"""tests/test_loop_recall.py on the PyTorch port alone: loop retrieval on a
160-keyframe, 3.2-revolution orbit at 320x240 with the port's shipped
vocabularies (rgbdslam_tpu_torch/assets, byte copies of the JAX package's),
held to the JAX test's bounds: at least 60 revisit queries, recall@5 >= 0.75,
precision >= 0.60. The JAX test pins the JAX package's side; this one runs
no JAX. The card's counterpart is tests/test_torch_gpu_behaviour.py.
"""

import pytest

import port_behaviour as pb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("detector,vocname", [
    ("svo_fast", "voc_synth_fast_brief.npz"),
    ("orb", "voc_synth_orb.npz"),
])
def test_retrieval_recall_at_5_long_multiloop(detector, vocname):
    r = pb.retrieval_recall(detector, vocname, "cpu")
    assert r["queries"] >= 60, f"only {r['queries']} revisit queries in the sequence"
    assert r["recall"] >= 0.75, f"recall@5 {r['recall']:.3f}"
    assert r["precision"] >= 0.60, f"precision {r['precision']:.3f}"
