"""Dataset factory (port of rgbdslam_tpu/io/datasets.py, synthetic branch).
Disk datasets (TUM, ICL, CoRBS) and the native loader are not yet ported.
"""

from __future__ import annotations


def open_dataset(path_or_kind: str, **kwargs):
    """'synthetic' / 'synthetic:sweep' / 'synthetic:orbit' / 'synthetic:tour'
    -> SyntheticDataset(trajectory=..., **kwargs)."""
    if path_or_kind.startswith("synthetic"):
        from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

        traj = path_or_kind.split(":", 1)[1] if ":" in path_or_kind else "orbit"
        return SyntheticDataset(trajectory=traj, **kwargs)
    raise NotImplementedError("not yet ported: disk datasets (synthetic only)")
