"""The import guard: top-level names compared whole (the program's name
begins with the JAX package's), the reference's sources importing nothing
of the program, and a run refused without a card."""

from __future__ import annotations

from pathlib import Path

from slambench import guard, run

HERE = Path(__file__).resolve().parent


def test_loaded_forbidden_compares_top_level_names_whole():
    mods = ["rgbdslam_tpu_torch", "rgbdslam_tpu_torch.slam.system", "numpy", "jaxtyping",
            "flaxen"]
    assert guard.loaded_forbidden(mods) == []
    assert guard.loaded_forbidden(mods + ["jax.numpy", "rgbdslam_tpu.ops"]) == [
        "jax", "rgbdslam_tpu"]
    assert guard.loaded_forbidden(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]


def test_the_benchmark_loads_no_jax():
    import slambench.check  # noqa: F401
    import slambench.drive  # noqa: F401
    import slambench.run  # noqa: F401
    from rgbdslam_tpu_torch.slam import system  # noqa: F401

    import subprocess
    import sys

    code = ("import slambench.run, slambench.check, slambench.trace; "
            "from rgbdslam_tpu_torch.slam import system; "
            "from slambench import guard; print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert guard.reference_imports_forbidden(HERE / "reference") == {}
    (tmp_path / "bad.py").write_text("import numpy\nfrom rgbdslam_tpu_torch.ops import fast\n")
    (tmp_path / "worse.py").write_text("import jax.numpy as jnp\n")
    assert guard.reference_imports_forbidden(tmp_path) == {
        "bad.py": ["rgbdslam_tpu_torch"], "worse.py": ["jax"]}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        return
    assert run.main(["--workload", "fast_brief.tour_b32", "--seed", "3", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
