"""A run of the tiny cell on the CPU, whole but for the look for a card,
with the timed path sound and then broken underneath in each way this
benchmark's cells can break (`faults.py`): `correct` must come out true,
then false, by the number each fault is for.

The cells run on one card, so there is no exchange between chips to leave
out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench import faults, tiny
from slambench.manifest import Cell
from slambench.run import run

SEED = 2 ** 31 + 977
SECONDS = 6.0


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    torch.set_num_threads(2)
    return Cell(tiny.make_root(tmp_path_factory.mktemp("bench")), tiny.CELL)


@pytest.fixture(scope="module")
def noisy_cell(tmp_path_factory):
    torch.set_num_threads(2)
    return Cell(tiny.make_root(tmp_path_factory.mktemp("noisy"), noise=True), tiny.CELL)


def _run(cell):
    return run(cell, SEED, SECONDS, False, device="cpu")


@pytest.mark.parametrize("which", ["clean", "noisy"])
def test_sound_run_is_correct(cell, noisy_cell, which):
    res = _run(cell if which == "clean" else noisy_cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _failed(res, number):
    c = res["checks"][number]
    return c["value"] is None or c["value"] > c["limit"]


@pytest.mark.parametrize("fault", ["identity_estimate", "half_batch", "descriptor_bit",
                                   "match_altered", "solve_unchanged"])
def test_fault_is_not_correct(cell, monkeypatch, fault):
    """Every estimate the identity (the state never moves); half of each
    batch's poses left out; a descriptor bit flipped where it is built; the
    backend's matches shifted by one slot; the pose-graph solve returning
    its input."""
    plant, number = faults.FAULTS[fault]
    plant(monkeypatch.setattr)
    res = _run(cell)
    assert not res["correct"]
    assert _failed(res, number), res["checks"]


def test_dense_polish_skipped_is_not_correct(noisy_cell, monkeypatch):
    plant, number = faults.FAULTS["dense_skipped"]
    plant(monkeypatch.setattr)
    res = _run(noisy_cell)
    assert not res["correct"]
    assert _failed(res, number), res["checks"]


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
def test_control_is_not_correct(cell, precision):
    """The reference computed in a lower precision, in the program's place
    for the features and the track extensions, fails their exact
    comparisons."""
    res = run(cell, SEED, SECONDS, False, device="cpu", control=precision)
    assert not res["correct"]
    assert res["checks"]["feature_mismatch"]["value"] > 0
    assert res["checks"]["match_mismatch"]["value"] > 0
    assert res["checks"]["frames_missing"]["value"] == 0
    assert np.isfinite(res["checks"]["ate_median_m"]["value"])
