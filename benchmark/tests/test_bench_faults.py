"""The check that decides ``correct`` fails what it must.

Each test drives a whole run of a cell on the CPU at a test's size (the
harness's look for a card skipped) with the timed path broken underneath,
and sees ``correct`` come out false: once for each fault the cell can
have. A cell on one card has no exchange between cards. The control, the
plain reference one precision below the configuration's in the program's
place, fails the cell's limits too; on the card it runs at the cell's own
size (``calibrate.py``, and the ``cuda`` test below)."""
import json
import os

import numpy as np
import pytest
import torch

import bench_helpers
import msm_we_tpu_torch.entry as entry
from benchmark import faults
import msm_we_tpu_torch.fluxmatrix as fluxmatrix
import msm_we_tpu_torch.model as model_mod
from msm_we_tpu_torch.ops import linalg

HOT, BUILD = "ntl9_100k.bins10", "westpa_default.100k"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return bench_helpers.small_copy(str(tmp_path_factory.mktemp("bench")))


def test_sound_runs_are_correct(bench):
    for cell in (HOT, BUILD):
        res, _c, _r = bench_helpers.run_cpu(bench, cell)
        assert res["correct"], (cell, res["checks"])


# ------------------------------------------------------------------ hot step
def _half_batch(fn):
    """Half of the segments left out, the other half's weights doubled."""
    def broken(*args):
        args = list(args)
        w = args[4].clone()
        n = len(w) // 2
        w[n:] = 0
        w[:n] *= 2
        args[4] = w
        return fn(*args)
    return broken


def _one_id_altered(fn):
    def broken(*args):
        pidx, cidx, fm = fn(*args)
        cidx = cidx.clone()
        cidx[7] = (cidx[7] + 1) % (len(args[10]))
        return pidx, cidx, fm
    return broken


def _state_unchanged(fm, basis_mask, target_mask):
    """A tail that returns the power iteration's start, unchanged."""
    S = fm.shape[0]
    p = torch.full((S,), 1.0 / S, dtype=fm.dtype)
    return fm, p, (p[:, None] * fm[:, target_mask]).sum(), torch.zeros((), dtype=fm.dtype)


@pytest.mark.parametrize("fault", ["half_batch", "one_id_altered", "state_unchanged"])
def test_hot_step_faults_are_caught(bench, monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(entry, "steady_state_from_flux", _state_unchanged)
    else:
        wrap = _half_batch if fault == "half_batch" else _one_id_altered
        monkeypatch.setattr(entry, "transform_assign", wrap(entry.transform_assign))
    res, _c, _r = bench_helpers.run_cpu(bench, HOT)
    assert not res["correct"], res["checks"]


# --------------------------------------------------------------------- build
def _half_rows(fn):
    def broken(model, feats, masks, iters):
        start, end, w = fn(model, feats, masks, iters)
        n = len(w) // 2
        return start[:n], end[:n], 2 * w[:n]
    return broken


def _store_altered(fn):
    def broken(self, parent_idx, child_idx):
        child_idx = np.array(child_idx, copy=True)
        n = int(getattr(self, "n_clusters", 2))
        child_idx[len(child_idx) // 3] = (child_idx[len(child_idx) // 3] + 1) % max(n, 2)
        return fn(self, parent_idx, child_idx)
    return broken


def _steady_state_unchanged(tmatrix, ind_targets, ind_basis, n_bins, lagtime, **_kw):
    p = np.full(n_bins, 1.0 / n_bins)
    return p, linalg.target_flux(np.asarray(tmatrix), p, ind_targets, n_bins, lagtime)


@pytest.mark.parametrize("fault", ["half_batch", "one_id_altered", "state_unchanged",
                                   "centers_unchanged"])
def test_build_faults_are_caught(bench, monkeypatch, fault):
    if fault == "centers_unchanged":
        with faults.centers_unchanged():
            res, _c, _r = bench_helpers.run_cpu(bench, BUILD)
        assert not res["correct"], res["checks"]
        assert res["checks"]["lloyd_gain"][0] > res["checks"]["lloyd_gain"][1]
        return
    if fault == "half_batch":
        monkeypatch.setattr(fluxmatrix, "_lag0_ids", _half_rows(fluxmatrix._lag0_ids))
    elif fault == "one_id_altered":
        monkeypatch.setattr(model_mod.modelWE, "_store_dtrajs",
                            _store_altered(model_mod.modelWE._store_dtrajs))
    else:
        monkeypatch.setattr(linalg, "steady_state_refined", _steady_state_unchanged)
    res, _c, _r = bench_helpers.run_cpu(bench, BUILD)
    assert not res["correct"], res["checks"]


# ------------------------------------------------------------------- control
def _control_correct(bench, cell, seed, device):
    run = bench_helpers.harness(bench)
    wl = run.load_json(os.path.join(bench, "workloads", cell + ".json"))
    cfg = run.load_json(os.path.join(bench, "configs", wl["config"] + ".json"))
    run._import_program()
    driver = run.load_module(os.path.join(bench, "drivers", wl["driver"] + ".py"),
                             "bench_driver_" + wl["driver"])
    c = driver.Cell(cfg, wl, seed, torch.device(device))
    c.release()
    numbers = dict(c.control())
    return all(numbers[k] <= v for k, v in wl["checks"].items()), numbers


@pytest.mark.parametrize("cell", [HOT, BUILD])
def test_the_control_is_not_correct(bench, cell):
    for seed in (5, 2**31 + 9):
        ok, numbers = _control_correct(bench, cell, seed, "cpu")
        assert not ok, numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card_at_the_cells_size(card):
    """The hot step's control at the cell's own size, on three seeds."""
    for seed in (101, 102, 2**31 + 103):
        ok, numbers = _control_correct(bench_helpers.BENCH, HOT, seed, card)
        assert not ok, json.dumps(numbers)
