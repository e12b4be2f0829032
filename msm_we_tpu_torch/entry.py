"""Entry points of the hot step: the port's counterparts of
``__graft_entry__.entry()`` and ``bench.py::device_pipeline``.

``entry(device)`` returns the fused haMSM step (stratified discretization
-> flux matrix -> steady state) and example arguments on ``device``.
``hot_step(problem, tier, device)`` runs the benchmark's step on a
``make_problem()`` problem: raw coordinates -> PCA transform -> nearest
valid center in the segment's WE bin -> basis/target overrides -> flux
scatter -> steady state.

Both run on the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device the default raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import as_device, to_device
from .ops.stratified_assign import (
    assign_flux,
    transform_assign,
    transform_assign_child,
)
from .step import _discretize_and_flux, steady_state_from_flux
from .testing import tiny_stratified_problem

__all__ = ["entry", "stage_problem", "hot_step", "TIERS"]

TIERS = ("two_transform", "dedup")

_ROW_KEYS = ("fp", "fc", "pbins", "cbins", "basis_p", "basis_c", "target_c",
             "w", "centers", "center_bin", "valid")
_DTYPES = dict(
    fp=torch.float32, fc=torch.float32, pbins=torch.int32, cbins=torch.int32,
    basis_p=torch.bool, basis_c=torch.bool, target_c=torch.bool,
    w=torch.float32, centers=torch.float32, center_bin=torch.int32,
    valid=torch.bool,
)


def _state_masks(n_states, device):
    ids = torch.arange(n_states, device=device)
    return ids == n_states - 2, ids == n_states - 1


def entry(device="cuda"):
    """``(hamsm_forward, example_args)`` on ``device``: the
    ``tiny_stratified_problem`` through assign + overrides + flux (one H3
    launch on CUDA) and ``steady_state_from_flux``. ``hamsm_forward``
    returns ``(fm, pss, flux, residual)``."""
    dev = as_device(device)
    p = tiny_stratified_problem(n_rows=64, d=8, n_bins=4, k=4, seed=0)
    n_states = p["n_states"]

    def hamsm_forward(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
                      centers, center_bin, valid):
        fm, _pidx, _cidx = _discretize_and_flux(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
            centers, center_bin, valid, n_states,
        )
        basis_mask, target_mask = _state_masks(n_states, fm.device)
        _T, pss, flux, residual = steady_state_from_flux(
            fm, basis_mask, target_mask
        )
        return fm, pss, flux, residual

    args = tuple(to_device(p[k], dev, _DTYPES[k]) for k in _ROW_KEYS)
    return hamsm_forward, args


def stage_problem(problem, tier, device):
    """Upload a ``make_problem()`` dict for ``hot_step`` (set-up, not part
    of a step). The ``dedup`` tier uploads one raw array: the child rows
    followed by the recycled parents' fallback frames, with
    ``rows_ext`` addressing each parent's source row in it."""
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    dev = as_device(device)
    p = problem
    f32, i32, b = torch.float32, torch.int32, torch.bool
    s = dict(
        tier=tier, device=dev, n_states=int(p["n_states"]),
        mean=to_device(p["mean"], dev, f32), comp=to_device(p["comp"], dev, f32),
        pbins=to_device(p["pbins"], dev, i32), cbins=to_device(p["cbins"], dev, i32),
        basis_p=to_device(p["basis_p"], dev, b),
        basis_c=to_device(p["basis_c"], dev, b),
        target_c=to_device(p["target_c"], dev, b),
        w=to_device(p["w"], dev, f32),
        centers=to_device(p["centers"], dev, f32),
        center_bin=to_device(p["center_bin"], dev, i32),
        valid=to_device(p["valid"], dev, b),
    )
    if tier == "two_transform":
        s["raw_parent"] = to_device(p["raw_parent"], dev, f32)
        s["raw_child"] = to_device(p["raw_child"], dev, f32)
        return s
    n = len(p["raw_child"])
    fb = np.asarray(p["fb_idx"])
    rows_ext = np.asarray(p["parent_rows"], np.int64).copy()
    rows_ext[fb] = n + np.arange(len(fb))
    bins_ext = np.concatenate([p["cbins"], np.asarray(p["pbins"])[fb]])
    # Continuity: a gathered parent sits in its source row's bin, so the
    # source row's features stand in for the parent's
    if not np.array_equal(bins_ext[rows_ext], p["pbins"]):
        raise ValueError("dedup tier needs parents in their source rows' bins")
    s["raw_ext"] = to_device(
        np.concatenate([p["raw_child"], p["raw_fallback"]]), dev, f32
    )
    s["bins_ext"] = to_device(bins_ext, dev, i32)
    s["rows_ext"] = to_device(rows_ext, dev, torch.int64)
    return s


def hot_step(problem, tier="two_transform", device="cuda"):
    """One hot step. ``problem`` is a ``make_problem()`` dict (uploaded to
    ``device`` first) or the output of :func:`stage_problem`.

    ``two_transform`` (bench tier ``two_transform``): parent and child raw
    rows through one H2 launch (transform, assign, flux-order overrides,
    f32 flux). ``dedup``: one features-only H1 launch transforms the
    extended raw array once and emits its features (no scoring); parent
    features are a gather of them (WE continuity) and one H3 launch
    assigns both sets and scatters the flux. Any feature width. Either way the steady state follows.

    Returns a dict with ``fm``, ``pss``, ``flux``, ``residual``, ``pidx``
    and ``cidx`` (device tensors; nothing is synchronised).
    """
    s = problem if "tier" in problem else stage_problem(problem, tier, device)
    if s["tier"] != tier:
        raise ValueError(f"problem was staged for tier {s['tier']!r}, not {tier!r}")
    S = s["n_states"]
    bank = (s["centers"], s["center_bin"], s["valid"])
    if tier == "two_transform":
        pidx, cidx, fm = transform_assign(
            s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"], s["w"],
            s["basis_p"], s["basis_c"], s["target_c"], s["mean"], s["comp"],
            *bank, S,
        )
    else:
        _none, g = transform_assign_child(
            s["raw_ext"], s["bins_ext"], None, None, s["mean"], s["comp"],
            *bank, S, features_only=True,
        )
        feats = g - s["mean"] @ s["comp"]
        n = len(s["pbins"])
        fc = feats[:n]
        fp = feats.index_select(0, s["rows_ext"])
        pidx, cidx, fm = assign_flux(
            fp, fc.contiguous(), s["pbins"], s["cbins"], s["w"], s["basis_p"],
            s["basis_c"], s["target_c"], *bank, S,
        )
    basis_mask, target_mask = _state_masks(S, fm.device)
    _T, pss, flux, residual = steady_state_from_flux(fm, basis_mask, target_mask)
    return dict(fm=fm, pss=pss, flux=flux, residual=residual, pidx=pidx,
                cidx=cidx)
