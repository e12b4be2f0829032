"""Entry points of the hot step: the port's counterparts of
``__graft_entry__.entry()`` and ``bench.py::device_pipeline``.

``entry(device)`` returns the fused haMSM step (stratified discretization
-> flux matrix -> steady state) and example arguments on ``device``.
``hot_step(problem, tier, device)`` runs the benchmark's step on a
``make_problem()`` problem: raw coordinates -> PCA transform -> nearest
valid center in the segment's WE bin -> basis/target overrides -> flux
scatter -> steady state.

``dryrun_multichip(n_ranks, device)`` runs the sharded step of a build on
``n_ranks`` ranks (``parallel/``) against the one-rank result.

All run on the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device the default raises. On the card
a step is one CUDA graph replay (``_graph.py``, the counterpart of the JAX
package's ``jax.jit``): ``hot_step`` and ``entry()``'s ``hamsm_forward``
are captured at their first call with new inputs and replayed after that.
On the CPU they run eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _graph
from ._device import as_device, to_device
from .ops.stratified_assign import (
    assign_flux,
    c2adj,
    transform_assign,
    transform_assign_child,
)
from .step import _discretize_and_flux, steady_state_from_flux
from .testing import tiny_stratified_problem

__all__ = ["entry", "stage_problem", "hot_step", "dryrun_multichip", "TIERS",
           "GROUPED_MIN_OFF_BIN", "grouped_route"]

TIERS = ("two_transform", "dedup")

# The two_transform step scores bin-grouped once a row's bin leaves this
# many valid centers of the bank outside it: H2 stages the whole bank into
# every tile and scores each 32-center sub-tile a warp's rows need, so its
# time grows with the centers outside the rows' bins, while the grouped
# route pays a second pass over the features. The crossover of
# chip_smoke.py's ``route`` phase on an H100 (PERF.md, section 6; 1 to 128
# bins of 25 centers, each route a CUDA graph): H2 wins at 6 bins (150
# outside), the grouped route at 8 (175) and at every count above.
GROUPED_MIN_OFF_BIN = 175

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
    returns ``(fm, pss, flux, residual)``; on CUDA tensors it replays one
    CUDA graph, keyed by its arguments."""
    dev = as_device(device)
    p = tiny_stratified_problem(n_rows=64, d=8, n_bins=4, k=4, seed=0)
    n_states = p["n_states"]

    def step(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, centers,
             center_bin, valid):
        _graph.mark("assign_flux")
        fm, _pidx, _cidx = _discretize_and_flux(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, centers,
            center_bin, valid, n_states,
        )
        basis_mask, target_mask = _state_masks(n_states, fm.device)
        _T, pss, flux, residual = steady_state_from_flux(fm, basis_mask,
                                                         target_mask)
        return fm, pss, flux, residual

    def hamsm_forward(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
                      centers, center_bin, valid):
        return _graph.run(step, fp, fc, pbins, cbins, basis_p, basis_c,
                          target_c, w, centers, center_bin, valid)

    args = tuple(to_device(p[k], dev, _DTYPES[k]) for k in _ROW_KEYS)
    return hamsm_forward, args


def grouped_route(center_bin, valid):
    """Whether the ``two_transform`` step scores bin-grouped for this bank
    (host arrays): the valid centers outside a row's own bin, K less K over
    the bins that hold valid centers, reach ``GROUPED_MIN_OFF_BIN``. Then
    both raw sets go through H1's features-only transform and H3 scores
    each row against its own bin's centers on H2's ``c2adj``, bitwise H2's
    ids; below it, H2 alone."""
    bins = np.asarray(center_bin)[np.asarray(valid, bool)]
    K = len(bins)
    n_bins = len(np.unique(bins))
    return K > 0 and K - K / n_bins >= GROUPED_MIN_OFF_BIN


def stage_problem(problem, tier, device):
    """Upload a ``make_problem()`` dict for ``hot_step`` (set-up, not part
    of a step). The ``dedup`` tier uploads one raw array: the child rows
    followed by the recycled parents' fallback frames, with
    ``rows_ext`` addressing each parent's source row in it. The
    ``two_transform`` tier records its route (``grouped``,
    :func:`grouped_route` of the bank)."""
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
        s["grouped"] = grouped_route(p["center_bin"], p["valid"])
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
    f32 flux), or, where :func:`grouped_route` takes the bank (8 or more
    bins of 25 centers), through two features-only H1 launches and one H3
    launch that scores each row against its own bin only, with the same
    ids. ``dedup``: one
    features-only H1 launch transforms the
    extended raw array once and emits its features (no scoring); parent
    features are a gather of them (WE continuity) and one H3 launch
    assigns both sets and scatters the flux. Any feature width. Either way
    the steady state follows.

    On the card the step is one CUDA graph replay: the staged problem is
    the graph's static input, captured at the first step on it (a
    ``make_problem()`` dict is staged anew, so each such call captures).
    Returns a dict with ``fm``, ``pss``, ``flux``, ``residual``, ``pidx``
    and ``cidx`` (device tensors; nothing is synchronised).
    """
    s = problem if "tier" in problem else stage_problem(problem, tier, device)
    return _graph.run(_hot_step, s, tier)


def _hot_step(s, tier):
    """:func:`hot_step` on a staged problem: the function ``_graph.run``
    warms up, captures and replays. Called directly it runs as launches
    from Python with no graph, as on the CPU: the comparison for the
    replays on the card. In a traced capture it marks
    ``device_ms["assign_flux"]`` and counts ``assign_grouped``."""
    if s["tier"] != tier:
        raise ValueError(f"problem was staged for tier {s['tier']!r}, not {tier!r}")
    _graph.mark("assign_flux")
    S = s["n_states"]
    bank = (s["centers"], s["center_bin"], s["valid"])
    grouped = tier == "two_transform" and s["grouped"]
    _graph.count("assign_grouped", grouped)
    if tier == "two_transform":
        pidx, cidx, fm = _two_transform(s, grouped)
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
    _T, pss, flux, residual = steady_state_from_flux(fm, basis_mask,
                                                     target_mask)
    return dict(fm=fm, pss=pss, flux=flux, residual=residual, pidx=pidx,
                cidx=cidx)


def _two_transform(s, grouped):
    """The ``two_transform`` step's assignment and f32 flux on a staged
    problem: ``(pidx, cidx, fm)``. ``grouped``: the uncentered features
    ``g = raw P`` of both sets (H1, features only), then H3 on H2's
    ``c2adj``, so every score is H2's bit for bit; else one H2 launch."""
    S = s["n_states"]
    bank = (s["centers"], s["center_bin"], s["valid"])
    rows = (s["pbins"], s["cbins"], s["w"], s["basis_p"], s["basis_c"],
            s["target_c"])
    if not grouped:
        return transform_assign(s["raw_parent"], s["raw_child"], *rows,
                                s["mean"], s["comp"], *bank, S)
    _none, gp = transform_assign_child(
        s["raw_parent"], s["pbins"], None, None, s["mean"], s["comp"], *bank,
        S, features_only=True)
    _none, gc = transform_assign_child(
        s["raw_child"], s["cbins"], None, None, s["mean"], s["comp"], *bank,
        S, features_only=True)
    a = c2adj(s["mean"], s["comp"], s["centers"]).contiguous()
    return assign_flux(gp, gc, *rows, *bank, S, c2=a)


def hot_problem(n_segments=102_400, seed=0):
    """The hot step's problem as features (``make_problem``'s raw rows
    through its PCA, in f32 on the host: 10 bins x 25 centers) with dyadic
    f64 weights, so every flux cell sum is exact in any order."""
    from .testing import make_problem

    p = make_problem(n_segments=n_segments, seed=seed)
    off = p["mean"] @ p["comp"]
    fc = (p["raw_child"] @ p["comp"] - off).astype(np.float32)
    rng = np.random.default_rng(seed + 5)
    return dict(fp=(p["raw_parent"] @ p["comp"] - off).astype(np.float32), fc=fc,
                pbins=p["pbins"], cbins=p["cbins"], basis_p=p["basis_p"],
                basis_c=p["basis_c"], target_c=p["target_c"],
                w=rng.integers(1, 17, len(fc)) / 16.0, centers=p["centers"],
                center_bin=p["center_bin"], valid=p["valid"],
                n_states=p["n_states"])


def wide_problem(problem, n_bins=128, k=25, seed=5):
    """``problem``'s rows over ``n_bins`` uniform random bins of ``k``
    centers each (rows of the bin plus noise): the wide bank."""
    rng = np.random.default_rng(seed)
    fc = problem["fc"]
    N = len(fc)
    out = dict(problem, pbins=rng.integers(0, n_bins, N).astype(np.int32),
               cbins=rng.integers(0, n_bins, N).astype(np.int32))
    pick = np.concatenate([
        rng.choice(m if len(m) else np.arange(N), k, replace=len(m) < k)
        for m in (np.flatnonzero(out["cbins"] == b) for b in range(n_bins))])
    out["centers"] = (fc[pick] + 0.01 * rng.normal(size=(len(pick), fc.shape[1]))
                      ).astype(np.float32)
    out["center_bin"] = np.repeat(np.arange(n_bins, dtype=np.int32), k)
    out["valid"] = np.ones(len(pick), bool)
    out["n_states"] = len(pick) + 2
    return out


def _awkward_problems(data, model):
    """The JAX dryrun's awkward shapes for a (data, model) mesh: ``model +
    1`` bins of 3 centers over ``16 data + 7`` rows (bins straddle the
    bank's shards, K does not divide), and one bin of ``4 model + 1``
    centers over ``8 data + 1`` rows (a bin spanning every shard). Each
    also padded by one more row block and one more bank block."""
    from .parallel.distributed import pad_problem
    from .testing import tiny_stratified_problem

    out = {}
    for i, (n_bins, k, n) in enumerate([(model + 1, 3, 16 * data + 7),
                                        (1, 4 * model + 1, 8 * data + 1)]):
        raw = tiny_stratified_problem(n_rows=n, n_bins=n_bins, k=k, seed=11)
        raw["w"] = raw["w"].astype(np.float64)
        K = n_bins * k
        out[f"awkward{i}"] = raw
        out[f"awkward{i}_padded"] = pad_problem(
            raw, (-(-n // data) + 1) * data, (-(-K // model) + 1) * model)
    return out


def dryrun_multichip(n_ranks, device="cuda", n_segments=102_400, wide_bins=128,
                     backend="gloo", timeout=600, base=None):
    """The sharded programs of a build on ``n_ranks`` ranks against one rank.

    One process group of ``n_ranks`` ranks (``parallel.distributed.
    launch_programs``, ``backend`` gloo: its ranks may share one card) runs
    the flux step, the pair, single and plain assignments and the cluster
    statistics (``parallel.distributed.run_programs``) on two mesh shapes,
    ``best_mesh_shape``'s and (``n_ranks``, 1):
    the hot step's problem (``n_segments`` rows, raw 900 -> 30 features, 10
    bins x 25 centers; dyadic f64 weights), the same rows over
    ``wide_bins`` bins of 25 centers, and the JAX dryrun's awkward shapes,
    each also padded by one more row block and bank block (``base``: the
    first two problems, already made, by name). This process
    runs each problem on the (1, 1) mesh of ``device``. Ids, the flux,
    counts, minima and maxima must be bitwise the one-rank ones (the f64
    pcoord sums to 1e-12), a padded problem's bitwise its unpadded one's.
    Returns
    ``{"checks": [...], "problems": {...}, "results": {...}, "seconds"}``.
    """
    import time

    from .parallel.distributed import (
        complete_problem,
        launch_programs,
        run_programs,
        shard_problem,
    )
    from .parallel.mesh import Mesh, best_mesh_shape

    dev = as_device(device)
    models = sorted({best_mesh_shape(n_ranks)[1], 1}, reverse=True)
    t0 = time.perf_counter()
    if base is None:
        base = {"hot": hot_problem(n_segments)}
        if wide_bins:
            base["wide"] = wide_problem(base["hot"], wide_bins)
    problems, jobs = {}, []
    for m in models:
        shape = f"{n_ranks // m}x{m}"
        for name, prob in {**base, **_awkward_problems(n_ranks // m, m)}.items():
            key = f"{name}@{shape}"
            problems[key] = complete_problem(prob)
            jobs.append((key, problems[key], m))
    results = launch_programs(jobs, n_ranks, backend=backend, device=device,
                              timeout=timeout)
    one_mesh = Mesh.single(dev)
    checks = []
    for key, prob in problems.items():
        got = results[key]
        N = len(prob["w"])
        ref = run_programs(one_mesh, shard_problem(prob))
        line = dict(name=key, n=N, K=len(prob["valid"]))
        for k in ("fm", "pidx", "cidx", "single", "assign", "counts", "vmin", "vmax"):
            if not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"{key}: {k} differs from the one-rank result")
        scale = max(float(np.abs(ref["sums"]).max()), 1e-300)
        sums_err = float(np.abs(got["sums"] - ref["sums"]).max()) / scale
        if sums_err > 1e-12:
            raise AssertionError(f"{key}: pcoord sums differ by {sums_err}")
        line.update(ids_bitwise=True, flux_bitwise=True, sums_rel_err=sums_err)
        if "_padded" in key:
            unpadded = results[key.replace("_padded", "")]
            n0 = len(unpadded["cidx"])
            if not (np.array_equal(got["fm"], unpadded["fm"]) and all(
                    np.array_equal(got[k][:n0], unpadded[k])
                    for k in ("pidx", "cidx", "single", "assign"))):
                raise AssertionError(f"{key}: padding changed the answer")
            line["padding_inert"] = True
        checks.append(line)
    return dict(checks=checks, problems=problems, results=results,
                rank_launches=launch_programs.rank_launches,
                seconds=time.perf_counter() - t0)
