"""The hot step and ``entry()`` as CUDA graph replays (``_graph.py``) against
their eager launches, on the card. JAX-free, so they also run on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_cuda.py

Each test skips without a GPU. Ids must be bitwise the eager step's. The
f32 flux adds with ``atomicAdd`` in a run-dependent order, so ``fm`` must
lie within ``testing.flux_order_bound`` of an eager step's in each cell,
and the graphed ``pss``, JtargetSS and residual must equal, bitwise, the
eager tail run on the graphed ``fm``; dyadic weights (``entry()``) make the
flux exact in any order, so there everything is bitwise. At up to
``S_MAX`` states both routes take the tail kernel (``ops/steady_tail.py``),
so the graphed tail equals the eager one bitwise and the cuBLAS early-exit
loop within ``testing.tail_order_excess``. Above ``S_MAX`` an f32 flux
matrix takes the tail in float64 (conditional nodes in the graph, guarded
rounds eagerly): both take the float64 early-exit loop's rounds and lie
within their f32 rounding (and 1e-12) of its outputs, also at 3,202
states, the 128-bin step of the ``ntl9_100k.bins128`` cell, under twelve
orders of its segments. The traced graph of ``tracing.collect()`` gives
the plain graph's outputs, counts the tail's rounds and the replays whose
tail took the kernel or the float64 route, and times two intervals that
fit in the step's device time. From 8 bins of 25 centers up the
``two_transform`` step takes the bin-grouped route (features-only H1, then
H3): at 128 its ids are an eager H2 launch's bitwise, and the counts and
launches show the route.
"""
import functools
import gc

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph, tracing
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import (
    TIERS,
    _hot_step,
    _state_masks,
    entry,
    hot_step,
    stage_problem,
)
from msm_we_tpu_torch.ops import steady_tail as st
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import (
    f32_rounding_excess,
    flux_order_bound,
    make_problem,
    steady_state_early_exit,
    tail_order_excess,
)

SMALL = dict(n_segments=8192, n_raw_features=64, n_components=8, n_bins=10,
             k_per_bin=25)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problems():
    return [make_problem(seed=seed, **SMALL) for seed in (3, 4)]


def _assert_like_eager(graphed, eager, w):
    ref = eager[0]
    S = ref["fm"].shape[0]
    bound = flux_order_bound(ref["pidx"], ref["cidx"], w, S)
    basis, target = _state_masks(S, ref["fm"].device)
    for o in graphed:
        assert torch.equal(o["pidx"], ref["pidx"])
        assert torch.equal(o["cidx"], ref["cidx"])
        assert ((o["fm"].double() - ref["fm"].double()).abs() <= bound).all()
        _T, pss, flux, res = tstep.steady_state_from_flux(o["fm"], basis, target)
        assert torch.equal(o["pss"], pss) and torch.equal(o["flux"], flux)
        assert torch.equal(o["residual"], res)


def _runs(fn, n=8):
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_replay_equals_the_eager_step(cuda_device, problems, tier):
    s = stage_problem(problems[0], tier, cuda_device)
    eager = _runs(lambda: _hot_step(s, tier))
    graphed = _runs(lambda: hot_step(s, tier))
    _assert_like_eager(graphed, eager, s["w"])


@pytest.mark.cuda
def test_entry_replays_its_graph(cuda_device):
    fn, args = entry("cuda")
    outs = [fn(*args) for _ in range(3)]
    S = args[-2].shape[0] + 2
    fm, _p, _c = tstep._discretize_and_flux(*args, S)
    basis, target = _state_masks(S, fm.device)
    _T, pss, flux, res = tstep.steady_state_from_flux(fm, basis, target)
    for g in outs:
        assert torch.equal(g[0], fm)  # dyadic weights: exact in any order
        assert torch.equal(g[1], pss)
        assert torch.equal(g[2], flux) and torch.equal(g[3], res)


# The wrappers each tier's step calls and their launches, by the step's
# route (the tail kernel at 252 states; SMALL's bank of 10 bins x 25 takes
# the bin-grouped route, ``entry.grouped_route``, whose features stream
# through one ``transform_features`` launch, as the dedup tier's do)
TIER_KERNELS = {"two_transform": dict(transform_assign=1, steady_tail=1),
                "two_transform_grouped": dict(transform_features=1,
                                              assign_flux=1, steady_tail=1),
                "dedup": dict(transform_features=1, assign_flux=1,
                              steady_tail=1)}


def _traced_kernels(fn, n):
    """Launches of each of the port's kernels in a ``torch.profiler`` trace
    of ``n`` runs of ``fn``, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {sym: sum(sym in name for name in names)
            for sym in set(sa.KERNEL_SYMBOLS.values())}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_a_replay_launches_the_steps_kernels(cuda_device, problems, tier):
    """The trace of replays shows the step's kernels; the counters move
    only for the warm-up's launches (a capture only records)."""
    s = stage_problem(problems[0], tier, cuda_device)
    launches = TIER_KERNELS[tier + ("_grouped" if s.get("grouped") else "")]
    before = sa.launch_counts()
    hot_step(s, tier)  # warm-up, capture, replay
    torch.cuda.synchronize()
    mid = sa.launch_counts()
    traced = _traced_kernels(lambda: hot_step(s, tier), 3)
    after = sa.launch_counts()
    assert {k: mid[k] - before[k] for k in mid} == {
        k: launches.get(k, 0) for k in mid}
    assert after == mid
    for name in launches:
        assert traced[sa.KERNEL_SYMBOLS[name]] > 0
    assert traced["pair_assign_kernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_a_second_staged_problem_captures_its_own_graph(cuda_device, problems,
                                                        tier):
    a, b = (stage_problem(p, tier, cuda_device) for p in problems)
    ka = _graph.graph_key(_hot_step, _graph.pytree.tree_leaves((a, tier)))
    kb = _graph.graph_key(_hot_step, _graph.pytree.tree_leaves((b, tier)))
    ga, gb = hot_step(a, tier), hot_step(b, tier)
    assert ka in _graph._CACHE and kb in _graph._CACHE
    _assert_like_eager([ga], _runs(lambda: _hot_step(a, tier)), a["w"])
    _assert_like_eager([gb], _runs(lambda: _hot_step(b, tier)), b["w"])
    assert not torch.equal(ga["cidx"], gb["cidx"])
    del a
    gc.collect()
    assert ka not in _graph._CACHE and kb in _graph._CACHE


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_a_replay_sees_inputs_overwritten_in_place(cuda_device, problems, tier):
    s = stage_problem(problems[0], tier, cuda_device)
    first = hot_step(s, tier)
    n = len(_graph._CACHE)
    other = stage_problem(problems[1], tier, cuda_device)
    for k, v in s.items():
        if isinstance(v, torch.Tensor):
            v.copy_(other[k])
    graphed = _runs(lambda: hot_step(s, tier))
    assert len(_graph._CACHE) == n  # no new capture
    assert not torch.equal(graphed[0]["cidx"], first["cidx"])
    _assert_like_eager(graphed, _runs(lambda: _hot_step(other, tier)),
                       other["w"])


def _coupled(eps, S=12, seed=0):
    rng = np.random.default_rng(seed)
    fm = rng.random((S, S))
    block = np.arange(S) < S // 2
    fm[block[:, None] != block[None, :]] *= eps
    return fm.astype(np.float32)


def _bipartite(S=13, seed=1):
    """A chain of period 2: the residual never falls below ``tol``, so the
    tail takes all 16 extra squarings on any device."""
    rng = np.random.default_rng(seed)
    parity = np.arange(S) % 2
    return (rng.random((S, S)) * (parity[:, None] != parity[None, :])
            ).astype(np.float32)


def _lopsided(eps, S=642, ratio=10.0, seed=0):
    """Two halves joined by flux ``eps`` one way and ``ratio * eps`` the
    other: the float64 tail takes more extra squarings the smaller ``eps``
    (``test_torch_device_loops.py``)."""
    rng = np.random.default_rng(seed)
    fm = rng.random((S, S))
    half = np.arange(S) < S // 2
    fm[half[:, None] & ~half[None, :]] *= eps
    fm[~half[:, None] & half[None, :]] *= eps * ratio
    return fm.astype(np.float32)


def _within_f32_rounding(got, ref):
    """Whether each f32 output of ``got`` lies within its own f32 rounding
    and 1e-12 of the float64 ``ref`` (``testing.f32_rounding_excess``)."""
    return (all(g.dtype == torch.float32 for g in got)
            and f32_rounding_excess(got, ref) <= 1e-12)


def _eager_rounds(fm, basis, target, tol=1e-6):
    """The eager route's tail and the extra squarings its guarded rounds
    kept: ``step._where_rounds`` one round at a time, each round's flag
    read after the tail."""
    flags = []

    def rounds(Tn, p, residual, T, tol, n, **kw):
        for _ in range(n):
            flags.append(residual > tol)
            Tn, p, residual = tstep._where_rounds(Tn, p, residual, T, tol, 1,
                                                  **kw)
        return Tn, p, residual

    out = tstep._steady_state(fm, basis, target, 512, tol, 16, rounds,
                              st.tail_dtype(fm.dtype, fm.shape[0]))
    return out, sum(int(f) for f in flags)


@pytest.mark.cuda
@pytest.mark.parametrize("make,rounds", [(lambda: _coupled(0.1, S=642), 0),
                                         (lambda: _lopsided(5e-5), 5),
                                         (lambda: _bipartite(S=643), 16)],
                         ids=["wide_round_0", "wide_round_5", "wide_never"])
def test_graphed_f64_tail_equals_the_float64_loop(cuda_device, make, rounds):
    """Above ``S_MAX`` the graphed and the eager tail of an f32 flux matrix
    run in float64: the float64 early-exit loop's rounds (the traced
    graph's counter, the eager route's kept rounds) and its outputs within
    their f32 rounding; every traced replay counts as the float64 route and
    none as the kernel."""
    fm = torch.tensor(make(), device=cuda_device)
    S = fm.shape[0]
    assert st.tail_dtype(fm.dtype, S) == torch.float64
    basis, target = _state_masks(S, cuda_device)
    *ref, n_extra = steady_state_early_exit(fm.double(), basis, target)
    assert n_extra == rounds
    eager, kept = _eager_rounds(fm, basis, target)
    assert kept == n_extra and _within_f32_rounding(eager, ref)
    before = sa.launch_counts()["steady_tail"]
    outs, col = _traced_runs(lambda: _graph.run(
        tstep.steady_state_from_flux, fm, basis, target), 3)
    assert sa.launch_counts()["steady_tail"] == before
    for got in outs:
        assert _within_f32_rounding(got, ref)
    assert col.counts["tail_rounds"] == 3 * n_extra
    assert col.counts["tail_f64"] == 3 and col.counts["tail_fused"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("make,rounds", [(lambda: _coupled(0.1), 0),
                                         (lambda: _coupled(1.5e-4), 5),
                                         (_bipartite, 16)],
                         ids=["round_0", "round_5", "never"])
def test_graphed_tail_equals_the_early_exit_loop(cuda_device, make, rounds):
    """The graphed tail (the tail kernel's node at these sizes): the eager
    route's result bitwise (the same kernel, fixed sums), and the early-exit
    loop's within ``testing.tail_order_excess`` (cuBLAS sums in other
    orders), on the same device tensors. ``round_5`` may take a round more
    or less on the card, whose sums round otherwise; ``never`` takes every
    round."""
    fm = torch.tensor(make(), device=cuda_device)
    ids = torch.arange(fm.shape[0], device=cuda_device)
    basis, target = ids == fm.shape[0] - 2, ids == fm.shape[0] - 1
    *ref, n_extra = steady_state_early_exit(fm, basis, target)
    if rounds in (0, 16):
        assert n_extra == rounds
    else:
        assert 0 < n_extra < 16
    eager = tstep.steady_state_from_flux(fm, basis, target)
    for _ in range(2):
        got = _graph.run(tstep.steady_state_from_flux, fm, basis, target)
        for g, e in zip(got, eager):
            assert torch.equal(g, e)
        excess = tail_order_excess(got, ref)
        assert all(v <= 0 for v in excess.values()), excess


# ------------------------------------------------------- the traced graph


@pytest.fixture(scope="module")
def problem0():
    """The benchmark's problem (``make_problem`` seed 0, full size)."""
    return make_problem(seed=0)


def _traced_runs(fn, n):
    """``n`` runs of ``fn`` under ``collect()``, after one that captures the
    traced graph: ``(outputs, collector)``."""
    with tracing.collect():
        fn()
    with tracing.collect() as col:
        outs = _runs(fn, n)
    return outs, col


@pytest.mark.cuda
def test_the_traced_graph_gives_the_plain_graphs_outputs(cuda_device, problems):
    fn, args = entry("cuda")
    plain = _runs(lambda: fn(*args), 2)
    traced, col = _traced_runs(lambda: fn(*args), 2)
    for g in traced:  # dyadic weights: bitwise
        for a, b in zip(g, plain[0]):
            assert torch.equal(a, b)
    assert len(col.device_ms["assign_flux"]) == len(col.device_ms["tail"]) == 2
    for tier in TIERS:
        s = stage_problem(problems[0], tier, cuda_device)
        plain = _runs(lambda: hot_step(s, tier), 4)
        traced, col = _traced_runs(lambda: hot_step(s, tier), 4)
        _assert_like_eager(traced, plain, s["w"])
        assert {n: len(v) for n, v in col.spans.items()} == {
            "graph.lookup": 4, "graph.launch": 4, "graph.copy_out": 4}


@pytest.mark.cuda
def test_tail_rounds_count_each_replays_early_exit_rounds(cuda_device, problem0):
    """The traced graph's counters: the rounds are the tail kernel's own,
    as it counts them eagerly on each replay's flux, and every replay's
    tail took the kernel."""
    s = stage_problem(problem0, "two_transform", cuda_device)
    outs, col = _traced_runs(lambda: hot_step(s, "two_transform"), 8)
    basis, target = _state_masks(s["n_states"], cuda_device)
    want = sum(int(st.steady_tail(o["fm"], basis, target)[4]) for o in outs)
    assert col.counts["tail_rounds"] == want
    assert col.counts["tail_fused"] == 8


@pytest.mark.cuda
def test_tail_rounds_read_16_a_step_at_tol_0(cuda_device, problem0):
    s = stage_problem(problem0, "two_transform", cuda_device)
    fm = hot_step(s, "two_transform")["fm"]
    basis, target = _state_masks(s["n_states"], cuda_device)
    assert steady_state_early_exit(fm, basis, target, tol=0.0)[-1] == 16
    tail = functools.partial(tstep.steady_state_from_flux, tol=0.0)
    _outs, col = _traced_runs(lambda: _graph.run(tail, fm, basis, target), 3)
    assert col.counts["tail_rounds"] == 48


@pytest.mark.cuda
def test_the_device_intervals_fit_in_the_steps_device_time(cuda_device, problem0):
    """Assign + flux and the tail, timed by the traced graph's event nodes
    in synchronised replays, sum to no more than a synchronised plain
    step's device time by events around its launch, and to 80-105% of a
    plain step's by events around replays queued back to back behind a
    spin (no host time in it, no launch latency: a replay that starts on an
    idle device and its event nodes may take a few microseconds more)."""
    s = stage_problem(problem0, "two_transform", cuda_device)
    n = 20
    _outs, col = _traced_runs(lambda: hot_step(s, "two_transform"), n)
    af, tail = (sum(col.device_ms[k]) / n for k in ("assign_flux", "tail"))
    alone = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        hot_step(s, "two_transform")
        b.record()
        b.synchronize()
        alone.append(a.elapsed_time(b))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(int(4e7))  # ~20 ms at 2 GHz: n steps queue meanwhile
    ev[1].record()
    for _ in range(n):
        hot_step(s, "two_transform")
    ev[2].record()
    torch.cuda.synchronize()
    queued = ev[1].elapsed_time(ev[2]) / n
    assert ev[0].elapsed_time(ev[1]) > 5.0  # the spin outlasted the queueing
    assert 0 < af and 0 < tail
    assert af + tail <= sorted(alone)[n // 2]
    assert 0.8 * queued <= af + tail <= 1.05 * queued


@pytest.mark.cuda
def test_bins128_tail_takes_the_float64_loops_rounds_in_every_order(cuda_device):
    """The ``ntl9_100k.bins128`` cell's step (``make_problem`` seed 0, 128
    bins x 25: 3,202 states) with its segments dealt out in twelve orders,
    as the cell's runs deal them (``benchmark/traffic/hot_problem.reorder``):
    in every order the graphed tail (the traced graph's counter) and the
    eager tail take the float64 early-exit loop's rounds on their own flux
    matrix, the same number in every order, and give its outputs within
    their f32 rounding; every traced replay counts as the float64 route."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.traffic.hot_problem import reorder

    base = make_problem(seed=0, n_bins=128)
    S = int(base["n_states"])
    assert S == 3202
    basis, target = _state_masks(S, cuda_device)
    seen = set()
    for seed in range(2**31 + 101, 2**31 + 113):
        s = stage_problem(reorder(base, seed), "two_transform", cuda_device)
        outs, col = _traced_runs(lambda: hot_step(s, "two_transform"), 2)
        want = []
        for o in outs:
            *ref, n_extra = steady_state_early_exit(o["fm"].double(), basis, target)
            want.append(n_extra)
            assert _within_f32_rounding((o["pss"], o["flux"]), ref[1:3]), seed
        assert col.counts["tail_rounds"] == sum(want), (seed, want)
        assert col.counts["tail_f64"] == 2 and col.counts["tail_fused"] == 0
        fm = _hot_step(s, "two_transform")["fm"]
        *ref, n_extra = steady_state_early_exit(fm.double(), basis, target)
        eager, kept = _eager_rounds(fm, basis, target)
        assert kept == n_extra and _within_f32_rounding(eager, ref), seed
        seen |= set(want) | {kept}
        del s, outs
        gc.collect()
    assert len(seen) == 1, seen


# ------------------------------------------ the route of the two_transform step


@pytest.fixture(scope="module")
def route_problems():
    """``make_problem`` seed 0, full size, at 6 bins of 25 centers (below
    ``entry.GROUPED_MIN_OFF_BIN``) and the bins10 and bins128 cells' 10 and
    128, by bin count; made only where the tests that use them run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return {n: make_problem(seed=0, n_bins=n) for n in (6, 10, 128)}


# The wrappers a two_transform step launches, by the bank's bin count: H2
# and the tail kernel at 6 bins; one streaming transform of both sets and
# H3 at 10 and 128, with the tail kernel at 252 states and the f64 tail's
# row kernels at 3,202 (the transition pass, and a renormalisation after
# each of the 9 squarings and of the 16 guarded rounds of the eager
# warm-up)
ROUTE_LAUNCHES = {6: dict(transform_assign=1, steady_tail=1),
                  10: dict(transform_features=1, assign_flux=1, steady_tail=1),
                  128: dict(transform_features=1, assign_flux=1,
                            tail_transition=1, tail_renorm=25)}


@pytest.mark.cuda
def test_bins128_grouped_replay_equals_an_eager_h2_launch(cuda_device,
                                                          route_problems):
    """At 128 bins the step takes the bin-grouped route: its replays give
    an eager H2 launch's ids bitwise, and with dyadic weights its flux."""
    s = stage_problem(route_problems[128], "two_transform", cuda_device)
    assert s["grouped"]
    rng = np.random.default_rng(7)
    s["w"].copy_(torch.as_tensor(rng.integers(1, 17, len(s["w"])) / 16.0))
    ref = sa.transform_assign(
        s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"], s["w"],
        s["basis_p"], s["basis_c"], s["target_c"], s["mean"], s["comp"],
        s["centers"], s["center_bin"], s["valid"], s["n_states"])
    for o in _runs(lambda: hot_step(s, "two_transform"), 3):
        assert torch.equal(o["pidx"], ref[0]) and torch.equal(o["cidx"], ref[1])
        assert torch.equal(o["fm"], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", [6, 10, 128])
def test_the_route_shows_in_counts_and_launches(cuda_device, route_problems,
                                                n_bins):
    """``counts["assign_grouped"]`` and ``counts["features_stream"]`` read
    one a traced replay at 10 and 128 bins and none at 6; the warm-up's
    launch counts show one streaming transform and H3 at 10 and 128 bins
    and H2 alone at 6, and a trace of the replays the streaming kernel and
    H3's only where the step is grouped, H1/H2's only where it is not."""
    grouped = n_bins > 6
    s = stage_problem(route_problems[n_bins], "two_transform", cuda_device)
    assert s["grouped"] is grouped
    before = sa.launch_counts()
    hot_step(s, "two_transform")  # warm-up, capture, replay
    torch.cuda.synchronize()
    mid = sa.launch_counts()
    assert {k: mid[k] - before[k] for k in mid} == {
        k: ROUTE_LAUNCHES[n_bins].get(k, 0) for k in mid}
    traced = _traced_kernels(lambda: hot_step(s, "two_transform"), 3)
    assert (traced["stratified_assign_kernel"] > 0) is not grouped
    assert (traced["transform_features_kernel"] > 0) is grouped
    assert (traced["assign_flux_kernel"] > 0) is grouped
    _outs, col = _traced_runs(lambda: hot_step(s, "two_transform"), 3)
    assert col.counts["assign_grouped"] == (3 if grouped else 0)
    assert col.counts["features_stream"] == (3 if grouped else 0)
