"""The hot step and ``entry()`` as CUDA graph replays (``_graph.py``) against
their eager launches, on the card. JAX-free, so they also run on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_cuda.py

Each test skips without a GPU. Ids must be bitwise the eager step's. The
f32 flux adds with ``atomicAdd`` in a run-dependent order, so ``fm`` must
lie within ``testing.flux_order_bound`` of an eager step's in each cell,
and the graphed ``pss``, JtargetSS and residual must equal, bitwise, the
eager tail run on the graphed ``fm``; dyadic weights (``entry()``) make the
flux exact in any order, so there everything is bitwise.
"""
import gc

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import (
    TIERS,
    _hot_step_eager,
    _hot_step_graphed,
    _state_masks,
    entry,
    hot_step,
    stage_problem,
)
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import (
    flux_order_bound,
    make_problem,
    steady_state_early_exit,
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
    eager = _runs(lambda: _hot_step_eager(s, tier))
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


# The wrappers each tier's step calls
TIER_KERNELS = {"two_transform": ["transform_assign"],
                "dedup": ["transform_assign_child", "assign_flux"]}


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
    before = sa.launch_counts()
    hot_step(s, tier)  # warm-up, capture, replay
    torch.cuda.synchronize()
    mid = sa.launch_counts()
    traced = _traced_kernels(lambda: hot_step(s, tier), 3)
    after = sa.launch_counts()
    assert {k: mid[k] - before[k] for k in mid} == {
        k: int(k in TIER_KERNELS[tier]) for k in mid}
    assert after == mid
    for name in TIER_KERNELS[tier]:
        assert traced[sa.KERNEL_SYMBOLS[name]] > 0
    assert traced["pair_assign_kernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
def test_a_second_staged_problem_captures_its_own_graph(cuda_device, problems,
                                                        tier):
    a, b = (stage_problem(p, tier, cuda_device) for p in problems)
    ka = _graph.graph_key(_hot_step_graphed, _graph.pytree.tree_leaves((a, tier)))
    kb = _graph.graph_key(_hot_step_graphed, _graph.pytree.tree_leaves((b, tier)))
    ga, gb = hot_step(a, tier), hot_step(b, tier)
    assert ka in _graph._CACHE and kb in _graph._CACHE
    _assert_like_eager([ga], _runs(lambda: _hot_step_eager(a, tier)), a["w"])
    _assert_like_eager([gb], _runs(lambda: _hot_step_eager(b, tier)), b["w"])
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
    _assert_like_eager(graphed, _runs(lambda: _hot_step_eager(other, tier)),
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


@pytest.mark.cuda
@pytest.mark.parametrize("make,rounds", [(lambda: _coupled(0.1), 0),
                                         (lambda: _coupled(1.5e-4), 5),
                                         (_bipartite, 16)],
                         ids=["round_0", "round_5", "never"])
def test_graphed_tail_equals_the_early_exit_loop(cuda_device, make, rounds):
    """The tail's rounds as conditional nodes of a graph: the early-exit
    loop's result, bitwise, on the same device tensors. ``round_5`` may take
    a round more or less on the card, whose sums round otherwise; ``never``
    takes every conditional body."""
    fm = torch.tensor(make(), device=cuda_device)
    ids = torch.arange(fm.shape[0], device=cuda_device)
    basis, target = ids == fm.shape[0] - 2, ids == fm.shape[0] - 1
    *ref, n_extra = steady_state_early_exit(fm, basis, target)
    if rounds in (0, 16):
        assert n_extra == rounds
    else:
        assert 0 < n_extra < 16
    for _ in range(2):
        got = _graph.run(tstep.steady_state_from_flux,
                         _graph.steady_state_conditional, fm, basis, target)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
