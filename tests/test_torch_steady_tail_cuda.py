"""The tail kernel (``csrc/steady_tail.cu``) on the card, against the plain
early-exit loop (``testing.steady_state_early_exit``, cuBLAS products).
JAX-free, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_steady_tail_cuda.py

Each test skips without a GPU. The kernel sums in other orders than cuBLAS
and torch's reductions, so ``T``, ``p``, JtargetSS and the residual are held
to ``testing.tail_order_excess``: ``(S + 2) eps32`` relatively in ``T`` (a
row sum of ``S`` nonnegative numbers in two orders, and the division),
``1e-4`` relatively (``1e-6``, ``1e-7`` absolutely) in ``p`` and the flux,
the tolerances at which the tests hold this tail to the JAX package's, and
in the residual twice ``||dp||_1`` plus ``2 (S + 1) eps32`` (its own sums).
The residual must also lie within ``testing.tail_residual_excess`` of
``||p T - p||_1`` recomputed in f64 from the kernel's own ``T`` and ``p``
(the rounding of the kernel's sums, 7.7e-7 at 252 states), and on the
loop's side of ``tol``. Its fixed orders make two runs on one flux matrix
bitwise equal.
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import _state_masks, entry, hot_step, stage_problem
from msm_we_tpu_torch.ops import steady_tail as st
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import (
    f32_rounding_excess,
    make_problem,
    steady_state_early_exit,
    tail_order_excess,
    tail_residual_excess,
)

from test_torch_graph_cuda import _bipartite, _coupled


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem0_fm():
    """The hot step's flux of the benchmark's problem (``make_problem``
    seed 0, 252 states), computed on the card once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    s = stage_problem(make_problem(seed=0), "two_transform", "cuda")
    return hot_step(s, "two_transform")["fm"].clone()


def _entry_fm():
    fn, args = entry("cuda")
    S = args[-2].shape[0] + 2
    return tstep._discretize_and_flux(*args, S)[0]


def _dense(S, seed=9):
    return torch.tensor(np.random.default_rng(seed).random((S, S)),
                        dtype=torch.float32, device="cuda")


# name -> (flux matrix maker, tol, extra rounds: exact, a (lo, hi) range, or
# None where the f32 residual may sit at its floor and any count is right)
CASES = {
    "entry_18": (_entry_fm, 1e-6, None),
    "bins10_252": ("problem0", 1e-6, None),
    "s_max": (lambda: _dense(st.S_MAX), 1e-6, None),
    "s_max_plus_1": (lambda: _dense(st.S_MAX + 1), 1e-6, None),
    "round_0": (lambda: _coupled(0.1), 1e-6, 0),
    "round_5": (lambda: _coupled(1.5e-4), 1e-6, (4, 6)),
    "never": (_bipartite, 1e-6, 16),
    "tol_0": ("problem0", 0.0, 16),
}


def _fm(name, problem0_fm):
    make = CASES[name][0]
    if make == "problem0":
        return problem0_fm
    fm = make()
    return fm if isinstance(fm, torch.Tensor) else torch.tensor(fm, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_the_kernel_matches_the_early_exit_loop(cuda_device, problem0_fm, name):
    fm = _fm(name, problem0_fm)
    _make, tol, rounds = CASES[name]
    basis, target = _state_masks(fm.shape[0], cuda_device)
    *got, n = st.steady_tail(fm, basis, target, tol=tol)
    *ref, n_extra = steady_state_early_exit(fm, basis, target, tol=tol)
    torch.cuda.synchronize()
    excess = dict(tail_order_excess(got, ref),
                  **tail_residual_excess(got, ref, tol))
    assert all(v <= 0 for v in excess.values()), (excess, int(n), n_extra)
    if isinstance(rounds, int):
        assert int(n) == n_extra == rounds
    elif rounds is not None:
        assert rounds[0] <= int(n) <= rounds[1]
        assert abs(int(n) - n_extra) <= 1
    assert float(got[1].sum()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bins10_252", "never", "tol_0"])
def test_two_runs_are_bitwise_equal(cuda_device, problem0_fm, name):
    fm = _fm(name, problem0_fm)
    basis, target = _state_masks(fm.shape[0], cuda_device)
    tol = CASES[name][1]
    a = st.steady_tail(fm, basis, target, tol=tol)
    b = st.steady_tail(fm.clone(), basis, target, tol=tol)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [st.S_MAX, st.S_MAX + 1])
def test_the_eager_tail_launches_the_kernel_up_to_s_max(cuda_device, S):
    """At ``S_MAX`` the eager tail is the kernel's; above it the PyTorch
    tail runs in float64 (no launch of the kernel), bitwise the plain
    version, its f32 outputs within their rounding (and 1e-12) of the
    float64 early-exit loop's."""
    fm = _dense(S)
    basis, target = _state_masks(S, cuda_device)
    before = sa.launch_counts()["steady_tail"]
    got = tstep.steady_state_from_flux(fm, basis, target)
    launched = sa.launch_counts()["steady_tail"] - before
    if S <= st.S_MAX:
        ref = st.steady_tail(fm, basis, target)[:4]
        assert launched == 1
    else:
        ref = tstep._steady_state(fm, basis, target, 512, 1e-6, 16,
                                  tstep._where_rounds, torch.float64)
        assert launched == 0
        *loop, _n = steady_state_early_exit(fm.double(), basis, target)
        assert f32_rounding_excess(got, loop) <= 1e-12
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r)


def _bad_inputs(name):
    S = 16
    fm = _dense(S)
    basis, target = _state_masks(S, torch.device("cuda"))
    kw = {}
    if name == "f64":
        fm = fm.double()
    elif name == "transposed":
        fm = fm.t()
    elif name == "not_square":
        fm = fm[:, :8]
    elif name == "mask_dtype":
        basis = basis.to(torch.int8)
    elif name == "mask_on_cpu":
        target = target.cpu()
    elif name == "too_many_states":
        fm = _dense(st.MAX_STATES + 1)
        basis, target = _state_masks(st.MAX_STATES + 1, torch.device("cuda"))
    elif name == "counter_dtype":
        kw["counter"] = torch.zeros((), dtype=torch.int64, device="cuda")
    return (fm, basis, target), kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f64", "transposed", "not_square",
                                  "mask_dtype", "mask_on_cpu",
                                  "too_many_states", "counter_dtype"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, name):
    args, kw = _bad_inputs(name)
    before = sa.launch_counts()["steady_tail"]
    with pytest.raises((TypeError, ValueError)):
        st.steady_tail(*args, **kw)
    assert sa.launch_counts()["steady_tail"] == before


@pytest.mark.cuda
def test_the_counter_gains_the_rounds(cuda_device, problem0_fm):
    basis, target = _state_masks(problem0_fm.shape[0], cuda_device)
    counter = torch.full((), 5, dtype=torch.int32, device=cuda_device)
    *_out, n = st.steady_tail(problem0_fm, basis, target, tol=0.0,
                              counter=counter)
    assert int(n) == 16 and int(counter) == 21


@pytest.mark.cuda
def test_a_step_graph_holds_the_tail_as_one_kernel(cuda_device):
    """A replay of the hot step's graph at 252 states launches the tail
    kernel once and no conditional node's flag kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = make_problem(seed=3, n_segments=8192, n_raw_features=64,
                     n_components=8, n_bins=10, k_per_bin=25)
    s = stage_problem(p, "two_transform", cuda_device)
    hot_step(s, "two_transform")  # capture
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            hot_step(s, "two_transform")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    # The profiler may drop some of a replay's events: at most one a replay
    assert 0 < sum("steady_tail_kernel" in n for n in names) <= reps
    assert not any("set_if_kernel" in n for n in names)
