"""The float64 tail's row kernels (``csrc/tail_rows.cu``) on the card,
against their plain versions in ``step.py``. JAX-free, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tail_rows_cuda.py

Each test skips without a GPU. The kernels sum in float64 in other orders
than torch's reductions, so a renormalised or transition row is held to
``(S + 2) eps64`` of the plain one relatively (a sum of ``S`` nonnegative
numbers in two orders, and the division), and the whole float64 tail to
``testing.tail_order_excess`` in float64, with the plain tail's extra
rounds, eagerly and as a CUDA graph with its conditional nodes. Their
fixed orders make two runs bitwise equal.
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph, tracing
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import _state_masks, hot_step, stage_problem
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.ops import tail_rows as tr
from msm_we_tpu_torch.testing import (
    f32_rounding_excess,
    make_problem,
    steady_state_early_exit,
    tail_order_excess,
)

F32, F64 = torch.float32, torch.float64
EPS64 = torch.finfo(F64).eps


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bins128_fm():
    """The ``ntl9_100k.bins128`` cell's f32 flux (``make_problem`` seed 0,
    128 bins x 25: 3,202 states), computed on the card once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    s = stage_problem(make_problem(seed=0, n_bins=128), "two_transform", "cuda")
    fm = hot_step(s, "two_transform")["fm"].clone()
    del s
    torch.cuda.empty_cache()
    return fm


def _padded(values, pad):
    """``values`` (S, S) f64 in a matrix whose rows start on ``ROW_ALIGN``
    bytes, its padding columns set to ``pad``: ``(matrix, buffer)``."""
    S = values.shape[0]
    ld = tr._aligned_empty(S, F64, values.device).stride(0)
    buf = torch.full((S, ld), pad, dtype=F64, device=values.device)
    a = buf[:, :S]
    a.copy_(values)
    return a, buf


def _within_rows(got, ref):
    """Each value within ``(S + 2) eps64`` of ``ref``'s, relatively."""
    S = ref.shape[0]
    return bool(((got - ref).abs() <= (S + 2) * EPS64 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [641, 3202, 5000])
def test_renormalize_matches_the_plain_division(cuda_device, S):
    """Rows of nonnegative numbers (one all zero, one of a single value)
    divided by their clamped sums: within ``(S + 2) eps64`` of
    ``out / out.sum(1).clamp(min=1e-30)``, the zero row exactly 0, the
    padding columns untouched (NaN stays NaN and adds nothing); 641 states
    end on half a 16-byte pair, 5,000 read a row twice."""
    rng = np.random.default_rng(S)
    x = torch.tensor(rng.random((S, S)), dtype=F64, device=cuda_device)
    x[3] = 0.0
    x[5] = 0.0
    x[5, 7] = 2.5
    a, buf = _padded(x, float("nan"))
    before = sa.launch_counts()["tail_renorm"]
    assert tr.renormalize(a) is a
    torch.cuda.synchronize()
    assert sa.launch_counts()["tail_renorm"] == before + 1
    ref = x / x.sum(1, keepdim=True).clamp(min=1e-30)
    assert _within_rows(a, ref)
    assert torch.equal(a[3], torch.zeros_like(a[3])) and float(a[5, 7]) == 1.0
    assert bool(torch.isnan(buf[:, S:]).all())
    again, _buf = _padded(x, float("nan"))
    tr.renormalize(again)
    assert torch.equal(again, a)


def _transition_case(name, fm):
    """A flux matrix and its masks by ``name``, from the bins128 flux."""
    S = fm.shape[0]
    dev = fm.device
    basis, target = _state_masks(S, dev)
    if name == "idle_rows":  # rows with no outflux, an idle basis state
        fm = fm.clone()
        fm[10:40] = 0.0
        fm[S - 2] = 0.0
    elif name == "empty_basis":
        basis = torch.zeros(S, dtype=torch.bool, device=dev)
    elif name == "many_states":  # several target and basis states
        ids = torch.arange(S, device=dev)
        target = (ids % 97 == 5) | (ids == S - 1)
        basis = (ids % 89 == 3) & ~target
    elif name == "f64_input":
        fm = fm.double()
    return fm, basis, target


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bins128", "idle_rows", "empty_basis",
                                  "many_states", "f64_input"])
def test_transition_matches_the_plain_version(cuda_device, bins128_fm, name):
    """T within ``(S + 2) eps64`` of ``step._transition_matrix`` in float64
    (identity and recycled rows exactly), its padding 0, the copy bitwise
    ``T.to(float32)`` (``T`` itself for an f64 flux), and each row's target
    mass within ``(S + 2) eps64`` of the sum over the target columns."""
    fm, basis, target = _transition_case(name, bins128_fm)
    before = sa.launch_counts()["tail_transition"]
    T, T_out, mass = tr.transition(fm, basis, target)
    torch.cuda.synchronize()
    assert sa.launch_counts()["tail_transition"] == before + 1
    S = fm.shape[0]
    assert T.dtype == F64 and T.stride(0) * 8 % tr.ROW_ALIGN == 0
    ref = tstep._transition_matrix(fm.double(), basis, target)
    assert _within_rows(T, ref)
    exact = (fm.double().sum(1) <= 0) | target
    assert torch.equal(T[exact], ref[exact])
    assert bool((T.as_strided((S, T.stride(0)), T.stride())[:, S:] == 0).all())
    if fm.dtype == F32:
        assert T_out.dtype == F32 and torch.equal(T_out, T.to(F32))
    else:
        assert T_out is T
    want = torch.where(target[None, :], ref, torch.zeros_like(ref)).sum(1)
    assert _within_rows(mass, want)
    again = tr.transition(fm, basis, target)
    for x, y in zip(again, (T, T_out, mass)):
        assert torch.equal(x, y)


def _counted_rounds(fm, basis, target, tol):
    """The eager float64 tail on the row kernels, with the extra rounds its
    guarded rounds kept (each round's flag read after the tail)."""
    flags = []

    def rounds(Tn, p, residual, T, tol, n, **kw):
        for _ in range(n):
            flags.append(residual > tol)
            Tn, p, residual = tstep._where_rounds(Tn, p, residual, T, tol, 1,
                                                  **kw)
        return Tn, p, residual

    out = tstep._steady_state(fm, basis, target, 512, tol, 16, rounds, F64,
                              rows=True)
    return out, sum(int(f) for f in flags)


@pytest.mark.cuda
@pytest.mark.parametrize("tol,rounds", [(1e-6, 0), (0.0, 16)],
                         ids=["rounds_0", "rounds_16"])
def test_the_f64_tail_matches_the_pytorch_tail(cuda_device, bins128_fm, tol,
                                               rounds):
    """At 3,202 states, in float64: the tail on the row kernels, eagerly and
    as a graph with its conditional nodes, lies within the float64 tail's
    bound of the PyTorch tail on the same card and takes its rounds (the
    early-exit loop's: 0 at ``tol`` 1e-6, all 16 at 0); every traced replay
    counts the row route; the replays are bitwise equal, and so are two
    eager runs."""
    fm = bins128_fm.double()
    basis, target = _state_masks(fm.shape[0], cuda_device)
    ref = tstep._steady_state(fm, basis, target, 512, tol, 16,
                              tstep._where_rounds, F64)
    n_extra = steady_state_early_exit(fm, basis, target, tol=tol)[4]
    assert n_extra == rounds
    eager, kept = _counted_rounds(fm, basis, target, tol)
    assert kept == n_extra
    twice = tstep.steady_state_from_flux(fm, basis, target, 512, tol)
    with tracing.collect():
        _graph.run(tstep.steady_state_from_flux, fm, basis, target, 512, tol)
    with tracing.collect() as col:
        graphed = [_graph.run(tstep.steady_state_from_flux, fm, basis, target,
                              512, tol) for _ in range(3)]
    torch.cuda.synchronize()
    assert col.counts["tail_rows"] == 3 and col.counts["tail_f64"] == 0
    assert col.counts["tail_rounds"] == 3 * n_extra
    for got in [eager, twice, *graphed]:
        excess = tail_order_excess(got, ref, F64)
        assert all(v <= 0 for v in excess.values()), excess
    for x, y in zip(eager, twice):
        assert torch.equal(x, y)
    for g in graphed[1:]:
        for x, y in zip(g, graphed[0]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_the_f32_flux_takes_the_row_kernels(cuda_device, bins128_fm):
    """The cell's f32 flux: the eager tail launches the transition pass once
    and 25 renormalisations (9 squarings, 16 guarded rounds), a capture
    launches none, and a trace of the replays shows both kernels; the f32
    outputs lie within their rounding (and 1e-12) of the float64 early-exit
    loop's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fm = bins128_fm
    basis, target = _state_masks(fm.shape[0], cuda_device)
    *loop, _n = steady_state_early_exit(fm.double(), basis, target)
    before = sa.launch_counts()
    got = tstep.steady_state_from_flux(fm, basis, target)
    torch.cuda.synchronize()
    mid = sa.launch_counts()
    assert {k: mid[k] - before[k] for k in mid} == dict(
        dict.fromkeys(mid, 0), tail_transition=1, tail_renorm=25)
    assert f32_rounding_excess(got, loop) <= 1e-12
    _graph.run(tstep.steady_state_from_flux, fm, basis, target)  # capture
    torch.cuda.synchronize()
    after = sa.launch_counts()
    assert after["tail_renorm"] - mid["tail_renorm"] == 25  # the warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _graph.run(tstep.steady_state_from_flux, fm, basis, target)
        torch.cuda.synchronize()
    assert sa.launch_counts() == after
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("tail_transition_kernel" in n for n in names)
    assert any("tail_renorm_kernel" in n for n in names)


def _bad(name, dev):
    S = 16
    basis, target = _state_masks(S, dev)
    a = tr._aligned_empty(S, F64, dev).fill_(1.0)
    fm = torch.ones((S, S), dtype=F32, device=dev)
    if name == "renorm_f32":
        return tr.renormalize, (a.float(),)
    if name == "renorm_rows_of_641":
        return tr.renormalize, (torch.ones((641, 641), dtype=F64, device=dev),)
    if name == "renorm_offset":
        return tr.renormalize, (tr._aligned_empty(S + 1, F64, dev)[1:, 1:],)
    if name == "renorm_transposed":
        return tr.renormalize, (a.t(),)
    if name == "transition_f16":
        return tr.transition, (fm.half(), basis, target)
    if name == "transition_transposed":
        return tr.transition, (fm.t(), basis, target)
    if name == "transition_mask_dtype":
        return tr.transition, (fm, basis.to(torch.int8), target)
    return tr.transition, (fm, basis, target.cpu())  # a mask on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "renorm_f32", "renorm_rows_of_641", "renorm_offset", "renorm_transposed",
    "transition_f16", "transition_transposed", "transition_mask_dtype",
    "transition_mask_on_cpu"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(cuda_device, name):
    fn, args = _bad(name, cuda_device)
    before = sa.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        fn(*args)
    assert sa.launch_counts() == before
