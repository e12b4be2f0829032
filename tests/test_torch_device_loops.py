"""The port's device loops with their convergence checks on the device:
``step.steady_state_from_flux`` (JAX: a ``lax.while_loop`` of extra
squarings) and ``ops.linalg.committor_device`` (JAX: ``committor_jax``),
against the early-exit loops that read the residual on the host (bitwise)
and against the JAX package (the tolerances of
``test_torch_step.py::test_steady_state_from_flux_matches_jax`` and of
``test_torch_analysis.py::test_committor_device_matches_jax``); neither
reads the device inside its rounds. An f32 flux matrix of more than
``ops.steady_tail.S_MAX`` states takes the tail in float64 (a difference
by design from JAX's f32 loop): it is held to the early-exit loop and to
JAX's loop on the same matrix in float64, its outputs within their own f32
rounding (and 1e-12) of those. Also the key and cache logic of
``_graph.py`` on CPU tensors, without a capture.
"""
import gc
import math

import numpy as np
import pytest
import torch

from msm_we_tpu.ops import linalg as jlinalg
from msm_we_tpu.parallel import sharded as jsh
from msm_we_tpu_torch import _graph
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import TIERS, hot_step
from msm_we_tpu_torch.ops import linalg as tlinalg
from msm_we_tpu_torch.ops import steady_tail as st
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import (
    f32_rounding_excess,
    make_problem,
    steady_state_early_exit,
)

from _torch_parity import np_, tt

torch.set_num_threads(1)


# ------------------------------------------------------------ steady state


def _coupled(eps, S=12, seed=0):
    """Two blocks of states joined by flux ``eps`` times the rest: the
    smaller ``eps``, the more extra squarings the tail takes."""
    rng = np.random.default_rng(seed)
    fm = rng.random((S, S))
    block = np.arange(S) < S // 2
    fm[block[:, None] != block[None, :]] *= eps
    return fm.astype(np.float32)


def _bipartite(S=13, seed=1):
    """Flux only between even and odd states (target even, basis odd): a
    chain of period 2. The uniform start puts 7/13 of its mass on the even
    states where the stationary vector puts 1/2, so the residual never
    falls below ``tol``."""
    rng = np.random.default_rng(seed)
    parity = np.arange(S) % 2
    return (rng.random((S, S)) * (parity[:, None] != parity[None, :])
            ).astype(np.float32)


def _lopsided(eps, S=642, ratio=10.0, seed=0):
    """Two halves of the states joined by flux ``eps`` times the rest one
    way and ``ratio * eps`` the other, so the stationary vector lies far
    from the uniform start: the smaller ``eps``, the more extra squarings
    the float64 tail takes."""
    rng = np.random.default_rng(seed)
    fm = rng.random((S, S))
    half = np.arange(S) < S // 2
    fm[half[:, None] & ~half[None, :]] *= eps
    fm[~half[:, None] & half[None, :]] *= eps * ratio
    return fm.astype(np.float32)


@pytest.fixture(scope="module")
def hot_fluxes():
    """The (252, 252) f32 flux of each tier of a small ``make_problem``
    (10 bins x 25 centers) on the CPU."""
    p = make_problem(n_segments=4096, n_raw_features=64, n_components=8,
                     n_bins=10, k_per_bin=25, seed=3)
    return {tier: hot_step(p, tier, "cpu")["fm"].numpy() for tier in TIERS}


# name -> (flux matrix, extra squarings the early-exit loop takes)
CASES = {
    "round_0": (lambda: _coupled(0.1), 0),
    "round_5": (lambda: _coupled(1.5e-4), 5),
    "never": (_bipartite, 16),
}


# Above S_MAX, where an f32 flux matrix takes the float64 tail: name ->
# (flux matrix, extra squarings of the float64 loop, of the f32 loop). The
# f32 residual sits at its rounding floor (about 2e-6 at 642 states), so
# the f32 loop takes all 16 rounds whatever the chain.
WIDE_CASES = {
    "wide_round_0": (lambda: _coupled(0.1, S=642), 0, 16),
    "wide_round_5": (lambda: _lopsided(5e-5), 5, 16),
    "wide_never": (lambda: _bipartite(S=643), 16, 16),
}


def assert_within_f32_rounding(got, ref):
    """Each of the f32 outputs ``got`` lies within its own f32 rounding and
    1e-12 of the float64 ``ref`` (``testing.f32_rounding_excess``)."""
    assert all(g.dtype == torch.float32 for g in got)
    assert f32_rounding_excess(got, ref) <= 1e-12


def _case(name, hot_fluxes):
    if name in TIERS:
        return hot_fluxes[name], None
    make, rounds = CASES[name]
    return make(), rounds


def _masks(S):
    ids = torch.arange(S)
    return ids == S - 2, ids == S - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [*CASES, *TIERS])
def test_steady_state_equals_the_early_exit_loop(name, dtype, hot_fluxes):
    fm, rounds = _case(name, hot_fluxes)
    fm = torch.tensor(fm, dtype=dtype)
    basis, target = _masks(fm.shape[0])
    got = tstep.steady_state_from_flux(fm, basis, target)
    *ref, n_extra = steady_state_early_exit(fm, basis, target)
    if rounds is not None and dtype == torch.float32:
        assert n_extra == rounds
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("name", [*CASES, *TIERS])
def test_steady_state_matches_jax(name, hot_fluxes):
    fm, _rounds = _case(name, hot_fluxes)
    basis, target = (np_(m) for m in _masks(fm.shape[0]))
    jT, jp, jflux, jres = (np.asarray(o) for o in jsh.steady_state_from_flux(
        fm, basis, target))
    T, p, flux, res = tstep.steady_state_from_flux(tt(fm), tt(basis), tt(target))
    np.testing.assert_allclose(np_(T), jT, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np_(p), jp, rtol=1e-4, atol=1e-6)
    assert float(flux) == pytest.approx(float(jflux), rel=1e-4, abs=1e-7)
    assert (float(res) <= 1e-6) == (float(jres) <= 1e-6)


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_the_f64_route_equals_the_float64_loop(name):
    """Above ``S_MAX`` an f32 flux matrix's tail is the early-exit loop run
    on it in float64, its outputs cast to f32: the float64 loop's rounds,
    where the f32 loop's follow its rounding floor."""
    make, rounds64, rounds32 = WIDE_CASES[name]
    fm = torch.tensor(make())
    assert fm.shape[0] > st.S_MAX
    basis, target = _masks(fm.shape[0])
    got = tstep.steady_state_from_flux(fm, basis, target)
    *ref, n_extra = steady_state_early_exit(fm.double(), basis, target)
    assert n_extra == rounds64
    assert steady_state_early_exit(fm, basis, target)[-1] == rounds32
    assert_within_f32_rounding(got, ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r.float())


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_the_f64_route_matches_jax_in_float64(name):
    """JAX's ``while_loop`` on the same matrix in float64: the f64 route's
    outputs lie within their f32 rounding and 1e-12 of it, and its residual
    on the same side of ``tol``."""
    from msm_we_tpu.utils import _scoped_x64

    fm = WIDE_CASES[name][0]()
    basis, target = (np_(m) for m in _masks(fm.shape[0]))
    with _scoped_x64():
        ref = [torch.tensor(np.asarray(o)) for o in jsh.steady_state_from_flux(
            fm.astype(np.float64), basis, target)]
    assert all(r.dtype == torch.float64 for r in ref)
    got = tstep.steady_state_from_flux(tt(fm), tt(basis), tt(target))
    assert_within_f32_rounding(got[:3], ref[:3])
    assert (float(got[3]) <= 1e-6) == (float(ref[3]) <= 1e-6)


def _refuse_host_reads(monkeypatch, allow_bool=None):
    """Make every read of a tensor's value into Python raise; with
    ``allow_bool`` (a list), ``bool()`` is allowed and counted in it."""
    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "tolist", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    if allow_bool is None:
        monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    else:
        real = torch.Tensor.__bool__

        def counted(t):
            allow_bool.append(1)
            return real(t)

        monkeypatch.setattr(torch.Tensor, "__bool__", counted)


@pytest.mark.parametrize("name", list(CASES))
def test_steady_state_reads_nothing_on_the_host(name, monkeypatch):
    fm = torch.tensor(CASES[name][0]())
    basis, target = _masks(fm.shape[0])
    _refuse_host_reads(monkeypatch)
    T, p, flux, res = tstep.steady_state_from_flux(fm, basis, target)
    monkeypatch.undo()
    assert torch.isfinite(p).all() and torch.isfinite(res)


def test_tol_compares_as_a_float64_would():
    """``f64_threshold``: an f32 residual against it decides as
    ``float(residual) > tol`` does, also where f32(tol) rounds up."""
    from msm_we_tpu_torch._device import f64_threshold

    for tol in (1e-6, 1e-10, 0.1, 3.0):
        t = f64_threshold(tol, torch.float32)
        x = torch.tensor(np.float32(tol))
        up = torch.nextafter(x, torch.tensor(np.inf, dtype=torch.float32))
        for v in (x, up, torch.nextafter(x, torch.tensor(-np.inf))):
            assert bool(v > t) == (float(v) > tol)
            assert bool(v <= t) == (float(v) <= tol)
    assert f64_threshold(1e-10, torch.float64) == 1e-10


# --------------------------------------------------------------- committor


def _committor_early_exit(M, target_mask, basis_mask, conv, max_iters):
    """The committor iteration as it was: the residual read on the host
    after every step. Returns ``(q, steps, changes)``."""
    eye = torch.eye(M.shape[0], dtype=M.dtype)
    M = torch.where(basis_mask[:, None], eye, M)
    one = torch.ones((), dtype=M.dtype)
    zero = torch.zeros((), dtype=M.dtype)
    q = torch.where(target_mask, one, zero)
    changes = []
    for step in range(1, max_iters + 1):
        qn = M @ torch.where(target_mask, one, torch.where(basis_mask, zero, q))
        changes.append(float((q - qn).abs().sum()))
        q = qn
        if changes[-1] <= conv:
            break
    return q, step, changes


@pytest.fixture(scope="module")
def slow_chain():
    """An 8-state chain with a bottleneck: the committor's L1 changes fall
    strictly for more than 65 steps."""
    rng = np.random.default_rng(6)
    F = rng.random((8, 8))
    F[:4, 4:] *= 0.02
    F[4:, :4] *= 0.02
    M = torch.tensor(F / F.sum(1, keepdims=True), dtype=torch.float32)
    ids = torch.arange(8)
    _q, _n, changes = _committor_early_exit(M, ids == 7, ids == 0, -1.0, 70)
    assert np.all(np.diff(changes) < 0)
    return M, ids == 7, ids == 0, changes


# (conv, max_iters, steps the early-exit loop takes); conv None: the
# change at that step, so the loop stops exactly there
COMMITTOR_CASES = {
    "step_1": (None, 10_000, 1),
    "step_63": (None, 10_000, 63),
    "step_64": (None, 10_000, 64),
    "step_65": (None, 10_000, 65),
    "max_iters": (-1.0, 100, 100),
}


@pytest.mark.parametrize("name", list(COMMITTOR_CASES))
def test_committor_equals_the_early_exit_loop(name, slow_chain, monkeypatch):
    M, target, basis, changes = slow_chain
    conv, max_iters, steps = COMMITTOR_CASES[name]
    if conv is None:
        conv = changes[steps - 1]
    ref, n, _ = _committor_early_exit(M, target, basis, conv, max_iters)
    assert n == steps
    reads = []
    _refuse_host_reads(monkeypatch, allow_bool=reads)
    got = tlinalg.committor_device(M, target, basis, conv=conv,
                                   max_iters=max_iters)
    monkeypatch.undo()
    assert torch.equal(got, ref)
    # One read of the device flag a block of guarded steps
    assert len(reads) == math.ceil(steps / tlinalg.COMMITTOR_BLOCK)


@pytest.mark.parametrize("name", ["step_63", "step_65", "max_iters"])
def test_committor_matches_committor_jax(name, slow_chain):
    import jax.numpy as jnp

    M, target, basis, changes = slow_chain
    conv, max_iters, steps = COMMITTOR_CASES[name]
    if conv is None:
        conv = changes[steps - 1]
    ref = np.asarray(jlinalg.committor_jax(
        jnp.asarray(np_(M)), jnp.asarray(np_(target)), jnp.asarray(np_(basis)),
        conv=conv, max_iters=max_iters))
    got = tlinalg.committor_device(M, target, basis, conv=conv,
                                   max_iters=max_iters)
    assert float(got[0]) == 0.0
    np.testing.assert_allclose(np_(got), ref, atol=1e-4)


# ------------------------------------------------------------------ graphs


class _FakeCapture:
    """Counts captures; an entry's replay returns which capture it was."""

    def __init__(self):
        self.n = 0

    def __call__(self, fn, args, device, traced=False):
        assert fn is _step and not traced
        assert device == torch.device("cpu") and args[-1] in TIERS
        self.n += 1
        n = self.n

        class Entry:
            def launch(self):
                pass

            def copy_out(self):
                return n

        return Entry()


def _step(a, b, tier):
    return a + b


def test_graph_key_reads_identity_layout_and_values():
    a, b = torch.zeros(4, 3), torch.ones(4, 3)
    key = _graph.graph_key(_step, [a, b, "dedup"])
    assert key == _graph.graph_key(_step, [a, b, "dedup"])
    others = [
        (_step, [a, b, "two_transform"]),  # a value
        (_step, [a, b.clone(), "dedup"]),  # another buffer
        (_step, [a, b.t(), "dedup"]),  # shape and stride
        (_step, [a, b[:, :2], "dedup"]),  # shape, same pointer
        (_step, [a, b.double(), "dedup"]),  # dtype
        (lambda *x: 0, [a, b, "dedup"]),  # the callable
    ]
    for fn, leaves in others:
        assert _graph.graph_key(fn, leaves) != key
    with pytest.raises(TypeError):
        _graph.graph_key(_step, [a, np.zeros(3)])


def test_graph_cache_captures_once_a_key_and_keeps_four():
    fake = _FakeCapture()
    cache = _graph.GraphCache(capture=fake, device_type="cpu")
    inputs = [(torch.zeros(2), torch.zeros(2)) for _ in range(5)]
    for rep in range(2):  # the second pass only replays
        for x in inputs[:4]:
            cache.run(_step, *x, "dedup")
    assert fake.n == 4 and len(cache) == 4
    # Writing new values into a key's tensors keeps its graph
    inputs[0][0].fill_(3.0)
    assert cache.run(_step, *inputs[0], "dedup") == 1
    cache.run(_step, *inputs[4], "dedup")  # evicts the least recent: #2
    assert fake.n == 5 and len(cache) == 4
    assert cache.run(_step, *inputs[0], "dedup") == 1
    assert cache.run(_step, *inputs[1], "dedup") == 6  # captured anew
    assert cache.run(_step, *inputs[0], "two_transform") == 7


def test_graph_cache_drops_a_graph_whose_input_is_freed():
    fake = _FakeCapture()
    cache = _graph.GraphCache(capture=fake, device_type="cpu")
    keep, freed = torch.zeros(3), torch.zeros(3)
    cache.run(_step, keep, freed, "dedup")
    cache.run(_step, keep, keep, "dedup")
    assert len(cache) == 2
    key = _graph.graph_key(_step, [keep, freed, "dedup"])
    del freed
    gc.collect()
    assert len(cache) == 1 and key not in cache


def test_run_is_eager_on_cpu_tensors(monkeypatch):
    def never(*_a, **_k):
        raise AssertionError("a graph was captured for CPU tensors")

    monkeypatch.setattr(_graph._CACHE, "_capture", never)
    before = len(_graph._CACHE)
    a = torch.arange(3.0)
    assert torch.equal(_graph.run(_step, a, a, "dedup"), 2 * a)
    assert len(_graph._CACHE) == before


@pytest.mark.parametrize("capturing", [False, True])
def test_a_launch_counts_only_outside_a_capture(capturing, monkeypatch):
    """A wrapper called while its stream is captured records its launch in
    the graph and launches nothing, so it counts nothing."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    before = {**sa.launch_counts(), "scores": sa.pair_assign.score_launches}
    sa._count_launch(sa.pair_assign, scores=True)
    sa._count_launch(sa.assign_flux)
    after = {**sa.launch_counts(), "scores": sa.pair_assign.score_launches}
    n = 0 if capturing else 1
    assert {k: after[k] - before[k] for k in after} == dict(
        transform_assign_child=0, transform_assign=0, assign_flux=n,
        pair_assign=n, steady_tail=0, scores=n)
    sa.pair_assign.launches -= n
    sa.pair_assign.score_launches -= n
    sa.assign_flux.launches -= n


def test_the_capture_hooks_do_nothing_outside_a_capture():
    """Outside a capture the step's hooks record nothing and give no
    counter; inside an untraced one ``count`` adds up and the traced-only
    hooks still record nothing; a traced one has one counter, one name."""
    assert not _graph.capturing()
    _graph.mark("tail")
    _graph.count("tail_fused", True)
    assert _graph.counter("tail_rounds") is None
    cap = _graph._Capture("cpu")
    _graph._local.capture = cap
    try:
        assert _graph.capturing()
        _graph.mark("tail")
        _graph.count("tail_fused", True)
        _graph.count("tail_fused", 2)
        _graph.count("tail_f64", False)
        assert _graph.counter("tail_rounds") is None
    finally:
        _graph._local.capture = None
    assert cap.counts == dict(tail_fused=3, tail_f64=0)
    assert cap.marks == [] and cap.counter_name is None
    # A traced capture hands out its one counter, made before the capture
    traced = _graph._Capture("cpu", traced=True)
    traced.counter = torch.zeros((), dtype=torch.int32)
    _graph._local.capture = traced
    try:
        assert _graph.counter("tail_rounds") is traced.counter
        assert _graph.counter("tail_rounds") is traced.counter
        with pytest.raises(ValueError, match="counts 'tail_rounds'"):
            _graph.counter("other")
    finally:
        _graph._local.capture = None
    assert traced.counter_name == "tail_rounds"


def test_conditional_needs_a_capture():
    with pytest.raises(RuntimeError, match="needs a capture"):
        with _graph.conditional(torch.tensor(True)):
            pass


@pytest.mark.parametrize("name", list(CASES))
def test_conditional_rounds_take_the_early_exit_loops_rounds(name,
                                                            monkeypatch):
    """The graph form of the tail, with each conditional node run as the
    graph runs it (its block only where the flag holds), gives the early-exit
    loop's result bitwise: its rounds write into the tail's own tensors."""
    from contextlib import contextmanager

    taken = []

    @contextmanager
    def run_where(flag):
        go = bool(flag)
        taken.append(go)
        saved = [t.clone() for t in state] if not go else None
        yield
        if saved is not None:  # the block ran for its side effects only
            for t, v in zip(state, saved):
                t.copy_(v)

    def rounds(Tn, p, residual, T, tol, n_rounds):
        state[:] = [Tn, p, residual]
        return tstep._conditional_rounds(Tn, p, residual, T, tol, n_rounds)

    state = []
    monkeypatch.setattr(_graph, "conditional", run_where)
    fm = torch.tensor(CASES[name][0]())
    basis, target = _masks(fm.shape[0])
    got = tstep._steady_state(fm, basis, target, 512, 1e-6, 16, rounds,
                              fm.dtype)
    *ref, n_extra = steady_state_early_exit(fm, basis, target)
    assert len(taken) == 16 and sum(taken) == n_extra == CASES[name][1]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_conditional_rounds_take_the_float64_loops_rounds(name, monkeypatch):
    """The graph form of the float64 route, each conditional node run as the
    graph runs it: the float64 loop's rounds, and its outputs cast to f32."""
    from contextlib import contextmanager

    taken, state = [], []

    @contextmanager
    def run_where(flag):
        go = bool(flag)
        taken.append(go)
        saved = [t.clone() for t in state] if not go else None
        yield
        if saved is not None:
            for t, v in zip(state, saved):
                t.copy_(v)

    def rounds(Tn, p, residual, T, tol, n_rounds):
        assert Tn.dtype == p.dtype == residual.dtype == torch.float64
        state[:] = [Tn, p, residual]
        return tstep._conditional_rounds(Tn, p, residual, T, tol, n_rounds)

    monkeypatch.setattr(_graph, "conditional", run_where)
    make, rounds64, _rounds32 = WIDE_CASES[name]
    fm = torch.tensor(make())
    basis, target = _masks(fm.shape[0])
    got = tstep._steady_state(fm, basis, target, 512, 1e-6, 16, rounds,
                              st.tail_dtype(fm.dtype, fm.shape[0]))
    *ref, n_extra = steady_state_early_exit(fm.double(), basis, target)
    assert len(taken) == 16 and sum(taken) == n_extra == rounds64
    for g, r in zip(got, ref):
        assert torch.equal(g, r.float())


def test_flux_order_bound_covers_another_summation_order():
    """Two f32 scatters of the same weights in different row orders differ
    (the CPU adds in row order) and stay within the bound in every cell."""
    from msm_we_tpu_torch.testing import flux_order_bound

    rng = np.random.default_rng(2)
    n, S = 20_000, 7
    w = torch.tensor(np.exp(rng.uniform(np.log(1e-6), 0, n)), dtype=torch.float32)
    pidx = torch.tensor(rng.integers(0, S, n), dtype=torch.int32)
    cidx = torch.tensor(rng.integers(0, S, n), dtype=torch.int32)
    perm = torch.tensor(rng.permutation(n))
    a = tstep._scatter_flux(pidx, cidx, w, S).double()
    b = tstep._scatter_flux(pidx[perm], cidx[perm], w[perm], S).double()
    bound = flux_order_bound(pidx, cidx, w, S)
    assert not torch.equal(a, b)
    assert ((a - b).abs() <= bound).all()
    exact = tstep._scatter_flux(pidx, cidx, w.double(), S)
    assert ((a - exact).abs() <= bound / 2).all()
