"""The tail kernel's route, plain version and wiring on the CPU
(``ops/steady_tail.py``, ``csrc/steady_tail.cu``). The kernel itself runs
only on the card: ``tests/test_torch_steady_tail_cuda.py``.

* the route: CUDA, f32 and at most ``S_MAX`` states take the kernel, and
  nothing else does; an f32 matrix of more than ``S_MAX`` states takes the
  PyTorch tail in float64, on the CPU and on CUDA alike, its outputs in
  f32; the tail asks the rules once, outside a capture and inside one
  (emulated on the CPU), and a capture counts its route;
* a 128-bin hot step on the CPU (642 states: the float64 route) passes the
  ``ntl9_100k.bins128`` cell's check (``benchmark/reference/hot_step.py``)
  within the cell's limits;
* the plain version is the PyTorch tail with guarded rounds, bitwise the
  early-exit loop, which counts the rounds;
* the bounds the card tests hold the kernel to pass between two summation
  orders of the plain tail, and fail a residual moved or decided wrongly;
* the tail's launches are counted with the other kernels';
* the traced graph counts the replays whose tail took the kernel or the
  float64 route;
* the kernel source carries its note.
"""
import json
import sys
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph, tracing
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.ops import steady_tail as st
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import (
    steady_state_early_exit,
    tail_order_excess,
    tail_residual_excess,
)

from test_torch_device_loops import CASES, WIDE_CASES

torch.set_num_threads(1)


def _masks(S):
    ids = torch.arange(S)
    return ids == S - 2, ids == S - 1


F32, F64, F16 = torch.float32, torch.float64, torch.float16

# (device, dtype, S, takes the kernel, dtype of the PyTorch tail)
ROUTES = {
    "cpu_f32": ("cpu", F32, 252, False, F32),
    "cpu_f32_entry": ("cpu", F32, 18, False, F32),
    "cuda_f32_entry": ("cuda", F32, 18, True, F32),
    "cuda_f32_bins10": ("cuda", F32, 252, True, F32),
    "cuda_f32_s_max": ("cuda", F32, st.S_MAX, True, F32),
    "cuda_f32_above": ("cuda", F32, st.S_MAX + 1, False, F64),
    "cuda_f32_bins128": ("cuda", F32, 3202, False, F64),
    "cuda_f64": ("cuda", F64, 252, False, F64),
    "cuda_f16": ("cuda", F16, 252, False, F16),
    "cpu_f32_s_max": ("cpu", F32, st.S_MAX, False, F32),
    "cpu_f32_above": ("cpu", F32, st.S_MAX + 1, False, F64),
    "cpu_f32_bins128": ("cpu", F32, 3202, False, F64),
    "cuda_f64_bins128": ("cuda", F64, 3202, False, F64),
    "cuda_f16_bins128": ("cuda", F16, 3202, False, F16),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_the_route_rule(name):
    device, dtype, S, kernel, tail = ROUTES[name]
    assert st.uses_kernel(torch.device(device), dtype, S) is kernel
    assert st.uses_kernel(device, dtype, S) is kernel
    assert st.tail_dtype(dtype, S) is tail


def test_s_max_lies_between_the_cells_sizes():
    assert 252 <= st.S_MAX < min(3202, st.MAX_STATES)


class _FakeKernel:
    """Stands in for the kernel wrapper on CPU tensors: records its calls
    and returns the plain version's outputs (no round count)."""

    def __init__(self):
        self.calls = []

    def __call__(self, fm, basis, target, n_iters=512, tol=1e-6,
                 max_extra_squarings=16, counter=None):
        self.calls.append(dict(n_iters=n_iters, tol=tol,
                               max_extra=max_extra_squarings, counter=counter))
        return (*tstep._steady_state(fm, basis, target, n_iters, tol,
                                     max_extra_squarings, tstep._where_rounds,
                                     fm.dtype),
                torch.zeros((), dtype=torch.int32))


@contextmanager
def _capture_on_cpu(monkeypatch):
    """What ``step.steady_state_from_flux`` sees of a capture by ``_graph``
    (an untraced one), on CPU tensors: each conditional node of
    ``step._conditional_rounds`` runs its block where its flag holds and
    undoes it where it does not, as a replay does. Yields the capture,
    whose ``counts`` the tail fills."""
    cap = _graph._Capture("cpu")
    state = []

    @contextmanager
    def run_where(flag):
        saved = None if bool(flag) else [t.clone() for t in state]
        yield
        if saved is not None:
            for t, v in zip(state, saved):
                t.copy_(v)

    real_rounds = tstep._conditional_rounds

    def rounds(Tn, p, residual, T, tol, n_rounds, **kw):
        state[:] = [Tn, p, residual]
        return real_rounds(Tn, p, residual, T, tol, n_rounds, **kw)

    monkeypatch.setattr(_graph, "conditional", run_where)
    monkeypatch.setattr(tstep, "_conditional_rounds", rounds)
    monkeypatch.setattr(_graph._local, "capture", cap, raising=False)
    try:
        yield cap
    finally:
        _graph._local.capture = None


def _within(form, monkeypatch):
    """``form`` "eager": outside a capture; "graphed": inside one."""
    return (_capture_on_cpu(monkeypatch) if form == "graphed"
            else nullcontext())


@pytest.mark.parametrize("form", ["eager", "graphed"])
@pytest.mark.parametrize("kernel", [True, False])
def test_the_tail_asks_the_route(form, kernel, monkeypatch):
    """Outside a capture ("eager") and inside one ("graphed") the tail asks
    the route once and launches the kernel exactly where it says so, with
    the caller's settings and, outside a traced capture, no counter;
    elsewhere the PyTorch tail runs unchanged. A capture counts the route
    it took."""
    fake = _FakeKernel()
    asked = []

    def rule(device, dtype, S):
        asked.append((torch.device(device).type, dtype, S))
        return kernel

    monkeypatch.setattr(st, "uses_kernel", rule)
    monkeypatch.setattr(st, "steady_tail", fake)
    fm = torch.tensor(CASES["round_5"][0]())
    basis, target = _masks(fm.shape[0])
    with _within(form, monkeypatch) as cap:
        got = tstep.steady_state_from_flux(fm, basis, target, n_iters=256,
                                           tol=1e-5)
    assert asked == [("cpu", torch.float32, 12)]
    ref = tstep._steady_state(fm, basis, target, 256, 1e-5, 16,
                              tstep._where_rounds, fm.dtype)
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert fake.calls == ([dict(n_iters=256, tol=1e-5, max_extra=16,
                                counter=None)] if kernel else [])
    if cap is not None:
        assert cap.counts == dict(tail_fused=int(kernel), tail_f64=0,
                                  tail_rows=0)


@pytest.mark.parametrize("form", ["eager", "graphed"])
def test_both_forms_ask_the_dtype_rule(form, monkeypatch):
    """Outside a capture and inside one the tail takes its dtype from
    ``tail_dtype`` alone: told float64 for a small f32 matrix, both run the
    float64 early-exit loop's tail and return it in f32, and a capture
    counts the float64 route."""
    asked = []

    def rule(dtype, S):
        asked.append((dtype, S))
        return torch.float64

    monkeypatch.setattr(st, "tail_dtype", rule)
    fm = torch.tensor(CASES["round_5"][0]())
    basis, target = _masks(fm.shape[0])
    *ref, n_extra = steady_state_early_exit(fm.double(), basis, target)
    with _within(form, monkeypatch) as cap:
        got = tstep.steady_state_from_flux(fm, basis, target)
    if cap is not None:
        assert cap.counts == dict(tail_fused=0, tail_f64=1, tail_rows=0)
    assert asked == [(torch.float32, 12)]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r.float())


# name -> (flux matrix, its dtype, whether a capture takes the f64 route)
CAPTURES = {
    "f32_small": (lambda: CASES["round_5"][0](), torch.float32, False),
    "f32_above": (lambda: WIDE_CASES["wide_round_5"][0](), torch.float32, True),
    "f64_above": (lambda: WIDE_CASES["wide_round_5"][0](), torch.float64, False),
}


@pytest.mark.parametrize("name", list(CAPTURES))
def test_a_capture_is_marked_where_its_tail_takes_the_f64_route(name,
                                                                monkeypatch):
    """Inside a capture the tail counts the float64 route (and so the
    traced graph's ``tail_f64``) only for an f32 matrix above ``S_MAX``,
    and returns the eager route's outputs in the input's dtype."""
    make, dtype, f64 = CAPTURES[name]
    fm = torch.tensor(make(), dtype=dtype)
    basis, target = _masks(fm.shape[0])
    with _capture_on_cpu(monkeypatch) as cap:
        got = tstep.steady_state_from_flux(fm, basis, target)
    assert cap.counts == dict(tail_fused=0, tail_f64=int(f64), tail_rows=0)
    for g, e in zip(got, tstep.steady_state_from_flux(fm, basis, target)):
        assert g.dtype == dtype and torch.equal(g, e)


def _cell_limits():
    root = Path(__file__).resolve().parents[1]
    path = root / "benchmark" / "workloads" / "ntl9_100k.bins128.json"
    return json.loads(path.read_text())["checks"]


def test_a_128_bin_hot_step_passes_the_cells_check():
    """``make_problem(n_bins=128, k_per_bin=5)``: 642 states, above
    ``S_MAX``, so the CPU step's tail runs in float64. Its outputs, judged
    by the benchmark's float64 reference, lie within every limit of the
    ``ntl9_100k.bins128`` cell; the f32 tail, at its rounding floor, takes
    all 16 extra squarings on the same flux matrix."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.reference.hot_step import Judge
    from msm_we_tpu_torch.entry import hot_step
    from msm_we_tpu_torch.testing import make_problem

    p = make_problem(n_segments=4096, n_raw_features=64, n_components=8,
                     n_bins=128, k_per_bin=5, seed=0)
    assert p["n_states"] == 642 > st.S_MAX
    out = hot_step(p, "two_transform", "cpu")
    assert out["pss"].dtype == torch.float32
    basis, target = _masks(642)
    *_ref, n64 = steady_state_early_exit(out["fm"].double(), basis, target)
    assert n64 == 0
    assert steady_state_early_exit(out["fm"], basis, target)[-1] == 16
    numbers = Judge(p)(out)
    limits = _cell_limits()
    assert set(limits) <= set(numbers)
    for name, limit in limits.items():
        assert numbers[name] <= limit, (name, numbers[name], limit)


@pytest.mark.parametrize("tol", [1e-6, 0.0])
@pytest.mark.parametrize("name", list(CASES))
def test_the_plain_version_is_the_pytorch_tail_with_its_rounds(name, tol):
    """The kernel's plain version, the PyTorch tail with guarded rounds, is
    bitwise the early-exit loop (which counts the rounds) and the CPU
    route."""
    fm = torch.tensor(CASES[name][0]())
    basis, target = _masks(fm.shape[0])
    got = tstep._steady_state(fm, basis, target, 512, tol, 16,
                              tstep._where_rounds, fm.dtype)
    *ref, n_extra = steady_state_early_exit(fm, basis, target, tol=tol)
    assert n_extra == (16 if tol == 0.0 else CASES[name][1])
    for g, r, e in zip(got, ref, tstep.steady_state_from_flux(
            fm, basis, target, tol=tol)):
        assert torch.equal(g, r) and torch.equal(g, e)


def _relabel(fm, perm):
    """The flux of the same chain with its states renumbered by ``perm``
    (basis and target stay the last two): the same tail summed in other
    orders."""
    return fm[perm][:, perm]


@pytest.mark.parametrize("name", list(CASES))
def test_the_bound_holds_between_two_summation_orders(name):
    """``testing.tail_order_excess``: the plain tail of a chain and of the
    same chain with its other states renumbered (its sums taken in another
    order) lie within the bound; the residual's term still holds where it
    sits at the rounding floor."""
    fm = torch.tensor(CASES[name][0]())
    S = fm.shape[0]
    basis, target = _masks(S)
    rng = np.random.default_rng(5)
    perm = torch.tensor(np.concatenate([rng.permutation(S - 2), [S - 2, S - 1]]))
    T, p, flux, res = tstep.steady_state_from_flux(fm, basis, target)
    T2, p2, flux2, res2 = tstep.steady_state_from_flux(_relabel(fm, perm),
                                                       basis, target)
    inv = torch.argsort(perm)
    got = (T2[inv][:, inv], p2[inv], flux2, res2)
    excess = tail_order_excess(got, (T, p, flux, res))
    assert all(v <= 0 for v in excess.values()), excess
    far = (T, p * 1.01, flux, res)
    assert tail_order_excess(far, (T, p, flux, res))["p"] > 0


@pytest.mark.parametrize("bad", ["cpu", "cpu_f64"])
def test_the_wrapper_refuses_cpu_tensors(bad):
    fm = torch.zeros((4, 4), dtype=torch.float64 if bad == "cpu_f64" else
                     torch.float32)
    basis, target = _masks(4)
    before = sa.launch_counts()["steady_tail"]
    with pytest.raises(ValueError, match="CUDA flux matrix"):
        st.steady_tail(fm, basis, target)
    assert sa.launch_counts()["steady_tail"] == before


@pytest.mark.parametrize("capturing", [False, True])
def test_the_tails_launches_are_counted_with_the_other_kernels(capturing,
                                                               monkeypatch):
    """One reset and one read cover the tail's kernel: a launch counts
    outside a capture and not inside one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    assert sa.KERNELS["steady_tail"] is st.steady_tail
    assert sa.KERNEL_SYMBOLS["steady_tail"] == "steady_tail_kernel"
    sa.reset_launch_counts()
    sa._count_launch(st.steady_tail)
    assert sa.launch_counts() == dict(dict.fromkeys(sa.KERNELS, 0),
                                      steady_tail=int(not capturing))
    sa.reset_launch_counts()
    assert sa.launch_counts()["steady_tail"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_the_residual_check(name):
    """``testing.tail_residual_excess`` on the plain tail (torch's sums,
    whose rounding lies far inside the bound of the kernel's): its own
    residual passes, and fails once moved by twice the bound or decided on
    the other side of ``tol``."""
    fm = torch.tensor(CASES[name][0]())
    basis, target = _masks(fm.shape[0])
    T, p, flux, res = ref = tstep.steady_state_from_flux(fm, basis, target)
    ok = tail_residual_excess(ref, ref, 1e-6)
    assert ok["own"] <= 0 and ok["side"] == 0, ok
    r64 = float((p.double() @ T.double() - p.double()).abs().sum())
    bound = abs(float(res) - r64) - ok["own"]
    moved = (T, p, flux, res + 2 * bound)
    assert tail_residual_excess(moved, ref, 1e-6)["own"] > 0
    # A tol between the two residuals: the round rule would differ
    tol = (float(res) + float(moved[3])) / 2
    assert tail_residual_excess(moved, ref, tol)["side"] == 1


def test_the_scratch_covers_the_kernels_layout():
    """Three padded matrices, two sets of partial row sums, two vectors:
    ``csrc/steady_tail.cu``'s layout (S padded to NP, a multiple of 64;
    NB = NP / 32 tiles a side)."""
    assert st._scratch_floats(252) == 3 * 256 * 256 + 2 * 8 * 256 + 2 * 256
    assert st._scratch_floats(256) == st._scratch_floats(252)
    assert st._scratch_floats(257) == 3 * 320 ** 2 + 2 * 10 * 320 + 2 * 320


class _Event:
    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.25


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("name", ["tail_fused", "tail_f64"])
def test_the_traced_graph_counts_its_routes_replays(name, on):
    """A traced graph whose capture counted ``name`` (the tail's kernel or
    its float64 route) adds it once a replay, the other route's count
    none, beside the tail's interval and its round counter."""
    entry = _graph._Capture(-1, traced=True)  # -1: no device
    entry.marks, entry.end = [("tail", _Event())], _Event()
    entry.counts = dict(tail_fused=0, tail_f64=0)
    entry.counts[name] = int(on)
    entry.counter = torch.ones((), dtype=torch.int32)
    entry.counter_name = "tail_rounds"
    col = tracing.Collector()
    for _ in range(3):
        col.using(entry)
    col.close()
    other = "tail_f64" if name == "tail_fused" else "tail_fused"
    assert col.counts == {name: 3 * on, other: 0, "tail_rounds": 0}
    assert col.device_ms == {"tail": [0.25] * 3}


@pytest.mark.parametrize("dtype,S", [(torch.float64, 642), (torch.float32, 642),
                                     (torch.float64, 12), (torch.float32, 13)])
def test_squared_rows_start_on_row_align_bytes(dtype, S):
    """The tail's transition matrix and its squares keep their rows on
    ``step.ROW_ALIGN`` bytes (cuBLAS's faster product), with the values of
    a plain product renormalised."""
    fm = torch.tensor(np.random.default_rng(3).random((S, S)), dtype=dtype)
    T = tstep._aligned(fm)
    sq = tstep._square(T)
    for x in (T, sq):
        assert x.shape == (S, S) and x.stride(1) == 1
        assert x.stride(0) * x.element_size() % tstep.ROW_ALIGN == 0
        assert 0 <= x.stride(0) - S < tstep.ROW_ALIGN // x.element_size()
    assert torch.equal(T, fm)
    plain = fm @ fm
    torch.testing.assert_close(sq, plain / plain.sum(1, keepdim=True),
                               rtol=4 * S * torch.finfo(dtype).eps, atol=0)


def test_the_kernel_source_carries_its_note():
    src = (Path(st.__file__).resolve().parents[1] / "csrc"
           / "steady_tail.cu").read_text()
    head = src.split("#include")[0]
    assert "replaces no Pallas call" in head
    assert "What bounds it on an H100" in head
    assert "Design:" in head
    assert "ops/steady_tail.py::steady_tail" in head
    assert "fmaf" in head and "TF32" in head
