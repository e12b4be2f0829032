"""The float64 tail's row kernels (``ops/tail_rows.py``,
``csrc/tail_rows.cu``) on the CPU: their route, wrappers and wiring. The
kernels themselves run only on the card: ``tests/test_torch_tail_rows_cuda.py``.

* the rule: a PyTorch tail in float64 on CUDA takes the row kernels, and
  nothing else does; a CPU input, or an f32 one of at most ``S_MAX``
  states, never reaches ``ops/tail_rows``, and a CUDA float64-route input
  does (the device test emulated on CPU tensors), eagerly and inside a
  capture, which counts the route;
* the tail on that route is the plain tail with the kernels' arithmetic in
  their place: the transition pass once, a renormalisation after every
  squaring, the target flux as ``p . mass``;
* ``p . mass`` equals ``step._target_flux`` within the float64 tail's
  bound (``testing.tail_order_excess`` in float64), which two summation
  orders of the plain float64 tail keep and a moved ``p`` breaks;
* the wrappers refuse CPU tensors and rows off ``ROW_ALIGN`` bytes, and
  their launches are counted with the other kernels';
* the traced graph counts the replays whose tail took the row kernels;
* the kernel source carries its note, and the module imports no other
  kernel module.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph, tracing
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.ops import steady_tail as st
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.ops import tail_rows as tr
from msm_we_tpu_torch.testing import make_problem, tail_order_excess

from test_torch_device_loops import CASES, WIDE_CASES
from test_torch_layers import PKG, _imports
from test_torch_steady_tail import _Event, _masks, _relabel, _within

torch.set_num_threads(1)

F32, F64, F16 = torch.float32, torch.float64, torch.float16

# (device, dtype of the PyTorch tail, takes the row kernels)
RULES = {
    "cuda_f64": ("cuda", F64, True),
    "cpu_f64": ("cpu", F64, False),
    "cuda_f32": ("cuda", F32, False),
    "cuda_f16": ("cuda", F16, False),
    "cpu_f32": ("cpu", F32, False),
}


@pytest.mark.parametrize("name", list(RULES))
def test_the_row_rule(name):
    device, dtype, rows = RULES[name]
    assert tr.uses_kernels(device, dtype) is rows
    assert tr.uses_kernels(torch.device(device), dtype) is rows


class _FakeRows:
    """Stands in for the row kernels on CPU tensors: records the calls and
    computes what the kernels compute, by the plain versions' arithmetic."""

    def __init__(self):
        self.transitions = 0
        self.renorms = 0

    def transition(self, fm, basis, target):
        self.transitions += 1
        T = tstep._aligned(tstep._transition_matrix(fm.double(), basis, target))
        mass = torch.where(target[None, :], T, torch.zeros_like(T)).sum(1)
        return T, T.to(fm.dtype), mass

    def renormalize(self, a):
        self.renorms += 1
        return tstep._renormalize(a)


def _as_if_on_cuda(monkeypatch):
    """The row rule as a CUDA device answers it, for CPU tensors; the row
    kernels replaced by :class:`_FakeRows`, returned."""
    real = tr.uses_kernels
    fake = _FakeRows()
    monkeypatch.setattr(tr, "uses_kernels",
                        lambda device, dtype: real("cuda", dtype))
    monkeypatch.setattr(tr, "transition", fake.transition)
    monkeypatch.setattr(tr, "renormalize", fake.renormalize)
    return fake


# name -> (flux matrix, its dtype, whether a CUDA tail takes the row kernels)
INPUTS = {
    "f32_small": (lambda: CASES["round_5"][0](), F32, False),
    "f32_above": (lambda: WIDE_CASES["wide_round_5"][0](), F32, True),
    "f64_small": (lambda: CASES["round_5"][0](), F64, True),
}


@pytest.mark.parametrize("form", ["eager", "graphed"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_the_tail_reaches_the_row_kernels_where_the_rule_says(name, form,
                                                              monkeypatch):
    """With the device test answering as a card would, the tail launches the
    transition pass once and a renormalisation after each of its 9 fixed
    squarings and 16 rounds (guarded rounds eagerly, conditional bodies in
    a capture) exactly where its tail runs in float64, and returns the
    plain tail's ``T``, ``p`` and residual bitwise, its flux within the
    float64 tail's bound; an f32 tail of at most ``S_MAX`` states never
    reaches them. A capture counts the route."""
    make, dtype, rows = INPUTS[name]
    monkeypatch.setattr(st, "uses_kernel", lambda device, dtype, S: False)
    fake = _as_if_on_cuda(monkeypatch)
    fm = torch.tensor(make(), dtype=dtype)
    basis, target = _masks(fm.shape[0])
    with _within(form, monkeypatch) as cap:
        got = tstep.steady_state_from_flux(fm, basis, target)
    assert (fake.transitions, fake.renorms) == ((1, 25) if rows else (0, 0))
    if cap is not None:
        assert cap.counts["tail_rows"] == int(rows)
    ref = tstep._steady_state(fm, basis, target, 512, 1e-6, 16,
                              tstep._where_rounds,
                              st.tail_dtype(fm.dtype, fm.shape[0]))
    for i in (0, 1, 3):
        assert got[i].dtype == dtype and torch.equal(got[i], ref[i])
    if rows:
        excess = tail_order_excess(got, ref, dtype)
        assert excess["flux"] <= 0, excess
    else:
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("name", list(INPUTS))
def test_cpu_inputs_never_reach_the_row_kernels(name, monkeypatch):
    """On the CPU every tail keeps the plain versions: the row kernels'
    wrappers are never called, and a capture counts no row route."""
    def never(*args):
        raise AssertionError("a CPU tail reached ops/tail_rows")

    monkeypatch.setattr(tr, "transition", never)
    monkeypatch.setattr(tr, "renormalize", never)
    make, dtype, _rows = INPUTS[name]
    fm = torch.tensor(make(), dtype=dtype)
    basis, target = _masks(fm.shape[0])
    with _within("graphed", monkeypatch) as cap:
        tstep.steady_state_from_flux(fm, basis, target)
    assert cap.counts["tail_rows"] == 0
    tstep.steady_state_from_flux(fm, basis, target)


def test_p_dot_target_mass_is_the_target_flux():
    """``make_problem(n_bins=128)`` cut to 5 centers a bin (642 states): the
    plain float64 tail's target flux and ``p . mass``, each row's mass the
    sum over the target columns of ``T``, agree within the float64 tail's
    bound, and the bound is tighter than 1e-12 relatively."""
    from msm_we_tpu_torch.entry import hot_step

    p = make_problem(n_segments=4096, n_raw_features=64, n_components=8,
                     n_bins=128, k_per_bin=5, seed=0)
    fm = hot_step(p, "two_transform", "cpu")["fm"].double()
    basis, target = _masks(fm.shape[0])
    T, pss, flux, res = tstep._steady_state(fm, basis, target, 512, 1e-6, 16,
                                            tstep._where_rounds, F64)
    mass = torch.where(target[None, :], T, torch.zeros_like(T)).sum(1)
    excess = tail_order_excess((T, pss, pss @ mass, res), (T, pss, flux, res),
                               F64)
    assert all(v <= 0 for v in excess.values()), excess
    assert abs(float(pss @ mass - flux)) <= 1e-12 * abs(float(flux))


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_the_f64_bound_holds_between_two_summation_orders(name):
    """``testing.tail_order_excess`` in float64: the plain float64 tail of a
    chain above ``S_MAX`` and of the same chain with its other states
    renumbered (every sum, the products' too, in another order) lie within
    the bound, at 0 and at 16 rounds; ``p`` moved by one part in 1e11 does
    not."""
    fm = torch.tensor(WIDE_CASES[name][0]()).double()
    S = fm.shape[0]
    basis, target = _masks(S)
    rng = np.random.default_rng(5)
    perm = torch.tensor(np.concatenate([rng.permutation(S - 2), [S - 2, S - 1]]))
    inv = torch.argsort(perm)
    for tol in (1e-6, 0.0):
        ref = tstep.steady_state_from_flux(fm, basis, target, tol=tol)
        T2, p2, flux2, res2 = tstep.steady_state_from_flux(
            _relabel(fm, perm), basis, target, tol=tol)
        got = (T2[inv][:, inv], p2[inv], flux2, res2)
        excess = tail_order_excess(got, ref, F64)
        assert all(v <= 0 for v in excess.values()), (tol, excess)
    far = (ref[0], ref[1] * (1 + 1e-11), ref[2], ref[3])
    assert tail_order_excess(far, ref, F64)["p"] > 0


def _unaligned(name):
    """A CPU matrix the renormalisation does not take, by ``name``."""
    if name == "f32":
        return tr._aligned_empty(8, F32, "cpu")
    if name == "rows_of_641":
        return torch.zeros((641, 641), dtype=F64)
    if name == "offset":
        return tr._aligned_empty(9, F64, "cpu")[1:, 1:]
    if name == "transposed":
        return tr._aligned_empty(8, F64, "cpu").t()
    return torch.zeros((4, 8), dtype=F64)  # not square


@pytest.mark.parametrize("name", ["f32", "rows_of_641", "offset",
                                  "transposed", "not_square"])
def test_the_wrapper_refuses_rows_off_row_align(name):
    with pytest.raises((TypeError, ValueError)):
        tr._check_rows(_unaligned(name))


@pytest.mark.parametrize("S", [1, 641, 3200, 3202])
def test_the_wrapper_takes_the_tails_aligned_matrices(S):
    """What ``step._square`` and ``step._aligned`` give passes the check."""
    assert tr._check_rows(tr._aligned_empty(S, F64, "cpu")) == S
    fm = torch.ones((S, S), dtype=F64)
    assert tr._check_rows(tstep._aligned(fm)) == S


@pytest.mark.parametrize("call", ["renormalize", "transition"])
def test_the_wrappers_refuse_cpu_tensors(call):
    S = 16
    basis, target = _masks(S)
    before = sa.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if call == "renormalize":
            tr.renormalize(tr._aligned_empty(S, F64, "cpu").zero_())
        else:
            tr.transition(torch.ones((S, S)), basis, target)
    assert sa.launch_counts() == before


@pytest.mark.parametrize("capturing", [False, True])
def test_the_row_kernels_are_counted_with_the_other_kernels(capturing,
                                                            monkeypatch):
    """One reset and one read cover the row kernels: a launch counts outside
    a capture and not inside one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    assert sa.KERNELS["tail_renorm"] is tr.renormalize
    assert sa.KERNELS["tail_transition"] is tr.transition
    assert sa.KERNEL_SYMBOLS["tail_renorm"] == "tail_renorm_kernel"
    assert sa.KERNEL_SYMBOLS["tail_transition"] == "tail_transition_kernel"
    sa.reset_launch_counts()
    sa._count_launch(tr.renormalize)
    sa._count_launch(tr.transition)
    n = int(not capturing)
    assert sa.launch_counts() == dict(dict.fromkeys(sa.KERNELS, 0),
                                      tail_renorm=n, tail_transition=n)
    sa.reset_launch_counts()


@pytest.mark.parametrize("on", [True, False])
def test_the_traced_graph_counts_the_row_route(on):
    """A traced graph whose capture counted ``tail_rows`` adds it once a
    replay, beside ``tail_f64`` and the tail's interval."""
    entry = _graph._Capture(-1, traced=True)  # -1: no device
    entry.marks, entry.end = [("tail", _Event())], _Event()
    entry.counts = dict(tail_fused=0, tail_f64=int(on), tail_rows=int(on))
    entry.counter = torch.ones((), dtype=torch.int32)
    entry.counter_name = "tail_rounds"
    col = tracing.Collector()
    for _ in range(3):
        col.using(entry)
    col.close()
    assert col.counts == dict(tail_fused=0, tail_f64=3 * on, tail_rows=3 * on,
                              tail_rounds=0)
    assert col.device_ms == {"tail": [0.25] * 3}


def test_the_row_kernels_module_imports_no_other_kernel_module():
    got = _imports(PKG / "ops" / "tail_rows.py")
    assert {m.split(".")[1] for m in got if m.startswith("ops.")} <= {"_ext"}
    assert "ops.tail_rows" in _imports(PKG / "step.py")


def test_the_row_kernels_source_carries_its_note():
    src = (Path(tr.__file__).resolve().parents[1] / "csrc"
           / "tail_rows.cu").read_text()
    head = src.split("#include")[0]
    assert "replaces no Pallas call" in head
    assert "What bounds it on an H100" in head
    assert "Design:" in head
    assert "ops/tail_rows.py::renormalize" in head
    assert "tail_renorm_kernel" in head and "tail_transition_kernel" in head
