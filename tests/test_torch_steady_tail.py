"""The tail kernel's route, plain version and wiring on the CPU
(``ops/steady_tail.py``, ``csrc/steady_tail.cu``). The kernel itself runs
only on the card: ``tests/test_torch_steady_tail_cuda.py``.

* the route: CUDA, f32 and at most ``S_MAX`` states take the kernel, and
  nothing else does; the eager and the graphed tail ask the same rule;
* the plain version is the PyTorch tail with guarded rounds, bitwise the
  early-exit loop, which counts the rounds;
* the bounds the card tests hold the kernel to pass between two summation
  orders of the plain tail, and fail a residual moved or decided wrongly;
* the tail's launches are counted with the other kernels';
* the traced graph counts the replays whose tail took the kernel;
* the kernel source carries its note.
"""
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

from test_torch_device_loops import CASES

torch.set_num_threads(1)


def _masks(S):
    ids = torch.arange(S)
    return ids == S - 2, ids == S - 1


# (device, dtype, S, takes the kernel)
ROUTES = {
    "cpu_f32": ("cpu", torch.float32, 252, False),
    "cpu_f32_entry": ("cpu", torch.float32, 18, False),
    "cuda_f32_entry": ("cuda", torch.float32, 18, True),
    "cuda_f32_bins10": ("cuda", torch.float32, 252, True),
    "cuda_f32_s_max": ("cuda", torch.float32, st.S_MAX, True),
    "cuda_f32_above": ("cuda", torch.float32, st.S_MAX + 1, False),
    "cuda_f32_bins128": ("cuda", torch.float32, 3202, False),
    "cuda_f64": ("cuda", torch.float64, 252, False),
    "cuda_f16": ("cuda", torch.float16, 252, False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_the_route_rule(name):
    device, dtype, S, kernel = ROUTES[name]
    assert st.uses_kernel(torch.device(device), dtype, S) is kernel
    assert st.uses_kernel(device, dtype, S) is kernel


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
                                     max_extra_squarings, tstep._where_rounds),
                torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("form", ["eager", "graphed"])
@pytest.mark.parametrize("kernel", [True, False])
def test_the_tail_asks_the_route(form, kernel, monkeypatch):
    """Both forms of the tail launch the kernel exactly where the route
    says so, with the caller's settings and, outside a capture, no
    counter; elsewhere the PyTorch tail runs unchanged."""
    fake = _FakeKernel()
    asked = []

    def rule(device, dtype, S):
        asked.append((torch.device(device).type, dtype, S))
        return kernel

    monkeypatch.setattr(st, "uses_kernel", rule)
    monkeypatch.setattr(st, "steady_tail", fake)
    fm = torch.tensor(CASES["round_5"][0]())
    basis, target = _masks(fm.shape[0])
    fn = (tstep.steady_state_from_flux if form == "eager"
          else _graph.steady_state_conditional)
    if form == "graphed" and not kernel:
        with pytest.raises(RuntimeError, match="needs a capture"):
            fn(fm, basis, target, tol=1e-5)
        return
    got = fn(fm, basis, target, n_iters=256, tol=1e-5)
    assert asked == [("cpu", torch.float32, 12)]
    ref = tstep._steady_state(fm, basis, target, 256, 1e-5, 16,
                              tstep._where_rounds)
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert fake.calls == ([dict(n_iters=256, tol=1e-5, max_extra=16,
                                counter=None)] if kernel else [])


@pytest.mark.parametrize("tol", [1e-6, 0.0])
@pytest.mark.parametrize("name", list(CASES))
def test_the_plain_version_is_the_pytorch_tail_with_its_rounds(name, tol):
    """The kernel's plain version, the PyTorch tail with guarded rounds, is
    bitwise the early-exit loop (which counts the rounds) and the CPU
    route."""
    fm = torch.tensor(CASES[name][0]())
    basis, target = _masks(fm.shape[0])
    got = tstep._steady_state(fm, basis, target, 512, tol, 16,
                              tstep._where_rounds)
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


@pytest.mark.parametrize("fused", [True, False])
def test_the_traced_graph_counts_fused_replays(fused):
    entry = _graph._Captured(None, -1, [], None, [],  # -1: no device
                             marks=[_Event(), _Event(), _Event()],
                             rounds=torch.zeros((), dtype=torch.int32),
                             fused=fused)
    col = tracing.Collector()
    for _ in range(3):
        col.using(entry)
    col.close()
    assert col.counts["tail_fused"] == (3 if fused else 0)
    assert col.device_ms["tail"] == [0.25] * 3


def test_the_kernel_source_carries_its_note():
    src = (Path(st.__file__).resolve().parents[1] / "csrc"
           / "steady_tail.cu").read_text()
    head = src.split("#include")[0]
    assert "replaces no Pallas call" in head
    assert "What bounds it on an H100" in head
    assert "Design:" in head
    assert "ops/steady_tail.py::steady_tail" in head
    assert "fmaf" in head and "TF32" in head
