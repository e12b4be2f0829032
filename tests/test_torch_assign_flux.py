"""H3 (``assign_flux``) as a bin-grouped kernel that keeps its flux epilogue.

On CUDA the plan kernels give each row its bin's group (``_plan_keys``);
each block then owns the parent and child rows of ``SEGMENTS_PER_BLOCK``
segments, sorts them by group, and a warp scores up to ``TASK_ROWS`` rows
of one group against that group's centers only, before one thread a
segment applies the overrides and adds the segment's weight to the flux.
The CPU tests hold ``_plan_keys`` to its plain version, and a
block-by-block emulation of the kernel built on ``_plan_keys_plain`` to
``assign_flux_plain``; the JAX Pallas kernel ``_fused_call`` (interpret
mode) is the reference at 128 bins. Ids must agree except at near-ties
(f32 rounding of the f64 minimum); with dyadic weights the flux must be
bitwise equal.

The ``cuda`` test compares the kernel with the plain version and, bitwise,
with H4's raw ids; on the card run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_assign_flux.py
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.step import _scatter_flux

from _torch_parity import assert_ids_match, np_, to_torch
from test_torch_pair_assign import CASES, _bank_case

torch.set_num_threads(1)


def _h3_problem(case, seed=0, d=6, N=700, w_dtype=np.float64, with_target_p=True):
    """A bank case of ``test_torch_pair_assign`` with dyadic weights and
    override masks: the arguments of ``assign_flux`` as numpy arrays."""
    p = _bank_case(case, seed=seed, d=d, N=N)
    rng = np.random.default_rng(seed + 100)
    p["w"] = (rng.integers(1, 17, N) / 16.0).astype(w_dtype)
    for m, rate in (("basis_p", 0.1), ("basis_c", 0.05), ("target_c", 0.05)):
        p[m] = rng.random(N) < rate
    p["target_p"] = (rng.random(N) < 0.05) if with_target_p else None
    p["n_states"] = len(p["centers"]) + 2
    return p


def _args(t):
    """Positional arguments of ``assign_flux`` and its keyword."""
    return ((t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
             t["basis_c"], t["target_c"], t["centers"], t["center_bin"],
             t["valid"], t["n_states"]), dict(target_p=t["target_p"]))


def _emulate(fp, fc, pbins, cbins, w, basis_p, basis_c, target_c, centers,
             center_bin, valid, n_states, target_p=None,
             segs=sa.SEGMENTS_PER_BLOCK, task_rows=sa.TASK_ROWS):
    """The kernel's work block by block from the plan, in plain torch: a
    block's parent and child rows sorted by (group, row), each run of one
    group cut into tasks of ``task_rows`` rows and scored against its
    group's centers (first minimum of ``|c|^2 - 2 x.c``; group K: id 0),
    then the flux-order overrides and the flux of the segments' weights."""
    cperm, ckey, rkey = sa._plan_keys_plain(pbins, cbins, center_bin, valid)
    N, K = len(fc), len(centers)
    X = torch.cat([fp, fc])
    c2 = (centers * centers).sum(1)
    ids = torch.full((2 * N,), -1, dtype=torch.int32)
    for seg0 in range(0, N, segs):
        seg = torch.arange(seg0, min(seg0 + segs, N))
        rows = torch.cat([seg, N + seg])  # plan rows: parents, then children
        local = torch.cat([seg - seg0, segs + seg - seg0])
        _keys, order = torch.sort(rkey[rows].long() * 2**16 + local)
        rows = rows[order]
        groups = rkey[rows].long()
        for g, n_run in zip(*torch.unique_consecutive(groups, return_counts=True)):
            first = int(torch.searchsorted(groups, g))
            run = rows[first:first + int(n_run)]
            if g == K:
                ids[run] = 0
                continue
            nc = int((ckey == ckey[g]).sum())
            cids = cperm[int(g):int(g) + nc].long()
            for t0 in range(0, len(run), task_rows):
                task = run[t0:t0 + task_rows]
                scores = c2[cids][None, :] - 2.0 * (X[task] @ centers[cids].T)
                ids[task] = cids[torch.argmin(scores, dim=1)].to(torch.int32)
    assert (ids >= 0).all()
    pidx, cidx = ids[:N], ids[N:]
    B, T = n_states - 2, n_states - 1
    cidx = torch.where(target_c, T, cidx)
    if target_p is not None:
        pidx = torch.where(target_p, T, pidx)
    pidx = torch.where(basis_p, B, pidx).to(torch.int32)
    cidx = torch.where(basis_c, B, cidx).to(torch.int32)
    live = w != 0
    return pidx, cidx, _scatter_flux(pidx[live], cidx[live], w[live], n_states)


def _assert_matches(got, ref, p):
    """Ids up to near-ties (override states exactly); when every id agrees
    the dyadic flux is bitwise equal, and always that of the ids given."""
    K = len(p["centers"])
    bank = (p["centers"], p["center_bin"], p["valid"])
    n = assert_ids_match(got[0], ref[0], p["fp"], p["pbins"], *bank, n_regular=K)
    n += assert_ids_match(got[1], ref[1], p["fc"], p["cbins"], *bank, n_regular=K)
    assert got[2].dtype == ref[2].dtype and got[2].shape == (K + 2, K + 2)
    w = torch.as_tensor(p["w"], device=got[2].device)
    assert torch.equal(got[2], _scatter_flux(got[0], got[1], w, K + 2))
    if n == 0:
        assert torch.equal(got[2].cpu(), ref[2].cpu())


@pytest.mark.parametrize("case", CASES)
def test_plan_keys_on_cpu_is_the_plain_plan(case):
    p = _bank_case(case)
    args = [torch.as_tensor(p[k]) for k in ("pbins", "cbins", "center_bin", "valid")]
    cperm, ckey, rkey = sa._plan_keys(*args)
    for a, b in zip((cperm, ckey, rkey), sa._plan_keys_plain(*args)):
        assert torch.equal(a, b)
    assert cperm.dtype == rkey.dtype == torch.int32 and ckey.dtype == torch.int64
    # H4's plan sorts the centers the same way
    assert torch.equal(sa._bin_tiles_plain(*args)[1], cperm)
    # A row's group holds exactly its bin's valid centers; group K none
    bins = np.concatenate([p["pbins"], p["cbins"]])
    K = len(p["center_bin"])
    ck, cp = np_(ckey), np_(cperm)
    for b, g in zip(bins, np_(rkey)):
        mine = np.flatnonzero(p["valid"] & (p["center_bin"] == b))
        if g == K:
            assert len(mine) == 0
            continue
        n = int((ck == ck[g]).sum())
        np.testing.assert_array_equal(cp[g:g + n], mine)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("N,segs", [(700, 64), (50, sa.SEGMENTS_PER_BLOCK)],
                         ids=["ragged_blocks", "fewer_rows_than_a_block"])
@pytest.mark.parametrize("w_dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("with_target_p", [True, False], ids=["target_p", "no_target_p"])
def test_block_emulation_matches_plain(case, N, segs, w_dtype, with_target_p):
    p = _h3_problem(case, seed=N, N=N, w_dtype=w_dtype, with_target_p=with_target_p)
    t = to_torch(p)
    args, kw = _args(t)
    got = _emulate(*args, **kw, segs=segs)
    ref = sa.assign_flux_plain(*args, **kw)
    _assert_matches(got, ref, p)
    # On CPU tensors the wrapper is the plain version
    for a, b in zip(sa.assign_flux(*args, **kw), ref):
        assert torch.equal(a, b)


def test_128_bins_match_pallas_h3():
    """At 128 bins the emulation and ``assign_flux`` on the CPU match
    ``_fused_call`` (through ``fused_assign_flux``) in interpret mode,
    which scores the full distance and has no parent target override."""
    from msm_we_tpu.ops import pallas_kernels as pk

    p = _h3_problem("bins128", seed=3, d=5, N=300, w_dtype=np.float32,
                    with_target_p=False)
    pidx, cidx, fm = pk.fused_assign_flux(
        p["fp"], p["fc"], p["pbins"], p["cbins"], p["w"], p["basis_p"],
        p["basis_c"], p["target_c"], p["centers"], p["center_bin"],
        p["valid"], p["n_states"], tile=128,
    )
    t = to_torch(p)
    args, kw = _args(t)
    ref = tuple(torch.tensor(np.array(a)) for a in (pidx, cidx, fm))
    for got in (_emulate(*args, **kw, segs=64), sa.assign_flux(*args, **kw)):
        _assert_matches(got, ref, p)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edge_problem(edge, F):
    if edge == "one_segment":
        return _h3_problem("holey", seed=F, d=F, N=1)
    if edge == "bank_not_a_multiple_of_32":
        p = _h3_problem("one_bin", seed=F, d=F, N=3000)
        keep = np.arange(37)
        p.update(centers=p["centers"][keep], center_bin=p["center_bin"][keep],
                 valid=p["valid"][keep], n_states=39)
        return p
    if edge == "every_row_in_bin_minus_one":
        p = _h3_problem("holey", seed=F, d=F, N=3000)
        p["pbins"][:] = -1
        p["cbins"][:] = -1
        return p
    return _h3_problem(edge, seed=F, d=F, N=5000)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [12, 30, 300])
@pytest.mark.parametrize("edge", CASES + ["one_segment", "bank_not_a_multiple_of_32",
                                          "every_row_in_bin_minus_one"])
def test_cuda_kernel_matches_plain_and_h4(edge, F, cuda_device):
    """The kernel against ``assign_flux_plain`` (ids up to near-ties,
    overrides exactly, dyadic flux bitwise in f64 and f32), its plan
    kernels against the plain plan, and its raw ids bitwise H4's."""
    p = _edge_problem(edge, F)
    t = to_torch(p, cuda_device)
    args, kw = _args(t)
    plan_args = (t["pbins"], t["cbins"], t["center_bin"], t["valid"])
    plain_args = [a.cpu() for a in plan_args]
    for a, b in zip(sa._plan_keys(*plan_args), sa._plan_keys_plain(*plain_args)):
        assert torch.equal(a.cpu(), b)
    sa.reset_launch_counts()
    got = sa.assign_flux(*args, **kw)
    ref = sa.assign_flux_plain(*args, **kw)
    torch.cuda.synchronize()
    assert sa.launch_counts()["assign_flux"] == 1
    _assert_matches(got, ref, p)
    again = sa.assign_flux(*args, **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    # f32 weights: the same ids, the flux in f32
    w32 = t["w"].float()
    got32 = sa.assign_flux(*args[:4], w32, *args[5:], **kw)
    assert got32[2].dtype == torch.float32
    assert torch.equal(got32[0], got[0]) and torch.equal(got32[1], got[1])
    assert torch.equal(got32[2], _scatter_flux(got[0], got[1], w32, p["n_states"]))
    # Without overrides the ids are H4's raw ids, bitwise
    N = len(p["fc"])
    off = torch.zeros(N, dtype=torch.bool, device=cuda_device)
    hp, hc, _fm = sa.assign_flux(*args[:5], off, off, off, *args[8:])
    pp, pc = sa.pair_assign(t["fp"], t["fc"], t["pbins"], t["cbins"],
                            t["centers"], t["center_bin"], t["valid"])
    assert torch.equal(hp, pp) and torch.equal(hc, pc)
