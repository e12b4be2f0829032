"""The port's stratified assignment kernels (``msm_we_tpu_torch.ops.
stratified_assign``) against the Pallas kernels they replace and the JAX
production step.

On the CPU each wrapper runs its plain PyTorch version; the Pallas kernels
run in interpret mode, as ``tests/test_pallas_kernel.py`` runs them. Ids
must agree except at near-ties (f32 rounding of the f64 minimum); flux
with dyadic weights must be bitwise equal. The one test that needs a GPU
compares each CUDA kernel with its plain version; the JAX package is
imported inside the tests that use it, so that test also runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.step import _raw_pair_assign
from msm_we_tpu_torch.testing import pad_stratified_problem, tiny_stratified_problem

from _torch_parity import assert_ids_match, np_, to_torch, tt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and production step."""
    from msm_we_tpu.ops import pallas_kernels
    from msm_we_tpu.ops.kmeans import masked_assign
    from msm_we_tpu.parallel import sharded

    return types.SimpleNamespace(pk=pallas_kernels, jsh=sharded,
                                 masked_assign=masked_assign)


def _problem(seed=3, N=500, d=11, n_bins=5, k=3, dyadic=True):
    """The fixture of tests/test_pallas_kernel.py: a holey compact bank
    (valid-first, global-id order), with dyadic weights."""
    rng = np.random.default_rng(seed)
    K = n_bins * k
    holey = rng.random(K) < 0.85
    centers_all = rng.normal(size=(K, d)).astype(np.float32)
    center_bin_all = np.repeat(np.arange(n_bins, dtype=np.int32), k)
    rows = np.flatnonzero(holey)
    K = len(rows)
    p = dict(
        fp=rng.normal(size=(N, d)).astype(np.float32),
        fc=rng.normal(size=(N, d)).astype(np.float32),
        pbins=rng.integers(0, n_bins, N).astype(np.int32),
        cbins=rng.integers(0, n_bins, N).astype(np.int32),
        w=rng.random(N).astype(np.float32),
        basis_p=(rng.random(N) < 0.1),
        basis_c=(rng.random(N) < 0.05),
        target_c=(rng.random(N) < 0.05),
        centers=centers_all[rows],
        center_bin=center_bin_all[rows],
        valid=np.ones(K, bool),
        n_states=K + 2,
    )
    if dyadic:
        p["w"] = (rng.integers(1, 17, N) / 16.0).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _raw(p, D, seed):
    rng = np.random.default_rng(seed)
    N, d = p["fp"].shape
    return dict(
        proj=(rng.normal(size=(D, d)) * 0.3).astype(np.float32),
        mean=rng.normal(size=D).astype(np.float32),
        raw_p=rng.normal(size=(N, D)).astype(np.float32),
        raw_c=rng.normal(size=(N, D)).astype(np.float32),
    )


def _bank(t):
    return t["centers"], t["center_bin"], t["valid"]


# --------------------------------------------------------------- Pallas


def test_pair_assign_matches_pallas_h4(problem, jx):
    p, pk = problem, jx.pk
    tile = 128
    N, d = p["fp"].shape
    K = len(p["centers"])
    Np, dp, Kp = pk._round_up(N, tile), pk._round_up(d, 128), pk._round_up(K, 128)
    pidx, cidx = pk._assign_call(
        pk._pad2(p["fp"], Np, dp), pk._pad2(p["fc"], Np, dp),
        pk._col(p["pbins"], Np, -1), pk._col(p["cbins"], Np, -1),
        pk._pad2(p["centers"], Kp, dp).T.copy(), pk._col(p["center_bin"], Kp, -2),
        pk._col(p["valid"].astype(np.int32), Kp), tile=tile, interpret=True,
    )
    t = to_torch(p)
    ppi, pci = _raw_pair_assign(t["fp"], t["fc"], t["pbins"], t["cbins"], *_bank(t))
    assert ppi.dtype == torch.int32 and pci.shape == (N,)
    assert_ids_match(ppi, np.asarray(pidx)[:N], p["fp"], p["pbins"], *_bank(p))
    assert_ids_match(pci, np.asarray(cidx)[:N], p["fc"], p["cbins"], *_bank(p))


def test_assign_flux_matches_pallas_h3(problem, jx):
    p, pk = problem, jx.pk
    pidx, cidx, fm = pk.fused_assign_flux(
        p["fp"], p["fc"], p["pbins"], p["cbins"], p["w"],
        p["basis_p"], p["basis_c"], p["target_c"],
        p["centers"], p["center_bin"], p["valid"], p["n_states"], tile=128,
    )
    t = to_torch(p)
    ppi, pci, pfm = sa.assign_flux(
        t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
        t["basis_c"], t["target_c"], *_bank(t), p["n_states"],
    )
    K = len(p["centers"])
    n1 = assert_ids_match(ppi, pidx, p["fp"], p["pbins"], *_bank(p), n_regular=K)
    n2 = assert_ids_match(pci, cidx, p["fc"], p["cbins"], *_bank(p), n_regular=K)
    assert pfm.dtype == torch.float32 and pfm.shape == (K + 2, K + 2)
    if n1 + n2 == 0:
        # Dyadic weights: exact cell sums in any order
        np.testing.assert_array_equal(np_(pfm), np.asarray(fm))


def test_transform_assign_matches_pallas_h2(problem, jx):
    p, pk = problem, jx.pk
    r = _raw(p, 37, seed=11)
    t, rt = to_torch(p), to_torch(r)
    K = len(p["centers"])
    for with_flux in (True, False):
        pidx, cidx, fm = pk.fused_transform_assign(
            r["raw_p"], r["raw_c"], p["pbins"], p["cbins"], p["w"],
            p["basis_p"], p["basis_c"], p["target_c"], r["mean"], r["proj"],
            p["centers"], p["center_bin"], p["valid"], p["n_states"],
            tile=128, with_flux=with_flux, interpret=True,
        )
        ppi, pci, pfm = sa.transform_assign(
            rt["raw_p"], rt["raw_c"], t["pbins"], t["cbins"], t["w"],
            t["basis_p"], t["basis_c"], t["target_c"], rt["mean"], rt["proj"],
            *_bank(t), p["n_states"], with_flux=with_flux,
        )
        c2a = np_(sa.c2adj(rt["mean"], rt["proj"], t["centers"]))
        n1 = assert_ids_match(ppi, pidx, None, p["pbins"], *_bank(p), n_regular=K,
                              c2=c2a, raw=r["raw_p"], proj=r["proj"])
        n2 = assert_ids_match(pci, cidx, None, p["cbins"], *_bank(p), n_regular=K,
                              c2=c2a, raw=r["raw_c"], proj=r["proj"])
        if with_flux:
            if n1 + n2 == 0:
                np.testing.assert_array_equal(np_(pfm), np.asarray(fm))
        else:
            assert pfm is None


@pytest.mark.parametrize("emit", [False, True])
def test_transform_assign_child_matches_pallas_h1(problem, emit, jx):
    p, pk = problem, jx.pk
    r = _raw(p, 41, seed=13)
    t, rt = to_torch(p), to_torch(r)
    cidx, feats = pk.fused_transform_assign_child(
        r["raw_c"], p["cbins"], p["basis_c"], p["target_c"], r["mean"],
        r["proj"], p["centers"], p["center_bin"], p["valid"], p["n_states"],
        tile=128, interpret=True, emit_features=emit,
    )
    idx, g = sa.transform_assign_child(
        rt["raw_c"], t["cbins"], t["basis_c"], t["target_c"], rt["mean"],
        rt["proj"], *_bank(t), p["n_states"], emit_features=emit,
    )
    c2a = np_(sa.c2adj(rt["mean"], rt["proj"], t["centers"]))
    assert_ids_match(idx, cidx, None, p["cbins"], *_bank(p),
                     n_regular=len(p["centers"]), c2=c2a, raw=r["raw_c"],
                     proj=r["proj"])
    if emit:
        # Both emit raw @ proj (centering folded into the bank)
        np.testing.assert_allclose(np_(g), feats, rtol=1e-5, atol=1e-5)
    else:
        assert g is None and feats is None


# ------------------------------------------------- production semantics


def _overlap_problem():
    """Rows inside both basis and target regions, and parents in the
    target: the cases where override order and target_p matter."""
    p = _problem(seed=7)
    rng = np.random.default_rng(8)
    N = len(p["w"])
    p["target_p"] = rng.random(N) < 0.1
    both = rng.random(N) < 0.05
    for k in ("basis_p", "basis_c", "target_c", "target_p"):
        p[k] = p[k] | both
    return p


def test_assign_flux_applies_target_p_like_production(jx):
    """The Pallas H3 omits the parent target override; the port applies it
    as parallel.sharded._discretize_and_flux does (before basis)."""
    p = _overlap_problem()
    fm, pidx, cidx = jx.jsh._discretize_and_flux(
        p["fp"], p["fc"], p["pbins"], p["cbins"], p["basis_p"], p["basis_c"],
        p["target_c"], p["w"], p["centers"], p["center_bin"], p["valid"],
        p["n_states"], target_p=p["target_p"],
    )
    t = to_torch(p)
    ppi, pci, pfm = sa.assign_flux(
        t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
        t["basis_c"], t["target_c"], *_bank(t), p["n_states"],
        target_p=t["target_p"],
    )
    K = len(p["centers"])
    assert (np_(ppi)[p["target_p"] & ~p["basis_p"]] == K + 1).all()
    n = assert_ids_match(ppi, pidx, p["fp"], p["pbins"], *_bank(p), n_regular=K)
    n += assert_ids_match(pci, cidx, p["fc"], p["cbins"], *_bank(p), n_regular=K)
    if n == 0:
        np.testing.assert_array_equal(np_(pfm), np.asarray(fm))


@pytest.mark.parametrize("order", ["flux", "predict"])
def test_pair_assign_override_orders(order, jx):
    p = _overlap_problem()
    pidx, cidx = jx.jsh._assign_overridden(
        p["fp"], p["fc"], p["pbins"], p["cbins"], p["basis_p"], p["basis_c"],
        p["target_c"], p["centers"], p["center_bin"], p["valid"],
        p["n_states"], target_p=p["target_p"],
        predict_order=order == "predict",
    )
    t = to_torch(p)
    ppi, pci = sa.pair_assign(
        t["fp"], t["fc"], t["pbins"], t["cbins"], *_bank(t),
        n_states=p["n_states"], basis_p=t["basis_p"], basis_c=t["basis_c"],
        target_p=t["target_p"], target_c=t["target_c"], order=order,
    )
    K = len(p["centers"])
    both_c = p["basis_c"] & p["target_c"]
    assert both_c.any()
    expect = K + 1 if order == "predict" else K
    assert (np_(pci)[both_c] == expect).all()
    assert_ids_match(ppi, pidx, p["fp"], p["pbins"], *_bank(p), n_regular=K)
    assert_ids_match(pci, cidx, p["fc"], p["cbins"], *_bank(p), n_regular=K)


def test_single_set_predict_order_matches_sharded_single_assign(jx):
    """One row set with predict-order overrides: the dedup discretization
    fast path (build_sharded_single_assign)."""
    import jax

    from msm_we_tpu.parallel import make_mesh

    p = _overlap_problem()
    fn = jx.jsh.build_sharded_single_assign(make_mesh(jax.devices()[:1]), p["n_states"])
    ref = np.asarray(fn(p["fc"], p["cbins"], p["basis_c"], p["target_c"],
                        p["centers"], p["center_bin"], p["valid"]))
    t = to_torch(p)
    out = sa.pair_assign(None, t["fc"], None, t["cbins"], *_bank(t),
                         n_states=p["n_states"], basis_c=t["basis_c"],
                         target_c=t["target_c"], order="predict")
    assert_ids_match(out, ref, p["fc"], p["cbins"], *_bank(p),
                     n_regular=len(p["centers"]))


def test_rows_with_bin_minus_one_match_nothing_and_carry_no_flux(jx):
    p = _problem(seed=21)
    rng = np.random.default_rng(4)
    dead = rng.random(len(p["w"])) < 0.2
    p["pbins"][dead] = -1
    p["w"][dead] = 0.0
    for k in ("basis_p", "basis_c", "target_c"):
        p[k][dead] = False
    t = to_torch(p)
    ppi, pci, pfm = sa.assign_flux(
        t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
        t["basis_c"], t["target_c"], *_bank(t), p["n_states"],
    )
    fm, pidx, cidx = jx.jsh._discretize_and_flux(
        p["fp"], p["fc"], p["pbins"], p["cbins"], p["basis_p"], p["basis_c"],
        p["target_c"], p["w"], p["centers"], p["center_bin"], p["valid"],
        p["n_states"],
    )
    live = ~dead
    K = len(p["centers"])
    assert_ids_match(np_(ppi)[live], np.asarray(pidx)[live], p["fp"][live],
                     p["pbins"][live], *_bank(p), n_regular=K)
    np.testing.assert_array_equal(np_(pfm), np.asarray(fm))


def test_duplicate_centers_lower_index_wins(jx):
    rng = np.random.default_rng(5)
    d, N = 6, 200
    base = rng.normal(size=(4, d)).astype(np.float32)
    centers = np.concatenate([base, base])  # rows 4..7 duplicate 0..3
    center_bin = np.zeros(8, np.int32)
    X = rng.normal(size=(N, d)).astype(np.float32)
    bins = np.zeros(N, np.int32)
    out = sa.pair_assign(None, tt(X), None, tt(bins), tt(centers),
                         tt(center_bin), tt(np.ones(8, bool)))
    assert (np_(out) < 4).all()
    ref = np.asarray(jx.masked_assign(X, bins, centers, center_bin,
                                       np.ones(8, bool), n_bins=1))
    np.testing.assert_array_equal(np_(out), ref)


def test_many_bins_elementwise_mask_regime(jx):
    """> 64 bins: the JAX package's elementwise-mask regime."""
    p = _problem(seed=9, N=700, d=5, n_bins=70, k=2)
    ref = np.asarray(jx.masked_assign(p["fc"], p["cbins"], p["centers"],
                                       p["center_bin"], p["valid"], n_bins=70))
    t = to_torch(p)
    out = sa.pair_assign(None, t["fc"], None, t["cbins"], *_bank(t))
    assert_ids_match(out, ref, p["fc"], p["cbins"], *_bank(p))


def test_bank_size_not_a_tile_multiple(jx):
    p = _problem(seed=12, N=300, d=7, n_bins=1, k=37)
    assert len(p["centers"]) % 8 != 0
    ref = np.asarray(jx.masked_assign(p["fp"], p["pbins"], p["centers"],
                                       p["center_bin"], p["valid"], n_bins=1))
    t = to_torch(p)
    out = sa.pair_assign(None, t["fp"], None, t["pbins"], *_bank(t))
    assert_ids_match(out, ref, p["fp"], p["pbins"], *_bank(p))


@pytest.mark.parametrize("n_pad,k_pad", [(64, 16), (77, 23), (128, 40)])
def test_padding_is_inert(n_pad, k_pad):
    raw = tiny_stratified_problem(n_rows=64, d=8, n_bins=4, k=4, seed=2)
    padded = pad_stratified_problem(raw, n_pad, k_pad)
    outs = []
    for prob in (raw, padded):
        t = to_torch(prob)
        outs.append(sa.assign_flux(
            t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
            t["basis_c"], t["target_c"], *_bank(t), raw["n_states"],
        ))
    (p0, c0, f0), (p1, c1, f1) = outs
    np.testing.assert_array_equal(np_(p0), np_(p1)[:64])
    np.testing.assert_array_equal(np_(c0), np_(c1)[:64])
    np.testing.assert_array_equal(np_(f0), np_(f1))


# ------------------------------------------------------------ wrappers


def test_kernel_checks_refuse_wrong_dtype_layout_and_device():
    """The CUDA path validates every tensor before a pointer is taken;
    the same checks, run against a CPU device, refuse bad inputs, and a
    tensor on an unsupported device never reaches either path."""
    cpu = torch.device("cpu")
    x = torch.zeros((4, 3), dtype=torch.float32)
    sa._check(x, "x", torch.float32, (4, 3), cpu)
    with pytest.raises(TypeError):
        sa._check(x.double(), "x", torch.float32, (4, 3), cpu)
    with pytest.raises(ValueError):
        sa._check(torch.zeros((3, 4)).T, "x", torch.float32, (4, 3), cpu)
    with pytest.raises(ValueError):
        sa._check(x, "x", torch.float32, (4, 2), cpu)
    with pytest.raises(ValueError):
        sa._check(None, "x", torch.float32, (4, 3), cpu)
    with pytest.raises(TypeError):
        sa._check(np.zeros((4, 3), np.float32), "x", torch.float32, (4, 3), cpu)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        sa.pair_assign(None, meta, None, meta, meta, meta, meta)
    # Any feature width passes: the kernels hold no row in registers
    assert not hasattr(sa, "MAX_FEATURES")
    wide = torch.zeros((4, 300), dtype=torch.float32)
    assert sa._check_bank(wide, torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.bool), 300, cpu) == 4
    sa._check(wide, "fc", torch.float32, (4, 300), cpu)
    sa._check_rows(4)
    with pytest.raises(ValueError):
        sa._check_rows(2**31)
    with pytest.raises(ValueError):
        sa.pair_assign(None, x, None, torch.zeros(4, dtype=torch.int32), x,
                       torch.zeros(4, dtype=torch.int32),
                       torch.ones(4, dtype=torch.bool), order="sideways")


def test_assign_flux_c2_defaults_to_the_centers_norms(problem):
    """``assign_flux_plain``'s ``c2``: None is ``|c|^2``; with uncentered
    features ``raw P`` and ``c2adj`` it is plain H2 on the raw rows."""
    t = to_torch(problem)
    r = to_torch(_raw(problem, 37, seed=11))
    S = problem["n_states"]
    rows = (t["pbins"], t["cbins"], t["w"], t["basis_p"], t["basis_c"],
            t["target_c"])
    ref = sa.assign_flux_plain(t["fp"], t["fc"], *rows, *_bank(t), S)
    c2 = (t["centers"] * t["centers"]).sum(1)
    got = sa.assign_flux_plain(t["fp"], t["fc"], *rows, *_bank(t), S, c2=c2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    a2 = sa.c2adj(r["mean"], r["proj"], t["centers"])
    got = sa.assign_flux_plain(r["raw_p"] @ r["proj"], r["raw_c"] @ r["proj"],
                               *rows, *_bank(t), S, c2=a2)
    ref = sa.transform_assign_plain(r["raw_p"], r["raw_c"], *rows, r["mean"],
                                    r["proj"], *_bank(t), S)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_launch_counters_count_only_kernel_launches(problem):
    t = to_torch(problem)
    sa.reset_launch_counts()
    sa.pair_assign(t["fp"], t["fc"], t["pbins"], t["cbins"], *_bank(t))
    assert sa.launch_counts() == dict.fromkeys(sa.KERNELS, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(problem, cuda_device):
    p = problem
    r = _raw(p, 37, seed=11)
    t = to_torch(p, cuda_device)
    rt = to_torch(r, cuda_device)
    w64 = t["w"].double()
    S = p["n_states"]
    bank = _bank(t)
    sa.reset_launch_counts()
    got = sa.assign_flux(t["fp"], t["fc"], t["pbins"], t["cbins"], w64,
                         t["basis_p"], t["basis_c"], t["target_c"], *bank, S)
    ref = sa.assign_flux_plain(t["fp"], t["fc"], t["pbins"], t["cbins"], w64,
                               t["basis_p"], t["basis_c"], t["target_c"], *bank, S)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    got = sa.transform_assign(rt["raw_p"], rt["raw_c"], t["pbins"], t["cbins"],
                              w64, t["basis_p"], t["basis_c"], t["target_c"],
                              rt["mean"], rt["proj"], *bank, S)
    ref = sa.transform_assign_plain(rt["raw_p"], rt["raw_c"], t["pbins"],
                                    t["cbins"], w64, t["basis_p"], t["basis_c"],
                                    t["target_c"], rt["mean"], rt["proj"], *bank, S)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    got = sa.transform_assign_child(rt["raw_c"], t["cbins"], t["basis_c"],
                                    t["target_c"], rt["mean"], rt["proj"], *bank,
                                    S, emit_features=True)
    ref = sa.transform_assign_child_plain(rt["raw_c"], t["cbins"], t["basis_c"],
                                          t["target_c"], rt["mean"], rt["proj"],
                                          *bank, S, emit_features=True)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    got = sa.pair_assign(t["fp"], t["fc"], t["pbins"], t["cbins"], *bank)
    ref = sa.pair_assign_plain(t["fp"], t["fc"], t["pbins"], t["cbins"], *bank)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert sa.launch_counts() == dict(dict.fromkeys(sa.KERNELS, 1),
                                      steady_tail=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins,k", [(5, 3), (40, 3)])
def test_cuda_grouped_scores_are_h2s(n_bins, k, cuda_device):
    """H1's features-only transform of both raw sets, then H3 on H2's
    ``c2adj``: bitwise H2's ids and dyadic f64 flux; ``c2=|c|^2`` is H3's
    default; a ``c2`` of another length is refused."""
    p = _problem(N=3000, n_bins=n_bins, k=k)
    r = _raw(p, 37, seed=11)
    t = to_torch(p, cuda_device)
    rt = to_torch(r, cuda_device)
    w64 = t["w"].double()
    S = p["n_states"]
    bank = _bank(t)
    rows = (t["pbins"], t["cbins"], w64, t["basis_p"], t["basis_c"], t["target_c"])
    ref = sa.transform_assign(rt["raw_p"], rt["raw_c"], *rows, rt["mean"],
                              rt["proj"], *bank, S)
    gp, gc = (sa.transform_assign_child(rt[raw], t[bins], None, None, rt["mean"],
                                        rt["proj"], *bank, S, features_only=True)[1]
              for raw, bins in (("raw_p", "pbins"), ("raw_c", "cbins")))
    a2 = sa.c2adj(rt["mean"], rt["proj"], t["centers"]).contiguous()
    got = sa.assign_flux(gp, gc, *rows, *bank, S, c2=a2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    c2 = (t["centers"] * t["centers"]).sum(1)
    got = sa.assign_flux(gp, gc, *rows, *bank, S, c2=c2)
    ref = sa.assign_flux(gp, gc, *rows, *bank, S)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        sa.assign_flux(gp, gc, *rows, *bank, S, c2=c2[:-1])
