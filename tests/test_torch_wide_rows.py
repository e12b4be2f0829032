"""H1-H3 (``transform_assign_child``, ``transform_assign``, ``assign_flux``)
at feature widths past 128.

The kernels keep a block's feature rows in a shared-memory tile and take
any width. On the CPU the wrappers run their plain versions, held here to
the Pallas kernels in interpret mode (their wrappers pad F to multiples of
128) at F = 160 and 300, and the hot step at a wide F to the JAX bench
step. Ids must agree except at near-ties (f32 rounding of the f64
minimum); flux with dyadic weights must be bitwise equal. The ``cuda``
tests hold each kernel to its plain version at the tiling's edges (rows
not a multiple of the block's, unaligned raw rows, a raw view one row in,
F = 30 / 129 / 300, K = 3,200); on the card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wide_rows.py
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa

from _torch_parity import assert_ids_match, np_, to_torch

torch.set_num_threads(1)


def _wide_problem(F, seed, N=200, D=None, n_bins=4, k=6):
    """Feature and raw rows of width F (raw D) with a compact bank of
    ``n_bins`` x ``k`` centers and dyadic weights."""
    rng = np.random.default_rng(seed)
    D = F + 20 if D is None else D
    K = n_bins * k
    p = dict(
        fp=rng.normal(size=(N, F)).astype(np.float32),
        fc=rng.normal(size=(N, F)).astype(np.float32),
        raw_p=rng.normal(size=(N, D)).astype(np.float32),
        raw_c=rng.normal(size=(N, D)).astype(np.float32),
        proj=(rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32),
        mean=(0.1 * rng.normal(size=D)).astype(np.float32),
        pbins=rng.integers(0, n_bins, N).astype(np.int32),
        cbins=rng.integers(0, n_bins, N).astype(np.int32),
        basis_p=rng.random(N) < 0.1,
        basis_c=rng.random(N) < 0.05,
        target_c=rng.random(N) < 0.05,
        centers=rng.normal(size=(K, F)).astype(np.float32),
        center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k),
        valid=np.ones(K, bool),
        n_states=K + 2,
    )
    p["w"] = (rng.integers(1, 17, N) / 16.0).astype(np.float32)
    return p


def _bank(t):
    return t["centers"], t["center_bin"], t["valid"]


@pytest.mark.parametrize("F", [160, 300])
@pytest.mark.parametrize("kernel", ["H1", "H2", "H3"])
def test_wide_rows_match_pallas(kernel, F):
    from msm_we_tpu.ops import pallas_kernels as pk

    p = _wide_problem(F, seed=F + len(kernel))
    t = to_torch(p)
    K, S = len(p["centers"]), p["n_states"]
    bank = (p["centers"], p["center_bin"], p["valid"])
    c2a = np_(sa.c2adj(t["mean"], t["proj"], t["centers"]))

    def raw_kw(side):  # near-ties of rows given raw, scored on c2adj
        return dict(c2=c2a, raw=p[side], proj=p["proj"])

    if kernel == "H1":
        ref, ref_g = pk.fused_transform_assign_child(
            p["raw_c"], p["cbins"], p["basis_c"], p["target_c"], p["mean"],
            p["proj"], *bank, S, tile=128, interpret=True, emit_features=True)
        idx, g = sa.transform_assign_child(
            t["raw_c"], t["cbins"], t["basis_c"], t["target_c"], t["mean"],
            t["proj"], *_bank(t), S, emit_features=True)
        assert g.shape == (len(p["w"]), F)
        np.testing.assert_allclose(np_(g), np.asarray(ref_g), rtol=1e-5, atol=1e-5)
        assert_ids_match(idx, ref, None, p["cbins"], *bank, n_regular=K,
                         **raw_kw("raw_c"))
        return
    if kernel == "H2":
        pidx, cidx, fm = pk.fused_transform_assign(
            p["raw_p"], p["raw_c"], p["pbins"], p["cbins"], p["w"],
            p["basis_p"], p["basis_c"], p["target_c"], p["mean"], p["proj"],
            *bank, S, tile=128, interpret=True)
        got = sa.transform_assign(
            t["raw_p"], t["raw_c"], t["pbins"], t["cbins"], t["w"],
            t["basis_p"], t["basis_c"], t["target_c"], t["mean"], t["proj"],
            *_bank(t), S)
        n = assert_ids_match(got[0], pidx, None, p["pbins"], *bank, n_regular=K,
                             **raw_kw("raw_p"))
        n += assert_ids_match(got[1], cidx, None, p["cbins"], *bank, n_regular=K,
                              **raw_kw("raw_c"))
    else:
        pidx, cidx, fm = pk.fused_assign_flux(
            p["fp"], p["fc"], p["pbins"], p["cbins"], p["w"], p["basis_p"],
            p["basis_c"], p["target_c"], *bank, S, tile=128)
        got = sa.assign_flux(
            t["fp"], t["fc"], t["pbins"], t["cbins"], t["w"], t["basis_p"],
            t["basis_c"], t["target_c"], *_bank(t), S)
        n = assert_ids_match(got[0], pidx, p["fp"], p["pbins"], *bank, n_regular=K)
        n += assert_ids_match(got[1], cidx, p["fc"], p["cbins"], *bank, n_regular=K)
    assert got[2].shape == (S, S)
    if n == 0:  # dyadic weights: exact cell sums in any order
        np.testing.assert_array_equal(np_(got[2]), np.asarray(fm))


def test_features_only_returns_the_emitted_features():
    p = _wide_problem(300, seed=5)
    t = to_torch(p)
    args = (t["raw_c"], t["cbins"], None, None, t["mean"], t["proj"], *_bank(t),
            p["n_states"])
    g, none = sa.transform_features(t["raw_c"], None, t["proj"])
    _ids, g_emit = sa.transform_assign_child(*args, emit_features=True)
    assert none is None
    assert torch.equal(g, g_emit)
    assert torch.equal(g, t["raw_c"] @ t["proj"])


@pytest.mark.parametrize("tier", ["two_transform", "dedup"])
def test_hot_step_at_wide_rows_matches_bench(tier):
    """The hot step at 160 features (raw 192) against the JAX bench step."""
    import bench

    from msm_we_tpu_torch.entry import hot_step
    from msm_we_tpu_torch.testing import make_problem

    p = make_problem(n_segments=1024, n_raw_features=192, n_components=160,
                     n_bins=4, k_per_bin=4, seed=6)
    step, args = bench.device_pipeline(p, dedup=tier == "dedup")
    jfm, _jpss, jflux, _jres = (np.asarray(o) for o in step(*args))
    out = hot_step(p, tier, "cpu")
    assert out["fm"].shape == jfm.shape
    # f32 weights summed in another order: f32 rounding of the cell sums
    np.testing.assert_allclose(np_(out["fm"]), jfm, rtol=1e-5, atol=1e-12)
    assert float(out["flux"]) == pytest.approx(float(jflux), rel=1e-3)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (rows, raw width, features, bins x centers per bin, raw as a view one row in)
EDGES = [
    (1000, 900, 30, (10, 25), False),    # rows not a multiple of the tile
    (1000, 901, 30, (10, 25), False),    # unaligned rows: the 4-byte path
    (1000, 900, 30, (10, 25), True),     # a view one row in (aligned)
    (999, 901, 129, (10, 25), True),     # ... unaligned, and F = 129
    (777, 300, 300, (12, 25), False),    # F = 300: a 64-row tile
    (3000, 64, 30, (128, 25), False),    # K = 3,200 over 128 bins
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,F,bank_shape,view", EDGES)
def test_cuda_h1_h3_match_plain_at_the_edges(N, D, F, bank_shape, view, cuda_device):
    n_bins, k = bank_shape
    p = _wide_problem(F, seed=N + D + F, N=N, D=D, n_bins=n_bins, k=k)
    t = to_torch(p, cuda_device)
    if view:  # the same rows, starting one row into a larger array
        for side in ("raw_p", "raw_c"):
            big = torch.cat([torch.zeros((1, D), device=cuda_device), t[side]])
            t[side] = big[1:]
            assert t[side].is_contiguous() and t[side].data_ptr() % 16 == (4 * D) % 16
    K, S = len(p["centers"]), p["n_states"]
    bank = (p["centers"], p["center_bin"], p["valid"])
    c2a = np_(sa.c2adj(t["mean"], t["proj"], t["centers"]))

    def raw_kw(side):  # near-ties of rows given raw, scored on c2adj
        return dict(c2=c2a, raw=p[side], proj=p["proj"])

    w64 = t["w"].double()
    sa.reset_launch_counts()

    # H1 with features, and the features alone (the streaming kernel up to
    # 32 features, else H1's features-only launch)
    h1 = (t["raw_c"], t["cbins"], t["basis_c"], t["target_c"], t["mean"],
          t["proj"], *_bank(t), S)
    idx, g = sa.transform_assign_child(*h1, emit_features=True)
    ridx, rg = sa.transform_assign_child_plain(*h1, emit_features=True)
    g_only, none = sa.transform_features(t["raw_c"], None, t["proj"])
    torch.cuda.synchronize()
    assert none is None and torch.equal(g_only, g)
    torch.testing.assert_close(g, rg, rtol=1e-5, atol=1e-5)
    assert_ids_match(idx, ridx, None, p["cbins"], *bank, n_regular=K, **raw_kw("raw_c"))

    # H2 with dyadic f64 flux
    h2 = (t["raw_p"], t["raw_c"], t["pbins"], t["cbins"], w64, t["basis_p"],
          t["basis_c"], t["target_c"], t["mean"], t["proj"], *_bank(t), S)
    got, ref = sa.transform_assign(*h2), sa.transform_assign_plain(*h2)
    n = assert_ids_match(got[0], ref[0], None, p["pbins"], *bank, n_regular=K,
                         **raw_kw("raw_p"))
    n += assert_ids_match(got[1], ref[1], None, p["cbins"], *bank, n_regular=K,
                          **raw_kw("raw_c"))
    from msm_we_tpu_torch.step import _scatter_flux

    assert torch.equal(got[2], _scatter_flux(got[0], got[1], w64, S))  # dyadic
    if n == 0:
        assert torch.equal(got[2], ref[2])

    # H3 on the same rows' features, and its raw ids bitwise H4's
    h3 = (t["fp"], t["fc"], t["pbins"], t["cbins"], w64, t["basis_p"],
          t["basis_c"], t["target_c"], *_bank(t), S)
    got, ref = sa.assign_flux(*h3), sa.assign_flux_plain(*h3)
    n = assert_ids_match(got[0], ref[0], p["fp"], p["pbins"], *bank, n_regular=K)
    n += assert_ids_match(got[1], ref[1], p["fc"], p["cbins"], *bank, n_regular=K)
    if n == 0:
        assert torch.equal(got[2], ref[2])
    off = torch.zeros(N, dtype=torch.bool, device=cuda_device)
    hp, hc, _fm = sa.assign_flux(t["fp"], t["fc"], t["pbins"], t["cbins"], w64,
                                 off, off, off, *_bank(t), S)
    pp, pc = sa.pair_assign(t["fp"], t["fc"], t["pbins"], t["cbins"], *_bank(t))
    assert torch.equal(hp, pp) and torch.equal(hc, pc)
    counts = sa.launch_counts()
    streams = sa.features_stream_fits(D, F)
    assert counts["transform_features"] == int(streams)
    assert counts["transform_assign_child"] == 2 - streams
    assert counts["transform_assign"] == 1
    assert counts["assign_flux"] == 2 and counts["pair_assign"] == 1
