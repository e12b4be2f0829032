"""H4 (``pair_assign``) as a bin-grouped kernel of any feature width.

On CUDA the wrapper groups the rows by bin (``_bin_tiles``: a stable sort
of the rows, tiles of one bin each) and the kernel scores each tile against
its bin's centers only. The plan's plain version (``_bin_tiles_plain``) is
torch, so the CPU tests hold it to its invariants, and a tile-by-tile
emulation of the kernel built on it to ``pair_assign_plain``. The JAX Pallas kernel ``_assign_call`` (interpret
mode) is the reference at 12 and 300 features. Ids must agree except at
near-ties (f32 rounding of the f64 minimum).

The ``cuda`` test compares the kernel with the plain version and, bitwise,
with the raw ids of H3 (``assign_flux``); on the card run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pair_assign.py
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa

from _torch_parity import assert_ids_match, np_, to_torch

torch.set_num_threads(1)


def _bank_case(case, seed=0, d=6, N=700):
    """Rows and a bank for one plan case: (fp, fc, pbins, cbins, centers,
    center_bin, valid) as numpy arrays."""
    rng = np.random.default_rng(seed)
    if case == "holey":  # invalid centers scattered through the bank
        n_bins, k = 6, 5
        center_bin = np.repeat(np.arange(n_bins), k)
        valid = rng.random(len(center_bin)) < 0.7
    elif case == "empty_bins":  # bins 2 and 4 have no valid center
        n_bins, k = 6, 4
        center_bin = np.repeat(np.arange(n_bins), k)
        valid = ~np.isin(center_bin, [2, 4])
    elif case == "unsorted":  # the bank is not ordered by bin
        n_bins, k = 5, 4
        center_bin = rng.permutation(np.repeat(np.arange(n_bins), k))
        valid = rng.random(len(center_bin)) < 0.9
    elif case == "one_bin":  # aggregated clustering: every row in bin 0
        n_bins, k = 1, 300
        center_bin = np.zeros(k, int)
        valid = np.ones(k, bool)
    elif case == "bins128":
        n_bins, k = 128, 3
        center_bin = np.repeat(np.arange(n_bins), k)
        valid = rng.random(len(center_bin)) < 0.95
    else:
        raise ValueError(case)
    K = len(center_bin)
    row_bins = np.arange(-1, n_bins) if n_bins > 1 else np.array([0])
    return dict(
        fp=rng.normal(size=(N, d)).astype(np.float32),
        fc=rng.normal(size=(N, d)).astype(np.float32),
        pbins=rng.choice(row_bins, N).astype(np.int32),
        cbins=rng.choice(row_bins, N).astype(np.int32),
        centers=rng.normal(size=(K, d)).astype(np.float32),
        center_bin=center_bin.astype(np.int32),
        valid=valid,
    )


CASES = ["holey", "empty_bins", "unsorted", "one_bin", "bins128"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tile_rows", [sa.TILE_ROWS, 7])
def test_tile_plan_covers_each_row_once_in_one_bin(case, tile_rows):
    p = _bank_case(case)
    bins = np.concatenate([p["pbins"], p["cbins"]])
    center_bin, valid = p["center_bin"], p["valid"]
    R, K = len(bins), len(center_bin)
    args = [torch.as_tensor(p[k]) for k in ("pbins", "cbins", "center_bin", "valid")]
    plan = sa._bin_tiles_plain(*args, tile_rows)
    if tile_rows == sa.TILE_ROWS:  # on CPU tensors the plan is the plain one
        assert all(torch.equal(a, b) for a, b in zip(sa._bin_tiles(*args), plan))
    order, cperm, tiles = (np_(t) for t in plan)
    assert tiles.shape == (-(-R // tile_rows) + min(K, R) + 1, 4)
    assert order.dtype == np.int64 and tiles.dtype == cperm.dtype == np.int32
    assert (tiles[~(tiles[:, 1] > 0)] == 0).all()  # zero tiles past the last
    # The bank sorted stably by bin, valid centers first
    key = np.where(valid, center_bin.astype(np.int64), 2**40)
    np.testing.assert_array_equal(cperm, np.argsort(key, kind="stable"))
    assert sorted(order.tolist()) == list(range(R))
    covered = np.isin(bins, center_bin[valid])
    seen_scored = np.zeros(R, int)
    seen_empty = np.zeros(R, int)
    live = tiles[:, 1] > 0
    assert live[:live.sum()].all()  # tiles first, then the empty rest
    for first, nrows, c0, nc in tiles[live]:
        assert 0 < nrows <= tile_rows
        rows = order[first:first + nrows]
        if nc == 0:
            seen_empty[rows] += 1
            continue
        cids = cperm[c0:c0 + nc]
        assert valid[cids].all()
        assert len(set(center_bin[cids])) == 1  # never straddles bins
        b = center_bin[cids[0]]
        assert (bins[rows] == b).all()
        # Every valid center of the bin, in id order
        np.testing.assert_array_equal(cids, np.flatnonzero(valid & (center_bin == b)))
        seen_scored[rows] += 1
    np.testing.assert_array_equal(seen_scored, covered.astype(int))
    np.testing.assert_array_equal(seen_empty, (~covered).astype(int))
    # Each group's rows keep their order (the sort is stable)
    for first, nrows, _c0, _nc in tiles[live]:
        rows = order[first:first + nrows]
        assert (np.diff(rows) > 0).all()


def _emulate(fp, fc, pbins, cbins, centers, center_bin, valid, tile_rows=64):
    """The kernel's arithmetic tile by tile from the plan, in plain torch:
    each tile's rows against its bin's centers, first minimum of
    ``|c|^2 - 2 x.c``, id 0 for rows of a tile without centers."""
    X = fc if fp is None else torch.cat([fp, fc])
    order, cperm, tiles = sa._bin_tiles_plain(pbins, cbins, center_bin, valid,
                                              tile_rows)
    ids = torch.full((len(X),), -1, dtype=torch.int32)
    c2 = (centers * centers).sum(1)
    for first, nrows, c0, nc in tiles.tolist():
        if nrows == 0:
            continue
        rows = order[first:first + nrows].long()
        if nc == 0:
            ids[rows] = 0
            continue
        cids = cperm[c0:c0 + nc].long()
        scores = c2[cids][None, :] - 2.0 * (X[rows] @ centers[cids].T)
        ids[rows] = cids[torch.argmin(scores, dim=1)].to(torch.int32)
    assert (ids >= 0).all()
    n = len(fc)
    return ids if fp is None else (ids[:n], ids[n:])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pair", [True, False], ids=["pair", "child_only"])
def test_tile_emulation_matches_plain(case, pair):
    p = _bank_case(case, seed=4)
    t = to_torch(p)
    bank = (t["centers"], t["center_bin"], t["valid"])
    fp = t["fp"] if pair else None
    pb = t["pbins"] if pair else None
    got = _emulate(fp, t["fc"], pb, t["cbins"], *bank, tile_rows=32)
    ref = sa.pair_assign_plain(fp, t["fc"], pb, t["cbins"], *bank)
    if not pair:
        got, ref = (None, got), (None, ref)
    for side, X, bins in ((0, "fp", "pbins"), (1, "fc", "cbins")):
        if got[side] is None:
            continue
        assert_ids_match(got[side], ref[side], p[X], p[bins], p["centers"],
                         p["center_bin"], p["valid"])


def _jax_h4(pk, fp, fc, pbins, cbins, centers, center_bin, valid, tile=128):
    """``_assign_call`` in interpret mode (``tests/test_torch_kernels.py``)."""
    N, d = fp.shape
    K = len(centers)
    Np, dp, Kp = pk._round_up(N, tile), pk._round_up(d, 128), pk._round_up(K, 128)
    pidx, cidx = pk._assign_call(
        pk._pad2(fp, Np, dp), pk._pad2(fc, Np, dp),
        pk._col(pbins, Np, -1), pk._col(cbins, Np, -1),
        pk._pad2(centers, Kp, dp).T.copy(), pk._col(center_bin, Kp, -2),
        pk._col(valid.astype(np.int32), Kp), tile=tile, interpret=True,
    )
    return np.asarray(pidx)[:N], np.asarray(cidx)[:N]


@pytest.mark.parametrize("F", [12, 300])
def test_wide_rows_match_pallas_h4(F):
    """At 300 features (batch PCA at 100 atoms keeps all of them; TICA and
    VAMP keep 139-145) and at the default build's 12, ``pair_assign`` on
    the CPU and the tile emulation match the Pallas kernel."""
    from msm_we_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(F)
    N, n_bins, k = 200, 4, 6
    p = dict(
        fp=rng.normal(size=(N, F)).astype(np.float32),
        fc=rng.normal(size=(N, F)).astype(np.float32),
        pbins=rng.integers(-1, n_bins, N).astype(np.int32),
        cbins=rng.integers(0, n_bins, N).astype(np.int32),
        centers=rng.normal(size=(n_bins * k, F)).astype(np.float32),
        center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k),
        valid=np.ones(n_bins * k, bool),
    )
    ref = _jax_h4(pk, **p)
    t = to_torch(p)
    args = (t["fp"], t["fc"], t["pbins"], t["cbins"], t["centers"],
            t["center_bin"], t["valid"])
    bank = (p["centers"], p["center_bin"], p["valid"])
    for got in (sa.pair_assign(*args), _emulate(*args)):
        assert_ids_match(got[0], ref[0], p["fp"], p["pbins"], *bank)
        assert_ids_match(got[1], ref[1], p["fc"], p["cbins"], *bank)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case,F", [("holey", 12), ("empty_bins", 30),
                                    ("unsorted", 64), ("one_bin", 12),
                                    ("bins128", 30), ("holey", 300)])
def test_cuda_kernel_matches_plain_and_h3(case, F, cuda_device):
    """The kernel against ``pair_assign_plain`` (ids up to near-ties,
    overrides exactly) and against H3's raw ids bitwise."""
    p = _bank_case(case, seed=F, d=F, N=5000)
    t = to_torch(p, cuda_device)
    args = (t["fp"], t["fc"], t["pbins"], t["cbins"], t["centers"],
            t["center_bin"], t["valid"])
    bank = (p["centers"], p["center_bin"], p["valid"])
    plan_args = (t["pbins"], t["cbins"], t["center_bin"], t["valid"])
    for a, b in zip(sa._bin_tiles(*plan_args), sa._bin_tiles_plain(*plan_args)):
        assert torch.equal(a, b)  # the plan kernels equal the plain plan
    sa.reset_launch_counts()
    got = sa.pair_assign(*args)
    ref = sa.pair_assign_plain(*args)
    assert sa.launch_counts()["pair_assign"] == 1
    assert_ids_match(got[0], ref[0], p["fp"], p["pbins"], *bank)
    assert_ids_match(got[1], ref[1], p["fc"], p["cbins"], *bank)
    assert torch.equal(sa.pair_assign(*args)[1], got[1])  # repeats bitwise
    rng = np.random.default_rng(1)
    N, K = len(p["fc"]), len(p["centers"])
    masks = {m: torch.as_tensor(rng.random(N) < 0.1, device=cuda_device)
             for m in ("basis_p", "basis_c", "target_p", "target_c")}
    for order in ("flux", "predict"):
        a = sa.pair_assign(*args, n_states=K + 2, order=order, **masks)
        b = sa.pair_assign_plain(*args, n_states=K + 2, order=order, **masks)
        for side in (0, 1):
            over = a[side] >= K
            assert torch.equal(over, b[side] >= K)
            assert torch.equal(a[side][over], b[side][over])
            assert torch.equal(a[side][~over], got[side][~over])
    none = torch.zeros(N, dtype=torch.bool, device=cuda_device)
    w = torch.ones(N, dtype=torch.float64, device=cuda_device)
    hp, hc, _fm = sa.assign_flux(t["fp"], t["fc"], t["pbins"], t["cbins"],
                                 w, none, none, none, t["centers"],
                                 t["center_bin"], t["valid"], K + 2)
    assert torch.equal(hp, got[0]) and torch.equal(hc, got[1])
