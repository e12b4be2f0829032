"""The port's mesh programs (``msm_we_tpu_torch/parallel``) on gloo groups of
CPU processes, against one rank and against the JAX package's
``build_sharded_*`` on its virtual CPU mesh.

``entry.dryrun_multichip`` runs on 2 ranks (meshes (2, 1) and (1, 2)) and
on 4 ranks ((2, 2) and (4, 1)), once each per module: the hot step's
problem cut to 600 rows (10 bins x 25 centers, and 16 bins x 25), and the
JAX dryrun's awkward shapes with their padded copies. The dryrun itself
requires ids, the dyadic f64 flux, counts, minima and maxima bitwise the
one-rank ones and the f64 pcoord sums within 1e-12; the tests read its
checks and hold the rank results to JAX's programs on the same (data,
model) shape: ids equal up to near-ties (these seeded problems have none),
the flux within 1e-12, the statistics' counts, minima and maxima equal and the sums
(JAX adds in f32) within 1e-5. Also: ``best_mesh_shape`` against JAX's,
H4's score output (plain version) against the ``masked_scores`` minimum,
the mesh layout and the (min, id) combine.

The ``cuda`` tests hold H4's score output on the card to the plain version
and its ids with and without scores bitwise; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel.py
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.ops.kmeans import masked_scores
from msm_we_tpu_torch.parallel import best_mesh_shape
from msm_we_tpu_torch.parallel.mesh import Mesh
from msm_we_tpu_torch.parallel.sharded import _combine_argmin

from _torch_parity import assert_ids_match

torch.set_num_threads(1)

SHAPES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (4, 1)]}
PROBLEMS = ("hot", "wide", "awkward0", "awkward0_padded", "awkward1",
            "awkward1_padded")
TIMEOUT = 50  # seconds a group of ranks may take


@pytest.fixture(scope="module")
def runs():
    from msm_we_tpu_torch.entry import dryrun_multichip

    return {n: dryrun_multichip(n, device="cpu", n_segments=600, wide_bins=16,
                                timeout=TIMEOUT) for n in SHAPES}


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("n", range(1, 9))
def test_best_mesh_shape_matches_jax(n):
    from msm_we_tpu.parallel.mesh import best_mesh_shape as jax_shape

    assert best_mesh_shape(n) == jax_shape(n)
    for m in (1, 2, 4):
        if n % m == 0:
            assert best_mesh_shape(n, m) == jax_shape(n, m)
        else:
            with pytest.raises(ValueError):
                best_mesh_shape(n, m)


def _fake(shape, coords):
    """A mesh without process groups at ``coords`` of ``shape``: the
    layout methods work, collectives are not issued."""
    return Mesh({"data": shape[0], "model": shape[1]}, coords,
                {"data": None, "model": None, "world": None}, "cpu", None)


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (4, 1), (2, 4)])
def test_row_blocks_and_bank_shards_tile_the_problem(shape):
    """The data ranks' blocks tile the rows in order, padded with ``fill``;
    the model ranks' shards tile the bank in order, padded with invalid
    rows, each with its first global id."""
    N, K = 23, 9
    a = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    bank = (torch.arange(K * 3, dtype=torch.float32).reshape(K, 3),
            torch.arange(K, dtype=torch.int32), torch.ones(K, dtype=torch.bool))
    D, M = shape
    blocks, shards = [], []
    for d in range(D):
        mesh = _fake(shape, (d, 0))
        lo, hi, block = mesh.row_block(N)
        rows = mesh.rows(a, -1.0)
        assert rows.shape == (-(-N // D), 2) and block == rows.shape[0]
        assert (rows[hi - lo:] == -1).all()
        blocks.append(rows[: hi - lo])
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), a)
    for m in range(M):
        c, cb, v, offset = _fake(shape, (0, m)).bank_shard(*bank)
        assert offset == m * c.shape[0] and c.shape[0] == -(-K // M)
        assert (cb[~v] == -2).all() and (c[~v] == 0).all()
        shards.append((c[v], cb[v]))
    np.testing.assert_array_equal(torch.cat([s[0] for s in shards]), bank[0])
    np.testing.assert_array_equal(torch.cat([s[1] for s in shards]), bank[1])


class _Gathered:
    """A stand-in mesh whose 'model' all-gather returns given shards."""

    def __init__(self, mins, gids):
        self.parts = iter([torch.stack(mins), torch.stack(gids)])

    def all_gather(self, t, axis):
        assert axis == "model"
        return next(self.parts)


def test_combine_argmin_orders_by_score_then_global_id():
    inf = float("inf")
    mins = [torch.tensor([1.0, 2.0, inf, 0.5, inf]),
            torch.tensor([1.0, 1.5, 3.0, 0.5, inf])]
    gids = [torch.tensor([4, 1, 2, 7, 3], dtype=torch.int32),
            torch.tensor([2, 9, 5, 6, 8], dtype=torch.int32)]
    got = _combine_argmin(mins[0], gids[0], _Gathered(mins, gids))
    # tie -> lower id; smaller score wins; +inf never a candidate; none -> 0
    assert got.tolist() == [2, 9, 5, 6, 0]


def test_shard_problem_blocks_tile_the_problem():
    """The row shards a launch writes are the mesh's row blocks: in order,
    padded inert, with the bank and the sizes; a shard of another block
    length is refused."""
    from msm_we_tpu_torch.parallel.distributed import (
        complete_problem,
        run_programs,
        shard_problem,
    )
    from msm_we_tpu_torch.testing import tiny_stratified_problem

    p = complete_problem(tiny_stratified_problem(n_rows=23, seed=3))
    for data in (1, 2, 3, 5):
        real = {key: [] for key in ("fc", "cbins", "target_p", "w", "p1")}
        for d in range(data):
            s = shard_problem(p, data, d)
            lo, hi, block = _fake((data, 1), (d, 0)).row_block(23)
            assert len(s["w"]) == block and s["n_rows"] == 23
            assert (s["pbins"][hi - lo:] == -1).all() and (s["w"][hi - lo:] == 0).all()
            assert np.isnan(s["p1"][hi - lo:]).all() and not s["basis_c"][hi - lo:].any()
            np.testing.assert_array_equal(s["centers"], p["centers"])
            for key in real:
                real[key].append(s[key][: hi - lo])
        for key, parts in real.items():
            np.testing.assert_array_equal(np.concatenate(parts), np.asarray(p[key]))
    with pytest.raises(ValueError, match="does not fit"):
        run_programs(Mesh.single("cpu"), shard_problem(p, 2, 0))


class _StubMesh:
    """Stands in for a mesh of ``n`` ranks in the route choice."""

    def __init__(self, n):
        self.world_size = n


@pytest.mark.parametrize("n_ranks,sharded", [(1, False), (2, True)])
def test_predict_takes_the_sharded_route_only_over_several_ranks(
        n_ranks, sharded, monkeypatch):
    """A one-rank mesh (the (1, 1) mesh a device-pipeline build attaches)
    predicts by the one-device route; only several ranks shard it."""
    from msm_we_tpu_torch.ops.stratified import HOST_BATCH_THRESHOLD, StratifiedKmeans

    rng = np.random.default_rng(0)
    strat = StratifiedKmeans(n_bins=2, k_per_bin=3, n_features=4, seed=0, device="cpu")
    X = rng.normal(size=(HOST_BATCH_THRESHOLD, 4)).astype(np.float32)
    bins = rng.integers(0, 2, len(X))
    strat.partial_fit(X, bins)
    expected = strat.predict(X, bins)
    calls = []
    monkeypatch.setattr(StratifiedKmeans, "_predict_sharded",
                        lambda self, X, b: calls.append(len(X)) or expected)
    strat.use_mesh(Mesh.single("cpu") if n_ranks == 1 else _StubMesh(n_ranks))
    np.testing.assert_array_equal(strat.predict(X, bins), expected)
    assert bool(calls) == sharded


# ----------------------------------------------------------------- scores


def _score_case(case, N=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    if case == "holey":
        center_bin = np.repeat(np.arange(6), 5)
        valid = rng.random(30) < 0.7
    elif case == "empty_bins":
        center_bin = np.repeat(np.arange(6), 4)
        valid = ~np.isin(center_bin, [2, 4])
    else:  # one bin, aggregated clustering's shape
        center_bin = np.zeros(40, int)
        valid = np.ones(40, bool)
    n_bins = int(center_bin.max()) + 1
    row_bins = np.arange(-1, n_bins) if n_bins > 1 else np.array([0])
    t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(dt)
    return (t(rng.normal(size=(N, d)), torch.float32),
            t(rng.normal(size=(N, d)), torch.float32),
            t(rng.choice(row_bins, N), torch.int32), t(rng.choice(row_bins, N), torch.int32),
            t(rng.normal(size=(len(center_bin), d)), torch.float32),
            t(center_bin, torch.int32), t(valid, torch.bool))


@pytest.mark.parametrize("case", ["holey", "empty_bins", "one_bin"])
def test_pair_assign_scores_are_the_masked_minimum(case):
    fp, fc, pb, cb, C, cbin, valid = _score_case(case)
    pidx, cidx, pmin, cmin = sa.pair_assign(fp, fc, pb, cb, C, cbin, valid,
                                            return_scores=True)
    p0, c0 = sa.pair_assign(fp, fc, pb, cb, C, cbin, valid)
    assert torch.equal(pidx, p0) and torch.equal(cidx, c0)
    one, one_min = sa.pair_assign(None, fc, None, cb, C, cbin, valid,
                                  return_scores=True)
    assert torch.equal(one, c0) and torch.equal(one_min, cmin)
    for X, bins, ids, mins in ((fp, pb, pidx, pmin), (fc, cb, cidx, cmin)):
        assert mins.dtype == torch.float32
        s = masked_scores(X, bins, C, cbin, valid)
        has = (valid[None] & (cbin[None] == bins[:, None])).any(1)
        assert torch.equal(mins[has], s.min(1).values[has])
        assert torch.equal(mins[has], s.gather(1, ids[:, None].long())[has, 0])
        assert bool(torch.isinf(mins[~has]).all()) and bool((ids[~has] == 0).all())
    if case == "empty_bins":
        assert bool((~torch.isfinite(cmin)).any())
    with pytest.raises(ValueError, match="without overrides"):
        sa.pair_assign(fp, fc, pb, cb, C, cbin, valid, n_states=40,
                       order="predict", return_scores=True)


# ------------------------------------------------------------ mesh groups


@pytest.mark.parametrize("n_ranks", sorted(SHAPES))
def test_dryrun_checks_every_shape_and_problem(runs, n_ranks):
    checks = {c["name"]: c for c in runs[n_ranks]["checks"]}
    for data, model in SHAPES[n_ranks]:
        for name in PROBLEMS:
            c = checks[f"{name}@{data}x{model}"]
            assert c["ids_bitwise"] and c["flux_bitwise"]
            assert c["sums_rel_err"] <= 1e-12
            assert c.get("padding_inert", "_padded" not in name)


def _jax_programs(problem, data, model):
    """JAX's sharded programs on the same (data, model) shape of the
    virtual CPU mesh, at the padded sizes its shard_map needs."""
    import jax

    from msm_we_tpu.parallel.mesh import make_mesh
    from msm_we_tpu.parallel.sharded import (
        build_sharded_assign,
        build_sharded_cluster_stats,
        build_sharded_pair_assign,
        build_sharded_single_assign,
        build_sharded_step,
    )
    from msm_we_tpu_torch.parallel.distributed import pad_problem

    mesh = make_mesh(jax.devices()[: data * model], model_parallel=model)
    N, K = len(problem["w"]), len(problem["valid"])
    p = pad_problem(problem, -(-N // data) * data, -(-K // model) * model)
    n_bins = int(np.asarray(problem["center_bin"]).max()) + 1
    S = int(problem["n_states"])
    rows = [p[k] for k in ("fp", "fc", "pbins", "cbins", "basis_p", "basis_c",
                           "target_c")]
    bank = [p["centers"], p["center_bin"], p["valid"]]
    w32 = np.asarray(p["w"], np.float32)  # dyadic: exact in f32 too
    fm = build_sharded_step(mesh, S, with_target_p=True, n_bins=n_bins)(
        *rows, w32, *bank, p["target_p"])
    both = build_sharded_pair_assign(mesh, S, with_target_p=True, n_bins=n_bins)(
        *rows, *bank, p["target_p"])
    single = build_sharded_single_assign(mesh, S, n_bins=n_bins)(
        p["fc"], p["cbins"], p["basis_c"], p["target_c"], *bank)
    raw = build_sharded_assign(mesh, n_bins=n_bins)(p["fc"], p["cbins"], *bank)
    stats = build_sharded_cluster_stats(mesh, len(p["valid"]), 2)(
        raw, p["p1"], int(problem["n_live"]))
    both = np.asarray(both).astype(np.int64)
    out = dict(fm=np.asarray(fm, np.float64), pidx=both[:N, 0], cidx=both[:N, 1],
               single=np.asarray(single).astype(np.int64)[:N],
               assign=np.asarray(raw).astype(np.int64)[:N])
    out.update(zip(("counts", "sums", "vmin", "vmax"),
                   (np.asarray(t)[:K] for t in stats)))
    return out


@pytest.mark.parametrize("name", ["hot", "awkward0"])
@pytest.mark.parametrize("shape", [s for n in sorted(SHAPES) for s in SHAPES[n]],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_programs_match_jax_mesh(runs, shape, name):
    data, model = shape
    run = runs[data * model]
    key = f"{name}@{data}x{model}"
    prob, got = run["problems"][key], run["results"][key]
    ref = _jax_programs(prob, data, model)
    K = len(prob["valid"])
    bank = (prob["centers"], prob["center_bin"], prob["valid"])
    ties = 0
    for k, X, bins in (("pidx", prob["fp"], prob["pbins"]),
                       ("cidx", prob["fc"], prob["cbins"]),
                       ("single", prob["fc"], prob["cbins"]),
                       ("assign", prob["fc"], prob["cbins"])):
        ties += assert_ids_match(got[k], ref[k], X, bins, *bank, n_regular=K)
    # These seeded problems have no near-tie row, so every id agrees and
    # the flux and the statistics are compared whole
    assert ties == 0
    scale = np.abs(ref["fm"]).max()
    assert np.abs(got["fm"] - ref["fm"]).max() <= 1e-12 * scale
    np.testing.assert_array_equal(got["counts"][:K], ref["counts"])
    np.testing.assert_array_equal(got["vmin"][:K], ref["vmin"])
    np.testing.assert_array_equal(got["vmax"][:K], ref["vmax"])
    np.testing.assert_allclose(got["sums"][:K], ref["sums"], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["holey", "empty_bins", "one_bin"])
@pytest.mark.parametrize("F", [5, 30, 300])
def test_cuda_scores_match_plain_and_ids_unchanged(case, F, cuda_device):
    """On the card: ids with and without scores bitwise; scores equal the
    plain version's where the ids agree (to f32 rounding of the product,
    whose order differs), ``+inf`` exactly where the bin has no center."""
    tensors = _score_case(case, N=5000, d=F, seed=F)
    fp, fc, pb, cb, C, cbin, valid = (t.to(cuda_device) for t in tensors)
    pk, ck, pmin, cmin = sa.pair_assign(fp, fc, pb, cb, C, cbin, valid,
                                        return_scores=True)
    p0, c0 = sa.pair_assign(fp, fc, pb, cb, C, cbin, valid)
    assert torch.equal(pk, p0) and torch.equal(ck, c0)
    one, one_min = sa.pair_assign(None, fc, None, cb, C, cbin, valid,
                                  return_scores=True)
    assert torch.equal(one, c0) and torch.equal(one_min, cmin)
    pp, cp, ppm, cpm = sa.pair_assign_plain(fp, fc, pb, cb, C, cbin, valid,
                                            return_scores=True)
    for ids, ref_ids, mins, ref_mins in ((pk, pp, pmin, ppm), (ck, cp, cmin, cpm)):
        assert torch.equal(torch.isinf(mins), torch.isinf(ref_mins))
        finite = torch.isfinite(ref_mins)
        same = (ids == ref_ids) & finite
        # Rows a bin without centers cannot score are excluded; of the rest
        # only near-ties may differ
        assert int(same.sum()) >= 0.99 * int(finite.sum())
        tol = 1e-5 * (C.abs().sum(1).max() * fc.abs().max() + 1) * F
        assert float((mins[same] - ref_mins[same]).abs().max()) <= float(tol)
