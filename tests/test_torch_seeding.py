"""The port's device seeding family (``msm_we_tpu_torch.ops.kmeans``:
``kmeans_plusplus``, ``lloyd``, ``seed_bin``, ``seed_bins_batched``,
``kmeans_fit``) and the device-family branch of
``StratifiedKmeans.partial_fit``, against the JAX package on the same
numpy inputs, on the CPU.

JAX's PRNG cannot be reproduced in torch, so k-means++ is held to the
properties of a weighted k-means++ draw (zero-weight rows never chosen,
first-draw frequencies proportional to the weights, the all-duplicate
fallback, determinism), and the Lloyd updates are held to JAX's from an
injected initialization: ids equal up to near-ties, centers and weight
sums within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from msm_we_tpu.ops import kmeans as jkm
from msm_we_tpu.ops.stratified import StratifiedKmeans as JaxStrat
from msm_we_tpu_torch.ops import kmeans as km
from msm_we_tpu_torch.ops.stratified import StratifiedKmeans

from _torch_parity import assert_ids_match

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _blobs(rng, n, d, n_blobs, spread=0.05):
    means = rng.normal(size=(n_blobs, d)) * 3.0
    return (means[rng.integers(0, n_blobs, n)]
            + spread * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("n_iter", [1, 5])
def test_lloyd_and_seed_tail_match_jax(weighted, n_iter):
    """``lloyd`` and the ``seed_bin`` tail (final assignment, per-center
    weight sums) from an injected init equal JAX's ``lloyd`` +
    ``assign_flat`` + ``segment_sum``. One init center lies far away, so
    its cluster stays empty and keeps its center."""
    rng = np.random.default_rng(11 + n_iter)
    n, d, k = 600, 4, 6
    X = _blobs(rng, n, d, 5)
    w = (rng.uniform(0.1, 1.0, n) if weighted else np.ones(n)).astype(np.float32)
    init = X[rng.choice(n, k, replace=False)].copy()
    init[-1] = 1e3  # never the nearest: an empty cluster

    cj = np.asarray(jkm.lloyd(jnp.asarray(X), jnp.asarray(w), jnp.asarray(init),
                              n_iter=n_iter))
    idx_j, _ = jkm.assign_flat(jnp.asarray(X), jnp.asarray(cj), jnp.ones(k, bool))
    wsum_j = np.asarray(jax.ops.segment_sum(jnp.asarray(w), idx_j, num_segments=k))

    cp = km.lloyd(_t(X), _t(w), _t(init), n_iter=n_iter)
    centers_p, wsum_p = km._lloyd_batched(_t(X)[None], _t(w)[None], _t(init)[None],
                                          n_iter)
    assert torch.equal(centers_p[0], cp)
    np.testing.assert_allclose(cp.numpy(), cj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cp.numpy()[-1], init[-1])
    ids_p = km.assign_flat(_t(X), cp, torch.ones(k, dtype=torch.bool))
    zeros = np.zeros(n, np.int32)
    assert_ids_match(ids_p, np.asarray(idx_j), X, zeros, cp.numpy(),
                     np.zeros(k, np.int32), np.ones(k, bool))
    np.testing.assert_allclose(wsum_p[0].numpy(), wsum_j, rtol=1e-5)


def test_seed_bins_batched_matches_per_bin_seed_bin():
    """The batched seeding equals per-bin ``seed_bin`` calls bitwise (JAX's
    own check, ``tests/test_minibatch_scan.py:212``), and in both packages
    the weight sums account for exactly the live rows of each bin."""
    rng = np.random.default_rng(5)
    B, P, d, k = 4, 512, 3, 7
    Xs = rng.normal(size=(B, P, d)).astype(np.float32)
    ws = rng.random((B, P)).astype(np.float32)
    ws[:, 400:] = 0.0  # zero-weight padding rows must stay inert
    seeds = list(range(10, 10 + B))

    batched, index = km.seed_bins_batched(seeds, _t(Xs), _t(ws), k, return_index=True)
    per_bin = torch.stack([km.seed_bin(s, _t(Xs[i]), _t(ws[i]), k)
                           for i, s in enumerate(seeds)])
    assert torch.equal(batched, per_bin)
    assert (index < 400).all()
    # The draws do not depend on the shared padded length
    shorter = km.seed_bins_batched(seeds, _t(Xs[:, :450]), _t(ws[:, :450]), k)
    assert torch.equal(shorter, batched)

    jb = np.asarray(jkm.seed_bins_batched(jnp.asarray(np.asarray(seeds, np.uint32)),
                                          jnp.asarray(Xs), jnp.asarray(ws), k))
    for packed in (batched.numpy(), jb):
        assert packed.shape == (B, k, d + 1)
        np.testing.assert_allclose(packed[:, :, -1].sum(axis=1), ws.sum(axis=1),
                                   rtol=1e-6)


def test_kmeans_plusplus_never_chooses_zero_weight_rows():
    rng = np.random.default_rng(3)
    B, P, d, k = 8, 300, 3, 20
    Xs = rng.normal(size=(B, P, d)).astype(np.float32)
    ws = rng.random((B, P)).astype(np.float32)
    ws[rng.random((B, P)) < 0.4] = 0.0
    # The heaviest zero-weight candidates: far-away rows
    Xs[ws == 0] *= 100.0
    u = torch.stack([km._uniforms(s, k) for s in range(B)])
    centers, index = km._kmeans_pp_batched(_t(Xs), _t(ws), k, u)
    chosen_w = np.take_along_axis(ws, index.numpy(), axis=1)
    assert (chosen_w > 0).all()
    np.testing.assert_array_equal(
        centers.numpy(), np.take_along_axis(Xs, index.numpy()[..., None], axis=1))
    for b in range(B):
        cj = np.asarray(jkm.kmeans_plusplus(jax.random.PRNGKey(b), jnp.asarray(Xs[b]),
                                            jnp.asarray(ws[b]), k))
        live = Xs[b][ws[b] > 0]
        assert all((live == c).all(axis=1).any() for c in cj)


def test_kmeans_plusplus_first_draw_follows_the_weights():
    """2,000 first draws on 5 rows: frequencies match ``w / w.sum()`` by
    chi-square, for the port's generator and for JAX's keys alike."""
    X = np.arange(15, dtype=np.float32).reshape(5, 3)
    w = np.array([0.1, 0.4, 0.2, 0.0, 0.3], np.float32)
    n = 2000
    g = torch.Generator().manual_seed(1234)
    firsts = [int(km.kmeans_plusplus(_t(X), _t(w), 1, g, return_index=True)[1][0])
              for _ in range(n)]
    counts = np.bincount(firsts, minlength=5)
    assert counts[3] == 0
    live = w > 0
    expected = n * w[live] / w.sum()
    assert chisquare(counts[live], expected).pvalue > 1e-3

    keys = jax.random.split(jax.random.PRNGKey(0), n)
    cj = np.asarray(jax.vmap(lambda key: jkm.kmeans_plusplus(
        key, jnp.asarray(X), jnp.asarray(w), 1))(keys))[:, 0, 0]
    counts_j = np.bincount((cj / 3).astype(int), minlength=5)
    assert counts_j[3] == 0
    assert chisquare(counts_j[live], expected).pvalue > 1e-3


def test_kmeans_plusplus_all_duplicates_fall_back_to_the_weights():
    """Every row equal: after the first pick every score is zero, and each
    later pick draws from the base weights again (never a zero-weight
    row), as in JAX."""
    X = np.tile(np.array([[1.0, -2.0, 0.5]], np.float32), (10, 1))
    w = np.array([0, 1, 1, 0, 2, 0, 1, 0, 1, 0], np.float32)
    g = torch.Generator().manual_seed(0)
    centers, index = km.kmeans_plusplus(_t(X), _t(w), 6, g, return_index=True)
    assert (w[index.numpy()] > 0).all()
    assert len(set(index.tolist())) > 1  # fresh draws, not index 0 repeated
    np.testing.assert_array_equal(centers.numpy(), X[:6])
    cj = np.asarray(jkm.kmeans_plusplus(jax.random.PRNGKey(0), jnp.asarray(X),
                                        jnp.asarray(w), 6))
    np.testing.assert_array_equal(cj, centers.numpy())


def test_kmeans_plusplus_same_seed_same_result():
    rng = np.random.default_rng(9)
    X = _t(rng.normal(size=(400, 5)).astype(np.float32))
    w = _t(rng.random(400).astype(np.float32))

    def run(seed):
        return km.kmeans_plusplus(X, w, 12, torch.Generator().manual_seed(seed),
                                  return_index=True)

    (c1, i1), (c2, i2), (_c3, i3) = run(7), run(7), run(8)
    assert torch.equal(i1, i2) and torch.equal(c1, c2)
    assert not torch.equal(i1, i3)
    packed = km.seed_bin(7, X, w, 12)
    np.testing.assert_array_equal(
        packed.numpy(), km.seed_bins_batched([7], X[None], w[None], 12)[0].numpy())
    # JAX: one key, one result
    kj = jax.random.PRNGKey(7)
    a = np.asarray(jkm.kmeans_plusplus(kj, jnp.asarray(X.numpy()), jnp.asarray(w.numpy()), 12))
    b = np.asarray(jkm.kmeans_plusplus(kj, jnp.asarray(X.numpy()), jnp.asarray(w.numpy()), 12))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("minibatch", [False, True], ids=["lloyd", "minibatch"])
def test_kmeans_fit_from_the_same_init_matches_jax(minibatch):
    """``kmeans_fit``: the k-means++ rows it reports, fed to JAX's
    ``lloyd`` (or its minibatch pass), give the port's centers within rtol
    1e-5 and its ids up to near-ties."""
    rng = np.random.default_rng(21)
    n, d, k = 900, 3, 8
    X = _blobs(rng, n, d, 6)
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    centers, ids, init = km.kmeans_fit(X, w, k, seed=4, n_iter=20, minibatch=minibatch,
                                       batch_size=256, return_init=True,
                                       device="cpu")
    Xj, wj, c = jnp.asarray(X), jnp.asarray(w), jnp.asarray(X[init])
    if minibatch:
        counts = jnp.zeros(k, jnp.float32)
        for s in range(0, n, 256):
            idx, _ = jkm.assign_flat(Xj[s:s + 256], c, jnp.ones(k, bool))
            c, counts = jkm.minibatch_update(c, counts, Xj[s:s + 256], wj[s:s + 256], idx)
    else:
        c = jkm.lloyd(Xj, wj, c, n_iter=20)
    np.testing.assert_allclose(centers, np.asarray(c), rtol=1e-5, atol=1e-5)
    ids_j, _ = jkm.assign_flat(Xj, c, jnp.ones(k, bool))
    assert_ids_match(ids, np.asarray(ids_j), X, np.zeros(n, np.int32), centers,
                     np.zeros(k, np.int32), np.ones(k, bool))


def test_partial_fit_device_family_equals_seed_bins_batched(monkeypatch):
    """With ``HOST_BATCH_THRESHOLD`` lowered (as JAX's tests do,
    ``tests/test_review_regressions.py:417-438``), a bin with that many
    members seeds through the device family: its centers and counts equal
    ``seed_bin`` on its members, ``valid``/``initialized`` follow, the
    snapshot rule keeps the seeding batch from updating it again, and ids
    come from that bank. The host-family bin equals JAX's bitwise."""
    thr = 64
    monkeypatch.setattr("msm_we_tpu_torch.ops.stratified.HOST_BATCH_THRESHOLD", thr)
    monkeypatch.setattr("msm_we_tpu.ops.stratified.HOST_BATCH_THRESHOLD", thr)
    rng = np.random.default_rng(4)
    n_bins, k, d, seed = 4, 5, 3, 2
    sizes = {0: 150, 1: 40, 2: 3, 3: 90}  # device, host, unseeded, device
    bins = np.concatenate([np.full(m, b) for b, m in sizes.items()])
    rng.shuffle(bins)
    X = _blobs(rng, len(bins), d, 7)
    w = rng.uniform(0.1, 1.0, len(bins)).astype(np.float32)

    s = StratifiedKmeans(n_bins, k, d, seed=seed, device="cpu")
    j = JaxStrat(n_bins, k, d, seed=seed)
    assert s.partial_fit(X, bins, weights=w) == j.partial_fit(X, bins, weights=w) == {0, 1, 3}
    assert s.seeded_by_family == {"host": 1, "device": 2}
    np.testing.assert_array_equal(s.initialized, [True, True, False, True])
    np.testing.assert_array_equal(s.initialized, j.initialized)
    np.testing.assert_array_equal(s.valid, j.valid)
    for b in (0, 3):
        m = np.flatnonzero(bins == b)
        packed = km.seed_bin(seed + b, _t(X[m]), _t(w[m]), k).numpy()
        rows = slice(b * k, (b + 1) * k)
        np.testing.assert_array_equal(s.centers[rows], packed[:, :-1])
        np.testing.assert_array_equal(s.counts[rows], packed[:, -1])
        # Counted once: the weight of the members, in both packages
        np.testing.assert_allclose(s.counts[rows].sum(), w[m].sum(), rtol=1e-5)
        np.testing.assert_allclose(j.counts[rows].sum(), w[m].sum(), rtol=1e-5)
    rows = slice(k, 2 * k)
    np.testing.assert_array_equal(s.centers[rows], j.centers[rows])
    np.testing.assert_array_equal(s.counts[rows], j.counts[rows])

    Xq = _blobs(rng, 200, d, 7)
    bq = rng.choice([0, 1, 3], 200)
    ids = s.predict(Xq, bq)
    bank = s.compact_bank()
    flat = np.asarray(km.masked_assign(_t(Xq), _t(bq.astype(np.int32)), _t(bank[0]),
                                       _t(bank[1]), _t(bank[2])))
    np.testing.assert_array_equal(ids, flat)


def test_build_seeds_through_the_device_family(monkeypatch):
    """A default build whose bins seed from at least ``HOST_BATCH_THRESHOLD``
    members (lowered here, as in JAX's tests) on a run stacked from two
    replicas seeds them through the device family and reproduces itself
    bitwise, validation models included."""
    from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
    from msm_we_tpu_torch.data import generate_we_replicas

    monkeypatch.setattr("msm_we_tpu_torch.ops.stratified.HOST_BATCH_THRESHOLD", 6)
    data = generate_we_replicas(12, 48, 2, seed=17)
    builds = []
    for _ in range(2):
        m = modelWE(device="cpu")
        m.build_analyze_model(
            file_paths=ArrayWEDataset(data),
            ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
            modelName="wide", basis_pcoord_bounds=[[9.0, 10.0]],
            target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
            n_clusters=4, show_live_display=False,
            step_kwargs={"clustering": {
                "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
                "scan_small_batches": True}},
        )
        builds.append(m)
    a, b = builds
    assert a._strat.seeded_by_family["device"] > 0
    np.testing.assert_array_equal(np.concatenate(a.dtrajs), np.concatenate(b.dtrajs))
    assert a.JtargetSS == b.JtargetSS > 0
    assert [v.JtargetSS for v in a.validation_models] == [
        v.JtargetSS for v in b.validation_models]


def test_stacked_replicas_are_one_continuous_run():
    """``generate_we_replicas``: each replica's block is that seed's run of
    the generator (held to the JAX generator in test_torch_build.py),
    parent ids point into the replica's block, weights sum to 1, and the
    worker processes give the serial result."""
    from msm_we_tpu.data.synthetic import SynthWESettings as JaxSettings
    from msm_we_tpu.data.synthetic import generate_trajectory_arrays as jax_generate
    from msm_we_tpu_torch import ArrayWEDataset
    from msm_we_tpu_torch.data import generate_we_replicas

    serial = generate_we_replicas(4, 20, 3, seed=5, warmup=2)
    parallel = generate_we_replicas(4, 20, 3, seed=5, warmup=2, processes=2)
    for a, b in zip(serial, parallel):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for r in range(3):
        ref = jax_generate(JaxSettings(n_iterations=5, n_segments=20, seed=5 + r,
                                       warmup=2))
        for it, d in enumerate(serial):
            block = slice(20 * r, 20 * (r + 1))
            np.testing.assert_array_equal(d["coords"][block], ref[it]["coords"])
            np.testing.assert_array_equal(d["weights"][block], ref[it]["weights"] / 3)
    ds = ArrayWEDataset(serial)
    assert ds.check_continuity(sample_per_iter=60, full_iters=5)
    for d in serial:
        assert d["weights"].sum() == pytest.approx(1.0, abs=1e-12)
