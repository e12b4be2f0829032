"""The port's hot step (``msm_we_tpu_torch.step`` / ``.entry``) against the
JAX package's: ``entry()`` against ``__graft_entry__.entry()``, ``hot_step``
against ``bench.device_pipeline`` at a reduced ``make_problem``, the f32
steady state, the override orders, and the streaming clustering scan."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msm_we_tpu.ops import kmeans as jkm
from msm_we_tpu.parallel import sharded as jsh
from msm_we_tpu_torch import entry as tentry
from msm_we_tpu_torch import step as tstep
from msm_we_tpu_torch.entry import (
    TIERS,
    _hot_step,
    _two_transform,
    entry,
    grouped_route,
    hot_step,
    stage_problem,
)
from msm_we_tpu_torch.ops import kmeans as tkm
from msm_we_tpu_torch.ops.stratified_assign import transform_assign_plain
from msm_we_tpu_torch.testing import make_problem

from _torch_parity import assert_ids_match, np_, tt

torch.set_num_threads(1)

_HI = jax.lax.Precision.HIGHEST


def test_entry_matches_graft_entry():
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    jfm, jpss, jflux, jres = (np.asarray(o) for o in jax.jit(jfn)(*jargs))
    fn, args = entry("cpu")
    fm, pss, flux, res = fn(*args)
    # Dyadic weights: the flux matrix is exact in any summation order
    np.testing.assert_array_equal(np_(fm), jfm)
    np.testing.assert_allclose(np_(pss), jpss, rtol=1e-5, atol=1e-7)
    assert float(flux) == pytest.approx(float(jflux), rel=1e-5)
    assert float(res) < 1e-5 and float(jres) < 1e-5


@pytest.fixture(scope="module")
def small_problem():
    return make_problem(n_segments=4096, n_raw_features=64, n_components=8,
                        n_bins=10, k_per_bin=5, seed=3)


def _jax_ids(p, dedup):
    """Production ids of the bench step: features = raw @ comp - mean @ comp
    (the dedup tier gathers the parents from the extended child array)."""
    offset = p["mean"] @ p["comp"]
    fc = jnp.matmul(p["raw_child"], p["comp"], precision=_HI) - offset
    if dedup:
        n = len(p["raw_child"])
        rows = p["parent_rows"].copy()
        rows[p["fb_idx"]] = n + np.arange(len(p["fb_idx"]))
        ext = np.concatenate([p["raw_child"], p["raw_fallback"]])
        fp = (jnp.matmul(ext, p["comp"], precision=_HI) - offset)[rows]
    else:
        fp = jnp.matmul(p["raw_parent"], p["comp"], precision=_HI) - offset
    fm, pidx, cidx = jsh.fused_step_single(
        fp, fc, p["pbins"], p["cbins"], p["basis_p"], p["basis_c"],
        p["target_c"], p["w"], p["centers"], p["center_bin"], p["valid"],
        p["n_states"], n_bins=int(p["center_bin"].max()) + 1,
    )
    return np.asarray(fp), np.asarray(fc), np.asarray(fm), np.asarray(pidx), np.asarray(cidx)


@pytest.mark.parametrize("tier", TIERS)
def test_hot_step_matches_bench_device_pipeline(small_problem, tier):
    import bench

    p = small_problem
    dedup = tier == "dedup"
    step, args = bench.device_pipeline(p, dedup=dedup)
    jfm, jpss, jflux, jres = (np.asarray(o) for o in step(*args))
    fp, fc, _fm, jp, jc = _jax_ids(p, dedup)

    out = hot_step(p, tier, "cpu")
    K = len(p["centers"])
    bank = (p["centers"], p["center_bin"], p["valid"])
    n = assert_ids_match(out["pidx"], jp, fp, p["pbins"], *bank, n_regular=K)
    n += assert_ids_match(out["cidx"], jc, fc, p["cbins"], *bank, n_regular=K)
    if n == 0:
        # f32 weights summed in another order: f32 rounding of the cell sums
        np.testing.assert_allclose(np_(out["fm"]), jfm, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(np_(out["pss"]), jpss, rtol=1e-3, atol=1e-6)
        assert float(out["flux"]) == pytest.approx(float(jflux), rel=1e-3)
    assert float(out["residual"]) < 1e-5


@pytest.fixture(scope="module")
def wide_problem():
    """``make_problem`` binned 128 wide (the ``ntl9_100k.bins128`` cell's
    widths, raw 900 -> 30) cut to 4,096 segments, with dyadic weights so
    that every flux cell sum is exact in any order."""
    p = make_problem(n_segments=4096, n_bins=128, seed=3)
    p["w"] = np.random.default_rng(5).integers(1, 17, 4096) / 16.0
    return p


@pytest.mark.parametrize("n_bins,k,valid_bins,grouped", [
    (10, 25, None, True), (128, 25, None, True), (6, 25, None, False),
    (1, 3200, None, False), (128, 25, 4, False)],
    ids=["bins10", "bins128", "bins6", "one_bin", "bins128_4_valid"])
def test_grouped_route_follows_the_bank(n_bins, k, valid_bins, grouped):
    """The route rule counts the valid centers and the bins that hold them:
    the bins10 and bins128 cells' banks take the grouped route, 6 bins of
    25 (the sweep's last point below ``GROUPED_MIN_OFF_BIN``) and one bin of
    3,200 centers do not, nor a wide bank whose valid centers lie in 4
    bins."""
    center_bin = np.repeat(np.arange(n_bins, dtype=np.int32), k)
    valid = (np.ones(len(center_bin), bool) if valid_bins is None
             else center_bin < valid_bins)
    assert grouped_route(center_bin, valid) is grouped
    assert grouped_route(tt(center_bin), tt(valid)) is grouped


def test_stage_problem_records_the_route(small_problem, wide_problem):
    assert stage_problem(small_problem, "two_transform", "cpu")["grouped"] is False
    assert stage_problem(wide_problem, "two_transform", "cpu")["grouped"] is True
    assert "grouped" not in stage_problem(wide_problem, "dedup", "cpu")


def _without_tail(monkeypatch):
    """Leave the steady-state tail out of ``_hot_step`` (at 3,202 states:
    minutes on one thread)."""
    monkeypatch.setattr(tentry, "steady_state_from_flux",
                        lambda fm, basis, target: (None,) * 4)


def test_grouped_route_equals_plain_h2(wide_problem, monkeypatch):
    """The 128-bin step's composed route (features-only transforms, then H3
    on ``c2adj``) against plain H2 on the same raw rows: equal ids, and the
    same flux with dyadic weights."""
    p = wide_problem
    s = stage_problem(p, "two_transform", "cpu")
    pidx, cidx, fm = _two_transform(s, True)
    ref = transform_assign_plain(
        s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"], s["w"],
        s["basis_p"], s["basis_c"], s["target_c"], s["mean"], s["comp"],
        s["centers"], s["center_bin"], s["valid"], s["n_states"])
    assert torch.equal(pidx, ref[0]) and torch.equal(cidx, ref[1])
    assert torch.equal(fm, ref[2])
    # The step takes it (the 3,202-state tail left out: minutes on one thread)
    _without_tail(monkeypatch)
    out = _hot_step(s, "two_transform")
    assert torch.equal(out["pidx"], pidx) and torch.equal(out["cidx"], cidx)
    assert torch.equal(out["fm"], fm)


def test_grouped_step_matches_jax_production_step(wide_problem, monkeypatch):
    """The comparison above on the 128-bin problem, whose step takes the
    bin-grouped route: ids against the JAX production step's up to
    near-ties, and its flux with dyadic weights (the 3,202-state tail is
    left out: minutes on one thread; the f64 tail has tests of its own)."""
    p = wide_problem
    s = stage_problem(p, "two_transform", "cpu")
    assert s["grouped"]
    fp, fc, jfm, jp, jc = _jax_ids(p, dedup=False)
    _without_tail(monkeypatch)
    out = _hot_step(s, "two_transform")
    K = len(p["centers"])
    bank = (p["centers"], p["center_bin"], p["valid"])
    n = assert_ids_match(out["pidx"], jp, fp, p["pbins"], *bank, n_regular=K)
    n += assert_ids_match(out["cidx"], jc, fc, p["cbins"], *bank, n_regular=K)
    if n == 0:
        np.testing.assert_array_equal(np_(out["fm"]), jfm)


def test_hot_step_accepts_a_staged_problem(small_problem):
    staged = stage_problem(small_problem, "dedup", "cpu")
    a = hot_step(staged, "dedup")
    b = hot_step(small_problem, "dedup", "cpu")
    assert torch.equal(a["fm"], b["fm"])
    with pytest.raises(ValueError):
        hot_step(staged, "two_transform")


def _flux_matrices():
    rng = np.random.default_rng(0)
    dense = (rng.random((12, 12)) * (rng.random((12, 12)) < 0.5)).astype(np.float32)
    # Disconnected: a block no flux enters, and an all-zero row
    disc = dense.copy()
    disc[:4, 4:] = 0.0
    disc[4:, :4] = 0.0
    disc[6] = 0.0
    tiny = dense * np.float32(1e-32)  # outflux below the old 1e-30 clamp
    return {"random": dense, "disconnected": disc, "tiny": tiny}


@pytest.mark.parametrize("name", ["random", "disconnected", "tiny"])
def test_steady_state_from_flux_matches_jax(name):
    fm = _flux_matrices()[name]
    S = fm.shape[0]
    basis = np.arange(S) == S - 2
    target = np.arange(S) == S - 1
    jT, jp, jflux, jres = (np.asarray(o) for o in jsh.steady_state_from_flux(
        fm, basis, target))
    T, p, flux, res = tstep.steady_state_from_flux(tt(fm), tt(basis), tt(target))
    np.testing.assert_allclose(np_(T), jT, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np_(p), jp, rtol=1e-4, atol=1e-6)
    assert float(flux) == pytest.approx(float(jflux), rel=1e-4, abs=1e-7)
    assert np.isfinite(float(res))
    # Row-stochastic transition matrix, exact divisor
    np.testing.assert_allclose(np_(T).sum(1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("predict_order", [False, True])
def test_apply_overrides_matches_jax(predict_order):
    rng = np.random.default_rng(1)
    n, S = 300, 20
    pidx = rng.integers(0, S - 2, n).astype(np.int32)
    cidx = rng.integers(0, S - 2, n).astype(np.int32)
    masks = {k: rng.random(n) < 0.3 for k in ("bp", "bc", "tc", "tp")}
    jp, jc = jsh._apply_overrides(pidx, cidx, masks["bp"], masks["bc"], masks["tc"],
                                  S, target_p=masks["tp"], predict_order=predict_order)
    tp_, tc_ = tstep._apply_overrides(
        tt(pidx), tt(cidx), tt(masks["bp"]), tt(masks["bc"]), tt(masks["tc"]), S,
        target_p=tt(masks["tp"]), predict_order=predict_order,
    )
    np.testing.assert_array_equal(np_(tp_), np.asarray(jp))
    np.testing.assert_array_equal(np_(tc_), np.asarray(jc))


def _scan_inputs(seed=4):
    rng = np.random.default_rng(seed)
    n_bins, k, d, N = 4, 3, 5, 600
    centers = rng.normal(size=(n_bins * k, d)).astype(np.float32)
    counts = rng.integers(1, 5, n_bins * k).astype(np.float32)
    X = rng.normal(size=(N, d)).astype(np.float32)
    eff = rng.integers(-1, n_bins, N).astype(np.int32)
    init = np.array([True, True, False, True])
    starts = np.array([0, 150, 150, 420])
    lengths = np.array([150, 0, 270, 180])
    return dict(centers=centers, counts=counts, X=X, eff=eff, init=init,
                starts=starts, lengths=lengths,
                center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k),
                valid=rng.random(n_bins * k) < 0.9, n_bins=n_bins)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_minibatch_scan_equals_per_batch_sequence(weighted):
    s = _scan_inputs()
    w = np.random.default_rng(9).random(len(s["X"])).astype(np.float32)
    c, n = tkm.masked_minibatch_scan(
        tt(s["centers"]), tt(s["counts"]), tt(s["X"]), tt(s["eff"]),
        tt(w) if weighted else None, tt(s["init"]), s["starts"], s["lengths"],
        tt(s["center_bin"]), tt(s["valid"]),
    )
    cs, ns = tt(s["centers"]), tt(s["counts"])
    for lo, ln in zip(s["starts"], s["lengths"]):
        rows = np.arange(lo, lo + ln)
        b = s["eff"][rows]
        live = rows[(b >= 0) & s["init"][np.maximum(b, 0)]]
        if not len(live):
            continue
        cs, ns = tkm.masked_minibatch_step(
            cs, ns, tt(s["X"][live]),
            tt(w[live]) if weighted else torch.ones(len(live)),
            tt(s["eff"][live]), tt(s["center_bin"]), tt(s["valid"]),
        )
    assert torch.equal(c, cs) and torch.equal(n, ns)


def test_masked_minibatch_scan_matches_jax_with_injected_centers():
    s = _scan_inputs(seed=6)
    window = 512
    jc, jn = jkm.masked_minibatch_scan(
        jnp.asarray(s["centers"]), jnp.asarray(s["counts"]), jnp.asarray(s["X"]),
        jnp.asarray(s["eff"]), None, jnp.asarray(s["init"]),
        jnp.asarray(s["starts"].astype(np.int32)),
        jnp.asarray(s["lengths"].astype(np.int32)),
        jnp.asarray(s["center_bin"]), jnp.asarray(s["valid"]),
        n_bins=s["n_bins"], window=window,
    )
    c, n = tkm.masked_minibatch_scan(
        tt(s["centers"]), tt(s["counts"]), tt(s["X"]), tt(s["eff"]), None,
        tt(s["init"]), s["starts"], s["lengths"], tt(s["center_bin"]),
        tt(s["valid"]),
    )
    np.testing.assert_array_equal(np_(n), np.asarray(jn))
    # Same assignments and the same update; the f32 sums may round in
    # another order (XLA's segment sum vs index_add_)
    np.testing.assert_allclose(np_(c), np.asarray(jc), rtol=2e-6, atol=1e-6)


def test_masked_assign_and_minibatch_update_match_jax():
    s = _scan_inputs(seed=2)
    rows = s["eff"] >= 0
    X, b = s["X"][rows], s["eff"][rows]
    ref = np.asarray(jkm.masked_assign(X, b, s["centers"], s["center_bin"],
                                       s["valid"], n_bins=s["n_bins"]))
    idx = tkm.masked_assign(tt(X), tt(b), tt(s["centers"]), tt(s["center_bin"]),
                            tt(s["valid"]))
    assert_ids_match(idx, ref, X, b, s["centers"], s["center_bin"], s["valid"])
    w = np.linspace(0.1, 1.0, len(X)).astype(np.float32)
    jc, jn = jkm.minibatch_update(s["centers"], s["counts"], X, w, ref)
    c, n = tkm.minibatch_update(tt(s["centers"]), tt(s["counts"]), tt(X), tt(w),
                                tt(ref))
    np.testing.assert_allclose(np_(c), np.asarray(jc), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(np_(n), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(
        np_(tkm.pairwise_dist2(tt(X), tt(s["centers"]))),
        np.asarray(jkm.pairwise_dist2(X, s["centers"])), rtol=1e-5, atol=1e-4,
    )
