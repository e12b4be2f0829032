#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``msm_we_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,main,analysis] [--out DIR]

Phases, each printing one JSON line:

1. ``device``: the card's name, count and power limit (a GPU is required).
2. ``build``: compile the kernel library from ``msm_we_tpu_torch/csrc``.
3. ``kernels``: every kernel against its plain PyTorch version on the same
   device tensors at the main path's shapes (``make_problem()``: 102,400
   segments, raw 900 -> 30 features, 250 centers; plus 3,200 centers over
   128 bins). Ids must agree except at near-ties, dyadic f64 flux bitwise.
   Median times of kernel and plain version from CUDA events.
4. ``main``: the main path with every launch count reset first --
   ``hot_step`` in both tiers and ``entry()`` at full size, then the haMSM
   build (``modelWE.build_analyze_model``) on a 101 x 1,000 synthetic WE
   run generated in memory. Every kernel must have launched. Then the
   results are checked against references: the hot step on a reduced
   problem against its CPU run, and a reduced build on the GPU against the
   same build on the CPU.
5. ``analysis``: the default build (block cross-validation, predict route)
   at 101 x 10,000 segments with every launch count reset first; H4 must
   have launched. Then the analysis on that model (committors, flux
   profiles, implied timescales, CK test, bootstrap, lagged flux), the
   default build on the GPU against the CPU at 30 x 200 (and two GPU
   builds bitwise equal), and both f64 FPT device engines against the
   host engines (1,000 states) and alone (2,500 states).

The line before the last is the ``{"kernels": [...]}`` summary and the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is not 0. Without a CUDA device the script exits with code 2
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "main", "analysis")

KERNEL_INFO = {
    "transform_assign_child": dict(
        pallas="H1", replaces="msm_we_tpu/ops/pallas_kernels.py:546"),
    "transform_assign": dict(
        pallas="H2", replaces="msm_we_tpu/ops/pallas_kernels.py:377"),
    "assign_flux": dict(
        pallas="H3", replaces="msm_we_tpu/ops/pallas_kernels.py:248"),
    "pair_assign": dict(
        pallas="H4", replaces="msm_we_tpu/ops/pallas_kernels.py:203"),
}
SOURCE = "msm_we_tpu_torch/csrc/stratified_assign.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


class Failure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise Failure(msg)


def nvidia_smi():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
        "nvidia-smi gave no output"
    )


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each bracketed by
    CUDA events (after ``warmup`` untimed runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------- kernels


def _compare_ids(name, regime, ids_k, ids_p, n_states, X, bins, bank,
                 c2=None, raw=None, proj=None):
    """Mismatching ids must be near-ties between two regular centers."""
    import numpy as np

    from msm_we_tpu_torch.testing import near_tie_rows

    import torch

    ik = ids_k.cpu().numpy()
    ip = ids_p.cpu().numpy()
    bad = np.flatnonzero(ik != ip)
    K = bank[0].shape[0]
    n_ties = 0
    if len(bad):
        require(((ik[bad] < K) & (ip[bad] < K)).all() and ik[bad].max() < n_states - 2,
                f"{name} [{regime}]: override ids disagree")
        host_bank = [t.cpu().numpy() for t in bank]
        local = np.arange(len(bad))
        rows = torch.as_tensor(bad, device=bins.device)
        if raw is not None:
            # Only the disagreeing raw rows come to the host
            ties = near_tie_rows(
                local, ik[bad], ip[bad], None, bins.cpu().numpy()[bad],
                *host_bank, c2=c2.cpu().numpy(), raw=raw[rows].cpu().numpy(),
                proj=proj.cpu().numpy(),
            )
        else:
            ties = near_tie_rows(
                local, ik[bad], ip[bad], X[rows].cpu().numpy(),
                bins.cpu().numpy()[bad], *host_bank,
            )
        n_ties = int(ties.sum())
    require(n_ties == len(bad),
            f"{name} [{regime}]: {len(bad) - n_ties} id mismatches are not near-ties")
    return len(bad), n_ties


def phase_kernels(args, summary):
    import numpy as np
    import torch

    from msm_we_tpu_torch.entry import stage_problem
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.step import _scatter_flux
    from msm_we_tpu_torch.testing import make_problem

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    prob = make_problem()
    s = stage_problem(prob, "two_transform", dev)
    setup_s = time.perf_counter() - t0
    N, D = s["raw_child"].shape
    F = s["comp"].shape[1]
    S = s["n_states"]
    bank = (s["centers"], s["center_bin"], s["valid"])
    rng = np.random.default_rng(5)
    # Dyadic f64 weights: every cell sum is exact in any order
    w64 = torch.as_tensor(rng.integers(1, 17, N) / 16.0, device=dev)
    reps = args.reps

    def record(name, regime, ms, plain_ms, err, mism, ties, flux_ok=None,
               K=None):
        line = dict(phase="kernel", name=name, pallas=KERNEL_INFO[name]["pallas"],
                    regime=regime, n=int(N), K=int(K or bank[0].shape[0]),
                    ms=ms, plain_ms=plain_ms, max_abs_err=err,
                    id_mismatches=mism, near_ties=ties)
        if flux_ok is not None:
            line["flux_bitwise"] = flux_ok
        emit(line)
        if regime == "K=250":  # the main path's bank for the summary line
            summary[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)

    a2 = sa.c2adj(s["mean"], s["comp"], s["centers"])

    # H1: child rows, raw -> features -> ids (+ features)
    idx_k, g_k = sa.transform_assign_child(
        s["raw_child"], s["cbins"], None, None, s["mean"], s["comp"], *bank, S,
        emit_features=True)
    idx_p, g_p = sa.transform_assign_child_plain(
        s["raw_child"], s["cbins"], None, None, s["mean"], s["comp"], *bank, S,
        emit_features=True)
    torch.cuda.synchronize()
    mism, ties = _compare_ids("transform_assign_child", "K=250", idx_k, idx_p,
                              S, None, s["cbins"], bank, c2=a2,
                              raw=s["raw_child"], proj=s["comp"])
    err = float((g_k - g_p).abs().max())
    require(err <= 1e-4 * float(g_p.abs().max()),
            f"H1 features differ by {err}")
    ms = cuda_ms(lambda: sa.transform_assign_child(
        s["raw_child"], s["cbins"], s["basis_c"], s["target_c"], s["mean"],
        s["comp"], *bank, S, emit_features=True), reps)
    pms = cuda_ms(lambda: sa.transform_assign_child_plain(
        s["raw_child"], s["cbins"], s["basis_c"], s["target_c"], s["mean"],
        s["comp"], *bank, S, emit_features=True), reps)
    record("transform_assign_child", "K=250", ms, pms, err, mism, ties)

    # H2: both raw sets, flux-order overrides, f64 dyadic flux
    args2 = (s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"])
    ovr2 = (s["basis_p"], s["basis_c"], s["target_c"], s["mean"], s["comp"],
            *bank, S)
    pk, ck, fk = sa.transform_assign(*args2, w64, *ovr2)
    pp, cp, fpl = sa.transform_assign_plain(*args2, w64, *ovr2)
    # Raw ids (no overrides) for the near-tie check
    basis_none = torch.zeros(N, dtype=torch.bool, device=dev)
    rk = sa.transform_assign(*args2, None, basis_none, basis_none, basis_none,
                             s["mean"], s["comp"], *bank, S, with_flux=False)
    rp = sa.transform_assign_plain(*args2, None, basis_none, basis_none,
                                   basis_none, s["mean"], s["comp"], *bank, S,
                                   with_flux=False)
    torch.cuda.synchronize()
    m1, t1 = _compare_ids("transform_assign", "K=250", rk[0], rp[0], S, None,
                          s["pbins"], bank, c2=a2, raw=s["raw_parent"],
                          proj=s["comp"])
    m2, t2 = _compare_ids("transform_assign", "K=250", rk[1], rp[1], S, None,
                          s["cbins"], bank, c2=a2, raw=s["raw_child"],
                          proj=s["comp"])
    own = _scatter_flux(pk, ck, w64, S)
    flux_ok = bool(torch.equal(fk, own)) and (
        (m1 + m2) > 0 or bool(torch.equal(fk, fpl)))
    require(flux_ok, "H2 dyadic f64 flux is not bitwise equal")
    err = float((fk - fpl).abs().max())
    ms = cuda_ms(lambda: sa.transform_assign(*args2, s["w"], *ovr2), reps)
    pms = cuda_ms(lambda: sa.transform_assign_plain(*args2, s["w"], *ovr2), reps)
    record("transform_assign", "K=250", ms, pms, err, m1 + m2, t1 + t2, flux_ok)

    # H3 / H4 on features: the main path's K=250 bank, and a wide bank
    # (128 bins x 25 = 3,200 centers: K tiling, > 64 bins)
    off = s["mean"] @ s["comp"]
    fp = (s["raw_parent"] @ s["comp"] - off).contiguous()
    fc = (s["raw_child"] @ s["comp"] - off).contiguous()
    del s["raw_parent"]
    n_wide = 128
    bins_p_w = torch.as_tensor(rng.integers(0, n_wide, N).astype(np.int32),
                               device=dev)
    bins_c_w = torch.as_tensor(rng.integers(0, n_wide, N).astype(np.int32),
                               device=dev)
    pick = np.concatenate([
        rng.choice(np.flatnonzero(bins_c_w.cpu().numpy() == b), 25,
                   replace=False)
        for b in range(n_wide)
    ])
    centers_w = (fc[torch.as_tensor(pick, device=dev)]
                 + 0.01 * torch.randn(len(pick), F, device=dev,
                                      generator=torch.Generator(dev).manual_seed(7))
                 ).contiguous()
    bank_w = (centers_w,
              torch.as_tensor(np.repeat(np.arange(n_wide, dtype=np.int32), 25),
                              device=dev),
              torch.ones(len(pick), dtype=torch.bool, device=dev))
    S_w = len(pick) + 2
    regimes = [("K=250", s["pbins"], s["cbins"], bank, S),
               ("K=3200,bins=128", bins_p_w, bins_c_w, bank_w, S_w)]
    ovr = (s["basis_p"], s["basis_c"], s["target_c"])
    for regime, pb, cb, bk, SS in regimes:
        pk, ck, fk = sa.assign_flux(fp, fc, pb, cb, w64, *ovr, *bk, SS)
        _pp, _cp, fpl = sa.assign_flux_plain(fp, fc, pb, cb, w64, *ovr, *bk, SS)
        rk = sa.pair_assign(fp, fc, pb, cb, *bk)
        rp = sa.pair_assign_plain(fp, fc, pb, cb, *bk)
        torch.cuda.synchronize()
        m1, t1 = _compare_ids("pair_assign", regime, rk[0], rp[0], SS, fp, pb, bk)
        m2, t2 = _compare_ids("pair_assign", regime, rk[1], rp[1], SS, fc, cb, bk)
        own = _scatter_flux(pk, ck, w64, SS)
        flux_ok = bool(torch.equal(fk, own)) and (
            (m1 + m2) > 0 or bool(torch.equal(fk, fpl)))
        require(flux_ok, f"H3 [{regime}] dyadic f64 flux is not bitwise equal")
        # Raw ids from the flux kernel must be the H4 ids (same scoring)
        err = float((fk - fpl).abs().max())
        ms = cuda_ms(lambda: sa.assign_flux(fp, fc, pb, cb, s["w"], *ovr, *bk,
                                            SS), reps)
        pms = cuda_ms(lambda: sa.assign_flux_plain(fp, fc, pb, cb, s["w"], *ovr,
                                                   *bk, SS), reps)
        record("assign_flux", regime, ms, pms, err, m1 + m2, t1 + t2, flux_ok,
               K=bk[0].shape[0])

        # H4 with the predict-order epilogue, as the build discretizes
        kw = dict(n_states=SS, basis_p=s["basis_p"], basis_c=s["basis_c"],
                  target_c=s["target_c"], order="predict")
        ms = cuda_ms(lambda: sa.pair_assign(fp, fc, pb, cb, *bk, **kw), reps)
        pms = cuda_ms(lambda: sa.pair_assign_plain(fp, fc, pb, cb, *bk, **kw),
                      reps)
        # Score gap (f64) between the kernel's and the plain version's
        # chosen centers: 0 when every id agrees
        gap = _score_gap(fc, bk, rk[1], rp[1])
        record("pair_assign", regime, ms, pms, gap, m1 + m2, t1 + t2,
               K=bk[0].shape[0])
    emit(dict(phase="kernels", setup_s=setup_s, reps=reps))


def _score_gap(X, bank, ids_a, ids_b):
    """Largest f64 score difference between the centers two assignments
    chose (0 when every id agrees)."""
    C = bank[0].double()
    x = X.double()
    c2 = (C * C).sum(1)
    s_a = c2[ids_a.long()] - 2.0 * (x * C[ids_a.long()]).sum(1)
    s_b = c2[ids_b.long()] - 2.0 * (x * C[ids_b.long()]).sum(1)
    return float((s_a - s_b).abs().max()) if len(x) else 0.0


# ------------------------------------------------------------------ main


def _hot_step_ref_check():
    """The hot step on a reduced problem: CUDA kernels against the plain
    CPU run of the same function."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.entry import TIERS, hot_step
    from msm_we_tpu_torch.testing import make_problem

    p = make_problem(n_segments=4096, n_raw_features=64, n_components=8,
                     n_bins=10, k_per_bin=5, seed=3)
    out = {}
    for tier in TIERS:
        g = hot_step(p, tier, "cuda")
        c = hot_step(p, tier, "cpu")
        pm = (g["pidx"].cpu().numpy() != c["pidx"].numpy()).sum()
        cm = (g["cidx"].cpu().numpy() != c["cidx"].numpy()).sum()
        fm_g = g["fm"].cpu().double().numpy()
        fm_c = c["fm"].double().numpy()
        rel = float(np.abs(fm_g - fm_c).max() / max(np.abs(fm_c).max(), 1e-30))
        require(np.isfinite(fm_g).all(), f"hot step [{tier}] flux not finite")
        if pm + cm == 0:
            require(rel <= 1e-5, f"hot step [{tier}] flux differs from CPU by {rel}")
            require(abs(float(g["flux"]) - float(c["flux"]))
                    <= 1e-3 * abs(float(c["flux"])) + 1e-12,
                    f"hot step [{tier}] JtargetSS differs from CPU")
        out[tier] = dict(id_mismatches=int(pm + cm), flux_rel_err=rel)
    torch.cuda.synchronize()
    return out


def _build(data, device, scan, n_clusters, quiet=True):
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    model = modelWE(device=device)
    t0 = time.perf_counter()
    model.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="smoke",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca",
        tau=1.0,
        n_clusters=n_clusters,
        cross_validation_groups=0,
        show_live_display=False,
        device_pipeline=True,
        step_kwargs={"clustering": {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
            "scan_small_batches": scan,
        }},
    )
    return time.perf_counter() - t0, model


def _build_parity(data, scan):
    """A reduced build on the GPU against the same build on the CPU. With
    ``scan`` the clustering fill loop sums in f32 in another order on each
    device, so dtraj rows may flip at near-ties; without it both devices
    cluster with the same host numpy updates."""
    import numpy as np

    _t, g = _build(data, "cuda", scan, 25)
    _t, c = _build(data, "cpu", scan, 25)
    dg = np.concatenate(g.dtrajs)
    dc = np.concatenate(c.dtrajs)
    flips = int((dg != dc).sum())
    res = dict(scan_small_batches=scan, rows=int(len(dc)), dtraj_flips=flips,
               clusters_gpu=int(g.fluxMatrix.shape[0]),
               clusters_cpu=int(c.fluxMatrix.shape[0]),
               JtargetSS_gpu=float(g.JtargetSS), JtargetSS_cpu=float(c.JtargetSS))
    if flips == 0:
        np.testing.assert_allclose(g.fluxMatrixRaw, c.fluxMatrixRaw, rtol=1e-12)
        np.testing.assert_allclose(g.fluxMatrix, c.fluxMatrix, rtol=1e-12)
        require(res["clusters_gpu"] == res["clusters_cpu"],
                "cleaned cluster counts differ between GPU and CPU builds")
        np.testing.assert_allclose(g.pSS, c.pSS, rtol=1e-8, atol=1e-15)
        require(abs(g.JtargetSS - c.JtargetSS) <= 1e-6 * abs(c.JtargetSS),
                "JtargetSS differs between GPU and CPU builds")
    else:
        require(flips <= 1e-3 * len(dc), f"{flips} dtraj rows flip GPU vs CPU")
        require(abs(g.JtargetSS - c.JtargetSS) <= 1e-3 * abs(c.JtargetSS),
                "JtargetSS differs between GPU and CPU builds")
    return res


def phase_main(args, summary):
    import numpy as np
    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.entry import TIERS, entry, hot_step, stage_problem
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.testing import make_problem

    dev = torch.device("cuda")
    prob = make_problem()
    N = len(prob["w"])
    staged = {t: stage_problem(prob, t, dev) for t in TIERS}
    del prob
    t0 = time.perf_counter()
    data = generate_we_arrays(n_iterations=101, n_segments=1000, seed=17)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    # ---- the main path, counted
    sa.reset_launch_counts()
    for tier in TIERS:
        out = hot_step(staged[tier], tier)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            out = hot_step(staged[tier], tier)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        times.sort()
        step_s = times[len(times) // 2]
        fm = out["fm"]
        pss_sum = float(out["pss"].sum())
        require(bool(torch.isfinite(fm).all()) and fm.shape == (252, 252),
                f"hot step [{tier}] flux malformed")
        require(abs(pss_sum - 1.0) < 1e-3, f"hot step [{tier}] pSS sums to {pss_sum}")
        emit(dict(phase="hot_step", tier=tier, n_segments=N,
                  step_ms=step_s * 1e3, frames_per_s=N / step_s,
                  ss_residual=float(out["residual"]),
                  JtargetSS=float(out["flux"]), reps=args.reps))
        summary["hot_step_" + tier] = dict(step_ms=step_s * 1e3,
                                           frames_per_s=N / step_s)
    del staged
    fn, eargs = entry("cuda")
    fm, pss, flux, residual = fn(*eargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(pss).all()), "entry() pSS not finite")
    emit(dict(phase="entry", flux_sum=float(fm.sum()), JtargetSS=float(flux),
              ss_residual=float(residual)))

    builds = []
    for _ in range(2):  # cold (first use of every path), then warm
        secs, model = _build(data, "cuda", True, 25)
        builds.append(secs)
    counts = sa.launch_counts()
    emit(dict(phase="launch_counts", **counts))
    require(np.isfinite(model.JtargetSS) and model.JtargetSS > 0,
            f"build JtargetSS = {model.JtargetSS}")
    emit(dict(phase="build", segments=int(sum(len(d) for d in model.dtrajs)),
              iterations=101, seconds_cold=builds[0], seconds_warm=builds[1],
              generate_s=gen_s,
              stages={n: s for n, s, _note in model.stage_timings.stages},
              clusters_before=int(model.fluxMatrixRaw.shape[0]),
              clusters_after=int(model.fluxMatrix.shape[0]),
              JtargetSS=float(model.JtargetSS)))
    for name in sa.KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the main path")
    summary["launches"] = counts
    summary["build_warm_s"] = builds[1]

    # ---- references (not counted)
    emit(dict(phase="hot_step_reference", **_hot_step_ref_check()))
    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    for scan in (False, True):
        emit(dict(phase="build_parity", **_build_parity(small, scan)))


# -------------------------------------------------------------- analysis


def _default_build(data, device, n_clusters=25):
    """``build_analyze_model`` with its defaults (block cross-validation,
    2 groups x 4 blocks; predict route) in the bench configuration."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    model = modelWE(device=device)
    t0 = time.perf_counter()
    model.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="smoke",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca",
        tau=1.0,
        n_clusters=n_clusters,
        show_live_display=False,
        step_kwargs={"clustering": {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
            "scan_small_batches": True,
        }},
    )
    return time.perf_counter() - t0, model


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _check_probability_vector(name, q):
    import numpy as np

    q = np.asarray(q)
    require(np.isfinite(q).all(), f"{name} is not finite")
    require(q.min() >= -1e-9 and q.max() <= 1 + 1e-9,
            f"{name} leaves [0, 1]: [{q.min()}, {q.max()}]")


def _analysis_calls(model):
    """The analysis a user runs on a built model, each timed and checked.
    The lagged flux matrices come last: they leave the model at that lag."""
    import numpy as np

    out = {}
    n = model.n_clusters

    s, _ = _timed(model.get_committor)
    _check_probability_vector("committor", model.q)
    out["get_committor"] = s
    s, _ = _timed(model.get_flux)
    require(np.isfinite(model.J).all(), "flux profile is not finite")
    out["get_flux"] = s
    s, _ = _timed(model.get_flux_committor)
    require(np.isfinite(model.Jq).all(), "committor flux profile is not finite")
    out["get_flux_committor"] = s
    q = model.q.copy()
    s, _ = _timed(lambda: model.get_backwards_committor(conv=1e-5))
    _check_probability_vector("backwards committor", model.qm)
    out["get_backwards_committor"] = s
    model.q = q
    s, (lag_times, ts) = _timed(lambda: model.get_implied_timescales(lags=(0, 1, 2)))
    require(ts.shape == (3, 3) and lag_times.shape == (3,),
            f"implied timescales have shape {ts.shape}")
    out["get_implied_timescales"] = s
    s, ck = _timed(lambda: model.get_ck_test(lags=(0, 1, 2, 3), sets=2))
    require(ck[2].shape == ck[3].shape == (len(ck[1]), 4) and len(ck[1]) >= 1,
            f"CK test has shape {ck[2].shape}")
    out["get_ck_test"] = s
    s, boot = _timed(lambda: model.bootstrap_target_flux(
        n_boot=200, observables=("flux", "pss", "committor")))
    lo, hi = boot["ci"]
    require(np.isfinite([lo, hi]).all() and lo <= hi, f"bootstrap ci {boot['ci']}")
    require(boot["n_failed"] < 200, "every bootstrap replicate failed")
    out["bootstrap_target_flux"] = s
    out["bootstrap_ci"] = [lo, hi]
    out["bootstrap_n_failed"] = boot["n_failed"]
    for lag in (1, 2, 3):
        s, _ = _timed(lambda: model.get_fluxMatrix(lag))
        require(model.fluxMatrixRaw.shape == (n + 2, n + 2),
                f"lag-{lag} flux has shape {model.fluxMatrixRaw.shape}")
        out[f"get_fluxMatrix_lag{lag}"] = s
    return out


def _default_build_parity(data):
    """The default build on the GPU against the same build on the CPU,
    then two GPU builds against each other (the clustering scan's sums run
    in a fixed order, so repeated GPU builds are bitwise equal)."""
    import numpy as np

    _t, g = _default_build(data, "cuda")
    _t, c = _default_build(data, "cpu")
    _t, g2 = _default_build(data, "cuda")
    dg, dc = np.concatenate(g.dtrajs), np.concatenate(c.dtrajs)
    flips = int((dg != dc).sum())
    jv_g = [v.JtargetSS for v in g.validation_models]
    jv_c = [v.JtargetSS for v in c.validation_models]
    res = dict(rows=int(len(dc)), dtraj_flips=flips,
               JtargetSS_gpu=float(g.JtargetSS), JtargetSS_cpu=float(c.JtargetSS),
               validation_JtargetSS_gpu=jv_g, validation_JtargetSS_cpu=jv_c)
    require(np.array_equal(np.concatenate(g2.dtrajs), dg)
            and g2.JtargetSS == g.JtargetSS
            and [v.JtargetSS for v in g2.validation_models] == jv_g,
            "two GPU builds with the clustering scan are not bitwise equal")
    res["gpu_builds_bitwise_equal"] = True
    if flips:
        require(flips <= 1e-3 * len(dc), f"{flips} dtraj rows flip GPU vs CPU")
        require(abs(g.JtargetSS - c.JtargetSS) <= 1e-3 * abs(c.JtargetSS),
                "JtargetSS differs between GPU and CPU builds")
        return res

    def close(a, b, what):
        a, b = np.asarray(a, float), np.asarray(b, float)
        err = float(np.nanmax(np.abs(a - b)) / max(float(np.nanmax(np.abs(b))), 1e-300))
        require(np.array_equal(np.isnan(a), np.isnan(b)) and err <= 1e-8,
                f"{what} differs between GPU and CPU builds by {err}")
        return err

    errs = {"JtargetSS": close(g.JtargetSS, c.JtargetSS, "JtargetSS"),
            "validation_JtargetSS": close(jv_g, jv_c, "validation JtargetSS")}
    for m in (g, c):
        m.get_committor()
    errs["committor"] = close(g.q, c.q, "committor")
    boots = [m.bootstrap_target_flux(n_boot=50)["fluxes"] for m in (g, c)]
    errs["bootstrap_fluxes"] = close(boots[0], boots[1], "bootstrap fluxes")
    for m in (g, c):
        m.get_fluxMatrix(1)
    errs["lag1_flux"] = close(g.fluxMatrixRaw, c.fluxMatrixRaw, "lag-1 flux matrix")
    res["max_rel_err"] = errs
    return res


def _random_metastable(n, seed=1):
    """The FPT test matrix of ``scripts/fpt_perf.py``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = rng.random((n, n)) * 0.02 + np.diag(rng.random(n) * 20 + 1)
    return T / T.sum(axis=1, keepdims=True)


def _rel_err(a, b):
    import numpy as np

    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def _plain_fpt_distribution(T, ini, fin, w, lags, logscale):
    """``MatrixFPT.fpt_distribution``'s result (``lag_time = dt = 1``)
    from a plain per-lag ``torch.linalg.matrix_power`` loop in f64 on the
    card: the target columns merged into ``fin[0]``, the other targets
    dropped (``ini`` lies below them), the density folded by step width."""
    import numpy as np
    import torch

    tm = T.copy()
    tm[:, fin[0]] = tm[:, fin].sum(axis=1)
    keep = [i for i in range(len(tm)) if i not in fin[1:]]
    Tt = torch.as_tensor(tm[np.ix_(keep, keep)], device="cuda")
    F, prev, pdfs = Tt, 0, []
    for lag in lags:
        F = torch.linalg.matrix_power(Tt, int(lag - prev)) @ (F - torch.diag(torch.diag(F)))
        pdfs.append(F[ini, fin[0]])
        prev = lag
    w = np.asarray(w, float)
    density = w @ torch.stack(pdfs, dim=1).cpu().numpy() / w.sum()
    if logscale:
        times, widths = lags, np.diff(np.concatenate([[0], lags]))
    else:
        times, widths = lags + 1, np.ones(len(lags))
    dist = np.column_stack([np.concatenate([[0.0], times]),
                            np.concatenate([[0.0], density * widths])])
    dist[:, 1] /= dist[:, 1].sum()
    return dist


def _fpt_checks():
    """Both f64 device engines of ``msm.fpt`` on the card against the host
    f64 engines at n = 1,000, and alone at n = 2,500 against a plain
    per-lag ``matrix_power`` loop. Each timed device call follows an
    untimed one of the same shape."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.msm import fpt

    def sync_timed(fn):
        torch.cuda.synchronize()
        return _timed(fn)

    schedules = (("linear", dict(max_n_lags=100)),
                 ("logscale", dict(max_n_lags=100, logscale=True,
                                   min_power=1, max_power=4)))
    lines = []
    n = 1000
    T = _random_metastable(n)
    ini, fin, w = [0, 1, 2], [n - 2, n - 1], [0.5, 0.3, 0.2]
    for name, kw in schedules:
        host_s, host = _timed(lambda: fpt.MatrixFPT.fpt_distribution(T, ini, fin, w, **kw))
        fpt.MatrixFPT.fpt_distribution(T, ini, fin, w, engine="device",
                                       device="cuda", **kw)  # first use
        dev_s, dev = sync_timed(lambda: fpt.MatrixFPT.fpt_distribution(
            T, ini, fin, w, engine="device", device="cuda", **kw))
        err = _rel_err(dev[:, 1], host[:, 1])
        require(np.array_equal(dev[:, 0], host[:, 0]) and err <= 1e-10,
                f"fpt_distribution [{name}] device differs from host by {err}")
        lines.append(dict(check="fpt_distribution", n_states=n, schedule=name,
                          host_s=host_s, device_s=dev_s, max_rel_err=err))

    akw = dict(max_steps=400, max_time=1e7)
    host_s, host = _timed(lambda: fpt.MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, **akw))
    fpt.MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, engine="device", device="cuda", **akw)  # first use
    dev_s, dev = sync_timed(lambda: fpt.MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, engine="device", device="cuda", **akw))
    same = dev[2] == host[2] and np.array_equal(dev[3], host[3])
    require(same, "adaptive schedule differs between device and host engines")
    err = float(np.nanmax(np.abs(dev[0] - host[0])))
    require(np.allclose(dev[0], host[0], rtol=1e-8, atol=1e-14),
            f"adaptive probabilities differ by {err}")
    lines.append(dict(check="adaptive_fpt_distribution", n_states=n,
                      host_s=host_s, device_s=dev_s, schedule_equal=True,
                      steps=int(host[2]), max_abs_err=err,
                      mass_host=float(np.nansum(host[0])),
                      mass_device=float(np.nansum(dev[0]))))

    n = 2500
    T = _random_metastable(n)
    ini, fin = [0, 1, 2], [n - 2, n - 1]
    for name, kw in schedules:
        fpt.MatrixFPT.fpt_distribution(T, ini, fin, w, engine="device",
                                       device="cuda", **kw)  # first use
        dev_s, dev = sync_timed(lambda: fpt.MatrixFPT.fpt_distribution(
            T, ini, fin, w, engine="device", device="cuda", **kw))
        lags = (np.logspace(1, 4, 100, dtype=int) if kw.get("logscale")
                else np.arange(0, 100))
        plain_s, plain = sync_timed(lambda: _plain_fpt_distribution(
            T, ini, fin, w, lags, bool(kw.get("logscale"))))
        err = _rel_err(dev[:, 1], plain[:, 1])
        require(np.isfinite(dev).all() and np.array_equal(dev[:, 0], plain[:, 0])
                and err <= 1e-10,
                f"fpt_distribution [{name}] at {n} states differs from the "
                f"matrix_power loop by {err}")
        lines.append(dict(check="fpt_device_only", n_states=n, schedule=name,
                          device_s=dev_s, plain_matrix_power_s=plain_s,
                          max_set_bits=max(int(s).bit_count() for s in
                                           np.diff(np.concatenate([[0], lags]))),
                          max_rel_err_vs_matrix_power=err))
    fpt.MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, engine="device", device="cuda", **akw)  # first use
    ad_s, ad = sync_timed(lambda: fpt.MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, engine="device", device="cuda", **akw))
    mass = float(np.nansum(ad[0]))
    require(mass >= 0.99999, f"adaptive mass captured {mass} < 0.99999")
    lines.append(dict(check="adaptive_fpt_device_only", n_states=n,
                      device_s=ad_s, steps=int(ad[2]), mass=mass))
    return lines


def phase_analysis(args, summary):
    """The default build at 1.01M segments, the analysis on it, parity
    with the CPU at 30 x 200, and the FPT engines."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.ops import stratified_assign as sa

    # ---- (c) parity first: it also warms CUDA and the kernel library
    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    emit(dict(phase="analysis_parity", **_default_build_parity(small)))

    # ---- (a) the default build at 1.01M segments, counted
    t0 = time.perf_counter()
    data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
    emit(dict(phase="analysis_data", iterations=101, segments_per_iteration=10_000,
              generate_s=time.perf_counter() - t0))
    # A cold build (first use of every path at this size), then the warm,
    # counted one
    cold_s, model = _default_build(data, "cuda")
    del model
    torch.cuda.synchronize()
    sa.reset_launch_counts()
    secs, model = _default_build(data, "cuda")
    torch.cuda.synchronize()
    counts = sa.launch_counts()
    del data
    names = [n for n, _s, _note in model.stage_timings.stages]
    jv = [float(v.JtargetSS) for v in model.validation_models]
    require(counts["pair_assign"] > 0, "pair_assign never launched in the default build")
    require(len(jv) == 2 and all(np.isfinite(jv)) and min(jv) > 0,
            f"validation JtargetSS {jv}")
    require(names[-1] == "Cross-validation", f"stages end with {names[-1]}")
    require(np.isfinite(model.JtargetSS) and model.JtargetSS > 0,
            f"build JtargetSS = {model.JtargetSS}")
    emit(dict(phase="analysis_build", segments=int(sum(len(d) for d in model.dtrajs)),
              seconds_cold=cold_s, seconds_warm=secs,
              stages={n: s for n, s, _note in model.stage_timings.stages},
              clusters_before=int(model.fluxMatrixRaw.shape[0]),
              clusters_after=int(model.fluxMatrix.shape[0]),
              JtargetSS=float(model.JtargetSS), validation_JtargetSS=jv,
              launch_counts=counts))
    summary["launches_analysis"] = counts

    # ---- (b) the analysis on that model
    emit(dict(phase="analysis_calls", **_analysis_calls(model)))
    del model

    # ---- (d) FPT engines
    for line in _fpt_checks():
        emit(dict(phase="analysis_fpt", **line))


# -------------------------------------------------------------------- run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="directory for the compiler log")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import logging

    import torch

    # The package logs each build stage at INFO; the phases print their own
    logging.getLogger("msm_we_tpu_torch").setLevel(logging.WARNING)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "msm_we_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    summary = {}
    if "device" in phases:
        emit(dict(phase="device", name=kind, count=count, nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda))
    if "build" in phases:
        from msm_we_tpu_torch.ops import _ext

        t0 = time.perf_counter()
        _ext.library()
        regs = [ln.strip() for ln in _ext.build_info["log"].splitlines()
                if "registers" in ln]
        emit(dict(phase="build", seconds=time.perf_counter() - t0,
                  nvcc_seconds=_ext.build_info["seconds"], ptxas=regs))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "nvcc.log"), "w") as fh:
                fh.write(_ext.build_info["log"])
    if "kernels" in phases:
        phase_kernels(args, summary)
    if "main" in phases:
        phase_main(args, summary)
    if "analysis" in phases:
        phase_analysis(args, summary)

    launches = summary.get("launches", {})
    launches_analysis = summary.get("launches_analysis", {})
    kernels = []
    for name, info in KERNEL_INFO.items():
        k = summary.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=info["replaces"], launches=launches.get(name),
            launches_analysis=launches_analysis.get(name),
            max_abs_err=k.get("max_abs_err"), ms=k.get("ms"),
            plain_ms=k.get("plain_ms"),
        ))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind, count=count)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
