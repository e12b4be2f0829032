#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``msm_we_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,main,analysis,access,configs] [--out DIR]

Phases, each printing one JSON line:

1. ``device``: the card's name, count and power limit (a GPU is required).
2. ``build``: compile the kernel library from ``msm_we_tpu_torch/csrc``.
3. ``kernels``: every kernel against its plain PyTorch version on the same
   device tensors at the main path's shapes (``make_problem()``: 102,400
   segments, raw 900 -> 30 features, 250 centers). Every kernel also at
   3,200 centers over 128 bins and at 300 features over 12 bins x 25 (H1/H2:
   raw 900 -> 300 with a seeded P), H3/H4 also on one bin of 300 centers
   (aggregated clustering). Ids must agree except at near-ties, H1's
   features to 1e-4 relative, dyadic f64 flux bitwise, H4's ids must
   equal H3's raw ids bitwise, and the plan kernels of H3/H4 their plain
   plans. Median times of kernel, plain version and the dense
   ``torch.mm`` each kernel cannot avoid (``mm_ms``) from CUDA events;
   device times of the kernel and its plan kernels from ``torch.profiler``;
   ``bound_ms`` is the least time the card could take (bytes over 3.35
   TB/s or FLOPs over 67 TFLOP/s f32, whichever is larger). H3's lines
   also give the FLOPs it issues beside the same-bin FLOPs.
4. ``main``: the main path with every launch count reset first --
   ``hot_step`` in both tiers and ``entry()`` at full size, then the haMSM
   build (``modelWE.build_analyze_model``) on a 101 x 1,000 synthetic WE
   run generated in memory, cold with ``device="cuda"``, then warm with
   ``modelWE()`` (the default device must be the card). Every kernel must
   have launched. Then the
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
6. ``access``: (a) the bench build (101 x 1,000) and the default build
   (101 x 10,000), each warm, untraced and then with ``profile_dir`` set
   (under ``--out``, else a temporary directory): the trace file must
   exist, parse and hold device kernel events that include H4's kernel,
   and the traced build's JtargetSS must equal the untraced one's bitwise;
   printed are the wall seconds, the summed device time, the device's busy
   share of the wall and the ten device operations with the most time.
   (b) The seven data-access methods on the bench build's model against
   the arrays its dataset was made from. (c) ``NonMarkovModel`` and
   ``MarkovPlusColorModel`` on a seeded three-state walk of 50,000 steps:
   populations sum to 1, model MFPTs within 20% of the empirical ones.
   (d) Where h5py can be imported, ``generate_west_h5`` at 30 x 200 into a
   temporary file and a build from that path on the card, bitwise equal to
   the ``ArrayWEDataset`` build of the same arrays; where it cannot, the
   line says so and ``initialize([path])`` must raise the ``ImportError``
   that names h5py.
7. ``configs``: the build's other configurations. (a) Device-family
   seeding (``seed_bins_batched``, 12 bins x 16,384 rows) on the card
   against the CPU: equal k-means++ rows, centers and weight sums within
   rtol 1e-5, two card runs bitwise equal. (b) The default build on
   11 iterations x 100,000 segments (8 stacked replicas of 12,500), cold
   then warm: bins seed through the device family, the two builds are
   bitwise equal. (c) The default build with aggregated k-means (300
   clusters) on the ``analysis`` data, then against the CPU at 30 x 200.
   (d) TICA, VAMP and batch-PCA fits and builds at 100 atoms (300 raw
   features, device f32 pair moments) against the CPU f64 fits; their
   features are wider than 128 (139 to 300), so H4 runs its any-width
   path, and each build's ids must equal the plain version's on its own
   features and bank except at near-ties. Launch counts are reset before
   each build of (b)-(d); H4 must launch in each.

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

PHASES = ("device", "build", "kernels", "main", "analysis", "access", "configs")

KERNEL_INFO = {
    "transform_assign_child": dict(
        pallas="H1", replaces="msm_we_tpu/ops/pallas_kernels.py:546",
        source="msm_we_tpu_torch/csrc/stratified_assign.cu"),
    "transform_assign": dict(
        pallas="H2", replaces="msm_we_tpu/ops/pallas_kernels.py:377",
        source="msm_we_tpu_torch/csrc/stratified_assign.cu"),
    "assign_flux": dict(
        pallas="H3", replaces="msm_we_tpu/ops/pallas_kernels.py:248",
        source="msm_we_tpu_torch/csrc/assign_flux.cu"),
    "pair_assign": dict(
        pallas="H4", replaces="msm_we_tpu/ops/pallas_kernels.py:203",
        source="msm_we_tpu_torch/csrc/pair_assign.cu"),
}
# Published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores (every assignment stays exact f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def device_ms(fn, name, reps):
    """Mean device milliseconds per run of ``fn`` spent in the kernels
    whose name contains ``name`` (``torch.profiler`` over ``reps`` runs
    after one untimed run), or None when the trace shows no device time
    for them. Unlike ``cuda_ms``, host launch overhead is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or 0
             for ev in prof.key_averages() if name in ev.key)
    return us / 1e3 / reps if us > 0 else None


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


def _bound(tensors, flops):
    """(bound_ms, bound_by): the larger of the bytes of ``tensors`` (each
    input read once, each output written once) over the HBM rate and
    ``flops`` over the f32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _same_bin_pairs(bins, bank):
    """Number of (row, valid same-bin center) pairs: the products this
    run's data needs."""
    import torch

    cb = bank[1][bank[2]].long()
    b = bins.long()
    n_bins = int(max(int(cb.max()), int(b.max()))) + 1
    per_bin = torch.bincount(cb, minlength=n_bins)
    return int(torch.where(b >= 0, per_bin[b.clamp(min=0)], 0).sum())


def _h3_flops(pbins, cbins, bank, F):
    """(FLOPs H3 issues, same-bin FLOPs) at these inputs, as
    ``csrc/assign_flux.cu`` cuts the work: each block's run of one bin
    into tasks of ``TASK_ROWS`` rows; a task of more than 16 rows scores 32
    row slots against 32 center slots per 32-center chunk; a shorter one
    R = max(4, next power of two) row slots against its chunk's centers in
    passes of 16 (R = 8) or 32 center slots."""
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa

    _cperm, ckey, rkey = sa._plan_keys(pbins, cbins, bank[1], bank[2])
    dev, N, K = ckey.device, cbins.shape[0], ckey.shape[0]
    block = (torch.arange(N, device=dev) // sa.SEGMENTS_PER_BLOCK).repeat(2)
    g = rkey.long()
    live = g < K
    runs, rows = torch.unique(block[live] * (K + 1) + g[live], return_counts=True)
    ncent = torch.searchsorted(ckey, ckey, right=True) - torch.arange(K, device=dev)
    nc = ncent[runs % (K + 1)]
    full, rem = rows // sa.TASK_ROWS, rows % sa.TASK_ROWS
    long_rows = full * 32 + torch.where(rem > 16, 32, 0)
    long_slots = 32 * ((nc + 31) // 32)
    short = (rem > 0) & (rem <= 16)
    R = torch.where(rem <= 4, 4, torch.exp2(torch.ceil(torch.log2(
        rem.clamp(min=1).double()))).long())
    cc = torch.where(R == 8, 16, 32)
    short_slots = (nc // 32) * 32 + (nc % 32 + cc - 1) // cc * cc
    issued = long_rows * long_slots + torch.where(short, R * short_slots, 0)
    return 2 * F * int(issued.sum()), 2 * F * int((rows * nc).sum())


def _wide_bank(fc, bins_c, n_bins, k, seed, rng):
    """k centers per bin: rows of ``fc`` in that bin plus small noise."""
    import numpy as np
    import torch

    dev = fc.device
    bc = bins_c.cpu().numpy()
    pick = np.concatenate([
        rng.choice(np.flatnonzero(bc == b), k, replace=False) for b in range(n_bins)
    ])
    centers = (fc[torch.as_tensor(pick, device=dev)]
               + 0.01 * torch.randn(len(pick), fc.shape[1], device=dev,
                                    generator=torch.Generator(dev).manual_seed(seed))
               ).contiguous()
    return (centers,
            torch.as_tensor(np.repeat(np.arange(n_bins, dtype=np.int32), k), device=dev),
            torch.ones(len(pick), dtype=torch.bool, device=dev))


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
    bank = (s["centers"], s["center_bin"], s["valid"])
    rng = np.random.default_rng(5)
    # Dyadic f64 weights: every cell sum is exact in any order
    w64 = torch.as_tensor(rng.integers(1, 17, N) / 16.0, device=dev)
    reps = args.reps

    def record(name, regime, ms, plain_ms, err, mism, ties, bound, mm_ms,
               flux_ok=None, K=None, **extra):
        line = dict(phase="kernel", name=name, pallas=KERNEL_INFO[name]["pallas"],
                    regime=regime, n=int(N), K=int(K or bank[0].shape[0]),
                    ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                    bound_by=bound[1], mm_ms=mm_ms, library_ms=None,
                    max_abs_err=err, id_mismatches=mism, near_ties=ties, **extra)
        if flux_ok is not None:
            line["flux_bitwise"] = flux_ok
        emit(line)
        if regime == "K=250":  # the main path's bank for the summary line
            summary[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                 bound_ms=bound[0], bound_by=bound[1],
                                 mm_ms=mm_ms, kernel_ms=extra.get("kernel_ms"))

    def h1h2(regime, mean, proj, pb, cb, bk):
        """H1 and H2 on the main path's raw rows against their plain
        versions (ids up to near-ties, H1's features, H2's dyadic f64 flux
        bitwise); wrapper, device and plain times beside the bound and
        ``torch.mm`` of raw x P."""
        SS = bk[0].shape[0] + 2
        Fx = proj.shape[1]
        a2 = sa.c2adj(mean, proj, bk[0])
        pairs_p, pairs_c = _same_bin_pairs(pb, bk), _same_bin_pairs(cb, bk)
        raw_p, raw_c = s["raw_parent"], s["raw_child"]

        # H1: child rows, raw -> features -> ids (+ features)
        idx_k, g_k = sa.transform_assign_child(raw_c, cb, None, None, mean, proj,
                                               *bk, SS, emit_features=True)
        idx_p, g_p = sa.transform_assign_child_plain(raw_c, cb, None, None, mean,
                                                     proj, *bk, SS, emit_features=True)
        torch.cuda.synchronize()
        mism, ties = _compare_ids("transform_assign_child", regime, idx_k, idx_p,
                                  SS, None, cb, bk, c2=a2, raw=raw_c, proj=proj)
        err = float((g_k - g_p).abs().max())
        require(err <= 1e-4 * float(g_p.abs().max()),
                f"H1 [{regime}] features differ by {err}")
        del g_p
        h1 = (raw_c, cb, s["basis_c"], s["target_c"], mean, proj, *bk, SS)
        ms = cuda_ms(lambda: sa.transform_assign_child(*h1, emit_features=True), reps)
        pms = cuda_ms(lambda: sa.transform_assign_child_plain(*h1, emit_features=True),
                      reps)
        dms = device_ms(lambda: sa.transform_assign_child(*h1, emit_features=True),
                        "stratified_assign_kernel", reps)
        # The features-only launch (the dedup tier's): the transform alone
        g_f = sa.transform_assign_child(*h1, features_only=True)[1]
        require(torch.equal(g_f, g_k), f"H1 [{regime}] features-only launch differs")
        del g_f
        fdms = device_ms(lambda: sa.transform_assign_child(*h1, features_only=True),
                         "stratified_assign_kernel", reps)
        mm = cuda_ms(lambda: torch.mm(raw_c, proj), reps)
        bound = _bound([raw_c, cb, s["basis_c"], s["target_c"], mean, proj, *bk,
                        idx_k, g_k], 2 * N * D * Fx + 2 * pairs_c * Fx)
        record("transform_assign_child", regime, ms, pms, err, mism, ties, bound, mm,
               K=bk[0].shape[0], F=int(Fx), kernel_ms=dms,
               features_only_kernel_ms=fdms)
        del g_k

        # H2: both raw sets, flux-order overrides, f64 dyadic flux
        args2 = (raw_p, raw_c, pb, cb)
        ovr2 = (s["basis_p"], s["basis_c"], s["target_c"], mean, proj, *bk, SS)
        pk, ck, fk = sa.transform_assign(*args2, w64, *ovr2)
        _pp, _cp, fpl = sa.transform_assign_plain(*args2, w64, *ovr2)
        # Raw ids (no overrides) for the near-tie check
        none = torch.zeros(N, dtype=torch.bool, device=dev)
        rk = sa.transform_assign(*args2, None, none, none, none, mean, proj, *bk,
                                 SS, with_flux=False)
        rp = sa.transform_assign_plain(*args2, None, none, none, none, mean, proj,
                                       *bk, SS, with_flux=False)
        torch.cuda.synchronize()
        m1, t1 = _compare_ids("transform_assign", regime, rk[0], rp[0], SS, None,
                              pb, bk, c2=a2, raw=raw_p, proj=proj)
        m2, t2 = _compare_ids("transform_assign", regime, rk[1], rp[1], SS, None,
                              cb, bk, c2=a2, raw=raw_c, proj=proj)
        own = _scatter_flux(pk, ck, w64, SS)
        flux_ok = bool(torch.equal(fk, own)) and (
            (m1 + m2) > 0 or bool(torch.equal(fk, fpl)))
        require(flux_ok, f"H2 [{regime}] dyadic f64 flux is not bitwise equal")
        err = float((fk - fpl).abs().max())
        del own, fpl, rk, rp
        ms = cuda_ms(lambda: sa.transform_assign(*args2, s["w"], *ovr2), reps)
        pms = cuda_ms(lambda: sa.transform_assign_plain(*args2, s["w"], *ovr2), reps)
        dms = device_ms(lambda: sa.transform_assign(*args2, s["w"], *ovr2),
                        "stratified_assign_kernel", reps)
        mm = cuda_ms(lambda: (torch.mm(raw_p, proj), torch.mm(raw_c, proj)), reps)
        fm32 = torch.empty((SS, SS), dtype=torch.float32, device=dev)
        bound = _bound([*args2, s["w"], *ovr2[:5], *bk, pk, ck, fm32],
                       4 * N * D * Fx + 2 * (pairs_p + pairs_c) * Fx)
        record("transform_assign", regime, ms, pms, err, m1 + m2, t1 + t2, bound,
               mm, flux_ok, K=bk[0].shape[0], F=int(Fx), kernel_ms=dms)

    h1h2("K=250", s["mean"], s["comp"], s["pbins"], s["cbins"], bank)

    # H3 / H4 on features: the main path's K=250 bank, and a wide bank
    # (128 bins x 25 = 3,200 centers: K tiling, > 64 bins), which H1/H2
    # also score
    off = s["mean"] @ s["comp"]
    fp = (s["raw_parent"] @ s["comp"] - off).contiguous()
    fc = (s["raw_child"] @ s["comp"] - off).contiguous()
    n_wide = 128
    bins_p_w = torch.as_tensor(rng.integers(0, n_wide, N).astype(np.int32),
                               device=dev)
    bins_c_w = torch.as_tensor(rng.integers(0, n_wide, N).astype(np.int32),
                               device=dev)
    bank_w = _wide_bank(fc, bins_c_w, n_wide, 25, 7, rng)
    h1h2("K=3200,bins=128", s["mean"], s["comp"], bins_p_w, bins_c_w, bank_w)
    # 300 features from the same raw rows (a seeded P): 12 bins x 25
    gen = torch.Generator(dev).manual_seed(11)
    proj3 = torch.randn(D, 300, device=dev, generator=gen) / D ** 0.5
    rng3 = np.random.default_rng(13)  # keeps ``rng``'s draws as before
    b12p = torch.as_tensor(rng3.integers(0, 12, N).astype(np.int32), device=dev)
    b12c = torch.as_tensor(rng3.integers(0, 12, N).astype(np.int32), device=dev)
    fc3 = (s["raw_child"] @ proj3 - s["mean"] @ proj3).contiguous()
    bank_3 = _wide_bank(fc3, b12c, 12, 25, 12, rng3)
    del fc3
    h1h2("F=300,bins=12x25", s["mean"], proj3, b12p, b12c, bank_3)
    del s["raw_parent"], proj3, bank_3
    ovr = (s["basis_p"], s["basis_c"], s["target_c"])
    h4_kw = dict(basis_p=s["basis_p"], basis_c=s["basis_c"],
                 target_c=s["target_c"], order="predict")

    def h4(regime, X_p, X_c, pb, cb, bk, flux_regime):
        """H4 against its plain version (and, with ``flux_regime``, H3
        and H3's raw ids bitwise); wrapper, kernel-alone and plain times."""
        SS = bk[0].shape[0] + 2
        rk = sa.pair_assign(X_p, X_c, pb, cb, *bk)
        rp = sa.pair_assign_plain(X_p, X_c, pb, cb, *bk)
        torch.cuda.synchronize()
        m1, t1 = _compare_ids("pair_assign", regime, rk[0], rp[0], SS, X_p, pb, bk)
        m2, t2 = _compare_ids("pair_assign", regime, rk[1], rp[1], SS, X_c, cb, bk)
        pairs = _same_bin_pairs(pb, bk) + _same_bin_pairs(cb, bk)
        Fx = X_c.shape[1]
        mm = cuda_ms(lambda: (torch.mm(X_p, bk[0].T), torch.mm(X_c, bk[0].T)), reps)
        extra = {}
        if flux_regime:
            pk, ck, fk = sa.assign_flux(X_p, X_c, pb, cb, w64, *ovr, *bk, SS)
            _pp, _cp, fpl = sa.assign_flux_plain(X_p, X_c, pb, cb, w64, *ovr, *bk, SS)
            none = torch.zeros(N, dtype=torch.bool, device=dev)
            hp, hc, _fm = sa.assign_flux(X_p, X_c, pb, cb, w64, none, none, none,
                                         *bk, SS)
            require(torch.equal(hp, rk[0]) and torch.equal(hc, rk[1]),
                    f"H4 [{regime}] ids are not bitwise H3's raw ids")
            own = _scatter_flux(pk, ck, w64, SS)
            flux_ok = bool(torch.equal(fk, own)) and (
                (m1 + m2) > 0 or bool(torch.equal(fk, fpl)))
            require(flux_ok, f"H3 [{regime}] dyadic f64 flux is not bitwise equal")
            err = float((fk - fpl).abs().max())
            ms = cuda_ms(lambda: sa.assign_flux(X_p, X_c, pb, cb, s["w"], *ovr,
                                                *bk, SS), reps)
            pms = cuda_ms(lambda: sa.assign_flux_plain(X_p, X_c, pb, cb, s["w"],
                                                       *ovr, *bk, SS), reps)
            dms = device_ms(lambda: sa.assign_flux(X_p, X_c, pb, cb, s["w"], *ovr,
                                                   *bk, SS), "assign_flux_kernel", reps)
            plan3 = device_ms(lambda: sa.assign_flux(X_p, X_c, pb, cb, s["w"], *ovr,
                                                     *bk, SS), "plan_", reps)
            keys = sa._plan_keys(pb, cb, bk[1], bk[2])
            require(all(torch.equal(a, b) for a, b in
                        zip(keys, sa._plan_keys_plain(pb, cb, bk[1], bk[2]))),
                    f"H3 [{regime}] plan kernels differ from the plain plan")
            del keys
            issued, same_bin = _h3_flops(pb, cb, bk, Fx)
            fm32 = torch.empty((SS, SS), dtype=torch.float32, device=dev)
            bound = _bound([X_p, X_c, pb, cb, s["w"], *ovr, *bk, pk, ck, fm32],
                           2 * pairs * Fx)
            record("assign_flux", regime, ms, pms, err, m1 + m2, t1 + t2, bound,
                   mm, flux_ok, K=bk[0].shape[0], F=int(Fx), kernel_ms=dms,
                   plan_kernels_ms=plan3, flops_issued=issued,
                   flops_same_bin=same_bin)
            extra["h3_raw_ids_bitwise"] = True

        # H4 with the predict-order epilogue, as the build discretizes:
        # the whole wrapper (plan + kernel), its device time in the assign
        # kernel and in the plan kernels, and the plain version
        kw = dict(n_states=SS, **h4_kw)
        ms = cuda_ms(lambda: sa.pair_assign(X_p, X_c, pb, cb, *bk, **kw), reps)
        dms = device_ms(lambda: sa.pair_assign(X_p, X_c, pb, cb, *bk, **kw),
                        "pair_assign_kernel", reps)
        plan_dms = device_ms(lambda: sa.pair_assign(X_p, X_c, pb, cb, *bk, **kw),
                             "plan_", reps)
        plan = sa._bin_tiles(pb, cb, bk[1], bk[2])
        require(all(torch.equal(a, b) for a, b in
                    zip(plan, sa._bin_tiles_plain(pb, cb, bk[1], bk[2]))),
                f"H4 [{regime}] plan kernels differ from the plain plan")
        del plan
        pms = cuda_ms(lambda: sa.pair_assign_plain(X_p, X_c, pb, cb, *bk, **kw),
                      reps)
        # Score gap (f64) between the kernel's and the plain version's
        # chosen centers: 0 when every id agrees
        gap = _score_gap(X_c, bk, rk[1], rp[1])
        bound = _bound([X_p, X_c, pb, cb, s["basis_p"], s["basis_c"], s["target_c"],
                        *bk, *rk], 2 * pairs * Fx)
        record("pair_assign", regime, ms, pms, gap, m1 + m2, t1 + t2, bound, mm,
               K=bk[0].shape[0], F=int(Fx), kernel_ms=dms,
               plan_kernels_ms=plan_dms, **extra)
        return ms, dms

    h4_ms = {}
    h4_ms["K=250"] = h4("K=250", fp, fc, s["pbins"], s["cbins"], bank, True)
    h4_ms["K=3200"] = h4("K=3200,bins=128", fp, fc, bins_p_w, bins_c_w, bank_w, True)
    del bank_w, bins_p_w, bins_c_w
    # Aggregated clustering's shape: every row in one bin of 300 centers
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    bank_1 = _wide_bank(fc, zeros, 1, 300, 8, rng)
    h4_ms["one_bin"] = h4("one_bin,K=300", fp, fc, zeros, zeros, bank_1, True)
    del bank_1
    # 300 features (batch PCA at 100 atoms keeps all): 12 bins x 25
    gen = torch.Generator(dev).manual_seed(9)
    fp3 = torch.randn(N, 300, device=dev, generator=gen)
    fc3 = torch.randn(N, 300, device=dev, generator=gen)
    b12p = torch.as_tensor(rng.integers(0, 12, N).astype(np.int32), device=dev)
    b12c = torch.as_tensor(rng.integers(0, 12, N).astype(np.int32), device=dev)
    bank_3 = _wide_bank(fc3, b12c, 12, 25, 10, rng)
    h4_ms["F=300"] = h4("F=300,bins=12x25", fp3, fc3, b12p, b12c, bank_3, True)
    del fp3, fc3, bank_3
    (ms_a, dev_a), (ms_b, dev_b) = h4_ms["K=250"], h4_ms["K=3200"]
    emit(dict(phase="kernels", setup_s=setup_s, reps=reps,
              h4_ms_ratio_k3200_over_k250=ms_b / ms_a,
              h4_device_ms_ratio_k3200_over_k250=dev_b / dev_a if dev_a and dev_b else None))


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


def _build(data, device, scan, n_clusters, quiet=True, profile_dir=None):
    """The bench build of ``data``: a list of per-iteration arrays, or a
    list of west.h5 paths."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    # device None: the model's default, the card
    model = modelWE() if device is None else modelWE(device=device)
    in_memory = isinstance(data[0], dict)
    t0 = time.perf_counter()
    model.build_analyze_model(
        file_paths=ArrayWEDataset(data) if in_memory else data,
        profile_dir=profile_dir,
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
    fn, eargs = entry()  # the default device: the card
    fm, pss, flux, residual = fn(*eargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(pss).all()), "entry() pSS not finite")
    emit(dict(phase="entry", flux_sum=float(fm.sum()), JtargetSS=float(flux),
              ss_residual=float(residual)))

    builds = []
    # cold (first use of every path), then warm with no device given
    for device in ("cuda", None):
        secs, model = _build(data, device, True, 25)
        builds.append(secs)
    require(model.device.type == "cuda",
            f"modelWE() with no device built on {model.device}")
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
    summary["bench_data"] = data  # reused by the access phase

    # ---- references (not counted)
    emit(dict(phase="hot_step_reference", **_hot_step_ref_check()))
    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    for scan in (False, True):
        emit(dict(phase="build_parity", **_build_parity(small, scan)))


# -------------------------------------------------------------- analysis


def _default_build(data, device, n_clusters=25, n_atoms=4, dimreduce_method="pca",
                   stratified=True, dim_reduce_kwargs=None, profile_dir=None):
    """``build_analyze_model`` with its defaults (block cross-validation,
    2 groups x 4 blocks; predict route) in the bench configuration."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    model = modelWE(device=device)
    step_kwargs = {"dimReduce": dim_reduce_kwargs or {}}
    if stratified:
        step_kwargs["clustering"] = {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
            "scan_small_batches": True,
        }
    t0 = time.perf_counter()
    model.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        ref_struct={"coords": None, "nAtoms": n_atoms, "coord_ndim": 3},
        modelName="smoke",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method=dimreduce_method,
        tau=1.0,
        n_clusters=n_clusters,
        stratified=stratified,
        show_live_display=False,
        step_kwargs=step_kwargs,
        profile_dir=profile_dir,
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
    summary["analysis_data"] = data  # reused by the configs phase
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


# ---------------------------------------------------------------- access

DEVICE_EVENT_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_summary(path, wall_s):
    """Device time of one Chrome trace written by ``profile_trace``: the
    events of the device categories (kernels, copies, fills), their summed
    duration, the time the device was busy (the union of their intervals,
    so overlapping streams do not count twice), its share of ``wall_s``
    (the seconds the traced build ran), and the ten operations with the
    most time."""
    with open(path) as fh:
        trace = json.load(fh)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATEGORIES]
    by_name = {}
    for e in events:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    busy_us, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur > end:
            busy_us += ts + dur - max(ts, end)
            end = ts + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        trace_bytes=os.path.getsize(path), trace_events=len(trace["traceEvents"]),
        device_events=len(events),
        kernel_events=sum(e["cat"] == "kernel" for e in events),
        h4_kernel_events=sum("pair_assign_kernel" in e["name"] for e in events),
        device_sum_ms=sum(e["dur"] for e in events) / 1e3,
        device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / 1e6 / wall_s,
        top_device_ops=[dict(name=name[:120], calls=n, ms=t / 1e3) for name, (n, t) in top],
    )


def _traced_build(name, build, out_dir, smi):
    """``build(profile_dir)`` warm, untraced and then traced: the trace
    must hold H4's kernel and leave the result bitwise unchanged."""
    import numpy as np
    import torch

    plain_s, plain = build(None)
    torch.cuda.synchronize()
    log_dir = os.path.join(out_dir, f"trace_{name}")
    call_s, traced = build(log_dir)
    # The build's stages, without the profiler's start (the first use of a
    # process sets up the tracing library, which takes seconds), its stop
    # and the export of the trace
    traced_s = traced.stage_timings.total
    path = traced.build_profile.trace_path
    require(os.path.isfile(path) and os.path.dirname(path) == log_dir,
            f"{name}: no trace file at {path}")
    t0 = time.perf_counter()
    line = _trace_summary(path, traced_s)
    parse_s = time.perf_counter() - t0
    require(line["kernel_events"] > 0, f"{name}: the trace holds no device kernel events")
    require(line["h4_kernel_events"] > 0, f"{name}: the trace does not hold H4's kernel")
    require(float(traced.JtargetSS) == float(plain.JtargetSS),
            f"{name}: traced JtargetSS {traced.JtargetSS} != untraced {plain.JtargetSS}")
    jv = [float(v.JtargetSS) for v in getattr(traced, "validation_models", [])]
    require(jv == [float(v.JtargetSS) for v in getattr(plain, "validation_models", [])],
            f"{name}: traced validation JtargetSS differ")
    np.testing.assert_array_equal(np.concatenate(traced.dtrajs),
                                  np.concatenate(plain.dtrajs))
    emit(dict(phase="access_trace", build=name, nvidia_smi=smi,
              segments=int(sum(len(d) for d in traced.dtrajs)),
              seconds_untraced=plain_s, stages_untraced_s=plain.stage_timings.total,
              seconds_traced=traced_s, profiler_start_stop_export_s=call_s - traced_s,
              parse_s=parse_s,
              JtargetSS=float(traced.JtargetSS), validation_JtargetSS=jv,
              stages=_stages(traced), trace_file=path, **line))
    return traced


def _data_access_checks(model, data):
    """The seven data-access methods of ``model`` against ``data``, the
    arrays its dataset was made from."""
    import numpy as np

    it, last = 40, len(data) - 1  # the last iteration is incomplete
    final = lambda i: np.asarray(data[i - 1]["coords"])[:, -1]  # noqa: E731
    np.testing.assert_array_equal(model.get_iter_coordinates(it), final(it))
    require(model.n_iter == it and model.nSeg == len(data[it - 1]["weights"]),
            "get_iter_coordinates did not load the iteration")
    model.load_iter_coordinates()
    np.testing.assert_array_equal(model.cur_iter_coords, final(it))
    model.load_iter_coordinates0()
    np.testing.assert_array_equal(model.cur_iter_coords,
                                  np.asarray(data[it - 1]["coords"])[:, 0])
    model.get_iterations_iters(5, 14)
    np.testing.assert_array_equal(
        model.numSegments, [float(len(data[i - 1]["weights"])) for i in range(5, 15)])
    model.get_iterations()
    require(model.maxIter == last, f"maxIter {model.maxIter} != {last}")
    model.get_coordinates(3, 6)
    np.testing.assert_array_equal(model.all_coords,
                                  np.concatenate([final(i) for i in range(3, 7)]))
    model.load_iter_data(it)
    model.get_seg_histories(4)
    parents = np.asarray(data[it - 1]["parent_ids"])
    np.testing.assert_array_equal(model.seg_histories[:, 0], np.arange(model.nSeg))
    np.testing.assert_array_equal(model.seg_histories[:, 1], parents)
    np.testing.assert_array_equal(model.weight_histories[:, 0], data[it - 1]["weights"])
    length = 5
    trajs = model.get_traj_coordinates(it, length)
    require(len(trajs) == model.nSeg, "one trajectory a current segment")
    cut = 0
    for s, traj in enumerate(trajs):
        anc, steps = s, []
        for h in range(length):  # walk back until the lineage was recycled
            steps.append(final(it - h)[anc])
            anc = int(np.asarray(data[it - h - 1]["parent_ids"])[anc])
            if anc < 0:
                break
        cut += len(steps) < length
        np.testing.assert_array_equal(traj, np.array(steps[::-1]))
    return dict(iteration=it, segments=int(model.nSeg), traj_length=length,
                recycled_lineages=int(cut), methods=7)


def _trajectory_model_checks():
    """``NonMarkovModel`` and ``MarkovPlusColorModel`` on a seeded
    three-state walk: populations sum to 1 and the model's MFPTs lie within
    20% of the empirical ones."""
    import numpy as np

    import msm_we_tpu_torch as port

    traj = np.random.default_rng(7).integers(0, 3, 50_000)
    out = {}
    for name, model in (
        ("NonMarkovModel",
         port.NonMarkovModel([traj], stateA=[0], stateB=[2], lag_time=10)),
        ("MarkovPlusColorModel",
         port.MarkovPlusColorModel([traj], stateA=[0], stateB=[2], lag_time=10,
                                   hist_length=20)),
    ):
        got, emp = model.mfpts(), model.empirical_mfpts()
        for key in ("mfptAB", "mfptBA"):
            require(abs(got[key] - emp[key]) <= 0.2 * emp[key],
                    f"{name}: {key} {got[key]} vs empirical {emp[key]}")
        line = dict(mfptAB=float(got["mfptAB"]), mfptBA=float(got["mfptBA"]),
                    empirical_mfptAB=float(emp["mfptAB"]),
                    empirical_mfptBA=float(emp["mfptBA"]))
        if name == "NonMarkovModel":  # the color model estimates no populations
            pops = model.populations()
            require(abs(pops.sum() - 1.0) < 1e-9 and pops.min() > 0,
                    f"{name}: populations {pops}")
            line["populations"] = [float(p) for p in pops]
            seqs, weights, n = model.empirical_weighted_FS()
            require(abs(sum(weights) - 1.0) < 1e-9, "fundamental-sequence weights")
            line["fundamental_sequences"] = len(seqs)
        out[name] = line
    return out


def _file_checks(tmp_dir):
    """With h5py: a west.h5 at 30 x 200 built from its path on the card
    equals the ``ArrayWEDataset`` build of the same arrays bitwise. Without
    it: opening a path raises the ``ImportError`` that names h5py."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_arrays, generate_west_h5
    from msm_we_tpu_torch.model import modelWE

    path = os.path.join(tmp_dir, "west.h5")
    try:
        import h5py  # noqa: F401
    except ImportError:
        try:
            modelWE().initialize(
                [path], {"coords": None, "nAtoms": 4, "coord_ndim": 3}, "nofile",
                basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]])
        except ImportError as e:
            require("h5py" in str(e), f"the ImportError does not name h5py: {e}")
            return dict(h5py=False, import_error=str(e)[:160])
        raise Failure("initialize([path]) did not raise ImportError without h5py")
    generate_west_h5(path, n_iterations=30, n_segments=200, seed=17)
    arrays = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    file_s, f = _build([path], None, True, 25)
    _s, a = _build(arrays, None, True, 25)
    np.testing.assert_array_equal(np.concatenate(f.dtrajs), np.concatenate(a.dtrajs))
    np.testing.assert_array_equal(f.fluxMatrixRaw, a.fluxMatrixRaw)
    require(float(f.JtargetSS) == float(a.JtargetSS),
            f"file build JtargetSS {f.JtargetSS} != in-memory {a.JtargetSS}")
    require(f._dataset._open_handles == {}, "the build left file handles open")
    return dict(h5py=True, seconds=file_s, bytes=os.path.getsize(path),
                JtargetSS=float(f.JtargetSS))


def phase_access(args, summary, smi):
    """Traced builds, the data-access methods, the trajectory models and
    the file path."""
    import shutil
    import tempfile

    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.ops import stratified_assign as sa

    tmp_dir = tempfile.mkdtemp(prefix="chip_smoke_access_")
    out_dir = args.out or tmp_dir
    try:
        bench = summary.get("bench_data")
        if bench is None:
            bench = generate_we_arrays(n_iterations=101, n_segments=1000, seed=17)
            _build(bench, None, True, 25)  # cold: first use of every path
        sa.reset_launch_counts()
        model = _traced_build(
            "bench", lambda d: _build(bench, None, True, 25, profile_dir=d),
            out_dir, smi)
        counts = sa.launch_counts()
        require(counts["pair_assign"] > 0, "pair_assign never launched in the traced build")
        emit(dict(phase="access_data", **_data_access_checks(model, bench)))
        del model, bench

        data = summary.get("analysis_data")
        if data is None:
            data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
            summary["analysis_data"] = data
            _default_build(data, "cuda")  # cold
        sa.reset_launch_counts()
        model = _traced_build(
            "default", lambda d: _default_build(data, "cuda", profile_dir=d),
            out_dir, smi)
        for k, v in sa.launch_counts().items():
            counts[k] += v
        del model, data
        torch.cuda.empty_cache()
        summary["launches_access"] = counts

        emit(dict(phase="access_models", **_trajectory_model_checks()))
        emit(dict(phase="access_file", nvidia_smi=smi, **_file_checks(tmp_dir)))
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


# --------------------------------------------------------------- configs


def _stages(model):
    return {n: s for n, s, _note in model.stage_timings.stages}


def _seeding_check():
    """(a) ``seed_bins_batched`` on the card against the CPU: 12 bins x
    16,384 rows (the last 20% zero-weight outliers), d = 5, k = 25, seeds
    17 + b. The live rows are 25 tight blobs per bin, so Lloyd's
    assignments have no near-ties and the two devices' f32 sums may differ
    only in rounding."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.ops.kmeans import seed_bins_batched

    B, P, d, k = 12, 16_384, 5, 25
    live = P - P // 5
    rng = np.random.default_rng(17)
    Xs = np.empty((B, P, d), np.float32)
    ws = np.zeros((B, P), np.float32)
    for b in range(B):
        means = rng.normal(size=(k, d)) * 4.0
        Xs[b, :live] = means[rng.integers(0, k, live)] + 0.05 * rng.normal(size=(live, d))
        Xs[b, live:] = 50.0 + rng.normal(size=(P - live, d))
        ws[b, :live] = rng.uniform(0.1, 1.0, live)
    seeds = [17 + b for b in range(B)]
    cpu_s, (packed_c, idx_c) = _timed(lambda: seed_bins_batched(
        seeds, torch.as_tensor(Xs), torch.as_tensor(ws), k, return_index=True))
    Xd, wd = torch.as_tensor(Xs, device="cuda"), torch.as_tensor(ws, device="cuda")

    def on_card():
        out = seed_bins_batched(seeds, Xd, wd, k, return_index=True)
        torch.cuda.synchronize()
        return out

    first_s, (packed_g, idx_g) = _timed(on_card)
    cuda_s, (packed_g2, idx_g2) = _timed(on_card)
    idx_g, idx_c = idx_g.cpu().numpy(), idx_c.numpy()
    require(np.array_equal(idx_g, idx_c), "k-means++ rows differ between the card and the CPU")
    require((np.take_along_axis(ws, idx_g, axis=1) > 0).all(),
            "k-means++ chose a zero-weight row")
    require(torch.equal(packed_g, packed_g2) and torch.equal(idx_g2.cpu(), torch.as_tensor(idx_g)),
            "two seedings on the card are not bitwise equal")
    g, c = packed_g.cpu().numpy(), packed_c.numpy()
    scale = float(np.abs(c[..., :-1]).max())
    center_err = float(np.abs(g[..., :-1] - c[..., :-1]).max())
    wsum_rel = float(np.max(np.abs(g[..., -1] - c[..., -1]) / np.abs(c[..., -1]).clip(1e-30)))
    np.testing.assert_allclose(g[..., :-1], c[..., :-1], rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(g[..., -1], c[..., -1], rtol=1e-5)
    return dict(check="seeding", bins=B, rows_per_bin=P, zero_weight_rows=P - live,
                k=k, d=d, kmeanspp_rows_equal=True, cuda_bitwise_repeat=True,
                max_abs_center_err=center_err, max_rel_wsum_err=wsum_rel,
                cuda_first_s=first_s, cuda_s=cuda_s, cpu_s=cpu_s)


def _first_batch_members(data, edges):
    """Iteration 1's training members per WE bin (parent pcoord; basis,
    target and zero-weight rows excluded), the rows a first seeding batch
    holds."""
    import numpy as np

    d0 = data[0]
    x = np.asarray(d0["pcoords"])[:, 0, 0]
    keep = ~((x > 0.0) & (x < 1.0)) & ~((x > 9.0) & (x < 10.0)) & (d0["weights"] > 0)
    bins = np.clip(np.digitize(x[keep], edges) - 1, 0, len(edges) - 2)
    return np.bincount(bins, minlength=len(edges) - 1).tolist()


def _bitwise_equal_builds(a, b):
    import numpy as np

    return (np.array_equal(np.concatenate(a.dtrajs), np.concatenate(b.dtrajs))
            and a.JtargetSS == b.JtargetSS
            and [v.JtargetSS for v in a.validation_models]
            == [v.JtargetSS for v in b.validation_models])


def _counted(fn):
    """``fn()`` with every launch count reset first; returns (result,
    counts)."""
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa

    torch.cuda.synchronize()
    sa.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, sa.launch_counts()


def _check_build(name, model, counts):
    import numpy as np

    jv = [float(v.JtargetSS) for v in model.validation_models]
    require(counts["pair_assign"] > 0, f"{name}: pair_assign never launched")
    require(np.isfinite(model.JtargetSS) and model.JtargetSS > 0,
            f"{name}: JtargetSS = {model.JtargetSS}")
    require(len(jv) == 2 and all(np.isfinite(jv)) and min(jv) > 0,
            f"{name}: validation JtargetSS {jv}")
    return jv


def _wide_build():
    """(b) The default build on 11 x 100,000 segments, cold then warm."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_replicas

    t0 = time.perf_counter()
    data = generate_we_replicas(n_iterations=11, n_segments=12_500, n_replicas=8,
                                seed=17, processes=8)
    gen_s = time.perf_counter() - t0
    members = _first_batch_members(data, np.linspace(0, 10, 13))
    (cold_s, cold), counts_cold = _counted(lambda: _default_build(data, "cuda"))
    (warm_s, warm), counts = _counted(lambda: _default_build(data, "cuda"))
    jv = _check_build("wide build", warm, counts)
    families = warm._strat.seeded_by_family
    require(families["device"] >= 1, f"no bin seeded through the device family: {families}")
    require(_bitwise_equal_builds(cold, warm), "cold and warm wide builds are not bitwise equal")
    line = dict(check="wide_build", iterations=11, segments_per_iteration=len(data[0]["weights"]),
                replicas=8, generate_s=gen_s, first_batch_members_per_bin=members,
                seeded_by_family=families, seconds_cold=cold_s, seconds_warm=warm_s,
                cold_warm_bitwise_equal=True, stages=_stages(warm),
                clusters_before=int(warm.fluxMatrixRaw.shape[0]),
                clusters_after=int(warm.fluxMatrix.shape[0]),
                JtargetSS=float(warm.JtargetSS), validation_JtargetSS=jv,
                launch_counts=counts, launch_counts_cold=counts_cold)
    return line, counts


def _aggregated_parity():
    """(c) The aggregated default build on the card against the CPU at
    30 x 200: equal k-means++ rows; JtargetSS, validation JtargetSS and
    the flux to 1e-8 when no dtraj row flips (else only near-tie flips)."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_arrays

    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    _t, g = _default_build(small, "cuda", n_clusters=300, stratified=False)
    _t, c = _default_build(small, "cpu", n_clusters=300, stratified=False)
    require(np.array_equal(g.kmeans_init_index, c.kmeans_init_index),
            "aggregated k-means++ rows differ between the card and the CPU")
    dg, dc = np.concatenate(g.dtrajs), np.concatenate(c.dtrajs)
    flips = int((dg != dc).sum())
    res = dict(check="aggregated_parity", rows=int(len(dc)), kmeanspp_rows_equal=True,
               dtraj_flips=flips, JtargetSS_gpu=float(g.JtargetSS),
               JtargetSS_cpu=float(c.JtargetSS))
    if flips:
        require(flips <= 1e-3 * len(dc), f"{flips} dtraj rows flip GPU vs CPU")
        require(abs(g.JtargetSS - c.JtargetSS) <= 1e-3 * abs(c.JtargetSS),
                "aggregated JtargetSS differs between GPU and CPU builds")
        return res
    errs = {}
    for what, a, b in (
        ("JtargetSS", g.JtargetSS, c.JtargetSS),
        ("validation_JtargetSS", [v.JtargetSS for v in g.validation_models],
         [v.JtargetSS for v in c.validation_models]),
        ("fluxMatrixRaw", g.fluxMatrixRaw, c.fluxMatrixRaw),
        ("fluxMatrix", g.fluxMatrix, c.fluxMatrix),
    ):
        a, b = np.asarray(a, float), np.asarray(b, float)
        require(a.shape == b.shape, f"aggregated {what} shapes differ")
        errs[what] = _rel_err(a, b)
        require(errs[what] <= 1e-8, f"aggregated {what} differs GPU vs CPU by {errs[what]}")
    res["max_rel_err"] = errs
    return res


def _aggregated_build(data):
    """(c) The aggregated default build (300 clusters) on the analysis
    phase's 101 x 10,000 run (generated here when that phase did not
    run)."""
    from msm_we_tpu_torch.data import generate_we_arrays

    if data is None:
        data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
    (secs, model), counts = _counted(
        lambda: _default_build(data, "cuda", n_clusters=300, stratified=False))
    jv = _check_build("aggregated build", model, counts)
    line = dict(check="aggregated_build", segments=int(sum(len(d) for d in model.dtrajs)),
                n_clusters=300, seconds=secs, stages=_stages(model),
                clusters_before=int(model.fluxMatrixRaw.shape[0]),
                clusters_after=int(model.fluxMatrix.shape[0]),
                JtargetSS=float(model.JtargetSS), validation_JtargetSS=jv,
                launch_counts=counts)
    return line, counts


def _reduction_fit(data, n_atoms, method, device, **kw):
    """``dimReduce`` alone with ``method`` on ``device``; returns the model."""
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    m = modelWE(device=device)
    m.initialize(ArrayWEDataset(data), {"coords": None, "nAtoms": n_atoms, "coord_ndim": 3},
                 "fit", basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method=method, tau=1.0)
    m.get_iterations()
    m.dimReduce(**kw)
    return m


def _fit_error(method, got, want):
    """Largest difference of the fitted spectra (``scales_`` for TICA/VAMP,
    ``explained_variance_`` for batch PCA) from the CPU f64 fit."""
    import numpy as np

    attr = "explained_variance_" if method == "batch-pca" else "scales_"
    a, b = getattr(got.coordinates, attr), getattr(want.coordinates, attr)
    # The variance cutoff may fall one component apart where f32 rounding
    # moves a cumulative ratio across it; compare the common components
    n = min(len(a), len(b))
    require(abs(len(a) - len(b)) <= 1, f"{method}: {len(a)} vs {len(b)} components")
    err = float(np.abs(a[:n] - b[:n]).max())
    tol = 2e-4 + (1e-5 * float(np.abs(b).max()) if method == "batch-pca" else 0.0)
    require(err <= tol, f"{method} spectrum differs from the f64 fit by {err}")
    return err


def _build_ids_check(name, model):
    """The build's child features and final stratified bank through H4 and
    its plain version on the card: ids equal except at near-ties."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa

    strat, dev = model._strat, model.device
    X = torch.as_tensor(np.asarray(model._features["child"], np.float32), device=dev)
    eff = strat.we_remap[np.asarray(model._raw_we_bins()[1])]
    bins = torch.as_tensor(eff.astype(np.int32), device=dev)
    centers, _counts = strat._device_state()
    cb, valid, _init = strat._device_meta()
    bank = (centers.contiguous(), cb.to(torch.int32).contiguous(), valid)
    ids_k = sa.pair_assign(None, X, None, bins, *bank)
    ids_p = sa.pair_assign_plain(None, X, None, bins, *bank)
    torch.cuda.synchronize()
    return _compare_ids(name, "build", ids_k, ids_p, len(centers) + 2, X, bins, bank)


def _reduction_builds():
    """(d) TICA, VAMP and batch-PCA builds at 100 atoms (300 raw features:
    the device f32 pair moments; TICA and VAMP keep more than 128
    components, batch PCA all 300), each fit against the CPU f64 fit, with
    H4 launched on rows wider than 128 features, and the build's ids held
    to the plain version on its own features and bank."""
    from msm_we_tpu_torch.data import SynthWESettings, generate_trajectory_arrays

    lines, total = [], {}
    gen_s, wide = _timed(lambda: generate_trajectory_arrays(SynthWESettings(
        n_iterations=102, n_segments=1_000, n_atoms=100, seed=17, warmup=20)))
    for method in ("tica", "vamp", "batch-pca"):
        fit_s, g = _timed(lambda: _reduction_fit(wide, 100, method, "cuda"))
        ref = _reduction_fit(wide, 100, method, "cpu", device_moments=False)
        fit_err = _fit_error(method, g, ref)
        del g
        (secs, model), counts = _counted(lambda: _default_build(
            wide, "cuda", n_atoms=100, dimreduce_method=method))
        jv = _check_build(f"{method} build", model, counts)
        require(model.ndim > 128, f"{method}: {model.ndim} features, not the wide rows")
        err = _fit_error(method, model, ref)
        mism, ties = _build_ids_check(method, model)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        lines.append(dict(check="reduction_build", method=method, n_atoms=100,
                          raw_features=300, device_moments=True, ndim=int(model.ndim),
                          generate_s=gen_s, fit_s=fit_s, fit_max_abs_err_vs_f64=fit_err,
                          seconds=secs, stages=_stages(model),
                          max_abs_err_vs_f64=err, JtargetSS=float(model.JtargetSS),
                          validation_JtargetSS=jv, launch_counts=counts,
                          h4_id_mismatches=mism, h4_near_ties=ties))
        del model
    return lines, total


def phase_configs(args, summary):
    """The build's other configurations: device-family seeding, a wide
    stratified build, aggregated k-means, TICA/VAMP/batch PCA."""
    emit(dict(phase="configs", **_seeding_check()))
    total = {}
    line, counts = _wide_build()
    emit(dict(phase="configs", **line))
    runs = [counts]
    line, counts = _aggregated_build(summary.pop("analysis_data", None))
    emit(dict(phase="configs", **line))
    runs.append(counts)
    emit(dict(phase="configs", **_aggregated_parity()))
    lines, counts = _reduction_builds()
    for line in lines:
        emit(dict(phase="configs", **line))
    runs.append(counts)
    for c in runs:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    summary["launches_configs"] = total


# -------------------------------------------------------------------- run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="directory for the compiler log and the build traces")
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
    if "access" in phases:
        phase_access(args, summary, smi)
    summary.pop("bench_data", None)
    if "configs" in phases:
        phase_configs(args, summary)

    launches = summary.get("launches", {})
    launches_analysis = summary.get("launches_analysis", {})
    launches_configs = summary.get("launches_configs", {})
    launches_access = summary.get("launches_access", {})
    kernels = []
    for name, info in KERNEL_INFO.items():
        k = summary.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches.get(name),
            launches_analysis=launches_analysis.get(name),
            launches_configs=launches_configs.get(name),
            launches_access=launches_access.get(name),
            max_abs_err=k.get("max_abs_err"), ms=k.get("ms"),
            plain_ms=k.get("plain_ms"), bound_ms=k.get("bound_ms"),
            bound_by=k.get("bound_by"), library_ms=None, mm_ms=k.get("mm_ms"),
            kernel_ms=k.get("kernel_ms"),
        ))
    emit(dict(kernels=kernels))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind, count=count)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
