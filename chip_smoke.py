#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``msm_we_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,main,analysis,access,routes,mesh,plugins,configs,tail,route] [--out DIR]

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
   ``hot_step`` in both tiers and ``entry()`` at full size, each step one
   CUDA graph replay, then the haMSM
   build (``modelWE.build_analyze_model``) on a 101 x 1,000 synthetic WE
   run generated in memory, cold with ``device="cuda"``, then warm with
   ``modelWE()`` (the default device must be the card). Every kernel must
   have launched, but H2 where the step's bank takes the bin-grouped route
   (``entry.grouped_route``). A capture only records launches, so a graph's launches
   are counted in a ``torch.profiler`` trace of its replays (each kernel
   of the graph must show there); the wrappers count the captures'
   warm-ups and the builds. After that count, each tier's line times the
   graphed step, the eager one (``entry._hot_step``) and the
   parent's route (the eager launches with the early-exit tail, a host
   read a round) in turns, host clock around a synchronised step, and
   gives their CUDA-event ms, the eager routes' device ms and device
   operations (``torch.profiler``) beside the graph's lower bounds from
   the trace, the graphed step's enqueue ms, the launches a step and the
   flux's f32 order bound; ids must equal the eager ids bitwise, every flux
   lie within the order bound of the first eager step's, and the graphed
   ``pss``/JtargetSS equal the eager tail's on the same flux. Then the
   results are checked against references: the steady-state tail alone on
   each tier's flux in four graphs (no extra round, 16 ``torch.where``
   rounds, 16 conditional rounds, and the conditional rounds at ``tol =
   0`` where all 16 bodies run: times, device ops, the extra squarings of
   the early-exit loop), the hot step on a reduced
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
7. ``routes``: the opt-in device flux and stats route of a build, beside
   the default host route, both on the card, in the bench configuration
   (launch counts reset before the counted device-route builds; H3 and H4
   must launch). (a) At 101 x 10,000 (seed 17), each route cold then warm:
   the device route (both ``MSM_WE_TPU_DEVICE_*_MIN_ROWS`` knobs at 0, set
   here and restored) never materializes host ids, launches H3 once per
   flux call, and agrees with the host route in ``fluxMatrixRaw`` (1e-12
   of its largest entry), ``JtargetSS`` (1e-10), the cleaned cluster count,
   the sorted ``pSS`` and, after ``_ensure_discretized()``, the dtrajs; the
   differing positions of the pcoord sort are counted; stage seconds of
   both routes, H3's time with f64 weights against its bound, and the
   device-to-host bytes of the flux and cleaning stages from a trace.
   (b) Dyadic weights at 30 x 200: flux bitwise the host bincount's, on
   the card and against the CPU build. (c) Weights from 1e-300 to 1: every
   nonzero entry to 1e-12. (d) Aggregated clustering at 1.01M, 300
   clusters, through ``_force_device_flux`` (H3 on one bin). (e) The same
   two routes at 101 x 100,000 (8 stacked replicas; ``--big-segments``):
   stage seconds, H3's device time and bound, peak device memory.
   (f) ``cluster_stats`` on the card against host f64 statistics. (g)
   ``optimization``: the discrepancy solve on the 1.01M model, both bin
   functions, an ``OptimizedBinMapper`` assigning 100,000 extended pcoords
   (H4) and its bytestring round trip onto the card. (h) ``plotting``: the
   coarse flux profile; importing the module pulls in no matplotlib; the plots on the
   ``Agg`` backend where matplotlib imports, else the ``ImportError``.
   (i) Index widths: H3 and H4 on 10,100,000 rows a set of 300 features
   (row offsets beyond 2^31 elements): H4's ids equal H3's raw ids bitwise,
   the first and last 65,536 rows equal the plain version except at
   near-ties, and the dyadic f64 flux is bitwise the scatter of H3's ids.
   (j) At 30 x 200 with deferred ids and the row knobs unset, the forced
   device flux mints the dtrajs from H3's ids: bitwise ``pair_discretize``'s,
   with disjoint and with overlapping basis and target regions. In (a), (d)
   and (e) H3 is also held against its plain version in row chunks.
8. ``configs``: the build's other configurations. (a) Device-family
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
9. ``mesh``: ``parallel/`` on ``torch.distributed``. (a) H4 with and
   without its score output (``return_scores``) at the kernel table's
   regimes (K = 250, 3,200, one bin of 300, F = 300): ids bitwise equal,
   scores against the plain version's where ids agree, times and device
   times of both forms and the bound with the scores' 4 bytes a row.
   (b) One NCCL rank (a process group of one): the bench build at 101 x
   10,000 with both device routes on (``MSM_WE_TPU_DEVICE_*_MIN_ROWS=0``)
   and ``enable_mesh()``, against the no-mesh device route of the same
   data (dtrajs equal, flux and JtargetSS within 1e-12), launch counts
   reset before it; the one-rank mesh step against ``fused_step_single``
   (flux bitwise, both times). (c) ``entry.dryrun_multichip`` on 2 ranks
   (meshes (1, 2), (2, 1)) and 4 ranks ((2, 2), (4, 1)) over gloo, the
   ranks sharing the card: the hot step's problem at K = 250 and 3,200
   and the awkward shapes, ids and dyadic flux bitwise the one-rank ones.
   (d) ``launch_local_dryrun`` on the same four meshes (each rank reads
   only its shard): the flux bitwise the one-rank flux. The phase's launch
   counts add the NCCL build's and every rank's; H3, H4 and H4's score
   form must launch.
10. ``plugins`` (runs before ``configs``): ``extended``, the CLI and the
   WESTPA drivers on the card, the launch counts reset before each counted
   part; H4 must launch in each of (a)-(c). (a) ``ExtendedModelWE`` built
   by the default build on the ``analysis`` data (101 x 10,000), its
   JtargetSS bitwise a plain ``modelWE`` build's; then ``get_hflux``,
   ``get_model_aristoffian``, the kh bins of the ``adaptive`` (k-means on
   the card), ``uniform`` and ``log_uniform`` methods,
   ``get_iter_aristoffian`` of the last iteration (10,000 rows through H4),
   ``evolve_probability`` and the 1-D pcoord flux; the same calls at 30 x
   200 on the card and on the CPU: ids equal except at near-ties, h, kh,
   varh and the relaxed distribution within 1e-12 relative, every evolved
   distribution summing to 1. (b) The CLI: ``info`` names the card;
   ``generate`` and ``build`` with and without ``--device-pipeline`` (JSON
   equal to the API sequence) where h5py imports, else ``build`` raises the
   ``ImportError`` naming h5py; ``validate`` of (a)'s 30 x 200 card model
   saved with its ids deferred (the command mints them on the card) equal
   to the implied timescales and CK test of the in-memory model within
   1e-12; ``set_topology``/``set_basis`` of a ``.dat`` file, and of a
   ``.prmtop`` path without mdtraj the ``ImportError`` naming it. (c) The
   drivers over the 101 x 10,000 run: ``build_hamsm_from_config`` bitwise
   equal to ``build_analyze_model`` with the same arguments,
   ``update_cluster_structures`` and ``start_state_entries`` (weights
   summing to the clusters' pSS within 1e-6), ``write_restart_artifacts``
   into a temporary directory, ``compute_optimized_bins_for_model`` and the
   WESTPA wrapper under an in-process ``FuncBinMapper`` stand-in: its args
   through a plain pickle round trip assign 100,000 extended pcoords on the
   card, bitwise the live mapper's; ``compute_new_pcoord_map`` on 1,000
   structures.
11. ``tail``: the steady-state tail above ``ops.steady_tail.S_MAX``, on the
   flux matrix of the ``ntl9_100k.bins128`` cell's step (``make_problem``
   seed 0, 128 bins x 25: 3,202 states), which an f32 matrix takes in
   float64 (``ops.steady_tail.tail_dtype``) with its row passes on the
   kernels of ``ops/tail_rows.py``: the step's graph must show them in a
   trace of its replays (``bins128_step``), then one
   ``steady_state_rounds`` line, as the ``main`` phase's for the tail
   kernel, with the float64 route's forms (also with the PyTorch row
   passes), its device ms and bound, the f32 tail beside it
   (``_tail_rounds``), and the row kernels' device ms and byte floors at 0
   and 16 rounds (``row_kernels``).
12. ``route``: first the ``transform_stream`` line: the features-only
   transform of the main path's two raw sets by the streaming kernel
   (``transform_features``, both sets in one launch and one set alone)
   against the two features-only H1 launches it replaced, bitwise equal,
   each form's device ms by the profiler and a replay of its own CUDA
   graph by events beside its byte bound, the grouped route's graph with
   either transform, and the ptxas lines of the new kernel. Then the
   ``two_transform`` step's assignment and flux by H2 and by the
   bin-grouped route (the streaming transform, then H3 on H2's ``c2adj``)
   at 1 to 128 bins of 25 centers (``ROUTE_BINS``, or ``--route-bins``)
   (``make_problem()``'s rows): ids and the dyadic flux bitwise equal,
   each route's device ms a replay of its own CUDA graph by events, the
   route ``entry.grouped_route`` takes; the sweep that set
   ``entry.GROUPED_MIN_OFF_BIN``.

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

PHASES = ("device", "build", "kernels", "main", "analysis", "access", "routes",
          "mesh", "plugins", "configs", "tail", "route")

KERNEL_INFO = {
    "transform_assign_child": dict(
        pallas="H1", replaces="msm_we_tpu/ops/pallas_kernels.py:546",
        source="msm_we_tpu_torch/csrc/stratified_assign.cu"),
    "transform_assign": dict(
        pallas="H2", replaces="msm_we_tpu/ops/pallas_kernels.py:377",
        source="msm_we_tpu_torch/csrc/stratified_assign.cu"),
    # H1's transform alone, both raw sets a launch; timed by the route
    # phase's transform_stream line
    "transform_features": dict(
        pallas="none", replaces="msm_we_tpu/ops/pallas_kernels.py:546",
        source="msm_we_tpu_torch/csrc/transform_features.cu"),
    "assign_flux": dict(
        pallas="H3", replaces="msm_we_tpu/ops/pallas_kernels.py:248",
        source="msm_we_tpu_torch/csrc/assign_flux.cu"),
    "pair_assign": dict(
        pallas="H4", replaces="msm_we_tpu/ops/pallas_kernels.py:203",
        source="msm_we_tpu_torch/csrc/pair_assign.cu"),
    # H4's score form (return_scores=True): the mesh's model axis
    "pair_assign_scores": dict(
        pallas="H4", replaces="msm_we_tpu/ops/pallas_kernels.py:203",
        source="msm_we_tpu_torch/csrc/pair_assign.cu"),
    # The steady-state tail: no Pallas call, XLA's while_loop in the JAX
    # package; timed by the main and tail phases' steady_state_rounds lines
    "steady_tail": dict(
        pallas="none", replaces="msm_we_tpu/parallel/sharded.py:538",
        source="msm_we_tpu_torch/csrc/steady_tail.cu"),
    # The float64 tail's row passes above S_MAX (XLA's in the JAX package);
    # timed by the tail phase's row_kernels line
    "tail_renorm": dict(
        pallas="none", replaces="msm_we_tpu/parallel/sharded.py:538",
        source="msm_we_tpu_torch/csrc/tail_rows.cu"),
    "tail_transition": dict(
        pallas="none", replaces="msm_we_tpu/parallel/sharded.py:538",
        source="msm_we_tpu_torch/csrc/tail_rows.cu"),
}
# Published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores (every assignment stays exact f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# and f64 FLOP/s of the tensor cores (the steady-state tail above S_MAX)
F64_FLOPS = 67e12


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
        # The features alone (the hot step's grouped route and dedup tier):
        # the streaming kernel up to 32 features, else H1's features-only
        # launch
        g_f = sa.transform_features(raw_c, None, proj)[0]
        require(torch.equal(g_f, g_k), f"H1 [{regime}] features-only transform differs")
        del g_f
        fdms = device_ms(lambda: sa.transform_features(raw_c, None, proj),
                         "transform_features_kernel" if sa.features_stream_fits(D, Fx)
                         else "stratified_assign_kernel", reps)
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


# The wrappers each graph of the main path calls (a two_transform step
# whose bank takes the bin-grouped route, ``entry.grouped_route``: the
# streaming transform and H3), and the tail phase's 128-bin step (3,202
# states: the float64 tail's row kernels)
GRAPH_KERNELS = {"two_transform": ("transform_assign", "steady_tail"),
                 "two_transform_grouped": ("transform_features", "assign_flux",
                                           "steady_tail"),
                 "dedup": ("transform_features", "assign_flux", "steady_tail"),
                 "entry": ("assign_flux", "steady_tail"),
                 "bins128": ("transform_features", "assign_flux",
                             "tail_transition", "tail_renorm")}


def _step_profile(fn, reps):
    """``torch.profiler`` over ``reps`` runs of ``fn``: device ms and device
    operations (kernels, copies, sets) a run, ms None where the trace shows
    no device event, and the launches of each of the port's kernels in the
    trace, by kernel name (``sa.KERNEL_SYMBOLS``). The profiler can drop
    events of a graph's replays, so for a graph each is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msm_we_tpu_torch.ops import stratified_assign as sa

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in evs)
    kernels = {sym: sum(sym in e.name for e in evs)
               for sym in set(sa.KERNEL_SYMBOLS.values())}
    return (us / 1e3 / reps if us > 0 else None), len(evs) / reps, kernels


def _graphed_run(fn, reps, graph, graph_launches):
    """The main path's run of a graphed step: ``fn()`` once (warm-up,
    capture and a replay at a new key), then ``reps`` replays under
    ``torch.profiler``. The kernels of ``GRAPH_KERNELS[graph]`` must show
    in that trace; their traced launches are added to ``graph_launches``.
    Returns the last output and the trace's lower bounds a replay."""
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa

    fn()
    torch.cuda.synchronize()
    out = []
    dev_ms, ops, kernels = _step_profile(lambda: out.append(fn()), reps)
    for name in GRAPH_KERNELS[graph]:
        n = kernels[sa.KERNEL_SYMBOLS[name]]
        require(n > 0, f"kernel {name} never launched in {reps} replays of "
                       f"the {graph} graph (torch.profiler trace)")
        graph_launches[name] += n
    return out[-1], dict(
        device_ms_lower_bound=dev_ms, device_ops_lower_bound=ops,
        traced_launches={name: kernels[sa.KERNEL_SYMBOLS[name]] / reps
                         for name in GRAPH_KERNELS[graph]})


def _synced_ms(fn, reps, outs):
    """Host milliseconds of ``reps`` synchronised runs of ``fn``; each
    run's output is appended to ``outs``."""
    import torch

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _max_dev(outs, ref, key):
    return max(float((o[key].double() - ref[key].double()).abs().max())
               for o in outs)


def _tail_rounds(fm, reps):
    """The steady-state tail alone on ``fm``, each form captured into a
    CUDA graph of its own. The PyTorch tail (the route above
    ``ops.steady_tail.S_MAX``): with no extra round; with
    ``max_extra_squarings`` (16) rounds guarded by ``torch.where`` (every
    round runs its kernels); with the rounds as conditional nodes (a round
    after convergence launches no squaring); and the conditional nodes at
    ``tol = 0``, below the residual floor, so that all 16 bodies run (what a
    step whose tail does not converge pays). Each must equal the plain
    early-exit loop's ``T``, ``p``, JtargetSS and residual at the same
    ``tol`` bitwise (but for ``none``). The tail kernel (``fused``, and
    ``fused_taken`` at ``tol = 0``): its replay must equal the eager
    kernel bitwise, the early-exit loop within
    ``testing.tail_order_excess``, and its residual must lie within
    ``testing.tail_residual_excess`` of its own ``T`` and ``p`` and on the
    loop's side of ``tol``; its line adds the kernel's device ms, its bound
    (f32 operations of the squarings taken over 67 TFLOP/s, or the flux
    matrix in and T out over 3.35 TB/s) and the plain version's ms (the
    PyTorch tail with ``torch.where`` rounds, eagerly). Replay ms (CUDA events), the trace's device
    ms and operations (lower bounds); the extra squarings the loop and the
    kernel took at each ``tol``. Above ``S_MAX`` the forms are the
    float64 route's (:func:`_tail_rounds_f64`)."""
    import torch

    from msm_we_tpu_torch import _graph, step
    from msm_we_tpu_torch.ops import steady_tail as st
    from msm_we_tpu_torch.testing import (
        steady_state_early_exit,
        tail_order_excess,
        tail_residual_excess,
    )

    S = fm.shape[0]
    if not st.uses_kernel(fm.device, fm.dtype, S):
        return _tail_rounds_f64(fm, reps)
    ids = torch.arange(S, device=fm.device)
    basis, target = ids == S - 2, ids == S - 1
    ref = {tol: steady_state_early_exit(fm, basis, target, tol=tol)
           for tol in (1e-6, 0.0)}
    fused_rounds = {tol: int(st.steady_tail(fm, basis, target, tol=tol)[4])
                    for tol in (1e-6, 0.0)}
    res = dict(n_states=S, extra_squarings=ref[1e-6][4],
               extra_squarings_tol_0=ref[0.0][4],
               fused_extra_squarings=fused_rounds[1e-6],
               fused_extra_squarings_tol_0=fused_rounds[0.0])
    require(ref[0.0][4] == 16 and fused_rounds[0.0] == 16,
            f"the early-exit loop and the kernel took {ref[0.0][4]} and "
            f"{fused_rounds[0.0]} extra squarings at tol = 0, not 16")

    def torch_tail(rounds, n=16, tol=1e-6):
        return lambda: step._steady_state(fm, basis, target, 512, tol, n,
                                          rounds, fm.dtype)

    def kernel(tol):
        return lambda: st.steady_tail(fm, basis, target, tol=tol)[:4]

    where = torch_tail(step._where_rounds)
    forms = {"none": (torch_tail(step._where_rounds, 0), 1e-6),
             "where": (where, 1e-6),
             "conditional": (torch_tail(step._rounds), 1e-6),
             "conditional_taken": (torch_tail(step._rounds, tol=0.0), 0.0),
             "fused": (kernel(1e-6), 1e-6),
             "fused_taken": (kernel(0.0), 0.0)}
    for form, (eager, tol) in forms.items():
        cap = _graph.capture(eager, (), fm.device)
        got = cap.replay()
        dev_ms, ops, _k = _step_profile(cap.replay, reps)
        line = dict(ms=cuda_ms(cap.replay, reps), device_ms_lower_bound=dev_ms,
                    device_ops_lower_bound=ops,
                    p_diff=float((got[1] - ref[tol][1]).abs().max()))
        if form.startswith("fused"):
            line["bitwise_eager"] = all(
                torch.equal(g, e) for g, e in zip(got, eager()))
            line["excess"] = dict(tail_order_excess(got, ref[tol][:4]),
                                  **tail_residual_excess(got, ref[tol], tol))
            n = 9 + fused_rounds[tol]
            t_ops = n * 2.0 * S ** 3 / F32_FLOPS
            t_bytes = 2 * 4.0 * S * S / HBM_BYTES_PER_S
            line.update(
                kernel_ms=device_ms(eager, "steady_tail_kernel", reps),
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                plain_ms=cuda_ms(torch_tail(step._where_rounds, tol=tol), reps))
            require(line["bitwise_eager"] and all(
                v <= 0 for v in line["excess"].values()),
                f"tail [{form}] at S = {S}: replay bitwise the eager kernel "
                f"{line['bitwise_eager']}, excess over the bounds of the "
                f"early-exit loop and of its own residual {line['excess']}")
        else:
            line["bitwise"] = all(torch.equal(g, r) for g, r in zip(got, ref[tol][:4]))
            require(line["bitwise"] or form == "none",
                    f"tail [{form}] differs from the early-exit loop (p by "
                    f"{line['p_diff']})")
        res[form] = line
    return res


def _f32_tail(fm, basis, target, tol, rounds):
    """The parent's PyTorch tail of an f32 ``fm`` above ``S_MAX``: the
    float64 route's steps in f32, its fixed squarings on rows of ``S``
    floats as the parent laid them out, its extra squarings taken by
    ``rounds`` (``step._where_rounds`` or ``step._rounds``)."""
    from msm_we_tpu_torch import step
    from msm_we_tpu_torch._device import f64_threshold

    T = step._transition_matrix(fm, basis, target)
    Tn = T
    for _ in range(step._fixed_squarings(512)):
        Tn = Tn @ Tn
        Tn = Tn / Tn.sum(1, keepdim=True).clamp(min=1e-30)
    p, residual = step._stationary(Tn, T)
    Tn, p, residual = rounds(Tn, p, residual, T, f64_threshold(tol, fm.dtype), 16)
    return T, p, step._target_flux(T, p, target), residual


def _tail_rounds_f64(fm, reps):
    """The steady-state tail of an f32 ``fm`` of more than ``S_MAX`` states,
    which takes it in float64 (``ops.steady_tail.tail_dtype``) with its
    row passes on ``ops/tail_rows.py``'s kernels, each form captured into
    a CUDA graph of its own: 16 rounds guarded by ``torch.where``
    (``where``), the rounds as conditional nodes (``conditional``), those
    at ``tol = 0`` where all 16 bodies run (``conditional_taken``), and the
    last two with the PyTorch row passes (``torch_rows``,
    ``torch_rows_taken``: the route before the row kernels). Each must lie
    within its f32 rounding and 1e-12 of the float64 early-exit loop at the
    same ``tol`` (``bitwise``: whether it equals that loop's outputs cast
    to f32). The ``conditional`` form's line adds the tail's device ms by
    the event nodes of its traced graph (``tracing.collect()``: what
    ``step.tail_device_ms`` reads), their rounds and row-route replays, its
    bound (float64 operations of the squarings taken over 67 TFLOP/s, or
    each squaring's operand and product over 3.35 TB/s), and the f32 tail
    beside it: eagerly (``plain_ms``: 16 ``torch.where`` rounds) and as a
    graph of conditional nodes (``f32_graph_ms``), with the extra squarings
    of the f32 early-exit loop. ``row_kernels`` (:func:`_row_kernels`)
    times the row kernels alone."""
    import functools

    import torch

    from msm_we_tpu_torch import _graph, step, tracing
    from msm_we_tpu_torch.ops import steady_tail as st
    from msm_we_tpu_torch.testing import (
        f32_rounding_excess,
        steady_state_early_exit,
    )

    S = fm.shape[0]
    require(st.tail_dtype(fm.dtype, S) == torch.float64,
            f"tail at S = {S}: an f32 flux matrix above S_MAX must take the "
            f"float64 route")
    ids = torch.arange(S, device=fm.device)
    basis, target = ids == S - 2, ids == S - 1
    ref = {tol: steady_state_early_exit(fm.double(), basis, target, tol=tol)
           for tol in (1e-6, 0.0)}
    f32_rounds = steady_state_early_exit(fm, basis, target)[4]
    res = dict(n_states=S, route="float64", extra_squarings=ref[1e-6][4],
               extra_squarings_tol_0=ref[0.0][4],
               f32_extra_squarings=f32_rounds)
    require(ref[0.0][4] == 16, f"the float64 early-exit loop took "
                               f"{ref[0.0][4]} extra squarings at tol = 0")

    def route(rounds, tol, rows=True):
        return lambda: step._steady_state(fm, basis, target, 512, tol, 16,
                                          rounds, torch.float64, rows)

    forms = {"where": (route(step._where_rounds, 1e-6), 1e-6),
             "conditional": (route(step._rounds, 1e-6), 1e-6),
             "conditional_taken": (route(step._rounds, 0.0), 0.0),
             "torch_rows": (route(step._rounds, 1e-6, False), 1e-6),
             "torch_rows_taken": (route(step._rounds, 0.0, False), 0.0)}
    for form, (fn, tol) in forms.items():
        cap = _graph.capture(fn, (), fm.device)
        got = cap.replay()
        r = ref[tol]
        dev_ms, ops, _k = _step_profile(cap.replay, reps)
        line = dict(ms=cuda_ms(cap.replay, reps), device_ms_lower_bound=dev_ms,
                    device_ops_lower_bound=ops,
                    p_diff=float((got[1].double() - r[1]).abs().max()),
                    bitwise=all(torch.equal(g, x.float()) for g, x in zip(got, r[:4])),
                    rounding_excess=f32_rounding_excess(got, r[:4]))
        require(all(g.dtype == torch.float32 for g in got)
                and line["rounding_excess"] <= 1e-12,
                f"tail [{form}] at S = {S}: the float64 route lies "
                f"{line['rounding_excess']} beyond its f32 rounding of the "
                f"float64 early-exit loop")
        res[form] = line
    traced = _graph.capture(
        functools.partial(step.steady_state_from_flux, fm, basis, target),
        (), fm.device, traced=True)
    col = tracing.Collector()
    for _ in range(reps):
        col.using(traced)
        traced.launch()
    col.close()
    tail_ms = sorted(col.device_ms["tail"])
    n = step._fixed_squarings(512) + res["extra_squarings"]
    t_ops = n * 2.0 * S ** 3 / F64_FLOPS
    t_bytes = n * 2 * 8.0 * S * S / HBM_BYTES_PER_S
    f32_where = functools.partial(_f32_tail, fm, basis, target, 1e-6,
                                  step._where_rounds)
    f32_graph = _graph.capture(functools.partial(
        _f32_tail, fm, basis, target, 1e-6, step._rounds), (), fm.device)
    _d, _o, traced_kernels = _step_profile(traced.launch, reps)
    res["conditional"].update(
        tail_device_ms=tail_ms[len(tail_ms) // 2],
        traced_rounds=col.counts["tail_rounds"] / reps,
        traced_f64=col.counts.get("tail_f64", 0) / reps,
        traced_rows=col.counts.get("tail_rows", 0) / reps,
        traced_row_launches={k: traced_kernels[k] / reps for k in (
            "tail_transition_kernel", "tail_renorm_kernel")},
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops > t_bytes else "bytes",
        plain_ms=cuda_ms(f32_where, reps),
        f32_graph_ms=cuda_ms(f32_graph.replay, reps))
    require(res["conditional"]["traced_rounds"] == res["extra_squarings"]
            and res["conditional"]["traced_f64"] == 1
            and res["conditional"]["traced_rows"] == 1,
            f"tail at S = {S}: the traced graph counted "
            f"{res['conditional']['traced_rounds']} rounds a replay (the "
            f"float64 loop {res['extra_squarings']}), "
            f"{res['conditional']['traced_f64']} float64 and "
            f"{res['conditional']['traced_rows']} row-kernel replays a replay")
    require(all(v > 0 for v in res["conditional"]["traced_row_launches"].values()),
            f"tail at S = {S}: the row kernels are missing from the trace of "
            f"the traced graph's replays: {res['conditional']['traced_row_launches']}")
    res["row_kernels"] = _row_kernels(fm, basis, target, reps)
    return res


def _row_kernels(fm, basis, target, reps):
    """The float64 tail's row kernels on ``fm`` (``ops/tail_rows.py``), in
    the eager tail with 0 and with 16 guarded rounds (9 and 25 squarings):
    each kernel's device ms a launch (``torch.profiler``) beside its byte
    floor over 3.35 TB/s (the renormalisation reads and writes the S x S
    f64 matrix once; the transition pass reads the flux and writes T in
    f64 and its copy in the flux's dtype), and the tail's device ms in all,
    in its DGEMMs (``gemm`` kernels) and outside them, with the row kernels
    and with the PyTorch row passes."""
    import torch

    from msm_we_tpu_torch import step

    S = fm.shape[0]
    sq = float(S) * S
    out = dict(renorm_floor_ms=2 * 8 * sq / HBM_BYTES_PER_S * 1e3,
               transition_floor_ms=(fm.element_size() * 2 + 8) * sq
               / HBM_BYTES_PER_S * 1e3)
    for n in (0, 16):
        def tail(rows):
            return lambda: step._steady_state(fm, basis, target, 512, 1e-6, n,
                                              step._where_rounds,
                                              torch.float64, rows)

        line = dict(
            renorm_ms=device_ms(tail(True), "tail_renorm_kernel", reps)
            / (step._fixed_squarings(512) + n),
            transition_ms=device_ms(tail(True), "tail_transition_kernel", reps))
        for rows, name in ((True, "rows"), (False, "torch")):
            total = _step_profile(tail(rows), reps)[0]
            gemm = device_ms(tail(rows), "gemm", reps)
            line.update({f"{name}_device_ms": total, f"{name}_gemm_ms": gemm,
                         f"{name}_other_ms": total - gemm})
        out[f"rounds_{n}"] = line
    return out


# ------------------------------------------------------------------ route

ROUTE_BINS = (1, 2, 3, 4, 6, 8, 10, 16, 24, 32, 48, 64, 128)  # of 25 centers


def _queued_replay_ms(launch, n):
    """Device milliseconds of one ``launch()`` of a captured graph: ``n``
    launches queued behind a spin kernel, between CUDA events, so no host
    time is in it."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(int(2e7))  # ~10 ms at 2 GHz: the replays queue meanwhile
    ev[1].record()
    t = time.perf_counter()
    for _ in range(n):
        launch()
    queued_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    require(queued_ms < ev[0].elapsed_time(ev[1]),
            "the spin ended before the replays were queued")
    return ev[1].elapsed_time(ev[2]) / n


def _peak_mb(fn):
    """Device memory a run of ``fn`` holds at its peak above what was
    allocated before it, in MB."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _ptxas_of(kernel):
    """The compiler's register and spill lines for each instantiation of
    ``kernel`` in this process's build log (empty where the library was
    loaded, not built)."""
    from msm_we_tpu_torch.ops import _ext

    out, cur = {}, None
    for ln in _ext.build_info.get("log", "").splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if kernel in ln else None
            if cur is not None:
                out[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.strip())
    return out


def _stream_transform(args, summary):
    """The main path's features-only transform (``make_problem()``: two
    sets of 102,400 x 900 raw rows, P to 30 features) by the streaming
    kernel, both sets in one launch and one set alone, against the two
    features-only H1 launches it replaced (bitwise equal). Each form's
    device ms by the profiler and as a replay of its own CUDA graph (the
    median of five turns of 20 replays queued behind a spin, the forms
    alternating), beside its byte bound (rows and P read, features written
    once); the 10-bin grouped route's graph with either transform."""
    import numpy as np
    import torch

    from msm_we_tpu_torch import _graph, entry
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.testing import make_problem

    dev = torch.device("cuda")
    s = entry.stage_problem(make_problem(), "two_transform", dev)
    # Dyadic weights: the f32 flux is exact in any order of the atomics
    w = np.random.default_rng(19).integers(1, 17, len(s["w"])) / 16.0
    s["w"] = torch.as_tensor(w, dtype=torch.float32, device=dev)
    rp, rc, comp = s["raw_parent"], s["raw_child"], s["comp"]
    N, D = rc.shape
    F = comp.shape[1]
    bank = (s["centers"], s["center_bin"], s["valid"])
    S = s["n_states"]
    require(sa.features_stream_fits(D, F), "the main path's shape does not stream")

    def h1(raw):  # H1's features-only launch, as the parent ran it
        g = torch.empty((N, F), dtype=torch.float32, device=dev)
        sa._h1_features(raw, comp, g)
        return g

    rows = (s["pbins"], s["cbins"], s["w"], s["basis_p"], s["basis_c"],
            s["target_c"])
    a2 = sa.c2adj(s["mean"], comp, s["centers"]).contiguous()
    forms = {
        "stream_both": lambda: sa.transform_features(rp, rc, comp),
        "stream_one": lambda: sa.transform_features(rc, None, comp),
        "h1_pair": lambda: (h1(rp), h1(rc)),
        "h1_one": lambda: h1(rc),
        "grouped_stream": lambda: entry._two_transform(s, True),
        "grouped_h1": lambda: sa.assign_flux(h1(rp), h1(rc), *rows, *bank, S, c2=a2),
    }
    (gp, gc), (hp, hc) = forms["stream_both"](), forms["h1_pair"]()
    require(torch.equal(gp, hp) and torch.equal(gc, hc),
            "the streaming transform differs from H1's features")
    require(torch.equal(forms["stream_one"]()[0], hc),
            "the streaming transform of one set differs from H1's features")
    new, old = forms["grouped_stream"](), forms["grouped_h1"]()
    require(all(torch.equal(x, y) for x, y in zip(new, old)),
            "the grouped route's ids or flux moved with the streaming transform")
    del gp, gc, hp, hc, new, old
    graphs = {name: _graph.capture(fn, (), dev) for name, fn in forms.items()}
    times = {name: [] for name in forms}
    names = list(forms)
    for turn in range(5):
        for name in (names if turn % 2 == 0 else names[::-1]):
            times[name].append(_queued_replay_ms(graphs[name].launch, 20))
    del graphs
    feats = torch.empty((N, F), dtype=torch.float32, device=dev)
    one_bound = _bound([rc, comp, feats], 2 * N * D * F)
    both_bound = _bound([rp, rc, comp, feats, feats], 4 * N * D * F)
    kernel = {"stream_both": "transform_features_kernel",
              "stream_one": "transform_features_kernel",
              "h1_pair": "stratified_assign_kernel",
              "h1_one": "stratified_assign_kernel"}
    line = dict(phase="transform_stream", n=int(N), D=int(D), F=int(F),
                bitwise=True, grouped_ids_flux_bitwise=True,
                one_bound_ms=one_bound[0], one_bound_by=one_bound[1],
                both_bound_ms=both_bound[0], both_bound_by=both_bound[1],
                ptxas=_ptxas_of("transform_features_kernel"))
    for name in forms:
        line[name + "_graph_ms"] = _median(times[name])
        line[name + "_graph_ms_all"] = times[name]
    for name, sym in kernel.items():
        line[name + "_kernel_ms"] = device_ms(forms[name], sym, args.reps)
    for name, bound in (("stream_both", both_bound), ("stream_one", one_bound),
                        ("h1_pair", both_bound), ("h1_one", one_bound)):
        line[name + "_byte_share"] = bound[0] / line[name + "_graph_ms"]
    emit(line)
    summary["transform_features"] = dict(
        ms=line["stream_both_graph_ms"], kernel_ms=line["stream_both_kernel_ms"],
        bound_ms=both_bound[0], bound_by=both_bound[1], max_abs_err=0.0)
    del s, forms, feats
    torch.cuda.empty_cache()


def phase_route(args, summary):
    """The ``two_transform`` step's assignment and flux by both routes
    (``entry._two_transform``): H2 alone, and the bin-grouped route (two
    features-only H1 launches, then H3 on H2's ``c2adj``), on
    ``make_problem()``'s rows at each of ``ROUTE_BINS`` bins of 25 centers.
    Ids and the dyadic f32 flux must be bitwise equal between the routes.
    Each route is captured into a CUDA graph of its own, and its device ms
    a replay is the median of five turns of 20 replays queued behind a
    spin, the routes alternating. Beside them: which route
    ``entry.grouped_route`` takes, each route's kernels' device ms
    (``torch.profiler``), its CUDA-event ms as eager launches, its bound
    (bytes over 3.35 TB/s or f32 FLOPs over 67 TFLOP/s; the grouped route
    also writes and reads the features once) and the memory it holds above
    the staged problem. The crossover sets
    ``entry.GROUPED_MIN_OFF_BIN``. The ``transform_stream`` line comes
    first (:func:`_stream_transform`)."""
    import numpy as np
    import torch

    from msm_we_tpu_torch import _graph, entry
    from msm_we_tpu_torch.testing import make_problem

    _stream_transform(args, summary)
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    lines = []
    for n_bins in args.route_bins:
        p = make_problem(n_bins=n_bins)
        s = entry.stage_problem(p, "two_transform", dev)
        del p
        N, D = s["raw_child"].shape
        F = s["comp"].shape[1]
        K = s["centers"].shape[0]
        S = s["n_states"]
        bank = (s["centers"], s["center_bin"], s["valid"])
        # Dyadic weights: the f32 flux is exact in any order of the atomics
        sd = dict(s, w=torch.as_tensor(rng.integers(1, 17, N) / 16.0,
                                       dtype=torch.float32, device=dev))
        h2, grouped = (entry._two_transform(sd, g) for g in (False, True))
        for a, b, what in zip(h2, grouped, ("pidx", "cidx", "fm")):
            require(torch.equal(a, b),
                    f"route [{n_bins} bins]: {what} differs between H2 and "
                    f"the bin-grouped route")
        del sd, h2, grouped
        routes = {False: lambda: entry._two_transform(s, False),
                  True: lambda: entry._two_transform(s, True)}
        graphs = {g: _graph.capture(fn, (), dev) for g, fn in routes.items()}
        times = {False: [], True: []}
        for turn in range(5):
            for g in ((False, True) if turn % 2 == 0 else (True, False)):
                times[g].append(_queued_replay_ms(graphs[g].launch, 20))
        del graphs
        pairs = _same_bin_pairs(s["pbins"], bank) + _same_bin_pairs(s["cbins"], bank)
        fm32 = torch.empty((S, S), dtype=torch.float32, device=dev)
        ids = torch.empty(2 * N, dtype=torch.int32, device=dev)
        inputs = [s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"],
                  s["w"], s["basis_p"], s["basis_c"], s["target_c"], s["mean"],
                  s["comp"], *bank, ids, fm32]
        feats = torch.empty((2, N, F), dtype=torch.float32, device=dev)
        flops = 4 * N * D * F + 2 * pairs * F
        line = dict(
            phase="route", n_bins=n_bins, K=int(K), n=int(N),
            off_bin=float(K - K / n_bins), rule_grouped=bool(s["grouped"]),
            ids_bitwise=True, flux_bitwise=True,
            h2_graph_ms=_median(times[False]), grouped_graph_ms=_median(times[True]),
            h2_graph_ms_all=times[False], grouped_graph_ms_all=times[True],
            h2_ms=cuda_ms(routes[False], args.reps),
            grouped_ms=cuda_ms(routes[True], args.reps),
            h2_kernel_ms=device_ms(routes[False], "stratified_assign_kernel",
                                   args.reps),
            grouped_transform_ms=device_ms(routes[True], "transform_features_kernel",
                                           args.reps),
            grouped_h3_ms=device_ms(routes[True], "assign_flux_kernel", args.reps),
            grouped_plan_ms=device_ms(routes[True], "plan_", args.reps),
            h2_bound=_bound(inputs, flops),
            grouped_bound=_bound(inputs + [feats, feats], flops),
            h2_peak_mb=_peak_mb(routes[False]),
            grouped_peak_mb=_peak_mb(routes[True]))
        line["faster"] = ("grouped" if line["grouped_graph_ms"] < line["h2_graph_ms"]
                          else "h2")
        emit(line)
        lines.append(line)
        del s, routes, inputs, feats, fm32, ids
        torch.cuda.empty_cache()
    # The least count of centers outside a row's bin from which the grouped
    # route wins at every point of the sweep (ROUTE_BINS ascend)
    crossover = None
    for ln in reversed(lines):
        if ln["faster"] != "grouped":
            break
        crossover = ln["off_bin"]
    summary["route"] = dict(
        h2_graph_ms={ln["n_bins"]: ln["h2_graph_ms"] for ln in lines},
        grouped_graph_ms={ln["n_bins"]: ln["grouped_graph_ms"] for ln in lines},
        grouped_wins_from_off_bin=crossover,
        rule_agrees=all(ln["rule_grouped"] == (ln["faster"] == "grouped")
                        for ln in lines))
    emit(dict(phase="route_sweep", **summary["route"]))


def phase_tail(args, summary):
    """The steady-state tail above ``S_MAX``: the float64 route on the
    ``ntl9_100k.bins128`` cell's flux matrix (3,202 states). The cell's
    graphed step must show the row kernels in a trace of its replays
    (``GRAPH_KERNELS["bins128"]``)."""
    import torch

    from msm_we_tpu_torch.entry import hot_step, stage_problem
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.testing import make_problem

    s = stage_problem(make_problem(seed=0, n_bins=128), "two_transform", "cuda")
    launches = dict.fromkeys(sa.KERNELS, 0)
    out, step_trace = _graphed_run(lambda: hot_step(s, "two_transform"),
                                   args.reps, "bins128", launches)
    fm = out["fm"]
    emit(dict(phase="bins128_step", **step_trace))
    del s, out
    torch.cuda.empty_cache()
    line = _tail_rounds(fm, args.reps)
    emit(dict(phase="steady_state_rounds", tier="bins128", **line))
    summary["tail_bins128"] = dict(
        ms=line["conditional"]["ms"],
        tail_device_ms=line["conditional"]["tail_device_ms"],
        bound_ms=line["conditional"]["bound_ms"],
        plain_ms=line["conditional"]["plain_ms"],
        f32_graph_ms=line["conditional"]["f32_graph_ms"],
        torch_rows_ms=line["torch_rows"]["ms"],
        row_kernels=line["row_kernels"])


def _early_exit_step(s, tier):
    """The parent's route: ``entry._hot_step`` with the early-exit tail, a
    host read a round."""
    from msm_we_tpu_torch import entry, step
    from msm_we_tpu_torch.testing import steady_state_early_exit

    entry.steady_state_from_flux = lambda *a: steady_state_early_exit(*a)[:4]
    try:
        return entry._hot_step(s, tier)
    finally:
        entry.steady_state_from_flux = step.steady_state_from_flux


def _hot_step_turns(s, tier, reps):
    """The hot step on the staged problem ``s`` by three routes, timed in
    turns (parent, eager, graph, graph, eager, parent; ``reps``
    synchronised steps each): graphed (``hot_step``, a CUDA graph replay),
    eager (``_hot_step``: launches from Python, the tail's rounds
    guarded by ``torch.where``) and the parent's route (the eager launches
    with the early-exit tail, which reads the residual on the host before
    each extra squaring). Every step's ids must equal the first eager
    step's bitwise. The f32 flux adds with ``atomicAdd`` in a run-dependent
    order, so every step's ``fm`` must lie within
    ``testing.flux_order_bound`` of the first eager step's in each cell,
    and each graphed step's ``pss``, JtargetSS and residual must equal,
    bitwise, the eager tail run on that step's own ``fm``. The largest
    distance of any step of a route from the first eager step (the spread)
    is reported beside. Runs after the main path's counted run."""
    import torch

    from msm_we_tpu_torch.entry import _hot_step, _state_masks, hot_step
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.step import steady_state_from_flux
    from msm_we_tpu_torch.testing import flux_order_bound

    routes = dict(graph=lambda: hot_step(s, tier),
                  eager=lambda: _hot_step(s, tier),
                  parent=lambda: _early_exit_step(s, tier))
    for fn in routes.values():
        fn()
    torch.cuda.synchronize()
    before = sa.launch_counts()
    routes["eager"]()
    per_step = {k: n - before[k] for k, n in sa.launch_counts().items()}
    outs = {r: [] for r in routes}
    times = {r: [] for r in routes}
    for r in ("parent", "eager", "graph", "graph", "eager", "parent"):
        times[r] += _synced_ms(routes[r], reps, outs[r])
    ref = outs["eager"][0]
    S = s["n_states"]
    bound = flux_order_bound(ref["pidx"], ref["cidx"], s["w"], S)
    for o in sum(outs.values(), []):
        require(torch.equal(o["pidx"], ref["pidx"])
                and torch.equal(o["cidx"], ref["cidx"]),
                f"hot step [{tier}]: ids differ between steps")
        excess = float(((o["fm"].double() - ref["fm"].double()).abs()
                        - bound).max())
        require(excess <= 0.0, f"hot step [{tier}]: fm differs from the "
                               f"first eager step beyond the f32 order bound")
    basis, target = _state_masks(S, ref["fm"].device)
    for o in outs["graph"]:
        _T, pss, flux, res = steady_state_from_flux(o["fm"], basis, target)
        require(torch.equal(o["pss"], pss) and torch.equal(o["flux"], flux)
                and torch.equal(o["residual"], res),
                f"hot step [{tier}]: the graphed tail differs from the eager "
                f"tail on the same fm")
    line = dict(step_ms=_median(times["graph"]),
                eager_step_ms=_median(times["eager"]),
                parent_step_ms=_median(times["parent"]),
                event_ms=cuda_ms(routes["graph"], reps),
                eager_event_ms=cuda_ms(routes["eager"], reps),
                parent_event_ms=cuda_ms(routes["parent"], reps))
    for r in ("eager", "parent"):
        dev_ms, ops, _k = _step_profile(routes[r], reps)
        line[f"{r}_device_ms"], line[f"{r}_device_ops"] = dev_ms, ops
    t_enqueue = []
    for _ in range(reps):
        t = time.perf_counter()
        routes["graph"]()
        t_enqueue.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    line.update(
        enqueue_ms=_median(t_enqueue), eager_kernel_launches=per_step,
        spread={key: {r: _max_dev(o, ref, key) for r, o in outs.items()}
                for key in ("fm", "pss", "flux")},
        fm_order_bound_max=float(bound.max()))
    return line


def phase_main(args, summary):
    import numpy as np
    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.entry import TIERS, entry, hot_step, stage_problem
    from msm_we_tpu_torch.ops import steady_tail as st
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.testing import make_problem

    dev = torch.device("cuda")
    prob = make_problem()
    N = len(prob["w"])
    staged = {t: stage_problem(prob, t, dev) for t in TIERS}
    staged_grouped = staged["two_transform"]["grouped"]
    del prob
    t0 = time.perf_counter()
    data = generate_we_arrays(n_iterations=101, n_segments=1000, seed=17)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    # ---- the main path, counted: the hot step of each tier and entry() as
    # graph replays (their launches traced), then the builds. The wrappers
    # count the launches of the captures' warm-ups and of the builds.
    sa.reset_launch_counts()
    graph_launches = dict.fromkeys(sa.KERNELS, 0)
    traced = {}
    for tier in TIERS:
        s = staged[tier]
        graph = tier + ("_grouped" if s.get("grouped") else "")
        out, traced[tier] = _graphed_run(lambda: hot_step(s, tier), args.reps,
                                         graph, graph_launches)
        fm = out["fm"]
        pss_sum = float(out["pss"].sum())
        require(bool(torch.isfinite(fm).all()) and fm.shape == (252, 252),
                f"hot step [{tier}] flux malformed")
        require(abs(pss_sum - 1.0) < 1e-3, f"hot step [{tier}] pSS sums to {pss_sum}")
        traced[tier].update(ss_residual=float(out["residual"]),
                            JtargetSS=float(out["flux"]))
    fn, eargs = entry()  # the default device: the card
    (fm, pss, flux, residual), entry_trace = _graphed_run(
        lambda: fn(*eargs), 2, "entry", graph_launches)
    require(bool(torch.isfinite(pss).all()), "entry() pSS not finite")
    emit(dict(phase="entry", flux_sum=float(fm.sum()), JtargetSS=float(flux),
              ss_residual=float(residual), **entry_trace))

    builds = []
    # cold (first use of every path), then warm with no device given
    for device in ("cuda", None):
        secs, model = _build(data, device, True, 25)
        builds.append(secs)
    require(model.device.type == "cuda",
            f"modelWE() with no device built on {model.device}")
    eager_launches = sa.launch_counts()
    counts = {k: n + graph_launches[k] for k, n in eager_launches.items()}
    emit(dict(phase="launch_counts", eager=eager_launches,
              graph_traced=graph_launches, **counts))
    require(np.isfinite(model.JtargetSS) and model.JtargetSS > 0,
            f"build JtargetSS = {model.JtargetSS}")
    emit(dict(phase="build", segments=int(sum(len(d) for d in model.dtrajs)),
              iterations=101, seconds_cold=builds[0], seconds_warm=builds[1],
              generate_s=gen_s,
              stages={n: s for n, s, _note in model.stage_timings.stages},
              clusters_before=int(model.fluxMatrixRaw.shape[0]),
              clusters_after=int(model.fluxMatrix.shape[0]),
              JtargetSS=float(model.JtargetSS)))
    # H2 is off the main path where its bank takes the bin-grouped route
    # (the kernels and route phases run it), and H1 where the main path's
    # features stream (``features_stream_fits``; the kernels phase runs
    # it); the float64 tail's row kernels run above S_MAX only (the tail
    # phase)
    off_path = {"tail_renorm", "tail_transition"}
    if staged_grouped:
        off_path.add("transform_assign")
    if sa.features_stream_fits(*staged["dedup"]["comp"].shape):
        off_path.add("transform_assign_child")
    for name in sa.KERNELS:
        require(counts[name] > 0 or name in off_path,
                f"kernel {name} never launched on the main path")
    summary["launches"] = counts
    summary["launches_graph"] = graph_launches
    summary["build_warm_s"] = builds[1]
    summary["bench_data"] = data  # reused by the access phase

    # ---- comparisons and references (not counted)
    for tier in TIERS:
        line = _hot_step_turns(staged[tier], tier, args.reps)
        emit(dict(phase="hot_step", tier=tier, n_segments=N,
                  frames_per_s=N / line["step_ms"] * 1e3, reps=args.reps,
                  **traced[tier], **line))
        summary["hot_step_" + tier] = dict(
            step_ms=line["step_ms"], eager_step_ms=line["eager_step_ms"],
            parent_step_ms=line["parent_step_ms"],
            event_ms=line["event_ms"], frames_per_s=N / line["step_ms"] * 1e3)
        fm = hot_step(staged[tier], tier)["fm"]
        emit(dict(phase="steady_state_rounds", tier=tier,
                  **_tail_rounds(fm, args.reps)))
    del staged
    dense = torch.tensor(np.random.default_rng(7).random((st.S_MAX, st.S_MAX)),
                         dtype=torch.float32, device=dev)
    emit(dict(phase="steady_state_rounds", tier="dense_s_max",
              **_tail_rounds(dense, args.reps)))
    del dense
    emit(dict(phase="hot_step_reference", **_hot_step_ref_check()))
    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    for scan in (False, True):
        emit(dict(phase="build_parity", **_build_parity(small, scan)))


# -------------------------------------------------------------- analysis


def _default_build(data, device, n_clusters=25, n_atoms=4, dimreduce_method="pca",
                   stratified=True, dim_reduce_kwargs=None, profile_dir=None,
                   model_cls=None):
    """``build_analyze_model`` with its defaults (block cross-validation,
    2 groups x 4 blocks; predict route) in the bench configuration, on a
    ``modelWE`` (or ``model_cls``)."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    model = (model_cls or modelWE)(device=device)
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


# ---------------------------------------------------------------- routes

ROUTE_ENVS = ("MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS", "MSM_WE_TPU_DEVICE_STATS_MIN_ROWS")
ROUTE_STAGES = ("Clustering", "Flux matrix", "Cleaning")


class _device_route:
    """Both routing knobs at 0 inside the block, restored after it."""

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in ROUTE_ENVS}
        for k in ROUTE_ENVS:
            os.environ[k] = "0"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _counting:
    """Counts the calls of ``module.name`` inside the block."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls += 1
            return self.real(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _route_stages(model):
    st = _stages(model)
    return {n: st[n] for n in ROUTE_STAGES}


def _route_builds(data, n_clusters=25):
    """The bench build of ``data`` on the card by both routes, each cold
    then warm; the warm device-route build is counted. Returns (host model,
    device model, line, counts)."""
    from msm_we_tpu_torch import fluxmatrix

    line = {}
    for cold in (True, False):
        secs, host = _build(data, None, True, n_clusters)
        line[f"host_{'cold' if cold else 'warm'}_s"] = secs
        line[f"host_{'cold' if cold else 'warm'}_stages"] = _route_stages(host)
        with _device_route(), _counting(fluxmatrix, "get_flux_matrix") as flux_calls:
            (secs, dev), counts = _counted(lambda: _build(data, None, True, n_clusters))
        line[f"device_{'cold' if cold else 'warm'}_s"] = secs
        line[f"device_{'cold' if cold else 'warm'}_stages"] = _route_stages(dev)
    require(host._child_idx is not None, "the host route left its ids deferred")
    require(dev._child_idx is None and dev.dtrajs is None,
            "the device route materialized host ids")
    require(counts["assign_flux"] >= flux_calls.calls >= 2,
            f"H3 launched {counts['assign_flux']} times in {flux_calls.calls} flux calls")
    require(counts["pair_assign"] > 0, "H4 never launched on the device route")
    line.update(flux_calls=flux_calls.calls, launch_counts=counts)
    return host, dev, line, counts


def _route_parity(host, dev):
    """The device-route build against the host-route build of the same
    data on the same card."""
    import numpy as np

    scale = float(np.abs(host.fluxMatrixRaw).max())
    flux_err = float(np.abs(dev.fluxMatrixRaw - host.fluxMatrixRaw).max()) / scale
    require(flux_err <= 1e-12, f"fluxMatrixRaw differs between the routes by {flux_err}")
    j_err = abs(dev.JtargetSS - host.JtargetSS) / abs(host.JtargetSS)
    require(j_err <= 1e-10, f"JtargetSS differs between the routes by {j_err}")
    require(dev.fluxMatrix.shape == host.fluxMatrix.shape,
            "cleaned cluster counts differ between the routes")
    swapped = int((np.asarray(dev.pcoord_sort_indices)
                   != np.asarray(host.pcoord_sort_indices)).sum())
    np.testing.assert_allclose(np.sort(dev.pSS), np.sort(host.pSS), rtol=1e-8,
                               atol=1e-18)
    center_err = float(np.nanmax(np.abs(
        np.sort(dev.targetRMSD_centers[:, 0]) - np.sort(host.targetRMSD_centers[:, 0]))))
    dev._ensure_discretized()
    require(np.array_equal(np.concatenate(dev.dtrajs), np.concatenate(host.dtrajs)),
            "dtrajs differ between the routes after _ensure_discretized()")
    return dict(flux_rel_err=flux_err, JtargetSS_host=float(host.JtargetSS),
                JtargetSS_device=float(dev.JtargetSS), JtargetSS_rel_err=j_err,
                clusters_before=int(host.fluxMatrixRaw.shape[0]),
                clusters_after=int(host.fluxMatrix.shape[0]),
                sort_positions_differing=swapped,
                sorted_center_max_abs_err=center_err, dtrajs_equal=True,
                segments=int(sum(len(d) for d in host.dtrajs)))


PLAIN_CHUNK_ROWS = 1 << 20  # rows a chunk of the plain H3 (its score matrix is rows x K)


def _assign_flux_plain_chunked(args, target_p):
    """``assign_flux_plain`` with its scores taken over runs of
    ``PLAIN_CHUNK_ROWS`` rows. Returns ``(pidx, cidx, fm, fm_chunks)``:
    ``fm`` is one scatter of all rows, as the unchunked plain version makes
    it; ``fm_chunks`` the sum of the chunks' fluxes. An f64 sum of millions
    of addends depends on its order beyond 1e-12 (equal WE weights round the
    same way at every addition), so only ``fm`` adds in the kernel's and the
    host bincount's row order."""
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.step import _scatter_flux

    n = args[0].shape[0]
    pids, cids, fm_chunks = [], [], 0
    for lo in range(0, n, PLAIN_CHUNK_ROWS):
        rows = slice(lo, lo + PLAIN_CHUNK_ROWS)
        p, c, f = sa.assign_flux_plain(
            *(a[rows] for a in args[:8]), *args[8:],
            target_p=None if target_p is None else target_p[rows])
        pids.append(p)
        cids.append(c)
        fm_chunks = fm_chunks + f
    pidx, cidx = torch.cat(pids), torch.cat(cids)
    return pidx, cidx, _scatter_flux(pidx, cidx, args[4], args[11]), fm_chunks


def _h3_f64(model, reps):
    """H3 at a built model's shapes with its f64 weights (the launch
    ``device_flux_lag0`` makes): the wrapper between CUDA events, the
    kernel's and the plan kernels' device time, the bound from this run's
    inputs, the whole ``device_flux_lag0`` call on the host clock, and the
    plain version on the same tensors in row chunks. The ids must agree but
    for near-ties; the f64 flux agrees with the plain flux to 1e-12 (with
    id mismatches: with the scatter of the kernel's own ids)."""
    import torch

    from msm_we_tpu_torch import fluxmatrix
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.step import _scatter_flux

    iters = list(range(2, model.maxIter))
    args, target_p = fluxmatrix._flux_launch_args(model, iters)
    fp, fc, pbins, cbins, w = args[:5]
    bank = args[8:11]
    n_states = args[11]
    require(w.dtype == torch.float64, f"the route's weights are {w.dtype}")
    run = lambda: sa.assign_flux(*args, target_p=target_p)  # noqa: E731
    pk, ck, fk = run()
    torch.cuda.synchronize()
    F = fc.shape[1]
    pairs = _same_bin_pairs(pbins, bank) + _same_bin_pairs(cbins, bank)
    bound = _bound([*args[:11], target_p, pk, ck, fk], 2 * pairs * F)
    line = dict(rows=int(fc.shape[0]), F=int(F), K=int(bank[0].shape[0]),
                ms=cuda_ms(run, reps), kernel_ms=device_ms(run, "assign_flux_kernel", reps),
                plan_kernels_ms=device_ms(run, "plan_", reps),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)
    torch.cuda.synchronize()
    with _device_route():  # the ids stay where they are
        line["device_flux_lag0_s"], _fm = _timed(
            lambda: fluxmatrix.device_flux_lag0(model, iters))
    plain = lambda: _assign_flux_plain_chunked(args, target_p)  # noqa: E731
    pp, cp, fpl, fpl_chunks = plain()
    regime = f"routes N={fc.shape[0]},K={bank[0].shape[0]}"
    mism = sum(
        _compare_ids("assign_flux", regime, ik, ip, n_states, X, bins, bank)[0]
        for ik, ip, X, bins in ((pk, pp, fp, pbins), (ck, cp, fc, cbins)))
    ref = fpl if mism == 0 else _scatter_flux(pk, ck, w, n_states)
    err = float((fk - ref).abs().max() / ref.abs().max())
    require(err <= 1e-12, f"H3's f64 flux differs from the plain version by {err}")
    line.update(id_mismatches_near_ties=mism, max_abs_err=float((fk - ref).abs().max()),
                flux_rel_err=err, plain_chunk_rows=PLAIN_CHUNK_ROWS,
                chunk_summed_flux_rel_err=float(
                    (fk - fpl_chunks).abs().max() / fpl_chunks.abs().max()),
                plain_ms=cuda_ms(plain, max(reps // 4, 3), warmup=1))
    return line


def _dtoh_bytes(data, out_dir, device_route):
    """Device-to-host bytes of the flux and cleaning stages of one route,
    from a ``torch.profiler`` trace of those stages on a freshly clustered
    model; None where the trace names no copy sizes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from contextlib import nullcontext

    with (_device_route() if device_route else nullcontext()):
        model = _clustered_bench(data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.get_fluxMatrix(0)
            model.organize_fluxMatrix()
            torch.cuda.synchronize()
    path = os.path.join(out_dir, f"trace_routes_{'device' if device_route else 'host'}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    return dict(copies=len(copies),
                bytes=None if any(b is None for b in sizes) else int(sum(sizes)),
                ms=sum(e["dur"] for e in copies) / 1e3)


def _clustered_bench(data, n_clusters=25, stratified=True, defer=True, weights=None,
                     bounds=([[9.0, 10.0]], [[0.0, 1.0]])):
    """A model of the bench configuration on the card, clustered and not
    yet through the flux stage (``weights``: a function that rewrites the
    feature weights first; ``bounds``: the basis and target pcoord bounds)."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    m = modelWE()
    m.initialize(ArrayWEDataset(data), {"coords": None, "nAtoms": 4, "coord_ndim": 3},
                 "routes", basis_pcoord_bounds=bounds[0],
                 target_pcoord_bounds=bounds[1], dim_reduce_method="pca", tau=1.0)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    m.dimReduce()
    if weights is not None:
        feats = m._featurize_all()
        feats["weights"] = weights(feats["weights"])
    if stratified:
        m.cluster_coordinates(
            n_clusters=n_clusters, stratified=True,
            user_bin_mapper=RectilinearBinMapper([np.linspace(0, 10, 13)]),
            scan_small_batches=True, defer_discretization=defer)
    else:
        m.cluster_coordinates(n_clusters=n_clusters, stratified=False)
    return m


def _tail(model):
    """Flux matrix through JtargetSS on a clustered model; returns the
    stage seconds."""
    out = {}
    out["Flux matrix"], _ = _timed(lambda: model.get_fluxMatrix(0))
    out["Cleaning"], _ = _timed(model.organize_fluxMatrix)
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    return out


def _dyadic_check():
    """(b) Dyadic weights (j/16) at 30 x 200: the device route's flux equals
    the host bincount bitwise, on the card and against the CPU build."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_arrays

    data = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    rng = np.random.default_rng(18)
    for d in data:
        d["weights"] = rng.integers(1, 17, len(d["weights"])) / 16.0
    _t, host = _build(data, "cuda", False, 25)
    _t, cpu = _build(data, "cpu", False, 25)
    with _device_route():
        (_t, dev), counts = _counted(lambda: _build(data, "cuda", False, 25))
    require(dev._child_idx is None and counts["assign_flux"] >= 2,
            "the dyadic build did not take the device route")
    require(np.array_equal(dev.fluxMatrixRaw, host.fluxMatrixRaw),
            "dyadic flux: device route is not bitwise the host bincount")
    require(dev.JtargetSS == host.JtargetSS, "dyadic JtargetSS differs between the routes")
    dev._ensure_discretized()
    flips = int((np.concatenate(dev.dtrajs) != np.concatenate(cpu.dtrajs)).sum())
    if flips == 0:
        require(np.array_equal(dev.fluxMatrixRaw, cpu.fluxMatrixRaw),
                "dyadic flux: device route on the card is not bitwise the CPU build's")
    else:
        require(flips <= 1e-3 * sum(len(d) for d in cpu.dtrajs),
                f"{flips} dtraj rows flip between the card and the CPU")
    return dict(check="dyadic_30x200", flux_bitwise_host_route=True,
                dtraj_flips_vs_cpu=flips, flux_bitwise_cpu_build=flips == 0,
                JtargetSS=float(dev.JtargetSS), launch_counts=counts)


def _tiny_weight_check():
    """(c) Weights spanning 1e-300 to 1 inside every iteration of a 30 x 200
    run: each nonzero entry of the device f64 flux equals the host
    bincount's to 1e-12, and none is flushed to zero."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.model import modelWE

    data = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    rng = np.random.default_rng(19)
    m = _clustered_bench(
        data, defer=False,
        weights=lambda w: w * 10.0 ** rng.uniform(-300, 0, len(w)))
    w = m._featurize_all()["weights"]
    require(m._device_f64_weights_ok(w) is True, "device_f64_weights_ok is not True")
    m.get_fluxMatrix(0)
    host = m.fluxMatrixRaw.copy()
    modelWE._force_device_flux = True
    try:
        _none, counts = _counted(lambda: m.get_fluxMatrix(0))
    finally:
        modelWE._force_device_flux = False
    require(counts["assign_flux"] == 1, "the forced flux call did not launch H3 once")
    dev = m.fluxMatrixRaw
    nz = host > 0
    require(np.array_equal(dev > 0, nz), "a tiny-weight entry was flushed to zero")
    err = float(np.max(np.abs(dev[nz] - host[nz]) / host[nz]))
    require(err <= 1e-12, f"tiny-weight flux differs from the host bincount by {err}")
    return dict(check="weights_1e-300", weight_min=float(w[w > 0].min()),
                weight_max=float(w.max()), nonzero_entries=int(nz.sum()),
                smallest_entry=float(host[nz].min()), max_rel_err=err,
                device_f64_weights_ok=True)


def _deferred_ids_check():
    """(j) At 30 x 200 with deferred ids and the row knobs unset, the forced
    device flux mints the build's dtrajs from H3's ids on the card: bitwise
    the predict-order ids of ``pair_discretize`` (H4), with disjoint regions
    and with overlapping ones (rows inside both), and the flux equals the
    host bincount of those ids to 1e-12."""
    import numpy as np

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.discretization import pair_discretize
    from msm_we_tpu_torch.model import modelWE

    data = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    line = dict(check="deferred_ids_30x200")
    for name, bounds in (("disjoint", ([[9.0, 10.0]], [[0.0, 1.0]])),
                         ("overlapping", ([[1.5, 3.0]], [[0.0, 2.0]]))):
        m = _clustered_bench(data, bounds=bounds)
        require(m._parent_idx is None and m.dtrajs is None,
                "the deferred clustering stored ids")
        masks = m._pc_masks()
        both = int((masks["basis_c"] & masks["target_c"]).sum())
        require((both > 0) == (name == "overlapping"),
                f"{name}: {both} child rows lie inside both regions")
        modelWE._force_device_flux = True
        try:
            _none, counts = _counted(lambda: m.get_fluxMatrix(0))
        finally:
            modelWE._force_device_flux = False
        require(counts["assign_flux"] == 1 and counts["pair_assign"] == 0,
                f"{name}: the forced flux call launched {counts}")
        require(m._parent_idx is not None and m._scored_on_host is False,
                f"{name}: the H3 launch did not mint the ids")
        dev_flux = m.fluxMatrixRaw.copy()
        pid, cid = pair_discretize(m, m._strat, *m._raw_we_bins())
        require(np.array_equal(m._parent_idx, pid) and np.array_equal(m._child_idx, cid)
                and np.array_equal(np.concatenate(m.dtrajs), cid),
                f"{name}: the ids minted from H3 are not pair_discretize's")
        m.get_fluxMatrix(0)  # ids stored: the host bincount
        err = float(np.abs(dev_flux - m.fluxMatrixRaw).max() / np.abs(m.fluxMatrixRaw).max())
        require(err <= 1e-12, f"{name}: the minting launch's flux is off by {err}")
        line[name] = dict(rows_in_both_regions=both, ids_bitwise_pair_discretize=True,
                          flux_rel_err=err)
    return line


def _aggregated_routes(data, reps):
    """(d) Aggregated clustering (300 clusters) at 1.01M: one clustering,
    then the flux matrix through JtargetSS on two copies, by the host route
    and through ``_force_device_flux`` (H3 on one bin of 300 centers)."""
    import copy

    import numpy as np

    from msm_we_tpu_torch.model import modelWE

    cluster_s, base = _timed(lambda: _clustered_bench(data, n_clusters=300,
                                                      stratified=False))
    host, dev = copy.deepcopy(base), base
    host_stages = _tail(host)
    modelWE._force_device_flux = True
    try:
        dev_stages, counts = _counted(lambda: _tail(dev))
        h3 = _h3_f64(dev, reps)
    finally:
        modelWE._force_device_flux = False
    require(counts["assign_flux"] == 1,
            f"the aggregated flux stage launched H3 {counts['assign_flux']} times")
    scale = float(np.abs(host.fluxMatrixRaw).max())
    flux_err = float(np.abs(dev.fluxMatrixRaw - host.fluxMatrixRaw).max()) / scale
    j_err = abs(dev.JtargetSS - host.JtargetSS) / abs(host.JtargetSS)
    require(flux_err <= 1e-12, f"aggregated flux differs between the routes by {flux_err}")
    require(j_err <= 1e-10, f"aggregated JtargetSS differs between the routes by {j_err}")
    return dict(check="aggregated_1.01M", n_clusters=300, clustering_s=cluster_s,
                host_stages=host_stages, device_stages=dev_stages,
                flux_rel_err=flux_err, JtargetSS_host=float(host.JtargetSS),
                JtargetSS_device=float(dev.JtargetSS), JtargetSS_rel_err=j_err,
                clusters_after=int(dev.fluxMatrix.shape[0]), h3_one_bin=h3,
                launch_counts=counts), counts


def _big_routes(args, smi):
    """(e) Both routes at 101 x ``--big-segments`` (8 stacked replicas,
    bins seeding through the device family)."""
    import torch

    from msm_we_tpu_torch.data import generate_we_replicas

    per = args.big_segments // 8
    gen_s, data = _timed(lambda: generate_we_replicas(
        n_iterations=101, n_segments=per, n_replicas=8, seed=17, processes=8))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    host, dev, line, counts = _route_builds(data)
    peak = torch.cuda.max_memory_allocated()
    del data
    families = dev._strat.seeded_by_family
    require(families["device"] >= 1, f"no bin seeded through the device family: {families}")
    h3 = _h3_f64(dev, max(args.reps // 4, 3))
    parity = _route_parity(host, dev)
    return dict(check="big_build", nvidia_smi=smi, iterations=101,
                segments_per_iteration=per * 8, replicas=8, generate_s=gen_s,
                seeded_by_family=families, peak_device_bytes=int(peak),
                h3_f64=h3, **line, **parity), counts


def _cluster_stats_check(dev_model):
    """(f) ``cluster_stats`` on the card: at the device-route model (ids
    still deferred) against the host f64 statistics of
    ``get_cluster_centers``; and on seeded ids with NaN pcoords in two
    dimensions against a numpy f64 reference."""
    import numpy as np
    import torch

    from msm_we_tpu_torch import structures
    from msm_we_tpu_torch.discretization import device_child_assign
    from msm_we_tpu_torch.step import cluster_stats

    m = dev_model
    require(m._child_idx is None, "the device-route model already holds host ids")
    n, strat = m.n_clusters, m._strat
    k_max = strat.n_bins * strat.k
    built = (m.targetRMSD_centers, m.targetRMSD_minmax)  # put back at the end
    order_d = structures._get_cluster_centers_device(m)
    centers_d, minmax_d = m.targetRMSD_centers.copy(), m.targetRMSD_minmax.copy()
    counts_d = cluster_stats(device_child_assign(m, strat), structures._device_p1(m),
                             n, k_max)[0][:n, 0].cpu().numpy()
    m._ensure_discretized()
    order_h = m.get_cluster_centers()
    ids = m._child_idx
    counts_h = np.bincount(ids[ids < n], minlength=n)
    require(np.array_equal(counts_d, counts_h), "device cluster counts differ from the host's")
    mean_err = float(np.nanmax(np.abs(np.sort(centers_d[:, 0]) - np.sort(m.targetRMSD_centers[:, 0]))
                               / np.abs(np.sort(m.targetRMSD_centers[:, 0]))))
    require(mean_err <= 1e-5, f"device cluster means differ from the host's by {mean_err}")
    inv_d, inv_h = np.argsort(order_d), np.argsort(order_h)
    require(np.array_equal(
        minmax_d[inv_d][:n],
        m.targetRMSD_minmax[inv_h][:n].astype(np.float32).astype(np.float64)),
        "device cluster min/max differ from the host's after the f32 cast")

    m.targetRMSD_centers, m.targetRMSD_minmax = built

    rng = np.random.default_rng(23)
    N, ndim, live = 1_010_000, 2, 270
    cid = rng.integers(-1, 302, N).astype(np.int32)
    p1 = rng.uniform(0, 10, (N, ndim)).astype(np.float32)
    nan_rows = rng.choice(N, 1000, replace=False)
    p1[nan_rows, rng.integers(0, ndim, 1000)] = np.nan
    got = [t.cpu().numpy() for t in cluster_stats(
        torch.as_tensor(cid, device="cuda"), torch.as_tensor(p1, device="cuda"), live, 300)]
    for dim in range(ndim):
        ok = (cid >= 0) & (cid < live) & ~np.isnan(p1[:, dim])
        c = np.bincount(cid[ok], minlength=301)
        sm = np.bincount(cid[ok], weights=p1[ok, dim].astype(np.float64), minlength=301)
        require(np.array_equal(got[0][:, dim], c), "cluster_stats counts (NaN rows) differ")
        np.testing.assert_allclose(got[1][:live, dim], sm[:live], rtol=1e-5)
        lo = np.full(301, np.inf, np.float32)
        hi = np.full(301, -np.inf, np.float32)
        np.minimum.at(lo, cid[ok], p1[ok, dim])
        np.maximum.at(hi, cid[ok], p1[ok, dim])
        require(np.array_equal(got[2][:, dim], lo) and np.array_equal(got[3][:, dim], hi),
                "cluster_stats min/max (NaN rows) differ")
    return dict(check="cluster_stats", clusters=int(n), counts_equal=True,
                mean_max_rel_err=mean_err, minmax_equal_after_f32_cast=True,
                sort_positions_differing=int((order_d != order_h).sum()),
                nan_case_rows=N, nan_case_nan_rows=1000, nan_case_equal=True)


def _optimization_check(model):
    """(g) ``optimization`` on the 1.01M host-route model."""
    import numpy as np

    from msm_we_tpu_torch import optimization as opt
    from msm_we_tpu_torch.model import StratifiedClustersShim

    n_we_bins = 12
    T, pss = np.asarray(model.Tmatrix), np.squeeze(np.asarray(model.pSS))
    solve_s, (disc, var) = _timed(lambda: opt.solve_discrepancy(T, pss, model.indTargets))
    require(np.isfinite(disc).all() and np.isfinite(var).all(),
            "the discrepancy solve is not finite")
    b = np.zeros(len(pss))
    b[model.indTargets] = 1.0
    lhs = (np.eye(len(T)) - T + np.outer(pss, pss) / (pss @ pss)) @ disc
    residual = float(np.abs(lhs - (b - pss[model.indTargets].sum())).max())
    require(residual <= 1e-8, f"the discrepancy system's residual is {residual}")
    uniform = opt.get_uniform_mfpt_bins(var, disc, pss, n_we_bins)
    require(len(uniform) == len(pss) and uniform.min() >= 0, "uniform bins malformed")
    clustered, counts = _counted(lambda: opt.get_clustered_mfpt_bins(
        var, disc, pss, n_we_bins, seed=1, device=model.device))
    require(not np.isnan(clustered).any()
            and 2 <= len(np.unique(clustered)) <= n_we_bins - 2,
            "clustered bins malformed")
    # The branch that ran: sklearn's KMeans where it imports (no launch),
    # else the port's k-means on the card (H4 launches)
    import importlib.util

    if importlib.util.find_spec("sklearn") is not None:
        branch = "sklearn"
        require(counts["pair_assign"] == 0, "sklearn imports but H4 launched")
    else:
        branch = "kmeans_fit"
        require(counts["pair_assign"] > 0,
                "without sklearn the port's k-means must run on the card (H4)")

    # Cluster id -> WE bin: the sorted states' bins carried back to global ids
    n = model.n_clusters
    table = np.zeros(n + 2)
    table[np.asarray(model.pcoord_sort_indices)] = uniform
    strat = model._strat
    mapper = opt.OptimizedBinMapper(
        nbins=n_we_bins, n_original_pcoord_dims=1,
        target_pcoord_bounds=model.target_pcoord_bounds,
        basis_pcoord_bounds=model.basis_pcoord_bounds,
        previous_binmapper=model._bin_mapper, microstate_mapper=table,
        stratified_clusterer=StratifiedClustersShim(model._bin_mapper, None, strat))
    require(mapper.n_clusters == n + 2, f"the mapper counts {mapper.n_clusters} clusters")
    feats = model._featurize_all()
    start = len(feats["weights"]) // 5
    rows = slice(start, start + 100_000)
    pc, X = feats["pcoord1"][rows], feats["child"][rows]
    coords = np.column_stack([pc, X])
    (assign_s, got), c2 = _counted(lambda: _timed(lambda: mapper.assign(coords)))
    require(c2["pair_assign"] > 0, "the mapper's assignment did not launch H4")
    _add_counts(counts, c2)
    basis, target = model.is_WE_basis(pc), model.is_WE_target(pc)
    ids = strat.predict(X, model._bin_mapper.assign(pc), is_basis=basis, is_target=target)
    want = table[ids]
    want[target] = n_we_bins - 1
    want[basis] = n_we_bins - 2
    require(np.array_equal(got, want.astype(int)),
            "OptimizedBinMapper.assign differs from predict + table by hand")
    blob = mapper.pickle_and_encode()
    # The transport format holds CPU state; the constructor puts it on the card
    import base64

    require(b"cuda" not in base64.b64decode(blob),
            "the pickled mapper does not hold CPU state")
    restored = opt.OptimizedBinMapper(bytestring=blob)
    require(restored.clusterer.strat.device.type == "cuda",
            "the bytestring constructor did not put the mapper on the card")
    got2, c3 = _counted(lambda: restored.assign(coords))
    require(c3["pair_assign"] > 0, "the restored mapper's assignment did not launch H4")
    _add_counts(counts, c3)
    require(np.array_equal(got2, got),
            "assignments differ after the bytestring round trip (on the card)")
    on_cpu = opt.OptimizedBinMapper(bytestring=blob, device="cpu")
    cpu_diff = int((on_cpu.assign(coords) != got).sum())
    require(cpu_diff <= 1e-3 * len(got),
            f"{cpu_diff} assignments differ after the round trip (on the CPU)")
    return dict(check="optimization", states=len(pss), solve_discrepancy_s=solve_s,
                residual=residual, clustered_branch=branch, we_bins=n_we_bins,
                mapper_rows=len(got), mapper_assign_s=assign_s,
                mapper_equals_by_hand=True, bytestring_bytes=len(blob),
                round_trip_equal_on_card=True, round_trip_cpu_differing=cpu_diff,
                launch_counts=counts), counts


def _index_width_check():
    """(i) H3 and H4 at 10.1M rows a set x 300 features, 12 bins x 25
    centers: element offsets pass 2^31, the row index 2N stays below it."""
    import numpy as np
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.step import _scatter_flux

    dev = torch.device("cuda")
    N, F, n_bins, k, edge = 10_100_000, 300, 12, 25, 65_536
    gen = torch.Generator(dev).manual_seed(29)
    fp = torch.randn(N, F, device=dev, generator=gen)
    fc = torch.randn(N, F, device=dev, generator=gen)
    pb = torch.randint(0, n_bins, (N,), device=dev, generator=gen, dtype=torch.int32)
    cb = torch.randint(0, n_bins, (N,), device=dev, generator=gen, dtype=torch.int32)
    w = torch.randint(1, 17, (N,), device=dev, generator=gen).double() / 16.0
    bank = (torch.randn(n_bins * k, F, device=dev, generator=gen),
            torch.arange(n_bins, device=dev, dtype=torch.int32).repeat_interleave(k),
            torch.ones(n_bins * k, dtype=torch.bool, device=dev))
    none = torch.zeros(N, dtype=torch.bool, device=dev)
    SS = n_bins * k + 2
    torch.cuda.synchronize()
    h3_s, (pk, ck, fm) = _timed(lambda: (
        sa.assign_flux(fp, fc, pb, cb, w, none, none, none, *bank, SS),
        torch.cuda.synchronize())[0])
    h4_s, (hp, hc) = _timed(lambda: (
        sa.pair_assign(fp, fc, pb, cb, *bank), torch.cuda.synchronize())[0])
    require(torch.equal(pk, hp) and torch.equal(ck, hc),
            "index widths: H4's ids are not bitwise H3's raw ids")
    require(torch.equal(fm, _scatter_flux(pk, ck, w, SS)),
            "index widths: the dyadic f64 flux is not the scatter of H3's ids")
    mism = ties = 0
    for X, ids, bins in ((fp, pk, pb), (fc, ck, cb)):
        for rows in (slice(0, edge), slice(N - edge, N)):
            plain = sa.pair_assign_plain(None, X[rows].contiguous(), None,
                                         bins[rows].contiguous(), *bank)
            m, t = _compare_ids("assign_flux", "N=10.1M,F=300", ids[rows], plain, SS,
                                X[rows], bins[rows], bank)
            mism, ties = mism + m, ties + t
    return dict(check="index_widths", rows=N, F=F, K=n_bins * k,
                elements_a_set=N * F, h3_first_call_s=h3_s, h4_first_call_s=h4_s,
                h4_bitwise_h3=True, flux_bitwise=True, edge_rows=4 * edge,
                id_mismatches=mism, near_ties=ties,
                peak_device_bytes=int(torch.cuda.max_memory_allocated()))


def _plotting_check(model, had_matplotlib, out_dir):
    """(h) ``plotting`` on the 1.01M host-route model."""
    import numpy as np

    from msm_we_tpu_torch import plotting

    require(("matplotlib" in sys.modules) == had_matplotlib,
            "importing msm_we_tpu_torch.plotting pulled in matplotlib")
    model.get_committor()
    model.get_flux()
    model.get_flux_committor()
    fluxes, bounds = model.get_coarse_flux_profile()
    require(len(fluxes) == len(bounds) and np.isfinite(fluxes).all(),
            "the coarse flux profile is malformed")
    line = dict(check="plotting", coarse_bins=len(fluxes),
                import_pulls_no_matplotlib=True)
    try:
        import matplotlib
    except ImportError:
        try:
            model.plot_flux(suppress_validation=True)
        except ImportError as e:
            require("matplotlib" in str(e), f"the ImportError does not name matplotlib: {e}")
            return dict(matplotlib=False, import_error=str(e)[:120], **line)
        raise Failure("plot_flux did not raise ImportError without matplotlib")
    matplotlib.use("Agg")
    cwd = os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(out_dir)  # plot_committor saves into the working directory
    try:
        model.first_iter, model.last_iter = 1, model.maxIter
        figures = {
            "flux": model.plot_flux(suppress_validation=True).figure,
            "flux_committor": model.plot_flux_committor(suppress_validation=True).figure,
            "flux_committor_pcoordcolor":
                model.plot_flux_committor_pcoordcolor()[0].figure,
            "committor": model.plot_committor(),
            "coarse_flux_profile": model.plot_coarse_flux_profile()[0],
            "implied_timescales": model.plot_implied_timescales()[0],
            "ck_test": model.plot_ck_test(sets=2)[0],
        }
        for name, fig in figures.items():
            fig.savefig(f"routes_{name}.png")
            require(os.path.getsize(f"routes_{name}.png") > 0, f"plot {name} is empty")
    finally:
        os.chdir(cwd)
    return dict(matplotlib=True, plots=sorted(figures), **line)


def phase_routes(args, summary, smi):
    """The device flux and stats route beside the host route,
    ``optimization`` and ``plotting``."""
    import shutil
    import tempfile

    import torch

    from msm_we_tpu_torch.data import generate_we_arrays

    had_matplotlib = "matplotlib" in sys.modules
    total = {}
    tmp_dir = tempfile.mkdtemp(prefix="chip_smoke_routes_")
    out_dir = args.out or tmp_dir
    os.makedirs(out_dir, exist_ok=True)
    try:
        emit(dict(phase="routes", **_dyadic_check()))
        emit(dict(phase="routes", **_tiny_weight_check()))
        emit(dict(phase="routes", **_deferred_ids_check()))

        data = summary.get("analysis_data")
        if data is None:
            data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
            summary["analysis_data"] = data
        # (a) both routes at 1.01M
        host, dev, line, counts = _route_builds(data)
        _add_counts(total, counts)
        h3 = _h3_f64(dev, args.reps)
        stats = _cluster_stats_check(dev)  # materializes the ids at its end
        parity = _route_parity(host, dev)
        emit(dict(phase="routes", check="route_parity_1.01M", nvidia_smi=smi,
                  h3_f64=h3, **line, **parity))
        emit(dict(phase="routes", **stats))
        summary["routes_h3"] = h3
        del dev
        emit(dict(phase="routes", check="dtoh_1.01M",
                  host_route=_dtoh_bytes(data, out_dir, False),
                  device_route=_dtoh_bytes(data, out_dir, True)))
        # (g), (h) on the host-route model
        line, counts = _optimization_check(host)
        _add_counts(total, counts)
        emit(dict(phase="routes", **line))
        emit(dict(phase="routes", **_plotting_check(host, had_matplotlib, out_dir)))
        del host
        # (d) aggregated clustering through the one-bin H3
        line, counts = _aggregated_routes(data, args.reps)
        _add_counts(total, counts)
        emit(dict(phase="routes", **line))
        del data
        torch.cuda.empty_cache()
        # (i) index widths at 10.1M x 300
        torch.cuda.reset_peak_memory_stats()
        emit(dict(phase="routes", **_index_width_check()))
        torch.cuda.empty_cache()
        # (e) the big build
        line, counts = _big_routes(args, smi)
        _add_counts(total, counts)
        emit(dict(phase="routes", **line))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    for name in ("assign_flux", "pair_assign"):
        require(total.get(name, 0) > 0, f"kernel {name} never launched in the routes phase")
    summary["launches_routes"] = total


# ------------------------------------------------------------------ mesh


def _mesh_regimes(hot, wide, dev):
    """The kernel table's H4 regimes as card tensors: (name, fp, fc, pbins,
    cbins, bank): K = 250 (the hot problem), K = 3,200 (128 bins x 25), one
    bin of 300 centers, and 300 features over 12 bins x 25."""
    import numpy as np
    import torch

    def t(a, dt):
        return torch.as_tensor(np.asarray(a)).to(dt).to(dev).contiguous()

    f32, i32 = torch.float32, torch.int32

    def bank(p):
        return (t(p["centers"], f32), t(p["center_bin"], i32),
                t(p["valid"], torch.bool))

    rng = np.random.default_rng(21)
    N = len(hot["fc"])
    out = [("K=250", t(hot["fp"], f32), t(hot["fc"], f32), t(hot["pbins"], i32),
            t(hot["cbins"], i32), bank(hot)),
           ("K=3200,bins=128", t(wide["fp"], f32), t(wide["fc"], f32),
            t(wide["pbins"], i32), t(wide["cbins"], i32), bank(wide))]
    zeros = torch.zeros(N, dtype=i32, device=dev)
    pick = rng.choice(N, 300, replace=False)
    one = (t(hot["fc"][pick] + 0.01 * rng.normal(size=(300, hot["fc"].shape[1])), f32),
           torch.zeros(300, dtype=i32, device=dev),
           torch.ones(300, dtype=torch.bool, device=dev))
    out.append(("one_bin,K=300", out[0][1], out[0][2], zeros, zeros, one))
    gen = torch.Generator(dev).manual_seed(19)
    fp3 = torch.randn(N, 300, device=dev, generator=gen)
    fc3 = torch.randn(N, 300, device=dev, generator=gen)
    b12p = t(rng.integers(0, 12, N), i32)
    b12c = t(rng.integers(0, 12, N), i32)
    bank_3 = _wide_bank(fc3, b12c, 12, 25, 23, rng)
    out.append(("F=300,bins=12x25", fp3, fc3, b12p, b12c, bank_3))
    return out


def _h4_scores(args, hot, wide, summary):
    """(a) H4 with and without its score output at the table's regimes:
    ids bitwise equal, scores against the plain version's where the ids
    agree (mismatching ids must be near-ties), times of both forms."""
    import torch

    from msm_we_tpu_torch.ops import stratified_assign as sa

    dev = torch.device("cuda")
    reps = args.reps
    for regime, fp, fc, pb, cb, bk in _mesh_regimes(hot, wide, dev):
        N, F = fc.shape
        SS = bk[0].shape[0] + 2
        ids = sa.pair_assign(fp, fc, pb, cb, *bk)
        pk, ck, pmin, cmin = sa.pair_assign(fp, fc, pb, cb, *bk, return_scores=True)
        require(torch.equal(pk, ids[0]) and torch.equal(ck, ids[1]),
                f"H4 [{regime}] ids differ with the score output")
        one, one_min = sa.pair_assign(None, fc, None, cb, *bk, return_scores=True)
        require(torch.equal(one, ids[1]) and torch.equal(one_min, cmin),
                f"H4 [{regime}] one-set scores differ from the pair launch's")
        pp, cp, ppm, cpm = sa.pair_assign_plain(fp, fc, pb, cb, *bk,
                                                return_scores=True)
        torch.cuda.synchronize()
        m1, t1 = _compare_ids("pair_assign_scores", regime, pk, pp, SS, fp, pb, bk)
        m2, t2 = _compare_ids("pair_assign_scores", regime, ck, cp, SS, fc, cb, bk)
        err = 0.0
        for k, p, km, pm in ((pk, pp, pmin, ppm), (ck, cp, cmin, cpm)):
            require(torch.equal(torch.isinf(km), torch.isinf(pm)),
                    f"H4 [{regime}] +inf scores differ from the plain version's")
            same = (k == p) & torch.isfinite(pm)
            err = max(err, float((km[same] - pm[same]).abs().max()))
        scale = float(torch.maximum(pmin.abs().max(), cmin.abs().max()))
        require(err <= 1e-4 * max(scale, 1.0),
                f"H4 [{regime}] scores differ from the plain version's by {err}")
        del pp, cp, ppm, cpm
        call = lambda: sa.pair_assign(fp, fc, pb, cb, *bk)  # noqa: E731
        scall = lambda: sa.pair_assign(fp, fc, pb, cb, *bk, return_scores=True)  # noqa: E731
        ms, ms_s = cuda_ms(call, reps), cuda_ms(scall, reps)
        dms = device_ms(call, "pair_assign_kernel", reps)
        dms_s = device_ms(scall, "pair_assign_kernel", reps)
        pms = cuda_ms(lambda: sa.pair_assign_plain(fp, fc, pb, cb, *bk,
                                                   return_scores=True), reps)
        pairs = _same_bin_pairs(pb, bk) + _same_bin_pairs(cb, bk)
        # The score form writes 4 more bytes a row
        bound = _bound([fp, fc, pb, cb, *bk, pk, ck, pmin, cmin], 2 * pairs * F)
        emit(dict(phase="mesh", check="h4_scores", regime=regime, n=int(N),
                  K=int(bk[0].shape[0]), F=int(F), ids_bitwise=True,
                  id_mismatches_vs_plain=m1 + m2, near_ties=t1 + t2,
                  max_abs_score_err=err, ms=ms, ms_scores=ms_s, kernel_ms=dms,
                  kernel_ms_scores=dms_s, plain_ms=pms, bound_ms=bound[0],
                  bound_by=bound[1]))
        if regime == "K=250":
            summary["pair_assign_scores"] = dict(
                ms=ms_s, plain_ms=pms, max_abs_err=err, bound_ms=bound[0],
                bound_by=bound[1], kernel_ms=dms_s)


def _nccl_build(args, data, hot, smi):
    """(b) One NCCL rank: the bench build at 101 x 10,000 with both device
    routes on and ``enable_mesh()`` over a process group of one, against the
    no-mesh device route (no process group) of the same data; the one-rank
    mesh step against ``fused_step_single`` on the hot problem. Returns
    (line, launch counts of the mesh build)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.parallel import build_sharded_step, make_mesh
    from msm_we_tpu_torch.step import fused_step_single

    with _device_route():
        ref_s, ref = _build(data, None, True, 25)
    require(not ref._mesh.distributed, "the reference build has a process group")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        init_s = time.perf_counter() - t0
        sa.reset_launch_counts()
        with _device_route():
            secs, m = _build(data, None, True, 25)
        counts = dict(sa.launch_counts(), pair_assign_scores=sa.pair_assign.score_launches)
        require(m._mesh.distributed and m._mesh.backend == "nccl",
                f"the mesh build ran on {m._mesh}")
        for name in ("assign_flux", "pair_assign"):
            require(counts[name] > 0, f"{name} never launched on the NCCL rank's build")
        ref._ensure_discretized()
        m._ensure_discretized()
        require(np.array_equal(np.concatenate(m.dtrajs), np.concatenate(ref.dtrajs)),
                "dtrajs differ between the NCCL mesh build and the one-device build")
        scale = float(np.abs(ref.fluxMatrixRaw).max())
        flux_err = float(np.abs(m.fluxMatrixRaw - ref.fluxMatrixRaw).max()) / scale
        j_err = abs(m.JtargetSS - ref.JtargetSS) / abs(ref.JtargetSS)
        require(flux_err <= 1e-12 and j_err <= 1e-12,
                f"NCCL mesh build differs: flux {flux_err}, JtargetSS {j_err}")
        # The one-rank mesh step (H3 + the NCCL all-reduce) against the
        # one-device step, dyadic f64 weights
        mesh = make_mesh(device="cuda")
        dev = torch.device("cuda")
        keys = ("fp", "fc", "pbins", "cbins", "basis_p", "basis_c", "target_c", "w",
                "centers", "center_bin", "valid")
        dt = dict(fp=torch.float32, fc=torch.float32, pbins=torch.int32,
                  cbins=torch.int32, basis_p=torch.bool, basis_c=torch.bool,
                  target_c=torch.bool, w=torch.float64, centers=torch.float32,
                  center_bin=torch.int32, valid=torch.bool)
        a = [torch.as_tensor(np.asarray(hot[k])).to(dt[k]).to(dev).contiguous()
             for k in keys]
        S = int(hot["n_states"])
        step = build_sharded_step(mesh, S)
        require(torch.equal(step(*a), fused_step_single(*a, S)[0]),
                "the one-rank mesh step's flux differs from fused_step_single's")
        ms_mesh = cuda_ms(lambda: step(*a), args.reps)
        ms_one = cuda_ms(lambda: fused_step_single(*a, S), args.reps)
    finally:
        dist.destroy_process_group()
    return dict(phase="mesh", check="nccl_one_rank_build", nvidia_smi=smi,
                segments=int(sum(len(d) for d in m.dtrajs)), init_s=init_s,
                seconds=secs, seconds_no_mesh=ref_s, stages=_route_stages(m),
                stages_no_mesh=_route_stages(ref), flux_rel_err=flux_err,
                JtargetSS=float(m.JtargetSS), JtargetSS_rel_err=j_err,
                dtrajs_equal=True, launch_counts=counts,
                mesh_step_ms=ms_mesh, fused_step_single_ms=ms_one,
                mesh_step_overhead_ms=ms_mesh - ms_one), counts


def phase_mesh(args, summary, smi):
    """``parallel/``: H4's score output, one NCCL rank's build, and the
    gloo dryruns of 2 and 4 ranks sharing the card."""
    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.entry import dryrun_multichip, hot_problem, wide_problem
    from msm_we_tpu_torch.parallel.distributed import launch_local_dryrun

    t_phase = time.perf_counter()
    hot = hot_problem()
    wide = wide_problem(hot)
    _h4_scores(args, hot, wide, summary)
    torch.cuda.empty_cache()
    data = summary.get("analysis_data")
    if data is None:
        data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
        summary["analysis_data"] = data
    line, total = _nccl_build(args, data, hot, smi)
    emit(line)
    per_rank = {}
    for n in (2, 4):
        r = dryrun_multichip(n, device="cuda", base={"hot": hot, "wide": wide},
                             timeout=300)
        jobs = {c["name"]: {k: v for k, v in c.items() if k != "name"}
                for c in r["checks"]}
        for counts in r["rank_launches"]:
            _add_counts(total, counts)
        per_rank[f"dryrun_multichip_{n}"] = r["rank_launches"]
        emit(dict(phase="mesh", check=f"dryrun_multichip_{n}", backend="gloo",
                  seconds=r["seconds"], jobs=jobs, rank_launches=r["rank_launches"]))
    for n, m, name, prob in ((2, 2, "K=250", hot), (2, 1, "K=3200", wide),
                             (4, 2, "K=250", hot), (4, 1, "K=3200", wide)):
        t0 = time.perf_counter()
        fm = launch_local_dryrun(n, model_parallel=m, backend="gloo", device="cuda",
                                 problem=prob, timeout=300)
        ranks = launch_local_dryrun.rank_launches
        for counts in ranks:
            _add_counts(total, counts)
        emit(dict(phase="mesh", check="launch_local_dryrun", backend="gloo",
                  mesh=[n // m, m], regime=name, flux_bitwise=True,
                  flux_sum=float(fm.sum()), seconds=time.perf_counter() - t0,
                  rank_launches=ranks))
    for name in ("assign_flux", "pair_assign", "pair_assign_scores"):
        require(total.get(name, 0) > 0, f"{name} never launched in the mesh phase")
    summary["launches_mesh"] = total
    emit(dict(phase="mesh", check="launches", launch_counts=total,
              seconds=time.perf_counter() - t_phase))


# --------------------------------------------------------------- plugins

PLUGIN_EDGES = (0.0, 10.0, 13)  # the default build's WE bin grid (12 bins)


def _extended_calls(model):
    """The extended analysis on a built ``ExtendedModelWE``, each call
    timed and checked: the h-flux, kh and its variance, the kh bins of
    three methods, kh of the last iteration's segments (H4 on the card for
    10,000 rows), the evolved probabilities, the 1-D pcoord flux."""
    import numpy as np

    t = {}
    t["get_hflux"], h = _timed(lambda: model.get_hflux(conv=1e-3, max_iters=2000))
    t["get_model_aristoffian"], (kh, varh) = _timed(model.get_model_aristoffian)
    require(np.isfinite(h).all() and np.isfinite(kh).all() and np.isfinite(varh).all(),
            "h, kh or varh is not finite")
    require(float(varh.min()) >= -1e-8 * max(float(np.abs(varh).max()), 1e-300),
            f"varh is negative: {float(varh.min())}")
    bins = {}
    for method in ("adaptive", "uniform", "log_uniform"):
        model.binMethod, model.allocationMethod, model.nB, model.nW = method, "adaptive", 10, 100
        s, _ = _timed(model.get_model_steady_state_aristoffian)
        require(np.isclose(model.alloc.sum(), 1.0) and np.isfinite(model.binObjective)
                and model.binObjective >= 0, f"kh bins {method}: malformed allocation")
        require(len(model.khbins_binEdges) == len(model.khbins_binCenters) + 1,
                f"kh bins {method}: edges do not bound the centers")
        bins[method] = dict(seconds=s, bins=int(len(model.khbins_binCenters)),
                            objective=float(model.binObjective),
                            walkers=int(model.walkers_per_bin.sum()))
    last = int(model.maxIter)
    t["get_iter_aristoffian"], kh_list = _timed(lambda: model.get_iter_aristoffian(last))
    khf = np.asarray(kh).reshape(-1)
    require(kh_list.shape == (model.nSeg, 1) and np.isfinite(kh_list).all()
            and kh_list.min() >= khf.min() - 1e-12 and kh_list.max() <= khf.max() + 1e-12,
            "get_iter_aristoffian gave kh outside the model's kh")
    t["evolve_probability"], prob = _timed(lambda: model.evolve_probability(2000, 100))
    rows_err = float(np.abs(prob.sum(axis=1) - 1.0).max())
    require(rows_err <= 1e-8, f"evolved distributions sum to 1 within {rows_err}")
    t["get_pcoord1D_fluxMatrix"], fm = _timed(lambda: model.get_pcoord1D_fluxMatrix(
        0, 1, model.maxIter - 1, np.linspace(0.0, 10.0, 11)))
    require(fm.shape == (10, 10) and (fm >= 0).all() and abs(fm.sum() - 1.0) <= 1e-6,
            f"1-D pcoord flux sums to {fm.sum()}")
    return dict(seconds=t, states=int(model.nBins), kh_bins=bins, iteration=last,
                evolve_rows_max_err=rows_err, pcoord1d_flux_sum=float(fm.sum()))


def _extended_parity(small):
    """(a) The same calls on the card and on the CPU at 30 x 200: the
    dtrajs and the last iteration's cluster ids equal except at near-ties,
    h and kh within 1e-12 relative where the ids are equal, and the
    evolved distributions each sum to 1."""
    import numpy as np

    from msm_we_tpu_torch.extended import ExtendedModelWE
    from msm_we_tpu_torch.testing import near_tie_rows

    _t, g = _default_build(small, "cuda", model_cls=ExtendedModelWE)
    _t, c = _default_build(small, "cpu", model_cls=ExtendedModelWE)
    for m in (g, c):
        m.get_hflux(conv=1e-3, max_iters=2000)
        m.get_model_aristoffian()
    dg, dc = np.concatenate(g.dtrajs), np.concatenate(c.dtrajs)
    flips = int((dg != dc).sum())
    # The last iteration's children through each model's bank (the
    # predictions _model_cluster_assign makes)
    it = int(c.maxIter)
    c.load_iter_data(it)
    _p, child, _w = c._dataset.iter_coord_pairs(it)
    pc = c.pcoord1List
    feats = c.reduceCoordinates(np.nan_to_num(child)).astype(np.float32)
    bins = c._bin_mapper.assign(np.nan_to_num(pc))
    raw = [m._strat.predict(feats, bins, is_basis=c.is_WE_basis(pc),
                            is_target=c.is_WE_target(pc)) for m in (g, c)]
    bad = np.flatnonzero(raw[0] != raw[1])
    if len(bad):
        strat = c._strat
        require(near_tie_rows(bad, raw[0], raw[1], feats, strat.we_remap[bins],
                              *strat.compact_bank()).all(),
                f"{len(bad)} cluster ids differ card vs CPU and are not near-ties")
    elif not flips:
        g.load_iter_data(it)
        require(np.array_equal(g._model_cluster_assign(child, pc),
                               c._model_cluster_assign(child, pc)),
                "_model_cluster_assign differs card vs CPU")
    res = dict(rows=int(len(dc)), dtraj_flips=flips, iteration_id_flips=int(len(bad)),
               JtargetSS_gpu=float(g.JtargetSS), JtargetSS_cpu=float(c.JtargetSS))
    for m in (g, c):
        m.evolve_probability(2000, 100)
        require(np.abs(m.probTransient.sum(axis=1) - 1.0).max() <= 1e-8,
                "an evolved distribution does not sum to 1")
    if flips:
        require(flips <= 1e-3 * len(dc), f"{flips} dtraj rows flip card vs CPU")
        return res, g
    errs = {}
    for name in ("h", "kh", "varh", "pEvolved"):
        a, b = np.asarray(getattr(g, name), float), np.asarray(getattr(c, name), float)
        errs[name] = float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-300))
        require(errs[name] <= 1e-12, f"{name} differs card vs CPU by {errs[name]}")
    res["max_rel_err"] = errs
    return res, g


def _cli_api_build(path, flags):
    """The port's API sequence the CLI's ``build`` drives with ``flags``
    (stratified, default bin grid), on the card."""
    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.model import modelWE

    model = modelWE(device="cuda")
    model.initialize([path], {"coords": None, "nAtoms": 1, "coord_ndim": 3},
                     "cli_model", basis_pcoord_bounds=[[9.0, 10.0]],
                     target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="none",
                     tau=1.0, _suppress_boundary_warning=True)
    model.device_pipeline = "--device-pipeline" in flags
    if model.device_pipeline:
        model.enable_mesh()
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    ext = [0.0, 9.0, 10.0, 0.0, 1.0]
    for i in range(1, model.maxIter):
        d = model._dataset.iter_data(i)
        for key in ("pcoord0", "pcoord1"):
            ext += [float(np.nanmin(d[key][:, 0])), float(np.nanmax(d[key][:, 0]))]
    lo, hi = min(ext), max(ext)
    span = hi - lo
    model.cluster_coordinates(n_clusters=5, stratified=True, user_bin_mapper=(
        RectilinearBinMapper([np.linspace(lo - 0.001 * span, hi + 0.001 * span, 11)])))
    model.get_fluxMatrix(1)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    return dict(n_clusters=int(model.n_clusters), n_lag=1, lagtime=float(model.lagtime),
                JtargetSS=float(model.JtargetSS), pSS=[float(x) for x in model.pSS])


def _cli_main(argv):
    """``msm-we-tpu-torch argv`` with its standard output captured."""
    import contextlib
    import io

    from msm_we_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, f"msm-we-tpu-torch {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def _cli_checks(model, tmp_dir):
    """(b) The CLI and the mdtraj surface on the card: ``info`` names the
    card; ``generate`` and ``build`` (with and without
    ``--device-pipeline``, each JSON equal to the API sequence) where h5py
    imports, else ``build`` raises the ``ImportError`` naming h5py;
    ``validate`` of ``model`` saved with its ids deferred (the command
    materializes them on the card) equals the implied timescales and the
    CK test of the in-memory model; ``set_topology`` of a ``.dat`` file,
    and of a ``.prmtop`` path without mdtraj raises naming it."""
    import importlib.util
    import numpy as np
    import torch

    from msm_we_tpu_torch.model import modelWE
    from msm_we_tpu_torch.ops.linalg import (
        chapman_kolmogorov_from_flux,
        implied_timescales_from_flux,
        pcca_sets,
    )

    out = {}
    info = _cli_main(["info"])
    require(torch.cuda.get_device_name(0) in info, f"info does not name the card: {info}")
    out["info"] = info.strip().splitlines()
    path = os.path.join(tmp_dir, "cli_west.h5")
    bounds = ["--basis", "9", "10", "--target", "0", "1"]
    if importlib.util.find_spec("h5py") is None:
        try:
            _cli_main(["build", path, *bounds])
        except ImportError as e:
            require("h5py" in str(e), f"the ImportError does not name h5py: {e}")
            out["build"] = dict(h5py=False, import_error=str(e)[:120])
        else:
            raise Failure("build on a path did not raise ImportError without h5py")
    else:
        _cli_main(["generate", path, "--iterations", "30", "--segments", "200",
                   "--seed", "17"])
        out["build"] = dict(h5py=True)
        for extra in ([], ["--device-pipeline"]):
            flags = ["--n-clusters", "5", "--stratified", "--lag", "1", *extra]
            res_path = os.path.join(tmp_dir, "cli_build.json")
            s, _ = _timed(lambda: _cli_main(["build", path, *bounds, *flags,
                                             "--output", res_path]))
            with open(res_path) as fh:
                got = json.load(fh)
            require(got == _cli_api_build(path, flags),
                    f"build {extra} JSON differs from the API sequence")
            out["build"]["device_pipeline" if extra else "host_route"] = dict(
                seconds=s, JtargetSS=got["JtargetSS"])

    # validate: the model saved with its ids deferred
    lags = [0, 1, 2]
    fms, lag_times = model._lagged_flux_matrices(lags, iters_to_use=None,
                                                  drop_basis_target=True)
    ts = implied_timescales_from_flux(fms, lag_times, n_timescales=3)
    factors = np.rint(lag_times / lag_times[0]).astype(int)
    sets, predicted, estimated = chapman_kolmogorov_from_flux(
        fms, factors, sets=pcca_sets(fms[0], 2))
    ids = np.concatenate(model.dtrajs)
    saved = (model.dtrajs, model.pair_dtrajs, model._parent_idx, model._child_idx)
    model.dtrajs = model.pair_dtrajs = model._parent_idx = model._child_idx = None
    obj = os.path.join(tmp_dir, "cli_model.obj")
    model.save(obj)
    model.dtrajs, model.pair_dtrajs, model._parent_idx, model._child_idx = saved
    res_path = os.path.join(tmp_dir, "cli_validate.json")
    s, _ = _timed(lambda: _cli_main(["validate", obj, "--lags", *map(str, lags),
                                     "--pcca-sets", "2", "--output", res_path]))
    with open(res_path) as fh:
        got = json.load(fh)

    def close(a, b, what):
        a = np.array(a, dtype=float)
        b = np.array(b, dtype=float)
        err = float(np.nanmax(np.abs(a - b)) / max(float(np.nanmax(np.abs(b))), 1e-300))
        require(a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
                and err <= 1e-12, f"validate {what} differs by {err}")
        return err

    errs = dict(lag_times=close(got["lag_times"], lag_times, "lag times"),
                implied_timescales=close(got["implied_timescales"], ts, "timescales"),
                ck_predicted=close(got["ck_predicted"], predicted, "CK predicted"),
                ck_estimated=close(got["ck_estimated"], estimated, "CK estimated"))
    require(got["ck_sets"] == [[int(x) for x in S] for S in sets], "CK sets differ")
    reloaded = modelWE.load(obj, device="cuda")
    reloaded._ensure_discretized()
    require(np.array_equal(np.concatenate(reloaded.dtrajs), ids),
            "the ids minted on the card differ from the build's")
    out["validate"] = dict(seconds=s, max_rel_err=errs, lags=lags)

    # The mdtraj surface: .dat through numpy, a .prmtop path through mdtraj
    dat = os.path.join(tmp_dir, "ref.dat")
    np.savetxt(dat, np.arange(12.0).reshape(4, 3))
    m = modelWE(device="cuda")
    m.set_topology(dat)
    m.set_basis(dat)
    require(m.nAtoms == 1 and np.array_equal(m.reference_coord, np.loadtxt(dat))
            and np.array_equal(m.basis_coords, np.loadtxt(dat)), "set_topology(.dat)")
    out["topology_dat"] = True
    if importlib.util.find_spec("mdtraj") is None:
        try:
            m.set_topology(os.path.join(tmp_dir, "ref.prmtop"))
        except ImportError as e:
            require("mdtraj" in str(e), f"the ImportError does not name mdtraj: {e}")
            out["topology_prmtop"] = dict(mdtraj=False, import_error=str(e)[:80])
        else:
            raise Failure("set_topology(.prmtop) did not raise ImportError without mdtraj")
    else:
        out["topology_prmtop"] = dict(mdtraj=True, checked=False)
    return out


def _install_func_bin_mapper():
    """An in-process stand-in for ``westpa.core.binning.FuncBinMapper``
    (westpa is not installed on the card's machine): it keeps the
    function, the bin count and the args. Returns the modules it added."""
    import types

    class FuncBinMapper:
        def __init__(self, func, nbins, args=None, kwargs=None):
            self.func, self.nbins, self.args = func, nbins, tuple(args or ())

    binning = types.ModuleType("westpa.core.binning")
    binning.FuncBinMapper = FuncBinMapper
    core = types.ModuleType("westpa.core")
    core.binning = binning
    westpa = types.ModuleType("westpa")
    westpa.core = core
    added = {"westpa": westpa, "westpa.core": core, "westpa.core.binning": binning}
    for name, mod in added.items():
        require(name not in sys.modules, f"{name} is already imported")
        sys.modules[name] = mod
    return added


def _driver_checks(data, tmp_dir):
    """(c) The WESTPA drivers on the card over the 101 x 10,000 run."""
    import pickle
    import shutil

    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE
    from msm_we_tpu_torch.westpa_plugins.hamsm_driver import build_hamsm_from_config
    from msm_we_tpu_torch.westpa_plugins.optimization_driver import (
        _wrap_for_westpa,
        compute_new_pcoord_map,
        compute_optimized_bins_for_model,
    )
    from msm_we_tpu_torch.westpa_plugins.restart_driver import (
        start_state_entries,
        write_restart_artifacts,
    )

    out, total = {}, {}
    ref = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
    config = dict(model_name="smoke_driver", n_clusters=25, tau=1.0,
                  basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
                  dimreduce_method="pca", ref_pdb_file=ref, show_live_display=False,
                  user_bin_mapper=RectilinearBinMapper([np.linspace(*PLUGIN_EDGES)]),
                  device="cuda")
    (s, model), counts = _counted(lambda: _timed(
        lambda: build_hamsm_from_config(config, ArrayWEDataset(data))))
    _add_counts(total, counts)
    require(model.device.type == "cuda", "the driver's model is not on the card")
    plain = modelWE(device="cuda")
    s_plain, _ = _timed(lambda: plain.build_analyze_model(
        file_paths=ArrayWEDataset(data), ref_struct=ref, modelName="smoke_driver",
        basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca", n_clusters=25, tau=1.0,
        step_kwargs={"dimReduce": {"use_weights": True, "variance_cutoff": 0.95,
                                   "first_iter": 1},
                     "clustering": {"first_cluster_iter": 1,
                                    "user_bin_mapper": config["user_bin_mapper"]}},
        fluxmatrix_iters=[1, -1], allow_validation_failure=True,
        cross_validation_groups=2, device_pipeline=False, show_live_display=False))
    require(model.JtargetSS == plain.JtargetSS
            and np.array_equal(np.concatenate(model.dtrajs), np.concatenate(plain.dtrajs)),
            "build_hamsm_from_config differs from build_analyze_model")
    del plain
    out["build"] = dict(seconds=s, seconds_plain=s_plain, JtargetSS=float(model.JtargetSS),
                        states=int(model.nBins), bitwise_equal_to_plain=True)

    s, _ = _timed(lambda: model.update_cluster_structures(build_pcoord_cache=True))
    entries = list(start_state_entries(model, model.pSS))
    weight = float(sum(w for _b, _s, w, _x in entries))
    want = float(np.asarray(model.pSS)[: model.n_clusters].sum())
    require(entries and abs(weight - want) <= 1e-6 * want,
            f"start-state weights sum to {weight}, pSS to {want}")
    out["start_states"] = dict(seconds=s, entries=len(entries), weight=weight)
    restart_dir = os.path.join(tmp_dir, "restart0")
    s, sstates = _timed(lambda: write_restart_artifacts(model, restart_dir, store_h5=True))
    with open(sstates) as fh:
        lines = fh.read().strip().splitlines()
    require(len(lines) == len(entries) and all(ln.split()[2].startswith("hdf:")
                                               for ln in lines), "startstates.txt")
    out["restart_artifacts"] = dict(seconds=s, lines=len(lines), pickle_bytes=os.path.getsize(
        os.path.join(restart_dir, "hamsm.obj")))
    shutil.rmtree(restart_dir)

    (s, mapper), counts = _counted(lambda: _timed(
        lambda: compute_optimized_bins_for_model(model, n_active_bins=12)))
    _add_counts(total, counts)
    require(mapper.clusterer.strat.device.type == "cuda", "the mapper's bank left the card")
    feats = model._featurize_all()
    start = len(feats["weights"]) // 5
    rows = slice(start, start + 100_000)
    coords = np.column_stack([feats["pcoord1"][rows], feats["child"][rows]]).astype(np.float32)
    live, counts = _counted(lambda: mapper.assign(coords))
    _add_counts(total, counts)
    added = _install_func_bin_mapper()
    try:
        wrapped = _wrap_for_westpa(mapper)
        args = pickle.loads(pickle.dumps(wrapped.args))
    finally:
        for name in added:
            sys.modules.pop(name, None)
    require(args[0].clusterer.strat.device.type == "cpu" and args[1] == "cuda",
            "the pickled args do not hold a CPU bank and the device 'cuda'")
    output = np.full(len(coords), -1)
    mask = np.ones(len(coords), bool)
    (s_assign, _), counts = _counted(lambda: _timed(
        lambda: wrapped.func(coords, mask, output, *args)))
    _add_counts(total, counts)
    require(counts["pair_assign"] > 0, "the unpickled mapper did not launch H4")
    require(args[0].clusterer.strat.device.type == "cuda",
            "the unpickled bank is not on the card after an assignment")
    require(np.array_equal(output, live), "the unpickled mapper's ids differ from the live one's")
    out["optimized_bins"] = dict(seconds=s, rows=len(coords), assign_s=s_assign,
                                 round_trip_bitwise=True, bank_device="cuda")

    rng = np.random.default_rng(3)
    coord_map = {i: rng.normal(size=(4, 3)).astype(np.float32) for i in range(1000)}
    s, pcoord_map = _timed(lambda: compute_new_pcoord_map(
        model, coord_map, lambda i: np.array([float(i)])))
    require(len(pcoord_map) == 1000 and pcoord_map[7].shape == (1 + model.ndim,)
            and pcoord_map[7][0] == 7.0, "compute_new_pcoord_map malformed")
    out["new_pcoord_map"] = dict(seconds=s, structures=1000)
    return out, total


def phase_plugins(args, summary, smi):
    """``extended``, the CLI and the WESTPA drivers, each over H4 on the
    card."""
    import shutil
    import tempfile

    import torch

    from msm_we_tpu_torch.data import generate_we_arrays
    from msm_we_tpu_torch.extended import ExtendedModelWE
    from msm_we_tpu_torch.ops import stratified_assign as sa

    t_phase = time.perf_counter()
    data = summary.get("analysis_data")
    if data is None:
        data = generate_we_arrays(n_iterations=101, n_segments=10_000, seed=17)
        summary["analysis_data"] = data
    small = generate_we_arrays(n_iterations=30, n_segments=200, seed=17)
    tmp_dir = tempfile.mkdtemp(prefix="chip_smoke_plugins_")
    total = {}
    torch.cuda.synchronize()
    sa.reset_launch_counts()
    try:
        # (a) ExtendedModelWE at full size, then card against CPU
        (s_ext, ext), build_counts = _counted(lambda: _default_build(
            data, "cuda", model_cls=ExtendedModelWE))
        _add_counts(total, build_counts)
        s_plain, plain = _default_build(data, "cuda")
        require(ext.JtargetSS == plain.JtargetSS
                and [v.JtargetSS for v in ext.validation_models]
                == [v.JtargetSS for v in plain.validation_models],
                "the ExtendedModelWE build differs from the plain build")
        del plain
        calls, counts = _counted(lambda: _extended_calls(ext))
        _add_counts(total, counts)
        require(counts["pair_assign"] > 0, "the extended calls did not launch H4")
        emit(dict(phase="plugins", check="extended", segments=int(sum(len(d) for d in ext.dtrajs)),
                  build_seconds=s_ext, plain_build_seconds=s_plain,
                  JtargetSS=float(ext.JtargetSS), bitwise_equal_to_plain=True,
                  launch_counts_build=build_counts, launch_counts_calls=counts, **calls))
        del ext
        (parity, small_model), counts = _counted(lambda: _extended_parity(small))
        _add_counts(total, counts)
        emit(dict(phase="plugins", check="extended_parity_30x200", **parity))
        a_counts = dict(total)
        require(a_counts.get("pair_assign", 0) > 0, "H4 never launched in (a)")

        # (b) the CLI
        b, counts = _counted(lambda: _cli_checks(small_model, tmp_dir))
        _add_counts(total, counts)
        require(counts["pair_assign"] > 0, "H4 never launched in the CLI checks")
        emit(dict(phase="plugins", check="cli", launch_counts=counts, **b))

        # (c) the drivers
        c, counts = _driver_checks(data, tmp_dir)
        _add_counts(total, counts)
        require(counts.get("pair_assign", 0) > 0, "H4 never launched in the drivers")
        emit(dict(phase="plugins", check="drivers", launch_counts=counts, **c))
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    summary["launches_plugins"] = total
    emit(dict(phase="plugins", check="launches", launch_counts=total,
              seconds=time.perf_counter() - t_phase, nvidia_smi=smi))


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
    ap.add_argument("--big-segments", type=int, default=100_000,
                    help="segments per iteration of the routes phase's big "
                         "build (a multiple of 8; 101 iterations)")
    ap.add_argument("--route-bins", default=",".join(map(str, ROUTE_BINS)),
                    help="bin counts (of 25 centers) of the route phase's sweep")
    args = ap.parse_args(argv)
    args.route_bins = [int(b) for b in args.route_bins.split(",") if b]
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
    if "routes" in phases:
        phase_routes(args, summary, smi)
    if "mesh" in phases:
        phase_mesh(args, summary, smi)
    if "plugins" in phases:
        phase_plugins(args, summary, smi)
    if "configs" in phases:
        phase_configs(args, summary)
    if "tail" in phases:
        phase_tail(args, summary)
    if "route" in phases:
        phase_route(args, summary)

    launches = summary.get("launches", {})
    launches_analysis = summary.get("launches_analysis", {})
    launches_configs = summary.get("launches_configs", {})
    launches_access = summary.get("launches_access", {})
    launches_routes = summary.get("launches_routes", {})
    launches_mesh = summary.get("launches_mesh", {})
    launches_plugins = summary.get("launches_plugins", {})
    kernels = []
    for name, info in KERNEL_INFO.items():
        k = summary.get(name, {})
        # H4's score form runs on the mesh path only: its launches are that
        # path's
        main_launches = launches_mesh if name == "pair_assign_scores" else launches
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=main_launches.get(name),
            launches_graph=summary.get("launches_graph", {}).get(name),
            launches_analysis=launches_analysis.get(name),
            launches_configs=launches_configs.get(name),
            launches_access=launches_access.get(name),
            launches_routes=launches_routes.get(name),
            launches_mesh=launches_mesh.get(name),
            launches_plugins=launches_plugins.get(name),
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
