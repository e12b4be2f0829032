#!/usr/bin/env python3
"""H1-H3 of one checkout's ``msm_we_tpu_torch`` at ``make_problem()`` on the
card, for comparing two trees (parent / change / change / parent) on one
card in one sitting.

    python3 scripts/kernel_ab.py run --root DIR --save FILE [--reps 20]
    python3 scripts/kernel_ab.py compare FILE [FILE ...]
    python3 scripts/kernel_ab.py builds --root DIR --data FILE [--reps 3]

``run`` imports the package from ``DIR`` (its kernels are built there at
first use), runs H1 with features, H2 with dyadic f64 flux and H3 on the
main path's problem (102,400 segments, raw 900 -> 30, K = 250), saves the
outputs to ``FILE`` and prints one JSON line: each kernel's whole-call
median ms (CUDA events) and device ms (``torch.profiler``: H1/H2's
kernel, all of H3's call), and for each
hot-step tier the median step ms (host clock around a synchronised step)
and the device ms of all its kernels a step, with the card's
``nvidia-smi`` name and power limit. ``compare`` prints, for each saved
output, whether every file holds it bitwise equal to the first file's.
``builds`` times whole builds on the card with the package from ``DIR``:
the default configuration (``chip_smoke.py``'s ``analysis`` build: block
cross-validation, predict route) and the bench configuration (device
pipeline, no validation) on the 101 x 10,000 synthetic run (seed 17,
pickled to ``FILE`` by the first call, read by the others), one cold build
and ``--reps`` warm ones each, and a host-only control (generating an 11 x
2,000 run, numpy); one JSON line of seconds, stage seconds and JtargetSS.
Run it alternately per tree. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def _cuda_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _device_ms(fn, name, reps):
    """Mean device ms a run of ``fn`` spends in the kernels whose name
    contains ``name`` (None: every kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or 0
             for ev in prof.key_averages()
             if (name in ev.key if name else ev.device_type == DeviceType.CUDA))
    return us / 1e3 / reps if us > 0 else None


def run(root, save, reps):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from msm_we_tpu_torch.entry import TIERS, hot_step, stage_problem
    from msm_we_tpu_torch.ops import stratified_assign as sa
    from msm_we_tpu_torch.testing import make_problem

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    prob = make_problem()
    staged = {t: stage_problem(prob, t, dev) for t in TIERS}
    s = staged["two_transform"]
    N = s["raw_child"].shape[0]
    S = s["n_states"]
    bank = (s["centers"], s["center_bin"], s["valid"])
    rng = np.random.default_rng(5)
    w64 = torch.as_tensor(rng.integers(1, 17, N) / 16.0, device=dev)
    h1 = (s["raw_child"], s["cbins"], s["basis_c"], s["target_c"], s["mean"],
          s["comp"], *bank, S)
    h2 = (s["raw_parent"], s["raw_child"], s["pbins"], s["cbins"])
    ovr = (s["basis_p"], s["basis_c"], s["target_c"], s["mean"], s["comp"], *bank, S)
    off = s["mean"] @ s["comp"]
    fp = (s["raw_parent"] @ s["comp"] - off).contiguous()
    fc = (s["raw_child"] @ s["comp"] - off).contiguous()
    h3 = (fp, fc, s["pbins"], s["cbins"], s["w"], s["basis_p"], s["basis_c"],
          s["target_c"], *bank, S)

    idx1, g1 = sa.transform_assign_child(*h1, emit_features=True)
    p2, c2, f2 = sa.transform_assign(*h2, w64, *ovr)
    p3, c3, f3 = sa.assign_flux(fp, fc, s["pbins"], s["cbins"], w64, *h3[5:])
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in dict(
        h1_ids=idx1, h1_features=g1, h2_pidx=p2, h2_cidx=c2, h2_flux_f64=f2,
        h3_pidx=p3, h3_cidx=c3, h3_flux_f64=f3).items()}, save)
    line = dict(root=root, nvidia_smi=_smi(), kind=torch.cuda.get_device_name(0),
                reps=reps, n=int(N))
    # H1/H2: their kernel alone; H3: every kernel of its call (plan, c2,
    # the flux's zero fill), so that trees with other H3 kernels compare
    for key, fn, name in (
        ("h1", lambda: sa.transform_assign_child(*h1, emit_features=True),
         "stratified_assign_kernel"),
        ("h2", lambda: sa.transform_assign(*h2, s["w"], *ovr), "stratified_assign_kernel"),
        ("h3", lambda: sa.assign_flux(*h3), None),
    ):
        line[key + "_ms"] = _cuda_ms(fn, reps)
        line[key + "_device_ms"] = _device_ms(fn, name, reps)
    for tier in TIERS:
        def step(tier=tier):
            hot_step(staged[tier], tier)
            torch.cuda.synchronize()
        step()
        times = []
        for _ in range(5 * reps):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        line[f"hot_step_{tier}_ms"] = sorted(times)[len(times) // 2] * 1e3
        line[f"hot_step_{tier}_device_ms"] = _device_ms(step, None, reps)
    print(json.dumps(line), flush=True)


def builds(root, data_path, reps):
    import os
    import pickle

    sys.path.insert(0, root)
    import logging

    import numpy as np

    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset, generate_we_arrays
    from msm_we_tpu_torch.model import modelWE

    if not os.path.exists(data_path):
        with open(data_path, "wb") as fh:
            pickle.dump(generate_we_arrays(n_iterations=101, n_segments=10_000,
                                           seed=17), fh)
    with open(data_path, "rb") as fh:
        data = pickle.load(fh)
    mapper = RectilinearBinMapper([np.linspace(0, 10, 13)])
    logging.getLogger("msm_we_tpu_torch").setLevel(logging.WARNING)

    def build(bench):
        model = modelWE(device="cuda")
        kw = dict(cross_validation_groups=0, device_pipeline=True) if bench else {}
        t0 = time.perf_counter()
        model.build_analyze_model(
            file_paths=ArrayWEDataset(data),
            ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
            modelName="ab", basis_pcoord_bounds=[[9.0, 10.0]],
            target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
            n_clusters=25, show_live_display=False,
            step_kwargs={"clustering": {"user_bin_mapper": mapper,
                                        "scan_small_batches": True}}, **kw)
        return time.perf_counter() - t0, model

    line = dict(root=root, nvidia_smi=_smi())
    for name, bench in (("default", False), ("bench", True)):
        cold, _m = build(bench)
        warm = [build(bench) for _ in range(reps)]
        model = warm[-1][1]
        line[name] = dict(
            cold_s=cold, warm_s=[t for t, _ in warm],
            median_warm_s=sorted(t for t, _ in warm)[len(warm) // 2],
            stages={n: t for n, t, _ in model.stage_timings.stages},
            JtargetSS=float(model.JtargetSS))
    t0 = time.perf_counter()
    generate_we_arrays(n_iterations=11, n_segments=2_000, seed=3)
    line["control_generate_s"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)


def compare(files):
    import torch

    outs = [torch.load(f) for f in files]
    res = {k: all(torch.equal(o[k], outs[0][k]) for o in outs[1:]) for k in outs[0]}
    print(json.dumps(dict(files=files, bitwise_equal=res)), flush=True)
    return 0 if all(res.values()) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", required=True)
    r.add_argument("--save", required=True)
    r.add_argument("--reps", type=int, default=20)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs="+")
    b = sub.add_parser("builds")
    b.add_argument("--root", required=True)
    b.add_argument("--data", required=True)
    b.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.root, args.save, args.reps)
        return 0
    if args.cmd == "builds":
        builds(args.root, args.data, args.reps)
        return 0
    return compare(args.files)


if __name__ == "__main__":
    sys.exit(main())
