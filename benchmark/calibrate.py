#!/usr/bin/env python3
"""Readings that set the limits of a cell's correctness check.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ... [--fault NAME] [--out FILE]

For each ``--seeds`` seed: the cell's set-up, a window of ``--seconds``,
and the check of what it produced (the lower readings: the program as the
configuration states it). For each ``--control-seeds`` seed: the cell's
inputs through its driver's control, the plain reference one precision
below the configuration's, held to the same check (the upper readings).
With ``--fault`` the ``--seeds`` runs take the program with that fault of
``faults.py`` planted (the upper readings of a number that a lower
precision cannot move).
One JSON line per seed, also appended to ``--out``. The benchmark's own
runs never run this; it is how the limits in ``workloads/<cell>.json``
were read, and how they are read again.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import faults  # noqa: E402
import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    wl = run.load_json(os.path.join(HERE, "workloads", args.workload + ".json"))
    cfg = run.load_json(os.path.join(HERE, "configs", wl["config"] + ".json"))
    run._import_program()
    driver = run.load_module(os.path.join(HERE, "drivers", wl["driver"] + ".py"),
                             "bench_driver_" + wl["driver"])
    dev = torch.device(args.device)
    jobs = [("program", s) for s in args.seeds] + [("control", s)
                                                   for s in args.control_seeds]
    for kind, seed in jobs:
        t0 = time.perf_counter()
        planted = faults.FAULTS[args.fault]() if args.fault and kind == "program" \
            else contextlib.nullcontext()
        with planted:
            cell = driver.Cell(cfg, wl, seed, dev)
            w = cell.window(args.seconds) if kind == "program" else None
        if kind == "program":
            cell.release()
            numbers = dict(cell.check())
            extra = dict(attempted=w["attempted"], fault=args.fault)
        else:
            cell.release()
            numbers = dict(cell.control())
            extra = {}
        line = dict(workload=args.workload, kind=kind, seed=seed, numbers=numbers,
                    limits=wl["checks"], seconds=time.perf_counter() - t0, **extra)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
