#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is one process: make the cell's inputs from ``--seed``, warm up
(set-up), measure for ``--seconds``, free the program's state, hold what
the window produced to the plain reference, and print the result. With
``--trace 0`` the metrics are the cell's end-to-end metrics of
``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from what the window recorded.

Everything particular to a cell is data, found by name:
``benchmark/workloads/<cell>.json`` (configuration, driver, traffic and
the limits of the correctness check), ``benchmark/configs/<config>.json``
(the configuration's sizes and source), ``benchmark/drivers/<driver>.py``
(one module per kind of entry point) and ``benchmark/metrics/<name>.py``
(one reader per per-layer metric).

Without a CUDA device, or with fewer than the cell asks for, the run exits
with a non-zero code and prints no result. So it does when a module named
``jax``, ``jaxlib``, ``flax`` or ``msm_we_tpu`` (the JAX package) is
loaded once the window has closed.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "msm_we_tpu")
PROGRAM = "msm_we_tpu_torch"

# Build and kernel caches at fixed places inside the checkout, so that only
# the first run of a cell there compiles. The port builds its kernel
# library into msm_we_tpu_torch/_build/ of the checkout by itself.
_CACHE = os.path.join(HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


class RunError(Exception):
    """A run that cannot produce a result (no card, a missing file, a
    forbidden module): reported on standard error, exit code 2."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    """The module in the file ``path`` (a driver or a metric reader)."""
    if not os.path.isfile(path):
        raise RunError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None):
    """Top-level names among ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole: ``msm_we_tpu_torch`` is not
    ``msm_we_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def _metric_cells(metric, spec):
    """The cells a metric is reported in: its ``workloads``, else every
    cell (an end-to-end metric without the key, as ``setup_s``)."""
    if "workloads" in metric:
        return set(metric["workloads"])
    return {w["name"] for w in spec["workloads"]}


def cell_metrics(spec, cell, kind):
    """The metrics of ``spec[kind]`` that ``cell`` reports, in file order."""
    return [m for m in spec[kind] if cell in _metric_cells(m, spec)]


def _import_program():
    """The port, from this checkout and from nowhere else."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if not os.path.isfile(os.path.join(ROOT, PROGRAM, "__init__.py")):
        raise RunError(f"{PROGRAM} is not in this checkout ({ROOT})")
    import msm_we_tpu_torch

    where = os.path.realpath(os.path.dirname(msm_we_tpu_torch.__file__))
    if where != os.path.realpath(os.path.join(ROOT, PROGRAM)):
        raise RunError(f"{PROGRAM} was loaded from {where}, not from {ROOT}")
    return msm_we_tpu_torch


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _finite(v):
    """``v`` as a float that JSON can hold: a NaN or an infinity (a check
    that found no number) reads as the largest float, above any limit."""
    v = float(v)
    return v if math.isfinite(v) else sys.float_info.max


def run(workload, seed, seconds, trace, device="cuda", bench_dir=HERE):
    """One run of the cell ``workload``; returns ``(result, compared,
    readings)``: the result line, each compared number with its limit, and
    the check's other numbers (shown, not compared).

    ``bench_dir`` holds ``workloads/``, ``configs/``, ``drivers/`` and
    ``metrics/``, with ``BENCHMARK.json`` beside it. ``device`` other than a CUDA device serves the tests
    of the harness on the CPU: no device-only metric is read there.
    """
    import torch

    spec = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise RunError(f"no cell {workload!r} in BENCHMARK.json")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: this benchmark runs on the card only")
        if torch.cuda.device_count() < entry["chips"]:
            raise RunError(f"the cell needs {entry['chips']} CUDA devices, "
                           f"{torch.cuda.device_count()} found")
    wl = load_json(os.path.join(bench_dir, "workloads", workload + ".json"))
    cfg = load_json(os.path.join(bench_dir, "configs", wl["config"] + ".json"))
    _import_program()
    driver = load_module(os.path.join(bench_dir, "drivers", wl["driver"] + ".py"),
                         "bench_driver_" + wl["driver"])

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell = driver.Cell(cfg, wl, seed, dev)
    window = cell.window(seconds, trace=bool(trace))
    # Set-up: process start to the window's first timed operation
    setup_s = window["t0"] - _T_START
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    dev_info = dict(platform="gpu" if dev.type == "cuda" else dev.type, kind=kind,
                    count=entry["chips"], memory_peak_bytes=peak)

    metrics = {}
    breakdown = None
    if trace:
        record = dict(window.get("record", {}), device_kind=kind,
                      peaks=load_json(os.path.join(bench_dir, "peaks.json")))
        for m in cell_metrics(spec, workload, "per_layer"):
            reader = load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        if "busy_s" in window:
            dev_info.update(busy_s=window["busy_s"], window_s=window["window_s"])
        breakdown = window.get("breakdown")
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        for m in cell_metrics(spec, workload, "end_to_end"):
            metrics[m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])
    if dev.type == "cuda":
        dev_info["power_limit"] = _power_limit()

    cell.release()
    numbers = dict(cell.check())
    limits = wl["checks"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise RunError(f"the check gave no number for {', '.join(missing)}")
    compared = [dict(name=n, value=_finite(numbers[n]), limit=float(limits[n]))
                for n in limits]
    correct = all(c["value"] <= c["limit"] for c in compared)
    result = dict(correct=correct, attempted=int(window["attempted"]),
                  failed=int(window["failed"]), metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: [c["value"], c["limit"]] for c in compared}
    readings = {n: v for n, v in numbers.items() if n not in limits}
    return result, compared, readings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, compared, readings = run(args.workload, args.seed, args.seconds,
                                         args.trace)
        found = forbidden_loaded()
        if found:
            raise RunError(f"forbidden modules loaded: {', '.join(found)}")
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, v in readings.items():
        print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    for c in compared:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
