"""Helpers of the benchmark's tests: a copy of the benchmark at sizes a CPU
test can hold, and one run of a cell in it."""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_CONFIGS = {
    "ntl9_100k": dict(n_segments=2048, n_raw_features=60, n_components=8,
                      clusters_per_bin=5),
}
SMALL_TRAFFIC = {
    "westpa_default.1m": dict(n_iterations=30, n_segments=200),
    "westpa_default.100k": dict(n_iterations=24, n_segments=120),
}


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def dump_json(obj, path):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)


def small_copy(dest):
    """A checkout at ``dest``: ``BENCHMARK.json``, a copy of ``benchmark/``
    with the configurations and traffic cut to CPU-test sizes, and a link
    to the program. Returns the copy's ``benchmark`` directory."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    os.symlink(os.path.join(ROOT, "msm_we_tpu_torch"),
               os.path.join(dest, "msm_we_tpu_torch"))
    for name, sizes in SMALL_CONFIGS.items():
        path = os.path.join(bench, "configs", name + ".json")
        dump_json(dict(load_json(path), **sizes), path)
    for name, sizes in SMALL_TRAFFIC.items():
        path = os.path.join(bench, "workloads", name + ".json")
        w = load_json(path)
        w["traffic"].update(sizes)
        dump_json(w, path)
    return bench


def harness(bench):
    """The ``run`` module of the benchmark copy ``bench``."""
    spec = importlib.util.spec_from_file_location(
        "bench_run_" + str(abs(hash(bench))), os.path.join(bench, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cpu(bench, cell, seed=2**31 + 3, seconds=0.3):
    """One run of ``cell`` in the copy ``bench`` on the CPU (the harness's
    look for a card skipped): ``(result, compared, readings)``."""
    return harness(bench).run(cell, seed, seconds, 0, device="cpu", bench_dir=bench)
