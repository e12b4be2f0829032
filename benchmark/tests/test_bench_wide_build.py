"""The wide-binned build cell ``westpa_bins128.100k``: its configuration
(``westpa_default``'s but the bins), its three readers (``build.clean_s``,
``build.steady_state_s``, ``build.fold_host_share``) on hand-made records,
its driver (``drivers/build_spans.py``) against the program and against a
program without the spans and counts, and one run of the cell on the CPU
at 21 x 1,000 segments."""
import importlib.util
import os

import numpy as np
import pytest

import bench_helpers

CELL = "westpa_bins128.100k"
CONFIG = "westpa_bins128"
READERS = ("build.clean_s", "build.steady_state_s", "build.fold_host_share")
COUNTS = ("fold_host_bins", "fold_device_bins", "fold_gathered_iterations",
          "fold_remapped_bins")
SMALL = dict(n_iterations=21, n_segments=1000)


def _module(*parts):
    path = os.path.join(bench_helpers.BENCH, *parts)
    name = "bench_wide_" + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(name):
    return _module("metrics", name + ".py")


def _config(name):
    return bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "configs",
                                                name + ".json"))


def _small_copy(tmp_path):
    """``bench_helpers.small_copy`` with the cell's traffic cut to 21 x 1,000
    segments: the configuration's widths and bins, fewer iterations."""
    bench = bench_helpers.small_copy(str(tmp_path))
    path = os.path.join(bench, "workloads", CELL + ".json")
    wl = bench_helpers.load_json(path)
    wl["traffic"].update(SMALL)
    bench_helpers.dump_json(wl, path)
    return bench


def test_the_configuration_is_westpa_default_binned_wide():
    wide, base = _config(CONFIG), _config("westpa_default")
    assert set(wide) == set(base)
    for key in set(base) - {"name", "source", "deployment", "assumed"}:
        if key in ("build", "synthetic"):
            continue
        assert wide[key] == base[key], key
    for key in base["build"]:
        if key != "we_bin_edges":
            assert wide["build"][key] == base["build"][key], key
    for key in base["synthetic"]:
        if key != "n_we_bins":
            assert wide["synthetic"][key] == base["synthetic"][key], key
    assert wide["build"]["we_bin_edges"] == np.linspace(0, 10, 129).tolist()
    assert wide["synthetic"]["n_we_bins"] == 128
    assert wide["reduced"] == [] and "stratified_clustering.py" in wide["deployment"]
    assert wide["assumed"][-1].startswith("we_bins 128")
    wl = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "workloads",
                                              CELL + ".json"))
    base_wl = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "workloads",
                                                   "westpa_default.100k.json"))
    assert wl["config"] == CONFIG and wl["driver"] == "build_spans"
    assert wl["traffic"] == base_wl["traffic"] and set(wl["checks"]) == set(base_wl["checks"])


def _record(spans=None, counts=None):
    spans = [dict(clean=0.2, steady_state=0.05), dict(clean=0.4, steady_state=0.07)] \
        if spans is None else spans
    counts = [dict(fold_host_bins=90, fold_device_bins=10, fold_gathered_iterations=92,
                   fold_remapped_bins=1)] * 2 if counts is None else counts
    return dict(build_spans=spans, trace_counts=counts)


def test_the_readers_read_their_record():
    rec = _record()
    assert _metric("build.clean_s").read(rec) == pytest.approx(0.3)
    assert _metric("build.steady_state_s").read(rec) == pytest.approx(0.06)
    assert _metric("build.fold_host_share").read(rec) == pytest.approx(90.0)
    # Every bin batch on the device is a reading, not silence
    rec = _record(counts=[dict(fold_host_bins=0, fold_device_bins=7)])
    assert _metric("build.fold_host_share").read(rec) == 0.0


SILENT = {
    "no_fields": {},
    "no_builds": dict(build_spans=[], trace_counts=[]),
    "none_values": _record(spans=[dict(clean=None, steady_state=None)] * 2,
                           counts=[dict(fold_host_bins=None, fold_device_bins=None)] * 2),
    "no_keys": _record(spans=[{}, {}], counts=[{}, {}]),
    "one_build_without": _record(spans=[dict(clean=0.2, steady_state=0.05), {}],
                                 counts=[dict(fold_host_bins=3, fold_device_bins=1), {}]),
}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("rec", SILENT.values(), ids=SILENT.keys())
def test_the_readers_are_silent_without_their_fields(name, rec):
    assert _metric(name).read(rec) is None


def test_the_share_is_silent_without_bin_batches():
    rec = _record(counts=[dict(fold_host_bins=0, fold_device_bins=0)])
    assert _metric("build.fold_host_share").read(rec) is None


def test_outermost_seconds_sums_the_outer_spans_alone():
    driver = _module("drivers", "build_spans.py")
    spans = [("clean", 1.0, -1, 4), ("discretize", 0.5, 0, 4), ("clean", 0.25, 1, 4),
             ("model_copy", 0.1, -1, 9), ("clean", 2.0, -1, 9), ("steady_state", 0.3, -1, 9)]
    assert driver.outermost_seconds(spans, "clean") == 3.0
    assert driver.outermost_seconds(spans, "steady_state") == 0.3
    assert driver.outermost_seconds(spans, "featurize") is None


def test_a_cpu_run_of_the_cell_is_correct(tmp_path):
    """The cell at 21 x 1,000 segments on the CPU: 128 WE bins x 25, its
    build held to the cell's limits; a traced run reads the spans (no
    profiled builds off the card, so no counts)."""
    bench = _small_copy(tmp_path)
    res, compared, _r = bench_helpers.run_cpu(bench, CELL, seconds=0.5)
    assert res["correct"] and res["attempted"] > 0, compared
    assert set(res["metrics"]) == {"setup_s", "build_s"}
    run = bench_helpers.harness(bench)
    res, compared, _r = run.run(CELL, 2**31 + 23, 0.5, 1, device="cpu", bench_dir=bench)
    assert res["correct"], compared
    assert {"build.clean_s", "build.steady_state_s", "build.clustering_s"} <= set(res["metrics"])
    assert "build.fold_host_share" not in res["metrics"]
    assert res["metrics"]["build.clean_s"]["value"] <= res["metrics"][
        "build.flux_cleaning_s"]["value"] + res["metrics"]["build.validation_s"]["value"]


def _cell(bench, tmp_path):
    import torch

    run = bench_helpers.harness(bench)
    wl = run.load_json(os.path.join(bench, "workloads", CELL + ".json"))
    cfg = run.load_json(os.path.join(bench, "configs", wl["config"] + ".json"))
    run._import_program()
    driver = run.load_module(os.path.join(bench, "drivers", wl["driver"] + ".py"),
                             "bench_driver_wide_" + tmp_path.name)
    return driver.Cell(cfg, wl, 2**31 + 29, torch.device("cpu"))


def test_the_driver_keeps_the_spans_and_the_counts(tmp_path):
    """Window builds give their spans; a profiled build gives its counts."""
    cell = _cell(_small_copy(tmp_path), tmp_path)
    res = cell.window(0.1, trace=True)
    spans = res["record"]["build_spans"]
    assert len(spans) == res["attempted"] and res["record"]["trace_counts"] == []
    assert all(b["clean"] > 0 and b["steady_state"] > 0 for b in spans)
    cell._build(profile_dir=str(tmp_path / "trace"))
    counts = cell._counts[-1]
    assert set(counts) == set(COUNTS)
    # 20 iterations at ~8 walkers a bin: fill batches gather iterations
    assert counts["fold_gathered_iterations"] >= 10 and counts["fold_remapped_bins"] >= 0
    assert counts["fold_host_bins"] + counts["fold_device_bins"] >= 128


def test_the_driver_runs_a_program_without_the_spans(tmp_path, monkeypatch):
    """A program with neither the spans ``clean`` and ``steady_state`` nor
    the host counts, as before they were added: the driver's record holds
    None, and the readers report nothing."""
    from msm_we_tpu_torch import discretization, tracing
    from msm_we_tpu_torch.ops import stratified

    enter = tracing.span.__enter__

    def without(self):
        if self.name in ("clean", "steady_state"):
            self._t0 = None
            return self
        return enter(self)

    monkeypatch.setattr(tracing.span, "__enter__", without)
    for module in (discretization, stratified):
        monkeypatch.setattr(module, "count", lambda *_a: None)
    cell = _cell(_small_copy(tmp_path), tmp_path)
    res = cell.window(0.1, trace=True)
    cell._build(profile_dir=str(tmp_path / "trace"))
    rec = dict(res["record"], trace_counts=cell._counts)
    assert all(v is None for b in rec["build_spans"] for v in b.values())
    assert all(v is None for b in rec["trace_counts"] for v in b.values())
    for name in READERS:
        assert _metric(name).read(rec) is None
    cell.release()
    assert dict(cell.check())["bad_ids"] == 0
