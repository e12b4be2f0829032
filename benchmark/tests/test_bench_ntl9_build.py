"""The build cell at NTL9 widths ``westpa_ntl9.100k``: its three readers
(``build.reduce_moments_s``, ``build.project_s``,
``build.parent_gathered_share``) on hand-made records, its driver
(``drivers/build_wide.py``) against the program and against a program
without the spans and counts (at 11 x 200 segments of its 900-wide run),
and one run of the cell on the CPU at 21 x 1,000 segments."""
import importlib.util
import os

import pytest

import bench_helpers

CELL = "westpa_ntl9.100k"
READERS = ("build.reduce_moments_s", "build.project_s", "build.parent_gathered_share")
SPANS = ("clean", "steady_state", "reduce_moments", "project")
COUNTS = ("fold_host_bins", "fold_device_bins", "fold_gathered_iterations",
          "fold_remapped_bins", "parent_rows_gathered", "parent_rows_projected",
          "dedup_fallback")
SMALL = dict(n_iterations=11, n_segments=200)
# Rows enough a WE bin for the cell's limits, read at 101 x 1,000 (fewer
# rows a bin leave more to a Lloyd step)
CHECKED = dict(n_iterations=21, n_segments=1000)


def _module(*parts):
    path = os.path.join(bench_helpers.BENCH, *parts)
    name = "bench_ntl9_" + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(name):
    return _module("metrics", name + ".py")


def _record(spans=None, counts=None):
    spans = [dict(reduce_moments=0.2, project=0.1), dict(reduce_moments=0.4, project=0.3)] \
        if spans is None else spans
    counts = [dict(parent_rows_gathered=97, parent_rows_projected=3)] * 2 \
        if counts is None else counts
    return dict(build_spans=spans, trace_counts=counts)


def test_the_readers_read_their_record():
    rec = _record()
    assert _metric("build.reduce_moments_s").read(rec) == pytest.approx(0.3)
    assert _metric("build.project_s").read(rec) == pytest.approx(0.2)
    assert _metric("build.parent_gathered_share").read(rec) == pytest.approx(97.0)
    # A build that fell back gathered nothing: its share is 0, not silence
    fell_back = [dict(parent_rows_gathered=None, parent_rows_projected=100,
                      dedup_fallback=1)] * 2
    assert _metric("build.parent_gathered_share").read(_record(counts=fell_back)) == 0.0


SILENT = {
    "no_fields": {},
    "no_builds": dict(build_spans=[], trace_counts=[]),
    "none_values": _record(spans=[dict(reduce_moments=None, project=None)] * 2,
                           counts=[dict(parent_rows_gathered=None,
                                        parent_rows_projected=None)] * 2),
    "no_keys": _record(spans=[{}, {}], counts=[{}, {}]),
    "one_build_without": _record(spans=[dict(reduce_moments=0.2, project=0.1), {}],
                                 counts=[dict(parent_rows_gathered=3,
                                              parent_rows_projected=1), {}]),
}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("rec", SILENT.values(), ids=SILENT.keys())
def test_the_readers_are_silent_without_their_fields(name, rec):
    assert _metric(name).read(rec) is None


def test_the_share_is_silent_without_parent_rows():
    rec = _record(counts=[dict(parent_rows_gathered=0, parent_rows_projected=0)])
    assert _metric("build.parent_gathered_share").read(rec) is None


def _small_copy(tmp_path, sizes=SMALL):
    """``bench_helpers.small_copy`` with the cell's traffic cut to ``sizes``:
    the configuration's widths, fewer rows."""
    bench = bench_helpers.small_copy(str(tmp_path))
    path = os.path.join(bench, "workloads", CELL + ".json")
    wl = bench_helpers.load_json(path)
    wl["traffic"].update(sizes)
    bench_helpers.dump_json(wl, path)
    return bench


def _cell(bench, tmp_path):
    import torch

    run = bench_helpers.harness(bench)
    wl = run.load_json(os.path.join(bench, "workloads", CELL + ".json"))
    cfg = run.load_json(os.path.join(bench, "configs", wl["config"] + ".json"))
    run._import_program()
    driver = run.load_module(os.path.join(bench, "drivers", wl["driver"] + ".py"),
                             "bench_driver_ntl9_" + tmp_path.name)
    return driver.Cell(cfg, wl, 2**31 + 41, torch.device("cpu"))


def test_the_cell_runs_the_wide_run(tmp_path):
    """The driver's run is the configuration's: 900 raw coordinates on
    ``westpa_default``'s WE run; the other build cells keep theirs."""
    from benchmark.traffic import we_run

    cell = _cell(_small_copy(tmp_path), tmp_path)
    assert cell.data[0]["coords"].shape == (200, 2, 300, 3)
    spans_driver = _module("drivers", "build_spans.py")
    assert spans_driver.base.generate is we_run.generate
    assert spans_driver.SPANS == ("clean", "steady_state")


def test_the_driver_keeps_the_spans_and_the_counts(tmp_path):
    """Window builds give their spans; a profiled build gives its counts."""
    cell = _cell(_small_copy(tmp_path), tmp_path)
    res = cell.window(0.1, trace=True)
    spans = res["record"]["build_spans"]
    assert len(spans) == res["attempted"] and res["record"]["trace_counts"] == []
    assert all(set(b) == set(SPANS) for b in spans)
    assert all(b["reduce_moments"] > 0 and b["project"] > 0 for b in spans)
    cell._build(profile_dir=str(tmp_path / "trace"))
    counts = cell._counts[-1]
    assert set(counts) == set(COUNTS)
    # On the CPU the 900-wide projection is host numpy, which may round a
    # row by its company: where the gather's checks fail, every parent is
    # projected
    gathered = counts["parent_rows_gathered"] or 0
    assert gathered + counts["parent_rows_projected"] == 10 * 200
    assert (counts["dedup_fallback"] == 1) == (gathered == 0)
    rec = dict(res["record"], trace_counts=cell._counts)
    share = _metric("build.parent_gathered_share").read(rec)
    assert share == pytest.approx(100.0 * gathered / (10 * 200))


def test_the_driver_runs_a_program_without_the_spans(tmp_path, monkeypatch):
    """A program without the spans ``reduce_moments`` and ``project`` and the
    parent-row counts, as before they were added: the driver's record holds
    None, and the readers report nothing."""
    from msm_we_tpu_torch import features, tracing

    enter = tracing.span.__enter__

    def without(self):
        if self.name in ("reduce_moments", "project"):
            self._t0 = None
            return self
        return enter(self)

    monkeypatch.setattr(tracing.span, "__enter__", without)
    monkeypatch.setattr(features, "count", lambda *_a: None)
    cell = _cell(_small_copy(tmp_path), tmp_path)
    res = cell.window(0.1, trace=True)
    cell._build(profile_dir=str(tmp_path / "trace"))
    rec = dict(res["record"], trace_counts=cell._counts)
    for b in rec["build_spans"]:
        assert b["reduce_moments"] is None and b["project"] is None
    for b in rec["trace_counts"]:
        assert all(b[n] is None for n in COUNTS[4:])
    for name in READERS:
        assert _metric(name).read(rec) is None
    cell.release()
    assert dict(cell.check())["bad_ids"] == 0


def test_a_cpu_run_of_the_cell_is_correct(tmp_path):
    """The cell at 21 x 1,000 segments on the CPU, its build held to the
    cell's limits; a traced run reads the spans (no profiled builds off the
    card, so no counts)."""
    bench = _small_copy(tmp_path, CHECKED)
    res, compared, _r = bench_helpers.run_cpu(bench, CELL, seconds=0.3)
    assert res["correct"] and res["attempted"] > 0, compared
    assert set(res["metrics"]) == {"setup_s", "build_s"}
    run = bench_helpers.harness(bench)
    res, compared, _r = run.run(CELL, 2**31 + 43, 0.3, 1, device="cpu", bench_dir=bench)
    assert res["correct"], compared
    assert {"build.reduce_moments_s", "build.project_s", "build.reduction_s"} <= set(res["metrics"])
    assert "build.parent_gathered_share" not in res["metrics"]
    assert res["metrics"]["build.reduce_moments_s"]["value"] <= res["metrics"][
        "build.reduction_s"]["value"]
