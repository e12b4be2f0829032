"""``profile_trace`` and ``build_analyze_model(profile_dir=...)`` of the
port on the CPU: one Chrome trace file that parses and holds events, the
build's results bitwise unchanged, the trace written also when the block
raises, and ``profile_trace(None)`` a no-op. Spans (``tracing.span``):
sub-spans of a ``StageTimer`` stage, the same names as ranges of the
profiler's trace, nested as they ran, ``collect()`` and its collector, no
profiler range entered where nothing records, and the graph cache's spans
and traced entries (a fake capture: no card here).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, _graph, modelWE
from msm_we_tpu_torch import tracing
from msm_we_tpu_torch.data import generate_we_arrays, generate_west_h5
from msm_we_tpu_torch.tracing import StageTimer, collect, profile_trace, span

torch.set_num_threads(1)


def _build(source, groups=0, **kw):
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=source,
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="traced", basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
        n_clusters=3, cross_validation_groups=groups,
        cross_validation_blocks=4, allow_validation_failure=True,
        show_live_display=False,
        step_kwargs={"clustering": {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
            "scan_small_batches": True}},
        **kw,
    )
    return m


def _events(log_dir):
    files = glob.glob(os.path.join(str(log_dir), "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as fp:
        trace = json.load(fp)
    return files[0], [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def test_profile_trace_none_is_a_noop(tmp_path):
    with profile_trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_profile_trace_writes_one_chrome_trace(tmp_path):
    log_dir = tmp_path / "new" / "dir"  # created if absent
    with profile_trace(str(log_dir)) as prof:
        a = torch.arange(6.0).reshape(2, 3)
        (a @ a.T).sum()
    path, events = _events(log_dir)
    assert prof.trace_path == path
    names = {e["name"] for e in events}
    assert any("mm" in n or "matmul" in n for n in names), sorted(names)[:20]
    assert all(e["dur"] >= 0 for e in events)
    assert "aten::mm" in {k.key for k in prof.key_averages()} or any(
        "matmul" in k.key for k in prof.key_averages())


def test_profile_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path)):
            torch.ones(8).cumsum(0)
            1 / 0
    _path, events = _events(tmp_path)
    assert any("cumsum" in e["name"] for e in events)


@pytest.mark.parametrize("source", ["arrays", "file"])
def test_profile_dir_traces_a_build_and_changes_nothing(tmp_path, source):
    if source == "arrays":
        def data():
            return ArrayWEDataset(generate_we_arrays(12, 32, seed=17))
    else:
        path = generate_west_h5(str(tmp_path / "west.h5"), n_iterations=12,
                                n_segments=32, seed=17)

        def data():
            return [path]
    plain = _build(data())
    traced = _build(data(), profile_dir=str(tmp_path / "trace"))
    assert plain.build_profile is None
    path, events = _events(tmp_path / "trace")
    assert traced.build_profile.trace_path == path
    assert len(events) > 10
    assert any(e["name"].startswith("aten::") for e in events)
    np.testing.assert_array_equal(np.concatenate(traced.dtrajs),
                                  np.concatenate(plain.dtrajs))
    np.testing.assert_array_equal(traced.fluxMatrixRaw, plain.fluxMatrixRaw)
    np.testing.assert_array_equal(traced.pSS, plain.pSS)
    assert traced.JtargetSS == plain.JtargetSS
    # The profiler is not part of the model's saved or copied state
    traced.save(str(tmp_path / "m.pkl"))
    assert modelWE.load(str(tmp_path / "m.pkl"), device="cpu").build_profile is None


def test_profile_dir_trace_survives_a_failing_build(tmp_path):
    # A topology path needs mdtraj, which is not installed here
    with pytest.raises(ImportError, match="mdtraj"):
        m = modelWE(device="cpu")
        m.build_analyze_model(
            file_paths=ArrayWEDataset(generate_we_arrays(6, 8, seed=1)),
            ref_struct="topology.pdb", modelName="x",
            basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
            dimreduce_method="pca", tau=1.0, n_clusters=2,
            show_live_display=False, profile_dir=str(tmp_path))
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    with open(files[0]) as fp:
        assert "traceEvents" in json.load(fp)


# ------------------------------------------------------------------- spans

# The sub-spans of a build with block validation and the stage each opens
# in (``model_copy``: the post-clustering copy and one a validation group;
# ``clean`` and ``steady_state``: the model's, then each group's), at the
# top level: every nested span is a ``project`` inside ``featurize``
BUILD_SPANS = [("reduce_moments", "Dimensionality reduction"),
               ("featurize", "Clustering"), ("cluster_fold", "Clustering"),
               ("discretize", "Clustering"), ("model_copy", "Clustering"),
               ("clean", "Cleaning"), ("steady_state", "Steady-state distribution"),
               ("model_copy", "Cross-validation"), ("model_copy", "Cross-validation"),
               ("clean", "Cross-validation"), ("steady_state", "Cross-validation"),
               ("clean", "Cross-validation"), ("steady_state", "Cross-validation")]
NO_VALIDATION_SPANS = [s for s in BUILD_SPANS[:7] if s[0] != "model_copy"]


def _top_level(spans):
    """The names of the top-level ``spans`` (a ``StageTimer``'s), after
    checking that each nested one is a ``project`` inside ``featurize``."""
    nested = [(n, spans[p][0]) for n, _s, p, _st in spans if p != -1]
    assert nested and set(nested) == {("project", "featurize")}, nested
    return [(n, st) for n, _s, p, st in spans if p == -1]


def _arrays():
    return ArrayWEDataset(generate_we_arrays(12, 32, seed=17))


def _ranges(events, name):
    # The port's ranges are the trace's ``cpu_op`` events of their name
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == name and e.get("cat") == "cpu_op")


def test_sub_spans_nest_under_their_stage():
    timer = StageTimer()
    with span("before"):  # no stage runs: recorded nowhere
        pass
    with timer.stage("A"):
        with span("x"):
            with span("y"):
                pass
        with span("z"):
            pass
    with timer.stage("B", note="n"):
        pass
    assert [n for n, _s, _note in timer.stages] == ["A", "B"]
    assert [(n, parent, stage) for n, _s, parent, stage in timer.spans] == [
        ("x", -1, 0), ("y", 0, 0), ("z", -1, 0)]
    (_a, a, _), (_b, b, _) = timer.stages
    x, y, z = (sec for _n, sec, _p, _st in timer.spans)
    assert 0 <= y <= x and x + z <= a
    assert timer.total == a + b
    assert timer.self_seconds() == [("A", a - x - z), ("B", b)]
    d = timer.as_dict()
    assert [s["name"] for s in d["stages"]] == ["A", "B"]
    assert d["total_seconds"] == round(a + b, 4)
    assert [(s["name"], s["parent"]) for s in d["spans"]] == [
        ("x", "A"), ("y", "x"), ("z", "A")]
    report = timer.report()
    assert "A" in report and "x" not in report.split()


@pytest.mark.parametrize("groups,spans", [(0, NO_VALIDATION_SPANS), (2, BUILD_SPANS)],
                         ids=["no_validation", "validation"])
def test_a_build_times_its_sub_stages(groups, spans):
    m = _build(_arrays(), groups=groups)
    t = m.stage_timings
    stages = [n for n, _s, _note in t.stages]
    assert [(n, stages[st]) for n, st in _top_level(t.spans)] == spans
    clustering = dict(t.self_seconds())["Clustering"]
    assert 0 <= clustering < dict((n, s) for n, s, _ in t.stages)["Clustering"]


def test_a_profiled_build_shows_its_stages_and_spans_as_ranges(tmp_path):
    """Every stage and sub-span is a range of the same name in the trace,
    inside its parent's range, lasting what the timer says (10% or 2 ms)."""
    m = _build(_arrays(), groups=2, profile_dir=str(tmp_path))
    _path, events = _events(tmp_path)
    t = m.stage_timings
    stage_ranges = [_ranges(events, n) for n, _s, _note in t.stages]
    assert all(len(r) == 1 for r in stage_ranges)
    seen, span_ranges = {}, []
    for name, *_ in t.spans:
        span_ranges.append(_ranges(events, name)[seen.get(name, 0)])
        seen[name] = seen.get(name, 0) + 1
    assert {n: len(_ranges(events, n)) for n in seen} == seen
    timed = [(r[0], s) for r, (_n, s, _note) in zip(stage_ranges, t.stages)] + [
        (r, s) for r, (_n, s, _p, _st) in zip(span_ranges, t.spans)]
    for (a, b), seconds in timed:
        assert abs((b - a) / 1e6 - seconds) <= max(0.1 * seconds, 2e-3)
    for (a, b), (_n, _s, parent, stage) in zip(span_ranges, t.spans):
        pa, pb = span_ranges[parent] if parent >= 0 else stage_ranges[stage][0]
        assert pa <= a and b <= pb + 1.0  # the trace rounds to 1 ns


def test_spans_enter_no_range_where_nothing_records(monkeypatch):
    def no_range(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    assert not tracing.active()
    with span("alone"):
        pass
    with collect() as col:
        assert tracing.active()
        with span("collected"):
            pass
    m = _build(_arrays(), groups=2)
    assert not tracing.active()
    assert list(col.spans) == ["collected"] and len(col.spans["collected"]) == 1
    assert [n for n, _st in _top_level(m.stage_timings.spans)] == [
        n for n, _st in BUILD_SPANS]


def test_collect_changes_no_build_output():
    plain = _build(_arrays(), groups=2)
    with collect() as col:
        traced = _build(_arrays(), groups=2)
    assert tracing.collector() is None
    assert {n: len(v) for n, v in col.spans.items()} == {
        "reduce_moments": 1, "featurize": 1, "cluster_fold": 1, "discretize": 1,
        "model_copy": 3, "clean": 3, "steady_state": 3,
        # The child rows, the pre-flight's two calls, the recycled parents, the sample
        "project": 5}
    np.testing.assert_array_equal(np.concatenate(traced.dtrajs),
                                  np.concatenate(plain.dtrajs))
    np.testing.assert_array_equal(traced.fluxMatrixRaw, plain.fluxMatrixRaw)
    np.testing.assert_array_equal(traced.pSS, plain.pSS)
    assert traced.JtargetSS == plain.JtargetSS
    for v, w in zip(traced.validation_models, plain.validation_models):
        np.testing.assert_array_equal(v.pSS, w.pSS)


def test_collect_blocks_nest_and_restore():
    with collect() as outer:
        with collect() as inner:
            with span("s"):
                pass
        assert tracing.collector() is outer
        with span("t"):
            pass
    assert tracing.collector() is None
    assert list(inner.spans) == ["s"] and list(outer.spans) == ["t"]


class _FakeEntry:
    """A captured step without a card: counts its launches; a traced one
    reports one device interval a launch and a counter of two a launch."""

    def __init__(self, traced):
        self.traced = traced
        self.runs = 0
        self.calls = []

    def launch(self):
        self.runs += 1

    def copy_out(self):
        return self.runs

    def open(self, col):
        self.calls.append("open")

    def read(self, col):
        self.calls.append("read")
        col.device_ms.setdefault("tail", []).append(float(self.runs))

    def close(self, col):
        self.calls.append("close")
        col.counts["tail_rounds"] = 2 * self.runs


class _FakeCapture:
    def __init__(self):
        self.entries = []

    def __call__(self, fn, args, device, traced=False):
        assert fn is _step
        self.entries.append(_FakeEntry(traced))
        return self.entries[-1]


def _step(a, b):
    return a + b


def test_graph_runs_record_spans_and_a_traced_entry_under_collect(monkeypatch):
    fake = _FakeCapture()
    cache = _graph.GraphCache(capture=fake, device_type="cpu")
    a = torch.zeros(2)
    with monkeypatch.context() as mp:
        def no_span(name):
            raise AssertionError(f"span {name} opened with tracing off")

        mp.setattr(_graph.tracing, "span", no_span)
        assert cache.run(_step, a, a) == 1
    with collect() as col:
        runs = [cache.run(_step, a, a) for _ in range(3)]
    assert cache.run(_step, a, a) == 2  # the plain entry again
    plain, traced = fake.entries
    assert (plain.traced, traced.traced, len(cache)) == (False, True, 2)
    assert runs == [1, 2, 3] and plain.calls == []
    assert {n: len(v) for n, v in col.spans.items()} == {
        "graph.lookup": 3, "graph.launch": 3, "graph.copy_out": 3}
    # Each launch's interval is read before the next, the last at the end
    assert traced.calls == ["open", "read", "read", "read", "close"]
    assert col.device_ms == {"tail": [1.0, 2.0, 3.0]}
    assert col.counts == {"tail_rounds": 6}
    assert _graph.graph_key(_step, [a, a]) in cache
    assert _graph.graph_key(_step, [a, a], traced=True) in cache


def test_the_cpu_route_under_collect_spans_its_check_alone(monkeypatch):
    def never(*_a, **_k):
        raise AssertionError("a graph was captured for CPU tensors")

    monkeypatch.setattr(_graph._CACHE, "_capture", never)
    a = torch.arange(3.0)
    before = len(_graph._CACHE)
    with collect() as col:
        out = _graph.run(_step, a, a)
    assert torch.equal(out, 2 * a) and len(_graph._CACHE) == before
    assert {n: len(v) for n, v in col.spans.items()} == {"graph.lookup": 1}
    assert col.device_ms == {} and col.counts == {}


# ------------------------------------------------------------------ counts

def test_count_adds_to_the_innermost_collect_block():
    tracing.count("lost", 5)  # no block open: recorded nowhere
    with collect() as outer:
        tracing.count("n", 2)
        with collect() as inner:
            tracing.count("n", 3)
            tracing.count("m")
        tracing.count("n", 4)
    tracing.count("lost", 1)
    assert outer.counts == {"n": 6} and inner.counts == {"n": 3, "m": 1}


def _batch(rng, sizes):
    """Rows of 2 features around each bin's own offset, ``sizes[b]`` of bin
    ``b``, and their bins."""
    bins = np.repeat(np.arange(len(sizes)), sizes)
    return (bins[:, None] * 10.0 + rng.normal(size=(len(bins), 2))).astype(
        np.float32), bins


# Batches of per-bin row counts, with the bin batches each family runs:
# a bin seeds once it has k rows in one batch (the host family under
# HOST_BATCH_THRESHOLD rows, else the device family); a bin seeded before
# the batch is updated (the family by the batch's live rows); a bin short
# of k rows and not seeded is not worked
FOLDS = {
    "host_family": ([[5, 2, 4, 0], [3, 3, 0, 1], [2, 2, 2, 2]], (2 + 2 + 3, 0)),
    "device_family": ([[4096, 5, 0], [4000, 200, 0], [5, 0, 10]], (1 + 0 + 2, 1 + 2 + 0)),
}


@pytest.mark.parametrize("batches,expect", FOLDS.values(), ids=FOLDS.keys())
def test_fold_counts_add_up_to_the_bin_batches(batches, expect):
    from msm_we_tpu_torch.ops.stratified import StratifiedKmeans

    rng = np.random.default_rng(3)
    strat = StratifiedKmeans(len(batches[0]), 3, 2, seed=1, device="cpu")
    with collect() as col:
        for sizes in batches:
            strat.partial_fit(*_batch(rng, sizes))
    host, device = expect
    assert (col.counts["fold_host_bins"], col.counts["fold_device_bins"]) == (host, device)
    worked = sum(sum(1 for n, ready in zip(sizes, seen) if n and (ready or n >= 3))
                 for sizes, seen in zip(batches, _seeded_before(batches, 3)))
    assert host + device == worked
    assert strat.seeded_by_family["device"] <= device


def _seeded_before(batches, k):
    """For each batch, which bins were seeded before it."""
    seen, out = [False] * len(batches[0]), []
    for sizes in batches:
        out.append(list(seen))
        seen = [s or n >= k for s, n in zip(seen, sizes)]
    return out


@pytest.mark.parametrize("groups", [0, 1, 2])
def test_clean_and_steady_state_span_the_model_and_each_group(groups):
    with collect() as col:
        m = _build(_arrays(), groups=groups)
    t = m.stage_timings
    stages = [n for n, _s, _note in t.stages]
    seconds = dict((n, s) for n, s, _note in t.stages)
    for name, own in (("clean", "Cleaning"), ("steady_state", "Steady-state distribution")):
        where = [stages[st] for n, _s, _p, st in t.spans if n == name]
        assert where == [own] + ["Cross-validation"] * groups
        assert len(col.spans[name]) == 1 + groups
        first = next(s for n, s, _p, _st in t.spans if n == name)
        assert 0 <= first <= seconds[own]
    assert len(m.validation_models or []) == groups


def test_a_build_counts_its_fold_under_collect():
    plain = _build(_arrays(), groups=2)
    with collect() as col:
        m = _build(_arrays(), groups=2)
    strat = m._strat
    assert col.counts["fold_host_bins"] >= strat.seeded_by_family["host"]
    assert col.counts["fold_device_bins"] >= strat.seeded_by_family["device"]
    assert col.counts["fold_gathered_iterations"] >= 0
    assert col.counts["fold_remapped_bins"] >= 0
    np.testing.assert_array_equal(m.pSS, plain.pSS)


# Per-iteration rows of each of 4 WE bins at k = 3, with the iterations the
# fill batches hold after their first and the bins remapped when the data
# ran out: each iteration filling the bins it reaches, then bins that need
# two iterations to fill and a last batch that runs out with two unfilled
PLANS = {
    "each_iteration_fills": ([[3, 4, 0, 0], [5, 3, 3, 0], [0, 3, 0, 6]], (0, 0)),
    "gathered_and_ran_out": (
        [[2, 1, 0, 0], [1, 2, 0, 0], [3, 0, 0, 3], [0, 1, 0, 0], [0, 1, 1, 3]], (2, 2)),
}


@pytest.mark.parametrize("sizes,expect", PLANS.values(), ids=PLANS.keys())
def test_the_batch_plan_counts_gathered_iterations_and_remapped_bins(sizes, expect):
    from msm_we_tpu_torch.discretization import build_batch_plan

    bins = np.concatenate([np.repeat(np.arange(4), n) for n in sizes])
    offsets = np.concatenate([[0], np.cumsum([sum(n) for n in sizes])])
    mapper = RectilinearBinMapper([np.linspace(0, 4, 5)])
    with collect() as col:
        batches, delegated = build_batch_plan(
            mapper, list(range(1, len(sizes) + 1)), 3, np.arange(len(bins)), bins, offsets)
    assert (col.counts["fold_gathered_iterations"], col.counts["fold_remapped_bins"]) == expect
    assert col.counts["fold_gathered_iterations"] == len(sizes) - len(batches)
    assert sum(delegated) == (expect[1] > 0)
