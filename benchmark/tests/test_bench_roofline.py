"""``step.roofline_pct``'s count of bytes and operations, against values
worked out by hand for the two hot-step cells."""
import importlib.util
import os

import pytest

import bench_helpers

H100 = "NVIDIA H100 80GB HBM3"


def _metric(name):
    path = os.path.join(bench_helpers.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sizes(n_centers):
    # 102,400 segments, both raw rows of each projected (two_transform),
    # 900 -> 30 features, 25 centers a bin scored for every row
    return dict(raw_rows=204_800, n_segments=102_400, n_raw=900, n_components=30,
                n_centers=n_centers, n_states=n_centers + 2,
                scored_pairs=25 * 204_800)


# bins10: reads 737,280,000 (raw) + 3,600 (mean) + 108,000 (components)
# + 250 x 125 (centers, bins, valid) + 102,400 x 15 (bins, masks, weights)
# + 252^2 x 4 (the tail reads the flux matrix) = 739,212,866; writes
# 102,400 x 8 (ids) + 254,016 (flux matrix) + 1,008 (distribution).
# bins128: 3,200 centers, 3,202 states. Operations: 2 x 204,800 x 900 x 30
# (projection) + 2 x 30 x 5,120,000 (scores).
@pytest.mark.parametrize("n_centers,nbytes", [(250, 740_287_090), (3_200, 822_182_040)])
def test_roofline_counts(n_centers, nbytes):
    m = _metric("step.roofline_pct")
    assert m.work(_sizes(n_centers)) == (nbytes, 11_366_400_000)


def test_roofline_share_and_silence():
    m = _metric("step.roofline_pct")
    peaks = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "peaks.json"))
    rec = dict(roofline=_sizes(250), device_step_ms=1.0, peaks=peaks, device_kind=H100)
    # bytes bind: 740,287,090 / 3.35e12 s over 1 ms of device time a step
    assert m.read(rec) == pytest.approx(100 * 740_287_090 / 3.35e12 / 1e-3)
    assert m.read(dict(rec, device_kind="cpu")) is None
    assert m.read(dict(rec, device_step_ms=None)) is None


def test_step_metrics_read_the_record():
    rec = dict(enqueue_s=[2e-4, 4e-4], device_step_ms=0.5, steps=2, window_s=0.002)
    assert _metric("step.enqueue_ms").read(rec) == pytest.approx(0.3)
    assert _metric("step.device_idle_pct").read(rec) == pytest.approx(50.0)
    assert _metric("step.enqueue_ms").read({}) is None
    assert _metric("step.device_idle_pct").read({}) is None
    assert _metric("step.device_idle_pct").read(dict(rec, device_step_ms=None)) is None


def test_build_metrics_read_the_record():
    build = [("Model initialization", 0.1), ("Loading iterations", 0.2),
             ("Loading coordinates", 0.3), ("Dimensionality reduction", 0.4),
             ("Clustering", 0.5), ("Flux matrix", 0.6), ("Cleaning", 0.7),
             ("Transition matrix", 0.8), ("Cross-validation", 0.9)]
    rec = dict(build_stages=[build, build], busy_s=0.5, traced_wall_s=2.0)
    want = {"build.ingest_s": 0.6, "build.reduction_s": 0.4, "build.clustering_s": 0.5,
            "build.flux_cleaning_s": 1.3, "build.validation_s": 0.9,
            "build.device_idle_pct": 75.0}
    for name, value in want.items():
        assert _metric(name).read(rec) == pytest.approx(value), name
        assert _metric(name).read({}) is None, name
