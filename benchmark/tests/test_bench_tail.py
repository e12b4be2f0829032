"""The tail cell ``ntl9_100k.bins128``: its three readers (``step.tail_*``)
on hand-made records, the tail roofline's count at 3,202 states worked by
hand, its driver (``drivers/hot_step_tail.py``) reading every key of the
cell's traffic, and one run of the cell on the CPU at test size (642
states: above ``S_MAX``, so the program's float64 tail route)."""
import importlib.util
import math
import os

import pytest

import bench_helpers

H100 = "NVIDIA H100 80GB HBM3"
CELL = "ntl9_100k.bins128"
CONFIG = "ntl9_100k_bins128"


def _module(*parts):
    path = os.path.join(bench_helpers.BENCH, *parts)
    name = "bench_tail_" + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(name):
    return _module("metrics", name + ".py")


def _peaks():
    return bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "peaks.json"))


def _small_copy(tmp_path):
    """``bench_helpers.small_copy`` with the cell's configuration cut to the
    sizes the copy gives ``ntl9_100k``: the same widths, fewer of them."""
    bench = bench_helpers.small_copy(str(tmp_path))
    path = os.path.join(bench, "configs", CONFIG + ".json")
    bench_helpers.dump_json(dict(bench_helpers.load_json(path),
                                 **bench_helpers.SMALL_CONFIGS["ntl9_100k"]), path)
    return bench


def _record(**tail):
    t = dict(replays=50, device_ms=10.0, rounds=0.0, f64_share=1.0,
             n_states=3202, fixed_squarings=9)
    t.update(tail)
    return dict(tail=t, peaks=_peaks(), device_kind=H100)


# 3,202 states, 9 squarings: 2 x 3,202^3 = 65,658,956,816 operations a
# squaring, 590,930,611,344 in all; each squaring reads and writes 3,202^2
# = 10,252,804 float64 numbers, 9 x 2 x 10,252,804 x 8 = 1,476,403,776
# bytes. At 67 TFLOP/s the operations take 8.8199 ms, at 3.35 TB/s the
# bytes 0.4407 ms: the operations bind.
def test_tail_roofline_counts():
    m = _metric("step.tail_roofline_pct")
    assert m.work(3202, 9) == (1_476_403_776, 590_930_611_344)
    assert m.work(3202, 9 + 2) == (1_804_493_504, 722_248_524_976)


def test_tail_roofline_share():
    m = _metric("step.tail_roofline_pct")
    assert m.read(_record()) == pytest.approx(100 * 590_930_611_344 / 67e12 / 10e-3)
    # Rounds per replay add squarings; a mean may be fractional
    assert m.read(_record(rounds=0.5)) == pytest.approx(
        100 * 9.5 * 2 * 3202 ** 3 / 67e12 / 10e-3)
    # At 4 states the bytes bind: 9 x 2 x 16 x 8 bytes over 3.35 TB/s
    assert m.read(_record(n_states=4, device_ms=1e-6)) == pytest.approx(
        100 * (9 * 2 * 16 * 8 / 3.35e12) / 1e-9)


@pytest.mark.parametrize("rec", [
    {},
    dict(tail={}),
    _record(device_ms=None),
    _record(rounds=None),
    dict(_record(), device_kind="cpu"),
    dict(_record(), peaks={}),
], ids=["no_tail", "empty_tail", "no_device_ms", "no_rounds", "other_card",
        "no_peaks"])
def test_tail_roofline_is_silent_without_its_numbers(rec):
    assert _metric("step.tail_roofline_pct").read(rec) is None


def test_tail_device_ms_and_rounds_read_the_record():
    rec = _record(device_ms=12.5, rounds=0.25)
    assert _metric("step.tail_device_ms").read(rec) == 12.5
    assert _metric("step.tail_rounds").read(rec) == 0.25
    # Zero rounds is a reading, not silence
    assert _metric("step.tail_rounds").read(_record(rounds=0.0)) == 0.0
    # A program without the float64 count (f64_share None) still reads
    assert _metric("step.tail_device_ms").read(_record(f64_share=None)) == 10.0
    for name in ("step.tail_device_ms", "step.tail_rounds"):
        assert _metric(name).read({}) is None
        assert _metric(name).read(dict(tail={})) is None
        assert _metric(name).read(_record(device_ms=None, rounds=None)) is None


def test_fixed_squarings_follow_the_configuration():
    driver = _module("drivers", "hot_step_tail.py")
    cfg = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "configs",
                                               CONFIG + ".json"))
    n_iters = cfg["steady_state"]["n_iters"]
    assert driver.fixed_squarings(n_iters) == math.ceil(math.log2(n_iters)) == 9
    assert driver.fixed_squarings(1) == 1
    assert driver.fixed_squarings(513) == 10


def test_the_configuration_is_ntl9_100k_binned_wide():
    """The cell's configuration holds every size of ``ntl9_100k`` unchanged
    and names its 128 WE bins, which the cell's traffic runs."""
    def cfg(name):
        return bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "configs",
                                                    name + ".json"))

    wide, base = cfg(CONFIG), cfg("ntl9_100k")
    for key in ("n_segments", "n_raw_features", "n_components", "clusters_per_bin",
                "recycled_fraction", "steady_state", "reduced"):
        assert wide[key] == base[key], key
    assert wide["source"] != base["source"]
    wl = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "workloads",
                                              CELL + ".json"))
    assert wl["config"] == CONFIG
    assert wide["we_bins"] == wl["traffic"]["n_bins"] == 128


def test_the_driver_refuses_traffic_of_other_bins():
    import torch

    driver = _module("drivers", "hot_step_tail.py")
    wl = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "workloads",
                                              CELL + ".json"))
    wl["traffic"] = dict(wl["traffic"], n_bins=10)
    cfg = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "configs",
                                               CONFIG + ".json"))
    with pytest.raises(ValueError, match="128 WE bins"):
        driver.Cell(cfg, wl, 2**31 + 5, torch.device("cpu"))


class _Tracked(dict):
    """A dict that remembers which of its keys were read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)


def test_the_driver_reads_every_traffic_key(tmp_path):
    """Every key of the cell's traffic is read by its driver, at test size."""
    import torch

    bench = _small_copy(tmp_path)
    run = bench_helpers.harness(bench)
    wl = run.load_json(os.path.join(bench, "workloads", CELL + ".json"))
    cfg = run.load_json(os.path.join(bench, "configs", wl["config"] + ".json"))
    run._import_program()
    driver = run.load_module(os.path.join(bench, "drivers", wl["driver"] + ".py"),
                             "bench_driver_tail_keys")
    traffic = _Tracked(wl["traffic"], warmup_steps=1, trace_steps=2)
    cell = driver.Cell(cfg, dict(wl, traffic=traffic), 2**31 + 5, torch.device("cpu"))
    assert cell.problem["n_states"] == 128 * cfg["clusters_per_bin"] + 2
    res = cell.window(0.05, trace=True)
    assert traffic.read == set(wl["traffic"])
    # Off the card no traced graph runs: the tail's numbers stay None
    tail = res["record"]["tail"]
    assert tail["replays"] == 0
    assert tail["device_ms"] is tail["rounds"] is tail["f64_share"] is None
    assert tail["n_states"] == cell.problem["n_states"]
    assert tail["fixed_squarings"] == 9


def test_a_cpu_run_of_the_cell_is_correct(tmp_path):
    """The cell at test size on the CPU: 128 bins x 5 centers, 642 states,
    so the program's tail runs in float64; its outputs pass the cell's
    limits, and a traced run reports none of the device metrics."""
    bench = _small_copy(tmp_path)
    path = os.path.join(bench, "workloads", CELL + ".json")
    wl = bench_helpers.load_json(path)
    wl["traffic"].update(warmup_steps=1, trace_steps=2)
    bench_helpers.dump_json(wl, path)
    res, compared, _r = bench_helpers.run_cpu(bench, CELL, seconds=0.2)
    assert res["correct"] and res["attempted"] > 0, compared
    assert set(res["metrics"]) == {"setup_s", "hot_step_frames_per_s",
                                   "hot_step_p95_ms"}
    run = bench_helpers.harness(bench)
    res, _c, _r = run.run(CELL, 2**31 + 9, 0.1, 1, device="cpu", bench_dir=bench)
    assert res["metrics"] == {}
