"""The harness keeps to the benchmark's contract: ``BENCHMARK.json``'s
shape, names and units; every cell, configuration and metric found by name
from files; a cell, a configuration or a per-layer metric added as files
alone; no result without a card, or without the program."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import bench_helpers

SPEC_PATH = os.path.join(bench_helpers.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return bench_helpers.load_json(SPEC_PATH)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(SPEC_PATH) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    files = [w for w in spec["command"] if os.path.exists(os.path.join(
        bench_helpers.ROOT, w)) and os.sep in w]
    assert files and all(any(f.startswith(p + "/") for p in spec["paths"]) for f in files)


def test_run_seconds_fits_a_full_check(spec):
    s = spec["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(spec):
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in spec["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in spec["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_just_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}


def test_every_cell_reports_enough(spec):
    run = bench_helpers.harness(bench_helpers.BENCH)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        ends = {m["name"] for m in run.cell_metrics(spec, w["name"], "end_to_end")}
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        layer = run.cell_metrics(spec, w["name"], "per_layer")
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in ends, (w["name"], m["name"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


def test_every_name_has_its_files(spec):
    bench = bench_helpers.BENCH
    used = set()
    for w in spec["workloads"]:
        wl = bench_helpers.load_json(os.path.join(bench, "workloads", w["name"] + ".json"))
        assert wl["config"] == w["config"]
        assert wl["why"] == w["why"]
        assert os.path.isfile(os.path.join(bench, "drivers", wl["driver"] + ".py"))
        assert set(wl["checks"]) and all(v >= 0 for v in wl["checks"].values())
        used.add(w["config"])
    for c in spec["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        cfg = bench_helpers.load_json(os.path.join(bench_helpers.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for m in spec["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics", m["name"] + ".py"))


def test_files_alone_add_a_config_a_cell_and_a_metric(tmp_path):
    """A configuration, a cell and a per-layer metric added as data files and
    one reader, with no edit to the harness's code, are found and run."""
    bench = bench_helpers.small_copy(str(tmp_path))
    cfg = bench_helpers.load_json(os.path.join(bench, "configs", "ntl9_100k.json"))
    cfg.update(name="ntl9_tiny", n_segments=1024, n_raw_features=24, n_components=4)
    bench_helpers.dump_json(cfg, os.path.join(bench, "configs", "ntl9_tiny.json"))
    wl = bench_helpers.load_json(os.path.join(bench, "workloads", "ntl9_100k.bins10.json"))
    wl.update(config="ntl9_tiny", why="a tiny hot step over 4 bins")
    wl["traffic"]["n_bins"] = 4
    bench_helpers.dump_json(wl, os.path.join(bench, "workloads", "ntl9_tiny.bins4.json"))
    with open(os.path.join(bench, "metrics", "step.mean_ms.py"), "w") as fh:
        fh.write('"""The mean synchronised step."""\n\n\ndef read(rec):\n'
                 '    s = rec.get("step_s")\n'
                 '    return 1e3 * sum(s) / len(s) if s else None\n')
    spec_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    spec = bench_helpers.load_json(spec_path)
    spec["configs"].append(dict(name="ntl9_tiny", source="https://example.org/tiny",
                                file="benchmark/configs/ntl9_tiny.json", reduced=[],
                                why="a tiny configuration"))
    spec["workloads"].append(dict(name="ntl9_tiny.bins4", config="ntl9_tiny",
                                  traffic="bins4", chips=1, why=wl["why"]))
    for m in spec["end_to_end"]:
        if m["name"].startswith("hot_step"):
            m["workloads"].append("ntl9_tiny.bins4")
    spec["per_layer"].append(dict(name="step.mean_ms", unit="ms", better="lower",
                                  source="host_clock", layer="hot step",
                                  moves="hot_step_frames_per_s",
                                  workloads=["ntl9_tiny.bins4"]))
    bench_helpers.dump_json(spec, spec_path)
    run = bench_helpers.harness(bench)
    res, _c, _r = run.run("ntl9_tiny.bins4", 11, 0.2, 0, device="cpu", bench_dir=bench)
    assert set(res["metrics"]) == {"setup_s", "hot_step_frames_per_s", "hot_step_p95_ms"}
    assert res["correct"] and res["attempted"] > 0
    res, _c, _r = run.run("ntl9_tiny.bins4", 12, 0.2, 1, device="cpu", bench_dir=bench)
    assert set(res["metrics"]) == {"step.mean_ms"}  # device metrics: silent off the card
    assert res["metrics"]["step.mean_ms"]["value"] > 0


def _cli(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ntl9_100k.bins10",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _cli(bench_helpers.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copytree(bench_helpers.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(SPEC_PATH, tmp_path)
    out = _cli(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    # Off the card too: the harness finds no program in the checkout
    bench = str(tmp_path / "benchmark")
    run = bench_helpers.harness(bench)
    with pytest.raises(run.RunError, match="not in this checkout"):
        run.run("ntl9_100k.bins10", 1, 0.1, 0, device="cpu", bench_dir=bench)


def test_a_cpu_run_prints_checks_last(tmp_path):
    bench = bench_helpers.small_copy(str(tmp_path))
    res, compared, _r = bench_helpers.run_cpu(bench, "ntl9_100k.bins10")
    assert list(res)[-1] == "checks"
    assert [c["name"] for c in compared] == list(res["checks"])
    json.dumps(res, allow_nan=False)
