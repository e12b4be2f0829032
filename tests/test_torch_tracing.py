"""``profile_trace`` and ``build_analyze_model(profile_dir=...)`` of the
port on the CPU: one Chrome trace file that parses and holds events, the
build's results bitwise unchanged, the trace written also when the block
raises, and ``profile_trace(None)`` a no-op.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.data import generate_we_arrays, generate_west_h5
from msm_we_tpu_torch.tracing import profile_trace

torch.set_num_threads(1)


def _build(source, **kw):
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=source,
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="traced", basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
        n_clusters=3, cross_validation_groups=0, show_live_display=False,
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
    with pytest.raises(NotImplementedError, match="mdtraj"):
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
