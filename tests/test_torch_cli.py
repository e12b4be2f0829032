"""The port's command line (``msm_we_tpu_torch.cli``, ``msm-we-tpu-torch``),
its augmentation script and the mdtraj surface of ``modelWE``, on the CPU
(``--device cpu``), against the JAX package's ``msm_we_tpu.cli`` and
``msm_we_tpu.scripts``.

The eight cases of ``tests/test_cli_and_scripts.py`` run through the port.
``build``'s JSON must equal the port's own API sequence with the same flags
bitwise (host float64 after the ids), with the model's route
(``device_pipeline``) following ``--device-pipeline``. ``validate`` runs on a
port model that carries the JAX model's fitted bank
(``convert.fitted_state_from_arrays``), and its JSON must match the JAX
CLI's within 1e-10. mdtraj is absent here and on the card's machine, so it
is stubbed as the JAX tests stub it; the augmentation writes the same
auxdata as the JAX script, and ``.dat`` topologies and basis files load as
the JAX model loads them.
"""
import json
import os
import shutil
import sys
import types

import h5py
import numpy as np
import pytest
import torch

from msm_we_tpu.cli import main as jax_main
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu_torch.cli import main
from msm_we_tpu_torch.model import modelWE

torch.set_num_threads(1)

BUILD = ["--basis", "9", "10", "--target", "0", "1"]


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_cli") / "west.h5")
    generate_west_h5(path, n_iterations=30, n_segments=16, seed=21)
    return path


def _api_build(path, n_clusters, stratified, lag, device_pipeline):
    """The port's API sequence that ``build`` drives, on the CPU."""
    from msm_we_tpu_torch.binning import RectilinearBinMapper

    model = modelWE(device="cpu")
    model.initialize([path], {"coords": None, "nAtoms": 1, "coord_ndim": 3},
                     "cli_model", basis_pcoord_bounds=[[9.0, 10.0]],
                     target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="none",
                     tau=1.0, _suppress_boundary_warning=True)
    model.device_pipeline = device_pipeline
    if device_pipeline:
        model.enable_mesh()
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    kwargs = {}
    if stratified:
        ext = [0.0, 9.0, 10.0, 0.0, 1.0]
        for i in range(1, model.maxIter):
            d = model._dataset.iter_data(i)
            for key in ("pcoord0", "pcoord1"):
                ext += [float(np.nanmin(d[key][:, 0])), float(np.nanmax(d[key][:, 0]))]
        lo, hi = min(ext), max(ext)
        span = hi - lo
        kwargs["user_bin_mapper"] = RectilinearBinMapper(
            [np.linspace(lo - 0.001 * span, hi + 0.001 * span, 11)])
    model.cluster_coordinates(n_clusters=n_clusters, stratified=stratified, **kwargs)
    model.get_fluxMatrix(lag)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    return model


def test_cli_generate_and_info(tmp_path, capsys):
    out = str(tmp_path / "gen.h5")
    assert main(["generate", out, "--iterations", "8", "--segments", "6"]) == 0
    ref = str(tmp_path / "gen_jax.h5")
    assert jax_main(["generate", ref, "--iterations", "8", "--segments", "6"]) == 0
    with h5py.File(out) as h5, h5py.File(ref) as h5_ref:
        assert "iterations/iter_00000001/seg_index" in h5
        assert sorted(h5["iterations"]) == sorted(h5_ref["iterations"])
        np.testing.assert_array_equal(h5["iterations/iter_00000003/pcoord"][:],
                                      h5_ref["iterations/iter_00000003/pcoord"][:])
    capsys.readouterr()
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert f"cuda available: {torch.cuda.is_available()}" in out


@pytest.mark.parametrize("stratified, device_pipeline", [
    (False, False), (True, False), (True, True)],
    ids=["aggregated", "stratified_host_route", "stratified_device_pipeline"])
def test_cli_build_equals_the_api_sequence(west_h5, tmp_path, stratified, device_pipeline):
    """``build``'s JSON equals the API sequence of the same flags bitwise,
    and the saved model's route follows ``--device-pipeline``. Stratified
    builds (host-family seeding at this size) also equal the JAX CLI's to
    1e-12; aggregated k-means draws its own k-means++ rows (by design)."""
    out_json, model_path = str(tmp_path / "results.json"), str(tmp_path / "m.obj")
    flags = ["--n-clusters", "2", "--stratified", "--lag", "1"] if stratified else \
        ["--n-clusters", "6"]
    flags += ["--device-pipeline"] if device_pipeline else []
    assert main(["build", west_h5, *BUILD, *flags, "--device", "cpu", "--output", out_json,
                 "--save-model", model_path]) == 0
    results = json.load(open(out_json))
    api = _api_build(west_h5, 2 if stratified else 6, stratified,
                     1 if stratified else 0, device_pipeline)
    assert results == {
        "n_clusters": int(api.n_clusters), "n_lag": int(api.n_lag),
        "lagtime": float(api.lagtime), "JtargetSS": float(api.JtargetSS),
        "pSS": [float(x) for x in api.pSS],
    }
    assert results["JtargetSS"] > 0 and np.isclose(sum(results["pSS"]), 1.0)
    restored = modelWE.load(model_path, h5_paths=[west_h5], device="cpu")
    assert restored.device_pipeline is device_pipeline
    assert restored.JtargetSS == results["JtargetSS"]
    if stratified:
        assert results["n_lag"] == 1 and results["lagtime"] == pytest.approx(2.0)
        ref = str(tmp_path / "jax.json")
        assert jax_main(["build", west_h5, *BUILD, *flags, "--output", ref]) == 0
        _assert_json_close(results, json.load(open(ref)), rtol=1e-12)


def test_cli_build_needs_h5py_and_scan_needs_stratified(west_h5, monkeypatch, capsys):
    """Without h5py a build from a path raises the ``ImportError`` naming
    it (the card's machine has no h5py); ``--scan-small-batches`` needs
    ``--stratified`` as in the JAX CLI."""
    with pytest.raises(SystemExit):
        main(["build", west_h5, *BUILD, "--scan-small-batches", "--device", "cpu"])
    assert "--scan-small-batches requires --stratified" in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        main(["build", west_h5, *BUILD, "--device", "cpu"])


def test_cli_no_command_prints_help(capsys):
    assert main([]) == 1
    assert "msm-we-tpu-torch" in capsys.readouterr().out


class _FakeTraj:
    def __init__(self, xyz):
        self.xyz = xyz
        self._xyz = xyz
        self.topology = types.SimpleNamespace(n_atoms=xyz.shape[1])
        self.n_atoms = xyz.shape[1]


def _install_fake_mdtraj(monkeypatch, coords_of):
    """Stub mdtraj as ``tests/test_cli_and_scripts.py`` does:
    ``load(path)`` returns a one-frame trajectory whose coordinates come
    from ``coords_of(path)``."""
    fake = types.ModuleType("mdtraj")

    def load(path, top=None):
        if not os.path.exists(path):
            raise OSError(f"No such file: {path}")
        return _FakeTraj(np.asarray(coords_of(path))[None])

    fake.load = load
    fake.load_prmtop = lambda path: types.SimpleNamespace(n_atoms=7, path=path)
    monkeypatch.setitem(sys.modules, "mdtraj", fake)


def _segment_coords(n_atoms):
    """Coordinates from the path's iteration/segment/file part, so two
    copies of one layout in different directories get the same values."""
    def coords_of(path):
        key = "/".join(str(path).split(os.sep)[-3:])
        seed = int.from_bytes(key.encode(), "little") % (2**31)
        return np.random.default_rng(seed).normal(size=(n_atoms, 3))
    return coords_of


def _unaugmented_copies(tmp_path, n_iterations, n_segments, seed, segments):
    """One west.h5 without auxdata, copied into a ``jax`` and a ``port``
    directory, each with the segment files of ``segments(n_segs)``."""
    src = str(tmp_path / "src.h5")
    generate_west_h5(src, n_iterations=n_iterations, n_segments=n_segments, seed=seed)
    with h5py.File(src, "a") as h5:
        for k in list(h5["iterations"].keys()):
            if "auxdata" in h5[f"iterations/{k}"]:
                del h5[f"iterations/{k}/auxdata"]
    paths = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        paths.append(str(d / "west.h5"))
        shutil.copyfile(src, paths[-1])
        with h5py.File(src) as h5:
            for k in h5["iterations"]:
                it = int(k.split("_")[1])
                for s in segments(h5[f"iterations/{k}/seg_index"].shape[0]):
                    seg = d / "traj_segs" / f"{it:06d}" / f"{s:06d}"
                    seg.mkdir(parents=True, exist_ok=True)
                    (seg / "parent.rst7").write_text("stub")
                    (seg / "seg.rst7").write_text("stub")
        (d / "top.pdb").write_text("stub")
    return paths


def _auxdata(path):
    with h5py.File(path) as h5:
        return {k: h5[f"iterations/{k}/auxdata/coord"][:] for k in h5["iterations"]
                if "auxdata/coord" in h5[f"iterations/{k}"]}


def _assert_same_auxdata(a, b):
    da, db = _auxdata(a), _auxdata(b)
    assert da.keys() == db.keys() and da
    for k in da:
        np.testing.assert_array_equal(da[k], db[k])


def test_augment_west_h5_writes_coord_pairs(tmp_path, monkeypatch):
    from msm_we_tpu.scripts import augment_west_h5 as jax_augment
    from msm_we_tpu_torch.scripts import augment_west_h5

    n_atoms = 3
    jpath, path = _unaugmented_copies(tmp_path, 6, 4, 2, range)
    _install_fake_mdtraj(monkeypatch, _segment_coords(n_atoms))
    top = os.path.join(os.path.dirname(path), "top.pdb")
    n = augment_west_h5(path, top)
    assert n == jax_augment(jpath, os.path.join(os.path.dirname(jpath), "top.pdb")) >= 4
    _assert_same_auxdata(path, jpath)
    with h5py.File(path) as h5:
        grp = h5["iterations/iter_00000002"]
        assert grp["auxdata/coord"].shape == (grp["seg_index"].shape[0], 2, n_atoms, 3)
        assert np.isfinite(grp["auxdata/coord"][:]).all()
    # Idempotent without overwrite; re-runs with overwrite
    assert augment_west_h5(path, top) == 0
    assert augment_west_h5(path, top, overwrite=True) == n
    _assert_same_auxdata(path, jpath)


def test_augment_missing_segment_files_get_nan(tmp_path, monkeypatch):
    from msm_we_tpu.scripts import augment_west_h5 as jax_augment
    from msm_we_tpu_torch.scripts import augment_west_h5

    jpath, path = _unaugmented_copies(tmp_path, 4, 3, 3, lambda n: [0])
    _install_fake_mdtraj(monkeypatch, lambda p: np.zeros((2, 3)) + 1.0)
    for p, fn in ((path, augment_west_h5), (jpath, jax_augment)):
        fn(p, os.path.join(os.path.dirname(p), "top.pdb"))
    _assert_same_auxdata(path, jpath)
    dset = _auxdata(path)["iter_00000001"]
    assert np.isfinite(dset[0]).all()
    assert np.isnan(dset[1]).all()  # missing files -> NaN (weight 0 downstream)


def test_collect_iter_coordinates_matches_jax(tmp_path, monkeypatch):
    """``modelWE.collect_iter_coordinates`` over the augmentation script,
    with the topology from the model's ``refPDBfile``: the same total and
    the same auxdata as the JAX model's; a model with a dict topology needs
    ``topology_path``."""
    jpath, path = _unaugmented_copies(tmp_path, 5, 3, 4, range)
    _install_fake_mdtraj(monkeypatch, _segment_coords(2))
    totals = []
    for p, cls, kw in ((path, modelWE, {"device": "cpu"}), (jpath, JaxModelWE, {})):
        model = cls(**kw)
        model.initialize([p], os.path.join(os.path.dirname(p), "top.pdb"), "collect",
                         basis_pcoord_bounds=[[9.0, 10.0]],
                         target_pcoord_bounds=[[0.0, 1.0]],
                         _suppress_boundary_warning=True)
        totals.append(model.collect_iter_coordinates())
    assert totals[0] == totals[1] >= 3
    _assert_same_auxdata(path, jpath)
    m = modelWE(device="cpu")
    m.initialize([path], {"coords": None, "nAtoms": 2, "coord_ndim": 3}, "collect",
                 _suppress_boundary_warning=True)
    with pytest.raises(ValueError, match="topology_path"):
        m.collect_iter_coordinates()
    assert m.collect_iter_coordinates(
        topology_path=os.path.join(os.path.dirname(path), "top.pdb"), overwrite=True) == totals[0]


def _carried_model(jax_model_path, west_h5):
    """A port model (CPU) with the JAX CLI model's fitted bank and bin
    grid, solved by the port's own stages."""
    from msm_we_tpu_torch.convert import fitted_state_from_arrays

    j = JaxModelWE.load(jax_model_path, h5_paths=[west_h5])
    strat = j._strat
    strat._sync_host()
    m = modelWE(device="cpu")
    m.initialize([west_h5], {"coords": None, "nAtoms": 1, "coord_ndim": 3},
                 "cli_model", basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="none",
                 tau=1.0, _suppress_boundary_warning=True)
    m.device_pipeline = False
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    fitted_state_from_arrays(
        m, centers=strat.centers, counts=strat.counts, center_bin=strat.center_bin,
        valid=strat.valid, initialized=strat.initialized, we_remap=strat.we_remap,
        bin_edges=j._bin_mapper.boundaries)
    m.get_fluxMatrix(0)
    m.organize_fluxMatrix()
    m.get_Tmatrix()
    m.get_steady_state()
    m.get_steady_state_target_flux()
    np.testing.assert_allclose(m.JtargetSS, j.JtargetSS, rtol=1e-12)
    return m


def _assert_json_close(got, want, rtol=1e-10):
    assert got.keys() == want.keys()
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, str):
            assert a == b, key
            continue
        a = np.array(a, dtype=float)
        b = np.array(b, dtype=float)
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.nanmax(np.abs(b)),
                                   equal_nan=True, err_msg=key)


@pytest.fixture(scope="module")
def validate_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_validate")
    h5 = str(d / "west.h5")
    generate_west_h5(h5, n_iterations=25, n_segments=24, seed=3)
    jax_path, port_path = str(d / "jax.obj"), str(d / "port.obj")
    assert jax_main(["build", h5, *BUILD, "--n-clusters", "3", "--stratified",
                     "--save-model", jax_path]) == 0
    _carried_model(jax_path, h5).save(port_path)
    return jax_path, port_path


def test_cli_validate(validate_models, tmp_path):
    jax_path, port_path = validate_models
    out, ref = str(tmp_path / "validate.json"), str(tmp_path / "validate_jax.json")
    args = ["--lags", "0", "1", "2", "--pcca-sets", "2"]
    assert main(["validate", port_path, *args, "--device", "cpu", "--output", out]) == 0
    assert jax_main(["validate", jax_path, *args, "--output", ref]) == 0
    results = json.load(open(out))
    _assert_json_close(results, json.load(open(ref)))
    assert results["lag_times"] == [1.0, 2.0, 3.0]
    assert len(results["implied_timescales"]) == 3
    assert len(results["ck_sets"]) == 2
    assert results["ck_max_abs_deviation"] < 0.5


def test_cli_validate_reports_ck_error_for_bad_lags(validate_models, tmp_path):
    jax_path, port_path = validate_models
    out, ref = str(tmp_path / "validate.json"), str(tmp_path / "validate_jax.json")
    assert main(["validate", port_path, "--lags", "1", "2", "--device", "cpu",
                 "--output", out]) == 0
    assert jax_main(["validate", jax_path, "--lags", "1", "2", "--output", ref]) == 0
    results = json.load(open(out))
    _assert_json_close(results, json.load(open(ref)))
    assert "integer lag multiples" in results["ck_error"]
    assert len(results["implied_timescales"]) == 2


@pytest.mark.parametrize("source", ["dat", "prmtop", "pdb", "object", "unsupported"])
def test_topology_and_basis_match_jax(tmp_path, monkeypatch, source):
    """``set_topology``/``set_basis``: ``.dat`` files through numpy alone,
    other paths and objects through (stubbed) mdtraj, as the JAX model
    loads them; without mdtraj a path that needs it raises the
    ``ImportError`` that names mdtraj."""
    rng = np.random.default_rng(5)
    dat = str(tmp_path / "ref.dat")
    np.savetxt(dat, rng.normal(size=(6, 3)))
    m, j = modelWE(device="cpu"), JaxModelWE()
    if source == "dat":
        for model in (m, j):
            model.set_topology(dat)
            model.set_basis(dat)
        np.testing.assert_array_equal(m.reference_coord, j.reference_coord)
        np.testing.assert_array_equal(m.basis_coords, j.basis_coords)
        assert (m.nAtoms, m.coord_ndim) == (j.nAtoms, j.coord_ndim) == (1, 3)
        return
    if source == "unsupported":
        for model in (m, j):
            with pytest.raises(NotImplementedError, match="Unsupported topology"):
                model.set_topology(3.0)
            with pytest.raises(NotImplementedError, match="Unsupported basis"):
                model.set_basis(3.0)
        return
    path = str(tmp_path / f"ref.{source}")
    open(path, "w").write("stub")
    if source != "object":
        monkeypatch.setitem(sys.modules, "mdtraj", None)
        with pytest.raises(ImportError, match="mdtraj"):
            m.set_topology(path)
    xyz = rng.normal(size=(1, 5, 3))
    _install_fake_mdtraj(monkeypatch, lambda p: xyz[0])
    arg = _FakeTraj(xyz) if source == "object" else path
    for model in (m, j):
        model.set_topology(arg)
        model.set_basis(arg)
    assert (m.nAtoms, m.coord_ndim) == (j.nAtoms, j.coord_ndim)
    if source == "prmtop":
        assert m.nAtoms == 7 and m.reference_structure.path == path
    else:
        np.testing.assert_array_equal(m.reference_coord, j.reference_coord)
        np.testing.assert_array_equal(m.basis_coords, j.basis_coords)
        assert m.nAtoms == 5
