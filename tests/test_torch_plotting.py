"""``msm_we_tpu_torch.plotting`` and the model's plot methods against the JAX
package's, on the headless ``Agg`` backend.

The JAX model is built as ``tests/test_plotting.py`` builds it (30
iterations x 16 segments, seed 13, no reduction, 2 clusters a bin); the
port's model gets the same fitted bank through
``convert.fitted_state_from_arrays`` and runs its own stages from the
discretization on. Both models then draw every plot, and the arrays each
artist holds (line and scatter coordinates, colours, labels, axis limits)
must be equal: the plotted numbers come from host f64 arrays that agree to
1e-10 or better, so the comparison is ``rtol=1e-9``;
``get_coarse_flux_profile`` is held to 1e-12.
"""
import copy
import subprocess
import sys
import os
import textwrap

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch
from matplotlib import pyplot as plt

from msm_we_tpu import plotting as jplotting
from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu_torch import ArrayWEDataset, modelWE
from msm_we_tpu_torch import plotting
from msm_we_tpu_torch.convert import fitted_state_from_arrays
from msm_we_tpu_torch.data import generate_we_arrays

torch.set_num_threads(1)

N_ITER, N_SEG, SEED = 30, 16, 13
EDGES = np.linspace(0, 10, 11)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}


def _stages(model):
    model.get_fluxMatrix(0)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    model.get_committor()
    model.get_flux()
    model.get_flux_committor()
    return model


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_plot") / "west.h5")
    generate_west_h5(path, n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    init = dict(basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
                dim_reduce_method="pca", tau=1.0)
    j = JaxModelWE()
    j.initialize([path], REF, "plotme", **init)
    j.get_iterations()
    j.get_coordSet(j.maxIter)
    j.dimReduce()
    j.cluster_coordinates(n_clusters=2, stratified=True,
                          user_bin_mapper=JaxMapper([EDGES]))
    strat = j._strat
    strat._sync_host()
    m = modelWE(device="cpu")
    m.initialize(ArrayWEDataset(generate_we_arrays(N_ITER, N_SEG, seed=SEED)), REF,
                 "plotme", **init)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    fitted_state_from_arrays(
        m, pca_mean=j.coordinates.mean_, pca_components=j.coordinates.components_,
        pca_explained_variance=j.coordinates.explained_variance_,
        centers=strat.centers, counts=strat.counts, center_bin=strat.center_bin,
        valid=strat.valid, initialized=strat.initialized, we_remap=strat.we_remap,
        bin_edges=[EDGES])
    _stages(j)
    _stages(m)
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    return j, m


def _artists(ax):
    """Every number and label an axes holds."""
    out = []
    for line in ax.get_lines():
        out.append(("line", line.get_label(), line.get_marker(),
                    np.asarray(line.get_xdata(), float),
                    np.asarray(line.get_ydata(), float),
                    np.asarray(matplotlib.colors.to_rgba(line.get_color()))))
    for coll in ax.collections:
        arr = coll.get_array()
        offsets = np.asarray(coll.get_offsets(), float)
        out.append(("collection", coll.get_label(), len(offsets), offsets,
                    np.zeros(0) if arr is None else np.asarray(arr, float),
                    np.asarray(coll.get_facecolor(), float)))
    for text in ax.texts:
        out.append(("text", text.get_text(), None, np.asarray(text.get_position()),
                    np.zeros(0), np.zeros(0)))
    out.append(("axes", ax.get_xlabel() + "|" + ax.get_ylabel() + "|" + ax.get_title(),
                ax.get_yscale(), np.asarray(ax.get_xlim()), np.zeros(0), np.zeros(0)))
    return out


def _assert_same_axes(ax_port, ax_ref):
    a, b = _artists(ax_port), _artists(ax_ref)
    assert len(a) == len(b) and len(a) > 1
    for got, want in zip(a, b):
        assert got[:3] == want[:3]
        for x, y in zip(got[3:], want[3:]):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-300, equal_nan=True)


def _fig_axes(result):
    """The axes of whatever a plot function returned."""
    if isinstance(result, tuple):
        result = result[0]
    fig = result if hasattr(result, "axes") and not hasattr(result, "plot") else result.figure
    return [ax for ax in fig.axes]


PLOTS = {
    "flux": lambda m: m.plot_flux(suppress_validation=True),
    "flux_custom": lambda m: m.plot_flux(suppress_validation=True, pcoord_to_use=0,
                                         markersize=4, _to_colors=["k"] * 3,
                                         _from_colors=["g"] * 3),
    "flux_committor": lambda m: m.plot_flux_committor(suppress_validation=True),
    "flux_committor_nwin3": lambda m: m.plot_flux_committor(nwin=3,
                                                            suppress_validation=True),
    "flux_committor_pcoordcolor": lambda m: m.plot_flux_committor_pcoordcolor(nwin=2),
    "committor": lambda m: m.plot_committor(),
    "coarse_flux_profile": lambda m: m.plot_coarse_flux_profile(),
    "implied_timescales": lambda m: m.plot_implied_timescales(lags=(0, 1, 2)),
    "ck_test": lambda m: m.plot_ck_test(lags=(0, 1, 2), sets=2),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_draws_the_same_arrays_as_jax(models, name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # plot_committor saves a png into the cwd
    j, m = (copy.deepcopy(x) for x in models)
    try:
        port_axes = _fig_axes(PLOTS[name](m))
        ref_axes = _fig_axes(PLOTS[name](j))
        assert len(port_axes) == len(ref_axes) >= 1
        for a, b in zip(port_axes, ref_axes):
            _assert_same_axes(a, b)
    finally:
        plt.close("all")


def test_plots_overlay_validation_models(models):
    j, m = (copy.deepcopy(x) for x in models)
    try:
        with pytest.raises(RuntimeError, match="cross-validation"):
            m.plot_flux()
        with pytest.raises(RuntimeError, match="cross-validation"):
            m.plot_flux_committor()
        for model, source in ((j, models[0]), (m, models[1])):
            model.validation_models = [copy.deepcopy(source) for _ in range(2)]
        _assert_same_axes(m.plot_flux(), j.plot_flux())
        _assert_same_axes(m.plot_flux_committor(), j.plot_flux_committor())
        ax = m.plot_flux()
        labels = [line.get_label() for line in ax.get_lines()]
        assert "validation_model_1 flux toward target" in labels
    finally:
        plt.close("all")


def test_plot_on_a_given_axes_and_save(models, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _j, m = (copy.deepcopy(x) for x in models)
    try:
        fig, ax = plt.subplots()
        assert m.plot_flux(ax=ax, suppress_validation=True, save=True) is ax
        assert (tmp_path / "plotme_flux.pdf").stat().st_size > 0
        assert ax.get_legend() is None  # the caller's axes keep their legend
        m.draw_basis_target_boundaries(ax)
        m.slope_overcorrected = True
        n_text = len(ax.texts)
        m.check_display_overcorrection_warning(ax)
        assert len(ax.texts) == n_text + 1
        fig2, axes = m.plot_ck_test(lags=(0, 1), sets=2, axes=plt.subplots(1, 2)[1])
        assert fig2 is axes[0].figure
    finally:
        plt.close("all")


def test_committor_bands_from_the_bootstrap(models, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _j, m = (copy.deepcopy(x) for x in models)
    try:
        bare = len(m.plot_committor().axes[0].collections)
        m.bootstrap_target_flux(n_boot=12, seed=5, observables=("flux", "committor"))
        assert "committor_ci" in m.flux_bootstrap
        assert len(m.plot_committor().axes[0].collections) > bare
    finally:
        plt.close("all")


@pytest.mark.parametrize("min_coarse_bins", [10, 4])
def test_coarse_flux_profile_matches_jax(models, min_coarse_bins):
    j, m = models
    got = m.get_coarse_flux_profile(min_coarse_bins=min_coarse_bins)
    ref = j.get_coarse_flux_profile(min_coarse_bins=min_coarse_bins)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-18)
    assert len(got[0]) == len(got[1]) == min_coarse_bins
    assert np.isfinite(got[0]).all()


def test_windowed_committor_flux_matches_jax(models):
    j, m = models
    for nwin in (1, 3, 5):
        for a, b in zip(plotting._windowed_committor_flux(m, nwin),
                        jplotting._windowed_committor_flux(j, nwin)):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300)


def test_missing_matplotlib_raises_an_import_error_naming_it(models, monkeypatch):
    _j, m = models
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    for call in (lambda: m.plot_flux(suppress_validation=True), m.plot_committor,
                 m.plot_coarse_flux_profile, m.plot_implied_timescales,
                 m.plot_ck_test, m.plot_flux_committor_pcoordcolor,
                 lambda: m.plot_flux_committor(suppress_validation=True)):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    # The arrays behind the plots need no matplotlib
    assert len(m.get_coarse_flux_profile()[0]) == 10


def test_importing_plotting_pulls_in_no_matplotlib():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {root!r})
        import msm_we_tpu_torch.plotting as p
        assert callable(p.get_coarse_flux_profile)
        assert "matplotlib" not in sys.modules, "matplotlib imported"
        print("CLEAN")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0 and "CLEAN" in res.stdout, res.stdout + res.stderr
