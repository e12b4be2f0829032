"""TICA, VAMP and batch PCA in the port (``ops/pca.py``:
``PairMomentAccumulator``, ``TICAModel``; ``modelWE.dimReduce``) against
the JAX package on the same numpy inputs, on the CPU.

The f64 pair moments are a copy of JAX's host path and equal it bitwise;
the f32 path (products on a torch device, f64 Chan combine) stays within
atol 2e-4 of f64 in the fitted scales, far from the origin too (the JAX
suite's bound, ``tests/test_tica_vamp_goldens.py:226-251``). The builds
at 12 x 32 equal the JAX builds in dtrajs and JtargetSS.
"""
import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu.ops.pca import PairMomentAccumulator as JaxPairMoments
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.convert import tica_state_from_arrays
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.ops.pca import PairMomentAccumulator, TICAModel

torch.set_num_threads(1)

N_ITER, N_SEG, N_CLUSTERS, SEED = 12, 32, 3, 17
EDGES = np.linspace(0, 10, 13)
COMMON = dict(
    ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
    modelName="tica",
    basis_pcoord_bounds=[[9.0, 10.0]],
    target_pcoord_bounds=[[0.0, 1.0]],
    tau=1.0,
    n_clusters=N_CLUSTERS,
    show_live_display=False,
)


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_tica") / "west.h5"
    generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)


def _pairs(seed, n=2000, d=5, offset=0.0):
    rng = np.random.default_rng(seed)
    X0 = rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) + offset
    Xt = 0.7 * (X0 - offset) + 0.5 * rng.normal(size=(n, d)) + offset
    return X0, Xt, rng.random(n)


def _accumulate(acc, X0, Xt, w, chunks=8):
    bounds = np.linspace(0, len(X0), chunks + 1).astype(int)
    for a, b in zip(bounds[:-1], bounds[1:]):
        acc.add(X0[a:b], Xt[a:b], None if w is None else w[a:b])
    return acc


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_pair_moments_f64_equal_jax_bitwise(weighted):
    X0, Xt, w = _pairs(1)
    w = w if weighted else None
    port = _accumulate(PairMomentAccumulator(5), X0, Xt, w)
    ref = _accumulate(JaxPairMoments(5), X0, Xt, w)
    for name in ("mu0", "mut", "C00", "C0t", "Ctt"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port.n == ref.n


@pytest.mark.parametrize("offset", [0.0, 1e7], ids=["origin", "offset_1e7"])
def test_pair_moments_f32_within_f64(offset):
    """f32 device products (after f64 centering) against the f64 path, for
    TICA and VAMP, near and far from the origin; JAX's f32 path on the same
    data stays inside the same bound."""
    X0, Xt, w = _pairs(12, offset=offset)
    fits = {}
    for name, cls, kw in (("port", PairMomentAccumulator, {"device": "cpu"}),
                          ("jax", JaxPairMoments, {})):
        for dtype in (np.float64, np.float32):
            fits[name, dtype] = _accumulate(cls(5, dtype=dtype, **kw), X0, Xt, w)
    for method in ("tica", "vamp"):
        host = fits["port", np.float64].finalize(method, var_cutoff=1.0)
        dev = fits["port", np.float32].finalize(method, var_cutoff=1.0)
        jdev = fits["jax", np.float32].finalize(method, var_cutoff=1.0)
        np.testing.assert_allclose(dev.scales_, host.scales_, atol=2e-4)
        np.testing.assert_allclose(jdev.scales_, host.scales_, atol=2e-4)


@pytest.mark.parametrize("method", ["tica", "vamp"])
@pytest.mark.parametrize("var_cutoff", [0.95, 1.0])
def test_finalize_and_transform_match_jax(method, var_cutoff):
    X0, Xt, w = _pairs(3, d=6)
    port = _accumulate(PairMomentAccumulator(6), X0, Xt, w)
    ref = _accumulate(JaxPairMoments(6), X0, Xt, w)
    pm = port.finalize(method, var_cutoff=var_cutoff)
    jm = ref.finalize(method, var_cutoff=var_cutoff)
    assert isinstance(pm, TICAModel) and pm.output_dimension == jm.output_dimension
    for name in ("mean_", "components_", "scales_"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name))
    small = X0[:50]
    np.testing.assert_array_equal(pm.transform(small), jm.transform(small))
    # Above the device threshold: a torch product against jnp
    rows = int(2.5e7 / (X0.shape[1] * pm.output_dimension)) + 1
    big = np.tile(X0, (rows // len(X0) + 1, 1))
    assert 2.0 * big.size * pm.output_dimension >= 5e7
    np.testing.assert_allclose(pm.transform(big), jm.transform(big), rtol=1e-5,
                               atol=1e-5)


def _builds(west_h5, arrays, method):
    j = JaxModelWE()
    j.build_analyze_model(
        file_paths=[west_h5], dimreduce_method=method,
        step_kwargs={"clustering": {"user_bin_mapper": JaxMapper([EDGES])}}, **COMMON,
    )
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=ArrayWEDataset(arrays), dimreduce_method=method,
        step_kwargs={"clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES])}},
        **COMMON,
    )
    return j, m


@pytest.mark.parametrize("method", ["tica", "vamp", "batch-pca"])
def test_build_matches_jax(west_h5, arrays, method):
    """The default build (block cross-validation, predict route) with each
    reduction equals the JAX build: transform, features, dtrajs,
    JtargetSS and the validation models."""
    j, m = _builds(west_h5, arrays, method)
    assert m.ndim == j.ndim
    if method == "batch-pca":
        assert m.ndim == 12  # every component
        np.testing.assert_array_equal(m.coordinates.explained_variance_,
                                      j.coordinates.explained_variance_)
    else:
        np.testing.assert_array_equal(m.coordinates.scales_, j.coordinates.scales_)
    np.testing.assert_array_equal(m._features["child"], j._features["child"])
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8) and m.JtargetSS > 0
    for vm, vj in zip(m.validation_models, j.validation_models):
        assert vm.JtargetSS == pytest.approx(vj.JtargetSS, rel=1e-8)


def test_tica_state_from_jax_fit(west_h5, arrays):
    """The JAX package's fitted TICA, installed through ``convert``, gives
    the port the JAX features bitwise."""
    j = JaxModelWE()
    j.initialize([west_h5], COMMON["ref_struct"], "jax", dim_reduce_method="tica",
                 tau=1.0, basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]])
    j.get_iterations()
    j.dimReduce()
    m = modelWE(device="cpu")
    m.initialize(ArrayWEDataset(arrays), COMMON["ref_struct"], "port",
                 dim_reduce_method="tica", tau=1.0, basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]])
    m.get_iterations()
    tica_state_from_arrays(m, mean=j.coordinates.mean_,
                           components=j.coordinates.components_,
                           scales=j.coordinates.scales_)
    assert m.ndim == j.ndim
    for key in ("child", "parent"):
        np.testing.assert_array_equal(m._featurize_all()[key], j._featurize_all()[key])


def test_dimreduce_device_moments_match_host(arrays):
    """``device_moments=True`` (f32 products on the model's device) against
    the host f64 fit of the same pairs, for TICA and batch PCA."""
    fits = {}
    for method in ("tica", "batch-pca"):
        for dev_moments in (False, True):
            m = modelWE(device="cpu")
            m.initialize(ArrayWEDataset(arrays), COMMON["ref_struct"], "port",
                         dim_reduce_method=method, tau=1.0,
                         basis_pcoord_bounds=[[9.0, 10.0]],
                         target_pcoord_bounds=[[0.0, 1.0]])
            m.get_iterations()
            m.dimReduce(device_moments=dev_moments)
            fits[method, dev_moments] = m.coordinates
    np.testing.assert_allclose(fits["tica", True].scales_, fits["tica", False].scales_,
                               atol=2e-4)
    np.testing.assert_allclose(fits["batch-pca", True].explained_variance_,
                               fits["batch-pca", False].explained_variance_,
                               rtol=1e-5, atol=2e-4)
