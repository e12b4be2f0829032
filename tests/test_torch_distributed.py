"""Multi-process runs of the port (``msm_we_tpu_torch/parallel/distributed``)
on gloo groups of CPU processes, and ``modelWE.enable_mesh``.

* ``launch_local_dryrun``: 2 and 4 ranks, each reading only its row shard
  (``.npz``), the flux bitwise the one-rank flux (dyadic weights), on the
  divisible and the awkward shapes (ragged rows, bins straddling the
  bank's shards), over meshes (1, 2), (2, 1), (2, 2) and (4, 1). The
  launchers run on the card unless the caller passes ``device="cpu"``.
* A 30 x 200 synthetic build in the bench configuration (PCA, 12 WE bins,
  5 clusters a bin, no validation) on gloo ranks, each rank on the same
  data with ``enable_mesh()``: on mesh (1, 2) by the default routes, on
  (2, 1) with the device flux and stats routes switched on
  (``MSM_WE_TPU_DEVICE_*_MIN_ROWS=0``), and on (2, 2) with them on and
  without the continuity dedup. Against one process: dtrajs equal,
  flux and JtargetSS within 1e-12; against the JAX package's mesh build of
  the same run (its 8-device virtual CPU mesh): dtrajs equal, flux 1e-12,
  JtargetSS 1e-10. The build ends with the ids on every rank: rank 0 reads
  the dtrajs alone, with no collective.
* Without a process group ``enable_mesh()`` gives the (1, 1) mesh and the
  build of today's routes bit for bit; pickles drop the mesh, deep copies
  keep it.

Every group of ranks runs under a hard timeout well under a minute.

The ``cuda`` tests run gloo ranks that share the one card (their kernels on
the card, the collectives through the host); on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_distributed.py
"""
import contextlib
import copy
import inspect
import os
import pickle

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, modelWE
from msm_we_tpu_torch import fluxmatrix, structures
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.parallel.distributed import (
    build_analyze_bench,
    build_results,
    launch_local_build,
    launch_local_dryrun,
    launch_programs,
    run_worker,
)

torch.set_num_threads(1)

EDGES = np.linspace(0, 10, 13)
DATA = dict(n_iterations=30, n_segments=200, seed=17)
N_CLUSTERS = 5
TIMEOUT = 50  # seconds a group of ranks may take
ROUTE_ENVS = (fluxmatrix.DEVICE_FLUX_MIN_ROWS_ENV,
              structures.DEVICE_STATS_MIN_ROWS_ENV)


@contextlib.contextmanager
def _device_route(on):
    """Both device-route knobs at 0 inside the block when ``on``."""
    saved = {k: os.environ.get(k) for k in ROUTE_ENVS}
    if on:
        os.environ.update({k: "0" for k in ROUTE_ENVS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _one_process(device_route, no_mesh=False, device="cpu"):
    """The build in this process (its (1, 1) mesh; ``no_mesh``: the mesh
    left unset, as before ``enable_mesh`` existed)."""
    m = modelWE(device=device)
    if no_mesh:
        m.enable_mesh = lambda mesh=None: None
    with _device_route(device_route):
        build_analyze_bench(m, ArrayWEDataset(generate_we_arrays(**DATA)), EDGES,
                            n_clusters=N_CLUSTERS)
    return m


# (ranks, model-axis size, device routes on, continuity dedup): the host
# route mints the ids in the flux stage; the device routes leave them
# deferred to the end (the dedup single route, or the pair route without
# dedup) and compute the cluster statistics over the mesh
BUILDS = {"1x2": (2, 2, False, "auto"), "2x1_device_route": (2, 1, True, "auto"),
          "2x2_device_route_no_dedup": (4, 2, True, False)}


@pytest.fixture(scope="module")
def builds():
    out = {}
    for name, (n, m, device_route, dedup) in BUILDS.items():
        with _device_route(device_route):
            out[name] = launch_local_build(
                n, DATA, dict(n_clusters=N_CLUSTERS, dedup_coordinates=dedup),
                bin_edges=EDGES, device="cpu", model_parallel=m, timeout=TIMEOUT)
    out["one"] = build_results(_one_process(False))
    out["one_device_route"] = build_results(_one_process(True))
    return out


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max())


# ---------------------------------------------------------------- dryrun


@pytest.mark.parametrize("n_procs,model_parallel,awkward", [
    (2, None, False), (2, 1, True), (4, None, True), (4, 1, False)],
    ids=["1x2", "2x1-awkward", "2x2-awkward", "4x1"])
def test_launch_local_dryrun_matches_one_rank(n_procs, model_parallel, awkward):
    fm = launch_local_dryrun(n_procs, model_parallel=model_parallel,
                             awkward=awkward, device="cpu", timeout=TIMEOUT)
    assert fm.dtype == np.float64 and fm.sum() > 0


def test_a_failing_rank_raises_with_its_output():
    """No rank waits on a peer that died: the launch kills the others and
    raises with every rank's output."""
    with pytest.raises(RuntimeError, match="ranks failed"):
        launch_local_dryrun(2, backend="no-such-backend", device="cpu",
                            timeout=TIMEOUT)


@pytest.mark.parametrize("launcher", [launch_local_dryrun, launch_local_build,
                                      launch_programs, run_worker],
                         ids=lambda f: f.__name__)
def test_launchers_default_to_the_card(launcher):
    assert inspect.signature(launcher).parameters["device"].default == "cuda"


# ---------------------------------------------------------------- builds


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_rank_zero_reads_the_dtrajs_alone_after_the_build(builds, name):
    """A build over several ranks returns with its ids minted on every
    rank (also where the device routes deferred them), so rank 0 read its
    results alone: a collective there would have held it to the timeout."""
    assert bool(builds[name]["ids_at_build_end"])
    assert len(builds[name]["dtrajs"]) == len(builds["one"]["dtrajs"])


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_rank_build_matches_one_process(builds, name):
    got = builds[name]
    ref = builds["one_device_route" if BUILDS[name][2] else "one"]
    np.testing.assert_array_equal(got["dtrajs"], ref["dtrajs"])
    assert got["fluxMatrixRaw"].shape == ref["fluxMatrixRaw"].shape
    assert _rel(got["fluxMatrixRaw"], ref["fluxMatrixRaw"]) <= 1e-12
    assert _rel(got["fluxMatrix"], ref["fluxMatrix"]) <= 1e-12
    assert abs(float(got["JtargetSS"]) - float(ref["JtargetSS"])) <= 1e-12 * abs(
        float(ref["JtargetSS"]))


def test_rank_build_matches_jax_mesh_build(builds, tmp_path):
    """The JAX package's build on its virtual CPU mesh (``device_pipeline``
    enables a (4, 2) mesh over the 8 devices) of the same run."""
    from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
    from msm_we_tpu.data import generate_west_h5
    from msm_we_tpu.model import modelWE as JaxModelWE

    path = str(tmp_path / "west.h5")
    generate_west_h5(path, **DATA)
    j = JaxModelWE()
    j.build_analyze_model(
        file_paths=[path], ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="jax", basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
        n_clusters=N_CLUSTERS, cross_validation_groups=0, show_live_display=False,
        device_pipeline=True, step_kwargs={"clustering": {
            "user_bin_mapper": JaxMapper([EDGES]), "scan_small_batches": False}})
    assert j._mesh is not None and j._mesh.devices.size > 1
    j._ensure_discretized()
    for name in BUILDS:
        got = builds[name]
        np.testing.assert_array_equal(got["dtrajs"], np.concatenate(j.dtrajs))
        assert _rel(got["fluxMatrixRaw"], j.fluxMatrixRaw) <= 1e-12
        assert float(got["JtargetSS"]) == pytest.approx(j.JtargetSS, rel=1e-10)


@pytest.mark.parametrize("device_route", [False, True], ids=["host", "device"])
def test_enable_mesh_without_group_is_the_one_device_build(device_route):
    m = _one_process(device_route)
    assert m._mesh is not None and not m._mesh.distributed
    assert m._mesh.shape == {"data": 1, "model": 1}
    assert m._strat.mesh is m._mesh
    old = _one_process(device_route, no_mesh=True)
    assert old._mesh is None
    if device_route:  # the ids stayed deferred on both
        assert m._child_idx is None and old._child_idx is None
    a, b = build_results(m), build_results(old)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pickle_drops_the_mesh_and_deepcopy_keeps_it(tmp_path):
    m = _one_process(False)
    mesh = m._mesh
    twin = copy.deepcopy(m)
    assert twin._mesh is mesh and twin._strat.mesh is mesh
    back = pickle.loads(pickle.dumps(m))
    assert back._mesh is None and back._strat.mesh is None
    assert m._mesh is mesh and m._strat.mesh is mesh  # the live model keeps it
    with pytest.raises(TypeError, match="cannot be pickled"):
        pickle.dumps(mesh)
    # The (1, 1) mesh follows the model to another device
    m.to("cpu")
    assert m._mesh is mesh
    path = str(tmp_path / "m.obj")
    m.save(path)
    loaded = modelWE.load(path, device="cpu")
    assert loaded._mesh is None
    np.testing.assert_array_equal(loaded.fluxMatrix, m.fluxMatrix)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel,kernel,launches",
                         [(2, "pair_assign_scores", 4), (1, "assign_flux", 1)],
                         ids=["1x2", "2x1"])
def test_cuda_gloo_ranks_share_the_card(model_parallel, kernel, launches,
                                        cuda_device):
    """Two gloo ranks on the one card: the awkward shapes' flux bitwise the
    one-rank flux on the card. Each rank runs the five programs once: with
    model 2 the four assigning ones launch H4's score form, with model 1
    the flux step launches H3."""
    fm = launch_local_dryrun(2, model_parallel=model_parallel, awkward=True,
                             device="cuda", timeout=120)
    assert fm.sum() > 0
    assert [c[kernel] for c in launch_local_dryrun.rank_launches] == [launches] * 2


@pytest.mark.cuda
def test_cuda_rank_build_matches_one_card_build(cuda_device):
    """A 2-rank (1, 2) build with both device routes on, the ranks sharing
    the card, against the same build in this process on the card."""
    with _device_route(True):
        got = launch_local_build(2, DATA, dict(n_clusters=N_CLUSTERS),
                                 bin_edges=EDGES, device="cuda", timeout=120)
    ref = build_results(_one_process(True, device="cuda"))
    assert all(c["pair_assign_scores"] > 0 for c in launch_local_build.rank_launches)
    np.testing.assert_array_equal(got["dtrajs"], ref["dtrajs"])
    assert _rel(got["fluxMatrixRaw"], ref["fluxMatrixRaw"]) <= 1e-12
    assert abs(float(got["JtargetSS"]) - float(ref["JtargetSS"])) <= 1e-12 * abs(
        float(ref["JtargetSS"]))
