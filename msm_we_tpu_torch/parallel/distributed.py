"""Multi-process runs of the sharded programs: one process per rank, joined
by ``torch.distributed``.

Counterpart of ``msm_we_tpu/parallel/distributed.py``. The JAX package
joins processes with ``jax.distributed`` and assembles global arrays from
per-process h5 shards; here every rank of a process group reads only its
own row shard (``.npz`` files: the card's machine has no h5py) and the
replicated bank, runs the programs of :mod:`.sharded` on them, and rank 0
saves the replicated results.

* :func:`launch_programs` runs the sharded programs (step, pair, single,
  plain assignment, cluster statistics) of given problems on given mesh
  shapes and returns rank 0's results (``entry.dryrun_multichip``, the
  tests); :func:`run_worker` is its per-rank entry point.
* :func:`launch_local_dryrun` runs them on ``n_procs`` ranks for one
  problem and holds the flux to the one-rank flux, bitwise (dyadic
  weights).
* :func:`launch_local_build` runs a whole build on ``n_procs`` ranks, each
  rank on the same synthetic data, with ``model.enable_mesh()``.

Every launch runs its ranks as subprocesses with a hard timeout: on expiry
or on any rank's failure all ranks are killed and the launch raises with
their output. After a launch, its function's ``rank_launches`` lists each
rank's kernel launch counts. The launches run on the card unless the
caller passes ``device="cpu"``; on the card the kernel library is built
once in the launching process before the ranks start. Ranks meet through a
``file://`` rendezvous in a temporary directory, so concurrent launches
never collide on a port. Ranks of a gloo group may share one card; an NCCL
group needs one card a rank.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["run_worker", "launch_local_dryrun", "launch_programs",
           "launch_local_build", "run_programs", "shard_problem"]

# Row arrays of a problem and their inert padding
_ROW_FILL = dict(fp=0.0, fc=0.0, pbins=-1, cbins=-1, basis_p=False,
                 basis_c=False, target_c=False, target_p=False, w=0.0,
                 p1=float("nan"))
_STEP_KEYS = ["fp", "fc", "pbins", "cbins", "basis_p", "basis_c", "target_c", "w"]
_BANK_KEYS = ["centers", "center_bin", "valid"]
_DTYPES = dict(fp=np.float32, fc=np.float32, pbins=np.int32, cbins=np.int32,
               basis_p=bool, basis_c=bool, target_c=bool, target_p=bool,
               p1=np.float32, centers=np.float32, center_bin=np.int32, valid=bool)


def _model_parallel(n_procs):
    """Model-axis size of a dryrun's mesh: ``best_mesh_shape``'s rule, one
    value for every job of a comparison."""
    from .mesh import best_mesh_shape

    return best_mesh_shape(n_procs)[1]


def _init_group(rank, n_procs, init_method, backend, timeout):
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=init_method, world_size=n_procs, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )


def _tensors(arrays, device):
    import torch

    return {k: torch.as_tensor(np.ascontiguousarray(np.asarray(v).astype(
        _DTYPES.get(k, np.asarray(v).dtype)))).to(device) for k, v in arrays.items()}


# ------------------------------------------------------------ programs


def complete_problem(problem):
    """``problem`` with what :func:`run_programs` reads beyond a
    ``tiny_stratified_problem``, where it is missing: ``target_p`` (5% of
    the rows), ``p1`` (two child pcoords a row) and ``n_live`` (the
    statistics' live clusters, K), all seeded by the sizes."""
    N, K = len(problem["w"]), len(problem["valid"])
    out = dict(problem)
    if "target_p" not in out:
        out["target_p"] = np.random.default_rng(N).random(N) < 0.05
    if "p1" not in out:
        out["p1"] = np.random.default_rng(N + K).random((N, 2)).astype(np.float32)
    out.setdefault("n_live", K)
    return out


def shard_problem(problem, data=1, d=0):
    """What rank ``(d, *)`` of a mesh with ``data`` rows reads of a
    :func:`complete_problem`: row block ``d`` (the mesh's contiguous
    blocks of ``ceil(N / data)`` rows, padded inert: bin -1, weight 0,
    masks False, NaN pcoords), the replicated bank, and the sizes
    (``n_states``, ``n_live``, ``n_rows`` = N). ``data=1``: the whole
    problem, the one-rank input."""
    p = complete_problem(problem)
    N = len(p["w"])
    block = -(-N // data)
    lo, hi = min(d * block, N), min((d + 1) * block, N)
    out = {}
    for key, fill in _ROW_FILL.items():
        a = np.asarray(p[key]).astype(_DTYPES.get(key, np.asarray(p[key]).dtype))
        part = np.full((block,) + a.shape[1:], fill, dtype=a.dtype)
        part[: hi - lo] = a[lo:hi]
        out[key] = part
    out.update({k: np.asarray(p[k]) for k in _BANK_KEYS})
    out.update(n_states=int(p["n_states"]), n_live=int(p["n_live"]), n_rows=N)
    return out


def run_programs(mesh, shard):
    """Every sharded program of :mod:`.sharded` on this rank's
    :func:`shard_problem` (whose ``w`` gives the flux its dtype) over
    ``mesh``; ids are gathered over 'data'. Returns numpy arrays, equal on
    every rank: ``fm`` (the flux step with ``target_p``), ``pidx``/``cidx``
    (the predict-order pair program), ``single`` (the child program),
    ``assign`` (raw child ids), and the cluster statistics of the raw child
    ids over ``p1`` (``counts``, ``sums``, ``vmin``, ``vmax``)."""
    from .sharded import (
        build_sharded_assign,
        build_sharded_cluster_stats,
        build_sharded_pair_assign,
        build_sharded_single_assign,
        build_sharded_step,
    )

    N, n_states = int(shard["n_rows"]), int(shard["n_states"])
    if mesh.row_block(N)[2] != len(shard["w"]):
        raise ValueError(f"a row shard of {len(shard['w'])} rows does not fit "
                         f"{mesh} with {N} rows")
    rows = _tensors({k: shard[k] for k in _ROW_FILL}, mesh.device)
    bank = list(_tensors({k: shard[k] for k in _BANK_KEYS}, mesh.device).values())
    r = [rows[k] for k in _STEP_KEYS]
    masks = [rows[k] for k in ("basis_p", "basis_c", "target_c")]
    out = {"fm": build_sharded_step(mesh, n_states, with_target_p=True)(
        *r, *bank, rows["target_p"])}
    pidx, cidx = build_sharded_pair_assign(mesh, n_states, with_target_p=True)(
        *r[:4], *masks, *bank, rows["target_p"])
    out["pidx"], out["cidx"] = (mesh.gather_rows(pidx, N), mesh.gather_rows(cidx, N))
    out["single"] = mesh.gather_rows(build_sharded_single_assign(mesh, n_states)(
        rows["fc"], rows["cbins"], rows["basis_c"], rows["target_c"], *bank), N)
    raw = build_sharded_assign(mesh)(rows["fc"], rows["cbins"], *bank)
    out["assign"] = mesh.gather_rows(raw, N)
    # Padded rows carry NaN pcoords, which the statistics skip
    stats = build_sharded_cluster_stats(mesh, len(shard["valid"]))(
        raw, rows["p1"], int(shard["n_live"]))
    out.update(zip(("counts", "sums", "vmin", "vmax"), stats))
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_worker(rank, n_procs, init_method, jobs_path, out_dir, backend="gloo",
               device="cuda", timeout=300):
    """One rank of :func:`launch_programs`: join the group, then for every
    job (row shards by data index and a model-axis size) in order read
    only this rank's shard and run :func:`run_programs`; rank 0 saves each
    job's results."""
    import torch.distributed as dist

    from .mesh import make_mesh

    _init_group(rank, n_procs, init_method, backend, timeout)
    try:
        with open(jobs_path) as fh:
            jobs = json.load(fh)
        meshes = {}
        for job in jobs:
            m = job["model_parallel"]
            if m not in meshes:  # group construction is collective: same order
                meshes[m] = make_mesh(model_parallel=m, device=device)
            mesh = meshes[m]
            with np.load(job["shards"][mesh.coords[0]]) as z:
                shard = {k: z[k] for k in z.files}
            res = run_programs(mesh, shard)
            if rank == 0:
                np.savez(os.path.join(out_dir, job["name"] + ".npz"), **res)
        next(iter(meshes.values())).barrier()
    finally:
        dist.destroy_process_group()


def pad_problem(problem, n_pad, k_pad):
    """A :func:`complete_problem` padded with inert rows (bin -1, weight 0,
    masks False, NaN pcoords) to ``n_pad`` rows and invalid bank rows (bin
    -2) to ``k_pad``: the answer must not change."""
    from ..testing import pad_stratified_problem

    p = pad_stratified_problem(complete_problem(problem), n_pad, k_pad)
    N = len(problem["w"])
    for key, fill in (("target_p", False), ("p1", np.nan)):
        a = np.asarray(p[key])
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
        out[:N] = a
        p[key] = out
    return p


def launch_programs(jobs, n_procs, backend="gloo", device="cuda", timeout=120):
    """Run :func:`run_programs` on ``n_procs`` ranks for every job ``(name,
    problem dict, model-axis size)`` (the size dividing ``n_procs``), in
    order, one process group for all; each rank reads only its row shard
    of each problem. Returns ``{name: results of rank 0}``."""
    with tempfile.TemporaryDirectory(prefix="msm_we_torch_mesh_") as workdir:
        saved, specs = {}, []
        for i, (_name, problem, m) in enumerate(jobs):
            data = n_procs // int(m)
            key = (id(problem), data)  # a problem shared by jobs is cut once
            if key not in saved:
                saved[key] = []
                for d in range(data):
                    path = os.path.join(workdir, f"problem_{i}_rows_{d}.npz")
                    np.savez(path, **shard_problem(problem, data, d))
                    saved[key].append(path)
            specs.append(dict(name=f"job_{i}", shards=saved[key],
                              model_parallel=int(m)))
        jobs_path = os.path.join(workdir, "jobs.json")
        with open(jobs_path, "w") as fh:
            json.dump(specs, fh)
        launch_programs.rank_launches = _spawn(
            "programs", n_procs, workdir, timeout, dict(
                backend=backend, device=device, jobs_path=jobs_path,
                out_dir=workdir))
        out = {}
        for (name, _p, _m), spec in zip(jobs, specs):
            with np.load(os.path.join(workdir, spec["name"] + ".npz")) as z:
                out[name] = {k: z[k] for k in z.files}
        return out


# --------------------------------------------------------------- builds


def _build_worker(rank, n_procs, init_method, backend, device, data_kwargs,
                  build_kwargs, bin_edges, model_parallel, out_path, timeout):
    """One rank of :func:`launch_local_build`: the bench-configuration
    build of ``generate_we_arrays(**data_kwargs)`` with ``enable_mesh()``;
    rank 0 alone reads and saves its results (a build over several ranks
    ends with its ids on every rank: reading them runs no collective), and
    whether the ids were there when the build returned."""
    import torch.distributed as dist

    from ..data import ArrayWEDataset, generate_we_arrays
    from ..model import modelWE
    from .mesh import make_mesh

    _init_group(rank, n_procs, init_method, backend, timeout)
    try:
        model = modelWE(device=device)
        mesh = make_mesh(model_parallel=model_parallel, device=device)
        model.enable_mesh(mesh)
        build_analyze_bench(model, ArrayWEDataset(generate_we_arrays(**data_kwargs)),
                            bin_edges, **build_kwargs)
        if rank == 0:
            ids_at_build_end = model._parent_idx is not None
            np.savez(out_path, ids_at_build_end=ids_at_build_end,
                     **build_results(model))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def build_analyze_bench(model, dataset, bin_edges, n_clusters=3, **kw):
    """``build_analyze_model`` in the bench configuration (PCA, stratified,
    pair route, no validation) on ``dataset``."""
    from ..binning import RectilinearBinMapper

    kw.setdefault("step_kwargs", {"clustering": {
        "user_bin_mapper": RectilinearBinMapper([np.asarray(bin_edges, float)]),
        "scan_small_batches": False}})
    return model.build_analyze_model(**{**dict(
        file_paths=dataset, ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="mesh", basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
        n_clusters=n_clusters, cross_validation_groups=0,
        show_live_display=False, device_pipeline=True), **kw})


def build_results(model):
    """The arrays two builds are compared by."""
    model._ensure_discretized()
    return dict(dtrajs=np.concatenate(model.dtrajs),
                fluxMatrixRaw=model.fluxMatrixRaw, fluxMatrix=model.fluxMatrix,
                pSS=model.pSS, JtargetSS=np.float64(model.JtargetSS))


def launch_local_build(n_procs, data_kwargs, build_kwargs=None,
                       bin_edges=tuple(np.linspace(0, 10, 11)), backend="gloo",
                       device="cuda", model_parallel=None, timeout=120):
    """A bench-configuration build on ``n_procs`` ranks (every rank on the
    same ``generate_we_arrays(**data_kwargs)`` data, ``enable_mesh()`` on
    ``best_mesh_shape`` or ``model_parallel``). Returns rank 0's
    :func:`build_results`."""
    with tempfile.TemporaryDirectory(prefix="msm_we_torch_build_") as workdir:
        out_path = os.path.join(workdir, "build.npz")
        launch_local_build.rank_launches = _spawn(
            "build", n_procs, workdir, timeout, dict(
                backend=backend, device=device, data_kwargs=dict(data_kwargs),
                build_kwargs=dict(build_kwargs or {}), bin_edges=list(bin_edges),
                model_parallel=model_parallel, out_path=out_path))
        with np.load(out_path) as z:
            return {k: z[k] for k in z.files}


# --------------------------------------------------------------- dryrun


def launch_local_dryrun(n_procs=2, model_parallel=None, backend="gloo",
                        device="cuda", timeout=120, problem=None, awkward=False):
    """:func:`launch_programs` of one problem on ``n_procs`` ranks (each
    reading only its row shard), with its flux required to equal the
    one-rank flux (:func:`run_programs` on the (1, 1) mesh of this process,
    on ``device``) bitwise: the weights of the default problems are dyadic.
    Returns the flux; ``launch_local_dryrun.rank_launches`` the ranks'
    launch counts.

    ``problem`` defaults to ``tiny_stratified_problem(32 * n_procs)``;
    ``awkward=True`` takes a ragged row count (``16 * data + 7``) and
    ``n_bins = model + 1`` bins of 3 centers (bins straddle the bank's
    shards). ``model_parallel`` defaults to ``best_mesh_shape``'s."""
    from ..testing import tiny_stratified_problem
    from .mesh import Mesh

    if model_parallel is None:
        model_parallel = _model_parallel(n_procs)
    data = n_procs // model_parallel
    if problem is None:
        problem = (tiny_stratified_problem(n_rows=16 * data + 7,
                                           n_bins=model_parallel + 1, k=3, seed=3)
                   if awkward else tiny_stratified_problem(n_rows=32 * n_procs, seed=3))
    # The flux of a build: f64 weights, summed over 'data' in f64
    problem = dict(problem, w=np.asarray(problem["w"], np.float64))
    fm_multi = launch_programs([("dryrun", problem, model_parallel)], n_procs,
                               backend=backend, device=device,
                               timeout=timeout)["dryrun"]["fm"]
    launch_local_dryrun.rank_launches = launch_programs.rank_launches
    fm_single = run_programs(Mesh.single(device), shard_problem(problem))["fm"]
    if not np.array_equal(fm_multi, fm_single):
        raise AssertionError(
            f"{n_procs}-rank flux differs from the one-rank flux by "
            f"{np.abs(fm_multi - fm_single).max()}")
    return fm_multi


# --------------------------------------------------------------- spawning


def _spawn(mode, n_procs, workdir, timeout, kwargs):
    """Run ``n_procs`` ranks of ``mode`` as subprocesses of this module
    (``kwargs`` as arguments), joined by a
    ``file://`` rendezvous in ``workdir``; kill all of them and raise with
    their output when one fails or ``timeout`` seconds pass. Returns each
    rank's kernel launch counts at its end (``ops.stratified_assign.
    launch_counts``, and ``pair_assign_scores``: H4's score-form launches)."""
    if str(kwargs["device"]).startswith("cuda"):
        from ..ops._ext import library

        library()  # one kernel build, here, before the ranks load it
    init_method = "file://" + os.path.join(workdir, "rendezvous")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for rank in range(n_procs):
        spec = dict(mode=mode, rank=rank, n_procs=n_procs,
                    init_method=init_method, timeout=timeout, **kwargs,
                    counts_path=os.path.join(workdir, f"counts_{rank}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "msm_we_tpu_torch.parallel.distributed",
             json.dumps(spec)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outputs, failed = [], False
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for proc in procs:
        left = max((deadline - datetime.datetime.now()).total_seconds(), 0.1)
        try:
            out, _ = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            failed = True
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
        outputs.append(out.decode(errors="replace"))
        failed = failed or proc.returncode != 0
        if failed:  # one rank down: the others would wait on it until timeout
            for p in procs:
                p.kill()
    if failed:
        raise RuntimeError(
            f"{mode} ranks failed:\n" + "\n--- rank ---\n".join(outputs))
    counts = []
    for rank in range(n_procs):
        with open(os.path.join(workdir, f"counts_{rank}.json")) as fh:
            counts.append(json.load(fh))
    return counts


def _main():
    from ..ops.stratified_assign import launch_counts, pair_assign

    spec = json.loads(sys.argv[1])
    mode = spec.pop("mode")
    counts_path = spec.pop("counts_path")
    common = (spec.pop("rank"), spec.pop("n_procs"), spec.pop("init_method"))
    workers = {"programs": run_worker, "build": _build_worker}
    workers[mode](*common, **spec)
    with open(counts_path, "w") as fh:
        json.dump(dict(launch_counts(),
                       pair_assign_scores=pair_assign.score_launches), fh)


if __name__ == "__main__":
    _main()
