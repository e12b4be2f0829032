"""The parameter names and order of every public function and method the
port shares with the JAX package.

For each module of ``msm_we_tpu`` with a counterpart in
``msm_we_tpu_torch`` (same relative name), every public function, and every
public method (and ``__init__``) of a public class, defined in both modules
must take the same parameters in the same order. A positional call then
means the same thing in both packages. Only the differences ROADMAP §3
records are allowed:

- the port's ``device`` keyword, wherever it adds one;
- arguments the port drops because only the TPU, XLA or the reference's
  Ray fan-out needed them (``DROPPED``);
- the k-means draws, the one-process-a-card ``parallel/`` layer and the
  precomputed center norms of ``masked_scores`` (``RECORDED``).

``test_recorded_differences_are_still_differences`` keeps ``RECORDED``
from outliving the code it excuses.
"""
import importlib
import inspect
import pkgutil

import pytest

import msm_we_tpu
import msm_we_tpu_torch

# JAX-side arguments the port leaves out (ROADMAP §3): padding and static
# shapes for XLA (pad_to, n_bins, ndim, window), XLA's matmul precision
# (the port pins f32 products to IEEE in _device.py), and the reference's
# Ray and progress-bar plumbing (use_ray, result_batch_size, progress_bar)
DROPPED = {"pad_to", "n_bins", "ndim", "window", "precision", "use_ray",
           "result_batch_size", "progress_bar"}

# Recorded differences (ROADMAP §3), after DROPPED and ``device``:
# port parameters, JAX parameters
RECORDED = {
    # k-means draws: a CPU torch.Generator and an integer seed stand where
    # JAX takes a PRNG key; the draws' rows are reported for the parity tests
    "ops.kmeans:kmeans_plusplus": (["X", "w", "k", "generator", "return_index"],
                                   ["key", "X", "w", "k"]),
    "ops.kmeans:seed_bin": (["seed", "X", "w", "k"], ["key", "X", "w", "k"]),
    "ops.kmeans:seed_bins_batched": (["seeds", "Xs", "ws", "k", "return_index"],
                                     ["seeds", "Xs", "ws", "k"]),
    "ops.kmeans:kmeans_fit": (["X", "w", "k", "seed", "n_iter", "minibatch",
                               "batch_size", "return_init"],
                              ["X", "w", "k", "seed", "n_iter", "minibatch",
                               "batch_size"]),
    # the production score |c|^2 - 2x.c takes the bank's norms once
    "ops.kmeans:masked_scores": (["X", "seg_bin", "C", "center_bin", "valid", "c2"],
                                 ["X", "seg_bin", "C", "center_bin", "valid"]),
    # parallel/: one process a card over torch.distributed, where JAX runs
    # one process over a jax.sharding.Mesh of local devices
    "parallel.mesh:make_mesh": (["model_parallel"], ["devices", "model_parallel"]),
    "parallel.distributed:launch_local_dryrun": (
        ["n_procs", "model_parallel", "backend", "timeout", "problem", "awkward"],
        ["n_procs", "local_devices", "port", "timeout", "awkward"]),
    "parallel.distributed:run_worker": (
        ["rank", "n_procs", "init_method", "jobs_path", "out_dir", "backend", "timeout"],
        ["rank", "n_procs", "coordinator", "shard_path", "bank_path", "out_path",
         "local_devices", "model_parallel"]),
}


def _modules(pkg):
    names = {"": pkg.__name__}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names[info.name[len(pkg.__name__) + 1:]] = info.name
    return names


PORT, JAX = _modules(msm_we_tpu_torch), _modules(msm_we_tpu)
SHARED = sorted(set(PORT) & set(JAX))


def _params(fn):
    if isinstance(fn, (staticmethod, classmethod)):
        fn = fn.__func__
    return [p.name for p in inspect.signature(fn).parameters.values()]


def _normalized(port, jax):
    """The two parameter lists after the blanket rules: the port's added
    ``device`` and the JAX arguments in ``DROPPED`` that the port left out."""
    port = [p for p in port if p != "device" or p in jax]
    jax = [p for p in jax if p not in DROPPED or p in port]
    return port, jax


def _is_function(obj):
    """A plain function, or one wrapped by a decorator such as ``jax.jit``."""
    return inspect.isfunction(obj) or inspect.isfunction(getattr(obj, "__wrapped__", None))


def _pairs(rel):
    """``(qualname, port function, JAX function)`` for every public
    function and method defined in both modules."""
    pm = importlib.import_module(PORT[rel])
    jm = importlib.import_module(JAX[rel])
    out = []
    for name in sorted(set(vars(pm)) & set(vars(jm))):
        if name.startswith("_"):
            continue
        po, jo = vars(pm)[name], vars(jm)[name]
        if getattr(po, "__module__", None) != pm.__name__ or \
                getattr(jo, "__module__", None) != jm.__name__:
            continue  # re-exported from elsewhere: checked where defined
        if inspect.isclass(po) and inspect.isclass(jo):
            for attr in sorted(set(vars(po)) & set(vars(jo))):
                if attr.startswith("_") and attr != "__init__":
                    continue
                a, b = vars(po)[attr], vars(jo)[attr]
                if isinstance(a, property) or isinstance(b, property) or inspect.isclass(a):
                    continue
                if callable(a) or isinstance(a, (staticmethod, classmethod)):
                    out.append((f"{name}.{attr}", a, b))
        elif _is_function(po) and _is_function(jo):
            out.append((name, po, jo))
    return out


def _differences(rel):
    diffs = {}
    for qualname, a, b in _pairs(rel):
        port, jax = _normalized(_params(a), _params(b))
        if port != jax:
            diffs[f"{rel}:{qualname}"] = (port, jax)
    return diffs


@pytest.mark.parametrize("rel", SHARED, ids=[r or "package" for r in SHARED])
def test_shared_signatures_match_jax(rel):
    unrecorded = {k: v for k, v in _differences(rel).items() if RECORDED.get(k) != v}
    assert not unrecorded, (
        "parameters differ from the JAX package's (port, JAX) and ROADMAP §3 "
        f"does not record it: {unrecorded}")


def test_every_module_has_its_counterpart():
    """The port has every module of the JAX package but the Pallas kernels
    (ported as the CUDA kernels of ``csrc/``)."""
    assert sorted(set(JAX) - set(PORT)) == ["ops.pallas_kernels"]
    for rel in ("cli", "extended", "scripts.collect_coordinates",
                "westpa_plugins.augmentation_driver", "westpa_plugins.hamsm_driver",
                "westpa_plugins.optimization_driver", "westpa_plugins.restart_driver"):
        assert rel in SHARED and _pairs(rel), rel


def test_recorded_differences_are_still_differences():
    found = {}
    for rel in {key.split(":")[0] for key in RECORDED}:
        found.update(_differences(rel))
    assert {k: found.get(k) for k in RECORDED} == RECORDED


def test_the_comparison_catches_a_swapped_flag():
    """Two flags in swapped positions (the fault ``cluster_stratified``
    had) are a difference; the blanket rules do not hide it."""
    def jax_side(self, n, progress_bar=None, defer_discretization=False,
                 scan_small_batches=False):
        pass

    def port_side(self, n, progress_bar=None, scan_small_batches=False,
                  defer_discretization=False, device="cpu"):
        pass

    port, jax = _normalized(_params(port_side), _params(jax_side))
    assert port != jax
    from msm_we_tpu.model import modelWE as JaxModelWE
    from msm_we_tpu_torch.model import modelWE

    assert _params(modelWE.cluster_stratified) == _params(JaxModelWE.cluster_stratified)
