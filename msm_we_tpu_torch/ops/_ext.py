"""Build and bind the CUDA kernel library of ``msm_we_tpu_torch/csrc``.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all at once,
and the objects are linked into one shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The library is built at first use into
``msm_we_tpu_torch/_build/``, named by a hash of the sources and the
compiler flags, and moved into place with an atomic rename so that two
processes never load half a library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of each extern "C" entry point in csrc/*.cu
_SIGNATURES = {
    "msm_transform_assign_child": [_P] * 9 + [_I] * 5 + [_P, _P, _P],
    "msm_transform_assign": [_P] * 9 + [_I] + [_P] * 5 + [_I] * 5 + [_P] * 4,
    "msm_transform_features": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    "msm_assign_flux": [_P] * 7 + [_I] + [_P] * 5 + [_I] * 4 + [_P] * 4,
    "msm_pair_plan_keys": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    "msm_pair_plan_tiles": [_P, _I, _P, _I, _P, _P, _P, _I, _P],
    "msm_pair_assign": [_P] * 8 + [_I] + [_P] * 3 + [_I] * 4 + [_P] * 5,
    "msm_graph_add_if": [_P, _P, _P],
    "msm_steady_tail": [_P] * 3 + [_I] * 3 + [_F] + [_P] * 8,
    "msm_tail_renorm": [_P, _I, _I, _P],
    "msm_tail_transition": [_P, _I, _P, _P, _I, _I] + [_P] * 4,
}

_lock = threading.Lock()
_lib = None
build_info = {}  # path, seconds, compiler log of the library in use


def _sources():
    return sorted(
        p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")
    )


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def library_path():
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmsm_we_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands in parallel; raise with the log of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                "nvcc failed building the CUDA kernels:\n" + " ".join(cmd) + "\n" + log
            )
    return "".join(logs)


def _compile(target):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, cmds = [], []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
        log = _run(cmds)
        tmp = os.path.join(tmpdir, "lib.so")
        log += _run([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, target)  # atomic: readers see all or nothing
    return time.perf_counter() - t0, log


def library():
    """The loaded kernel library, building it first if needed.

    Raises when ``nvcc`` is missing or the build fails; there is no
    fallback.
    """
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        seconds, log = 0.0, ""
        if not path.exists():
            seconds, log = _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_info.update(path=str(path), seconds=seconds, log=log)
        _lib = lib
        return lib


def check(err, name):
    """Raise if an entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _count_launch(wrapper, scores=False):
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``
    (``scores``: in ``wrapper.score_launches`` too, H4's score form). A
    call while the current stream is being captured into a CUDA graph
    (``_graph.py``) launches nothing, it records the launch, so it counts
    nothing: a graph's launches show in a trace of its replays."""
    if torch.cuda.is_current_stream_capturing():
        return
    wrapper.launches += 1
    if scores:
        wrapper.score_launches += 1
