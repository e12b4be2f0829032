"""The ('data', 'model') layout of the ranks of a ``torch.distributed`` job.

Counterpart of ``msm_we_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over the chips of one process; here one process
drives one device and a multi-device build is launched as one process per
device (``torchrun --nproc_per_node=N``), every rank running the same
script on the same inputs. A :class:`Mesh` lays the ranks of the default
process group out as a (data, model) grid, row-major like JAX's
``reshape(data, model)``: rank ``r`` sits at ``(r // model, r % model)``.

* ``data``: segments are split into contiguous row blocks, padded with
  inert rows (bin -1, weight 0, masks False); rank ``d`` of the axis
  scores block ``d`` only.
* ``model``: the compact center bank is split into equal contiguous
  shards, padded with invalid rows to ``ceil(K / model) * model``; the
  shard's local id plus ``m * shard`` is the global id.

Results are replicated on every rank: sums, minima and maxima by an
all-reduce over 'data', ids by an all-gather of the blocks over 'data'.
On a gloo group the tensors of a CUDA device go through the host for every
collective (gloo has no ``all_gather`` and no MIN/MAX reduce for CUDA
tensors); NCCL takes them as they are. Without an initialized process
group the mesh is (1, 1) and issues no collective.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .._device import as_device

__all__ = ["Mesh", "make_mesh", "best_mesh_shape"]

_SINGLES = {}  # device -> its (1, 1) mesh
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def best_mesh_shape(n_devices, model_parallel=None):
    """(data, model) factorization of ``n_devices``: the model axis is 2
    when ``n_devices`` is even and above 1, else 1 (center banks are
    small); the data axis takes the rest."""
    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n_devices} ranks")
    return n_devices // model_parallel, model_parallel


class Mesh:
    """This rank's place in a (data, model) layout of the process group.

    ``shape`` (``{"data": D, "model": M}``), ``coords`` (this rank's
    ``(d, m)``), ``groups`` (``{"data": ..., "model": ..., "world": ...}``,
    each None without a process group), ``device`` (where this rank's
    tensors live) and ``backend`` (the group's, or None). A mesh belongs to
    its process: pickles drop it and copies share it.
    """

    def __init__(self, shape, coords, groups, device, backend):
        self.shape = dict(shape)
        self.coords = tuple(coords)
        self.groups = dict(groups)
        self.device = as_device(device)
        self.backend = backend

    @classmethod
    def single(cls, device):
        """The (1, 1) mesh on ``device``: no process group, no collective.
        One object a device, so that caches keyed by their mesh hold."""
        device = as_device(device)
        if device not in _SINGLES:
            _SINGLES[device] = cls({"data": 1, "model": 1}, (0, 0),
                                   {"data": None, "model": None, "world": None},
                                   device, None)
        return _SINGLES[device]

    @property
    def distributed(self):
        """True when the mesh has process groups (its collectives run)."""
        return self.backend is not None

    @property
    def world_size(self):
        return self.shape["data"] * self.shape["model"]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")

    def __deepcopy__(self, memo):
        return self  # process groups belong to the process: copies share them

    def __reduce__(self):
        raise TypeError("a Mesh belongs to its process and cannot be pickled")

    # ------------------------------------------------------------ layout
    def row_block(self, n):
        """``(lo, hi, block)``: this rank's rows ``[lo, hi)`` of ``n`` and
        the common block length ``ceil(n / data)`` every data rank pads to."""
        block = -(-n // self.shape["data"])
        lo = min(self.coords[0] * block, n)
        return lo, min(lo + block, n), block

    def rows(self, a, fill):
        """This rank's row block of ``a`` (numpy or tensor, ``n`` rows) as
        a tensor on the mesh's device, padded to the block length with
        ``fill`` (padding must be inert where it is consumed)."""
        lo, hi, block = self.row_block(len(a))
        return self.pad_block(a[lo:hi], block, fill)

    def pad_block(self, part, block, fill):
        """``part`` (this rank's rows, numpy or tensor) as a tensor on the
        mesh's device, padded with ``fill`` to ``block`` rows."""
        if not isinstance(part, torch.Tensor):
            part = torch.as_tensor(np.ascontiguousarray(part))
        part = part.to(self.device)
        n = part.shape[0]
        if n < block:
            pad = torch.full((block - n,) + tuple(part.shape[1:]), fill,
                             dtype=part.dtype, device=self.device)
            part = torch.cat([part, pad])
        return part.contiguous()

    def bank_shard(self, centers, center_bin, valid):
        """This rank's shard of a compact bank (valid centers first, in
        global-id order): the bank padded with invalid rows (bin -2) to
        ``ceil(K / model) * model`` and cut into ``model`` contiguous
        shards. Returns ``(centers, center_bin, valid, offset)``: the
        shard's first global id is ``offset``."""
        M = self.shape["model"]
        K = centers.shape[0]
        shard = max(-(-K // M), 1)
        lo = min(self.coords[1] * shard, K)
        hi = min(lo + shard, K)
        out = []
        for t, fill in ((centers, 0.0), (center_bin, -2), (valid, False)):
            part = t[lo:hi].to(self.device)
            if hi - lo < shard:
                pad = torch.full((shard - (hi - lo),) + tuple(t.shape[1:]), fill,
                                 dtype=t.dtype, device=self.device)
                part = torch.cat([part, pad])
            out.append(part.contiguous())
        return (*out, self.coords[1] * shard)

    # ------------------------------------------------------- collectives
    def _stage(self, t):
        """The tensor a collective takes on this backend: CUDA tensors go
        through the host on gloo."""
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce(self, t, op, axis):
        """``op`` ("sum", "min", "max") of ``t`` over ``axis`` ("data",
        "model" or "world"); returns the reduced tensor (``t`` itself
        without process groups)."""
        if not self.distributed:
            return t
        work = self._stage(t.contiguous())
        dist.all_reduce(work, op=_OPS[op], group=self.groups[axis])
        return work.to(t.device)

    def all_gather(self, t, axis):
        """Every rank's ``t`` along ``axis`` ("data" or "model"), stacked:
        ``(axis size, *shape)`` (``t[None]`` without process groups)."""
        if not self.distributed:
            return t[None]
        work = self._stage(t.contiguous())
        parts = [torch.empty_like(work) for _ in range(self.shape[axis])]
        dist.all_gather(parts, work, group=self.groups[axis])
        return torch.stack(parts).to(t.device)

    def gather_rows(self, block, n):
        """The ``n`` global rows from every data rank's (padded) block."""
        if not self.distributed and self.shape["data"] == 1:
            return block[:n]
        full = self.all_gather(block, "data")
        return full.reshape((-1,) + tuple(block.shape[1:]))[:n]

    def check_same(self, digest, what):
        """Raise unless every rank holds the same 64-bit ``digest`` (an
        all-reduce MIN and MAX over the world)."""
        if not self.distributed:
            return
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        v = torch.tensor([digest], dtype=torch.int64, device=dev)
        lo = self.all_reduce(v.clone(), "min", "world")
        hi = self.all_reduce(v.clone(), "max", "world")
        if int(lo) != int(hi):
            raise RuntimeError(f"the ranks hold different {what}")

    def barrier(self):
        if self.distributed:
            dist.barrier(group=self.groups["world"])


def make_mesh(model_parallel=None, device=None):
    """The ('data', 'model') mesh of the default process group's ranks.

    Without an initialized group: the (1, 1) mesh on ``device`` (default
    the card), which issues no collective. With one: ``best_mesh_shape``
    of the world size (or ``model_parallel``), this rank at
    ``(rank // model, rank % model)``, and one group per axis line. Every
    rank must call this, in the same order as its other group
    constructions. On NCCL a card without an index is this rank's,
    ``cuda:{LOCAL_RANK}`` (one card a rank); ranks of a gloo group may
    share one card.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh.single("cuda" if device is None else device)
    backend = str(dist.get_backend()).lower()
    world, rank = dist.get_world_size(), dist.get_rank()
    D, M = best_mesh_shape(world, model_parallel)
    dev = as_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and backend == "nccl":
        # One card a rank: this rank's card on its host
        dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current card
    # The axis groups come from dist.new_group, not init_device_mesh: that
    # sets each rank's CUDA device from its local rank, while the gloo ranks
    # that share one card must all stay on it. new_group is collective:
    # every rank creates every group, in the same order.
    data_groups = [dist.new_group([d * M + m for d in range(D)]) for m in range(M)]
    model_groups = [dist.new_group([d * M + m for m in range(M)]) for d in range(D)]
    d, m = divmod(rank, M)
    groups = {"data": data_groups[m], "model": model_groups[d],
              "world": dist.group.WORLD}
    return Mesh({"data": D, "model": M}, (d, m), groups, dev, backend)


def bank_digest(*arrays):
    """A 63-bit digest of host arrays' bytes (the bank check after a fit)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1

