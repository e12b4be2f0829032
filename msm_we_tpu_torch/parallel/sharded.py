"""The haMSM step over a ('data', 'model') mesh of ``torch.distributed`` ranks.

Counterpart of ``msm_we_tpu/parallel/sharded.py``. Where the JAX package
runs one ``shard_map`` program over the chips of one process, here every
rank runs the same functions on its own part of the problem and the
results meet in collectives (``parallel/mesh.py``):

* rows (segments) are split over 'data': a rank passes its row block,
  padded with inert rows (bin -1, weight 0, masks False; ``Mesh.rows``);
  the partial flux is summed over 'data' in the dtype of the weights (f64
  on a build), and ids come back as the rank's block (``Mesh.gather_rows``
  collects them where a host consumer needs them);
* the compact center bank is split over 'model': the callables take the
  whole compact bank (every rank fits it whole) and score the rank's shard
  (``Mesh.bank_shard``). With model 1 a rank runs the one-card program of
  ``step.py`` on its block: one H3 launch for the flux, one H4 launch with
  the override epilogue for ids. With model > 1 it runs H4 with scores on
  its shard, combines the (score, global id) minima over 'model', then
  applies the overrides and scatters the flux.

The combine takes the smaller score and, on equal scores, the lower global
id: the kernels' own ``better()`` order (``csrc/assign_common.cuh``), so
the ids of any mesh equal the one-card ids bitwise. A row whose bin has no
valid center in any shard gets id 0, as on one card. With the (1, 1) mesh
and no process group every function is the one-card program, launch for
launch.

The builders keep the JAX names and return callables that take this rank's
row block and the whole compact bank. Left out: the packed-sparse flux
(``build_sharded_step_packed*``), which served the TPU's slow download
link, and the int16 narrowing of ``_stack_ids_replicated``.
"""
from __future__ import annotations

import torch

from ..ops.stratified_assign import pair_assign
from .. import step as _step
from ..step import (
    _apply_overrides,
    _scatter_flux,
    fused_step_single,
    steady_state_from_flux,
)

__all__ = [
    "build_sharded_step",
    "build_sharded_pair_assign",
    "build_sharded_single_assign",
    "build_sharded_assign",
    "build_sharded_cluster_stats",
    "fused_step_single",
    "steady_state_from_flux",
]

_NO_ID = torch.iinfo(torch.int32).max


def _local_masked_min(X, seg_bin, C, center_bin, valid):
    """Nearest valid same-bin center within the rank's bank shard: H4 with
    its score output. Returns ``(min_score, local_id)``; the score is
    ``+inf`` where the shard holds no valid center of the row's bin."""
    idx, score = pair_assign(None, X, None, seg_bin, C, center_bin, valid,
                             return_scores=True)
    return score, idx


def _combine_argmin(local_min, local_gid, mesh):
    """Global (score, id) minimum over the 'model' axis: the smaller score
    wins, equal scores go to the lower global id; id 0 where no shard has
    a candidate (every score ``+inf``)."""
    mins = mesh.all_gather(local_min, "model")
    gids = mesh.all_gather(local_gid.to(torch.int32), "model")
    best = mins.min(0).values
    cand = torch.where(mins == best[None], gids, torch.full_like(gids, _NO_ID))
    gid = cand.min(0).values
    return torch.where(best == float("inf"), torch.zeros_like(gid), gid)


def _raw_pair_assign(mesh, fp, fc, pbins, cbins, centers, center_bin, valid,
                     offset=0):
    """Global nearest-center ids of the parent and child rows of the
    rank's block, no overrides; ``centers``.. is the rank's shard, whose
    first global id is ``offset``."""
    if mesh.shape["model"] == 1:
        return _step._raw_pair_assign(fp, fc, pbins, cbins, centers,
                                      center_bin, valid)
    pk, ck, pmin, cmin = pair_assign(fp, fc, pbins, cbins, centers, center_bin,
                                     valid, return_scores=True)
    n = fc.shape[0]
    both = _combine_argmin(torch.cat([pmin, cmin]),
                           torch.cat([pk, ck]) + offset, mesh)
    return both[:n], both[n:]


def _assign_overridden(mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c,
                       centers, center_bin, valid, n_states, offset=0,
                       target_p=None, predict_order=False):
    """Ids of the rank's parent and child rows with the basis/target
    overrides (``predict_order``: target wins, the dtrajs; else basis wins,
    the flux). With model 1 the overrides are H4's epilogue."""
    if mesh.shape["model"] == 1:
        return _step._assign_overridden(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, centers,
            center_bin, valid, n_states, target_p=target_p,
            predict_order=predict_order,
        )
    pidx, cidx = _raw_pair_assign(mesh, fp, fc, pbins, cbins, centers,
                                  center_bin, valid, offset)
    return _apply_overrides(pidx, cidx, basis_p, basis_c, target_c, n_states,
                            target_p=target_p, predict_order=predict_order)


def _discretize_and_flux(mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c,
                         w, centers, center_bin, valid, n_states, offset=0,
                         target_p=None):
    """Flux-order ids of the rank's block and the (S, S) flux of ``w``
    summed over 'data' (in the dtype of ``w``), replicated on every rank.
    With model 1: one H3 launch on the block. Returns ``(fm, pidx, cidx)``."""
    if mesh.shape["model"] == 1:
        fm, pidx, cidx = _step._discretize_and_flux(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, centers,
            center_bin, valid, n_states, target_p=target_p,
        )
    else:
        pidx, cidx = _assign_overridden(
            mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c, centers,
            center_bin, valid, n_states, offset, target_p=target_p,
        )
        fm = _scatter_flux(pidx, cidx, w, n_states)
    return mesh.all_reduce(fm, "sum", "data"), pidx, cidx


def _single_assign(mesh, fc, cbins, basis_c, target_c, centers, center_bin,
                   valid, n_states):
    """Predict-order ids of one row set (the rank's block)."""
    if mesh.shape["model"] == 1:
        return _step.single_assign_predict(fc, cbins, basis_c, target_c, centers,
                                           center_bin, valid, n_states)
    *shard, offset = mesh.bank_shard(centers, center_bin, valid)
    local_min, local_k = _local_masked_min(fc, cbins, *shard)
    cidx = _combine_argmin(local_min, local_k + offset, mesh)
    cidx = torch.where(basis_c, n_states - 2, cidx) if basis_c is not None else cidx
    cidx = torch.where(target_c, n_states - 1, cidx) if target_c is not None else cidx
    return cidx.to(torch.int32)


def build_sharded_step(mesh, n_states, with_target_p=False):
    """The (data, model)-sharded discretize + flux step over ``mesh``.

    The callable takes this rank's row block (parent/child features (n, F);
    parent/child WE bins, basis/target masks, weights (n,); with
    ``with_target_p`` the parent-in-target mask last) and the whole compact
    bank ``(centers, center_bin, valid)``, and returns the (n_states,
    n_states) flux summed over 'data', replicated. f64 weights give the f64
    flux of a build."""

    def step(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, centers,
             center_bin, valid, *rest):
        *shard, offset = mesh.bank_shard(centers, center_bin, valid)
        fm, _pidx, _cidx = _discretize_and_flux(
            mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, *shard,
            n_states, offset, target_p=rest[0] if with_target_p else None,
        )
        return fm

    return step


def build_sharded_pair_assign(mesh, n_states, with_target_p=False):
    """Parent and child ids with the predict-order overrides (target wins:
    the dtrajs), same inputs as :func:`build_sharded_step` minus the
    weights. Returns this rank's ``(pidx, cidx)`` int32 blocks."""

    def assign(fp, fc, pbins, cbins, basis_p, basis_c, target_c, centers,
               center_bin, valid, *rest):
        *shard, offset = mesh.bank_shard(centers, center_bin, valid)
        return _assign_overridden(
            mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c, *shard,
            n_states, offset, target_p=rest[0] if with_target_p else None,
            predict_order=True,
        )

    return assign


def build_sharded_single_assign(mesh, n_states):
    """Child-only :func:`build_sharded_pair_assign` (the dedup
    discretization): ``(fc, cbins, basis_c, target_c, centers, center_bin,
    valid)`` -> this rank's predict-order ids."""

    def assign(fc, cbins, basis_c, target_c, centers, center_bin, valid):
        return _single_assign(mesh, fc, cbins, basis_c, target_c, centers,
                              center_bin, valid, n_states)

    return assign


def build_sharded_assign(mesh):
    """Stratified assignment without overrides: ``(X, seg_bin, centers,
    center_bin, valid)`` -> this rank's global cluster ids (compact bank)."""

    def assign(X, seg_bin, centers, center_bin, valid):
        if mesh.shape["model"] == 1:
            return pair_assign(None, X, None, seg_bin, centers, center_bin, valid)
        *shard, offset = mesh.bank_shard(centers, center_bin, valid)
        local_min, local_k = _local_masked_min(X, seg_bin, *shard)
        return _combine_argmin(local_min, local_k + offset, mesh)

    return assign


def build_sharded_cluster_stats(mesh, k_max):
    """Per-cluster child-pcoord count, sum, min and max over the mesh:
    ``step.cluster_stats`` on the rank's block of ids ``cid`` and pcoords
    ``p1`` (pad ``p1`` with NaN: NaN rows are excluded), then SUM of counts
    and sums, MIN of ``vmin`` and MAX of ``vmax`` over 'data'. Returns the
    replicated ``(counts, sums, vmin, vmax)``, each ``(k_max + 1, ndim)``."""

    def stats(cid, p1, n_live):
        counts, sums, vmin, vmax = _step.cluster_stats(cid, p1, n_live, k_max)
        return (mesh.all_reduce(counts, "sum", "data"),
                mesh.all_reduce(sums, "sum", "data"),
                mesh.all_reduce(vmin, "min", "data"),
                mesh.all_reduce(vmax, "max", "data"))

    return stats
