"""Mesh parallelism over ``torch.distributed`` ranks: the sharded
discretize + flux step of a build, one process per device."""
from .mesh import Mesh, best_mesh_shape, make_mesh
from .sharded import (
    build_sharded_assign,
    build_sharded_cluster_stats,
    build_sharded_pair_assign,
    build_sharded_single_assign,
    build_sharded_step,
    fused_step_single,
    steady_state_from_flux,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "best_mesh_shape",
    "build_sharded_step",
    "build_sharded_pair_assign",
    "build_sharded_single_assign",
    "build_sharded_assign",
    "build_sharded_cluster_stats",
    "fused_step_single",
    "steady_state_from_flux",
]
