"""Coordinate-augmentation plugins: populate ``auxdata/coord`` after each
WE iteration.

Counterpart of ``msm_we_tpu/westpa_plugins/augmentation_driver.py``
(reference ``westpa_plugins/augmentation_driver.py``: H5AugmentationDriver
:8, MDAugmentationDriver :70). Host code only: westpa, h5py and mdtraj are
imported inside the drivers.
"""
from __future__ import annotations

import os

import numpy as np

from .._logging import log


def _final_frame(traj_xyz):
    """(n_atoms, 3) final frame of an mdtraj ``xyz`` array.

    Multi-frame trajectory files contribute their last saved frame. (The
    reference ``np.squeeze``s instead, which silently writes a mis-shaped
    5-D ``auxdata/coord`` for multi-frame files -- breaking the documented
    ``(n_walkers, 2, n_atoms, 3)`` contract and every downstream reader.)
    """
    xyz = np.asarray(traj_xyz)
    assert xyz.ndim == 3, f"expected (n_frames, n_atoms, 3), got {xyz.shape}"
    return xyz[-1]


class H5AugmentationDriver:
    """HDF5-framework augmentation: after each iteration, soft-link
    ``iter_XXX/auxdata/coord`` to the per-iteration trajectory dataset.

    west.cfg usage::

        west:
          plugins:
            - plugin: msm_we_tpu_torch.westpa_plugins.augmentation_driver.H5AugmentationDriver
    """

    def __init__(self, sim_manager, plugin_config):
        import westpa

        westpa.rc.pstatus("Initializing coordinate augmentation plugin")
        if not sim_manager.work_manager.is_master:
            westpa.rc.pstatus("Not running on the master process, skipping")
            return

        self.data_manager = sim_manager.data_manager
        self.sim_manager = sim_manager
        self.plugin_config = plugin_config
        self.priority = plugin_config.get("priority", 1)

        sim_manager.register_callback(
            sim_manager.post_propagation, self.augment_coordinates, self.priority
        )
        assert self.data_manager.store_h5, (
            "H5 framework not enabled! Can't use the H5 framework augmentation driver."
        )

    def augment_coordinates(self):
        import h5py
        import westpa

        westpa.rc.pstatus("Performing augmentation")
        iter_group_name = self.data_manager.get_iter_group(self.sim_manager.n_iter).name
        auxcoord_dataset = f"{iter_group_name}/auxdata/coord"
        self.data_manager.we_h5file[auxcoord_dataset] = h5py.SoftLink(
            path=f"{iter_group_name}/trajectories/sorted_segment_trajectories"
        )


class MDAugmentationDriver:
    """File-based augmentation: load parent/child segment trajectory files
    with mdtraj and write ``(n_walkers, 2, n_atoms, 3)`` coordinate pairs.

    west.cfg usage::

        west:
          plugins:
            - plugin: msm_we_tpu_torch.westpa_plugins.augmentation_driver.MDAugmentationDriver
              topology_file: path/to/topology.pdb
              child_traj_filename: seg.trr
              parent_traj_filename: parent.trr
    """

    def __init__(self, sim_manager, plugin_config):
        import mdtraj as md
        import westpa

        westpa.rc.pstatus("Initializing coordinate augmentation plugin")
        if not sim_manager.work_manager.is_master:
            westpa.rc.pstatus("Not running on the master process, skipping")
            return

        self.data_manager = sim_manager.data_manager
        self.sim_manager = sim_manager
        self.plugin_config = plugin_config
        self.topology_file = plugin_config["topology_file"]
        self.topology = md.load(self.topology_file).topology
        self.parent_traj_filename = plugin_config["parent_traj_filename"]
        self.child_traj_filename = plugin_config["child_traj_filename"]
        self.priority = plugin_config.get("priority", 1)

        sim_manager.register_callback(
            sim_manager.post_propagation, self.augment_coordinates, self.priority
        )

    def augment_coordinates(self):
        """Write each segment's (parent end, child end) coordinate pair into
        ``auxdata/coord``; run-start parents fall back to their basis-state
        structure (reference ``augmentation_driver.py:111-181``)."""
        import mdtraj as md
        import westpa

        westpa.rc.pstatus("Performing augmentation")
        iter_group_name = self.data_manager.get_iter_group(self.sim_manager.n_iter).name
        segments = self.data_manager.get_segments(
            n_iter=self.sim_manager.n_iter, load_pcoords=True
        )
        n_walkers = len(segments)
        data_ref_formatter = os.path.expandvars(
            westpa.rc.config["west"]["data"]["data_refs"]["segment"]
        )

        for segment in segments:
            seg_path = data_ref_formatter.format(segment=segment)
            parent_traj_path = f"{seg_path}/{self.parent_traj_filename}"
            child_traj_path = f"{seg_path}/{self.child_traj_filename}"

            if os.path.exists(parent_traj_path):
                parent_coords = _final_frame(
                    md.load(parent_traj_path, top=self.topology).xyz
                )
            else:
                # Parent was an initial/basis state, not a segment
                try:
                    segment_istate = self.data_manager.get_segment_initial_states(
                        [segment]
                    )[0]
                except IndexError:
                    log.debug(
                        "No initial state for segment; assuming augmentation "
                        "was already performed (continuation run)."
                    )
                    continue
                bstate_id = segment_istate.basis_state_id
                segment_bstate = self.data_manager.get_basis_states(
                    self.sim_manager.n_iter
                )[bstate_id]
                parent_coords = _final_frame(
                    md.load(segment_bstate.auxref, top=self.topology).xyz
                )

            child_coords = _final_frame(
                md.load(child_traj_path, top=self.topology).xyz
            )

            auxcoord_dataset = self.data_manager.we_h5file.require_dataset(
                name=f"{iter_group_name}/auxdata/coord",
                shape=(n_walkers, 2, *child_coords.shape),
                dtype=child_coords.dtype,
            )
            auxcoord_dataset[segment.seg_id, 0] = parent_coords
            auxcoord_dataset[segment.seg_id, 1] = child_coords
