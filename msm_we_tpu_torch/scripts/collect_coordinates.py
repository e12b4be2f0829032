"""Post-hoc coordinate augmentation: write ``auxdata/<auxpath>`` into west.h5.

Counterpart of ``msm_we_tpu/scripts/collect_coordinates.py`` (the working
replacement for the reference's ``collectCoordinates.py`` example). Reads
each segment's parent/child trajectory files with mdtraj and writes the
``(n_segs, 2, n_atoms, 3)`` coordinate pairs the haMSM pipeline consumes.
h5py and mdtraj are imported when the function runs, not with the module.
"""
from __future__ import annotations

import os

import numpy as np

from .._logging import log

__all__ = ["augment_west_h5"]


def augment_west_h5(
    west_h5_path,
    topology_path,
    seg_dir_format="traj_segs/{iteration:06d}/{seg_id:06d}",
    parent_filename="parent.rst7",
    child_filename="seg.rst7",
    auxpath="coord",
    overwrite=False,
):
    """Augment every complete iteration of ``west_h5_path`` with coordinates.

    Parameters
    ----------
    seg_dir_format: format string with ``iteration`` and ``seg_id`` fields
        locating each segment's trajectory directory (relative to the west.h5
        file's directory).
    parent_filename / child_filename: trajectory file names inside each
        segment directory (any mdtraj-loadable format).
    auxpath: dataset name under ``auxdata/``.
    overwrite: replace an existing auxdata dataset.

    A segment whose files are missing keeps NaN coordinates (weight 0
    downstream). Returns the number of iterations augmented.
    """
    import h5py
    import mdtraj as md

    topology = md.load(topology_path).topology
    base_dir = os.path.dirname(os.path.abspath(west_h5_path))

    n_augmented = 0
    with h5py.File(west_h5_path, "a") as h5:
        iterations = sorted(h5["iterations"].keys())
        # The last iteration is incomplete (no dynamics run)
        for iter_key in iterations[:-1]:
            n_iter = int(iter_key.split("_")[1])
            grp = h5[f"iterations/{iter_key}"]
            dset_name = f"auxdata/{auxpath}"
            if dset_name in grp:
                if not overwrite:
                    log.debug(f"{iter_key} already augmented, skipping")
                    continue
                del grp[dset_name]

            n_segs = grp["seg_index"].shape[0]
            coords = None
            for seg_id in range(n_segs):
                seg_dir = os.path.join(
                    base_dir, seg_dir_format.format(iteration=n_iter, seg_id=seg_id)
                )
                try:
                    parent_xyz = np.squeeze(md.load(
                        os.path.join(seg_dir, parent_filename), top=topology).xyz[-1])
                    child_xyz = np.squeeze(md.load(
                        os.path.join(seg_dir, child_filename), top=topology).xyz[-1])
                except OSError as e:
                    log.error(
                        f"Error collecting coordinates for iteration {n_iter} "
                        f"segment {seg_id}: {e}"
                    )
                    continue

                if coords is None:
                    coords = np.full(
                        (n_segs, 2) + parent_xyz.shape, np.nan, dtype=np.float32
                    )
                coords[seg_id, 0] = parent_xyz
                coords[seg_id, 1] = child_xyz

            if coords is not None:
                grp.create_dataset(dset_name, data=coords)
                n_augmented += 1
                log.debug(f"Augmented {iter_key} with {n_segs} segment pairs")

    log.info(f"Augmented {n_augmented} iterations in {west_h5_path}")
    return n_augmented
