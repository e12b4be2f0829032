"""Automated steady-state restart ("marathon") plugin.

Counterpart of ``msm_we_tpu/westpa_plugins/restart_driver.py`` (reference
``westpa_plugins/restart_driver.py``, RestartDriver :104): manage N runs x M
restarts through a ``restart.dat`` JSON state file,
move each run's data into ``restart<R>/run<N>/``, build an haMSM over the
last-N restarts' h5 files, write per-cluster start-states weighted by
Aristoff-Zuckerman Algorithm 5.3, crush basis-state probabilities, cache
pcoords for w_init, produce diagnostic plots, and relaunch WE.

All bookkeeping that doesn't touch a live WESTPA process is in module-level
functions, testable without WESTPA. h5py, mdtraj, matplotlib and westpa are
imported inside the functions that need them. The haMSM is built on the
config's ``device`` (default ``"cuda"``); ``hamsm.obj`` holds CPU state and
reads back with ``modelWE.load(path, device=...)``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil

import numpy as np

from .._logging import log
from .hamsm_driver import HAMSMDriver, _resolve_callable

EXTENSION_LOCKFILE = "doing_extension"

# WESTPA's Segment.SEG_ENDPOINT_RECYCLED
SEG_ENDPOINT_RECYCLED = 3


# --------------------------------------------------------------- pure helpers


def check_target_reached(h5_filename):
    """True if any segment in the file was recycled (reached the target).

    Scans ``seg_index['endpoint_type']`` backwards from the second-to-last
    iteration (the last is incomplete). Reference ``restart_driver.py:52-73``,
    except the scan includes the FIRST iteration: the reference's
    ``[-2:0:-1]`` slice stops before index 0, so a run whose only recycling
    events happen in iteration 1 is misreported as never reaching the target
    (and a 2-iteration file is never scanned at all).
    """
    import h5py

    with h5py.File(h5_filename, "r") as h5_file:
        for iteration_key in list(h5_file["iterations"].keys())[-2::-1]:
            endpoint_types = h5_file[f"iterations/{iteration_key}/seg_index"][
                "endpoint_type"
            ]
            if SEG_ENDPOINT_RECYCLED in endpoint_types:
                log.debug(
                    f"recycled segment found in {h5_filename} at {iteration_key}"
                )
                return True
    return False


def fix_deprecated_initialization(initialization_state):
    """Migrate old hyphenated w_init JSON keys to underscores.

    Reference ``restart_driver.py:76-101``.
    """
    for old_key, new_key in [
        ("tstate-file", "tstate_file"),
        ("bstate-file", "bstate_file"),
        ("sstate-file", "sstate_file"),
        ("segs-per-state", "segs_per_state"),
    ]:
        if old_key in initialization_state:
            log.warning(
                f"Initialization JSON uses deprecated hyphenated key {old_key}; "
                "replace with underscores."
            )
            initialization_state[new_key] = initialization_state.pop(old_key)
    return initialization_state


def load_restart_state(restart_file):
    """Read restart.dat, or the initial state if it doesn't exist."""
    state = {"restarts_completed": 0, "runs_completed": 0}
    if os.path.exists(restart_file):
        with open(restart_file, "r") as fp:
            state = json.load(fp)
    return state


def save_restart_state(restart_file, state):
    with open(restart_file, "w") as fp:
        json.dump(state, fp)


def marathon_west_files(restart_state, n_runs=None, restarts_to_use=-1, base_path="."):
    """The west.h5 paths to build the haMSM from at this restart.

    ``restarts_to_use``: -1 = all restarts so far; an integer >= 1 = the last
    N restarts; a fraction in (0, 1) = that fraction of restarts (at least 1).
    ``n_runs`` is accepted for call compatibility but unused -- the run count
    comes from ``restart_state["runs_completed"]``.
    Reference ``restart_driver.py:779-818``.
    """
    completed = restart_state["restarts_completed"]
    if restarts_to_use == -1:
        last_N = 1 + completed
    elif restarts_to_use >= 1:
        last_N = int(restarts_to_use)
    elif 0 < restarts_to_use < 1:
        # At least one restart's files (a fraction rounding to 0 must not
        # silently expand to the whole marathon history)
        last_N = max(int(restarts_to_use * (1 + completed)), 1)
    else:
        raise ValueError(f"Invalid restarts_to_use: {restarts_to_use}")

    first_restart = max(1 + completed - last_N, 0)
    files = []
    for restart_number in range(first_restart, 1 + completed):
        for run_number in range(1, 1 + restart_state["runs_completed"]):
            files.append(
                f"{base_path}/restart{restart_number}/run{run_number}/west.h5"
            )
    return files


def start_state_entries(model, ss_dist):
    """Yield (msm_bin_idx, struct_idx, structure_weight, structure) for every
    start-state candidate.

    Weights follow Aristoff & Zuckerman, "Optimizing Weighted Ensemble
    Sampling of Steady States", Alg 5.3: ``seg_weight * (bin_prob /
    bin_total_WE_weight)``. Basis/target pseudo-clusters and zero-probability
    bins are skipped. Reference ``restart_driver.py:948-1005``.

    ``model.cluster_structures`` is keyed by *raw* global cluster ids (the
    dtraj numbering) while ``ss_dist`` lives in the pcoord-sorted fluxMatrix
    numbering, so the probability lookup maps through the recorded sort
    permutation. (The reference indexes raw ids into the sorted pSS
    directly -- silently wrong start-state weights whenever the sort is a
    non-identity permutation; fixed here.)
    """
    sort_idx = getattr(model, "pcoord_sort_indices", None)
    inv = None
    if sort_idx is not None:
        inv = np.empty(len(sort_idx), dtype=np.int64)
        inv[np.asarray(sort_idx)] = np.arange(len(sort_idx))
    for msm_bin_idx, structures in model.cluster_structures.items():
        if msm_bin_idx in [model.n_clusters, model.n_clusters + 1]:
            continue
        bin_prob = ss_dist[inv[msm_bin_idx] if inv is not None else msm_bin_idx]
        if bin_prob == 0:
            log.info(
                f"MSM-Bin {msm_bin_idx} has probability 0, so not saving any "
                "structs from it."
            )
            continue
        msm_bin_we_weight = sum(model.cluster_structure_weights[msm_bin_idx])
        for struct_idx, structure in enumerate(structures):
            seg_we_weight = model.cluster_structure_weights[msm_bin_idx][struct_idx]
            structure_weight = seg_we_weight * (bin_prob / msm_bin_we_weight)
            yield msm_bin_idx, struct_idx, structure_weight, structure


def build_reverse_coord_map(full_coord_map):
    """Hash full-coordinate structures back to discrete state ids (SynD).

    Reference ``restart_driver.py:988-992``.
    """
    reverse = {}
    for state_id, structure in full_coord_map.items():
        _hash = hashlib.md5(np.asarray(structure, np.float32)).hexdigest()
        reverse[_hash] = state_id
    return reverse


def write_restart_artifacts(
    model,
    restart_directory,
    store_h5=True,
    struct_filetype=None,
    synd_reverse_coord_map=None,
):
    """Write JtargetSS.txt, pSS.txt, startstates.txt, and the pickled model.

    Start-state structure references: SynD state ids when a reverse coord map
    is given; ``hdf:file:iter:seg`` references when the HDF5 framework is in
    use; otherwise PDB/rst7 files written under ``structs/``.
    Returns the startstates.txt path. Reference ``restart_driver.py:894-1143``.
    """
    os.makedirs(restart_directory, exist_ok=True)
    struct_directory = f"{restart_directory}/structs"
    os.makedirs(struct_directory, exist_ok=True)

    with open(f"{restart_directory}/JtargetSS.txt", "w") as fp:
        fp.write(str(model.JtargetSS))
    with open(f"{restart_directory}/pSS.txt", "w") as fp:
        np.savetxt(fp, model.pSS)

    ss_dist = model.pSS
    sstates_filename = f"{restart_directory}/startstates.txt"
    resolved_filetype = None  # resolved once, lazily: the default needs mdtraj
    with open(sstates_filename, "w") as fp:
        for msm_bin_idx, struct_idx, weight, structure in start_state_entries(
            model, ss_dist
        ):
            if synd_reverse_coord_map is not None:
                _hash = hashlib.md5(np.asarray(structure, np.float32)).hexdigest()
                structure_filename = f"{synd_reverse_coord_map[_hash]}"
            elif store_h5:
                iteration, seg_id, h5_file = model.structure_iteration_segments[
                    msm_bin_idx
                ][struct_idx]
                structure_filename = f"hdf:{h5_file}:{iteration}:{seg_id}"
            else:
                if resolved_filetype is None:
                    resolved_filetype = _resolve_callable(struct_filetype)
                structure_filename = _write_structure_file(
                    model, structure, struct_directory, msm_bin_idx, struct_idx,
                    resolved_filetype,
                )
            fp.write(f"b{msm_bin_idx}_s{struct_idx} {weight} {structure_filename}\n")

    with open(f"{restart_directory}/hamsm.obj", "wb") as objFileHandler:
        log.debug("Pickling model")
        pickle.dump(model, objFileHandler, protocol=4)

    return sstates_filename


def _write_structure_file(
    model, structure, struct_directory, msm_bin_idx, struct_idx, struct_filetype
):
    """Write one start-state structure to disk (PDB or Amber rst7)."""
    import mdtraj as md

    if struct_filetype is None:
        struct_filetype = md.formats.PDBTrajectoryFile
    extensions = {
        md.formats.PDBTrajectoryFile: "pdb",
        md.formats.AmberRestartFile: "rst7",
    }

    topology = model.reference_structure.topology
    try:
        angles = model.reference_structure.unitcell_angles[0]
        lengths = model.reference_structure.unitcell_lengths[0] * 10
    except (TypeError, AttributeError):
        angles, lengths = None, None

    coords = np.asarray(structure) * 10  # nm -> Angstrom
    structure_filename = (
        f"{struct_directory}/bin{msm_bin_idx}_struct{struct_idx}."
        f"{extensions[struct_filetype]}"
    )
    with struct_filetype(structure_filename, "w") as struct_file:
        if struct_filetype is md.formats.PDBTrajectoryFile:
            struct_file.write(
                coords, topology, modelIndex=1,
                unitcell_angles=angles, unitcell_lengths=lengths,
            )
        elif struct_filetype is md.formats.AmberRestartFile:
            struct_file.write(
                coords, time=None, cell_angles=angles, cell_lengths=lengths
            )
        else:
            log.warning(
                f"Filetype {struct_filetype} not explicitly handled; attempting "
                "(coords, topology) write."
            )
            struct_file.write(coords, topology)
    return structure_filename


def write_basis_target_states(
    restart_directory, original_bstates, original_tstates, crush_factor=1e-10
):
    """Write basisstates.txt (probabilities crushed so start-states dominate
    initialization) and targetstates.txt. Returns their paths.
    Reference ``restart_driver.py:1104-1136``.
    """
    bstates_filename = f"{restart_directory}/basisstates.txt"
    with open(bstates_filename, "w") as fp:
        for bstate in original_bstates:
            fp.write(
                f"{bstate.label} {bstate.probability * crush_factor} "
                f"{bstate.auxref}\n"
            )

    tstates_filename = f"{restart_directory}/targetstates.txt"
    with open(tstates_filename, "w") as fp:
        for tstate in original_tstates:
            fp.write(f"{tstate.label} {tstate.pcoord[0]}\n")
    return bstates_filename, tstates_filename


# --------------------------------------------------------------------- driver


class RestartDriver(HAMSMDriver):
    """WESTPA plugin: estimate steady state, re-initialize WE there, relaunch.

    west.cfg usage (reference schema, ``restart_driver.py:120-143``)::

        west:
          plugins:
            - plugin: msm_we_tpu_torch.westpa_plugins.restart_driver.RestartDriver
              n_restarts: total restarts
              n_runs: runs per marathon
              extension_iters: iterations to extend by if no target flux yet
              n_restarts_to_use: how many past restarts feed the haMSM
              initialization_file: restart_initialization.json
              # ... plus all HAMSMDriver config keys
    """

    def __init__(self, sim_manager, plugin_config):
        import westpa

        super().__init__(sim_manager, plugin_config)
        # Non-master workers return from the parent __init__ before it sets
        # any attributes; nothing to unregister (or configure) on them
        if not sim_manager.work_manager.is_master:
            return
        # The parent registered construct_hamsm at its configured priority;
        # this plugin drives construction itself at the end of the state
        # machine
        self.sim_manager._callback_table[sim_manager.finalize_run].discard(
            (self.priority, "construct_hamsm", super().construct_hamsm)
        )

        westpa.rc.pstatus("Restart plugin initialized")

        self.restart_file = plugin_config.get("restart_file", "restart.dat")
        self.initialization_file = plugin_config.get(
            "initialization_file", "restart_initialization.json"
        )
        self.extension_iters = plugin_config.get("extension_iters", 0)
        self.max_total_iterations = westpa.rc.config.get(
            ["west", "propagation", "max_total_iterations"], default=None
        )
        self.base_total_iterations = self.max_total_iterations

        self.n_restarts = plugin_config.get("n_restarts", -1)
        self.n_runs = plugin_config.get("n_runs", 1)
        self.cache_pcoords = plugin_config.get("cache_pcoords", True)
        self.restarts_to_use = plugin_config.get("n_restarts_to_use", self.n_restarts)

        # Resolved lazily: only needed when start-state structures are
        # written to disk (not for hdf:/SynD references), and the default
        # requires mdtraj
        self._struct_filetype_spec = plugin_config.get(
            "struct_filetype", "mdtraj.formats.PDBTrajectoryFile"
        )

        # Runs LAST: it closes the h5 file and starts a new WE run
        self.priority = plugin_config.get("priority", 100)
        sim_manager.register_callback(
            sim_manager.finalize_run, self.prepare_new_we, self.priority
        )

        self.synd_full_coord_map_path = plugin_config.get(
            "synd_full_coord_map_path", None
        )
        self.synd_full_coord_map = None
        if self.synd_full_coord_map_path is not None:
            with open(self.synd_full_coord_map_path, "rb") as infile:
                self.synd_full_coord_map = pickle.load(infile)

        self.pcoord_cache = None
        self.model = None
        self.base_path = plugin_config.get("base_path", os.getcwd())

    @property
    def struct_filetype(self):
        return _resolve_callable(self._struct_filetype_spec)

    @property
    def cur_iter(self):
        return self.sim_manager.n_iter - 1

    @property
    def is_last_iteration(self):
        return self.cur_iter >= self.sim_manager.max_total_iterations

    def get_original_bins(self):
        """WE bins and their probabilities at the end of the previous
        iteration (reference ``restart_driver.py:248-268``).

        Returns ``(bins, binprobs)``: the WE driver's next-iteration binning
        and each bin's total weight.
        """
        bins = self.sim_manager.we_driver.next_iter_binning
        binprobs = np.fromiter(
            (b.weight for b in bins), dtype=np.float64, count=len(bins)
        )
        return bins, binprobs

    # -- WE lifecycle pieces -------------------------------------------------

    def init_we(self, initialization_state, pcoord_cache):
        """w_init with cached pcoords monkey-patched into the propagator for
        start-states (labels ``bX_sY``). Reference ``restart_driver.py:494-554``.
        """
        import re

        import westpa
        from westpa.cli.core import w_init

        original_get_pcoord = None
        if pcoord_cache is not None:
            log.info("Enabling pcoord cache for new WE run initialization")
            propagator = westpa.rc.propagator
            original_get_pcoord = propagator.get_pcoord
            template = re.compile(r"^b(\d+)_s(\d+)$")

            def get_cached_pcoord(state):
                is_start_state = template.match(state.label)
                if is_start_state:
                    cluster_idx, cluster_seg_idx = re.findall(r"\d+", state.label)
                    state.pcoord = pcoord_cache[int(cluster_idx)][int(cluster_seg_idx)]
                else:
                    original_get_pcoord(state)

            propagator.get_pcoord = get_cached_pcoord

        try:
            w_init.initialize(**initialization_state, shotgun=False)
        finally:
            # Always restore: a failed w_init must not leave the cache patch
            # installed for later (unrelated) get_pcoord calls
            if pcoord_cache is not None:
                propagator.get_pcoord = original_get_pcoord

    def prepare_extension_run(self, run_number, restart_state, first_extension=False):
        """Re-link a previous run's data and continue it for more iterations.

        Reference ``restart_driver.py:295-383``.
        """
        import westpa
        from westpa.cli.core import w_run

        log.debug(f"Linking run files from restart0/run{run_number}")
        # Each path may be a directory, a symlink (from a previous
        # extension), or absent; handle them independently so one path's
        # state can't mask another's error
        for p in ("traj_segs", "seg_logs"):
            if os.path.islink(p):
                os.unlink(p)
            elif os.path.isdir(p):
                shutil.rmtree(p)

        if os.path.exists(self.data_manager.we_h5filename):
            os.remove(self.data_manager.we_h5filename)
        os.symlink(f"restart0/run{run_number}/traj_segs", "traj_segs")
        os.symlink(f"restart0/run{run_number}/seg_logs", "seg_logs")

        if first_extension:
            # Extend max_total_iterations in west.cfg
            with open("west.cfg", "r") as west_config:
                lines = west_config.readlines()
            for i, line in enumerate(lines):
                if "max_total_iterations" in line:
                    max_iters = [
                        int(tok)
                        for tok in line.replace(":", " ").replace("\n", " ").split()
                        if tok.isdigit()
                    ]
                    new_max_iters = max_iters[0] + self.extension_iters
                    lines[i] = f"{line.split(':')[0]}: {new_max_iters}\n"
                    break
            with open("west.cfg", "w") as west_config:
                west_config.writelines(lines)

        save_restart_state(self.restart_file, restart_state)
        log.info("First WE extension run ready!")

        westpa.rc.sim_manager.segments = None
        shutil.copy(
            f"restart0/run{run_number}/west.h5", self.data_manager.we_h5filename
        )
        self.data_manager.open_backing()
        if run_number == 1:
            westpa.rc.sim_manager.max_total_iterations += self.extension_iters
        w_run.run_simulation()

    def generate_plots(self, restart_directory):
        """Flux-profile, pseudocommittor, direct-vs-haMSM comparison, and
        coarse-profile diagnostic plots. Reference ``restart_driver.py:385-492``.
        """
        import h5py
        from matplotlib import pyplot as plt

        model = self.model
        log.info("Producing flux-profile, pseudocommittor, and comparison plots.")

        fig, ax = plt.subplots()
        model.plot_flux(ax=ax, suppress_validation=True)
        ax.legend(bbox_to_anchor=(1.01, 1.0), loc="upper left")
        fig.savefig(f"{restart_directory}/flux_plot.pdf", bbox_inches="tight")

        fig, ax = plt.subplots()
        model.plot_flux_committor(ax=ax, suppress_validation=True)
        ax.legend(bbox_to_anchor=(1.01, 1.0), loc="upper left")
        fig.savefig(
            f"{restart_directory}/pseudocomm-flux_plot.pdf", bbox_inches="tight"
        )

        # haMSM-vs-direct flux comparison
        fig, ax = plt.subplots(figsize=(7, 3))
        models = [model] + list(model.validation_models)
        flux_estimates = [m.JtargetSS for m in models]

        for _file in model.fileList:
            try:
                with h5py.File(_file, "r") as h5:
                    # Last usable iteration: its successor must also exist
                    present = sorted(
                        int(k.split("_")[1]) for k in h5["iterations"]
                    )
                    pset = set(present)
                    usable = [n for n in present if n + 1 in pset]
                    if not usable:
                        continue
                    last = usable[-1]
                    seg_index = h5[f"iterations/iter_{last:08d}/seg_index"][:]
                    recycled = seg_index["endpoint_type"] == SEG_ENDPOINT_RECYCLED
                    recycled_w = float(seg_index["weight"][recycled].sum())
                target_flux = recycled_w / model.tau
            except Exception as e:
                log.warning(f"Couldn't compute direct flux for {_file}: {e}")
                continue
            if target_flux == 0:
                continue
            short = f"....{_file[-12:]}" if len(_file) >= 15 else _file
            ax.axhline(
                target_flux, linestyle="--",
                label=f"Last iter WE direct {target_flux:.2e}\n  ({short})",
            )

        ax.axhline(
            flux_estimates[0], label=f"Main model estimate\n  {flux_estimates[0]:.2e}"
        )
        for i, J in enumerate(flux_estimates[1:]):
            ax.axhline(J, label=f"Validation model {i} estimate\n  {J:.2e}")
        ax.legend(bbox_to_anchor=(1.01, 0.9), loc="upper left")
        ax.set_yscale("log")
        ax.set_ylabel("Flux")
        ax.set_xticks([])
        fig.tight_layout()
        fig.savefig(
            f"{restart_directory}/hamsm_vs_direct_flux_comparison_plot.pdf",
            bbox_inches="tight",
        )

        fig, ax = model.plot_coarse_flux_profile()
        fig.savefig(
            f"{restart_directory}/coarse_flux_profile.pdf", bbox_inches="tight"
        )

    # -- the state machine ---------------------------------------------------

    def prepare_new_we(self):
        """The restart state machine. Reference ``restart_driver.py:556-1208``.

        1. Gate on the final iteration.  2. Advance restart.dat and archive
        this run's data.  3. Launch remaining runs of the marathon (fresh or
        extension).  4. Build the haMSM over the marathon's h5 files.
        5. Write start/basis/target states and diagnostics.  6. w_init in the
        estimated steady state and w_run.
        """
        import westpa
        from westpa.cli.core import w_run

        if not self.is_last_iteration:
            return

        log.debug("Final iteration, preparing restart")
        restart_state = load_restart_state(self.restart_file)
        doing_extension = os.path.exists(EXTENSION_LOCKFILE)
        restart_state["runs_completed"] += 1

        restart_directory = f"restart{restart_state['restarts_completed']}"
        run_directory = f"{restart_directory}/run{restart_state['runs_completed']}"
        os.makedirs(run_directory, exist_ok=True)

        # Archive this run's trajectory data
        for data_folder in ["traj_segs", "seg_logs"]:
            if doing_extension and os.path.islink(data_folder):
                os.unlink(data_folder)
                os.mkdir(data_folder)
                continue
            new_path = f"{run_directory}/{data_folder}"
            if os.path.exists(new_path):
                log.info(f"{new_path} already exists. Removing and overwriting.")
                shutil.rmtree(new_path)
            try:
                os.rename(data_folder, new_path)
            except FileNotFoundError:
                log.warning(f"Folder {data_folder} was not found.")
            else:
                os.mkdir(data_folder)

        last_run = restart_state["runs_completed"] >= self.n_runs
        last_restart = restart_state["restarts_completed"] >= self.n_restarts

        if not last_run:
            # More runs to do in this marathon before restarting
            log.info(f"Run {restart_state['runs_completed']}/{self.n_runs} completed.")
            initialization_state = {
                "tstate_file": None, "bstate_file": None, "sstate_file": None,
                "tstates": None, "bstates": None, "sstates": None,
                "segs_per_state": None,
            }
            self.data_manager.finalize_run()
            shutil.copyfile(self.data_manager.we_h5filename, f"{run_directory}/west.h5")

            if not doing_extension:
                if not os.path.exists(self.initialization_file):
                    raise RuntimeError(
                        "No initialization JSON file provided -- can't start "
                        "new runs in this marathon."
                    )
                with open(self.initialization_file, "r") as fp:
                    initialization_state.update(
                        fix_deprecated_initialization(json.load(fp))
                    )
                self.init_we(initialization_state, self.pcoord_cache)
                save_restart_state(self.restart_file, restart_state)
                log.info("New WE run ready!")
                w_run.run_simulation()
                return
            else:
                self.prepare_extension_run(
                    run_number=restart_state["runs_completed"] + 1,
                    restart_state=restart_state,
                )
                return

        # All runs complete: build the model (unless all restarts done too)
        original_bstates = self.sim_manager.current_iter_bstates
        if original_bstates is None:
            original_bstates = self.data_manager.get_basis_states(
                self.sim_manager.n_iter - 1
            )
        assert original_bstates is not None, "Bstates are none in the current iteration"
        original_tstates = self.data_manager.get_target_states(self.cur_iter)

        self.data_manager.finalize_run()
        shutil.copyfile(self.data_manager.we_h5filename, f"{run_directory}/west.h5")

        west_files = marathon_west_files(
            restart_state, self.n_runs, self.restarts_to_use, self.base_path
        )
        log.debug(f"WESTPA datafiles for analysis: {west_files}")

        # First restart: extend instead if no run reached the target
        if restart_state["restarts_completed"] == 0:
            target_reached = any(check_target_reached(f) for f in west_files)
            if target_reached or self.extension_iters == 0:
                if doing_extension and self.extension_iters != 0:
                    os.remove(EXTENSION_LOCKFILE)
                    westpa.rc.sim_manager.max_total_iterations = (
                        self.base_total_iterations
                    )
            else:
                log.info("Target not reached. Preparing for extensions.")
                if not os.path.exists(EXTENSION_LOCKFILE):
                    with open(EXTENSION_LOCKFILE, "w") as lockfile:
                        lockfile.write(str(self.max_total_iterations))
                restart_state["runs_completed"] = 0
                self.prepare_extension_run(
                    run_number=1, restart_state=restart_state, first_extension=True
                )
                return

        log.debug("Building haMSM and computing steady-state")
        self.h5file_paths = west_files
        self.pcoord_cache = None
        self.model = self.construct_hamsm()
        model = self.model

        log.info(f"Target steady-state flux is {model.JtargetSS}")

        model.update_cluster_structures(build_pcoord_cache=self.cache_pcoords)
        from copy import deepcopy

        self.pcoord_cache = deepcopy(model.pcoord_cache)

        synd_reverse_map = (
            build_reverse_coord_map(self.synd_full_coord_map)
            if self.synd_full_coord_map is not None
            else None
        )
        sstates_filename = write_restart_artifacts(
            model,
            restart_directory,
            store_h5=getattr(self.data_manager, "store_h5", False),
            struct_filetype=self._struct_filetype_spec,
            synd_reverse_coord_map=synd_reverse_map,
        )
        bstates_filename, tstates_filename = write_basis_target_states(
            restart_directory, original_bstates, original_tstates
        )
        self.generate_plots(restart_directory)

        if last_restart:
            log.info("All restarts completed! Finished.")
            return

        restart_state["restarts_completed"] += 1
        restart_state["runs_completed"] = 0
        save_restart_state(self.restart_file, restart_state)

        log.info("Initializing new run")
        segs_per_state = 1
        if os.path.exists(self.initialization_file):
            # Archive the previous restart's initialization record. It need
            # not exist: single-run marathons (n_runs=1) never required one
            shutil.move(
                self.initialization_file,
                f"{restart_directory}/{self.initialization_file}",
            )
        initialization_state = {
            "tstate_file": tstates_filename,
            "bstate_file": bstates_filename,
            "sstate_file": sstates_filename,
            "tstates": None, "bstates": None, "sstates": None,
            "segs_per_state": segs_per_state,
        }
        with open(self.initialization_file, "w") as fp:
            json.dump(initialization_state, fp)

        self.init_we(initialization_state, self.pcoord_cache)
        log.info("New WE run ready!")
        w_run.run_simulation()
