"""Automated WE hyperparameter (binning/allocation) optimization plugin.

Counterpart of ``msm_we_tpu/westpa_plugins/optimization_driver.py``
(reference ``westpa_plugins/optimization_driver.py``, OptimizationDriver
:63). The whole coordinate map is featurized in batched calls (the
reference used a pool of Ray actors, one structure at a time). The
optimized mapper assigns through its stratified bank, which launches the H4
kernel on the card. WESTPA pickles the wrapped mapper into its workers with
plain ``pickle``, and a pickled bank holds CPU state, so the wrapper carries
the workers' device (the config's ``device``, default ``"cuda"``) and each
assignment puts the bank there first.
"""
from __future__ import annotations

import pickle

import numpy as np

from .. import optimization
from .._device import as_device
from .._logging import log


def _wrap_for_westpa(mapper, device="cuda"):
    """Adapt an :class:`~msm_we_tpu_torch.optimization.OptimizedBinMapper`
    to WESTPA's BinMapper contract.

    Our mapper is a plain standalone class; WESTPA's sim_manager expects the
    full BinMapper interface (``pickle_and_hash``, the (coords, mask, output)
    assign signature, ...). Wrapping in a ``FuncBinMapper`` supplies all of
    that, with the optimized mapper and the device its assignments run on
    carried as picklable arguments.
    """
    from westpa.core.binning import FuncBinMapper

    return FuncBinMapper(
        _optimized_assign, int(mapper.nbins), args=(mapper, str(as_device(device)))
    )


def _optimized_assign(coords, mask, output, mapper, device="cuda"):
    """FuncBinMapper assign function (module-level so it pickles): the
    mapper's bank goes to ``device`` (a bank unpickled in a worker lies on
    the CPU), then the masked rows are assigned."""
    strat = mapper.clusterer.strat
    if strat.device != as_device(device):
        strat.to(device)
    output[mask] = mapper.assign(np.asarray(coords)[mask])


def compute_optimized_bins_for_model(
    model, n_active_bins, binning_strategy=None, cluster_on_pcoord=False
):
    """Build an :class:`~msm_we_tpu_torch.optimization.OptimizedBinMapper`
    from a built haMSM; its bank stays on the model's device.

    ``binning_strategy`` (callable or None) maps the model to per-microstate
    WE bin indices; default is k-means MFPT binning
    (reference ``optimization_driver.py:198-273``; without sklearn its
    k-means runs on the model's device).
    """
    if binning_strategy is None:
        log.info(
            "Using default k-means MFPT optimization "
            "(optimization.get_clustered_mfpt_bins) for bin optimization"
        )
        discrepancy, variance = optimization.solve_discrepancy(
            tmatrix=model.Tmatrix, pi=model.pSS, B=model.indTargets
        )
        microstate_assignments = optimization.get_clustered_mfpt_bins(
            variance, discrepancy, model.pSS, n_active_bins, device=model.device
        )
    else:
        microstate_assignments = binning_strategy(model)

    microstate_assignments = np.asarray(microstate_assignments, dtype=float)
    n_states = model.nBins
    if len(microstate_assignments) == n_states - 2:
        # Strategies may exclude basis/target (the reference's documented
        # strategy contract); extend to cover their sorted positions
        microstate_assignments = np.concatenate(
            [microstate_assignments, [n_active_bins - 2, n_active_bins - 1]]
        )

    # The assignments are computed in the pcoord-SORTED fluxMatrix numbering
    # (discrepancy/variance/pSS all live there), but OptimizedBinMapper
    # consumes RAW stratified predict ids -- permute into raw numbering.
    # (The reference ships the sorted array and indexes it with raw ids:
    # silently wrong WE bins whenever the sort is non-identity; fixed here.)
    sort_idx = getattr(model, "pcoord_sort_indices", None)
    if sort_idx is not None and len(microstate_assignments) == len(sort_idx):
        inv = np.empty(len(sort_idx), dtype=np.int64)
        inv[np.asarray(sort_idx)] = np.arange(len(sort_idx))
        microstate_assignments = microstate_assignments[inv]

    # Pin the raw basis/target slots to the last two WE bins (the mapper
    # additionally overrides by pcoord region at assignment time)
    if len(microstate_assignments) >= n_states:
        microstate_assignments[n_states - 2] = n_active_bins - 2
        microstate_assignments[n_states - 1] = n_active_bins - 1
    log.debug(f"Microstate assignments are {microstate_assignments}")

    return optimization.OptimizedBinMapper(
        n_active_bins,
        model.pcoord_ndim,
        model.target_pcoord_bounds,
        model.basis_pcoord_bounds,
        model.clusters.bin_mapper,
        microstate_assignments,
        model.clusters,
        cluster_on_pcoord=cluster_on_pcoord,
    )


def compute_new_pcoord_map(model, coord_map, original_pcoord_map, batch_size=4096):
    """Extended pcoord map: original pcoord + reduced MSM features per state.

    ``coord_map``: {state_id: full-coordinate structure};
    ``original_pcoord_map``: callable state_id -> original pcoord (the SynD
    backmap in the reference).

    Vectorized: structures are stacked and pushed through
    ``model.reduceCoordinates`` in batches -- replacing the reference's
    per-structure Ray actor calls (``optimization_driver.py:275-328``).
    """
    state_ids = list(coord_map.keys())
    structures = np.stack([np.asarray(coord_map[s]) for s in state_ids])

    reduced = []
    for start in range(0, len(structures), batch_size):
        reduced.append(
            np.asarray(model.reduceCoordinates(structures[start : start + batch_size]))
        )
    reduced = np.concatenate(reduced)

    new_pcoord_map = {}
    for i, state_id in enumerate(state_ids):
        original = np.atleast_1d(np.asarray(original_pcoord_map(state_id)))
        new_pcoord_map[state_id] = np.concatenate([original, reduced[i]])
    return new_pcoord_map


class OptimizationDriver:
    """WESTPA plugin: optimize binning + allocation from the built haMSM, then
    continue WE with the new mapper.

    west.cfg usage (reference schema, ``optimization_driver.py:71-85``)::

        west:
          plugins:
            - plugin: msm_we_tpu_torch.westpa_plugins.optimization_driver.OptimizationDriver
              full_coord_map: pickled {state: structure} dict
              max_iters: total iterations across optimization rounds
              binning_strategy: optional dotted path
              allocation_strategy: optional dotted path
              device: cuda    # where the workers' mapper assigns
    """

    def __init__(self, sim_manager, plugin_config):
        import westpa

        westpa.rc.pstatus("Initializing optimization plugin")
        if not sim_manager.work_manager.is_master:
            westpa.rc.pstatus("Not running on the master process, skipping")
            return

        self.data_manager = sim_manager.data_manager
        self.sim_manager = sim_manager
        self.we_driver = westpa.rc.get_we_driver()
        self.propagator = westpa.rc.get_propagator()
        self.synd_model = getattr(self.propagator, "synd_model", None)
        self.plugin_config = plugin_config

        coord_map_path = plugin_config.get("full_coord_map")
        with open(coord_map_path, "rb") as infile:
            self.coord_map = pickle.load(infile)

        self.priority = plugin_config.get("priority", 3)
        self.device = plugin_config.get("device", "cuda")
        self.cluster_on_pcoord = plugin_config.get("cluster_on_pcoord", False)
        self.original_pcoord_dim = westpa.rc.config.get(
            ["west", "system", "system_options", "pcoord_ndim"]
        )

        sim_manager.register_callback(
            sim_manager.finalize_run, self.do_optimization, self.priority
        )

    def do_optimization(self):
        """Update mapper, allocation, and pcoord map, then continue WE.

        Reference ``optimization_driver.py:121-165``.
        """
        import westpa
        from westpa.cli.core import w_run

        # Validate config BEFORE any irreversible surgery: update_westpa_pcoord
        # deletes and recreates this iteration's pcoord/istate datasets, so a
        # missing max_iters must not be discovered afterwards
        max_iters = self.plugin_config.get("max_iters")
        if max_iters is None:
            raise ValueError(
                "The optimization driver config requires 'max_iters' (total WE "
                "iteration budget across optimization rounds)."
            )

        westpa.rc.pstatus("Updating bin mapper")
        self.we_driver.bin_mapper = _wrap_for_westpa(
            self.compute_optimized_bins(), device=self.device
        )

        westpa.rc.pstatus("Updating allocation")
        self.we_driver.bin_target_counts = self.compute_optimized_allocation()

        westpa.rc.pstatus("Updating pcoord map")
        new_pcoord_map = self.compute_new_pcoord_map()
        self.update_westpa_pcoord(new_pcoord_map)

        remaining_iters = max_iters - self.sim_manager.max_total_iterations
        if remaining_iters > 0:
            new_iters = min(
                remaining_iters,
                westpa.rc.config.get(["west", "propagation", "max_total_iterations"]),
            )
            self.sim_manager.max_total_iterations += new_iters
            westpa.rc.pstatus(
                f"\n\n=== Applying optimization and continuing for {new_iters} "
                "more iterations ===\n"
            )
            w_run.run_simulation()
        else:
            westpa.rc.pstatus("No more iterations for optimization, completing.")

    @staticmethod
    def default_bin_optimizer(model):
        """Default microstate->WE-bin optimization: k-means MFPT bins from the
        discrepancy solve (reference ``optimization_driver.py:198-217``)."""
        import westpa

        # get_we_driver() lazily constructs the driver; the raw rc.we_driver
        # attribute is None until something else has done so
        we_driver = westpa.rc.get_we_driver()
        n_active_bins = int(np.count_nonzero(we_driver.bin_target_counts))
        discrepancy, variance = optimization.solve_discrepancy(
            tmatrix=model.Tmatrix, pi=model.pSS, B=model.indTargets
        )
        return optimization.get_clustered_mfpt_bins(
            variance, discrepancy, model.pSS, n_active_bins, device=model.device
        )

    @staticmethod
    def default_allocation_optimizer(model):
        """Trivial example allocation optimizer: keep the current target
        counts (reference ``optimization_driver.py:167-173``)."""
        del model
        import westpa

        return westpa.rc.get_we_driver().bin_target_counts

    def compute_optimized_allocation(self):
        """Pluggable allocation optimization; default keeps current counts."""
        from .hamsm_driver import _resolve_callable

        strategy = self.plugin_config.get("allocation_strategy", None)
        if strategy is None:
            log.info("Not updating allocation")
            return self.we_driver.bin_target_counts
        allocation_optimizer = _resolve_callable(strategy)
        return allocation_optimizer(self.data_manager.hamsm_model)

    def compute_optimized_bins(self):
        from .hamsm_driver import _resolve_callable

        model = self.data_manager.hamsm_model
        strategy = self.plugin_config.get("binning_strategy", None)
        n_active_bins = int(np.count_nonzero(self.we_driver.bin_target_counts))
        return compute_optimized_bins_for_model(
            model,
            n_active_bins,
            binning_strategy=_resolve_callable(strategy),
            cluster_on_pcoord=self.cluster_on_pcoord,
        )

    def compute_new_pcoord_map(self):
        model = self.data_manager.hamsm_model
        backmap = self.synd_model.backmap
        original_dim = self.original_pcoord_dim
        return compute_new_pcoord_map(
            model, self.coord_map, lambda s: backmap(s)[:original_dim]
        )

    def update_westpa_pcoord(self, new_pcoord_map):
        """Surgically rewrite WESTPA's in-flight pcoord datasets/istates so WE
        can continue with the extended pcoord. Reference
        ``optimization_driver.py:330-441``.
        """
        import westpa
        from westpa.core.data_manager import create_dataset_from_dsopts

        try:
            from synd.westpa.propagator import get_segment_parent_index
        except ImportError as e:
            raise RuntimeError(
                "Extending pcoords mid-run currently requires the SynD "
                "propagator (as in the reference)."
            ) from e

        self.propagator.synd_model._backmappers["default"] = new_pcoord_map.get
        # Probe dimensionality from any entry: state ids need not start at 0
        new_pcoord_dim = next(iter(new_pcoord_map.values())).shape[0]
        westpa.rc.pstatus(f"New pcoord dimensionality is {new_pcoord_dim}")

        system = westpa.rc.get_system_driver()
        data_manager = westpa.rc.get_data_manager()
        sim_manager = westpa.rc.get_sim_manager()

        data_manager.get_new_weight_data = lambda x: None
        system.pcoord_ndim = new_pcoord_dim

        # The haMSM model may hold cached read-only handles on the same
        # west.h5; an in-process 'r' open makes the read-write reopen fail
        model = getattr(self.data_manager, "hamsm_model", None)
        if model is not None and hasattr(model, "close_files"):
            model.close_files()

        data_manager.open_backing()
        iter_group = data_manager.get_iter_group(sim_manager.n_iter)
        n_iter = sim_manager.n_iter
        segments = data_manager.get_segments(n_iter=n_iter, load_pcoords=True)

        del data_manager.we_h5file[
            "/iterations/iter_{:0{prec}d}/pcoord".format(
                int(n_iter), prec=data_manager.iter_prec
            )
        ]
        data_manager.flush_backing()

        pcoord_opts = data_manager.dataset_options.get(
            "pcoord", {"name": "pcoord", "h5path": "pcoord", "compression": False}
        )

        for segment in segments:
            parent_state_index = get_segment_parent_index(segment)
            segment.pcoord = np.concatenate(
                [
                    [new_pcoord_map[parent_state_index]],
                    np.zeros(shape=(system.pcoord_len - 1, system.pcoord_ndim)),
                ]
            )

        create_dataset_from_dsopts(
            iter_group,
            pcoord_opts,
            data=np.array([segment.pcoord for segment in segments]),
            shape=(len(sim_manager.segments), system.pcoord_len, system.pcoord_ndim),
            dtype=system.pcoord_dtype,
        )
        data_manager.update_segments(n_iter, segments)

        # Recreate next iteration's istates with the new pcoord shape
        initial_states = data_manager.get_initial_states(n_iter)
        del data_manager.we_h5file[
            "/iterations/iter_{:0{prec}d}/ibstates/istate_pcoord".format(
                int(n_iter), prec=data_manager.iter_prec
            )
        ]
        del data_manager.we_h5file[
            "/iterations/iter_{:0{prec}d}/ibstates/istate_index".format(
                int(n_iter), prec=data_manager.iter_prec
            )
        ]
        new_istates = data_manager.create_initial_states(
            n_states=len(initial_states), n_iter=n_iter
        )
        for old_istate, new_istate in zip(initial_states, new_istates):
            bstate_id = old_istate.basis_state_id
            parent_state_index = int(sim_manager.next_iter_bstates[bstate_id].auxref)
            new_istate.pcoord = new_pcoord_map[parent_state_index]
            new_istate.istate_status = old_istate.istate_status

        # create_initial_states only allocates placeholder h5 rows; the
        # mutated pcoords must be written back explicitly (mirrors the
        # update_segments call for segment pcoords below)
        data_manager.update_initial_states(new_istates, n_iter=n_iter)

        data_manager.flush_backing()
        for segment in sim_manager.segments.values():
            parent_state = get_segment_parent_index(segment)
            segment.pcoord = new_pcoord_map[parent_state]
        data_manager.flush_backing()
        data_manager.close_backing()
