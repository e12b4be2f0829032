"""Automated haMSM construction plugin.

Counterpart of ``msm_we_tpu/westpa_plugins/hamsm_driver.py`` (reference
``westpa_plugins/hamsm_driver.py``, HAMSMDriver :8). The model-building logic
is the WESTPA-free :func:`build_hamsm_from_config`; the driver wraps it into
a ``finalize_run`` callback and stores the model on the data manager. The
model runs on the device the config names (``device``, default ``"cuda"``).
"""
from __future__ import annotations

from .._logging import log
from ..model import modelWE


def _resolve_callable(spec):
    """Resolve a dotted-path string to a python object (the reference uses
    ``westpa.core.extloader.get_object``); callables pass through."""
    if spec is None or callable(spec):
        return spec
    import importlib

    if ":" in spec:
        module_name, attr = spec.split(":")
    else:
        module_name, _, attr = spec.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def build_hamsm_from_config(plugin_config, h5file_paths, first_iter_to_use=None,
                            device=None):
    """Build and analyze an haMSM from a plugin-config dict.

    Config schema follows the reference (``hamsm_driver.py:8-33``):
    ``model_name``, ``n_clusters`` (per WE bin), ``tau``,
    ``basis_pcoord_bounds``/``target_pcoord_bounds``, ``dimreduce_method``,
    ``featurization`` (dotted path or callable), ``first_analysis_iter``,
    ``cross_validation_groups``, plus optional ``user_bin_mapper``.
    Ray-related keys are accepted and ignored (the work runs as batched
    calls on the model's device). ``h5file_paths`` is a list of west.h5
    paths or an :class:`~msm_we_tpu_torch.data.ArrayWEDataset`.

    ``first_analysis_iter`` is honored from the config when the
    ``first_iter_to_use`` parameter is not given (an explicit parameter wins,
    matching the driver, which threads its own resolved value through). The
    model's device is ``device`` when given, else the config's ``device``,
    else ``"cuda"``.
    """
    if first_iter_to_use is None:
        first_iter_to_use = plugin_config.get("first_analysis_iter", 1)
    if device is None:
        device = plugin_config.get("device", "cuda")
    featurizer = _resolve_callable(plugin_config.get("featurization"))

    model = modelWE(device=device)
    if featurizer is not None:
        model.processCoordinates = featurizer

    model.build_analyze_model(
        file_paths=h5file_paths,
        ref_struct=plugin_config.get(
            "ref_pdb_file", {"coords": None, "nAtoms": 1, "coord_ndim": 3}
        ),
        modelName=plugin_config.get("model_name"),
        basis_pcoord_bounds=plugin_config.get("basis_pcoord_bounds"),
        target_pcoord_bounds=plugin_config.get("target_pcoord_bounds"),
        dimreduce_method=plugin_config.get("dimreduce_method", None),
        n_clusters=plugin_config.get("n_clusters"),
        tau=plugin_config.get("tau", None),
        step_kwargs={
            "dimReduce": {
                "use_weights": plugin_config.get("dimreduce_use_weights", True),
                "variance_cutoff": plugin_config.get("dimreduce_var_cutoff", 0.95),
                "first_iter": first_iter_to_use,
            },
            "clustering": {
                "first_cluster_iter": first_iter_to_use,
                "user_bin_mapper": plugin_config.get("user_bin_mapper"),
            },
        },
        fluxmatrix_iters=[first_iter_to_use, -1],
        allow_validation_failure=True,
        cross_validation_groups=plugin_config.get("cross_validation_groups", 2),
        device_pipeline=plugin_config.get("device_pipeline", False),
        show_live_display=plugin_config.get("show_live_display", True),
    )
    return model


class HAMSMDriver:
    """WESTPA plugin to construct an haMSM at the end of a run.

    west.cfg usage (reference schema)::

        west:
          plugins:
            - plugin: msm_we_tpu_torch.westpa_plugins.hamsm_driver.HAMSMDriver
              model_name: name
              n_clusters: clusters per WE bin
              tau: resampling time
              basis_pcoord_bounds: [[lo, hi], ...]
              target_pcoord_bounds: [[lo, hi], ...]
              dimreduce_method: pca | tica | vamp | none
              featurization: module.path.to.featurizer
              first_analysis_iter: 1
              device_pipeline: false   # pair discretization over the mesh
              show_live_display: true
              device: cuda             # the model's torch device
    """

    def __init__(self, sim_manager, plugin_config):
        import westpa

        westpa.rc.pstatus("Initializing haMSM plugin")
        if not sim_manager.work_manager.is_master:
            westpa.rc.pstatus("Not running on the master process, skipping")
            return

        self.data_manager = sim_manager.data_manager
        self.sim_manager = sim_manager
        self.plugin_config = plugin_config
        self.priority = plugin_config.get("priority", 2)

        sim_manager.register_callback(
            sim_manager.finalize_run, self.construct_hamsm, self.priority
        )

        # Overridable file list (the restart driver extends this with prior
        # runs' h5 files, reference ``hamsm_driver.py:59-64``)
        self.h5file_paths = [self.data_manager.we_h5filename]
        self.first_iter_to_use = plugin_config.get("first_analysis_iter", 1)

    def construct_hamsm(self):
        """Build the haMSM and store it on the data manager."""
        self.data_manager.hamsm_model = None

        featurizer = _resolve_callable(self.plugin_config.get("featurization"))
        if featurizer is not None:
            self.data_manager.processCoordinates = featurizer
        self.data_manager.close_backing()

        model = build_hamsm_from_config(
            self.plugin_config, self.h5file_paths, self.first_iter_to_use
        )
        log.info(f"Storing built haMSM on {self.data_manager}")
        self.data_manager.hamsm_model = model
        return model
