"""WESTPA plugin drivers (counterpart of ``msm_we_tpu/westpa_plugins``).

Each driver wires the port into WESTPA's sim_manager callback system. The
WESTPA-independent logic (restart bookkeeping, start-state weights, the
haMSM built from a config dict, optimized bins) lives in plain functions,
usable without a WESTPA install; westpa, h5py and mdtraj are imported only
inside the functions that need them. A driver's model runs on the device
its config names (``device``, default ``"cuda"``).
"""

__all__ = [
    "H5AugmentationDriver",
    "MDAugmentationDriver",
    "HAMSMDriver",
    "RestartDriver",
    "OptimizationDriver",
]


def __getattr__(name):
    if name in ("H5AugmentationDriver", "MDAugmentationDriver"):
        from .augmentation_driver import H5AugmentationDriver, MDAugmentationDriver

        return {"H5AugmentationDriver": H5AugmentationDriver,
                "MDAugmentationDriver": MDAugmentationDriver}[name]
    if name == "HAMSMDriver":
        from .hamsm_driver import HAMSMDriver

        return HAMSMDriver
    if name == "RestartDriver":
        from .restart_driver import RestartDriver

        return RestartDriver
    if name == "OptimizationDriver":
        from .optimization_driver import OptimizationDriver

        return OptimizationDriver
    raise AttributeError(name)
