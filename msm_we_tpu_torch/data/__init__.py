"""WE data for the port: the west.h5 reader, the in-memory dataset and the
synthetic generator. h5py is imported only when a file is touched."""
from .arrays import ArrayWEDataset
from .synthetic import (
    SEG_INDEX_DTYPE,
    SynthWESettings,
    generate_trajectory_arrays,
    generate_we_arrays,
    generate_we_replicas,
    generate_west_h5,
    stack_we_runs,
)
from .westh5 import WEDataset

__all__ = [
    "ArrayWEDataset",
    "SEG_INDEX_DTYPE",
    "SynthWESettings",
    "WEDataset",
    "generate_trajectory_arrays",
    "generate_we_arrays",
    "generate_we_replicas",
    "generate_west_h5",
    "stack_we_runs",
]
