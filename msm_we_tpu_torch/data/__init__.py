"""WE data for the port: the in-memory dataset and the synthetic generator."""
from .arrays import ArrayWEDataset
from .synthetic import (
    SynthWESettings,
    generate_trajectory_arrays,
    generate_we_arrays,
    generate_we_replicas,
    stack_we_runs,
)

__all__ = [
    "ArrayWEDataset",
    "SynthWESettings",
    "generate_trajectory_arrays",
    "generate_we_arrays",
    "generate_we_replicas",
    "stack_we_runs",
]
