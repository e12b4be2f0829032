"""The benchmark's traffic generators make the port's inputs, array for
array: its copy of ``testing.make_problem`` and its vectorised copy of the
synthetic WE run (``data/synthetic.py``); a reordered problem is the same
problem."""
import os

import numpy as np
import pytest

import bench_helpers
from benchmark.traffic.hot_problem import make_problem, reorder
from benchmark.traffic.we_run import generate
from msm_we_tpu_torch.data.synthetic import generate_we_arrays
from msm_we_tpu_torch.testing import make_problem as port_make_problem


@pytest.mark.parametrize("seed", [7, 2**31 + 19])
@pytest.mark.parametrize("n_bins", [10, 128])
def test_hot_problem_equals_the_ports(seed, n_bins):
    kw = dict(n_segments=1536, n_raw_features=48, n_components=6, n_bins=n_bins,
              k_per_bin=4, seed=seed)
    ours, port = make_problem(**kw), port_make_problem(**kw)
    assert ours.keys() == port.keys()
    for k in port:
        assert np.array_equal(ours[k], port[k]), k


@pytest.mark.parametrize("seed", [5, 2**40 + 3])
def test_a_reordered_problem_steps_the_same_segments(seed):
    """The port's step over a reordered problem gives each segment the ids
    it had, and the same flux matrix and steady state up to rounding."""
    from msm_we_tpu_torch.entry import hot_step

    p = make_problem(n_segments=1024, n_raw_features=40, n_components=6, n_bins=5,
                     k_per_bin=4, seed=0)
    q = reorder(p, seed)
    order = np.random.default_rng(seed).permutation(1024)
    assert np.array_equal(q["raw_parent"], p["raw_parent"][order])
    assert not np.array_equal(order, np.arange(1024))
    a, b = hot_step(p, "two_transform", "cpu"), hot_step(q, "two_transform", "cpu")
    for k in ("pidx", "cidx"):
        assert np.array_equal(b[k].numpy(), a[k].numpy()[order]), k
    for k in ("fm", "pss"):
        assert np.allclose(b[k].numpy(), a[k].numpy(), rtol=1e-5, atol=1e-7), k
    # The dedup tier's continuity holds in the new order
    hot_step(q, "dedup", "cpu")


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
@pytest.mark.parametrize("n_iterations,n_segments", [(6, 50), (4, 300)])
def test_we_run_equals_the_ports(seed, n_iterations, n_segments):
    ours = generate(n_iterations, n_segments, seed)
    port = generate_we_arrays(n_iterations, n_segments, seed)
    assert len(ours) == len(port) == n_iterations + 1
    for a, b in zip(ours, port):
        assert a.keys() == b.keys()
        for k in b:
            assert np.array_equal(a[k], b[k]), k



def test_the_build_bins_are_the_runs_own():
    """The build cells bin by the synthetic run's own WE bin mapper, as the
    plugin reads a run's own."""
    cfg = bench_helpers.load_json(
        os.path.join(bench_helpers.BENCH, "configs", "westpa_default.json"))
    s = cfg["synthetic"]
    edges = np.linspace(s["x_min"], s["x_max"], s["n_we_bins"] + 1)
    assert np.array_equal(cfg["build"]["we_bin_edges"], edges)
