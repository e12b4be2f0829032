"""The port's trajectory ensembles (``msm_we_tpu_torch.msm.ensembles``) and
the ``utils`` helpers they use against the JAX package's on the same seeded
numpy trajectories, and the port's ``dijkstra_path`` against networkx.

Both modules are host numpy with the same code, so results are held
bitwise; where a float goes through a different summation they are held to
1e-12.
"""
import networkx as nx
import numpy as np
import pytest

from msm_we_tpu import utils as jax_utils
from msm_we_tpu.msm import ensembles as jax_ens
from msm_we_tpu_torch import utils
from msm_we_tpu_torch.msm import ensembles as ens
from msm_we_tpu_torch.msm.ensembles import dijkstra_path


def mc_simulation(numsteps):
    x = 5
    inside = utils.Interval([0, 100], 1)
    traj = []
    for _ in range(numsteps):
        dx = np.random.uniform(-10, 10)
        if (x + dx) in inside:
            x = x + dx
        traj.append(x)
    return np.array(traj)


def simple_mapping(x):
    return int(x / 10)


@pytest.fixture(scope="module")
def trajs():
    np.random.seed(192348)
    return [mc_simulation(4000) for _ in range(3)]


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------- utils
@pytest.mark.parametrize("helper", [
    "reverse_sort_lists", "weighted_choice", "get_shape", "random_markov_matrix",
    "pops_from_nm_tmatrix", "map_to_integers",
])
def test_utils_helpers_match_jax(helper):
    port, ref = getattr(utils, helper), getattr(jax_utils, helper)
    rng = np.random.default_rng(5)
    if helper == "reverse_sort_lists":
        a, b = list(rng.random(7)), list("abcdefg")
        assert port(a, b) == ref(a, b)
    elif helper == "weighted_choice":
        items, w = list(range(6)), rng.random(6)
        for weights in (w, None, list(w * 10)):
            np.random.seed(42)
            got = [port(items, weights) for _ in range(200)]
            state_port = np.random.random()
            np.random.seed(42)
            want = [ref(items, weights) for _ in range(200)]
            assert got == want
            assert state_port == np.random.random()  # one draw a call in both
        assert len(set(got)) == 6
    elif helper == "get_shape":
        for shape in ((5,), (5, 3)):
            assert port(np.zeros(shape)) == ref(np.zeros(shape))
        with pytest.raises(ValueError, match="not 1-D or 2-D"):
            port(np.zeros((2, 2, 2)))
    elif helper == "random_markov_matrix":
        _same(port(6, seed=3), ref(6, seed=3))
        np.random.seed(9)
        a = port(4)
        np.random.seed(9)
        _same(a, ref(4))
        np.testing.assert_allclose(a.sum(axis=1), 1.0, rtol=1e-14)
    elif helper == "pops_from_nm_tmatrix":
        T = utils.pseudo_nm_tmatrix(utils.random_markov_matrix(5, seed=1), [0], [4])
        got, want = port(T), ref(T)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert got.shape == (5,) and np.isclose(got.sum(), 1.0)
        with pytest.raises(ValueError, match="even number"):
            port(utils.random_markov_matrix(3, seed=1))
    else:
        seq = ["b", "a", "b", "c", "a"]
        got, gmap = port(seq)
        want, wmap = ref(seq)
        _same(got, want)
        assert gmap == wmap == {"b": 0, "a": 1, "c": 2}
        got2, gmap2 = port(["c", "d"], gmap)
        assert list(got2) == [2, 3] and gmap2["d"] == 3


# -------------------------------------------------------------- dijkstra
def _graphs():
    """(name, adjacency in insertion order) for seeded random digraphs, with
    integer weights (many equal-length paths) and with float weights."""
    out = []
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 11))
        integer = seed % 2 == 0
        adj = {i: {} for i in range(n)}
        for i, j in zip(*np.nonzero(rng.random((n, n)) < 0.45)):
            if i != j:
                adj[int(i)][int(j)] = (float(rng.integers(1, 3)) if integer
                                       else float(rng.random()) + 0.05)
        out.append((f"seed{seed}_{'int' if integer else 'float'}", adj))
    # A diamond and a ladder: every route has the same length
    out.append(("diamond", {0: {1: 1.0, 2: 1.0}, 1: {3: 1.0}, 2: {3: 1.0}, 3: {}}))
    out.append(("diamond_rev", {0: {2: 1.0, 1: 1.0}, 1: {3: 1.0}, 2: {3: 1.0}, 3: {}}))
    out.append(("ladder", {0: {1: 1.0, 2: 2.0}, 1: {2: 1.0, 3: 2.0},
                           2: {3: 1.0, 4: 2.0}, 3: {4: 1.0}, 4: {}}))
    return out


@pytest.mark.parametrize("name,adj", _graphs(), ids=[g[0] for g in _graphs()])
def test_dijkstra_path_equals_networkx(name, adj):
    G = nx.DiGraph()
    G.add_nodes_from(adj)
    for u, succ in adj.items():
        for v, d in succ.items():
            G.add_edge(u, v, distance=d)
    n_paths = 0
    for s in adj:
        for t in adj:
            try:
                want = nx.dijkstra_path(G, s, t, "distance")
            except nx.NetworkXNoPath:
                with pytest.raises(ValueError, match="no path"):
                    dijkstra_path(adj, s, t)
                continue
            assert dijkstra_path(adj, s, t) == want, (s, t)
            n_paths += 1
    assert n_paths >= len(adj)
    with pytest.raises(KeyError):
        dijkstra_path(adj, 99, 0)


def test_graph_from_matrix_matches_networkx_graph():
    T = utils.random_markov_matrix(6, seed=2)
    T[T < 0.12] = 0.0
    adj = ens.DiscretePathEnsemble._graph_from_matrix(T)
    G = jax_ens.DiscretePathEnsemble._graph_from_matrix(T)
    assert list(adj) == list(G.nodes)
    for u in adj:
        assert list(adj[u]) == list(G.successors(u))
        for v, d in adj[u].items():
            assert d == G[u][v]["distance"]


# -------------------------------------------------------------- ensembles
def test_ensemble_containers_match_jax(trajs):
    stateA, stateB = [0, 10], [90, 100]
    built = []
    for mod in (ens, jax_ens):
        e0 = mod.Ensemble([trajs[0]])
        e2 = mod.Ensemble([trajs[1]])
        e2.add_trajectory(trajs[2])
        tot = e0 + e2
        e0 += mod.Ensemble([trajs[1]])
        built.append((e0, tot))
    (p0, ptot), (j0, jtot) = built
    assert len(ptot) == len(jtot) == 3 and len(p0) == len(j0) == 2
    assert str(ptot) == str(jtot)
    _same(ptot.empirical_mfpts(stateA, stateB), jtot.empirical_mfpts(stateA, stateB))
    _same(ptot._count_matrix(10, simple_mapping), jtot._count_matrix(10, simple_mapping))
    _same(ptot._mle_transition_matrix(10, simple_mapping),
          jtot._mle_transition_matrix(10, simple_mapping))
    times = [1, 5, 20]
    for sym in (True, False):
        _same(ptot.empirical_corr_function(stateA, stateB, times, symmetric=sym),
              jtot.empirical_corr_function(stateA, stateB, times, symmetric=sym))
    with pytest.raises(ValueError, match="same number of variables"):
        ens.Ensemble([np.zeros((4, 2)), np.zeros((4, 3))])
    with pytest.raises(ValueError, match="map function"):
        ptot._count_matrix()


def test_path_ensembles_match_jax(trajs):
    stateA, stateB = [0, 10], [90, 100]
    paths = []
    for mod in (ens, jax_ens):
        tot = mod.Ensemble(list(trajs))
        pe = mod.PathEnsemble.from_ensemble(tot, stateA, stateB)
        dpe = mod.DiscretePathEnsemble.from_ensemble(tot, [0], [9],
                                                     map_function=simple_mapping)
        de = mod.DiscreteEnsemble.from_ensemble(tot, map_function=simple_mapping)
        paths.append((tot, pe, dpe, de))
    (ptot, ppe, pdpe, pde), (jtot, jpe, jdpe, jde) = paths
    assert len(ppe) == len(jpe) > 0 and len(pdpe) == len(jdpe) > 0
    _same(ppe.trajectories, jpe.trajectories)
    _same(pdpe.trajectories, jdpe.trajectories)
    _same(pde.trajectories, jde.trajectories)
    _same(ppe.empirical_mfpts(stateA, stateB), jpe.empirical_mfpts(stateA, stateB))
    K = ptot._mle_transition_matrix(10, simple_mapping)
    for sym in (True, False):
        got = pdpe.weighted_fundamental_sequences(K, symmetric=sym)
        want = jdpe.weighted_fundamental_sequences(K, symmetric=sym)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=0)
        assert np.isclose(sum(got[1]), 1.0)
    got = pdpe.nm_mfpt(n_states=10)
    want = jdpe.nm_mfpt(n_states=10)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(ValueError, match="stateA"):
        ens.PathEnsemble([trajs[0]])
    with pytest.raises(NotImplementedError):
        ppe.cluster(None)


@pytest.mark.parametrize("ini_pops", [None, "ss", [0.25, 0.75]])
def test_from_transition_matrix_consumes_the_same_random_numbers(ini_pops):
    T = utils.random_markov_matrix(7, seed=4)
    out = []
    for mod in (ens, jax_ens):
        np.random.seed(2024)
        d = mod.DiscreteEnsemble.from_transition_matrix(T, sim_length=500,
                                                        initial_state=3)
        p = mod.DiscretePathEnsemble.from_transition_matrix(
            T, stateA=[0, 1], stateB=[6], n_paths=40, ini_pops=ini_pops)
        out.append((d, p, np.random.random()))
    (pd, pp, pnext), (jd, jp, jnext) = out
    _same(pd.trajectories, jd.trajectories)
    _same(pp.trajectories, jp.trajectories)
    assert pnext == jnext  # the generators stand at the same draw
    assert len(pd[0]) == 501 and pd[0][0] == 3
    assert all(t[0] in (0, 1) and t[-1] == 6 for t in pp)
    got = pp.weighted_fundamental_sequences(T)
    want = jp.weighted_fundamental_sequences(T)
    assert got[0] == want[0] and got[2] == want[2] == 40
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="simulation length"):
        ens.DiscreteEnsemble.from_transition_matrix(T)
