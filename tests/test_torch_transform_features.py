"""The hot step's features-only transform (``ops.stratified_assign.
transform_features``) on the CPU: its plain version against H1's plain
emitted features, its route rule at its edge, the hot step's
routes through it against the compositions they replace, and the count a
capture records. The kernel itself is held to H1 on the card by
``tests/test_torch_transform_features_cuda.py``."""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch import _graph
from msm_we_tpu_torch import entry as tentry
from msm_we_tpu_torch.entry import _hot_step, _two_transform, stage_problem
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import make_problem

torch.set_num_threads(1)


def _h1_g(raw, proj):
    """H1's plain emitted features (one center, bin 0 for every row)."""
    D, F = proj.shape
    bins = torch.zeros(raw.shape[0], dtype=torch.int32)
    return sa.transform_assign_child_plain(
        raw, bins, None, None, torch.zeros(D), proj, torch.zeros((1, F)),
        torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), 3,
        emit_features=True)[1]


@pytest.mark.parametrize("na,nb,D,F", [(1, None, 900, 30), (37, 53, 900, 30),
                                       (40, 40, 901, 31), (17, 5, 64, 12),
                                       (0, 9, 33, 32)])
def test_plain_version_is_h1s_features(na, nb, D, F):
    gen = torch.Generator().manual_seed(na + D + F)
    a = torch.randn((na, D), generator=gen)
    b = None if nb is None else torch.randn((nb, D), generator=gen)
    proj = torch.randn((D, F), generator=gen)
    sa.reset_launch_counts()
    ga, gb = sa.transform_features(a, b, proj)
    assert torch.equal(ga, _h1_g(a, proj))
    if b is None:
        assert gb is None
    else:
        assert torch.equal(gb, _h1_g(b, proj))
    assert sa.launch_counts() == dict.fromkeys(sa.KERNELS, 0)


@pytest.mark.parametrize("D,F,fits", [
    (900, 30, True), (900, 32, True), (900, 33, False), (901, 31, True),
    (4000, 30, True), (1, 1, True), (900, 1, True), (900, 0, False),
    (0, 30, False), (900, 300, False), (64, 12, True), (64, 40, False),
])
def test_the_route_rule_at_its_edge(D, F, fits):
    """F within two of the kernel's tile widths (32 features), any D."""
    assert sa.features_stream_fits(D, F) is fits


def test_tile_widths():
    """The least instantiated width whose two lane halves hold F: F = 30
    tiles exactly (15 a half); odd F leaves one feature slot unused."""
    assert [sa._stream_width(F) for F in (1, 8, 9, 24, 25, 30, 31, 32, 33)] == [
        4, 4, 8, 12, 15, 15, 16, 16, 0]


@pytest.fixture(scope="module")
def problem():
    p = make_problem(n_segments=2048, n_raw_features=96, n_components=30,
                     n_bins=10, k_per_bin=5, seed=7)
    p["w"] = np.random.default_rng(3).integers(1, 17, 2048) / 16.0
    return p


def _without_tail(monkeypatch):
    monkeypatch.setattr(tentry, "steady_state_from_flux",
                        lambda fm, basis, target: (None,) * 4)


def test_grouped_route_is_the_composition_it_replaces(problem):
    """``_two_transform``'s grouped route on the CPU: both raw sets'
    features as H1's plain version emits them, then H3's plain version on
    H2's ``c2adj``, bit for bit."""
    s = stage_problem(problem, "two_transform", "cpu")
    got = _two_transform(s, True)
    rows = (s["pbins"], s["cbins"], s["w"], s["basis_p"], s["basis_c"],
            s["target_c"])
    bank = (s["centers"], s["center_bin"], s["valid"])
    a = sa.c2adj(s["mean"], s["comp"], s["centers"])
    ref = sa.assign_flux_plain(_h1_g(s["raw_parent"], s["comp"]),
                               _h1_g(s["raw_child"], s["comp"]), *rows, *bank,
                               s["n_states"], c2=a)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_dedup_step_is_the_composition_it_replaces(problem, monkeypatch):
    """The dedup tier on the CPU: the extended array's features as H1's
    plain version emits them, the parents gathered, H3's plain version,
    bit for bit."""
    s = stage_problem(problem, "dedup", "cpu")
    _without_tail(monkeypatch)
    out = _hot_step(s, "dedup")
    feats = _h1_g(s["raw_ext"], s["comp"]) - s["mean"] @ s["comp"]
    n = len(s["pbins"])
    ref = sa.assign_flux_plain(
        feats.index_select(0, s["rows_ext"]), feats[:n].contiguous(),
        s["pbins"], s["cbins"], s["w"], s["basis_p"], s["basis_c"],
        s["target_c"], s["centers"], s["center_bin"], s["valid"],
        s["n_states"])
    assert torch.equal(out["pidx"], ref[0]) and torch.equal(out["cidx"], ref[1])
    assert torch.equal(out["fm"], ref[2])


@pytest.mark.parametrize("tier,grouped,streamed", [
    ("two_transform", False, 0), ("two_transform", True, 1), ("dedup", None, 1)])
def test_a_capture_counts_the_streamed_features(problem, monkeypatch, tier,
                                                grouped, streamed):
    """Inside a capture the step adds ``features_stream`` (one a replay)
    where its features come from the streaming transform: the grouped
    route and the dedup tier; H2's route counts none."""
    s = stage_problem(problem, tier, "cpu")
    if grouped is not None:
        s["grouped"] = grouped
    _without_tail(monkeypatch)
    cap = _graph._Capture("cpu")
    monkeypatch.setattr(_graph._local, "capture", cap, raising=False)
    _hot_step(s, tier)
    assert cap.counts["features_stream"] == streamed
    assert cap.counts["assign_grouped"] == int(bool(grouped))


def test_a_capture_counts_no_stream_past_the_rule(problem, monkeypatch):
    """Where the shape leaves the rule (33 features), the grouped route's
    features come from H1's launches and the count stays 0."""
    s = stage_problem(problem, "two_transform", "cpu")
    s["grouped"] = True
    D = s["comp"].shape[0]
    s["comp"] = torch.randn((D, 33), generator=torch.Generator().manual_seed(1))
    s["centers"] = torch.zeros((len(s["center_bin"]), 33))
    _without_tail(monkeypatch)
    cap = _graph._Capture("cpu")
    monkeypatch.setattr(_graph._local, "capture", cap, raising=False)
    _hot_step(s, "two_transform")
    assert cap.counts == dict(assign_grouped=1, features_stream=0)


def test_the_kernel_is_registered():
    """The wrapper counts its launches beside the others', and a trace
    finds its kernel by name."""
    assert sa.KERNELS["transform_features"] is sa.transform_features
    assert sa.KERNEL_SYMBOLS["transform_features"] == "transform_features_kernel"
    sa.reset_launch_counts()
    assert sa.launch_counts()["transform_features"] == 0
