"""The streaming features-only transform on the card
(``csrc/transform_features.cu`` through ``ops.stratified_assign.
transform_features``) against H1's emitted features
(``transform_assign_child(..., emit_features=True)``, the kernel of
``csrc/stratified_assign.cu``): bitwise equal, since both sum each
feature as one fmaf chain over d ascending. Imports no JAX; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_transform_features_cuda.py
"""
import pytest
import torch

from msm_we_tpu_torch.ops import stratified_assign as sa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(n, D, seed, dev):
    """Rows like the hot step's raw coordinates (an offset and a spread a
    column, plus noise), made on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    scale = 0.3 * (1 + 0.2 * torch.randn(D, generator=gen))
    pc = 10 * torch.rand((n, 1), generator=gen)
    return (pc * scale + 0.3 * torch.randn((n, D), generator=gen)).to(dev)


def _proj(D, F, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((D, F), generator=gen) / D ** 0.5).to(dev)


def _h1_features(raw, proj):
    """H1's emitted features: a one-center bank that every row's bin 0
    matches, so scoring runs beside the transform."""
    dev, F = raw.device, proj.shape[1]
    zeros = torch.zeros(raw.shape[0], dtype=torch.int32, device=dev)
    return sa.transform_assign_child(
        raw, zeros, None, None, torch.zeros(raw.shape[1], device=dev), proj,
        torch.zeros((1, F), device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev), 3, emit_features=True)[1]


def _launches():
    c = sa.launch_counts()
    return c["transform_features"], c["transform_assign_child"]


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,D,F", [
    (1, 1, 900, 30),            # one row a set
    (102_400, 102_400, 900, 30),  # the hot step's sets
    (1000, 777, 900, 30),       # ragged N (not a multiple of 16 or 256)
    (1000, 333, 901, 30),       # D % 4 != 0: the producer warp's cp.async
    (333, 517, 900, 12),
    (333, 517, 900, 31),        # odd F: 16 features a lane half, one unused
    (333, 517, 900, 32),        # the widest F the rule takes
    (517, 333, 4000, 30),       # a long row: 250 stages a round
])
def test_both_sets_are_h1s_features(cuda_device, na, nb, D, F):
    """Both sets in one launch, each set alone, and H1's emitted features
    agree bitwise; one launch of the new kernel a call, none of H1."""
    assert sa.features_stream_fits(D, F)
    a = _rows(na, D, na + D, cuda_device)
    b = _rows(nb, D, nb + D + 1, cuda_device)
    proj = _proj(D, F, F, cuda_device)
    sa.reset_launch_counts()
    ga, gb = sa.transform_features(a, b, proj)
    ga1, none = sa.transform_features(a, None, proj)
    gb1, _ = sa.transform_features(b, None, proj)
    torch.cuda.synchronize()
    assert none is None
    assert _launches() == (3, 0)
    ref_a, ref_b = _h1_features(a, proj), _h1_features(b, proj)
    torch.cuda.synchronize()
    assert ga.shape == (na, F) and gb.shape == (nb, F)
    assert torch.equal(ga, ref_a) and torch.equal(gb, ref_b)
    assert torch.equal(ga1, ref_a) and torch.equal(gb1, ref_b)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,D", [(900, 900), (1, 900), (901, 901)])
def test_a_view_into_a_larger_array(cuda_device, offset, D):
    """Rows that start ``offset`` floats into their storage: one row in at
    D = 900 (16-byte aligned: TMA boxes), one float in (4 bytes off: the
    producer warp's cp.async) and one row in at D = 901."""
    n = 700
    flat = _rows(n + 2, D, 5, cuda_device).reshape(-1)
    a = flat[offset:offset + n * D].view(n, D)
    b = _rows(300, D, 6, cuda_device)
    assert a.is_contiguous() and (a.data_ptr() % 16 == 0) is (offset == 900)
    proj = _proj(D, 30, 7, cuda_device)
    ga, gb = sa.transform_features(a, b, proj)
    gb2, ga2 = sa.transform_features(b, a, proj)
    torch.cuda.synchronize()
    ref_a, ref_b = _h1_features(a, proj), _h1_features(b, proj)
    assert torch.equal(ga, ref_a) and torch.equal(gb, ref_b)
    assert torch.equal(ga2, ref_a) and torch.equal(gb2, ref_b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,F", [(900, 33), (901, 40)])
def test_just_past_the_rule_h1_transforms(cuda_device, D, F):
    """A shape the rule leaves out takes H1's features-only launch, one a
    set, with the same features."""
    assert not sa.features_stream_fits(D, F)
    a = _rows(400, D, 8, cuda_device)
    b = _rows(250, D, 9, cuda_device)
    proj = _proj(D, F, 10, cuda_device)
    sa.reset_launch_counts()
    ga, gb = sa.transform_features(a, b, proj)
    torch.cuda.synchronize()
    assert _launches() == (0, 2)
    assert torch.equal(ga, _h1_features(a, proj))
    assert torch.equal(gb, _h1_features(b, proj))


@pytest.mark.cuda
def test_empty_sets_launch_nothing(cuda_device):
    proj = _proj(900, 30, 11, cuda_device)
    empty = torch.empty((0, 900), device=cuda_device)
    sa.reset_launch_counts()
    ga, gb = sa.transform_features(empty, empty, proj)
    assert ga.shape == gb.shape == (0, 30) and _launches() == (0, 0)
    b = _rows(40, 900, 12, cuda_device)
    ga, gb = sa.transform_features(empty, b, proj)
    torch.cuda.synchronize()
    assert ga.shape == (0, 30) and _launches() == (1, 0)
    assert torch.equal(gb, _h1_features(b, proj))


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a = _rows(8, 900, 13, cuda_device)
    proj = _proj(900, 30, 14, cuda_device)
    with pytest.raises(TypeError):
        sa.transform_features(a.double(), None, proj)
    with pytest.raises(ValueError):
        sa.transform_features(a, None, proj[:-1])
    with pytest.raises(ValueError):
        sa.transform_features(a, _rows(8, 901, 15, cuda_device), proj)
    with pytest.raises(ValueError):
        sa.transform_features(a.t(), None, proj)
    with pytest.raises(ValueError):
        sa.transform_features(a, None, proj.cpu())
