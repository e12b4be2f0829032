"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: numpy problems converted to torch tensors, and the near-tie-aware
id comparison.

Both packages get the same numpy inputs. Cluster ids must be equal except
at near-ties, where both chosen centers score within f32 rounding of the
f64 minimum (``msm_we_tpu_torch.testing.near_tie_rows``); override states
(basis/target) must always be equal.
"""
import numpy as np
import torch

from msm_we_tpu_torch.testing import near_tie_rows

TORCH_DTYPES = dict(
    fp=torch.float32, fc=torch.float32, raw_p=torch.float32,
    raw_c=torch.float32, pbins=torch.int32, cbins=torch.int32,
    basis_p=torch.bool, basis_c=torch.bool, target_p=torch.bool,
    target_c=torch.bool, w=None, centers=torch.float32,
    center_bin=torch.int32, valid=torch.bool, mean=torch.float32,
    proj=torch.float32,
)


def tt(a, dtype=None, device="cpu"):
    """numpy -> contiguous torch tensor (dtype kept unless given)."""
    t = torch.tensor(np.asarray(a))  # a copy: inputs may be read-only
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def to_torch(problem, device="cpu"):
    """Every array of a problem dict as a tensor with the kernels' dtypes."""
    out = {}
    for k, v in problem.items():
        if isinstance(v, np.ndarray):
            out[k] = tt(v, TORCH_DTYPES.get(k), device)
        else:
            out[k] = v
    return out


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_ids_match(ids_port, ids_ref, X, bins, centers, center_bin, valid,
                     n_regular=None, c2=None, raw=None, proj=None,
                     max_ties=None):
    """Ids equal except at near-ties between two regular centers. Returns
    the number of near-tie rows."""
    a = np_(ids_port).astype(np.int64)
    b = np_(ids_ref).astype(np.int64)
    assert a.shape == b.shape
    bad = np.flatnonzero(a != b)
    if not len(bad):
        return 0
    K = len(centers) if n_regular is None else n_regular
    assert (a[bad] < K).all() and (b[bad] < K).all(), (
        f"override ids disagree at rows {bad[:10]}"
    )
    ties = near_tie_rows(bad, a, b, None if X is None else np_(X), np_(bins),
                         np_(centers), np_(center_bin), np_(valid),
                         c2=None if c2 is None else np_(c2),
                         raw=None if raw is None else np_(raw),
                         proj=None if proj is None else np_(proj))
    assert ties.all(), f"rows {bad[~ties][:10]} differ and are not near-ties"
    if max_ties is not None:
        assert len(bad) <= max_ties
    return len(bad)
