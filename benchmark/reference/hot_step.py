"""Plain reference of the hot step, and the judge of what the step produced.

The step: raw parent and child rows -> PCA transform (``(raw - mean) @
comp``) -> the nearest valid center of the row's WE bin -> basis/target
overrides -> flux matrix of the segment weights at (parent state, child
state) -> steady state of the recycled transition matrix and the flux into
the target. Plain PyTorch in float64, computed in row blocks; it imports
nothing of the program and takes only the generated inputs.

``Judge(problem, device)(out)`` holds one step's outputs (``pidx``,
``cidx``, ``fm``, ``pss``, ``flux``) to the reference:

* ``bad_ids``: rows whose id is not a valid center of the row's bin, or
  not the override state where an override applies (exact: limit 0);
* ``id_gap``: the widest gap, over the other rows, by which the chosen
  center's float64 squared distance lies above the nearest one's, as a
  share of the row's distance scale (rounding of the float32 step reads
  at about its epsilon; a lower precision reads far above);
* ``flux_err``: the largest cell gap between the step's flux matrix and
  the float64 sum of the weights at the step's ids (judged above), as a
  share of the total weight;
* ``pss_err`` and ``target_flux_err``: the L1 gap of the steady state and
  the relative gap of the target flux against the float64 tail of that
  flux matrix.

``solve(problem, device, tf32=...)`` is the step itself in plain PyTorch;
with ``tf32`` it is the control, one precision below the float32 (TF32
off) that the configuration states: every matrix product rounds its
operands to TF32 (10 mantissa bits, float32 accumulation), and the flux,
a sum and no product, is summed in bfloat16.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Judge", "solve", "steady_state", "transition_matrix"]

N_ITERS = 512
TOL = 1e-6
MAX_EXTRA_SQUARINGS = 16
ROW_BLOCK = 8192


def _tf32(x):
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _mm(a, b, tf32):
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


def transition_matrix(fm, basis_mask, target_mask):
    """Row-normalized flux; a state with no outflux stays put; a target
    state recycles uniformly into the basis states."""
    S = fm.shape[0]
    out = fm.sum(1)
    T = torch.zeros_like(fm)
    pos = out > 0
    T[pos] = fm[pos] / out[pos, None]
    idle = torch.nonzero(~pos).flatten()
    T[idle, idle] = 1.0
    recycle = basis_mask.to(fm.dtype) / basis_mask.sum().clamp(min=1)
    T[target_mask] = recycle
    return T.reshape(S, S)


def steady_state(fm, basis_mask, target_mask, tf32=False):
    """``p0 T^n`` from the uniform ``p0``, ``n = 2^ceil(log2 512)`` by
    repeated squaring (rows renormalized), then up to 16 more squarings
    while ``||p T - p||_1 > 1e-6``; and the flux into the target states.
    Returns ``(p, flux)``."""
    T = transition_matrix(fm, basis_mask, target_mask)
    S = T.shape[0]

    def square(M):
        M = _mm(M, M, tf32)
        return M / M.sum(1, keepdim=True).clamp(min=1e-30)

    def stationary(M):
        p = _mm(torch.full((1, S), 1.0 / S, dtype=T.dtype, device=T.device), M,
                tf32)[0]
        p = p / p.sum().clamp(min=1e-30)
        return p, float((_mm(p[None], T, tf32)[0] - p).abs().sum())

    Tn = T
    for _ in range(max(math.ceil(math.log2(max(N_ITERS, 2))), 1)):
        Tn = square(Tn)
    p, residual = stationary(Tn)
    extra = 0
    while residual > TOL and extra < MAX_EXTRA_SQUARINGS:
        Tn = square(Tn)
        p, residual = stationary(Tn)
        extra += 1
    flux = (p[:, None] * T[:, target_mask]).sum()
    return p, flux


def _state_masks(S, device):
    ids = torch.arange(S, device=device)
    return ids == S - 2, ids == S - 1


def _rows(problem, device, dtype):
    """Each side's raw rows, bins and override states, on ``device``:
    ``[(raw, bins, forced)]`` for parents then children, ``forced`` the
    override state of each row or -1 (parents: basis; children: target,
    then basis, which wins)."""
    p = problem
    S = int(p["n_states"])
    B, T = S - 2, S - 1

    def t(x, dt=None):
        return torch.as_tensor(x, device=device, dtype=dt)

    forced_p = torch.where(t(p["basis_p"]), B, -1)
    forced_c = torch.where(t(p["target_c"]), T, -1)
    forced_c = torch.where(t(p["basis_c"]), B, forced_c)
    return [(t(p["raw_parent"], dtype), t(p["pbins"], torch.int64), forced_p),
            (t(p["raw_child"], dtype), t(p["cbins"], torch.int64), forced_c)]


def _features(raw, problem, device, dtype, tf32=False):
    mean = torch.as_tensor(problem["mean"], device=device, dtype=dtype)
    comp = torch.as_tensor(problem["comp"], device=device, dtype=dtype)
    return torch.cat([_mm(raw[i:i + ROW_BLOCK] - mean, comp, tf32)
                      for i in range(0, len(raw), ROW_BLOCK)])


def _flux(pidx, cidx, w, S):
    flat = pidx.long() * S + cidx.long()
    fm = torch.zeros(S * S, dtype=w.dtype, device=w.device)
    return fm.index_add_(0, flat, w).reshape(S, S)


def solve(problem, device="cpu", tf32=False):
    """The hot step in plain PyTorch: float64, or with ``tf32`` float32
    with TF32 products (the control). Returns the step's outputs."""
    dtype = torch.float32 if tf32 else torch.float64
    S = int(problem["n_states"])
    C = torch.as_tensor(problem["centers"], device=device, dtype=dtype)
    cb = torch.as_tensor(problem["center_bin"], device=device, dtype=torch.int64)
    valid = torch.as_tensor(problem["valid"], device=device)
    c2 = (C * C).sum(1)
    ids = []
    for raw, bins, forced in _rows(problem, device, dtype):
        X = _features(raw, problem, device, dtype, tf32)
        out = []
        for i in range(0, len(X), ROW_BLOCK):
            x, b = X[i:i + ROW_BLOCK], bins[i:i + ROW_BLOCK]
            d = c2[None, :] - 2.0 * _mm(x, C.T, tf32)
            d = torch.where(valid[None, :] & (cb[None, :] == b[:, None]), d,
                            torch.inf)
            out.append(d.argmin(1))
        ids.append(torch.where(forced >= 0, forced, torch.cat(out)))
    pidx, cidx = ids
    if tf32:
        w = torch.as_tensor(problem["w"], device=device, dtype=torch.bfloat16)
        fm = _flux(pidx, cidx, w, S).to(dtype)
    else:
        w = torch.as_tensor(problem["w"], device=device, dtype=dtype)
        fm = _flux(pidx, cidx, w, S)
    basis, target = _state_masks(S, device)
    pss, flux = steady_state(fm, basis, target, tf32=tf32)
    return dict(pidx=pidx, cidx=cidx, fm=fm, pss=pss, flux=flux)


class Judge:
    """The float64 reference of one problem, judging step outputs."""

    def __init__(self, problem, device="cpu"):
        f64 = torch.float64
        self.device = device
        self.S = int(problem["n_states"])
        self.C = torch.as_tensor(problem["centers"], device=device, dtype=f64)
        self.cb = torch.as_tensor(problem["center_bin"], device=device,
                                  dtype=torch.int64)
        self.valid = torch.as_tensor(problem["valid"], device=device)
        self.sides = [(_features(raw, problem, device, f64), bins, forced)
                      for raw, bins, forced in _rows(problem, device, f64)]
        self.w = torch.as_tensor(problem["w"], device=device, dtype=f64)
        self.basis, self.target = _state_masks(self.S, device)

    def _ids(self, X, bins, forced, ids):
        """(bad rows, widest relative gap) of the ids of one side."""
        K = len(self.C)
        c2 = (self.C * self.C).sum(1)
        cn = c2.sqrt()
        bad, gap = 0, 0.0
        for i in range(0, len(X), ROW_BLOCK):
            x, b = X[i:i + ROW_BLOCK], bins[i:i + ROW_BLOCK]
            f, got = forced[i:i + ROW_BLOCK], ids[i:i + ROW_BLOCK].long()
            x2 = (x * x).sum(1)
            cand = self.valid[None, :] & (self.cb[None, :] == b[:, None])
            d = x2[:, None] + c2[None, :] - 2.0 * (x @ self.C.T)
            d = torch.where(cand, d, torch.inf)
            free = f < 0
            in_bank = (got >= 0) & (got < K)
            safe = got.clamp(0, K - 1)
            ok = torch.where(free, in_bank & cand.gather(1, safe[:, None])[:, 0],
                             got == f)
            bad += int((~ok).sum())
            judged = free & ok
            if judged.any():
                dj = d[judged]
                scale = (x2[judged]
                         + torch.where(cand[judged], c2[None, :], 0).amax(1)
                         + 2.0 * x2[judged].sqrt()
                         * torch.where(cand[judged], cn[None, :], 0).amax(1))
                chosen = dj.gather(1, safe[judged][:, None])[:, 0]
                gap = max(gap, float(((chosen - dj.amin(1)) / scale).max()))
        return bad, gap

    def __call__(self, out):
        dev = self.device
        pidx = torch.as_tensor(out["pidx"], device=dev)
        cidx = torch.as_tensor(out["cidx"], device=dev)
        bad, gap = 0, 0.0
        for (X, bins, forced), ids in zip(self.sides, (pidx, cidx)):
            b, g = self._ids(X, bins, forced, ids)
            bad, gap = bad + b, max(gap, g)
        S = self.S
        if bad:
            # The flux of ids that are not states cannot be judged
            nan = float("nan")
            return dict(bad_ids=bad, id_gap=gap, flux_err=nan, pss_err=nan,
                        target_flux_err=nan)
        fm_ref = _flux(pidx, cidx, self.w, S)
        fm = torch.as_tensor(out["fm"], device=dev).to(torch.float64)
        flux_err = float((fm - fm_ref).abs().max() / self.w.sum())
        p_ref, j_ref = steady_state(fm_ref, self.basis, self.target)
        p = torch.as_tensor(out["pss"], device=dev).to(torch.float64)
        j = float(torch.as_tensor(out["flux"]).double())
        return dict(bad_ids=bad, id_gap=gap, flux_err=flux_err,
                    pss_err=float((p - p_ref).abs().sum()),
                    target_flux_err=abs(j - float(j_ref)) / abs(float(j_ref)))
