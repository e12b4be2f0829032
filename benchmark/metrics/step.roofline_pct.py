"""``step.roofline_pct``: the least time the hot step's work needs, as a
share of the device's time of one step: CUDA events around steps queued
back to back behind a spin kernel, so that the host's time to queue a
step is not in it (``drivers/hot_step.py``, ``_device_step_ms``).

The count is of the work the inputs need, not of an implementation. Bytes:
each input read once (the raw rows, the PCA mean and components, the
centers, their bins and validity, the rows' bins, override masks and
weights) and each output written once (two ids a segment, the flux
matrix, the distribution); the steady-state tail counts as reading the
flux matrix once, since how many squarings it takes is the algorithm's
choice. Operations: the projection of every raw row (a multiply and an add
per raw feature and component) and the score of every (row, center of the
row's bin) pair that an override does not decide. The least time is the
larger of bytes over the HBM bandwidth and operations over the float32
peak of the card (``peaks.json``); a card the table lacks gives nothing.
"""

F32, I32, BOOL = 4, 4, 1


def work(s):
    """``(bytes, operations)`` of one step with the sizes ``s``: ``raw_rows``
    rows of ``n_raw`` features projected to ``n_components``,
    ``n_segments`` segments, ``n_centers`` centers, ``n_states`` states and
    ``scored_pairs`` same-bin (row, center) scores."""
    n, d, c = s["n_segments"], s["n_raw"], s["n_components"]
    k, S = s["n_centers"], s["n_states"]
    reads = (s["raw_rows"] * d * F32 + d * F32 + d * c * F32
             + k * (c * F32 + I32 + BOOL)
             + n * (2 * I32 + 3 * BOOL + F32)
             + S * S * F32)
    writes = n * 2 * I32 + S * S * F32 + S * F32
    ops = 2 * s["raw_rows"] * d * c + 2 * c * s["scored_pairs"]
    return reads + writes, ops


def read(rec):
    sizes = rec.get("roofline")
    step_ms = rec.get("device_step_ms")
    peak = rec.get("peaks", {}).get(rec.get("device_kind"))
    if not sizes or not step_ms or not peak:
        return None
    nbytes, ops = work(sizes)
    least_s = max(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_flops_per_s"])
    return 100.0 * least_s / (step_ms / 1e3)
