"""``step.tail_roofline_pct``: the least time of the steady-state tail's
work as a share of its device time (``step.tail_device_ms``).

The work: each squaring the tail took, the fixed ones and the extra rounds
of a traced replay (``step.tail_rounds``), is one product of two S x S
matrices, ``2 S^3`` operations, which reads its operand and writes its
product, ``2 S^2`` float64 numbers. The least time is the larger of the
operations over the card's float64 peak and the bytes over its HBM
bandwidth (``peaks.json``). The transition matrix, the stationary vectors
and the target flux are left out, so the share is an upper bound of the
squarings' own. A card without a float64 peak here gives nothing.
"""

F64 = 8
# Float64 peak of the card's tensor cores, operations a second: NVIDIA H100
# Tensor Core GPU data sheet, SXM5: 67 TFLOP/s FP64 Tensor Core, at the
# 700 W power limit
FP64_FLOPS_PER_S = {"NVIDIA H100 80GB HBM3": 67e12}


def work(n_states, squarings):
    """``(bytes, operations)`` of ``squarings`` squarings of an
    ``n_states`` x ``n_states`` float64 matrix."""
    S = n_states
    return squarings * 2 * S * S * F64, squarings * 2 * S ** 3


def read(rec):
    tail = rec.get("tail") or {}
    kind = rec.get("device_kind")
    peak = rec.get("peaks", {}).get(kind)
    flops = FP64_FLOPS_PER_S.get(kind)
    ms, rounds = tail.get("device_ms"), tail.get("rounds")
    if not ms or rounds is None or not peak or not flops:
        return None
    nbytes, ops = work(tail["n_states"], tail["fixed_squarings"] + rounds)
    least_s = max(nbytes / peak["hbm_bytes_per_s"], ops / flops)
    return 100.0 * least_s / (ms / 1e3)
