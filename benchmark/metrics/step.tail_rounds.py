"""``step.tail_rounds``: the steady-state tail's extra squarings (rounds
taken after the fixed ones while the residual exceeds ``tol``) per traced
replay of ``drivers/hot_step_tail.py``'s traced phase: the traced graph's
device counter (``msm_we_tpu_torch/_graph.py``, ``counts["tail_rounds"]``)
over the replays. Nothing where the program kept no such counter."""


def read(rec):
    return (rec.get("tail") or {}).get("rounds")
