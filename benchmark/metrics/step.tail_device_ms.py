"""``step.tail_device_ms``: the device milliseconds of the hot step's
steady-state tail, the mean over the traced replays of
``drivers/hot_step_tail.py``'s traced phase: the interval between the
traced graph's event nodes where the tail starts and where the step ends
(``msm_we_tpu_torch/_graph.py``, ``device_ms["tail"]``). Nothing where the
program recorded no such interval."""


def read(rec):
    return (rec.get("tail") or {}).get("device_ms")
