"""``step.device_idle_pct``: the share of the traced window in which the
device ran no step: one minus the steps of the window times the device's
milliseconds of one step (``step.roofline_pct``'s denominator, from CUDA
events around steps queued back to back) over the window's seconds. What
is left is the host's part of each step: the Python around the replay,
its launch, and the synchronise's return."""


def read(rec):
    step_ms = rec.get("device_step_ms")
    window = rec.get("window_s")
    if not step_ms or not window:
        return None
    return 100.0 * (1.0 - rec["steps"] * step_ms / 1e3 / window)
