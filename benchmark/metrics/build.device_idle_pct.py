"""``build.device_idle_pct``: one minus the device's busy share of the
traced builds' wall time: the union of the device events' intervals in
the build's own ``torch.profiler`` trace (``tracing.profile_trace``, the
build's ``profile_dir``) over the host seconds the traced builds took."""


def read(rec):
    busy = rec.get("busy_s")
    wall = rec.get("traced_wall_s")
    if busy is None or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
