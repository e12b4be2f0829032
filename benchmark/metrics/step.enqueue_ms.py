"""``step.enqueue_ms``: the mean host time of a ``hot_step`` call without
its synchronise (the Python around the graph replay and the replay's
launch), over every step of the traced window."""


def read(rec):
    times = rec.get("enqueue_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
