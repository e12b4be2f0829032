"""``build.steady_state_s``, the layer analysis tail (``ops/linalg.py``):
the mean over the window's builds of the seconds of the program's span
``steady_state`` (``linalg.steady_state_refined``: the eigensolve and the
inverse iteration), summed a build over the main model and every
validation group (``drivers/build_spans.py``, host clock). Nothing where
the program has no such span."""


def read(rec):
    vals = [b.get("steady_state") for b in rec.get("build_spans") or ()]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
