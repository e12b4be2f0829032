"""``build.clean_s``, the layer flux and cleaning (``fluxmatrix.py``,
``cleaning.py``): the mean over the window's builds of the seconds of the
program's span ``clean`` (``cleaning.organize_flux_cleaning``: connected
sets, removal and re-discretisation), summed a build over the main model
and every validation group (``drivers/build_spans.py``, host clock).
Nothing where the program has no such span."""


def read(rec):
    vals = [b.get("clean") for b in rec.get("build_spans") or ()]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
