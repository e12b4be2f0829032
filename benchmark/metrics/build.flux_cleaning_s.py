"""``build.flux_cleaning_s``, the layer flux and cleaning (``fluxmatrix.py``,
``cleaning.py``): the mean over the window's builds of the seconds of the
stages "Flux matrix" and "Cleaning" (``model.stage_timings``, host clock)."""

STAGES = ("Flux matrix", "Cleaning")


def read(rec):
    builds = rec.get("build_stages")
    if not builds:
        return None
    return sum(sum(s for n, s in b if n in STAGES) for b in builds) / len(builds)
