"""``build.reduction_s``, the layer reduction (``ops/pca.py``): the mean over
the window's builds of the seconds of the stage "Dimensionality reduction"
(``model.stage_timings``, host clock)."""

STAGES = ("Dimensionality reduction",)


def read(rec):
    builds = rec.get("build_stages")
    if not builds:
        return None
    return sum(sum(s for n, s in b if n in STAGES) for b in builds) / len(builds)
