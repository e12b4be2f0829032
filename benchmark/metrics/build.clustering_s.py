"""``build.clustering_s``, the layer clustering and discretization
(``ops/stratified.py``, ``ops/kmeans.py``, ``discretization.py``,
``features.py``): the mean over the window's builds of the seconds of the
stage "Clustering" (``model.stage_timings``, host clock)."""

STAGES = ("Clustering",)


def read(rec):
    builds = rec.get("build_stages")
    if not builds:
        return None
    return sum(sum(s for n, s in b if n in STAGES) for b in builds) / len(builds)
