"""``build.ingest_s``, the layer ingest (``data/``, ``model.initialize``):
the mean over the window's builds of the seconds of the stages "Model
initialization", "Loading iterations" and "Loading coordinates"
(``model.stage_timings``, host clock)."""

STAGES = ("Model initialization", "Loading iterations", "Loading coordinates")


def read(rec):
    builds = rec.get("build_stages")
    if not builds:
        return None
    return sum(sum(s for n, s in b if n in STAGES) for b in builds) / len(builds)
