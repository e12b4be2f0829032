"""``build.validation_s``, the layer validation
(``model.do_block_validation``): the mean over the window's builds of the
seconds of the stage "Cross-validation" (``model.stage_timings``, host
clock)."""

STAGES = ("Cross-validation",)


def read(rec):
    builds = rec.get("build_stages")
    if not builds:
        return None
    return sum(sum(s for n, s in b if n in STAGES) for b in builds) / len(builds)
