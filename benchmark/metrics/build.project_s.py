"""``build.project_s``, the layer reduction (``ops/pca.py``): the mean over
the window's builds of the seconds of the program's span ``project`` (each
``PCAModel.transform``: raw frames to PCA features, on the card by the
features kernel at 900 raw coordinates), summed a build over its outermost
occurrences, the featurization's chunks and its checks
(``drivers/build_wide.py``, host clock). Nothing where the program has no
such span."""


def read(rec):
    vals = [b.get("project") for b in rec.get("build_spans") or ()]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
