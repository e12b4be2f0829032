"""``build.reduce_moments_s``, the layer reduction (``ops/pca.py``): the mean
over the window's builds of the seconds of the program's span
``reduce_moments`` (``modelWE.dimReduce``: the moments of every child
frame, as f32 products on the card from 256 features and summed in f64,
then the eigensolve), summed a build over its outermost occurrences
(``drivers/build_wide.py``, host clock). Nothing where the program has no
such span."""


def read(rec):
    vals = [b.get("reduce_moments") for b in rec.get("build_spans") or ()]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
