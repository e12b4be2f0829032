"""``build.parent_gathered_share``, the layer clustering and discretization
(``features.py``): the share, in percent, of the parent feature rows that
``features.featurize_all`` gathered from their parents' child rows rather
than projected from their own frames, over the profiled builds of a
``--trace 1`` run: ``parent_rows_gathered`` / (``parent_rows_gathered`` +
``parent_rows_projected``), the program's host counts under
``tracing.collect()`` (``drivers/build_wide.py``). Nothing where the program
kept no such count.

Higher is better: a gathered row costs no read of its frame and no
projection. The first iteration's and recycled walkers' parents are always
projected; a build whose bitwise checks of the gather fail projects every
parent row (0%)."""


def read(rec):
    builds = rec.get("trace_counts") or ()
    gathered = [b.get("parent_rows_gathered") for b in builds]
    projected = [b.get("parent_rows_projected") for b in builds]
    if not builds or None in projected:
        return None
    gathered = [g or 0 for g in gathered]
    if not sum(gathered) + sum(projected):
        return None
    return 100.0 * sum(gathered) / (sum(gathered) + sum(projected))
