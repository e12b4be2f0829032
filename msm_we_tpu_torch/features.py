"""Featurization engine: streaming reduction, the WE-continuity dedup, and
the device-resident feature arrays.

Counterpart of ``msm_we_tpu/features.py`` (``FeatureSet``,
``StreamingReducer``, ``featurize_all``, ``featurize_dedup``,
``device_row_feats``); ``mesh_row_feats`` gives a rank of a mesh its row
block. Host featurization is numpy and
unchanged, so the port's features are bitwise those of the JAX package.
Under WE continuity the parent features are a recipe (a gather of child
rows plus directly featurized fallback rows); the device copy of the
parent array is built by a gather on the device from the child upload.
"""
from __future__ import annotations

import numpy as np
import torch

from ._logging import log
from .tracing import count, span


def _pad_rows_to(a, n_pad, fill):
    """Pad an array to ``n_pad`` rows with ``fill`` (padding rows must be
    inert wherever they are consumed: weight 0, bin -1, masks False)."""
    n = len(a)
    if n_pad == n:
        return a
    out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
    out[:n] = a
    return out


class FeatureSet(dict):
    """Concatenated per-segment feature arrays (see ``modelWE._featurize_all``).

    Under the continuity dedup the parent feature array is redundant with
    the child array: parent row ``i`` is a bit-copy of child row ``src[i]``
    (WE continuity), except for a few directly-featurized *fallback* rows
    (iteration 1 and recycled segments). This class stores that recipe
    instead of the materialized array: host consumers that index
    ``feats["parent"]`` trigger a one-time materialization, subset
    consumers use :meth:`parent_rows` (no full gather), and the device
    pipeline (``modelWE._device_row_feats``) performs the gather on-device
    from the child upload, so large builds pay neither the host gather nor
    a second feature upload.
    """

    def __init__(self, *args, parent_src=None, parent_fb_rows=None,
                 parent_fb_feats=None, **kw):
        super().__init__(*args, **kw)
        # Recipe: parent[i] = child[parent_src[i]] where parent_src[i] >= 0;
        # rows with parent_src[i] < 0 appear in parent_fb_rows (sorted
        # ascending) with their directly-featurized values in parent_fb_feats
        self._parent_src = parent_src
        self._parent_fb_rows = parent_fb_rows
        self._parent_fb_feats = parent_fb_feats

    @property
    def parent_is_lazy(self):
        return dict.__getitem__(self, "parent") is None

    def __getitem__(self, key):
        val = dict.__getitem__(self, key)
        if val is None and key == "parent":
            val = self.parent_rows()
            # Keep the recipe: the device path still prefers the on-device
            # gather even after a host consumer forced materialization
            dict.__setitem__(self, "parent", val)
        return val

    # Accessors that would otherwise leak the raw None placeholder
    # materialize first. (Plain ``dict(fs)`` bypasses all overrides via
    # CPython's fast path and is not interceptable -- use ``fs.copy()``.)
    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __reduce__(self):
        # Custom pickling: dict-subclass pickling walks obj.items(), which
        # (overridden below) would materialize the lazy parent and bloat
        # the pickle with a redundant array; ship the recipe instead
        return (
            _featureset_unpickle,
            (
                dict.copy(self),
                self._parent_src,
                self._parent_fb_rows,
                self._parent_fb_feats,
            ),
        )

    def _materialized(self):
        if self.parent_is_lazy:
            self["parent"]
        return self

    def items(self):
        return dict.items(self._materialized())

    def values(self):
        return dict.values(self._materialized())

    def copy(self):
        return FeatureSet(
            dict.copy(self._materialized()),
            parent_src=self._parent_src,
            parent_fb_rows=self._parent_fb_rows,
            parent_fb_feats=self._parent_fb_feats,
        )

    def parent_rows(self, rows=None):
        """Parent feature rows without materializing the full array.

        ``rows``: integer indices, a boolean mask, or None for all rows."""
        parent = dict.__getitem__(self, "parent")
        if parent is not None:
            return parent if rows is None else parent[rows]
        child = dict.__getitem__(self, "child")
        src = self._parent_src
        fbr = self._parent_fb_rows
        fbv = self._parent_fb_feats
        if rows is None:
            out = child[np.maximum(src, 0)]
            if len(fbr):
                out[fbr] = fbv
            return out
        rows = np.asarray(rows)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        rows = rows.astype(np.int64, copy=False)
        out = child[np.maximum(src[rows], 0)]
        if len(fbr):
            pos = np.minimum(np.searchsorted(fbr, rows), len(fbr) - 1)
            hit = fbr[pos] == rows
            if hit.any():
                out[hit] = fbv[pos[hit]]
        return out


def _featureset_unpickle(d, src, fbr, fbv):
    return FeatureSet(d, parent_src=src, parent_fb_rows=fbr, parent_fb_feats=fbv)


def _feat_parent_rows(feats, rows):
    """Subset of parent feature rows; avoids full materialization for
    :class:`FeatureSet`, falls back to plain indexing for legacy dicts."""
    if isinstance(feats, FeatureSet):
        return feats.parent_rows(rows)
    return feats["parent"][rows]


class StreamingReducer:
    """Buffer raw frames and flush fixed-size chunks through a reduce fn.

    Keeps only the small reduced features resident -- raw coordinates
    never accumulate beyond one chunk (the streaming design of SURVEY.md
    P4; for production systems the raw set can be orders of magnitude
    larger than host RAM).
    """

    def __init__(self, reduce_fn, chunk):
        self.reduce_fn = reduce_fn
        self.chunk = chunk
        self.buf = []
        self.buffered = 0
        self.out = []

    def add(self, coords):
        # Drain directly from the incoming block: the previous
        # append-concatenate-split loop re-copied the whole buffered
        # tail once per flushed chunk (~0.5 GB of pure copies per 2M-
        # segment featurization pass). Only the sub-chunk remainder is
        # ever buffered (copied, so the big source block can be freed).
        pos = 0
        n = len(coords)
        if self.buffered:
            take = min(self.chunk - self.buffered, n)
            if self.buffered + take < self.chunk:
                if take:
                    # Copy: a view would pin the whole incoming block
                    self.buf.append(coords[:take].copy())
                    self.buffered += take
                return
            self.buf.append(coords[:take])
            self.out.append(
                np.asarray(self.reduce_fn(np.concatenate(self.buf)))
            )
            self.buf = []
            self.buffered = 0
            pos = take
        while n - pos >= self.chunk:
            self.out.append(
                np.asarray(self.reduce_fn(coords[pos : pos + self.chunk]))
            )
            pos += self.chunk
        if n - pos:
            self.buf = [coords[pos:].copy()]
            self.buffered = n - pos

    def finish(self):
        if self.buffered:
            block = np.concatenate(self.buf) if len(self.buf) > 1 else self.buf[0]
            if self.out:  # pad to the compiled chunk shape
                pad = np.zeros(
                    (self.chunk - len(block),) + block.shape[1:], block.dtype
                )
                padded = np.concatenate([block, pad])
                self.out.append(
                    np.asarray(self.reduce_fn(padded))[: len(block)]
                )
            else:
                self.out.append(np.asarray(self.reduce_fn(block)))
        self.buf = []
        return (
            np.concatenate(self.out)
            if self.out
            else np.zeros((0, 1), np.float32)
        )


def featurize_all(model, force=False):
    """Reduce every iteration's (parent, child) coords to features, once.

    Builds concatenated arrays over iterations 1..maxIter-1 (the
    discretizable range): features, pcoords, weights, per-iteration
    offsets. Raw coordinates stream through fixed-size chunks; NaN
    coordinates are zero-filled (their weight is already 0).

    With ``dedup_coordinates`` (default "auto"), parent features are
    gathered from the previous iteration's child features instead of
    re-read and re-featurized -- see :func:`featurize_dedup`. The work (not
    a cached return) is the span ``featurize``; it counts the parent rows
    it gathered (``parent_rows_gathered``) and projected
    (``parent_rows_projected``), and ``dedup_fallback`` where the gather's
    checks failed.
    """
    if model._features is not None and not force:
        return model._features
    return _featurize_all(model)


@span("featurize")
def _featurize_all(model):
    model._raw_bins_cache = None  # bins follow the feature arrays
    model._pc_masks_cache = None  # and so do the basis/target masks

    mode = getattr(model, "dedup_coordinates", "auto")
    use_dedup = mode is True or (
        mode == "auto"
        and model._dataset.check_continuity(last_iter=model.maxIter - 1)
    )
    if mode == "auto" and not use_dedup:
        log.debug(
            "Coordinate continuity does not hold for this dataset; "
            "featurizing parent frames directly."
        )
    if use_dedup:
        feats, failed = _featurize_dedup(model, verify=(mode == "auto"))
        if feats is not None:
            model._features = feats
            return feats
        count("dedup_fallback")
        log.warning(
            f"Gathered parent features did not bitwise-match directly "
            f"featurized ones at the {failed} (non-row-independent "
            "featurizer?); falling back to direct parent featurization."
        )

    red_parent = StreamingReducer(model.reduceCoordinates, model.FEATURE_CHUNK)
    red_child = StreamingReducer(model.reduceCoordinates, model.FEATURE_CHUNK)
    p0s, p1s, ws, iter_of = [], [], [], []
    offsets = [0]
    for iteration in range(1, model.maxIter):
        parent, child, weights = model._dataset.iter_coord_pairs(iteration)
        d = model._dataset.iter_data(iteration)
        red_parent.add(np.nan_to_num(parent, copy=False))
        red_child.add(np.nan_to_num(child, copy=False))
        p0s.append(d["pcoord0"])
        p1s.append(d["pcoord1"])
        ws.append(weights)
        iter_of.append(np.full(len(weights), iteration))
        offsets.append(offsets[-1] + len(weights))

    count("parent_rows_projected", offsets[-1])
    model._features = FeatureSet(
        parent=red_parent.finish().astype(np.float32),
        child=red_child.finish().astype(np.float32),
        pcoord0=np.concatenate(p0s),
        pcoord1=np.concatenate(p1s),
        weights=np.concatenate(ws),
        iteration=np.concatenate(iter_of),
        offsets=np.array(offsets),
    )
    return model._features


def featurize_dedup(model, verify=True):
    """Featurize with the WE-continuity dedup: child frames only are read
    and reduced; parent features are *gathered* from the previous
    iteration's child features (a segment's frame 0 is a bit-copy of its
    parent's final frame). Direct frame-0 reads remain only for
    iteration 1 and recycled (parent_id < 0) segments.

    Halves coordinate I/O and ``processCoordinates``/transform work vs
    the reference, which reads and featurizes both frames of every
    segment (``_data.py:254-313``). With ``verify``, a sample of gathered
    rows is re-featurized directly from their own frame-0 coords and must
    match bitwise; returns None on mismatch (caller falls back).
    """
    return _featurize_dedup(model, verify)[0]


def _featurize_dedup(model, verify):
    """:func:`featurize_dedup`'s ``(features, None)``, or ``(None, check)``
    naming the check that failed: ``"pre-flight"`` (a block's first rows
    featurized alone) or ``"sample"`` (gathered rows featurized from their
    own frame 0)."""
    ds = model._dataset
    red_child = StreamingReducer(model.reduceCoordinates, model.FEATURE_CHUNK)
    p0s, p1s, ws, iter_of, nan_blocks = [], [], [], [], []
    offsets = [0]
    for iteration in range(1, model.maxIter):
        # consume=True: the nan_to_num below mutates the block in place, so
        # take ownership of any cached entry instead of sharing it
        child = ds._iter_frame_block(iteration, -1, consume=True)
        if verify and iteration == 1 and len(child) > 1:
            # Pre-flight fail-fast: a featurizer whose per-row output
            # depends on the rest of the batch (e.g. batch-mean
            # centering) breaks the gather. Catch it BEFORE the full
            # dedup pass, not only at the post-hoc sample check --
            # otherwise a doomed pass costs ~1.5x the direct path.
            # Bounded to one chunk: featurizing the whole block would
            # bypass the FEATURE_CHUNK streaming discipline (an extra
            # compile shape + a memory spike on large iterations)
            block = np.nan_to_num(child[: model.FEATURE_CHUNK])
            k = min(8, len(block))
            whole = np.asarray(model.reduceCoordinates(block))
            sub = np.asarray(model.reduceCoordinates(block[:k]))
            if not np.array_equal(whole[:k], sub):
                return None, "pre-flight"
        d = ds.iter_data(iteration)
        nan_blocks.append(np.isnan(child).any(axis=tuple(range(1, child.ndim))))
        # In-place NaN fill is safe: the block is a fresh h5 read, and
        # the NaN scan above already ran. Saves a full copy pass over
        # every raw coordinate per build (GBs for real MD data)
        red_child.add(np.nan_to_num(child, copy=False))
        p0s.append(d["pcoord0"])
        p1s.append(d["pcoord1"])
        # No copy needed: np.concatenate below always allocates, so the
        # later in-place zeroing never reaches the cached iter_data array
        ws.append(d["weights"])
        iter_of.append(np.full(d["n_segs"], iteration))
        offsets.append(offsets[-1] + d["n_segs"])

    child_feats = red_child.finish().astype(np.float32)
    offsets = np.array(offsets)
    child_nan = (
        np.concatenate(nan_blocks) if nan_blocks else np.zeros(0, bool)
    )

    # Accumulate one global source-index array, then gather once: 100+
    # small fancy-index copies have poor locality at millions of rows
    src_all = np.full(int(offsets[-1]), -1, np.int64)
    fallback = []  # (iteration, local_rows)
    for iteration in range(1, model.maxIter):
        d = ds.iter_data(iteration)
        base = offsets[iteration - 1]
        if iteration == 1:
            fb_local = np.arange(d["n_segs"])
        else:
            pg = d["parent_ids_global"]
            fb_local = np.flatnonzero(pg < 0)
            ga_local = np.flatnonzero(pg >= 0)
            if len(ga_local):
                src_all[base + ga_local] = offsets[iteration - 2] + pg[ga_local]
        if len(fb_local):
            fallback.append((iteration, fb_local))

    # Parent features stay a RECIPE (src gather + fallback rows) inside
    # the returned FeatureSet: the full host gather only happens if a
    # host consumer indexes feats["parent"]; the device pipeline gathers
    # on-device from the child upload instead. Only the cheap 1-D NaN
    # propagation is done eagerly here.
    gathered = np.flatnonzero(src_all >= 0)
    parent_nan = np.zeros(len(child_nan), bool)
    if len(gathered):
        parent_nan[gathered] = child_nan[src_all[gathered]]

    fb_rows_all = np.zeros(0, np.int64)
    fb_feats = np.zeros((0, child_feats.shape[1]), np.float32)
    if fallback:
        red_fb = StreamingReducer(model.reduceCoordinates, model.FEATURE_CHUNK)
        fb_nan, fb_rows = [], []
        for iteration, fb_local in fallback:
            raw = ds.iter_frame_subset(iteration, fb_local, 0)
            fb_nan.append(np.isnan(raw).any(axis=tuple(range(1, raw.ndim))))
            red_fb.add(np.nan_to_num(raw, copy=False))
            fb_rows.append(offsets[iteration - 1] + fb_local)
        # Iterations ascend and fb_local is sorted within each, so the
        # concatenation is globally sorted (parent_rows searchsorts it)
        fb_rows_all = np.concatenate(fb_rows).astype(np.int64)
        fb_feats = red_fb.finish().astype(np.float32)
        parent_nan[fb_rows_all] = np.concatenate(fb_nan)

    if verify and len(gathered):
        rng = np.random.default_rng(0)
        n_sample = min(256, len(gathered))
        sample = np.sort(rng.choice(gathered, n_sample, replace=False))
        sample_iter = np.searchsorted(offsets, sample, side="right")
        red_v = StreamingReducer(model.reduceCoordinates, model.FEATURE_CHUNK)
        for it in np.unique(sample_iter):
            rows_g = sample[sample_iter == it]
            raw = ds.iter_frame_subset(int(it), rows_g - offsets[it - 1], 0)
            red_v.add(np.nan_to_num(raw, copy=False))
        direct = red_v.finish().astype(np.float32)
        if not np.array_equal(direct, child_feats[src_all[sample]]):
            return None, "sample"

    # The NaN -> weight-0 convention (reference _data.py:303-313), with
    # parent NaN-ness propagated through the gather
    weights = np.concatenate(ws) if ws else np.zeros(0)
    bad = child_nan | parent_nan
    if bad.any():
        iter_all = np.concatenate(iter_of)
        for it in np.unique(iter_all[bad]):
            seg = np.flatnonzero(bad & (iter_all == it)) - offsets[it - 1]
            log.warning(
                f"Bad coordinates for segments {seg} in iteration {it}, "
                "setting weights to 0"
            )
        weights[bad] = 0.0

    count("parent_rows_gathered", len(gathered))
    count("parent_rows_projected", len(fb_rows_all))
    return FeatureSet(
        dict(
            parent=None,  # lazy: materialized from the recipe on demand
            child=child_feats,
            pcoord0=np.concatenate(p0s),
            pcoord1=np.concatenate(p1s),
            weights=weights,
            iteration=np.concatenate(iter_of),
            offsets=offsets,
        ),
        parent_src=src_all,
        parent_fb_rows=fb_rows_all,
        parent_fb_feats=fb_feats,
    ), None


def _device_parent_from_child(child_dev, feats):
    """The parent feature array built ON the device from the child upload
    and the :class:`FeatureSet` recipe (gather, then the fallback rows):
    no host gather, no second upload. Gather and copy move f32 bits
    exactly, so rows equal the host materialization."""
    dev = child_dev.device
    src = torch.as_tensor(np.maximum(feats._parent_src, 0), device=dev)
    parent = child_dev.index_select(0, src)
    fbr = feats._parent_fb_rows
    if len(fbr):
        parent[torch.as_tensor(fbr, device=dev)] = torch.as_tensor(
            feats._parent_fb_feats, device=dev
        )
    return parent


def device_row_feats(model, need_parent=True):
    """Device copies of the (parent, child) feature arrays on
    ``model.device``, shared by the clustering scan and the discretization
    (one upload per featurization). ``need_parent=False`` skips the parent
    array (the dedup discretization fast path never reads it); a later
    ``need_parent=True`` call fills it in from the cached child upload.
    The cache pins the feature dict it was built from."""
    feats = model._featurize_all()
    cache = getattr(model, "_dev_feats_cache", None)
    if cache is not None and cache[0] is feats:
        parent_dev, child_dev = cache[1]
        if parent_dev is not None or not need_parent:
            return cache[1]
    else:
        child_dev = torch.as_tensor(feats["child"], device=model.device)
    if not need_parent:
        parent_dev = None
    elif isinstance(feats, FeatureSet) and feats.parent_is_lazy:
        parent_dev = _device_parent_from_child(child_dev, feats)
    else:
        parent_dev = torch.as_tensor(feats["parent"], device=model.device)
    pair = (parent_dev, child_dev)
    model._dev_feats_cache = (feats, pair)
    return pair


def mesh_row_feats(model, mesh, need_parent=True):
    """This rank's row block of the (parent, child) feature arrays on the
    mesh's device (``Mesh.rows``: contiguous, zero-padded; the padded rows
    carry bin -1 wherever they are scored). With one data rank the block is
    every row: the arrays of :func:`device_row_feats`. With more, only the
    block is uploaded (its parent rows gathered on the host from the
    :class:`FeatureSet` recipe), cached per feature set and mesh."""
    if mesh.shape["data"] == 1:
        return device_row_feats(model, need_parent=need_parent)
    feats = model._featurize_all()
    cache = getattr(model, "_mesh_feats_cache", None)
    if cache is not None and cache[0] is feats and cache[1] is mesh:
        parent, child = cache[2]
        if parent is not None or not need_parent:
            return cache[2]
    else:
        parent, child = None, mesh.rows(feats["child"], 0.0)
    if need_parent:
        lo, hi, block = mesh.row_block(len(feats["child"]))
        parent = mesh.pad_block(_feat_parent_rows(feats, np.arange(lo, hi)),
                                block, 0.0)
    model._mesh_feats_cache = (feats, mesh, (parent, child))
    return parent, child
