"""The port's west.h5 reader (``msm_we_tpu_torch.data.westh5.WEDataset``)
against the JAX package's on the same files, and its block cache and
prefetch thread held to the behaviours ``tests/test_prefetch_cache.py``
pins for the JAX package's reader.

The files come from the JAX package's ``generate_west_h5`` (seeded, in a
temporary directory); both readers must return bitwise equal arrays.
"""
import pickle
import sys
import threading
import time

import h5py
import numpy as np
import pytest

from msm_we_tpu.data import generate_west_h5 as jax_generate_west_h5
from msm_we_tpu.data.synthetic import SEG_INDEX_DTYPE as JAX_DTYPE
from msm_we_tpu.data.synthetic import SynthWESettings as JaxSettings
from msm_we_tpu.data.westh5 import WEDataset as JaxWEDataset
from msm_we_tpu_torch import WEDataset as ExportedWEDataset
from msm_we_tpu_torch.data import (
    SEG_INDEX_DTYPE,
    ArrayWEDataset,
    SynthWESettings,
    generate_we_arrays,
    generate_west_h5,
)
from msm_we_tpu_torch.data.westh5 import WEDataset

N_ITER, N_SEGS, SEED = 12, 16, 11
ITER_KEYS = ("weights", "parent_ids", "pcoord0", "pcoord1", "west_idx",
             "seg_idx", "n_segs", "parent_ids_global")
PAIR_KEYS = ("start", "end", "weights", "departure_weights", "start_pcoord",
             "warped", "anc")
BASIS = np.full((4, 3), 9.5)


def _same(a, b):
    """Bitwise equal arrays of one dtype and shape (NaN equal to NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.fixture(scope="module")
def h5path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_westh5") / "west.h5"
    jax_generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEGS, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_westh5_multi")
    paths = [str(d / "west1.h5"), str(d / "west2.h5")]
    jax_generate_west_h5(paths[0], n_iterations=N_ITER, n_segments=N_SEGS, seed=31)
    jax_generate_west_h5(paths[1], n_iterations=N_ITER, n_segments=10, seed=32)
    return paths


@pytest.fixture(scope="module")
def nan_file(tmp_path_factory):
    """Segments 2 (both frames) and 5 (frame 0 only) of iteration 4 have NaN
    coordinates."""
    path = str(tmp_path_factory.mktemp("torch_westh5_nan") / "west.h5")
    jax_generate_west_h5(path, n_iterations=N_ITER, n_segments=N_SEGS, seed=5)
    with h5py.File(path, "r+") as h5:
        coord = h5["iterations/iter_00000004/auxdata/coord"]
        block = coord[:]
        block[2] = np.nan
        block[5, 0, 1, 2] = np.nan
        coord[...] = block
    return path


def _files(name, h5path, two_files, nan_file):
    return {"one": [h5path], "two": two_files, "nan": [nan_file]}[name]


def test_reader_is_exported():
    assert ExportedWEDataset is WEDataset


@pytest.mark.parametrize("files", ["one", "two", "nan"])
def test_scan_and_iter_data_match_jax(files, h5path, two_files, nan_file):
    paths = _files(files, h5path, two_files, nan_file)
    ref, got = JaxWEDataset(paths), WEDataset(paths)
    assert got.maxIter == ref.maxIter == N_ITER
    assert got.max_segs == ref.max_segs
    _same(got.numSegments, ref.numSegments)
    assert got._iter_index == ref._iter_index
    assert got.pcoord_len is None
    for it in range(1, N_ITER + 1):
        a, b = got.iter_data(it), ref.iter_data(it)
        assert set(a) == set(b) == set(ITER_KEYS)
        for k in ITER_KEYS:
            _same(a[k], b[k])
        assert got.iter_data(it) is a  # cached
    assert got.pcoord_len == ref.pcoord_len == 2
    assert got.n_atoms_coord_ndim() == ref.n_atoms_coord_ndim() == (4, 3)
    with pytest.raises(KeyError, match="not present"):
        got.iter_data(N_ITER + 1)  # the incomplete last iteration
    if files == "two":
        d = got.iter_data(3)
        assert set(np.unique(d["west_idx"])) == {0, 1}
        assert (d["parent_ids_global"] != d["parent_ids"]).any()
    got.close()
    ref.close()


@pytest.mark.parametrize("files", ["one", "two", "nan"])
def test_coordinates_match_jax(files, h5path, two_files, nan_file):
    paths = _files(files, h5path, two_files, nan_file)
    ref, got = JaxWEDataset(paths), WEDataset(paths)
    for it in range(1, N_ITER + 1):
        for x, y in zip(got.iter_coord_pairs(it), ref.iter_coord_pairs(it)):
            _same(x, y)
        _same(got.iter_child_coords(it), ref.iter_child_coords(it))
        for frame in (0, -1):
            _same(got._iter_frame_block(it, frame), ref._iter_frame_block(it, frame))
        n = got.iter_data(it)["n_segs"]
        for rows in (np.arange(0, n, 3), [3, 0, 3, 7], np.arange(n)):
            for frame in (0, -1):
                _same(got.iter_frame_subset(it, rows, frame),
                      ref.iter_frame_subset(it, rows, frame))
    assert got.check_continuity() == ref.check_continuity()
    for kw in (dict(sample_per_iter=3, full_iters=1, seed=4, last_iter=N_ITER - 1),
               dict(sample_per_iter=100, full_iters=0, seed=0, last_iter=None)):
        assert (got._check_continuity_uncached(**kw)
                == ref._check_continuity_uncached(**kw))
    if files == "nan":
        _p, _c, w = got.iter_coord_pairs(4)
        assert w[2] == 0.0 and w[5] == 0.0 and (np.delete(w, [2, 5]) > 0).all()
        assert len(got.iter_child_coords(4)) == got.iter_data(4)["n_segs"] - 1
    got.close()
    ref.close()


@pytest.mark.parametrize("lag", [0, 1, 2])
@pytest.mark.parametrize("files", ["one", "two", "nan"])
def test_transition_pairs_and_ancestors_match_jax(files, lag, h5path, two_files,
                                                  nan_file):
    paths = _files(files, h5path, two_files, nan_file)
    ref, got = JaxWEDataset(paths), WEDataset(paths)
    for it in range(lag + 1, N_ITER + 1):
        for x, y in zip(got.ancestor_ids(it, lag), ref.ancestor_ids(it, lag)):
            _same(x, y)
        a = got.iter_transition_pairs(it, lag, basis_coords=BASIS)
        b = ref.iter_transition_pairs(it, lag, basis_coords=BASIS)
        assert set(a) == set(b) == set(PAIR_KEYS)
        for k in PAIR_KEYS:
            _same(a[k], b[k])
    with pytest.raises(ValueError, match="no ancestry"):
        got.ancestor_ids(2, 2)
    if lag:
        warped_iter = next(
            it for it in range(lag + 1, N_ITER + 1)
            if got.ancestor_ids(it, lag)[1].any()
        )
        with pytest.raises(ValueError, match="basis_coords is required"):
            got.iter_transition_pairs(warped_iter, lag)
    got.close()
    ref.close()


def test_reader_matches_array_dataset(tmp_path):
    """One run through the file and in memory: the two datasets of the port
    agree member by member."""
    path = generate_west_h5(str(tmp_path / "w.h5"), n_iterations=8, n_segments=12,
                            seed=3)
    h5, mem = WEDataset([path]), ArrayWEDataset(generate_we_arrays(8, 12, seed=3))
    assert h5.maxIter == mem.maxIter == 8
    _same(h5.numSegments, mem.numSegments)
    for it in range(1, 9):
        a, b = h5.iter_data(it), mem.iter_data(it)
        for k in ITER_KEYS:
            _same(a[k], b[k])
        for x, y in zip(h5.iter_coord_pairs(it), mem.iter_coord_pairs(it)):
            _same(x, y)
    for it in range(3, 9):
        a = h5.iter_transition_pairs(it, 2, basis_coords=BASIS)
        b = mem.iter_transition_pairs(it, 2, basis_coords=BASIS)
        for k in PAIR_KEYS:
            _same(a[k], b[k])
    assert h5.check_continuity() is mem.check_continuity() is True
    h5.close()


@pytest.mark.parametrize("kwargs", [
    dict(n_iterations=6, n_segments=9, seed=4),
    dict(n_iterations=5, n_segments=7, seed=2, warmup=3),
    dict(settings=dict(n_iterations=5, n_segments=8, seed=1, pcoord_len=3,
                       pcoord_ndim=2)),
])
def test_generate_west_h5_matches_jax(tmp_path, kwargs):
    assert SEG_INDEX_DTYPE == JAX_DTYPE
    a, b = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    if "settings" in kwargs:
        assert generate_west_h5(a, settings=SynthWESettings(**kwargs["settings"])) == a
        jax_generate_west_h5(b, settings=JaxSettings(**kwargs["settings"]))
    else:
        assert generate_west_h5(a, **kwargs) == a
        jax_generate_west_h5(b, **kwargs)
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert dict(fa.attrs) == dict(fb.attrs)
        assert list(fa["iterations"]) == list(fb["iterations"])
        for name in fa["iterations"]:
            for ds in ("seg_index", "pcoord", "auxdata/coord"):
                _same(fa[f"iterations/{name}/{ds}"][...],
                      fb[f"iterations/{name}/{ds}"][...])
    with pytest.raises(ValueError, match="not both"):
        generate_west_h5(a, n_iterations=3, settings=SynthWESettings())


def test_pcoord_ndim_clipping_warning_and_error(tmp_path, caplog):
    path = str(tmp_path / "w2.h5")
    jax_generate_west_h5(path, settings=JaxSettings(
        n_iterations=6, n_segments=8, seed=1, pcoord_ndim=2))
    full, ref = WEDataset([path], pcoord_ndim=2), JaxWEDataset([path], pcoord_ndim=2)
    clipped = WEDataset([path], pcoord_ndim=1)
    from msm_we_tpu_torch._logging import log

    log.propagate = True
    try:
        with caplog.at_level("WARNING"):
            for it in (1, 2, 3):
                d = clipped.iter_data(it)
                assert d["pcoord0"].shape == (d["n_segs"], 1)
                _same(d["pcoord1"], full.iter_data(it)["pcoord1"][:, :1])
                _same(full.iter_data(it)["pcoord0"], ref.iter_data(it)["pcoord0"])
    finally:
        log.propagate = False
    warned = [r for r in caplog.records if "loading only the first 1" in r.getMessage()]
    assert len(warned) == 1  # once a dataset, not once an iteration
    with pytest.raises(ValueError, match="only 2 dims but pcoord_ndim=3"):
        WEDataset([path], pcoord_ndim=3).iter_data(1)
    for ds in (full, ref, clipped):
        ds.close()


def test_seg_index_without_parent_id_name_uses_field_1(tmp_path):
    path = str(tmp_path / "w.h5")
    jax_generate_west_h5(path, n_iterations=4, n_segments=6, seed=2)
    want = JaxWEDataset([path]).iter_data(2)["parent_ids"]
    renamed = np.dtype([(("parent" if n == "parent_id" else n), SEG_INDEX_DTYPE[n])
                        for n in SEG_INDEX_DTYPE.names])
    with h5py.File(path, "r+") as h5:
        for name in h5["iterations"]:
            g = h5[f"iterations/{name}"]
            data = g["seg_index"][...].astype(SEG_INDEX_DTYPE).view(renamed)
            del g["seg_index"]
            g.create_dataset("seg_index", data=data)
    got, ref = WEDataset([path]), JaxWEDataset([path])
    np.testing.assert_array_equal(got.iter_data(2)["parent_ids"], want)
    np.testing.assert_array_equal(ref.iter_data(2)["parent_ids"], want)
    got.close()
    ref.close()


@pytest.mark.parametrize("how", ["pickle", "deepcopy"])
def test_copies_drop_handles_locks_threads_and_blocks(h5path, how):
    import copy

    ds = WEDataset([h5path])
    ds.start_prefetch(N_ITER)
    ds.iter_coord_pairs(2)
    assert ds._open_handles
    state = ds.__getstate__()
    assert state["_open_handles"] == {} and state["_dset_cache"] == {}
    assert state["_block_cache"] is None and state["_io_lock"] is None
    assert state["_prefetch_thread"] is None and state["_prefetch_stop"] is None
    new = pickle.loads(pickle.dumps(ds)) if how == "pickle" else copy.deepcopy(ds)
    assert new is not ds and new._open_handles == {}
    assert new._prefetch_thread is None and new._block_cache is None
    assert new._io_lock is not ds._io_lock
    for x, y in zip(new.iter_coord_pairs(3), ds.iter_coord_pairs(3)):
        _same(x, y)
    assert new._open_handles and new._open_handles[0] is not ds._open_handles[0]
    for d in (ds, new):
        d.close()
        assert d._prefetch_thread is None


def test_close_then_lazy_reopen(h5path):
    ds = WEDataset([h5path])
    before = [np.array(x) for x in ds.iter_coord_pairs(2)]
    handle = ds._open_handles[0]
    ds.close()
    assert ds._open_handles == {} and ds._dset_cache == {} and not handle.id.valid
    with h5py.File(h5path, "r+"):
        pass  # a writer can open the file once the reader's handles are closed
    for x, y in zip(ds.iter_coord_pairs(2), before):
        _same(x, y)
    assert ds._open_handles[0].id.valid
    ds.close()


def test_continuity_memo_is_keyed_by_file_identity(tmp_path):
    from msm_we_tpu_torch.data import westh5

    path = str(tmp_path / "w.h5")
    jax_generate_west_h5(path, n_iterations=6, n_segments=8, seed=9)
    ds = WEDataset([path])
    n_before = len(westh5._continuity_memo)
    assert ds.check_continuity() is True
    assert len(westh5._continuity_memo) == n_before + 1
    assert WEDataset([path]).check_continuity() is True  # served from the memo
    assert len(westh5._continuity_memo) == n_before + 1
    ds.close()
    # A rewritten file is checked again, and now fails
    time.sleep(0.01)
    with h5py.File(path, "r+") as h5:
        coord = h5["iterations/iter_00000003/auxdata/coord"]
        block = coord[:]
        block[:, 0] += 1.0
        coord[...] = block
    broken = WEDataset([path])
    assert broken.check_continuity() is False
    assert JaxWEDataset([path]).check_continuity() is False
    broken.close()


def test_missing_h5py_raises_import_error_naming_h5py(monkeypatch, h5path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        WEDataset([h5path])
    with pytest.raises(ImportError, match="h5py"):
        generate_west_h5(h5path + ".never")


# ---------------------------------------------------- block cache and prefetch
def _wait_thread_done(ds, timeout=30.0):
    t = ds._prefetch_thread
    if t is not None:
        t.join(timeout=timeout)
        assert not t.is_alive(), "prefetch thread did not finish"


def _direct_blocks(ds):
    return {i: np.array(ds._read_frame_block(i, -1)) for i in range(1, N_ITER)}


def test_block_cache_budget_respected(h5path):
    ds = WEDataset([h5path])
    one_block = ds._read_frame_block(1, -1).nbytes
    # Room for exactly two blocks; the third read must not be cached
    ds.enable_block_cache(budget_bytes=2 * one_block)
    direct = _direct_blocks(ds)
    for i in (1, 2, 3):
        got = ds._iter_frame_block(i, -1)
        assert np.array_equal(np.asarray(got), direct[i])
        assert ds._block_used <= ds._block_budget
    assert set(ds._block_cache) == {(1, -1), (2, -1)}
    assert ds._block_used == 2 * one_block
    ds.close()


def test_block_cache_budget_from_environment(h5path, monkeypatch):
    ds = WEDataset([h5path])
    ds.enable_block_cache()
    assert ds._block_budget == 512 << 20
    monkeypatch.setenv("MSM_WE_TPU_BLOCK_CACHE_MB", "3")
    ds.enable_block_cache()
    assert ds._block_budget == 3 << 20
    ds.drop_block_cache()
    assert ds._block_cache is None and ds._block_used == 0
    ds.close()


def test_consume_hand_over_serves_once(h5path):
    ds = WEDataset([h5path])
    ds.enable_block_cache()
    first = np.array(ds._iter_frame_block(2, -1))  # populates the cache
    assert (2, -1) in ds._block_cache
    used_before = ds._block_used
    assert used_before > 0

    owned = ds._iter_frame_block(2, -1, consume=True)
    assert np.array_equal(np.asarray(owned), first)
    # Ownership transferred: entry gone, accounting restored, key tombstoned
    assert (2, -1) not in ds._block_cache
    assert ds._block_used == used_before - owned.nbytes
    assert (2, -1) in ds._block_consumed
    # A consuming re-read goes to disk and never re-populates the cache
    again = ds._iter_frame_block(2, -1, consume=True)
    assert np.array_equal(np.asarray(again), first)
    assert (2, -1) not in ds._block_cache
    ds.close()


def test_consume_after_shared_hit_gets_its_own_copy(h5path):
    ds = WEDataset([h5path])
    ds.enable_block_cache()
    ds._iter_frame_block(3, -1)  # miss: stored
    shared = ds._iter_frame_block(3, -1)  # plain hit: marked shared
    assert (3, -1) in ds._block_shared
    keep = np.array(shared)
    owned = ds._iter_frame_block(3, -1, consume=True)
    owned[:] = -1.0  # the consumer mutates in place
    assert np.array_equal(shared, keep)
    ds.close()


def test_prefetch_fills_then_consumer_drains(h5path):
    ds = WEDataset([h5path])
    direct = _direct_blocks(ds)
    ds.start_prefetch(N_ITER)
    first_thread = ds._prefetch_thread
    ds.start_prefetch(N_ITER)  # a second start while one runs is a no-op
    assert ds._prefetch_thread is first_thread or not first_thread.is_alive()
    _wait_thread_done(ds)
    # Everything fits in the default budget at this size
    assert set(ds._block_cache) == {(i, -1) for i in range(1, N_ITER)}
    assert set(ds._iter_data) == set(range(1, N_ITER + 1))
    for i in range(1, N_ITER):
        got = ds._iter_frame_block(i, -1, consume=True)
        assert np.array_equal(np.asarray(got), direct[i])
    assert ds._block_cache == {}
    assert ds._block_used == 0
    ds.stop_prefetch()
    ds.close()


@pytest.mark.parametrize("budget", [1, "one_block"])
def test_prefetch_backpressure_small_budget_no_deadlock(h5path, budget):
    """Budget below one block (the reader skips what can never fit) or of
    exactly one block (the reader idles until the consumer pops): the
    consumer still gets correct data and stop returns promptly."""
    ds = WEDataset([h5path])
    direct = _direct_blocks(ds)
    if budget == "one_block":
        budget = ds._block_nbytes_estimate()
    ds.enable_block_cache(budget_bytes=budget)
    ds.start_prefetch(N_ITER)
    for i in range(1, N_ITER):
        got = ds._iter_frame_block(i, -1, consume=True)
        assert np.array_equal(np.asarray(got), direct[i])
        assert ds._block_used <= budget
    t0 = time.perf_counter()
    ds.stop_prefetch()
    assert time.perf_counter() - t0 < 5.0
    assert ds._prefetch_thread is None
    ds.close()


def test_stop_and_close_are_idempotent_under_active_prefetch(h5path):
    ds = WEDataset([h5path])
    ds.start_prefetch(N_ITER)
    ds.close()  # close() stops the prefetch first
    ds.stop_prefetch()  # then both are no-ops
    ds.stop_prefetch()
    assert ds._prefetch_thread is None
    # The dataset must still be readable after close (lazy reopen)
    assert ds.iter_data(1)["n_segs"] == N_SEGS
    ds.close()
    assert not [t for t in threading.enumerate() if t.name == "westh5-prefetch"]


def test_concurrent_consumers_never_corrupt_accounting(h5path):
    """Several threads hammer the cache while a prefetch runs; the
    invariants 0 <= _block_used <= _block_budget and value-correctness hold
    throughout."""
    ds = WEDataset([h5path])
    direct = _direct_blocks(ds)
    ds.enable_block_cache()
    ds.start_prefetch(N_ITER)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(30):
                i = int(rng.integers(1, N_ITER))
                got = ds._iter_frame_block(i, -1, consume=bool(rng.integers(2)))
                if not np.array_equal(np.asarray(got), direct[i]):
                    errors.append(f"wrong data for iter {i}")
                with ds._io_lock:
                    used, budget = ds._block_used, ds._block_budget
                if not (0 <= used <= budget):
                    errors.append(f"accounting violated: {used}/{budget}")
        except Exception as e:  # surface, don't hang the join
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    ds.stop_prefetch()
    assert not errors, errors[:5]
    ds.close()


def test_subset_reads_are_transient(h5path):
    """Continuity and subset reads must not populate the block cache, and a
    transient hit must not mark the block shared."""
    ds = WEDataset([h5path])
    ds.enable_block_cache()
    out = ds.iter_frame_subset(2, [0, 1, 3], 0)
    assert out.shape[0] == 3
    assert ds._block_cache == {} and ds._block_used == 0

    first = np.array(ds._iter_frame_block(2, -1))  # populates the cache
    assert (2, -1) in ds._block_cache
    sub = ds.iter_frame_subset(2, [1, 2], -1)
    sub[:] = -999.0  # mutating the gathered copy never reaches the cache
    assert np.array_equal(np.asarray(ds._block_cache[(2, -1)]), first)
    assert (2, -1) not in ds._block_shared
    assert ds._check_continuity_uncached(
        sample_per_iter=4, full_iters=2, seed=0, last_iter=None
    ) is True
    assert set(ds._block_cache) == {(2, -1)}
    ds.close()


def test_aux_full_respects_per_iteration_dtype(tmp_path):
    """The full-block low-level read uses each iteration's own on-disk
    dtype: a later iteration written wider is not down-converted."""
    src = str(tmp_path / "mixed.h5")
    jax_generate_west_h5(src, n_iterations=6, n_segments=4, seed=5)
    with h5py.File(src, "r+") as h5:
        g = h5["iterations/iter_00000003/auxdata"]
        data = g["coord"][:].astype(np.float64) + 1e-12
        del g["coord"]
        g.create_dataset("coord", data=data)
        g1 = h5["iterations/iter_00000001/auxdata"]
        data1 = g1["coord"][:].astype(np.float32)
        del g1["coord"]
        g1.create_dataset("coord", data=data1)
    ds = WEDataset([src])
    b1 = ds._read_frame_block(1, -1)
    b3 = ds._aux_full(0, 3)
    assert b1.dtype == np.float32 and b3.dtype == np.float64
    np.testing.assert_array_equal(b3, data)
    ds.close()


@pytest.mark.parametrize("n_segments,rows,dtype", [
    (16, [3, 0, 3, 7], np.float64),   # dense rows: whole-block read
    (200, [0, 3, 3, 7], np.float32),  # sparse rows: row-selective read
])
def test_iter_frame_subset_paths_agree(tmp_path, monkeypatch, n_segments, rows, dtype):
    """The whole-block fast path and the row-selective HDF5 read return the
    same rows in the same dtype (native f32 stays f32)."""
    src = str(tmp_path / "w.h5")
    jax_generate_west_h5(src, n_iterations=6, n_segments=n_segments, seed=2)
    if dtype == np.float32:
        with h5py.File(src, "r+") as h5:
            for it in list(h5["iterations"]):
                g = h5[f"iterations/{it}/auxdata"]
                data = g["coord"][:].astype(np.float32)
                del g["coord"]
                g.create_dataset("coord", data=data)
    ds = WEDataset([src])
    fast = ds.iter_frame_subset(2, rows, -1)
    assert fast.dtype == dtype
    # Make every block look large, so sparse rows take the selective branch
    monkeypatch.setattr(ds, "_block_nbytes_estimate", lambda: (33 << 20))
    other = ds.iter_frame_subset(2, rows, -1)
    assert other.dtype == dtype
    np.testing.assert_array_equal(fast, other)
    ds.close()
