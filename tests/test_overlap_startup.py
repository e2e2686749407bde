"""Overlapped cold start: AOT geometry precompile + deferred upload.

The startup-overlap path (``FingerprintDB.start_precompile`` / ``upload`` /
``DatabaseRegistry.from_fsim_files(precompile_ks=...)``) lets a server run
its multi-minute remote XLA compiles concurrently with the equally long
library load/upload instead of back to back (round-3 flagship: 915 s load +
459 s compile sequential). These tests pin the invariants that make that
safe: geometry-only stores plan the exact layout the upload builds, the
AOT-compiled executables return bit-identical results to the normal jit
path, and searches arriving mid-startup block rather than crash.
"""

import threading

import numpy as np
import pytest

from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
from gpusimilarity_jax.models.registry import DatabaseRegistry
from gpusimilarity_jax.parallel import sharded

from conftest import random_fingerprint_data


@pytest.fixture(scope="module")
def data():
    return random_fingerprint_data(
        np.random.default_rng(0xA07), count=4000, dbkey="ovl"
    )


@pytest.mark.parametrize(
    "scan_mode,fold", [("dense", 1), ("dense", 2), ("bitplane", 1)]
)
def test_aot_matches_regular_path(data, scan_mode, fold):
    base = FingerprintDB(data, fold_factor=fold, scan_mode=scan_mode)
    db = FingerprintDB(
        data, fold_factor=fold, scan_mode=scan_mode, defer_upload=True
    )
    assert db._store is None  # nothing uploaded yet
    db.start_precompile(ks=(10,), max_batch=2)
    db.upload(async_prewarm=True)
    db.join_precompile()
    db.join_prewarm()
    compiled_before = db.compile_count
    assert compiled_before >= 2  # batch buckets 1 and 2 at least

    q = data.packed_words()[17]
    ref = base.search(q, k=10, dbkey="ovl", return_indices=True)
    got = db.search(q, k=10, dbkey="ovl", return_indices=True)
    assert got.indices == ref.indices
    assert got.scores == ref.scores
    assert got.scores[0] == 1.0 and got.indices[0] == 17
    # the search must have reused an AOT program, not compiled a new one
    assert db.compile_count == compiled_before

    # batched path through the same AOT executables
    refs = base.search_batch(
        data.packed_words()[5:7], k=10, dbkey="ovl", return_indices=True
    )
    gots = db.search_batch(
        data.packed_words()[5:7], k=10, dbkey="ovl", return_indices=True
    )
    for r, g in zip(refs, gots):
        assert g.indices == r.indices and g.scores == r.scores
    assert db.compile_count == compiled_before


@pytest.mark.parametrize("scan_mode,fold", [("dense", 2), ("bitplane", 1)])
def test_shape_only_store_matches_built_layout(data, scan_mode, fold):
    """The geometry the AOT compile assumes must equal what upload builds —
    a mismatch would make the compiled executable reject the live arrays."""
    db = FingerprintDB(
        data, fold_factor=fold, scan_mode=scan_mode, defer_upload=True
    )
    geom = db._geometry_store()
    db.upload()
    real = db._store
    if scan_mode == "bitplane":
        assert geom.planes.shape == real.planes.shape
        assert geom.planes.dtype == real.planes.dtype
        assert geom.bitcount == real.bitcount
    else:
        assert geom.words.shape == real.words.shape
        assert geom.words.dtype == real.words.dtype
    assert geom.popcounts.shape == real.popcounts.shape
    assert geom.popcounts.dtype == real.popcounts.dtype
    assert geom.n_padded == real.n_padded
    assert geom.chunk_cols == real.chunk_cols
    assert geom.n_valid == real.n_valid


def test_search_blocks_until_upload(data):
    db = FingerprintDB(data, scan_mode="dense", defer_upload=True)
    results = []

    def searcher():
        results.append(
            db.search(data.packed_words()[3], k=5, dbkey="ovl",
                      return_indices=True)
        )

    t = threading.Thread(target=searcher, daemon=True)
    t.start()
    t.join(timeout=0.5)
    assert t.is_alive(), "search must wait for the deferred upload"
    db.upload()
    t.join(timeout=60)
    assert not t.is_alive()
    assert results and results[0].indices[0] == 3


def test_registry_overlapped_startup(data, tmp_path):
    from gpusimilarity_jax.utils.tfsim import save_native

    path = str(tmp_path / "ovl.tfsim")
    save_native(path, data)
    reg = DatabaseRegistry.from_fsim_files(
        [path], fold_factor=2, scan_mode="dense",
        precompile_ks=(10,), precompile_batch=2,
    )
    reg.warmup(ks=(10,), max_batch=2)
    db = reg.get("ovl")
    db.join_prewarm()
    compiled = db.compile_count
    assert compiled >= 2
    q = data.packed_words()[42]
    r = reg.search_databases(["ovl"], ["ovl"], q, k=8)
    assert r.scores[0] == 1.0
    # warmup + live search served entirely from the AOT programs
    assert db.compile_count == compiled


def test_upload_is_idempotent(data):
    db = FingerprintDB(data, scan_mode="dense", defer_upload=True)
    db.upload()
    store = db._store
    db.upload()
    assert db._store is store


def test_streaming_fold_build_store_matches_prefold(data):
    """build_store(fold_factor=N) must equal fold-then-build."""
    import jax

    from gpusimilarity_jax.ops import fold as fold_ops

    full = data.packed_words()
    streamed = sharded.build_store(full, fold_factor=2)
    prefold = sharded.build_store(fold_ops.fold_words(full, 2))
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(streamed.words)),
        np.asarray(jax.device_get(prefold.words)),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(streamed.popcounts)),
        np.asarray(jax.device_get(prefold.popcounts)),
    )
    assert streamed.chunk_cols == prefold.chunk_cols
