"""Virtual-library (utils/synth.py) correctness on the 8-device CPU mesh.

The bench's fold mode trusts synth for three things, each pinned here:

1. host and device materialize BIT-IDENTICAL data from the row-index mixer;
2. the device-side SPMD generator produces byte-for-byte the same
   BitplaneStore the production host builder (``sharded.build_bitplane_store``)
   would build from the same full-width rows;
3. the full folded pipeline — folded bitplane scan, over-fetch
   (``ops/fold.py``, reference ``fingerprintdb_cuda.cu:284-331``), exact
   full-width host rescore — returns the true full-width top-k.
"""

import numpy as np
import pytest

import jax

from gpusimilarity_jax.ops import fold as fold_ops
from gpusimilarity_jax.ops.bitplane import query_plane_indices
from gpusimilarity_jax.ops.scan import popcount_rows_np, scores_np
from gpusimilarity_jax.parallel import sharded
from gpusimilarity_jax.parallel.mesh import make_mesh
from gpusimilarity_jax.utils import synth

SEED = 11
FOLD = 4
N_ROWS = 2 * 1024 * 1024  # smallest Pallas-aligned count on 8 shards
K = 8
QUERY_ROWS = (17, 1_234_567)


def test_host_device_rows_identical():
    import jax.numpy as jnp

    idx0 = 98_304
    host = synth.virtual_rows_np(
        np.arange(idx0, idx0 + 512), word_count=32, seed=SEED
    )
    dev = jax.jit(
        lambda: synth._virtual_rows_jnp(jnp.uint32(idx0), 512, 32, SEED)
    )()
    assert np.array_equal(host, np.asarray(dev))


def test_native_fill_identical():
    from gpusimilarity_jax.utils import native

    if not native.available():
        pytest.skip("native library not built")
    idx0 = 777_216
    a = native.synth_fill(2048, seed=SEED, row0=idx0)
    b = synth.virtual_rows_np(np.arange(idx0, idx0 + 2048), seed=SEED)
    assert np.array_equal(a, b)


def test_density_is_morgan_like():
    rows = synth.virtual_rows_np(np.arange(4096), seed=SEED)
    pops = popcount_rows_np(rows)
    assert 32 <= pops.mean() <= 48  # ~4% of 1024, Morgan-like
    # clustered: same-cluster rows sit in a graded similarity band well
    # above the noise floor (what makes fold over-fetch recovery behave
    # like the reference's real-corpus accuracy table, slide 11)
    q = rows[300]
    cluster = scores_np(rows[256:512], q[None, :])[0]
    noise = scores_np(rows[2048:2304], q[None, :])[0]
    assert cluster.mean() > 0.2 and np.median(cluster) > 0.15
    assert noise.max() < 0.15
    folded_pops = popcount_rows_np(fold_ops.fold_words(rows, FOLD))
    # the TYPICAL folded row fits the 64-plane kernel bucket; the upper
    # tail crosses it, which is why bench queries are rejection-sampled
    assert np.percentile(folded_pops, 95) <= 64
    picked = synth.pick_query_rows(64, 1 << 20, FOLD, seed=SEED)
    prows = synth.virtual_rows_np(picked, seed=SEED)
    assert popcount_rows_np(
        np.asarray(fold_ops.fold_words(prows, FOLD))
    ).max() <= 64


def test_device_store_matches_host_builder_small():
    """Device SPMD generator == production host builder, byte for byte."""
    n = synth.aligned_virtual_rows(65536, 8)
    mesh = make_mesh()
    virt = synth.build_virtual_bitplane_store(n, FOLD, mesh=mesh, seed=SEED)
    full = synth.virtual_rows_np(np.arange(n), seed=SEED)
    ref = sharded.build_bitplane_store(
        np.asarray(fold_ops.fold_words(full, FOLD)), mesh=mesh
    )
    assert virt.bitcount == ref.bitcount == 1024 // FOLD
    assert np.array_equal(np.asarray(virt.planes), np.asarray(ref.planes))
    assert np.array_equal(np.asarray(virt.popcounts), np.asarray(ref.popcounts))
    assert virt.popcounts.dtype == np.int16


@pytest.fixture(scope="module")
def big():
    """2M-row virtual store + full-width oracle scores for the test queries."""
    mesh = make_mesh()
    store = synth.build_virtual_bitplane_store(
        N_ROWS, FOLD, mesh=mesh, seed=SEED
    )
    full_q = synth.virtual_rows_np(np.array(QUERY_ROWS), seed=SEED)
    oracle = np.empty((len(QUERY_ROWS), N_ROWS), np.float32)
    slab = 1 << 18
    for lo in range(0, N_ROWS, slab):
        rows = synth.virtual_rows_np(np.arange(lo, lo + slab), seed=SEED)
        oracle[:, lo : lo + slab] = scores_np(rows, full_q)
    return store, full_q, oracle


@pytest.mark.parametrize("use_pallas", [False, True])
def test_folded_search_recovers_full_width_topk(big, use_pallas):
    store, full_q, oracle = big
    b = len(QUERY_ROWS)
    folded_q = np.asarray(fold_ops.fold_words(full_q, FOLD))
    plane_idx, bucket = query_plane_indices(folded_q, store.bitcount)
    k_fetch = fold_ops.overfetch_count(K, FOLD)
    search = sharded.build_bitplane_search_fn(
        store, k=k_fetch, similarity="tanimoto", batch=b,
        plane_bucket=bucket, use_pallas=use_pallas, interpret=use_pallas,
    )
    import jax.numpy as jnp

    sharded.LAST_PHASE1_IMPL.clear()
    vals, idx, _ = jax.device_get(
        search(
            jnp.asarray(plane_idx),
            jnp.asarray(popcount_rows_np(folded_q).astype(np.int32)),
            jnp.zeros(b, jnp.float32),
            jnp.float32(1.0),
            jnp.float32(1.0),
        )
    )
    assert sharded.LAST_PHASE1_IMPL["bitplane"] == (
        "pallas" if use_pallas else "xla"
    )
    for qi in range(b):
        scores, indices = synth.rescore_candidates_np(
            idx[qi], full_q[qi], K, N_ROWS, seed=SEED
        )
        # every returned score is the true full-width score of its row
        assert np.allclose(scores, oracle[qi][indices], atol=0)
        # rank 0 is the query row at exactly 1.0
        assert indices[0] == QUERY_ROWS[qi] and scores[0] == 1.0
        # the k-th-ranked oracle scores match (tie-permutation tolerant)
        want = np.sort(oracle[qi])[::-1][:K]
        assert np.array_equal(scores, want)
