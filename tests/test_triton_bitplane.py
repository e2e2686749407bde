"""The bitplane Pallas kernel (``ops/triton_bitplane.py``) and the XLA scan
paths against the numpy oracle, on the CPU.

The kernel runs through the Pallas interpreter (``interpret=True``): the
same kernel body the GPU compiles, except that the Tanimoto divide is the
plain f32 divide instead of the inline-PTX ``div.rn.f32`` (both IEEE). Cases cover
the query plane buckets, padded tails, shard offsets, several tiles,
Tversky scoring and per-query cutoff counts; each case also runs through
the three search paths (XLA dense, XLA bitplane, bitplane kernel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpusimilarity_jax.ops.bitplane import query_plane_indices
from gpusimilarity_jax.ops.scan import popcount_rows_np, scores_np
from gpusimilarity_jax.ops.triton_bitplane import bitplane_phase1
from gpusimilarity_jax.parallel import sharded
from gpusimilarity_jax.parallel.mesh import make_mesh

N_ROWS = 60_001  # 2 shards x 32768 columns: a padded tail on shard 1

# name: (query set-bit counts -> plane bucket, similarity, alpha, beta)
CASES = {
    "p16": ((5, 12, 16), "tanimoto", 1.0, 1.0),
    "p64": ((33, 40, 64), "tanimoto", 1.0, 1.0),
    "p128": ((65, 90, 128), "tanimoto", 1.0, 1.0),
    "tversky": ((20, 41, 60), "tversky", 0.75, 0.25),
    "tversky-uneven": ((30, 47, 50), "tversky", 0.5, 1.5),
}
CUTOFFS = np.array([0.0, 0.05, 0.2], np.float32)


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(1234)
    bits = rng.random((N_ROWS, 1024)) < 0.04
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def make_queries(library, set_bits):
    """Queries with exactly ``set_bits[i]`` bits; query 0 keeps the bits of
    library row 7 (so some columns score exactly 1.0 against it)."""
    rng = np.random.default_rng(sum(set_bits))
    out = np.zeros((len(set_bits), 32), np.uint32)
    for i, nb in enumerate(set_bits):
        bits = np.zeros(1024, np.uint8)
        if i == 0:
            own = np.nonzero(
                np.unpackbits(library[7].view(np.uint8), bitorder="little")
            )[0]
            pick = own[:nb] if len(own) >= nb else own
        else:
            pick = rng.choice(1024, nb, replace=False)
        bits[pick] = 1
        out[i] = np.packbits(bits, bitorder="little").view(np.uint32)
    return out


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def stores(library, mesh2):
    return (
        sharded.build_bitplane_store(library, mesh=mesh2),
        sharded.build_store(library, mesh=mesh2, chunk_cols=8192),
    )


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_oracle(library, stores, case, shard):
    """Per-word maxima and cutoff counts of one shard (16 tiles)."""
    set_bits, similarity, alpha, beta = CASES[case]
    store = stores[0]
    queries = make_queries(library, set_bits)
    plane_idx, bucket = query_plane_indices(queries, store.bitcount)
    assert bucket == max(16, 1 << (max(set_bits) - 1).bit_length())
    m8s = store.planes.shape[1] // store.n_shards
    ns = m8s * 256
    planes = np.asarray(store.planes)[:, shard * m8s : (shard + 1) * m8s]
    pops = np.asarray(store.popcounts)[shard * ns : (shard + 1) * ns]
    colmax, counts = bitplane_phase1(
        jnp.asarray(planes), jnp.asarray(pops), jnp.asarray(plane_idx),
        jnp.asarray(popcount_rows_np(queries)), jnp.asarray(CUTOFFS),
        jnp.asarray([alpha, beta], jnp.float32), jnp.int32(shard * ns),
        n_valid=N_ROWS, similarity=similarity, tile=64, interpret=True,
    )
    rows = shard * ns + np.arange(ns)
    valid = rows < N_ROWS
    local = np.zeros((ns, 32), np.uint32)
    local[valid] = library[rows[valid]]
    want = scores_np(local, queries, similarity, alpha, beta)
    want[:, ~valid] = -np.inf
    np.testing.assert_array_equal(
        np.asarray(colmax).reshape(len(queries), -1),
        want.reshape(len(queries), -1, 32).max(axis=-1),
    )
    np.testing.assert_array_equal(
        np.asarray(counts), (want >= CUTOFFS[:, None]).sum(axis=1)
    )


@pytest.mark.parametrize("path", ["dense", "bitplane-xla", "bitplane-pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_search_paths_match_oracle(library, stores, case, path):
    """The full SPMD search (phase 1, selection, merge) of every path."""
    set_bits, similarity, alpha, beta = CASES[case]
    k = 10
    queries = make_queries(library, set_bits)
    qpops = jnp.asarray(popcount_rows_np(queries))
    bstore, dstore = stores
    if path == "dense":
        search = sharded.build_search_fn(dstore, k, similarity, len(queries))
        qarg = jnp.asarray(queries)
    else:
        plane_idx, bucket = query_plane_indices(queries, bstore.bitcount)
        kernel = path == "bitplane-pallas"
        search = sharded.build_bitplane_search_fn(
            bstore, k, similarity, len(queries), bucket,
            use_pallas=kernel, interpret=kernel,
        )
        qarg = jnp.asarray(plane_idx)
    sharded.LAST_PHASE1_IMPL.clear()
    vals, idx, approx = jax.device_get(search(
        qarg, qpops, jnp.asarray(CUTOFFS), jnp.float32(alpha),
        jnp.float32(beta),
    ))
    mode = "dense" if path == "dense" else "bitplane"
    assert sharded.LAST_PHASE1_IMPL[mode] == (
        "pallas" if path == "bitplane-pallas" else "xla"
    )
    want = scores_np(library, queries, similarity, alpha, beta)
    for qi in range(len(queries)):
        order = np.lexsort((np.arange(N_ROWS), -want[qi]))[:k]
        np.testing.assert_array_equal(vals[qi], want[qi][order])
        np.testing.assert_array_equal(want[qi][idx[qi]], vals[qi])
        if path == "dense":  # lowest-index ties, like the oracle
            np.testing.assert_array_equal(idx[qi], order)
        assert approx[:, qi].sum() == (want[qi] >= CUTOFFS[qi]).sum()


def test_kernel_rejects_untiled_shard():
    planes = jnp.zeros((8 * 1025, 4), jnp.uint32)  # 32 words: < one tile
    with pytest.raises(ValueError, match="multiple of"):
        bitplane_phase1(
            planes, jnp.zeros(1024, jnp.int16), jnp.zeros((1, 16), jnp.int32),
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.float32),
            jnp.ones(2, jnp.float32), jnp.int32(0),
            n_valid=1024, interpret=True,
        )


@pytest.mark.parametrize("interpret", [False, True])
def test_kernel_requested_on_cpu(library, stores, interpret):
    """Asking for the kernel where there is no GPU raises; it is never
    quietly interpreted. Only an explicit ``interpret=True`` runs it."""
    if interpret:
        sharded.build_bitplane_search_fn(
            stores[0], 10, "tanimoto", 1, 64, use_pallas=True, interpret=True
        )
        return
    with pytest.raises(ValueError, match="GPU"):
        sharded.build_bitplane_search_fn(
            stores[0], 10, "tanimoto", 1, 64, use_pallas=True
        )


def test_engine_kernel_requested_on_cpu(library):
    from gpusimilarity_jax.models import FingerprintDB
    from gpusimilarity_jax.utils.fsim import FingerprintData

    data = FingerprintData(
        dbkey="", bitcount=1024, fingerprints=library[:4096].view(np.uint8),
        smiles=[b"C"] * 4096, ids=[b"x"] * 4096,
    )
    db = FingerprintDB(data, scan_mode="bitplane", use_pallas=True)
    with pytest.raises(ValueError, match="GPU"):
        db.search(library[3], k=5)
    with pytest.raises(ValueError, match="bitplane"):
        FingerprintDB(data, scan_mode="dense", use_pallas=True)
