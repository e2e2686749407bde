"""Bitplane (bit-sliced) scan mode: ops parity + engine golden values."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpusimilarity_jax.models import FingerprintDB
from gpusimilarity_jax.ops import bitplane as bp
from gpusimilarity_jax.ops.scan import popcount_rows_np
from gpusimilarity_jax.utils.fsim import read_fsim

from conftest import random_fingerprint_data


def pack_bits(bits):
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


class TestBitplaneOps:
    def test_transpose_roundtrip(self, rng):
        bits = (rng.random((300, 1024)) < 0.1).astype(np.uint8)
        packed = pack_bits(bits)
        planes = bp.build_bitplanes_np(packed, 320)
        assert planes.shape == (1024, 10)
        for p, r in [(0, 0), (7, 299), (1023, 150), (512, 32)]:
            got = (planes[p, r // 32] >> (r % 32)) & 1
            assert got == bits[r, p]
        # padding columns are zero
        tail = np.unpackbits(
            planes.view(np.uint8), bitorder="little"
        ).reshape(1024, 320)[:, 300:]
        assert (tail == 0).all()

    def test_wallace_counts_match_popcount(self, rng):
        bits = (rng.random((256, 1024)) < 0.15).astype(np.uint8)
        packed = pack_bits(bits)
        words = packed.view(np.uint32)
        planes = bp.build_bitplanes_np(packed, 256)
        planes_ext = np.concatenate(
            [planes, np.zeros((1, planes.shape[1]), np.uint32)]
        )
        for qi in (0, 99, 255):
            idx, _ = bp.query_plane_indices(words[qi : qi + 1], 1024)
            gathered = jnp.asarray(planes_ext)[jnp.asarray(idx[0])]
            common = np.asarray(bp.common_from_planes(gathered))[:256]
            expected = popcount_rows_np(words & words[qi])
            np.testing.assert_array_equal(common, expected)

    def test_query_plane_indices_buckets(self):
        q = np.zeros((1, 32), np.uint32)
        q[0, 0] = 0b1011  # 3 bits set
        idx, bucket = bp.query_plane_indices(q, 1024)
        assert bucket == 16
        assert list(idx[0][:3]) == [0, 1, 3]
        assert (idx[0][3:] == 1024).all()  # sentinel padding

    def test_empty_query(self):
        idx, bucket = bp.query_plane_indices(np.zeros((1, 32), np.uint32), 1024)
        assert (idx == 1024).all()

    def test_wallace_tree_widths(self, rng):
        # exercise non-power-of-2 plane counts
        for p in (1, 2, 3, 5, 17, 33):
            planes = [
                jnp.asarray(rng.integers(0, 2**32, 8, dtype=np.uint32))
                for _ in range(p)
            ]
            counters = bp.wallace_popcount_planes(planes)
            counts = np.asarray(bp.counters_to_counts(counters))
            expected = sum(
                np.unpackbits(np.asarray(pl).view(np.uint8), bitorder="little")
                for pl in planes
            )
            np.testing.assert_array_equal(counts, expected)


class TestBitplaneEngine:
    @pytest.fixture(scope="class")
    def dbs(self):
        import os

        if not os.path.exists("/root/reference/test/small.fsim"):
            pytest.skip("reference fixture not available")
        data = read_fsim("/root/reference/test/small.fsim")
        return (
            FingerprintDB(data, scan_mode="dense"),
            FingerprintDB(data, scan_mode="bitplane"),
        )

    @pytest.mark.parametrize(
        "cutoff,expect_n,expect_approx",
        [(0.0, 10, 100), (0.1, 10, 86), (0.3, 3, 3), (0.4, 1, 1)],
    )
    def test_golden_cutoffs(self, dbs, cutoff, expect_n, expect_approx):
        dense, bitp = dbs
        q = dense.get_fingerprint(0)
        r = bitp.search(q, k=10, cutoff=cutoff, dbkey="pass")
        assert len(r) == expect_n
        assert r.approximate_count == expect_approx
        rd = dense.search(q, k=10, cutoff=cutoff, dbkey="pass")
        assert r.ids == rd.ids and r.scores == rd.scores

    def test_bitplane_matches_dense_on_synthetic(self, rng):
        data = random_fingerprint_data(rng, count=3000)
        dense = FingerprintDB(data, scan_mode="dense")
        bitp = FingerprintDB(data, scan_mode="bitplane")
        words = data.packed_words()
        batch = words[[7, 1234, 2999]]
        rd = dense.search_batch(batch, k=25)
        rb = bitp.search_batch(batch, k=25)
        for a, b in zip(rd, rb):
            assert a.ids == b.ids
            assert a.scores == b.scores
            assert a.approximate_count == b.approximate_count

    # NOTE: the bitplane two-phase selection path is covered by
    # tests/test_two_phase.py::TestBitplaneTwoPhase (this class's 8-shard
    # geometry lands every case in the small-shard shortcut).

    def test_store_popcounts_are_int16(self, dbs):
        # int16 like the dense store: at 768M rows an int32 flat popcount
        # array costs 3 GiB of HBM — the difference between a fold-8
        # bitplane flagship fitting beside its planes or OOMing.
        _, bitp = dbs
        assert bitp._store.popcounts.dtype == jnp.int16

    def test_folded_bitplane(self, dbs):
        import os

        data = read_fsim("/root/reference/test/small.fsim")
        dense, _ = dbs
        fb = FingerprintDB(data, scan_mode="bitplane", fold_factor=4)
        q = dense.get_fingerprint(0)
        assert fb.search(q, k=10, dbkey="pass").ids == dense.search(
            q, k=10, dbkey="pass"
        ).ids

    def test_tversky_bitplane(self, rng):
        data = random_fingerprint_data(rng, count=200)
        bitp = FingerprintDB(data, scan_mode="bitplane")
        r = bitp.search(
            data.packed_words()[9], k=5, similarity="tversky", alpha=0.2, beta=0.8
        )
        assert r.scores[0] == 1.0
