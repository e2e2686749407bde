"""Tests for scan / fold / topk ops against independent oracles."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpusimilarity_jax import ops


def brute_tanimoto(bits_db, bits_q):
    """Bit-level oracle, no packing involved."""
    common = (bits_db & bits_q).sum(axis=-1)
    total = bits_db.sum(axis=-1) + bits_q.sum(axis=-1)
    with np.errstate(invalid="ignore"):
        out = np.where(total - common > 0, common / (total - common), 0.0)
    return out.astype(np.float32)


def pack(bits):
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(
        np.uint32
    )


@pytest.fixture()
def bits(rng):
    return (rng.random((64, 1024)) < 0.12).astype(np.uint8)


class TestScan:
    def test_popcount_rows(self, bits):
        words = pack(bits)
        np.testing.assert_array_equal(
            ops.popcount_rows_np(words), bits.sum(axis=-1).astype(np.int32)
        )

    def test_jax_scores_match_bit_oracle(self, bits, rng):
        qbits = (rng.random(1024) < 0.12).astype(np.uint8)
        db_words, q_words = pack(bits), pack(qbits[None])[0]
        scores = ops.score_batch(
            jnp.asarray(db_words),
            jnp.asarray(ops.popcount_rows_np(db_words)),
            jnp.asarray(q_words),
            jnp.asarray(ops.popcount_rows_np(q_words[None])[0]),
        )
        np.testing.assert_allclose(
            np.asarray(scores), brute_tanimoto(bits, qbits), rtol=1e-6
        )

    def test_numpy_scores_match_jax(self, bits, rng):
        qbits = (rng.random((3, 1024)) < 0.2).astype(np.uint8)
        db_words, q_words = pack(bits), pack(qbits)
        jax_scores = ops.score_batch(
            jnp.asarray(db_words),
            jnp.asarray(ops.popcount_rows_np(db_words)),
            jnp.asarray(q_words),
            jnp.asarray(ops.popcount_rows_np(q_words)),
        )
        np_scores = ops.scores_np(db_words, q_words)
        assert np_scores.shape == (3, 64)
        np.testing.assert_allclose(np.asarray(jax_scores), np_scores, rtol=1e-6)

    def test_self_similarity_is_one(self, bits):
        words = pack(bits)
        pops = ops.popcount_rows_np(words)
        scores = ops.score_batch(
            jnp.asarray(words),
            jnp.asarray(pops),
            jnp.asarray(words[5]),
            jnp.asarray(pops[5]),
        )
        assert float(scores[5]) == 1.0

    def test_empty_fingerprints_score_zero(self):
        words = np.zeros((4, 32), np.uint32)
        scores = ops.score_batch(
            jnp.asarray(words),
            jnp.zeros(4, jnp.int32),
            jnp.asarray(words[0]),
            jnp.int32(0),
        )
        np.testing.assert_array_equal(np.asarray(scores), np.zeros(4, np.float32))

    def test_tversky_reduces_to_tanimoto_at_unit_weights(self, bits, rng):
        qbits = (rng.random(1024) < 0.12).astype(np.uint8)
        db_words, q_words = pack(bits), pack(qbits[None])
        tani = ops.scores_np(db_words, q_words, similarity=ops.TANIMOTO)
        tver = ops.scores_np(
            db_words, q_words, similarity=ops.TVERSKY, alpha=1.0, beta=1.0
        )
        np.testing.assert_allclose(tani, tver, rtol=1e-6)

    def test_tversky_asymmetry(self, rng):
        # query a subset of db bits: Tversky(alpha=0) scores substructure 1.0
        dbits = np.zeros((1, 1024), np.uint8)
        dbits[0, :64] = 1
        qbits = np.zeros((1, 1024), np.uint8)
        qbits[0, :32] = 1  # query subset of the db compound
        s = ops.scores_np(
            pack(dbits), pack(qbits), similarity=ops.TVERSKY, alpha=1.0, beta=0.0
        )
        assert s[0, 0] == 1.0


class TestFold:
    def test_fold_bits_or_semantics(self):
        # fold 2: output bit p = in[p] | in[p + n/2]
        bits = np.zeros(8, np.uint8)
        bits[[0, 5]] = 1
        folded = ops.fold_bits(bits, 2)
        np.testing.assert_array_equal(folded, [1, 1, 0, 0])

    def test_fold_words_matches_fold_bits(self, rng):
        bits = (rng.random((16, 1024)) < 0.1).astype(np.uint8)
        for fold in (1, 2, 4, 8, 16, 32):
            via_words = ops.fold_words(pack(bits), fold)
            via_bits = pack(ops.fold_bits(bits, fold))
            np.testing.assert_array_equal(via_words, via_bits, err_msg=f"fold={fold}")

    def test_fold_words_jax_matches_numpy(self, rng):
        bits = (rng.random((8, 1024)) < 0.1).astype(np.uint8)
        words = pack(bits)
        out = ops.fold_words(jnp.asarray(words), 4)
        np.testing.assert_array_equal(np.asarray(out), ops.fold_words(words, 4))

    def test_round_fold_factor(self):
        assert ops.round_fold_factor(32, 1) == 1
        assert ops.round_fold_factor(32, 3) == 4  # 3 -> 4 divides 32
        assert ops.round_fold_factor(32, 5) == 8
        assert ops.round_fold_factor(32, 32) == 32

    def test_overfetch_matches_reference_rule(self):
        # reference: k * fold * log2(2 * fold)
        assert ops.overfetch_count(20, 1) == 20
        assert ops.overfetch_count(20, 2) == 80
        assert ops.overfetch_count(20, 4) == 240
        assert ops.overfetch_count(20, 8) == 640

    def test_folding_never_lowers_similarity(self, rng):
        """Folded Tanimoto >= true Tanimoto never holds in general, but a
        self-match must stay 1.0 and folded scores of the true top hit should
        remain high — the property the over-fetch rule relies on."""
        bits = (rng.random((32, 1024)) < 0.1).astype(np.uint8)
        words = pack(bits)
        folded = ops.fold_words(words, 4)
        s = ops.scores_np(folded, folded[3][None])
        assert s[0, 3] == 1.0


class TestTopK:
    def test_exact_topk_small(self, rng):
        scores = rng.random(1000).astype(np.float32)
        vals, idx = ops.exact_topk(jnp.asarray(scores), 10)
        order = np.argsort(-scores)[:10]
        np.testing.assert_array_equal(np.asarray(idx), order)
        np.testing.assert_allclose(np.asarray(vals), scores[order])

    def test_exact_topk_segmented_matches_sort(self, rng):
        scores = rng.random(100_000).astype(np.float32)
        vals, idx = ops.exact_topk(jnp.asarray(scores), 128, segment=4096)
        order = np.argsort(-scores)[:128]
        vals_np, idx_np = np.asarray(vals), np.asarray(idx)
        np.testing.assert_allclose(vals_np, scores[order])
        # 100k float32 draws collide ~4-5 times per run (birthday at 2^30
        # near-1 values), and np.argsort's default sort is UNSTABLE, so
        # index-sequence equality is not a valid oracle at ties: assert the
        # tie-robust contract instead — every index names a row with
        # exactly the returned score and no index repeats
        np.testing.assert_array_equal(scores[idx_np], vals_np)
        assert len(set(idx_np.tolist())) == len(idx_np)

    def test_exact_topk_unpadded_boundary(self, rng):
        scores = rng.random(100_001).astype(np.float32)  # not segment-aligned
        vals, _ = ops.exact_topk(jnp.asarray(scores), 7, segment=4096)
        np.testing.assert_allclose(np.asarray(vals), np.sort(scores)[::-1][:7])

    def test_exact_topk_batched(self, rng):
        scores = rng.random((5, 50_000)).astype(np.float32)
        vals, idx = ops.exact_topk(jnp.asarray(scores), 16, segment=2048)
        for b in range(5):
            np.testing.assert_allclose(
                np.asarray(vals[b]), np.sort(scores[b])[::-1][:16]
            )

    def test_topk_with_cutoff(self, rng):
        scores = np.linspace(0, 1, 101, dtype=np.float32)
        vals, idx, approx = ops.topk_with_cutoff(
            jnp.asarray(scores), 10, jnp.float32(0.95)
        )
        assert int(approx) == 6  # 0.95, 0.96, ..., 1.0
        assert np.asarray(vals)[0] == 1.0
        # entries below cutoff masked to -inf
        assert np.asarray(vals)[6:].max() == -np.inf

    def test_topk_cutoff_zero_counts_everything(self, rng):
        scores = rng.random(256).astype(np.float32)
        _, _, approx = ops.topk_with_cutoff(jnp.asarray(scores), 5, jnp.float32(0.0))
        assert int(approx) == 256

    def test_merge_topk(self, rng):
        scores = rng.random(4096).astype(np.float32)
        # simulate 4 shards of 1024 with global indices
        shard_vals, shard_idx = [], []
        for s in range(4):
            chunk = scores[s * 1024 : (s + 1) * 1024]
            order = np.argsort(-chunk)[:8]
            shard_vals.append(chunk[order])
            shard_idx.append(order + s * 1024)
        vals, idx = ops.merge_topk(
            jnp.asarray(np.stack(shard_vals)), jnp.asarray(np.stack(shard_idx)), 8
        )
        expected = np.argsort(-scores)[:8]
        np.testing.assert_array_equal(np.asarray(idx), expected)
        np.testing.assert_allclose(np.asarray(vals), scores[expected])
