"""Popless dense stores + the synthetic (virtual) fingerprint source.

Round-5 additions for the 1.024B-row flagship: a dense store without the
per-column popcount array (column pops recomputed inside the scan) and the
v3 ``.tfsim`` "synthetic" fingerprint kind (rows are the counter-mixer
function of their index; string tables stay real on-disk blobs). Both must
be bit-exact against the same numpy oracle as the stored paths — exactness
here is what makes the HBM/disk savings free, not a trade.
"""

import json

import jax
import numpy as np
import pytest

from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
from gpusimilarity_jax.parallel import sharded
from gpusimilarity_jax.parallel.mesh import make_mesh
from gpusimilarity_jax.ops.scan import scores_np
from gpusimilarity_jax.utils import synth, tfsim
from gpusimilarity_jax.utils.fsim import FingerprintData
from gpusimilarity_jax.utils.strings import StridedStringTable


def oracle_topk(words, q, k):
    s = scores_np(words, q[None, :])[0]
    order = np.lexsort((np.arange(len(s)), -s))[:k]
    return s, order


# --------------------------------------------------------------- popless


def random_data(rng, count, dbkey="pl"):
    packed = rng.integers(0, 2**32, size=(count, 32), dtype=np.uint32)
    # Morgan-like sparsity
    for _ in range(4):
        packed &= rng.integers(0, 2**32, size=(count, 32), dtype=np.uint32)
    smiles = [f"C{'C' * (i % 7)}N{i}".encode() for i in range(count)]
    ids = [f"TEST{i:08d}".encode() for i in range(count)]
    return FingerprintData(
        dbkey=dbkey, bitcount=1024, fingerprints=packed.view(np.uint8),
        smiles=smiles, ids=ids,
    )


class TestPoplessDense:
    @pytest.fixture(scope="class")
    def data(self):
        return random_data(np.random.default_rng(17), count=700000)

    @pytest.fixture(scope="class")
    def mesh2(self):
        return make_mesh(jax.devices()[:2])

    # the dense phase 1 has one implementation (XLA); the id records it
    @pytest.mark.parametrize("impl", ["xla"])
    def test_matches_withpops_and_oracle(self, data, mesh2, impl):
        db = FingerprintDB(data, mesh=mesh2, chunk_cols=8192, popless=True)
        assert db._store.popcounts is None
        words = data.packed_words()
        queries = [5, 123456, 699999]
        sharded.LAST_PHASE1_IMPL.clear()
        results = db.search_batch(
            words[queries], k=10, cutoff=[0.0, 0.1, 0.2], dbkey="pl"
        )
        assert sharded.LAST_PHASE1_IMPL["dense"] == impl
        for qi, cutoff, r in zip(queries, [0.0, 0.1, 0.2], results):
            s, order = oracle_topk(words, words[qi], 10)
            if cutoff > 0:
                order = order[s[order] >= cutoff]
            assert r.scores == [float(v) for v in s[order]]
            assert r.approximate_count == int((s >= cutoff).sum())
            assert [int(i[4:]) for i in r.ids] == [int(x) for x in order]

    def test_small_path_popless(self):
        data = random_data(np.random.default_rng(3), count=3000)
        db = FingerprintDB(data, mesh=make_mesh(jax.devices()[:2]),
                           popless=True)
        words = data.packed_words()
        r = db.search(words[42], k=5, dbkey="pl")
        s, order = oracle_topk(words, words[42], 5)
        assert r.scores == [float(v) for v in s[order]]
        assert r.scores[0] == 1.0

    def test_popless_rejects_bitplane(self):
        data = random_data(np.random.default_rng(3), count=1000)
        with pytest.raises(ValueError, match="popless"):
            FingerprintDB(data, scan_mode="bitplane", popless=True)

    def test_shape_only_store_popless(self):
        st = sharded.shape_only_store(100000, 8, popless=True)
        assert st.popcounts is None
        assert isinstance(st.words, jax.ShapeDtypeStruct)


# ---------------------------------------------------------- virtual source


class TestVirtualWords:
    def test_getitem_forms(self):
        vw = synth.VirtualWords(10000, 32, seed=5)
        ref = synth.virtual_rows_np(np.arange(10000), seed=5)
        assert vw.shape == (10000, 32)
        assert vw.nbytes == 10000 * 32 * 4
        np.testing.assert_array_equal(vw[7], ref[7])
        np.testing.assert_array_equal(vw[-1], ref[-1])
        np.testing.assert_array_equal(vw[10:200], ref[10:200])
        np.testing.assert_array_equal(vw[::997], ref[::997])
        idx = np.array([3, 9999, 0, 512])
        np.testing.assert_array_equal(vw[idx], ref[idx])
        with pytest.raises(IndexError):
            vw[10000]

    def test_native_bulk_slice_identical(self):
        vw = synth.VirtualWords(5000, 32, seed=9)
        ref = synth.virtual_rows_np(np.arange(1000, 4000), seed=9)
        np.testing.assert_array_equal(vw[1000:4000], ref)

    def test_rescore_matches_scores_np(self):
        vw = synth.VirtualWords(20000, 32, seed=1)
        q = vw[777]
        idx = np.array([0, 777, 12345, 19999])
        got = vw.rescore(idx, q)
        want = scores_np(vw[idx], q[None, :])[0]
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got[1] == 1.0

    def test_fingerprints_face(self):
        vf = synth.VirtualFingerprints(1000, 1024, seed=2)
        assert vf.shape == (1000, 128)
        assert len(vf) == 1000
        np.testing.assert_array_equal(
            vf[5:7], np.ascontiguousarray(vf.words[5:7]).view(np.uint8)
        )


class TestVirtualTfsim:
    def test_save_load_roundtrip(self, tmp_path):
        data = FingerprintData(
            dbkey="vkey",
            bitcount=1024,
            fingerprints=synth.VirtualFingerprints(5000, 1024, seed=11),
            smiles=[b"CCO"] * 5000,
            ids=[f"SYN{i:010d}".encode() for i in range(5000)],
        )
        path = tmp_path / "virt.tfsim"
        tfsim.save_native(path, data)
        meta = json.loads((path / "meta.json").read_text())
        assert meta["format_version"] == 3
        assert meta["fingerprints"] == {"kind": "synthetic", "seed": 11}
        assert not (path / "fingerprints.npy").exists()
        loaded = tfsim.load_native(path)
        assert isinstance(loaded.fingerprints, synth.VirtualFingerprints)
        assert loaded.count == 5000
        np.testing.assert_array_equal(
            loaded.packed_words()[100:200],
            synth.virtual_rows_np(np.arange(100, 200), seed=11),
        )
        assert loaded.ids[4999] == b"SYN0000004999"

    def test_stream_writer_synthetic_strided(self, tmp_path):
        path = tmp_path / "big.tfsim"
        with tfsim.TfsimStreamWriter(
            path, dbkey="k", synthetic_seed=7,
            strided={"smiles": 8, "ids": 6},
        ) as w:
            w.append_batch(
                None,
                np.frombuffer(b"AAAAAAAABBBBBBBB", np.uint8).reshape(2, 8),
                [b"ID0001", b"ID0002"],
            )
            w.append_batch(None, [b"CCCCCCCC"], b"ID0003")
        meta = json.loads((path / "meta.json").read_text())
        assert meta["format_version"] == 3
        assert meta["count"] == 3
        assert meta["strings"]["smiles"] == {"kind": "strided", "itemsize": 8}
        assert not (path / "smiles.idx.npy").exists()
        loaded = tfsim.load_native(path)
        assert isinstance(loaded.smiles, StridedStringTable)
        assert bytes(loaded.smiles[2]) == b"CCCCCCCC"
        assert bytes(loaded.ids[1]) == b"ID0002"
        np.testing.assert_array_equal(
            loaded.packed_words()[0], synth.virtual_rows_np([0], seed=7)[0]
        )

    def test_stream_writer_rejects_fp_for_synthetic(self, tmp_path):
        w = tfsim.TfsimStreamWriter(
            tmp_path / "x.tfsim", synthetic_seed=1, strided={"ids": 6},
        )
        try:
            with pytest.raises(ValueError, match="synthetic"):
                w.append_batch(b"\0" * 128, [b"CCO"], [b"ID0001"])
            with pytest.raises(ValueError, match="mismatch"):
                w.append_batch(None, [b"CCO", b"CCN"], [b"ID0001"])
        finally:
            w.abort()


class TestVirtualEngine:
    """End-to-end: the engine serving a synthetic library, dense popless,
    fold > 1 — the 1B flagship configuration at CPU-test scale."""

    N = 262144  # aligned for the virtual bitplane builder at 8 shards too

    @pytest.fixture(scope="class")
    def data(self):
        return FingerprintData(
            dbkey="virt",
            bitcount=1024,
            fingerprints=synth.VirtualFingerprints(self.N, 1024, seed=7),
            smiles=[b"CCO"] * self.N,
            ids=[f"SYN{i:010d}".encode() for i in range(self.N)],
        )

    @pytest.fixture(scope="class")
    def full(self):
        return synth.virtual_matrix(self.N, seed=7)

    def test_dense_popless_fold2_exact(self, data, full):
        db = FingerprintDB(data, fold_factor=2, popless=True)
        assert db._store.popcounts is None
        # the store was generated on-device, not uploaded
        assert db._store.n_valid == self.N
        for qi in (5, 100000, self.N - 1):
            r = db.search(full[qi], k=10, dbkey="virt", return_indices=True)
            s, order = oracle_topk(full, full[qi], 10)
            assert r.scores == pytest.approx(
                [float(v) for v in s[order]], abs=1e-6
            )
            assert r.scores[0] == 1.0
            assert r.indices[0] == qi
            assert r.ids[0] == f"SYN{qi:010d}"

    def test_device_gen_matches_host_upload(self, full):
        """The on-device dense generator writes the exact planes the host
        upload path would."""
        mesh = make_mesh(jax.devices()[:4])
        st_dev = synth.build_virtual_dense_store(
            self.N, 2, mesh=mesh, seed=7, popless=False, chunk_cols=8192
        )
        from gpusimilarity_jax.ops import fold as fold_ops

        st_host = sharded.build_store(
            full, mesh=mesh, chunk_cols=8192, fold_factor=2
        )
        np.testing.assert_array_equal(
            np.asarray(st_dev.words), np.asarray(st_host.words)
        )
        np.testing.assert_array_equal(
            np.asarray(st_dev.popcounts), np.asarray(st_host.popcounts)
        )

    def test_bitplane_virtual_aligned(self, data, full):
        db = FingerprintDB(data, scan_mode="bitplane")
        r = db.search(full[999], k=5, dbkey="virt")
        s, order = oracle_topk(full, full[999], 5)
        assert r.scores == pytest.approx([float(v) for v in s[order]], abs=1e-6)

    def test_virtual_full_topk_oracle_exact(self, full):
        """The on-device full-width oracle (flagship recall measurement)
        matches numpy exactly, incl. lowest-index ties and cutoff counts."""
        qrows = [5, 77777, self.N - 1]
        vals, idx, counts = synth.virtual_full_topk(
            self.N, full[qrows], 16, seed=7, cutoffs=(0.3, 0.5)
        )
        for bi, qi in enumerate(qrows):
            s = scores_np(full, full[qi][None, :])[0]
            order = np.lexsort((np.arange(self.N), -s))[:16]
            np.testing.assert_array_equal(idx[bi], order)
            np.testing.assert_allclose(vals[bi], s[order], atol=1e-6)
            assert counts[bi, 0] == (s >= 0.3).sum()
            assert counts[bi, 1] == (s >= 0.5).sum()

    def test_bitplane_virtual_unaligned_raises(self):
        data = FingerprintData(
            dbkey="virt", bitcount=1024,
            fingerprints=synth.VirtualFingerprints(100000, 1024, seed=7),
            smiles=[b"C"] * 100000, ids=[b"X"] * 100000,
        )
        with pytest.raises(ValueError, match="aligned"):
            FingerprintDB(data, scan_mode="bitplane")
