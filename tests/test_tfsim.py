"""Tests for the native .tfsim format and format conversion."""

import numpy as np
import pytest

from gpusimilarity_jax.utils.fsim import read_fsim, write_fsim
from gpusimilarity_jax.utils.strings import StringTable
from gpusimilarity_jax.utils.tfsim import (
    convert,
    is_native,
    load_any,
    load_native,
    save_native,
)

from conftest import random_fingerprint_data


class TestNativeFormat:
    def test_roundtrip(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=123, dbkey="nat")
        path = tmp_path / "db.tfsim"
        save_native(path, data)
        assert is_native(path)
        back = load_native(path)
        assert back.dbkey == "nat" and back.count == 123
        np.testing.assert_array_equal(
            np.asarray(back.fingerprints), data.fingerprints
        )
        assert isinstance(back.smiles, StringTable)
        assert list(back.smiles) == data.smiles
        assert list(back.ids) == data.ids

    def test_mmap_load(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=10)
        save_native(tmp_path / "m.tfsim", data)
        back = load_native(tmp_path / "m.tfsim", mmap=True)
        assert isinstance(back.fingerprints, np.memmap)
        assert back.smiles[0] == data.smiles[0]

    def test_no_overwrite(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=5)
        save_native(tmp_path / "x.tfsim", data)
        with pytest.raises(FileExistsError):
            save_native(tmp_path / "x.tfsim", data)

    def test_convert_both_ways(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=42, dbkey="conv")
        write_fsim(tmp_path / "a.fsim", data)
        convert(tmp_path / "a.fsim", tmp_path / "a.tfsim")
        convert(tmp_path / "a.tfsim", tmp_path / "b.fsim")
        back = read_fsim(tmp_path / "b.fsim")
        assert back.dbkey == "conv"
        np.testing.assert_array_equal(
            np.asarray(back.fingerprints), data.fingerprints
        )
        assert back.ids == data.ids

    def test_load_any(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=7)
        write_fsim(tmp_path / "f.fsim", data)
        save_native(tmp_path / "n.tfsim", data)
        assert load_any(tmp_path / "f.fsim").count == 7
        assert load_any(tmp_path / "n.tfsim").count == 7

    def test_registry_loads_native(self, tmp_path, rng):
        from gpusimilarity_jax.models import DatabaseRegistry

        data = random_fingerprint_data(rng, count=30)
        save_native(tmp_path / "natdb.tfsim", data)
        reg = DatabaseRegistry.from_fsim_files([str(tmp_path / "natdb.tfsim")])
        assert reg.names() == ["natdb"]
        q = data.packed_words()[2]
        r = reg.search_databases(["natdb"], [""], q, k=3)
        assert r.scores[0] == 1.0

    def test_convertdb_cli(self, tmp_path, rng):
        from gpusimilarity_jax.cli import convertdb

        data = random_fingerprint_data(rng, count=9, dbkey="cli")
        write_fsim(tmp_path / "c.fsim", data)
        convertdb.main([str(tmp_path / "c.fsim"), str(tmp_path / "c.tfsim")])
        assert load_native(tmp_path / "c.tfsim").dbkey == "cli"


class TestMmapFoldedRescore:
    """Fold-N search over a memory-mapped .tfsim must not materialize the
    full-width matrix in RAM: the engine's rescore source stays a view of
    the mapped file and only candidate rows' pages are touched — this is
    what makes folding work for libraries larger than host memory
    (round-1 review: fold search previously implied a full host copy)."""

    def test_folded_search_from_mmap_is_zero_copy_and_exact(self, tmp_path, rng):
        import numpy as np

        from conftest import random_fingerprint_data
        from gpusimilarity_jax.models import FingerprintDB
        from gpusimilarity_jax.ops.scan import scores_np
        from gpusimilarity_jax.utils.tfsim import load_native, save_native

        data = random_fingerprint_data(rng, count=3000, dbkey="mm")
        save_native(tmp_path / "mm.tfsim", data)
        mapped = load_native(tmp_path / "mm.tfsim", mmap=True)
        assert isinstance(mapped.fingerprints, np.memmap)

        db = FingerprintDB(mapped, fold_factor=4)
        # the rescore source is a view of the mapped file, not a RAM copy
        assert np.shares_memory(db._full_words, mapped.fingerprints)

        words = mapped.packed_words()
        assert np.shares_memory(words, mapped.fingerprints)
        r = db.search(np.array(words[123]), k=10, dbkey="mm")
        assert r.scores[0] == 1.0 and r.ids[0] == db.get_id(123)
        # every returned score is an exact full-width score
        oracle = scores_np(np.array(words), np.array(words[123])[None, :])[0]
        for rid, rs in zip(r.ids, r.scores):
            assert float(oracle[int(rid[4:])]) == rs


class TestCompactStringTables:
    def test_strided_and_constant_roundtrip(self, tmp_path):
        from gpusimilarity_jax.utils.fsim import FingerprintData
        from gpusimilarity_jax.utils.strings import (
            ConstantStringTable,
            StridedStringTable,
        )

        n = 50
        ids = StridedStringTable.from_strings(
            [f"ZINC{i:06d}".encode() for i in range(n)]
        )
        data = FingerprintData(
            dbkey="c", bitcount=1024,
            fingerprints=np.zeros((n, 128), np.uint8),
            smiles=ConstantStringTable(b"C", n), ids=ids,
        )
        path = tmp_path / "compact.tfsim"
        save_native(path, data)
        # no offsets index files on disk for compact layouts
        assert not (path / "ids.idx.npy").exists()
        assert not (path / "smiles.blob").exists()
        back = load_native(path)
        assert back.ids[7] == b"ZINC000007"
        assert back.smiles[49] == b"C"
        assert len(back.ids) == n == len(back.smiles)
        back.validate()

    def test_strided_rejects_ragged(self):
        from gpusimilarity_jax.utils.strings import StridedStringTable

        with pytest.raises(ValueError, match="fixed-width"):
            StridedStringTable.from_strings([b"ab", b"abc"])

    def test_compact_layouts_stamp_format_version_2(self, tmp_path):
        """strided/constant tables are a v2 feature: a v1-only reader must
        see a clear version error, not a missing-file crash deep in the
        loader. Plain offsets tables keep writing v1."""
        import json

        from gpusimilarity_jax.utils.fsim import FingerprintData
        from gpusimilarity_jax.utils.strings import ConstantStringTable

        n = 4
        compact = FingerprintData(
            dbkey="v", bitcount=1024,
            fingerprints=np.zeros((n, 128), np.uint8),
            smiles=ConstantStringTable(b"C", n),
            ids=[f"I{i}".encode() for i in range(n)],
        )
        path = tmp_path / "v2.tfsim"
        save_native(path, compact)
        assert json.loads((path / "meta.json").read_text())[
            "format_version"
        ] == 2
        assert load_native(path).smiles[0] == b"C"  # current reader accepts

        plain = FingerprintData(
            dbkey="v", bitcount=1024,
            fingerprints=np.zeros((n, 128), np.uint8),
            smiles=[b"C"] * n, ids=[f"I{i}".encode() for i in range(n)],
        )
        path1 = tmp_path / "v1.tfsim"
        save_native(path1, plain)
        assert json.loads((path1 / "meta.json").read_text())[
            "format_version"
        ] == 1

    def test_reader_rejects_future_versions(self, tmp_path, rng):
        import json

        data = random_fingerprint_data(rng, count=3)
        path = tmp_path / "future.tfsim"
        save_native(path, data)
        meta = json.loads((path / "meta.json").read_text())
        meta["format_version"] = 99
        (path / "meta.json").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="format version 99"):
            load_native(path)

    def test_constant_table_with_non_utf8_bytes_roundtrips(self, tmp_path):
        """The string-table API is bytes-based; a constant value that isn't
        UTF-8 must still save/load byte-exactly (latin1-in-JSON escape)."""
        from gpusimilarity_jax.utils.fsim import FingerprintData
        from gpusimilarity_jax.utils.strings import ConstantStringTable

        raw = b"\xff\xfe\x00raw"
        n = 3
        data = FingerprintData(
            dbkey="nb", bitcount=1024,
            fingerprints=np.zeros((n, 128), np.uint8),
            smiles=ConstantStringTable(raw, n),
            ids=[f"I{i}".encode() for i in range(n)],
        )
        path = tmp_path / "nonutf8.tfsim"
        save_native(path, data)
        back = load_native(path)
        assert back.smiles[0] == raw
        assert (path / "meta.json").exists()  # no half-written temp left


class TestStreamWriter:
    def test_stream_matches_save_native(self, tmp_path, rng):
        from gpusimilarity_jax.utils.tfsim import TfsimStreamWriter

        data = random_fingerprint_data(rng, count=137, dbkey="sw")
        ref = tmp_path / "ref.tfsim"
        save_native(ref, data)

        out = tmp_path / "stream.tfsim"
        with TfsimStreamWriter(out, bitcount=1024, dbkey="sw") as w:
            # deliberately uneven batches incl. an empty one
            for lo, hi in ((0, 1), (1, 1), (1, 64), (64, 137)):
                w.append_batch(
                    data.fingerprints[lo:hi],
                    list(data.smiles[lo:hi]),
                    list(data.ids[lo:hi]),
                )
        a, b = load_native(ref), load_native(out)
        assert b.count == 137 and b.dbkey == "sw"
        np.testing.assert_array_equal(
            np.asarray(a.fingerprints), np.asarray(b.fingerprints)
        )
        assert list(a.smiles) == list(b.smiles)
        assert list(a.ids) == list(b.ids)

    def test_abort_on_error_leaves_nothing(self, tmp_path):
        from gpusimilarity_jax.utils.tfsim import TfsimStreamWriter

        out = tmp_path / "bad.tfsim"
        with pytest.raises(ValueError):
            with TfsimStreamWriter(out, bitcount=1024) as w:
                w.append_batch(np.zeros((2, 128), np.uint8), [b"C"], [b"X"])
        assert not out.exists()
        assert not list(tmp_path.iterdir())  # temp dir cleaned up

    def test_refuses_existing(self, tmp_path, rng):
        from gpusimilarity_jax.utils.tfsim import TfsimStreamWriter

        data = random_fingerprint_data(rng, count=3)
        out = tmp_path / "dup.tfsim"
        save_native(out, data)
        with pytest.raises(FileExistsError):
            TfsimStreamWriter(out)

    def test_rejects_non_uint8_fingerprint_arrays(self, tmp_path):
        """np.asarray(packed_words, np.uint8) would VALUE-truncate every
        uint32 word to its low byte and write a silently corrupt database
        — the writer must reject non-uint8 arrays outright."""
        from gpusimilarity_jax.utils.tfsim import TfsimStreamWriter

        out = tmp_path / "typed.tfsim"
        words = np.arange(2 * 32, dtype=np.uint32).reshape(2, 32)
        with pytest.raises(TypeError, match="uint8"):
            with TfsimStreamWriter(out, bitcount=1024) as w:
                w.append_batch(words, [b"C", b"C"], [b"A", b"B"])
        assert not out.exists()
        # the documented escape hatch works and round-trips byte-exactly
        with TfsimStreamWriter(out, bitcount=1024) as w:
            w.append_batch(words.view(np.uint8), [b"C", b"C"], [b"A", b"B"])
        back = load_native(out)
        np.testing.assert_array_equal(
            np.asarray(back.fingerprints).view(np.uint32).reshape(2, 32),
            words,
        )

    def test_overwrite_swaps_only_at_close(self, tmp_path, rng):
        """overwrite=True keeps the old database until the new one is
        fully built: an abort mid-write must leave the original intact."""
        from gpusimilarity_jax.utils.tfsim import TfsimStreamWriter

        data = random_fingerprint_data(rng, count=3, dbkey="old")
        out = tmp_path / "swap.tfsim"
        save_native(out, data)

        with pytest.raises(RuntimeError, match="boom"):
            with TfsimStreamWriter(out, bitcount=1024, dbkey="new",
                                   overwrite=True) as w:
                w.append_batch(np.zeros((1, 128), np.uint8), [b"C"], [b"X"])
                raise RuntimeError("boom")
        assert load_native(out).dbkey == "old"  # original survived

        with TfsimStreamWriter(out, bitcount=1024, dbkey="new",
                               overwrite=True) as w:
            w.append_batch(np.zeros((1, 128), np.uint8), [b"C"], [b"X"])
        assert load_native(out).dbkey == "new"  # clean swap on success
        assert list(tmp_path.glob("*.old.*")) == []  # no litter

    def test_createdb_streams_tfsim_and_serves(self, tmp_path):
        """createdb --output foo.tfsim -> registry serve round-trip
        (VERDICT r3 item 6: no double write through convertdb)."""
        import gzip

        from gpusimilarity_jax.cli import createdb
        from gpusimilarity_jax.models.registry import DatabaseRegistry
        from gpusimilarity_jax.utils.fingerprints import (
            smiles_to_fingerprint_bin,
        )

        smiles = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CCCC", "C1CCCCC1"]
        smi = tmp_path / "in.smi.gz"
        with gzip.open(smi, "wb") as f:
            for i, s in enumerate(smiles):
                f.write(f"{s} ID{i}\n".encode())
            f.write(b"not_a_smiles_(((( BAD1\n")  # dropped with a warning

        out = tmp_path / "db.tfsim"
        createdb.main([str(smi), str(out), "--dbkey", "k2", "--singleThreaded"])
        assert is_native(out)
        data = load_native(out)
        assert data.count == 6 and data.dbkey == "k2"
        assert data.generator  # provenance tag survives streaming
        assert list(data.ids) == [f"ID{i}".encode() for i in range(6)]

        reg = DatabaseRegistry.from_fsim_files([str(out)])
        fp, _ = smiles_to_fingerprint_bin("CCO")
        r = reg.search_databases(
            ["db"], ["k2"], np.frombuffer(fp, np.uint8).view(np.uint32),
            k=3,
        )
        assert r.scores[0] == 1.0 and r.ids[0] == "ID0"


class TestPrewarm:
    def test_folded_mmap_library_prewarms_rescore_pages(self, tmp_path, rng, caplog):
        """A folded library loaded from a .tfsim map re-touches its pages
        after upload (the exact-rescore otherwise faults cold pages at
        serve time; 768M-row run measured 2-3 s/query vs 150 ms warm)."""
        import logging

        from gpusimilarity_jax.models import FingerprintDB

        data = random_fingerprint_data(rng, count=2048, dbkey="pw")
        path = tmp_path / "pw.tfsim"
        save_native(path, data)
        loaded = load_native(path)
        assert isinstance(loaded.fingerprints, np.memmap)
        with caplog.at_level(logging.INFO, logger="gpusimilarity_jax"):
            db = FingerprintDB(loaded, fold_factor=2)
        assert any("prewarmed" in r.message for r in caplog.records)
        r = db.search(data.packed_words()[5], k=3, dbkey="pw")
        assert r.scores[0] == 1.0

    def test_unfolded_or_ram_library_skips_prewarm(self, rng, caplog):
        import logging

        from gpusimilarity_jax.models import FingerprintDB

        data = random_fingerprint_data(rng, count=512, dbkey="pw")
        with caplog.at_level(logging.INFO, logger="gpusimilarity_jax"):
            FingerprintDB(data, fold_factor=2)  # RAM-backed: nothing to warm
            FingerprintDB(data)  # unfolded: no rescore path
        assert not any("prewarmed" in r.message for r in caplog.records)

    def test_tfsim_tables_classified_as_mmap_backed(self, tmp_path, rng):
        """Table construction views the blob, downcasting np.memmap to
        ndarray — the base-chain walk must still classify .tfsim tables
        as mmap-backed (they drove both the multihost string policy and
        the blob prewarm to the wrong branch)."""
        from gpusimilarity_jax.parallel.multihost import needs_host_sharding
        from gpusimilarity_jax.utils.strings import mmap_backing

        data = random_fingerprint_data(rng, count=64, dbkey="m")
        path = tmp_path / "m.tfsim"
        save_native(path, data)
        loaded = load_native(path)
        assert mmap_backing(loaded.ids._blob) is not None
        assert needs_host_sharding(loaded.ids) is False
        assert needs_host_sharding(loaded.smiles) is False
        # RAM-backed tables still classify as needing sharding
        assert needs_host_sharding(data.ids) is True

    def test_prewarm_fires_through_view_downcast(self, tmp_path, rng, caplog):
        """Load paths can hand the engine a VIEW of the mapped file (slice,
        dtype view, np.asarray), which downcasts np.memmap to plain ndarray
        — the prewarm gate walks the base chain, so the folded-library page
        re-touch still fires (a bare isinstance silently skipped it)."""
        import dataclasses
        import logging

        from gpusimilarity_jax.models import FingerprintDB

        data = random_fingerprint_data(rng, count=2048, dbkey="pwv")
        path = tmp_path / "pwv.tfsim"
        save_native(path, data)
        loaded = load_native(path)
        viewed = np.asarray(loaded.fingerprints)
        assert not isinstance(viewed, np.memmap)  # the downcast under test
        data2 = dataclasses.replace(loaded, fingerprints=viewed)
        with caplog.at_level(logging.INFO, logger="gpusimilarity_jax"):
            db = FingerprintDB(data2, fold_factor=2)
        assert any("prewarmed" in r.message for r in caplog.records)
        r = db.search(data.packed_words()[5], k=3, dbkey="pwv")
        assert r.scores[0] == 1.0


class TestCreatedbOverwrite:
    """`createdb` must treat an existing output identically for both
    formats: refuse up front (before the long fingerprinting pass) unless
    --force, for .fsim and .tfsim alike."""

    @pytest.mark.parametrize("ext", [".fsim", ".tfsim"])
    def test_refuses_then_forces(self, tmp_path, ext):
        from gpusimilarity_jax.cli import createdb

        smi = tmp_path / "in.smi"
        smi.write_text("CCO ethanol\nCCN ethylamine\n")
        out = tmp_path / ("db" + ext)
        argv = [str(smi), str(out), "--dbkey", "k", "--singleThreaded"]
        createdb.main(argv)
        assert out.exists()
        with pytest.raises(SystemExit):
            createdb.main(argv)  # second run without --force refuses
        createdb.main(argv + ["--force"])  # explicit overwrite succeeds
        loaded = load_any(out)
        assert loaded.count == 2

    @pytest.mark.parametrize("ext", [".fsim", ".tfsim"])
    def test_force_keeps_old_database_until_the_new_one_is_complete(
        self, tmp_path, ext, monkeypatch
    ):
        """--force must NOT delete the existing output before the
        (potentially hours-long) build: a mid-build failure leaves the
        previous database intact and serving."""
        from gpusimilarity_jax.cli import createdb

        smi = tmp_path / "in.smi"
        smi.write_text("CCO ethanol\nCCN ethylamine\n")
        out = tmp_path / ("db" + ext)
        argv = [str(smi), str(out), "--dbkey", "k", "--singleThreaded"]
        createdb.main(argv)
        before = load_any(out)
        assert before.count == 2

        def boom(*a, **k):
            raise RuntimeError("simulated mid-build failure")
            yield  # pragma: no cover — keep it a generator

        monkeypatch.setattr(createdb, "iter_fingerprint_batches", boom)
        with pytest.raises(RuntimeError, match="mid-build"):
            createdb.main(argv + ["--force"])
        survived = load_any(out)  # the old database is still there
        assert survived.count == 2
        assert [bytes(s) for s in survived.ids] == [
            bytes(s) for s in before.ids
        ]
