"""Tests for the Qt-stream layer and the .fsim v3 reader/writer."""

import struct
import zlib

import numpy as np
import pytest

from gpusimilarity_jax.utils import qtstream
from gpusimilarity_jax.utils.fsim import (
    FingerprintData,
    merge_fsim,
    read_fsim,
    write_fsim,
)

from conftest import random_fingerprint_data


class TestQtStream:
    def test_write_string_layout(self):
        w = qtstream.QtStreamWriter()
        w.write_string(b"pass")
        # uint32 length including NUL, then bytes, then NUL — matches the
        # observed header bytes of the reference fixture.
        assert w.getvalue() == b"\x00\x00\x00\x05pass\x00"

    def test_write_empty_and_null_string(self):
        w = qtstream.QtStreamWriter()
        w.write_string(b"")
        w.write_string(None)
        assert w.getvalue() == b"\x00\x00\x00\x01\x00" + b"\xff\xff\xff\xff"
        r = qtstream.QtStreamReader(w.getvalue())
        assert r.read_string() == b""
        assert r.read_string() is None

    def test_int_roundtrip(self):
        w = qtstream.QtStreamWriter()
        w.write_int32(-7)
        w.write_uint32(0xDEADBEEF)
        w.write_uint64(1 << 40)
        w.write_double(0.25)
        r = qtstream.QtStreamReader(w.getvalue())
        assert r.read_int32() == -7
        assert r.read_uint32() == 0xDEADBEEF
        assert r.read_uint64() == 1 << 40
        assert r.read_double() == 0.25
        assert r.at_end()

    def test_qcompress_roundtrip(self):
        payload = b"hello fingerprint world" * 100
        c = qtstream.qcompress(payload)
        # 4-byte BE uncompressed size header + zlib magic
        assert struct.unpack(">I", c[:4])[0] == len(payload)
        assert c[4] == 0x78
        assert qtstream.quncompress(c) == payload

    def test_quncompress_rejects_bad_size(self):
        c = struct.pack(">I", 5) + zlib.compress(b"xx")
        with pytest.raises(qtstream.QtStreamError):
            qtstream.quncompress(c)

    def test_string_chunk_roundtrip(self):
        strings = [b"CCO", b"", b"c1ccccc1", b"ZINC00000001"]
        chunk = qtstream.pack_string_chunk(strings)
        assert qtstream.parse_string_chunk(chunk) == strings

    def test_truncated_stream_raises(self):
        r = qtstream.QtStreamReader(b"\x00\x00")
        with pytest.raises(qtstream.QtStreamError):
            r.read_int32()


class TestFsimRoundtrip:
    def test_roundtrip(self, tmp_path, rng):
        data = random_fingerprint_data(rng, count=257, dbkey="secret")
        path = tmp_path / "rt.fsim"
        write_fsim(path, data)
        back = read_fsim(path)
        assert back.dbkey == "secret"
        assert back.bitcount == 1024
        assert back.count == 257
        np.testing.assert_array_equal(back.fingerprints, data.fingerprints)
        assert back.smiles == data.smiles
        assert back.ids == data.ids

    def test_multi_chunk_roundtrip(self, tmp_path, rng):
        # Tiny chunk limit forces multiple fp/smiles/id chunks, exercising the
        # same rollover logic the reference uses at 1 GiB.
        data = random_fingerprint_data(rng, count=100)
        path = tmp_path / "chunked.fsim"
        write_fsim(path, data, chunk_limit=1000)
        back = read_fsim(path)
        assert back.count == 100
        np.testing.assert_array_equal(back.fingerprints, data.fingerprints)
        assert back.smiles == data.smiles
        assert back.ids == data.ids

    def test_empty_db_roundtrip(self, tmp_path):
        data = FingerprintData()
        path = tmp_path / "empty.fsim"
        write_fsim(path, data)
        back = read_fsim(path)
        assert back.count == 0

    def test_validate_catches_mismatch(self):
        data = FingerprintData(
            fingerprints=np.zeros((2, 128), np.uint8), smiles=[b"C"], ids=[b"X"]
        )
        with pytest.raises(ValueError):
            data.validate()

    def test_packed_words_shape(self, rng):
        data = random_fingerprint_data(rng, count=10)
        words = data.packed_words()
        assert words.shape == (10, 32)
        assert words.dtype == np.uint32
        # word 0 contains bytes 0..3 little-endian
        expected = (
            data.fingerprints[:, 0].astype(np.uint32)
            | (data.fingerprints[:, 1].astype(np.uint32) << 8)
            | (data.fingerprints[:, 2].astype(np.uint32) << 16)
            | (data.fingerprints[:, 3].astype(np.uint32) << 24)
        )
        np.testing.assert_array_equal(words[:, 0], expected)


class TestReferenceGolden:
    """Golden-parity against the reference's own fixture (read in place)."""

    def test_read_reference_fixture(self, reference_fixture_path):
        data = read_fsim(reference_fixture_path)
        assert data.dbkey == "pass"
        assert data.bitcount == 1024
        assert data.count == 100
        assert len(data.smiles) == 100
        assert len(data.ids) == 100
        assert all(i.startswith(b"ZINC") for i in data.ids)
        # every fingerprint of a real molecule has at least one bit set
        assert (np.unpackbits(data.fingerprints, axis=1).sum(axis=1) > 0).all()

    def test_rewrite_reference_fixture_roundtrips(self, reference_fixture_path, tmp_path):
        data = read_fsim(reference_fixture_path)
        out = tmp_path / "rewritten.fsim"
        write_fsim(out, data)
        back = read_fsim(out)
        assert back.dbkey == data.dbkey
        np.testing.assert_array_equal(back.fingerprints, data.fingerprints)
        assert back.smiles == data.smiles
        assert back.ids == data.ids

    def test_header_bytes_match_reference_writer(self, reference_fixture_path, tmp_path):
        """Our writer produces the exact header byte layout of the reference."""
        data = read_fsim(reference_fixture_path)
        out = tmp_path / "hdr.fsim"
        write_fsim(out, data)
        hdr = open(out, "rb").read(21)
        assert hdr[:4] == b"\x00\x00\x00\x03"  # version
        assert hdr[4:13] == b"\x00\x00\x00\x05pass\x00"  # dbkey
        assert hdr[13:17] == b"\x00\x00\x04\x00"  # bitcount 1024
        assert hdr[17:21] == b"\x00\x00\x00\x64"  # count 100


class TestMerge:
    def test_merge(self, tmp_path, rng):
        a = random_fingerprint_data(rng, count=10, dbkey="k")
        b = random_fingerprint_data(rng, count=15, dbkey="k")
        pa, pb, out = tmp_path / "a.fsim", tmp_path / "b.fsim", tmp_path / "m.fsim"
        write_fsim(pa, a)
        write_fsim(pb, b)
        merged = merge_fsim([pa, pb], out)
        assert merged.count == 25
        back = read_fsim(out)
        assert back.dbkey == "k"  # the reference merger drops this — we don't
        assert back.count == 25
        np.testing.assert_array_equal(back.fingerprints[:10], a.fingerprints)
        np.testing.assert_array_equal(back.fingerprints[10:], b.fingerprints)
        assert back.ids == a.ids + b.ids

    def test_merge_dbkey_mismatch(self, tmp_path, rng):
        a = random_fingerprint_data(rng, count=3, dbkey="one")
        b = random_fingerprint_data(rng, count=3, dbkey="two")
        pa, pb = tmp_path / "a.fsim", tmp_path / "b.fsim"
        write_fsim(pa, a)
        write_fsim(pb, b)
        with pytest.raises(ValueError):
            merge_fsim([pa, pb], tmp_path / "m.fsim")
        merged = merge_fsim([pa, pb], tmp_path / "m.fsim", dbkey="forced")
        assert merged.dbkey == "forced"

    def test_merge_untagged_with_tagged(self, tmp_path, rng):
        """An untagged file (e.g. reference-built) is unknown provenance,
        not incompatible — merge succeeds and keeps the tagged side's tag
        (round-2 review finding)."""
        a = random_fingerprint_data(rng, count=4, dbkey="k")
        b = random_fingerprint_data(rng, count=4, dbkey="k")
        a.generator = ""
        b.generator = "rdkit-morgan-r2-1024"
        pa, pb = tmp_path / "a.fsim", tmp_path / "b.fsim"
        write_fsim(pa, a)
        write_fsim(pb, b)
        merged = merge_fsim([pa, pb], tmp_path / "m.fsim")
        assert merged.generator == "rdkit-morgan-r2-1024"
        # compatible pair still merges; incompatible still refuses
        c = random_fingerprint_data(rng, count=4, dbkey="k")
        c.generator = "rdkit-compat-morgan-r2-1024"
        pc = tmp_path / "c.fsim"
        write_fsim(pc, c)
        assert merge_fsim([pb, pc], tmp_path / "m2.fsim").count == 8
        d = random_fingerprint_data(rng, count=4, dbkey="k")
        d.generator = "builtin-morgan-r2-1024"
        pd = tmp_path / "d.fsim"
        write_fsim(pd, d)
        with pytest.raises(ValueError):
            merge_fsim([pb, pd], tmp_path / "m3.fsim")

    def test_untagged_rewrite_clears_stale_sidecar(self, tmp_path, rng):
        a = random_fingerprint_data(rng, count=4, dbkey="k")
        a.generator = "rdkit-morgan-r2-1024"
        p = tmp_path / "x.fsim"
        write_fsim(p, a)
        assert read_fsim(p).generator == "rdkit-morgan-r2-1024"
        b = random_fingerprint_data(rng, count=4, dbkey="k")
        b.generator = ""
        write_fsim(p, b)  # rewrite in place with untagged data
        assert read_fsim(p).generator == ""

    def test_merge_bitcount_mismatch(self, tmp_path, rng):
        a = random_fingerprint_data(rng, count=3, bitcount=1024)
        b = random_fingerprint_data(rng, count=3, bitcount=512)
        pa, pb = tmp_path / "a.fsim", tmp_path / "b.fsim"
        write_fsim(pa, a)
        write_fsim(pb, b)
        with pytest.raises(ValueError):
            merge_fsim([pa, pb], tmp_path / "m.fsim")
