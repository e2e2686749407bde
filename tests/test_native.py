"""Native C++ runtime: parity with the pure-Python fallbacks."""

import subprocess
import sys

import numpy as np
import pytest

from gpusimilarity_jax.utils import native
from gpusimilarity_jax.utils.qtstream import pack_string_chunk, qcompress
from gpusimilarity_jax.utils.strings import StringTable, _parse_offsets_py


@pytest.fixture(scope="session", autouse=True)
def build_native():
    """Build the shared library if absent (make is in the image)."""
    if not native.available():
        subprocess.run(
            ["make", "-C", "native"], cwd=".", capture_output=True
        )
        native._TRIED = False  # retry the load
        native._LIB = None
    if not native.available():
        pytest.skip("native library unavailable and could not be built")


class TestNative:
    def test_decompress_chunks(self, rng):
        payloads = [rng.bytes(n) for n in (10, 1000, 65536)]
        chunks = [qcompress(p) for p in payloads]
        out = native.decompress_chunks(chunks)
        for p, o in zip(payloads, out):
            assert o.tobytes() == p

    def test_decompress_rejects_corrupt(self, rng):
        good = qcompress(b"hello" * 100)
        bad = good[:4] + bytes([good[4] ^ 0xFF]) + good[5:]
        with pytest.raises(ValueError):
            native.decompress_chunks([bad])

    def test_parse_string_records_matches_python(self):
        strings = [b"CCO", b"", b"c1ccccc1", b"ZINC" * 100, b"x"]
        chunk = np.frombuffer(pack_string_chunk(strings), dtype=np.uint8)
        offs_native = native.parse_string_records(chunk)
        offs_py = _parse_offsets_py(chunk)
        np.testing.assert_array_equal(offs_native, offs_py)
        blob = chunk
        got = [blob[a:b].tobytes() for a, b in offs_native]
        assert got == strings

    def test_parse_rejects_truncated(self):
        chunk = np.frombuffer(pack_string_chunk([b"CCO"])[:-2], dtype=np.uint8)
        with pytest.raises(ValueError):
            native.parse_string_records(chunk)

    def test_popcount_rows_matches_table(self, rng):
        words = rng.integers(0, 2**32, (2048, 32), dtype=np.uint32)
        from gpusimilarity_jax.ops.scan import _POPCOUNT_TABLE

        expected = _POPCOUNT_TABLE[words.view(np.uint8)].sum(
            axis=-1, dtype=np.int32
        )
        np.testing.assert_array_equal(native.popcount_rows(words), expected)

    def test_fold_rows_matches_numpy(self, rng):
        words = rng.integers(0, 2**32, (1500, 32), dtype=np.uint32)
        for fold in (2, 4, 8):
            expected = np.bitwise_or.reduce(
                words.reshape(1500, fold, 32 // fold), axis=1
            )
            np.testing.assert_array_equal(
                native.fold_rows(words, fold), expected
            )

    def test_transpose_planar(self, rng):
        words = rng.integers(0, 2**32, (777, 32), dtype=np.uint32)
        out = native.transpose_planar(words, 1024)
        assert out.shape == (32, 1024)
        np.testing.assert_array_equal(out[:, :777], words.T)
        assert (out[:, 777:] == 0).all()


class TestStringTable:
    def test_from_strings(self):
        t = StringTable.from_strings([b"abc", b"", b"defg"])
        assert len(t) == 3
        assert t[0] == b"abc" and t[1] == b"" and t[2] == b"defg"
        assert list(t) == [b"abc", b"", b"defg"]
        assert t == [b"abc", b"", b"defg"]

    def test_from_record_chunks(self):
        c1 = pack_string_chunk([b"one", b"two"])
        c2 = pack_string_chunk([b"three"])
        t = StringTable.from_record_chunks([c1, c2])
        assert t == [b"one", b"two", b"three"]

    def test_slice(self):
        t = StringTable.from_strings([b"a", b"b", b"c"])
        assert t[1:] == [b"b", b"c"]

    def test_fsim_roundtrip_with_tables(self, tmp_path, rng):
        from conftest import random_fingerprint_data
        from gpusimilarity_jax.utils.fsim import read_fsim, write_fsim

        data = random_fingerprint_data(rng, count=50)
        write_fsim(tmp_path / "t.fsim", data)
        tab = read_fsim(tmp_path / "t.fsim", string_tables=True)
        lst = read_fsim(tmp_path / "t.fsim", string_tables=False)
        assert isinstance(tab.smiles, StringTable)
        assert tab.smiles == lst.smiles == data.smiles
        assert tab.ids == lst.ids == data.ids
        # write back from a StringTable-backed FingerprintData
        write_fsim(tmp_path / "t2.fsim", tab)
        again = read_fsim(tmp_path / "t2.fsim")
        assert again.ids == data.ids
