"""Reference binary socket protocol: wire-level round trips."""

import socket

import numpy as np
import pytest

from gpusimilarity_jax.models import DatabaseRegistry
from gpusimilarity_jax.serve.batching import BatchingSearcher
from gpusimilarity_jax.serve.socket_server import (
    SocketProtocolServer,
    parse_request,
    serialize_response,
)
from gpusimilarity_jax.utils.qtstream import QtStreamReader, QtStreamWriter

from conftest import random_fingerprint_data


def encode_request(dbname_keys, request_num, count, cutoff, fp: bytes) -> bytes:
    """Client-side encoding exactly as the reference front end does
    (gpusim_server.py:76-92)."""
    w = QtStreamWriter()
    w.write_int32(len(dbname_keys))
    for name, key in dbname_keys:
        w.write_string(name.encode())
        w.write_string(key.encode())
    w.write_int32(request_num)
    w.write_int32(count)
    w.write_double(cutoff)  # Qt_5_2 writes "float" as a double
    w.write_bytearray(fp)
    return w.getvalue()


def decode_response(raw: bytes):
    r = QtStreamReader(raw)
    request_num = r.read_int32()
    count = r.read_int32()
    approx = r.read_uint64()
    smiles = [r.read_string().decode() for _ in range(count)]
    ids = [r.read_string().decode() for _ in range(count)]
    scores = [r.read_double() for _ in range(count)]
    return request_num, approx, smiles, ids, scores


class TestWireFormat:
    def test_request_roundtrip(self):
        raw = encode_request([("db1", "k1"), ("db2", "")], 42, 10, 0.5, b"\x01" * 128)
        req, used = parse_request(raw)
        assert used == len(raw)
        assert req["dbnames"] == ["db1", "db2"]
        assert req["dbkeys"] == ["k1", ""]
        assert req["request_num"] == 42
        assert req["return_count"] == 10
        assert req["cutoff"] == 0.5
        assert req["fingerprint"] == b"\x01" * 128

    def test_partial_request_raises(self):
        raw = encode_request([("db", "")], 1, 5, 0.0, b"\x00" * 128)
        from gpusimilarity_jax.utils.qtstream import QtStreamError

        with pytest.raises(QtStreamError):
            parse_request(raw[: len(raw) // 2])

    def test_response_shape(self):
        from gpusimilarity_jax.models.results import SearchResult

        r = SearchResult(
            smiles=["CCO"], ids=["X1"], scores=[0.75], approximate_count=9
        )
        request_num, approx, smiles, ids, scores = decode_response(
            serialize_response(7, r)
        )
        assert (request_num, approx, smiles, ids, scores) == (
            7, 9, ["CCO"], ["X1"], [0.75]
        )


class TestSocketServer:
    @pytest.fixture()
    def server(self, rng, tmp_path):
        reg = DatabaseRegistry()
        self.data = random_fingerprint_data(rng, count=64, dbkey="sk")
        reg.add("sockdb", self.data)
        searcher = BatchingSearcher(reg, window_ms=1.0)
        srv = SocketProtocolServer(
            searcher, socket_name="jaxsim-test.sock", socket_dir=str(tmp_path)
        )
        srv.start_background()
        yield srv
        srv.close()
        searcher.close()

    def _query(self, server, payload):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(server.path)
        c.sendall(payload)
        buf = b""
        c.settimeout(30)
        while True:
            chunk = c.recv(65536)
            buf += chunk
            try:
                return decode_response(buf)
            except Exception:
                if not chunk:
                    raise
        c.close()

    def test_end_to_end_search(self, server):
        fp = self.data.fingerprints[5].tobytes()
        payload = encode_request([("sockdb", "sk")], 1234, 5, 0.0, fp)
        request_num, approx, smiles, ids, scores = self._query(server, payload)
        assert request_num == 1234
        assert approx == 64
        assert ids[0] == "TEST00000005"
        assert scores[0] == 1.0

    def test_sequential_requests_one_connection(self, server):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(server.path)
        c.settimeout(30)
        for rn, qi in ((1, 0), (2, 9)):
            fp = self.data.fingerprints[qi].tobytes()
            c.sendall(encode_request([("sockdb", "sk")], rn, 3, 0.0, fp))
            buf = b""
            while True:
                buf += c.recv(65536)
                try:
                    request_num, _, _, ids, scores = decode_response(buf)
                    break
                except Exception:
                    continue
            assert request_num == rn
            assert ids[0] == f"TEST{qi:08d}"
        c.close()

    def test_wrong_dbkey_empty(self, server):
        fp = self.data.fingerprints[0].tobytes()
        payload = encode_request([("sockdb", "bad")], 9, 5, 0.0, fp)
        _, approx, smiles, ids, scores = self._query(server, payload)
        assert approx == 0 and ids == []
