"""Shared client-side encoders for the reference socket protocol tests."""

from gpusimilarity_jax.utils.qtstream import QtStreamReader, QtStreamWriter


def encode_request(dbname_keys, request_num, count, cutoff, fp: bytes) -> bytes:
    w = QtStreamWriter()
    w.write_int32(len(dbname_keys))
    for name, key in dbname_keys:
        w.write_string(name.encode())
        w.write_string(key.encode())
    w.write_int32(request_num)
    w.write_int32(count)
    w.write_double(cutoff)
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
