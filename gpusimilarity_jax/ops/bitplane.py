"""Bit-sliced (bitplane) intersection counting — the sparse-query fast path.

The dense scan reads every packed word of every fingerprint and popcounts the
AND (``scan.py``). But ``common = popcount(db_row & query)`` is also::

    common[n] = sum over set bits p of the query of  bit_p(db_row_n)

Morgan fingerprints are sparse (~30-60 of 1024 bits set), so if the library
is stored **bit-transposed** — one packed *bit-plane* per fingerprint
position, ``plane[p]`` holding bit p of every row — a query only has to read
its |q| set planes: ~25x less memory traffic and far fewer operations than the
dense kernel, with exactly the same counts. Same total memory (it is a
transpose). This is the classic bit-sliced signature index, mapped onto the
vector units: planes are summed with a Wallace-tree of carry-save adders over
whole ``uint32`` lanes, and the bit-sliced counters are expanded to integer
counts only at the end.

Layout: ``planes uint32[bitcount, n_cols / 32]`` — bit ``i`` of word ``j`` of
plane ``p`` = bit ``p`` of fingerprint ``32*j + i`` (little-endian bit order,
matching the packed-row layout everywhere else).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# query set-bit lists are padded to a bucket size; a sentinel plane index
# (== bitcount) selects an all-zero plane and contributes nothing
PLANE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def build_bitplanes_np(packed_rows: np.ndarray, n_cols: int) -> np.ndarray:
    """Transpose packed rows ``uint8[N, bytes]`` into padded bitplanes.

    Returns ``uint32[bitcount, n_cols // 32]`` (``n_cols >= N``, multiple of
    32; the padding columns are zero). The transpose is done with numpy bit
    tricks chunk-by-chunk to bound working memory.
    """
    n, nbytes = packed_rows.shape
    bitcount = nbytes * 8
    if n_cols % 32 or n_cols < n:
        raise ValueError("n_cols must be a multiple of 32 and >= row count")
    out = np.zeros((bitcount, n_cols // 8), dtype=np.uint8)  # byte view
    step = 1 << 20
    for start in range(0, n, step):
        stop = min(n, start + step)
        # (rows, bitcount) 0/1 for this slab
        bits = np.unpackbits(
            packed_rows[start:stop], axis=1, bitorder="little"
        )
        # transpose -> (bitcount, rows), then pack rows along columns
        col_bits = np.ascontiguousarray(bits.T)
        packed = np.packbits(col_bits, axis=1, bitorder="little")
        # byte range this slab occupies (start/stop multiples of 8 except tail)
        b0, b1 = start // 8, (stop + 7) // 8
        if start % 8:
            raise ValueError("chunk step must be a multiple of 8")
        out[:, b0:b1] = packed
    return np.ascontiguousarray(out).view(np.uint32).reshape(bitcount, n_cols // 32)


def plane_bucket_for(max_set: int, bitcount: int) -> int:
    """Smallest plane bucket holding ``max_set`` set bits (cap: bitcount).

    Every distinct bucket compiles its own XLA program, so warmup needs
    this mapping to precompile the buckets live traffic will hit.
    """
    bucket = next(
        (p for p in PLANE_BUCKETS if p >= max_set and p <= bitcount),
        bitcount,
    )
    return min(bucket, bitcount)


def query_plane_indices(
    query_words: np.ndarray, bitcount: int, bucket: int | None = None
) -> tuple[np.ndarray, int]:
    """Set-bit positions of packed queries, padded with the sentinel.

    ``query_words`` is ``uint32 (B, W)``; returns ``int32 (B, P)`` and P.
    """
    q = np.asarray(query_words, dtype=np.uint32)
    bits = np.unpackbits(q.view(np.uint8), axis=-1, bitorder="little")
    idx_lists = [np.nonzero(row)[0] for row in bits]
    max_set = max((len(i) for i in idx_lists), default=1)
    if bucket is None:
        bucket = plane_bucket_for(max_set, bitcount)
    bucket = min(bucket, bitcount)
    if max_set > bucket:
        raise ValueError(f"query has {max_set} bits set > bucket {bucket}")
    out = np.full((len(idx_lists), bucket), bitcount, dtype=np.int32)
    for b, idx in enumerate(idx_lists):
        out[b, : len(idx)] = idx
    return out, bucket


def _csa(a, b, c):
    """Carry-save full adder on uint32 lanes: 3 addends -> (sum, carry)."""
    axb = a ^ b
    return axb ^ c, (a & b) | (axb & c)


def wallace_popcount_planes(planes: list[jax.Array]) -> list[jax.Array]:
    """Sum P single-bit planes into bit-sliced counters (Wallace tree).

    ``planes`` is a list of same-shape uint32 arrays, each lane-bit holding a
    0/1 addend. Returns counter planes ``[c0, c1, ...]`` where the count for
    a lane-bit is ``sum_j bit(c_j) << j``. O(P) CSA ops total.
    """
    if not planes:
        raise ValueError("no planes")
    levels: list[list[jax.Array]] = [list(planes)]
    weight = 0
    result: list[jax.Array] = []
    while weight < len(levels):
        wires = levels[weight]
        while len(wires) > 2:
            rest = []
            for i in range(0, len(wires) - 2, 3):
                s, c = _csa(wires[i], wires[i + 1], wires[i + 2])
                rest.append(s)
                if weight + 1 >= len(levels):
                    levels.append([])
                levels[weight + 1].append(c)
            tail = len(wires) - (len(wires) // 3) * 3
            if tail:
                rest.extend(wires[-tail:])
            wires = rest
        if len(wires) == 2:  # half adder
            s = wires[0] ^ wires[1]
            c = wires[0] & wires[1]
            if weight + 1 >= len(levels):
                levels.append([])
            levels[weight + 1].append(c)
            wires = [s]
        result.append(wires[0] if wires else None)
        weight += 1
    return [r if r is not None else jnp.zeros_like(planes[0]) for r in result]


def counters_to_counts(counters: list[jax.Array]) -> jax.Array:
    """Expand bit-sliced counters ``[(M,) uint32, ...]`` to ``int32 (M*32,)``.

    Lane-bit i of word j is the count bit for row ``32*j + i``.
    """
    m = counters[0].shape[-1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    total = jnp.zeros((*counters[0].shape[:-1], m, 32), dtype=jnp.int32)
    for j, c in enumerate(counters):
        bits = (c[..., None] >> shifts) & jnp.uint32(1)
        total = total + (bits.astype(jnp.int32) << j)
    return total.reshape(*counters[0].shape[:-1], m * 32)


def common_from_planes(gathered: jax.Array) -> jax.Array:
    """Intersection counts from gathered query planes.

    ``gathered``: ``uint32 (P, M)`` — the query's set-bit planes over a block
    of M packed columns. Returns ``int32 (M * 32,)`` per-row common counts.
    """
    planes = [gathered[p] for p in range(gathered.shape[0])]
    counters = wallace_popcount_planes(planes)
    return counters_to_counts(counters)


def common_from_planes_np(
    planes: np.ndarray, plane_idx: np.ndarray, n_rows: int
) -> np.ndarray:
    """Numpy oracle: same computation, dumb implementation.

    ``planes`` has no sentinel row; sentinel indices (>= plane count) skip.
    """
    m = planes.shape[1]
    total = np.zeros(m * 32, dtype=np.int32)
    for p in plane_idx:
        if p >= planes.shape[0]:
            continue
        words = planes[p]
        bits = np.unpackbits(
            words.view(np.uint8), bitorder="little"
        ).astype(np.int32)
        total += bits
    return total[:n_rows]
