"""Pallas (Triton route) kernel for phase 1 of the bit-sliced (bitplane) scan.

The XLA version (``parallel/sharded._bitplane_local_topk``,
``per_query_xla_phase1``) reads all P plane windows of a query's bucket
(sentinel planes included), sums them with an unrolled Wallace tree and
expands the bit-sliced counters in separate fusions, one query at a time
under ``lax.map``. This kernel does the whole per-tile pipeline in
registers:

* the grid is ``(column tile, query)``; each program loads its own query's
  plane indices and counts the real (non-sentinel) ones, so a query reads
  only its ~40 set-bit planes, never the padding of its bucket;
* a loop over those planes loads each plane's ``tile`` consecutive words
  (coalesced) and ripple-adds them into ``bit_length(P)`` bit-sliced
  counters;
* the counters expand to per-column intersection counts as a
  ``(tile, 32)`` tile, which is scored against the stored per-column
  popcounts (read directly, ``(tile, 32)`` consecutive int16s);
* it writes the per-word maxima (the selection layer's input) and one
  cutoff count per program; counts are summed outside the kernel, since
  programs run in no order and nothing carries between them.

Tanimoto scores are bit-identical to the numpy oracle: Triton lowers an
f32 divide to the approximate ``div.full.f32``, so on the card the
Tanimoto division is the IEEE ``div.rn.f32`` through inline PTX — the
quotient ``ops.scan.exact_div`` gives the XLA paths and the exact rescore.
Tversky divides with ``ops.scan.faithful_div`` (the plain divide plus one
correction step, within 1 ulp), as every other path does
(``ops.scan.similarity_from_counts``), so phase 1 and the rescore of one
search score alike. ``interpret=True`` runs the same body
on the CPU (where the plain divide is IEEE) — that is how the tests reach
it.

Layouts (see ``parallel/sharded.BitplaneStore``): per shard, plane ``p``
occupies rows ``8p .. 8p+7`` of ``(8 * (bitcount + 1), M8s)``, i.e. one
contiguous run of ``Ms = 8 * M8s`` words; word ``j`` of that run holds the
bits of columns ``32 * j .. 32 * j + 31``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .scan import TANIMOTO, faithful_div

NEG_INF = float("-inf")

#: words per program: a (TILE, 32) score tile is 8192 columns
TILE_WORDS = 256


def _div_rn_ptx(x, y):
    """IEEE round-to-nearest f32 divide (Triton's ``/`` is approximate)."""
    [q] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[x, y],
        constraints="=f,f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.float32)],
    )
    return q


def _kernel(
    idx_ref,  # (B, P) int32 plane indices, real ones first, sentinel=bitcount
    planes_ref,  # (bitcount + 1, Ms) uint32
    pops_ref,  # (Ms, 32) int16 per-column popcounts
    qpop_ref,  # (B,) int32
    cut_ref,  # (B,) f32
    ab_ref,  # (2,) f32 Tversky alpha, beta
    off_ref,  # (1,) int32 shard's first global column
    colmax_ref,  # out (B, Ms) f32 per-word maxima
    cnt_ref,  # out (B, n_tiles) int32 per-program cutoff counts
    *,
    tile: int,
    n_counters: int,
    bitcount: int,
    n_valid: int,
    similarity: str,
    div,
):
    ti = pl.program_id(0)
    qb = pl.program_id(1)
    base = ti * tile
    n_real = jnp.sum((idx_ref[qb, :] < bitcount).astype(jnp.int32))

    def add_plane(pi, counters):
        carry = planes_ref[idx_ref[qb, pi], pl.ds(base, tile)]
        out = []
        for c in counters:
            out.append(c ^ carry)
            carry = c & carry
        return tuple(out)

    zero = jnp.zeros((tile,), jnp.uint32)
    counters = jax.lax.fori_loop(
        0, n_real, add_plane, (zero,) * n_counters
    )

    shifts = jax.lax.broadcasted_iota(jnp.uint32, (1, 32), 1)
    common = jnp.zeros((tile, 32), jnp.int32)
    for j, c in enumerate(counters):
        bit = (c[:, None] >> shifts) & jnp.uint32(1)
        common = common + (bit << jnp.uint32(j)).astype(jnp.int32)
    cf = common.astype(jnp.float32)
    pop = pops_ref[pl.ds(base, tile), :].astype(jnp.float32)
    qpop = qpop_ref[qb].astype(jnp.float32)
    if similarity == TANIMOTO:
        denom = qpop + pop - cf
        # denom is a non-negative integer, 0 only when cf is 0
        s = div(cf, jnp.maximum(denom, 1.0))
    else:
        # the XLA paths' Tversky divide
        denom = ab_ref[0] * (qpop - cf) + ab_ref[1] * (pop - cf) + cf
        s = faithful_div(cf, jnp.where(denom > 0, denom, 1.0))
    s = jnp.where(denom > 0, s, 0.0)
    # the self-match pin of ops.scan.similarity_from_counts
    s = jnp.where((cf == denom) & (denom > 0), 1.0, s)
    col = (
        off_ref[0]
        + 32 * (base + jax.lax.broadcasted_iota(jnp.int32, (tile, 32), 0))
        + jax.lax.broadcasted_iota(jnp.int32, (tile, 32), 1)
    )
    s = jnp.where(col < n_valid, s, NEG_INF)
    colmax_ref[qb, pl.ds(base, tile)] = jnp.max(s, axis=1)
    cnt_ref[qb, ti] = jnp.sum((s >= cut_ref[qb]).astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=("n_valid", "similarity", "tile", "interpret"),
)
def bitplane_phase1(
    planes,  # uint32 (8 * (bitcount + 1), M8s) — one shard's planes
    pops,  # int16 (32 * 8 * M8s,) — that shard's per-column popcounts
    plane_idx,  # int32 (B, P)
    query_pops,  # int32 (B,)
    cutoffs,  # f32 (B,)
    alpha_beta,  # f32 (2,)
    shard_offset,  # int32 scalar
    *,
    n_valid: int,
    similarity: str = TANIMOTO,
    tile: int = TILE_WORDS,
    interpret: bool = False,
):
    """Returns ``(colmax f32 (B, 8, M8s), counts i32 (B,))``.

    ``colmax[b, r, w]`` is query b's best score over the 32 columns of
    word w of sub-row r — the layout ``per_query_wordsel`` selects from.
    """
    n_rows, m8s = planes.shape
    bitcount = n_rows // 8 - 1
    ms = 8 * m8s
    b, p = plane_idx.shape
    if ms % tile:
        raise ValueError(f"shard of {ms} words is not a multiple of {tile}")
    n_tiles = ms // tile
    kernel = functools.partial(
        _kernel,
        tile=tile,
        n_counters=max(1, p.bit_length()),
        bitcount=bitcount,
        n_valid=n_valid,
        similarity=similarity,
        div=jnp.divide if interpret else _div_rn_ptx,
    )
    colmax, cnt = pl.pallas_call(
        kernel,
        grid=(n_tiles, b),
        out_shape=[
            jax.ShapeDtypeStruct((b, ms), jnp.float32),
            jax.ShapeDtypeStruct((b, n_tiles), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="bitplane_phase1",
    )(
        plane_idx.astype(jnp.int32),
        planes.reshape(bitcount + 1, ms),
        pops.reshape(ms, 32),
        query_pops.astype(jnp.int32),
        cutoffs.astype(jnp.float32),
        alpha_beta.astype(jnp.float32),
        jnp.reshape(shard_offset, (1,)).astype(jnp.int32),
    )
    return colmax.reshape(b, 8, m8s), cnt.sum(axis=-1)
