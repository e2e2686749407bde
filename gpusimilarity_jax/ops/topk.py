"""Exact top-k selection without a full sort, plus cutoff accounting.

The reference full-sorts all N scores on GPU per query
(``thrust::sort_by_key`` at ``fingerprintdb_cuda.cu:280-282``) — O(N log N)
and the dominant non-scan cost. Here a two-level exact reduction is used:
segment the score vector, take a per-segment ``lax.top_k``, then a final
``top_k`` over the ``segments * k`` survivors. The union of per-segment top-k
sets always contains the global top-k, so the result is exact while touching
each score once.

Cutoff semantics mirror the reference kernel + compaction
(``fingerprintdb_cuda.cu:98-99, 263-277``): scores below the cutoff are
excluded from results, and ``approximate_result_count`` is the number of
library entries scoring >= cutoff (or the whole library when cutoff == 0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# plain float: a jnp scalar at import time would initialize the XLA
# backend before jax.distributed.initialize() can run (multi-host)
NEG_INF = float("-inf")


def _pad_to_multiple(x: jax.Array, multiple: int, value) -> jax.Array:
    n = x.shape[-1]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, rem)]
    return jnp.pad(x, pad, constant_values=value)


def exact_topk(
    scores: jax.Array, k: int, segment: int = 8192
) -> tuple[jax.Array, jax.Array]:
    """Exact (values, indices) of the k largest along the last axis.

    ``scores`` is ``f32[..., N]``; returns ``f32[..., k]``, ``int32[..., k]``
    sorted descending. Ties resolve to the lowest index (``lax.top_k``
    semantics), making results deterministic. For small N this is a single
    ``lax.top_k``; for large N a segmented two-level reduction.
    """
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} > N={n}")
    if n <= max(2 * segment, 2 * k):
        vals, idx = jax.lax.top_k(scores, k)
        return vals, idx.astype(jnp.int32)

    padded = _pad_to_multiple(scores, segment, NEG_INF)
    n_pad = padded.shape[-1]
    n_seg = n_pad // segment
    seg_k = min(k, segment)
    seg_scores = padded.reshape(*scores.shape[:-1], n_seg, segment)
    seg_vals, seg_idx = jax.lax.top_k(seg_scores, seg_k)  # (..., n_seg, seg_k)
    offsets = (jnp.arange(n_seg, dtype=jnp.int32) * segment)[:, None]
    global_idx = seg_idx.astype(jnp.int32) + offsets
    flat_vals = seg_vals.reshape(*scores.shape[:-1], n_seg * seg_k)
    flat_idx = global_idx.reshape(*scores.shape[:-1], n_seg * seg_k)
    top_vals, top_pos = jax.lax.top_k(flat_vals, k)
    top_idx = jnp.take_along_axis(flat_idx, top_pos.astype(jnp.int32), axis=-1)
    return top_vals, top_idx


def count_above(scores: jax.Array, cutoff) -> jax.Array:
    """Entries scoring >= cutoff along the last axis (``approximate_count``).

    int32: a single shard never exceeds 2**31 rows (16 GiB HBM holds ~125 M
    packed 1024-bit rows); cross-shard totals are summed in Python int64.
    """
    return jnp.sum((scores >= cutoff).astype(jnp.int32), axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "segment"))
def topk_with_cutoff(
    scores: jax.Array, k: int, cutoff: jax.Array, segment: int = 8192
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fused cutoff + top-k: returns (values, indices, approximate_count).

    Sub-cutoff entries are masked to -inf so they sort behind every survivor;
    callers truncate the k results to ``min(k, approximate_count)`` when
    cutoff > 0, matching the reference's compaction behavior. When
    ``cutoff <= 0`` the approximate count is the full library size.
    """
    n = scores.shape[-1]
    approx = jnp.where(
        cutoff > 0, count_above(scores, cutoff), jnp.int32(n)
    )
    masked = jnp.where(scores >= cutoff, scores, NEG_INF)
    vals, idx = exact_topk(masked, k, segment=segment)
    return vals, idx, approx


def merge_topk(
    vals_list: jax.Array, idx_list: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge per-shard top-k candidate lists into a global top-k.

    ``vals_list``/``idx_list`` are ``(..., S, k)`` per-shard results with
    *global* indices; returns ``(..., k)``. This is the all-gather merge that
    replaces the reference's host-thread fan-in + mutex + full re-sort
    (``fingerprintdb_cuda.cu:333-338, 363-380``).
    """
    flat_vals = vals_list.reshape(*vals_list.shape[:-2], -1)
    flat_idx = idx_list.reshape(*idx_list.shape[:-2], -1)
    vals, pos = jax.lax.top_k(flat_vals, k)
    idx = jnp.take_along_axis(flat_idx, pos.astype(jnp.int32), axis=-1)
    return vals, idx
