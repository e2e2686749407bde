"""Similarity scoring over packed fingerprint words (pure-JAX reference path).

This is the rebuild of the reference's scoring functors — the CUDA
``TanimotoFunctor`` (``fingerprintdb_cuda.cu:76-104``) and the CPU
``TanimotoFunctorCPU`` (``calculation_functors.cpp:6-20``) — as vectorized JAX
over ``uint32[N, W]`` packed fingerprints. It is both the reference the device
paths are checked against and an XLA path in its own right (the AND +
popcount + reduce fuses into a single bandwidth-bound loop).

Two deliberate improvements over the reference:

* Per-row popcounts are **precomputed once at load** instead of recomputed on
  every query (the reference popcounts both operands per scan), halving the
  per-query popcount work.
* Tversky similarity is supported as a scoring mode of the same kernel
  (the reference ships only Tanimoto despite advertising fingerprint
  agnosticism): ``sim = c / (alpha*(|q|-c) + beta*(|db|-c) + c)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TANIMOTO = "tanimoto"
TVERSKY = "tversky"

_POPCOUNT_TABLE = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(
    axis=1
).astype(np.int32)


def popcount_rows_np(words: np.ndarray) -> np.ndarray:
    """Host-side popcount of packed rows: ``uint32[N, W] -> int32[N]``.

    Used at DB load to precompute per-row totals. Uses the native C++
    accelerator when built; falls back to a byte lookup table (numpy<2.0
    lacks ``bitwise_count``).
    """
    if words.ndim == 2 and words.shape[0] >= 1024:
        try:
            from ..utils import native

            return native.popcount_rows(words)
        except ImportError:
            pass
    as_bytes = np.ascontiguousarray(words).view(np.uint8)
    return _POPCOUNT_TABLE[as_bytes].sum(axis=-1, dtype=np.int32)


def common_bits(db_words: jax.Array, query_words: jax.Array) -> jax.Array:
    """Popcount of the bitwise AND: ``(N, W) & (..., W) -> (..., N)`` int32.

    ``query_words`` may be ``(W,)`` for a single query or ``(B, W)`` for a
    batch; the result is ``(N,)`` or ``(B, N)``.
    """
    q = query_words[..., None, :]  # (..., 1, W)
    inter = jnp.bitwise_and(db_words, q)  # (..., N, W)
    return jnp.sum(jax.lax.population_count(inter).astype(jnp.int32), axis=-1)


def exact_div(num: jax.Array, den: jax.Array) -> jax.Array:
    """Correctly-rounded f32 division for small integer-valued operands.

    A backend's f32 divide need not be correctly rounded: on an NVIDIA
    H100, XLA's f32 divide misrounds 2,455,295 of the 8,392,704 quotients
    checked below (29.3%), which flips ``score >= cutoff`` at boundary
    fractions (e.g. 11/55 vs 0.2f, 15/50 vs 0.3f) and diverges returned
    scores from the numpy / reference-CUDA oracle
    (``fingerprintdb_cuda.cu:96-100`` divides with IEEE-correct
    hardware). This restores round-to-nearest-even:

      q       = fl(num/den)              faithful hardware quotient
      qh + ql = q                        Veltkamp split at 12 bits
      r       = (num - qh*den) - ql*den  EXACT residual num - q*den
      out     = q + r/den                Markstein correction step

    Exactness argument, for integer-valued ``0 <= num <= 2**12`` and
    ``1 <= den <= 2**12`` (bitcount <= 2048 => num <= 2048, den <= 4096):

    * ``qh`` has <= 12 significand bits and ``den`` <= 12, so ``qh*den`` is
      exact (<= 24-bit product); likewise ``ql*den`` (``ql`` <= 12 bits).
    * ``num - qh*den`` is exact by Sterbenz (``qh*den`` is within a factor
      of 2 of ``num`` whenever ``q`` is within a few ulp of ``num/den``).
    * the outer subtraction's true value ``r = num - q*den`` is a multiple
      of ``ulp(q)`` with ``|r| <= 2*den*ulp(q) < 2**13*ulp(q)``, hence
      representable, hence computed exactly.
    * ``num/den`` is never an f32 rounding midpoint (a midpoint needs a
      25-bit odd significand; ``num <= 2**12`` forces any dyadic quotient
      to <= 12 bits), so a faithful ``q`` plus the sign-exact correction
      lands on the correctly-rounded quotient.

    Verified exhaustively over every (num <= 2048, 1 <= den <= 4096) pair
    against numpy on CPU (tests/test_exactdiv.py) and on the H100, where
    XLA may contract the multiplies and adds into FMAs: 0 mismatches
    (``chip_smoke.py``'s division phase, ``tools/verify_exactdiv.py``).
    Cost: ~7 flops on top of the divide — invisible on the memory-bound
    scan paths.
    """
    q = num / den
    t = q * 4097.0  # 2**12 + 1: Veltkamp split constant
    qh = t - (t - q)
    ql = q - qh
    r = (num - qh * den) - ql * den
    return q + r / den


def _split12(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Veltkamp split of f32 ``x`` into ``hi + lo``, each <= 12 bits."""
    t = x * 4097.0
    hi = t - (t - x)
    return hi, x - hi


def faithful_div(num: jax.Array, den: jax.Array) -> jax.Array:
    """f32 division within 1 ulp of the correctly rounded quotient, for
    integer-valued ``0 <= num <= 2**12`` and any positive f32 ``den``
    (Tversky's ``alpha*(|q|-c) + beta*(|db|-c) + c``).

    A native divide that is not correctly rounded may be 2 ulp off (the
    H100's is, see ``tools/verify_exactdiv.py``). One correction step with
    an accurate residual brings it within 1 ulp:

      q           = fl(num/den)            within 2 ulp
      qh+ql, dh+dl                         Veltkamp splits at 12 bits
      r           = num - q*den            from four exact 12x12-bit
                                           products, largest first
      out         = q + r/den

    ``num - qh*dh`` is exact (Sterbenz: the product is within 2**-11 of
    ``num``); each later subtraction rounds a partial sum of size at most
    ``2**-10 * num``, so ``r`` is off by under ``2**-32 * num``, far below
    the ``2**-25 * num`` that a half-ulp of the quotient times ``den``
    allows. ``q + r/den`` is then within half an ulp before its final
    rounding, hence one of the two floats around the true quotient, and
    correctly rounded unless the quotient lies within about ``2**-20``
    ulp of a midpoint. An FMA contraction keeps every product exact and
    the split at 12 bits, so it changes none of this. Checked over every
    ``num <= 2048`` and quarter-integer ``den <= 4096`` on the CPU (tests)
    and on the H100 (``tools/verify_exactdiv.py``).
    """
    q = num / den
    qh, ql = _split12(q)
    dh, dl = _split12(den)
    r = (((num - qh * dh) - qh * dl) - ql * dh) - ql * dl
    return q + r / den


def similarity_from_counts(
    common: jax.Array,
    db_popcounts: jax.Array,
    query_popcounts: jax.Array,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> jax.Array:
    """Turn intersection counts into similarity scores (float32).

    Tanimoto (reference ``fingerprintdb_cuda.cu:96-100``):
    ``c / (|q| + |db| - c)``. Tversky: ``c / (alpha*(|q|-c) + beta*(|db|-c) + c)``.
    A zero denominator (both fingerprints empty) scores 0 rather than NaN —
    a deliberate divergence from the reference's unchecked division.

    Tanimoto scores are **bit-exact** vs the numpy oracle on every backend:
    the integer-operand division goes through :func:`exact_div`. Tversky's
    denominator is non-integer for general alpha/beta, so the exactness
    argument doesn't apply; :func:`faithful_div` keeps its quotient within
    1 ulp of the correctly rounded one (the oracle's, when alpha and beta
    are exact in f32).
    """
    c = common.astype(jnp.float32)
    qp = query_popcounts.astype(jnp.float32)[..., None]
    dp = db_popcounts.astype(jnp.float32)
    if similarity == TANIMOTO:
        denom = qp + dp - c
        # max(denom, 1) never changes a real score (denom == 0 only when
        # c == 0) and keeps the unused where-branch NaN-free
        score = jnp.where(denom > 0, exact_div(c, jnp.maximum(denom, 1.0)), 0.0)
    elif similarity == TVERSKY:
        denom = alpha * (qp - c) + beta * (dp - c) + c
        score = jnp.where(
            denom > 0, faithful_div(c, jnp.where(denom > 0, denom, 1.0)), 0.0
        )
    else:
        raise ValueError(f"unknown similarity {similarity!r}")
    # a divide that is not correctly rounded can return 0.99999994 for
    # c/c; a self-match must score exactly 1.0 (the reference
    # tests and any cutoff=1.0 query depend on it), so pin the equal case.
    # (exact_div already guarantees it for Tanimoto; kept for Tversky and
    # as a documented invariant.)
    return jnp.where((c == denom) & (denom > 0), 1.0, score)


@functools.partial(jax.jit, static_argnames=("similarity",))
def score_batch(
    db_words: jax.Array,
    db_popcounts: jax.Array,
    query_words: jax.Array,
    query_popcounts: jax.Array,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> jax.Array:
    """Score a query batch against every row: returns ``f32[..., N]``."""
    c = common_bits(db_words, query_words)
    return similarity_from_counts(
        c, db_popcounts, query_popcounts, similarity, alpha, beta
    )


def scores_np(
    db_words: np.ndarray,
    query_words: np.ndarray,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> np.ndarray:
    """Pure-numpy oracle mirroring ``TanimotoFunctorCPU`` — used in tests and
    for exact host-side re-scoring of folded-scan candidates."""
    inter = np.ascontiguousarray(db_words & query_words[..., None, :])
    c = _POPCOUNT_TABLE[inter.view(np.uint8)].sum(axis=-1)
    dp = popcount_rows_np(db_words).astype(np.float64)
    qp = popcount_rows_np(query_words.reshape(-1, query_words.shape[-1]))
    qp = qp.reshape(query_words.shape[:-1])[..., None].astype(np.float64)
    if similarity == TANIMOTO:
        denom = qp + dp - c
    elif similarity == TVERSKY:
        denom = alpha * (qp - c) + beta * (dp - c) + c
    else:
        raise ValueError(f"unknown similarity {similarity!r}")
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(denom > 0, c / denom, 0.0)
    return out.astype(np.float32)
