"""Exhaustive verification of ops.scan.exact_div — the correctly-rounded
f32 division that makes every Tanimoto score bit-identical to the numpy /
reference-CPU oracle (``calculation_functors.cpp:6-20`` divides with IEEE
hardware; a reciprocal-multiply divide misrounds many small-integer
quotients by 1 ulp).

Three layers:

* the correction algorithm, re-implemented step-for-step in numpy f32
  (every numpy op IS correctly rounded), recovers the correctly-rounded
  quotient from ANY faithful starting quotient — tested by perturbing the
  true quotient +-1 ulp over the full operand grid. This is the proof that
  a misrounded divide is repaired, runnable without one.
* the JAX ``exact_div`` over the full grid equals numpy division on the CPU
  backend (plumbing: XLA must not reassociate the split).
* the engine-level consequence: ``similarity_from_counts`` counts at the
  golden boundary fractions (11/55 vs 0.2f, 15/50 vs 0.3f — the exact
  pairs that flipped on hardware) match numpy.

The same grid runs on the GPU in ``chip_smoke.py``'s division phase (and
``tools/verify_exactdiv.py``), with a second one of quarter-integer
denominators for ``faithful_div``, Tversky's divide, which is checked here
too: within 1 ulp of the correctly rounded quotient from any start a
native divide that is up to 2 ulp off can give.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpusimilarity_jax.ops.scan import (
    exact_div,
    faithful_div,
    similarity_from_counts,
)

F1 = np.float32(1.0)
SPLIT = np.float32(4097.0)


def _grid(max_num=2048, max_den=4096, den_step=1):
    num = np.arange(0, max_num + 1, dtype=np.float32)
    den = np.arange(den_step, max_den + den_step / 2, den_step, dtype=np.float32)
    c = np.repeat(num, len(den))
    d = np.tile(den, len(num))
    return c, d


def _correct_np(q, c, d):
    """The exact_div correction in pure numpy f32 (all ops IEEE-correct)."""
    t = q * SPLIT
    qh = t - (t - q)
    ql = q - qh
    r = (c - qh * d) - ql * d
    return q + r / d


def test_correction_recovers_from_any_faithful_quotient():
    """For every operand pair, starting from the correctly-rounded quotient
    OR either 1-ulp neighbor (superset of every faithful hardware divide),
    the correction lands on the correctly-rounded quotient."""
    c, d = _grid()
    q_true = c / d  # numpy: correctly rounded
    for direction in (None, np.float32(np.inf), np.float32(-np.inf)):
        q0 = q_true if direction is None else np.nextafter(q_true, direction)
        got = _correct_np(q0.astype(np.float32), c, d)
        bad = got != q_true
        assert not bad.any(), (
            f"{int(bad.sum())} wrong quotients from {direction}-perturbed "
            f"start, e.g. {c[bad][:3]}/{d[bad][:3]}"
        )


def _faithful_np(q, c, d):
    """faithful_div's correction in pure numpy f32 (all ops IEEE-correct)."""
    def split(x):
        t = x * SPLIT
        hi = t - (t - x)
        return hi, x - hi

    qh, ql = split(q)
    dh, dl = split(d)
    r = (((c - qh * dh) - qh * dl) - ql * dh) - ql * dl
    return q + r / d


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _rounded(c, d):
    return (c.astype(np.float64) / d.astype(np.float64)).astype(np.float32)


def _random_denominators(n=1 << 20):
    """Integer numerators over denominators with all 24 bits in use."""
    rng = np.random.default_rng(5)
    c = rng.integers(1, 2049, n).astype(np.float32)
    d = (c * rng.uniform(1.0, 3.0, n)).astype(np.float32)
    return c, d


@pytest.mark.parametrize("dens", ["quarter-integers", "random"])
def test_faithful_div_within_one_ulp_from_any_2ulp_start(dens):
    """From the correctly rounded quotient or any start up to 2 ulp away
    (a native divide's worst case), the correction lands within 1 ulp of
    the correctly rounded quotient."""
    if dens == "random":
        c, d = _random_denominators()
    else:
        c, d = _grid(max_num=512, max_den=1024, den_step=0.25)
        c, d = c[c > 0], d[c > 0]
    want = _rounded(c, d)
    for steps in (-2, -1, 0, 1, 2):
        q0 = (want.view(np.int32) + steps).view(np.float32)
        got = _faithful_np(q0, c, d)
        assert _ulp(got, want).max() <= 1, steps


def test_faithful_div_jax_matches_numpy():
    c, d = _grid(max_num=512, max_den=1024, den_step=0.25)
    got = np.asarray(jax.jit(faithful_div)(jnp.asarray(c), jnp.asarray(d)))
    np.testing.assert_array_equal(got, _faithful_np(c / d, c, d))
    assert _ulp(got, _rounded(c, d)).max() <= 1


def test_exact_div_matches_numpy_full_grid():
    c, d = _grid()
    fn = jax.jit(exact_div)
    got = np.asarray(fn(jnp.asarray(c), jnp.asarray(d)))
    want = c / d
    bad = got != want
    assert not bad.any(), (
        f"{int(bad.sum())} mismatches, e.g. {c[bad][:3]}/{d[bad][:3]}: "
        f"{got[bad][:3]} != {want[bad][:3]}"
    )


def test_exact_div_edge_values():
    # 0/d, self-match c/c, and the measured hardware-flip pairs
    c = np.array([0, 7, 11, 15, 1024, 2048, 1, 2047], np.float32)
    d = np.array([3, 7, 55, 50, 1024, 2048, 4096, 2048], np.float32)
    got = np.asarray(exact_div(jnp.asarray(c), jnp.asarray(d)))
    np.testing.assert_array_equal(got, c / d)
    assert got[1] == 1.0 and got[4] == 1.0 and got[5] == 1.0


@pytest.mark.parametrize(
    "common,dpop,qpop,cutoff",
    [
        (11, 94, 10, 0.2),   # den 94+10-11=93? adjust below
        (15, 50, 15, 0.3),
        (11, 56, 10, 0.2),   # den = 55: fl(11/55) == 0.2f boundary
        (15, 35, 30, 0.3),   # den = 50: fl(15/50) == 0.3f boundary
    ],
)
def test_boundary_counts_match_numpy(common, dpop, qpop, cutoff):
    """(num, den) pairs on a cutoff boundary, where a misrounded divide
    flips `>= cutoff`: the engine's score must land on the same side as
    numpy's."""
    s_dev = np.asarray(
        similarity_from_counts(
            jnp.asarray([[common]], jnp.int32),
            jnp.asarray([dpop], jnp.int32),
            jnp.asarray([qpop], jnp.int32),
        )
    )[0, 0]
    den = np.float32(qpop) + np.float32(dpop) - np.float32(common)
    s_np = np.float32(common) / den
    assert s_dev == s_np
    assert (s_dev >= np.float32(cutoff)) == (s_np >= np.float32(cutoff))


def test_verify_tool_reports_on_cpu():
    """tools/verify_exactdiv.py on a small grid: the CPU divide is IEEE."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import verify_exactdiv

    out = verify_exactdiv.run(log=lambda *a: None, max_num=64, max_den=128)
    assert out["ok"]
    assert out["pairs"] == 65 * 128 and out["tversky_pairs"] == 65 * 512
    assert out["xla_native_divide_max_ulp"] == 0
    assert out["xla_faithful_div_max_ulp"] == 0
