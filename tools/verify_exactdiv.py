"""Exhaustive check of f32 division on the device: exact_div and the divides.

Every Tanimoto score is a quotient of small integers. The engine's scores
must be bit-identical to the numpy oracle, so this checks, over every
(num <= 2048, 1 <= den <= 4096) pair against numpy:

1. the backend's native f32 divide under XLA (is it correctly rounded, and
   by how many ulp is it off at worst?);
2. ``ops.scan.exact_div`` under XLA — must be 0 mismatches (XLA's GPU
   backend may contract a multiply and an add into an FMA, which the
   Veltkamp split in exact_div must survive);
3. the engine predicate ``exact_div(...) >= cutoff`` over every quotient a
   Tanimoto score can take, at the golden cutoffs;
4. on a GPU, the two divides a Triton-route Pallas kernel can use: ``/``
   and the inline-PTX ``div.rn.f32`` of ``ops/triton_bitplane.py`` (the
   bitplane kernel's Tanimoto divide — must be 0 mismatches).

Tversky scores divide with ``ops.scan.faithful_div`` on every path, the
kernel included, so a second grid — every num <= 2048 over the
quarter-integer denominators 0.25 .. 4096 that Tversky takes at alpha,
beta in {0.25, 0.5, 0.75, 1} — reports the native divide's and
faithful_div's worst ulp error there (faithful_div must stay within 1),
and checks that the kernel's faithful_div and XLA's give the same bits
(phase 1 and the rescore of one search must score alike).

Usage:  python tools/verify_exactdiv.py   (runs on the default backend;
``chip_smoke.py`` runs :func:`run` as its division phase)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def grid(max_num=2048, max_den=4096, den_step=1.0):
    num = np.arange(0, max_num + 1, dtype=np.float32)
    den = np.arange(den_step, max_den + den_step / 2, den_step, dtype=np.float32)
    c = np.repeat(num, len(den))
    d = np.tile(den, len(num))
    return c, d


def max_ulp(got, want) -> int:
    """Largest distance in ulp between two arrays of non-negative f32."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


def _correctly_rounded(c, d):
    """The f32 quotient rounded once, from the exact f64 quotient."""
    return (c.astype(np.float64) / d.astype(np.float64)).astype(np.float32)


def _pallas_divides(c, d):
    """(plain ``/``, ``div.rn.f32``, ``faithful_div``) inside a
    Triton-route Pallas kernel."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from gpusimilarity_jax.ops.scan import faithful_div
    from gpusimilarity_jax.ops.triton_bitplane import _div_rn_ptx

    block = 1024
    n = -(-len(c) // block) * block
    cp = np.zeros(n, np.float32)
    dp = np.ones(n, np.float32)
    cp[: len(c)], dp[: len(d)] = c, d

    def kernel(a_ref, b_ref, plain_ref, rn_ref, fd_ref):
        sl = pl.ds(pl.program_id(0) * block, block)
        a, b = a_ref[sl], b_ref[sl]
        plain_ref[sl] = a / b
        rn_ref[sl] = _div_rn_ptx(a, b)
        fd_ref[sl] = faithful_div(a, b)

    out = pl.pallas_call(
        kernel,
        grid=(n // block,),
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
    )(jnp.asarray(cp), jnp.asarray(dp))
    return tuple(np.asarray(x)[: len(c)] for x in out)


def run(log=print, max_num=2048, max_den=4096) -> dict:
    """Run the checks; returns the mismatch counts (``ok`` if exact)."""
    import jax
    import jax.numpy as jnp

    from gpusimilarity_jax.ops.scan import exact_div, faithful_div

    native = jax.jit(lambda a, b: a / b)
    c, d = grid(max_num, max_den)
    want = c / d  # numpy: IEEE correctly rounded
    out = {"pairs": len(c)}

    t0 = time.time()
    raw = np.asarray(native(jnp.asarray(c), jnp.asarray(d)))
    out["xla_native_divide_misrounded"] = int((raw != want).sum())
    out["xla_native_divide_max_ulp"] = max_ulp(raw, want)
    got = np.asarray(jax.jit(exact_div)(jnp.asarray(c), jnp.asarray(d)))
    bad = got != want
    out["xla_exact_div_mismatches"] = int(bad.sum())
    for j in np.nonzero(bad)[0][:5]:
        log(f"  exact_div {c[j]}/{d[j]}: got {got[j]!r} want {want[j]!r}")

    # the cutoff predicate over every (common, den) with den >= common —
    # exactly the quotient set a Tanimoto score can ever be (score <= 1)
    sel = d >= c
    cc, dd = jnp.asarray(c[sel]), jnp.asarray(d[sel])
    fails = 0
    for cut in (0.2, 0.3, 0.4, 0.5, 1.0):
        cutf = np.float32(cut)
        np_ge = (c[sel] / d[sel]) >= cutf
        dev_ge = np.asarray(
            jax.jit(lambda a, b: exact_div(a, b) >= cutf)(cc, dd)
        )
        fails += int((np_ge != dev_ge).sum())
    out["cutoff_predicate_disagreements"] = fails

    # Tversky's quarter-integer denominators
    tc, td = grid(max_num, max_den, den_step=0.25)
    t_want = _correctly_rounded(tc, td)
    t_raw = np.asarray(native(jnp.asarray(tc), jnp.asarray(td)))
    out["tversky_pairs"] = len(tc)
    out["tversky_native_divide_misrounded"] = int((t_raw != t_want).sum())
    out["tversky_native_divide_max_ulp"] = max_ulp(t_raw, t_want)
    t_fd = np.asarray(jax.jit(faithful_div)(jnp.asarray(tc), jnp.asarray(td)))
    out["xla_faithful_div_misrounded"] = int((t_fd != t_want).sum())
    out["xla_faithful_div_max_ulp"] = max_ulp(t_fd, t_want)

    disagree = 0
    if jax.default_backend() == "gpu":
        plain, rn, _ = _pallas_divides(c, d)
        out["pallas_plain_divide_misrounded"] = int((plain != want).sum())
        out["pallas_div_rn_mismatches"] = int((rn != want).sum())
        _, _, k_fd = _pallas_divides(tc, td)
        disagree = int((k_fd != t_fd).sum())
        out["pallas_vs_xla_faithful_div_disagreements"] = disagree
    out["seconds"] = round(time.time() - t0, 2)
    out["ok"] = (
        out["xla_exact_div_mismatches"] == 0
        and fails == 0
        and out["xla_faithful_div_max_ulp"] <= 1
        and out.get("pallas_div_rn_mismatches", 0) == 0
        and disagree == 0
    )
    return out


def main():
    import jax

    from gpusimilarity_jax.utils import jax_cache

    jax_cache.enable()
    print(f"backend: {jax.default_backend()}", flush=True)
    out = run()
    for key, val in out.items():
        print(f"{key}: {val}", flush=True)
    print("RESULT:", "PASS" if out["ok"] else "FAIL", flush=True)
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
