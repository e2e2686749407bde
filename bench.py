"""Benchmark: brute-force Tanimoto top-k scan rate on the local card(s).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

The headline metric is fingerprints scanned per second per chip for a
single top-128 query over a synthetic 1024-bit library resident in HBM —
directly comparable to the reference's implied rate of ~1.25e9
fingerprints/s per V100 (1e9 compounds / 0.2 s / 4 GPUs, reference
README.md:13; see BASELINE.md).

The library is generated directly on device (random packed words) so the
benchmark measures scan+top-k, not host upload. Row popcounts of random
uint32 words average 512 bits — statistically equivalent to real Morgan
fingerprints for bandwidth/compute purposes (scores are still exact
Tanimoto on the random data).
"""

import json
import os
import statistics
import time

REFERENCE_FPS_PER_GPU = 1.25e9  # BASELINE.md derived figure


def main():
    # JAXSIM_BENCH_FOLD > 1 benchmarks the reference's own baseline shape: a
    # library LARGER than device memory scanned folded with an exact
    # full-width host re-score (the 1.25e9 fp/s/GPU figure derives from 1B
    # rows on 4x16 GB V100s = 128 GB of data on 64 GB of HBM, a fold-2+
    # config; reference README.md:13 + fingerprintdb_cuda.cu:284-331).
    # Default: fold 4 over 352M rows — 45 GB of fingerprints, scanned
    # folded and rescored exactly per query.
    fold = int(os.environ.get("JAXSIM_BENCH_FOLD", 4))
    if fold > 1:
        rows_default = 352 * 1024 * 1024
    else:
        rows_default = 104 * 1024 * 1024
    rows = int(os.environ.get("JAXSIM_BENCH_ROWS", rows_default))
    if fold > 1:
        _run_fold(rows, fold)
    else:
        _run(rows)


def _setup_jax():
    import jax

    from gpusimilarity_jax.utils import jax_cache

    jax_cache.enable()
    return jax


def _emit(payload: dict) -> None:
    print(json.dumps(payload))


def _full_oracle_extras(jax, mode, fold, use_pallas, k, seed):
    """FULL-library exactness: every returned (score, index) vs the
    complete numpy/native oracle — no sampling (round-4 VERDICT item 5).

    Runs an interleaved small store (2M virtual rows — feasible on the
    1-core host) in the SAME mode/kernels as the timed passes, at B=1 and
    B=32, with non-trivial per-query cutoffs. Two classes of claim:

    * HARD (must be zero errors at any fold): every returned score equals
      the full-width oracle score of the row it names, descending order,
      and the approximate count equals the oracle count of DEVICE-score
      >= cutoff rows (folded scores at fold > 1 — the count's defined
      semantics, reference ``fingerprintdb_cuda.cu:293-299``). At fold 1
      the returned (score, index) sequence must equal the oracle's
      lowest-index-tie-broken top-k outright (two-phase selection is
      provably exact) — any divergence beyond equal-score index swaps is
      an error.
    * MEASURED (fold > 1): set-level recall vs the true top-k. The fold
      over-fetch is the reference's own near-exact heuristic (slide 11:
      1.45% mismatch at fold 8); weak-neighbor queries whose kth true
      score sits at the noise floor can miss tail rows, and this field
      reports how often instead of sampling around it.

    Disable with JAXSIM_BENCH_FULL_ORACLE=0.
    """
    import jax.numpy as jnp
    import numpy as np

    from gpusimilarity_jax.ops import fold as fold_ops
    from gpusimilarity_jax.ops.bitplane import query_plane_indices
    from gpusimilarity_jax.ops.scan import popcount_rows_np, scores_np
    from gpusimilarity_jax.parallel.mesh import make_mesh
    from gpusimilarity_jax.parallel.sharded import (
        build_bitplane_search_fn,
        build_search_fn,
    )
    from gpusimilarity_jax.utils import synth

    oseed = seed + 5
    devices = jax.devices()
    mesh = make_mesh(devices)
    n_shards = len(devices)
    n = synth.aligned_virtual_rows(2 * 1024 * 1024, n_shards)
    full = synth.virtual_matrix(n, seed=oseed)  # 256 MB host matrix
    folded_lib = np.asarray(fold_ops.fold_words(full, fold))

    if mode == "bitplane":
        store = synth.build_virtual_bitplane_store(n, fold, mesh=mesh, seed=oseed)
    else:
        store = synth.build_virtual_dense_store(
            n, fold, mesh=mesh, seed=oseed, popless=False
        )

    q_rows = synth.pick_query_rows(32, n, fold, seed=oseed, rng_seed=321)
    full_q = synth.virtual_rows_np(q_rows, seed=oseed)
    folded_q = np.asarray(fold_ops.fold_words(full_q, fold))
    folded_pops = popcount_rows_np(folded_q).astype(np.int32)
    cutoffs = np.array([(0.0, 0.2, 0.3)[i % 3] for i in range(32)], np.float32)
    overfetch = fold_ops.overfetch_count(k, fold)
    k_fetch = min(max(128, 1 << (overfetch - 1).bit_length()), n)

    score_errors = order_errors = count_mismatches = fold1_mismatches = 0
    recalls = []
    n_queries = 0
    for b in (1, 32):
        if mode == "bitplane":
            plane_idx, bucket = query_plane_indices(
                folded_q[:b], store.bitcount, bucket=64
            )
            search = build_bitplane_search_fn(
                store, k=k_fetch, similarity="tanimoto", batch=b,
                plane_bucket=bucket, use_pallas=use_pallas,
            )
            qarg = jnp.asarray(plane_idx)
        else:
            search = build_search_fn(
                store, k=k_fetch, similarity="tanimoto", batch=b,
            )
            qarg = jnp.asarray(folded_q[:b])
        vals, idx, approx = jax.device_get(
            search(
                qarg, jnp.asarray(folded_pops[:b]),
                jnp.asarray(cutoffs[:b]), jnp.float32(1.0), jnp.float32(1.0),
            )
        )
        approx = approx.astype(np.int64).sum(axis=0)
        for bq in range(b):
            n_queries += 1
            keep = (vals[bq] > float("-inf")) & (idx[bq] >= 0) & (idx[bq] < n)
            if fold > 1:
                got_s, got_i = synth.rescore_candidates_np(
                    idx[bq][keep], full_q[bq], k, n, seed=oseed
                )
            else:
                got_s, got_i = vals[bq][keep][:k], idx[bq][keep][:k]
            oracle_s = scores_np(full, full_q[bq][None, :])[0]
            order = np.lexsort((np.arange(n), -oracle_s))[:k]
            want_s = oracle_s[order].astype(np.float32)
            # HARD: each returned score IS its row's full-width score, desc
            true_of_got = oracle_s[np.asarray(got_i, np.int64)].astype(
                np.float32
            )
            score_errors += int(
                (np.asarray(got_s, np.float32) != true_of_got).sum()
            )
            if np.any(np.diff(np.asarray(got_s, np.float32)) > 0):
                order_errors += 1
            if fold == 1:
                # provably exact path: sequence equality modulo equal-score
                # index swaps (the bitplane tie-order caveat)
                for pos in range(min(len(got_i), k)):
                    if np.float32(got_s[pos]) != want_s[pos]:
                        fold1_mismatches += 1
            # MEASURED: set recall vs the true top-k
            recalls.append(
                len(np.intersect1d(np.asarray(got_i, np.int64), order))
                / max(1, len(order))
            )
            # count semantics: device-score (folded at fold>1) >= cutoff
            dev_s = scores_np(folded_lib, folded_q[bq][None, :])[0]
            want_count = int((dev_s >= cutoffs[bq]).sum())
            if int(approx[bq]) != want_count:
                count_mismatches += 1
    out = {
        "oracle": "full",
        "oracle_full_rows": int(n),
        "oracle_full_queries": f"{n_queries} (B=1 + B=32), cutoffs 0/0.2/0.3",
        "oracle_score_errors": int(score_errors),
        "oracle_order_errors": int(order_errors),
        "oracle_count_mismatches": int(count_mismatches),
        "oracle_recall_at_k": round(float(np.mean(recalls)), 5),
        "oracle_exact_topk_queries": int(sum(r == 1.0 for r in recalls)),
    }
    if fold == 1:
        out["oracle_fold1_seq_mismatches"] = int(fold1_mismatches)
    return out


def _run_fold(n_rows, fold):
    """Folded-library benchmark: bitplane scan of a beyond-HBM virtual
    library + exact full-width host rescore (the production fold path,
    ``models/fingerprint_db.py`` fold branch of ``_assemble``).

    The library is "virtual" (``utils/synth.py``): a counter-mixer makes
    device (folded, bit-transposed, generated in HBM) and host (full-width
    matrix in RAM, natively filled) materializations bit-identical, so the
    rescore runs the production ``native.rescore`` path over real host
    memory and results are verifiable against a full-width oracle.
    """
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from gpusimilarity_jax.ops import fold as fold_ops
    from gpusimilarity_jax.ops.bitplane import query_plane_indices
    from gpusimilarity_jax.ops.scan import popcount_rows_np
    from gpusimilarity_jax.parallel.mesh import make_mesh
    from gpusimilarity_jax.parallel.sharded import build_bitplane_search_fn
    from gpusimilarity_jax.utils import synth

    k = int(os.environ.get("JAXSIM_BENCH_K", 128))
    batch = int(os.environ.get("JAXSIM_BENCH_BATCH", 1))
    repeats = int(os.environ.get("JAXSIM_BENCH_REPEATS", 10))
    # the bitplane phase 1 runs as the Pallas kernel on a GPU
    use_pallas = jax.default_backend() == "gpu"
    seed = int(os.environ.get("JAXSIM_BENCH_SEED", 11))
    sample_rows = int(os.environ.get("JAXSIM_BENCH_VERIFY_ROWS", 2 * 1024 * 1024))
    throughput_batch = int(os.environ.get("JAXSIM_BENCH_ALSO_BATCH", "32"))
    if os.environ.get("JAXSIM_BENCH_MODE", "bitplane") != "bitplane":
        raise ValueError("JAXSIM_BENCH_FOLD>1 supports bitplane mode only "
                         "(dense fold configs: tools/fold_scale.py)")

    devices = jax.devices()
    mesh = make_mesh(devices)
    n_shards = len(devices)
    n_rows = synth.aligned_virtual_rows(n_rows, n_shards)

    t0 = time.monotonic()
    store = synth.build_virtual_bitplane_store(n_rows, fold, mesh=mesh, seed=seed)
    jax.block_until_ready(store.popcounts)
    gen_s = time.monotonic() - t0

    n_q = max(batch, throughput_batch if batch == 1 else batch)
    q_rows = synth.pick_query_rows(n_q, n_rows, fold, seed=seed)
    full_q = synth.virtual_rows_np(q_rows, seed=seed)
    folded_q = np.asarray(fold_ops.fold_words(full_q, fold))
    plane_idx, bucket = query_plane_indices(folded_q, store.bitcount, bucket=64)
    folded_pops = popcount_rows_np(folded_q).astype(np.int32)
    overfetch = fold_ops.overfetch_count(k, fold)
    # mirror the engine's k-fetch bucketing (fingerprint_db._k_bucket)
    k_fetch = min(max(128, 1 << (overfetch - 1).bit_length()), n_rows)

    def rescore_one(vals, idx, bq):
        keep = vals > float("-inf")
        return synth.rescore_candidates_np(
            idx[keep], full_q[bq], k, n_rows, seed=seed
        )

    def measure(b, reps):
        search = build_bitplane_search_fn(
            store, k=k_fetch, similarity="tanimoto", batch=b,
            plane_bucket=bucket, use_pallas=use_pallas,
        )
        args = (
            jnp.asarray(plane_idx[:b]),
            jnp.asarray(folded_pops[:b]),
            jnp.zeros(b, jnp.float32),
            jnp.float32(1.0),
            jnp.float32(1.0),
        )

        def run_once():
            vals, idx, _ = search(*args)
            # serving fetches the candidates to the host anyway
            vals, idx = jax.device_get((vals, idx))
            return [rescore_one(vals[bq], idx[bq], bq) for bq in range(b)]

        t0 = time.monotonic()
        results = run_once()
        compile_s = time.monotonic() - t0
        ts = []
        for _ in range(reps):
            t0 = time.monotonic()
            results = run_once()
            ts.append(time.monotonic() - t0)
        return statistics.median(ts), min(ts), compile_s, results

    p50, tmin, compile_s, results = measure(batch, repeats)
    fps_per_chip = n_rows * batch / p50 / n_shards

    # ---- exactness: self-match + full-width-oracle inclusion --------------
    # The oracle set per query = a random subsample UNION the query's whole
    # 256-row cluster (where the true top-k lives in clustered data): every
    # oracle row outranking the returned kth score must appear in the
    # returned top-k. Scores themselves are exact by construction (the
    # rescore recomputes full-width rows; verified in tests/test_synth.py).
    self_ok = sum(
        1
        for bq, (sc, ix) in enumerate(results)
        if len(ix) and ix[0] == q_rows[bq] and sc[0] == 1.0
    )
    rng = np.random.default_rng(seed + 1)
    rand_sample = np.unique(rng.integers(0, n_rows, size=sample_rows))
    checked = violations = 0
    for bq, (sc, ix) in enumerate(results):
        if len(sc) < k:
            continue
        cluster0 = int(q_rows[bq]) & ~255
        cluster = np.arange(cluster0, cluster0 + 256, dtype=np.int64)
        sample = np.union1d(rand_sample, cluster)
        s_scores, s_idx = synth.rescore_candidates_np(
            sample, full_q[bq], len(sample), n_rows, seed=seed
        )
        beat = s_idx[s_scores > sc[-1]]  # oracle rows outranking the kth
        checked += len(beat)
        violations += len(np.setdiff1d(beat, ix))

    extras = {
        "fold": fold,
        "k_fetch": k_fetch,
        "plane_bucket": bucket,
        "library_gib": round(n_rows * 128 / 2**30, 1),
        "device_gib": round(store.nbytes / 2**30, 1),
        "exact_self_match": f"{self_ok}/{batch}",
        "oracle_sample_rows": int(len(rand_sample) + 256),
        "oracle_rows_outranking_kth": int(checked),
        "oracle_inclusion_violations": int(violations),
    }
    if batch == 1 and throughput_batch > 1:
        bp50, _, _, bres = measure(throughput_batch, max(3, repeats // 2))
        extras[f"batch{throughput_batch}_fps_per_chip"] = round(
            n_rows * throughput_batch / bp50 / n_shards, 1
        )
        extras[f"batch{throughput_batch}_p50_ms"] = round(bp50 * 1e3, 3)
        extras[f"batch{throughput_batch}_self_match"] = (
            f"{sum(1 for bq, (sc, ix) in enumerate(bres) if len(ix) and ix[0] == q_rows[bq] and sc[0] == 1.0)}"
            f"/{throughput_batch}"
        )

    if os.environ.get("JAXSIM_BENCH_FULL_ORACLE", "1") == "1":
        # interleaved FULL-library exactness pass (small store, same mode).
        # Free the measured store + its compiled programs first (same
        # reasoning as _run: the oracle pass is independent, and a
        # JAXSIM_BENCH_ROWS override can leave less slack than its
        # buffers need).
        del store, measure
        jax.clear_caches()
        import gc

        gc.collect()
        extras.update(
            _full_oracle_extras(jax, "bitplane", fold, use_pallas, k, seed)
        )

    _emit(
        {
            "metric": "fingerprints_scanned_per_sec_per_chip",
            "value": round(fps_per_chip, 1),
            "unit": "fp/s/chip",
            "vs_baseline": round(fps_per_chip / REFERENCE_FPS_PER_GPU, 4),
            "p50_latency_ms": round(p50 * 1e3, 3),
            "rows": n_rows,
            "batch": batch,
            "k": k,
            "chips": n_shards,
            "mode": f"bitplane+fold{fold}" + ("+pallas" if use_pallas else ""),
            "min_latency_ms": round(tmin * 1e3, 3),
            "compile_plus_first_run_s": round(compile_s, 2),
            "library_gen_s": round(gen_s, 2),
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            **extras,
        }
    )


def _run(n_rows):
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from gpusimilarity_jax.parallel.mesh import make_mesh
    from gpusimilarity_jax.parallel.sharded import (
        build_search_fn,
        build_store_from_device,
    )

    k = int(os.environ.get("JAXSIM_BENCH_K", 128))
    batch = int(os.environ.get("JAXSIM_BENCH_BATCH", 1))
    repeats = int(os.environ.get("JAXSIM_BENCH_REPEATS", 10))
    mode = os.environ.get("JAXSIM_BENCH_MODE", "bitplane")
    if mode not in ("dense", "bitplane"):
        raise ValueError(f"JAXSIM_BENCH_MODE must be dense|bitplane, not {mode!r}")
    # the bitplane phase 1 runs as the Pallas kernel on a GPU
    use_pallas = mode == "bitplane" and jax.default_backend() == "gpu"
    qpop = int(os.environ.get("JAXSIM_BENCH_QPOP", 50))  # typical Morgan density
    w = 32  # 1024-bit fingerprints

    devices = jax.devices()
    mesh = make_mesh(devices)
    n_shards = len(devices)
    per_shard = -(-n_rows // n_shards)
    # bitplane sub-row layout needs 256-column alignment per shard (dense
    # only needs 128); unaligned per-shard widths would silently truncate
    # m8_padded below and skip tail rows
    align = 256 if mode == "bitplane" else 128
    chunk = min(1 << 20, ((per_shard + align - 1) // align) * align)
    chunk = max(align, (chunk // align) * align)
    per_shard = -(-per_shard // chunk) * chunk
    n_padded = per_shard * n_shards

    from jax.sharding import NamedSharding, PartitionSpec as P

    words_sharding = NamedSharding(mesh, P(None, "shards"))
    pops_sharding = NamedSharding(mesh, P("shards"))

    rng = np.random.default_rng(1)

    if mode == "bitplane":
        from gpusimilarity_jax.ops.bitplane import PLANE_BUCKETS
        from gpusimilarity_jax.parallel.sharded import (
            BitplaneStore,
            build_bitplane_search_fn,
        )

        bitcount = w * 32
        m8_padded = n_padded // 256  # tile-aligned sub-row layout
        planes_sharding = NamedSharding(mesh, P(None, "shards"))

        @jax.jit
        def make_planes(key):
            planes = jax.random.bits(
                key, ((bitcount + 1) * 8, m8_padded), dtype=jnp.uint32
            )
            # zero the sentinel plane's 8 sub-rows
            planes = jax.lax.dynamic_update_slice(
                planes, jnp.zeros((8, m8_padded), jnp.uint32), (bitcount * 8, 0)
            )
            planes = jax.lax.with_sharding_constraint(planes, planes_sharding)
            # popcounts: random planes are symmetric, so exact per-column pops
            # can be computed plane-by-plane; a constant ~bitcount/2 would bias
            # scores, so accumulate properly over the 1024 plane rows
            m8s_pops = jnp.zeros((8, m8_padded, 32), jnp.int32)

            def acc(pi, tot):
                rows = jax.lax.dynamic_slice(
                    planes, (8 * pi, 0), (8, m8_padded)
                )
                bits = (rows[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
                return tot + bits.astype(jnp.int32)

            by_word = jax.lax.fori_loop(0, bitcount, acc, m8s_pops)
            # a shard's flat column = 32*(r*M8s + m_local) + bit: regroup the
            # global (r, m, bit) accumulator shard-by-shard so each shard's
            # slice of the flat pops matches its plane sub-rows
            m8s_local = m8_padded // n_shards
            pops = (
                by_word.reshape(8, n_shards, m8s_local, 32)
                .transpose(1, 0, 2, 3)
                .reshape(-1)
            )
            pops = jax.lax.with_sharding_constraint(pops, pops_sharding)
            return planes, pops

        t0 = time.monotonic()
        planes, pops = jax.block_until_ready(make_planes(jax.random.key(0)))
        gen_s = time.monotonic() - t0

        # flat popcounts travel int16 like the production store
        pops16 = jax.jit(
            lambda p: jax.lax.with_sharding_constraint(
                p.astype(jnp.int16), pops_sharding
            )
        )(pops)
        del pops
        store = BitplaneStore(
            mesh=mesh, axis="shards", planes=planes, popcounts=pops16,
            n_valid=n_rows, chunk_cols=min(1 << 18, chunk), bitcount=bitcount,
        )
        bucket = next(p for p in PLANE_BUCKETS if p >= qpop)

        def build_for_batch(b):
            search = build_bitplane_search_fn(
                store, k=k, similarity="tanimoto", batch=b,
                plane_bucket=bucket, use_pallas=use_pallas,
            )
            plane_idx = np.full((b, bucket), bitcount, dtype=np.int32)
            for bq in range(b):
                plane_idx[bq, :qpop] = np.sort(
                    rng.choice(bitcount, size=qpop, replace=False)
                )
            return search, jnp.asarray(plane_idx), np.full(b, qpop, np.int32)
    else:
        @jax.jit
        def make_library(key):
            words = jax.random.bits(key, (w, n_padded), dtype=jnp.uint32)
            words = jax.lax.with_sharding_constraint(words, words_sharding)
            pops = jnp.sum(
                jax.lax.population_count(words).astype(jnp.int32), axis=0
            )
            pops = jax.lax.with_sharding_constraint(pops, pops_sharding)
            return words, pops

        t0 = time.monotonic()
        words, pops = jax.block_until_ready(make_library(jax.random.key(0)))
        gen_s = time.monotonic() - t0

        store = build_store_from_device(
            words, pops, n_valid=n_rows, mesh=mesh, chunk_cols=chunk
        )
        def build_for_batch(b):
            search = build_search_fn(
                store, k=k, similarity="tanimoto", batch=b,
            )
            from gpusimilarity_jax.ops.scan import popcount_rows_np

            queries = rng.integers(0, 2**32, (b, w), dtype=np.uint32)
            qpops = popcount_rows_np(queries).astype(np.int32)
            return search, jnp.asarray(queries), qpops

    def measure(b, reps):
        search, query_arg, qpops = build_for_batch(b)
        args = (
            query_arg,
            jnp.asarray(qpops),
            jnp.asarray(np.zeros(b, np.float32)),
            jnp.float32(1.0),
            jnp.float32(1.0),
        )
        # serving fetches the top-k to the host anyway
        t0 = time.monotonic()
        vals, _, _ = search(*args)
        jax.device_get(vals)
        compile_s = time.monotonic() - t0
        ts = []
        for _ in range(reps):
            t0 = time.monotonic()
            vals, _, _ = search(*args)
            jax.device_get(vals)
            ts.append(time.monotonic() - t0)
        return statistics.median(ts), min(ts), compile_s

    p50, tmin, compile_s = measure(batch, repeats)
    times = [tmin]  # for the extras below
    fps_per_chip = n_rows * batch / p50 / n_shards

    extras = {}
    throughput_batch = int(os.environ.get("JAXSIM_BENCH_ALSO_BATCH", "32"))
    if batch == 1 and throughput_batch > 1:
        bp50, _, _ = measure(throughput_batch, max(3, repeats // 2))
        extras[f"batch{throughput_batch}_fps_per_chip"] = round(
            n_rows * throughput_batch / bp50 / n_shards, 1
        )
        extras[f"batch{throughput_batch}_p50_ms"] = round(bp50 * 1e3, 3)
    if os.environ.get("JAXSIM_BENCH_FULL_ORACLE", "1") == "1":
        # interleaved FULL-library exactness pass (small virtual store,
        # same mode/kernels; the timed library above is random-generated
        # on the device and has no host twin to oracle against). The
        # measured library is dead weight from here on: drop it AND the
        # compiled search executables so the oracle pass fits.
        del store, build_for_batch, measure
        if mode == "bitplane":
            del planes, pops16
        else:
            del words, pops
        jax.clear_caches()
        import gc

        gc.collect()
        extras.update(
            _full_oracle_extras(jax, mode, 1, use_pallas, k, seed=11)
        )
    print(
        json.dumps(
            {
                "metric": "fingerprints_scanned_per_sec_per_chip",
                "value": round(fps_per_chip, 1),
                "unit": "fp/s/chip",
                "vs_baseline": round(fps_per_chip / REFERENCE_FPS_PER_GPU, 4),
                "p50_latency_ms": round(p50 * 1e3, 3),
                "rows": n_rows,
                "batch": batch,
                "k": k,
                "chips": n_shards,
                "mode": mode + ("+pallas" if use_pallas else ""),
                "min_latency_ms": round(min(times) * 1e3, 3),
                "compile_plus_first_run_s": round(compile_s, 2),
                "library_gen_s": round(gen_s, 2),
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                **extras,
            }
        )
    )


if __name__ == "__main__":
    main()
