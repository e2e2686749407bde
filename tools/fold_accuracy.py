"""Fold-accuracy study: how exact is folded search at each fold factor?

Reproduces the reference's published accuracy experiment (RDKit UGM 2018
presentation slide 11: top-20 x 100 searches over a 17M library -> fold 2:
0% mismatches, fold 4: 0.1%, fold 8: 1.45%, using the k*fold*log2(2*fold)
over-fetch rule from ``fingerprintdb_cuda.cu:284-287``).

This engine re-scores candidates exactly, so the only possible error is a
true top-k row missing from the folded scan's over-fetched candidate set.
The study measures exactly that: for Q queries over an N-row synthetic
Morgan-like library (sparse rows, AND-of-k random slabs), compare folded
search results at folds {2, 4, 8} against the exact full-width oracle and
count mismatched result rows.

CPU-only; runs on the virtual device mesh. Prints one JSON line.

Usage: python tools/fold_accuracy.py [--rows N] [--queries Q] [--k K]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--folds", default="2,4,8")
    ap.add_argument("--data", default="clustered",
                    choices=("clustered", "random"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
    from gpusimilarity_jax.ops.scan import scores_np
    from gpusimilarity_jax.utils.fsim import FingerprintData

    rng = np.random.default_rng(17)
    n, q, k = args.rows, args.queries, args.k
    if args.data == "random":
        # Morgan-like sparsity, no structure: the ADVERSARIAL case — the
        # top-k beyond the self-match is arbitrary among thousands of
        # near-ties, so folding misses most of them; real libraries are
        # clustered and behave like the reference's numbers
        packed = np.frombuffer(rng.bytes(n * 128), np.uint8).reshape(n, 128)
        for _ in range(3):
            packed = packed & np.frombuffer(
                rng.bytes(n * 128), np.uint8
            ).reshape(n, 128)
        packed = packed.copy()
    else:
        # clustered like a real corpus: scaffold fingerprints plus small
        # per-member bit mutations, so each query has genuine neighbors
        # (scores ~0.4-0.8) the way ZINC/Enamine analog series do
        n_scaffolds = max(1, n // 200)
        scaff_bits = rng.random((n_scaffolds, 1024)) < 0.05
        member = rng.integers(0, n_scaffolds, size=n)
        bits = scaff_bits[member]
        drop = rng.random(bits.shape) < 0.10  # lose 10% of scaffold bits
        extra = rng.random(bits.shape) < (8 / 1024)  # ~8 decoration bits
        bits = (bits & ~drop) | extra
        packed = np.packbits(bits, axis=1, bitorder="little")
    data = FingerprintData(
        fingerprints=packed,
        smiles=[b"C"] * n,
        ids=[str(i).encode() for i in range(n)],
    )
    words = data.packed_words()
    q_rows = rng.choice(n, size=q, replace=False)

    # exact oracle: full-width scores, top-k by (-score, index)
    def oracle_topk(query):
        s = scores_np(words, query[None, :])[0]
        idx = np.lexsort((np.arange(n), -s))[:k]
        return set(idx.tolist()), s

    results = {}
    t0 = time.monotonic()
    # the oracle depends only on the query, not the fold: compute each
    # full-library scan once instead of once per fold factor
    oracle = {int(qi): oracle_topk(np.array(words[qi])) for qi in q_rows}
    for fold in (int(f) for f in args.folds.split(",")):
        db = FingerprintDB(data, fold_factor=fold)
        mism = 0
        worst = 0.0
        for qi in q_rows:
            query = np.array(words[qi])
            r = db.search(query, k=k, return_indices=True)
            got = set(r.indices)
            want, s = oracle[int(qi)]
            missing = want - got
            # ties at the k-th score are interchangeable, not mismatches
            if missing:
                kth = sorted((s[i] for i in want), reverse=True)[k - 1]
                missing = {i for i in missing if s[i] > kth}
            mism += len(missing)
            for i in missing:
                worst = max(worst, float(s[i]))
        results[f"fold{fold}_mismatch_pct"] = round(100 * mism / (q * k), 3)
        results[f"fold{fold}_worst_missed_score"] = round(worst, 3)
        print(f"  fold {fold}: {mism}/{q * k} mismatched rows "
              f"({100 * mism / (q * k):.2f}%)", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "fold_accuracy_study",
                "data": args.data,
                "rows": n,
                "queries": q,
                "k": k,
                "reference_slide11_pct": {"fold2": 0.0, "fold4": 0.1,
                                          "fold8": 1.45},
                **results,
                "wall_s": round(time.monotonic() - t0, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
