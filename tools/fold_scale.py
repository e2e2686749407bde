"""Beyond-memory scale demonstration: folded search over 384M rows on one card.

The reference's headline trick is fingerprint folding: libraries larger than
GPU memory scan folded (lossy), then candidates re-score exactly on the host
with full-width data (``fingerprintdb_cuda.cu:307-331``; presentation slides
10-13: 510M rows fold-8 on 2x1080Ti, 1.02B rows fold-4 on 4xV100). This tool
reproduces that capability on one device:

* stream-writes a synthetic ``.tfsim`` library of ``--rows`` 1024-bit rows
  (default 384M = 49 GB of packed fingerprints),
* loads it memory-mapped, folds fold-``--fold`` on the host (streaming the
  map once), uploads the folded planar store (default 12.3 GB),
* runs exact top-k searches: folded scan on device with the reference's
  k*fold*log2(2*fold) over-fetch, then full-width re-score touching only the
  candidates' mmap pages,
* checks exactness: each query IS a library row, so rank-0 must be that row
  at score 1.0, and every returned score must equal the full-width numpy
  oracle score.

Usage:  python tools/fold_scale.py [--rows N] [--fold F] [--dir PATH]
        [--queries Q] [--mode dense|bitplane]

Fold-8 note: use --and_slabs 4 (Morgan-like 6.25% density). 50%-dense
random rows OR-fold by 8 into ~all-ones (P(bit)=1-0.5^8=0.996), most
folded rows become identical, and the folded scan can no longer rank
candidates — the exactness check fails by construction, not by bug.
Real fingerprints fold-8 to ~40% density and rank fine (the reference's
published fold-8 accuracy was measured on real data).

Mode note: use dense mode for folded searches. Folding densifies queries
(even Morgan-sparse rows at fold 4 select ~60 of 256 planes), so the
bit-sliced mode loses its advantage; bitplane's win is UNfolded sparse
queries. The server's auto scan mode picks dense whenever the effective
fold factor is above 1.
Writes ~66 GB under --dir (default /tmp/jaxsim_fold_scale); reuses it if
present. Prints one JSON summary line.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GiB = 1 << 30


def generate_tfsim(
    path: Path, rows: int, bitcount: int = 1024, and_slabs: int = 1
) -> None:
    """Stream-write a synthetic .tfsim directory without materializing it.

    ``and_slabs``: AND together k independent random slabs, giving bit
    density 0.5^k — k=4 (6.25%, ~64/1024 bits) approximates real Morgan
    fingerprints' sparsity, which is what the bitplane scan mode exploits.
    """
    width = bitcount // 8
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=False)
    rng = np.random.default_rng(7)
    t0 = time.monotonic()

    # fingerprints.npy: uint8 (rows, width), streamed in ~512 MB slabs
    fp_mm = np.lib.format.open_memmap(
        tmp / "fingerprints.npy", mode="w+", dtype=np.uint8,
        shape=(rows, width),
    )
    slab = (512 * 1024 * 1024) // width
    for lo in range(0, rows, slab):
        hi = min(lo + slab, rows)
        buf = np.frombuffer(
            bytearray(rng.bytes((hi - lo) * width)), dtype=np.uint8
        )
        for _ in range(and_slabs - 1):
            buf &= np.frombuffer(rng.bytes((hi - lo) * width), dtype=np.uint8)
        fp_mm[lo:hi] = buf.reshape(hi - lo, width)
        print(f"  fingerprints {hi/rows:5.1%}", end="\r", flush=True)
    fp_mm.flush()
    del fp_mm
    print()

    # ids: "SYN" + 10 digits (supports >1e9 rows) as fixed-width STRIDED
    # records — no offsets index (16 B/row, 12 GiB at 768M rows, would
    # blow the disk budget of the beyond-memory runs). Smiles HARDLINK to the
    # same blob: distinct per row (a constant smiles makes the service
    # layer's duplicate-SMILES dedup collapse every result into one joined
    # row) at zero extra disk; synthetic rows have no real structures, so
    # the id string doubles as an opaque smiles placeholder.
    if rows > 10**10:
        raise ValueError("id generator supports at most 1e10 rows")
    id_len = 13
    n_digits = 10
    with open(tmp / "ids.blob", "wb") as f:
        chunk = 8 * 1024 * 1024
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            idx = np.arange(lo, hi, dtype=np.int64)
            out = np.empty((hi - lo, id_len), np.uint8)
            out[:, 0], out[:, 1], out[:, 2] = 0x53, 0x59, 0x4E  # "SYN"
            for d in range(n_digits):
                out[:, id_len - 1 - d] = (idx // 10**d) % 10 + 0x30
            f.write(out.tobytes())
    os.link(tmp / "ids.blob", tmp / "smiles.blob")

    (tmp / "meta.json").write_text(
        json.dumps(
            {
                "format_version": 1,
                "dbkey": "scale",
                "bitcount": bitcount,
                "count": rows,
                "generator": "synthetic-random",
                "strings": {
                    "ids": {"kind": "strided", "itemsize": id_len},
                    "smiles": {"kind": "strided", "itemsize": id_len},
                },
            }
        )
    )
    tmp.rename(path)
    print(f"  generated {rows:,} rows in {time.monotonic() - t0:.1f}s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=384 * 1024 * 1024)
    ap.add_argument("--fold", type=int, default=4)
    ap.add_argument("--dir", default="/tmp/jaxsim_fold_scale")
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--mode", default="dense", choices=("dense", "bitplane"))
    ap.add_argument(
        "--and_slabs", type=int, default=1,
        help="AND k random slabs: bit density 0.5^k (4 = Morgan-like 6.25%%)",
    )
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--generate_only", action="store_true",
                    help="write the synthetic library and exit (lets the "
                    "multi-minute generation run detached from the search)")
    args = ap.parse_args()

    density = "" if args.and_slabs == 1 else f"_d{args.and_slabs}"
    lib_dir = Path(args.dir) / f"rows{args.rows}{density}.tfsim"
    if not lib_dir.exists():
        print(f"generating synthetic library at {lib_dir} ...")
        generate_tfsim(lib_dir, args.rows, and_slabs=args.and_slabs)
    if args.generate_only:  # before JAX touches a device
        print(f"library ready at {lib_dir}")
        return

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from gpusimilarity_jax.utils import jax_cache

    jax_cache.enable()

    from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
    from gpusimilarity_jax.ops.scan import scores_np
    from gpusimilarity_jax.utils.tfsim import load_native

    t0 = time.monotonic()
    data = load_native(lib_dir)
    load_s = time.monotonic() - t0
    print(f"mapped {data.count:,} rows ({data.fingerprints.nbytes / GiB:.1f} "
          f"GiB) in {load_s:.2f}s")

    t0 = time.monotonic()
    db = FingerprintDB(data, fold_factor=args.fold, scan_mode=args.mode)
    build_s = time.monotonic() - t0
    device_gib = args.rows * (128 / args.fold) / GiB
    print(f"folded x{db.fold_factor} + uploaded ~{device_gib:.1f} GiB in "
          f"{build_s:.1f}s")

    rng = np.random.default_rng(123)
    q_rows = rng.choice(args.rows, size=args.queries, replace=False)
    full = data.packed_words()

    t0 = time.monotonic()
    r = db.search(np.array(full[q_rows[0]]), k=args.k, dbkey="scale")
    compile_s = time.monotonic() - t0
    lat = []
    exact_ok = 0
    for qi in q_rows:
        query = np.array(full[qi])
        t0 = time.monotonic()
        r = db.search(query, k=args.k, dbkey="scale", return_indices=True)
        lat.append(time.monotonic() - t0)
        # exactness: rank 0 is the query row at 1.0, and every candidate
        # score equals the full-width oracle
        oracle = scores_np(
            np.array(full[np.asarray(r.indices)]), query[None, :]
        )[0]
        if (
            r.indices[0] == qi
            and r.scores[0] == 1.0
            and np.allclose(r.scores, oracle, atol=1e-6)
        ):
            exact_ok += 1
    p50 = statistics.median(lat)
    print(
        json.dumps(
            {
                "metric": "folded_search_p50_ms",
                "value": round(p50 * 1e3, 2),
                "unit": "ms",
                "rows": args.rows,
                "fold": db.fold_factor,
                "mode": args.mode,
                "k": args.k,
                "library_gib": round(args.rows * 128 / GiB, 1),
                "device_gib": round(device_gib, 1),
                "exact_self_match": f"{exact_ok}/{args.queries}",
                "fps_per_chip": round(args.rows / p50, 1),
                "load_s": round(load_s, 2),
                "fold_upload_s": round(build_s, 1),
                "compile_plus_first_s": round(compile_s, 1),
            }
        )
    )
    assert exact_ok == args.queries, "exactness check failed"


if __name__ == "__main__":
    main()
