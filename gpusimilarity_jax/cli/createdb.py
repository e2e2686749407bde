"""Build a ``.fsim`` fingerprint database from a SMILES library.

Equivalent of the reference's ``gpusim_createdb.py``: streams a ``.smi`` /
``.smi.gz`` file of ``SMILES<whitespace>ID`` lines, fingerprints each row
(canonicalizing the SMILES and dropping unparseable rows with a warning), and
writes a v3 ``.fsim``. Parallelism uses :mod:`multiprocessing` instead of the
reference's optional ipyparallel cluster.
"""

from __future__ import annotations

import argparse
import gzip
import multiprocessing
import os
import sys
import time

import numpy as np

from ..utils.fingerprints import BITCOUNT, FingerprintError, smiles_to_fingerprint_bin
from ..utils.fsim import FingerprintData, write_fsim

READ_BATCH_BYTES = 10_000_000


def _process_line(line: bytes, trust_smiles: bool = False):
    parts = line.split()
    if len(parts) < 2:
        if line.strip():
            print(f"Skipping malformed line: {line!r}", file=sys.stderr)
        return None
    cid = parts[1]
    try:
        smiles = parts[0].decode()  # inside the try: a stray non-UTF-8
        # byte must skip the row, not abort an hours-long build
        fp, canon = smiles_to_fingerprint_bin(smiles, trust_smiles=trust_smiles)
    except (FingerprintError, ValueError, UnicodeDecodeError) as e:
        print(f"Error processing {parts[0]!r}: {e}", file=sys.stderr)
        return None
    return fp, canon, cid


def _process_line_trusted(line: bytes):
    return _process_line(line, trust_smiles=True)


def iter_fingerprint_batches(
    inputfile: str,
    trust_smiles: bool = False,
    workers: int = 0,
):
    """Yield ``(fps, smiles, ids)`` byte-string lists per ~10 MB read batch.

    The shared front half of both build paths: streams the ``.smi``/
    ``.smi.gz`` input, fingerprints each row on the worker pool, drops
    unparseable rows with a warning. Memory stays O(batch) regardless of
    library size.
    """
    opener = gzip.open if str(inputfile).endswith(".gz") else open
    worker_fn = _process_line_trusted if trust_smiles else _process_line

    pool = None
    if workers != 1:
        n = workers if workers > 0 else (os.cpu_count() or 1)
        if n > 1:
            pool = multiprocessing.Pool(n)
    mapper = pool.map if pool else map

    t0 = time.monotonic()
    total = 0
    try:
        with opener(inputfile, "rb") as fh:
            lines = fh.readlines(READ_BATCH_BYTES)
            while lines:
                fps: list[bytes] = []
                smiles: list[bytes] = []
                ids: list[bytes] = []
                for row in mapper(worker_fn, lines):
                    if row is None:
                        continue
                    fp, canon, cid = row
                    fps.append(fp)
                    smiles.append(canon)
                    ids.append(cid)
                total += len(ids)
                print(f"Processed {total} rows", file=sys.stderr)
                yield fps, smiles, ids
                lines = fh.readlines(READ_BATCH_BYTES)
    finally:
        if pool:
            pool.close()
            pool.join()
    print(
        f"Fingerprinted {total} compounds in {time.monotonic() - t0:.1f}s",
        file=sys.stderr,
    )


def build_database(
    inputfile: str,
    dbkey: str = "",
    trust_smiles: bool = False,
    workers: int = 0,
) -> FingerprintData:
    fps: list[bytes] = []
    smiles: list[bytes] = []
    ids: list[bytes] = []
    for bfps, bsmiles, bids in iter_fingerprint_batches(
        inputfile, trust_smiles=trust_smiles, workers=workers
    ):
        fps.extend(bfps)
        smiles.extend(bsmiles)
        ids.extend(bids)

    if fps:
        matrix = np.frombuffer(b"".join(fps), dtype=np.uint8).reshape(
            len(fps), BITCOUNT // 8
        )
    else:
        matrix = np.zeros((0, BITCOUNT // 8), np.uint8)
    from ..utils.fingerprints import generator_tag

    return FingerprintData(
        dbkey=dbkey, bitcount=BITCOUNT, fingerprints=matrix, smiles=smiles,
        ids=ids, generator=generator_tag(),
    )


def build_database_streaming(
    inputfile: str,
    outputfile: str,
    dbkey: str = "",
    trust_smiles: bool = False,
    workers: int = 0,
    overwrite: bool = False,
) -> int:
    """Stream straight into a ``.tfsim`` directory; returns the row count.

    The ``.fsim`` path accumulates the whole library in RAM before
    writing (the reference does the same, ``gpusim_createdb.py:56-98``);
    at 1B rows that's >128 GB twice over. Streaming to the mmap-native
    format writes each row once and never holds more than one read batch.
    """
    from ..utils.fingerprints import generator_tag
    from ..utils.tfsim import TfsimStreamWriter

    with TfsimStreamWriter(
        outputfile, bitcount=BITCOUNT, dbkey=dbkey, generator=generator_tag(),
        overwrite=overwrite,
    ) as writer:
        for fps, smiles, ids in iter_fingerprint_batches(
            inputfile, trust_smiles=trust_smiles, workers=workers
        ):
            writer.append_batch(b"".join(fps), smiles, ids)
        count = writer.count
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create a gpusimilarity_jax binary FingerprintDB (.fsim v3)"
    )
    parser.add_argument("inputfile", help=".smi or .smi.gz: SMILES<ws>ID lines")
    parser.add_argument(
        "outputfile",
        help="output path: .fsim (reference interchange format) or .tfsim "
        "(native mmap format, streamed — constant memory, no convertdb "
        "second write; use for beyond-RAM builds)",
    )
    parser.add_argument("--dbkey", default="", help="database key (default empty)")
    parser.add_argument(
        "--trustSmiles", action="store_true", default=False,
        help="skip full sanitization of input SMILES",
    )
    parser.add_argument(
        "--singleThreaded", action="store_true", default=False,
        help="disable the multiprocessing pool",
    )
    parser.add_argument(
        "--workers", type=int, default=0,
        help="fingerprinting processes (0 = all cores)",
    )
    parser.add_argument(
        "--force", action="store_true", default=False,
        help="overwrite an existing output database",
    )
    args = parser.parse_args(argv)

    # refuse to clobber an existing database up front — identically for
    # both formats, and BEFORE the (potentially hours-long) fingerprinting
    # pass rather than at first write. With --force the existing database
    # is NOT deleted here: both writers build under a temp name and swap
    # at the end, so a mid-build failure leaves the old database serving.
    if os.path.exists(args.outputfile) and not args.force:
        parser.error(
            f"output {args.outputfile!r} already exists "
            "(pass --force to overwrite)"
        )

    workers = 1 if args.singleThreaded else args.workers
    if str(args.outputfile).endswith(".tfsim"):
        build_database_streaming(
            args.inputfile,
            args.outputfile,
            dbkey=args.dbkey,
            trust_smiles=args.trustSmiles,
            workers=workers,
            overwrite=args.force,
        )
    else:
        data = build_database(
            args.inputfile,
            dbkey=args.dbkey,
            trust_smiles=args.trustSmiles,
            workers=workers,
        )
        if args.force and os.path.isdir(args.outputfile):
            # a directory can't be os.replace'd by write_fsim's tmp file.
            # Write the new database to a sibling path FIRST: if the write
            # fails (disk full on a multi-GB output), the old database must
            # survive. Only once the bytes are on disk is the old directory
            # swapped aside and removed.
            import shutil

            new = f"{args.outputfile}.new.{os.getpid()}"
            write_fsim(new, data)
            old = f"{args.outputfile}.old.{os.getpid()}"
            os.rename(args.outputfile, old)
            try:
                os.replace(new, args.outputfile)
            except Exception:
                os.rename(old, args.outputfile)  # restore the previous db
                raise
            # the provenance sidecar travels with the file
            if os.path.exists(f"{new}.meta.json"):
                os.replace(f"{new}.meta.json", f"{args.outputfile}.meta.json")
            shutil.rmtree(old, ignore_errors=True)
        else:
            write_fsim(args.outputfile, data)
    print(
        f"Database generation finished with key: {args.dbkey}", file=sys.stderr
    )


if __name__ == "__main__":
    main()
