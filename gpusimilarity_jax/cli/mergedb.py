"""Merge many ``.fsim`` files into one (parallel database builds).

Equivalent of the reference's ``gpusim_mergedb.py`` but writes a *valid* v3
header: the reference merger omits the dbkey field its own reader requires
(``gpusim_mergedb.py:65-67`` vs ``gpusim.cpp:191-194``).
"""

from __future__ import annotations

import argparse
import sys

from ..utils.fsim import merge_fsim


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge gpusimilarity_jax binary FingerprintDBs"
    )
    parser.add_argument(
        "--outputfile", "-o", required=True, help="merged .fsim output path"
    )
    parser.add_argument("dbnames", nargs="+", help=".fsim files to merge")
    parser.add_argument(
        "--dbkey", default=None,
        help="override output dbkey (default: require identical input keys)",
    )
    args = parser.parse_args(argv)
    merged = merge_fsim(args.dbnames, args.outputfile, dbkey=args.dbkey)
    print(
        f"Wrote {args.outputfile}: {merged.count} entries, "
        f"dbkey={merged.dbkey!r}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
