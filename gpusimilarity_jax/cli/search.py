"""Interactive CLI search client (debugging aid).

Equivalent of the reference's ``gpusim_search.py`` REPL, but speaking the
HTTP/JSON contract — the only process boundary in the JAX rebuild (there is
no local-socket backend process to bypass).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request


def run_query(server: str, port: int, smiles: str, dbnames: str, dbkeys: str,
              count: int, cutoff: float) -> dict:
    data = urllib.parse.urlencode(
        {
            "smiles": smiles,
            "return_count": count,
            "similarity_cutoff": cutoff,
            "dbnames": dbnames,
            "dbkeys": dbkeys,
        }
    ).encode()
    url = f"http://{server}:{port}/similarity_search_json"
    with urllib.request.urlopen(urllib.request.Request(url, data=data)) as resp:
        return json.loads(resp.read())


def main(argv=None):
    parser = argparse.ArgumentParser(description="gpusimilarity_jax search REPL")
    parser.add_argument("--server", default="localhost")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument("--dbnames", default="all")
    parser.add_argument("--dbkeys", default="")
    parser.add_argument("--return_count", default=20, type=int)
    parser.add_argument("--similarity_cutoff", default=0.0, type=float)
    args = parser.parse_args(argv)

    print("Enter SMILES (blank line or Ctrl-D to quit):", file=sys.stderr)
    for line in sys.stdin:
        smiles = line.strip()
        if not smiles:
            break
        try:
            payload = run_query(
                args.server, args.port, smiles, args.dbnames, args.dbkeys,
                args.return_count, args.similarity_cutoff,
            )
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            continue
        print(f"Approximate matches: {payload['approximate_count']}")
        for cid, smi, score in payload["results"]:
            print(f"  {score:.4f}  {cid:20s}  {smi}")
    return 0


if __name__ == "__main__":
    main()
