"""PostgreSQL foreign-data-wrapper for gpusimilarity_jax (multicorn).

SQL integration equivalent to the reference's ``fdw/gpusim_fdw``: a foreign
table whose ``query='SMILES'`` qual triggers an HTTP similarity search and
yields ``{id, query, smiles, similarity}`` rows. Differences from the
reference FDW (both deliberate fixes):

* It parses the server's actual JSON shape
  (``{"approximate_count": ..., "results": [[id, smiles, score], ...]}``) —
  the reference FDW iterates the response dict directly and yields nothing
  (``fdw/gpusim_fdw/__init__.py:41-47`` vs the server's
  ``gpusim_server.py:153-168``).
* ``similarity_cutoff`` and ``dbkey`` are supported as table options.

Table definition example::

    CREATE SERVER jaxsim_srv FOREIGN DATA WRAPPER multicorn
      OPTIONS (wrapper 'gpusimilarity_jax.fdw.JaxSimilarityFDW');
    CREATE FOREIGN TABLE similarity_search (
      id TEXT, query TEXT, smiles TEXT, similarity FLOAT
    ) SERVER jaxsim_srv OPTIONS (
      server 'localhost', port '8080', db_name 'all', max_results '20'
    );
    SELECT * FROM similarity_search WHERE query = 'CCOC(=O)c1ccccc1';
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

try:  # pragma: no cover - multicorn only exists inside postgres
    from multicorn import ForeignDataWrapper
except ImportError:  # import-safe outside postgres (tests, docs)
    class ForeignDataWrapper:  # type: ignore[no-redef]
        def __init__(self, options, columns):
            self.options = options
            self.columns = columns


class JaxSimilarityFDW(ForeignDataWrapper):
    def __init__(self, options, columns):
        super().__init__(options, columns)
        self.columns = columns
        self.max_results = int(options.get("max_results", "20"))
        self.cutoff = float(options.get("similarity_cutoff", "0"))
        self.dbname = options.get("db_name", "all")
        self.dbkey = options.get("dbkey", "")
        # outlive the server's 1500 s worst-case live-compile window by
        # default (warmed shapes answer in milliseconds; k-bucket
        # promotion keeps warmed servers off the compile path entirely),
        # but never block the Postgres backend forever on a hung server —
        # set a smaller per-table timeout when cold compiles are
        # impossible in your deployment
        self.timeout = float(options.get("timeout", "1520"))
        server = options["server"]
        port = options["port"]
        self.endpoint = f"http://{server}:{port}/similarity_search_json_{self.dbname}"
        self._last_query: str | None = None
        self._cached_rows: list[list] = []

    def _fetch(self, smiles: str) -> list[list]:
        body = urllib.parse.urlencode(
            {
                "smiles": smiles,
                "return_count": self.max_results,
                "similarity_cutoff": self.cutoff,
                "dbkeys": self.dbkey,
            }
        ).encode()
        with urllib.request.urlopen(
            urllib.request.Request(self.endpoint, data=body),
            timeout=self.timeout,
        ) as resp:
            payload = json.loads(resp.read())
        return payload["results"]

    def execute(self, quals, columns):
        smiles = None
        for qual in quals:
            if qual.field_name == "query" and qual.operator == "=":
                smiles = qual.value
                break
        if smiles is None:
            return  # no query qual -> no rows

        if smiles != self._last_query:
            self._cached_rows = self._fetch(smiles)
            self._last_query = smiles
        for cid, row_smiles, score in self._cached_rows:
            yield {
                "id": cid,
                "query": smiles,
                "smiles": row_smiles,
                "similarity": score,
            }
