"""HTTP/JSON similarity-search service.

Replaces the reference's two-process sandwich (Python HTTP front end +
QLocalSocket + C++ ``gpusimserver`` backend, ``gpusim_server.py:286-311``)
with ONE process owning the JAX runtime. Wire contract is kept compatible:

* ``POST /similarity_search_json[_<db>]`` with form fields ``smiles``,
  ``return_count``, ``similarity_cutoff``, ``dbnames`` (comma-separated),
  ``dbkeys`` (comma-separated, optional) → JSON
  ``{"approximate_count": N, "results": [[id, smiles, score], ...]}``
  (shape per ``gpusim_server.py:153-168``). The optional URL suffix selects
  databases for clients that don't post ``dbnames`` (the reference FDW posts
  to ``/similarity_search_json_<db>`` with no ``dbnames`` field — a contract
  the reference server itself never honored); ``all`` means every loaded DB.
* Extensions: ``similarity`` (``tanimoto``/``tversky``), ``alpha``, ``beta``,
  ``fp_hex`` (pre-computed packed fingerprint, bypasses SMILES parsing),
  ``GET /healthz`` and ``GET /stats``.
* ``POST /similarity_search`` + ``GET /`` serve a debug HTML UI when enabled
  (the reference's ``--http_interface`` mode).

Concurrent requests are coalesced by :class:`BatchingSearcher` into batched
device scans instead of being serialized behind a global mutex.
"""

from __future__ import annotations

import html
import json
import logging
import threading
import urllib.parse
from concurrent.futures import TimeoutError as FuturesTimeoutError
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from ..models.registry import DatabaseRegistry
from ..ops.scan import TANIMOTO, TVERSKY
from ..utils.fingerprints import (
    BITCOUNT,
    FingerprintError,
    fingerprint_bin_to_words,
    compatible_generators,
    generator_tag,
    smiles_to_query_words,
)
from .batching import BatchingSearcher

# request-size guard: the largest top-k a client may ask for (the engine
# would happily compile top_k over the whole library otherwise)
MAX_RETURN_COUNT = 10_000

log = logging.getLogger("gpusimilarity_jax.http")


class RequestError(ValueError):
    """400-class client error."""


def parse_form(content_type: str, body: bytes) -> dict[str, str]:
    """Parse a POST body: urlencoded, JSON, or multipart/form-data."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct in ("application/x-www-form-urlencoded", ""):
        return {k: v[-1] for k, v in parse_qs(body.decode("utf-8", "replace")).items()}
    if ct == "application/json":
        try:
            data = json.loads(body.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise RequestError(f"bad JSON body: {e}") from e
        if not isinstance(data, dict):
            raise RequestError("JSON body must be an object")
        return {str(k): str(v) for k, v in data.items()}
    if ct == "multipart/form-data":
        msg = BytesParser(policy=HTTP_POLICY).parsebytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
        )
        out = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name:
                value = part.get_content()
                if isinstance(value, bytes):  # file/octet-stream parts
                    value = value.decode("utf-8", "replace")
                out[name] = value.strip()
        return out
    raise RequestError(f"unsupported content type {content_type!r}")


class SearchService:
    """Protocol-independent request handling shared by HTTP and tests."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        max_batch: int = 64,
        window_ms: float = 2.0,
        search_timeout_s: float = 1500.0,
    ):
        self.registry = registry
        self.searcher = BatchingSearcher(
            registry, max_batch, window_ms, result_timeout_s=search_timeout_s
        )
        self._svg_cache: dict[str, str] = {}

    def close(self):
        self.searcher.close()

    def resolve_dbnames(self, form: dict, url_db: str | None) -> list[str]:
        raw = form.get("dbnames", "") or (url_db or "")
        if not raw or raw == "all":
            names = self.registry.names()
            if not names:
                raise RequestError("no databases loaded")
            return names
        return raw.split(",")

    def handle_search(self, form: dict[str, str], url_db: str | None = None) -> dict:
        dbnames = self.resolve_dbnames(form, url_db)
        dbkeys = form.get("dbkeys", "")
        dbkeys = dbkeys.split(",") if dbkeys else [""] * len(dbnames)
        if len(dbkeys) == 1 and len(dbnames) > 1:
            # one key against a resolved multi-DB list (e.g. the FDW's
            # db_name 'all' with a dbkey option) broadcasts to every DB
            dbkeys = dbkeys * len(dbnames)
        if len(dbkeys) != len(dbnames):
            raise RequestError("need one dbkey per database")

        try:
            k = int(form.get("return_count", "20"))
            cutoff = float(form.get("similarity_cutoff", "0"))
            alpha = float(form.get("alpha", "1"))
            beta = float(form.get("beta", "1"))
        except ValueError as e:
            raise RequestError(f"bad numeric parameter: {e}") from e
        if k < 1:
            raise RequestError("return_count must be >= 1")
        if k > MAX_RETURN_COUNT:
            # a huge k would compile a full-library top_k and materialize
            # per-shard score arrays — an unauthenticated resource DoS
            raise RequestError(
                f"return_count must be <= {MAX_RETURN_COUNT}"
            )
        similarity = form.get("similarity", TANIMOTO).lower()
        if similarity not in (TANIMOTO, TVERSKY):
            raise RequestError(f"unknown similarity {similarity!r}")

        src_smiles = form.get("smiles", "").strip()
        fp_hex = form.get("fp_hex", "").strip()
        if src_smiles and not fp_hex:
            # provenance guard: a SMILES query is fingerprinted by THIS
            # process's generator; a database tagged with an incompatible
            # generator would return quietly wrong neighbors. "rdkit" and
            # "rdkit-compat" (the built-in bit-exact reimplementation) are
            # interchangeable; the round-1 "builtin" hash is not. Untagged
            # DBs (e.g. reference-built .fsim files) are not checked. Raw
            # fp_hex queries bypass the check — the caller owns the bits.
            mine = generator_tag()
            ok_tags = compatible_generators(mine)
            for name in dbnames:
                if name not in self.registry:
                    continue
                theirs = self.registry.get(name).generator
                if theirs and theirs not in ok_tags:
                    raise RequestError(
                        f"database {name!r} was built with fingerprint "
                        f"generator {theirs!r} but this server generates "
                        f"{mine!r}; results would be meaningless. Re-fetch "
                        "with fp_hex, or serve with a matching generator."
                    )
        # query width follows the QUERIED databases' full bitcount, not a
        # hardcoded 1024 — a legally-loaded 512-bit library must get
        # 512-bit queries (the Morgan generator hashes mod nBits, so
        # generating at the DB's width is RDKit-exact at any power of two)
        widths = {
            self.registry.get(n).bitcount
            for n in dbnames
            if n in self.registry
        }
        if len(widths) > 1:
            raise RequestError(
                f"queried databases have mixed fingerprint widths "
                f"{sorted(widths)}; query them separately"
            )
        bitcount = widths.pop() if widths else BITCOUNT
        if fp_hex:
            try:
                query = fingerprint_bin_to_words(bytes.fromhex(fp_hex), bitcount)
            except ValueError as e:
                raise RequestError(f"bad fp_hex: {e}") from e
            canonical = ""
        elif src_smiles:
            try:
                query, canonical = smiles_to_query_words(
                    src_smiles, bitcount=bitcount
                )
            except FingerprintError as e:
                raise RequestError(str(e)) from e
        else:
            raise RequestError("missing 'smiles' (or 'fp_hex') field")

        result = self.searcher.search(
            dbnames, dbkeys, query, k=k, cutoff=cutoff,
            similarity=similarity, alpha=alpha, beta=beta,
        )
        return {
            "approximate_count": result.approximate_count,
            "results": result.rows(),
            "query": src_smiles,
            "query_canonical": canonical,
        }

    def index_html(self) -> str:
        names = ",".join(self.registry.names())
        return _INDEX_TEMPLATE.format(dbnames=html.escape(names or "all"))

    def results_html(self, payload: dict) -> str:
        """Debug HTML with inline-SVG structure depictions per result
        (reference renders RDKit PNGs into a tempdir image cache,
        ``gpusim_server.py:171-252``; inline SVG needs no files/escaping).
        Depictions are memoized per canonical SMILES across requests."""
        rows = "\n".join(
            "<tr><td>{}</td><td>{}<br>{}</td><td>{:.4f}</td></tr>".format(
                _linkify(cid), self._depict(smi), html.escape(smi), score
            )
            for cid, smi, score in payload["results"]
        )
        query_smiles = payload.get("query_canonical") or payload.get("query", "")
        query_cell = (
            f"<p>Query: {self._depict(query_smiles)} "
            f"{html.escape(query_smiles)}</p>"
            if query_smiles
            else ""
        )
        return (
            self.index_html()
            + query_cell
            + f"<p>Approximate Total Matching Compounds: "
            f"{payload['approximate_count']}, returning "
            f"{len(payload['results'])}</p>"
            f"<table border=1><tr><th>ID</th><th>Structure / SMILES</th>"
            f"<th>Score</th></tr>"
            f"{rows}</table>"
        )

    def _depict(self, smiles: str) -> str:
        svg = self._svg_cache.get(smiles)
        if svg is None:
            from ..utils.depict import smiles_to_svg

            svg = smiles_to_svg(smiles, size=160)
            if len(self._svg_cache) > 4096:  # bound the memo like the
                self._svg_cache.clear()  # reference's tempdir cache
            self._svg_cache[smiles] = svg
        return svg


def _linkify(cid: str) -> str:
    safe = html.escape(cid)
    if cid.startswith("ZINC"):
        # quoted attribute + URL-encoded fragment: html.escape alone leaves
        # spaces unescaped, letting a hostile ID inject attributes/handlers
        frag = urllib.parse.quote(cid[4:], safe="")
        return f'<a href="http://zinc.docking.org/substance/{frag}">{safe}</a>'
    return safe


_INDEX_TEMPLATE = """<title>gpusimilarity_jax</title>
<h3>gpusimilarity_jax debug interface</h3>
<form action="/similarity_search" method="post">
  SMILES: <input type="text" name="smiles">
  Cutoff: <input type="text" name="similarity_cutoff" value="0.5">
  <input type="hidden" name="return_count" value="20">
  <input type="hidden" name="dbnames" value="{dbnames}">
  <input type="hidden" name="dbkeys" value="">
  <input type="submit" value="HTML search">
</form>
<form action="/similarity_search_json" method="post">
  SMILES: <input type="text" name="smiles">
  Cutoff: <input type="text" name="similarity_cutoff" value="0.5">
  <input type="hidden" name="return_count" value="20">
  <input type="hidden" name="dbnames" value="{dbnames}">
  <input type="hidden" name="dbkeys" value="">
  <input type="submit" value="JSON search">
</form>
"""


def make_handler(service: SearchService, debug_ui: bool):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.info("%s - %s", self.address_string(), fmt % args)

        def _send(self, code: int, content_type: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: dict):
            self._send(code, "application/json", json.dumps(payload).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok", "databases": service.registry.names()})
            elif self.path == "/stats":
                self._send_json(200, service.registry.stats())
            elif debug_ui and self.path in ("/", "/index.html"):
                self._send(200, "text/html", service.index_html().encode())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                form = parse_form(self.headers.get("Content-Type", ""), body)

                if self.path.startswith("/similarity_search_json"):
                    url_db = self.path[len("/similarity_search_json"):].lstrip("_") or None
                    payload = service.handle_search(form, url_db)
                    self._send_json(200, payload)
                elif debug_ui and self.path.startswith("/similarity_search"):
                    payload = service.handle_search(form, None)
                    self._send(200, "text/html", service.results_html(payload).encode())
                else:
                    self._send_json(404, {"error": "not found"})
            except RequestError as e:
                self._send_json(400, {"error": str(e)})
            except KeyError as e:
                self._send_json(400, {"error": str(e.args[0]) if e.args else str(e)})
            except (TimeoutError, FuturesTimeoutError):
                # two except types: concurrent.futures.TimeoutError only
                # became an alias of the builtin in Python 3.11
                self._send_json(
                    503,
                    {"error": "search timed out (first query of a new batch "
                              "shape compiles; retry shortly)"},
                )
            except Exception as e:  # pragma: no cover
                log.exception("internal error")
                self._send_json(500, {"error": f"internal error: {e}"})

    return Handler


class SimilarityServer:
    """Owns the HTTP server + batching service; context-manager friendly."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        hostname: str = "localhost",
        port: int = 8080,
        debug_ui: bool = False,
        max_batch: int = 64,
        window_ms: float = 2.0,
        socket_name: str | None = None,
        search_timeout_s: float = 1500.0,
    ):
        self.service = SearchService(
            registry, max_batch, window_ms, search_timeout_s=search_timeout_s
        )

        # http.server's default listen backlog is 5: a burst of 32
        # concurrent clients (the load test, or any fan-in proxy) overflows
        # the accept queue and the kernel RESETs the overflow connections.
        # Size the backlog to the batching window's natural fan-in instead.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server(
            (hostname, port), make_handler(self.service, debug_ui)
        )
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self.socket_server = None
        if socket_name:
            from .socket_server import SocketProtocolServer

            self.socket_server = SocketProtocolServer(
                self.service.searcher, socket_name=socket_name
            )
            self.socket_server.start_background()

    def serve_forever(self):
        log.info("serving on port %d", self.port)
        self.httpd.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.socket_server:
            self.socket_server.close()
        self.service.close()
        if self._thread:
            self._thread.join(timeout=5)
