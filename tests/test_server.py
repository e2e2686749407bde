"""Integration tests: HTTP service, batching, CLIs, and the FDW."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from gpusimilarity_jax.models import DatabaseRegistry
from gpusimilarity_jax.serve.batching import BatchingSearcher
from gpusimilarity_jax.serve.server import SimilarityServer, parse_form, RequestError
from gpusimilarity_jax.utils.fingerprints import smiles_to_fingerprint_bin
from gpusimilarity_jax.utils.fsim import FingerprintData, write_fsim

CORPUS = [
    "CCO", "CCCO", "CCCCO", "c1ccccc1", "c1ccncc1", "Cc1ccccc1",
    "CC(=O)O", "CC(=O)N", "CCN(CC)CC", "OCC(O)CO", "Clc1ccccc1",
    "Brc1ccccc1", "CC(C)CC", "C1CCCCC1", "C1CCNCC1", "N#Cc1ccccc1",
]


def corpus_data(dbkey=""):
    fps, smiles = [], []
    for s in CORPUS:
        fp, canon = smiles_to_fingerprint_bin(s)
        fps.append(np.frombuffer(fp, np.uint8))
        smiles.append(canon)
    return FingerprintData(
        dbkey=dbkey,
        fingerprints=np.stack(fps),
        smiles=smiles,
        ids=[f"CMPD{i:04d}".encode() for i in range(len(CORPUS))],
    )


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("srv")
    write_fsim(tmp / "corpus.fsim", corpus_data())
    write_fsim(tmp / "keyed.fsim", corpus_data(dbkey="sekrit"))
    registry = DatabaseRegistry.from_fsim_files(
        [str(tmp / "corpus.fsim"), str(tmp / "keyed.fsim")]
    )
    srv = SimilarityServer(registry, port=0, debug_ui=True, window_ms=1.0)
    srv.start_background()
    yield srv
    srv.close()


def post(server, path, fields, expect_error=False):
    body = urllib.parse.urlencode(fields).encode()
    url = f"http://localhost:{server.port}{path}"
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body)) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            payload = json.loads(payload)
        except Exception:
            pass
        if not expect_error:
            raise AssertionError(f"unexpected {e.status}: {payload}")
        return e.status, payload


class TestHTTP:
    def test_basic_json_search(self, server):
        status, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": 5, "similarity_cutoff": 0,
             "dbnames": "corpus"},
        )
        assert status == 200
        assert payload["approximate_count"] == len(CORPUS)
        assert len(payload["results"]) == 5
        cid, smi, score = payload["results"][0]
        assert cid == "CMPD0000" and score == 1.0
        assert payload["query_canonical"]

    def test_wire_shape_matches_reference(self, server):
        _, payload = post(
            server, "/similarity_search_json",
            {"smiles": "c1ccccc1", "return_count": 3, "similarity_cutoff": 0,
             "dbnames": "corpus", "dbkeys": ""},
        )
        assert set(payload) >= {"approximate_count", "results"}
        for row in payload["results"]:
            assert isinstance(row, list) and len(row) == 3
            assert isinstance(row[0], str) and isinstance(row[1], str)
            assert isinstance(row[2], float)

    def test_url_suffix_database_selection(self, server):
        # FDW-style: database in URL, no dbnames field
        status, payload = post(
            server, "/similarity_search_json_corpus",
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0},
        )
        assert status == 200 and len(payload["results"]) == 3

    def test_all_databases(self, server):
        status, payload = post(
            server, "/similarity_search_json_all",
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0,
             "dbkeys": ",sekrit"},
        )
        assert status == 200
        # same compound in both DBs -> ids joined with ;:;
        assert ";:;" in payload["results"][0][0]
        assert payload["approximate_count"] == 2 * len(CORPUS)

    def test_dbkey_gating_over_http(self, server):
        _, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0,
             "dbnames": "keyed", "dbkeys": "wrong"},
        )
        assert payload["results"] == [] and payload["approximate_count"] == 0

    def test_cutoff_filters(self, server):
        _, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": 10, "similarity_cutoff": 0.99,
             "dbnames": "corpus"},
        )
        assert len(payload["results"]) == 1  # only the exact match

    def test_tversky_extension(self, server):
        status, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0,
             "dbnames": "corpus", "similarity": "tversky",
             "alpha": 0.3, "beta": 0.7},
        )
        assert status == 200 and payload["results"][0][2] == 1.0

    def test_fp_hex_query(self, server):
        fp, _ = smiles_to_fingerprint_bin("CCO")
        status, payload = post(
            server, "/similarity_search_json",
            {"fp_hex": fp.hex(), "return_count": 2, "similarity_cutoff": 0,
             "dbnames": "corpus"},
        )
        assert status == 200 and payload["results"][0][0] == "CMPD0000"

    def test_bad_smiles_is_400(self, server):
        status, payload = post(
            server, "/similarity_search_json",
            {"smiles": "((((", "return_count": 5, "similarity_cutoff": 0,
             "dbnames": "corpus"},
            expect_error=True,
        )
        assert status == 400 and "error" in payload

    def test_unknown_database_is_400(self, server):
        status, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": 5, "similarity_cutoff": 0,
             "dbnames": "nope"},
            expect_error=True,
        )
        assert status == 400

    def test_missing_smiles_is_400(self, server):
        status, _ = post(
            server, "/similarity_search_json",
            {"return_count": 5, "similarity_cutoff": 0, "dbnames": "corpus"},
            expect_error=True,
        )
        assert status == 400

    def test_json_body(self, server):
        body = json.dumps(
            {"smiles": "CCO", "return_count": 2, "similarity_cutoff": 0,
             "dbnames": "corpus"}
        ).encode()
        req = urllib.request.Request(
            f"http://localhost:{server.port}/similarity_search_json",
            data=body, headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        assert payload["results"][0][0] == "CMPD0000"

    def test_healthz_and_stats(self, server):
        with urllib.request.urlopen(
            f"http://localhost:{server.port}/healthz"
        ) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and "corpus" in health["databases"]
        with urllib.request.urlopen(f"http://localhost:{server.port}/stats") as r:
            stats = json.loads(r.read())
        assert stats["databases"]["corpus"]["count"] == len(CORPUS)
        assert stats["searches"] > 0

    def test_debug_html_ui(self, server):
        with urllib.request.urlopen(f"http://localhost:{server.port}/") as r:
            page = r.read().decode()
        assert "similarity_search_json" in page
        body = urllib.parse.urlencode(
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0,
             "dbnames": "corpus"}
        ).encode()
        req = urllib.request.Request(
            f"http://localhost:{server.port}/similarity_search", data=body
        )
        with urllib.request.urlopen(req) as r:
            page = r.read().decode()
        assert "CMPD0000" in page and "Approximate" in page

    def test_concurrent_requests_batch(self, server):
        """Concurrent searches all succeed (and coalesce into batches)."""
        errors, results = [], []

        def go(smiles):
            try:
                _, payload = post(
                    server, "/similarity_search_json",
                    {"smiles": smiles, "return_count": 3,
                     "similarity_cutoff": 0, "dbnames": "corpus"},
                )
                results.append(payload)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [
            threading.Thread(target=go, args=(s,))
            for s in CORPUS[:8]
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert len(results) == 8
        for payload, smiles in zip(results, CORPUS[:8]):
            assert payload["results"][0][2] == 1.0


class TestParseForm:
    def test_urlencoded(self):
        out = parse_form(
            "application/x-www-form-urlencoded", b"a=1&b=hello%20world"
        )
        assert out == {"a": "1", "b": "hello world"}

    def test_json(self):
        out = parse_form("application/json", b'{"a": 1, "b": "x"}')
        assert out == {"a": "1", "b": "x"}

    def test_multipart(self):
        boundary = "XX"
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"smiles\""
            f"\r\n\r\nCCO\r\n--{boundary}--\r\n"
        ).encode()
        out = parse_form(f"multipart/form-data; boundary={boundary}", body)
        assert out["smiles"] == "CCO"

    def test_bad_json(self):
        with pytest.raises(RequestError):
            parse_form("application/json", b"{oops")

    def test_unsupported(self):
        with pytest.raises(RequestError):
            parse_form("application/octet-stream", b"xx")


class TestBatching:
    def test_heterogeneous_params_batch_correctly(self, rng):
        from conftest import random_fingerprint_data

        reg = DatabaseRegistry()
        data = random_fingerprint_data(rng, count=128)
        reg.add("d", data)
        searcher = BatchingSearcher(reg, max_batch=16, window_ms=20.0)
        words = data.packed_words()
        try:
            futures = []
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(8) as pool:
                for i in range(8):
                    futures.append(
                        pool.submit(
                            searcher.search, ["d"], [""], words[i],
                            k=5 + i, cutoff=0.05 * i,
                        )
                    )
                results = [f.result(timeout=60) for f in futures]
            for i, r in enumerate(results):
                assert r.scores[0] == 1.0
                assert len(r) <= 5 + i
                assert all(s >= 0.05 * i for s in r.scores)
        finally:
            searcher.close()

    def test_slow_group_does_not_stall_others(self):
        """One group stuck in a long compile (simulated by a sleeping
        registry call) must not block other groups in the same or later
        drain cycles (round-1 review: the worker ran groups serially)."""
        import threading
        import time as _time

        class FakeRegistry:
            def search_databases_batch(self, dbnames, dbkeys, queries, ks,
                                       cutoffs, **kw):
                if dbnames[0] == "slow":
                    _time.sleep(3.0)
                return [SearchResult() for _ in range(len(queries))]

        from gpusimilarity_jax.models.results import SearchResult

        searcher = BatchingSearcher(FakeRegistry(), window_ms=1.0)
        try:
            q = np.zeros(32, np.uint32)
            slow_done = threading.Event()
            t = threading.Thread(
                target=lambda: (searcher.search(["slow"], [""], q),
                                slow_done.set()),
                daemon=True,
            )
            t.start()
            _time.sleep(0.1)  # let the slow group start
            t0 = _time.monotonic()
            searcher.search(["fast"], [""], q, timeout=10)
            fast_elapsed = _time.monotonic() - t0
            assert fast_elapsed < 1.5, fast_elapsed  # not behind the 3s sleep
            assert not slow_done.is_set()
            t.join(timeout=10)
            assert slow_done.is_set()
        finally:
            searcher.close()

    def test_error_propagates_to_caller(self, rng):
        reg = DatabaseRegistry()
        searcher = BatchingSearcher(reg, window_ms=1.0)
        try:
            with pytest.raises(KeyError):
                searcher.search(["missing"], [""], np.zeros(32, np.uint32))
        finally:
            searcher.close()


class TestFDW:
    def test_fdw_execute(self, server):
        from gpusimilarity_jax.fdw import JaxSimilarityFDW

        class Qual:
            field_name = "query"
            operator = "="
            value = "CCO"

        fdw = JaxSimilarityFDW(
            {"server": "localhost", "port": str(server.port),
             "db_name": "corpus", "max_results": "4"},
            ["id", "query", "smiles", "similarity"],
        )
        rows = list(fdw.execute([Qual()], None))
        assert len(rows) == 4
        assert rows[0]["id"] == "CMPD0000"
        assert rows[0]["similarity"] == 1.0
        assert rows[0]["query"] == "CCO"
        # cached second execution
        rows2 = list(fdw.execute([Qual()], None))
        assert rows2 == rows

    def test_fdw_no_qual_yields_nothing(self):
        from gpusimilarity_jax.fdw import JaxSimilarityFDW

        fdw = JaxSimilarityFDW(
            {"server": "localhost", "port": "1", "max_results": "4"}, []
        )
        assert list(fdw.execute([], None)) == []


class TestCLIs:
    def test_createdb_mergedb_roundtrip(self, tmp_path):
        import gzip

        from gpusimilarity_jax.cli import createdb, mergedb
        from gpusimilarity_jax.utils.fsim import read_fsim

        smi = tmp_path / "in.smi.gz"
        with gzip.open(smi, "wb") as f:
            for i, s in enumerate(CORPUS[:6]):
                f.write(f"{s} ID{i}\n".encode())
            f.write(b"not_a_smiles_(((( BAD1\n")  # dropped with a warning

        out = tmp_path / "out.fsim"
        createdb.main([str(smi), str(out), "--dbkey", "k1", "--singleThreaded"])
        data = read_fsim(out)
        assert data.count == 6
        assert data.dbkey == "k1"
        assert data.ids == [f"ID{i}".encode() for i in range(6)]

        merged = tmp_path / "merged.fsim"
        mergedb.main(["-o", str(merged), str(out), str(out)])
        m = read_fsim(merged)
        assert m.count == 12 and m.dbkey == "k1"

    def test_search_repl_client(self, server, monkeypatch, capsys):
        import io

        from gpusimilarity_jax.cli import search as search_cli

        monkeypatch.setattr("sys.stdin", io.StringIO("CCO\n\n"))
        search_cli.main(
            ["--port", str(server.port), "--dbnames", "corpus",
             "--return_count", "3"]
        )
        out = capsys.readouterr().out
        assert "CMPD0000" in out and "1.0000" in out


class TestProvenanceGuard:
    """A SMILES query against a DB built by a different fingerprint
    generator must 400, not return quietly wrong neighbors."""

    @pytest.fixture(scope="class")
    def reg(self):
        from gpusimilarity_jax.utils.fingerprints import generator_tag

        other = "rdkit" if generator_tag().startswith("builtin") else "builtin"
        foreign = corpus_data()
        foreign.generator = f"{other}-morgan-r2-1024"
        local = corpus_data()
        local.generator = generator_tag()
        untagged = corpus_data()
        registry = DatabaseRegistry()
        registry.add("foreign", foreign)
        registry.add("local", local)
        registry.add("untagged", untagged)
        return registry

    def test_mismatch_rejected_matching_and_untagged_pass(self, reg):
        from gpusimilarity_jax.serve.server import SearchService

        svc = SearchService(reg, window_ms=1.0)
        try:
            with pytest.raises(RequestError, match="generator"):
                svc.handle_search({"smiles": "CCO", "dbnames": "foreign"})
            for name in ("local", "untagged"):
                out = svc.handle_search({"smiles": "CCO", "dbnames": name})
                assert out["results"]
            # raw fingerprints bypass the guard: the caller owns the bits
            fp, _ = smiles_to_fingerprint_bin("CCO")
            out = svc.handle_search(
                {"fp_hex": fp.hex(), "dbnames": "foreign"}
            )
            assert out["results"]
        finally:
            svc.close()

    def test_generator_survives_fsim_and_tfsim_roundtrip(self, tmp_path):
        from gpusimilarity_jax.utils.fsim import read_fsim
        from gpusimilarity_jax.utils.tfsim import load_native, save_native

        data = corpus_data()
        data.generator = "rdkit-morgan-r2-1024"
        write_fsim(tmp_path / "g.fsim", data)
        assert (tmp_path / "g.fsim.meta.json").exists()
        assert read_fsim(tmp_path / "g.fsim").generator == data.generator
        save_native(tmp_path / "g.tfsim", data)
        assert load_native(tmp_path / "g.tfsim").generator == data.generator
        # untagged data writes no sidecar and reads back as unknown
        write_fsim(tmp_path / "u.fsim", corpus_data())
        assert not (tmp_path / "u.fsim.meta.json").exists()
        assert read_fsim(tmp_path / "u.fsim").generator == ""

    def test_merge_refuses_mixed_generators(self, tmp_path):
        from gpusimilarity_jax.utils.fsim import merge_fsim

        a, b = corpus_data(), corpus_data()
        a.generator = "rdkit-morgan-r2-1024"
        b.generator = "builtin-morgan-r2-1024"
        write_fsim(tmp_path / "a.fsim", a)
        write_fsim(tmp_path / "b.fsim", b)
        with pytest.raises(ValueError, match="generator"):
            merge_fsim(
                [tmp_path / "a.fsim", tmp_path / "b.fsim"],
                tmp_path / "m.fsim",
            )
        a2 = corpus_data()
        a2.generator = "rdkit-morgan-r2-1024"
        write_fsim(tmp_path / "a2.fsim", a2)
        merged = merge_fsim(
            [tmp_path / "a.fsim", tmp_path / "a2.fsim"], tmp_path / "m.fsim"
        )
        assert merged.generator == "rdkit-morgan-r2-1024"


class TestRound2ReviewFixes:
    """Regressions for the round-2 serving/parallel review findings."""

    def test_auto_scan_mode_resolves_on_effective_fold(self):
        # resolve_scan_mode takes the EFFECTIVE fold (after the registry's
        # memory-based auto-fold), not the raw --fold flag: a library
        # beyond device memory with default flags must not serve
        # folded-bitplane
        from gpusimilarity_jax.models.registry import resolve_scan_mode

        # unfolded GPU default is bitplane (whose phase 1 is the kernel)
        assert resolve_scan_mode("auto", 1, "gpu") == "bitplane"
        # ANY effective fold > 1 picks dense, however the fold arose
        assert resolve_scan_mode("auto", 4, "gpu") == "dense"
        assert resolve_scan_mode("auto", 2, "gpu") == "dense"
        assert resolve_scan_mode("auto", 1, "cpu") == "dense"
        # an explicit mode is never overridden
        assert resolve_scan_mode("bitplane", 4, "gpu") == "bitplane"

    def test_default_flags_beyond_hbm_library_serves_dense(self, monkeypatch):
        # integration: a library whose AUTO fold factor (memory-based, no
        # --fold flag anywhere) comes out > 1 must load in dense mode
        from gpusimilarity_jax.models import registry as registry_mod
        from gpusimilarity_jax.utils.fsim import write_fsim

        monkeypatch.setattr(registry_mod, "auto_fold_factor", lambda *a, **k: 4)
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            path = f"{td}/big.fsim"
            write_fsim(path, corpus_data())
            reg = registry_mod.DatabaseRegistry.from_fsim_files(
                [path], scan_mode="auto"
            )
        db = reg.get("big")
        assert db.fold_factor == 4
        assert db.scan_mode == "dense"

    def test_return_count_upper_bound(self, server):
        from gpusimilarity_jax.serve.server import MAX_RETURN_COUNT

        status, payload = post(
            server, "/similarity_search_json",
            {"smiles": "CCO", "return_count": MAX_RETURN_COUNT + 1,
             "similarity_cutoff": 0, "dbnames": "corpus"},
            expect_error=True,
        )
        assert status == 400 and "return_count" in payload["error"]

    def test_socket_return_count_bounds(self):
        import pytest

        from gpusimilarity_jax.serve.socket_server import parse_request
        from gpusimilarity_jax.utils.qtstream import QtStreamWriter

        def req(count):
            w = QtStreamWriter()
            w.write_int32(1)
            w.write_string(b"db")
            w.write_string(b"")
            w.write_int32(7)  # request_num
            w.write_int32(count)
            w.write_double(0.0)
            w.write_bytearray(b"\x00" * 128)
            return w.getvalue()

        parsed, _ = parse_request(req(20))
        assert parsed["return_count"] == 20
        for bad in (0, -5, 2**31 - 1):
            with pytest.raises(ValueError):
                parse_request(req(bad))

    def test_bitplane_store_unaligned_chunk_cols(self, rng):
        """A caller-chosen unaligned chunk width must not skew the sub-row
        layout or skip tail columns (it silently did before the fix)."""
        import numpy as np

        from gpusimilarity_jax.models import FingerprintDB
        from conftest import random_fingerprint_data

        data = random_fingerprint_data(rng, count=9000)
        db = FingerprintDB(data, scan_mode="bitplane", chunk_cols=5000)
        words = data.packed_words()
        for qi in (0, 4444, 8999):
            r = db.search(np.array(words[qi]), k=3, return_indices=True)
            assert r.indices[0] == qi and r.scores[0] == 1.0

    def test_single_dbkey_broadcasts_to_all(self, server):
        # FDW-style: db_name 'all' resolves to N databases but the table
        # carries ONE dbkey option — it must broadcast, not 400
        status, payload = post(
            server, "/similarity_search_json_all",
            {"smiles": "CCO", "return_count": 3, "similarity_cutoff": 0,
             "dbkeys": "sekrit"},
        )
        assert status == 200
        # 'corpus' (no key) rejects the key; 'keyed' accepts it
        assert payload["approximate_count"] == len(CORPUS)

    def test_duplicate_database_name_rejected(self):
        from gpusimilarity_jax.models import DatabaseRegistry

        registry = DatabaseRegistry()
        registry.add("lib", corpus_data())
        with pytest.raises(ValueError):
            registry.add("lib", corpus_data())

    def test_device_bitcount_auto_picks_dense(self):
        # --gpu_bitcount 256 implies fold 4 through _global_fold; the
        # registry resolves auto mode from that effective fold
        from gpusimilarity_jax.models import registry as registry_mod
        from gpusimilarity_jax.utils.fsim import write_fsim
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            path = f"{td}/cap.fsim"
            write_fsim(path, corpus_data())
            reg = registry_mod.DatabaseRegistry.from_fsim_files(
                [path], scan_mode="auto", device_bitcount=256
            )
        db = reg.get("cap")
        assert db.fold_factor == 4
        assert db.scan_mode == "dense"

    def test_createdb_skips_non_utf8_line(self, tmp_path):
        import gzip
        import subprocess
        import sys

        src = tmp_path / "in.smi.gz"
        with gzip.open(src, "wb") as f:
            f.write(b"CCO ok1\nCC\xe9O bad1\nCCC ok2\n")
        out = subprocess.run(
            [sys.executable, "-m", "gpusimilarity_jax.cli.createdb",
             str(src), str(tmp_path / "out.fsim")],
            capture_output=True, text=True,
        )
        assert out.returncode == 0, out.stderr
        from gpusimilarity_jax.utils.fsim import read_fsim

        assert read_fsim(tmp_path / "out.fsim").count == 2


class TestNonDefaultBitcount:
    """The HTTP layer sizes queries to the QUERIED database's bitcount —
    a legally-loaded 512-bit library must serve SMILES and fp_hex queries
    (it 500'd on every query when 1024 was hardcoded)."""

    @pytest.fixture(scope="class")
    def svc512(self):
        from gpusimilarity_jax.serve.server import SearchService

        fps, smiles = [], []
        for smi in CORPUS:
            fp, canon = smiles_to_fingerprint_bin(smi, bitcount=512)
            fps.append(np.frombuffer(fp, np.uint8))
            smiles.append(canon)
        data = FingerprintData(
            bitcount=512, fingerprints=np.stack(fps), smiles=smiles,
            ids=[f"H{i:04d}".encode() for i in range(len(CORPUS))],
        )
        registry = DatabaseRegistry()
        registry.add("half", data)
        registry.add("full", corpus_data())
        svc = SearchService(registry, window_ms=1.0)
        yield svc, fps
        svc.close()

    def test_smiles_query_serves_512_bit_db(self, svc512):
        svc, fps = svc512
        out = svc.handle_search({"smiles": CORPUS[0], "dbnames": "half"})
        assert out["results"][0][2] == 1.0  # self-match at the DB's width

    def test_fp_hex_at_db_width(self, svc512):
        svc, fps = svc512
        out = svc.handle_search(
            {"fp_hex": fps[3].tobytes().hex(), "dbnames": "half"}
        )
        assert out["results"][0][0] == "H0003"
        assert out["results"][0][2] == 1.0

    def test_fp_hex_wrong_width_is_400_not_500(self, svc512):
        svc, fps = svc512
        with pytest.raises(RequestError, match="bytes"):
            svc.handle_search({"fp_hex": "00" * 128, "dbnames": "half"})

    def test_mixed_width_query_rejected(self, svc512):
        svc, fps = svc512
        with pytest.raises(RequestError, match="mixed"):
            svc.handle_search({"smiles": "CCO", "dbnames": "half,full"})


class TestServeTimeouts:
    def test_timeout_plumbs_from_server_to_batcher(self):
        from gpusimilarity_jax.serve.server import SearchService

        registry = DatabaseRegistry()
        registry.add("c", corpus_data())
        svc = SearchService(registry, window_ms=1.0, search_timeout_s=123.0)
        try:
            assert svc.searcher._result_timeout_s == 123.0
        finally:
            svc.close()


class TestSocketCorruption:
    def test_corrupt_string_raises_corrupt_not_truncated(self):
        """A COMPLETE record whose string payload lacks its NUL must raise
        the corrupt subclass (fail the connection now), not the base
        truncation error (which means 'wait for more bytes' and used to
        stall the connection toward the 16 MiB cap in silence)."""
        from gpusimilarity_jax.serve.socket_server import parse_request
        from gpusimilarity_jax.utils.qtstream import (
            QtStreamCorruptError,
            QtStreamError,
            QtStreamWriter,
        )

        w = QtStreamWriter()
        w.write_int32(1)
        w.write_string(b"db")
        w.write_string(b"")
        w.write_int32(7)
        w.write_int32(20)
        w.write_double(0.0)
        w.write_bytearray(b"\x00" * 128)
        good = w.getvalue()
        parse_request(good)  # sanity: the uncorrupted record parses

        # flip the dbname string's trailing NUL (int32 count + uint32 len
        # + b"db" -> the NUL sits at offset 4 + 4 + 2)
        bad = bytearray(good)
        assert bad[10] == 0
        bad[10] = ord("X")
        with pytest.raises(QtStreamCorruptError):
            parse_request(bytes(bad))

        # genuine truncation still raises the BASE class only (retryable)
        try:
            parse_request(good[:-10])
            raise AssertionError("truncated record must not parse")
        except QtStreamCorruptError:
            raise AssertionError("truncation misclassified as corruption")
        except QtStreamError:
            pass
