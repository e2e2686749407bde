"""Smoke test of the served search path on a GPU.

Run from the root of a checkout on a machine with an NVIDIA card::

    python chip_smoke.py             # one card: phases 1-5
    python chip_smoke.py --cards 4   # four cards: phases 1, 2 and 6 only

Phases (any failed check, exception or non-GPU platform ends the run with
``"ok": false`` and a non-zero exit; no phase's failure is passed over):

1. card — ``nvidia-smi``'s name and power limit;
2. native library — built with ``make -C native``, loaded by
   ``utils/native.py``;
3. served path — a synthetic v3 ``.tfsim`` of Enamine 2/12 (113,335,291
   rows of 1024 bits, the clustered lowbias32 library of ``utils/synth.py``,
   rounded up to the bitplane store's alignment) served by
   ``python -m gpusimilarity_jax.cli.server`` with default flags. Library
   rows are sent as ``fp_hex`` self-queries over HTTP at return_count 20
   and 128 and cutoffs 0, 0.3 and 0.5, one at a time and then as a
   concurrent burst of 32. Every response is checked (rank 0 is the query's
   own row at 1.0, every score is the full-width Tanimoto of the row it
   names, descending order); two queries are also checked against a full
   host oracle over all rows (top-k score multiset and approximate_count);
4. kernels — every phase-1 implementation (XLA dense, XLA bitplane, the
   Pallas bitplane kernel) timed at 113M rows, B=1 and B=32, alone and
   through ``FingerprintDB.search_batch``; checked at 113M rows against
   phase 3's full host oracle, and compared with the numpy oracle on a
   2M-row store (Tanimoto bit-exact, Tversky within 1 ulp);
5. division — the exhaustive grid of ``tools/verify_exactdiv.py``;
6. (``--cards 4`` only) Enamine 18/12, 1,020,017,472 rows unfolded, served
   on a 4-card mesh with the phase-3 checks, then the 2M-row oracle
   comparison of phase 4 on the same mesh.

The server runs as a subprocess; this process initialises JAX on the GPU
only after the server has exited (a JAX process reserves most of a card's
memory). Times printed here are smoke figures — few samples, one process,
cold caches — not benchmark figures. The last line of standard output is
one JSON object: ``{"ok": ..., "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

ENAMINE_2_12 = 113_335_291  # BASELINE.md: 202.76 ms on 2x1080Ti
ENAMINE_18_12 = 1_020_017_472  # BASELINE.md: 451.72 ms fold 4 on 4xV100
SEED = 7
ORACLE_ROWS = 2 << 20
ORACLE_CUTOFFS = (0.0, 0.3, 0.5)
ID_WIDTH = 10  # ids are the zero-padded row number
# alpha and beta exact in f32: the only rounding left in a Tversky score is
# the divide, which is what the 1-ulp envelope is for
TVERSKY = (0.75, 0.25)
H100_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


class SmokeFailure(Exception):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ phase 1-2


def card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        raise SmokeFailure("no nvidia-smi: this machine has no NVIDIA card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), "nvidia-smi failed")
    return out.stdout.strip()


def build_native() -> bool:
    out = subprocess.run(
        ["make", "-C", os.path.join(ROOT, "native")],
        capture_output=True, text=True, timeout=600,
    )
    check(out.returncode == 0, f"make -C native failed: {out.stderr[-2000:]}")
    from gpusimilarity_jax.utils import native

    return native._load() is not None


# -------------------------------------------------------------- the library


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """``uint8 (len(values), width)``: zero-padded decimal ASCII."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // powers) % 10 + ord("0")).astype(np.uint8)


def id_blob(n: int) -> np.ndarray:
    """``uint8 (n, ID_WIDTH)``: each row's id is its zero-padded index.

    Built in blocks of 10**4 rows (a shared 6-digit prefix, the same
    4-digit tails), so a billion ids cost two broadcast copies."""
    tail = 10**4
    blocks = -(-n // tail)
    out = np.empty((blocks, tail, ID_WIDTH), np.uint8)
    out[:, :, ID_WIDTH - 4 :] = _digits(np.arange(tail), 4)[None]
    out[:, :, : ID_WIDTH - 4] = _digits(np.arange(blocks), ID_WIDTH - 4)[:, None]
    return out.reshape(-1, ID_WIDTH)[:n]


def write_library(path: str, n: int, seed: int = SEED) -> None:
    """A synthetic v3 ``.tfsim``: fingerprints are the counter mixer of the
    row index; ids and smiles are real fixed-width records naming each row
    (distinct smiles: results are deduplicated by smiles)."""
    from gpusimilarity_jax.utils import synth
    from gpusimilarity_jax.utils.fsim import FingerprintData
    from gpusimilarity_jax.utils.strings import StridedStringTable
    from gpusimilarity_jax.utils.tfsim import save_native

    table = StridedStringTable(id_blob(n).reshape(-1), ID_WIDTH)
    data = FingerprintData(
        dbkey="smoke",
        bitcount=1024,
        fingerprints=synth.VirtualFingerprints(n, 1024, seed),
        smiles=table,
        ids=table,
    )
    save_native(path, data)


def full_width_scores(words, rows, query) -> np.ndarray:
    """f32 Tanimoto of library ``rows`` against ``query``, from the host."""
    from gpusimilarity_jax.ops.scan import scores_np

    return scores_np(
        words[np.asarray(rows, np.int64)], np.asarray(query)[None, :]
    )[0]


def response_errors(payload, words, row: int, k: int, cutoff: float) -> list:
    """What is wrong with one HTTP response to a self-query of ``row``."""
    errs = []
    if not {"approximate_count", "results"} <= set(payload):
        return [f"response keys {sorted(payload)}"]
    results = payload["results"]
    if not isinstance(results, list) or len(results) > k:
        return [f"results is not a list of at most {k}"]
    if any(not (isinstance(r, list) and len(r) == 3) for r in results):
        return ["a result is not [id, smiles, score]"]
    if not results:
        return ["no results"]
    try:
        idx = np.array([int(r[0]) for r in results], np.int64)
    except ValueError:
        return ["an id is not a row number"]
    if idx.min() < 0 or idx.max() >= len(words):
        return ["an id names no row"]
    got = np.array([r[2] for r in results], np.float64)
    want = full_width_scores(words, idx, words[row])
    if not np.array_equal(got, want.astype(np.float64)):
        errs.append(f"{int((got != want).sum())} scores differ from full width")
    if np.any(np.diff(got) > 0):
        errs.append("scores not in descending order")
    if np.any(got < np.float32(cutoff)):
        errs.append("a score below the cutoff")
    # rank 0 is the query's own row (or an identical fingerprint ranked
    # before it — then the row itself must follow at 1.0)
    mine = np.nonzero(idx == row)[0]
    if got[0] != 1.0 or len(mine) == 0 or np.any(got[: mine[0] + 1] != 1.0):
        errs.append(f"rank 0 is row {idx[0]} at {got[0]}, not the query {row}")
    if payload["approximate_count"] < len(results):
        errs.append("approximate_count below the number of results")
    return errs


# ------------------------------------------------------------- host oracle


def _oracle_chunk(args):
    n, seed, lo, hi, queries, k, cutoffs = args
    from gpusimilarity_jax.utils import synth

    rows = synth.VirtualWords(n, queries.shape[1], seed)[lo:hi]
    pops = np.bitwise_count(rows).sum(axis=1, dtype=np.int32)
    tops, counts = [], []
    for q in queries:
        common = np.bitwise_count(rows & q).sum(axis=1, dtype=np.int32)
        qpop = int(np.bitwise_count(q).sum())
        den = (qpop + pops - common).astype(np.float32)
        with np.errstate(invalid="ignore", divide="ignore"):
            s = np.where(den > 0, common.astype(np.float32) / den, np.float32(0))
        s = s.astype(np.float32)
        kk = min(k, len(s))
        tops.append(np.sort(np.partition(s, len(s) - kk)[len(s) - kk :])[::-1])
        counts.append([int((s >= np.float32(c)).sum()) for c in cutoffs])
    return tops, counts


def host_oracle(n, seed, queries, k, cutoffs, chunk=1 << 21, workers=None):
    """Exact full-width top-k score multisets and cutoff counts of
    ``queries`` over all ``n`` library rows, streamed in row chunks across
    worker processes (``np.bitwise_count``; nothing is kept but per-chunk
    top-k and counts). Returns ``(top f32 (Q, k), counts int (Q, C))``."""
    queries = np.asarray(queries, np.uint32)
    jobs = [
        (n, seed, lo, min(n, lo + chunk), queries, k, tuple(cutoffs))
        for lo in range(0, n, chunk)
    ]
    # half the cores: the server compiles and serves on the rest
    workers = workers or max(1, min(16, (os.cpu_count() or 2) // 2))
    ctx = multiprocessing.get_context("spawn")
    tops = [[] for _ in queries]
    counts = np.zeros((len(queries), len(cutoffs)), np.int64)
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        for t, c in pool.map(_oracle_chunk, jobs):
            for qi in range(len(queries)):
                tops[qi].append(t[qi])
            counts += np.asarray(c, np.int64)
    top = np.stack(
        [np.sort(np.concatenate(t))[::-1][:k] for t in tops]
    ).astype(np.float32)
    return top, counts


def oracle_mismatches(payload, top, k: int, cutoff: float, count) -> list:
    """How one response differs from the full oracle of its query: the
    top-k score multiset above the cutoff, and the cutoff count."""
    errs = []
    got = np.sort(np.array([r[2] for r in payload["results"]], np.float32))
    want = top[:k][top[:k] >= np.float32(cutoff)]
    if not np.array_equal(got[::-1], want):
        errs.append("top-k score multiset differs")
    if payload["approximate_count"] != count:
        errs.append(f"count {payload['approximate_count']} != {count}")
    return errs


# ------------------------------------------------------------ served path


class Server:
    """``python -m gpusimilarity_jax.cli.server`` as a child process."""

    def __init__(self, path: str):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            self.port = s.getsockname()[1]
        self.lines: list[str] = []
        self.ready = threading.Event()
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gpusimilarity_jax.cli.server", path,
             "--port", str(self.port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT,
        )
        self.ready_s = None
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if " ready on " in line and self.ready_s is None:
                self.ready_s = time.monotonic() - self.t0
                self.ready.set()
        self.ready.set()

    def wait_ready(self, timeout: float) -> None:
        self.ready.wait(timeout)
        if self.ready_s is None:
            tail = "\n".join(self.lines[-40:])
            raise SmokeFailure(f"server not ready in {timeout:.0f} s:\n{tail}")

    def log_value(self, pattern: str):
        for line in self.lines:
            m = re.search(pattern, line)
            if m:
                return m.group(1)
        return None

    def post(self, form: dict, timeout: float = 900) -> tuple[dict, float]:
        body = urllib.parse.urlencode(form).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(
            f"http://localhost:{self.port}/similarity_search_json", body,
            timeout=timeout,
        ) as r:
            check(r.status == 200, f"HTTP {r.status}")
            payload = json.loads(r.read())
        return payload, time.perf_counter() - t0

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(
            f"http://localhost:{self.port}{path}", timeout=60
        ) as r:
            return json.loads(r.read())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(60)
        self._reader.join(10)


def served_path(n_rows: int, cards: int, full_oracle: bool):
    """Phases 3 and 6: build, serve, query and check a synthetic library.

    With ``full_oracle``, returns ``(rows, top, counts)``: the host oracle
    of two query rows over the whole library (see :func:`host_oracle`),
    for phase 4 to check the other phase-1 paths against."""
    from gpusimilarity_jax.utils import synth

    n = synth.aligned_virtual_rows(n_rows, cards)
    say(f"[served] library rows: {n_rows:,} requested, {n:,} served "
        f"(aligned to the bitplane store)")
    words = synth.VirtualWords(n, 32, SEED)
    rng = np.random.default_rng(SEED)
    # query rows spread over every card's span, first and last row included
    span = n // cards
    singles = [0, n - 1] + [
        int(c * span + rng.integers(span)) for c in range(cards)
    ]
    kinds = [(k, c) for k in (20, 128) for c in ORACLE_CUTOFFS]
    burst = [int(r) for r in rng.choice(n, 32, replace=False)]

    oracle_pool = None
    oracle_future = None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.monotonic()
        path = os.path.join(tmp, "smoke.tfsim")
        write_library(path, n)
        say(f"[served] wrote {path} in {time.monotonic() - t0:.1f} s")
        if full_oracle:
            # two queries against every row, on the host, while the server
            # starts (it runs on other cores)
            oracle_rows = singles[:2]
            oracle_pool = cf.ThreadPoolExecutor(1)
            oracle_future = oracle_pool.submit(
                host_oracle, n, SEED, words[np.array(oracle_rows)], 128,
                ORACLE_CUTOFFS,
            )
        srv = Server(path)
        try:
            srv.wait_ready(1100)
            warm = srv.log_value(r"warmed up smoke \(([0-9.]+)s\)")
            aot = srv.log_value(r"AOT-precompiled (\d+ search programs in \S+)")
            mode = srv.log_value(r"auto scan mode resolved to (.*)")
            say(f"[served] smoke figure: server ready in {srv.ready_s:.1f} s "
                f"after launch; warmup {warm} s; AOT precompile {aot}")
            say(f"[served] mode: {mode}")
            lat: dict = {kind: [] for kind in kinds}
            answers = {}
            errors = 0

            def ask(row, k, cutoff):
                payload, dt = srv.post({
                    "fp_hex": words[row].tobytes().hex(),
                    "return_count": k, "similarity_cutoff": cutoff,
                    "dbnames": "smoke", "dbkeys": "smoke",
                })
                return payload, dt

            for row in singles:
                for k, c in kinds:
                    payload, dt = ask(row, k, c)
                    lat[(k, c)].append(dt)
                    answers[(row, k, c)] = payload
                    errs = response_errors(payload, words, row, k, c)
                    if errs:
                        errors += 1
                        say(f"[served] row {row} k={k} cutoff={c}: {errs}")
            for k, c in kinds:
                say(f"[served] smoke figure: single k={k} cutoff={c}: "
                    f"p50 {statistics.median(lat[(k, c)]) * 1e3:.1f} ms "
                    f"over {len(lat[(k, c)])}")
            t0 = time.monotonic()
            with cf.ThreadPoolExecutor(32) as pool:
                futs = [
                    pool.submit(ask, row, *kinds[i % len(kinds)])
                    for i, row in enumerate(burst)
                ]
                burst_out = [f.result() for f in futs]
            burst_s = time.monotonic() - t0
            for i, (row, (payload, _)) in enumerate(zip(burst, burst_out)):
                k, c = kinds[i % len(kinds)]
                errs = response_errors(payload, words, row, k, c)
                if errs:
                    errors += 1
                    say(f"[served] burst row {row} k={k} cutoff={c}: {errs}")
            say(f"[served] smoke figure: burst of 32 in {burst_s:.2f} s, "
                f"p50 {statistics.median([d for _, d in burst_out]) * 1e3:.1f}"
                f" ms (first burst compiles the B=32 programs)")
            stats = srv.get("/stats")
            say(f"[served] phase-1 implementation: {stats.get('phase1_impl')}; "
                f"compiled programs {stats.get('compiled_programs')}; "
                f"fold {stats['databases']['smoke']['fold_factor']}; "
                f"shards {stats['databases']['smoke']['shards']}")
            check(stats["databases"]["smoke"]["shards"] == cards,
                  "library not sharded over every card")
            responses = len(singles) * len(kinds) + len(burst)
            say(f"[served] {responses} responses, {errors} with errors")
            check(errors == 0, f"{errors} responses failed their checks")
        finally:
            srv.stop()
        if oracle_future is not None:
            t0 = time.monotonic()
            top, counts = oracle_future.result()
            mism = 0
            for qi, row in enumerate(oracle_rows):
                for k, c in kinds:
                    for err in oracle_mismatches(
                        answers[(row, k, c)], top[qi], k, c,
                        counts[qi][ORACLE_CUTOFFS.index(c)],
                    ):
                        mism += 1
                        say(f"[served] oracle: row {row} k={k} c={c}: {err}")
            say(f"[served] full host oracle over {n:,} rows for rows "
                f"{oracle_rows}: {mism} mismatches "
                f"(+{time.monotonic() - t0:.1f} s wait)")
            check(mism == 0, "served results differ from the full oracle")
            return oracle_rows, top, counts
        return None
    finally:
        if oracle_pool is not None:
            oracle_pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- kernels


IMPLS = (("dense", False), ("bitplane", False), ("bitplane", True))


def impl_name(mode: str, kernel: bool) -> str:
    return f"{mode} {'pallas' if kernel else 'xla'}"


def virtual_data(n: int, seed: int):
    from gpusimilarity_jax.utils import synth
    from gpusimilarity_jax.utils.fsim import FingerprintData
    from gpusimilarity_jax.utils.strings import ConstantStringTable

    return FingerprintData(
        dbkey="smoke", bitcount=1024,
        fingerprints=synth.VirtualFingerprints(n, 1024, seed),
        smiles=ConstantStringTable(b"C", n),
        ids=ConstantStringTable(b"x", n),
    )


def ulp_distance(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def oracle_scores(full, pops, query, similarity, alpha, beta) -> np.ndarray:
    """``ops.scan.scores_np`` of one query over ``full``, with the popcounts
    taken by ``np.bitwise_count`` (same arithmetic, far faster)."""
    c = np.bitwise_count(full & query).sum(axis=1, dtype=np.int64)
    qp = int(np.bitwise_count(query).sum())
    c, dp = c.astype(np.float64), pops.astype(np.float64)
    if similarity == "tanimoto":
        den = qp + dp - c
    else:
        den = alpha * (qp - c) + beta * (dp - c) + c
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(den > 0, c / den, 0.0).astype(np.float32)


def oracle_errors(results, oracle, cutoffs, k, similarity,
                  exact_order: bool) -> int:
    """Errors of ``search_batch(..., return_indices=True)`` results against
    the oracle scores ``oracle[qi]`` of every row. Tanimoto must match bit
    for bit, Tversky within 1 ulp; ``exact_order`` also demands the
    oracle's lowest-index tie order (the dense path's guarantee)."""
    tol = 0 if similarity == "tanimoto" else 1
    errors = 0
    for qi, r in enumerate(results):
        s = oracle[qi]
        order = np.lexsort((np.arange(len(s)), -s))[:k]
        cut = np.float32(cutoffs[qi])
        want = s[order]
        keep = want >= cut
        got = np.asarray(r.scores, np.float32)
        gi = np.asarray(r.indices, np.int64)
        if len(got) != int(keep.sum()) and tol == 0:
            errors += 1
            continue
        m = min(len(got), int(keep.sum()))
        errors += int(np.any(ulp_distance(got[:m], want[keep][:m]) > tol))
        errors += int(np.any(ulp_distance(got, s[gi]) > tol))
        errors += int(np.any(np.diff(got) > 0))
        if exact_order and tol == 0:
            errors += int(not np.array_equal(gi, order[keep]))
        if tol == 0:
            errors += int(r.approximate_count != int((s >= cut).sum()))
        else:
            lo = int((np.nextafter(s, np.float32(-np.inf)) >= cut).sum())
            hi = int((np.nextafter(s, np.float32(np.inf)) >= cut).sum())
            errors += int(not lo <= r.approximate_count <= hi)
    return errors


def oracle_comparison(mesh_note: str) -> None:
    """Every phase-1 implementation against the numpy oracle, 2M rows."""
    from gpusimilarity_jax.models import FingerprintDB
    from gpusimilarity_jax.parallel import sharded
    from gpusimilarity_jax.utils import synth

    n = synth.aligned_virtual_rows(ORACLE_ROWS, _device_count())
    full = synth.virtual_matrix(n, seed=SEED + 1)
    rows = np.random.default_rng(SEED + 1).choice(n, 32, replace=False)
    queries = full[rows]
    cutoffs = np.array([(0.0, 0.2, 0.3, 0.5)[i % 4] for i in range(32)],
                       np.float32)
    pops = np.bitwise_count(full).sum(axis=1, dtype=np.int64)
    oracle = {
        sim: [oracle_scores(full, pops, q, sim, *ab) for q in queries]
        for sim, ab in (("tanimoto", (1.0, 1.0)), ("tversky", TVERSKY))
    }
    total = 0
    for mode, kernel in IMPLS:
        db = FingerprintDB(virtual_data(n, SEED + 1), scan_mode=mode,
                           use_pallas=kernel)
        for similarity, (alpha, beta) in (
            ("tanimoto", (1.0, 1.0)), ("tversky", TVERSKY)
        ):
            for b in (1, 32):
                res = db.search_batch(
                    queries[:b], k=128, cutoff=cutoffs[:b], dbkey="smoke",
                    similarity=similarity, alpha=alpha, beta=beta,
                    return_indices=True,
                )
                impl = sharded.LAST_PHASE1_IMPL.get(mode)
                check(impl == ("pallas" if kernel else "xla"),
                      f"{impl_name(mode, kernel)} compiled {impl!r} phase 1")
                errs = oracle_errors(
                    res, oracle[similarity], cutoffs, 128, similarity,
                    exact_order=mode == "dense",
                )
                total += errs
                say(f"[oracle] {n:,} rows{mesh_note}, {impl_name(mode, kernel)}"
                    f", {similarity}, B={b}: {errs} errors")
        del db
    check(total == 0, f"{total} oracle errors")


def _device_count() -> int:
    import jax

    return len(jax.devices())


def time_kernels(n_rows: int, oracle) -> None:
    """Phase 4 at the full library width: each phase-1 path timed, and its
    answers to the oracle's query rows checked against ``oracle`` (the
    full host oracle phase 3 computed for the same library)."""
    import jax

    from gpusimilarity_jax.models import FingerprintDB
    from gpusimilarity_jax.parallel import sharded
    from gpusimilarity_jax.utils import synth

    n = synth.aligned_virtual_rows(n_rows, _device_count())
    words = synth.VirtualWords(n, 32, SEED)
    rows = np.random.default_rng(SEED + 2).choice(n, 32, replace=False)
    queries = words[rows]
    for mode, kernel in IMPLS:
        t0 = time.monotonic()
        db = FingerprintDB(virtual_data(n, SEED), scan_mode=mode,
                           use_pallas=kernel)
        jax.block_until_ready((db._store.popcounts,))
        say(f"[kernels] {impl_name(mode, kernel)}: {n:,}-row store built on "
            f"the device in {time.monotonic() - t0:.1f} s")
        check_full_oracle(db, words, oracle, impl_name(mode, kernel))
        for b in (1, 32):
            fn, args, _ = db.device_call(queries[:b], 128, np.zeros(b))
            t0 = time.monotonic()
            vals, idx, _ = jax.block_until_ready(fn(*args))
            compile_s = time.monotonic() - t0
            impl = sharded.LAST_PHASE1_IMPL.get(mode)
            check(impl == ("pallas" if kernel else "xla"),
                  f"{impl_name(mode, kernel)} compiled {impl!r} phase 1")
            alone = []
            for _ in range(10):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*args))
                alone.append(time.perf_counter() - t0)
            e2e = []
            for _ in range(10):
                t0 = time.perf_counter()
                res = db.search_batch(queries[:b], k=128, dbkey="smoke")
                e2e.append(time.perf_counter() - t0)
            check(all(r.scores[0] == 1.0 for r in res),
                  f"{impl_name(mode, kernel)}: a self-query missed")
            med = statistics.median(alone)
            line = (f"[kernels] smoke figure: {impl_name(mode, kernel)} "
                    f"{n:,} rows B={b}: alone p50 {med * 1e3:.3f} ms "
                    f"(min {min(alone) * 1e3:.3f}), search_batch p50 "
                    f"{statistics.median(e2e) * 1e3:.3f} ms, first call "
                    f"{compile_s:.1f} s, {n * b / med:.3e} fp/s")
            if mode == "dense":
                nbytes = db._store.words.size * 4 + db._store.popcounts.size * 2
                line += (f", {nbytes / med / 1e9:.0f} GB/s = "
                         f"{nbytes / med / H100_BYTES_PER_S:.1%} of 3.35 TB/s")
            say(line)
        del db, fn, args
        jax.clear_caches()


def check_full_oracle(db, words, oracle, name: str) -> None:
    """Every returned score is its row's full-width score, in order, and
    the top-k multiset and counts equal the full host oracle's."""
    oracle_rows, top, counts = oracle
    queries = words[np.array(oracle_rows)]
    errors = 0
    for ci, c in enumerate(ORACLE_CUTOFFS):
        res = db.search_batch(queries, k=128, cutoff=c, dbkey="smoke",
                              return_indices=True)
        for qi, r in enumerate(res):
            payload = {
                "approximate_count": r.approximate_count,
                "results": [[f"{i}", "", v] for i, v in
                            zip(r.indices, r.scores)],
            }
            errs = response_errors(payload, words, oracle_rows[qi], 128, c)
            errs += oracle_mismatches(payload, top[qi], 128, c, counts[qi][ci])
            if errs:
                errors += 1
                say(f"[kernels] {name} row {oracle_rows[qi]} cutoff {c}: {errs}")
    say(f"[kernels] {name}: full oracle over {len(words):,} rows for rows "
        f"{oracle_rows}, cutoffs {ORACLE_CUTOFFS}: {errors} errors")
    check(errors == 0, f"{name} differs from the full oracle")


def device_memory_report() -> None:
    from gpusimilarity_jax.parallel.mesh import (
        auto_fold_factor,
        available_device_memory,
    )
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    say(f"[memory] bytes_limit {stats.get('bytes_limit')} per card, "
        f"available {available_device_memory()} over {_device_count()} "
        f"card(s); auto fold: {ENAMINE_2_12:,} rows -> "
        f"{auto_fold_factor(ENAMINE_2_12 * 128)}, {ENAMINE_18_12:,} rows -> "
        f"{auto_fold_factor(ENAMINE_18_12 * 128)}")


def start_jax(cards: int):
    import jax

    from gpusimilarity_jax.utils import jax_cache

    jax_cache.enable()
    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"JAX platform is {devices[0].platform!r}, not gpu")
    check(len(devices) >= cards, f"{len(devices)} cards, need {cards}")
    return devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: serve 1,020,017,472 rows on a 4-card mesh "
                    "(phase 6) instead of phases 3-5")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    try:
        say(card_line())
        say(f"[native] library loaded: {build_native()}")
        if args.cards == 1:
            oracle = served_path(ENAMINE_2_12, 1, full_oracle=True)
            devices = start_jax(1)
            device_memory_report()
            time_kernels(ENAMINE_2_12, oracle)
            oracle_comparison("")
            sys.path.insert(0, os.path.join(ROOT, "tools"))
            import verify_exactdiv

            div = verify_exactdiv.run(log=say)
            say(f"[division] {div}")
            check(div["ok"], "division grid mismatches")
        else:
            served_path(ENAMINE_18_12, 4, full_oracle=False)
            devices = start_jax(4)
            device_memory_report()
            oracle_comparison(f" on a {len(devices)}-card mesh")
        say(f"[done] {time.monotonic() - t_start:.0f} s")
        say(json.dumps({"ok": True, "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        }}))
        return 0
    except Exception as e:  # report every failure as "ok": false
        import traceback

        traceback.print_exc()
        say(f"[failed] {type(e).__name__}: {e}")
        say(json.dumps({"ok": False}))
        return 1


if __name__ == "__main__":
    sys.exit(main())
