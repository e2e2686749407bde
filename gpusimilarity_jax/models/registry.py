"""DatabaseRegistry — multi-database loading, search dispatch, result merge.

The service-layer equivalent of the reference's ``GPUSimServer`` registry and
``searchDatabases`` (``gpusim.cpp:87-166, 306-374``): databases are keyed by
file basename, a global fold factor is derived from total size vs device
memory (with an optional user bitcount override), and multi-database searches
merge score-sorted results with SMILES deduplication, joining the IDs of
duplicate compounds with ``";:;"``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from ..ops import fold as fold_ops
from ..ops.scan import TANIMOTO
from ..parallel.mesh import auto_fold_factor, make_mesh
from ..utils.fsim import FingerprintData, read_fsim
from .fingerprint_db import FingerprintDB
from .results import SearchResult

log = logging.getLogger("gpusimilarity_jax")

ID_JOIN = ";:;"  # reference's duplicate-compound ID separator (gpusim.cpp:354)


def resolve_scan_mode(scan_mode: str, effective_fold: int, backend: str) -> str:
    """Resolve ``--scan_mode auto`` to a concrete scan mode.

    MUST be called with the EFFECTIVE fold factor — after the registry's
    automatic memory-based fold decision (``_global_fold``), not just the
    user's explicit ``--fold``/``--gpu_bitcount`` flags. Folding densifies
    queries (fold-4 Morgan selects ~60 of 256 planes), so ANY effective
    fold > 1, whether from an explicit flag or from a library larger than
    device memory, picks dense. Unfolded, ``gpu`` picks the bit-sliced scan
    (whose phase 1 then runs as the Pallas kernel of
    ``ops/triton_bitplane.py``, see :class:`FingerprintDB`) and ``cpu``
    picks dense. Any other backend raises: no device is assumed. The
    reference has no analogous decision (one scan kernel); its auto-fold
    precedent is ``gpusim.cpp:119-143``.
    """
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"no scan mode rule for backend {backend!r}")
    if scan_mode != "auto":
        return scan_mode
    if int(effective_fold) == 1 and backend == "gpu":
        return "bitplane"
    return "dense"


class DatabaseRegistry:
    """A set of named FingerprintDBs sharing one mesh and fold factor."""

    def __init__(self, mesh=None):
        self._mesh = mesh if mesh is not None else make_mesh()
        self._dbs: dict[str, FingerprintDB] = {}
        self.search_count = 0
        self.total_search_seconds = 0.0
        # searches run concurrently from the batcher's group pool
        self._stats_lock = threading.Lock()
        # set on process 0 in multi-host serving: fans each search out to
        # every process (see parallel.multihost.MultihostController)
        self.multihost_controller = None

    # ---------------------------------------------------------------- loading

    @classmethod
    def from_fsim_files(
        cls,
        paths: Sequence[str],
        mesh=None,
        device_bitcount: int = 0,
        fold_factor: Optional[int] = None,
        scan_mode: str = "dense",
        precompile_ks: Optional[Sequence[int]] = None,
        precompile_batch: int = 1,
        popless: bool = False,
    ) -> "DatabaseRegistry":
        """Load ``.fsim`` files or native ``.tfsim`` directories; database
        names are file basenames (reference ``gpusim.cpp:114-116``).

        ``device_bitcount`` mirrors ``--gpu_bitcount``: an upper bound on the
        on-device fingerprint width. It errors if the data can't fit at that
        width's implied fold (reference ``gpusim.cpp:144-151``).

        ``scan_mode`` may be ``"auto"``: it is resolved HERE, after the
        global fold factor is known, because the right mode depends on the
        effective fold (see :func:`resolve_scan_mode`) — a 20 GB library
        served with default flags must end up dense, not folded-bitplane.

        ``precompile_ks`` enables the **overlapped startup** (single-process
        only): for each database the warmup shapes AOT-compile on a
        background thread from geometry alone while the library streams,
        folds, and uploads in the foreground, and the post-upload mmap page
        prewarm also runs in the background — the three long poles of a
        cold start run concurrently instead of sequentially. A
        subsequent :meth:`warmup` joins the precompiles and executes each
        shape once, compile-free.
        """
        from ..utils.tfsim import load_any

        reg = cls(mesh=mesh)
        datas: list[tuple[str, FingerprintData]] = []
        for p in paths:
            name = os.path.basename(str(p).rstrip("/"))
            for suffix in (".fsim", ".tfsim"):
                if name.endswith(suffix):
                    name = name[: -len(suffix)]
            t0 = time.monotonic()
            data = load_any(p)
            log.info(
                "loaded %s: %d compounds, %d bits, dbkey=%r (%.2fs)",
                name, data.count, data.bitcount, data.dbkey,
                time.monotonic() - t0,
            )
            datas.append((name, data))

        fold = fold_factor if fold_factor is not None else cls._global_fold(
            datas, device_bitcount
        )
        if scan_mode == "auto":
            import jax

            scan_mode = resolve_scan_mode(
                scan_mode, fold, jax.default_backend()
            )
            log.info(
                "auto scan mode resolved to %s (effective fold %d)",
                scan_mode, fold,
            )
        if popless and scan_mode != "dense":
            log.info("popless store forces dense scan mode (was %s)", scan_mode)
            scan_mode = "dense"
        overlap = precompile_ks is not None
        if overlap:
            import jax

            # multi-host processes must compile+upload in lockstep
            overlap = jax.process_count() == 1
        for name, data in datas:
            t0 = time.monotonic()
            db = reg.add(
                name, data, fold_factor=fold, scan_mode=scan_mode,
                defer_upload=overlap, popless=popless,
            )
            if overlap:
                db.start_precompile(
                    ks=tuple(precompile_ks), max_batch=precompile_batch
                )
                db.upload(async_prewarm=True)
                log.info(
                    "uploaded %s to device mesh (%.2fs; AOT compiles and "
                    "page prewarm continue in background)",
                    name, time.monotonic() - t0,
                )
            else:
                log.info(
                    "uploaded %s to device mesh (%.2fs)",
                    name, time.monotonic() - t0,
                )
        return reg

    @staticmethod
    def _global_fold(
        datas: Sequence[tuple[str, FingerprintData]], device_bitcount: int
    ) -> int:
        """One fold factor for all databases, from total bytes vs free device
        memory (reference ``gpusim.cpp:119-151``)."""
        total_bytes = sum(d.fingerprints.nbytes for _, d in datas)
        fold = auto_fold_factor(total_bytes)
        if device_bitcount:
            if not datas:
                return 1
            # max across databases, like the reference's max_fp_bitcount
            # (gpusim.cpp:127-128,145): the first file's width must not
            # decide whether the others get folded under the cap
            bitcount = max(d.bitcount for _, d in datas)
            requested_fold = max(1, bitcount // device_bitcount)
            if requested_fold < fold:
                raise MemoryError(
                    f"device_bitcount {device_bitcount} needs fold "
                    f"{requested_fold}, but the data requires at least {fold} "
                    "to fit in device memory"
                )
            fold = requested_fold
        if fold > 1:
            log.info("folding fingerprints by %d to fit device memory", fold)
        return fold

    def add(
        self,
        name: str,
        data: FingerprintData,
        fold_factor: int | str = 1,
        scan_mode: str = "dense",
        use_pallas: bool | None = None,
        defer_upload: bool = False,
        popless: bool = False,
        interpret: bool = False,
    ) -> FingerprintDB:
        if name in self._dbs:
            # two paths sharing a basename would silently shadow half the
            # data (every query resolves names through this dict)
            raise ValueError(f"database name {name!r} already loaded")
        db = FingerprintDB(
            data, mesh=self._mesh, fold_factor=fold_factor,
            scan_mode=scan_mode, use_pallas=use_pallas,
            defer_upload=defer_upload, popless=popless, interpret=interpret,
        )
        self._dbs[name] = db
        return db

    # ----------------------------------------------------------------- access

    def names(self) -> list[str]:
        return sorted(self._dbs)

    def get(self, name: str) -> FingerprintDB:
        return self._dbs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._dbs

    def warmup(
        self, ks: Sequence[int] = (20, 128), max_batch: int = 1
    ) -> None:
        """Precompile each database's common search shapes (see
        ``FingerprintDB.warmup``); called at server start unless disabled."""
        for name, db in self._dbs.items():
            t0 = time.monotonic()
            db.warmup(ks=ks, max_batch=max_batch)
            log.info("warmed up %s (%.2fs)", name, time.monotonic() - t0)

    def stats(self) -> dict:
        from ..parallel import sharded

        return {
            # which phase-1 implementation each scan mode last compiled
            "phase1_impl": dict(sharded.LAST_PHASE1_IMPL),
            "databases": {
                name: {
                    "count": db.count,
                    "bitcount": db.bitcount,
                    "device_bitcount": db.device_bitcount,
                    "fold_factor": db.fold_factor,
                    "shards": db._store.n_shards,
                    "device_bytes": db._store.nbytes,
                }
                for name, db in self._dbs.items()
            },
            "searches": self.search_count,
            "total_search_seconds": round(self.total_search_seconds, 6),
            "compiled_programs": sum(
                db.compile_count for db in self._dbs.values()
            ),
        }

    # ----------------------------------------------------------------- search

    def search_databases(
        self,
        dbnames: Sequence[str],
        dbkeys: Sequence[str],
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
    ) -> SearchResult:
        """Search several databases and merge (reference ``searchDatabases``,
        ``gpusim.cpp:306-374``): sort all results descending by score, drop
        duplicate SMILES joining their IDs with ``";:;"``, truncate to k, and
        sum approximate counts."""
        [merged] = self.search_databases_batch(
            dbnames, dbkeys, np.asarray(query)[None, :], [k], [cutoff],
            similarity=similarity, alpha=alpha, beta=beta,
        )
        return merged

    def _execute_batch(
        self, dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
    ) -> list:
        """One device pass per database — the SPMD half of a search.

        Runs IDENTICALLY on every process in multi-host serving (workers
        call it from ``MultihostController.serve_worker``); anything that
        can diverge between processes (key checks, name resolution) is
        decided before dispatch and travels as ``key_oks`` flags.
        """
        import jax

        per_db = []
        for name, ok in zip(dbnames, key_oks):
            db = self._dbs[name]
            # a pre-checked key mismatch yields the engine's empty-result
            # path on every process alike (no device program runs)
            key = db.dbkey if ok else db.dbkey + "\x00mismatch"
            # profiler annotation: shows up in TensorBoard traces captured
            # via --jax_profiler_port (the rebuild's tracing hook; the
            # reference only had a wall-clock log, gpusim.cpp:420-429)
            with jax.profiler.TraceAnnotation(f"jaxsim.search.{name}"):
                per_db.append(
                    db.search_batch(
                        queries, k=list(ks), cutoff=list(cutoffs), dbkey=key,
                        similarity=similarity, alpha=alpha, beta=beta,
                    )
                )
        return per_db

    def search_databases_batch(
        self,
        dbnames: Sequence[str],
        dbkeys: Sequence[str],
        queries: np.ndarray,
        ks: Sequence[int],
        cutoffs: Sequence[float],
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
    ) -> list[SearchResult]:
        """Batched multi-database search: one device pass per database for the
        whole ``(B, W)`` query batch, then a per-query cross-DB merge."""
        t0 = time.monotonic()
        b = len(queries)
        for name in dbnames:
            if name not in self._dbs:
                raise KeyError(f"unknown database {name!r}")
        key_oks = [
            key == self._dbs[name].dbkey for name, key in zip(dbnames, dbkeys)
        ]
        if self.multihost_controller is not None:
            per_db = self.multihost_controller.dispatch_batch(
                list(dbnames), key_oks, queries, list(ks), list(cutoffs),
                similarity, alpha, beta,
            )
        else:
            per_db = self._execute_batch(
                dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
            )
        merged = [
            merge_results([db_results[qi] for db_results in per_db], int(ks[qi]))
            for qi in range(b)
        ]
        elapsed = time.monotonic() - t0
        with self._stats_lock:
            self.search_count += b
            self.total_search_seconds += elapsed
        log.info(
            "batched search over %s: %d queries, %.1f ms",
            list(dbnames), b, elapsed * 1e3,
        )
        return merged


def merge_results(results: Sequence[SearchResult], k: int) -> SearchResult:
    """Score-sorted cross-database merge with SMILES dedup + ID joining."""
    rows = []
    for db_order, r in enumerate(results):
        for smi, cid, score in zip(r.smiles, r.ids, r.scores):
            rows.append((-score, db_order, cid, smi))
    rows.sort()

    seen: dict[str, int] = {}
    out = SearchResult(approximate_count=sum(r.approximate_count for r in results))
    for neg_score, _, cid, smi in rows:
        if smi in seen:
            out.ids[seen[smi]] += ID_JOIN + cid
            continue
        if len(out.scores) >= k:
            continue
        seen[smi] = len(out.scores)
        out.smiles.append(smi)
        out.ids.append(cid)
        out.scores.append(-neg_score)
    return out
