"""Query batching: coalesce concurrent requests into one device scan.

The reference deliberately serializes all searches behind a global mutex
(``gpusim_server.py:31-32``) — one request at a time over one socket. On an
accelerator the idiomatic win is the opposite: concurrent requests within a small window
become one ``(B, N)`` batched scan, multiplying throughput at nearly constant
latency. Requests that target the same database set and scoring mode batch
together; others run in their own group within the same drain cycle.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..models.registry import DatabaseRegistry
from ..models.results import SearchResult
from ..ops.scan import TANIMOTO


@dataclass
class _Pending:
    dbnames: tuple[str, ...]
    dbkeys: tuple[str, ...]
    query: np.ndarray
    k: int
    cutoff: float
    similarity: str
    alpha: float
    beta: float
    future: Future = field(default_factory=Future)

    def group_key(self):
        return (self.dbnames, self.dbkeys, self.similarity, self.alpha, self.beta)


class BatchingSearcher:
    """Thread-safe search front end that batches concurrent callers."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        max_batch: int = 64,
        window_ms: float = 2.0,
        result_timeout_s: float = 1500.0,
    ):
        self._registry = registry
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        # the result deadline must outlive a live compile: k-bucket
        # promotion keeps warmed shapes off that path, but a cold shape
        # (--no_warmup, k beyond the warmed max) still compiles on the
        # request thread
        self._result_timeout_s = result_timeout_s
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # groups run on a small pool, not inline in the drain loop: a group
        # stuck in a long XLA compile must not stall every other
        # group and all new arrivals for its duration (jit dispatch is
        # thread-safe; the device serializes actual execution)
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="jaxsim-scan"
        )
        self._worker = threading.Thread(
            target=self._run, name="jaxsim-batcher", daemon=True
        )
        self._worker.start()

    @property
    def registry(self) -> DatabaseRegistry:
        return self._registry

    def search(
        self,
        dbnames,
        dbkeys,
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        timeout: float | None = None,  # None -> the searcher's default
    ) -> SearchResult:
        """Blocking search; may share a device pass with concurrent callers."""
        if timeout is None:
            timeout = self._result_timeout_s
        item = _Pending(
            dbnames=tuple(dbnames),
            dbkeys=tuple(dbkeys),
            query=np.asarray(query, dtype=np.uint32),
            k=int(k),
            cutoff=float(cutoff),
            similarity=similarity,
            alpha=float(alpha),
            beta=float(beta),
        )
        self._queue.put(item)
        return item.future.result(timeout=timeout)

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=5)
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------- internals

    def _drain_batch(self) -> list[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        import time

        deadline = time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._drain_batch()
            if not batch:
                continue
            groups: dict[tuple, list[_Pending]] = {}
            for item in batch:
                groups.setdefault(item.group_key(), []).append(item)
            for key, items in groups.items():
                try:
                    self._pool.submit(self._run_group, key, items)
                except RuntimeError:
                    # pool already shut down (close() raced a slow drain):
                    # run inline so no caller's future hangs for its full
                    # result() timeout
                    self._run_group(key, items)
        # resolve anything still queued at shutdown instead of leaving the
        # callers blocked in future.result()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("server shutting down")
                )

    def _run_group(self, key, items):
        dbnames, dbkeys, similarity, alpha, beta = key
        try:
            queries = np.stack([it.query for it in items])
            results = self._registry.search_databases_batch(
                dbnames,
                dbkeys,
                queries,
                ks=[it.k for it in items],
                cutoffs=[it.cutoff for it in items],
                similarity=similarity,
                alpha=alpha,
                beta=beta,
            )
            for it, r in zip(items, results):
                it.future.set_result(r)
        except Exception as e:  # deliver the failure to every caller
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
