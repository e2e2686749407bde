"""FingerprintDB — the core similarity-search engine.

The JAX rebuild of the reference's ``FingerprintDB``
(``fingerprintdb_cuda.h:53-147``, ``fingerprintdb_cuda.cu:106-399``). Same
capability surface — cutoff-filtered Tanimoto (plus Tversky) top-k search,
fingerprint folding with exact re-scoring, approximate-match counts, dbkey
gating, fingerprint retrieval — but one SPMD program over a device mesh
instead of per-GPU storage blocks, host threads, and a mutex-guarded merge.

Differences from the reference, by design:

* Queries are **batched**: any number of concurrent queries become one
  ``(B, W)`` scan (the reference serializes searches behind a global mutex,
  ``gpusim_server.py:31-32``).
* Top-k selection is an exact segmented reduction on device, not a full sort.
* Per-row popcounts are precomputed at load.
* Folded-scan candidates are re-scored exactly on the host from the
  full-width matrix (the reference does the same on CPU,
  ``fingerprintdb_cuda.cu:307-331``, but requires the whole matrix in
  RAM — its benchmark boxes carry 256 GB). Here the rescore source can be
  a ``.tfsim`` memory map: ``packed_words()`` is a zero-copy view of the
  mapped file, the word-level fold streams it once, and the per-candidate
  rescore touches only the selected rows' pages — so fold-N search works
  over libraries larger than host RAM. (An on-device gather rescore would
  only help when the *unfolded* matrix is device-resident, which
  contradicts folding's purpose of fitting in HBM; deliberately not
  built.)
"""

from __future__ import annotations

import os
import threading
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..ops import fold as fold_ops
from ..ops.scan import TANIMOTO, popcount_rows_np, scores_np
from ..parallel import sharded
from ..parallel.mesh import SHARD_AXIS, auto_fold_factor, make_mesh
from ..utils.fsim import FingerprintData
from .results import SearchResult

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _batch_bucket(b: int) -> int:
    for bucket in _BATCH_BUCKETS:
        if b <= bucket:
            return bucket
    return -(-b // _BATCH_BUCKETS[-1]) * _BATCH_BUCKETS[-1]


def _k_bucket(k_fetch: int, count: int) -> int:
    """Round the candidate fetch width up to a power of two with a floor of
    128 (capped at the row count) so every ``return_count`` a client picks
    maps onto a handful of compiled programs instead of one XLA program per
    novel k. Fetching 128 candidates is free next to the scan itself."""
    bucket = max(128, 1 << (max(k_fetch, 1) - 1).bit_length())
    return min(bucket, count)


class FingerprintDB:
    """One fingerprint library resident on the device mesh."""

    def __init__(
        self,
        data: FingerprintData,
        mesh=None,
        fold_factor: int | str = 1,
        chunk_cols: int | None = None,
        keep_full_on_host: bool = True,
        scan_mode: str = "dense",
        use_pallas: bool | None = None,
        defer_upload: bool = False,
        popless: bool = False,
        interpret: bool = False,
    ):
        """``scan_mode``: ``"dense"`` scans every packed word per query (the
        word-planar kernel); ``"bitplane"`` stores the library bit-transposed
        and reads only the query's set-bit planes — lower single-query
        latency for sparse fingerprints like Morgan (see ``ops/bitplane.py``);
        dense batches better. The bitplane phase 1 runs as the GPU kernel
        of ``ops/triton_bitplane.py`` on a GPU mesh and as XLA elsewhere;
        ``use_pallas`` overrides that choice (tests, and timing the XLA
        path for comparison), and ``interpret`` runs the kernel through the
        Pallas interpreter (tests on the CPU).

        ``popless=True`` (dense, single-process) stores NO per-column
        popcount array on the device; the scan recomputes column pops from
        the planes it reads — 2 B/row of device memory back.

        ``defer_upload=True`` records metadata only; the caller then runs
        :meth:`start_precompile` (AOT compiles from geometry) concurrently
        with :meth:`upload` (the heavy read/fold/transfer) — the startup-
        overlap path used by :meth:`DatabaseRegistry.from_fsim_files`.
        Single-process only: multi-host compiles must run in lockstep."""
        data.validate()
        if scan_mode not in ("dense", "bitplane"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if use_pallas and scan_mode != "bitplane":
            raise ValueError("the Pallas kernel is a bitplane phase 1")
        if popless and scan_mode != "dense":
            raise ValueError(
                "popless stores are dense-only: the bitplane score needs "
                "stored popcounts (a query reads only its set-bit planes, "
                "so column totals cannot be recomputed on the fly)"
            )
        self.scan_mode = scan_mode
        self.interpret = interpret
        self.popless = popless
        self.dbkey = data.dbkey
        self.bitcount = data.bitcount
        self.generator = data.generator  # provenance tag ("" = unknown)
        self._smiles = data.smiles
        self._ids = data.ids
        # captured up front: in multi-host mode the string tables may be
        # host-sharded to this process's span, so len(self._ids) would
        # undercount and _assemble would silently drop other hosts' rows
        self._count = data.count
        full = data.packed_words()
        self._full_words = full if keep_full_on_host else None
        self.word_count = full.shape[1]
        self._chunk_cols = chunk_cols
        self._data = data

        if fold_factor == "auto":
            fold_factor = auto_fold_factor(full.nbytes)
        fold_factor = fold_ops.round_fold_factor(self.word_count, int(fold_factor))
        self.fold_factor = fold_factor
        if fold_factor > 1 and self._full_words is None:
            raise ValueError(
                "folded search needs a full-width rescore source; keep "
                "keep_full_on_host=True (free for .tfsim-mapped data: the "
                "'host copy' is a zero-copy view of the memory-mapped file)"
            )

        self._mesh = mesh if mesh is not None else make_mesh()
        if use_pallas is None:
            use_pallas = scan_mode == "bitplane" and (
                self._mesh.devices.flat[0].platform == "gpu"
            )
        self.use_pallas = use_pallas
        import jax

        self._multihost = jax.process_count() > 1
        if self._multihost:
            # the per-process feed builds popcounts with the planar slabs;
            # popless is a single-process memory squeeze, not a multi-host
            # need
            self.popless = False
        # fp bytes this process actually read to build the device store —
        # multi-host tests assert no process materializes the full library
        self.loaded_fp_bytes: int | None = None
        self._store = None
        # serving gate: set once the library is device-resident; a search
        # arriving while a deferred upload is still streaming waits here
        self._ready = threading.Event()
        self._prewarm_thread: threading.Thread | None = None
        self._precompile_thread: threading.Thread | None = None
        self._search_fns: dict = {}
        # fold>1 determinism pins: exact k-fetch key -> the larger compiled
        # bucket it was promoted to; consulted BEFORE _search_fns so a later
        # warmup() compiling the exact bucket cannot flip served result sets
        self._pinned_keys: dict = {}
        # THREAD-LOCAL: warmup bypasses promotion only on its own thread. A
        # process-global flag let live requests racing a concurrent warmup
        # take the exact-bucket path and return a different fold>1 result
        # set than the same query before/after the warmup window
        self._warming = threading.local()
        # k-bucket promotion support: keys whose exact program is being
        # compiled off the request path (single-process only)
        self._bg_keys: set = set()
        self._bg_pool = None
        # the batching front end dispatches request groups on a thread
        # pool: per-key locks stop two threads from racing the same
        # multi-minute XLA compile, while different shapes still compile
        # concurrently
        self._fn_locks_guard = threading.Lock()
        self._fn_locks: dict = {}
        # distinct compiled search programs (bucketed batch x bucketed k x
        # similarity x plane bucket); /stats exposes the registry-wide sum
        self.compile_count = 0
        # multi-host uploads cannot defer: every process must device_put in
        # lockstep, and stray background compiles would desync the peers
        if not defer_upload or self._multihost:
            self.upload()

    # ---------------------------------------------------------------- loading

    def upload(self, async_prewarm: bool = False) -> None:
        """Read/fold/transpose the library and upload it to the device mesh.

        Runs inline from ``__init__`` unless ``defer_upload=True`` was
        passed. ``async_prewarm=True`` runs the post-upload mmap page
        prewarm on a background thread (join with :meth:`join_prewarm`) —
        the server overlaps it with warmup executions; only the first few
        live queries see cold rescore pages.
        """
        if self._ready.is_set():
            return
        data = self._data
        full = data.packed_words()
        import logging

        log = logging.getLogger("gpusimilarity_jax")
        from ..utils import synth

        virtual = isinstance(full, synth.VirtualWords)
        if self._multihost:
            # per-process feed: each host reads/folds/transposes ONLY the
            # rows its local devices own, straight from the (typically
            # memory-mapped) full matrix — or, for a synthetic library,
            # generates only its span (VirtualWords slicing)
            if self.scan_mode == "bitplane":
                self._store, self.loaded_fp_bytes = (
                    sharded.build_bitplane_store_multihost(
                        full,
                        mesh=self._mesh,
                        chunk_cols=self._chunk_cols
                        or sharded.BITPLANE_CHUNK_COLS,
                        fold_factor=self.fold_factor,
                    )
                )
            else:
                self._store, self.loaded_fp_bytes = (
                    sharded.build_store_multihost(
                        full,
                        mesh=self._mesh,
                        chunk_cols=self._chunk_cols
                        or sharded.DEFAULT_CHUNK_COLS,
                        fold_factor=self.fold_factor,
                    )
                )
            self._shard_host_strings(data)
        elif virtual and self.scan_mode == "dense":
            # synthetic library: generate the folded planes DIRECTLY on the
            # device (one SPMD pass over the mixer) — no host
            # materialization, no multi-GB host-to-device transfer
            self._store = synth.build_virtual_dense_store(
                self._count,
                self.fold_factor,
                mesh=self._mesh,
                word_count=self.word_count,
                seed=full.seed,
                popless=self.popless,
                chunk_cols=self._chunk_cols or sharded.DEFAULT_CHUNK_COLS,
            )
        elif virtual:
            n_aligned = synth.aligned_virtual_rows(
                self._count, self._mesh.shape[SHARD_AXIS]
            )
            if n_aligned != self._count:
                raise ValueError(
                    "synthetic bitplane store needs an aligned row count "
                    f"(use synth.aligned_virtual_rows: {n_aligned}), or "
                    "serve dense"
                )
            self._store = synth.build_virtual_bitplane_store(
                self._count,
                self.fold_factor,
                mesh=self._mesh,
                word_count=self.word_count,
                seed=full.seed,
            )
        elif self.scan_mode == "bitplane":
            device_rows = fold_ops.fold_words(full, self.fold_factor)
            self._store = sharded.build_bitplane_store(
                device_rows,
                mesh=self._mesh,
                chunk_cols=self._chunk_cols or sharded.BITPLANE_CHUNK_COLS,
            )
        else:
            # fold-on-the-fly slab streaming: the full-width mmap is read
            # once and the folded intermediate is never materialized whole
            self._store = sharded.build_store(
                full,
                mesh=self._mesh,
                chunk_cols=self._chunk_cols or sharded.DEFAULT_CHUNK_COLS,
                fold_factor=self.fold_factor,
                popless=self.popless,
            )
        from ..utils.strings import mmap_backing

        # gate on the base-chain walk, not isinstance: load paths hand the
        # engine VIEWS of the mapped file (slices, dtype views), which
        # downcast np.memmap to ndarray — a bare isinstance would silently
        # skip the prewarm and reintroduce 2-3 s/query cold-fault rescans.
        # String blobs prewarm even when the fingerprints are NOT a map
        # (synthetic source): every result row still faults an id + smiles
        # page, and at 1B rows the strided blobs are tens of GiB.
        needs_prewarm = (
            self.fold_factor > 1
            and mmap_backing(data.fingerprints) is not None
        ) or any(
            mmap_backing(getattr(t, "_blob", None)) is not None
            for t in (self._smiles, self._ids)
        )
        if needs_prewarm:
            # folded + memory-mapped: the exact rescore will fault this
            # file's pages at serve time — heal the cache the upload
            # pass just partially evicted (see _prewarm_rescore_pages)
            if async_prewarm:
                self._prewarm_thread = threading.Thread(
                    target=self._prewarm_rescore_pages,
                    name="jaxsim-prewarm",
                    daemon=True,
                )
                self._ready.set()  # serve while pages warm in the background
                self._prewarm_thread.start()
            else:
                self._prewarm_rescore_pages()
        else:
            log.info("rescore prewarm not needed (unfolded or RAM-backed)")
        self._ready.set()

    def join_prewarm(self) -> None:
        """Block until the background rescore-page prewarm finishes."""
        t = self._prewarm_thread
        if t is not None:
            t.join()

    def _prewarm_rescore_pages(self) -> None:
        """Re-touch the memory-mapped full-width matrix after a folded
        upload.

        The fold+transpose+upload pass allocates ~2x the folded size of
        transient host RAM, evicting a slice of the just-read file from the
        page cache — after which every folded search pays thousands of
        COLD random page faults in its exact rescore (measured 2-3 s/query
        vs 150 ms warm at 768M rows). One sequential page-granular touch
        heals the cache; only worth it (and only done) when the whole file
        can stay resident.
        """
        import time

        import logging

        from ..utils.strings import mmap_backing as _mm

        log = logging.getLogger("gpusimilarity_jax")
        # only an mmap-backed matrix gets its pages touched: a synthetic
        # (VirtualWords) source has no pages — "touching" it would burn CPU
        # regenerating rows for nothing
        fp = self._full_words if (
            self._full_words is not None and _mm(self._full_words) is not None
        ) else None
        total = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal"):
                        total = int(line.split()[1]) * 1024
                        break
        except (ValueError, OSError):
            log.info("rescore prewarm skipped (no /proc/meminfo)")
            return
        # distinct string blobs (smiles/ids may hardlink to ONE file —
        # synthetic scale libraries do — so dedupe by inode, not by path)
        blobs = {}
        for table in (self._smiles, self._ids):
            mm = _mm(getattr(table, "_blob", None))
            if mm is None or not mm.size:
                continue
            try:
                st = os.stat(mm.filename)
                blobs[(st.st_dev, st.st_ino)] = mm
            except (OSError, TypeError):
                blobs[id(mm)] = mm
        row_bytes = fp.shape[1] * 4 if fp is not None else 0
        fp_bytes = fp.shape[0] * row_bytes if fp is not None else 0
        nbytes = fp_bytes + sum(m.size for m in blobs.values())
        if nbytes == 0:
            log.info("rescore prewarm not needed (no memory-mapped assets)")
            return
        # gate on TOTAL ram, not MemAvailable: at this point the fold's
        # transient buffers (~2x folded size) are still allocated and make
        # MemAvailable lie about the serve-time picture, where the maps are
        # the only big residents
        if total is None or nbytes > total * 0.85:
            # cannot stay resident; a warm pass would just thrash
            log.info(
                "rescore prewarm skipped (%d GiB of maps exceeds 85%% of RAM)",
                nbytes >> 30,
            )
            return
        t0 = time.monotonic()
        if fp is not None:
            rows_per_page = max(1, 4096 // row_bytes)
            step = max(1, (64 << 20) // row_bytes)  # 64 MB of rows per slab
            for lo in range(0, fp.shape[0], step):
                hi = min(lo + step, fp.shape[0])
                # one element per page, in sequential order: the kernel's
                # readahead turns this into near-sequential streaming
                fp[lo:hi:rows_per_page, 0].max()
        # string blobs too: every result row faults an id + smiles page,
        # and at 768M rows the blobs are ~10 GiB — hundreds of cold faults
        # per query until healed (measured ~0.9 s/query of fault time)
        for mm in blobs.values():
            flat = mm.reshape(-1).view(np.uint8)
            for lo in range(0, flat.size, 64 << 20):
                hi = min(lo + (64 << 20), flat.size)
                flat[lo:hi:4096].max()
        log.info(
            "prewarmed %d GiB of rescore pages in %.1fs",
            nbytes >> 30, time.monotonic() - t0,
        )

    def _shard_host_strings(self, data: FingerprintData) -> None:
        """Multi-host string policy (SURVEY §5 distributed entry).

        Memory-mapped tables (``.tfsim``) stay whole on every host — the
        documented full-mmap-per-host mode: the blob lives in the shared
        page cache and a lookup touches one page, so there is nothing to
        shard. RAM-backed tables (``.fsim`` loads, plain lists) are sliced
        to this process's global row span (:class:`multihost.HostStrings`);
        result assembly then resolves non-owned rows with a cross-host
        collective (``multihost.resolve_strings_many``).
        """
        from ..parallel import multihost

        lo, hi = multihost.process_row_span(self._mesh, self._store.n_padded)
        n = data.count
        for attr in ("_smiles", "_ids"):
            table = getattr(self, attr)
            if multihost.needs_host_sharding(table):
                local = [bytes(s) for s in table[lo : min(hi, n)]]
                setattr(self, attr, multihost.HostStrings(local, lo, hi))

    def _lookup_strings_batch(self, idx_lists):
        """Resolve smiles+ids for many result index arrays at once.

        Host-sharded tables (multi-host serving) cost cross-host
        collectives; gathering every query's smiles AND ids in a single
        :func:`multihost.resolve_strings_many` call pays 2 collectives per
        search batch instead of 2 per query per field. Local tables
        resolve directly. Returns ``(smiles_lists, ids_lists)``.
        """
        from ..parallel import multihost

        out = [[None] * len(idx_lists), [None] * len(idx_lists)]
        plans, pairs = [], []
        for fi, table in enumerate((self._smiles, self._ids)):
            if isinstance(table, multihost.HostStrings):
                for li, idx in enumerate(idx_lists):
                    plans.append((fi, li))
                    pairs.append((table, idx))
            else:
                for li, idx in enumerate(idx_lists):
                    out[fi][li] = [table[int(i)] for i in idx]
        if pairs:
            for (fi, li), raw in zip(
                plans, multihost.resolve_strings_many(pairs)
            ):
                out[fi][li] = raw
        return tuple(
            [[s.decode("utf-8", "replace") for s in raw] for raw in field]
            for field in out
        )

    # ------------------------------------------------------------------ info

    @property
    def count(self) -> int:
        return self._count

    @property
    def device_bitcount(self) -> int:
        return self.bitcount // self.fold_factor

    def get_fingerprint(self, index: int) -> np.ndarray:
        """Full-width packed words of row ``index`` (reference
        ``FingerprintDB::getFingerprint``, ``fingerprintdb_cuda.cu:212-226``)."""
        if self._full_words is None:
            raise ValueError("full-width matrix not retained on host")
        return np.array(self._full_words[index])

    def get_smiles(self, index: int) -> str:
        return self._smiles[index].decode("utf-8", "replace")

    def get_id(self, index: int) -> str:
        return self._ids[index].decode("utf-8", "replace")

    # ---------------------------------------------------------------- search

    def _get_search_fn(
        self, k_fetch: int, batch: int, similarity: str, plane_bucket: int = 0
    ):
        key = (k_fetch, batch, similarity, plane_bucket)
        fn = self._search_fns.get(key)
        if fn is not None:
            return fn
        with self._fn_locks_guard:
            lock = self._fn_locks.setdefault(key, threading.Lock())
        with lock:
            fn = self._search_fns.get(key)
            if fn is None:
                # pre-upload (AOT precompile) the store is geometry-only:
                # the builder lowers+compiles from shapes and the returned
                # callable late-binds the live arrays via the store_ref
                store = self._store if self._store is not None else (
                    self._geometry_store()
                )
                if self.scan_mode == "bitplane":
                    fn = sharded.build_bitplane_search_fn(
                        store, k_fetch, similarity, batch, plane_bucket,
                        use_pallas=self.use_pallas,
                        store_ref=lambda: self._store,
                        interpret=self.interpret,
                    )
                else:
                    fn = sharded.build_search_fn(
                        store, k_fetch, similarity, batch,
                        store_ref=lambda: self._store,
                    )
                self._search_fns[key] = fn
                with self._fn_locks_guard:
                    self.compile_count += 1
        return fn

    def _geometry_store(self):
        """Shape-only store with the exact layout :meth:`upload` will build
        (shared planning code) — the AOT precompile target."""
        wf = self.word_count // self.fold_factor
        if self.scan_mode == "bitplane":
            return sharded.shape_only_bitplane_store(
                self._count, wf, mesh=self._mesh,
                chunk_cols=self._chunk_cols or sharded.BITPLANE_CHUNK_COLS,
            )
        return sharded.shape_only_store(
            self._count, wf, mesh=self._mesh,
            chunk_cols=self._chunk_cols or sharded.DEFAULT_CHUNK_COLS,
            popless=self.popless,
        )

    def precompile(
        self, ks: Sequence[int] = (20, 128), max_batch: int = 1,
        similarity: str = TANIMOTO,
    ) -> None:
        """AOT-compile the warmup search shapes from geometry alone.

        Safe to run BEFORE (or concurrently with) :meth:`upload`: programs
        are lowered against a shape-only store and late-bind the device
        arrays at call time, letting a server overlap its multi-minute
        XLA compiles with the library load/upload
        instead of paying them back to back. Compiles the same key set
        :meth:`warmup` would execute.
        """
        if self.count == 0:
            return
        batches = [1]
        for bucket in _BATCH_BUCKETS[1:]:
            if bucket <= max_batch:
                batches.append(bucket)
        if self.scan_mode == "bitplane":
            from ..ops.bitplane import plane_bucket_for

            w = self.device_bitcount
            buckets = set()
            for q in self._warmup_queries():
                folded = fold_ops.fold_words(q[None, :], self.fold_factor)
                buckets.add(
                    plane_bucket_for(int(popcount_rows_np(folded)[0]), w)
                )
        else:
            buckets = {0}
        keys = []
        for k in ks:
            k_eff = min(int(k), self.count)
            k_fetch = _k_bucket(
                fold_ops.overfetch_count(k_eff, self.fold_factor), self.count
            )
            for b in batches:
                for pb in sorted(buckets):
                    key = (k_fetch, b, similarity, pb)
                    if key not in keys:
                        keys.append(key)
        # compile CONCURRENTLY: XLA compiles release the GIL, so a small
        # pool overlaps them (per-key locks make _get_search_fn safe; the
        # serve path already live-compiles on up to 4 request threads at
        # once), and warmup gates /healthz.
        def compile_one(t):
            # one bad geometry must not abandon the rest of the warmup
            # set — that program's traffic falls back to a live compile
            # (or k-bucket promotion) instead
            try:
                self._get_search_fn(*t)
            except Exception:
                import logging

                logging.getLogger("gpusimilarity_jax").exception(
                    "AOT compile failed for %s; its traffic pays a live "
                    "compile", t,
                )

        if len(keys) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                min(4, len(keys)), thread_name_prefix="jaxsim-aot"
            ) as pool:
                list(pool.map(compile_one, keys))
        else:
            for t in keys:
                compile_one(t)

    def start_precompile(
        self, ks: Sequence[int] = (20, 128), max_batch: int = 1
    ) -> None:
        """Run :meth:`precompile` on a background thread (idempotent)."""
        if self._precompile_thread is not None or self._multihost:
            return

        def task():
            import logging
            import time

            t0 = time.monotonic()
            # snapshot: compile_count counts every compile in the process
            # lifetime (live request threads race this warmup), so log the
            # DELTA this precompile pass actually added (r4 advisor)
            before = self.compile_count
            try:
                self.precompile(ks=tuple(ks), max_batch=max_batch)
                logging.getLogger("gpusimilarity_jax").info(
                    "AOT-precompiled %d search programs in %.1fs",
                    self.compile_count - before, time.monotonic() - t0,
                )
            except Exception:
                logging.getLogger("gpusimilarity_jax").exception(
                    "AOT precompile failed; first queries pay live compiles"
                )

        self._precompile_thread = threading.Thread(
            target=task, name="jaxsim-precompile", daemon=True
        )
        self._precompile_thread.start()

    def join_precompile(self) -> None:
        """Block until a background :meth:`start_precompile` finishes."""
        t = self._precompile_thread
        if t is not None:
            t.join()

    def _get_search_fn_serving(
        self, k_fetch: int, batch: int, similarity: str, plane_bucket: int = 0
    ):
        """Serve-path program lookup with **k-bucket promotion**.

        A request whose exact ``k_fetch`` bucket is uncompiled would
        otherwise stall behind a live XLA compile (the 503 window warmup
        exists to close, recurring on the k axis). If a LARGER fetch bucket with the same batch/similarity/
        plane key is already compiled, serve with that instead: fetching
        more candidates only widens the exact selection, ``_assemble``
        trims to the caller's ``k``, and the cutoff count is independent
        of ``k_fetch``.

        At ``fold_factor == 1`` the two-phase selection is exact, so the
        promoted bucket returns results IDENTICAL to the exact one, and
        the exact program is compiled in the background (``missing_key``)
        to take over. At ``fold_factor > 1`` a larger over-fetch can
        RECOVER rows the exact bucket's heuristic over-fetch would miss —
        better, but not identical — so the engine PINS the promoted
        bucket instead of background-compiling the exact one: switching
        programs mid-lifetime would make the same query return different
        result sets before and after the compile landed. The pin is
        recorded in ``_pinned_keys`` and consulted before the compiled-
        program map, so it survives even a later ``warmup()`` compiling
        the exact bucket (which would otherwise silently unpin it).

        Returns ``(fn, missing_key)``; ``missing_key`` is the exact key to
        compile in the background (None when the exact program ran or the
        promotion is pinned). Warmup bypasses promotion so its ``ks``
        actually compile.
        """
        key = (k_fetch, batch, similarity, plane_bucket)
        if getattr(self._warming, "flag", False):
            return self._get_search_fn(*key), None
        if self.fold_factor > 1:
            pinned = self._pinned_keys.get(key)
            if pinned is not None:
                return self._search_fns[pinned], None
        if key in self._search_fns:
            return self._get_search_fn(*key), None
        larger = [
            kf
            for (kf, b2, s2, pb2) in list(self._search_fns)
            if b2 == batch and s2 == similarity and pb2 == plane_bucket
            and kf > k_fetch
        ]
        if not larger:
            return self._get_search_fn(*key), None
        promoted = (min(larger), batch, similarity, plane_bucket)
        fn = self._search_fns[promoted]
        if self.fold_factor > 1:
            self._pinned_keys[key] = promoted
            return fn, None
        return fn, key

    def _compile_in_background(self, key, args) -> None:
        """Compile+execute the exact k-bucket program off the request path.

        Single-process only: in multi-host serving every device program
        must execute in broadcast lockstep, so a stray background
        execution would desync the peers — there, promotion simply keeps
        serving with the larger warmed bucket (deterministic on every
        process, since the compiled-program sets advance in lockstep).
        ``args`` are the live request's device arrays — by construction
        the exact-bucket program takes identical input shapes (only the
        internal fetch width and output shapes differ).
        """
        import jax

        if jax.process_count() > 1:
            return
        with self._fn_locks_guard:
            if key in self._bg_keys:
                return
            self._bg_keys.add(key)
            if self._bg_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._bg_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="jaxsim-bgcompile"
                )

        def task():
            import logging

            try:
                fn = self._get_search_fn(*key)
                jax.device_get(fn(*args))  # first execution triggers compile
            except Exception:
                logging.getLogger("gpusimilarity_jax").exception(
                    "background compile for %s failed; requests keep "
                    "serving via the promoted bucket", key,
                )

        self._bg_pool.submit(task)

    def drain_background_compiles(self) -> None:
        """Block until queued background compiles finish (tests/tools)."""
        with self._fn_locks_guard:
            pool = self._bg_pool
        if pool is not None:
            pool.submit(lambda: None).result()

    def _synthetic_query(self, n_set: int) -> np.ndarray:
        """Full-width packed query with exactly ``n_set`` bits, all within
        the first ``device_bitcount`` positions so word-level folding
        preserves the count — the query then lands in the plane bucket of
        ``n_set`` exactly."""
        rng = np.random.default_rng(n_set)
        n_set = max(1, min(n_set, self.device_bitcount))
        bits = np.zeros(self.bitcount, np.uint8)
        bits[rng.choice(self.device_bitcount, n_set, replace=False)] = 1
        return np.packbits(bits, bitorder="little").view(np.uint32)

    def _warmup_queries(self) -> list[np.ndarray]:
        """One query per plane bucket live traffic is likely to hit.

        Warming only library row 0's bucket would leave a live query one
        ``PLANE_BUCKETS`` boundary denser to a fresh compile (the 503 path
        warmup exists to close). Sample the
        library's folded row-popcount distribution and cover the buckets
        of its p50 and p95 plus one bucket of headroom above.
        """
        if self._full_words is not None:
            base = np.array(self._full_words[0])
        else:
            base = self._synthetic_query(min(48, self.device_bitcount))
        if self.scan_mode != "bitplane":
            return [base]  # dense programs don't key on query density

        from ..ops.bitplane import PLANE_BUCKETS, plane_bucket_for

        sample_n = min(self.count, 4096)
        if self._full_words is not None:
            stride = max(1, self.count // sample_n)
            rows = np.asarray(self._full_words[:: stride][:sample_n])
            pops = popcount_rows_np(fold_ops.fold_words(rows, self.fold_factor))
        else:
            pops = np.asarray([48])
        w = self.device_bitcount
        targets = {
            plane_bucket_for(int(np.percentile(pops, 50)), w),
            plane_bucket_for(int(np.percentile(pops, 95)), w),
        }
        # one bucket of headroom above the densest observed
        top = max(targets)
        nxt = next((p for p in PLANE_BUCKETS if p > top), None)
        if nxt is not None and nxt <= w:
            targets.add(nxt)
        base_bucket = plane_bucket_for(
            int(popcount_rows_np(
                fold_ops.fold_words(base[None, :], self.fold_factor)
            )[0]), w,
        )
        queries = [base]
        for bucket in sorted(targets - {base_bucket}):
            queries.append(self._synthetic_query(bucket))
        return queries

    def warmup(
        self, ks: Sequence[int] = (20, 128), max_batch: int = 1
    ) -> None:
        """Precompile the common search shapes.

        Without this the first real query after startup eats the XLA
        compile (the HTTP layer's
        503-until-ready is a stopgap, not a fix). Covers every plane
        bucket in the library's observed query-density range (see
        ``_warmup_queries``), not just row 0's. The ``ks`` need not
        enumerate every k-fetch bucket: serving **promotes** a request
        whose exact bucket is uncompiled to the next-larger warmed bucket
        (identical results at fold 1; pinned for determinism at fold > 1,
        see ``_get_search_fn_serving``), at fold 1 compiling the exact
        program in the background — so warming the largest
        expected ``k`` (default 128) makes every smaller k compile-free.
        Only a k beyond the warmed maximum still pays a live compile.
        ``max_batch``: also compile every batch bucket up to it — the
        batching front end coalesces concurrent requests into groups, so
        single-query warmup alone would leave the first traffic burst
        paying a live compile (the server passes its ``--max_batch``).
        """
        if self.count == 0:
            return
        # a background AOT precompile (startup overlap) covers the same key
        # set — wait for it so the executions below run compile-free and so
        # both threads never race the same per-key lock for minutes
        self.join_precompile()
        batches = [1]
        for bucket in _BATCH_BUCKETS[1:]:
            if bucket <= max_batch:
                batches.append(bucket)
        # thread-local: only THIS thread's searches compile exact buckets;
        # live requests racing the warmup keep their promotion pins
        self._warming.flag = True
        try:
            for query in self._warmup_queries():
                for b in batches:
                    for k in ks:
                        self.search_batch(
                            np.tile(query, (b, 1)), k=min(int(k), self.count),
                            dbkey=self.dbkey,
                        )
        finally:
            self._warming.flag = False

    def search(
        self,
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        dbkey: str = "",
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        return_indices: bool = False,
    ) -> SearchResult:
        """Search one full-width packed query; returns the top ``min(k, matches)``.

        A dbkey mismatch yields an empty result, matching the reference's
        key gate (``fingerprintdb_cuda.cu:349-352``).
        """
        [result] = self.search_batch(
            query[None, :], k, cutoff, dbkey, similarity, alpha, beta,
            return_indices=return_indices,
        )
        return result

    def search_batch(
        self,
        queries: np.ndarray,
        k: int | Sequence[int] = 20,
        cutoff: float | Sequence[float] = 0.0,
        dbkey: str = "",
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        return_indices: bool = False,
    ) -> list[SearchResult]:
        """Search a ``(B, W)`` batch of packed queries in one device pass.

        ``k`` and ``cutoff`` may be scalars or per-query sequences — the
        batching HTTP front end coalesces heterogeneous concurrent requests
        into one scan.
        """
        queries = np.asarray(queries, dtype=np.uint32)
        if queries.ndim != 2 or queries.shape[1] != self.word_count:
            raise ValueError(
                f"queries must be (B, {self.word_count}) packed uint32 words"
            )
        b = queries.shape[0]
        ks = np.broadcast_to(np.asarray(k, dtype=np.int64), (b,))
        cutoffs = np.broadcast_to(np.asarray(cutoff, dtype=np.float32), (b,))
        if dbkey != self.dbkey:
            return [SearchResult() for _ in range(b)]
        if self.count == 0:
            return [SearchResult() for _ in range(b)]
        # deferred-upload startup: block until the library is device-resident
        self._ready.wait()

        ks = np.minimum(ks, self.count)
        fn, call_args, missing_key = self.device_call(
            queries, int(ks.max()), cutoffs, similarity, alpha, beta
        )
        vals, idx, approx = fn(*call_args)
        if missing_key is not None:
            # served via a promoted (larger) fetch bucket: compile the
            # exact program off the request path for subsequent traffic
            self._compile_in_background(missing_key, call_args)
        # one device->host gather for all three outputs: separate
        # np.asarray calls would each wait for their own transfer
        import jax

        vals, idx, approx = jax.device_get((vals, idx, approx))
        # approx arrives as per-shard int32 counts (S, B): sum in int64
        approx = approx.astype(np.int64).sum(axis=0)
        vals, idx, approx = vals[:b], idx[:b], approx[:b]

        selected = []
        for qi in range(b):
            selected.append(
                self._assemble(
                    queries[qi], vals[qi], idx[qi], int(approx[qi]), int(ks[qi]),
                    float(cutoffs[qi]), similarity, alpha, beta,
                )
            )
        # resolve smiles+ids for the WHOLE batch at once: under multi-host
        # serving this is one cross-host collective instead of 2 per query
        smiles_b, ids_b = self._lookup_strings_batch([s[1] for s in selected])
        results = []
        for qi, (svals, sidx, sapprox) in enumerate(selected):
            result = SearchResult(
                smiles=smiles_b[qi],
                ids=ids_b[qi],
                scores=[float(v) for v in svals],
                approximate_count=sapprox,
            )
            if return_indices:
                result.indices = sidx.tolist()
            results.append(result)
        return results

    def device_call(
        self, queries, k_max, cutoffs, similarity=TANIMOTO, alpha=1.0,
        beta=1.0,
    ):
        """The device half of :meth:`search_batch`: ``(fn, args,
        missing_key)`` where ``fn(*args)`` runs the compiled scan over the
        padded, folded ``(B, W)`` batch (timing tools call it alone).
        ``missing_key`` is an exact-bucket program to compile in the
        background (see :meth:`_get_search_fn_serving`)."""
        b = queries.shape[0]
        k_fetch = _k_bucket(
            fold_ops.overfetch_count(k_max, self.fold_factor), self.count
        )
        bucket = _batch_bucket(b)
        padded = np.zeros((bucket, self.word_count), dtype=np.uint32)
        padded[:b] = queries
        cut_padded = np.zeros(bucket, dtype=np.float32)
        cut_padded[:b] = cutoffs
        folded_q = fold_ops.fold_words(padded, self.fold_factor)
        folded_pops = popcount_rows_np(folded_q)

        if self.scan_mode == "bitplane":
            from ..ops.bitplane import query_plane_indices

            plane_idx, plane_bucket = query_plane_indices(
                folded_q, self.device_bitcount
            )
            fn, missing_key = self._get_search_fn_serving(
                k_fetch, bucket, similarity, plane_bucket
            )
            query_arg = jnp.asarray(plane_idx)
        else:
            fn, missing_key = self._get_search_fn_serving(
                k_fetch, bucket, similarity
            )
            query_arg = jnp.asarray(folded_q)
        call_args = (
            query_arg,
            jnp.asarray(folded_pops),
            jnp.asarray(cut_padded),
            jnp.float32(alpha),
            jnp.float32(beta),
        )
        return fn, call_args, missing_key

    def _assemble(
        self, query, vals, idx, approx, k, cutoff, similarity, alpha, beta,
    ) -> tuple:
        finite = vals > -np.inf
        vals, idx = vals[finite], idx[finite]
        in_range = (idx >= 0) & (idx < self.count)
        vals, idx = vals[in_range], idx[in_range]

        if self.fold_factor > 1:
            # exact re-score of folded-scan candidates with full-width data,
            # then cutoff re-check + re-sort (reference :307-331).
            # Candidates arrive score-ordered; visiting the mmap in INDEX
            # order instead turns thousands of random page faults into a
            # seek-ordered sweep (measured seconds vs sub-second at 768M
            # rows when the file exceeds the page cache). The final lexsort
            # re-orders by score anyway.
            o = np.argsort(idx)
            idx, vals = idx[o], vals[o]
            from ..utils import synth

            if isinstance(self._full_words, synth.VirtualWords):
                # synthetic source: candidates are recomputed from the
                # mixer (native when built) — no host matrix exists
                vals = self._full_words.rescore(
                    idx, query, similarity, alpha, beta
                )
            else:
                try:
                    from ..utils import native

                    vals = native.rescore(
                        self._full_words, idx, query, alpha, beta,
                        tversky=similarity != TANIMOTO,
                    )
                except ImportError:
                    vals = scores_np(
                        self._full_words[idx], query[None, :], similarity,
                        alpha, beta,
                    )[0]

        if cutoff > 0:
            keep = vals >= cutoff
            vals, idx = vals[keep], idx[keep]
        order = np.lexsort((idx, -vals))[:k]
        vals, idx = vals[order], idx[order]
        return vals, idx, approx
