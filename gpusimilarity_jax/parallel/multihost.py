"""Multi-host (DCN) scaffolding: process init, per-host data feeding, and
host-sharded string tables.

The reference is strictly single-node (SURVEY §2a.7); its scaling story
stops at multi-GPU fan-out inside one box. The JAX design for
multiple hosts (SURVEY §5, distributed entry) is: **one JAX process per
host**, the library column-sharded over the *global* mesh exactly as over
a single host's devices (``parallel/sharded.py`` — the SPMD program is
unchanged; XLA routes the ``all_gather`` within a host and over the
network across hosts), with two host-side consequences handled here:

* each process feeds only the rows its local devices own
  (:func:`distribute_rows` via ``jax.make_array_from_process_local_data``)
  — no host ever materializes the whole library;
* SMILES/ID string tables are sharded per host by global row span
  (:class:`HostStrings`): device shards own contiguous global column
  ranges, so the rows a host can resolve are exactly its local span.

Real DCN runs need real multi-host hardware; everything here is exercised
by the 2-process CPU smoke test (``tests/test_multihost.py``), which runs
the full sharded search on a Gloo-backed global mesh.
"""

from __future__ import annotations

import numpy as np

from .mesh import SHARD_AXIS


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Join the multi-process JAX runtime (``--coordinator host:port``).

    Must run before any jax device access; afterwards ``jax.devices()``
    spans every process and a mesh built from it is a global mesh.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_row_span(mesh, n_padded: int) -> tuple[int, int]:
    """Global row range [lo, hi) owned by THIS process's devices.

    Shards own contiguous column ranges in mesh-device order (the flattened
    1-D mesh), so a process's span is contiguous as long as its devices are
    contiguous in the mesh (the default ordering from ``jax.devices()``).
    """
    import jax

    devs = list(mesh.devices.reshape(-1))
    n_shards = len(devs)
    if n_padded % n_shards:
        raise ValueError(
            f"n_padded={n_padded} is not divisible by {n_shards} shards — "
            "pad rows to the shard count before computing spans"
        )
    per_shard = n_padded // n_shards
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError(
            "this process's devices are not contiguous in the mesh; "
            "order the mesh by process for contiguous string-table spans"
        )
    return (mine[0] * per_shard, (mine[-1] + 1) * per_shard)


def distribute_rows(local_planar: np.ndarray, local_pops: np.ndarray, mesh,
                    axis: str = SHARD_AXIS):
    """Form global device arrays from each process's LOCAL planar slice.

    ``local_planar`` is ``uint32 (W, n_local)`` — this process's columns
    only (its :func:`process_row_span`); ``local_pops`` is ``int32
    (n_local,)``. Returns ``(words, pops)`` global jax Arrays sharded
    ``P(None, axis)`` / ``P(axis)``, suitable for
    ``sharded.build_store_from_device`` / ``ShardedStore``.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    words = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, axis)), np.ascontiguousarray(local_planar)
    )
    pops = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(axis)), np.ascontiguousarray(local_pops)
    )
    return words, pops


def needs_host_sharding(table) -> bool:
    """True if ``table`` holds its bytes in this process's RAM (plain list
    or RAM-backed StringTable) — at multi-host scale those must be sliced
    per host. Memory-mapped tables (``.tfsim``) and constant tables are
    page-cache-backed and safe to keep in full on every host (the
    documented full-mmap-per-host mode: a lookup touches one page)."""
    from ..utils.strings import (
        ConstantStringTable,
        StridedStringTable,
        StringTable,
        mmap_backing,
    )

    if isinstance(table, ConstantStringTable):
        return False
    if isinstance(table, (StringTable, StridedStringTable)):
        # NB: table construction views the blob (ascontiguousarray /
        # reshape), which downcasts np.memmap to ndarray — walk the base
        # chain, or every .tfsim table would be misclassified as RAM
        return mmap_backing(table._blob) is None
    return True  # plain list[bytes]


def resolve_strings(table: "HostStrings", indices):
    """Cross-host string lookup: a COLLECTIVE over all processes.

    Convenience wrapper over :func:`resolve_strings_many` for a single
    (table, indices) pair; see there for the collective contract.
    """
    return resolve_strings_many([(table, indices)])[0]


def resolve_strings_many(pairs):
    """Batched cross-host string lookup: ONE collective for many requests.

    ``pairs`` is a list of ``(table, indices)`` — e.g. every query's
    (smiles, idx) and (ids, idx) of a whole search batch — flattened into
    a single lengths ``process_allgather`` plus a single byte-buffer
    ``process_allgather`` (2 collectives total instead of 2 per pair:
    each collective is a separate dispatch of pure network latency on
    the serving hot path). Returns one ``list[bytes]`` per pair.

    Every process contributes the strings it owns; rows nobody owns
    (padding indices) resolve to ``b""``. Lengths gather first, so the
    byte buffer is sized to the batch's true maximum — no truncation at
    any SMILES/ID length, and every process derives the same buffer shape
    from the replicated length table. All processes must call this in the
    same order with the same per-pair index counts — search results are
    replicated by the SPMD program, so lockstep callers see identical
    arguments by construction.
    """
    from jax.experimental import multihost_utils

    local = [
        table.get(int(gi)) for table, indices in pairs for gi in indices
    ]
    k = len(local)
    if k == 0:
        # nothing to gather anywhere: the index lists are replicated, so
        # every process skips the collectives symmetrically
        return [[] for _ in pairs]
    lens = np.array(
        [-1 if s is None else len(s) for s in local], np.int32
    )
    all_lens = multihost_utils.process_allgather(lens)  # (P, k)
    max_len = max(1, int(all_lens.max(initial=0)))  # k > 0 past the early return
    buf = np.zeros((k, max_len), np.uint8)
    for j, s in enumerate(local):
        if s:
            buf[j, : len(s)] = np.frombuffer(s, np.uint8)
    all_buf = multihost_utils.process_allgather(buf)  # (P, k, max_len)
    flat = []
    for j in range(k):
        owners = np.nonzero(all_lens[:, j] >= 0)[0]
        if owners.size == 0:
            flat.append(b"")
            continue
        p = int(owners[0])
        flat.append(all_buf[p, j, : int(all_lens[p, j])].tobytes())
    out = []
    pos = 0
    for _, indices in pairs:
        n = len(indices)
        out.append(flat[pos : pos + n])
        pos += n
    return out


class HostStrings:
    """String table for this host's global row span only.

    At 1B rows the SMILES/ID tables are tens of GB; sharding them per
    host by the span of rows the host's devices own keeps each host's
    share proportional. ``get`` returns ``None`` for rows owned by other
    hosts — the serving front end resolves those from the owning host (or
    serves from a host holding full mmap'd tables; see ``utils/tfsim``).
    """

    def __init__(self, strings, lo: int, hi: int):
        if hi - lo < len(strings):
            raise ValueError(f"span [{lo}, {hi}) smaller than {len(strings)} strings")
        self._strings = strings
        self.lo = lo
        self.hi = hi

    def __len__(self) -> int:
        return len(self._strings)

    def owns(self, global_index: int) -> bool:
        return self.lo <= global_index < self.lo + len(self._strings)

    def get(self, global_index: int):
        if not self.owns(global_index):
            return None
        return self._strings[global_index - self.lo]

    def __getitem__(self, global_index: int):
        s = self.get(int(global_index))
        if s is None:
            raise IndexError(
                f"row {global_index} is owned by another host (span "
                f"[{self.lo}, {self.lo + len(self._strings)})); use "
                "resolve_strings for cross-host lookups"
            )
        return s


_OP_SHUTDOWN = 0
_OP_SEARCH = 1
_SIM_CODES = {"tanimoto": 0, "tversky": 1}
_SIM_NAMES = {v: k for k, v in _SIM_CODES.items()}


class MultihostController:
    """Fan search requests from process 0 out to every process.

    In multi-host JAX every process must execute the same device program
    in the same order — an HTTP request arriving at process 0 alone cannot
    just run the SPMD search. Process 0 broadcasts each request's
    parameters (``broadcast_one_to_all``: fixed-shape arrays, so one
    compiled broadcast program serves every request) and then all
    processes run the identical engine call; worker processes loop in
    :meth:`serve_worker`, discarding results (only process 0 holds the
    HTTP connection; result arrays are replicated anyway). A lock
    serializes dispatch — the batching front end may race groups, but the
    broadcast order must match the workers' execution order.

    The reference has no analog (strictly single-node, SURVEY §2a.7);
    this is the DCN half of the mesh design in SURVEY §5.
    """

    def __init__(self, registry, max_batch: int = 64, max_dbs: int | None = None):
        import threading

        self.registry = registry
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._closed = False
        self._names = registry.names()
        # default the broadcast template's db slots to however many
        # databases the registry actually serves — a query can never name
        # more, so no configuration knob is needed (every process builds
        # the controller from an identical registry, so shapes agree)
        self.max_dbs = max_dbs if max_dbs is not None else max(1, len(self._names))
        widths = {registry.get(n).word_count for n in self._names}
        if len(widths) > 1:
            raise ValueError(
                f"multi-host serving needs one fingerprint width, got {widths}"
            )
        self.word_count = widths.pop() if widths else 32

    def _template(self):
        return {
            "meta": np.zeros(3, np.int32),  # op, b, sim_code
            "db_idx": np.full(self.max_dbs, -1, np.int32),
            "key_ok": np.zeros(self.max_dbs, np.int32),
            "queries": np.zeros((self.max_batch, self.word_count), np.uint32),
            "ks": np.zeros(self.max_batch, np.int32),
            "cutoffs": np.zeros(self.max_batch, np.float32),
            "ab": np.ones(2, np.float32),
        }

    @staticmethod
    def _broadcast(payload):
        from jax.experimental import multihost_utils

        out = multihost_utils.broadcast_one_to_all(payload)
        return {k: np.asarray(v) for k, v in out.items()}

    # ------------------------------------------------------------- process 0

    def dispatch_batch(
        self, dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
    ):
        """Broadcast one search and run it locally; returns per-db results."""
        b = len(queries)
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds multi-host max {self.max_batch}")
        if len(dbnames) > self.max_dbs:
            raise ValueError(f"{len(dbnames)} databases exceed max {self.max_dbs}")
        req = self._template()
        req["meta"][:] = (_OP_SEARCH, b, _SIM_CODES[similarity])
        for i, name in enumerate(dbnames):
            req["db_idx"][i] = self._names.index(name)
            req["key_ok"][i] = int(key_oks[i])
        req["queries"][:b] = queries
        req["ks"][:b] = ks
        req["cutoffs"][:b] = cutoffs
        req["ab"][:] = (alpha, beta)
        with self._lock:
            if self._closed:
                # a batcher group that was already in flight when the
                # server shut down must fail fast, not broadcast into a
                # collective no worker will ever join (which would hang
                # this thread forever and pin the process open)
                raise RuntimeError("multi-host controller is shut down")
            self._broadcast(req)
            # Execute with the values as ROUND-TRIPPED through the broadcast
            # template (float32 cutoffs/alpha/beta), not the caller's float64
            # originals: the workers can only see the template dtypes, and a
            # host-side rescore value landing on either side of the cutoff on
            # different processes would desync the resolve_strings collective
            # shapes (hang/crash every host).
            return self.registry._execute_batch(
                dbnames,
                key_oks,
                req["queries"][:b],
                [int(k) for k in req["ks"][:b]],
                [float(c) for c in req["cutoffs"][:b]],
                similarity,
                float(req["ab"][0]),
                float(req["ab"][1]),
            )

    def shutdown(self):
        req = self._template()
        req["meta"][0] = _OP_SHUTDOWN
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._broadcast(req)

    # ------------------------------------------------------------- workers

    def serve_worker(self):
        """Worker-process loop: execute broadcast requests until shutdown.

        A failing request (novel-shape compile error, device OOM) must not
        kill the loop: process 0 surfaces the same exception to its HTTP
        client and stays up, so the worker logs it and rejoins the next
        broadcast — otherwise one bad request would leave process 0
        broadcasting to nobody and every later search hanging.
        """
        import logging

        log = logging.getLogger("gpusimilarity_jax.multihost")
        while True:
            req = self._broadcast(self._template())
            op, b, sim_code = (int(x) for x in req["meta"])
            if op == _OP_SHUTDOWN:
                return
            dbnames = [
                self._names[int(i)] for i in req["db_idx"] if int(i) >= 0
            ]
            key_oks = [bool(k) for k in req["key_ok"][: len(dbnames)]]
            try:
                self.registry._execute_batch(
                    dbnames,
                    key_oks,
                    req["queries"][:b],
                    [int(k) for k in req["ks"][:b]],
                    [float(c) for c in req["cutoffs"][:b]],
                    _SIM_NAMES[sim_code],
                    float(req["ab"][0]),
                    float(req["ab"][1]),
                )
            except Exception:
                log.exception(
                    "multi-host worker: request failed (batch=%d dbs=%s); "
                    "continuing to serve", b, dbnames,
                )
