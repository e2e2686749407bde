"""Multi-host serving: 2-process CPU tests over a Gloo mesh.

Each subprocess joins a 2-process JAX runtime (4 fake CPU devices per
process => an 8-device global mesh). Three layers are pinned here:

* raw sharded-store smoke test (round 1): ``multihost.distribute_rows``
  feeds local rows, the SPMD search matches the numpy oracle;
* engine level (round 3): ``FingerprintDB`` itself builds its store from
  this process's span only, RAM string tables are host-sharded and
  resolved with the cross-host collective during result assembly;
* full stack (round 3): two ``cli.server`` processes with
  ``--coordinator``, an HTTP query to process 0 fans out through the
  ``MultihostController`` and returns correct merged ids/smiles, with
  neither process having read more than its span of the ``.tfsim`` map.

Real multi-host runs need real hardware; these pin the process wiring and the
engine/server integration.
"""

import socket
import subprocess
import sys
import os

import numpy as np
import pytest

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " \
    "--xla_cpu_enable_fast_math=false"
import jax
jax.config.update("jax_platforms", "cpu")

from gpusimilarity_jax.parallel import multihost, sharded
from gpusimilarity_jax.parallel.mesh import make_mesh
from gpusimilarity_jax.ops.scan import popcount_rows_np, scores_np

multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

import numpy as np
rng = np.random.default_rng(1234)  # same seed: both processes know the data
n, w = 4096, 32
words = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
mesh = make_mesh(jax.devices())

lo, hi = multihost.process_row_span(mesh, n)
assert (lo, hi) == ((0, 2048) if pid == 0 else (2048, 4096)), (lo, hi)

planar_local = np.ascontiguousarray(words[lo:hi].T)
pops_local = popcount_rows_np(words[lo:hi])
gwords, gpops = multihost.distribute_rows(planar_local, pops_local, mesh)
store = sharded.build_store_from_device(gwords, gpops, n_valid=n, mesh=mesh,
                                        chunk_cols=512)

search = sharded.build_search_fn(store, k=10, similarity="tanimoto", batch=2)
queries = words[[7, 3000]]
import jax.numpy as jnp
vals, idx, approx = search(
    jnp.asarray(queries), jnp.asarray(popcount_rows_np(queries)),
    jnp.asarray(np.zeros(2, np.float32)), jnp.float32(1.0), jnp.float32(1.0),
)
vals, idx = np.asarray(jax.device_get(vals)), np.asarray(jax.device_get(idx))

s = scores_np(words, queries)
for qi in range(2):
    order = np.lexsort((np.arange(n), -s[qi]))[:10]
    np.testing.assert_allclose(vals[qi], s[qi][order], rtol=0)
    np.testing.assert_array_equal(idx[qi], order)

# host-sharded string table: this process resolves exactly its own span
ids = [f"ID{i:06d}".encode() for i in range(lo, hi)]
table = multihost.HostStrings(ids, lo, hi)
for gi in idx.reshape(-1):
    gi = int(gi)
    got = table.get(gi)
    if lo <= gi < hi:
        assert got == f"ID{gi:06d}".encode()
    else:
        assert got is None
print(f"proc {pid} OK", flush=True)
"""


ENGINE_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " \
    "--xla_cpu_enable_fast_math=false"
import jax
jax.config.update("jax_platforms", "cpu")

from gpusimilarity_jax.parallel import multihost
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)

import numpy as np
from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
from gpusimilarity_jax.ops.scan import scores_np
from gpusimilarity_jax.utils.fsim import FingerprintData

rng = np.random.default_rng(77)  # same seed: both processes build the data
n = 4096
bits = rng.random((n, 1024), dtype=np.float32) < 0.1
packed = np.packbits(bits, axis=1, bitorder="little")
smiles = [f"SMI{i:05d}".encode() for i in range(n)]  # plain RAM lists ->
ids = [f"ID{i:05d}".encode() for i in range(n)]      # HostStrings sharding
# real libraries hold SMILES beyond any fixed buffer guess; row 3000 (on
# process 1's span) must round-trip through the cross-host resolve
# collective unclipped
smiles[3000] = b"C" * 700
data = FingerprintData(dbkey="mh", bitcount=1024, fingerprints=packed,
                       smiles=smiles, ids=ids)

db = FingerprintDB(data, chunk_cols=512)
# the engine fed only this process's span, not the whole library
assert db.loaded_fp_bytes is not None
assert db.loaded_fp_bytes <= packed.nbytes // 2 + 512 * 128, db.loaded_fp_bytes

# string tables were host-sharded (RAM lists, not mmap)
assert isinstance(db._smiles, multihost.HostStrings)
assert isinstance(db._ids, multihost.HostStrings)

# query rows living on BOTH hosts' spans: assembly crosses spans via the
# resolve_strings collective; both processes run searches in lockstep
words = data.packed_words()
for qi in (7, 3000):
    r = db.search(words[qi], k=5, dbkey="mh")
    s = scores_np(words, words[qi][None, :])[0]
    order = np.lexsort((np.arange(n), -s))[:5]
    assert r.scores == [float(v) for v in s[order]], (qi, r.scores)
    assert r.ids == [f"ID{i:05d}" for i in order], (qi, r.ids)
    assert r.smiles == [smiles[i].decode() for i in order]
assert any(len(x) == 700 for x in db.search(words[3000], k=1, dbkey="mh").smiles)
print(f"engine proc {pid} OK", flush=True)
"""


SERVER_DB_BUILDER = r"""
import numpy as np, sys
from gpusimilarity_jax.utils.fsim import FingerprintData
from gpusimilarity_jax.utils.tfsim import save_native
rng = np.random.default_rng(99)
n = 4096
bits = rng.random((n, 1024), dtype=np.float32) < 0.1
packed = np.packbits(bits, axis=1, bitorder="little")
data = FingerprintData(
    dbkey="mh", bitcount=1024, fingerprints=packed,
    smiles=[f"SMI{i:05d}".encode() for i in range(n)],
    ids=[f"ID{i:05d}".encode() for i in range(n)],
)
save_native(sys.argv[1], data)
np.save(sys.argv[2], packed)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh_search(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out


BITPLANE_ENGINE_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " \
    "--xla_cpu_enable_fast_math=false"
import jax
jax.config.update("jax_platforms", "cpu")

from gpusimilarity_jax.parallel import multihost
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)

import numpy as np
from gpusimilarity_jax.models.fingerprint_db import FingerprintDB
from gpusimilarity_jax.ops.scan import scores_np
from gpusimilarity_jax.utils.fsim import FingerprintData

rng = np.random.default_rng(78)
n = 60000
bits = rng.random((n, 1024), dtype=np.float32) < 0.05
packed = np.packbits(bits, axis=1, bitorder="little")
data = FingerprintData(
    dbkey="mhb", bitcount=1024, fingerprints=packed,
    smiles=[f"SMI{i:05d}".encode() for i in range(n)],
    ids=[f"ID{i:05d}".encode() for i in range(n)],
)

# the bitplane per-process feed (its byte-identity to the single-host
# builder is pinned by test_bitplane_multihost_feed_matches_single_host)
db = FingerprintDB(data, scan_mode="bitplane")
assert db.loaded_fp_bytes is not None
assert db.loaded_fp_bytes <= packed.nbytes // 2 + 8192 * 128

words = data.packed_words()
for qi in (7, 45000):
    r = db.search(words[qi], k=5, dbkey="mhb")
    s = scores_np(words, words[qi][None, :])[0]
    order = np.lexsort((np.arange(n), -s))[:5]
    assert r.scores == [float(v) for v in s[order]], (qi, r.scores)
    assert r.ids[0] == f"ID{qi:05d}" and r.scores[0] == 1.0
print(f"bitplane engine proc {pid} OK", flush=True)
"""


def test_bitplane_multihost_feed_matches_single_host():
    """Single-process sanity: the per-process bitplane feed lays out the
    EXACT arrays the single-host uploader builds (planes interleave, int16
    pops) — for both unfolded and folded data."""
    import jax

    from gpusimilarity_jax.ops import fold as fold_ops
    from gpusimilarity_jax.parallel import sharded
    from gpusimilarity_jax.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    n = 70000
    packed = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    packed &= rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    mesh = make_mesh(jax.devices()[:4])
    for fold in (1, 2):
        st_mh, nbytes = sharded.build_bitplane_store_multihost(
            packed, mesh, fold_factor=fold
        )
        assert nbytes == packed.nbytes
        st_sh = sharded.build_bitplane_store(
            np.asarray(fold_ops.fold_words(packed, fold)),
            mesh=mesh,
        )
        np.testing.assert_array_equal(
            np.asarray(st_mh.planes), np.asarray(st_sh.planes)
        )
        np.testing.assert_array_equal(
            np.asarray(st_mh.popcounts), np.asarray(st_sh.popcounts)
        )
        assert st_mh.n_valid == st_sh.n_valid == n
        assert st_mh.bitcount == 1024 // fold


def test_resolve_scan_mode_allows_multihost_bitplane():
    from gpusimilarity_jax.models.registry import resolve_scan_mode

    # the rule depends on the backend and the fold, not on the process
    # count: a multi-host GPU job serves bitplane unfolded
    assert resolve_scan_mode("auto", 1, "gpu") == "bitplane"
    # folding still picks dense
    assert resolve_scan_mode("auto", 4, "gpu") == "dense"


def test_two_process_bitplane_engine(tmp_path):
    """The bitplane store served from a 2-process mesh: per-span plane
    feed, exact merged results."""
    script = tmp_path / "bitplane_engine_worker.py"
    script.write_text(BITPLANE_ENGINE_WORKER)
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"bitplane engine proc {pid} OK" in out


def _clean_env():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    return env


def test_two_process_engine_with_host_sharded_strings(tmp_path):
    """FingerprintDB itself (not raw sharded calls) in a 2-process mesh:
    per-span store feed + HostStrings + cross-host string resolve."""
    script = tmp_path / "engine_worker.py"
    script.write_text(ENGINE_WORKER)
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"engine proc {pid} OK" in out


def test_two_process_server_stack(tmp_path):
    """The full serving stack on a 2-process mesh: two ``cli.server``
    processes with --coordinator, one HTTP query to process 0, correct
    merged ids/smiles back, and neither process fed more than its span of
    the .tfsim map (VERDICT r3 item 2)."""
    import json
    import time
    import urllib.request

    env = _clean_env()
    db_path = tmp_path / "mh.tfsim"
    packed_path = tmp_path / "packed.npy"
    builder = tmp_path / "build_db.py"
    builder.write_text(SERVER_DB_BUILDER)
    subprocess.run(
        [sys.executable, str(builder), str(db_path), str(packed_path)],
        check=True, env={**env, "JAX_PLATFORMS": "cpu"},
    )
    packed = np.load(packed_path)
    n = packed.shape[0]

    coord_port = _free_port()
    http_port = _free_port()
    worker_env = dict(
        env,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4 "
        "--xla_cpu_enable_fast_math=false",
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "gpusimilarity_jax.cli.server",
                str(db_path), "--cpu_only", "--port", str(http_port),
                "--coordinator", f"localhost:{coord_port}",
                "--num_processes", "2", "--process_id", str(pid),
                "--no_warmup",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=worker_env, text=True,
        )
        for pid in (0, 1)
    ]
    try:
        deadline = time.monotonic() + 240
        result = None
        qi = 3000
        q_hex = packed[qi].tobytes().hex()
        body = (
            f"fp_hex={q_hex}&return_count=5&similarity_cutoff=0"
            f"&dbnames=mh&dbkeys=mh"
        ).encode()
        while time.monotonic() < deadline:
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(2)
            try:
                with urllib.request.urlopen(
                    urllib.request.Request(
                        f"http://localhost:{http_port}/similarity_search_json",
                        data=body,
                    ),
                    timeout=30,
                ) as resp:
                    result = json.loads(resp.read())
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                continue
        assert result is not None, "server never answered"
    finally:
        outs = []
        for p in procs:
            p.terminate()
            try:
                out, _ = p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)

    # correctness: self-match at rank 0 with the right id/smiles
    from gpusimilarity_jax.ops.scan import scores_np

    s = scores_np(packed.view(np.uint32).reshape(n, 32),
                  packed[qi].view(np.uint32)[None, :])[0]
    order = np.lexsort((np.arange(n), -s))[:5]
    assert result["results"][0][0] == f"ID{qi:05d}"
    assert result["results"][0][1] == f"SMI{qi:05d}"
    assert result["results"][0][2] == 1.0
    got_ids = [r[0] for r in result["results"]]
    assert got_ids == [f"ID{i:05d}" for i in order], (got_ids, outs[0][-2000:])
    assert result["approximate_count"] == n  # cutoff 0 counts every row

    # no process fed more than its half-span of fingerprint bytes
    full_bytes = packed.nbytes
    for pid, out in enumerate(outs):
        import re

        m = re.search(r"fed (\d+) fp bytes", out)
        assert m, f"proc {pid} missing feed log:\n{out[-3000:]}"
        assert int(m.group(1)) <= full_bytes // 2 + 512 * 128, (
            pid, m.group(1), full_bytes,
        )


def test_eight_process_server_stack(tmp_path):
    """Eight-host-shaped serving: EIGHT ``cli.server`` processes x 1 CPU
    device each (8 hosts x 1 card), one HTTP query
    to process 0. 2-process tests cannot catch fan-in and span bugs that
    only appear at >2 (``multihost.process_row_span`` contiguity, the
    ``resolve_strings_many`` all-gather fan-in, broadcast lockstep across
    7 workers) — round-3 review item 5. Slow (~5 min on the 1-core CI
    host): 8 jax runtimes boot serially."""
    import json
    import time
    import urllib.request

    nprocs = 8
    env = _clean_env()
    db_path = tmp_path / "mh8.tfsim"
    packed_path = tmp_path / "packed8.npy"
    builder = tmp_path / "build_db8.py"
    builder.write_text(SERVER_DB_BUILDER)
    subprocess.run(
        [sys.executable, str(builder), str(db_path), str(packed_path)],
        check=True, env={**env, "JAX_PLATFORMS": "cpu"},
    )
    packed = np.load(packed_path)
    n = packed.shape[0]

    coord_port = _free_port()
    http_port = _free_port()
    worker_env = dict(
        env,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=1 "
        "--xla_cpu_enable_fast_math=false",
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "gpusimilarity_jax.cli.server",
                str(db_path), "--cpu_only", "--port", str(http_port),
                "--coordinator", f"localhost:{coord_port}",
                "--num_processes", str(nprocs), "--process_id", str(pid),
                "--no_warmup",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=worker_env, text=True,
        )
        for pid in range(nprocs)
    ]
    try:
        deadline = time.monotonic() + 900
        result = None
        # query row on the LAST process's span: its id/smiles resolution
        # must fan in across all 8 processes
        qi = n - 5
        q_hex = packed[qi].tobytes().hex()
        body = (
            f"fp_hex={q_hex}&return_count=5&similarity_cutoff=0"
            f"&dbnames=mh8&dbkeys=mh"
        ).encode()
        while time.monotonic() < deadline:
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(2)
            try:
                with urllib.request.urlopen(
                    urllib.request.Request(
                        f"http://localhost:{http_port}/similarity_search_json",
                        data=body,
                    ),
                    timeout=30,
                ) as resp:
                    result = json.loads(resp.read())
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                continue
        assert result is not None, "server never answered"
    finally:
        outs = []
        for p in procs:
            p.terminate()
            try:
                out, _ = p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)

    from gpusimilarity_jax.ops.scan import scores_np

    s = scores_np(packed.view(np.uint32).reshape(n, 32),
                  packed[qi].view(np.uint32)[None, :])[0]
    order = np.lexsort((np.arange(n), -s))[:5]
    assert result["results"][0][0] == f"ID{qi:05d}", outs[0][-2000:]
    assert result["results"][0][2] == 1.0
    got_ids = [r[0] for r in result["results"]]
    assert got_ids == [f"ID{i:05d}" for i in order], (got_ids, outs[0][-2000:])
    assert result["approximate_count"] == n

    # every process fed only its 1/8 span of fingerprint bytes
    full_bytes = packed.nbytes
    for pid, out in enumerate(outs):
        import re

        m = re.search(r"fed (\d+) fp bytes", out)
        assert m, f"proc {pid} missing feed log:\n{out[-3000:]}"
        assert int(m.group(1)) <= full_bytes // nprocs + 512 * 128, (
            pid, m.group(1), full_bytes,
        )


# ------------------------------------------------- controller unit tests
# (single-process: broadcast_one_to_all degenerates to identity, which is
# enough to pin the lifecycle/shape logic without a 2-process mesh)


class _FakeDB:
    word_count = 32


class _FakeRegistry:
    def __init__(self, names):
        self._names = list(names)

    def names(self):
        return list(self._names)

    def get(self, name):
        return _FakeDB()

    def _execute_batch(self, *a, **k):
        return []


def test_controller_max_dbs_defaults_to_registry_count():
    """The broadcast template sizes its db slots from the registry — a
    12-database registry must accept a 12-database query with no knob."""
    from gpusimilarity_jax.parallel.multihost import MultihostController

    c = MultihostController(_FakeRegistry([f"db{i}" for i in range(12)]))
    assert c.max_dbs == 12
    assert c._template()["db_idx"].shape == (12,)
    assert MultihostController(_FakeRegistry([]), max_dbs=3).max_dbs == 3


def test_controller_dispatch_after_shutdown_fails_fast():
    """A batcher group still in flight when the server shuts down must get
    an immediate error, not hang forever in a collective with no peers."""
    import numpy as np
    import pytest

    from gpusimilarity_jax.parallel.multihost import MultihostController

    c = MultihostController(_FakeRegistry(["db0"]))
    c.shutdown()
    c.shutdown()  # idempotent: no second broadcast, no error
    with pytest.raises(RuntimeError, match="shut down"):
        c.dispatch_batch(
            ["db0"], [True], np.zeros((1, 32), np.uint32), [5], [0.0],
            "tanimoto", 1.0, 1.0,
        )


def test_serve_worker_survives_failing_request():
    """One failing request must not kill the worker loop (process 0 stays
    up after the same failure; a dead worker would wedge every later
    broadcast)."""
    from gpusimilarity_jax.parallel import multihost as mh

    class _BoomRegistry(_FakeRegistry):
        def __init__(self, names):
            super().__init__(names)
            self.calls = 0

        def _execute_batch(self, *a, **k):
            self.calls += 1
            raise RuntimeError("boom")

    reg = _BoomRegistry(["db0"])
    c = mh.MultihostController(reg)
    search = c._template()
    search["meta"][:] = (mh._OP_SEARCH, 1, 0)
    search["db_idx"][0] = 0
    search["key_ok"][0] = 1
    stop = c._template()  # zero meta == shutdown
    seq = iter([search, stop])
    c._broadcast = lambda payload: next(seq)  # shadow the collective
    c.serve_worker()  # returns via the shutdown op, exception logged
    assert reg.calls == 1


def test_resolve_strings_many_splits_pairs_in_one_collective():
    """Batched cross-host lookup: per-pair splitting, b'' for unowned
    rows, empty pairs, and the all-empty early-out (single-process
    collectives are identities, so the splitting logic is what's pinned)."""
    from gpusimilarity_jax.parallel import multihost

    a = multihost.HostStrings([b"a0", b"a1"], 0, 4)
    b = multihost.HostStrings([b"b2", b"b3"], 2, 4)
    out = multihost.resolve_strings_many(
        [(a, [0, 1, 3]), (b, [2, 0]), (a, [])]
    )
    assert out == [[b"a0", b"a1", b""], [b"b2", b""], []]
    # all-empty: skips the collectives entirely (symmetric on every process)
    assert multihost.resolve_strings_many([(a, []), (b, [])]) == [[], []]
    # single-pair wrapper unchanged
    assert multihost.resolve_strings(a, [1, 2]) == [b"a1", b""]


def test_dispatch_batch_executes_with_broadcast_roundtripped_values():
    """Process 0 must run the search with the float32 values the workers
    decode from the broadcast template — float64 originals could rescore
    a boundary row differently and desync the string-resolve collective."""
    import numpy as np

    from gpusimilarity_jax.parallel.multihost import MultihostController

    class _Recorder(_FakeRegistry):
        def __init__(self, names):
            super().__init__(names)
            self.seen = None

        def _execute_batch(
            self, dbnames, key_oks, queries, ks, cutoffs, similarity,
            alpha, beta,
        ):
            self.seen = (list(ks), list(cutoffs), alpha, beta)
            return ["ok"]

    reg = _Recorder(["db0"])
    c = MultihostController(reg, max_batch=4)
    c.dispatch_batch(
        ["db0"], [True], np.zeros((1, 32), np.uint32), [5], [0.3],
        "tversky", 0.3, 0.7,
    )
    ks, cutoffs, alpha, beta = reg.seen
    assert ks == [5]
    assert cutoffs == [float(np.float32(0.3))] != [0.3]
    assert alpha == float(np.float32(0.3)) != 0.3
    assert beta == float(np.float32(0.7)) != 0.7
