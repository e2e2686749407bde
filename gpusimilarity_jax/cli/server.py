"""Run the similarity-search HTTP service.

Single-process equivalent of the reference's ``gpusim_server.py`` +
``gpusimserver`` pair: loads ``.fsim`` databases onto the device mesh and
serves HTTP/JSON searches with request batching.
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="gpusimilarity_jax server — load fingerprint databases into "
        "GPU memory and answer similarity searches over HTTP/JSON."
    )
    parser.add_argument("dbnames", nargs="+", help=".fsim files to serve")
    parser.add_argument("--hostname", default="localhost")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument(
        "--http_interface", action="store_true",
        help="enable the debug HTML UI (not for production exposure)",
    )
    parser.add_argument(
        "--cpu_only", action="store_true",
        help="run on the host CPU (slow; tests and debugging). Without it "
        "the server refuses to start where JAX finds no GPU",
    )
    parser.add_argument(
        "--gpu_bitcount", "--device_bitcount", dest="device_bitcount",
        default=0, type=int,
        help="maximum on-device fingerprint bitcount (forces folding)",
    )
    parser.add_argument(
        "--fold", default=None, type=int,
        help="explicit fold factor (default: auto from device memory)",
    )
    parser.add_argument("--max_batch", default=64, type=int,
                        help="max queries coalesced into one scan")
    parser.add_argument("--batch_window_ms", default=2.0, type=float,
                        help="batching window in milliseconds")
    parser.add_argument(
        "--search_timeout_s", default=1500.0, type=float,
        help="per-request result deadline; must outlive the live XLA "
        "compile a cold shape can hit",
    )
    parser.add_argument(
        "--scan_mode", default="auto",
        choices=("auto", "dense", "bitplane"),
        help="dense packed-word scan, bit-sliced sparse-query scan, or auto "
        "(on a GPU: bitplane when the library is unfolded, dense when "
        "folded; dense on CPU). On a GPU the bitplane scan runs its Pallas "
        "kernel",
    )
    parser.add_argument(
        "--popless", action="store_true",
        help="dense store without the per-column popcount array (the scan "
        "recomputes pops from the planes it reads) — frees 2 B/row of "
        "device memory",
    )
    parser.add_argument(
        "--coordinator", default="",
        help="multi-host mode: coordination service address host:port "
        "(run one server process per host with --num_processes/--process_id; "
        "the library shards over the global mesh)",
    )
    parser.add_argument("--num_processes", default=1, type=int,
                        help="total processes in the multi-host job")
    parser.add_argument("--process_id", default=0, type=int,
                        help="this process's rank in the multi-host job")
    parser.add_argument(
        "--no_warmup", action="store_true",
        help="skip precompiling the common search shapes at startup (the "
        "first live query then pays the XLA compile)",
    )
    parser.add_argument(
        "--warmup_batch", default=8, type=int,
        help="also precompile coalesced-batch shapes up to this bucket "
        "(the batching layer groups concurrent requests; without this the "
        "first burst pays a live compile). 1 = single-query shapes only",
    )
    parser.add_argument(
        "--warmup_ks", default="20,128",
        help="comma-separated return_count values to precompile (each "
        "distinct k-fetch bucket is its own XLA compile; requests above "
        "the warmed maximum pay a live compile, smaller ks are served via "
        "k-bucket promotion)",
    )
    parser.add_argument(
        "--jax_profiler_port", default=0, type=int,
        help="start the JAX profiler server (TensorBoard-attachable) on this port",
    )
    parser.add_argument(
        "--socket_name", default="",
        help="also serve the reference's binary local-socket protocol on "
        "$TMPDIR/<name> (the reference backend used 'gpusimilarity')",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )

    import jax

    if args.cpu_only:
        jax.config.update("jax_platforms", "cpu")
    if args.coordinator:
        from ..parallel import multihost

        multihost.initialize(
            args.coordinator, args.num_processes, args.process_id
        )
    if not args.cpu_only and jax.default_backend() != "gpu":
        print(
            f"no GPU found (JAX backend {jax.default_backend()!r}); pass "
            "--cpu_only to serve from the host CPU",
            file=sys.stderr,
        )
        sys.exit(2)
    from ..utils import jax_cache

    jax_cache.enable()  # restarts skip compiles
    if args.jax_profiler_port:
        # on-demand device profiling: point TensorBoard (or
        # `jax.profiler.trace_function`) at this port to capture traces of
        # live searches — the rebuild's answer to the reference's
        # QElapsedTimer logging (gpusim.cpp:420-429), which we also keep as
        # per-search latency log lines.
        jax.profiler.start_server(args.jax_profiler_port)

    from ..models.registry import DatabaseRegistry
    from ..serve.server import SimilarityServer

    warmup_ks = tuple(
        int(k) for k in str(args.warmup_ks).split(",") if k.strip()
    )
    # "auto" scan mode resolves inside the registry, AFTER the global fold
    # factor is known (an auto memory-based fold > 1 must pick dense too,
    # not just an explicit --fold; see models/registry.resolve_scan_mode).
    # With warmup on, the warmup shapes AOT-precompile on background threads
    # WHILE each library streams/folds/uploads (overlapped startup).
    registry = DatabaseRegistry.from_fsim_files(
        args.dbnames,
        device_bitcount=args.device_bitcount,
        fold_factor=args.fold,
        scan_mode=args.scan_mode,
        precompile_ks=None if args.no_warmup else warmup_ks,
        precompile_batch=min(args.warmup_batch, args.max_batch),
        popless=args.popless,
    )
    # multi-host serving: every process loads (its span of) the library and
    # runs warmup in lockstep; process 0 serves HTTP and fans each request
    # out through the controller, the rest execute requests in a loop
    controller = None
    if args.coordinator and args.num_processes > 1:
        from ..parallel.multihost import MultihostController

        controller = MultihostController(registry, max_batch=args.max_batch)
    if not args.no_warmup:
        registry.warmup(
            ks=warmup_ks, max_batch=min(args.warmup_batch, args.max_batch)
        )
    if controller is not None and jax.process_index() != 0:
        for name, db in registry._dbs.items():
            print(
                f"worker {jax.process_index()}: {name} fed "
                f"{db.loaded_fp_bytes} fp bytes", file=sys.stderr,
            )
        print(
            f"gpusimilarity_jax worker {jax.process_index()} ready",
            file=sys.stderr,
        )
        controller.serve_worker()
        return
    if controller is not None:
        registry.multihost_controller = controller
        for name, db in registry._dbs.items():
            print(
                f"worker 0: {name} fed {db.loaded_fp_bytes} fp bytes",
                file=sys.stderr,
            )
    server = SimilarityServer(
        registry,
        hostname=args.hostname,
        port=args.port,
        debug_ui=args.http_interface,
        max_batch=args.max_batch,
        window_ms=args.batch_window_ms,
        socket_name=args.socket_name or None,
        search_timeout_s=args.search_timeout_s,
    )
    print(
        f"gpusimilarity_jax ready on {args.hostname}:{server.port} "
        f"({', '.join(registry.names())})",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if controller is not None:
            controller.shutdown()


if __name__ == "__main__":
    main()
