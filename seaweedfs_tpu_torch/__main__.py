"""Command line of the port.

    python3 -m seaweedfs_tpu_torch master [-ip 127.0.0.1] [-port 9333]
        [-volumeSizeLimitMB 1024] [-defaultReplication 000]
        [-telemetry -telemetryUrl URL]
    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1] [-mserver HOST:PORT] [-device cuda] [-max 8]
        [-dataCenter DC] [-rack RACK] [-fsync]
    python3 -m seaweedfs_tpu_torch filer [-ip 127.0.0.1] [-port 8888]
        [-master HOST:PORT] [-store filer.db] [-collection C]
        [-replication 000]
    python3 -m seaweedfs_tpu_torch shell [-master HOST:PORT]
        [-filer HOST:PORT] ["lock; ec.encode -volumeId=1; unlock"]
    python3 -m seaweedfs_tpu_torch admin [-ip 127.0.0.1] [-port 23646]
        [-master HOST:PORT] [-detectionInterval 30] [-dataDir DIR]
    python3 -m seaweedfs_tpu_torch worker [-admin HOST:PORT]
        [-master HOST:PORT] [-dir DIR]
        [-capabilities erasure_coding,ec_rebuild] [-device cuda]
    python3 -m seaweedfs_tpu_torch benchmark [-master HOST:PORT]
        [-n 1000] [-size 1024] [-c 16]
    python3 -m seaweedfs_tpu_torch upload [-master HOST:PORT] FILE
    python3 -m seaweedfs_tpu_torch download [-master HOST:PORT] FID

`master` starts the master (`server/master_server.py`) and `volume` a
volume server (`server/volume_server.py`) that heartbeats to
`-mserver` (without it, the server has no master), reporting `-max`
volume slots and its `-dataCenter` and `-rack`, which the master's
placement of new volumes reads.  `-fsync` puts the volume server on
the power-loss tier: a write or delete is acked after an fsync of its
`.dat`, one fsync a group-commit window.  The master grows volumes of
`-defaultReplication` for assigns that name none.  Each prints
`<role> server listening on <ip>:<port>` on its first line (`-port 0`
takes a free port) and serves until SIGTERM or SIGINT, when it stops
cleanly and exits 0.  A master given `-telemetry` and `-telemetryUrl`
prints `telemetry enabled -> <url>` next and posts an anonymous report
of the cluster's shape there (`telemetry.py`) at once and every 24
hours; without them it sends nothing.  The volume server's codec runs
on the CUDA card, or on `-device cpu` when asked for.  A `-device cuda`
given on the command line must find the card at start, or the command
fails; left out, the card is first looked for by the first encode or
rebuild, which fails without one.  `shell` runs one `;`-separated command line
against `-master` (and `-filer`, for the `fs.*` commands), prints each
command's output and exits.

`filer` starts a filer (`server/filer_server.py`) over the sqlite store
`-store` (a file, its metadata log in `<store>.metalog`, or `:memory:`)
whose files' chunks go to `-collection` on `-master`'s volumes, and
prints `filer listening on <ip>:<port>`.  Over a store file it runs the
meta plane (metalog as WAL, the store an async checkpoint) and the
native meta and read planes by default, in one process; `-metaPlane 0`
commits every mutation synchronously, and `-metaPlane 1` over a store
the plane cannot run on (`:memory:`) is refused.  A `-storeType` other
than sqlite, `-workers` above 1, `-notification`, `-lockPeers` and
`-metricsAddress` are refused, not ported yet (ROADMAP).

`admin` starts the maintenance admin (`plugin/admin.py`) and prints
`admin listening on <ip>:<port>`; `worker` registers a maintenance
worker (`plugin/worker.py`) with `-admin` and prints `worker <id>
polling <admin>`.  The worker's `erasure_coding` capability encodes
pulled volumes on its `-device` (the card by default; `-device cuda`
must find it at start), and both `erasure_coding` and `ec_rebuild`
bring the rebuild handler.  Both serve until SIGTERM or SIGINT, stop
and exit 0.

`benchmark` writes `-n` files of `-size` bytes through `-master` on
`-c` threads, then reads each back, and prints one JSON line of
latencies a phase (`benchmark.py`); `upload` writes a file as one needle
and prints its fid; `download` writes a fid's bytes to standard output.
"""

from __future__ import annotations

import argparse
import gc
import os
import signal
import sys
import tempfile
import threading


def _serve(server, line, then=None) -> int:
    """Start `server`, print `line(server)`, call `then(server)` if
    given, freeze the heap so far out of the cycle collector, and serve
    until SIGTERM or SIGINT."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(line(server), flush=True)
    if then is not None:
        then(server)
    # the startup heap (torch and the other modules, the loaded indexes)
    # leaves the cycle collector: a full collection of it takes tens of
    # milliseconds, and every request thread waits behind one
    gc.collect()
    gc.freeze()
    try:
        stop.wait()
    finally:
        server.stop()
    return 0


def _listening(role: str):
    return lambda server: f"{role} listening on {server.url}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("master", help="start a master server")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-telemetry", action="store_true",
                   help="opt-in anonymous cluster reports (default off)")
    m.add_argument("-telemetryUrl", default="",
                   help="collector URL for -telemetry")
    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default=".", help="comma-separated data dirs")
    v.add_argument("-mserver", default="",
                   help="master host:port (none: no heartbeat)")
    v.add_argument("-device", default=None,
                   help="codec device: cuda (the default) or cpu")
    v.add_argument("-max", type=int, default=8)
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-fsync", action="store_true",
                   help="fsync acked writes (the power-loss tier; one "
                        "fsync a group-commit window)")
    ad = sub.add_parser("admin", help="start the maintenance admin")
    ad.add_argument("-ip", default="127.0.0.1")
    ad.add_argument("-port", type=int, default=23646)
    ad.add_argument("-master", default="127.0.0.1:9333")
    ad.add_argument("-detectionInterval", type=float, default=30.0)
    ad.add_argument("-dataDir", default="",
                    help="persist jobs, config and workers under "
                         "<dataDir>/plugin/")
    wk = sub.add_parser("worker", help="start a maintenance worker")
    wk.add_argument("-admin", default="127.0.0.1:23646")
    wk.add_argument("-master", default="127.0.0.1:9333")
    wk.add_argument("-dir", default=os.path.join(tempfile.gettempdir(),
                                                 "seaweedfs_tpu_worker"),
                    help="where pulled volumes are encoded")
    wk.add_argument("-capabilities", default="erasure_coding,ec_rebuild")
    wk.add_argument("-device", default=None,
                    help="codec device: cuda (the default) or cpu")
    fl = sub.add_parser("filer", help="start a filer server")
    fl.add_argument("-ip", default="127.0.0.1")
    fl.add_argument("-port", type=int, default=8888)
    fl.add_argument("-master", default="127.0.0.1:9333")
    fl.add_argument("-store", default="filer.db",
                    help="sqlite store path, or :memory:")
    fl.add_argument("-storeType", dest="store_type", default="sqlite",
                    choices=["sqlite", "lsm", "redis", "elastic"],
                    help="metadata store; only sqlite is ported")
    fl.add_argument("-collection", default="")
    fl.add_argument("-replication", default="")
    fl.add_argument("-notification", default="",
                    help="metadata notification sink (not ported)")
    fl.add_argument("-lockPeers", dest="lock_peers", default="",
                    help="distributed-lock ring (not ported)")
    fl.add_argument("-workers", type=int, default=None,
                    help="pre-fork worker processes (only 1 is ported)")
    fl.add_argument("-metaPlane", dest="meta_plane", default="",
                    choices=["", "0", "1"],
                    help="filer meta plane (metalog-as-WAL ack and async "
                         "store checkpointing): 1 forces on, 0 forces the "
                         "synchronous store commit; default auto (on for "
                         "a sqlite file).  Sets "
                         "SEAWEEDFS_TPU_FILER_META_PLANE")
    fl.add_argument("-metricsAddress", dest="metrics_address",
                    default="", help="Prometheus pushgateway (not ported)")
    fl.add_argument("-metricsIntervalSec", dest="metrics_interval",
                    type=int, default=15)
    sh = sub.add_parser("shell", help="run shell commands")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("-filer", default="",
                    help="filer host:port for the fs.* command family")
    sh.add_argument("command", nargs="*",
                    help="one `;`-separated command line")
    bm = sub.add_parser("benchmark",
                        help="write/read load test (weed benchmark)")
    bm.add_argument("-master", default="127.0.0.1:9333")
    bm.add_argument("-n", type=int, default=1000)
    bm.add_argument("-size", type=int, default=1024)
    bm.add_argument("-c", type=int, default=16)
    up = sub.add_parser("upload", help="upload a file")
    up.add_argument("-master", default="127.0.0.1:9333")
    up.add_argument("file")
    down = sub.add_parser("download", help="download a fid")
    down.add_argument("-master", default="127.0.0.1:9333")
    down.add_argument("fid")
    args = ap.parse_args(argv)

    if args.cmd == "master":
        from .server.master_server import MasterServer
        from .telemetry import TelemetryClient
        reporter = TelemetryClient(args.telemetryUrl,
                                   enabled=args.telemetry)

        def report(server):
            if reporter.enabled:
                print(f"telemetry enabled -> {args.telemetryUrl}",
                      flush=True)
                reporter.start(server.url)
        try:
            return _serve(MasterServer(
                args.ip, args.port,
                volume_size_limit_mb=args.volumeSizeLimitMB,
                default_replication=args.defaultReplication),
                _listening("master server"), report)
        finally:
            reporter.stop()
    if args.cmd in ("volume", "worker") and args.device is not None:
        from .ops.rs_torch import _resolve_device
        _resolve_device(args.device)  # raises without the card
    if args.cmd == "volume":
        from .server.volume_server import VolumeServer
        return _serve(VolumeServer(
            args.dir.split(","), host=args.ip, port=args.port,
            device=args.device or "cuda", master=args.mserver,
            data_center=args.dataCenter, rack=args.rack,
            max_volume_count=args.max, fsync=args.fsync),
            _listening("volume server"))
    if args.cmd == "admin":
        from .plugin.admin import AdminServer
        return _serve(AdminServer(
            args.master, args.ip, args.port,
            detection_interval=args.detectionInterval,
            data_dir=args.dataDir or None), _listening("admin"))
    if args.cmd == "worker":
        from .plugin import EcEncodeHandler, EcRebuildHandler, PluginWorker
        caps = args.capabilities.split(",")
        handlers = []
        if "erasure_coding" in caps:
            handlers.append(EcEncodeHandler(device=args.device or "cuda"))
        if {"erasure_coding", "ec_rebuild"} & set(caps):
            handlers.append(EcRebuildHandler())
        if not handlers:
            ap.error(f"no handler for -capabilities {args.capabilities}; "
                     f"known: erasure_coding, ec_rebuild")
        return _serve(PluginWorker(args.admin, args.master, args.dir,
                                   handlers),
                      lambda w: f"worker {w.worker_id} polling {w.admin}")
    if args.cmd == "filer":
        from .server.filer_server import FilerServer
        workers = args.workers
        if workers is None:
            try:
                workers = int(os.environ.get(
                    "SEAWEEDFS_TPU_FILER_WORKERS", "") or 1)
            except ValueError:
                workers = 1
        refused = {
            f"-storeType {args.store_type}": args.store_type != "sqlite",
            f"-workers {workers}": workers != 1,
            "-notification": bool(args.notification),
            "-lockPeers": bool(args.lock_peers),
            "-metricsAddress": bool(args.metrics_address)}
        for flag, hit in refused.items():
            if hit:
                ap.error(f"filer {flag}: not ported yet (ROADMAP A, "
                         f"\"the rest of the filer\")")
        if args.meta_plane:
            os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = args.meta_plane
        try:
            fs = FilerServer(args.master, args.ip, args.port,
                             store_path=args.store,
                             collection=args.collection,
                             replication=args.replication)
        except ValueError as e:  # the meta plane over a :memory: store
            ap.error(f"filer: {e}")
        return _serve(fs, _listening("filer"))
    if args.cmd == "benchmark":
        import json
        from .benchmark import run_benchmark
        for r in run_benchmark(args.master, args.n, args.size, args.c):
            print(json.dumps(r))
        return 0
    if args.cmd == "upload":
        from . import operation
        with open(args.file, "rb") as f:
            data = f.read()
        print(operation.submit(args.master, data, name=args.file))
        return 0
    if args.cmd == "download":
        from . import operation
        sys.stdout.buffer.write(operation.read(args.master, args.fid))
        return 0
    from .shell import CommandEnv
    from .shell.commands import run_script
    for out in run_script(CommandEnv(args.master, filer=args.filer),
                          " ".join(args.command)):
        print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
