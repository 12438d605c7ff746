"""Command line of the port.

    python3 -m seaweedfs_tpu_torch master [-ip 127.0.0.1] [-port 9333]
        [-volumeSizeLimitMB 1024] [-telemetry -telemetryUrl URL]
    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1] [-mserver HOST:PORT] [-device cuda]
    python3 -m seaweedfs_tpu_torch shell [-master HOST:PORT]
        ["lock; ec.encode -volumeId=1; unlock"]
    python3 -m seaweedfs_tpu_torch admin [-ip 127.0.0.1] [-port 23646]
        [-master HOST:PORT] [-detectionInterval 30] [-dataDir DIR]
    python3 -m seaweedfs_tpu_torch worker [-admin HOST:PORT]
        [-master HOST:PORT] [-dir DIR]
        [-capabilities erasure_coding,ec_rebuild] [-device cuda]

`master` starts the master (`server/master_server.py`) and `volume` a
volume server (`server/volume_server.py`) that heartbeats to
`-mserver` (without it, the server has no master).  Each prints
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
against `-master`, prints each command's output and exits.

`admin` starts the maintenance admin (`plugin/admin.py`) and prints
`admin listening on <ip>:<port>`; `worker` registers a maintenance
worker (`plugin/worker.py`) with `-admin` and prints `worker <id>
polling <admin>`.  The worker's `erasure_coding` capability encodes
pulled volumes on its `-device` (the card by default; `-device cuda`
must find it at start), and both `erasure_coding` and `ec_rebuild`
bring the rebuild handler.  Both serve until SIGTERM or SIGINT, stop
and exit 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import threading


def _serve(server, line, then=None) -> int:
    """Start `server`, print `line(server)`, call `then(server)` if
    given, and serve until SIGTERM or SIGINT."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(line(server), flush=True)
    if then is not None:
        then(server)
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
    sh = sub.add_parser("shell", help="run shell commands")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("command", nargs="*",
                    help="one `;`-separated command line")
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
                volume_size_limit_mb=args.volumeSizeLimitMB),
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
            device=args.device or "cuda", master=args.mserver),
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
    from .shell import CommandEnv
    from .shell.commands import run_script
    for out in run_script(CommandEnv(args.master), " ".join(args.command)):
        print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
