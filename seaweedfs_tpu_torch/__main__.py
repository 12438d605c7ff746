"""Command line of the port.

    python3 -m seaweedfs_tpu_torch master [-ip 127.0.0.1] [-port 9333]
        [-volumeSizeLimitMB 1024]
    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1] [-mserver HOST:PORT] [-device cuda]
    python3 -m seaweedfs_tpu_torch shell [-master HOST:PORT]
        ["lock; ec.encode -volumeId=1; unlock"]

`master` starts the master (`server/master_server.py`) and `volume` a
volume server (`server/volume_server.py`) that heartbeats to
`-mserver` (without it, the server has no master).  Each prints
`<role> server listening on <ip>:<port>` on its first line (`-port 0`
takes a free port) and serves until SIGTERM or SIGINT, when it stops
cleanly and exits 0.  The volume server's codec runs on the CUDA card,
or on `-device cpu` when asked for.  A `-device cuda` given on the
command line must find the card at start, or the command fails; left
out, the card is first looked for by the first encode or rebuild,
which fails without one.  `shell` runs one `;`-separated command line
against `-master`, prints each command's output and exits.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _serve(server, role: str) -> int:
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(f"{role} server listening on {server.url}", flush=True)
    try:
        stop.wait()
    finally:
        server.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("master", help="start a master server")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default=".", help="comma-separated data dirs")
    v.add_argument("-mserver", default="",
                   help="master host:port (none: no heartbeat)")
    v.add_argument("-device", default=None,
                   help="codec device: cuda (the default) or cpu")
    sh = sub.add_parser("shell", help="run shell commands")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("command", nargs="*",
                    help="one `;`-separated command line")
    args = ap.parse_args(argv)

    if args.cmd == "master":
        from .server.master_server import MasterServer
        return _serve(MasterServer(
            args.ip, args.port,
            volume_size_limit_mb=args.volumeSizeLimitMB), "master")
    if args.cmd == "volume":
        if args.device is not None:
            from .ops.rs_torch import _resolve_device
            _resolve_device(args.device)  # raises without the card
        from .server.volume_server import VolumeServer
        return _serve(VolumeServer(
            args.dir.split(","), host=args.ip, port=args.port,
            device=args.device or "cuda", master=args.mserver), "volume")
    from .shell import CommandEnv
    from .shell.commands import run_script
    for out in run_script(CommandEnv(args.master), " ".join(args.command)):
        print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
