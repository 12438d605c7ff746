"""Command line of the port.

    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1]

`volume` starts a volume server with the EC admin routes
(`server/volume_server.py`), prints `volume server listening on
<ip>:<port>` on one line (`-port 0` takes a free port), and serves until
SIGTERM or SIGINT, when it stops cleanly and exits 0.  Its codec runs on
the CUDA card.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default=".", help="comma-separated data dirs")
    args = ap.parse_args(argv)

    from .server.volume_server import VolumeServer
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    vs = VolumeServer(args.dir.split(","), host=args.ip,
                      port=args.port).start()
    print(f"volume server listening on {vs.url}", flush=True)
    try:
        stop.wait()
    finally:
        vs.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
