"""Command line of the port.

    python3 -m seaweedfs_tpu_torch [-securityToml security.toml] ROLE ...
    python3 -m seaweedfs_tpu_torch master [-ip 127.0.0.1] [-port 9333]
        [-volumeSizeLimitMB 1024] [-defaultReplication 000]
        [-peers HOST:PORT,HOST:PORT,...] [-mdir DIR]
        [-telemetry -telemetryUrl URL]
    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1] [-mserver HOST:PORT[,...]] [-device cuda] [-max 8]
        [-dataCenter DC] [-rack RACK] [-fsync]
    python3 -m seaweedfs_tpu_torch filer [-ip 127.0.0.1] [-port 8888]
        [-master HOST:PORT] [-store filer.db] [-collection C]
        [-replication 000] [-workers N] [-metaPlane 0|1]
    python3 -m seaweedfs_tpu_torch shell [-master HOST:PORT]
        [-filer HOST:PORT] ["lock; ec.encode -volumeId=1; unlock"]
    python3 -m seaweedfs_tpu_torch admin [-ip 127.0.0.1] [-port 23646]
        [-master HOST:PORT] [-detectionInterval 30] [-dataDir DIR]
    python3 -m seaweedfs_tpu_torch worker [-admin HOST:PORT]
        [-master HOST:PORT] [-dir DIR]
        [-capabilities erasure_coding,vacuum] [-device cuda]
    python3 -m seaweedfs_tpu_torch fix|compact|export -dir DIR
        -volumeId N [-collection C] [-o OUT.tar]
    python3 -m seaweedfs_tpu_torch benchmark [-master HOST:PORT]
        [-n 1000] [-size 1024] [-c 16]
    python3 -m seaweedfs_tpu_torch upload [-master HOST:PORT] FILE
    python3 -m seaweedfs_tpu_torch download [-master HOST:PORT] FID
    python3 -m seaweedfs_tpu_torch s3 [-ip 127.0.0.1] [-port 8333]
        [-filer HOST:PORT | -master HOST:PORT -store filer.db]
        [-accessKey AK -secretKey SK] [-iamConfig s3.json]
        [-kmsFile keys.json]
    python3 -m seaweedfs_tpu_torch cert [-dir certs]
        [-hosts 127.0.0.1,localhost]
    python3 -m seaweedfs_tpu_torch scaffold [-config security]

`-securityToml` (before the role) loads the reference's security.toml
into the process (`security.py`): `[jwt.signing]` and
`[jwt.signing.read]` keys gate needle writes and reads with per-fid
JWTs, `[admin] key` (or `[access] admin_key`) the admin paths,
`[access] white_list` admits IPs to them, and `[tls]` (`ca`, `cert`,
`key`, `mtls`) puts every listener and dial on TLS.  A `[qos]` section
configures QoS (a malformed one exits 2).  `cert` mints a
cluster CA and one node certificate for `[tls]` (it needs the
`cryptography` package); `scaffold -config security` prints a
commented security.toml.

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
hours; without them it sends nothing.  `master -peers a,b,c` starts one
member of an HA master set (raft, `server/raft.py`; each member is given
the same list, its own address among them, as `-ip`:`-port` spells it)
and `-mdir DIR` keeps its raft log, term and vote under `DIR/raft`, in
the JAX package's format, so a restarted set keeps its topology id and
issues no file key or volume id twice.  Every `-master` and `-mserver`
of the other roles takes such a list and follows the leader.  The volume server's codec runs
on the CUDA card, or on `-device cpu` when asked for.  A `-device cuda`
given on the command line must find the card at start, or the command
fails; left out, the card is first looked for by the first encode or
rebuild, which fails without one.  `shell` runs one `;`-separated command line
against `-master` (and `-filer`, for the `fs.*` commands), prints each
command's output and exits; with no command it reads lines at a `> `
prompt until `exit`, `quit` or the end of input.

`filer` starts a filer (`server/filer_server.py`) over the sqlite store
`-store` (a file, its metadata log in `<store>.metalog`, or `:memory:`)
whose files' chunks go to `-collection` on `-master`'s volumes, and
prints `filer listening on <ip>:<port>`.  Over a store file it runs the
meta plane (metalog as WAL, the store an async checkpoint) and the
native meta and read planes by default, in one process; `-metaPlane 0`
commits every mutation synchronously, and `-metaPlane 1` over a store
the plane cannot run on (`:memory:`) is refused.  `-workers N` (or
`SEAWEEDFS_TPU_FILER_WORKERS`) above 1 pre-forks N-1 sibling processes
on the same port (SO_REUSEPORT) and prints `filer pre-forked N-1
sibling workers on port P` after its listening line; a sibling that
exits is respawned (20 times at most), and SIGTERM stops the fleet.
`SEAWEEDFS_TPU_ASYNC_FRONT=filer` serves the filer on the asyncio front
(`server/async_front.py`).  A `-storeType` other than sqlite,
`-notification`, `-lockPeers` and `-metricsAddress` are refused, not
ported yet (ROADMAP).  A volume server and a filer run the SLO autopilot
(`autopilot.py`) unless `SEAWEEDFS_TPU_AUTOPILOT=0`; a fleet's parent
also registers the `workers` knob, between 1 and twice `-workers`
processes, which spawns and drains siblings under the monitor's lock.

`admin` starts the maintenance admin (`plugin/admin.py`) and prints
`admin listening on <ip>:<port>`; `worker` registers a maintenance
worker (`plugin/worker.py`) with `-admin` and prints `worker <id>
polling <admin>`.  Its `-capabilities` default to the JAX worker's,
`erasure_coding,vacuum`.  `erasure_coding` (or `ec`) encodes pulled
volumes on its `-device` (the card by default; `-device cuda` must find
it at start); `erasure_coding` and `ec_rebuild` bring the rebuild
handler; `vacuum` compacts volumes whose garbage passed 0.3;
`volume_balance` (or `balance`) and `ec_balance` even out volume counts
and EC shards across the servers.  Both serve until SIGTERM or SIGINT,
stop and exit 0.

`fix`, `compact` and `export` work on the files of a volume that no
server has open (weed fix, compact, export): `fix` rebuilds the `.idx`
from a scan of the `.dat`, `compact` vacuums it offline, and `export`
lists its live files, or writes them to the tar file `-o`.

`s3` starts the S3 gateway (`s3/s3_server.py`) over a running filer
(`-filer`, through `filer/client.py`) or an in-process filer over
`-master` and the sqlite `-store`, and prints `s3 gateway listening on
<ip>:<port>`.  Requests are signed with SigV4 against `-accessKey` /
`-secretKey` (every key acts as admin) or the identities of
`-iamConfig` (the reference's s3.json shape); `-kmsFile` is a local KMS
keystore that enables SSE-KMS.  `-stsKey`, `-rolesFile`,
`-kmsEndpoint`, `-kmsCloud`, `-metricsPort` and `-metricsAddress` are
refused (exit 2), not ported yet (ROADMAP A9).

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


def _serve(server, line, then=None, before_stop=None) -> int:
    """Start `server`, print `line(server)`, call `then(server)` if
    given, freeze the heap so far out of the cycle collector, and serve
    until SIGTERM or SIGINT; then call `before_stop()` if given, and stop
    the server."""
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
        try:
            if before_stop is not None:
                before_stop()
        finally:
            server.stop()
    return 0


def _listening(role: str):
    return lambda server: f"{role} listening on {server.url}"


SECURITY_SCAFFOLD = """\
# security.toml: pass it as -securityToml before the role
# (command/scaffold/security.toml layout)

[jwt.signing]
# per-fid write tokens minted by the master on assign
key = ""
expires_after_seconds = 10

[jwt.signing.read]
# optional read-token gate on the volume data path
key = ""
expires_after_seconds = 10

[admin]
# admin-plane key: guards /admin/*, /debug/*, heartbeats, grow, lock
key = ""

[access]
# IPs and CIDRs admitted to the admin plane without the admin JWT
white_list = []

# [tls]
# cluster-wide TLS/mTLS (security/tls.go; mint a PKI with
# `python3 -m seaweedfs_tpu_torch cert -dir certs`)
# ca = "certs/ca.crt"
# cert = "certs/node.crt"
# key = "certs/node.key"
# mtls = true"""


def _load_security(path: str) -> "str | None":
    """Configure the process from security.toml, and QoS from its `[qos]`
    section (tenant admission limits and the EC throttle's foreground
    SLO); an error message when the file cannot be used (a malformed
    `[qos]` included)."""
    from . import qos, security
    try:
        security.configure(security.load_security_toml(path))
        qos_cfg = qos.load_qos_toml(path)
    except (OSError, ValueError) as e:
        return f"-securityToml {path}: {e}"
    if qos_cfg is not None:
        qos.configure(qos_cfg)
    return None


def _s3(ap, args) -> int:
    """`s3`: the gateway over a running filer or an in-process one."""
    for flag in ("stsKey", "rolesFile", "kmsEndpoint", "kmsCloud",
                 "metricsPort", "metricsAddress"):
        if getattr(args, "refused_" + flag) is not None:
            print(f"s3 -{flag}: not ported yet (ROADMAP A9)",
                  file=sys.stderr)
            return 2
    from .s3 import S3ApiServer
    creds = {args.accessKey: args.secretKey} if args.accessKey else None
    iam_store = kms = None
    if args.iam_config:
        from .iam import IdentityStore
        iam_store = IdentityStore(args.iam_config)
    if args.kms_file:
        from .iam.kms import LocalKms
        kms = LocalKms(args.kms_file)
    if args.filer:
        from .filer.client import FilerClient
        backend = FilerClient(args.filer)
    else:
        from .filer import Filer
        from .filer.filer_store import SqliteStore
        backend = Filer(args.master, SqliteStore(args.store))
    suffix = f" (filer {args.filer})" if args.filer else ""
    return _serve(S3ApiServer(backend, args.ip, args.port,
                              credentials=creds, iam=iam_store, kms=kms),
                  lambda gw: f"s3 gateway listening on {gw.url}{suffix}")


# a sibling that keeps exiting is respawned this many times at most
WORKER_RESPAWNS = 20


class _Fleet:
    """A pre-fork filer's siblings: `cmd` started `workers - 1` times,
    each exit respawned by the monitor (`WORKER_RESPAWNS` at most), and
    the SLO autopilot's `workers` knob, which spawns and drains siblings.
    One lock, `lock`, is held by a respawn, by the knob and by the stop:
    once the stop has set `stopping`, no sibling starts that it would not
    stop, and the monitor never brings back one that the knob drained."""

    def __init__(self, cmd: "list[str]", workers: int):
        self.cmd = cmd
        self.workers = workers
        self.procs: list = []
        self.drained: "set[int]" = set()   # pids the knob stopped
        self.stopping = threading.Event()
        self.lock = threading.Lock()
        self.respawns = 0

    def _spawn(self):
        import subprocess
        p = subprocess.Popen(self.cmd)
        self.procs.append(p)
        return p

    def start(self) -> None:
        with self.lock:
            if self.stopping.is_set():
                return
            for _ in range(self.workers - 1):
                self._spawn()
        threading.Thread(target=self._monitor, daemon=True,
                         name="filer-worker-monitor").start()

    def _monitor(self) -> None:
        while not self.stopping.wait(2.0):
            self.monitor_once()

    def monitor_once(self) -> None:
        import subprocess
        with self.lock:
            if self.stopping.is_set():
                return
            for i, p in enumerate(self.procs):
                rc = p.poll()
                if rc is None or p.pid in self.drained:
                    continue
                print(f"filer worker pid={p.pid} exited rc={rc}",
                      file=sys.stderr, flush=True)
                if self.respawns >= WORKER_RESPAWNS:
                    continue
                self.respawns += 1
                self.procs[i] = subprocess.Popen(self.cmd)

    def _live(self) -> list:
        """The caller holds `lock`."""
        return [p for p in self.procs
                if p.poll() is None and p.pid not in self.drained]

    def size(self) -> float:
        """The fleet's processes, the parent included (the knob's
        value)."""
        with self.lock:
            return 1.0 + len(self._live())

    def scale(self, n: float) -> None:
        """The knob's setter: spawn or drain siblings to `n` processes."""
        want = max(0, int(round(n)) - 1)
        with self.lock:
            if self.stopping.is_set():
                return
            live = self._live()
            while len(live) < want:
                live.append(self._spawn())
            while len(live) > want:
                p = live.pop()
                self.drained.add(p.pid)
                p.terminate()

    def register_knob(self, ap) -> None:
        """The `workers` actuator, on the parent only: bounds [1, 2 x
        -workers], a 30 s cooldown that runs from the fleet's start (the
        operator's `-workers` is its first setting: the probe's first
        idle ticks, before any load, drain nothing)."""
        from .autopilot import Actuator
        act = ap.register(Actuator(
            "workers", get=self.size, set=self.scale, lo=1.0,
            hi=float(max(self.workers * 2, 2)), cooldown=30.0,
            describe="SO_REUSEPORT pre-fork filer processes (parent "
                     "included)"))
        act.last_actuated = ap.now()

    def stop(self) -> None:
        import subprocess
        with self.lock:
            self.stopping.set()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _filer(ap, args, argv: "list[str]") -> int:
    """`filer`, with its pre-fork fleet: `-workers N` (or
    `SEAWEEDFS_TPU_FILER_WORKERS`) above 1 re-executes this command line
    N-1 times as siblings (`-workers 0`) on the resolved port, every
    process binding it with SO_REUSEPORT, so the kernel spreads the
    connections.  The parent exports `SEAWEEDFS_TPU_TREE_ROOT` first, so
    any sibling's `/metrics` reports the fleet's process tree.  A
    sibling exits when its parent (that pid) is gone; the parent
    respawns a sibling that exited, `WORKER_RESPAWNS` times at most,
    and on SIGTERM stops them all, and respawns none, before its own
    server stops (`_Fleet`)."""
    import time
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
        "-notification": bool(args.notification),
        "-lockPeers": bool(args.lock_peers),
        "-metricsAddress": bool(args.metrics_address)}
    for flag, hit in refused.items():
        if hit:
            ap.error(f"filer {flag}: not ported yet (ROADMAP A, "
                     f"\"the rest of the filer\")")
    if workers < 0:
        ap.error(f"filer -workers {workers}: must be 0 or more")
    if args.meta_plane:
        # through the environment, so the siblings run the same mode
        os.environ["SEAWEEDFS_TPU_FILER_META_PLANE"] = args.meta_plane
    is_worker = workers == 0          # a spawned sibling

    def orphan_watch() -> None:
        # the parent that spawned this sibling exported its pid as the
        # tree's root; a sibling started by hand watches its own parent
        ppid = int(os.environ.get("SEAWEEDFS_TPU_TREE_ROOT", "")
                   or os.getppid())
        while os.getppid() == ppid:
            time.sleep(1.0)
        os._exit(0)

    if is_worker:
        # watched from the start: a sibling whose parent is gone by now
        # (or before the watch's first look) must not serve on
        threading.Thread(target=orphan_watch, daemon=True,
                         name="filer-orphan-watch").start()
    try:
        fs = FilerServer(args.master, args.ip, args.port,
                         store_path=args.store,
                         collection=args.collection,
                         replication=args.replication,
                         reuse_port=is_worker or workers > 1)
    except ValueError as e:  # the meta plane over a :memory: store
        ap.error(f"filer: {e}")
    # the command line of a sibling: this one, on the resolved port
    sibling = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("-port", "-workers"):
            skip = True
            continue
        sibling.append(a)
    sibling += ["-port", str(fs.http.port), "-workers", "0"]
    fl = _Fleet([sys.executable, "-m", "seaweedfs_tpu_torch"] + sibling,
                workers)

    def fleet(server) -> None:
        if is_worker or workers <= 1:
            return
        os.environ["SEAWEEDFS_TPU_TREE_ROOT"] = str(os.getpid())
        fl.start()
        print(f"filer pre-forked {workers - 1} sibling workers on port "
              f"{server.http.port}", flush=True)
        fl.register_knob(server.autopilot)

    try:
        return _serve(fs, _listening("filer"), fleet, fl.stop)
    finally:
        fl.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch")
    ap.add_argument("-securityToml", default="",
                    help="security.toml: JWT signing keys, admin key, "
                         "IP whitelist, TLS")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("master", help="start a master server")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-peers", default="",
                   help="the HA master set, host:port,... (this master "
                        "among them); none: a set of one")
    m.add_argument("-mdir", default="",
                   help="keep the raft log, term and vote under DIR/raft")
    m.add_argument("-telemetry", action="store_true",
                   help="opt-in anonymous cluster reports (default off)")
    m.add_argument("-telemetryUrl", default="",
                   help="collector URL for -telemetry")
    v = sub.add_parser("volume", help="start a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default=".", help="comma-separated data dirs")
    v.add_argument("-mserver", default="",
                   help="master host:port, or the HA set's comma-separated "
                        "list (none: no heartbeat)")
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
    wk.add_argument("-capabilities", default="erasure_coding,vacuum")
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
                    help="pre-fork worker processes on one port "
                         "(SO_REUSEPORT); default "
                         "SEAWEEDFS_TPU_FILER_WORKERS, else 1")
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
    s3p = sub.add_parser("s3", help="start the S3 gateway on a filer")
    s3p.add_argument("-ip", default="127.0.0.1")
    s3p.add_argument("-port", type=int, default=8333)
    s3p.add_argument("-master", default="127.0.0.1:9333")
    s3p.add_argument("-filer", default="",
                     help="attach to a running filer's namespace; "
                          "overrides -master and -store")
    s3p.add_argument("-store", default="filer.db")
    s3p.add_argument("-accessKey", default="")
    s3p.add_argument("-secretKey", default="")
    s3p.add_argument("-iamConfig", dest="iam_config", default="",
                     help="identities JSON (the s3.json shape); "
                          "supersedes -accessKey")
    s3p.add_argument("-kmsFile", dest="kms_file", default="",
                     help="local KMS keystore (enables SSE-KMS)")
    for flag in ("-stsKey", "-rolesFile", "-kmsEndpoint", "-kmsCloud",
                 "-metricsPort", "-metricsAddress"):
        s3p.add_argument(flag, dest="refused_" + flag[1:], default=None,
                         help="not ported (refused)")
    crt = sub.add_parser("cert", help="mint a cluster CA and node "
                         "certificate for the TLS plane")
    crt.add_argument("-dir", default="certs")
    crt.add_argument("-hosts", default="127.0.0.1,localhost",
                     help="comma-separated SAN hosts and IPs")
    sc = sub.add_parser("scaffold", help="print a commented template "
                        "config")
    sc.add_argument("-config", default="security", choices=["security"])
    for name, what in (("fix", "rebuild a volume's .idx from its .dat"),
                       ("compact", "vacuum a volume's files offline"),
                       ("export", "list or tar a volume's live files")):
        off = sub.add_parser(name, help=f"{what} (stop its volume server "
                                        f"first)")
        off.add_argument("-dir", required=True)
        off.add_argument("-volumeId", dest="volume_id", type=int,
                         required=True)
        off.add_argument("-collection", default="")
        if name == "export":
            off.add_argument("-o", dest="out", default="",
                             help="output .tar path (omit to list)")
    args = ap.parse_args(argv)

    if args.securityToml:
        err = _load_security(args.securityToml)
        if err:
            print(err, file=sys.stderr)
            return 2
    if args.cmd == "cert":
        try:
            from .tls import generate_cluster_certs
            paths = generate_cluster_certs(
                args.dir, [h.strip() for h in args.hosts.split(",")
                           if h.strip()])
        except ModuleNotFoundError as e:
            print(f"cert: needs the {e.name!r} module, which is not "
                  f"installed", file=sys.stderr)
            return 2
        print(f"wrote {paths['ca']}, {paths['cert']}, {paths['key']}")
        print("enable via security.toml:\n[tls]\n"
              f'ca = "{paths["ca"]}"\ncert = "{paths["cert"]}"\n'
              f'key = "{paths["key"]}"\nmtls = true')
        return 0
    if args.cmd == "scaffold":
        print(SECURITY_SCAFFOLD)
        return 0
    if args.cmd == "s3":
        return _s3(ap, args)

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
                default_replication=args.defaultReplication,
                peers=args.peers or None, meta_dir=args.mdir or None),
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
        from .plugin import PluginWorker
        handlers = _worker_handlers(args.capabilities.split(","),
                                    args.device or "cuda")
        if not handlers:
            ap.error(f"no handler for -capabilities {args.capabilities}; "
                     f"known: erasure_coding, ec_rebuild, vacuum, "
                     f"volume_balance, ec_balance")
        return _serve(PluginWorker(args.admin, args.master, args.dir,
                                   handlers),
                      lambda w: f"worker {w.worker_id} polling {w.admin}")
    if args.cmd in ("fix", "compact", "export"):
        return _offline_tool(args)
    if args.cmd == "filer":
        return _filer(ap, args,
                      sys.argv[1:] if argv is None else list(argv))
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
    env = CommandEnv(args.master, filer=args.filer)
    if not args.command:
        return _repl(env)
    for out in run_script(env, " ".join(args.command)):
        print(out, flush=True)
    return 0


def _repl(env) -> int:
    """The shell's prompt: a `;`-separated line at a time, until `exit`,
    `quit` or the end of input; a failed command prints its error and
    the prompt goes on."""
    from .shell.commands import run_script
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print(flush=True)
            return 0
        if line in ("exit", "quit"):
            return 0
        if not line:
            continue
        try:
            for out in run_script(env, line):
                print(out, flush=True)
        except Exception as e:  # noqa: BLE001 — the prompt survives
            print(f"error: {e}", flush=True)


def _worker_handlers(caps: "list[str]", device: str) -> list:
    """The handlers of a worker's capabilities, in the JAX worker's order
    (seaweedfs_tpu/__main__.py:893-913)."""
    from .plugin.handlers import (EcBalanceHandler, EcEncodeHandler,
                                  EcRebuildHandler, VacuumHandler,
                                  VolumeBalanceHandler)
    want = set(caps)
    handlers = []
    if {"erasure_coding", "ec"} & want:
        handlers.append(EcEncodeHandler(device=device))
    if {"erasure_coding", "ec", "ec_rebuild"} & want:
        handlers.append(EcRebuildHandler())
    if "vacuum" in want:
        handlers.append(VacuumHandler())
    if {"volume_balance", "balance"} & want:
        handlers.append(VolumeBalanceHandler())
    if "ec_balance" in want:
        handlers.append(EcBalanceHandler())
    return handlers


def _offline_tool(args) -> int:
    """weed fix / compact / export over the files of an unmounted volume:
    pure Python over `Volume` and `walk_dat`, as in the JAX package."""
    from .storage.volume import Volume
    name = (f"{args.collection}_" if args.collection else "") + \
        f"{args.volume_id}"
    base = os.path.join(args.dir, name)
    if not os.path.exists(base + ".dat"):
        # Volume() would create an empty volume there
        print(f"no {base}.dat", file=sys.stderr)
        return 1
    if args.cmd == "fix":
        # replay the .dat into a fresh .idx: writes put, tombstones delete
        from .storage import idx as idxmod
        from .storage import types
        from .storage.volume import walk_dat
        tmp = base + ".idx.fix"
        n_writes = n_dels = 0
        with open(tmp, "wb") as f:
            for needle, off in walk_dat(base + ".dat"):
                if needle.data:
                    f.write(idxmod.entry_bytes(
                        needle.id, types.to_stored_offset(off), needle.size))
                    n_writes += 1
                else:
                    f.write(idxmod.entry_bytes(
                        needle.id, 0, types.TOMBSTONE_FILE_SIZE))
                    n_dels += 1
        os.replace(tmp, base + ".idx")
        print(f"fixed {base}.idx: {n_writes} writes, {n_dels} tombstones")
        return 0
    v = Volume(args.dir, args.volume_id, collection=args.collection)
    try:
        if args.cmd == "compact":
            before, garbage = v.dat_size(), v.garbage_level()
            v.vacuum()
            print(f"compacted volume {args.volume_id}: {before} -> "
                  f"{v.dat_size()} bytes (garbage was {garbage:.0%})")
            return 0
        import io
        import tarfile
        tar = tarfile.open(args.out, "w") if args.out else None
        count = 0
        for key, stored_off, size in sorted(v.nm.items()):
            n = v._read_at(stored_off, size)
            fname = f"{key:x}"
            if n.has_name():
                fname += "_" + n.name.decode("utf-8", "replace")
            if tar is None:
                mime = n.mime.decode("utf-8", "replace") \
                    if n.has_mime() else "-"
                print(f"{fname}\t{len(n.data)}\t{mime}")
            else:
                info = tarfile.TarInfo(fname)
                info.size = len(n.data)
                info.mtime = n.last_modified or 0
                tar.addfile(info, io.BytesIO(n.data))
            count += 1
        if tar is not None:
            tar.close()
            print(f"exported {count} files to {args.out}")
        else:
            print(f"{count} live files in volume {args.volume_id}")
        return 0
    finally:
        v.close()


if __name__ == "__main__":
    sys.exit(main())
