"""Command line of the port.

    python3 -m seaweedfs_tpu_torch [-securityToml security.toml]
        [-v LEVEL] [-logdir DIR] [-logJson] ROLE ...
    python3 -m seaweedfs_tpu_torch master [-ip 127.0.0.1] [-port 9333]
        [-volumeSizeLimitMB 1024] [-defaultReplication 000]
        [-peers HOST:PORT,HOST:PORT,...] [-mdir DIR]
        [-telemetry -telemetryUrl URL]
        [-metricsAddress HOST:PORT [-metricsIntervalSec 15]]
    python3 -m seaweedfs_tpu_torch volume -dir DIR[,DIR...] [-port 8080]
        [-ip 127.0.0.1] [-mserver HOST:PORT[,...]] [-device cuda] [-max 8]
        [-dataCenter DC] [-rack RACK] [-fsync] [-memoryMapMaxSizeMb MB]
        [-tierBackend ENDPOINT,BUCKET[,ACCESSKEY,SECRETKEY]]
        [-metricsAddress HOST:PORT [-metricsIntervalSec 15]]
    python3 -m seaweedfs_tpu_torch server [-ip 127.0.0.1] [-dir .]
        [-master.port 9333] [-master.volumeSizeLimitMB 1024]
        [-volume.port 8080] [-device cuda]
        [-tierBackend ENDPOINT,BUCKET[,ACCESSKEY,SECRETKEY]]
        [-filer [-filer.port 8888]]
        [-s3 [-s3.port 8333] [-s3.accessKey AK -s3.secretKey SK]]
    python3 -m seaweedfs_tpu_torch filer [-ip 127.0.0.1] [-port 8888]
        [-master HOST:PORT] [-store filer.db] [-collection C]
        [-storeType sqlite|lsm|redis|elastic] [-replication 000]
        [-workers N] [-metaPlane 0|1] [-notification SPEC]
        [-lockPeers HOST:PORT,...]
        [-metricsAddress HOST:PORT [-metricsIntervalSec 15]]
    python3 -m seaweedfs_tpu_torch filer.sync -from HOST:PORT -to HOST:PORT
        [-state FILE] [-interval 0.5]
    python3 -m seaweedfs_tpu_torch filer.backup -filer HOST:PORT -dir DIR
        [-state FILE] [-interval 0.5]
    python3 -m seaweedfs_tpu_torch filer.backup.s3 -filer HOST:PORT
        -endpoint HOST:PORT -bucket B [-accessKey AK -secretKey SK]
        [-prefix P] [-state FILE] [-interval 0.5]
    python3 -m seaweedfs_tpu_torch filer.remote.sync -filer HOST:PORT
        -dir /MOUNTED [-state FILE] [-interval 0.5]
    python3 -m seaweedfs_tpu_torch filer.meta.tail [-filer HOST:PORT]
        [-sinceNs N] [-pathPrefix /P] [-interval 1.0] [-once]
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
        [-stsKey KEY [-rolesFile roles.json]]
        [-kmsFile keys.json | -kmsEndpoint HOST:PORT[,AK,SK[,REGION]]
         | -kmsCloud gcp|azure|openbao:ENDPOINT,KEY,TOKEN]
        [-metricsPort P] [-metricsAddress HOST:PORT [-metricsIntervalSec 15]]
    python3 -m seaweedfs_tpu_torch iam -iamConfig s3.json [-ip 127.0.0.1]
        [-port 8111] [-stsKey KEY [-rolesFile roles.json]
        [-oidcConfig providers.json]]
    python3 -m seaweedfs_tpu_torch webdav [-ip 127.0.0.1] [-port 7333]
        [-filer HOST:PORT]
    python3 -m seaweedfs_tpu_torch sftp -userStoreFile users.json
        [-ip 127.0.0.1] [-port 2022] [-filer HOST:PORT] [-hostKeyFile PEM]
        [-authMethods password,publickey] [-banner TEXT]
        [-ldapServer HOST:PORT [-ldapUserDnTemplate uid={},ou=people,...
         | -ldapBaseDn DN [-ldapBindDn DN -ldapBindPassword PW]] [-ldapTls]]
    python3 -m seaweedfs_tpu_torch sftp.user -store users.json
        add|delete|list [-name N] [-password PW] [-home DIR]
        [-pubkey 'ssh-ed25519 B64'] [-perm PATH:PERM,PERM ...]
    python3 -m seaweedfs_tpu_torch mount -dir MOUNTPOINT [-filer HOST:PORT]
    python3 -m seaweedfs_tpu_torch version
    python3 -m seaweedfs_tpu_torch cert [-dir certs]
        [-hosts 127.0.0.1,localhost]
    python3 -m seaweedfs_tpu_torch scaffold
        [-config security|filer|notification|replication]

`-v LEVEL` (or `WEED_V`), `-logdir DIR` and `-logJson` (before the
role) set the log (`util/wlog.py`): `V(n)` gates detail at or under
LEVEL, every line goes to stderr and, with `-logdir`, to
`DIR/weed.log` too (rotated at 64 MiB, three old files kept), as one
JSON object a line with `-logJson`, and a line logged inside a request
carries its request id (`X-Request-ID`).  Every `WEED_*` environment
default that replaced a flag's default is logged as an `env override`
line.

`webdav`, `sftp` and `mount` attach to a running filer (`-filer`)
through `filer/client.FilerClient`, as the reference's `weed webdav`,
`weed sftp` and `weed mount` do, and import no torch.  `webdav` prints
`webdav on <ip>:<port> serving filer <filer>` and `sftp` `sftp on
<ip>:<port> serving filer <filer>`; both serve until SIGTERM.  `sftp`
authenticates against the JSON user store that `sftp.user` edits
(`password`, `passwordSha256`, `publicKeys`, `permissions`) and, for a
user who is not in it, by a bind to `-ldapServer`; `-hostKeyFile` is an
ed25519 PEM, made and saved if missing.  `mount` serves the filer's
namespace through libfuse 2.9 at `-dir` until `fusermount -u`.

`-securityToml` (before the role) loads the reference's security.toml
into the process (`security.py`): `[jwt.signing]` and
`[jwt.signing.read]` keys gate needle writes and reads with per-fid
JWTs, `[admin] key` (or `[access] admin_key`) the admin paths,
`[access] white_list` admits IPs to them, and `[tls]` (`ca`, `cert`,
`key`, `mtls`) puts every listener and dial on TLS.  A `[qos]` section
configures QoS (a malformed one exits 2).  `cert` mints a
cluster CA and one node certificate for `[tls]` (it needs the
`cryptography` package); `scaffold -config security` prints a
commented security.toml, and `-config filer|notification|replication`
the filer's, the notification's and filer.backup's templates.

Every flag of every command may be defaulted from the environment as
`WEED_<COMMAND>_<FLAG>` (`WEED_FILER_STORETYPE=lsm`; dots and dashes as
underscores), as the reference's viper layer does
(`util/config.apply_env_defaults`); a flag on the command line wins.

`master` starts the master (`server/master_server.py`) and `volume` a
volume server (`server/volume_server.py`) that heartbeats to
`-mserver` (without it, the server has no master), reporting `-max`
volume slots and its `-dataCenter` and `-rack`, which the master's
placement of new volumes reads.  `-fsync` puts the volume server on
the power-loss tier: a write or delete is acked after an fsync of its
`.dat`, one fsync a group-commit window.  `-memoryMapMaxSizeMb MB`
serves needle reads of volumes up to MB from a read-only map of the
`.dat` (0, the default, reads through the file handle).  `-tierBackend
ENDPOINT,BUCKET[,AK,SK]` registers the S3 backend "default" (the bucket
`tier` if none is given), so the server mounts at start the volumes
that `volume.tier.move` (or `.upload`) put there; without it such a
volume is left out with a line on stderr.  The master grows volumes of
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
rebuild, which fails without one.  `-metricsAddress` on `master`,
`volume`, `filer` and `s3` PUTs the role's registry to a Prometheus
pushgateway every `-metricsIntervalSec` seconds
(`stats.MetricsPusher`; `pushing metrics to ...` printed after the
listening line); a failed push is logged and retried at the next tick,
never fatal.

`server` runs a master, a volume server on `-dir` (its codec on
`-device`, the card by default), and with `-filer` or `-s3` a filer
over the sqlite store `DIR/filer.db`, and with `-s3` an S3 gateway on
it (signed with `-s3.accessKey`/`-s3.secretKey`, unsigned without), all
in one process, started in that order; it prints `master on URL,
volume on URL`, then `filer on URL` and `s3 on URL`, as the JAX
package's `server` does, and stops them in the reverse order on
SIGTERM or SIGINT.  `-master.volumeSizeLimitMB` (the reference's `weed
server` flag; the JAX `server` has none) sets the master's volume size
limit; `-tierBackend` registers the volume server's S3 tier backend,
as `volume`'s does.  `version` prints
`seaweedfs-tpu-torch <version> (python <version>)`.

`shell` runs one `;`-separated command line
against `-master` (and `-filer`, for the `fs.*` commands), prints each
command's output and exits; with no command it reads lines at a `> `
prompt until `exit`, `quit` or the end of input.

`filer` starts a filer (`server/filer_server.py`) over the store
`-store` of `-storeType`: sqlite (a file, its metadata log in
`<store>.metalog`, or `:memory:`; the default), lsm (a directory, the
reference's leveldb2 shape), redis (the host:port of a RESP server) or
elastic (of an ES-wire server); its files' chunks go to `-collection`
on `-master`'s volumes, and it prints `filer listening on
<ip>:<port>`.  Without `-store`/`-storeType` on the command line, the
first enabled store of a `filer.toml` in ./, ~/.seaweedfs/ or
/etc/seaweedfs/ is used, and without `-notification` the first enabled
sink of a `notification.toml` there.  Over a local store (a sqlite
file, an lsm directory) it runs the meta plane (metalog as WAL, the
store an async checkpoint) and the native meta and read planes by
default, in one process; `-metaPlane 0` commits every mutation
synchronously, and `-metaPlane 1` over `:memory:` is refused (over
redis or elastic, which the plane never runs on, every mutation commits
synchronously, as in the JAX filer).  `-notification` publishes
every metadata event, at least once, to `webhook:URL`,
`logfile:PATH`, `sqs:QUEUE_URL` or `pubsub:ENDPOINT/projects/P/topics/T`
(`mq:` and `kafka:` are refused, exit 2: not ported yet); `-lockPeers`
names the filers of the lock ring, this one among them (refused
otherwise).  `-workers N` (or
`SEAWEEDFS_TPU_FILER_WORKERS`) above 1 pre-forks N-1 sibling processes
on the same port (SO_REUSEPORT) and prints `filer pre-forked N-1
sibling workers on port P` after its listening line; a sibling that
exits is respawned (20 times at most), and SIGTERM stops the fleet.
`SEAWEEDFS_TPU_ASYNC_FRONT=filer` serves the filer on the asyncio front
(`server/async_front.py`).  `-workers` over a store other than sqlite
warns and runs one process, as the JAX filer does.  A volume server
and a filer run
the SLO autopilot (`autopilot.py`) unless `SEAWEEDFS_TPU_AUTOPILOT=0`;
a fleet's parent also registers the `workers` knob, between 1 and twice
`-workers` processes, which spawns and drains siblings under the
monitor's lock.

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
keystore that enables SSE-KMS; `-kmsEndpoint` speaks the AWS KMS wire
protocol to an endpoint instead (`iam/kms_aws.py`), and `-kmsCloud` to
GCP KMS, Azure Key Vault or OpenBao transit (`iam/kms_cloud.py`; an
unknown provider exits 2).  `-stsKey` honours temporary credentials
(`x-amz-security-token`) minted under the same key by an `iam` server,
whose roles `-rolesFile` holds (`iam/sts.py`).  `-metricsPort` serves
the per-bucket metrics on a listener of their own too.

`iam` serves the IAM API (`iam/iamapi.py`: users, access keys, inline
policies) and STS `AssumeRole` over HTTP on `-port`, over the
identities JSON `-iamConfig` that gateways share; with `-stsKey`
(and `-rolesFile`) it mints temporary credentials, and `-oidcConfig`, a
JSON list of `{name, issuer, audience?, hs256Secret? |
rsaPublicKeyFile?}`, adds `AssumeRoleWithWebIdentity` (`iam/oidc.py`;
without `-stsKey` it exits 2).  It prints `oidc provider NAME (ISSUER)`
for each provider, then `iam api on <ip>:<port>`.

`filer.sync` replicates `-from`'s namespace and content to `-to`,
event by event from its metadata log, `filer.backup` mirrors a
filer into the local directory `-dir` and `filer.backup.s3` into the
bucket `-bucket` of the S3 API at `-endpoint` (under `-prefix`; SigV4
with `-accessKey`/`-secretKey`; the bucket is made if missing); each
keeps its offset in
`-state` (a name derived from its ends by default), advanced after an
event is applied, and runs until SIGTERM or SIGINT.
`filer.remote.sync` pushes local changes under a remote-mounted
directory back to its S3 store.  `filer.meta.tail` prints the metadata
events from `-sinceNs` (0: from now; with `-once`, from the start) as
JSON lines, under `-pathPrefix`; `-once` drains the backlog and exits.

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


def _serve(server, line, then=None, before_stop=None, push=None) -> int:
    """Start `server`, print `line(server)`, start the metrics pusher that
    `push`, (args, job), asks for, call `then(server)` if given, freeze
    the heap so far out of the cycle collector, and serve until SIGTERM
    or SIGINT; then call `before_stop()` if given, and stop the pusher
    and the server."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(line(server), flush=True)
    pusher = _metrics_pusher(server, *push) if push else None
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
            if pusher is not None:
                pusher.stop()
            server.stop()
    return 0


def _metrics_pusher(server, args, job: str):
    """With `-metricsAddress`, push `server`'s registry to the gateway
    every `-metricsIntervalSec` (`stats.MetricsPusher`) and say so, as
    the JAX roles do (the volume server's line names no interval);
    None without it."""
    if not args.metrics_address:
        return None
    from .stats import MetricsPusher
    pusher = MetricsPusher(server.metrics, job, server.url,
                           args.metrics_address,
                           args.metrics_interval).start()
    every = "" if job == "volume_server" else \
        f" every {args.metrics_interval}s"
    print(f"pushing metrics to {args.metrics_address}{every}", flush=True)
    return pusher


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


FILER_SCAFFOLD = """\
# filer.toml — place in ./, ~/.seaweedfs/, or /etc/seaweedfs/
# the first ENABLED section picks the filer's metadata store
# (command/scaffold/filer.toml layout; archetype mapping in
# seaweedfs_tpu_torch/util/config.py)

[sqlite]
enabled = true
dbFile = "filer.db"           # or ":memory:"

[leveldb2]
# embedded ordered-KV (our LSM store — the reference's default)
enabled = false
dir = "./filerldb2"

[redis2]
# any RESP2 server (hand-rolled client, filer/redis_store.py)
enabled = false
address = "localhost:6379"

[elastic7]
# any ES-wire JSON-HTTP server (filer/elastic_store.py)
enabled = false
servers = ["http://localhost:9200"]\
"""

NOTIFICATION_SCAFFOLD = """\
# notification.toml — metadata-event publishing
# (command/scaffold/notification.toml layout; the first enabled
# sink becomes the filer's -notification spec)

[notification.webhook]
enabled = false
url = "http://localhost:9000/events"

[notification.kafka]
enabled = false
hosts = ["localhost:9092"]
topic = "seaweedfs_meta"

[notification.log]
enabled = false
path = "filer_events.log"

[notification.mq]
enabled = false
broker = "localhost:17777"
namespace = "notifications"
topic = "filer_meta"\
"""

REPLICATION_SCAFFOLD = """\
# replication.toml — filer.backup sink selection
# (command/scaffold/replication.toml layout; the first enabled
# [sink.*] section drives filer.backup)

[sink.local]
enabled = false
directory = "/backup"

[sink.s3]
enabled = false
endpoint = "localhost:8333"
bucket = "backup"
aws_access_key_id = ""
aws_secret_access_key = ""

[sink.gcs]
enabled = false
bucket = "backup"

[sink.azure]
enabled = false
container = "backup"

[sink.backblaze]
enabled = false
bucket = "backup"\
"""

SCAFFOLDS = {"security": SECURITY_SCAFFOLD, "filer": FILER_SCAFFOLD,
             "notification": NOTIFICATION_SCAFFOLD,
             "replication": REPLICATION_SCAFFOLD}


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
        from .util import wlog
        wlog.info("qos config loaded from %s", path, component="config")
    return None


def _kms(args):
    """The gateway's KMS provider: `-kmsCloud`, else `-kmsEndpoint`, else
    `-kmsFile` (seaweedfs_tpu/__main__.py's order); None without one.
    Raises ValueError for an unknown `-kmsCloud` provider."""
    if args.kms_cloud:
        from .iam import kms_cloud
        kind, _, rest = args.kms_cloud.partition(":")
        parts = rest.split(",")
        ctor = {"gcp": kms_cloud.GcpKms, "azure": kms_cloud.AzureKms,
                "openbao": kms_cloud.OpenBaoKms}.get(kind)
        if ctor is None:
            raise ValueError(f"unknown -kmsCloud provider {kind!r}")
        return ctor(parts[0], parts[1] if len(parts) > 1 else "",
                    token=parts[2] if len(parts) > 2 else "")
    if args.kms_endpoint:
        from .iam.kms_aws import AwsKms
        parts = args.kms_endpoint.split(",")
        return AwsKms(parts[0], parts[1] if len(parts) > 1 else "",
                      parts[2] if len(parts) > 2 else "",
                      parts[3] if len(parts) > 3 else "us-east-1")
    if args.kms_file:
        from .iam.kms import LocalKms
        return LocalKms(args.kms_file)
    return None


def _s3(ap, args) -> int:
    """`s3`: the gateway over a running filer or an in-process one."""
    from .s3 import S3ApiServer
    creds = {args.accessKey: args.secretKey} if args.accessKey else None
    iam_store = sts = None
    if args.iam_config:
        from .iam import IdentityStore
        iam_store = IdentityStore(args.iam_config)
    if args.sts_key:
        from .iam import StsService
        from .iam.sts import RoleStore
        sts = StsService(args.sts_key, RoleStore(args.roles_file or None))
    try:
        kms = _kms(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    if args.filer:
        from .filer.client import FilerClient
        backend = FilerClient(args.filer)
    else:
        from .filer import Filer
        from .filer.filer_store import SqliteStore
        backend = Filer(args.master, SqliteStore(args.store))
    suffix = f" (filer {args.filer})" if args.filer else ""

    def line(gw) -> str:
        metrics = f" (metrics {gw.metrics_http.url}/metrics)" \
            if gw.metrics_http is not None else ""
        return f"s3 gateway listening on {gw.url}{suffix}{metrics}"
    return _serve(S3ApiServer(backend, args.ip, args.port,
                              credentials=creds, iam=iam_store, sts=sts,
                              kms=kms, metrics_port=args.metrics_port),
                  line, push=(args, "s3"))


class _AllInOne:
    """`server`: a master, a volume server and, with `-filer` or `-s3`,
    a filer and an S3 gateway in one process, started in dependency
    order (command/mini.go) and stopped in the reverse order."""

    def __init__(self, args):
        self.args = args
        self.parts: list = []

    def start(self) -> "_AllInOne":
        from .server.master_server import MasterServer
        from .server.volume_server import VolumeServer
        a = self.args
        self.master = MasterServer(
            a.ip, a.master_port,
            volume_size_limit_mb=a.volume_size_limit_mb).start()
        self.parts.append(self.master)
        self.volume = VolumeServer([a.dir], host=a.ip, port=a.volume_port,
                                   device=a.device or "cuda",
                                   master=self.master.url).start()
        self.parts.append(self.volume)
        self.lines = [f"master on {self.master.url}, volume on "
                      f"{self.volume.url}"]
        if a.filer or a.s3:
            from .server.filer_server import FilerServer
            self.filer = FilerServer(
                self.master.url, a.ip, a.filer_port,
                store_path=os.path.join(a.dir, "filer.db")).start()
            self.parts.append(self.filer)
            self.lines.append(f"filer on {self.filer.url}")
            if a.s3:
                from .s3 import S3ApiServer
                creds = {a.s3_access: a.s3_secret} if a.s3_access \
                    else None
                self.s3 = S3ApiServer(self.filer.filer, a.ip, a.s3_port,
                                      credentials=creds).start()
                self.parts.append(self.s3)
                self.lines.append(f"s3 on {self.s3.url}")
        return self

    def stop(self) -> None:
        while self.parts:
            self.parts.pop().stop()


def _server(args) -> int:
    if args.tierBackend:
        from .storage.backend import configure_from_flag
        configure_from_flag(args.tierBackend)
    if args.device is not None:
        from .ops.rs_torch import _resolve_device
        _resolve_device(args.device)  # raises without the card
    return _serve(_AllInOne(args), lambda s: "\n".join(s.lines))


def _iam(ap, args) -> int:
    """`iam`: the IAM API and STS over HTTP (`iam/iamapi.py`)."""
    import json
    from .iam import IdentityStore, StsService
    from .iam.iamapi import IamApiServer
    from .iam.sts import RoleStore
    store = IdentityStore(args.iam_config)
    sts = StsService(args.sts_key, RoleStore(args.roles_file or None)) \
        if args.sts_key else None
    if args.oidc_config and sts is None:
        ap.error("-oidcConfig requires -stsKey (web identities mint STS "
                 "credentials)")
    if sts is not None and args.oidc_config:
        from .iam.oidc import OidcProvider
        with open(args.oidc_config) as f:
            providers = json.load(f)
        for cfg in providers:
            pems = []
            if cfg.get("rsaPublicKeyFile"):
                with open(cfg["rsaPublicKeyFile"], "rb") as kf:
                    pems.append(kf.read())
            sts.add_provider(OidcProvider(
                cfg["name"], cfg["issuer"], cfg.get("audience", ""),
                rsa_public_keys_pem=pems,
                hs256_secret=cfg.get("hs256Secret", "")))
            print(f"oidc provider {cfg['name']} ({cfg['issuer']})",
                  flush=True)
    return _serve(IamApiServer(store, sts, args.ip, args.port),
                  lambda srv: f"iam api on {srv.url}")


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
                from .util import wlog
                wlog.warning(f"filer worker pid={p.pid} exited rc={rc}",
                             component="filer")
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
    from . import notification as notify
    from .server.filer_server import FilerServer
    from .util import wlog
    from .util.config import (filer_store_from_toml, find_toml,
                              notification_from_toml)
    workers = args.workers
    if workers is None:
        try:
            workers = int(os.environ.get(
                "SEAWEEDFS_TPU_FILER_WORKERS", "") or 1)
        except ValueError:
            workers = 1
    if workers < 0:
        ap.error(f"filer -workers {workers}: must be 0 or more")
    # the scaffold TOMLs stand in for the flags' defaults only: a
    # -store/-storeType or -notification on the command line wins
    store_type, store_path = args.store_type, args.store
    toml_path = find_toml("filer.toml")
    if toml_path and store_type == "sqlite" and store_path == "filer.db":
        picked = filer_store_from_toml(toml_path)
        if picked:
            store_type, store_path = picked
            wlog.info("filer store from %s: %s %s", toml_path,
                      store_type, store_path, component="config")
    spec = args.notification
    ntoml = find_toml("notification.toml")
    if ntoml and not spec:
        spec = notification_from_toml(ntoml)
        if spec:
            wlog.info("notification from %s: %s", ntoml, spec,
                      component="config")
    if spec:
        try:
            notify.from_spec(spec).close()
        except ValueError as e:    # an unknown kind, or mq: / kafka:
            ap.error(f"filer: {e}")
    if workers > 1 and store_type != "sqlite":
        wlog.warning("filer -workers needs the sqlite store (shared WAL + "
                     "metalog); running 1 process", component="filer")
        workers = 1
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
                         store_path=store_path,
                         collection=args.collection,
                         replication=args.replication,
                         store_type=store_type, notification=spec,
                         lock_peers=[p.strip() for p in
                                     args.lock_peers.split(",")
                                     if p.strip()],
                         reuse_port=is_worker or workers > 1)
    except (ValueError, RuntimeError, OSError) as e:
        # the meta plane asked for over a store it cannot run on, a ring
        # without this filer, a store that does not answer
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
        return _serve(fs, _listening("filer"), fleet, fl.stop,
                      push=(args, "filer"))
    finally:
        fl.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m seaweedfs_tpu_torch")
    ap.add_argument("-securityToml", default="",
                    help="security.toml: JWT signing keys, admin key, "
                         "IP whitelist, TLS")
    ap.add_argument("-v", type=int, default=None, metavar="LEVEL",
                    help="verbose log level (wlog.V gates; also WEED_V)")
    ap.add_argument("-logdir", default="",
                    help="also write the log to <logdir>/weed.log, "
                         "size-rotated")
    ap.add_argument("-logJson", dest="log_json", action="store_true",
                    help="one JSON object a log line")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def metrics_flags(parser) -> None:
        parser.add_argument("-metricsAddress", dest="metrics_address",
                            default="",
                            help="Prometheus pushgateway host:port")
        parser.add_argument("-metricsIntervalSec", dest="metrics_interval",
                            type=int, default=15)
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
    metrics_flags(m)
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
    v.add_argument("-memoryMapMaxSizeMb", dest="mmap_mb", type=int,
                   default=0, help="mmap the .dat read path of volumes up "
                                   "to this size (0: off)")
    v.add_argument("-tierBackend", default="",
                   help="S3 tier backend: endpoint,bucket[,accessKey,"
                        "secretKey], to mount tiered volumes at start")
    metrics_flags(v)
    sv = sub.add_parser("server", help="all-in-one: master + volume (+ "
                        "filer + s3) in one process")
    sv.add_argument("-ip", default="127.0.0.1")
    sv.add_argument("-master.port", dest="master_port", type=int,
                    default=9333)
    sv.add_argument("-master.volumeSizeLimitMB", dest="volume_size_limit_mb",
                    type=int, default=1024,
                    help="the master's volume size limit (the reference's "
                         "weed server flag)")
    sv.add_argument("-volume.port", dest="volume_port", type=int,
                    default=8080)
    sv.add_argument("-filer", action="store_true")
    sv.add_argument("-filer.port", dest="filer_port", type=int,
                    default=8888)
    sv.add_argument("-s3", action="store_true")
    sv.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    sv.add_argument("-s3.accessKey", dest="s3_access", default="")
    sv.add_argument("-s3.secretKey", dest="s3_secret", default="")
    sv.add_argument("-dir", default=".")
    sv.add_argument("-device", default=None,
                    help="the volume server's codec device: cuda (the "
                         "default) or cpu")
    sv.add_argument("-tierBackend", default="",
                    help="S3 tier backend: endpoint,bucket[,accessKey,"
                         "secretKey]")
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
                    help="sqlite file or :memory:, lsm directory, or the "
                         "host:port of a redis/elastic server")
    fl.add_argument("-storeType", dest="store_type", default="sqlite",
                    choices=["sqlite", "lsm", "redis", "elastic"],
                    help="metadata store")
    fl.add_argument("-collection", default="")
    fl.add_argument("-replication", default="")
    fl.add_argument("-notification", default="",
                    help="metadata notification sink: webhook:URL, "
                         "logfile:PATH, sqs:QUEUE_URL or pubsub:ENDPOINT/"
                         "projects/P/topics/T (mq: and kafka: are not "
                         "ported)")
    fl.add_argument("-lockPeers", dest="lock_peers", default="",
                    help="the lock ring's filers, host:port,... (this "
                         "filer among them)")
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
    metrics_flags(fl)
    fsy = sub.add_parser("filer.sync", help="replicate one filer's "
                         "namespace and content to another")
    fsy.add_argument("-from", dest="sync_from", required=True,
                     help="source filer host:port")
    fsy.add_argument("-to", dest="sync_to", required=True,
                     help="target filer host:port")
    fsy.add_argument("-state", default="",
                     help="offset file (default: named after -from/-to)")
    fsy.add_argument("-interval", type=float, default=0.5,
                     help="poll interval seconds when idle")
    fbk = sub.add_parser("filer.backup", help="mirror a filer into a "
                         "local directory")
    fbk.add_argument("-filer", required=True,
                     help="source filer host:port")
    fbk.add_argument("-dir", required=True, help="backup root")
    fbk.add_argument("-state", default="", help="offset file")
    fbk.add_argument("-interval", type=float, default=0.5)
    fbs3 = sub.add_parser("filer.backup.s3", help="mirror a filer into an "
                          "S3-compatible bucket")
    fbs3.add_argument("-filer", required=True, help="source filer host:port")
    fbs3.add_argument("-endpoint", required=True,
                      help="S3 endpoint, e.g. http://host:8333")
    fbs3.add_argument("-bucket", required=True)
    fbs3.add_argument("-accessKey", dest="access_key", default="")
    fbs3.add_argument("-secretKey", dest="secret_key", default="")
    fbs3.add_argument("-prefix", default="",
                      help="key prefix inside the bucket")
    fbs3.add_argument("-state", default="", help="offset file")
    fbs3.add_argument("-interval", type=float, default=0.5)
    frs = sub.add_parser("filer.remote.sync", help="push local changes "
                         "under a remote-mounted directory to its store")
    frs.add_argument("-filer", required=True)
    frs.add_argument("-dir", required=True,
                     help="remote-mounted filer directory")
    frs.add_argument("-state", default="", help="offset file")
    frs.add_argument("-interval", type=float, default=0.5)
    mt = sub.add_parser("filer.meta.tail", help="print the filer's "
                        "metadata events as JSON lines")
    mt.add_argument("-filer", default="127.0.0.1:8888")
    mt.add_argument("-sinceNs", dest="since_ns", type=int, default=0,
                    help="replay from this event timestamp (0 = now)")
    mt.add_argument("-pathPrefix", dest="path_prefix", default="",
                    help="only events under this path")
    mt.add_argument("-interval", type=float, default=1.0)
    mt.add_argument("-once", action="store_true",
                    help="drain the backlog and exit (no follow)")
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
    s3p.add_argument("-metricsPort", dest="metrics_port", type=int,
                     default=None,
                     help="serve the per-bucket metrics on a separate "
                          "listener too")
    metrics_flags(s3p)
    s3p.add_argument("-stsKey", dest="sts_key", default="",
                     help="STS signing key: honour temporary credentials "
                          "minted by the iam server")
    s3p.add_argument("-rolesFile", dest="roles_file", default="")
    s3p.add_argument("-kmsFile", dest="kms_file", default="",
                     help="local KMS keystore (enables SSE-KMS)")
    s3p.add_argument("-kmsEndpoint", dest="kms_endpoint", default="",
                     help="AWS-KMS-protocol endpoint host:port[,accessKey,"
                          "secretKey[,region]]; overrides -kmsFile")
    s3p.add_argument("-kmsCloud", dest="kms_cloud", default="",
                     help="gcp:endpoint,keyName,token | azure:vaultUrl,"
                          "keyName,token | openbao:addr,keyName,token; "
                          "overrides -kmsEndpoint and -kmsFile")
    iamp = sub.add_parser("iam", help="the IAM API and STS AssumeRole over "
                          "an identities JSON shared with the gateways")
    iamp.add_argument("-ip", default="127.0.0.1")
    iamp.add_argument("-port", type=int, default=8111)
    iamp.add_argument("-iamConfig", dest="iam_config", required=True)
    iamp.add_argument("-stsKey", dest="sts_key", default="")
    iamp.add_argument("-rolesFile", dest="roles_file", default="")
    iamp.add_argument("-oidcConfig", dest="oidc_config", default="",
                      help="JSON list of OIDC providers: [{name, issuer, "
                           "audience?, hs256Secret? | rsaPublicKeyFile?}]")
    wd = sub.add_parser("webdav", help="WebDAV gateway attached to a "
                        "running filer (server/webdav_server.go)")
    wd.add_argument("-ip", default="127.0.0.1")
    wd.add_argument("-port", type=int, default=7333)
    wd.add_argument("-filer", default="127.0.0.1:8888",
                    help="filer host:port whose namespace to serve")
    mnt = sub.add_parser("mount", help="FUSE-mount a running filer "
                         "(weed/mount)")
    mnt.add_argument("-filer", default="127.0.0.1:8888")
    mnt.add_argument("-dir", required=True, help="mountpoint")
    sf = sub.add_parser("sftp", help="SFTP gateway attached to a running "
                        "filer (weed/sftpd)")
    sf.add_argument("-ip", default="127.0.0.1")
    sf.add_argument("-port", type=int, default=2022)
    sf.add_argument("-filer", default="127.0.0.1:8888")
    sf.add_argument("-userStoreFile", dest="user_store", required=True,
                    help="JSON user store (sftpd/user/filestore.go)")
    sf.add_argument("-hostKeyFile", dest="host_key", default="",
                    help="ed25519 host key PEM; generated and saved if "
                         "missing")
    sf.add_argument("-authMethods", dest="auth_methods",
                    default="password,publickey")
    sf.add_argument("-banner", default="")
    sf.add_argument("-ldapServer", dest="ldap_server", default="",
                    help="host:port of an LDAP server for password auth "
                         "of users not in the store")
    sf.add_argument("-ldapUserDnTemplate", dest="ldap_dn_template",
                    default="",
                    help="user DN template, {} = username "
                         "(e.g. uid={},ou=people,dc=corp)")
    sf.add_argument("-ldapBaseDn", dest="ldap_base_dn", default="")
    sf.add_argument("-ldapBindDn", dest="ldap_bind_dn", default="")
    sf.add_argument("-ldapBindPassword", dest="ldap_bind_password",
                    default="")
    sf.add_argument("-ldapTls", dest="ldap_tls", action="store_true",
                    help="reach the directory over TLS (ldaps)")
    sfu = sub.add_parser("sftp.user", help="manage an SFTP user-store "
                         "file")
    sfu.add_argument("-store", required=True)
    sfu.add_argument("action", choices=["add", "delete", "list"])
    sfu.add_argument("-name", default="")
    sfu.add_argument("-password", default="")
    sfu.add_argument("-home", default="")
    sfu.add_argument("-pubkey", default="",
                     help="authorized key line 'ssh-ed25519 <b64>'")
    sfu.add_argument("-perm", action="append", default=[],
                     help="path:perm1,perm2 (repeatable)")
    sub.add_parser("version", help="print the version")
    crt = sub.add_parser("cert", help="mint a cluster CA and node "
                         "certificate for the TLS plane")
    crt.add_argument("-dir", default="certs")
    crt.add_argument("-hosts", default="127.0.0.1,localhost",
                     help="comma-separated SAN hosts and IPs")
    sc = sub.add_parser("scaffold", help="print a commented template "
                        "config")
    sc.add_argument("-config", default="security",
                    choices=["security", "filer", "notification",
                             "replication"],
                    help="which template to print")
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
    # WEED_<COMMAND>_<FLAG> in the environment replace the parsers'
    # defaults (the reference's viper layer): a flag given still wins
    from .util.config import apply_env_defaults
    env_applied = apply_env_defaults(sub.choices)
    args = ap.parse_args(argv)

    from .util import wlog
    if args.v is not None:
        wlog.set_verbosity(args.v)
    if args.log_json:
        wlog.json_format(True)
    if args.logdir:
        os.makedirs(args.logdir, exist_ok=True)
        wlog.set_output(os.path.join(args.logdir, "weed.log"))
    for line in env_applied:
        wlog.info("env override: %s", line, component="config")
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
        print(SCAFFOLDS[args.config])
        return 0
    if args.cmd == "filer.sync":
        from .filer.filer_sync import FilerSync
        return _serve(FilerSync(args.sync_from, args.sync_to,
                                args.state or None,
                                poll_interval=args.interval),
                      lambda s: f"filer.sync {s.source} -> {s.target} "
                                f"(offset state: {s.state_path})")
    if args.cmd == "filer.backup":
        from .filer.filer_backup import FilerBackup
        return _serve(FilerBackup(args.filer, args.dir, args.state or None,
                                  poll_interval=args.interval),
                      lambda s: f"filer.backup {s.source} -> "
                                f"{args.dir} (offset state: "
                                f"{s.state_path})")
    if args.cmd == "filer.backup.s3":
        from .filer.s3_sink import S3Sink
        return _serve(S3Sink(args.filer, args.endpoint, args.bucket,
                             args.access_key, args.secret_key, args.prefix,
                             args.state or None,
                             poll_interval=args.interval),
                      lambda s: f"filer.backup.s3 {s.source} -> "
                                f"{args.endpoint}/{args.bucket}/"
                                f"{args.prefix} (offset state: "
                                f"{s.state_path})")
    if args.cmd == "filer.remote.sync":
        from .remote import RemoteError, RemoteSyncer
        try:
            syncer = RemoteSyncer(args.filer, args.dir, args.state or None,
                                  args.interval)
        except (RemoteError, OSError) as e:
            print(f"filer.remote.sync: {e}", file=sys.stderr)
            return 1
        return _serve(syncer, lambda s: f"remote-syncing {s.dir} on "
                                        f"{s.filer}")
    if args.cmd == "filer.meta.tail":
        return _meta_tail(args)
    if args.cmd == "s3":
        return _s3(ap, args)
    if args.cmd == "iam":
        return _iam(ap, args)
    if args.cmd == "webdav":
        from .filer.client import FilerClient
        from .server.webdav_server import WebDavServer
        return _serve(WebDavServer("", FilerClient(args.filer), args.ip,
                                   args.port),
                      lambda d: f"webdav on {d.url} serving filer "
                                f"{args.filer}")
    if args.cmd == "mount":
        from .mount.fuse_ctypes import mount as fuse_mount
        print(f"mounting filer {args.filer} at {args.dir}", flush=True)
        return fuse_mount(args.filer, args.dir)
    if args.cmd == "sftp":
        return _sftp(args)
    if args.cmd == "sftp.user":
        return _sftp_user(args)
    if args.cmd == "version":
        from . import __version__
        print(f"seaweedfs-tpu-torch {__version__} "
              f"(python {sys.version.split()[0]})")
        return 0
    if args.cmd == "server":
        return _server(args)

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
                _listening("master server"), report, push=(args, "master"))
        finally:
            reporter.stop()
    if args.cmd in ("volume", "worker") and args.device is not None:
        from .ops.rs_torch import _resolve_device
        _resolve_device(args.device)  # raises without the card
    if args.cmd == "volume":
        from .server.volume_server import VolumeServer
        if args.tierBackend:
            from .storage.backend import configure_from_flag
            configure_from_flag(args.tierBackend)
        if args.mmap_mb:
            from .storage import store
            store.MMAP_READ_MB = args.mmap_mb
        return _serve(VolumeServer(
            args.dir.split(","), host=args.ip, port=args.port,
            device=args.device or "cuda", master=args.mserver,
            data_center=args.dataCenter, rack=args.rack,
            max_volume_count=args.max, fsync=args.fsync),
            _listening("volume server"), push=(args, "volume_server"))
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


def _sftp(args) -> int:
    """The SFTP gateway over a running filer: the host key from
    `-hostKeyFile` (an ed25519 PEM, made and saved there if missing),
    the user store, and an LDAP provider with `-ldapServer`."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey)
    from .filer.client import FilerClient
    from .sftp import SftpService, UserStore
    key = None
    if args.host_key:
        if os.path.exists(args.host_key):
            with open(args.host_key, "rb") as f:
                key = serialization.load_pem_private_key(f.read(),
                                                         password=None)
        else:
            key = Ed25519PrivateKey.generate()
            with open(args.host_key, "wb") as f:
                f.write(key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.PKCS8,
                    serialization.NoEncryption()))
    ldap = None
    if args.ldap_server:
        from .iam.ldap import LdapProvider
        host, _, port = args.ldap_server.partition(":")
        ldap = LdapProvider(
            host, int(port or (636 if args.ldap_tls else 389)),
            base_dn=args.ldap_base_dn,
            user_dn_template=args.ldap_dn_template,
            bind_dn=args.ldap_bind_dn,
            bind_password=args.ldap_bind_password, use_tls=args.ldap_tls)
    svc = SftpService(FilerClient(args.filer), UserStore(args.user_store),
                      host_key=key, port=args.port, ip=args.ip,
                      auth_methods=tuple(args.auth_methods.split(",")),
                      banner=args.banner, ldap=ldap)
    return _serve(svc, lambda s: f"sftp on {s.ip}:{s.port} serving filer "
                                 f"{args.filer}")


def _sftp_user(args) -> int:
    """sftp.user add|delete|list on a user-store file."""
    from .sftp import User, UserStore
    store = UserStore(args.store)
    if args.action == "list":
        for u in store:
            print(f"{u.username} home={u.home_dir} "
                  f"keys={len(u.public_keys)} perms={u.permissions}")
    elif args.action == "delete":
        store.delete(args.name)
        print(f"deleted {args.name}")
    else:
        u = store.get(args.name) or User(args.name, args.home)
        if args.home:
            u.home_dir = args.home
        if args.password:
            u.set_password(args.password)
        if args.pubkey:
            u.add_public_key(args.pubkey)
        for spec in args.perm:
            path, _, perms = spec.partition(":")
            u.permissions[path] = perms.split(",")
        store.put(u)
        print(f"saved {u.username}")
    return 0


def _meta_tail(args) -> int:
    """filer.meta.tail (command/filer_meta_tail.go): the metadata log
    from `-sinceNs` as JSON lines, pages of 1,000; `-once` stops at the
    end of the backlog, else it follows, retrying a filer that is
    down."""
    import json
    import time
    from .server.httpd import http_json
    since = args.since_ns
    if since == 0 and not args.once:
        since = time.time_ns()          # "now": only new events
    try:
        while True:
            try:
                r = http_json("GET", f"{args.filer}/__meta__/events?"
                                     f"sinceNs={since}&limit=1000")
            except OSError as e:
                if args.once:
                    print(f"filer.meta.tail: {e}", file=sys.stderr)
                    return 1
                print(f"filer.meta.tail: {e}; retrying", file=sys.stderr)
                time.sleep(args.interval)
                continue
            if "error" in r:
                # a 401 or 404 must not read as an empty log
                print(f"filer.meta.tail: {r['error']}", file=sys.stderr)
                return 1
            events = r.get("events", [])
            for ev in events:
                path = (ev.get("newEntry") or ev.get("oldEntry") or
                        {}).get("fullPath", "")
                since = max(since, int(ev.get("tsNs", 0)))
                if args.path_prefix and \
                        not path.startswith(args.path_prefix):
                    continue
                print(json.dumps(ev), flush=True)
            if len(events) < 1000:
                if args.once:
                    return 0
                time.sleep(args.interval)
    except KeyboardInterrupt:
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
