"""Configuration layer, the port's copy of `seaweedfs_tpu/util/config.py`
(reference: weed/util/config.go — viper-backed
TOML files with WEED_* environment overrides, and the per-role
scaffold TOMLs `filer.toml` / `notification.toml` / `replication.toml`
from weed/command/scaffold/).

Three pieces:

1. `apply_env_defaults(subparsers)` — every CLI flag of every role can
   be defaulted from the environment as `WEED_<ROLE>_<FLAG>` (flag
   name uppercased, dots/dashes -> underscores), matching the
   reference's viper `SetEnvPrefix("weed")` behavior.  Explicit
   command-line flags still win: the env only REPLACES the parser
   default.

2. `find_toml(name)` — the reference's search path: ./, ~/.seaweedfs/,
   /etc/seaweedfs/ (util/config.go LoadConfiguration).

3. Role helpers that read the scaffold shapes:
   - `filer_store_from_toml(path)`: the `[sqlite]` / `[leveldb2]`-
     family sections with `enabled = true` choose the filer store
     (our archetypes: sqlite, lsm, redis2->redis).
   - `notification_from_toml(path)`: `[notification.*]` sections ->
     the `-notification` spec string the filer CLI takes.
"""

from __future__ import annotations

import os

import tomllib

SEARCH_DIRS = (".", os.path.expanduser("~/.seaweedfs"),
               "/etc/seaweedfs")


def find_toml(name: str) -> "str | None":
    for d in SEARCH_DIRS:
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    return None


def load_toml(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _env_key(role: str, flag: str) -> str:
    clean = flag.lstrip("-").replace(".", "_").replace("-", "_")
    return f"WEED_{role.upper().replace('.', '_')}_{clean.upper()}"


def apply_env_defaults(subparsers: dict, environ=None) -> list[str]:
    """Rewrite each subparser's argument DEFAULTS from matching
    WEED_* env vars.  Returns the applied `ROLE.flag=value` list (for
    a startup log line).  Type conversion follows the argument's
    declared type; booleans accept true/1/yes."""
    environ = environ if environ is not None else os.environ
    applied = []
    for role, parser in subparsers.items():
        for action in parser._actions:          # noqa: SLF001
            if not action.option_strings:
                continue
            flag = action.option_strings[0]
            if flag in ("-h", "--help"):
                continue
            val = environ.get(_env_key(role, flag))
            if val is None:
                continue
            if isinstance(action.const, bool) or \
                    action.__class__.__name__ == "_StoreTrueAction":
                action.default = val.lower() in ("1", "true", "yes",
                                                 "on")
            elif action.type is int:
                action.default = int(val)
            elif action.type is float:
                action.default = float(val)
            else:
                action.default = val
            applied.append(f"{role}{flag}={val}")
    return applied


# -- filer.toml (command/scaffold/filer.toml shape) ------------------------

# reference store section -> our archetype; every leveldb flavor maps
# onto the embedded LSM, redis flavors onto the RESP store
_STORE_SECTIONS = {
    "sqlite": "sqlite",
    "leveldb2": "lsm", "leveldb3": "lsm", "leveldb": "lsm",
    "rocksdb": "lsm",
    "redis2": "redis", "redis": "redis", "redis_cluster2": "redis",
    "elastic7": "elastic", "elastic": "elastic",
}


def filer_store_from_toml(path: str) -> "tuple[str, str] | None":
    """(store_type, store_path) from the first enabled store section,
    or None.  Path fields per section shape: sqlite `dbFile`,
    leveldb* `dir`, redis* `address`."""
    doc = load_toml(path)
    for section, archetype in _STORE_SECTIONS.items():
        cfg = doc.get(section)
        if not cfg or not cfg.get("enabled", False):
            continue
        if archetype == "sqlite":
            return "sqlite", cfg.get("dbFile",
                                     cfg.get("dbfile", "filer.db"))
        if archetype == "lsm":
            return "lsm", cfg.get("dir", "./filerldb2")
        if archetype == "elastic":
            servers = cfg.get("servers",
                              cfg.get("address", "localhost:9200"))
            first = servers[0] if isinstance(servers, list) \
                else str(servers)
            return "elastic", first.removeprefix("http://")
        return "redis", cfg.get("address", "localhost:6379")
    return None


# -- notification.toml (command/scaffold/notification.toml) ----------------

def notification_from_toml(path: str) -> str:
    """First enabled [notification.*] sink -> our -notification spec
    (webhook:URL, kafka:host:port/topic, logfile:PATH,
    mq:broker/ns/topic)."""
    doc = load_toml(path).get("notification", {})
    wh = doc.get("webhook", {})
    if wh.get("enabled"):
        return "webhook:" + wh.get("url", "")
    kf = doc.get("kafka", {})
    if kf.get("enabled"):
        hosts = kf.get("hosts", ["localhost:9092"])
        host = hosts[0] if isinstance(hosts, list) else str(hosts)
        return f"kafka:{host}/{kf.get('topic', 'seaweedfs_meta')}"
    lg = doc.get("log", {}) or doc.get("logfile", {})
    if lg.get("enabled"):
        return "logfile:" + lg.get("path", "filer_events.log")
    mq = doc.get("mq", {})
    if mq.get("enabled"):
        return (f"mq:{mq.get('broker', 'localhost:17777')}/"
                f"{mq.get('namespace', 'notifications')}/"
                f"{mq.get('topic', 'filer_meta')}")
    return ""


# -- replication.toml (command/scaffold/replication.toml) ------------------

def replication_sink_from_toml(path: str) -> "tuple[str, dict] | None":
    """(sink_kind, config) from the first enabled [sink.*] section —
    the filer.backup CLI consumes this (sink kinds: local, s3, gcs,
    azure, b2 — our filer/*_sink.py family)."""
    doc = load_toml(path).get("sink", {})
    for kind in ("local", "s3", "gcs", "azure", "backblaze", "b2"):
        cfg = doc.get(kind, {})
        if cfg.get("enabled"):
            return ("b2" if kind == "backblaze" else kind), dict(cfg)
    return None
