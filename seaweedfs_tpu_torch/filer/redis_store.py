"""Redis FilerStore, the port's copy of
`seaweedfs_tpu/filer/redis_store.py` — a concrete wire-protocol store
archetype (weed/filer/redis2/universal_redis_store.go; interface
weed/filer/filerstore.go).  Keys and values are the JAX package's, so a
RESP server written by either package's filer reads in the other.

Two pieces, both from scratch:

- **RespClient** — a hand-rolled RESP2 client (redis serialization
  protocol): inline command arrays out, typed replies
  (+simple / -error / :integer / $bulk / *array) back, over one
  pooled socket with reconnect-on-failure.  No third-party driver
  (the image carries none), and nothing redis-specific beyond the
  protocol — it speaks to a real `redis-server` unchanged.
- **RedisFilerStore** — the reference redis2 data model: the entry
  body lives at key `<path>` (JSON here; the reference uses protobuf
  Entry encoding), and each directory keeps a SORTED SET at
  `<dir>\\x00` with one member per child name (score 0), so listing
  is ZRANGEBYLEX — ordered, resumable pagination without scanning.

Tested against an external RESP server process (tests/resp_fake.py),
the way the reference's CI runs its redis stores against a service
container.
"""

from __future__ import annotations

import json
import socket
import threading

from .entry import Entry
from .filer_store import FilerStore, normalize_path

DIR_LIST_MARKER = "\x00"   # redis2 DIR_LIST_MARKER


class RespError(RuntimeError):
    """Server-reported -ERR reply."""


class RespClient:
    """Minimal RESP2 client over one reconnecting socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._lock = threading.Lock()
        self._sock: "socket.socket | None" = None
        self._buf = b""

    def _connect(self) -> None:
        """Caller holds the lock."""
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    # -- wire ----------------------------------------------------------

    @staticmethod
    def _encode(args: "tuple") -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, (int, float)):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_line(self) -> bytes:
        """Caller holds the lock."""
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise OSError("RESP connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        """Caller holds the lock."""
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise OSError("RESP connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self._read_reply()
                                       for _ in range(n)]
        raise RespError(f"unparseable reply {line[:40]!r}")

    def call(self, *args):
        """One command round-trip; reconnects once on a dead pooled
        socket (commands used by the store are idempotent writes —
        SET/ZADD/DEL replay safely)."""
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._connect()
                try:
                    self._sock.sendall(self._encode(args))
                    return self._read_reply()
                except OSError:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    if attempt:
                        raise


class RedisFilerStore(FilerStore):
    """redis2's data model over RespClient (see module docstring)."""

    def __init__(self, client: RespClient):
        self.r = client

    @staticmethod
    def _dir_key(dir_path: str) -> str:
        return dir_path + DIR_LIST_MARKER

    def insert_entry(self, entry: Entry) -> None:
        self.r.call("SET", entry.full_path,
                    json.dumps(entry.to_json()))
        if entry.name:
            self.r.call("ZADD", self._dir_key(entry.parent), 0,
                        entry.name)

    update_entry = insert_entry

    def find_entry(self, path: str) -> "Entry | None":
        path = normalize_path(path)
        if path == "/":
            return Entry("/", is_directory=True)
        raw = self.r.call("GET", path)
        if raw is None:
            return None
        return Entry.from_json(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        path = normalize_path(path)
        self.r.call("DEL", path)
        parent, _, name = path.rpartition("/")
        if name:
            self.r.call("ZREM", self._dir_key(parent or "/"), name)

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        names = self.r.call("ZRANGEBYLEX", self._dir_key(path),
                            "-", "+") or []
        for raw in names:
            name = raw.decode() if isinstance(raw, bytes) else raw
            child = path.rstrip("/") + "/" + name
            # recurse into directories BEFORE dropping the child key
            raw_e = self.r.call("GET", child)
            if raw_e is not None:
                try:
                    if json.loads(raw_e).get("isDirectory"):
                        self.delete_folder_children(child)
                except ValueError:
                    pass
            self.r.call("DEL", child)
        self.r.call("DEL", self._dir_key(path))

    def list_directory_entries(self, dir_path: str,
                               start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> list[Entry]:
        dir_path = normalize_path(dir_path)
        if start_file:
            lo = ("[" if include_start else "(") + start_file
        elif prefix:
            lo = "[" + prefix
        else:
            lo = "-"
        hi = "[" + prefix + "\xff" if prefix else "+"
        names = self.r.call("ZRANGEBYLEX", self._dir_key(dir_path),
                            lo, hi, "LIMIT", 0, limit) or []
        out: list[Entry] = []
        for raw in names:
            name = raw.decode() if isinstance(raw, bytes) else raw
            if prefix and not name.startswith(prefix):
                continue
            raw_e = self.r.call(
                "GET", dir_path.rstrip("/") + "/" + name)
            if raw_e is None:
                continue    # listing/entry raced a delete
            out.append(Entry.from_json(json.loads(raw_e)))
        return out

    def close(self) -> None:
        self.r.close()
