"""The same-host zero-copy needle read plane over a Unix-domain socket,
the port's copy of `seaweedfs_tpu/server/uds_reader.py` (the analog of
the reference's RDMA sidecar, seaweedfs-rdma-sidecar/rdma-engine/src/
ipc.rs): a reader on the volume server's host receives the raw needle
record straight from the `.dat` by sendfile(2), past the HTTP stack.

The wire is the JAX package's, so either package's client reads from
either package's server (one request a round, the connection reused;
the port's client keeps a connection a thread and socket, where the JAX
client dials one a read):

    client -> {"volumeId": v, "key": k}\\n
    server -> {"size": n, "version": ver}\\n  + n raw record bytes
    or     -> {"error": "..."}\\n

The client parses the record with the needle codec (CRC, cookie and TTL
are checked there).  The volume server gives the socket's path in its
`/status` (`udsPath`); a client whose host cannot reach the path reads
over HTTP.  The server takes the record's place and a dup of the `.dat`
fd under the volume's lock, after a flush of the buffered handle (an
fsync is not needed: every acked record is in the file), and streams
outside the lock, so a slow reader never holds the volume.  A record
larger than the socket's send buffer is sent whole: the server waits
for room when sendfile(2) would block (the JAX server's sendfile fails
there, and its reader falls back to HTTP for any needle over ~256 KiB).
"""

from __future__ import annotations

import json
import os
import select
import socket
import threading

from ..storage import types
from ..storage.needle import Needle, get_actual_size


class UdsNeedleServer:
    """The accept loop and one thread a connection over `store`'s normal
    volumes.  `on_read(vid, key)` runs after each record served (the
    volume server warms its native read plane with it)."""

    def __init__(self, store, sock_path: str, on_read=None):
        self.store = store
        self.sock_path = sock_path
        self.on_read = on_read
        self.served = 0            # records sent
        self._served_lock = threading.Lock()
        self._conns: "set[socket.socket]" = set()
        self._stop = threading.Event()
        try:
            os.remove(sock_path)
        except OSError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._sock.bind(sock_path)
            self._sock.listen(64)
        except OSError:
            self._sock.close()
            raise
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="uds-accept", daemon=True)

    def start(self) -> "UdsNeedleServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close the listener and every connection (a kept client
        connection then reads EOF and dials afresh)."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._served_lock:
            conns, self._conns = self._conns, set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            os.remove(self.sock_path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return             # closed by stop()
            with self._served_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            f = conn.makefile("rb")
            while not self._stop.is_set():
                line = f.readline(4096)
                if not line:
                    return
                try:
                    req = json.loads(line)
                    vid, key = int(req["volumeId"]), int(req["key"])
                except (ValueError, KeyError, TypeError):
                    conn.sendall(b'{"error": "malformed request"}\n')
                    return
                self._serve_one(conn, vid, key)
        except OSError:
            pass
        finally:
            with self._served_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_one(self, conn: socket.socket, vid: int, key: int) -> None:
        v = self.store.find_volume(vid)
        if v is None:
            conn.sendall(json.dumps(
                {"error": f"volume {vid} not found"}).encode() + b"\n")
            return
        with v.lock:
            # a native ack whose journal entry has not drained yet is
            # readable here too
            v._drain_if_pending()
            got = v.nm.get(key)
            if got is None:
                conn.sendall(b'{"error": "not found"}\n')
                return
            offset = types.to_actual_offset(got[0])
            total = get_actual_size(got[1], v.version)
            version = v.version
            v.flush()
            dup_fd = os.dup(v.dat_fd())
        try:
            conn.settimeout(30.0)
            conn.sendall(json.dumps(
                {"size": total, "version": version}).encode() + b"\n")
            sent = 0
            while sent < total:
                try:
                    n = os.sendfile(conn.fileno(), dup_fd, offset + sent,
                                    total - sent)
                except BlockingIOError:
                    # the socket's buffer is full (a socket with a
                    # timeout does not block): wait for room, within
                    # the timeout
                    if not select.select([], [conn], [], 30.0)[1]:
                        raise TimeoutError("uds send stalled") from None
                    continue
                if n == 0:
                    break
                sent += n
        finally:
            os.close(dup_fd)
        if self.on_read is not None:
            try:
                self.on_read(vid, key)
            except Exception:  # noqa: BLE001 — a plane warm is best
                pass           # effort and must not end the connection
        with self._served_lock:       # counted once its hook has run
            self.served += 1


_kept = threading.local()


def uds_read_needle(sock_path: str, vid: int, key: int,
                    timeout: float = 10.0) -> Needle:
    """One needle record over the socket at `sock_path`, parsed and
    CRC-checked, on this thread's kept connection to it.  A kept
    connection that failed is dialled again once, unless it timed out
    (the caller's budget is spent then).  OSError on a transport
    problem, LookupError when the server reports a miss (the connection
    stays usable)."""
    conns = getattr(_kept, "conns", None)
    if conns is None:
        conns = _kept.conns = {}
    line = json.dumps({"volumeId": vid, "key": key}).encode() + b"\n"
    for attempt in (0, 1):
        c = conns.pop(sock_path, None)
        reused = c is not None
        if c is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(timeout)
                s.connect(sock_path)
            except OSError:
                s.close()
                raise
            c = (s, s.makefile("rb"))
        s, f = c
        try:
            s.settimeout(timeout)
            s.sendall(line)
            header = json.loads(f.readline(4096))
            if "error" in header:
                conns[sock_path] = c
                raise LookupError(header["error"])
            total = int(header["size"])
            buf = f.read(total)
        except (OSError, ValueError) as e:
            s.close()
            if reused and attempt == 0 and \
                    not isinstance(e, socket.timeout):
                continue       # the server closed a kept connection
            raise
        if len(buf) != total:
            s.close()
            raise OSError(f"short uds read: {len(buf)}/{total}")
        conns[sock_path] = c
        return Needle.from_bytes(buf, int(header["version"]))
    raise OSError("unreachable")  # pragma: no cover
