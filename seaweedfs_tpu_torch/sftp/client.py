"""Minimal SSH/SFTP client over the same transport, the port's copy of
`seaweedfs_tpu/sftp/client.py`.

No OpenSSH client or paramiko is installed, so the tests and
`chip_smoke.py` drive the gateway with this client (the reference's
sftp_server_test.go does the same with pkg/sftp's client).
"""

from __future__ import annotations

import base64
import socket

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)
from cryptography.hazmat.primitives import serialization

from . import handlers as fx
from . import server as msg
from .ssh_wire import Reader, ssh_bool, ssh_string, u32, u8
from .transport import SshError, Transport


def openssh_pubkey(key: Ed25519PrivateKey, comment: str = "") -> str:
    """'ssh-ed25519 <base64-blob> comment' authorized_keys line."""
    raw = key.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
    blob = ssh_string("ssh-ed25519") + ssh_string(raw)
    b64 = base64.b64encode(blob).decode()
    return f"ssh-ed25519 {b64} {comment}".strip()


class SftpError(OSError):
    def __init__(self, code: int, text: str):
        super().__init__(f"sftp status {code}: {text}")
        self.code = code


class SftpClient:
    def __init__(self, host: str, port: int, username: str,
                 password: str | None = None,
                 key: Ed25519PrivateKey | None = None,
                 expected_host_key: bytes | None = None,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        # a 32 KiB WRITE leaves as two channel packets (see the server)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.tr = Transport(self.sock, server=False,
                            expected_host_key=expected_host_key)
        self.tr.request_service("ssh-userauth")
        self._auth(username, password, key)
        self._open_channel()
        self._req_id = 0
        self._inbuf = b""
        v = self._rpc_raw(u8(fx.FXP_INIT) + u32(3))
        r = Reader(v)
        if r.u8() != fx.FXP_VERSION or r.u32() != 3:
            raise SshError("sftp version negotiation failed")

    def close(self) -> None:
        try:
            self.tr.send(u8(msg.MSG_CHANNEL_CLOSE) + u32(0))
        except OSError:
            pass    # best-effort goodbye on a dying transport
        self.sock.close()

    # -- ssh plumbing ------------------------------------------------------

    def _auth(self, username, password, key) -> None:
        if key is not None:
            raw = key.public_key().public_bytes(
                serialization.Encoding.Raw,
                serialization.PublicFormat.Raw)
            blob = ssh_string("ssh-ed25519") + ssh_string(raw)
            body = (ssh_string(username) +
                    ssh_string("ssh-connection") +
                    ssh_string("publickey") + ssh_bool(True) +
                    ssh_string("ssh-ed25519") + ssh_string(blob))
            signed = ssh_string(self.tr.session_id) + \
                u8(msg.MSG_USERAUTH_REQUEST) + body
            sig = (ssh_string("ssh-ed25519") +
                   ssh_string(key.sign(signed)))
            self.tr.send(u8(msg.MSG_USERAUTH_REQUEST) + body +
                         ssh_string(sig))
        else:
            self.tr.send(u8(msg.MSG_USERAUTH_REQUEST) +
                         ssh_string(username) +
                         ssh_string("ssh-connection") +
                         ssh_string("password") + ssh_bool(False) +
                         ssh_string(password or ""))
        while True:
            r = Reader(self.tr.recv())
            t = r.u8()
            if t == msg.MSG_USERAUTH_SUCCESS:
                return
            if t == msg.MSG_USERAUTH_BANNER:
                continue
            if t == msg.MSG_USERAUTH_FAILURE:
                raise PermissionError(
                    f"auth failed (server allows {r.name_list()})")
            raise SshError(f"unexpected userauth reply {t}")

    def _open_channel(self) -> None:
        self.recv_window = msg.WINDOW
        self.tr.send(u8(msg.MSG_CHANNEL_OPEN) + ssh_string("session") +
                     u32(0) + u32(msg.WINDOW) + u32(msg.MAX_PACKET))
        r = Reader(self.tr.recv())
        if r.u8() != msg.MSG_CHANNEL_OPEN_CONFIRMATION:
            raise SshError("channel open refused")
        r.u32()
        self.chan_peer = r.u32()
        self.peer_window = r.u32()
        self.peer_max_packet = min(r.u32(), 1 << 20)
        self.tr.send(u8(msg.MSG_CHANNEL_REQUEST) + u32(self.chan_peer) +
                     ssh_string("subsystem") + ssh_bool(True) +
                     ssh_string("sftp"))
        r = Reader(self.tr.recv())
        if r.u8() != msg.MSG_CHANNEL_SUCCESS:
            raise SshError("sftp subsystem refused")

    def _send_data(self, data: bytes) -> None:
        step = max(1024, self.peer_max_packet - 16)
        for i in range(0, len(data), step):
            chunk = data[i:i + step]
            while self.peer_window < len(chunk):
                self._pump()
            self.peer_window -= len(chunk)
            self.tr.send(u8(msg.MSG_CHANNEL_DATA) +
                         u32(self.chan_peer) + ssh_string(chunk))

    def _pump(self) -> None:
        """Process one incoming connection-layer message."""
        r = Reader(self.tr.recv())
        t = r.u8()
        if t == msg.MSG_CHANNEL_DATA:
            r.u32()
            data = r.string()
            self._inbuf += data
            self.recv_window -= len(data)
            if self.recv_window < msg.WINDOW // 2:
                grow = msg.WINDOW - self.recv_window
                self.tr.send(u8(msg.MSG_CHANNEL_WINDOW_ADJUST) +
                             u32(self.chan_peer) + u32(grow))
                self.recv_window += grow
        elif t == msg.MSG_CHANNEL_WINDOW_ADJUST:
            r.u32()
            self.peer_window += r.u32()
        elif t in (msg.MSG_CHANNEL_EOF, msg.MSG_CHANNEL_CLOSE):
            raise ConnectionError("sftp channel closed")
        else:
            raise SshError(f"unexpected channel message {t}")

    def _rpc_raw(self, body: bytes) -> bytes:
        self._send_data(u32(len(body)) + body)
        while True:
            if len(self._inbuf) >= 4:
                n = int.from_bytes(self._inbuf[:4], "big")
                if len(self._inbuf) >= 4 + n:
                    resp = self._inbuf[4:4 + n]
                    self._inbuf = self._inbuf[4 + n:]
                    return resp
            self._pump()

    def _rpc(self, t: int, body: bytes) -> Reader:
        self._req_id += 1
        resp = self._rpc_raw(u8(t) + u32(self._req_id) + body)
        r = Reader(resp)
        rt = r.u8()
        rid = r.u32()
        if rid != self._req_id:
            raise SshError(f"response id {rid} != {self._req_id}")
        if rt == fx.FXP_STATUS:
            code = r.u32()
            text = r.text()
            if code not in (fx.FX_OK, fx.FX_EOF):
                raise SftpError(code, text)
            r.code = code  # type: ignore[attr-defined]
        r.type = rt        # type: ignore[attr-defined]
        return r

    # -- sftp surface ------------------------------------------------------

    def open(self, path: str, pflags: int) -> bytes:
        r = self._rpc(fx.FXP_OPEN, ssh_string(path) + u32(pflags) +
                      u32(0))
        if r.type != fx.FXP_HANDLE:
            raise SftpError(fx.FX_FAILURE, "no handle")
        return r.string()

    def close_handle(self, h: bytes) -> None:
        self._rpc(fx.FXP_CLOSE, ssh_string(h))

    def write_file(self, path: str, data: bytes,
                   chunk: int = 24 * 1024) -> None:
        h = self.open(path, fx.FXF_WRITE | fx.FXF_CREAT | fx.FXF_TRUNC)
        try:
            for off in range(0, len(data), chunk):
                self._rpc(fx.FXP_WRITE, ssh_string(h) +
                          off.to_bytes(8, "big") +
                          ssh_string(data[off:off + chunk]))
        finally:
            self.close_handle(h)

    def read_file(self, path: str, chunk: int = 24 * 1024) -> bytes:
        h = self.open(path, fx.FXF_READ)
        out = bytearray()
        try:
            while True:
                r = self._rpc(fx.FXP_READ, ssh_string(h) +
                              len(out).to_bytes(8, "big") + u32(chunk))
                if r.type == fx.FXP_STATUS:   # EOF
                    break
                out += r.string()
        finally:
            self.close_handle(h)
        return bytes(out)

    def write_at(self, h: bytes, offset: int, data: bytes) -> None:
        self._rpc(fx.FXP_WRITE, ssh_string(h) +
                  offset.to_bytes(8, "big") + ssh_string(data))

    def listdir(self, path: str) -> list[tuple[str, dict]]:
        h = self._rpc(fx.FXP_OPENDIR, ssh_string(path)).string()
        names = []
        try:
            while True:
                r = self._rpc(fx.FXP_READDIR, ssh_string(h))
                if r.type == fx.FXP_STATUS:
                    break
                for _ in range(r.u32()):
                    name = r.text()
                    r.string()               # longname
                    names.append((name, _parse_attrs(r)))
        finally:
            self.close_handle(h)
        return names

    def stat(self, path: str) -> dict:
        r = self._rpc(fx.FXP_STAT, ssh_string(path))
        if r.type != fx.FXP_ATTRS:
            raise SftpError(fx.FX_FAILURE, "no attrs")
        return _parse_attrs(r)

    def setstat(self, path: str, mode: int | None = None,
                size: int | None = None) -> None:
        flags, body = 0, b""
        if size is not None:
            flags |= fx.ATTR_SIZE
            body += size.to_bytes(8, "big")
        if mode is not None:
            flags |= fx.ATTR_PERMISSIONS
            body += u32(mode)
        self._rpc(fx.FXP_SETSTAT, ssh_string(path) + u32(flags) + body)

    def mkdir(self, path: str) -> None:
        self._rpc(fx.FXP_MKDIR, ssh_string(path) + u32(0))

    def rmdir(self, path: str) -> None:
        self._rpc(fx.FXP_RMDIR, ssh_string(path))

    def remove(self, path: str) -> None:
        self._rpc(fx.FXP_REMOVE, ssh_string(path))

    def rename(self, old: str, new: str) -> None:
        self._rpc(fx.FXP_RENAME, ssh_string(old) + ssh_string(new))

    def realpath(self, path: str) -> str:
        r = self._rpc(fx.FXP_REALPATH, ssh_string(path))
        r.u32()
        return r.text()


def _parse_attrs(r: Reader) -> dict:
    flags = r.u32()
    out = {}
    if flags & fx.ATTR_SIZE:
        out["size"] = r.u64()
    if flags & fx.ATTR_UIDGID:
        out["uid"], out["gid"] = r.u32(), r.u32()
    if flags & fx.ATTR_PERMISSIONS:
        out["mode"] = r.u32()
    if flags & fx.ATTR_ACMODTIME:
        out["atime"], out["mtime"] = r.u32(), r.u32()
    return out
