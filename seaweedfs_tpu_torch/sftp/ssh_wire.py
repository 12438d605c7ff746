"""SSH wire primitives: RFC 4251 data types and the RFC 4253 §6 binary
packet protocol (length/padding framing, AES-128-CTR encryption,
HMAC-SHA2-256 integrity, per-direction sequence numbers).

The reference gets this from golang.org/x/crypto/ssh; no SSH library
is installed, so it lives here, as in `seaweedfs_tpu/sftp/ssh_wire.py`
(the port's copy).  Only the negotiated
suite is implemented: curve25519-sha256 / ssh-ed25519 / aes128-ctr /
hmac-sha2-256 / none — the same defaults x/crypto/ssh picks for the
reference's server (sftpd/sftp_service.go buildSSHConfig).
"""

from __future__ import annotations

import hmac
import os
import struct

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes


# -- RFC 4251 §5 data types -----------------------------------------------

def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def u8(v: int) -> bytes:
    return struct.pack(">B", v)


def ssh_string(b: bytes | str) -> bytes:
    if isinstance(b, str):
        b = b.encode()
    return u32(len(b)) + b


def ssh_bool(v: bool) -> bytes:
    return b"\x01" if v else b"\x00"


def mpint(n: int) -> bytes:
    """Minimal two's-complement big-endian with sign-bit padding."""
    if n == 0:
        return u32(0)
    b = n.to_bytes((n.bit_length() + 8) // 8, "big")
    return u32(len(b)) + b


def name_list(names: list[str]) -> bytes:
    return ssh_string(",".join(names))


class Reader:
    """Sequential decoder over one packet payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("ssh packet truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def string(self) -> bytes:
        return self._take(self.u32())

    def text(self) -> str:
        return self.string().decode()

    def boolean(self) -> bool:
        return self.u8() != 0

    def name_list(self) -> list[str]:
        s = self.text()
        return s.split(",") if s else []

    def rest(self) -> bytes:
        b = self.data[self.pos:]
        self.pos = len(self.data)
        return b


# -- RFC 4253 §7.2 key derivation -----------------------------------------

def derive_key(hash_fn, k_mpint: bytes, h: bytes, letter: bytes,
               session_id: bytes, length: int) -> bytes:
    out = hash_fn(k_mpint + h + letter + session_id).digest()
    while len(out) < length:
        out += hash_fn(k_mpint + h + out).digest()
    return out[:length]


# -- RFC 4253 §6 binary packets -------------------------------------------

class PacketStream:
    """Framed packet IO over a socket, with an armed/unarmed cipher
    state per direction.  Sequence numbers run from connection start
    (they cover the cleartext kex packets too — the MAC input is
    uint32(seq) || unencrypted_packet)."""

    MAX_PACKET = 1 << 18

    def __init__(self, sock):
        self.sock = sock
        self._rbuf = b""
        self._seq_in = 0
        self._seq_out = 0
        self._enc = None            # outgoing cipher context
        self._dec = None            # incoming cipher context
        self._mac_out = None        # outgoing hmac key
        self._mac_in = None
        self._block_out = 8
        self._block_in = 8

    def arm(self, enc_key: bytes, enc_iv: bytes, dec_key: bytes,
            dec_iv: bytes, mac_out: bytes, mac_in: bytes) -> None:
        """Switch both directions to aes128-ctr + hmac-sha2-256 after
        NEWKEYS.  CTR state is continuous across packets."""
        self._enc = Cipher(algorithms.AES(enc_key),
                           modes.CTR(enc_iv)).encryptor()
        self._dec = Cipher(algorithms.AES(dec_key),
                           modes.CTR(dec_iv)).decryptor()
        self._mac_out, self._mac_in = mac_out, mac_in
        self._block_out = self._block_in = 16

    # -- raw socket helpers ------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("ssh peer closed")
            self._rbuf += chunk
        b, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return b

    def read_version_line(self) -> str:
        """RFC 4253 §4.2: lines before the SSH- identification are
        permitted (server banner); the id line ends with CRLF."""
        for _ in range(32):
            line = b""
            while not line.endswith(b"\n"):
                line += self._recv_exact(1)
                if len(line) > 255:
                    raise ValueError("oversized ssh version line")
            text = line.rstrip(b"\r\n").decode(errors="replace")
            if text.startswith("SSH-"):
                return text
        raise ValueError("no SSH identification line")

    def write_version_line(self, version: str) -> None:
        self.sock.sendall(version.encode() + b"\r\n")

    # -- packets -----------------------------------------------------------

    def send(self, payload: bytes) -> None:
        block = self._block_out
        # 4-byte length + 1-byte padlen + payload + padding ≡ 0 mod block
        pad = block - ((5 + len(payload)) % block)
        if pad < 4:
            pad += block
        packet = (u32(1 + len(payload) + pad) + u8(pad) + payload +
                  os.urandom(pad))
        mac = b""
        if self._mac_out:
            mac = hmac.new(self._mac_out, u32(self._seq_out) + packet,
                           "sha256").digest()
            packet = self._enc.update(packet)
        self._seq_out = (self._seq_out + 1) & 0xFFFFFFFF
        self.sock.sendall(packet + mac)

    def recv(self) -> bytes:
        first = self._recv_exact(self._block_in)
        if self._dec:
            first = self._dec.update(first)
        length = struct.unpack(">I", first[:4])[0]
        if (not 5 <= length <= self.MAX_PACKET or
                (4 + length) % self._block_in != 0):
            raise ValueError(f"bad ssh packet length {length}")
        rest = self._recv_exact(4 + length - self._block_in)
        if self._dec:
            rest = self._dec.update(rest)
        packet = first + rest
        if self._mac_in:
            want = hmac.new(self._mac_in, u32(self._seq_in) + packet,
                            "sha256").digest()
            got = self._recv_exact(len(want))
            if not hmac.compare_digest(want, got):
                raise ValueError("ssh mac mismatch")
        self._seq_in = (self._seq_in + 1) & 0xFFFFFFFF
        pad = packet[4]
        payload = packet[5:4 + length - pad]
        if not payload:
            raise ValueError("empty ssh payload")
        return payload
