"""AWS event-stream framing (application/vnd.amazon.eventstream) —
the response encoding SelectObjectContent uses
(s3api_object_select.go; AWS "Event Stream Encoding" spec).

Message layout:
    total_length  u32 BE
    headers_length u32 BE
    prelude_crc   u32 BE   (CRC32 of the 8 prelude bytes)
    headers:  per header: name_len u8, name, value_type u8 (7 =
              string), value_len u16 BE, value
    payload
    message_crc   u32 BE   (CRC32 of everything before it)

The port's copy of `seaweedfs_tpu/s3/eventstream.py`.
"""

from __future__ import annotations

import struct
import zlib


def encode_message(headers: "dict[str, str]", payload: bytes) -> bytes:
    hbytes = b""
    for name, value in headers.items():
        nb, vb = name.encode(), value.encode()
        hbytes += (struct.pack(">B", len(nb)) + nb + b"\x07" +
                   struct.pack(">H", len(vb)) + vb)
    total = 4 + 4 + 4 + len(hbytes) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hbytes))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hbytes + payload
    return body + struct.pack(">I", zlib.crc32(body))


def records_event(data: bytes) -> bytes:
    return encode_message({
        ":message-type": "event",
        ":event-type": "Records",
        ":content-type": "application/octet-stream"}, data)


def stats_event(bytes_scanned: int, bytes_returned: int) -> bytes:
    xml = (f"<Stats><BytesScanned>{bytes_scanned}</BytesScanned>"
           f"<BytesProcessed>{bytes_scanned}</BytesProcessed>"
           f"<BytesReturned>{bytes_returned}</BytesReturned>"
           f"</Stats>").encode()
    return encode_message({
        ":message-type": "event",
        ":event-type": "Stats",
        ":content-type": "text/xml"}, xml)


def end_event() -> bytes:
    return encode_message({":message-type": "event",
                           ":event-type": "End"}, b"")


def decode_messages(stream: bytes) -> "list[tuple[dict, bytes]]":
    """Parse a concatenated event stream (test/client side), verifying
    both CRCs."""
    out = []
    pos = 0
    while pos < len(stream):
        total, hlen = struct.unpack_from(">II", stream, pos)
        prelude_crc = struct.unpack_from(">I", stream, pos + 8)[0]
        if zlib.crc32(stream[pos:pos + 8]) != prelude_crc:
            raise ValueError("event-stream prelude CRC mismatch")
        msg = stream[pos:pos + total]
        msg_crc = struct.unpack_from(">I", msg, total - 4)[0]
        if zlib.crc32(msg[:total - 4]) != msg_crc:
            raise ValueError("event-stream message CRC mismatch")
        headers = {}
        hp = 12
        hend = 12 + hlen
        while hp < hend:
            nlen = msg[hp]
            name = msg[hp + 1:hp + 1 + nlen].decode()
            vtype = msg[hp + 1 + nlen]
            if vtype != 7:
                raise ValueError(f"unsupported header type {vtype}")
            vlen = struct.unpack_from(">H", msg, hp + 2 + nlen)[0]
            vstart = hp + 4 + nlen
            headers[name] = msg[vstart:vstart + vlen].decode()
            hp = vstart + vlen
        out.append((headers, msg[hend:total - 4]))
        pos += total
    return out
