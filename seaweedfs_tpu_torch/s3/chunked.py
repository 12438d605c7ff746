"""Streaming-chunked SigV4 payload codec
(weed/s3api/chunked_reader_v4.go).

Clients that sign uploads with `x-amz-content-sha256:
STREAMING-AWS4-HMAC-SHA256-PAYLOAD` send the body as aws-chunked
frames, each carrying its own signature chained from the previous one
(seeded by the Authorization header's signature):

    <hex-size>;chunk-signature=<sig64>\r\n
    <data>\r\n
    ...
    0;chunk-signature=<final-sig>\r\n\r\n

Each chunk's signature is HMAC(signing_key,
"AWS4-HMAC-SHA256-PAYLOAD\\n{date}\\n{scope}\\n{prev}\\n{sha256('')}\\n
{sha256(data)}") — chunk_string_to_sign in auth.py.  The decoder
verifies every frame and the final empty frame, so a tampered or
truncated stream is rejected as a whole.

The port's copy of `seaweedfs_tpu/s3/chunked.py`.
"""

from __future__ import annotations

import hashlib
import hmac

from .auth import AuthContext, chunk_string_to_sign


class ChunkedDecodeError(ValueError):
    pass


def decode_streaming_body(body: bytes, ctx: AuthContext | None
                          ) -> bytes:
    """Verify and strip the aws-chunked framing; returns the payload.
    Raises ChunkedDecodeError on any malformed frame or signature
    mismatch (chunked_reader_v4.go readChunkedBody).  With ctx=None
    (gateway running without credentials) the framing is stripped but
    signatures cannot be checked — there is no secret to check against."""
    out = bytearray()
    prev_sig = ctx.seed_signature if ctx else ""
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise ChunkedDecodeError("truncated chunk header")
        header = body[pos:nl].decode("latin-1")
        size_hex, _, ext = header.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise ChunkedDecodeError(f"bad chunk size {size_hex!r}")
        if ext.startswith("chunk-signature="):
            sig = ext[len("chunk-signature="):]
        else:
            raise ChunkedDecodeError("missing chunk-signature")
        data_start = nl + 2
        data_end = data_start + size
        if data_end > len(body):
            raise ChunkedDecodeError("truncated chunk data")
        data = body[data_start:data_end]
        if ctx is not None:
            want = hmac.new(
                ctx.signing_key,
                chunk_string_to_sign(prev_sig, ctx.amz_date, ctx.scope,
                                     data).encode(),
                hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise ChunkedDecodeError("chunk signature mismatch")
        prev_sig = sig
        if size == 0:
            return bytes(out)
        out += data
        pos = data_end
        if body[pos:pos + 2] == b"\r\n":
            pos += 2


def encode_streaming_body(payload: bytes, ctx: AuthContext,
                          chunk_size: int = 64 * 1024) -> bytes:
    """Client-side encoder (what an SDK does) — used by tests and the
    benchmark tool to exercise the decode path end-to-end."""
    out = bytearray()
    prev_sig = ctx.seed_signature
    offsets = list(range(0, len(payload), chunk_size)) or [0]
    pieces = [payload[o:o + chunk_size] for o in offsets]
    if pieces[-1]:
        pieces.append(b"")  # final zero chunk
    for data in pieces:
        sig = hmac.new(
            ctx.signing_key,
            chunk_string_to_sign(prev_sig, ctx.amz_date, ctx.scope,
                                 data).encode(),
            hashlib.sha256).hexdigest()
        out += f"{len(data):x};chunk-signature={sig}\r\n".encode()
        out += data
        out += b"\r\n"
        prev_sig = sig
    return bytes(out)
