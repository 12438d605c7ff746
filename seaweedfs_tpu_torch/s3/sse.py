"""SSE-C: server-side encryption with customer-provided keys
(weed/s3api/s3_sse_c.go).

The client supplies a 256-bit key per request; the server encrypts the
object with AES-256-CTR under a random IV (stored in entry metadata,
never the key), remembers only MD5(key) to verify later requests, and
requires the SAME key headers on every GET/HEAD:

  x-amz-server-side-encryption-customer-algorithm: AES256
  x-amz-server-side-encryption-customer-key:      base64(32-byte key)
  x-amz-server-side-encryption-customer-key-MD5:  base64(md5(key))

The port's copy of `seaweedfs_tpu/s3/sse.py`.
"""

from __future__ import annotations

import base64
import hashlib
import os

ALGO_HEADER = "x-amz-server-side-encryption-customer-algorithm"
KEY_HEADER = "x-amz-server-side-encryption-customer-key"
KEY_MD5_HEADER = "x-amz-server-side-encryption-customer-key-md5"


class SseError(ValueError):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code


def parse_sse_c_headers(headers: dict) -> "tuple[bytes, str] | None":
    """Returns (key, key_md5_b64) or None when no SSE-C headers.
    Raises SseError on malformed/mismatched headers
    (s3_sse_c.go validateSSECHeaders)."""
    algo = headers.get(ALGO_HEADER, "")
    key_b64 = headers.get(KEY_HEADER, "")
    md5_b64 = headers.get(KEY_MD5_HEADER, "")
    if not (algo or key_b64 or md5_b64):
        return None
    if algo != "AES256":
        raise SseError(400, "InvalidArgument",
                       f"unsupported SSE-C algorithm {algo!r}")
    try:
        key = base64.b64decode(key_b64)
    except ValueError:
        raise SseError(400, "InvalidArgument", "bad SSE-C key encoding")
    if len(key) != 32:
        raise SseError(400, "InvalidArgument",
                       "SSE-C key must be 256 bits")
    want_md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
    if md5_b64 != want_md5:
        raise SseError(400, "InvalidArgument", "SSE-C key MD5 mismatch")
    return key, md5_b64


def encrypt(key: bytes, plaintext: bytes) -> "tuple[bytes, str]":
    """AES-256-CTR under a fresh IV; returns (ciphertext, iv_hex)."""
    from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                        algorithms,
                                                        modes)
    iv = os.urandom(16)
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return enc.update(plaintext) + enc.finalize(), iv.hex()


def decrypt(key: bytes, iv_hex: str, ciphertext: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                        algorithms,
                                                        modes)
    dec = Cipher(algorithms.AES(key),
                 modes.CTR(bytes.fromhex(iv_hex))).decryptor()
    return dec.update(ciphertext) + dec.finalize()


def decrypt_entry(key: bytes, entry_extended: dict,
                  data: bytes) -> bytes:
    """Decrypt an object body with entry-level SSE metadata: either a
    single IV (plain PUT) or the per-part IV table a multipart
    completion records (each part was encrypted separately, CTR keeps
    lengths so ciphertext offsets == plaintext offsets)."""
    import json as _json
    parts = entry_extended.get("sseParts")
    if not parts:
        return decrypt(key, entry_extended["sseIv"], data)
    table = _json.loads(parts)
    out = bytearray(len(data))
    for i, p in enumerate(table):
        start = int(p["offset"])
        stop = int(table[i + 1]["offset"]) if i + 1 < len(table) \
            else len(data)
        out[start:stop] = decrypt(key, p["iv"], data[start:stop])
    return bytes(out)


SSE_HEADER = "x-amz-server-side-encryption"
SSE_KMS_KEY_HEADER = "x-amz-server-side-encryption-aws-kms-key-id"
DEFAULT_KMS_ALIAS = "aws/s3"   # SSE-S3 (AES256) rides a default key


def parse_sse_kms_headers(headers: dict
                          ) -> "tuple[str, str] | None":
    """Returns (mode, key_identifier) for SSE-KMS / SSE-S3 requests:
    mode is "aws:kms" or "AES256"; key id may be empty (default key).
    Raises on SSE-C + SSE-KMS on one request (mutually exclusive,
    s3_sse_kms.go validation)."""
    mode = headers.get(SSE_HEADER, "")
    if not mode:
        return None
    if mode not in ("aws:kms", "AES256"):
        raise SseError(400, "InvalidArgument",
                       f"unsupported SSE algorithm {mode!r}")
    if headers.get(KEY_HEADER):
        raise SseError(400, "InvalidArgument",
                       "SSE-C and SSE-KMS are mutually exclusive")
    return mode, headers.get(SSE_KMS_KEY_HEADER, "")


def kms_encrypt(kms, mode: str, key_identifier: str, arn: str,
                plaintext: bytes) -> "tuple[bytes, dict]":
    """Envelope-encrypt an object body: fresh data key from the KMS,
    AES-256-CTR over the body, sealed blob + IV into entry metadata
    (kms/envelope.go + s3_sse_kms.go).  The object ARN binds the
    encryption context."""
    from ..iam.kms import KmsError
    if not key_identifier:
        key_identifier = DEFAULT_KMS_ALIAS
        # probe once per provider instance: the result never changes
        # after first success, and a remote KMS would otherwise pay
        # an extra DescribeKey round-trip on EVERY default-key PUT
        if not getattr(kms, "_default_key_ok", False):
            try:
                kms.get_key_id(key_identifier)
            except KmsError as e:
                if "NotFound" not in str(e):
                    # a 503/AccessDenied is NOT a missing key —
                    # misreporting it would tell the operator to
                    # provision a key that already exists
                    raise SseError(503, "ServiceUnavailable", str(e))
                if not hasattr(kms, "create_key"):
                    # remote KMS providers don't auto-mint: the
                    # default key is provisioned out of band
                    raise SseError(400, "InvalidArgument",
                                   f"no default key "
                                   f"({DEFAULT_KMS_ALIAS}) on the "
                                   f"KMS")
                kms.create_key(alias=key_identifier,
                               description="default S3 key")
            kms._default_key_ok = True
    try:
        dk = kms.generate_data_key(key_identifier,
                                   {"aws:s3:arn": arn})
    except KmsError as e:
        # bad/disabled key ids are client errors, not gateway crashes
        raise SseError(400, "InvalidArgument", str(e))
    ciphertext, iv_hex = encrypt(dk["Plaintext"], plaintext)
    return ciphertext, {
        "sseAlgorithm": mode,
        "sseKmsKeyId": dk["KeyId"],
        "sseKmsBlob": dk["CiphertextBlob"],
        "sseIv": iv_hex,
    }


def kms_decrypt(kms, entry_extended: dict, arn: str,
                ciphertext: bytes) -> bytes:
    from ..iam.kms import KmsError
    try:
        dk = kms.decrypt(entry_extended["sseKmsBlob"],
                         {"aws:s3:arn": arn})
    except KmsError as e:
        raise SseError(403, "AccessDenied", str(e))
    return decrypt_entry(dk["Plaintext"], entry_extended, ciphertext)


def kms_response_headers(entry_extended: dict) -> dict:
    if not entry_extended.get("sseKmsBlob"):
        return {}
    h = {SSE_HEADER: entry_extended.get("sseAlgorithm", "aws:kms")}
    if h[SSE_HEADER] == "aws:kms":
        h[SSE_KMS_KEY_HEADER] = entry_extended.get("sseKmsKeyId", "")
    return h


def check_read_key(entry_extended: dict, headers: dict
                   ) -> "bytes | None":
    """For a GET/HEAD of an object: returns the key to decrypt with,
    None for unencrypted objects.  Raises SseError when the object is
    encrypted and the request's key is absent or wrong
    (s3_sse_c.go: 400 without key, 403 on mismatch)."""
    stored_md5 = entry_extended.get("sseKeyMd5", "")
    provided = parse_sse_c_headers(headers)
    if not stored_md5:
        if provided is not None:
            raise SseError(400, "InvalidArgument",
                           "object is not SSE-C encrypted")
        return None
    if provided is None:
        raise SseError(
            400, "InvalidRequest",
            "object was stored with SSE-C; the key headers are "
            "required to read it")
    key, md5_b64 = provided
    if md5_b64 != stored_md5:
        raise SseError(403, "AccessDenied", "SSE-C key does not match")
    return key
