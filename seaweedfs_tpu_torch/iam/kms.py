"""Local KMS provider + envelope encryption (reference: weed/kms/kms.go
provider interface, weed/kms/local/local_kms.go, weed/kms/envelope.go).

Master keys live in a JSON keystore (key id -> 256-bit material);
per-object DATA keys are minted fresh, returned in plaintext for the
gateway to encrypt with, and stored only as a ciphertext blob sealed
under the master key with AES-GCM (the encryption context is bound as
GCM AAD, so a blob decrypts only with the same context — kms.go
EncryptionContext semantics).

The port's copy of `seaweedfs_tpu/iam/kms.py`.
"""

from __future__ import annotations

import base64
import json
import os
import secrets
import threading
import time

class KmsError(Exception):
    pass


def _aesgcm():
    """Lazy optional import: the `cryptography` wheel is only needed
    when envelope crypto actually runs.  Importing this module (for
    KmsError, key metadata, the store plumbing every gateway wires up)
    must work on a box without the wheel — sse.py, oidc.py and
    kms_cloud.py already follow the same rule."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:  # pragma: no cover — environment gap
        raise KmsError(
            "the `cryptography` package is required for KMS envelope "
            "encryption (pip install cryptography)") from e
    return AESGCM


class LocalKms:
    """kms/local/local_kms.go: file-backed key store, no external
    dependency.  Aliases resolve like the reference's GetKeyID."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._keys: dict[str, dict] = {}
        self._aliases: dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            self._keys = doc.get("keys", {})
            self._aliases = doc.get("aliases", {})

    def _save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"keys": self._keys, "aliases": self._aliases},
                      f, indent=1)
        os.replace(tmp, self.path)

    # -- key management ----------------------------------------------------

    def create_key(self, alias: str = "",
                   description: str = "") -> str:
        with self._lock:
            key_id = secrets.token_hex(16)
            self._keys[key_id] = {
                "material": secrets.token_hex(32),
                "description": description,
                "enabled": True,
                "created": int(time.time()),
            }
            if alias:
                self._aliases[alias.removeprefix("alias/")] = key_id
            self._save()
            return key_id

    def get_key_id(self, identifier: str) -> str:
        """Resolve alias/ARN/id to the bare key id (kms.go GetKeyID)."""
        ident = identifier.rsplit("/", 1)[-1] \
            if identifier.startswith("arn:") else identifier
        ident = ident.removeprefix("alias/")
        if ident in self._keys:
            return ident
        if ident in self._aliases:
            return self._aliases[ident]
        raise KmsError(f"NotFoundException: key {identifier}")

    def describe_key(self, identifier: str) -> dict:
        key_id = self.get_key_id(identifier)
        meta = self._keys[key_id]
        return {"KeyId": key_id,
                "Arn": f"arn:aws:kms:::key/{key_id}",
                "Enabled": meta["enabled"],
                "Description": meta["description"],
                "CreationDate": meta["created"]}

    def disable_key(self, identifier: str) -> None:
        with self._lock:
            self._keys[self.get_key_id(identifier)]["enabled"] = False
            self._save()

    def _master(self, key_id: str) -> bytes:
        meta = self._keys.get(key_id)
        if meta is None:
            raise KmsError(f"NotFoundException: key {key_id}")
        if not meta["enabled"]:
            raise KmsError(f"DisabledException: key {key_id}")
        return bytes.fromhex(meta["material"])

    # -- data keys (envelope.go) ------------------------------------------

    @staticmethod
    def _aad(context: dict | None) -> bytes:
        return json.dumps(context or {}, sort_keys=True,
                          separators=(",", ":")).encode()

    def generate_data_key(self, identifier: str,
                          context: dict | None = None) -> dict:
        """GenerateDataKey: (plaintext 32-byte key, sealed blob).  The
        blob embeds the key id so Decrypt needs no key argument —
        kms.go CiphertextBlob format."""
        key_id = self.get_key_id(identifier)
        master = self._master(key_id)
        plaintext = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        sealed = _aesgcm()(master).encrypt(nonce, plaintext,
                                           self._aad(context))
        blob = json.dumps({
            "keyId": key_id,
            "nonce": base64.b64encode(nonce).decode(),
            "sealed": base64.b64encode(sealed).decode(),
        }).encode()
        return {"KeyId": key_id, "Plaintext": plaintext,
                "CiphertextBlob": base64.b64encode(blob).decode()}

    def decrypt(self, ciphertext_blob: str,
                context: dict | None = None) -> dict:
        try:
            blob = json.loads(base64.b64decode(ciphertext_blob))
            nonce = base64.b64decode(blob["nonce"])
            sealed = base64.b64decode(blob["sealed"])
            key_id = blob["keyId"]
        except (ValueError, KeyError, TypeError):
            raise KmsError("InvalidCiphertextException: undecodable "
                           "blob")
        master = self._master(key_id)
        aesgcm = _aesgcm()
        try:
            plaintext = aesgcm(master).decrypt(nonce, sealed,
                                               self._aad(context))
        except Exception:
            raise KmsError("InvalidCiphertextException: seal or "
                           "context mismatch")
        return {"KeyId": key_id, "Plaintext": plaintext}
