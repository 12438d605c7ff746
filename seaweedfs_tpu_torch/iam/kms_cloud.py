"""Cloud KMS providers: GCP KMS, Azure Key Vault, OpenBao/Vault
transit, the port's copy of `seaweedfs_tpu/iam/kms_cloud.py`
(reference: weed/kms/gcp/, kms/azure/, kms/openbao/).

All three expose the same KMSProvider surface as LocalKms/AwsKms
(get_key_id / describe_key / generate_data_key / decrypt) over each
service's REST wire protocol — no SDKs.  Data-key envelopes follow
each reference provider's shape:

- GCP has no GenerateDataKey: the data key is minted locally and
  sealed through cryptoKeys/...:encrypt (gcp_kms.go does the same).
- Azure Key Vault wraps the locally-minted key via keys/.../wrapkey.
- OpenBao transit mints server-side via v1/transit/datakey/plaintext.

Ciphertext blobs are self-describing JSON naming the provider, so
Decrypt needs no out-of-band key reference.  Auth is a bearer token
(static or file-sourced) — the air-gapped test environment drives the
wire protocols against the Fake*Server twins below.
"""

from __future__ import annotations

import base64
import json
import secrets

from ..server.httpd import HttpServer, http_bytes
from .kms import KmsError


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _post_json(url: str, payload: dict, headers: dict) -> dict:
    try:
        st, resp, _ = http_bytes(
            "POST", url, json.dumps(payload).encode(),
            dict(headers, **{"Content-Type": "application/json"}))
    except OSError as e:
        raise KmsError(f"kms endpoint unreachable: {e}")
    try:
        doc = json.loads(resp) if resp else {}
    except ValueError:
        raise KmsError(f"kms: undecodable response ({st})")
    if st >= 300:
        msg = doc.get("error", doc)
        raise KmsError(f"kms: {st} {msg}")
    return doc


class GcpKms:
    """gcp_kms.go: envelope through cryptoKeys encrypt/decrypt."""

    def __init__(self, endpoint: str, key_name: str, token: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.key_name = key_name.strip("/")
        self.token = token

    def _hdrs(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} \
            if self.token else {}

    def get_key_id(self, identifier: str) -> str:
        return identifier or self.key_name

    def describe_key(self, identifier: str) -> dict:
        return {"KeyId": self.get_key_id(identifier), "Enabled": True}

    def generate_data_key(self, identifier: str,
                          context: dict | None = None) -> dict:
        key = self.get_key_id(identifier)
        plaintext = secrets.token_bytes(32)
        aad = json.dumps(context or {}, sort_keys=True).encode()
        d = _post_json(
            f"{self.endpoint}/v1/{key}:encrypt",
            {"plaintext": _b64(plaintext),
             "additionalAuthenticatedData": _b64(aad)},
            self._hdrs())
        blob = json.dumps({"provider": "gcp", "key": key,
                           "ciphertext": d["ciphertext"]}).encode()
        return {"KeyId": key, "Plaintext": plaintext,
                "CiphertextBlob": _b64(blob)}

    def decrypt(self, ciphertext_blob: str,
                context: dict | None = None) -> dict:
        try:
            blob = json.loads(base64.b64decode(ciphertext_blob))
            key, ct = blob["key"], blob["ciphertext"]
        except (ValueError, KeyError, TypeError):
            raise KmsError("InvalidCiphertextException: undecodable "
                           "blob")
        aad = json.dumps(context or {}, sort_keys=True).encode()
        d = _post_json(
            f"{self.endpoint}/v1/{key}:decrypt",
            {"ciphertext": ct,
             "additionalAuthenticatedData": _b64(aad)},
            self._hdrs())
        return {"KeyId": key,
                "Plaintext": base64.b64decode(d["plaintext"])}


class AzureKms:
    """azure_kms.go: envelope through Key Vault wrapkey/unwrapkey."""

    API = "api-version=7.4"

    def __init__(self, vault_url: str, key_name: str,
                 token: str = "", key_version: str = ""):
        self.vault = vault_url.rstrip("/")
        self.key_name = key_name
        self.key_version = key_version
        self.token = token

    def _hdrs(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} \
            if self.token else {}

    def _key_path(self, name: str) -> str:
        ver = f"/{self.key_version}" if self.key_version else "/"
        return f"/keys/{name}{ver}".rstrip("/")

    def get_key_id(self, identifier: str) -> str:
        return identifier or self.key_name

    def describe_key(self, identifier: str) -> dict:
        return {"KeyId": self.get_key_id(identifier), "Enabled": True}

    def generate_data_key(self, identifier: str,
                          context: dict | None = None) -> dict:
        name = self.get_key_id(identifier)
        plaintext = secrets.token_bytes(32)
        d = _post_json(
            f"{self.vault}{self._key_path(name)}/wrapkey?{self.API}",
            {"alg": "RSA-OAEP-256", "value": _b64url(plaintext)},
            self._hdrs())
        blob = json.dumps({"provider": "azure", "key": name,
                           "wrapped": d["value"],
                           "kid": d.get("kid", "")}).encode()
        return {"KeyId": name, "Plaintext": plaintext,
                "CiphertextBlob": _b64(blob)}

    def decrypt(self, ciphertext_blob: str,
                context: dict | None = None) -> dict:
        try:
            blob = json.loads(base64.b64decode(ciphertext_blob))
            name, wrapped = blob["key"], blob["wrapped"]
        except (ValueError, KeyError, TypeError):
            raise KmsError("InvalidCiphertextException: undecodable "
                           "blob")
        d = _post_json(
            f"{self.vault}{self._key_path(name)}/unwrapkey?{self.API}",
            {"alg": "RSA-OAEP-256", "value": wrapped}, self._hdrs())
        return {"KeyId": name, "Plaintext": _unb64url(d["value"])}


class OpenBaoKms:
    """openbao_kms.go: transit engine datakey/decrypt."""

    def __init__(self, addr: str, key_name: str, token: str = ""):
        self.addr = addr.rstrip("/")
        self.key_name = key_name
        self.token = token

    def _hdrs(self) -> dict:
        return {"X-Vault-Token": self.token} if self.token else {}

    def get_key_id(self, identifier: str) -> str:
        return identifier or self.key_name

    def describe_key(self, identifier: str) -> dict:
        return {"KeyId": self.get_key_id(identifier), "Enabled": True}

    def generate_data_key(self, identifier: str,
                          context: dict | None = None) -> dict:
        name = self.get_key_id(identifier)
        body = {}
        if context:
            body["context"] = _b64(json.dumps(
                context, sort_keys=True).encode())
        d = _post_json(
            f"{self.addr}/v1/transit/datakey/plaintext/{name}",
            body, self._hdrs())["data"]
        blob = json.dumps({"provider": "openbao", "key": name,
                           "ciphertext": d["ciphertext"]}).encode()
        return {"KeyId": name,
                "Plaintext": base64.b64decode(d["plaintext"]),
                "CiphertextBlob": _b64(blob)}

    def decrypt(self, ciphertext_blob: str,
                context: dict | None = None) -> dict:
        try:
            blob = json.loads(base64.b64decode(ciphertext_blob))
            name, ct = blob["key"], blob["ciphertext"]
        except (ValueError, KeyError, TypeError):
            raise KmsError("InvalidCiphertextException: undecodable "
                           "blob")
        body = {"ciphertext": ct}
        if context:
            body["context"] = _b64(json.dumps(
                context, sort_keys=True).encode())
        d = _post_json(f"{self.addr}/v1/transit/decrypt/{name}",
                       body, self._hdrs())["data"]
        return {"KeyId": name,
                "Plaintext": base64.b64decode(d["plaintext"])}


# -- wire-faithful fakes (tests / air-gapped dev) -------------------------

class _FakeBase:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: str = "testtoken"):
        self.token = token
        self.http = HttpServer(host, port)
        self.http.fallback = self._route
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        self._aesgcm = AESGCM(secrets.token_bytes(32))

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self) -> str:
        return f"http://{self.http.url}"

    def _seal(self, plaintext: bytes) -> str:
        nonce = secrets.token_bytes(12)
        return _b64(nonce + self._aesgcm.encrypt(nonce, plaintext,
                                                 b""))

    def _unseal(self, ct: str) -> bytes:
        raw = base64.b64decode(ct)
        return self._aesgcm.decrypt(raw[:12], raw[12:], b"")


class FakeGcpKmsServer(_FakeBase):
    def _route(self, req):
        if req.headers.get("Authorization") != f"Bearer {self.token}":
            return 401, {"error": "unauthenticated"}
        body = json.loads(req.body or b"{}")
        if req.path.endswith(":encrypt"):
            pt = base64.b64decode(body["plaintext"])
            return 200, {"ciphertext": self._seal(pt)}
        if req.path.endswith(":decrypt"):
            try:
                return 200, {"plaintext": _b64(
                    self._unseal(body["ciphertext"]))}
            except Exception:
                return 400, {"error": "decryption failed"}
        return 404, {"error": req.path}


class FakeAzureKeyVaultServer(_FakeBase):
    def _route(self, req):
        if req.headers.get("Authorization") != f"Bearer {self.token}":
            return 401, {"error": "unauthenticated"}
        body = json.loads(req.body or b"{}")
        if req.path.endswith("/wrapkey"):
            pt = _unb64url(body["value"])
            return 200, {"kid": req.path, "value": _b64url(
                self._seal(pt).encode())}
        if req.path.endswith("/unwrapkey"):
            try:
                sealed = _unb64url(body["value"]).decode()
                return 200, {"value": _b64url(self._unseal(sealed))}
            except Exception:
                return 400, {"error": "unwrap failed"}
        return 404, {"error": req.path}


class FakeOpenBaoServer(_FakeBase):
    def _route(self, req):
        if req.headers.get("X-Vault-Token") != self.token:
            return 403, {"error": "permission denied"}
        body = json.loads(req.body or b"{}")
        if "/transit/datakey/plaintext/" in req.path:
            pt = secrets.token_bytes(32)
            return 200, {"data": {
                "plaintext": _b64(pt),
                "ciphertext": "vault:v1:" + self._seal(pt)}}
        if "/transit/decrypt/" in req.path:
            ct = body.get("ciphertext", "")
            if not ct.startswith("vault:v1:"):
                return 400, {"error": "bad ciphertext"}
            try:
                return 200, {"data": {"plaintext": _b64(
                    self._unseal(ct[len("vault:v1:"):]))}}
            except Exception:
                return 400, {"error": "decryption failed"}
        return 404, {"error": req.path}
