"""AWS KMS wire-protocol provider, the port's copy of
`seaweedfs_tpu/iam/kms_aws.py` (reference: weed/kms/aws/aws_kms.go):
the same KMSProvider surface as LocalKms, but speaking the real AWS KMS
JSON protocol (X-Amz-Target: TrentService.*, SigV4 service "kms") to
ANY compatible endpoint — a real region, LocalStack,
or the stub the tests run.

Gives deployments an external-KMS option without bundling an SDK:
the protocol is ~three POSTs."""

from __future__ import annotations

import base64
import json

from ..s3.auth import sign_request
from ..server.httpd import http_bytes
from .kms import KmsError


class AwsKms:
    def __init__(self, endpoint: str, access_key: str,
                 secret_key: str, region: str = "us-east-1"):
        self.endpoint = endpoint.removeprefix("http://")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _call(self, target: str, body: dict) -> dict:
        payload = json.dumps(body).encode()
        headers = {
            "content-type": "application/x-amz-json-1.1",
            "x-amz-target": f"TrentService.{target}",
        }
        signed = sign_request("POST", self.endpoint, "/", {},
                              headers, payload, self.access_key,
                              self.secret_key, region=self.region,
                              service="kms")
        try:
            st, resp, _ = http_bytes("POST", f"{self.endpoint}/",
                                     payload, signed)
        except OSError as e:
            # transport failure must surface as a KmsError so the S3
            # gateway maps it to an S3 XML error, not a raw 500
            raise KmsError(f"kms {target}: endpoint unreachable "
                           f"({e})")
        try:
            doc = json.loads(resp) if resp else {}
        except ValueError:
            raise KmsError(f"kms {target}: undecodable response "
                           f"({st})")
        if st != 200:
            raise KmsError(doc.get("__type",
                                   f"kms {target}: {st}") +
                           (": " + doc["message"]
                            if doc.get("message") else ""))
        return doc

    # -- KMSProvider surface (kms.go) -------------------------------------

    def get_key_id(self, identifier: str) -> str:
        return self.describe_key(identifier)["KeyId"]

    def describe_key(self, identifier: str) -> dict:
        d = self._call("DescribeKey", {"KeyId": identifier})
        meta = d.get("KeyMetadata", {})
        return {"KeyId": meta.get("KeyId", identifier),
                "Arn": meta.get("Arn", ""),
                "Enabled": meta.get("Enabled", True),
                "Description": meta.get("Description", "")}

    def generate_data_key(self, identifier: str,
                          context: dict | None = None) -> dict:
        d = self._call("GenerateDataKey", {
            "KeyId": identifier, "KeySpec": "AES_256",
            "EncryptionContext": context or {}})
        return {"KeyId": d["KeyId"],
                "Plaintext": base64.b64decode(d["Plaintext"]),
                "CiphertextBlob": d["CiphertextBlob"]}

    def decrypt(self, ciphertext_blob: str,
                context: dict | None = None) -> dict:
        d = self._call("Decrypt", {
            "CiphertextBlob": ciphertext_blob,
            "EncryptionContext": context or {}})
        return {"KeyId": d.get("KeyId", ""),
                "Plaintext": base64.b64decode(d["Plaintext"])}


class KmsStubServer:
    """A wire-faithful KMS endpoint over LocalKms — what the tests
    (and a laptop deployment) point AwsKms at, the way the reference
    tests aws_kms.go against LocalStack."""

    def __init__(self, local_kms, host: str = "127.0.0.1",
                 port: int = 0, access_key: str = "AK",
                 secret_key: str = "SK"):
        from ..server.httpd import HttpServer
        self.kms = local_kms
        self.credentials = {access_key: secret_key}
        self.http = HttpServer(host, port)
        self.http.route("POST", "/", self._handle)

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self):
        return self.http.url

    def _handle(self, req):
        # wire-faithful includes AUTH: verify the SigV4 signature
        # (service scope "kms") like a real endpoint would
        from ..s3.auth import SigV4Verifier
        ok, who, _ = SigV4Verifier(self.credentials).verify(
            "POST", req.path, req.query,
            {k.lower(): v for k, v in req.headers.items()}, req.body)
        if not ok:
            return 403, {"__type": "IncompleteSignatureException",
                         "message": who}
        target = req.headers.get("X-Amz-Target", "").split(".")[-1]
        body = req.json()
        try:
            if target == "DescribeKey":
                meta = self.kms.describe_key(body["KeyId"])
                return 200, {"KeyMetadata": meta}
            if target == "GenerateDataKey":
                dk = self.kms.generate_data_key(
                    body["KeyId"], body.get("EncryptionContext"))
                return 200, {
                    "KeyId": dk["KeyId"],
                    "Plaintext": base64.b64encode(
                        dk["Plaintext"]).decode(),
                    "CiphertextBlob": dk["CiphertextBlob"]}
            if target == "Decrypt":
                out = self.kms.decrypt(
                    body["CiphertextBlob"],
                    body.get("EncryptionContext"))
                return 200, {
                    "KeyId": out["KeyId"],
                    "Plaintext": base64.b64encode(
                        out["Plaintext"]).decode()}
            return 400, {"__type": "UnknownOperationException"}
        except KmsError as e:
            code = str(e).split(":")[0]
            return 400, {"__type": code, "message": str(e)}
