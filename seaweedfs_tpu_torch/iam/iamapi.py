"""AWS IAM-compatible REST API + STS endpoint, the port's copy of
`seaweedfs_tpu/iam/iamapi.py` (reference: weed/iamapi/iamapi_server.go
+ iamapi_management_handlers.go, and the AssumeRole surface of
weed/iam/sts/).  HTTP only: the JAX server's gRPC twin of this plane
runs only where `grpcio` is installed, and the port has no gRPC.

Form-encoded `Action=...` POSTs, XML responses, mutating the shared
IdentityStore the S3 gateway authorizes against.  Management actions
require a SigV4 signature from an admin identity; AssumeRole accepts
any enabled identity (the role's trust list decides).

Policy translation mirrors iamapi GetActions: IAM policy documents are
compressed to the coarse identity actions ("Read:bucket/prefix", ...)
that auth_credentials.go CanDo evaluates.
"""

from __future__ import annotations

import secrets
import string
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..s3.auth import SigV4Verifier
from ..server.httpd import HttpServer, Request
from .identity import Credential, Identity, IdentityStore
from .policy_actions import IamError, policy_to_actions
from .sts import StsError, StsService

__all__ = ["IamApiServer", "IamError", "policy_to_actions"]


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root)


def _response(action: str, fill) -> "tuple[int, tuple]":
    root = ET.Element(
        f"{action}Response",
        xmlns="https://iam.amazonaws.com/doc/2010-05-08/")
    result = ET.SubElement(root, f"{action}Result")
    fill(result)
    meta = ET.SubElement(root, "ResponseMetadata")
    ET.SubElement(meta, "RequestId").text = str(uuid.uuid4())
    return 200, (_xml(root), "application/xml")


def _error_xml(status: int, code: str, message: str):
    root = ET.Element("ErrorResponse")
    err = ET.SubElement(root, "Error")
    ET.SubElement(err, "Code").text = code
    ET.SubElement(err, "Message").text = message
    return status, (_xml(root), "application/xml")


def _user_xml(parent: ET.Element, ident: Identity) -> None:
    u = ET.SubElement(parent, "User")
    ET.SubElement(u, "UserName").text = ident.name
    ET.SubElement(u, "UserId").text = ident.name
    ET.SubElement(u, "Arn").text = ident.principal_arn


class IamApiServer:
    """One HTTP server exposing the IAM management API and AssumeRole,
    sharing the identity store with the S3 gateway."""

    def __init__(self, store: IdentityStore,
                 sts: StsService | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self.sts = sts
        self.verifier = SigV4Verifier(store.secrets_view(), sts=sts)
        self.http = HttpServer(host, port)
        self.http.route("POST", "/", self._handle)

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self) -> str:
        return self.http.url

    # -- request plumbing --------------------------------------------------

    def _caller(self, req: Request) -> Identity | None:
        ok, who, ctx = self.verifier.verify(
            "POST", req.path, req.query,
            {k.lower(): v for k, v in req.headers.items()}, req.body)
        if not ok:
            return None
        if ctx is not None and ctx.sts_identity is not None:
            return ctx.sts_identity
        return self.store.by_access_key(who)

    def _handle(self, req: Request):
        form = {k: v[0] for k, v in
                urllib.parse.parse_qs(req.body.decode()).items()}
        action = form.get("Action", "")
        if action == "AssumeRoleWithWebIdentity":
            # the web-identity TOKEN is the credential — no SigV4
            # (AWS STS semantics; sts_service.go:431)
            return self._assume_role_with_web_identity(form)
        caller = self._caller(req)
        if caller is None:
            return _error_xml(403, "AccessDenied",
                              "request must be signed by a known "
                              "identity")
        try:
            if action == "AssumeRole":
                return self._assume_role(caller, form)
            if not caller.is_admin:
                return _error_xml(403, "AccessDenied",
                                  "management actions require an "
                                  "admin identity")
            fn = getattr(self, f"_do_{action}", None)
            if fn is None:
                return _error_xml(400, "InvalidAction", action)
            return fn(form)
        except IamError as e:
            return _error_xml(e.status, e.code, str(e))

    def _need_user(self, form: dict) -> Identity:
        name = form.get("UserName", "")
        ident = self.store.get(name)
        if ident is None:
            raise IamError(404, "NoSuchEntity", f"user {name}")
        return ident

    # -- user management ---------------------------------------------------

    def _do_CreateUser(self, form: dict):
        name = form.get("UserName", "")
        if not name:
            raise IamError(400, "InvalidInput", "UserName required")
        if self.store.get(name) is not None:
            raise IamError(409, "EntityAlreadyExists", name)
        ident = Identity(name, actions=[])
        self.store.put(ident)
        return _response("CreateUser",
                         lambda r: _user_xml(r, ident))

    def _do_GetUser(self, form: dict):
        ident = self._need_user(form)
        return _response("GetUser", lambda r: _user_xml(r, ident))

    def _do_UpdateUser(self, form: dict):
        ident = self._need_user(form)
        new_name = form.get("NewUserName", "")
        if new_name:
            if new_name != ident.name and \
                    self.store.get(new_name) is not None:
                raise IamError(409, "EntityAlreadyExists", new_name)
            self.store.delete(ident.name)
            ident.name = new_name
            ident.principal_arn = f"arn:aws:iam:::user/{new_name}"
            self.store.put(ident)
        return _response("UpdateUser", lambda r: _user_xml(r, ident))

    def _do_DeleteUser(self, form: dict):
        ident = self._need_user(form)
        self.store.delete(ident.name)
        return _response("DeleteUser", lambda r: None)

    def _do_ListUsers(self, form: dict):
        def fill(r):
            users = ET.SubElement(r, "Users")
            for ident in self.store:
                _user_xml(users, ident)
        return _response("ListUsers", fill)

    # -- access keys -------------------------------------------------------

    def _do_CreateAccessKey(self, form: dict):
        ident = self._need_user(form)
        alphabet = string.ascii_uppercase + string.digits
        access = "AKID" + "".join(secrets.choice(alphabet)
                                  for _ in range(16))
        secret = secrets.token_urlsafe(30)
        ident.credentials.append(Credential(access, secret))
        self.store.put(ident)

        def fill(r):
            k = ET.SubElement(r, "AccessKey")
            ET.SubElement(k, "UserName").text = ident.name
            ET.SubElement(k, "AccessKeyId").text = access
            ET.SubElement(k, "SecretAccessKey").text = secret
            ET.SubElement(k, "Status").text = "Active"
        return _response("CreateAccessKey", fill)

    def _do_DeleteAccessKey(self, form: dict):
        ident = self._need_user(form)
        key_id = form.get("AccessKeyId", "")
        before = len(ident.credentials)
        ident.credentials = [c for c in ident.credentials
                             if c.access_key != key_id]
        if len(ident.credentials) == before:
            raise IamError(404, "NoSuchEntity", key_id)
        self.store.put(ident)
        return _response("DeleteAccessKey", lambda r: None)

    def _do_ListAccessKeys(self, form: dict):
        ident = self._need_user(form)

        def fill(r):
            members = ET.SubElement(r, "AccessKeyMetadata")
            for c in ident.credentials:
                m = ET.SubElement(members, "member")
                ET.SubElement(m, "UserName").text = ident.name
                ET.SubElement(m, "AccessKeyId").text = c.access_key
                ET.SubElement(m, "Status").text = c.status
        return _response("ListAccessKeys", fill)

    # -- inline policies ---------------------------------------------------

    def _recompute_actions(self, ident: Identity) -> None:
        """static provisioned actions ∪ all inline policies
        (computeAggregatedActionsForUser) — never strips the static
        set, so attaching a policy to an admin can't drop Admin."""
        actions: set[str] = set(ident.static_actions)
        for doc in ident.policies.values():
            actions.update(policy_to_actions(doc))
        ident.actions = sorted(actions)

    def _do_PutUserPolicy(self, form: dict):
        ident = self._need_user(form)
        name = form.get("PolicyName", "")
        doc = form.get("PolicyDocument", "")
        policy_to_actions(doc)          # validate before storing
        ident.policies[name] = doc
        self._recompute_actions(ident)
        self.store.put(ident)
        return _response("PutUserPolicy", lambda r: None)

    def _do_GetUserPolicy(self, form: dict):
        ident = self._need_user(form)
        name = form.get("PolicyName", "")
        if name not in ident.policies:
            raise IamError(404, "NoSuchEntity", name)

        def fill(r):
            ET.SubElement(r, "UserName").text = ident.name
            ET.SubElement(r, "PolicyName").text = name
            ET.SubElement(r, "PolicyDocument").text = \
                urllib.parse.quote(ident.policies[name])
        return _response("GetUserPolicy", fill)

    def _do_DeleteUserPolicy(self, form: dict):
        ident = self._need_user(form)
        name = form.get("PolicyName", "")
        if ident.policies.pop(name, None) is None:
            raise IamError(404, "NoSuchEntity", name)
        self._recompute_actions(ident)
        self.store.put(ident)
        return _response("DeleteUserPolicy", lambda r: None)

    def _do_ListUserPolicies(self, form: dict):
        ident = self._need_user(form)

        def fill(r):
            names = ET.SubElement(r, "PolicyNames")
            for n in ident.policies:
                ET.SubElement(names, "member").text = n
        return _response("ListUserPolicies", fill)

    # -- STS ---------------------------------------------------------------

    @staticmethod
    def _parse_assume_form(form: dict):
        """(role, session, duration) shared by both AssumeRole
        flavors; raises IamError on bad input."""
        role = form.get("RoleArn", "") or form.get("RoleName", "")
        role = role.rsplit("/", 1)[-1]
        session = form.get("RoleSessionName", "session")
        try:
            duration = int(form.get("DurationSeconds", "3600"))
        except ValueError:
            raise IamError(400, "InvalidInput",
                           "DurationSeconds must be an integer")
        return role, session, duration

    @staticmethod
    def _credentials_response(action: str, creds: dict):
        import time as _time

        def fill(r):
            c = ET.SubElement(r, "Credentials")
            for tag in ("AccessKeyId", "SecretAccessKey",
                        "SessionToken"):
                ET.SubElement(c, tag).text = str(creds[tag])
            # AWS wire format: ISO 8601, not a raw epoch
            ET.SubElement(c, "Expiration").text = _time.strftime(
                "%Y-%m-%dT%H:%M:%SZ",
                _time.gmtime(int(creds["Expiration"])))
            ET.SubElement(r, "AssumedRoleUser")
        return _response(action, fill)

    def _assume_role_with_web_identity(self, form: dict):
        if self.sts is None:
            return _error_xml(400, "InvalidAction",
                              "no STS service configured")
        try:
            role, session, duration = self._parse_assume_form(form)
            creds = self.sts.assume_role_with_web_identity(
                form.get("WebIdentityToken", ""), role, session,
                duration)
        except IamError as e:
            return _error_xml(e.status, e.code, str(e))
        except StsError as e:
            return _error_xml(403, "AccessDenied", str(e))
        return self._credentials_response("AssumeRoleWithWebIdentity",
                                          creds)

    def _assume_role(self, caller: Identity, form: dict):
        if self.sts is None:
            return _error_xml(400, "InvalidAction",
                              "no STS service configured")
        try:
            role, session, duration = self._parse_assume_form(form)
            creds = self.sts.assume_role(caller, role, session,
                                         duration)
        except IamError as e:
            return _error_xml(e.status, e.code, str(e))
        except StsError as e:
            return _error_xml(403, "AccessDenied", str(e))
        return self._credentials_response("AssumeRole", creds)
