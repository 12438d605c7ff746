"""Identity model + store (reference: weed/s3api/auth_credentials.go
Identity/Account/Credential and its s3.json config format, plus
weed/credential/ store archetypes).

Identities carry COARSE actions ("Admin", "Read:bucket/prefix",
"Write:bucket", ...) — the reference's first authorization layer,
evaluated before (and independently of) bucket-policy documents.

The port's copy of `seaweedfs_tpu/iam/identity.py`.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading

from ..util import wlog

# s3_constants/s3_actions.go
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"
ACTION_ADMIN = "Admin"
ACTION_DELETE_BUCKET = "DeleteBucket"
ACTION_READ_ACP = "ReadAcp"
ACTION_WRITE_ACP = "WriteAcp"
ACTION_BYPASS_GOVERNANCE = "BypassGovernanceRetention"

# auth_credentials.go:1534 CanDo consults these in order:
#   exact action, then "<Action>:<bucket[/key]>" patterns with
#   wildcards, then Admin-scoped equivalents.


def coarse_action(s3_action: str, method: str = "",
                  query: dict | None = None) -> str:
    """Map the fine-grained s3:* action names (policy engine
    vocabulary) onto the reference's coarse identity actions — the
    mapping s3api_server.go encodes by wrapping each route in
    iam.Auth(handler, ACTION_X)."""
    q = query or {}
    a = s3_action.removeprefix("s3:")
    if a in ("GetObjectRetention", "GetObjectLegalHold"):
        return ACTION_READ
    if a in ("PutObjectRetention", "PutObjectLegalHold"):
        return ACTION_WRITE
    if "Tagging" in a:
        return ACTION_TAGGING
    if a.endswith("Acl"):
        return ACTION_READ_ACP if a.startswith("Get") else \
            ACTION_WRITE_ACP
    if a == "DeleteBucket":
        return ACTION_DELETE_BUCKET
    if a.startswith("List"):
        return ACTION_LIST
    if a in ("GetObject", "GetObjectVersion", "HeadObject"):
        return ACTION_READ
    if a in ("PutObject", "DeleteObject", "DeleteObjectVersion",
             "AbortMultipartUpload", "RestoreObject"):
        return ACTION_WRITE
    if a == "CreateBucket":
        return ACTION_ADMIN
    # bucket configuration subresources (policy/cors/versioning/
    # object-lock/encryption/...) are admin-plane
    return ACTION_ADMIN


class Credential:
    def __init__(self, access_key: str, secret_key: str,
                 status: str = "Active"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.status = status

    def to_json(self) -> dict:
        return {"accessKey": self.access_key,
                "secretKey": self.secret_key, "status": self.status}

    @classmethod
    def from_json(cls, d: dict) -> "Credential":
        return cls(d["accessKey"], d["secretKey"],
                   d.get("status", "Active"))


class Account:
    """auth_credentials.go Account: the ownership principal S3 ACLs
    name.  The three canned accounts mirror the reference."""

    def __init__(self, acc_id: str, display_name: str = "",
                 email: str = ""):
        self.id = acc_id
        self.display_name = display_name or acc_id
        self.email = email

    def to_json(self) -> dict:
        return {"id": self.id, "displayName": self.display_name,
                "emailAddress": self.email}

    @classmethod
    def from_json(cls, d: dict) -> "Account":
        return cls(d.get("id", ""), d.get("displayName", ""),
                   d.get("emailAddress", ""))


ACCOUNT_ADMIN = Account("admin", "admin")
ACCOUNT_ANONYMOUS = Account("anonymous", "anonymous")


class Identity:
    def __init__(self, name: str,
                 credentials: list[Credential] | None = None,
                 actions: list[str] | None = None,
                 account: Account | None = None,
                 disabled: bool = False,
                 principal_arn: str = ""):
        self.name = name
        self.credentials = credentials or []
        self.actions = actions or []
        self.account = account or ACCOUNT_ADMIN
        self.disabled = disabled
        self.principal_arn = principal_arn or \
            f"arn:aws:iam:::user/{name}"
        # inline IAM policy documents by name (iamapi PutUserPolicy);
        # identity.actions holds static_actions ∪ their translation
        self.policies: dict[str, str] = {}
        # grants inherited through group membership (iam.proto Group
        # policy_names, evaluated in auth_credentials.go
        # evaluateIAMPolicies) — maintained by the IdentityStore, not
        # serialized: they are derived state, recomputed on every
        # group/policy mutation so detaching a policy from a group
        # revokes it from every member atomically
        self.group_actions: list[str] = []
        # actions provisioned directly (identities JSON / operator) —
        # policy recomputation must never strip these, or attaching a
        # policy to the admin identity would drop Admin (lockout)
        self.static_actions: list[str] = list(actions or [])

    @property
    def is_admin(self) -> bool:
        return ACTION_ADMIN in self.actions or \
            ACTION_ADMIN in self.group_actions

    def granted_actions(self) -> list[str]:
        """Own actions ∪ group-inherited ones — the set CanDo
        consults (reference: identity actions + group policy
        evaluation are independent allow paths)."""
        if not self.group_actions:
            return self.actions
        return list(self.actions) + [a for a in self.group_actions
                                     if a not in self.actions]

    def can_do(self, action: str, bucket: str, key: str = "") -> bool:
        """auth_credentials.go:1534 CanDo: exact action grants the
        whole system; otherwise match "<Action>:<bucket[/key]>"
        entries (wildcards allowed) with Admin:<scope> as superset."""
        if self.disabled:
            return False
        if self.is_admin:
            return True
        granted = self.granted_actions()
        if action in granted:
            return True
        if not bucket:
            return False
        full = bucket + ("/" + key.lstrip("/") if key else "")
        targets = (f"{action}:{full}", f"{ACTION_ADMIN}:{full}")
        for a in granted:
            if ":" not in a:
                continue
            if "*" in a or "?" in a:
                # wildcard entries match the fully-qualified target
                # (auth_credentials.go MatchesWildcard branch)
                if any(fnmatch.fnmatchcase(t, a) for t in targets):
                    return True
                continue
            act, _, scope = a.partition(":")
            if act not in (action, ACTION_ADMIN):
                continue
            # exact scope, bucket-limited scope, or path-prefix scope
            if scope in (full, bucket) or \
                    full.startswith(scope.rstrip("/") + "/"):
                return True
        return False

    def to_json(self) -> dict:
        return {"name": self.name,
                "credentials": [c.to_json() for c in self.credentials],
                "actions": list(self.actions),
                "staticActions": list(self.static_actions),
                "account": self.account.to_json(),
                "disabled": self.disabled,
                "principalArn": self.principal_arn,
                "policies": dict(self.policies)}

    @classmethod
    def from_json(cls, d: dict) -> "Identity":
        ident = cls(d["name"],
                    [Credential.from_json(c)
                     for c in d.get("credentials", [])],
                    list(d.get("actions", [])),
                    Account.from_json(d["account"])
                    if d.get("account") else None,
                    d.get("disabled", False),
                    d.get("principalArn", ""))
        ident.policies = dict(d.get("policies", {}))
        if "staticActions" in d:
            ident.static_actions = list(d["staticActions"])
        elif ident.policies:
            # migration: an older save serialized actions as
            # static ∪ policy-derived; re-deriving and subtracting
            # keeps policy grants revocable (DeleteUserPolicy must
            # not leave them baked into the static set forever).
            # Ambiguity: a static grant that COINCIDES with a policy
            # grant is also subtracted and will disappear when that
            # policy is deleted — fail-closed (losing a grant) is
            # preferred over fail-open (an irrevocable one); re-grant
            # via UpdateUser if that static action was intended
            try:
                from .policy_actions import IamError, policy_to_actions
                derived = set()
                for doc in ident.policies.values():
                    derived.update(policy_to_actions(doc))
                ident.static_actions = [a for a in ident.actions
                                        if a not in derived]
            except (IamError, AttributeError, KeyError, TypeError,
                    ValueError):
                pass     # undecodable legacy doc: keep all actions
        # else: a hand-written identities JSON — its actions ARE the
        # static provisioned set (the cls(...) call captured them)
        return ident


class IdentityStore:
    """The s3.json identities config as a mutable, persistent store
    (credential/credential_store.go role).  Backing file is optional —
    gateways can run with a purely in-memory store for tests."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.RLock()
        self._identities: dict[str, Identity] = {}
        self._by_access_key: dict[str, Identity] = {}
        # managed policies (iam_pb.Policy name -> JSON content) and
        # groups (iam_pb.Group), the filer-propagated config the
        # reference carries in S3ApiConfiguration
        self._policies: dict[str, str] = {}
        self._groups: dict[str, dict] = {}
        # service accounts (iam.proto ServiceAccount: application
        # credentials parented to a user, optionally restricted to a
        # subset of its actions, optionally expiring)
        self._service_accounts: dict[str, dict] = {}
        self._sa_by_key: dict[str, dict] = {}
        self._mtime = 0.0
        if path and os.path.exists(path):
            with self._lock:
                self._reload()

    def _reload(self) -> None:
        """Caller holds the lock."""
        with open(self.path) as f:
            self.load_json(json.load(f))
        self._mtime = os.stat(self.path).st_mtime

    def _maybe_reload(self) -> None:
        """An `iam` server process and an `s3` gateway process share
        the store through its JSON file; the reference propagates
        config through the filer (credential/propagating_store.go) —
        here an mtime check on lookup keeps readers current."""
        if not self.path:
            return
        try:
            m = os.stat(self.path).st_mtime
        except OSError:
            return
        if m != self._mtime:
            with self._lock:
                if m != self._mtime:
                    self._reload()

    # -- config IO ---------------------------------------------------------

    def load_json(self, doc: dict) -> None:
        """Build fresh maps, then swap the references atomically —
        lock-free readers (every request thread) must never observe
        the cleared-but-not-rebuilt intermediate state."""
        identities: dict[str, Identity] = {}
        by_key: dict[str, Identity] = {}
        for d in doc.get("identities", []):
            ident = Identity.from_json(d)
            identities[ident.name] = ident
            for c in ident.credentials:
                by_key[c.access_key] = ident
        sas = {sa["id"]: sa for sa in doc.get("serviceAccounts", [])}
        with self._lock:
            self._identities = identities
            self._by_access_key = by_key
            self._policies = dict(doc.get("policies", {}))
            self._groups = dict(doc.get("groups", {}))
            self._service_accounts = sas
            self._sa_by_key = {
                sa["credential"]["accessKey"]: sa
                for sa in sas.values() if sa.get("credential")}
            self._recompute_group_grants()

    def to_json(self) -> dict:
        with self._lock:
            out = {"identities": [i.to_json()
                                  for i in self._identities.values()]}
            if self._policies:
                out["policies"] = dict(self._policies)
            if self._groups:
                out["groups"] = dict(self._groups)
            if self._service_accounts:
                out["serviceAccounts"] = \
                    list(self._service_accounts.values())
            return out

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.to_json(), f, indent=1)
            os.replace(tmp, self.path)
            self._mtime = os.stat(self.path).st_mtime

    def _index(self, ident: Identity) -> None:
        """Caller holds the lock."""
        self._identities[ident.name] = ident
        for c in ident.credentials:
            self._by_access_key[c.access_key] = ident

    # -- lookups -----------------------------------------------------------

    def get(self, name: str) -> Identity | None:
        self._maybe_reload()
        return self._identities.get(name)

    def by_access_key(self, access_key: str) -> Identity | None:
        self._maybe_reload()
        ident = self._by_access_key.get(access_key)
        if ident is not None:
            return ident
        sa = self._sa_by_key.get(access_key)
        if sa is not None:
            return self._sa_identity(sa)
        return None

    def _sa_identity(self, sa: dict) -> Identity | None:
        """Synthesize the auth-time Identity for a service-account
        credential (auth_credentials.go loads ServiceAccounts into
        the same access-key index).  Acts AS the parent user (bucket
        ownership, policy principal) but with the SA's restricted
        action set when one was given; dead if the SA is disabled /
        expired or the parent is gone / disabled."""
        parent = self._identities.get(sa.get("parentUser", ""))
        if parent is None:
            return None
        import time as _t
        exp = sa.get("expiration", 0)
        dead = (sa.get("disabled", False) or parent.disabled or
                (exp and exp < _t.time()))
        restricted = list(sa.get("actions") or ())
        if restricted:
            # the subset invariant is enforced at AUTH time, not just
            # at creation: revoking a grant from the parent must also
            # revoke it from every service account that named it —
            # otherwise an operator auditing the parent sees no
            # access while the SA's writes keep landing
            kept = []
            for a in restricted:
                act, _, scope = a.partition(":")
                bucket, _, key = scope.partition("/")
                if parent.can_do(act, bucket, key):
                    kept.append(a)
            restricted = kept or ["__none__"]   # all revoked: dead
        ident = Identity(
            parent.name,
            [Credential.from_json(sa["credential"])],
            restricted or list(parent.actions),
            parent.account, disabled=bool(dead),
            principal_arn=parent.principal_arn)
        if not sa.get("actions"):
            # unrestricted SA inherits the parent's group grants too;
            # a restricted one is capped at exactly its action list
            ident.group_actions = list(parent.group_actions)
        return ident

    def secret_for(self, access_key: str) -> str | None:
        ident = self.by_access_key(access_key)
        if ident is None or ident.disabled:
            return None
        for c in ident.credentials:
            if c.access_key == access_key and c.status == "Active":
                return c.secret_key
        return None

    def anonymous(self) -> Identity | None:
        """auth_credentials.go: an identity literally named
        "anonymous" grants unauthenticated requests its actions."""
        return self.get("anonymous")

    def __iter__(self):
        with self._lock:
            return iter(list(self._identities.values()))

    # -- mutation (iamapi writes through these) ---------------------------

    def put(self, ident: Identity) -> None:
        with self._lock:
            old = self._identities.get(ident.name)
            if old is not None:
                for c in old.credentials:
                    self._by_access_key.pop(c.access_key, None)
            self._index(ident)
            self._recompute_group_grants()
            self.save()

    def delete(self, name: str) -> None:
        with self._lock:
            old = self._identities.pop(name, None)
            if old is not None:
                for c in old.credentials:
                    self._by_access_key.pop(c.access_key, None)
                self.save()

    # -- managed policies + groups (iam.proto Policy/Group) ---------------

    def put_policy(self, name: str, content: str) -> None:
        with self._lock:
            self._policies[name] = content
            self._recompute_group_grants()
            self.save()

    def get_policy(self, name: str) -> "str | None":
        self._maybe_reload()
        return self._policies.get(name)

    def list_policies(self) -> "dict[str, str]":
        self._maybe_reload()
        with self._lock:
            return dict(self._policies)

    def delete_policy(self, name: str) -> None:
        with self._lock:
            self._policies.pop(name, None)
            self._recompute_group_grants()
            self.save()

    def _recompute_group_grants(self) -> None:
        """Refresh every identity's derived group_actions from group
        membership × attached managed policies.  Caller holds the
        lock (or is single-threaded startup).  Translation uses the
        same policy→coarse-action mapping the IAM API applies to
        inline user policies, so a grant means the same thing
        whichever path attached it."""
        derived: dict[str, set] = {}
        groups = self._groups
        if groups:
            try:
                from .policy_actions import IamError, policy_to_actions
            except Exception as e:  # noqa: BLE001 — fail closed
                # no translation, no grant: every identity's derived
                # group actions are cleared below, never left stale
                # (a deleted group or policy must not keep granting)
                wlog.warning("iam group grants dropped: policy "
                             "translation unavailable: %s", e,
                             component="iam")
                groups = {}
            for gname, g in groups.items():
                # FAIL CLOSED per group: a malformed entry (non-dict
                # group, non-list members/policyNames, unhashable
                # member...) drops THAT group's grant and logs —
                # raising here would abort mid-recompute and leave a
                # half-updated grant map where some identities carry
                # stale group actions and others none
                try:
                    if g.get("disabled"):
                        continue
                    acts: set = set()
                    for pname in g.get("policyNames", []):
                        doc = self._policies.get(pname)
                        if doc:
                            try:
                                acts.update(policy_to_actions(doc))
                            except (IamError, AttributeError, KeyError,
                                    TypeError, ValueError):
                                continue   # malformed doc grants nothing
                    if not acts:
                        continue
                    for member in g.get("members", []):
                        derived.setdefault(str(member),
                                           set()).update(acts)
                except (AttributeError, KeyError, TypeError,
                        ValueError) as e:
                    wlog.warning(
                        "iam group %r malformed; its grant is "
                        "dropped: %s", gname, e, component="iam")
                    continue
        for ident in self._identities.values():
            ident.group_actions = sorted(derived.get(ident.name, ()))

    def put_group(self, name: str, group: dict) -> None:
        with self._lock:
            self._groups[name] = group
            self._recompute_group_grants()
            self.save()

    def get_group(self, name: str) -> "dict | None":
        self._maybe_reload()
        return self._groups.get(name)

    def list_groups(self) -> "dict[str, dict]":
        self._maybe_reload()
        with self._lock:
            return dict(self._groups)

    def delete_group(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)
            self._recompute_group_grants()
            self.save()

    # -- service accounts (iam.proto ServiceAccount) -----------------------

    def put_service_account(self, sa: dict) -> None:
        with self._lock:
            old = self._service_accounts.get(sa["id"])
            if old is not None and old.get("credential"):
                self._sa_by_key.pop(
                    old["credential"]["accessKey"], None)
            self._service_accounts[sa["id"]] = sa
            if sa.get("credential"):
                self._sa_by_key[sa["credential"]["accessKey"]] = sa
            self.save()

    def get_service_account(self, sa_id: str) -> "dict | None":
        self._maybe_reload()
        return self._service_accounts.get(sa_id)

    def list_service_accounts(self, parent: str = "") -> list[dict]:
        self._maybe_reload()
        with self._lock:
            return [sa for sa in self._service_accounts.values()
                    if not parent or sa.get("parentUser") == parent]

    def delete_service_account(self, sa_id: str) -> None:
        with self._lock:
            old = self._service_accounts.pop(sa_id, None)
            if old is not None:
                if old.get("credential"):
                    self._sa_by_key.pop(
                        old["credential"]["accessKey"], None)
                self.save()

    # -- SigV4Verifier adapter --------------------------------------------

    class _SecretsView:
        def __init__(self, store: "IdentityStore"):
            self.store = store

        def get(self, access_key: str) -> str | None:
            return self.store.secret_for(access_key)

    def secrets_view(self):
        """Mapping-shaped live view for SigV4Verifier (which only
        calls .get) — mutations through the store are visible to the
        verifier immediately, unlike a copied dict."""
        return IdentityStore._SecretsView(self)
