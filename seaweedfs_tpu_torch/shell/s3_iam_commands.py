"""S3 identity/credential admin shell commands, the port's copy of
`seaweedfs_tpu/shell/s3_iam_commands.py` (weed/shell/command_s3_user*.go,
command_s3_accesskey*.go, command_s3_group*.go, command_s3_policy*.go,
command_s3_anonymous*.go, command_s3_configure.go,
command_s3_clean_uploads.go).

All of them operate on the shared IdentityStore JSON config
(iam/identity.py) — the same file the S3 gateway and IAM API watch by
mtime, so shell changes propagate live, the way the reference
propagates credential config through the filer
(credential/propagating_store.go)."""

from __future__ import annotations

import json
import secrets
import time
import urllib.parse

from ..iam.identity import Credential, Identity, IdentityStore
from ..server.httpd import http_bytes, http_json
from .commands import CommandEnv, _must, _parse_flags, command


def _store(env: CommandEnv, opts: dict) -> IdentityStore:
    path = opts.get("config") or getattr(env, "iam_config", "")
    if not path:
        raise RuntimeError(
            "no identities config; pass -config=/path/to/s3.json "
            "(the file the s3/iam gateways were started with)")
    env.iam_config = path
    return IdentityStore(path)


def _fmt_identity(i: Identity, verbose: bool = False) -> str:
    keys = ", ".join(c.access_key + ("" if c.status == "Active"
                                     else " (inactive)")
                     for c in i.credentials) or "-"
    line = (f"{i.name:24s} actions={len(i.actions)} keys=[{keys}]"
            + (" DISABLED" if getattr(i, 'disabled', False) else ""))
    if verbose:
        line += "\n  actions: " + (", ".join(i.actions) or "-")
    return line


# -- users ----------------------------------------------------------------

@command("s3.user.create")
def cmd_s3_user_create(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_create.go (-user=NAME [-actions=a,b]
    [-config=...]): creates the identity with a fresh access key."""
    opts = _parse_flags(args)
    name = opts.get("user", "")
    if not name:
        return "usage: s3.user.create -user=NAME [-actions=Read:bucket]"
    store = _store(env, opts)
    if store.get(name) is not None:
        raise RuntimeError(f"user {name!r} already exists")
    actions = [a for a in opts.get("actions", "").split(",") if a]
    cred = Credential(access_key=secrets.token_hex(8).upper(),
                      secret_key=secrets.token_urlsafe(24))
    store.put(Identity(name, actions=actions, credentials=[cred]))
    return (f"created {name}\naccessKey: {cred.access_key}\n"
            f"secretKey: {cred.secret_key}")


@command("s3.user.delete")
def cmd_s3_user_delete(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_delete.go (-user=NAME)."""
    opts = _parse_flags(args)
    name = opts.get("user", "")
    store = _store(env, opts)
    if store.get(name) is None:
        raise RuntimeError(f"no such user {name!r}")
    store.delete(name)
    return f"deleted {name}"


@command("s3.user.list")
def cmd_s3_user_list(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_list.go."""
    store = _store(env, _parse_flags(args))
    out = [_fmt_identity(i) for i in sorted(store, key=lambda i: i.name)]
    return "\n".join(out) or "(no identities)"


@command("s3.user.show")
def cmd_s3_user_show(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_show.go (-user=NAME)."""
    opts = _parse_flags(args)
    i = _store(env, opts).get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    return _fmt_identity(i, verbose=True)


def _set_disabled(env, args, disabled: bool) -> str:
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    i.disabled = disabled
    store.put(i)
    return f"{'disabled' if disabled else 'enabled'} {i.name}"


@command("s3.user.disable")
def cmd_s3_user_disable(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_disable.go: auth refuses a disabled identity's
    keys without deleting its config."""
    return _set_disabled(env, args, True)


@command("s3.user.enable")
def cmd_s3_user_enable(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_enable.go."""
    return _set_disabled(env, args, False)


# -- access keys ----------------------------------------------------------

@command("s3.accesskey.create")
def cmd_s3_accesskey_create(env: CommandEnv, args: list[str]) -> str:
    """command_s3_accesskey_create.go (-user=NAME): mints an extra key
    pair for key rotation."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    cred = Credential(access_key=secrets.token_hex(8).upper(),
                      secret_key=secrets.token_urlsafe(24))
    i.credentials.append(cred)
    store.put(i)
    return f"accessKey: {cred.access_key}\nsecretKey: {cred.secret_key}"


@command("s3.accesskey.delete")
def cmd_s3_accesskey_delete(env: CommandEnv, args: list[str]) -> str:
    """command_s3_accesskey_delete.go (-user=NAME -accessKey=K)."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    key = opts.get("accessKey", "")
    before = len(i.credentials)
    i.credentials = [c for c in i.credentials if c.access_key != key]
    if len(i.credentials) == before:
        raise RuntimeError(f"user {i.name} has no key {key!r}")
    store.put(i)
    return f"deleted key {key} of {i.name}"


@command("s3.accesskey.list")
def cmd_s3_accesskey_list(env: CommandEnv, args: list[str]) -> str:
    """command_s3_accesskey_list.go: every key -> identity mapping."""
    store = _store(env, _parse_flags(args))
    lines = []
    for i in sorted(store, key=lambda i: i.name):
        for c in i.credentials:
            lines.append(f"{c.access_key:20s} {i.name:20s} {c.status}")
    return "\n".join(lines) or "(no access keys)"


# -- action grants (the reference's policy attach surface) ---------------

@command("s3.policy.attach")
def cmd_s3_policy_attach(env: CommandEnv, args: list[str]) -> str:
    """command_s3_policy.go attach (-user=NAME -actions=a,b): grants
    identity actions (Read/Write/List/Tagging/Admin[:bucket])."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    new = [a for a in opts.get("actions", "").split(",") if a]
    if not new:
        return "usage: s3.policy.attach -user=NAME -actions=Read:bucket"
    i.actions = sorted(set(i.actions) | set(new))
    # operator grants are static: IAM policy recomputation must not
    # strip them (identity.py static_actions contract)
    i.static_actions = sorted(set(i.static_actions) | set(new))
    store.put(i)
    return f"{i.name} actions: {', '.join(i.actions)}"


@command("s3.policy.detach")
def cmd_s3_policy_detach(env: CommandEnv, args: list[str]) -> str:
    """command_s3_policy.go detach."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    drop = set(a for a in opts.get("actions", "").split(",") if a)
    i.actions = [a for a in i.actions if a not in drop]
    i.static_actions = [a for a in i.static_actions if a not in drop]
    store.put(i)
    return f"{i.name} actions: {', '.join(i.actions) or '-'}"


# -- anonymous access -----------------------------------------------------

@command("s3.anonymous.get")
def cmd_s3_anonymous_get(env: CommandEnv, args: list[str]) -> str:
    """command_s3_anonymous.go: show what unauthenticated requests may
    do (the identity literally named "anonymous")."""
    store = _store(env, _parse_flags(args))
    anon = store.get("anonymous")
    if anon is None:
        return "anonymous access: none"
    return "anonymous actions: " + (", ".join(anon.actions) or "-")


@command("s3.anonymous.set")
def cmd_s3_anonymous_set(env: CommandEnv, args: list[str]) -> str:
    """Grant/replace anonymous actions (-actions=Read:public,...);
    empty -actions removes anonymous access."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    actions = [a for a in opts.get("actions", "").split(",") if a]
    if not actions:
        store.delete("anonymous")
        return "anonymous access removed"
    store.put(Identity("anonymous", actions=actions))
    return "anonymous actions: " + ", ".join(actions)


@command("s3.anonymous.list")
def cmd_s3_anonymous_list(env: CommandEnv, args: list[str]) -> str:
    """Buckets anonymously readable under the current grants."""
    store = _store(env, _parse_flags(args))
    anon = store.get("anonymous")
    if anon is None:
        return "(no anonymous access)"
    buckets = sorted({a.split(":", 1)[1] for a in anon.actions
                      if ":" in a} |
                     ({"*"} if any(":" not in a for a in anon.actions)
                      else set()))
    return "\n".join(buckets) or "(no anonymous access)"


# -- config ---------------------------------------------------------------

@command("s3.config.show")
def cmd_s3_config_show(env: CommandEnv, args: list[str]) -> str:
    """command_s3_configure.go read side: dump the identities JSON."""
    store = _store(env, _parse_flags(args))
    return json.dumps(store.to_json(), indent=1)


@command("s3.configure")
def cmd_s3_configure(env: CommandEnv, args: list[str]) -> str:
    """command_s3_configure.go: point the shell at an identities
    config (-config=...) and optionally apply a raw identity JSON
    (-applyJson='{"name": ...}')."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    raw = opts.get("applyJson", "")
    if raw:
        d = json.loads(raw)
        store.put(Identity.from_json(d))
        return f"applied identity {d.get('name')}"
    return f"using identities config {store.path} " \
           f"({sum(1 for _ in store)} identities)"


# -- multipart hygiene ----------------------------------------------------

@command("s3.clean.uploads")
def cmd_s3_clean_uploads(env: CommandEnv, args: list[str]) -> str:
    """command_s3_clean_uploads.go (-timeAgo=24h): purge aged
    multipart-upload scratch dirs under the filer's /.uploads."""
    opts = _parse_flags(args)
    spec = opts.get("timeAgo", "24h")
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}
    try:
        age = float(spec[:-1]) * mult[spec[-1]] \
            if spec[-1] in mult else float(spec)
    except ValueError:
        raise RuntimeError(f"bad -timeAgo {spec!r} (Ns/Nm/Nh/Nd)")
    filer = env.require_filer()
    # multipart scratch lives PER BUCKET: /buckets/<b>/.uploads/<id>
    # (s3_server.py UPLOADS_DIR under _bucket_path)
    st, body, _ = http_bytes("GET", f"{filer}/buckets/?limit=1000")
    if st == 404:
        return "purged 0 multipart uploads"
    buckets = [e["fullPath"].rsplit("/", 1)[-1]
               for e in json.loads(body).get("entries", [])
               if e.get("isDirectory")]
    # entry mtimes are cross-process wall timestamps written by the
    # filer — the wall clock is the only shared clock
    cutoff = time.time() - age  # noqa: SWFS011
    purged = 0
    for bucket in buckets:
        st, body, _ = http_bytes(
            "GET", f"{filer}/buckets/"
                   f"{urllib.parse.quote(bucket)}/.uploads/"
                   f"?limit=1000")
        if st != 200:
            continue
        for e in json.loads(body).get("entries", []):
            mtime = e.get("attributes", {}).get("mtime", 0)
            if mtime and mtime < cutoff:
                _must(http_json(
                    "DELETE",
                    f"{filer}{urllib.parse.quote(e['fullPath'])}"
                    f"?recursive=true"), f"purge {e['fullPath']}")
                purged += 1
    return f"purged {purged} multipart uploads older than {spec}"


# -- bucket administration (command_s3_bucket_*.go) -----------------------

def _bucket_entry(env: CommandEnv, bucket: str) -> dict:
    filer = env.require_filer()
    st, body, _ = http_bytes(
        "GET", f"{filer}/__meta__/lookup?path=" +
        urllib.parse.quote(f"/buckets/{bucket}"))
    if st != 200:
        raise RuntimeError(f"no bucket {bucket!r} ({st})")
    return json.loads(body)


def _patch_bucket(env: CommandEnv, bucket: str, extended: dict) -> None:
    filer = env.require_filer()
    _bucket_entry(env, bucket)  # existence check
    _must(http_json("POST", f"{filer}/__meta__/patch_extended",
                    {"path": f"/buckets/{bucket}",
                     "extended": extended}),
          f"update bucket {bucket}")


@command("s3.bucket.versioning")
def cmd_s3_bucket_versioning(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_versioning.go (-bucket=B
    [-status=Enabled|Suspended]): read or set the bucket versioning
    state the gateway enforces (stored on the bucket entry, the same
    place PutBucketVersioning writes)."""
    opts = _parse_flags(args)
    bucket = opts.get("bucket", "")
    if not bucket:
        return "usage: s3.bucket.versioning -bucket=B [-status=Enabled]"
    status = opts.get("status", "")
    if status:
        if status not in ("Enabled", "Suspended"):
            raise RuntimeError("status must be Enabled or Suspended")
        _patch_bucket(env, bucket, {"versioning": status})
        return f"{bucket}: versioning {status}"
    e = _bucket_entry(env, bucket)
    return f"{bucket}: versioning " \
           f"{e.get('extended', {}).get('versioning') or 'unset'}"


@command("s3.bucket.owner")
def cmd_s3_bucket_owner(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_owner.go analog (-bucket=B [-owner=ID]):
    read/set the owning account id recorded on the bucket entry (the
    gateway's ACL owner checks read it)."""
    opts = _parse_flags(args)
    bucket = opts.get("bucket", "")
    if not bucket:
        return "usage: s3.bucket.owner -bucket=B [-owner=accountId]"
    owner = opts.get("owner", "")
    if owner:
        _patch_bucket(env, bucket, {"x-amz-owner-id": owner})
        return f"{bucket}: owner {owner}"
    e = _bucket_entry(env, bucket)
    return f"{bucket}: owner " \
           f"{e.get('extended', {}).get('x-amz-owner-id') or 'unset'}"


@command("s3.user.provision")
def cmd_s3_user_provision(env: CommandEnv, args: list[str]) -> str:
    """command_s3_user_provision.go shape: one-shot onboarding —
    create the user (if absent), a bucket named for it (if absent),
    and grant the user full access to that bucket."""
    opts = _parse_flags(args)
    name = opts.get("user", "")
    if not name:
        return "usage: s3.user.provision -user=NAME [-bucket=B]"
    bucket = opts.get("bucket", name)
    store = _store(env, opts)
    created_user = False
    i = store.get(name)
    key_note = ""
    if i is None:
        cred = Credential(access_key=secrets.token_hex(8).upper(),
                          secret_key=secrets.token_urlsafe(24))
        i = Identity(name, credentials=[cred])
        created_user = True
        key_note = (f"\naccessKey: {cred.access_key}"
                    f"\nsecretKey: {cred.secret_key}")
    grants = {f"Read:{bucket}", f"Write:{bucket}", f"List:{bucket}",
              f"Tagging:{bucket}"}
    i.actions = sorted(set(i.actions) | grants)
    i.static_actions = sorted(set(i.static_actions) | grants)
    store.put(i)
    filer = env.require_filer()
    st, _, _ = http_bytes(
        "HEAD", f"{filer}/buckets/{urllib.parse.quote(bucket)}")
    created_bucket = False
    if st != 200:
        _must(http_json("POST", f"{filer}/__meta__/create",
                        {"path": f"/buckets/{bucket}",
                         "isDirectory": True}),
              f"create bucket {bucket}")
        created_bucket = True
    return (f"{'created' if created_user else 'updated'} user {name}; "
            f"{'created' if created_bucket else 'kept'} bucket "
            f"{bucket}; granted {', '.join(sorted(grants))}"
            + key_note)


# -- groups (command_s3_group_*.go; iam.proto Group) ----------------------

@command("s3.group.create")
def cmd_s3_group_create(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_create.go (-name=G [-policies=p1,p2]): a new
    (normally empty) group; members inherit the coarse translation of
    every attached managed policy (identity.py group_actions)."""
    opts = _parse_flags(args)
    name = opts.get("name", "")
    if not name:
        return "usage: s3.group.create -name=GROUP [-policies=p1,p2]"
    store = _store(env, opts)
    if store.get_group(name) is not None:
        raise RuntimeError(f"group {name!r} already exists")
    policies = [p for p in opts.get("policies", "").split(",") if p]
    for p in policies:
        if store.get_policy(p) is None:
            raise RuntimeError(f"no managed policy {p!r} "
                               "(create it with s3.policy first)")
    store.put_group(name, {"name": name, "members": [],
                           "policyNames": policies,
                           "disabled": False})
    return f"created group {name}"


@command("s3.group.delete")
def cmd_s3_group_delete(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_delete.go: removing a group revokes its
    policy grants from every member at once."""
    opts = _parse_flags(args)
    name = opts.get("name", "")
    store = _store(env, opts)
    if store.get_group(name) is None:
        raise RuntimeError(f"no such group {name!r}")
    store.delete_group(name)
    return f"deleted group {name}"


@command("s3.group.list")
def cmd_s3_group_list(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_list.go."""
    store = _store(env, _parse_flags(args))
    lines = []
    for name, g in sorted(store.list_groups().items()):
        lines.append(f"{name:24s} members={len(g.get('members', []))} "
                     f"policies=[{','.join(g.get('policyNames', []))}]"
                     + (" DISABLED" if g.get("disabled") else ""))
    return "\n".join(lines) or "(no groups)"


@command("s3.group.show")
def cmd_s3_group_show(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_show.go: full group document."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    g = store.get_group(opts.get("name", ""))
    if g is None:
        raise RuntimeError(f"no such group {opts.get('name')!r}")
    return json.dumps(g, indent=1)


@command("s3.group.add.user")
def cmd_s3_group_add_user(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_add_user.go (-name=G -user=U): membership
    takes effect on the user's next request (grants are recomputed
    inside put_group)."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    g = store.get_group(opts.get("name", ""))
    if g is None:
        raise RuntimeError(f"no such group {opts.get('name')!r}")
    user = opts.get("user", "")
    if store.get(user) is None:
        raise RuntimeError(f"no such user {user!r}")
    if user in g.get("members", []):
        return f"{user} already in {g['name']}"
    g.setdefault("members", []).append(user)
    store.put_group(g["name"], g)
    return f"added {user} to {g['name']}"


@command("s3.group.remove.user")
def cmd_s3_group_remove_user(env: CommandEnv, args: list[str]) -> str:
    """command_s3_group_remove_user.go."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    g = store.get_group(opts.get("name", ""))
    if g is None:
        raise RuntimeError(f"no such group {opts.get('name')!r}")
    user = opts.get("user", "")
    if user not in g.get("members", []):
        raise RuntimeError(f"{user!r} not in {g['name']}")
    g["members"] = [m for m in g["members"] if m != user]
    store.put_group(g["name"], g)
    return f"removed {user} from {g['name']}"


# -- managed policies (command_s3_policy.go; iam.proto Policy) ------------

@command("s3.policy")
def cmd_s3_policy(env: CommandEnv, args: list[str]) -> str:
    """command_s3_policy.go: manage MANAGED policy documents
    (-list | -name=P [-content=JSON | -file=path | -delete]).
    Attach them to groups (s3.group.create -policies=...); per-user
    coarse grants stay on s3.policy.attach/detach."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    if "list" in opts:
        pols = store.list_policies()
        return "\n".join(sorted(pols)) or "(no managed policies)"
    name = opts.get("name", "")
    if not name:
        return ("usage: s3.policy -list | "
                "-name=P [-content=JSON|-file=F|-delete]")
    if "delete" in opts:
        if store.get_policy(name) is None:
            raise RuntimeError(f"no such policy {name!r}")
        store.delete_policy(name)
        return f"deleted policy {name}"
    content = opts.get("content", "")
    if opts.get("file"):
        with open(opts["file"]) as f:
            content = f.read()
    if content:
        from ..iam.policy_actions import policy_to_actions
        policy_to_actions(content)       # validate before storing
        store.put_policy(name, content)
        return f"stored policy {name}"
    doc = store.get_policy(name)
    if doc is None:
        raise RuntimeError(f"no such policy {name!r}")
    return doc


# -- service accounts (command_s3_serviceaccount_*.go) --------------------

@command("s3.serviceaccount.create")
def cmd_s3_sa_create(env: CommandEnv, args: list[str]) -> str:
    """command_s3_serviceaccount_create.go (-user=PARENT
    [-description=..] [-actions=a,b] [-expiry=24h]): application
    credentials parented to a user.  -actions must be a subset the
    parent could itself perform; empty inherits the parent's grants
    (including future changes)."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    parent = store.get(opts.get("user", ""))
    if parent is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    actions = [a for a in opts.get("actions", "").split(",") if a]
    for a in actions:
        act, _, scope = a.partition(":")
        bucket, _, key = scope.partition("/")
        if not parent.can_do(act, bucket, key):
            raise RuntimeError(
                f"parent {parent.name} cannot {a!r}; a service "
                "account cannot exceed its parent")
    expiration = 0
    spec = opts.get("expiry", "")
    if spec:
        mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}
        try:
            secs = float(spec[:-1]) * mult[spec[-1]] \
                if spec[-1] in mult else float(spec)
        except ValueError:
            raise RuntimeError(f"bad -expiry {spec!r} (Ns/Nm/Nh/Nd)")
        expiration = int(time.time() + secs)
    sa_id = "sa-" + secrets.token_hex(6)
    cred = Credential(access_key=secrets.token_hex(8).upper(),
                      secret_key=secrets.token_urlsafe(24))
    store.put_service_account({
        "id": sa_id, "parentUser": parent.name,
        "description": opts.get("description", ""),
        "credential": cred.to_json(), "actions": actions,
        "expiration": expiration, "disabled": False,
        "createdAt": int(time.time()), "createdBy": "shell"})
    return (f"id: {sa_id}\naccessKey: {cred.access_key}\n"
            f"secretKey: {cred.secret_key}")


@command("s3.serviceaccount.delete")
def cmd_s3_sa_delete(env: CommandEnv, args: list[str]) -> str:
    """command_s3_serviceaccount_delete.go (-id=sa-xxx)."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    sa_id = opts.get("id", "")
    if store.get_service_account(sa_id) is None:
        raise RuntimeError(f"no such service account {sa_id!r}")
    store.delete_service_account(sa_id)
    return f"deleted service account {sa_id}"


@command("s3.serviceaccount.list")
def cmd_s3_sa_list(env: CommandEnv, args: list[str]) -> str:
    """command_s3_serviceaccount_list.go ([-user=PARENT])."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    lines = []
    for sa in sorted(store.list_service_accounts(opts.get("user", "")),
                     key=lambda s: s["id"]):
        exp = sa.get("expiration", 0)
        state = ("DISABLED" if sa.get("disabled") else
                 "EXPIRED" if exp and exp < time.time() else "active")
        lines.append(
            f"{sa['id']:20s} parent={sa.get('parentUser', ''):16s} "
            f"key={sa.get('credential', {}).get('accessKey', '-')} "
            f"{state}")
    return "\n".join(lines) or "(no service accounts)"


@command("s3.serviceaccount.show")
def cmd_s3_sa_show(env: CommandEnv, args: list[str]) -> str:
    """command_s3_serviceaccount_show.go (-id=sa-xxx): full document
    minus the secret key."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    sa = store.get_service_account(opts.get("id", ""))
    if sa is None:
        raise RuntimeError(f"no such service account {opts.get('id')!r}")
    redacted = dict(sa)
    if redacted.get("credential"):
        redacted["credential"] = {
            **redacted["credential"], "secretKey": "<redacted>"}
    return json.dumps(redacted, indent=1)


# -- key rotation + config portability ------------------------------------

@command("s3.accesskey.rotate")
def cmd_s3_accesskey_rotate(env: CommandEnv, args: list[str]) -> str:
    """command_s3_accesskey_rotate.go (-user=U -accessKey=OLD):
    mint-new-then-delete-old in one step; the brief both-valid window
    the reference documents does not exist here because the swap is
    a single store.put."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    i = store.get(opts.get("user", ""))
    if i is None:
        raise RuntimeError(f"no such user {opts.get('user')!r}")
    old = opts.get("accessKey", "")
    if old and all(c.access_key != old for c in i.credentials):
        raise RuntimeError(f"user {i.name} has no key {old!r}")
    if not old:
        if len(i.credentials) != 1:
            raise RuntimeError(
                f"user {i.name} has {len(i.credentials)} keys; "
                "pass -accessKey=OLD to pick one")
        old = i.credentials[0].access_key
    cred = Credential(access_key=secrets.token_hex(8).upper(),
                      secret_key=secrets.token_urlsafe(24))
    i.credentials = [c for c in i.credentials
                     if c.access_key != old] + [cred]
    store.put(i)
    return (f"rotated {old} -> {cred.access_key}\n"
            f"secretKey: {cred.secret_key}")


@command("s3.iam.export")
def cmd_s3_iam_export(env: CommandEnv, args: list[str]) -> str:
    """command_s3_iam_export.go (-file=out.json): portable dump of
    the whole identity/policy/group/service-account config."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    doc = json.dumps(store.to_json(), indent=1)
    out = opts.get("file", "")
    if out:
        with open(out, "w") as f:
            f.write(doc)
        return f"exported {out}"
    return doc


@command("s3.iam.import")
def cmd_s3_iam_import(env: CommandEnv, args: list[str]) -> str:
    """command_s3_iam_import.go (-file=in.json [-merge]): load a
    previously exported config.  Default REPLACES the store; -merge
    keeps existing entries not present in the file."""
    opts = _parse_flags(args)
    store = _store(env, opts)
    src = opts.get("file", "")
    if not src:
        return "usage: s3.iam.import -file=dump.json [-merge]"
    with open(src) as f:
        doc = json.load(f)
    if "merge" in opts:
        merged = store.to_json()
        have = {i["name"] for i in merged["identities"]}
        merged["identities"].extend(
            i for i in doc.get("identities", [])
            if i["name"] not in have)
        for k in ("policies", "groups"):
            merged[k] = {**doc.get(k, {}), **merged.get(k, {})}
        have_sa = {s["id"] for s in merged.get("serviceAccounts", [])}
        merged.setdefault("serviceAccounts", []).extend(
            s for s in doc.get("serviceAccounts", [])
            if s["id"] not in have_sa)
        doc = merged
    store.load_json(doc)
    store.save()
    n = len(doc.get("identities", []))
    return f"imported {n} identities from {src}"


# -- per-bucket access + object lock (command_s3_bucket_*.go) -------------

@command("s3.bucket.access")
def cmd_s3_bucket_access(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_access.go (-name=B -user=U
    [-access=Read,List|none]): view or replace a user's
    bucket-scoped grants; the user is auto-created, and "none"
    strips every grant scoped to the bucket."""
    opts = _parse_flags(args)
    bucket = opts.get("name", "")
    user = opts.get("user", "")
    if not bucket or not user:
        return ("usage: s3.bucket.access -name=B -user=U "
                "[-access=Read,List|none]")
    store = _store(env, opts)
    i = store.get(user)
    spec = opts.get("access", "")

    def _on_bucket(a: str) -> bool:
        # both whole-bucket ("Read:b") and path-scoped
        # ("Read:b/prefix") grants target this bucket — -access=none
        # must strip BOTH or revocation silently leaves path access
        _, _, scope = a.partition(":")
        return scope == bucket or scope.startswith(bucket + "/")

    if not spec:
        if i is None:
            return f"{user}: no access to {bucket}"
        scoped = [a for a in i.granted_actions()
                  if ":" in a and _on_bucket(a)]
        return f"{user} on {bucket}: " + (", ".join(scoped) or "none")
    if i is None:
        i = Identity(user, credentials=[Credential(
            access_key=secrets.token_hex(8).upper(),
            secret_key=secrets.token_urlsafe(24))])
    keep = [a for a in i.actions if ":" not in a or not _on_bucket(a)]
    keep_static = [a for a in i.static_actions
                   if ":" not in a or not _on_bucket(a)]
    if spec.lower() != "none":
        allowed = {"Read", "Write", "List", "Tagging", "Admin"}
        new = []
        for a in spec.split(","):
            if a and a not in allowed:
                raise RuntimeError(f"unknown action {a!r} "
                                   f"(use {'/'.join(sorted(allowed))})")
            if a:
                new.append(f"{a}:{bucket}")
        keep = sorted(set(keep) | set(new))
        keep_static = sorted(set(keep_static) | set(new))
    i.actions, i.static_actions = keep, keep_static
    store.put(i)
    i = store.get(user)          # re-read: group grants recomputed
    scoped = [a for a in i.actions if ":" in a and _on_bucket(a)]
    out = f"{user} on {bucket}: " + (", ".join(scoped) or "none")
    inherited = [a for a in i.group_actions
                 if ":" in a and _on_bucket(a)]
    if inherited:
        # stripping per-user actions cannot revoke group-inherited
        # grants — saying "none" while access survives would mislead
        # the operator into believing access was revoked
        out += (f"\nWARNING: still inherited via groups: "
                f"{', '.join(inherited)} (edit the group or its "
                "policies to revoke)")
    return out


@command("s3.bucket.lock")
def cmd_s3_bucket_lock(env: CommandEnv, args: list[str]) -> str:
    """command_s3_bucket_lock.go (-name=B [-enable]): view or enable
    WORM Object Lock.  Enabling turns versioning on (a lock
    prerequisite) and is irreversible, matching AWS semantics."""
    opts = _parse_flags(args)
    bucket = opts.get("name", "")
    if not bucket:
        return "usage: s3.bucket.lock -name=B [-enable]"
    e = _bucket_entry(env, bucket)
    state = e.get("extended", {}).get("objectLock") or "Disabled"
    if "enable" not in opts:
        return f"{bucket}: object lock {state}"
    if state == "Enabled":
        return f"{bucket}: object lock already Enabled"
    _patch_bucket(env, bucket, {"versioning": "Enabled",
                                "objectLock": "Enabled"})
    return f"{bucket}: object lock Enabled (versioning Enabled)"
