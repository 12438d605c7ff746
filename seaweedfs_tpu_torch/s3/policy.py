"""Bucket policy engine (weed/s3api/policy_engine/): the IAM-style
JSON policy document evaluated per request.

Supported subset (the core of the reference's engine):

    {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow" | "Deny",
        "Principal": "*" | {"AWS": "*" | [access-key, ...]},
        "Action": "s3:GetObject" | ["s3:*", "s3:Get*"],
        "Resource": "arn:aws:s3:::bucket/key-or-*" | [...],
        "Condition": {"<Operator>": {"<context-key>": value|[...]}}
    }]}

Conditions evaluate against the per-request context the gateway
builds (aws:SourceIp, aws:SecureTransport, aws:username,
aws:CurrentTime, aws:UserAgent, aws:Referer, s3:prefix, ...), with
the reference's operator set (policy_engine/conditions.go:643
GetConditionEvaluator): String*, Numeric*, Date*, Bool,
IpAddress/NotIpAddress, Null, plus the ...IfExists suffix.

Evaluation order is AWS's: explicit Deny wins over Allow; otherwise a
matching Allow grants (this is how anonymous/public access is opened);
no match falls back to the gateway's signature-based default.

The port's copy of `seaweedfs_tpu/s3/policy.py`.
"""

from __future__ import annotations

import fnmatch
import ipaddress
import json
from datetime import datetime, timezone


class PolicyError(ValueError):
    pass


# -- Condition operators (conditions.go) -----------------------------------

def _parse_date(s: str) -> float:
    s = str(s)
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S%z",
                "%Y-%m-%d"):
        try:
            dt = datetime.strptime(s, fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            return dt.timestamp()
        except ValueError:
            continue
    raise PolicyError(f"undecodable date {s!r}")


def _op_string(op, wanted, got):
    if op == "StringEquals":
        return got in wanted
    if op == "StringNotEquals":
        return got not in wanted
    if op == "StringLike":
        return any(fnmatch.fnmatchcase(got, w) for w in wanted)
    if op == "StringNotLike":
        return not any(fnmatch.fnmatchcase(got, w) for w in wanted)
    return None


def _cmp(op_suffix, g, w) -> bool:
    return {"Equals": g == w, "NotEquals": g != w,
            "LessThan": g < w, "LessThanEquals": g <= w,
            "GreaterThan": g > w,
            "GreaterThanEquals": g >= w}[op_suffix]


def _op_numeric(op, wanted, got):
    """Values within one key are OR'd (AWS multi-value semantics)."""
    try:
        g = float(got)
        ws = [float(w) for w in wanted]
    except ValueError:
        return False
    return any(_cmp(op.removeprefix("Numeric"), g, w) for w in ws)


def _op_date(op, wanted, got):
    try:
        g = _parse_date(got)
        ws = [_parse_date(w) for w in wanted]
    except PolicyError:
        return False
    return any(_cmp(op.removeprefix("Date"), g, w) for w in ws)


def _op_ip(op, wanted, got):
    try:
        addr = ipaddress.ip_address(got)
        nets = [ipaddress.ip_network(w, strict=False) for w in wanted]
    except ValueError:
        return False
    inside = any(addr in n for n in nets)
    return inside if op == "IpAddress" else not inside


_KNOWN_OPERATORS = {
    "StringEquals", "StringNotEquals", "StringLike", "StringNotLike",
    "NumericEquals", "NumericNotEquals", "NumericLessThan",
    "NumericLessThanEquals", "NumericGreaterThan",
    "NumericGreaterThanEquals", "DateEquals", "DateNotEquals",
    "DateLessThan", "DateLessThanEquals", "DateGreaterThan",
    "DateGreaterThanEquals", "Bool", "IpAddress", "NotIpAddress",
    "Null",
}


def _condition_matches(conditions: dict, context: dict) -> bool:
    """ALL operator blocks and ALL keys within must pass (AWS AND
    semantics; values within one key are OR'd)."""
    for op_raw, block in conditions.items():
        if_exists = op_raw.endswith("IfExists")
        op = op_raw.removesuffix("IfExists")
        for key, wanted in block.items():
            wanted = [str(w) for w in (
                wanted if isinstance(wanted, list) else [wanted])]
            if not wanted:
                return False     # defensive: parse rejects this
            got = context.get(key)
            if op == "Null":
                want_null = wanted[0].lower() == "true"
                if (got is None) != want_null:
                    return False
                continue
            if got is None:
                if if_exists:
                    continue        # absent key passes with IfExists
                # negative operators pass vacuously on absent keys
                # (AWS semantics: NotEquals/NotLike/NotIpAddress
                # match when the key is missing)
                if op in ("StringNotEquals", "StringNotLike",
                          "NotIpAddress", "NumericNotEquals",
                          "DateNotEquals"):
                    continue
                return False
            got = str(got)
            if op.startswith("String"):
                ok = _op_string(op, wanted, got)
            elif op.startswith("Numeric"):
                ok = _op_numeric(op, wanted, got)
            elif op.startswith("Date"):
                ok = _op_date(op, wanted, got)
            elif op == "Bool":
                ok = got.lower() in (w.lower() for w in wanted)
            elif op in ("IpAddress", "NotIpAddress"):
                ok = _op_ip(op, wanted, got)
            else:
                ok = None
            if not ok:
                return False
    return True


def parse_policy(doc: bytes) -> "list[dict]":
    try:
        p = json.loads(doc)
    except ValueError as e:
        raise PolicyError(f"malformed policy JSON: {e}")
    stmts = p.get("Statement")
    if not isinstance(stmts, list) or not stmts:
        raise PolicyError("policy needs a Statement list")
    out = []
    for s in stmts:
        effect = s.get("Effect")
        if effect not in ("Allow", "Deny"):
            raise PolicyError(f"bad Effect {effect!r}")
        conditions = s.get("Condition", {})
        if not isinstance(conditions, dict):
            raise PolicyError("Condition must be an object")
        for op in conditions:
            if op.removesuffix("IfExists") not in _KNOWN_OPERATORS:
                # an engine that cannot EVALUATE an operator must not
                # silently grant unconditionally — that widens access
                # beyond what the document states
                raise PolicyError(
                    f"unsupported condition operator {op!r}")
            if not isinstance(conditions[op], dict):
                raise PolicyError(f"Condition {op} must map keys")
            for ck, cv in conditions[op].items():
                if isinstance(cv, list) and not cv:
                    # an empty value list would crash evaluation
                    raise PolicyError(
                        f"Condition {op}/{ck} needs at least one "
                        f"value")
        principal = s.get("Principal", "*")
        if isinstance(principal, dict):
            unsupported = set(principal) - {"AWS"}
            if unsupported:
                # collapsing e.g. {"Federated": ...} to "*" would turn
                # an unsupported principal type into a wildcard grant
                raise PolicyError(
                    f"unsupported Principal types: "
                    f"{sorted(unsupported)}")
            principal = principal.get("AWS", "*")
        principals = principal if isinstance(principal, list) \
            else [principal]
        actions = s.get("Action", [])
        actions = actions if isinstance(actions, list) else [actions]
        resources = s.get("Resource", [])
        resources = resources if isinstance(resources, list) \
            else [resources]
        if not actions or not resources:
            raise PolicyError("statement needs Action and Resource")
        for a in actions:
            if not str(a).startswith("s3:"):
                raise PolicyError(f"unsupported action {a!r}")
        out.append({"effect": effect, "principals": principals,
                    "actions": [str(a) for a in actions],
                    "resources": [str(r) for r in resources],
                    "conditions": conditions})
    return out


def _match_any(patterns: "list[str]", value: str) -> bool:
    return any(fnmatch.fnmatchcase(value, p) for p in patterns)


def evaluate(statements: "list[dict]", principal: str, action: str,
             resource: str, context: "dict | None" = None
             ) -> "str | None":
    """'Deny' | 'Allow' | None (no statement matched).  `principal` is
    the authenticated access key, or "*"/"anonymous" for unsigned
    requests.  Explicit Deny wins.  `context` feeds Condition
    evaluation; statements with conditions simply don't match when
    their conditions fail."""
    decision = None
    for s in statements:
        if not (_match_any(s["principals"], principal) or
                "*" in s["principals"]):
            continue
        if not _match_any(s["actions"], action):
            continue
        if not _match_any(s["resources"], resource):
            continue
        if s.get("conditions") and not _condition_matches(
                s["conditions"], context or {}):
            continue
        if s["effect"] == "Deny":
            return "Deny"
        decision = "Allow"
    return decision


# bucket subresources get their OWN action names: an s3:ListBucket
# grant must not expose the policy/CORS/versioning/lock configs
_SUBRESOURCE_ACTIONS = {
    "policy": "BucketPolicy",
    "cors": "BucketCORS",
    "versioning": "BucketVersioning",
    "object-lock": "BucketObjectLockConfiguration",
    "lifecycle": "BucketLifecycle",
    "versions": None,  # ListBucketVersions, handled below
}


def action_for(method: str, bucket: str, key: str,
               query: dict) -> str:
    """Map an S3 request to its IAM action name (the subset the
    reference's engine distinguishes first)."""
    if "acl" in query:
        # ACL ops get their own names on BOTH bucket and object paths:
        # a plain read/write grant must not confer ReadAcp/WriteAcp
        verb = "Put" if method == "PUT" else "Get"
        return f"s3:{verb}{'ObjectAcl' if key else 'BucketAcl'}"
    if not key:
        for sub, name in _SUBRESOURCE_ACTIONS.items():
            if sub in query:
                if sub == "versions":
                    return "s3:ListBucketVersions"
                verb = {"GET": "Get", "HEAD": "Get", "PUT": "Put",
                        "DELETE": "Delete"}.get(method, method.title())
                return f"s3:{verb}{name}"
    if key:
        if method in ("GET", "HEAD"):
            return "s3:GetObject" if "versionId" not in query else \
                "s3:GetObjectVersion"
        if method == "PUT":
            return "s3:PutObject"
        if method == "DELETE":
            return "s3:DeleteObject" if "versionId" not in query \
                else "s3:DeleteObjectVersion"
        if method == "POST":
            return "s3:PutObject"
        return f"s3:{method.title()}Object"
    if method in ("GET", "HEAD"):
        return "s3:ListBucket"
    if method == "PUT":
        return "s3:CreateBucket"
    if method == "DELETE":
        return "s3:DeleteBucket"
    if method == "POST":
        return "s3:DeleteObject"  # batch delete
    return f"s3:{method.title()}Bucket"


def resource_arn(bucket: str, key: str) -> str:
    return f"arn:aws:s3:::{bucket}/{key}" if key else \
        f"arn:aws:s3:::{bucket}"
