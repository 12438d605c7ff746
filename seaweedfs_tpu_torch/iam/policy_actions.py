"""IAM policy documents to coarse identity actions
(iamapi_management_handlers.go GetActions), the port's copy of the part
of `seaweedfs_tpu/iam/iamapi.py` that the identity store uses to derive
group and managed-policy grants; `iam/iamapi.py` (the IAM API server)
uses it too."""

from __future__ import annotations

import json

from .identity import (ACTION_ADMIN, ACTION_LIST, ACTION_READ,
                       ACTION_TAGGING, ACTION_WRITE)


class IamError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code


def policy_to_actions(doc: str) -> list[str]:
    """iamapi_management_handlers.go GetActions: statements of an IAM
    policy document -> coarse identity actions.  Unknown actions raise
    (the reference rejects invalid documents at Put time)."""
    try:
        policy = json.loads(doc)
        statements = policy["Statement"]
    except (ValueError, KeyError, TypeError):
        raise IamError(400, "MalformedPolicyDocument",
                       "undecodable policy document")
    if isinstance(statements, dict):
        statements = [statements]
    out: list[str] = []
    for st in statements:
        if st.get("Effect") != "Allow":
            raise IamError(400, "MalformedPolicyDocument",
                           "only Effect=Allow is supported here")
        actions = st.get("Action", [])
        resources = st.get("Resource", [])
        if isinstance(actions, str):
            actions = [actions]
        if isinstance(resources, str):
            resources = [resources]
        for res in resources:
            prefix = "arn:aws:s3:::"
            if not res.startswith(prefix):
                raise IamError(400, "MalformedPolicyDocument",
                               f"unsupported resource {res}")
            scope = res[len(prefix):].rstrip("*").rstrip("/")
            for act in actions:
                coarse = _statement_action(act)
                if scope in ("", "*"):
                    out.append(coarse)
                else:
                    out.append(f"{coarse}:{scope}")
    return sorted(set(out))


def _statement_action(act: str) -> str:
    a = act.removeprefix("s3:")
    if a == "*":
        return ACTION_ADMIN
    if "Tagging" in a:
        return ACTION_TAGGING
    if a.startswith("List"):
        return ACTION_LIST
    if a.startswith(("Get", "Head")) or a == "Read":
        return ACTION_READ
    if a.startswith(("Put", "Delete", "Abort", "Restore", "Create")):
        return ACTION_WRITE
    raise IamError(400, "MalformedPolicyDocument",
                   f"unsupported action {act}")
