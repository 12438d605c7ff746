"""Bucket lifecycle configuration (reference:
s3api_bucket_handlers.go lifecycle handlers + the shell enforcement
pass s3.clean.uploads / filer TTL mapping).

Supported rule shape (the expiration core of AWS's schema):

    <LifecycleConfiguration>
      <Rule>
        <ID>...</ID>
        <Filter><Prefix>logs/</Prefix></Filter>   (or bare <Prefix>)
        <Status>Enabled</Status>
        <Expiration><Days>30</Days></Expiration>  (or <Date>)
        <AbortIncompleteMultipartUpload>
          <DaysAfterInitiation>7</DaysAfterInitiation>
        </AbortIncompleteMultipartUpload>
      </Rule>
    </LifecycleConfiguration>

The port's copy of `seaweedfs_tpu/s3/lifecycle.py`.
"""

from __future__ import annotations

import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from datetime import datetime, timezone


class LifecycleError(ValueError):
    pass


@dataclass
class Rule:
    rule_id: str
    prefix: str
    enabled: bool
    expire_days: "int | None" = None
    expire_date: "float | None" = None
    abort_mpu_days: "int | None" = None

    def expires_before(self, now: float) -> "float | None":
        """Cutoff mtime: objects older than this are expired."""
        if self.expire_days is not None:
            return now - self.expire_days * 86400
        if self.expire_date is not None and now >= self.expire_date:
            return now
        return None


def _tag(el) -> str:
    return el.tag.rsplit("}", 1)[-1]


def _child_text(parent, name: str) -> "str | None":
    for el in parent:
        if _tag(el) == name and el.text and el.text.strip():
            return el.text.strip()
    return None


def parse_lifecycle(doc: bytes) -> "list[Rule]":
    """Element-SCOPED parsing: a <Days> inside <Transition> must not
    read as Expiration, and unsupported actions/filters are REJECTED
    rather than silently dropped (misreading either turns a
    non-destructive config into data deletion)."""
    try:
        root = ET.fromstring(doc)
    except ET.ParseError as e:
        raise LifecycleError(f"undecodable lifecycle XML: {e}")
    rules = []
    for rule_el in root:
        if not _tag(rule_el).endswith("Rule"):
            continue
        rule_id = _child_text(rule_el, "ID") or ""
        status = _child_text(rule_el, "Status") or ""
        if status not in ("Enabled", "Disabled"):
            raise LifecycleError(f"Rule needs Status "
                                 f"Enabled|Disabled, got {status!r}")
        prefix = _child_text(rule_el, "Prefix") or ""
        expire_days = expire_date = abort_days = None
        for el in rule_el:
            tag = _tag(el)
            if tag in ("ID", "Status", "Prefix"):
                continue
            if tag == "Filter":
                for f in el:
                    if _tag(f) == "Prefix":
                        prefix = (f.text or "").strip()
                    else:
                        raise LifecycleError(
                            f"unsupported Filter element "
                            f"{_tag(f)!r} (only Prefix)")
                continue
            if tag == "Expiration":
                days = _child_text(el, "Days")
                date = _child_text(el, "Date")
                try:
                    if days is not None:
                        expire_days = int(days)
                        if expire_days <= 0:
                            raise LifecycleError(
                                "Expiration Days must be > 0")
                    if date is not None:
                        expire_date = datetime.fromisoformat(
                            date.replace("Z", "+00:00")).astimezone(
                            timezone.utc).timestamp()
                except ValueError as e:
                    raise LifecycleError(str(e))
                continue
            if tag == "AbortIncompleteMultipartUpload":
                raw = _child_text(el, "DaysAfterInitiation")
                try:
                    abort_days = int(raw) if raw is not None else None
                except ValueError as e:
                    raise LifecycleError(str(e))
                if abort_days is None or abort_days <= 0:
                    raise LifecycleError(
                        "DaysAfterInitiation must be > 0")
                continue
            # Transition / NoncurrentVersionExpiration / unknown:
            # refusing beats misinterpreting a non-destructive action
            raise LifecycleError(f"unsupported Rule element {tag!r}")
        if expire_days is None and expire_date is None and \
                abort_days is None:
            raise LifecycleError(
                "Rule needs an Expiration or "
                "AbortIncompleteMultipartUpload action")
        rules.append(Rule(rule_id, prefix, status == "Enabled",
                          expire_days, expire_date, abort_days))
    if not rules:
        raise LifecycleError("no Rule elements")
    return rules


def apply_lifecycle(filer, bucket_path: str, rules: "list[Rule]",
                    now: "float | None" = None) -> "tuple[int, int]":
    """One enforcement pass over a bucket: delete expired objects and
    abort stale multipart uploads.  Returns (objects_deleted,
    uploads_aborted).  Mirrors the reference's shell-driven
    enforcement (lifecycle is applied by a maintenance pass, not
    inline on reads)."""
    now = now or time.time()
    deleted = aborted = 0
    for rule in rules:
        if not rule.enabled:
            continue
        cutoff = rule.expires_before(now)
        if cutoff is not None:
            deleted += _expire_tree(filer, bucket_path, bucket_path,
                                    rule.prefix, cutoff)
        if rule.abort_mpu_days is not None:
            updir = f"{bucket_path}/.uploads"
            mpu_cutoff = now - rule.abort_mpu_days * 86400
            for e in filer.list_directory(updir, limit=10000):
                # the marker records the upload's target key: the
                # rule's prefix filter applies to it (AWS semantics —
                # aborting out-of-scope uploads loses parts)
                target = e.extended.get("key", "")
                if rule.prefix and not target.startswith(rule.prefix):
                    continue
                if e.is_directory and \
                        e.attributes.crtime < mpu_cutoff:
                    filer.delete_entry(e.full_path, recursive=True)
                    aborted += 1
    return deleted, aborted


def _expire_tree(filer, bucket_path: str, directory: str,
                 prefix: str, cutoff: float) -> int:
    deleted = 0
    last = ""
    while True:
        batch = filer.list_directory(directory, start_file=last,
                                     limit=500)
        if not batch:
            break
        for e in batch:
            rel = e.full_path[len(bucket_path):].lstrip("/")
            if e.is_directory:
                if e.name.startswith(".") or \
                        e.name.endswith(".versions"):
                    # .uploads scratch + "<key>.versions" archives:
                    # Expiration must never hard-delete version
                    # history (that is NoncurrentVersionExpiration,
                    # unsupported -> untouched)
                    continue
                # descend only if the prefix could match inside
                if not prefix or prefix.startswith(rel + "/") or \
                        rel.startswith(prefix):
                    deleted += _expire_tree(filer, bucket_path,
                                            e.full_path, prefix,
                                            cutoff)
                continue
            if prefix and not rel.startswith(prefix):
                continue
            if e.attributes.mtime < cutoff:
                filer.delete_entry(e.full_path)
                deleted += 1
        if len(batch) < 500:
            break
        last = batch[-1].name
    return deleted
