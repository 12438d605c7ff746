"""Bucket CORS configuration + request evaluation
(weed/s3api/cors/ — PutBucketCors/GetBucketCors + the middleware that
answers preflights and decorates responses).

Config is the standard XML:
  <CORSConfiguration><CORSRule>
    <AllowedOrigin>https://a.example</AllowedOrigin>
    <AllowedMethod>GET</AllowedMethod>
    <AllowedHeader>*</AllowedHeader>
    <ExposeHeader>ETag</ExposeHeader>
    <MaxAgeSeconds>3000</MaxAgeSeconds>
  </CORSRule>...</CORSConfiguration>
Stored per bucket; evaluated per request Origin/method.

The port's copy of `seaweedfs_tpu/s3/cors.py`.
"""

from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field


@dataclass
class CorsRule:
    allowed_origins: list[str] = field(default_factory=list)
    allowed_methods: list[str] = field(default_factory=list)
    allowed_headers: list[str] = field(default_factory=list)
    expose_headers: list[str] = field(default_factory=list)
    max_age_seconds: int | None = None

    def matches_origin(self, origin: str) -> bool:
        return any(fnmatch.fnmatchcase(origin, pat)
                   for pat in self.allowed_origins)

    def allows_headers(self, req_headers: list[str]) -> bool:
        for h in req_headers:
            h = h.strip().lower()
            if not h:
                continue
            if not any(fnmatch.fnmatchcase(h, pat.lower())
                       for pat in self.allowed_headers):
                return False
        return True


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_cors_config(xml_bytes: bytes) -> list[CorsRule]:
    """Raises ValueError on malformed config (PutBucketCors validates
    before storing)."""
    root = ET.fromstring(xml_bytes)
    rules = []
    for rule_el in root:
        if _local(rule_el.tag) != "CORSRule":
            continue
        rule = CorsRule()
        for el in rule_el:
            tag, text = _local(el.tag), (el.text or "").strip()
            if tag == "AllowedOrigin":
                rule.allowed_origins.append(text)
            elif tag == "AllowedMethod":
                rule.allowed_methods.append(text.upper())
            elif tag == "AllowedHeader":
                rule.allowed_headers.append(text)
            elif tag == "ExposeHeader":
                rule.expose_headers.append(text)
            elif tag == "MaxAgeSeconds":
                rule.max_age_seconds = int(text)
        if not rule.allowed_origins or not rule.allowed_methods:
            raise ValueError(
                "CORSRule needs AllowedOrigin and AllowedMethod")
        rules.append(rule)
    if not rules:
        raise ValueError("no CORSRule in configuration")
    return rules


def evaluate(rules: list[CorsRule], origin: str, method: str,
             request_headers: str = "") -> dict | None:
    """Returns the CORS response headers for a matching rule, or None.
    `method` is the actual method (simple requests) or the preflight's
    Access-Control-Request-Method."""
    req_hdrs = [h for h in request_headers.split(",") if h.strip()] \
        if request_headers else []
    for rule in rules:
        if not rule.matches_origin(origin):
            continue
        if method.upper() not in rule.allowed_methods:
            continue
        if req_hdrs and not rule.allows_headers(req_hdrs):
            continue
        headers = {
            "Access-Control-Allow-Origin":
                "*" if rule.allowed_origins == ["*"] else origin,
            "Access-Control-Allow-Methods":
                ", ".join(rule.allowed_methods),
            "Vary": "Origin",
        }
        if req_hdrs:
            headers["Access-Control-Allow-Headers"] = request_headers
        if rule.expose_headers:
            headers["Access-Control-Expose-Headers"] = \
                ", ".join(rule.expose_headers)
        if rule.max_age_seconds is not None:
            headers["Access-Control-Max-Age"] = \
                str(rule.max_age_seconds)
        return headers
    return None
