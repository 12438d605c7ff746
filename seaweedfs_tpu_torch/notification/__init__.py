"""Metadata notification fan-out (weed/notification/configuration.go), the
port's copy of `seaweedfs_tpu/notification/__init__.py`.

The reference publishes every filer metadata mutation to a configured
message bus (kafka / aws_sqs / google_pub_sub / gocdk) keyed by file
path; consumers build search indexes, replication queues, and audit
trails from it.  This package is that plane: a `Publisher` interface,
concrete webhook / SQS / Pub/Sub / log-file publishers selected by a
spec string (notification.toml analog), and a `NotificationTailer` that
follows the filer's persistent metadata log and fans every event out
with at-least-once delivery (checkpointed offset, per-event retries with
backoff).  Each publisher sends the JAX package's bytes for an event.

Spec strings:
    webhook:http://host:port/path     POST one JSON event per request
    sqs:<queue_url>                   AWS SQS SendMessage (SigV4; creds
                                      from the standard env vars)
    pubsub:<endpoint>/projects/<p>/topics/<t>
                                      Google Pub/Sub REST publish
    logfile:/path/to/file             append JSON lines (debug/audit)

`mq:` and `kafka:` (the JAX package's built-in MQ broker and the Kafka
wire client) are not ported: `from_spec` raises `NotPorted` for them
(ROADMAP A8).
"""

from __future__ import annotations

import json
import os
import threading


class Publisher:
    def publish(self, event: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


def _event_key(event: dict) -> str:
    """One key rule for every sink: the entry path (per-path ordering
    in partitioned topics depends on all sinks agreeing)."""
    return (event.get("newEntry") or event.get("oldEntry") or
            {}).get("fullPath", "")


class WebhookPublisher(Publisher):
    """POST each event as JSON (the gocdk/webhook shape)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout

    def publish(self, event: dict) -> None:
        # the JAX publisher's body and content type, sent over the
        # port's pooled client (which dials the URL itself, no proxy)
        from ..server.httpd import http_bytes
        st, _, _ = http_bytes("POST", self.url, json.dumps(event).encode(),
                              {"Content-Type": "application/json"},
                              timeout=self.timeout)
        if st >= 300:
            raise OSError(f"webhook {self.url}: {st}")


class SqsPublisher(Publisher):
    """AWS SQS SendMessage over the Query API with SigV4
    (weed/notification/aws_sqs/aws_sqs_pub.go role).  Credentials come
    from the standard env vars (AWS_ACCESS_KEY_ID /
    AWS_SECRET_ACCESS_KEY); the queue URL carries the endpoint, so a
    local SQS-compatible server works for tests and the real service
    when egress exists."""

    def __init__(self, queue_url: str, region: str = ""):
        import urllib.parse as up
        self.queue_url = queue_url
        u = up.urlsplit(queue_url)
        self.origin = f"{u.scheme}://{u.netloc}"
        self.path = u.path or "/"
        # region from the standard host shape sqs.<region>.amazonaws.com
        host_parts = u.netloc.split(".")
        self.region = region or os.environ.get("AWS_REGION") or (
            host_parts[1] if len(host_parts) > 2 and
            host_parts[0].startswith("sqs") else "us-east-1")

    def publish(self, event: dict) -> None:
        import urllib.parse as up

        from ..s3.auth import sign_request
        from ..server.httpd import http_bytes
        body = up.urlencode({
            "Action": "SendMessage",
            "Version": "2012-11-05",
            "MessageBody": json.dumps(event),
            "MessageAttribute.1.Name": "key",
            "MessageAttribute.1.Value.DataType": "String",
            "MessageAttribute.1.Value.StringValue": _event_key(event),
        }).encode()
        ak = os.environ.get("AWS_ACCESS_KEY_ID", "")
        sk = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        headers = {"Content-Type":
                   "application/x-www-form-urlencoded"}
        if ak:
            # sign_request takes the scheme-less authority (it becomes
            # the signed host header verbatim)
            import urllib.parse as up
            headers = sign_request(
                "POST", up.urlsplit(self.origin).netloc, self.path,
                {}, headers, body, ak, sk, region=self.region,
                service="sqs")
        st, resp, _ = http_bytes("POST", self.origin + self.path,
                                 body, headers)
        if st >= 300:
            raise OSError(f"sqs {self.queue_url}: {st} {resp[:200]}")


class PubSubPublisher(Publisher):
    """Google Pub/Sub REST publish
    (weed/notification/google_pub_sub/google_pub_sub.go role):
    POST {endpoint}/v1/projects/<p>/topics/<t>:publish with base64
    message data + the entry path as an attribute.  Bearer token from
    `token` or env GOOGLE_BEARER_TOKEN; the official emulator needs
    none."""

    def __init__(self, endpoint: str, project: str, topic: str,
                 token: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.project = project
        self.topic = topic
        self.token = token or os.environ.get("GOOGLE_BEARER_TOKEN", "")

    def publish(self, event: dict) -> None:
        import base64

        from ..server.httpd import http_bytes
        payload = json.dumps({"messages": [{
            "data": base64.b64encode(
                json.dumps(event).encode()).decode(),
            "attributes": {"key": _event_key(event)},
        }]}).encode()
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        st, resp, _ = http_bytes(
            "POST", f"{self.endpoint}/v1/projects/{self.project}"
                    f"/topics/{self.topic}:publish", payload, headers)
        if st >= 300:
            raise OSError(f"pubsub {self.project}/{self.topic}: "
                          f"{st} {resp[:200]}")


class LogFilePublisher(Publisher):
    """Append JSON lines — the audit/debug sink."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def publish(self, event: dict) -> None:
        with self._lock:
            self._f.write(json.dumps(event) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class NotPorted(ValueError):
    """A sink of the JAX package that the port does not have yet."""


def from_spec(spec: str) -> Publisher:
    """notification.toml analog: one enabled sink chosen by spec."""
    kind, _, rest = spec.partition(":")
    if kind == "webhook":
        return WebhookPublisher(rest)
    if kind == "logfile":
        return LogFilePublisher(rest)
    if kind in ("mq", "kafka"):
        raise NotPorted(
            f"-notification {kind}: not ported yet (ROADMAP A8, the MQ "
            f"client)")
    if kind == "sqs":
        # sqs:https://sqs.us-east-1.amazonaws.com/123456/my-queue
        if "://" not in rest:
            raise ValueError(
                f"sqs spec must be sqs:<queue_url>: {spec!r}")
        return SqsPublisher(rest)
    if kind == "pubsub":
        # pubsub:https://pubsub.googleapis.com/projects/<p>/topics/<t>
        endpoint, sep, tail = rest.partition("/projects/")
        project, _, topic = tail.partition("/topics/")
        if not (sep and project and topic):
            raise ValueError(
                "pubsub spec must be "
                f"pubsub:<endpoint>/projects/<p>/topics/<t>: {spec!r}")
        return PubSubPublisher(endpoint, project, topic)
    raise ValueError(f"unknown notification spec {spec!r} "
                     "(webhook:|mq:|kafka:|sqs:|pubsub:|logfile:)")


class NotificationTailer:
    """Follows a filer's MetaLog and fans events out with at-least-once
    delivery: the offset checkpoint advances only after a successful
    publish, and failures retry with capped backoff (the reference's
    notification queue blocks the same way rather than dropping)."""

    def __init__(self, meta_log, publisher: Publisher,
                 state_path: str | None = None,
                 poll_interval: float = 0.2):
        self.meta_log = meta_log
        self.publisher = publisher
        self.state_path = state_path
        self.poll_interval = poll_interval
        self._since = self._load_offset()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _load_offset(self) -> int:
        if not self.state_path:
            return 0
        try:
            with open(self.state_path, encoding="utf-8") as f:
                return int(json.load(f).get("sinceNs", 0))
        except (OSError, ValueError):
            return 0

    def _save_offset(self) -> None:
        if not self.state_path:
            return
        tmp = f"{self.state_path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"sinceNs": self._since}, f)
        os.replace(tmp, self.state_path)

    def start(self) -> "NotificationTailer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.publisher.close()

    def _run(self) -> None:
        backoff = self.poll_interval
        while not self._stop.is_set():
            events = self.meta_log.events_since(self._since, limit=256)
            if not events:
                self._stop.wait(self.poll_interval)
                continue
            for ev in events:
                while not self._stop.is_set():
                    try:
                        self.publisher.publish(ev)
                        backoff = self.poll_interval
                        break
                    except OSError:
                        # at-least-once: never advance past an
                        # undelivered event; capped exponential backoff
                        self._stop.wait(backoff)
                        backoff = min(backoff * 2, 10.0)
                if self._stop.is_set():
                    return
                self._since = ev["tsNs"]
                self._save_offset()
