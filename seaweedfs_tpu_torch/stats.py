"""Prometheus-style metrics registry (the counterpart of
`seaweedfs_tpu/stats.py`'s `Metrics` and `PROCESS`), rendered in the
Prometheus text format, and the process-tree sampler every role's
`/metrics` appends (`render_process`), and the push-gateway loop that
`-metricsAddress` starts (`MetricsPusher`).
"""

from __future__ import annotations

import os
import threading
import urllib.parse
from collections import defaultdict

# latency buckets in seconds, 5ms through 10s (the reference's)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

# the filer meta plane's sub-stages (filer/meta_plane.py): serialize and
# barrier live in the 50us..25ms band; the async apply's per-event share
# sits near the bottom of it
META_SUB_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                    0.005, 0.01, 0.025, 0.05, 0.1, 0.25)


def escape_label_value(v) -> str:
    """Prometheus text-format label escaping: backslash, double quote
    and line feed are escaped, so a label value cannot tear a line."""
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


class Metrics:
    """Counters, gauges and histograms keyed by (name, label set)."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = defaultdict(float)
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], dict] = {}
        self._help: dict[str, str] = {}
        # observers memoized for call sites whose owner is transient
        # (per-request stage tracks): caller-chosen key -> observer
        self.obs_memo: dict = {}

    def counter_add(self, name: str, value: float = 1.0,
                    help_text: str = "", **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] += value
            if help_text:
                self._help.setdefault(name, help_text)

    def gauge_set(self, name: str, value: float, help_text: str = "",
                  **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value
            if help_text:
                self._help.setdefault(name, help_text)

    def histogram_observe(self, name: str, value: float,
                          buckets: "tuple[float, ...]" = DEFAULT_BUCKETS,
                          help_text: str = "", **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = {
                    "buckets": tuple(buckets),
                    "counts": [0] * (len(buckets) + 1),  # +Inf last
                    "sum": 0.0, "count": 0}
            for i, le in enumerate(h["buckets"]):
                if value <= le:
                    h["counts"][i] += 1
                    break
            else:
                h["counts"][-1] += 1
            h["sum"] += value
            h["count"] += 1
            if help_text:
                self._help.setdefault(name, help_text)

    def _hist_cell(self, name: str, buckets, help_text: str,
                   labels: dict) -> dict:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = {
                    "buckets": tuple(buckets),
                    "counts": [0] * (len(buckets) + 1),  # +Inf last
                    "sum": 0.0, "count": 0}
            if help_text:
                self._help.setdefault(name, help_text)
        return h

    def observer(self, name: str,
                 buckets: "tuple[float, ...]" = DEFAULT_BUCKETS,
                 help_text: str = "", **labels):
        """A pre-resolved `histogram_observe` for one label set: the
        cell is looked up once, and the returned closure only scans the
        buckets under the registry lock.  Hot call sites keep one for
        each label set."""
        h = self._hist_cell(name, buckets, help_text, labels)
        lock, bkts, counts = self._lock, h["buckets"], h["counts"]

        def observe(value: float) -> None:
            with lock:
                for i, le in enumerate(bkts):
                    if value <= le:
                        counts[i] += 1
                        break
                else:
                    counts[-1] += 1
                h["sum"] += value
                h["count"] += 1

        return observe

    def batch_observer(self, name: str,
                       buckets: "tuple[float, ...]" = DEFAULT_BUCKETS,
                       help_text: str = "", **labels):
        """The bulk form of `observer`: one lock round for a whole array
        of values, bucketed with `np.searchsorted` (the native planes'
        record drain observes thousands of stage samples a tick)."""
        h = self._hist_cell(name, buckets, help_text, labels)
        lock, bkts, counts = self._lock, h["buckets"], h["counts"]

        def observe_batch(values) -> None:
            if not len(values):
                return
            import numpy as np
            vals = np.asarray(values, dtype=np.float64)
            # side="left": the first bucket with le >= value, as the
            # scalar scan's `value <= le`
            idx = np.searchsorted(np.asarray(bkts), vals, side="left")
            per = np.bincount(idx, minlength=len(counts))
            total = float(vals.sum())
            with lock:
                for i, c in enumerate(per.tolist()):
                    if c:
                        counts[i] += c
                h["sum"] += total
                h["count"] += len(vals)

        return observe_batch

    def counter_value(self, name: str, **labels) -> "float | None":
        """One counter cell (exact label set), or None if it was never
        incremented."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key)

    def counter_sum(self, name: str, **labels) -> float:
        """Counter `name` summed over every label set that carries at
        least `labels` (0 if never incremented)."""
        want = set(labels.items())
        with self._lock:
            return sum(v for (n, ls), v in self._counters.items()
                       if n == name and want.issubset(ls))

    def gauge_value(self, name: str, **labels) -> "float | None":
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._gauges.get(key)

    def histogram_merged(self, name: str) -> "dict | None":
        """Histogram `name` merged across every label set:
        {"buckets", "counts", "sum", "count"}, or None when it was
        never observed."""
        merged: "dict | None" = None
        with self._lock:
            for (n, _labels), h in self._hists.items():
                if n != name:
                    continue
                if merged is None:
                    merged = {"buckets": h["buckets"],
                              "counts": list(h["counts"]),
                              "sum": h["sum"], "count": h["count"]}
                elif merged["buckets"] == h["buckets"]:
                    merged["counts"] = [
                        a + b for a, b in zip(merged["counts"],
                                              h["counts"])]
                    merged["sum"] += h["sum"]
                    merged["count"] += h["count"]
        return merged

    def render(self) -> str:
        """Prometheus text exposition format."""
        out = []
        with self._lock:
            seen_types: set[str] = set()
            for store, mtype in ((self._counters, "counter"),
                                 (self._gauges, "gauge")):
                for (name, labels), value in sorted(store.items()):
                    full = f"{self.namespace}_{name}"
                    if full not in seen_types:
                        if name in self._help:
                            out.append(f"# HELP {full} "
                                       f"{self._help[name]}")
                        out.append(f"# TYPE {full} {mtype}")
                        seen_types.add(full)
                    if labels:
                        lbl = ",".join(
                            f'{k}="{escape_label_value(v)}"'
                            for k, v in labels)
                        out.append(f"{full}{{{lbl}}} {value}")
                    else:
                        out.append(f"{full} {value}")
            for (name, labels), h in sorted(self._hists.items()):
                full = f"{self.namespace}_{name}"
                if full not in seen_types:
                    if name in self._help:
                        out.append(f"# HELP {full} {self._help[name]}")
                    out.append(f"# TYPE {full} histogram")
                    seen_types.add(full)
                base = [f'{k}="{escape_label_value(v)}"'
                        for k, v in labels]
                cum = 0
                for le, n in zip(h["buckets"], h["counts"]):
                    cum += n
                    lbl = ",".join(base + [f'le="{le}"'])
                    out.append(f"{full}_bucket{{{lbl}}} {cum}")
                lbl = ",".join(base + ['le="+Inf"'])
                out.append(f"{full}_bucket{{{lbl}}} {h['count']}")
                suffix = f"{{{','.join(base)}}}" if base else ""
                out.append(f"{full}_sum{suffix} {h['sum']}")
                out.append(f"{full}_count{suffix} {h['count']}")
        return "\n".join(out) + "\n"


# process-wide registry: the device telemetry (profiling.py), the
# pooled client, the caches and the planes land here; every role's
# /metrics appends it (render_process)
PROCESS = Metrics("seaweedfs_tpu")


def _proc_tree_sample() -> "tuple[float, float, int] | None":
    """(cpu_seconds, rss_bytes, process_count) of this process's whole
    /proc subtree: pre-fork filer siblings and their children included.
    One /proc pass builds the parent map; the walk is in memory.  None
    where /proc is absent.  Reaped children's CPU (cutime, cstime) rides
    along.

    The root is `SEAWEEDFS_TPU_TREE_ROOT` when set and alive (the filer
    pre-fork parent exports its pid before spawning its siblings, so a
    scrape the kernel routed to any one of them reports the fleet),
    else this process."""
    me = os.getpid()
    try:
        me = int(os.environ.get("SEAWEEDFS_TPU_TREE_ROOT", "") or me)
    except ValueError:
        pass
    try:
        clk = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        names = os.listdir("/proc")
    except (OSError, ValueError, AttributeError):
        return None
    info: "dict[int, tuple[int, float, float, float]]" = {}
    for d in names:
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                raw = f.read(4096)
            # the fields after comm's ")" (proc(5)): [1] ppid, [11]
            # utime, [12] stime, [13] cutime, [14] cstime, [21] rss
            parts = raw.rsplit(b") ", 1)[1].split()
            info[int(d)] = (
                int(parts[1]),
                (int(parts[11]) + int(parts[12])) / clk,
                (int(parts[13]) + int(parts[14])) / clk,
                int(parts[21]) * page)
        except (OSError, IndexError, ValueError):
            continue
    if me not in info:
        # a stale root (the pre-fork parent died): this process
        me = os.getpid()
        if me not in info:
            return None
    kids: "dict[int, list[int]]" = {}
    for pid, (ppid, _c, _rc, _r) in info.items():
        kids.setdefault(ppid, []).append(pid)
    cpu = rss = 0.0
    count = 0
    stack, seen = [me], set()
    while stack:
        pid = stack.pop()
        if pid in seen or pid not in info:
            continue
        seen.add(pid)
        _ppid, own, reaped, mem = info[pid]
        cpu += own + reaped
        rss += mem
        count += 1
        stack.extend(kids.get(pid, ()))
    return cpu, rss, count


def render_process() -> str:
    """`PROCESS` in the text format, after refreshing this process's
    CPU and its /proc subtree's CPU, RSS and process count (a filer
    fleet answers a scrape from one sibling; the tree gauges charge the
    whole fleet to it)."""
    t = os.times()
    PROCESS.gauge_set(
        "process_cpu_seconds", t[0] + t[1],
        help_text="user+system CPU consumed by this process "
                  "(cumulative; exported as a gauge)")
    tree = _proc_tree_sample()
    if tree is not None:
        cpu, rss, count = tree
        PROCESS.gauge_set(
            "process_tree_cpu_seconds", round(cpu, 3),
            help_text="user+system CPU of this process's whole /proc "
                      "subtree (pre-fork workers + native plane "
                      "children; cumulative, refreshed per scrape)")
        PROCESS.gauge_set(
            "process_tree_rss_bytes", rss,
            help_text="resident set of this process's whole /proc "
                      "subtree (shared pages double-counted across "
                      "forked workers)")
        PROCESS.gauge_set(
            "process_tree_procs", float(count),
            help_text="processes in this node's /proc subtree")
    return PROCESS.render()


class MetricsPusher:
    """LoopPushingMetric (metrics.go:534): every `interval` seconds, PUT
    the rendered registry to a Prometheus pushgateway at
    /metrics/job/<job>/instance/<instance>.  A failed push is logged
    (once until a push succeeds again) and retried at the next tick,
    never fatal: metrics delivery must not take a data server down."""

    def __init__(self, metrics: "Metrics", job: str, instance: str,
                 gateway: str, interval: float = 15.0):
        self.metrics = metrics
        self.gateway = gateway
        self.interval = interval
        self.path = (f"/metrics/job/{urllib.parse.quote(job)}"
                     f"/instance/{urllib.parse.quote(instance)}")
        self.pushed = self.failed = 0
        self._failing = False
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def push_once(self) -> bool:
        from .server.httpd import http_bytes
        from .util import wlog
        try:
            st, _, _ = http_bytes(
                "PUT", f"{self.gateway}{self.path}",
                self.metrics.render().encode(),
                {"Content-Type": "text/plain; version=0.0.4"})
            err = "" if st < 300 else f"HTTP {st}"
        except OSError as e:
            err = repr(e)
        if err:
            self.failed += 1
            if not self._failing:
                wlog.warning("metrics push to %s failed: %s; retrying "
                             "every %ss", self.gateway, err, self.interval,
                             component="stats")
            self._failing = True
            return False
        self.pushed += 1
        self._failing = False
        return True

    def start(self) -> "MetricsPusher":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-pusher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()
