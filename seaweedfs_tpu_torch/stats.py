"""Prometheus-style metrics registry (the counterpart of
`seaweedfs_tpu/stats.py`'s `Metrics` and `PROCESS`), rendered in the
Prometheus text format.

Only the registry: the process-tree sampler and the push-gateway loop
come with the server slice of the port.
"""

from __future__ import annotations

import threading
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

    def counter_value(self, name: str, **labels) -> "float | None":
        """One counter cell (exact label set), or None if it was never
        incremented."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key)

    def counter_sum(self, name: str) -> float:
        """Counter `name` summed over every label set (0 if never
        incremented)."""
        with self._lock:
            return sum(v for (n, _labels), v in self._counters.items()
                       if n == name)

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


# process-wide registry: the device telemetry (profiling.py) lands here
PROCESS = Metrics("seaweedfs_tpu")
