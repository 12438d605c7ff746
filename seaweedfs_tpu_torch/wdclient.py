"""The follow stream's client, the port's copy of `seaweedfs_tpu/
wdclient.py`: a vid map fed by the master's pushes
(weed/wdclient/masterclient.go:417-471, vid_map.go).

A background thread long-polls the master's `/cluster/watch`: a snapshot
of the topology first, then the location deltas after its cursor.  It
keeps vid -> locations, so a lookup is local and a volume that moves or
leaves is seen as soon as the master publishes it.  Long-lived processes
(the filer) call `operation.enable_follow(master)`; one-shot verbs keep
the TTL'd lookup cache.

It speaks the JAX master's wire, so it follows either package's master.
EC shard locations stay resolved by RPC (`/dir/ec_lookup`): the degraded
read path needs each shard's placement, which the deltas do not carry.
The stream follows the raft leader (wdclient.go:158-170): the leader a
master announces (the `leader` of each answer, and `{"leader": url}`
events on its hub) re-points the poll and feeds `operation`'s leader
cache for the seed list, and the stream then resyncs from a snapshot,
because a new leader's hub is fresh and the cursor means nothing there.
A stream error resets the poll to the seed list, whose `not leader`
hints find whoever leads now.
"""

from __future__ import annotations

import random
import threading


def _backoff(failures: int, base: float = 0.5, cap: float = 15.0) -> float:
    """A full-jitter delay for the `failures`-th failure in a row."""
    return random.uniform(0, min(cap, base * 2 ** max(failures - 1, 0)))


class MasterFollower:
    def __init__(self, master: str, poll_timeout: float = 25.0):
        self.master = master
        self.poll_timeout = poll_timeout
        # where the loop polls: the address given, then the leader the
        # master announces; a stream error resets it to the address given
        self._target = master
        self._lock = threading.Lock()
        self._vids: dict[int, dict[str, dict]] = {}  # vid -> url -> loc
        self._leader: "str | None" = None
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # snapshots and event batches applied (tests, the smoke)
        self.snapshots = 0
        self.events = 0

    # -- what a consumer reads ---------------------------------------------

    def get_locations(self, vid: int) -> "list[dict] | None":
        """The pushed locations of `vid`; None when unknown or before the
        first snapshot, and the caller then asks the master (a push for a
        freshly grown volume may trail the assign that named it)."""
        if not self._synced.is_set():
            return None
        with self._lock:
            m = self._vids.get(vid)
            return list(m.values()) if m else None

    def state(self) -> dict:
        """What the stream holds: synced, the snapshots and event batches
        applied, the leader heard and the poll's target, and vid -> the
        pushed urls (the filer's `/debug/follow`)."""
        with self._lock:
            vids = {str(v): sorted(m) for v, m in sorted(self._vids.items())}
            return {"synced": self._synced.is_set(),
                    "snapshots": self.snapshots, "events": self.events,
                    "leader": self._leader, "target": self._target,
                    "volumes": vids}

    @property
    def leader(self) -> "str | None":
        return self._leader

    @property
    def target(self) -> str:
        return self._target

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "MasterFollower":
        self._thread = threading.Thread(target=self._run,
                                        name="master-follower", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Ask the loop to end.  No join: it is parked in a long poll
        most of the time, and a daemon that checks the flag each turn."""
        self._stop.set()

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    # -- the stream loop --------------------------------------------------------

    def _run(self) -> None:
        from .operation import master_json
        cursor = -1
        hub = ""
        failures = 0
        while not self._stop.is_set():
            try:
                if cursor < 0:
                    r = master_json(self._target, "GET",
                                    "/cluster/watch?snapshot=1", timeout=10)
                    if "error" in r:
                        raise OSError(r["error"])
                    self._apply_snapshot(r.get("snapshot") or {})
                    self._note_leader(r.get("leader"))
                    cursor = int(r.get("cursor", 0))
                    # the cursor's hub: a poll that a redirect lands on
                    # another master's answers lagged, not that hub's
                    # events after a foreign cursor
                    hub = r.get("hub", "")
                    self._synced.set()
                    failures = 0
                    continue
                r = master_json(
                    self._target, "GET",
                    f"/cluster/watch?since={cursor}"
                    f"&timeout={self.poll_timeout}" +
                    (f"&hub={hub}" if hub else ""),
                    timeout=self.poll_timeout + 10)
                if "error" in r:
                    raise OSError(r["error"])
                moved = self._note_leader(r.get("leader"))
                if r.get("lagged"):
                    cursor = -1          # the ring lost events: resync
                    self._synced.clear()
                    continue
                failures = 0
                cursor = int(r.get("cursor", cursor))
                for ev in r.get("events", []):
                    if "leader" in ev:
                        moved = self._note_leader(ev["leader"]) or moved
                        continue
                    self._apply_event(ev)
                if moved:
                    # a new leader's hub is fresh: the cursor means
                    # nothing there
                    cursor = -1
                    self._synced.clear()
            except (OSError, ValueError):
                # the master unreachable or erroring: back off with
                # jitter, then resync from the address given
                self._synced.clear()
                cursor = -1
                failures += 1
                self._target = self.master
                self._stop.wait(max(0.05, _backoff(failures)))

    def _note_leader(self, leader: "str | None") -> bool:
        """Record an announced leader, in `operation`'s leader cache too;
        True when it moved the poll target (the caller resyncs)."""
        if leader and leader != self._leader:
            self._leader = leader
            from . import operation
            operation.note_leader(self.master, leader)
        if leader and leader != self._target:
            self._target = leader
            return True
        return False

    def _apply_snapshot(self, topo: dict) -> None:
        vids: dict[int, dict[str, dict]] = {}
        for dc in (topo.get("dataCenters") or {}).values():
            for rack in dc.get("racks", {}).values():
                for node in rack.get("nodes", []):
                    loc = {"url": node["url"],
                           "publicUrl": node.get("publicUrl", node["url"])}
                    for v in node.get("volumes", []):
                        vids.setdefault(v["id"], {})[loc["url"]] = loc
        with self._lock:
            self._vids = vids
            self.snapshots += 1

    def _apply_event(self, ev: dict) -> None:
        if "url" not in ev:
            return
        loc = {"url": ev["url"],
               "publicUrl": ev.get("publicUrl", ev["url"])}
        with self._lock:
            for vid in ev.get("newVids", []):
                self._vids.setdefault(vid, {})[loc["url"]] = loc
            for vid in ev.get("deletedVids", []):
                m = self._vids.get(vid)
                if m:
                    m.pop(loc["url"], None)
                    if not m:
                        self._vids.pop(vid, None)
            self.events += 1
