"""Raft for the master set, the port's copy of `seaweedfs_tpu/server/
raft.py`: leader election and a replicated log over the JSON-HTTP control
plane (the reference runs hashicorp/raft, weed/server/raft_hashicorp.go).

- **The FSM** is a flat dict fed by entries {"index", "term", "key",
  "value"}.  The master keeps there what the reference keeps in its raft
  log: the topology identity (master_server.go:256
  syncRaftForTopologyId), the file-id sequence bound (`maxFileKey`), the
  highest volume id issued (`maxVolumeId`, MaxVolumeIdCommand of
  weed/topology/cluster_commands.go) and the membership (`peers`,
  master.proto:50-56 RaftAddServer/RaftRemoveServer).
- **Persistence** under `data_dir`, in the JAX package's format, so a
  JAX `-mdir` and a port `-mdir` read each other: `raft.state` (term and
  votedFor, fsynced before any vote leaves the node), `raft.log` (JSONL,
  fsynced on append; a torn tail line is dropped and the file rewritten
  to the recovered prefix before anything is appended) and `raft.snap`
  (the FSM, its last index and term; the log compacts past it once it
  holds more than `SNAPSHOT_THRESHOLD` entries).  Without `data_dir`
  everything is in memory.
- **Election safety.**  A vote carries lastLogIndex/lastLogTerm and is
  granted only to a candidate whose log is at least as up to date.
- **Replication** rides the leader's pulse: per-peer nextIndex and
  matchIndex, conflict backoff, commit on a majority's match of an entry
  of the current term only, and a snapshot for a peer behind the
  compaction horizon.
- **The lease.**  `lease_valid()` is what a serving path asks: a leader
  that has not heard a majority for `LEASE_PULSES` pulses stops serving
  before any peer can time out and elect another.
- **Transfer** (`transfer_leadership`): a last replication round, then
  `timeout_now` to the chosen peer, which runs its election at once.

Every clock is monotonic.  No lock of this module is held across a call
to a peer, and the loop thread takes `_lock` only for moments.

Wire protocol (JSON over the master's `HttpServer`, admin paths):
  POST /cluster/raft/vote   {term, candidate, lastLogIndex, lastLogTerm}
                            -> {granted, term}
  POST /cluster/raft/append {term, leader, prevLogIndex, prevLogTerm,
                             entries, leaderCommit [, snapshot]}
                            -> {ok, term, matchIndex | conflictIndex}
  POST /cluster/raft/timeout_now {term, leader} -> {ok, term}
It imports no torch.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import uuid
from concurrent.futures import (TimeoutError as FuturesTimeout,
                                ThreadPoolExecutor, as_completed)

from .httpd import HttpServer, Request, http_json
from ..util import wlog


FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# log entries kept beyond the snapshot before compacting again
SNAPSHOT_THRESHOLD = 512


class RaftLog:
    """The log in memory, with JSONL persistence and a snapshot under
    `data_dir`.  Indexes are 1-based (0 is "before the log"); `start` is
    the index of entries[0], the snapshot's last index plus one."""

    def __init__(self, data_dir: "str | None" = None):
        self.dir = data_dir
        self.entries: list[dict] = []
        self.snap_index = 0
        self.snap_term = 0
        self.snap_fsm: dict = {}
        self._f = None
        self._torn_tail = False
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            self._load()
            if self._torn_tail:
                # the recovered prefix first: an entry appended after a
                # torn line would be lost by the next replay
                self._rewrite()
            else:
                self._f = open(self._log_path(), "a")

    def _log_path(self) -> str:
        return os.path.join(self.dir, "raft.log")

    def _snap_path(self) -> str:
        return os.path.join(self.dir, "raft.snap")

    def _load(self) -> None:
        try:
            with open(self._snap_path()) as f:
                snap = json.load(f)
            self.snap_index = int(snap["lastIndex"])
            self.snap_term = int(snap["lastTerm"])
            self.snap_fsm = snap["fsm"]
        except (OSError, ValueError, KeyError):
            pass
        try:
            with open(self._log_path()) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        e = json.loads(line)
                    except ValueError:
                        self._torn_tail = True
                        break       # a torn write: drop the rest
                    idx = int(e.get("index", 0))
                    if idx <= self.snap_index:
                        continue    # inside the snapshot
                    # a truncation rewrite may repeat an index: the
                    # latest occurrence wins
                    pos = idx - self.snap_index - 1
                    if pos < len(self.entries):
                        del self.entries[pos:]
                    self.entries.append(e)
        except OSError:
            pass

    @property
    def start(self) -> int:
        return self.snap_index + 1

    def last_index(self) -> int:
        return self.snap_index + len(self.entries)

    def last_term(self) -> int:
        if self.entries:
            return int(self.entries[-1]["term"])
        return self.snap_term

    def term_at(self, index: int) -> "int | None":
        """The term of entry `index` (the snapshot's boundary included);
        None when compacted away or past the end."""
        if index == 0:
            return 0
        if index == self.snap_index:
            return self.snap_term
        pos = index - self.start
        if 0 <= pos < len(self.entries):
            return int(self.entries[pos]["term"])
        return None

    def entry(self, index: int) -> "dict | None":
        pos = index - self.start
        if 0 <= pos < len(self.entries):
            return self.entries[pos]
        return None

    def slice_from(self, index: int) -> list[dict]:
        return self.entries[max(0, index - self.start):]

    def append(self, entries: list[dict]) -> None:
        self.entries.extend(entries)
        if self._f is not None:
            for e in entries:
                self._f.write(json.dumps(e) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def truncate_from(self, index: int) -> None:
        """Drop the entries from `index` on (a conflict)."""
        pos = index - self.start
        if pos < len(self.entries):
            del self.entries[max(pos, 0):]
            self._rewrite()

    def install_snapshot(self, last_index: int, last_term: int,
                         fsm: dict) -> None:
        self.snap_index = last_index
        self.snap_term = last_term
        self.snap_fsm = dict(fsm)
        self.entries = []
        self._persist_snapshot()
        self._rewrite()

    def compact(self, applied_index: int, fsm: dict) -> None:
        """Fold the entries up to `applied_index` into the snapshot."""
        if applied_index <= self.snap_index:
            return
        term = self.term_at(applied_index)
        if term is None:
            return
        keep = self.slice_from(applied_index + 1)
        self.snap_index = applied_index
        self.snap_term = term
        self.snap_fsm = dict(fsm)
        self.entries = list(keep)
        self._persist_snapshot()
        self._rewrite()

    def _persist_snapshot(self) -> None:
        if not self.dir:
            return
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"lastIndex": self.snap_index,
                       "lastTerm": self.snap_term,
                       "fsm": self.snap_fsm}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path())

    def _rewrite(self) -> None:
        if not self.dir:
            return
        if self._f is not None:
            self._f.close()
        tmp = self._log_path() + ".tmp"
        with open(tmp, "w") as f:
            for e in self.entries:
                f.write(json.dumps(e) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path())
        self._f = open(self._log_path(), "a")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class RaftNode:
    # The leader's lease in pulses: strictly below the least election
    # timeout (4 pulses), so a leader cut off from the quorum stops
    # serving before a peer on the majority side can begin an election
    # (hashicorp/raft LeaderLeaseTimeout < ElectionTimeout).
    LEASE_PULSES = 3

    def __init__(self, http: HttpServer, self_url: str,
                 peers: "list[str] | None" = None,
                 pulse_seconds: float = 0.25,
                 on_leadership=None, auth_headers=None,
                 data_dir: "str | None" = None, on_apply=None,
                 on_leader=None):
        """`peers` names every master of the set (this one included, in
        any order); none means a set of one, its own leader at start.
        `auth_headers()` gives the headers of a peer call (the pooled
        client attaches the process's admin JWT to these admin paths by
        itself).  `on_apply(key, value)` runs, off the lock, for every
        committed entry; `on_leadership(bool)` on a change of role, and
        `on_leader(url)` when a follower hears of a new leader."""
        self.self_url = self_url
        self.peers = sorted(set(peers or []) | {self_url})
        self.pulse = pulse_seconds
        self.on_leadership = on_leadership
        self.on_apply = on_apply
        self.on_leader = on_leader
        self._auth_headers = auth_headers or (lambda: {})
        self.state = FOLLOWER
        self.term = 0
        self.voted_for: "str | None" = None
        self.leader = ""
        self.topology_id = ""
        self.data_dir = data_dir
        self.log = RaftLog(data_dir)
        self.commit_index = self.log.snap_index
        self.applied_index = self.log.snap_index
        self.fsm: dict = dict(self.log.snap_fsm)
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        # peers with an append in flight: one at a time a peer
        self._inflight: "set[str]" = set()
        # each peer's newest acked append, by its dispatch time
        self._acked_at: "dict[str, float]" = {}
        self._commit_cv = threading.Condition()
        self._last_heard = time.monotonic()
        self._last_quorum = time.monotonic()
        # when this node last became leader (monotonic; 0: never)
        self.leader_since = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=max(4, len(self.peers)),
                                        thread_name_prefix="raft")
        self._thread: "threading.Thread | None" = None
        if data_dir:
            with self._lock:
                self._load_state()
        with self._lock:
            self._apply_committed_locked()
        http.route("POST", "/cluster/raft/vote", self._handle_vote)
        http.route("POST", "/cluster/raft/append", self._handle_append)
        http.route("POST", "/cluster/raft/timeout_now",
                   self._handle_timeout_now)

    def set_peers(self, peers: "list[str]") -> None:
        """The members, before `start` (a set whose listeners were bound
        on port 0 learns its addresses after construction)."""
        with self._lock:
            self.peers = sorted(set(peers) | {self.self_url})

    # -- (term, votedFor) on disk -------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.data_dir, "raft.state")

    def _load_state(self) -> None:
        """The caller holds the lock."""
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
            self.term = int(st.get("term", 0))
            self.voted_for = st.get("votedFor") or None
        except (OSError, ValueError):
            pass

    def _persist_state(self) -> None:
        """The caller holds the lock.  Durable before a vote leaves this
        node: two votes in one term across a restart elect two leaders."""
        if not self.data_dir:
            return
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "votedFor": self.voted_for}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> "RaftNode":
        if len(self.peers) == 1:
            with self._lock:
                self.state = CANDIDATE
            self._try_become_leader(self.term)
        self._thread = threading.Thread(target=self._loop, name="raft",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._commit_cv:
            self._commit_cv.notify_all()
        self._pool.shutdown(wait=False)
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            self.log.close()

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def lease_valid(self) -> bool:
        """True when this node may act as the leader now: what a serving
        path asks, never `is_leader`."""
        if self.state != LEADER:
            return False
        if len(self.peers) == 1:
            return True
        return time.monotonic() - self._last_quorum <= \
            self.LEASE_PULSES * self.pulse

    def majority(self) -> int:
        return len(self.peers) // 2 + 1

    # -- the FSM ------------------------------------------------------------------

    def fsm_get(self, key: str, default=None):
        with self._lock:
            return self.fsm.get(key, default)

    def propose(self, key: str, value, timeout: float = 5.0) -> bool:
        """On the leader: append {key: value}, replicate it and wait for
        its commit.  False when not the leader, when the lease lapses or
        leadership is lost, or on timeout (the entry may still commit
        later)."""
        with self._lock:
            if self.state != LEADER:
                return False
            index = self.log.last_index() + 1
            term = self.term
            self.log.append([{"index": index, "term": term,
                              "key": key, "value": value}])
            self._match_index[self.self_url] = index
            if len(self.peers) == 1:
                self._advance_commit_locked()
        if len(self.peers) > 1:
            self._heartbeat_peers()     # a replication round at once
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.commit_index < index:
                left = deadline - time.monotonic()
                # a leader whose lease lapsed gives up at once: the
                # request that proposed must not outlive its leadership
                if left <= 0 or self._stop.is_set() or \
                        self.term != term or not self.lease_valid():
                    return False
                self._commit_cv.wait(min(left, self.pulse / 4))
        # committed is not enough: a successor may have put its own
        # entry at `index`; ours survived only if the term there is ours
        # (an index folded into the snapshot was committed as it was)
        with self._lock:
            if index <= self.log.snap_index:
                return True
            return self.log.term_at(index) == term

    def _advance_commit_locked(self) -> None:
        """On the leader: commit the highest index of the current term
        that a majority holds (Raft §5.4.2: replicas of older terms do
        not count).  The caller holds the lock."""
        matches = sorted(
            [self._match_index.get(p, 0) if p != self.self_url
             else self.log.last_index() for p in self.peers],
            reverse=True)
        candidate = matches[self.majority() - 1]
        while candidate > self.commit_index:
            if self.log.term_at(candidate) == self.term:
                self.commit_index = candidate
                break
            candidate -= 1
        self._apply_committed_locked()

    def _apply_committed_locked(self) -> None:
        """Apply (applied, commit] to the FSM; the caller holds the lock,
        and the callbacks run on the pool."""
        fired = []
        self.applied_index = max(self.applied_index, self.log.snap_index)
        self.commit_index = max(self.commit_index, self.log.snap_index)
        while self.applied_index < self.commit_index:
            e = self.log.entry(self.applied_index + 1)
            if e is None:
                break
            self.applied_index += 1
            key, value = e.get("key"), e.get("value")
            if key is None:
                continue
            self.fsm[key] = value
            if key == "topologyId":
                self.topology_id = str(value)
            elif key == "peers" and isinstance(value, list) and value:
                # a single-entry configuration change: every node takes
                # the committed view (one left out of it runs on, but
                # cannot win against the new majority)
                self.peers = sorted(set(value))
            fired.append((key, value))
        if len(self.log.entries) > SNAPSHOT_THRESHOLD:
            self.log.compact(self.applied_index, self.fsm)
        with self._commit_cv:
            self._commit_cv.notify_all()
        if fired and self.on_apply is not None and \
                not self._stop.is_set():
            cb = self.on_apply
            try:
                self._pool.submit(lambda: [cb(k, v) for k, v in fired])
            except RuntimeError:
                pass        # the pool shut down: the node is stopping

    # -- the RPC handlers ---------------------------------------------------------

    def _handle_vote(self, req: Request):
        b = req.json()
        term, candidate = int(b["term"]), b["candidate"]
        cand_last_idx = int(b.get("lastLogIndex", 0))
        cand_last_term = int(b.get("lastLogTerm", 0))
        with self._lock:
            if term > self.term:
                self._step_down(term)
            # §5.4.1: only a candidate whose log is at least as up to
            # date as ours
            up_to_date = (cand_last_term, cand_last_idx) >= \
                (self.log.last_term(), self.log.last_index())
            granted = (term == self.term and up_to_date and
                       self.voted_for in (None, candidate))
            if granted:
                self.voted_for = candidate
                self._persist_state()
                self._last_heard = time.monotonic()
            return 200, {"granted": granted, "term": self.term}

    def _handle_append(self, req: Request):
        b = req.json()
        term = int(b["term"])
        with self._lock:
            if term < self.term:
                return 200, {"ok": False, "term": self.term}
            if term > self.term or self.state != FOLLOWER:
                self._step_down(term)
            leader = b.get("leader", "")
            if leader != self.leader and self.on_leader is not None:
                try:
                    self._pool.submit(self.on_leader, leader)
                except RuntimeError:
                    pass
            self.leader = leader
            self._last_heard = time.monotonic()
            snap = b.get("snapshot")
            if snap:
                s_idx = int(snap["lastIndex"])
                s_term = int(snap["lastTerm"])
                # install unless our log already holds the snapshot's
                # last entry: a longer conflicting tail must go, or the
                # same snapshot is refused for ever
                if s_idx > self.log.snap_index and \
                        self.log.term_at(s_idx) != s_term:
                    self.log.install_snapshot(s_idx, s_term, snap["fsm"])
                    self.fsm = dict(snap["fsm"])
                    self.commit_index = self.log.snap_index
                    self.applied_index = self.log.snap_index
                    self.topology_id = str(
                        self.fsm.get("topologyId", self.topology_id))
            prev_idx = int(b.get("prevLogIndex", 0))
            prev_term = int(b.get("prevLogTerm", 0))
            have = self.log.term_at(prev_idx)
            if prev_idx > 0 and have is None:
                # a gap: the leader backs up to our end
                return 200, {"ok": False, "term": self.term,
                             "conflictIndex": self.log.last_index() + 1}
            if prev_idx > self.log.snap_index and have != prev_term:
                # a conflicting history: back up past the bad entry
                return 200, {"ok": False, "term": self.term,
                             "conflictIndex": max(prev_idx,
                                                  self.log.start)}
            match = prev_idx
            for e in b.get("entries", []):
                idx = int(e["index"])
                if idx <= self.log.snap_index:
                    match = max(match, idx)
                    continue
                mine = self.log.term_at(idx)
                if mine is None:
                    self.log.append([e])
                elif mine != int(e["term"]):
                    self.log.truncate_from(idx)
                    self.log.append([e])
                match = idx
            leader_commit = int(b.get("leaderCommit", 0))
            if leader_commit > self.commit_index:
                self.commit_index = min(leader_commit,
                                        self.log.last_index())
                self._apply_committed_locked()
            # the identity rides the FSM; a fresh follower may not hold
            # its entry yet
            if b.get("topologyId"):
                self.topology_id = b["topologyId"]
            return 200, {"ok": True, "term": self.term, "matchIndex": match}

    def _handle_timeout_now(self, req: Request):
        """The leader chose this node as its successor: elect now,
        without waiting out the randomized timeout."""
        b = req.json()
        with self._lock:
            if int(b.get("term", 0)) < self.term or self.state == LEADER:
                return 200, {"ok": False, "term": self.term}
        self._run_election()
        return 200, {"ok": self.state == LEADER, "term": self.term}

    # -- roles --------------------------------------------------------------------

    def _step_down(self, term: int) -> None:
        """The caller holds the lock.  A leader that steps down starts its
        election timer afresh: its last append heard is as old as its
        term, and a stale timer would stand it for election at its next
        pulse, against the successor it has just voted on (the JAX node
        keeps the stale timer)."""
        was_leader = self.state == LEADER
        if term != self.term:
            self.term = term
            self.voted_for = None
            self._persist_state()
        self.state = FOLLOWER
        if was_leader:
            self._last_heard = time.monotonic()
        if was_leader and self.on_leadership is not None:
            try:
                self._pool.submit(self.on_leadership, False)
            except RuntimeError:
                pass

    def _try_become_leader(self, term: int) -> bool:
        """Promote only if still the candidate of `term`: an append of a
        higher term racing the vote count wins."""
        with self._lock:
            if self.state != CANDIDATE or self.term != term:
                return False
            self.state = LEADER
            self.leader = self.self_url
            self.leader_since = time.monotonic()
            last = self.log.last_index()
            for p in self.peers:
                self._next_index[p] = last + 1
                self._match_index[p] = 0
            self._acked_at = {}
            self._last_quorum = time.monotonic()
            # the replicated identity survives restarts and failovers; a
            # new one is minted only for a new set, and proposed through
            # the log by the leadership callback
            if not self.topology_id:
                self.topology_id = str(self.fsm.get("topologyId", "")) or \
                    f"{self.term}-{uuid.uuid4().hex[:8]}"
        if self.on_leadership is not None:
            self.on_leadership(True)
        return True

    def transfer_leadership(self, target: str = "") -> bool:
        """Hand leadership over (raft §3.10, TimeoutNow): one more
        replication round so the successor's log is current, `timeout_now`
        to it (the named `target`, else the peer with the highest match),
        then step down with the election timer reset.  With no peer
        taking the nudge it is a plain step-down."""
        with self._lock:
            if self.state != LEADER:
                return False
            term = self.term
            candidates = [p for p in self.peers if p != self.self_url]
            if target and target in candidates:
                candidates = [target]
            else:
                candidates.sort(key=lambda p: -self._match_index.get(p, 0))
        if candidates:
            self._heartbeat_peers()
        nudged = False
        for peer in candidates:
            try:
                r = http_json("POST", f"{peer}/cluster/raft/timeout_now",
                              {"term": term, "leader": self.self_url},
                              3.0, self._auth_headers())
            except OSError:
                continue
            if r.get("ok"):
                nudged = True
                break
        if not nudged and candidates:
            wlog.warning("leader transfer: no peer took timeout_now; "
                         "stepping down")
        with self._lock:
            if self.state != LEADER:
                return True
            self._step_down(self.term)
        return True

    def _election_timeout(self) -> float:
        return random.uniform(4, 8) * self.pulse

    def _loop(self) -> None:
        timeout = self._election_timeout()
        while not self._stop.wait(self.pulse):
            if self.state == LEADER:
                self._heartbeat_peers()
            elif time.monotonic() - self._last_heard > timeout:
                timeout = self._election_timeout()
                self._run_election()

    def _run_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.term += 1
            self.voted_for = self.self_url
            self._persist_state()
            term = self.term
            last_idx = self.log.last_index()
            last_term = self.log.last_term()
            # a split vote waits out a fresh randomized timeout
            self._last_heard = time.monotonic()
            peers = [p for p in self.peers if p != self.self_url]
        votes = 1
        try:
            futs = [self._pool.submit(
                http_json, "POST", f"{p}/cluster/raft/vote",
                {"term": term, "candidate": self.self_url,
                 "lastLogIndex": last_idx, "lastLogTerm": last_term},
                self._rpc_timeout(), self._auth_headers()) for p in peers]
        except RuntimeError:
            return          # the pool shut down: stopping
        try:
            for f in as_completed(futs, timeout=self._rpc_timeout() + 1):
                try:
                    r = f.result()
                except (OSError, ValueError):
                    continue            # a peer down or a bad answer
                if int(r.get("term", 0)) > term:
                    with self._lock:
                        self._step_down(int(r["term"]))
                    return
                if r.get("granted"):
                    votes += 1
        except (TimeoutError, FuturesTimeout):
            pass
        if votes >= self.majority() and self._try_become_leader(term):
            self._heartbeat_peers()

    def _rpc_timeout(self) -> float:
        """A peer call's timeout: well under the lease."""
        return max(0.5, 2 * self.pulse)

    def _peer_payload(self, peer: str, term: int) -> dict:
        """The caller holds the lock: the append for `peer`'s nextIndex
        (a batch of entries, or the snapshot when the peer is behind the
        compaction horizon)."""
        next_idx = self._next_index.get(peer, self.log.last_index() + 1)
        payload = {"term": term, "leader": self.self_url,
                   "leaderCommit": self.commit_index,
                   "topologyId": self.topology_id}
        if next_idx < self.log.start:
            payload["snapshot"] = {"lastIndex": self.log.snap_index,
                                   "lastTerm": self.log.snap_term,
                                   "fsm": self.log.snap_fsm}
            next_idx = self.log.start
        prev = next_idx - 1
        payload["prevLogIndex"] = prev
        payload["prevLogTerm"] = self.log.term_at(prev) or 0
        payload["entries"] = self.log.slice_from(next_idx)[:256]
        return payload

    def _heartbeat_peers(self) -> None:
        """One replication round: an append to each peer that has none in
        flight.  It returns once a majority has acked (the lease then
        runs from the round's dispatch: a follower restarts its timer at
        receipt, after it, so dispatch + lease < receipt + the least
        election timeout), once every peer has answered, or after the
        call timeout.  A straggler's answer is handled when it comes, and
        its peer gets no second append meanwhile: a peer that hangs holds
        one pool thread and never delays the lease.  A leader that has
        not heard a majority for the lease steps down, so a split never
        serves on both sides."""
        round_start = time.monotonic()
        with self._lock:
            if self.state != LEADER:
                return
            term = self.term
            if self.majority() <= 1:
                self._last_quorum = round_start
            peers = [p for p in self.peers
                     if p != self.self_url and p not in self._inflight]
        rnd = _Round(len(peers))
        for p in peers:
            self._send_append(p, term, rnd)
        rnd.done.wait(self._rpc_timeout() + 1)
        with self._lock:
            if self.state == LEADER and self.term == term and \
                    time.monotonic() - self._last_quorum > \
                    self.LEASE_PULSES * self.pulse:
                self._step_down(self.term)

    def _send_append(self, peer: str, term: int,
                     rnd: "_Round | None") -> None:
        with self._lock:
            if self.state != LEADER or self.term != term or \
                    peer in self._inflight:
                if rnd is not None:
                    rnd.answered(False, self.majority())
                return
            payload = self._peer_payload(peer, term)
            self._inflight.add(peer)
        dispatched = time.monotonic()
        try:
            fut = self._pool.submit(
                http_json, "POST", f"{peer}/cluster/raft/append", payload,
                self._rpc_timeout(), self._auth_headers())
        except RuntimeError:            # the pool shut down: stopping
            with self._lock:
                self._inflight.discard(peer)
            if rnd is not None:
                rnd.done.set()
            return
        fut.add_done_callback(lambda f: self._append_done(
            peer, term, dispatched, rnd, f))

    def _append_done(self, peer: str, term: int, dispatched: float,
                     rnd: "_Round | None", fut) -> None:
        try:
            r = fut.result()
        except Exception:   # noqa: BLE001 — a peer down: no ack
            r = None
        more = False
        with self._lock:
            self._inflight.discard(peer)
            acked = False
            if r is not None and int(r.get("term", 0)) > self.term:
                self._step_down(int(r["term"]))
            elif r is not None and self.state == LEADER and \
                    self.term == term:
                if r.get("ok"):
                    acked = True
                    self._note_ack_locked(peer, dispatched)
                    match = int(r.get("matchIndex", 0))
                    if match > self._match_index.get(peer, 0):
                        self._match_index[peer] = match
                    self._next_index[peer] = match + 1
                    self._advance_commit_locked()
                elif "conflictIndex" in r:
                    self._next_index[peer] = max(1, int(r["conflictIndex"]))
                # entries still to send (a proposal while this append
                # flew, a conflict's backoff): at once, not a pulse later
                more = self._next_index.get(peer, 0) <= \
                    self.log.last_index()
            if rnd is not None:
                rnd.answered(acked, self.majority())
        if more and not self._stop.is_set():
            self._send_append(peer, term, None)

    def _note_ack_locked(self, peer: str, dispatched: float) -> None:
        """The lease runs from the dispatch of the newest append that a
        majority (this node included) has acked."""
        self._acked_at[peer] = max(self._acked_at.get(peer, 0.0),
                                   dispatched)
        times = sorted((self._acked_at.get(p, 0.0) for p in self.peers
                        if p != self.self_url), reverse=True)
        need = self.majority() - 1          # this node's own vote
        if need <= 0:
            return
        if len(times) >= need:
            self._last_quorum = max(self._last_quorum, times[need - 1])


class _Round:
    """The acks of one replication round; `done` is set at a majority
    (the leader's own vote counts), or when every peer has answered."""

    def __init__(self, pending: int):
        self.acks = 1
        self.pending = pending
        self.done = threading.Event()
        if pending == 0:
            self.done.set()

    def answered(self, acked: bool, majority: int) -> None:
        """One peer's answer (the caller holds the node's lock)."""
        self.pending -= 1
        self.acks += acked
        if self.acks >= majority or self.pending <= 0:
            self.done.set()
