"""The master's volume-location push hub, the port's copy of
`seaweedfs_tpu/server/location_hub.py` (the follow stream's fan-out,
weed/wdclient/masterclient.go:417-471, KeepConnected).  The heartbeat
path publishes each node's volume-set delta, and the master's
`/cluster/watch` long-poll reads it.

Delivery is by cursor over a bounded ring: each event gets the next
sequence number, and a reader asks for the events after its cursor,
getting (events, new cursor, lagged).  A reader further behind than the
ring holds sees lagged=True and must resync from a snapshot.  Cursors
keep delivery gap-free across polls.

Events are plain dicts:
    {"url", "publicUrl", "newVids", "deletedVids",
     "newEcVids", "deletedEcVids"}          a volume location delta
    {"leader": "<url>"}                     a leadership change
"""

from __future__ import annotations

import collections
import threading
import uuid


class LocationHub:
    def __init__(self, capacity: int = 4096):
        # this hub's identity: a cursor means something only to the hub
        # that issued it (each master of a set has its own)
        self.id = uuid.uuid4().hex[:12]
        self._cond = threading.Condition()
        self._log: "collections.deque[tuple[int, dict]]" = \
            collections.deque(maxlen=capacity)
        self._seq = 0

    @property
    def cursor(self) -> int:
        """The sequence number of the latest event (0: none yet).  Read
        it before building a snapshot, so that events published while
        the snapshot is built are replayed after it."""
        with self._cond:
            return self._seq

    def publish(self, event: dict) -> None:
        with self._cond:
            self._seq += 1
            self._log.append((self._seq, event))
            self._cond.notify_all()

    def events_since(self, since: int, timeout: float = 0.0
                     ) -> "tuple[list[dict], int, bool]":
        """(events after `since`, the new cursor, lagged), waiting up to
        `timeout` seconds for the first event.  lagged means the ring no
        longer holds everything after `since`: resync from a snapshot."""
        with self._cond:
            if timeout > 0 and self._seq <= since:
                self._cond.wait_for(lambda: self._seq > since, timeout)
            oldest = self._log[0][0] if self._log else self._seq + 1
            lagged = since + 1 < oldest and self._seq > since
            events = [e for s, e in self._log if s > since]
            return events, self._seq, lagged
