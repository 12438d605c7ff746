"""File-id sequencers (weed/sequence/memory_sequencer.go,
snowflake_sequencer.go; `seaweedfs_tpu/sequence.py`): monotonically
increasing needle keys for the master's `/dir/assign`."""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    """An in-memory counter.  The port's master is a single node with no
    raft log: each heartbeat's `maxFileKey` floors it (`set_max`), so a
    master that restarts never issues a key a volume server holds."""

    # next_file_id(count) reserves [start, start+count): an assign with
    # count=N hands out the base fid, and the client derives the other
    # N-1 keys (the reference's count-assign contract)
    reserves_ranges = True

    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        """Floor the counter above `seen`: next_file_id hands out
        `_counter` itself, so seen == _counter must bump it too
        (memory_sequencer.go's <= rule)."""
        with self._lock:
            if seen >= self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        return self._counter


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit machine id | 12-bit sequence
    (weed/sequence/snowflake_sequencer.go, the sonyflake layout)."""

    EPOCH_MS = 1_577_836_800_000  # 2020-01-01

    # clock-derived ids: count>1 reserves no contiguous range (a derived
    # key+i would collide with the next issued id), so the master grants
    # a count of 1
    reserves_ranges = False

    def __init__(self, machine_id: int = 1):
        if not 0 <= machine_id < 1024:
            raise ValueError("machine id must fit in 10 bits")
        self.machine_id = machine_id
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            now = int(time.time() * 1000)
            if now == self._last_ms:
                self._seq += 1
                if self._seq >= 4096:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000)
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = now
            return (((now - self.EPOCH_MS) & ((1 << 41) - 1)) << 22) | \
                (self.machine_id << 12) | self._seq

    def set_max(self, seen: int) -> None:
        pass  # time-ordered by construction
