"""Probabilistic skip list, the port's copy of
`seaweedfs_tpu/util/skiplist.py` (reference: weed/util/skiplist — the
ordered map under the reference's name-list directory listings).

Ordered key->value map with O(log n) insert/delete/search and
in-order range scans — the operations the LSM memtable and large
directory listings need.  Deterministic tower heights derive from
the key's hash rather than a RNG: identical trees across restarts
make behavior reproducible under test: the lsm store's memtable, and so
its flushed segments, come out the same in either package.
"""

from __future__ import annotations

import zlib

MAX_LEVEL = 16


class _Node:
    __slots__ = ("key", "value", "forward")

    def __init__(self, key, value, level: int):
        self.key = key
        self.value = value
        self.forward: list = [None] * level


class SkipList:
    def __init__(self):
        self._head = _Node(None, None, MAX_LEVEL)
        self._level = 1
        self._len = 0

    @staticmethod
    def _height_for(key) -> int:
        # deterministic 1/2-decay tower height from a PROCESS-STABLE
        # key digest: the builtin hash() is salted per process for
        # str/bytes (PYTHONHASHSEED); crc32 is unsalted, cheap, and
        # well-mixed enough after the avalanche below
        if isinstance(key, str):
            h = zlib.crc32(key.encode("utf-8", "surrogatepass"))
        elif isinstance(key, (bytes, bytearray)):
            h = zlib.crc32(key)
        else:
            h = hash(key) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h ^= h >> 16
        level = 1
        while (h & 1) and level < MAX_LEVEL:
            level += 1
            h >>= 1
        return level

    def __len__(self) -> int:
        return self._len

    def __contains__(self, key) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def _find_predecessors(self, key):
        update = [self._head] * MAX_LEVEL
        x = self._head
        for i in range(self._level - 1, -1, -1):
            while x.forward[i] is not None and x.forward[i].key < key:
                x = x.forward[i]
            update[i] = x
        return update, x.forward[0]

    def insert(self, key, value) -> None:
        update, nxt = self._find_predecessors(key)
        if nxt is not None and nxt.key == key:
            nxt.value = value
            return
        level = self._height_for(key)
        if level > self._level:
            self._level = level
        node = _Node(key, value, level)
        for i in range(level):
            node.forward[i] = update[i].forward[i]
            update[i].forward[i] = node
        self._len += 1

    def delete(self, key) -> bool:
        update, nxt = self._find_predecessors(key)
        if nxt is None or nxt.key != key:
            return False
        for i in range(len(nxt.forward)):
            if update[i].forward[i] is nxt:
                update[i].forward[i] = nxt.forward[i]
        while self._level > 1 and \
                self._head.forward[self._level - 1] is None:
            self._level -= 1
        self._len -= 1
        return True

    def get(self, key, default=None):
        x = self._head
        for i in range(self._level - 1, -1, -1):
            while x.forward[i] is not None and x.forward[i].key < key:
                x = x.forward[i]
        x = x.forward[0]
        if x is not None and x.key == key:
            return x.value
        return default

    def items(self, start=None, end=None, include_start: bool = True):
        """In-order (key, value) scan over [start, end) — the
        range-read shape directory listings page with."""
        x = self._head
        if start is not None:
            for i in range(self._level - 1, -1, -1):
                while x.forward[i] is not None and \
                        x.forward[i].key < start:
                    x = x.forward[i]
        x = x.forward[0]
        while x is not None:
            if end is not None and x.key >= end:
                return
            if start is None or include_start or x.key != start:
                yield x.key, x.value
            x = x.forward[0]

    def keys(self):
        for k, _v in self.items():
            yield k

    def first(self):
        n = self._head.forward[0]
        return (n.key, n.value) if n is not None else None


_MISSING = object()
