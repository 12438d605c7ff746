"""Filer metadata stores (weed/filer/filerstore.go), the port's copy of
`seaweedfs_tpu/filer/filer_store.py`: an in-memory dict store (tests,
ephemeral filers) and the SQLite store of the abstract_sql family (one
(directory, name)-keyed table, the schema of
filer/abstract_sql/abstract_sql_store.go), the durable default.  The
JAX package's other stores (lsm, redis, elastic, kv) are not ported
(ROADMAP).
"""

from __future__ import annotations

import threading

from .entry import Entry, normalize_path


class FilerStore:
    """Interface: insert/update/find/delete/list, per directory."""

    # durable local stores: a JAX filer with its meta plane on may have
    # left this store a checkpoint behind its metalog, which the port's
    # filer replays at boot (meta_plane.recover_sync)
    supports_meta_plane = False

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def apply_events(self, records: list) -> None:
        """Apply a batch of metalog events (the boot replay of
        meta_plane.recover_sync).  `records` = [(op, new_path, raw_meta,
        new_dict, old_path)] in log order.  The base implementation
        loops the CRUD ops; stores with a transaction boundary
        override to commit the whole batch ONCE."""
        for op, npath, _raw, new, opath in records:
            if npath:
                self.insert_entry(Entry.from_json(new))
            if opath and op in ("delete", "rename") and opath != npath:
                self.delete_entry(opath)

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Entry | None:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, dir_path: str, start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> list[Entry]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStore(FilerStore):
    def __init__(self):
        self._by_dir: dict[str, dict[str, Entry]] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._by_dir.setdefault(entry.parent, {})[entry.name] = entry

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        path = normalize_path(path)
        if path == "/":
            return Entry("/", is_directory=True)
        parent, name = path.rsplit("/", 1)
        with self._lock:
            return self._by_dir.get(parent or "/", {}).get(name)

    def delete_entry(self, path: str) -> None:
        path = normalize_path(path)
        parent, name = path.rsplit("/", 1)
        with self._lock:
            self._by_dir.get(parent or "/", {}).pop(name, None)

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            self._by_dir.pop(path, None)
            for d in [d for d in self._by_dir
                      if d.startswith(path + "/")]:
                self._by_dir.pop(d, None)

    def list_directory_entries(self, dir_path: str, start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> list[Entry]:
        dir_path = normalize_path(dir_path)
        with self._lock:
            names = sorted(self._by_dir.get(dir_path, {}))
            out = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_file:
                    if n < start_file or \
                            (n == start_file and not include_start):
                        continue
                out.append(self._by_dir[dir_path][n])
                if len(out) >= limit:
                    break
            return out


# imported AFTER FilerStore exists (abstract_sql imports it back)
from .abstract_sql import (AbstractSqlStore, SqlDialect,  # noqa: E402
                           SqliteDialect)


class SqliteStore(AbstractSqlStore):
    """abstract_sql-family store: one table keyed (directory, name).
    The always-available engine of the AbstractSqlStore family
    (filer/abstract_sql.py; reference weed/filer/sqlite/ over
    weed/filer/abstract_sql/)."""

    def __init__(self, path: str = ":memory:"):
        dialect = SqliteDialect()
        # file-backed stores get the WAL read plane (per-thread read
        # connections that never block behind the writer); :memory:
        # databases are private per connection, so reads stay on the
        # shared conn under the lock
        read_factory = (lambda: dialect.connect(path)) \
            if path != ":memory:" else None
        super().__init__(dialect.connect(path), dialect,
                         read_factory=read_factory)
        # a :memory: database dies with the process: no checkpoint of a
        # planed run can describe it
        self.supports_meta_plane = path != ":memory:"

    # kept for callers/tests that exercised the escaping directly
    _like_escape = staticmethod(SqlDialect.like_escape)
