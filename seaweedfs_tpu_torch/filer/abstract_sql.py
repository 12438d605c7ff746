"""Abstract-SQL FilerStore family (weed/filer/abstract_sql/
abstract_sql_store.go), the port's copy of
`seaweedfs_tpu/filer/abstract_sql.py`: ONE store implementation over a
DB-API connection + a dialect, the layer that powers the reference's
mysql/mysql2/postgres/postgres2/sqlite stores.  The schema and the rows
are the JAX package's, so a `filer.db` written by either filer opens in
the other.

The schema is the reference's filemeta shape — (directory, name)
primary key with an opaque meta blob — and every query funnels through
the dialect so placeholder style, upsert syntax and LIKE escaping can
vary per engine without touching store logic.

Concrete dialects:
- SqliteDialect — used by filer_store.SqliteStore (the default filer
  store, always available).
- MysqlDialect / PostgresDialect — the reference's `%s`-placeholder
  engines.  No client library is installed, so `connect()` raises with
  guidance; the tests render their SQL.
"""

from __future__ import annotations

import json
import os
import threading

from ..util.group_commit import CommitBarrier
from .entry import Entry, normalize_path
from .filer_store import FilerStore


def sqlite_sync_mode() -> str:
    """SEAWEEDFS_TPU_SQLITE_SYNC: sqlite `PRAGMA synchronous` for
    file-backed stores — "normal" (default; with WAL journaling a
    commit is a write() into the WAL, fsync only at checkpoint: the
    same process-kill durability tier as the volume plane's
    flush-then-ack, losing only a power-loss window), "full" (fsync
    per barrier — the seed's behavior and the bench A/B's off arm),
    or "off"."""
    v = os.environ.get("SEAWEEDFS_TPU_SQLITE_SYNC", "normal").lower()
    return v if v in ("normal", "full", "off") else "normal"


class SqlDialect:
    """Placeholder + syntax hooks (abstract_sql GenSqlInsert etc.)."""

    name = "generic"
    placeholder = "?"

    def create_table_sql(self) -> list[str]:
        return [
            "CREATE TABLE IF NOT EXISTS filemeta ("
            " directory TEXT NOT NULL,"
            " name TEXT NOT NULL,"
            " meta TEXT NOT NULL,"
            " PRIMARY KEY (directory, name))",
        ]

    def upsert_sql(self) -> str:
        p = self.placeholder
        return (f"INSERT OR REPLACE INTO filemeta (directory, name, "
                f"meta) VALUES ({p}, {p}, {p})")

    def find_sql(self) -> str:
        p = self.placeholder
        return ("SELECT meta FROM filemeta WHERE directory=" + p +
                " AND name=" + p)

    def delete_sql(self) -> str:
        p = self.placeholder
        return ("DELETE FROM filemeta WHERE directory=" + p +
                " AND name=" + p)

    def delete_tree_sql(self) -> str:
        p = self.placeholder
        return ("DELETE FROM filemeta WHERE directory=" + p +
                r" OR directory LIKE " + p + r" ESCAPE '\'")

    def list_sql(self, include_start: bool, prefix: bool) -> str:
        p = self.placeholder
        op = ">=" if include_start else ">"
        q = ("SELECT meta FROM filemeta WHERE directory=" + p +
             f" AND name {op} " + p + " ")
        if prefix:
            q += r"AND name LIKE " + p + r" ESCAPE '\' "
        q += "ORDER BY name LIMIT " + p
        return q

    @staticmethod
    def like_escape(s: str) -> str:
        r"""Escape LIKE wildcards; every LIKE uses ESCAPE '\'."""
        return s.replace("\\", "\\\\").replace("%", r"\%") \
                .replace("_", r"\_")

    def connect(self, **kw):
        raise NotImplementedError


class SqliteDialect(SqlDialect):
    name = "sqlite"

    def connect(self, path: str = ":memory:", **kw):
        import sqlite3
        conn = sqlite3.connect(path, check_same_thread=False)
        if path != ":memory:":
            # WAL journaling: a commit appends to the write-ahead log
            # instead of the rollback journal's two fsyncs a
            # transaction, and dedicated READ connections run without
            # blocking behind the writer (AbstractSqlStore._read_conn).
            # synchronous level per sqlite_sync_mode().
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute(
                f"PRAGMA synchronous={sqlite_sync_mode().upper()}")
            conn.execute("PRAGMA busy_timeout=5000")
        return conn


class MysqlDialect(SqlDialect):
    name = "mysql"
    placeholder = "%s"

    def create_table_sql(self) -> list[str]:
        return [
            "CREATE TABLE IF NOT EXISTS filemeta ("
            " directory VARCHAR(512) NOT NULL,"
            " name VARCHAR(512) NOT NULL,"
            " meta LONGTEXT NOT NULL,"
            " PRIMARY KEY (directory, name))",
        ]

    def upsert_sql(self) -> str:
        return ("INSERT INTO filemeta (directory, name, meta) "
                "VALUES (%s, %s, %s) "
                "ON DUPLICATE KEY UPDATE meta=VALUES(meta)")

    def connect(self, **kw):
        raise NotImplementedError(
            "no mysql client library is installed; point an "
            "AbstractSqlStore at a DB-API connection from "
            "mysql-connector/PyMySQL where available")


class PostgresDialect(SqlDialect):
    name = "postgres"
    placeholder = "%s"

    def upsert_sql(self) -> str:
        return ("INSERT INTO filemeta (directory, name, meta) "
                "VALUES (%s, %s, %s) "
                "ON CONFLICT (directory, name) "
                "DO UPDATE SET meta=EXCLUDED.meta")

    def connect(self, **kw):
        raise NotImplementedError(
            "no postgres client library is installed; point an "
            "AbstractSqlStore at a DB-API connection from psycopg "
            "where available")


class AbstractSqlStore(FilerStore):
    """The single store body shared by every SQL engine.

    Mutations are GROUP-COMMITTED: each writer executes its statement
    under the store lock (cheap — the rows land in the connection's
    open transaction), then meets the shared barrier, where one leader
    runs `commit()` once for the whole batch.  Ack semantics are
    unchanged (a mutation returns only after a commit that covers it);
    the per-writer transaction fsync/write is amortized across every
    concurrent writer — classic database group commit.  Reads on the
    same connection see the open transaction, so a writer's own
    find_entry is never stale."""

    def __init__(self, conn, dialect: "SqlDialect | None" = None,
                 read_factory=None):
        self._db = conn
        self.dialect = dialect or SqliteDialect()
        self._lock = threading.RLock()
        self._barrier = CommitBarrier(self._group_commit_flush,
                                      site="filer.store")
        # WAL read plane: when the engine supports concurrent readers
        # (sqlite WAL, any server engine), each reader thread gets its
        # OWN connection and never touches the write lock, so find_entry
        # threads do not pile up behind writers' execute/commit windows.
        # Readers see the last COMMITTED state, which is exactly the ack
        # contract (a mutation is visible to others only once its
        # barrier commit has made it durable).  None = reads share the
        # write connection under the lock (the :memory: store).
        self._read_factory = read_factory
        self._read_local = threading.local()
        with self._lock:
            for stmt in self.dialect.create_table_sql():
                self._db.execute(stmt)
            self._db.commit()

    def _read_conn(self):
        if self._read_factory is None:
            return None
        conn = getattr(self._read_local, "conn", None)
        if conn is None:
            conn = self._read_local.conn = self._read_factory()
        return conn

    def _group_commit_flush(self) -> None:
        """Designated barrier helper: one commit covering every
        statement executed so far (CommitBarrier serializes leaders)."""
        with self._lock:
            self._db.commit()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._db.execute(
                self.dialect.upsert_sql(),
                (entry.parent, entry.name,
                 json.dumps(entry.to_json())))
        self._barrier.commit()

    update_entry = insert_entry

    def apply_events(self, records: list) -> None:
        """Apply a batch of metalog events in ONE transaction, ONE
        commit (meta_plane.recover_sync's boot replay).  Upserts reuse
        the exact entry bytes the WAL line carries (`raw`).  Consecutive
        upserts run through `executemany` (the statement compiles
        once and the rows loop in C); the ordered flush before each
        delete preserves per-path apply order."""
        if not records:
            return
        up = self.dialect.upsert_sql()
        dele = self.dialect.delete_sql()
        rows: list = []
        with self._lock:
            for op, npath, raw, new, opath in records:
                if npath:
                    parent, _, name = npath.rpartition("/")
                    rows.append((parent or "/", name,
                                 raw if raw is not None
                                 else json.dumps(new)))
                if opath and op in ("delete", "rename") and \
                        opath != npath:
                    if rows:
                        self._db.executemany(up, rows)
                        rows = []
                    parent, _, name = opath.rpartition("/")
                    self._db.execute(dele, (parent or "/", name))
            if rows:
                self._db.executemany(up, rows)
            self._db.commit()

    def find_entry(self, path: str) -> "Entry | None":
        path = normalize_path(path)
        if path == "/":
            return Entry("/", is_directory=True)
        parent, name = path.rsplit("/", 1)
        rc = self._read_conn()
        if rc is not None:
            row = rc.execute(self.dialect.find_sql(),
                             (parent or "/", name)).fetchone()
        else:
            with self._lock:
                row = self._db.execute(
                    self.dialect.find_sql(),
                    (parent or "/", name)).fetchone()
        return Entry.from_json(json.loads(row[0])) if row else None

    def delete_entry(self, path: str) -> None:
        path = normalize_path(path)
        parent, name = path.rsplit("/", 1)
        with self._lock:
            self._db.execute(self.dialect.delete_sql(),
                             (parent or "/", name))
        self._barrier.commit()

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            self._db.execute(
                self.dialect.delete_tree_sql(),
                (path, self.dialect.like_escape(path) + "/%"))
        self._barrier.commit()

    def list_directory_entries(self, dir_path: str,
                               start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> list[Entry]:
        dir_path = normalize_path(dir_path)
        args: list = [dir_path, start_file]
        if prefix:
            args.append(self.dialect.like_escape(prefix) + "%")
        args.append(limit)
        rc = self._read_conn()
        if rc is not None:
            rows = rc.execute(
                self.dialect.list_sql(include_start, bool(prefix)),
                args).fetchall()
        else:
            with self._lock:
                rows = self._db.execute(
                    self.dialect.list_sql(include_start, bool(prefix)),
                    args).fetchall()
        return [Entry.from_json(json.loads(r[0])) for r in rows]

    def close(self) -> None:
        with self._lock:
            try:
                # sqlite rolls an open transaction back on close; any
                # rows here belong to mutations that already passed
                # (or are about to pass) the barrier — commit them
                self._db.commit()
            except Exception:  # noqa: BLE001 — the DB-API error base
                pass           # varies per engine; teardown must finish
            self._db.close()
