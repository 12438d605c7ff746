"""Elasticsearch-shaped filer store, the port's copy of
`seaweedfs_tpu/filer/elastic_store.py` — the document-DB archetype
(reference: weed/filer/elastic/v7/elastic_store.go: entries become
documents, directories become term filters, listings are sorted
searches).

The client is hand-rolled over the ES JSON-HTTP wire (no ES driver,
the same rule as the RESP client in redis_store.py):

    PUT    /{index}/_doc/{id}            index a document
    GET    /{index}/_doc/{id}            fetch ({"found": bool})
    DELETE /{index}/_doc/{id}
    POST   /{index}/_delete_by_query     {"query": ...}
    POST   /{index}/_search              bool-filter + sort + size
    POST   /{index}/_refresh             make writes searchable

Document model (single index, vs the reference's index-per-top-dir —
one index keeps create/delete of top-level dirs free of index
lifecycle management while serving the same queries):

    _id      urlsafe-b64(full_path)   (ES ids must be path-safe)
    directory  parent directory (exact-match term for listings)
    name       entry name (range/sort key for pagination)
    entry      the full entry JSON

The store is write-through searchable: mutations refresh the index so
a subsequent listing sees them (the filer contract; production ES
would batch refreshes, the reference issues them per write too).
"""

from __future__ import annotations

import base64
import json
import urllib.parse

from ..server.httpd import http_bytes
from .entry import Entry
from .filer_store import FilerStore, normalize_path

INDEX = "seaweedfs_entries"


class ElasticError(RuntimeError):
    pass


class ElasticClient:
    """Minimal ES JSON-HTTP client (driver role)."""

    def __init__(self, address: str):
        self.base = address if address.startswith("http") \
            else f"http://{address}"

    def _req(self, method: str, path: str,
             body: "dict | None" = None,
             ok_404: bool = False) -> dict:
        payload = json.dumps(body).encode() if body is not None \
            else None
        headers = {"Content-Type": "application/json"} \
            if payload else {}
        try:
            st, raw, _ = http_bytes(method, self.base + path,
                                    payload, headers)
        except OSError as e:
            raise ElasticError(f"elastic {self.base}: {e}")
        doc = json.loads(raw) if raw else {}
        if st == 404 and ok_404:
            return doc          # semantic not-found (doc fetch/del)
        if st >= 400:
            # a swallowed 400 (mapping conflict, bad search) would
            # read as "write succeeded" / "directory empty" — every
            # protocol error must surface
            raise ElasticError(f"elastic {method} {path}: {st} "
                               f"{doc}")
        return doc

    def ping(self) -> None:
        self._req("GET", "/")

    def ensure_index(self, idx: str) -> None:
        """Create the index with KEYWORD mappings when absent
        (elastic_store.go CreateIndex): under ES dynamic mapping,
        `directory`/`name` would become analyzed text — term filters
        would tokenize and sort would be refused."""
        try:
            self._req("GET", f"/{idx}")
            return
        except ElasticError:
            pass
        self._req("PUT", f"/{idx}", {
            "mappings": {"properties": {
                "directory": {"type": "keyword"},
                "name": {"type": "keyword"},
                "entry": {"type": "object", "enabled": False},
            }}})

    def index(self, idx: str, doc_id: str, body: dict) -> None:
        self._req("PUT", f"/{idx}/_doc/"
                         f"{urllib.parse.quote(doc_id, safe='')}",
                  body)
        self._req("POST", f"/{idx}/_refresh")

    def get(self, idx: str, doc_id: str) -> "dict | None":
        doc = self._req("GET", f"/{idx}/_doc/"
                               f"{urllib.parse.quote(doc_id, safe='')}",
                        ok_404=True)
        return doc.get("_source") if doc.get("found") else None

    def delete(self, idx: str, doc_id: str) -> None:
        self._req("DELETE", f"/{idx}/_doc/"
                            f"{urllib.parse.quote(doc_id, safe='')}",
                  ok_404=True)
        self._req("POST", f"/{idx}/_refresh")

    def delete_by_query(self, idx: str, query: dict) -> None:
        self._req("POST", f"/{idx}/_delete_by_query",
                  {"query": query})
        self._req("POST", f"/{idx}/_refresh")

    def search(self, idx: str, query: dict, sort: list,
               size: int) -> list:
        doc = self._req("POST", f"/{idx}/_search",
                        {"query": query, "sort": sort, "size": size})
        return [h["_source"]
                for h in doc.get("hits", {}).get("hits", [])]


def _doc_id(path: str) -> str:
    return base64.urlsafe_b64encode(path.encode()).decode()


class ElasticFilerStore(FilerStore):
    """FilerStore over ElasticClient (elastic_store.go shape)."""

    def __init__(self, client: ElasticClient):
        self.es = client
        self.es.ping()
        self.es.ensure_index(INDEX)

    def insert_entry(self, entry: Entry) -> None:
        self.es.index(INDEX, _doc_id(entry.full_path), {
            "directory": entry.parent, "name": entry.name,
            "entry": entry.to_json()})

    update_entry = insert_entry

    def find_entry(self, path: str) -> "Entry | None":
        path = normalize_path(path)
        if path == "/":
            return Entry("/", is_directory=True)
        src = self.es.get(INDEX, _doc_id(path))
        return Entry.from_json(src["entry"]) if src else None

    def delete_entry(self, path: str) -> None:
        self.es.delete(INDEX, _doc_id(normalize_path(path)))

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path).rstrip("/")
        # children at every depth: their directory is the folder
        # itself or starts with "<folder>/" (the reference deletes by
        # directory prefix the same way)
        self.es.delete_by_query(INDEX, {"bool": {"should": [
            {"term": {"directory": path or "/"}},
            {"prefix": {"directory": (path or "") + "/"}},
        ]}})

    def list_directory_entries(self, dir_path: str,
                               start_file: str = "",
                               include_start: bool = False,
                               limit: int = 1000,
                               prefix: str = "") -> "list[Entry]":
        dir_path = normalize_path(dir_path).rstrip("/") or "/"
        filters: list = [{"term": {"directory": dir_path}}]
        if start_file:
            op = "gte" if include_start else "gt"
            filters.append({"range": {"name": {op: start_file}}})
        if prefix:
            filters.append({"prefix": {"name": prefix}})
        hits = self.es.search(
            INDEX, {"bool": {"filter": filters}},
            [{"name": "asc"}], limit)
        return [Entry.from_json(h["entry"]) for h in hits]

    def close(self) -> None:
        pass
