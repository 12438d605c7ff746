"""SQL-subset evaluation over JSON-lines / CSV byte streams
(weed/query/engine/ — the reference evaluates SELECTs over parquet and
JSON files stored as needles, served by volume_server.proto:132 Query
and s3 SelectObjectContent).

Supported grammar (the core of AWS S3 Select / the reference's
query/engine tests, round 5 widened toward aggregations.go):

    SELECT <* | item[, item...]> FROM s3object
      [WHERE <cond> [AND ...]]
      [GROUP BY col[, col...]]
      [LIMIT <n>] [OFFSET <m>]

    item: col | COUNT(*) | COUNT(col) | SUM(col) | AVG(col)
        | MIN(col) | MAX(col)          (each with optional AS alias)
    cond: col <op> literal | col [NOT] LIKE 'pat' | col IS [NOT] NULL

ops: = != <> < <= > >=      literals: 'str' | number | true | false
LIKE patterns use SQL % / _ wildcards.  Column access supports dotted
paths into nested JSON (a.b.c).

Parquet fast paths (the reference's aggregations.go metadata
shortcuts): COUNT(*) with no WHERE answers from row-group row counts
without reading data; MIN/MAX with no WHERE answer from column
statistics when every row group carries them.

The port's copy of `seaweedfs_tpu/query/engine.py`.
"""

from __future__ import annotations

import csv
import fnmatch
import io
import json
import re


class QueryError(ValueError):
    pass


_SQL_RE = re.compile(
    r"^\s*select\s+(?P<cols>.+?)\s+from\s+s3object\s*"
    r"(?:\s+where\s+(?P<where>.+?))?"
    r"(?:\s+group\s+by\s+(?P<group>[\w.\",\s]+?))?"
    r"(?:\s+limit\s+(?P<limit>\d+))?"
    r"(?:\s+offset\s+(?P<offset>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)

_COND_RE = re.compile(
    r"^\s*(?P<col>[\w.\"]+)\s*(?P<op>=|!=|<>|<=|>=|<|>)\s*"
    r"(?P<val>'(?:[^']|'')*'|[-\w.]+)\s*$")

_LIKE_RE = re.compile(
    r"^\s*(?P<col>[\w.\"]+)\s+(?P<neg>not\s+)?like\s+"
    r"(?P<val>'(?:[^']|'')*')\s*$", re.IGNORECASE)

_NULL_RE = re.compile(
    r"^\s*(?P<col>[\w.\"]+)\s+is\s+(?P<neg>not\s+)?null\s*$",
    re.IGNORECASE)

_AGG_RE = re.compile(
    r"^(?P<fn>count|sum|avg|min|max)\s*\(\s*"
    r"(?P<arg>\*|[\w.\"]+)\s*\)$", re.IGNORECASE)

_AS_RE = re.compile(r"^(?P<expr>.+?)\s+as\s+(?P<alias>[\w.]+)$",
                    re.IGNORECASE)

_OPS = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _split_conjuncts(where: str) -> "list[str]":
    """Split a WHERE clause on AND — but only OUTSIDE single-quoted
    literals ('black and white' must stay one token; '' escapes a
    quote)."""
    parts: list[str] = []
    buf: list[str] = []
    i, n = 0, len(where)
    in_quote = False
    while i < n:
        c = where[i]
        if c == "'":
            if in_quote and i + 1 < n and where[i + 1] == "'":
                buf.append("''")
                i += 2
                continue
            in_quote = not in_quote
            buf.append(c)
            i += 1
            continue
        if not in_quote and where[i:i + 3].lower() == "and" and \
                (i == 0 or where[i - 1].isspace()) and \
                (i + 3 >= n or where[i + 3].isspace()):
            parts.append("".join(buf))
            buf = []
            i += 3
            continue
        buf.append(c)
        i += 1
    parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


def _parse_literal(tok: str):
    if tok.startswith("'"):
        return tok[1:-1].replace("''", "'")
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null":
        return None
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            raise QueryError(f"bad literal {tok!r}")


def _parse_cond(part: str):
    cm = _COND_RE.match(part)
    if cm:
        return (cm.group("col").strip('"'), cm.group("op"),
                _parse_literal(cm.group("val")))
    lm = _LIKE_RE.match(part)
    if lm:
        op = "not like" if lm.group("neg") else "like"
        return (lm.group("col").strip('"'), op,
                _parse_literal(lm.group("val")))
    nm = _NULL_RE.match(part)
    if nm:
        return (nm.group("col").strip('"'),
                "is not null" if nm.group("neg") else "is null",
                None)
    raise QueryError(f"unsupported condition {part!r}")


def _split_select_items(raw: str) -> "list[str]":
    """Split the select list on commas OUTSIDE parentheses (AVG(a),b
    must not split inside the call)."""
    items, buf, depth = [], [], 0
    for c in raw:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if c == "," and depth == 0:
            items.append("".join(buf).strip())
            buf = []
        else:
            buf.append(c)
    items.append("".join(buf).strip())
    return [i for i in items if i]


def parse_sql(sql: str) -> dict:
    m = _SQL_RE.match(sql)
    if not m:
        raise QueryError(f"unsupported SQL: {sql!r}")
    cols_raw = m.group("cols").strip()
    cols: "list | None" = None
    aggs: list = []          # (fn, arg_col_or_None, output_name)
    if cols_raw != "*":
        cols = []
        for item in _split_select_items(cols_raw):
            alias = ""
            am = _AS_RE.match(item)
            if am:
                item, alias = am.group("expr").strip(), \
                    am.group("alias")
            gm = _AGG_RE.match(item)
            if gm:
                fn = gm.group("fn").lower()
                arg = gm.group("arg").strip('"')
                if arg == "*":
                    if fn != "count":
                        raise QueryError(f"{fn}(*) is not valid")
                    arg = None
                aggs.append((fn, arg,
                             alias or f"{fn}({arg or '*'})"))
            else:
                cols.append((item.strip('"'),
                             alias or item.strip('"')))
    conds = [_parse_cond(p)
             for p in _split_conjuncts(m.group("where") or "")]
    group_by = [c.strip().strip('"')
                for c in (m.group("group") or "").split(",")
                if c.strip()]
    if aggs and cols and not group_by:
        raise QueryError("plain columns beside aggregates need "
                         "GROUP BY")
    if group_by and not aggs:
        raise QueryError("GROUP BY needs at least one aggregate")
    if group_by:
        grouped = {c for c, _a in (cols or [])}
        if grouped - set(group_by):
            raise QueryError(
                f"non-grouped columns {sorted(grouped - set(group_by))} "
                "in an aggregate select")
    limit = int(m.group("limit")) if m.group("limit") else None
    offset = int(m.group("offset")) if m.group("offset") else 0
    return {"cols": cols, "aggs": aggs, "group_by": group_by,
            "conds": conds, "limit": limit, "offset": offset}


def _get_path(row: dict, col: str):
    cur = row
    for part in col.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _like_match(got, pattern: str) -> bool:
    """SQL LIKE: % = any run, _ = one char (translated to fnmatch;
    fnmatch's own specials are escaped first)."""
    if not isinstance(got, str):
        got = "" if got is None else str(got)
    out = []
    for ch in pattern:
        if ch == "%":
            out.append("*")
        elif ch == "_":
            out.append("?")
        elif ch in "*?[":
            out.append(f"[{ch}]")      # literal under fnmatch
        else:
            out.append(ch)
    return fnmatch.fnmatchcase(got, "".join(out))


def _matches(row: dict, conds) -> bool:
    for col, op, want in conds:
        got = _get_path(row, col)
        if op == "is null":
            if got is not None:
                return False
            continue
        if op == "is not null":
            if got is None:
                return False
            continue
        if op in ("like", "not like"):
            if got is None:
                return False    # SQL 3VL: NULL satisfies neither
            hit = _like_match(got, want)
            if hit == (op == "not like"):
                return False
            continue
        if got is None and want is not None:
            return False
        # CSV fields arrive as strings; coerce toward the literal type
        if isinstance(want, (int, float)) and isinstance(got, str):
            try:
                got = float(got) if isinstance(want, float) else \
                    int(got)
            except ValueError:
                return False
        try:
            if not _OPS[op](got, want):
                return False
        except TypeError:
            return False
    return True


def _rowgroup_may_match(md_rg, conds) -> bool:
    """Row-group statistics pruning (the reference prunes parquet row
    groups by min/max the same way, query/engine/aggregations.go:40):
    False only when some conjunct PROVABLY matches no row of the
    group.  Missing/typeless stats keep the group."""
    cols = {md_rg.column(i).path_in_schema: md_rg.column(i)
            for i in range(md_rg.num_columns)}
    for col, op, want in conds:
        c = cols.get(col)
        if c is None or not isinstance(want, (int, float)) or \
                isinstance(want, bool):
            continue
        stats = c.statistics
        if stats is None or not stats.has_min_max or \
                not isinstance(stats.min, (int, float)):
            continue
        lo, hi = stats.min, stats.max
        if (op in ("=", "<=", "<") and lo > want) or \
                (op in ("=", ">=", ">") and hi < want) or \
                (op == "<" and lo >= want) or \
                (op == ">" and hi <= want):
            return False
    return True


def _parquet_rows(data: bytes, conds):
    """Parquet scan with row-group pruning; rows surface as plain
    dicts (binary columns decoded latin-1 so predicates on text-ish
    bytes behave)."""
    try:
        import pyarrow.parquet as pq
    except ImportError:  # pragma: no cover
        raise QueryError("parquet support requires pyarrow")
    try:
        pf = pq.ParquetFile(io.BytesIO(data))
    except Exception as e:
        raise QueryError(f"malformed parquet: {e}")
    for rg in range(pf.num_row_groups):
        if not _rowgroup_may_match(pf.metadata.row_group(rg), conds):
            continue
        table = pf.read_row_group(rg)
        for row in table.to_pylist():
            yield {k: (v.decode("latin-1")
                       if isinstance(v, bytes) else v)
                   for k, v in row.items()}


def _rows_from(data: bytes, input_format: str,
               csv_header: bool = True, conds=()):
    if input_format == "parquet":
        yield from _parquet_rows(data, conds)
    elif input_format == "json":
        for line in data.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                raise QueryError("malformed JSON record")
    elif input_format == "csv":
        text = data.decode("utf-8", errors="replace")
        reader = csv.reader(io.StringIO(text))
        rows = iter(reader)
        if csv_header:
            header = next(rows, None)
            if header is None:
                return
            for r in rows:
                yield dict(zip(header, r))
        else:
            for r in rows:
                yield {f"_{i + 1}": v for i, v in enumerate(r)}
    else:
        raise QueryError(f"unsupported input format {input_format!r}")


class _Acc:
    """One aggregate accumulator (aggregations.go state shape)."""

    def __init__(self, fn: str):
        self.fn = fn
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def add(self, val) -> None:
        if self.fn == "count":
            if val is not None:       # COUNT(col) skips nulls;
                self.count += 1       # COUNT(*) feeds a constant
            return
        if val is None:
            return
        if isinstance(val, str):
            # CSV fields arrive as strings: MIN/MAX must compare
            # numerically when the value IS numeric (lexicographic
            # '10' < '9' is wrong); non-numeric strings stay strings
            try:
                val = float(val)
            except ValueError:
                if self.fn in ("sum", "avg"):
                    return
        if self.fn in ("sum", "avg"):
            # only genuine numbers feed the divisor — a dict/list/
            # bool incrementing count would skew AVG
            if isinstance(val, bool) or \
                    not isinstance(val, (int, float)):
                return
            self.count += 1
            self.total += val
            return
        if not isinstance(val, (str, int, float)) or \
                isinstance(val, bool):
            return                       # unorderable for MIN/MAX
        self.count += 1
        try:
            if self.min is None or val < self.min:
                self.min = val
            if self.max is None or val > self.max:
                self.max = val
        except TypeError:
            pass

    def result(self):
        if self.fn == "count":
            return self.count
        if self.fn == "sum":
            return self.total if self.count else None
        if self.fn == "avg":
            return self.total / self.count if self.count else None
        return self.min if self.fn == "min" else self.max


def _parquet_metadata_fastpath(q: dict, data: bytes):
    """aggregations.go metadata shortcuts: COUNT(*) from row-group
    row counts, MIN/MAX from column statistics — no data read.  None
    when the query shape or the file's stats don't allow it."""
    if q["conds"] or q["group_by"] or not q["aggs"] or q["cols"]:
        return None
    try:
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(io.BytesIO(data))
    except Exception:
        return None
    md = pf.metadata
    out = {}
    for fn, arg, name in q["aggs"]:
        if fn == "count" and arg is None:
            out[name] = md.num_rows
            continue
        if fn in ("min", "max") and arg is not None:
            vals = []
            for rg in range(md.num_row_groups):
                col = next(
                    (md.row_group(rg).column(i)
                     for i in range(md.row_group(rg).num_columns)
                     if md.row_group(rg).column(i).path_in_schema
                     == arg), None)
                st = col.statistics if col is not None else None
                if st is None or not st.has_min_max:
                    return None        # stats gap: scan instead
                vals.append(st.min if fn == "min" else st.max)
            if not vals:
                return None
            out[name] = min(vals) if fn == "min" else max(vals)
            continue
        return None                    # SUM/AVG/COUNT(col): scan
    return [out]


def run_query(sql: str, data: bytes, input_format: str = "json",
              csv_header: bool = True) -> "list[dict]":
    """Evaluate; returns the projected rows (aggregate queries return
    one row per group, or a single row without GROUP BY)."""
    q = parse_sql(sql)
    if q["limit"] == 0:
        return []
    if q["aggs"]:
        if input_format == "parquet":
            fast = _parquet_metadata_fastpath(q, data)
            if fast is not None:
                lo = q["offset"]
                hi = None if q["limit"] is None else lo + q["limit"]
                return fast[lo:hi]   # same pagination as the scan
        groups: dict = {}
        for row in _rows_from(data, input_format, csv_header,
                              q["conds"]):
            if not _matches(row, q["conds"]):
                continue
            key = tuple(_get_path(row, c) for c in q["group_by"])
            accs = groups.get(key)
            if accs is None:
                accs = groups[key] = [_Acc(fn)
                                      for fn, _a, _n in q["aggs"]]
            for acc, (fn, arg, _n) in zip(accs, q["aggs"]):
                acc.add(1 if arg is None else _get_path(row, arg))
        if not q["group_by"] and not groups:
            groups[()] = [_Acc(fn) for fn, _a, _n in q["aggs"]]
        out = []
        for key in sorted(groups,
                          key=lambda k: tuple(str(x) for x in k)):
            row_out = {}
            for (col, alias) in (q["cols"] or []):
                row_out[alias] = key[q["group_by"].index(col)]
            for acc, (_fn, _arg, name) in zip(groups[key],
                                              q["aggs"]):
                row_out[name] = acc.result()
            out.append(row_out)
        lo = q["offset"]
        hi = None if q["limit"] is None else lo + q["limit"]
        return out[lo:hi]
    out = []
    skipped = 0
    for row in _rows_from(data, input_format, csv_header,
                          q["conds"]):
        if not _matches(row, q["conds"]):
            continue
        if skipped < q["offset"]:
            skipped += 1
            continue
        if q["cols"] is None:
            out.append(row)
        else:
            out.append({alias: _get_path(row, c)
                        for c, alias in q["cols"]})
        if q["limit"] is not None and len(out) >= q["limit"]:
            break
    return out
