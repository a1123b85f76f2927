"""Server-side selection over stored JSON, JSON-lines and CSV objects.

The port's copy of seaweedfs_tpu/query/json_query.py (weed/query/json/
query_json.go and the Query RPC, weed/server/volume_grpc_query.go): the
volume server's ``POST /query`` filters and projects a needle's documents,
so only the matching rows travel back.  A filter is ``{field, operand,
value}``; the input is one JSON document or array, JSON lines, or CSV
with a header row.
"""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Iterator, Optional

OPERANDS = (">", ">=", "<", "<=", "=", "!=", "prefix", "contains")


def dig(doc: Any, dotted: str) -> Any:
    """Path lookup 'a.b.2.c' through dicts and lists (query_json.go's
    gjson-style access, restricted to plain paths)."""
    node = doc
    for part in dotted.split("."):
        if isinstance(node, dict):
            if part not in node:
                return None
            node = node[part]
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return node


def _coerce_pair(a: Any, b: Any) -> tuple[Any, Any]:
    """Compare numerically when both sides look numeric, else as strings."""
    try:
        return float(a), float(b)
    except (TypeError, ValueError):
        return str(a), str(b)


def match_filter(doc: Any, filt: Optional[dict]) -> bool:
    if not filt:
        return True
    field = filt.get("field", "")
    op = filt.get("operand", "=")
    want = filt.get("value")
    got = dig(doc, field) if field else doc
    if op in ("prefix", "contains"):
        if got is None:
            return False
        s, w = str(got), str(want)
        return s.startswith(w) if op == "prefix" else w in s
    if got is None:
        return op == "!=" and want is not None
    a, b = _coerce_pair(got, want)
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    try:
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
    except TypeError:
        return False
    raise ValueError(f"unknown operand {op!r}")


def project(doc: Any, select: Optional[list[str]]) -> Any:
    if not select:
        return doc
    return {path: dig(doc, path) for path in select}


def iter_documents(data: bytes, input_format: str = "json") -> Iterator[Any]:
    """Decode an object's bytes into documents:
    - "json": one document, or a top-level array (one doc per element)
    - "jsonl": one document per line
    - "csv": header row names columns, one dict per data row
    """
    if input_format == "json":
        doc = json.loads(data)
        if isinstance(doc, list):
            yield from doc
        else:
            yield doc
    elif input_format == "jsonl":
        for line in data.splitlines():
            line = line.strip()
            if line:
                yield json.loads(line)
    elif input_format == "csv":
        reader = csv.DictReader(io.StringIO(data.decode()))
        yield from reader
    else:
        raise ValueError(f"unknown input format {input_format!r}")


def execute_query(data: bytes, select: Optional[list[str]] = None,
                  filt: Optional[dict] = None,
                  input_format: str = "json") -> list[Any]:
    """Filter + project one stored object -> matching rows."""
    rows = []
    for doc in iter_documents(data, input_format):
        if match_filter(doc, filt):
            rows.append(project(doc, select))
    return rows
