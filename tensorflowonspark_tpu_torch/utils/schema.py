"""Schema-string parser for the inference CLI's ``--schema_hint``.

An own copy of ``tensorflowonspark_tpu/utils/schema.py``: Spark's
``StructType.simpleString`` grammar, ``struct<name:type,...>`` over base
types and 1-D arrays, mapped onto ``dfutil``'s ``{name: (kind,
is_array)}`` schema dicts (kinds: int64 / float / string / bytes).
"""

from __future__ import annotations

import re

# simpleString base type -> dfutil kind (the reference's widening rules:
# DFUtilTest.scala:95-132 — bool widens to long, binary is bytes)
_BASE_TYPES = {
    "boolean": "int64",
    "tinyint": "int64",
    "smallint": "int64",
    "int": "int64",
    "bigint": "int64",
    "long": "int64",
    "float": "float",
    "double": "float",
    "string": "string",
    "binary": "bytes",
}

_KIND_TO_TYPE = {
    "int64": "bigint",
    "float": "float",
    "string": "string",
    "bytes": "binary",
}

_FIELD_RE = re.compile(
    r"^(?P<name>[A-Za-z_][A-Za-z0-9_]*):"
    r"(?:(?P<array>array<(?P<elem>[a-z]+)>)|(?P<base>[a-z]+))$"
)


class SchemaParseError(ValueError):
    pass


def _split_fields(body):
    """Split on commas at nesting depth 0 (array<...> commas don't occur
    in the 1-D grammar, but be robust to them anyway)."""
    fields, depth, cur = [], 0, []
    for ch in body:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            fields.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        fields.append("".join(cur))
    return fields


def parse_schema(text):
    """``struct<name:type,...>`` -> {name: (kind, is_array)}.

    Accepts the bare field list too (``name:type,...``), matching how the
    reference CLI users pass hints on the command line.
    """
    s = text.strip()
    if s.startswith("struct<"):
        if not s.endswith(">"):
            raise SchemaParseError(f"unbalanced struct<...>: {text!r}")
        s = s[len("struct<"):-1]
    schema = {}
    if not s:
        return schema
    for field in _split_fields(s):
        m = _FIELD_RE.match(field.strip())
        if not m:
            raise SchemaParseError(f"cannot parse field {field!r} in {text!r}")
        base = m.group("elem") or m.group("base")
        if base not in _BASE_TYPES:
            raise SchemaParseError(
                f"unknown type {base!r} in {field!r}; "
                f"expected one of {sorted(_BASE_TYPES)}"
            )
        schema[m.group("name")] = (
            _BASE_TYPES[base], m.group("array") is not None
        )
    return schema


def format_schema(schema):
    """{name: (kind, is_array)} -> ``struct<...>`` simpleString."""
    parts = []
    for name, (kind, is_array) in schema.items():
        t = _KIND_TO_TYPE[kind]
        parts.append(f"{name}:array<{t}>" if is_array else f"{name}:{t}")
    return f"struct<{','.join(parts)}>"


def merge_schemas(inferred, hint):
    """Partial-hint semantics (parity: DFUtil.inferSchema's schemaHint
    :67-110): hinted fields override the inferred kinds; unhinted fields
    keep the inference."""
    merged = dict(inferred)
    merged.update(hint)
    return merged
