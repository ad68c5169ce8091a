"""Row-batch <-> typed-column marshalling, native when it builds.

The port's own copy of ``tensorflowonspark_tpu/recordio/marshal.py``.
The compiled path is the ``_tfos_torch_marshal`` CPython extension
(``native/marshal.c``, built at first use into ``build/torch_native/``
by ``recordio._build``); the numpy path beside it has the same
semantics, is what runs where the extension cannot build (no
``Python.h``) or ``TFOS_NATIVE_MARSHAL=0`` asks for it (read at first
use, nothing built then), and is the plain version the tests hold the
native one against.  The feeder's chunk encoder
(``node._make_chunk_encoder``) calls ``infer_spec`` and
``rows_to_columns``; ``DataFeed`` calls ``columns_to_rows`` to hand
columnar chunks out as rows.

Dtype codes:
  '?' bool  'i' int32  'l' int64  'f' float32  'd' float64  'O' object
  'b' int8  'B' uint8  'h' int16  'H' uint16 (narrow integer columns,
  numpy path only)
A column spec entry is ``(code, width)``: width 0 for scalar columns,
w>0 for fixed-length sequence columns (shape [n, w]).
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import logging
import os
import threading

import numpy as np

from tensorflowonspark_tpu_torch.recordio import _build

logger = logging.getLogger(__name__)

EXT_NAME = "_tfos_torch_marshal"

_ext = None
_ext_tried = False
_ext_lock = threading.Lock()

_CODE_TO_DTYPE = {"?": np.bool_, "i": np.int32, "l": np.int64,
                  "f": np.float32, "d": np.float64,
                  # narrow integer columns (image bytes!): keep the
                  # native dtype on the wire instead of upcasting to
                  # int32 — a 224x224x3 uint8 image must travel as 147KB,
                  # not 588KB
                  "b": np.int8, "B": np.uint8,
                  "h": np.int16, "H": np.uint16}

# codes the C extension's per-element fill loop understands; narrow
# codes deliberately stay on the numpy path — their columns come from
# ndarray rows where one bulk np.asarray copy beats per-element boxing
_EXT_CODES = "?ilfd"

# dtypes the C reconstruction loop (columns_to_rows) can read back —
# exactly the buffer formats its format_code/value_from switch handles
_EXT_OUT_DTYPES = frozenset(
    np.dtype(t) for t in (np.bool_, np.int8, np.int32, np.int64,
                          np.float32, np.float64))


def _load_ext():
    global _ext, _ext_tried
    if _ext_tried:
        return _ext
    with _ext_lock:
        if _ext_tried:
            return _ext
        if os.environ.get("TFOS_NATIVE_MARSHAL", "1") == "0":
            _ext_tried = True
            return None
        try:
            _build.build(["marshal"])
            path = str(_build.lib_path("marshal"))
            loader = importlib.machinery.ExtensionFileLoader(EXT_NAME, path)
            spec = importlib.util.spec_from_loader(EXT_NAME, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _ext = mod
        except (ImportError, OSError, RuntimeError) as e:
            logger.warning("native marshal unavailable (%s): the numpy "
                           "marshal runs", e)
            _ext = None
        _ext_tried = True
    return _ext


def native_available():
    """True when the compiled marshal built and loaded."""
    return _load_ext() is not None


def path_for(spec):
    """``"native"`` or ``"numpy"``: which marshal ``rows_to_columns``
    takes for ``spec`` (narrow and object codes always take numpy)."""
    return ("native" if _load_ext() is not None
            and all(c in _EXT_CODES for c, _ in spec) else "numpy")


def _ndarray_code(dtype):
    """Spec code for a numpy dtype (exact-width for narrow ints so image
    bytes never upcast on the wire; int8 'b' must NOT collide with bool
    '?', uint64 does not fit int64)."""
    if dtype.kind == "b":
        return "?"
    if dtype.kind == "i":
        return {1: "b", 2: "h", 4: "i"}.get(dtype.itemsize, "l")
    if dtype.kind == "u":
        if dtype.itemsize >= 8:
            raise ValueError("uint64 columns do not fit the int64 spec")
        # unsigned widths widen one step only where exactness demands it:
        # uint8 'B' / uint16 'H' are exact; uint32 needs int64
        return {1: "B", 2: "H"}.get(dtype.itemsize, "l")
    if dtype.kind == "f":
        return "f" if dtype.itemsize <= 4 else "d"
    raise ValueError(f"unsupported ndarray dtype {dtype}")


def infer_spec(row):
    """Column spec from one example row (the schema-less path; the CLI's
    schema_hint translates to an explicit spec via schema_to_spec)."""
    spec = []
    for v in row:
        if isinstance(v, (bool, np.bool_)):
            spec.append(("?", 0))
        elif isinstance(v, (int, np.integer)):
            spec.append(("l", 0))
        elif isinstance(v, (float, np.floating)):
            spec.append(("d", 0))
        elif isinstance(v, (bytes, str)):
            spec.append(("O", 0))
        elif isinstance(v, np.ndarray):
            if v.ndim != 1:
                raise ValueError(
                    f"spec supports 1-D array columns, got shape {v.shape}"
                )
            spec.append((_ndarray_code(v.dtype), len(v)))
        elif isinstance(v, (list, tuple)):
            if not v:
                raise ValueError("cannot infer dtype of empty sequence column")
            inner = v[0]
            if isinstance(inner, (bool, np.bool_)):
                spec.append(("?", len(v)))
            elif isinstance(inner, (int, np.integer)):
                spec.append(("l", len(v)))
            elif isinstance(inner, (float, np.floating)):
                spec.append(("d", len(v)))
            elif isinstance(inner, (bytes, str)):
                spec.append(("O", len(v)))
            else:
                raise ValueError(f"unsupported sequence element: {type(inner)}")
        else:
            raise ValueError(f"unsupported column value: {type(v)}")
    return spec


def schema_to_spec(fields, widths=None):
    """(name, dtype_str) pairs (utils.schema parse output) -> spec."""
    m = {"bool": "?", "boolean": "?", "int": "i", "integer": "i",
         "bigint": "l", "long": "l", "float": "f", "double": "d",
         "string": "O", "binary": "O"}
    spec = []
    for i, (name, dt) in enumerate(fields):
        base = dt
        width = 0
        if dt.startswith("array<") and dt.endswith(">"):
            base = dt[6:-1]
            width = (widths or {}).get(name, -1)
        code = m.get(base)
        if code is None:
            raise ValueError(f"unsupported schema type {dt} for {name}")
        spec.append((code, width))
    return spec


def rows_to_columns(rows, spec=None):
    """Batch of row tuples -> tuple of dense per-column arrays.

    Object ('O') columns always take the numpy path (the native layer
    handles the numeric matrix; strings/bytes stay python objects, like
    the reference's byte-string tensors)."""
    rows = list(rows)
    if not rows:
        return ()
    if spec is None:
        spec = infer_spec(rows[0])
    if path_for(spec) == "native":
        return _ext.rows_to_columns(rows, [(c, int(w)) for c, w in spec])
    # numpy fallback (identical semantics)
    for i, r in enumerate(rows):
        if len(r) != len(spec):
            raise ValueError(
                f"row {i} has {len(r)} fields, spec has {len(spec)} columns"
            )
    out = []
    for c, (code, width) in enumerate(spec):
        vals = [r[c] for r in rows]
        if code == "O":
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
        else:
            if code in "?ilbBhH":
                # a spec inferred from an int first row must not silently
                # truncate floats that appear in later rows — reject the
                # lossy cast so callers fall back to the exact row path
                natural = np.asarray(vals)
                if natural.dtype.kind == "f" or (
                    code == "?" and natural.dtype.kind != "b"
                ):
                    raise ValueError(
                        f"column {c}: {natural.dtype} values under spec "
                        f"{code!r} (lossy cast refused)"
                    )
                target = _CODE_TO_DTYPE[code]
                if code != "?" and natural.dtype != np.dtype(target):
                    # narrowing (or sign-crossing) casts are checked by
                    # VALUE range, like the C fill loop's int32 guard
                    info = np.iinfo(target)
                    if (natural > info.max).any() or (natural < info.min).any():
                        raise ValueError(
                            f"column {c}: values overflow the "
                            f"{np.dtype(target).name} spec"
                        )
                arr = natural.astype(target, copy=False)
            else:
                arr = np.asarray(vals, dtype=_CODE_TO_DTYPE[code])
            if width and arr.shape[1:] != (width,):
                raise ValueError(
                    f"column {c}: shape {arr.shape[1:]} != width {width}"
                )
        out.append(arr)
    return tuple(out)


def columns_to_rows(columns):
    """Dense per-column arrays -> list of row tuples.

    1-D columns yield python scalars; 2-D columns yield python lists
    (parity: tensors2batch's scalar-vs-Seq rule, TFModel.scala:121-239).
    """
    columns = [np.ascontiguousarray(a) for a in columns]
    ext = _load_ext()
    if ext is not None and all(
        a.dtype in _EXT_OUT_DTYPES and a.ndim in (1, 2) for a in columns
    ):
        return ext.columns_to_rows(columns)
    n = len(columns[0]) if columns else 0
    cols = []
    for a in columns:
        if a.ndim <= 1:
            cols.append(a.tolist())
        else:
            # per-row nested lists; ndim>2 keeps its nesting (the ext path
            # only handles ndim<=2, so those arrays always land here)
            cols.append([row.tolist() for row in a])
    return [tuple(col[i] for col in cols) for i in range(n)]
