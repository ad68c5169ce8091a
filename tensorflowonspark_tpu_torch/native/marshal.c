/* Row-batch <-> typed-column marshalling (CPython extension).
 *
 * The port's own copy of the JAX package's marshal: the per-dtype
 * conversion between a batch of row tuples and dense per-column buffers
 * runs in compiled code, not the Python interpreter.  The feeder uses it
 * to turn numeric row chunks into columnar chunks.
 *
 * Exposed as module `_tfos_torch_marshal` (its own name, so that it never
 * shadows the JAX package's `_tfos_marshal` in sys.modules):
 *   rows_to_columns(rows, spec) -> tuple of numpy arrays
 *     rows: sequence of row tuples/lists (all the same arity)
 *     spec: sequence of (dtype_char, width) per column:
 *       '?' bool, 'i' int32, 'l' int64, 'f' float32, 'd' float64
 *       width 0 -> scalar column (result shape [n]);
 *       width w>0 -> fixed-length sequence column (result shape [n, w])
 *   columns_to_rows(columns) -> list of row tuples
 *     columns: sequence of C-contiguous numpy arrays, 1-D (scalar per
 *     row) or 2-D (python list per row) — mirroring tensors2batch's
 *     "size>1 becomes a Seq" rule.
 *
 * Arrays are allocated by calling back into numpy (np.empty) and filled
 * through the buffer protocol, so no numpy C headers are needed at
 * build time.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static PyObject *np_empty = NULL; /* numpy.empty */

static PyObject *make_array(Py_ssize_t n, Py_ssize_t width, char code) {
  char dtype[3] = {code, 0, 0};
  PyObject *shape, *args, *kw, *arr, *dt;
  if (width > 0)
    shape = Py_BuildValue("(nn)", n, width);
  else
    shape = Py_BuildValue("(n)", n);
  if (!shape) return NULL;
  dt = PyUnicode_FromString(dtype);
  if (!dt) { Py_DECREF(shape); return NULL; }
  args = PyTuple_Pack(2, shape, dt);
  Py_DECREF(shape);
  Py_DECREF(dt);
  if (!args) return NULL;
  kw = NULL;
  arr = PyObject_Call(np_empty, args, kw);
  Py_DECREF(args);
  return arr;
}

static int fill_value(char code, char *dst, Py_ssize_t idx, PyObject *v) {
  switch (code) {
    case '?': {
      /* only genuine bools (python bool or numpy.bool_): truthiness of
       * an int/float here would be a silent lossy cast (2 -> True) the
       * row path never performs */
      const char *tn = Py_TYPE(v)->tp_name;
      if (!PyBool_Check(v) && strcmp(tn, "numpy.bool_") != 0 &&
          strcmp(tn, "numpy.bool") != 0) {
        PyErr_SetString(PyExc_TypeError, "bool column requires bool values");
        return -1;
      }
      int b = PyObject_IsTrue(v);
      if (b < 0) return -1;
      ((unsigned char *)dst)[idx] = (unsigned char)b;
      return 0;
    }
    case 'i': {
      long long x = PyLong_AsLongLong(v);
      if (x == -1 && PyErr_Occurred()) return -1;
      if (x > 2147483647LL || x < -2147483648LL) {
        PyErr_SetString(PyExc_OverflowError,
                        "value overflows the int32 column spec");
        return -1;
      }
      ((int *)dst)[idx] = (int)x;
      return 0;
    }
    case 'l': {
      long long x = PyLong_AsLongLong(v);
      if (x == -1 && PyErr_Occurred()) return -1;
      ((long long *)dst)[idx] = x;
      return 0;
    }
    case 'f': {
      double x = PyFloat_AsDouble(v);
      if (x == -1.0 && PyErr_Occurred()) return -1;
      ((float *)dst)[idx] = (float)x;
      return 0;
    }
    case 'd': {
      double x = PyFloat_AsDouble(v);
      if (x == -1.0 && PyErr_Occurred()) return -1;
      ((double *)dst)[idx] = x;
      return 0;
    }
    default:
      PyErr_Format(PyExc_ValueError, "unsupported dtype code '%c'", code);
      return -1;
  }
}

static PyObject *rows_to_columns(PyObject *self, PyObject *args) {
  PyObject *rows_obj, *spec_obj;
  if (!PyArg_ParseTuple(args, "OO", &rows_obj, &spec_obj)) return NULL;

  PyObject *rows = PySequence_Fast(rows_obj, "rows must be a sequence");
  if (!rows) return NULL;
  PyObject *spec = PySequence_Fast(spec_obj, "spec must be a sequence");
  if (!spec) { Py_DECREF(rows); return NULL; }

  Py_ssize_t n = PySequence_Fast_GET_SIZE(rows);
  Py_ssize_t ncols = PySequence_Fast_GET_SIZE(spec);

  PyObject *out = PyTuple_New(ncols);
  Py_buffer *bufs = PyMem_Calloc(ncols, sizeof(Py_buffer));
  char *codes = PyMem_Calloc(ncols, 1);
  Py_ssize_t *widths = PyMem_Calloc(ncols, sizeof(Py_ssize_t));
  int ok = (out && bufs && codes && widths);

  for (Py_ssize_t c = 0; ok && c < ncols; c++) {
    PyObject *entry = PySequence_Fast_GET_ITEM(spec, c);
    const char *code_s;
    Py_ssize_t w;
    if (!PyArg_ParseTuple(entry, "sn", &code_s, &w)) { ok = 0; break; }
    codes[c] = code_s[0];
    widths[c] = w;
    PyObject *arr = make_array(n, w, codes[c]);
    if (!arr) { ok = 0; break; }
    PyTuple_SET_ITEM(out, c, arr); /* steals ref */
    if (PyObject_GetBuffer(arr, &bufs[c], PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
      ok = 0;
      break;
    }
  }

  for (Py_ssize_t r = 0; ok && r < n; r++) {
    PyObject *row = PySequence_Fast_GET_ITEM(rows, r);
    PyObject *rowf = PySequence_Fast(row, "row must be a sequence");
    if (!rowf) { ok = 0; break; }
    if (PySequence_Fast_GET_SIZE(rowf) != ncols) {
      PyErr_Format(PyExc_ValueError,
                   "row %zd has %zd fields, spec has %zd columns", r,
                   PySequence_Fast_GET_SIZE(rowf), ncols);
      Py_DECREF(rowf);
      ok = 0;
      break;
    }
    for (Py_ssize_t c = 0; ok && c < ncols; c++) {
      PyObject *v = PySequence_Fast_GET_ITEM(rowf, c);
      if (widths[c] == 0) {
        if (fill_value(codes[c], bufs[c].buf, r, v) < 0) ok = 0;
      } else {
        PyObject *vf = PySequence_Fast(v, "array column value must be a sequence");
        if (!vf) { ok = 0; break; }
        if (PySequence_Fast_GET_SIZE(vf) != widths[c]) {
          PyErr_Format(PyExc_ValueError,
                       "row %zd col %zd: length %zd != spec width %zd", r, c,
                       PySequence_Fast_GET_SIZE(vf), widths[c]);
          Py_DECREF(vf);
          ok = 0;
          break;
        }
        for (Py_ssize_t k = 0; k < widths[c]; k++) {
          if (fill_value(codes[c], bufs[c].buf, r * widths[c] + k,
                         PySequence_Fast_GET_ITEM(vf, k)) < 0) {
            ok = 0;
            break;
          }
        }
        Py_DECREF(vf);
      }
    }
    Py_DECREF(rowf);
  }

  for (Py_ssize_t c = 0; c < ncols; c++)
    if (bufs && bufs[c].obj) PyBuffer_Release(&bufs[c]);
  PyMem_Free(bufs);
  PyMem_Free(codes);
  PyMem_Free(widths);
  Py_DECREF(rows);
  Py_DECREF(spec);
  if (!ok) {
    Py_XDECREF(out);
    return NULL;
  }
  return out;
}

static PyObject *value_from(char code, const char *src, Py_ssize_t idx) {
  switch (code) {
    case '?': return PyBool_FromLong(((const unsigned char *)src)[idx]);
    case 'b': return PyLong_FromLong(((const signed char *)src)[idx]);
    case 'i': return PyLong_FromLong(((const int *)src)[idx]);
    case 'l': return PyLong_FromLongLong(((const long long *)src)[idx]);
    case 'f': return PyFloat_FromDouble(((const float *)src)[idx]);
    case 'd': return PyFloat_FromDouble(((const double *)src)[idx]);
    default:
      PyErr_Format(PyExc_ValueError, "unsupported output dtype '%c'", code);
      return NULL;
  }
}

/* map a numpy format string (buffer protocol) to our dtype code */
static char format_code(const char *fmt) {
  if (!fmt) return 0;
  /* skip byte-order prefix */
  if (*fmt == '<' || *fmt == '>' || *fmt == '=' || *fmt == '|') fmt++;
  switch (*fmt) {
    case '?': return '?';
    case 'b': return 'b';
    case 'i': return 'i';
    case 'l': return sizeof(long) == 8 ? 'l' : 'i';
    case 'q': return 'l';
    case 'f': return 'f';
    case 'd': return 'd';
    default: return 0;
  }
}

/* Build the python list for one row of a 2-D column with a per-dtype
 * tight loop: hoisting the dtype switch out of the element loop makes
 * wide sequence columns (e.g. 784-float feature rows) ~2x faster than
 * per-element dispatch — the difference between losing and winning
 * against numpy's tolist() on the reconstruction path. */
static PyObject *row_list_from(char code, const char *src, Py_ssize_t off,
                               Py_ssize_t w) {
  PyObject *v = PyList_New(w);
  if (!v) return NULL;
  Py_ssize_t k = 0;
  switch (code) {
    case 'f': {
      const float *p = (const float *)src + off;
      for (; k < w; k++) {
        PyObject *e = PyFloat_FromDouble(p[k]);
        if (!e) goto fail;
        PyList_SET_ITEM(v, k, e);
      }
      return v;
    }
    case 'd': {
      const double *p = (const double *)src + off;
      for (; k < w; k++) {
        PyObject *e = PyFloat_FromDouble(p[k]);
        if (!e) goto fail;
        PyList_SET_ITEM(v, k, e);
      }
      return v;
    }
    case 'i': {
      const int *p = (const int *)src + off;
      for (; k < w; k++) {
        PyObject *e = PyLong_FromLong(p[k]);
        if (!e) goto fail;
        PyList_SET_ITEM(v, k, e);
      }
      return v;
    }
    case 'l': {
      const long long *p = (const long long *)src + off;
      for (; k < w; k++) {
        PyObject *e = PyLong_FromLongLong(p[k]);
        if (!e) goto fail;
        PyList_SET_ITEM(v, k, e);
      }
      return v;
    }
    default:
      for (; k < w; k++) {
        PyObject *e = value_from(code, src, off + k);
        if (!e) goto fail;
        PyList_SET_ITEM(v, k, e);
      }
      return v;
  }
fail:
  Py_DECREF(v);
  return NULL;
}

static PyObject *columns_to_rows(PyObject *self, PyObject *args) {
  PyObject *cols_obj;
  if (!PyArg_ParseTuple(args, "O", &cols_obj)) return NULL;
  PyObject *cols = PySequence_Fast(cols_obj, "columns must be a sequence");
  if (!cols) return NULL;
  Py_ssize_t ncols = PySequence_Fast_GET_SIZE(cols);

  Py_buffer *bufs = PyMem_Calloc(ncols, sizeof(Py_buffer));
  char *codes = PyMem_Calloc(ncols, 1);
  Py_ssize_t n = -1;
  int ok = (bufs && codes);
  PyObject *out = NULL;

  for (Py_ssize_t c = 0; ok && c < ncols; c++) {
    PyObject *arr = PySequence_Fast_GET_ITEM(cols, c);
    if (PyObject_GetBuffer(arr, &bufs[c], PyBUF_FORMAT | PyBUF_C_CONTIGUOUS) < 0) {
      ok = 0;
      break;
    }
    if (bufs[c].ndim < 1 || bufs[c].ndim > 2) {
      PyErr_Format(PyExc_ValueError, "column %zd: ndim %d not in {1,2}", c,
                   bufs[c].ndim);
      ok = 0;
      break;
    }
    codes[c] = format_code(bufs[c].format);
    if (!codes[c]) {
      PyErr_Format(PyExc_ValueError, "column %zd: unsupported format '%s'", c,
                   bufs[c].format ? bufs[c].format : "?");
      ok = 0;
      break;
    }
    if (n == -1) n = bufs[c].shape[0];
    else if (bufs[c].shape[0] != n) {
      PyErr_Format(PyExc_ValueError,
                   "column %zd has %zd rows, expected %zd", c,
                   bufs[c].shape[0], n);
      ok = 0;
      break;
    }
  }
  if (n < 0) n = 0;

  if (ok) {
    out = PyList_New(n);
    if (!out) ok = 0;
  }
  for (Py_ssize_t r = 0; ok && r < n; r++) {
    PyObject *row = PyTuple_New(ncols);
    if (!row) { ok = 0; break; }
    for (Py_ssize_t c = 0; c < ncols; c++) {
      PyObject *v;
      if (bufs[c].ndim == 1) {
        v = value_from(codes[c], bufs[c].buf, r);
      } else {
        Py_ssize_t w = bufs[c].shape[1];
        v = row_list_from(codes[c], bufs[c].buf, r * w, w);
      }
      if (!v) { Py_DECREF(row); ok = 0; break; }
      PyTuple_SET_ITEM(row, c, v);
    }
    if (!ok) break;
    PyList_SET_ITEM(out, r, row);
  }

  for (Py_ssize_t c = 0; c < ncols; c++)
    if (bufs && bufs[c].obj) PyBuffer_Release(&bufs[c]);
  PyMem_Free(bufs);
  PyMem_Free(codes);
  Py_DECREF(cols);
  if (!ok) {
    Py_XDECREF(out);
    return NULL;
  }
  return out;
}

static PyMethodDef methods[] = {
    {"rows_to_columns", rows_to_columns, METH_VARARGS,
     "rows_to_columns(rows, spec) -> tuple of numpy arrays"},
    {"columns_to_rows", columns_to_rows, METH_VARARGS,
     "columns_to_rows(columns) -> list of row tuples"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tfos_torch_marshal",
    "native row-batch <-> typed-column marshalling", -1, methods,
};

PyMODINIT_FUNC PyInit__tfos_torch_marshal(void) {
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) return NULL;
  np_empty = PyObject_GetAttrString(np, "empty");
  Py_DECREF(np);
  if (!np_empty) return NULL;
  return PyModule_Create(&moduledef);
}
