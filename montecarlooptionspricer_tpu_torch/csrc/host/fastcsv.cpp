// The port's native CSV reader (counterpart: montecarlooptionspricer_tpu's
// native/fastcsv.cpp).
//
// Reads the whole file once and splits it into Python lists of str with no
// Python loop over the fields.  The split keeps std::getline(ss, tok, ',')
// semantics: no quoting, no escaping, a trailing delimiter yields no empty
// trailing field, and "," yields [""].  Lines end at '\n' only: one
// trailing '\r' is stripped, a lone '\r' inside a line is field content.
// Empty and whitespace-only lines after the header are skipped, and each
// field is decoded as UTF-8 with replacement.  The Python form beside it,
// pipeline/csv_io.py read_table_plain, gives the same lists.
//
// A CPython extension, built at first use by kernels/host_build.py:
//   read_table(path) -> (header: list[str], rows: list[list[str]])

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// One line (no line break) as a list of str.
PyObject* split_fields(const char* s, Py_ssize_t len) {
  PyObject* list = PyList_New(0);
  if (!list || len == 0) return list;
  Py_ssize_t start = 0;
  for (Py_ssize_t i = 0; i <= len; ++i) {
    const bool at_end = i == len;
    if (!at_end && s[i] != ',') continue;
    // getline reaches the end right after a delimiter: no empty field.
    if (at_end && i == start && s[i - 1] == ',') break;
    PyObject* field = PyUnicode_DecodeUTF8(s + start, i - start, "replace");
    if (!field || PyList_Append(list, field) < 0) {
      Py_XDECREF(field);
      Py_DECREF(list);
      return nullptr;
    }
    Py_DECREF(field);
    start = i + 1;
  }
  return list;
}

bool blank(const char* s, size_t len) {
  for (size_t i = 0; i < len; ++i)
    if (!std::isspace(static_cast<unsigned char>(s[i]))) return false;
  return true;
}

// The whole file, read in chunks (a pipe or a special file reads as well as
// a regular one); false with an OSError set on failure.
bool slurp(const char* path, std::string* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return false;
  }
  char buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) data->append(buf, got);
  const bool failed = std::ferror(f) != 0;
  std::fclose(f);
  if (failed) PyErr_Format(PyExc_OSError, "read error on %s", path);
  return !failed;
}

PyObject* read_table(PyObject*, PyObject* args) {
  const char* path = nullptr;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  std::string data;
  if (!slurp(path, &data)) return nullptr;
  if (data.empty()) {
    PyErr_Format(PyExc_ValueError, "Empty CSV: %s", path);
    return nullptr;
  }
  const char* base = data.data();
  const size_t n = data.size();
  PyObject* header = nullptr;
  PyObject* rows = PyList_New(0);
  if (!rows) return nullptr;
  size_t pos = 0;
  while (pos < n) {
    const char* nl = static_cast<const char*>(std::memchr(base + pos, '\n',
                                                          n - pos));
    const size_t end = nl ? static_cast<size_t>(nl - base) : n;
    size_t len = end - pos;
    if (len > 0 && base[pos + len - 1] == '\r') --len;
    if (!header) {
      header = split_fields(base + pos, static_cast<Py_ssize_t>(len));
      if (!header) break;
    } else if (len > 0 && !blank(base + pos, len)) {
      PyObject* row = split_fields(base + pos, static_cast<Py_ssize_t>(len));
      if (!row || PyList_Append(rows, row) < 0) {
        Py_XDECREF(row);
        Py_CLEAR(header);
        break;
      }
      Py_DECREF(row);
    }
    pos = end + 1;
  }
  if (!header) {
    Py_DECREF(rows);
    return nullptr;
  }
  PyObject* out = PyTuple_Pack(2, header, rows);
  Py_DECREF(header);
  Py_DECREF(rows);
  return out;
}

PyMethodDef methods[] = {
    {"read_table", read_table, METH_VARARGS,
     "read_table(path) -> (header, rows), split with std::getline "
     "semantics."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_mcop_fastcsv",
    "The port's native CSV reader.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mcop_fastcsv(void) {
  return PyModule_Create(&module_def);
}
