/* Hash-consed ROBDD engine — native core for circuit construction.
 *
 * The boolean-circuit layer builds adders/multipliers/comparators as
 * BDDs at circuit-build time (spf_tpu_torch/circuits/bdd.py). The reference
 * gets this for free from Rust + biodivine-lib-bdd; in Python the
 * 16x16 multiplier takes ~2 minutes. This extension implements the
 * same ROBDD (ite with memoization, unique-table hash consing) in C++
 * with the exact same node-id semantics as the Python engine
 * (0 = FALSE, 1 = TRUE, nodes append-only), so the two are
 * interchangeable and cross-checked by tests.
 *
 * Built with the CPython C API (no pybind11 in this image) at first use
 * into spf_tpu_torch/_build/; see spf_tpu_torch/native/build.py. A copy
 * of spf_tpu/native/bdd_native.cpp.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  int32_t var;
  int32_t lo;
  int32_t hi;
};

struct KeyHash {
  size_t operator()(const uint64_t k) const {
    // splitmix64
    uint64_t z = k + 0x9e3779b97f4a7c15ULL;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return static_cast<size_t>(z ^ (z >> 31));
  }
};

struct Manager {
  PyObject_HEAD
  int32_t num_vars;
  std::vector<Node>* nodes;
  std::unordered_map<uint64_t, int32_t, KeyHash>* unique;   // (var,lo,hi) -> id
  std::unordered_map<uint64_t, int32_t, KeyHash>* ite_lo;   // (f,g,h) low 64
  std::unordered_map<uint64_t, int32_t, KeyHash>* ite_hi;   // high bits disambiguation
  // full ite cache keyed by 96 bits via two maps is fragile; use one map
  // keyed by packed 3x21-bit ids when small, else a std::map fallback
  std::unordered_map<uint64_t, int32_t, KeyHash>* ite_big;
};

inline uint64_t pack3(uint32_t a, uint32_t b, uint32_t c) {
  // valid while ids < 2^21 (~2M nodes); circuits here stay well below
  return (static_cast<uint64_t>(a) << 42) | (static_cast<uint64_t>(b) << 21) |
         static_cast<uint64_t>(c);
}

int32_t mk(Manager* m, int32_t var, int32_t lo, int32_t hi) {
  if (lo == hi) return lo;
  uint64_t key = pack3(static_cast<uint32_t>(var), static_cast<uint32_t>(lo),
                       static_cast<uint32_t>(hi));
  auto it = m->unique->find(key);
  if (it != m->unique->end()) return it->second;
  int32_t id = static_cast<int32_t>(m->nodes->size());
  m->nodes->push_back({var, lo, hi});
  (*m->unique)[key] = id;
  return id;
}

int32_t ite(Manager* m, int32_t f, int32_t g, int32_t h) {
  if (f == 1) return g;
  if (f == 0) return h;
  if (g == h) return g;
  if (g == 1 && h == 0) return f;
  uint64_t key = pack3(static_cast<uint32_t>(f), static_cast<uint32_t>(g),
                       static_cast<uint32_t>(h));
  auto it = m->ite_big->find(key);
  if (it != m->ite_big->end()) return it->second;

  const std::vector<Node>& nodes = *m->nodes;
  int32_t top = nodes[f].var;
  if (nodes[g].var < top) top = nodes[g].var;
  if (nodes[h].var < top) top = nodes[h].var;

  auto cof = [&](int32_t x, bool branch) -> int32_t {
    const Node& n = nodes[x];
    if (n.var != top) return x;
    return branch ? n.hi : n.lo;
  };

  int32_t f0 = cof(f, false), g0 = cof(g, false), h0 = cof(h, false);
  int32_t f1 = cof(f, true), g1 = cof(g, true), h1 = cof(h, true);
  int32_t lo = ite(m, f0, g0, h0);
  int32_t hi = ite(m, f1, g1, h1);
  int32_t r = mk(m, top, lo, hi);
  (*m->ite_big)[key] = r;
  return r;
}

// --- Python type ---

PyObject* Manager_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  int num_vars = 0;
  static const char* kwlist[] = {"num_vars", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "i",
                                   const_cast<char**>(kwlist), &num_vars))
    return nullptr;
  Manager* self = reinterpret_cast<Manager*>(type->tp_alloc(type, 0));
  if (!self) return nullptr;
  self->num_vars = num_vars;
  self->nodes = new std::vector<Node>();
  self->unique = new std::unordered_map<uint64_t, int32_t, KeyHash>();
  self->ite_big = new std::unordered_map<uint64_t, int32_t, KeyHash>();
  self->ite_lo = nullptr;
  self->ite_hi = nullptr;
  // terminals: var = num_vars sorts after every real variable
  self->nodes->push_back({num_vars, 0, 0});
  self->nodes->push_back({num_vars, 1, 1});
  return reinterpret_cast<PyObject*>(self);
}

void Manager_dealloc(Manager* self) {
  delete self->nodes;
  delete self->unique;
  delete self->ite_big;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* Manager_var(Manager* self, PyObject* arg) {
  long i = PyLong_AsLong(arg);
  if (i < 0 || i >= self->num_vars) {
    PyErr_SetString(PyExc_ValueError, "variable index out of range");
    return nullptr;
  }
  return PyLong_FromLong(mk(self, static_cast<int32_t>(i), 0, 1));
}

PyObject* Manager_ite(Manager* self, PyObject* args) {
  int f, g, h;
  if (!PyArg_ParseTuple(args, "iii", &f, &g, &h)) return nullptr;
  return PyLong_FromLong(ite(self, f, g, h));
}

PyObject* Manager_num_nodes(Manager* self, PyObject*) {
  return PyLong_FromSize_t(self->nodes->size());
}

PyObject* Manager_node(Manager* self, PyObject* arg) {
  long i = PyLong_AsLong(arg);
  if (i < 0 || static_cast<size_t>(i) >= self->nodes->size()) {
    PyErr_SetString(PyExc_IndexError, "node id out of range");
    return nullptr;
  }
  const Node& n = (*self->nodes)[i];
  return Py_BuildValue("(iii)", n.var, n.lo, n.hi);
}

PyMethodDef Manager_methods[] = {
    {"var", reinterpret_cast<PyCFunction>(Manager_var), METH_O,
     "BDD for a single variable"},
    {"ite", reinterpret_cast<PyCFunction>(Manager_ite), METH_VARARGS,
     "if-then-else of three BDD ids"},
    {"num_nodes", reinterpret_cast<PyCFunction>(Manager_num_nodes),
     METH_NOARGS, "total node count"},
    {"node", reinterpret_cast<PyCFunction>(Manager_node), METH_O,
     "(var, lo, hi) triple of a node id"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject ManagerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyModuleDef bdd_module = {
    PyModuleDef_HEAD_INIT, "bdd_native",
    "Native hash-consed ROBDD engine for mux-circuit construction",
    -1, nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_bdd_native(void) {
  ManagerType.tp_name = "bdd_native.Manager";
  ManagerType.tp_basicsize = sizeof(Manager);
  ManagerType.tp_flags = Py_TPFLAGS_DEFAULT;
  ManagerType.tp_doc = "Hash-consed ROBDD manager";
  ManagerType.tp_new = Manager_new;
  ManagerType.tp_dealloc = reinterpret_cast<destructor>(Manager_dealloc);
  ManagerType.tp_methods = Manager_methods;
  if (PyType_Ready(&ManagerType) < 0) return nullptr;
  PyObject* mod = PyModule_Create(&bdd_module);
  if (!mod) return nullptr;
  Py_INCREF(&ManagerType);
  PyModule_AddObject(mod, "Manager",
                     reinterpret_cast<PyObject*>(&ManagerType));
  return mod;
}
