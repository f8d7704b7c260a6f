// The port's C-ABI shim: embeds CPython and calls gunrock_tpu_torch.capi.
//
// Counterpart of native/c_api.cpp, which calls gunrock_tpu.capi: one
// interpreter a process, created on first call (or the GIL taken when
// the library is loaded into a running Python process), the caller's
// buffers handed over as addresses (numpy views in capi.py), the results
// written straight into them. The Python side runs on the GPU; any
// exception there, a missing GPU included, is printed and the call
// returns -1.
//
// Built by gunrock_tpu_torch.capi.build_capi_lib():
//   g++ -O2 -shared -fPIC -std=c++17 c_api.cpp -I$PY_INC -L$PY_LIBDIR \
//       -lpython3.12 -DGRTT_PYPATH='"repo:site-packages"'

#include <Python.h>

#include <cstdint>

#include "gunrock_tpu_torch.h"

#ifndef GRTT_PYPATH
#define GRTT_PYPATH ""
#endif

namespace {

// Start the interpreter if needed, with the repository and the build's
// site-packages on sys.path, and take the GIL.
PyGILState_STATE ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    PyRun_SimpleString(
        "import sys\n"
        "for _p in \"" GRTT_PYPATH "\".split(\":\"):\n"
        "    if _p and _p not in sys.path:\n"
        "        sys.path.insert(0, _p)\n");
    // Release the GIL Py_InitializeEx took, so that a call from another
    // thread does not wait on it for ever.
    PyEval_SaveThread();
  }
  return PyGILState_Ensure();
}

// gunrock_tpu_torch.capi.<fn>(*args), every argument an integer (an
// address, a size or a flag). The elapsed ms, or -1.
float call_capi(const char* fn, const long long* args, int nargs) {
  PyGILState_STATE st = ensure_python();
  float result = -1.0f;
  PyObject* mod = PyImport_ImportModule("gunrock_tpu_torch.capi");
  if (mod) {
    PyObject* f = PyObject_GetAttrString(mod, fn);
    if (f) {
      PyObject* tup = PyTuple_New(nargs);
      for (int i = 0; i < nargs; ++i) {
        PyTuple_SET_ITEM(tup, i, PyLong_FromLongLong(args[i]));
      }
      PyObject* r = PyObject_CallObject(f, tup);
      Py_DECREF(tup);
      if (r) {
        result = static_cast<float>(PyFloat_AsDouble(r));
        Py_DECREF(r);
      }
      Py_DECREF(f);
    }
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    result = -1.0f;
  }
  PyGILState_Release(st);
  return result;
}

inline long long addr(const void* p) {
  return static_cast<long long>(reinterpret_cast<uintptr_t>(p));
}

}  // namespace

extern "C" {

float gunrock_tpu_torch_bfs(int* bfs_label, int* bfs_pred,
                            const int num_nodes, const int num_edges,
                            const int* row_offsets, const int* col_indices,
                            const int source, const bool mark_predecessors,
                            const bool direction_optimized) {
  long long a[] = {addr(bfs_label), addr(bfs_pred), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices), source,
                   mark_predecessors ? 1 : 0, direction_optimized ? 1 : 0};
  return call_capi("bfs_c", a, 9);
}

float gunrock_tpu_torch_bc(float* bc_scores, const int num_nodes,
                           const int num_edges, const int* row_offsets,
                           const int* col_indices, const int source) {
  long long a[] = {addr(bc_scores), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices), source};
  return call_capi("bc_c", a, 6);
}

float gunrock_tpu_torch_cc(int* component, int* num_components,
                           const int num_nodes, const int num_edges,
                           const int* row_offsets, const int* col_indices) {
  long long a[] = {addr(component), addr(num_components), num_nodes,
                   num_edges, addr(row_offsets), addr(col_indices)};
  return call_capi("cc_c", a, 6);
}

float gunrock_tpu_torch_sssp(float* distances, int* preds,
                             const int num_nodes, const int num_edges,
                             const int* row_offsets, const int* col_indices,
                             const float* edge_values, const int source,
                             const bool mark_preds) {
  long long a[] = {addr(distances), addr(preds), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices),
                   addr(edge_values), source, mark_preds ? 1 : 0};
  return call_capi("sssp_c", a, 9);
}

float gunrock_tpu_torch_pagerank(int* node_ids, float* pagerank,
                                 const int num_nodes, const int num_edges,
                                 const int* row_offsets,
                                 const int* col_indices,
                                 const bool normalized) {
  long long a[] = {addr(node_ids), addr(pagerank), num_nodes, num_edges,
                   addr(row_offsets), addr(col_indices),
                   normalized ? 1 : 0};
  return call_capi("pagerank_c", a, 7);
}

}  // extern "C"
