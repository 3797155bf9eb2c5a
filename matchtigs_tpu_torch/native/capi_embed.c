/* Copied from native/capi_embed.c; it delegates to matchtigs_tpu_torch.capi. */
/* C ABI for embedding the framework in non-Python hosts (GGCAT-style).
 *
 * Mirrors the reference's extern "C" surface (upstream src/clib.rs):
 *   matchtigs_initialise()
 *   matchtigs_initialise_graph(unitig_amount) -> handle
 *   matchtigs_merge_nodes(handle, a, strand_a, b, strand_b)
 *   matchtigs_build_graph(handle, unitig_weights*)
 *   matchtigs_compute_tigs(handle, algorithm, threads, k,
 *                          matching_file_prefix, matcher_path,
 *                          tigs_edge_out, tigs_insert_out, tigs_out_limits)
 *       -> number of tigs
 *
 * Node numbering, algorithm ids (1=unitigs, 2=pathtigs, 3=eulertigs,
 * 4=matchtigs, 5=greedytigs -- the reference's *code* mapping, clib.rs:
 * 350-389) and the flat signed-unitig-id output layout are identical to
 * the reference.  matching_file_prefix / matcher_path are accepted for
 * signature compatibility; the matching runs with the built-in solver.
 *
 * Implementation: embeds CPython (or joins the interpreter already running
 * in the process) and delegates to matchtigs_tpu_torch.capi.TigGraphBuilder,
 * whose matchtig variants (ids 4 and 5) search on the CUDA card; without one
 * they print the error and return 0 tigs.  Build:
 *   make cabi-torch
 * (matchtigs_tpu_torch.native.build_capi: gcc -shared -fPIC -O2 with the
 * interpreter's includes and embedding flags, into libmatchtigs_tpu_torch.so)
 */

#include <Python.h>
#include <stdint.h>
#include <stdio.h>

typedef long long ll;

typedef struct {
  PyObject *builder;
  ll unitig_amount;
  ll edge_capacity; /* 2 * unitigs after build */
} MatchtigsData;

static void ensure_python(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
}

void matchtigs_initialise(void) { ensure_python(); }

void *matchtigs_initialise_graph(size_t unitig_amount) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *mod = PyImport_ImportModule("matchtigs_tpu_torch.capi");
  if (!mod) {
    PyErr_Print();
    PyGILState_Release(gil);
    return NULL;
  }
  PyObject *cls = PyObject_GetAttrString(mod, "TigGraphBuilder");
  PyObject *builder =
      PyObject_CallFunction(cls, "n", (Py_ssize_t)unitig_amount);
  Py_XDECREF(cls);
  Py_XDECREF(mod);
  if (!builder) {
    PyErr_Print();
    PyGILState_Release(gil);
    return NULL;
  }
  MatchtigsData *data = (MatchtigsData *)malloc(sizeof(MatchtigsData));
  data->builder = builder;
  data->unitig_amount = (ll)unitig_amount;
  data->edge_capacity = 0;
  PyGILState_Release(gil);
  return data;
}

void matchtigs_merge_nodes(void *handle, size_t unitig_a, int strand_a,
                           size_t unitig_b, int strand_b) {
  MatchtigsData *data = (MatchtigsData *)handle;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(data->builder, "merge_nodes", "nOnO",
                                    (Py_ssize_t)unitig_a,
                                    strand_a ? Py_True : Py_False,
                                    (Py_ssize_t)unitig_b,
                                    strand_b ? Py_True : Py_False);
  if (!r) PyErr_Print();
  Py_XDECREF(r);
  PyGILState_Release(gil);
}

void matchtigs_build_graph(void *handle, const size_t *unitig_weights) {
  MatchtigsData *data = (MatchtigsData *)handle;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *weights = PyList_New((Py_ssize_t)data->unitig_amount);
  for (ll i = 0; i < data->unitig_amount; ++i)
    PyList_SET_ITEM(weights, i, PyLong_FromSize_t(unitig_weights[i]));
  PyObject *np = PyImport_ImportModule("numpy");
  PyObject *arr = PyObject_CallMethod(np, "asarray", "O", weights);
  PyObject *r = PyObject_CallMethod(data->builder, "build_graph", "O", arr);
  if (!r) PyErr_Print();
  data->edge_capacity = 2 * data->unitig_amount;
  Py_XDECREF(r);
  Py_XDECREF(arr);
  Py_XDECREF(np);
  Py_XDECREF(weights);
  PyGILState_Release(gil);
}

size_t matchtigs_compute_tigs(void *handle, size_t tig_algorithm,
                              size_t threads, size_t k,
                              const char *matching_file_prefix,
                              const char *matcher_path, int64_t *tigs_edge_out,
                              size_t *tigs_insert_out,
                              size_t *tigs_out_limits) {
  (void)matching_file_prefix;
  (void)matcher_path;
  MatchtigsData *data = (MatchtigsData *)handle;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(
      data->builder, "compute_tigs", "nnn", (Py_ssize_t)tig_algorithm,
      (Py_ssize_t)k, (Py_ssize_t)threads);
  size_t n_tigs = 0;
  if (!r) {
    PyErr_Print();
  } else {
    PyObject *edges = PyTuple_GetItem(r, 0);
    PyObject *inserts = PyTuple_GetItem(r, 1);
    PyObject *limits = PyTuple_GetItem(r, 2);
    PyObject *edges_l = PyObject_CallMethod(edges, "tolist", NULL);
    PyObject *inserts_l = PyObject_CallMethod(inserts, "tolist", NULL);
    PyObject *limits_l = PyObject_CallMethod(limits, "tolist", NULL);
    Py_ssize_t total = PyList_Size(edges_l);
    for (Py_ssize_t i = 0; i < total; ++i) {
      tigs_edge_out[i] =
          (int64_t)PyLong_AsLongLong(PyList_GET_ITEM(edges_l, i));
      tigs_insert_out[i] =
          (size_t)PyLong_AsLongLong(PyList_GET_ITEM(inserts_l, i));
    }
    n_tigs = (size_t)PyList_Size(limits_l);
    for (Py_ssize_t i = 0; i < (Py_ssize_t)n_tigs; ++i)
      tigs_out_limits[i] =
          (size_t)PyLong_AsLongLong(PyList_GET_ITEM(limits_l, i));
    Py_XDECREF(edges_l);
    Py_XDECREF(inserts_l);
    Py_XDECREF(limits_l);
    Py_DECREF(data->builder);
    free(data);
  }
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return n_tigs;
}
