/* mh_tpu_torch native runtime: a C ABI shared library embedding the port.
 *
 * The counterpart of mh_tpu's libmh_tpu.so (and of the reference's host
 * wrapper, Kernel.cu:873-984): it embeds CPython, forwards the wire structs
 * of wire.h to mh_tpu_torch.native.bridge as raw byte buffers, and copies
 * the results back into caller-allocated memory. A C / C# / C++ host links
 * (or P/Invokes) it exactly as it would the reference DLL; on the card the
 * bridge's suggest_layouts runs the fused CUDA kernel.
 *
 * Calls run one at a time (a mutex), and every call into Python holds the
 * interpreter lock (PyGILState_Ensure / Release), so the entry points may
 * be called from any thread of a C host and from a Python process through
 * ctypes.CDLL, which drops the lock around a foreign call. A host with no
 * interpreter gets one initialised here, whose main-thread hold on the
 * lock is released at once.
 *
 * Error codes: -1 the interpreter or the bridge did not start, -2 a null
 * argument, -3 the arguments could not be built, -4 the bridge raised (its
 * traceback goes to stderr), -5 the result had the wrong size. On error
 * nothing is written to the out buffers.
 */

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

#include "wire.h"

/* the repo root (prepended to sys.path; MH_TPU_PYROOT in the environment
 * overrides it) and the interpreter that built the library, whose prefix,
 * virtual environment included, the embedded interpreter takes */
#ifndef MH_TPU_PYROOT
#define MH_TPU_PYROOT ""
#endif
#ifndef MH_TPU_PYTHON
#define MH_TPU_PYTHON ""
#endif

namespace {

std::mutex g_mutex;
bool g_initialized = false;
PyObject* g_bridge = nullptr;  // mh_tpu_torch.native.bridge module

// Start the interpreter if the host has none. Returns 0 on success.
int64_t start_interpreter() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.parse_argv = 0;
  config.install_signal_handlers = 0;
  config.configure_c_stdio = 0;
  PyStatus status = PyStatus_Ok();
  if (*MH_TPU_PYTHON) {
    status = PyConfig_SetBytesString(&config, &config.program_name,
                                     MH_TPU_PYTHON);
  }
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "mh_tpu_torch: Python did not start: %s\n",
                 status.err_msg ? status.err_msg : "unknown error");
    return -1;
  }
  PyEval_SaveThread();  // every call takes the lock with PyGILState_Ensure
  return 0;
}

// Initialise the interpreter and import the bridge once. Returns 0 on
// success. Caller must hold g_mutex.
int64_t ensure_bridge_locked() {
  if (g_initialized) return g_bridge ? 0 : -1;
  g_initialized = true;
  if (!Py_IsInitialized() && start_interpreter() != 0) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  // Make mh_tpu_torch importable without a site-packages install.
  const char* env_root = std::getenv("MH_TPU_PYROOT");
  const char* root = (env_root && *env_root) ? env_root : MH_TPU_PYROOT;
  if (*root) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* entry = sys_path ? PyUnicode_FromString(root) : nullptr;
    if (entry) {
      PyList_Insert(sys_path, 0, entry);
      Py_DECREF(entry);
    }
  }
  g_bridge = PyImport_ImportModule("mh_tpu_torch.native.bridge");
  if (!g_bridge) PyErr_Print();
  PyGILState_Release(gil);
  return g_bridge ? 0 : -1;
}

PyObject* bytes_view(const void* p, Py_ssize_t len) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(p), len);
}

// The bridge's run_wire on the wire structs; copies its result out.
int64_t run_wire(const mh_surface* surface,
                 const mh_relationship* relationships,
                 const mh_angle_relationship* angle_relationships,
                 const mh_pose* poses, const mh_rect* clearances,
                 const mh_rect* offlimits, const mh_config* config,
                 double* out_points, mh_result_costs* out_costs,
                 double* out_accept_rate) {
  const int64_t n = surface->n_objs;
  const int64_t chains = config->n_chains;

  PyObject* args = Py_BuildValue(
      "(NNNNNNN)",
      bytes_view(surface, sizeof(mh_surface)),
      bytes_view(relationships,
                 sizeof(mh_relationship) * surface->n_relationships),
      bytes_view(angle_relationships,
                 sizeof(mh_angle_relationship) *
                     surface->n_angle_relationships),
      bytes_view(poses, sizeof(mh_pose) * n),
      bytes_view(clearances, sizeof(mh_rect) * surface->n_clearances),
      bytes_view(offlimits, sizeof(mh_rect) * n),
      bytes_view(config, sizeof(mh_config)));
  if (!args) {
    PyErr_Print();
    return -3;
  }

  PyObject* fn = PyObject_GetAttrString(g_bridge, "run_wire");
  PyObject* result = fn ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_DECREF(args);
  if (!result) {
    PyErr_Print();
    return -4;
  }

  // result: bytes = points f64[chains*n*6] | costs f64[chains*8] |
  //                 accept f64[chains]
  const int64_t pts = chains * n * 6;
  const int64_t expect =
      static_cast<int64_t>(sizeof(double)) * (pts + chains * 8 + chains);
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(result, &buf, &len) != 0 || len != expect) {
    PyErr_Clear();
    Py_DECREF(result);
    return -5;
  }
  std::memcpy(out_points, buf, sizeof(double) * pts);
  std::memcpy(out_costs, buf + sizeof(double) * pts,
              sizeof(double) * chains * 8);
  std::memcpy(out_accept_rate, buf + sizeof(double) * (pts + chains * 8),
              sizeof(double) * chains);
  Py_DECREF(result);
  return 0;
}

}  // namespace

extern "C" int64_t MHKernelWrapper(const mh_surface* surface,
                                   const mh_relationship* relationships,
                                   const mh_angle_relationship* angle_relationships,
                                   const mh_pose* poses,
                                   const mh_rect* clearances,
                                   const mh_rect* offlimits,
                                   const mh_config* config,
                                   double* out_points,
                                   mh_result_costs* out_costs,
                                   double* out_accept_rate) {
  if (!surface || !poses || !config || !out_points || !out_costs ||
      !out_accept_rate) {
    return -2;
  }
  std::lock_guard<std::mutex> lock(g_mutex);
  if (ensure_bridge_locked() != 0) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  const int64_t rc = run_wire(surface, relationships, angle_relationships,
                              poses, clearances, offlimits, config, out_points,
                              out_costs, out_accept_rate);
  PyGILState_Release(gil);
  return rc;
}

extern "C" int64_t MHDeviceReport(char* buf, int64_t buf_len) {
  if (!buf || buf_len <= 0) return -2;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (ensure_bridge_locked() != 0) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  int64_t rc = 0;
  PyObject* s = PyObject_CallMethod(g_bridge, "device_report", nullptr);
  const char* c = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (!s) {
    PyErr_Print();
    rc = -4;
  } else if (!c) {
    PyErr_Clear();
    rc = -5;
  } else {
    std::snprintf(buf, static_cast<size_t>(buf_len), "%s", c);
  }
  Py_XDECREF(s);
  PyGILState_Release(gil);
  return rc;
}
