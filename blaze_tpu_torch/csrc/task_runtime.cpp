// Task runtime entry: init / call / finalize (ref blaze/src/exec.rs:54-135
// initNative/callNative/finalizeNative and the per-task runtime of rt.rs).
//
// The port's copy of the JAX package's native/src/task_runtime.cpp; it
// differs only in the Python module it calls. The compute engine is
// PyTorch driven from Python, so callNative's job is to hand the serialized
// TaskDefinition to the in-process engine
// (blaze_tpu_torch.runtime.native_entry.run_task_serialized), which runs it
// on the CUDA card, and hand the serialized result frames back. The Python
// C-API symbols are resolved lazily with dlsym so this library loads
// cleanly both inside a Python process (ctypes) and inside a JVM that has
// embedded/loaded libpython (the deployment mode a Spark executor uses).

#include <dlfcn.h>

#include <cstdlib>
#include <cstring>
#include <string>

#include "blaze_native.h"

namespace {

thread_local std::string g_last_error;
// category of the last failure, NATIVE_CATEGORY_CODES wire codes
// (blaze_native.h / blaze_tpu_torch.runtime.faults): 0 none, 1 retryable,
// 2 resource, 3 plan, 4 fatal, 5 killed
thread_local int g_last_category = 0;

// minimal Python C-API surface, resolved at runtime
struct PyApi {
  void* (*GILState_Ensure)();
  void (*GILState_Release)(void*);
  void* (*Import_ImportModule)(const char*);
  void* (*Object_GetAttrString)(void*, const char*);
  void* (*Bytes_FromStringAndSize)(const char*, ssize_t);
  void* (*Object_CallFunctionObjArgs)(void*, ...);
  char* (*Bytes_AsString)(void*);
  ssize_t (*Bytes_Size)(void*);
  void (*Dec)(void*);
  void* (*Err_Occurred)();
  void (*Err_Fetch)(void**, void**, void**);
  void (*Err_Clear)();
  void* (*Object_Str)(void*);
  const char* (*Unicode_AsUTF8)(void*);
  bool ok = false;
};

PyApi g_py;

bool load_py_api() {
  if (g_py.ok) return true;
  void* h = RTLD_DEFAULT;
  auto sym = [&](const char* name) -> void* {
    void* s = dlsym(h, name);
    if (!s) {
      // try an explicitly loaded libpython (JVM embedding path)
      static void* lib = dlopen("libpython3.12.so.1.0",
                                RTLD_NOW | RTLD_GLOBAL);
      if (lib) s = dlsym(lib, name);
    }
    return s;
  };
  g_py.GILState_Ensure =
      reinterpret_cast<void* (*)()>(sym("PyGILState_Ensure"));
  g_py.GILState_Release =
      reinterpret_cast<void (*)(void*)>(sym("PyGILState_Release"));
  g_py.Import_ImportModule =
      reinterpret_cast<void* (*)(const char*)>(sym("PyImport_ImportModule"));
  g_py.Object_GetAttrString = reinterpret_cast<void* (*)(void*, const char*)>(
      sym("PyObject_GetAttrString"));
  g_py.Bytes_FromStringAndSize =
      reinterpret_cast<void* (*)(const char*, ssize_t)>(
          sym("PyBytes_FromStringAndSize"));
  g_py.Object_CallFunctionObjArgs = reinterpret_cast<void* (*)(void*, ...)>(
      sym("PyObject_CallFunctionObjArgs"));
  g_py.Bytes_AsString =
      reinterpret_cast<char* (*)(void*)>(sym("PyBytes_AsString"));
  g_py.Bytes_Size = reinterpret_cast<ssize_t (*)(void*)>(sym("PyBytes_Size"));
  g_py.Dec = reinterpret_cast<void (*)(void*)>(sym("Py_DecRef"));
  g_py.Err_Occurred = reinterpret_cast<void* (*)()>(sym("PyErr_Occurred"));
  g_py.Err_Fetch = reinterpret_cast<void (*)(void**, void**, void**)>(
      sym("PyErr_Fetch"));
  g_py.Err_Clear = reinterpret_cast<void (*)()>(sym("PyErr_Clear"));
  g_py.Object_Str = reinterpret_cast<void* (*)(void*)>(sym("PyObject_Str"));
  g_py.Unicode_AsUTF8 =
      reinterpret_cast<const char* (*)(void*)>(sym("PyUnicode_AsUTF8"));
  g_py.ok = g_py.GILState_Ensure && g_py.Import_ImportModule &&
            g_py.Object_CallFunctionObjArgs && g_py.Bytes_AsString;
  return g_py.ok;
}

int category_of_py_error(void* type, void* value) {
  // The Python engine classifies task errors into the faults taxonomy
  // before they cross this boundary (native_entry wraps the task entries
  // in faults.ensure_classified), so the instance normally carries a
  // `category` string attribute. Fall back to the type name for raw
  // exceptions; anything unrecognized is fatal.
  if (!g_py.Object_GetAttrString || !g_py.Unicode_AsUTF8) return 4;
  if (value) {
    void* cat = g_py.Object_GetAttrString(value, "category");
    if (cat) {
      const char* s = g_py.Unicode_AsUTF8(cat);
      int code = 4;
      if (s) {
        if (std::strcmp(s, "retryable") == 0) code = 1;
        else if (std::strcmp(s, "resource") == 0) code = 2;
        else if (std::strcmp(s, "plan") == 0) code = 3;
        else if (std::strcmp(s, "killed") == 0) code = 5;
      }
      g_py.Dec(cat);
      return code;
    }
    if (g_py.Err_Clear) g_py.Err_Clear();  // GetAttrString set a new error
  }
  if (type) {
    void* nm = g_py.Object_GetAttrString(type, "__name__");
    if (nm) {
      const char* s = g_py.Unicode_AsUTF8(nm);
      int code = 4;
      if (s) {
        if (std::strstr(s, "TaskKilled")) code = 5;
        else if (std::strcmp(s, "MemoryError") == 0) code = 2;
        else if (std::strcmp(s, "NotImplementedError") == 0) code = 3;
        else if (std::strcmp(s, "TimeoutError") == 0 ||
                 std::strcmp(s, "ConnectionError") == 0 ||
                 std::strcmp(s, "BrokenPipeError") == 0) code = 1;
      }
      g_py.Dec(nm);
      return code;
    }
    if (g_py.Err_Clear) g_py.Err_Clear();
  }
  return 4;
}

void capture_py_error() {
  if (!g_py.Err_Occurred || !g_py.Err_Occurred()) {
    g_last_error = "python call failed (no exception info)";
    g_last_category = 4;
    return;
  }
  void *type = nullptr, *value = nullptr, *tb = nullptr;
  g_py.Err_Fetch(&type, &value, &tb);
  g_last_category = category_of_py_error(type, value);
  if (value && g_py.Object_Str && g_py.Unicode_AsUTF8) {
    void* s = g_py.Object_Str(value);
    const char* msg = s ? g_py.Unicode_AsUTF8(s) : nullptr;
    g_last_error = msg ? msg : "python exception";
    if (s) g_py.Dec(s);
  } else {
    g_last_error = "python exception";
  }
  if (type) g_py.Dec(type);
  if (value) g_py.Dec(value);
  if (tb) g_py.Dec(tb);
}

}  // namespace

extern "C" {

const char* bn_last_error(void) { return g_last_error.c_str(); }

int bn_last_error_category(void) { return g_last_category; }

int bn_init(int64_t mem_budget) {
  if (!load_py_api()) {
    g_last_error = "python runtime not available";
    g_last_category = 4;
    return -1;
  }
  void* gil = g_py.GILState_Ensure();
  int rc = 0;
  void* mod =
      g_py.Import_ImportModule("blaze_tpu_torch.runtime.native_entry");
  if (!mod) {
    capture_py_error();
    rc = -2;
  } else {
    void* fn = g_py.Object_GetAttrString(mod, "init");
    if (fn) {
      void* arg = g_py.Bytes_FromStringAndSize(
          reinterpret_cast<const char*>(&mem_budget), sizeof(mem_budget));
      void* res = g_py.Object_CallFunctionObjArgs(fn, arg, nullptr);
      if (!res) {
        capture_py_error();
        rc = -3;
      } else {
        g_py.Dec(res);
      }
      if (arg) g_py.Dec(arg);
      g_py.Dec(fn);
    }
    g_py.Dec(mod);
  }
  g_py.GILState_Release(gil);
  return rc;
}

int bn_call_py(const uint8_t* task_def, int64_t len, const char* entry,
               uint8_t** out, int64_t* out_len) {
  if (!load_py_api()) {
    g_last_error = "python runtime not available";
    g_last_category = 4;
    return -1;
  }
  void* gil = g_py.GILState_Ensure();
  int rc = 0;
  *out = nullptr;
  *out_len = 0;
  void* mod =
      g_py.Import_ImportModule("blaze_tpu_torch.runtime.native_entry");
  if (!mod) {
    capture_py_error();
    g_py.GILState_Release(gil);
    return -2;
  }
  void* fn = g_py.Object_GetAttrString(mod, entry);
  if (!fn) {
    capture_py_error();
    g_py.Dec(mod);
    g_py.GILState_Release(gil);
    return -3;
  }
  void* arg = g_py.Bytes_FromStringAndSize(
      reinterpret_cast<const char*>(task_def), len);
  void* res = g_py.Object_CallFunctionObjArgs(fn, arg, nullptr);
  if (!res) {
    capture_py_error();
    rc = -4;
  } else {
    ssize_t sz = g_py.Bytes_Size(res);
    char* data = g_py.Bytes_AsString(res);
    if (sz < 0 || !data) {
      g_last_error = "task entry must return bytes";
      g_last_category = 4;
      rc = -5;
    } else {
      *out = static_cast<uint8_t*>(std::malloc(sz));
      std::memcpy(*out, data, sz);
      *out_len = sz;
    }
    g_py.Dec(res);
  }
  g_py.Dec(arg);
  g_py.Dec(fn);
  g_py.Dec(mod);
  g_py.GILState_Release(gil);
  return rc;
}

int bn_call(const uint8_t* task_def, int64_t len, uint8_t** out,
            int64_t* out_len) {
  return bn_call_py(task_def, len, "run_task_serialized", out, out_len);
}

namespace {

// shared body of the kill-flag entries: call a no-argument-payload
// native_entry hook and report success/failure. The Python-side flag is
// the source of truth (native ExecContexts poll it at batch boundaries);
// the C++ layer only flips it on the host's behalf.
int call_kill_entry(const char* entry) {
  uint8_t* out = nullptr;
  int64_t out_len = 0;
  int rc = bn_call_py(nullptr, 0, entry, &out, &out_len);
  if (out) bn_free_buffer(out);
  return rc == 0 ? 0 : -1;
}

}  // namespace

int bn_request_kill(void) { return call_kill_entry("request_kill"); }

int bn_clear_kill(void) { return call_kill_entry("clear_kill"); }

int bn_kill_requested(void) {
  uint8_t* out = nullptr;
  int64_t out_len = 0;
  // kill_state returns b"\x01" / b"\x00"
  int rc = bn_call_py(nullptr, 0, "kill_state", &out, &out_len);
  if (rc != 0 || out_len != 1) {
    if (out) bn_free_buffer(out);
    return -1;
  }
  int set = out[0] != 0;
  bn_free_buffer(out);
  return set;
}

int64_t bn_spill(int64_t bytes_needed) {
  // host-driven memory reclamation (ref OnHeapSpillManager.scala:61-144
  // — Spark's memory manager forces spill state to disk under pressure)
  uint8_t* out = nullptr;
  int64_t out_len = 0;
  int rc = bn_call_py(reinterpret_cast<const uint8_t*>(&bytes_needed),
                      sizeof(bytes_needed), "spill", &out, &out_len);
  if (rc != 0 || out_len != sizeof(int64_t)) {
    if (out) bn_free_buffer(out);
    return -1;
  }
  int64_t freed;
  std::memcpy(&freed, out, sizeof(freed));
  bn_free_buffer(out);
  return freed;
}

int bn_finalize(void) {
  g_last_error.clear();
  g_last_category = 0;
  return 0;
}

void bn_free_buffer(uint8_t* buf) { std::free(buf); }

}  // extern "C"
