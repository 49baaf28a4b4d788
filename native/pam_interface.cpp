// pam_tpu native host-side data plane: the GCM-facing API.
//
// Equivalent of the reference's pam_interface layer
// (pam_core/pam_interface/{pam_interface.h, pam_interface_extern_c.cpp} and
// the host DataManager, pam_core/DataManager.h): a named, dimension-checked
// host array registry with zero-copy aliasing of GCM-owned memory, a typed
// options KV store, and per-thread coupler instances — exposed through a C
// ABI consumed by the Fortran bindings (generated) and the Python framework
// (ctypes).
//
// This is a fresh C++17 implementation; only the extern "C" entry-point
// names mirror the reference so GCM glue code ports over unchanged.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <variant>
#include <vector>

namespace {

enum class DType : int { Bool = 0, Int = 1, Float = 2, Double = 3 };

size_t dtype_size(DType t) {
  switch (t) {
    case DType::Bool: return 1;
    case DType::Int: return sizeof(int);
    case DType::Float: return sizeof(float);
    case DType::Double: return sizeof(double);
  }
  return 0;
}

struct Entry {
  std::string desc;
  DType dtype{DType::Double};
  std::vector<int> dims;      // row-major (C ordering), as passed
  void *ptr{nullptr};         // borrowed (GCM-owned) or owned.get()
  std::unique_ptr<char[]> owned;
  bool readonly{false};
  bool dirty{false};

  size_t count() const {
    size_t n = 1;
    for (int d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

struct Options {
  using Value = std::variant<bool, int64_t, double, std::string>;
  std::map<std::string, Value> values;
  std::map<std::string, bool> readonly;

  template <class T>
  int set(const std::string &key, T v) {
    auto ro = readonly.find(key);
    if (ro != readonly.end() && ro->second) return -1;
    values[key] = Value(v);
    return 0;
  }
};

struct Coupler {
  std::thread::id tid;
  std::map<std::string, int> dimensions;
  std::map<std::string, Entry> entries;
  Options options;
};

std::vector<std::unique_ptr<Coupler>> g_couplers;
std::mutex g_mutex;

Coupler &coupler() {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto tid = std::this_thread::get_id();
  for (auto &c : g_couplers)
    if (c->tid == tid) return *c;
  g_couplers.push_back(std::make_unique<Coupler>());
  g_couplers.back()->tid = tid;
  return *g_couplers.back();
}

void register_array(const char *name, const char *desc, const int *dims,
                    int ndims, DType t, void *ptr, bool readonly, bool copy) {
  Entry e;
  e.desc = desc ? desc : "";
  e.dtype = t;
  e.dims.assign(dims, dims + ndims);
  e.readonly = readonly;
  if (copy || ptr == nullptr) {
    size_t bytes = e.count() * dtype_size(t);
    e.owned.reset(new char[bytes]());
    if (ptr) std::memcpy(e.owned.get(), ptr, bytes);
    e.ptr = e.owned.get();
  } else {
    e.ptr = ptr;  // zero-copy alias of caller-owned memory
  }
  coupler().entries[name] = std::move(e);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- lifecycle
void pam_interface_finalize() {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_couplers.clear();
}

// --------------------------------------------------------------- dimensions
void pam_interface_register_dimension(const char *name, int len) {
  coupler().dimensions[name] = len;
}

int pam_interface_get_dimension_size(const char *name) {
  auto &d = coupler().dimensions;
  auto it = d.find(name);
  return it == d.end() ? -1 : it->second;
}

// ------------------------------------------------------------------- arrays
// mirror = register existing (zero-copy alias of GCM memory)
#define PAM_MIRROR(SUFFIX, CTYPE, DTYPE)                                      \
  void pam_interface_mirror_array_readonly_##SUFFIX(                          \
      const char *name, const char *desc, int *dims, int ndims,               \
      CTYPE *ptr) {                                                           \
    register_array(name, desc, dims, ndims, DTYPE, ptr, true, false);         \
  }                                                                           \
  void pam_interface_mirror_array_readwrite_##SUFFIX(                         \
      const char *name, const char *desc, int *dims, int ndims,               \
      CTYPE *ptr) {                                                           \
    register_array(name, desc, dims, ndims, DTYPE, ptr, false, false);        \
  }                                                                           \
  void pam_interface_register_and_allocate_##SUFFIX(                          \
      const char *name, const char *desc, int *dims, int ndims) {             \
    register_array(name, desc, dims, ndims, DTYPE, nullptr, false, true);     \
  }

PAM_MIRROR(bool, bool, DType::Bool)
PAM_MIRROR(int, int, DType::Int)
PAM_MIRROR(float, float, DType::Float)
PAM_MIRROR(double, double, DType::Double)
#undef PAM_MIRROR

void pam_interface_unregister_and_deallocate(const char *name) {
  coupler().entries.erase(name);
}

int pam_interface_array_exists(const char *name) {
  return coupler().entries.count(name) ? 1 : 0;
}

void *pam_interface_get_array_ptr(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  if (it == e.end()) return nullptr;
  it->second.dirty = true;  // conservative: hand-out implies possible write
  return it->second.ptr;
}

int pam_interface_get_array_rank(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  return it == e.end() ? -1 : static_cast<int>(it->second.dims.size());
}

void pam_interface_get_array_dims(const char *name, int *dims_out) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  if (it == e.end()) return;
  for (size_t i = 0; i < it->second.dims.size(); ++i)
    dims_out[i] = it->second.dims[i];
}

int pam_interface_get_array_dtype(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  return it == e.end() ? -1 : static_cast<int>(it->second.dtype);
}

int pam_interface_array_readonly(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  return it == e.end() ? -1 : (it->second.readonly ? 1 : 0);
}

void pam_interface_make_readonly(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  if (it != e.end()) it->second.readonly = true;
}

// dirty tracking (the reference DataManager's module-tracing hook,
// DataManager.h:239-271)
void pam_interface_clean_all_entries() {
  for (auto &kv : coupler().entries) kv.second.dirty = false;
}

int pam_interface_entry_dirty(const char *name) {
  auto &e = coupler().entries;
  auto it = e.find(name);
  return it == e.end() ? -1 : (it->second.dirty ? 1 : 0);
}

// validators (ref: DataManager validate_nan/inf/pos, DataManager.h:411-466).
// Returns number of offending values; works for float/double entries.
int64_t pam_interface_validate_array(const char *name, int check_nan,
                                     int check_inf, int check_pos) {
  auto &es = coupler().entries;
  auto it = es.find(name);
  if (it == es.end()) return -1;
  const Entry &e = it->second;
  int64_t bad = 0;
  auto check = [&](auto *p) {
    for (size_t i = 0; i < e.count(); ++i) {
      double v = static_cast<double>(p[i]);
      if (check_nan && std::isnan(v)) ++bad;
      else if (check_inf && std::isinf(v)) ++bad;
      else if (check_pos && v < 0) ++bad;
    }
  };
  if (e.dtype == DType::Double) check(static_cast<double *>(e.ptr));
  else if (e.dtype == DType::Float) check(static_cast<float *>(e.ptr));
  else return -2;
  return bad;
}

// ------------------------------------------------------------------ options
void pam_interface_set_option_bool(const char *name, bool v) {
  coupler().options.set(name, v);
}
void pam_interface_set_option_int(const char *name, int v) {
  coupler().options.set(name, static_cast<int64_t>(v));
}
void pam_interface_set_option_int64(const char *name, long long v) {
  // full-width integer setter for hosts with 64-bit option values
  // (timestamps, step counts); the int overload keeps the reference's
  // Fortran-facing ABI
  coupler().options.set(name, static_cast<int64_t>(v));
}
void pam_interface_set_option_double(const char *name, double v) {
  coupler().options.set(name, v);
}
void pam_interface_set_option_float(const char *name, float v) {
  coupler().options.set(name, static_cast<double>(v));
}
void pam_interface_set_option_string(const char *name, const char *v) {
  coupler().options.set(name, std::string(v));
}

// Getters must not throw across the extern "C"/FFI boundary (that would
// std::terminate the host process with no catchable error): missing or
// wrong-typed lookups return a zero value; callers that need a hard
// failure query pam_interface_get_option_type first (the ctypes bridge
// does, raising KeyError/TypeError on the Python side).
int pam_interface_get_option_type(const char *name) {
  auto &vals = coupler().options.values;
  auto it = vals.find(name);
  if (it == vals.end()) return -1;
  return static_cast<int>(it->second.index());  // 0 bool, 1 int64,
                                                // 2 double, 3 string
}
bool pam_interface_get_option_bool(const char *name) {
  auto &vals = coupler().options.values;
  auto it = vals.find(name);
  if (it == vals.end() || !std::holds_alternative<bool>(it->second))
    return false;
  return std::get<bool>(it->second);
}
long long pam_interface_get_option_int64(const char *name) {
  auto &vals = coupler().options.values;
  auto it = vals.find(name);
  if (it == vals.end() || !std::holds_alternative<int64_t>(it->second))
    return 0;
  return static_cast<long long>(std::get<int64_t>(it->second));
}
int pam_interface_get_option_int(const char *name) {
  return static_cast<int>(pam_interface_get_option_int64(name));
}
double pam_interface_get_option_double(const char *name) {
  auto &vals = coupler().options.values;
  auto it = vals.find(name);
  if (it == vals.end()) return 0.0;
  auto &v = it->second;
  if (std::holds_alternative<int64_t>(v))
    return static_cast<double>(std::get<int64_t>(v));
  if (!std::holds_alternative<double>(v)) return 0.0;
  return std::get<double>(v);
}
float pam_interface_get_option_float(const char *name) {
  return static_cast<float>(pam_interface_get_option_double(name));
}
void pam_interface_get_option_string(const char *name, char *out, int maxlen) {
  auto &vals = coupler().options.values;
  auto it = vals.find(name);
  if (it == vals.end() || !std::holds_alternative<std::string>(it->second)) {
    if (maxlen > 0) out[0] = '\0';
    return;
  }
  const auto &s = std::get<std::string>(it->second);
  std::strncpy(out, s.c_str(), maxlen - 1);
  out[maxlen - 1] = '\0';
}

int pam_interface_option_is_set(const char *name) {
  return coupler().options.values.count(name) ? 1 : 0;
}
void pam_interface_remove_option(const char *name) {
  coupler().options.values.erase(name);
  coupler().options.readonly.erase(name);
}
void pam_interface_make_option_readonly(const char *name) {
  coupler().options.readonly[name] = true;
}

}  // extern "C"
