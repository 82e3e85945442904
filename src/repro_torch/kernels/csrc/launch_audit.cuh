// Launch records for the kernel audit (src/repro_torch/analysis/
// kernel_audit.py).  While recording is on, every launch site notes the
// kernel instantiation it launches, its block size and the dynamic shared
// memory it requests; `<prefix>_audit_entry` then reports, for each noted
// instantiation, what cudaFuncGetAttributes says of it (static shared
// bytes, registers, local bytes) and the blocks an SM holds at that launch
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Off, a note is one
// branch.  Each library keeps its own table (internal linkage).
#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

#include <atomic>
#include <mutex>

namespace {
namespace launch_audit {

struct Entry {
  const void* fn;
  int threads;
  int dyn_smem;
  char name[112];
};

constexpr int MAX_ENTRIES = 128;
std::atomic<int> g_on{0};
int g_n = 0;
int g_overflow = 0;
Entry g_entries[MAX_ENTRIES];
std::mutex g_mu;

template <typename... A>
void note(const void* fn, int threads, int dyn_smem, const char* fmt,
          A... args) {
  if (!g_on) return;
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_n; ++i)
    if (g_entries[i].fn == fn && g_entries[i].threads == threads &&
        g_entries[i].dyn_smem == dyn_smem)
      return;
  if (g_n == MAX_ENTRIES) {
    g_overflow = 1;
    return;
  }
  Entry& e = g_entries[g_n++];
  e.fn = fn;
  e.threads = threads;
  e.dyn_smem = dyn_smem;
  if constexpr (sizeof...(A) == 0)
    snprintf(e.name, sizeof(e.name), "%s", fmt);
  else
    snprintf(e.name, sizeof(e.name), fmt, args...);
}

// The name of an element type in an instantiation's name.
template <typename T>
const char* dtype_name() {
  return sizeof(T) == 2 ? "bf16" : "f32";
}

// vals: static shared bytes, dynamic shared bytes, registers a thread,
// local bytes a thread, threads a block, blocks an SM holds, the kernel's
// largest block and its binary's SM version.  0 on success, else a
// cudaError_t value (or -1 for an index past the table).
int entry(int i, char* name, int name_len, int* vals) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (i < 0 || i >= g_n) return -1;
  const Entry& e = g_entries[i];
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, e.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, e.fn,
                                                      e.threads, e.dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  snprintf(name, name_len, "%s", e.name);
  vals[0] = static_cast<int>(fa.sharedSizeBytes);
  vals[1] = e.dyn_smem;
  vals[2] = fa.numRegs;
  vals[3] = static_cast<int>(fa.localSizeBytes);
  vals[4] = e.threads;
  vals[5] = per_sm;
  vals[6] = fa.maxThreadsPerBlock;
  vals[7] = fa.binaryVersion;
  return 0;
}

}  // namespace launch_audit
}  // namespace

// At a launch site, just before the launch: the kernel, its block size, the
// dynamic shared bytes requested, and a printf-style name of the
// instantiation.
#define LAUNCH_AUDIT(fn, threads, dyn_smem, ...)                            \
  launch_audit::note((const void*)(fn),                                      \
                     static_cast<int>(threads), static_cast<int>(dyn_smem), \
                     __VA_ARGS__)

// The C entry points of one library: `<prefix>_audit_record(on)` turns
// recording on (clearing the table) or off; `<prefix>_audit_count()` is
// the number of noted instantiations (-1 if the table overflowed);
// `<prefix>_audit_entry(i, name, name_len, vals)` as launch_audit::entry.
#define LAUNCH_AUDIT_EXPORTS(prefix)                                       \
  extern "C" void prefix##_audit_record(int on) {                          \
    std::lock_guard<std::mutex> lock(launch_audit::g_mu);                  \
    if (on) {                                                              \
      launch_audit::g_n = 0;                                               \
      launch_audit::g_overflow = 0;                                        \
    }                                                                      \
    launch_audit::g_on = on;                                               \
  }                                                                        \
  extern "C" int prefix##_audit_count() {                                  \
    std::lock_guard<std::mutex> lock(launch_audit::g_mu);                  \
    return launch_audit::g_overflow ? -1 : launch_audit::g_n;              \
  }                                                                        \
  extern "C" int prefix##_audit_entry(int i, char* name, int name_len,     \
                                      int* vals) {                         \
    return launch_audit::entry(i, name, name_len, vals);                   \
  }
