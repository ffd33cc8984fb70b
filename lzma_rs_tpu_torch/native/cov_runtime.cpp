// Edge-coverage runtime for the instrumented native build (fuzzing).
//
// lzma_native.cpp is compiled with -fsanitize-coverage=trace-pc, which
// calls __sanitizer_cov_trace_pc() on every edge; this TU (compiled
// WITHOUT instrumentation, so the callback cannot recurse) records the
// edges in a bitmap keyed by the call site's offset from an anchor
// symbol — stable across loads of the same .so build, so arc ids can be
// persisted in the fuzz ledger alongside a build hash. Mirrors the
// reference's libFuzzer instrumentation of its decoder under test (its
// fuzz targets, fuzz/README.md:3-8) with a
// poor-man's in-process query API instead of the libFuzzer harness.

#include <cstdint>
#include <cstring>

extern "C" {

enum { kLrtCovBits = 17, kLrtCovSize = 1 << kLrtCovBits };
static unsigned char lrt_cov_map[kLrtCovSize];
static int lrt_cov_enabled = 0;

void lrt_cov_anchor() {}

void __sanitizer_cov_trace_pc() {
  if (!lrt_cov_enabled) return;
  uintptr_t pc = (uintptr_t)__builtin_return_address(0);
  uintptr_t off = pc - (uintptr_t)&lrt_cov_anchor;
  lrt_cov_map[(off >> 2) & (kLrtCovSize - 1)] = 1;
}

void lrt_cov_enable(int on) { lrt_cov_enabled = on; }

void lrt_cov_reset() { memset(lrt_cov_map, 0, sizeof lrt_cov_map); }

// Write the set bitmap indices into out (up to cap); returns the count.
int lrt_cov_snapshot(int32_t* out, int cap) {
  int n = 0;
  for (int i = 0; i < kLrtCovSize; i++) {
    if (lrt_cov_map[i]) {
      if (n < cap) out[n] = i;
      n++;
    }
  }
  return n < cap ? n : cap;
}

}  // extern "C"
