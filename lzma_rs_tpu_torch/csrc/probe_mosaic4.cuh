// One lane and one rank of the mosaic4 probe kernel: the per-lane step of
// the JAX package's Pallas probes tools/probe_mosaic4.py (build and
// build2), in scalar code, and the per-rank pieces of a block's shared
// work (the table's fill, a round's refill, a step's resets, the
// write-back).
//
// Compiled for the card by probes_mosaic4.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic4.cu as host loops over blocks, their ranks
// and their lanes, in an order the card's barriers allow (every rank's
// fill before any step; a round's refill by all 32 ranks before its
// steps; each step of every lane, then the warp's resets of that step by
// all 32 ranks), so the logic is checked on the CPU against the plain
// PyTorch version (ops/probes_mosaic4.py).
//
// Integer semantics are the probe's: wrapping int32 (every add that can
// wrap is done in uint32_t and converted back), and `%` and `//` are
// jnp's floor mod and floor division of a wrapped int32 (lzm::floor_mod,
// shared with probe_mosaic.cuh); by a power of two they are an and and an
// arithmetic shift.
#ifndef LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_

#include "probe_mosaic.cuh"

namespace lzm4 {

using lzm::floor_mod;
using lzm::wrap;

constexpr int kLanes = 8;        // lanes a block
constexpr int kWarp = 32;        // the chain warp's threads
constexpr int kCopies = kWarp / kLanes;  // threads that run each lane
constexpr int kThreads = 128;    // threads a block: all fill, write back
constexpr int kW = 512;          // table rows ([512, L], lane-minor)
constexpr int kFill = 7;         // the table's value at the start
constexpr int kReset = 0x400;    // the reset value (LZMA's initial prob)
constexpr int kResetEvery = 17;  // reset where acc % 17 == 0
constexpr int kTile = 64;        // tile rows: two chunks
constexpr int kChunk = 32;       // rows per chunk
constexpr int kChunks = 4;       // chunks 0-3: rows 0-127 (W // 128)
constexpr int kRowOfShift = 7;   // the refill's row0 = idx // 128
constexpr int kRound = 16;       // steps per outer round
constexpr int kSched = 8;        // build2: rows of k
constexpr uint32_t kAll = 0xFFFFFFFFu;  // a warp's threads
constexpr uint32_t kLaneMask = (1u << kLanes) - 1;  // a block's lanes
constexpr int ERR_ARGS = -1;     // a bad argument: nothing was launched

// build's variants: base; when_reset and when_reset_hoisted (one function:
// the block-wide guard of when_reset changes no result); when_reset_refed
// (the flags through the tile's row 0). build2's: max(k[ci], 0), k[ci],
// and the sum of k[r] (ci == r) over the 8 rows.
enum {
  MODE_BASE = 0,
  MODE_RESET = 1,
  MODE_RESET_REFED = 2,
  MODE_SCHED_MAX = 3,
  MODE_SCHED_SUM = 4,
  MODE_SCHED_BLEND = 5,
};

LZM_FN constexpr bool refills(int mode) { return mode < MODE_SCHED_MAX; }
LZM_FN constexpr bool resets(int mode) {
  return mode == MODE_RESET || mode == MODE_RESET_REFED;
}

// A block's shared memory: its lanes' table [kW, kLanes], 32 bytes a row,
// then, for build, the tile [kTile, kLanes]. Lane f's word of table row r
// sits in slot f ^ ((r / 4) & sw) of the row. The reset variants swizzle
// (sw = 7: a lane's 32 consecutive rows lie in 32 banks, so the warp writes
// a flagged lane's column together); the others do not (sw = 0: row r of
// lane f in bank 8 (r % 4) + f, a lane's column in 4 banks). Each is the
// faster on the H100 (PERF.md): unswizzled, the resets' seeded input took
// 534-595 cycles a step against 252-256; swizzled, base and build2 were
// 0-3% slower.
LZM_FN int block_words(int mode) {
  return kW * kLanes + (refills(mode) ? kTile * kLanes : 0);
}
constexpr int kSwizzle = kLanes - 1;  // the reset variants' sw
LZM_FN constexpr int swizzle_of(int mode) {
  return resets(mode) ? kSwizzle : 0;
}
constexpr uint32_t kTileBytes = kW * kLanes * 4;  // the tile's offset

// Lane f's word of table row r: its byte offset in the block's memory.
LZM_FN uint32_t slot(int32_t r, int f, int sw) {
  return (uint32_t(r) << 5) + (uint32_t(f ^ ((r >> 2) & sw)) << 2);
}

// The block's shared memory as the chain's lanes reach it: byte offsets
// from its base. On the card the base is a shared-space address held in a
// register and the accesses are ld/st.shared (as C loads through the
// extern array, ptxas rebuilt the array's address with an S2R in every
// step, on the chain); volatile and ordered, as the card runs them. On
// the host, a pointer.
struct Shared {
  uintptr_t base;  // the card: a shared-space address; the host: a pointer
#if defined(__CUDA_ARCH__)
  LZM_FN int32_t ld(uint32_t off) const {
    int32_t v;
    asm volatile("ld.shared.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(uint32_t(base) + off)
                 : "memory");
    return v;
  }
  LZM_FN void st(uint32_t off, int32_t v) const {
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(uint32_t(base) + off),
                 "r"(v)
                 : "memory");
  }
  // 16 bytes of v at a 16-byte aligned offset
  LZM_FN void st4(uint32_t off, int32_t v) const {
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(
                     uint32_t(base) + off),
                 "r"(v)
                 : "memory");
  }
#else
  LZM_FN int32_t ld(uint32_t off) const {
    return *reinterpret_cast<const int32_t*>(base + off);
  }
  LZM_FN void st(uint32_t off, int32_t v) const {
    *reinterpret_cast<int32_t*>(base + off) = v;
  }
  LZM_FN void st4(uint32_t off, int32_t v) const {
    for (int i = 0; i < 4; ++i) st(off + 4 * i, v);
  }
#endif
};

// A lane's carried state: idx and acc.
struct Lane {
  int32_t idx;
  uint32_t acc;
};

LZM_FN Lane load_lane(const int32_t* start, size_t L, int lane) {
  return Lane{start[lane], uint32_t(start[L + lane])};
}

LZM_FN void store_lane(int32_t* state, size_t L, int lane, const Lane& s) {
  state[lane] = s.idx;
  state[L + lane] = wrap(s.acc);
}

// Rank t's share of a round's refill (the chain warp's 32 ranks share
// it): lane f = t % 8's tile rows j = q, q + 4, ..., q + 60 (q = t / 8),
// tile[32 c + jj] = chunk (row0 + c) of rows 0-127 (zeros outside), row0
// = idx // 128 (idx: lane f's). A warp's loads and stores of one j lie in
// 32 banks. Its 16 words are loaded first and stored after, so the loads
// are in flight together.
LZM_FN void refill_rank(const Shared& sm, int t, int sw, int32_t idx) {
  constexpr int kPer = kTile / kCopies;  // 16
  const int f = t % kLanes, q = t / kLanes;
  const int32_t row0 = idx >> kRowOfShift;  // |row0| < 2^24: no wrap below
  int32_t w[kPer];
  LZM_UNROLL(unroll)
  for (int i = 0; i < kPer; ++i) {
    const int j = q + kCopies * i;
    const int32_t c = row0 + j / kChunk;
    const bool in = c >= 0 && c < kChunks;
    const int32_t v = sm.ld(slot((in ? c : 0) * kChunk + j % kChunk, f, sw));
    w[i] = in ? v : 0;  // the load unconditional, the value picked after
  }
  LZM_UNROLL(unroll)
  for (int i = 0; i < kPer; ++i)
    sm.st(kTileBytes + uint32_t(((q + kCopies * i) * kLanes + f) * 4), w[i]);
}

// One step of the probe's loop for lane f of the block (lane `lane` of
// L; k: build2's [8, L] input), in each of the lane's threads (they load
// the same words and store the same values; on the card a __syncwarp
// between the load and the store orders every copy's load before any
// copy's store, so no copy reads a sibling's store of this step):
//   v = tab[idx] (0 when idx is outside [0, 512): the one-hot is empty);
//   build: tab[idx] = v + 1 where acc > 0; build2: v += the k term of
//   row ci = clip(acc, 0, 7), loaded ahead of the table (it depends on
//   acc alone);
//   idx = (idx + v) % 512 (an and: jnp's floor mod by a power of two of
//   the wrapped sum); acc += 1.
// After a step idx lies in [0, 512), so only a run's first step asks
// whether it does (kCheck); the others load unconditionally (a load under
// the test became a predicated one, its address rebuilt behind the test,
// on the chain).
template <int kMode, bool kCheck>
LZM_FN void step(const Shared& sm, int f, const int32_t* k, size_t L,
                 int lane, Lane& s) {
  uint32_t term = 0;
  if (!refills(kMode)) {
    const int32_t a = int32_t(s.acc);
    const int32_t ci = a < 0 ? 0 : a > kSched - 1 ? kSched - 1 : a;
    if (kMode == MODE_SCHED_MAX) {
      const int32_t kv = k[ci * L + lane];
      term = uint32_t(kv > 0 ? kv : 0);
    } else if (kMode == MODE_SCHED_SUM) {
      term = uint32_t(k[ci * L + lane]);
    } else {  // the probe's blend: every row, where ci == r
      // Written as a select: as a product k[r] * (ci == r) (or an and
      // with a mask of it), ptxas of CUDA 12.9 at its default -O3 added
      // wrong rows at some steps on the H100 (right at -Xptxas -O0, and
      // right in this form).
      LZM_UNROLL(unroll)
      for (int r = 0; r < kSched; ++r)
        term += ci == r ? uint32_t(k[r * L + lane]) : 0u;
    }
  }
  const uint32_t at =
      slot(kCheck ? s.idx & (kW - 1) : s.idx, f, swizzle_of(kMode));
  uint32_t v = uint32_t(sm.ld(at));
  bool write = refills(kMode) && int32_t(s.acc) > 0;
  if (kCheck) {
    const bool in = uint32_t(s.idx) < uint32_t(kW);
    v = in ? v : 0u;
    write = write && in;
  }
#if defined(__CUDA_ARCH__)
  if (refills(kMode)) __syncwarp();
#endif
  if (write) sm.st(at, wrap(v + 1u));
  s.idx = wrap(uint32_t(s.idx) + v + term) & (kW - 1);
  s.acc += 1u;
}

// The reset variants' flag of the step that leaves acc: acc % 17 == 0.
LZM_FN bool reset_flag(uint32_t acc) {
  return floor_mod(int32_t(acc), kResetEvery) == 0;
}

// when_reset_refed's flag of lane f, written to the tile's row 0 and read
// back.
LZM_FN bool through_tile(const Shared& sm, int f, bool flag) {
  const uint32_t at = kTileBytes + uint32_t(f * 4);
  sm.st(at, flag);
  return sm.ld(at) == 1;
}

LZM_FN int lowest_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Rank t's stores of a step's resets (the reset variants' swizzled
// table), the warp's flags in `mask` (bit f: lane f's column becomes
// 0x400). Where every lane flags, the whole table is 0x400: the ranks
// write it in 16-byte stores, rank t the chunks t, t + 32, ... Else the
// ranks write each flagged lane's column together, rank t rows t, t + 32,
// ...: those lie in bank 8 (t % 4) + (f ^ (t / 4)), so a warp's 32 stores
// of a lane lie in 32 banks.
LZM_FN void reset_rank(const Shared& sm, uint32_t mask, int t) {
  if (mask == kLaneMask) {
    LZM_UNROLL(unroll 8)
    for (int i = t; i < kW * kLanes / 4; i += kWarp)
      sm.st4(uint32_t(i) * 16, kReset);
    return;
  }
  for (uint32_t m = mask; m != 0u; m &= m - 1u) {
    const int f = lowest_bit(m);
    LZM_UNROLL(unroll)
    for (int i = 0; i < kW / kWarp; ++i)
      sm.st(slot(t + kWarp * i, f, kSwizzle), kReset);
  }
}

// Rank `tid` of `nt`: the table to kFill and the tile to 0 (both whole
// 16-byte chunks).
LZM_FN void fill_rank(int32_t* sm, int mode, int tid, int nt) {
  const int n_tab = kW * kLanes, n_all = block_words(mode);
#if defined(__CUDA_ARCH__)
  int4* const q = reinterpret_cast<int4*>(sm);
  for (int i = tid; i < n_all / 4; i += nt)
    q[i] = i < n_tab / 4 ? make_int4(kFill, kFill, kFill, kFill)
                         : make_int4(0, 0, 0, 0);
#else
  for (int i = tid * 4; i < n_all; i += nt * 4)
    for (int j = 0; j < 4; ++j) sm[i + j] = i < n_tab ? kFill : 0;
#endif
}

// Rank `tid` of `nt` writes its share of the block's table, and tile where
// one is asked for, into tab ([kW, L]) and tile ([kTile, L]) after the
// block's barrier: 32 bytes a row.
LZM_FN void write_back_rank(int32_t* tab, int32_t* tile, const int32_t* sm,
                            int sw, size_t L, int lane0, int nl, int tid,
                            int nt) {
  for (int i = tid; i < kW * kLanes; i += nt) {
    const int r = i / kLanes, f = i % kLanes;
    if (f < nl) tab[r * L + lane0 + f] = sm[slot(r, f, sw) / 4];
  }
  if (tile == nullptr) return;
  const int32_t* const st = sm + kW * kLanes;
  for (int i = tid; i < kTile * kLanes; i += nt) {
    const int r = i / kLanes, f = i % kLanes;
    if (f < nl) tile[r * L + lane0 + f] = st[i];
  }
}

// A bad argument: mode out of range, no lane, a negative limit; build2
// without k or with a tile; build with a table and no tile to write back
// or the reverse.
LZM_FN bool bad_table(int mode, const int32_t* k, const int32_t* tab,
                      const int32_t* tile, int L, int limit) {
  if (mode < MODE_BASE || mode > MODE_SCHED_BLEND || L < 1 || limit < 0)
    return true;
  return refills(mode) ? (tab == nullptr) != (tile == nullptr)
                       : k == nullptr || tile != nullptr;
}

}  // namespace lzm4

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_mosaic4.cu's C interface as host loops over blocks, ranks and
// lanes (tests only). The stream argument is ignored.
#include <vector>

namespace lzm4 {

// The chain warp of one block: a round's refill by its 32 ranks, then
// each step of every lane and the step's resets by the 32 ranks, as the
// card's __syncwarp orders them. A lane's copies are one lane here; a
// lane past nl runs no chain (on the card its threads run one on its own
// column, which nothing reads).
template <int kMode>
int32_t host_warp(int32_t* sm, const int32_t* k, size_t L, int lane0,
                  int nl, Lane* st, int32_t it, int32_t limit) {
  constexpr int sw = swizzle_of(kMode);
  const Shared m{reinterpret_cast<uintptr_t>(sm)};
  bool first = true;
  while (it < limit) {
    if (refills(kMode))
      for (int t = 0; t < kWarp; ++t)
        if (t % kLanes < nl) refill_rank(m, t, sw, st[t % kLanes].idx);
    for (int j = 0; j < kRound; ++j) {
      uint32_t mask = 0;
      for (int f = 0; f < nl; ++f) {
        if (first)
          step<kMode, true>(m, f, k, L, lane0 + f, st[f]);
        else
          step<kMode, false>(m, f, k, L, lane0 + f, st[f]);
        bool flag = resets(kMode) && reset_flag(st[f].acc);
        if (kMode == MODE_RESET_REFED) flag = through_tile(m, f, flag);
        if (flag) mask |= 1u << f;
      }
      first = false;
      if (mask)
        for (int t = 0; t < kWarp; ++t) reset_rank(m, mask, t);
      it = wrap(uint32_t(it) + 1u);
    }
  }
  return it;
}

}  // namespace lzm4

extern "C" {

int lzm4_table_chain(int mode, const int32_t* k, int L, const int32_t* start,
                     int32_t* tab, int32_t* tile, int32_t* state,
                     const int32_t* it0, int32_t* it_out, int limit,
                     void* /*stream*/) {
  using namespace lzm4;
  if (bad_table(mode, k, tab, tile, L, limit)) return ERR_ARGS;
  const int sw = swizzle_of(mode);
  const size_t sL = size_t(L);
  std::vector<int32_t> sm(size_t(block_words(mode)));
  for (int b = 0; b <= (L - 1) / kLanes; ++b) {
    const int lane0 = b * kLanes;
    const int nl = L - lane0 < kLanes ? L - lane0 : kLanes;
    for (int r = 0; r < kThreads; ++r)
      fill_rank(sm.data(), mode, r, kThreads);
    Lane st[kLanes];
    for (int t = 0; t < nl; ++t) st[t] = load_lane(start, sL, lane0 + t);
    int32_t it = 0;
    switch (mode) {
#define LZM4_CASE(m)                                                      \
  case m:                                                                 \
    it = host_warp<m>(sm.data(), k, sL, lane0, nl, st, *it0, limit);      \
    break;
      LZM4_CASE(MODE_BASE)
      LZM4_CASE(MODE_RESET)
      LZM4_CASE(MODE_RESET_REFED)
      LZM4_CASE(MODE_SCHED_MAX)
      LZM4_CASE(MODE_SCHED_SUM)
      LZM4_CASE(MODE_SCHED_BLEND)
#undef LZM4_CASE
    }
    for (int t = 0; t < nl; ++t) store_lane(state, sL, lane0 + t, st[t]);
    if (tab != nullptr)
      for (int r = 0; r < kThreads; ++r)
        write_back_rank(tab, tile, sm.data(), sw, sL, lane0, nl, r,
                        kThreads);
    if (b == 0) *it_out = it;
  }
  return 0;
}

const char* lzm4_error_string(int code) {
  return code == lzm4::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_
