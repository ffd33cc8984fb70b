// One lane of each probe kernel: the per-lane functions of the JAX
// package's Pallas probes tools/probe_lane2d.py and
// tools/probe_state_in_ref.py, in scalar code.
//
// Compiled for the card by probes.cu (one thread per lane) and, as a test
// aid, for the host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also
// defines the C interface of probes.cu as host loops over lanes, so the
// logic is checked on the CPU against the plain PyTorch versions
// (ops/probes.py). tinyops and the bit decode are one dependent chain a
// lane, timed as they are; a tiny-op round forms its successor's a - d for
// both outcomes of d's select before the compare that picks one
// (tiny_round), so four instructions, not five, lie from one round's a to
// the next, and every register stays what the probe computes; y4 runs
// the same rounds. bitdecode_chain's lane likewise loads the next
// iteration's table word for both outcomes of the bit before it resolves
// (bitdecode_lane); probe_bisect.cuh's bodies keep the whole step on one
// chain (climb_clip, decode_bit, shift_in). y4's lane unrolls its rounds
// as the TPU traced them and overlaps each iteration's loads with the next
// one's rounds (realweight_lane), the same code on the host.
//
// Integer semantics are the probes': wrapping int32 and uint32. Signed
// overflow is undefined in C++ and the compilers optimise on it, so every
// add, subtract and left shift that can wrap is done in uint32_t and
// converted back. The conversion uint32_t -> int32_t is modular on g++ and
// nvcc (and defined so from C++20), and so is >> of a negative int32_t
// (arithmetic), which the table update p - (p >> 5) needs.
#ifndef LZMA_RS_TPU_TORCH_PROBE_LANE_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_LANE_CUH_

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define LZP_FN __host__ __device__ inline
#else
#define LZP_FN inline
#endif

namespace lzp {

constexpr int kRows = 648;   // the probes' table rows (ROWS)
constexpr int kRing = 512;   // y4's ring window rows
constexpr int kTinyRounds = 50;  // tinyops rounds per iteration (150 ops)
constexpr int kBlock = 64;   // lanes per block, and per shared-memory table
static_assert((-64 >> 5) == -2, "needs an arithmetic >> of int32");

LZP_FN int32_t wrap(uint32_t v) { return static_cast<int32_t>(v); }

// The "tiny op" chain's registers, and e = a - d (wrapped): a round's a
// where b <= k & 7, formed by the round before.
struct Tiny {
  int32_t a, b, d, e;
};

LZP_FN Tiny tiny_start(int32_t a, int32_t b, int32_t d) {
  return Tiny{a, b, d, wrap(uint32_t(a) - uint32_t(d))};
}

// One round of the chain (k is the round index), as the probe writes it:
//   a = b > (k & 7) ? a + 1 : a - d
//   b = (b ^ a) & 0xFFFF
//   d = a > b ? d | 1 : d << 1
// The next round's a - d is formed for both outcomes of d's select as soon
// as a is known (e1 = a - (d | 1), e2 = a - (d << 1)), so the compare
// a > b picks between values already there. From one round's a to the
// next: the xor and mask (one LOP3), the compare (ISETP), e's select and
// a's select (on the H100 a predicated IADD and a predicated VIADD), four
// dependent instructions where the plain form has five or more; a + 1,
// d | 1, d << 1, the two differences and the compare of b with k & 7 run
// beside them. On the card the round is one inline-PTX block: written as
// C, nvcc folds e's select of two differences of a into a - (d's select),
// or ptxas splits the xor from the mask, each a step more on the chain
// (on the H100 the C form took 28.7 cycles a round, this block 24.7;
// PERF.md).
LZP_FN void tiny_round(Tiny& t, int k) {
  const int32_t d1 = t.d | 1, d2 = wrap(uint32_t(t.d) << 1);
  const int32_t a1 = wrap(uint32_t(t.a) + 1u);
#if defined(__CUDA_ARCH__)
  int32_t a, b, d, e;
  asm("{\n\t.reg .pred q, p;\n\t.reg .b32 e1, e2;\n\t"
      "setp.gt.s32 q, %4, %9;\n\t"          // q = b > (k & 7)
      "selp.b32 %0, %8, %5, q;\n\t"         // a = q ? a + 1 : e
      "lop3.b32 %1, %4, %0, %10, 0x28;\n\t"  // b = (b ^ a) & 0xFFFF
      "setp.gt.s32 p, %0, %1;\n\t"          // p = a > b
      "sub.s32 e1, %0, %6;\n\t"
      "sub.s32 e2, %0, %7;\n\t"
      "selp.b32 %2, %6, %7, p;\n\t"         // d = p ? d | 1 : d << 1
      "selp.b32 %3, e1, e2, p;\n\t}"        // e = a - d
      : "=&r"(a), "=&r"(b), "=&r"(d), "=&r"(e)
      : "r"(t.b), "r"(t.e), "r"(d1), "r"(d2), "r"(a1), "r"(k & 7),
        "r"(0xFFFF));
  t = Tiny{a, b, d, e};
#else
  t.a = t.b > (k & 7) ? a1 : t.e;
  t.b = (t.b ^ t.a) & 0xFFFF;
  const bool p = t.a > t.b;
  t.e = p ? wrap(uint32_t(t.a) - uint32_t(d1))
          : wrap(uint32_t(t.a) - uint32_t(d2));
  t.d = p ? d1 : d2;
#endif
}

// tinyops_only_1d / _2d: a = x, b = x + 1, d = x + 2, then `iters`
// iterations of kTinyRounds rounds. The rounds unroll, as the Python loop
// of the Pallas kernel does.
LZP_FN void tinyops_lane(int32_t x, int iters, int32_t* out_a,
                         int32_t* out_b, int32_t* out_d) {
  Tiny t = tiny_start(x, wrap(uint32_t(x) + 1u), wrap(uint32_t(x) + 2u));
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int it = 0; it < iters; ++it) {
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int k = 0; k < kTinyRounds; ++k) tiny_round(t, k);
  }
  *out_a = t.a;
  *out_b = t.b;
  *out_d = t.d;
}

// Table placements (the template parameter of the bit-decode step).
// Lane-minor: row r of a lane at row0[r * stride]; the TPU probe's
// [ROWS, L] layout in device memory (stride L), and the shared-memory
// table of a block (stride kBlock).
struct LaneMinorTable {
  int32_t* row0;
  int stride;
  LZP_FN int32_t load(int r) const { return row0[size_t(r) * stride]; }
  LZP_FN void store(int r, int32_t v) const { row0[size_t(r) * stride] = v; }
  // Row r's word, its offset in 32-bit arithmetic, for bitdecode_lane
  // (load and store keep their size_t offsets): r x stride < 2^31 because
  // lzp_bitdecode refuses more than kMaxLanes lanes (bad_bitdecode).
  LZP_FN int32_t* at(int r) const { return row0 + r * stride; }
};

// Lane-major: a lane's rows are contiguous ([L, ROWS]), the decoder's own
// layout (probs + l * nprobs in lzma_lane.cuh).
struct LaneMajorTable {
  int32_t* row0;
  LZP_FN int32_t load(int r) const { return row0[r]; }
  LZP_FN void store(int r, int32_t v) const { row0[r] = v; }
  LZP_FN int32_t* at(int r) const { return row0 + r; }
};

// The bit-decode state (idx, acc, rng, cod).
struct BitState {
  int32_t idx, acc;
  uint32_t rng, cod;
};

// State placements. In registers: loaded once, stored once.
struct RegState {
  BitState s;
  LZP_FN BitState load() const { return s; }
  LZP_FN void store(const BitState& v) { s = v; }
};

// In memory, loaded and stored every iteration (y1: slots of one [NST, L]
// array; y2: four [L] arrays). The pointers are volatile, so the compiler
// can neither keep the state in registers across iterations nor drop a
// store: every iteration reads and writes the four words.
struct MemState {
  volatile int32_t *idx, *acc, *rng, *cod;
  LZP_FN BitState load() const {
    return BitState{*idx, *acc, uint32_t(*rng), uint32_t(*cod)};
  }
  LZP_FN void store(const BitState& v) {
    *idx = v.idx;
    *acc = v.acc;
    *rng = wrap(v.rng);
    *cod = wrap(v.cod);
  }
};

// One range-coder-shaped bit at table row s.idx: read p, decide the bit
// against cod, adapt p and write it back, update rng and cod. Returns the
// bit; acc is the caller's.
template <class Tab>
LZP_FN uint32_t decode_bit(const Tab& tab, BitState& s) {
  const int32_t p = tab.load(s.idx);
  const uint32_t bound = (s.rng >> 11) * uint32_t(p & 0x7FF);
  const uint32_t bit = s.cod >= bound ? 1u : 0u;
  tab.store(s.idx, bit ? wrap(uint32_t(p) - uint32_t(p >> 5))
                       : wrap(uint32_t(p) + 3u));
  s.rng = bit ? s.rng - bound : (s.rng | 1u);
  s.cod ^= bit;
  return bit;
}

LZP_FN int32_t shift_in(int32_t acc, uint32_t bit) {
  const int32_t v = wrap((uint32_t(acc) << 1) | bit);
  return v > 0x100 ? 1 : v;
}

// The bit decode's climb and clip (bitdecode_1d / _2d and y1 / y2: idx
// += #{k < 10 : acc > k}, ten wrapping adds, then the clip to the table's
// rows) in closed form: the count is acc clamped to [0, 10], added to idx
// with the same int32 wrap, then clipped.
LZP_FN int32_t climb_clip(int32_t idx, int32_t acc) {
  const int32_t n = acc < 0 ? 0 : (acc > 10 ? 10 : acc);
  const int32_t c = wrap(uint32_t(idx) + uint32_t(n));
  return c < 0 ? 0 : (c > kRows - 1 ? kRows - 1 : c);
}

// bitdecode_chain's lane: `iters` iterations of the bit-decode step (the
// climb and clip, decode_bit, shift_in), the next iteration's table word
// loaded before this one's bit resolves. Its row
// depends only on idx and acc, and acc takes one of two values after the
// bit, so both candidate rows (c0 for a 0, c1 for a 1) are formed and
// loaded first; the bit then picks one. Those loads precede this
// iteration's store, so where the picked row is the row just stored (as
// on the probe's own input, where idx sits at the last row) the stored
// word is taken from registers. A warp issues in order, so the pick waits
// for its loads at the top of the next iteration, after that iteration's
// own candidate loads are issued: each load has an iteration to arrive.
// The loop is unrolled by 2, so the words loaded and the words picked sit
// in different registers and the loads can be issued ahead of the pick
// (unrolled by 1, nvcc gave both one register and the loads waited behind
// the pick). The chain an iteration is the range coder on the picked word
// and the bit's selects; the climb (climb_clip), the clip and the loads
// run beside it. The state is loaded and stored every iteration, as the
// probes do: in memory (MemState) that round trip stays on the chain, in registers (RegState) it is free. decode_bit's arithmetic
// on the picked word is inline: its new word is forwarded.
template <class Tab, class State>
LZP_FN void bitdecode_lane(const Tab& tab, State& st, int iters) {
  if (iters <= 0) return;
  BitState s = st.load();
  int32_t c = climb_clip(s.idx, s.acc);
  int32_t q0 = *tab.at(c), q1 = q0, np = 0;  // the first word, no forward
  uint32_t bit = 0, fwd = 0;
#if defined(__CUDACC__)
#pragma unroll 2
#endif
  for (int it = 0; it < iters; ++it) {
    const int32_t a0 = shift_in(s.acc, 0u), a1 = shift_in(s.acc, 1u);
    const int32_t c0 = climb_clip(c, a0), c1 = climb_clip(c, a1);
    const int32_t n0 = *tab.at(c0), n1 = *tab.at(c1);
    const int32_t p = fwd ? np : (bit ? q1 : q0);
    const uint32_t bound = (s.rng >> 11) * uint32_t(p & 0x7FF);
    bit = s.cod >= bound ? 1u : 0u;
    np = bit ? wrap(uint32_t(p) - uint32_t(p >> 5)) : wrap(uint32_t(p) + 3u);
    *tab.at(c) = np;
    s.rng = bit ? s.rng - bound : (s.rng | 1u);
    s.cod ^= bit;
    s.idx = c;
    s.acc = bit ? a1 : a0;
    st.store(s);
    const int32_t next = bit ? c1 : c0;
    fwd = next == c ? 1u : 0u;
    c = next;
    q0 = n0;
    q1 = n1;
    s = st.load();
  }
}

// y4's state: bit-decode state plus the tiny-op registers.
struct RealState {
  BitState s;
  int32_t a, b, d;
};

// `rounds` tiny-op rounds, as the TPU traced them: straight-line code with
// k & 7 a constant in each round (unrolled by 8, a branch once every 8
// rounds, then the tail's rounds % 8 rounds; k & 7 is the round's only use
// of k, and k = 8 n + j there).
LZP_FN void tiny_rounds(int32_t& a, int32_t& b, int32_t& d, int rounds) {
  Tiny t = tiny_start(a, b, d);
  int k = 0;
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (; k + 8 <= rounds; k += 8) {
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int j = 0; j < 8; ++j) tiny_round(t, j);
  }
  const int tail = rounds - k;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int j = 0; j < 7; ++j)
    if (j < tail) tiny_round(t, j);
  a = t.a;
  b = t.b;
  d = t.d;
}

// The loads of one y4 iteration, issued before the next iteration's rounds
// and consumed after them: the table word p at idx, the ring words w0 (at
// a & 511) and old (at q = b & 511).
struct RealLoads {
  int32_t p, w0, old;
  int q;
};

// A table row whose word was loaded ahead: decode_bit reads the held word
// and stores through the table.
struct HeldRow {
  LaneMinorTable tab;
  int32_t p;
  LZP_FN int32_t load(int) const { return p; }
  LZP_FN void store(int r, int32_t v) const { tab.store(r, v); }
};

// y4 (y5, y6), one iteration in two halves. realweight_issue, after the
// iteration's `rounds` tiny-op rounds (the probe's nops // 3): idx moved
// by a's low bit, and the loads of the bit-decode step's table word and
// of two ring words. The probe also reads w1 at (a + 1) & 511, but its
// value enters the merge masked to 0, so the result does not depend on it
// and it is not read. realweight_consume: the bit decode on the held word
// (the table's update stored), where the bit is 1 the ring row q's low
// byte replaced by w0's, and acc shifted.
LZP_FN RealLoads realweight_issue(const LaneMinorTable& tab,
                                  const LaneMinorTable& ring, RealState& r) {
  const int32_t idx = wrap(uint32_t(r.s.idx) + uint32_t(r.a & 1));
  r.s.idx = idx < 0 ? 0 : (idx > kRows - 1 ? kRows - 1 : idx);
  RealLoads ld;
  ld.p = tab.load(r.s.idx);
  ld.w0 = ring.load(r.a & (kRing - 1));
  ld.q = r.b & (kRing - 1);
  ld.old = ring.load(ld.q);
  return ld;
}

LZP_FN void realweight_consume(const LaneMinorTable& tab,
                               const LaneMinorTable& ring, RealState& r,
                               const RealLoads& ld) {
  const uint32_t bit = decode_bit(HeldRow{tab, ld.p}, r.s);
  if (bit) ring.store(ld.q, (ld.old & ~0xFF) | (ld.w0 & 0xFF));
  r.s.acc = shift_in(r.s.acc, bit);
}

// The state words of realweight's [7, L] state array, in this order.
enum { RW_IDX, RW_ACC, RW_RNG, RW_COD, RW_A, RW_B, RW_D };

LZP_FN RealState load_real(const int32_t* st, size_t L, size_t lane) {
  RealState r;
  r.s = BitState{st[RW_IDX * L + lane], st[RW_ACC * L + lane],
                 uint32_t(st[RW_RNG * L + lane]),
                 uint32_t(st[RW_COD * L + lane])};
  r.a = st[RW_A * L + lane];
  r.b = st[RW_B * L + lane];
  r.d = st[RW_D * L + lane];
  return r;
}

LZP_FN void store_real(int32_t* st, size_t L, size_t lane,
                       const RealState& r) {
  st[RW_IDX * L + lane] = r.s.idx;
  st[RW_ACC * L + lane] = r.s.acc;
  st[RW_RNG * L + lane] = wrap(r.s.rng);
  st[RW_COD * L + lane] = wrap(r.s.cod);
  st[RW_A * L + lane] = r.a;
  st[RW_B * L + lane] = r.b;
  st[RW_D * L + lane] = r.d;
}

// `iters` iterations of y4, pipelined by hand: iteration i's loads are
// issued, iteration i + 1's rounds run (they never read the loaded words
// or the bit: a, b and d do not depend on them), and only then is i
// consumed, so the loads' latency hides behind the rounds. i's table and
// ring stores precede i + 1's loads, which are issued after the consume.
LZP_FN void realweight_lane(int32_t* tab, int32_t* ring, int32_t* state,
                            int L, int lane, int iters, int rounds) {
  const LaneMinorTable t{tab + lane, L}, w{ring + lane, L};
  RealState r = load_real(state, size_t(L), size_t(lane));
  if (iters > 0) {
    tiny_rounds(r.a, r.b, r.d, rounds);
    RealLoads ld = realweight_issue(t, w, r);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
    for (int it = 1; it < iters; ++it) {
      tiny_rounds(r.a, r.b, r.d, rounds);
      realweight_consume(t, w, r, ld);
      ld = realweight_issue(t, w, r);
    }
    realweight_consume(t, w, r, ld);
  }
  store_real(state, size_t(L), size_t(lane), r);
}

// One bit-decode lane with its state in registers (kMem false: loaded
// from the four state arrays at the start, stored at the end) or in
// memory (kMem true: the arrays themselves, every iteration).
template <class Tab, bool kMem>
LZP_FN void bitdecode_run(const Tab& tab, int32_t* idx, int32_t* acc,
                          int32_t* rng, int32_t* cod, int lane, int iters) {
  if (kMem) {
    MemState st{idx + lane, acc + lane, rng + lane, cod + lane};
    bitdecode_lane(tab, st, iters);
  } else {
    RegState st{BitState{idx[lane], acc[lane], uint32_t(rng[lane]),
                         uint32_t(cod[lane])}};
    bitdecode_lane(tab, st, iters);
    idx[lane] = st.s.idx;
    acc[lane] = st.s.acc;
    rng[lane] = wrap(st.s.rng);
    cod[lane] = wrap(st.s.cod);
  }
}

// Table placements of lzp_bitdecode's `place` argument.
enum { PLACE_MINOR = 0, PLACE_MAJOR = 1, PLACE_SHARED = 2 };
constexpr int ERR_ARGS = -1;  // a bad argument: nothing was launched

LZP_FN bool bad_args(int L, int iters) { return L < 0 || iters < 0; }

// bitdecode_chain's table ([ROWS, L] or [L, ROWS]) is addressed in 32-bit
// offsets (at), so it holds fewer than 2^31 words: at most kMaxLanes lanes.
constexpr int kMaxLanes = INT32_MAX / kRows;  // 3,314,017

LZP_FN bool bad_bitdecode(int place, int L, int iters) {
  return bad_args(L, iters) || L > kMaxLanes || place < PLACE_MINOR ||
         place > PLACE_SHARED;
}

}  // namespace lzp

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes.cu's C interface as host loops over lanes (tests only). The
// stream argument is ignored. A shared-memory table is a block's
// lane-minor copy, filled and written back as the kernel does.
#include <vector>

namespace lzp {

template <bool kMem>
void host_bitdecode(int place, int32_t* tab, int32_t* idx, int32_t* acc,
                    int32_t* rng, int32_t* cod, int L, int iters) {
  if (place != PLACE_SHARED) {
    for (int l = 0; l < L; ++l) {
      if (place == PLACE_MINOR)
        bitdecode_run<LaneMinorTable, kMem>(LaneMinorTable{tab + l, L}, idx,
                                            acc, rng, cod, l, iters);
      else
        bitdecode_run<LaneMajorTable, kMem>(
            LaneMajorTable{tab + size_t(l) * kRows}, idx, acc, rng, cod, l,
            iters);
    }
    return;
  }
  std::vector<int32_t> smem(size_t(kRows) * kBlock);
  for (int base = 0; base < L; base += kBlock) {
    const int n = L - base < kBlock ? L - base : kBlock;
    for (int r = 0; r < kRows; ++r)
      for (int t = 0; t < n; ++t)
        smem[size_t(r) * kBlock + t] = tab[size_t(r) * L + base + t];
    for (int t = 0; t < n; ++t)
      bitdecode_run<LaneMinorTable, kMem>(
          LaneMinorTable{smem.data() + t, kBlock}, idx, acc, rng, cod,
          base + t, iters);
    for (int r = 0; r < kRows; ++r)
      for (int t = 0; t < n; ++t)
        tab[size_t(r) * L + base + t] = smem[size_t(r) * kBlock + t];
  }
}

}  // namespace lzp

extern "C" {

int lzp_tinyops(const int32_t* x, int32_t* state, int L, int iters,
                void* /*stream*/) {
  if (lzp::bad_args(L, iters)) return lzp::ERR_ARGS;
  for (int l = 0; l < L; ++l)
    lzp::tinyops_lane(x[l], iters, state + l, state + L + l,
                      state + 2 * size_t(L) + l);
  return 0;
}

// `rounds` rounds of tiny_round on each of n triples (a[i], b[i], d[i]),
// in place, the first at round index `first` (host build only: the round
// alone, against the probe's form).
int lzp_tiny_rounds_host(int32_t* a, int32_t* b, int32_t* d, int n,
                         int first, int rounds) {
  if (n < 0 || first < 0 || rounds < 0) return lzp::ERR_ARGS;
  for (int i = 0; i < n; ++i) {
    lzp::Tiny t = lzp::tiny_start(a[i], b[i], d[i]);
    for (int k = first; k < first + rounds; ++k) lzp::tiny_round(t, k);
    a[i] = t.a;
    b[i] = t.b;
    d[i] = t.d;
  }
  return 0;
}

int lzp_bitdecode(int place, int mem_state, int32_t* tab, int32_t* idx,
                  int32_t* acc, int32_t* rng, int32_t* cod, int L, int iters,
                  void* /*stream*/) {
  if (lzp::bad_bitdecode(place, L, iters)) return lzp::ERR_ARGS;
  if (mem_state)
    lzp::host_bitdecode<true>(place, tab, idx, acc, rng, cod, L, iters);
  else
    lzp::host_bitdecode<false>(place, tab, idx, acc, rng, cod, L, iters);
  return 0;
}

int lzp_realweight(int32_t* tab, int32_t* ring, int32_t* state, int L,
                   int iters, int rounds, void* /*stream*/) {
  if (lzp::bad_args(L, iters) || rounds < 0) return lzp::ERR_ARGS;
  for (int l = 0; l < L; ++l)
    lzp::realweight_lane(tab, ring, state, L, l, iters, rounds);
  return 0;
}

int lzp_bitdecode_max_lanes() { return lzp::kMaxLanes; }

const char* lzp_error_string(int code) {
  return code == lzp::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_LANE_CUH_
