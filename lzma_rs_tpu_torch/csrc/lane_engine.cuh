// One lane of the lane engine: a dict-reset segment (or a raw LZMA stream)
// decoded in place in the flat output, with the JAX lane kernel's contract
// (lzma_rs_tpu/ops/lane_decoder.py::decode_lanes): the flat archive, the
// flat output with the stored chunks placed, chunk tables [L, K] of
// absolute offsets, per-chunk props, and per lane its chunk count, segment
// base, size_known and dictionary size.
//
// Semantics: those of lzma_lane.cuh's decode_lane (the decoder's), plus
// the JAX lane kernel's: a match distance beyond the lane's dictionary
// size is ERR_DIST_DICT, tested before ERR_DIST_OUT; a lane of unknown
// size (size_known 0) decodes its first chunk up to the end marker (or to
// a finished coder after a symbol, or at once after the chunk's setup),
// and a symbol past that chunk's out_end, its capacity, is ERR_SIZE (a
// literal is refused before its store). Every micro-op (a range-coder bit,
// a copied byte, a chunk setup) counts one step in an int64 count, as the
// plain version's lockstep iterations do, and a lane stops with
// ERR_STEP_CAP when its budget (lane_budget) is spent. A lane's window is
// its own slice of the output (out + seg_base), bounded by its last
// chunk's out_end and nothing else, so any dictionary size works; its
// input is the archive itself. Checks that keep every access inside the
// buffers: a chunk off the input, off the lane's window or shorter than 5
// bytes is ERR_SHORT; a lane whose seg_base or last out_end lies off the
// output gets an empty window; props are clamped to their fields (lc <= 8,
// lp, pb <= 7).
//
// The chain. A lane is one serial chain, every bit waiting on the one
// before, so the design shortens the chain of one step:
//   - the lead: thread 0 of the lane's block alone runs the range coder,
//     the symbol decoder, the state, the reps and outp, with no barrier a
//     bit. The wide work goes to the block's second warp, the helpers
//     (Crew, helper_loop): the table's refill and copies longer than
//     kLeadCopy bytes, posted through a ring of jobs in shared memory
//     (Mail). The lead does not wait for a copy: it goes on decoding and
//     waits only before it reads window bytes that a posted copy may still
//     be writing (Crew::settle), and for a refill. It copies short ones
//     alone, every source byte loaded before the first store;
//   - a bit tests nothing but its own outcome: a symbol that starts at
//     least 48 steps before the budget's end and 64 input bytes before its
//     chunk's end (kSymbolBits, kSymbolBytes) can reach neither, so it runs
//     unchecked: no budget, end-of-input or input-bounds test a bit, its
//     steps counted in 32 bits and folded once a symbol. The other symbols
//     run the same code checked, with sticky errors (a bit after the lane
//     has stopped changes no count or output), and the lane's error is
//     read once a symbol, before any store to the window;
//   - probabilities fetched ahead: every bit tree loads the four
//     grandchildren of its node (one 64-bit shared load) before the node's
//     bit; the next probability is a half of the quad the level before
//     loaded, so a load has two bits' time to land, and a tree walks two
//     levels a pass, so that no loop copy waits for a load. The first nodes
//     of the next literal tree, the next is_match and is_rep bits and the
//     length coder's choice bits are loaded with the symbol's first bit;
//     the rep bits and the position slot trees' first nodes while the match
//     is still being told apart. A parent's updated probability is never
//     among the values loaded ahead (only descendants are), and between
//     refills the lead is the only thread that touches the table;
//   - the table has its own layout (LaneTable): every tree 8-byte aligned,
//     so a node's four grandchildren are one load;
//   - the input one byte ahead: each bit loads the byte after the one it
//     may shift in, from L1, and shifts it in a bit later, so no bit waits
//     on the load it issued;
//   - window bytes off the chain: the literal context's previous byte is
//     kept in a register (the literal; after a copy the copy's last byte,
//     loaded from the copy's source as soon as it is known), and the next
//     matched literal's byte is loaded as soon as rep0 and outp are fixed
//     after a match.
// Profiled on the card (clock64 around each part of a symbol), a bit was
// issue-bound, some 80 instructions with its tests of the budget, the
// chunk's end and the input's bounds and a look-ahead word's refill, and a
// copy waited on the L2 latency of its source bytes: the unchecked symbols
// and the helper warp take those two off the chain.
//
// Compiled for the card by decode_lanes.cu (a block of two warps a lane)
// and, as a test aid, for the host by g++ (-x c++ -DLZL_HOST_ENTRY), where
// one thread is the lead and runs each job as it posts it, the helpers'
// ranks last first, so the lane's logic is checked on the CPU against the
// plain PyTorch version (ops/lane_decoder.py::decode_lanes_reference).
#ifndef LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_
#define LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_

#include <stdint.h>
#include <string.h>

#include "lzma_lane.cuh"

#if defined(__CUDACC__)
#define LZL_UNROLL _Pragma("unroll")
#else
#define LZL_UNROLL
#endif

namespace lzl {

// lc + lp <= 4: 16 literal contexts.
constexpr int kLaneNlit = 16;
// A copy of at most this many bytes is the lead's alone.
constexpr int kLeadCopy = 8;

// The lane engine's probability table: the cells of models/state.py's
// LAYOUT_LCLP4 in another order (a private layout: the table is no
// output), with every bit tree 8-byte aligned. A tree's node m (from 1) is
// at its base + m. spec_pos holds one block of max(4, 2^nd) entries a
// position slot s of 4-13 (nd = s / 2 - 1 reverse-tree bits; spec_block);
// a length coder has its two choice bits at its base and its trees at base
// + 2 (low, 8 a pos_state), + 130 (mid), + 258 (high), so its base is 2
// mod 4.
struct LaneTable {
  static constexpr int is_match = kLaneNlit * LIT_ROW;  // [state][pos_state]
  static constexpr int is_rep = is_match + 192;
  static constexpr int is_rep_g0 = is_rep + 12;
  static constexpr int is_rep_g1 = is_rep_g0 + 12;
  static constexpr int is_rep_g2 = is_rep_g1 + 12;
  static constexpr int is_rep_0long = is_rep_g2 + 12;   // [state][pos_state]
  static constexpr int pos_slot = is_rep_0long + 192;   // [len_state][64]
  static constexpr int spec_pos = pos_slot + 4 * 64;
  static constexpr int align = spec_pos + 128;
  static constexpr int len = align + 16 + 2;
  static constexpr int rep_len = len + 514 + 2;
  static constexpr int total = rep_len + 514;
  // Entries allocated: a tree's last level loads its node's grandchildren
  // (walk), past its leaves, up to rep_len's high tree's base + 4 * 256.
  static constexpr int alloc = rep_len + 258 + 4 * 256;
};
static_assert(LIT_ROW % 4 == 0 && LaneTable::pos_slot % 4 == 0 &&
                  LaneTable::spec_pos % 4 == 0 && LaneTable::align % 4 == 0 &&
                  LaneTable::len % 4 == 2 && LaneTable::rep_len % 4 == 2,
              "every tree of the lane table is 8-byte aligned");

// Bytes of the lane table in shared memory, a multiple of 16.
LZL_FN int lane_table_bytes() { return (2 * LaneTable::alloc + 15) & ~15; }

// Offset of position slot s's reverse tree (4 <= s < 14) in spec_pos.
LZL_FN int spec_block(int s) {
  const int k = s >> 1;
  return k == 2 ? (s & 1) << 2 : (1 << k) + ((s & 1) << (k - 1));
}

// Two and four neighbouring probabilities in one load (p 4- and 8-byte
// aligned), little-endian: the lower index in the low half. On the card an
// inline shared load with a memory clobber, so that no store of a single
// probability is moved across it.
LZL_FN uint32_t ld_pair(const uint16_t* p) {
#if defined(__CUDA_ARCH__)
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(uint32_t(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

LZL_FN uint64_t ld_quad(const uint16_t* p) {
#if defined(__CUDA_ARCH__)
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];"
               : "=l"(v)
               : "r"(uint32_t(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
#else
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
#endif
}

LZL_FN uint32_t lo16(uint32_t v) { return v & 0xFFFFu; }
LZL_FN uint32_t hi16(uint32_t v) { return v >> 16; }

// The low n bits of v in reverse order (1 <= n <= 32).
LZL_FN uint32_t rev_bits(uint32_t v, int n) {
#if defined(__CUDA_ARCH__)
  return __brev(v) >> (32 - n);
#else
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
#endif
}

// a mod d for 0 <= a, 1 <= d, without a division when a < d.
LZL_FN int mod_small(int a, int d) { return a < d ? a : a % d; }

// The most bits one symbol decodes (a match: is_match, is_rep, 10 length
// bits, 6 slot bits, 26 direct and 4 align bits), so also the most input
// bytes it consumes. A symbol that starts at least kSymbolBits steps
// before the budget's end and kSymbolBytes input bytes before its chunk's
// end can stop on neither, and reads no input byte past the chunk (the
// input is read a byte ahead): it runs unchecked.
constexpr int kSymbolBits = 48;
constexpr int kSymbolBytes = kSymbolBits + 16;

// The lead's range decoder over the archive, with the lane's int64 step
// budget. Its bits come in two builds: checked (kChecked), which count
// every step against the budget and test the chunk's end and the input's
// end at every input byte, with sticky errors (once err is set no step is
// counted, and the bits decoded after it are garbage that nothing
// stores); and unchecked, for a symbol that can reach neither end, which
// count steps in nb (folded into steps once a symbol) and test nothing.
struct LeadCoder {
  const uint8_t* in;
  int w_in;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  int pos = 0, end = 0;
  int64_t steps = 0, max_steps;
  uint32_t nb = 0;  // unchecked bits since the last fold()
  int err = ERR_NONE;
  // Input byte pos, and byte pos + 1: loaded at every bit (a hit in L1 but
  // at a line's first byte) and taken a bit later, so that no bit waits
  // on the load it issued.
  uint32_t cur = 0, pending = 0;

  LZL_FN LeadCoder(const uint8_t* in_, int w_in_, int64_t max_steps_)
      : in(in_), w_in(w_in_), max_steps(max_steps_) {}

  // Byte i of the input, 0 past its end (never consumed).
  LZL_FN uint32_t byte_at(int i) const {
    return i < w_in ? load_byte(in + i) : 0u;
  }

  LZL_FN void seek(int p) {
    pos = p;
    cur = byte_at(p);
    pending = byte_at(p + 1);
  }

  // May the next symbol run unchecked?
  LZL_FN bool roomy() const {
    return steps + kSymbolBits <= max_steps && end - pos >= kSymbolBytes;
  }

  LZL_FN void fold() {
    steps += nb;
    nb = 0;
  }

  // The chunk setup's micro-op; false (err set) once the budget is spent.
  LZL_FN bool step() {
    if (steps >= max_steps) {
      err = ERR_STEP_CAP;
      return false;
    }
    ++steps;
    return true;
  }

  template <bool kChecked>
  LZL_FN void count() {
    if constexpr (kChecked) {
      const bool live = err == ERR_NONE;
      const bool spent = steps >= max_steps;
      err = live && spent ? ERR_STEP_CAP : err;
      steps += live && !spent ? 1 : 0;
    } else {
      ++nb;
    }
  }

  template <bool kChecked>
  LZL_FN void normalize() {
    bool go = range < (1u << 24);
    if constexpr (kChecked) {
      const bool eof = go && pos >= end;
      err = eof && err == ERR_NONE ? ERR_EOF : err;
      go = go && !eof;
    }
    range = go ? range << 8 : range;
    code = go ? (code << 8) | cur : code;
    cur = go ? pending : cur;
    pos += go ? 1 : 0;
    if constexpr (kChecked) {
      pending = byte_at(pos + 1);
    } else {
      pending = load_byte(in + (pos + 1));
    }
  }

  // One adaptive bit whose probability pv = *p was loaded ahead.
  template <bool kChecked>
  LZL_FN uint32_t bit(uint16_t* p, uint32_t pv) {
    count<kChecked>();
    const uint32_t bound = (range >> 11) * pv;
    const uint32_t b = code >= bound ? 1u : 0u;
    range = b ? range - bound : bound;
    code = b ? code - bound : code;
    *p = uint16_t(b ? pv - (pv >> 5) : pv + ((0x800u - pv) >> 5));
    normalize<kChecked>();
    return b;
  }

  template <bool kChecked>
  LZL_FN uint32_t direct_bit() {
    count<kChecked>();
    range >>= 1;
    const uint32_t b = code >= range ? 1u : 0u;
    code = b ? code - range : code;
    normalize<kChecked>();
    return b;
  }
};

// Walk a bit tree from node m down to a leaf >= top, which it returns:
// pv = t[m], and m's kids are the half kb of the quad kq (t[2m] and
// t[2m + 1]). Each level loads its node's four grandchildren before its
// bit (the table is allocated long enough for a tree's last level to read
// past its leaves); the next probability is then a half of the quad the
// level before loaded, so a load has two bits' time to land.
template <bool kChecked>
LZL_FN void level(LeadCoder& c, uint16_t* t, uint32_t& m, uint32_t& pv,
                  uint64_t& kq, uint32_t& kb) {
  const uint32_t kids = kb ? uint32_t(kq >> 32) : uint32_t(kq);
  kq = ld_quad(t + 4 * m);
  kb = c.bit<kChecked>(t + m, pv);
  m = 2 * m + kb;
  pv = kb ? hi16(kids) : lo16(kids);
}

// Two levels a pass, so that a level's load lands in the register the
// level before read, with no copy between passes that waits for it.
template <bool kChecked>
LZL_FN uint32_t walk(LeadCoder& c, uint16_t* t, uint32_t m, uint32_t pv,
                     uint64_t kq, uint32_t kb, uint32_t top) {
  while (m < top) {
    level<kChecked>(c, t, m, pv, kq, kb);
    if (m >= top) break;
    level<kChecked>(c, t, m, pv, kq, kb);
  }
  return m;
}

// A whole MSB-first tree of kBits levels from q0 = t[0..3] loaded ahead
// (t[1] the root, t[2..3] its children): its value, 0 .. 2^kBits - 1.
template <int kBits, bool kChecked>
LZL_FN uint32_t tree(LeadCoder& c, uint16_t* t, uint64_t q0) {
  return walk<kChecked>(c, t, 1, uint32_t(q0) >> 16, q0, 1, 1u << kBits) -
         (1u << kBits);
}

// A reverse tree of nbits (1..5) levels from q0 = t[0..3]: its value,
// bits LSB first.
template <bool kChecked>
LZL_FN uint32_t rtree(LeadCoder& c, uint16_t* t, uint64_t q0, int nbits) {
  const uint32_t top = 1u << nbits;
  return rev_bits(walk<kChecked>(c, t, 1, uint32_t(q0) >> 16, q0, 1, top) -
                      top,
                  nbits);
}

// A matched literal's byte: lit is the literal row, mb the match byte, pv
// lit[0x100 * (1 + bit 7 of mb) + 1]. While the bits follow mb's, the next
// probability is the matched row's node; at the first that differs the
// plain row takes over. Each level loads both, and the plain node's kids.
template <bool kChecked>
LZL_FN uint32_t matched_literal(LeadCoder& c, uint16_t* lit, uint32_t mb,
                                uint32_t pv) {
  uint32_t sym = 1;
  for (;;) {
    const uint32_t mbit = (mb >> 7) & 1u;
    mb <<= 1;
    const uint32_t nbit = (mb >> 7) & 1u;
    const uint32_t next_m = lit[((1 + nbit) << 8) + 2 * sym + mbit];
    const uint32_t next_p = ld_pair(lit + 2 * sym);
    const uint64_t kids_p = ld_quad(lit + 4 * sym);
    const uint32_t b = c.bit<kChecked>(lit + ((1 + mbit) << 8) + sym, pv);
    sym = 2 * sym + b;
    if (sym >= 0x100) return sym & 0xFFu;
    if (b != mbit) {
      return walk<kChecked>(c, lit, sym, b ? hi16(next_p) : lo16(next_p),
                            kids_p, b, 0x100) & 0xFFu;
    }
    pv = next_m;
  }
}

// Match length minus 2 (0..271) from the coder at base; choice =
// base[0] | base[1] << 16, loaded ahead.
template <bool kChecked>
LZL_FN int lead_len(LeadCoder& c, uint16_t* base, uint32_t choice, int ps) {
  uint16_t* const low = base + 2 + ps * 8;
  uint16_t* const mid = base + 130 + ps * 8;
  uint16_t* const high = base + 258;
  const uint64_t ql = ld_quad(low), qm = ld_quad(mid), qh = ld_quad(high);
  if (!c.bit<kChecked>(base, lo16(choice))) {
    return int(tree<3, kChecked>(c, low, ql));
  }
  if (!c.bit<kChecked>(base + 1, hi16(choice))) {
    return 8 + int(tree<3, kChecked>(c, mid, qm));
  }
  return 16 + int(tree<8, kChecked>(c, high, qh));
}

// The distance field of a new match of length len + 2 (rep0 to be, or the
// end marker 0xFFFFFFFF); qs = the first quad of its slot tree, loaded
// ahead.
template <bool kChecked>
LZL_FN uint32_t lead_distance(LeadCoder& c, uint16_t* P, int ls,
                              uint64_t qs) {
  const uint64_t qa = ld_quad(P + LaneTable::align);
  const int slot =
      int(tree<6, kChecked>(c, P + LaneTable::pos_slot + ls * 64, qs));
  if (slot < 4) return uint32_t(slot);
  const int nd = (slot >> 1) - 1;
  const uint32_t base = (2u | uint32_t(slot & 1)) << nd;
  if (slot < 14) {
    uint16_t* const t = P + LaneTable::spec_pos + spec_block(slot);
    return base + rtree<kChecked>(c, t, ld_quad(t), nd);
  }
  uint32_t acc = 0;
  for (int i = 0; i < nd - 4; ++i) {
    acc = (acc << 1) | c.direct_bit<kChecked>();
  }
  return base + (acc << 4) +
         rev_bits(tree<4, kChecked>(c, P + LaneTable::align, qa), 4);
}

// The bytes of a copy of n <= kLeadCopy bytes from dist back, by the lead
// alone. Byte i is win[at - dist + i % dist], a byte that existed before
// the copy, so every load comes before the first store.
LZL_FN void lead_copy(uint8_t* win, int at, int dist, int n) {
  const uint8_t* const src = win + (at - dist);
  uint8_t v[kLeadCopy];
  int j = 0;
  LZL_UNROLL
  for (int i = 0; i < kLeadCopy; ++i) {
    v[i] = src[j];
    j = j + 1 == dist ? 0 : j + 1;
  }
  LZL_UNROLL
  for (int i = 0; i < kLeadCopy; ++i) {
    if (i < n) win[at + i] = v[i];
  }
}

// A lane's step budget. No lane, valid or corrupt, takes more than
// 22 * w + K + 1 steps for a w-byte window (ops/lane_decoder.py::
// lane_budgets), so the budget is a guard that never fires on a valid
// stream, for every w < 2^31.
LZL_FN int64_t lane_budget(int64_t w, int n, int64_t max_steps) {
  const int64_t b = 24 * w + 2 * int64_t(n) + 64;
  return max_steps > 0 && max_steps < b ? max_steps : b;
}

LZL_FN int32_t clamp_to(int64_t v, int64_t lo, int64_t hi) {
  return int32_t(v < lo ? lo : (v > hi ? hi : v));
}

struct LaneArgs {
  const uint8_t* in;   // [in_len] the archive
  uint8_t* out;        // [out_len] the output, stored chunks placed
  const int32_t *in_start, *in_end, *out_start, *out_end, *reset, *lc, *lp,
      *pb;                                     // [L, K]
  const int32_t *nchunks, *seg_base, *size_known;  // [L]
  const int64_t* dict_size;                    // [L]
  int32_t *err, *outp;                         // [L]
  int64_t* steps;                              // [L]
  int L, K, in_len, out_len;
  int64_t max_steps;  // <= 0: each lane's own budget (lane_budget)
};

// Work the lead hands to the helper warp.
struct Job {
  int kind, at, dist, n;  // a copy: n bytes at at from dist back
};
constexpr int kJobDone = 0, kJobRefill = 1, kJobCopy = 2;

// The lead's mailbox to the helper warp, in shared memory after the table:
// a ring of kRing jobs, the count the lead has posted and the count the
// helpers have finished.
constexpr int kRing = 8;
struct Mail {
  int posted, done;
  int job[kRing][4];
};

// Bytes of a lane's shared memory: its table and its mailbox.
LZL_FN int lane_smem_bytes() {
  return lane_table_bytes() + ((int(sizeof(Mail)) + 15) & ~15);
}

#if defined(__CUDACC__)
LZL_FN int ld_volatile(const int* p) {
  return *static_cast<const volatile int*>(p);
}
LZL_FN void st_volatile(int* p, int v) { *static_cast<volatile int*>(p) = v; }
#endif

// One helper's part of a job: rank r of 32.
LZL_FN void do_job(const Job& j, int r, uint8_t* win, uint16_t* P) {
  if (j.kind == kJobRefill) {
    for (int i = r; i < LaneTable::total; i += 32) P[i] = PROB_INIT;
  } else if (j.kind == kJobCopy) {
    copy_rank(win, j.at, j.dist, j.n, r, 32);
  }
}

// The helper warp as the lead sees it. post() hands a job over and returns
// at once; the lead waits only before it reads window bytes that a posted
// copy may still be writing (settle) and for the table's refill (drain).
// Posted copies write at increasing offsets, so pend_lo, the first pending
// copy's offset, bounds them all. On the host the lead plays the helpers
// too, as late as the protocol lets them run: a posted job waits in the
// ring until the ring is full, a drain() or the lane's end, and then runs
// with the ranks last first; a missing settle() then reads stale bytes.
struct Crew {
  Mail* mail;
  uint8_t* win;
  uint16_t* P;
  int posted = 0, done = 0;
  int pend_lo = 0x7FFFFFFF;
#if !defined(__CUDA_ARCH__)
  Job ring[kRing] = {};

  void run_oldest() {
    const Job& j = ring[done % kRing];
    for (int r = 31; r >= 0; --r) do_job(j, r, win, P);
    ++done;
  }
#endif

  LZL_FN Crew(Mail* mail_, uint8_t* win_, uint16_t* P_)
      : mail(mail_), win(win_), P(P_) {}

  LZL_FN void post(const Job& j) {
#if defined(__CUDA_ARCH__)
    while (posted - done >= kRing) done = ld_volatile(&mail->done);
    int* const slot = mail->job[posted % kRing];
    st_volatile(slot + 0, j.kind);
    st_volatile(slot + 1, j.at);
    st_volatile(slot + 2, j.dist);
    st_volatile(slot + 3, j.n);
    __threadfence_block();  // the lead's window bytes and the job first
    st_volatile(&mail->posted, ++posted);
    if (j.kind == kJobCopy && pend_lo == 0x7FFFFFFF) pend_lo = j.at;
#else
    if (posted - done >= kRing) run_oldest();
    ring[posted++ % kRing] = j;
    if (j.kind == kJobCopy && pend_lo == 0x7FFFFFFF) pend_lo = j.at;
    if (j.kind == kJobDone) drain();
#endif
  }

  // Wait until every posted job is done, and see what it wrote.
  LZL_FN void drain() {
#if defined(__CUDA_ARCH__)
    while (ld_volatile(&mail->done) != posted) {
    }
    done = posted;
    __threadfence_block();
#else
    while (done < posted) run_oldest();
#endif
    pend_lo = 0x7FFFFFFF;
  }

  // Before the lead reads window bytes below hi.
  LZL_FN void settle(int hi) {
    if (hi > pend_lo) drain();
  }
};

#if defined(__CUDACC__)
// The helper warp's loop: each job in turn, split over its 32 ranks, then
// a warp barrier and the done count; it returns at kJobDone.
__device__ inline void helper_loop(Mail* mail, uint8_t* win, uint16_t* P) {
  const int r = int(threadIdx.x & 31u);
  for (int seq = 0;; ++seq) {
    while (ld_volatile(&mail->posted) == seq) __nanosleep(32);
    __threadfence_block();
    const int* const slot = mail->job[seq % kRing];
    const Job j{ld_volatile(slot), ld_volatile(slot + 1), ld_volatile(slot + 2),
                ld_volatile(slot + 3)};
    if (j.kind == kJobDone) return;
    do_job(j, r, win, P);
    __threadfence_block();
    __syncwarp();
    if (r == 0) st_volatile(&mail->done, seq + 1);
  }
}
#endif

// The lead's lane: its state between jobs, and run(), which decodes until
// the next job.
struct LeadLane {
  static constexpr int kNextChunk = 0, kInChunk = 1, kStopped = 2;
  LeadCoder c;
  Crew crew;
  uint16_t* P;
  uint8_t* win;  // the lane's window, w bytes
  int w;
  const int32_t *in_start, *in_end, *out_start, *out_end, *reset, *lc_t,
      *lp_t, *pb_t;  // the lane's chunk tables
  int64_t base;      // seg_base
  int n;             // chunks
  uint32_t dict;
  bool open;  // size_known 0
  int ci = 0, phase = kNextChunk;
  int outp = 0, oe = 0, state = 0, lc = 0, lpm = 0, pbm = 0;
  uint32_t rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  uint32_t prev = 0;  // win[outp - 1], 0 at the window's start
  uint32_t mb = 0;    // win[outp - 1 - rep0] after a match
  uint32_t pm = 0;    // the next symbol's is_match probability
  int len = 0;        // the bytes of the copy symbol() decoded

  LZL_FN LeadLane(const LaneArgs& a, size_t t, Mail* mail, uint16_t* P_,
                  uint8_t* win_, int w_, int64_t base_, int n_, uint32_t dict_,
                  bool open_)
      : c(a.in, a.in_len, lane_budget(w_, n_, a.max_steps)),
        crew(mail, win_, P_), P(P_), win(win_), w(w_),
        in_start(a.in_start + t), in_end(a.in_end + t),
        out_start(a.out_start + t), out_end(a.out_end + t),
        reset(a.reset + t), lc_t(a.lc + t), lp_t(a.lp + t), pb_t(a.pb + t),
        base(base_), n(n_), dict(dict_), open(open_) {}

  LZL_FN bool finished() const {
    return open && c.code == 0 && c.pos >= c.end;
  }

  LZL_FN Job stop() {
    phase = kStopped;
    return Job{kJobDone, 0, 0, 0};
  }

  // The next chunk's setup (one step): true when it resets the table.
  LZL_FN bool setup() {
    phase = kStopped;
    if (!c.step() || ci >= n) return false;
    const int i = ci++;
    const int s = in_start[i], e = in_end[i];
    const int os = clamp_to(int64_t(out_start[i]) - base, -1, 0x7FFFFFFF);
    const int oe_ = clamp_to(int64_t(out_end[i]) - base, -1, 0x7FFFFFFF);
    if (s < 0 || e > c.w_in || os < 0 || os > oe_ || oe_ > w || e - s < 5) {
      c.err = ERR_SHORT;
      return false;
    }
    const bool fresh = reset[i] == 1;
    if (fresh) {
      state = 0;
      rep0 = rep1 = rep2 = rep3 = 0;
    }
    lc = clamp_to(lc_t[i], 0, 8);
    lpm = (1 << clamp_to(lp_t[i], 0, 7)) - 1;
    pbm = ((1 << clamp_to(pb_t[i], 0, 7)) - 1) & 15;
    c.range = 0xFFFFFFFFu;
    c.code = (load_byte(c.in + s + 1) << 24) | (load_byte(c.in + s + 2) << 16) |
             (load_byte(c.in + s + 3) << 8) | load_byte(c.in + s + 4);
    c.seek(s + 5);
    c.end = e;
    outp = os;
    oe = oe_;
    crew.settle(os);
    prev = os > 0 ? win[os - 1] : 0u;
    mb = state >= 7 && uint64_t(rep0) + 1 <= uint64_t(os)
             ? win[os - 1 - int(rep0)]
             : 0u;
    if (finished()) return false;
    phase = kInChunk;
    return fresh;
  }

  static constexpr int kSymLiteral = 0, kSymCopy = 1, kSymStop = 2;
  template <bool kChecked>
  LZL_FN int symbol();
  LZL_FN Job run();
};

// One symbol, up to its window bytes: a literal stored (kSymLiteral), a
// match's length and distance decoded and checked (kSymCopy: len bytes
// from rep0 + 1 back), or the lane's end (kSymStop). The step count is
// folded before anything reads it.
template <bool kChecked>
LZL_FN int LeadLane::symbol() {
  typedef LaneTable T;
  const int ps = outp & pbm;
  const int ctx =
      (((outp & lpm) << lc) + int(prev >> (8 - lc))) & (kLaneNlit - 1);
  uint16_t* const lit = P + ctx * LIT_ROW;
  const bool matched = state >= 7;
  // the second bit's probabilities, loaded with the first bit
  const uint64_t lq =
      ld_quad(lit + (matched ? (1 + ((mb >> 7) & 1)) << 8 : 0));
  const uint32_t prep = P[T::is_rep + state];
  const uint32_t mchoice = ld_pair(P + T::len);
  if (!c.bit<kChecked>(P + T::is_match + (state << 4) + ps, pm)) {
    const int next = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
    pm = P[T::is_match + (next << 4) + ((outp + 1) & pbm)];
    if (matched && uint64_t(rep0) + 1 > uint64_t(outp)) {
      c.fold();
      if (c.err == ERR_NONE) c.err = ERR_MATCHDIST;
      return kSymStop;
    }
    const uint32_t sym =
        matched ? matched_literal<kChecked>(c, lit, mb, uint32_t(lq) >> 16)
                : tree<8, kChecked>(c, lit, lq);
    c.fold();
    if (c.err != ERR_NONE) return kSymStop;
    if (outp >= oe) {  // past an open lane's capacity
      c.err = ERR_SIZE;
      return kSymStop;
    }
    win[outp++] = uint8_t(sym);
    prev = sym;
    state = next;
    return finished() ? kSymStop : kSymLiteral;
  }

  // a match: the rep path's bits, loaded with is_rep
  const uint32_t pg0 = P[T::is_rep_g0 + state];
  const uint32_t pg1 = P[T::is_rep_g1 + state];
  const uint32_t pg2 = P[T::is_rep_g2 + state];
  const uint32_t plong = P[T::is_rep_0long + (state << 4) + ps];
  const uint32_t rchoice = ld_pair(P + T::rep_len);
  if (!c.bit<kChecked>(P + T::is_rep + state, prep)) {
    const uint64_t s0 = ld_quad(P + T::pos_slot);
    const uint64_t s1 = ld_quad(P + T::pos_slot + 64);
    const uint64_t s2 = ld_quad(P + T::pos_slot + 128);
    const uint64_t s3 = ld_quad(P + T::pos_slot + 192);
    rep3 = rep2;
    rep2 = rep1;
    rep1 = rep0;
    len = lead_len<kChecked>(c, P + T::len, mchoice, ps);
    state = state < 7 ? 7 : 10;
    const int ls = len < 3 ? len : 3;
    const uint64_t qs = ls == 0 ? s0 : (ls == 1 ? s1 : (ls == 2 ? s2 : s3));
    const uint32_t d = lead_distance<kChecked>(c, P, ls, qs);
    c.fold();
    if (c.err != ERR_NONE) return kSymStop;
    if (d == 0xFFFFFFFFu) {
      // an open lane's end; a sized chunk's symbols run only while
      // outp < its end, so a finished coder here still leaves it short
      if (!finished()) {
        c.err = c.code == 0 && c.pos >= c.end ? ERR_SIZE : ERR_EOS_EXTRA;
      }
      return kSymStop;
    }
    rep0 = d;
    len += 2;
  } else if (!c.bit<kChecked>(P + T::is_rep_g0 + state, pg0)) {
    if (!c.bit<kChecked>(P + T::is_rep_0long + (state << 4) + ps, plong)) {
      state = state < 7 ? 9 : 11;  // short rep: one byte from rep0
      len = 1;
    } else {
      len = lead_len<kChecked>(c, P + T::rep_len, rchoice, ps) + 2;
      state = state < 7 ? 8 : 11;
    }
  } else {
    uint32_t d;
    if (!c.bit<kChecked>(P + T::is_rep_g1 + state, pg1)) {
      d = rep1;
    } else {
      if (!c.bit<kChecked>(P + T::is_rep_g2 + state, pg2)) {
        d = rep2;
      } else {
        d = rep3;
        rep3 = rep2;
      }
      rep2 = rep1;
    }
    rep1 = rep0;
    rep0 = d;
    len = lead_len<kChecked>(c, P + T::rep_len, rchoice, ps) + 2;
    state = state < 7 ? 8 : 11;
  }
  c.fold();
  if (c.err != ERR_NONE) return kSymStop;
  if (uint64_t(rep0) + 1 > uint64_t(dict)) {
    c.err = ERR_DIST_DICT;
    return kSymStop;
  }
  if (uint64_t(rep0) + 1 > uint64_t(outp)) {
    c.err = ERR_DIST_OUT;
    return kSymStop;
  }
  return kSymCopy;
}

LZL_FN Job LeadLane::run() {
  for (;;) {
    if (phase == kStopped) return stop();
    if (phase == kNextChunk) {
      if (setup()) return Job{kJobRefill, 0, 0, 0};
      continue;
    }
    pm = P[LaneTable::is_match + (state << 4) + (outp & pbm)];
    while (open || outp < oe) {  // one symbol a pass
      const int sym = c.roomy() ? symbol<false>() : symbol<true>();
      if (sym == kSymStop) return stop();
      if (sym == kSymLiteral) continue;

      // the copy: len bytes from dist back, split as split_copy says (the
      // lockstep version's step, then chunk-end test, a byte)
      const int dist = int(rep0) + 1, at = outp, room = oe - outp;
      const int64_t left = c.max_steps - c.steps;
      int nb = len, ns = len;
      if (len > left || len > room) {
        if (left <= room) {
          nb = ns = int(left);
          c.err = ERR_STEP_CAP;
        } else {
          nb = room;
          ns = room + 1;
          c.err = ERR_SIZE;
        }
      }
      outp += nb;
      c.steps += ns;
      pm = P[LaneTable::is_match + (state << 4) + (outp & pbm)];
      if (nb > 0) {  // dist <= at: the next bytes' sources are in the window
        crew.settle(at - dist + (nb + 1 < dist ? nb + 1 : dist));
        const uint8_t* const src = win + (at - dist);
        prev = src[mod_small(nb - 1, dist)];
        mb = src[mod_small(nb, dist)];
      }
      const bool last = c.err != ERR_NONE || finished();
      if (nb > kLeadCopy) {
        if (last) phase = kStopped;
        return Job{kJobCopy, at, dist, nb};
      }
      lead_copy(win, at, dist, nb);
      if (last) return stop();
    }
    phase = kNextChunk;
  }
}

struct LaneOut {
  int32_t err, outp;  // outp absolute
  int64_t steps;
};

// The lead's part of lane `lane`: decode it, handing the wide work to the
// helpers through mail.
LZL_FN LaneOut run_lane(const LaneArgs& a, int lane, uint16_t* P, Mail* mail) {
  const size_t t = size_t(lane) * size_t(a.K);
  const int n = clamp_to(a.nchunks[lane], 0, a.K);
  const int64_t base = a.seg_base[lane];
  const bool in_out = base >= 0 && base <= a.out_len;
  int64_t w = 0;
  if (n > 0 && in_out) {
    const int64_t last = a.out_end[t + size_t(n - 1)];
    if (last >= base && last <= a.out_len) w = last - base;
  }
  const int64_t d = a.dict_size[lane];
  const uint32_t dict =
      d < 0 ? 0u : (d > 0xFFFFFFFFll ? 0xFFFFFFFFu : uint32_t(d));
  const int64_t at = in_out ? base : 0;
  LeadLane s(a, t, mail, P, a.out + at, int(w), base, n, dict,
             a.size_known[lane] == 0);
  Job job{kJobRefill, 0, 0, 0};
  for (;;) {
    s.crew.post(job);
    if (job.kind == kJobDone) break;
    if (job.kind == kJobRefill) s.crew.drain();
    job = s.run();
  }
  return LaneOut{s.c.err, int32_t(at + s.outp), s.c.steps};
}

}  // namespace lzl

#if defined(LZL_HOST_ENTRY) && !defined(__CUDACC__)
#include <vector>

// The kernel's lanes one after another, one thread playing the lead and
// the helpers (each job run as it is posted, the ranks last first), with
// the kernel's arguments (tests only). The output is decoded in place.
extern "C" int lzl_decode_lanes_host(
    const uint8_t* in, uint8_t* out, const int32_t* in_start,
    const int32_t* in_end, const int32_t* out_start, const int32_t* out_end,
    const int32_t* reset, const int32_t* lc, const int32_t* lp,
    const int32_t* pb, const int32_t* nchunks, const int32_t* seg_base,
    const int32_t* size_known, const int64_t* dict_size, int32_t* err,
    int32_t* outp, int64_t* steps, int L, int K, int in_len, int out_len,
    long long max_steps) {
  const lzl::LaneArgs a{in,       out,       in_start, in_end,     out_start,
                        out_end,  reset,     lc,       lp,         pb,
                        nchunks,  seg_base,  size_known, dict_size, err,
                        outp,     steps,     L,        K,          in_len,
                        out_len,  max_steps};
  std::vector<uint16_t> P(size_t(lzl::LaneTable::alloc));
  lzl::Mail mail{};
  for (int l = 0; l < L; ++l) {
    const lzl::LaneOut r = lzl::run_lane(a, l, P.data(), &mail);
    err[l] = r.err;
    outp[l] = r.outp;
    steps[l] = r.steps;
  }
  return 0;
}

// lane_budget, for the tests.
extern "C" long long lzl_lane_budget_host(long long w, int n,
                                          long long max_steps) {
  return lzl::lane_budget(w, n, max_steps);
}

extern "C" int lzl_lanes_smem_bytes_host() { return lzl::lane_smem_bytes(); }
#endif

#endif  // LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_
