// One lane of the segment decoder: decodes one LZMA2 dict-reset segment
// (a schedule of LZMA chunks) to completion, run by a team of threads.
//
// Compiled for the card by segment_kernel.cuh (the decoder: a warp a lane;
// the variants of decode_variants.cu: a thread or a warp a lane) and, as a
// test aid, for the host by g++ (-x c++ -DLZL_HOST_ENTRY), so the
// decoder's logic is checked on the CPU against the plain PyTorch version
// (ops/segment_decoder.py::decode_segments_reference).
//
// Semantics are those of the JAX package's gen-2 kernel
// (lzma_rs_tpu/ops/vmem2_decoder.py::decode_segments_vmem2), which follow
// the native decoder (lzma_rs_tpu/native/lzma_native.cpp RangeDecoder,
// DecoderState, lrt_lzma2_decode_segment):
//   - chunk setup from the chunk tables: reset (meta & 3) == 1 refills the
//     probabilities and clears state and reps; range-coder init skips one
//     byte and reads a big-endian u32, and needs 5 bytes (ERR_SHORT);
//   - the range coder needs a byte past the chunk's input: ERR_EOF;
//   - a match runs past the chunk's unpacked end: ERR_SIZE;
//   - a matched literal whose rep0 + 1 exceeds the output so far:
//     ERR_MATCHDIST; a match distance beyond it: ERR_DIST_OUT (prefilled
//     stored-chunk bytes count as output);
//   - an end-of-stream marker inside a sized chunk: ERR_EOS_EXTRA, or
//     ERR_SIZE when the coder is otherwise finished.
// Every micro-op (a range-coder bit, a copied byte, a chunk setup) counts
// one step, exactly as the plain version's lockstep iterations do, and a
// lane stops with ERR_STEP_CAP when its step budget is spent.
//
// The step-cost builds (step_cost.cu, ops/step_cost.py) set further option
// bits, each a part of the step taken out, so that timing them against
// each other prices the parts: the port of the JAX kernel's
// LZMA_RS_TPU_ABLATE switches (lzma_rs_tpu/ops/vmem_decoder.py:55-62), as
// compile-time instantiations instead of a variable read at import.
// kDecoder sets none of them, so the decoder's build and the variants
// compile to the code they had (cuobjdump -sass, kernel for kernel): the
// literal's store and the match byte test their bits with if constexpr,
// since a plain if on the constant there changed the SASS of V4 and S3.
//
// The team. Every thread of a team runs the same scalar decoder on its own
// copy of the state, so control flow is uniform and every load and store
// of the tables and the window goes to one address for all of them. Work
// is split over the team only where the format allows it: the probability
// refill and match copies (each byte of a copy reads only bytes that
// existed before it). The caller places the table and the window (shared
// or global memory). Ordering inside a warp is explicit, never assumed
// from lockstep execution: a team barrier between each probability's load
// and its store, so no thread's store can overtake another's load of the
// same entry, and after every cooperative step. On the host a warp is one
// thread playing each rank in turn, with the same index arithmetic.
//
// The probability table uses models/state.py's flat layout for
// lc + lp <= log2(nlit): literals first, then is_match, is_rep, ... .
#ifndef LZMA_RS_TPU_TORCH_LZMA_LANE_CUH_
#define LZMA_RS_TPU_TORCH_LZMA_LANE_CUH_

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define LZL_FN __host__ __device__ inline
#else
#define LZL_FN inline
#endif

namespace lzl {

constexpr int ERR_NONE = 0;
constexpr int ERR_EOF = 1;
constexpr int ERR_DIST_OUT = 2;
constexpr int ERR_DIST_DICT = 3;  // the lane engine's only (lane_engine.cuh)
constexpr int ERR_SIZE = 4;
constexpr int ERR_EOS_EXTRA = 5;
constexpr int ERR_SHORT = 6;
constexpr int ERR_MATCHDIST = 7;
constexpr int ERR_STEP_CAP = 1;

constexpr uint16_t PROB_INIT = 0x400;
constexpr int LIT_ROW = 0x300;
constexpr int LEN_LOW = 2;
constexpr int LEN_MID = 2 + 16 * 8;
constexpr int LEN_HIGH = 2 + 16 * 8 * 2;

// Options of a decoder build (bits of the kOpts template argument).
constexpr int kWarpCopy = 1;   // a match copy split over the team; else one
                               // thread copies a byte a step
constexpr int kLookahead = 2;  // input read through two words held ahead
// The step-cost options (the JAX ablation each stands for in brackets):
constexpr int kSpin = 4;          // ["spin"] the lane never stops before
                                  // its budget: at the end of its chunks or
                                  // on any error it starts its segment
                                  // again (a fresh coder, the table
                                  // refilled, outp back at the first
                                  // chunk's start), so every lane runs
                                  // exactly max_steps steps and ends with
                                  // ERR_STEP_CAP; it counts its restarts
constexpr int kNoProbRead = 8;    // ["probread"] a bit reads the constant
                                  // PROB_INIT (the JAX PROB_PACKED) in
                                  // place of its probability
constexpr int kNoProbWrite = 16;  // ["probwrite"] a bit stores no updated
                                  // probability
constexpr int kNoPort = 32;       // ["port"] window reads return 0: a
                                  // copy's source, a matched literal's
                                  // match byte
constexpr int kNoWinWrite = 64;   // ["winwrite"] no byte is stored to the
                                  // window (literals and copies)
constexpr int kNoInput = 128;     // ["refill", the JAX kernel's input
                                  // look-ahead refill] the range coder's
                                  // next input byte is the constant 0, not
                                  // loaded. Not refill() below, which
                                  // resets the probability table.
// No counterpart: "flush" (the JAX ring's flush; this decoder keeps the
// whole window, no ring), and "chainA/B/C/D/L", "m8", "lit4" (switches of
// the JAX kernel's own fast paths, which this decoder does not have).
constexpr int kDecoder = kWarpCopy;  // the decoder's build

// The seven step-cost builds, by case number (step_cost.cu's
// lzl_decode_ablated, ops/step_cost.py's ABLATIONS): the JAX tools' cases
// but "spin,flush", and the five ablations together.
constexpr int kAblated[7] = {
    kSpin,
    kSpin | kNoProbRead,
    kSpin | kNoProbRead | kNoProbWrite,
    kSpin | kNoPort,
    kSpin | kNoWinWrite,
    kSpin | kNoInput,
    kSpin | kNoProbRead | kNoProbWrite | kNoPort | kNoWinWrite | kNoInput,
};

// Offsets of models/state.py's make_layout(log2(nlit)).
struct Layout {
  int is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2, is_rep_0long,
      pos_slot, spec_pos, align, len, rep_len, total;
  LZL_FN explicit Layout(int nlit) {
    int o = nlit * LIT_ROW;
    is_match = o;     o += 192;
    is_rep = o;       o += 12;
    is_rep_g0 = o;    o += 12;
    is_rep_g1 = o;    o += 12;
    is_rep_g2 = o;    o += 12;
    is_rep_0long = o; o += 192;
    pos_slot = o;     o += 4 * 64;
    spec_pos = o;     o += 115;
    align = o;        o += 16;
    len = o;          o += 514;
    rep_len = o;      o += 514;
    total = o;
  }
};

// Bytes of a lane's probability table in shared memory, rounded up to 16
// so that the window placed after it is 16-byte aligned
// (ops/segment_decoder.py::probs_bytes).
LZL_FN int probs_bytes(int nlit) {
  return (2 * Layout(nlit).total + 15) & ~15;
}

// A thread alone (one lane a thread).
struct Solo {
  static constexpr int kSize = 1;
  LZL_FN void sync() const {}
  template <class F>
  LZL_FN void each(F&& f) const { f(0); }
  template <class F>
  LZL_FN void one(F&& f) const { f(); }
};

// A warp (one lane a warp). each(f) runs f(rank) on every rank and then a
// warp barrier; one(f) runs f on rank 0 and then a warp barrier. On the
// host one thread plays every rank in turn, the last rank first: a rank
// that read a byte a lower rank writes in the same step would read it
// stale, as it may on the card (lzl_match_copy_host tries both orders).
struct Warp {
  static constexpr int kSize = 32;
  LZL_FN void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  template <class F>
  LZL_FN void each(F&& f) const {
#if defined(__CUDA_ARCH__)
    f(int(threadIdx.x & 31u));
    __syncwarp();
#else
    for (int r = kSize - 1; r >= 0; --r) f(r);
#endif
  }
  template <class F>
  LZL_FN void one(F&& f) const {
#if defined(__CUDA_ARCH__)
    if ((threadIdx.x & 31u) == 0) f();
    __syncwarp();
#else
    f();
#endif
  }
};

// Staged input, read-only for the whole launch: the card's read-only path.
LZL_FN uint32_t load_byte(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// A little-endian 4-byte word at a 4-byte-aligned address.
LZL_FN uint32_t load_word(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(reinterpret_cast<const unsigned int*>(p));
#else
  uint32_t v;
  memcpy(&v, p, 4);  // the host build runs on little-endian machines
  return v;
#endif
}

// Range decoder over the lane's staged input, with the lane's step budget.
template <class Team, int kOpts>
struct Coder {
  const uint8_t* in;
  int w_in;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  int pos = 0, end = 0;
  int steps = 0, max_steps;
  int err = ERR_NONE;
  uint32_t w0 = 0, w1 = 0;  // kLookahead: the words holding pos and pos + 4
  Team team;

  LZL_FN Coder(const uint8_t* in_, int w_in_, int max_steps_, Team team_)
      : in(in_), w_in(w_in_), max_steps(max_steps_), team(team_) {}

  // Count one micro-op; false (err set) once the budget is spent.
  LZL_FN bool step() {
    if (steps >= max_steps) {
      err = ERR_STEP_CAP;
      return false;
    }
    ++steps;
    return true;
  }

  // Word i of the lane's input, 0 past its end (never consumed: a chunk's
  // bytes end at or before w_in).
  LZL_FN uint32_t word(int i) const {
    return 4 * i + 4 <= w_in ? load_word(in + 4 * i) : 0u;
  }

  LZL_FN void seek(int p) {
    pos = p;
    if (kOpts & kLookahead) {
      w0 = word(p >> 2);
      w1 = word((p >> 2) + 1);
    }
  }

  // The byte at pos, then pos + 1. With kLookahead the next word's load is
  // issued four bytes (some 32 bits) before its first byte is needed.
  LZL_FN uint32_t next_byte() {
    if (kOpts & kNoInput) {
      ++pos;
      return 0u;
    }
    if (!(kOpts & kLookahead)) return load_byte(in + pos++);
    const uint32_t b = (w0 >> ((pos & 3) * 8)) & 0xFFu;
    if ((++pos & 3) == 0) {
      w0 = w1;
      w1 = word((pos >> 2) + 1);
    }
    return b;
  }

  LZL_FN bool normalize() {
    if (range < (1u << 24)) {
      if (pos >= end) {
        err = ERR_EOF;
        return false;
      }
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return true;
  }

  // One adaptive bit: 0 or 1, or -1 with err set.
  LZL_FN int bit(uint16_t* p) {
    if (!step()) return -1;
    const uint32_t pv = (kOpts & kNoProbRead) ? uint32_t(PROB_INIT) : *p;
    team.sync();  // every rank has read *p
    const uint32_t bound = (range >> 11) * pv;
    int b;
    if (code < bound) {
      range = bound;
      if (!(kOpts & kNoProbWrite)) *p = uint16_t(pv + ((0x800u - pv) >> 5));
      b = 0;
    } else {
      code -= bound;
      range -= bound;
      if (!(kOpts & kNoProbWrite)) *p = uint16_t(pv - (pv >> 5));
      b = 1;
    }
    return normalize() ? b : -1;
  }

  // One fixed-probability ("direct") bit.
  LZL_FN int direct_bit() {
    if (!step()) return -1;
    range >>= 1;
    const int b = code >= range;
    if (b) code -= range;
    return normalize() ? b : -1;
  }

  // MSB-first bit tree of nbits: value in [0, 2^nbits), or -1.
  LZL_FN int tree(uint16_t* p, int nbits) {
    uint32_t m = 1;
    for (int i = 0; i < nbits; ++i) {
      const int b = bit(&p[m]);
      if (b < 0) return -1;
      m = (m << 1) | uint32_t(b);
    }
    return int(m - (1u << nbits));
  }

  // LSB-first (reverse) bit tree of nbits, or -1.
  LZL_FN int rtree(uint16_t* p, int nbits) {
    uint32_t m = 1, r = 0;
    for (int i = 0; i < nbits; ++i) {
      const int b = bit(&p[m]);
      if (b < 0) return -1;
      m = (m << 1) | uint32_t(b);
      r |= uint32_t(b) << i;
    }
    return int(r);
  }
};

// Match length minus 2 (0..271), or -1.
template <class C>
LZL_FN int decode_len(C& c, uint16_t* base, int pos_state) {
  int b = c.bit(&base[0]);
  if (b < 0) return -1;
  if (!b) return c.tree(base + LEN_LOW + pos_state * 8, 3);
  b = c.bit(&base[1]);
  if (b < 0) return -1;
  if (!b) {
    const int v = c.tree(base + LEN_MID + pos_state * 8, 3);
    return v < 0 ? -1 : v + 8;
  }
  const int v = c.tree(base + LEN_HIGH, 8);
  return v < 0 ? -1 : v + 16;
}

// Distance field (rep0 to be) of a new match; false on error.
template <class C>
LZL_FN bool decode_distance(C& c, uint16_t* P, const Layout& lay, int len,
                            uint32_t* out) {
  const int len_state = len < 3 ? len : 3;
  const int slot = c.tree(P + lay.pos_slot + len_state * 64, 6);
  if (slot < 0) return false;
  if (slot < 4) {
    *out = uint32_t(slot);
    return true;
  }
  const int ndirect = (slot >> 1) - 1;
  const uint32_t base = (2u | uint32_t(slot & 1)) << ndirect;
  if (slot < 14) {
    const int r = c.rtree(P + lay.spec_pos + (base - slot), ndirect);
    if (r < 0) return false;
    *out = base + uint32_t(r);
    return true;
  }
  uint32_t acc = 0;
  for (int i = 0; i < ndirect - 4; ++i) {
    const int b = c.direct_bit();
    if (b < 0) return false;
    acc = (acc << 1) | uint32_t(b);
  }
  const int r = c.rtree(P + lay.align, 4);
  if (r < 0) return false;
  *out = base + (acc << 4) + uint32_t(r);
  return true;
}

// How a match copy of len bytes ends. The lockstep decoder runs, for each
// byte, one step (ERR_STEP_CAP once the budget is spent) and then the
// chunk-end test (ERR_SIZE at outend). With s = max_steps - steps steps
// left and o = outend - outp bytes left in the chunk:
//   len <= min(s, o):    all len bytes, len steps;
//   s <= o and s < len:  s bytes, s steps, ERR_STEP_CAP;
//   else (o < s, o < len): o bytes, o + 1 steps, ERR_SIZE.
struct CopySplit {
  int n, steps, err;
};

LZL_FN CopySplit split_copy(int len, int steps, int max_steps, int outp,
                            int outend) {
  const int s = max_steps - steps, o = outend - outp;
  if (len <= s && len <= o) return CopySplit{len, len, ERR_NONE};
  if (s <= o) return CopySplit{s, s, ERR_STEP_CAP};
  return CopySplit{o, o + 1, ERR_SIZE};
}

// Rank r of a team of t threads writes bytes r, r + t, ... of an n-byte
// copy from dist back. Byte i of the copy is win[outp - dist + i % dist]:
// a byte that existed before the copy, so every distance works (dist < n
// overlaps) and the ranks need no order among themselves. kNoPort stores
// 0 without the read; kNoWinWrite stores nothing.
template <int kOpts = 0>
LZL_FN void copy_rank(uint8_t* win, int outp, int dist, int n, int r,
                      int t) {
  if ((kOpts & kNoWinWrite) || r >= n) return;
  const uint8_t* src = win + (outp - dist);
  int j = r < dist ? r : r % dist;
  const int dj = t < dist ? t : t % dist;
  for (int i = r; i < n; i += t) {
    win[outp + i] = (kOpts & kNoPort) ? uint8_t(0) : src[j];
    j += dj;
    if (j >= dist) j -= dist;
  }
}

// A match copy of len bytes from dist back (dist <= outp checked by the
// caller), split as split_copy says; false (err set) if the lane stops.
template <class Team, int kOpts>
LZL_FN bool copy_match(Coder<Team, kOpts>& c, uint8_t* win, int& outp,
                       int outend, int dist, int len) {
  const CopySplit s = split_copy(len, c.steps, c.max_steps, outp, outend);
  const int at = outp;
  if (kOpts & kWarpCopy) {
    c.team.each([&](int r) {
      copy_rank<kOpts>(win, at, dist, s.n, r, Team::kSize);
    });
  } else if (!(kOpts & kNoWinWrite)) {
    c.team.one([&] {
      for (int i = 0; i < s.n; ++i) {
        win[at + i] = (kOpts & kNoPort) ? uint8_t(0) : win[at + i - dist];
      }
    });
  }
  outp += s.n;
  c.steps += s.steps;
  if (s.err != ERR_NONE) {
    c.err = s.err;
    return false;
  }
  return true;
}

// Every probability back to PROB_INIT, split over the team; the barrier
// before it keeps a slower rank's last store from landing after the fill.
template <class Team>
LZL_FN void refill(const Team& team, uint16_t* P, int total) {
  team.sync();
  team.each([&](int r) {
    for (int i = r; i < total; i += Team::kSize) P[i] = PROB_INIT;
  });
}

struct LaneResult {
  int32_t err, outp, steps;
  int32_t restarts;  // kSpin: the times the lane started its segment again
};

// Decode one lane. in: w_in staged bytes; win: w bytes, prefilled with the
// segment's stored chunks; P: Layout(nlit).total probabilities; chunk
// tables: k entries each (lane-local offsets, pack_chunk_meta fields).
template <class Team, int kOpts>
LZL_FN LaneResult decode_lane(Team team, const uint8_t* in, int w_in,
                              uint8_t* win, int w, uint16_t* P, int nlit,
                              const int32_t* in_start, const int32_t* in_end,
                              const int32_t* out_start,
                              const int32_t* out_end, const int32_t* meta,
                              int k, int max_steps) {
  const Layout lay(nlit);
  refill(team, P, lay.total);
  Coder<Team, kOpts> c(in, w_in, max_steps, team);
  int outp = 0, state = 0, lc = 0, lp = 0, pb = 0;
  uint32_t rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  int restarts = 0;

again:
  for (int ci = 0;; ++ci) {
    if (!c.step()) break;  // the chunk-setup micro-op
    const int m = ci < k ? meta[ci] : 0;
    if (!((m >> 12) & 1)) break;  // no further chunk: the lane is done
    const int s = in_start[ci], e = in_end[ci];
    const int os = out_start[ci], oe = out_end[ci];
    if (s < 0 || e > w_in || os < 0 || os > oe || oe > w || e - s < 5) {
      c.err = ERR_SHORT;
      break;
    }
    if ((m & 3) == 1) {
      refill(team, P, lay.total);
      state = 0;
      rep0 = rep1 = rep2 = rep3 = 0;
    }
    lc = (m >> 2) & 15;
    lc = lc < 8 ? lc : 8;
    lp = (m >> 6) & 7;
    pb = (m >> 9) & 7;
    c.range = 0xFFFFFFFFu;
    c.code = (load_byte(in + s + 1) << 24) | (load_byte(in + s + 2) << 16) |
             (load_byte(in + s + 3) << 8) | load_byte(in + s + 4);
    c.seek(s + 5);
    c.end = e;
    outp = os;

    while (outp < oe) {  // one symbol per pass
      const int ps = outp & ((1 << pb) - 1) & 15;
      int b = c.bit(&P[lay.is_match + (state << 4) + ps]);
      if (b < 0) goto done;
      if (!b) {
        // literal, context from the previous byte (0 at the segment start)
        const uint32_t prev = outp > 0 ? win[outp - 1] : 0u;
        const int ctx =
            (((outp & ((1 << lp) - 1)) << lc) + int(prev >> (8 - lc))) &
            (nlit - 1);
        uint16_t* lit = P + ctx * LIT_ROW;
        uint32_t sym = 1;
        if (state >= 7) {
          if (uint64_t(rep0) + 1 > uint64_t(outp)) {
            c.err = ERR_MATCHDIST;
            goto done;
          }
          uint32_t mb;
          if constexpr ((kOpts & kNoPort) != 0) {
            mb = 0;
          } else {
            mb = win[outp - 1 - int(rep0)];
          }
          do {
            const uint32_t mbit = (mb >> 7) & 1;
            mb = (mb << 1) & 0xFF;
            b = c.bit(&lit[((1 + mbit) << 8) + sym]);
            if (b < 0) goto done;
            sym = (sym << 1) | uint32_t(b);
            if (mbit != uint32_t(b)) break;
          } while (sym < 0x100);
        }
        while (sym < 0x100) {
          b = c.bit(&lit[sym]);
          if (b < 0) goto done;
          sym = (sym << 1) | uint32_t(b);
        }
        if constexpr ((kOpts & kNoWinWrite) != 0) {
          ++outp;
        } else {
          win[outp++] = uint8_t(sym);  // every rank stores the same byte
        }
        state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
        continue;
      }

      int len;
      b = c.bit(&P[lay.is_rep + state]);
      if (b < 0) goto done;
      if (b) {
        b = c.bit(&P[lay.is_rep_g0 + state]);
        if (b < 0) goto done;
        if (!b) {
          b = c.bit(&P[lay.is_rep_0long + (state << 4) + ps]);
          if (b < 0) goto done;
          if (!b) {  // short rep: one byte from rep0
            state = state < 7 ? 9 : 11;
            if (uint64_t(rep0) + 1 > uint64_t(outp)) {
              c.err = ERR_DIST_OUT;
              goto done;
            }
            if (!copy_match(c, win, outp, oe, int(rep0) + 1, 1)) goto done;
            continue;
          }
        } else {
          uint32_t d;
          b = c.bit(&P[lay.is_rep_g1 + state]);
          if (b < 0) goto done;
          if (!b) {
            d = rep1;
          } else {
            b = c.bit(&P[lay.is_rep_g2 + state]);
            if (b < 0) goto done;
            if (!b) {
              d = rep2;
            } else {
              d = rep3;
              rep3 = rep2;
            }
            rep2 = rep1;
          }
          rep1 = rep0;
          rep0 = d;
        }
        len = decode_len(c, P + lay.rep_len, ps);
        if (len < 0) goto done;
        state = state < 7 ? 8 : 11;
      } else {
        rep3 = rep2;
        rep2 = rep1;
        rep1 = rep0;
        len = decode_len(c, P + lay.len, ps);
        if (len < 0) goto done;
        state = state < 7 ? 7 : 10;
        uint32_t d;
        if (!decode_distance(c, P, lay, len, &d)) goto done;
        if (d == 0xFFFFFFFFu) {
          // end marker: symbols run only while outp < the chunk's end, so
          // a finished coder here still leaves the chunk short
          c.err = (c.code == 0 && c.pos >= c.end) ? ERR_SIZE : ERR_EOS_EXTRA;
          goto done;
        }
        rep0 = d;
      }
      if (uint64_t(rep0) + 1 > uint64_t(outp)) {
        c.err = ERR_DIST_OUT;
        goto done;
      }
      if (!copy_match(c, win, outp, oe, int(rep0) + 1, len + 2)) goto done;
    }
  }
done:
  if (kOpts & kSpin) {
    // every pass takes at least its first chunk-setup step, so the
    // budget ends the loop
    if (c.steps < max_steps) {
      ++restarts;
      refill(team, P, lay.total);
      c.err = ERR_NONE;
      outp = out_start[0];
      state = 0;
      rep0 = rep1 = rep2 = rep3 = 0;
      goto again;
    }
    c.err = ERR_STEP_CAP;
  }
  return LaneResult{c.err, outp, c.steps, restarts};
}

}  // namespace lzl

#if defined(LZL_HOST_ENTRY) && !defined(__CUDACC__)
// Host loop over lanes with the kernel's buffer layout (tests only). code
// picks the decoder build, as the variant's code: 0 a thread a lane, one
// byte copied a step (V0 and S3); 1 the decoder (a warp a lane; V1-V3
// place its table and window, which the host build does not model); 4 a
// warp with one thread copying (V4); 5 the decoder with the input
// look-ahead (V5); 16 + c the step-cost case c (the decoder with
// kAblated[c], step_cost.cu's case c), which also writes restarts (null
// for the other codes). The window is decoded in place.
template <class Team, int kOpts>
static void lzl_host_lanes(const uint8_t* inbuf, uint8_t* win,
                           uint16_t* probs, const int32_t* in_start,
                           const int32_t* in_end, const int32_t* out_start,
                           const int32_t* out_end, const int32_t* chunk_meta,
                           int32_t* err, int32_t* outp, int32_t* steps,
                           int32_t* restarts, int L, int w_in, int w,
                           int nprobs, int nlit, int k, int max_steps) {
  for (int l = 0; l < L; ++l) {
    const size_t t = size_t(l) * size_t(k);
    const lzl::LaneResult r = lzl::decode_lane<Team, kOpts>(
        Team{}, inbuf + size_t(l) * size_t(w_in), w_in,
        win + size_t(l) * size_t(w), w, probs + size_t(l) * size_t(nprobs),
        nlit, in_start + t, in_end + t, out_start + t, out_end + t,
        chunk_meta + t, k, max_steps);
    err[l] = r.err;
    outp[l] = r.outp;
    steps[l] = r.steps;
    if (kOpts & lzl::kSpin) restarts[l] = r.restarts;
  }
}

extern "C" int lzl_decode_segments_host(
    const uint8_t* inbuf, uint8_t* win, uint16_t* probs,
    const int32_t* in_start, const int32_t* in_end, const int32_t* out_start,
    const int32_t* out_end, const int32_t* chunk_meta, int32_t* err,
    int32_t* outp, int32_t* steps, int32_t* restarts, int L, int w_in,
    int w, int nprobs, int nlit, int k, int max_steps, int code) {
  using lzl::Solo;
  using lzl::Warp;
  using lzl::kAblated;
  using lzl::kDecoder;
  if (code >= 16 && code < 23 && restarts == nullptr) return -1;
#define LZL_HOST_RUN(TEAM, OPTS)                                           \
  lzl_host_lanes<TEAM, OPTS>(inbuf, win, probs, in_start, in_end,          \
                             out_start, out_end, chunk_meta, err, outp,    \
                             steps, restarts, L, w_in, w, nprobs, nlit, k, \
                             max_steps)
  switch (code) {
    case 0: LZL_HOST_RUN(Solo, 0); return 0;
    case 1: LZL_HOST_RUN(Warp, kDecoder); return 0;
    case 4: LZL_HOST_RUN(Warp, 0); return 0;
    case 5: LZL_HOST_RUN(Warp, kDecoder | lzl::kLookahead); return 0;
    case 16: LZL_HOST_RUN(Warp, kDecoder | kAblated[0]); return 0;
    case 17: LZL_HOST_RUN(Warp, kDecoder | kAblated[1]); return 0;
    case 18: LZL_HOST_RUN(Warp, kDecoder | kAblated[2]); return 0;
    case 19: LZL_HOST_RUN(Warp, kDecoder | kAblated[3]); return 0;
    case 20: LZL_HOST_RUN(Warp, kDecoder | kAblated[4]); return 0;
    case 21: LZL_HOST_RUN(Warp, kDecoder | kAblated[5]); return 0;
    case 22: LZL_HOST_RUN(Warp, kDecoder | kAblated[6]); return 0;
    default: return -1;
  }
#undef LZL_HOST_RUN
}

// One match copy as the decoder's warp runs it (split_copy, then every
// rank's copy_rank, the ranks in order, or the last first when reverse is
// set): res = {outp, steps, err} after it.
extern "C" int lzl_match_copy_host(uint8_t* win, int outp, int outend,
                                   int dist, int len, int steps,
                                   int max_steps, int reverse, int32_t* res) {
  const lzl::CopySplit s = lzl::split_copy(len, steps, max_steps, outp,
                                           outend);
  constexpr int t = lzl::Warp::kSize;
  for (int i = 0; i < t; ++i) {
    lzl::copy_rank(win, outp, dist, s.n, reverse ? t - 1 - i : i, t);
  }
  res[0] = outp + s.n;
  res[1] = steps + s.steps;
  res[2] = s.err;
  return 0;
}

extern "C" int lzl_probs_bytes_host(int nlit) { return lzl::probs_bytes(nlit); }
#endif

#endif  // LZMA_RS_TPU_TORCH_LZMA_LANE_CUH_
