// One lane of the lane engine: a dict-reset segment (or a raw LZMA stream)
// decoded in place in the flat output, with the JAX lane kernel's contract
// (lzma_rs_tpu/ops/lane_decoder.py::decode_lanes): the flat archive, the
// flat output with the stored chunks placed, chunk tables [L, K] of
// absolute offsets, per-chunk props, and per lane its chunk count, segment
// base, size_known and dictionary size.
//
// The lane runs lzma_lane.cuh's decode_lane with kLaneEngine on a window
// that is its own slice of the output (out + seg_base), bounded by its last
// chunk's out_end and nothing else, so any dictionary size works; its input
// is the archive itself, no per-lane staging. Before it decodes, the team
// packs the lane's props into decode_lane's chunk_meta and makes its
// out_start / out_end relative to seg_base, in a [3, L, K] scratch in
// global memory (props clamped to the fields' widths: lc <= 8, lp, pb <=
// 7). Checks that keep every access inside the buffers: a chunk off the
// input, off the lane's window or shorter than 5 bytes is ERR_SHORT; a lane
// whose seg_base or last out_end lies off the output gets an empty window.
//
// Compiled for the card by decode_lanes.cu (a warp a lane) and, as a test
// aid, for the host by g++ (-x c++ -DLZL_HOST_ENTRY), so the lane's logic
// is checked on the CPU against the plain PyTorch version
// (ops/lane_decoder.py::decode_lanes_reference).
#ifndef LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_
#define LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_

#include <stdint.h>

#include "lzma_lane.cuh"

namespace lzl {

// lc + lp <= 4: the literal table of models/state.py's LAYOUT_LCLP4.
constexpr int kLaneNlit = 16;
constexpr int kLaneOpts = kDecoder | kLaneEngine;

struct LaneArgs {
  const uint8_t* in;   // [in_len] the archive
  uint8_t* out;        // [out_len] the output, stored chunks placed
  int32_t* scratch;    // [3, L, K]: chunk_meta, out_start, out_end (lane)
  const int32_t *in_start, *in_end, *out_start, *out_end, *reset, *lc, *lp,
      *pb;                                     // [L, K]
  const int32_t *nchunks, *seg_base, *size_known;  // [L]
  const int64_t* dict_size;                    // [L]
  int32_t *err, *outp, *steps;                 // [L]
  int L, K, in_len, out_len;
  int max_steps;  // <= 0: each lane's own budget (lane_budget)
};

// A lane's step budget. As ops/segment_decoder.py::default_max_steps
// argues for a bucket, no lane, valid or corrupt, takes more than
// 22 * w + K + 1 steps for a w-byte window, so the budget is a guard that
// never fires on a valid stream, up to the int32 step count (w < 89 MB).
LZL_FN int lane_budget(int64_t w, int n, int max_steps) {
  int64_t b = 24 * w + 2 * int64_t(n) + 64;
  if (b > 0x7FFFFFFF) b = 0x7FFFFFFF;
  if (max_steps > 0 && max_steps < b) b = max_steps;
  return int(b);
}

LZL_FN int32_t clamp_to(int64_t v, int64_t lo, int64_t hi) {
  return int32_t(v < lo ? lo : (v > hi ? hi : v));
}

struct LaneOut {
  int32_t err, outp, steps;  // outp absolute
};

template <class Team>
LZL_FN LaneOut run_lane(const LaneArgs& a, int lane, uint16_t* P) {
  const Team team{};
  const size_t t = size_t(lane) * size_t(a.K);
  const size_t plane = size_t(a.L) * size_t(a.K);
  int32_t* const meta = a.scratch + t;
  int32_t* const os = a.scratch + plane + t;
  int32_t* const oe = a.scratch + 2 * plane + t;
  const int n = clamp_to(a.nchunks[lane], 0, a.K);
  const int64_t base = a.seg_base[lane];
  const bool in_out = base >= 0 && base <= a.out_len;
  int64_t w = 0;
  if (n > 0 && in_out) {
    const int64_t last = a.out_end[t + size_t(n - 1)];
    if (last >= base && last <= a.out_len) w = last - base;
  }
  team.each([&](int r) {
    for (int ci = r; ci < a.K; ci += Team::kSize) {
      const size_t i = t + size_t(ci);
      meta[ci] = (a.reset[i] == 1 ? 1 : 0) | (clamp_to(a.lc[i], 0, 8) << 2) |
                 (clamp_to(a.lp[i], 0, 7) << 6) |
                 (clamp_to(a.pb[i], 0, 7) << 9) | ((ci < n ? 1 : 0) << 12);
      os[ci] = clamp_to(int64_t(a.out_start[i]) - base, -1, 0x7FFFFFFF);
      oe[ci] = clamp_to(int64_t(a.out_end[i]) - base, -1, 0x7FFFFFFF);
    }
  });
  const int64_t d = a.dict_size[lane];
  const uint32_t dict =
      d < 0 ? 0u : (d > 0xFFFFFFFFll ? 0xFFFFFFFFu : uint32_t(d));
  const int64_t at = in_out ? base : 0;
  const LaneResult r = decode_lane<Team, kLaneOpts>(
      team, a.in, a.in_len, a.out + at, int(w), P, kLaneNlit,
      a.in_start + t, a.in_end + t, os, oe, meta, a.K,
      lane_budget(w, n, a.max_steps), dict,
      a.size_known[lane] == 0 ? 0 : 1);
  return LaneOut{r.err, int32_t(at + r.outp), r.steps};
}

}  // namespace lzl

#if defined(LZL_HOST_ENTRY) && !defined(__CUDACC__)
#include <vector>

// The kernel's lanes one after another, a warp played by one thread (the
// ranks last first), with the kernel's arguments (tests only). The output
// is decoded in place; scratch is [3, L, K] int32.
extern "C" int lzl_decode_lanes_host(
    const uint8_t* in, uint8_t* out, int32_t* scratch,
    const int32_t* in_start, const int32_t* in_end, const int32_t* out_start,
    const int32_t* out_end, const int32_t* reset, const int32_t* lc,
    const int32_t* lp, const int32_t* pb, const int32_t* nchunks,
    const int32_t* seg_base, const int32_t* size_known,
    const int64_t* dict_size, int32_t* err, int32_t* outp, int32_t* steps,
    int L, int K, int in_len, int out_len, int max_steps) {
  const lzl::LaneArgs a{in,        out,       scratch, in_start, in_end,
                        out_start, out_end,   reset,   lc,       lp,
                        pb,        nchunks,   seg_base, size_known,
                        dict_size, err,       outp,    steps,    L,
                        K,         in_len,    out_len, max_steps};
  std::vector<uint16_t> P(size_t(lzl::Layout(lzl::kLaneNlit).total));
  for (int l = 0; l < L; ++l) {
    const lzl::LaneOut r = lzl::run_lane<lzl::Warp>(a, l, P.data());
    err[l] = r.err;
    outp[l] = r.outp;
    steps[l] = r.steps;
  }
  return 0;
}
#endif

#endif  // LZMA_RS_TPU_TORCH_LANE_ENGINE_CUH_
