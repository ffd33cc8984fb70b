// The device CRC's arithmetic: the raw CRC32 / CRC64-XZ register (init 0,
// no final XOR) of L 4 KiB chunks, in stream order, shared by the kernel
// (crc_blocks.cu) and a host test build.
//
// The register is linear over GF(2), so for pieces p_0 .. p_{n-1} of a
// stream
//
//     raw(p_0 || ... || p_{n-1}) = XOR_i Z_{s_i}(raw(p_i)),
//
// where s_i is the number of bytes after p_i and Z_s advances a register by
// s zero bytes: combine_raw's right ^ Z_{|right|}(left)
// (ops/crc_device.py), summed over every split at once. So each piece's
// register is advanced to the stream's end on its own and the pieces are
// XORed in any order. A lane's piece is 128 bytes of a chunk: its register
// by slice-by-8 (eight tables of 256 entries, t[k][v] the register of byte
// v followed by k zero bytes; reflected: a byte enters the register's low
// byte, bit 0 first), advanced past the chunk's later lanes, XORed over the
// warp; then the chunk's register advanced past the later chunks. Every
// advance is by a multiple of a power of two, so every map is one of
// Z_{2^j} (j < kMaps), applied bit by bit of the multiple: the lanes' maps
// are Z_{2^7} .. Z_{2^11}, the chunks' Z_{2^12} and up. A map is applied
// through its nibble table, n[q * 16 + v] = Z(v << 4q): W / 4 lookups and
// XORs in place of W column selects.
//
// The tables are built on the host from the GF(2) machinery of
// ops/crc_device.py (slice_table, power_maps, nibble_table) and passed in.
#ifndef LZMA_RS_TPU_TORCH_CRC_KERNEL_CUH_
#define LZMA_RS_TPU_TORCH_CRC_KERNEL_CUH_

#include <stdint.h>

#if defined(__CUDACC__)
#define LZC_FN __host__ __device__ inline
#define LZC_UNROLL _Pragma("unroll")
#else
#define LZC_FN inline
#define LZC_UNROLL
#endif

namespace lzc {

constexpr int kChunk = 4096;  // bytes a chunk (ops/crc_device.py CHUNK)
constexpr int kLanes = 32;    // a warp a chunk
constexpr int kStretch = kChunk / kLanes;  // 128 bytes a lane
constexpr int kStretchWords = kStretch / 8;
constexpr int kStretchLog = 7;  // kStretch = 2^7
constexpr int kChunkLog = 12;   // kChunk = 2^12
constexpr int kLaneMaps = 5;    // kLanes = 2^5: Z_{2^7} .. Z_{2^11}
// Z_{2^j} for j < kMaps: a chunk advances by at most (2^31 - 2) chunks,
// under 2^43 bytes.
constexpr int kMaps = 43;

// The register of each width (the 64-bit one is the type of atomicXor and
// of the warp shuffles) and the entries of one map's nibble table.
template <int W> struct Width;
template <> struct Width<32> {
  using Reg = uint32_t;
  static constexpr int kNib = 32 / 4 * 16;
};
template <> struct Width<64> {
  using Reg = unsigned long long;
  static constexpr int kNib = 64 / 4 * 16;
};

// Eight bytes (the little-endian word w) into the register r: slice-by-8
// over t[k * 256 + v]. For CRC32 the register's high half is 0, so bytes
// 4-7 of x are the input's own.
template <typename Reg>
LZC_FN Reg step8(const Reg* t, Reg r, uint64_t w) {
  const uint64_t x = uint64_t(r) ^ w;
  return t[7 * 256 + int(x & 255)] ^ t[6 * 256 + int((x >> 8) & 255)] ^
         t[5 * 256 + int((x >> 16) & 255)] ^
         t[4 * 256 + int((x >> 24) & 255)] ^
         t[3 * 256 + int((x >> 32) & 255)] ^
         t[2 * 256 + int((x >> 40) & 255)] ^
         t[1 * 256 + int((x >> 48) & 255)] ^ t[int(x >> 56)];
}

// Z(x) for the map whose nibble table is n.
template <int W, typename Reg>
LZC_FN Reg advance(const Reg* n, Reg x) {
  Reg y = 0;
  LZC_UNROLL
  for (int q = 0; q < W / 4; ++q) {
    y ^= n[q * 16 + int((x >> (4 * q)) & 15)];
  }
  return y;
}

// The raw register (from 0) of a lane's 128 bytes, as 16 words.
template <typename Reg>
LZC_FN Reg stretch_register(const Reg* t, const uint64_t* words) {
  Reg r = 0;
  LZC_UNROLL
  for (int j = 0; j < kStretchWords; ++j) r = step8(t, r, words[j]);
  return r;
}

// r advanced by k units of 2^first bytes: Z_{2^(first+b)} for each set
// bit b of k (maps: the nibble tables of Z_{2^first}, Z_{2^(first+1)},
// ...). The loop runs to k's highest bit.
template <int W, typename Reg>
LZC_FN Reg advance_units(const Reg* maps, Reg r, long long k) {
  for (int b = 0; k != 0; ++b, k >>= 1) {
    if (k & 1) r = advance<W>(maps + b * Width<W>::kNib, r);
  }
  return r;
}

// A lane's register advanced past the chunk's later lanes
// (lane_maps: Z_{2^7} .. Z_{2^11}). The loop is the same for every lane.
template <int W, typename Reg>
LZC_FN Reg lane_to_chunk_end(const Reg* lane_maps, Reg r, int lane) {
  const int k = kLanes - 1 - lane;
  LZC_UNROLL
  for (int b = 0; b < kLaneMaps; ++b) {
    if ((k >> b) & 1) r = advance<W>(lane_maps + b * Width<W>::kNib, r);
  }
  return r;
}

// A chunk's register advanced past the later chunks of the L (maps: all
// kMaps nibble tables).
template <int W, typename Reg>
LZC_FN Reg chunk_to_end(const Reg* maps, Reg r, long long chunk, long long L) {
  return advance_units<W>(maps + kChunkLog * Width<W>::kNib, r,
                          L - 1 - chunk);
}

}  // namespace lzc

#if defined(LZC_HOST_ENTRY) && !defined(__CUDACC__)
#include <string.h>

namespace lzc {

template <int W>
void host_blocks(const uint8_t* data, int L, const void* slice,
                 const void* maps, unsigned long long* out) {
  using Reg = typename Width<W>::Reg;
  const Reg* t = static_cast<const Reg*>(slice);
  const Reg* z = static_cast<const Reg*>(maps);
  const Reg* lane_maps = z + kStretchLog * Width<W>::kNib;
  unsigned long long acc = 0;
  for (long long c = 0; c < L; ++c) {
    Reg chunk = 0;  // the warp's XOR, lane by lane
    for (int lane = 0; lane < kLanes; ++lane) {
      uint64_t words[kStretchWords];
      memcpy(words, data + c * kChunk + lane * kStretch, kStretch);
      chunk ^= lane_to_chunk_end<W>(lane_maps, stretch_register(t, words),
                                    lane);
    }
    acc ^= chunk_to_end<W>(z, chunk, c, L);
  }
  *out ^= acc;
}

}  // namespace lzc

// The kernel's arithmetic on the host, chunk by chunk and lane by lane,
// with the kernel's arguments (tests only; little-endian hosts): XORs the
// raw register of the L chunks at data into *out.
extern "C" int lzc_crc_blocks_host(int width, const uint8_t* data, int L,
                                   const void* slice, const void* maps,
                                   int nmaps, unsigned long long* out) {
  if (nmaps != lzc::kMaps || L < 1) return 1;
  if (width == 32) {
    lzc::host_blocks<32>(data, L, slice, maps, out);
  } else if (width == 64) {
    lzc::host_blocks<64>(data, L, slice, maps, out);
  } else {
    return 1;
  }
  return 0;
}
#endif

#endif  // LZMA_RS_TPU_TORCH_CRC_KERNEL_CUH_
