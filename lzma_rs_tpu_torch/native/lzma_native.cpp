// Native host runtime for lzma_rs_tpu: scalar LZMA/LZMA2 decoder + CRC64.
//
// This is the C++ counterpart of the Python executable spec in
// models/spec.py — the fast host path for serial work (single segments,
// streaming) while bulk decode goes to the TPU kernels. Behavior (outputs
// and error strings) mirrors the reference implementation:
//   range coder:      /root/reference/src/decode/rangecoder.rs:7-152
//   state machine:    /root/reference/src/decode/lzma.rs:165-593
//   output windows:   /root/reference/src/decode/lzbuffer.rs:4-321
//   LZMA2 chunk loop: /root/reference/src/decode/lzma2.rs:11-230
//
// Exposed C ABI (see native/loader.py):
//   lrt_crc64_update, lrt_lzma_decode, lrt_lzma2_decode,
//   lrt_stream_* (incremental push-style decoding), lrt_free.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <type_traits>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC64-XZ (reflected poly 0xC96C5795D7870F42), slice-by-8.
// ---------------------------------------------------------------------------

struct Crc64Tables {
  uint64_t t[8][256];
  Crc64Tables() {
    const uint64_t poly = 0xC96C5795D7870F42ULL;
    for (int i = 0; i < 256; i++) {
      uint64_t crc = i;
      for (int k = 0; k < 8; k++) crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      t[0][i] = crc;
    }
    for (int s = 1; s < 8; s++)
      for (int i = 0; i < 256; i++)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const Crc64Tables kCrc64;

uint64_t crc64_update(uint64_t crc, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = kCrc64.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    n--;
  }
  while (n >= 8) {
    uint64_t x;
    memcpy(&x, p, 8);
    x ^= crc;
    crc = kCrc64.t[7][x & 0xFF] ^ kCrc64.t[6][(x >> 8) & 0xFF] ^
          kCrc64.t[5][(x >> 16) & 0xFF] ^ kCrc64.t[4][(x >> 24) & 0xFF] ^
          kCrc64.t[3][(x >> 32) & 0xFF] ^ kCrc64.t[2][(x >> 40) & 0xFF] ^
          kCrc64.t[1][(x >> 48) & 0xFF] ^ kCrc64.t[0][(x >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = kCrc64.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

// ---------------------------------------------------------------------------
// Error plumbing: code 1 = LzmaError, 2 = IoError (EOF & friends).
// ---------------------------------------------------------------------------

struct Err {
  int code = 0;
  std::string msg;
  bool ok() const { return code == 0; }
};

constexpr const char* kEofMsg = "failed to fill whole buffer";

// ---------------------------------------------------------------------------
// Range decoder (rangecoder.rs:7-152). Reads from a bounded byte span.
// ---------------------------------------------------------------------------

struct RangeDecoder {
  const uint8_t* buf;
  size_t pos, end;
  uint32_t range = 0xFFFFFFFFu, code = 0;

  bool init(Err& e) {  // skip 1 byte, read u32 BE (rangecoder.rs:26-27)
    if (end - pos < 5) {
      pos = end;
      e = {2, kEofMsg};
      return false;
    }
    pos++;
    code = (uint32_t(buf[pos]) << 24) | (uint32_t(buf[pos + 1]) << 16) |
           (uint32_t(buf[pos + 2]) << 8) | uint32_t(buf[pos + 3]);
    pos += 4;
    return true;
  }

  bool is_eof() const { return pos >= end; }
  bool is_finished_ok() const { return code == 0 && is_eof(); }

  template <bool CHECKED = true>
  inline bool normalize(Err& e) {
    if (range < 0x0100'0000u) {
      if (CHECKED && pos >= end) {
        e = {2, kEofMsg};
        return false;
      }
      range <<= 8;
      code = (code << 8) ^ buf[pos++];
    }
    return true;
  }

  template <bool CHECKED = true>
  inline int get_bit(Err& e) {
    range >>= 1;
    int bit = code >= range;
    if (bit) code -= range;
    if (!normalize<CHECKED>(e)) return -1;
    return bit;
  }

  template <bool CHECKED = true>
  inline int64_t get(int count, Err& e) {
    uint32_t result = 0;
    for (int i = 0; i < count; i++) {
      int b = get_bit<CHECKED>(e);
      if (b < 0) return -1;
      result = (result << 1) ^ uint32_t(b);
    }
    return result;
  }

  template <bool CHECKED = true, bool UPDATE = true>
  inline int decode_bit(uint16_t* prob, Err& e) {
    uint32_t bound = (range >> 11) * uint32_t(*prob);
    int bit;
    if (code < bound) {
      if (UPDATE) *prob += (0x800 - *prob) >> 5;
      range = bound;
      bit = 0;
    } else {
      if (UPDATE) *prob -= *prob >> 5;
      code -= bound;
      range -= bound;
      bit = 1;
    }
    if (!normalize<CHECKED>(e)) return -1;
    return bit;
  }

  inline int decode_bit(uint16_t* prob, bool update, Err& e) {
    return update ? decode_bit<true, true>(prob, e)
                  : decode_bit<true, false>(prob, e);
  }

  template <bool CHECKED = true, bool UPDATE = true>
  inline int64_t parse_bit_tree(int num_bits, uint16_t* probs, Err& e) {
    uint32_t tmp = 1;
    for (int i = 0; i < num_bits; i++) {
      int b = decode_bit<CHECKED, UPDATE>(&probs[tmp], e);
      if (b < 0) return -1;
      tmp = (tmp << 1) ^ uint32_t(b);
    }
    return tmp - (1u << num_bits);
  }

  inline int64_t parse_bit_tree(int num_bits, uint16_t* probs, bool update,
                                Err& e) {
    return update ? parse_bit_tree<true, true>(num_bits, probs, e)
                  : parse_bit_tree<true, false>(num_bits, probs, e);
  }

  template <bool CHECKED = true, bool UPDATE = true>
  inline int64_t parse_reverse_bit_tree(int num_bits, uint16_t* probs,
                                        size_t offset, Err& e) {
    uint32_t result = 0;
    size_t tmp = 1;
    for (int i = 0; i < num_bits; i++) {
      int b = decode_bit<CHECKED, UPDATE>(&probs[offset + tmp], e);
      if (b < 0) return -1;
      tmp = (tmp << 1) ^ size_t(b);
      result ^= uint32_t(b) << i;
    }
    return result;
  }

  inline int64_t parse_reverse_bit_tree(int num_bits, uint16_t* probs,
                                        size_t offset, bool update, Err& e) {
    return update
               ? parse_reverse_bit_tree<true, true>(num_bits, probs, offset, e)
               : parse_reverse_bit_tree<true, false>(num_bits, probs, offset, e);
  }
};

// ---------------------------------------------------------------------------
// LZ output windows (lzbuffer.rs). Both flavors flush into `out`.
// ---------------------------------------------------------------------------

struct OutputBuffer {
  std::string out;          // flushed output
  std::vector<uint8_t> buf; // live window
  bool circular = false;
  size_t dict_size = 0;
  uint64_t memlimit = UINT64_MAX;
  size_t cursor = 0; // circular only
  uint64_t len = 0;  // bytes since last reset (accum) / total (circular)
  // accum mode: distances past this are format errors (flat-window
  // one-shot raw-LZMA decode — replicates the circular window's
  // dictionary-size checks without the wrap machinery)
  uint64_t dict_limit = UINT64_MAX;

  // --- accum mode (LzAccumBuffer, lzbuffer.rs:39-165)
  void reset_accum() {
    out.append(reinterpret_cast<const char*>(buf.data()), buf.size());
    buf.clear();
    len = 0;
  }
  // --- common
  uint8_t last_or(uint8_t lit) const {
    if (circular) {
      if (len == 0) return lit;
      size_t idx = (dict_size + cursor - 1) % dict_size;
      return idx < buf.size() ? buf[idx] : 0;
    }
    return buf.empty() ? lit : buf.back();
  }
  bool last_n(uint64_t dist, uint8_t* val, Err& e) const {
    if (circular) {
      if (dist > dict_size) {
        e = {1, "Match distance " + std::to_string(dist) +
                    " is beyond dictionary size " + std::to_string(dict_size)};
        return false;
      }
      if (dist > len) {
        e = {1, "Match distance " + std::to_string(dist) +
                    " is beyond output size " + std::to_string(len)};
        return false;
      }
      size_t idx = (dict_size + cursor - size_t(dist)) % dict_size;
      *val = idx < buf.size() ? buf[idx] : 0;
      return true;
    }
    if (dist > dict_limit) {
      e = {1, "Match distance " + std::to_string(dist) +
                  " is beyond dictionary size " + std::to_string(dict_limit)};
      return false;
    }
    if (dist > buf.size()) {
      e = {1, "Match distance " + std::to_string(dist) +
                  " is beyond output size " + std::to_string(buf.size())};
      return false;
    }
    *val = buf[buf.size() - size_t(dist)];
    return true;
  }
  bool append_literal(uint8_t lit, Err& e) {
    if (circular) {
      if (buf.size() < cursor + 1) {
        if (cursor + 1 <= memlimit) {
          buf.resize(cursor + 1, 0);
        } else {
          e = {1, "exceeded memory limit of " + std::to_string(memlimit)};
          return false;
        }
      }
      buf[cursor] = lit;
      cursor++;
      len++;
      if (cursor == dict_size) {
        out.append(reinterpret_cast<const char*>(buf.data()), buf.size());
        cursor = 0;
      }
      return true;
    }
    if (len + 1 > memlimit) {
      e = {1, "exceeded memory limit of " + std::to_string(memlimit)};
      return false;
    }
    buf.push_back(lit);
    len++;
    return true;
  }
  bool append_lz(uint64_t l, uint64_t dist, Err& e) {
    if (circular) {
      if (dist > dict_size) {
        e = {1, "LZ distance " + std::to_string(dist) +
                    " is beyond dictionary size " + std::to_string(dict_size)};
        return false;
      }
      if (dist > len) {
        e = {1, "LZ distance " + std::to_string(dist) +
                    " is beyond output size " + std::to_string(len)};
        return false;
      }
      size_t offset = (dict_size + cursor - size_t(dist)) % dict_size;
      for (uint64_t i = 0; i < l; i++) {
        uint8_t x = offset < buf.size() ? buf[offset] : 0;
        if (!append_literal(x, e)) return false;
        if (++offset == dict_size) offset = 0;
      }
      return true;
    }
    if (dist > dict_limit) {
      e = {1, "LZ distance " + std::to_string(dist) +
                  " is beyond dictionary size " + std::to_string(dict_limit)};
      return false;
    }
    if (dist > buf.size()) {
      e = {1, "LZ distance " + std::to_string(dist) + " is beyond output size " +
                  std::to_string(buf.size())};
      return false;
    }
    size_t offset = buf.size() - size_t(dist);
    size_t old = buf.size();
    buf.resize(old + size_t(l));
    // Overlap-correct forward copy; memcpy fast path when spans are disjoint.
    if (dist >= l) {
      memcpy(&buf[old], &buf[offset], size_t(l));
    } else {
      for (uint64_t i = 0; i < l; i++) buf[old + i] = buf[offset + i];
    }
    len += l;
    return true;
  }
  void finish() {
    if (circular) {
      if (cursor > 0)
        out.append(reinterpret_cast<const char*>(buf.data()), cursor);
    } else {
      out.append(reinterpret_cast<const char*>(buf.data()), buf.size());
      buf.clear();
    }
  }
};

// ---------------------------------------------------------------------------
// Flat output: decodes straight into a caller-provided, exactly-sized
// buffer (LZMA2 headers give exact unpacked sizes up front). This is the
// hot path for block/segment-parallel decode: no window abstraction, no
// per-byte capacity checks, memcpy for non-overlapping matches.
// ---------------------------------------------------------------------------

struct FlatOut {
  uint8_t* base;     // segment output start
  uint64_t pos = 0;  // == accum.len (bytes since segment/dict-reset start)
  uint64_t cap = 0;  // segment capacity (sum of chunk unpacked sizes)
  uint64_t len = 0;  // alias of pos for the shared decode templates
  // distances beyond the declared dictionary are format errors when the
  // caller sets this (raw-LZMA flat path; lzbuffer.rs checks first);
  // segment decode leaves it unbounded (planner-validated schedules)
  uint64_t dict_limit = UINT64_MAX;

  uint8_t last_or(uint8_t lit) const { return pos ? base[pos - 1] : lit; }
  bool last_n(uint64_t dist, uint8_t* val, Err& e) const {
    if (dist > dict_limit) {
      e = {1, "Match distance " + std::to_string(dist) +
                  " is beyond dictionary size " + std::to_string(dict_limit)};
      return false;
    }
    if (dist > pos) {
      e = {1, "Match distance " + std::to_string(dist) +
                  " is beyond output size " + std::to_string(pos)};
      return false;
    }
    *val = base[pos - dist];
    return true;
  }
  inline bool append_literal(uint8_t lit, Err& e) {
    if (pos >= cap) {
      e = {1, "Expected unpacked size of " + std::to_string(cap) +
                  " but decompressed to more"};
      return false;
    }
    base[pos++] = lit;
    len = pos;
    return true;
  }
  bool append_lz(uint64_t l, uint64_t dist, Err& e) {
    if (dist > dict_limit) {
      e = {1, "LZ distance " + std::to_string(dist) +
                  " is beyond dictionary size " + std::to_string(dict_limit)};
      return false;
    }
    if (dist > pos) {
      e = {1, "LZ distance " + std::to_string(dist) + " is beyond output size " +
                  std::to_string(pos)};
      return false;
    }
    if (pos + l > cap) {
      e = {1, "Expected unpacked size of " + std::to_string(cap) +
                  " but decompressed to more"};
      return false;
    }
    uint8_t* dst = base + pos;
    const uint8_t* src = base + pos - dist;
    if (dist >= l) {
      memcpy(dst, src, size_t(l));
    } else {
      for (uint64_t i = 0; i < l; i++) dst[i] = src[i];
    }
    pos += l;
    len = pos;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Decoder state (lzma.rs:165-593) over the flat probability table.
// Layout matches models/state.py.
// ---------------------------------------------------------------------------

constexpr int kMaxRequiredInput = 20;  // lzma.rs:13
// Max bytes a single symbol can append (longest match = 273): the flat
// raw-LZMA buffer carries this much slack past the declared size so an
// overshooting final match is appended (and then reported) exactly like
// the reference's growable window path.
constexpr uint64_t kMaxRequiredOvershoot = 273;

struct Layout {
  size_t nlit, lit, is_match, is_rep, is_rep_g0, is_rep_g1, is_rep_g2,
      is_rep_0long, pos_slot, spec_pos, align, len_coder, rep_len_coder, total;
  explicit Layout(int lclp) {
    nlit = size_t(1) << lclp;
    size_t off = 0;
    auto take = [&](size_t n) { size_t a = off; off += n; return a; };
    lit = take(nlit * 0x300);
    is_match = take(192);
    is_rep = take(12);
    is_rep_g0 = take(12);
    is_rep_g1 = take(12);
    is_rep_g2 = take(12);
    is_rep_0long = take(192);
    pos_slot = take(4 * 64);
    spec_pos = take(115);
    align = take(16);
    len_coder = take(514);
    rep_len_coder = take(514);
    total = off;
  }
};

constexpr size_t kLenChoice = 0, kLenChoice2 = 1, kLenLow = 2,
                 kLenMid = 2 + 128, kLenHigh = 2 + 256;

enum class Status { Continue, Finished, NeedMore };

struct DecoderState {
  int lc = 0, lp = 0, pb = 0;
  bool has_unpacked = false;
  uint64_t unpacked_size = 0;
  Layout layout{4};
  std::vector<uint16_t> probs;
  int state = 0;
  uint64_t rep[4] = {0, 0, 0, 0};
  uint8_t partial[kMaxRequiredInput];
  size_t partial_len = 0;

  void init(int lc_, int lp_, int pb_) {
    lc = lc_;
    lp = lp_;
    pb = pb_;
    int lclp = lc + lp;
    if (size_t(1) << lclp > layout.nlit) layout = Layout(lclp);
    probs.assign(layout.total, 0x400);
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
  }

  // One symbol (lzma.rs:278-393). `update=false` is the streaming dry-run.
  template <class OUT>
  Status process_next_inner(OUT& o, RangeDecoder& rc, bool update, Err& e) {
    return update ? process_next_inner_t<OUT, true, true>(o, rc, e)
                  : process_next_inner_t<OUT, true, false>(o, rc, e);
  }

  // CHECKED=false elides all input bounds checks; only legal when the
  // caller guarantees >= MAX_REQUIRED_INPUT bytes remain (lzma.rs:9-13).
  template <class OUT, bool CHECKED, bool UPDATE>
  Status process_next_inner_t(OUT& o, RangeDecoder& rc, Err& e) {
    constexpr bool update = UPDATE;
    uint16_t* P = probs.data();
    size_t pos_state = size_t(o.len) & ((size_t(1) << pb) - 1);

    int b = rc.decode_bit(&P[layout.is_match + (size_t(state) << 4) + pos_state],
                          update, e);
    if (b < 0) return Status::Continue;  // e set
    if (!b) {
      // Literal (lzma.rs:526-561)
      uint8_t prev_byte = o.last_or(0);
      unsigned result = 1;
      size_t lit_state =
          ((size_t(o.len) & ((size_t(1) << lp) - 1)) << lc) + (prev_byte >> (8 - lc));
      uint16_t* probs_base = &P[layout.lit + lit_state * 0x300];
      if (state >= 7) {
        uint8_t mb;
        if (!o.last_n(rep[0] + 1, &mb, e)) return Status::Continue;
        unsigned match_byte = mb;
        while (result < 0x100) {
          unsigned match_bit = (match_byte >> 7) & 1;
          match_byte = (match_byte << 1) & 0xFF;
          int bit = rc.decode_bit(&probs_base[((1 + match_bit) << 8) + result],
                                  update, e);
          if (bit < 0) return Status::Continue;
          result = (result << 1) ^ unsigned(bit);
          if (match_bit != unsigned(bit)) break;
        }
      }
      while (result < 0x100) {
        int bit = rc.decode_bit<CHECKED, UPDATE>(&probs_base[result], e);
        if (bit < 0) return Status::Continue;
        result = (result << 1) ^ unsigned(bit);
      }
      if (update) {
        if (!o.append_literal(uint8_t(result - 0x100), e)) return Status::Continue;
        state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
      }
      return Status::Continue;
    }

    uint64_t len;
    b = rc.decode_bit<CHECKED, UPDATE>(&P[layout.is_rep + state], e);
    if (b < 0) return Status::Continue;
    if (b) {
      // Repeated distance
      b = rc.decode_bit<CHECKED, UPDATE>(&P[layout.is_rep_g0 + state], e);
      if (b < 0) return Status::Continue;
      if (!b) {
        b = rc.decode_bit<CHECKED, UPDATE>(
            &P[layout.is_rep_0long + (size_t(state) << 4) + pos_state], e);
        if (b < 0) return Status::Continue;
        if (!b) {
          if (update) {
            state = state < 7 ? 9 : 11;
            if (!o.append_lz(1, rep[0] + 1, e)) return Status::Continue;
          }
          return Status::Continue;
        }
      } else {
        int idx;
        b = rc.decode_bit<CHECKED, UPDATE>(&P[layout.is_rep_g1 + state], e);
        if (b < 0) return Status::Continue;
        if (!b) {
          idx = 1;
        } else {
          b = rc.decode_bit<CHECKED, UPDATE>(&P[layout.is_rep_g2 + state], e);
          if (b < 0) return Status::Continue;
          idx = b ? 3 : 2;
        }
        if (update) {
          uint64_t dist = rep[idx];
          for (int i = idx - 1; i >= 0; i--) rep[i + 1] = rep[i];
          rep[0] = dist;
        }
      }
      int64_t l = decode_len<CHECKED, UPDATE>(rc, pos_state, true, e);
      if (l < 0) return Status::Continue;
      len = uint64_t(l);
      if (update) state = state < 7 ? 8 : 11;
    } else {
      // New distance
      if (update) {
        rep[3] = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
      }
      int64_t l = decode_len<CHECKED, UPDATE>(rc, pos_state, false, e);
      if (l < 0) return Status::Continue;
      len = uint64_t(l);
      if (update) state = state < 7 ? 7 : 10;
      int64_t rep0 = decode_distance<CHECKED, UPDATE>(rc, size_t(len), e);
      if (rep0 < 0) return Status::Continue;
      if (update) {
        rep[0] = uint64_t(rep0);
        if (rep[0] == 0xFFFFFFFFull) {
          if (rc.is_finished_ok()) return Status::Finished;
          e = {1, "Found end-of-stream marker but more bytes are available"};
          return Status::Continue;
        }
      }
    }
    if (update) {
      len += 2;
      if (!o.append_lz(len, rep[0] + 1, e)) return Status::Continue;
    }
    return Status::Continue;
  }

  template <bool CHECKED, bool UPDATE>
  int64_t decode_len(RangeDecoder& rc, size_t pos_state, bool is_rep,
                     Err& e) {
    uint16_t* base = &probs[is_rep ? layout.rep_len_coder : layout.len_coder];
    int b = rc.decode_bit<CHECKED, UPDATE>(&base[kLenChoice], e);
    if (b < 0) return -1;
    if (!b) return rc.parse_bit_tree<CHECKED, UPDATE>(3, &base[kLenLow + pos_state * 8], e);
    b = rc.decode_bit<CHECKED, UPDATE>(&base[kLenChoice2], e);
    if (b < 0) return -1;
    if (!b) {
      int64_t v = rc.parse_bit_tree<CHECKED, UPDATE>(3, &base[kLenMid + pos_state * 8], e);
      return v < 0 ? -1 : v + 8;
    }
    int64_t v = rc.parse_bit_tree<CHECKED, UPDATE>(8, &base[kLenHigh], e);
    return v < 0 ? -1 : v + 16;
  }

  template <bool CHECKED, bool UPDATE>
  int64_t decode_distance(RangeDecoder& rc, size_t len, Err& e) {
    size_t len_state = len > 3 ? 3 : len;
    int64_t pos_slot =
        rc.parse_bit_tree<CHECKED, UPDATE>(6, &probs[layout.pos_slot + len_state * 64], e);
    if (pos_slot < 0) return -1;
    if (pos_slot < 4) return pos_slot;
    int num_direct_bits = int(pos_slot >> 1) - 1;
    uint64_t result = (2 | (uint64_t(pos_slot) & 1)) << num_direct_bits;
    if (pos_slot < 14) {
      int64_t add = rc.parse_reverse_bit_tree<CHECKED, UPDATE>(num_direct_bits,
                                              probs.data() + layout.spec_pos,
                                              size_t(result - pos_slot), e);
      if (add < 0) return -1;
      result += uint64_t(add);
    } else {
      int64_t d = rc.get<CHECKED>(num_direct_bits - 4, e);
      if (d < 0) return -1;
      result += uint64_t(d) << 4;
      int64_t a =
          rc.parse_reverse_bit_tree<CHECKED, UPDATE>(4, probs.data() + layout.align, 0, e);
      if (a < 0) return -1;
      result += uint64_t(a);
    }
    return int64_t(result);
  }

  template <class OUT>
  bool try_process_next(OUT& o, const uint8_t* buf, size_t n,
                        uint32_t range, uint32_t code) {
    RangeDecoder rc{buf, 0, n};
    rc.range = range;
    rc.code = code;
    Err e;
    process_next_inner(o, rc, false, e);
    return e.ok();
  }

  // Register-local fast symbol loop for the flat (segment) output path.
  //
  // The generic per-symbol path re-reads the range coder and decoder
  // state through memory after every output write: FlatOut stores
  // through `uint8_t*`, and char-typed stores may alias *anything* in
  // C++, so the compiler must spill/reload `rc.range/code/pos`, `state`
  // and the reps around each one. liblzma sidesteps this by caching the
  // coder in locals for the whole loop (lzma_decoder.c's rc_to_local);
  // same idea here. Runs symbols while >= 2*kMaxRequiredInput input
  // bytes remain (so all reads are unchecked, cf. lzma.rs:9-13) and the
  // chunk's unpacked size is not reached, then writes state back for
  // the generic loop to finish the tail. Error strings are byte-equal
  // to the generic path's (reference parity, tests/test_errors.py).
  // ``olimit_in``: symbol loop stops once output reaches this (the
  // chunk/stream target); matches may overshoot it up to o.cap, which
  // callers pad with kMaxRequiredOvershoot slack where overshoot must
  // be reported by the generic path's post-loop size check.
  bool process_fast(FlatOut& o, RangeDecoder& rc, Err& e,
                    uint64_t olimit_in) {
    uint32_t range = rc.range, code = rc.code;
    const uint8_t* const ibuf = rc.buf;
    size_t ipos = rc.pos;
    const size_t isafe = rc.end - 2 * size_t(kMaxRequiredInput);
    uint8_t* const obase = o.base;
    size_t opos = size_t(o.pos);
    const size_t ocap = size_t(o.cap);
    // literal stores below elide the per-byte cap check; cap the loop so
    // they stay in-bounds even if the target overshoots the buffer
    // (the generic tail path then reports the parity error string)
    const size_t olimit = size_t(olimit_in) < ocap ? size_t(olimit_in) : ocap;
    unsigned st_ = unsigned(state);
    size_t r0 = size_t(rep[0]), r1 = size_t(rep[1]), r2 = size_t(rep[2]),
           r3 = size_t(rep[3]);
    uint16_t* const P = probs.data();
    uint16_t* const Plit = P + layout.lit;
    const size_t off_is_match = layout.is_match, off_is_rep = layout.is_rep,
                 off_g0 = layout.is_rep_g0, off_g1 = layout.is_rep_g1,
                 off_g2 = layout.is_rep_g2, off_0long = layout.is_rep_0long,
                 off_slot = layout.pos_slot, off_spec = layout.spec_pos,
                 off_align = layout.align, off_len = layout.len_coder,
                 off_rlen = layout.rep_len_coder;
    const size_t pbmask = (size_t(1) << pb) - 1;
    const size_t lpmask = (size_t(1) << lp) - 1;
    const int lc_ = lc;
    const uint64_t dlim = o.dict_limit;

#define LRT_RC_BIT(probp, bitvar)                                        \
  do {                                                                   \
    uint16_t* pp_ = (probp);                                             \
    uint32_t pv_ = *pp_;                                                 \
    uint32_t bound_ = (range >> 11) * pv_;                               \
    if (code < bound_) {                                                 \
      range = bound_;                                                    \
      *pp_ = uint16_t(pv_ + ((0x800 - pv_) >> 5));                       \
      bitvar = 0;                                                        \
    } else {                                                             \
      code -= bound_;                                                    \
      range -= bound_;                                                   \
      *pp_ = uint16_t(pv_ - (pv_ >> 5));                                 \
      bitvar = 1;                                                        \
    }                                                                    \
    if (range < 0x0100'0000u) {                                          \
      range <<= 8;                                                       \
      code = (code << 8) ^ ibuf[ipos++];                                 \
    }                                                                    \
  } while (0)

    while (opos < olimit && ipos <= isafe) {
      const size_t pos_state = opos & pbmask;
      unsigned bit;
      LRT_RC_BIT(&P[off_is_match + (size_t(st_) << 4) + pos_state], bit);
      if (!bit) {
        // Literal (lzma.rs:526-561)
        const unsigned prev = opos ? obase[opos - 1] : 0;
        uint16_t* const pl =
            Plit + (((opos & lpmask) << lc_) + (prev >> (8 - lc_))) * 0x300;
        unsigned result = 1;
        if (st_ < 7) {
          // plain literal: straight-line 8-bit tree walk (no backedge)
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          LRT_RC_BIT(&pl[result], bit); result = (result << 1) ^ bit;
          obase[opos++] = uint8_t(result);  // == result - 0x100
          st_ = st_ < 4 ? 0 : st_ - 3;
          continue;
        }
        if (r0 + 1 > dlim) {
          e = {1, "Match distance " + std::to_string(r0 + 1) +
                      " is beyond dictionary size " + std::to_string(dlim)};
          goto out;
        }
        if (r0 + 1 > opos) {
          e = {1, "Match distance " + std::to_string(r0 + 1) +
                      " is beyond output size " + std::to_string(opos)};
          goto out;
        }
        unsigned match_byte = obase[opos - r0 - 1];
        do {
          const unsigned match_bit = (match_byte >> 7) & 1;
          match_byte = (match_byte << 1) & 0xFF;
          LRT_RC_BIT(&pl[((1 + match_bit) << 8) + result], bit);
          result = (result << 1) ^ bit;
          if (match_bit != bit) break;
        } while (result < 0x100);
        while (result < 0x100) {
          LRT_RC_BIT(&pl[result], bit);
          result = (result << 1) ^ bit;
        }
        obase[opos++] = uint8_t(result);  // == result - 0x100
        st_ = st_ < 10 ? st_ - 3 : st_ - 6;
        continue;
      }

      size_t len;
      LRT_RC_BIT(&P[off_is_rep + st_], bit);
      if (bit) {
        // Repeated distance
        LRT_RC_BIT(&P[off_g0 + st_], bit);
        if (!bit) {
          LRT_RC_BIT(&P[off_0long + (size_t(st_) << 4) + pos_state], bit);
          if (!bit) {
            // 1-byte short rep (lzma.rs:334-339)
            st_ = st_ < 7 ? 9 : 11;
            const size_t dist = r0 + 1;
            if (dist > dlim) {
              e = {1, "LZ distance " + std::to_string(dist) +
                          " is beyond dictionary size " + std::to_string(dlim)};
              goto out;
            }
            if (dist > opos) {
              e = {1, "LZ distance " + std::to_string(dist) +
                          " is beyond output size " + std::to_string(opos)};
              goto out;
            }
            if (opos + 1 > ocap) {
              e = {1, "Expected unpacked size of " + std::to_string(ocap) +
                          " but decompressed to more"};
              goto out;
            }
            obase[opos] = obase[opos - dist];
            opos++;
            continue;
          }
        } else {
          size_t dist;
          LRT_RC_BIT(&P[off_g1 + st_], bit);
          if (!bit) {
            dist = r1;
            r1 = r0;
          } else {
            LRT_RC_BIT(&P[off_g2 + st_], bit);
            if (!bit) {
              dist = r2;
            } else {
              dist = r3;
              r3 = r2;
            }
            r2 = r1;
            r1 = r0;
          }
          r0 = dist;
        }
        // rep len coder
        uint16_t* const B = P + off_rlen;
        LRT_RC_BIT(&B[kLenChoice], bit);
        unsigned tmp = 1;
        if (!bit) {
          uint16_t* const low = B + kLenLow + pos_state * 8;
          LRT_RC_BIT(&low[1], bit);
          tmp = 2 ^ bit;
          LRT_RC_BIT(&low[tmp], bit);
          tmp = (tmp << 1) ^ bit;
          LRT_RC_BIT(&low[tmp], bit);
          len = ((tmp << 1) ^ bit) - 8;
        } else {
          LRT_RC_BIT(&B[kLenChoice2], bit);
          if (!bit) {
            uint16_t* const mid = B + kLenMid + pos_state * 8;
            for (int i = 0; i < 3; i++) {
              LRT_RC_BIT(&mid[tmp], bit);
              tmp = (tmp << 1) ^ bit;
            }
            len = (tmp - 8) + 8;
          } else {
            uint16_t* const high = B + kLenHigh;
            for (int i = 0; i < 8; i++) {
              LRT_RC_BIT(&high[tmp], bit);
              tmp = (tmp << 1) ^ bit;
            }
            len = (tmp - 0x100) + 16;
          }
        }
        st_ = st_ < 7 ? 8 : 11;
      } else {
        // New distance
        r3 = r2;
        r2 = r1;
        r1 = r0;
        uint16_t* const B = P + off_len;
        LRT_RC_BIT(&B[kLenChoice], bit);
        unsigned tmp = 1;
        if (!bit) {
          uint16_t* const low = B + kLenLow + pos_state * 8;
          for (int i = 0; i < 3; i++) {
            LRT_RC_BIT(&low[tmp], bit);
            tmp = (tmp << 1) ^ bit;
          }
          len = tmp - 8;
        } else {
          LRT_RC_BIT(&B[kLenChoice2], bit);
          if (!bit) {
            uint16_t* const mid = B + kLenMid + pos_state * 8;
            for (int i = 0; i < 3; i++) {
              LRT_RC_BIT(&mid[tmp], bit);
              tmp = (tmp << 1) ^ bit;
            }
            len = (tmp - 8) + 8;
          } else {
            uint16_t* const high = B + kLenHigh;
            for (int i = 0; i < 8; i++) {
              LRT_RC_BIT(&high[tmp], bit);
              tmp = (tmp << 1) ^ bit;
            }
            len = (tmp - 0x100) + 16;
          }
        }
        st_ = st_ < 7 ? 7 : 10;
        // distance (lzma.rs:402-433)
        const size_t len_state = len > 3 ? 3 : len;
        uint16_t* const ps = P + off_slot + len_state * 64;
        tmp = 1;
        for (int i = 0; i < 6; i++) {
          LRT_RC_BIT(&ps[tmp], bit);
          tmp = (tmp << 1) ^ bit;
        }
        const unsigned pos_slot = tmp - 64;
        if (pos_slot < 4) {
          r0 = pos_slot;
        } else {
          const int ndb = int(pos_slot >> 1) - 1;
          uint32_t result = (2u | (pos_slot & 1)) << ndb;
          if (pos_slot < 14) {
            uint16_t* const sp = P + off_spec + (result - pos_slot);
            unsigned t2 = 1, add = 0;
            for (int i = 0; i < ndb; i++) {
              LRT_RC_BIT(&sp[t2], bit);
              t2 = (t2 << 1) ^ bit;
              add ^= bit << i;
            }
            result += add;
          } else {
            // direct bits, branchless (rangecoder.rs:55-76 semantics)
            uint32_t d = 0;
            for (int i = 0; i < ndb - 4; i++) {
              range >>= 1;
              code -= range;
              const uint32_t mask = uint32_t(int32_t(code) >> 31);
              code += range & mask;
              d = (d << 1) + (mask + 1);
              if (range < 0x0100'0000u) {
                range <<= 8;
                code = (code << 8) ^ ibuf[ipos++];
              }
            }
            result += d << 4;
            uint16_t* const al = P + off_align;
            unsigned t2 = 1, add = 0;
            for (int i = 0; i < 4; i++) {
              LRT_RC_BIT(&al[t2], bit);
              t2 = (t2 << 1) ^ bit;
              add ^= bit << i;
            }
            result += add;
          }
          if (result == 0xFFFFFFFFu) {
            // EOS marker mid-buffer: >= 2*kMaxRequiredInput bytes remain,
            // so is_finished_ok() is necessarily false (lzma.rs:421-428)
            rc.range = range;
            rc.code = code;
            rc.pos = ipos;
            o.pos = opos;
            o.len = opos;
            state = int(st_);
            rep[0] = r0;
            rep[1] = r1;
            rep[2] = r2;
            rep[3] = r3;
            e = {1, "Found end-of-stream marker but more bytes are available"};
            return false;
          }
          r0 = result;
        }
      }
      len += 2;
      {
        const size_t dist = r0 + 1;
        if (dist > dlim) {
          e = {1, "LZ distance " + std::to_string(dist) +
                      " is beyond dictionary size " + std::to_string(dlim)};
          goto out;
        }
        if (dist > opos) {
          e = {1, "LZ distance " + std::to_string(dist) +
                      " is beyond output size " + std::to_string(opos)};
          goto out;
        }
        if (opos + len > ocap) {
          e = {1, "Expected unpacked size of " + std::to_string(ocap) +
                      " but decompressed to more"};
          goto out;
        }
        uint8_t* const dst = obase + opos;
        const uint8_t* const src = dst - dist;
        if (dist >= len) {
          memcpy(dst, src, len);
        } else if (dist == 1) {
          memset(dst, src[0], len);
        } else {
          for (size_t i = 0; i < len; i++) dst[i] = src[i];
        }
        opos += len;
      }
    }
  out:
#undef LRT_RC_BIT
    rc.range = range;
    rc.code = code;
    rc.pos = ipos;
    o.pos = opos;
    o.len = opos;
    state = int(st_);
    rep[0] = r0;
    rep[1] = r1;
    rep[2] = r2;
    rep[3] = r3;
    return e.ok();
  }

  // The main loop (lzma.rs:435-524). partial_mode = streaming Partial.
  template <class OUT>
  bool process_mode(OUT& o, RangeDecoder& rc, bool partial_mode,
                    Err& e) {
    for (;;) {
      if (has_unpacked) {
        if (o.len >= unpacked_size) break;
      } else if (partial_mode ? (rc.is_eof() && partial_len == 0)
                              : (rc.is_finished_ok() && partial_len == 0)) {
        break;
      }

      if (partial_len > 0) {
        size_t want = kMaxRequiredInput - partial_len;
        size_t take = want < (rc.end - rc.pos) ? want : (rc.end - rc.pos);
        memcpy(partial + partial_len, rc.buf + rc.pos, take);
        partial_len += take;
        rc.pos += take;

        if (partial_mode && partial_len < kMaxRequiredInput &&
            !try_process_next(o, partial, partial_len, rc.range, rc.code))
          return true;  // wait for more data

        RangeDecoder tmp{partial, 0, partial_len};
        tmp.range = rc.range;
        tmp.code = rc.code;
        Status res = process_next_inner(o, tmp, true, e);
        if (!e.ok()) return false;
        rc.range = tmp.range;
        rc.code = tmp.code;
        size_t consumed = tmp.pos;
        memmove(partial, partial + consumed, partial_len - consumed);
        partial_len -= consumed;
        if (res == Status::Finished) break;
      } else {
        size_t remaining = rc.end - rc.pos;
        if (partial_mode && remaining < kMaxRequiredInput &&
            !try_process_next(o, rc.buf + rc.pos, remaining, rc.range, rc.code)) {
          memcpy(partial, rc.buf + rc.pos, remaining);
          partial_len = remaining;
          rc.pos = rc.end;
          return true;
        }
        if constexpr (std::is_same<OUT, FlatOut>::value) {
          // Bulk of the segment: register-local fast loop (see
          // process_fast above). Exits at the input/output tail; the
          // generic per-symbol path below finishes the edges.
          if (!partial_mode && has_unpacked && o.len < unpacked_size &&
              o.len < o.cap && remaining >= 2 * kMaxRequiredInput) {
            if (!process_fast(o, rc, e, unpacked_size)) return false;
            continue;  // re-check termination with updated o.len/rc
          }
        }
        if constexpr (std::is_same<OUT, OutputBuffer>::value) {
          // Flat accum: run the same fast loop over a FlatOut view of
          // the accum vector. Size-declared chunks (LZMA2) use their
          // target; unknown-size (EOS-marker, flat-window one-shot raw
          // decode) grow geometrically. The view is resized to the
          // target + one-symbol overshoot slack and trimmed back after.
          // Gated so the growable path's memlimit check could not fire
          // below the target (non-circular append_lz does not check
          // memlimit, matching the view's behavior).
          if (!partial_mode && !o.circular &&
              (!has_unpacked || o.len < unpacked_size) &&
              remaining >= 2 * kMaxRequiredInput) {
            // geometric growth toward the target, never allocating from
            // the (untrusted) declared size up front: a crafted header
            // claiming GiBs must not cost more memory than the stream
            // actually decodes to (plus one doubling)
            const uint64_t grow = o.len < 65536 ? 65536 : o.len;
            uint64_t tgt = o.len + grow;
            if (has_unpacked && unpacked_size < tgt) tgt = unpacked_size;
            if (tgt <= (uint64_t(1) << 31) && o.memlimit >= tgt) {
              const size_t target =
                  size_t(tgt) + size_t(kMaxRequiredOvershoot);
              if (o.buf.size() < target) o.buf.resize(target);
              FlatOut fo;
              fo.base = o.buf.data();
              fo.pos = o.len;
              fo.len = o.len;
              fo.cap = target;
              fo.dict_limit = o.dict_limit;
              const bool ok = process_fast(fo, rc, e, tgt);
              o.buf.resize(size_t(fo.len));
              o.len = fo.len;
              if (!ok) return false;
              continue;  // re-check termination with updated o.len/rc
            }
          }
          // Circular window, pre-wrap: until the cursor first wraps at
          // dict_size the window IS a flat buffer, so the same fast
          // loop applies (EOS-marker raw streams — the reference's
          // decompress_big_file bench shape). Gated on
          // dict_size <= memlimit so the per-byte memlimit check could
          // never fire pre-wrap; dict_limit preserves the
          // "beyond dictionary size" distance errors. Post-wrap (rare:
          // output larger than the dictionary) stays generic.
          // (also valid mid-feed in partial/streaming mode: the loop
          // only runs while >= 2*kMaxRequiredInput bytes remain, and the
          // partial-tail stashing below picks up after it exits)
          if (o.circular && o.cursor == o.len &&
              o.dict_size > 2 * kMaxRequiredOvershoot &&
              o.dict_size <= o.memlimit &&
              (!has_unpacked || o.len < unpacked_size) &&
              o.dict_size <= (uint64_t(1) << 31) &&
              remaining >= 2 * kMaxRequiredInput) {
            // Stop one max-match short of the wrap point: a match may
            // overshoot the target by up to kMaxRequiredOvershoot, and
            // crossing dict_size would skip the circular flush/wrap
            // (the last pre-wrap symbols run generic). Geometric growth
            // (like the vector the window replaces): tiny streams must
            // not pay a dict_size-sized allocation.
            const uint64_t wrap_safe =
                o.dict_size - 1 - kMaxRequiredOvershoot;
            const uint64_t grow = o.len < 65536 ? 65536 : o.len;
            uint64_t target = o.len + grow;
            if (wrap_safe < target) target = wrap_safe;
            if (has_unpacked && unpacked_size < target)
              target = unpacked_size;
            if (o.len < target) {
              const size_t need =
                  size_t(target) + size_t(kMaxRequiredOvershoot);
              if (o.buf.size() < need) o.buf.resize(need);
              FlatOut fo;
              fo.base = o.buf.data();
              fo.pos = o.len;
              fo.len = o.len;
              fo.cap = need;
              fo.dict_limit = o.dict_size;
              const bool ok = process_fast(fo, rc, e, target);
              o.buf.resize(size_t(fo.len));
              o.len = fo.len;
              o.cursor = size_t(fo.len);
              if (!ok) return false;
              continue;  // generic path handles the wrap/tail symbols
            }
          }
        }
        Status res;
        if (!partial_mode && rc.end - rc.pos >= 2 * kMaxRequiredInput) {
          res = process_next_inner_t<OUT, false, true>(o, rc, e);
        } else {
          res = process_next_inner_t<OUT, true, true>(o, rc, e);
        }
        if (!e.ok()) return false;
        if (res == Status::Finished) break;
      }
    }

    if (has_unpacked && !partial_mode && unpacked_size != o.len) {
      e = {1, "Expected unpacked size of " + std::to_string(unpacked_size) +
                  " but decompressed to " + std::to_string(o.len)};
      return false;
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// LZMA2 chunk loop (lzma2.rs:52-230).
// ---------------------------------------------------------------------------

bool lzma2_decode_impl(const uint8_t* data, size_t n, size_t start,
                       OutputBuffer& accum, size_t* consumed, Err& e) {
  DecoderState st;
  st.init(0, 0, 0);
  size_t pos = start;
  bool initialized = true;  // probs initialised by init()
  (void)initialized;
  for (;;) {
    if (pos >= n) {
      e = {1, std::string("LZMA2 expected new status: ") + kEofMsg};
      return false;
    }
    uint8_t control = data[pos++];
    if (control == 0) break;
    if (control == 1 || control == 2) {
      if (n - pos < 2) {
        e = {1, std::string("LZMA2 expected unpacked size: ") + kEofMsg};
        return false;
      }
      size_t unpacked = (size_t(data[pos]) << 8 | data[pos + 1]) + 1;
      pos += 2;
      if (control == 1) accum.reset_accum();
      if (n - pos < unpacked) {
        e = {1, "LZMA2 expected " + std::to_string(unpacked) +
                    " uncompressed bytes: " + kEofMsg};
        return false;
      }
      accum.buf.insert(accum.buf.end(), data + pos, data + pos + unpacked);
      accum.len += unpacked;
      pos += unpacked;
      continue;
    }
    if (!(control & 0x80)) {
      e = {1, "LZMA2 invalid status " + std::to_string(control) +
                  ", must be 0, 1, 2 or >= 128"};
      return false;
    }
    int reset_mode = (control >> 5) & 3;
    if (n - pos < 2) {
      e = {1, std::string("LZMA2 expected unpacked size: ") + kEofMsg};
      return false;
    }
    uint64_t unpacked =
        (((uint64_t(control) & 0x1F) << 16) | (uint64_t(data[pos]) << 8) |
         data[pos + 1]) + 1;
    pos += 2;
    if (n - pos < 2) {
      e = {1, std::string("LZMA2 expected packed size: ") + kEofMsg};
      return false;
    }
    uint64_t packed = ((uint64_t(data[pos]) << 8) | data[pos + 1]) + 1;
    pos += 2;

    if (reset_mode == 3) accum.reset_accum();
    if (reset_mode >= 1) {
      int lc = st.lc, lp = st.lp, pb = st.pb;
      if (reset_mode >= 2) {
        if (pos >= n) {
          e = {1, std::string("LZMA2 expected new properties: ") + kEofMsg};
          return false;
        }
        unsigned p = data[pos++];
        if (p >= 225) {
          e = {1, "LZMA2 invalid properties: " + std::to_string(p) +
                      " must be < 225"};
          return false;
        }
        lc = p % 9;
        p /= 9;
        lp = p % 5;
        pb = p / 5;
        if (lc + lp > 4) {
          e = {1, "LZMA2 invalid properties: lc + lp (" + std::to_string(lc) +
                      " + " + std::to_string(lp) + ") must be <= 4"};
          return false;
        }
      }
      st.init(lc, lp, pb);
    }
    st.has_unpacked = true;
    st.unpacked_size = unpacked + accum.len;

    size_t chunk_end = pos + size_t(packed);
    if (chunk_end > n) chunk_end = n;
    RangeDecoder rc{data, pos, chunk_end};
    Err ie;
    if (!rc.init(ie)) {
      e = {1, std::string("LZMA input too short: ") + ie.msg};
      return false;
    }
    if (!st.process_mode(accum, rc, false, e)) return false;
    pos = rc.pos;
  }
  if (consumed) *consumed = pos - start;
  return true;
}

// ---------------------------------------------------------------------------
// Range encoder (mirror of encode/rangecoder.rs:7-144): 64-bit low with
// cache/cache-size carry propagation, 5-byte flush.
// ---------------------------------------------------------------------------

struct RangeEncoder {
  std::string out;
  uint32_t range = 0xFFFFFFFFu;
  uint64_t low = 0;
  uint8_t cache = 0;
  uint32_t cachesz = 1;

  inline void write_low() {
    if (low < 0xFF000000ull || low > 0xFFFFFFFFull) {
      uint8_t tmp = cache;
      do {
        out.push_back(char(uint8_t(tmp + (low >> 32))));
        tmp = 0xFF;
      } while (--cachesz);
      cache = uint8_t(low >> 24);
    }
    cachesz++;
    low = (low << 8) & 0xFFFFFFFFull;
  }

  void finish() {
    for (int i = 0; i < 5; i++) write_low();
  }

  inline void encode_bit(uint16_t* prob, int bit) {
    uint32_t bound = (range >> 11) * uint32_t(*prob);
    if (bit) {
      *prob -= *prob >> 5;
      low += bound;
      range -= bound;
    } else {
      *prob += (0x800 - *prob) >> 5;
      range = bound;
    }
    while (range < 0x01000000u) {
      range <<= 8;
      write_low();
    }
  }
};

char* dup_out(const std::string& s) {
  char* p = static_cast<char*>(malloc(s.size() ? s.size() : 1));
  if (p && s.size()) memcpy(p, s.data(), s.size());
  return p;
}

void set_err(char* err_buf, const Err& e) {
  if (err_buf) {
    snprintf(err_buf, 511, "%s", e.msg.c_str());
  }
}

}  // namespace

extern "C" {

uint64_t lrt_crc64_update(uint64_t crc, const char* data, size_t n) {
  return crc64_update(crc, reinterpret_cast<const uint8_t*>(data), n);
}

void lrt_free(void* p) { free(p); }

// One-shot raw LZMA decode. Returns 0 ok, 1 LzmaError, 2 IoError.
int lrt_lzma_decode(const char* data, size_t n, size_t payload_off, int lc,
                    int lp, int pb, uint64_t dict_size, int has_unpacked,
                    uint64_t unpacked_size, int has_memlimit, uint64_t memlimit,
                    void** out_buf, size_t* out_len, char* err_buf) {
  *out_buf = nullptr;
  *out_len = 0;
  DecoderState st;
  st.init(lc, lp, pb);
  st.has_unpacked = has_unpacked != 0;
  st.unpacked_size = unpacked_size;

  RangeDecoder rc{reinterpret_cast<const uint8_t*>(data), payload_off, n};
  Err e;
  if (!rc.init(e)) {
    Err w{1, std::string("LZMA stream too short: ") + e.msg};
    set_err(err_buf, w);
    return 1;
  }

  // A flat growing accum window with a dictionary distance limit is
  // semantically identical to the circular window (same distance rules
  // and error strings, identical output) and runs the register-local
  // fast loop over the whole stream; it grows geometrically with the
  // ACTUAL output (never allocating from the untrusted declared size —
  // a crafted header must not drive a multi-GiB upfront allocation).
  // Eligibility: the accum path charges total output against the
  // memlimit, the circular reference window charges min(dict, len), so
  // the flat window is only equivalent when the memlimit could never
  // fire below the stream's own end (no memlimit, or declared size +
  // one-symbol overshoot within it). Everything else — including the
  // memlimit-in-[size, size+272] overshoot edge, where the reference
  // reports the memlimit error and not the size mismatch — keeps the
  // reference's circular window (lzbuffer.rs LzCircularBuffer).
  OutputBuffer o;
  const bool flat_ok =
      !has_memlimit ||
      (has_unpacked &&
       unpacked_size + kMaxRequiredOvershoot <= memlimit);
  if (flat_ok) {
    o.dict_limit = dict_size;
    if (has_memlimit) o.memlimit = memlimit;  // unreachable under gate
  } else {
    o.circular = true;
    o.dict_size = size_t(dict_size);
    o.memlimit = memlimit;
  }
  if (!st.process_mode(o, rc, false, e)) {
    set_err(err_buf, e);
    return e.code;
  }
  o.finish();
  // release the window before duplicating: out + buf + the malloc'd
  // copy would otherwise coexist (3x output transiently)
  std::vector<uint8_t>().swap(o.buf);
  *out_buf = dup_out(o.out);
  *out_len = o.out.size();
  return 0;
}

// Real LZMA2 compression (greedy match-finding). level 1..9 maps to match
// finder depth; chunk_size (clamped to [256, 65536]) sets the unpacked
// bytes per LZMA2 chunk (smaller chunks suit the VMEM TPU decode kernel).
// Output is a complete LZMA2 chunk stream (0x00-terminated).
extern "C++" {
template <bool kBt>
static void lzma2_compress_block(const uint8_t* data, size_t n, int depth,
                                 int first_block, size_t chunk_size,
                                 int parse_mode, int props, size_t dist_cap,
                                 std::string& out);
}  // extern "C++"

int lrt_lzma2_compress(const char* data, size_t n, int level,
                       size_t chunk_size, int props, size_t dist_cap,
                       void** out_buf, size_t* out_len) {
  int depth = level <= 1 ? 8 : level <= 3 ? 24 : level <= 5 ? 32
                                                : level <= 6 ? 64 : 96;
  // parse modes: 1-3 greedy with lazy lookahead (fastest); 4-9 run the
  // optimal-parse DP (per-node adaptive state) — at depth 32 the DP
  // encodes within ~2x of the price-density greedy's speed and closes
  // its 4-11% ratio gap vs liblzma -4/-5, so the greedy (parse_mode 1)
  // is no longer mapped to any preset; it stays reachable (and tested)
  // via LZMA_RS_TPU_PARSE_MODE for speed/ratio experiments.
  int parse_mode = level >= 4 ? 2 : 0;
  if (const char* pm = getenv("LZMA_RS_TPU_PARSE_MODE")) {
    int v = atoi(pm);
    if (v >= 0 && v <= 2) parse_mode = v;
  }
  if (chunk_size < 256) chunk_size = 256;
  if (chunk_size > 65536) chunk_size = 65536;
  // props byte (lzma_header.py / lzma.rs:43-94): default lc=3 lp=0 pb=2.
  // lc+lp <= 4 keeps liblzma-compatible streams.
  if (props < 0 || props >= 225 ||
      props % 9 + (props / 9) % 5 > 4)
    props = 3 + 9 * (0 + 5 * 2);
  // dist_cap (0 = uncapped) bounds match distances: the TPU ring-window
  // kernel keeps only the last dist_cap bytes of history in VMEM, so
  // archives encoded with a cap decode on the fast ring path.
  std::string out;
  out.reserve(n / 3 + 64);
  if (n > 0) {
    // bt4 costs 8 bytes of tree per input byte; fall back to the hash
    // chain for degenerate single-block inputs beyond 256 MB
    if (parse_mode >= 1 && n <= (size_t(1) << 28))
      lzma2_compress_block<true>(reinterpret_cast<const uint8_t*>(data), n,
                                 depth, /*first_block=*/1, chunk_size,
                                 parse_mode, props, dist_cap, out);
    else
      lzma2_compress_block<false>(reinterpret_cast<const uint8_t*>(data), n,
                                  depth, /*first_block=*/1, chunk_size,
                                  parse_mode, props, dist_cap, out);
  }
  out.push_back('\0');
  *out_buf = dup_out(out);
  *out_len = out.size();
  return 0;
}

// One-shot LZMA2 decode from `start`. Returns consumed byte count.
int lrt_lzma2_decode(const char* data, size_t n, size_t start, void** out_buf,
                     size_t* out_len, size_t* consumed, char* err_buf) {
  *out_buf = nullptr;
  *out_len = 0;
  OutputBuffer accum;  // accum mode
  Err e;
  if (!lzma2_decode_impl(reinterpret_cast<const uint8_t*>(data), n, start,
                         accum, consumed, e)) {
    set_err(err_buf, e);
    return e.code;
  }
  accum.finish();
  std::vector<uint8_t>().swap(accum.buf);  // see lrt_lzma_decode
  *out_buf = dup_out(accum.out);
  *out_len = accum.out.size();
  return 0;
}

// ---------------------------------------------------------------------------
// Bit-price model for encode-side decisions: price of coding bit b with
// probability p, in 1/64-bit units (the standard LZMA price table idea —
// liblzma keeps the same table; only relative prices matter). Prices are
// computed from the *current adaptive* probabilities, so the encoder's
// choices track the model exactly as the decoder will see it.
// ---------------------------------------------------------------------------

struct ProbPriceTable {
  uint32_t t[256];
  ProbPriceTable() {
    for (int i = 0; i < 256; i++) {
      double p = (i * 8 + 4) / 2048.0;
      t[i] = uint32_t(-std::log2(p) * 64.0 + 0.5);
    }
  }
};
const ProbPriceTable kProbPrice;

inline uint32_t price0(uint16_t p) { return kProbPrice.t[p >> 3]; }
inline uint32_t price1(uint16_t p) {
  return kProbPrice.t[(2048 - p) >> 3];
}
inline uint32_t price_bit(uint16_t p, int b) {
  return b ? price1(p) : price0(p);
}
constexpr uint32_t kDirectBitPrice = 64;  // one full bit

// ---------------------------------------------------------------------------
// Real LZMA encoder: greedy hash-chain match finder + full symbol coding
// (matches, rep matches, short rep, matched literals). This goes beyond the
// reference's literal-only "dumb" encoder (encode/dumbencoder.rs) — it is
// the encode-side mirror of the decoder state machine above, producing
// streams our decoder, the reference, and liblzma all accept.
// ---------------------------------------------------------------------------

struct LzmaEncoder {
  RangeEncoder rc;
  Layout layout;
  std::vector<uint16_t> probs;
  int lc, lp, pb;
  int state = 0;
  uint32_t rep[4] = {0, 0, 0, 0};

  LzmaEncoder(int lc_, int lp_, int pb_)
      : layout(lc_ + lp_), lc(lc_), lp(lp_), pb(pb_) {
    probs.assign(layout.total, 0x400);
  }

  inline void bit(size_t idx, int b) { rc.encode_bit(&probs[idx], b); }

  inline void tree(int nbits, size_t base, uint32_t value) {
    uint32_t tmp = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      int b = (value >> i) & 1;
      rc.encode_bit(&probs[base + tmp], b);
      tmp = (tmp << 1) ^ uint32_t(b);
    }
  }

  inline void rtree(int nbits, size_t base, uint32_t value) {
    uint32_t tmp = 1;
    for (int i = 0; i < nbits; i++) {
      int b = (value >> i) & 1;
      rc.encode_bit(&probs[base + tmp], b);
      tmp = (tmp << 1) ^ uint32_t(b);
    }
  }

  inline void direct(uint32_t value, int nbits) {
    for (int i = nbits - 1; i >= 0; i--) {
      rc.range >>= 1;
      if ((value >> i) & 1) rc.low += rc.range;
      while (rc.range < 0x01000000u) {
        rc.range <<= 8;
        rc.write_low();
      }
    }
  }

  void encode_len(size_t base, size_t pos_state, uint32_t lval) {
    // lval in 0..271 (match length - 2), rangecoder.rs:253-269 mirror
    if (lval < 8) {
      rc.encode_bit(&probs[base + kLenChoice], 0);
      tree(3, base + kLenLow + pos_state * 8, lval);
    } else if (lval < 16) {
      rc.encode_bit(&probs[base + kLenChoice], 1);
      rc.encode_bit(&probs[base + kLenChoice2], 0);
      tree(3, base + kLenMid + pos_state * 8, lval - 8);
    } else {
      rc.encode_bit(&probs[base + kLenChoice], 1);
      rc.encode_bit(&probs[base + kLenChoice2], 1);
      tree(8, base + kLenHigh, lval - 16);
    }
  }

  void encode_distance(uint32_t len, uint32_t dist_field) {
    size_t len_state = len > 3 ? 3 : len;  // len = length value (0-based)
    uint32_t slot;
    if (dist_field < 4) {
      slot = dist_field;
    } else {
      int nb = 32 - __builtin_clz(dist_field);
      slot = uint32_t((nb - 1) * 2 + ((dist_field >> (nb - 2)) & 1));
    }
    tree(6, layout.pos_slot + len_state * 64, slot);
    if (slot < 4) return;
    int ndirect = int(slot >> 1) - 1;
    uint32_t base = (2 | (slot & 1)) << ndirect;
    uint32_t rest = dist_field - base;
    if (slot < 14) {
      // decoder reads spec_pos with offset (base - slot)
      // (lzma.rs:579-585); beware unsigned underflow when base == slot
      rtree(ndirect, layout.spec_pos + size_t(base - slot), rest);
    } else {
      direct(rest >> 4, ndirect - 4);
      rtree(4, layout.align, rest & 0xF);
    }
  }

  // ---- price queries (read-only mirrors of the encode methods) ---------

  uint32_t ptree(int nbits, size_t base, uint32_t value) const {
    uint32_t price = 0, tmp = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      int b = (value >> i) & 1;
      price += price_bit(probs[base + tmp], b);
      tmp = (tmp << 1) ^ uint32_t(b);
    }
    return price;
  }

  uint32_t prtree(int nbits, size_t base, uint32_t value) const {
    uint32_t price = 0, tmp = 1;
    for (int i = 0; i < nbits; i++) {
      int b = (value >> i) & 1;
      price += price_bit(probs[base + tmp], b);
      tmp = (tmp << 1) ^ uint32_t(b);
    }
    return price;
  }

  uint32_t price_len(size_t base, size_t pos_state, uint32_t lval) const {
    if (lval < 8)
      return price0(probs[base + kLenChoice]) +
             ptree(3, base + kLenLow + pos_state * 8, lval);
    if (lval < 16)
      return price1(probs[base + kLenChoice]) +
             price0(probs[base + kLenChoice2]) +
             ptree(3, base + kLenMid + pos_state * 8, lval - 8);
    return price1(probs[base + kLenChoice]) +
           price1(probs[base + kLenChoice2]) +
           ptree(8, base + kLenHigh, lval - 16);
  }

  uint32_t price_dist(uint32_t lval, uint32_t dist_field) const {
    size_t len_state = lval > 3 ? 3 : lval;
    uint32_t slot;
    if (dist_field < 4) {
      slot = dist_field;
    } else {
      int nb = 32 - __builtin_clz(dist_field);
      slot = uint32_t((nb - 1) * 2 + ((dist_field >> (nb - 2)) & 1));
    }
    uint32_t price = ptree(6, layout.pos_slot + len_state * 64, slot);
    if (slot < 4) return price;
    int ndirect = int(slot >> 1) - 1;
    uint32_t base = (2u | (slot & 1)) << ndirect;
    uint32_t rest = dist_field - base;
    if (slot < 14)
      return price + prtree(ndirect, layout.spec_pos + size_t(base - slot),
                            rest);
    return price + kDirectBitPrice * uint32_t(ndirect - 4) +
           prtree(4, layout.align, rest & 0xF);
  }

  // The _st variants price from an explicit adaptive (state, rep0)
  // instead of the encoder's current one: the optimal-parse DP tracks
  // the state machine and rep LRU per node along each candidate path
  // (liblzma's lzma_optimum does the same), so prices reflect the path
  // actually taken rather than the window-entry state.
  uint32_t price_match(size_t pos_state, uint32_t len,
                       uint32_t dist_field) const {
    return price_match_st(state, pos_state, len, dist_field);
  }

  uint32_t price_match_st(int st, size_t pos_state, uint32_t len,
                          uint32_t dist_field) const {
    uint32_t lval = len - 2;
    return price1(probs[layout.is_match + (size_t(st) << 4) + pos_state]) +
           price0(probs[layout.is_rep + st]) +
           price_len(layout.len_coder, pos_state, lval) +
           price_dist(lval, dist_field);
  }

  uint32_t price_rep(int r, uint32_t len, size_t pos_state) const {
    return price_rep_st(state, r, len, pos_state);
  }

  uint32_t price_rep_st(int st, int r, uint32_t len,
                        size_t pos_state) const {
    uint32_t price =
        price1(probs[layout.is_match + (size_t(st) << 4) + pos_state]) +
        price1(probs[layout.is_rep + st]);
    if (r == 0) {
      price += price0(probs[layout.is_rep_g0 + st]) +
               price1(probs[layout.is_rep_0long + (size_t(st) << 4) +
                            pos_state]);
    } else {
      price += price1(probs[layout.is_rep_g0 + st]);
      if (r == 1) {
        price += price0(probs[layout.is_rep_g1 + st]);
      } else {
        price += price1(probs[layout.is_rep_g1 + st]) +
                 price_bit(probs[layout.is_rep_g2 + st], r == 3);
      }
    }
    return price + price_len(layout.rep_len_coder, pos_state, len - 2);
  }

  // rep price without the length part (the DP caches length prices per
  // window, so the head and tail are priced separately there)
  uint32_t price_rep_head(int st, int r, size_t pos_state) const {
    uint32_t price =
        price1(probs[layout.is_match + (size_t(st) << 4) + pos_state]) +
        price1(probs[layout.is_rep + st]);
    if (r == 0) {
      price += price0(probs[layout.is_rep_g0 + st]) +
               price1(probs[layout.is_rep_0long + (size_t(st) << 4) +
                            pos_state]);
    } else {
      price += price1(probs[layout.is_rep_g0 + st]);
      if (r == 1) {
        price += price0(probs[layout.is_rep_g1 + st]);
      } else {
        price += price1(probs[layout.is_rep_g1 + st]) +
                 price_bit(probs[layout.is_rep_g2 + st], r == 3);
      }
    }
    return price;
  }

  uint32_t price_match_head(int st, size_t pos_state) const {
    return price1(probs[layout.is_match + (size_t(st) << 4) + pos_state]) +
           price0(probs[layout.is_rep + st]);
  }

  uint32_t price_shortrep(size_t pos_state) const {
    return price_shortrep_st(state, pos_state);
  }

  uint32_t price_shortrep_st(int st, size_t pos_state) const {
    return price1(probs[layout.is_match + (size_t(st) << 4) + pos_state]) +
           price1(probs[layout.is_rep + st]) +
           price0(probs[layout.is_rep_g0 + st]) +
           price0(probs[layout.is_rep_0long + (size_t(st) << 4) +
                        pos_state]);
  }

  uint32_t price_literal(const uint8_t* block, size_t pos,
                         size_t block_pos) const {
    return price_literal_st(state, rep[0], block, pos, block_pos);
  }

  uint32_t price_literal_st(int st, uint32_t rep0, const uint8_t* block,
                            size_t pos, size_t block_pos) const {
    size_t pos_state = block_pos & ((size_t(1) << pb) - 1);
    uint32_t price =
        price0(probs[layout.is_match + (size_t(st) << 4) + pos_state]);
    uint8_t byte = block[pos];
    uint8_t prev = pos > 0 ? block[pos - 1] : 0;
    size_t lit_state =
        ((block_pos & ((size_t(1) << lp) - 1)) << lc) + (prev >> (8 - lc));
    const uint16_t* p = &probs[layout.lit + lit_state * 0x300];
    unsigned result = 1;
    int i = 7;
    if (st >= 7) {
      unsigned match_byte = block[pos - rep0 - 1];
      for (; i >= 0; i--) {
        unsigned match_bit = (match_byte >> 7) & 1;
        match_byte = (match_byte << 1) & 0xFF;
        int b = (byte >> i) & 1;
        price += price_bit(p[((1 + match_bit) << 8) + result], b);
        result = (result << 1) ^ unsigned(b);
        if (int(match_bit) != b) {
          i--;
          break;
        }
      }
    }
    for (; i >= 0; i--) {
      int b = (byte >> i) & 1;
      price += price_bit(p[result], b);
      result = (result << 1) ^ unsigned(b);
    }
    return price;
  }

  void literal(const uint8_t* block, size_t pos, size_t block_pos) {
    // mirror of decode_literal (lzma.rs:526-561); block_pos = position
    // since dict reset (drives pos_state / literal position context)
    uint8_t byte = block[pos];
    uint8_t prev = pos > 0 ? block[pos - 1] : 0;
    size_t lit_state =
        ((block_pos & ((size_t(1) << lp) - 1)) << lc) + (prev >> (8 - lc));
    uint16_t* p = &probs[layout.lit + lit_state * 0x300];
    unsigned result = 1;
    int i = 7;
    if (state >= 7) {
      unsigned match_byte = block[pos - rep[0] - 1];
      for (; i >= 0; i--) {
        unsigned match_bit = (match_byte >> 7) & 1;
        match_byte = (match_byte << 1) & 0xFF;
        int b = (byte >> i) & 1;
        rc.encode_bit(&p[((1 + match_bit) << 8) + result], b);
        result = (result << 1) ^ unsigned(b);
        if (int(match_bit) != b) {
          i--;
          break;
        }
      }
    }
    for (; i >= 0; i--) {
      int b = (byte >> i) & 1;
      rc.encode_bit(&p[result], b);
      result = (result << 1) ^ unsigned(b);
    }
  }
};

constexpr uint32_t kMaxMatchLen = 273;
// Declared LZMA2 dictionary size (matches the .xz filter props byte 22 ->
// 8 MiB); encoder distances must respect it or strict decoders (liblzma)
// reject the stream.
constexpr size_t kEncDictSize = size_t(1) << 23;

// A match candidate; find_all returns a pareto front ordered by
// strictly increasing length (each longer candidate supersedes nearer,
// shorter ones for its length range).
struct Cand {
  uint32_t len, dist;
};
constexpr int kMaxCands = 24;

// Word-at-a-time match extension: compare 8 bytes per iteration and
// locate the first differing byte with ctz. All callers bound `limit`
// by the block end, so the 8-byte loads never read past `data + n`.
static inline size_t extend_match(const uint8_t* a, const uint8_t* b,
                                  size_t l, size_t limit) {
  while (l + 8 <= limit) {
    uint64_t x, y;
    memcpy(&x, a + l, 8);
    memcpy(&y, b + l, 8);
    const uint64_t d = x ^ y;
    if (d) return l + (size_t(__builtin_ctzll(d)) >> 3);
    l += 8;
  }
  while (l < limit && a[l] == b[l]) l++;
  return l;
}

// Greedy hash-chain match finder (hash of 4 bytes).
struct MatchFinder {
  const uint8_t* data;
  size_t n;
  std::vector<int32_t> head;   // hash -> most recent pos
  std::vector<int32_t> chain;  // pos -> previous pos with same hash
  int depth;
  static constexpr int kHashBits = 17;

  MatchFinder(const uint8_t* d, size_t n_, int depth_)
      : data(d), n(n_), head(size_t(1) << kHashBits, -1), chain(n_, -1),
        depth(depth_) {}

  static inline uint32_t hash4(const uint8_t* p) {
    uint32_t x;
    memcpy(&x, p, 4);
    return (x * 2654435761u) >> (32 - kHashBits);
  }

  inline void insert(size_t pos) {
    if (pos + 4 > n) return;
    uint32_t h = hash4(data + pos);
    chain[pos] = head[h];
    head[h] = int32_t(pos);
  }

  // Longest match at pos with distance <= max_dist; returns (len, dist).
  inline std::pair<uint32_t, uint32_t> find(size_t pos, size_t max_dist,
                                            size_t limit) const {
    uint32_t best_len = 0, best_dist = 0;
    if (pos + 4 > n) return {0, 0};
    int32_t cand = head[hash4(data + pos)];
    int tries = depth;
    const uint8_t* cur = data + pos;
    while (cand >= 0 && tries-- > 0) {
      size_t dist = pos - size_t(cand);
      if (dist > max_dist) break;  // chain is position-ordered
      const uint8_t* q = data + cand;
      if (q[best_len] == cur[best_len]) {
        size_t l = extend_match(q, cur, 0, limit);
        if (l > best_len) {
          best_len = uint32_t(l);
          best_dist = uint32_t(dist);
          if (l >= limit) break;
        }
      }
      cand = chain[cand];
    }
    return {best_len, best_dist};
  }

  // Unified finder API: search (pre-insert state), then insert pos.
  inline int find_all(size_t pos, size_t max_dist, size_t limit,
                      Cand* out) {
    auto [l, d] = pos + 4 <= n ? find(pos, max_dist, limit)
                               : std::pair<uint32_t, uint32_t>{0, 0};
    insert(pos);
    if (l >= 2) {
      out[0] = {l, d};
      return 1;
    }
    return 0;
  }
};

// Binary-tree match finder (bt4 family: hash2/hash3 recency tables for
// short near matches + a binary search tree per hash4 bucket, ordered by
// suffix). Compared to the hash chain it finds the true longest match
// within the window AND the pareto front of shorter-but-nearer
// alternatives — which is what the price-density and DP parses need.
// Tree maintenance (a re-linking walk per inserted position) makes it
// ~2x the insert cost of the chain; used by levels >= 4. The structural
// invariant: the bucket root is the newest position and every step down
// the tree reaches an older one, so a distance beyond the window cuts
// the whole subtree.
struct Bt4MatchFinder {
  const uint8_t* data;
  size_t n;
  std::vector<int32_t> head2, head3, head;
  std::vector<int32_t> tree;  // [2*pos] = left child, [2*pos+1] = right
  int depth;
  size_t dist_cap;  // 0 = uncapped (window = dict size)
  static constexpr int kHashBits = 17;
  static constexpr int kHash2Bits = 10;
  static constexpr int kHash3Bits = 16;

  Bt4MatchFinder(const uint8_t* d, size_t n_, int depth_, size_t cap)
      : data(d), n(n_),
        head2(size_t(1) << kHash2Bits, -1),
        head3(size_t(1) << kHash3Bits, -1),
        head(size_t(1) << kHashBits, -1),
        tree(2 * n_, -1), depth(depth_), dist_cap(cap) {}

  static inline uint32_t hash4(const uint8_t* p) {
    uint32_t x;
    memcpy(&x, p, 4);
    return (x * 2654435761u) >> (32 - kHashBits);
  }
  static inline uint32_t hash2(const uint8_t* p) {
    uint32_t x = uint32_t(p[0]) | (uint32_t(p[1]) << 8);
    return (x * 2654435761u) >> (32 - kHash2Bits);
  }
  static inline uint32_t hash3(const uint8_t* p) {
    uint32_t x =
        uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
    return (x * 2654435761u) >> (32 - kHash3Bits);
  }

  inline size_t window_at(size_t pos) const {
    size_t w = pos < kEncDictSize ? pos : kEncDictSize;
    if (dist_cap && w > dist_cap) w = dist_cap;
    return w;
  }

  // Core walk: collect pareto candidates (when out != nullptr) and
  // re-link pos into its bucket's tree. Candidates from hash2/hash3
  // come first (fully extended), then tree candidates with strictly
  // increasing length. ``search_limit`` caps REPORTED candidate lengths
  // (chunk boundaries); tree comparisons always run to the block-wide
  // ``tree_limit`` — capping them at a chunk tail would adopt unequal
  // suffixes as equal and corrupt the ordering for future searches.
  int walk(size_t pos, size_t max_dist, size_t search_limit,
           size_t tree_limit, Cand* out) {
    int n_out = 0;
    uint32_t best = 1;
    const uint8_t* cur = data + pos;
    if (pos + 2 <= n) {
      uint32_t h2v = hash2(cur);
      int32_t c2 = head2[h2v];
      head2[h2v] = int32_t(pos);
      if (out && c2 >= 0 && pos - size_t(c2) <= max_dist) {
        const uint8_t* q = data + c2;
        size_t l = extend_match(q, cur, 0, search_limit);
        if (l >= 2) {
          best = uint32_t(l);
          out[n_out++] = {best, uint32_t(pos - size_t(c2))};
        }
      }
    }
    if (pos + 3 <= n) {
      uint32_t h3v = hash3(cur);
      int32_t c3 = head3[h3v];
      head3[h3v] = int32_t(pos);
      if (out && c3 >= 0 && pos - size_t(c3) <= max_dist) {
        const uint8_t* q = data + c3;
        size_t l = extend_match(q, cur, 0, search_limit);
        if (l >= 3 && l > best) {
          best = uint32_t(l);
          out[n_out++] = {best, uint32_t(pos - size_t(c3))};
        }
      }
    }
    if (pos + 4 > n) return n_out;
    uint32_t h = hash4(cur);
    int32_t cand = head[h];
    head[h] = int32_t(pos);
    int32_t* ptr0 = &tree[2 * pos + 1];
    int32_t* ptr1 = &tree[2 * pos];
    uint32_t len0 = 0, len1 = 0;
    int tries = depth;
    for (;;) {
      if (cand < 0 || tries-- <= 0 || pos - size_t(cand) > max_dist) {
        *ptr0 = -1;
        *ptr1 = -1;
        break;
      }
      const uint8_t* q = data + cand;
      uint32_t len = len0 < len1 ? len0 : len1;
      // the walk is a pointer-chase through tree[]; prefetching the
      // candidate's child pair (one cache line) overlaps the string
      // compare with the next node's load (+8% encode throughput;
      // prefetching q+len as well measured slower)
      __builtin_prefetch(&tree[2 * size_t(cand)]);
      if (q[len] == cur[len]) {
        len = uint32_t(extend_match(q, cur, len, tree_limit));
        uint32_t cl = len < search_limit ? len : uint32_t(search_limit);
        if (out && cl > best && cl >= 2 && n_out < kMaxCands) {
          best = cl;
          out[n_out++] = {cl, uint32_t(pos - size_t(cand))};
        }
        if (len >= tree_limit) {
          // full-prefix equality: adopt cand's children, done
          *ptr1 = tree[2 * size_t(cand)];
          *ptr0 = tree[2 * size_t(cand) + 1];
          break;
        }
      }
      if (q[len] < cur[len]) {
        *ptr1 = cand;
        ptr1 = &tree[2 * size_t(cand) + 1];
        len1 = len;
        cand = *ptr1;
      } else {
        *ptr0 = cand;
        ptr0 = &tree[2 * size_t(cand)];
        len0 = len;
        cand = *ptr0;
      }
    }
    return n_out;
  }

  inline size_t tree_limit_at(size_t pos) const {
    size_t l = n - pos;
    return l > kMaxMatchLen ? kMaxMatchLen : l;
  }

  inline int find_all(size_t pos, size_t max_dist, size_t limit,
                      Cand* out) {
    return walk(pos, max_dist, limit, tree_limit_at(pos), out);
  }

  // Insert-only (positions covered by an emitted match).
  inline void insert(size_t pos) {
    size_t tl = tree_limit_at(pos);
    walk(pos, window_at(pos), tl, tl, nullptr);
  }
};


// ---------------------------------------------------------------------------
// Optimal-parse: forward shortest-path DP over a sliding lookahead
// window, pricing literal / short-rep / rep / match transitions from the
// CURRENT adaptive model (prices refresh every window). Each node
// carries the (state machine, rep LRU) context along its best path, so
// prices and rep candidates reflect the path actually taken (liblzma's
// lzma_optimum does the same). Approximations vs a full optimum: the
// PROBABILITIES are frozen at window start (no mid-window price
// refresh), and only lengths {2..8, Lmax} are relaxed per candidate.
// Steps record the match DISTANCE, not the LRU index — emission
// re-resolves the distance against the true LRU (or degrades
// rep->match / shortrep->literal), so the produced stream is always
// byte-correct even where pricing drifted.
// ---------------------------------------------------------------------------

struct OptNode {
  uint64_t cost;
  int32_t from;
  uint8_t kind;  // 0 literal, 1 shortrep, 2 rep(dist), 3 match(dist)
  uint8_t st;    // adaptive state machine value along the best path here
  uint16_t len;
  uint32_t dist;     // 1-based distance for kinds 1-3
  uint32_t reps[4];  // rep LRU (0-based distances) along the best path
};

// Round-4: 128 -> 512. Short windows force a "land on node n" parse
// whose boundary distorts literal-vs-match choices every 128 bytes;
// 512 quarters the boundary frequency and the overshoot credit below
// removes most of the rest (foo.txt L6 ratio 1.020 -> see RATIO_PINS).
constexpr int kOptWin = 512;

// Emit one parsed step at `pos`, resolving distance-coded reps against
// the encoder's true LRU. Always produces the same decoded bytes.
static void emit_step(const uint8_t* block, size_t pos, LzmaEncoder& enc,
                      int kind, uint32_t len, uint32_t dist) {
  size_t pos_state = pos & ((size_t(1) << enc.pb) - 1);
  if (kind == 1 && size_t(enc.rep[0]) + 1 != dist)
    kind = 0;  // shortrep drifted: the byte is block[pos] either way
  if (kind == 2) {
    int r = -1;
    for (int i = 0; i < 4; i++)
      if (size_t(enc.rep[i]) + 1 == dist) {
        r = i;
        break;
      }
    if (r < 0) {
      kind = 3;  // LRU drifted: same bytes as a normal match
    } else {
      enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
      enc.bit(enc.layout.is_rep + enc.state, 1);
      if (r == 0) {
        enc.bit(enc.layout.is_rep_g0 + enc.state, 0);
        enc.bit(
            enc.layout.is_rep_0long + (size_t(enc.state) << 4) + pos_state,
            1);
      } else {
        enc.bit(enc.layout.is_rep_g0 + enc.state, 1);
        if (r == 1) {
          enc.bit(enc.layout.is_rep_g1 + enc.state, 0);
        } else {
          enc.bit(enc.layout.is_rep_g1 + enc.state, 1);
          enc.bit(enc.layout.is_rep_g2 + enc.state, r == 3);
        }
        uint32_t d = enc.rep[r];
        for (int i = r - 1; i >= 0; i--) enc.rep[i + 1] = enc.rep[i];
        enc.rep[0] = d;
      }
      enc.encode_len(enc.layout.rep_len_coder, pos_state, len - 2);
      enc.state = enc.state < 7 ? 8 : 11;
      return;
    }
  }
  if (kind == 3) {
    enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
    enc.bit(enc.layout.is_rep + enc.state, 0);
    enc.rep[3] = enc.rep[2];
    enc.rep[2] = enc.rep[1];
    enc.rep[1] = enc.rep[0];
    enc.rep[0] = dist - 1;
    uint32_t lval = len - 2;
    enc.encode_len(enc.layout.len_coder, pos_state, lval);
    enc.state = enc.state < 7 ? 7 : 10;
    enc.encode_distance(lval, dist - 1);
    return;
  }
  if (kind == 1) {
    enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
    enc.bit(enc.layout.is_rep + enc.state, 1);
    enc.bit(enc.layout.is_rep_g0 + enc.state, 0);
    enc.bit(enc.layout.is_rep_0long + (size_t(enc.state) << 4) + pos_state,
            0);
    enc.state = enc.state < 7 ? 9 : 11;
    return;
  }
  enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 0);
  enc.literal(block, pos, pos);
  enc.state = enc.state < 4 ? 0
                            : (enc.state < 10 ? enc.state - 3
                                              : enc.state - 6);
}

// Per-window price tables (liblzma precomputes the same; probabilities
// are frozen during a DP window since emission happens only at trace-
// back, so caching is exact). Length prices cover both len coders x
// pos_state x all 272 values; distance prices cache every dist_field
// < 128 fully and fall back to slot + direct + align tables beyond
// (dist_field >= 128 implies slot >= 14: no spec_pos part).
//
// Build cost matters: one build per 512-byte DP window was ~20% of
// encode time when each leaf price re-walked its tree. The builders
// below enumerate a whole tree's leaf prices in O(leaves) via the
// node-cumulative table (cum[2m] = cum[m] + price0, cum[2m+1] = cum[m]
// + price1), then assemble the public tables with adds only.

// out[sym] = price of coding `sym` through the `bits`-deep forward
// tree at probs[base+1..]; cum must hold 2<<bits entries.
static void tree_leaf_prices(const uint16_t* probs, size_t base, int bits,
                             uint32_t* out, uint32_t* cum) {
  const int top = 1 << bits;
  cum[1] = 0;
  for (int m = 1; m < top; m++) {
    uint16_t p = probs[base + size_t(m)];
    cum[2 * m] = cum[m] + price0(p);
    cum[2 * m + 1] = cum[m] + price1(p);
  }
  for (int s = 0; s < top; s++) out[s] = cum[top + s];
}

// Reverse-tree variant (bits consumed LSB-first): leaf node top+m
// corresponds to value bitrev(m).
static void rtree_leaf_prices(const uint16_t* probs, size_t base, int bits,
                              uint32_t* out, uint32_t* cum) {
  const int top = 1 << bits;
  cum[1] = 0;
  for (int m = 1; m < top; m++) {
    uint16_t p = probs[base + size_t(m)];
    cum[2 * m] = cum[m] + price0(p);
    cum[2 * m + 1] = cum[m] + price1(p);
  }
  for (int m = 0; m < top; m++) {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) v |= uint32_t((m >> i) & 1) << (bits - 1 - i);
    out[v] = cum[top + m];
  }
}

struct WinPrices {
  uint32_t len_p[2][16][272];
  uint32_t dist_lo[4][128];
  uint32_t slot_p[4][64];
  uint32_t align_p[16];

  void build(const LzmaEncoder& enc) {
    uint32_t cum[512];
    uint32_t high_p[256], low_p[8], mid_p[8];
    const uint16_t* pr = enc.probs.data();
    size_t nps = size_t(1) << enc.pb;
    for (int rep = 0; rep < 2; rep++) {
      size_t base =
          rep ? enc.layout.rep_len_coder : enc.layout.len_coder;
      uint32_t c0 = price0(pr[base + kLenChoice]);
      uint32_t c1 = price1(pr[base + kLenChoice]);
      uint32_t c20 = c1 + price0(pr[base + kLenChoice2]);
      uint32_t c21 = c1 + price1(pr[base + kLenChoice2]);
      tree_leaf_prices(pr, base + kLenHigh, 8, high_p, cum);
      for (size_t ps = 0; ps < nps; ps++) {
        tree_leaf_prices(pr, base + kLenLow + ps * 8, 3, low_p, cum);
        tree_leaf_prices(pr, base + kLenMid + ps * 8, 3, mid_p, cum);
        uint32_t* lp = len_p[rep][ps];
        for (int v = 0; v < 8; v++) lp[v] = c0 + low_p[v];
        for (int v = 0; v < 8; v++) lp[8 + v] = c20 + mid_p[v];
        for (int v = 0; v < 256; v++) lp[16 + v] = c21 + high_p[v];
      }
    }
    for (int ls = 0; ls < 4; ls++)
      tree_leaf_prices(pr, enc.layout.pos_slot + size_t(ls) * 64, 6,
                       slot_p[ls], cum);
    // spec-pos contribution for df in [4, 128) is len_state-independent
    uint32_t spec_part[128] = {0};
    for (uint32_t slot = 4; slot < 14; slot++) {
      int nd = int(slot >> 1) - 1;
      uint32_t base_d = (2u | (slot & 1)) << nd;
      uint32_t rp[32];
      rtree_leaf_prices(pr, enc.layout.spec_pos + size_t(base_d - slot),
                        nd, rp, cum);
      for (uint32_t rest = 0; rest < (1u << nd); rest++)
        spec_part[base_d + rest] = rp[rest];
    }
    for (int ls = 0; ls < 4; ls++) {
      for (uint32_t df = 0; df < 4; df++) dist_lo[ls][df] = slot_p[ls][df];
      for (uint32_t df = 4; df < 128; df++) {
        int nb = 32 - __builtin_clz(df);
        uint32_t slot = uint32_t((nb - 1) * 2 + ((df >> (nb - 2)) & 1));
        dist_lo[ls][df] = slot_p[ls][slot] + spec_part[df];
      }
    }
    rtree_leaf_prices(pr, enc.layout.align, 4, align_p, cum);
  }

  uint32_t dist(uint32_t lval, uint32_t df) const {
    size_t ls = lval > 3 ? 3 : lval;
    if (df < 128) return dist_lo[ls][df];
    int nb = 32 - __builtin_clz(df);
    uint32_t slot = uint32_t((nb - 1) * 2 + ((df >> (nb - 2)) & 1));
    int nd = int(slot >> 1) - 1;
    return slot_p[ls][slot] + kDirectBitPrice * uint32_t(nd - 4) +
           align_p[df & 0xF];
  }
};

// One DP window starting at `start`; emits the optimal step sequence and
// returns the new position (> start).
extern "C++" {
template <class MF>
static size_t optimal_parse_emit(const uint8_t* block, size_t start,
                                 size_t end, MF& mf,
                                 LzmaEncoder& enc, size_t dist_cap) {
  constexpr uint64_t kInf = ~0ull;
  // Long-rep shortcut: a rep0 run covering the whole DP window (long
  // literal runs, structured repeats) is emitted directly — no cheaper
  // parse of it exists, and skipping the DP makes run-heavy data encode
  // at greedy speed.
  {
    size_t max_dist = start < kEncDictSize ? start : kEncDictSize;
    if (dist_cap && max_dist > dist_cap) max_dist = dist_cap;
    size_t d0 = size_t(enc.rep[0]) + 1;
    if (d0 <= max_dist) {
      // probe the run beyond the match-length cap: the shortcut is for
      // runs covering the WHOLE window (no cheaper parse exists and
      // run-heavy data must encode at greedy speed); a mere max-length
      // match still goes through the DP, which can parse it better
      // (the round-4 kOptWin bump made the old l-capped test dead).
      size_t probe = end - start;
      if (probe > kOptWin) probe = kOptWin;
      const uint8_t* q = block + start - d0;
      size_t l_run = extend_match(q, block + start, 0, probe);
      if (l_run >= kMaxMatchLen || (l_run >= 2 && l_run == end - start)) {
        size_t l = l_run > kMaxMatchLen ? kMaxMatchLen : l_run;
        emit_step(block, start, enc, 2, uint32_t(l), uint32_t(d0));
        for (size_t p = start; p < start + l; p++) mf.insert(p);
        return start + l;
      }
    }
  }
  static thread_local WinPrices wp;
  wp.build(enc);
  const int n = int(std::min<size_t>(kOptWin, end - start));
  // Nodes extend past the window end by a full match length: a match
  // from node i < n may land anywhere in (n, n + kMaxMatchLen]; keeping
  // those terminals un-clamped lets the trace-back credit the extra
  // covered bytes instead of charging a full match price against a
  // literal path that covers less input (the old clamp-to-n rule).
  const int nx = n + int(kMaxMatchLen);
  static thread_local std::vector<OptNode> nodes;
  nodes.assign(size_t(nx) + 1, OptNode{kInf, -1, 0, 0, 0, 0, {0, 0, 0, 0}});
  nodes[0].cost = 0;
  nodes[0].st = uint8_t(enc.state);
  for (int r = 0; r < 4; r++) nodes[0].reps[r] = enc.rep[r];

  for (int i = 0; i < n; i++) {
    if (nodes[i].cost == kInf) continue;
    const size_t ap = start + i;
    const size_t ps = ap & ((size_t(1) << enc.pb) - 1);
    const OptNode& ni = nodes[i];
    const uint64_t c = ni.cost;
    // Per-node adaptive context (state machine + rep LRU along the best
    // path into i): prices and rep candidates reflect the path actually
    // taken, not the window-entry snapshot.
    const int st = ni.st;
    const uint32_t rp[4] = {ni.reps[0], ni.reps[1], ni.reps[2], ni.reps[3]};
    auto relax = [&](size_t j, uint64_t cost, uint8_t kind, uint16_t len,
                     uint32_t dist, int r) {
      size_t jj = j > size_t(nx) ? size_t(nx) : j;
      OptNode& nd = nodes[jj];
      if (cost >= nd.cost) return;
      nd.cost = cost;
      nd.from = int32_t(i);
      nd.kind = kind;
      nd.len = len;
      nd.dist = dist;
      switch (kind) {
        case 0:
          nd.st = uint8_t(st < 4 ? 0 : (st < 10 ? st - 3 : st - 6));
          for (int k = 0; k < 4; k++) nd.reps[k] = rp[k];
          break;
        case 1:
          nd.st = uint8_t(st < 7 ? 9 : 11);
          for (int k = 0; k < 4; k++) nd.reps[k] = rp[k];
          break;
        case 2: {
          nd.st = uint8_t(st < 7 ? 8 : 11);
          const uint32_t d = rp[r];
          for (int k = 0; k < 4; k++) nd.reps[k] = rp[k];
          for (int k = r; k > 0; k--) nd.reps[k] = nd.reps[k - 1];
          nd.reps[0] = d;
          break;
        }
        default:
          nd.st = uint8_t(st < 7 ? 7 : 10);
          nd.reps[0] = dist - 1;
          nd.reps[1] = rp[0];
          nd.reps[2] = rp[1];
          nd.reps[3] = rp[2];
          break;
      }
    };
    relax(size_t(i) + 1, c + enc.price_literal_st(st, rp[0], block, ap, ap),
          0, 1, 0, -1);

    size_t limit = end - ap;
    if (limit > kMaxMatchLen) limit = kMaxMatchLen;
    size_t max_dist = ap < kEncDictSize ? ap : kEncDictSize;
    if (dist_cap && max_dist > dist_cap) max_dist = dist_cap;

    for (int r = 0; r < 4; r++) {
      size_t d = size_t(rp[r]) + 1;
      if (d > max_dist) continue;  // max_dist <= ap, so d <= ap holds
      const uint8_t* q = block + ap - d;
      size_t l = extend_match(q, block + ap, 0, limit);
      if (r == 0 && l >= 1)
        relax(size_t(i) + 1, c + enc.price_shortrep_st(st, ps), 1, 1,
              uint32_t(d), 0);
      if (l < 2) continue;
      uint32_t lmax = uint32_t(l);
      const uint64_t rep_head = c + enc.price_rep_head(st, r, ps);
      const uint32_t* lp_rep = wp.len_p[1][ps];
      // dense rep-length relaxation (round 5): the O(leaves) WinPrices
      // build made per-length pricing nearly free, and lens 13..24 are
      // common on text — rep<=12 left ~0.3% ratio on the table
      for (uint32_t len = 2; len <= 24 && len <= lmax; len++)
        relax(size_t(i) + len, rep_head + lp_rep[len - 2], 2,
              uint16_t(len), uint32_t(d), r);
      if (lmax > 24)
        relax(size_t(i) + lmax, rep_head + lp_rep[lmax - 2], 2,
              uint16_t(lmax), uint32_t(d), r);
    }

    Cand cands[kMaxCands];
    int nc = mf.find_all(ap, max_dist, limit, cands);
    uint32_t prev_len = 1;
    const uint64_t match_head = c + enc.price_match_head(st, ps);
    const uint32_t* lp_m = wp.len_p[0][ps];
    for (int ci = 0; ci < nc; ci++) {
      uint32_t ml = cands[ci].len, md = cands[ci].dist;
      if (ml < 2) continue;
      // each pareto candidate prices the length range its predecessor
      // could not reach (nearer candidates are cheaper for short lens)
      uint32_t lo = prev_len + 1 < 2 ? 2 : prev_len + 1;
      uint32_t hi = std::min(ml, lo + 30);
      for (uint32_t len = lo; len <= hi; len++)
        relax(size_t(i) + len,
              match_head + lp_m[len - 2] + wp.dist(len - 2, md - 1),
              3, uint16_t(len), md, -1);
      if (ml > hi)
        relax(size_t(i) + ml,
              match_head + lp_m[ml - 2] + wp.dist(ml - 2, md - 1),
              3, uint16_t(ml), md, -1);
      prev_len = ml;
    }
  }

  // Trace the optimal path back from the best terminal at or beyond the
  // window end. Terminals cover different amounts of input, so compare
  // cost minus an average-rate credit for the extra bytes (the window's
  // own realized bits/byte is the estimate) — a match overshooting the
  // boundary is then rewarded for the future work it removes.
  static thread_local std::vector<int> path;
  path.clear();
  int best_j = n;
  {
    const uint64_t avg = nodes[n].cost != kInf && n > 0
                             ? nodes[n].cost / uint64_t(n)
                             : 0;
    int64_t best_v = INT64_MAX;
    for (int j = n; j <= nx; j++) {
      if (nodes[j].cost == kInf) continue;
      int64_t v = int64_t(nodes[j].cost) - int64_t(avg) * (j - n);
      if (v < best_v) {
        best_v = v;
        best_j = j;
      }
    }
  }
  for (int j = best_j; j > 0; j = nodes[j].from) path.push_back(j);
  size_t p = start;
  for (auto it = path.rbegin(); it != path.rend(); ++it) {
    const OptNode& s = nodes[*it];
    emit_step(block, p, enc, s.kind, s.len, s.dist);
    size_t next = p + s.len;
    // positions beyond the DP loop (a final match overshooting the
    // window) still need match-finder insertion
    for (size_t q = std::max(p + 1, start + size_t(n)); q < next; q++)
      mf.insert(q);
    p = next;
  }
  return p;
}

// Encode block[start..end) as one LZMA chunk payload. `block` begins at
// the dict-reset point (positions are block-relative). The encoder state
// (probs/state/reps) persists across chunks of a block (LZMA2 reset_mode
// 0 continuation); only the range coder restarts per chunk. parse_mode:
// 2 = the optimal-parse-lite DP above, 1 = greedy with price-density
// candidate selection, 0 = greedy with length heuristics + lazy
// lookahead.
template <class MF>
static std::string encode_lzma_chunk(const uint8_t* block, size_t start,
                                     size_t end, MF& mf,
                                     LzmaEncoder& enc, int parse_mode,
                                     size_t dist_cap) {
  enc.rc = RangeEncoder();
  if (parse_mode == 2) {
    size_t p = start;
    while (p < end) p = optimal_parse_emit(block, p, end, mf, enc, dist_cap);
    enc.rc.finish();
    return std::move(enc.rc.out);
  }
  const int pb = enc.pb;
  size_t pos = start;
  // one-position lazy-lookahead cache: a peek at pos+1 inserts pos+1
  // into the finder (bt4 walks re-link the tree), so the result is
  // cached and consumed instead of re-walking (or double-inserting)
  Cand cached_cands[kMaxCands];
  int cached_nc = 0;
  size_t cached_at = SIZE_MAX;
  while (pos < end) {
    size_t pos_state = pos & ((size_t(1) << pb) - 1);
    size_t limit = end - pos;
    if (limit > kMaxMatchLen) limit = kMaxMatchLen;
    // window = block start .. pos, capped by the declared dict size and
    // the optional ring cap (TPU ring-window decode profile)
    size_t max_dist = pos < kEncDictSize ? pos : kEncDictSize;
    if (dist_cap && max_dist > dist_cap) max_dist = dist_cap;

    // rep candidates
    uint32_t rep_len[4] = {0, 0, 0, 0};
    for (int r = 0; r < 4; r++) {
      size_t dist = size_t(enc.rep[r]) + 1;
      if (dist > max_dist) continue;
      const uint8_t* q = block + pos - dist;
      size_t l = extend_match(q, block + pos, 0, limit);
      rep_len[r] = uint32_t(l);
    }
    // normal-match candidates (find_all searches the pre-insert state —
    // a self-match at distance 0 would read as the EOS marker — then
    // inserts pos)
    Cand cands[kMaxCands];
    int nc;
    if (cached_at == pos) {
      nc = cached_nc;
      if (nc > 0) memcpy(cands, cached_cands, sizeof(Cand) * size_t(nc));
    } else {
      nc = mf.find_all(pos, max_dist, limit, cands);
    }
    uint32_t m_len = nc ? cands[nc - 1].len : 0;
    uint32_t m_dist = nc ? cands[nc - 1].dist : 0;

    int best_rep = -1;
    uint32_t best_rep_len = 0;
    for (int r = 0; r < 4; r++)
      if (rep_len[r] > best_rep_len) {
        best_rep_len = rep_len[r];
        best_rep = r;
      }

    bool use_rep, use_match;
    if (parse_mode == 1) {
      // Price-density selection: choose the symbol with the lowest coded
      // bits per byte advanced, from the *current adaptive* model. The
      // denominator makes long matches win over marginally-cheaper short
      // ones; cross-multiplication avoids floating point.
      uint64_t lit_price = enc.price_literal(block, pos, pos);
      // candidates: 0 = literal, 1 = shortrep, 2 = rep, 3 = match
      int kind = 0;
      uint64_t best_price = lit_price;
      uint64_t best_adv = 1;
      auto better = [&](uint64_t price, uint64_t adv) {
        return price * best_adv < best_price * adv;
      };
      if (rep_len[0] >= 1) {
        uint64_t p = enc.price_shortrep(pos_state);
        if (better(p, 1)) {
          kind = 1;
          best_price = p;
          best_adv = 1;
        }
      }
      int price_rep_idx = -1;
      for (int r = 0; r < 4; r++) {
        if (rep_len[r] < 2) continue;
        uint64_t p = enc.price_rep(r, rep_len[r], pos_state);
        if (better(p, rep_len[r])) {
          kind = 2;
          best_price = p;
          best_adv = rep_len[r];
          price_rep_idx = r;
        }
      }
      for (int ci = 0; ci < nc; ci++) {
        uint32_t cl = cands[ci].len, cd = cands[ci].dist;
        if (cl < 2) continue;
        uint64_t p = enc.price_match(pos_state, cl, cd - 1);
        if (better(p, cl)) {
          kind = 3;
          best_price = p;
          best_adv = cl;
          m_len = cl;
          m_dist = cd;
        }
      }
      // Lazy lookahead: emitting a literal first is worth it when the
      // match starting at pos+1 is strictly denser than this symbol.
      if ((kind == 2 || kind == 3) && best_adv >= 2 &&
          pos + 1 + 4 <= end) {
        size_t lim2 = end - (pos + 1);
        if (lim2 > kMaxMatchLen) lim2 = kMaxMatchLen;
        cached_nc = mf.find_all(pos + 1, max_dist + 1, lim2,
                                cached_cands);
        cached_at = pos + 1;
        uint32_t n_len = cached_nc ? cached_cands[cached_nc - 1].len : 0;
        uint32_t n_dist = cached_nc ? cached_cands[cached_nc - 1].dist : 0;
        if (n_len > best_adv) {
          uint64_t np = enc.price_match(pos_state, n_len, n_dist - 1);
          if ((lit_price + np) * best_adv <
              best_price * (1 + uint64_t(n_len))) {
            kind = 0;
          }
        }
      }
      if (kind == 2) {
        best_rep = price_rep_idx;
        best_rep_len = rep_len[price_rep_idx];
      }
      use_rep = kind == 2;
      use_match = kind == 3;
      if (kind == 1) {
        // force the short-rep branch below
        use_rep = false;
        use_match = false;
        best_rep = 0;
        m_len = 0;
      } else if (kind == 0) {
        use_rep = false;
        use_match = false;
        best_rep = -1;  // fall through to literal
      }
    } else {
      // Length heuristics (fast levels): a far match must be longer to
      // pay for its distance bits.
      if (m_len >= 3) {
        if ((m_len == 3 && m_dist > (1u << 12)) ||
            (m_len == 4 && m_dist > (1u << 20)) ||
            (m_len == 5 && m_dist > (1u << 26)))
          m_len = 0;
      }
      // A rep match beats a normal match unless the normal one is at
      // least 2 longer (rep distances cost almost nothing to code).
      use_rep = best_rep_len >= 2 && best_rep_len + 1 >= m_len;
      use_match = !use_rep && m_len >= 3;

      // Lazy lookahead: if the match at pos+1 is longer, or as long but
      // much nearer, emit a literal now and take it next iteration.
      if (use_match && pos + 1 + 4 <= end && m_len < kMaxMatchLen) {
        size_t lim2 = end - (pos + 1);
        if (lim2 > kMaxMatchLen) lim2 = kMaxMatchLen;
        cached_nc = mf.find_all(pos + 1, max_dist + 1, lim2,
                                cached_cands);
        cached_at = pos + 1;
        uint32_t n_len = cached_nc ? cached_cands[cached_nc - 1].len : 0;
        uint32_t n_dist = cached_nc ? cached_cands[cached_nc - 1].dist : 0;
        if (n_len > m_len ||
            (n_len == m_len && n_dist + (n_dist >> 3) < m_dist))
          use_match = false;
        // also defer to an upcoming rep match: check if pos+1 continues
        // rep0 (cheap and common in structured data)
        if (use_match && enc.rep[0] + 1 <= max_dist + 1 && m_len < 64) {
          size_t d0 = size_t(enc.rep[0]) + 1;
          if (pos + 1 >= d0) {
            const uint8_t* q = block + pos + 1 - d0;
            size_t l = extend_match(q, block + pos + 1, 0, lim2);
            if (l >= size_t(m_len)) use_match = false;
          }
        }
      }
    }

    if (use_rep) {
      uint32_t len = best_rep_len;
      enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
      enc.bit(enc.layout.is_rep + enc.state, 1);
      if (best_rep == 0) {
        enc.bit(enc.layout.is_rep_g0 + enc.state, 0);
        enc.bit(enc.layout.is_rep_0long + (size_t(enc.state) << 4) + pos_state,
                1);
      } else {
        enc.bit(enc.layout.is_rep_g0 + enc.state, 1);
        if (best_rep == 1) {
          enc.bit(enc.layout.is_rep_g1 + enc.state, 0);
        } else {
          enc.bit(enc.layout.is_rep_g1 + enc.state, 1);
          enc.bit(enc.layout.is_rep_g2 + enc.state, best_rep == 3);
        }
        uint32_t d = enc.rep[best_rep];
        for (int i = best_rep - 1; i >= 0; i--) enc.rep[i + 1] = enc.rep[i];
        enc.rep[0] = d;
      }
      enc.encode_len(enc.layout.rep_len_coder, pos_state, len - 2);
      enc.state = enc.state < 7 ? 8 : 11;
      for (uint32_t i = (cached_at == pos + 1 ? 2u : 1u); i < len; i++)
        mf.insert(pos + i);
      pos += len;
    } else if (use_match) {
      enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
      enc.bit(enc.layout.is_rep + enc.state, 0);
      enc.rep[3] = enc.rep[2];
      enc.rep[2] = enc.rep[1];
      enc.rep[1] = enc.rep[0];
      enc.rep[0] = m_dist - 1;
      uint32_t lval = m_len - 2;
      enc.encode_len(enc.layout.len_coder, pos_state, lval);
      enc.state = enc.state < 7 ? 7 : 10;
      enc.encode_distance(lval, m_dist - 1);
      for (uint32_t i = (cached_at == pos + 1 ? 2u : 1u); i < m_len; i++)
        mf.insert(pos + i);
      pos += m_len;
    } else if (best_rep == 0 && rep_len[0] >= 1 && m_len < 2) {
      // short rep (len 1)
      enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 1);
      enc.bit(enc.layout.is_rep + enc.state, 1);
      enc.bit(enc.layout.is_rep_g0 + enc.state, 0);
      enc.bit(enc.layout.is_rep_0long + (size_t(enc.state) << 4) + pos_state,
              0);
      enc.state = enc.state < 7 ? 9 : 11;
      pos += 1;
    } else {
      enc.bit(enc.layout.is_match + (size_t(enc.state) << 4) + pos_state, 0);
      enc.literal(block, pos, pos);
      enc.state = enc.state < 4 ? 0 : (enc.state < 10 ? enc.state - 3
                                                      : enc.state - 6);
      pos += 1;
    }
  }
  enc.rc.finish();
  return std::move(enc.rc.out);
}
}  // extern "C++"

// Compress one dict region (block) into an LZMA2 chunk stream (no 0x00
// terminator). Chunks are 64 KiB unpacked with the dictionary AND the
// probability model carried across chunks (reset_mode 0 continuation;
// only the range coder restarts). Chunks that do not compress are stored
// (control 1/2) with an encoder-state rollback, and the next compressed
// chunk resets state (reset_mode 1) as the spec requires.
extern "C++" {
template <bool kBt>
static void lzma2_compress_block(const uint8_t* data, size_t n, int depth,
                                 int first_block, size_t chunk_size,
                                 int parse_mode, int props, size_t dist_cap,
                                 std::string& out) {
  const size_t kChunk = chunk_size;
  using MF = std::conditional_t<kBt, Bt4MatchFinder, MatchFinder>;
  MF mf = [&] {
    if constexpr (kBt)
      return Bt4MatchFinder(data, n, depth, dist_cap);
    else
      return MatchFinder(data, n, depth);
  }();
  int lc = props % 9, lp = (props / 9) % 5, pb = props / 45;
  LzmaEncoder enc(lc, lp, pb);
  size_t pos = 0;
  // 3 = dict+state+props (stream start), 2 = state+props reset, 1 = state
  // reset (props already in effect), 0 = pure continuation.
  int next_reset = first_block ? 3 : 0;
  bool props_sent = false;
  std::vector<uint16_t> probs_snap;
  while (pos < n) {
    size_t end = pos + kChunk < n ? pos + kChunk : n;
    size_t unpacked = end - pos;

    if (next_reset >= 1) {
      enc.probs.assign(enc.layout.total, 0x400);
      enc.state = 0;
      enc.rep[0] = enc.rep[1] = enc.rep[2] = enc.rep[3] = 0;
    }
    // snapshot for stored-chunk rollback
    probs_snap = enc.probs;
    int state_snap = enc.state;
    uint32_t rep_snap[4] = {enc.rep[0], enc.rep[1], enc.rep[2], enc.rep[3]};

    std::string payload =
        encode_lzma_chunk(data, pos, end, mf, enc, parse_mode, dist_cap);
    if (payload.size() + 6 < unpacked && payload.size() <= 65536) {
      int reset_mode = next_reset;
      uint32_t usz = uint32_t(unpacked - 1);
      out.push_back(char(0x80 | (reset_mode << 5) | int(usz >> 16)));
      out.push_back(char((usz >> 8) & 0xFF));
      out.push_back(char(usz & 0xFF));
      uint32_t psz = uint32_t(payload.size() - 1);
      out.push_back(char((psz >> 8) & 0xFF));
      out.push_back(char(psz & 0xFF));
      if (reset_mode >= 2) {
        out.push_back(char(props));
        props_sent = true;
      }
      out += payload;
      next_reset = 0;
    } else {
      // store; roll encoder state back (the decoder never saw the trial)
      enc.probs = probs_snap;
      enc.state = state_snap;
      enc.rep[0] = rep_snap[0];
      enc.rep[1] = rep_snap[1];
      enc.rep[2] = rep_snap[2];
      enc.rep[3] = rep_snap[3];
      out.push_back(char(next_reset == 3 ? 1 : 2));
      uint32_t usz = uint32_t(unpacked - 1);
      out.push_back(char((usz >> 8) & 0xFF));
      out.push_back(char(usz & 0xFF));
      out.append(reinterpret_cast<const char*>(data + pos), unpacked);
      // the spec requires the next LZMA chunk to reset state; props must
      // be (re)sent if none were emitted yet
      next_reset = props_sent ? 1 : 2;
    }
    pos = end;
  }
}
}  // extern "C++"

// Literal-only LZMA encode body (mirror of encode/dumbencoder.rs:64-123):
// lc=3, lp=0, pb=2 hard-coded like the reference; 8 literal contexts via
// prev_byte >> 5; optional EOS marker. The 13-byte header is written by the
// Python layer. Returns the range-coded payload.
int lrt_lzma_encode_body(const char* data, size_t n, int write_eos,
                         void** out_buf, size_t* out_len) {
  const uint8_t* in = reinterpret_cast<const uint8_t*>(data);
  RangeEncoder rc;
  rc.out.reserve(n + n / 4 + 64);
  std::vector<uint16_t> literal_probs(8 * 0x300, 0x400);
  uint16_t is_match[4] = {0x400, 0x400, 0x400, 0x400};

  uint8_t prev = 0;
  for (size_t i = 0; i < n; i++) {
    rc.encode_bit(&is_match[i & 3], 0);
    uint16_t* probs = &literal_probs[size_t(prev >> 5) * 0x300];
    unsigned result = 1;
    uint8_t byte = in[i];
    for (int k = 7; k >= 0; k--) {
      int bit = (byte >> k) & 1;
      rc.encode_bit(&probs[result], bit);
      result = (result << 1) ^ unsigned(bit);
    }
    prev = byte;
  }

  if (write_eos) {
    // match + dummy len 0 + distance field 0xFFFF_FFFF
    // (dumbencoder.rs:87-123: fresh 0x400 prob per bit)
    size_t pos_state = n & 3;
    rc.encode_bit(&is_match[pos_state], 1);
    uint16_t scratch;
    scratch = 0x400; rc.encode_bit(&scratch, 0);      // is_rep = 0
    for (int i = 0; i < 4; i++) { scratch = 0x400; rc.encode_bit(&scratch, 0); }
    for (int i = 0; i < 6; i++) { scratch = 0x400; rc.encode_bit(&scratch, 1); }
    for (int i = 0; i < 30; i++) { scratch = 0x400; rc.encode_bit(&scratch, 1); }
  }
  rc.finish();
  *out_buf = dup_out(rc.out);
  *out_len = rc.out.size();
  return 0;
}

// Segment-parallel decode: one dict-reset segment = a chunk schedule that
// decodes into a caller-provided flat buffer (offsets segment-relative).
// Thread-safe (no shared mutable state); Python drives one call per worker
// thread, writing disjoint regions of one shared output buffer (ctypes
// releases the GIL around the call).
struct LrtChunk {
  uint64_t in_start;   // absolute offset of chunk payload (rc-init byte)
  uint64_t in_end;
  uint64_t out_start;  // segment-relative
  uint64_t out_end;
  int32_t reset_state;
  int32_t lc, lp, pb;
};

int lrt_lzma2_decode_segment(const char* data, size_t n,
                             const LrtChunk* chunks, int nchunks,
                             char* out, size_t out_cap, char* err_buf) {
  const uint8_t* in = reinterpret_cast<const uint8_t*>(data);
  FlatOut o;
  o.base = reinterpret_cast<uint8_t*>(out);
  o.cap = out_cap;
  DecoderState st;
  st.init(0, 0, 0);
  bool first = true;
  for (int i = 0; i < nchunks; i++) {
    const LrtChunk& c = chunks[i];
    if (c.reset_state || first) {
      st.init(c.lc, c.lp, c.pb);
    } else {
      st.lc = c.lc;  // props can only change with a state reset, but keep
      st.lp = c.lp;  // the schedule authoritative
      st.pb = c.pb;
    }
    first = false;
    o.pos = c.out_start;  // uncompressed chunks were prefilled by the host
    o.len = o.pos;
    st.has_unpacked = true;
    st.unpacked_size = c.out_end;
    if (c.in_end > n || c.in_start > c.in_end) {
      Err e{2, kEofMsg};
      set_err(err_buf, e);
      return e.code;
    }
    RangeDecoder rc{in, size_t(c.in_start), size_t(c.in_end)};
    Err ie;
    if (!rc.init(ie)) {
      Err w{1, std::string("LZMA input too short: ") + ie.msg};
      set_err(err_buf, w);
      return 1;
    }
    Err e;
    if (!st.process_mode(o, rc, false, e)) {
      set_err(err_buf, e);
      return e.code;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Incremental LZMA2 decoding: one complete chunk per call. The Python
// layer parses chunk headers from its input buffer (sizes are in the
// 5/6-byte headers) and feeds full payloads; decoder state (probability
// model, window, reps) persists across calls exactly as in the one-shot
// chunk loop above. This powers the chunk-granular LZMA2/.xz streaming
// API — a capability beyond the reference, which only streams raw LZMA
// (/root/reference/src/decode/stream.rs).
// ---------------------------------------------------------------------------

struct LrtL2Stream {
  DecoderState st;
  OutputBuffer accum;  // accum mode (LzAccumBuffer semantics)
  size_t out_read = 0;
  LrtL2Stream() { st.init(0, 0, 0); }
};

void* lrt_l2stream_new() { return new LrtL2Stream(); }
void lrt_l2stream_delete(void* h) { delete static_cast<LrtL2Stream*>(h); }

// kind: 0 = LZMA chunk (payload = range-coded bytes), 1 = uncompressed.
// reset_mode: LZMA chunks 0..3 per the control byte; uncompressed chunks
// 1 = dict reset (control 0x01), 0 = none (control 0x02).
// props: -1 = keep current, else the raw props byte.
int lrt_l2stream_chunk(void* h, const char* payload, size_t n, int kind,
                       uint64_t unpacked, int reset_mode, int props,
                       char* err_buf) {
  auto* s = static_cast<LrtL2Stream*>(h);
  Err e;
  if (kind == 1) {
    if (reset_mode) s->accum.reset_accum();
    s->accum.buf.insert(s->accum.buf.end(),
                        reinterpret_cast<const uint8_t*>(payload),
                        reinterpret_cast<const uint8_t*>(payload) + n);
    s->accum.len += n;
    return 0;
  }
  if (reset_mode == 3) s->accum.reset_accum();
  if (reset_mode >= 1) {
    int lc = s->st.lc, lp = s->st.lp, pb = s->st.pb;
    if (reset_mode >= 2) {
      if (props < 0 || props >= 225) {
        e = {1, "LZMA2 invalid properties: " + std::to_string(props) +
                    " must be < 225"};
        set_err(err_buf, e);
        return e.code;
      }
      unsigned p = unsigned(props);
      lc = p % 9;
      p /= 9;
      lp = p % 5;
      pb = p / 5;
      if (lc + lp > 4) {
        e = {1, "LZMA2 invalid properties: lc + lp (" + std::to_string(lc) +
                    " + " + std::to_string(lp) + ") must be <= 4"};
        set_err(err_buf, e);
        return e.code;
      }
    }
    s->st.init(lc, lp, pb);
  }
  s->st.has_unpacked = true;
  s->st.unpacked_size = unpacked + s->accum.len;

  RangeDecoder rc{reinterpret_cast<const uint8_t*>(payload), 0, n};
  Err ie;
  if (!rc.init(ie)) {
    Err w{1, std::string("LZMA input too short: ") + ie.msg};
    set_err(err_buf, w);
    return 1;
  }
  if (!s->st.process_mode(s->accum, rc, false, e)) {
    set_err(err_buf, e);
    return e.code;
  }
  return 0;
}

// Drain output produced so far (flushed + live window).
int lrt_l2stream_take_output(void* h, void** buf, size_t* len) {
  auto* s = static_cast<LrtL2Stream*>(h);
  // accum mode: everything lives in out after reset flushes; the live
  // window (buf) holds the current dict region — expose both.
  std::string total = s->accum.out;
  total.append(reinterpret_cast<const char*>(s->accum.buf.data()),
               s->accum.buf.size());
  size_t avail = total.size() - s->out_read;
  char* p = static_cast<char*>(malloc(avail ? avail : 1));
  if (!p) return 1;
  memcpy(p, total.data() + s->out_read, avail);
  s->out_read = total.size();
  *buf = p;
  *len = avail;
  return 0;
}

// ---------------------------------------------------------------------------
// Incremental push-style decoding for the Stream API (stream.rs semantics).
// The Python layer parses the header and creates the run state with the
// initial (range, code); feed() runs Partial mode, finish() runs Finish.
// ---------------------------------------------------------------------------

struct LrtStream {
  DecoderState st;
  OutputBuffer o;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  size_t out_read = 0;  // how much of o.out Python has consumed
};

void* lrt_stream_new(int lc, int lp, int pb, uint64_t dict_size,
                     int has_unpacked, uint64_t unpacked_size, int has_memlimit,
                     uint64_t memlimit, uint32_t range, uint32_t code) {
  auto* s = new LrtStream();
  s->st.init(lc, lp, pb);
  s->st.has_unpacked = has_unpacked != 0;
  s->st.unpacked_size = unpacked_size;
  s->o.circular = true;
  s->o.dict_size = size_t(dict_size);
  if (has_memlimit) s->o.memlimit = memlimit;
  s->range = range;
  s->code = code;
  return s;
}

void lrt_stream_delete(void* h) { delete static_cast<LrtStream*>(h); }

// Returns 0 ok, errcode otherwise. finish_mode: 0 = Partial, 1 = Finish.
// *consumed reports how many input bytes the decoder took (stream.rs
// write() returns input.position(): once a provided unpacked size is
// reached, further bytes are left with the caller — the reference's
// WriteZero condition, tests/lzma.rs:71-88).
int lrt_stream_feed(void* h, const char* data, size_t n, int finish_mode,
                    size_t* consumed, char* err_buf) {
  auto* s = static_cast<LrtStream*>(h);
  RangeDecoder rc{reinterpret_cast<const uint8_t*>(data), 0, n};
  rc.range = s->range;
  rc.code = s->code;
  Err e;
  bool ok = s->st.process_mode(s->o, rc, finish_mode == 0, e);
  s->range = rc.range;
  s->code = rc.code;
  if (consumed) *consumed = rc.pos;
  if (!ok) {
    set_err(err_buf, e);
    return e.code;
  }
  return 0;
}

// Flush remaining window bytes into `out` (used at finish()).
void lrt_stream_finalize(void* h) {
  static_cast<LrtStream*>(h)->o.finish();
}

// Drain newly produced output since the last call.
int lrt_stream_take_output(void* h, void** buf, size_t* len) {
  auto* s = static_cast<LrtStream*>(h);
  size_t avail = s->o.out.size() - s->out_read;
  *len = avail;
  char* p = static_cast<char*>(malloc(avail ? avail : 1));
  if (!p) return 1;
  memcpy(p, s->o.out.data() + s->out_read, avail);
  s->out_read = s->o.out.size();
  *buf = p;
  return 0;
}

uint64_t lrt_stream_output_len(void* h) {
  return static_cast<LrtStream*>(h)->o.out.size();
}

}  // extern "C"
