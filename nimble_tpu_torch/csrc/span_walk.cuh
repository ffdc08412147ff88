// span_walk.cuh: the candidate span-walk of nimble_tpu_torch as a device
// function, shared by csrc/fused_span_walk.cu (the walk alone, the mesh's
// shard step) and csrc/probe_walk_filter.cu (probe, candidates, walk and
// filter in one launch).  Header only; every function is inline.
//
// walk_lanes<NR> is the walk of one read's candidates on a power-of-two
// group of warp lanes, one lane per candidate, bit for bit the walk of
// gather_span_words + fused_span_walk_plain (nimble_tpu_torch/ops/
// span_walk.py): per candidate
//   start = row_starts[lib, row] + off - anchor + ref_pad
//   w0 = clamp(start >> 4, 0, n_words - NW),  phase = start & 15
// with NW = NR + 1 words (NR = ceil(Lmax/16)) and n_words the (padded)
// extent of ref_codes_packed's last axis; then the lockstep walk forward
// over p = k..Lmax-1, then left over p = P-2..0 (P = Lmax-k+1), with
// base = off - anchor:
//   forward: alive = base + p <  r_len,  active = anchor+k <= p < read_len
//   left:    alive = base + p >= 0,      active = p < anchor
//   step:    la = live & alive; lm = la & match
//            if active & any(la) & any(lm): live = lm, score += 1
//            elif active & any(la):         live = la, mm += 1
//
// Design (what bounds the walk is latency, not bytes: see
// fused_span_walk.cu).
// - Each lane computes its candidate's window and loads it once: no
//   (B, C, NW) words tensor exists.
// - 16 bases per compare: the read's packed row (base j at bits 2*(j%4) of
//   byte j/4) is loaded once, as 32-bit words from the 4-byte boundary at
//   or before it, and funnel-shifted into read words (RowWords, which the
//   probe of probe_walk_filter.cu takes its keys from too); each
//   phase-aligned reference word (__funnelshift_r, defined at phase 0) is
//   XORed with the read word and ~(x | x >> 1) & 0x55555555 leaves bit 2j
//   set where base j matches.  There is no global load in the step loop.
//   Up to NR = 8 (Lmax <= 128) the match words live in registers (one
//   instantiation per NR); above, each lane's NW reference words are
//   staged in dynamic shared memory with cp.async (word i of thread t at
//   [i * blockDim + t]) and turned into match words in place.
// - The chain: a step is valid for a lane where it is alive and its read
//   active, one interval of p per lane and walk, computed once.  Folding
//   active into the votes keeps the result: an inactive read votes no
//   valid lane, and a step without one changes nothing.  For each 16 steps
//   the lane builds one word, valid at odd bits and valid & match at even
//   bits; the 16 steps are unrolled, and a step is two votes on fixed bits
//   of that word (off the chain: they do not depend on live), then
//   la = live & A and lm = live & M with two predicated moves.  The group's
//   live lanes are one mask held by each lane of the group; score and the
//   steps with a live valid lane are kept as bits per chunk and counted
//   once (mm is their difference).  The warp walks the union of the valid
//   intervals of its lanes that start live, in chunks from the union's
//   first step (forward) or last step (left), so no more than 15 steps a
//   walk are spare.

#ifndef NIMBLE_SPAN_WALK_CUH_
#define NIMBLE_SPAN_WALK_CUH_

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace nimble_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegWords = 8;  // NR above this stages in shared memory
constexpr size_t kDefaultSmem = 48 * 1024;

// The tables the walk reads, single or stacked on a leading library axis.
struct WalkTables {
  const int32_t* row_starts;   // (L, n_rows)
  const int32_t* row_lengths;  // (L, n_rows)
  const uint32_t* ref;         // (L, n_words) 2-bit packed, 16 bases a word
  int64_t n_rows;
  int64_t n_words;
  int Lmax, k, ref_pad;
};

__device__ __forceinline__ int clamp_int(int64_t v, int lo, int hi) {
  return static_cast<int>(v < lo ? lo : (v > hi ? hi : v));
}

// Bits 2j set where base j of the phase-aligned reference word equals base
// j of the read word.
__device__ __forceinline__ uint32_t match_word(uint32_t lo, uint32_t hi,
                                               unsigned sh, uint32_t rw) {
  const uint32_t x = __funnelshift_r(lo, hi, sh) ^ rw;
  return ~(x | (x >> 1)) & 0x55555555u;
}

// A packed row's bases (base j at bits 2*(j%4) of byte j/4) as 16-base
// read words, loaded as 32-bit words from the 4-byte boundary at or before
// the row: each such word holds a byte of the row, so it lies in the
// tensor's allocation (4-byte granular).  Aligned words past the nb base
// bytes read as 0; the bytes past nb within the last one (the length, or
// the next row) only meet bases >= Lmax, which no step or key reads.
struct RowWords {
  const uint32_t* aligned;
  int lead, nb;

  __device__ __forceinline__ RowWords(const uint8_t* prow, int nb_)
      : aligned(reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uint64_t>(prow) & ~3ull)),
        lead(static_cast<int>(reinterpret_cast<uint64_t>(prow) & 3)),
        nb(nb_) {}

  __device__ __forceinline__ uint32_t aligned_word(int j) const {
    return 4 * j < lead + nb ? __ldg(aligned + j) : 0u;
  }
  // read word i (bases 16i..16i+15) from aligned words i and i + 1
  __device__ __forceinline__ uint32_t join(uint32_t lo, uint32_t hi) const {
    return __funnelshift_r(lo, hi, 8u * static_cast<unsigned>(lead));
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    return join(aligned_word(i), aligned_word(i + 1));
  }
  // bases p..p+15, base p at bits 0-1
  __device__ __forceinline__ uint32_t window(int p) const {
    const int q = p >> 4;
    return __funnelshift_r(word(q), word(q + 1),
                           2u * static_cast<unsigned>(p & 15));
  }
};

// Even bits 2j of the steps j < n of a 16-step chunk (n clamped to 0..16).
__device__ __forceinline__ uint32_t steps_below(int n) {
  n = min(max(n, 0), 16);
  return n == 16 ? 0x55555555u : ((1u << (2 * n)) - 1u) & 0x55555555u;
}

// The lane's word for the 16 steps p = base..base+15 of one walk: bit 2j+1
// set where step base+j is valid (alive and its read active: lo <= p < hi),
// bit 2j where it is valid and the bases match (m: match bits of those
// steps, from match_word).
__device__ __forceinline__ uint32_t chunk_word(uint32_t m, int base, int lo,
                                               int hi) {
  const uint32_t v = steps_below(hi - base) & ~steps_below(lo - base);
  return (v << 1) | (v & m);
}

// The match bits of steps base..base+15 from the NR match words of steps
// 0..16*NR-1 (bits of steps outside them are 0; base may be negative).  The
// words are picked by selects, not indexed, so they stay in registers.
template <int NR>
__device__ __forceinline__ uint32_t match_at(const uint32_t (&mw)[NR],
                                             int base) {
  const int q = base >> 4;  // rounds down
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    lo = i == q ? mw[i] : lo;
    hi = i == q + 1 ? mw[i] : hi;
  }
  return __funnelshift_r(lo, hi, 2u * static_cast<unsigned>(base & 15));
}

struct Lane {
  unsigned live;  // the group's live lanes, at their warp positions
  int score, acts;  // matched steps; steps with a live, valid lane (mm is
                    // acts - score)
};

// Step T of a chunk, on bit pair J of the chunk word w: the votes of valid
// (bit 2J+1) and valid & match (bit 2J), then la = live & A, lm = live & M;
// if la != 0: live = la, acted |= 1 << T; if lm != 0: live = lm,
// matched |= 1 << T (lm is within la).  In PTX so that each bit test is one
// instruction with its mask as an immediate.
template <int J, int T>
__device__ __forceinline__ void chunk_step(unsigned& live, unsigned& matched,
                                           unsigned& acted, uint32_t w) {
  asm volatile(
      "{\n\t"
      ".reg .pred pv, pm, pa, pl;\n\t"
      ".reg .b32 a, m;\n\t"
      "and.b32 a, %3, %4;\n\t"
      "setp.ne.u32 pv, a, 0;\n\t"
      "and.b32 m, %3, %5;\n\t"
      "setp.ne.u32 pm, m, 0;\n\t"
      "vote.sync.ballot.b32 a, pv, 0xffffffff;\n\t"
      "vote.sync.ballot.b32 m, pm, 0xffffffff;\n\t"
      "and.b32 a, a, %0;\n\t"
      "and.b32 m, m, %0;\n\t"
      "setp.ne.u32 pa, a, 0;\n\t"
      "setp.ne.u32 pl, m, 0;\n\t"
      "@pa mov.b32 %0, a;\n\t"
      "@pl mov.b32 %0, m;\n\t"
      "@pa or.b32 %2, %2, %6;\n\t"
      "@pl or.b32 %1, %1, %6;\n\t"
      "}"
      : "+r"(live), "+r"(matched), "+r"(acted)
      : "r"(w), "n"(2u << (2 * J)), "n"(1u << (2 * J)), "n"(1u << T));
}

template <bool DESC, int... T>
__device__ __forceinline__ void chunk_steps(Lane& s, uint32_t w,
                                            std::integer_sequence<int, T...>) {
  unsigned matched = 0u, acted = 0u;
  (chunk_step<DESC ? 15 - T : T, T>(s.live, matched, acted, w), ...);
  s.score += __popc(matched);
  s.acts += __popc(acted);
}

// The 16 steps of a chunk word, j = 0..15 (or 15..0 when DESC).
template <bool DESC>
__device__ __forceinline__ void walk_chunk(Lane& s, uint32_t w) {
  chunk_steps<DESC>(s, w, std::make_integer_sequence<int, 16>{});
}

// The walk of one candidate per lane; every lane of the warp must call it
// (it votes over the whole warp).  prow: the read's packed row
// (ceil(Lmax/4) bytes of bases, then the uint16 length read_len); anchor,
// lib, row (the candidate's row id within library lib) and off (its anchor
// offset in the row) must address the tables for every lane, live0 is
// false for a lane without a candidate; gmask: the lanes of this read's
// group.  NR > 0: NR = ceil(Lmax/16) match words in registers.  NR == 0:
// ceil(Lmax/16) + 1 words per thread of dynamic shared memory, this
// thread's column at sw (word i at sw[i * blockDim.x]).  Returns the
// group's live lanes, score and steps acted on, the same in every lane of
// the group.
template <int NR>
__device__ __forceinline__ Lane walk_lanes(const WalkTables& t,
                                           const uint8_t* prow, int read_len,
                                           int64_t anc, int64_t lib,
                                           int64_t row_in_lib, int64_t off,
                                           bool live0, unsigned gmask,
                                           uint32_t* sw) {
  const int nr = NR > 0 ? NR : (t.Lmax + 15) >> 4;
  const RowWords row_words(prow, (t.Lmax + 3) >> 2);
  const int64_t row = lib * t.n_rows + row_in_lib;
  const int64_t base = off - anc;
  const int64_t start = __ldg(t.row_starts + row) + base + t.ref_pad;
  const unsigned sh = 2u * static_cast<unsigned>(start & 15);
  int64_t w0 = start >> 4;
  const int64_t w_max = t.n_words - (nr + 1);
  w0 = w0 < 0 ? 0 : (w0 > w_max ? w_max : w0);
  const uint32_t* win = t.ref + lib * t.n_words + w0;

  // Each walk's valid steps, alive and active, as one interval of p per
  // lane.  Forward: alive while p < row_len - base, active for
  // anchor + k <= p < read_len.  Left (p <= P - 2, P = Lmax - k + 1):
  // alive while p >= -base, active for p < anchor.
  const int P = t.Lmax - t.k + 1;
  const int f_lo = clamp_int(anc + t.k, t.k, t.Lmax);
  const int f_hi = min(clamp_int(__ldg(t.row_lengths + row) - base, -1,
                                 t.Lmax),
                       min(read_len, t.Lmax));
  const int l_lo = clamp_int(-base, 0, t.Lmax);
  const int l_hi = clamp_int(anc, 0, P - 1);  // exclusive

  uint32_t mw[NR > 0 ? NR : 1];
  if constexpr (NR > 0) {
    uint32_t rw[NR + 1];  // the row's aligned words, each loaded once
#pragma unroll
    for (int j = 0; j <= NR; ++j) rw[j] = row_words.aligned_word(j);
    uint32_t lo = __ldg(win);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const uint32_t hi = __ldg(win + i + 1);
      mw[i] = match_word(lo, hi, sh, row_words.join(rw[i], rw[i + 1]));
      lo = hi;
    }
  } else {
    for (int i = 0; i <= nr; ++i) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(sw + i * blockDim.x));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(win + i));
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    for (int i = 0; i < nr; ++i) {
      sw[i * blockDim.x] =
          match_word(sw[i * blockDim.x], sw[(i + 1) * blockDim.x], sh,
                     row_words.word(i));
    }
  }

  Lane s;
  s.live = __ballot_sync(kFull, live0) & gmask;
  s.score = 0;
  s.acts = 0;
  // the warp walks the union of the valid intervals of its live lanes: a
  // lane not live at the start never votes live, and a step where no live
  // lane of the warp is valid is a no-op
  const bool fw = live0 && f_lo < f_hi;
  const bool lw = live0 && l_lo < l_hi;
  const int wf_lo = __reduce_min_sync(kFull, fw ? f_lo : t.Lmax);
  const int wf_hi = __reduce_max_sync(kFull, fw ? f_hi : 0);
  const int wl_lo = __reduce_min_sync(kFull, lw ? l_lo : t.Lmax);
  const int wl_hi = __reduce_max_sync(kFull, lw ? l_hi : 0);

  // the match bits of steps base..base+15 (0 outside 0..16*nr-1)
  const auto match_bits = [&](int b) -> uint32_t {
    if constexpr (NR > 0) {
      return match_at(mw, b);
    } else {
      const int q = b >> 4;  // rounds down
      const uint32_t lo = q >= 0 && q < nr ? sw[q * blockDim.x] : 0u;
      const uint32_t hi = q + 1 >= 0 && q + 1 < nr ? sw[(q + 1) * blockDim.x]
                                                    : 0u;
      return __funnelshift_r(lo, hi, 2u * static_cast<unsigned>(b & 15));
    }
  };
  // chunks of 16 steps from the warp's first valid forward step up, then
  // from its last valid left step down
#pragma unroll 1
  for (int b = wf_lo; b < wf_hi; b += 16)
    walk_chunk<false>(s, chunk_word(match_bits(b), b, f_lo, f_hi));
#pragma unroll 1
  for (int b = wl_hi - 16; b + 16 > wl_lo; b -= 16)
    walk_chunk<true>(s, chunk_word(match_bits(b), b, l_lo, l_hi));
  return s;
}

// The lanes of the group of 2^gbits lanes that holds this lane.
__device__ __forceinline__ unsigned group_mask(int lane, int gbits) {
  return gbits == 5 ? kFull
                    : ((1u << (1 << gbits)) - 1u) << ((lane >> gbits) << gbits);
}

// Allows a kernel `smem` bytes of dynamic shared memory: above the default
// 48 KB through the opt-in attribute, set to the device's maximum every
// time (idempotent across host threads); cudaErrorInvalidValue when even
// that is too little.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

}  // namespace nimble_walk

#endif  // NIMBLE_SPAN_WALK_CUH_
