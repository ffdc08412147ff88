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
//   set where base j matches.  The match bits are then packed to one bit
//   a step, 32 steps a word.  Up to NR = 8 (Lmax <= 128) those words live
//   in registers (one instantiation per NR); above, each lane's NW
//   reference words are staged in dynamic shared memory with cp.async
//   (word i of thread t at [i * blockDim + t]) and turned into step words
//   in place.  There is no global load in the walk.
// - A step is valid for a lane where it is alive and its read active:
//   one interval of p per lane and walk, computed once (an inactive read
//   votes no valid lane, and a step without one changes nothing).
// - The walk goes by events, not by steps.  Over a window of 32 steps each
//   lane holds v (valid) and m (valid & match) for its candidate; over the
//   group's live lanes four reductions (butterflies of warp shuffles) give
//   anyM = OR m, allM = AND m, anyA = OR v, allA = AND v.  The step rule
//   changes the live set only at the event steps E = (anyM & ~allM) |
//   (~anyM & anyA & ~allA); every other step adds its anyM bit to score
//   and its anyA bit to the steps acted on.  So the group adds the popcounts up to and
//   including the first event in walk order (lowest bit forward, highest
//   bit left), takes the event's live set (the live lanes that match
//   there if any does, else the valid ones) by one ballot, and reduces
//   again from the next step.  Each event removes a lane, so a walk has at
//   most C - 1 of them.  A group down to one live lane meets no more
//   events: that lane counts its steps left in closed form (a popcount a
//   32 steps), so a read with one live candidate, the common case, walks
//   no window at all.  The loops are warp-uniform (each group keeps its
//   own position), so the warp's ballots and shuffles stay converged.

#ifndef NIMBLE_SPAN_WALK_CUH_
#define NIMBLE_SPAN_WALK_CUH_

#include <cstdint>

#include <cuda_runtime.h>

namespace nimble_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegWords = 8;  // NR above this stages in shared memory
constexpr size_t kDefaultSmem = 48 * 1024;

// The tables the walk reads, single or stacked on a leading library axis.
// The callers' hosts check that L * n_rows and L * n_words lie below 2^31.
struct WalkTables {
  const int32_t* row_starts;   // (L, n_rows)
  const int32_t* row_lengths;  // (L, n_rows)
  const uint32_t* ref;         // (L, n_words) 2-bit packed, 16 bases a word
  int n_rows;
  int n_words;
  int Lmax, k, ref_pad;
};

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bits 2j set where base j of the phase-aligned reference word equals base
// j of the read word.
__device__ __forceinline__ uint32_t match_word(uint32_t lo, uint32_t hi,
                                               unsigned sh, uint32_t rw) {
  const uint32_t x = __funnelshift_r(lo, hi, sh) ^ rw;
  return ~(x | (x >> 1)) & 0x55555555u;
}

// The 16 even bits of w (bit 2j) as bits j.
__device__ __forceinline__ uint32_t even_bits(uint32_t w) {
  w &= 0x55555555u;
  w = (w | (w >> 1)) & 0x33333333u;
  w = (w | (w >> 2)) & 0x0F0F0F0Fu;
  w = (w | (w >> 4)) & 0x00FF00FFu;
  return (w | (w >> 8)) & 0x0000FFFFu;
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

// Bits j < n (n clamped to 0..32).
__device__ __forceinline__ uint32_t bits_below(int n) {
  return n <= 0 ? 0u : (n >= 32 ? ~0u : (1u << n) - 1u);
}

// Bit j set where step base + j lies in [lo, hi).
__device__ __forceinline__ uint32_t range_bits(int base, int lo, int hi) {
  return bits_below(hi - base) & ~bits_below(lo - base);
}

// The match bits of steps base..base+31 from the NQ step words of steps
// 0..32*NQ-1 (bits of steps outside them are 0; base may be negative).
// The words are picked by selects, not indexed, so they stay in registers.
template <int NQ>
__device__ __forceinline__ uint32_t steps_at(const uint32_t (&st)[NQ],
                                             int base) {
  const int q = base >> 5;  // rounds down
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    lo = i == q ? st[i] : lo;
    hi = i == q + 1 ? st[i] : hi;
  }
  return __funnelshift_r(lo, hi, static_cast<unsigned>(base & 31));
}

struct Lane {
  unsigned live;  // the group's live lanes, at their warp positions
  int score, acts;  // matched steps; steps with a live, valid lane (mm is
                    // acts - score)
};

// One window of 32 steps for the group of G lanes: v and m are this
// lane's valid and valid & match bits (0 unless its group walks and it is
// live); bit j is step base + j in either direction.  Adds the steps up to
// and including the window's first event in walk order (the lowest bit
// forward, the highest when LEFT) to score and acts and, at the event,
// sets the live lanes.  Returns the event's bit, or -1 without one.  Every
// lane of the warp calls it.  The group's OR and AND are butterflies of
// whole-warp shuffles within the group (redux.sync on each group's mask
// measured slower: PERF.md section 6).
template <bool LEFT>
__device__ __forceinline__ int walk_window(Lane& s, bool go, uint32_t v,
                                           uint32_t m, unsigned gmask,
                                           int lane, int G) {
  const bool me = (s.live >> lane) & 1u;
  uint32_t any_m = me ? m : 0u, all_m = me ? m : ~0u;
  uint32_t any_a = me ? v : 0u, all_a = me ? v : ~0u;
  for (int d = 1; d < G; d <<= 1) {
    any_m |= __shfl_xor_sync(kFull, any_m, d);
    all_m &= __shfl_xor_sync(kFull, all_m, d);
    any_a |= __shfl_xor_sync(kFull, any_a, d);
    all_a &= __shfl_xor_sync(kFull, all_a, d);
  }
  const uint32_t ev =
      go ? (any_m & ~all_m) | (~any_m & any_a & ~all_a) : 0u;
  const int e = ev == 0u ? -1 : (LEFT ? 31 - __clz(ev) : __ffs(ev) - 1);
  const uint32_t upto =
      e < 0 ? ~0u : (LEFT ? ~0u << e : (2u << e) - 1u);  // 2u << 31 == 0
  if (go) {
    s.score += __popc(any_m & upto);
    s.acts += __popc(any_a & upto);
  }
  const int at = e < 0 ? 0 : e;
  const uint32_t pick = (any_m >> at) & 1u ? m : v;
  const unsigned keep =
      __ballot_sync(kFull, e >= 0 && ((pick >> at) & 1u)) & gmask;
  if (e >= 0) s.live = keep;
  return e;
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
                                           int anc, int lib, int row_in_lib,
                                           int off, bool live0,
                                           unsigned gmask, uint32_t* sw) {
  const int lane = threadIdx.x & 31;
  const int nr = NR > 0 ? NR : (t.Lmax + 15) >> 4;
  const int nq = (nr + 1) >> 1;  // step words of 32 steps
  const RowWords row_words(prow, (t.Lmax + 3) >> 2);
  const int row = lib * t.n_rows + row_in_lib;
  const int base = off - anc;
  const int start = __ldg(t.row_starts + row) + base + t.ref_pad;
  const unsigned sh = 2u * static_cast<unsigned>(start & 15);
  const int w0 = clamp_int(start >> 4, 0, t.n_words - (nr + 1));
  const uint32_t* win = t.ref + lib * t.n_words + w0;

  // Each walk's valid steps, alive and active, as one interval of p per
  // lane.  Forward: alive while p < row_len - base, active for
  // anchor + k <= p < read_len.  Left (p <= P - 2, P = Lmax - k + 1):
  // alive while p >= -base, active for p < anchor.  f_lo and l_hi are the
  // same in every lane of a read.
  const int P = t.Lmax - t.k + 1;
  const int f_lo = clamp_int(anc + t.k, t.k, t.Lmax);
  const int f_hi = min(clamp_int(__ldg(t.row_lengths + row) - base, -1,
                                 t.Lmax),
                       min(read_len, t.Lmax));
  const int l_lo = clamp_int(-base, 0, t.Lmax);
  const int l_hi = clamp_int(anc, 0, P - 1);  // exclusive

  uint32_t st[NR > 0 ? (NR + 1) / 2 : 1];
  if constexpr (NR > 0) {
    uint32_t rw[NR + 1];  // the row's aligned words, each loaded once
#pragma unroll
    for (int j = 0; j <= NR; ++j) rw[j] = row_words.aligned_word(j);
    uint32_t wd[NR + 1];
#pragma unroll
    for (int i = 0; i <= NR; ++i) wd[i] = __ldg(win + i);
#pragma unroll
    for (int i = 0; i < (NR + 1) / 2; ++i) {
      const uint32_t a = match_word(wd[2 * i], wd[2 * i + 1], sh,
                                    row_words.join(rw[2 * i], rw[2 * i + 1]));
      const uint32_t b =
          2 * i + 1 < NR
              ? match_word(wd[2 * i + 1], wd[min(2 * i + 2, NR)], sh,
                           row_words.join(rw[2 * i + 1],
                                          rw[min(2 * i + 2, NR)]))
              : 0u;
      st[i] = even_bits(a) | (even_bits(b) << 16);
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
    // in place: step word j from match words 2j and 2j + 1 (j <= 2j)
    for (int j = 0; j < nq; ++j) {
      const uint32_t b =
          2 * j + 1 < nr ? even_bits(sw[(2 * j + 1) * blockDim.x]) : 0u;
      sw[j * blockDim.x] = even_bits(sw[2 * j * blockDim.x]) | (b << 16);
    }
  }
  // the match bits of steps b..b+31 (0 outside 0..32*nq-1)
  const auto step_bits = [&](int b) -> uint32_t {
    if constexpr (NR > 0) {
      return steps_at(st, b);
    } else {
      const int q = b >> 5;  // rounds down
      const uint32_t lo = q >= 0 && q < nq ? sw[q * blockDim.x] : 0u;
      const uint32_t hi =
          q + 1 >= 0 && q + 1 < nq ? sw[(q + 1) * blockDim.x] : 0u;
      return __funnelshift_r(lo, hi, static_cast<unsigned>(b & 31));
    }
  };

  Lane s;
  s.live = __ballot_sync(kFull, live0) & gmask;
  s.score = 0;
  s.acts = 0;
  // the group walks the union of the valid intervals of its lanes that
  // start live (a lane not live at the start never becomes live, and a
  // step where no live lane is valid changes nothing)
  const int G = __popc(gmask);
  int f_end = live0 && f_lo < f_hi ? f_hi : 0;
  int l_beg = live0 && l_lo < l_hi ? l_lo : t.Lmax;
  for (int d = 1; d < G; d <<= 1) {
    f_end = max(f_end, __shfl_xor_sync(kFull, f_end, d));
    l_beg = min(l_beg, __shfl_xor_sync(kFull, l_beg, d));
  }

  // the steps left: forward from cur up, then left from top down
  int cur = f_lo, top = l_hi - 1;
  // A group with one live lane meets no event: that lane adds its steps
  // left in closed form, and the group's walk ends (the counts reach the
  // group's other lanes by one shuffle at the end)
  int own_score = 0, own_acts = 0;
  const auto close_if_one = [&]() {
    if (__popc(s.live) != 1 || (cur >= f_end && top < l_beg)) return;
    if ((s.live >> lane) & 1u) {
      for (int b = cur; b < f_hi; b += 32) {
        const uint32_t v = range_bits(b, cur, f_hi);
        own_score += __popc(v & step_bits(b));
        own_acts += __popc(v);
      }
      const int l_end = min(l_hi, top + 1);
      for (int b = l_lo; b < l_end; b += 32) {
        const uint32_t v = range_bits(b, l_lo, l_end);
        own_score += __popc(v & step_bits(b));
        own_acts += __popc(v);
      }
    }
    cur = max(cur, f_end);
    top = min(top, l_beg - 1);
  };
  close_if_one();
  // forward: windows from f_lo up; the next starts after an event
#pragma unroll 1
  while (__any_sync(kFull, cur < f_end)) {
    const bool go = cur < f_end;
    const bool me = go && ((s.live >> lane) & 1u);
    const uint32_t v = me ? range_bits(cur, f_lo, f_hi) : 0u;
    const int e = walk_window<false>(s, go, v, v & step_bits(cur), gmask,
                                     lane, G);
    cur = !go ? cur : (e < 0 ? cur + 32 : cur + e + 1);
    close_if_one();
  }
  // left: windows from l_hi - 1 down (bit j: step top - 31 + j)
#pragma unroll 1
  while (__any_sync(kFull, top >= l_beg)) {
    const bool go = top >= l_beg;
    const int b = top - 31;
    const bool me = go && ((s.live >> lane) & 1u);
    const uint32_t v = me ? range_bits(b, l_lo, l_hi) : 0u;
    const int e =
        walk_window<true>(s, go, v, v & step_bits(b), gmask, lane, G);
    top = !go ? top : (e < 0 ? b - 1 : b + e - 1);
    close_if_one();
  }
  const int src = s.live != 0u ? __ffs(s.live) - 1 : lane;
  s.score += __shfl_sync(kFull, own_score, src);
  s.acts += __shfl_sync(kFull, own_acts, src);
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
