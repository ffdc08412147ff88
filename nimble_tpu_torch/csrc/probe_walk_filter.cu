// probe_walk_filter.cu: the whole device pass of nimble_tpu_torch in one
// launch, for Hopper (sm_90a): unpack, anchor probe, candidate gather, span
// walk and filter + pack.  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/probe_walk.py
// (probe_walk), which checks the tables once per tables object, passes
// them as one argument block (ProbeTables, probe_walk_tables.h) and checks
// the packed rows on every call.
//
// Replaces the device program of nimble_tpu/ops/engine_fast.py,
// probe_walk_filter_packed_chunked (:1146, body _probe_walk_filter_impl)
// and probe_walk_full_packed_chunked (:1215, body _probe_walk_full_impl):
// the XLA probe (_probe_bucketed), the postings gather, the TPU kernel
// nimble_tpu/ops/pallas_fused.py pallas_fused_span_walk with its word
// gather, and the XLA distinct / gate / pack epilogue, one jit per launch
// there.  Its plain version is the torch chain of ops/compact.py and
// ops/full.py (probe_walk_filter_plain, probe_walk_full_plain), bit for
// bit.  Per read b of a launch (packed row b % B0, library b / B0: the B0
// packed rows served against every stacked library, library major):
// 1. unpack: bases from the packed row (base j at bits 2*(j%4) of byte
//    j/4), read_len from its trailing uint16;
// 2. probe: for positions p < min(Lmax - k + 1, read_len - k + 1), the key
//    halves hi = bases [p, p + k/2), lo = [p + k/2, p + k) (first base most
//    significant), h = fmix32(lo ^ fmix32(hi)) & (n_buckets - 1) and the
//    fingerprint fp = fmix32(rot16(hi) ^ fmix32(lo ^ FP_SALT)); for
//    hop < max_probe the W lanes of bkey_fp[lib, (h + hop) & mask].  The
//    anchor is the first position with any lane hit; at it the first hop
//    with a hit, and in that hop the lowest lane.  Only that lane's
//    bkey_lo / bkey_hi are verified; a mismatch (a fingerprint collision)
//    sets needs_host and nothing more is searched.  Without a hit the
//    anchor, bucket and lane are 0;
// 3. candidates: astart = bstart[lib, bucket, lane], acnt = has_anchor ?
//    bcount[...] : 0; candidate c < C is postings_row / postings_off[lib,
//    clamp(astart + c, 0, n_postings - 1)], live while c < min(acnt, C);
//    needs_host |= has_anchor & acnt > C;
// 4. the walk of csrc/span_walk.cuh (nimble_walk::walk_lanes);
// 5. score = has_anchor ? walk score + k : 0, mm likewise; distinct = the
//    live lanes whose row no earlier live lane holds; mask = the live lanes
//    as bits.  Compact mode writes (B, 2) int32: astart, mask |
//    passed & !needs_host << 16 | needs_host << 17 | has_anchor << 18 with
//    passed = has_anchor & score >= threshold & score >= s_min[lib,
//    clamp(read_len)] & mm <= mismatches & (distinct <= 1 | !discard
//    multiple) & (mm == 0 | !discard nonzero), the gates per library when
//    stacked.  Full mode writes (B, 3): astart, mask | has_anchor << 16 |
//    needs_host << 17, score << 16 | mm.
//
// What bounds it on the H100.  Not bytes: a read at Lmax = 92 reads its
// 25-byte row, one 32-byte fingerprint row per hop and position probed
// (one, for a read that anchors at position 0), two key words, the
// postings of its C candidates, their row spans and reference windows,
// and writes 8 or 12 bytes: under 2 MB for an 8192-read launch, well under
// a microsecond at 3.35 TB/s, and below the time of an empty launch of the
// same grid.  Not operations either: ~40 32-bit operations a key, a few
// per walk window.  What remains is latency: a chain of dependent loads
// (row -> fingerprint row -> slot -> postings -> row start -> reference
// words), then the walk.  PERF.md section 6 has the times and the split
// into phases.
//
// Design.
// - A read owns a power-of-two group of G >= 8 lanes (G = 8 at C <= 8, so
//   4 reads per warp).  The grid is (blocks per library, L): the library
//   is blockIdx.y, so no thread divides.  Every index is 32-bit (the host
//   checks every table's extent and B * row width against 2^31).
// - The probe takes G positions a round, lane j position round * G + j,
//   each building its key straight from the packed row's words (two
//   16-base windows of span_walk.cuh's RowWords, bit-reversed to
//   first-base-most-significant).  A lane loads a hop's bucket row as
//   16-byte vectors (ld.global.nc.v4.u32; W = 8 is two), both issued
//   before its first compare, compares in registers and takes the lowest
//   lane by a bit scan; the next hop's row only after a hop without a hit
//   (issuing every hop's row at once doubled the rows read at max_probe 2
//   and measured slower: PERF.md section 6).  The group's ballot
//   takes the round's first hitting position (its lowest lane); that lane
//   issues its slot's key halves, bstart and bcount right after the
//   ballot and compares the key only after the rounds, and the shuffles
//   bring its loaded values, so the chain waits for no trip to the slot
//   behind the shuffles.  (Every hitting lane loading its slot at its
//   compare, one ballot earlier, crowded a table beyond L2 with eight
//   lanes' loads a read and measured slower.)  Only the winner's key is
//   verified: a mismatch sets needs_host and nothing more is searched.  The rounds are warp-uniform
//   (every lane votes every round) until no group of the warp searches.
// - Lane c then loads candidate c (lanes c >= C load a valid posting and
//   stay dead), and the group walks as in fused_span_walk.cu: the event
//   walk of span_walk.cuh.
// - The epilogue counts distinct rows with one shuffle per group lane and
//   a ballot; lane 0 of the group gates and writes the row.
// - The walk's register / shared-memory split is kept: NR <= 8 in
//   registers with 64-thread blocks, above in dynamic shared memory with
//   256-thread blocks (reads up to 1024 bp).

#include <cstdint>

#include <cuda_runtime.h>

#include "probe_walk_tables.h"
#include "span_walk.cuh"

namespace {

using nimble_walk::kFull;
using nimble_walk::kMaxRegWords;
using nimble_walk::Lane;
using nimble_walk::WalkTables;

constexpr int kRegThreads = 64;
constexpr int kSmemThreads = 256;
constexpr int kProbeVecs = 2;  // 16-byte row loads in flight a batch
constexpr uint32_t kFpSalt = 0x7FEB352Du;  // ops/device_index.FP_SALT

struct ProbeArgs {
  ProbeTables tab;
  const uint8_t* packed;  // (B0, ceil(Lmax/4) + 2)
  int32_t* out;           // (L * B0, 2) compact or (L * B0, 3) full
  int B0, C, gbits;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The n <= 16 bases of a 16-base window (base i at bits 2i) as a key half,
// the first base most significant.
__device__ __forceinline__ uint32_t key_half(uint32_t window, int n) {
  uint32_t r = __brev(window);  // base i at bits 31-2i, 30-2i, swapped
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return n == 16 ? r : r >> (2 * (16 - n));
}

// Bit j set where word j of the 16-byte vector equals fp.
__device__ __forceinline__ unsigned hits4(const uint4& r, uint32_t fp) {
  return static_cast<unsigned>(r.x == fp) |
         (static_cast<unsigned>(r.y == fp) << 1) |
         (static_cast<unsigned>(r.z == fp) << 2) |
         (static_cast<unsigned>(r.w == fp) << 3);
}

template <int NR>
__global__ void probe_walk_filter_kernel(const ProbeArgs a) {
  extern __shared__ uint32_t smem[];
  const ProbeTables& tb = a.tab;
  const int lane = threadIdx.x & 31;
  const int G = 1 << a.gbits;
  const int group_base = (lane >> a.gbits) << a.gbits;
  const int c = lane - group_base;
  const int lib = blockIdx.y;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int first_row = warp << (5 - a.gbits);  // of this library's B0
  if (first_row >= a.B0) return;  // the whole warp lies past the batch
  const int r = first_row + (lane >> a.gbits);
  const bool read_ok = r < a.B0;
  const int b = lib * a.B0 + (read_ok ? r : 0);  // the result row
  const unsigned gmask = nimble_walk::group_mask(lane, a.gbits);
  const WalkTables t{tb.row_starts, tb.row_lengths, tb.ref, tb.n_rows,
                     tb.n_words, tb.Lmax, tb.k, tb.ref_pad};
  const int nb = (tb.Lmax + 3) >> 2;
  // lanes past the batch read row 0 and stay dead
  const uint8_t* prow = a.packed + (read_ok ? r : 0) * (nb + 2);
  const int read_len = __ldg(prow + nb) | (__ldg(prow + nb + 1) << 8);
  const nimble_walk::RowWords rw(prow, nb);
  const int lib_bucket0 = lib * tb.n_buckets;  // the library's first row
  // astart of a read without an anchor: slot (bucket 0, lane 0)
  const int32_t astart0 = __ldg(tb.bstart + lib_bucket0 * tb.W);

  // --- probe: G positions a round until the group's first hit
  const int k = tb.k;
  const int half = k >> 1;
  const int npos = read_ok ? min(tb.Lmax - k + 1, read_len - k + 1) : 0;
  const uint32_t mask = static_cast<uint32_t>(tb.n_buckets - 1);
  const int vph = tb.W >> 2;  // 16-byte vectors a bucket row
  bool found = false;
  unsigned winners = 0u;
  int my_p = 0, my_slot = 0, my_start = 0, my_cnt = 0;
  uint32_t my_lo = 0u, my_hi = 0u, my_klo = 0u, my_khi = 0u;
  for (int round = 0; __any_sync(kFull, !found && round < npos);
       round += G) {
    const int p = round + c;
    bool hit = false;
    if (!found && p < npos) {
      const uint32_t hi = key_half(rw.window(p), half);
      const uint32_t lo = key_half(rw.window(p + half), k - half);
      const uint32_t h = fmix32(lo ^ fmix32(hi));
      const uint32_t fp =
          fmix32(__funnelshift_l(hi, hi, 16) ^ fmix32(lo ^ kFpSalt));
      for (int hop = 0; hop < tb.max_probe && !hit; ++hop) {
        const int row0 =
            (lib_bucket0 + static_cast<int>((h + hop) & mask)) * tb.W;
        const uint4* row = reinterpret_cast<const uint4*>(tb.bkey_fp + row0);
        // the row's words as 16-byte vectors, all loaded before the first
        // compare (W = 8: two), then compared in registers
        unsigned hits = 0u;
        for (int q0 = 0; q0 < vph; q0 += kProbeVecs) {
          uint4 vec[kProbeVecs];
#pragma unroll
          for (int i = 0; i < kProbeVecs; ++i)
            if (q0 + i < vph) vec[i] = __ldg(row + q0 + i);
#pragma unroll
          for (int i = 0; i < kProbeVecs; ++i)
            if (q0 + i < vph) hits |= hits4(vec[i], fp) << (4 * (q0 + i));
        }
        if (hits != 0u) {
          my_slot = row0 + __ffs(hits) - 1;
          my_lo = lo;
          my_hi = hi;
          hit = true;
        }
      }
      my_p = p;
    }
    const unsigned hits = __ballot_sync(kFull, hit) & gmask;
    if (hits != 0u) {  // only while the group searches
      found = true;
      winners = hits;
      // the winner issues its slot's loads now: the group's shuffles find
      // them under way (one lane a read: every position of a round may
      // hit, and eight lanes' slot loads crowd a table that is not in L2)
      if (lane == __ffs(hits) - 1) {
        my_klo = __ldg(tb.bkey_lo + my_slot);
        my_khi = __ldg(tb.bkey_hi + my_slot);
        my_start = __ldg(tb.bstart + my_slot);
        my_cnt = __ldg(tb.bcount + my_slot);
      }
    }
  }
  // the winner's values to its group (every lane shuffles; a group without
  // a hit reads its own lane and takes the defaults); the key is compared
  // only here, so no round waits for the slot's loads
  const int my_bad = my_klo != my_lo || my_khi != my_hi;
  const int src = found ? __ffs(winners) - 1 : lane;
  const int win_p = __shfl_sync(kFull, my_p, src);
  const int win_bad = __shfl_sync(kFull, my_bad, src);
  const int win_start = __shfl_sync(kFull, my_start, src);
  const int win_cnt = __shfl_sync(kFull, my_cnt, src);
  const int anchor = found ? win_p : 0;
  const bool fp_bad = found && win_bad != 0;
  const int32_t astart = found ? win_start : astart0;
  const int32_t acnt = found ? win_cnt : 0;

  // --- candidates
  const int pidx = nimble_walk::clamp_int(astart + c, 0, tb.n_postings - 1);
  const int post = lib * tb.n_postings + pidx;
  const int32_t cand_row = __ldg(tb.postings_row + post);
  const int32_t cand_off = __ldg(tb.postings_off + post);
  const bool live0 = read_ok && c < a.C && c < acnt;
  const bool needs_host = (found && acnt > a.C) || fp_bad;

  // --- walk
  const Lane s = nimble_walk::walk_lanes<NR>(
      t, prow, read_len, anchor, lib, cand_row, cand_off, live0, gmask,
      smem + threadIdx.x);

  // --- distinct live rows, mask, gates, pack
  const unsigned live = s.live >> group_base;  // bit j: group lane j
  bool dup = false;
  for (int j = 0; j < G; ++j) {
    const int32_t other = __shfl_sync(kFull, cand_row, group_base + j);
    dup |= j < c && ((live >> j) & 1u) && other == cand_row;
  }
  const int distinct = __popc(
      __ballot_sync(kFull, ((live >> c) & 1u) && !dup) & gmask);
  if (!read_ok || c != 0) return;
  const uint32_t lanes = live & ((1u << a.C) - 1u);
  const int score = found ? s.score + k : 0;
  const int mm = found ? s.acts - s.score : 0;
  if (tb.full) {
    int32_t* o = a.out + b * 3;
    o[0] = astart;
    o[1] = static_cast<int32_t>(lanes | (found ? 1u << 16 : 0u) |
                                (needs_host ? 1u << 17 : 0u));
    o[2] = static_cast<int32_t>((static_cast<uint32_t>(score) << 16) |
                                static_cast<uint32_t>(mm));
    return;
  }
  const int len_at = min(read_len, tb.s_len - 1);
  const int32_t s_min = __ldg(tb.s_min + lib * tb.s_len + len_at);
  const int64_t thr = tb.threshold ? __ldg(tb.threshold + lib) : tb.threshold0;
  const int64_t mis =
      tb.mismatches ? __ldg(tb.mismatches + lib) : tb.mismatches0;
  const bool dmult = tb.discard_multiple
                         ? __ldg(tb.discard_multiple + lib) != 0
                         : tb.discard_multiple0 != 0;
  const bool dnz = tb.discard_nonzero ? __ldg(tb.discard_nonzero + lib) != 0
                                      : tb.discard_nonzero0 != 0;
  const bool passed = found && score >= thr && score >= s_min && mm <= mis &&
                      (distinct <= 1 || !dmult) && (mm == 0 || !dnz);
  int32_t* o = a.out + b * 2;
  o[0] = astart;
  o[1] = static_cast<int32_t>(lanes | (passed && !needs_host ? 1u << 16 : 0u) |
                              (needs_host ? 1u << 17 : 0u) |
                              (found ? 1u << 18 : 0u));
}

template <int NR>
cudaError_t launch(const ProbeArgs& a, int blocks_per_lib,
                   cudaStream_t stream) {
  const int threads = NR > 0 ? kRegThreads : kSmemThreads;
  size_t smem = 0;
  if constexpr (NR == 0) {
    smem = static_cast<size_t>(threads) * (((a.tab.Lmax + 15) >> 4) + 1) *
           sizeof(uint32_t);
    const cudaError_t e = nimble_walk::allow_smem(
        reinterpret_cast<const void*>(probe_walk_filter_kernel<0>), smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(blocks_per_lib),
                  static_cast<unsigned>(a.tab.L));
  probe_walk_filter_kernel<NR><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch of the B0 packed rows against the L libraries of *tab: L * B0
// results, library major.  Returns 0 or a cudaError_t.
extern "C" int nimble_probe_walk_filter(const ProbeTables* tab,
                                        const void* packed, void* out, int B0,
                                        int C, void* stream) {
  if (B0 <= 0) return 0;
  const ProbeTables& tb = *tab;
  const int nr = (tb.Lmax + 15) / 16;
  if (C < 1 || C > 16 || tb.L < 1 || tb.L > 65535 || tb.W < 4 ||
      tb.W % 4 != 0 || tb.W > 32 || tb.max_probe < 1 || tb.k < 2 ||
      tb.k > 32 || tb.k >= tb.Lmax || tb.n_buckets < 1 ||
      (tb.n_buckets & (tb.n_buckets - 1)) != 0 || tb.n_postings < 1 ||
      tb.n_rows < 1 || tb.n_words < nr + 1 || (!tb.full && tb.s_len < 1) ||
      (reinterpret_cast<uintptr_t>(tb.bkey_fp) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int gbits = 3;  // groups of at least 8 lanes: 8 positions a probe round
  while ((1 << gbits) < C) ++gbits;
  const ProbeArgs a{tb, static_cast<const uint8_t*>(packed),
                    static_cast<int32_t*>(out), B0, C, gbits};
  const int reads_per_warp = 32 >> gbits;
  const int threads = nr > kMaxRegWords ? kSmemThreads : kRegThreads;
  const int64_t threads_per_lib =
      (static_cast<int64_t>(B0) + reads_per_warp - 1) / reads_per_warp * 32;
  const int blocks = static_cast<int>((threads_per_lib + threads - 1) /
                                      threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nr > kMaxRegWords ? 0 : nr) {
    case 1: e = launch<1>(a, blocks, s); break;
    case 2: e = launch<2>(a, blocks, s); break;
    case 3: e = launch<3>(a, blocks, s); break;
    case 4: e = launch<4>(a, blocks, s); break;
    case 5: e = launch<5>(a, blocks, s); break;
    case 6: e = launch<6>(a, blocks, s); break;
    case 7: e = launch<7>(a, blocks, s); break;
    case 8: e = launch<8>(a, blocks, s); break;
    default: e = launch<0>(a, blocks, s); break;
  }
  return static_cast<int>(e);
}

extern "C" const char* nimble_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
