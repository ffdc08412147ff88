// probe_walk_filter.cu: the whole device pass of nimble_tpu_torch in one
// launch, for Hopper (sm_90a): unpack, anchor probe, candidate gather, span
// walk and filter + pack.  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/probe_walk.py
// (probe_walk), which allocates the output and checks every argument.
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
// a microsecond at 3.35 TB/s.  Not operations either: ~40 32-bit
// operations a key and the walk's ~2 * (Lmax - k) voted steps.  What
// remains is latency: a chain of dependent loads (row -> fingerprint row ->
// key words -> bstart -> postings -> row start -> reference words) before
// the walk's serial steps.  PERF.md section 6 has the times.
//
// Design.
// - A read owns a power-of-two group of G >= 8 lanes (G = 8 at C <= 8, so
//   4 reads per warp, the walk kernel's mapping).  The probe takes G
//   positions a round, lane j position round * G + j, each building its
//   key straight from the packed row's words (two 16-base windows of
//   span_walk.cuh's RowWords, bit-reversed to first-base-most-significant):
//   no rolling state, no per-position table beyond the bucket row it
//   needs.  A ballot
//   over the group picks the round's first hitting position, and the group
//   stops there; a read that anchors at position 0, as most do, reads one
//   bucket row per hop.  The rounds are warp-uniform (every lane votes
//   every round) until no group of the warp searches.
// - The winner's bucket, lane and key come to every lane of the group by
//   shuffle; lane c then loads candidate c (lanes c >= C load a valid
//   posting and stay dead), and the group walks as in fused_span_walk.cu.
// - The epilogue counts distinct rows with one shuffle per group lane and
//   a ballot; lane 0 of the group gates and writes the row.
// - The walk's register / shared-memory split is kept: NR <= 8 in
//   registers with 64-thread blocks, above in dynamic shared memory with
//   256-thread blocks (reads up to 1024 bp).

#include <cstdint>

#include <cuda_runtime.h>

#include "span_walk.cuh"

namespace {

using nimble_walk::kFull;
using nimble_walk::kMaxRegWords;
using nimble_walk::Lane;
using nimble_walk::WalkTables;

constexpr int kRegThreads = 64;
constexpr int kSmemThreads = 256;
constexpr uint32_t kFpSalt = 0x7FEB352Du;  // ops/device_index.FP_SALT

struct ProbeArgs {
  const uint8_t* packed;        // (B0, ceil(Lmax/4) + 2)
  const uint32_t* bkey_lo;      // (L, n_buckets, W)
  const uint32_t* bkey_hi;
  const uint32_t* bkey_fp;
  const int32_t* bstart;
  const int32_t* bcount;
  const int32_t* postings_row;  // (L, n_postings)
  const int32_t* postings_off;
  const int32_t* s_min;         // (L, s_len); compact mode only
  const int32_t* threshold;     // (L,) or null: threshold0
  const int32_t* mismatches;    // (L,) or null: mismatches0
  const uint8_t* discard_multiple;  // (L,) bool or null
  const uint8_t* discard_nonzero;   // (L,) bool or null
  int32_t* out;                 // (B, 2) compact or (B, 3) full
  WalkTables t;
  int64_t n_buckets, n_postings, s_len, threshold0, mismatches0;
  int discard_multiple0, discard_nonzero0;
  int B, B0, C, W, max_probe, gbits, full;
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

template <int NR>
__global__ void probe_walk_filter_kernel(const ProbeArgs a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int group_base = (lane >> a.gbits) << a.gbits;
  const int G = 1 << a.gbits;
  const int c = lane - group_base;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t first_read = warp * (32 >> a.gbits);
  if (first_read >= a.B) return;  // the whole warp lies past the batch
  const int64_t b = first_read + (lane >> a.gbits);
  const bool read_ok = b < a.B;
  const int64_t rb = read_ok ? b : 0;  // lanes past the batch: read 0, dead
  const int64_t lib = rb / a.B0;
  const unsigned gmask = nimble_walk::group_mask(lane, a.gbits);
  const WalkTables& t = a.t;
  const int nb = (t.Lmax + 3) >> 2;
  const uint8_t* prow = a.packed + (rb % a.B0) * static_cast<int64_t>(nb + 2);
  const int read_len = __ldg(prow + nb) | (__ldg(prow + nb + 1) << 8);
  const nimble_walk::RowWords rw(prow, nb);

  // --- probe: G positions a round until the group's first hit
  const int k = t.k;
  const int half = k >> 1;
  const int npos = read_ok ? min(t.Lmax - k + 1, read_len - k + 1) : 0;
  const int64_t mask = a.n_buckets - 1;
  const uint32_t* fp_tab = a.bkey_fp + lib * a.n_buckets * a.W;
  bool found = false;
  unsigned winners = 0u;
  int my_p = 0, my_lane = 0;
  int64_t my_bucket = 0;
  uint32_t my_lo = 0u, my_hi = 0u;
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
      for (int hop = 0; hop < a.max_probe && !hit; ++hop) {
        const int64_t bk = (static_cast<int64_t>(h) + hop) & mask;
        const uint32_t* row = fp_tab + bk * a.W;
        for (int w = 0; w < a.W; ++w) {
          if (__ldg(row + w) == fp) {
            hit = true;
            my_bucket = bk;
            my_lane = w;
            break;
          }
        }
      }
      my_p = p;
      my_lo = lo;
      my_hi = hi;
    }
    const unsigned hits = __ballot_sync(kFull, hit) & gmask;
    if (hits != 0u) {  // only while the group searches
      found = true;
      winners = hits;
    }
  }
  // the winner's values to its group (every lane shuffles; a group without
  // a hit reads its own lane and takes 0)
  const int src = found ? __ffs(winners) - 1 : lane;
  const int win_p = __shfl_sync(kFull, my_p, src);
  const long long win_bucket =
      __shfl_sync(kFull, static_cast<long long>(my_bucket), src);
  const int win_lane = __shfl_sync(kFull, my_lane, src);
  const uint32_t key_lo = __shfl_sync(kFull, my_lo, src);
  const uint32_t key_hi = __shfl_sync(kFull, my_hi, src);
  const int anchor = found ? win_p : 0;
  const int64_t bucket = found ? win_bucket : 0;
  const int sel_lane = found ? win_lane : 0;
  const int64_t slot = (lib * a.n_buckets + bucket) * a.W + sel_lane;
  const bool fp_bad = found && (__ldg(a.bkey_lo + slot) != key_lo ||
                                __ldg(a.bkey_hi + slot) != key_hi);

  // --- candidates
  const int32_t astart = __ldg(a.bstart + slot);
  const int32_t acnt = found ? __ldg(a.bcount + slot) : 0;
  int64_t pidx = static_cast<int64_t>(astart) + c;
  pidx = pidx < 0 ? 0 : (pidx > a.n_postings - 1 ? a.n_postings - 1 : pidx);
  const int64_t post = lib * a.n_postings + pidx;
  const int32_t cand_row = __ldg(a.postings_row + post);
  const bool live0 = read_ok && c < a.C && c < acnt;
  const bool needs_host = (found && acnt > a.C) || fp_bad;

  // --- walk
  const Lane s = nimble_walk::walk_lanes<NR>(
      t, prow, read_len, anchor, lib, cand_row,
      __ldg(a.postings_off + post), live0, gmask, smem + threadIdx.x);

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
  if (a.full) {
    int32_t* o = a.out + b * 3;
    o[0] = astart;
    o[1] = static_cast<int32_t>(lanes | (found ? 1u << 16 : 0u) |
                                (needs_host ? 1u << 17 : 0u));
    o[2] = static_cast<int32_t>((static_cast<uint32_t>(score) << 16) |
                                static_cast<uint32_t>(mm));
    return;
  }
  const int64_t len_at = read_len < a.s_len - 1 ? read_len : a.s_len - 1;
  const int32_t s_min = __ldg(a.s_min + lib * a.s_len + len_at);
  const int64_t thr = a.threshold ? __ldg(a.threshold + lib) : a.threshold0;
  const int64_t mis =
      a.mismatches ? __ldg(a.mismatches + lib) : a.mismatches0;
  const bool dmult = a.discard_multiple
                         ? __ldg(a.discard_multiple + lib) != 0
                         : a.discard_multiple0 != 0;
  const bool dnz = a.discard_nonzero ? __ldg(a.discard_nonzero + lib) != 0
                                     : a.discard_nonzero0 != 0;
  const bool passed = found && score >= thr && score >= s_min && mm <= mis &&
                      (distinct <= 1 || !dmult) && (mm == 0 || !dnz);
  int32_t* o = a.out + b * 2;
  o[0] = astart;
  o[1] = static_cast<int32_t>(lanes | (passed && !needs_host ? 1u << 16 : 0u) |
                              (needs_host ? 1u << 17 : 0u) |
                              (found ? 1u << 18 : 0u));
}

template <int NR>
cudaError_t launch(const ProbeArgs& a, int64_t threads_total,
                   cudaStream_t stream) {
  const int threads = NR > 0 ? kRegThreads : kSmemThreads;
  const int64_t blocks = (threads_total + threads - 1) / threads;
  size_t smem = 0;
  if constexpr (NR == 0) {
    smem = static_cast<size_t>(threads) * (((a.t.Lmax + 15) >> 4) + 1) *
           sizeof(uint32_t);
    const cudaError_t e = nimble_walk::allow_smem(
        reinterpret_cast<const void*>(probe_walk_filter_kernel<0>), smem);
    if (e != cudaSuccess) return e;
  }
  probe_walk_filter_kernel<NR><<<static_cast<unsigned>(blocks), threads,
                                 smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch of B reads (B0 packed rows; B = L * B0 when the tables hold L
// libraries).  Returns 0 or a cudaError_t.
extern "C" int nimble_probe_walk_filter(
    const void* packed, const void* bkey_lo,
    const void* bkey_hi, const void* bkey_fp, const void* bstart,
    const void* bcount, const void* postings_row, const void* postings_off,
    const void* ref, const void* row_starts, const void* row_lengths,
    const void* s_min, const void* threshold, const void* mismatches,
    const void* discard_multiple, const void* discard_nonzero, void* out,
    int64_t n_buckets, int64_t n_postings, int64_t n_rows, int64_t n_words,
    int64_t s_len, int64_t threshold0, int64_t mismatches0,
    int discard_multiple0, int discard_nonzero0, int B, int B0, int C, int W,
    int max_probe, int Lmax, int k, int ref_pad, int full, void* stream) {
  if (B <= 0) return 0;
  const int nr = (Lmax + 15) / 16;
  if (B0 < 1 || C < 1 || C > 16 || W < 1 || max_probe < 1 || k < 2 ||
      k > 32 || k >= Lmax || n_buckets < 1 ||
      (n_buckets & (n_buckets - 1)) != 0 || n_postings < 1 || n_rows < 1 ||
      n_words < nr + 1 || (!full && s_len < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int gbits = 3;  // groups of at least 8 lanes: 8 positions a probe round
  while ((1 << gbits) < C) ++gbits;
  const ProbeArgs a{
      static_cast<const uint8_t*>(packed),
      static_cast<const uint32_t*>(bkey_lo),
      static_cast<const uint32_t*>(bkey_hi),
      static_cast<const uint32_t*>(bkey_fp),
      static_cast<const int32_t*>(bstart),
      static_cast<const int32_t*>(bcount),
      static_cast<const int32_t*>(postings_row),
      static_cast<const int32_t*>(postings_off),
      static_cast<const int32_t*>(s_min),
      static_cast<const int32_t*>(threshold),
      static_cast<const int32_t*>(mismatches),
      static_cast<const uint8_t*>(discard_multiple),
      static_cast<const uint8_t*>(discard_nonzero),
      static_cast<int32_t*>(out),
      WalkTables{static_cast<const int32_t*>(row_starts),
                 static_cast<const int32_t*>(row_lengths),
                 static_cast<const uint32_t*>(ref), n_rows, n_words, Lmax, k,
                 ref_pad},
      n_buckets, n_postings, s_len, threshold0, mismatches0,
      discard_multiple0, discard_nonzero0, B, B0, C, W, max_probe, gbits,
      full};
  const int64_t reads_per_warp = 32 >> gbits;
  const int64_t threads_total =
      (B + reads_per_warp - 1) / reads_per_warp * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nr > kMaxRegWords ? 0 : nr) {
    case 1: e = launch<1>(a, threads_total, s); break;
    case 2: e = launch<2>(a, threads_total, s); break;
    case 3: e = launch<3>(a, threads_total, s); break;
    case 4: e = launch<4>(a, threads_total, s); break;
    case 5: e = launch<5>(a, threads_total, s); break;
    case 6: e = launch<6>(a, threads_total, s); break;
    case 7: e = launch<7>(a, threads_total, s); break;
    case 8: e = launch<8>(a, threads_total, s); break;
    default: e = launch<0>(a, threads_total, s); break;
  }
  return static_cast<int>(e);
}

extern "C" const char* nimble_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
