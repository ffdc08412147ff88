// fused_span_walk.cu: the candidate span-walk of nimble_tpu_torch, for
// Hopper (sm_90a), gathering its own reference words.  Built by
// nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/span_walk.py
// (fused_span_walk), which allocates the outputs and checks every argument.
//
// Replaces the TPU kernel nimble_tpu/ops/pallas_fused.py,
// pallas_fused_span_walk, together with the word gather in front of it
// (engine_fast._span_walk_abs_fused: _gather_span_words, then the kernel).
// Inputs are the device tensors the probe already holds: the uploaded 2-bit
// packed read rows (B, ceil(Lmax/4) + 2) uint8 (base j at bits 2*(j%4) of
// byte j/4, then the uint16 length), the anchor (B,), the candidates' row
// ids and anchor offsets (B, C), live0 (B, C), an optional per-row library
// index (B,), and the tables row_starts, row_lengths and ref_codes_packed,
// single or stacked (L, .).  Per candidate:
//   start = row_starts[lib, row] + off - anchor + ref_pad
//   w0 = clamp(start >> 4, 0, n_words - NW),  phase = start & 15
// with NW = NR + 1 words (NR = ceil(Lmax/16)) and n_words the (padded)
// extent of ref_codes_packed's last axis, as gather_span_words computes
// them.  Results, bit for bit those of gather_span_words +
// fused_span_walk_plain: the lockstep walk forward over p = k..Lmax-1, then
// left over p = P-2..0 (P = Lmax-k+1), with base = off - anchor:
//   forward: alive = base + p <  r_len,  active = anchor+k <= p < read_len
//   left:    alive = base + p >= 0,      active = p < anchor
//   step:    la = live & alive; lm = la & match
//            if active & any(la) & any(lm): live = lm, score += 1
//            elif active & any(la):         live = la, mm += 1
//
// What bounds it on the H100.  Not bytes: 25 B of packed read, 144 B of
// anchor, candidate ids and live0 and 16 B of results a read at Lmax = 92
// and C = 8, about 1.5 MB per 8192-read launch with the table words it
// touches, half a microsecond of HBM time at 3.35 TB/s.  What remains is
// latency and issue: the three dependent loads before the walk (candidate
// row, its row start, its reference words), then the walk's windows (one
// per 32 steps and one more per event), each four reductions over the
// read's candidates, 2,048 warps of them at B = 8192 and C = 8.  PERF.md section
// 6 has the times.
//
// Design.
// - One warp lane per candidate: a read's C candidates occupy a
//   power-of-two group of lanes (8 for C = 8, so 4 reads per warp); lanes
//   past C or past the batch carry live = 0.  The block is 64 threads, so
//   the 8192-read launch at C = 8 is 1,024 blocks spread over all 132 SMs.
// - The walk itself is nimble_walk::walk_lanes (csrc/span_walk.cuh, shared
//   with csrc/probe_walk_filter.cu, which probes and filters around it in
//   the same launch): it gathers its own reference words, compares 16
//   bases a word, and walks by events, 32 steps a window with four group
//   reductions, a step of its own only where the live candidates
//   disagree; up to NR = 8 (Lmax <= 128) its step words live in registers
//   (one kernel per NR), above in dynamic shared memory (256 threads x 65
//   words at Lmax = 1024, above 48 KB after the opt-in).  This entry serves the
//   mesh's shard step, which all-reduces the probe before the walk; the
//   single-device passes launch probe_walk_filter.cu instead.

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

struct WalkArgs {
  const uint8_t* packed;       // (B, row_bytes)
  const int64_t* anchor;       // (B,)
  const int64_t* rows;         // (B, C)
  const int64_t* offs;         // (B, C)
  const uint8_t* live0;        // (B, C) bool
  const int64_t* lib;          // (B,) or null: library 0
  WalkTables t;
  uint8_t* live_out;           // (B, C) bool
  int32_t* score_out;          // (B,)
  int32_t* mm_out;             // (B,)
  int B, C, gbits;
};

// NR > 0: NR match words in registers.  NR == 0: (Lmax + 15) / 16 + 1
// words of dynamic shared memory per thread.
template <int NR>
__global__ void fused_span_walk_kernel(const WalkArgs a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int group = lane >> a.gbits;
  const int c = lane & ((1 << a.gbits) - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t first_read = warp * (32 >> a.gbits);
  if (first_read >= a.B) return;  // the whole warp lies past the batch
  const int64_t b = first_read + group;
  const bool read_ok = b < a.B;
  const bool cand_ok = read_ok && c < a.C;
  // lanes without a candidate read the first read's first candidate (a
  // valid address) and never vote live
  const int64_t rb = read_ok ? b : 0;
  const int64_t bc = cand_ok ? b * a.C + c : 0;
  const int nb = (a.t.Lmax + 3) >> 2;

  const uint8_t* prow = a.packed + rb * static_cast<int64_t>(nb + 2);
  const int rdlen = __ldg(prow + nb) | (__ldg(prow + nb + 1) << 8);
  const int lib = a.lib != nullptr ? static_cast<int>(__ldg(a.lib + rb)) : 0;
  const bool live0 = cand_ok && __ldg(a.live0 + bc) != 0;
  const Lane s = nimble_walk::walk_lanes<NR>(
      a.t, prow, rdlen, static_cast<int>(__ldg(a.anchor + rb)), lib,
      static_cast<int>(__ldg(a.rows + bc)),
      static_cast<int>(__ldg(a.offs + bc)), live0,
      nimble_walk::group_mask(lane, a.gbits), smem + threadIdx.x);

  if (cand_ok) a.live_out[bc] = (s.live >> lane) & 1u;
  if (read_ok && c == 0) {
    a.score_out[b] = s.score;
    a.mm_out[b] = s.acts - s.score;
  }
}

template <int NR>
cudaError_t launch(const WalkArgs& a, int64_t threads_total,
                   cudaStream_t stream) {
  const int threads = NR > 0 ? kRegThreads : kSmemThreads;
  const int64_t blocks = (threads_total + threads - 1) / threads;
  size_t smem = 0;
  if constexpr (NR == 0) {
    smem = static_cast<size_t>(threads) * (((a.t.Lmax + 15) >> 4) + 1) *
           sizeof(uint32_t);
    const cudaError_t e = nimble_walk::allow_smem(
        reinterpret_cast<const void*>(fused_span_walk_kernel<0>), smem);
    if (e != cudaSuccess) return e;
  }
  fused_span_walk_kernel<NR><<<static_cast<unsigned>(blocks), threads, smem,
                               stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nimble_fused_span_walk(
    const void* packed, const void* anchor, const void* rows,
    const void* offs, const void* live0, const void* lib,
    const void* row_starts, const void* row_lengths, const void* ref,
    void* live_out, void* score_out, void* mm_out, int64_t n_rows,
    int64_t n_words, int B, int C, int Lmax, int k, int ref_pad,
    void* stream) {
  if (B <= 0) return 0;
  const int nr = (Lmax + 15) / 16;
  // the walk indexes the tables in 32 bits (the wrapper checks L * n_rows
  // and L * n_words against 2^31)
  if (C < 1 || C > 32 || k <= 0 || k >= Lmax || n_rows < 1 ||
      n_words < nr + 1 || n_rows >= (int64_t{1} << 31) ||
      n_words >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int gbits = 0;
  while ((1 << gbits) < C) ++gbits;
  const WalkArgs a{static_cast<const uint8_t*>(packed),
                   static_cast<const int64_t*>(anchor),
                   static_cast<const int64_t*>(rows),
                   static_cast<const int64_t*>(offs),
                   static_cast<const uint8_t*>(live0),
                   static_cast<const int64_t*>(lib),
                   WalkTables{static_cast<const int32_t*>(row_starts),
                              static_cast<const int32_t*>(row_lengths),
                              static_cast<const uint32_t*>(ref),
                              static_cast<int>(n_rows),
                              static_cast<int>(n_words), Lmax, k, ref_pad},
                   static_cast<uint8_t*>(live_out),
                   static_cast<int32_t*>(score_out),
                   static_cast<int32_t*>(mm_out),
                   B, C, gbits};
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
