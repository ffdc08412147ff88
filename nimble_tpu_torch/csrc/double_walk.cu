// double_walk.cu: the walk recurrence over precomputed masks, for Hopper
// (sm_90a).  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/double_walk.py
// (double_walk), which allocates the outputs and checks every argument.
//
// Replaces the TPU kernel nimble_tpu/ops/pallas_walk.py, pallas_double_walk
// (body: _walk_kernel).  Same inputs and results, bit for bit: per read b,
// the forward walk over t = 0..T-1 on (f_alive, f_match, f_active), then the
// left walk over t = 0..Tl-1 on (l_alive, l_match, l_active), with the live
// lanes carried from the first into the second:
//   la = live & alive;  lm = live & match
//   act = active & any(la)
//   if act & any(lm): live = lm, score += 1
//   elif act:         live = la, mm += 1
// The masks come from the relative-coordinate span glue
// (ops/span_walk.py, rel_walk_masks) as int8 0/1 values.
//
// Layout: the masks are taken in the (B, C, T) order the glue builds them,
// not transposed to the Pallas kernel's (T, C, B).  A transpose would be one
// more full pass over the masks (about 4 MB each at B = 8192, C = 8,
// T = 62) before the kernel reads them once; in (B, C, T) order each
// candidate's T steps are one contiguous row, which its lane walks front to
// back, so a row is fetched from L2 in one or two 128-byte lines and the
// later steps hit L1.
//
// What bounds it on the H100.  The bytes: 2*B*C*(T+Tl) + B*(T+Tl) mask
// bytes, about 17 MB per 8192-read launch at T = Tl = 62, which is ~5 us of
// HBM time at 3.35 TB/s.  The serial chain is T+Tl dependent steps per
// read, each needing two "any" votes over the read's candidates.
//
// Design.  As in fused_span_walk.cu: one warp lane per candidate; a read's
// C candidates occupy a power-of-two group of lanes (8 for C = 8, so 4
// reads per warp) and each step's any_alive / any_match are two
// __ballot_sync votes masked to the group.  Every lane runs all T steps and
// then all Tl steps (the bounds are kernel arguments, the same for every
// lane), so the votes are always warp-uniform; lanes past C or past the
// batch read no mask, carry live = 0 and vote 0.  Vectorized mask loads and
// shared-memory staging are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ void walk_step(bool& live, int& score, int& mm,
                                          bool alive, bool match,
                                          bool active, unsigned gmask) {
  const bool la = live && alive;
  const bool lm = live && match;
  const bool any_alive = (__ballot_sync(kFull, la) & gmask) != 0u;
  const bool any_match = (__ballot_sync(kFull, lm) & gmask) != 0u;
  const bool act = active && any_alive;
  const bool act_match = act && any_match;
  live = act_match ? lm : (act ? la : live);
  score += act_match ? 1 : 0;
  mm += (act && !any_match) ? 1 : 0;
}

// One walk over T steps of (B, C, T) alive/match and (B, T) active masks.
__device__ __forceinline__ void walk(bool& live, int& score, int& mm,
                                     const int8_t* __restrict__ alive_row,
                                     const int8_t* __restrict__ match_row,
                                     const int8_t* __restrict__ active_row,
                                     bool cand_ok, bool read_ok, int T,
                                     unsigned gmask) {
  for (int t = 0; t < T; ++t) {
    const bool alive = cand_ok && __ldg(alive_row + t) != 0;
    const bool match = cand_ok && __ldg(match_row + t) != 0;
    const bool active = read_ok && __ldg(active_row + t) != 0;
    walk_step(live, score, mm, alive, match, active, gmask);
  }
}

__global__ void __launch_bounds__(kThreads) double_walk_kernel(
    const int8_t* __restrict__ f_alive,   // (B, C, T)
    const int8_t* __restrict__ f_match,   // (B, C, T)
    const int8_t* __restrict__ f_active,  // (B, T)
    const int8_t* __restrict__ l_alive,   // (B, C, Tl)
    const int8_t* __restrict__ l_match,   // (B, C, Tl)
    const int8_t* __restrict__ l_active,  // (B, Tl)
    const int8_t* __restrict__ live0,     // (B, C)
    int8_t* __restrict__ live_out,        // (B, C)
    int32_t* __restrict__ score_out,      // (B,)
    int32_t* __restrict__ mm_out,         // (B,)
    int B, int C, int T, int Tl, int gbits) {
  const int lane = threadIdx.x & 31;
  const int group = lane >> gbits;
  const int c = lane & ((1 << gbits) - 1);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t first_read = warp * (32 >> gbits);
  if (first_read >= B) return;  // the whole warp lies past the batch
  const int64_t b = first_read + group;
  const bool read_ok = b < B;
  const bool cand_ok = read_ok && c < C;
  const int64_t bc = cand_ok ? b * C + c : 0;
  const int64_t bb = read_ok ? b : 0;
  const unsigned gmask =
      gbits == 5 ? kFull
                 : ((1u << (1 << gbits)) - 1u) << (group << gbits);

  bool live = cand_ok && live0[bc] != 0;
  int score = 0;
  int mm = 0;
  walk(live, score, mm, f_alive + bc * T, f_match + bc * T, f_active + bb * T,
       cand_ok, read_ok, T, gmask);
  walk(live, score, mm, l_alive + bc * Tl, l_match + bc * Tl,
       l_active + bb * Tl, cand_ok, read_ok, Tl, gmask);

  if (cand_ok) live_out[bc] = live ? 1 : 0;
  if (read_ok && c == 0) {
    score_out[b] = score;
    mm_out[b] = mm;
  }
}

}  // namespace

extern "C" int nimble_double_walk(
    const void* f_alive, const void* f_match, const void* f_active,
    const void* l_alive, const void* l_match, const void* l_active,
    const void* live0, void* live_out, void* score_out, void* mm_out,
    int B, int C, int T, int Tl, void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || C > 32 || T < 0 || Tl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int gbits = 0;
  while ((1 << gbits) < C) ++gbits;
  const int64_t reads_per_warp = 32 >> gbits;
  const int64_t warps = (B + reads_per_warp - 1) / reads_per_warp;
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  double_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(f_alive), static_cast<const int8_t*>(f_match),
      static_cast<const int8_t*>(f_active),
      static_cast<const int8_t*>(l_alive), static_cast<const int8_t*>(l_match),
      static_cast<const int8_t*>(l_active), static_cast<const int8_t*>(live0),
      static_cast<int8_t*>(live_out), static_cast<int32_t*>(score_out),
      static_cast<int32_t*>(mm_out), B, C, T, Tl, gbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nimble_double_walk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
