// gather_rows.cu: row gathers from a table staged in shared memory, for
// Hopper (sm_90a).  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/gather.py (gather_take,
// gather_taa, gather_lane), which allocates the outputs and checks every
// argument.
//
// Replaces the three TPU feasibility probes of
// scripts/probe_mosaic_gather.py, each a Pallas kernel that holds its whole
// table in VMEM and gathers rows from it with vector indices:
//   pallas_take (k_take):  out[m, :] = tab[idx[m], :]         (M, W)
//   pallas_taa  (k_taa):   out[m, w] = tab[idx2[m, w], w]     (M, W)
//   pallas_lane (k_lane):  out[w, m] = tab_t[w, idx2[w, m]]   (W, M)
// on int32 bit patterns (the port's storage of uint32).  The probe's shapes
// are a (4096, 8) table and M = 65536.
//
// take and taa.  Shared memory stands in for VMEM: every block first stages
// the whole table (N * W * 4 bytes; 128 KiB at the probe's shapes) into
// dynamic shared memory, then gathers a grid-stride range of the output
// from it.  The grid is as many blocks as fit on the card at once, so the
// staging is repeated once per resident block.  Stores are coalesced: a
// thread writes one 16-byte quarter of a row (two per 32-byte row of
// W = 8), neighbouring threads the neighbouring quarters.  Above 48 KiB a
// launch needs cudaFuncAttributeMaxDynamicSharedMemorySize, set once per
// kernel and device; a table above the card's opt-in maximum (227 KiB on an
// H100) is refused (kErrTableTooLarge) and never falls back to global
// memory.  What bounds them on the H100: the output and index bytes (2.5
// and 4.3 MB at the probe's shapes, ~1 us of HBM time) against the
// staging, ~132 resident blocks each reading the 128 KiB table from L2,
// ~17 MB of L2 traffic per call.
//
// lane.  Output row w reads table row w alone, so a block stages one row:
// blocks map to (w, a range of m), about two per SM over all rows, and
// each copies tab_t[w, :] (N * 4 bytes, 16 KiB at the probe's shapes) with
// 16-byte cp.async, then gathers its range with 16-byte index loads and
// 16-byte stores, four m per thread.  The staging falls from ~17 MB of L2
// traffic per call to (blocks x 16 KiB), ~4 MB at the probe's shapes, and
// a block's 16 KiB lets several blocks share an SM.  A table is refused
// only when one row exceeds the opt-in maximum.  What bounds it: the index
// and output bytes (4.2 MB, ~1.3 us of HBM time), with the row's staging
// ahead of each block's first gather.
//
// Indices are clamped into [0, N) so that no read leaves the shared table;
// in-range indices are the contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kLaneThreads = 256;
constexpr int kLaneQuads = 4;  // index quads a lane thread holds at once
constexpr int kMaxDevices = 64;
constexpr int kErrTableTooLarge = -1;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// Copy n_words int32 of the table into shared memory, 16 bytes at a time
// when the source allows it.
__device__ __forceinline__ void stage_table(const int32_t* __restrict__ tab,
                                            int32_t* smem, int64_t n_words,
                                            bool vec) {
  if (vec) {
    const int4* src = reinterpret_cast<const int4*>(tab);
    int4* dst = reinterpret_cast<int4*>(smem);
    for (int64_t i = threadIdx.x; i < n_words / 4; i += blockDim.x)
      dst[i] = __ldg(src + i);
  } else {
    for (int64_t i = threadIdx.x; i < n_words; i += blockDim.x)
      smem[i] = __ldg(tab + i);
  }
  __syncthreads();
}

__device__ __forceinline__ int64_t first_item() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t item_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// out[m, :] = tab[idx[m], :]; with vec (W % 4 == 0, aligned pointers) one
// item is a 16-byte quarter of a row, else one element.
__global__ void __launch_bounds__(kThreads) gather_take_kernel(
    const int32_t* __restrict__ tab,  // (N, W)
    const int32_t* __restrict__ idx,  // (M,)
    int32_t* __restrict__ out,        // (M, W)
    int N, int W, int64_t M, bool vec) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  stage_table(tab, s, static_cast<int64_t>(N) * W, vec);
  if (vec) {
    const int Q = W >> 2;
    const int4* s4 = smem4;
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t e = first_item(); e < M * Q; e += item_stride()) {
      const int64_t m = e / Q;
      const int q = static_cast<int>(e - m * Q);
      const int r = clamp_index(__ldg(idx + m), N);
      out4[e] = s4[static_cast<int64_t>(r) * Q + q];
    }
  } else {
    for (int64_t e = first_item(); e < M * W; e += item_stride()) {
      const int64_t m = e / W;
      const int w = static_cast<int>(e - m * W);
      const int r = clamp_index(__ldg(idx + m), N);
      out[e] = s[static_cast<int64_t>(r) * W + w];
    }
  }
}

// out[m, w] = tab[idx2[m, w], w]; with vec one item is four neighbouring
// columns: one 16-byte index load and one 16-byte store.
__global__ void __launch_bounds__(kThreads) gather_taa_kernel(
    const int32_t* __restrict__ tab,   // (N, W)
    const int32_t* __restrict__ idx2,  // (M, W)
    int32_t* __restrict__ out,         // (M, W)
    int N, int W, int64_t M, bool vec) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  stage_table(tab, s, static_cast<int64_t>(N) * W, vec);
  if (vec) {
    const int Q = W >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx2);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t e = first_item(); e < M * Q; e += item_stride()) {
      const int64_t m = e / Q;
      const int w0 = static_cast<int>(e - m * Q) * 4;
      const int4 ii = __ldg(idx4 + e);
      int4 v;
      v.x = s[static_cast<int64_t>(clamp_index(ii.x, N)) * W + w0];
      v.y = s[static_cast<int64_t>(clamp_index(ii.y, N)) * W + w0 + 1];
      v.z = s[static_cast<int64_t>(clamp_index(ii.z, N)) * W + w0 + 2];
      v.w = s[static_cast<int64_t>(clamp_index(ii.w, N)) * W + w0 + 3];
      out4[e] = v;
    }
  } else {
    for (int64_t e = first_item(); e < M * W; e += item_stride()) {
      const int64_t m = e / W;
      const int w = static_cast<int>(e - m * W);
      const int r = clamp_index(__ldg(idx2 + e), N);
      out[e] = s[static_cast<int64_t>(r) * W + w];
    }
  }
}

// out[w, m] = tab_t[w, idx2[w, m]]: block i gathers the range
// [m0, m0 + chunk) of output row w = i / blocks_per_row, m0 = (i %
// blocks_per_row) * chunk, from table row w alone, staged in shared memory
// with 16-byte cp.async over the row's 16-byte aligned envelope (every
// chunk copied holds a byte of the row, so no copy leaves the table's
// pages, whatever N).  With vec (M % 4 == 0, aligned index and output)
// a thread takes four neighbouring m: one 16-byte index load and one
// 16-byte store; the indices of its first kLaneQuads quads are loaded
// before the row has arrived.
__global__ void __launch_bounds__(kLaneThreads) gather_lane_kernel(
    const int32_t* __restrict__ tab_t,  // (W, N)
    const int32_t* __restrict__ idx2,   // (W, M)
    int32_t* __restrict__ out,          // (W, M)
    int N, int64_t M, int64_t chunk, int blocks_per_row, bool vec) {
  extern __shared__ int4 smem4[];
  const int64_t w = blockIdx.x / blocks_per_row;
  const int64_t m0 = (blockIdx.x - w * blocks_per_row) * chunk;
  const int64_t m1 = m0 + chunk < M ? m0 + chunk : M;
  const uintptr_t s = reinterpret_cast<uintptr_t>(tab_t + w * N);
  const uintptr_t a0 = s & ~static_cast<uintptr_t>(15);
  const int64_t n16 = static_cast<int64_t>(
      ((s + 4 * static_cast<uintptr_t>(N) + 15) &
       ~static_cast<uintptr_t>(15)) - a0) / 16;
  for (int64_t i = threadIdx.x; i < n16; i += blockDim.x) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem4 + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(a0 + 16 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int32_t* row = reinterpret_cast<const int32_t*>(smem4) + (s - a0) / 4;
  const int32_t* irow = idx2 + w * M;
  int32_t* orow = out + w * M;
  if (vec) {
    const int4* i4 = reinterpret_cast<const int4*>(irow);
    int4* o4 = reinterpret_cast<int4*>(orow);
    const int64_t q0 = m0 / 4 + threadIdx.x;
    const int64_t q1 = m1 / 4;
    const int64_t step = static_cast<int64_t>(kLaneQuads) * blockDim.x;
    int4 ii[kLaneQuads];
#pragma unroll
    for (int k = 0; k < kLaneQuads; ++k) {
      const int64_t q = q0 + k * static_cast<int64_t>(blockDim.x);
      if (q < q1) ii[k] = __ldg(i4 + q);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int64_t base = q0; base < q1; base += step) {
      if (base != q0) {
#pragma unroll
        for (int k = 0; k < kLaneQuads; ++k) {
          const int64_t q = base + k * static_cast<int64_t>(blockDim.x);
          if (q < q1) ii[k] = __ldg(i4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kLaneQuads; ++k) {
        const int64_t q = base + k * static_cast<int64_t>(blockDim.x);
        if (q < q1) {
          int4 v;
          v.x = row[clamp_index(ii[k].x, N)];
          v.y = row[clamp_index(ii[k].y, N)];
          v.z = row[clamp_index(ii[k].z, N)];
          v.w = row[clamp_index(ii[k].w, N)];
          o4[q] = v;
        }
      }
    }
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int64_t m = m0 + threadIdx.x; m < m1; m += blockDim.x)
      orow[m] = row[clamp_index(__ldg(irow + m), N)];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// Shared-memory setup and grid size of one launch: refuses a table above
// the opt-in maximum, raises the kernel's dynamic shared-memory limit once
// per device, and sizes the grid to the blocks that fit on the card at once.
int configure(const void* fn, bool* configured, int threads, size_t smem,
              int64_t items, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin)) return kErrTableTooLarge;
  if (smem > kDefaultSmem && !configured[dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t wanted = (items + threads - 1) / threads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  *grid = static_cast<int>(wanted < resident ? wanted : resident);
  return 0;
}

bool configured_take[kMaxDevices];
bool configured_taa[kMaxDevices];
bool configured_lane[kMaxDevices];

}  // namespace

extern "C" int nimble_gather_take(const void* tab, const void* idx, void* out,
                                  int N, int W, int64_t M, void* stream) {
  if (M <= 0) return 0;
  if (N < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 4 == 0 && aligned16(tab) && aligned16(out);
  const size_t smem = static_cast<size_t>(N) * W * sizeof(int32_t);
  int grid = 0;
  const int err = configure(reinterpret_cast<const void*>(gather_take_kernel),
                            configured_take, kThreads, smem,
                            vec ? M * (W / 4) : M * W,
                            &grid);
  if (err) return err;
  gather_take_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), N, W, M, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nimble_gather_taa(const void* tab, const void* idx2, void* out,
                                 int N, int W, int64_t M, void* stream) {
  if (M <= 0) return 0;
  if (N < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 4 == 0 && aligned16(tab) && aligned16(idx2) &&
                   aligned16(out);
  const size_t smem = static_cast<size_t>(N) * W * sizeof(int32_t);
  int grid = 0;
  const int err = configure(reinterpret_cast<const void*>(gather_taa_kernel),
                            configured_taa, kThreads, smem,
                            vec ? M * (W / 4) : M * W,
                            &grid);
  if (err) return err;
  gather_taa_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), static_cast<const int32_t*>(idx2),
      static_cast<int32_t*>(out), N, W, M, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nimble_gather_lane(const void* tab_t, const void* idx2,
                                  void* out, int N, int W, int64_t M,
                                  void* stream) {
  if (M <= 0) return 0;
  if (N < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = M % 4 == 0 && aligned16(idx2) && aligned16(out);
  // one row's 16-byte envelope: at most 15 bytes before and after it
  const size_t smem = (static_cast<size_t>(N) * 4 + 15) / 16 * 16 + 16;
  int grid = 0, dev = 0, sms = 0;  // lane sizes its own grid, below
  int err = configure(reinterpret_cast<const void*>(gather_lane_kernel),
                      configured_lane, kLaneThreads, smem, M * W, &grid);
  if (err) return err;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // about two blocks per SM over all rows, each block a whole number of
  // thread-quads of m (the last of a row may be short)
  const int64_t unit = 4 * kLaneThreads;
  int64_t per_row = (2 * static_cast<int64_t>(sms) + W - 1) / W;
  int64_t chunk = (M + per_row - 1) / per_row;
  chunk = (chunk + unit - 1) / unit * unit;
  per_row = (M + chunk - 1) / chunk;
  if (per_row * W > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_lane_kernel<<<static_cast<unsigned>(per_row * W), kLaneThreads,
                       smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab_t), static_cast<const int32_t*>(idx2),
      static_cast<int32_t*>(out), N, M, chunk, static_cast<int>(per_row),
      vec);
  return static_cast<int>(cudaGetLastError());
}

// The opt-in shared-memory maximum of the current device, in bytes (< 0: a
// CUDA error code, negated).
extern "C" int nimble_gather_smem_optin() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return optin;
}

extern "C" const char* nimble_gather_error_string(int err) {
  if (err == kErrTableTooLarge)
    return "the table exceeds the shared memory a block can opt in to";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
