// gather_rows.cu: row gathers from a table held on chip, for Hopper
// (sm_90a).  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/gather.py (gather_take,
// gather_taa, gather_lane), which allocates the outputs and checks every
// argument.
//
// Replaces the three TPU feasibility probes of
// scripts/probe_mosaic_gather.py, each a Pallas kernel that holds its whole
// table in VMEM and gathers rows from it with vector indices:
//   pallas_take (k_take):  out[m, :] = tab[idx[m], :]         (M, W)
//   pallas_taa  (k_taa):   out[m, w] = tab[idx[m], w]         (M, W)
//   pallas_lane (k_lane):  out[w, m] = tab_t[w, idx[m]]       (W, M)
// on int32 bit patterns (the port's storage of uint32); k_taa and k_lane
// broadcast their (M,) index inside the kernel.  The probe's shapes are a
// (4096, 8) table and M = 65536.
//
// take and taa (nimble_gather_rows): one function covers both,
//   out[m, w] = tab[idx[m * s0 + w * s1], w]
// take is s0 = 1, s1 = 0; taa on k_taa's broadcast index (idx[:, None]
// expanded to (M, W), strides (1, 0)) is the same row form, one index per
// output row; taa on a contiguous (M, W) index (s0 = W, s1 = 1) is the
// general form, a row per element.  Items: in the row form with W % 4 == 0
// and 16-byte aligned pointers, a 16-byte quarter of a row (one index load
// per row, one 16-byte table load and store); in the general form with
// those, four neighbouring columns (one 16-byte index load, four 4-byte
// table loads, one 16-byte store); else one element.  Neighbouring threads
// write neighbouring 16 bytes; each thread loads its next index before its
// current row.  Two designs (Table types), chosen by the entry from the
// form and the table's size (choose_design):
// - unstaged (GlobalTable): rows read straight from global memory, 16-byte
//   quarters with ld.global.nc.L1::evict_last; each SM pulls only the rows
//   its items touch, through L1 and the 50 MB L2; no size limit.  The row
//   form's design at every size, and the general form's above one block's
//   opt-in shared memory.
// - per block (BlockTable): every block copies the whole table into its
//   shared memory (16-byte loads by all threads over the table's 16-byte
//   aligned envelope, so a table at any 4-byte offset needs no head or
//   tail), then gathers from it.  The general form's design while the
//   table fits in a block: four scattered 4-byte reads an item cost less
//   from shared memory than from L1.
// What bounds them at the probe's shapes (M = 65536, (4096, 8) table; 2.5
// MB of index, table and output, ~0.74 us of HBM time): a copy of the
// whole table into every SM is bound by what an SM can take in from L2
// while all SMs copy at once (128 KiB a block takes longer than the whole
// unstaged gather); the unstaged row form is the latency of an index load
// and a dependent row load, with no copy ahead of it.  Two designs that
// stage the table once per thread-block cluster (every block of a cluster
// filled by multicast TMA copies; the table split by rows over the
// cluster, read through distributed shared memory) measured slower than
// both on an H100 and were removed (PERF.md section 6).
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
// Indices are clamped into [0, N) so that no read leaves the table; in-range
// indices are the contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // take and taa
constexpr int kLaneThreads = 256;
constexpr int kLaneQuads = 4;  // index quads a lane thread holds at once
constexpr int kMaxDevices = 64;
constexpr int kErrTableTooLarge = -1;
constexpr size_t kDefaultSmem = 48 * 1024;
// designs of nimble_gather_rows (nimble_gather_rows_design's codes)
constexpr int kUnstaged = 0;
constexpr int kBlock = 1;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ int64_t first_item() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t item_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// The row form's grid-stride walk over items e = m * Q + c (output row m,
// item c of the row), stepped with no division in the loop (the grid, at
// most the blocks resident at once, holds fewer than 2^32 threads).  On an
// H100 the row form ran faster with this walk than with two 64-bit
// divisions an item, and the general form, which needs only c, slower
// than with its one modulo an item (PERF.md section 6).
struct ItemWalk {
  int64_t e, m, step_m;
  int c, Q, step, step_c;

  __device__ explicit ItemWalk(int Q_) : Q(Q_) {
    const unsigned q = static_cast<unsigned>(Q_);
    const unsigned e0 = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned s = gridDim.x * blockDim.x;
    e = e0;
    m = e0 / q;
    c = static_cast<int>(e0 - static_cast<unsigned>(m) * q);
    step = static_cast<int>(s);
    step_m = s / q;
    step_c = static_cast<int>(s - static_cast<unsigned>(step_m) * q);
  }

  __device__ __forceinline__ ItemWalk next() const {
    ItemWalk n = *this;
    n.e += step;
    n.m += step_m;
    n.c += step_c;
    if (n.c >= Q) {
      n.c -= Q;
      ++n.m;
    }
    return n;
  }
};

struct RowArgs {
  const int32_t* tab;  // (N, W)
  const int32_t* idx;  // row form: idx[m * s0]; general form: (M, W)
  int32_t* out;        // (M, W)
  int64_t M, s0;
  int N, W;
  bool vec;  // 16-byte items
};

// Shared memory of a block that holds a table of `bytes` at any 4-byte
// offset: its 16-byte envelope.
constexpr size_t held_smem(size_t bytes) { return (bytes + 15) / 16 * 16 + 16; }

// The unstaged design: rows read from global memory, kept in L1.
struct GlobalTable {
  const int32_t* tab;
  int W;
  __device__ GlobalTable(const RowArgs& a, int4*) : tab(a.tab), W(a.W) {}
  __device__ void stage(const RowArgs&) const {}
  __device__ void ready() const {}
  __device__ __forceinline__ int32_t load(int r, int w) const {
    return __ldg(tab + static_cast<int64_t>(r) * W + w);
  }
  __device__ __forceinline__ int4 load4(int r, int q) const {
    int4 v;
    asm("ld.global.nc.L1::evict_last.v4.s32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(tab + static_cast<int64_t>(r) * W + 4 * q));
    return v;
  }
};

// The per-block design: every block copies the whole table into its own
// shared memory, all threads loading 16 bytes at a time over the table's
// 16-byte aligned envelope.
struct BlockTable {
  int4* smem;
  const int32_t* held;  // tab[0, 0] in this block's shared memory
  int W;

  __device__ BlockTable(const RowArgs& a, int4* smem_)
      : smem(smem_),
        held(reinterpret_cast<const int32_t*>(smem_) +
             (reinterpret_cast<uintptr_t>(a.tab) & 15u) / 4),
        W(a.W) {}

  __device__ void stage(const RowArgs& a) const {
    const uintptr_t f = 15;
    const uintptr_t s = reinterpret_cast<uintptr_t>(a.tab);
    const int4* src = reinterpret_cast<const int4*>(s & ~f);
    const int64_t n16 = static_cast<int64_t>(
        ((s + 4 * static_cast<uintptr_t>(a.N) * W + f) & ~f) - (s & ~f)) / 16;
    for (int64_t i = threadIdx.x; i < n16; i += blockDim.x)
      smem[i] = __ldg(src + i);
  }

  __device__ void ready() const { __syncthreads(); }

  __device__ __forceinline__ int32_t load(int r, int w) const {
    return held[static_cast<int64_t>(r) * W + w];
  }
};

// out[m, w] = tab[idx[m * s0 + w * s1], w] from a Table; kRowIndex: s1 =
// 0 (GlobalTable only), else the contiguous (M, W) index (GlobalTable or
// BlockTable).  Each thread's first index is loaded before the table is
// ready, and the next item's index before the current item's row.
template <class Table, bool kRowIndex>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const RowArgs a) {
  extern __shared__ int4 smem4[];
  const Table t(a, smem4);
  t.stage(a);
  const int N = a.N;
  const int Q = a.vec ? a.W / 4 : a.W;  // items per output row
  const int64_t items = a.M * Q;
  if constexpr (kRowIndex) {
    ItemWalk it(Q);
    int r = it.e < items ? clamp_index(__ldg(a.idx + it.m * a.s0), N) : 0;
    t.ready();
    while (it.e < items) {
      const ItemWalk nx = it.next();
      int next_r = 0;
      if (nx.e < items) next_r = clamp_index(__ldg(a.idx + nx.m * a.s0), N);
      if (a.vec)
        reinterpret_cast<int4*>(a.out)[it.e] = t.load4(r, it.c);
      else
        a.out[it.e] = t.load(r, it.c);
      it = nx;
      r = next_r;
    }
  } else if (a.vec) {
    const int4* idx4 = reinterpret_cast<const int4*>(a.idx);
    int64_t e = first_item();
    int4 ii = make_int4(0, 0, 0, 0);
    if (e < items) ii = __ldg(idx4 + e);
    t.ready();
    while (e < items) {
      const int w0 = static_cast<int>(e % Q) * 4;
      const int64_t next = e + item_stride();
      int4 nx = make_int4(0, 0, 0, 0);
      if (next < items) nx = __ldg(idx4 + next);
      int4 v;
      v.x = t.load(clamp_index(ii.x, N), w0);
      v.y = t.load(clamp_index(ii.y, N), w0 + 1);
      v.z = t.load(clamp_index(ii.z, N), w0 + 2);
      v.w = t.load(clamp_index(ii.w, N), w0 + 3);
      reinterpret_cast<int4*>(a.out)[e] = v;
      e = next;
      ii = nx;
    }
  } else {
    int64_t e = first_item();
    int i = e < items ? __ldg(a.idx + e) : 0;
    t.ready();
    while (e < items) {
      const int w = static_cast<int>(e % Q);
      const int64_t next = e + item_stride();
      int next_i = 0;
      if (next < items) next_i = __ldg(a.idx + next);
      a.out[e] = t.load(clamp_index(i, N), w);
      e = next;
      i = next_i;
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

// The current device, checked against the per-device tables below.
int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return 0;
}

int smem_optin(int dev, int* optin) {
  return static_cast<int>(cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

// Shared-memory setup and grid size of one launch: refuses a table above
// the opt-in maximum, raises the kernel's dynamic shared-memory limit once
// per device, and sizes the grid to the blocks that fit on the card at once.
int configure(const void* fn, bool* configured, int threads, size_t smem,
              int64_t items, int* grid) {
  int dev = 0, optin = 0;
  int err = current_device(&dev);
  if (!err) err = smem_optin(dev, &optin);
  if (err) return err;
  if (smem > static_cast<size_t>(optin)) return kErrTableTooLarge;
  cudaError_t e;
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

bool configured_lane[kMaxDevices];

// One launch of gather_rows_kernel over Table.
template <class Table, bool kRowIndex>
int launch_rows(const RowArgs& a, size_t smem, cudaStream_t stream) {
  static bool configured[kMaxDevices];
  void (*fn)(const RowArgs) = gather_rows_kernel<Table, kRowIndex>;
  const int64_t items = a.vec ? a.M * (a.W / 4) : a.M * a.W;
  int grid = 0;
  const int err = configure(reinterpret_cast<const void*>(fn), configured,
                            kThreads, smem, items, &grid);
  if (err) return err;
  fn<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The design of one call on the current device (kUnstaged or kBlock, or a
// CUDA error, negated), and the shared memory a block then holds: the row
// form unstaged; the general form per block while the table fits in one
// block's opt-in shared memory, else unstaged.
int choose_design(int N, int W, bool row, size_t* smem) {
  *smem = 0;
  if (row) return kUnstaged;
  int dev = 0, optin = 0;
  int err = current_device(&dev);
  if (!err) err = smem_optin(dev, &optin);
  if (err) return -err;
  const size_t held = held_smem(static_cast<size_t>(N) * W * 4);
  if (held > static_cast<size_t>(optin)) return kUnstaged;
  *smem = held;
  return kBlock;
}

bool valid_form(int64_t s0, int64_t s1, int W) {
  return s1 == 0 || (s1 == 1 && s0 == W);
}

}  // namespace

// out[m, w] = tab[idx[m * s0 + w * s1], w] for an (N, W) int32 table:
// s1 = 0 is the row form (take: s0 = 1; taa on a broadcast index), s0 = W
// and s1 = 1 the general form (taa on a contiguous (M, W) index), in the
// design choose_design picks.  Refuses no table.
extern "C" int nimble_gather_rows(const void* tab, const void* idx, void* out,
                                  int N, int W, int64_t M, int64_t s0,
                                  int64_t s1, void* stream) {
  if (M <= 0) return 0;
  if (N < 1 || W < 1 || !valid_form(s0, s1, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool row = s1 == 0;
  const bool vec = W % 4 == 0 && aligned16(tab) && aligned16(out) &&
                   (row || aligned16(idx));
  const RowArgs a{static_cast<const int32_t*>(tab),
                  static_cast<const int32_t*>(idx),
                  static_cast<int32_t*>(out), M, s0, N, W, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  const int design = choose_design(N, W, row, &smem);
  if (design < 0) return -design;
  if (row) return launch_rows<GlobalTable, true>(a, 0, s);
  return design == kBlock ? launch_rows<BlockTable, false>(a, smem, s)
                          : launch_rows<GlobalTable, false>(a, 0, s);
}

// The design nimble_gather_rows runs for an (N, W) table in the form of
// (s0, s1) on the current device: 0 unstaged, 1 per block, writing the
// shared memory a block holds to *smem; < 0: a CUDA error code, negated.
extern "C" int nimble_gather_rows_design(int N, int W, int64_t s0, int64_t s1,
                                         int64_t* smem) {
  if (N < 1 || W < 1 || !valid_form(s0, s1, W))
    return -static_cast<int>(cudaErrorInvalidValue);
  size_t held = 0;
  const int design = choose_design(N, W, s1 == 0, &held);
  *smem = static_cast<int64_t>(held);
  return design;
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
  int dev = 0, optin = 0;
  int err = current_device(&dev);
  if (!err) err = smem_optin(dev, &optin);
  return err ? -err : optin;
}

extern "C" const char* nimble_gather_error_string(int err) {
  if (err == kErrTableTooLarge)
    return "a table row exceeds the shared memory a block can opt in to";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
