// double_walk.cu: the walk recurrence over precomputed masks, for Hopper
// (sm_90a).  Built by nimble_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes by nimble_tpu_torch/ops/double_walk.py
// (double_walk), which allocates the outputs, checks every argument and
// picks the tile size.
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
// (ops/span_walk.py, rel_walk_masks) in its (B, C, T) order, as int8 0/1
// values: the function is defined on 0/1 masks (the Pallas kernel
// multiplies them), and the kernel reads bit 0 of each byte.  They are
// otherwise arbitrary: match need not lie within alive and alive need not
// be an interval, so nothing is folded into intervals as in
// fused_span_walk.cu.
//
// What bounds it on the H100.  The bytes: 2*B*C*(T+Tl) + B*(T+Tl) mask
// bytes, 17.5 MB per 8192-read launch at C = 8, T = Tl = 62, 5.2 us of HBM
// time at 3.35 TB/s; the masks fit in the 50 MB L2, so a caller that has
// just written them reads them faster.  The earlier design of this kernel
// (one warp lane per candidate, three 1-byte loads and two votes per step,
// the lanes of a warp T bytes apart) paid about 124 load latencies in series
// per warp instead.
// What remains (PERF.md section 6): each read's 124 steps are a serial
// chain, and the pack's 4-byte shared loads (two words and a funnel shift
// per candidate and 4 steps) sit between a tile's arrival and its first
// step.
//
// Design: the masks are streamed in bulk and walked as bits, one thread per
// read.
// - Tiles.  R reads (R <= 32, picked by the wrapper to fit the shared
//   memory) are one contiguous byte range in each mask tensor of one walk:
//   R*C*S bytes of alive and of match, R*S of active (S = T or Tl).  A block
//   is persistent: it takes tiles blockIdx.x, +gridDim.x, ..., each tile
//   two items, its forward walk and its left walk (at B = 8192, C = 8 one
//   tile of 32 reads per block, all blocks resident at once).
// - Staging.  An item's three ranges come into shared memory by three TMA
//   bulk copies (cp.async.bulk) completing on one mbarrier, each over the
//   range's 16-byte aligned envelope: every 16 bytes so copied hold a byte
//   of the tensor, so no copy leaves its pages, and a base pointer that is
//   not 16-byte aligned (the slice x[1:]) needs no head or tail.  Two
//   buffers: item j + 1 is issued as soon as item j has landed (not
//   before, so that the forward walk's bytes are not shared out with the
//   left walk's), and lands while item j is packed and walked.
// - Pack once.  Warps 1..7 turn each (read, 4 steps) cell of a landed item
//   into bit words: per candidate a 4-byte load and x << c (bit c of each
//   step byte; no compare, the bytes are 0/1), the active bytes times 0xff
//   masking both, so an inactive step becomes a step with no alive and no
//   match candidate, which changes nothing.  The words are byte planes (8
//   candidates a plane, ceil(C/8) planes), at an odd read stride, so the
//   walk's loads are free of bank conflicts.  Two sets of words: the
//   packers fill item j + 1's while item j is walked.
// - Walk from bits.  Warp 0 walks: thread r walks read r, live a C-bit word
//   in a register, a step la = live & a, lm = live & m and two selects, 4
//   steps a group without a branch; no vote and no global load.
// - Edges: any T, Tl >= 0 (a walk of 0 steps copies and walks nothing), C
//   from 1 to 32 (CG planes, a template argument; candidates past C in the
//   last plane are masked, not branched on), B not a multiple of R (the
//   last tile is short).  A tile of one read over the card's opt-in shared
//   memory is refused by the wrapper (ValueError).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // warp 0 walks, warps 1..7 pack
constexpr int kWalkers = 32;  // one walker warp: at most 32 reads a tile
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kSlack = 48;  // envelope rounding and the funnel's last word
constexpr int kBarBytes = 16;  // one mbarrier per staging buffer

struct Args {
  const int8_t* alive[2];   // forward, left: (B, C, S)
  const int8_t* match[2];   // (B, C, S)
  const int8_t* active[2];  // (B, S)
  const int8_t* live0;      // (B, C)
  int8_t* live_out;         // (B, C)
  int32_t* score_out;       // (B,)
  int32_t* mm_out;          // (B,)
  int B, C, R;
  int steps[2];             // T, Tl
};

// Shared-memory layout of one launch, in bytes (all offsets 16-aligned):
// two mbarriers; two staging buffers of one item's (alive, match, active);
// two sets of packed words, each CG byte planes of alive and of match, R
// reads at a stride of Gp (odd) 4-step words.  The wrapper's smem_bytes
// mirrors it.
struct Layout {
  int Gp, CG;  // read stride in 4-step words; planes
  int mask_bytes, active_bytes, buffer_bytes, plane_words;
  __host__ __device__ Layout(int R, int C, int T, int Tl) {
    const int S = T > Tl ? T : Tl;
    Gp = (S + 3) / 4 | 1;
    CG = (C + 7) / 8;
    mask_bytes = (R * C * S + kSlack + 15) / 16 * 16;
    active_bytes = (R * S + kSlack + 15) / 16 * 16;
    buffer_bytes = 2 * mask_bytes + active_bytes;
    plane_words = R * Gp;
  }
  __host__ __device__ int buffer_offset(int w) const {
    return kBarBytes + w * buffer_bytes;
  }
  __host__ __device__ int words_offset() const { return buffer_offset(2); }
  __host__ __device__ size_t total() const {
    return static_cast<size_t>(words_offset()) +
           2 * 2 * static_cast<size_t>(CG) * plane_words * 4;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 16-byte aligned envelope of bytes [off, off + len) of src: its first
// address (*a0) and its size in bytes (0 for an empty range).  Every 16
// bytes of it hold a byte of the range, so a copy of it stays within the
// tensor's pages.
__device__ __forceinline__ unsigned envelope(const int8_t* src, int64_t off,
                                             int64_t len, uintptr_t* a0) {
  const uintptr_t f = 15;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src + off);
  *a0 = s & ~f;
  return len > 0 ? static_cast<unsigned>(((s + len + f) & ~f) - *a0) : 0u;
}

// The range's offset within its envelope, where the packers find it.
__device__ __forceinline__ int lead_of(const int8_t* src, int64_t off) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src + off) & 15);
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0u;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 4 bytes at byte offset p of a shared buffer, any alignment.
__device__ __forceinline__ uint32_t load4(const uint32_t* w, int p) {
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1],
                         8u * static_cast<unsigned>(p & 3));
}

// One step of the walk on the step's alive and match bits (active folded
// in).
__device__ __forceinline__ void walk_step(uint32_t& live, int& score, int& mm,
                                          uint32_t a, uint32_t m) {
  const uint32_t la = live & a;
  const uint32_t lm = live & m;
  const bool act = la != 0u;
  const bool hit = lm != 0u;
  live = act ? (hit ? lm : la) : live;
  score += (act && hit) ? 1 : 0;
  mm += (act && !hit) ? 1 : 0;
}

// Step q (0..3) of a 4-step group: byte q of each plane, plane k at bits
// 8k..8k+7.
template <int CG>
__device__ __forceinline__ uint32_t step_bits(const uint32_t (&w)[CG], int q) {
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < CG; ++k) v |= ((w[k] >> (8 * q)) & 0xffu) << (8 * k);
  return v;
}

template <int CG>
__global__ void __launch_bounds__(kThreads) double_walk_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout lay(a.R, a.C, a.steps[0], a.steps[1]);
  const int C = a.C;
  const int R = a.R;
  const int64_t tiles = (static_cast<int64_t>(a.B) + R - 1) / R;
  if (blockIdx.x >= tiles) return;
  const int64_t items =
      2 * ((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const unsigned bar0 = smem_addr(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + lay.words_offset());
  const int tid = threadIdx.x;
  constexpr int kIssuer = kWalkers;  // the first packer thread

  // item j: tile blockIdx.x + (j / 2) * gridDim.x, walk j % 2 (0 forward,
  // 1 left), staged in buffer j % 2 (the buffer of one walk)
  const auto first_read = [&](int64_t j) {
    return (blockIdx.x + (j >> 1) * gridDim.x) * static_cast<int64_t>(R);
  };
  const auto reads_in = [&](int64_t b0) {
    return static_cast<int>(a.B - b0 < R ? a.B - b0 : R);
  };
  const auto issue = [&](int64_t j) {  // one thread: the TMA copies of item j
    const int w = static_cast<int>(j & 1);
    const int64_t b0 = first_read(j);
    const int64_t nr = reads_in(b0);
    const int64_t S = a.steps[w];
    const unsigned bar = bar0 + 8 * w;
    const int8_t* src[3] = {a.alive[w], a.match[w], a.active[w]};
    const int64_t unit[3] = {C * S, C * S, S};  // bytes per read
    uint8_t* buf = smem + lay.buffer_offset(w);
    uint8_t* dst[3] = {buf, buf + lay.mask_bytes, buf + 2 * lay.mask_bytes};
    uintptr_t a0[3];
    unsigned size[3];
    unsigned bytes = 0u;
    for (int i = 0; i < 3; ++i) {
      size[i] = envelope(src[i], b0 * unit[i], nr * unit[i], &a0[i]);
      bytes += size[i];
    }
    // the expected bytes first: a copy may complete before its arrival
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    for (int i = 0; i < 3; ++i) {
      if (size[i] == 0u) continue;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst[i])),
          "l"(a0[i]), "r"(size[i]), "r"(bar)
          : "memory");
    }
  };

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == kIssuer) issue(0);

  uint32_t live = 0u;
  int score = 0, mm = 0;
  for (int64_t j = 0; j < items; ++j) {
    const int w = static_cast<int>(j & 1);
    const int64_t b0 = first_read(j);
    const int nr = reads_in(b0);
    const int S = a.steps[w];
    const int G = (S + 3) / 4;
    uint32_t* plane_a = words + (w * 2) * lay.CG * lay.plane_words;
    uint32_t* plane_m = plane_a + lay.CG * lay.plane_words;
    if (tid >= kWalkers) {
      // pack item j: cell (read r, steps 4g..4g+3), g fastest
      bar_wait(bar0 + 8 * w, static_cast<unsigned>((j >> 1) & 1));
      if (tid == kIssuer && j + 1 < items) {
        // item j has landed and item j - 1 was packed before the last
        // barrier: the other buffer takes item j + 1 while j is worked on
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(j + 1);
      }
      const uint8_t* buf = smem + lay.buffer_offset(w);
      const uint32_t* wa = reinterpret_cast<const uint32_t*>(buf);
      const uint32_t* wm =
          reinterpret_cast<const uint32_t*>(buf + lay.mask_bytes);
      const uint32_t* wx =
          reinterpret_cast<const uint32_t*>(buf + 2 * lay.mask_bytes);
      const int64_t S64 = S;
      const int lda = lead_of(a.alive[w], b0 * C * S64);
      const int ldm = lead_of(a.match[w], b0 * C * S64);
      const int ldx = lead_of(a.active[w], b0 * S64);
      // this thread's cells: from its own index, kPackers cells apart
      constexpr int kPackers = kThreads - kWalkers;
      const int Gd = G > 0 ? G : 1;  // a walk of 0 steps packs nothing
      const int dr = kPackers / Gd;
      const int dg = kPackers % Gd;
      int r = G > 0 ? (tid - kWalkers) / Gd : nr;
      int g = (tid - kWalkers) % Gd;
      for (; r < nr; r += dr, g += dg) {
        if (g >= G) {
          g -= G;
          if (++r >= nr) break;
        }
        // 0/1 bytes: 0x00 or 0xff per active step
        const uint32_t act = load4(wx, ldx + r * S + 4 * g) * 0xffu;
#pragma unroll
        for (int k = 0; k < CG; ++k) {
          uint32_t acc_a = 0u, acc_m = 0u;  // byte q: step 4g+q, bit c
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            // candidates past C (in the last group) read candidate C - 1
            // and are masked out: no branch
            const int cc = 8 * k + c < C ? 8 * k + c : C - 1;
            const uint32_t keep = 8 * k + c < C ? ~0u : 0u;
            const int p = (r * C + cc) * S + 4 * g;
            acc_a |= (load4(wa, lda + p) << c) & keep;
            acc_m |= (load4(wm, ldm + p) << c) & keep;
          }
          plane_a[k * lay.plane_words + r * lay.Gp + g] = acc_a & act;
          plane_m[k * lay.plane_words + r * lay.Gp + g] = acc_m & act;
        }
      }
    }
    // words of item j complete, buffer j % 2 read; the walk of item j - 1
    // (the other words) done
    __syncthreads();
    if (tid < nr) {
      // walk item j, while the packers go on to item j + 1
      const int r = tid;
      const int64_t b = b0 + r;
      if (w == 0) {
        live = 0u;
        for (int c = 0; c < C; ++c)
          live |= (__ldg(a.live0 + b * C + c) != 0 ? 1u : 0u) << c;
        score = 0;
        mm = 0;
      }
      const uint32_t* ra = plane_a + r * lay.Gp;
      const uint32_t* rm = plane_m + r * lay.Gp;
      uint32_t x[CG], y[CG];
      const auto load_group = [&](int g) {
#pragma unroll
        for (int k = 0; k < CG; ++k) {
          x[k] = ra[k * lay.plane_words + g];
          y[k] = rm[k * lay.plane_words + g];
        }
      };
      const int full = S >> 2;
#pragma unroll 4
      for (int g = 0; g < full; ++g) {  // 4 steps a group, no branch
        load_group(g);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          walk_step(live, score, mm, step_bits<CG>(x, q), step_bits<CG>(y, q));
      }
      if (S & 3) {
        load_group(full);
        for (int q = 0; q < (S & 3); ++q)
          walk_step(live, score, mm, step_bits<CG>(x, q), step_bits<CG>(y, q));
      }
      if (w == 1) {
        for (int c = 0; c < C; ++c)
          a.live_out[b * C + c] = static_cast<int8_t>((live >> c) & 1u);
        a.score_out[b] = score;
        a.mm_out[b] = mm;
      }
    }
  }
}

template <int CG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Layout lay(a.R, a.C, a.steps[0], a.steps[1]);
  const size_t smem = lay.total();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > kDefaultSmem) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    // the device's maximum every time: idempotent across host threads
    e = cudaFuncSetAttribute(double_walk_kernel<CG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return e;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, double_walk_kernel<CG>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (static_cast<int64_t>(a.B) + a.R - 1) / a.R;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = tiles < resident ? tiles : resident;
  double_walk_kernel<CG><<<static_cast<unsigned>(grid), kThreads, smem,
                           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nimble_double_walk(
    const void* f_alive, const void* f_match, const void* f_active,
    const void* l_alive, const void* l_match, const void* l_active,
    const void* live0, void* live_out, void* score_out, void* mm_out,
    int B, int C, int T, int Tl, int R, void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || C > 32 || T < 0 || Tl < 0 || R < 1 || R > kWalkers)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{{static_cast<const int8_t*>(f_alive),
                static_cast<const int8_t*>(l_alive)},
               {static_cast<const int8_t*>(f_match),
                static_cast<const int8_t*>(l_match)},
               {static_cast<const int8_t*>(f_active),
                static_cast<const int8_t*>(l_active)},
               static_cast<const int8_t*>(live0),
               static_cast<int8_t*>(live_out),
               static_cast<int32_t*>(score_out),
               static_cast<int32_t*>(mm_out),
               B, C, R, {T, Tl}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((C + 7) / 8) {
    case 1: e = launch<1>(a, s); break;
    case 2: e = launch<2>(a, s); break;
    case 3: e = launch<3>(a, s); break;
    default: e = launch<4>(a, s); break;
  }
  return static_cast<int>(e);
}

// Shared memory of one launch with tiles of R reads (the wrapper checks its
// own mirror of Layout against it).
extern "C" int64_t nimble_double_walk_smem(int R, int C, int T, int Tl) {
  return static_cast<int64_t>(Layout(R, C, T, Tl).total());
}

extern "C" const char* nimble_double_walk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
