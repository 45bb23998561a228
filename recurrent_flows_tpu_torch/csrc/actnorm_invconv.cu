// The step actnorm folded into the invertible 1x1 (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/fused.py
// (_actnorm_invconv_pallas / _ainv_kernel), which runs the product on the
// MXU in 256-row tiles at any C: y = ((x + b) * e^logs) @ W^T over the rows
// of x [rows, C], no logdet. Computes what actnorm_invconv_ref
// (recurrent_flows_tpu_torch/ops/fused.py) computes.
//
// What bounds it on the H100. Each row is read once and written once
// (2 * rows * C * 4 bytes) for 2*C FLOPs per element. At the flow's shapes
// that is at most ~1 MB (0.3 microseconds at the card's memory rate) and
// ~67 MFLOP (x [512, 256]: 1.0 microseconds at its float32 rate): below
// C = 96 the bytes bound it, above the operations, and at every shape a
// launch costs more than either: its fixed latency (the launch, one trip
// to memory and back) plus the serial work the design puts on top. Two
// regimes keep that serial work short (ops/fused.py::ainv_plan picks one):
//
// The compile-time instances (C in {4, 8, 16, 32, 64}, the gray presets,
// and the RGB widths {12, 24, 48, 96} at little work: rfn_bair's serving
// scales):
//  * Compile-time width: index math is shifts and every loop unrolls. Other
//    widths <= 64 (and pointers that are not 16-byte aligned) take a
//    run-time-C instance, one thread per output element.
//  * Every thread a 4-wide output vector of one row. It reads its part of
//    the row as 16-byte loads and writes the vector as one 16-byte store.
//    From C = 32 the C-term sum of each output is split over `lanes` = 4
//    neighbouring threads (each takes every lanes-th 16-byte piece of the
//    row) and their partial sums are added by a fixed __shfl_xor_sync
//    butterfly: the dependent chain is C/lanes FMAs, not C.
//  * The grid fills the card: each block takes a few rows and a slice of
//    their output vectors (2, or the 1 of C = 4), so that every scale
//    spreads over most of the 132 SMs in one wave.
//  * No per-element fixed work. e^logs and b*e^logs are computed once per
//    channel and block, into shared memory, while the row and W loads are
//    in flight; then every element is one FMA into the folded actnorm and
//    4 FMAs into the outputs.
//  * W through the read-only path: each thread reads the pieces of the 4
//    rows of W it needs as 16-byte loads, all of them issued before the
//    barrier. Its cost grows with the rows a block holds (each thread reads
//    4 rows of W for one row of x): at the train step's RGB scales and above
//    64 channels the tile design below takes over.
//
// The tile design (ainv_kernel_tile; the RGB widths 24-96 at the train
// step's work and every C above 64) is described where it is defined.
//
// Both regimes sum each output in a fixed order, so two launches agree bit
// for bit. No tensor cores: TF32 would break the 1e-5 tolerance against
// float32, and a 3xTF32 split would not pay at ~1 MFLOP per SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxC = 64;

// The folded actnorm of channel c, once per block: scale = e^logs,
// shift = b * e^logs (the reference's (x + b) * e^logs, as x*scale + shift).
__device__ __forceinline__ void fold_actnorm(const float* __restrict__ bias,
                                             const float* __restrict__ logs,
                                             float* scale, float* shift, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float e = expf(logs[c]);
    scale[c] = e;
    shift[c] = bias[c] * e;
  }
}

// C in {4, 8, 12, 16, 24, 32, 48, 64, 96}; LANES threads share one 4-wide
// output vector.
// Block (bx, by) takes rows [bx*rows_per_block, ...) and the output vectors
// [by*groups, (by+1)*groups) of each, so it reads 4*groups rows of W.
template <int C, int LANES>
__global__ void __launch_bounds__(256)
ainv_kernel(const float4* __restrict__ x, const float* __restrict__ bias,
            const float* __restrict__ logs,
            const float4* __restrict__ w,  // [C, C/4]: y_d = sum_c w[d, c] x_c
            float4* __restrict__ y, int rows, int rows_per_block, int groups) {
  constexpr int G = C / 4;      // output vectors (and 16-byte pieces) per row
  constexpr int Q = G / LANES;  // pieces of the row per lane
  static_assert(Q * LANES == G, "lanes must divide C/4");
  __shared__ __align__(16) float scale[C], shift[C];

  const int t = threadIdx.x;
  // groups and LANES are powers of 2: so are the threads of a row
  const int row_shift = __ffs(groups * LANES) - 1;
  const int row = blockIdx.x * rows_per_block + (t >> row_shift);
  const int j = t & ((1 << row_shift) - 1);
  const int g = blockIdx.y * groups + j / LANES, lane = j % LANES;
  const bool live = row < rows;

  // every load first: the row's pieces lane, lane + LANES, ... and the
  // matching pieces of W's rows 4g .. 4g+3
  float4 xv[Q], wv[4][Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    xv[k] = live ? __ldg(x + (size_t)row * G + k * LANES + lane)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d = 0; d < 4; ++d) wv[d][k] = __ldg(w + (4 * g + d) * G + k * LANES + lane);
  }
  fold_actnorm(bias, logs, scale, shift, C);
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float4 sc = reinterpret_cast<const float4*>(scale)[k * LANES + lane];
    const float4 sh = reinterpret_cast<const float4*>(shift)[k * LANES + lane];
    const float v0 = fmaf(xv[k].x, sc.x, sh.x), v1 = fmaf(xv[k].y, sc.y, sh.y);
    const float v2 = fmaf(xv[k].z, sc.z, sh.z), v3 = fmaf(xv[k].w, sc.w, sh.w);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      acc[d] = fmaf(v0, wv[d][k].x, acc[d]);
      acc[d] = fmaf(v1, wv[d][k].y, acc[d]);
      acc[d] = fmaf(v2, wv[d][k].z, acc[d]);
      acc[d] = fmaf(v3, wv[d][k].w, acc[d]);
    }
  }
  // the lanes of one vector are neighbours in one warp, all live or all not
  if constexpr (LANES > 1) {
    const unsigned group = ((1u << LANES) - 1) << ((t & 31) & ~(LANES - 1));
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) {
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[d] += __shfl_xor_sync(group, acc[d], o);
    }
  }
  if (live && lane == 0) y[(size_t)row * G + g] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// Any C <= 64, any alignment: one thread per output element (row, d).
__global__ void __launch_bounds__(256)
ainv_kernel_any(const float* __restrict__ x, const float* __restrict__ bias,
                const float* __restrict__ logs, const float* __restrict__ w,
                float* __restrict__ y, int rows, int C, int rows_per_block) {
  __shared__ float scale[kMaxC], shift[kMaxC];
  const int row = blockIdx.x * rows_per_block + threadIdx.x / C;
  const int d = threadIdx.x % C;
  fold_actnorm(bias, logs, scale, shift, C);
  __syncthreads();
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  const float* wd = w + d * C;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(fmaf(__ldg(xr + c), scale[c], shift[c]), __ldg(wd + c), acc);
  y[(size_t)row * C + d] = acc;
}

// The tile design: the RGB widths 24, 48 and 96 at the train step's work and
// any C above 64 (and 24, 48 with aligned pointers at any work the plan
// gives it). A block computes an output tile of `tm` rows by `tn` outputs
// over all C input channels, as one small matrix product. At these sizes a
// block lives a few thousand clocks with one or two warps a scheduler, so
// what counts is the chain of instructions each thread runs (a loop of
// copies, a pass of its own, a division by a run-time width all show), and
// the design keeps it short:
//
//  * One round trip. Rows of at least 64 channels are each one bulk copy
//    into shared memory (cp.async.bulk, completing on an mbarrier; a thread
//    issues a row or two). Narrower rows (and C % 4 != 0, or x, W, y not
//    16-byte aligned) come through registers: every thread issues its loads
//    (16-byte, or 4-byte) before it stores any. At every C up to 256 one
//    stage holds all of C; beyond, two buffers take turns and the next
//    stage's bulk copies are issued before the current stage's FMAs. Rows
//    past the edge are not stored; channels past C are zeroed.
//  * The actnorm folded once per channel and block: e^logs and b*e^logs of
//    the stage's channels go to shared memory while the copies are in
//    flight; each x value is folded as it is read (x*scale + shift, the
//    scales of 4 channels one broadcast read), not in a pass of its own.
//  * A 4x4 register tile per thread: rows rg + i*tm/4 and outputs
//    cg + j*tn/4 (i, j < 4), so that the threads of a warp read neighbouring
//    rows of x and of W; rows are `stride` floats apart, stride/4 odd, so 8
//    neighbouring rows' 16-byte pieces fall in distinct banks. Per 4 channels
//    a thread reads 2 + 4 + 4 16-byte pieces and does 64 FMAs and 16 folds.
//  * A split of the C-sum. `lanes` groups of threads take `kc / lanes`
//    consecutive channels of each stage, so that a block has enough warps
//    at small tiles; their partial sums are added in shared memory by a
//    fixed tree (lane l + lanes/2 into l, halving). Each output is summed
//    over c ascending within a lane, then by the tree.
//  * At the flow's widths (24, 48, 96, 128, 192, 256) and lanes 1-8, C and
//    the lanes are compile-time constants: index math by constants, the
//    FMA loop and the tree unrolled.
constexpr int kTileThreads = 256;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on the H100

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Floats between two staged rows: kc rounded up to an odd number of 4s.
__host__ __device__ constexpr int tile_stride(int kc) { return kc + ((kc / 4) % 2 ? 0 : 4); }

// Dynamic shared memory of a tile (floats): one or two stage buffers of x
// and W rows, the stage's scales and shifts; the lanes' partial sums reuse it.
__host__ __device__ inline int tile_smem_floats(int tm, int tn, int lanes, int kc, int C) {
  const int buffers = kc < C ? 2 : 1;
  const int stage = buffers * (tm + tn) * tile_stride(kc) + 2 * kc;
  const int partials = lanes > 1 ? lanes * tm * tn : 0;
  return stage > partials ? stage : partials;
}

// CT, LT: C and lanes at compile time (one stage, kc = C: index math by
// constants, the FMA loop and the tree unrolled), or 0: at run time. VEC:
// 16-byte copies; BULK (VEC, and rows of at least 64 channels or several
// stages): one bulk copy per row.
template <bool VEC, int CT, int LT>
__global__ void __launch_bounds__(kTileThreads)
ainv_kernel_tile(const float* __restrict__ x, const float* __restrict__ bias,
                 const float* __restrict__ logs, const float* __restrict__ w,
                 float* __restrict__ y, int rows, int C_, int tm, int tn, int lanes_, int kc_) {
  constexpr bool BULK = VEC && (CT == 0 || CT >= 64);
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long bars[2];  // BULK: one per stage buffer
  const int C = CT ? CT : C_, lanes = LT ? LT : lanes_, kc = CT ? CT : kc_;
  const int stride = tile_stride(kc), buffer = (tm + tn) * stride;
  const int stages = (C + kc - 1) / kc;
  float* scale = smem + (stages > 1 ? 2 : 1) * buffer;  // [kc]
  float* shift = scale + kc;                             // [kc]

  const int t = threadIdx.x, nt = blockDim.x;
  const int r0 = blockIdx.x * tm, n0 = blockIdx.y * tn;
  const int ng = tn / 4, rgs = tm / 4;
  const int cg = t % ng, rg = (t / ng) % rgs, lane = t / (ng * rgs);
  const int ks = kc / lanes;
  const int x_rows = min(tm, rows - r0), w_rows = min(tn, C - n0);  // rows to copy

  // BULK: each thread that copies rows arrives on the stage's mbarrier,
  // expecting its own bytes, before it issues its copies
  const int copies = x_rows + w_rows, copiers = min(nt, copies);
  if constexpr (BULK) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bars[0])),
                   "r"(copiers));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bars[1])),
                   "r"(copiers));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // stage s into buffer s % 2: rows 0..tm-1 of x, then tm.. of W, each
  // `stride` floats apart; channels past C zeroed. BULK: copies in flight
  // until bar_wait; else loaded and stored here, 8 quads a thread at a time
  auto issue = [&](int s) {
    float* buf = smem + (s & 1) * buffer;
    const int c0 = s * kc, width = min(kc, C - c0);
    if constexpr (BULK) {
      if (t < copiers) bar_expect(&bars[s & 1], (copies - t + nt - 1) / nt * width * 4);
      for (int h = t; h < copies; h += nt) {
        const bool is_x = h < x_rows;
        const float* src = is_x ? x + (size_t)(r0 + h) * C + c0
                                : w + (size_t)(n0 + h - x_rows) * C + c0;
        bulk_copy(buf + (is_x ? h : tm + h - x_rows) * stride, src, width * 4, &bars[s & 1]);
      }
      if (width < kc) {
        for (int v = t; v < (tm + tn) * (kc - width); v += nt) {
          const int h = v / (kc - width);
          buf[h * stride + width + v - h * (kc - width)] = 0.f;
        }
      }
    } else {
      const int quads = kc / 4, n = (tm + tn) * quads;
      for (int base = t; base < n; base += 8 * nt) {
        float4 r[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int v = base + u * nt;
          if (v >= n) break;
          const int h = v / quads, c = c0 + 4 * (v - h * quads);
          const bool is_x = h < tm;
          const int row = is_x ? r0 + h : n0 + h - tm;
          const float* p = (is_x ? x : w) + (size_t)row * C + c;
          const bool live = row < (is_x ? rows : C);
          if constexpr (VEC) {
            r[u] = live && c < C ? __ldg(reinterpret_cast<const float4*>(p))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            r[u].x = live && c < C ? __ldg(p) : 0.f;
            r[u].y = live && c + 1 < C ? __ldg(p + 1) : 0.f;
            r[u].z = live && c + 2 < C ? __ldg(p + 2) : 0.f;
            r[u].w = live && c + 3 < C ? __ldg(p + 3) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int v = base + u * nt;
          if (v >= n) break;
          const int h = v / quads;
          *reinterpret_cast<float4*>(buf + h * stride + 4 * (v - h * quads)) = r[u];
        }
      }
    }
  };

  float acc[4][4] = {};
  issue(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) issue(s + 1);
    const int c0 = s * kc;
    // the folded actnorm of the stage's channels while its copies are in
    // flight; 0 past C
    for (int k = t; k < kc; k += nt) {
      const int c = c0 + k;
      const float e = c < C ? expf(logs[c]) : 0.f;
      scale[k] = e;
      shift[k] = c < C ? bias[c] * e : 0.f;
    }
    if constexpr (BULK) bar_wait(&bars[s & 1], (s >> 1) & 1);
    __syncthreads();
    const float* xs = smem + (s & 1) * buffer;
    const float* xp = xs + rg * stride + lane * ks;
    const float* wp = xs + (tm + cg) * stride + lane * ks;
    const float* sp = scale + lane * ks;
    const float* hp = shift + lane * ks;
#pragma unroll 4
    for (int k = 0; k < ks; k += 4) {
      const float4 sc = *reinterpret_cast<const float4*>(sp + k);
      const float4 sh = *reinterpret_cast<const float4*>(hp + k);
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(xp + i * rgs * stride + k);
        b[i] = *reinterpret_cast<const float4*>(wp + i * ng * stride + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = make_float4(fmaf(a[i].x, sc.x, sh.x), fmaf(a[i].y, sc.y, sh.y),
                           fmaf(a[i].z, sc.z, sh.z), fmaf(a[i].w, sc.w, sh.w));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // this buffer and the scales are refilled by later stages
  }

  if (lanes == 1) {  // rows r0 + rg + i*rgs, outputs n0 + cg + j*ng
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + rg + i * rgs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = n0 + cg + j * ng;
        if (row < rows && d < C) y[(size_t)row * C + d] = acc[i][j];
      }
    }
    return;
  }
  float* part = smem;  // [lanes][tm][tn]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(lane * tm + rg + i * rgs) * tn + cg + j * ng] = acc[i][j];
  }
  const int quads = tm * tn / 4;
#pragma unroll
  for (int half = lanes / 2; half >= 1; half /= 2) {
    __syncthreads();
    for (int v = t; v < half * quads; v += nt) {
      float4* p = reinterpret_cast<float4*>(part) + v;
      const float4 q = p[half * quads];
      *p = make_float4(p->x + q.x, p->y + q.y, p->z + q.z, p->w + q.w);
    }
  }
  __syncthreads();
  for (int v = t; v < quads; v += nt) {  // outputs 4v .. 4v+3 of the tile
    const int m = v / ng, row = r0 + m, d = n0 + 4 * (v - m * ng);
    if (row >= rows || d >= C) continue;
    const float4 s = reinterpret_cast<const float4*>(part)[v];
    float* out = y + (size_t)row * C + d;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(out) = s;
    } else {
      const float e[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && d + j < C; ++j) out[j] = e[j];
    }
  }
}

template <bool VEC, int CT, int LT>
cudaError_t launch_tile(const float* x, const float* bias, const float* logs, const float* w,
                        float* y, int rows, int C, int tm, int tn, int lanes, int kc,
                        cudaStream_t stream) {
  if ((CT && (C != CT || kc != CT)) || (LT && lanes != LT)) return cudaErrorInvalidValue;
  const int threads = lanes * (tm / 4) * (tn / 4);
  if (tm < 4 || tm % 4 || tn < 4 || tn % 4 || lanes < 1 || (lanes & (lanes - 1)) ||
      threads > kTileThreads || kc < 4 * lanes || kc % (4 * lanes))
    return cudaErrorInvalidValue;
  const int smem = 4 * tile_smem_floats(tm, tn, lanes, kc, C);
  if (smem > kMaxSmem - 64) return cudaErrorInvalidValue;  // 64: the static mbarriers
  // above 48 KB a block's shared memory must be asked for; once per device
  static bool asked[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 - 64 && dev < 64 && !asked[dev]) {
    err = cudaFuncSetAttribute(ainv_kernel_tile<VEC, CT, LT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - 64);
    if (err != cudaSuccess) return err;
    asked[dev] = true;
  }
  const dim3 blocks((rows + tm - 1) / tm, (C + tn - 1) / tn);
  ainv_kernel_tile<VEC, CT, LT><<<blocks, threads, smem, stream>>>(x, bias, logs, w, y, rows,
                                                                    C, tm, tn, lanes, kc);
  return cudaGetLastError();
}

// The flow's widths from 24 up, each at the lanes ops/fused.py::ainv_plan may
// give it, take an instance of compile-time C and lanes (16-byte copies);
// every other case the run-time one.
template <int CT>
cudaError_t launch_tile_c(const float* x, const float* bias, const float* logs, const float* w,
                          float* y, int rows, int tm, int tn, int lanes, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_tile<true, CT, 1>(x, bias, logs, w, y, rows, CT, tm, tn, 1, CT, s);
    case 2: return launch_tile<true, CT, 2>(x, bias, logs, w, y, rows, CT, tm, tn, 2, CT, s);
    case 4:
      if constexpr (CT % 16 == 0)
        return launch_tile<true, CT, 4>(x, bias, logs, w, y, rows, CT, tm, tn, 4, CT, s);
      break;
    case 8:
      if constexpr (CT % 32 == 0)
        return launch_tile<true, CT, 8>(x, bias, logs, w, y, rows, CT, tm, tn, 8, CT, s);
      break;
  }
  return launch_tile<true, 0, 0>(x, bias, logs, w, y, rows, CT, tm, tn, lanes, CT, s);
}

// The lanes of each output vector at width C: 4 from C = 32, else 1 (one
// instance per width; ops/fused.py::ainv_plan gives the same).
template <int C>
constexpr int kLanes = C >= 32 ? 4 : 1;

template <int C>
cudaError_t launch(int lanes, const float* x, const float* bias, const float* logs,
                   const float* w, float* y, int rows, int rows_per_block,
                   int groups, cudaStream_t stream) {
  constexpr int LANES = kLanes<C>;
  if (lanes != LANES || groups < 1 || (C / 4) % groups || (groups & (groups - 1)))
    return cudaErrorInvalidValue;
  const int threads = rows_per_block * groups * LANES;
  const dim3 blocks((rows + rows_per_block - 1) / rows_per_block, C / 4 / groups);
  ainv_kernel<C, LANES><<<blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), bias, logs,
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(y), rows,
      rows_per_block, groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* actnorm_invconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y[rows, C] = ((x + bias) * exp(logs)) @ w^T on `stream`, with the
// geometry of ops/fused.py::ainv_plan. `vec` 1 takes the compile-time-width
// instance (C in {4, 8, 12, 16, 24, 32, 48, 64, 96}, 16-byte aligned pointers) with
// `lanes` threads per output vector (kLanes<C>, checked) and `groups` 4-wide
// output vectors of each of a block's `rows_per_block` rows (a power-of-2
// divisor of C/4); 0 the run-time-C one (C <= 64, whole rows per block); 2
// the tile design (any C): a block takes a tile of `rows_per_block` rows by
// 4 * `groups` outputs, `lanes` threads share each output's C-sum, `k_stage`
// channels come in per stage, and 16-byte loads are taken where C % 4 == 0
// and x, w, y are 16-byte aligned. Returns the cudaError_t of the launch (0
// on success).
int actnorm_invconv_launch(const float* x, const float* bias,
                           const float* logs, const float* w, float* y,
                           int rows, int C, int vec, int lanes,
                           int rows_per_block, int groups, int k_stage, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (rows < 1 || C < 1 || rows_per_block < 1) return err;
  if (vec == 2) {
    const bool vec16 = C % 4 == 0 &&
        ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
          reinterpret_cast<size_t>(y)) & 15) == 0;
    const int tn = 4 * groups;
    if (!vec16)
      return static_cast<int>(launch_tile<false, 0, 0>(x, bias, logs, w, y, rows, C,
                                                       rows_per_block, tn, lanes, k_stage, s));
    if (k_stage == C) {
      switch (C) {
        case 24: return launch_tile_c<24>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
        case 48: return launch_tile_c<48>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
        case 96: return launch_tile_c<96>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
        case 128: return launch_tile_c<128>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
        case 192: return launch_tile_c<192>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
        case 256: return launch_tile_c<256>(x, bias, logs, w, y, rows, rows_per_block, tn, lanes, s);
      }
    }
    return static_cast<int>(launch_tile<true, 0, 0>(x, bias, logs, w, y, rows, C, rows_per_block,
                                                    tn, lanes, k_stage, s));
  }
  if (!vec) {
    if (C > kMaxC) return err;
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    ainv_kernel_any<<<blocks, rows_per_block * C, 0, s>>>(x, bias, logs, w, y,
                                                          rows, C, rows_per_block);
    return static_cast<int>(cudaGetLastError());
  }
  switch (C) {
    case 4: err = launch<4>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 8: err = launch<8>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 12: err = launch<12>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 16: err = launch<16>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 24: err = launch<24>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 48: err = launch<48>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 96: err = launch<96>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 32: err = launch<32>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 64: err = launch<64>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
