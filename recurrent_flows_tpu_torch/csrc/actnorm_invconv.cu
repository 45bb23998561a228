// The step actnorm folded into the invertible 1x1 (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/fused.py
// (_actnorm_invconv_pallas / _ainv_kernel): y = ((x + b) * e^logs) @ W^T over
// the rows of x [rows, C], no logdet. Computes what actnorm_invconv_ref
// (recurrent_flows_tpu_torch/ops/fused.py) computes.
//
// Two regimes. At the widths of the gray and RGB presets up to 96 channels
// (4-64 for rfn_mnist_production and rfn_kth, 12-96 for rfn_bair), and at
// any other C up to 64, the kernels below hold a row and the rows of W they
// need in registers; above that (any gray config with L >= 6 reaches 128,
// RGB at L = 5 reaches 192) ainv_kernel_wide streams W in tiles through
// shared memory, for any C.
//
// What bounds it on the H100, up to C = 64: the launch. Each row is read once and written
// once (2 * rows * C * 4 bytes) for 2*C FLOPs per element, C <= 64: at the
// five scales of rfn_mnist_production ([30720, 4] .. [120, 64]) 0.06-0.98 MB,
// under 0.3 microseconds at the card's memory rate, and at most ~1 MFLOP. So
// a launch costs its fixed latency (the launch itself, one trip to memory
// and back) plus whatever serial work the design puts on top of it; the
// design keeps that serial work short:
//
//  * Compile-time width. The kernel is a template on C in {4, 8, 16, 32, 64}
//    and the RGB widths {12, 24, 48, 96}: index math is shifts and every
//    loop unrolls. Other widths <= 64 (and pointers that are not 16-byte
//    aligned) take a run-time-C instance, one thread per output element.
//  * Every thread a 4-wide output vector of one row. It reads its part of
//    the row as 16-byte loads and writes the vector as one 16-byte store.
//    From C = 32 the C-term sum of each output is split over `lanes` = 4
//    neighbouring threads (each takes every lanes-th 16-byte piece of the
//    row) and their partial sums are added by a fixed __shfl_xor_sync
//    butterfly: the dependent chain is C/lanes FMAs, not C.
//  * The grid fills the card. ops/fused.py::ainv_plan gives each block a few
//    rows and a slice of their output vectors (2, or the 1 of C = 4), so that
//    every scale spreads over most of the 132 SMs in one wave.
//  * No per-element fixed work. e^logs and b*e^logs are computed once per
//    channel and block, into shared memory, while the row and W loads are
//    in flight; then every element is one FMA into the folded actnorm and
//    4 FMAs into the outputs.
//  * W through the read-only path: each thread reads the pieces of the 4
//    rows of W it needs as 16-byte loads, all of them issued before the
//    barrier; a block computes `groups` output vectors of its rows, so it
//    reads 4*groups rows of W (at most 16 KB in all, L1/L2-resident after
//    the first block). Staging those rows in shared memory by cp.async,
//    overlapped with the row loads, measured slower at 4 of the 5 scales
//    (PERF.md).
//  * Sums in a fixed order (c ascending within a lane, then the butterfly),
//    so two launches agree bit for bit.
//  * No tensor cores: at 2*C FLOPs per element a launch is at most ~1 MFLOP,
//    and TF32 would break the 1e-5 tolerance against float32.

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

// C > 64, any C: the rows' x and W do not fit a thread's registers, and
// C*C floats of W (256 KB at C = 256) not one block's shared memory. So a
// block takes an output tile of `rows_per_block` (<= kWideRows) rows by
// kWideCols outputs, and streams the C input channels through shared memory
// kWideK at a time: the tile's rows of x (the actnorm folded in as they
// are stored) and W's kWideCols x kWideK block, stored transposed so that a
// thread reads its 4 outputs' weights as one 16-byte load. Each thread
// computes one 4-wide output vector of one row (a row's 8 threads share
// its x, a warp's 4 rows share the weights), summing c in ascending order,
// so two launches agree bit for bit. Loads are scalar and guarded: any C,
// any alignment, ragged rows and a ragged last tile.
constexpr int kWideRows = 32, kWideCols = 32, kWideK = 32;
constexpr int kWideStride = kWideK + 4;  // 16-byte aligned rows, 4 mod 32 banks

__global__ void __launch_bounds__(kWideRows * kWideCols / 4)
ainv_kernel_wide(const float* __restrict__ x, const float* __restrict__ bias,
                 const float* __restrict__ logs, const float* __restrict__ w,
                 float* __restrict__ y, int rows, int C, int rows_per_block) {
  __shared__ __align__(16) float xs[kWideRows][kWideStride];   // [row][k]
  __shared__ __align__(16) float wt[kWideK][kWideCols + 4];    // [k][d]
  const int t = threadIdx.x, nt = blockDim.x;
  const int r0 = blockIdx.x * rows_per_block, d0 = blockIdx.y * kWideCols;
  const int ty = t / (kWideCols / 4), tx = t % (kWideCols / 4);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += kWideK) {
    for (int i = t; i < rows_per_block * kWideK; i += nt) {
      const int r = i / kWideK, k = i % kWideK, c = c0 + k;
      float v = 0.f;
      if (r0 + r < rows && c < C) {
        const float e = expf(__ldg(logs + c));
        v = fmaf(__ldg(x + (size_t)(r0 + r) * C + c), e, __ldg(bias + c) * e);
      }
      xs[r][k] = v;
    }
    for (int i = t; i < kWideCols * kWideK; i += nt) {
      const int d = i / kWideK, k = i % kWideK;
      wt[k][d] = (d0 + d < C && c0 + k < C) ? __ldg(w + (size_t)(d0 + d) * C + c0 + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWideK; k += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[ty][k]);
      const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(&wt[k + kk][4 * tx]);
        acc[0] = fmaf(xk[kk], wv.x, acc[0]);
        acc[1] = fmaf(xk[kk], wv.y, acc[1]);
        acc[2] = fmaf(xk[kk], wv.z, acc[2]);
        acc[3] = fmaf(xk[kk], wv.w, acc[3]);
      }
    }
    __syncthreads();
  }
  const int row = r0 + ty;
  if (row >= rows) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = d0 + 4 * tx + j;
    if (d < C) y[(size_t)row * C + d] = acc[j];
  }
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
// geometry of ops/fused.py::ainv_plan: `vec` 1 takes the compile-time-width
// instance (C in {4, 8, 12, 16, 24, 32, 48, 64, 96}, 16-byte aligned pointers) with `lanes`
// threads per output vector (kLanes<C>, checked), 0 the run-time-C one
// (C <= 64), 2 the tiled one (any C; `groups` must be kWideCols/4 and
// `lanes` 1); a block takes `rows_per_block` rows, and `groups` 4-wide
// output vectors of each (a power-of-2 divisor of C/4; the run-time-C
// instance takes whole rows). Returns the cudaError_t of the launch (0 on
// success).
int actnorm_invconv_launch(const float* x, const float* bias,
                           const float* logs, const float* w, float* y,
                           int rows, int C, int vec, int lanes,
                           int rows_per_block, int groups, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (rows < 1 || C < 1 || rows_per_block < 1) return err;
  if (vec == 2) {
    if (lanes != 1 || groups != kWideCols / 4 || rows_per_block > kWideRows) return err;
    const dim3 blocks((rows + rows_per_block - 1) / rows_per_block,
                      (C + kWideCols - 1) / kWideCols);
    ainv_kernel_wide<<<blocks, rows_per_block * groups, 0, s>>>(x, bias, logs, w, y,
                                                               rows, C, rows_per_block);
    return static_cast<int>(cudaGetLastError());
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
    case 12: err = launch<12>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 24: err = launch<24>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 48: err = launch<48>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 96: err = launch<96>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 8: err = launch<8>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 16: err = launch<16>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 32: err = launch<32>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
    case 64: err = launch<64>(lanes, x, bias, logs, w, y, rows, rows_per_block, groups, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
