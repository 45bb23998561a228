// One GlowStep on a sample's thread-block cluster: the device code shared
// by the K-step chain kernel (glowchain.cu) and the whole-GlowStep kernel
// (glowstep.cu). Both kernels compute what glowstep_ref
// (recurrent_flows_tpu_torch/ops/glowstep.py) computes, forward and reverse,
// with all four clamps; the design note is in glowchain.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 8;  // blocks per sample (the portable maximum)

struct StepParams {
  const float* an_bias;   // [C]
  const float* an_logs;   // [C]
  const float* w1x1;      // [C, C], y = x @ w1x1
  const float* wa;        // [9, CA, U]
  const float* ana_bias;  // [U]
  const float* ana_logs;  // [U]
  const float* wb;        // [U, U]
  const float* anb_bias;  // [U]
  const float* anb_logs;  // [U]
  const float* wc;        // [9, U, C], outputs: shift then raw log-scale
  const float* bias_c;    // [C]
  const float* clamp_scale;  // [C/2]
  const float* clamp_shift;  // [C/2]
};

struct Dims {
  int H, W, C, Cc, U;
};

__device__ __forceinline__ float clamp_s(float v, int clamp_type, float scale,
                                         float shift) {
  switch (clamp_type) {
    case 1:  // glow: log(sigmoid(v + 2))
      return logf(1.0f / (1.0f + expf(-(v + 2.0f))));
    case 2:  // softclamp
      return 2.5f * 0.636f * atanf(v / 2.5f);
    case 3:  // realnvp
      return scale * tanhf(v) + shift;
    default:  // none
      return v;
  }
}

// Shared-memory views of one block.
struct Smem {
  float* xs;     // [HW, C] the chain's carry (replicated in every block)
  float* tmp;    // [HW, C]
  float* part;   // [HW, C] this block's partial sums of the last conv
  float* shs;    // [HW, C/2] coupling shift
  float* ss;     // [HW, C/2] coupling s (clamped)
  float* red;    // [kThreads]
  float* inpad;  // [(H+2)(W+2), CA] zero-padded [z1 | cond]
};

// Barrier over the sample's cluster; the fence publishes this block's
// writes to the global scratch buffer to the other blocks.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  cg::this_cluster().sync();
}

// y[p, :] = src[p, :] @ w  ([C, C]), for every position.
__device__ void matmul_c(const float* src, float* dst, const float* w, int hw,
                         int c) {
  for (int i = threadIdx.x; i < hw * c; i += blockDim.x) {
    int p = i / c, d = i - p * c;
    const float* row = src + p * c;
    float acc = 0.0f;
    for (int k = 0; k < c; ++k) acc = fmaf(row[k], w[k * c + d], acc);
    dst[i] = acc;
  }
}

// The coupling net on z1 = xs[:, :C/2] (cond already in inpad): leaves the
// shift and the clamped s in shared memory, identical in every block.
template <int PT>
__device__ void coupling_net(const Smem& sm, float* ha, float* hb,
                             const StepParams& p, const Dims& d,
                             int clamp_type, int rank) {
  const int hw = d.H * d.W, c2 = d.C / 2, ca = c2 + d.Cc, U = d.U;
  const int wp = d.W + 2;
  const int n_tiles = (hw + PT - 1) / PT;
  const int u0 = U * rank / kCluster, nu = U * (rank + 1) / kCluster - u0;

  for (int i = threadIdx.x; i < hw * c2; i += blockDim.x) {
    int q = i / c2, j = i - q * c2;
    int h = q / d.W, w = q - h * d.W;
    sm.inpad[((h + 1) * wp + w + 1) * ca + j] = sm.xs[q * d.C + j];
  }
  __syncthreads();

  // 3x3 conv [z1|cond] -> this block's hidden channels, actnorm, relu -> ha
  for (int item = threadIdx.x; item < n_tiles * nu; item += blockDim.x) {
    const int u = u0 + item % nu, p0 = (item / nu) * PT;
    float acc[PT];
    int hh[PT], ww[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[j] = 0.0f;
      int q = min(p0 + j, hw - 1);
      hh[j] = q / d.W;
      ww[j] = q - hh[j] * d.W;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const float* wt = p.wa + tap * ca * U + u;
      int off[PT];
#pragma unroll
      for (int j = 0; j < PT; ++j) off[j] = ((hh[j] + dy) * wp + ww[j] + dx) * ca;
      for (int ci = 0; ci < ca; ++ci) {
        const float wv = wt[ci * U];
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[j] = fmaf(sm.inpad[off[j] + ci], wv, acc[j]);
      }
    }
    const float b = p.ana_bias[u], g = expf(p.ana_logs[u]);
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) ha[(p0 + j) * U + u] = fmaxf((acc[j] + b) * g, 0.0f);
  }
  cluster_sync();

  // 1x1 conv U -> this block's hidden channels, actnorm, relu -> hb
  for (int item = threadIdx.x; item < n_tiles * nu; item += blockDim.x) {
    const int v = u0 + item % nu, p0 = (item / nu) * PT;
    float acc[PT];
    const float* rows[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[j] = 0.0f;
      rows[j] = ha + min(p0 + j, hw - 1) * U;
    }
    for (int u = 0; u < U; ++u) {
      const float wv = p.wb[u * U + v];
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[j] = fmaf(rows[j][u], wv, acc[j]);
    }
    const float b = p.anb_bias[v], g = expf(p.anb_logs[v]);
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) hb[(p0 + j) * U + v] = fmaxf((acc[j] + b) * g, 0.0f);
  }
  cluster_sync();

  // 3x3 zero-conv U -> C (gain folded, 'cross' pre-permuted): this block's
  // share of the sum, over its own hidden channels
  for (int item = threadIdx.x; item < n_tiles * d.C; item += blockDim.x) {
    const int c = item % d.C, p0 = (item / d.C) * PT;
    float acc[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[j] = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const float* rows[PT];
      float mask[PT];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        int q = min(p0 + j, hw - 1);
        int h = q / d.W + dy, w = q % d.W + dx;
        bool ok = h >= 0 && h < d.H && w >= 0 && w < d.W;
        mask[j] = ok ? 1.0f : 0.0f;
        rows[j] = hb + (ok ? h * d.W + w : 0) * U;
      }
      const float* wt = p.wc + tap * U * d.C + c;
      for (int u = u0; u < u0 + nu; ++u) {
        const float wv = wt[u * d.C];
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[j] = fmaf(mask[j] * rows[j][u], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) sm.part[(p0 + j) * d.C + c] = acc[j];
  }
  cluster_sync();

  // every block adds the kCluster partial sums in rank order, then clamps
  cg::cluster_group cluster = cg::this_cluster();
  const float* parts[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) parts[r] = cluster.map_shared_rank(sm.part, r);
  for (int i = threadIdx.x; i < hw * d.C; i += blockDim.x) {
    const int q = i / d.C, c = i - q * d.C;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += parts[r][i];
    v += p.bias_c[c];
    if (c < c2) {
      sm.shs[q * c2 + c] = v;
    } else {
      const int k = c - c2;
      sm.ss[q * c2 + k] = clamp_s(v, clamp_type, p.clamp_scale[k], p.clamp_shift[k]);
    }
  }
  __syncthreads();
}

// One GlowStep on the block's replica of the carry sm.xs, forward or
// reverse. Adds this thread's share of the coupling logdet to ld_local.
template <int PT>
__device__ void glowstep_body(const Smem& sm, float* ha, float* hb,
                              const StepParams& p, const Dims& d,
                              int clamp_type, bool reverse, int rank,
                              float& ld_local) {
  const int hw = d.H * d.W, C = d.C, c2 = C / 2;
  if (!reverse) {
    for (int i = threadIdx.x; i < hw * C; i += blockDim.x) {
      const int c = i % C;
      sm.tmp[i] = (sm.xs[i] + p.an_bias[c]) * expf(p.an_logs[c]);
    }
    __syncthreads();
    matmul_c(sm.tmp, sm.xs, p.w1x1, hw, C);
    __syncthreads();
  }
  coupling_net<PT>(sm, ha, hb, p, d, clamp_type, rank);
  for (int i = threadIdx.x; i < hw * c2; i += blockDim.x) {
    const int q = i / c2, j = i - q * c2;
    const float s = sm.ss[i], sh = sm.shs[i];
    float* z2 = sm.xs + q * C + c2 + j;
    *z2 = reverse ? *z2 * expf(-s) - sh : (*z2 + sh) * expf(s);
    ld_local += s;
  }
  __syncthreads();
  if (reverse) {
    matmul_c(sm.xs, sm.tmp, p.w1x1, hw, C);
    __syncthreads();
    for (int i = threadIdx.x; i < hw * C; i += blockDim.x) {
      const int c = i % C;
      sm.xs[i] = sm.tmp[i] * expf(-p.an_logs[c]) - p.an_bias[c];
    }
    __syncthreads();
  }
}

// Bytes of dynamic shared memory one block needs.
inline size_t smem_bytes(int H, int W, int C, int Cc) {
  const size_t hw = (size_t)H * W, ca = C / 2 + Cc;
  return sizeof(float) *
         (4 * hw * C + kThreads + (size_t)(H + 2) * (W + 2) * ca);
}

// Carve the block's dynamic shared memory into its views.
__device__ __forceinline__ Smem carve_smem(float* smem, const Dims& d) {
  const int hw = d.H * d.W, C = d.C, c2 = C / 2;
  Smem sm;
  sm.xs = smem;
  sm.tmp = sm.xs + hw * C;
  sm.part = sm.tmp + hw * C;
  sm.shs = sm.part + hw * C;
  sm.ss = sm.shs + hw * c2;
  sm.red = sm.ss + hw * c2;
  sm.inpad = sm.red + blockDim.x;
  return sm;
}

// Load sample b: x into the carry, cond into the zero-padded coupling input
// (cond does not change between the steps of a chain, so it is placed once).
__device__ void load_sample(const Smem& sm, const float* x, const float* cond,
                            const Dims& d, int b) {
  const int hw = d.H * d.W, C = d.C, c2 = C / 2, ca = c2 + d.Cc;
  const int npad = (d.H + 2) * (d.W + 2) * ca;
  const float* xb = x + (size_t)b * hw * C;
  const float* cb = cond + (size_t)b * hw * d.Cc;
  for (int i = threadIdx.x; i < hw * C; i += blockDim.x) sm.xs[i] = xb[i];
  for (int i = threadIdx.x; i < npad; i += blockDim.x) sm.inpad[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < hw * d.Cc; i += blockDim.x) {
    const int q = i / d.Cc, j = i - q * d.Cc;
    const int h = q / d.W, w = q - h * d.W;
    sm.inpad[((h + 1) * (d.W + 2) + w + 1) * ca + c2 + j] = cb[i];
  }
  __syncthreads();
}

// Rank 0 of the cluster writes the carry and the sample's coupling logdet
// (a fixed-order tree reduction: the same from run to run). Every block of
// the cluster must call it: no block may exit while another still reads
// its partial sums.
__device__ void store_sample(const Smem& sm, float* y, float* ld,
                             const Dims& d, int b, int rank, float ld_local) {
  cg::this_cluster().sync();
  if (rank != 0) return;
  const int hw = d.H * d.W, C = d.C;
  float* yb = y + (size_t)b * hw * C;
  for (int i = threadIdx.x; i < hw * C; i += blockDim.x) yb[i] = sm.xs[i];
  sm.red[threadIdx.x] = ld_local;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm.red[threadIdx.x] += sm.red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[b] = sm.red[0];
}

}  // namespace
