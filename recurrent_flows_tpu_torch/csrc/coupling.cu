// The affine coupling's tail (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/fused.py
// (_coupling_pallas / _coupling_kernel): forward out = (z2 + shift) * e^s,
// reverse out = z2 * e^-s - shift, and the per-sample logdet sum(s).
// Computes what coupling_transform_ref (recurrent_flows_tpu_torch/ops/fused.py)
// computes.
//
// What bounds it on the H100: the launch. Three reads and one write of
// 2,048 values per sample at the shapes of rfn_mnist_production (n = H*W*C/2
// falls from 2,048 at scale 0 to 128 at scale 4), a few hundred kilobytes in
// all, under 0.3 microseconds at the card's memory rate. So a launch costs
// its fixed latency plus the serial work of the design: one trip to memory
// and the reduction of the logdet across the threads that share a sample.
//
// Design:
//  * A sample per block: one block of up to 1,024 threads takes one sample,
//    and every thread issues all its loads at once (one group of 4 values
//    per thread at the production shapes: no loop over chunks). A
//    thread-block cluster of 2, 4 or 8 blocks per sample, with the logdet
//    added through distributed shared memory, measured 0.4-1.0 us slower at
//    every shape of the flow on the H100 (PERF.md), so it was not kept.
//  * Inputs where they lie. z2, shift and s are NHWC views whose element
//    (b, h, w, c) sits at ((b*H + h)*W + w) * R + c * cs with a channel
//    stride cs of 1 or 2: a contiguous tensor (R = C/2, cs = 1), the 'split'
//    half x[..., C/2:] (R = C, cs = 1) or a 'cross' half h[..., 0::2]
//    (R = C, cs = 2). So the caller copies nothing. A group of 4 values is
//    read with 16-byte loads: one per input where the 4 values lie side by
//    side, two (every other value of 8) for a 'cross' view; at C/2 = 2 the
//    group spans two positions, 8 bytes of each for a 'split' view. A
//    layout whose pointers or strides break that alignment takes MODE 1,
//    4-byte loads. The output is contiguous and written 16 bytes at a time.
//    (A 'split' or 'cross' view drags the other half's bytes through L2 with
//    it: at C/2 = 2 a block reads 1.5x the sectors of contiguous inputs.)
//  * The logdet without atomics: each thread adds its values in order, a
//    warp by a fixed __shfl_xor_sync butterfly, the block its warps' sums by
//    another. Two launches agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;

struct View {
  const float* p;
  int r;   // floats from one position to the next
  int cs;  // floats from one channel to the next: 1 or 2
};

// The 4 values of a group, starting at position `pos`, channel `c`.
// MODE 4: C/2 % 4 == 0, the 4 values in one position; MODE 2: C/2 == 2,
// two positions of 2 values (side by side where the view is contiguous).
// The alignment each load needs is coupling_mode's to ensure.
template <int MODE>
__device__ __forceinline__ float4 load4(const View& v, int pos, int c) {
  if constexpr (MODE == 4) {
    const float* q = v.p + pos * v.r + c * v.cs;
    if (v.cs == 1) return __ldg(reinterpret_cast<const float4*>(q));
    const float4 a = __ldg(reinterpret_cast<const float4*>(q));
    const float4 b = __ldg(reinterpret_cast<const float4*>(q) + 1);
    return make_float4(a.x, a.z, b.x, b.z);
  } else {
    const float* q0 = v.p + pos * v.r;
    const float* q1 = q0 + v.r;
    if (v.r == 2) return __ldg(reinterpret_cast<const float4*>(q0));  // contiguous
    if (v.cs == 1) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(q0));
      const float2 b = __ldg(reinterpret_cast<const float2*>(q1));
      return make_float4(a.x, a.y, b.x, b.y);
    }
    const float4 a = __ldg(reinterpret_cast<const float4*>(q0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(q1));
    return make_float4(a.x, a.z, b.x, b.z);
  }
}

// The sum over a warp's 32 lanes by a fixed butterfly (every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float affine(float z, float sh, float s, bool reverse) {
  return reverse ? z * expf(-s) - sh : (z + sh) * expf(s);
}

// grid = B blocks, one per sample; a block takes its sample's ceil(n/4)
// groups of 4 values; ch = C/2 channels.
template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
coupling_kernel(View z2, View sh, View s, float* __restrict__ out,
                float* __restrict__ ld, int n, int ch, int reverse) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int b = blockIdx.x;
  const int nq = (n + 3) / 4;
  const bool rev = reverse != 0;

  float part = 0.f;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const int i = b * n + 4 * q;  // first value, over the batch (< 2^31: the wrapper's)
    if constexpr (MODE == 1) {
      int pos = i / ch, c = i - pos * ch;
      float zv[4], hv[4], sv[4];
      const int m = min(4, n - 4 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < m) {
          zv[e] = __ldg(z2.p + pos * z2.r + c * z2.cs);
          hv[e] = __ldg(sh.p + pos * sh.r + c * sh.cs);
          sv[e] = __ldg(s.p + pos * s.r + c * s.cs);
        }
        if (++c == ch) c = 0, ++pos;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < m) {
          out[i + e] = affine(zv[e], hv[e], sv[e], rev);
          part += sv[e];
        }
      }
    } else {
      const int pos = MODE == 2 ? i >> 1 : i / ch;
      const int c = i - pos * ch;
      const float4 z = load4<MODE>(z2, pos, c);
      const float4 h = load4<MODE>(sh, pos, c);
      const float4 v = load4<MODE>(s, pos, c);
      reinterpret_cast<float4*>(out)[i / 4] =
          make_float4(affine(z.x, h.x, v.x, rev), affine(z.y, h.y, v.y, rev),
                      affine(z.z, h.z, v.z, rev), affine(z.w, h.w, v.w, rev));
      part += (v.x + v.y) + (v.z + v.w);
    }
  }

  // the logdet: a butterfly in each warp, then one over the warps' sums in
  // warp 0
  part = warp_sum(part);
  const int warps = blockDim.x / 32;
  if (warps > 1) {
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = part;
    __syncthreads();
    if (threadIdx.x < 32) part = warp_sum(threadIdx.x < warps ? warp_sums[threadIdx.x] : 0.f);
  }
  if (threadIdx.x == 0) ld[b] = part;
}

template <int MODE>
cudaError_t launch(View z2, View sh, View s, float* out, float* ld, int B,
                   int n, int ch, int threads, int reverse, cudaStream_t stream) {
  coupling_kernel<MODE><<<B, threads, 0, stream>>>(z2, sh, s, out, ld, n, ch, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* coupling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [B, n] (contiguous) and ld [B] of the coupling tail on `stream`. Each
// input is given as (pointer, position stride, channel stride), ch = C/2
// channels and n = H*W*ch values per sample; mode and threads come from
// ops/fused.py::coupling_mode and coupling_plan. Returns the cudaError_t of
// the launch (0 on success).
int coupling_launch(const float* z2, int r_z2, int cs_z2, const float* shift,
                    int r_shift, int cs_shift, const float* s, int r_s,
                    int cs_s, float* out, float* ld, int B, int n, int ch,
                    int mode, int threads, int reverse, void* stream) {
  const View vz{z2, r_z2, cs_z2}, vh{shift, r_shift, cs_shift}, vs{s, r_s, cs_s};
  const auto st = static_cast<cudaStream_t>(stream);
  if (B < 1 || n < 1 || ch < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case 1: err = launch<1>(vz, vh, vs, out, ld, B, n, ch, threads, reverse, st); break;
    case 2: err = launch<2>(vz, vh, vs, out, ld, B, n, ch, threads, reverse, st); break;
    case 4: err = launch<4>(vz, vh, vs, out, ld, B, n, ch, threads, reverse, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
