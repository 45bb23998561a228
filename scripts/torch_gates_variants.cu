// Variants of the ConvLSTM gates kernel (recurrent_flows_tpu_torch/csrc/
// convlstm_gates.cu) for scripts/torch_gates_variants.py: a measurement
// aid, not part of the package. VEC channels (VEC-wide loads) and S samples
// per thread, the peepholes kept in registers over the S samples; quotients
// by __fdividef, or by IEEE division where built with -DIEEE_DIV; with
// -DCLOCKS thread 0 of each block writes the clocks from its start to its
// loads' return and from there to its last store.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float quot(float a, float b) {
#ifdef IEEE_DIV
  return a / b;
#else
  return __fdividef(a, b);
#endif
}

__device__ __forceinline__ float sigmoid(float v) { return quot(1.f, 1.f + expf(-v)); }

__device__ __forceinline__ float tanh_free(float v) {
  const float e = expf(-2.f * fabsf(v));
  const float t = quot(1.f - e, 1.f + e);
  return v >= 0.f ? t : -t;
}

template <int VEC> struct Pack;
template <> struct Pack<1> { using T = float; };
template <> struct Pack<2> { using T = float2; };
template <> struct Pack<4> { using T = float4; };

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  const auto t = __ldg(reinterpret_cast<const typename Pack<VEC>::T*>(p));
  if constexpr (VEC == 1) v[0] = t;
  else if constexpr (VEC == 2) v[0] = t.x, v[1] = t.y;
  else v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) *p = v[0];
  else if constexpr (VEC == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// grid = (hw, ceil(hc / VEC / threads), ceil(B / S))
template <int VEC, int S>
__global__ void __launch_bounds__(256)
gates_variant(const float* __restrict__ gates, const float* __restrict__ c,
              const float* __restrict__ w_ci, const float* __restrict__ w_cf,
              const float* __restrict__ w_co, float* __restrict__ h_out,
              float* __restrict__ c_out, int B, int hw, int hc, long long* clocks) {
#ifdef CLOCKS
  const long long t0 = clock64();
#endif
  const int ch = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (ch >= hc) return;
  const int p = blockIdx.x, b0 = blockIdx.z * S;
  float wi[VEC], wf[VEC], wo[VEC], gi[S][VEC], gf[S][VEC], go[S][VEC], gg[S][VEC], cv[S][VEC];
  load<VEC>(w_ci + p * hc + ch, wi);
  load<VEC>(w_cf + p * hc + ch, wf);
  load<VEC>(w_co + p * hc + ch, wo);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (b0 + s < B) {
      const int pos = (b0 + s) * hw + p;
      const float* g = gates + pos * 4 * hc + ch;
      load<VEC>(g, gi[s]);
      load<VEC>(g + hc, gf[s]);
      load<VEC>(g + 2 * hc, go[s]);
      load<VEC>(g + 3 * hc, gg[s]);
      load<VEC>(c + pos * hc + ch, cv[s]);
    }
  }
#ifdef CLOCKS
  // the first use of the loaded values waits for them
  float sink = cv[0][0] + gi[0][0] + gf[0][0] + go[0][0] + gg[0][0] + wi[0] + wf[0] + wo[0];
  asm volatile("" : "+f"(sink));
  const long long t1 = clock64();
#endif
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (b0 + s < B) {
      float hn[VEC], cn[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float i = sigmoid(gi[s][e] + wi[e] * cv[s][e]);
        const float f = sigmoid(gf[s][e] + wf[e] * cv[s][e]);
        cn[e] = f * cv[s][e] + i * tanh_free(gg[s][e]);
        const float o = sigmoid(go[s][e] + wo[e] * cn[e]);
        hn[e] = o * tanh_free(cn[e]);
      }
      const int off = ((b0 + s) * hw + p) * hc + ch;
      store<VEC>(h_out + off, hn);
      store<VEC>(c_out + off, cn);
    }
  }
#ifdef CLOCKS
  if (threadIdx.x == 0) {
    long long* q = clocks + 2 * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));
    q[0] = t1 - t0;
    q[1] = clock64() - t1;
  }
#endif
}

template <int VEC, int S>
int launch(const float* const* p, float* h, float* cn, int B, int hw, int hc, int threads,
           long long* clocks, cudaStream_t stream) {
  const dim3 grid(hw, (hc / VEC + threads - 1) / threads, (B + S - 1) / S);
  gates_variant<VEC, S><<<grid, threads, 0, stream>>>(p[0], p[1], p[2], p[3], p[4], h, cn, B,
                                                      hw, hc, clocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gates_variant_launch(const float* gates, const float* c, const float* w_ci,
                                    const float* w_cf, const float* w_co, float* h, float* cn,
                                    int B, int hw, int hc, int vec, int samples, int threads,
                                    long long* clocks, void* stream) {
  const float* p[5] = {gates, c, w_ci, w_cf, w_co};
  const auto st = static_cast<cudaStream_t>(stream);
  if (hc % vec || threads < 32 || threads > 256 || threads % 32) return cudaErrorInvalidValue;
  switch (vec * 10 + samples) {
    case 11: return launch<1, 1>(p, h, cn, B, hw, hc, threads, clocks, st);
    case 12: return launch<1, 2>(p, h, cn, B, hw, hc, threads, clocks, st);
    case 21: return launch<2, 1>(p, h, cn, B, hw, hc, threads, clocks, st);
    case 41: return launch<4, 1>(p, h, cn, B, hw, hc, threads, clocks, st);
    case 42: return launch<4, 2>(p, h, cn, B, hw, hc, threads, clocks, st);
  }
  return cudaErrorInvalidValue;
}
