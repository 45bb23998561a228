// The step actnorm folded into the invertible 1x1 (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/fused.py
// (_actnorm_invconv_pallas / _ainv_kernel): y = ((x + b) * e^logs) @ W^T over
// the rows of x [rows, C], no logdet. Computes what actnorm_invconv_ref
// (recurrent_flows_tpu_torch/ops/fused.py) computes.
//
// What bounds it on the H100: bytes. Each row is read once and written once
// (2 * rows * C * 4 bytes) for 2*C FLOPs per element, C <= 64: 0.98 MB at the
// widest map of rfn_mnist_production ([30*32*32, 4]), a fraction of a
// microsecond at the card's memory rate, so a launch is mostly latency.
//
// Design: one pass over the rows. A block takes a tile of consecutive rows,
// which are one contiguous span of memory (kTileElems values, so that wide
// and narrow maps alike spread over many blocks): its threads load the span
// with neighbouring threads on neighbouring addresses, apply x * scale +
// sbias (scale = e^logs, sbias = b * scale) on the way into shared memory,
// and keep W [C, C] (at most 16 KB, rows padded by one float) in shared
// memory beside it. Each thread then computes output elements i = r * C + d
// for consecutive i: the row's inputs are a shared-memory broadcast within
// the threads of a row, the weights W[d, c] are read at a stride of C + 1
// floats (no bank conflict), and the stores are coalesced. The sum over c
// runs in a fixed order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 1024;  // values of x per block

inline int tile_rows(int C) { return kTileElems / C > 1 ? kTileElems / C : 1; }

__global__ void __launch_bounds__(kThreads)
actnorm_invconv_kernel(const float* __restrict__ x,
                       const float* __restrict__ bias,
                       const float* __restrict__ logs,
                       const float* __restrict__ w,  // [C, C], y_d = sum_c w[d, c]
                       float* __restrict__ y, int rows, int C, int tile) {
  extern __shared__ float smem[];
  const int ldw = C + 1;
  float* ws = smem;             // [C, C + 1]: ws[d * ldw + c] = w[d * C + c]
  float* xs = ws + C * ldw;     // [tile, C], the folded actnorm applied
  const int row0 = blockIdx.x * tile;
  const int n = min(tile, rows - row0) * C;
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
    const int d = i / C, c = i - d * C;
    ws[d * ldw + c] = w[i];
  }
  const float* xb = x + (size_t)row0 * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % C;
    const float scale = expf(logs[c]);
    xs[i] = xb[i] * scale + bias[c] * scale;
  }
  __syncthreads();
  float* yb = y + (size_t)row0 * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / C, d = i - r * C;
    const float* row = xs + r * C;
    const float* wd = ws + d * ldw;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(row[c], wd[c], acc);
    yb[i] = acc;
  }
}

}  // namespace

extern "C" {

const char* actnorm_invconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y[rows, C] = ((x + bias) * exp(logs)) @ w^T on `stream`, C <= 64.
// Returns the cudaError_t of the launch (0 on success).
int actnorm_invconv_launch(const float* x, const float* bias,
                           const float* logs, const float* w, float* y,
                           int rows, int C, void* stream) {
  const int tile = tile_rows(C);
  const size_t smem = sizeof(float) * ((size_t)C * (C + 1) + (size_t)tile * C);
  const int grid = (rows + tile - 1) / tile;
  actnorm_invconv_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, bias, logs, w, y, rows, C, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
