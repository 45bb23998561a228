// GlowSteps on a batch tile of whole samples, one thread-block cluster per
// tile: the device code shared by the K-step chain kernel (glowchain.cu)
// and the whole-GlowStep kernel (glowstep.cu). Both compute what
// glowstep_ref / glowchain_ref (recurrent_flows_tpu_torch/ops) compute,
// forward and reverse, with all four clamps.
//
// What bounds the kernels on the H100: the coupling net's three convs are
// products over M = B*H*W rows with a few hundred to a few thousand terms
// each. At the shapes of the flow (2x2 .. 16x16 maps, a batch of 8-30)
// neither their FLOPs nor their bytes are the limit but latency: of
// dependent loads, of the barriers between the phases of a step, of the
// fixed work per chunk of weights, and how many of the card's threads have
// work at all. On maps of 256 rows the FMA loops run at about a third of
// the FFMA peak; on maps of 4-16 rows a step is a chain of some twenty
// barriers and memory round trips with almost no arithmetic between them.
//
// Design.
//  * Rows of several samples per cluster. A cluster of nb blocks (8; up to
//    16 where the plan says so) takes `batch_tile` whole samples,
//    R = batch_tile*H*W rows. Every block keeps a replica of the carry x
//    [R, C] and of the coupling input [z1 | cond] [R, CA] (unpadded: a
//    shared row of zeros stands for every out-of-map neighbour) and does
//    the cheap per-position work redundantly. A ragged last tile is masked:
//    its missing samples are zeros, are never stored and add to no logdet.
//  * The hidden channels are split over the blocks: block r computes
//    columns [U*r/nb, U*(r+1)/nb) of the first 3x3 conv and of the 1x1. The
//    1x1 needs every column of the first hidden map ha in every block, an
//    all-to-all of R*U floats per block and step. For small tiles each
//    block keeps its slice in shared memory and gathers its peers' slices
//    through distributed shared memory, a group of peers at a time. From 64
//    rows on that all-to-all is faster through L2 (measured: the cluster's
//    network moves about 4 bytes per clock and SM in this pattern): each
//    block writes its slice to a global scratch, and after the barrier ha
//    comes back kc_b columns at a time with the matching rows of wb, by
//    cp.async, into the same ring as the weights. The second hidden map
//    never leaves its block: for the last 3x3 each block sums over its own
//    hidden channels and the nb partial sums are added in rank order
//    through distributed shared memory. Two cluster barriers per step.
//  * Every thread busy. A product is cut into 4x4 register tiles (IM of
//    them per thread, rows strided so that neighbouring lanes read
//    neighbouring rows; row strides are 4 mod 8 floats, so eight such rows
//    fall into different banks), both operands read from shared memory 16
//    bytes at a time: 8 loads feed 64 FMAs (12 feed 128 with IM = 2). Where
//    a phase has fewer tiles than the block has threads, the reduction is
//    split over KS = 256/tiles thread groups and the partial tiles are
//    added through shared memory in the order ks = 0..KS-1. No float
//    atomics: results repeat bit for bit. (A warp's 16-byte load costs the
//    shared memory four clocks whatever it broadcasts, so the loads, not
//    the FMAs, set the pace of these tiles. 8x8 tiles, 16 loads for 256
//    FMAs, were tried: they spill at 255 registers and ran 1.4x slower.)
//  * An asynchronous weight stream. A block's slices of wa, wb and wc pass
//    through a ring of `stages` buffers in shared memory as one sequence of
//    chunks over all phases and steps, filled `stages-1` chunks ahead of
//    the FMAs with cp.async (16 bytes per copy where widths and pointers
//    allow, 4 bytes otherwise; rows and columns padded with zeros by
//    zero-size copies). The weights are taken as they lie: a block's
//    column slice is a run of 64-128 bytes per row, which cp.async copies
//    without a packing pass. The first chunks are in flight before the
//    sample is loaded, and step k+1's weights arrive during step k's tail.
//    A chunk costs a block barrier and some hundred clocks of fixed work,
//    so chunks are as large as the shared memory allows (several taps of a
//    3x3 conv together where they fit).
//  * The geometry (batch tile, blocks per cluster, IM, stages, chunk rows,
//    row strides, every offset into shared memory) is decided in Python,
//    ops/glowstep.py::launch_plan, and arrives here as the Plan's integers.
//
// With -DGLOW_PROFILE block 0 counts its clocks per phase
// (scripts/torch_glow_kernel_times.py --profile reads them).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace cg = cooperative_groups;

extern __shared__ __align__(16) float smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kPlanInts = 32;
constexpr int kMaxCluster = 16;  // blocks per cluster, at most (Hopper's limit)

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
  int B, H, W, C, Cc, U, K;
};

// The launch plan: the ints of ops/glowstep.py::LaunchPlan, in its order.
// Offsets (o_*) and sizes are in floats; every offset is a multiple of 4.
struct Plan {
  int batch_tile, clusters, cluster_blocks, im, stages, stage_floats;
  int group_peers, kc_b, kc_a, sub_a, taps_a, taps_c, s_in, s_h, s_g, vec;
  int ha_global;
  int o_xs, o_tmp, o_in, o_zero, o_ha, o_hb, o_stg, o_part, o_shs, o_ss;
  int o_lds, o_red, o_ring, smem_floats, smem_bytes;
};
static_assert(sizeof(Plan) == kPlanInts * sizeof(int), "Plan and kPlanInts");

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

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- per-phase clocks (only with -DGLOW_PROFILE) ---------------------------

// Thread 0 of block 0 adds the clocks since its last mark to slot i:
// 0 set-up, load and store, 1 the per-position work before the coupling net,
// 2 first conv, 3 waiting at the first cluster barrier, 4 gather and 1x1,
// 5 last conv, 6 waiting at the second barrier, 7 the sum over ranks, the
// clamp, the affine and the per-position work after it. Inside those, over
// all chunks of the weight stream: 8 waiting for a chunk's copies, 9 the
// block barrier, 10 starting the next chunk's copies.
#ifdef GLOW_PROFILE
constexpr int kProfSlots = 11;
__device__ long long glow_prof[kProfSlots];
#define PROF_SPAN(i, t0)                                        \
  do {                                                          \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                  \
      const long long now = clock64();                          \
      glow_prof[i] += now - (t0);                               \
      (t0) = now;                                               \
    }                                                           \
  } while (0)
#define PROF_MARK(c, i)                               \
  do {                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {        \
      const long long now = clock64();                \
      glow_prof[i] += now - (c).t_mark;               \
      (c).t_mark = now;                               \
    }                                                 \
  } while (0)
#else
#define PROF_MARK(c, i)
#define PROF_SPAN(i, t0)
#endif

// ---- the tile's context ----------------------------------------------------

struct Ctx {
  StepParams P;  // stacked [K, ...] (K = 1: one step's arrays)
  Dims d;
  Plan pl;
  int rank, nb;     // this block in its cluster
  int u0, nu;       // this block's hidden channels [u0, u0 + nu)
  int np_u;         // nu of the widest block, rounded up to 4
  int cp;           // C rounded up to 4
  int R;            // rows of the tile, batch_tile * H * W
  int n_a, n_b, n_step;  // chunks of the weight stream per phase and step
  int consumed, total;   // the stage the FMAs take next; chunks in all
  // the producer's position: chunk p_chunk is piece p_piece of step p_step,
  // for stage p_stage
  int p_chunk, p_step, p_piece, p_stage;
  // how the block's threads share a chunk's copies, for slabs np_u wide
  // (index 0), cp wide (1) and kc_b wide (2): this thread's first row, its
  // column and the rows between its copies
  int cp_row[3], cp_col[3], cp_step[3];
  // chunks of the 1x1 put off until their ha is written (only with ha in
  // global memory): steps below `gate` are open
  int gate, deferred, def_r, def_stage;
  bool drain;
  float* ha_g;  // the cluster's [R, U] of the scratch
#ifdef GLOW_PROFILE
  long long t_mark;
#endif
};

__device__ __forceinline__ int slice_begin(const Ctx& c, int r) {
  return c.d.U * r / c.nb;
}

// ---- the weight stream -----------------------------------------------------

// Starts this thread's copies of a [rows, cols] slab (row stride ld) to dst
// (row stride dstride), zero-padded to [rows_pad, the kind's width]. kind:
// the threads' layout, 0 for slabs np_u wide, 1 for cp, 2 for kc_b.
__device__ __forceinline__ void copy_slab(const Ctx& c, float* dst, int dstride,
                                          const float* src, int ld, int rows,
                                          int rows_pad, int cols, int kind) {
  const int col = c.cp_col[kind], step = c.cp_step[kind];
  const bool col_ok = col < cols;
  if (c.pl.vec & (kind == 1 ? 2 : 1)) {  // addresses are multiples of 16 B
    for (int row = c.cp_row[kind]; row < rows_pad; row += step) {
      const bool ok = col_ok && row < rows;
      cp_async16(dst + row * dstride + col,
                 ok ? src + (size_t)row * ld + col : src, ok ? 16 : 0);
    }
  } else {
    for (int row = c.cp_row[kind]; row < rows_pad; row += step) {
      const bool ok = col_ok && row < rows;
      cp_async4(dst + row * dstride + col,
                ok ? src + (size_t)row * ld + col : c.P.wa, ok ? 4 : 0);
    }
  }
}

// Starts the copies of piece r of step k of the stream into that stage: a
// slab of weights, zero-padded to [rows4, np]; for the 1x1 with ha in
// global memory also the matching columns of ha, [R, kc_b].
__device__ void copy_chunk(const Ctx& c, int k, int r, int stage) {
  const int C = c.d.C, U = c.d.U, ca = C / 2 + c.d.Cc;
  float* dst = smem + c.pl.o_ring + stage * c.pl.stage_floats;
  if (r < c.n_a && c.pl.taps_a > 1) {  // wa[k, taps_a taps, :, u0 : u0 + nu]
    const int ca4 = (ca + 3) & ~3;
    const float* src = c.P.wa + (size_t)(k * 9 + r * c.pl.taps_a) * ca * U + c.u0;
    for (int sl = 0; sl < c.pl.taps_a; ++sl)
      copy_slab(c, dst + sl * ca4 * c.np_u, c.np_u, src + (size_t)sl * ca * U, U,
                ca, ca4, c.nu, 0);
  } else if (r < c.n_a) {  // wa[k, tap, k0 : k0 + rows, u0 : u0 + nu]
    const int tap = r / c.pl.sub_a, k0 = (r - tap * c.pl.sub_a) * c.pl.kc_a;
    const int rows = min(c.pl.kc_a, ca - k0);
    copy_slab(c, dst, c.np_u,
              c.P.wa + ((size_t)(k * 9 + tap) * ca + k0) * U + c.u0, U, rows,
              (rows + 3) & ~3, c.nu, 0);
  } else if (r < c.n_a + c.n_b) {  // wb[k, ua : ua + rows, u0 : u0 + nu]
    int ua, rows;
    if (c.pl.ha_global) {
      ua = (r - c.n_a) * c.pl.kc_b;
      rows = min(c.pl.kc_b, U - ua);
    } else {
      const int p0 = (r - c.n_a) * c.pl.group_peers;
      ua = slice_begin(c, p0);
      rows = slice_begin(c, min(c.nb, p0 + c.pl.group_peers)) - ua;
    }
    copy_slab(c, dst, c.np_u, c.P.wb + ((size_t)k * U + ua) * U + c.u0, U, rows,
              (rows + 3) & ~3, c.nu, 0);
    if (c.pl.ha_global)  // ha[:, ua : ua + rows] behind the weights
      copy_slab(c, dst + ((c.pl.kc_b + 3) & ~3) * c.np_u, c.pl.s_g, c.ha_g + ua,
                U, c.R, c.R, rows, 2);
  } else {  // wc[k, taps_c taps from tap on, u0 : u0 + nu, :]
    const int tap = (r - c.n_a - c.n_b) * c.pl.taps_c, rows4 = (c.nu + 3) & ~3;
    const float* src = c.P.wc + ((size_t)(k * 9 + tap) * U + c.u0) * C;
    for (int sl = 0; sl < c.pl.taps_c; ++sl)
      copy_slab(c, dst + sl * rows4 * c.cp, c.cp, src + (size_t)sl * U * C, C,
                c.nu, rows4, C, 1);
  }
}

// The next chunk of the stream (step, phase, piece in execution order).
// Always commits a group, so that the groups count chunks. A chunk of the
// 1x1 whose ha is not written yet (the stream runs ahead of the barrier
// after the first conv) is put off until open_gate.
__device__ void issue_chunk(Ctx& c) {
  if (c.p_chunk < c.total) {
    if (c.pl.ha_global && c.p_piece >= c.n_a && c.p_piece < c.n_a + c.n_b &&
        c.p_step >= c.gate) {
      if (c.deferred++ == 0) c.def_r = c.p_piece, c.def_stage = c.p_stage;
    } else {
      copy_chunk(c, c.p_step, c.p_piece, c.p_stage);
    }
    if (++c.p_piece == c.n_step) c.p_piece = 0, ++c.p_step;
    if (++c.p_stage == c.pl.stages) c.p_stage = 0;
  }
  ++c.p_chunk;
  cp_async_commit();
}

// After the barrier that follows step k's first conv: ha is in global
// memory, so the chunks of the 1x1 that were put off start now. They are
// one group more than the stream counts, so the next stream_next waits for
// every copy in flight.
__device__ void open_gate(Ctx& c, int k) {
  c.gate = k + 1;
  for (int i = 0; i < c.deferred; ++i)
    copy_chunk(c, k, c.def_r + i, (c.def_stage + i) % c.pl.stages);
  if (c.deferred) {
    cp_async_commit();
    c.drain = true;
  }
  c.deferred = 0;
}

__device__ void stream_begin(Ctx& c) {
  for (int kind = 0; kind < 3; ++kind) {
    // 16-byte copies where the plan allows them, else one float each; a
    // thread keeps its column and walks down the rows
    const int np = kind == 0   ? c.np_u
                   : kind == 1 ? c.cp
                               : max(4, (c.pl.kc_b + 3) & ~3);
    const int unit = (c.pl.vec & (kind == 1 ? 2 : 1)) ? 4 : 1, n = np / unit;
    const int row = threadIdx.x / n;
    c.cp_step[kind] = max(1, kThreads / n);
    // threads past the last full row of a pass copy nothing
    c.cp_row[kind] = row < c.cp_step[kind] ? row : 1 << 30;
    c.cp_col[kind] = (threadIdx.x - row * n) * unit;
  }
  c.p_chunk = c.p_step = c.p_piece = c.p_stage = c.consumed = c.gate = c.deferred = 0;
  c.drain = false;
  for (int q = 0; q < c.pl.stages - 1; ++q) issue_chunk(c);
}

// The next chunk, landed and visible to the whole block. The barrier also
// says that every thread is done with the chunk before, whose stage is
// refilled here. Every thread of the block must call it.
__device__ const float* stream_next(Ctx& c) {
#ifdef GLOW_PROFILE
  long long t0 = clock64();
#endif
  if (c.drain) {
    cp_async_wait<0>();
    c.drain = false;
  } else {
    switch (c.pl.stages) {
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<2>(); break;
    }
  }
  PROF_SPAN(8, t0);
  __syncthreads();
  PROF_SPAN(9, t0);
  issue_chunk(c);
  PROF_SPAN(10, t0);
  const float* stage = smem + c.pl.o_ring + c.consumed * c.pl.stage_floats;
  if (++c.consumed == c.pl.stages) c.consumed = 0;
  return stage;
}

// ---- register-tile products -------------------------------------------------

// A phase's output [R, N] cut into 4x4 tiles, IM per thread: rows
// mt + j * mt_n (j < 4 IM), columns 4 nt + i.
struct Tiling {
  int nt_n, mt_n, tiles, ks_n;  // column tiles, row tiles, their product, KS
  int nt, mt, ks;               // this thread's
  bool active;
};

template <int IM>
__device__ __forceinline__ Tiling make_tiling(int R, int N) {
  Tiling t;
  t.nt_n = max(1, (N + 3) >> 2);  // N = 0: a block without hidden channels
  t.mt_n = (R + 4 * IM - 1) / (4 * IM);
  t.tiles = t.nt_n * t.mt_n;
  t.ks_n = max(1, kThreads / t.tiles);
  const int tid = threadIdx.x;
  t.ks = tid / t.tiles;
  const int rem = tid - t.ks * t.tiles;
  t.mt = rem / t.nt_n;
  t.nt = rem - t.mt * t.nt_n;
  t.active = tid < t.ks_n * t.tiles;
  return t;
}

// acc += A[rows of this thread, 4g .. 4g+3] * W[4g .. 4g+3, 4nt .. 4nt+3] over
// this thread's groups g of four terms. arow[j]: offset in smem of row j's
// first term of the chunk; wst: the chunk's stage, [rows4, np].
template <int IM>
__device__ __forceinline__ void mac_chunk(float (&acc)[4 * IM][4],
                                          const int (&arow)[4 * IM],
                                          const float* __restrict__ wst, int np,
                                          int groups, const Tiling& t) {
  const float* wp = wst + t.nt * 4;
#pragma unroll 1  // (unrolled by 2 and by 4 it measured 6% and 8% slower)
  for (int g = t.ks; g < groups; g += t.ks_n) {
    const float* w = wp + g * 4 * np;
    const float4 b0 = *reinterpret_cast<const float4*>(w);
    const float4 b1 = *reinterpret_cast<const float4*>(w + np);
    const float4 b2 = *reinterpret_cast<const float4*>(w + 2 * np);
    const float4 b3 = *reinterpret_cast<const float4*>(w + 3 * np);
#pragma unroll
    for (int j = 0; j < 4 * IM; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(smem + arow[j] + g * 4);
      acc[j][0] = fmaf(a.w, b3.x, fmaf(a.z, b2.x, fmaf(a.y, b1.x, fmaf(a.x, b0.x, acc[j][0]))));
      acc[j][1] = fmaf(a.w, b3.y, fmaf(a.z, b2.y, fmaf(a.y, b1.y, fmaf(a.x, b0.y, acc[j][1]))));
      acc[j][2] = fmaf(a.w, b3.z, fmaf(a.z, b2.z, fmaf(a.y, b1.z, fmaf(a.x, b0.z, acc[j][2]))));
      acc[j][3] = fmaf(a.w, b3.w, fmaf(a.z, b2.w, fmaf(a.y, b1.w, fmaf(a.x, b0.w, acc[j][3]))));
    }
  }
}

// What becomes of a finished sum: smem[dst + row * stride + col] = v, or
// with bias: relu((v + bias[col]) * exp(logs[col])).
struct Epilogue {
  int dst, stride;
  const float* bias;  // nullptr: store the raw sum
  const float* logs;
  float* global;      // with its row stride: a copy for the peers, or nullptr
  int global_stride;
};

__device__ __forceinline__ void put(const Epilogue& e, int row, int col, float v) {
  if (e.bias) v = fmaxf((v + e.bias[col]) * expf(e.logs[col]), 0.0f);
  if (e.global)
    e.global[(size_t)row * e.global_stride + col] = v;
  else
    smem[e.dst + row * e.stride + col] = v;
}

// Ends a phase: adds the KS partial tiles in the order ks = 0..KS-1 (through
// the `red` buffer) and applies the epilogue to the [R, N] result. Every
// thread of the block must call it.
template <int IM>
__device__ void finish(const Ctx& c, const float (&acc)[4 * IM][4],
                       const Tiling& t, int N, const Epilogue& e) {
  const int R = c.R;
  if (t.ks_n == 1) {
    if (t.active) {
#pragma unroll
      for (int j = 0; j < 4 * IM; ++j) {
        const int row = t.mt + j * t.mt_n;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (row < R && t.nt * 4 + i < N) put(e, row, t.nt * 4 + i, acc[j][i]);
      }
    }
    return;
  }
  // red[(ks * 4IM + j), tile, 4]
  float* red = smem + c.pl.o_red;
  if (t.active) {
    const int tile = t.mt * t.nt_n + t.nt;
#pragma unroll
    for (int j = 0; j < 4 * IM; ++j)
      *reinterpret_cast<float4*>(
          red + ((size_t)((t.ks * 4 * IM + j) * t.tiles + tile) << 2)) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int per_ks = 4 * IM * t.tiles * 4;
  for (int idx = threadIdx.x; idx < per_ks; idx += kThreads) {
    const int i = idx & 3, tile = (idx >> 2) % t.tiles, j = (idx >> 2) / t.tiles;
    const int mt = tile / t.nt_n, nt = tile - mt * t.nt_n;
    const int row = mt + j * t.mt_n, col = nt * 4 + i;
    if (row < R && col < N) {
      float v = 0.0f;
      for (int ks = 0; ks < t.ks_n; ++ks) v += red[ks * per_ks + idx];
      put(e, row, col, v);
    }
  }
}

// This thread's rows as map positions, (h << 16) | w, or -1 for a row past
// the tile or an idle thread: computed once per phase.
template <int IM>
__device__ __forceinline__ void row_positions(const Ctx& c, const Tiling& t,
                                              int (&pos)[4 * IM]) {
  const int hw = c.d.H * c.d.W;
#pragma unroll
  for (int j = 0; j < 4 * IM; ++j) {
    const int row = t.mt + j * t.mt_n, q = row % hw, h = q / c.d.W;
    pos[j] = t.active && row < c.R ? (h << 16) | (q - h * c.d.W) : -1;
  }
}

// Offsets of this thread's rows in a [R, stride] map at `base`, each moved
// by the 3x3 tap (dy, dx); rows past the tile and neighbours outside the map
// read the shared row of zeros.
template <int IM>
__device__ __forceinline__ void tap_rows(const Ctx& c, const Tiling& t,
                                         const int (&pos)[4 * IM], int base,
                                         int stride, int dy, int dx, int col0,
                                         int (&arow)[4 * IM]) {
#pragma unroll
  for (int j = 0; j < 4 * IM; ++j) {
    const int h = (pos[j] >> 16) + dy, w = (pos[j] & 0xffff) + dx;
    const bool ok = pos[j] >= 0 && h >= 0 && h < c.d.H && w >= 0 && w < c.d.W;
    arow[j] = ok ? base + (t.mt + j * t.mt_n + dy * c.d.W + dx) * stride + col0
                 : c.pl.o_zero;
  }
}

// ---- one GlowStep ----------------------------------------------------------

// The coupling net on z1 = xs[:, :C/2] (cond already in the coupling input):
// leaves the shift and the clamped s in shared memory, identical in every
// block of the cluster.
template <int IM>
__device__ void coupling_net(Ctx& c, int k, int clamp_type) {
  cg::cluster_group cluster = cg::this_cluster();
  const Plan& pl = c.pl;
  const int C = c.d.C, c2 = C / 2, ca = c2 + c.d.Cc, U = c.d.U, R = c.R;
  float* ha_g = c.ha_g;

  for (int i = threadIdx.x; i < R * c2; i += kThreads) {
    const int row = i / c2, j = i - row * c2;
    smem[pl.o_in + row * pl.s_in + j] = smem[pl.o_xs + row * C + j];
  }
  // (the first stream_next below is the barrier that publishes z1)
  PROF_MARK(c, 1);

  // 3x3 conv [z1|cond] -> this block's hidden channels, actnorm, relu -> ha
  {
    const Tiling t = make_tiling<IM>(R, c.nu);
    float acc[4 * IM][4] = {};
    int arow[4 * IM], pos[4 * IM];
    row_positions<IM>(c, t, pos);
    if (pl.taps_a > 1) {  // several whole taps per chunk
      const int groups = (ca + 3) >> 2;
      for (int tap0 = 0; tap0 < 9; tap0 += pl.taps_a) {
        const float* wst = stream_next(c);
        for (int tap = tap0; tap < tap0 + pl.taps_a; ++tap, wst += groups * 4 * c.np_u) {
          tap_rows<IM>(c, t, pos, pl.o_in, pl.s_in, tap / 3 - 1, tap % 3 - 1, 0, arow);
          if (t.active) mac_chunk<IM>(acc, arow, wst, c.np_u, groups, t);
        }
      }
    } else {  // sub_a chunks per tap
      for (int tap = 0; tap < 9; ++tap) {
        for (int sc = 0; sc < pl.sub_a; ++sc) {
          const int k0 = sc * pl.kc_a, rows = min(pl.kc_a, ca - k0);
          tap_rows<IM>(c, t, pos, pl.o_in, pl.s_in, tap / 3 - 1, tap % 3 - 1, k0, arow);
          const float* wst = stream_next(c);
          if (t.active) mac_chunk<IM>(acc, arow, wst, c.np_u, (rows + 3) >> 2, t);
        }
      }
    }
    const Epilogue e{pl.o_ha, pl.s_h, c.P.ana_bias + k * U + c.u0,
                     c.P.ana_logs + k * U + c.u0,
                     pl.ha_global ? ha_g + c.u0 : nullptr, U};
    finish<IM>(c, acc, t, c.nu, e);
  }
  PROF_MARK(c, 2);
  if (pl.ha_global) __threadfence();  // ha goes to the peers through L2
  cluster.sync();  // every block's slice of ha is written
  PROF_MARK(c, 3);

  // 1x1 conv U -> this block's hidden channels, actnorm, relu -> hb. ha
  // comes either with the weights, kc_b columns per chunk, from global
  // memory, or from the peers' shared memory, gathered a group at a time
  {
    const Tiling t = make_tiling<IM>(R, c.nu);
    float acc[4 * IM][4] = {};
    int arow[4 * IM];
    if (pl.ha_global) {
      open_gate(c, k);
      const int wb_floats = ((pl.kc_b + 3) & ~3) * c.np_u;
      for (int gi = 0; gi < c.n_b; ++gi) {
        const int cols = min(pl.kc_b, U - gi * pl.kc_b);
        const float* wst = stream_next(c);
        const int base = static_cast<int>(wst - smem) + wb_floats;
#pragma unroll
        for (int j = 0; j < 4 * IM; ++j) {
          const int row = t.mt + j * t.mt_n;
          arow[j] = t.active && row < R ? base + row * pl.s_g : pl.o_zero;
        }
        if (t.active) mac_chunk<IM>(acc, arow, wst, c.np_u, (cols + 3) >> 2, t);
      }
    }
#pragma unroll
    for (int j = 0; j < 4 * IM; ++j) {
      const int row = t.mt + j * t.mt_n;
      arow[j] = t.active && row < R ? pl.o_stg + row * pl.s_g : pl.o_zero;
    }
    for (int gi = 0; gi < (pl.ha_global ? 0 : c.n_b); ++gi) {
      const int p0 = gi * pl.group_peers, p1 = min(c.nb, p0 + pl.group_peers);
      const int ua = slice_begin(c, p0);
      if (gi) __syncthreads();  // the group before is consumed
      const int wg = slice_begin(c, p1) - ua;  // the group's columns
      if (pl.vec & 1) {
        // even slices of a multiple of 4 columns: one flat loop over the
        // group's [R, wg], 8 loads in flight per thread; each block starts
        // at another column, so that no block is read by all at once
        const int n4 = wg >> 2, n = R * n4, nu4 = c.nu >> 2;
        for (int v0 = threadIdx.x; v0 < n; v0 += 8 * kThreads) {
          float4 val[8];
          int at[8];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int v = v0 + s * kThreads;
            if (v < n) {
              const int row = v / n4;
              int c4 = v - row * n4 + c.rank * nu4;
              c4 = c4 >= n4 ? c4 % n4 : c4;
              const int peer = c4 / nu4, cv = (c4 - peer * nu4) * 4;
              val[s] = *reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(smem + pl.o_ha, p0 + peer) +
                  row * pl.s_h + cv);
              at[s] = pl.o_stg + row * pl.s_g + c4 * 4;
            }
          }
#pragma unroll
          for (int s = 0; s < 8; ++s)
            if (v0 + s * kThreads < n)
              *reinterpret_cast<float4*>(smem + at[s]) = val[s];
        }
      } else {
        for (int p = p0; p < p1; ++p) {
          const int up = slice_begin(c, p), wp = slice_begin(c, p + 1) - up;
          const float* src = cluster.map_shared_rank(smem + pl.o_ha, p);
          float* dst = smem + pl.o_stg + (up - ua);
          for (int e = threadIdx.x; e < R * wp; e += kThreads) {
            const int row = e / wp, col = e - row * wp;
            dst[row * pl.s_g + col] = src[row * pl.s_h + col];
          }
        }
      }
      const float* wst = stream_next(c);  // its barrier publishes the gather
      if (t.active) mac_chunk<IM>(acc, arow, wst, c.np_u, (wg + 3) >> 2, t);
    }
    const Epilogue e{pl.o_hb, pl.s_h, c.P.anb_bias + k * U + c.u0,
                     c.P.anb_logs + k * U + c.u0, nullptr, 0};
    finish<IM>(c, acc, t, c.nu, e);
  }
  // (the next stream_next is the barrier that publishes hb to the block)
  PROF_MARK(c, 4);

  // 3x3 zero-conv U -> C (gain folded, 'cross' pre-permuted): this block's
  // share of the sum, over its own hidden channels
  {
    const Tiling t = make_tiling<IM>(R, C);
    float acc[4 * IM][4] = {};
    int arow[4 * IM], pos[4 * IM];
    row_positions<IM>(c, t, pos);
    const int groups = (c.nu + 3) >> 2;
    for (int tap0 = 0; tap0 < 9; tap0 += pl.taps_c) {
      const float* wst = stream_next(c);
      for (int tap = tap0; tap < tap0 + pl.taps_c; ++tap, wst += groups * 4 * c.cp) {
        tap_rows<IM>(c, t, pos, pl.o_hb, pl.s_h, tap / 3 - 1, tap % 3 - 1, 0, arow);
        if (t.active) mac_chunk<IM>(acc, arow, wst, c.cp, groups, t);
      }
    }
    const Epilogue e{pl.o_part, c.cp, nullptr, nullptr, nullptr, 0};
    finish<IM>(c, acc, t, C, e);
  }
  PROF_MARK(c, 5);
  cluster.sync();  // every block's partial sums are written, and every
                   // block is done reading its peers' ha
  PROF_MARK(c, 6);

  // every block adds the nb partial sums in rank order, then clamps
  const float* bias_c = c.P.bias_c + k * C;
  const float* cl_scale = c.P.clamp_scale + k * c2;
  const float* cl_shift = c.P.clamp_shift + k * c2;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int row = i / C, ch = i - row * C;
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < c.nb)
        part[r] = cluster.map_shared_rank(smem + pl.o_part, r)[row * c.cp + ch];
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < c.nb) v += part[r];
    v += bias_c[ch];
    if (ch < c2) {
      smem[pl.o_shs + row * c2 + ch] = v;
    } else {
      const int j = ch - c2;
      smem[pl.o_ss + row * c2 + j] = clamp_s(v, clamp_type, cl_scale[j], cl_shift[j]);
    }
  }
  __syncthreads();
}

// y[row, :] = src[row, :] @ w  ([C, C]), for every row of the tile.
__device__ void matmul_c(const float* src, float* dst, const float* w, int rows,
                         int c) {
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int p = i / c, d = i - p * c;
    const float* row = src + p * c;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < c; ++k) acc = fmaf(row[k], w[k * c + d], acc);
    dst[i] = acc;
  }
}

// Step k on the block's replica of the carry, forward or reverse. Adds each
// element's s to the tile's logdet accumulator.
template <int IM>
__device__ void glowstep_body(Ctx& c, int k, int clamp_type, bool reverse) {
  const Plan& pl = c.pl;
  const int C = c.d.C, c2 = C / 2, R = c.R;
  float* xs = smem + pl.o_xs;
  float* tmp = smem + pl.o_tmp;
  const float* an_bias = c.P.an_bias + k * C;
  const float* an_logs = c.P.an_logs + k * C;
  const float* w1x1 = c.P.w1x1 + (size_t)k * C * C;
  if (!reverse) {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int ch = i % C;
      tmp[i] = (xs[i] + an_bias[ch]) * expf(an_logs[ch]);
    }
    __syncthreads();
    matmul_c(tmp, xs, w1x1, R, C);
    __syncthreads();
  }
  coupling_net<IM>(c, k, clamp_type);
  for (int i = threadIdx.x; i < R * c2; i += kThreads) {
    const int row = i / c2, j = i - row * c2;
    const float s = smem[pl.o_ss + i], sh = smem[pl.o_shs + i];
    float* z2 = xs + row * C + c2 + j;
    *z2 = reverse ? *z2 * expf(-s) - sh : (*z2 + sh) * expf(s);
    smem[pl.o_lds + i] += s;
  }
  __syncthreads();
  if (reverse) {
    matmul_c(xs, tmp, w1x1, R, C);
    __syncthreads();
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int ch = i % C;
      xs[i] = tmp[i] * expf(-an_logs[ch]) - an_bias[ch];
    }
    __syncthreads();
  }
}

// ---- a cluster's whole job --------------------------------------------------

// K GlowSteps on the cluster's batch tile: load, K steps, store.
template <int IM>
__device__ void run_tile(const float* __restrict__ x,
                         const float* __restrict__ cond, const StepParams& P,
                         float* __restrict__ y, float* __restrict__ ld,
                         float* scratch, const Dims& d, const Plan& pl,
                         int clamp_type, bool reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  Ctx c;
  c.P = P, c.d = d, c.pl = pl;
  c.rank = static_cast<int>(cluster.block_rank());
  c.nb = pl.cluster_blocks;
  c.u0 = slice_begin(c, c.rank);
  c.nu = slice_begin(c, c.rank + 1) - c.u0;
  c.np_u = (((d.U + c.nb - 1) / c.nb) + 3) & ~3;
  c.cp = (d.C + 3) & ~3;
  const int hw = d.H * d.W, C = d.C, c2 = C / 2;
  c.R = pl.batch_tile * hw;
  c.n_a = 9 * pl.sub_a / pl.taps_a;
  c.n_b = pl.ha_global ? (d.U + pl.kc_b - 1) / pl.kc_b
                       : (c.nb + pl.group_peers - 1) / pl.group_peers;
  c.ha_g = scratch + (size_t)(blockIdx.x / c.nb) * c.R * d.U;
  c.n_step = c.n_a + c.n_b + 9 / pl.taps_c;
  c.total = d.K * c.n_step;

#ifdef GLOW_PROFILE
  c.t_mark = clock64();
#endif
  // zeros everywhere but the ring: the pads of every map, the row of zeros,
  // the logdet accumulator and the rows of a ragged tile's missing samples
  for (int i = threadIdx.x; i < pl.o_ring; i += kThreads) smem[i] = 0.0f;
  stream_begin(c);  // the first weights are on their way
  __syncthreads();

  const int b0 = (blockIdx.x / c.nb) * pl.batch_tile;
  const int n_valid = min(pl.batch_tile, d.B - b0);
  const float* xb = x + (size_t)b0 * hw * C;
  const float* cb = cond + (size_t)b0 * hw * d.Cc;
  for (int i = threadIdx.x; i < n_valid * hw * C; i += kThreads)
    smem[pl.o_xs + i] = xb[i];
  for (int i = threadIdx.x; i < n_valid * hw * d.Cc; i += kThreads) {
    const int row = i / d.Cc, j = i - row * d.Cc;
    smem[pl.o_in + row * pl.s_in + c2 + j] = cb[i];
  }
  __syncthreads();

  PROF_MARK(c, 0);
  for (int k = 0; k < d.K; ++k) {
    glowstep_body<IM>(c, k, clamp_type, reverse);
    PROF_MARK(c, 7);
  }

  // no block may exit while a peer still reads its partial sums
  cluster.sync();
  if (c.rank != 0) return;
  float* yb = y + (size_t)b0 * hw * C;
  for (int i = threadIdx.x; i < n_valid * hw * C; i += kThreads)
    yb[i] = smem[pl.o_xs + i];
  // per-sample logdet: one warp per sample, lanes stride the sample's
  // elements, then a fixed tree over the lanes: the same from run to run
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < n_valid; s += kThreads / 32) {
    const float* e = smem + pl.o_lds + s * hw * c2;
    float v = 0.0f;
    for (int i = lane; i < hw * c2; i += 32) v += e[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) ld[b0 + s] = v;
  }
  PROF_MARK(c, 0);
}

// ---- host side --------------------------------------------------------------

// Launches `kernel` on the plan's grid of clusters with its dynamic shared
// memory; clusters of more than 8 blocks need the non-portable opt-in.
template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, const Plan& pl, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (err != cudaSuccess) return err;
  if (pl.cluster_blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.clusters * pl.cluster_blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef GLOW_PROFILE
// Copies the kProfSlots clocks to `out` and sets them to zero.
inline int read_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, glow_prof, sizeof(glow_prof));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long zeros[kProfSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(glow_prof, zeros, sizeof(zeros)));
}
#endif

// The plan's ints as a Plan; the 16-byte copies of the weight stream are
// kept only where the weights' pointers allow them.
inline Plan read_plan(const int* ints, const StepParams& P) {
  Plan pl;
  memcpy(&pl, ints, sizeof(Plan));
  const auto misaligned = [](const float* p) {
    return (reinterpret_cast<size_t>(p) & 15) != 0;
  };
  if (misaligned(P.wa) || misaligned(P.wb)) pl.vec &= ~1;
  if (misaligned(P.wc)) pl.vec &= ~2;
  return pl;
}

}  // namespace
