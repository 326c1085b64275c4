// The float32 backward of a stride-1, zero-padded, dilated conv1d for Hopper
// (sm_90a), in FFMA: the input gradient (dgrad), the weight and bias
// gradients (wgrad) and their fixed-order slice reduction, with the forward
// convolution that a backward recomputes. neuralsvb_torch/ops/dilated_conv.py
// binds them and owns their launch policy; two schedules drive them:
//
// - `resblock_cluster_backward_cuda` (ops/fused_resblock.py), the HiFiGAN
//   ResBlock1 cluster's backward, tower by tower. Every convolution of the
//   cluster reads its operand through leaky-ReLU, so it runs the LRELU
//   instances. Per tower step (k taps, dilation d)
//
//       y = conv_{k,d}(lrelu(cur)) + b1,   cur' = cur + conv_{k,1}(lrelu(y)) + b2
//
//   and with g = dL/dcur':
//
//       g_y   = dgrad_{k,1}(g) * lrelu'(y)          g_cur = g + dgrad_{k,d}(g_y) * lrelu'(cur)
//       dW2   = corr(g, lrelu(y)),  db2 = sum g     dW1   = corr(g_y, lrelu(cur)), db1 = sum g_y
//
//   lrelu'(v) is 1 for v >= 0 (also at exactly 0, as jax.nn.leaky_relu's).
// - `amp_conv_backward_cuda` (ops/amp_conv.py), the backward of BigVGAN's
//   AMPBlock1 convolutions: dgrad and wgrad of y = b + conv_{K,d}(x), in the
//   plain instances (the AMP activation's own backward kernel applies its
//   derivative).
//
// Replaces no TPU kernel: the JAX package's `custom_vjp` recomputes the
// cluster through its plain version, and it has no BigVGAN. On the card the
// cluster's recompute and gradients, and the towers' 108 convolution
// gradients a bigvgan_train step, were the largest costs of their training
// steps in cuDNN's legacy float32 engines.
//
// What bounds it: operations. A dgrad, a wgrad or a forward are each
// 2 Co Ci K T B FLOPs in plain f32 (no TF32, no bf16): the least time is the
// FLOPs at the card's 67 TFLOP/s f32 FFMA rate. The design keeps the FFMA
// pipes fed:
//
// - `dilated_conv_dgrad_kernel<K, CO, LRELU>` is an implicit GEMM over the
//   reduction channels x K taps; it computes a dgrad (taps flipped, the
//   weight's channels swapped by its strides) or, for the cluster's
//   recompute, the forward. A block computes CO output channels x 1024 / CO
//   positions of one residue class t = r + d m (the "lattice" of the
//   dilation), so the K taps are K consecutive lattice positions: each
//   thread holds an 8 (channel) x 8 (position) register tile and, per
//   reduction channel, loads 8 + K - 1 window values once and reuses them
//   across the K taps (64 K FFMA per 2 K + 5 float4 shared loads at K = 11).
//   The weights, read through their strides (16 bytes a copy for the LRELU
//   instances, whose weights are contiguous along the output channel; 4
//   bytes for the plain ones, so that BigVGAN's W needs no copy), and the
//   window (with its K - 1 lattice halo; zero outside [0, T) by the copies'
//   zero fill) are staged in shared memory 16 channels at a time (8 for the
//   narrowest tile) by cp.async, double buffered. CO is 64
//   for the cluster and for the towers' wide stages, 32, 16 or 8 where the
//   channels are fewer (96, 48, 24), so that no tile masks most of its lanes.
//   The LRELU instances apply lrelu to the operand once in shared memory
//   (forward) or scale it and multiply the result by lrelu' of a saved
//   pre-activation (dgrad), and their epilogue adds a bias, a residual times
//   a scale and the output's old value where asked; the plain instances
//   store the sums.
// - `dilated_conv_wgrad_kernel<K, COL, LRELU>` uses the same lattice: a
//   thread holds 8 Co x 1 Ci (2 for K <= 5) x K taps; for each position of
//   a residue class it reads 8 gradient values (2 float4 shared loads) for
//   8K FFMA, and its Ci row's window of 8 + K - 1 values once per 8
//   positions. A block of 128 threads covers 8 COL Co x 16 (32) Ci; where
//   the channels are few (COL < 8) its 128 / (16 COL) groups of threads take
//   every group-th block of 8 positions (of 64 staged a step where the
//   groups are 8) and add their sums in group order in shared memory at the
//   end. A block sums over its share of the work items (b, residue class,
//   64 lattice positions), taken in a fixed order, and writes its partial
//   sums, with the bias's, to its slice of the workspace through the
//   gradient's strides; `dilated_conv_reduce_kernel` adds the slices in
//   slice order (with `lanes` > 1 threads each add every lanes-th slice, and
//   the lanes' sums are added in lane order). No atomics: two calls give
//   bit-equal gradients.
//
// Ragged C and T are masked in the copies and the stores. K is a template
// parameter: the LRELU instances are built for HiFiGAN's ResBlock kernel
// sizes (3, 5, 7, 9, 11) at CO = 64, COL = 8, the plain ones for the AMP
// towers' (3, 7, 11) at every tile; the entries refuse others. No kernel
// here is named like another layer's kernels.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): see PERF.md §6. Positions per
// thread, channels a stage, blocks per SM, wgrad blocks and narrower tiles
// each moved the kernels by a few percent at most.
//
// C interface (loaded with ctypes, no PyTorch headers); every int entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take:
//   nsvb_dconv(in, w, wc, wj, wo, bias, mask, res, out, B, Cr, Co, T, k, d,
//              tile, lrelu, dgrad, accumulate, in_scale, res_scale, stream)
//     in [B, Cr, T]; weight element (c, tap j, o) at w[c wc + j wj + o wo],
//     taps read flipped for dgrad; out [B, Co, T]:
//     v = conv_{k,d}(in' ) with in' = lrelu(in) (!dgrad) or in * in_scale;
//     v *= lrelu'(mask) (mask [B, Co, T]); v += bias[o] + res * res_scale;
//     out = v, or out += v (accumulate). bias, mask, res may be NULL. The
//     plain instances (lrelu 0): out = conv_{k,d}(in), and no bias, mask,
//     res, accumulate or scales. tile (Co per block) 64, or 32, 16, 8 for
//     the plain instances; lrelu: wo 1, wc and wj multiples of 4, w 16-byte
//     aligned
//   nsvb_dconv_wgrad(g, a, dw, dw_s, dw_o, dw_i, dw_j, db, db_s, db_o, B, Co,
//                    Ci, T, k, d, nslices, tile, lrelu, g_scale, stream)
//     g [B, Co, T], a [B, Ci, T] (the conv's operand, before lrelu); slice
//     s: dw[s dw_s + o dw_o + i dw_i + j dw_j] and db[s db_s + o db_o] (db
//     may be NULL), times g_scale; tile (Co per block) as above
//   nsvb_dconv_reduce(parts, out, n, nslices, lanes, stream)
//     out[i] = the sum over s of parts[s n + i]; lanes in {1, 2, 4, 8}

#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr float SLOPE = 0.1f;
constexpr int THREADS = 128;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// ---------------------------------------------------------------------------
// dgrad (and the recompute's forward)
// ---------------------------------------------------------------------------

constexpr int PT = 8;  // positions per thread

template <int CO>
__host__ __device__ constexpr int cv_tl() { return (THREADS / (CO / 8)) * PT; }
// reduction channels per pipeline stage: 16, and 8 for the narrowest tile,
// whose window row is longest
template <int CO>
__host__ __device__ constexpr int cv_cic() { return CO >= 16 ? 16 : 8; }
template <int CO>
__host__ __device__ constexpr int cv_xw() { return cv_tl<CO>() + 16; }  // TL + K - 1, K <= 11
template <int K, int CO>
__host__ __device__ constexpr int cv_stage_floats() {
  return cv_cic<CO>() * K * CO + cv_cic<CO>() * cv_xw<CO>();
}

struct ConvArgs {
  const float* in;
  const float* w;
  const float* bias;
  const float* mask;
  const float* res;
  float* out;
  int wc, wj, wo;  // the weight's strides: its offsets fit an int
  int Cr, Co, T, d, ntl, lrelu_in, accumulate;
  float in_scale, res_scale;
};

template <int K, int CO, bool LRELU>
__global__ void __launch_bounds__(THREADS, 3)
dilated_conv_dgrad_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NCL = CO / 8;             // channel lanes
  constexpr int TL = cv_tl<CO>();         // lattice positions per block
  constexpr int CIC = cv_cic<CO>();       // reduction channels per stage
  constexpr int XW = cv_xw<CO>();
  constexpr int WS = CIC * K * CO;
  constexpr int STAGE = cv_stage_floats<K, CO>();
  constexpr int HK = (K - 1) / 2;
  constexpr int NX = (PT + K - 1 + 3) / 4 * 4;  // window values a thread reads
  constexpr int NW = CIC * XW / THREADS;        // window values a thread copies
  // The weight's output channels a copy: the lrelu callers' weights (the
  // cluster's packed [C_out, k, C_in] and its transposed copy) are
  // contiguous and 16-byte aligned along them, BigVGAN's W [Co, Ci, K], read
  // as [Co, K, Ci], is not. Measured: 4-byte copies cost the cluster's
  // convolutions 9-14%; the window copies fully unrolled with 16-byte weight
  // copies gain 2-8%, with 4-byte ones take 168 registers at CO = 64 and
  // lose 4% (the towers).
  constexpr int V = LRELU ? 4 : 1;
  constexpr int UNROLL = LRELU ? NW : 4;
  static_assert(CIC * XW % THREADS == 0, "window copies per thread");
  static_assert(TL - PT + NX <= XW, "window row too short for K");

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * CO;
  const int r = blockIdx.x / a.ntl;
  const int m0 = (blockIdx.x - r * a.ntl) * TL;
  const int d = a.d, T = a.T;
  const int Tr = r < T ? (T - r + d - 1) / d : 0;  // positions of class r
  if (m0 >= Tr) return;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a quarter warp holds 4 position lanes x 2 channel lanes (8 position
  // lanes with one channel lane): its window reads hit 4 distinct 16-byte
  // groups of banks, its weight reads 2
  int tx, ty;
  if (NCL == 1) {
    tx = tid;
    ty = 0;
  } else {
    constexpr int WCH = NCL / 2 > 0 ? NCL / 2 : 1;  // warps across channel lanes
    ty = 2 * (warp % WCH) + ((lane >> 2) & 1);
    tx = (lane & 3) | ((lane >> 3) << 2) | ((warp / WCH) << 4);
  }
  const float* in_b = a.in + (size_t)b * a.Cr * T;

  auto stage = [&](int c0, int s) {
    float* ws = smem + s * STAGE;
    float* xs = ws + WS;
    // element (c, tap j, o) to ws[(c K + j) CO + o], V output channels a
    // copy, o fastest (no bank conflicts on the stores)
    for (int q = tid; q < CIC * K * (CO / V); q += THREADS) {
      const int row = q / (CO / V), o = (q - row * (CO / V)) * V;
      const int c = row / K, j = row - c * K;
      const int cg = c0 + c, og = o0 + o;
      const int n = cg < a.Cr && og < a.Co ? min(V, a.Co - og) : 0;
      cp_async<V>(ws + row * CO + o, n ? a.w + (cg * a.wc + j * a.wj + og * a.wo) : a.w, n);
    }
#pragma unroll (UNROLL)
    for (int n = 0; n < NW; ++n) {
      const int q = tid + n * THREADS;
      const int c = q / XW, p = q - c * XW;
      const int cg = c0 + c;
      const int t = r + d * (m0 - HK + p);
      const bool valid = p < TL + K - 1 && cg < a.Cr && t >= 0 && t < T;
      cp_async<1>(xs + q, valid ? in_b + (size_t)cg * T + t : a.in, valid);
    }
  };

  // the operand's transform (LRELU only), on the window values this thread
  // copied itself
  auto transform = [&](int s) {
    float* xs = smem + s * STAGE + WS;
    if (a.lrelu_in) {
#pragma unroll (UNROLL)
      for (int n = 0; n < NW; ++n) xs[tid + n * THREADS] = lrelu(xs[tid + n * THREADS]);
    } else if (a.in_scale != 1.f) {
#pragma unroll (UNROLL)
      for (int n = 0; n < NW; ++n) xs[tid + n * THREADS] *= a.in_scale;
    }
  };

  float acc[8][PT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < PT; ++jj) acc[i][jj] = 0.f;

  const int nch = (a.Cr + CIC - 1) / CIC;
  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int s = ch & 1;
    if (ch + 1 < nch) {
      stage((ch + 1) * CIC, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (LRELU) transform(s);
    __syncthreads();
    const float* ws = smem + s * STAGE;
    const float* xs = ws + WS;
#pragma unroll 1
    for (int c = 0; c < CIC; ++c) {
      float xv[NX];
      const float* xr = xs + c * XW + PT * tx;
#pragma unroll
      for (int q = 0; q < NX / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xr + 4 * q);
        xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
      }
      const float* wr = ws + c * K * CO + 8 * ty;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 w0 = *reinterpret_cast<const float4*>(wr + j * CO);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + j * CO + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < PT; ++jj) acc[i][jj] = fmaf(wv[i], xv[jj + j], acc[i][jj]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  float* __restrict__ out = a.out;
  const size_t plane = (size_t)b * a.Co * T;
  if constexpr (!LRELU) {  // the plain instances store the sums
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = o0 + 8 * ty + i;
      if (o >= a.Co) continue;
      const size_t row = plane + (size_t)o * T + r;
#pragma unroll
      for (int jj = 0; jj < PT; ++jj) {
        const int m = m0 + PT * tx + jj;
        if (m < Tr) out[row + (size_t)d * m] = acc[i][jj];
      }
    }
  } else {
    // the fused epilogue, one row of positions at a time: all of a row's
    // loads are issued before its stores (out may alias nothing the kernel
    // reads, but the compiler cannot know), so their latency is paid once
    // per row
    const float* __restrict__ bias = a.bias;
    const float* __restrict__ mask = a.mask;
    const float* __restrict__ res = a.res;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = o0 + 8 * ty + i;
      if (o >= a.Co) continue;
      const size_t row = plane + (size_t)o * T + r;
      float mk[PT], rs[PT], ov[PT];
#pragma unroll
      for (int jj = 0; jj < PT; ++jj) {
        const int m = m0 + PT * tx + jj;
        const size_t idx = row + (size_t)d * m;
        const bool in = m < Tr;
        mk[jj] = in && mask != nullptr ? mask[idx] : 0.f;
        rs[jj] = in && res != nullptr ? res[idx] : 0.f;
        ov[jj] = in && a.accumulate ? out[idx] : 0.f;
      }
      const float bv = bias != nullptr ? bias[o] : 0.f;
#pragma unroll
      for (int jj = 0; jj < PT; ++jj) {
        const int m = m0 + PT * tx + jj;
        if (m >= Tr) continue;
        float v = acc[i][jj];
        if (mask != nullptr && !(mk[jj] >= 0.f)) v = v * SLOPE;
        v = v + bv + rs[jj] * a.res_scale;  // rs is 0 without a residual
        out[row + (size_t)d * m] = ov[jj] + v;  // ov is 0 unless accumulating
      }
    }
  }
}

template <int K, int CO, bool LRELU>
int launch_conv(ConvArgs a, int B, cudaStream_t stream) {
  constexpr int TL = cv_tl<CO>();
  a.ntl = ((a.T + a.d - 1) / a.d + TL - 1) / TL;
  const int bytes = 2 * cv_stage_floats<K, CO>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dilated_conv_dgrad_kernel<K, CO, LRELU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.d * a.ntl, (a.Co + CO - 1) / CO, B);
  dilated_conv_dgrad_kernel<K, CO, LRELU><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad and its reduction
// ---------------------------------------------------------------------------

constexpr int WG_CIL = 16;   // Ci lanes per block
constexpr int WG_ITEM = 64;  // lattice positions per work item

struct WgradArgs {
  const float* g;
  const float* a;
  float* dw;
  float* db;
  long long dw_s, dw_o, dw_i, dw_j, db_s, db_o;
  int B, Co, Ci, T, d, ntl, nitems, nslices;
  float g_scale;
};

// Ci per thread: two rows of taps where the taps are few
template <int K>
__host__ __device__ constexpr int wg_cpt() { return K <= 5 ? 2 : 1; }

template <int K, int COL, bool LRELU>
__global__ void __launch_bounds__(THREADS)
dilated_conv_wgrad_kernel(const WgradArgs p) {
  constexpr int CPT = wg_cpt<K>();
  constexpr int CIB = WG_CIL * CPT;             // Ci per block
  constexpr int CO_T = 8 * COL;                 // Co per block
  constexpr int PG = THREADS / (WG_CIL * COL);  // position groups
  constexpr int GLD = CO_T + 4;                 // G row: 16-byte aligned
  // lattice positions per pipeline stage: at least 8 for each group
  constexpr int WG_M = PG > 4 ? 64 : 32;
  constexpr int AW = WG_M + K - 1;              // window of a Ci row
  constexpr int ALD = AW % 2 ? AW : AW + 1;     // odd stride: rows on distinct banks
  constexpr int HK = (K - 1) / 2;
  constexpr int NACC = CPT * 8 * K;
  constexpr int RLD = NACC + 9;                 // odd stride: threads on distinct banks
  constexpr int GROWS = THREADS / WG_M;         // G rows copied at once
  static_assert(CO_T % GROWS == 0, "G copies per thread");
  __shared__ __align__(16) float gs[2][WG_M][GLD];
  __shared__ float as[2][CIB][ALD];
  __shared__ float red[PG > 1 ? WG_CIL * COL * RLD : 1];

  const int ci0 = blockIdx.x * CIB;
  const int co0 = blockIdx.y * CO_T;
  const int s = blockIdx.z;
  const int d = p.d, T = p.T;
  const int tid = threadIdx.x;
  const int cl = tid % WG_CIL, cg = (tid / WG_CIL) % COL, pg = tid / (WG_CIL * COL);
  const int gm = tid % WG_M, grow = tid / WG_M;  // G copy lanes
  const bool do_bias = p.db != nullptr && blockIdx.x == 0;
  // work items (b, r, lattice block l), this block's: s, s + S, s + 2S, ...
  const int my_items = s < p.nitems ? (p.nitems - s + p.nslices - 1) / p.nslices : 0;
  const int nch = my_items * (WG_ITEM / WG_M);

  auto stage = [&](int ch, int st) {
    const int item = s + (ch / (WG_ITEM / WG_M)) * p.nslices;
    const int l = item % p.ntl, q = item / p.ntl;
    const int r = q % d, b = q / d;
    const int Tr = r < T ? (T - r + d - 1) / d : 0;
    const int m_end = min((l + 1) * WG_ITEM, Tr);
    const int m0 = l * WG_ITEM + (ch % (WG_ITEM / WG_M)) * WG_M;
    {
      const bool in = m0 + gm < m_end;
      const int t = r + d * (m0 + gm);
      const float* src = p.g + ((size_t)b * p.Co + co0) * T + t;
#pragma unroll
      for (int n = 0; n < CO_T / GROWS; ++n) {
        const int row = grow + GROWS * n;
        const bool v = in && co0 + row < p.Co;
        cp_async<1>(&gs[st][gm][row], v ? src + (size_t)row * T : p.g, v);
      }
    }
    for (int e = tid; e < CIB * AW; e += THREADS) {
      const int row = e / AW, pp = e - row * AW;
      const int t = r + d * (m0 + pp - HK);
      const bool v = t >= 0 && t < T && ci0 + row < p.Ci;
      cp_async<1>(&as[st][row][pp],
                  v ? p.a + ((size_t)b * p.Ci + ci0 + row) * T + t : p.a, v);
    }
  };

  float acc[CPT][8][K], bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < K; ++j) acc[c][i][j] = 0.f;
  }

  if (nch > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < nch) {
      stage(ch + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (LRELU) {
      for (int e = tid; e < CIB * AW; e += THREADS) {  // lrelu of own copies
        const int row = e / AW, pp = e - row * AW;
        as[st][row][pp] = lrelu(as[st][row][pp]);
      }
    }
    __syncthreads();
    // each position's K taps are K consecutive window values: per block of
    // 8 positions a thread reads 8 + K - 1 values of its Ci row once
#pragma unroll 1
    for (int mb = 8 * pg; mb < WG_M; mb += 8 * PG) {
      float win[CPT][8 + K - 1];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int q = 0; q < 8 + K - 1; ++q) win[c][q] = as[st][cl * CPT + c][mb + q];
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const float4 g0 = *reinterpret_cast<const float4*>(&gs[st][mb + mm][8 * cg]);
        const float4 g1 = *reinterpret_cast<const float4*>(&gs[st][mb + mm][8 * cg + 4]);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j)
              acc[c][i][j] = fmaf(gv[i], win[c][mm + j], acc[c][i][j]);
        if (do_bias) {
#pragma unroll
          for (int i = 0; i < 8; ++i) bsum[i] += gv[i];
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // the position groups' sums, added in group order into group 0's
  if (PG > 1) {
    const int lt = tid % (WG_CIL * COL);
    float* mine = red + lt * RLD;
#pragma unroll 1
    for (int q = 1; q < PG; ++q) {
      if (pg == q) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j) mine[(c * 8 + i) * K + j] = acc[c][i][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) mine[NACC + i] = bsum[i];
      }
      __syncthreads();
      if (pg == 0) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j) acc[c][i][j] += mine[(c * 8 + i) * K + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) bsum[i] += mine[NACC + i];
      }
      __syncthreads();
    }
    if (pg != 0) return;
  }

  float* dw = p.dw + s * p.dw_s;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + 8 * cg + i;
    if (co >= p.Co) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ci = ci0 + cl * CPT + c;
      if (ci >= p.Ci) continue;
#pragma unroll
      for (int j = 0; j < K; ++j)
        dw[co * p.dw_o + ci * p.dw_i + j * p.dw_j] = acc[c][i][j] * p.g_scale;
    }
    if (do_bias && cl == 0) p.db[s * p.db_s + co * p.db_o] = bsum[i] * p.g_scale;
  }
}

template <int K, int COL, bool LRELU>
int launch_wgrad(const WgradArgs& p, cudaStream_t stream) {
  constexpr int CIB = WG_CIL * wg_cpt<K>();
  dim3 grid((p.Ci + CIB - 1) / CIB, (p.Co + 8 * COL - 1) / (8 * COL), p.nslices);
  dilated_conv_wgrad_kernel<K, COL, LRELU><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int RD_THREADS = 256;

__global__ void __launch_bounds__(RD_THREADS)
dilated_conv_reduce_kernel(const float* __restrict__ parts, float* __restrict__ out,
                           long long n, int nslices, int lanes) {
  __shared__ float part[RD_THREADS];
  const int per = RD_THREADS / lanes;  // outputs per block
  const int lane = threadIdx.x / per, k = threadIdx.x - lane * per;
  const long long i = (long long)blockIdx.x * per + k;
  float v = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int s = lane; s < nslices; s += lanes) v += parts[(size_t)s * n + i];
  }
  if (lanes > 1) {
    part[threadIdx.x] = v;
    __syncthreads();
    if (lane != 0) return;
    for (int q = 1; q < lanes; ++q) v += part[q * per + k];
  }
  if (i < n) out[i] = v;
}

// the instances built: f(std::integral_constant<int, K>()) for a kernel size
// of the variant, f(std::integral_constant<int, TILE>()) for a tile of it
// (output channels per block), else cudaErrorInvalidValue
template <bool LRELU, class F>
int with_k(int k, F f) {
  switch (k) {
    case 3: return f(std::integral_constant<int, 3>());
    case 7: return f(std::integral_constant<int, 7>());
    case 11: return f(std::integral_constant<int, 11>());
  }
  if constexpr (LRELU) {
    if (k == 5) return f(std::integral_constant<int, 5>());
    if (k == 9) return f(std::integral_constant<int, 9>());
  }
  return (int)cudaErrorInvalidValue;
}

template <bool LRELU, class F>
int with_tile(int tile, F f) {
  if (tile == 64) return f(std::integral_constant<int, 64>());
  if constexpr (!LRELU) {
    if (tile == 32) return f(std::integral_constant<int, 32>());
    if (tile == 16) return f(std::integral_constant<int, 16>());
    if (tile == 8) return f(std::integral_constant<int, 8>());
  }
  return (int)cudaErrorInvalidValue;
}

template <bool LRELU>
int conv(const ConvArgs& a, int B, int k, int tile, cudaStream_t st) {
  return with_k<LRELU>(k, [&](auto kk) {
    return with_tile<LRELU>(tile, [&](auto co) {
      return launch_conv<decltype(kk)::value, decltype(co)::value, LRELU>(a, B, st);
    });
  });
}

template <bool LRELU>
int wgrad(const WgradArgs& p, int k, int tile, cudaStream_t st) {
  return with_k<LRELU>(k, [&](auto kk) {
    return with_tile<LRELU>(tile, [&](auto co) {
      return launch_wgrad<decltype(kk)::value, decltype(co)::value / 8, LRELU>(p, st);
    });
  });
}

}  // namespace

extern "C" int nsvb_dconv(const void* in, const void* w, long long wc, long long wj,
                          long long wo, const void* bias, const void* mask, const void* res,
                          void* out, int B, int Cr, int Co, int T, int k, int d, int tile,
                          int lrelu, int dgrad, int accumulate, float in_scale,
                          float res_scale, void* stream) {
  if (B <= 0 || B > 65535 || Cr <= 0 || Co <= 0 || T <= 0 || d <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  // the lrelu instances copy the weight 16 bytes at a time; the plain ones
  // have no operand transform and no epilogue
  if (lrelu && (wo != 1 || wc % 4 || wj % 4 || (size_t)w % 16)) return (int)cudaErrorInvalidValue;
  if (!lrelu && (bias || mask || res || accumulate || in_scale != 1.f || res_scale != 1.f))
    return (int)cudaErrorInvalidValue;
  const long long extent = (Cr - 1) * (wc < 0 ? -wc : wc) + (k - 1) * (wj < 0 ? -wj : wj) +
                           (Co - 1) * (wo < 0 ? -wo : wo);
  if (extent > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.in = (const float*)in; a.bias = (const float*)bias; a.mask = (const float*)mask;
  a.res = (const float*)res; a.out = (float*)out;
  // dgrad reads the taps flipped: tap j at the weight's tap k - 1 - j
  a.w = (const float*)w + (dgrad ? (k - 1) * wj : 0);
  a.wc = (int)wc; a.wj = (int)(dgrad ? -wj : wj); a.wo = (int)wo;
  a.Cr = Cr; a.Co = Co; a.T = T; a.d = d; a.ntl = 0;
  a.lrelu_in = lrelu && !dgrad; a.accumulate = accumulate;
  a.in_scale = in_scale; a.res_scale = res_scale;
  cudaStream_t st = (cudaStream_t)stream;
  return lrelu ? conv<true>(a, B, k, tile, st) : conv<false>(a, B, k, tile, st);
}

extern "C" int nsvb_dconv_wgrad(const void* g, const void* x, void* dw, long long dw_s,
                                long long dw_o, long long dw_i, long long dw_j, void* db,
                                long long db_s, long long db_o, int B, int Co, int Ci, int T,
                                int k, int d, int nslices, int tile, int lrelu, float g_scale,
                                void* stream) {
  if (B <= 0 || Co <= 0 || Ci <= 0 || T <= 0 || d <= 0 || nslices <= 0 || nslices > 65535)
    return (int)cudaErrorInvalidValue;
  WgradArgs p;
  p.g = (const float*)g; p.a = (const float*)x; p.dw = (float*)dw; p.db = (float*)db;
  p.dw_s = dw_s; p.dw_o = dw_o; p.dw_i = dw_i; p.dw_j = dw_j; p.db_s = db_s; p.db_o = db_o;
  p.B = B; p.Co = Co; p.Ci = Ci; p.T = T; p.d = d;
  p.ntl = ((T + d - 1) / d + WG_ITEM - 1) / WG_ITEM;
  const long long items = (long long)B * d * p.ntl;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.nitems = (int)items;
  p.nslices = nslices; p.g_scale = g_scale;
  cudaStream_t st = (cudaStream_t)stream;
  return lrelu ? wgrad<true>(p, k, tile, st) : wgrad<false>(p, k, tile, st);
}

extern "C" int nsvb_dconv_reduce(const void* parts, void* out, long long n, int nslices,
                                 int lanes, void* stream) {
  if (n <= 0 || nslices <= 0 || (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8))
    return (int)cudaErrorInvalidValue;
  const long long per = RD_THREADS / lanes;
  dilated_conv_reduce_kernel<<<(unsigned)((n + per - 1) / per), RD_THREADS, 0,
                               (cudaStream_t)stream>>>((const float*)parts, (float*)out, n,
                                                       nslices, lanes);
  return (int)cudaGetLastError();
}
