// Backward of the HiFiGAN ResBlock1 cluster for Hopper (sm_90a), f32 FFMA.
//
// Replaces no TPU kernel: the JAX package's `custom_vjp` recomputes the
// cluster through its plain version and differentiates that, and the port
// did the same through cuDNN until these kernels. On the card that recompute
// and its autograd were the largest single cost of vocoder training (18
// dilated convolutions per stage, forward, dgrad and wgrad, in cuDNN's legacy
// float32 engines). neuralsvb_torch/ops/fused_resblock.py
// (`resblock_cluster_backward_cuda`) drives these kernels tower by tower;
// `resblock_cluster_backward_plain` beside it is the same decomposition in
// F.conv1d. Per tower step (k taps, dilation d)
//
//     y = conv_{k,d}(lrelu(cur)) + b1,   cur' = cur + conv_{k,1}(lrelu(y)) + b2
//
// and with g = dL/dcur':
//
//     g_y   = dgrad_{k,1}(g) * lrelu'(y)          g_cur = g + dgrad_{k,d}(g_y) * lrelu'(cur)
//     dW2   = corr(g, lrelu(y)),  db2 = sum g     dW1   = corr(g_y, lrelu(cur)), db1 = sum g_y
//
// lrelu'(v) is 1 for v >= 0 (also at exactly 0, as jax.nn.leaky_relu's).
//
// What bounds it: operations. Recompute, dgrad and wgrad are each
// 2*C^2*T*k multiply-adds per conv, about C*k of them per element read, all
// in plain f32 (no TF32, no bf16): the least time is the FLOPs at the card's
// 67 TFLOP/s f32 FFMA rate. The design keeps the FFMA pipes fed:
//
// - `cluster_bwd_conv_kernel<K, DGRAD>` (recompute and dgrad) is an implicit
//   GEMM over C_in x K taps. A block computes 64 output channels x 128
//   positions of one residue class t = r + d*m (the "lattice" of the
//   dilation), so the K taps of a dilated conv are K consecutive lattice
//   positions: each thread holds an 8 (channel) x 8 (position) register tile
//   and, per input channel, loads 8 + K - 1 window values once and reuses
//   them across all K taps (K*64 FFMA per 2K + 5 shared loads). Weights and
//   the window (with its (K-1) lattice halo) are staged in shared memory 16
//   channels at a time by cp.async, double buffered; zero padding outside
//   [0, T) is the copies' zero fill. Recompute applies lrelu to the window
//   once in shared memory and adds bias (and residual) in the epilogue.
//   dgrad reads the weights with flipped taps and C_in / C_out swapped; its
//   epilogue multiplies by lrelu' of the saved pre-activation, adds the
//   residual gradient (times the 1/n tower mean at a tower's top) and can
//   accumulate into the stage input's gradient (the towers' sum, in tower
//   order).
// - `cluster_bwd_wgrad_kernel<K>` uses the same lattice: a thread holds 8
//   C_out x 1 C_in (2 for K <= 5) x K taps; for each position of a residue
//   class it reads 8 gradient values (2 float4 shared loads) for 8K FFMA,
//   and its C_in row's window of 8 + K - 1 values once per 8 positions. A
//   block computes 64 C_out x 16 (32) C_in over
//   its share of the work items (b, residue class, 64 lattice positions),
//   taken in a fixed order, staged 32 positions at a time by 4-byte
//   cp.async (transposed on the way in, lrelu applied in place), and
//   writes its partial sums, with the bias gradient's, to its slice's
//   workspace row. `cluster_bwd_reduce_kernel` adds the slices in slice
//   order. No atomics: two calls give bit-equal gradients.
//
// Tile sizes follow the shapes the wrapper sees: the conv grid covers
// ceil(C/64) channel tiles x d residue classes x ceil(ceil(T/d)/128)
// lattice tiles x B; the number of wgrad slices comes from C, k, B and T
// so that every stage fills the card. Ragged C and T are masked in the
// copies and the epilogues. K is a template parameter, built for the
// kernel sizes of HiFiGAN's ResBlocks (3, 5, 7, 9, 11); the wrapper refuses
// others. No kernel here is named like the forward's kernels.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): the three training stages'
// backward, 1,533 GFLOP, in about 45 ms with the wgrads on a second
// stream, 51% of its f32 FFMA least time (22.9 ms); the card sustains 65
// TFLOP/s of pure register FFMA, and none of positions per thread (8, 12, 16),
// channels per stage (8, 16), blocks per SM (2, 3) or the wgrad's lane
// layout moved the kernels by more than a few percent.
//
// C interface (loaded with ctypes, no PyTorch headers); every int entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take:
//   nsvb_cluster_bwd_conv(in, w, bias, mask, res, out, B, Cr, Co, T, k, d,
//                         ldw, dgrad, accumulate, in_scale, res_scale, stream)
//     in   [B, Cr, T]   the operand before its load transform (recompute:
//                       lrelu; dgrad: times in_scale)
//     w    element (c, tap j, o) at w[(c*k + (dgrad ? k-1-j : j))*ldw + o],
//          ldw % 4 == 0, ldw >= Co, 16-byte aligned
//     bias [Co] or NULL (recompute)   mask [B, Co, T] or NULL (dgrad: lrelu')
//     res  [B, Co, T] or NULL (recompute: added; dgrad: added times res_scale)
//     out  [B, Co, T]   written, or (dgrad, accumulate) added to
//   nsvb_cluster_bwd_wgrad(g, a, dw, db, B, Co, Ci, T, k, d, nslices,
//                          slice_stride, g_scale, stream)
//     g [B, Co, T], a [B, Ci, T] (the conv's input before lrelu); slice s:
//     dw[s*slice_stride + (co*k + tap)*Ci + ci] and db[s*slice_stride + co]
//     (db may be NULL), times g_scale
//   nsvb_cluster_bwd_reduce(parts, out, n, nslices, stream)
//     out[i] = sum over s in order of parts[s*n + i]

#include <cuda_runtime.h>

namespace {

constexpr float SLOPE = 0.1f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !valid (src must still be a device address)
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 16 bytes, of which the first `bytes` are copied and the rest zero-filled
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// ---------------------------------------------------------------------------
// recompute and dgrad
// ---------------------------------------------------------------------------

constexpr int CV_CO = 64;            // output channels per block
constexpr int CV_PT = 8;             // positions per thread
constexpr int CV_TL = 16 * CV_PT;    // lattice positions per block
constexpr int CV_CI = 16;            // reduction channels per pipeline stage
constexpr int CV_XW = CV_TL + 16;    // window row: CV_TL + K - 1 for K <= 11
constexpr int CV_THREADS = 128;      // 8 channel lanes x 16 position lanes

struct ConvArgs {
  const float* in;
  const float* w;
  const float* bias;
  const float* mask;
  const float* res;
  float* out;
  int Cr, Co, T, d, ldw, ntl, accumulate;
  float in_scale, res_scale;
};

template <int K>
__host__ __device__ constexpr int conv_stage_floats() { return CV_CI * K * CV_CO + CV_CI * CV_XW; }

template <int K, bool DGRAD>
__global__ void __launch_bounds__(CV_THREADS, 3)
cluster_bwd_conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WS = CV_CI * K * CV_CO;
  constexpr int STAGE = conv_stage_floats<K>();
  constexpr int HK = (K - 1) / 2;
  constexpr int NX = (CV_PT + K - 1 + 3) / 4 * 4;  // window values a thread reads
  static_assert(CV_CI * CV_XW % CV_THREADS == 0, "window copies per thread");
  static_assert(CV_PT * 15 + NX <= CV_XW, "window row too short for K");

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * CV_CO;
  const int r = blockIdx.x / a.ntl;
  const int m0 = (blockIdx.x - r * a.ntl) * CV_TL;
  const int d = a.d, T = a.T;
  const int Tr = r < T ? (T - r + d - 1) / d : 0;  // positions of class r
  if (m0 >= Tr) return;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a quarter warp holds 4 position lanes x 2 channel lanes: its window
  // reads hit 4 distinct 16-byte groups of banks, its weight reads 2
  const int tx = (lane & 3) | ((lane >> 3) << 2);  // 0..15
  const int ty = 2 * warp + ((lane >> 2) & 1);     // 0..7
  const float* in_b = a.in + (size_t)b * a.Cr * T;

  auto stage = [&](int c0, int s) {
    float* ws = smem + s * STAGE;
    float* xs = ws + WS;
    for (int q = tid; q < CV_CI * K * (CV_CO / 4); q += CV_THREADS) {
      const int row = q / (CV_CO / 4), col = (q % (CV_CO / 4)) * 4;
      const int c = row / K, j = row - c * K;
      const int cg = c0 + c, og = o0 + col;
      int bytes = 0;
      const float* src = a.w;
      if (cg < a.Cr && og < a.Co) {
        bytes = min(16, (a.Co - og) * 4);
        src = a.w + ((size_t)cg * K + (DGRAD ? K - 1 - j : j)) * a.ldw + og;
      }
      cp_async_16(ws + row * CV_CO + col, src, bytes);
    }
#pragma unroll
    for (int n = 0; n < CV_CI * CV_XW / CV_THREADS; ++n) {
      const int q = tid + n * CV_THREADS;
      const int c = q / CV_XW, p = q - c * CV_XW;
      const int cg = c0 + c;
      const int t = r + d * (m0 - HK + p);
      const bool valid = p < CV_TL + K - 1 && cg < a.Cr && t >= 0 && t < T;
      cp_async_4(xs + q, valid ? in_b + (size_t)cg * T + t : a.in, valid);
    }
  };

  // the load transform, on the window values this thread copied itself
  auto transform = [&](int s) {
    float* xs = smem + s * STAGE + WS;
    if (DGRAD && a.in_scale == 1.f) return;
#pragma unroll
    for (int n = 0; n < CV_CI * CV_XW / CV_THREADS; ++n) {
      const int q = tid + n * CV_THREADS;
      xs[q] = DGRAD ? xs[q] * a.in_scale : lrelu(xs[q]);
    }
  };

  float acc[8][CV_PT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < CV_PT; ++jj) acc[i][jj] = 0.f;

  const int nch = (a.Cr + CV_CI - 1) / CV_CI;
  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int s = ch & 1;
    if (ch + 1 < nch) {
      stage((ch + 1) * CV_CI, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    transform(s);
    __syncthreads();
    const float* ws = smem + s * STAGE;
    const float* xs = ws + WS;
#pragma unroll 1
    for (int c = 0; c < CV_CI; ++c) {
      float xv[NX];
      const float* xr = xs + c * CV_XW + CV_PT * tx;
#pragma unroll
      for (int q = 0; q < NX / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xr + 4 * q);
        xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
      }
      const float* wr = ws + c * K * CV_CO + 8 * ty;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 w0 = *reinterpret_cast<const float4*>(wr + j * CV_CO);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + j * CV_CO + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < CV_PT; ++jj) acc[i][jj] = fmaf(wv[i], xv[jj + j], acc[i][jj]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // epilogue, one row of positions at a time: all of a row's loads are
  // issued before its stores (out may alias nothing the kernel reads, but
  // the compiler cannot know), so their latency is paid once per row
  const float* __restrict__ bias = a.bias;
  const float* __restrict__ mask = a.mask;
  const float* __restrict__ res = a.res;
  float* __restrict__ out = a.out;
  const size_t plane = (size_t)b * a.Co * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + 8 * ty + i;
    if (o >= a.Co) continue;
    const size_t row = plane + (size_t)o * T + r;
    float mk[CV_PT], rs[CV_PT], ov[CV_PT];
#pragma unroll
    for (int jj = 0; jj < CV_PT; ++jj) {
      const int m = m0 + CV_PT * tx + jj;
      const size_t idx = row + (size_t)d * m;
      const bool in = m < Tr;
      mk[jj] = in && mask != nullptr ? mask[idx] : 0.f;
      rs[jj] = in && res != nullptr ? res[idx] : 0.f;
      ov[jj] = in && DGRAD && a.accumulate ? out[idx] : 0.f;
    }
    const float bv = (!DGRAD && bias != nullptr) ? bias[o] : 0.f;
#pragma unroll
    for (int jj = 0; jj < CV_PT; ++jj) {
      const int m = m0 + CV_PT * tx + jj;
      if (m >= Tr) continue;
      float v = acc[i][jj];
      if (DGRAD) {
        if (!(mk[jj] >= 0.f)) v = v * SLOPE;
        v = v + rs[jj] * a.res_scale;  // rs is 0 without a residual
        v = ov[jj] + v;                // ov is 0 unless accumulating
      } else {
        v = v + bv + rs[jj];
      }
      out[row + (size_t)d * m] = v;
    }
  }
}

template <int K, bool DGRAD>
int launch_conv(const ConvArgs& a, int B, cudaStream_t stream) {
  const int bytes = 2 * conv_stage_floats<K>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(cluster_bwd_conv_kernel<K, DGRAD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.d * a.ntl, (a.Co + CV_CO - 1) / CV_CO, B);
  cluster_bwd_conv_kernel<K, DGRAD><<<grid, CV_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad and its reduction
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;
constexpr int WG_LANES = 16;                         // C_in lanes per block
constexpr int WG_CO = 8 * (WG_THREADS / WG_LANES);   // C_out per block, 8 a lane
constexpr int WG_M = 32;        // lattice positions per pipeline stage
constexpr int WG_ITEM = 64;     // lattice positions per work item
constexpr int WG_GLD = WG_CO + 4;  // G row: 16-byte aligned

struct WgradArgs {
  const float* g;
  const float* a;
  float* dw;
  float* db;
  int B, Co, Ci, T, d, ntl, nitems, nslices;
  long long slice_stride;
  float g_scale;
};

// C_in per thread: two rows of taps where the taps are few
template <int K>
__host__ __device__ constexpr int wg_cpt() { return K <= 5 ? 2 : 1; }

template <int K>
__global__ void __launch_bounds__(WG_THREADS)
cluster_bwd_wgrad_kernel(const WgradArgs p) {
  constexpr int CPT = wg_cpt<K>();
  constexpr int CIB = WG_LANES * CPT;           // C_in per block
  constexpr int AW = WG_M + K - 1;              // window of a C_in row
  constexpr int ALD = AW % 2 ? AW : AW + 1;     // odd stride: rows on distinct banks
  constexpr int HK = (K - 1) / 2;
  __shared__ __align__(16) float gs[2][WG_M][WG_GLD];
  __shared__ float as[2][CIB][ALD];

  const int ci0 = blockIdx.x * CIB;
  const int co0 = blockIdx.y * WG_CO;
  const int s = blockIdx.z;
  const int d = p.d, T = p.T;
  const int tid = threadIdx.x;
  const int cl = tid & (WG_LANES - 1), cg = tid / WG_LANES;  // compute lanes
  const int gm = tid & (WG_M - 1), grow = tid / WG_M;        // G copy lanes
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
      for (int n = 0; n < WG_CO / (WG_THREADS / WG_M); ++n) {
        const int row = grow + (WG_THREADS / WG_M) * n;
        const bool v = in && co0 + row < p.Co;
        cp_async_4(&gs[st][gm][row], v ? src + (size_t)row * T : p.g, v);
      }
    }
    for (int e = tid; e < CIB * AW; e += WG_THREADS) {
      const int row = e / AW, pp = e - row * AW;
      const int t = r + d * (m0 + pp - HK);
      const bool v = t >= 0 && t < T && ci0 + row < p.Ci;
      cp_async_4(&as[st][row][pp],
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
    for (int e = tid; e < CIB * AW; e += WG_THREADS) {  // lrelu of own copies
      const int row = e / AW, pp = e - row * AW;
      as[st][row][pp] = lrelu(as[st][row][pp]);
    }
    __syncthreads();
    // each position's K taps are K consecutive window values: per block of
    // 8 positions a thread reads 8 + K - 1 values of its C_in row once
#pragma unroll 1
    for (int mb = 0; mb < WG_M; mb += 8) {
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

  float* dw = p.dw + (size_t)s * p.slice_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + 8 * cg + i;
    if (co >= p.Co) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ci = ci0 + cl * CPT + c;
      if (ci >= p.Ci) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) dw[((size_t)co * K + j) * p.Ci + ci] = acc[c][i][j] * p.g_scale;
    }
    if (do_bias && cl == 0) p.db[(size_t)s * p.slice_stride + co] = bsum[i] * p.g_scale;
  }
}

template <int K>
int launch_wgrad(const WgradArgs& p, cudaStream_t stream) {
  dim3 grid((p.Ci + WG_LANES * wg_cpt<K>() - 1) / (WG_LANES * wg_cpt<K>()),
            (p.Co + WG_CO - 1) / WG_CO, p.nslices);
  cluster_bwd_wgrad_kernel<K><<<grid, WG_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

__global__ void cluster_bwd_reduce_kernel(const float* __restrict__ parts,
                                          float* __restrict__ out, long long n, int nslices) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
#pragma unroll 4
  for (int s = 0; s < nslices; ++s) v += parts[(size_t)s * n + i];
  out[i] = v;
}

}  // namespace

#define NSVB_CONV_CASE(KK)                                                     \
  case KK:                                                                     \
    return dgrad ? launch_conv<KK, true>(a, B, st) : launch_conv<KK, false>(a, B, st);

extern "C" int nsvb_cluster_bwd_conv(const void* in, const void* w, const void* bias,
                                     const void* mask, const void* res, void* out, int B,
                                     int Cr, int Co, int T, int k, int d, int ldw, int dgrad,
                                     int accumulate, float in_scale, float res_scale,
                                     void* stream) {
  if (B <= 0 || B > 65535 || Cr <= 0 || Co <= 0 || T <= 0 || d <= 0 || ldw < Co ||
      ldw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.in = (const float*)in; a.w = (const float*)w; a.bias = (const float*)bias;
  a.mask = (const float*)mask; a.res = (const float*)res; a.out = (float*)out;
  a.Cr = Cr; a.Co = Co; a.T = T; a.d = d; a.ldw = ldw;
  a.ntl = ((T + d - 1) / d + CV_TL - 1) / CV_TL;
  a.accumulate = accumulate; a.in_scale = in_scale; a.res_scale = res_scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    NSVB_CONV_CASE(3)
    NSVB_CONV_CASE(5)
    NSVB_CONV_CASE(7)
    NSVB_CONV_CASE(9)
    NSVB_CONV_CASE(11)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#define NSVB_WGRAD_CASE(KK) \
  case KK:                      \
    return launch_wgrad<KK>(p, st);

extern "C" int nsvb_cluster_bwd_wgrad(const void* g, const void* a, void* dw, void* db,
                                      int B, int Co, int Ci, int T, int k, int d,
                                      int nslices, long long slice_stride, float g_scale,
                                      void* stream) {
  if (B <= 0 || Co <= 0 || Ci <= 0 || T <= 0 || d <= 0 || nslices <= 0 || nslices > 65535)
    return (int)cudaErrorInvalidValue;
  WgradArgs p;
  p.g = (const float*)g; p.a = (const float*)a; p.dw = (float*)dw; p.db = (float*)db;
  p.B = B; p.Co = Co; p.Ci = Ci; p.T = T; p.d = d;
  p.ntl = ((T + d - 1) / d + WG_ITEM - 1) / WG_ITEM;
  const long long items = (long long)B * d * p.ntl;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.nitems = (int)items;
  p.nslices = nslices; p.slice_stride = slice_stride; p.g_scale = g_scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    NSVB_WGRAD_CASE(3)
    NSVB_WGRAD_CASE(5)
    NSVB_WGRAD_CASE(7)
    NSVB_WGRAD_CASE(9)
    NSVB_WGRAD_CASE(11)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nsvb_cluster_bwd_reduce(const void* parts, void* out, long long n, int nslices,
                                       void* stream) {
  if (n <= 0 || nslices <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  cluster_bwd_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>((const float*)parts, (float*)out, n,
                                                      nslices);
  return (int)cudaGetLastError();
}
