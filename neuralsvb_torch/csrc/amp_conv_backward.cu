// Backward of BigVGAN's AMPBlock1 convolutions for Hopper (sm_90a), f32 FFMA:
// the input gradient (dgrad), the weight gradient (wgrad) and the bias's.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. Added because on
// the card the 108 tower convolutions of a BigVGAN-v2 training step (6
// stages x 3 towers, K = 3, 7, 11, dilations 1, 3, 5 and then 1, at 768 ...
// 24 channels over 4 x 1024 ... 4 x 65536 positions) had their gradients in
// cuDNN's legacy float32 engines (`dgrad_engine`, `wgrad_alg0_engine`), the
// largest cost of the step. The forward stays cuDNN's; the AMP activation's
// own backward kernel (csrc/amp_activation.cu) applies the activation's
// derivative, so these kernels carry no load transform and no epilogue
// other than the store. neuralsvb_torch/ops/amp_conv.py
// (`amp_conv_backward_cuda`) drives them; `amp_conv_backward_plain` beside
// it is the same decomposition in F.conv1d.
//
// For y = b + conv_{K,d}(x) (zero padding (K-1)/2 * d a side, y as long as
// x), W [Co, Ci, K], and g = dL/dy:
//
//   dx[i, t]    = sum_o sum_j W[o, i, j] g[o, t - (j - (K-1)/2) d]
//   dW[o, i, j] = sum_{b,t} g[b, o, t] x[b, i, t + (j - (K-1)/2) d]
//   db[o]       = sum_{b,t} g[b, o, t]
//
// What bounds it: operations. dgrad and wgrad are each 2 Co Ci K T B FLOPs,
// in plain f32 (no TF32, no bf16): over a bigvgan_train step the 108
// convolutions' backward is 2 x 1.788 TFLOP, at least 53.4 ms at the
// card's 67 TFLOP/s f32 FFMA rate. The design keeps the FFMA pipes fed, as
// csrc/cluster_backward.cu's kernels for HiFiGAN do (that file stays as it
// is: its loads and epilogues fuse leaky-ReLU, its tiles suit 512-128
// channels at 16 x 8192 or less):
//
// - `tower_conv_dgrad_kernel<K, CO>` is an implicit GEMM over Co x K taps.
//   A block computes CO input channels x 8192 / CO positions of one residue
//   class t = r + d m (the "lattice" of the dilation), so the K taps are K
//   consecutive lattice positions: each thread holds an 8 (channel) x 8
//   (position) register tile and, per reduction channel, loads 8 + K - 1
//   window values once and reuses them across the K taps (64 K FFMA per
//   2 K + 5 float4 shared loads at K = 11). The weights (read in W's own
//   layout, transposed and their taps flipped on the way in, so that no
//   copy of W is made) and the window (with its K - 1 lattice halo; zero
//   outside [0, T) by the copies' zero fill) are staged in shared memory
//   16 channels at a time (8 for the narrowest tile) by cp.async, double
//   buffered. CO is 64 for the wide stages and 32, 16 or 8 where the
//   channels are fewer (96, 48, 24), so that no tile masks most of its
//   lanes.
// - `tower_conv_wgrad_kernel<K, COL>` uses the same lattice: a thread holds
//   8 Co x 1 Ci (2 for K <= 5) x K taps; for each position of a residue
//   class it reads 8 gradient values (2 float4 shared loads) for 8K FFMA,
//   and its Ci row's window of 8 + K - 1 values once per 8 positions. A
//   block of 128 threads covers 8 COL Co x 16 (32) Ci; where the channels
//   are few (COL < 8) its 128 / (16 COL) groups of threads take every
//   group-th block of 8 positions (of 64 staged a step where the groups
//   are 8) and add their sums in group order in shared memory at the end.
//   A block sums over its share of the work items (b, residue class, 64
//   lattice positions), taken in a fixed order, and writes its partial
//   sums, with the bias's, to its slice's row of the workspace;
//   `tower_conv_reduce_kernel` adds the rows in row order (with `lanes` > 1
//   threads each add every lanes-th row, and the lanes' sums are added in
//   lane order). No atomics: two calls give bit-equal gradients.
//
// The wrapper launches the wgrad and its reduction on a second stream, so
// that they fill the dgrad's partial last waves. Ragged C and T are masked
// in the copies and the stores. K is a template parameter, built for the
// tower kernel sizes 3, 7 and 11; the entries refuse others. No kernel here
// is named like another layer's kernels.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): the 108 convolutions' backward
// at the bigvgan_train step's shapes in 125 ms between events, 43% of the
// 53.4 ms least time, against 134 ms of cuDNN's engines; the two widest
// stages run at 44-48%, no faster than cuDNN there, the narrow ones gain
// most. Blocks per SM, channels a stage, wgrad blocks and narrower tiles
// moved the total by about 3%; one stream for both is 6% slower.
//
// C interface (loaded with ctypes, no PyTorch headers); every int entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take:
//   nsvb_tower_dgrad(g, w, dx, B, Co, Ci, T, k, d, co_tile, stream)
//     g [B, Co, T]; W [Co, Ci, k]; dx [B, Ci, T] written; co_tile (Ci per
//     block) in {8, 16, 32, 64}
//   nsvb_tower_wgrad(g, x, parts, B, Co, Ci, T, k, d, nslices, col, stream)
//     g [B, Co, T], x [B, Ci, T]; parts [nslices, n], n = Co Ci k + Co:
//     slice s's sums at parts[s n + (o Ci + i) k + j] and the bias's at
//     parts[s n + Co Ci k + o]; col (Co lanes of 8) in {1, 2, 4, 8}
//   nsvb_tower_reduce(parts, dw, db, nw, n, nslices, lanes, stream)
//     dw[i] (i < nw) and db[i - nw] (i >= nw) = the sum over s of
//     parts[s n + i]; lanes in {1, 2, 4, 8}

#include <cuda_runtime.h>

namespace {

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

constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

constexpr int DG_PT = 8;  // positions per thread

template <int CO>
__host__ __device__ constexpr int dg_tl() { return (THREADS / (CO / 8)) * DG_PT; }
// reduction channels per pipeline stage: 16, and 8 for the narrowest tile,
// whose window row is longest
template <int CO>
__host__ __device__ constexpr int dg_cic() { return CO >= 16 ? 16 : 8; }
template <int CO>
__host__ __device__ constexpr int dg_xw() { return dg_tl<CO>() + 16; }  // TL + K - 1, K <= 11
template <int K, int CO>
__host__ __device__ constexpr int dg_stage_floats() {
  return dg_cic<CO>() * K * CO + dg_cic<CO>() * dg_xw<CO>();
}

struct DgradArgs {
  const float* g;
  const float* w;
  float* out;
  int Cr, Co, T, d, ntl;
};

template <int K, int CO>
__global__ void __launch_bounds__(THREADS, 3)
tower_conv_dgrad_kernel(const DgradArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NCL = CO / 8;             // channel lanes
  constexpr int TL = dg_tl<CO>();         // lattice positions per block
  constexpr int CIC = dg_cic<CO>();        // reduction channels per stage
  constexpr int XW = dg_xw<CO>();
  constexpr int WS = CIC * K * CO;
  constexpr int STAGE = dg_stage_floats<K, CO>();
  constexpr int HK = (K - 1) / 2;
  constexpr int NX = (DG_PT + K - 1 + 3) / 4 * 4;  // window values a thread reads
  static_assert(CIC * XW % THREADS == 0, "window copies per thread");
  static_assert(TL - DG_PT + NX <= XW, "window row too short for K");

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
  const float* g_b = a.g + (size_t)b * a.Cr * T;

  auto stage = [&](int c0, int s) {
    float* ws = smem + s * STAGE;
    float* xs = ws + WS;
    // W [Cr, Co, K] in its own layout, transposed on the way in: element
    // (c, tap K-1-j, o) to ws[(c K + j) CO + o], o fastest (no bank
    // conflicts on the stores; the loads hit one stretch of CO K floats)
    for (int q = tid; q < CIC * K * CO; q += THREADS) {
      const int row = q / CO, o = q - row * CO;
      const int c = row / K, j = row - c * K;
      const int cg = c0 + c, og = o0 + o;
      const bool valid = cg < a.Cr && og < a.Co;
      cp_async_4(ws + q, valid ? a.w + ((size_t)cg * a.Co + og) * K + (K - 1 - j) : a.w,
                 valid);
    }
#pragma unroll 4
    for (int n = 0; n < CIC * XW / THREADS; ++n) {
      const int q = tid + n * THREADS;
      const int c = q / XW, p = q - c * XW;
      const int cg = c0 + c;
      const int t = r + d * (m0 - HK + p);
      const bool valid = p < TL + K - 1 && cg < a.Cr && t >= 0 && t < T;
      cp_async_4(xs + q, valid ? g_b + (size_t)cg * T + t : a.g, valid);
    }
  };

  float acc[8][DG_PT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < DG_PT; ++jj) acc[i][jj] = 0.f;

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
    __syncthreads();
    const float* ws = smem + s * STAGE;
    const float* xs = ws + WS;
#pragma unroll 1
    for (int c = 0; c < CIC; ++c) {
      float xv[NX];
      const float* xr = xs + c * XW + DG_PT * tx;
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
          for (int jj = 0; jj < DG_PT; ++jj) acc[i][jj] = fmaf(wv[i], xv[jj + j], acc[i][jj]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  float* __restrict__ out = a.out;
  const size_t plane = (size_t)b * a.Co * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + 8 * ty + i;
    if (o >= a.Co) continue;
    const size_t row = plane + (size_t)o * T + r;
#pragma unroll
    for (int jj = 0; jj < DG_PT; ++jj) {
      const int m = m0 + DG_PT * tx + jj;
      if (m < Tr) out[row + (size_t)d * m] = acc[i][jj];
    }
  }
}

template <int K, int CO>
int launch_dgrad(DgradArgs a, int B, cudaStream_t stream) {
  constexpr int TL = dg_tl<CO>();
  a.ntl = ((a.T + a.d - 1) / a.d + TL - 1) / TL;
  const int bytes = 2 * dg_stage_floats<K, CO>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tower_conv_dgrad_kernel<K, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.d * a.ntl, (a.Co + CO - 1) / CO, B);
  tower_conv_dgrad_kernel<K, CO><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int dgrad_tile(const DgradArgs& a, int B, int co_tile, cudaStream_t stream) {
  switch (co_tile) {
    case 64: return launch_dgrad<K, 64>(a, B, stream);
    case 32: return launch_dgrad<K, 32>(a, B, stream);
    case 16: return launch_dgrad<K, 16>(a, B, stream);
    case 8: return launch_dgrad<K, 8>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgrad and its reduction
// ---------------------------------------------------------------------------

constexpr int WG_CIL = 16;      // Ci lanes per block
constexpr int WG_ITEM = 64;     // lattice positions per work item

struct WgradArgs {
  const float* g;
  const float* a;
  float* parts;
  int B, Co, Ci, T, d, ntl, nitems, nslices;
  long long n;
};

// Ci per thread: two rows of taps where the taps are few
template <int K>
__host__ __device__ constexpr int wg_cpt() { return K <= 5 ? 2 : 1; }

template <int K, int COL>
__global__ void __launch_bounds__(THREADS)
tower_conv_wgrad_kernel(const WgradArgs p) {
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
  const bool do_bias = blockIdx.x == 0;
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
        cp_async_4(&gs[st][gm][row], v ? src + (size_t)row * T : p.g, v);
      }
    }
    for (int e = tid; e < CIB * AW; e += THREADS) {
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

  float* dw = p.parts + (size_t)s * p.n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + 8 * cg + i;
    if (co >= p.Co) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ci = ci0 + cl * CPT + c;
      if (ci >= p.Ci) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) dw[((size_t)co * p.Ci + ci) * K + j] = acc[c][i][j];
    }
    if (do_bias && cl == 0) dw[(size_t)p.Co * p.Ci * K + co] = bsum[i];
  }
}

template <int K, int COL>
int launch_wgrad(const WgradArgs& p, cudaStream_t stream) {
  constexpr int CIB = WG_CIL * wg_cpt<K>();
  dim3 grid((p.Ci + CIB - 1) / CIB, (p.Co + 8 * COL - 1) / (8 * COL), p.nslices);
  tower_conv_wgrad_kernel<K, COL><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int K>
int wgrad_tile(const WgradArgs& p, int col, cudaStream_t stream) {
  switch (col) {
    case 8: return launch_wgrad<K, 8>(p, stream);
    case 4: return launch_wgrad<K, 4>(p, stream);
    case 2: return launch_wgrad<K, 2>(p, stream);
    case 1: return launch_wgrad<K, 1>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int RD_THREADS = 256;

__global__ void __launch_bounds__(RD_THREADS)
tower_conv_reduce_kernel(const float* __restrict__ parts, float* __restrict__ dw,
                         float* __restrict__ db, long long nw, long long n, int nslices,
                         int lanes) {
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
  if (i >= n) return;
  if (i < nw) dw[i] = v;
  else db[i - nw] = v;
}

}  // namespace

#define NSVB_TOWER_CASE(KK, CALL) \
  case KK:                        \
    return CALL;

extern "C" int nsvb_tower_dgrad(const void* g, const void* w, void* dx, int B, int Co, int Ci,
                                int T, int k, int d, int co_tile, void* stream) {
  if (B <= 0 || B > 65535 || Co <= 0 || Ci <= 0 || T <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  DgradArgs a;
  a.g = (const float*)g; a.w = (const float*)w; a.out = (float*)dx;
  a.Cr = Co; a.Co = Ci; a.T = T; a.d = d; a.ntl = 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    NSVB_TOWER_CASE(3, dgrad_tile<3>(a, B, co_tile, st))
    NSVB_TOWER_CASE(7, dgrad_tile<7>(a, B, co_tile, st))
    NSVB_TOWER_CASE(11, dgrad_tile<11>(a, B, co_tile, st))
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nsvb_tower_wgrad(const void* g, const void* x, void* parts, int B, int Co,
                                int Ci, int T, int k, int d, int nslices, int col,
                                void* stream) {
  if (B <= 0 || Co <= 0 || Ci <= 0 || T <= 0 || d <= 0 || nslices <= 0 || nslices > 65535)
    return (int)cudaErrorInvalidValue;
  WgradArgs p;
  p.g = (const float*)g; p.a = (const float*)x; p.parts = (float*)parts;
  p.B = B; p.Co = Co; p.Ci = Ci; p.T = T; p.d = d;
  p.ntl = ((T + d - 1) / d + WG_ITEM - 1) / WG_ITEM;
  const long long items = (long long)B * d * p.ntl;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.nitems = (int)items;
  p.nslices = nslices;
  p.n = (long long)Co * Ci * k + Co;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    NSVB_TOWER_CASE(3, wgrad_tile<3>(p, col, st))
    NSVB_TOWER_CASE(7, wgrad_tile<7>(p, col, st))
    NSVB_TOWER_CASE(11, wgrad_tile<11>(p, col, st))
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nsvb_tower_reduce(const void* parts, void* dw, void* db, long long nw,
                                 long long n, int nslices, int lanes, void* stream) {
  if (nw <= 0 || n <= nw || nslices <= 0 || db == nullptr ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8))
    return (int)cudaErrorInvalidValue;
  const long long per = RD_THREADS / lanes;
  tower_conv_reduce_kernel<<<(unsigned)((n + per - 1) / per), RD_THREADS, 0,
                             (cudaStream_t)stream>>>((const float*)parts, (float*)dw,
                                                     (float*)db, nw, n, nslices, lanes);
  return (int)cudaGetLastError();
}
