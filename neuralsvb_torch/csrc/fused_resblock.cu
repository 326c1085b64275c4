// HiFiGAN ResBlock1 cluster convolution for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `_cluster_kernel` /
// `fused_resblock_cluster_nct` in neuralsvb_tpu/ops/fused_resblock.py. Per
// upsample stage the vocoder averages three ResBlock1 towers (k = 3/7/11,
// dilations 1/3/5): 18 dilated convolutions with leaky-ReLU inputs and
// residual adds. neuralsvb_torch/ops/fused_resblock.py launches this kernel
// once per convolution (18 launches per stage) and keeps the whole cluster
// inside it: leaky-ReLU and sequence-edge zeroing are applied while the
// input is loaded, and bias, residual add and the running tower mean are
// applied in the epilogue, so no elementwise op runs outside the kernel.
//
// What bounds it on this card: compute. One stage costs 126*C^2*T
// multiply-adds (each conv is C*C*k MACs per output sample, 2*(3+7+11)*3
// taps over the 18 convs), which is about C*k MACs for every element loaded
// from device memory (C = 256/128/64). The kernel is an implicit GEMM in
// plain f32 FFMA: each block computes a 64 (C_out) x 128 (time) tile and
// walks K = k*C_in as (32-channel C_in chunk, tap). For one chunk it stages
// the input window [32][128 + (k-1)*d] in shared memory once (leaky-ReLU and
// zero padding outside [0, T) applied on load) and then, tap by tap, a
// [32][64] weight tile; each of the 128 threads accumulates an 8 (C_out) x 8
// (time) register tile, and up to four blocks share an SM.
//
// Why the TPU design does not carry over: the TPU kernel kept every weight
// of the cluster resident in its multi-megabyte VMEM (about 16.5 MB in bf16
// at C = 256) and ran all 18 convs on one time tile with a halo. An SM has
// at most 227 KB of shared memory, so here each conv's weights (at most
// 11*256*256*4 B = 2.9 MB) are streamed from L2 (50 MB), which holds them
// across the blocks of one launch, and the intermediates `y` and `cur`
// round-trip device memory between launches.
//
// C interface (loaded with ctypes, no PyTorch headers):
//   int nsvb_resblock_conv1d(in, w, bias, res, out, acc, acc_accumulate,
//                            acc_scale, B, C, T, k, d, stream)
//   in   [B, C, T] f32     conv input before leaky-ReLU
//   w    [C, k, C] f32     packed weight [C_out, tap, C_in]
//   bias [C] f32
//   res  [B, C, T] f32 or NULL   residual added to the conv result
//   out  [B, C, T] f32 or NULL   result written here (may alias res)
//   acc  [B, C, T] f32 or NULL   acc = ((acc_accumulate ? acc : 0) + result) * acc_scale
// Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BCO = 64;       // output channels per block
constexpr int BT = 128;       // time steps per block
constexpr int BCI = 32;       // input channels per K chunk
constexpr int MAX_HALO = 64;  // largest (k-1)*d the window holds
constexpr int THREADS = 128;  // 16 x 8 threads, 8 C_out x 8 time each
constexpr float SLOPE = 0.1f;

__global__ void __launch_bounds__(THREADS, 4)
resblock_conv1d_kernel(const float* __restrict__ in,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* res, float* out, float* acc,
                       int acc_accumulate, float acc_scale,
                       int C, int T, int k, int d) {
  __shared__ float xs[BCI][BT + MAX_HALO];
  __shared__ __align__(16) float ws[BCI][BCO + 4];  // rows 16-byte aligned

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * BCO;
  const int t0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // time lane: t = tx + 16 * jj
  const int ty = tid / 16;  // channel lane: co = 8 * ty + i
  const int half = (k - 1) / 2 * d;
  const int win = BT + (k - 1) * d;
  const float* in_b = in + (size_t)b * C * T;

  float accv[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) accv[i][jj] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += BCI) {
    __syncthreads();  // previous chunk's readers are done with xs / ws
    for (int idx = tid; idx < BCI * win; idx += THREADS) {
      const int c = idx / win;
      const int p = idx - c * win;
      const int t = t0 - half + p;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < C && t >= 0 && t < T) {
        v = in_b[(size_t)ci * T + t];
        v = v >= 0.f ? v : SLOPE * v;
      }
      xs[c][p] = v;
    }
    for (int j = 0; j < k; ++j) {
      if (j > 0) __syncthreads();  // readers of the previous tap's ws
      for (int idx = tid; idx < BCI * BCO; idx += THREADS) {
        const int co = idx / BCI;
        const int c = idx - co * BCI;
        float v = 0.f;
        if (co0 + co < C && ci0 + c < C)
          v = w[((size_t)(co0 + co) * k + j) * C + ci0 + c];
        ws[c][co] = v;
      }
      __syncthreads();
      const int off = j * d;
#pragma unroll 8
      for (int c = 0; c < BCI; ++c) {
        float wv[8], xv[8];
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[c][8 * ty]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[c][8 * ty + 4]);
        wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
        wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) xv[jj] = xs[c][tx + 16 * jj + off];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) accv[i][jj] = fmaf(wv[i], xv[jj], accv[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + 8 * ty + i;
    if (co >= C) continue;
    const float bv = bias[co];
    const size_t row = ((size_t)b * C + co) * T;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int t = t0 + tx + 16 * jj;
      if (t >= T) continue;
      float v = accv[i][jj] + bv;
      if (res != nullptr) v += res[row + t];
      if (out != nullptr) out[row + t] = v;
      if (acc != nullptr) {
        const float prev = acc_accumulate ? acc[row + t] : 0.f;
        acc[row + t] = (prev + v) * acc_scale;
      }
    }
  }
}

}  // namespace

extern "C" int nsvb_resblock_conv1d(const void* in, const void* w,
                                    const void* bias, const void* res,
                                    void* out, void* acc, int acc_accumulate,
                                    float acc_scale, int B, int C, int T,
                                    int k, int d, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || k <= 0 || d <= 0 || k % 2 == 0 ||
      (k - 1) * d > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + BT - 1) / BT, (C + BCO - 1) / BCO, B);
  resblock_conv1d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)w, (const float*)bias,
      (const float*)res, (float*)out, (float*)acc, acc_accumulate, acc_scale,
      C, T, k, d);
  return (int)cudaGetLastError();
}
