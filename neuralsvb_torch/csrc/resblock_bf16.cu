// HiFiGAN ResBlock1 cluster convolution for Hopper (sm_90a): bf16 operands
// on the tensor cores (wgmma), TMA loads, f32 accumulation.
//
// Replaces the Pallas TPU kernel `_cluster_kernel` /
// `fused_resblock_cluster_nct` in neuralsvb_tpu/ops/fused_resblock.py with
// that kernel's arithmetic: every conv operand is bf16(leaky_relu_f32(v)),
// zero outside [0, T); weights are bf16 in the layout of `_pack_tower(...,
// mm_dtype=bf16)`; biases, products' sums, the residual chain `cur` and the
// tower mean are f32. neuralsvb_torch/ops/fused_resblock.py launches
// `nsvb_lrelu_bf16` once per stage (the operand of the stage input, shared by
// the three towers) and `nsvb_resblock_conv1d_bf16` once per convolution (18
// per stage).
//
// What bounds it on this card. A stage is 126*C^2*T multiply-adds (C =
// 256/128/64). On the f32 FFMA pipe that was compute-bound; on the bf16
// tensor cores (989 TFLOP/s dense) the limits are the bytes: device memory
// between launches, and L2 -> shared memory inside a launch (the weight
// tile of every tap, the operand rows of every 64-channel chunk). The
// design:
//
// - Implicit GEMM per conv, D[C_out, time] = sum over (C_in chunk, tap) of
//   W[C_out, tap, chunk] x X[chunk, time + (tap - (k-1)/2) * d]. A block owns
//   64*WM output channels x 128 time steps; WM consumer warpgroups (WM = 2
//   when C is a multiple of 128, else 1) each issue wgmma.m64n128k16 with
//   both operands K-major in shared memory, in the 128-byte swizzle.
// - The bf16 operands are stored channels-last, [B][T][C]: a tap's shift
//   then moves the TMA box along time rows, which may start anywhere (even
//   before 0), while a box's innermost coordinate must be 16-byte aligned.
//   The f32 tensors (the stage input, `cur`, the mean) keep the model's
//   [B][C][T]. The pre-pass transposes.
// - Persistent blocks: the grid is what the SMs hold at once, and each
//   block walks output tiles (channel tile fastest, so neighbours share
//   operand rows in L2). One producer warp feeds a ring of STAGES
//   shared-memory stages with TMA and mbarriers, running on into the next
//   tile while the consumers finish this one's epilogue. Per 64-channel
//   chunk it loads one operand window, 128 + (k-1)*d time rows of the 3-D
//   map [B][T][C] from t0 - (k-1)/2*d, into a double buffer; per (chunk,
//   tap) it loads the weight tile, one box of the 3-D map [C_out][k][C_in],
//   into a STAGES-deep ring. Tap j reads the window through a descriptor
//   that starts j*d rows in: the 128-byte swizzle follows the shared-memory
//   address bits, so any row is a valid start (base offset 0). The k taps
//   thus share one load of the operand rows. TMA's zero fill outside the
//   tensor gives the exact per-item sequence-edge padding (and channel
//   padding when C is not a multiple of 64) with no masking code.
// - Fused epilogues keep device traffic at about 16 bytes per element per
//   dilation pair: conv1 writes only bf16(leaky_relu(y + b1)); conv2 adds b2
//   and the f32 residual and writes the f32 `cur` (when another dilation
//   follows) and bf16(leaky_relu(cur)), the next conv's operand, or folds the
//   tower's result into the running f32 mean.
//
// Accumulator layout of wgmma.m64n128k16 (f32): thread l of warp w in the
// warpgroup holds rows 16w + l/4 (+8) and columns 8i + 2(l%4) (+1), i < 16.
//
// C interface (loaded with ctypes, no PyTorch headers, no -lcuda: the tensor
// maps are encoded through cudaGetDriverEntryPoint):
//   int nsvb_lrelu_bf16(x, out, B, C, T, stream)
//     x [B, C, T] f32 -> out [B, T, C] bf16 = bf16(leaky_relu(x))
//   int nsvb_resblock_conv1d_bf16(op, w, bias, res, cur_out, op_out, mean,
//                                 mean_accumulate, mean_scale, B, C, T, k, d,
//                                 stream)
//     op   [B, T, C] bf16   conv operand (already bf16(leaky_relu(.)))
//     w    [C, k, C] bf16   packed weight [C_out, tap, C_in]
//     bias [C] f32
//     res  [B, C, T] f32 or NULL   residual added to the conv result v
//     cur_out [B, C, T] f32 or NULL    v (may alias res)
//     op_out  [B, T, C] bf16 or NULL   bf16(leaky_relu(v))
//     mean    [B, C, T] f32 or NULL    ((mean_accumulate ? mean : 0) + v) * mean_scale
//     C % 8 == 0 and T % 8 == 0 (TMA strides are multiples of 16 bytes).
// Both return cudaGetLastError() after the launch (or an error code for
// arguments the kernel does not take).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 128;                  // time steps per block
constexpr int BK = 64;                   // input channels per K step (128 bytes)
constexpr int STAGES = 4;                // weight-tile ring depth
constexpr int A_TILE = 64 * BK * 2;      // one warpgroup's weight tile, 8 KB
constexpr int ROW = BK * 2;              // one operand window row, 128 bytes
constexpr int MAX_WIN = 256;             // TMA's largest box: (k-1)*d <= 128
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `parity` to complete. A pipeline that never
// completes (a TMA load that cannot land) traps after about 2^34 cycles
// (several seconds) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// (rows of 64 bf16, groups of 8 rows 1024 bytes apart; the leading byte
// offset is unused in this mode and set to 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], both K-major, bf16 -> f32.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Rows of an operand window, rounded up to 8 (1024 bytes) so the second
// buffer starts on the swizzle's 1024-byte grid.
__host__ __device__ constexpr int win_rows(int k, int d) { return (BN + (k - 1) * d + 7) / 8 * 8; }

template <int WM>
constexpr int smem_bytes(int rows) {
  return STAGES * WM * A_TILE + 2 * rows * ROW + 2 * (STAGES + 2) * 8 + 1024;  // + alignment
}

// WM consumer warpgroups (warps 0 .. 4*WM-1) and one producer warp.
template <int WM>
__global__ void __launch_bounds__(128 * WM + 32, WM == 1 ? 2 : 1)
resblock_conv1d_bf16_kernel(const __grid_constant__ CUtensorMap tm_op,
                            const __grid_constant__ CUtensorMap tm_w,
                            const float* __restrict__ bias, const float* res, float* cur_out,
                            __nv_bfloat16* op_out, float* mean, int mean_accumulate,
                            float mean_scale, int B, int C, int T, int k, int d) {
  extern __shared__ uint8_t smem_raw[];
  const int rows = win_rows(k, d), win_bytes = rows * ROW;
  // TMA's 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_base = base;                            // [STAGES][WM*64][64] bf16
  const uint32_t w_base = base + STAGES * WM * A_TILE;     // [2][rows][64] bf16
  const uint32_t full_a = w_base + 2 * win_bytes;          // STAGES mbarriers each
  const uint32_t empty_a = full_a + STAGES * 8;
  const uint32_t full_w = empty_a + STAGES * 8;            // 2 mbarriers each
  const uint32_t empty_w = full_w + 2 * 8;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = (C + BK - 1) / BK;
  const int n_co = (C + 64 * WM - 1) / (64 * WM), n_t = (T + BN - 1) / BN;
  const int n_tiles = n_co * n_t * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 4 * WM);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_w + 8 * s, 1);
      mbar_init(empty_w + 8 * s, 4 * WM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ga counts this block's weight tiles and gw its operand windows over all
  // its tiles: ring slot g % depth, phase parity (g / depth) & 1, the same
  // sequences on both sides
  if (warp == 4 * WM) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      const int half = (k - 1) / 2 * d;
      int ga = 0, gw = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int co_blk = tile % n_co * 64 * WM;
        const int t0 = tile / n_co % n_t * BN, b = tile / (n_co * n_t);
        for (int chunk = 0; chunk < n_chunks; ++chunk, ++gw) {
          const int ws = gw % 2;
          mbar_wait(empty_w + 8 * ws, ((gw / 2) & 1) ^ 1);
          mbar_expect_tx(full_w + 8 * ws, (BN + (k - 1) * d) * ROW);
          tma_load_3d(w_base + ws * win_bytes, &tm_op, full_w + 8 * ws, chunk * BK, t0 - half, b);
          for (int tap = 0; tap < k; ++tap, ++ga) {
            const int s = ga % STAGES;
            mbar_wait(empty_a + 8 * s, ((ga / STAGES) & 1) ^ 1);
            mbar_expect_tx(full_a + 8 * s, WM * A_TILE);
            tma_load_3d(a_base + s * WM * A_TILE, &tm_w, full_a + 8 * s, chunk * BK, tap, co_blk);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output channels co_blk + 64*wg .. +64
  const int wg = warp / 4;
  int ga = 0, gw = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int co_blk = tile % n_co * 64 * WM;
    const int t0 = tile / n_co % n_t * BN, b = tile / (n_co * n_t);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk, ++gw) {
      const int ws = gw % 2;
      mbar_wait(full_w + 8 * ws, (gw / 2) & 1);
      for (int tap = 0; tap < k; ++tap, ++ga) {
        const int s = ga % STAGES;
        mbar_wait(full_a + 8 * s, (ga / STAGES) & 1);
        const uint32_t a = a_base + s * WM * A_TILE + wg * A_TILE;
        const uint32_t bt = w_base + ws * win_bytes + tap * d * ROW;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 channels = 32 bytes of each row
          wgmma_m64n128k16(acc, sw128_desc(a + 32 * kk), sw128_desc(bt + 32 * kk));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(acc);
        // the previous step's products are done: hand back its weight tile
        // and, after a chunk's last tap, its window
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (lane == 0 && (chunk > 0 || tap > 0)) {
          mbar_arrive(empty_a + 8 * ((ga - 1) % STAGES));
          if (tap == 0) mbar_arrive(empty_w + 8 * ((gw - 1) % 2));
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (lane == 0) {  // the tile's last weight tile and window
      mbar_arrive(empty_a + 8 * ((ga - 1) % STAGES));
      mbar_arrive(empty_w + 8 * ((gw - 1) % 2));
    }

    // Epilogue in passes, each pass's loads before any store: `res` and
    // `mean` may alias outputs, so a load placed after a store would wait for
    // it and every iteration would pay a full device-memory latency.
    // C % 8 == 0 and T % 8 == 0 keep every test below uniform over a warp
    // (a warp's rows and an i's eight steps are all in range or all out), so
    // the shuffle runs on full warps.
    const int wl = warp % 4;
    const bool even = ((lane >> 2) & 1) == 0;  // this lane's row (channel) is even
    const int co0 = co_blk + 64 * wg + 16 * wl + lane / 4;
    const size_t row0 = (static_cast<size_t>(b) * C + co0) * T;  // channel co0 + 8h: + 8hT
    const int tl = t0 + 2 * (lane % 4);                           // step of i = 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // v = acc + bias (+ res)
      if (co0 + 8 * h >= C) continue;
      const float bv = bias[co0 + 8 * h];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        float2 v = make_float2(acc[4 * i + 2 * h] + bv, acc[4 * i + 2 * h + 1] + bv);
        if (res != nullptr && tl + 8 * i < T) {
          const float2 r = *reinterpret_cast<const float2*>(res + row0 + 8 * h * T + tl + 8 * i);
          v.x += r.x;
          v.y += r.y;
        }
        acc[4 * i + 2 * h] = v.x;
        acc[4 * i + 2 * h + 1] = v.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // cur_out = v, op_out = bf16(lrelu(v))
      const int co = co0 + 8 * h;
      if (co >= C) continue;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int t = tl + 8 * i;
        if (t >= T) continue;  // t + 1 < T too
        const float2 v = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        if (cur_out != nullptr) *reinterpret_cast<float2*>(cur_out + row0 + 8 * h * T + t) = v;
        if (op_out != nullptr) {
          // channels-last: pair this lane's (co, t | t+1) with the neighbour
          // channel's, so each lane stores two adjacent channels of one step
          const float l0 = lrelu(v.x), l1 = lrelu(v.y);
          const float o = __shfl_xor_sync(0xffffffffu, even ? l1 : l0, 4);
          const size_t at = (static_cast<size_t>(b) * T + t + (even ? 0 : 1)) * C + co - (even ? 0 : 1);
          *reinterpret_cast<__nv_bfloat162*>(op_out + at) =
              even ? __floats2bfloat162_rn(l0, o) : __floats2bfloat162_rn(o, l1);
        }
      }
    }
    if (mean != nullptr) {  // mean = ((mean_accumulate ? mean : 0) + v) * mean_scale
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (co0 + 8 * h >= C) continue;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          float2 m = make_float2(0.f, 0.f);
          if (mean_accumulate && tl + 8 * i < T)
            m = *reinterpret_cast<const float2*>(mean + row0 + 8 * h * T + tl + 8 * i);
          acc[4 * i + 2 * h] = (m.x + acc[4 * i + 2 * h]) * mean_scale;
          acc[4 * i + 2 * h + 1] = (m.y + acc[4 * i + 2 * h + 1]) * mean_scale;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (co0 + 8 * h >= C) continue;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          if (tl + 8 * i < T)
            *reinterpret_cast<float2*>(mean + row0 + 8 * h * T + tl + 8 * i) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// [B][C][T] f32 -> [B][T][C] bf16(leaky_relu(.)), through a 64 x 64 tile.
__global__ void __launch_bounds__(256) lrelu_bf16_kernel(const float* __restrict__ x,
                                                         __nv_bfloat16* __restrict__ out,
                                                         int C, int T) {
  __shared__ float tile[64][65];
  const int b = blockIdx.z, c0 = blockIdx.y * 64, t0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int c = i / 64, t = i % 64;
    tile[c][t] = c0 + c < C && t0 + t < T
                     ? lrelu(x[(static_cast<size_t>(b) * C + c0 + c) * T + t0 + t])
                     : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 32; i += 256) {
    const int t = i / 32, c = 2 * (i % 32);
    if (c0 + c < C && t0 + t < T)  // C is even
      *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * T + t0 + t) * C + c0 + c) =
          __floats2bfloat162_rn(tile[c][t], tile[c + 1][t]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D bf16 map, dims innermost first, 128-byte swizzle, zero fill outside.
bool make_map(EncodeTiled enc, CUtensorMap* m, const void* ptr, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t b0, uint32_t b1, uint32_t b2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WM>
int launch(const void* op, const void* w, const void* bias, const void* res, void* cur_out,
           void* op_out, void* mean, int mean_accumulate, float mean_scale, int B, int C, int T,
           int k, int d, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_op, tm_w;
  if (!make_map(enc, &tm_op, op, C, T, B, BK, BN + (k - 1) * d, 1) ||
      !make_map(enc, &tm_w, w, C, k, C, BK, 1, 64 * WM))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = resblock_conv1d_bf16_kernel<WM>;
  const int threads = 128 * WM + 32, smem = smem_bytes<WM>(win_rows(k, d));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<WM>(MAX_WIN));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles =
      static_cast<long long>((C + 64 * WM - 1) / (64 * WM)) * ((T + BN - 1) / BN) * B;
  const int grid = static_cast<int>(tiles < per_sm * sms ? tiles : per_sm * sms);
  kernel<<<grid, threads, smem, stream>>>(
      tm_op, tm_w, static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<float*>(cur_out), static_cast<__nv_bfloat16*>(op_out),
      static_cast<float*>(mean), mean_accumulate, mean_scale, B, C, T, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nsvb_resblock_conv1d_bf16(const void* op, const void* w, const void* bias,
                                         const void* res, void* cur_out, void* op_out,
                                         void* mean, int mean_accumulate, float mean_scale,
                                         int B, int C, int T, int k, int d, void* stream) {
  if (B <= 0 || C <= 0 || C % 8 != 0 || T <= 0 || T % 8 != 0 ||
      static_cast<long long>(B) * T * C >= (1ll << 31) || k <= 0 || k % 2 == 0 || d <= 0 ||
      BN + (k - 1) * d > MAX_WIN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0)
    return launch<2>(op, w, bias, res, cur_out, op_out, mean, mean_accumulate, mean_scale, B, C,
                     T, k, d, s);
  return launch<1>(op, w, bias, res, cur_out, op_out, mean, mean_accumulate, mean_scale, B, C, T,
                   k, d, s);
}

extern "C" int nsvb_lrelu_bf16(const void* x, void* out, int B, int C, int T, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || C % 2 != 0 || (C + 63) / 64 > 65535 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + 63) / 64, (C + 63) / 64, B);
  lrelu_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), C, T);
  return static_cast<int>(cudaGetLastError());
}
