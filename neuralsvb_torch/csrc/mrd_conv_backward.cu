// The float32 backward of BigVGAN's multi-resolution discriminator (MRD) for
// Hopper (sm_90a), in FFMA: the input gradient (dgrad) and the weight and
// bias gradients (wgrad) of the 2-D convolutions of `DiscriminatorR`
// (neuralsvb_torch/models/bigvgan.py), each followed by leaky-ReLU 0.1 but
// the last. neuralsvb_torch/ops/mrd_conv.py binds them and owns the schedule
// (`mrd_conv_backward_cuda`): they run the discriminators' update and the
// generator's (dx alone); the wgrad's slices are added by the fixed-order
// reduction of dilated_conv_backward.cu (`dilated_conv.reduce`).
//
// A layer is y = act(b + conv(x, W)) with x [B, Ci, H, Wi], W [Co, Ci, 3, KW],
// padding (1, P = (KW - 1) / 2), stride (1, SW) and y [B, Co, H, Wo]. From
// the post-activation output y and its gradient dy, with
// g = dy * act'(y) (act' is 1 for y >= 0, also at exactly 0, else 0.1; the
// last layer has no activation: g = dy):
//
//   dx[i, h, w]       = sum_{o, kh, kw: SW | w + P - kw} W[o, i, kh, kw] g[o, h + 1 - kh, (w + P - kw) / SW]
//   dW[o, i, kh, kw]  = sum_{b, h, v} g[b, o, h, v] x[b, i, h + kh - 1, SW v + kw - P]
//   db[o]             = sum_{b, h, v} g[b, o, h, v]
//
// act' is applied where g is staged, from the y staged beside it: no pass
// over the 72-172 MB feature maps of its own.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. Added because the
// MRD's convolution gradients in cuDNN's legacy float32 engines
// (`dgrad_engine`, `wgrad_alg0_engine`) cost a bigvgan_train step 104 ms, 13%
// of their least time.
//
// What bounds it: operations. dgrad and wgrad are each 2 B H Wo Co Ci 3 KW
// FLOPs in plain f32 (no TF32): the least time is the FLOPs at the card's
// 67 TFLOP/s f32 FFMA rate. The design keeps the FFMA pipes fed:
//
// - `mrd_conv_dgrad_kernel<KW, SW, RC, OC, LRELU>` is an implicit GEMM over
//   RC reduction channels x 3 x KW taps into OC output channels. An output
//   column w = SW m + r takes only the taps kw = r + P (mod SW): for the
//   stride-2 layers the even columns take the 5 even taps of the 9, the odd
//   columns the 4 odd ones, and no multiply is spent on inserted zeros (the
//   residue-class trick of dilated_conv_backward.cu applied to a stride).
//   Both classes read the same window of g, so a thread holds TC channels x
//   8 m x SW classes (8 x 8 x 1, 4 x 8 x 2 for the stride-2 layers, 1 x 8
//   for the one-channel output of the first layer) and, per reduction
//   channel and kernel row, loads 8 + 2P / SW window values once for its 9
//   taps (288 FMA per 9 + 3 float4 shared loads at stride 2). Its sums run
//   in three levels (one reduction channel, a stage of 4, the stages in
//   shared memory), so that its relative error against float64 stays under
//   cuDNN's; one chain over the whole reduction read 3x cuDNN's.
//   A block is TH rows x TW 8-column groups of one batch item (TH TW = the
//   position lanes, chosen per call for the least padded work), staging 4
//   reduction channels at a time: their weights (pre-permuted to
//   [RC, 3, KW, OC], 16 bytes a copy) and their g and y windows with a
//   one-row halo (4 bytes a copy, zero outside the map), by cp.async, double
//   buffered. The block's output tile leaves through shared memory, so that
//   a warp stores consecutive columns of a row (measured: the step's dgrad
//   12% faster than with each thread storing its own 8 x SW columns).
// - `mrd_conv_wgrad_kernel<KW, SW, CI, CO, LRELU>` is a 32 x 864 product (at
//   32 channels) reduced over positions: a thread holds TO output channels x
//   1 input channel x KHT kernel rows x KW taps (8 x 1 x 1 x 9, 8 x 1 x 3 x 3,
//   or one channel for the one-channel layers). A work item is 32 output
//   columns of one row (b, h); its x rows are staged split by residue class
//   of the stride, so that each class is a contiguous window: per block of 8
//   positions a thread reads its row's windows once (3 float4 a class) and 8
//   gradient values a position (2 float4) for 72 FMA a position. A block
//   sums its slice's items, taken in a fixed order (the bias's sums, and
//   the one-channel layers' weight sums, item by item with Kahan's
//   compensation), and writes its sums to its slice of a workspace, whose
//   slices `dilated_conv.reduce` adds in a fixed order. No atomics: two
//   calls give bit-equal gradients.
//
// The instances: the wgrad and the dgrad for the MRD's four geometries (KW,
// SW, C_in, C_out) = (9, 1, 1, 32), (9, 2, 32, 32), (3, 1, 32, 32) and (3, 1,
// 32, 1), the last without the activation; the entries refuse any other.
// Kernel height 3 throughout.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): see PERF.md §6. Moving the
// bias's sums out of the wgrad's inner loop, 64-column work items, two
// blocks an SM instead of three and, for the wgrad, four moved nothing or
// lost 1-5%.
//
// C interface (loaded with ctypes, no PyTorch headers); every int entry
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take. (kw, sw, ci, co) is the forward's geometry;
// y is NULL exactly for the layer without an activation:
//   nsvb_mrd_dgrad(g, y, wt, dx, B, ci, co, H, Wi, Wo, kw, sw, stream)
//     g, y [B, co, H, Wo]; wt the weight permuted to [co, 3, kw, ci]
//     (16-byte aligned); dx [B, ci, H, Wi]
//   nsvb_mrd_wgrad(g, y, x, parts, B, ci, co, H, Wi, Wo, kw, sw, nslices, stream)
//     x [B, ci, H, Wi]; slice s: parts[s n + ((o ci + i) 3 + kh) kw + k] its
//     share of dW and parts[s n + co ci 3 kw + o] of db, n = co ci 3 kw + co

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr float SLOPE = 0.1f;  // the MRD's leaky-ReLU slope
constexpr int THREADS = 128;
constexpr int KH = 3;          // kernel rows of every MRD layer
constexpr int TP = 8;          // dgrad: positions of one residue class a thread
constexpr int WM = 32;         // wgrad: output columns a work item
constexpr int SMEM_CAP = 110 * 1024;  // dgrad tiles: at least two blocks an SM

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// a row stride of an odd number of 16-byte groups, so that the rows a
// quarter warp reads at once fall on distinct banks
__host__ __device__ constexpr int odd16(int n) {
  return (up4(n) / 4) % 2 ? up4(n) : up4(n) + 4;
}

__device__ __forceinline__ float act_grad(float g, float y) { return y >= 0.f ? g : g * SLOPE; }

// s += v with Kahan's compensation c (the true sum is s - c)
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c, t = s + y;
  c = (t - s) - y;
  s = t;
}

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

template <int KW, int SW, int RC, int OC>
struct Dgrad {
  static constexpr int P = (KW - 1) / 2;
  static constexpr int TC = 8 / SW < OC ? 8 / SW : OC;  // output channels a thread
  static constexpr int NCL = OC / TC;              // channel lanes
  static constexpr int PL = THREADS / NCL;         // position lanes
  static constexpr int PL_LOG2 = log2i(PL);
  static constexpr int CIC = RC < 4 ? RC : 4;      // reduction channels a stage
  static constexpr int NST = RC / CIC;             // stages
  static constexpr int HALO = 2 * P / SW;          // window columns past a thread's TP
  static constexpr int NX = up4(TP + HALO);        // window values a thread reads
  static constexpr int WSZ = CIC * KH * KW * OC;   // weight floats a stage
  static constexpr int NACC = SW * TC * TP;        // sums a thread
  // the running total of the stages' sums, a thread's own slots in shared
  // memory ([NACC / 4][THREADS] float4, so that a warp's copies are
  // consecutive): none where one stage covers the reduction
  static constexpr int TOT = NST > 1 ? NACC * THREADS : 0;
  static_assert(WSZ % 4 == 0 && RC % CIC == 0 && NACC % 4 == 0,
                "16-byte weight copies, whole stages, 16-byte sums");
  static_assert(1 << PL_LOG2 == PL && (NCL == 1 || NCL % 2 == 0),
                "position lanes a power of 2, channel lanes in pairs");
};

// the output tile's row stride: 16-byte rows of an odd number of 16-byte
// groups (ncols, the tile's columns, is a power of 2 from 8)
__host__ __device__ constexpr int dgrad_tile_stride(int ncols) { return ncols + 4; }

struct DgradArgs {
  const float* g;   // [B, RC, H, Wo]
  const float* y;   // [B, RC, H, Wo] (LRELU)
  const float* w;   // [RC, 3, KW, OC]
  float* dx;        // [B, OC, H, Wi]
  int H, Wi, Wo;
  int ntm, nth;     // tiles along m (8 TW columns of a class) and along h (TH rows)
  int tw_log2;      // log2 TW
  int xs;           // window row stride in shared memory
  int tot_off;      // floats before the running total in shared memory
};

template <int KW, int SW, int RC, int OC, bool LRELU>
__global__ void __launch_bounds__(THREADS, 3)
mrd_conv_dgrad_kernel(const DgradArgs a) {
  using G = Dgrad<KW, SW, RC, OC>;
  constexpr int TC = G::TC, NCL = G::NCL, CIC = G::CIC, NX = G::NX, P = G::P;
  extern __shared__ __align__(16) float smem[];
  const int tw = 1 << a.tw_log2, th = G::PL >> a.tw_log2, rows = th + 2, xs = a.xs;
  const int win = CIC * rows * xs;  // window floats a stage, of g and of y each
  const int stage_floats = G::WSZ + (LRELU ? 2 : 1) * win;

  int t = blockIdx.x;
  const int tm = t % a.ntm;
  t /= a.ntm;
  const int h0 = (t % a.nth) * th, b = t / a.nth;
  const int m0 = tm * tw * TP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a quarter warp holds 4 position lanes x 2 channel lanes: its window
  // reads hit 4 distinct 16-byte groups of banks, its weight reads 2; with
  // one output channel every thread is a position lane
  int cl = 0, pl = tid;
  if constexpr (NCL > 1) {
    constexpr int WCH = NCL / 2;  // warps across channel lanes
    cl = 2 * (warp % WCH) + ((lane >> 2) & 1);
    pl = (lane & 3) | ((lane >> 3) << 2) | ((warp / WCH) << 4);
  }
  const int lr = pl >> a.tw_log2, lm = pl & (tw - 1);

  // copy lanes: column cq of the window rows cr, cr + crs, ...; a thread
  // past crs full rows copies nothing
  const int ncol = tw * TP + G::HALO;
  const int crs = THREADS / ncol;
  const int cq = tid % ncol;
  const int cr = tid / ncol < crs ? tid / ncol : rows;
  const int col = m0 - P / SW + cq;  // g's column
  const bool col_ok = col >= 0 && col < a.Wo;
  const long long plane = (long long)a.H * a.Wo;
  const float* g_b = a.g + (long long)b * RC * plane;
  const float* y_b = LRELU ? a.y + (long long)b * RC * plane : a.g;

  auto stage = [&](int c0, int s) {
    float* ws = smem + s * stage_floats;
    float* gs = ws + G::WSZ;
    const float* wsrc = a.w + (long long)c0 * KH * KW * OC;
    for (int q = tid; q < G::WSZ / 4; q += THREADS) cp_async<4>(ws + 4 * q, wsrc + 4 * q, 4);
#pragma unroll
    for (int c = 0; c < CIC; ++c) {
      for (int r = cr; r < rows; r += crs) {
        const int hr = h0 - 1 + r;
        const bool ok = col_ok && hr >= 0 && hr < a.H;
        const long long off = (c0 + c) * plane + (long long)hr * a.Wo + col;
        float* d = gs + (c * rows + r) * xs + cq;
        cp_async<1>(d, ok ? g_b + off : a.g, ok);
        if constexpr (LRELU) cp_async<1>(d + win, ok ? y_b + off : a.g, ok);
      }
    }
  };

  // g = dy * act'(y) on the window values this thread copied itself
  auto transform = [&](int s) {
    float* gs = smem + s * stage_floats + G::WSZ;
#pragma unroll
    for (int c = 0; c < CIC; ++c) {
      for (int r = cr; r < rows; r += crs) {
        float* d = gs + (c * rows + r) * xs + cq;
        *d = act_grad(*d, d[win]);
      }
    }
  };

  // The sums in three levels, so that no chain of roundings runs over the
  // whole reduction (32 channels x 3 x 5 taps at stride 2; one chain read
  // 3x cuDNN's relative error against float64): acc holds one reduction
  // channel's products, mid the stage's channels, the total in shared
  // memory the stages before.
  float acc[SW][TC][TP], mid[SW][TC][TP];
  float4* tot = reinterpret_cast<float4*>(smem + a.tot_off) + tid;
  constexpr int NST = G::NST, NQ = G::NACC / 4;
  stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < NST; ++st) {
    const int s = st & 1;
    if (st + 1 < NST) {
      stage((st + 1) * CIC, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (LRELU) transform(s);
    __syncthreads();
    const float* ws = smem + s * stage_floats;
    const float* gs = ws + G::WSZ;
#pragma unroll
    for (int r = 0; r < SW; ++r)
#pragma unroll
      for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) mid[r][i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < CIC; ++c) {
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
        // output row h0 + lr reads g's row h0 + lr + 1 - kh: window row lr + 2 - kh
        float xv[NX];
        const float* xr = gs + (c * rows + lr + 2 - kh) * xs + TP * lm;
#pragma unroll
        for (int q = 0; q < NX / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xr + 4 * q);
          xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
        }
        const float* wr = ws + (c * KH + kh) * KW * OC + TC * cl;
#pragma unroll
        for (int kw = 0; kw < KW; ++kw) {
          float wv[TC];
          if constexpr (TC % 4 == 0) {
#pragma unroll
            for (int q = 0; q < TC / 4; ++q) {
              const float4 v = *reinterpret_cast<const float4*>(wr + kw * OC + 4 * q);
              wv[4 * q] = v.x; wv[4 * q + 1] = v.y; wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < TC; ++i) wv[i] = wr[kw * OC + i];
          }
          // the residue class this tap feeds, and its window offset:
          // g's column m + (r + P - kw) / SW is window value j + sft; a
          // class's first tap of the channel starts its sums
          const int r = (kw + SW * KW - P) % SW;
          const int sft = (r + P - kw) / SW + P / SW;
          const bool first = kh == 0 && kw < SW;
#pragma unroll
          for (int i = 0; i < TC; ++i)
#pragma unroll
            for (int j = 0; j < TP; ++j)
              acc[r][i][j] = first ? wv[i] * xv[j + sft] : fmaf(wv[i], xv[j + sft], acc[r][i][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < SW; ++r)
#pragma unroll
        for (int i = 0; i < TC; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) mid[r][i][j] += acc[r][i][j];
    }
    __syncthreads();  // this stage's readers are done before it is refilled
    if (st + 1 < NST) {  // the stage's sums into the total (the last stays in mid)
      const float* m = &mid[0][0][0];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 v = make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
        if (st > 0) {
          const float4 t = tot[q * THREADS];
          v = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
        }
        tot[q * THREADS] = v;
      }
    }
  }
  if constexpr (NST > 1) {
    float* m = &mid[0][0][0];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 t = tot[q * THREADS];
      m[4 * q] += t.x; m[4 * q + 1] += t.y; m[4 * q + 2] += t.z; m[4 * q + 3] += t.w;
    }
  }

  // the epilogue: the block's tile through shared memory (free: every
  // stage's readers are past the loop's last barrier), so that a warp's
  // stores cover consecutive columns of a row
  const int ncols = tw * TP * SW, rso = dgrad_tile_stride(ncols);
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    float* trow = smem + ((TC * cl + i) * th + lr) * rso + TP * SW * lm;
#pragma unroll
    for (int q = 0; q < TP * SW / 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = mid[(4 * q + e) % SW][i][(4 * q + e) / SW];
      *reinterpret_cast<float4*>(trow + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  const int lc = tid & (ncols - 1), w = SW * m0 + lc;
  const int th_log2 = G::PL_LOG2 - a.tw_log2;
  for (int line = tid / ncols; line < OC * th; line += THREADS / ncols) {
    const int h = h0 + (line & (th - 1));
    if (h < a.H && w < a.Wi)
      a.dx[(((long long)b * OC + (line >> th_log2)) * a.H + h) * a.Wi + w] = smem[line * rso + lc];
  }
}

template <int KW, int SW, int RC, int OC, bool LRELU>
int launch_dgrad(DgradArgs a, int B, cudaStream_t stream) {
  using G = Dgrad<KW, SW, RC, OC>;
  // the block shape with the least padded work (ties: the wider) whose two
  // stages fit SMEM_CAP
  const int M = (a.Wi + SW - 1) / SW;
  long long best = -1;
  int bytes = 0;
  for (int l = 0; l <= 3 && (G::PL >> l) >= 1; ++l) {
    const int tw = 1 << l, th = G::PL >> l;
    const int xs = odd16(tw * TP + G::HALO);
    const int stage = G::WSZ + (LRELU ? 2 : 1) * G::CIC * (th + 2) * xs;
    const int tile = OC * th * dgrad_tile_stride(tw * TP * SW);
    const int floats = (2 * stage > tile ? 2 * stage : tile) + G::TOT;
    if (floats * (int)sizeof(float) > SMEM_CAP) continue;
    const int ntm = (M + tw * TP - 1) / (tw * TP), nth = (a.H + th - 1) / th;
    const long long work = (long long)ntm * tw * nth * th;
    if (best < 0 || work <= best) {
      best = work;
      a.tw_log2 = l; a.xs = xs; a.ntm = ntm; a.nth = nth; a.tot_off = floats - G::TOT;
      bytes = floats * (int)sizeof(float);
    }
  }
  if (best < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * a.nth * a.ntm;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mrd_conv_dgrad_kernel<KW, SW, RC, OC, LRELU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  mrd_conv_dgrad_kernel<KW, SW, RC, OC, LRELU><<<(unsigned)blocks, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad and its reduction
// ---------------------------------------------------------------------------

template <int KW, int SW, int CI, int CO>
struct Wgrad {
  static constexpr int P = (KW - 1) / 2;
  static constexpr int TO = CI == 1 || CO == 1 ? 1 : 8;    // output channels a thread
  static constexpr int KHT = TO * KH * KW <= 72 ? KH : 1;  // kernel rows a block
  static constexpr int OL = CO / TO, IL = CI;              // channel lanes
  static constexpr int PG = THREADS / (OL * IL);           // position groups
  static constexpr int NXW = up4(8 + (KW - 1) / SW);       // window a thread reads a class
  static constexpr int PW = WM - 8 + NXW;                  // columns of a class
  static constexpr int RS = odd16(SW * PW);                // x row stride
  // g staged [position][GLD]: 16-byte rows for 8 channels a thread, else an
  // odd stride (the copies' stores on distinct banks)
  static constexpr int GLD = TO == 8 ? CO + 4 : (CO == 1 ? 1 : CO + 1);
  static constexpr int XF = CI * KHT * RS;                 // x floats a stage
  static constexpr int GF = up4(WM * GLD);                 // g floats a stage
  static constexpr int NACC = KHT * KW * TO;
  // the one-channel layers sum each work item's products apart and add the
  // items' sums with Kahan's compensation (the registers allow it there)
  static constexpr bool ITEM = TO == 1;
  static_assert(OL * IL * PG == THREADS && WM % (8 * PG) == 0, "threads and positions");
};

template <int KW, int SW, int CI, int CO>
constexpr int wgrad_smem_floats(bool lrelu) {
  using G = Wgrad<KW, SW, CI, CO>;
  return 2 * (G::XF + (lrelu ? 2 : 1) * G::GF);
}

struct WgradArgs {
  const float* g;   // [B, CO, H, Wo]
  const float* y;   // [B, CO, H, Wo] (LRELU)
  const float* x;   // [B, CI, H, Wi]
  float* parts;     // [nslices, n]
  long long n;      // CO CI 3 KW + CO
  int H, Wi, Wo, ntw, nitems, nslices;
};

template <int KW, int SW, int CI, int CO, bool LRELU>
__global__ void __launch_bounds__(THREADS, 3)
mrd_conv_wgrad_kernel(const WgradArgs p) {
  using G = Wgrad<KW, SW, CI, CO>;
  constexpr int TO = G::TO, KHT = G::KHT, PG = G::PG, NXW = G::NXW, PW = G::PW;
  constexpr int RS = G::RS, GLD = G::GLD, P = G::P;
  constexpr int STAGE = G::XF + (LRELU ? 2 : 1) * G::GF;
  extern __shared__ __align__(16) float smem[];

  const int s = blockIdx.x, kh0 = blockIdx.y * KHT;
  const int tid = threadIdx.x;
  const int il = tid % G::IL, ol = (tid / G::IL) % G::OL, pg = tid / (G::IL * G::OL);
  const bool do_bias = blockIdx.y == 0;
  const int H = p.H, Wi = p.Wi, Wo = p.Wo;
  const int nmine = s < p.nitems ? (p.nitems - s + p.nslices - 1) / p.nslices : 0;
  // g copy lanes: position gp of channels go, go + THREADS / WM, ...
  const int gp = tid % WM, go = tid / WM;

  auto stage = [&](int k, int st) {
    const int item = s + k * p.nslices;
    const int v0 = (item % p.ntw) * WM;
    const int hb = item / p.ntw, h = hb % H, b = hb / H;
    float* xsm = smem + st * STAGE;
    float* gsm = xsm + G::XF;
    {
      const bool ok = v0 + gp < Wo;
      const long long base = ((long long)b * CO * H + h) * Wo + v0 + gp;
      for (int o = go; o < CO; o += THREADS / WM) {
        const long long off = base + (long long)o * H * Wo;
        cp_async<1>(gsm + gp * GLD + o, ok ? p.g + off : p.g, ok);
        if constexpr (LRELU) cp_async<1>(gsm + G::GF + gp * GLD + o, ok ? p.y + off : p.g, ok);
      }
    }
    // x rows (i, kh), their columns SW v0 - P + q split by residue class of the stride
    constexpr int QN = SW * PW;
    for (int e = tid; e < CI * KHT * QN; e += THREADS) {
      const int row = e / QN, q = e - row * QN;
      const int i = row / KHT, hr = h + kh0 + (row - i * KHT) - 1;
      const int w = SW * v0 - P + q;
      const bool ok = hr >= 0 && hr < H && w >= 0 && w < Wi;
      cp_async<1>(xsm + row * RS + (q % SW) * PW + q / SW,
                  ok ? p.x + (((long long)b * CI + i) * H + hr) * Wi + w : p.x, ok);
    }
  };

  // g = dy * act'(y) on the values this thread copied itself
  auto transform = [&](int st) {
    float* gsm = smem + st * STAGE + G::XF;
    for (int o = go; o < CO; o += THREADS / WM) {
      float* d = gsm + gp * GLD + o;
      *d = act_grad(*d, d[G::GF]);
    }
  };

  // The slice's sums: acc (dW) and bsum (db), each with its compensation
  // (acmp for ITEM, bcmp); ia and bi the work item's. A bias sum runs over
  // 0.3-2.2 thousand positions of a slice: one chain of roundings read 4-6x
  // cuDNN's relative error against float64.
  constexpr int IK = G::ITEM ? KHT : 1, IW = G::ITEM ? KW : 1;
  float acc[KHT][KW][TO], acmp[IK][IW][TO], ia[IK][IW][TO];
  float bsum[TO], bcmp[TO], bi[TO];
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    bsum[o] = bcmp[o] = 0.f;
#pragma unroll
    for (int r = 0; r < KHT; ++r)
#pragma unroll
      for (int k = 0; k < KW; ++k) acc[r][k][o] = 0.f;
#pragma unroll
    for (int r = 0; r < IK; ++r)
#pragma unroll
      for (int k = 0; k < IW; ++k) acmp[r][k][o] = 0.f;
  }

  if (nmine > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int k = 0; k < nmine; ++k) {
    const int st = k & 1;
    if (k + 1 < nmine) {
      stage(k + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (LRELU) transform(st);
    __syncthreads();
    const float* xsm = smem + st * STAGE;
    const float* gsm = xsm + G::XF;
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      bi[o] = 0.f;
#pragma unroll
      for (int r = 0; r < IK; ++r)
#pragma unroll
        for (int k = 0; k < IW; ++k) ia[r][k][o] = 0.f;
    }
#pragma unroll 1
    for (int mb = 8 * pg; mb < WM; mb += 8 * PG) {
      // position v0 + mb + mm, tap kw reads class kw % SW at mm + kw / SW
      float xw[KHT][SW][NXW];
#pragma unroll
      for (int r = 0; r < KHT; ++r)
#pragma unroll
        for (int c = 0; c < SW; ++c) {
          const float* xr = xsm + (il * KHT + r) * RS + c * PW + mb;
#pragma unroll
          for (int q = 0; q < NXW / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(xr + 4 * q);
            xw[r][c][4 * q] = v.x; xw[r][c][4 * q + 1] = v.y;
            xw[r][c][4 * q + 2] = v.z; xw[r][c][4 * q + 3] = v.w;
          }
        }
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        float gv[TO];
        const float* gr = gsm + (mb + mm) * GLD;
        if constexpr (TO == 8) {
          const float4 g0 = *reinterpret_cast<const float4*>(gr + 8 * ol);
          const float4 g1 = *reinterpret_cast<const float4*>(gr + 8 * ol + 4);
          gv[0] = g0.x; gv[1] = g0.y; gv[2] = g0.z; gv[3] = g0.w;
          gv[4] = g1.x; gv[5] = g1.y; gv[6] = g1.z; gv[7] = g1.w;
        } else {
          gv[0] = gr[ol];
        }
#pragma unroll
        for (int r = 0; r < KHT; ++r)
#pragma unroll
          for (int kw = 0; kw < KW; ++kw)
#pragma unroll
            for (int o = 0; o < TO; ++o) {
              const float xv = xw[r][kw % SW][mm + kw / SW];
              if constexpr (G::ITEM) ia[r][kw][o] = fmaf(gv[o], xv, ia[r][kw][o]);
              else acc[r][kw][o] = fmaf(gv[o], xv, acc[r][kw][o]);
            }
        if (do_bias) {
#pragma unroll
          for (int o = 0; o < TO; ++o) bi[o] += gv[o];
        }
      }
    }
    // the item's sums into the slice's
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      if (do_bias) kahan_add(bsum[o], bcmp[o], bi[o]);
      if constexpr (G::ITEM) {
#pragma unroll
        for (int r = 0; r < KHT; ++r)
#pragma unroll
          for (int k = 0; k < KW; ++k) kahan_add(acc[r][k][o], acmp[r][k][o], ia[r][k][o]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    bsum[o] -= bcmp[o];
    if constexpr (G::ITEM) {
#pragma unroll
      for (int r = 0; r < KHT; ++r)
#pragma unroll
        for (int k = 0; k < KW; ++k) acc[r][k][o] -= acmp[r][k][o];
    }
  }

  // the position groups' sums, added in group order into group 0's
  if constexpr (PG > 1) {
    constexpr int RLD = (G::NACC + TO) | 1;  // odd stride: threads on distinct banks
    float* mine = smem + (tid % (G::OL * G::IL)) * RLD;
#pragma unroll 1
    for (int q = 1; q < PG; ++q) {
      if (pg == q) {
#pragma unroll
        for (int r = 0; r < KHT; ++r)
#pragma unroll
          for (int kw = 0; kw < KW; ++kw)
#pragma unroll
            for (int o = 0; o < TO; ++o) mine[(r * KW + kw) * TO + o] = acc[r][kw][o];
#pragma unroll
        for (int o = 0; o < TO; ++o) mine[G::NACC + o] = bsum[o];
      }
      __syncthreads();
      if (pg == 0) {
#pragma unroll
        for (int r = 0; r < KHT; ++r)
#pragma unroll
          for (int kw = 0; kw < KW; ++kw)
#pragma unroll
            for (int o = 0; o < TO; ++o) acc[r][kw][o] += mine[(r * KW + kw) * TO + o];
#pragma unroll
        for (int o = 0; o < TO; ++o) bsum[o] += mine[G::NACC + o];
      }
      __syncthreads();
    }
    if (pg != 0) return;
  }

  float* part = p.parts + (long long)s * p.n;
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    const int co = ol * TO + o;
#pragma unroll
    for (int r = 0; r < KHT; ++r)
#pragma unroll
      for (int kw = 0; kw < KW; ++kw)
        part[((co * CI + il) * KH + kh0 + r) * KW + kw] = acc[r][kw][o];
    if (do_bias && il == 0) part[CO * CI * KH * KW + co] = bsum[o];
  }
}

template <int KW, int SW, int CI, int CO, bool LRELU>
int launch_wgrad(WgradArgs p, int B, cudaStream_t stream) {
  using G = Wgrad<KW, SW, CI, CO>;
  p.ntw = (p.Wo + WM - 1) / WM;
  const long long items = (long long)B * p.H * p.ntw;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.nitems = (int)items;
  p.n = (long long)CO * CI * KH * KW + CO;
  const int bytes = wgrad_smem_floats<KW, SW, CI, CO>(LRELU) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(mrd_conv_wgrad_kernel<KW, SW, CI, CO, LRELU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.nslices, KH / G::KHT);
  mrd_conv_wgrad_kernel<KW, SW, CI, CO, LRELU><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// f(kw, sw, ci, co, lrelu as integral constants) for the MRD's geometries,
// else cudaErrorInvalidValue
template <class F>
int with_geometry(int kw, int sw, int ci, int co, bool lrelu, F f) {
  if (kw == 9 && sw == 1 && ci == 1 && co == 32 && lrelu) return f.template run<9, 1, 1, 32, true>();
  if (kw == 9 && sw == 2 && ci == 32 && co == 32 && lrelu) return f.template run<9, 2, 32, 32, true>();
  if (kw == 3 && sw == 1 && ci == 32 && co == 32 && lrelu) return f.template run<3, 1, 32, 32, true>();
  if (kw == 3 && sw == 1 && ci == 32 && co == 1 && !lrelu) return f.template run<3, 1, 32, 1, false>();
  return (int)cudaErrorInvalidValue;
}

struct DgradLaunch {
  const DgradArgs& a;
  int B;
  cudaStream_t st;
  template <int KW, int SW, int CI, int CO, bool LRELU>
  int run() const { return launch_dgrad<KW, SW, CO, CI, LRELU>(a, B, st); }
};

struct WgradLaunch {
  const WgradArgs& p;
  int B;
  cudaStream_t st;
  template <int KW, int SW, int CI, int CO, bool LRELU>
  int run() const { return launch_wgrad<KW, SW, CI, CO, LRELU>(p, B, st); }
};

// the forward's output width for padding (KW - 1) / 2 and stride sw
bool widths_ok(int Wi, int Wo, int kw, int sw) {
  return Wi > 0 && Wo > 0 && Wo == (Wi + 2 * ((kw - 1) / 2) - kw) / sw + 1;
}

}  // namespace

extern "C" int nsvb_mrd_dgrad(const void* g, const void* y, const void* wt, void* dx, int B,
                              int ci, int co, int H, int Wi, int Wo, int kw, int sw,
                              void* stream) {
  if (B <= 0 || H <= 0 || !widths_ok(Wi, Wo, kw, sw) || (size_t)wt % 16)
    return (int)cudaErrorInvalidValue;
  DgradArgs a;
  a.g = (const float*)g; a.y = (const float*)y; a.w = (const float*)wt; a.dx = (float*)dx;
  a.H = H; a.Wi = Wi; a.Wo = Wo;
  a.ntm = a.nth = a.tw_log2 = a.xs = a.tot_off = 0;
  return with_geometry(kw, sw, ci, co, y != nullptr, DgradLaunch{a, B, (cudaStream_t)stream});
}

extern "C" int nsvb_mrd_wgrad(const void* g, const void* y, const void* x, void* parts, int B,
                              int ci, int co, int H, int Wi, int Wo, int kw, int sw,
                              int nslices, void* stream) {
  if (B <= 0 || H <= 0 || !widths_ok(Wi, Wo, kw, sw) || nslices <= 0)
    return (int)cudaErrorInvalidValue;
  WgradArgs p;
  p.g = (const float*)g; p.y = (const float*)y; p.x = (const float*)x; p.parts = (float*)parts;
  p.H = H; p.Wi = Wi; p.Wo = Wo; p.nslices = nslices;
  p.n = 0; p.ntw = p.nitems = 0;
  return with_geometry(kw, sw, ci, co, y != nullptr, WgradLaunch{p, B, (cudaStream_t)stream});
}
