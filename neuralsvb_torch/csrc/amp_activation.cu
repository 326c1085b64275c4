// BigVGAN's anti-aliased SnakeBeta activation (`Activation1d`) for Hopper
// (sm_90a), f32, forward and backward.
//
// Per channel c of x [B, C, T], with the 12-tap Kaiser-sinc low-pass f
// (cutoff 0.25, half width 0.3) and the logscale parameters a[c], b[c]:
//
//   u[m] = 2 sum_k f[k] xp[j],  2 j + k = m + 15   (upsample 2x: x padded by
//          5 on each side by replication, transposed conv, 15 cropped off
//          each end; m in [0, 2T))
//   s[m] = u[m] + sin(u[m] e^a)^2 / (e^b + 1e-9)            (SnakeBeta)
//   y[i] = sum_k f[k] s[clamp(2 i - 5 + k, 0, 2T - 1)]      (downsample 2x:
//          s padded (5, 6) by replication, strided conv; i in [0, T))
//
// Written out, u[2i] = 2 sum_q f[2q+1] x[clamp(i+2-q)] and u[2i+1] =
// 2 sum_q f[2q] x[clamp(i+3-q)], q = 0..5: six taps per upsampled sample.
//
// Forward (`amp_activation_fwd_kernel`): one block per (row, tile of TILE
// outputs). It stages x[i0-8 .. i0+TILE+8) (indices clamped: the
// replication pad) in shared memory; each thread computes the upsampled
// samples of one (even, odd) pair of positions from seven staged values
// (no divergence between the two parities), applies SnakeBeta and keeps
// the pair in two shared arrays, so that the 12-tap downsampling reads
// them without bank conflicts; y is written once. The TILE + 6 pairs a
// tile reads are two per thread. x is read once (plus a 16-sample halo per
// tile), y written once, s never leaves the SM. sinf is the accurate one
// (no --use_fast_math, no __sinf).
//
// Backward (`amp_activation_bwd_kernel`, then `amp_activation_reduce_kernel`):
// recomputes u from x. With ds the gradient at s (the strided conv's
// transpose; at m = 0 and m = 2T-1 the taps that fell on the padding are
// folded in), and v = u e^a,
//
//   du  = ds (1 + e^a sin(2v) / (e^b + 1e-9))
//   da += ds e^a u sin(2v) / (e^b + 1e-9)
//   db -= ds sin(v)^2 e^b / (e^b + 1e-9)^2
//
// and dx is the upsampling's transpose of du (its padding folded into
// dx[0] and dx[T-1]). A tile of TILE dx values stages x and dy with an
// 8-sample halo, computes du at its TILE + 6 pairs into shared memory and
// da/db over the pairs it owns ([j0, j0 + TILE)); each block reduces its
// two partials in a fixed tree and writes them; the reduce kernel sums a
// channel's partials over rows and tiles in a fixed order. Two calls with
// the same inputs give the same bits.
//
// C interface (loaded with ctypes, no PyTorch headers):
//   int nsvb_amp_tile()                       outputs per block (TILE)
//   int nsvb_amp_forward(x, a, b, y, B, C, T, taps, stream)
//   int nsvb_amp_backward(x, a, b, dy, dx, partial, da, db, B, C, T, taps,
//                         stream)
//   x, y, dy, dx [B, C, T]; a, b, da, db [C]; partial [2, B C ceil(T/TILE)];
//   taps: 12 host floats. All f32, contiguous, on the stream's device.
// Each returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

// outputs per block: the 2 TILE + 12 upsampled positions a tile reads are
// TILE + 6 = 2 THREADS (even, odd) pairs, two per thread
constexpr int THREADS = 256;
constexpr int PAIRS = 2 * THREADS;
constexpr int TILE = PAIRS - 6;
constexpr int HALO = 8;
constexpr int XS = TILE + 2 * HALO;   // staged x (and dy)

struct Taps {
  float f[12];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (u[2p], u[2p+1]) for 0 <= p < T from the staged x, whose slot k holds
// x[clamp(base + k)]: u[2p] = 2 sum_q f[2q+1] x[p+2-q], u[2p+1] =
// 2 sum_q f[2q] x[p+3-q]; seven staged values serve both
__device__ __forceinline__ float2 upsampled_pair(const float* xs, int base, int p,
                                                 const Taps& t) {
  const float* w = xs + (p - 3 - base);  // w[r] = x[p - 3 + r], r = 0..6
  float e = 0.f, o = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    e = fmaf(t.f[2 * q + 1], w[5 - q], e);
    o = fmaf(t.f[2 * q], w[6 - q], o);
  }
  return make_float2(2.f * e, 2.f * o);
}

__global__ void __launch_bounds__(THREADS)
amp_activation_fwd_kernel(const float* __restrict__ x, const float* __restrict__ alog,
                          const float* __restrict__ blog, float* __restrict__ y, int C,
                          int T, Taps taps) {
  __shared__ float xs[XS];
  __shared__ float se[PAIRS], so[PAIRS];  // s at 2p and 2p + 1, p = i0 - 3 + k
  const long long row = blockIdx.x;
  const int c = (int)(row % C);
  const int i0 = blockIdx.y * TILE;
  const float* xr = x + row * T;
  const int base = i0 - HALO;
  for (int k = threadIdx.x; k < XS; k += THREADS) xs[k] = __ldg(xr + clampi(base + k, 0, T - 1));
  const float alpha = expf(__ldg(alog + c));
  const float inv = 1.f / (expf(__ldg(blog + c)) + 1e-9f);
  __syncthreads();
  const int pbase = i0 - 3;
  // the passes unrolled: their sinf chains are independent
#pragma unroll
  for (int r = 0; r < PAIRS / THREADS; ++r) {
    // positions before 0 and past 2T - 1 read s[0] and s[2T - 1] (the
    // replication pad of s)
    const int k = threadIdx.x + r * THREADS;
    const int p = pbase + k, pc = clampi(p, 0, T - 1);
    const float2 u = upsampled_pair(xs, base, pc, taps);
    const float sne = sinf(u.x * alpha), sno = sinf(u.y * alpha);
    const float ve = u.x + inv * (sne * sne), vo = u.y + inv * (sno * sno);
    se[k] = p > T - 1 ? vo : ve;
    so[k] = p < 0 ? ve : vo;
  }
  __syncthreads();
  // y[i] = sum_j f[2j+1] s[2(i-2+j)] + f[2j] s[2(i-3+j)+1], j = 0..5
  float* yr = y + row * T;
#pragma unroll
  for (int r = 0; r < PAIRS / THREADS; ++r) {
    const int t = threadIdx.x + r * THREADS;
    if (t >= TILE || i0 + t >= T) break;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc = fmaf(taps.f[2 * j + 1], se[t + 1 + j], acc);
      acc = fmaf(taps.f[2 * j], so[t + j], acc);
    }
    yr[i0 + t] = acc;
  }
}

// the gradient at s[m'] before the padding is folded: the taps of the
// strided conv that read position m' (possibly in the padding)
__device__ __forceinline__ float ds_raw(const float* dyr, int T, int m, const Taps& t) {
  const int p = m >= 0 ? m >> 1 : -((1 - m) >> 1);  // floor(m / 2)
  float acc = 0.f;
  if (m & 1) {  // m = 2p + 1: k = 2 (p - i) + 6, i in [p - 2, p + 3]
#pragma unroll
    for (int d = -3; d <= 2; ++d) {
      const int i = p - d;
      if (i >= 0 && i < T) acc = fmaf(t.f[2 * d + 6], __ldg(dyr + i), acc);
    }
  } else {      // m = 2p: k = 2 (p - i) + 5, i in [p - 3, p + 2]
#pragma unroll
    for (int d = -2; d <= 3; ++d) {
      const int i = p - d;
      if (i >= 0 && i < T) acc = fmaf(t.f[2 * d + 5], __ldg(dyr + i), acc);
    }
  }
  return acc;
}

// ds at the even and odd position of pair p, padding folded at m = 0 and
// m = 2T - 1; gs slot k holds dy[base + k] (0 outside [0, T))
__device__ __forceinline__ float2 ds_pair(const float* gs, int base, const float* dyr, int T,
                                          int p, const Taps& t) {
  const float* w = gs + (p - 3 - base);  // w[r] = dy[p - 3 + r]
  float e = 0.f, o = 0.f;
#pragma unroll
  for (int d = -3; d <= 3; ++d) {
    if (d >= -2) e = fmaf(t.f[2 * d + 5], w[3 - d], e);
    if (d <= 2) o = fmaf(t.f[2 * d + 6], w[3 - d], o);
  }
  if (p == 0) {  // the (5, 6) pad's left taps fold onto s[0]
    e = 0.f;
    for (int mm = -5; mm <= 0; ++mm) e += ds_raw(dyr, T, mm, t);
  }
  if (p == T - 1) {  // and the right ones onto s[2T - 1]
    o = 0.f;
    for (int mm = 2 * T - 1; mm <= 2 * T + 5; ++mm) o += ds_raw(dyr, T, mm, t);
  }
  return make_float2(e, o);
}

__global__ void __launch_bounds__(THREADS)
amp_activation_bwd_kernel(const float* __restrict__ x, const float* __restrict__ alog,
                          const float* __restrict__ blog, const float* __restrict__ dy,
                          float* __restrict__ dx, float* __restrict__ partial, int C, int T,
                          Taps taps) {
  __shared__ float xs[XS];
  __shared__ float gs[XS];
  __shared__ float de[PAIRS], dod[PAIRS];  // du at 2p and 2p + 1, p = j0 - 3 + k
  __shared__ float red[2][THREADS];
  const long long row = blockIdx.x;
  const int c = (int)(row % C);
  const int j0 = blockIdx.y * TILE;
  const float* xr = x + row * T;
  const float* dyr = dy + row * T;
  const int base = j0 - HALO;
  for (int k = threadIdx.x; k < XS; k += THREADS) {
    const int i = base + k;
    xs[k] = __ldg(xr + clampi(i, 0, T - 1));
    gs[k] = (i >= 0 && i < T) ? __ldg(dyr + i) : 0.f;
  }
  const float alpha = expf(__ldg(alog + c));
  const float eb = expf(__ldg(blog + c));
  const float inv = 1.f / (eb + 1e-9f);
  __syncthreads();
  const int pbase = j0 - 3;
  float pa = 0.f, pb = 0.f;
#pragma unroll
  for (int r = 0; r < PAIRS / THREADS; ++r) {
    const int k = threadIdx.x + r * THREADS;
    const int p = pbase + k;
    float due = 0.f, duo = 0.f;  // du is 0 outside [0, 2T)
    if (p >= 0 && p < T) {
      const float2 ds = ds_pair(gs, base, dyr, T, p, taps);
      const float2 u = upsampled_pair(xs, base, p, taps);
      float sne, cse, sno, cso;
      sincosf(u.x * alpha, &sne, &cse);
      sincosf(u.y * alpha, &sno, &cso);
      const float s2e = 2.f * sne * cse, s2o = 2.f * sno * cso;
      due = ds.x * (1.f + alpha * s2e * inv);
      duo = ds.y * (1.f + alpha * s2o * inv);
      if (p >= j0 && p < j0 + TILE) {  // the pairs this tile owns
        pa = fmaf(ds.x, alpha * u.x * s2e * inv, pa);
        pa = fmaf(ds.y, alpha * u.y * s2o * inv, pa);
        pb = fmaf(ds.x, -(sne * sne) * eb * inv * inv, pb);
        pb = fmaf(ds.y, -(sno * sno) * eb * inv * inv, pb);
      }
    }
    de[k] = due;
    dod[k] = duo;
  }
  red[0][threadIdx.x] = pa;
  red[1][threadIdx.x] = pb;
  __syncthreads();
  // dx[j] = 2 sum_q f[2q+1] du[2(j-2+q)] + f[2q] du[2(j-3+q)+1]; the
  // upsampling's padding folds onto j = 0 (v = -5 .. -1) and j = T - 1
  // (v = T .. T + 4), whose du lie in this tile's pairs or are 0
  auto g_at = [&](int v) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int ke = v - 2 + q - pbase, ko = v - 3 + q - pbase;
      if (ke >= 0 && ke < PAIRS) acc = fmaf(taps.f[2 * q + 1], de[ke], acc);
      if (ko >= 0 && ko < PAIRS) acc = fmaf(taps.f[2 * q], dod[ko], acc);
    }
    return 2.f * acc;
  };
  float* dxr = dx + row * T;
#pragma unroll
  for (int r = 0; r < PAIRS / THREADS; ++r) {
    const int t = threadIdx.x + r * THREADS;
    if (t >= TILE || j0 + t >= T) break;
    const int j = j0 + t;
    float g = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      g = fmaf(taps.f[2 * q + 1], de[t + 1 + q], g);
      g = fmaf(taps.f[2 * q], dod[t + q], g);
    }
    g *= 2.f;
    if (j == 0)
      for (int v = -5; v < 0; ++v) g += g_at(v);
    if (j == T - 1)
      for (int v = T; v < T + 5; ++v) g += g_at(v);
    dxr[j] = g;
  }
  // the block's partials of da and db, in a fixed tree
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long idx = row * gridDim.y + blockIdx.y;
    const long long n = (long long)gridDim.x * gridDim.y;
    partial[idx] = red[0][0];
    partial[n + idx] = red[1][0];
  }
}

// da[c], db[c]: the partials of channel c over rows b C + c and tiles,
// one warp per channel and parameter, lanes strided in order, then a fixed
// shuffle tree
__global__ void amp_activation_reduce_kernel(const float* __restrict__ partial,
                                             float* __restrict__ da, float* __restrict__ db,
                                             int B, int C, int tiles) {
  const int c = blockIdx.x, which = blockIdx.y, lane = threadIdx.x;
  const long long n = (long long)B * C * tiles;
  const float* p = partial + which * n;
  float acc = 0.f;
  for (int k = lane; k < B * tiles; k += 32) {
    const int b = k / tiles, t = k % tiles;
    acc += p[((long long)b * C + c) * tiles + t];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) (which ? db : da)[c] = acc;
}

Taps load_taps(const float* taps) {
  Taps t;
  for (int k = 0; k < 12; ++k) t.f[k] = taps[k];
  return t;
}

bool bad_shape(int B, int C, int T) {
  const long long tiles = (T + TILE - 1) / TILE;
  return B <= 0 || C <= 0 || T <= 0 || tiles > 65535 || (long long)B * C > 0x7fffffffLL;
}

}  // namespace

extern "C" int nsvb_amp_tile() { return TILE; }

extern "C" int nsvb_amp_forward(const void* x, const void* a, const void* b, void* y, int B,
                                int C, int T, const float* taps, void* stream) {
  if (bad_shape(B, C, T)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * C), (unsigned)((T + TILE - 1) / TILE));
  amp_activation_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)b, (float*)y, C, T, load_taps(taps));
  return (int)cudaGetLastError();
}

extern "C" int nsvb_amp_backward(const void* x, const void* a, const void* b, const void* dy,
                                 void* dx, void* partial, void* da, void* db, int B, int C,
                                 int T, const float* taps, void* stream) {
  if (bad_shape(B, C, T)) return (int)cudaErrorInvalidValue;
  const int tiles = (T + TILE - 1) / TILE;
  const dim3 grid((unsigned)(B * C), (unsigned)tiles);
  cudaStream_t s = (cudaStream_t)stream;
  amp_activation_bwd_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)dy, (float*)dx,
      (float*)partial, C, T, load_taps(taps));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  amp_activation_reduce_kernel<<<dim3((unsigned)C, 2), 32, 0, s>>>(
      (const float*)partial, (float*)da, (float*)db, B, C, tiles);
  return (int)cudaGetLastError();
}
