// Polyphase filter-bank channelizer KP for Hopper (sm_90a).
//
// KP replaces no TPU kernel: it replaces the XLA im2col GEMM of
// dumpvdl2_tpu/dsp/frontend.py::bandpass_channelize, which the port ran
// as an im2col copy and a (2C, 2T) x (2T, M) float32 cuBLAS product
// (610 GFLOP and a 2.38 GB im2col buffer a wideband block).  The
// formulation, the plan (K, phi, bins, Taylor terms) and the plain
// version are in dumpvdl2_tpu_torch/dsp/pfb_kernel.py (pfb_plain); on a
// CUDA tensor the wrapper there launches this.  Its output equals the
// plain version's bit for bit: every product and sum below is the plain
// version's, in its order, each rounded (the file builds with
// --fmad=false), with the same float32 tables.
//
// Output j of the block (G_j = os (j + 1) - 1 raw samples after its
// start) and channel c:
//   fold       v_n[r] = sum_{q = 0..Q-1} p_n[r + qK] x[G_j - r - qK],
//              in that order, x complex (two planes), p_n real;
//   phi        v_n[r] *= pre[r] (e^{-j 2 pi phi r / K}), where phi != 0;
//   transform  X_n[k] = sum_r W^{kr} v_n[r], W = e^{-j 2 pi / K},
//              K = 21 P: r = 21 a + b, k = k1 + P k2; a P-point DFT over
//              a for each b, the twiddle W^{b k1} (a table product), a
//              21-point DFT over b for each k1; the small DFTs are direct
//              (2, 3, 4, 7) or composite (8 = 2 x 4, 16 = 4 x 4,
//              21 = 3 x 7), each output the left-to-right sum of its
//              terms, a term's twiddle exact at the quarter turns and a
//              table product otherwise;
//   combine    w = sum_n A[c, n] X_n[bin_c], n in order;
//   rotate     w e^{+j ang}, ang = ((G_j + n0) mod 2^24 * dphi_c mod
//              2^24) * (2 pi / 2^24) in float32, cosf and sinf: the
//              GEMM formulation's residual rotation.  n0 is a value or a
//              0-dim device input (a CUDA graph's).
// x[i] is the raw carry (T - 1 columns) then the block; before the
// carry and after the block it reads 0.
//
// Bound: operations.  A wideband block (256 channels, oversample 80,
// K = 336, two Taylor terms, Q = 17) reads 33.6 MB and writes 107 MB
// (0.042 ms at 3.35 TB/s); the fold is 2 x 2 x 5 712 multiply-adds an
// output sample and the two transforms ~25 000 operations more
// (chip_smoke.py::kp_bound counts them).  Design: a CTA of 336 threads
// takes J = 16 x 336 / K consecutive output samples.  It stages their
// window of the input (os (J - 1) + Q K complex samples) in shared
// memory; thread (r, group) folds 16 outputs of its group for one r,
// the Taylor terms' prototypes read once a q for all 16 (two loads for
// 4 x terms x 16 multiply-adds) and the samples conflict-free (a warp's
// r are consecutive).  The folded values go to shared memory over the
// window; the transforms run in place there, a thread a small DFT held
// in registers (the static twiddles are kernel parameters at offsets
// known when it is compiled); the last pass combines the terms, rotates
// and writes dec once, consecutive threads on consecutive samples.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 336;                  // 21 x 16
constexpr int kJT = 16;                        // outputs a thread folds
constexpr int kOdd = 21;
constexpr int kMaxK = 21 * 16;
constexpr int kMaxOrders = 3;
constexpr long long kMask24 = 0xFFFFFF;
// float(np.float32(2 pi / 2^24)), the plain rotation's constant
constexpr float kTwoPiOver2_24 = 0x1.921fb6p-22f;

struct Twiddles {
  float2 w[kMaxK];                             // W^i, i < K
};

__device__ __forceinline__ float2 cmul(float2 x, float2 w) {
  return make_float2(x.x * w.x - x.y * w.y, x.x * w.y + x.y * w.x);
}

// x W^idx for an index known after unrolling.
template <int K>
__device__ __forceinline__ float2 tw(float2 x, int idx, const Twiddles& t) {
  idx %= K;
  if (idx == 0) return x;
  if (4 * idx == K) return make_float2(x.y, -x.x);
  if (2 * idx == K) return make_float2(-x.x, -x.y);
  if (4 * idx == 3 * K) return make_float2(-x.y, x.x);
  return cmul(x, t.w[idx]);
}

template <int K, int R>
struct Dft {
  // direct: y[k] = x[0] + x[1] W_R^k + ... in that order
  static __device__ __forceinline__ void run(const float2* x, float2* y,
                                             const Twiddles& t) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = x[0];
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const float2 p = tw<K>(x[m], (m * k % R) * (K / R), t);
        acc.x = acc.x + p.x;
        acc.y = acc.y + p.y;
      }
      y[k] = acc;
    }
  }
};

// R1 R2 points: input m = R2 a + b, output k = k1 + R1 k2.
template <int K, int R1, int R2>
__device__ __forceinline__ void dft_composite(const float2* x, float2* y,
                                              const Twiddles& t) {
  float2 z[R2][R1];
#pragma unroll
  for (int b = 0; b < R2; ++b) {
    float2 a[R1], o[R1];
#pragma unroll
    for (int i = 0; i < R1; ++i) a[i] = x[R2 * i + b];
    Dft<K, R1>::run(a, o, t);
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1)
      z[b][k1] = tw<K>(o[k1], b * k1 * (K / (R1 * R2)), t);
  }
#pragma unroll
  for (int k1 = 0; k1 < R1; ++k1) {
    float2 a[R2], o[R2];
#pragma unroll
    for (int b = 0; b < R2; ++b) a[b] = z[b][k1];
    Dft<K, R2>::run(a, o, t);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) y[k1 + R1 * k2] = o[k2];
  }
}

template <int K>
struct Dft<K, 8> {
  static __device__ __forceinline__ void run(const float2* x, float2* y,
                                             const Twiddles& t) {
    dft_composite<K, 2, 4>(x, y, t);
  }
};
template <int K>
struct Dft<K, 16> {
  static __device__ __forceinline__ void run(const float2* x, float2* y,
                                             const Twiddles& t) {
    dft_composite<K, 4, 4>(x, y, t);
  }
};
template <int K>
struct Dft<K, 21> {
  static __device__ __forceinline__ void run(const float2* x, float2* y,
                                             const Twiddles& t) {
    dft_composite<K, 3, 7>(x, y, t);
  }
};

__host__ __device__ constexpr int outputs_a_cta(int P) {
  return kJT * (kThreads / (kOdd * P));
}

template <int P, int NO>
__global__ void __launch_bounds__(kThreads, NO < 3 ? 2 : 1)
pfb_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
           long long N, const float* __restrict__ c_re,
           const float* __restrict__ c_im, int T1,
           const float* __restrict__ proto, int Q, int os, int M,
           const float2* __restrict__ pre, const int* __restrict__ bins,
           const int* __restrict__ dphi24, const float2* __restrict__ coef,
           int C, const long long* __restrict__ n0_ptr, long long n0_val,
           float* __restrict__ out, const __grid_constant__ Twiddles tw_) {
  constexpr int K = kOdd * P;
  constexpr int J = outputs_a_cta(P);
  extern __shared__ float2 smem[];
  float2* sw = smem;                           // K twiddles
  float2* f = smem + K;                        // folded values, in place
  float* sx = reinterpret_cast<float*>(f);     // the window, planes
  const int QK = Q * K;
  const int wn = os * (J - 1) + QK;
  float* sy = sx + wn;
  const int tid = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * J;

  for (int i = tid; i < K; i += kThreads) sw[i] = tw_.w[i];
  // window: x at raw index base + w, w < wn (carry, block, zeros)
  const long long base = static_cast<long long>(os) * j0 + os + T1 - QK;
  for (int w = tid; w < wn; w += kThreads) {
    const long long i = base + w;
    float a = 0.f, b = 0.f;
    if (i >= 0 && i < T1) {
      a = c_re[i];
      b = c_im[i];
    } else if (i >= T1 && i - T1 < N) {
      a = x_re[i - T1];
      b = x_im[i - T1];
    }
    sx[w] = a;
    sy[w] = b;
  }
  __syncthreads();

  // fold: thread (r, group) takes outputs group * kJT + i, i < kJT
  const int r = tid % K;
  const int jj0 = (tid / K) * kJT;
  float ar[NO][kJT], ai[NO][kJT];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < kJT; ++i) ar[n][i] = ai[n][i] = 0.f;
  for (int q = 0; q < Q; ++q) {
    float h[NO];
#pragma unroll
    for (int n = 0; n < NO; ++n) h[n] = __ldg(proto + n * QK + q * K + r);
    const int w0 = os * jj0 + QK - 1 - r - q * K;
#pragma unroll
    for (int i = 0; i < kJT; ++i) {
      const float xr = sx[w0 + os * i], xi = sy[w0 + os * i];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        ar[n][i] = ar[n][i] + h[n] * xr;
        ai[n][i] = ai[n][i] + h[n] * xi;
      }
    }
  }
  __syncthreads();                             // the window is read
  const float2 pt = pre != nullptr ? pre[r] : make_float2(1.f, 0.f);
#pragma unroll
  for (int i = 0; i < kJT; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float2 v = make_float2(ar[n][i], ai[n][i]);
      if (pre != nullptr) v = cmul(v, pt);
      f[((jj0 + i) * NO + n) * K + r] = v;
    }
  __syncthreads();

  // transform, pass 1: a P-point DFT over a for each (sample, term, b),
  // then W^{b k1}; in place at 21 k1 + b
  for (int task = tid; task < J * NO * kOdd; task += kThreads) {
    const int b = task % kOdd;
    float2* v = f + (task / kOdd) * K + b;
    float2 x[P], y[P];
#pragma unroll
    for (int a = 0; a < P; ++a) x[a] = v[kOdd * a];
    Dft<K, P>::run(x, y, tw_);
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) v[kOdd * k1] = cmul(y[k1], sw[b * k1 % K]);
  }
  __syncthreads();
  // pass 2: a 21-point DFT over b for each (sample, term, k1); bin
  // k1 + P k2 at 21 k1 + k2
  for (int task = tid; task < J * NO * P; task += kThreads) {
    float2* v = f + (task / P) * K + kOdd * (task % P);
    float2 x[kOdd], y[kOdd];
#pragma unroll
    for (int b = 0; b < kOdd; ++b) x[b] = v[b];
    Dft<K, kOdd>::run(x, y, tw_);
#pragma unroll
    for (int k2 = 0; k2 < kOdd; ++k2) v[k2] = y[k2];
  }
  __syncthreads();

  // combine the terms, rotate, write
  const long long n0 = n0_ptr != nullptr ? *n0_ptr : n0_val;
  for (int task = tid; task < C * J; task += kThreads) {
    const int jj = task % J;
    const int c = task / J;
    const long long j = j0 + jj;
    if (j >= M) continue;
    const int bin = bins[c];
    const float2* v = f + jj * NO * K + kOdd * (bin % P) + bin / P;
    float2 acc = cmul(v[0], coef[c * NO]);
#pragma unroll
    for (int n = 1; n < NO; ++n) {
      const float2 p = cmul(v[n * K], coef[c * NO + n]);
      acc.x = acc.x + p.x;
      acc.y = acc.y + p.y;
    }
    const long long g = n0 + static_cast<long long>(os) * (j + 1) - 1;
    const unsigned long long ph =
        (static_cast<unsigned long long>(g & kMask24) *
         static_cast<unsigned long long>(dphi24[c])) & kMask24;
    const float ang = static_cast<float>(ph) * kTwoPiOver2_24;
    const float cg = cosf(ang), sg = sinf(ang);
    out[static_cast<long long>(c) * M + j] = acc.x * cg - acc.y * sg;
    out[static_cast<long long>(C + c) * M + j] = acc.y * cg + acc.x * sg;
  }
}

template <int P, int NO>
int launch(const float* x_re, const float* x_im, long long N,
           const float* c_re, const float* c_im, int T1, const float* proto,
           int Q, int os, int M, const float2* pre, const Twiddles& tw,
           const int* bins, const int* dphi24, const float2* coef, int C,
           const long long* n0_ptr, long long n0_val, float* out,
           cudaStream_t stream) {
  constexpr int K = kOdd * P;
  constexpr int J = outputs_a_cta(P);
  const long long window = 2LL * (static_cast<long long>(os) * (J - 1) +
                                  static_cast<long long>(Q) * K) * 4;
  const long long folded = static_cast<long long>(J) * NO * K * 8;
  const long long bytes = K * 8 + (window > folded ? window : folded);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  // set on every launch: the attribute belongs to the current device's
  // context, and the mesh launches on several devices
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pfb_kernel<P, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((M + J - 1) / J);
  pfb_kernel<P, NO><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      x_re, x_im, N, c_re, c_im, T1, proto, Q, os, M, pre, bins, dphi24,
      coef, C, n0_ptr, n0_val, out, tw);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int by_orders(int orders, const float* x_re, const float* x_im, long long N,
              const float* c_re, const float* c_im, int T1,
              const float* proto, int Q, int os, int M, const float2* pre,
              const Twiddles& tw, const int* bins, const int* dphi24,
              const float2* coef, int C, const long long* n0_ptr,
              long long n0_val, float* out, cudaStream_t stream) {
  switch (orders) {
#define KP_ORDERS(NO)                                                      \
  case NO:                                                                 \
    return launch<P, NO>(x_re, x_im, N, c_re, c_im, T1, proto, Q, os, M,  \
                         pre, tw, bins, dphi24, coef, C, n0_ptr, n0_val,  \
                         out, stream);
    KP_ORDERS(1)
    KP_ORDERS(2)
    KP_ORDERS(3)
#undef KP_ORDERS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dec (2, C, M) of a block x (planes x_re, x_im, N samples) after the
// raw carry (planes c_re, c_im, T1 = T - 1 columns); proto (orders,
// Q K), pre (K) or null, wtab (K) on the host, bins, dphi24 (C),
// coef (C, orders) on the card; n0 from n0_ptr (a 0-dim int64 on the
// card) if it is not null, else n0_val.
extern "C" int pfb_launch(const float* x_re, const float* x_im, long long N,
                          const float* c_re, const float* c_im, int T1,
                          const float* proto, int Q, int os, int M,
                          const float* pre, const float* wtab,
                          const int* bins, const int* dphi24,
                          const float* coef, int C, int P, int orders,
                          const long long* n0_ptr, long long n0_val,
                          float* out, void* stream) {
  if (M <= 0) return 0;
  if (orders < 1 || orders > kMaxOrders)
    return static_cast<int>(cudaErrorInvalidValue);
  Twiddles tw;
  memset(&tw, 0, sizeof(tw));
  if (P >= 1 && P <= 16) memcpy(tw.w, wtab, sizeof(float2) * kOdd * P);
  const float2* pre2 = reinterpret_cast<const float2*>(pre);
  const float2* coef2 = reinterpret_cast<const float2*>(coef);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
#define KP_P(PP)                                                           \
  case PP:                                                                 \
    return by_orders<PP>(orders, x_re, x_im, N, c_re, c_im, T1, proto, Q, \
                         os, M, pre2, tw, bins, dphi24, coef2, C, n0_ptr, \
                         n0_val, out, s);
    KP_P(1)
    KP_P(2)
    KP_P(4)
    KP_P(8)
    KP_P(16)
#undef KP_P
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
