// D8PSK preamble sync error metric (kernel K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel dumpvdl2_tpu/dsp/sync_pallas.py
// (sync_error_metric_pallas, body _metric_kernel).  At every decimated
// sample n of every channel it fits the 16-symbol preamble phase ramp:
// take the phases at n-150+10k (k = 0..15), subtract the preamble
// phase PR_PHASE[k], unwrap along k, remove the mean, fit the slope
// freq = sum x_k e_k / 340 with x_k = k-7.5, and return the residual
// sum of squares as err.  For n < 150 the kernel itself writes
// err = +inf and freq = 0.  The plain PyTorch twin is
// dumpvdl2_tpu_torch/dsp/sync_kernel.py:sync_error_metric_plain.
//
// Bound: memory.  Each sample is read once (4 bytes) and two results
// are written (8 bytes) against ~150 flops, far below the H100's
// ~20 flop/byte balance point for fp32 outside the tensor cores.  At
// the wideband shape (256, 108 844) that is 0.33 GB, ~0.1 ms at
// 3.35 TB/s.
//
// Design: one block per (256-sample output tile, channel).  The block
// stages the tile's 256+150 input phases in shared memory with
// coalesced loads (the 150-sample lookback is the only re-read, 1.6x
// of the tile from shared memory, never from device memory twice per
// thread); one thread per output sample then runs the 16-term unwrap,
// mean, slope and residual in registers.  Ragged M and any C are
// handled by bounds checks, so the wrapper pads nothing.
//
// Numerics follow the plain version: the same float32 constants, the
// same operation order (err_k = phi - PR_PHASE[k], d = err_k - err_{k-1}
// compared against pi) so the +-2pi unwrap decisions match.  Built
// without fast math and with FMA contraction off.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 256;
constexpr int kSyms = 16;
constexpr int kSps = 10;
constexpr int kLookback = (kSyms - 1) * kSps;   // 150

// Preamble phase ramp in units of pi/4 (constants.PREAMBLE_PHASE_UNITS).
__constant__ float kPrUnits[kSyms] = {0, 3, -3, 1, 1, 2, 0, 4,
                                      -3, 4, -2, 3, 1, -2, -3, 0};

__global__ void __launch_bounds__(kTile)
sync_metric_kernel(const float* __restrict__ ph, float* __restrict__ err,
                   float* __restrict__ freq, int M) {
  __shared__ float win[kTile + kLookback];
  const long long row = static_cast<long long>(blockIdx.y) * M;
  const int n0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < kTile + kLookback; i += kTile) {
    const int src = n0 - kLookback + i;
    win[i] = (src >= 0 && src < M) ? ph[row + src] : 0.0f;
  }
  __syncthreads();

  const int n = n0 + threadIdx.x;
  if (n >= M) return;
  if (n < kLookback) {
    err[row + n] = CUDART_INF_F;
    freq[row + n] = 0.0f;
    return;
  }

  const float pi = 3.14159265358979323846f;        // float32(pi)
  const float two_pi = 6.28318530717958647692f;    // float32(2 pi)
  const float quarter_pi = 0.78539816339744830962f;  // float32(pi / 4)

  // win[threadIdx.x + 10k] is the phase at n - 150 + 10k
  const float* w = win + threadIdx.x;
  float ev[kSyms];
  float prev = w[0] - kPrUnits[0] * quarter_pi;
  float cum = 0.0f;
  ev[0] = prev;
#pragma unroll
  for (int k = 1; k < kSyms; ++k) {
    const float cur = w[k * kSps] - kPrUnits[k] * quarter_pi;
    const float d = cur - prev;
    const float adj = (d > pi ? -two_pi : 0.0f) + (d < -pi ? two_pi : 0.0f);
    cum = cum + adj;
    ev[k] = cur + cum;
    prev = cur;
  }

  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kSyms; ++k) sum = sum + ev[k];
  const float mean = sum / 16.0f;

  float f = 0.0f;
#pragma unroll
  for (int k = 0; k < kSyms; ++k) {
    ev[k] = ev[k] - mean;
    f = f + (static_cast<float>(k) - 7.5f) * ev[k];
  }
  f = f / 340.0f;

  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < kSyms; ++k) {
    const float r = ev[k] - f * (static_cast<float>(k) - 7.5f);
    e = e + r * r;
  }
  err[row + n] = e;
  freq[row + n] = f;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `phases`, `err`, `freq`
// are (C, M) contiguous float32 device buffers; launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int sync_metric_launch(const float* phases, float* err,
                                  float* freq, int C, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  if (C > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((M + kTile - 1) / kTile, C);
  sync_metric_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      phases, err, freq, M);
  return static_cast<int>(cudaGetLastError());
}
