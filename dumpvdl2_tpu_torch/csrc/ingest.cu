// Raw-sample ingest kernel KI for Hopper (sm_90a).
//
// KI replaces no TPU kernel: the JAX package dequantizes a raw IQ file
// on the host (dumpvdl2_tpu/io/iqfile.py::dequantize_block) and hands
// the pipeline complex64 blocks.  The port copies the raw bytes to the
// card instead (S16_LE is half the bytes of planar float32, U8 a
// quarter) and builds the planar block there.  The plain version is
// dumpvdl2_tpu_torch/dsp/ingest_kernel.py::ingest_plain; on a CUDA
// tensor the wrapper there launches this.
//
// The stream it reads is V = P ++ raw: P the pend_n (< 4) bytes of a
// sample pair that the previous call's buffer ended in (packed little
// end first into `pend`), raw the device copy of this call's buffer.
// V holds S whole pairs; pair j is (I, Q) at bytes [j w2, (j + 1) w2),
// w2 = 2 x itemsize.  A value is
//   U8:     (x - 127.5f) / 127.5f      (an IEEE division, not a
//                                       reciprocal multiply)
//   S16_LE: x / 32768.0f               (exact)
// as dequantize_block computes it in float32.  Column t of the
// concatenation [residual (2, R), pairs (2, S)] goes to column t of the
// block (2, n_out) for t < n_out, else to column t - n_out of the new
// residual (2, n_total - n_out); n_total = R + S and n_out, a multiple
// of the oversample factor, is the caller's.
//
// Bound: bytes.  A wideband S16 block (4 194 240 samples) reads 16.8 MB
// and writes 33.6 MB: 15 us at 3.35 TB/s.  Design: a thread a group of
// four columns; where the group lies in the fresh samples of the block
// and the layout allows it (no pending bytes, R and n_out multiples of
// 4), one 16-byte (S16) or 8-byte (U8) load and two 16-byte stores;
// every other group (the residual's columns, the new residual, a ragged
// layout) column by column, byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                      // columns a thread

__device__ __forceinline__ unsigned byte_at(const unsigned char* raw,
                                            unsigned pend, int pend_n,
                                            long long o) {
  return o < pend_n ? (pend >> (8 * o)) & 0xFFu : raw[o - pend_n];
}

__device__ __forceinline__ float u8_value(unsigned x) {
  return __fdiv_rn(static_cast<float>(x) - 127.5f, 127.5f);
}

__device__ __forceinline__ float s16_value(unsigned lo, unsigned hi) {
  const short v = static_cast<short>(lo | (hi << 8));
  return __fdiv_rn(static_cast<float>(v), 32768.0f);
}

// Value k (0: I, 1: Q) of fresh pair j of V, read byte by byte.
__device__ __forceinline__ float value_at(const unsigned char* raw,
                                          unsigned pend, int pend_n,
                                          int s16, long long j, int k) {
  if (s16) {
    const long long o = (2 * j + k) * 2;
    return s16_value(byte_at(raw, pend, pend_n, o),
                     byte_at(raw, pend, pend_n, o + 1));
  }
  return u8_value(byte_at(raw, pend, pend_n, 2 * j + k));
}

__global__ void __launch_bounds__(kThreads)
ingest_kernel(const unsigned char* __restrict__ raw, unsigned pend,
              int pend_n, int s16, const float* __restrict__ res_in, int R,
              float* __restrict__ out, long long n_out,
              float* __restrict__ res_out, long long n_total, int vec) {
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kGroup;
  if (t0 >= n_total) return;
  const long long r_new = n_total - n_out;
  if (vec && t0 >= R && t0 + kGroup <= n_out) {
    const long long j = t0 - R;              // a multiple of 4
    float4 re, im;
    if (s16) {
      const int4 w = *reinterpret_cast<const int4*>(raw + 4 * j);
      const unsigned u[4] = {static_cast<unsigned>(w.x),
                             static_cast<unsigned>(w.y),
                             static_cast<unsigned>(w.z),
                             static_cast<unsigned>(w.w)};
      float f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __fdiv_rn(static_cast<float>(
            static_cast<short>(u[i] & 0xFFFFu)), 32768.0f);
        f[2 * i + 1] = __fdiv_rn(static_cast<float>(
            static_cast<short>(u[i] >> 16)), 32768.0f);
      }
      re = make_float4(f[0], f[2], f[4], f[6]);
      im = make_float4(f[1], f[3], f[5], f[7]);
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(raw + 2 * j);
      float f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[i] = u8_value((w.x >> (8 * i)) & 0xFFu);
        f[4 + i] = u8_value((w.y >> (8 * i)) & 0xFFu);
      }
      re = make_float4(f[0], f[2], f[4], f[6]);
      im = make_float4(f[1], f[3], f[5], f[7]);
    }
    *reinterpret_cast<float4*>(out + t0) = re;
    *reinterpret_cast<float4*>(out + n_out + t0) = im;
    return;
  }
  for (int g = 0; g < kGroup; ++g) {
    const long long t = t0 + g;
    if (t >= n_total) return;
    float v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] = t < R ? res_in[k * static_cast<long long>(R) + t]
                   : value_at(raw, pend, pend_n, s16, t - R, k);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (t < n_out)
        out[k * n_out + t] = v[k];
      else
        res_out[k * r_new + (t - n_out)] = v[k];
    }
  }
}

}  // namespace

extern "C" int ingest_launch(const unsigned char* raw, unsigned pend,
                             int pend_n, int s16, const float* res_in,
                             int R, float* out, long long n_out,
                             float* res_out, long long n_total,
                             void* stream) {
  if (n_total <= 0) return 0;
  const int vec = pend_n == 0 && R % kGroup == 0 && n_out % kGroup == 0 &&
                  reinterpret_cast<uintptr_t>(raw) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long groups = (n_total + kGroup - 1) / kGroup;
  const long long grid = (groups + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  ingest_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      raw, pend, pend_n, s16, res_in, R, out, n_out, res_out, n_total, vec);
  return static_cast<int>(cudaGetLastError());
}
