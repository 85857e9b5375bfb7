// Device helpers shared by the package's kernels: complex arithmetic,
// radix-2 FFTs in shared memory over natural-order spectra, two-for-one
// real-pair packing, the ITD delay ramp, and the effective-filter chain
// that every filter-assembly kernel runs.
//
// Everything here has internal linkage (anonymous namespace): each .cu
// includes this header and the build links all of them into one library.
// All arithmetic is fp32 with accurate twiddles (sincospif); build without
// --use_fast_math: the delay ramp's phase reaches ~48π rad at L = 256 and
// grows with L, where __sinf/__cosf are inaccurate outside [-π, π], so its
// integer part is reduced exactly as (j·⌊d⌋) mod L instead.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ int bitrev(int i, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
}

// Split the FFT Z of a packed real pair z = a + i·b into A = rfft(a) and
// B = rfft(b) at bin k, given Zm = Z[(n-k) mod n].
__device__ __forceinline__ void unpack_pair(float2 Z, float2 Zm, float2* A,
                                            float2* B) {
  *A = make_float2(0.5f * (Z.x + Zm.x), 0.5f * (Z.y - Zm.y));
  *B = make_float2(0.5f * (Z.y + Zm.y), 0.5f * (Zm.x - Z.x));
}

// Store the full spectrum W = A + i·B of the real pair whose half spectra
// are A[k], B[k] (k ≤ n/2) at bin k and its mirror n-k, in bit-reversed
// order. The imaginary parts at DC and Nyquist are dropped, as irfft does.
__device__ __forceinline__ void pack_pair(float2* buf, int k, int n, int log2n,
                                          float2 A, float2 B) {
  if (k == 0 || k == n / 2) {
    A.y = 0.f;
    B.y = 0.f;
  }
  buf[bitrev(k, log2n)] = make_float2(A.x - B.y, A.y + B.x);
  if (k != 0 && k != n / 2)
    buf[bitrev(n - k, log2n)] = make_float2(A.x + B.y, B.x - A.y);
}

// tw[k] = exp(-2πi·k/n) for k < n/2.
__device__ void make_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    float s, c;
    sincospif(2.0f * k / n, &s, &c);
    tw[k] = make_float2(c, -s);
  }
}

// In-place radix-2 FFT of n points held in bit-reversed order in shared
// memory; natural order on return. tw is the twiddle table of size tw_n
// (tw_n ≥ n). inverse conjugates the twiddles and does not scale.
__device__ void fft_bitrev(float2* x, int n, const float2* tw, int tw_n,
                           bool inverse) {
  __syncthreads();
  for (int half = 1; half < n; half <<= 1) {
    const int stride = tw_n / (2 * half);
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      const int pos = t & (half - 1);
      const int i0 = ((t - pos) << 1) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos * stride];
      if (inverse) w.y = -w.y;
      const float2 a = x[i0];
      const float2 b = cmul(x[i1], w);
      x[i0] = make_float2(a.x + b.x, a.y + b.y);
      x[i1] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// delay_ramp (tinaural/data/table.py) at bin j of an L-point rfft for a
// clipped shift d: exp(j·[θ·⌊d⌋ + W·θ·frac + (1−W)·ψ]), θ = −2πj/L. The
// integer part is reduced exactly to (j·⌊d⌋) mod L before the sine.
__device__ float2 delay_ramp_bin(int j, int L, float d, float taper_lo,
                                 float taper_hi) {
  const float di = floorf(d);
  const float frac = d - di;
  int m = (j * static_cast<int>(di)) % L;
  if (m < 0) m += L;
  float si, ci;
  sincospif(2.0f * m / L, &si, &ci);
  const float fnorm = static_cast<float>(j) / L;
  float st, ct;  // sin/cos of 2π·fnorm; θ = −2π·fnorm
  sincospif(2.0f * fnorm, &st, &ct);
  const float theta = -2.0f * CUDART_PI_F * fnorm;
  const float tt =
      fminf(fmaxf((fnorm - taper_lo) / (taper_hi - taper_lo), 0.f), 1.f);
  const float wt = 0.5f * (1.0f + cospif(tt));
  const float psi = atan2f(-frac * st, (1.0f - frac) + frac * ct);
  const float ph = wt * theta * frac + (1.0f - wt) * psi;
  float sp, cp;
  sincosf(ph, &sp, &cp);
  return cmul(make_float2(ci, -si), make_float2(cp, sp));
}

// n_fft/log2n name the transform an assembly kernel ends in: the render's
// FFT size for assemble_filters, the 2B partition frame for
// assemble_partitions.
struct AssemblyParams {
  int taps, t_pad, L, log2L, n_fft, log2n;
  int apply_itd, apply_ild;
  float align_guard, max_shift, taper_lo, taper_hi;
};

// The effective-filter chain of one row, shared by every assembly kernel:
// gather + lerp of the 4 table rows rows[k] with weights wk[k] (both in
// shared memory, visible to all threads), the clipped delays and the gains
// into dg = (d0, d1, g0, g1), rfft_L of both ears packed as h0 + i·h1,
// delay ramp and gain per ear, one packed irfft_L. On return s2 holds
// L·h_eff in natural order (x = ear 0, y = ear 1) for t < L; s1 is
// scratch. tw is a twiddle table of size tw_n ≥ L.
__device__ void effective_filter_L(const int* rows, const float* wk, float* dg,
                                   const float* __restrict__ h_table,
                                   const float* __restrict__ delays,
                                   const float* __restrict__ gains,
                                   const AssemblyParams& p, const float2* tw,
                                   int tw_n, float2* s1, float2* s2) {
  if (threadIdx.x < 4) {
    const int e = threadIdx.x & 1;
    const bool gain = threadIdx.x >= 2;
    float v;
    if (gain ? p.apply_ild : p.apply_itd) {
      const float* src = gain ? gains : delays;
      v = 0.f;
      for (int k = 0; k < 4; ++k) v += wk[k] * src[2 * rows[k] + e];
    } else {
      v = gain ? 1.f : p.align_guard;
    }
    if (!gain) v = fminf(fmaxf(v - p.align_guard, -p.align_guard), p.max_shift);
    dg[threadIdx.x] = v;
  }
  // gathered shapes of both ears, packed as h0 + i·h1, zero-padded to L
  for (int t = threadIdx.x; t < p.L; t += blockDim.x) {
    float2 z = make_float2(0.f, 0.f);
    if (t < p.taps) {
      for (int k = 0; k < 4; ++k) {
        const float* row = h_table + static_cast<size_t>(rows[k]) * 2 * p.taps;
        z.x += wk[k] * row[t];
        z.y += wk[k] * row[p.taps + t];
      }
    }
    s1[bitrev(t, p.log2L)] = z;
  }
  fft_bitrev(s1, p.L, tw, tw_n, false);

  // ramp and gain per ear, repacked for one inverse FFT of both ears
  for (int j = threadIdx.x; j <= p.L / 2; j += blockDim.x) {
    float2 G0, G1;
    unpack_pair(s1[j], s1[(p.L - j) & (p.L - 1)], &G0, &G1);
    G0 = cscale(cmul(G0, delay_ramp_bin(j, p.L, dg[0], p.taper_lo, p.taper_hi)),
                dg[2]);
    G1 = cscale(cmul(G1, delay_ramp_bin(j, p.L, dg[1], p.taper_lo, p.taper_hi)),
                dg[3]);
    pack_pair(s2, j, p.L, p.log2L, G0, G1);
  }
  fft_bitrev(s2, p.L, tw, tw_n, true);
}

__host__ __device__ int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

AssemblyParams assembly_params(int taps, int t_pad, int n_fft, int apply_itd,
                               int apply_ild, float align_guard,
                               float max_shift, float taper_lo,
                               float taper_hi) {
  AssemblyParams p;
  p.taps = taps;
  p.t_pad = t_pad;
  p.L = 1 << ilog2(t_pad);
  p.log2L = ilog2(t_pad);
  p.n_fft = n_fft;
  p.log2n = ilog2(n_fft);
  p.apply_itd = apply_itd;
  p.apply_ild = apply_ild;
  p.align_guard = align_guard;
  p.max_shift = max_shift;
  p.taper_lo = taper_lo;
  p.taper_hi = taper_hi;
  return p;
}

}  // namespace
