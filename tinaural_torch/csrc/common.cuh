// Device helpers shared by the package's kernels: complex arithmetic,
// radix-2 FFTs over natural-order spectra (in shared memory, or split in
// two passes over a device-memory scratch for sizes above shared memory),
// two-for-one real-pair packing, the ITD delay ramp, the effective-filter
// chain that every filter-assembly kernel runs, and the packed inverse of
// two ears' spectra.
//
// Everything here has internal linkage (anonymous namespace): each .cu
// includes this header and the build links all of them into one library.
// All arithmetic is fp32 with accurate twiddles (sincospif); build without
// --use_fast_math: the delay ramp's phase reaches ~48π rad at L = 256 and
// grows with L, where __sinf/__cosf are inaccurate outside [-π, π], so its
// integer part is reduced exactly as (j·⌊d⌋) mod L instead.
//
// Two buffer modes, picked by the host from the shapes before a launch
// (tinaural_torch/ops/_layout.py): every kernel is a template on kSplit.
//   kSplit = false  the twiddles and every FFT buffer live in shared memory;
//                   one CUDA block per row.
//   kSplit = true   the FFT buffers live in a device-memory scratch, one
//                   slice per CUDA block, and the blocks walk the rows in a
//                   grid-stride loop. An n-point FFT is split as n = n1·n2
//                   (n2 = min(n, work)): pass 1 runs the n1 contiguous
//                   n2-point rows in shared memory and applies the
//                   twiddles, pass 2 the n2 strided n1-point columns, `work`
//                   points at a time. Two device-memory round trips per
//                   transform instead of log2(n) for a radix-2 loop.

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

// log2n ≥ 1: every caller transforms at least 2 points.
__device__ __forceinline__ int bitrev(int i, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
}

__host__ __device__ inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// An n-point FFT's layout: unsplit (work == 0, in shared memory, input in
// bit-reversed order) or split as n = n1·n2 (input x[t] at position
// (t mod n1)·n2 + ⌊t/n1⌋). Either way the output is in natural order.
struct FftPlan {
  int n, log2n, n1, log2n1, n2, log2n2, work;
};

__host__ __device__ inline FftPlan fft_plan(int n, int work) {
  FftPlan f;
  f.n = n;
  f.log2n = ilog2(n);
  f.work = work;
  f.n2 = work > 0 && work < n ? work : n;
  f.log2n2 = ilog2(f.n2);
  f.n1 = n / f.n2;
  f.log2n1 = ilog2(f.n1);
  return f;
}

// Where sample t of an FFT's input goes.
template <bool kSplit>
__device__ __forceinline__ int fft_pos(const FftPlan& f, int t) {
  if (kSplit) return ((t & (f.n1 - 1)) << f.log2n2) + (t >> f.log2n1);
  return bitrev(t, f.log2n);
}

// Split the FFT Z of a packed real pair z = a + i·b into A = rfft(a) and
// B = rfft(b) at bin k, given Zm = Z[(n-k) mod n].
__device__ __forceinline__ void unpack_pair(float2 Z, float2 Zm, float2* A,
                                            float2* B) {
  *A = make_float2(0.5f * (Z.x + Zm.x), 0.5f * (Z.y - Zm.y));
  *B = make_float2(0.5f * (Z.y + Zm.y), 0.5f * (Zm.x - Z.x));
}

// Store the full spectrum W = A + i·B of the real pair whose half spectra
// are A[k], B[k] (k ≤ n/2) at bin k and its mirror n-k, as the input of
// the inverse FFT f. The imaginary parts at DC and Nyquist are dropped, as
// irfft does.
template <bool kSplit>
__device__ __forceinline__ void pack_pair(float2* buf, const FftPlan& f, int k,
                                          float2 A, float2 B) {
  const int n = f.n;
  if (k == 0 || k == n / 2) {
    A.y = 0.f;
    B.y = 0.f;
  }
  buf[fft_pos<kSplit>(f, k)] = make_float2(A.x - B.y, A.y + B.x);
  if (k != 0 && k != n / 2)
    buf[fft_pos<kSplit>(f, n - k)] = make_float2(A.x + B.y, B.x - A.y);
}

// tw[k] = exp(-2πi·k/n) for k < n/2.
__device__ void make_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    float s, c;
    sincospif(2.0f * k / n, &s, &c);
    tw[k] = make_float2(c, -s);
  }
}

// In-place radix-2 FFT of n points held in bit-reversed order; natural
// order on return. kBatch: `count` such transforms stored one after
// another (the split passes); without it the loop is the single-transform
// one the shared mode runs. tw is the twiddle table of size tw_n
// (tw_n ≥ n). inverse conjugates the twiddles and does not scale.
template <bool kBatch = false>
__device__ void fft_bitrev(float2* x, int n, const float2* tw, int tw_n,
                           bool inverse, int count = 1) {
  const int h = n / 2;
  const int log2h = kBatch ? ilog2(h) : 0;
  __syncthreads();
  for (int half = 1; half < n; half <<= 1) {
    const int stride = tw_n / (2 * half);
    for (int t = threadIdx.x; t < (kBatch ? count * h : h); t += blockDim.x) {
      const int u = kBatch ? t & (h - 1) : t;
      const int pos = u & (half - 1);
      const int i0 =
          (kBatch ? (t >> log2h) * n : 0) + ((u - pos) << 1) + pos;
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

// The n-point FFT of x, laid out as fft_pos puts it, in place; natural
// order on return. Unsplit, x is in shared memory and `work` is unused.
// Split, x is a device-memory slice of this block, `work` holds f.work
// points of shared memory, and the twiddle table covers tw_n ≥ f.work. The
// cross twiddle exp(∓2πi·j1·k2/n) is exact in its integer part
// (j1·k2 < n ≤ 2^24).
template <bool kSplit>
__device__ void fft_run(const FftPlan& f, float2* x, const float2* tw,
                        int tw_n, float2* work, bool inverse) {
  if (!kSplit) {
    fft_bitrev(x, f.n, tw, tw_n, inverse);
    return;
  }
  // pass 1: the n1 rows of n2 contiguous points, R at a time, then the
  // cross twiddles
  const int R = f.work >> f.log2n2;
  for (int r0 = 0; r0 < f.n1; r0 += R) {
    const int rows = min(R, f.n1 - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < (rows << f.log2n2); i += blockDim.x) {
      const int rr = i >> f.log2n2;
      const int j = i & (f.n2 - 1);
      work[(rr << f.log2n2) + bitrev(j, f.log2n2)] =
          x[(static_cast<size_t>(r0 + rr) << f.log2n2) + j];
    }
    fft_bitrev<true>(work, f.n2, tw, tw_n, inverse, rows);
    for (int i = threadIdx.x; i < (rows << f.log2n2); i += blockDim.x) {
      const int rr = i >> f.log2n2;
      const int k2 = i & (f.n2 - 1);
      float2 v = work[i];
      if (f.n1 > 1) {
        float s, c;
        sincospif(2.0f * static_cast<float>((r0 + rr) * k2) / f.n, &s, &c);
        v = cmul(v, make_float2(c, inverse ? s : -s));
      }
      x[(static_cast<size_t>(r0 + rr) << f.log2n2) + k2] = v;
    }
  }
  // pass 2: the n2 columns of n1 points strided by n2, C at a time
  if (f.n1 > 1) {
    const int C = min(f.work >> f.log2n1, f.n2);
    const int lc = ilog2(C);
    for (int c0 = 0; c0 < f.n2; c0 += C) {
      __syncthreads();
      for (int i = threadIdx.x; i < (C << f.log2n1); i += blockDim.x) {
        const int j1 = i >> lc;
        const int cc = i & (C - 1);
        work[(cc << f.log2n1) + bitrev(j1, f.log2n1)] =
            x[(static_cast<size_t>(j1) << f.log2n2) + c0 + cc];
      }
      fft_bitrev<true>(work, f.n1, tw, tw_n, inverse, C);
      for (int i = threadIdx.x; i < (C << f.log2n1); i += blockDim.x) {
        const int k1 = i >> lc;
        const int cc = i & (C - 1);
        x[(static_cast<size_t>(k1) << f.log2n2) + c0 + cc] =
            work[(cc << f.log2n1) + k1];
      }
    }
  }
  __syncthreads();
}

// The packed inverse of two ears' half spectra A, B (n/2 + 1 bins each,
// shared or device memory): one complex FFT through buf, then the frames
// f0 = irfft(A), f1 = irfft(B), n samples each. With terms > 1, A and B are
// the sums of `terms` spectra `stride` float2 apart, added in order. A and
// B must be complete (a barrier after their last write); buf is rewritten.
template <bool kSplit>
__device__ void inverse_pair(const float2* A, const float2* B, float2* buf,
                             const FftPlan& f, const float2* tw, int tw_n,
                             float2* work, float* f0, float* f1,
                             int terms = 1, size_t stride = 0) {
  for (int k = threadIdx.x; k <= f.n / 2; k += blockDim.x) {
    float2 a = A[k], b = B[k];
    for (int t = 1; t < terms; ++t) {
      a = cadd(a, A[t * stride + k]);
      b = cadd(b, B[t * stride + k]);
    }
    pack_pair<kSplit>(buf, f, k, a, b);
  }
  fft_run<kSplit>(f, buf, tw, tw_n, work, true);
  const float inv_n = 1.0f / f.n;
  for (int t = threadIdx.x; t < f.n; t += blockDim.x) {
    f0[t] = buf[t].x * inv_n;
    f1[t] = buf[t].y * inv_n;
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
// scratch. fL is the L-point plan, tw a twiddle table of size tw_n and
// work the split passes' shared memory.
template <bool kSplit>
__device__ void effective_filter_L(const int* rows, const float* wk, float* dg,
                                   const float* __restrict__ h_table,
                                   const float* __restrict__ delays,
                                   const float* __restrict__ gains,
                                   const AssemblyParams& p, const FftPlan& fL,
                                   const float2* tw, int tw_n, float2* work,
                                   float2* s1, float2* s2) {
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
    s1[fft_pos<kSplit>(fL, t)] = z;
  }
  fft_run<kSplit>(fL, s1, tw, tw_n, work, false);

  // ramp and gain per ear, repacked for one inverse FFT of both ears
  for (int j = threadIdx.x; j <= p.L / 2; j += blockDim.x) {
    float2 G0, G1;
    unpack_pair(s1[j], s1[(p.L - j) & (p.L - 1)], &G0, &G1);
    G0 = cscale(cmul(G0, delay_ramp_bin(j, p.L, dg[0], p.taper_lo, p.taper_hi)),
                dg[2]);
    G1 = cscale(cmul(G1, delay_ramp_bin(j, p.L, dg[1], p.taper_lo, p.taper_hi)),
                dg[3]);
    pack_pair<kSplit>(s2, fL, j, G0, G1);
  }
  fft_run<kSplit>(fL, s2, tw, tw_n, work, true);
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

// The next row of a kernel's CUDA block: none after its own in the shared
// mode (so the row loop compiles to one pass), every gridDim.x-th row in
// the split mode.
template <bool kSplit>
__device__ __forceinline__ int next_row(int r, int rows) {
  return kSplit ? r + static_cast<int>(gridDim.x) : rows;
}

// Where a kernel's buffers go: `slices` > 0 selects the split mode with
// that many CUDA blocks (a scratch slice each) and `work` points of shared
// memory per split pass; 0 the shared mode with one block per row.
struct Launch {
  int grid, smem;
};

// Launch shape and the dynamic shared memory: `shared_f2` float2 in the
// shared mode, the twiddles and work area (work/2 + work float2) in the
// split mode. Raises the kernel's shared-memory limit to it (above 48 KB a
// kernel must opt in).
template <typename K>
int launch_shape(K kernel, int rows, int slices, int work, long long shared_f2,
                 Launch* out) {
  const long long f2 = slices > 0 ? work / 2 + work : shared_f2;
  out->grid = slices > 0 ? slices : rows;
  out->smem = static_cast<int>(f2 * static_cast<long long>(sizeof(float2)));
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out->smem));
}

}  // namespace
