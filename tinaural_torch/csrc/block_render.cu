// Hand-written Hopper kernels of the single-launch block render.
//
// Replaces tinaural/ops/pallas_kernels.py:fused_block_render (kernel body
// _block_render_kernel, built from _vmem_gather, _block_spectra_core with
// _ramp_cos_sin, and _inverse_ola_core). The TPU kernel works in a
// scrambled four-step FFT layout and leans on its grid running in order:
// it carries the previous filter, the source mixdown and the OLA tails
// across grid steps. CUDA blocks run in parallel and in no order, so the
// same map is split into three kernels over natural-order spectra:
//
//   assemble_filters           one block per (source, block) row: gather +
//                              lerp of 4 table rows, rfft_L, delay ramp and
//                              gain, irfft_L, truncation, rfft_nfft → H.
//   block_spectra_mix_inverse  one block per output block b, a loop over the
//                              sources inside it (the TPU's sequential source
//                              axis, deterministic, no atomics): crossfaded
//                              MAC against H[s,b] and H[s,b-1], mixdown, one
//                              packed inverse FFT for both ears → frames.
//   overlap_add                out[e,t] = Σ_j frames[b-j, e, t-(b-j)·B].
//
// All arithmetic is fp32, FFTs are radix-2 in shared memory with accurate
// twiddles (sincospif). Build without --use_fast_math: the delay ramp's
// phase reaches ~48π rad and __sinf/__cosf are inaccurate outside [-π, π];
// its integer part is reduced exactly as (j·⌊d⌋) mod L instead.

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

struct AssemblyParams {
  int taps, t_pad, L, log2L, n_fft, log2n;
  int apply_itd, apply_ild;
  float align_guard, max_shift, taper_lo, taper_hi;
};

// One block per (source, block) row r. Bound on the H100 by its three
// shared-memory FFTs and their __syncthreads() stages (the table rows are
// ~1 MB, L2-resident); both ears ride one complex FFT at every stage.
__global__ void assemble_filters_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ h_table,
                                        const float* __restrict__ delays,
                                        const float* __restrict__ gains,
                                        float2* __restrict__ H,
                                        AssemblyParams p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;              // n_fft / 2
  float2* big = tw + p.n_fft / 2;  // n_fft
  float2* s1 = big + p.n_fft;      // L
  float2* s2 = s1 + p.L;           // L
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];  // d0, d1, g0, g1

  const int r = blockIdx.x;
  const int F = p.n_fft / 2 + 1;
  if (threadIdx.x < 4) {
    rows[threadIdx.x] = idx[4 * r + threadIdx.x];
    wk[threadIdx.x] = w[4 * r + threadIdx.x];
  }
  make_twiddles(tw, p.n_fft);
  __syncthreads();

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
  fft_bitrev(s1, p.L, tw, p.n_fft, false);

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
  fft_bitrev(s2, p.L, tw, p.n_fft, true);

  // h_eff truncated to T_pad, packed, zero-padded to n_fft
  const float inv_L = 1.0f / p.L;
  for (int t = threadIdx.x; t < p.n_fft; t += blockDim.x) {
    big[bitrev(t, p.log2n)] =
        t < p.t_pad ? cscale(s2[t], inv_L) : make_float2(0.f, 0.f);
  }
  fft_bitrev(big, p.n_fft, tw, p.n_fft, false);

  float2* H0 = H + static_cast<size_t>(r) * 2 * F;
  float2* H1 = H0 + F;
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    float2 A, B;
    unpack_pair(big[k], big[(p.n_fft - k) & (p.n_fft - 1)], &A, &B);
    H0[k] = A;
    H1[k] = B;
  }
}

// One block per output block b, looping over the S sources. Bound on the
// H100 by the shared-memory FFTs (one forward per source, one inverse per
// block) and by streaming H[s,b], H[s,b-1] from device memory (32 KB per
// source and block); at S = 64, nb = 128 the grid is only 128 blocks.
__global__ void block_spectra_mix_inverse_kernel(const float* __restrict__ x,
                                                 const float2* __restrict__ H,
                                                 float* __restrict__ frames,
                                                 int S, int nb, int B,
                                                 int n_fft, int log2n,
                                                 int crossfade) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  float2* tw = smem;        // n / 2
  float2* buf = tw + n / 2;  // n
  float2* acc0 = buf + n;    // F
  float2* acc1 = acc0 + F;   // F

  const int b = blockIdx.x;
  make_twiddles(tw, n);
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    acc0[k] = make_float2(0.f, 0.f);
    acc1[k] = make_float2(0.f, 0.f);
  }
  const float inv_B = 1.0f / B;
  for (int s = 0; s < S; ++s) {
    const float* xb = x + (static_cast<size_t>(s) * nb + b) * B;
    // crossfade: one FFT of x·u + i·x·(1−u), u = (i + 0.5)/B
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      float2 z = make_float2(0.f, 0.f);
      if (t < B) {
        const float v = xb[t];
        if (crossfade) {
          const float xu = v * ((t + 0.5f) * inv_B);
          z = make_float2(xu, v - xu);
        } else {
          z.x = v;
        }
      }
      buf[bitrev(t, log2n)] = z;
    }
    fft_bitrev(buf, n, tw, n, false);

    const float2* Hc = H + (static_cast<size_t>(s) * nb + b) * 2 * F;
    // block 0 of every source takes its own filter as "previous"
    const float2* Hp = H + (static_cast<size_t>(s) * nb + (b > 0 ? b - 1 : 0)) * 2 * F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      if (crossfade) {
        float2 Xu, Xd;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
        acc0[k] = cadd(acc0[k], cadd(cmul(Xu, Hc[k]), cmul(Xd, Hp[k])));
        acc1[k] = cadd(acc1[k], cadd(cmul(Xu, Hc[F + k]), cmul(Xd, Hp[F + k])));
      } else {
        const float2 X = buf[k];
        acc0[k] = cadd(acc0[k], cmul(X, Hc[k]));
        acc1[k] = cadd(acc1[k], cmul(X, Hc[F + k]));
      }
    }
    __syncthreads();  // buf is rewritten by the next source
  }

  for (int k = threadIdx.x; k <= n / 2; k += blockDim.x)
    pack_pair(buf, k, n, log2n, acc0[k], acc1[k]);
  fft_bitrev(buf, n, tw, n, true);

  float* f0 = frames + static_cast<size_t>(b) * 2 * n;
  float* f1 = f0 + n;
  const float inv_n = 1.0f / n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    f0[t] = buf[t].x * inv_n;
    f1[t] = buf[t].y * inv_n;
  }
}

// One thread per output sample: a pure strided reduction over the
// k = n_fft/B frames that overlap it, bound by device-memory bandwidth.
__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   float* __restrict__ out, int nb, int B,
                                   int n_fft) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * out_len) return;
  const int e = static_cast<int>(i / out_len);
  const long long t = i % out_len;
  const int q = static_cast<int>(t / B);
  const int k = n_fft / B;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int bb = q - j;
    if (bb >= 0 && bb < nb)
      acc += frames[(static_cast<size_t>(bb) * 2 + e) * n_fft +
                    (t - static_cast<long long>(bb) * B)];
  }
  out[i] = acc;
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H: (rows, 2, n_fft/2+1) complex64.
int tt_assemble_filters(const void* idx, const void* w, const void* h_table,
                        const void* delays, const void* gains, void* H,
                        int rows, int taps, int t_pad, int n_fft,
                        int apply_itd, int apply_ild, float align_guard,
                        float max_shift, float taper_lo, float taper_hi,
                        void* stream) {
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
  const int smem = static_cast<int>((n_fft / 2 + n_fft + 2 * p.L) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      assemble_filters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  assemble_filters_kernel<<<rows, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<float2*>(H), p);
  return static_cast<int>(cudaGetLastError());
}

// x: (S, nb, B) f32; H: (S·nb, 2, F) complex64; frames: (nb, 2, n_fft) f32.
int tt_block_spectra_mix_inverse(const void* x, const void* H, void* frames,
                                 int S, int nb, int B, int n_fft,
                                 int crossfade, void* stream) {
  const int F = n_fft / 2 + 1;
  const int smem = static_cast<int>((n_fft / 2 + n_fft + 2 * F) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      block_spectra_mix_inverse_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_spectra_mix_inverse_kernel<<<nb, 512, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float*>(frames), S, nb, B, n_fft, ilog2(n_fft), crossfade);
  return static_cast<int>(cudaGetLastError());
}

// frames: (nb, 2, n_fft) f32 → out: (2, (nb−1)·B + n_fft) f32.
int tt_overlap_add(const void* frames, void* out, int nb, int B, int n_fft,
                   void* stream) {
  const long long total = 2 * (static_cast<long long>(nb - 1) * B + n_fft);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  overlap_add_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<float*>(out), nb, B, n_fft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
