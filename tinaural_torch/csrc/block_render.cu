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
// All arithmetic is fp32, with the FFTs and the delay ramp of common.cuh.

#include "common.cuh"

namespace {

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

  effective_filter_L(rows, wk, dg, h_table, delays, gains, p, tw, p.n_fft, s1,
                     s2);

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
  const AssemblyParams p =
      assembly_params(taps, t_pad, n_fft, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
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
