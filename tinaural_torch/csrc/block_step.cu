// Hand-written Hopper kernels of the two-launch block render: block
// spectra per (source, block) row, or mixed over sources per output block.
// Their inverse, `spectra_inverse`, is in spectra_inverse.cu.
//
// Replaces, in tinaural/ops/pallas_kernels.py:
//   fused_block_step  (_assembly_mac_s_kernel: forward four-step FFT of the
//                      raw block, filter assembly, crossfaded MAC) — the
//                      assembly stays in assemble_filters
//                      (assemble_filters.cu),
//                      as B1's port split it, and `block_spectra` below
//                      does the rest;
//   fused_block_step_mix  (the same step for every (source, block),
//                      accumulated over sources in the kernel: its grid
//                      revisits each output tile across a sequential source
//                      axis) — `block_spectra_mix` below, then the summing
//                      `spectra_inverse`.
// fused_epilogue, the inverse FFT and OLA that follow both, is
// `spectra_inverse` (spectra_inverse.cu) and then the overlap_add kernel
// of block_render.cu over a leading source axis, which is what its
// `first` masks express.
// The TPU kernels work in the scrambled four-step layout and carry the
// previous filter and the OLA tails across their ordered grid. Here every
// row is independent: spectra are in natural order, H[s,b−1] is read from
// device memory (H[s,−1] := H[s,0], the `first[0] = 1` rule of
// pallas_kernels.py:837, for every source), and the OLA is a gather.
//
//   block_spectra    one block per (source, block) row: rfft_nfft of the
//                    up/down-ramped raw block (both ramps in one complex
//                    FFT), Y = Xu·H[s,b] + Xd·H[s,b−1]; without crossfade
//                    Y = X·H[s,b]. A filter count per source of 1 lets one
//                    filter serve every block (the static render).
//   block_spectra_mix  one block per (source chunk c, output block b): the
//                    forward FFT and MAC of block_spectra for each source of
//                    the chunk in turn, accumulated in shared memory → one
//                    partial spectrum P[c, b]. CUDA blocks run in no order,
//                    so the TPU's sequential source axis becomes a loop
//                    inside the block plus a second pass over the C
//                    partials; no atomics, so two calls give equal bits.
//                    The host picks the chunk so that the grid (C·nb)
//                    covers the card several times over (ops/block_step.py
//                    `mix_chunk`); B1's mix kernel has nb blocks only.
//
// Each row reads B samples and two filters (2·2·F complex64, 32 KB at
// n_fft = 2048) and writes 2·F complex64; the FFT stages and their
// __syncthreads() bound both kernels on the H100 before the bytes do.
// Both run in either buffer mode of common.cuh.

#include "common.cuh"

namespace {

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64 with fnb ∈ {1, nb};
// Y: (S, nb, 2, F) complex64.
template <bool kSplit>
__global__ void block_spectra_kernel(const float* __restrict__ x,
                                     const float2* __restrict__ H,
                                     float2* __restrict__ Y, int S, int nb,
                                     int B, int n_fft, int fnb,
                                     int crossfade, float2* scratch,
                                     int work) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* buf =
      kSplit ? scratch + static_cast<size_t>(blockIdx.x) * n : wbuf;  // n

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  const float inv_B = 1.0f / B;
  for (int r = blockIdx.x; r < S * nb; r = next_row<kSplit>(r, S * nb)) {
    __syncthreads();  // the previous row is done with buf
    const int s = r / nb;
    const int b = r - s * nb;
    const float* xb = x + static_cast<size_t>(r) * B;
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
      buf[fft_pos<kSplit>(f, t)] = z;
    }
    fft_run<kSplit>(f, buf, tw, tw_n, wbuf, false);

    const int bc = fnb == 1 ? 0 : b;
    const float2* Hc = H + (static_cast<size_t>(s) * fnb + bc) * 2 * F;
    // block 0 of every source takes its own filter as "previous"
    const float2* Hp =
        H + (static_cast<size_t>(s) * fnb + (bc > 0 ? bc - 1 : 0)) * 2 * F;
    float2* Y0 = Y + static_cast<size_t>(r) * 2 * F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      if (crossfade) {
        float2 Xu, Xd;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
        Y0[k] = cadd(cmul(Xu, Hc[k]), cmul(Xd, Hp[k]));
        Y0[F + k] = cadd(cmul(Xu, Hc[F + k]), cmul(Xd, Hp[F + k]));
      } else {
        const float2 X = buf[k];
        Y0[k] = cmul(X, Hc[k]);
        Y0[F + k] = cmul(X, Hc[F + k]);
      }
    }
  }
}

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64 with fnb ∈ {1, nb};
// P: (C, nb, 2, F) complex64, C = ⌈S/chunk⌉, P[c, b] = Σ of Y[s, b] over the
// sources c·chunk ≤ s < (c+1)·chunk, added in order of s.
template <bool kSplit>
__global__ void block_spectra_mix_kernel(const float* __restrict__ x,
                                         const float2* __restrict__ H,
                                         float2* __restrict__ P, int S,
                                         int nb, int B, int n_fft, int fnb,
                                         int chunk, int crossfade,
                                         float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* buf = kSplit ? scratch + static_cast<size_t>(blockIdx.x) * (n + 2 * F)
                       : wbuf;   // n
  float2* acc0 = buf + n;        // F
  float2* acc1 = acc0 + F;       // F

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  const float inv_B = 1.0f / B;
  const int rows = (S + chunk - 1) / chunk * nb;
  for (int r = blockIdx.x; r < rows; r = next_row<kSplit>(r, rows)) {
    const int c = r / nb;
    const int b = r - c * nb;
    __syncthreads();  // the previous row is done with buf and acc
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      acc0[k] = make_float2(0.f, 0.f);
      acc1[k] = make_float2(0.f, 0.f);
    }
    const int bc = fnb == 1 ? 0 : b;
    const int s_end = min(S, (c + 1) * chunk);
    for (int s = c * chunk; s < s_end; ++s) {
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
        buf[fft_pos<kSplit>(f, t)] = z;
      }
      fft_run<kSplit>(f, buf, tw, tw_n, wbuf, false);

      const float2* Hc = H + (static_cast<size_t>(s) * fnb + bc) * 2 * F;
      // block 0 of every source takes its own filter as "previous"
      const float2* Hp =
          H + (static_cast<size_t>(s) * fnb + (bc > 0 ? bc - 1 : 0)) * 2 * F;
      for (int k = threadIdx.x; k < F; k += blockDim.x) {
        if (crossfade) {
          float2 Xu, Xd;
          unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
          acc0[k] = cadd(acc0[k], cadd(cmul(Xu, Hc[k]), cmul(Xd, Hp[k])));
          acc1[k] =
              cadd(acc1[k], cadd(cmul(Xu, Hc[F + k]), cmul(Xd, Hp[F + k])));
        } else {
          const float2 X = buf[k];
          acc0[k] = cadd(acc0[k], cmul(X, Hc[k]));
          acc1[k] = cadd(acc1[k], cmul(X, Hc[F + k]));
        }
      }
      __syncthreads();  // buf is rewritten by the next source
    }
    // each thread wrote the bins it reads back: no barrier needed
    float2* P0 = P + static_cast<size_t>(r) * 2 * F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      P0[k] = acc0[k];
      P0[F + k] = acc1[k];
    }
  }
}

}  // namespace

extern "C" {

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64; Y: (S, nb, 2, F)
// complex64. slices > 0: split mode, scratch holds slices · n_fft
// complex64.
int tt_block_spectra(const void* x, const void* H, void* Y, int S, int nb,
                     int B, int n_fft, int fnb, int crossfade, void* scratch,
                     int slices, int work, void* stream) {
  auto kernel =
      slices > 0 ? block_spectra_kernel<true> : block_spectra_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, S * nb, slices, work, n_fft / 2 + n_fft, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float2*>(Y), S, nb, B, n_fft, fnb, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64; P: (⌈S/chunk⌉, nb, 2, F)
// complex64. slices > 0: split mode, scratch holds slices · (n_fft + 2F)
// complex64.
int tt_block_spectra_mix(const void* x, const void* H, void* P, int S,
                         int nb, int B, int n_fft, int fnb, int chunk,
                         int crossfade, void* scratch, int slices, int work,
                         void* stream) {
  const int F = n_fft / 2 + 1;
  auto kernel = slices > 0 ? block_spectra_mix_kernel<true>
                           : block_spectra_mix_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, (S + chunk - 1) / chunk * nb, slices,
                               work, n_fft / 2 + n_fft + 2 * F, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float2*>(P), S, nb, B, n_fft, fnb, chunk, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
