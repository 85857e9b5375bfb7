// Hand-written Hopper kernels of the two-launch block render: block
// spectra per (source, block) row, then their inverse, with no mixdown.
//
// Replaces, in tinaural/ops/pallas_kernels.py:
//   fused_block_step  (_assembly_mac_s_kernel: forward four-step FFT of the
//                      raw block, filter assembly, crossfaded MAC) — the
//                      assembly stays in assemble_filters (block_render.cu),
//                      as B1's port split it, and `block_spectra` below
//                      does the rest;
//   fused_epilogue    (_epilogue_kernel → _inverse_ola_core: inverse
//                      four-step FFT of both ears, OLA under the `first`
//                      masks) — `spectra_inverse` below, then the
//                      overlap_add kernel of block_render.cu over a leading
//                      source axis, which is what the masks express.
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
//   spectra_inverse  one block per row: one packed inverse FFT of both
//                    ears → frames (rows, 2, n_fft).
//
// Each row reads B samples and two filters (2·2·F complex64, 32 KB at
// n_fft = 2048) and writes 2·F complex64 or 2·n_fft floats; the FFT stages
// and their __syncthreads() bound both kernels on the H100 before the
// bytes do. Both run in either buffer mode of common.cuh.

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

// Y: (rows, 2, F) complex64 → frames: (rows, 2, n_fft) f32.
template <bool kSplit>
__global__ void spectra_inverse_kernel(const float2* __restrict__ Y,
                                       float* __restrict__ frames, int rows,
                                       int n_fft, float2* scratch, int work) {
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
  for (int r = blockIdx.x; r < rows; r = next_row<kSplit>(r, rows)) {
    __syncthreads();  // the previous row is done with buf
    const float2* Yr = Y + static_cast<size_t>(r) * 2 * F;
    float* fr = frames + static_cast<size_t>(r) * 2 * n;
    inverse_pair<kSplit>(Yr, Yr + F, buf, f, tw, tw_n, wbuf, fr, fr + n);
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

// Y: (rows, 2, F) complex64 → frames: (rows, 2, n_fft) f32. slices > 0:
// split mode, scratch holds slices · n_fft complex64.
int tt_spectra_inverse(const void* Y, void* frames, int rows, int n_fft,
                       void* scratch, int slices, int work, void* stream) {
  auto kernel = slices > 0 ? spectra_inverse_kernel<true>
                           : spectra_inverse_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, rows, slices, work, n_fft / 2 + n_fft, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(Y), static_cast<float*>(frames), rows,
      n_fft, static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
