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
//   overlap_add                out[s,e,t] = Σ_j frames[s, b-j, e, t-(b-j)·B],
//                              per source s: no overlap crosses a source.
//                              With S = 1 it ends this render; with S
//                              sources it is the OLA half of
//                              fused_epilogue (csrc/block_step.cu).
//
// All arithmetic is fp32, with the FFTs and the delay ramp of common.cuh.
// The first two kernels run in either buffer mode of common.cuh.

#include "common.cuh"

namespace {

// One block per (source, block) row r (grid-stride when split). Bound on
// the H100 by its three FFTs and their __syncthreads() stages (the table
// rows are ~1 MB, L2-resident); both ears ride one complex FFT at every
// stage.
template <bool kSplit>
__global__ void assemble_filters_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ h_table,
                                        const float* __restrict__ delays,
                                        const float* __restrict__ gains,
                                        float2* __restrict__ H,
                                        AssemblyParams p, int rows_total,
                                        float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int tw_n = kSplit ? work : p.n_fft;
  float2* tw = smem;                 // tw_n / 2
  float2* wbuf = tw + tw_n / 2;      // split: work
  float2* big = kSplit ? scratch + static_cast<size_t>(blockIdx.x) *
                                       (p.n_fft + 2 * p.L)
                       : wbuf;       // n_fft
  float2* s1 = big + p.n_fft;        // L
  float2* s2 = s1 + p.L;             // L
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];  // d0, d1, g0, g1

  const int F = p.n_fft / 2 + 1;
  const FftPlan fL = fft_plan(p.L, kSplit ? work : 0);
  const FftPlan fN = fft_plan(p.n_fft, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int r = blockIdx.x; r < rows_total;
       r = next_row<kSplit>(r, rows_total)) {
    __syncthreads();  // the previous row is done with rows, wk, dg, buffers
    if (threadIdx.x < 4) {
      rows[threadIdx.x] = idx[4 * r + threadIdx.x];
      wk[threadIdx.x] = w[4 * r + threadIdx.x];
    }
    __syncthreads();

    effective_filter_L<kSplit>(rows, wk, dg, h_table, delays, gains, p, fL,
                               tw, tw_n, wbuf, s1, s2);

    // h_eff truncated to T_pad, packed, zero-padded to n_fft
    const float inv_L = 1.0f / p.L;
    for (int t = threadIdx.x; t < p.n_fft; t += blockDim.x) {
      big[fft_pos<kSplit>(fN, t)] =
          t < p.t_pad ? cscale(s2[t], inv_L) : make_float2(0.f, 0.f);
    }
    fft_run<kSplit>(fN, big, tw, tw_n, wbuf, false);

    float2* H0 = H + static_cast<size_t>(r) * 2 * F;
    float2* H1 = H0 + F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      float2 A, B;
      unpack_pair(big[k], big[(p.n_fft - k) & (p.n_fft - 1)], &A, &B);
      H0[k] = A;
      H1[k] = B;
    }
  }
}

// One block per output block b (grid-stride when split), looping over the
// S sources. Bound on the H100 by the FFTs (one forward per source, one
// inverse per block) and by streaming H[s,b], H[s,b-1] from device memory
// (32 KB per source and block); at S = 64, nb = 128 the grid is only 128
// blocks.
template <bool kSplit>
__global__ void block_spectra_mix_inverse_kernel(const float* __restrict__ x,
                                                 const float2* __restrict__ H,
                                                 float* __restrict__ frames,
                                                 int S, int nb, int B,
                                                 int n_fft, int crossfade,
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
  for (int b = blockIdx.x; b < nb; b = next_row<kSplit>(b, nb)) {
    __syncthreads();  // the previous block is done with buf
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      acc0[k] = make_float2(0.f, 0.f);
      acc1[k] = make_float2(0.f, 0.f);
    }
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
        buf[fft_pos<kSplit>(f, t)] = z;
      }
      fft_run<kSplit>(f, buf, tw, tw_n, wbuf, false);

      const float2* Hc = H + (static_cast<size_t>(s) * nb + b) * 2 * F;
      // block 0 of every source takes its own filter as "previous"
      const float2* Hp =
          H + (static_cast<size_t>(s) * nb + (b > 0 ? b - 1 : 0)) * 2 * F;
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

    float* f0 = frames + static_cast<size_t>(b) * 2 * n;
    inverse_pair<kSplit>(acc0, acc1, buf, f, tw, tw_n, wbuf, f0, f0 + n);
  }
}

// One thread per output sample t (grid x) of each source and ear (grid y,
// looping past 65535): a pure strided reduction over the k = n_fft/B
// frames of its source that overlap it, bound by device-memory bandwidth.
__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   float* __restrict__ out, int S, int nb,
                                   int B, int n_fft) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_len) return;
  const int q = static_cast<int>(t / B);
  const int k = n_fft / B;
  for (int se = blockIdx.y; se < 2 * S; se += gridDim.y) {  // s·2 + e
    const float* fs =
        frames + (static_cast<size_t>(se >> 1) * nb * 2 + (se & 1)) * n_fft;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int bb = q - j;
      if (bb >= 0 && bb < nb)
        acc += fs[static_cast<size_t>(bb) * 2 * n_fft +
                  (t - static_cast<long long>(bb) * B)];
    }
    out[static_cast<size_t>(se) * out_len + t] = acc;
  }
}

}  // namespace

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The opt-in shared memory one block may use on `device`, in bytes.
int tt_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H: (rows, 2, n_fft/2+1) complex64. slices > 0: split mode,
// scratch holds slices · (n_fft + 2L) complex64.
int tt_assemble_filters(const void* idx, const void* w, const void* h_table,
                        const void* delays, const void* gains, void* H,
                        int rows, int taps, int t_pad, int n_fft,
                        int apply_itd, int apply_ild, float align_guard,
                        float max_shift, float taper_lo, float taper_hi,
                        void* scratch, int slices, int work, void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, n_fft, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  auto kernel = slices > 0 ? assemble_filters_kernel<true>
                           : assemble_filters_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, rows, slices, work,
                               n_fft / 2 + n_fft + 2 * p.L, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<float2*>(H), p, rows,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// x: (S, nb, B) f32; H: (S·nb, 2, F) complex64; frames: (nb, 2, n_fft) f32.
// slices > 0: split mode, scratch holds slices · (n_fft + 2F) complex64.
int tt_block_spectra_mix_inverse(const void* x, const void* H, void* frames,
                                 int S, int nb, int B, int n_fft,
                                 int crossfade, void* scratch, int slices,
                                 int work, void* stream) {
  const int F = n_fft / 2 + 1;
  auto kernel = slices > 0 ? block_spectra_mix_inverse_kernel<true>
                           : block_spectra_mix_inverse_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, nb, slices, work,
                               n_fft / 2 + n_fft + 2 * F, &l);
  if (err) return err;
  kernel<<<l.grid, 512, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float*>(frames), S, nb, B, n_fft, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// frames: (S, nb, 2, n_fft) f32 → out: (S, 2, (nb−1)·B + n_fft) f32.
int tt_overlap_add(const void* frames, void* out, int S, int nb, int B,
                   int n_fft, void* stream) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((out_len + threads - 1) / threads),
                  static_cast<unsigned>(2 * S < 65535 ? 2 * S : 65535));
  overlap_add_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<float*>(out), S, nb, B,
      n_fft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
