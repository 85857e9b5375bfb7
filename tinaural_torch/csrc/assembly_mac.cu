// Hand-written Hopper kernel of the natural-order assembly + MAC: each
// row's filter is assembled and used in the MAC inside one CUDA block, so
// the filter spectra never reach device memory.
//
// Replaces tinaural/ops/pallas_kernels.py:fused_assembly_mac (kernel body
// _assembly_mac_kernel): assembly of each row's filter from its gathered
// shape, delay and gain, then Y = Xu·H[r] + Xd·H_prev[r] on the given input
// spectra, with H_prev = H[r−1], or H[r] at a `first` row; without crossfade
// Y = Xu·H[r]. The TPU kernel assembles by matmuls against resident
// constants and carries the last filter of each grid step to the next in
// VMEM, leaning on its ordered grid. CUDA blocks run in no order, so:
//
//   assembly_mac  one block per run of `run` consecutive rows (grid-stride
//                 over runs in the split mode). The block assembles the
//                 run's predecessor first, unless the run starts at a
//                 `first` row, then for each row assembles H with the
//                 effective-filter chain of common.cuh and rfft_nfft, does
//                 the MAC, and keeps H as the next row's previous filter.
//                 `first` rows may fall anywhere inside a run; row 0 always
//                 counts as one (pallas_kernels.py:374 forces it, since the
//                 TPU's carry is uninitialised there). The host picks the
//                 run from the rows and the SM count (ops/assembly_mac.py
//                 `run_length`): a run of c rows assembles c + 1 filters.
//
// Bound on the H100 by its FFTs (rfft_L, irfft_L and rfft_nfft per row,
// and their __syncthreads() stages), not by bytes: a row reads two input
// spectra and writes two output spectra (4·F complex64), where the
// two-launch route also writes H (2·F) and reads it twice. In the shared
// mode H and H_prev (4·F complex64, 64 KB at n_fft 4096) stay in shared
// memory beside the FFT buffers; above 227 KB (n_fft 32768: H and H_prev
// alone are 512 KB) they live in the block's device scratch slice.

#include "common.cuh"

namespace {

// idx, w: (rows, 4); Xu, Xd: (rows, F) complex64; first: (rows,) f32;
// Y: (rows, 2, F) complex64. 1024 threads: at n_fft 4096 the block's
// 120–180 KB of shared memory leave it alone on its SM, so its own warps
// must hide the latency of the FFT stages (the fastest of 256, 512 and
// 1024 threads on the H100 at n_fft 4096 and 32768).
template <bool kSplit>
__global__ void __launch_bounds__(1024) assembly_mac_kernel(
    const int* __restrict__ idx, const float* __restrict__ w,
    const float* __restrict__ h_table, const float* __restrict__ delays,
    const float* __restrict__ gains, const float2* __restrict__ Xu,
    const float2* __restrict__ Xd, const float* __restrict__ first,
    float2* __restrict__ Y, AssemblyParams p, int rows_total, int run,
    int crossfade, float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int n = p.n_fft;
  const int F = n / 2 + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* big = kSplit ? scratch + static_cast<size_t>(blockIdx.x) *
                                       (n + 2 * p.L + 4 * F)
                       : wbuf;   // n_fft
  float2* s1 = big + n;          // L
  float2* s2 = s1 + p.L;         // L
  float2* Hc = s2 + p.L;         // 2F: this row's filter, both ears
  float2* Hp = Hc + 2 * F;       // 2F: the previous row's
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];  // d0, d1, g0, g1

  const FftPlan fL = fft_plan(p.L, kSplit ? work : 0);
  const FftPlan fN = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  const float inv_L = 1.0f / p.L;
  const int runs = (rows_total + run - 1) / run;
  for (int q = blockIdx.x; q < runs; q = next_row<kSplit>(q, runs)) {
    const int r0 = q * run;
    const int r1 = min(rows_total, r0 + run);
    // the run's predecessor, unless the run starts a track
    const bool prev = crossfade && r0 > 0 && first[r0] < 0.5f;
    for (int r = prev ? r0 - 1 : r0; r < r1; ++r) {
      __syncthreads();  // the previous row is done with rows, wk, buffers
      if (threadIdx.x < 4) {
        rows[threadIdx.x] = idx[4 * r + threadIdx.x];
        wk[threadIdx.x] = w[4 * r + threadIdx.x];
      }
      __syncthreads();

      effective_filter_L<kSplit>(rows, wk, dg, h_table, delays, gains, p, fL,
                                 tw, tw_n, wbuf, s1, s2);
      // h_eff truncated to T_pad, packed, zero-padded to n_fft
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        big[fft_pos<kSplit>(fN, t)] =
            t < p.t_pad ? cscale(s2[t], inv_L) : make_float2(0.f, 0.f);
      }
      fft_run<kSplit>(fN, big, tw, tw_n, wbuf, false);

      // H into Hc, and the MAC; each thread reads back only the bins of Hp
      // it wrote itself for the row before
      const bool mac = r >= r0;
      const bool own = r == 0 || first[r] > 0.5f;
      const float2* xu = Xu + static_cast<size_t>(r) * F;
      const float2* xd = Xd + static_cast<size_t>(r) * F;
      float2* Y0 = Y + static_cast<size_t>(r) * 2 * F;
      for (int k = threadIdx.x; k < F; k += blockDim.x) {
        float2 A, B;
        unpack_pair(big[k], big[(n - k) & (n - 1)], &A, &B);
        Hc[k] = A;
        Hc[F + k] = B;
        if (!mac) continue;
        const float2 u = xu[k];
        float2 y0 = cmul(u, A), y1 = cmul(u, B);
        if (crossfade) {
          const float2 d = xd[k];
          y0 = cadd(y0, cmul(d, own ? A : Hp[k]));
          y1 = cadd(y1, cmul(d, own ? B : Hp[F + k]));
        }
        Y0[k] = y0;
        Y0[F + k] = y1;
      }
      float2* t = Hc;  // this row's filter is the next row's previous
      Hc = Hp;
      Hp = t;
    }
  }
}

}  // namespace

extern "C" {

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; Xu, Xd: (rows, F) complex64; first: (rows,) f32; Y: (rows, 2,
// F) complex64. slices > 0: split mode, scratch holds slices ·
// (n_fft + 2L + 4F) complex64.
int tt_assembly_mac(const void* idx, const void* w, const void* h_table,
                    const void* delays, const void* gains, const void* Xu,
                    const void* Xd, const void* first, void* Y, int rows,
                    int run, int taps, int t_pad, int n_fft, int crossfade,
                    int apply_itd, int apply_ild, float align_guard,
                    float max_shift, float taper_lo, float taper_hi,
                    void* scratch, int slices, int work, void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, n_fft, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  const int F = n_fft / 2 + 1;
  auto kernel =
      slices > 0 ? assembly_mac_kernel<true> : assembly_mac_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, (rows + run - 1) / run, slices, work,
                   n_fft / 2 + n_fft + 2 * p.L + 4 * F, &l);
  if (err) return err;
  kernel<<<l.grid, 1024, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<const float2*>(Xu),
      static_cast<const float2*>(Xd), static_cast<const float*>(first),
      static_cast<float2*>(Y), p, rows, run, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
