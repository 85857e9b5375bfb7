// Hand-written Hopper kernel `assemble_filters`: the filter spectra of the
// block render, H (rows, 2, n_fft/2 + 1) complex64, one row per (source,
// block): H[r] = rfft_n(truncate to t_pad(irfft_L(ramp·gain·rfft_L(
// gather(idx[r], w[r]))))).
//
// Replaces the assembly half of tinaural/ops/pallas_kernels.py
// fused_block_render (:1089; _vmem_gather and _block_spectra_core with
// _ramp_cos_sin), and of fused_block_step (:814) and fused_block_step_mix
// (:910), which share it. block_render.cu's header says how the block
// render's map is split over its three kernels.
//
// Bound on the H100 by its transforms' latency, not by bytes: a row reads
// 4 table rows (~1 MB table, L2-resident) and writes 2·F complex64, 16 KB
// at n_fft 2048, so 8192 rows take 0.040 ms at 3.35 TB/s; their FFTs
// 0.013 ms at 67 TFLOP/s fp32. The radix-2 body this replaces (three
// shared-memory FFTs with a barrier per stage, twiddles rebuilt with
// sincospif in every block, five transcendentals per bin and ear) took
// 13× the byte bound. This design, in the shared buffer mode (n_fft ≤
// 16384), is assembly_mac's chain without its MAC (ops/render_plan.py
// `filters_plan` is its launch):
//   threads      T = n/16 per block, 16 points each in registers
//                (csrc/fft_reg.cuh);
//   rows         G = min(n/L, 16) rows per block. Their L-point chains
//                (gather, rfft_L, ramp and gain, irfft_L: the stages of
//                assembly_mac_kernel, below as device functions) run at
//                once on G groups of TL = L/16 threads, group g in the
//                g-th slice of L + L/16 complex64 of the exchange buffer,
//                so every thread works where one row per block left
//                T − TL threads at the barriers (at 128 taps, L = 256,
//                n = 2048: 16 of 128). assembly_mac.cu keeps its own copy
//                of the stages: built on these functions, 29 of its 36
//                instances changed their spills (<9,9>: from none to
//                232/352 B of stores/loads);
//   hand-off     each group writes its row's h_eff, truncated to t_pad and
//                scaled by 1/L, at g·L of the buffer; every thread then
//                holds conj(h_eff_g[lane + m·T]) for m < 16/G (the rest of
//                rfft_n's first-pass input is zero: t ≥ L) of all G rows in
//                registers, which frees the buffer for the n-point phase;
//   rfft_n       the G rows one after the other on the whole block, the
//                forward transform as the conjugate of the register
//                inverse, then one exchange: thread `lane` unpacks H0, H1
//                from bins k = lane + i·T (i < 8; lane 0 also n/2) and
//                n − k and writes them coalesced.
// Twiddles come from tables built once per (device, size) on the host
// (ops/spectra_inverse.py `twiddles`), the ramp's taper from
// ops/mac_plan.py `ramp_taper`: no block computes a twiddle.
//
// The split buffer mode (n_fft above 16384, or forced) keeps the radix-2
// body: the effective-filter chain of common.cuh and fft_run over the
// block's device scratch slice, 256 threads, the blocks walking the rows.
// It shares the register kernel's name, so a profile names both alike.

#include "fft_reg.cuh"

namespace {

// The clipped delays d and gains g of both ears of row r, as
// effective_filter_L (common.cuh) computes them.
__device__ __forceinline__ void row_delays_gains(
    const int* idx, const float* w, const float* delays, const float* gains,
    const AssemblyParams& p, int r, float (&d)[2], float (&g)[2]) {
  int rows[4];
  float wk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rows[k] = __ldg(idx + 4 * r + k);
    wk[k] = __ldg(w + 4 * r + k);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float dv = p.align_guard, gv = 1.f;
    if (p.apply_itd) {
      dv = 0.f;
      for (int k = 0; k < 4; ++k) dv += wk[k] * __ldg(delays + 2 * rows[k] + e);
    }
    if (p.apply_ild) {
      gv = 0.f;
      for (int k = 0; k < 4; ++k) gv += wk[k] * __ldg(gains + 2 * rows[k] + e);
    }
    d[e] = fminf(fmaxf(dv - p.align_guard, -p.align_guard), p.max_shift);
    g[e] = gv;
  }
}

// Gather: conj(h0 + i·h1) of row r at t = lane + m·TL, the first pass's
// input of an L-point transform on TL = L/16 threads, then that pass. One
// table row at a time, so 32 loads are in flight, not 128 (the row and
// weight are read again: rows[k] and wk[k] at a run-time k would go to
// local memory).
template <int TL>
__device__ __forceinline__ void gather_conj(float2 (&v)[16], const int* idx,
                                            const float* w,
                                            const float* h_table, int taps,
                                            int r, int lane) {
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const float wkk = __ldg(w + 4 * r + k);
    const float* row =
        h_table + static_cast<size_t>(__ldg(idx + 4 * r + k)) * 2 * taps;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = lane + m * TL;
      if (t < taps) {
        v[m].x += wkk * __ldg(row + t);
        v[m].y += wkk * __ldg(row + taps + t);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = conj(v[m]);
  dft<16>(v);
}

// rfft_L → ramp and gain → irfft_L of one row on the TL = L/16 threads
// with `live` true, through the row's exchange buffer buf (RegPlan<log2
// L>::row_f2 complex64). On entry v holds gather_conj's output and buf is
// free (the caller's barrier); on return v holds irfft_L's last pass:
// L·h_eff at t = j + q·L/R for sub-DFT j = lane + s·TL, slot s·R + q (R
// the last radix). The ramp pass runs bins q = lane, lane + TL, … ≤ L/2
// on the live threads, each reading bins q and L − q, unpacking both ears,
// applying the ramp and the gain and packing Z[q] and Z[L − q] in place,
// each bin once. Every thread of the block calls this and keeps to its
// barriers.
template <int kLog2L>
__device__ __forceinline__ void assemble_L(float2 (&v)[16], float2* buf,
                                           int lane, bool live,
                                           const float (&d)[2],
                                           const float (&g)[2],
                                           const float2* twL,
                                           const float* taper) {
  using PL = RegPlan<kLog2L>;
  constexpr int L = PL::n, TL = PL::threads;
  constexpr int RL = PL::radix(PL::passes - 1), NsL = L / RL;
  // rfft_L
  reg_passes_live<kLog2L, 1>(v, buf, lane, twL, live);
  __syncthreads();  // the last pass has read buf
  if (live) {
#pragma unroll
    for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
      for (int q = 0; q < RL; ++q)
        buf[lane + s * TL + q * NsL] = conj(v[s * RL + q]);
  }
  __syncthreads();
  // unpack, ramp, gain and pack in place; DC and Nyquist lose their
  // imaginary parts
#pragma unroll 1
  for (int q = live ? lane : L; q <= L / 2; q += TL) {
    const int qm = (L - q) & (L - 1);
    float2 G0, G1;
    unpack_pair(buf[q], buf[qm], &G0, &G1);
    G0 = cscale(cmul(G0, ramp_bin(q, L, d[0], twL, taper)), g[0]);
    G1 = cscale(cmul(G1, ramp_bin(q, L, d[1], twL, taper)), g[1]);
    if (q == 0 || q == L / 2) {
      G0.y = 0.f;
      G1.y = 0.f;
    }
    buf[q] = make_float2(G0.x - G1.y, G0.y + G1.x);
    if (qm != q) buf[qm] = make_float2(G0.x + G1.y, G1.x - G0.y);
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = buf[lane + m * TL];
    dft<16>(v);
  }
  // irfft_L
  __syncthreads();  // the exchange has been read
  reg_passes_live<kLog2L, 1>(v, buf, lane, twL, live);
}

constexpr int kFiltersMinLog2 = 7;  // L ≥ next_pow2(1 + DELAY_PAD) = 128
constexpr int kFiltersMaxRows = 16;

// Blocks per SM that __launch_bounds__ asks for with T threads: 256
// threads' worth, at most 32 blocks, so up to 255 registers a thread
// below 512 threads (178 at n_fft 2048, where 128 spilled the held
// inputs: 212 B; 2–10% faster, scripts/torch_block_render_sweep.py), 128
// at 512 and 64 at 1024. ops/render_plan.py `min_blocks` computes the
// same.
__host__ __device__ constexpr int filters_min_blocks(int threads) {
  return threads >= 256 ? 1 : (256 / threads > 32 ? 32 : 256 / threads);
}

// Rows per block: ops/render_plan.py `filters_plan` computes the same.
__host__ __device__ constexpr int filters_rows(int log2n, int log2L) {
  return (1 << (log2n - log2L)) < kFiltersMaxRows ? 1 << (log2n - log2L)
                                                  : kFiltersMaxRows;
}

struct FilterArgs {
  const int* idx;        // (rows, 4) flat table rows
  const float* w;        // (rows, 4)
  const float* h_table;  // (R, 2, taps)
  const float* delays;   // (R, 2)
  const float* gains;    // (R, 2)
  float2* H;             // (rows, 2, F)
  const float2* twL;     // exp(+2πi·m/L), m < L
  const float2* twN;     // exp(+2πi·m/n), m < n
  const float* taper;    // the ramp's taper w at bins 0 … L/2
  AssemblyParams p;
  int rows;
};

// The shared buffer mode: G rows per block of T = n/16 threads; see the
// header comment. buf is one n-point exchange buffer (n + n/16 complex64).
template <int kLog2N, int kLog2L>
__global__ void __launch_bounds__(RegPlan<kLog2N>::threads,
                                  filters_min_blocks(RegPlan<kLog2N>::threads))
    assemble_filters_kernel(const FilterArgs a) {
  using PN = RegPlan<kLog2N>;
  using PL = RegPlan<kLog2L>;
  constexpr int n = PN::n, L = PL::n, T = PN::threads, TL = PL::threads;
  constexpr int F = n / 2 + 1;
  constexpr int G = filters_rows(kLog2N, kLog2L);
  constexpr int M = 16 / G;  // rfft_n inputs of a row a thread holds
  constexpr int RL = PL::radix(PL::passes - 1), NsL = L / RL;
  constexpr int RN = PN::radix(PN::passes - 1), NsN = n / RN;
  static_assert(PN::passes > 1 && PL::passes > 1 && PN::points == 16 &&
                    PL::points == 16 && G * TL <= T &&
                    G * PL::row_f2 <= PN::row_f2,
                "G groups of the L-point plan fit the block and its buffer");
  extern __shared__ float2 buf[];
  const AssemblyParams& p = a.p;
  const int grp = threadIdx.x / TL;
  const int gl = threadIdx.x % TL;
  const int r0 = blockIdx.x * G;
  const int r = r0 + grp;
  const bool live = grp < G && r < a.rows;

  // the G rows' L-point chains, group grp in its own slice of buf
  float2 v[16];
  float d[2], g[2];
  row_delays_gains(a.idx, a.w, a.delays, a.gains, p, live ? r : r0, d, g);
  if (live) gather_conj<TL>(v, a.idx, a.w, a.h_table, p.taps, r, gl);
  assemble_L<kLog2L>(v, buf + grp * PL::row_f2, gl, live, d, g, a.twL,
                     a.taper);
  __syncthreads();  // irfft_L's last pass has read the group slices
  // h_eff of row grp, truncated and scaled, at buf[grp·L + t]: the last
  // pass's sub-DFT j = gl + s·TL holds t = j + q·NsL
  if (live) {
    const float inv_L = 1.0f / L;
#pragma unroll
    for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        const int t = gl + s * TL + q * NsL;
        if (t < p.t_pad) buf[grp * L + t] = cscale(v[s * RL + q], inv_L);
      }
  }
  __syncthreads();
  // rfft_n's first-pass inputs t = lane + m·T < L of every row, conjugated
  const int lane = threadIdx.x;
  float2 hold[16];
#pragma unroll
  for (int k = 0; k < G; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int t = lane + m * T;
      hold[k * M + m] =
          t < p.t_pad ? conj(buf[k * L + t]) : make_float2(0.f, 0.f);
    }

  // rfft_n of each row in turn, on the whole block
#pragma unroll 1
  for (int k = 0; k < G; ++k) {
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = m < M ? hold[m] : make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m + M < 16; ++m) hold[m] = hold[m + M];
    dft<16>(v);
    __syncthreads();  // the hold loads, or the last row's bins, read buf
    reg_passes<kLog2N, 1>(v, buf, lane, a.twN);
    __syncthreads();  // the last pass has read buf
#pragma unroll
    for (int s = 0; s < 16 / RN; ++s)
#pragma unroll
      for (int q = 0; q < RN; ++q)
        buf[lane + s * T + q * NsN] = conj(v[s * RN + q]);
    __syncthreads();
    if (r0 + k < a.rows) {
      float2* H0 = a.H + static_cast<size_t>(r0 + k) * 2 * F;
#pragma unroll
      for (int i = 0; i <= 8; ++i) {
        if (i < 8 || lane == 0) {  // bin n/2 on lane 0
          const int kb = i < 8 ? lane + i * T : n / 2;
          float2 A, B;
          unpack_pair(buf[kb], buf[(n - kb) & (n - 1)], &A, &B);
          H0[kb] = A;
          H0[F + kb] = B;
        }
      }
    }
  }
}

// The split buffer mode: the radix-2 body over the block's device scratch
// slice (n_fft + 2L complex64), the blocks walking the rows.
__global__ void assemble_filters_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ h_table,
                                        const float* __restrict__ delays,
                                        const float* __restrict__ gains,
                                        float2* __restrict__ H,
                                        AssemblyParams p, int rows_total,
                                        float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int tw_n = work;
  float2* tw = smem;                 // tw_n / 2
  float2* wbuf = tw + tw_n / 2;      // work
  float2* big = scratch + static_cast<size_t>(blockIdx.x) *
                              (p.n_fft + 2 * p.L);  // n_fft
  float2* s1 = big + p.n_fft;        // L
  float2* s2 = s1 + p.L;             // L
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];  // d0, d1, g0, g1

  const int F = p.n_fft / 2 + 1;
  const FftPlan fL = fft_plan(p.L, work);
  const FftPlan fN = fft_plan(p.n_fft, work);
  make_twiddles(tw, tw_n);
  for (int r = blockIdx.x; r < rows_total; r = next_row<true>(r, rows_total)) {
    __syncthreads();  // the previous row is done with rows, wk, dg, buffers
    if (threadIdx.x < 4) {
      rows[threadIdx.x] = idx[4 * r + threadIdx.x];
      wk[threadIdx.x] = w[4 * r + threadIdx.x];
    }
    __syncthreads();

    effective_filter_L<true>(rows, wk, dg, h_table, delays, gains, p, fL, tw,
                             tw_n, wbuf, s1, s2);

    // h_eff truncated to T_pad, packed, zero-padded to n_fft
    const float inv_L = 1.0f / p.L;
    for (int t = threadIdx.x; t < p.n_fft; t += blockDim.x) {
      big[fft_pos<true>(fN, t)] =
          t < p.t_pad ? cscale(s2[t], inv_L) : make_float2(0.f, 0.f);
    }
    fft_run<true>(fN, big, tw, tw_n, wbuf, false);

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

using SplitKernel = void (*)(const int*, const float*, const float*,
                             const float*, const float*, float2*,
                             AssemblyParams, int, float2*, int);

// The register kernel for L = 2^kLog2L ≤ n = 2^kLog2N.
template <int kLog2N, int kLog2L>
int launch_filters(int log2L, const FilterArgs& a, cudaStream_t stream) {
  if constexpr (kLog2L > kLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2L != kLog2L)
      return launch_filters<kLog2N, kLog2L + 1>(log2L, a, stream);
    constexpr int G = filters_rows(kLog2N, kLog2L);
    const auto kernel = assemble_filters_kernel<kLog2N, kLog2L>;
    const int smem = RegPlan<kLog2N>::row_f2 * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(a.rows + G - 1) / G, RegPlan<kLog2N>::threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// The register kernel for n = 2^kLog2N, checked against the caller's plan.
template <int kLog2N>
int launch_register(int log2n, int log2L, int threads, int rows_per_block,
                    int blocks_per_sm, const FilterArgs& a,
                    cudaStream_t stream) {
  if constexpr (kLog2N > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_register<kLog2N + 1>(log2n, log2L, threads, rows_per_block,
                                         blocks_per_sm, a, stream);
    using P = RegPlan<kLog2N>;
    if (threads != P::threads || log2L > kLog2N ||
        rows_per_block != filters_rows(kLog2N, log2L) ||
        blocks_per_sm != filters_min_blocks(P::threads) || a.twL == nullptr ||
        a.twN == nullptr || a.taper == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_filters<kLog2N, kFiltersMinLog2>(log2L, a, stream);
  }
}

}  // namespace

extern "C" {

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H: (rows, 2, n_fft/2+1) complex64. slices > 0: split mode,
// scratch holds slices · (n_fft + 2L) complex64, and twL, twN, taper,
// threads, rows_per_block and blocks_per_sm are unused. Otherwise the
// register kernel (n_fft ≤ 16384): twL and twN the tables of exp(+2πi·m/L)
// and exp(+2πi·m/n), taper the ramp's taper at bins 0 … L/2, and threads,
// rows_per_block and blocks_per_sm must be the plan's
// (ops/render_plan.py `filters_plan`).
int tt_assemble_filters(const void* idx, const void* w, const void* h_table,
                        const void* delays, const void* gains, void* H,
                        const void* twL, const void* twN, const void* taper,
                        int rows, int taps, int t_pad, int n_fft,
                        int apply_itd, int apply_ild, int threads,
                        int rows_per_block, int blocks_per_sm,
                        float align_guard, float max_shift, float taper_lo,
                        float taper_hi, void* scratch, int slices, int work,
                        void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, n_fft, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  const auto s = static_cast<cudaStream_t>(stream);
  if (slices == 0) {
    const FilterArgs a{static_cast<const int*>(idx),
                       static_cast<const float*>(w),
                       static_cast<const float*>(h_table),
                       static_cast<const float*>(delays),
                       static_cast<const float*>(gains),
                       static_cast<float2*>(H),
                       static_cast<const float2*>(twL),
                       static_cast<const float2*>(twN),
                       static_cast<const float*>(taper),
                       p,
                       rows};
    return launch_register<kFiltersMinLog2>(p.log2n, p.log2L, threads,
                                            rows_per_block, blocks_per_sm, a,
                                            s);
  }
  const SplitKernel kernel = assemble_filters_kernel;
  Launch l;
  const int err = launch_shape(kernel, rows, slices, work,
                               n_fft / 2 + n_fft + 2 * p.L, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<float2*>(H), p, rows,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
