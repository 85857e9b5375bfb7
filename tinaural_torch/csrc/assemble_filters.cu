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
//                assembly_mac_kernel, as the device functions of
//                csrc/assembly_stages.cuh) run at once on G groups of
//                TL = L/16 threads, group g in the g-th slice of
//                L + L/16 complex64 of the exchange buffer, so every
//                thread works where one row per block left T − TL threads
//                at the barriers (at 128 taps, L = 256, n = 2048: 16 of
//                128). assembly_mac.cu keeps its own copy of the stages:
//                built on these functions, 29 of its 36 instances changed
//                their spills (<9,9>: from none to 232/352 B of
//                stores/loads);
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
// The cluster buffer mode (n_fft = L 32768 … 131072; ops/render_plan.py
// `filters_plan`, ops/_layout.py): a row's filter pair is 2·F complex64,
// 262 KB at 32768, more than one block's shared memory, and the split
// mode's radix-2 body took 0.86 ms of device time at render (j)'s 128 rows
// × 16,384 taps on an H100, 50× its byte bound. Here one thread-block
// cluster of C = n/16384 blocks (ranks) of 1024 threads takes a run of
// rows (fft_reg.cuh ClusterPlan), each row as assembly_mac's cluster
// kernel builds it without the MAC (assembly_stages.cuh cluster_spectrum):
//   chain      cluster_filter: the gather straight into registers, rfft_L,
//              the ramp exchange of bins q and L − q across ranks, the
//              table-driven ramp and gain, irfft_L;
//   rfft_n     h_eff truncated to t_pad, scaled by 1/L and conjugated in
//              registers, then one cluster transform: the radix-C step,
//              one DSMEM exchange, each rank's 16384-point register FFT;
//   pairs      one exchange brings Z[q] and Z[n − q] of rank c's bins
//              q = c·8192 … c·8192 + 8191 (the last rank also n/2) side
//              by side; thread tid unpacks H0, H1 at q = c·8192 + tid +
//              1024·i (i < 8) and writes both ears of H coalesced.
// Runs of rows come from the clusters the card places at once
// (cudaOccupancyMaxActiveClusters, tt_assemble_filters_clusters), as
// assembly_mac's do: at (j)'s 128 rows, 66 clusters of 2 give runs of 2.
// Twiddles come from host tables at n, L = n and 16384, the taper at L.
//
// The split buffer mode (n_fft above 131072, L < n_fft above 16384 — as at
// block 1024 and 15,298 … 16,320 taps, n_fft 32768 with L 16384 —, or
// forced) keeps the radix-2 body: the effective-filter chain of common.cuh
// and fft_run over the block's device scratch slice, 256 threads, the
// blocks walking the rows. Both other modes share the register kernel's
// name, so a profile names all three alike.

#include "assembly_stages.cuh"

namespace {

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
  const float2* twM;     // exp(+2πi·m/16384), m < 16384 (cluster mode)
  const float* taper;    // the ramp's taper w at bins 0 … L/2
  AssemblyParams p;
  int rows;
  int run;  // rows per cluster (cluster mode)
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
                     a.taper, TL, live);
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

// complex64 of shared memory per rank of the cluster mode: the cluster
// chain's share, which the pair exchange reuses. ops/render_plan.py
// `filters_plan` computes the same.
constexpr int kFiltersClusterShared = ClusterPlan<kRegMaxLog2N + 1>::share_f2;

// The cluster mode: one cluster of PN::ranks blocks per run of rows; see
// the header comment. L == n.
template <class PN>
__global__ void __launch_bounds__(kClusterThreads, 1)
    assemble_filters_kernel(const FilterArgs a) {
  constexpr int n = PN::n, C = PN::ranks;
  constexpr int F = n / 2 + 1;
  extern __shared__ __align__(16) float2 share[];
  const int r0 = static_cast<int>(blockIdx.x) / C * a.run;
  const int r1 = min(a.rows, r0 + a.run);
  cluster_arrive<C>();  // this block runs: the others may store into it

  for (int r = r0; r < r1; ++r) {
    const int rank = fresh_rank();  // blockIdx.x % C
    const int tid = fresh_tid();
    // H[r]'s pairs in share (assembly_stages.cuh cluster_spectrum)
    cluster_spectrum<PN>(share, a, r, rank, tid);
    // unpack both ears at this thread's bins and write them coalesced
    float2* H0 = a.H + static_cast<size_t>(r) * 2 * F;
    auto bin = [&](int pair) {
      const int q = rank * kClusterPairs + pair;
      const float4 z = reinterpret_cast<const float4*>(share)[pair];
      float2 A, B;
      unpack_pair(make_float2(z.x, z.y), make_float2(z.z, z.w), &A, &B);
      H0[q] = A;
      H0[F + q] = B;
    };
#pragma unroll 1
    for (int i = 0; i < 8; ++i) bin(tid + i * kClusterThreads);
    if (rank == C - 1 && tid == 0) bin(kClusterPairs);  // n/2
    cluster_arrive<C>();  // the pairs are read
  }
  cluster_wait<C>();
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

// The cluster kernel for n = 2^kLog2N.
template <int kLog2N>
auto filters_cluster_kernel() {
  return static_cast<void (*)(const FilterArgs)>(
      assemble_filters_kernel<ClusterPlan<kLog2N>>);
}

// The cluster kernel for n = 2^log2n with L == n, checked against the
// caller's plan.
template <int kLog2N>
int launch_filters_cluster(int log2n, int log2L, int ranks, int threads,
                           int rows_per_block, int blocks_per_sm,
                           const FilterArgs& a, cudaStream_t stream) {
  if constexpr (kLog2N > kClusterMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_filters_cluster<kLog2N + 1>(log2n, log2L, ranks, threads,
                                                rows_per_block, blocks_per_sm,
                                                a, stream);
    using PN = ClusterPlan<kLog2N>;
    if (log2L != kLog2N || ranks != PN::ranks || threads != kClusterThreads ||
        rows_per_block != 1 || blocks_per_sm != 1 || a.run < 1 ||
        a.twL == nullptr || a.twN == nullptr || a.twM == nullptr ||
        a.taper == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(
        filters_cluster_kernel<kLog2N>(), (a.rows + a.run - 1) / a.run,
        PN::ranks, kFiltersClusterShared * static_cast<int>(sizeof(float2)),
        stream, a);
  }
}

// The clusters of the cluster kernel at n = 2^log2n that the current
// device runs at once.
template <int kLog2N>
int filters_cluster_slots(int log2n) {
  if constexpr (kLog2N > kClusterMaxLog2N) {
    return -static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N) return filters_cluster_slots<kLog2N + 1>(log2n);
    return cluster_slots(
        filters_cluster_kernel<kLog2N>(), ClusterPlan<kLog2N>::ranks,
        kFiltersClusterShared * static_cast<int>(sizeof(float2)));
  }
}

}  // namespace

extern "C" {

// The clusters of assemble_filters' cluster mode at n_fft (32768 …
// 131072) that the current device runs at once, read once per device and
// kept: the host's runs (ops/block_render.py). ≥ 0, or a CUDA error
// negated.
int tt_assemble_filters_clusters(int n_fft) {
  return filters_cluster_slots<kRegMaxLog2N + 1>(ilog2(n_fft));
}

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H: (rows, 2, n_fft/2+1) complex64. slices > 0: split mode,
// scratch holds slices · (n_fft + 2L) complex64, and twL, twN, twM, taper,
// run, ranks, threads, rows_per_block and blocks_per_sm are unused.
// Otherwise the register kernel (n_fft ≤ 16384, ranks 0) or the cluster
// kernel (n_fft 32768 … 131072 with L == n_fft, ranks n_fft/16384, each
// cluster a run of `run` rows): twL and twN the tables of exp(+2πi·m/L)
// and exp(+2πi·m/n), twM (cluster only) that of exp(+2πi·m/16384), taper
// the ramp's taper at bins 0 … L/2, and ranks, threads, rows_per_block
// and blocks_per_sm must be the plan's (ops/render_plan.py
// `filters_plan`).
int tt_assemble_filters(const void* idx, const void* w, const void* h_table,
                        const void* delays, const void* gains, void* H,
                        const void* twL, const void* twN, const void* twM,
                        const void* taper, int rows, int run, int taps,
                        int t_pad, int n_fft, int apply_itd, int apply_ild,
                        int ranks, int threads, int rows_per_block,
                        int blocks_per_sm, float align_guard, float max_shift,
                        float taper_lo, float taper_hi, void* scratch,
                        int slices, int work, void* stream) {
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
                       static_cast<const float2*>(twM),
                       static_cast<const float*>(taper),
                       p,
                       rows,
                       run};
    if (p.log2n > kRegMaxLog2N)
      return launch_filters_cluster<kRegMaxLog2N + 1>(
          p.log2n, p.log2L, ranks, threads, rows_per_block, blocks_per_sm, a,
          s);
    if (ranks != 0) return static_cast<int>(cudaErrorInvalidValue);
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
