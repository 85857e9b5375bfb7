// Hand-written Hopper kernel `assemble_partitions`: the filter partitions
// of the partitioned overlap-save convolution, H (rows, P, 2, B+1) as re/im
// planes (the layout of StreamState.prev_h): H[r, q] = rfft_2B of the
// B-sample partition q of h_eff[r], zero-padded to 2B, where h_eff[r] =
// truncate_{t_pad}(irfft_L(ramp·gain·rfft_L(gather(idx[r], w[r])))).
//
// Replaces the assembly of tinaural/ops/pallas_kernels.py
// fused_partitioned_assembled (:1710; _asm_filters :1480) and
// fused_stream_step (:2215; _stream_step_asm_kernel :2006). partitioned.cu's
// header says how the partitioned map splits over its three kernels.
//
// With the chain, bound on the H100 by its transforms' latency, not by
// bytes: a row reads 4 table rows (the table stays in L2) and writes its
// planes, P·2·(B+1) complex64 (render (g): 2048 rows × 2048 taps × B 512,
// 84 MB, 0.030 ms at 3.35 TB/s). Four bodies, picked on the host from
// the shapes and the flags (ops/partitions_plan.py, ops/_layout.py), all
// named assemble_partitions_kernel so that a profile names them alike:
//
// The direct body, wherever neither ITD nor ILD applies (apply_itd and
// apply_ild both 0, as for a table kept whole) and B = 64 … 2048, at
// every L. Then the chain is an exact identity: the delay is
// clip(ALIGN_GUARD − ALIGN_GUARD) = 0, whose ramp_bin is twL[0]·(cos 0,
// sin 0) = 1 at every bin, the gain is 1, and L ≥ t_pad, so nothing
// wraps: h_eff is the lerp of the 4 table rows, zero from `taps` on. So
// this body runs no L-point transform, no ramp, no cluster and no shared
// h_eff: its unit of work is one (row r, partition q), the grid covers
// rows × P with u = r·P + q, and a block of S·2B/16 threads runs units
// b·S … b·S + S − 1 (S from the plan: 64 threads a block, or one
// transform's 2B/16 where that is more), so consecutive blocks take
// neighbouring rows, whose table rows (neighbouring head azimuths) stay in
// L2. Small blocks wait on small barriers: in the design sweep at
// room44k.streamed's shape a call took 1.93 ms at 64 threads a block,
// 2.72 ms at 512 (H100, 700 W); the entry point takes at most 256, the
// plan's largest block (one transform at B 2048):
//   prologue   lane `lane` of unit u loads its first pass's 8 samples
//              t = qB + lane + m·2B/16, m < 8, straight from the 4 table
//              rows with __ldg (a row of weight 0 is skipped), lerps them
//              in registers and packs both ears as conj(h0 + i·h1), 0
//              from t = taps on; the padded half (m ≥ 8) is 0;
//   transform  the 2B-point register transform of partition_rounds
//              (RegPlan, the forward one as the conjugate of the inverse)
//              through the slot's own padded exchange buffer, the bins
//              conjugated into it in natural order;
//   store      lane `lane` unpacks the ear pair at bins lane + i·2B/16
//              and 2B − k and writes H's planes coalesced: a block's
//              units are H's rows b·S … b·S + S − 1, contiguous.
// The chain's irfft_L carried L·h_eff, scaled back by 1/L; here nothing
// is scaled. Bound by bytes: the planes it writes (room44k.streamed's call,
// 4,106 rows × 87 partitions × B 512, 2.93 GB of planes, 0.911 ms at 3.35
// TB/s with the table rows and inputs): this body takes 1.95 ms a call
// there, 2.1× that bound and 1.65× the 1.18 ms in which the card fills
// the same planes, where the cluster chain took 15.22 ms (H100, 700 W).
//
// The register body, the shared mode at L = 128 … 8192 and B = 64 … 2048
// where ITD or ILD applies. The radix-2 body took 24× the byte bound at
// (g): one block of 256 threads per row, twiddles rebuilt with sincospif
// in every block, the L-point chain and then the P partitions one after
// another as radix-2 FFTs with a barrier per stage (~74 stages a row at
// (g)). Here, on the register FFT of csrc/fft_reg.cuh (16 points a
// thread, radix-16 passes):
//   rows       G rows per block of T threads, T/G ≥ TL = L/16 of them per
//              row. The rows' L-point chains (gather, rfft_L as the
//              conjugate of the inverse, table ramp and gain, irfft_L:
//              csrc/assembly_stages.cuh, as assemble_filters runs them) run
//              at once, each on the first TL threads of its row's share,
//              in its own padded slice of shared memory. G is the largest
//              power of two up to 512/TL (at most 16) that still gives
//              every SM a block: 1024 rows at L = 256 take G = 4, 2048 rows
//              at L = 4096 G = 2, 64 rows G = 1. T is twice the chains'
//              threads (up to 512, at least 256): all of a row's T/G
//              threads share its ramp pass (nine bins a thread in turn on
//              TL of them) and, where T/G ≥ 2·TL, its gather, each thread
//              loading all four table rows at once into the slice; with
//              few rows, where latency counts, a row's chain so waits on
//              fewer serial steps;
//   hand-off   each chain writes conj(h_eff) of its row, truncated to t_pad
//              and scaled by 1/L, at g·t_pad of shared memory, over the
//              chains' buffers;
//   partitions the block's G·P partitions run as 2B-point register
//              transforms (the forward one as the conjugate of the
//              inverse) on 2B/16 threads each, T/(2B/16) at once: one
//              round where they fit (P = 9 at 2B = 512 on 512 threads),
//              else more (render (g)'s two rows of P = 5 at 2B = 1024: 8 +
//              2 on 512 threads; at 128 registers a thread one such block
//              fills an SM's register file, and one row of five on 320
//              threads per block was slower). Each partition reads its B
//              samples from h_eff into its first pass's registers, runs
//              reg_passes through its own exchange buffer above h_eff,
//              stores its bins conjugated in natural order, and thread
//              `lane` unpacks the ear pair at bins lane + i·2B/16 and
//              2B − k and writes H's planes coalesced: a block's
//              partitions are H's rows r0·P … r0·P + G·P − 1.
// Twiddles come from host-built tables (ops/spectra_inverse.py `twiddles`
// at L and 2B), the ramp's taper from ops/mac_plan.py `ramp_taper`: no
// block computes a twiddle.
//
// The radix-2 body stays for the shared mode's other shapes (B < 64,
// or B > 2048 at L ≤ 8192) and for the split mode: one block of 256
// threads per row (grid-stride over a device scratch when split), the
// effective-filter chain of common.cuh, then the P partitions in turn.
//
// The cluster mode, for
// L = 16384 … 131072 and B = 64 … 2048 where ITD or ILD applies
// (ops/partitions_plan.py), where the
// split mode's radix-2 passes over a device scratch took 4.3 ms for
// render (j)'s 256 rows × 44,100 taps (32× the bound: the 355 MB table
// read once and 91 MB of planes written, 0.134 ms at 3.35 TB/s). One
// thread-block cluster of C = L/16384 blocks of 1024 threads per row; each
// L-point transform runs in four steps (fft_reg.cuh ClusterPlan), crossing
// the cluster once, and every remote access is a store to neighbouring
// addresses of another block's shared memory:
//   gather     rank c's threads load conj(h0 + i·h1) at t = 16384·k1 + k2
//              for their k2-span, straight into registers, coalesced;
//   rfft_L     the conjugate of the inverse: the radix-C step and its
//              twiddle in registers, one DSMEM exchange, each block's
//              16384-point register FFT; rank c holds bins c + C·t2;
//   ramp, gain a DSMEM exchange sends each bin above L/2 to the block that
//              holds its mirror L − q, so every thread unpacks its 8 pairs
//              (q, L − q) below L/2, applies the table-driven ramp
//              (ramp_bin) and the gain once per pair, keeps Z[q] in
//              registers in the inverse's first-pass order and sends
//              Z[L − q] back to its block;
//   irfft_L    the reverse order: each block's 16384-point register
//              inverse of Z[c + C·k2], the twiddle, one DSMEM exchange to
//              the block that owns each t2's span, the C-point DFT, and a
//              last exchange that lands h_eff, truncated to t_pad, scaled
//              by 1/L and conjugated, in the blocks' shared memory:
//              samples c·16384 … of rank c;
//   partitions each block transforms the partitions of its own samples
//              (rfft_2B of B samples zero-padded, as the conjugated
//              register inverse, RegPlan at 2B with 2B/16 threads each),
//              8192/B at a time in two rounds, and writes H's planes
//              coalesced from one more exchange that pairs bins k and
//              2B − k. The first round's exchange buffers overlay the
//              samples it has read, so h_eff and one round's buffers take
//              199,680 B.
// Twiddles and the ramp's taper come from host-built tables
// (ops/spectra_inverse.py `twiddles` at L, 16384 and 2B; ops/mac_plan.py
// `ramp_taper`).

#include "assembly_stages.cuh"

namespace {

// One block per row r (grid-stride when split): H_re/H_im (rows, P, 2,
// B+1).
template <bool kSplit>
__global__ void assemble_partitions_kernel(const int* __restrict__ idx,
                                           const float* __restrict__ w,
                                           const float* __restrict__ h_table,
                                           const float* __restrict__ delays,
                                           const float* __restrict__ gains,
                                           float* __restrict__ H_re,
                                           float* __restrict__ H_im,
                                           AssemblyParams p, int B, int P,
                                           int rows_total, float2* scratch,
                                           int work) {
  extern __shared__ float2 smem[];
  const int n = p.n_fft;  // 2B
  const int tw_n = kSplit ? work : max(p.L, n);
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* s1 = kSplit ? scratch + static_cast<size_t>(blockIdx.x) *
                                      (2 * p.L + n)
                      : wbuf;    // L
  float2* s2 = s1 + p.L;         // L
  float2* buf = s2 + p.L;        // 2B
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];

  const int F2 = B + 1;
  const FftPlan fL = fft_plan(p.L, kSplit ? work : 0);
  const FftPlan fB = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int r = blockIdx.x; r < rows_total;
       r = next_row<kSplit>(r, rows_total)) {
    __syncthreads();
    if (threadIdx.x < 4) {
      rows[threadIdx.x] = idx[4 * r + threadIdx.x];
      wk[threadIdx.x] = w[4 * r + threadIdx.x];
    }
    __syncthreads();

    effective_filter_L<kSplit>(rows, wk, dg, h_table, delays, gains, p, fL,
                               tw, tw_n, wbuf, s1, s2);

    const float inv_L = 1.0f / p.L;
    for (int q = 0; q < P; ++q) {
      // partition q of h_eff (samples qB … qB+B-1 below T_pad), zero-padded
      // to 2B, both ears packed
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int src = q * B + t;
        buf[fft_pos<kSplit>(fB, t)] = (t < B && src < p.t_pad)
                                          ? cscale(s2[src], inv_L)
                                          : make_float2(0.f, 0.f);
      }
      fft_run<kSplit>(fB, buf, tw, tw_n, wbuf, false);
      const size_t o = (static_cast<size_t>(r) * P + q) * 2 * F2;
      for (int k = threadIdx.x; k < F2; k += blockDim.x) {
        float2 A, Bk;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &A, &Bk);
        H_re[o + k] = A.x;
        H_im[o + k] = A.y;
        H_re[o + F2 + k] = Bk.x;
        H_im[o + F2 + k] = Bk.y;
      }
      __syncthreads();  // buf is refilled by the next partition
    }
  }
}

// Inputs of the cluster mode's assemble_partitions.
struct PartitionArgs {
  const int* idx;        // (rows, 4) flat table rows
  const float* w;        // (rows, 4)
  const float* h_table;  // (R, 2, taps)
  const float* delays;   // (R, 2)
  const float* gains;    // (R, 2)
  float* H_re;           // (rows, P, 2, B+1)
  float* H_im;
  const float2* twL;     // exp(+2πi·m/L), m < L
  const float2* twM;     // exp(+2πi·m/16384), m < 16384
  const float2* tw2B;    // exp(+2πi·m/2B), m < 2B
  const float* taper;    // the ramp's taper w at bins 0 … L/2
  AssemblyParams p;
  int P;
};

// complex64 of shared memory per block: h_eff's 16384 samples with one
// round's partition exchange buffers (17408) overlaid from kPartitionKeep
// below sample 8192 on, 199,680 B: with the 1 KB each block reserves, just
// what the SM's 196 KB shared-memory carve-out holds, which leaves the
// twiddle tables 60 KB of L1 instead of 28 KB.
constexpr int kPartitionKeep = 640;
constexpr int kPartitionShared = 8192 - kPartitionKeep +
                                 (1 << kRegMaxLog2N) +
                                 (1 << kRegMaxLog2N) / 16;

// The partition FFTs of this block's samples of h_eff (its shared memory,
// local sample l at l xor 8192), 8192/B at a time: thread tid is lane
// tid mod Tp of slot tid / Tp. r: the row, rank: the block's rank.
template <int kLog2B2>
__device__ __forceinline__ void partition_rounds(const PartitionArgs& a,
                                                 float2* smem, int r, int rank,
                                                 int tid) {
  using PB = RegPlan<kLog2B2>;
  constexpr int n2 = PB::n, B = n2 / 2, Tp = PB::threads, F2 = B + 1;
  constexpr int kHalf = (1 << kRegMaxLog2N) / 2;  // 8192
  static_assert(PB::points == 16 && PB::passes > 1 && Tp <= kClusterThreads,
                "a partition takes 2B/16 threads of 16 points");
  float2 v[16];
  constexpr int RB = PB::radix(PB::passes - 1), NsB = n2 / RB;
  const int lane = tid % Tp;
  const int slot = tid / Tp;
  float2 keep = make_float2(0.f, 0.f);
  for (int round = 0; round < 2; ++round) {
    const int q0 = (rank * 2 * kHalf + round * kHalf) / B;
    if (q0 >= a.P) break;  // the same for the whole block
    if (round == 1) {  // round 0's buffers are read; restore what they hid
      __syncthreads();
      if (tid < kPartitionKeep) smem[kHalf - kPartitionKeep + tid] = keep;
      __syncthreads();
    }
    // the round's samples; once they are read, its exchange buffers from
    // there on, round 0's from kPartitionKeep below, over the last samples
    // of round 1, which threads tid < kPartitionKeep hold meanwhile
    const float2* in = smem + (1 - round) * kHalf;
    float2* region = round ? smem : smem + kHalf - kPartitionKeep;
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = m < 8 ? in[slot * B + lane + m * Tp] : make_float2(0.f, 0.f);
    if (round == 0 && tid < kPartitionKeep)
      keep = smem[kHalf - kPartitionKeep + tid];
    dft<16>(v);
    __syncthreads();  // every sample of the round is read
    float2* buf = region + slot * PB::row_f2;
    reg_passes<kLog2B2, 1>(v, buf, lane, a.tw2B);
    __syncthreads();  // the last pass has read buf
#pragma unroll
    for (int s = 0; s < 16 / RB; ++s)
#pragma unroll
      for (int i = 0; i < RB; ++i)
        buf[lane + s * Tp + i * NsB] = conj(v[s * RB + i]);
    __syncthreads();
    const int q = q0 + slot;
    if (q < a.P) {
      const size_t o = (static_cast<size_t>(r) * a.P + q) * 2 * F2;
      auto bin = [&](int k) {
        float2 A, Bk;
        unpack_pair(buf[k], buf[(n2 - k) & (n2 - 1)], &A, &Bk);
        a.H_re[o + k] = A.x;
        a.H_im[o + k] = A.y;
        a.H_re[o + F2 + k] = Bk.x;
        a.H_im[o + F2 + k] = Bk.y;
      };
#pragma unroll
      for (int i = 0; i < 8; ++i) bin(lane + i * Tp);
      if (lane == 0) bin(B);
    }
  }
}

// The cluster mode: one cluster of PL::ranks blocks per row; see the
// header comment. It shares the other modes' name, so a profile names
// them alike.
template <class PL, int kLog2B2>
__global__ void __launch_bounds__(kClusterThreads, 1)
    assemble_partitions_kernel(const PartitionArgs a) {
  constexpr int L = PL::n, C = PL::ranks, M = PL::M, span = PL::span;
  constexpr int kHalf = M / 2;  // 8192
  extern __shared__ float2 smem[];
  const AssemblyParams& p = a.p;
  const int rank = static_cast<int>(blockIdx.x) % C;
  const int r = static_cast<int>(blockIdx.x) / C;
  const int tid = threadIdx.x;
  cluster_arrive<C>();  // this block runs: the others may store into it

  // h_eff·L in registers: sample M·(m % C) + rank·span + tid + (m/C)·1024
  // in v[m], with an arrive outstanding (assembly_stages.cuh)
  float2 v[16];
  cluster_filter<PL>(v, smem, a, r, rank, tid);

  // conj(h_eff) truncated to t_pad and scaled by 1/L: sample M·t1 + t2 at
  // rank t1, local t2 xor 8192, unpadded
  const float inv_L = 1.0f / L;
  cluster_wait<C>();
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t1 = m % C;
    const int t2 = rank * span + tid + (m / C) * kClusterThreads;
    const float2 h = M * t1 + t2 < p.t_pad ? conj(cscale(v[m], inv_L))
                                           : make_float2(0.f, 0.f);
    st_rank<C>(smem, t1, rank, t2 ^ kHalf, h);
  }
  cluster_arrive<C>();
  cluster_wait<C>();  // h_eff is whole; nothing below leaves this block

  partition_rounds<kLog2B2>(a, smem, r, rank, tid);
}

constexpr int kPartMinLog2B2 = 7;   // 2B = 128: B = 64
constexpr int kPartMaxLog2B2 = 12;  // 2B = 4096: B = 2048

template <int kLog2L, int kLog2B2>
int launch_partitions_block(int log2B2, const PartitionArgs& a, int rows,
                            cudaStream_t stream) {
  if constexpr (kLog2B2 > kPartMaxLog2B2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2B2 != kLog2B2)
      return launch_partitions_block<kLog2L, kLog2B2 + 1>(log2B2, a, rows,
                                                          stream);
    using PL = ClusterPlan<kLog2L>;
    const auto kernel = static_cast<void (*)(const PartitionArgs)>(
        assemble_partitions_kernel<PL, kLog2B2>);
    return launch_cluster(kernel, rows,
                          PL::ranks,
                          kPartitionShared * static_cast<int>(sizeof(float2)),
                          stream, a);
  }
}

// The cluster kernel for L = 2^log2L, checked against the caller's plan.
template <int kLog2L>
int launch_partitions_cluster(int log2L, int log2B2, int ranks,
                              const PartitionArgs& a, int rows,
                              cudaStream_t stream) {
  if constexpr (kLog2L > kClusterMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2L != kLog2L)
      return launch_partitions_cluster<kLog2L + 1>(log2L, log2B2, ranks, a,
                                                   rows, stream);
    if (ranks != ClusterPlan<kLog2L>::ranks || a.twL == nullptr ||
        a.twM == nullptr || a.tw2B == nullptr || a.taper == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_partitions_block<kLog2L, kPartMinLog2B2>(log2B2, a, rows,
                                                           stream);
  }
}

// ------------------------------------------------------------------------
// The shared mode's register body, L = 128 … 8192 and 2B = 128 … 4096: G
// rows per block of T threads (ops/partitions_plan.py `PartitionsPlan`
// computes G, T and the shared figure the same way).

constexpr int kRegMinLog2L = 7;      // L ≥ next_pow2(1 + DELAY_PAD) = 128
constexpr int kRegMaxLog2L = 13;     // 8192, the last L below the cluster mode
constexpr int kRegMaxThreads = 512;  // per block: up to 128 registers a thread
constexpr int kRegMaxRows = 16;
constexpr int kRegMinThreads = 256;  // per block: the ramp and the gather of
                                     // a few rows spread over them

// The most rows per block at L = 2^log2L: G groups of L/16 threads fit
// kRegMaxThreads.
__host__ __device__ constexpr int partition_max_rows(int log2L) {
  return (kRegMaxThreads >> (log2L - 4)) < kRegMaxRows
             ? kRegMaxThreads >> (log2L - 4)
             : kRegMaxRows;
}

// Threads of a block of G rows of P partitions: twice the G chains' L/16
// each, up to kRegMaxThreads, so that each row's gather and ramp spread
// over twice its chain's threads; or for the partitions 2B/16 each, as
// many at once as the G·P take up to kRegMaxThreads, so one round takes
// all of them where they fit; at least kRegMinThreads. All are powers of
// two or multiples of 2B/16, so T is a multiple of G and of 2B/16.
__host__ __device__ constexpr int partition_block_threads(int log2L,
                                                          int log2B2, int G,
                                                          int P) {
  const int chains = G << (log2L - 3);
  const int Tp = 1 << (log2B2 - 4);
  const int slots = G * P < kRegMaxThreads / Tp ? G * P : kRegMaxThreads / Tp;
  const int wide = chains < kRegMaxThreads ? chains : kRegMaxThreads;
  const int T = wide > slots * Tp ? wide : slots * Tp;
  return T > kRegMinThreads ? T : kRegMinThreads;
}

// complex64 of shared memory: the G chains' exchange buffers, and over them
// once the chains are done, h_eff of the G rows (t_pad samples each) below
// the partition rounds' exchange buffers, one per slot.
__host__ __device__ constexpr int partition_shared_f2(int log2L, int log2B2,
                                                      int G, int threads,
                                                      int t_pad) {
  const int chains = G * ((1 << log2L) + (1 << (log2L - 4)));
  const int rounds = G * t_pad + (threads >> (log2B2 - 4)) *
                                     ((1 << log2B2) + (1 << (log2B2 - 4)));
  return chains > rounds ? chains : rounds;
}

// The register body: see the header comment. Block b takes rows
// b·G … b·G + G − 1.
template <int kLog2L, int kLog2B2>
__global__ void __launch_bounds__(kRegMaxThreads, 1)
    assemble_partitions_kernel(const PartitionArgs a, int rows, int G) {
  using PL = RegPlan<kLog2L>;
  using PB = RegPlan<kLog2B2>;
  constexpr int L = PL::n, TL = PL::threads;
  constexpr int n2 = PB::n, B = n2 / 2, Tp = PB::threads, F2 = B + 1;
  constexpr int RL = PL::radix(PL::passes - 1), NsL = L / RL;
  constexpr int RB = PB::radix(PB::passes - 1), NsB = n2 / RB;
  static_assert(PL::passes > 1 && PB::passes > 1 && PL::points == 16 &&
                    PB::points == 16 && TL <= kRegMaxThreads &&
                    Tp <= kRegMaxThreads,
                "register plans of 16 points a thread that fit the block");
  extern __shared__ float2 smem[];
  const AssemblyParams& p = a.p;
  const int tid = threadIdx.x;
  const int GT = static_cast<int>(blockDim.x) / G;  // threads per row, ≥ TL
  const int grp = tid / GT;
  const int gl = tid % GT;
  const int r0 = blockIdx.x * G;
  const int r = r0 + grp;
  const bool row = grp < G && r < rows;  // the group's row exists
  const bool live = row && gl < TL;      // and this thread runs its chain

  // the G rows' L-point chains, group grp in its own slice of smem
  float2 v[16];
  float d[2], g[2];
  float2* slice = smem + grp * PL::row_f2;
  row_delays_gains(a.idx, a.w, a.delays, a.gains, p, row ? r : r0, d, g);
  if (GT >= 2 * TL) {  // the same for the whole block
    // the group's GT threads gather conj(h0 + i·h1) at t = gl + i·GT
    // into slice, all four table rows' loads at once
    if (row) {
      int rk[4];
      float wk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rk[k] = __ldg(a.idx + 4 * r + k);
        wk[k] = __ldg(a.w + 4 * r + k);
      }
#pragma unroll 1
      for (int t = gl; t < L; t += GT) {
        float2 z = make_float2(0.f, 0.f);
        if (t < p.taps) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float* hr = a.h_table + static_cast<size_t>(rk[k]) * 2 *
                                              p.taps + t;
            z.x += wk[k] * __ldg(hr);
            z.y += wk[k] * __ldg(hr + p.taps);
          }
        }
        slice[t] = conj(z);
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = slice[gl + m * TL];
      dft<16>(v);
    }
    __syncthreads();  // slice becomes the first pass's exchange buffer
  } else if (live) {
    gather_conj<TL>(v, a.idx, a.w, a.h_table, p.taps, r, gl);
  }
  assemble_L<kLog2L>(v, slice, gl, live, d, g, a.twL, a.taper, GT, row);
  __syncthreads();  // irfft_L's last pass has read the group slices
  // conj(h_eff) of row grp, truncated to t_pad and scaled by 1/L, at
  // smem[grp·t_pad + t]: the last pass's sub-DFT j = gl + s·TL holds
  // t = j + q·NsL
  if (live) {
    const float inv_L = 1.0f / L;
#pragma unroll
    for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        const int t = gl + s * TL + q * NsL;
        if (t < p.t_pad)
          smem[grp * p.t_pad + t] = conj(cscale(v[s * RL + q], inv_L));
      }
  }
  __syncthreads();

  // the G·P partitions, k = g·P + q, T/Tp at a time: thread tid is lane
  // tid mod Tp of slot tid / Tp, with its exchange buffer above h_eff
  const int lane = tid % Tp;
  const int slot = tid / Tp;
  const int slots = static_cast<int>(blockDim.x) / Tp;
  const int parts = G * a.P;
  float2* buf = smem + G * p.t_pad + slot * PB::row_f2;
#pragma unroll 1
  for (int k0 = 0; k0 < parts; k0 += slots) {
    const int k = k0 + slot;
    const int gk = k / a.P;
    const bool on = k < parts && r0 + gk < rows;
    if (on) {  // B samples of h_eff from q·B, zero-padded to 2B
      const float2* h = smem + gk * p.t_pad;
      const int t0 = (k - gk * a.P) * B + lane;
#pragma unroll
      for (int m = 0; m < 16; ++m)
        v[m] = m < 8 && t0 + m * Tp < p.t_pad ? h[t0 + m * Tp]
                                              : make_float2(0.f, 0.f);
      dft<16>(v);
    }
    if (k0 > 0) __syncthreads();  // the last round's bins are read
    reg_passes_live<kLog2B2, 1>(v, buf, lane, a.tw2B, on);
    __syncthreads();  // the last pass has read buf
    if (on) {
#pragma unroll
      for (int s = 0; s < 16 / RB; ++s)
#pragma unroll
        for (int i = 0; i < RB; ++i)
          buf[lane + s * Tp + i * NsB] = conj(v[s * RB + i]);
    }
    __syncthreads();
    if (on) {  // row r0 + gk's partition q is H's row r0·P + k
      const size_t o = (static_cast<size_t>(r0) * a.P + k) * 2 * F2;
      auto bin = [&](int kb) {
        float2 A, Bk;
        unpack_pair(buf[kb], buf[(n2 - kb) & (n2 - 1)], &A, &Bk);
        a.H_re[o + kb] = A.x;
        a.H_im[o + kb] = A.y;
        a.H_re[o + F2 + kb] = Bk.x;
        a.H_im[o + F2 + kb] = Bk.y;
      };
#pragma unroll
      for (int i = 0; i < 8; ++i) bin(lane + i * Tp);
      if (lane == 0) bin(B);
    }
  }
}

template <int kLog2L, int kLog2B2>
int launch_partitions_register(int log2L, int log2B2, int threads, int G,
                               const PartitionArgs& a, int rows,
                               cudaStream_t stream) {
  if constexpr (kLog2B2 > kPartMaxLog2B2) {
    return launch_partitions_register<kLog2L + 1, kPartMinLog2B2>(
        log2L, log2B2, threads, G, a, rows, stream);
  } else if constexpr (kLog2L > kRegMaxLog2L) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2L != kLog2L || log2B2 != kLog2B2)
      return launch_partitions_register<kLog2L, kLog2B2 + 1>(
          log2L, log2B2, threads, G, a, rows, stream);
    const auto kernel = static_cast<void (*)(const PartitionArgs, int, int)>(
        assemble_partitions_kernel<kLog2L, kLog2B2>);
    const int smem = partition_shared_f2(kLog2L, kLog2B2, G, threads,
                                         a.p.t_pad) *
                     static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(rows + G - 1) / G, threads, smem, stream>>>(a, rows, G);
    return static_cast<int>(cudaGetLastError());
  }
}

// ------------------------------------------------------------------------
// The direct body, neither ITD nor ILD and 2B = 128 … 4096 at every L: S
// units (row, partition) per block of S·2B/16 threads, S from
// ops/partitions_plan.py `direct_slots` (a power of two, checked here).

// per block: the plan's largest, one transform of 2B = 4096 on 256 threads;
// 4 such blocks an SM cap a thread at 64 registers
constexpr int kDirectMaxThreads = 1 << (kPartMaxLog2B2 - 4);

// The direct body: see the header comment. Thread tid is lane tid mod Tp
// of slot tid / Tp, which transforms unit u = blockIdx.x·S + slot of the
// rows × P, row u / P, partition u mod P.
template <int kLog2B2>
__global__ void __launch_bounds__(kDirectMaxThreads, 4)
    assemble_partitions_kernel(const PartitionArgs a, int units) {
  using PB = RegPlan<kLog2B2>;
  constexpr int n2 = PB::n, B = n2 / 2, Tp = PB::threads, F2 = B + 1;
  constexpr int RB = PB::radix(PB::passes - 1), NsB = n2 / RB;
  static_assert(PB::points == 16 && PB::passes > 1 &&
                    Tp <= kDirectMaxThreads,
                "a partition takes 2B/16 threads of 16 points");
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int lane = tid % Tp;
  const int slot = tid / Tp;
  const int u = static_cast<int>(blockIdx.x) * (blockDim.x / Tp) + slot;
  const bool on = u < units;  // the same for the slot's threads
  float2 v[16];
  if (on) {
    // the lerp of the 4 table rows at t = qB + lane + m·Tp, m < 8, both
    // ears, each row's 16 loads at once; a row of weight 0 adds 0 and is
    // not read (two of the four on a one-ring grid, three in the nearest
    // lookup)
    const int r = u / a.P;
    const int t0 = (u - r * a.P) * B + lane;
    const int taps = a.p.taps;
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float wk = __ldg(a.w + 4 * r + k);
      if (wk == 0.f) continue;
      const float* row =
          a.h_table + static_cast<size_t>(__ldg(a.idx + 4 * r + k)) * 2 * taps;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int t = t0 + m * Tp;
        if (t < taps) {
          v[m].x += wk * __ldg(row + t);
          v[m].y += wk * __ldg(row + taps + t);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = conj(v[m]);
    dft<16>(v);
  }
  float2* buf = smem + slot * PB::row_f2;
  reg_passes_live<kLog2B2, 1>(v, buf, lane, a.tw2B, on);
  __syncthreads();  // the last pass has read buf
  if (on) {
#pragma unroll
    for (int s = 0; s < 16 / RB; ++s)
#pragma unroll
      for (int i = 0; i < RB; ++i)
        buf[lane + s * Tp + i * NsB] = conj(v[s * RB + i]);
  }
  __syncthreads();
  if (on) {  // unit u is H's row u of the rows × P
    const size_t o = static_cast<size_t>(u) * 2 * F2;
    auto bin = [&](int k) {
      float2 A, Bk;
      unpack_pair(buf[k], buf[(n2 - k) & (n2 - 1)], &A, &Bk);
      a.H_re[o + k] = A.x;
      a.H_im[o + k] = A.y;
      a.H_re[o + F2 + k] = Bk.x;
      a.H_im[o + F2 + k] = Bk.y;
    };
#pragma unroll
    for (int i = 0; i < 8; ++i) bin(lane + i * Tp);
    if (lane == 0) bin(B);
  }
}

template <int kLog2B2>
int launch_partitions_direct(int log2B2, int slots, const PartitionArgs& a,
                             int units, cudaStream_t stream) {
  if constexpr (kLog2B2 > kPartMaxLog2B2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2B2 != kLog2B2)
      return launch_partitions_direct<kLog2B2 + 1>(log2B2, slots, a, units,
                                                   stream);
    using PB = RegPlan<kLog2B2>;
    if (slots < 1 || (slots & (slots - 1)) ||
        slots * PB::threads > kDirectMaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = static_cast<void (*)(const PartitionArgs, int)>(
        assemble_partitions_kernel<kLog2B2>);
    const int smem = slots * PB::row_f2 * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(units + slots - 1) / slots, slots * PB::threads, smem,
             stream>>>(a, units);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H_re, H_im: (rows, P, 2, B+1) f32. slices > 0: split mode,
// scratch holds slices · (2L + 2B) complex64, and the tables, ranks,
// threads and per_block are unused. Otherwise, with direct (the plan's
// body, ops/partitions_plan.py; only where apply_itd and apply_ild are
// both 0 and B = 64 … 2048), the direct body at every L: tw2B the table
// of exp(+2πi·m/2B), ranks 0, per_block its units a block (a power of
// two) and threads per_block·2B/16. Else the shared mode (L ≤
// 8192; ranks 0) or the cluster mode (L ≥ 16384): twL, twM and tw2B the
// tables of exp(+2πi·m/L), exp(+2πi·m/16384) (cluster mode only) and
// exp(+2πi·m/2B), taper the ramp's taper at bins 0 … L/2, and ranks,
// threads and per_block the plan's (ops/partitions_plan.py): the shared
// mode's register body at B = 64 … 2048 takes its rows per block as
// per_block > 0 and its threads, its radix-2 body at other blocks takes 0
// for both.
int tt_assemble_partitions(const void* idx, const void* w, const void* h_table,
                           const void* delays, const void* gains, void* H_re,
                           void* H_im, const void* twL, const void* twM,
                           const void* tw2B, const void* taper, int rows,
                           int taps, int t_pad, int B, int P, int apply_itd,
                           int apply_ild, int direct, int ranks,
                           int threads, int per_block, float align_guard,
                           float max_shift, float taper_lo, float taper_hi,
                           void* scratch, int slices, int work, void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, 2 * B, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  const auto s = static_cast<cudaStream_t>(stream);
  const PartitionArgs a{static_cast<const int*>(idx),
                        static_cast<const float*>(w),
                        static_cast<const float*>(h_table),
                        static_cast<const float*>(delays),
                        static_cast<const float*>(gains),
                        static_cast<float*>(H_re),
                        static_cast<float*>(H_im),
                        static_cast<const float2*>(twL),
                        static_cast<const float2*>(twM),
                        static_cast<const float2*>(tw2B),
                        static_cast<const float*>(taper),
                        p,
                        P};
  const int log2B2 = ilog2(2 * B);
  const bool blocks = log2B2 >= kPartMinLog2B2 && log2B2 <= kPartMaxLog2B2;
  if (direct) {
    const long long units = static_cast<long long>(rows) * P;
    if (slices != 0 || !blocks || apply_itd || apply_ild || ranks != 0 ||
        P < 1 || units > (1LL << 31) - 1 || a.tw2B == nullptr ||
        threads != per_block * (1 << (log2B2 - 4)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_partitions_direct<kPartMinLog2B2>(
        log2B2, per_block, a, static_cast<int>(units), s);
  }
  if (slices == 0 && p.L > (1 << kRegMaxLog2L))
    return launch_partitions_cluster<kRegMaxLog2N>(p.log2L, log2B2, ranks, a,
                                                   rows, s);
  const bool reg = p.log2L >= kRegMinLog2L && blocks;
  if (slices == 0 && (ranks != 0 || (per_block > 0) != reg))
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 0 && reg) {
    const int G = per_block;
    if (G > partition_max_rows(p.log2L) || (G & (G - 1)) || P < 1 ||
        threads != partition_block_threads(p.log2L, log2B2, G, P) ||
        a.twL == nullptr || a.tw2B == nullptr || a.taper == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_partitions_register<kRegMinLog2L, kPartMinLog2B2>(
        p.log2L, log2B2, threads, G, a, rows, s);
  }
  const int tw_n = p.L > 2 * B ? p.L : 2 * B;
  using SplitKernel = void (*)(const int*, const float*, const float*,
                               const float*, const float*, float*, float*,
                               AssemblyParams, int, int, int, float2*, int);
  const SplitKernel kernel =
      slices > 0 ? static_cast<SplitKernel>(assemble_partitions_kernel<true>)
                 : static_cast<SplitKernel>(assemble_partitions_kernel<false>);
  Launch l;
  const int err = launch_shape(kernel, rows, slices, work,
                               tw_n / 2 + 2 * p.L + 2 * B, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<float*>(H_re),
      static_cast<float*>(H_im), p, B, P, rows, static_cast<float2*>(scratch),
      work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
