// Hand-written Hopper kernels of uniformly partitioned overlap-save
// convolution: the streaming step, its hold step, and the batched offline
// render of the same map.
//
// Replaces, in tinaural/ops/pallas_kernels.py:
//   fused_stream_step            (_stream_step_kernel, _stream_step_asm_kernel
//                                 → _stream_conv_core)
//   fused_stream_hold            (_stream_hold_kernel → _stream_conv_core)
//   fused_partitioned_step       (_partitioned_kernel → _partitioned_conv_core)
//   fused_partitioned_assembled  (_partitioned_asm_kernel: _asm_filters →
//                                 _partitioned_conv_core)
// The TPU kernels compute the partition spectra with zoom matmuls or a
// four-step FFT in a scrambled lane layout, and the offline one carries the
// frame, delay line and previous filter across its ordered grid. Here every
// transform is a radix-2 FFT in shared memory over natural-order bins, and
// the map splits into three kernels that need no carry between CUDA blocks:
//
//   assemble_partitions  one block per row (a stream, or a block of the
//                        offline render): the shared effective-filter chain
//                        (gather, rfft_L, ramp·gain, irfft_L), truncation to
//                        T_pad, then P packed-ear rfft_2B of the B-sample
//                        partitions → H (rows, P, 2, B+1) as re/im planes,
//                        the layout of StreamState.prev_h.
//   stream_conv          one block per stream: rfft_2B of [prev_in | xb],
//                        the delay line shifted into NEW planes, the MAC
//                        over P under H (and under the previous filter when
//                        crossfading), one packed inverse FFT per filter,
//                        the last B samples, the blend w = (i + 0.5)/B. The
//                        hold step is the same kernel without crossfade.
//   partitioned_conv     one block per output block b of the offline render:
//                        the P frame spectra X[b-p] recomputed from the input
//                        (two frames per complex FFT), the MAC under H[b]
//                        and H[b-1] (H[-1] := H[0]), tails and blend.
//
// Bound on the H100 by the shared-memory FFT stages and their
// __syncthreads(); device-memory traffic per row is the partition planes
// (P·2·(B+1) complex values, ~37 KB at P = 9, B = 256) and stays far below
// the card's bandwidth at serving batch sizes. Every kernel runs in either
// buffer mode of common.cuh, so a filter of any length (L = 65536 at
// 44,100 taps) and any stream block take the same kernels.
//
// assemble_partitions has a third buffer mode, the cluster mode, for
// L = 16384 … 131072 and B = 64 … 2048 (ops/partitions_plan.py), where the
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

#include "fft_reg.cuh"

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

  // gather: conj(h0 + i·h1) at t = M·k1 + k2, k2 = rank·span + tid +
  // s·1024, into v[s·C + k1]; one table row at a time, half the slots at a
  // time, so 16 loads are in flight
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = make_float2(0.f, 0.f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float wkk = __ldg(a.w + 4 * r + k);
      const float* row = a.h_table + static_cast<size_t>(__ldg(
                                         a.idx + 4 * r + k)) * 2 * p.taps;
#pragma unroll
      for (int m = 8 * h; m < 8 * h + 8; ++m) {
        const int t = M * (m % C) + rank * span + tid +
                      (m / C) * kClusterThreads;
        if (t < p.taps) {
          v[m].x += wkk * __ldg(row + t);
          v[m].y += wkk * __ldg(row + p.taps + t);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = conj(v[m]);

  // rfft_L as the conjugate of the inverse, in four steps: rank c ends
  // with conj(S[q]) for its bins q = c + C·t2, t2 = tid + 1024·local_out(m)
  cluster_spread<PL>(v, smem, rank, tid, a.twL);
  cluster_local_fft(v, smem, tid, a.twM);

  // The ramp pairs bin q with L − q, which lies at rank (C − c) mod C,
  // index t2' = M − 1 − t2 (c > 0) or (M − t2) mod M (c = 0). A thread's
  // bins q < L/2 are those of local_out(m) < 8 (lo), the rest hi; a hi
  // bin's mirror is a lo bin. Each hi S[q] goes to the slot t2' of its
  // mirror's rank; every thread then ramps its lo pairs and sends Z[L − q]
  // back to the hi slot t2' of the mirror's rank, which nobody reads until
  // the next barrier. So each pair's ramp runs once, all reads local.
  cluster_arrive<C>();  // this block's passes have read smem
  cluster_wait<C>();
  const int partner = (C - rank) % C;
  auto mirror = [&](int t2) {
    return rank ? M - 1 - t2 : (M - t2) & (M - 1);
  };
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    if (local_out(m) < 8) continue;
    const int t2 = tid + kClusterThreads * local_out(m);
    if (rank == 0 && t2 == M / 2) continue;  // L/2, its own mirror
    st_rank<C>(smem, partner, rank, mirror(t2), conj(v[m]));
  }
  cluster_arrive<C>();
  cluster_wait<C>();

  // clipped delays and gains, as effective_filter_L
  float d[2], gn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float dv = p.align_guard, gv = 1.f;
    if (p.apply_itd) {
      dv = 0.f;
      for (int k = 0; k < 4; ++k)
        dv += __ldg(a.w + 4 * r + k) *
              __ldg(a.delays + 2 * __ldg(a.idx + 4 * r + k) + e);
    }
    if (p.apply_ild) {
      gv = 0.f;
      for (int k = 0; k < 4; ++k)
        gv += __ldg(a.w + 4 * r + k) *
              __ldg(a.gains + 2 * __ldg(a.idx + 4 * r + k) + e);
    }
    d[e] = fminf(fmaxf(dv - p.align_guard, -p.align_guard), p.max_shift);
    gn[e] = gv;
  }

  // unpack, ramp, gain and pack the pair (q, L − q) of each lo bin, and of
  // L/2 on its thread; Z[q] into the inverse's first-pass order (Z[c +
  // C·k2] at u[k2 / 1024], k2 = t2), Z[L − q] to the mirror's hi slot
  float2 u[16];
  auto ramp = [&](int q, float2 Sq, float2 Sm, float2& zq, float2& zm) {
    float2 G0, G1;
    unpack_pair(Sq, Sm, &G0, &G1);
    G0 = cscale(cmul(G0, ramp_bin(q, L, d[0], a.twL, a.taper)), gn[0]);
    G1 = cscale(cmul(G1, ramp_bin(q, L, d[1], a.twL, a.taper)), gn[1]);
    if (q == 0 || q == L / 2) {
      G0.y = 0.f;
      G1.y = 0.f;
    }
    zq = make_float2(G0.x - G1.y, G0.y + G1.x);
    zm = make_float2(G0.x + G1.y, G1.x - G0.y);
  };
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int o = local_out(m);
    if (o >= 8) continue;
    const int t2 = tid + kClusterThreads * o;
    const int q = rank + C * t2;
    const float2 Sq = conj(v[m]);
    float2 zm;
    ramp(q, Sq, q ? smem[t2] : Sq, u[o], zm);
    if (q) st_rank<C>(smem, partner, rank, mirror(t2), zm);
  }
  if (rank == 0 && tid == 0) {  // L/2: u[8], from v[2] (local_out(2) = 8)
    float2 unused;
    ramp(L / 2, conj(v[2]), conj(v[2]), u[8], unused);
  }
  cluster_arrive<C>();
  cluster_wait<C>();  // every Z[L − q] has landed
#pragma unroll
  for (int o = 8; o < 16; ++o)
    if (!(rank == 0 && tid == 0 && o == 8))
      u[o] = smem[tid + kClusterThreads * o];
  __syncthreads();  // every hi slot is read before the passes reuse smem

  // irfft_L in four steps, reversed: this rank's local M-point inverse of
  // Z[c + C·k2], the twiddle e^{2πi·c·t2/L}, then the C-point DFT across
  // the cluster for each t2, on the rank that owns t2's span
  dft<16>(u);
  reg_passes<kRegMaxLog2N, 1>(u, smem, tid, a.twM);
  cluster_arrive<C>();  // this block's passes have read smem
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t2 = tid + kClusterThreads * local_out(m);
    if (rank) u[m] = cmul(u[m], __ldg(a.twL + rank * t2));
  }
  cluster_wait<C>();
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t2 = tid + kClusterThreads * local_out(m);
    st_rank<C>(smem, t2 / span, rank, rank * span + t2 % span, u[m]);
  }
  cluster_arrive<C>();
  cluster_wait<C>();
  // t2 = rank·span + tid + s·1024: x[k1] from local k1·span + tid + s·1024
#pragma unroll
  for (int m = 0; m < 16; ++m)
    v[m] = smem[(m % C) * span + tid + (m / C) * kClusterThreads];
  cluster_arrive<C>();  // the spans are read
  if constexpr (C > 1) {
#pragma unroll
    for (int s = 0; s < 16 / C; ++s) {
      float2 x[C];
#pragma unroll
      for (int k1 = 0; k1 < C; ++k1) x[k1] = v[s * C + k1];
      dft<C>(x);
#pragma unroll
      for (int t1 = 0; t1 < C; ++t1) v[s * C + t1] = x[t1];
    }
  }

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

__device__ __forceinline__ float2 plane(const float* re, const float* im,
                                        size_t i) {
  return make_float2(re[i], im[i]);
}

// Inverse of the two packed-ear spectra in yn (and yp), last B samples,
// blend: y (2, B) at y0 (ear 0) and y0 + ear_stride (ear 1).
template <bool kSplit>
__device__ void tails_blend(float2* yn, float2* yp, const FftPlan& f,
                            const float2* tw, int tw_n, float2* work, int B,
                            int crossfade, float* y0, size_t ear_stride) {
  fft_run<kSplit>(f, yn, tw, tw_n, work, true);
  if (crossfade) fft_run<kSplit>(f, yp, tw, tw_n, work, true);
  const float inv_n = 1.0f / f.n;
  const float inv_B = 1.0f / B;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    float2 v = cscale(yn[B + i], inv_n);
    if (crossfade) {
      const float u = (i + 0.5f) * inv_B;
      const float2 vp = cscale(yp[B + i], inv_n);
      v = make_float2(u * v.x + (1.0f - u) * vp.x, u * v.y + (1.0f - u) * vp.y);
    }
    y0[i] = v.x;
    y0[ear_stride + i] = v.y;
  }
}

// One block per stream s (grid-stride when split). xb, prev_in: (S, B);
// fdl_*: (S, P, B+1); H_*, Hp_*: (S, P, 2, B+1); started: (S,). Writes y
// (S, 2, B), prev_out = xb, and the shifted delay line into fdl_*_out.
template <bool kSplit>
__global__ void stream_conv_kernel(const float* __restrict__ xb,
                                   const float* __restrict__ prev_in,
                                   const float* __restrict__ fdl_re,
                                   const float* __restrict__ fdl_im,
                                   const float* __restrict__ H_re,
                                   const float* __restrict__ H_im,
                                   const float* __restrict__ Hp_re,
                                   const float* __restrict__ Hp_im,
                                   const float* __restrict__ started,
                                   float* __restrict__ y,
                                   float* __restrict__ prev_out,
                                   float* __restrict__ fdl_re_out,
                                   float* __restrict__ fdl_im_out, int S,
                                   int B, int P, int crossfade,
                                   float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int n = 2 * B;
  const int F2 = B + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* xs = kSplit ? scratch + static_cast<size_t>(blockIdx.x) * 3 * n
                      : wbuf;    // n
  float2* yn = xs + n;           // n
  float2* yp = yn + n;           // n

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int s = blockIdx.x; s < S; s = next_row<kSplit>(s, S)) {
    __syncthreads();
    const size_t sb = static_cast<size_t>(s) * B;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      float v;
      if (t < B) {
        v = prev_in[sb + t];
      } else {
        v = xb[sb + t - B];
        prev_out[sb + t - B] = v;
      }
      xs[fft_pos<kSplit>(f, t)] = make_float2(v, 0.f);
    }
    fft_run<kSplit>(f, xs, tw, tw_n, wbuf, false);

    // The first push of a stream takes its own filter as "previous".
    const bool prev = crossfade && started[s] > 0.5f;
    const float* Pr = prev ? Hp_re : H_re;
    const float* Pi = prev ? Hp_im : H_im;
    for (int k = threadIdx.x; k < F2; k += blockDim.x) {
      float2 n0 = make_float2(0.f, 0.f), n1 = n0, p0 = n0, p1 = n0;
      for (int q = 0; q < P; ++q) {
        // slot 0 is the new frame, slot q the old slot q-1
        const size_t fi = (static_cast<size_t>(s) * P + q) * F2 + k;
        const float2 X = q == 0 ? xs[k] : plane(fdl_re, fdl_im, fi - F2);
        fdl_re_out[fi] = X.x;
        fdl_im_out[fi] = X.y;
        const size_t h = (static_cast<size_t>(s) * P + q) * 2 * F2 + k;
        n0 = cadd(n0, cmul(X, plane(H_re, H_im, h)));
        n1 = cadd(n1, cmul(X, plane(H_re, H_im, h + F2)));
        if (crossfade) {
          p0 = cadd(p0, cmul(X, plane(Pr, Pi, h)));
          p1 = cadd(p1, cmul(X, plane(Pr, Pi, h + F2)));
        }
      }
      pack_pair<kSplit>(yn, f, k, n0, n1);
      if (crossfade) pack_pair<kSplit>(yp, f, k, p0, p1);
    }
    tails_blend<kSplit>(yn, yp, f, tw, tw_n, wbuf, B, crossfade,
                        y + static_cast<size_t>(s) * 2 * B, B);
  }
}

// Sample t of the 2B overlap-save frame of block c, [x[c-1] | x[c]], with
// x[<0] = 0.
__device__ __forceinline__ float frame_sample(const float* x, int c, int t,
                                              int B) {
  const int blk = c - 1 + (t >= B ? 1 : 0);
  return blk < 0 ? 0.f : x[static_cast<size_t>(blk) * B + (t & (B - 1))];
}

// One block per output block b = b0 + i, i < n_blocks (grid-stride when
// split). x: (nb, B); H_*: rows for blocks b0 - has_prev … (P, 2, B+1
// each); y: (2, nb·B).
template <bool kSplit>
__global__ void partitioned_conv_kernel(const float* __restrict__ x,
                                        const float* __restrict__ H_re,
                                        const float* __restrict__ H_im,
                                        float* __restrict__ y, int nb, int b0,
                                        int n_blocks, int has_prev, int B,
                                        int P, int crossfade, float2* scratch,
                                        int work) {
  extern __shared__ float2 smem[];
  const int n = 2 * B;
  const int F2 = B + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* buf = kSplit ? scratch + static_cast<size_t>(blockIdx.x) *
                                       (2 * n + 4 * F2)
                       : wbuf;   // n
  float2* yp = buf + n;          // n
  float2* acc = yp + n;  // 4 · F2: Yn ear 0, Yn ear 1, Yp ear 0, Yp ear 1

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int i = blockIdx.x; i < n_blocks; i = next_row<kSplit>(i, n_blocks)) {
    __syncthreads();
    const int b = b0 + i;
    const size_t row = static_cast<size_t>(i + has_prev);
    const size_t prow = b == 0 ? row : row - 1;
    for (int k = threadIdx.x; k < 4 * F2; k += blockDim.x)
      acc[k] = make_float2(0.f, 0.f);

    for (int q = 0; q < P; q += 2) {
      // frames of blocks b-q and b-q-1 as one complex FFT
      const bool pair = q + 1 < P;
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        buf[fft_pos<kSplit>(f, t)] =
            make_float2(frame_sample(x, b - q, t, B),
                        pair ? frame_sample(x, b - q - 1, t, B) : 0.f);
      }
      fft_run<kSplit>(f, buf, tw, tw_n, wbuf, false);
      for (int k = threadIdx.x; k < F2; k += blockDim.x) {
        float2 Xa, Xb;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xa, &Xb);
        for (int j = 0; j < (pair ? 2 : 1); ++j) {
          const float2 X = j == 0 ? Xa : Xb;
          const size_t h = (row * P + q + j) * 2 * F2 + k;
          acc[k] = cadd(acc[k], cmul(X, plane(H_re, H_im, h)));
          acc[F2 + k] = cadd(acc[F2 + k], cmul(X, plane(H_re, H_im, h + F2)));
          if (crossfade) {
            const size_t hp = (prow * P + q + j) * 2 * F2 + k;
            acc[2 * F2 + k] =
                cadd(acc[2 * F2 + k], cmul(X, plane(H_re, H_im, hp)));
            acc[3 * F2 + k] =
                cadd(acc[3 * F2 + k], cmul(X, plane(H_re, H_im, hp + F2)));
          }
        }
      }
      __syncthreads();  // buf is refilled by the next pair of frames
    }

    for (int k = threadIdx.x; k < F2; k += blockDim.x) {
      pack_pair<kSplit>(buf, f, k, acc[k], acc[F2 + k]);
      if (crossfade)
        pack_pair<kSplit>(yp, f, k, acc[2 * F2 + k], acc[3 * F2 + k]);
    }
    tails_blend<kSplit>(buf, yp, f, tw, tw_n, wbuf, B, crossfade,
                        y + static_cast<size_t>(b) * B,
                        static_cast<size_t>(nb) * B);
  }
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

}  // namespace

extern "C" {

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; H_re, H_im: (rows, P, 2, B+1) f32. slices > 0: split mode,
// scratch holds slices · (2L + 2B) complex64. Otherwise the shared mode
// (L ≤ 8192; ranks 0) or the cluster mode (L ≥ 16384): twL, twM and tw2B
// the tables of exp(+2πi·m/L), exp(+2πi·m/16384) and exp(+2πi·m/2B),
// taper the ramp's taper at bins 0 … L/2, and ranks the plan's
// (ops/partitions_plan.py).
int tt_assemble_partitions(const void* idx, const void* w, const void* h_table,
                           const void* delays, const void* gains, void* H_re,
                           void* H_im, const void* twL, const void* twM,
                           const void* tw2B, const void* taper, int rows,
                           int taps, int t_pad,
                           int B, int P, int apply_itd, int apply_ild,
                           int ranks, float align_guard, float max_shift,
                           float taper_lo, float taper_hi, void* scratch,
                           int slices, int work, void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, 2 * B, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  if (slices == 0 && p.L > (1 << kRegMaxLog2N) / 2) {
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
    return launch_partitions_cluster<kRegMaxLog2N>(
        p.log2L, ilog2(2 * B), ranks, a, rows,
        static_cast<cudaStream_t>(stream));
  }
  if (slices == 0 && ranks != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<float*>(H_re),
      static_cast<float*>(H_im), p, B, P, rows, static_cast<float2*>(scratch),
      work);
  return static_cast<int>(cudaGetLastError());
}

// See stream_conv_kernel; Hp_* may alias H_* (the hold step). slices > 0:
// split mode, scratch holds slices · 6B complex64.
int tt_stream_conv(const void* xb, const void* prev_in, const void* fdl_re,
                   const void* fdl_im, const void* H_re, const void* H_im,
                   const void* Hp_re, const void* Hp_im, const void* started,
                   void* y, void* prev_out, void* fdl_re_out,
                   void* fdl_im_out, int S, int B, int P, int crossfade,
                   void* scratch, int slices, int work, void* stream) {
  auto kernel =
      slices > 0 ? stream_conv_kernel<true> : stream_conv_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, S, slices, work, 7 * B, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const float*>(prev_in),
      static_cast<const float*>(fdl_re), static_cast<const float*>(fdl_im),
      static_cast<const float*>(H_re), static_cast<const float*>(H_im),
      static_cast<const float*>(Hp_re), static_cast<const float*>(Hp_im),
      static_cast<const float*>(started), static_cast<float*>(y),
      static_cast<float*>(prev_out), static_cast<float*>(fdl_re_out),
      static_cast<float*>(fdl_im_out), S, B, P, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// x: (nb, B) f32; H_re, H_im: (n_blocks + has_prev, P, 2, B+1) f32 for
// blocks b0 - has_prev … b0 + n_blocks - 1; y: (2, nb·B) f32. slices > 0:
// split mode, scratch holds slices · (4B + 4(B+1)) complex64.
int tt_partitioned_conv(const void* x, const void* H_re, const void* H_im,
                        void* y, int nb, int b0, int n_blocks, int has_prev,
                        int B, int P, int crossfade, void* scratch,
                        int slices, int work, void* stream) {
  auto kernel = slices > 0 ? partitioned_conv_kernel<true>
                           : partitioned_conv_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, n_blocks, slices, work,
                               5 * B + 4 * (B + 1), &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(H_re),
      static_cast<const float*>(H_im), static_cast<float*>(y), nb, b0,
      n_blocks, has_prev, B, P, crossfade, static_cast<float2*>(scratch),
      work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
