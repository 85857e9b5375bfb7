// The stages of a register-resident effective-filter chain on L/16
// threads, shared by the kernels that run G rows' chains at once on G
// groups of threads: assemble_filters.cu and assemble_partitions.cu.
// Each group computes h_eff = irfft_L(ramp·gain·rfft_L(gather(idx[r],
// w[r]))) for its row r: row_delays_gains, then gather_conj into the
// first pass of rfft_L, then assemble_L through the group's exchange
// buffer. assembly_mac.cu's register kernel keeps its own copy of these
// stages: built on these functions, 29 of its 36 instances changed their
// spills. The cluster chain at the end (cluster_filter) serves the
// cluster modes of assemble_partitions.cu, assembly_mac.cu and
// assemble_filters.cu; the last two build a row's filter spectrum on it
// with cluster_spectrum.

#pragma once

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

// Unpack, ramp, gain and pack the bin pair (q, L − q) of an L-point
// spectrum in buf, in place; DC and Nyquist lose their imaginary parts.
__device__ __forceinline__ void ramp_pair(float2* buf, int q, int L,
                                          const float (&d)[2],
                                          const float (&g)[2],
                                          const float2* twL,
                                          const float* taper) {
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

// rfft_L → ramp and gain → irfft_L of one row on the TL = L/16 threads
// with `live` true, through the row's exchange buffer buf (RegPlan<log2
// L>::row_f2 complex64). On entry v holds gather_conj's output and buf is
// free (the caller's barrier); on return v holds irfft_L's last pass:
// L·h_eff at t = j + q·L/R for sub-DFT j = lane + s·TL, slot s·R + q (R
// the last radix). The ramp pass runs on the `ramp_lanes` ≥ TL threads
// lane = 0 … ramp_lanes − 1 of the row with `ramp_live` true (the
// chain's TL among them; TL and `live` where the row has no more
// threads), bins q = lane, lane + ramp_lanes, … ≤ L/2, each reading bins
// q and L − q, unpacking both ears, applying the ramp and the gain and
// packing Z[q] and Z[L − q] in place, each bin once: a block with threads
// to spare finishes it in fewer rounds. Every thread of the block calls
// this and keeps to its barriers.
template <int kLog2L>
__device__ __forceinline__ void assemble_L(float2 (&v)[16], float2* buf,
                                           int lane, bool live,
                                           const float (&d)[2],
                                           const float (&g)[2],
                                           const float2* twL,
                                           const float* taper,
                                           int ramp_lanes, bool ramp_live) {
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
#pragma unroll 1
  for (int q = ramp_live ? lane : L; q <= L / 2; q += ramp_lanes)
    ramp_pair(buf, q, L, d, g, twL, taper);
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

// ------------------------------------------------------------------------
// The cluster chain (ClusterPlan, fft_reg.cuh), shared by the cluster
// modes of assemble_partitions.cu and assembly_mac.cu: one row's L-point
// chain (L = 16384 … 131072) on a thread-block cluster of C = L/16384
// blocks of 1024 threads, crossing the cluster through distributed shared
// memory: the gather straight into registers, rfft_L as the conjugate of
// the inverse (the radix-C step, one exchange, each block's 16384-point
// register FFT), the exchange that brings each bin's mirror L − q to its
// block, the table-driven ramp and the gain once per pair, and irfft_L in
// the reverse order (each block's local inverse, the twiddle, one exchange
// to the block that owns each t2's span, the C-point DFT).
// assemble_partitions.cu's header describes each step.
//
// On entry the thread has arrived on the cluster barrier since its block
// last read smem (the share of the cluster's exchange buffers, at least
// ClusterPlan::share_f2 complex64). On return v[m] holds L·h_eff, both
// ears packed, at t = M·(m % C) + rank·span + tid + (m / C)·1024, which is
// cluster_spread's input order, and an arrive is outstanding: smem is
// read. Args names idx, w, h_table, delays, gains, twL (exp(+2πi·m/L)),
// twM (exp(+2πi·m/16384)), taper (ops/mac_plan.py ramp_taper at L) and p.
template <class PL, class Args>
__device__ __forceinline__ void cluster_filter(float2 (&v)[16], float2* smem,
                                               const Args& a, int r, int rank,
                                               int tid) {
  constexpr int L = PL::n, C = PL::ranks, M = PL::M, span = PL::span;
  const AssemblyParams& p = a.p;
  // gather: conj(h0 + i·h1) at t = M·k1 + k2, k2 = rank·span + tid +
  // s·1024, into v[s·C + k1]; one table row at a time, half the slots at a
  // time, so 16 loads are in flight
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
}

// One row's filter spectrum H = rfft_n(h_eff truncated to t_pad) on a
// cluster, L == n (ClusterPlan PN): cluster_filter; h_eff truncated to
// t_pad, scaled by 1/n and conjugated in registers; rfft_n as the
// conjugate of the inverse across the cluster (cluster_spread, one DSMEM
// exchange, each rank's 16384-point register FFT); then cluster_pairs. On
// entry as cluster_filter; on return share holds Z[q], Z[n − q] of the
// packed pair H0 + i·H1 at float4 l of each rank's bins q = rank·8192 + l
// (the last rank's n/2 at l = 8192), and no arrive is outstanding. Args
// names cluster_filter's tables and twN (exp(+2πi·m/n)). The cluster
// kernels of assembly_mac.cu (which then runs its MAC on the pairs) and
// assemble_filters.cu (which writes H) share it, so neither keeps a copy.
template <class PN, class Args>
__device__ __forceinline__ void cluster_spectrum(float2* share, const Args& a,
                                                 int r, int rank, int tid) {
  constexpr int n = PN::n, C = PN::ranks, M = PN::M, span = PN::span;
  const float inv_n = 1.0f / n;
  float2 v[16];
  cluster_filter<PN>(v, share, a, r, rank, tid);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t = M * (m % C) + rank * span + tid + (m / C) * kClusterThreads;
    v[m] = t < a.p.t_pad ? conj(cscale(v[m], inv_n)) : make_float2(0.f, 0.f);
  }
  cluster_spread<PN>(v, share, rank, tid, a.twN);
  cluster_local_fft(v, share, tid, a.twM);
  cluster_pairs<PN>(v, share, rank, tid);
}

}  // namespace
