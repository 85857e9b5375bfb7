// The stages of a register-resident effective-filter chain on L/16
// threads, shared by the kernels that run G rows' chains at once on G
// groups of threads: assemble_filters.cu and assemble_partitions.cu.
// Each group computes h_eff = irfft_L(ramp·gain·rfft_L(gather(idx[r],
// w[r]))) for its row r: row_delays_gains, then gather_conj into the
// first pass of rfft_L, then assemble_L through the group's exchange
// buffer. assembly_mac.cu keeps its own copy of these stages: built on
// these functions, 29 of its 36 instances changed their spills.

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

}  // namespace
