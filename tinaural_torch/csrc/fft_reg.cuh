// Register-resident FFTs for Hopper: one n-point transform per row, its
// points spread over T threads that keep `points` values each in
// registers, in passes of radix 16 (a smaller radix last where n is not a
// power of 16) with one exchange through shared memory between passes.
//
// Order (Stockham, in Bainville's formulation): pass p has radix R and
// stride Ns, the product of the radices before it. Its sub-DFT j < n/R
// takes slot r from position j + r·n/R and multiplies it by the twiddle
// exp(+2πi·r·(j mod Ns)/(Ns·R)). It transforms the R values in registers
// and hands slot r on to position (j div Ns)·Ns·R + (j mod Ns) + r·Ns.
// After the last pass the output is in natural order, so there is no
// bit-reversal pass. Thread `lane` of a row runs the sub-DFTs
// j = lane + s·T, s < points/R, so neighbouring threads touch
// neighbouring positions in every load and store.
//
// The plan is a compile-time function of log2 n (RegPlan), computed the
// same way by tinaural_torch/ops/spectra_inverse.py `inverse_plan`:
//   n ≤ 16: one pass of radix n, one thread per row, 256 rows per block;
//   n ≥ 32: 16 points per thread, T = n/16 threads per row, max(1, 256/T)
//           rows per block, radices 16, …, 16, n/16^(passes−1).
// A row's exchange buffer holds n + n/16 complex64: one float2 of padding
// after every 16 (pad16), so that the first pass's stride-16 stores fall
// on distinct banks. Twiddles between passes come from a table of
// exp(+2πi·m/n), m < n, that the host builds once in float64 and rounds
// to complex64; the in-register butterflies use constants.
//
// Only the inverse direction (exp(+2πi·…)) is written; the forward one is
// its conjugate.

#pragma once

#include "common.cuh"

namespace {

constexpr int kRegMaxLog2N = 14;

template <int kLog2N>
struct RegPlan {
  static constexpr int n = 1 << kLog2N;
  static constexpr int points = n < 16 ? n : 16;
  static constexpr int threads = n / points;
  static constexpr int rows = threads >= 256 ? 1 : 256 / threads;
  static constexpr int block = rows * threads;
  static constexpr int passes = (kLog2N + 3) / 4;
  static constexpr int row_f2 = passes > 1 ? n + n / 16 : 0;
  // the radix of pass p, and its stride Ns = 16^p
  __host__ __device__ static constexpr int radix(int p) {
    return p + 1 < passes ? 16 : n >> (4 * (passes - 1));
  }
  __host__ __device__ static constexpr int stride(int p) { return 1 << (4 * p); }
};

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// a · exp(+2πi·q/16); q is a constant once the caller's loops unroll, so
// the switch folds away and the quarter turns cost no multiply.
__device__ __forceinline__ float2 mul_w16(float2 a, int q) {
  constexpr float c = 0.92387953251128674f;  // cos(π/8)
  constexpr float s = 0.38268343236508977f;  // sin(π/8)
  constexpr float h = 0.70710678118654752f;  // cos(π/4)
  switch (q & 15) {
    case 0: return a;
    case 4: return make_float2(-a.y, a.x);
    case 8: return make_float2(-a.x, -a.y);
    case 12: return make_float2(a.y, -a.x);
    case 1: return cmul(a, make_float2(c, s));
    case 2: return cmul(a, make_float2(h, h));
    case 3: return cmul(a, make_float2(s, c));
    case 5: return cmul(a, make_float2(-s, c));
    case 6: return cmul(a, make_float2(-h, h));
    case 7: return cmul(a, make_float2(-c, s));
    case 9: return cmul(a, make_float2(-c, -s));
    case 10: return cmul(a, make_float2(-h, -h));
    case 11: return cmul(a, make_float2(-s, -c));
    case 13: return cmul(a, make_float2(s, -c));
    case 14: return cmul(a, make_float2(h, -h));
    default: return cmul(a, make_float2(c, -s));  // 15
  }
}

// In-place inverse DFT of R ∈ {2, 4, 8, 16} values in registers, natural
// order in and out: X[k] = Σ_r x[r]·exp(+2πi·r·k/R). R = 8, 16 run as
// 4 × R/4: y[n2][k1] = dft4 over n1 of x[R2·n1 + n2], times
// exp(2πi·n2·k1/R), then X[k1 + 4·k2] = dft_R2 over n2 of y[n2][k1].
template <int R>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = cadd(a, b);
    x[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 s02 = cadd(x[0], x[2]), d02 = csub(x[0], x[2]);
    const float2 s13 = cadd(x[1], x[3]), d13 = csub(x[1], x[3]);
    const float2 i13 = make_float2(-d13.y, d13.x);
    x[0] = cadd(s02, s13);
    x[1] = cadd(d02, i13);
    x[2] = csub(s02, s13);
    x[3] = csub(d02, i13);
  } else {
    constexpr int R2 = R / 4;
    float2 y[R2][4];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
      float2 g[4];
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) g[n1] = x[R2 * n1 + n2];
      dft<4>(g);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        y[n2][k1] = mul_w16(g[k1], n2 * k1 * (16 / R));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 g[R2];
#pragma unroll
      for (int n2 = 0; n2 < R2; ++n2) g[n2] = y[n2][k1];
      dft<R2>(g);
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) x[k1 + 4 * k2] = g[k2];
    }
  }
}

// Passes kPass … passes−1 of one row's transform. On entry v holds the
// output of pass kPass − 1 of thread `lane` (sub-DFTs j = lane + s·T, slot
// r at v[s·R + r]); on return, the last pass's. buf is the row's exchange
// buffer (RegPlan::row_f2 complex64 of shared memory) and tw the table of
// exp(+2πi·m/n). Every thread of the block calls this, rows or not.
template <int kLog2N, int kPass>
__device__ __forceinline__ void reg_passes(
    float2 (&v)[RegPlan<kLog2N>::points], float2* buf, int lane,
    const float2* __restrict__ tw) {
  using P = RegPlan<kLog2N>;
  if constexpr (kPass < P::passes) {
    constexpr int n = P::n, T = P::threads, PT = P::points;
    constexpr int Rq = P::radix(kPass - 1), Nq = P::stride(kPass - 1);
    constexpr int R = P::radix(kPass), Ns = P::stride(kPass);
    if constexpr (kPass > 1) __syncthreads();  // the last pass read buf
#pragma unroll
    for (int s = 0; s < PT / Rq; ++s) {
      const int j = lane + s * T;
      const int base = (j / Nq) * Nq * Rq + j % Nq;
#pragma unroll
      for (int r = 0; r < Rq; ++r) buf[pad16(base + r * Nq)] = v[s * Rq + r];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < PT / R; ++s) {
      const int j = lane + s * T;
      const int k = j % Ns;
      float2 x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[r] = buf[pad16(j + r * (n / R))];
        if (r > 0) x[r] = cmul(x[r], __ldg(tw + r * k * (n / (Ns * R))));
      }
      dft<R>(x);
#pragma unroll
      for (int r = 0; r < R; ++r) v[s * R + r] = x[r];
    }
    reg_passes<kLog2N, kPass + 1>(v, buf, lane, tw);
  }
}

// reg_passes for a block wider than the transform: threads with `live`
// false touch neither buf nor v but keep to every barrier, so a block of
// n'/16 threads can run an n-point transform (n ≤ n') on its first n/16.
template <int kLog2N, int kPass>
__device__ __forceinline__ void reg_passes_live(
    float2 (&v)[RegPlan<kLog2N>::points], float2* buf, int lane,
    const float2* __restrict__ tw, bool live) {
  using P = RegPlan<kLog2N>;
  if constexpr (kPass < P::passes) {
    constexpr int n = P::n, T = P::threads, PT = P::points;
    constexpr int Rq = P::radix(kPass - 1), Nq = P::stride(kPass - 1);
    constexpr int R = P::radix(kPass), Ns = P::stride(kPass);
    if constexpr (kPass > 1) __syncthreads();  // the last pass read buf
    if (live) {
#pragma unroll
      for (int s = 0; s < PT / Rq; ++s) {
        const int j = lane + s * T;
        const int base = (j / Nq) * Nq * Rq + j % Nq;
#pragma unroll
        for (int r = 0; r < Rq; ++r) buf[pad16(base + r * Nq)] = v[s * Rq + r];
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int s = 0; s < PT / R; ++s) {
        const int j = lane + s * T;
        const int k = j % Ns;
        float2 x[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          x[r] = buf[pad16(j + r * (n / R))];
          if (r > 0) x[r] = cmul(x[r], __ldg(tw + r * k * (n / (Ns * R))));
        }
        dft<R>(x);
#pragma unroll
        for (int r = 0; r < R; ++r) v[s * R + r] = x[r];
      }
    }
    reg_passes_live<kLog2N, kPass + 1>(v, buf, lane, tw, live);
  }
}

}  // namespace
