// Hand-written Hopper kernel of the natural-order assembly + MAC: each
// row's filter is assembled and used in the MAC inside one CUDA block, so
// the filter spectra never reach device memory.
//
// Replaces tinaural/ops/pallas_kernels.py:fused_assembly_mac (:354; kernel
// body _assembly_mac_kernel, :287): per row r, H[r] = rfft_n(truncate to
// t_pad(irfft_L(ramp·gain·rfft_L(gather(idx[r], w[r]))))), then
// Y[r] = Xu[r]·H[r] + Xd[r]·H_prev with H_prev = H[r−1], or H[r] at a
// `first` row; without crossfade Y = Xu·H[r]. The TPU kernel assembles by
// matmuls against resident constants and carries the last filter of each
// grid step to the next in VMEM, leaning on its ordered grid. CUDA blocks
// run in no order, so one block takes a run of `run` consecutive rows and
// assembles the run's predecessor first, unless the run starts at a
// `first` row. `first` rows may fall anywhere inside a run; row 0 always
// counts as one (pallas_kernels.py:374 forces it). The host picks the run
// from the rows and the card's concurrent blocks (ops/assembly_mac.py
// `run_length`): a run of c rows assembles c + 1 filters.
//
// Bound on the H100 by bytes: a row reads two input spectra and writes
// two (4·F complex64, 64 KB at n_fft 4096), so 8192 rows at n_fft 4096
// take 0.165 ms at 3.35 TB/s, where their FFTs, ramp and MAC (0.86 MFLOP
// a row at 2048 taps, chip_smoke.py's count) take 0.105 ms at 67 TFLOP/s
// fp32; 4096 rows at 128 taps 0.081 ms against 0.020 ms. The radix-2 body
// this replaces (three shared-memory FFTs with a barrier per stage, ~40
// barriers a row, twiddles rebuilt with sincospif in every block, five
// transcendentals per bin and ear, one 1024-thread block per SM) took 25×
// the byte bound. This design, in the shared buffer mode (n_fft ≤ 16384):
//   threads      n/16 per block (256 at n_fft 4096), 16 points each in
//                registers (csrc/fft_reg.cuh), 3 blocks per SM at 4096:
//                __launch_bounds__ caps the registers at 85;
//   gather       the first L/16 threads load h0 + i·h1 of the 4 table rows
//                and weights straight into the first pass's input order,
//                coalesced, one table row at a time; the other threads
//                keep to the barriers only;
//   rfft_L       the forward transform as the conjugate of the register
//                inverse: conjugated input, reg_passes, conjugated output;
//   ramp, gain   one exchange, then a pass over the bins on every thread:
//                bin q ≤ L/2 reads bins q and L − q, unpacks both ears,
//                applies the ramp and the gain and packs Z[q] and Z[L − q]
//                in place, each bin once; the L/16 threads then load the
//                inverse's input. The ramp's integer phase (q·⌊d⌋) mod L
//                and sin θ, cos θ come from the L-point twiddle table, the
//                taper w from a host table (ops/mac_plan.py): per bin and
//                ear one sincospif and, where w < 1 (fnorm > 0.40), one
//                atan2f remain;
//   irfft_L      truncated to t_pad and scaled by 1/L: where L == n each
//                thread already holds the positions the forward rfft_n
//                takes (a register permutation), else one exchange;
//   rfft_n, MAC  one exchange: thread `lane` owns bins lane + i·T (i < 8;
//                lane 0 also n/2), unpacks H0, H1 from bins k and n − k,
//                reads Xu, Xd and writes Y coalesced, and keeps its bins of
//                H as the next row's H_prev in its own slice of shared
//                memory (18 complex64 a thread; in registers at n_fft
//                16384, where the slices would not fit), so the carry
//                needs no barrier. In registers everywhere, the carry
//                spilled 400–600 bytes a thread at n_fft 4096 and 8192.
// Twiddles come from tables built once per (device, size) on the host
// (ops/spectra_inverse.py `twiddles`): no block computes a twiddle.
// 17 barriers a row at n_fft 4096 with L == n, 15 with L = 256.
//
// The split buffer mode (n_fft above 16384: H and H_prev alone are 512 KB
// at 32768) keeps the radix-2 body: the effective-filter chain of
// common.cuh and fft_run over the block's device scratch slice, 1024
// threads, the blocks walking the runs.

#include "fft_reg.cuh"

namespace {

constexpr int kMacMinLog2 = 7;  // L ≥ next_pow2(1 + DELAY_PAD) = 128
constexpr int kCarrySlots = 18;  // H_prev: 9 bins × 2 ears per thread

// complex64 of dynamic shared memory: the exchange buffer, and below
// n_fft 16384 the carried H_prev beside it. ops/mac_plan.py `mac_plan`
// computes the same.
template <int kLog2N>
constexpr int mac_shared_f2() {
  using P = RegPlan<kLog2N>;
  return P::row_f2 + (kLog2N < kRegMaxLog2N ? kCarrySlots * P::threads : 0);
}

// Blocks per SM that __launch_bounds__ asks for with T threads: 768
// threads' worth, at most 16 blocks (so their shared memory fits), so 85
// registers a thread (ptxas takes 80) up to T = 256, 128 at 512 and 64 at
// 1024, the hardware's cap. Three blocks of 256 took 7% less time than
// two at n_fft 4096 and 2048 taps, 23% at 128 taps
// (scripts/torch_assembly_mac_sweep.py on a build of each).
// ops/mac_plan.py `mac_plan` computes the same.
__host__ __device__ constexpr int mac_min_blocks(int threads) {
  return threads >= 768 ? 1 : (768 / threads > 16 ? 16 : 768 / threads);
}

struct MacArgs {
  const int* idx;        // (rows, 4) flat table rows
  const float* w;        // (rows, 4)
  const float* h_table;  // (R, 2, taps)
  const float* delays;   // (R, 2)
  const float* gains;    // (R, 2)
  const float2* Xu;      // (rows, F)
  const float2* Xd;      // (rows, F)
  const float* first;    // (rows,)
  float2* Y;             // (rows, 2, F)
  const float2* twL;     // exp(+2πi·m/L), m < L
  const float2* twN;     // exp(+2πi·m/n), m < n
  const float* taper;    // the ramp's taper w at bins 0 … L/2
  AssemblyParams p;
  int rows, run, crossfade;
};

// The shared buffer mode: one block of T = n/16 threads per run of rows;
// see the header comment. buf is one row's exchange buffer (n + n/16
// complex64), reused by every exchange.
template <int kLog2N, int kLog2L>
__global__ void __launch_bounds__(RegPlan<kLog2N>::threads,
                                  mac_min_blocks(RegPlan<kLog2N>::threads))
    assembly_mac_kernel(const MacArgs a) {
  using PN = RegPlan<kLog2N>;
  using PL = RegPlan<kLog2L>;
  constexpr int n = PN::n, L = PL::n, T = PN::threads, TL = PL::threads;
  constexpr int F = n / 2 + 1;
  constexpr int RL = PL::radix(PL::passes - 1), NsL = L / RL;
  constexpr int RN = PN::radix(PN::passes - 1), NsN = n / RN;
  static_assert(PN::passes > 1 && PL::passes > 1 && PN::points == 16 &&
                    PL::points == 16,
                "the register plans of both transforms take 16 points");
  extern __shared__ float2 buf[];
  const AssemblyParams& p = a.p;
  const int lane = threadIdx.x;
  // the L-point chain's threads (a constant true where L == n spilled
  // twice as much at n_fft 4096 and ran 15% slower)
  const bool live = lane < TL;
  const float inv_L = 1.0f / L;
  const int r0 = blockIdx.x * a.run;
  const int r1 = min(a.rows, r0 + a.run);
  // the run's predecessor, unless the run starts a track
  const bool prev = a.crossfade && r0 > 0 && __ldg(a.first + r0) < 0.5f;
  // H_prev at this thread's bins lane + i·T (i < 8; i = 8: n/2 on lane
  // 0), both ears: slot 2i + e, in this thread's slice of shared memory
  // beside buf (slot s at s·T + lane) where both fit, else in registers
  constexpr bool kSharedCarry = kLog2N < kRegMaxLog2N;
  float2 hreg[kSharedCarry ? 1 : kCarrySlots];
  float2* hsh = buf + PN::row_f2 + lane;
  auto carry = [&](int s) -> float2& {
    if constexpr (kSharedCarry) return hsh[s * T];
    else return hreg[s];
  };

  for (int r = prev ? r0 - 1 : r0; r < r1; ++r) {
    float2 v[16];
    int rows[4];
    float wk[4], d[2], g[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rows[k] = __ldg(a.idx + 4 * r + k);
      wk[k] = __ldg(a.w + 4 * r + k);
    }
    // clipped delays and gains, as effective_filter_L
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float dv = p.align_guard, gv = 1.f;
      if (p.apply_itd) {
        dv = 0.f;
        for (int k = 0; k < 4; ++k)
          dv += wk[k] * __ldg(a.delays + 2 * rows[k] + e);
      }
      if (p.apply_ild) {
        gv = 0.f;
        for (int k = 0; k < 4; ++k)
          gv += wk[k] * __ldg(a.gains + 2 * rows[k] + e);
      }
      d[e] = fminf(fmaxf(dv - p.align_guard, -p.align_guard), p.max_shift);
      g[e] = gv;
    }
    if (live) {
      // gather: conj(h0 + i·h1) at t = lane + m·TL, the first pass's
      // input, one table row at a time, so 32 loads are in flight, not 128
      // (the row and weight are read again: rows[k] and wk[k] at a
      // run-time k would go to local memory)
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = make_float2(0.f, 0.f);
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        const float wkk = __ldg(a.w + 4 * r + k);
        const float* row = a.h_table + static_cast<size_t>(__ldg(
                                           a.idx + 4 * r + k)) * 2 * p.taps;
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const int t = lane + m * TL;
          if (t < p.taps) {
            v[m].x += wkk * __ldg(row + t);
            v[m].y += wkk * __ldg(row + p.taps + t);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = conj(v[m]);
      dft<16>(v);
    }
    // rfft_L
    __syncthreads();  // the previous row's MAC has read buf
    reg_passes_live<kLog2L, 1>(v, buf, lane, a.twL, live);
    __syncthreads();  // the last pass has read buf
    if (live) {
#pragma unroll
      for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
        for (int q = 0; q < RL; ++q)
          buf[lane + s * TL + q * NsL] = conj(v[s * RL + q]);
    }
    __syncthreads();
    // unpack, ramp, gain and pack in place, bins q and L − q on every
    // thread, each bin once; DC and Nyquist lose their imaginary parts
#pragma unroll 1
    for (int q = lane; q <= L / 2; q += T) {
      const int qm = (L - q) & (L - 1);
      float2 G0, G1;
      unpack_pair(buf[q], buf[qm], &G0, &G1);
      G0 = cscale(cmul(G0, ramp_bin(q, L, d[0], a.twL, a.taper)), g[0]);
      G1 = cscale(cmul(G1, ramp_bin(q, L, d[1], a.twL, a.taper)), g[1]);
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
    reg_passes_live<kLog2L, 1>(v, buf, lane, a.twL, live);
    // h_eff, truncated to t_pad and scaled, conjugated into rfft_n's first
    // pass: the last pass's sub-DFT j = lane + s·TL holds t = j + q·NsL
    if constexpr (kLog2L == kLog2N) {
      float2 u[16];
#pragma unroll
      for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
        for (int q = 0; q < RL; ++q) {
          const int m = s + q * (16 / RL);  // t = lane + m·T
          u[m] = lane + m * T < p.t_pad ? conj(cscale(v[s * RL + q], inv_L))
                                        : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int m = 0; m < 16; ++m) v[m] = u[m];
    } else {
      __syncthreads();  // the last pass has read buf
      if (live) {
#pragma unroll
        for (int s = 0; s < 16 / RL; ++s)
#pragma unroll
          for (int q = 0; q < RL; ++q) {
            const int t = lane + s * TL + q * NsL;
            if (t < p.t_pad) buf[t] = cscale(v[s * RL + q], inv_L);
          }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int t = lane + m * T;
        v[m] = t < p.t_pad ? conj(buf[t]) : make_float2(0.f, 0.f);
      }
    }
    // rfft_n
    dft<16>(v);
    __syncthreads();  // irfft_L's last pass, or the hand-off, read buf
    reg_passes<kLog2N, 1>(v, buf, lane, a.twN);
    __syncthreads();  // the last pass has read buf
#pragma unroll
    for (int s = 0; s < 16 / RN; ++s)
#pragma unroll
      for (int q = 0; q < RN; ++q)
        buf[lane + s * T + q * NsN] = conj(v[s * RN + q]);
    __syncthreads();

    // unpack H and the MAC on this thread's bins; H becomes H_prev
    const bool mac = r >= r0;
    const bool own = r == 0 || __ldg(a.first + r) > 0.5f;
    const float2* xu = a.Xu + static_cast<size_t>(r) * F;
    const float2* xd = a.Xd + static_cast<size_t>(r) * F;
    float2* Y0 = a.Y + static_cast<size_t>(r) * 2 * F;
    auto mac_bin = [&](int k, float2& h0, float2& h1) {
      float2 A, B;
      unpack_pair(buf[k], buf[(n - k) & (n - 1)], &A, &B);
      if (mac) {
        const float2 x = __ldg(xu + k);
        float2 y0 = cmul(x, A), y1 = cmul(x, B);
        if (a.crossfade) {
          const float2 xdk = __ldg(xd + k);
          y0 = cadd(y0, cmul(xdk, own ? A : h0));
          y1 = cadd(y1, cmul(xdk, own ? B : h1));
        }
        Y0[k] = y0;
        Y0[F + k] = y1;
      }
      h0 = A;
      h1 = B;
    };
#pragma unroll 2
    for (int i = 0; i < 8; ++i)
      mac_bin(lane + i * T, carry(2 * i), carry(2 * i + 1));
    if (lane == 0) mac_bin(n / 2, carry(16), carry(17));
  }
}

// The split buffer mode: the radix-2 body over the block's device scratch
// slice (n_fft + 2L + 4F complex64), the blocks walking the runs. It
// shares the register kernel's name, so a profile names both alike.
// idx, w: (rows, 4); Xu, Xd: (rows, F) complex64; first: (rows,) f32;
// Y: (rows, 2, F) complex64.
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
  const int tw_n = work;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // work
  float2* big = scratch + static_cast<size_t>(blockIdx.x) *
                              (n + 2 * p.L + 4 * F);  // n_fft
  float2* s1 = big + n;          // L
  float2* s2 = s1 + p.L;         // L
  float2* Hc = s2 + p.L;         // 2F: this row's filter, both ears
  float2* Hp = Hc + 2 * F;       // 2F: the previous row's
  __shared__ int rows[4];
  __shared__ float wk[4];
  __shared__ float dg[4];  // d0, d1, g0, g1

  const FftPlan fL = fft_plan(p.L, work);
  const FftPlan fN = fft_plan(n, work);
  make_twiddles(tw, tw_n);
  const float inv_L = 1.0f / p.L;
  const int runs = (rows_total + run - 1) / run;
  for (int q = blockIdx.x; q < runs; q = next_row<true>(q, runs)) {
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

      effective_filter_L<true>(rows, wk, dg, h_table, delays, gains, p, fL,
                               tw, tw_n, wbuf, s1, s2);
      // h_eff truncated to T_pad, packed, zero-padded to n_fft
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        big[fft_pos<true>(fN, t)] =
            t < p.t_pad ? cscale(s2[t], inv_L) : make_float2(0.f, 0.f);
      }
      fft_run<true>(fN, big, tw, tw_n, wbuf, false);

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

using SplitKernel = void (*)(const int*, const float*, const float*,
                             const float*, const float*, const float2*,
                             const float2*, const float*, float2*,
                             AssemblyParams, int, int, int, float2*, int);

// The register kernel for L = 2^kLog2L ≤ n = 2^kLog2N.
template <int kLog2N, int kLog2L>
int launch_mac(int log2L, const MacArgs& a, cudaStream_t stream) {
  if constexpr (kLog2L > kLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2L != kLog2L) return launch_mac<kLog2N, kLog2L + 1>(log2L, a, stream);
    using P = RegPlan<kLog2N>;
    const auto kernel = assembly_mac_kernel<kLog2N, kLog2L>;
    const int smem =
        mac_shared_f2<kLog2N>() * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(a.rows + a.run - 1) / a.run, P::threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// The register kernel for n = 2^kLog2N, checked against the caller's plan.
template <int kLog2N>
int launch_register(int log2n, int log2L, int threads, int blocks_per_sm,
                    const MacArgs& a, cudaStream_t stream) {
  if constexpr (kLog2N > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_register<kLog2N + 1>(log2n, log2L, threads, blocks_per_sm,
                                         a, stream);
    using P = RegPlan<kLog2N>;
    if (threads != P::threads || blocks_per_sm != mac_min_blocks(P::threads) ||
        a.twL == nullptr || a.twN == nullptr || a.taper == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mac<kLog2N, kMacMinLog2>(log2L, a, stream);
  }
}

}  // namespace

extern "C" {

// idx, w: (rows, 4) int32 / f32; h_table: (R, 2, taps) f32; delays, gains:
// (R, 2) f32; Xu, Xd: (rows, F) complex64; first: (rows,) f32; Y: (rows, 2,
// F) complex64. slices > 0: split mode, scratch holds slices ·
// (n_fft + 2L + 4F) complex64, and twL, twN, taper, threads and
// blocks_per_sm are unused. Otherwise the register kernel: twL and twN the
// tables of exp(+2πi·m/L) and exp(+2πi·m/n), taper the ramp's taper at
// bins 0 … L/2, and threads and blocks_per_sm must be the plan's
// (ops/mac_plan.py `mac_plan`).
int tt_assembly_mac(const void* idx, const void* w, const void* h_table,
                    const void* delays, const void* gains, const void* Xu,
                    const void* Xd, const void* first, void* Y,
                    const void* twL, const void* twN, const void* taper,
                    int rows, int run, int taps, int t_pad, int n_fft,
                    int crossfade, int apply_itd, int apply_ild, int threads,
                    int blocks_per_sm, float align_guard, float max_shift,
                    float taper_lo, float taper_hi, void* scratch, int slices,
                    int work, void* stream) {
  const AssemblyParams p =
      assembly_params(taps, t_pad, n_fft, apply_itd, apply_ild, align_guard,
                      max_shift, taper_lo, taper_hi);
  const auto s = static_cast<cudaStream_t>(stream);
  if (slices == 0) {
    const MacArgs a{static_cast<const int*>(idx),
                    static_cast<const float*>(w),
                    static_cast<const float*>(h_table),
                    static_cast<const float*>(delays),
                    static_cast<const float*>(gains),
                    static_cast<const float2*>(Xu),
                    static_cast<const float2*>(Xd),
                    static_cast<const float*>(first),
                    static_cast<float2*>(Y),
                    static_cast<const float2*>(twL),
                    static_cast<const float2*>(twN),
                    static_cast<const float*>(taper),
                    p,
                    rows,
                    run,
                    crossfade};
    return launch_register<kMacMinLog2>(p.log2n, p.log2L, threads,
                                        blocks_per_sm, a, s);
  }
  const int F = n_fft / 2 + 1;
  const SplitKernel kernel = assembly_mac_kernel;
  Launch l;
  const int err =
      launch_shape(kernel, (rows + run - 1) / run, slices, work,
                   n_fft / 2 + n_fft + 2 * p.L + 4 * F, &l);
  if (err) return err;
  kernel<<<l.grid, 1024, l.smem, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(h_table), static_cast<const float*>(delays),
      static_cast<const float*>(gains), static_cast<const float2*>(Xu),
      static_cast<const float2*>(Xd), static_cast<const float*>(first),
      static_cast<float2*>(Y), p, rows, run, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
