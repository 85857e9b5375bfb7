// Hand-written Hopper kernels of the two-launch block render: block
// spectra per (source, block) row, or mixed over sources per output block.
// Their inverse, `spectra_inverse`, is in spectra_inverse.cu.
//
// Replaces, in tinaural/ops/pallas_kernels.py:
//   fused_block_step  (_assembly_mac_s_kernel: forward four-step FFT of the
//                      raw block, filter assembly, crossfaded MAC) — the
//                      assembly stays in assemble_filters
//                      (assemble_filters.cu),
//                      as B1's port split it, and `block_spectra` below
//                      does the rest;
//   fused_block_step_mix  (the same step for every (source, block),
//                      accumulated over sources in the kernel: its grid
//                      revisits each output tile across a sequential source
//                      axis) — `block_spectra_mix` below, then the summing
//                      `spectra_inverse`.
// fused_block_step's dir_rate path (_block_spectra_core, _expand_rows: the
// chunk/k unique filters of a snapped track assembled, then each copied to
// its k blocks) is the row map ⌊b/k⌋ of both kernels below: assemble_filters
// assembles ⌈nb/k⌉ rows a source and no row is copied. The JAX package has
// no dir_rate in fused_block_step_mix; the port's scene route takes the
// same map there.
// fused_epilogue, the inverse FFT and OLA that follow both, is
// `spectra_inverse` (spectra_inverse.cu) and then the overlap_add kernel
// of block_render.cu over a leading source axis, which is what its
// `first` masks express.
// The TPU kernels work in the scrambled four-step layout and carry the
// previous filter and the OLA tails across their ordered grid. Here every
// row is independent: spectra are in natural order, H[s,b−1] is read from
// device memory (H[s,−1] := H[s,0], the `first[0] = 1` rule of
// pallas_kernels.py:837, for every source), and the OLA is a gather.
//
//   block_spectra    per (source, block) row: rfft_nfft of the up/down-
//                    ramped raw block (both ramps in one complex FFT),
//                    Y = Xu·H[s,b] + Xd·H[s,b−1]; without crossfade
//                    Y = X·H[s,b]. Block b reads filter row ⌊b/k⌋ of its
//                    source's ⌈nb/k⌉ (the dir_rate row map: one filter per
//                    group of k blocks, assembled once), and its previous
//                    filter is row ⌊(b−1)/k⌋, the same row inside a group;
//                    k ≥ nb is one filter per source (the static render).
//   block_spectra_mix  per (source chunk c, output block b): the forward
//                    FFT and MAC of block_spectra for each source of the
//                    chunk → one partial spectrum P[c, b]. CUDA blocks run
//                    in no order, so the TPU's sequential source axis
//                    becomes a loop inside the block plus a second pass
//                    over the C partials (the summing spectra_inverse); no
//                    atomics, so two calls give equal bits.
//
// Bound on the H100 by bytes: a row reads B samples and two filters (2·2·F
// complex64, the second mostly from L2 as the row before read it) and
// writes 2·F complex64; at (i)'s 8192 rows × n_fft 2048 that is 0.090 ms
// at 3.35 TB/s, and the mix kernel's partials at (b)'s 64 × 128 0.055 ms;
// their FFTs take 0.014 ms at 67 TFLOP/s fp32. The radix-2 bodies this
// replaces (one row per block, the twiddles rebuilt in every block, one
// barrier per radix-2 stage, the mix kernel's sums read-modified-written
// in shared memory behind a barrier per source) took 4–7× the bound. The
// register bodies, in the shared buffer mode at n_fft 128 … 16384
// (ops/step_plan.py):
//   forward      16 points a thread on T = n/16 threads a transform
//                (csrc/fft_reg.cuh): z = x·u + i·x·(1−u) (or x) of
//                t = lane + m·T straight into the first pass's input,
//                conjugated, as the register inverse conjugated is the
//                forward transform; twiddles from the host-built table
//                (ops/spectra_inverse.py `twiddles`), none computed here;
//                then one exchange to natural order;
//   MAC          thread `lane` owns bins k = lane + i·T (i < 8; lane 0
//                also n/2): it unpacks Xu, Xd from bins k and n − k and
//                reads H[s,b] and H[s,b−1] of both ears coalesced;
//   block_spectra      G rows per CUDA block, each on its own T threads and
//                exchange buffer (blocks of at least 128 threads: one row
//                from n_fft 2048 up, `spectra_rows`), Y written coalesced
//                from registers;
//   block_spectra_mix  one (chunk, block) per CUDA block in groups of T
//                threads, group j taking the chunk's sources j, j +
//                groups, … in order; each thread's 18 sums in its own
//                slice of shared memory beside its group's buffer (no
//                barrier; in registers at n_fft 16384, where the slices
//                would not fit); after the last source the block's threads
//                add the groups' sums in the order of the groups and
//                write P coalesced. ops/step_plan.py `mix_launch` picks
//                the chunk and the groups.
// Both ask __launch_bounds__ for two blocks of 512 threads an SM: 64
// registers a thread.
//
// Below n_fft 128, and in the split buffer mode (n_fft above 16384, or
// forced), the radix-2 bodies stay (namespace radix2): one row or (chunk,
// block) per CUDA block of 256 threads, their FFTs common.cuh fft_run.
// They share the register kernels' names, so a profile names both alike.

#include "fft_reg.cuh"

namespace {

constexpr int kStepMinLog2 = 7;  // 16 points on each of 8 threads
constexpr int kStepBlockThreads = 512;
constexpr int kRadix2Threads = 256;
constexpr int kAccSlots = 18;  // 9 bins × 2 ears per thread

// Rows (block_spectra) or groups (block_spectra_mix) of `threads` threads
// one register block holds at most. ops/step_plan.py `max_per_block`.
__host__ __device__ constexpr int step_max_per_block(int threads) {
  return threads >= kStepBlockThreads ? 1 : kStepBlockThreads / threads;
}

// Blocks per SM that __launch_bounds__ asks for: two of 512 threads, so
// 64 registers a thread, one at 1024. ops/step_plan.py `min_blocks`.
__host__ __device__ constexpr int step_min_blocks(int threads) {
  return threads >= 1024 ? 1 : 2;
}

// complex64 of shared memory of one row (block_spectra) or group
// (block_spectra_mix): its exchange buffer, and the mix kernel's 18 sums
// a thread beside it below n_fft 16384. ops/step_plan.py `step_plan`.
template <int kLog2N, bool kMix>
__host__ __device__ constexpr int step_unit_f2() {
  using P = RegPlan<kLog2N>;
  return P::row_f2 +
         (kMix && kLog2N < kRegMaxLog2N ? kAccSlots * P::threads : 0);
}

struct StepArgs {
  const float* x;    // (S, nb, B)
  const float2* H;   // (S·fnb, 2, F)
  float2* out;       // Y (S, nb, 2, F), or P (C, nb, 2, F)
  const float2* tw;  // exp(+2πi·m/n), m < n
  int S, nb, B, crossfade, dir_rate;
  int fnb;    // filter rows per source, ⌈nb/dir_rate⌉
  int chunk;  // block_spectra_mix: sources per chunk
};

// The forward transform of one block's B samples xb (none where xb is
// null: zeros) on the T threads of `lane`, into buf in natural order:
// buf[k] = Z[k], Z = fft_n(z), z = x·u + i·x·(1−u) (crossfade) or x,
// u = (i + 0.5)/B. buf is this row's or group's exchange buffer; every
// thread of the block calls this together (its passes hold barriers), and
// the caller has made sure that buf is no longer read.
template <int kLog2N>
__device__ __forceinline__ void forward_bins(const float* xb, int B,
                                             bool crossfade, float2* buf,
                                             int lane,
                                             const float2* __restrict__ tw) {
  using P = RegPlan<kLog2N>;
  constexpr int T = P::threads, R = P::radix(P::passes - 1), Ns = P::n / R;
  const float inv_B = 1.0f / B;
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t = lane + m * T;
    float2 z = make_float2(0.f, 0.f);
    if (xb != nullptr && t < B) {
      const float val = __ldg(xb + t);
      if (crossfade) {
        const float xu = val * ((t + 0.5f) * inv_B);
        z = make_float2(xu, xu - val);  // conj(x·u + i·x·(1−u))
      } else {
        z.x = val;
      }
    }
    v[m] = z;
  }
  dft<16>(v);
  reg_passes<kLog2N, 1>(v, buf, lane, tw);
  __syncthreads();  // the last pass has read buf
  // the last pass's sub-DFT j = lane + s·T holds bins j + q·Ns
#pragma unroll
  for (int s = 0; s < 16 / R; ++s)
#pragma unroll
    for (int q = 0; q < R; ++q)
      buf[lane + s * T + q * Ns] = conj(v[s * R + q]);
  __syncthreads();
}

// Bin k of both ears: Xu·Hc + Xd·Hp with Xu, Xd unpacked from bins k and
// n − k of buf (crossfade), else X·Hc.
__device__ __forceinline__ void mac_bin(const float2* buf, int k, int n,
                                        int F, bool crossfade,
                                        const float2* __restrict__ Hc,
                                        const float2* __restrict__ Hp,
                                        float2* y0, float2* y1) {
  if (crossfade) {
    float2 Xu, Xd;
    unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
    *y0 = cadd(cmul(Xu, __ldg(Hc + k)), cmul(Xd, __ldg(Hp + k)));
    *y1 = cadd(cmul(Xu, __ldg(Hc + F + k)), cmul(Xd, __ldg(Hp + F + k)));
  } else {
    const float2 X = buf[k];
    *y0 = cmul(X, __ldg(Hc + k));
    *y1 = cmul(X, __ldg(Hc + F + k));
  }
}

// Filter rows of block b of source s: its own, ⌊b/k⌋, and its
// predecessor's, the row before where b starts a group past block 0, else
// the same row (block 0 takes its own).
__device__ __forceinline__ const float2* filter_row(const StepArgs& a, int s,
                                                    int b, int F,
                                                    const float2** Hp) {
  const int hc = b / a.dir_rate;
  const float2* Hc = a.H + (static_cast<size_t>(s) * a.fnb + hc) * 2 * F;
  *Hp = b > 0 && b == hc * a.dir_rate ? Hc - 2 * F : Hc;
  return Hc;
}

// block_spectra's register body: G = blockDim.x / T rows per CUDA block,
// row r = blockIdx.x·G + (threadIdx.x / T); see the header comment.
template <int kLog2N>
__global__ void __launch_bounds__(
    RegPlan<kLog2N>::threads * step_max_per_block(RegPlan<kLog2N>::threads),
    step_min_blocks(RegPlan<kLog2N>::threads))
    block_spectra_kernel(const StepArgs a) {
  using P = RegPlan<kLog2N>;
  constexpr int n = P::n, T = P::threads, F = n / 2 + 1;
  static_assert(P::passes > 1 && P::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int grp = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  const int r = blockIdx.x * (blockDim.x / T) + grp;
  const bool live = r < a.S * a.nb;
  float2* buf = smem + grp * step_unit_f2<kLog2N, false>();
  forward_bins<kLog2N>(live ? a.x + static_cast<size_t>(r) * a.B : nullptr,
                       a.B, a.crossfade, buf, lane, a.tw);
  if (!live) return;

  const int s = r / a.nb;
  const float2* Hp;
  const float2* Hc = filter_row(a, s, r - s * a.nb, F, &Hp);
  float2* Y0 = a.out + static_cast<size_t>(r) * 2 * F;
#pragma unroll
  for (int i = 0; i <= 8; ++i) {
    if (i < 8 || lane == 0) {
      const int k = i < 8 ? lane + i * T : n / 2;
      float2 y0, y1;
      mac_bin(buf, k, n, F, a.crossfade, Hc, Hp, &y0, &y1);
      Y0[k] = y0;
      Y0[F + k] = y1;
    }
  }
}

// block_spectra_mix's register body: one (chunk c, output block b) per
// CUDA block, blockIdx.x = c·nb + b, in groups of T threads; see the
// header comment.
template <int kLog2N>
__global__ void __launch_bounds__(
    RegPlan<kLog2N>::threads * step_max_per_block(RegPlan<kLog2N>::threads),
    step_min_blocks(RegPlan<kLog2N>::threads))
    block_spectra_mix_kernel(const StepArgs a) {
  using P = RegPlan<kLog2N>;
  constexpr int n = P::n, T = P::threads, F = n / 2 + 1;
  constexpr int unit = step_unit_f2<kLog2N, true>();
  constexpr bool kSharedAcc = kLog2N < kRegMaxLog2N;
  static_assert(P::passes > 1 && P::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int groups = blockDim.x / T;
  const int grp = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  const int c = blockIdx.x / a.nb;
  const int b = blockIdx.x - c * a.nb;
  float2* buf = smem + grp * unit;  // the group's
  // both ears' sums at bins lane + i·T (i < 8) and, on lane 0, n/2
  // (i = 8): slot 2i + e, in this thread's slice of shared memory beside
  // buf (slot j at j·T + lane), or in registers
  float2 areg[kSharedAcc ? 1 : kAccSlots];
  float2* ash = buf + P::row_f2 + lane;
  auto acc = [&](int j) -> float2& {
    if constexpr (kSharedAcc) return ash[j * T];
    else return areg[j];
  };
#pragma unroll
  for (int j = 0; j < kAccSlots; ++j) acc(j) = make_float2(0.f, 0.f);

  // group grp takes the chunk's sources s0 + grp, s0 + grp + groups, …
  const int s0 = c * a.chunk;
  const int s_end = min(a.S, s0 + a.chunk);
  const int rounds = (s_end - s0 + groups - 1) / groups;
#pragma unroll 1
  for (int round = 0; round < rounds; ++round) {
    const int s = s0 + round * groups + grp;
    const bool live = s < s_end;
    // the twiddles are the same in every round: an opaque pointer keeps
    // the compiler from hoisting their loads out of the loop into
    // registers that spill (172 B a thread at n_fft 2048 with the hoist,
    // 68 B without; on an H100 0.186 ms against 0.171 at 64 sources × 128
    // blocks, PERF.md)
    const float2* tw = a.tw;
    asm volatile("" : "+l"(tw));
    __syncthreads();  // the last round's bins have been read
    forward_bins<kLog2N>(
        live ? a.x + (static_cast<size_t>(s) * a.nb + b) * a.B : nullptr,
        a.B, a.crossfade, buf, lane, tw);
    if (!live) continue;
    const float2* Hp;
    const float2* Hc = filter_row(a, s, b, F, &Hp);
#pragma unroll(kSharedAcc ? 1 : 9)
    for (int i = 0; i <= 8; ++i) {
      if (i < 8 || lane == 0) {
        const int k = i < 8 ? lane + i * T : n / 2;
        float2 y0, y1;
        mac_bin(buf, k, n, F, a.crossfade, Hc, Hp, &y0, &y1);
        acc(2 * i) = cadd(acc(2 * i), y0);
        acc(2 * i + 1) = cadd(acc(2 * i + 1), y1);
      }
    }
  }

  float2* P0 = a.out + static_cast<size_t>(blockIdx.x) * 2 * F;
  if constexpr (kSharedAcc) {
    // value e·F + k of P[c, b], the groups' sums added in order: bin k
    // lives in slot 2i + e of lane l, k = l + i·T (k = n/2 = 8T: lane 0,
    // i = 8)
    __syncthreads();  // every group's sums are in place
    for (int v = threadIdx.x; v < 2 * F; v += blockDim.x) {
      const int e = v >= F;
      const int k = v - e * F;
      const float2* slot = smem + P::row_f2 + (2 * (k / T) + e) * T + k % T;
      float2 sum = slot[0];
      for (int g = 1; g < groups; ++g) sum = cadd(sum, slot[g * unit]);
      P0[v] = sum;
    }
  } else {
    // one group: the block's threads are one transform's
#pragma unroll
    for (int i = 0; i <= 8; ++i) {
      if (i < 8 || lane == 0) {
        const int k = i < 8 ? lane + i * T : n / 2;
        P0[k] = acc(2 * i);
        P0[F + k] = acc(2 * i + 1);
      }
    }
  }
}

namespace radix2 {

// The radix-2 bodies, one row or (chunk, block) per CUDA block of
// kRadix2Threads threads, in either buffer mode of common.cuh.

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64, fnb = ⌈nb/k⌉ filter rows
// per source; Y: (S, nb, 2, F) complex64.
template <bool kSplit>
__global__ void block_spectra_kernel(const float* __restrict__ x,
                                     const float2* __restrict__ H,
                                     float2* __restrict__ Y, int S, int nb,
                                     int B, int n_fft, int dir_rate,
                                     int crossfade, float2* scratch,
                                     int work) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* buf =
      kSplit ? scratch + static_cast<size_t>(blockIdx.x) * n : wbuf;  // n

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  const float inv_B = 1.0f / B;
  const int fnb = (nb + dir_rate - 1) / dir_rate;
  for (int r = blockIdx.x; r < S * nb; r = next_row<kSplit>(r, S * nb)) {
    __syncthreads();  // the previous row is done with buf
    const int s = r / nb;
    const int b = r - s * nb;
    const float* xb = x + static_cast<size_t>(r) * B;
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

    const float2* Hc =
        H + (static_cast<size_t>(s) * fnb + b / dir_rate) * 2 * F;
    // the previous filter: the row before where b starts a group past
    // block 0, else the same row (block 0 takes its own)
    const float2* Hp = b > 0 && b % dir_rate == 0 ? Hc - 2 * F : Hc;
    float2* Y0 = Y + static_cast<size_t>(r) * 2 * F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      if (crossfade) {
        float2 Xu, Xd;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
        Y0[k] = cadd(cmul(Xu, Hc[k]), cmul(Xd, Hp[k]));
        Y0[F + k] = cadd(cmul(Xu, Hc[F + k]), cmul(Xd, Hp[F + k]));
      } else {
        const float2 X = buf[k];
        Y0[k] = cmul(X, Hc[k]);
        Y0[F + k] = cmul(X, Hc[F + k]);
      }
    }
  }
}

// x: (S, nb, B) f32; H: (S·fnb, 2, F) complex64, fnb = ⌈nb/k⌉;
// P: (C, nb, 2, F) complex64, C = ⌈S/chunk⌉, P[c, b] = Σ of Y[s, b] over the
// sources c·chunk ≤ s < (c+1)·chunk, added in order of s.
template <bool kSplit>
__global__ void block_spectra_mix_kernel(const float* __restrict__ x,
                                         const float2* __restrict__ H,
                                         float2* __restrict__ P, int S,
                                         int nb, int B, int n_fft,
                                         int dir_rate, int chunk,
                                         int crossfade, float2* scratch,
                                         int work) {
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
  const int rows = (S + chunk - 1) / chunk * nb;
  const int fnb = (nb + dir_rate - 1) / dir_rate;
  for (int r = blockIdx.x; r < rows; r = next_row<kSplit>(r, rows)) {
    const int c = r / nb;
    const int b = r - c * nb;
    __syncthreads();  // the previous row is done with buf and acc
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      acc0[k] = make_float2(0.f, 0.f);
      acc1[k] = make_float2(0.f, 0.f);
    }
    const int hc = b / dir_rate;
    // the previous filter: the row before where b starts a group past
    // block 0, else the same row (block 0 takes its own)
    const bool group_start = b > 0 && b == hc * dir_rate;
    const int s_end = min(S, (c + 1) * chunk);
    for (int s = c * chunk; s < s_end; ++s) {
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

      const float2* Hc = H + (static_cast<size_t>(s) * fnb + hc) * 2 * F;
      const float2* Hp = group_start ? Hc - 2 * F : Hc;
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
    // each thread wrote the bins it reads back: no barrier needed
    float2* P0 = P + static_cast<size_t>(r) * 2 * F;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      P0[k] = acc0[k];
      P0[F + k] = acc1[k];
    }
  }
}

using SpectraKernel = void (*)(const float*, const float2*, float2*, int, int,
                               int, int, int, int, float2*, int);
using MixKernel = void (*)(const float*, const float2*, float2*, int, int,
                           int, int, int, int, int, float2*, int);

}  // namespace radix2

// The register kernel for n = 2^kLog2N (kMix: block_spectra_mix), checked
// against the caller's plan: T threads per row or group, 1 ≤ per_block ≤
// the most, the blocks per SM of __launch_bounds__, a twiddle table.
template <int kLog2N, bool kMix>
int launch_register(int log2n, int threads, int per_block, int blocks_per_sm,
                    int grid, const StepArgs& a, cudaStream_t stream) {
  if constexpr (kLog2N > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_register<kLog2N + 1, kMix>(log2n, threads, per_block,
                                               blocks_per_sm, grid, a, stream);
    using P = RegPlan<kLog2N>;
    if (threads != P::threads || per_block < 1 ||
        per_block > step_max_per_block(P::threads) ||
        blocks_per_sm != step_min_blocks(P::threads) || a.tw == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(StepArgs);
    if constexpr (kMix)
      kernel = block_spectra_mix_kernel<kLog2N>;
    else
      kernel = block_spectra_kernel<kLog2N>;
    const int smem = per_block * step_unit_f2<kLog2N, kMix>() *
                     static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (grid > 0) kernel<<<grid, per_block * P::threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// The radix-2 body takes one row per block of kRadix2Threads threads.
bool radix2_plan_ok(int threads, int per_block, int blocks_per_sm) {
  return threads == kRadix2Threads && per_block == 1 && blocks_per_sm == 1;
}

bool register_size(int n_fft) {
  return n_fft >= (1 << kStepMinLog2) && n_fft <= (1 << kRegMaxLog2N);
}

}  // namespace

extern "C" {

// x: (S, nb, B) f32; H: (S·⌈nb/k⌉, 2, F) complex64, k = dir_rate; Y:
// (S, nb, 2, F) complex64. slices > 0: split mode (the radix-2 body),
// scratch holds slices · n_fft complex64. Otherwise, at 128 ≤ n_fft ≤
// 16384, the register body: tw the table of exp(+2πi·m/n), threads the
// plan's T, rows_per_block its G and blocks_per_sm its figure
// (ops/step_plan.py `step_plan`, `spectra_rows`); below 128 the radix-2
// body. The radix-2 body takes threads 256, one row per block and 1 block
// per SM. Any other plan launches nothing.
int tt_block_spectra(const void* x, const void* H, void* Y, const void* tw,
                     int S, int nb, int B, int n_fft, int dir_rate,
                     int crossfade, int threads, int rows_per_block,
                     int blocks_per_sm, void* scratch, int slices, int work,
                     void* stream) {
  if (dir_rate < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (slices == 0 && register_size(n_fft)) {
    const int rows = S * nb;
    const StepArgs a{static_cast<const float*>(x),
                     static_cast<const float2*>(H),
                     static_cast<float2*>(Y),
                     static_cast<const float2*>(tw),
                     S,
                     nb,
                     B,
                     crossfade,
                     dir_rate,
                     (nb + dir_rate - 1) / dir_rate,
                     0};
    const int grid =
        rows_per_block > 0 ? (rows + rows_per_block - 1) / rows_per_block : 0;
    return launch_register<kStepMinLog2, false>(ilog2(n_fft), threads,
                                                rows_per_block,
                                                blocks_per_sm, grid, a, st);
  }
  if (!radix2_plan_ok(threads, rows_per_block, blocks_per_sm) ||
      (slices == 0 && n_fft > (1 << kRegMaxLog2N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const radix2::SpectraKernel kernel =
      slices > 0 ? radix2::block_spectra_kernel<true>
                 : radix2::block_spectra_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, S * nb, slices, work, n_fft / 2 + n_fft, &l);
  if (err) return err;
  kernel<<<l.grid, kRadix2Threads, l.smem, st>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float2*>(Y), S, nb, B, n_fft, dir_rate, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// x: (S, nb, B) f32; H: (S·⌈nb/k⌉, 2, F) complex64, k = dir_rate; P:
// (⌈S/chunk⌉, nb, 2, F) complex64. slices > 0: split mode (the radix-2
// body), scratch holds slices · (n_fft + 2F) complex64. Otherwise, at
// 128 ≤ n_fft ≤ 16384, the register body: tw as in tt_block_spectra,
// threads the plan's T, groups its groups per block and blocks_per_sm its
// figure (ops/step_plan.py `step_plan`, `mix_launch`, `mix_groups`); below
// 128 the radix-2 body, which takes threads 256, groups 1 and 1 block per
// SM. Any other plan launches nothing.
int tt_block_spectra_mix(const void* x, const void* H, void* P,
                         const void* tw, int S, int nb, int B, int n_fft,
                         int dir_rate, int chunk, int crossfade, int threads,
                         int groups, int blocks_per_sm, void* scratch,
                         int slices, int work, void* stream) {
  if (dir_rate < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = (S + chunk - 1) / chunk * nb;
  if (slices == 0 && register_size(n_fft)) {
    const StepArgs a{static_cast<const float*>(x),
                     static_cast<const float2*>(H),
                     static_cast<float2*>(P),
                     static_cast<const float2*>(tw),
                     S,
                     nb,
                     B,
                     crossfade,
                     dir_rate,
                     (nb + dir_rate - 1) / dir_rate,
                     chunk};
    return launch_register<kStepMinLog2, true>(ilog2(n_fft), threads, groups,
                                               blocks_per_sm, rows, a, st);
  }
  if (!radix2_plan_ok(threads, groups, blocks_per_sm) ||
      (slices == 0 && n_fft > (1 << kRegMaxLog2N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int F = n_fft / 2 + 1;
  const radix2::MixKernel kernel =
      slices > 0 ? radix2::block_spectra_mix_kernel<true>
                 : radix2::block_spectra_mix_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, rows, slices, work, n_fft / 2 + n_fft + 2 * F, &l);
  if (err) return err;
  kernel<<<l.grid, kRadix2Threads, l.smem, st>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float2*>(P), S, nb, B, n_fft, dir_rate, chunk, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
