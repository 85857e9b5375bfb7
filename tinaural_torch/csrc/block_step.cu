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
// Above n_fft 16384 (n = P·Q, Q = max(next_pow2(B), 128) ≤ 16384) both
// run their pruned bodies (namespace pruned): the block is B samples
// zero-padded to n, so for residue r < P and m < Q
//   X[r + P·m] = Σ_{t<Q} (x[t]·ω_n^{r·t})·ω_Q^{m·t},
// P independent Q-point transforms of the pre-twiddled block, each the
// register FFT above (the pre-twiddle ω_n^{r·lane}·ω_n^{r·m·T} from the
// n-point table): 5·n·log2 Q operations instead of 5·n·log2 n, no
// scratch and no cluster. Without crossfade the mix packs two sources' real blocks into
// each transform (x + i·x2, unpacked as the crossfade's two ramps are).
// A CUDA block takes one row (or one (chunk, block)) and a group of
// residue pairs r, P − r, whose transforms hold each other's mirror bins;
// see the pruned namespace. ops/step_plan.py `pruned_plan`. Bounds: at
// 1024 rows × n_fft 32768 (a 2^20-sample static render on a 16,384-tap
// table) block_spectra writes 268 MB of Y, 0.0815 ms at 3.35 TB/s; the
// mix at 64 sources × 128 blocks is bound by its transforms under one
// filter a source, 0.232 ms at 67 TFLOP/s, and by H's 2.15 GB under one
// a block, 0.70 ms; the first cut runs 4.5×, 9× and 7× those (PERF.md).
//
// Below n_fft 128, in the split buffer mode (forced, or Q above 16384),
// the radix-2 bodies stay (namespace radix2): one row or (chunk, block)
// per CUDA block of 256 threads, their FFTs common.cuh fft_run.
// All three share the kernels' names, so a profile names them alike.

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
// kPre (the pruned mode): without crossfade z = x + i·x2, the block x2
// (the mix's next source; none where null) packed beside x; and z[t] is
// first multiplied by ω_n^(−r·t), conj'd as tw_n[r·lane]·tw_n[r·m·T]
// (pre: the n-point table, r < n/2^kLog2N, so both indices are below n),
// which makes buf the 2^kLog2N-point transform of residue r: bins
// r + P·m.
template <int kLog2N, bool kPre = false>
__device__ __forceinline__ void forward_bins(
    const float* xb, int B, bool crossfade, float2* buf, int lane,
    const float2* __restrict__ tw, const float2* __restrict__ pre = nullptr,
    int r = 0, const float* x2 = nullptr) {
  using P = RegPlan<kLog2N>;
  constexpr int T = P::threads, R = P::radix(P::passes - 1), Ns = P::n / R;
  const float inv_B = 1.0f / B;
  // the pre-twiddle of t = lane + m·T as ω_n^(r·lane)·ω_n^(r·m·T): one
  // load of the first a thread, and of the second one address a
  // transform (all its threads read the same), not 16 scattered loads
  float2 w_lane = make_float2(1.f, 0.f);
  if constexpr (kPre) w_lane = __ldg(pre + r * lane);
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
        if (kPre && x2 != nullptr) z.y = -__ldg(x2 + t);  // conj(x + i·x2)
      }
      if constexpr (kPre) z = cmul(cmul(z, w_lane), __ldg(pre + r * m * T));
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

namespace pruned {

// The pruned bodies (n = n_fft above 16384; see the header comment):
// residue r < P of a block of B ≤ Q samples is the Q-point transform
// Z_r[m] = Z[r + P·m] of the pre-twiddled block (forward_bins<·, true>).
// Under crossfade a transform holds both ramps of one block, z = x·u +
// i·x·(1 − u), unpacked at bin k from Z[k] and Z[n − k] (common.cuh
// unpack_pair) and MAC'd as Xu·H[s,⌊b/k⌋] + Xd·H[s,⌊(b−1)/k⌋]; without
// it the mix packs two sources' blocks, z = x_s + i·x_{s+1}, each under
// its own filter, so a real block costs half a transform set there, and
// block_spectra transforms its real block alone. Z[n − k] lies in
// transform P − r at Q − 1 − m, so a block holds whole pairs: pair p is
// residues p and P − p, pair 0 residues 0 and P/2 (each its own mirror).
// Residue group j is pairs j·g … j·g + g − 1, each transform on its own
// T = Q/16 threads and buffer (slot u < g: residue j·g + u; slot g + u:
// its mirror). Each residue owns bins m < Q/2 of its transform, residue 0
// also m = Q/2 (k = n/2): F in all. The MAC walks the group's outputs so
// that g consecutive threads take g consecutive bins (the mirrors' run
// ascending too), their H reads and Y (or P) writes on neighbouring
// addresses. At Q = 16384 a pair (2 × 1024 threads) does not fit one
// block: a block takes one residue r (g = 1/2) and, where it unpacks,
// first runs its mirror's transform, keeping the half of it that r's
// bins pair with (Q/2 complex64 beside the buffer).

constexpr int kSpectraThreads = 512;  // block_spectra's block, Q ≤ 4096
constexpr int kMixThreads = 256;      // block_spectra_mix's, Q ≤ 2048
// outputs a thread: g·Q over 2g·Q/16 threads (Q/2 over Q/16 at Q = 16384)
constexpr int kBins = 8;

template <int kLog2Q, bool kMix>
struct Plan {
  using R = RegPlan<kLog2Q>;
  static constexpr int Q = R::n, T = R::threads;
  static constexpr bool half = kLog2Q == kRegMaxLog2N;  // one residue a block
  static constexpr int aim = kMix ? kMixThreads : kSpectraThreads;
  static constexpr int pairs = half || 2 * T >= aim ? 1 : aim / (2 * T);
  static constexpr int residues = half ? 1 : 2 * pairs;  // slots a block
  static constexpr int threads = residues * T;
  static constexpr int min_blocks = 1024 / threads;  // 64 registers a thread
  // one float2 past each padded buffer, so that the MAC's g slots at one
  // m fall on distinct banks
  static constexpr int slot_f2 = R::row_f2 + 1;
  static constexpr int mirror_f2 = half ? Q / 2 : 0;
  // the mix kernel's 18 sums a thread in shared memory up to Q = 4096,
  // in registers above, where the slices would not fit
  static constexpr bool shared_acc = kMix && kLog2Q < kRegMaxLog2N - 1;
  static constexpr int shared_f2 = residues * slot_f2 + mirror_f2 +
                                   (shared_acc ? kAccSlots * threads : 0);
  static_assert(half || kBins * threads == pairs * Q, "8 bins a thread");
};

// log2 Q of a block of B samples: Q = max(next_pow2(B), 128).
inline int log2q(int B) {
  int l = kStepMinLog2;
  while ((1 << l) < B) ++l;
  return l;
}

// The residue that slot u of residue group j transforms.
template <class L>
__device__ __forceinline__ int slot_residue(int u, int j, int P) {
  const int p = j * L::pairs + (u < L::pairs ? u : u - L::pairs);
  return u < L::pairs ? p : (p ? P - p : P / 2);
}

// Output v < g·Q of residue group j: its bin k and the shared offsets of
// Z[k] and Z[n − k] (slot·slot_f2 + index).
struct Bin {
  int k, at, mirror_at;
};

template <class L>
__device__ __forceinline__ Bin pruned_bin(int v, int j, int P) {
  constexpr int g = L::pairs, Q = L::Q, side_n = g * (Q / 2);
  const int side = v >= side_n;  // 0: residue p, 1: its mirror
  const int w = v - side * side_n;
  const int m = w / g, i = w % g;
  const int pi = side ? g - 1 - i : i;  // the mirrors' bins ascend in i
  const int p = j * g + pi;
  const int u = side * g + pi;
  const int r = side ? (p ? P - p : P / 2) : p;
  Bin b;
  b.k = r + P * m;
  b.at = u * L::slot_f2 + m;
  // pair 0's residues are their own mirrors; residue 0 at (Q − m) mod Q
  b.mirror_at = p ? ((1 - side) * g + pi) * L::slot_f2 + (Q - 1 - m)
                  : u * L::slot_f2 + (side ? Q - 1 - m : (Q - m) & (Q - 1));
  return b;
}

// The Q = 16384 body's bin m ≤ Q/2 of residue r: Z[k] from the buffer
// (transform r), and Z[n − k] from it where r is its own mirror, else from
// the upper half of transform P − r kept beside it (half_forward).
template <class L>
__device__ __forceinline__ Bin half_bin(int m, int r, int P) {
  constexpr int Q = L::Q;
  Bin b;
  b.k = r + P * m;
  b.at = m;
  b.mirror_at = r == 0 ? (Q - m) & (Q - 1)
                : 2 * r == P ? Q - 1 - m
                             : L::slot_f2 + Q / 2 - 1 - m;
  return b;
}

// The Q = 16384 body's transforms of the blocks x (and x2) for residue r:
// where its bins are unpacked (``unpack``) and r is not its own mirror,
// the mirror's first, the upper half kept beside the buffer; then r's
// into buf. Called by every thread together, buf and the kept half no
// longer read.
template <class L>
__device__ __forceinline__ void half_forward(const StepArgs& a,
                                             const float* x, const float* x2,
                                             int r, int P, bool unpack,
                                             float2* buf, const float2* tw,
                                             const float2* twq) {
  constexpr int Q = L::Q;
  if (unpack && r != 0 && 2 * r != P) {
    forward_bins<kRegMaxLog2N, true>(x, a.B, a.crossfade, buf, threadIdx.x,
                                     twq, tw, P - r, x2);
    for (int t = threadIdx.x; t < Q / 2; t += L::threads)
      buf[L::slot_f2 + t] = buf[Q / 2 + t];
    __syncthreads();  // buf is rewritten by r's transform
  }
  forward_bins<kRegMaxLog2N, true>(x, a.B, a.crossfade, buf, threadIdx.x,
                                   twq, tw, r, x2);
}

// Both ears' X·H at bin k of filter row H.
__device__ __forceinline__ void mac_one(float2 X, const float2* __restrict__ H,
                                        int k, int F, float2* y0, float2* y1) {
  *y0 = cmul(X, __ldg(H + k));
  *y1 = cmul(X, __ldg(H + F + k));
}

// The two signals of bin q of the block's array, unpacked.
__device__ __forceinline__ void unpack_bin(const float2* smem, const Bin& q,
                                           float2* A, float2* B) {
  unpack_pair(smem[q.at], smem[q.mirror_at], A, B);
}

// block_spectra's pruned body: blockIdx.x = row·(P/residues) + j. Under
// crossfade each bin unpacks both ramps; without it the transform holds
// the real block alone and bin k is Z[k]·H. (A second row packed beside
// it would halve the transforms, but its doubled stores cost more than
// that saves: 0.510 against 0.366 ms a call at 1024 rows × n_fft 32768 on
// an H100, scripts/torch_step_ab.py --pruned.) Bins of the group's
// outputs (or, at Q = 16384, of residue j) with their array offsets from
// `pruned_bin` or `half_bin`.
template <int kLog2Q>
__global__ void __launch_bounds__(Plan<kLog2Q, false>::threads,
                                  Plan<kLog2Q, false>::min_blocks)
    block_spectra_kernel(const StepArgs a, const float2* __restrict__ twq,
                         int P) {
  using L = Plan<kLog2Q, false>;
  constexpr int Q = L::Q, T = L::T;
  extern __shared__ float2 smem[];
  const int n = P * Q, F = n / 2 + 1;
  const int groups = P / L::residues;
  const int row = blockIdx.x / groups;
  const int j = blockIdx.x - row * groups;
  const float* x = a.x + static_cast<size_t>(row) * a.B;
  const int s = row / a.nb;
  const float2* Hp;
  const float2* Hc = filter_row(a, s, row - s * a.nb, F, &Hp);
  float2* Y0 = a.out + static_cast<size_t>(row) * 2 * F;
  if constexpr (L::half) {
    half_forward<L>(a, x, nullptr, j, P, a.crossfade, smem, a.tw, twq);
  } else {
    const int u = threadIdx.x / T;
    forward_bins<kLog2Q, true>(x, a.B, a.crossfade, smem + u * L::slot_f2,
                               threadIdx.x % T, twq, a.tw,
                               slot_residue<L>(u, j, P));
  }
  // output i of this thread (i = kBins: bin n/2, residue 0's m = Q/2)
  const bool nyq = j == 0 && threadIdx.x == 0;
#pragma unroll
  for (int i = 0; i <= kBins; ++i) {
    if (i < kBins || nyq) {
      Bin q;
      if (L::half || i == kBins)
        q = half_bin<L>(i < kBins ? threadIdx.x + i * T : Q / 2, j, P);
      else
        q = pruned_bin<L>(threadIdx.x + i * L::threads, j, P);
      float2 y0, y1;
      if (a.crossfade) {
        float2 A, Bv, z0, z1;
        unpack_bin(smem, q, &A, &Bv);
        mac_one(A, Hc, q.k, F, &y0, &y1);
        mac_one(Bv, Hp, q.k, F, &z0, &z1);
        y0 = cadd(y0, z0);
        y1 = cadd(y1, z1);
      } else {
        mac_one(smem[q.at], Hc, q.k, F, &y0, &y1);
      }
      Y0[q.k] = y0;
      Y0[F + q.k] = y1;
    }
  }
}

// block_spectra_mix's pruned body: blockIdx.x = (c·nb + b)·(P/residues) + j,
// the chunk's sources in order, one a transform set under crossfade, else
// two (the second's filter in place of the predecessor's); each thread's
// sums of its bins (slot 2i + e of output i, ear e; slots 16, 17 bin
// n/2) in its slice of shared memory or in registers, written to P[c, b]
// at the end.
template <int kLog2Q>
__global__ void __launch_bounds__(Plan<kLog2Q, true>::threads,
                                  Plan<kLog2Q, true>::min_blocks)
    block_spectra_mix_kernel(const StepArgs a, const float2* __restrict__ twq,
                             int P) {
  using L = Plan<kLog2Q, true>;
  constexpr int Q = L::Q, T = L::T;
  constexpr bool kSharedAcc = L::shared_acc;
  extern __shared__ float2 smem[];
  const int n = P * Q, F = n / 2 + 1;
  const int groups = P / L::residues;
  const int cb = blockIdx.x / groups;  // c·nb + b
  const int j = blockIdx.x - cb * groups;
  const int c = cb / a.nb;
  const int b = cb - c * a.nb;
  const bool nyq = j == 0 && threadIdx.x == 0;  // also bin n/2
  float2 areg[kSharedAcc ? 1 : kAccSlots];
  float2* ash = smem + L::residues * L::slot_f2 + L::mirror_f2 + threadIdx.x;
  auto acc = [&](int i) -> float2& {
    if constexpr (kSharedAcc) return ash[i * L::threads];
    else return areg[i];
  };
#pragma unroll
  for (int i = 0; i < kAccSlots; ++i) acc(i) = make_float2(0.f, 0.f);

  const int s_end = min(a.S, (c + 1) * a.chunk);
  const int step = a.crossfade ? 1 : 2;
#pragma unroll 1
  for (int s = c * a.chunk; s < s_end; s += step) {
    // the tables are the same for every source: opaque pointers keep their
    // loads from being hoisted out of the loop into registers that spill
    const float2* tw = a.tw;
    const float2* twq_s = twq;
    asm volatile("" : "+l"(tw), "+l"(twq_s));
    __syncthreads();  // the last sources' bins have been read
    const float* x = a.x + (static_cast<size_t>(s) * a.nb + b) * a.B;
    const bool two = !a.crossfade && s + 1 < s_end;
    const float* x2 = two ? x + static_cast<size_t>(a.nb) * a.B : nullptr;
    const float2* Hp;
    const float2* Hc = filter_row(a, s, b, F, &Hp);
    if (!a.crossfade) {  // the second source's filter, or none
      const float2* unused;
      Hp = two ? filter_row(a, s + 1, b, F, &unused) : Hc;
    }
    if constexpr (L::half) {
      half_forward<L>(a, x, x2, j, P, true, smem, tw, twq_s);
    } else {
      const int u = threadIdx.x / T;
      forward_bins<kLog2Q, true>(x, a.B, a.crossfade, smem + u * L::slot_f2,
                                 threadIdx.x % T, twq_s, tw,
                                 slot_residue<L>(u, j, P), x2);
    }
#pragma unroll(kSharedAcc ? 1 : kBins + 1)
    for (int i = 0; i <= kBins; ++i) {
      if (i < kBins || nyq) {
        Bin q;
        if (L::half || i == kBins)
          q = half_bin<L>(i < kBins ? threadIdx.x + i * T : Q / 2, j, P);
        else
          q = pruned_bin<L>(threadIdx.x + i * L::threads, j, P);
        float2 A, Bv, y0, y1, z0, z1;
        unpack_bin(smem, q, &A, &Bv);
        mac_one(A, Hc, q.k, F, &y0, &y1);
        // Xd·H[s,⌊(b−1)/k⌋], or the second source's X·H (0 for a lone one)
        mac_one(Bv, Hp, q.k, F, &z0, &z1);
        acc(2 * i) = cadd(acc(2 * i), cadd(y0, z0));
        acc(2 * i + 1) = cadd(acc(2 * i + 1), cadd(y1, z1));
      }
    }
  }

  // each thread writes the bins it summed: no barrier needed
  float2* P0 = a.out + static_cast<size_t>(cb) * 2 * F;
#pragma unroll
  for (int i = 0; i <= kBins; ++i) {
    if (i < kBins || nyq) {
      int k;
      if (L::half || i == kBins)
        k = half_bin<L>(i < kBins ? threadIdx.x + i * T : Q / 2, j, P).k;
      else
        k = pruned_bin<L>(threadIdx.x + i * L::threads, j, P).k;
      P0[k] = acc(2 * i);
      P0[F + k] = acc(2 * i + 1);
    }
  }
}

// The pruned kernel for Q = 2^kLog2Q (kMix: block_spectra_mix) over
// `rows` rows (block_spectra) or (chunk, block) pairs, checked against the
// caller's plan: the block's threads and residues, the blocks per SM of
// __launch_bounds__, both twiddle tables, P = n/Q a multiple of the
// residues.
template <int kLog2Q, bool kMix>
int launch(int log2q, int threads, int residues, int blocks_per_sm, int rows,
           const StepArgs& a, const float2* twq, int P, cudaStream_t stream) {
  if constexpr (kLog2Q > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2q != kLog2Q)
      return launch<kLog2Q + 1, kMix>(log2q, threads, residues, blocks_per_sm,
                                      rows, a, twq, P, stream);
    using L = Plan<kLog2Q, kMix>;
    if (threads != L::threads || residues != L::residues ||
        blocks_per_sm != L::min_blocks || a.tw == nullptr || twq == nullptr ||
        P < 2 || P % L::residues != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(StepArgs, const float2*, int);
    if constexpr (kMix)
      kernel = block_spectra_mix_kernel<kLog2Q>;
    else
      kernel = block_spectra_kernel<kLog2Q>;
    const int smem = L::shared_f2 * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = static_cast<long long>(rows) * (P / L::residues);
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    if (grid > 0)
      kernel<<<static_cast<int>(grid), L::threads, smem, stream>>>(a, twq, P);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace pruned

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
// (ops/step_plan.py `step_plan`, `spectra_rows`); above 16384 the pruned
// body for Q = max(next_pow2(B), 128) ≤ 16384: tw as above, twq the
// Q-point table, threads the block's, rows_per_block its residues and
// blocks_per_sm its figure (`pruned_plan`); below 128 the radix-2 body.
// The radix-2 body takes threads 256, one row per block and 1 block per
// SM. Any other plan launches nothing.
int tt_block_spectra(const void* x, const void* H, void* Y, const void* tw,
                     const void* twq, int S, int nb, int B, int n_fft,
                     int dir_rate, int crossfade, int threads,
                     int rows_per_block, int blocks_per_sm, void* scratch,
                     int slices, int work, void* stream) {
  if (dir_rate < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
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
  if (slices == 0 && register_size(n_fft)) {
    const int grid =
        rows_per_block > 0 ? (rows + rows_per_block - 1) / rows_per_block : 0;
    return launch_register<kStepMinLog2, false>(ilog2(n_fft), threads,
                                                rows_per_block,
                                                blocks_per_sm, grid, a, st);
  }
  if (slices == 0 && n_fft > (1 << kRegMaxLog2N)) {
    const int lq = pruned::log2q(B);
    return pruned::launch<kStepMinLog2, false>(
        lq, threads, rows_per_block, blocks_per_sm, rows, a,
        static_cast<const float2*>(twq), n_fft >> lq, st);
  }
  if (!radix2_plan_ok(threads, rows_per_block, blocks_per_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  const radix2::SpectraKernel kernel =
      slices > 0 ? radix2::block_spectra_kernel<true>
                 : radix2::block_spectra_kernel<false>;
  Launch l;
  const int err =
      launch_shape(kernel, rows, slices, work, n_fft / 2 + n_fft, &l);
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
// figure (ops/step_plan.py `step_plan`, `mix_launch`, `mix_groups`); above
// 16384 the pruned body as in tt_block_spectra, groups its residues; below
// 128 the radix-2 body, which takes threads 256, groups 1 and 1 block per
// SM. Any other plan launches nothing.
int tt_block_spectra_mix(const void* x, const void* H, void* P,
                         const void* tw, const void* twq, int S, int nb,
                         int B, int n_fft, int dir_rate, int chunk,
                         int crossfade, int threads, int groups,
                         int blocks_per_sm, void* scratch, int slices,
                         int work, void* stream) {
  if (dir_rate < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = (S + chunk - 1) / chunk * nb;
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
  if (slices == 0 && register_size(n_fft))
    return launch_register<kStepMinLog2, true>(ilog2(n_fft), threads, groups,
                                               blocks_per_sm, rows, a, st);
  if (slices == 0 && n_fft > (1 << kRegMaxLog2N)) {
    const int lq = pruned::log2q(B);
    return pruned::launch<kStepMinLog2, true>(
        lq, threads, groups, blocks_per_sm, rows, a,
        static_cast<const float2*>(twq), n_fft >> lq, st);
  }
  if (!radix2_plan_ok(threads, groups, blocks_per_sm))
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
