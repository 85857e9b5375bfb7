// Hand-written Hopper kernel `block_spectra_mix_inverse`: the crossfaded
// MAC of every source's block against its filters, the mixdown over the
// sources and the packed inverse of both ears, x (S, nb, B) f32 and H (S,
// nb, 2, F) complex64 → frames (nb, 2, n_fft) f32:
//   frames[b, e] = irfft(Σ_s Xu[s,b]·H[s,b,e] + Xd[s,b]·H[s,b−1,e]),
// Xu = rfft(x·u), Xd = rfft(x·(1−u)), u = (i + 0.5)/B, H[s,−1] := H[s,0];
// without crossfade Σ_s rfft(x)·H[s,b,e].
//
// Replaces the MAC, mixdown and inverse of tinaural/ops/pallas_kernels.py
// fused_block_render (:1089; _block_spectra_core and _inverse_ola_core).
// The TPU kernel carries the mixdown across its sequential source axis;
// here one CUDA block loops over the sources in order (deterministic, no
// atomics). block_render.cu's header says how the block render's map is
// split over its three kernels.
//
// Bound on the H100 by bytes: a block b reads S·B samples and 2·S·F
// complex64 of H twice (H[s,b] and H[s,b−1], once each from device memory
// and once more from L2 over the whole grid) and writes 2·n floats; at
// (a)'s 8192 rows × n_fft 2048 that is 0.090 ms at 3.35 TB/s. Its FFTs
// (S + 1 per block) take 0.025 ms at 67 TFLOP/s fp32. The radix-2 body this
// replaces (one shared-memory FFT per source with a barrier per stage and
// twiddles rebuilt in every block) took 8.5× the bound. This design, in the
// shared buffer mode (n_fft ≤ 16384; ops/render_plan.py `mix_plan`):
//   threads      one output block b per CUDA block, in groups of T = n/16
//                threads, 16 points each in registers (csrc/fft_reg.cuh);
//                group g takes the sources g, g + groups, … in order. One
//                group where the nb blocks fill the card; where they do
//                not, up to 512 threads' worth (ops/render_plan.py
//                `mix_groups`: 4 at 64 sources × 128 blocks, whose 128
//                blocks of 4 warps left one warp per SM quadrant);
//   forward      per source, z = x·u + i·x·(1−u) (or x) of t = lane + m·T
//                straight into the first pass's input, conjugated: the
//                register inverse conjugated is the forward transform;
//                then one exchange to natural order;
//   MAC          thread `lane` owns bins k = lane + i·T (i < 8; lane 0 also
//                n/2): it unpacks Xu, Xd from bins k and n − k and adds
//                Xu·H[s,b] + Xd·H[s,b−1] of both ears, read coalesced, to
//                its 18 accumulators, kept in its own slice of shared
//                memory beside the group's buffer (no barrier; in registers
//                they spilled 300–500 B a thread) and at n_fft 16384, where
//                the slices would not fit, in registers;
//   inverse      after the last source, groups 1, … hand their sums to
//                group 0 through shared memory, which adds them in order,
//                packs Z = A + i·B at its bins k and n − k, and after one
//                exchange runs the register inverse, writing ear 0 as
//                Re z / n and ear 1 as Im z / n, coalesced.
// Twiddles come from the host-built table (ops/spectra_inverse.py
// `twiddles`): no block computes a twiddle.
//
// The split buffer mode (n_fft above 16384, or forced) keeps the radix-2
// body over the block's device scratch slice (n_fft + 2F complex64), 512
// threads, the blocks walking the output blocks. It shares the register
// kernel's name, so a profile names both alike.

#include "fft_reg.cuh"

namespace {

constexpr int kMixMinLog2 = 7;  // 16 points on each of 8 threads
constexpr int kAccSlots = 18;   // 9 bins × 2 ears per thread

// complex64 of shared memory of one group: its exchange buffer, and below
// n_fft 16384 each thread's 18 accumulators beside it (at 16384 they stay
// in registers: the slices would not fit). ops/render_plan.py `mix_plan`
// computes the same.
template <int kLog2N>
__host__ __device__ constexpr int mix_group_f2() {
  using P = RegPlan<kLog2N>;
  return P::row_f2 + (kLog2N < kRegMaxLog2N ? kAccSlots * P::threads : 0);
}

// Groups of T threads one block may hold: 512 threads' worth.
__host__ __device__ constexpr int mix_max_groups(int threads) {
  return threads >= 512 ? 1 : 512 / threads;
}

// Blocks per SM that __launch_bounds__ asks for: two of 512 threads, so
// 64 registers a thread (at 128, 0.36 ms against 0.28 at (a)'s 8192
// rows, scripts/torch_block_render_sweep.py; 64 B of spills remain), one
// at 1024. ops/render_plan.py `mix_plan` computes the same.
__host__ __device__ constexpr int mix_min_blocks(int threads) {
  return threads >= 1024 ? 1 : 2;
}

struct MixArgs {
  const float* x;   // (S, nb, B)
  const float2* H;  // (S·nb, 2, F)
  float* frames;    // (nb, 2, n)
  const float2* tw;  // exp(+2πi·m/n), m < n
  int S, nb, B, crossfade;
};

// The shared buffer mode: one output block per CUDA block of `groups`
// groups of T = n/16 threads; see the header comment.
template <int kLog2N>
__global__ void __launch_bounds__(RegPlan<kLog2N>::threads *
                                      mix_max_groups(RegPlan<kLog2N>::threads),
                                  mix_min_blocks(RegPlan<kLog2N>::threads))
    block_spectra_mix_inverse_kernel(const MixArgs a) {
  using P = RegPlan<kLog2N>;
  constexpr int n = P::n, T = P::threads, F = n / 2 + 1;
  constexpr int R = P::radix(P::passes - 1), Ns = n / R;
  constexpr bool kSharedAcc = kLog2N < kRegMaxLog2N;
  static_assert(P::passes > 1 && P::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int groups = blockDim.x / T;
  const int grp = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  const int b = blockIdx.x;
  float2* buf = smem + grp * mix_group_f2<kLog2N>();  // the group's
  const float inv_B = 1.0f / a.B;
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

  // group grp takes the sources grp, grp + groups, … in order
  const int rounds = (a.S + groups - 1) / groups;
#pragma unroll 1
  for (int round = 0; round < rounds; ++round) {
    const int s = round * groups + grp;
    const bool live = s < a.S;
    const float* xb = a.x + (static_cast<size_t>(live ? s : 0) * a.nb + b) * a.B;
    float2 v[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = lane + m * T;
      float2 z = make_float2(0.f, 0.f);
      if (live && t < a.B) {
        const float val = __ldg(xb + t);
        if (a.crossfade) {
          const float xu = val * ((t + 0.5f) * inv_B);
          z = make_float2(xu, xu - val);  // conj(x·u + i·x·(1−u))
        } else {
          z.x = val;
        }
      }
      v[m] = z;
    }
    dft<16>(v);
    __syncthreads();  // the last round's bins have been read
    reg_passes<kLog2N, 1>(v, buf, lane, a.tw);
    __syncthreads();  // the last pass has read buf
#pragma unroll
    for (int s2 = 0; s2 < 16 / R; ++s2)
#pragma unroll
      for (int q = 0; q < R; ++q)
        buf[lane + s2 * T + q * Ns] = conj(v[s2 * R + q]);
    __syncthreads();
    if (!live) continue;

    const float2* Hc = a.H + (static_cast<size_t>(s) * a.nb + b) * 2 * F;
    // block 0 of every source takes its own filter as the previous one
    const float2* Hp =
        a.H + (static_cast<size_t>(s) * a.nb + (b > 0 ? b - 1 : 0)) * 2 * F;
#pragma unroll(kSharedAcc ? 1 : 9)
    for (int i = 0; i <= 8; ++i) {
      if (i < 8 || lane == 0) {
        const int k = i < 8 ? lane + i * T : n / 2;
        float2 y0, y1;
        if (a.crossfade) {
          float2 Xu, Xd;
          unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xu, &Xd);
          y0 = cadd(cmul(Xu, __ldg(Hc + k)), cmul(Xd, __ldg(Hp + k)));
          y1 = cadd(cmul(Xu, __ldg(Hc + F + k)), cmul(Xd, __ldg(Hp + F + k)));
        } else {
          const float2 X = buf[k];
          y0 = cmul(X, __ldg(Hc + k));
          y1 = cmul(X, __ldg(Hc + F + k));
        }
        acc(2 * i) = cadd(acc(2 * i), y0);
        acc(2 * i + 1) = cadd(acc(2 * i + 1), y1);
      }
    }
  }

  // the groups' sums into group 0's, in the order of the groups, then
  // Z = A + i·B at bins k and n − k, as pack_pair (common.cuh): DC and
  // Nyquist lose their imaginary parts
  __syncthreads();  // the last round's bins have been read
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i <= 8; ++i) {
      if (i < 8 || lane == 0) {
        const int k = i < 8 ? lane + i * T : n / 2;
        buf[k] = acc(2 * i);
        buf[F + k] = acc(2 * i + 1);
      }
    }
  }
  __syncthreads();
  const bool first = grp == 0;
  if (first) {
#pragma unroll
    for (int i = 0; i <= 8; ++i) {
      if (i < 8 || lane == 0) {
        const int k = i < 8 ? lane + i * T : n / 2;
        float2 A = acc(2 * i), B = acc(2 * i + 1);
        for (int g = 1; g < groups; ++g) {
          const float2* other = smem + g * mix_group_f2<kLog2N>();
          A = cadd(A, other[k]);
          B = cadd(B, other[F + k]);
        }
        if (k == 0 || k == n / 2) {
          A.y = 0.f;
          B.y = 0.f;
        }
        buf[k] = make_float2(A.x - B.y, A.y + B.x);
        if (k != 0 && k != n / 2)
          buf[n - k] = make_float2(A.x + B.y, B.x - A.y);
      }
    }
  }
  __syncthreads();
  float2 v[16];
  if (first) {
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = buf[lane + m * T];
    dft<16>(v);
  }
  __syncthreads();  // the pack has been read
  reg_passes_live<kLog2N, 1>(v, buf, lane, a.tw, first);
  if (!first) return;

  // the last pass's sub-DFT j = lane + s·T holds samples j + q·Ns
  const float inv_n = 1.0f / n;
  float* f0 = a.frames + static_cast<size_t>(b) * 2 * n;
#pragma unroll
  for (int s = 0; s < 16 / R; ++s)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + s * T + q * Ns;
      f0[i] = v[s * R + q].x * inv_n;
      f0[n + i] = v[s * R + q].y * inv_n;
    }
}

// The split buffer mode: the radix-2 body, one output block at a time per
// CUDA block, looping over the S sources.
__global__ void block_spectra_mix_inverse_kernel(const float* __restrict__ x,
                                                 const float2* __restrict__ H,
                                                 float* __restrict__ frames,
                                                 int S, int nb, int B,
                                                 int n_fft, int crossfade,
                                                 float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  const int tw_n = work;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // work
  float2* buf = scratch + static_cast<size_t>(blockIdx.x) * (n + 2 * F);  // n
  float2* acc0 = buf + n;        // F
  float2* acc1 = acc0 + F;       // F

  const FftPlan f = fft_plan(n, work);
  make_twiddles(tw, tw_n);
  const float inv_B = 1.0f / B;
  for (int b = blockIdx.x; b < nb; b = next_row<true>(b, nb)) {
    __syncthreads();  // the previous block is done with buf
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      acc0[k] = make_float2(0.f, 0.f);
      acc1[k] = make_float2(0.f, 0.f);
    }
    for (int s = 0; s < S; ++s) {
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
        buf[fft_pos<true>(f, t)] = z;
      }
      fft_run<true>(f, buf, tw, tw_n, wbuf, false);

      const float2* Hc = H + (static_cast<size_t>(s) * nb + b) * 2 * F;
      // block 0 of every source takes its own filter as "previous"
      const float2* Hp =
          H + (static_cast<size_t>(s) * nb + (b > 0 ? b - 1 : 0)) * 2 * F;
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

    float* f0 = frames + static_cast<size_t>(b) * 2 * n;
    inverse_pair<true>(acc0, acc1, buf, f, tw, tw_n, wbuf, f0, f0 + n);
  }
}

using SplitKernel = void (*)(const float*, const float2*, float*, int, int,
                             int, int, int, float2*, int);

// The register kernel for n = 2^kLog2N, checked against the caller's plan.
template <int kLog2N>
int launch_register(int log2n, int threads, int groups, int blocks_per_sm,
                    const MixArgs& a, cudaStream_t stream) {
  if constexpr (kLog2N > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_register<kLog2N + 1>(log2n, threads, groups,
                                         blocks_per_sm, a, stream);
    using P = RegPlan<kLog2N>;
    if (threads != P::threads || groups < 1 ||
        groups > mix_max_groups(P::threads) ||
        blocks_per_sm != mix_min_blocks(P::threads) || a.tw == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = block_spectra_mix_inverse_kernel<kLog2N>;
    const int smem =
        groups * mix_group_f2<kLog2N>() * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<a.nb, groups * P::threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// x: (S, nb, B) f32; H: (S·nb, 2, F) complex64; frames: (nb, 2, n_fft) f32.
// slices > 0: split mode, scratch holds slices · (n_fft + 2F) complex64,
// and tw, threads, groups and blocks_per_sm are unused. Otherwise the
// register kernel (128 ≤ n_fft ≤ 16384): tw the table of exp(+2πi·m/n),
// threads and blocks_per_sm the plan's and groups at most its max_groups
// (ops/render_plan.py `mix_plan`, `mix_groups`).
int tt_block_spectra_mix_inverse(const void* x, const void* H, void* frames,
                                 const void* tw, int S, int nb, int B,
                                 int n_fft, int crossfade, int threads,
                                 int groups, int blocks_per_sm, void* scratch,
                                 int slices, int work, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (slices == 0) {
    const MixArgs a{static_cast<const float*>(x),
                    static_cast<const float2*>(H),
                    static_cast<float*>(frames),
                    static_cast<const float2*>(tw),
                    S,
                    nb,
                    B,
                    crossfade};
    return launch_register<kMixMinLog2>(ilog2(n_fft), threads, groups,
                                        blocks_per_sm, a, s);
  }
  const int F = n_fft / 2 + 1;
  const SplitKernel kernel = block_spectra_mix_inverse_kernel;
  Launch l;
  const int err = launch_shape(kernel, nb, slices, work,
                               n_fft / 2 + n_fft + 2 * F, &l);
  if (err) return err;
  kernel<<<l.grid, 512, l.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float2*>(H),
      static_cast<float*>(frames), S, nb, B, n_fft, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
