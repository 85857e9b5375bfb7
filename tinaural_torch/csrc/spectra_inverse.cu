// Hand-written Hopper kernel `spectra_inverse`: the packed inverse FFT of
// both ears' block spectra, Y (terms, rows, 2, F) complex64 → frames
// (rows, 2, n_fft) f32, the irfft of each ear of Σ_t Y[t] (t in order).
//
// Replaces the inverse half of fused_epilogue in
// tinaural/ops/pallas_kernels.py (:2587; its core _inverse_ola_core, :2486:
// ear packing, Hermitian mirror groups, inverse four-step FFT). The OLA
// half is overlap_add (block_render.cu). The TPU kernel works in the
// scrambled four-step layout; this one takes natural-order spectra and
// writes natural-order frames.
//
// Bound by bytes on the H100: a row reads 2·F complex64 per term and
// writes 2·n floats, 32 KB at n_fft 2048. 8192 such rows take 0.080 ms at
// 3.35 TB/s (0.160 ms at n_fft 4096), while their 5·n·log2 n FLOPs take
// 0.014 ms at 67 TFLOP/s.
//
// Design (shared buffer mode, n_fft ≤ 16384; fft_reg.cuh has the passes):
//   load and pack  each thread reads its 16 bins of both ears straight
//                  into registers, each bin k < n/2 or the mirror n − k
//                  (coalesced either way), sums the terms in order, and
//                  packs Z = A + i·B as pack_pair (common.cuh) does, the
//                  imaginary parts at DC and Nyquist dropped;
//   transform      radix-16 butterflies in registers, then one exchange
//                  through shared memory and one barrier per pass: 3
//                  passes at n_fft 2048 and 4096, so 3 barriers, where
//                  the shared-memory radix-2 loop took log2 n = 11 with
//                  the whole row read and written at each;
//   twiddles       between passes from a table built once per
//                  (device, n_fft) in float64 on the host
//                  (ops/spectra_inverse.py `twiddles`), read through the
//                  read-only cache; no block computes a sine;
//   store          f0 = Re z / n, f1 = Im z / n: neighbouring threads
//                  write neighbouring samples.
// Small rows share a block: T = n/16 threads per row, 256/T rows per
// block up to n_fft 4096 (one thread per row at n ≤ 16), so every block
// has 256 threads; 512 at 8192 and 1024 at 16384. A block's last rows
// past `rows` load nothing and store nothing but keep to the barriers.
// __launch_bounds__ caps registers at 64, 4 blocks of 256 per SM.
//
// The cluster buffer mode (n_fft 32768 … 131072, above what one block's
// shared memory holds): one thread-block cluster of C = n/16384 blocks of
// 1024 threads per row (fft_reg.cuh ClusterPlan). The same load and pack
// take bins M·k1 + k2 of a rank's k2-range, the radix-C step crosses the
// cluster once through distributed shared memory, and each block then runs
// the 16384-point register transform of the shared mode on its share; rank
// t1 stores samples t1 + C·t2. At 128 rows × 32768 that is 256 blocks, two
// waves on 132 SMs. A first design that ran all four radix-16 passes
// across the cluster, one DSMEM exchange each, took 0.187 ms there against
// irfft's 0.102 (scripts/torch_cluster_sweep.py, H100).
//
// The split buffer mode (above 131072, or forced) keeps the radix-2
// kernel of common.cuh: inverse_pair over a device scratch, the blocks
// walking the rows.

#include "fft_reg.cuh"

namespace {

// One row per T = RegPlan::threads threads; see the header comment.
template <int kLog2N, bool kSum>
__global__ void __launch_bounds__(RegPlan<kLog2N>::block,
                                  1024 / RegPlan<kLog2N>::block)
    spectra_inverse_kernel(const float2* __restrict__ Y,
                           float* __restrict__ frames,
                           const float2* __restrict__ tw, int rows,
                           int terms) {
  using P = RegPlan<kLog2N>;
  constexpr int n = P::n, F = n / 2 + 1, T = P::threads, PT = P::points;
  extern __shared__ float2 xbuf[];
  const int lane = threadIdx.x % T;
  const int local = threadIdx.x / T;
  const int row = blockIdx.x * P::rows + local;
  const bool live = row < rows;
  const float2* A = Y + static_cast<size_t>(live ? row : 0) * 2 * F;
  const size_t stride = static_cast<size_t>(rows) * 2 * F;

  // pass 0 (radix PT) takes Z[k], k = lane + r·T
  float2 v[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int k = lane + r * T;
    const bool mirror = k > n / 2;
    const int q = mirror ? n - k : k;
    float2 a = make_float2(0.f, 0.f), b = a;
    if (live) {
      a = __ldg(A + q);
      b = __ldg(A + F + q);
      if (kSum) {
        for (int t = 1; t < terms; ++t) {
          a = cadd(a, __ldg(A + t * stride + q));
          b = cadd(b, __ldg(A + t * stride + F + q));
        }
      }
    }
    if (q == 0 || q == n / 2) {
      a.y = 0.f;
      b.y = 0.f;
    }
    v[r] = mirror ? make_float2(a.x + b.y, b.x - a.y)
                  : make_float2(a.x - b.y, a.y + b.x);
  }
  dft<PT>(v);
  reg_passes<kLog2N, 1>(v, xbuf + local * P::row_f2, lane, tw);

  // the last pass's sub-DFT j = lane + s·T holds samples j + r·Ns
  if (live) {
    constexpr int RL = P::radix(P::passes - 1);
    constexpr int Ns = n / RL;
    const float inv_n = 1.0f / n;
    float* f0 = frames + static_cast<size_t>(row) * 2 * n;
#pragma unroll
    for (int s = 0; s < PT / RL; ++s) {
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int i = lane + s * T + r * Ns;
        f0[i] = v[s * RL + r].x * inv_n;
        f0[n + i] = v[s * RL + r].y * inv_n;
      }
    }
  }
}

// The cluster mode: one cluster of Plan::ranks blocks per row (fft_reg.cuh
// cluster_spread, cluster_local_fft). It shares the register kernel's
// name, so a profile names both alike.
template <class Plan, bool kSum>
__global__ void __launch_bounds__(kClusterThreads, 1)
    spectra_inverse_kernel(const float2* __restrict__ Y,
                           float* __restrict__ frames,
                           const float2* __restrict__ twN,
                           const float2* __restrict__ twM, int rows,
                           int terms) {
  constexpr int n = Plan::n, F = n / 2 + 1, C = Plan::ranks, M = Plan::M;
  extern __shared__ float2 xbuf[];
  const int rank = static_cast<int>(blockIdx.x) % C;
  const int row = static_cast<int>(blockIdx.x) / C;
  const int tid = threadIdx.x;
  const float2* A = Y + static_cast<size_t>(row) * 2 * F;
  const size_t stride = static_cast<size_t>(rows) * 2 * F;
  cluster_arrive<C>();  // this block runs: the others may store into it

  // Z[k], k = M·k1 + k2, k2 = rank·span + tid + s·1024, into v[s·C + k1]
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int k = M * (m % C) + rank * Plan::span + tid +
                  (m / C) * kClusterThreads;
    const bool mirror = k > n / 2;
    const int q = mirror ? n - k : k;
    float2 a = __ldg(A + q), b = __ldg(A + F + q);
    if (kSum) {
      for (int t = 1; t < terms; ++t) {
        a = cadd(a, __ldg(A + t * stride + q));
        b = cadd(b, __ldg(A + t * stride + F + q));
      }
    }
    if (q == 0 || q == n / 2) {
      a.y = 0.f;
      b.y = 0.f;
    }
    v[m] = mirror ? make_float2(a.x + b.y, b.x - a.y)
                  : make_float2(a.x - b.y, a.y + b.x);
  }
  cluster_spread<Plan>(v, xbuf, rank, tid, twN);
  cluster_local_fft(v, xbuf, tid, twM);

  // v[m] holds sample rank + C·t2, t2 = tid + 1024·local_out(m)
  const float inv_n = 1.0f / n;
  float* f0 = frames + static_cast<size_t>(row) * 2 * n;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int i = rank + C * (tid + kClusterThreads * local_out(m));
    f0[i] = v[m].x * inv_n;
    f0[n + i] = v[m].y * inv_n;
  }
}

// The split buffer mode: the blocks walk the rows, each row's packed
// inverse through the block's scratch slice (common.cuh inverse_pair).
// kSum = false compiles the single-term kernel without the sum loop. It
// shares the register kernel's name, so a profile names both alike.
template <bool kSum>
__global__ void spectra_inverse_kernel(const float2* __restrict__ Y,
                                       float* __restrict__ frames, int rows,
                                       int n_fft, int terms, float2* scratch,
                                       int work) {
  extern __shared__ float2 smem[];
  const int n = n_fft;
  const int F = n / 2 + 1;
  const int tw_n = work;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // work
  float2* buf = scratch + static_cast<size_t>(blockIdx.x) * n;

  const FftPlan f = fft_plan(n, work);
  make_twiddles(tw, tw_n);
  const size_t stride = static_cast<size_t>(rows) * 2 * F;
  for (int r = blockIdx.x; r < rows; r = next_row<true>(r, rows)) {
    __syncthreads();  // the previous row is done with buf
    const float2* Yr = Y + static_cast<size_t>(r) * 2 * F;
    float* fr = frames + static_cast<size_t>(r) * 2 * n;
    inverse_pair<true>(Yr, Yr + F, buf, f, tw, tw_n, wbuf, fr, fr + n,
                       kSum ? terms : 1, stride);
  }
}

using RegKernel = void (*)(const float2*, float*, const float2*, int, int);
using SplitKernel = void (*)(const float2*, float*, int, int, int, float2*,
                             int);

// The register kernel for n = 2^log2n, checked against the caller's plan.
template <int kLog2N>
int launch_register(int log2n, const float2* Y, float* frames,
                    const float2* tw, int rows, int terms, int rows_per_block,
                    int points, cudaStream_t stream) {
  if constexpr (kLog2N > kRegMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_register<kLog2N + 1>(log2n, Y, frames, tw, rows, terms,
                                         rows_per_block, points, stream);
    using P = RegPlan<kLog2N>;
    if (rows_per_block != P::rows || points != P::points || tw == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const RegKernel kernel =
        terms > 1 ? static_cast<RegKernel>(spectra_inverse_kernel<kLog2N, true>)
                  : static_cast<RegKernel>(spectra_inverse_kernel<kLog2N, false>);
    const int smem = P::rows * P::row_f2 * static_cast<int>(sizeof(float2));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (rows + P::rows - 1) / P::rows;
    kernel<<<grid, P::block, smem, stream>>>(Y, frames, tw, rows, terms);
    return static_cast<int>(cudaGetLastError());
  }
}

// The cluster kernel for n = 2^log2n, checked against the caller's plan.
template <int kLog2N>
int launch_cluster_inverse(int log2n, const float2* Y, float* frames,
                           const float2* tw, const float2* twM, int rows,
                           int terms, int rows_per_block, int points,
                           int ranks, cudaStream_t stream) {
  if constexpr (kLog2N > kClusterMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N)
      return launch_cluster_inverse<kLog2N + 1>(log2n, Y, frames, tw, twM,
                                                rows, terms, rows_per_block,
                                                points, ranks, stream);
    using P = ClusterPlan<kLog2N>;
    if (rows_per_block != 1 || points != 16 || ranks != P::ranks ||
        tw == nullptr || twM == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    using ClusterKernel = void (*)(const float2*, float*, const float2*,
                                   const float2*, int, int);
    const ClusterKernel kernel =
        terms > 1
            ? static_cast<ClusterKernel>(spectra_inverse_kernel<P, true>)
            : static_cast<ClusterKernel>(spectra_inverse_kernel<P, false>);
    return launch_cluster(kernel, rows, P::ranks,
                          P::share_f2 * static_cast<int>(sizeof(float2)),
                          stream, Y, frames, tw, twM, rows, terms);
  }
}

}  // namespace

extern "C" {

// Y: (terms, rows, 2, F) complex64 → frames: (rows, 2, n_fft) f32.
// slices > 0: split mode, scratch holds slices · n_fft complex64, tw and
// twM are unused. Otherwise the register kernel (n_fft ≤ 16384, ranks 1) or
// the cluster kernel (32768 … 131072): tw is the table of exp(+2πi·m/n)
// for m < n_fft, twM (cluster kernel only) that of exp(+2πi·m/16384), and
// rows_per_block, points and ranks must be the plan's
// (ops/spectra_inverse.py `inverse_plan`).
int tt_spectra_inverse(const void* Y, void* frames, const void* tw,
                       const void* twM, int rows, int n_fft, int terms,
                       int rows_per_block, int points, int ranks,
                       void* scratch, int slices, int work, void* stream) {
  const auto Yc = static_cast<const float2*>(Y);
  const auto out = static_cast<float*>(frames);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto twc = static_cast<const float2*>(tw);
  if (slices == 0 && n_fft > (1 << kRegMaxLog2N))
    return launch_cluster_inverse<kRegMaxLog2N + 1>(
        ilog2(n_fft), Yc, out, twc, static_cast<const float2*>(twM), rows,
        terms, rows_per_block, points, ranks, s);
  if (slices == 0)
    return ranks == 1 ? launch_register<1>(ilog2(n_fft), Yc, out, twc, rows,
                                           terms, rows_per_block, points, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  const SplitKernel kernel =
      terms > 1 ? static_cast<SplitKernel>(spectra_inverse_kernel<true>)
                : static_cast<SplitKernel>(spectra_inverse_kernel<false>);
  Launch l;
  const int err =
      launch_shape(kernel, rows, slices, work, n_fft / 2 + n_fft, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, s>>>(Yc, out, rows, n_fft, terms,
                                     static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
