// Hand-written Hopper kernels of the single-launch block render.
//
// Replaces tinaural/ops/pallas_kernels.py:fused_block_render (kernel body
// _block_render_kernel, built from _vmem_gather, _block_spectra_core with
// _ramp_cos_sin, and _inverse_ola_core). The TPU kernel works in a
// scrambled four-step FFT layout and leans on its grid running in order:
// it carries the previous filter, the source mixdown and the OLA tails
// across grid steps. CUDA blocks run in parallel and in no order, so the
// same map is split into three kernels over natural-order spectra:
//
//   assemble_filters           G (source, block) rows per CUDA block:
//                              gather + lerp of 4 table rows, rfft_L, delay
//                              ramp and gain, irfft_L, truncation, rfft_nfft
//                              → H (csrc/assemble_filters.cu).
//   block_spectra_mix_inverse  one CUDA block per output block b, a loop
//                              over the sources inside it (the TPU's
//                              sequential source axis, deterministic, no
//                              atomics): crossfaded MAC against H[s,b] and
//                              H[s,b-1], mixdown, one packed inverse FFT for
//                              both ears → frames (csrc/block_mix_inverse.cu).
//   overlap_add                out[s,e,t] = Σ_j frames[s, b-j, e, t-(b-j)·B],
//                              per source s: no overlap crosses a source.
//                              With S = 1 it ends this render; with S
//                              sources it is the OLA half of
//                              fused_epilogue (csrc/spectra_inverse.cu).
//
// All arithmetic is fp32. The first two kernels have two buffer modes
// (ops/_layout.py): up to n_fft 16384 the shared mode, register-resident
// radix-16 FFTs (csrc/fft_reg.cuh) with one exchange buffer in shared
// memory and host-built twiddle and taper tables; above, or when a test
// forces it, the split mode, the radix-2 FFTs of common.cuh over a device
// scratch. This file holds overlap_add and the library's helpers.
//
// overlap_add replaces the OLA of _inverse_ola_core (pallas_kernels.py),
// which fused_block_render and fused_epilogue run at the end of each
// sequential grid step, carrying the OLA tails in VMEM from one step to
// the next. Here every output sample is independent: with k = n_fft/B,
// sample t of a (source, ear) row sums frames q, q−1, …, q−k+1 (q = ⌊t/B⌋,
// those that exist), so no carry is needed. Bytes bound it: every frame
// value is read once and every output written once (chip_smoke.ola_work:
// S·nb·2·n_fft·4 + S·2·out_len·4 bytes over 3.35 TB/s), for one add per
// frame value. What the design does about that bound:
//   - V = 4 consecutive outputs a thread, one float4 a frame, all k
//     frames' loads of a batch issued before any add, so a thread keeps
//     k·16 bytes in flight (32 at (a)'s k = 2): an SM's 2048 resident
//     threads (28 registers a thread) hold 64 KB of loads, where one
//     scalar load a frame and thread held 16 KB;
//   - 32-bit index math within a row: B is a power of two, so q = t >> log2
//     B and t − q·B = t & (B − 1); a 64-bit base per row, and the wrapper
//     refuses rows of 2^31 samples or more;
//   - the adds in the plain version's order (ops/ola.py: frame q first,
//     then q−1, …, into zeros), plain fp32 adds, so the output is equal in
//     bits to the plain float32 overlap_add.
// B < 4, or a frames or out pointer not 16-byte aligned (a contiguous
// slice can start at any float), takes the scalar body of the same kernel
// (V = 1). k = 2 and 4 are template arguments; any other k runs in
// batches of kOlaBatch frames, in order. The launch plan (V, grid) is
// ops/ola_plan.py `ola_plan`; the entry point computes the same plan from
// these constants and launches no other. A sweep on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md) chose V 4, 128 threads, one group a thread and
// no cache hints: V 8 or 16, 256 or 512 threads, 2 or 4 groups a thread,
// 8 blocks an SM and evict-first hints (__ldcs, __stcs) were each no
// faster at the renders' shapes, or slower; 128 threads took the
// latency-bound k = 32 launch of 128 frames from 0.009 to 0.0075 ms.

#include "common.cuh"

namespace {

constexpr int kOlaVec = 4;        // outputs a thread: one float4
constexpr int kOlaThreads = 128;  // threads a block
constexpr int kOlaBatch = 8;      // frames loaded before their adds, k ∉ {2, 4}
constexpr int kOlaAlign = 16;     // bytes a float4 load or store needs
constexpr long long kOlaMaxIndex = 0x7fffffffLL;  // 32-bit offsets in a row

// V = 1 or kOlaVec floats at p (16-byte aligned for a float4) into r.
template <int V>
__device__ __forceinline__ void ola_load(const float* p, float* r) {
  if constexpr (V == 1) {
    r[0] = __ldg(p);
  } else {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  }
}

template <int V>
__device__ __forceinline__ void ola_store(float* p, const float* r) {
  if constexpr (V == 1)
    *p = r[0];
  else
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// Thread g of a row (grid x) makes outputs t = g·V … g·V + V − 1 of row
// s·2 + e (grid y, looping past 65535). V divides B, so the V outputs
// share q = ⌊t/B⌋ and frame q − j holds them at offset (t & (B − 1)) +
// j·B. K > 0 fixes k.
template <int K, int V>
__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   float* __restrict__ out, int rows, int nb,
                                   int log2b, int k, int n_fft, int out_len) {
  static_assert(V == 1 || V == kOlaVec, "V is 1 or one float4");
  constexpr int kBatch = K > 0 ? K : kOlaBatch;
  if constexpr (K > 0) k = K;
  const int g = blockIdx.x * kOlaThreads + threadIdx.x;
  if (g >= out_len / V) return;
  const int t = g * V;
  const int q = t >> log2b;
  const int r = t & ((1 << log2b) - 1);
  const int frame_step = 2 * n_fft;  // block b's frame to b + 1's, one ear
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {  // s·2 + e
    const float* f =
        frames + (static_cast<size_t>(row >> 1) * nb * 2 + (row & 1)) * n_fft;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kBatch) {
      float x[kBatch][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int bb = q - j0 - j;
        if (j0 + j < k && bb >= 0 && bb < nb)
          ola_load<V>(f + (bb * frame_step + r + ((j0 + j) << log2b)), x[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int bb = q - j0 - j;
        if (j0 + j < k && bb >= 0 && bb < nb) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += x[j][v];
        }
      }
    }
    ola_store<V>(out + static_cast<size_t>(row) * out_len + t, acc);
  }
}

// overlap_add's launch plan (ops/ola_plan.py `ola_plan`).
struct OlaPlan {
  int vec, grid_x;
};

OlaPlan ola_plan(long long out_len, int B, bool aligned) {
  const int vec = B < 4 || !aligned ? 1 : kOlaVec;
  return {vec, static_cast<int>((out_len / vec + kOlaThreads - 1) /
                                kOlaThreads)};
}

template <int K>
int launch_ola(int vec, dim3 grid, const float* frames, float* out, int rows,
               int nb, int log2b, int k, int n_fft, int out_len,
               cudaStream_t st) {
  if (vec == 1)
    overlap_add_kernel<K, 1><<<grid, kOlaThreads, 0, st>>>(
        frames, out, rows, nb, log2b, k, n_fft, out_len);
  else
    overlap_add_kernel<K, kOlaVec><<<grid, kOlaThreads, 0, st>>>(
        frames, out, rows, nb, log2b, k, n_fft, out_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The opt-in shared memory one block may use on `device`, in bytes.
int tt_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// frames: (S, nb, 2, n_fft) f32 → out: (S, 2, (nb−1)·B + n_fft) f32, B a
// power of two dividing n_fft. vec and grid_x are the plan of
// ops/ola_plan.py for these shapes and the pointers' alignment; any other
// plan, or a row whose offsets leave 32 bits (a source's nb·2·n_fft frame
// values, more than the out_len of an ear, of 2^31 or more), launches
// nothing.
int tt_overlap_add(const void* frames, void* out, int S, int nb, int B,
                   int n_fft, int vec, int grid_x, void* stream) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  if (S < 1 || nb < 1 || B < 1 || (B & (B - 1)) || n_fft < B ||
      n_fft % B || static_cast<long long>(nb) * 2 * n_fft > kOlaMaxIndex)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<size_t>(frames) % kOlaAlign == 0 &&
                       reinterpret_cast<size_t>(out) % kOlaAlign == 0;
  const OlaPlan p = ola_plan(out_len, B, aligned);
  if (vec != p.vec || grid_x != p.grid_x)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(2 * S < 65535 ? 2 * S : 65535));
  const int k = n_fft / B;
  const auto f = static_cast<const float*>(frames);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int len = static_cast<int>(out_len);
  const int log2b = ilog2(B);
  if (k == 2)
    return launch_ola<2>(vec, grid, f, o, 2 * S, nb, log2b, k, n_fft, len,
                         st);
  if (k == 4)
    return launch_ola<4>(vec, grid, f, o, 2 * S, nb, log2b, k, n_fft, len,
                         st);
  return launch_ola<0>(vec, grid, f, o, 2 * S, nb, log2b, k, n_fft, len, st);
}

}  // extern "C"
