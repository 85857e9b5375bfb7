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
//                              fused_epilogue (csrc/block_step.cu).
//
// All arithmetic is fp32. The first two kernels have two buffer modes
// (ops/_layout.py): up to n_fft 16384 the shared mode, register-resident
// radix-16 FFTs (csrc/fft_reg.cuh) with one exchange buffer in shared
// memory and host-built twiddle and taper tables; above, or when a test
// forces it, the split mode, the radix-2 FFTs of common.cuh over a device
// scratch. This file holds overlap_add and the library's helpers.

#include "common.cuh"

namespace {

// One thread per output sample t (grid x) of each source and ear (grid y,
// looping past 65535): a pure strided reduction over the k = n_fft/B
// frames of its source that overlap it, bound by device-memory bandwidth.
__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   float* __restrict__ out, int S, int nb,
                                   int B, int n_fft) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_len) return;
  const int q = static_cast<int>(t / B);
  const int k = n_fft / B;
  for (int se = blockIdx.y; se < 2 * S; se += gridDim.y) {  // s·2 + e
    const float* fs =
        frames + (static_cast<size_t>(se >> 1) * nb * 2 + (se & 1)) * n_fft;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int bb = q - j;
      if (bb >= 0 && bb < nb)
        acc += fs[static_cast<size_t>(bb) * 2 * n_fft +
                  (t - static_cast<long long>(bb) * B)];
    }
    out[static_cast<size_t>(se) * out_len + t] = acc;
  }
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

// frames: (S, nb, 2, n_fft) f32 → out: (S, 2, (nb−1)·B + n_fft) f32.
int tt_overlap_add(const void* frames, void* out, int S, int nb, int B,
                   int n_fft, void* stream) {
  const long long out_len = static_cast<long long>(nb - 1) * B + n_fft;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((out_len + threads - 1) / threads),
                  static_cast<unsigned>(2 * S < 65535 ? 2 * S : 65535));
  overlap_add_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<float*>(out), S, nb, B,
      n_fft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
