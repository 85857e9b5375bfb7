// Hand-written Hopper kernels of uniformly partitioned overlap-save
// convolution: the streaming step, its hold step, and the batched offline
// render of the same map.
//
// Replaces, in tinaural/ops/pallas_kernels.py:
//   fused_stream_step            (_stream_step_kernel, _stream_step_asm_kernel
//                                 → _stream_conv_core)
//   fused_stream_hold            (_stream_hold_kernel → _stream_conv_core)
//   fused_partitioned_step       (_partitioned_kernel → _partitioned_conv_core)
//   fused_partitioned_assembled  (_partitioned_asm_kernel: _asm_filters →
//                                 _partitioned_conv_core)
// The TPU kernels compute the partition spectra with zoom matmuls or a
// four-step FFT in a scrambled lane layout, and the offline one carries the
// frame, delay line and previous filter across its ordered grid. Here the
// map splits into three kernels that need no carry between CUDA blocks:
//
//   assemble_partitions  (csrc/assemble_partitions.cu) the filter
//                        partitions of each row (a stream, or a block of
//                        the offline render): the effective-filter chain
//                        (gather, rfft_L, ramp·gain, irfft_L), truncation to
//                        T_pad, then P packed-ear rfft_2B of the B-sample
//                        partitions → H (rows, P, 2, B+1) as re/im planes,
//                        the layout of StreamState.prev_h.
//   stream_conv          one block per stream: rfft_2B of [prev_in | xb],
//                        the delay line shifted into NEW planes, the MAC
//                        over P under H (and under the previous filter when
//                        crossfading), one packed inverse FFT per filter,
//                        the last B samples, the blend w = (i + 0.5)/B. The
//                        hold step is the same kernel without crossfade.
//   partitioned_conv     one block per output block b of the offline render:
//                        the P frame spectra X[b-p] recomputed from the input
//                        (two frames per complex FFT), the MAC under its
//                        filter and the previous block's (block 0: its
//                        own), tails and blend. Block b's filter is row
//                        ⌊b/k⌋ of the ⌈nb/k⌉ assembled (k = dir_rate): the
//                        TPU kernel's dir_rate path assembles the chunk/k
//                        unique filters and copies each to its k blocks
//                        (_expand_rows); here no row is copied.
//
// The two here run radix-2 FFTs in shared memory over natural-order bins.
// Bound on the H100 by those FFT stages and their __syncthreads();
// device-memory traffic per stream is the partition planes (P·2·(B+1)
// complex values, ~37 KB at P = 9, B = 256) and stays far below the card's
// bandwidth at serving batch sizes. Both run in either buffer mode of
// common.cuh, so any stream block takes the same kernels.

#include "fft_reg.cuh"

namespace {

__device__ __forceinline__ float2 plane(const float* re, const float* im,
                                        size_t i) {
  return make_float2(re[i], im[i]);
}

// Inverse of the two packed-ear spectra in yn (and yp), last B samples,
// blend: y (2, B) at y0 (ear 0) and y0 + ear_stride (ear 1).
template <bool kSplit>
__device__ void tails_blend(float2* yn, float2* yp, const FftPlan& f,
                            const float2* tw, int tw_n, float2* work, int B,
                            int crossfade, float* y0, size_t ear_stride) {
  fft_run<kSplit>(f, yn, tw, tw_n, work, true);
  if (crossfade) fft_run<kSplit>(f, yp, tw, tw_n, work, true);
  const float inv_n = 1.0f / f.n;
  const float inv_B = 1.0f / B;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    float2 v = cscale(yn[B + i], inv_n);
    if (crossfade) {
      const float u = (i + 0.5f) * inv_B;
      const float2 vp = cscale(yp[B + i], inv_n);
      v = make_float2(u * v.x + (1.0f - u) * vp.x, u * v.y + (1.0f - u) * vp.y);
    }
    y0[i] = v.x;
    y0[ear_stride + i] = v.y;
  }
}

// One block per stream s (grid-stride when split). xb, prev_in: (S, B);
// fdl_*: (S, P, B+1); H_*, Hp_*: (S, P, 2, B+1); started: (S,). Writes y
// (S, 2, B), prev_out = xb, and the shifted delay line into fdl_*_out.
template <bool kSplit>
__global__ void stream_conv_kernel(const float* __restrict__ xb,
                                   const float* __restrict__ prev_in,
                                   const float* __restrict__ fdl_re,
                                   const float* __restrict__ fdl_im,
                                   const float* __restrict__ H_re,
                                   const float* __restrict__ H_im,
                                   const float* __restrict__ Hp_re,
                                   const float* __restrict__ Hp_im,
                                   const float* __restrict__ started,
                                   float* __restrict__ y,
                                   float* __restrict__ prev_out,
                                   float* __restrict__ fdl_re_out,
                                   float* __restrict__ fdl_im_out, int S,
                                   int B, int P, int crossfade,
                                   float2* scratch, int work) {
  extern __shared__ float2 smem[];
  const int n = 2 * B;
  const int F2 = B + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* xs = kSplit ? scratch + static_cast<size_t>(blockIdx.x) * 3 * n
                      : wbuf;    // n
  float2* yn = xs + n;           // n
  float2* yp = yn + n;           // n

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int s = blockIdx.x; s < S; s = next_row<kSplit>(s, S)) {
    __syncthreads();
    const size_t sb = static_cast<size_t>(s) * B;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      float v;
      if (t < B) {
        v = prev_in[sb + t];
      } else {
        v = xb[sb + t - B];
        prev_out[sb + t - B] = v;
      }
      xs[fft_pos<kSplit>(f, t)] = make_float2(v, 0.f);
    }
    fft_run<kSplit>(f, xs, tw, tw_n, wbuf, false);

    // The first push of a stream takes its own filter as "previous".
    const bool prev = crossfade && started[s] > 0.5f;
    const float* Pr = prev ? Hp_re : H_re;
    const float* Pi = prev ? Hp_im : H_im;
    for (int k = threadIdx.x; k < F2; k += blockDim.x) {
      float2 n0 = make_float2(0.f, 0.f), n1 = n0, p0 = n0, p1 = n0;
      for (int q = 0; q < P; ++q) {
        // slot 0 is the new frame, slot q the old slot q-1
        const size_t fi = (static_cast<size_t>(s) * P + q) * F2 + k;
        const float2 X = q == 0 ? xs[k] : plane(fdl_re, fdl_im, fi - F2);
        fdl_re_out[fi] = X.x;
        fdl_im_out[fi] = X.y;
        const size_t h = (static_cast<size_t>(s) * P + q) * 2 * F2 + k;
        n0 = cadd(n0, cmul(X, plane(H_re, H_im, h)));
        n1 = cadd(n1, cmul(X, plane(H_re, H_im, h + F2)));
        if (crossfade) {
          p0 = cadd(p0, cmul(X, plane(Pr, Pi, h)));
          p1 = cadd(p1, cmul(X, plane(Pr, Pi, h + F2)));
        }
      }
      pack_pair<kSplit>(yn, f, k, n0, n1);
      if (crossfade) pack_pair<kSplit>(yp, f, k, p0, p1);
    }
    tails_blend<kSplit>(yn, yp, f, tw, tw_n, wbuf, B, crossfade,
                        y + static_cast<size_t>(s) * 2 * B, B);
  }
}

// Sample t of the 2B overlap-save frame of block c, [x[c-1] | x[c]], with
// x[<0] = 0.
__device__ __forceinline__ float frame_sample(const float* x, int c, int t,
                                              int B) {
  const int blk = c - 1 + (t >= B ? 1 : 0);
  return blk < 0 ? 0.f : x[static_cast<size_t>(blk) * B + (t & (B - 1))];
}

// One block per output block b = b0 + i, i < n_blocks (grid-stride when
// split). x: (nb, B); H_*: filter rows ⌊b0/k⌋ − has_prev … (P, 2, B+1
// each), k = dir_rate and b0 a multiple of k, so that a chunk that starts
// past block 0 holds the previous group's row first; y: (2, nb·B).
// ops/partitioned_conv.py `conv_rows` is the same map.
template <bool kSplit>
__global__ void partitioned_conv_kernel(const float* __restrict__ x,
                                        const float* __restrict__ H_re,
                                        const float* __restrict__ H_im,
                                        float* __restrict__ y, int nb, int b0,
                                        int n_blocks, int has_prev,
                                        int dir_rate, int B, int P,
                                        int crossfade, float2* scratch,
                                        int work) {
  extern __shared__ float2 smem[];
  const int n = 2 * B;
  const int F2 = B + 1;
  const int tw_n = kSplit ? work : n;
  float2* tw = smem;             // tw_n / 2
  float2* wbuf = tw + tw_n / 2;  // split: work
  float2* buf = kSplit ? scratch + static_cast<size_t>(blockIdx.x) *
                                       (2 * n + 4 * F2)
                       : wbuf;   // n
  float2* yp = buf + n;          // n
  float2* acc = yp + n;  // 4 · F2: Yn ear 0, Yn ear 1, Yp ear 0, Yp ear 1

  const FftPlan f = fft_plan(n, kSplit ? work : 0);
  make_twiddles(tw, tw_n);
  for (int i = blockIdx.x; i < n_blocks; i = next_row<kSplit>(i, n_blocks)) {
    __syncthreads();
    const int b = b0 + i;
    // block b's filter row, counted from the chunk's first (the group
    // before b0's where b0 > 0); its predecessor's is the row before where
    // b starts a group past block 0, else the same row
    const size_t row =
        static_cast<size_t>(b / dir_rate - b0 / dir_rate + has_prev);
    const size_t prow = b > 0 && b % dir_rate == 0 ? row - 1 : row;
    for (int k = threadIdx.x; k < 4 * F2; k += blockDim.x)
      acc[k] = make_float2(0.f, 0.f);

    for (int q = 0; q < P; q += 2) {
      // frames of blocks b-q and b-q-1 as one complex FFT
      const bool pair = q + 1 < P;
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        buf[fft_pos<kSplit>(f, t)] =
            make_float2(frame_sample(x, b - q, t, B),
                        pair ? frame_sample(x, b - q - 1, t, B) : 0.f);
      }
      fft_run<kSplit>(f, buf, tw, tw_n, wbuf, false);
      for (int k = threadIdx.x; k < F2; k += blockDim.x) {
        float2 Xa, Xb;
        unpack_pair(buf[k], buf[(n - k) & (n - 1)], &Xa, &Xb);
        for (int j = 0; j < (pair ? 2 : 1); ++j) {
          const float2 X = j == 0 ? Xa : Xb;
          const size_t h = (row * P + q + j) * 2 * F2 + k;
          acc[k] = cadd(acc[k], cmul(X, plane(H_re, H_im, h)));
          acc[F2 + k] = cadd(acc[F2 + k], cmul(X, plane(H_re, H_im, h + F2)));
          if (crossfade) {
            const size_t hp = (prow * P + q + j) * 2 * F2 + k;
            acc[2 * F2 + k] =
                cadd(acc[2 * F2 + k], cmul(X, plane(H_re, H_im, hp)));
            acc[3 * F2 + k] =
                cadd(acc[3 * F2 + k], cmul(X, plane(H_re, H_im, hp + F2)));
          }
        }
      }
      __syncthreads();  // buf is refilled by the next pair of frames
    }

    for (int k = threadIdx.x; k < F2; k += blockDim.x) {
      pack_pair<kSplit>(buf, f, k, acc[k], acc[F2 + k]);
      if (crossfade)
        pack_pair<kSplit>(yp, f, k, acc[2 * F2 + k], acc[3 * F2 + k]);
    }
    tails_blend<kSplit>(buf, yp, f, tw, tw_n, wbuf, B, crossfade,
                        y + static_cast<size_t>(b) * B,
                        static_cast<size_t>(nb) * B);
  }
}

}  // namespace

extern "C" {


// See stream_conv_kernel; Hp_* may alias H_* (the hold step). slices > 0:
// split mode, scratch holds slices · 6B complex64.
int tt_stream_conv(const void* xb, const void* prev_in, const void* fdl_re,
                   const void* fdl_im, const void* H_re, const void* H_im,
                   const void* Hp_re, const void* Hp_im, const void* started,
                   void* y, void* prev_out, void* fdl_re_out,
                   void* fdl_im_out, int S, int B, int P, int crossfade,
                   void* scratch, int slices, int work, void* stream) {
  auto kernel =
      slices > 0 ? stream_conv_kernel<true> : stream_conv_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, S, slices, work, 7 * B, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const float*>(prev_in),
      static_cast<const float*>(fdl_re), static_cast<const float*>(fdl_im),
      static_cast<const float*>(H_re), static_cast<const float*>(H_im),
      static_cast<const float*>(Hp_re), static_cast<const float*>(Hp_im),
      static_cast<const float*>(started), static_cast<float*>(y),
      static_cast<float*>(prev_out), static_cast<float*>(fdl_re_out),
      static_cast<float*>(fdl_im_out), S, B, P, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

// x: (nb, B) f32; H_re, H_im: (rows, P, 2, B+1) f32, the filter rows
// ⌊b0/k⌋ − has_prev … ⌊(b0 + n_blocks − 1)/k⌋ with k = dir_rate and b0 a
// multiple of k; y: (2, nb·B) f32. slices > 0: split mode, scratch holds
// slices · (4B + 4(B+1)) complex64.
int tt_partitioned_conv(const void* x, const void* H_re, const void* H_im,
                        void* y, int nb, int b0, int n_blocks, int has_prev,
                        int dir_rate, int B, int P, int crossfade,
                        void* scratch, int slices, int work, void* stream) {
  if (dir_rate < 1 || b0 % dir_rate)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = slices > 0 ? partitioned_conv_kernel<true>
                           : partitioned_conv_kernel<false>;
  Launch l;
  const int err = launch_shape(kernel, n_blocks, slices, work,
                               5 * B + 4 * (B + 1), &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(H_re),
      static_cast<const float*>(H_im), static_cast<float*>(y), nb, b0,
      n_blocks, has_prev, dir_rate, B, P, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"