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
// map splits into kernels that need no carry between CUDA blocks:
//
//   assemble_partitions  (csrc/assemble_partitions.cu) the filter
//                        partitions of each row (a stream, or a group of
//                        dir_rate blocks of the offline render): the
//                        effective-filter chain, truncation to T_pad, then
//                        P packed-ear rfft_2B → H (rows, P, 2, B+1) as re/im
//                        planes, the layout of StreamState.prev_h.
//   stream_conv          per stream: rfft_2B of [prev_in | xb], the delay
//                        line shifted into NEW planes, the MAC over P under
//                        H (and under the previous filter when crossfading),
//                        the inverses, the last B samples, the blend
//                        w = (i + 0.5)/B. The hold step is the same kernel
//                        without crossfade.
//   frame_spectra        the frame spectra X (nb, B+1) of the offline
//                        render, each frame [x[c-1] | x[c]] once for all
//                        its chunks, which the TPU kernel carries as its
//                        delay line across the grid.
//   partitioned_conv     per output block b: the MAC over X[b-q], q < P,
//                        under its filter and the previous block's (block
//                        0: its own), tails and blend. Block b's filter is
//                        row ⌊b/k⌋ of the ⌈nb/k⌉ assembled (k = dir_rate):
//                        the TPU kernel's dir_rate path copies each unique
//                        filter to its k blocks (_expand_rows); here no row
//                        is copied.
//
// Bound on the H100 by bytes: the MAC reads the partition planes of its
// filters, P·2·(B+1) complex64 each (render (g): 2048 blocks × P 5 × B
// 512, 84 MB; (j): 256 × P 87, 91 MB), and the streaming step the delay
// line too. The first cut (PR 2, the radix-2 body below) took 5–8× that:
// radix-2 FFTs in shared memory with a barrier per stage and twiddles
// rebuilt with sincospif in every block, one 256-thread block per stream,
// a stream's real frame transformed as a complex one, its two inverses in
// turn, and in the offline render every frame spectrum recomputed by each
// of the P blocks that read it (44 FFTs a block at (j)). The register
// design here, at B = 64 … 2048 (2B = 128 … 4096, the partition FFTs of
// assemble_partitions' register body; plan ops/conv_plan.py):
//   transforms  every 2B-point FFT is the register FFT of fft_reg.cuh
//               (RegPlan: 16 points a thread, T = 2B/16 threads, radix-16
//               passes, one exchange each), the forward one as the
//               conjugate of the inverse, twiddles from the host-built
//               table (ops/spectra_inverse.py `twiddles` at 2B);
//   forward     two real frames packed as one complex frame a + i·b,
//               separated by unpack_pair (common.cuh): stream_conv packs
//               two streams of its block, frame_spectra frames 2m and
//               2m + 1, so the offline render takes ⌈nb/2⌉ transforms
//               (the radix-2 body: nb·⌈P/2⌉), and a frame's bits are the
//               same however the render is cut into chunks;
//   MAC         G·(B+1) bins × `groups` groups of partitions spread over
//               the block's threads, each group's sums over its partitions
//               (q ≡ group mod groups, in order) in registers, then in its
//               own slice of shared memory, the groups added in order by
//               the inverse: no atomics, the same bits every run;
//   inverses    2G at once, each on its own T threads: for stream g and
//               ear e the packed Yn_e + i·Yp_e (new and previous filter),
//               so the last B samples of both and their blend
//               u·Re + (1 − u)·Im are in the thread's registers; without
//               crossfade Yp = 0 and u = 1.
// stream_conv runs G streams per block (a power of two from S and the SM
// count, as assemble_partitions picks rows); partitioned_conv one output
// block per block, on 64 … 512 threads picked from the blocks and the SM
// count: (g)'s 2048 blocks take 128, so with 64 registers a thread
// (__launch_bounds__(512, 2), no spills) several blocks share an SM and
// one's MAC loads overlap another's inverse: on an H100, 0.136 ms a launch
// at (g) with one 512-thread block an SM (87 registers), 0.068 with
// 128-thread blocks at 64 registers (scripts/torch_conv_ab.py). Outside
// the register range, and in the split buffer mode (common.cuh), both
// keep the radix-2 body.

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

// The radix-2 body: one block per stream s (grid-stride when split). xb,
// prev_in: (S, B); fdl_*: (S, P, B+1); H_*, Hp_*: (S, P, 2, B+1); started:
// (S,). Writes y (S, 2, B), prev_out = xb, and the shifted delay line into
// fdl_*_out.
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

// The radix-2 body: one block per output block b = b0 + i, i < n_blocks
// (grid-stride when split), the P frame spectra recomputed from x, two
// frames per complex FFT. x: (nb, B); H_*: filter rows ⌊b0/k⌋ − has_prev …
// (P, 2, B+1 each), k = dir_rate and b0 a multiple of k, so that a chunk
// that starts past block 0 holds the previous group's row first; y: (2,
// nb·B). ops/partitioned_conv.py `conv_rows` is the same map.
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

// ------------------------------------------------------------------------
// The register design (see the header comment), 2B = 2^kLog2N, 128 … 4096.
// ops/conv_plan.py computes the same figures.

constexpr int kConvMinLog2N = 7;       // 2B = 128: B = 64
constexpr int kConvMaxLog2N = 12;      // 2B = 4096: B = 2048
constexpr int kConvMaxThreads = 512;   // per block
constexpr int kConvMinThreads = 256;   // over which a block's MAC spreads
constexpr int kConvMaxStreams = 16;    // G of stream_conv at most
constexpr int kPartMinThreads = 64;    // per block of partitioned_conv
constexpr int kFrameThreads = 256;     // per block of frame_spectra at most

// G of stream_conv at most: 2G transforms of T = 2B/16 threads fit
// kConvMaxThreads.
__host__ __device__ constexpr int conv_max_streams(int log2n) {
  return (kConvMaxThreads >> (log2n - 3)) < kConvMaxStreams
             ? kConvMaxThreads >> (log2n - 3)
             : kConvMaxStreams;
}

// Threads of a stream_conv block of G streams: the 2G inverses' 2G·T, at
// least kConvMinThreads, and where P > 1 enough for G·2B (bin, partition)
// pairs at once, up to kConvMaxThreads.
__host__ __device__ constexpr int conv_threads(int log2n, int G, int P) {
  const int inv = G << (log2n - 3);
  const int wide = P > 1 ? (G << log2n) < kConvMaxThreads ? G << log2n
                                                           : kConvMaxThreads
                         : 0;
  const int T = inv > wide ? inv : wide;
  return T > kConvMinThreads ? T : kConvMinThreads;
}

// Threads of a partitioned_conv block: a power of two from max(64, 2T) up
// to kConvMaxThreads (the host picks it from the blocks and the SM count).
__host__ __device__ constexpr bool part_threads_ok(int log2n, int threads) {
  const int lo = (1 << (log2n - 3)) > kPartMinThreads ? 1 << (log2n - 3)
                                                      : kPartMinThreads;
  return threads >= lo && threads <= kConvMaxThreads &&
         (threads & (threads - 1)) == 0;
}

// Groups of partitions whose MACs run at once: as many as the threads hold
// G·B bins each, at least 1, at most P.
__host__ __device__ constexpr int conv_part_groups(int log2n, int G,
                                                   int threads, int P) {
  const int g = threads / (G << (log2n - 1));
  const int groups = g > 1 ? g : 1;
  return groups < P ? groups : P;
}

// complex64 of shared memory: with `forward`, the ⌈G/2⌉ forward buffers
// below the MAC's sums (groups · G · 4 planes · (B+1)); the 2G inverses'
// buffers over both once they are read.
__host__ __device__ constexpr int conv_shared_f2(int log2n, int G, int groups,
                                                 bool forward) {
  const int row = (1 << log2n) + (1 << (log2n - 4));
  const int fwd = forward ? (G + 1) / 2 * row : 0;
  const int acc = groups * G * 4 * ((1 << (log2n - 1)) + 1);
  return fwd + acc > 2 * G * row ? fwd + acc : 2 * G * row;
}

// Transforms per block of frame_spectra at most.
__host__ __device__ constexpr int frame_max_groups(int log2n) {
  return (kFrameThreads >> (log2n - 4)) > 1 ? kFrameThreads >> (log2n - 4)
                                            : 1;
}

// y0 += X·H[h], y1 += X·H[h + F2]: one partition's product for both ears
// at the bin that h names.
__device__ __forceinline__ void mac_ears(float2 X, const float* __restrict__ re,
                                         const float* __restrict__ im,
                                         size_t h, int F2, float2& y0,
                                         float2& y1) {
  y0 = cadd(y0, cmul(X, make_float2(__ldg(re + h), __ldg(im + h))));
  y1 = cadd(y1, cmul(X, make_float2(__ldg(re + h + F2), __ldg(im + h + F2))));
}

// The inverse of slot (g, e): Z = Yn_e + i·Yp_e (Yp = 0 without
// crossfade), each summed over the partition groups in order from acc
// (plane p of stream g and group pg at ((pg·G + g)·4 + p)·(B+1)), Z[n − k]
// from the mirror; the last B samples blended, u·Re + (1 − u)·Im (Re
// without crossfade), into ye[0 … B). buf is the slot's exchange buffer,
// which may overlay acc: every thread of the block calls this.
template <int kLog2N>
__device__ __forceinline__ void conv_inverse(const float2* acc, int G,
                                             int groups, int g, int e,
                                             bool live, int crossfade,
                                             float2* buf, int lane,
                                             const float2* __restrict__ tw,
                                             float* __restrict__ ye) {
  using PN = RegPlan<kLog2N>;
  constexpr int n = PN::n, B = n / 2, F2 = B + 1, T = PN::threads;
  constexpr int R = PN::radix(PN::passes - 1), Ns = n / R;
  float2 v[16];
  if (live) {
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int p = lane + m * T;
      const int k = p <= B ? p : n - p;
      float2 A = make_float2(0.f, 0.f), Bv = A;
      for (int pg = 0; pg < groups; ++pg) {
        const float2* a = acc + static_cast<size_t>((pg * G + g) * 4) * F2 + k;
        A = cadd(A, a[e * F2]);
        if (crossfade) Bv = cadd(Bv, a[(2 + e) * F2]);
      }
      if (k == 0 || k == B) {
        A.y = 0.f;
        Bv.y = 0.f;
      }
      v[m] = p <= B ? make_float2(A.x - Bv.y, A.y + Bv.x)
                    : make_float2(A.x + Bv.y, Bv.x - A.y);
    }
    dft<16>(v);
  }
  __syncthreads();  // acc is read: the passes' buffers may overlay it
  reg_passes_live<kLog2N, 1>(v, buf, lane, tw, live);
  if (!live) return;
  // the last pass's sub-DFT j = lane + s·T holds samples j + q·Ns; those
  // of q ≥ R/2 are the last B, sample i = j + (q − R/2)·Ns of them
  const float inv_n = 1.0f / n;
  const float inv_B = 1.0f / B;
#pragma unroll
  for (int s = 0; s < 16 / R; ++s)
#pragma unroll
    for (int q = R / 2; q < R; ++q) {
      const int i = lane + s * T + (q - R / 2) * Ns;
      const float2 z = v[s * R + q];
      const float u = (i + 0.5f) * inv_B;
      ye[i] = (crossfade ? u * z.x + (1.0f - u) * z.y : z.x) * inv_n;
    }
}

// Inputs of stream_conv's register body; shapes as the radix-2 body's.
struct StreamArgs {
  const float* xb;
  const float* prev_in;
  const float* fdl_re;
  const float* fdl_im;
  const float* H_re;
  const float* H_im;
  const float* Hp_re;
  const float* Hp_im;
  const float* started;
  float* y;
  float* prev_out;
  float* fdl_re_out;
  float* fdl_im_out;
  const float2* tw;  // exp(+2πi·m/2B), m < 2B
  int S, P, crossfade, G, groups;
};

// stream_conv's register body: streams b·G … b·G + G − 1 of block b, in
// three phases: the forward transforms (slot f < ⌈G/2⌉ packs streams 2f
// and 2f + 1), the MAC, the 2G inverses (slot j: stream j/2, ear j mod 2).
template <int kLog2N>
__global__ void __launch_bounds__(kConvMaxThreads, 2)
    stream_conv_kernel(const StreamArgs a) {
  using PN = RegPlan<kLog2N>;
  constexpr int n = PN::n, B = n / 2, F2 = B + 1, T = PN::threads;
  constexpr int R = PN::radix(PN::passes - 1), Ns = n / R;
  static_assert(PN::passes > 1 && PN::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int slot = tid / T;
  const int lane = tid % T;
  const int G = a.G;
  const int s0 = blockIdx.x * G;
  const int pairs = (G + 1) / 2;

  // rfft_2B of [prev_in | xb] of streams sa and sa + 1 as one transform of
  // conj(a + i·b); prev_out = xb. The spectrum Z = A + i·B lands in natural
  // order in the slot's buffer.
  {
    const int sa = s0 + 2 * slot;
    const bool on = slot < pairs && sa < a.S;
    const bool two = on && 2 * slot + 1 < G && sa + 1 < a.S;
    float2* buf = smem + slot * PN::row_f2;
    float2 v[16];
    if (on) {
      const size_t oa = static_cast<size_t>(sa) * B;
      const size_t ob = oa + B;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int t = lane + (m & 7) * T;  // position m·T + lane of the frame
        float fa, fb = 0.f;
        if (m < 8) {
          fa = __ldg(a.prev_in + oa + t);
          if (two) fb = __ldg(a.prev_in + ob + t);
        } else {
          fa = __ldg(a.xb + oa + t);
          a.prev_out[oa + t] = fa;
          if (two) {
            fb = __ldg(a.xb + ob + t);
            a.prev_out[ob + t] = fb;
          }
        }
        v[m] = make_float2(fa, -fb);
      }
      dft<16>(v);
    }
    reg_passes_live<kLog2N, 1>(v, buf, lane, a.tw, on);
    __syncthreads();  // the last pass has read buf
    if (on) {
#pragma unroll
      for (int s = 0; s < 16 / R; ++s)
#pragma unroll
        for (int q = 0; q < R; ++q)
          buf[lane + s * T + q * Ns] = conj(v[s * R + q]);
    }
    __syncthreads();
  }

  // the MAC: unit u is bin k of stream g for the partitions q ≡ pg (mod
  // groups); slot 0 of the delay line is the new frame, slot q the old
  // slot q − 1. The first push of a stream takes its own filter as the
  // previous one.
  float2* acc = smem + pairs * PN::row_f2;
  const int units = a.groups * G * F2;
  for (int u = tid; u < units; u += blockDim.x) {
    const int pg = u / (G * F2);
    const int r = u - pg * G * F2;
    const int g = r / F2;
    const int k = r - g * F2;
    const int s = s0 + g;
    if (s >= a.S) continue;
    const bool prev = a.crossfade && __ldg(a.started + s) > 0.5f;
    const float* Pr = prev ? a.Hp_re : a.H_re;
    const float* Pi = prev ? a.Hp_im : a.H_im;
    float2 n0 = make_float2(0.f, 0.f), n1 = n0, p0 = n0, p1 = n0;
    const size_t sp = static_cast<size_t>(s) * a.P;
    // partition q's slot of the delay line, and its products
    auto partition = [&](int q, float2 X) {
      const size_t fi = (sp + q) * F2 + k;
      a.fdl_re_out[fi] = X.x;
      a.fdl_im_out[fi] = X.y;
      const size_t h = (sp + q) * 2 * F2 + k;
      mac_ears(X, a.H_re, a.H_im, h, F2, n0, n1);
      if (a.crossfade) mac_ears(X, Pr, Pi, h, F2, p0, p1);
    };
    int q = pg;
    if (q == 0) {  // the new frame, unpacked from bins k and 2B − k
      const float2* z = smem + (g >> 1) * PN::row_f2;
      float2 Xa, Xb;
      unpack_pair(z[k], z[(n - k) & (n - 1)], &Xa, &Xb);
      partition(0, g & 1 ? Xb : Xa);
      q = a.groups;
    }
#pragma unroll 4
    for (; q < a.P; q += a.groups) {  // the old slot q − 1, from memory
      const size_t fi = (sp + q - 1) * F2 + k;
      partition(q, make_float2(__ldg(a.fdl_re + fi), __ldg(a.fdl_im + fi)));
    }
    float2* o = acc + static_cast<size_t>((pg * G + g) * 4) * F2 + k;
    o[0] = n0;
    o[F2] = n1;
    if (a.crossfade) {
      o[2 * F2] = p0;
      o[3 * F2] = p1;
    }
  }
  __syncthreads();

  const int g = slot >> 1;
  const int s = s0 + g;
  conv_inverse<kLog2N>(acc, G, a.groups, g, slot & 1,
                       slot < 2 * G && s < a.S, a.crossfade,
                       smem + slot * PN::row_f2, lane, a.tw,
                       a.y + (static_cast<size_t>(s) * 2 + (slot & 1)) * B);
}

// The frame spectra of frames f0 … f0 + frames − 1 of x (nb, B), frame c =
// [x[c−1] | x[c]] (x[−1] = 0), f0 even: X (frames, B+1) complex64. Block
// b's slot j < G transforms frames c = f0 + 2i and c + 1, i = b·G + j, as
// one complex frame (frame c + 1 wherever it lies in x, so a frame's bits
// do not depend on the range asked for), then writes the spectra in the
// range, bins lane + m·T (m < 8) and, on lane 0, B, unpacked from bins k
// and 2B − k.
struct FrameArgs {
  const float* x;  // (nb, B)
  float2* X;  // (frames, B+1)
  const float2* tw;  // exp(+2πi·m/2B), m < 2B
  int f0, frames, nb, G;
};

template <int kLog2N>
__global__ void __launch_bounds__(kFrameThreads)
    frame_spectra_kernel(const FrameArgs a) {
  using PN = RegPlan<kLog2N>;
  constexpr int n = PN::n, B = n / 2, F2 = B + 1, T = PN::threads;
  constexpr int R = PN::radix(PN::passes - 1), Ns = n / R;
  static_assert(PN::passes > 1 && PN::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int slot = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  const int i = blockIdx.x * a.G + slot;
  const int c = a.f0 + 2 * i;
  const bool on = slot < a.G && 2 * i < a.frames;
  const bool two = on && c + 1 < a.nb;  // frame c + 1 exists
  float2* buf = smem + slot * PN::row_f2;
  float2 v[16];
  if (on) {
    // frame c's halves are blocks c − 1 and c, frame c + 1's c and c + 1
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = lane + (m & 7) * T;
      const int blk = c - 1 + (m >= 8);
      const float fa =
          blk < 0 ? 0.f : __ldg(a.x + static_cast<size_t>(blk) * B + t);
      const float fb =
          two ? __ldg(a.x + static_cast<size_t>(blk + 1) * B + t) : 0.f;
      v[m] = make_float2(fa, -fb);
    }
    dft<16>(v);
  }
  reg_passes_live<kLog2N, 1>(v, buf, lane, a.tw, on);
  __syncthreads();  // the last pass has read buf
  if (on) {
#pragma unroll
    for (int s = 0; s < 16 / R; ++s)
#pragma unroll
      for (int q = 0; q < R; ++q)
        buf[lane + s * T + q * Ns] = conj(v[s * R + q]);
  }
  __syncthreads();
  if (!on) return;
  float2* Xa = a.X + static_cast<size_t>(2 * i) * F2;
  auto bin = [&](int k) {
    float2 A, Bk;
    unpack_pair(buf[k], buf[(n - k) & (n - 1)], &A, &Bk);
    Xa[k] = A;
    if (2 * i + 1 < a.frames) Xa[F2 + k] = Bk;
  };
#pragma unroll
  for (int m = 0; m < 8; ++m) bin(lane + m * T);
  if (lane == 0) bin(B);
}

// Inputs of partitioned_conv's register body.
struct PartArgs {
  const float2* X;  // frame spectra of frames f0 …, (·, B+1)
  const float* H_re;  // filter rows as the radix-2 body's
  const float* H_im;
  float* y;  // (2, nb·B)
  const float2* tw;  // exp(+2πi·m/2B), m < 2B
  int nb, b0, has_prev, dir_rate, f0, P, crossfade, groups;
};

// partitioned_conv's register body: output block b = b0 + blockIdx.x, the
// MAC of X[b − q] (q < P, b − q ≥ 0) under its row and its predecessor's
// (as the radix-2 body), then the two ears' inverses at once.
template <int kLog2N>
__global__ void __launch_bounds__(kConvMaxThreads, 2)
    partitioned_conv_kernel(const PartArgs a) {
  using PN = RegPlan<kLog2N>;
  constexpr int n = PN::n, B = n / 2, F2 = B + 1, T = PN::threads;
  static_assert(PN::passes > 1 && PN::points == 16,
                "the register plan takes 16 points a thread");
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int b = a.b0 + static_cast<int>(blockIdx.x);
  const size_t row =
      static_cast<size_t>(b / a.dir_rate - a.b0 / a.dir_rate + a.has_prev);
  const size_t prow = b > 0 && b % a.dir_rate == 0 ? row - 1 : row;
  const int qmax = a.P < b + 1 ? a.P : b + 1;  // frames b − q ≥ 0
  for (int u = tid; u < a.groups * F2; u += blockDim.x) {
    const int pg = u / F2;
    const int k = u - pg * F2;
    float2 n0 = make_float2(0.f, 0.f), n1 = n0, p0 = n0, p1 = n0;
#pragma unroll 4
    for (int q = pg; q < qmax; q += a.groups) {
      const float2 X =
          __ldg(a.X + static_cast<size_t>(b - q - a.f0) * F2 + k);
      mac_ears(X, a.H_re, a.H_im, (row * a.P + q) * 2 * F2 + k, F2, n0, n1);
      if (a.crossfade)
        mac_ears(X, a.H_re, a.H_im, (prow * a.P + q) * 2 * F2 + k, F2, p0,
                 p1);
    }
    float2* o = smem + static_cast<size_t>(pg * 4) * F2 + k;
    o[0] = n0;
    o[F2] = n1;
    if (a.crossfade) {
      o[2 * F2] = p0;
      o[3 * F2] = p1;
    }
  }
  __syncthreads();
  const int slot = tid / T;
  conv_inverse<kLog2N>(smem, 1, a.groups, 0, slot & 1, slot < 2, a.crossfade,
                       smem + slot * PN::row_f2, tid % T, a.tw,
                       a.y + static_cast<size_t>(slot & 1) * a.nb * B +
                           static_cast<size_t>(b) * B);
}

// Launch `kernel` on `grid` blocks of `threads` threads with `shared_f2`
// complex64 of dynamic shared memory.
template <typename Args>
int launch_conv(void (*kernel)(Args), int grid, int threads, int shared_f2,
                const Args& args, cudaStream_t stream) {
  const int smem = shared_f2 * static_cast<int>(sizeof(float2));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int kLog2N>
struct Log2N {
  static constexpr int value = kLog2N;
};

// launch(Log2N<log2n>{}) for 2B = 2^log2n of the register range, else an
// error.
template <int kLog2N = kConvMinLog2N, class Launch>
int dispatch(int log2n, const Launch& launch) {
  if constexpr (kLog2N > kConvMaxLog2N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2n != kLog2N) return dispatch<kLog2N + 1>(log2n, launch);
    return launch(Log2N<kLog2N>{});
  }
}

bool conv_register(int log2n) {
  return log2n >= kConvMinLog2N && log2n <= kConvMaxLog2N;
}

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// See stream_conv_kernel; Hp_* may alias H_* (the hold step). slices > 0:
// split mode, scratch holds slices · 6B complex64, and tw, G, threads and
// shared_f2 are unused. Otherwise B = 64 … 2048 takes the register body
// with tw the table of exp(+2πi·m/2B) and G, threads and shared_f2 the
// plan's (ops/conv_plan.py `stream_launch`); other blocks the radix-2 body,
// with G = 0.
int tt_stream_conv(const void* xb, const void* prev_in, const void* fdl_re,
                   const void* fdl_im, const void* H_re, const void* H_im,
                   const void* Hp_re, const void* Hp_im, const void* started,
                   void* y, void* prev_out, void* fdl_re_out,
                   void* fdl_im_out, const void* tw, int S, int B, int P,
                   int crossfade, int G, int threads, int shared_f2,
                   void* scratch, int slices, int work, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int log2n = ilog2(2 * B);
  const bool reg = conv_register(log2n);
  if (slices == 0 && (G > 0) != reg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 0 && reg) {
    const int groups = power_of_two(G) ? conv_part_groups(log2n, G, threads, P)
                                       : 0;
    if (!power_of_two(G) || G > conv_max_streams(log2n) || P < 1 ||
        threads != conv_threads(log2n, G, P) ||
        shared_f2 != conv_shared_f2(log2n, G, groups, true) || tw == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const StreamArgs a{static_cast<const float*>(xb),
                       static_cast<const float*>(prev_in),
                       static_cast<const float*>(fdl_re),
                       static_cast<const float*>(fdl_im),
                       static_cast<const float*>(H_re),
                       static_cast<const float*>(H_im),
                       static_cast<const float*>(Hp_re),
                       static_cast<const float*>(Hp_im),
                       static_cast<const float*>(started),
                       static_cast<float*>(y),
                       static_cast<float*>(prev_out),
                       static_cast<float*>(fdl_re_out),
                       static_cast<float*>(fdl_im_out),
                       static_cast<const float2*>(tw),
                       S,
                       P,
                       crossfade,
                       G,
                       groups};
    return dispatch(log2n, [&](auto N) {
      return launch_conv(static_cast<void (*)(StreamArgs)>(
                             stream_conv_kernel<decltype(N)::value>),
                         (S + G - 1) / G, threads, shared_f2, a, st);
    });
  }
  using Radix2 = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const float*,
                          const float*, const float*, const float*, float*,
                          float*, float*, float*, int, int, int, int, float2*,
                          int);
  const Radix2 kernel = slices > 0
                            ? static_cast<Radix2>(stream_conv_kernel<true>)
                            : static_cast<Radix2>(stream_conv_kernel<false>);
  Launch l;
  const int err = launch_shape(kernel, S, slices, work, 7 * B, &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, st>>>(
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

// x: (nb, B) f32; X: (frames, B+1) complex64, the spectra of frames f0 …
// f0 + frames − 1 (frame c = [x[c−1] | x[c]]), f0 even; tw the table of
// exp(+2πi·m/2B). B = 64 … 2048 only; G, threads and shared_f2 the plan's
// (ops/conv_plan.py `frames_launch`).
int tt_frame_spectra(const void* x, void* X, const void* tw, int f0,
                     int frames, int nb, int B, int G, int threads,
                     int shared_f2, void* stream) {
  const int log2n = ilog2(2 * B);
  if (!conv_register(log2n) || !power_of_two(G) ||
      G > frame_max_groups(log2n) || threads != (G << (log2n - 4)) ||
      shared_f2 != G * (2 * B + 2 * B / 16) || f0 < 0 || f0 % 2 ||
      frames < 1 || f0 + frames > nb || tw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameArgs a{static_cast<const float*>(x), static_cast<float2*>(X),
                    static_cast<const float2*>(tw), f0, frames, nb, G};
  const int transforms = (frames + 1) / 2;
  return dispatch(log2n, [&](auto N) {
    return launch_conv(frame_spectra_kernel<decltype(N)::value>,
                       (transforms + G - 1) / G, threads, shared_f2, a,
                       static_cast<cudaStream_t>(stream));
  });
}

// x: (nb, B) f32; H_re, H_im: (rows, P, 2, B+1) f32, the filter rows
// ⌊b0/k⌋ − has_prev … ⌊(b0 + n_blocks − 1)/k⌋ with k = dir_rate and b0 a
// multiple of k; y: (2, nb·B) f32. slices > 0: split mode, scratch holds
// slices · (4B + 4(B+1)) complex64. Otherwise B = 64 … 2048 takes the
// register body: X the frame spectra of frames f0 = max(0, b0 − P + 1) …
// b0 + n_blocks − 1 (tt_frame_spectra), tw the table of exp(+2πi·m/2B),
// threads and shared_f2 the plan's (ops/conv_plan.py `conv_launch`); other
// blocks the radix-2 body, with X null and threads 0.
int tt_partitioned_conv(const void* x, const void* X, const void* H_re,
                        const void* H_im, void* y, const void* tw, int nb,
                        int b0, int n_blocks, int has_prev, int dir_rate,
                        int f0, int B, int P, int crossfade, int threads,
                        int shared_f2, void* scratch, int slices, int work,
                        void* stream) {
  if (dir_rate < 1 || b0 % dir_rate)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int log2n = ilog2(2 * B);
  const bool reg = conv_register(log2n);
  if (slices == 0 && (threads > 0) != reg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 0 && reg) {
    const int groups = conv_part_groups(log2n, 1, threads, P);
    if (P < 1 || !part_threads_ok(log2n, threads) ||
        shared_f2 != conv_shared_f2(log2n, 1, groups, false) ||
        X == nullptr || tw == nullptr || f0 < 0 || f0 % 2 ||
        f0 > (b0 - P + 1 > 0 ? b0 - P + 1 : 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const PartArgs a{static_cast<const float2*>(X),
                     static_cast<const float*>(H_re),
                     static_cast<const float*>(H_im),
                     static_cast<float*>(y),
                     static_cast<const float2*>(tw),
                     nb,
                     b0,
                     has_prev,
                     dir_rate,
                     f0,
                     P,
                     crossfade,
                     groups};
    return dispatch(log2n, [&](auto N) {
      return launch_conv(static_cast<void (*)(PartArgs)>(
                             partitioned_conv_kernel<decltype(N)::value>),
                         n_blocks, threads, shared_f2, a, st);
    });
  }
  using Radix2 = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, int, int, int, int, int, float2*,
                          int);
  const Radix2 kernel =
      slices > 0 ? static_cast<Radix2>(partitioned_conv_kernel<true>)
                 : static_cast<Radix2>(partitioned_conv_kernel<false>);
  Launch l;
  const int err = launch_shape(kernel, n_blocks, slices, work,
                               5 * B + 4 * (B + 1), &l);
  if (err) return err;
  kernel<<<l.grid, 256, l.smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(H_re),
      static_cast<const float*>(H_im), static_cast<float*>(y), nb, b0,
      n_blocks, has_prev, dir_rate, B, P, crossfade,
      static_cast<float2*>(scratch), work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
