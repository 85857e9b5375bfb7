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


// ------------------------------------------------------------------------
// Shared by the assembly kernels (assembly_mac.cu, partitioned.cu).

// The delay ramp of common.cuh delay_ramp_bin at bin q < L/2 + 1 for the
// clipped shift d, with the bin's constants from tables: the exact integer
// phase exp(−2πi·((q·⌊d⌋) mod L)/L) and sin θ, cos θ (θ = −2πq/L) from
// twL, the taper w from `taper`. ψ only counts where w < 1. The rest of
// the phase is taken in units of π (θ/π = −2q/L exactly), so sincospif
// needs no range reduction and no local memory.
__device__ __forceinline__ float2 ramp_bin(int q, int L, float d,
                                           const float2* __restrict__ twL,
                                           const float* __restrict__ taper) {
  const float di = floorf(d);
  const float frac = d - di;
  const float2 e = __ldg(twL + ((q * static_cast<int>(di)) & (L - 1)));
  const float wt = __ldg(taper + q);
  const float theta_pi = -2.0f * (static_cast<float>(q) / L);
  float ph = wt * theta_pi * frac;
  if (wt < 1.0f) {
    const float2 c = __ldg(twL + q);  // cos θ = c.x, sin θ = −c.y
    const float psi = atan2f(-frac * c.y, (1.0f - frac) + frac * c.x);
    ph += (1.0f - wt) * (psi * (1.0f / CUDART_PI_F));
  }
  float sp, cp;
  sincospif(ph, &sp, &cp);
  return cmul(make_float2(e.x, -e.y), make_float2(cp, sp));
}

__device__ __forceinline__ float2 conj(float2 a) {
  return make_float2(a.x, -a.y);
}

// ------------------------------------------------------------------------
// The cluster mode: an n-point transform, 2^15 ≤ n ≤ 2^17 (and 2^14 for
// the assembly kernels, a cluster of one), spread over a thread-block
// cluster of C = n/M blocks (ranks) of 1024 threads, M = 16384, C ≤ 8 (the
// portable cluster size), as four steps: with k = M·k1 + k2 and
// t = t1 + C·t2,
//   z[t1 + C·t2] = Σ_k2 e^{2πi·k2·t2/M} · e^{2πi·k2·t1/n} ·
//                  Σ_k1 Z[M·k1 + k2] · e^{2πi·k1·t1/C}.
// Rank c's threads hold the inputs k2 of a contiguous M/C-range, all C of
// each (cluster_spread): the C-point DFT and the twiddle run in registers,
// and u_t1[k2] goes to rank t1 through distributed shared memory (DSMEM),
// each thread's stores on neighbouring addresses of the remote share. After
// one cluster barrier every rank runs the M-point register FFT of RegPlan
// on its own share (cluster_local_fft): rank t1 ends with outputs
// t1 + C·t2. So a transform crosses the cluster once, its reads all local
// and its remote accesses all posted stores. The order reversed (the local
// FFT of the inputs ≡ k1 mod C first, the C-point DFT last) gives outputs
// in contiguous M-blocks per rank; the assembly kernel's inverse runs so.
// A share is RegPlan<14>::row_f2 complex64 (139,264 B).

#include <cstdint>

constexpr int kClusterMaxLog2N = 17;
constexpr int kClusterThreads = 1024;

template <int kLog2N>
struct ClusterPlan {
  using Local = RegPlan<kRegMaxLog2N>;  // each rank's M-point transform
  static constexpr int n = 1 << kLog2N;
  static constexpr int M = Local::n;
  static constexpr int ranks = n / M;  // C
  static constexpr int span = M / ranks;  // the inputs k2 of one rank
  static constexpr int share_f2 = Local::row_f2;
  static_assert(ranks >= 1 && ranks <= 8 && Local::threads == kClusterThreads,
                "a cluster of 1 to 8 blocks of 1024 threads");
};

// Cluster barrier halves (arrive releases, wait acquires); one block alone
// keeps to __syncthreads.
template <int kRanks>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (kRanks > 1)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

template <int kRanks>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (kRanks > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  else
    __syncthreads();
}

// buf[local] of rank `rank` = v (buf: the same shared array in every
// block of the cluster); a plain store where the rank is this block's.
template <int kRanks>
__device__ __forceinline__ void st_rank(float2* buf, int rank, int self,
                                        int local, float2 v) {
  if (kRanks == 1 || rank == self) {
    buf[local] = v;
  } else {
    const uint32_t a =
        static_cast<uint32_t>(__cvta_generic_to_shared(buf + local));
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(a), "r"(rank));
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote),
                 "f"(v.x), "f"(v.y)
                 : "memory");
  }
}

// The cross-rank step. On entry v[s·C + k1] holds Z[M·k1 + k2] for
// k2 = rank·span + tid + s·1024 (s < 16/C), and the thread has arrived on
// the cluster barrier since the last read of buf by its block (or at the
// kernel's start). The C-point DFT over k1 and the twiddle
// e^{2πi·k2·t1/n} (tw: the n-point table) run in registers; u_t1[k2] is
// stored at local k2 of rank t1; on return every rank's buf holds its
// u[0 … M) and no arrive is outstanding.
template <class Plan>
__device__ __forceinline__ void cluster_spread(float2 (&v)[16], float2* buf,
                                               int rank, int tid,
                                               const float2* __restrict__ tw) {
  constexpr int C = Plan::ranks, S = 16 / C;
  if constexpr (C > 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k2 = rank * Plan::span + tid + s * kClusterThreads;
      float2 x[C];
#pragma unroll
      for (int k1 = 0; k1 < C; ++k1) x[k1] = v[s * C + k1];
      dft<C>(x);
#pragma unroll
      for (int t1 = 0; t1 < C; ++t1)
        v[s * C + t1] = t1 ? cmul(x[t1], __ldg(tw + k2 * t1)) : x[t1];
    }
  }
  cluster_wait<C>();  // every block runs and is done with its buf
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t1 = 0; t1 < C; ++t1)
      st_rank<C>(buf, t1, rank,
                 rank * Plan::span + tid + s * kClusterThreads, v[s * C + t1]);
  cluster_arrive<C>();
  cluster_wait<C>();  // every store has landed
}

// The M-point register FFT of this block's buf[0 … M) (natural order):
// on return the last pass's sub-DFT j = tid + s·1024 holds outputs
// j + r·M/4 in v[4s + r], that is output tid + 1024·(s + 4r).
__device__ __forceinline__ void cluster_local_fft(
    float2 (&v)[16], float2* buf, int tid, const float2* __restrict__ twM) {
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = buf[tid + r * kClusterThreads];
  __syncthreads();  // buf becomes the passes' exchange buffer
  dft<16>(v);
  reg_passes<kRegMaxLog2N, 1>(v, buf, tid, twM);
}

// The output index of v[m] after cluster_local_fft: RegPlan<14>'s last
// radix is 4.
__device__ __forceinline__ constexpr int local_out(int m) {
  return (m >> 2) + 4 * (m & 3);
}
static_assert(RegPlan<kRegMaxLog2N>::radix(RegPlan<kRegMaxLog2N>::passes - 1)
                  == 4,
              "local_out assumes a last radix of 4");

// Bins q = min(k, n − k) a rank pairs up after a cluster forward transform
// (cluster_pairs): 8192, the last rank's n/2 beside them.
constexpr int kClusterPairs = (1 << kRegMaxLog2N) / 2;
static_assert(2 * kClusterPairs + 2 <= RegPlan<kRegMaxLog2N>::row_f2,
              "the pair exchange fits a share");

// The pair exchange after a forward transform computed as the conjugate of
// the inverse (cluster_spread, cluster_local_fft): on entry v[m] holds
// conj(Z[k]), k = rank + C·(tid + 1024·local_out(m)), and the block's
// passes may still read buf. Each Z[k] goes to the rank of bin
// q = min(k, n − k), o = min(q / 8192, C − 1), slot 2·(q − o·8192), plus
// 1 for the mirror k > n/2; bins 0 and n/2 are their own mirrors and fill
// both slots, and n/2 lands on the last rank at pair 8192. On return every
// rank's buf holds Z[q], Z[n − q] of its bins q = rank·8192 + l side by
// side at float4 l, and no arrive is outstanding.
template <class Plan>
__device__ __forceinline__ void cluster_pairs(const float2 (&v)[16],
                                              float2* buf, int rank,
                                              int tid) {
  constexpr int n = Plan::n, C = Plan::ranks;
  cluster_arrive<C>();  // this block's passes have read buf
  cluster_wait<C>();
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int k = rank + C * (tid + kClusterThreads * local_out(m));
    const bool lo = k <= n / 2;
    const int q = lo ? k : n - k;
    const int o = min(q / kClusterPairs, C - 1);
    const int at = 2 * (q - o * kClusterPairs);
    const float2 z = conj(v[m]);
    st_rank<C>(buf, o, rank, at + (lo ? 0 : 1), z);
    if (k == 0 || k == n / 2) st_rank<C>(buf, o, rank, at + 1, z);
  }
  cluster_arrive<C>();
  cluster_wait<C>();  // every pair has landed
}

// This thread's index and its block's rank in the cluster, read anew on
// every row of a kernel that loops over rows: the addresses and exchange
// slots derived from them are then computed on each row, not hoisted out
// of the row loop into registers, where at 64 a thread they spilled
// (assembly_mac's cluster kernel: 1140 B of spill stores against 540 B,
// and 0.520 ms against 0.436 at 128 rows × 16,384 taps on an H100,
// scripts/torch_mac_ab.py).
__device__ __forceinline__ int fresh_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int fresh_rank() {
  int v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

// How many clusters of cfg's shape the device places at once for kernel:
// read once per kernel and device (cudaOccupancyMaxActiveClusters) and
// kept; ≥ 0, or a CUDA error negated.
inline int cluster_count(const void* kernel, const cudaLaunchConfig_t* cfg) {
  struct Seen {
    const void* kernel;
    int device, clusters;
  };
  static Seen seen[64];
  static int count = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  for (int i = 0; i < count; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device)
      return seen[i].clusters;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (count < 64) seen[count++] = {kernel, device, clusters};
  return clusters;
}

// 0 where the device places at least one cluster of cfg's shape for
// kernel, else the error (cudaErrorLaunchOutOfResources where it places
// none).
inline int cluster_capacity(const void* kernel, const cudaLaunchConfig_t* cfg) {
  const int clusters = cluster_count(kernel, cfg);
  if (clusters < 0) return -clusters;
  return clusters > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// The launch of kernel on `clusters` clusters of `ranks` blocks of
// kClusterThreads threads with `smem` bytes of dynamic shared memory each,
// the kernel's shared-memory limit raised to it; attr is the cluster
// attribute the config points to.
template <typename... Params>
int cluster_config(void (*kernel)(Params...), int clusters, int ranks,
                   int smem, cudaStream_t stream, cudaLaunchAttribute* attr,
                   cudaLaunchConfig_t* cfg) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(clusters * ranks);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// The clusters of `ranks` blocks with `smem` bytes each that the current
// device runs at once for kernel: ≥ 0, or a CUDA error negated.
template <typename... Params>
int cluster_slots(void (*kernel)(Params...), int ranks, int smem) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int err = cluster_config(kernel, 1, ranks, smem, nullptr, &attr, &cfg);
  if (err) return -err;
  return cluster_count(reinterpret_cast<const void*>(kernel), &cfg);
}

// Launch kernel on `clusters` clusters of `ranks` blocks of
// kClusterThreads threads with `smem` bytes of dynamic shared memory each.
// The first launch of a kernel on a device reads how many such clusters
// the device places at once and refuses (cudaErrorLaunchOutOfResources)
// where it places none; a launch that fails returns its error.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int clusters, int ranks,
                   int smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int bad = cluster_config(kernel, clusters, ranks, smem, stream, &attr,
                                 &cfg);
  if (bad) return bad;
  const int fit = cluster_capacity(reinterpret_cast<const void*>(kernel), &cfg);
  if (fit) return fit;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
