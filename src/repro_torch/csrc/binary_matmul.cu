// Fused grouped low-rank binary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py::
// fused_lowrank_matmul_grouped (body _fused_kernel): for G groups in one
// launch, y_g = s1_g * ((((x * s2_g) @ V_g) * rmask_g) @ U_g), where V_g
// and U_g are +-1 matrices packed 32 signs per 32-bit word along their
// reduction axis. The rank intermediate t is f32 and lives only in shared
// memory. eff_rank reads the leading r_eff rank columns of the full
// operands (a loop bound, never a copy).
//
// What bounds it on the H100: at decode (M <= 8) the packed factors are
// the only large input (4.1 MB for the llama3.2-1b gate-up group), so the
// floor is the HBM read; at prefill (M = 512) the M*K*R + M*R*N
// multiply-adds dominate. This first design does the +-1 products on the
// CUDA cores in full f32 — a +-1 factor only flips the sign bit, so each
// product is one XOR plus one add and no float is ever unpacked — which
// keeps f32 results within 1e-5 of the plain version but leaves the
// tensor cores idle; that makes it compute-bound at every shape.
//
// Design: grid (n_split, M-tiles of BM rows, G), 256 threads, in
// clusters of CL blocks along x. The CL blocks of a cluster share one
// (group, M-tile): each runs stage 1 for its own 1/CL of the rank
// columns (K in chunks of KC, activations staged in shared memory, each
// thread owning a rank column and all BM rows so one packed word feeds
// 32*BM products); the blocks then gather the whole rank intermediate,
// applying rmask, from each other's shared memory (distributed shared
// memory, never device memory) and each runs stage 2 for its own
// N-slice. n_split is a multiple of CL; with several clusters per
// (group, M-tile) each cluster recomputes stage 1, which buys blocks at
// decode, where one M-tile is all there is.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 8;         // activation rows per block
constexpr int KC = 256;       // K columns staged per chunk (8 words)
constexpr int THREADS = 256;
constexpr int CL = 8;         // blocks per cluster (the portable maximum)

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
fused_lowrank_kernel(const T* __restrict__ x, long long x_gstride,
                     const uint32_t* __restrict__ qv,
                     const uint32_t* __restrict__ qu,
                     const float* __restrict__ s1,
                     const float* __restrict__ s2,
                     const float* __restrict__ rmask, T* __restrict__ out,
                     int M, int K, int R, int r_eff, int N, int n_per_block) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rc = (r_eff + CL - 1) / CL;     // rank columns per block
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * rc;
  const int r1 = min(r_eff, r0 + rc);
  float* t_own = smem;                      // [BM][rc]: columns [r0, r1)
  float* t_s = t_own + BM * rc;             // [BM][r_eff], gathered
  float* xs = t_s + BM * r_eff;             // [BM][KC]
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const T* xg = x + (size_t)g * x_gstride;
  const uint32_t* qvg = qv + (size_t)g * (K / 32) * R;
  const uint32_t* qug = qu + (size_t)g * (R / 32) * N;
  const float* s2g = s2 + (size_t)g * K;
  const float* s1g = s1 + (size_t)g * N;
  const float* rmg = rmask + (size_t)g * R;

  // ---- stage 1: this block's rank columns of t = (x * s2) @ V, f32 ----
  for (int i = tid; i < BM * rc; i += THREADS) t_own[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // t_own zeroed / previous chunk fully consumed
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int m = i / KC, kk = i % KC;
      float v = 0.f;
      if (m0 + m < M && kk < kc)
        v = nq::to_f32(xg[(size_t)(m0 + m) * K + k0 + kk]) * s2g[k0 + kk];
      xs[i] = v;
    }
    __syncthreads();
    for (int r = r0 + tid; r < r1; r += THREADS) {
      float acc[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m] = t_own[m * rc + r - r0];
      for (int w = 0; w < kc / 32; ++w) {
        const uint32_t word = qvg[(size_t)(k0 / 32 + w) * R + r];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
#pragma unroll
          for (int m = 0; m < BM; ++m)
            acc[m] += nq::signed_by(xs[m * KC + w * 32 + b], word, b);
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) t_own[m * rc + r - r0] = acc[m];
    }
  }

  // ---- gather the whole intermediate from the cluster's blocks, masked ----
  cluster.sync();  // every block's columns are final
  for (int i = tid; i < BM * r_eff; i += THREADS) {
    const int m = i / r_eff, r = i % r_eff, owner = r / rc;
    const float* src = cluster.map_shared_rank(t_own, owner);
    t_s[i] = src[m * rc + r - owner * rc] * rmg[r];
  }
  cluster.sync();  // no block leaves while another still reads its columns

  // ---- stage 2: this block's N-slice of (t @ U) * s1 ----
  const int n_begin = blockIdx.x * n_per_block;
  const int n_end = min(N, n_begin + n_per_block);
  for (int n = n_begin + tid; n < n_end; n += THREADS) {
    float acc[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[m] = 0.f;
    for (int w = 0; w < r_eff / 32; ++w) {
      const uint32_t word = qug[(size_t)w * N + n];
#pragma unroll
      for (int b = 0; b < 32; ++b) {
#pragma unroll
        for (int m = 0; m < BM; ++m)
          acc[m] += nq::signed_by(t_s[m * r_eff + w * 32 + b], word, b);
      }
    }
    const float sc = s1g[n];
#pragma unroll
    for (int m = 0; m < BM; ++m)
      if (m0 + m < M)
        out[((size_t)g * M + m0 + m) * N + n] = nq::from_f32<T>(acc[m] * sc);
  }
}

template <typename T>
int launch(const void* x, long long x_gstride, const void* qv, const void* qu,
           const void* s1, const void* s2, const void* rmask, void* out, int G,
           int M, int K, int R, int r_eff, int N, int n_split,
           cudaStream_t stream) {
  if (n_split % CL) return (int)cudaErrorInvalidValue;
  const int rc = (r_eff + CL - 1) / CL;
  const size_t smem = (size_t)(BM * rc + BM * r_eff + BM * KC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_lowrank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_per_block = (N + n_split - 1) / n_split;
  dim3 grid(n_split, (M + BM - 1) / BM, G);
  fused_lowrank_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), x_gstride, static_cast<const uint32_t*>(qv),
      static_cast<const uint32_t*>(qu), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(rmask),
      static_cast<T*>(out), M, K, R, r_eff, N, n_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (Gx, M, K) in dtype, x_gstride = 0 when the groups share x, else M*K;
// qv: (G, K/32, R) words; qu: (G, R/32, N) words; s1: (G, N) f32;
// s2: (G, K) f32; rmask: (G, R) f32; out: (G, M, N) in dtype.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nq_fused_lowrank(const void* x, long long x_gstride,
                                const void* qv, const void* qu, const void* s1,
                                const void* s2, const void* rmask, void* out,
                                int G, int M, int K, int R, int r_eff, int N,
                                int n_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nq::kFloat32)
    return launch<float>(x, x_gstride, qv, qu, s1, s2, rmask, out, G, M, K, R,
                         r_eff, N, n_split, st);
  if (dtype == nq::kBFloat16)
    return launch<__nv_bfloat16>(x, x_gstride, qv, qu, s1, s2, rmask, out, G,
                                 M, K, R, r_eff, N, n_split, st);
  return (int)cudaErrorInvalidValue;
}
