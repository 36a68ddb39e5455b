// Packed binary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py::packed_matmul
// (body _kernel), the building block of the two-call low-rank chain:
// y = ((x * s_k) @ W) * s_n for one +-1 matrix W of shape (K, N), packed
// 32 signs per 32-bit word along K into (K/32, N) words. The sum is f32;
// the output is stored in the requested dtype (x's, or f32 for a rank
// intermediate that must not round).
//
// What bounds it on the H100: at decode (M <= 8) the packed words are the
// only large input (43 MB for the qwen1.5-110b w_down stage 1), so the
// floor is the HBM read; from M of a few rows on, the M*K*N products
// dominate. As in binary_matmul.cu the products run on the CUDA cores in
// f32, which keeps f32 results within 1e-5 of the plain version and
// leaves the tensor cores idle: each word bit becomes a +-1.0 float once
// (two integer operations) and feeds BM fused multiply-adds, one per
// activation row.
//
// Design: grid (ks, M-tiles of BM rows, N-tiles of BN columns), BN = 256
// threads, one output column per thread. Each block walks its 1/ks of the
// K words in chunks of KC rows: it loads the chunk's words of its column
// (8 loads in flight per thread), stages x * s_k for those rows in shared
// memory ([k][m], so a row's BM values are one broadcast vector load), and
// accumulates BM sums. The ks blocks of one output tile form a thread
// block cluster (ks <= 8, set at launch); their partial sums meet in
// distributed shared memory and are added in rank order, so the result is
// deterministic and never leaves the chip before the epilogue. ks is set
// by the wrapper to fill the SMs when N and M alone give too few tiles
// (qwen1.5-110b w_down stage 1: K 49152, only 28 column tiles).
//
// Edges are masked in the kernel, never padded: rows past M and columns
// past N are neither read nor written, and a K split past the last word
// contributes nothing (a padded word of 0 would unpack to -1). The packed
// operand takes a row stride, so a column slice W[:, :N'] of a wider
// matrix (an eff_rank view) is read in place.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 256;       // output columns per block, one per thread
constexpr int THREADS = BN;
constexpr int KC = 256;       // K rows per chunk
constexpr int WC = KC / 32;   // packed words per chunk
constexpr int MAX_KS = 8;     // K-split blocks per cluster (portable maximum)

template <typename TI, typename TO, int BM>
__global__ void __launch_bounds__(THREADS)
packed_matmul_kernel(const TI* __restrict__ x, const uint32_t* __restrict__ w,
                     long long ldw, const float* __restrict__ sk,
                     const float* __restrict__ sn, TO* __restrict__ out, int M,
                     int K, int N, int kw_per) {
  __shared__ __align__(16) float xs[KC * BM];     // [k][m]: x * s_k
  __shared__ float part[BM * THREADS];            // [m][column]: partial sums
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n = blockIdx.z * BN + tid;
  const bool col_ok = n < N;
  const int KW = K / 32;
  const int w_begin = min(KW, split * kw_per);
  const int w_end = min(KW, w_begin + kw_per);
  const uint32_t* wcol = w + (col_ok ? n : 0);

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int w0 = w_begin; w0 < w_end; w0 += WC) {
    const int nw = min(WC, w_end - w0);
    uint32_t words[WC];
#pragma unroll
    for (int i = 0; i < WC; ++i)
      words[i] = (col_ok && i < nw) ? wcol[(size_t)(w0 + i) * ldw] : 0u;
    __syncthreads();  // the previous chunk is fully consumed
    const int k0 = w0 * 32, kc = nw * 32;
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int m = i / KC, kk = i % KC;
      float v = 0.f;
      if (m0 + m < M && kk < kc) {
        v = nq::to_f32(x[(size_t)(m0 + m) * K + k0 + kk]);
        if (sk != nullptr) v *= sk[k0 + kk];
      }
      xs[kk * BM + m] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      if (i < nw) {
        const uint32_t word = words[i];
        const float* xk = xs + i * 32 * BM;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          // +1.0f when bit b is set, -1.0f when clear
          const float sgn =
              __uint_as_float(0x3f800000u | (((~word >> b) & 1u) << 31));
#pragma unroll
          for (int m = 0; m < BM; ++m) acc[m] = fmaf(xk[b * BM + m], sgn, acc[m]);
        }
      }
    }
  }

  if (ks == 1) {
    if (col_ok) {
      const float sc = sn != nullptr ? sn[n] : 1.f;
#pragma unroll
      for (int m = 0; m < BM; ++m)
        if (m0 + m < M)
          out[(size_t)(m0 + m) * N + n] = nq::from_f32<TO>(acc[m] * sc);
    }
    return;
  }
  // ---- add the ks partial sums of this tile, in rank order ----
#pragma unroll
  for (int m = 0; m < BM; ++m) part[m * THREADS + tid] = acc[m];
  cluster.sync();  // every block's partial sums are in its shared memory
  for (int m = split; m < BM; m += ks) {  // block `split` finishes rows m
    float s = 0.f;
    for (int r = 0; r < ks; ++r)
      s += cluster.map_shared_rank(part, r)[m * THREADS + tid];
    if (col_ok && m0 + m < M)
      out[(size_t)(m0 + m) * N + n] =
          nq::from_f32<TO>(s * (sn != nullptr ? sn[n] : 1.f));
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <typename TI, typename TO, int BM>
int launch(const void* x, const void* w, long long ldw, const void* sk,
           const void* sn, void* out, int M, int K, int N, int ks,
           cudaStream_t stream) {
  const int KW = K / 32;
  const int kw_per = (KW + ks - 1) / ks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (M + BM - 1) / BM, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, packed_matmul_kernel<TI, TO, BM>, static_cast<const TI*>(x),
      static_cast<const uint32_t*>(w), ldw, static_cast<const float*>(sk),
      static_cast<const float*>(sn), static_cast<TO*>(out), M, K, N, kw_per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch_bm(const void* x, const void* w, long long ldw, const void* sk,
              const void* sn, void* out, int M, int K, int N, int ks, int bm,
              cudaStream_t st) {
  switch (bm) {
    case 1: return launch<TI, TO, 1>(x, w, ldw, sk, sn, out, M, K, N, ks, st);
    case 2: return launch<TI, TO, 2>(x, w, ldw, sk, sn, out, M, K, N, ks, st);
    case 4: return launch<TI, TO, 4>(x, w, ldw, sk, sn, out, M, K, N, ks, st);
    case 8: return launch<TI, TO, 8>(x, w, ldw, sk, sn, out, M, K, N, ks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int launch_out(const void* x, const void* w, long long ldw, const void* sk,
               const void* sn, void* out, int M, int K, int N, int ks, int bm,
               int out_dtype, cudaStream_t st) {
  if (out_dtype == nq::kFloat32)
    return launch_bm<TI, float>(x, w, ldw, sk, sn, out, M, K, N, ks, bm, st);
  if (out_dtype == nq::kBFloat16)
    return launch_bm<TI, __nv_bfloat16>(x, w, ldw, sk, sn, out, M, K, N, ks,
                                        bm, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (M, K) in in_dtype, contiguous; w: (K/32, N) words with row stride ldw
// (>= N) and unit column stride; sk: (K,) f32 or null (ones); sn: (N,) f32
// or null (ones); out: (M, N) in out_dtype, contiguous. ks: K-split blocks
// per output tile (1..8, one cluster); bm: rows per block (1, 2, 4 or 8).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nq_packed_matmul(const void* x, const void* w, long long ldw,
                                const void* sk, const void* sn, void* out,
                                int M, int K, int N, int ks, int bm,
                                int in_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks < 1 || ks > MAX_KS || K % 32) return (int)cudaErrorInvalidValue;
  if (in_dtype == nq::kFloat32)
    return launch_out<float>(x, w, ldw, sk, sn, out, M, K, N, ks, bm,
                             out_dtype, st);
  if (in_dtype == nq::kBFloat16)
    return launch_out<__nv_bfloat16>(x, w, ldw, sk, sn, out, M, K, N, ks, bm,
                                     out_dtype, st);
  return (int)cudaErrorInvalidValue;
}
