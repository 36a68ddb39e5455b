// Packed binary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py::packed_matmul
// (body _kernel), the building block of the two-call low-rank chain:
// y = ((x * s_k) @ W) * s_n for one +-1 matrix W of shape (K, N), packed
// 32 signs per 32-bit word along K into (K/32, N) words. The sum is f32;
// the output is stored in the requested dtype (x's, or f32 for a rank
// intermediate that must not round).
//
// What bounds it on the H100: the function's floor at decode (M <= 8) is
// the HBM read of the packed words (43 MB for the qwen1.5-110b w_down
// stage 1), from some tens of rows on the M*K*N products at the bf16
// tensor rate. The products run on the tensor cores through the +-1 tile
// routine of binary_mma.cuh (mma.sync m16n8k16, the packed factor expanded
// in registers); what holds the kernel back from that floor is the
// routine's, see there. The operand x * s_k is what the plain version
// multiplies: f32 for f32 x, split into three bf16 terms for an f32 result
// and two for a bf16 one (the merged route's stage 2: an f32 rank
// intermediate into bf16); for bf16 x it is x * bf16(s_k) rounded to
// bf16, one exact term.
//
// Design: grid (ks, M-tiles of BM = 8*MT rows, N-tiles of BN = 128
// columns); four column warps of 32 columns each (two at decode per
// column, each over half the words). Each block walks its 1/ks of the K
// words in chunks: the chunk's words and raw activations (and s_k) are
// copied into shared memory with cp.async through a ring of buffers; the
// activations are split into bf16 terms in pair order, then multiplied.
// The ks blocks of one output tile form a thread block cluster (ks <= 8,
// set at launch); their partial sums meet in distributed shared memory and
// are added in rank order, so the result is deterministic and never leaves
// the chip before the epilogue. ks is set by the wrapper to give about
// four blocks per SM when N and M alone give too few tiles (qwen1.5-110b
// w_down stage 1: K 49152, 55 column tiles).
//
// Edges are masked in the kernel, never padded: rows past M and columns
// past N are neither read nor written, and a K split past the last word
// contributes nothing (a padded word of 0 would unpack to -1). The packed
// operand takes a row stride, so a column slice W[:, :N'] of a wider
// matrix (an eff_rank view) is read in place.
#include <cooperative_groups.h>

#include <type_traits>

#include "binary_mma.cuh"

namespace cg = cooperative_groups;
using namespace nq::mma1;

namespace {

constexpr int MAX_KS = 8;     // K-split blocks per cluster (portable maximum)

template <typename TI, typename TO>
__host__ __device__ constexpr int n_terms() {
  return std::is_same<TI, float>::value ? terms_for<TO>() : 1;
}

// Shared memory of a block: the word ring, one set of term planes, the
// raw x ring (`stride_rows` = min(BM, M) rows) and the s_k ring; the
// epilogue and the cluster reduction reuse it.
template <typename TI, int MT, int TERMS, int AT>
constexpr size_t smem_bytes(int stride_rows) {
  constexpr int KC = chunk_words(MT) * 32, BM = 8 * MT;
  const size_t loop = 4 * ((size_t)STAGES * chunk_words(MT) * BN +
                           term_words<MT, TERMS>(stride_rows)) +
                      (size_t)STAGES * stride_rows * KC * sizeof(TI) +
                      (size_t)STAGES * KC * 4;
  const size_t epilogue = 4 * (BM * BN + red_floats<MT, AT>());
  return loop > epilogue ? loop : epilogue;
}

// Raw x (and s_k) staged by cp.async, split into the term planes after
// they land. Only the tile's rows below M are staged and split.
template <typename TI, int MT, int TERMS>
struct RawAct {
  uint32_t* ts;      // TERMS planes of stride_rows rows, one set
  TI* raw;           // STAGES x [stride_rows][KC]
  float* skb;        // STAGES x [KC]
  const TI* x;       // row m0, column k0 of the block's K range
  const float* sk;   // column k0, or null
  int K, rows, stride_rows;  // rows staged here; rows per buffer
  static constexpr int KC = chunk_words(MT) * 32;

  __device__ __forceinline__ void issue(int buf, int w0, int nw) {
    constexpr int PER = 16 / sizeof(TI);    // elements per 16-byte copy
    const int q_row = nw * 32 / PER;
    TI* dst = raw + buf * stride_rows * KC;
    for (int i = threadIdx.x; i < rows * q_row; i += blockDim.x) {
      const int r = i / q_row, q = i % q_row;
      cp16(dst + r * KC + q * PER, x + (size_t)r * K + w0 * 32 + q * PER, 16);
    }
    if (sk != nullptr)
      for (int i = threadIdx.x; i < nw * 8; i += blockDim.x)
        cp16(skb + buf * KC + i * 4, sk + w0 * 32 + i * 4, 16);
  }

  __device__ __forceinline__ float operand(const TI* row, const float* s,
                                           int k) const {
    if constexpr (std::is_same<TI, float>::value) {
      return s != nullptr ? row[k] * s[k] : row[k];
    } else {  // the plain version's bf16 product x * bf16(s_k)
      if (s == nullptr) return __bfloat162float(row[k]);
      return nq::round_to<__nv_bfloat16>(
          __bfloat162float(row[k]) * nq::round_to<__nv_bfloat16>(s[k]));
    }
  }

  __device__ __forceinline__ TermView terms(int buf, int nw) {
    constexpr int RS = term_stride(MT);
    const int plane = stride_rows * RS;
    const TI* rb = raw + buf * stride_rows * KC;
    const float* sb = sk != nullptr ? skb + buf * KC : nullptr;
    for (int i = threadIdx.x; i < rows * nw * 16; i += blockDim.x) {
      const int r = i / (nw * 16), wp = i % (nw * 16);
      const int k = (wp / 16) * 32 + wp % 16;
      uint32_t out[TERMS];
      split_pair<TERMS>(operand(rb + r * KC, sb, k),
                        operand(rb + r * KC, sb, k + 16), out);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) ts[j * plane + r * RS + wp] = out[j];
    }
    __syncthreads();  // the terms are complete before any warp multiplies
    return {ts, rows, plane};
  }
};

template <typename TI, typename TO, int MT, int AT>
__global__ void __launch_bounds__(threads_for(MT))
packed_matmul_kernel(const TI* __restrict__ x, const uint32_t* __restrict__ w,
                     long long ldw, const float* __restrict__ sk,
                     const float* __restrict__ sn, TO* __restrict__ out, int M,
                     int K, int N, int kw_per, bool vec) {
  constexpr int TERMS = n_terms<TI, TO>(), KCW = chunk_words(MT), BM = 8 * MT;
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int KW = K / 32;
  const int w_begin = min(KW, split * kw_per);
  const int w_end = min(KW, w_begin + kw_per);

  const int stride_rows = min(BM, M);
  uint32_t* ws = smem;
  uint32_t* ts = ws + STAGES * KCW * BN;
  TI* raw = reinterpret_cast<TI*>(ts + term_words<MT, TERMS>(stride_rows));
  float* skb = reinterpret_cast<float*>(raw + STAGES * stride_rows * KCW * 32);
  RawAct<TI, MT, TERMS> act{ts, raw, skb,
                            x + (size_t)m0 * K + (size_t)w_begin * 32,
                            sk != nullptr ? sk + (size_t)w_begin * 32 : nullptr,
                            K, min(BM, M - m0), stride_rows};
  float sum[AT][FRAGS][4];
  tile_product<MT, TERMS, AT>(w + (size_t)w_begin * ldw + n0, ldw, N - n0, vec,
                          w_end - w_begin, act, ws, sum);

  float* part = reinterpret_cast<float*>(smem);  // [BM][BN]
  float* red = part + BM * BN;
  if (ks == 1) {
    finish_tile<MT, TERMS, AT>(sum, red, act.rows, [&](int m, int n, float v) {
      if (n0 + n < N)
        out[(size_t)(m0 + m) * N + n0 + n] =
            nq::from_f32<TO>(v * (sn != nullptr ? sn[n0 + n] : 1.f));
    });
    return;
  }
  // ---- add the ks partial sums of this tile, in rank order ----
  finish_tile<MT, TERMS, AT>(sum, red, act.rows,
                         [&](int m, int n, float v) { part[m * BN + n] = v; });
  cluster.sync();  // every block's partial sums are in its shared memory
  for (int e = split * blockDim.x + threadIdx.x; e < act.rows * BN;
       e += ks * blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < ks; ++r) s += cluster.map_shared_rank(part, r)[e];
    const int m = e / BN, n = e % BN;
    if (n0 + n < N)
      out[(size_t)(m0 + m) * N + n0 + n] =
          nq::from_f32<TO>(s * (sn != nullptr ? sn[n0 + n] : 1.f));
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

struct Launch {
  const void *x, *w;
  long long ldw;
  const void *sk, *sn;
  void* out;
  int M, K, N, ks;
  cudaStream_t stream;
};

template <typename TI, typename TO, int MT, int AT>
int launch(const Launch& a) {
  constexpr int TERMS = n_terms<TI, TO>();
  const size_t smem = smem_bytes<TI, MT, TERMS, AT>(min(8 * MT, a.M));
  auto kernel = packed_matmul_kernel<TI, TO, MT, AT>;
  static bool sized = false;  // the attribute is set once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<TI, MT, TERMS, AT>(8 * MT));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int KW = a.K / 32;
  const int kw_per = (KW + a.ks - 1) / a.ks;
  const bool vec =
      reinterpret_cast<uintptr_t>(a.w) % 16 == 0 && a.ldw % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(a.ks, (a.M + 8 * MT - 1) / (8 * MT), (a.N + BN - 1) / BN);
  cfg.blockDim = dim3(threads_for(MT), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TI*>(a.x),
      static_cast<const uint32_t*>(a.w), a.ldw,
      static_cast<const float*>(a.sk), static_cast<const float*>(a.sn),
      static_cast<TO*>(a.out), a.M, a.K, a.N, kw_per, vec);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch_bm(const Launch& a, int bm) {
  constexpr int T = n_terms<TI, TO>();
  switch (bm) {
    case 8: {  // M <= 8: col_tiles(T, M) tiles of (term, row) columns
      const int at = col_tiles(T, a.M);
      if constexpr (T >= 3) if (at == 3) return launch<TI, TO, 1, 3>(a);
      if constexpr (T >= 2) if (at == 2) return launch<TI, TO, 1, 2>(a);
      return launch<TI, TO, 1, 1>(a);
    }
    case 16: return launch<TI, TO, 2, 2>(a);
    case 32: return launch<TI, TO, 4, 4>(a);
    case 64: return launch<TI, TO, 8, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Launch& a, int bm, int in_dtype, int out_dtype) {
  if (bm == 8 && a.M > 8)  // bm 8 is the one tile of M <= 8
    return (int)cudaErrorInvalidValue;
  const bool f_in = in_dtype == nq::kFloat32, f_out = out_dtype == nq::kFloat32;
  if ((!f_in && in_dtype != nq::kBFloat16) ||
      (!f_out && out_dtype != nq::kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (f_in)
    return f_out ? launch_bm<float, float>(a, bm)
                 : launch_bm<float, __nv_bfloat16>(a, bm);
  return f_out ? launch_bm<__nv_bfloat16, float>(a, bm)
               : launch_bm<__nv_bfloat16, __nv_bfloat16>(a, bm);
}

}  // namespace

// x: (M, K) in in_dtype, contiguous, 16-byte aligned; w: (K/32, N) words
// with row stride ldw (>= N) and unit column stride; sk: (K,) f32, 16-byte
// aligned, or null (ones); sn: (N,) f32 or null (ones); out: (M, N) in
// out_dtype, contiguous. ks: K-split blocks per output tile (1..8, one
// cluster); bm: rows per block tile (8, 16, 32 or 64).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nq_packed_matmul(const void* x, const void* w, long long ldw,
                                const void* sk, const void* sn, void* out,
                                int M, int K, int N, int ks, int bm,
                                int in_dtype, int out_dtype, void* stream) {
  if (ks < 1 || ks > MAX_KS || K % 32) return (int)cudaErrorInvalidValue;
  const Launch a{x, w, ldw, sk, sn, out, M, K, N, ks,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(a, bm, in_dtype, out_dtype);
}

