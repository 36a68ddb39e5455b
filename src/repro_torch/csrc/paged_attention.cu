// Paged gather decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (body _kernel, _online_update): single-token GQA
// attention where each slot walks its own block table over
// (n_pages, page_size, Hkv, D) K/V pools with an f32 online softmax. A
// virtual row r of the slot's gathered pages last held absolute position
// q_pos - floor_mod(cache_pos - r, rows); negative (never written) and,
// with a window, out-of-window rows are masked with -1e30 (not -inf, so a
// fully masked page gives exp(m_prev - m_new) = 0, never NaN). The null
// page 0 that unmapped table entries point at masks out the same way.
//
// What bounds it on the H100: the bytes of the mapped K/V pages (and the
// block table); the arithmetic is 4*G*D flops per row read, far below the
// card's ridge. The TPU kernel DMA'd whole pages off a scalar-prefetched
// block table; here a block loads its own table entries and stages one
// (page_size x D) K and V tile per page in shared memory, rows padded to
// D+1 floats so the per-row dot products are free of bank conflicts.
//
// Design: grid (Hkv, B), 256 threads: one block per (slot, kv head) holds
// the G query heads of that kv head; scores for all (g, row) pairs of a
// page, a warp per query head for the online-softmax update, and the
// (G x D) accumulator in shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ cache_pos, T* __restrict__ out,
                       int pages, int PS, int Hkv, int G, int D, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;                 // [G][D]
  float* ks = qs + G * D;           // [PS][D+1]
  float* vs = ks + PS * DP;         // [PS][D+1]
  float* ss = vs + PS * DP;         // [G][PS] scores, then probabilities
  float* ms = ss + G * PS;          // [G][PS] 1 = valid row
  float* acc = ms + G * PS;         // [G][D]
  float* m_run = acc + G * D;       // [G]
  float* l_run = m_run + G;         // [G]
  float* alpha = l_run + G;         // [G]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = THREADS / 32;
  const int Hq = Hkv * G;
  const int rows = pages * PS;
  const int qp = q_pos[b], cp = cache_pos[b];
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;

  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = nq::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }

  for (int p = 0; p < pages; ++p) {
    const int page = block_table[(size_t)b * pages + p];
    __syncthreads();  // previous page fully consumed
    for (int i = tid; i < PS * D; i += THREADS) {
      const int row = i / D, d = i % D;
      const size_t src = (((size_t)page * PS + row) * Hkv + h) * D + d;
      ks[row * DP + d] = nq::to_f32(kpool[src]);
      vs[row * DP + d] = nq::to_f32(vpool[src]);
    }
    __syncthreads();
    for (int i = tid; i < G * PS; i += THREADS) {
      const int g = i / PS, row = i % PS;
      const int r = p * PS + row;
      const int abs_pos = qp - nq::floor_mod(cp - r, rows);
      const bool valid = abs_pos >= 0 && (window == 0 || abs_pos > qp - window);
      float s = -1e30f;
      if (valid) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qs[g * D + d] * ks[row * DP + d];
        s = dot * scale;
      }
      ss[i] = s;
      ms[i] = valid ? 1.f : 0.f;
    }
    __syncthreads();
    for (int g = warp; g < G; g += n_warps) {
      float mx = -INFINITY;
      for (int row = lane; row < PS; row += 32) mx = fmaxf(mx, ss[g * PS + row]);
      mx = nq::warp_max(mx);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int row = lane; row < PS; row += 32) {
        const int i = g * PS + row;
        const float pe = ms[i] != 0.f ? expf(ss[i] - m_new) : 0.f;
        ss[i] = pe;
        psum += pe;
      }
      psum = nq::warp_sum(psum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[g] = a;
        l_run[g] = l_run[g] * a + psum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = acc[i] * alpha[g];
      for (int row = 0; row < PS; ++row) a += ss[g * PS + row] * vs[row * DP + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS)
    ob[i] = nq::from_f32<T>(acc[i] / fmaxf(l_run[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* block_table, const void* q_pos, const void* cache_pos,
           void* out, int B, int pages, int PS, int Hkv, int G, int D,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * G * D + 2 * PS * (D + 1) + 2 * G * PS + 3 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(block_table),
      static_cast<const int*>(q_pos), static_cast<const int*>(cache_pos),
      static_cast<T*>(out), pages, PS, Hkv, G, D, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, 1, Hkv*G, D); pools: (n_pages, PS, Hkv, D); block_table: (B, pages)
// int32; q_pos, cache_pos: (B,) int32; out: (B, 1, Hkv*G, D). q, pools and
// out share one dtype. Returns the cudaError_t of the launch.
extern "C" int nq_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* block_table,
                                  const void* q_pos, const void* cache_pos,
                                  void* out, int B, int pages, int PS, int Hkv,
                                  int G, int D, int window, float scale,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nq::kFloat32)
    return launch<float>(q, kpool, vpool, block_table, q_pos, cache_pos, out,
                         B, pages, PS, Hkv, G, D, window, scale, st);
  if (dtype == nq::kBFloat16)
    return launch<__nv_bfloat16>(q, kpool, vpool, block_table, q_pos,
                                 cache_pos, out, B, pages, PS, Hkv, G, D,
                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}
