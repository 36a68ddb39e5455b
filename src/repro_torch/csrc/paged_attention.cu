// Paged gather decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (body _kernel, _online_update): single-token GQA
// attention where each slot walks its own block table over
// (n_pages, page_size, Hkv, D) K/V pools with an f32 online softmax. A
// virtual row r of the slot's gathered pages last held absolute position
// q_pos - floor_mod(cache_pos - r, rows); negative (never written) and,
// with a window, out-of-window rows are masked, and so is the null page 0
// that unmapped table entries point at.
//
// What bounds it on the H100: the bytes of the mapped K/V pages; the
// arithmetic is 4*G*D flops per row read, far below the card's ridge. At
// decode the pages of one slot are few, so the kernel is mostly latency:
// the design spreads the walk and keeps copies in flight.
//
// Design: a thin kernel over the split page walk of paged_walk.cuh. One
// block of 256 threads per work item (slot, kv head, split); the split
// count comes from kernels/paged_attention.py::_plan_paged, so a decode
// batch's items fill the card. Pages with no valid row are never loaded;
// the others arrive by 16-byte cp.async through a two-page ring. A bf16
// pool takes QK^T and PV on the tensor cores, f32 the CUDA cores. The
// splits of a (slot, head), at most 8, are one thread block cluster: they
// merge in split order through distributed shared memory, in the same
// launch, with no round trip through device memory.
#include <cooperative_groups.h>

#include "paged_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using nq::walk::Smem;
using nq::walk::Walk;

constexpr int MAX_CLUSTER = 8;  // splits per (slot, head): the portable cluster

template <typename T, bool TC>
__global__ void __launch_bounds__(nq::walk::THREADS)
paged_attention_kernel(const T* __restrict__ q, T* __restrict__ out, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem, w.G, w.D, w.PS, w.pages, sizeof(T));
  const int split = blockIdx.x % w.splits, bh = blockIdx.x / w.splits;
  const int b = bh / w.Hkv, h = bh % w.Hkv;
  const int G = w.G, D = w.D, GD = G * D, S = w.splits, tid = threadIdx.x;
  nq::walk::walk_begin<T>(w, sm, b, h, split);
  const T* qb = q + (size_t)bh * GD;  // the G query heads of kv head h
  for (int i = tid; i < GD; i += blockDim.x) sm.q[i] = nq::to_f32(qb[i]);
  nq::walk::walk_run<T, TC>(w, sm, b, h);
  T* ob = out + (size_t)bh * GD;
  if (S == 1) {
    for (int i = tid; i < GD; i += blockDim.x)
      ob[i] = nq::from_f32<T>(sm.acc[i] / fmaxf(sm.l[i / D], 1e-30f));
    return;
  }
  // the S splits of (b, h) are one cluster (rank = split): each block
  // reads every split's (m, l) and writes its share of the output from
  // every split's acc, all in split order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* wt = sm.red;     // [S][G] the splits' weights
  float* lt = sm.alpha;   // [G] the merged l
  for (int g = tid; g < G; g += blockDim.x) {
    float mt = -INFINITY;
    for (int s = 0; s < S; ++s)
      mt = fmaxf(mt, cluster.map_shared_rank(sm.m, s)[g]);
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = cluster.map_shared_rank(sm.m, s)[g];
      const float wgt = ms == -INFINITY ? 0.f : expf(ms - mt);
      wt[s * G + g] = wgt;
      l += cluster.map_shared_rank(sm.l, s)[g] * wgt;
    }
    lt[g] = l;
  }
  __syncthreads();
  for (int i = split * blockDim.x + tid; i < GD; i += S * blockDim.x) {
    const int g = i / D;
    float v = 0.f;
    for (int s = 0; s < S; ++s)
      v += wt[s * G + g] * cluster.map_shared_rank(sm.acc, s)[i];
    ob[i] = nq::from_f32<T>(v / fmaxf(lt[g], 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

// Raise the kernel's dynamic shared memory limit to at least `smem`. The
// launch and the occupancy query share this one record, so that a query
// for a smaller shape never lowers the limit under a larger shape's
// launch.
template <typename T, bool TC>
cudaError_t size_smem(size_t smem) {
  static size_t sized = 0;  // the attribute covers every size up to this
  if (smem <= sized) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) sized = smem;
  return err;
}

template <typename T, bool TC>
int launch(const void* q, void* out, const Walk& w, int B,
           cudaStream_t stream) {
  const size_t smem = Smem(nullptr, w.G, w.D, w.PS, w.pages, sizeof(T)).bytes;
  auto kernel = paged_attention_kernel<T, TC>;
  cudaError_t err = size_smem<T, TC>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * w.Hkv * w.splits), 1, 1);
  cfg.blockDim = dim3(nq::walk::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = w.splits;  // a (slot, head)'s splits
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<T*>(out), w);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TC>
int clusters(const Walk& w, int* out) {
  const size_t smem = Smem(nullptr, w.G, w.D, w.PS, w.pages, sizeof(T)).bytes;
  auto kernel = paged_attention_kernel<T, TC>;
  cudaError_t err = size_smem<T, TC>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w.splits * 1024, 1, 1);
  cfg.blockDim = dim3(nq::walk::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = w.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace

// Clusters of `splits` blocks of the kernel for these shapes and dtype that
// fit on the current device at once, into *out.
extern "C" int nq_paged_attention_clusters(int G, int D, int PS, int pages,
                                           int splits, int dtype, int* out) {
  Walk w{};
  w.G = G, w.D = D, w.PS = PS, w.pages = pages, w.splits = splits;
  if (dtype == nq::kFloat32) return clusters<float, false>(w, out);
  return nq::walk::tensor_walk(G, D, PS) ? clusters<__nv_bfloat16, true>(w, out)
                                         : clusters<__nv_bfloat16, false>(w, out);
}

// q: (B, 1, Hkv*G, D); pools: (n_pages, PS, Hkv, D); block_table: (B, pages)
// int32; q_pos, cache_pos: (B,) int32; out: (B, 1, Hkv*G, D). q, pools and
// out share one dtype (pools 16-byte aligned, D a multiple of 8). eps,
// splits (at most 8): the plan (_plan_paged). Returns the cudaError_t of
// the launch.
extern "C" int nq_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* block_table,
                                  const void* q_pos, const void* cache_pos,
                                  void* out, int B, int pages, int PS,
                                  int Hkv, int G, int D, int window,
                                  float scale, int eps, int splits, int dtype,
                                  void* stream) {
  Walk w{kpool, vpool, static_cast<const int*>(block_table),
         static_cast<const int*>(q_pos), static_cast<const int*>(cache_pos),
         nullptr, nullptr, pages, PS, Hkv, G, D, window, scale, eps, splits,
         0};
  if (D % 8 || G * D > 4 * nq::walk::MAX_ITEMS * nq::walk::THREADS ||
      splits * G > 4 * nq::walk::THREADS || splits < 1 ||
      splits > MAX_CLUSTER || eps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nq::kFloat32) return launch<float, false>(q, out, w, B, st);
  if (dtype == nq::kBFloat16)
    return nq::walk::tensor_walk(G, D, PS)
               ? launch<__nv_bfloat16, true>(q, out, w, B, st)
               : launch<__nv_bfloat16, false>(q, out, w, B, st);
  return (int)cudaErrorInvalidValue;
}
