// Fused grouped low-rank binary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py::
// fused_lowrank_matmul_grouped (body _fused_kernel): for G groups in one
// launch, y_g = s1_g * ((((x * s2_g) @ V_g) * rmask_g) @ U_g), where V_g
// and U_g are +-1 matrices packed 32 signs per 32-bit word along their
// reduction axis. The rank intermediate t is f32. eff_rank reads the
// leading r_eff rank columns of the full operands (a loop bound and a row
// stride, never a copy).
//
// What bounds it on the H100: the function's floor at decode (M <= 8) is
// the HBM read of the packed factors (12.6 MB for the qwen1.5-110b merged
// QKV group), at prefill the M*K*R + M*R*N products at the bf16 tensor
// rate. Both products run on the tensor cores through the +-1 tile routine
// of binary_mma.cuh (mma.sync m16n8k16, the packed factor expanded in
// registers; the f32 operands x * s2 and t * rmask split into three bf16
// terms for an f32 result, two for a bf16 one); what holds the kernel back
// from that floor is the routine's, see there, and at small shapes the
// three grid barriers.
//
// Design: one cooperative launch of a persistent grid of co-resident
// blocks (the wrapper sizes it from the occupancy query and the planner,
// kernels/binary_matmul.py::_plan_fused, and never larger, which is why
// the grid-wide barriers cannot deadlock). Four phases, a grid barrier
// between each:
//   0. x * s2_g, split into bf16 terms in pair order, into the workspace
//      (each element once per group, instead of once per block);
//   1. stage 1 work items (group, M-tile, 128 rank columns, K slice): each
//      is computed exactly once and writes its f32 partial sums to its own
//      slot of the workspace. K slices exist to fill the card at decode,
//      where one M-tile is all there is; at prefill the M-tiles do;
//   2. t = (sum of the slices, in slice order) * rmask, split into terms:
//      deterministic, no float atomics;
//   3. stage 2 work items (group, M-tile, 128 output columns): t @ U_g
//      through the routine, times s1 in the epilogue.
// The intermediate therefore goes through device memory, in a workspace
// the wrapper allocates: the f32 partials are G * slices * M * r_eff * 4
// bytes (1.6 MB for the qwen1.5-110b QKV group at M = 8 with 4 slices), a
// small share of the 12.6 MB of packed words, and L2 holds them; x * s2
// and t as bf16 terms take 2 * G * terms * M * (K + r_eff) bytes more.
#include <cooperative_groups.h>

#include "binary_mma.cuh"

namespace cg = cooperative_groups;
using namespace nq::mma1;

namespace {

// Shared memory of a block: the word ring and the term-plane ring, for
// tiles of at most stride_rows = min(BM, M) rows below M.
template <int MT, int TERMS, int AT>
constexpr size_t smem_bytes(int stride_rows) {
  const size_t loop = 4 * (size_t)STAGES *
                      (chunk_words(MT) * BN + term_words<MT, TERMS>(stride_rows));
  const size_t epilogue = 4 * (size_t)red_floats<MT, AT>();
  return loop > epilogue ? loop : epilogue;
}

struct Args {
  const void* x;
  long long x_gstride;
  const uint32_t* qv;
  const uint32_t* qu;
  const float* s1;
  const float* s2;
  const float* rmask;
  void* out;
  uint32_t* ws;
  int G, M, K, R, r_eff, N, slices, kw_per_slice;
  bool vec_v, vec_u;  // 16-byte copies of the packed words possible
};

template <typename T, int MT, int AT>
__global__ void __launch_bounds__(threads_for(MT))
    fused_lowrank_kernel(Args a) {
  constexpr int TERMS = terms_for<T>(), BM = 8 * MT;
  extern __shared__ __align__(16) uint32_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int G = a.G, M = a.M, K = a.K, R = a.R, r_eff = a.r_eff, N = a.N;
  const int KW = K / 32, RW = r_eff / 32, S = a.slices;
  const int m_tiles = (M + BM - 1) / BM;
  const int r_tiles = (r_eff + BN - 1) / BN, n_tiles = (N + BN - 1) / BN;
  uint32_t* xt = a.ws;                                   // [G][TERMS][M][KW][16]
  float* part = reinterpret_cast<float*>(xt + (size_t)G * TERMS * M * KW * 16);
  uint32_t* tt = reinterpret_cast<uint32_t*>(part + (size_t)G * S * M * r_eff);
  const int stride_rows = min(BM, M);
  uint32_t* ws = smem;                                   // STAGES x [KCW][BN]
  uint32_t* ts = ws + STAGES * chunk_words(MT) * BN;     // STAGES x planes
  float* red = reinterpret_cast<float*>(smem);           // the epilogue's
  const T* x = static_cast<const T*>(a.x);
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;

  // ---- 0: x * s2_g as bf16 terms, pair (p, p + 16) of each word ----
  for (long long e = gtid; e < (long long)G * M * KW * 16; e += gstride) {
    const int p = e % 16, w = (e / 16) % KW, m = (e / (16 * KW)) % M;
    const int g = e / (16LL * KW * M);
    const T* xr = x + g * a.x_gstride + (size_t)m * K + w * 32 + p;
    const float* sr = a.s2 + (size_t)g * K + w * 32 + p;
    uint32_t tv[TERMS];
    split_pair<TERMS>(nq::to_f32(xr[0]) * sr[0], nq::to_f32(xr[16]) * sr[16],
                      tv);
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
      xt[(((size_t)g * TERMS + j) * M + m) * KW * 16 + w * 16 + p] = tv[j];
  }
  grid.sync();

  // ---- 1: stage 1 items, each (group, M-tile, rank tile, K slice) once ----
  const int items1 = G * m_tiles * r_tiles * S;
  for (int item = blockIdx.x; item < items1; item += gridDim.x) {
    const int sl = item % S, rt = (item / S) % r_tiles;
    const int mt = (item / (S * r_tiles)) % m_tiles;
    const int g = item / (S * r_tiles * m_tiles);
    const int m0 = mt * BM, r0 = rt * BN, w0 = sl * a.kw_per_slice;
    const int nw = max(0, min(a.kw_per_slice, KW - w0));
    StagedTerms<MT, TERMS> act{ts, xt + (size_t)g * TERMS * M * KW * 16, M, KW,
                               m0, w0, stride_rows};
    float sum[AT][FRAGS][4];
    tile_product<MT, TERMS, AT>(a.qv + ((size_t)g * KW + w0) * R + r0, R,
                            r_eff - r0, a.vec_v, nw, act, ws, sum);
    float* dst = part + ((size_t)g * S + sl) * M * r_eff;
    finish_tile<MT, TERMS, AT>(sum, red, act.rows(), [&](int m, int r, float v) {
      if (r0 + r < r_eff) dst[(size_t)(m0 + m) * r_eff + r0 + r] = v;
    });
  }
  grid.sync();

  // ---- 2: t = (slices summed in order) * rmask, as bf16 terms ----
  for (long long e = gtid; e < (long long)G * M * RW * 16; e += gstride) {
    const int p = e % 16, w = (e / 16) % RW, m = (e / (16 * RW)) % M;
    const int g = e / (16LL * RW * M);
    const int k = w * 32 + p;
    const float* pr = part + (size_t)g * S * M * r_eff + (size_t)m * r_eff + k;
    float v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < S; ++s) {
      v0 += pr[(size_t)s * M * r_eff];
      v1 += pr[(size_t)s * M * r_eff + 16];
    }
    const float* rm = a.rmask + (size_t)g * R + k;
    uint32_t tv[TERMS];
    split_pair<TERMS>(v0 * rm[0], v1 * rm[16], tv);
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
      tt[(((size_t)g * TERMS + j) * M + m) * RW * 16 + w * 16 + p] = tv[j];
  }
  grid.sync();

  // ---- 3: stage 2 items (group, M-tile, output tile): (t @ U) * s1 ----
  T* out = static_cast<T*>(a.out);
  const int items2 = G * m_tiles * n_tiles;
  for (int item = blockIdx.x; item < items2; item += gridDim.x) {
    const int nt = item % n_tiles, mt = (item / n_tiles) % m_tiles;
    const int g = item / (n_tiles * m_tiles);
    const int m0 = mt * BM, n0 = nt * BN;
    StagedTerms<MT, TERMS> act{ts, tt + (size_t)g * TERMS * M * RW * 16, M, RW,
                               m0, 0, stride_rows};
    float sum[AT][FRAGS][4];
    tile_product<MT, TERMS, AT>(a.qu + (size_t)g * (R / 32) * N + n0, N, N - n0,
                            a.vec_u, RW, act, ws, sum);
    const float* s1 = a.s1 + (size_t)g * N + n0;
    T* dst = out + (size_t)g * M * N + n0;
    finish_tile<MT, TERMS, AT>(sum, red, act.rows(), [&](int m, int n, float v) {
      if (n0 + n < N) dst[(size_t)(m0 + m) * N + n] = nq::from_f32<T>(v * s1[n]);
    });
  }
}

template <typename T, int MT, int AT>
cudaError_t size_kernel(int M, size_t* smem) {
  constexpr int TERMS = terms_for<T>();
  *smem = smem_bytes<MT, TERMS, AT>(min(8 * MT, M));
  static bool sized = false;  // the attribute is set once per instantiation
  if (sized) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_lowrank_kernel<T, MT, AT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<MT, TERMS, AT>(8 * MT));
  sized = err == cudaSuccess;
  return err;
}

// With a: launch the kernel; without: the co-resident block count for M
// rows into *out.
template <typename T, int MT, int AT>
int run(int M, const Args* a, int grid, cudaStream_t stream, int* out) {
  size_t smem;
  cudaError_t err = size_kernel<T, MT, AT>(M, &smem);
  if (err != cudaSuccess) return (int)err;
  if (a == nullptr) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_lowrank_kernel<T, MT, AT>, threads_for(MT), smem);
    if (err != cudaSuccess) return (int)err;
    *out = per_sm * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads_for(MT), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_lowrank_kernel<T, MT, AT>, *a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bm(int bm, int M, const Args* a, int grid, cudaStream_t st,
                int* out) {
  constexpr int TERMS = terms_for<T>();
  switch (bm) {
    case 8: {  // M <= 8: col_tiles(TERMS, M) tiles of (term, row) columns
      const int at = col_tiles(TERMS, M);
      if constexpr (TERMS >= 3) if (at == 3) return run<T, 1, 3>(M, a, grid, st, out);
      if (at == 2) return run<T, 1, 2>(M, a, grid, st, out);
      return run<T, 1, 1>(M, a, grid, st, out);
    }
    case 16: return run<T, 2, 2>(M, a, grid, st, out);
    case 32: return run<T, 4, 4>(M, a, grid, st, out);
    case 64: return run<T, 8, 8>(M, a, grid, st, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int bm, int M, const Args* a, int grid,
             cudaStream_t st, int* out) {
  if (bm == 8 && M > 8)  // bm 8 is the one tile of M <= 8
    return (int)cudaErrorInvalidValue;
  if (dtype == nq::kFloat32)
    return dispatch_bm<float>(bm, M, a, grid, st, out);
  if (dtype == nq::kBFloat16)
    return dispatch_bm<__nv_bfloat16>(bm, M, a, grid, st, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the kernel for row tile bm, M rows and dtype that fit on the
// current device at once (occupancy per SM times the SM count), into *out.
// Shared memory depends on M only up to bm rows.
extern "C" int nq_fused_lowrank_blocks(int bm, int M, int dtype, int* out) {
  return dispatch(dtype, bm, M, nullptr, 0, nullptr, out);
}

// x: (Gx, M, K) in dtype, x_gstride = 0 when the groups share x, else M*K;
// qv: (G, K/32, R) words; qu: (G, R/32, N) words; s1: (G, N) f32;
// s2: (G, K) f32; rmask: (G, R) f32; out: (G, M, N) in dtype; ws: the
// workspace of the plan (16-byte aligned); bm, slices, kw_per_slice, grid:
// the plan (kernels/binary_matmul.py::_plan_fused).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nq_fused_lowrank(const void* x, long long x_gstride,
                                const void* qv, const void* qu, const void* s1,
                                const void* s2, const void* rmask, void* out,
                                void* ws, int G, int M, int K, int R,
                                int r_eff, int N, int bm, int slices,
                                int kw_per_slice, int grid, int dtype,
                                void* stream) {
  Args a{x, x_gstride, static_cast<const uint32_t*>(qv),
         static_cast<const uint32_t*>(qu), static_cast<const float*>(s1),
         static_cast<const float*>(s2), static_cast<const float*>(rmask),
         out, static_cast<uint32_t*>(ws), G, M, K, R, r_eff, N, slices,
         kw_per_slice, reinterpret_cast<uintptr_t>(qv) % 16 == 0,
         reinterpret_cast<uintptr_t>(qu) % 16 == 0 && N % 4 == 0};
  if (K % 32 || R % 32 || r_eff % 32 || slices < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, bm, M, &a, grid, static_cast<cudaStream_t>(stream),
                  nullptr);
}
