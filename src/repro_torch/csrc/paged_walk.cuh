// The split page walk shared by paged_attention.cu (#2) and megakernel.cu
// (#3), for sm_90a.
//
// One work item is (slot b, kv head h, split s): a split is a contiguous
// run of block-table entries, and kernels/paged_attention.py::_plan_paged
// chooses how many splits each (slot, head) gets, so that a decode batch
// fills the card (64 (slot, head) pairs at llama3.2-1b B = 8 would hold 64
// of 132 SMs). An item folds the G query heads of kv head h over its
// split's pages with an f32 online softmax into (m, l, acc[G x D]).
//
// What bounds it: the bytes of the mapped K/V pages; the arithmetic is
// 4*G*D flops per row read. So the walk
//  - never loads a page none of whose rows is valid: before any load, warp
//    0 lists the split's entries that hold a valid row, from the positions
//    alone (q_pos, cache_pos, window and, for #3, the excluded row r ==
//    cache_pos). That is exact: such a page adds p = 0 to every sum, and
//    the null page 0 behind unmapped entries falls out the same way;
//  - copies each listed page's K and V rows of head h with 16-byte
//    cp.async through a ring of RING pages (rows padded by 16 bytes), the
//    first ones put in flight before the caller writes the query rows, so
//    the copies are never what the walk waits for (measured on the H100:
//    cutting the copies out left the time unchanged).
// What holds it back instead is the instruction work per page: each
// (kv head, page) is a block's worth of scoring, softmax and PV, and a
// decode batch's pages are few, so the cost is latency and issue slots.
//  - f32 runs on the CUDA cores (to hold 1e-5): scores with LPR (at most
//    4) lanes over D and a shuffle reduction, each lane reading a K piece
//    once for GB query heads whose dot products and reductions interleave
//    (no thread runs a D-long chain); PV with each thread on 4 consecutive
//    d of one query head over an interleaved share of the page's rows (row
//    groups), the groups' sums added in a fixed order when the split ends.
//  - bf16 (when tensor_walk() takes the shape) runs QK^T and PV on the
//    tensor cores (mma.sync m16n8k16) with the G query rows as the A tile;
//    the probabilities round to bf16 for PV, as the plain version rounds
//    them.
//
// Merge: with one split the item's block holds the result. With several,
// the splits are merged in split order, so the output is bit-identical
// from run to run and no float atomics are used: kernel #2 launches the
// splits of a (slot, head) as one thread block cluster and merges them
// through distributed shared memory; the megakernel, whose persistent
// blocks take items in turn, merges through a workspace (merge_splits). A slot with no valid row at
// all returns acc = 0, l = 0 (m = -inf), which normalises to 0, as the
// Pallas kernel does.
#pragma once

#include "binary_mma.cuh"

namespace nq {
namespace walk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING = 2;        // pages in the copy ring (3 measured no faster,
                               // and it halves the blocks per SM at D = 128)
constexpr int GB = 8;          // query heads scored together
constexpr int MAX_ITEMS = 4;   // PV items (4 d of one head) per thread

// The page walk's operands and plan. part / tickets are merge_splits'
// (with splits > 1).
struct Walk {
  const void* kpool;      // (n_pages, PS, Hkv, D)
  const void* vpool;
  const int* bt;          // (B, pages)
  const int* q_pos;       // (B,)
  const int* cache_pos;   // (B,)
  float* part;            // [B * Hkv][splits][2 G + G D]
  int* tickets;           // [B * Hkv], 0 between launches
  int pages, PS, Hkv, G, D, window;
  float scale;
  int eps, splits;        // table entries per split, splits per (slot, head)
  int exclude;            // 1: row r == cache_pos is left out (#3)
};

__host__ __device__ inline size_t carve(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) & ~(size_t)15;
  return at;
}

// Shared memory of a walking block; `base` may be null to size it.
struct Smem {
  void* ring;          // RING x {K, V} x [PS][D + pad] in the pool dtype
  float* q;            // [G][D] the query rows (the caller fills it)
  float* acc;          // [G][D] the result
  float* s;            // [G][PS] scores, then probabilities
  float *m, *l, *alpha;  // [G]
  float* red;          // [THREADS][4] row-group sums, split weights
  int* plist;          // [pages] the split's table entries to load
  int* ppage;          // [pages] their pages
  int* count;
  size_t bytes;

  __host__ __device__ Smem(void* base, int G, int D, int PS, int pages,
                           int tsize) {
    char* p = static_cast<char*>(base);
    size_t o = 0;
    // rows padded by 16 bytes: the mma tiles' row loads miss no bank twice
    ring = p + carve(o, (size_t)RING * 2 * PS * (D + 16 / tsize) * tsize);
    q = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G * D));
    acc = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G * D));
    s = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G * PS));
    m = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G));
    l = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G));
    alpha = reinterpret_cast<float*>(p + carve(o, 4 * (size_t)G));
    red = reinterpret_cast<float*>(p + carve(o, 16 * (size_t)THREADS));
    plist = reinterpret_cast<int*>(p + carve(o, 4 * (size_t)pages));
    ppage = reinterpret_cast<int*>(p + carve(o, 4 * (size_t)pages));
    count = reinterpret_cast<int*>(p + carve(o, 4));
    bytes = o;
  }
};

// Whether virtual row r (0 <= r < rows) is attended: it last held
// absolute position q_pos - floor_mod(cache_pos - r, rows), negative when
// never written; cpm = floor_mod(cache_pos, rows).
__device__ __forceinline__ bool row_valid(int r, int qp, int cp, int cpm,
                                          int rows, int window, bool exclude) {
  int d = cpm - r;
  d += d < 0 ? rows : 0;
  const int abs_pos = qp - d;
  return abs_pos >= 0 && (window == 0 || abs_pos > qp - window) &&
         !(exclude && r == cp);
}

// one 16-byte piece of a K row as f32 values
__device__ __forceinline__ void load16(float (&kv)[4], const float* k) {
  const float4 b = *reinterpret_cast<const float4*>(k);
  kv[0] = b.x, kv[1] = b.y, kv[2] = b.z, kv[3] = b.w;
}
__device__ __forceinline__ void load16(float (&kv)[8],
                                       const __nv_bfloat16* k) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    kv[2 * i] = f.x, kv[2 * i + 1] = f.y;
  }
}

// q (f32, N values, 16-byte aligned) . kv
template <int N>
__device__ __forceinline__ float dot16(const float* q, const float (&kv)[N]) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + i);
    d += a.x * kv[i] + a.y * kv[i + 1] + a.z * kv[i + 2] + a.w * kv[i + 3];
  }
  return d;
}

// four consecutive values of a V row as f32
__device__ __forceinline__ float4 load4(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(v);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The 16-byte copies of one page's K and V rows of head h: each thread's
// pieces, their offsets (in elements) worked out once per split.
template <typename T>
struct PageCopier {
  static constexpr int CH = 16 / sizeof(T);
  static constexpr int MAXP = 8;  // pieces per thread kept in registers
  int soff[MAXP], doff[MAXP];
  int np, D, PS, NC, Hkv;

  __device__ __forceinline__ PageCopier(const Walk& w)
      : D(w.D), PS(w.PS), NC(w.D / CH), Hkv(w.Hkv) {
    np = 0;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      const int j = threadIdx.x + k * THREADS;
      soff[k] = doff[k] = 0;
      if (j < PS * NC) {
        const int row = j / NC, c = j % NC;
        soff[k] = row * Hkv * D + c * CH;
        doff[k] = row * (D + CH) + c * CH;
        np = k + 1;
      }
    }
  }

  // listed page i into ring buffer i % RING: one commit group per call,
  // empty past the list
  __device__ __forceinline__ void issue(const Walk& w, const Smem& sm, int h,
                                        int i, int n) const {
    if (i < n) {
      const size_t page_elems = (size_t)PS * (D + CH);
      T* kd = static_cast<T*>(sm.ring) + (size_t)(i % RING) * 2 * page_elems;
      T* vd = kd + page_elems;
      const size_t src0 = ((size_t)sm.ppage[i] * PS * Hkv + h) * D;
      const T* ks = static_cast<const T*>(w.kpool) + src0;
      const T* vs = static_cast<const T*>(w.vpool) + src0;
      if (PS * NC <= MAXP * THREADS) {
#pragma unroll
        for (int k = 0; k < MAXP; ++k)
          if (k < np) {
            mma1::cp16(kd + doff[k], ks + soff[k], 16);
            mma1::cp16(vd + doff[k], vs + soff[k], 16);
          }
      } else {
        for (int j = threadIdx.x; j < PS * NC; j += THREADS) {
          const int row = j / NC, c = j % NC;
          const size_t src = (size_t)row * Hkv * D + c * CH;
          mma1::cp16(kd + row * (D + CH) + c * CH, ks + src, 16);
          mma1::cp16(vd + row * (D + CH) + c * CH, vs + src, 16);
        }
      }
    }
    mma1::cp_commit();
  }
};

// Starts split `split` of (b, h): lists the split's entries holding a
// valid row (and their pages) and puts the copies of the first RING - 1
// listed pages in flight. The caller then writes the query rows into
// sm.q (the copies overlap that) and calls walk_run.
template <typename T>
__device__ void walk_begin(const Walk& w, const Smem& sm, int b, int h,
                           int split) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int PS = w.PS, rows = w.pages * PS;
  const int qp = w.q_pos[b], cp = w.cache_pos[b];
  const int cpm = floor_mod(cp, rows);
  const bool excl = w.exclude != 0;
  const int e0 = split * w.eps, e1 = min(w.pages, e0 + w.eps);
  if (tid < 32) {
    int n = 0;
    for (int c0 = e0; c0 < e1; c0 += 32) {
      // the table entries of 32 at a time, loaded together
      const int page_l =
          c0 + lane < e1 ? w.bt[(size_t)b * w.pages + c0 + lane] : 0;
      for (int k = 0; k < min(32, e1 - c0); ++k) {
        bool any = false;
        for (int row = lane; row < PS; row += 32)
          any |= row_valid((c0 + k) * PS + row, qp, cp, cpm, rows, w.window,
                           excl);
        const int page = __shfl_sync(0xffffffffu, page_l, k);
        if (__any_sync(0xffffffffu, any)) {
          if (lane == 0) {
            sm.plist[n] = c0 + k;
            sm.ppage[n] = page;
          }
          ++n;
        }
      }
    }
    if (lane == 0) *sm.count = n;
  }
  for (int g = tid; g < w.G; g += THREADS) {
    sm.m[g] = -INFINITY;
    sm.l[g] = 0.f;
  }
  __syncthreads();
  const int n = *sm.count;
  const PageCopier<T> copier(w);
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) copier.issue(w, sm, h, i, n);
}

// The online-softmax update of one page's scores in sm.s ([G][PS], -inf
// where masked), a warp per query head: sm.s becomes the probabilities,
// sm.alpha the rescale of the earlier sums, sm.m and sm.l move on.
__device__ __forceinline__ void softmax_page(const Smem& sm, int G, int PS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sm.s + g * PS;
    float mx = -INFINITY;
    for (int row = lane; row < PS; row += 32) mx = fmaxf(mx, sg[row]);
    mx = warp_max(mx);
    const float m_prev = sm.m[g];
    const float m_new = fmaxf(m_prev, mx);  // finite: the page has a valid row
    float psum = 0.f;
    for (int row = lane; row < PS; row += 32) {
      const float pe = expf(sg[row] - m_new);  // -inf -> 0
      sg[row] = pe;
      psum += pe;
    }
    psum = warp_sum(psum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      sm.alpha[g] = a;
      sm.l[g] = sm.l[g] * a + psum;
      sm.m[g] = m_new;
    }
  }
}

// Everything a page loop needs about its split.
struct Split {
  int n;            // listed pages
  int qp, cp, cpm, rows;
  bool excl;
};

// The page loop on the CUDA cores (any dtype and shape), f32 throughout;
// leaves the split's acc in sm.acc.
template <typename T>
__device__ void loop_cores(const Walk& w, const Smem& sm, int h,
                           const Split& sp, const PageCopier<T>& copier) {
  constexpr int CH = 16 / sizeof(T);          // elements per 16-byte piece
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = w.G, D = w.D, PS = w.PS, DS = D + CH;
  const int NC = D / CH;                       // 16-byte pieces per row
  const size_t page_elems = (size_t)PS * DS;
  const T* ring = static_cast<const T*>(sm.ring);

  // score mapping: LPR lanes (a power of two, at most 4) per row, RPW
  // rows per warp; each lane takes NC / LPR pieces of the row
  int LPR = 1;
  while (LPR * 2 <= min(4, NC)) LPR *= 2;
  const int RPW = 32 / LPR;
  // PV mapping: NI items of 4 d; RG row groups when NI < THREADS
  const int NI = G * D / 4;
  const int RG = NI >= THREADS ? 1 : THREADS / NI;
  const int item0 = RG == 1 ? tid : tid % NI;
  const int rg = RG == 1 ? 0 : tid / NI;
  const bool pv_active = RG == 1 || tid < RG * NI;
  float acc[MAX_ITEMS][4];
#pragma unroll
  for (int k = 0; k < MAX_ITEMS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int i = 0; i < sp.n; ++i) {
    copier.issue(w, sm, h, i + RING - 1, sp.n);  // into the buffer i - 1 freed
    mma1::cp_wait<RING - 1>();  // page i has landed
    __syncthreads();
    const T* kt = ring + (size_t)(i % RING) * 2 * page_elems;
    const T* vt = kt + page_elems;
    const int r0 = sm.plist[i] * PS;

    // scores of every (query head, row): GB heads at a time, each K piece
    // read once for all of them, their reductions interleaved
    for (int row0 = warp * RPW; row0 < PS; row0 += WARPS * RPW) {
      const int row = row0 + lane / LPR;
      const bool in = row < PS;
      const bool valid = in && row_valid(r0 + row, sp.qp, sp.cp, sp.cpm,
                                         sp.rows, w.window, sp.excl);
      for (int g0 = 0; g0 < G; g0 += GB) {
        float dot[GB];
#pragma unroll
        for (int j = 0; j < GB; ++j) dot[j] = 0.f;
        if (in)
          for (int c = lane % LPR; c < NC; c += LPR) {
            float kv[CH];
            load16(kv, kt + row * DS + c * CH);
#pragma unroll
            for (int j = 0; j < GB; ++j)
              if (g0 + j < G) dot[j] += dot16(sm.q + (g0 + j) * D + c * CH, kv);
          }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < GB; ++j)
            dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
        if (in && lane % LPR == 0)
#pragma unroll
          for (int j = 0; j < GB; ++j)
            if (g0 + j < G)
              sm.s[(g0 + j) * PS + row] = valid ? dot[j] * w.scale : -INFINITY;
      }
    }
    __syncthreads();
    softmax_page(sm, G, PS);
    __syncthreads();

    // PV: 4 d of one head over this thread's row group
    if (pv_active) {
#pragma unroll
      for (int k = 0; k < MAX_ITEMS; ++k) {
        const int it = item0 + k * THREADS;
        if (it >= NI || (k > 0 && RG > 1)) break;
        const int g = it / (D / 4), d = (it % (D / 4)) * 4;
        const float a = sm.alpha[g];
        float4 v4 = make_float4(acc[k][0] * a, acc[k][1] * a, acc[k][2] * a,
                                acc[k][3] * a);
        const float* pg = sm.s + g * PS;
        for (int row = rg; row < PS; row += RG) {
          const float p = pg[row];
          const float4 v = load4(vt + row * DS + d);
          v4.x += p * v.x;
          v4.y += p * v.y;
          v4.z += p * v.z;
          v4.w += p * v.w;
        }
        acc[k][0] = v4.x, acc[k][1] = v4.y, acc[k][2] = v4.z, acc[k][3] = v4.w;
      }
    }
    __syncthreads();          // page buffer and scores are free again
  }
  mma1::cp_wait<0>();

  // ---- the row groups' sums, in group order ----
  if (RG > 1) {
    if (pv_active)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.red[tid * 4 + j] = acc[0][j];
    __syncthreads();
    for (int it = tid; it < NI; it += THREADS)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.f;
        for (int r = 0; r < RG; ++r) v += sm.red[(r * NI + it) * 4 + j];
        sm.acc[it * 4 + j] = v;
      }
  } else {
#pragma unroll
    for (int k = 0; k < MAX_ITEMS; ++k) {
      const int it = item0 + k * THREADS;
      if (it < NI)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.acc[it * 4 + j] = acc[k][j];
    }
  }
}

// Whether the bf16 walk can take the tensor cores: whole k16 steps of keys
// and of D, at most 16 query heads (the rows of one mma tile), and D at
// most TC_MAX_D (the query fragments held in registers).
constexpr int TC_MAX_D = 128;
__host__ __device__ inline bool tensor_walk(int G, int D, int PS) {
  return G <= 16 && D % 16 == 0 && D <= TC_MAX_D && PS % 16 == 0;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// The bf16 page loop on the tensor cores (mma.sync m16n8k16, f32 sums):
// the G query rows are the rows of the A tile of QK^T (exact: q is bf16),
// a warp takes 8 keys per n8 tile with its K rows as B; after the softmax
// the probabilities, rounded to bf16 as the plain version rounds them, are
// the A tile of PV and the V rows the B tile (ldmatrix.trans), each warp
// holding its 8-column slices of the (G x D) sum in registers across
// pages. Leaves the split's acc in sm.acc.
__device__ inline void loop_tensor(const Walk& w, const Smem& sm, int h,
                            const Split& sp,
                            const PageCopier<__nv_bfloat16>& copier) {
  constexpr int CH = 8, KS_MAX = TC_MAX_D / 16, NTW_MAX = TC_MAX_D / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int G = w.G, D = w.D, PS = w.PS, DS = D + CH;
  const size_t page_elems = (size_t)PS * DS;
  const __nv_bfloat16* ring = static_cast<const __nv_bfloat16*>(sm.ring);
  const int KS = D / 16;

  // A fragments of the query rows, one per k16 step of D
  uint32_t qa[KS_MAX][4];
#pragma unroll
  for (int k = 0; k < KS_MAX; ++k) {
    const int d = 16 * k + 2 * t4;
    const float* q0 = sm.q + gid * D + d;
    const float* q1 = sm.q + (gid + 8) * D + d;
    const bool r0 = k < KS && gid < G, r1 = k < KS && gid + 8 < G;
    qa[k][0] = r0 ? bf16x2(q0[0], q0[1]) : 0u;
    qa[k][1] = r1 ? bf16x2(q1[0], q1[1]) : 0u;
    qa[k][2] = r0 ? bf16x2(q0[8], q0[9]) : 0u;
    qa[k][3] = r1 ? bf16x2(q1[8], q1[9]) : 0u;
  }
  float oacc[NTW_MAX][4];
#pragma unroll
  for (int t = 0; t < NTW_MAX; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[t][j] = 0.f;

  for (int i = 0; i < sp.n; ++i) {
    copier.issue(w, sm, h, i + RING - 1, sp.n);
    mma1::cp_wait<RING - 1>();
    __syncthreads();
    const __nv_bfloat16* kt = ring + (size_t)(i % RING) * 2 * page_elems;
    const __nv_bfloat16* vt = kt + page_elems;
    const int r0 = sm.plist[i] * PS;

    // QK^T: warp w scores keys 8 * (w + 8 j) .. + 7
    for (int nt = warp; nt < PS / 8; nt += WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* krow = kt + (nt * 8 + gid) * DS + 2 * t4;
#pragma unroll
      for (int k = 0; k < KS_MAX; ++k) {
        if (k >= KS) break;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + 16 * k);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + 16 * k + 8);
        mma1::mma_bf16(c, qa[k], b0, b1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = nt * 8 + 2 * t4 + j;
        const bool ok = row_valid(r0 + key, sp.qp, sp.cp, sp.cpm, sp.rows,
                                  w.window, sp.excl);
        if (gid < G) sm.s[gid * PS + key] = ok ? c[j] * w.scale : -INFINITY;
        if (gid + 8 < G)
          sm.s[(gid + 8) * PS + key] = ok ? c[2 + j] * w.scale : -INFINITY;
      }
    }
    __syncthreads();
    softmax_page(sm, G, PS);
    __syncthreads();

    // PV: warp w sums d-columns 8 * (w + 8 t) .. + 7 over the page's keys
    const float a0 = gid < G ? sm.alpha[gid] : 0.f;
    const float a1 = gid + 8 < G ? sm.alpha[gid + 8] : 0.f;
#pragma unroll
    for (int t = 0; t < NTW_MAX; ++t) {
      const int n0 = 8 * (warp + WARPS * t);
      if (n0 >= D) break;
      float (&o)[4] = oacc[t];
      o[0] *= a0, o[1] *= a0, o[2] *= a1, o[3] *= a1;
      for (int k0 = 0; k0 < PS; k0 += 16) {
        const float* p0 = sm.s + gid * PS + k0 + 2 * t4;
        const float* p1 = sm.s + (gid + 8) * PS + k0 + 2 * t4;
        const bool r0_ = gid < G, r1_ = gid + 8 < G;
        const uint32_t pa[4] = {r0_ ? bf16x2(p0[0], p0[1]) : 0u,
                                r1_ ? bf16x2(p1[0], p1[1]) : 0u,
                                r0_ ? bf16x2(p0[8], p0[9]) : 0u,
                                r1_ ? bf16x2(p1[8], p1[9]) : 0u};
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vt + (k0 + (lane & 15)) * DS + n0);
        mma1::mma_bf16(o, pa, b0, b1);
      }
    }
    __syncthreads();          // page buffer and scores are free again
  }
  mma1::cp_wait<0>();
#pragma unroll
  for (int t = 0; t < NTW_MAX; ++t) {
    const int n0 = 8 * (warp + WARPS * t);
    if (n0 >= D) break;
    const int d = n0 + 2 * t4;
    if (gid < G) {
      sm.acc[gid * D + d] = oacc[t][0];
      sm.acc[gid * D + d + 1] = oacc[t][1];
    }
    if (gid + 8 < G) {
      sm.acc[(gid + 8) * D + d] = oacc[t][2];
      sm.acc[(gid + 8) * D + d + 1] = oacc[t][3];
    }
  }
}

// Walks the split begun by walk_begin with the query rows in sm.q, on the
// tensor cores when TC (a bf16 pool at a shape tensor_walk() takes; the
// kernels instantiate both loops apart, so neither holds the other's
// registers). Leaves the split's (m, l, acc) in sm.m, sm.l, sm.acc.
template <typename T, bool TC>
__device__ void walk_run(const Walk& w, const Smem& sm, int b, int h) {
  Split sp;
  sp.rows = w.pages * w.PS;
  sp.qp = w.q_pos[b];
  sp.cp = w.cache_pos[b];
  sp.cpm = floor_mod(sp.cp, sp.rows);
  sp.excl = w.exclude != 0;
  const PageCopier<T> copier(w);
  __syncthreads();                             // sm.q is complete
  sp.n = *sm.count;
  if constexpr (TC)  // bf16 at a shape tensor_walk() takes
    loop_tensor(w, sm, h, sp, copier);
  else
    loop_cores<T>(w, sm, h, sp, copier);
  __syncthreads();
}

// After walk_run: merges the splits of (b, h) through the workspace. Each
// split writes its (m, l, acc) to its slot of w.part, and the last of the
// (slot, head)'s splits to arrive (an int ticket per (slot, head), which
// that block resets to 0) merges them in split order. Returns true in
// the block that then holds the merged (m, l, acc) in sm.m, sm.l, sm.acc
// (always with one split); every thread of the block gets the same answer.
__device__ inline bool merge_splits(const Walk& w, const Smem& sm, int b,
                                    int h, int split) {
  const int tid = threadIdx.x;
  const int G = w.G, D = w.D;
  if (w.splits == 1) return true;
  // ---- partials out; the last split of (b, h) merges in split order ----
  const int PSZ = 2 * G + G * D;
  const int bh = b * w.Hkv + h;
  float* base = w.part + (size_t)bh * w.splits * PSZ;
  float* mine = base + (size_t)split * PSZ;
  for (int g = tid; g < G; g += THREADS) {
    mine[g] = sm.m[g];
    mine[G + g] = sm.l[g];
  }
  for (int i = tid; i < G * D; i += THREADS) mine[2 * G + i] = sm.acc[i];
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // cumulative: the whole block's partials come first
    const int t = atomicAdd(w.tickets + bh, 1);
    *sm.count = t == w.splits - 1;
    if (t == w.splits - 1) w.tickets[bh] = 0;  // every split has arrived
  }
  __syncthreads();
  const bool last = *sm.count != 0;
  __syncthreads();  // every thread has read the flag before it is reused
  if (!last) return false;
  __threadfence();
  for (int g = tid; g < G; g += THREADS) {
    float mt = -INFINITY;
    for (int s = 0; s < w.splits; ++s)
      mt = fmaxf(mt, __ldcg(base + (size_t)s * PSZ + g));
    float lt = 0.f;
    for (int s = 0; s < w.splits; ++s) {
      const float ms = __ldcg(base + (size_t)s * PSZ + g);
      const float wt = ms == -INFINITY ? 0.f : expf(ms - mt);
      sm.red[s * G + g] = wt;
      lt += __ldcg(base + (size_t)s * PSZ + G + g) * wt;
    }
    sm.m[g] = mt;
    sm.l[g] = lt;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float v = 0.f;
    for (int s = 0; s < w.splits; ++s)
      v += sm.red[s * G + g] * __ldcg(base + (size_t)s * PSZ + 2 * G + i);
    sm.acc[i] = v;
  }
  __syncthreads();
  return true;
}

}  // namespace walk
}  // namespace nq
