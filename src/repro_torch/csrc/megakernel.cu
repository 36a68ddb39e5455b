// Decode-step megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/megakernel.py::
// decode_step_megakernel_raw (body _kernel, _stage1, _stage2, _rope_rows):
// the whole attention half of one decode step in a single launch —
//   1. merged-QKV packed low-rank matmul (3 groups, rmask, eff_rank),
//   2. rotate-half RoPE of q and the fresh k at q_pos,
//   3. the block-table page walk with an f32 online softmax that EXCLUDES
//      the virtual row == cache_pos mod rows (this token's row, stale at
//      read time; a ring's cache_pos may be given unwrapped),
//   4. the fold of the fresh k/v entry,
//   5. normalisation,
//   6. the packed wo projection (eff_rank_o).
// Roundings follow the unfused chain: projections round to x's dtype,
// the fresh k/v to the pool dtype before scoring, o to x's dtype before
// wo. The caller writes k_new / v_new into the pool.
//
// What bounds it on the H100: bytes — the packed QKV and wo factors
// (about 1 MB per layer of llama3.2-1b at 1 bpw) plus the slots' mapped
// K/V pages. So every packed word is read once per launch, whatever the
// batch: the B <= 8 slots are the rows of one tile of the +-1 tensor-core
// routine of binary_mma.cuh (mma.sync m16n8k16, the packed factor expanded
// in registers, the f32 operands x * s2, t * rmask, o * s2o and t_o split
// into 3 bf16 terms for an f32 result and 2 for a bf16 one, as kernel #1
// does). The page walk is the split walk of paged_walk.cuh, shared with
// kernel #2 (QK^T and PV on the tensor cores for bf16).
//
// Design: one cooperative launch of co-resident blocks (the wrapper sizes
// the grid from the occupancy query and kernels/megakernel.py::_plan_mega,
// never larger, so no wait can deadlock; a refused launch raises). Five
// phases of work items; a block takes its items of each phase in turn,
// and an item waits only for the flags of the earlier items it reads (no
// grid barrier: a walk item starts as soon as its head's q, k and v
// exist, while other blocks still project):
//   1. QKV stage 1 items (group, 128 rank columns, K slice): raw x and s2
//      staged by cp.async and split into terms in shared memory; each item
//      writes f32 partials, and the last slice of a (group, rank tile) to
//      arrive (an int ticket) sums the slices in slice order, times rmask,
//      split into terms. Rank tiles whose rmask is all zero (the padding
//      of a merged group's narrower k/v ranks) are not multiplied.
//   2. QKV stage 2 items (group, 128 output columns), each group over its
//      own width (nq, nkv, nkv) and its live rank words only: times s1,
//      rounded to x's dtype.
//   3. walk items (slot, kv head, split): RoPE at q_pos (one sincos per
//      frequency), q and the fresh k rounded; the split walk without row
//      cache_pos mod rows; the last split of a (slot, head) merges (paged_walk.cuh),
//      folds the fresh entry, normalises and rounds o to x's dtype.
//   4. wo stage 1 items (128 rank columns, K slice) on o * s2o; the last
//      slice sums in order and splits t_o into terms.
//   5. wo stage 2 items (128 output columns): times s1o into y.
// Intermediates go through a workspace in device memory that the wrapper
// allocates (L2-sized: 1.6 MB at llama3.2-1b B = 8 in f32).
#include "binary_mma.cuh"
#include "paged_walk.cuh"

using namespace nq::mma1;

namespace {

constexpr int THREADS = threads_for(1);  // 256, the walk's block size too
static_assert(THREADS == nq::walk::THREADS, "one block size for all phases");
constexpr int KCW = chunk_words(1);      // words per staged chunk
constexpr int KC = KCW * 32;             // activation columns per chunk

struct Args {
  const void* x;
  const uint32_t *qv3, *qu3;
  const float *s2_3, *s1_3, *rmask3;
  const uint32_t *qvo, *quo;
  const float *s2o, *s1o;
  void *y, *k_new, *v_new;
  float* ws;
  int* tickets;  // [3 r_tiles] QKV, [B Hkv] walk, [ro_tiles] wo
  unsigned* flags;  // [3 r_tiles] QKV rank tiles summed, [nt0 + 2 nt1]
                    // QKV output tiles, [Hkv][8] (head, slot) merged,
                    // [ro_tiles] wo rank tiles summed
  unsigned epoch;   // this launch's number, never 0
  nq::walk::Walk w;
  int B, K, R, r_eff, Nmax, nq, nkv, Ko, Ro, ro_eff, No, D;
  float theta;
  int s1_slices, s1_kw, o_slices, o_kw;
  bool vec_v, vec_u, vec_vo, vec_uo;
};

// The workspace, in floats, each piece rounded up to 16 bytes (the wrapper
// mirrors this in _plan_mega).
struct Work {
  float* part1;     // [3][s1_slices][B][r_eff]
  uint32_t* t1;     // [3][TERMS][B][r_eff/32][16]
  float* proj;      // [B][nq + 2 nkv] q, k, v rounded to x's dtype
  float* ob;        // [B][Ko] o rounded to x's dtype, zero past nq
  float* part_o;    // [o_slices][B][ro_eff]
  uint32_t* to;     // [TERMS][B][ro_eff/32][16]
  float* wpart;     // the walk's split partials
  size_t floats;

  __host__ __device__ static float* take(float* base, size_t& o, size_t n) {
    float* p = base + o;
    o += (n + 3) & ~(size_t)3;
    return p;
  }
  __host__ __device__ Work(float* base, const Args& a, int terms) {
    const int G = a.w.G;
    size_t o = 0;
    part1 = take(base, o, (size_t)3 * a.s1_slices * a.B * a.r_eff);
    t1 = reinterpret_cast<uint32_t*>(
        take(base, o, (size_t)3 * terms * a.B * a.r_eff / 2));
    proj = take(base, o, (size_t)a.B * (a.nq + 2 * a.nkv));
    ob = take(base, o, (size_t)a.B * a.Ko);
    part_o = take(base, o, (size_t)a.o_slices * a.B * a.ro_eff);
    to = reinterpret_cast<uint32_t*>(
        take(base, o, (size_t)terms * a.B * a.ro_eff / 2));
    wpart = take(base, o, (size_t)a.B * a.w.Hkv * a.w.splits * (2 * G + G * a.D));
    floats = o;
  }
};

// Raw activations (B rows, in TI) and a per-column f32 scale staged by
// cp.async; the operand x * s is split into the term planes once they land
// (as kernel #4 stages its x, but the product is f32, as the fused oracle
// takes it).
template <typename TI, int TERMS>
struct ScaledAct {
  uint32_t* ts;     // TERMS planes of `rows` rows, one set
  TI* raw;          // STAGES x [rows][KC]
  float* sb;        // STAGES x [KC]
  const TI* x;      // row 0, first column of the item's K range
  const float* s;   // first column of the item's K range
  int K, rows;

  __device__ __forceinline__ void issue(int buf, int w0, int nw) {
    constexpr int PER = 16 / sizeof(TI);
    const int q_row = nw * 32 / PER;
    TI* dst = raw + buf * rows * KC;
    for (int i = threadIdx.x; i < rows * q_row; i += blockDim.x) {
      const int r = i / q_row, q = i % q_row;
      cp16(dst + r * KC + q * PER, x + (size_t)r * K + w0 * 32 + q * PER, 16);
    }
    for (int i = threadIdx.x; i < nw * 8; i += blockDim.x)
      cp16(sb + buf * KC + i * 4, s + w0 * 32 + i * 4, 16);
  }

  __device__ __forceinline__ TermView terms(int buf, int nw) {
    constexpr int RS = term_stride(1);
    const int plane = rows * RS;
    const TI* rb = raw + buf * rows * KC;
    const float* sbb = sb + buf * KC;
    for (int i = threadIdx.x; i < rows * nw * 16; i += blockDim.x) {
      const int r = i / (nw * 16), wp = i % (nw * 16);
      const int k = (wp / 16) * 32 + wp % 16;
      uint32_t out[TERMS];
      split_pair<TERMS>(nq::to_f32(rb[r * KC + k]) * sbb[k],
                        nq::to_f32(rb[r * KC + k + 16]) * sbb[k + 16], out);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) ts[j * plane + r * RS + wp] = out[j];
    }
    __syncthreads();
    return {ts, rows, plane};
  }
};

// Shared memory of the product phases (bytes): the word ring plus either
// the staged-raw operand (phases 1, 4, sized for f32 raw) or the ring of
// staged terms (phases 2, 5), or the epilogue's reduction.
template <int TERMS, int AT>
size_t product_smem(int B) {
  const size_t words = 4 * (size_t)STAGES * KCW * BN;
  const size_t scaled = 4 * (size_t)term_words<1, TERMS>(B) +
                        4 * (size_t)STAGES * B * KC + 4 * (size_t)STAGES * KC;
  const size_t staged = 4 * (size_t)STAGES * term_words<1, TERMS>(B);
  const size_t loop = words + (scaled > staged ? scaled : staged);
  const size_t red = 4 * (size_t)red_floats<1, AT>();
  return loop > red ? loop : red;
}

// The walk phase's extra shared memory after the walk's own (floats): the
// RoPE table, the fresh k and v, and the fresh entry's probabilities.
__host__ __device__ inline size_t walk_extra_floats(int G, int D) {
  return (size_t)D + 2 * (size_t)D + (size_t)G;
}

template <typename T, int AT>
size_t smem_bytes(int B, int G, int D, int PS, int pages) {
  constexpr int TERMS = terms_for<T>();
  const size_t walk = nq::walk::Smem(nullptr, G, D, PS, pages, sizeof(T)).bytes +
                      4 * walk_extra_floats(G, D);
  const size_t prod = product_smem<TERMS, AT>(B);
  return walk > prod ? walk : prod;
}

// Every thread of the block calls it after writing its share of a work
// item; true in the block whose arrival is the n-th on `ticket` (which it
// resets to 0), with every earlier arrival's writes visible. (The fence
// of thread 0 after the block barrier is cumulative: it orders the whole
// block's writes before the increment.)
__device__ bool last_arrival(int* ticket, int n, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int t = atomicAdd(ticket, 1);
    *flag = t == n - 1;
    if (t == n - 1) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag != 0;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The phases meet through flags instead of grid barriers: a work item
// publishes its results by setting its flag to this launch's number (the
// epoch, never 0, a new one for every launch), and a consumer waits until
// the flags of the items it reads from hold the epoch. Every block takes
// its items in phase order and waits only on earlier phases, whose items
// all run on co-resident blocks (the cooperative launch guarantees it), so
// every wait ends; flags left by earlier launches hold older epochs, so
// they need no reset.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The block waits until flags f[0, n) all hold `ep`, a thread per flag. A
// wait far past any real launch (seconds) traps, so a fault becomes an
// error and not a hung card.
__device__ void wait_flags(const unsigned* f, int n, unsigned ep) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    long long spins = 0;
    while (ld_acquire(f + i) != ep) {
      __nanosleep(64);
      if (++spins > (1LL << 25)) __trap();
    }
  }
  __syncthreads();
}

// After every thread of the block wrote its share of an item: its flag.
__device__ void publish(unsigned* f, unsigned ep) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the whole block's writes come first
    atomicExch(f, ep);
  }
}

// The slices of one 128-column rank tile summed in slice order, times
// `mask` (null: ones), split into terms in pair order.
template <int TERMS>
__device__ void sum_slices(const float* part, int slices, int B, int width,
                           int r0, int ncols, const float* mask, bool live,
                           uint32_t* terms) {
  const int RW = width / 32, cw = ncols / 32;
  for (int e = threadIdx.x; e < B * cw * 16; e += blockDim.x) {
    const int p = e % 16, wl = (e / 16) % cw, m = e / (16 * cw);
    const int k = r0 + wl * 32 + p;
    float v0 = 0.f, v1 = 0.f;
    if (live)
      for (int s = 0; s < slices; ++s) {
        const float* pr = part + ((size_t)s * B + m) * width + k;
        v0 += __ldcg(pr);
        v1 += __ldcg(pr + 16);
      }
    if (mask != nullptr) {
      v0 = mask[k] != 0.f ? v0 * mask[k] : 0.f;
      v1 = mask[k + 16] != 0.f ? v1 * mask[k + 16] : 0.f;
    }
    uint32_t tv[TERMS];
    split_pair<TERMS>(v0, v1, tv);
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
      terms[(((size_t)j * B + m) * RW + k / 32) * 16 + p] = tv[j];
  }
}

template <typename T, int AT, bool TC>
__global__ void __launch_bounds__(THREADS) megakernel(Args a) {
  constexpr int TERMS = terms_for<T>();
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int flag;
  const int B = a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Work wk(a.ws, a, TERMS);
  uint32_t* wring = smem;                       // STAGES x [KCW][BN]
  uint32_t* ts = wring + STAGES * KCW * BN;     // term planes
  float* red = reinterpret_cast<float*>(smem);  // the epilogue's
  const int KW = a.K / 32, RW = a.r_eff / 32;
  const int r_tiles = (a.r_eff + BN - 1) / BN;
  const int PW = a.nq + 2 * a.nkv;
  const int nt0 = (a.nq + BN - 1) / BN, nt1 = (a.nkv + BN - 1) / BN;
  unsigned* done_r = a.flags;                 // QKV rank tiles summed
  unsigned* done_t = done_r + 3 * r_tiles;    // QKV output tiles
  unsigned* done_h = done_t + nt0 + 2 * nt1;  // (head, slot) merged
  unsigned* done_o = done_h + a.w.Hkv * 8;    // wo rank tiles summed
  const unsigned ep = a.epoch;

  // ---- 1: QKV stage 1, (group, rank tile, K slice), slices summed ----
  const int S1 = a.s1_slices;
  for (int item = blockIdx.x; item < 3 * r_tiles * S1; item += gridDim.x) {
    const int sl = item % S1, rt = (item / S1) % r_tiles, g = item / (S1 * r_tiles);
    const int r0 = rt * BN, ncols = min(BN, a.r_eff - r0);
    const float* rm = a.rmask3 + (size_t)g * a.R;
    if (warp == 0) {
      bool any = false;
      for (int c = lane; c < ncols / 4; c += 32) {
        const float4 v = reinterpret_cast<const float4*>(rm + r0)[c];
        any |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) flag = any;
    }
    __syncthreads();
    const bool live = flag != 0;
    __syncthreads();
    if (live) {
      const int w0 = sl * a.s1_kw, nw = max(0, min(a.s1_kw, KW - w0));
      ScaledAct<T, TERMS> act{
          ts, reinterpret_cast<T*>(ts + term_words<1, TERMS>(B)),
          reinterpret_cast<float*>(reinterpret_cast<char*>(
              ts + term_words<1, TERMS>(B)) + (size_t)STAGES * B * KC * 4),
          static_cast<const T*>(a.x) + (size_t)w0 * 32,
          a.s2_3 + (size_t)g * a.K + (size_t)w0 * 32, a.K, B};
      float sum[AT][FRAGS][4];
      tile_product<1, TERMS, AT>(a.qv3 + ((size_t)g * KW + w0) * a.R + r0, a.R,
                                 ncols, a.vec_v, nw, act, wring, sum);
      float* dst = wk.part1 + ((size_t)g * S1 + sl) * B * a.r_eff;
      finish_tile<1, TERMS, AT>(sum, red, B, [&](int m, int r, float v) {
        if (r < ncols) dst[(size_t)m * a.r_eff + r0 + r] = v;
      });
    }
    if (last_arrival(a.tickets + g * r_tiles + rt, S1, &flag)) {
      sum_slices<TERMS>(wk.part1 + (size_t)g * S1 * B * a.r_eff, S1, B,
                        a.r_eff, r0, ncols, rm, live,
                        wk.t1 + (size_t)g * TERMS * B * RW * 16);
      publish(done_r + g * r_tiles + rt, ep);
    }
  }

  // ---- 2: QKV stage 2, (group, output tile) over the group's width ----
  for (int item = blockIdx.x; item < nt0 + 2 * nt1; item += gridDim.x) {
    const int g = item < nt0 ? 0 : 1 + (item - nt0) / nt1;
    const int n0 = (item < nt0 ? item : (item - nt0) % nt1) * BN;
    const int N = g == 0 ? a.nq : a.nkv;
    // the live rank words: through the last nonzero rmask
    if (tid == 0) flag = -1;
    __syncthreads();
    const float4* rm4 = reinterpret_cast<const float4*>(a.rmask3 + (size_t)g * a.R);
    int lastnz = -1;
    for (int r4 = tid; r4 < a.r_eff / 4; r4 += THREADS) {
      const float4 v = rm4[r4];
      if (v.x != 0.f) lastnz = 4 * r4;
      if (v.y != 0.f) lastnz = 4 * r4 + 1;
      if (v.z != 0.f) lastnz = 4 * r4 + 2;
      if (v.w != 0.f) lastnz = 4 * r4 + 3;
    }
    lastnz = __reduce_max_sync(0xffffffffu, lastnz);
    if (lane == 0 && lastnz >= 0) atomicMax(&flag, lastnz);
    wait_flags(done_r + g * r_tiles, r_tiles, ep);  // synchronises the block
    const int rw_live = (flag + 32) / 32;
    __syncthreads();
    StagedTerms<1, TERMS> act{ts, wk.t1 + (size_t)g * TERMS * B * RW * 16, B,
                              RW, 0, 0, B};
    float sum[AT][FRAGS][4];
    tile_product<1, TERMS, AT>(a.qu3 + (size_t)g * (a.R / 32) * a.Nmax + n0,
                               a.Nmax, N - n0, a.vec_u, rw_live, act, wring,
                               sum);
    const float* s1 = a.s1_3 + (size_t)g * a.Nmax + n0;
    float* dst = wk.proj + (g == 0 ? 0 : a.nq + (g - 1) * a.nkv) + n0;
    finish_tile<1, TERMS, AT>(sum, red, B, [&](int m, int n, float v) {
      if (n0 + n < N) dst[(size_t)m * PW + n] = nq::round_to<T>(v * s1[n]);
    });
    publish(done_t + item, ep);
  }

  // ---- 3: walk items (slot, kv head, split) ----
  {
    const nq::walk::Walk& w = a.w;
    const int G = w.G, D = a.D, half = D / 2, GD = G * D;
    const nq::walk::Smem sm(smem, G, D, w.PS, w.pages, sizeof(T));
    float* cs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + sm.bytes);
    float* sn = cs + half;
    float* kf = sn + half;
    float* vf = kf + D;
    float* pnew = vf + D;
    T* k_new = static_cast<T*>(a.k_new);
    T* v_new = static_cast<T*>(a.v_new);
    const int items = B * w.Hkv * w.splits;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int split = item % w.splits, bh = item / w.splits;
      const int b = bh / w.Hkv, h = bh % w.Hkv;
      const float* pr = wk.proj + (size_t)b * PW;
      nq::walk::walk_begin<T>(w, sm, b, h, split);  // first pages in flight
      // head h's q columns, and its k and v columns
      {
        const int q0 = h * GD / BN, q1 = ((h + 1) * GD - 1) / BN;
        const int k0 = h * D / BN, k1 = ((h + 1) * D - 1) / BN;
        wait_flags(done_t + q0, q1 - q0 + 1, ep);
        wait_flags(done_t + nt0 + k0, k1 - k0 + 1, ep);
        wait_flags(done_t + nt0 + nt1 + k0, k1 - k0 + 1, ep);
      }
      const float qp = (float)w.q_pos[b];
      for (int j = tid; j < half; j += THREADS) {
        const float inv = 1.0f / powf(a.theta, (2.0f * (float)j) / (float)D);
        sincosf(qp * inv, &sn[j], &cs[j]);
      }
      __syncthreads();
      for (int i = tid; i < (G + 1) * half; i += THREADS) {
        const int row = i / half, j = i % half;
        const float* src = row < G ? pr + (h * G + row) * D : pr + a.nq + h * D;
        float* dst = row < G ? sm.q + row * D : kf;
        const float x1 = __ldcg(src + j), x2 = __ldcg(src + j + half);
        dst[j] = nq::round_to<T>(x1 * cs[j] - x2 * sn[j]);
        dst[j + half] = nq::round_to<T>(x2 * cs[j] + x1 * sn[j]);
      }
      for (int d = tid; d < D; d += THREADS)
        vf[d] = __ldcg(pr + a.nq + a.nkv + h * D + d);
      nq::walk::walk_run<T, TC>(w, sm, b, h);
      const bool last = nq::walk::merge_splits(w, sm, b, h, split);
      if (split == 0)  // kf, vf are complete: walk_run synchronised
        for (int d = tid; d < D; d += THREADS) {
          k_new[(size_t)bh * D + d] = nq::from_f32<T>(kf[d]);
          v_new[(size_t)bh * D + d] = nq::from_f32<T>(vf[d]);
        }
      if (!last) continue;
      // the fresh entry, at abs_pos == q_pos (inside any window)
      for (int g = warp; g < G; g += THREADS / 32) {
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot += sm.q[g * D + d] * kf[d];
        dot = nq::warp_sum(dot);
        if (lane == 0) {
          const float s_new = dot * w.scale;
          const float m_prev = sm.m[g];
          const float m_new = fmaxf(m_prev, s_new);
          const float al = expf(m_prev - m_new);
          const float pn = expf(s_new - m_new);
          sm.alpha[g] = al;
          pnew[g] = pn;
          sm.l[g] = sm.l[g] * al + pn;
        }
      }
      __syncthreads();
      float* ob = wk.ob + (size_t)b * a.Ko + (size_t)h * GD;
      for (int i = tid; i < GD; i += THREADS) {
        const int g = i / D;
        const float v = sm.acc[i] * sm.alpha[g] + pnew[g] * vf[i % D];
        ob[i] = nq::round_to<T>(v / fmaxf(sm.l[g], 1e-30f));
      }
      if (h == w.Hkv - 1)  // wo's K columns past nq are zero
        for (int k = a.nq + tid; k < a.Ko; k += THREADS)
          wk.ob[(size_t)b * a.Ko + k] = 0.f;
      publish(done_h + h * 8 + b, ep);
      __syncthreads();
    }
  }

  // ---- 4: wo stage 1 on o * s2o, (rank tile, K slice), slices summed ----
  const int KWo = a.Ko / 32, RWo = a.ro_eff / 32;
  const int ro_tiles = (a.ro_eff + BN - 1) / BN;
  const int So = a.o_slices;
  int* tick_o = a.tickets + 3 * r_tiles + B * a.w.Hkv;
  for (int item = blockIdx.x; item < ro_tiles * So; item += gridDim.x) {
    const int sl = item % So, rt = item / So;
    const int r0 = rt * BN, ncols = min(BN, a.ro_eff - r0);
    const int w0 = sl * a.o_kw, nw = max(0, min(a.o_kw, KWo - w0));
    {  // the heads whose o columns this K slice reads, every slot merged
      const int GD = a.w.G * a.D, last = a.w.Hkv - 1;
      const int h1 = nw > 0 ? min(last, (32 * (w0 + nw) - 1) / GD) : -1;
      for (int hh = min(last, 32 * w0 / GD); hh <= h1; ++hh)
        wait_flags(done_h + hh * 8, B, ep);
    }
    ScaledAct<float, TERMS> act{
        ts, reinterpret_cast<float*>(ts + term_words<1, TERMS>(B)),
        reinterpret_cast<float*>(ts + term_words<1, TERMS>(B)) +
            (size_t)STAGES * B * KC,
        wk.ob + (size_t)w0 * 32, a.s2o + (size_t)w0 * 32, a.Ko, B};
    float sum[AT][FRAGS][4];
    tile_product<1, TERMS, AT>(a.qvo + (size_t)w0 * a.Ro + r0, a.Ro, ncols,
                               a.vec_vo, nw, act, wring, sum);
    float* dst = wk.part_o + (size_t)sl * B * a.ro_eff;
    finish_tile<1, TERMS, AT>(sum, red, B, [&](int m, int r, float v) {
      if (r < ncols) dst[(size_t)m * a.ro_eff + r0 + r] = v;
    });
    if (last_arrival(tick_o + rt, So, &flag)) {
      sum_slices<TERMS>(wk.part_o, So, B, a.ro_eff, r0, ncols, nullptr, true,
                        wk.to);
      publish(done_o + rt, ep);
    }
  }

  // ---- 5: wo stage 2, (output tile): times s1o into y ----
  T* y = static_cast<T*>(a.y);
  for (int item = blockIdx.x; item < (a.No + BN - 1) / BN; item += gridDim.x) {
    const int n0 = item * BN;
    wait_flags(done_o, ro_tiles, ep);
    StagedTerms<1, TERMS> act{ts, wk.to, B, RWo, 0, 0, B};
    float sum[AT][FRAGS][4];
    tile_product<1, TERMS, AT>(a.quo + n0, a.No, a.No - n0, a.vec_uo, RWo, act,
                               wring, sum);
    finish_tile<1, TERMS, AT>(sum, red, B, [&](int m, int n, float v) {
      if (n0 + n < a.No)
        y[(size_t)m * a.No + n0 + n] = nq::from_f32<T>(v * a.s1o[n0 + n]);
    });
  }
}

// With a: launch the kernel on `grid` blocks; without: the co-resident
// block count into *out.
template <typename T, int AT, bool TC>
int run(const Args* a, int B, int G, int D, int PS, int pages, int grid,
        cudaStream_t stream, int* out) {
  const size_t smem = smem_bytes<T, AT>(B, G, D, PS, pages);
  static size_t sized = 0;  // the attribute covers every size up to this
  cudaError_t err;
  if (smem > sized) {
    err = cudaFuncSetAttribute(megakernel<T, AT, TC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  if (a == nullptr) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megakernel<T, AT, TC>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    *out = per_sm * sms;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, megakernel<T, AT, TC>, *a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TC>
int dispatch_at(const Args* a, int B, int G, int D, int PS, int pages,
                int grid, cudaStream_t st, int* out) {
  constexpr int TERMS = terms_for<T>();
  const int at = col_tiles(TERMS, B);
  if constexpr (TERMS >= 3)
    if (at == 3) return run<T, 3, TC>(a, B, G, D, PS, pages, grid, st, out);
  if (at == 2) return run<T, 2, TC>(a, B, G, D, PS, pages, grid, st, out);
  return run<T, 1, TC>(a, B, G, D, PS, pages, grid, st, out);
}

int dispatch(int dtype, const Args* a, int B, int G, int D, int PS, int pages,
             int grid, cudaStream_t st, int* out) {
  if (B < 1 || B > 8 || D % 8 || G * D > 4 * nq::walk::MAX_ITEMS * THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == nq::kFloat32)
    return dispatch_at<float, false>(a, B, G, D, PS, pages, grid, st, out);
  if (dtype == nq::kBFloat16)
    return nq::walk::tensor_walk(G, D, PS)
               ? dispatch_at<__nv_bfloat16, true>(a, B, G, D, PS, pages, grid,
                                                  st, out)
               : dispatch_at<__nv_bfloat16, false>(a, B, G, D, PS, pages,
                                                   grid, st, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the kernel for B slots (1..8), G query heads per kv head of
// head_dim D, page size PS, `pages` table entries and dtype that fit on the
// current device at once (occupancy per SM times the SM count), into *out.
extern "C" int nq_decode_megakernel_blocks(int B, int G, int D, int PS,
                                           int pages, int dtype, int* out) {
  return dispatch(dtype, nullptr, B, G, D, PS, pages, 0, nullptr, out);
}

// x: (B, K), B <= 8; qv3: (3, K/32, R); qu3: (3, R/32, Nmax); s2_3: (3, K)
// f32; s1_3: (3, Nmax) f32; rmask3: (3, R) f32; qvo: (Ko/32, Ro); quo:
// (Ro/32, No); s2o: (Ko,) f32; s1o: (No,) f32; pools: (n_pages, PS, Hkv,
// D); block_table: (B, pages) int32; q_pos, cache_pos: (B,) int32. Outputs
// y: (B, No), k_new / v_new: (B, Hkv, D). x, pools and outputs share one
// dtype; x, s2_3, s2o and the pools 16-byte aligned. ws: the workspace of
// the plan (16-byte aligned); tickets: 3 r_tiles + B Hkv + ro_tiles zeroed
// ints; flags: 3 r_tiles + nt0 + 2 nt1 + 8 Hkv + ro_tiles ints, none
// holding `epoch` (a number not given to an earlier launch, never 0); the
// slices, walk split and grid: the plan (_plan_mega). Returns the
// cudaError_t of the launch.
extern "C" int nq_decode_megakernel(
    const void* x, const void* qv3, const void* qu3, const void* s2_3,
    const void* s1_3, const void* rmask3, const void* qvo, const void* quo,
    const void* s2o, const void* s1o, const void* kpool, const void* vpool,
    const void* block_table, const void* q_pos, const void* cache_pos, void* y,
    void* k_new, void* v_new, void* ws, void* tickets, void* flags, int B,
    int K, int R,
    int r_eff, int Nmax, int Ko, int Ro, int ro_eff, int No, int nq, int nkv,
    int D, int Hkv, int pages, int PS, int window, int s1_slices, int s1_kw,
    int o_slices, int o_kw, int w_eps, int w_splits, int grid,
    unsigned epoch, float scale, float theta, int dtype, void* stream) {
  const int G = nq / D / Hkv;
  const int r_tiles = (r_eff + BN - 1) / BN;
  int* tk = static_cast<int*>(tickets);
  Args a{};
  a.x = x;
  a.qv3 = static_cast<const uint32_t*>(qv3);
  a.qu3 = static_cast<const uint32_t*>(qu3);
  a.s2_3 = static_cast<const float*>(s2_3);
  a.s1_3 = static_cast<const float*>(s1_3);
  a.rmask3 = static_cast<const float*>(rmask3);
  a.qvo = static_cast<const uint32_t*>(qvo);
  a.quo = static_cast<const uint32_t*>(quo);
  a.s2o = static_cast<const float*>(s2o);
  a.s1o = static_cast<const float*>(s1o);
  a.y = y, a.k_new = k_new, a.v_new = v_new;
  a.ws = static_cast<float*>(ws);
  a.tickets = tk;
  a.flags = static_cast<unsigned*>(flags);
  a.epoch = epoch;
  a.B = B, a.K = K, a.R = R, a.r_eff = r_eff, a.Nmax = Nmax, a.nq = nq;
  a.nkv = nkv, a.Ko = Ko, a.Ro = Ro, a.ro_eff = ro_eff, a.No = No, a.D = D;
  a.theta = theta;
  a.s1_slices = s1_slices, a.s1_kw = s1_kw, a.o_slices = o_slices;
  a.o_kw = o_kw;
  a.vec_v = reinterpret_cast<uintptr_t>(qv3) % 16 == 0;
  a.vec_u = reinterpret_cast<uintptr_t>(qu3) % 16 == 0 && Nmax % 4 == 0;
  a.vec_vo = reinterpret_cast<uintptr_t>(qvo) % 16 == 0 && Ro % 4 == 0;
  a.vec_uo = reinterpret_cast<uintptr_t>(quo) % 16 == 0 && No % 4 == 0;
  a.w = nq::walk::Walk{kpool, vpool, static_cast<const int*>(block_table),
                       static_cast<const int*>(q_pos),
                       static_cast<const int*>(cache_pos), nullptr,
                       tk + 3 * r_tiles, pages, PS, Hkv, G, D, window, scale,
                       w_eps, w_splits, 1};
  if (K % 32 || R % 32 || r_eff % 32 || Ko % 32 || Ro % 32 || ro_eff % 32 ||
      s1_slices < 1 || o_slices < 1 || w_splits < 1 || w_eps < 1 ||
      w_splits * G > 4 * THREADS || grid < 1 || epoch == 0)
    return (int)cudaErrorInvalidValue;
  const int terms = dtype == nq::kFloat32 ? terms_for<float>()
                                          : terms_for<__nv_bfloat16>();
  a.w.part = Work(a.ws, a, terms).wpart;
  return dispatch(dtype, &a, B, G, D, PS, pages, grid,
                  static_cast<cudaStream_t>(stream), nullptr);
}
