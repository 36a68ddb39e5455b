// Decode-step megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/megakernel.py::
// decode_step_megakernel_raw (body _kernel, _stage1, _stage2, _rope_rows):
// the whole attention half of one decode step in a single launch —
//   1. merged-QKV packed low-rank matmul (3 groups, rmask, eff_rank),
//   2. rotate-half RoPE of q and the fresh k at q_pos,
//   3. the block-table page walk with an f32 online softmax that EXCLUDES
//      the virtual row == cache_pos (this token's row, stale at read time),
//   4. the fold of the fresh k/v entry,
//   5. normalisation,
//   6. the packed wo projection (eff_rank_o).
// Roundings follow the unfused chain: projections round to x's dtype,
// the fresh k/v to the pool dtype before scoring, o to x's dtype before
// wo. The caller writes k_new / v_new into the pool.
//
// What bounds it on the H100: bytes — the packed QKV and wo factors
// (about 1 MB per layer of llama3.2-1b at 1 bpw) plus the slot's mapped
// K/V pages. Neither the rank intermediates nor q/k/v nor the attention
// output touch device memory: they stay in shared memory. The +-1
// products run on the CUDA cores in f32 (a sign-bit XOR and an add each),
// so at decode batch sizes the kernel is bound by the latency of its
// chains of packed-word loads and adds, not by either rate.
//
// Design: one cluster of CL blocks per slot (grid (CL, B)), so a slot's
// work spreads over CL SMs while every intermediate stays on chip. Block
// c of a cluster owns 1/CL of the rank columns of each stage 1 and the
// kv heads h with h % CL == c (one each for llama3.2-1b's 8). Phases:
// QKV stage 1 on its rank columns → gather the rank intermediate from
// the cluster's shared memory (distributed shared memory), masked → QKV
// stage 2 for its own heads' q, k and v columns → RoPE → page walk, fresh
// entry, normalise for its heads → gather the whole attention output →
// wo stage 1 on its rank columns → gather → wo stage 2 on its 1/CL of the
// output columns. Four cluster barriers order the exchanges.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int CL = 8;          // blocks per slot (the portable cluster maximum)

struct Dims {
  int K, R, r_eff, Nmax;           // merged QKV operands
  int Ko, Ro, ro_eff, No;          // wo operands
  int nq, nkv, D, Hkv, G;          // head layout
  int pages, PS, window;           // page walk
  float scale, theta;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The shared-memory carve-up, the same in every block of a cluster (the
// distributed-shared-memory reads rely on that). Sizes in floats.
struct Smem {
  float *xs, *t_own, *t_full, *q_s, *k_s, *v_s, *ks, *vs, *ss, *ms, *o_s,
      *m_run, *l_run, *alpha, *p_new;
  size_t floats;

  __host__ __device__ Smem(float* base, const Dims& dm) {
    const int rc = (dm.r_eff + CL - 1) / CL, rco = (dm.ro_eff + CL - 1) / CL;
    const size_t page = (size_t)dm.PS * (dm.D + 1), gps = (size_t)dm.G * dm.PS;
    size_t o = 0;
    xs = base + o;      o += imax(3 * dm.K, dm.Ko);             // scaled x / o
    t_own = base + o;   o += imax(3 * rc, rco);                 // own columns
    t_full = base + o;  o += imax(3 * dm.r_eff, dm.ro_eff);     // gathered
    q_s = base + o;     o += dm.nq;
    k_s = base + o;     o += dm.nkv;
    v_s = base + o;     o += dm.nkv;
    ks = base + o;      o += page;          // one page of K, rows padded
    vs = base + o;      o += page;
    ss = base + o;      o += gps;           // scores, then probabilities
    ms = base + o;      o += gps;           // 1 = valid row
    o_s = base + o;     o += dm.nq;         // this block's heads' output
    m_run = base + o;   o += dm.G;
    l_run = base + o;   o += dm.G;
    alpha = base + o;   o += dm.G;
    p_new = base + o;   o += dm.G;
    floats = o;
  }
};

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
megakernel(const T* __restrict__ x, const uint32_t* __restrict__ qv3,
           const uint32_t* __restrict__ qu3, const float* __restrict__ s2_3,
           const float* __restrict__ s1_3, const float* __restrict__ rmask3,
           const uint32_t* __restrict__ qvo, const uint32_t* __restrict__ quo,
           const float* __restrict__ s2o, const float* __restrict__ s1o,
           const T* __restrict__ kpool, const T* __restrict__ vpool,
           const int* __restrict__ block_table, const int* __restrict__ q_pos,
           const int* __restrict__ cache_pos, T* __restrict__ y,
           T* __restrict__ k_new, T* __restrict__ v_new, Dims dm) {
  extern __shared__ float smem[];
  const Smem sm(smem, dm);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = THREADS / 32;
  const int DP = dm.D + 1;
  const int GD = dm.G * dm.D;                  // q columns per kv head
  const int qp = q_pos[b], cp = cache_pos[b];
  const int rows = dm.pages * dm.PS;
  const int n_heads = (dm.Hkv - c + CL - 1) / CL;   // heads c, c+CL, ...

  // ---- 1a. QKV stage 1 on this block's rank columns [r0, r1) ----
  const int rc = (dm.r_eff + CL - 1) / CL;
  const int r0 = c * rc, r1 = min(dm.r_eff, r0 + rc), rn = r1 - r0;
  for (int i = tid; i < 3 * dm.K; i += THREADS) {
    const int g3 = i / dm.K, k = i % dm.K;
    sm.xs[i] = nq::to_f32(x[(size_t)b * dm.K + k]) * s2_3[(size_t)g3 * dm.K + k];
  }
  __syncthreads();
  for (int i = tid; i < 3 * rn; i += THREADS) {
    const int g3 = i / rn, r = r0 + i % rn;
    const float* xg = sm.xs + g3 * dm.K;
    const uint32_t* col = qv3 + (size_t)g3 * (dm.K / 32) * dm.R + r;
    float acc = 0.f;
    for (int w = 0; w < dm.K / 32; ++w) {
      const uint32_t word = col[(size_t)w * dm.R];
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) acc += nq::signed_by(xg[w * 32 + bit], word, bit);
    }
    sm.t_own[g3 * rc + r - r0] = acc;
  }

  // ---- 1b. gather the three rank intermediates, masked ----
  cluster.sync();
  for (int i = tid; i < 3 * dm.r_eff; i += THREADS) {
    const int g3 = i / dm.r_eff, r = i % dm.r_eff, owner = r / rc;
    const float* src = cluster.map_shared_rank(sm.t_own, owner);
    sm.t_full[i] = src[g3 * rc + r - owner * rc] * rmask3[(size_t)g3 * dm.R + r];
  }
  __syncthreads();

  // ---- 1c. QKV stage 2 for this block's heads, rounded to x's dtype ----
  const int per_head = GD + 2 * dm.D;
  for (int i = tid; i < n_heads * per_head; i += THREADS) {
    const int h = c + (i / per_head) * CL, j = i % per_head;
    int g3, n;
    float* dst;
    if (j < GD) {
      g3 = 0, n = h * GD + j, dst = sm.q_s + n;
    } else if (j < GD + dm.D) {
      g3 = 1, n = h * dm.D + j - GD, dst = sm.k_s + n;
    } else {
      g3 = 2, n = h * dm.D + j - GD - dm.D, dst = sm.v_s + n;
    }
    const float* t = sm.t_full + g3 * dm.r_eff;
    const uint32_t* col = qu3 + (size_t)g3 * (dm.R / 32) * dm.Nmax + n;
    float acc = 0.f;
    for (int w = 0; w < dm.r_eff / 32; ++w) {
      const uint32_t word = col[(size_t)w * dm.Nmax];
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) acc += nq::signed_by(t[w * 32 + bit], word, bit);
    }
    *dst = nq::round_to<T>(acc * s1_3[(size_t)g3 * dm.Nmax + n]);
  }
  __syncthreads();

  // ---- 2. RoPE on this block's q heads and k heads, f32 trig ----
  const int half = dm.D / 2;
  const int rope_rows = dm.G + 1;              // G q rows + 1 k row per head
  for (int i = tid; i < n_heads * rope_rows * half; i += THREADS) {
    const int h = c + (i / (rope_rows * half)) * CL;
    const int row = (i / half) % rope_rows, j = i % half;
    const float inv = 1.0f / powf(dm.theta, (2.0f * (float)j) / (float)dm.D);
    const float ang = (float)qp * inv;
    const float cs = cosf(ang), sn = sinf(ang);
    float* hrow = row < dm.G ? sm.q_s + (h * dm.G + row) * dm.D : sm.k_s + h * dm.D;
    const float x1 = hrow[j], x2 = hrow[j + half];
    hrow[j] = x1 * cs - x2 * sn;
    hrow[j + half] = x2 * cs + x1 * sn;
  }
  __syncthreads();
  for (int i = tid; i < n_heads * GD; i += THREADS) {
    const int n = (c + (i / GD) * CL) * GD + i % GD;
    sm.q_s[n] = nq::round_to<T>(sm.q_s[n]);
  }
  for (int i = tid; i < n_heads * dm.D; i += THREADS) {
    const int n = (c + (i / dm.D) * CL) * dm.D + i % dm.D;
    const T kv = nq::from_f32<T>(sm.k_s[n]);
    k_new[(size_t)b * dm.nkv + n] = kv;
    sm.k_s[n] = nq::to_f32(kv);
    v_new[(size_t)b * dm.nkv + n] = nq::from_f32<T>(sm.v_s[n]);
  }

  // ---- 3-5. per own kv head: page walk, fresh entry, normalise ----
  for (int jh = 0; jh < n_heads; ++jh) {
    const int h = c + jh * CL;
    const float* qh = sm.q_s + h * GD;
    float* acc_h = sm.o_s + h * GD;
    __syncthreads();
    for (int i = tid; i < GD; i += THREADS) acc_h[i] = 0.f;
    for (int g = tid; g < dm.G; g += THREADS) {
      sm.m_run[g] = -INFINITY;
      sm.l_run[g] = 0.f;
    }
    for (int p = 0; p < dm.pages; ++p) {
      const int page = block_table[(size_t)b * dm.pages + p];
      __syncthreads();
      for (int i = tid; i < dm.PS * dm.D; i += THREADS) {
        const int row = i / dm.D, d = i % dm.D;
        const size_t src = (((size_t)page * dm.PS + row) * dm.Hkv + h) * dm.D + d;
        sm.ks[row * DP + d] = nq::to_f32(kpool[src]);
        sm.vs[row * DP + d] = nq::to_f32(vpool[src]);
      }
      __syncthreads();
      for (int i = tid; i < dm.G * dm.PS; i += THREADS) {
        const int g = i / dm.PS, row = i % dm.PS;
        const int r = p * dm.PS + row;
        const int abs_pos = qp - nq::floor_mod(cp - r, rows);
        // r == cache_pos is the row this token overwrites: stale now,
        // its fresh k/v are folded in after the walk instead
        const bool valid = abs_pos >= 0 && r != cp &&
                           (dm.window == 0 || abs_pos > qp - dm.window);
        float s = -1e30f;
        if (valid) {
          float dot = 0.f;
          for (int d = 0; d < dm.D; ++d) dot += qh[g * dm.D + d] * sm.ks[row * DP + d];
          s = dot * dm.scale;
        }
        sm.ss[i] = s;
        sm.ms[i] = valid ? 1.f : 0.f;
      }
      __syncthreads();
      for (int g = warp; g < dm.G; g += n_warps) {
        float mx = -INFINITY;
        for (int row = lane; row < dm.PS; row += 32) mx = fmaxf(mx, sm.ss[g * dm.PS + row]);
        mx = nq::warp_max(mx);
        const float m_prev = sm.m_run[g];
        const float m_new = fmaxf(m_prev, mx);
        float psum = 0.f;
        for (int row = lane; row < dm.PS; row += 32) {
          const int i = g * dm.PS + row;
          const float pe = sm.ms[i] != 0.f ? expf(sm.ss[i] - m_new) : 0.f;
          sm.ss[i] = pe;
          psum += pe;
        }
        psum = nq::warp_sum(psum);
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          sm.alpha[g] = a;
          sm.l_run[g] = sm.l_run[g] * a + psum;
          sm.m_run[g] = m_new;
        }
      }
      __syncthreads();
      for (int i = tid; i < GD; i += THREADS) {
        const int g = i / dm.D, d = i % dm.D;
        float a = acc_h[i] * sm.alpha[g];
        for (int row = 0; row < dm.PS; ++row) a += sm.ss[g * dm.PS + row] * sm.vs[row * DP + d];
        acc_h[i] = a;
      }
    }
    __syncthreads();
    // fresh entry at abs_pos == q_pos (always inside any window)
    for (int g = warp; g < dm.G; g += n_warps) {
      float dot = 0.f;
      for (int d = lane; d < dm.D; d += 32) dot += qh[g * dm.D + d] * sm.k_s[h * dm.D + d];
      dot = nq::warp_sum(dot);
      if (lane == 0) {
        const float s_new = dot * dm.scale;
        const float m_prev = sm.m_run[g];
        const float m_new = fmaxf(m_prev, s_new);
        const float a = expf(m_prev - m_new);
        const float pn = expf(s_new - m_new);
        sm.alpha[g] = a;
        sm.p_new[g] = pn;
        sm.l_run[g] = sm.l_run[g] * a + pn;
      }
    }
    __syncthreads();
    for (int i = tid; i < GD; i += THREADS) {
      const int g = i / dm.D, d = i % dm.D;
      const float a = acc_h[i] * sm.alpha[g] + sm.p_new[g] * sm.v_s[h * dm.D + d];
      acc_h[i] = nq::round_to<T>(a / fmaxf(sm.l_run[g], 1e-30f));
    }
  }

  // ---- 6a. gather the attention output, scaled, zero-padded to Ko ----
  cluster.sync();
  for (int k = tid; k < dm.Ko; k += THREADS) {
    float v = 0.f;
    if (k < dm.nq) v = cluster.map_shared_rank(sm.o_s, (k / GD) % CL)[k];
    sm.xs[k] = v * s2o[k];
  }
  __syncthreads();

  // ---- 6b. wo stage 1 on this block's rank columns ----
  const int rco = (dm.ro_eff + CL - 1) / CL;
  const int ro0 = c * rco, ro1 = min(dm.ro_eff, ro0 + rco);
  for (int r = ro0 + tid; r < ro1; r += THREADS) {
    const uint32_t* col = qvo + r;
    float acc = 0.f;
    for (int w = 0; w < dm.Ko / 32; ++w) {
      const uint32_t word = col[(size_t)w * dm.Ro];
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) acc += nq::signed_by(sm.xs[w * 32 + bit], word, bit);
    }
    sm.t_own[r - ro0] = acc;
  }
  cluster.sync();
  for (int r = tid; r < dm.ro_eff; r += THREADS) {
    const int owner = r / rco;
    sm.t_full[r] = cluster.map_shared_rank(sm.t_own, owner)[r - owner * rco];
  }
  cluster.sync();  // no block leaves while another still reads its columns

  // ---- 6c. wo stage 2 on this block's 1/CL of the output columns ----
  const int nc = (dm.No + CL - 1) / CL;
  const int n_end = min(dm.No, (c + 1) * nc);
  for (int n = c * nc + tid; n < n_end; n += THREADS) {
    float a = 0.f;
    for (int w = 0; w < dm.ro_eff / 32; ++w) {
      const uint32_t word = quo[(size_t)w * dm.No + n];
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) a += nq::signed_by(sm.t_full[w * 32 + bit], word, bit);
    }
    y[(size_t)b * dm.No + n] = nq::from_f32<T>(a * s1o[n]);
  }
}

template <typename T>
int launch(const void* const* p, void* y, void* k_new, void* v_new, int B,
           const Dims& dm, cudaStream_t stream) {
  const size_t smem = Smem(nullptr, dm).floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      megakernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  megakernel<T><<<dim3(CL, B), THREADS, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const uint32_t*>(p[1]),
      static_cast<const uint32_t*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const uint32_t*>(p[6]), static_cast<const uint32_t*>(p[7]),
      static_cast<const float*>(p[8]), static_cast<const float*>(p[9]),
      static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
      static_cast<const int*>(p[12]), static_cast<const int*>(p[13]),
      static_cast<const int*>(p[14]), static_cast<T*>(y), static_cast<T*>(k_new),
      static_cast<T*>(v_new), dm);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, K); qv3: (3, K/32, R); qu3: (3, R/32, Nmax); s2_3: (3, K) f32;
// s1_3: (3, Nmax) f32; rmask3: (3, R) f32; qvo: (Ko/32, Ro); quo: (Ro/32,
// No); s2o: (Ko,) f32; s1o: (No,) f32; pools: (n_pages, PS, Hkv, D);
// block_table: (B, pages) int32; q_pos, cache_pos: (B,) int32.
// Outputs y: (B, No), k_new / v_new: (B, Hkv, D). x, pools and outputs
// share one dtype. Returns the cudaError_t of the launch.
extern "C" int nq_decode_megakernel(
    const void* x, const void* qv3, const void* qu3, const void* s2_3,
    const void* s1_3, const void* rmask3, const void* qvo, const void* quo,
    const void* s2o, const void* s1o, const void* kpool, const void* vpool,
    const void* block_table, const void* q_pos, const void* cache_pos, void* y,
    void* k_new, void* v_new, int B, int K, int R, int r_eff, int Nmax, int Ko,
    int Ro, int ro_eff, int No, int nq, int nkv, int D, int Hkv, int pages,
    int PS, int window, float scale, float theta, int dtype, void* stream) {
  const void* ptrs[15] = {x,   qv3, qu3, s2_3,  s1_3,        rmask3, qvo,      quo,
                          s2o, s1o, kpool, vpool, block_table, q_pos,  cache_pos};
  Dims dm{K,  R,   r_eff,         Nmax, Ko,    Ro, ro_eff, No,    nq,
          nkv, D, Hkv, nq / D / Hkv, pages, PS, window, scale, theta};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nq::kFloat32) return launch<float>(ptrs, y, k_new, v_new, B, dm, st);
  if (dtype == nq::kBFloat16)
    return launch<__nv_bfloat16>(ptrs, y, k_new, v_new, B, dm, st);
  return (int)cudaErrorInvalidValue;
}
