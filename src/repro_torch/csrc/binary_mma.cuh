// The +-1 tensor-core tile routine shared by binary_matmul.cu and
// packed_matmul.cu (sm_90a).
//
// One block computes a tile of BM = 8*MT activation rows by BN = 128
// output columns of  y = a @ W,  where W is a +-1 matrix packed 32 signs
// per 32-bit word along its reduction axis (bit b of word i is the sign of
// reduction row 32*i + b, set = +1; docs/manifest.md) and a holds f32
// activations split into TERMS bf16 terms (hi, mid, lo: three carry all 24
// bits of an f32 mantissa, so the split is exact for normal values).
//
// Instruction: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 in
// swap-AB form. A +-1 factor is exact in bf16 (+1 is 0x3F80, -1 is 0xBF80,
// one sign bit apart), so the A operand is the packed factor itself: 16
// output columns by 16 reduction rows, expanded straight from the words
// into bf16x2 registers (one shift and one lop3 per register) and never
// written to shared or device memory. The B operand is a k16 x n8 tile of
// activation terms (ldmatrix.x4 from shared memory) whose n dimension is
// the activation rows, so a decode batch wastes at most the unused columns
// of one n8 tile: at M <= 8 the columns are (term, row) pairs, so an f32
// operand at M = 1 costs one mma per A fragment, not three; from 9 rows on
// each term is one more mma on the same A fragment. mma.sync and not
// wgmma: wgmma with A from registers takes a 64-row warpgroup tile of the
// factor per instruction and the B terms in a swizzled shared-memory
// layout; mma.sync is the same operand layout at warp scale, simpler to
// get right first, and at decode (M <= 8) the tensor rate is not what
// bounds it.
//
// What bounds it on the H100 (measured by cutting parts of the loop out):
// at decode the integer work of expanding the words into A fragments and
// the mma issue, with few warps per SM, not the HBM read of the words; at
// prefill the mma issue and the shared-memory traffic of the B fragments.
// Registers decide the warps per SM, so the accumulators are sized to the
// rows that exist (col_tiles), decode tiles give every column warp a twin
// over half the words (k_groups), and one mma chain per accumulator was
// faster than several.
//
// Reduction order: a word's 32 rows are fed to the mma as 16 pairs (p,
// p + 16), p = 0..15, which puts both bits of a pair at the sign positions
// 15 and 31 after one left shift by 15 - p. The activation terms are
// staged in the same pair order ([row][word][pair] bf16x2), so any k slot
// of the mma sees the same reduction row in A and B.
//
// Accuracy: the tensor cores' f32 accumulation is not round-to-nearest at
// every step, so each staged K chunk (at most 512 reduction rows) is
// summed in fresh mma accumulators and then added into a separate f32
// register sum. (Carrying the accumulators over several chunks at prefill
// was measured slower: it holds more registers.)
//
// Staging: the words of a K chunk (and the caller's activation operand)
// are copied into shared memory with cp.async through a ring of STAGES
// buffers, so the next chunks load while this one multiplies (a ring of 2
// or 4 measured the same as 3). Edges are masked, never padded: columns
// past the tile's valid count load as zero words, rows past M are neither
// staged nor stored (an output depends only on its own A row and B
// column), and a K range covers whole words only.
#pragma once

#include "common.cuh"

namespace nq {
namespace mma1 {

constexpr int COL_WARPS = 4;              // warps across a tile's columns
constexpr int FRAGS = 2;                  // 16-column A fragments per warp
constexpr int BN = COL_WARPS * FRAGS * 16;  // output columns per block tile
constexpr int STAGES = 3;                 // chunk buffers in the copy ring

// packed words per staged K chunk for MT n8 tiles of activation rows
__host__ __device__ constexpr int chunk_words(int mt) {
  return mt >= 8 ? 2 : 16 / mt;
}
// row stride (in bf16x2 words) of a term plane in shared memory: a row's
// chunk_words * 16 pairs, padded by 4 so that the eight 16-byte rows of an
// ldmatrix 8x8 matrix fall in distinct banks
__host__ __device__ constexpr int term_stride(int mt) {
  return chunk_words(mt) * 16 + 4;
}
// K groups: at decode (MT <= 2) each column warp has a twin that takes
// every other word of a chunk, so an SM holds twice the warps to hide
// latency; their sums meet in finish_tile.
__host__ __device__ constexpr int k_groups(int mt) { return mt <= 2 ? 2 : 1; }
__host__ __device__ constexpr int threads_for(int mt) {
  return 32 * COL_WARPS * k_groups(mt);
}
// terms for an f32 operand: three (hi, mid, lo) into an f32 result, two
// into a bf16 one
template <typename TO>
__host__ __device__ constexpr int terms_for() {
  return sizeof(TO) == 4 ? 3 : 2;
}

// ---- cp.async (src_bytes < 16 or 4 zero-fills the rest) ----
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- the split of f32 values into bf16 terms ----
// Terms of the pair (v0, v1) as bf16x2 words, v0 in the low half.
template <int TERMS>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&out)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
    out[i] = (uint32_t)__bfloat16_as_ushort(h0) |
             ((uint32_t)__bfloat16_as_ushort(h1) << 16);
    v0 -= __bfloat162float(h0);
    v1 -= __bfloat162float(h1);
  }
}

// Two +-1 bf16 values from bits 15 (low half) and 31 (high half) of v:
// a set bit gives +1.0 (0x3F80), a clear one -1.0 (0xBF80).
__device__ __forceinline__ uint32_t pm1_pair(uint32_t v) {
  return 0x3F803F80u | (~v & 0x80008000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy nw word rows of a tile's BN columns into ws ([KCW][BN]); words
// points at the tile's first column of row 0, ldw is the row stride in
// words, ncols the tile's valid columns. vec: 16-byte copies (words and
// ldw 16-byte aligned), else one word per copy.
__device__ __forceinline__ void copy_words(uint32_t* ws,
                                           const uint32_t* words,
                                           long long ldw, int nw, int ncols,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int i = tid; i < nw * (BN / 4); i += blockDim.x) {
      const int w = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int ok = max(0, min(4, ncols - c));
      cp16(ws + w * BN + c, ok ? words + (size_t)w * ldw + c : words, 4 * ok);
    }
  } else {
    for (int i = tid; i < nw * BN; i += blockDim.x) {
      const int w = i / BN, c = i % BN;
      const bool ok = c < ncols;
      cp4(ws + w * BN + c, ok ? words + (size_t)w * ldw + c : words,
          ok ? 4 : 0);
    }
  }
}

// Accumulator tiles (AT): one per n8 tile of activation rows, MT of them,
// except at MT = 1 (M <= 8 rows, decode), where the B columns hold
// (term, row) pairs: term tau of row m is column tau * M + m, so the
// M * TERMS columns fill col_tiles = ceil(M * TERMS / 8) <= TERMS n8 tiles
// (an f32 operand at M <= 2 costs one mma per A fragment, not three, and
// holds a third of the accumulators). Their terms are added in the
// epilogue.
__host__ __device__ constexpr int col_tiles(int terms, int rows) {
  return (terms * rows + 7) / 8;
}

// The term planes of one staged chunk: TERMS planes, `plane` words apart,
// each of `stride_rows` rows of term_stride words in pair order, of which
// the first `rows` hold this tile's rows below M. The lanes of tile rows
// past them read the last real row instead: B column m of the mma meets
// only output row m, which is never stored, so neither smem nor copies
// are spent on rows that do not exist (7 of 8 at M = 1).
struct TermView {
  const uint32_t* ts;
  int rows, plane;
};

// Four rows of activation terms for the mma: ldmatrix.x4 hands lane
// (g, t) the 32-bit word t of row g of each of four 8x8 bf16 matrices,
// which is the B-fragment layout; lane L supplies the address of row L % 8
// of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Multiply one staged chunk: this warp's K group's share of the nw words
// of its columns (ws, [KCW][BN]) by the activation terms of tv; adds into
// acc. Lane group g of a warp owns the warp's columns 4g .. 4g + 3 (one
// 16-byte load per word): fragment f's A rows g and g + 8 are columns
// 4g + 2f and 4g + 2f + 1. One ldmatrix.x4 per (n8 tile of B, word)
// fetches the B fragments of both k16 steps of the word.
template <int MT, int TERMS, int AT>
__device__ __forceinline__ void mma_chunk(const uint32_t* ws, TermView tv,
                                          int nw, float (&acc)[AT][FRAGS][4]) {
  constexpr int RS = term_stride(MT), KG = k_groups(MT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, kg = warp / COL_WARPS;
  const uint4* wq = reinterpret_cast<const uint4*>(
      ws + (warp % COL_WARPS) * 32 + 4 * (lane >> 2));
  // B tile j's rows: at MT = 1 the (term, row) columns 8j .. 8j + 7 (the
  // term planes are contiguous, so column v is row v of the buffer), else
  // rows 8j .. of each term plane; past the real ones, the last real one.
  // Matrix lane / 8 of an x4 load is (step jx >> 1, pairs +4 if jx & 1).
  const int jx = lane >> 3;
  const int last = MT == 1 ? TERMS * tv.rows - 1 : tv.rows - 1;
  const int tiles = MT == 1 ? (TERMS * tv.rows + 7) / 8 : MT;
  unsigned bq[AT];
#pragma unroll
  for (int j = 0; j < AT; ++j)
    bq[j] = (unsigned)__cvta_generic_to_shared(
        tv.ts + min(j * 8 + (lane & 7), last) * RS + 8 * (jx >> 1) +
        4 * (jx & 1));
  const unsigned plane_bytes = 4u * tv.plane;
  for (int w2 = kg; w2 < nw; w2 += 2 * KG) {
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      const int w = w2 + wi * KG;  // this K group's words of the chunk
      if (w >= nw) break;
      // columns 4g .. 4g + 3, pre-shifted so that pair p = 8s + t (+4)
      // reaches the sign positions below
      const uint4 q = wq[w * (BN / 4)];
      const uint32_t lo[FRAGS] = {q.x << (3 - t), q.z << (3 - t)};
      const uint32_t hi[FRAGS] = {q.y << (3 - t), q.w << (3 - t)};
      uint32_t a[2][FRAGS][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int f = 0; f < FRAGS; ++f) {
          a[s][f][0] = pm1_pair(lo[f] << (12 - 8 * s));  // row g,   pair 8s+t
          a[s][f][1] = pm1_pair(hi[f] << (12 - 8 * s));  // row g+8, pair 8s+t
          a[s][f][2] = pm1_pair(lo[f] << (8 - 8 * s));   // row g,   pair 8s+t+4
          a[s][f][3] = pm1_pair(hi[f] << (8 - 8 * s));   // row g+8, pair 8s+t+4
        }
#pragma unroll
      for (int j = 0; j < AT; ++j) {
        if (j >= tiles) break;
        // at MT = 1 one pass covers every term; else one pass per term
#pragma unroll
        for (int term = 0; term < (MT == 1 ? 1 : TERMS); ++term) {
          uint32_t b[4];
          ldmatrix_x4(b, bq[j] + term * plane_bytes + w * 64);
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int f = 0; f < FRAGS; ++f)
              mma_bf16(acc[j][f], a[s][f], b[2 * s], b[2 * s + 1]);
        }
      }
    }
  }
}

// sum = a @ W over nw_total words of the tile's K range, through a ring
// of STAGES chunk buffers: the copies of the next STAGES - 1 chunks are in
// flight while one chunk multiplies. words: the tile's first column at
// the range's first word row. Act stages the activation operand:
// issue(buf, word0, nw) starts the cp.async copies of a chunk (word0
// counted from the range's start), and terms(buf, nw) returns the
// chunk's TermView once its copies have landed. ws holds STAGES * KCW *
// BN words.
template <int MT, int TERMS, int AT, class Act>
__device__ __forceinline__ void tile_product(
    const uint32_t* words, long long ldw, int ncols, bool vec, int nw_total,
    Act& act, uint32_t* ws, float (&sum)[AT][FRAGS][4]) {
  constexpr int KCW = chunk_words(MT);
#pragma unroll
  for (int mt = 0; mt < AT; ++mt)
#pragma unroll
    for (int f = 0; f < FRAGS; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][f][i] = 0.f;
  const int nch = (nw_total + KCW - 1) / KCW;
  auto issue = [&](int c) {  // one commit group per chunk, empty past the end
    if (c < nch) {
      const int w0 = c * KCW, nw = min(KCW, nw_total - w0);
      copy_words(ws + (c % STAGES) * KCW * BN, words + (size_t)w0 * ldw, ldw,
                 nw, ncols, vec);
      act.issue(c % STAGES, w0, nw);
    }
    cp_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nch; ++c) {
    issue(c + STAGES - 1);     // into the buffer chunk c - 1 freed
    cp_wait<STAGES - 1>();     // chunk c's group is complete
    __syncthreads();           // and visible to every warp
    const int nw = min(KCW, nw_total - c * KCW);
    const TermView tv = act.terms(c % STAGES, nw);
    float acc[AT][FRAGS][4];
#pragma unroll
    for (int mt = 0; mt < AT; ++mt)
#pragma unroll
      for (int f = 0; f < FRAGS; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][f][i] = 0.f;
    mma_chunk<MT, TERMS, AT>(ws + (c % STAGES) * KCW * BN, tv, nw, acc);
#pragma unroll
    for (int mt = 0; mt < AT; ++mt)
#pragma unroll
      for (int f = 0; f < FRAGS; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][f][i] += acc[mt][f][i];
    __syncthreads();           // buffer c % STAGES is free again
  }
  cp_wait<0>();                // no copy outlives the tile (empty groups)
}

// Words of shared memory for the term planes of one chunk, for a tile
// whose rows below M number at most stride_rows.
template <int MT, int TERMS>
__host__ __device__ constexpr int term_words(int stride_rows) {
  return TERMS * stride_rows * term_stride(MT);
}

// Activation operand already split: TERMS planes of [M rows][kw words][16
// pairs] in device memory (rows m0.. of this tile, words from word0),
// copied chunk by chunk into STAGES buffers of term_words words at ts.
template <int MT, int TERMS>
struct StagedTerms {
  uint32_t* ts;
  const uint32_t* src;  // plane 0, row 0, word 0 of the operand
  int M, kw, m0, word0, stride_rows;
  __device__ __forceinline__ int rows() const { return min(8 * MT, M - m0); }
  __device__ __forceinline__ void issue(int buf, int w0, int nw) {
    constexpr int RS = term_stride(MT);
    uint32_t* dst = ts + buf * term_words<MT, TERMS>(stride_rows);
    const int q_row = nw * 4;  // 16-byte pieces per row
    const int n = rows();
    for (int i = threadIdx.x; i < TERMS * n * q_row; i += blockDim.x) {
      const int q = i % q_row, r = (i / q_row) % n, term = i / (q_row * n);
      cp16(dst + (term * stride_rows + r) * RS + q * 4,
           src + (((size_t)term * M + m0 + r) * kw + word0 + w0) * 16 + q * 4,
           16);
    }
  }
  __device__ __forceinline__ TermView terms(int buf, int) const {
    return {ts + buf * term_words<MT, TERMS>(stride_rows), rows(),
            stride_rows * term_stride(MT)};
  }
};

// Floats of shared memory that finish_tile uses (free of any copy).
template <int MT, int AT>
__host__ __device__ constexpr int red_floats() {
  return MT == 1 ? k_groups(MT) * 8 * AT * BN
                 : (k_groups(MT) - 1) * AT * FRAGS * 4 * 32 * COL_WARPS;
}

// The epilogue of a tile: adds the K groups' sums and, at MT = 1, the
// terms of each row, in a fixed order (deterministic), then calls
// f(m, n, v) once for each of the tile's `rows` rows below M and each of
// its BN columns (m, n counted in the tile). red: red_floats floats of
// shared memory; every thread of the block calls it.
template <int MT, int TERMS, int AT, class F>
__device__ __forceinline__ void finish_tile(const float (&sum)[AT][FRAGS][4],
                                            float* red, int rows, F f) {
  constexpr int KG = k_groups(MT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, kg = warp / COL_WARPS;
  const int col = (warp % COL_WARPS) * 32 + 4 * g;
  if constexpr (MT == 1) {
    // red[kg][column v of B][n]: every group's sums, then rows read back
#pragma unroll
    for (int j = 0; j < AT; ++j)
#pragma unroll
      for (int fr = 0; fr < FRAGS; ++fr)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(kg * 8 * AT + j * 8 + 2 * t + (i & 1)) * BN + col + 2 * fr +
              (i >> 1)] = sum[j][fr][i];
    __syncthreads();
    for (int e = threadIdx.x; e < rows * BN; e += blockDim.x) {
      const int m = e / BN, n = e % BN;
      float v = 0.f;
      for (int k = 0; k < KG; ++k)
#pragma unroll
        for (int term = 0; term < TERMS; ++term)
          v += red[(k * 8 * AT + term * rows + m) * BN + n];
      f(m, n, v);
    }
    __syncthreads();  // red is free again
  } else {
    float acc[AT][FRAGS][4];
#pragma unroll
    for (int mt = 0; mt < AT; ++mt)
#pragma unroll
      for (int fr = 0; fr < FRAGS; ++fr)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][fr][i] = sum[mt][fr][i];
    if constexpr (KG > 1) {  // K groups 1.. hand their sums to group 0
      constexpr int W = 32 * COL_WARPS;
      const int slot = threadIdx.x % W;
      if (kg > 0) {
#pragma unroll
        for (int mt = 0; mt < AT; ++mt)
#pragma unroll
          for (int fr = 0; fr < FRAGS; ++fr)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              red[(((kg - 1) * AT + mt) * FRAGS * 4 + fr * 4 + i) * W + slot] =
                  acc[mt][fr][i];
      }
      __syncthreads();
      if (kg == 0) {
        for (int k = 1; k < KG; ++k)
#pragma unroll
          for (int mt = 0; mt < AT; ++mt)
#pragma unroll
            for (int fr = 0; fr < FRAGS; ++fr)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[mt][fr][i] +=
                    red[(((k - 1) * AT + mt) * FRAGS * 4 + fr * 4 + i) * W +
                        slot];
      }
      __syncthreads();  // red is free again
    }
    if (kg == 0) {
#pragma unroll
      for (int mt = 0; mt < AT; ++mt)
#pragma unroll
        for (int fr = 0; fr < FRAGS; ++fr)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = mt * 8 + 2 * t + (i & 1);
            if (m < rows) f(m, col + 2 * fr + (i >> 1), acc[mt][fr][i]);
          }
    }
  }
}

}  // namespace mma1
}  // namespace nq
