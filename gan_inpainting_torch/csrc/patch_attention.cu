// Patch attention: flash attention over materialized patch Q/K/V, for
// Hopper (sm_90a) — the forward, the dQ and the dK/dV kernel.
//
// The bf16 kernels run the cluster mainloops of attention_wgmma.cuh (the
// forward, gi_patch_attention_fwd_wgmma) and attention_bwd_wgmma.cuh (dQ
// and dK/dV, gi_patch_attention_{dq,dkv}_wgmma): wgmma fed by TMA, 64-wide
// units of d and dv over the cluster's blocks, 128 columns per step. The
// template below is the CUDA-core version of all three, for float32 (and
// bf16, which the card's tests compare with).
//
// Replaces the Pallas kernels _fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel of gan_inpainting_tpu/ops/pallas/patch_attention.py:
//
//   s   = scale·q·k + bias_k            bias −1e9 on an invalid key
//   p   = exp(s − m)·valid_k            the multiply drops invalid keys
//   out = Σ_k p·v / Σ_k p               0 for a row with no valid key
//   lse = m + log Σ_k p                 0 for a row with no valid key
//   dp  = dO·vᵀ, ds = p·(dp − δ)·scale, p rebuilt as exp(s − lse)·valid
//   dq  = Σ_k ds·k,  dk = Σ_q ds·q,  dv = Σ_q p·dO
//
// Inputs (contiguous): q (B, Lq, d), k (B, Lk, d), v (B, Lk, dv), T =
// float or __nv_bfloat16; valid (B, Lk) bytes 0/1; for the backward also
// dO (B, Lq, dv) T and lse, δ = rowsum(dO∘out) (B, Lq) float.
//
// What bounds it on this card: 2·Lq·Lk·(d + dv) operations for the
// forward, 2·Lq·Lk·(2d + dv) for dQ and 2·Lq·Lk·(2d + 2dv) for dK/dV,
// against (Lq + Lk)·(d + dv) elements of input: at the 2048² map (L = 65
// 536, d = 1728, dv = 3072) operations, by two orders of magnitude.
//
// The trouble is the head width. One query row's float32 accumulator over
// dv = 3072 is 12 KB and a 64-row Q tile of d = 1728 in bf16 is 221 KB, so
// no block can hold a row tile whole, as token attention's kernels do. A
// thread block cluster of CL ≤ 8 blocks shares one tile of BR rows
// instead: block `rank` holds the rows' slice of d (the score contraction)
// and of dv (the accumulator), in 16-wide chunks. Per step of BC columns:
//   1. every block stages its slices of the column tile and forms the
//      partial scores (and, in the backward, partial dp) of its slice;
//   2. cluster barrier; the block that owns BR/CL of the rows sums the CL
//      partials through distributed shared memory in rank order, applies
//      the softmax (running max and sum, or p and ds from lse and δ) and
//      publishes its rows of the weights (and the forward's rescale
//      factors);
//   3. cluster barrier; every block gathers all rows of the weights and
//      adds weights × its value (or key, query, dO) slice to its
//      accumulator slice.
// So scores are computed once per (row, column) pair and every operand
// byte is read once per row tile, whatever d and dv are. The partial and
// weight buffers are double-buffered by step parity, which makes two
// cluster barriers per step enough.
//
// Rows are queries in the forward and in dQ, keys in dK/dV. Ragged tails
// (L not a multiple of BR or BC, d or dv not a multiple of 16) are bounded
// in the kernel: out-of-range rows and columns load as zeros, out-of-range
// keys count as invalid, nothing out of range is stored. Offsets are 64-bit.
//
// The template computes 16×8 fragments with FMAs on the CUDA cores, float32
// sums; in bf16, p (forward, dV) and ds (dQ, dK) are rounded to bf16 for
// their products. Tiles are staged from global memory with 16-byte
// cp.async copies.
#include <cooperative_groups.h>
#include <math_constants.h>

#include <cstdint>

#include "attention_bwd_wgmma.cuh"
#include "attention_wgmma.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e9f;   // bias of an invalid key
constexpr float kInitM = -1e30f;   // running max before the first tile
constexpr int kSmemLimit = 232448;
enum Mode { kFwd = 0, kDq = 1, kDkv = 2 };

// BR rows per cluster, BC columns per step; F1 / F2: accumulator
// fragments (16×8) per warp for the d slice / the dv slice.
template <int MODE, typename T> struct Tiles;
template <> struct Tiles<kFwd, bf16> {
  static constexpr int BR = 64, BC = 64, F1 = 0, F2 = 24;
};
template <> struct Tiles<kFwd, float> {
  static constexpr int BR = 64, BC = 32, F1 = 0, F2 = 24;
};
template <> struct Tiles<kDq, bf16> {
  static constexpr int BR = 64, BC = 32, F1 = 16, F2 = 0;
};
template <> struct Tiles<kDq, float> {
  static constexpr int BR = 32, BC = 32, F1 = 16, F2 = 0;
};
template <> struct Tiles<kDkv, bf16> {
  static constexpr int BR = 32, BC = 64, F1 = 8, F2 = 12;
};
template <> struct Tiles<kDkv, float> {
  static constexpr int BR = 32, BC = 32, F1 = 8, F2 = 12;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared-memory layout of one block, in bytes (host and device agree):
// r1/r2 the row tile's d / dv slices, c1/c2 the column tile's, part the
// double-buffered float partials, own this block's published weight rows
// (double-buffered) and rescale factors, loc the gathered weights, vec
// the owner's running statistics and the gathered row factors.
struct Smem {
  int ld1, ld2, ldp, ldw, own;
  size_t r1, r2, c1, c2, part, own_w, own_a, loc, vec, total;
};

__host__ __device__ inline Smem smem_layout(int mode, int br, int bc,
                                            int tsize, int dsl, int dvsl,
                                            int cl) {
  Smem s;
  s.ld1 = dsl + 8;
  s.ld2 = dvsl + 8;
  s.ldp = bc + 4;
  s.ldw = bc + 8;
  s.own = br / cl;
  const int n_part = mode == kFwd ? 1 : 2;
  const int n_w = mode == kDkv ? 2 : 1;
  size_t at = 0;
  s.r1 = at;  at = align16(at + static_cast<size_t>(br) * s.ld1 * tsize);
  s.r2 = at;
  if (mode != kFwd) at = align16(at + static_cast<size_t>(br) * s.ld2 * tsize);
  s.c1 = at;  at = align16(at + static_cast<size_t>(bc) * s.ld1 * tsize);
  s.c2 = at;  at = align16(at + static_cast<size_t>(bc) * s.ld2 * tsize);
  s.part = at;
  at = align16(at + static_cast<size_t>(2) * n_part * br * s.ldp * 4);
  s.own_w = at;
  at = align16(at + static_cast<size_t>(2) * n_w * s.own * s.ldw * tsize);
  s.own_a = at;  at = align16(at + static_cast<size_t>(4) * s.own * 4);
  s.loc = at;
  at = align16(at + static_cast<size_t>(n_w) * br * s.ldw * tsize);
  s.vec = at;    at = align16(at + static_cast<size_t>(br) * 4);
  s.total = at;
  return s;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;
  const void* dout;        // backward: dO
  const float* lse;        // backward: the forward's lse
  const float* delta;      // backward: rowsum(dO∘out)
  void* out0;              // forward: out; dQ: dq; dK/dV: dk
  void* out1;              // dK/dV: dv
  float* lse_out;          // forward: lse, or null
  int B, Lq, Lk, d, dv;
  float scale;
};

// ---- tile products on 16×8 fragments ----------------------------------
// c (row g / g+8, columns 2t, 2t+1 of the fragment; g = lane/4, t = lane%4)
// += A (16 rows × 16, row-major, lda) · B (16 × 8): NT reads B[k][n] at
// Bm[n·ldb + k], NN at Bm[k·ldb + n].

template <bool NN, typename T>
__device__ __forceinline__ void fma_tile(float c[4], const T* A, int lda,
                                         const T* Bm, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float a_lo = gi::to_float(A[g * lda + kk]);
    const float a_hi = gi::to_float(A[(g + 8) * lda + kk]);
    const float b0 = gi::to_float(NN ? Bm[kk * ldb + 2 * t]
                                     : Bm[(2 * t) * ldb + kk]);
    const float b1 = gi::to_float(NN ? Bm[kk * ldb + 2 * t + 1]
                                     : Bm[(2 * t + 1) * ldb + kk]);
    c[0] = fmaf(a_lo, b0, c[0]);
    c[1] = fmaf(a_lo, b1, c[1]);
    c[2] = fmaf(a_hi, b0, c[2]);
    c[3] = fmaf(a_hi, b1, c[3]);
  }
}

// acc[i] (fragment row tile mt, column tile nt0 + step·i, i < NF, nt < nt_max)
// += A[mt·16.., 0..kdim) · B[.., nt·8..]; A row-major (lda), B as NN.
template <typename T, bool NN, int NF>
__device__ __forceinline__ void product(float (&acc)[NF][4], const T* A, int lda,
                                        const T* Bm, int ldb, int kdim,
                                        int mt, int nt0, int step,
                                        int nt_max, int lane) {
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    const T* a_ptr = A + mt * 16 * lda + k0;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int nt = nt0 + step * i;
      if (nt < nt_max)
        fma_tile<NN>(acc[i], a_ptr,
                     lda, NN ? Bm + k0 * ldb + nt * 8
                             : Bm + nt * 8 * ldb + k0, ldb, lane);
    }
  }
}

// ---- staging ------------------------------------------------------------
// dst[r][c] (r < rows, c < width, row stride ld) = src[row0 + r][col0 + c]
// of a (n_rows, D) matrix, 0 outside it. 16-byte cp.async copies where a
// chunk lies inside a row (zero-filled past n_rows), elementwise where it
// straddles D or the source is not 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int row0,
                                      int rows, int n_rows, int col0,
                                      int width, int D) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (D % V == 0)
                   && (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  const int chunks = width / V;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * V;
    const int gr = row0 + r, gc = col0 + c;
    T* s = dst + r * ld + c;
    if (vec && (gc + V <= D || gc >= D || gr >= n_rows)) {
      const bool in = gr < n_rows && gc < D;
      const T* g = in ? src + static_cast<size_t>(gr) * D + gc : src;
      const unsigned sa =
          static_cast<unsigned>(__cvta_generic_to_shared(s));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(sa), "l"(g), "r"(in ? 16 : 0));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        s[e] = (gr < n_rows && gc + e < D)
                   ? src[static_cast<size_t>(gr) * D + gc + e]
                   : gi::from_float<T>(0.f);
    }
  }
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the rank's 16-wide chunks of a width-n dimension: [lo, lo + w)
__device__ __forceinline__ void slice_of(int n, int rank, int cl, int& lo,
                                         int& w) {
  const int nch = (n + 15) / 16;
  const int a = rank * nch / cl, b = (rank + 1) * nch / cl;
  lo = a * 16;
  w = (b - a) * 16;
}

// accumulator fragments → rows of a (B, n_rows, width) T tensor: this
// block's columns [lo, lo + w), rows and columns in range only
template <typename T, int NF, int WPR>
__device__ __forceinline__ void store_rows(const float (&acc)[NF][4],
                                           void* dst_v, int b, int n_rows,
                                           int width, int row0, int mt,
                                           int nt0, int lo, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  T* dst = static_cast<T*>(dst_v) + static_cast<size_t>(b) * n_rows * width;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int nt = nt0 + WPR * i;
    if (nt >= w / 8) continue;
    const int col = lo + nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = row0 + mt * 16 + g + 8 * h;
      if (grow >= n_rows) continue;
      T* o = dst + static_cast<size_t>(grow) * width;
      if (col < width) o[col] = gi::from_float<T>(acc[i][2 * h]);
      if (col + 1 < width) o[col + 1] = gi::from_float<T>(acc[i][2 * h + 1]);
    }
  }
}

// ---- the kernel -----------------------------------------------------------
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
patch_attention_kernel(Args a) {
  using Tl = Tiles<MODE, T>;
  constexpr int BR = Tl::BR, BC = Tl::BC;
  constexpr int RT = BR / 16;              // fragment row tiles
  constexpr int WPR = kWarps / RT;         // warps per row tile
  constexpr int NPF = (BC / 8) / WPR;      // partial fragments per warp
  constexpr int F1 = Tl::F1 > 0 ? Tl::F1 : 1;
  constexpr int F2 = Tl::F2 > 0 ? Tl::F2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % RT, nt0 = warp / RT;

  const int b = blockIdx.y;
  const int row0 = (blockIdx.x / cl) * BR;
  const int d = a.d, dv = a.dv;
  const int n_rows = MODE == kDkv ? a.Lk : a.Lq;
  const int n_cols = MODE == kDkv ? a.Lq : a.Lk;
  int lo1, w1, lo2, w2;
  slice_of(d, rank, cl, lo1, w1);
  slice_of(dv, rank, cl, lo2, w2);
  const int dsl = (((d + 15) / 16 + cl - 1) / cl) * 16;
  const int dvsl = (((dv + 15) / 16 + cl - 1) / cl) * 16;
  const Smem L = smem_layout(MODE, BR, BC, sizeof(T), dsl, dvsl, cl);
  T* R1 = reinterpret_cast<T*>(smem + L.r1);
  T* R2 = reinterpret_cast<T*>(smem + L.r2);
  T* C1 = reinterpret_cast<T*>(smem + L.c1);
  T* C2 = reinterpret_cast<T*>(smem + L.c2);
  float* part = reinterpret_cast<float*>(smem + L.part);
  T* own_w = reinterpret_cast<T*>(smem + L.own_w);
  float* own_a = reinterpret_cast<float*>(smem + L.own_a);  // [2][own] alpha,
  float* own_m = own_a + 2 * L.own;                         // running max,
  float* own_l = own_m + L.own;          // and sum (the forward's)
  T* loc = reinterpret_cast<T*>(smem + L.loc);
  float* row_f = reinterpret_cast<float*>(smem + L.vec);    // [BR]
  constexpr int n_part = MODE == kFwd ? 1 : 2;
  constexpr int n_w = MODE == kDkv ? 2 : 1;
  const int own = L.own;
  const size_t part_buf = static_cast<size_t>(n_part) * BR * L.ldp;
  const size_t own_buf = static_cast<size_t>(n_w) * own * L.ldw;

  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(b) * a.Lq * d;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.Lk * d;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.Lk * dv;
  const T* dout = MODE == kFwd ? nullptr
      : static_cast<const T*>(a.dout) + static_cast<size_t>(b) * a.Lq * dv;
  const unsigned char* valid = a.valid + static_cast<size_t>(b) * a.Lk;
  const float* lse = MODE == kFwd ? nullptr : a.lse + static_cast<size_t>(b) * a.Lq;
  const float* delta = MODE == kFwd ? nullptr
                                    : a.delta + static_cast<size_t>(b) * a.Lq;
  const T* rsrc1 = MODE == kDkv ? k : q;
  const T* rsrc2 = MODE == kDkv ? v : dout;
  const T* csrc1 = MODE == kDkv ? q : k;
  const T* csrc2 = MODE == kDkv ? dout : v;

  stage(R1, L.ld1, rsrc1, row0, BR, n_rows, lo1, w1, d);
  if constexpr (MODE != kFwd) stage(R2, L.ld2, rsrc2, row0, BR, n_rows, lo2, w2, dv);
  // the forward's first key tile comes with the row tile; later ones are
  // issued as soon as the previous tile's scores are formed
  if constexpr (MODE == kFwd) stage(C1, L.ld1, csrc1, 0, BC, n_cols, lo1, w1, d);
  stage_commit();
  if constexpr (MODE == kFwd) {
    for (int i = threadIdx.x; i < own; i += kThreads) {
      own_m[i] = kInitM;
      own_l[i] = 0.f;
    }
  }
  float acc1[F1][4], acc2[F2][4];
#pragma unroll
  for (int i = 0; i < F1; ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < F2; ++i) acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;

  const int n_tiles = (n_cols + BC - 1) / BC;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    const int col0 = tile * BC;
    __syncthreads();   // the last step's products are done with C1, C2, loc
    if constexpr (MODE == kFwd) {
      // V tile in flight through the scores, barriers and softmax; the
      // key tile (issued one step earlier) must have landed
      stage(C2, L.ld2, csrc2, col0, BC, n_cols, lo2, w2, dv);
      stage_commit();
      stage_wait<1>();
    } else {
      stage(C1, L.ld1, csrc1, col0, BC, n_cols, lo1, w1, d);
      stage(C2, L.ld2, csrc2, col0, BC, n_cols, lo2, w2, dv);
      stage_commit();
      stage_wait<0>();
    }
    __syncthreads();

    // ---- 1. partial scores (and dp) of this block's slices ---------------
    {
      float ps[NPF][4];
#pragma unroll
      for (int i = 0; i < NPF; ++i) ps[i][0] = ps[i][1] = ps[i][2] = ps[i][3] = 0.f;
      product<T, false, NPF>(ps, R1, L.ld1, C1, L.ld1, w1, mt, nt0,
                                   WPR, BC / 8, lane);
      float* dst = part + buf * part_buf;
#pragma unroll
      for (int i = 0; i < NPF; ++i) {
        float* p = dst + (mt * 16 + g) * L.ldp + (nt0 + WPR * i) * 8 + 2 * t;
        p[0] = ps[i][0];
        p[1] = ps[i][1];
        p[8 * L.ldp] = ps[i][2];
        p[8 * L.ldp + 1] = ps[i][3];
      }
      if constexpr (MODE != kFwd) {
#pragma unroll
        for (int i = 0; i < NPF; ++i) ps[i][0] = ps[i][1] = ps[i][2] = ps[i][3] = 0.f;
        product<T, false, NPF>(ps, R2, L.ld2, C2, L.ld2, w2, mt, nt0,
                                     WPR, BC / 8, lane);
        dst += BR * L.ldp;
#pragma unroll
        for (int i = 0; i < NPF; ++i) {
          float* p = dst + (mt * 16 + g) * L.ldp + (nt0 + WPR * i) * 8 + 2 * t;
          p[0] = ps[i][0];
          p[1] = ps[i][1];
          p[8 * L.ldp] = ps[i][2];
          p[8 * L.ldp + 1] = ps[i][3];
        }
      }
    }
    cluster.sync();
    const bool next_k = MODE == kFwd && tile + 1 < n_tiles;
    if (next_k) {   // every warp of the block is done with this key tile
      stage(C1, L.ld1, csrc1, col0 + BC, BC, n_cols, lo1, w1, d);
      stage_commit();
    }

    // ---- 2. the owned rows: sum the partials, weights ---------------------
    for (int rl = warp; rl < own; rl += kWarps) {
      const int row = rank * own + rl;          // row within the tile
      const int grow = row0 + row;              // global row index
      T* w_row = own_w + buf * own_buf + rl * L.ldw;
      float m_new = 0.f, alpha = 0.f, psum = 0.f;
      if constexpr (MODE == kFwd) {
        float smax = -CUDART_INF_F;
        float sv[BC / 32];
#pragma unroll
        for (int jj = 0; jj < BC / 32; ++jj) {
          const int j = lane + 32 * jj, key = col0 + j;
          float parts[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            parts[r] = r < cl ? cluster.map_shared_rank(part, r)[
                buf * part_buf + row * L.ldp + j] : 0.f;
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) acc += parts[r];
          const bool ok = key < a.Lk && valid[key];
          sv[jj] = key < a.Lk ? acc * a.scale + (ok ? 0.f : kNegInf) : kNegInf;
          smax = fmaxf(smax, sv[jj]);
        }
        smax = gi::warp_max(smax);
        const float m_old = own_m[rl];
        m_new = fmaxf(m_old, smax);
        alpha = expf(m_old - m_new);
#pragma unroll
        for (int jj = 0; jj < BC / 32; ++jj) {
          const int j = lane + 32 * jj, key = col0 + j;
          const bool ok = key < a.Lk && valid[key];
          const float p = ok ? expf(sv[jj] - m_new) : 0.f;
          psum += p;
          w_row[j] = gi::from_float<T>(p);
        }
        psum = gi::warp_sum(psum);
        if (lane == 0) {
          own_m[rl] = m_new;
          own_l[rl] = own_l[rl] * alpha + psum;
          own_a[buf * own + rl] = alpha;
        }
      } else {
        // rows are queries (dQ) or keys (dK/dV); p rebuilt from lse
        const bool row_q = MODE == kDq;
#pragma unroll
        for (int jj = 0; jj < BC / 32; ++jj) {
          const int j = lane + 32 * jj, gcol = col0 + j;
          float ps_[8], pd_[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float* pr = cluster.map_shared_rank(part, r < cl ? r : 0)
                              + buf * part_buf + row * L.ldp + j;
            ps_[r] = r < cl ? pr[0] : 0.f;
            pd_[r] = r < cl ? pr[BR * L.ldp] : 0.f;
          }
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            s += ps_[r];
            dp += pd_[r];
          }
          const int key = row_q ? gcol : grow;
          const int qry = row_q ? grow : gcol;
          const bool in = key < a.Lk && qry < a.Lq;
          const bool ok = in && valid[key];
          const float l_q = in ? lse[qry] : 0.f;
          const float dl_q = in ? delta[qry] : 0.f;
          const float sc = s * a.scale + (ok ? 0.f : kNegInf);
          const float p = ok ? expf(sc - l_q) : 0.f;
          const float ds = p * (dp - dl_q) * a.scale;
          if constexpr (MODE == kDq) {
            w_row[j] = gi::from_float<T>(ds);
          } else {
            w_row[j] = gi::from_float<T>(p);
            w_row[own * L.ldw + j] = gi::from_float<T>(ds);
          }
        }
      }
    }
    cluster.sync();

    // ---- 3. gather the weights, accumulate -------------------------------
    {
      constexpr int V = 16 / sizeof(T);
      const int chunks = BC / V;
      for (int i = threadIdx.x; i < n_w * BR * chunks; i += kThreads) {
        const int wi = i / (BR * chunks);
        const int rem = i - wi * BR * chunks;
        const int row = rem / chunks, c = (rem - (rem / chunks) * chunks) * V;
        const int r = row / own, rl = row - r * own;
        const T* src = cluster.map_shared_rank(own_w, r) + buf * own_buf
                       + (wi * own + rl) * L.ldw + c;
        *reinterpret_cast<uint4*>(loc + (wi * BR + row) * L.ldw + c) =
            *reinterpret_cast<const uint4*>(src);
      }
      if constexpr (MODE == kFwd) {
        for (int row = threadIdx.x; row < BR; row += kThreads)
          row_f[row] = cluster.map_shared_rank(own_a, row / own)[
              buf * own + row % own];
      }
    }
    if constexpr (MODE == kFwd) {
      if (next_k) stage_wait<1>();   // this step's V tile has landed
      else stage_wait<0>();
    }
    __syncthreads();
    if constexpr (MODE == kFwd) {
      const float a_lo = row_f[mt * 16 + g], a_hi = row_f[mt * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < F2; ++i) {
        acc2[i][0] *= a_lo;
        acc2[i][1] *= a_lo;
        acc2[i][2] *= a_hi;
        acc2[i][3] *= a_hi;
      }
      product<T, true, F2>(acc2, loc, L.ldw, C2, L.ld2, BC, mt, nt0,
                                 WPR, w2 / 8, lane);
    } else if constexpr (MODE == kDq) {
      product<T, true, F1>(acc1, loc, L.ldw, C1, L.ld1, BC, mt, nt0,
                                 WPR, w1 / 8, lane);
    } else {
      product<T, true, F2>(acc2, loc, L.ldw, C2, L.ld2, BC, mt, nt0,
                                 WPR, w2 / 8, lane);
      product<T, true, F1>(acc1, loc + BR * L.ldw, L.ldw, C1, L.ld1,
                                 BC, mt, nt0, WPR, w1 / 8, lane);
    }
  }

  // ---- epilogue ------------------------------------------------------------
  if constexpr (MODE == kFwd) {
    float* own_inv = own_a;          // the alpha buffers are free now
    cluster.sync();                  // every block has read them
    for (int rl = threadIdx.x; rl < own; rl += kThreads) {
      const float l = own_l[rl];
      own_inv[rl] = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
      const int grow = row0 + rank * own + rl;
      if (a.lse_out != nullptr && grow < a.Lq)
        a.lse_out[static_cast<size_t>(b) * a.Lq + grow] =
            l > 0.f ? own_m[rl] + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
    cluster.sync();
    for (int row = threadIdx.x; row < BR; row += kThreads)
      row_f[row] = cluster.map_shared_rank(own_inv, row / own)[row % own];
    __syncthreads();
    const float i_lo = row_f[mt * 16 + g], i_hi = row_f[mt * 16 + g + 8];
#pragma unroll
    for (int i = 0; i < F2; ++i) {
      acc2[i][0] *= i_lo;
      acc2[i][1] *= i_lo;
      acc2[i][2] *= i_hi;
      acc2[i][3] *= i_hi;
    }
  }
  // store: acc1 → out0 (dq, dk), acc2 → out0 (forward out) or out1 (dv)
  if constexpr (MODE == kFwd)
    store_rows<T, F2, WPR>(acc2, a.out0, b, n_rows, dv, row0, mt, nt0, lo2,
                           w2, lane);
  if constexpr (MODE == kDq)
    store_rows<T, F1, WPR>(acc1, a.out0, b, n_rows, d, row0, mt, nt0, lo1,
                           w1, lane);
  if constexpr (MODE == kDkv) {
    store_rows<T, F1, WPR>(acc1, a.out0, b, n_rows, d, row0, mt, nt0, lo1,
                           w1, lane);
    store_rows<T, F2, WPR>(acc2, a.out1, b, n_rows, dv, row0, mt, nt0, lo2,
                           w2, lane);
  }
  cluster.sync();   // no block exits while another may read its buffers
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T, int MODE>
int launch(const Args& a, int cl, cudaStream_t stream) {
  using Tl = Tiles<MODE, T>;
  constexpr int RT = Tl::BR / 16, WPR = kWarps / RT;
  if (cl != 1 && cl != 2 && cl != 4 && cl != 8) return cudaErrorInvalidValue;
  const int dsl = (((a.d + 15) / 16 + cl - 1) / cl) * 16;
  const int dvsl = (((a.dv + 15) / 16 + cl - 1) / cl) * 16;
  if (MODE != kFwd && (dsl / 8 + WPR - 1) / WPR > Tl::F1)
    return cudaErrorInvalidValue;
  if (MODE != kDq && (dvsl / 8 + WPR - 1) / WPR > Tl::F2)
    return cudaErrorInvalidValue;
  const Smem L = smem_layout(MODE, Tl::BR, Tl::BC, sizeof(T), dsl, dvsl, cl);
  if (L.total > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kernel = patch_attention_kernel<T, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const int rows = MODE == kDkv ? a.Lk : a.Lq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((rows + Tl::BR - 1) / Tl::BR) * cl,
                     a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const Args& a, int is_bf16, int cl, void* stream) {
  if (a.B < 1 || a.Lq < 1 || a.Lk < 1 || a.d < 1 || a.dv < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16, MODE>(a, cl, s);
  return launch<float, MODE>(a, cl, s);
}

}  // namespace

// The CUDA-core kernels. Each returns a cudaError_t (0 on success);
// cluster = blocks per cluster (1, 2, 4 or 8). lse may be null in the
// forward (no log-sum-exp written).
extern "C" int gi_patch_attention_fwd(const void* q, const void* k,
                                      const unsigned char* valid,
                                      const void* v, void* out, float* lse,
                                      int B, int Lq, int Lk, int d, int dv,
                                      float scale, int is_bf16, int cluster,
                                      void* stream) {
  Args a = {q, k, v, valid, nullptr, nullptr, nullptr, out, nullptr, lse,
            B, Lq, Lk, d, dv, scale};
  return dispatch<kFwd>(a, is_bf16, cluster, stream);
}

extern "C" int gi_patch_attention_dq(const void* q, const void* k,
                                     const unsigned char* valid,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int Lq, int Lk, int d,
                                     int dv, float scale, int is_bf16,
                                     int cluster, void* stream) {
  Args a = {q, k, v, valid, dout, lse, delta, dq, nullptr, nullptr,
            B, Lq, Lk, d, dv, scale};
  return dispatch<kDq>(a, is_bf16, cluster, stream);
}

extern "C" int gi_patch_attention_dkv(const void* q, const void* k,
                                      const unsigned char* valid,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv_out, int B, int Lq,
                                      int Lk, int d, int dv, float scale,
                                      int is_bf16, int cluster, void* stream) {
  Args a = {q, k, v, valid, dout, lse, delta, dk, dv_out, nullptr,
            B, Lq, Lk, d, dv, scale};
  return dispatch<kDkv>(a, is_bf16, cluster, stream);
}

namespace {

// A (B, rows, width) bf16 matrix as a 3-D tensor map of boxes 64 wide and
// box_rows tall, 128-byte swizzled; rows past the end read as zeros.
int map3(CUtensorMap* tm, const void* ptr, int width, int rows, int batch,
         int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(rows) * width * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return gi::attn::encode_map(tm, ptr, 3, dims, strides, box);
}

// The dQ (which 0) or dK/dV (which 1) wgmma kernel: maps of the resident
// rows (boxes of 64) and of the streamed columns (boxes of 128); with
// max_clusters set, only the card's count of co-resident clusters; with
// clocks set, the instance that counts its phases' cycles there.
int bwd_wgmma(int which, const void* q, const void* k,
              const unsigned char* valid, const void* v, const void* dout,
              const float* lse, const float* delta, void* out0, void* out1,
              int B, int Lq, int Lk, int d, int dv, float scale, int cluster,
              unsigned long long* clocks, void* stream, int* max_clusters) {
  namespace ab = gi::attn_bwd;
  if (B < 1 || Lq < 1 || Lk < 1 || d < 8 || dv < 8 || d % 8 != 0 ||
      dv % 8 != 0)
    return cudaErrorInvalidValue;
  const bool dq = which == ab::kDq;
  const int rows = dq ? Lq : Lk, cols = dq ? Lk : Lq;
  CUtensorMap r1{}, r2{}, c1{}, c2{};
  if (max_clusters == nullptr) {      // the occupancy query needs no maps
    int err = map3(&r1, dq ? q : k, d, rows, B, ab::kBR);
    if (!err) err = map3(&r2, dq ? dout : v, dv, rows, B, ab::kBR);
    if (!err) err = map3(&c1, dq ? k : q, d, cols, B, ab::kBC);
    if (!err) err = map3(&c2, dq ? v : dout, dv, cols, B, ab::kBC);
    if (err) return err;
  }
  ab::Params p{};
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.dv = dv;
  p.n1 = (d + 63) / 64;
  p.n2 = (dv + 63) / 64;
  p.scale = scale;
  p.valid = valid;
  p.lse = lse;
  p.delta = delta;
  p.out0 = static_cast<__nv_bfloat16*>(out0);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.clocks = clocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clocks != nullptr)
    return dq ? ab::launch_clocked<ab::kDq>(r1, r2, c1, c2, p, cluster, s)
              : ab::launch_clocked<ab::kDkv>(r1, r2, c1, c2, p, cluster, s);
  return dq ? ab::launch<ab::kDq>(r1, r2, c1, c2, p, cluster, s, max_clusters)
            : ab::launch<ab::kDkv>(r1, r2, c1, c2, p, cluster, s,
                                   max_clusters);
}

}  // namespace

// The bf16 dQ and dK/dV on wgmma fed by TMA (attention_bwd_wgmma.cuh): d
// and dv multiples of 8; cluster 1, 2, 4, 8 or 16 blocks, enough that each
// holds ≤ 6 accumulated units and its slices, ring and partials fit shared
// memory (ops/kernels/patch_attention.py plan). Return a cudaError_t.
extern "C" int gi_patch_attention_dq_wgmma(
    const void* q, const void* k, const unsigned char* valid, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, int B,
    int Lq, int Lk, int d, int dv, float scale, int cluster, void* stream) {
  return bwd_wgmma(gi::attn_bwd::kDq, q, k, valid, v, dout, lse, delta, dq,
                   nullptr, B, Lq, Lk, d, dv, scale, cluster, nullptr, stream,
                   nullptr);
}

extern "C" int gi_patch_attention_dkv_wgmma(
    const void* q, const void* k, const unsigned char* valid, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv_out, int B, int Lq, int Lk, int d, int dv, float scale,
    int cluster, void* stream) {
  return bwd_wgmma(gi::attn_bwd::kDkv, q, k, valid, v, dout, lse, delta, dk,
                   dv_out, B, Lq, Lk, d, dv, scale, cluster, nullptr, stream,
                   nullptr);
}

// For profiling: the dQ (which 0, dv_out null) or dK/dV (which 1) kernel's
// instance that adds its blocks' cycles per phase and their steps into 8
// zeroed counters (Params.clocks); cluster 2 or 16. Returns a cudaError_t.
extern "C" int gi_patch_attention_bwd_wgmma_clocked(
    int which, const void* q, const void* k, const unsigned char* valid,
    const void* v, const void* dout, const float* lse, const float* delta,
    void* out0, void* out1, int B, int Lq, int Lk, int d, int dv,
    float scale, int cluster, unsigned long long* clocks, void* stream) {
  if (clocks == nullptr) return cudaErrorInvalidValue;
  return bwd_wgmma(which, q, k, valid, v, dout, lse, delta, out0, out1, B,
                   Lq, Lk, d, dv, scale, cluster, clocks, stream, nullptr);
}

// How many clusters of the dQ (which 0) or dK/dV (which 1) wgmma kernel at
// widths d, dv the card holds at once (cudaOccupancyMaxActiveClusters),
// into *out; 0 means the launch cannot run. Returns a cudaError_t.
extern "C" int gi_patch_attention_bwd_wgmma_clusters(int which, int d, int dv,
                                                     int cluster, int* out) {
  *out = 0;
  return bwd_wgmma(which, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, 1, 64, 64, d, dv, 1.f,
                   cluster, nullptr, nullptr, out);
}

// The bf16 forward on wgmma fed by TMA (attention_wgmma.cuh, kPatch): d
// and dv multiples of 8 (16-byte rows for the tensor maps); cluster 1, 2,
// 4 or 8 blocks, enough that each holds ≤ 4 of the ⌈d/64⌉ d units and ≤ 6
// of the ⌈dv/64⌉ dv units. lse may be null. Returns a cudaError_t.
extern "C" int gi_patch_attention_fwd_wgmma(const void* q, const void* k,
                                            const unsigned char* valid,
                                            const void* v, void* out,
                                            float* lse, int B, int Lq, int Lk,
                                            int d, int dv, float scale,
                                            int cluster, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || d < 8 || dv < 8 || d % 8 != 0 ||
      dv % 8 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tq{}, tk{}, tv{};
  int err = map3(&tq, q, d, Lq, B, gi::attn::kBR);
  if (err == cudaSuccess) err = map3(&tk, k, d, Lk, B, gi::attn::kBC);
  if (err == cudaSuccess) err = map3(&tv, v, dv, Lk, B, gi::attn::kBC);
  if (err != cudaSuccess) return err;
  gi::attn::Params p{};
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.dv = dv;
  p.n1 = (d + 63) / 64;
  p.n2 = (dv + 63) / 64;
  p.ws = 1;
  p.cpt = 1;
  p.rate = 1;
  p.scale = scale;
  p.valid = valid;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  return gi::attn::launch<gi::attn::kPatch>(tq, tk, tv, p, cluster,
                                            static_cast<cudaStream_t>(stream));
}
