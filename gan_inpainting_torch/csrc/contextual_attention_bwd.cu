// Fused contextual attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _bwd_dq_kernel and _bwd_dkv_kernel of
// gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py. Like the forward
// (contextual_attention.cu) every tile is rebuilt from the halo-padded
// sub-pixel parity maps, so neither patch tensors nor an (Lq, Lk) matrix
// reach device memory. The upstream gradient arrives the same way: gmaps
// holds g / overlap-count laid out as parity maps, so the `do` tap of a
// query is read exactly like the V tap of a key.
//
// Inputs (contiguous; T = float or __nv_bfloat16):
//   maps, gmaps (B, r, r, hs+2, ws+2, C) T — feature and gradient maps
//   bias, rnorm (B, L) float — as in the forward; L = hs·ws = Lq = Lk
//   lse (B, L) float — per-query log-sum-exp saved by the forward
//   o_taps (B, 4r², L, C) T — the forward's tap-major output (dQ only)
// With u_ij = Σ_9taps q_i·k_j, s = u·rnorm_j·scale + bias_j:
//   p_ij  = exp(s_ij − lse_i) on valid keys, exactly 0 on hole keys (a
//           select, not a product: s − lse is noise where every key is a
//           hole)
//   δ_i   = Σ_taps do_i·o_i           dp_ij = Σ_4r²taps do_i·v_j
//   ds_ij = p_ij·(dp_ij − δ_i)        dsr_ij = ds_ij·rnorm_j·scale
// The dQ kernel emits δ (B, L) and the 9 query-tap gradients
//   dq_t[i] = Σ_j dsr_ij·k_j,t          → qk_taps (B, 9, L, C) float;
// the dK/dV kernel reads δ and emits
//   dk_t[j] = Σ_i dsr_ij·q_i,t          → qk_taps (B, 9, L, C) float
//   dv_tap[j] = Σ_i p_ij·do_i,tap (p rounded to T) → dv_taps (B, 4r², L, C)
//   t_j = Σ_i ds_ij·u_ij, the scalar of the key-norm correction → (B, L).
// The per-tap gradients are folded onto the padded maps by the wrapper in
// a fixed order, so the result does not change from run to run (no
// atomics on device memory).
//
// The TPU kernels carry their sums in scratch across a sequential grid
// axis. Here one block owns G rows — query cells for dQ, key cells for
// dK/dV — and loops over every column (all keys, or all queries) itself:
//   1. u and dp of its G rows against all L columns;
//   2. p and dsr, kept in shared memory as G rows of L (dK/dV keeps both);
//   3. the tap products of those rows with the tap tiles of all columns,
//      one (tap, channel group) at a time with the sums in registers, so
//      no 9- or 25-tap accumulator has to fit anywhere.
// The two kernels differ only in which side the rows are, so each variant
// is one template with a flag. Two variants, as in the forward:
//   * mma (bf16; C % 64 == 0, ws % 32 == 0, L % 128 == 0): WMMA m8n32k16
//     tiles, operands loaded straight from the maps, dsr rounded to bf16
//     for step 3. Where G = 32 rows of L columns do not fit one block (the
//     512² map), a thread block cluster splits the columns: each block
//     computes p and dsr of its share (no statistics to combine: lse is an
//     input), and in step 3 the (tap, channel group) jobs are dealt over
//     the cluster's blocks, each reading every block's rows through
//     distributed shared memory, so K, V and `do` fragments fetched from
//     L2 still feed 32 rows;
//   * core (any shape, float32 or bf16): CUDA-core FMAs, float32 u, dp,
//     p·, dsr in shared memory.
// Bound on this card: 2·L²·C·(9 + 4r² + 9) operations per image for dQ and
// 2·L²·C·(9 + 2·4r² + 9) for dK/dV against tens of MB of maps and tap
// buffers: bounded by operations.
#include <cooperative_groups.h>
#include <math_constants.h>
#include <mma.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using bf16 = __nv_bfloat16;

// value/gradient tap `tap` of the 2r×2r window: parity map and cell offset
struct TapGeo {
  int par, off_p, off_q;
};
__device__ __forceinline__ TapGeo tap_geo(int tap, int rate) {
  const int half = rate / 2;
  const int vp = tap / (2 * rate), vq = tap - vp * (2 * rate);
  TapGeo g;
  g.par = ((vp - half + rate) % rate) * rate + (vq - half + rate) % rate;
  g.off_p = (vp - half + rate) / rate;
  g.off_q = (vq - half + rate) / rate;
  return g;
}

// ---------------------------------------------------------------------------
// core variant
// ---------------------------------------------------------------------------
// kDq: rows are query cells (dQ kernel); else rows are key cells (dK/dV).
template <typename T, int G, bool kDq>
__global__ void __launch_bounds__(kThreads)
attention_bwd_core_kernel(const T* __restrict__ maps,
                          const T* __restrict__ gmaps,
                          const float* __restrict__ bias,
                          const float* __restrict__ rnorm,
                          const float* __restrict__ lse,
                          const T* __restrict__ o_taps,
                          float* __restrict__ delta,
                          float* __restrict__ qk_taps,
                          float* __restrict__ dv_taps,
                          float* __restrict__ tnorm, int hs, int ws, int C,
                          int rate, float scale, int lpad) {
  extern __shared__ __align__(16) float smem[];
  float* SU = smem;                 // [G][lpad] u, then p (dK/dV)
  float* SD = SU + G * lpad;        // [G][lpad] dp, then dsr
  float* Rs = SD + G * lpad;        // [G][C] one tap of the block's rows
  float* row_a = Rs + G * C;        // [G] lse_i (dQ) or bias_j (dK/dV)
  float* row_b = row_a + G;         // [G] δ_i (dQ) or rnorm_j·scale
  float* row_t = row_b + G;         // [G] t_j partial sums (dK/dV)

  const int L = hs * ws;
  const int wp = ws + 2;
  const int taps = 4 * rate * rate;
  const size_t map_elems = static_cast<size_t>(hs + 2) * wp * C;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * G;
  const int nr = min(G, L - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* img = maps + static_cast<size_t>(b) * rate * rate * map_elems;
  const T* gimg = gmaps + static_cast<size_t>(b) * rate * rate * map_elems;
  const float* bias_b = bias + static_cast<size_t>(b) * L;
  const float* rnorm_b = rnorm + static_cast<size_t>(b) * L;
  const float* lse_b = lse + static_cast<size_t>(b) * L;
  float* delta_b = delta + static_cast<size_t>(b) * L;

  // ---- 0. per-row scalars; the dQ kernel computes δ of its rows --------
  if (kDq) {
    for (int r = warp; r < G; r += kWarps) {
      float d = 0.f;
      if (r < nr) {
        const int i = r0 + r, y = i / ws, x = i - y * ws;
        for (int tap = 0; tap < taps; ++tap) {
          const TapGeo g = tap_geo(tap, rate);
          const T* dop = gimg + static_cast<size_t>(g.par) * map_elems +
                         (static_cast<size_t>(y + g.off_p) * wp + x +
                          g.off_q) * C;
          const T* op = o_taps +
                        ((static_cast<size_t>(b) * taps + tap) * L + i) * C;
          for (int c = lane; c < C; c += 32)
            d = fmaf(gi::to_float(dop[c]), gi::to_float(op[c]), d);
        }
        d = gi::warp_sum(d);
        if (lane == 0) delta_b[i] = d;
      }
      if (lane == 0) {
        row_a[r] = r < nr ? lse_b[r0 + r] : 0.f;
        row_b[r] = d;
      }
    }
  } else {
    for (int r = tid; r < G; r += kThreads) {
      row_a[r] = r < nr ? bias_b[r0 + r] : -1.f;
      row_b[r] = r < nr ? rnorm_b[r0 + r] * scale : 0.f;
      row_t[r] = 0.f;
    }
  }

  // ---- 1. u (9 Q/K taps) and dp (4r² do/V taps) of G rows × L columns --
  for (int t = 0; t < 9 + taps; ++t) {
    const T* row_src;
    const T* col_src;
    int off_p, off_q;
    if (t < 9) {
      row_src = col_src = img;
      off_p = t / 3;
      off_q = t % 3;
    } else {
      const TapGeo g = tap_geo(t - 9, rate);
      // dQ: rows read `do` taps, columns V taps; dK/dV the other way round
      row_src = (kDq ? gimg : img) + static_cast<size_t>(g.par) * map_elems;
      col_src = (kDq ? img : gimg) + static_cast<size_t>(g.par) * map_elems;
      off_p = g.off_p;
      off_q = g.off_q;
    }
    __syncthreads();  // the previous tap's Rs reads are done
    for (int i = tid; i < G * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      float v = 0.f;
      if (r < nr) {
        const int cell = r0 + r, y = cell / ws, x = cell - y * ws;
        v = gi::to_float(row_src[(static_cast<size_t>(y + off_p) * wp + x +
                                  off_q) * C + c]);
      }
      Rs[i] = v;
    }
    __syncthreads();
    float* dst = t < 9 ? SU : SD;
    const bool first = t == 0 || t == 9;
    for (int k = tid; k < L; k += kThreads) {
      const int ky = k / ws, kx = k - ky * ws;
      const T* cp = col_src + (static_cast<size_t>(ky + off_p) * wp + kx +
                               off_q) * C;
      float acc[G];
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float4 cv = gi::load4(cp + c);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float4 rv = *reinterpret_cast<const float4*>(Rs + r * C + c);
          acc[r] = fmaf(rv.x, cv.x, acc[r]);
          acc[r] = fmaf(rv.y, cv.y, acc[r]);
          acc[r] = fmaf(rv.z, cv.z, acc[r]);
          acc[r] = fmaf(rv.w, cv.w, acc[r]);
        }
      }
      // each thread owns the same columns at every tap: no sync needed
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float* d = dst + r * lpad + k;
        *d = first ? acc[r] : *d + acc[r];
      }
    }
  }

  // ---- 2. p and dsr over the scores, each thread on its own columns ----
  float tn[G];
#pragma unroll
  for (int r = 0; r < G; ++r) tn[r] = 0.f;
  for (int k = tid; k < lpad; k += kThreads) {
    float col_a = 0.f, col_b = 0.f;
    if (k < L) {
      col_a = kDq ? bias_b[k] : lse_b[k];
      col_b = kDq ? rnorm_b[k] * scale : delta_b[k];
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float p = 0.f, dsr = 0.f;
      if (k < L && r < nr) {
        const float bias_j = kDq ? col_a : row_a[r];
        const float rs_j = kDq ? col_b : row_b[r];
        const float lse_i = kDq ? row_a[r] : col_a;
        const float delta_i = kDq ? row_b[r] : col_b;
        const float u = SU[r * lpad + k];
        p = bias_j >= 0.f ? expf(u * rs_j + bias_j - lse_i) : 0.f;
        const float ds = p * (SD[r * lpad + k] - delta_i);
        tn[r] = fmaf(ds, u, tn[r]);
        dsr = ds * rs_j;
      }
      SU[r * lpad + k] = gi::round_to<T>(p);  // the dV product takes p in T
      SD[r * lpad + k] = dsr;
    }
  }
  if (!kDq) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float s = gi::warp_sum(tn[r]);
      if (lane == 0) atomicAdd(row_t + r, s);  // shared memory, 8 warps
    }
  }
  __syncthreads();
  if (!kDq)
    for (int r = tid; r < nr; r += kThreads)
      tnorm[static_cast<size_t>(b) * L + r0 + r] = row_t[r];

  // ---- 3. tap products of the G rows with every column's tap tile ------
  // taps 0..8: dsr · (K taps | Q taps) → qk_taps; then (dK/dV only) the 4r²
  // value taps: p · do taps → dv_taps
  const int n_jobs = kDq ? 9 : 9 + taps;
  for (int pair = tid; pair < n_jobs * C; pair += kThreads) {
    const int t = pair / C, c = pair - t * C;
    const float* A;
    const T* src;
    float* out;
    if (t < 9) {
      A = SD;
      src = img + (static_cast<size_t>(t / 3) * wp + t % 3) * C + c;
      out = qk_taps + ((static_cast<size_t>(b) * 9 + t) * L + r0) * C + c;
    } else {
      const TapGeo g = tap_geo(t - 9, rate);
      A = SU;
      src = gimg + static_cast<size_t>(g.par) * map_elems +
            (static_cast<size_t>(g.off_p) * wp + g.off_q) * C + c;
      out = dv_taps +
            ((static_cast<size_t>(b) * taps + (t - 9)) * L + r0) * C + c;
    }
    float acc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) acc[r] = 0.f;
    int ky = 0, kx = 0;
    for (int k = 0; k < lpad; k += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (k + j < L)
                   ? gi::to_float(src[(static_cast<size_t>(ky) * wp + kx) * C])
                   : 0.f;
        if (++kx == ws) { kx = 0; ++ky; }
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * lpad + k);
        acc[r] = fmaf(a.x, v[0], acc[r]);
        acc[r] = fmaf(a.y, v[1], acc[r]);
        acc[r] = fmaf(a.z, v[2], acc[r]);
        acc[r] = fmaf(a.w, v[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r < nr) out[static_cast<size_t>(r) * C] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// mma variant: bf16 tensor-core tiles
// ---------------------------------------------------------------------------
namespace wmma = nvcuda::wmma;
// 8 rows × 32 columns × 16-deep contraction
using FragRows = wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16,
                                wmma::row_major>;
using FragColsT = wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16,
                                 wmma::col_major>;
using FragTile = wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16,
                                wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 8, 32, 16, float>;

// G = 8·QT rows per cluster of CL blocks (CL = the launch's cluster size).
// Block `rank` holds columns [rank·lb, (rank+1)·lb) of the G rows. Cells of
// a 32-column (or 8-row) tile lie in one map row because ws % 32 == 0.
template <int QT, bool kDq>
__global__ void __launch_bounds__(kThreads)
attention_bwd_mma_kernel(const bf16* __restrict__ maps,
                         const bf16* __restrict__ gmaps,
                         const float* __restrict__ bias,
                         const float* __restrict__ rnorm,
                         const float* __restrict__ lse,
                         const bf16* __restrict__ o_taps,
                         float* __restrict__ delta,
                         float* __restrict__ qk_taps,
                         float* __restrict__ dv_taps,
                         float* __restrict__ tnorm, int hs, int ws, int C,
                         int rate, float scale, int lb) {
  constexpr int G = 8 * QT;
  constexpr int KT = QT >= 4 ? 1 : 4 / QT;  // 32-column tiles per step-1 job
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = hs * ws;
  const int kbase = rank * lb;
  bf16* DS = reinterpret_cast<bf16*>(smem_raw);             // [G][lb] dsr
  bf16* P = DS + (kDq ? 0 : G * lb);                        // [G][lb] (dK/dV)
  float* stage = reinterpret_cast<float*>(P + G * lb);      // [warps][2][8][32]
  float* row_a = stage + kWarps * 2 * 8 * 32;               // [G]
  float* row_b = row_a + G;                                 // [G]
  float* row_t = row_b + G;                                 // [G]

  const int wp = ws + 2;
  const int taps = 4 * rate * rate;
  const size_t map_elems = static_cast<size_t>(hs + 2) * wp * C;
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / cl) * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* img = maps + static_cast<size_t>(b) * rate * rate * map_elems;
  const bf16* gimg = gmaps + static_cast<size_t>(b) * rate * rate * map_elems;
  const float* bias_b = bias + static_cast<size_t>(b) * L;
  const float* rnorm_b = rnorm + static_cast<size_t>(b) * L;
  const float* lse_b = lse + static_cast<size_t>(b) * L;
  float* delta_b = delta + static_cast<size_t>(b) * L;
  // cell i (row-major over hs × ws) shifted by (dy, dx) in a halo map
  auto cell = [&](const bf16* m, int i, int dy, int dx) {
    return m + (static_cast<size_t>(i / ws + dy) * wp + i % ws + dx) * C;
  };

  // ---- 0. per-row scalars; the dQ kernel computes δ of its rows (every
  // block of a cluster for itself, block 0 writes it out) ----------------
  if (kDq) {
    for (int r = warp; r < G; r += kWarps) {
      const int i = r0 + r;
      float d = 0.f;
      for (int tap = 0; tap < taps; ++tap) {
        const TapGeo g = tap_geo(tap, rate);
        const bf16* dop = cell(gimg + static_cast<size_t>(g.par) * map_elems,
                               i, g.off_p, g.off_q);
        const bf16* op = o_taps +
                         ((static_cast<size_t>(b) * taps + tap) * L + i) * C;
        for (int c = lane; c < C; c += 32)
          d = fmaf(__bfloat162float(dop[c]), __bfloat162float(op[c]), d);
      }
      d = gi::warp_sum(d);
      if (lane == 0) {
        if (rank == 0) delta_b[i] = d;
        row_a[r] = lse_b[i];
        row_b[r] = d;
      }
    }
  } else {
    for (int r = tid; r < G; r += kThreads) {
      row_a[r] = bias_b[r0 + r];
      row_b[r] = rnorm_b[r0 + r] * scale;
      row_t[r] = 0.f;
    }
  }
  __syncthreads();

  // ---- 1+2. job = G rows × KT·32 columns: u and dp in fragments, then p
  // and dsr through a per-warp staging tile into shared memory as bf16 ----
  float* st_u = stage + warp * 2 * 8 * 32;
  float* st_d = st_u + 8 * 32;
  const int e_row = lane / 4, e_col = (lane % 4) * 8;
  float tn[QT];
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) tn[qt] = 0.f;
  for (int job = warp; job < lb / (32 * KT); job += kWarps) {
    const int k0 = kbase + job * 32 * KT;
    FragAcc acc_u[QT][KT], acc_d[QT][KT];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        wmma::fill_fragment(acc_u[qt][kt], 0.f);
        wmma::fill_fragment(acc_d[qt][kt], 0.f);
      }
    for (int t = 0; t < 9; ++t) {
      const int dp = t / 3, dq = t % 3;
      for (int c = 0; c < C; c += 16) {
        FragRows rf[QT];
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
          wmma::load_matrix_sync(rf[qt], cell(img, r0 + qt * 8, dp, dq) + c,
                                 C);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          FragColsT cf;
          wmma::load_matrix_sync(cf, cell(img, k0 + kt * 32, dp, dq) + c, C);
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
            wmma::mma_sync(acc_u[qt][kt], rf[qt], cf, acc_u[qt][kt]);
        }
      }
    }
    for (int tap = 0; tap < taps; ++tap) {
      const TapGeo g = tap_geo(tap, rate);
      const bf16* row_src =
          (kDq ? gimg : img) + static_cast<size_t>(g.par) * map_elems;
      const bf16* col_src =
          (kDq ? img : gimg) + static_cast<size_t>(g.par) * map_elems;
      for (int c = 0; c < C; c += 16) {
        FragRows rf[QT];
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
          wmma::load_matrix_sync(
              rf[qt], cell(row_src, r0 + qt * 8, g.off_p, g.off_q) + c, C);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          FragColsT cf;
          wmma::load_matrix_sync(
              cf, cell(col_src, k0 + kt * 32, g.off_p, g.off_q) + c, C);
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
            wmma::mma_sync(acc_d[qt][kt], rf[qt], cf, acc_d[qt][kt]);
        }
      }
    }
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        wmma::store_matrix_sync(st_u, acc_u[qt][kt], 32, wmma::mem_row_major);
        wmma::store_matrix_sync(st_d, acc_d[qt][kt], 32, wmma::mem_row_major);
        __syncwarp();
        const int r = qt * 8 + e_row;
        const int kc = k0 + kt * 32 + e_col;
        __nv_bfloat162 hp[4], hd[4];
        float pe[8], de[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = kc + e;
          const float bias_j = kDq ? bias_b[k] : row_a[r];
          const float rs_j = kDq ? rnorm_b[k] * scale : row_b[r];
          const float lse_i = kDq ? row_a[r] : lse_b[k];
          const float delta_i = kDq ? row_b[r] : delta_b[k];
          const float u = st_u[e_row * 32 + e_col + e];
          const float p =
              bias_j >= 0.f ? expf(u * rs_j + bias_j - lse_i) : 0.f;
          const float ds = p * (st_d[e_row * 32 + e_col + e] - delta_i);
          tn[qt] = fmaf(ds, u, tn[qt]);
          pe[e] = p;
          de[e] = ds * rs_j;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hp[e] = __floats2bfloat162_rn(pe[2 * e], pe[2 * e + 1]);
          hd[e] = __floats2bfloat162_rn(de[2 * e], de[2 * e + 1]);
        }
        const size_t at = static_cast<size_t>(r) * lb + (kc - kbase);
        *reinterpret_cast<uint4*>(DS + at) =
            *reinterpret_cast<const uint4*>(hd);
        if (!kDq)
          *reinterpret_cast<uint4*>(P + at) =
              *reinterpret_cast<const uint4*>(hp);
        __syncwarp();
      }
  }
  if (!kDq) {
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      // the four lanes of a row hold its partial sums
      float s = tn[qt];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (lane % 4 == 0) atomicAdd(row_t + qt * 8 + e_row, s);
    }
  }
  cluster.sync();  // every block's rows and partial t_j are written
  if (!kDq && rank == 0)
    for (int r = tid; r < G; r += kThreads) {
      float s = 0.f;  // the blocks' partial sums, in rank order
      for (int o = 0; o < cl; ++o) s += cluster.map_shared_rank(row_t, o)[r];
      tnorm[static_cast<size_t>(b) * L + r0 + r] = s;
    }

  // ---- 3. job = one tap × 64 channels × all G rows over all L columns,
  // the jobs dealt out over the cluster's blocks ---------------------------
  const int cgroups = C / 64;
  const int n_jobs = (kDq ? 9 : 9 + taps) * cgroups;
  for (int job = rank + cl * warp; job < n_jobs; job += cl * kWarps) {
    const int t = job / cgroups, c0 = (job % cgroups) * 64;
    const bf16* A;
    const bf16* src;
    int off_p, off_q;
    float* out;
    if (t < 9) {
      A = DS;
      src = img + c0;
      off_p = t / 3;
      off_q = t % 3;
      out = qk_taps + ((static_cast<size_t>(b) * 9 + t) * L + r0) * C + c0;
    } else {
      const TapGeo g = tap_geo(t - 9, rate);
      A = P;
      src = gimg + static_cast<size_t>(g.par) * map_elems + c0;
      off_p = g.off_p;
      off_q = g.off_q;
      out = dv_taps +
            ((static_cast<size_t>(b) * taps + (t - 9)) * L + r0) * C + c0;
    }
    FragAcc acc[QT][2];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      wmma::fill_fragment(acc[qt][0], 0.f);
      wmma::fill_fragment(acc[qt][1], 0.f);
    }
    for (int owner = 0; owner < cl; ++owner) {
      const bf16* Ao = cluster.map_shared_rank(A, owner);
      for (int kl = 0; kl < lb; kl += 16) {
        const bf16* v = cell(src, owner * lb + kl, off_p, off_q);
        FragTile v0, v1;
        wmma::load_matrix_sync(v0, v, C);
        wmma::load_matrix_sync(v1, v + 32, C);
#pragma unroll
        for (int qt = 0; qt < QT; ++qt) {
          FragRows af;
          wmma::load_matrix_sync(
              af, Ao + static_cast<size_t>(qt) * 8 * lb + kl, lb);
          wmma::mma_sync(acc[qt][0], af, v0, acc[qt][0]);
          wmma::mma_sync(acc[qt][1], af, v1, acc[qt][1]);
        }
      }
    }
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(out + static_cast<size_t>(qt) * 8 * C + j * 32,
                                acc[qt][j], C, wmma::mem_row_major);
  }
  cluster.sync();  // no block exits while the others may read its rows
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
struct Args {
  const void* maps;
  const void* gmaps;
  const float* bias;
  const float* rnorm;
  const float* lse;
  const void* o_taps;
  float* delta;
  float* qk_taps;
  float* dv_taps;
  float* tnorm;
  int B, hs, ws, C, rate;
  float scale;
  int cluster;
  cudaStream_t stream;
};

template <typename T, int G, bool kDq>
int launch_core(const Args& a) {
  const int L = a.hs * a.ws;
  const int lpad = (L + 3) / 4 * 4;
  const size_t smem =
      (static_cast<size_t>(G) * (2 * lpad + a.C) + 3 * G) * sizeof(float);
  auto kernel = attention_bwd_core_kernel<T, G, kDq>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((L + G - 1) / G, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.maps), static_cast<const T*>(a.gmaps), a.bias,
      a.rnorm, a.lse, static_cast<const T*>(a.o_taps), a.delta, a.qk_taps,
      a.dv_taps, a.tnorm, a.hs, a.ws, a.C, a.rate, a.scale, lpad);
  return cudaGetLastError();
}

template <typename T, bool kDq>
int dispatch_core(int group, const Args& a) {
  switch (group) {
    case 8: return launch_core<T, 8, kDq>(a);
    case 4: return launch_core<T, 4, kDq>(a);
    case 2: return launch_core<T, 2, kDq>(a);
    case 1: return launch_core<T, 1, kDq>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int QT, bool kDq>
int launch_mma(const Args& a) {
  const int L = a.hs * a.ws;
  constexpr int G = 8 * QT;
  const int lb = L / a.cluster;
  const size_t smem =
      static_cast<size_t>(kDq ? 1 : 2) * G * lb * sizeof(bf16) +
      kWarps * 2 * 8 * 32 * sizeof(float) + 3 * G * sizeof(float);
  auto kernel = attention_bwd_mma_kernel<QT, kDq>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L / G * a.cluster, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(a.maps),
      static_cast<const bf16*>(a.gmaps), a.bias, a.rnorm, a.lse,
      static_cast<const bf16*>(a.o_taps), a.delta, a.qk_taps, a.dv_taps,
      a.tnorm, a.hs, a.ws, a.C, a.rate, a.scale, lb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kDq>
int dispatch_mma(int group, const Args& a) {
  switch (group) {
    case 32: return launch_mma<4, kDq>(a);
    case 16: return launch_mma<2, kDq>(a);
    case 8: return launch_mma<1, kDq>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int is_bf16, int variant, int group) {
  if (a.C % 4 != 0 || a.rate < 1 || a.hs < 1 || a.ws < 1 || a.B < 1)
    return cudaErrorInvalidValue;
  if (variant == 1) {
    const int L = a.hs * a.ws;
    if (!is_bf16 || a.C % 64 != 0 || a.ws % 32 != 0 || a.cluster < 1 ||
        a.cluster > 8 || L % (128 * a.cluster) != 0)
      return cudaErrorInvalidValue;
    return dispatch_mma<kDq>(group, a);
  }
  if (a.cluster != 1) return cudaErrorInvalidValue;
  if (is_bf16) return dispatch_core<bf16, kDq>(group, a);
  return dispatch_core<float, kDq>(group, a);
}

}  // namespace

// Both return a cudaError_t (0 on success). variant 0 = core, 1 = mma;
// group = rows (query cells, or key cells) per block (core) or per cluster
// (mma); cluster = blocks per cluster (mma; 1 for core).
extern "C" int gi_attention_bwd_dq(const void* maps, const void* gmaps,
                                   const float* bias, const float* rnorm,
                                   const float* lse, const void* o_taps,
                                   float* delta, float* dq_taps, int B,
                                   int hs, int ws, int C, int rate,
                                   float scale, int is_bf16, int variant,
                                   int group, int cluster, void* stream) {
  const Args a = {maps, gmaps, bias, rnorm, lse, o_taps, delta, dq_taps,
                  nullptr, nullptr, B, hs, ws, C, rate, scale, cluster,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16, variant, group);
}

extern "C" int gi_attention_bwd_dkv(const void* maps, const void* gmaps,
                                    const float* bias, const float* rnorm,
                                    const float* lse, float* delta,
                                    float* dk_taps, float* dv_taps,
                                    float* tnorm, int B, int hs, int ws,
                                    int C, int rate, float scale,
                                    int is_bf16, int variant, int group,
                                    int cluster, void* stream) {
  const Args a = {maps, gmaps, bias, rnorm, lse, nullptr, delta, dk_taps,
                  dv_taps, tnorm, B, hs, ws, C, rate, scale, cluster,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16, variant, group);
}
