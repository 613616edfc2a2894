// Fused contextual attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _fused_kernel_singlek and _fused_kernel of
// gan_inpainting_tpu/ops/pallas/fused_attention.py. Their two regimes exist
// because of the TPU's VMEM budget; here the whole score row of a query
// group sits in shared memory — one block's, or split over the blocks of a
// thread block cluster — so no flash recurrence is needed while the rows
// fit (the wrapper sizes the group from Lk and refuses an Lk it cannot
// hold).
//
// Inputs (contiguous; T = float or __nv_bfloat16):
//   maps  (B, r, r, hs+2, ws+2, C) T — sub-pixel parity maps of the feature
//         map with one zero halo cell each side; map (0,0) is the
//         rate-downscaled map, so Q/K taps are shifted slices of it
//   bias  (B, Lk) float — 0 for a valid key, -1e9 for a key touching a hole
//   rnorm (B, Lk) float — 1 / max(||key patch||, 1e-4)
// Output: out (B, 4r², Lq, C) T, tap-major, Lq = Lk = hs·ws; and, when the
// caller passes a buffer (training does, serving does not), lse (B, Lq)
// float: the per-query log-sum-exp of s over the valid keys, the residual
// the backward kernels (contextual_attention_bwd.cu) rebuild p from. A
// query with no valid key gets lse = 0, so that exp(s − lse) stays 0 there.
//
// One block = one image × a group of G query cells, 256 threads, 3 steps:
//   1. scores S[G][Lk] (float) in shared memory, as 9 shifted
//      C-contractions of the query and key taps;
//   2. s = S·(rnorm·scale) + bias, softmax per row by one warp, p zeroed
//      on hole keys, rows with no valid key left all zero (l > 0 guard);
//      p rounded to T as the TPU kernel rounds it before the PV product;
//   3. the 4r² tap products P·V_tap, V_tap read from the parity map at
//      cell offset (par, off).
// Accumulation is float32 throughout. Two variants of steps 1 and 3:
//   * mma (bf16 only; C % 64 == 0, ws % 32 == 0, Lk % 256 == 0 — the
//     serve shapes): tensor-core WMMA tiles (m8n32k16, mma.sync) whose Q,
//     K and V operands load straight from the maps (one image's maps are
//     a few MB and stay in L2), P from shared memory as bf16. Where G = 32
//     rows of Lk keys do not fit one block (512² and up), a cluster of
//     2–8 blocks splits the keys, so each block still serves 32 queries
//     and the L2 traffic of K and V per query stays that of the 256² map;
//     the blocks combine softmax statistics and read each other's weights
//     through distributed shared memory;
//   * core (any shape, float32 or bf16): CUDA-core FMAs, per tap the
//     group's Q rows staged in shared memory, each thread owning keys in
//     step 1 and (tap, channel) pairs in step 3.
//
// Bound on this card: 2·Lq·Lk·25·C operations per image (10.1 GFLOP at the
// 256² serve shape) against a few MB of maps and output, so it is bounded
// by operations (989 TFLOP/s bf16). Neither variant uses wgmma or TMA yet.
#include <cooperative_groups.h>
#include <math_constants.h>
#include <mma.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Step 2, one warp per query row of S (float scores, rows lk_pad apart):
// s = S·(rnorm·scale) + bias; p = exp(s − max) on valid keys, 0 on hole
// keys; p / Σp, or all 0 when no key is valid. Each p, rounded to T, goes
// to put(row, key, p); rows ≥ nq and keys ≥ L get 0. Where lse_rows is not
// null, row qi's log-sum-exp goes to lse_rows[qi].
template <typename T, typename Put>
__device__ __forceinline__ void softmax_rows(float* S, int lk_pad, int rows,
                                             int nq, int L,
                                             const float* bias_b,
                                             const float* rnorm_b,
                                             float scale, float* lse_rows,
                                             Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = warp; qi < rows; qi += kWarps) {
    float* row = S + qi * lk_pad;
    if (qi >= nq) {
      for (int k = lane; k < lk_pad; k += 32) put(qi, k, 0.f);
      continue;
    }
    float m = -CUDART_INF_F;
    for (int k = lane; k < L; k += 32) {
      const float s = row[k] * (rnorm_b[k] * scale) + bias_b[k];
      row[k] = s;
      m = fmaxf(m, s);
    }
    m = gi::warp_max(m);
    float l = 0.f;
    for (int k = lane; k < L; k += 32) {
      const float p = bias_b[k] >= 0.f ? expf(row[k] - m) : 0.f;
      row[k] = p;
      l += p;
    }
    l = gi::warp_sum(l);
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    if (lse_rows != nullptr && lane == 0)
      lse_rows[qi] = l > 0.f ? m + logf(l) : 0.f;
    for (int k = lane; k < L; k += 32) put(qi, k, gi::round_to<T>(row[k] * inv));
    for (int k = L + lane; k < lk_pad; k += 32) put(qi, k, 0.f);
  }
}

// ---------------------------------------------------------------------------
// core variant
// ---------------------------------------------------------------------------
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fused_attention_core_kernel(const T* __restrict__ maps,
                            const float* __restrict__ bias,
                            const float* __restrict__ rnorm,
                            T* __restrict__ out, float* __restrict__ lse,
                            int hs, int ws, int C, int rate, float scale,
                            int lk_pad) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                  // [G][lk_pad] scores, then weights
  float* Qs = smem + G * lk_pad;    // [G][C] one Q tap of the group

  const int L = hs * ws;
  const int wp = ws + 2;
  const size_t map_elems = static_cast<size_t>(hs + 2) * wp * C;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * G;
  const int nq = min(G, L - q0);
  const int tid = threadIdx.x;
  const T* img = maps + static_cast<size_t>(b) * rate * rate * map_elems;
  const float* bias_b = bias + static_cast<size_t>(b) * L;
  const float* rnorm_b = rnorm + static_cast<size_t>(b) * L;

  // ---- 1. scores: sum over the 3x3 taps of C-contractions --------------
  for (int t = 0; t < 9; ++t) {
    const int dp = t / 3, dq = t % 3;
    __syncthreads();  // previous tap's Qs reads are done
    for (int i = tid; i < G * C; i += kThreads) {
      const int qi = i / C, c = i - qi * C;
      float v = 0.f;
      if (qi < nq) {
        const int q = q0 + qi, y = q / ws, x = q - y * ws;
        v = gi::to_float(img[(static_cast<size_t>(y + dp) * wp + x + dq) * C
                             + c]);
      }
      Qs[i] = v;
    }
    __syncthreads();
    for (int k = tid; k < L; k += kThreads) {
      const int ky = k / ws, kx = k - ky * ws;
      const T* kp = img + (static_cast<size_t>(ky + dp) * wp + kx + dq) * C;
      float acc[G];
#pragma unroll
      for (int qi = 0; qi < G; ++qi) acc[qi] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float4 kv = gi::load4(kp + c);
#pragma unroll
        for (int qi = 0; qi < G; ++qi) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + qi * C + c);
          acc[qi] = fmaf(qv.x, kv.x, acc[qi]);
          acc[qi] = fmaf(qv.y, kv.y, acc[qi]);
          acc[qi] = fmaf(qv.z, kv.z, acc[qi]);
          acc[qi] = fmaf(qv.w, kv.w, acc[qi]);
        }
      }
      // each thread owns the same keys at every tap: no sync needed here
#pragma unroll
      for (int qi = 0; qi < G; ++qi) {
        float* s = S + qi * lk_pad + k;
        *s = (t == 0) ? acc[qi] : *s + acc[qi];
      }
    }
  }
  __syncthreads();

  // ---- 2. softmax, weights written back over the scores ---------------
  softmax_rows<T>(S, lk_pad, G, nq, L, bias_b, rnorm_b, scale,
                  lse == nullptr ? nullptr
                                 : lse + static_cast<size_t>(b) * L + q0,
                  [&](int qi, int k, float p) { S[qi * lk_pad + k] = p; });
  __syncthreads();

  // ---- 3. the 4r² tap products P·V_tap -----------------------------------
  const int taps = 4 * rate * rate;
  const int half = rate / 2;
  for (int pair = tid; pair < taps * C; pair += kThreads) {
    const int tap = pair / C, c = pair - tap * C;
    const int vp = tap / (2 * rate), vq = tap - vp * (2 * rate);
    // tap row vp reads parity (vp - r//2) mod r at cell offset
    // floor((vp - r//2) / r) + 1 of the halo-padded map
    const int par_p = (vp - half + rate) % rate;
    const int off_p = (vp - half + rate) / rate;
    const int par_q = (vq - half + rate) % rate;
    const int off_q = (vq - half + rate) / rate;
    const T* vmap = img + static_cast<size_t>(par_p * rate + par_q) * map_elems
                    + (static_cast<size_t>(off_p) * wp + off_q) * C + c;
    float acc[G];
#pragma unroll
    for (int qi = 0; qi < G; ++qi) acc[qi] = 0.f;
    int ky = 0, kx = 0;
    for (int k = 0; k < lk_pad; k += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (k + j < L)
                   ? gi::to_float(vmap[(static_cast<size_t>(ky) * wp + kx) * C])
                   : 0.f;
        if (++kx == ws) { kx = 0; ++ky; }
      }
#pragma unroll
      for (int qi = 0; qi < G; ++qi) {
        const float4 p = *reinterpret_cast<const float4*>(S + qi * lk_pad + k);
        acc[qi] = fmaf(p.x, v[0], acc[qi]);
        acc[qi] = fmaf(p.y, v[1], acc[qi]);
        acc[qi] = fmaf(p.z, v[2], acc[qi]);
        acc[qi] = fmaf(p.w, v[3], acc[qi]);
      }
    }
    T* o = out + ((static_cast<size_t>(b) * taps + tap) * L + q0) * C + c;
#pragma unroll
    for (int qi = 0; qi < G; ++qi)
      if (qi < nq) o[static_cast<size_t>(qi) * C] = gi::from_float<T>(acc[qi]);
  }
}

// ---------------------------------------------------------------------------
// mma variant: bf16 tensor-core tiles, keys split over a thread block cluster
// ---------------------------------------------------------------------------
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
// 8 query rows × 32 columns × 16-deep contraction
using FragRows = wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16,
                                wmma::row_major>;
using FragKeysT = wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16,
                                 wmma::col_major>;
using FragV = wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16,
                             wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 8, 32, 16, float>;

// G = 8·QT query cells per cluster of CL blocks (CL = the launch's cluster
// size, 1 at the 256² serve map). Block `rank` of the cluster holds the
// scores and weights of keys [rank·lb, (rank+1)·lb) of the group's rows in
// its shared memory, so a group keeps G rows at any Lk ≤ 8·lb; the softmax
// combines the blocks' row maxima and sums through distributed shared
// memory, and step 3 reads every block's weights. Lk and lb are multiples
// of 256; cells of a 32-key (or 8-query) tile lie in one map row because
// ws % 32 == 0.
template <int QT>
__global__ void __launch_bounds__(kThreads)
fused_attention_mma_kernel(const bf16* __restrict__ maps,
                           const float* __restrict__ bias,
                           const float* __restrict__ rnorm,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int hs, int ws, int C, int rate, float scale,
                           int lb) {
  constexpr int G = 8 * QT;
  constexpr int KT = 8 / QT;  // 32-key tiles per step-1 job
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = hs * ws;
  float* S = reinterpret_cast<float*>(smem_raw);            // [G][lb]
  bf16* P = reinterpret_cast<bf16*>(S + G * lb);            // [G][lb]
  float* stage = reinterpret_cast<float*>(P + G * lb);      // [warps][8][32]
  float* row_max = stage + kWarps * 8 * 32;                     // [G]
  float* row_sum = row_max + G;                             // [G]

  const int wp = ws + 2;
  const size_t map_elems = static_cast<size_t>(hs + 2) * wp * C;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x / cl) * G;
  const int kbase = rank * lb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* img = maps + static_cast<size_t>(b) * rate * rate * map_elems;
  // cell i (row-major over hs × ws) shifted by (dy, dx) in a halo map
  auto cell = [&](const bf16* m, int i, int dy, int dx) {
    return m + (static_cast<size_t>(i / ws + dy) * wp + i % ws + dx) * C;
  };

  // ---- 1. scores of this block's keys: job = KT·32 keys × G queries ----
  for (int job = warp; job < lb / (32 * KT); job += kWarps) {
    const int k0 = job * 32 * KT;
    FragAcc acc[QT][KT];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) wmma::fill_fragment(acc[qt][kt], 0.f);
    for (int t = 0; t < 9; ++t) {
      const int dp = t / 3, dq = t % 3;
      for (int c = 0; c < C; c += 16) {
        FragRows q[QT];
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
          wmma::load_matrix_sync(q[qt], cell(img, q0 + qt * 8, dp, dq) + c,
                                 C);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          FragKeysT kf;
          wmma::load_matrix_sync(
              kf, cell(img, kbase + k0 + kt * 32, dp, dq) + c, C);
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
            wmma::mma_sync(acc[qt][kt], q[qt], kf, acc[qt][kt]);
        }
      }
    }
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        wmma::store_matrix_sync(S + qt * 8 * lb + k0 + kt * 32, acc[qt][kt],
                                lb, wmma::mem_row_major);
  }
  __syncthreads();

  // ---- 2. softmax over the cluster's keys into P (bf16) ----------------
  // s = S·(rnorm·scale) + bias; p = exp(s − max) on valid keys, 0 on hole
  // keys; p / Σp, or all 0 when no key of the row is valid. The max and
  // the sum run over all Lk keys: each block's partial, combined through
  // distributed shared memory.
  const float* bias_b = bias + static_cast<size_t>(b) * L + kbase;
  const float* rnorm_b = rnorm + static_cast<size_t>(b) * L + kbase;
  for (int qi = warp; qi < G; qi += kWarps) {
    float* row = S + qi * lb;
    float m = -CUDART_INF_F;
    for (int k = lane; k < lb; k += 32) {
      const float s = row[k] * (rnorm_b[k] * scale) + bias_b[k];
      row[k] = s;
      m = fmaxf(m, s);
    }
    m = gi::warp_max(m);
    if (lane == 0) row_max[qi] = m;
  }
  cluster.sync();
  for (int qi = warp; qi < G; qi += kWarps) {
    float* row = S + qi * lb;
    float m = -CUDART_INF_F;
    for (int r = 0; r < cl; ++r)
      m = fmaxf(m, cluster.map_shared_rank(row_max, r)[qi]);
    float l = 0.f;
    for (int k = lane; k < lb; k += 32) {
      const float p = bias_b[k] >= 0.f ? expf(row[k] - m) : 0.f;
      row[k] = p;
      l += p;
    }
    l = gi::warp_sum(l);
    if (lane == 0) row_sum[qi] = l;
  }
  cluster.sync();
  for (int qi = warp; qi < G; qi += kWarps) {
    const float* row = S + qi * lb;
    float l = 0.f;
    for (int r = 0; r < cl; ++r) l += cluster.map_shared_rank(row_sum, r)[qi];
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    if (lse != nullptr && rank == 0 && lane == 0) {
      float m = -CUDART_INF_F;
      for (int r = 0; r < cl; ++r)
        m = fmaxf(m, cluster.map_shared_rank(row_max, r)[qi]);
      lse[static_cast<size_t>(b) * L + q0 + qi] = l > 0.f ? m + logf(l) : 0.f;
    }
    for (int k = lane; k < lb; k += 32)
      P[qi * lb + k] = __float2bfloat16(row[k] * inv);
  }
  cluster.sync();  // every block's weights are written

  // ---- 3. P·V_tap: job = one tap × 64 channels × all G queries over all
  // Lk keys, the jobs dealt out over the cluster's blocks -----------------
  const int taps = 4 * rate * rate;
  const int half = rate / 2;
  const int cgroups = C / 64;
  float* st = stage + warp * 8 * 32;
  for (int job = rank + cl * warp; job < taps * cgroups; job += cl * kWarps) {
    const int tap = job / cgroups, c0 = (job % cgroups) * 64;
    const int vp = tap / (2 * rate), vq = tap - vp * (2 * rate);
    const int par_p = (vp - half + rate) % rate;
    const int off_p = (vp - half + rate) / rate;
    const int par_q = (vq - half + rate) % rate;
    const int off_q = (vq - half + rate) / rate;
    const bf16* vmap =
        img + static_cast<size_t>(par_p * rate + par_q) * map_elems + c0;
    FragAcc acc[QT][2];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      wmma::fill_fragment(acc[qt][0], 0.f);
      wmma::fill_fragment(acc[qt][1], 0.f);
    }
    for (int owner = 0; owner < cl; ++owner) {
      const bf16* Po = cluster.map_shared_rank(P, owner);
      for (int kl = 0; kl < lb; kl += 16) {
        const bf16* v = cell(vmap, owner * lb + kl, off_p, off_q);
        FragV v0, v1;
        wmma::load_matrix_sync(v0, v, C);
        wmma::load_matrix_sync(v1, v + 32, C);
#pragma unroll
        for (int qt = 0; qt < QT; ++qt) {
          FragRows pf;
          wmma::load_matrix_sync(pf, Po + qt * 8 * lb + kl, lb);
          wmma::mma_sync(acc[qt][0], pf, v0, acc[qt][0]);
          wmma::mma_sync(acc[qt][1], pf, v1, acc[qt][1]);
        }
      }
    }
    // accumulators → bf16 rows of the tap-major output, 16 B per lane
    const int row = lane / 4, col = (lane % 4) * 8;
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[qt][j], 32, wmma::mem_row_major);
        __syncwarp();
        __nv_bfloat162 h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = __floats2bfloat162_rn(st[row * 32 + col + 2 * e],
                                       st[row * 32 + col + 2 * e + 1]);
        bf16* o = out + ((static_cast<size_t>(b) * taps + tap) * L + q0 +
                         qt * 8 + row) * C + c0 + j * 32 + col;
        *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(h);
        __syncwarp();
      }
  }
  cluster.sync();  // no block exits while the others may read its weights
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T, int G>
int launch_core(const void* maps, const float* bias, const float* rnorm,
                void* out, float* lse, int B, int hs, int ws, int C, int rate,
                float scale, cudaStream_t stream) {
  const int L = hs * ws;
  const int lk_pad = (L + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(G) * (lk_pad + C) * sizeof(float);
  auto kernel = fused_attention_core_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((L + G - 1) / G, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(maps), bias, rnorm, static_cast<T*>(out), lse, hs,
      ws, C, rate, scale, lk_pad);
  return cudaGetLastError();
}

template <typename T>
int dispatch_core(int group, const void* maps, const float* bias,
                  const float* rnorm, void* out, float* lse, int B, int hs,
                  int ws, int C, int rate, float scale, cudaStream_t s) {
  switch (group) {
    case 32: return launch_core<T, 32>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    case 16: return launch_core<T, 16>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    case 8: return launch_core<T, 8>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    case 4: return launch_core<T, 4>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    case 2: return launch_core<T, 2>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    case 1: return launch_core<T, 1>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int QT>
int launch_mma(const void* maps, const float* bias, const float* rnorm,
               void* out, float* lse, int B, int hs, int ws, int C, int rate,
               float scale, int cl, cudaStream_t stream) {
  const int L = hs * ws;
  const int lb = L / cl;
  const size_t smem = static_cast<size_t>(8 * QT) * lb * (4 + 2)
                      + kWarps * 8 * 32 * sizeof(float)
                      + 2 * 8 * QT * sizeof(float);
  auto kernel = fused_attention_mma_kernel<QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L / (8 * QT) * cl, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(maps), bias,
                           rnorm, static_cast<bf16*>(out), lse, hs, ws, C,
                           rate, scale, lb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int dispatch_mma(int group, const void* maps, const float* bias,
                 const float* rnorm, void* out, float* lse, int B, int hs,
                 int ws, int C, int rate, float scale, int cl,
                 cudaStream_t s) {
  switch (group) {
    case 32: return launch_mma<4>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, cl, s);
    case 16: return launch_mma<2>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, cl, s);
    case 8: return launch_mma<1>(maps, bias, rnorm, out, lse, B, hs, ws, C, rate, scale, cl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). variant 0 = core, 1 = mma; group
// = query cells per block (core) or per cluster (mma); cluster = blocks
// per cluster (mma; 1 for core). lse may be null (no log-sum-exp written).
extern "C" int gi_fused_attention(const void* maps, const float* bias,
                                  const float* rnorm, void* out, float* lse,
                                  int B,
                                  int hs, int ws, int C, int rate,
                                  float scale, int is_bf16, int variant,
                                  int group, int cluster, void* stream) {
  if (C % 4 != 0 || rate < 1 || hs < 1 || ws < 1 || B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int L = hs * ws;
    if (!is_bf16 || C % 64 != 0 || ws % 32 != 0 || cluster < 1 ||
        cluster > 8 || L % (256 * cluster) != 0)
      return cudaErrorInvalidValue;
    return dispatch_mma(group, maps, bias, rnorm, out, lse, B, hs, ws, C,
                        rate, scale, cluster, s);
  }
  if (cluster != 1) return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_core<bf16>(group, maps, bias, rnorm, out, lse, B, hs, ws,
                               C, rate, scale, s);
  return dispatch_core<float>(group, maps, bias, rnorm, out, lse, B, hs, ws,
                              C, rate, scale, s);
}
