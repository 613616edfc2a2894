// Fused contextual attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _bwd_dq_kernel and _bwd_dkv_kernel of
// gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py. Every operand tile
// is read from the halo-padded sub-pixel parity maps of the forward
// (contextual_attention.cu), so no patch tensor reaches device memory. The
// upstream gradient arrives the same way: gmaps holds g / overlap-count
// laid out as parity maps, so the `do` tap of a query is read exactly like
// the V tap of a key.
//
// Inputs (contiguous; T = float or __nv_bfloat16):
//   maps, gmaps (B, r, r, hs+2, ws+2, C) T — feature and gradient maps
//   bias, rnorm (B, L) float — as in the forward; L = hs·ws = Lq = Lk
//   lse (B, L) float — per-query log-sum-exp saved by the forward
//   o_taps (B, 4r², L, C) T — the forward's tap-major output
// With u_ij = Σ_9taps q_i·k_j, s = u·rnorm_j·scale + bias_j:
//   p_ij  = exp(s_ij − lse_i) on valid keys, exactly 0 on hole keys (a
//           select, not a product: s − lse is noise where every key is a
//           hole)
//   δ_i   = Σ_taps do_i·o_i           dp_ij = Σ_4r²taps do_i·v_j
//   ds_ij = p_ij·(dp_ij − δ_i)        dsr_ij = ds_ij·rnorm_j·scale
// and the outputs, float32 per-tap buffers:
//   δ → (B, L);  dq_t[i] = Σ_j dsr_ij·k_j,t → qk_taps (B, 9, L, C);
//   dk_t[j] = Σ_i dsr_ij·q_i,t → qk_taps;  dv_tap[j] = Σ_i p_ij·do_i,tap
//   → dv_taps (B, 4r², L, C);  t_j = Σ_i ds_ij·u_ij, the scalar of the
//   key-norm correction → (B, L).
// The wrapper folds the per-tap gradients onto the padded maps in a fixed
// order. No atomics touch device memory, so the same inputs give the same
// bits on every run.
//
// Two variants:
//   * wgmma (bf16; C % 32 == 0, ws 32, 64 or a multiple of 128, L % 128
//     == 0), materialized scores. Per sample the L × L matrices are small
//     beside the rows (P and dS in bf16: 4 MB at L 1024, 64 MB at L 4096,
//     while a row of Q, K and V taps is 9C + 16C = 4800 wide at C 192), so
//     p and dsr are formed once and the rest are dense products with a
//     wide N (one tap's C channels) and K = L. Four launches:
//       1. delta_kernel: δ, one warp per query row (memory-bound, small);
//       2. scores_kernel: per (sample, 128 query rows, 128 key columns)
//          u over the 9 Q/K taps and dp over the 4r² do/V taps, wgmma
//          m64n128k16 with float32 sums over all of d and dv (no split,
//          no exchange); the epilogue writes p and dsr as bf16 into a
//          scratch (2n, L, L) and the tile's column sums of ds·u (t's
//          partials) as float32 (n, L/128, L);
//       3./4. products_kernel, dQ (dq_t = dsr·K_t) and dK/dV (dk_t =
//          dsrᵀ·Q_t, dv_tap = pᵀ·do_tap): a block owns 128 rows × one
//          tap's NU·64 channels (wgmma m64n{64,128,192}k16, one product
//          per tap per N tile) and walks K = L in 64-cell stages; the
//          transposes are read through MN-major descriptors of the same
//          scratch, so neither is written; the dK/dV launch also sums t's
//          partials in row-tile order.
//     Both mainloops are warp-specialized as gated_conv.cu's: one
//     producer warpgroup (setmaxnreg 40) whose single thread issues TMA
//     boxes into an mbarrier ring, two consumer warpgroups (232) of 64
//     rows each. A Q/K tap is a box of map (0, 0) at the tap's shifted
//     cell origin, a V/do tap a box of parity map (par, off): 128 cells
//     are 4 map rows at ws 32, 2 at ws 64. A tap is cpt = ⌈C/64⌉ boxes
//     of 64 channels; where C is not a multiple of 64 (the published
//     width's C 96: 2 boxes), the last box runs past C and TMA fills those
//     channels with zeros, which add nothing to u, dp or a product and
//     give output channels the products' epilogue does not store. Fill
//     per block and stage:
//     scores 32 KB per 2·128·128·64 FLOP (64 FLOP per byte), products
//     40 KB per 2·128·192·64 (76.8). On the H100 the kernels run at
//     440–700 TFLOP/s all the same (PERF.md §6), and a cluster of 2 that
//     multicast the box the blocks share (85.3 and 109.7 FLOP per byte)
//     was no faster, so time does not follow the fill bytes here.
//   * core (any shape, float32 or bf16): one block owns G rows — query
//     cells for dQ, key cells for dK/dV — and loops over every column:
//     u and dp of its G rows against all L columns, p and dsr kept in
//     shared memory as G rows of L, then the tap products with the sums
//     in registers. CUDA-core FMAs, float32 throughout; the wrapper sizes
//     G from L and refuses an L it cannot hold.
// Bound on this card: 2·L²·C·(9 + 4r²) operations per image for the
// scores and 2·L²·C·(9 + 9 + 4r²) for the products (59 units of 2·L²·C
// at r 2, against 34 + 50 for a flash backward that recomputes the
// scores), against tens of MB of maps, tap buffers and the p/dsr round
// trip: bounded by operations.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

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
// wgmma variant (bf16): δ, score tiles, tap products
// ---------------------------------------------------------------------------
namespace mat {

using namespace gi;

constexpr int kWgThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kTile = 128;           // score tile rows/columns; product rows
constexpr int kUnit = 64;            // channels per TMA box (128 bytes)
constexpr int kDepth = 64;           // cells per product stage
constexpr int kHalf = kTile * kUnit * 2;           // 16 KB: 128 cells × 64
constexpr int kBoxBytes = kDepth * kUnit * 2;      // 8 KB: 64 cells × 64
constexpr int kScoreStage = 2 * kHalf;             // A and B tiles, 32 KB
constexpr int kScoreRing = 6;
constexpr int kSmemLimit = 232448;
constexpr int kExtra = 10 * kTile * 4;             // scores: column scalars

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D(64 × 64·NU) += A(64 × 16) · B(16 × 64·NU); TA, TB: the operand is
// MN-major (read transposed)
template <int NU, int TA, int TB>
__device__ __forceinline__ void wgmma_nu(float* d, uint64_t da, uint64_t db) {
  if constexpr (NU == 1) {
    wgmma_m64n64<TA, TB>(d, da, db);
  } else if constexpr (NU == 2) {
    wgmma_m64n128<TA, TB>(d, da, db);
  } else {
    wgmma_m64n192<TA, TB>(d, da, db);
  }
}

// MN-major operand of NU atoms of 64 along N, each a TMA box of 64 rows of
// K, 8 KB apart; 128-byte swizzle. The leading offset steps the atoms along
// N, the stride offset 8 rows of K; `addr` advances 2048 bytes per k16 step.
__device__ __forceinline__ uint64_t desc_sw128_mn_wide(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
      reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- 1. δ: one warp per query row --------------------------------------
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ gmaps, const bf16* __restrict__ o_taps,
             float* __restrict__ delta, int B, int hs, int ws, int C,
             int rate) {
  const int L = hs * ws;
  const long long row = 8LL * blockIdx.x + threadIdx.x / 32;
  if (row >= 1LL * B * L) return;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(row / L), i = static_cast<int>(row % L);
  const int y = i / ws, x = i - y * ws;
  const int taps = 4 * rate * rate, wp = ws + 2;
  const size_t map_elems = static_cast<size_t>(hs + 2) * wp * C;
  const bf16* g = gmaps + static_cast<size_t>(b) * rate * rate * map_elems;
  float d = 0.f;
  for (int tap = 0; tap < taps; ++tap) {
    const TapGeo geo = tap_geo(tap, rate);
    const bf16* dop = g + geo.par * map_elems +
                      (static_cast<size_t>(y + geo.off_p) * wp + x +
                       geo.off_q) * C;
    const bf16* op = o_taps +
                     ((static_cast<size_t>(b) * taps + tap) * L + i) * C;
    for (int c = lane * 8; c < C; c += 256) {
      const uint4 gv = *reinterpret_cast<const uint4*>(dop + c);
      const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
      const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 gf = __bfloat1622float2(g2[k]);
        const float2 of = __bfloat1622float2(o2[k]);
        d = fmaf(gf.x, of.x, d);
        d = fmaf(gf.y, of.y, d);
      }
    }
  }
  d = warp_sum(d);
  if (lane == 0) delta[row] = d;
}

// ---- 2. score tiles -------------------------------------------------------
struct ScoreArgs {
  int n, hs, ws, cpt, rate, L, tiles;   // cpt = ⌈C / 64⌉, tiles = L / 128
  float scale;
  const float* bias;     // (n, L) of this chunk; likewise rnorm, lse, delta
  const float* rnorm;
  const float* lse;
  const float* delta;
  bf16* scratch;         // (2n, L, L): dsr of sample b at b, p at n + b
  float* tpart;          // (n, tiles, L): column sums of ds·u per row tile
};

// Block (query tile qt, key tile kt) of sample blockIdx.y, blockIdx.x =
// kt·tiles + qt. Stages: the 9·cpt Q/K units (u), then the 4r²·cpt do/V
// units (dp); A (the 128 query rows) is 16 KB K-major, warpgroup w reading
// rows 64w …; B (the 128 keys) is 16 KB K-major.
__global__ void __launch_bounds__(kWgThreads, 1)
scores_kernel(const __grid_constant__ CUtensorMap tm_maps,   // 128 cells
              const __grid_constant__ CUtensorMap tm_gmaps,  // 128 cells
              const ScoreArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* col_bias = reinterpret_cast<float*>(gbase + kScoreRing * kScoreStage);
  float* col_rs = col_bias + kTile;
  float* tred = col_rs + kTile;                        // [8 warps][kTile]
  const uint32_t full = base + kScoreRing * kScoreStage + kExtra;
  const uint32_t empty = full + 8 * kScoreRing;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.x / a.tiles, qt = blockIdx.x - kt * a.tiles;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const int n_qk = 9 * a.cpt;
  const int n_st = n_qk + 4 * a.rate * a.rate * a.cpt;

  if (tid == 0) {
    for (int s = 0; s < kScoreRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ========================= producer ===================================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      prefetch_map(&tm_maps);
      prefetch_map(&tm_gmaps);
      const int bm = b * a.rate * a.rate;
      const int qy = q0 / a.ws, qx = q0 - qy * a.ws;
      const int ky = k0 / a.ws, kx = k0 - ky * a.ws;
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kScoreRing;
        mbar_wait(empty + 8 * s, ((i / kScoreRing) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t st = base + s * kScoreStage;
        mbar_expect_tx(bar, kScoreStage);
        int c, oy, ox, map = 0;
        if (i < n_qk) {
          const int tap = i / a.cpt;
          c = (i - tap * a.cpt) * kUnit;
          oy = tap / 3;
          ox = tap - oy * 3;
          tma_load_4d(st, &tm_maps, bar, c, qx + ox, qy + oy, bm);
        } else {
          const int j = i - n_qk, tap = j / a.cpt;
          c = (j - tap * a.cpt) * kUnit;
          const TapGeo geo = tap_geo(tap, a.rate);
          map = geo.par;
          oy = geo.off_p;
          ox = geo.off_q;
          tma_load_4d(st, &tm_gmaps, bar, c, qx + ox, qy + oy, bm + map);
        }
        tma_load_4d(st + kHalf, &tm_maps, bar, c, kx + ox, ky + oy,
                    bm + map);
      }
    }
  } else {
    // ========================= consumers ==================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
    for (int c = tid; c < kTile; c += kConsumers) {
      const size_t at = static_cast<size_t>(b) * a.L + k0 + c;
      col_bias[c] = a.bias[at];
      col_rs[c] = a.rnorm[at] * a.scale;
    }
    consumer_sync();
    float U[64], D[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      U[i] = 0.f;
      D[i] = 0.f;
      fence_operand(U[i]);
      fence_operand(D[i]);
    }
    wgmma_fence();
    int it = 0;
    for (; it < n_qk; ++it) {
      const int s = it % kScoreRing;
      mbar_wait(full + 8 * s, (it / kScoreRing) & 1);
      const uint32_t at = base + s * kScoreStage + wg * (kHalf / 2);
      const uint32_t bt = base + s * kScoreStage + kHalf;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128<0, 0>(U, desc_sw128_k(at + 32 * kk),
                            desc_sw128_k(bt + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();                 // stage it − 1 is read
      if (it > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it - 1) % kScoreRing));
    }
    for (; it < n_st; ++it) {
      const int s = it % kScoreRing;
      mbar_wait(full + 8 * s, (it / kScoreRing) & 1);
      const uint32_t at = base + s * kScoreStage + wg * (kHalf / 2);
      const uint32_t bt = base + s * kScoreStage + kHalf;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128<0, 0>(D, desc_sw128_k(at + 32 * kk),
                            desc_sw128_k(bt + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kScoreRing));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      fence_operand(U[i]);
      fence_operand(D[i]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * ((n_st - 1) % kScoreRing));

    // ---- epilogue: register d[4j + 2h + e] holds row r_lo + 8h and
    // column 8j + cq + e of the warpgroup's 64 × 128 tile
    const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    float lse_r[2], dl_r[2];
    bf16* dsr_row[2];
    bf16* p_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + r_lo + 8 * h;
      const size_t at = static_cast<size_t>(b) * a.L + q;
      lse_r[h] = a.lse[at];
      dl_r[h] = a.delta[at];
      dsr_row[h] = a.scratch + at * a.L + k0;
      p_row[h] = a.scratch + (static_cast<size_t>(a.n) * a.L + at) * a.L +
                 k0;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float tc[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, col = 8 * j + cq + e;
          const float rs = col_rs[col], bi = col_bias[col], u = U[i];
          const float pp = bi >= 0.f ? expf(u * rs + bi - lse_r[h]) : 0.f;
          const float ds = pp * (D[i] - dl_r[h]);
          tc[e] = fmaf(ds, u, tc[e]);
          pv[e] = pp;
          dv[e] = ds * rs;
        }
        *reinterpret_cast<__nv_bfloat162*>(p_row[h] + 8 * j + cq) =
            __floats2bfloat162_rn(pv[0], pv[1]);
        *reinterpret_cast<__nv_bfloat162*>(dsr_row[h] + 8 * j + cq) =
            __floats2bfloat162_rn(dv[0], dv[1]);
      }
      // the warp's 16 rows of each column: lanes with equal lane % 4
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float t = tc[e];
        t += __shfl_xor_sync(0xffffffffu, t, 4);
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        if (lane < 4) tred[warp * kTile + 8 * j + cq + e] = t;
      }
    }
    consumer_sync();
    if (tid < kTile) {
      float t = 0.f;                   // the 8 warps' rows, in row order
      for (int w = 0; w < 8; ++w) t += tred[w * kTile + tid];
      a.tpart[(static_cast<size_t>(b) * a.tiles + qt) * a.L + k0 + tid] = t;
    }
  }
}

// ---- 3./4. tap products ---------------------------------------------------
struct ProdArgs {
  int n, hs, ws, C, cpt, rate, L, tiles;   // cpt = ⌈C / 64⌉
  int which;             // 0: dQ; 1: dK and dV
  int ncb;               // channel blocks per tap: cpt / NU
  const float* tpart;    // (n, tiles, L), dK/dV
  float* tnorm;          // (n, L), dK/dV
  float* qk;             // (n, 9, L, C): dq taps or dk taps
  float* dv;             // (n, 4r², L, C), dK/dV
};

template <int NU>
__host__ __device__ constexpr int prod_ring() {
  return (kSmemLimit - 2048) / (kHalf + NU * kBoxBytes) < 8
             ? (kSmemLimit - 2048) / (kHalf + NU * kBoxBytes)
             : 8;
}

// Block (row tile blockIdx.x, job blockIdx.y, sample blockIdx.z); a job is
// a tap and a block of NU·64 channels. A: 128 rows × 64 cells of the
// scratch per stage — dQ (TA 0): dsr rows, K-major, one box of 128 rows;
// dK/dV (TA 1): dsrᵀ or pᵀ, two boxes of 64 key columns × 64 query rows
// read MN-major. B: NU boxes of 64 cells × 64 channels of the tap, read
// MN-major (cells are K).
template <int NU, int TA>
__global__ void __launch_bounds__(kWgThreads, 1)
products_kernel(const __grid_constant__ CUtensorMap tm_a,      // scratch
                const __grid_constant__ CUtensorMap tm_maps,   // 64 cells
                const __grid_constant__ CUtensorMap tm_gmaps,  // 64 cells
                const ProdArgs a) {
  constexpr int kStage = kHalf + NU * kBoxBytes;
  constexpr int kRing = prod_ring<NU>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kRing * kStage;
  const uint32_t empty = full + 8 * kRing;
  const int tid = threadIdx.x;
  const int mt = blockIdx.x, job = blockIdx.y, b = blockIdx.z;
  const int m0 = mt * kTile;
  const int tap = job / a.ncb;
  const int c0 = (job - tap * a.ncb) * NU * kUnit;
  const bool is_v = a.which == 1 && tap >= 9;
  const int n_st = a.L / kDepth;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ========================= producer ===================================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      prefetch_map(&tm_a);
      prefetch_map(is_v ? &tm_gmaps : &tm_maps);
      int map = 0, oy, ox;
      if (is_v) {
        const TapGeo geo = tap_geo(tap - 9, a.rate);
        map = geo.par;
        oy = geo.off_p;
        ox = geo.off_q;
      } else {
        oy = tap / 3;
        ox = tap - oy * 3;
      }
      const int plane = b * a.rate * a.rate + map;
      const int buf = is_v ? a.n + b : b;      // p, or dsr
      const CUtensorMap* tm_b = is_v ? &tm_gmaps : &tm_maps;
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kRing;
        mbar_wait(empty + 8 * s, ((i / kRing) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t st = base + s * kStage;
        mbar_expect_tx(bar, kStage);
        if constexpr (TA == 0) {
          tma_load_3d(st, &tm_a, bar, i * kDepth, m0, buf);
        } else {
          tma_load_3d(st, &tm_a, bar, m0, i * kDepth, buf);
          tma_load_3d(st + kHalf / 2, &tm_a, bar, m0 + 64, i * kDepth, buf);
        }
        const int ky = i * kDepth / a.ws, kx = i * kDepth - ky * a.ws;
#pragma unroll
        for (int u = 0; u < NU; ++u)
          tma_load_4d(st + kHalf + u * kBoxBytes, tm_b, bar, c0 + u * kUnit,
                      kx + ox, ky + oy, plane);
      }
    }
  } else {
    // ========================= consumers ==================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
    float acc[NU * 32];
#pragma unroll
    for (int i = 0; i < NU * 32; ++i) {
      acc[i] = 0.f;
      fence_operand(acc[i]);
    }
    wgmma_fence();
    for (int i = 0; i < n_st; ++i) {
      const int s = i % kRing;
      mbar_wait(full + 8 * s, (i / kRing) & 1);
      const uint32_t at = base + s * kStage + wg * (kHalf / 2);
      const uint32_t bt = base + s * kStage + kHalf;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = TA ? desc_sw128_mn(at + 2048 * kk)
                               : desc_sw128_k(at + 32 * kk);
        wgmma_nu<NU, TA, 1>(acc, da, desc_sw128_mn_wide(bt + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait<1>();                 // stage i − 1 is read
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kRing));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NU * 32; ++i) fence_operand(acc[i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((n_st - 1) % kRing));

    // ---- epilogue: register d[4j + 2h + e] holds row r_lo + 8h and
    // channel c0 + 8j + cq + e; channels from C on are the zero fill
    const int C = a.C;
    const int taps = 4 * a.rate * a.rate;
    float* out = is_v
        ? a.dv + (static_cast<size_t>(b) * taps + tap - 9) * a.L * C
        : a.qk + (static_cast<size_t>(b) * 9 + tap) * a.L * C;
    const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = out + static_cast<size_t>(m0 + r_lo + 8 * h) * C + c0 + cq;
#pragma unroll
      for (int j = 0; j < 8 * NU; ++j)
        if (c0 + 8 * j < C)            // C % 32 == 0: whole groups of 8
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    // t_j of the block's 128 keys: the row tiles' partial sums, in order
    if (a.which == 1 && job == 0 && tid < kTile) {
      const float* tp = a.tpart + static_cast<size_t>(b) * a.tiles * a.L +
                        m0 + tid;
      float t = 0.f;
      for (int r = 0; r < a.tiles; ++r) t += tp[static_cast<size_t>(r) * a.L];
      a.tnorm[static_cast<size_t>(b) * a.L + m0 + tid] = t;
    }
  }
}

// ---- host side --------------------------------------------------------------
inline int encode(CUtensorMap* tm, const void* ptr, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct Geo {
  int n, hs, ws, C, rate;
};

// 4-D map (C, ws + 2, hs + 2, n·r²) of parity maps; a box is 64 channels ×
// `cells` consecutive cells (whole map rows, or part of one)
inline int encode_maps(CUtensorMap* tm, const void* maps, const Geo& g,
                       int cells) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.C),
                              static_cast<cuuint64_t>(g.ws + 2),
                              static_cast<cuuint64_t>(g.hs + 2),
                              static_cast<cuuint64_t>(g.n) * g.rate * g.rate};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(g.C) * 2,
      static_cast<cuuint64_t>(g.ws + 2) * g.C * 2,
      static_cast<cuuint64_t>(g.hs + 2) * (g.ws + 2) * g.C * 2};
  const int bw = g.ws < cells ? g.ws : cells;
  const cuuint32_t box[4] = {kUnit, static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(cells / bw), 1};
  return encode(tm, maps, 4, dims, strides, box);
}

// 3-D map (L, L, 2n) of the scratch; a box is `cols` × `rows`
inline int encode_scratch(CUtensorMap* tm, const void* scratch, int n, int L,
                          int cols, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(2 * n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(L) * 2,
                                 static_cast<cuuint64_t>(L) * L * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1};
  return encode(tm, scratch, 3, dims, strides, box);
}

template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// what the wgmma kernels take (the wrapper's plan checks the same)
inline bool takes(const Geo& g) {
  const int L = g.hs * g.ws;
  return g.n >= 1 && g.hs >= 1 && g.rate >= 1 && g.C % 32 == 0 &&
         g.C > 0 && (g.ws == 32 || g.ws == 64 || g.ws % 128 == 0) &&
         L % kTile == 0;
}

int launch_scores(const void* maps, const void* gmaps, const Geo& g,
                  const ScoreArgs& a, cudaStream_t s) {
  CUtensorMap tm{}, tg{};
  int err = encode_maps(&tm, maps, g, kTile);
  if (err == cudaSuccess) err = encode_maps(&tg, gmaps, g, kTile);
  if (err != cudaSuccess) return err;
  const int smem = kScoreRing * kScoreStage + kExtra + 16 * kScoreRing + 1024;
  return launch(scores_kernel,
                dim3(static_cast<unsigned>(a.tiles * a.tiles),
                     static_cast<unsigned>(a.n)),
                smem, s, tm, tg, a);
}

template <int NU, int TA>
int launch_products(const void* maps, const void* gmaps, const void* scratch,
                    const Geo& g, const ProdArgs& a, cudaStream_t s) {
  CUtensorMap ta{}, tm{}, tg{};
  int err = encode_scratch(&ta, scratch, a.n, a.L, kDepth, TA ? 64 : kTile);
  if (err == cudaSuccess) err = encode_maps(&tm, maps, g, kDepth);
  if (err == cudaSuccess) err = encode_maps(&tg, gmaps, g, kDepth);
  if (err != cudaSuccess) return err;
  constexpr int kRing = prod_ring<NU>();
  const int smem = kRing * (kHalf + NU * kBoxBytes) + 16 * kRing + 1024;
  const int jobs = (a.which ? 9 + 4 * a.rate * a.rate : 9) * a.ncb;
  return launch(products_kernel<NU, TA>,
                dim3(static_cast<unsigned>(a.tiles),
                     static_cast<unsigned>(jobs),
                     static_cast<unsigned>(a.n)),
                smem, s, ta, tm, tg, a);
}

template <int NU>
int dispatch_products(const void* maps, const void* gmaps,
                      const void* scratch, const Geo& g, const ProdArgs& a,
                      cudaStream_t s) {
  if (a.which == 0)
    return launch_products<NU, 0>(maps, gmaps, scratch, g, a, s);
  return launch_products<NU, 1>(maps, gmaps, scratch, g, a, s);
}

}  // namespace mat

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

template <bool kDq>
int dispatch(const Args& a, int is_bf16, int group) {
  if (a.C % 4 != 0 || a.rate < 1 || a.hs < 1 || a.ws < 1 || a.B < 1)
    return cudaErrorInvalidValue;
  if (is_bf16) return dispatch_core<bf16, kDq>(group, a);
  return dispatch_core<float, kDq>(group, a);
}

}  // namespace

// All return a cudaError_t (0 on success).
//
// core variant: group = rows (query cells, or key cells) per block.
extern "C" int gi_attention_bwd_dq(const void* maps, const void* gmaps,
                                   const float* bias, const float* rnorm,
                                   const float* lse, const void* o_taps,
                                   float* delta, float* dq_taps, int B,
                                   int hs, int ws, int C, int rate,
                                   float scale, int is_bf16, int group,
                                   void* stream) {
  const Args a = {maps, gmaps, bias, rnorm, lse, o_taps, delta, dq_taps,
                  nullptr, nullptr, B, hs, ws, C, rate, scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16, group);
}

extern "C" int gi_attention_bwd_dkv(const void* maps, const void* gmaps,
                                    const float* bias, const float* rnorm,
                                    const float* lse, float* delta,
                                    float* dk_taps, float* dv_taps,
                                    float* tnorm, int B, int hs, int ws,
                                    int C, int rate, float scale,
                                    int is_bf16, int group, void* stream) {
  const Args a = {maps, gmaps, bias, rnorm, lse, nullptr, delta, dk_taps,
                  dv_taps, tnorm, B, hs, ws, C, rate, scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16, group);
}

// wgmma variant, bf16 (see mat::takes). δ over B samples:
extern "C" int gi_attention_bwd_delta(const void* gmaps, const void* o_taps,
                                      float* delta, int B, int hs, int ws,
                                      int C, int rate, void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || rate < 1 || C < 8 || C % 8)
    return cudaErrorInvalidValue;
  const long long rows = 1LL * B * hs * ws;
  mat::delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gmaps), static_cast<const bf16*>(o_taps),
      delta, B, hs, ws, C, rate);
  return cudaGetLastError();
}

// score tiles of n samples (one chunk): scratch (2n, L, L) bf16 — dsr, then
// p —, tpart (n, L/128, L) float
extern "C" int gi_attention_bwd_scores(
    const void* maps, const void* gmaps, const float* bias,
    const float* rnorm, const float* lse, const float* delta, void* scratch,
    float* tpart, int n, int hs, int ws, int C, int rate, float scale,
    void* stream) {
  const mat::Geo g = {n, hs, ws, C, rate};
  const int L = hs * ws;
  if (!mat::takes(g)) return cudaErrorInvalidValue;
  mat::ScoreArgs a = {};
  a.n = n; a.hs = hs; a.ws = ws; a.cpt = (C + mat::kUnit - 1) / mat::kUnit;
  a.rate = rate;
  a.L = L; a.tiles = L / mat::kTile; a.scale = scale;
  a.bias = bias; a.rnorm = rnorm; a.lse = lse; a.delta = delta;
  a.scratch = static_cast<bf16*>(scratch); a.tpart = tpart;
  return mat::launch_scores(maps, gmaps, g, a,
                            static_cast<cudaStream_t>(stream));
}

// tap products of n samples from the scores' scratch: which 0 → dq taps
// into qk (n, 9, L, C); which 1 → dk taps into qk, dv taps into dv
// (n, 4r², L, C) and t into tnorm (n, L). units = channels per block / 64:
// 1, 2 or 3, dividing cpt = ⌈C / 64⌉.
extern "C" int gi_attention_bwd_products(
    const void* maps, const void* gmaps, const void* scratch,
    const float* tpart, float* qk, float* dv, float* tnorm, int n, int hs,
    int ws, int C, int rate, int which, int units, void* stream) {
  const mat::Geo g = {n, hs, ws, C, rate};
  const int L = hs * ws;
  const int cpt = (C + mat::kUnit - 1) / mat::kUnit;
  if (!mat::takes(g) || (which != 0 && which != 1) || units < 1 ||
      units > 3 || cpt % units != 0)
    return cudaErrorInvalidValue;
  mat::ProdArgs a = {};
  a.n = n; a.hs = hs; a.ws = ws; a.C = C; a.cpt = cpt; a.rate = rate;
  a.L = L;
  a.tiles = L / mat::kTile; a.which = which; a.ncb = cpt / units;
  a.tpart = tpart; a.tnorm = tnorm; a.qk = qk; a.dv = dv;
  const auto s = static_cast<cudaStream_t>(stream);
  if (units == 3)
    return mat::dispatch_products<3>(maps, gmaps, scratch, g, a, s);
  if (units == 2)
    return mat::dispatch_products<2>(maps, gmaps, scratch, g, a, s);
  return mat::dispatch_products<1>(maps, gmaps, scratch, g, a, s);
}
