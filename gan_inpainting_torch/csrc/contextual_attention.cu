// Fused contextual attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _fused_kernel_singlek and _fused_kernel of
// gan_inpainting_tpu/ops/pallas/fused_attention.py.
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
// Two variants:
//   * wgmma (bf16; C % 32 == 0, ws 32, 64 or a multiple of 128, Lk % 128
//     == 0 — the serve and train maps): gi_fused_attention_wgmma, the
//     cluster mainloop of attention_wgmma.cuh with its kFused producer
//     (TMA boxes of shifted cell windows of the maps), a flash recurrence
//     over 128-key steps, so any map size;
//   * core (any shape, float32 or bf16): gi_fused_attention below. One
//     block = one image × a group of G query cells, 256 threads, 3 steps:
//     1. scores S[G][Lk] (float) in shared memory, as 9 shifted
//        C-contractions of the query and key taps, CUDA-core FMAs with the
//        group's Q rows of a tap staged in shared memory;
//     2. s = S·(rnorm·scale) + bias, softmax per row by one warp, p zeroed
//        on hole keys, rows with no valid key left all zero (l > 0 guard);
//        p rounded to T as the TPU kernel rounds it before the PV product;
//     3. the 4r² tap products P·V_tap, V_tap read from the parity map at
//        cell offset (par, off), each thread owning (tap, channel) pairs.
//     The whole score rows sit in shared memory, so the wrapper sizes the
//     group from Lk and refuses an Lk it cannot hold.
// Accumulation is float32 throughout.
//
// Bound on this card: 2·Lq·Lk·25·C operations per image (10.1 GFLOP at the
// 256² serve shape) against a few MB of maps and output, so it is bounded
// by operations (989 TFLOP/s bf16).
#include <cooperative_groups.h>
#include <math_constants.h>

#include "attention_wgmma.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
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

}  // namespace

// The CUDA-core variant. Returns a cudaError_t (0 on success). group =
// query cells per block; lse may be null (no log-sum-exp written).
extern "C" int gi_fused_attention(const void* maps, const float* bias,
                                  const float* rnorm, void* out, float* lse,
                                  int B, int hs, int ws, int C, int rate,
                                  float scale, int is_bf16, int group,
                                  void* stream) {
  if (C % 4 != 0 || rate < 1 || hs < 1 || ws < 1 || B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_core<bf16>(group, maps, bias, rnorm, out, lse, B, hs, ws,
                               C, rate, scale, s);
  return dispatch_core<float>(group, maps, bias, rnorm, out, lse, B, hs, ws,
                              C, rate, scale, s);
}

// The bf16 forward on wgmma fed by TMA (attention_wgmma.cuh, kFused):
// C % 32 == 0; ws 32, 64 or a multiple of 128; hs·ws % 128 == 0; cluster
// 1, 2, 4 or 8 blocks, enough that each holds ≤ 4 of the 9·⌈C/64⌉ d units
// and ≤ 6 of the 4r²·⌈C/64⌉ dv units. The maps keep their real C as the
// tensor maps' innermost size, so a tap's last unit reads zeros past C
// (TMA's out-of-bounds fill). Returns a cudaError_t (0 on success).
extern "C" int gi_fused_attention_wgmma(const void* maps, const float* bias,
                                        const float* rnorm, void* out,
                                        float* lse, int B, int hs, int ws,
                                        int C, int rate, float scale,
                                        int cluster, void* stream) {
  if (B < 1 || hs < 1 || rate < 1 || C < 32 || C % 32 != 0 ||
      !(ws == 32 || ws == 64 || (ws > 0 && ws % 128 == 0)) ||
      (hs * ws) % 128 != 0)
    return cudaErrorInvalidValue;
  const int L = hs * ws;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(ws + 2),
                              static_cast<cuuint64_t>(hs + 2),
                              static_cast<cuuint64_t>(B) * rate * rate};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(C) * 2,
      static_cast<cuuint64_t>(ws + 2) * C * 2,
      static_cast<cuuint64_t>(hs + 2) * (ws + 2) * C * 2};
  const int qbx = ws < 64 ? ws : 64, kbx = ws < 128 ? ws : 128;
  const cuuint32_t box_q[4] = {64, static_cast<cuuint32_t>(qbx),
                               static_cast<cuuint32_t>(64 / qbx), 1};
  const cuuint32_t box_k[4] = {64, static_cast<cuuint32_t>(kbx),
                               static_cast<cuuint32_t>(128 / kbx), 1};
  CUtensorMap tq{}, tk{};
  int err = gi::attn::encode_map(&tq, maps, 4, dims, strides, box_q);
  if (err != cudaSuccess) return err;
  err = gi::attn::encode_map(&tk, maps, 4, dims, strides, box_k);
  if (err != cudaSuccess) return err;
  gi::attn::Params p{};
  p.B = B;
  p.Lq = p.Lk = L;
  p.d = 9 * C;
  p.dv = 4 * rate * rate * C;
  p.cpt = (C + 63) / 64;
  p.n1 = 9 * p.cpt;
  p.n2 = 4 * rate * rate * p.cpt;
  p.ws = ws;
  p.C = C;
  p.rate = rate;
  p.scale = scale;
  p.bias = bias;
  p.rnorm = rnorm;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  return gi::attn::launch<gi::attn::kFused>(tq, tk, tk, p, cluster,
                                            static_cast<cudaStream_t>(stream));
}
