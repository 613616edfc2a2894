// Overlap-add folds onto the feature map, for Hopper (sm_90a): the fused
// attention forward's tap-major output (gi_fold_taps) and its backward's
// per-tap gradients (gi_fold_tap_grads). Both are gathers of shifted cell
// planes onto the map: every input element feeds one output pixel, every
// output is written once, so on an H100 they are bounded by bytes (3.35
// TB/s). Each is a one-pass stream: one 16-byte vector of one output pixel
// per thread, its sources' addresses from a closed form (no loop over
// window offsets), all of its loads issued before its adds, read-once
// inputs through the streaming load path (__ldcs, evict first), float32
// sums in a fixed order, the output stored once with the default policy
// (the next layer reads it). No atomics: the same inputs give the same
// bits on every run.
//
// gi_fold_taps replaces the Pallas kernel _fold_kernel of
// gan_inpainting_tpu/ops/pallas/fold.py:32. Taps (B, 4r², hs·ws, C) in T
// (float or __nv_bfloat16): tap (p, q) of cell (i, j) is the patch element
// at window offset (p, q) of a 2r×2r window at stride r, SAME padded (lo =
// r//2). Output (B, r·hs, r·ws, C) in T:
//   out[b, y, x, c] = inv(y, x) · Σ taps[b, p·2r + q, i·ws + j, c]
// over y = r·i + p − r//2, x = r·j + q − r//2. With ny = y + r//2 the two
// (p, i) candidates of a row are (ny % r, ny / r) and (ny % r + r,
// ny / r − 1), each valid where 0 ≤ i < hs; the same for x. A block takes
// one output row, so the row's pair is block-uniform; a thread's column
// pair is one division. inv = 1 / (valid rows · valid columns) is 1, ½ or
// ¼, exact, so no count plane is read.
//
// gi_fold_tap_grads replaces the scatter that _bwd_dq_kernel and
// _bwd_dkv_kernel (gan_inpainting_tpu/ops/pallas/fused_attention_bwd.py
// :148, :223) do in-kernel, with the XLA epilogue around them
// (_merge_row_blocks :311, _norm_correction :328, the crop and the inverse
// parity transpose). Inputs: the forward's halo-padded parity maps (B, r,
// r, hs+2, ws+2, C) in T, of which the (0, 0) map b00 is read; the float32
// tap gradients dq, dk (B, 9, L, C) and dv (B, 4r², L, C); tnorm and rnorm
// (B, L). Output pixel (y, x) has parity (y % r, x % r) and padded cell
// (I, J) = (y / r + 1, x / r + 1). A parity-(0, 0) pixel sums, for each
// Q/K tap t = (dp, dq) whose source cell (I − dp, J − dq) exists, dq_t +
// dk_t and the key-norm term −scale·tnorm·rnorm³·[rnorm < 1e4] of that
// cell times b00[I, J]; every pixel then sums its 4 value taps (vp, vq)
// with vp ≡ y % r + r//2 (mod r), vq likewise, from cell (I − op, J − oq),
// op = (vp − r//2) div r + 1 — the order of fold_tap_grads_plain. The
// threads of a row walk its pixels by column parity, so a warp's lanes
// take pixels of one parity and the 31-source pixels do not hold up the
// 4-source ones. The gradient is written once, in T.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// N consecutive elements of T as one aligned vector
template <typename T, int N>
struct alignas(N * sizeof(T)) Vec {
  T v[N];
};

template <typename T, int N>
using RawOf = typename Raw<N * sizeof(T)>::type;

template <typename T, int N>
__device__ __forceinline__ RawOf<T, N> load_stream(const T* p) {
  return __ldcs(reinterpret_cast<const RawOf<T, N>*>(p));
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float* acc) {
  Vec<T, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = gi::from_float<T>(acc[k]);
  *reinterpret_cast<Vec<T, N>*>(p) = o;
}

template <typename T, int N>
__device__ __forceinline__ void add(float* acc, const RawOf<T, N>& raw) {
  const Vec<T, N>& a = *reinterpret_cast<const Vec<T, N>*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] += gi::to_float(a.v[k]);
}

__device__ __forceinline__ float4 load_stream4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ taps, T* __restrict__ out, int H, int W,
            int hs, int ws, int C, int rate) {
  const int row = blockIdx.x;                    // b·H + y
  const int b = row / H, y = row - b * H;
  const int cv = C / N;                          // vectors per pixel
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= W * cv) return;
  const int x = v / cv;
  const int c = (v - x * cv) * N;
  const long long plane = 1LL * hs * ws * C;     // one tap's cells
  const int win = 2 * rate;
  // the row's two (p, i): (p0, i0) and (p0 + r, i0 − 1), block-uniform
  const int ny = y + rate / 2;
  const int p0 = ny % rate, i0 = ny / rate;
  const bool r0 = i0 < hs, r1 = i0 >= 1;
  // the column's two (q, j)
  const int nx = x + rate / 2;
  const int q0 = nx % rate, j0 = nx / rate;
  const bool c0 = j0 < ws, c1 = j0 >= 1;
  const T* src = taps + 1LL * b * win * win * plane + c;
  const long long a0 = p0 * win * plane + 1LL * i0 * ws * C;
  const long long a1 = a0 + rate * win * plane - 1LL * ws * C;
  const long long b0 = q0 * plane + 1LL * j0 * C;
  const long long b1 = b0 + rate * plane - C;
  // all loads first (a missing term is a zero vector), then the sums in
  // the order (p0, q0), (p0, q1), (p1, q0), (p1, q1)
  RawOf<T, N> t[4] = {};
  if (r0 && c0) t[0] = load_stream<T, N>(src + a0 + b0);
  if (r0 && c1) t[1] = load_stream<T, N>(src + a0 + b1);
  if (r1 && c0) t[2] = load_stream<T, N>(src + a1 + b0);
  if (r1 && c1) t[3] = load_stream<T, N>(src + a1 + b1);
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) add<T, N>(acc, t[m]);
  const float inv = (r0 && r1 ? 0.5f : 1.f) * (c0 && c1 ? 0.5f : 1.f);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] *= inv;
  store<T, N>(out + (1LL * row * W + x) * C + c, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_fold_kernel(const T* __restrict__ maps,
                          const float* __restrict__ dq,
                          const float* __restrict__ dk,
                          const float* __restrict__ dv,
                          const float* __restrict__ tnorm,
                          const float* __restrict__ rnorm,
                          T* __restrict__ out, int hs, int ws, int C,
                          int rate, float scale) {
  constexpr int N = 4;                           // channels per thread
  const int H = rate * hs, W = rate * ws, L = hs * ws;
  const int row = blockIdx.x;                    // b·H + y
  const int b = row / H, y = row - b * H;
  const int cv = C / N;
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= W * cv) return;
  // v = (pq·ws + jx)·cv + channel vector: pixels by column parity
  const int per_parity = ws * cv;
  const int pq = v / per_parity;
  const int rem = v - pq * per_parity;
  const int jx = rem / cv;
  const int c = (rem - jx * cv) * N;
  const int pp = y % rate;
  const int I = y / rate + 1, J = jx + 1;        // padded cell
  const int x = jx * rate + pq;
  float acc[N] = {0.f, 0.f, 0.f, 0.f};

  if (pp == 0 && pq == 0) {
    // Q/K taps and the key-norm term: all loads, then the sums in tap order
    const int hp = hs + 2, wp = ws + 2;
    const float4 bv = gi::load4(
        maps + ((1LL * b * rate * rate * hp + I) * wp + J) * C + c);
    float4 g[9];
    float cm[9];
    bool ok[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int i = I - t / 3, j = J - t % 3;
      ok[t] = i >= 0 && i < hs && j >= 0 && j < ws;
      const int cell = ok[t] ? i * ws + j : 0;
      const long long off = (1LL * (b * 9 + t) * L + cell) * C + c;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv;
      float tn = 0.f, rn = 0.f;
      if (ok[t]) {
        qv = load_stream4(dq + off);
        kv = load_stream4(dk + off);
        tn = tnorm[1LL * b * L + cell];
        rn = rnorm[1LL * b * L + cell];
      }
      g[t] = make_float4(qv.x + kv.x, qv.y + kv.y, qv.z + kv.z,
                         qv.w + kv.w);
      const float coef = rn < 1e4f ? rn * rn * rn : 0.f;
      cm[t] = (-scale * tn) * coef;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (!ok[t]) continue;
      acc[0] = __fadd_rn(acc[0] + g[t].x, __fmul_rn(cm[t], bv.x));
      acc[1] = __fadd_rn(acc[1] + g[t].y, __fmul_rn(cm[t], bv.y));
      acc[2] = __fadd_rn(acc[2] + g[t].z, __fmul_rn(cm[t], bv.z));
      acc[3] = __fadd_rn(acc[3] + g[t].w, __fmul_rn(cm[t], bv.w));
    }
  }

  // the 4 value taps of parity (pp, pq), in tap order
  const int half = rate / 2;
  const int vp0 = (pp + half) % rate, vq0 = (pq + half) % rate;
  const int op0 = vp0 < half ? 0 : 1, oq0 = vq0 < half ? 0 : 1;
  const int n_taps = 4 * rate * rate;
  float4 d[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a = m >> 1, e = m & 1;
    const int i = I - op0 - a, j = J - oq0 - e;
    const int tap = (vp0 + a * rate) * 2 * rate + vq0 + e * rate;
    d[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= 0 && i < hs && j >= 0 && j < ws)
      d[m] = load_stream4(dv + (1LL * (b * n_taps + tap) * L + i * ws + j)
                                   * C + c);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    acc[0] += d[m].x;
    acc[1] += d[m].y;
    acc[2] += d[m].z;
    acc[3] += d[m].w;
  }
  store<T, N>(out + (1LL * row * W + x) * C + c, acc);
}

template <typename T, int N>
int launch_fold(const void* taps, void* out, int B, int hs, int ws, int C,
                int rate, cudaStream_t stream) {
  const int H = rate * hs, W = rate * ws;
  const dim3 grid(B * H, (W * (C / N) + kThreads - 1) / kThreads);
  fold_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), static_cast<T*>(out), H, W, hs, ws, C,
      rate);
  return cudaGetLastError();
}

template <typename T>
int launch_fold_tap_grads(const void* maps, const float* dq, const float* dk,
                          const float* dv, const float* tnorm,
                          const float* rnorm, void* out, int B, int hs,
                          int ws, int C, int rate, float scale,
                          cudaStream_t stream) {
  const int H = rate * hs, W = rate * ws;
  const dim3 grid(B * H, (W * (C / 4) + kThreads - 1) / kThreads);
  attention_bwd_fold_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(maps), dq, dk, dv, tnorm, rnorm,
      static_cast<T*>(out), hs, ws, C, rate, scale);
  return cudaGetLastError();
}

// the grid: B·H rows in x, a row's vectors in blocks of kThreads in y
bool grid_fits(int B, int hs, int ws, int C, int rate, int vec) {
  const long long rows = 1LL * B * rate * hs;
  const long long per_row = 1LL * rate * ws * (C / vec);
  return rows < (1LL << 31) && (per_row + kThreads - 1) / kThreads <= 65535
         && 1LL * rate * hs * rate * ws * C < (1LL << 31);
}

}  // namespace

// Returns a cudaError_t (0 on success). vec: elements per vector (16, 8,
// 4 or 2 bytes of T; the wrapper picks the widest that divides C and the
// pointers' alignment).
extern "C" int gi_fold_taps(const void* taps, void* out, int B, int hs,
                            int ws, int C, int rate, int is_bf16, int vec,
                            void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || C < 1 || rate < 1 || vec < 1 ||
      C % vec != 0 || !grid_fits(B, hs, ws, C, rate, vec))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (vec) {
      case 8: return launch_fold<__nv_bfloat16, 8>(taps, out, B, hs, ws, C,
                                                   rate, s);
      case 4: return launch_fold<__nv_bfloat16, 4>(taps, out, B, hs, ws, C,
                                                   rate, s);
      case 2: return launch_fold<__nv_bfloat16, 2>(taps, out, B, hs, ws, C,
                                                   rate, s);
      case 1: return launch_fold<__nv_bfloat16, 1>(taps, out, B, hs, ws, C,
                                                   rate, s);
    }
    return cudaErrorInvalidValue;
  }
  switch (vec) {
    case 4: return launch_fold<float, 4>(taps, out, B, hs, ws, C, rate, s);
    case 2: return launch_fold<float, 2>(taps, out, B, hs, ws, C, rate, s);
    case 1: return launch_fold<float, 1>(taps, out, B, hs, ws, C, rate, s);
  }
  return cudaErrorInvalidValue;
}

// Returns a cudaError_t (0 on success). C % 4 == 0; out (B, r·hs, r·ws, C)
// in the maps' type.
extern "C" int gi_fold_tap_grads(const void* maps, const float* dq,
                                 const float* dk, const float* dv,
                                 const float* tnorm, const float* rnorm,
                                 void* out, int B, int hs, int ws, int C,
                                 int rate, float scale, int is_bf16,
                                 void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || C < 4 || C % 4 != 0 || rate < 1 ||
      !grid_fits(B, hs, ws, C, rate, 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fold_tap_grads<__nv_bfloat16>(
        maps, dq, dk, dv, tnorm, rnorm, out, B, hs, ws, C, rate, scale, s);
  return launch_fold_tap_grads<float>(maps, dq, dk, dv, tnorm, rnorm, out, B,
                                      hs, ws, C, rate, scale, s);
}
