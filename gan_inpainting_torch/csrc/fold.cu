// Overlap-add fold of tap-major attention patches, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _fold_kernel of
// gan_inpainting_tpu/ops/pallas/fold.py. Input taps (B, 4r², hs·ws, C) in
// T (float or __nv_bfloat16): tap (p, q) of cell (i, j) is the patch
// element at window offset (p, q) of a 2r×2r window at stride r, SAME
// padded (lo = r//2). Output (B, r·hs, r·ws, C) in T:
//   out[b, y, x, c] = inv[y, x] · Σ taps[b, p·2r + q, i·ws + j, c]
// over the (p, q, i, j) with y = r·i + p − r//2 and x = r·j + q − r//2 —
// two (p, i) pairs per axis, so four terms. inv = 1 / max(count, 1), the
// reciprocal overlap counts (a geometry constant the wrapper computes).
//
// One thread per four output channels of one pixel (C % 4 == 0), channels
// fastest, so the 8- or 16-byte reads of each tap and the write are
// coalesced; 32-bit index math (the wrapper bounds the element count).
// Every input element is read once and every output written once, so it
// is bounded by bytes; the sum is float32.
#include "common.cuh"

namespace {

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T>
__global__ void fold_kernel(const T* __restrict__ taps,
                            const float* __restrict__ inv,
                            T* __restrict__ out, int B, int hs, int ws,
                            int C, int rate) {
  const int H = rate * hs, W = rate * ws, L = hs * ws;
  const int n_taps = 4 * rate * rate;
  const int half = rate / 2;
  const int C4 = C / 4;
  const int total = B * H * W * C4;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int c = (idx % C4) * 4;
    const int pix = idx / C4;
    const int x = pix % W;
    const int y = (pix / W) % H;
    const int b = pix / (W * H);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < 2 * rate; ++p) {
      const int ny = y + half - p;  // = r·i
      if (ny < 0 || ny % rate) continue;
      const int i = ny / rate;
      if (i >= hs) continue;
      for (int q = 0; q < 2 * rate; ++q) {
        const int nx = x + half - q;
        if (nx < 0 || nx % rate) continue;
        const int j = nx / rate;
        if (j >= ws) continue;
        const float4 v = gi::load4(
            taps + (static_cast<size_t>(b * n_taps + p * 2 * rate + q) * L
                    + i * ws + j) * C + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    const float s = inv[y * W + x];
    store4(out + static_cast<size_t>(pix) * C + c,
           make_float4(acc.x * s, acc.y * s, acc.z * s, acc.w * s));
  }
}

template <typename T>
int launch(const void* taps, const float* inv, void* out, int B, int hs,
           int ws, int C, int rate, cudaStream_t stream) {
  const long long total = 1LL * B * rate * hs * rate * ws * (C / 4);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  fold_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(taps), inv, static_cast<T*>(out), B, hs, ws, C,
      rate);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int gi_fold_taps(const void* taps, const float* inv, void* out,
                            int B, int hs, int ws, int C, int rate,
                            int is_bf16, void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || C < 4 || C % 4 != 0 || rate < 1 ||
      1LL * B * rate * hs * rate * ws * C >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(taps, inv, out, B, hs, ws, C, rate, s);
  return launch<float>(taps, inv, out, B, hs, ws, C, rate, s);
}
