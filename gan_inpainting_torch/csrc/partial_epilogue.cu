// Partial-convolution epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _partial_epilogue_kernel of
// gan_inpainting_tpu/ops/pallas/fused_matmul.py. Per output pixel m of the
// raw feature conv (M = B·Ho·Wo pixels, C channels, T = float or
// __nv_bfloat16) with its float32 window count cnt[m]:
//   scale    = area / max(cnt, 1)  where cnt > 0, else 0
//   y[m, c]  = raw[m, c] · scale + bias[c]   where cnt > 0, else exactly 0
//   valid[m] = 1 where cnt > 0, else 0       (in T)
// The activation is not part of it: the layer applies it afterwards, as in
// the JAX package.
//
// One pass: every raw element is read once and every y element written
// once, so the kernel is bounded by bytes (2·M·C·sizeof(T) + 8·M). A thread
// owns one 16-byte vector of a pixel's channels (8 bf16 or 4 float), so
// reads and writes of a warp are contiguous; arithmetic is float32 and the
// result is rounded once. Channel counts that are no multiple of the vector
// width take the same kernel with one element per thread.
#include "common.cuh"

namespace {

template <typename T, int V>
__global__ void partial_epilogue_kernel(const T* __restrict__ raw,
                                        const float* __restrict__ cnt,
                                        const float* __restrict__ bias,
                                        T* __restrict__ y,
                                        T* __restrict__ valid, long long M,
                                        int C, float area) {
  const int per_pixel = C / V;
  const long long total = M * per_pixel;
  const long long stride = 1LL * gridDim.x * blockDim.x;
  for (long long idx = 1LL * blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long m = idx / per_pixel;
    const int c = static_cast<int>(idx - m * per_pixel) * V;
    const float n = cnt[m];
    const bool any = n > 0.f;
    const float scale = any ? area / fmaxf(n, 1.f) : 0.f;
    const T* src = raw + m * C + c;
    T* dst = y + m * C + c;
    if constexpr (V == 1) {
      const float v = gi::to_float(src[0]) * scale + bias[c];
      dst[0] = gi::from_float<T>(any ? v : 0.f);
    } else {
      // one 16-byte vector: V elements of T
      uint4 in = *reinterpret_cast<const uint4*>(src);
      uint4 out;
      const T* e = reinterpret_cast<const T*>(&in);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = gi::to_float(e[j]) * scale + bias[c + j];
        o[j] = gi::from_float<T>(any ? v : 0.f);
      }
      *reinterpret_cast<uint4*>(dst) = out;
    }
    if (c == 0) valid[m] = gi::from_float<T>(any ? 1.f : 0.f);
  }
}

template <typename T, int V>
int launch(const void* raw, const float* cnt, const float* bias, void* y,
           void* valid, long long M, int C, float area, cudaStream_t s) {
  const long long total = M * (C / V);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  partial_epilogue_kernel<T, V><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(raw), cnt, bias, static_cast<T*>(y),
      static_cast<T*>(valid), M, C, area);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). raw and y: (M, C) contiguous; cnt:
// (M,) float32; bias: (C,) float32; valid: (M,) in raw's type.
extern "C" int gi_partial_epilogue(const void* raw, const float* cnt,
                                   const float* bias, void* y, void* valid,
                                   long long M, int C, float area,
                                   int is_bf16, void* stream) {
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (C % 8 == 0)
      return launch<__nv_bfloat16, 8>(raw, cnt, bias, y, valid, M, C, area, s);
    return launch<__nv_bfloat16, 1>(raw, cnt, bias, y, valid, M, C, area, s);
  }
  if (C % 4 == 0)
    return launch<float, 4>(raw, cnt, bias, y, valid, M, C, area, s);
  return launch<float, 1>(raw, cnt, bias, y, valid, M, C, area, s);
}
