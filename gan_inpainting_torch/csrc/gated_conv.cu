// Gated convolution with the epilogue fused, for Hopper (sm_90a).
//
// Two entry points over one mainloop and one epilogue:
//   gi_gated_conv_direct  replaces the Pallas kernel _kernel of
//     gan_inpainting_tpu/ops/pallas/direct_conv.py (implicit GEMM, stride 1,
//     odd window, any dilation: no im2col in device memory);
//   gi_gated_matmul       replaces _gated_matmul_kernel of
//     gan_inpainting_tpu/ops/pallas/fused_matmul.py ((M, K) rows of a
//     materialized im2col times the packed weights, any stride).
// Both compute, for output pixel m and feature n < F,
//   out[m, n] = act(Σ_k A[m, k]·Wf[k, n] + bf[n])
//               · sigmoid(Σ_k A[m, k]·Wg[k, n] + bg[n])
// with A the (implicit or materialized) im2col row of pixel m in (tap,
// channel) order, so the 2F-channel pre-activation never reaches device
// memory. ELU is x > 0 ? x : expm1f(x) (the Pallas kernels write
// exp(min(x, 0)) − 1, the XLA path expm1; they differ by rounding only).
//
// What bounds it on an H100: operations (2·M·K·2F against 989 TFLOP/s in
// bf16) at every width of the generators but the thin stem. The TPU kernel
// keeps a row group plus its dilation halo resident in fast memory; a
// halo'd tile at dilation 16 does not fit a block's shared memory here, so
// a block owns 128 output pixels × BN features and walks K = k²·Cin in
// chunks of KC: per chunk it stages the (128 × KC) slice of A, gathered in
// 16-byte vectors at each tap's shifted addresses with zeros outside the
// map, and the matching (KC × 2·BN) slices of both weight halves. Reuse
// across taps and across neighbouring blocks comes from L2. The stages
// form a ring of three filled by cp.async, so the loads of chunks i + 1
// and i + 2 are in flight while chunk i is multiplied (a first version
// that loaded and multiplied in turns spent most of its time waiting on
// L2 latency). Two float32 accumulators (feature half and gate half of
// the same columns) stay in registers until the epilogue. Variants:
//   * bf16: tensor-core WMMA tiles (m16n16k16, mma.sync), 8 warps as 4 × 2,
//     each warp 32 pixels × BN/2 features × 2 halves;
//   * float32: CUDA cores, each thread 8 pixels × BN/16 features × 2
//     halves (full float32 products; TF32 would miss the tolerance).
// The weights arrive packed as (K_pad, 2, FP): K in (tap, channel) order
// padded with zero rows to whole chunks, half 0 = features, half 1 = gate,
// F padded with zero columns to a multiple of BN, so weight loads need no
// masks. Cin is a multiple of the 16-byte vector (the wrapper pads the
// 4-channel stem input and its weights with zero channels), so a vector
// never straddles two taps, while a chunk may. No wgmma or TMA yet.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output pixels per block

struct Geom {
  int H, W, Cin;        // input map (for the matmul entry: 1, M, K)
  int Ho, Wo;           // output map
  int F, FP;            // features per half, and padded to BN
  int k, stride, dil;   // window, stride, dilation
  int pad_y, pad_x;     // low-side TF-SAME pads
  int K;                // k·k·Cin
  int n_chunks;         // chunks of KC (n_chunks·KC = K_pad)
  int act;              // 0 none, 1 elu, 2 relu, 3 leaky_relu(0.2), 4 tanh
  long long M;          // B·Ho·Wo
};

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int KC = 64, PAD = 8, VEC = 8;
};
template <> struct Cfg<float> {
  static constexpr int KC = 32, PAD = 4, VEC = 4;
};
constexpr int kStages = 3;

// 16 bytes global → shared without passing through registers; n_bytes = 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float activate(float a, int act) {
  switch (act) {
    case 1: return a > 0.f ? a : expm1f(a);
    case 2: return fmaxf(a, 0.f);
    case 3: return a > 0.f ? a : 0.2f * a;
    case 4: return tanhf(a);
    default: return a;
  }
}

__device__ __forceinline__ float gated(float f, float g, int act) {
  return activate(f, act) * (1.f / (1.f + expf(-g)));
}

// Start the copies of chunk `chunk` of A (kBM × KC) and of both weight
// halves (KC × 2·BN) into one stage. Every thread owns the same vector
// column of A in each of its rows, so the tap is decoded once per chunk.
template <typename T, int BN>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x,
                                           const T* __restrict__ wp,
                                           const Geom& g, int chunk, int n0,
                                           T* As, T* Bs, const int* rows) {
  constexpr int VEC = Cfg<T>::VEC, KC = Cfg<T>::KC;
  constexpr int LDA = KC + Cfg<T>::PAD;
  constexpr int LDB = 2 * BN + Cfg<T>::PAD;
  constexpr int VPR = KC / VEC;                 // vectors per A row
  static_assert(kThreads % VPR == 0 && (kBM * VPR) % kThreads == 0, "");
  const int tid = threadIdx.x;
  const int kk0 = chunk * KC;
  {
    const int cv = tid % VPR;
    const int kk = kk0 + cv * VEC;
    const bool live = kk < g.K;
    const int tap = kk / g.Cin;
    const int c = kk - tap * g.Cin;
    const int ky = tap / g.k;
    const int dy = ky * g.dil, dx = (tap - ky * g.k) * g.dil;
#pragma unroll
    for (int i = 0; i < kBM * VPR / kThreads; ++i) {
      const int r = tid / VPR + i * (kThreads / VPR);
      const int b = rows[3 * r];
      const int iy = rows[3 * r + 1] + dy, ix = rows[3 * r + 2] + dx;
      const bool in = live && b >= 0 && iy >= 0 && iy < g.H && ix >= 0 &&
                      ix < g.W;
      const T* src =
          in ? x + ((static_cast<size_t>(b) * g.H + iy) * g.W + ix) * g.Cin +
                   c
             : x;
      cp_async16(As + r * LDA + cv * VEC, src, in ? 16 : 0);
    }
  }
  constexpr int VPRB = 2 * BN / VEC;
  static_assert((KC * VPRB) % kThreads == 0, "");
#pragma unroll
  for (int i = 0; i < KC * VPRB / kThreads; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / VPRB;
    const int col = (v - r * VPRB) * VEC;      // column of [features | gate]
    const int h = col / BN, c = col - h * BN;
    cp_async16(Bs + r * LDB + col,
               wp + (static_cast<size_t>(kk0 + r) * 2 + h) * g.FP + n0 + c,
               16);
  }
}

template <typename T, int BN>
struct Smem {
  static constexpr int LDA = Cfg<T>::KC + Cfg<T>::PAD;
  static constexpr int LDB = 2 * BN + Cfg<T>::PAD;
  static constexpr int A_BYTES = kBM * LDA * static_cast<int>(sizeof(T));
  static constexpr int B_BYTES =
      Cfg<T>::KC * LDB * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ROW_BYTES = kBM * 3 * static_cast<int>(sizeof(int));
  static constexpr int BYTES = kStages * STAGE_BYTES + ROW_BYTES;
};

// epilogue staging of the WMMA variant: per warp two 16×16 float tiles
constexpr int kStageLd = 20;
constexpr int kStageTile = 16 * kStageLd;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2)
gated_conv_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                  const float* __restrict__ bias, T* __restrict__ out,
                  const Geom g) {
  using S = Smem<T, BN>;
  constexpr int LDA = S::LDA, LDB = S::LDB, KC = Cfg<T>::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem + kStages * S::STAGE_BYTES);
  unsigned char* const ring = smem;
  auto stage_a = [ring](int slot) {
    return reinterpret_cast<T*>(ring + slot * S::STAGE_BYTES);
  };
  auto stage_b = [ring](int slot) {
    return reinterpret_cast<T*>(ring + slot * S::STAGE_BYTES + S::A_BYTES);
  };

  const int tid = threadIdx.x;
  const long long m0 = 1LL * blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // each row's image and the top-left input position of its window
  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    if (m < g.M) {
      const int ox = static_cast<int>(m % g.Wo);
      const long long t = m / g.Wo;
      const int oy = static_cast<int>(t % g.Ho);
      rows[3 * r] = static_cast<int>(t / g.Ho);
      rows[3 * r + 1] = oy * g.stride - g.pad_y;
      rows[3 * r + 2] = ox * g.stride - g.pad_x;
    } else {
      rows[3 * r] = -1;
    }
  }
  __syncthreads();

  // fill the ring with chunks 0 … kStages − 2: one commit group each (empty
  // past the last chunk), so the waits in the loops count uniformly
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g.n_chunks)
      load_tiles<T, BN>(x, wp, g, s, n0, stage_a(s), stage_b(s), rows);
    cp_async_commit();
  }

  if constexpr (std::is_same<T, bf16>::value) {
    // ---- tensor cores: warp (wm, wn) owns 32 pixels × WN features ------
    constexpr int WN = BN / 2, NI = WN / 16;
    static_assert(8 * 2 * kStageTile * 4 <= kStages * S::STAGE_BYTES,
                  "epilogue staging must fit the tiles it aliases");
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp & 3, wn = warp >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> accf[2][NI];
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> accg[2][NI];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        wmma::fill_fragment(accf[mi][ni], 0.f);
        wmma::fill_fragment(accg[mi][ni], 0.f);
      }
    for (int chunk = 0; chunk < g.n_chunks; ++chunk) {
      // chunk's copies have landed, and every warp is done with the stage
      // that chunk + kStages − 1 is about to overwrite
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int ahead = chunk + kStages - 1;
      if (ahead < g.n_chunks)
        load_tiles<T, BN>(x, wp, g, ahead, n0, stage_a(ahead % kStages),
                          stage_b(ahead % kStages), rows);
      cp_async_commit();
      const T* As = stage_a(chunk % kStages);
      const T* Bs = stage_b(chunk % kStages);
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wmma::load_matrix_sync(a[mi], As + (wm * 32 + mi * 16) * LDA + ks,
                                 LDA);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const T* bp = Bs + ks * LDB + wn * WN + ni * 16;
          wmma::load_matrix_sync(b, bp, LDB);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            wmma::mma_sync(accf[mi][ni], a[mi], b, accf[mi][ni]);
          wmma::load_matrix_sync(b, bp + BN, LDB);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            wmma::mma_sync(accg[mi][ni], a[mi], b, accg[mi][ni]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // ---- epilogue through a per-warp staging tile (aliases the stages;
    // every warp has left the loop) ----------------------------------------
    float* stage = reinterpret_cast<float*>(smem) + warp * 2 * kStageTile;
    const int r = lane >> 1, cb = (lane & 1) * 8;
    const bool vec_store = (g.F % 8) == 0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        wmma::store_matrix_sync(stage, accf[mi][ni], kStageLd,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(stage + kStageTile, accg[mi][ni], kStageLd,
                                wmma::mem_row_major);
        __syncwarp();
        const long long m = m0 + wm * 32 + mi * 16 + r;
        const int n = n0 + wn * WN + ni * 16 + cb;
        if (m < g.M && n < g.F) {
          const float* sf = stage + r * kStageLd + cb;
          const float* sg = sf + kStageTile;
          T* dst = out + m * g.F + n;
          if (vec_store) {
            uint4 packed;
            T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              o[j] = gi::from_float<T>(gated(sf[j] + bias[n + j],
                                             sg[j] + bias[g.F + n + j],
                                             g.act));
            *reinterpret_cast<uint4*>(dst) = packed;
          } else {
            for (int j = 0; j < 8 && n + j < g.F; ++j)
              dst[j] = gi::from_float<T>(gated(sf[j] + bias[n + j],
                                               sg[j] + bias[g.F + n + j],
                                               g.act));
          }
        }
        __syncwarp();
      }
  } else {
    // ---- CUDA cores: thread (tx, ty) owns pixels ty + 16·i, i < 8, and
    // features tx·TN … tx·TN + TN − 1 of both halves ----------------------
    constexpr int TN = BN / 16;
    const int tx = tid & 15, ty = tid >> 4;
    float accf[8][TN], accg[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accf[i][j] = accg[i][j] = 0.f;
    for (int chunk = 0; chunk < g.n_chunks; ++chunk) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int ahead = chunk + kStages - 1;
      if (ahead < g.n_chunks)
        load_tiles<T, BN>(x, wp, g, ahead, n0, stage_a(ahead % kStages),
                          stage_b(ahead % kStages), rows);
      cp_async_commit();
      const T* As = stage_a(chunk % kStages);
      const T* Bs = stage_b(chunk % kStages);
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[8], wf[TN], wg[TN];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          wf[j] = Bs[kk * LDB + tx * TN + j];
          wg[j] = Bs[kk * LDB + BN + tx * TN + j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            accf[i][j] = fmaf(a[i], wf[j], accf[i][j]);
            accg[i][j] = fmaf(a[i], wg[j], accg[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n < g.F)
          out[m * g.F + n] = gated(accf[i][j] + bias[n],
                                   accg[i][j] + bias[g.F + n], g.act);
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* x, const void* wp, const float* bias, void* out,
           const Geom& g, cudaStream_t s) {
  const long long bx = (g.M + kBM - 1) / kBM;
  if (bx > 0x7fffffffLL || g.FP / BN > 65535) return cudaErrorInvalidValue;
  auto kernel = gated_conv_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<T, BN>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(g.FP / BN));
  kernel<<<grid, kThreads, Smem<T, BN>::BYTES, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), bias,
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

int run(const void* x, const void* wp, const float* bias, void* out, Geom g,
        int BN, int is_bf16, cudaStream_t s) {
  const int kc = is_bf16 ? Cfg<bf16>::KC : Cfg<float>::KC;
  const int vec = is_bf16 ? Cfg<bf16>::VEC : Cfg<float>::VEC;
  if (g.M < 1 || g.Cin < 1 || g.Cin % vec || g.F < 1 || g.k < 1 ||
      (BN != 32 && BN != 64) || g.FP % BN || g.F > g.FP || g.act < 0 ||
      g.act > 4)
    return cudaErrorInvalidValue;
  g.K = g.k * g.k * g.Cin;
  g.n_chunks = (g.K + kc - 1) / kc;
  if (is_bf16) {
    if (BN == 64) return launch<bf16, 64>(x, wp, bias, out, g, s);
    return launch<bf16, 32>(x, wp, bias, out, g, s);
  }
  if (BN == 64) return launch<float, 64>(x, wp, bias, out, g, s);
  return launch<float, 32>(x, wp, bias, out, g, s);
}

}  // namespace

// Both return a cudaError_t (0 on success). x: (B, H, W, Cin) contiguous,
// Cin a multiple of 8 (bf16) or 4 (float32); wp: (K_pad, 2, FP) packed
// weights in x's type, K_pad = K rounded up to 64 (bf16) or 32 (float32)
// rows; bias: (2F,) float32, features first; out: (B, H, W, F). Stride 1,
// odd k, symmetric TF-SAME pad (k − 1)·dil / 2.
extern "C" int gi_gated_conv_direct(const void* x, const void* wp,
                                    const float* bias, void* out, int B,
                                    int H, int W, int Cin, int F, int FP,
                                    int BN, int k, int dil, int act,
                                    int is_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || k % 2 == 0 || dil < 1)
    return cudaErrorInvalidValue;
  Geom g{};
  g.H = H; g.W = W; g.Cin = Cin; g.Ho = H; g.Wo = W; g.F = F; g.FP = FP;
  g.k = k; g.stride = 1; g.dil = dil;
  g.pad_y = g.pad_x = (k - 1) * dil / 2;
  g.act = act;
  g.M = 1LL * B * H * W;
  return run(x, wp, bias, out, g, BN, is_bf16,
             static_cast<cudaStream_t>(stream));
}

// x2d: (M, K) contiguous rows of a materialized im2col, K a multiple of the
// vector; wp: (K_pad, 2, FP); out: (M, F). The rows are a 1×1 "conv" over a
// 1 × M map of K channels.
extern "C" int gi_gated_matmul(const void* x2d, const void* wp,
                               const float* bias, void* out, long long M,
                               int K, int F, int FP, int BN, int act,
                               int is_bf16, void* stream) {
  if (M < 1 || M > 0x7fffffffLL) return cudaErrorInvalidValue;
  Geom g{};
  g.H = 1; g.W = static_cast<int>(M); g.Cin = K; g.Ho = 1;
  g.Wo = static_cast<int>(M); g.F = F; g.FP = FP;
  g.k = 1; g.stride = 1; g.dil = 1; g.pad_y = g.pad_x = 0;
  g.act = act;
  g.M = M;
  return run(x2d, wp, bias, out, g, BN, is_bf16,
             static_cast<cudaStream_t>(stream));
}
