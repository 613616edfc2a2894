// Gated convolution with the epilogue fused, for Hopper (sm_90a).
//
// One entry point, gi_gated_conv, over any (B, H, W, Cin) map, window,
// stride, dilation and low-side TF-SAME pads. It replaces two Pallas
// kernels of the JAX package:
//   _kernel of gan_inpainting_tpu/ops/pallas/direct_conv.py (implicit GEMM,
//     stride 1, odd window, any dilation) — ops/kernels/direct_conv.py;
//   _gated_matmul_kernel of gan_inpainting_tpu/ops/pallas/fused_matmul.py
//     (rows of a materialized im2col, any stride) — ops/kernels/
//     gated_matmul.py, which passes the strided map itself: the kernel
//     reads the strided taps, so no im2col reaches device memory.
// Both compute, for output pixel m and feature n < F,
//   out[m, n] = act(Σ_k A[m, k]·Wf[k, n] + bf[n])
//               · sigmoid(Σ_k A[m, k]·Wg[k, n] + bg[n])
// with A the im2col row of pixel m in (tap, channel) order, so neither the
// patches nor the 2F-channel pre-activation reach device memory. ELU is
// x > 0 ? x : expm1f(x).
//
// What bounds it on an H100: operations (2·M·K·2F against 989 TFLOP/s in
// bf16) at every width of the generators but the thin stem — if the tiles
// are fed. The earlier design (WMMA, 8 warps, a cp.async ring) owned 128
// pixels × (64 + 64) columns per 64-deep K chunk: 32 KB filled from L2
// per 2.1 MFLOP, 64 FLOP per byte (43.7 at 32 + 32 columns), and its time
// followed those bytes: 2.047 ms at 192 → 2·192 3×3 64² B64 (170 TFLOP/s).
//
// bf16 mainloop (gated_wgmma_kernel). A block owns 128 output pixels ×
// N = 2·BF columns: BF features of one column block and the BF gate
// columns of the same features, so each thread holds a feature and its
// gate in its own registers and the epilogue needs no exchange. BF is 24,
// 48 or 96 (wgmma's N = 48, 96, 192); F > 96 takes ⌈F / 96⌉ column blocks
// (F = 192: two), ragged F is masked at the store. K is walked in slabs of
// 32 channels of one tap (64-byte rows, 64-byte swizzle) through a ring of
// kRing = 8 stages:
//   * one producer warpgroup (setmaxnreg down to 40): one thread issues per
//     slab a TMA box of A — (32 channels, pixels along W, rows, images) at
//     the tap's shifted coordinates of the (B, H, W, Cin) map, with zeros
//     outside it (the symmetric stride-1 pad, negative coordinates, and at
//     stride 2 elementStrides of 2 and the high-side pad as out-of-bounds
//     zeros) — and its slice of the B slab (rows of the packed weights,
//     K-major) multicast to every block of a cluster of C blocks along M,
//     so each block fetches only 1/C of B;
//   * two consumer warpgroups (setmaxnreg up to 232), 64 pixel rows each,
//     run wgmma.m64nNk16 with both operands read from shared memory by
//     descriptor and float32 accumulators in registers (N/2 per thread);
//   * "full" mbarriers carry the TMA bytes, "empty" mbarriers collect one
//     arrival per consumer warp of every block of the cluster, because a
//     block's producer writes into all of them. The remote arrivals keep
//     the default .cta release: with .release.cluster each one fenced, and
//     the first build took 4.8 ms at 192 → 2·192 (chip_smoke.py [2]);
//   * persistent: one cluster per co-resident slot walks tile groups, so
//     the producer fills the next tile's stages during the epilogue
//     (one block per tile spent as long on launch, fill and epilogue as on
//     tens of slabs, which the short-K forms felt most). The epilogue stays
//     in the consumers' registers: handing float32 sums to the producer
//     warpgroup's three idle warps through a staging tile (98 KB, leaving
//     room for 6 stages) was slower at every form (chip_smoke.py [2]).
// Fill bytes per FLOP, per block and 32-deep slab (A 128 × 32 + B N × 32 / C
// in bf16, against 2·128·N·32 FLOP):
//   F = 96, 192 (N 192, C 4): 8192 + 3072 B per 1.57 MFLOP = 139.6 FLOP/B
//   F = 48      (N 96,  C 4): 8192 + 1536 B per 0.79 MFLOP =  80.8 FLOP/B
//   F = 24      (N 48,  C 2): 8192 + 1536 B per 0.39 MFLOP =  40.4 FLOP/B
// (C = 2 at N = 48 keeps each multicast slice a whole 8-row swizzle atom.)
// The packed K holds kpt rows per tap: Cin rounded up to 32 where that
// wastes at most a third (Cin = 48 → 64, so a slab never straddles two
// taps and TMA's out-of-bounds zeros fill channels 48 … 63), else Cin
// rounded up to 8 (the stem: 8, taps packed densely). A TMA box needs
// kpt % 32 == 0 and a block's 128 pixels forming a box: W a multiple of
// 128, or
// 128 a multiple of W and then H a multiple of 128 / W or 128 / W a
// multiple of H. Other forms keep the 16-byte cp.async gather as their
// producer path (all 128 producer threads, setmaxnreg 56, the copies fenced
// to the async proxy before the "full" arrival): the 8-channel stem and odd
// maps. The plan is made in Python (ops/kernels/gated_matmul.py `plan`,
// `a_tile`) and passed in; the packed weights are (slabs, n_col·2·BF, 32),
// zero rows past Cin in each tap and past K, zero columns past F.
//
// float32 variant (gated_conv_kernel, unchanged since it was written): CUDA
// cores, 256 threads, 128 pixels × BN features (BN 32 or 64) × 2 halves,
// 8 × BN/16 per thread, a three-stage cp.async ring of 32-deep chunks,
// weights packed (K_pad, 2, FP); full float32 products (TF32 would miss the
// checks' tolerance). It serves the float32 checks.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace gi;

using bf16 = __nv_bfloat16;

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

// the bf16 kernel's gate: hardware exp and reciprocal (a few ulp of float32,
// far below the bf16 rounding of the output)
__device__ __forceinline__ float gated_fast(float f, float g, int act) {
  return activate(f, act) * __frcp_rn(1.f + __expf(-g));
}

// 16 bytes global → shared without passing through registers; n_bytes = 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n_bytes));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// =========================================================================
// float32: CUDA-core variant
// =========================================================================

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
template <> struct Cfg<float> {
  static constexpr int KC = 32, PAD = 4, VEC = 4;
};
constexpr int kStages = 3;

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

  // ---- CUDA cores: thread (tx, ty) owns pixels ty + 16·i, i < 8, and
  // features tx·TN … tx·TN + TN − 1 of both halves ------------------------
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

template <int BN>
int launch_f32(const float* x, const float* wp, const float* bias,
               float* out, Geom g, cudaStream_t s) {
  g.K = g.k * g.k * g.Cin;
  g.n_chunks = (g.K + Cfg<float>::KC - 1) / Cfg<float>::KC;
  const long long bx = (g.M + kBM - 1) / kBM;
  if (bx > 0x7fffffffLL || g.FP / BN > 65535) return cudaErrorInvalidValue;
  auto kernel = gated_conv_kernel<float, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<float, BN>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(g.FP / BN));
  kernel<<<grid, kThreads, Smem<float, BN>::BYTES, s>>>(x, wp, bias, out, g);
  return cudaGetLastError();
}

// =========================================================================
// bf16: wgmma fed by TMA (or by the cp.async gather), warp-specialized
// =========================================================================

constexpr int kWgThreads = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int kSlab = 32;           // K per stage: 32 channels = 64 bytes
constexpr int kRing = 8;            // stages
constexpr int kSlabA = kBM * kSlab * 2;   // 8192 bytes of A per stage
constexpr int kGatherLag = 3;       // gather stages in flight per thread

struct WGeom {
  int B, H, W, Cin;        // input map
  int Ho, Wo;              // output map
  int F, BF;               // features; features per column block
  int k, stride, dil;      // window, stride, dilation
  int pad_y, pad_x;        // low-side TF-SAME pads
  int n_col;               // column blocks
  int n_groups;            // tile groups: (blocks along M / cluster)·n_col
  int kpt;                 // K rows per tap in the packed weights (≥ Cin)
  int cps;                 // slabs per tap (TMA path): ⌈kpt / 32⌉
  int n_slabs;             // stages of K to run
  int K;                   // k·k·kpt (gather path bound)
  int cluster;             // blocks per cluster along M (B multicast)
  int act;
  long long M;             // B·Ho·Wo
};

// K-major operand, 64-byte swizzle: 8-row atoms of 512 bytes (SBO 512),
// leading offset unused; `addr` advanced by 32 bytes per k16 step
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// D(64 × N, float32) += A(64 × 16, smem) · B(16 × N, smem)^T, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t da,
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
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// Persistent: cluster q of the grid walks tile groups q, q + clusters, …;
// a group is C consecutive 128-pixel blocks (one per block of the
// cluster) × one column block of BF features and their BF gates, column
// blocks fastest, so neighbouring clusters read the same A rows from L2.
// The producer runs on into the next tile while the consumers finish the
// last one's epilogue.
template <int N, bool kTmaA>
__global__ void __launch_bounds__(kWgThreads, 1)
gated_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const bf16* __restrict__ x,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   const WGeom g) {
  constexpr int kStage = kSlabA + N * kSlab * 2;   // bytes per stage
  constexpr int BF = N / 2;
  extern __shared__ unsigned char smem_raw[];
  // stages 1024-aligned (the swizzle atoms, and one offset in every block
  // of the cluster)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kRing * kStage;
  const uint32_t empty = full + 8 * kRing;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const uint32_t n_cta = static_cast<uint32_t>(g.cluster);

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      // TMA: one expect_tx arrival; gather: that and one per thread
      mbar_init(full + 8 * s, kTmaA ? 1 : 129);
      // one arrival per consumer warp of every block of the cluster
      mbar_init(empty + 8 * s, 8 * n_cta);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const uint32_t rank = cluster_rank();
  const int first = blockIdx.x / g.cluster;
  const int step = gridDim.x / g.cluster;
  // first output pixel and column block of tile group q
  auto tile_m0 = [&](int q) {
    return (1LL * (q / g.n_col) * g.cluster + rank) * kBM;
  };

  if (wg == 2) {
    // ===================== producer =====================================
    if constexpr (kTmaA) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    }
    const int slice = N / g.cluster;        // packed rows per block
    const uint16_t mask = static_cast<uint16_t>((1u << n_cta) - 1u);
    const int t = tid - 256;
    // this block's share of the weight slab, multicast to the cluster
    auto load_b = [&](uint32_t st, uint32_t bar, int col, int i) {
      const uint32_t bdst = st + kSlabA + rank * slice * kSlab * 2;
      const int row = col * N + static_cast<int>(rank) * slice;
      if (n_cta > 1)
        tma_load_3d_multicast(bdst, &tm_b, bar, mask, 0, row, i);
      else
        tma_load_3d(bdst, &tm_b, bar, 0, row, i);
    };
    int it = 0;                             // slabs issued, over all tiles
    if constexpr (kTmaA) {
      if (t == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
            reinterpret_cast<uint64_t>(&tm_a)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
            reinterpret_cast<uint64_t>(&tm_b)) : "memory");
        for (int q = first; q < g.n_groups; q += step) {
          const long long m0 = tile_m0(q);
          const long long hw = 1LL * g.Ho * g.Wo;
          const int b0 = static_cast<int>(m0 / hw);
          const long long rem = m0 - b0 * hw;
          const int oy0 = static_cast<int>(rem / g.Wo);
          const int ox0 = static_cast<int>(rem - 1LL * oy0 * g.Wo);
          const int iy0 = oy0 * g.stride - g.pad_y;
          const int ix0 = ox0 * g.stride - g.pad_x;
          for (int i = 0; i < g.n_slabs; ++i, ++it) {
            const int s = it % kRing;
            mbar_wait(empty + 8 * s, ((it / kRing) & 1) ^ 1);
            const uint32_t bar = full + 8 * s;
            const uint32_t st = base + s * kStage;
            mbar_expect_tx(bar, kStage);
            const int tap = i / g.cps;
            const int c0 = (i - tap * g.cps) * kSlab;
            const int ky = tap / g.k, kx = tap - ky * g.k;
            tma_load_4d(st, &tm_a, bar, c0, ix0 + kx * g.dil,
                        iy0 + ky * g.dil, b0);
            load_b(st, bar, q % g.n_col, i);
          }
        }
      }
    } else {
      // thread t gathers pixel row t of each tile: 4 vectors of 8 channels
      // per slab, stored where the 64-byte swizzle puts them
      const uint32_t row_off = t * (kSlab * 2);
      const int swz = (t >> 1) & 3;
      for (int q = first; q < g.n_groups; q += step) {
        const long long m = tile_m0(q) + t;
        int b = -1, iy0 = 0, ix0 = 0;
        if (m < g.M) {
          const int ox = static_cast<int>(m % g.Wo);
          const long long r = m / g.Wo;
          const int oy = static_cast<int>(r % g.Ho);
          b = static_cast<int>(r / g.Ho);
          iy0 = oy * g.stride - g.pad_y;
          ix0 = ox * g.stride - g.pad_x;
        }
        for (int i = 0; i < g.n_slabs; ++i, ++it) {
          const int s = it % kRing;
          mbar_wait(empty + 8 * s, ((it / kRing) & 1) ^ 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t st = base + s * kStage;
          if (t == 0) {
            mbar_expect_tx(bar, N * kSlab * 2);
            load_b(st, bar, q % g.n_col, i);
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int kk = i * kSlab + v * 8;
            const int tap = kk / g.kpt;
            const int c = kk - tap * g.kpt;
            const int ky = tap / g.k;
            const int iy = iy0 + ky * g.dil;
            const int ix = ix0 + (tap - ky * g.k) * g.dil;
            const bool in = kk < g.K && c < g.Cin && b >= 0 && iy >= 0 &&
                            iy < g.H && ix >= 0 && ix < g.W;
            const bf16* src =
                in ? x + ((static_cast<size_t>(b) * g.H + iy) * g.W + ix) *
                             g.Cin + c
                   : x;
            cp_async16(st + row_off + ((v ^ swz) << 4), src, in ? 16 : 0);
          }
          cp_async_commit();
          // the copies of slab it − lag have landed: make them visible to
          // the tensor cores' (async) proxy, then arrive
          if (it >= kGatherLag) {
            cp_async_wait<kGatherLag>();
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full + 8 * ((it - kGatherLag) % kRing));
          }
        }
      }
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int d = it > kGatherLag ? it - kGatherLag : 0; d < it; ++d)
        mbar_arrive(full + 8 * (d % kRing));
    }
    // stay until every block of the cluster has released every stage this
    // block wrote into
    if (t == 0)
      for (int j = 0; j < kRing; ++j, ++it)
        mbar_wait(empty + 8 * (it % kRing), ((it / kRing) & 1) ^ 1);
  } else {
    // ===================== consumers ====================================
    if constexpr (kTmaA) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    }
    const int lane = tid & 31;
    // lane c of every consumer warp releases a stage to block c
    auto release = [&](int it) {
      if (lane < static_cast<int>(n_cta))
        mbar_arrive_cluster(empty + 8 * (it % kRing), lane);
    };
    const int r = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const bool pairs = (g.F % 2) == 0;
    int it = 0;                             // slabs consumed, over all tiles
    float acc[N / 2];
    for (int q = first; q < g.n_groups; q += step) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        acc[i] = 0.f;
        fence_operand(acc[i]);
      }
      for (int i = 0; i < g.n_slabs; ++i, ++it) {
        const int s = it % kRing;
        mbar_wait(full + 8 * s, (it / kRing) & 1);
        const uint32_t st = base + s * kStage;
        const uint64_t da = smem_desc(st + wg * (kSlabA / 2));
        const uint64_t db = smem_desc(st + kSlabA);
        wgmma_fence();
        wgmma_ss<N>(acc, da, db);
        wgmma_ss<N>(acc, da + 2, db + 2);     // + 32 bytes: k 16 … 31
        wgmma_commit();
        wgmma_wait<1>();                      // slab it − 1 is read
        if (i > 0) release(it - 1);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
      release(it - 1);

      // ---- epilogue: register d[4j + 2h + e] holds row r + 8h and column
      // 8j + 2·(lane % 4) + e; the gate of feature column c sits BF / 2
      // registers later
      const long long m0 = tile_m0(q);
      const int n0 = (q % g.n_col) * BF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + r + 8 * h;
        if (m >= g.M) continue;
        bf16* row = out + m * g.F;
#pragma unroll
        for (int j = 0; j < BF / 8; ++j) {
          const int n = n0 + 8 * j + cq;
          if (n >= g.F) continue;
          const int i = 4 * j + 2 * h;
          const float y0 = gated_fast(acc[i] + bias[n],
                                      acc[i + BF / 2] + bias[g.F + n],
                                      g.act);
          if (n + 1 < g.F) {
            const float y1 = gated_fast(
                acc[i + 1] + bias[n + 1],
                acc[i + 1 + BF / 2] + bias[g.F + n + 1], g.act);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(row + n) =
                  __floats2bfloat162_rn(y0, y1);
            } else {
              row[n] = __float2bfloat16(y0);
              row[n + 1] = __float2bfloat16(y1);
            }
          } else {
            row[n] = __float2bfloat16(y0);
          }
        }
      }
    }
  }
}


template <int N, bool kTmaA>
int launch_wgmma(const bf16* x, const bf16* wp, const float* bias, bf16* out,
                 const WGeom& g, int n_col, int tile_w, int tile_h,
                 int tile_b, cudaStream_t s) {
  EncodeTiled encode = encode_fn();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap tm_a{}, tm_b{};
  if (kTmaA) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.Cin),
                                static_cast<cuuint64_t>(g.W),
                                static_cast<cuuint64_t>(g.H),
                                static_cast<cuuint64_t>(g.B)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(g.Cin) * 2,
        static_cast<cuuint64_t>(g.W) * g.Cin * 2,
        static_cast<cuuint64_t>(g.H) * g.W * g.Cin * 2};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSlab),
                               static_cast<cuuint32_t>(tile_w * g.stride),
                               static_cast<cuuint32_t>(tile_h * g.stride),
                               static_cast<cuuint32_t>(tile_b)};
    const cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(g.stride),
                                static_cast<cuuint32_t>(g.stride), 1};
    if (encode(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<bf16*>(x), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kSlab),
                                static_cast<cuuint64_t>(n_col) * N,
                                static_cast<cuuint64_t>(g.n_slabs)};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(kSlab) * 2,
        static_cast<cuuint64_t>(n_col) * N * kSlab * 2};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSlab),
                               static_cast<cuuint32_t>(N / g.cluster), 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<bf16*>(wp), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const long long blocks = (g.M + kBM - 1) / kBM;
  const long long groups = (blocks + g.cluster - 1) / g.cluster * n_col;
  if (groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int kBytes = kRing * (kSlabA + N * kSlab * 2) + 16 * kRing + 1024;
  auto kernel = gated_wgmma_kernel<N, kTmaA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one cluster per set of co-resident blocks, each walking tile groups
  static int resident[5] = {0, 0, 0, 0, 0};
  if (resident[g.cluster] == 0) {
    cfg.gridDim = dim3(static_cast<unsigned>(g.cluster));
    err = cudaOccupancyMaxActiveClusters(&resident[g.cluster], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident[g.cluster] < 1) return cudaErrorInvalidConfiguration;
  }
  WGeom gg = g;
  gg.n_col = n_col;
  gg.n_groups = static_cast<int>(groups);
  const long long clusters =
      groups < resident[g.cluster] ? groups : resident[g.cluster];
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * g.cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_b, x, bias, out, gg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N>
int launch_wgmma_n(const bf16* x, const bf16* wp, const float* bias,
                   bf16* out, const WGeom& g, int n_col, int tile_w,
                   int tile_h, int tile_b, cudaStream_t s) {
  if (tile_w > 0)
    return launch_wgmma<N, true>(x, wp, bias, out, g, n_col, tile_w, tile_h,
                                 tile_b, s);
  return launch_wgmma<N, false>(x, wp, bias, out, g, n_col, 0, 0, 0, s);
}

}  // namespace

// Returns a cudaError_t (0 on success). x: (B, H, W, Cin) contiguous; out:
// (B, Ho, Wo, F); bias: (2F,) float32, features first; window k, stride,
// dilation, low-side pads pad_y / pad_x (the high side is whatever lies
// past the map). block_f features per column block, n_col column blocks.
//   bf16: wp (n_slabs, n_col·2·block_f, 32), K in (tap, channel) order
//     with kpt ≥ Cin rows per tap (zero past Cin), block_f ∈ {24, 48, 96},
//     cluster blocks along M share each B slab; tile_w·tile_h·tile_b = 128
//     names the TMA box of a block's pixels (tile_w = 0: the gather path),
//     which needs kpt % 32 == 0; Cin a multiple of 8.
//   float32: wp (K_pad, 2, n_col·block_f), block_f ∈ {32, 64}, K_pad a
//     multiple of 32, Cin a multiple of 4; cluster and tile unused.
extern "C" int gi_gated_conv(const void* x, const void* wp, const float* bias,
                             void* out, int B, int H, int W, int Cin, int Ho,
                             int Wo, int F, int k, int stride, int dil,
                             int pad_y, int pad_x, int kpt, int block_f,
                             int n_col, int cluster, int tile_w, int tile_h,
                             int tile_b, int act, int is_bf16,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1 || Cin < 1 || F < 1 ||
      k < 1 || stride < 1 || dil < 1 || pad_y < 0 || pad_x < 0 || act < 0 ||
      act > 4 || n_col < 1 || block_f * n_col < F)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = 1LL * B * Ho * Wo;
  if (!is_bf16) {
    if (Cin % 4 || (block_f != 32 && block_f != 64))
      return cudaErrorInvalidValue;
    Geom g{};
    g.H = H; g.W = W; g.Cin = Cin; g.Ho = Ho; g.Wo = Wo; g.F = F;
    g.FP = block_f * n_col; g.k = k; g.stride = stride; g.dil = dil;
    g.pad_y = pad_y; g.pad_x = pad_x; g.act = act; g.M = M;
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(wp);
    auto* of = static_cast<float*>(out);
    if (block_f == 64) return launch_f32<64>(xf, wf, bias, of, g, s);
    return launch_f32<32>(xf, wf, bias, of, g, s);
  }
  const bool tma = tile_w > 0;
  if (Cin % 8 || kpt < Cin || kpt % 8 ||
      (cluster != 1 && cluster != 2 && cluster != 4) ||
      (block_f != 24 && block_f != 48 && block_f != 96) ||
      ((2 * block_f / cluster) % 8) != 0)
    return cudaErrorInvalidValue;
  if (tma && (tile_w * tile_h * tile_b != kBM || tile_w * stride > 256 ||
              tile_h * stride > 256 || stride > 8 ||
              kpt % kSlab != 0))
    return cudaErrorInvalidValue;
  WGeom g{};
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Ho = Ho; g.Wo = Wo; g.F = F;
  g.BF = block_f; g.k = k; g.stride = stride; g.dil = dil; g.pad_y = pad_y;
  g.pad_x = pad_x; g.cluster = cluster; g.act = act; g.M = M;
  g.kpt = kpt;
  g.K = k * k * kpt;
  g.cps = (kpt + kSlab - 1) / kSlab;
  g.n_slabs = tma ? k * k * g.cps : (g.K + kSlab - 1) / kSlab;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(wp);
  auto* ob = static_cast<bf16*>(out);
  switch (block_f) {
    case 24:
      return launch_wgmma_n<48>(xb, wb, bias, ob, g, n_col, tile_w, tile_h,
                                tile_b, s);
    case 48:
      return launch_wgmma_n<96>(xb, wb, bias, ob, g, n_col, tile_w, tile_h,
                                tile_b, s);
    default:
      return launch_wgmma_n<192>(xb, wb, bias, ob, g, n_col, tile_w, tile_h,
                                 tile_b, s);
  }
}
