// The bf16 attention forward for Hopper (sm_90a): one cluster mainloop with
// two producers, instantiated by contextual_attention.cu (kFused: shifted
// cell windows of the parity maps) and patch_attention.cu (kPatch:
// materialized Q, K and V matrices).
//
// It computes, per query row of a 64-row tile,
//   s   = (Σ_c Q·K)·f_k + b_k      kFused: f = rnorm·scale, b = hole bias
//                                  kPatch: f = scale, b = 0 / −1e9
//   p   = exp(s − m)·valid_k       flash recurrence over 128-key steps
//   out = Σ_k bf16(p)·V_k / Σ_k p  0 where no key is valid
//   lse = m + log Σ_k p            0 where no key is valid
// with d and dv of one row (d = 9C = 1728, dv = 16C = 3072 at C = 192)
// far wider than one block can hold: a 64 × 3072 float32 accumulator is
// 768 KB, a 64-row Q tile of d 1728 is 221 KB.
//
// Split (a): a thread block cluster of CL blocks shares one 64-row tile.
// Block `rank` holds 64-wide units [rank·n1/CL, (rank+1)·n1/CL) of d (its
// slice of the Q tile stays resident, ≤ 4 units = 32 KB) and units
// [rank·n2/CL, …) of dv (≤ 6 units, split as evenly as the two consumer
// warpgroups allow: ≤ 3 each, 96 float32 accumulator registers per
// thread). Per 128-key step:
//   1. the block's partial scores over its d slice (wgmma m64n64k16, Q and
//      K both K-major from 128-byte-swizzled shared memory; warpgroup w
//      takes keys 64w … 64w + 63), written as float32 to shared memory;
//   2. cluster exchange 1; the block owning rows rank·64/CL … sums the CL
//      partials in rank order through distributed shared memory and runs
//      the softmax recurrence on them, one warp per row, its running max
//      and sum in registers; it publishes bf16 p and the rescale factor;
//   3. cluster exchange 2; every block reads the 64 × 128 weights once
//      into a local 128-byte-swizzled tile (wgmma's A operand), rescales
//      its accumulators and adds P·V over its dv units (V is keys × dv,
//      N-major: the descriptor's transpose).
// The exchanges are mbarriers (one arrival per consumer warp of every
// block, cluster-scope release and acquire), so the producer never joins
// them and keeps its TMA ring full through them. The weights' A tile
// reuses the partials' shared memory (a consumer barrier before the next
// step's partials are written).
//
// Staging: one thread of the producer warpgroup (setmaxnreg 40; the
// consumers take 232) issues TMA boxes of 64 elements × 128 keys (16 KB)
// into a ring of 8–9 stages: per step the block's K units, then its V
// units; a consumer releases a stage as soon as its product has read it.
// CL is a template parameter, so each warp's owned rows, running max and
// sum are registers of fixed count. kFused reads a 4-D tensor map of the maps (C, ws+2, hs+2,
// B·r²): a Q or K tap is a box at the tap's shifted cell origin, a V tap a
// box of parity map (par, off); 128 keys are 4 map rows at ws 32, 2 at ws
// 64, part of one row from ws 128. A tap is cpt = ⌈C/64⌉ units; where C is
// not a multiple of 64 (the published width's C 96: 2 units), the last
// unit's box runs past C and TMA fills those channels with zeros, which add
// nothing to a product and give output columns the epilogue does not
// store. kPatch reads 3-D maps (width, L, B) of the matrices, and
// out-of-range rows and columns arrive as zeros the same way.
//
// Fill per block and step: (d units + dv units)·16 KB for 2·64·128·64 FLOP
// per unit, 64 FLOP per byte filled; the exchange adds 6 bytes per (row,
// key) pair per block (4 of float32 partial, 2 of bf16 weight).
#pragma once

#include <cooperative_groups.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace gi {
namespace attn {

using bf16 = __nv_bfloat16;
constexpr int kBR = 64;            // query rows per cluster
constexpr int kBC = 128;           // keys per step
constexpr int kUnit = 64;          // width of a d or dv unit (128 bytes)
constexpr int kStageBytes = kBC * kUnit * 2;   // 16 KB
constexpr int kQUnitBytes = kBR * kUnit * 2;   // 8 KB
constexpr int kMaxDU = 4;          // d units per block
constexpr int kMaxVU = 6;          // dv units per block
constexpr int kVU = 3;             // dv units per consumer warpgroup
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // + the producer warpgroup
constexpr int kLdS = kBC + 8;      // float row stride of the partials
constexpr int kMaxRing = 9;
constexpr int kSmemLimit = 232448;
constexpr float kNegInf = -1e9f;   // bias of an invalid key
constexpr float kInitM = -1e30f;   // running max before the first step

enum Mode { kFused = 0, kPatch = 1 };

struct Params {
  int B, Lq, Lk, d, dv;
  int n1, n2;              // d and dv units (⌈width / 64⌉)
  int ws, C, cpt, rate;    // kFused: map width, channels, ⌈C / 64⌉, rate
  float scale;
  const float* bias;       // kFused (B, Lk): 0 valid, −1e9 hole
  const float* rnorm;      // kFused (B, Lk)
  const unsigned char* valid;  // kPatch (B, Lk)
  bf16* out;               // kFused (B, 4r², Lq, C); kPatch (B, Lq, dv)
  float* lse;              // (B, Lq) or null
  int ring;                // stages
};

// Shared memory past the 1024-aligned base, in bytes (host and device).
struct Layout {
  int ring, q, pl, sp, own_p, own_a, bars, total;
};
__host__ __device__ inline Layout layout(int ring, int own_rows) {
  Layout l;
  l.ring = 0;
  l.q = ring * kStageBytes;
  l.sp = l.q + kMaxDU * kQUnitBytes;
  l.pl = l.sp;             // the weights' A tile reuses the partials' space
  l.own_p = l.sp + kBR * kLdS * 4;
  l.own_a = l.own_p + own_rows * kBC * 2;
  l.bars = l.own_a + kBR * 4;
  l.total = l.bars + 8 * (2 * ring + 3) + 1024;   // + alignment slack
  return l;
}

// D(64 × 64, float32) += A(64 × 16) · B(16 × 64), both from shared memory;
// kTransB: B is N-major (its rows are K)
template <int kTransB>
__device__ __forceinline__ void wgmma_64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(kTransB), "r"(1));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// the parity-map tap (par, off) that V tap `tap` of the 2r × 2r output
// window reads: row vp reads parity (vp − r/2) mod r at cell offset
// ⌊(vp − r/2) / r⌋ + 1 of the halo map
__device__ __forceinline__ void v_tap(int tap, int rate, int& map, int& oy,
                                      int& ox) {
  const int half = rate / 2;
  const int vp = tap / (2 * rate), vq = tap - vp * (2 * rate);
  map = ((vp - half + rate) % rate) * rate + (vq - half + rate) % rate;
  oy = (vp - half + rate) / rate;
  ox = (vq - half + rate) / rate;
}

template <int MODE, int CL>
__global__ void __launch_bounds__(kThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int cl = CL;
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int own = kBR / CL;                    // rows this block owns
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const Layout L = layout(p.ring, own);
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * p.ring;
  const uint32_t qbar = empty + 8 * p.ring;
  const uint32_t sready = qbar + 8, pready = qbar + 16;
  float* spart = reinterpret_cast<float*>(gbase + L.sp);     // [64][kLdS]
  bf16* own_p = reinterpret_cast<bf16*>(gbase + L.own_p);    // [own][kBC]
  float* own_a = reinterpret_cast<float*>(gbase + L.own_a);  // [own]
  const int tid = threadIdx.x;

  const int b = blockIdx.y;
  const int row0 = (blockIdx.x / cl) * kBR;
  const int u1lo = rank * p.n1 / cl, u1n = (rank + 1) * p.n1 / cl - u1lo;
  const int u2lo = rank * p.n2 / cl, u2n = (rank + 1) * p.n2 / cl - u2lo;
  const int n_steps = (p.Lk + kBC - 1) / kBC;

  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(qbar, 1);
    mbar_init(sready, cl * kConsumers / 32);
    mbar_init(pready, cl * kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (tid >= kConsumers) {
    // ========================= producer ===================================
    // one thread issues; the warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
          reinterpret_cast<uint64_t>(&tm_q)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
          reinterpret_cast<uint64_t>(&tm_k)) : "memory");
      if (MODE == kPatch)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
            reinterpret_cast<uint64_t>(&tm_v)) : "memory");
      const int b_maps = b * p.rate * p.rate;
      // the block's slice of the Q tile
      mbar_expect_tx(qbar, u1n * kQUnitBytes);
      for (int u = 0; u < u1n; ++u) {
        const uint32_t dst = base + L.q + u * kQUnitBytes;
        if constexpr (MODE == kPatch) {
          tma_load_3d(dst, &tm_q, qbar, (u1lo + u) * kUnit, row0, b);
        } else {
          const int unit = u1lo + u, t = unit / p.cpt;
          tma_load_4d(dst, &tm_q, qbar, (unit - t * p.cpt) * kUnit,
                      row0 % p.ws + t % 3, row0 / p.ws + t / 3, b_maps);
        }
      }
      int it = 0;
      for (int j = 0; j < n_steps; ++j) {
        const int k0 = j * kBC;
        for (int i = 0; i < u1n + u2n; ++i, ++it) {
          const int s = it % p.ring;
          mbar_wait(empty + 8 * s, ((it / p.ring) & 1) ^ 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t dst = base + L.ring + s * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          const bool is_k = i < u1n;
          const int unit = is_k ? u1lo + i : u2lo + i - u1n;
          if constexpr (MODE == kPatch) {
            tma_load_3d(dst, is_k ? &tm_k : &tm_v, bar, unit * kUnit, k0, b);
          } else {
            const int ky = k0 / p.ws, kx = k0 - ky * p.ws;
            int tap = unit / p.cpt, map = 0, oy, ox;
            if (is_k) {
              oy = tap / 3;
              ox = tap % 3;
            } else {
              v_tap(tap, p.rate, map, oy, ox);
            }
            tma_load_4d(dst, &tm_k, bar, (unit - tap * p.cpt) * kUnit,
                        kx + ox, ky + oy, b_maps + map);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ========================= consumers ==================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;
    const int warp = tid >> 5, lane = tid & 31;
    const int r_lo = ((tid & 127) >> 5) * 16 + (lane >> 2);   // and r_lo + 8
    const int cq = 2 * (lane & 3);
    // the block's dv units split as evenly as the two warpgroups allow
    // (3 + 3 of 6, 2 + 2 of 4), the first taking the odd one
    const int v_half = (u2n + 1) / 2;            // ≤ kVU: u2n ≤ kMaxVU
    const int v_first = wg * v_half;
    const int v_cnt = wg ? u2n - v_half : v_half;
    constexpr int own8 = own / 8;              // rows per warp
    float o[kVU][32];
    float m_run[own8], l_run[own8];
#pragma unroll
    for (int u = 0; u < kVU; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[u][i] = 0.f;
#pragma unroll
    for (int i = 0; i < own8; ++i) {
      m_run[i] = kInitM;
      l_run[i] = 0.f;
    }
    uint32_t ph_s = 0, ph_p = 0;
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty + 8 * (it % p.ring));
    };
    auto exchange = [&](uint32_t bar, uint32_t& ph) {
      __syncwarp();
      if (lane < cl) mbar_arrive_release_cluster(bar, lane);
      mbar_wait_cluster(bar, ph);
      ph ^= 1;
    };
    const uint32_t q_s = base + L.q, pl_s = base + L.pl;
    mbar_wait(qbar, 0);
    int it = 0;
    for (int j = 0; j < n_steps; ++j) {
      const int k0 = j * kBC;
      // ---- 1. partial scores over this block's d units ----------------
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = 0.f;
        fence_operand(s[i]);
      }
      wgmma_fence();
      for (int u = 0; u < u1n; ++u) {
        const int st = (it + u) % p.ring;
        mbar_wait(full + 8 * st, ((it + u) / p.ring) & 1);
        const uint32_t kt = base + L.ring + st * kStageBytes + wg * 8192;
        const uint32_t qt = q_s + u * kQUnitBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_64<0>(s, desc_sw128_k(qt + 32 * kk),
                      desc_sw128_k(kt + 32 * kk));
        wgmma_commit();
        if (u > 0) {
          wgmma_wait<1>();             // unit u − 1 is read
          release(it + u - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(s[i]);
      if (u1n > 0) release(it + u1n - 1);
      it += u1n;
      // both warpgroups are done with the last step's weights, whose tile
      // the partial scores overwrite
      consumer_sync();
      {
        float* sp = spart + r_lo * kLdS + wg * 64 + cq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(sp + h * 8 * kLdS + 8 * jj) =
                make_float2(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]);
      }
      exchange(sready, ph_s);

      // ---- 2. the owned rows: sum the partials, softmax recurrence ------
      float f[4], bb[4];
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 4 * lane + e;
        if constexpr (MODE == kPatch) {
          ok[e] = key < p.Lk && p.valid[static_cast<size_t>(b) * p.Lk + key];
          f[e] = p.scale;
          bb[e] = ok[e] ? 0.f : kNegInf;
        } else {
          const size_t at = static_cast<size_t>(b) * p.Lk + key;
          bb[e] = p.bias[at];
          f[e] = p.rnorm[at] * p.scale;
          ok[e] = bb[e] >= 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < own8; ++i) {
        {
          const int rl = warp + 8 * i;             // row within the owned set
          const int row = rank * own + rl;         // row within the tile
          float a4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < cl; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(spart, r) + row * kLdS + 4 * lane);
            a4[0] += v.x;
            a4[1] += v.y;
            a4[2] += v.z;
            a4[3] += v.w;
          }
          float sv[4], mx = -CUDART_INF_F;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sv[e] = a4[e] * f[e] + bb[e];
            mx = fmaxf(mx, sv[e]);
          }
          mx = warp_max(mx);
          const float m_new = fmaxf(m_run[i], mx);
          const float alpha = expf(m_run[i] - m_new);
          float pv[4], ps = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = ok[e] ? expf(sv[e] - m_new) : 0.f;
            ps += pv[e];
          }
          ps = warp_sum(ps);
          l_run[i] = l_run[i] * alpha + ps;
          m_run[i] = m_new;
          __nv_bfloat162 h2[2] = {__floats2bfloat162_rn(pv[0], pv[1]),
                                  __floats2bfloat162_rn(pv[2], pv[3])};
          *reinterpret_cast<uint2*>(own_p + rl * kBC + 4 * lane) =
              *reinterpret_cast<const uint2*>(h2);
          if (lane == 0) own_a[rl] = alpha;
        }
      }
      exchange(pready, ph_p);

      // ---- 3. the weights once into the local A tile; P·V ---------------
      {
        unsigned char* pl = gbase + L.pl;
        for (int c = tid; c < kBR * 16; c += kConsumers) {
          const int row = c >> 4, ch = c & 15;
          const uint4 v = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(own_p, row / own) + (row % own) * kBC +
              ch * 8);
          const int cc = ch & 7;
          *reinterpret_cast<uint4*>(pl + (ch >> 3) * kQUnitBytes + row * 128 +
                                    ((cc ^ (row & 7)) << 4)) = v;
        }
      }
      const float a_lo = cluster.map_shared_rank(own_a, r_lo / own)[r_lo % own];
      const float a_hi =
          cluster.map_shared_rank(own_a, (r_lo + 8) / own)[(r_lo + 8) % own];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();
#pragma unroll
      for (int u = 0; u < kVU; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[u][i] *= (i & 2) ? a_hi : a_lo;
#pragma unroll
      for (int u = 0; u < kVU; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(o[u][i]);
      wgmma_fence();
      // the other warpgroup's units are released as they arrive, this
      // one's as soon as its product has read them
      int prev = -1;
      for (int vi = 0; vi < u2n; ++vi) {
        const int st = (it + vi) % p.ring;
        mbar_wait(full + 8 * st, ((it + vi) / p.ring) & 1);
        const int ul = vi - v_first;
        if (ul < 0 || ul >= v_cnt) {
          release(it + vi);
          continue;
        }
        const uint32_t vt = base + L.ring + st * kStageBytes;
#pragma unroll
        for (int u = 0; u < kVU; ++u) {
          if (u == ul) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              wgmma_64<1>(o[u],
                          desc_sw128_k(pl_s + (kk >> 2) * kQUnitBytes +
                                       32 * (kk & 3)),
                          desc_sw128_mn(vt + 2048 * kk));
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = it + vi;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kVU; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(o[u][i]);
      if (prev >= 0) release(prev);
      it += u2n;
    }

    // ---- epilogue: 1/l and lse from the owners; scale and store ----------
    exchange(sready, ph_s);            // every block has read the last alpha
#pragma unroll
    for (int i = 0; i < own8; ++i) {
      const int rl = warp + 8 * i;
      const float l = l_run[i];
      if (lane == 0) {
        own_a[rl] = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
        const int grow = row0 + rank * own + rl;
        if (p.lse != nullptr && grow < p.Lq)
          p.lse[static_cast<size_t>(b) * p.Lq + grow] =
              l > 0.f ? m_run[i] + logf(fmaxf(l, 1e-30f)) : 0.f;
      }
    }
    exchange(pready, ph_p);
    const float i_lo = cluster.map_shared_rank(own_a, r_lo / own)[r_lo % own];
    const float i_hi =
        cluster.map_shared_rank(own_a, (r_lo + 8) / own)[(r_lo + 8) % own];
#pragma unroll
    for (int u = 0; u < kVU; ++u) {
      if (u >= v_cnt) continue;
      const int unit = u2lo + v_first + u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_lo + 8 * h;
        if (row >= p.Lq) continue;
        const float inv = h ? i_hi : i_lo;
        bf16* dst;
        int width, col0;
        if constexpr (MODE == kPatch) {
          dst = p.out + (static_cast<size_t>(b) * p.Lq + row) * p.dv;
          width = p.dv;
          col0 = unit * kUnit;
        } else {
          const int tap = unit / p.cpt;
          const int taps = 4 * p.rate * p.rate;
          dst = p.out +
                ((static_cast<size_t>(b) * taps + tap) * p.Lq + row) * p.C;
          width = p.C;
          col0 = (unit - tap * p.cpt) * kUnit;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = col0 + 8 * jj + cq;
          const float y0 = o[u][4 * jj + 2 * h] * inv;
          const float y1 = o[u][4 * jj + 2 * h + 1] * inv;
          if (col + 1 < width && (width & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            if (col < width) dst[col] = __float2bfloat16(y0);
            if (col + 1 < width) dst[col + 1] = __float2bfloat16(y1);
          }
        }
      }
    }
    // no block leaves while another may still read its shared memory
    cluster_sync();
  }
}

// Tiled 128-byte-swizzled bf16 tensor map over a tensor of `rank` dims
// (innermost first, strides in bytes of dims 1 …).
inline int encode_map(CUtensorMap* tm, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  EncodeTiled encode = encode_fn();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  if (encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int MODE, int CL>
int launch_cl(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, Params p, cudaStream_t stream) {
  if ((p.n1 + CL - 1) / CL > kMaxDU || (p.n2 + CL - 1) / CL > kMaxVU)
    return cudaErrorInvalidValue;
  int ring = kMaxRing;
  while (ring > 3 && layout(ring, kBR / CL).total > kSmemLimit) --ring;
  const Layout L = layout(ring, kBR / CL);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  p.ring = ring;
  auto kernel = attention_wgmma_kernel<MODE, CL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.Lq + kBR - 1) / kBR) * CL,
                     static_cast<unsigned>(p.B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch over ⌈Lq / 64⌉ row tiles × B with clusters of `cl` blocks.
template <int MODE>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, int cl,
           cudaStream_t stream) {
  switch (cl) {
    case 1: return launch_cl<MODE, 1>(tq, tk, tv, p, stream);
    case 2: return launch_cl<MODE, 2>(tq, tk, tv, p, stream);
    case 4: return launch_cl<MODE, 4>(tq, tk, tv, p, stream);
    case 8: return launch_cl<MODE, 8>(tq, tk, tv, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace gi
