// The bf16 attention backward for Hopper (sm_90a): the dQ and the dK/dV
// kernel on one cluster mainloop, instantiated by patch_attention.cu for
// materialized Q, K, V and dO (its producer, PatchProducer below, reads
// 3-D tensor maps; a producer of shifted cell windows can take the fused
// backward the same way).
//
// Replaces _bwd_dq_kernel and _bwd_dkv_kernel of
// gan_inpainting_tpu/ops/pallas/patch_attention.py (:156, :186). With p
// rebuilt from the forward's lse and δ = rowsum(dO∘out) formed by the
// caller in float32:
//   p  = exp(scale·q·k − lse_q)·valid_k     (0 for an invalid key)
//   dp = dO·vᵀ,  ds = p·(dp − δ_q)·scale
//   dq = Σ_k ds·k,  dk = Σ_q ds·q,  dv = Σ_q p·dO
// p and ds are rounded to bf16 before their products; S and dP are float32
// sums of per-rank partials in rank order (patch_attention_mirror with
// unit 64, block_c 128 is this arithmetic in PyTorch). An invalid key has
// p = ds = 0, so a sample with no valid key gets exactly 0 gradients. Each
// cluster owns its rows for the whole walk: no atomics, deterministic.
//
// What bounds it: 2·Lq·Lk·(2d + dv) operations (dQ), 2·Lq·Lk·(2d + 2dv)
// (dK/dV), against (Lq + Lk)·(d + dv) elements: operations, by two orders
// of magnitude at d 1728 / dv 3072. The layout below counts the bytes each
// SM fills from L2 per FLOP (the forward, attention_wgmma.cuh, ran at
// 1.3–1.5× the time of its fill at ≈ 2.7 TB/s); what bounds it on the card
// is under "Fill".
//
// Split (a), as the forward: a cluster of CL blocks shares a 64-row tile;
// block `rank` holds 64-wide units [rank·n1/CL, (rank+1)·n1/CL) of d and
// [rank·n2/CL, …) of dv. Rows are queries in dQ and keys in dK/dV; the
// columns, walked in steps of 128, the other side.
//   resident (loaded once): the rows' d units (R1) and dv units (R2):
//     dQ: Q and dO;  dK/dV: K and V
//   streamed per step (TMA boxes of 64 × 128 columns, 16 KB stages), the
//   two sides in turns: dQ: V and K;  dK/dV: dO and Q
// Per step:
//   1. partial S = R1·C1ᵀ over the block's d units (warpgroup 0) and
//      partial dP = R2·C2ᵀ over its dv units (warpgroup 1), all 128
//      columns each (wgmma m64n128k16, both K-major), written as float32
//      to shared memory;
//   2. exchange 1; the block owning rows rank·64/CL … sums the CL partials
//      of its rows in rank order through distributed shared memory and
//      forms p and ds, elementwise (no running max: lse is known), and
//      publishes bf16 ds (and p, dK/dV);
//   3. exchange 2; every block copies the 64 × 128 weights once into local
//      128-byte-swizzled A tiles and adds
//        dQ:    dq += ds·K        over its d units
//        dK/dV: dv += pᵀ·dO, dk += dsᵀ·Q
//      with the stage read N-major (the descriptor's transpose), as the
//      forward reads V. A stage that feeds step 3 stays in the ring until
//      that product has read it, so a K stage (dQ) or a Q and a dO stage
//      (dK/dV) serves two products per fill.
// The accumulated units (dQ: the d units; dK/dV: the dv units, then the d
// units) alternate between the two consumer warpgroups, ≤ 3 each: 96
// float32 accumulator registers per thread beside the 64 of S or dP. An
// exchange is a named barrier of the consumers, then one cluster-scope
// release arrival per block on every rank's mbarrier, and acquire waits;
// the producer never joins it and keeps the ring full through it.
//
// Fill per block and step: du + dvu stages of 16 KB, 2·64·128·64 FLOP per
// unit product; dQ runs 2du + dvu products → 64·(2du + dvu)/(du + dvu)
// FLOP per byte filled (≈ 90 at d 1728 / dv 3072), dK/dV 2du + 2dvu → 128.
// On the card the fill is not what bounds it (the ring runs a step ahead):
// per step of ≈ 9 µs at d 1728 / dv 3072, CL 16, the owned rows' reads of
// 64 KB of partials through distributed shared memory take the largest
// share (≈ 10 bytes per cycle per SM), then the products (m64n64k16 and
// m64n128k16 from shared memory, far below the tensor cores' peak at
// these widths) and the two exchanges; the CLOCKS instances count the
// phases (Params.clocks).
// Both the exchanged bytes and the exchanges per FLOP grow with CL.
//
// The shared-memory budget decides the cluster (host side: configure; the
// Python plan mirrors it). Per block, in bytes:
//   ring     16 384 per stage
//   resident  8 192 per unit, ⌈n1/CL⌉ + ⌈n2/CL⌉ units
//   partials 2 × 64 × 136 × 4 = 69 632 (S, dP; the A tiles, 16 KB each,
//            reuse the S partial's space after exchange 2)
//   weights  64/CL rows × 128 × 2 per published tile (1 dQ, 2 dK/dV)
//   barriers 8·(2·ring + 3), + 1024 of alignment slack
// and the ring must hold a whole step (its stages that feed step 3 stay
// until then) plus one to prefetch. At d 1728 / dv 3072 (n1 27, n2 48),
// CL 8: 10 resident units (80 KB) + 68 KB of partials + 11 stages > 227 KB,
// and dK/dV would need 10 accumulator units (160 registers per thread);
// CL 16 (non-portable; 7 clusters resident on an H100 SXM) halves every
// slice: 2 + 3 units, ring 7, 227 464 (dQ) and 228 488 (dK/dV) of 232 448
// bytes, 5 accumulator units (3 + 2 per warpgroup).
#pragma once

#include "attention_wgmma.cuh"

namespace gi {
namespace attn_bwd {

using attn::bf16;
using attn::kBC;
using attn::kBR;
using attn::kConsumers;
using attn::kLdS;
using attn::kSmemLimit;
using attn::kStageBytes;
using attn::kThreads;
using attn::kUnit;
constexpr int kResBytes = kBR * kUnit * 2;   // one resident unit, 8 KB
constexpr int kSlots = 3;          // accumulator units per consumer warpgroup
constexpr int kMaxAcc = 2 * kSlots;
constexpr int kMaxRing = 8;

enum Which { kDq = 0, kDkv = 1 };

struct Params {
  int B, Lq, Lk;
  int d, dv;               // row widths of the tensors (multiples of 8)
  int n1, n2;              // their 64-wide units
  float scale;
  const unsigned char* valid;  // (B, Lk)
  const float* lse;            // (B, Lq)
  const float* delta;          // (B, Lq)
  bf16* out0;              // dQ: dq (B, Lq, d); dK/dV: dk (B, Lk, d)
  bf16* out1;              // dK/dV: dv (B, Lk, dv)
  // the CLOCKS instances only: thread 0 of each block adds its cycles per
  // phase (S and dP products, partial write, exchange 1, owned rows,
  // exchange 2, weight copy, products) into [0, 7) and its step count
  // into [7]
  unsigned long long* clocks;
  int ring;
};
constexpr int kPhases = 7;

// Shared memory past the 1024-aligned base, in bytes (host and device).
struct Layout {
  int ring, res, sp, dp, wt, own, bars, total;
};
__host__ __device__ inline Layout layout(int ring, int res_units,
                                         int own_rows, int n_pub) {
  Layout l;
  l.ring = 0;
  l.res = ring * kStageBytes;
  l.sp = l.res + res_units * kResBytes;
  l.wt = l.sp;             // the A tiles reuse the S partial's space
  l.dp = l.sp + kBR * kLdS * 4;
  l.own = l.dp + kBR * kLdS * 4;
  l.bars = l.own + n_pub * own_rows * kBC * 2;
  l.total = l.bars + 8 * (2 * ring + 3) + 1024;   // + alignment slack
  return l;
}

// Loads of materialized matrices (B, L, width) through 3-D tensor maps:
// the rows' resident units (boxes of 64 rows) and the columns' stages
// (boxes of 128); out-of-range rows and columns arrive as zeros.
struct PatchProducer {
  const CUtensorMap* r1;   // rows' d   (dQ: Q;  dK/dV: K)
  const CUtensorMap* r2;   // rows' dv  (dQ: dO; dK/dV: V)
  const CUtensorMap* c1;   // columns' d  (dQ: K;  dK/dV: Q)
  const CUtensorMap* c2;   // columns' dv (dQ: V;  dK/dV: dO)
  __device__ void prefetch() const {
    const CUtensorMap* maps[4] = {r1, r2, c1, c2};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
          reinterpret_cast<uint64_t>(maps[i])) : "memory");
  }
  __device__ void rows(uint32_t dst, uint32_t bar, bool d_side, int unit,
                       int row0, int b) const {
    tma_load_3d(dst, d_side ? r1 : r2, bar, unit * kUnit, row0, b);
  }
  __device__ void cols(uint32_t dst, uint32_t bar, bool d_side, int unit,
                       int c0, int b) const {
    tma_load_3d(dst, d_side ? c1 : c2, bar, unit * kUnit, c0, b);
  }
};

// D(64 × 128, float32) += A(64 × 16) · B(16 × 128), both K-major from
// shared memory
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int WHICH, int CL, bool CLOCKS>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_r1,
                     const __grid_constant__ CUtensorMap tm_r2,
                     const __grid_constant__ CUtensorMap tm_c1,
                     const __grid_constant__ CUtensorMap tm_c2,
                     const Params p) {
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int cl = CL;
  constexpr bool kIsDq = WHICH == kDq;
  constexpr int own = kBR / CL;                    // rows this block owns
  constexpr int n_pub = kIsDq ? 1 : 2;             // ds (, p)
  const int rank = static_cast<int>(cluster.block_rank());
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int du_cap = (p.n1 + cl - 1) / cl, dvu_cap = (p.n2 + cl - 1) / cl;
  const Layout L = layout(p.ring, du_cap + dvu_cap, own, n_pub);
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * p.ring;
  const uint32_t rbar = empty + 8 * p.ring;
  const uint32_t sready = rbar + 8, pready = rbar + 16;
  float* spart = reinterpret_cast<float*>(gbase + L.sp);     // [64][kLdS]
  float* dpart = reinterpret_cast<float*>(gbase + L.dp);     // [64][kLdS]
  bf16* own_w = reinterpret_cast<bf16*>(gbase + L.own);  // [n_pub][own][kBC]
  const int tid = threadIdx.x;

  const int b = blockIdx.y;
  const int row0 = (blockIdx.x / cl) * kBR;
  const int n_rows = kIsDq ? p.Lq : p.Lk;
  const int n_cols = kIsDq ? p.Lk : p.Lq;
  const int u1lo = rank * p.n1 / cl, u1n = (rank + 1) * p.n1 / cl - u1lo;
  const int u2lo = rank * p.n2 / cl, u2n = (rank + 1) * p.n2 / cl - u2lo;
  const int n_steps = (n_cols + kBC - 1) / kBC;
  // a step's loads alternate between the dv side (C2, dP on warpgroup 1)
  // and the d side (C1, S on warpgroup 0) while both have units left
  const int n_ld = u1n + u2n, n_alt = 2 * min(u1n, u2n);
  auto d_side = [&](int i) { return i < n_alt ? (i & 1) == 1 : u1n > u2n; };
  auto unit_of = [&](int i) { return i < n_alt ? i >> 1 : (n_alt >> 1) + i
                                                           - n_alt; };

  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(rbar, 1);
    mbar_init(sready, cl);             // one arrival per block
    mbar_init(pready, cl);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (tid >= kConsumers) {
    // ========================= producer ===================================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      const PatchProducer prod{&tm_r1, &tm_r2, &tm_c1, &tm_c2};
      prod.prefetch();
      mbar_expect_tx(rbar, n_ld * kResBytes);
      for (int u = 0; u < n_ld; ++u) {
        const bool ds = u < u1n;
        prod.rows(base + L.res + u * kResBytes, rbar, ds,
                  ds ? u1lo + u : u2lo + u - u1n, row0, b);
      }
      int it = 0;
      for (int j = 0; j < n_steps; ++j) {
        for (int i = 0; i < n_ld; ++i, ++it) {
          const int s = it % p.ring;
          mbar_wait(empty + 8 * s, ((it / p.ring) & 1) ^ 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes);
          const bool ds = d_side(i);
          prod.cols(base + L.ring + s * kStageBytes, bar, ds,
                    (ds ? u1lo : u2lo) + unit_of(i), j * kBC, b);
        }
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ========================= consumers ==================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int r_lo = ((tid & 127) >> 5) * 16 + (lane >> 2);   // and r_lo + 8
    const int cq = 2 * (lane & 3);
    const int n_acc = kIsDq ? u1n : u1n + u2n;
    // the accumulator unit load i feeds in phase 3, −1 for none: dQ: key
    // unit u → u; dK/dV: dO unit u → u (dv), query unit u → u2n + u (dk)
    auto acc_of = [&](int i) {
      if (kIsDq) return d_side(i) ? unit_of(i) : -1;
      return d_side(i) ? u2n + unit_of(i) : unit_of(i);
    };
    // accumulator unit a belongs to warpgroup a & 1, slot a >> 1
    auto mine = [&](int i) {
      const int a = acc_of(i);
      return a >= 0 && (a & 1) == wg;
    };
    float acc[kSlots][32];
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
    uint32_t ph_s = 0, ph_p = 0;
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty + 8 * (it % p.ring));
    };
    // every consumer's writes are done at the named barrier; one thread
    // per rank then releases them to that rank's barrier
    auto exchange = [&](uint32_t bar, uint32_t& ph) {
      attn::consumer_sync();
      if (tid < cl) mbar_arrive_release_cluster(bar, tid);
      mbar_wait_cluster(bar, ph);
      ph ^= 1;
    };
    const uint32_t wt_s = base + L.wt;
    const size_t vrow = static_cast<size_t>(b) * p.Lk;
    const size_t qrow = static_cast<size_t>(b) * p.Lq;
    long long t_mark = CLOCKS ? clock64() : 0;
    auto mark = [&](int k) {           // phase k ends (CLOCKS only)
      if (CLOCKS && tid == 0) {
        const long long t = clock64();
        atomicAdd(p.clocks + k, static_cast<unsigned long long>(t - t_mark));
        t_mark = t;
      }
    };
    mbar_wait(rbar, 0);
    int it = 0;
    for (int j = 0; j < n_steps; ++j) {
      const int c0 = j * kBC;
      // ---- 1. partial S (warpgroup 0, over the block's d units) and dP
      // (warpgroup 1, over its dv units), all 128 columns each -----------
      float t[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        t[i] = 0.f;
        fence_operand(t[i]);
      }
      wgmma_fence();
      int prev = -1;
      for (int i = 0; i < n_ld; ++i) {
        const int st = (it + i) % p.ring;
        mbar_wait(full + 8 * st, ((it + i) / p.ring) & 1);
        const bool ds = d_side(i);
        if (ds != (wg == 0)) {         // the other warpgroup's product
          if (!mine(i)) release(it + i);
          continue;
        }
        const uint32_t ct = base + L.ring + st * kStageBytes;
        const uint32_t rt = base + L.res
                            + (ds ? unit_of(i) : u1n + unit_of(i)) * kResBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_128(t, desc_sw128_k(rt + 32 * kk), desc_sw128_k(ct + 32 * kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();             // the previous load is read
          if (!mine(prev)) release(it + prev);
        }
        prev = i;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(t[i]);
      if (prev >= 0 && !mine(prev)) release(it + prev);
      mark(0);
      // both warpgroups are done with the last step's A tiles, which the
      // partials overwrite
      attn::consumer_sync();
      {
        float* part = wg == 0 ? spart : dpart;
        const int at = r_lo * kLdS + cq;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(part + at + h * 8 * kLdS + 8 * jj) =
                make_float2(t[4 * jj + 2 * h], t[4 * jj + 2 * h + 1]);
      }
      mark(1);
      exchange(sready, ph_s);
      mark(2);

      // ---- 2. the owned rows: sum the partials in rank order; p and ds ---
      // (pairs of columns, so that every consumer thread has work at CL 16)
#pragma unroll 1
      for (int c = tid; c < own * (kBC / 2); c += kConsumers) {
        const int rl = c / (kBC / 2), col = (c % (kBC / 2)) * 2;
        const int row = rank * own + rl;           // row within the tile
        const int grow = row0 + row;
        // the pair's validity, lse and δ first: their loads overlap the
        // partials'
        bool ok[2];
        float l_q[2], d_q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gcol = c0 + col + e;
          const int key = kIsDq ? gcol : grow;
          const int qry = kIsDq ? grow : gcol;
          const bool in = key < p.Lk && qry < p.Lq;
          ok[e] = in && p.valid[vrow + key];
          l_q[e] = in ? p.lse[qrow + qry] : 0.f;
          d_q[e] = in ? p.delta[qrow + qry] : 0.f;
        }
        float sv[2] = {0.f, 0.f}, dv2[2] = {0.f, 0.f};
#pragma unroll 8
        for (int r = 0; r < cl; ++r) {
          const float2 a = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(spart, r) + row * kLdS + col);
          const float2 e = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(dpart, r) + row * kLdS + col);
          sv[0] += a.x;
          sv[1] += a.y;
          dv2[0] += e.x;
          dv2[1] += e.y;
        }
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pv[e] = ok[e] ? expf(sv[e] * p.scale - l_q[e]) : 0.f;
          dsv[e] = pv[e] * (dv2[e] - d_q[e]) * p.scale;
        }
        *reinterpret_cast<__nv_bfloat162*>(own_w + rl * kBC + col) =
            __floats2bfloat162_rn(dsv[0], dsv[1]);
        if constexpr (!kIsDq)
          *reinterpret_cast<__nv_bfloat162*>(own_w + (own + rl) * kBC + col) =
              __floats2bfloat162_rn(pv[0], pv[1]);
      }
      mark(3);
      exchange(pready, ph_p);
      mark(4);

      // ---- 3. the weights once into local A tiles; the products ---------
      {
        // 16-byte chunks, all of a thread's remote loads in flight at once
        constexpr int per = n_pub * kBR * 16 / kConsumers;
        unsigned char* wt = gbase + L.wt;
        uint4 v[per];
#pragma unroll
        for (int k = 0; k < per; ++k) {
          const int c = tid + k * kConsumers;
          const int w = c / (kBR * 16), row = (c >> 4) & (kBR - 1);
          v[k] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(own_w, row / own) +
              (w * own + row % own) * kBC + (c & 15) * 8);
        }
#pragma unroll
        for (int k = 0; k < per; ++k) {
          const int c = tid + k * kConsumers;
          const int w = c / (kBR * 16), row = (c >> 4) & (kBR - 1);
          const int ch = c & 15, cc = ch & 7;
          *reinterpret_cast<uint4*>(wt + w * 2 * kResBytes +
                                    (ch >> 3) * kResBytes + row * 128 +
                                    ((cc ^ (row & 7)) << 4)) = v[k];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      attn::consumer_sync();
      mark(5);
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(acc[u][i]);
      wgmma_fence();
      prev = -1;
      for (int i = 0; i < n_ld; ++i) {
        if (!mine(i)) continue;
        const int slot = acc_of(i) >> 1;
        const uint32_t ct = base + L.ring + ((it + i) % p.ring) * kStageBytes;
        // dV's A tile is p (the second published tile), the others' ds
        const uint32_t at = wt_s + (!kIsDq && !d_side(i) ? 2 * kResBytes : 0);
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (u == slot) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              attn::wgmma_64<1>(acc[u],
                                desc_sw128_k(at + (kk >> 2) * kResBytes +
                                             32 * (kk & 3)),
                                desc_sw128_mn(ct + 2048 * kk));
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(it + prev);
        }
        prev = i;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(acc[u][i]);
      if (prev >= 0) release(it + prev);
      it += n_ld;
      mark(6);
    }
    if (CLOCKS && tid == 0)
      atomicAdd(p.clocks + kPhases, static_cast<unsigned long long>(n_steps));

    // ---- epilogue: the accumulated units as bf16, rows and columns in range
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int a = 2 * u + wg;
      if (a >= n_acc) continue;
      bf16* out;
      int width, unit;
      if (kIsDq || a >= u2n) {
        out = p.out0;
        width = p.d;
        unit = u1lo + (kIsDq ? a : a - u2n);
      } else {
        out = p.out1;
        width = p.dv;
        unit = u2lo + a;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_lo + 8 * h;
        if (row >= n_rows) continue;
        bf16* dst = out + (static_cast<size_t>(b) * n_rows + row) * width;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = unit * kUnit + 8 * jj + cq;
          if (col < width)             // width is even: col + 1 < width
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(acc[u][4 * jj + 2 * h],
                                      acc[u][4 * jj + 2 * h + 1]);
        }
      }
    }
    // no block leaves while another may still read its shared memory
    cluster_sync();
  }
}

// The launch configuration of one instance: shared memory (the deepest
// ring that fits, ≥ the held stages + 1), the non-portable cluster
// attribute for CL 16. Returns a cudaError_t.
template <int WHICH, int CL, bool CLOCKS>
int configure(Params& p, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
              cudaStream_t stream) {
  const int du = (p.n1 + CL - 1) / CL, dvu = (p.n2 + CL - 1) / CL;
  if ((WHICH == kDq ? du : du + dvu) > kMaxAcc) return cudaErrorInvalidValue;
  const int n_pub = WHICH == kDq ? 1 : 2;
  const int min_ring = du + dvu + 1;     // a whole step, and one to prefetch
  int ring = kMaxRing;
  while (ring > min_ring &&
         layout(ring, du + dvu, kBR / CL, n_pub).total > kSmemLimit)
    --ring;
  const Layout L = layout(ring, du + dvu, kBR / CL, n_pub);
  if (ring < min_ring || L.total > kSmemLimit) return cudaErrorInvalidValue;
  p.ring = ring;
  auto kernel = attention_bwd_kernel<WHICH, CL, CLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err == cudaSuccess && CL > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int rows = WHICH == kDq ? p.Lq : p.Lk;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((rows + kBR - 1) / kBR) * CL,
                     static_cast<unsigned>(p.B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launch over ⌈rows / 64⌉ row tiles × B (query rows for dQ, key rows for
// dK/dV) with clusters of CL blocks; or, with `max_clusters` set, only
// report how many such clusters the card holds at once.
template <int WHICH, int CL, bool CLOCKS>
int launch_cl(const CUtensorMap& r1, const CUtensorMap& r2,
              const CUtensorMap& c1, const CUtensorMap& c2, Params p,
              cudaStream_t stream, int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure<WHICH, CL, CLOCKS>(p, cfg, attr, stream);
  if (err != cudaSuccess) return err;
  auto kernel = attention_bwd_kernel<WHICH, CL, CLOCKS>;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, r1, r2, c1, c2, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WHICH>
int launch(const CUtensorMap& r1, const CUtensorMap& r2,
           const CUtensorMap& c1, const CUtensorMap& c2, const Params& p,
           int cl, cudaStream_t stream, int* max_clusters = nullptr) {
  switch (cl) {
    case 1:
      return launch_cl<WHICH, 1, false>(r1, r2, c1, c2, p, stream,
                                        max_clusters);
    case 2:
      return launch_cl<WHICH, 2, false>(r1, r2, c1, c2, p, stream,
                                        max_clusters);
    case 4:
      return launch_cl<WHICH, 4, false>(r1, r2, c1, c2, p, stream,
                                        max_clusters);
    case 8:
      return launch_cl<WHICH, 8, false>(r1, r2, c1, c2, p, stream,
                                        max_clusters);
    case 16:
      return launch_cl<WHICH, 16, false>(r1, r2, c1, c2, p, stream,
                                         max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

// The instances that count their phases' cycles into p.clocks, for
// profiling only: the clusters the plan takes at d 1728 / dv 3072 (16)
// and at d 200 / dv 300 (2).
template <int WHICH>
int launch_clocked(const CUtensorMap& r1, const CUtensorMap& r2,
                   const CUtensorMap& c1, const CUtensorMap& c2,
                   const Params& p, int cl, cudaStream_t stream) {
  switch (cl) {
    case 2:
      return launch_cl<WHICH, 2, true>(r1, r2, c1, c2, p, stream, nullptr);
    case 16:
      return launch_cl<WHICH, 16, true>(r1, r2, c1, c2, p, stream, nullptr);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn_bwd
}  // namespace gi
