// Causal flash attention for prefill, for Hopper (sm_90a): TMA + wgmma.
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill (Pallas
// `_kernel`), FlashAttention-2 over one (batch, head) row with the mask
// family: causal, optional sliding window, bidirectional prefix, tanh softcap,
// and GQA through kv_repeat (query row x reads K/V row x / kv_repeat; no
// broadcast copy of K/V).
//
// What bounds it on the H100: at the serving paths' shapes (S of a few hundred
// to ~1000, head_dim 64 or 128) the least time is set by bytes (Q, K, V read
// once, O written once), but only tensor-core work at close to the card's
// rate gets near it: the causal products are ~4 S^2/2 Dh flops per head.
//
// What the design does about it (one CTA per (64-query tile, row)):
// * a ring of K/V tiles in shared memory (STAGES deep), filled by TMA
//   (cp.async.bulk.tensor) from one producer warp and signalled through
//   mbarriers, so the loads of the next tiles overlap this tile's products;
// * one consumer warpgroup of 64 query rows runs Q.K^T as wgmma.mma_async
//   (Q and K both from shared memory, bf16 in, f32 accumulate), tile j + 1's
//   product in flight while tile j's softmax runs, and P.V with
//   P kept in registers as the A operand (rounded to bf16, the one place the
//   kernel rounds where the f32 reference does not; the row sums l use the
//   f32 P) and V read from shared memory MN-major through the descriptor's
//   transpose bit, so no transposed copy of V exists;
// * the tensor maps are 3-D (head_dim, S, rows): TMA zero-fills the ragged
//   tail along S and never reads the next row's tokens; their 128-byte
//   swizzle matches the wgmma descriptors' (each 64-column box is a stack of
//   1024-byte swizzle atoms);
// * the online softmax runs in exp2 with scale * log2(e) folded into one
//   multiply; the mask is applied only to tiles that cross the diagonal,
//   the window's lower edge, a prefix, or the end of the sequence;
// * the heaviest q-tiles (the last ones, with the longest causal range) are
//   launched first: blockIdx.y counts tiles from the end.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;                    // query rows of the consumer warpgroup
constexpr int BK = 64;                    // keys per K/V tile
constexpr int CONSUMERS = 128;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;    // one [64 rows][64 cols] bf16 box (128-byte rows)

template <int DH>
struct Cfg {
  static constexpr int BOXES = DH / 64;                 // 128-byte column boxes per tile
  static constexpr int TILE_BYTES = BOXES * BOX_BYTES;  // a 64-row tile of Q, K or V
  static constexpr int STAGES = DH == 128 ? 2 : 3;
  static constexpr int SMEM = TILE_BYTES * (1 + 2 * STAGES) + 1024 + 8 * (1 + 4 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading / stride byte offsets, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- wgmma instructions (bf16 x bf16 -> f32, M = 64) ----------------------
// _ss: A and B from shared memory, both K-major.  _rs_tb: A from registers,
// B from shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
    int S, int kv_repeat, float scale, float scale_log2, int window, int prefix_len,
    float softcap) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms need 1024-byte aligned tiles
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* k_s = q_s + C::TILE_BYTES;                   // [STAGES] tiles
  uint8_t* v_s = k_s + C::STAGES * C::TILE_BYTES;       // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::STAGES * C::TILE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* k_empty = v_full + C::STAGES;              // a stage's K and V free apart
  uint64_t* v_empty = k_empty + C::STAGES;

  const int row = blockIdx.x;
  const int qs = (gridDim.y - 1 - blockIdx.y) * BQ;     // heaviest q-tiles first
  const int kvrow = row / kv_repeat;

  // key range that can be unmasked for any query of the tile
  const int qe = min(qs + BQ, S);
  const bool in_prefix = prefix_len > 0 && qs < prefix_len;
  int kv_hi = qe;
  if (in_prefix) kv_hi = max(kv_hi, min(prefix_len, S));
  int kv_lo = 0;
  if (window > 0 && !in_prefix) kv_lo = max(0, qs - window + 1);
  const int kt_lo = kv_lo / BK;
  const int n_tiles = (kv_hi + BK - 1) / BK - kt_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS);
      mbar_init(v_empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: one lane keeps the ring full -----------------------
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, C::TILE_BYTES);
#pragma unroll
      for (int b = 0; b < C::BOXES; ++b)
        tma_load_3d(q_s + b * BOX_BYTES, &map_q, q_full, b * 64, qs, row);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        const uint32_t freed = ((j / C::STAGES) - 1) & 1;
        const int k0 = (kt_lo + j) * BK;
        if (j >= C::STAGES) mbar_wait(k_empty + s, freed);
        mbar_expect_tx(k_full + s, C::TILE_BYTES);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b)
          tma_load_3d(k_s + s * C::TILE_BYTES + b * BOX_BYTES, &map_k, k_full + s, b * 64, k0,
                      kvrow);
        if (j >= C::STAGES) mbar_wait(v_empty + s, freed);
        mbar_expect_tx(v_full + s, C::TILE_BYTES);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b)
          tma_load_3d(v_s + s * C::TILE_BYTES + b * BOX_BYTES, &map_v, v_full + s, b * 64, k0,
                      kvrow);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows, 16 per warp ----------------------
  // Pipelined within the warpgroup: tile j + 1's Q.K^T runs on the tensor
  // cores while tile j's softmax runs on the CUDA cores, and tile j's P.V
  // while tile j + 1's scores are read.  A stage's K is released once its
  // Q.K^T is done, its V once its P.V is done.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = qs + warp * 16 + g;                   // this thread's rows r0, r0 + 8
  float acc[DH / 2];                                   // O: n8 block i at acc[4i .. 4i+3]
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};                 // running max, log2 units
  float l_run[2] = {0.f, 0.f};                         // this thread's share of the row sums
  const uint32_t q_addr = smem_u32(q_s);

  // S = Q K^T of tile j into sc: 64 rows x 64 keys, K = head_dim in k16
  // steps (32 bytes of a 128-byte swizzled row; the next box past 64 columns)
  auto issue_qk = [&](float (&sc)[32], int j) {
    const int s = j % C::STAGES;
    const uint32_t k_addr = smem_u32(k_s + s * C::TILE_BYTES);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(k_full + s, (j / C::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_m64n64k16_ss(sc, sw128_desc(q_addr + off, 16, 1024),
                         sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };

  // scale (log2 units), softcap and mask tile j's scores where the tile
  // needs it; online softmax; P as bf16 A fragments (k16 step kk holds keys
  // 16kk .. 16kk + 15) and the rescale of O in corr
  auto softmax = [&](float (&sc)[32], int j, uint32_t (&pa)[4][4], float (&corr)[2]) {
    const int k0 = (kt_lo + j) * BK;
    const bool whole = k0 + BK - 1 <= qs && k0 + BK <= S &&
                       (window <= 0 || qs + BQ - 1 - k0 < window);
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = softcap * tanhf(sc[i] * scale / softcap) * LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    }
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + (e >= 2 ? 8 : 0);
          const int ki = k0 + 8 * i + 2 * t4 + (e & 1);
          bool ok = qi >= ki;
          if (window > 0) ok = ok && (qi - ki < window);
          if (prefix_len > 0) ok = ok || (qi < prefix_len && ki < prefix_len);
          ok = ok && ki < S;
          if (!ok) sc[4 * i + e] = NEG_INF;
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = fast_exp2(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2(sc[i] - m_run[(i >> 1) & 1]);
      sc[i] = p;
      l_run[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // O = corr * O + P V of tile j: V's tile is [keys][head_dim], N-contiguous
  // (MN-major B): 8-key groups 1024 bytes apart, 64-column boxes BOX_BYTES
  // apart.  O may be touched only after the previous P.V has retired.
  auto issue_pv = [&](int j, const uint32_t (&pa)[4][4], const float (&corr)[2]) {
    const int s = j % C::STAGES;
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[4 * i + 0] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
    const uint32_t v_addr = smem_u32(v_s + s * C::TILE_BYTES);
    mbar_wait(v_full + s, (j / C::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sw128_desc(v_addr + kk * 16 * 128, BOX_BYTES, 1024);
      if constexpr (DH == 128) {
        wgmma_m64n128k16_rs_tb(acc, pa[kk], db);
      } else {
        wgmma_m64n64k16_rs_tb(acc, pa[kk], db);
      }
    }
    wgmma_commit();
  };

  uint32_t pa[4][4];
  float corr[2];
  // steady state, one wgmma group of each kind in flight: Q.K^T (j + 1)
  // beside tile j's softmax, P.V (j) beside the wait for tile j + 1's scores
  auto step = [&](float (&cur)[32], float (&nxt)[32], int j) {
    issue_qk(nxt, j + 1);
    softmax(cur, j, pa, corr);
    wgmma_wait<1>();                                   // P.V (j - 1) has retired
    if (j > 0) mbar_arrive(v_empty + (j - 1) % C::STAGES);
    issue_pv(j, pa, corr);
    wgmma_wait<1>();                                   // Q.K^T (j + 1) has retired
    fence_regs(nxt);
    mbar_arrive(k_empty + (j + 1) % C::STAGES);
  };
  auto last = [&](float (&cur)[32], int j) {
    softmax(cur, j, pa, corr);
    wgmma_wait<0>();
    issue_pv(j, pa, corr);
    wgmma_wait<0>();
    fence_regs(acc);
  };

  mbar_wait(q_full, 0);
  float sa[32], sb[32];                                // score tiles, used in turn
  issue_qk(sa, 0);
  wgmma_wait<0>();
  fence_regs(sa);
  mbar_arrive(k_empty);
  int j = 0;
  for (; j + 2 < n_tiles; j += 2) {
    step(sa, sb, j);
    step(sb, sa, j + 1);
  }
  if (j + 1 < n_tiles) {
    step(sa, sb, j);
    last(sb, j + 1);
  } else {
    last(sa, j);
  }

  // full row sums across the quad, normalize, store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    l_run[h] = 1.f / fmaxf(l_run[h], 1e-30f);
  }
  __nv_bfloat16* ob = o + static_cast<long>(row) * S * DH;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long>(r0) * DH + col) =
          __floats2bfloat162_rn(acc[4 * i + 0] * l_run[0], acc[4 * i + 1] * l_run[0]);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long>(r0 + 8) * DH + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * l_run[1], acc[4 * i + 3] * l_run[1]);
  }
}

// cuTensorMapEncodeTiled is a driver call: fetched through the runtime, so
// the library links against nothing beyond cudart
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map (head_dim, S, rows) of a [rows, S, head_dim] bf16 tensor; boxes of
// 64 columns x 64 tokens x 1 row, 128-byte swizzle, zero fill past S
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Dh, int S, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dh) * 2,
                                 static_cast<cuuint64_t>(S) * Dh * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bhq, int S, int kv_repeat,
           float scale, int window, int prefix_len, float softcap, cudaStream_t st) {
  static_assert(BQ == BK, "one box shape serves Q, K and V");
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, q, DH, S, bhq) || !make_map(enc, &mk, k, DH, S, bhq / kv_repeat) ||
      !make_map(enc, &mv, v, DH, S, bhq / kv_repeat))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DH>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bhq, (S + BQ - 1) / BQ);
  flash_prefill_kernel<DH><<<grid, THREADS, Cfg<DH>::SMEM, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, kv_repeat, scale, scale * LOG2E, window,
      prefix_len, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    int bhq, int S, int Dh, int kv_repeat, float scale,
                                    int window, int prefix_len, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<128>(q, k, v, o, bhq, S, kv_repeat, scale, window, prefix_len,
                                    softcap, st);
  if (Dh == 64) return launch<64>(q, k, v, o, bhq, S, kv_repeat, scale, window, prefix_len,
                                  softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
