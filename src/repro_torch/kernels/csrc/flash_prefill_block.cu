// Causal attention of in-flight prefill blocks, unnormalised, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill_block (Pallas
// `_block_kernel`): for each query row-group n, the T (<= 64) queries of one
// chunk attend the same chunk's keys with a causal mask and a tail mask
// (key j visible to query t iff j <= t and j < kv_len[n]; masked scores are
// -1e30 before the max, softcap before the mask), and the kernel returns
// the unnormalised triple (acc [N, T, Dh], m [N, T], l [N, T]) that
// ops.gear_attend_block merges with the compressed history's.  A GQA row
// group n reads K/V row n / kv_repeat.
//
// What bounds it on the H100: bytes.  A row group reads q, k and v (3 T Dh
// f32) and writes T (Dh + 2) f32: 58.95 MB for the streaming prefill's
// [448, 64, 128] call, 17.6 us at 3.35 TB/s, against 0.48 GFLOP of visible
// pairs (2.9 us even as three TF32 products at 495 TFLOP/s).
//
// What the design does about it:
// - one block per K/V row, four warps per query row group, a 16-row query
//   tile each; with kv_repeat > 1 a block serves two row groups that share
//   K/V (staged once).  K and V arrive by 16-byte cp.async copies in two
//   groups (the scores start when K has landed), rows padded (K by 4 floats,
//   V by 8) so every fragment read of a quarter-warp hits 8 distinct 16-byte
//   bank groups: 68.6 KB and <= 170 registers a thread at Dh 128, three
//   blocks (12 warps) per SM;
// - both products run on the tensor cores, mma.sync m16n8k8 in TF32 with
//   each f32 operand split hi + lo and multiplied three times
//   (mma_tf32.cuh), ~2^-19 relative error per product;
// - a warp computes only the key blocks of 8 that one of its rows can see
//   (causal diagonal and kv_len, rounded up to an even count), masking
//   inside them; the count is a template constant, so the products of all
//   its accumulators interleave (each of the three passes runs over them in
//   turn) and the unrolled variants stay few;
// - q goes from device memory straight into A fragments, 64 columns at a
//   time with the next 64 in flight (16-byte loads; the contraction order
//   is permuted so one float4 feeds two k-steps);
// - the score tile stays in registers: row max and sum by quad shuffles, and
//   the accumulator fragment of 8 keys is the A fragment of P.V (keys permuted
//   so that score column 2 tg holds key tg and 2 tg + 1 key tg + 4, matching
//   the A fragment's k = tg, tg + 4);
// - P.V's output columns are permuted so that a lane holds 8 consecutive
//   columns of a row per 32: acc is written in 16-byte stores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TMAX = 64;          // most rows of a block
constexpr int KPAD = 4;           // K row padding (floats): conflict-free B fragments of q.k
constexpr int VPAD = 8;           // V row padding: conflict-free B fragments of P.V
constexpr int WARPS = TMAX / 16;  // warps of a row group: one 16-row query tile each
constexpr int NKB_STEP = 2;       // key blocks are computed in steps of two
constexpr int QCH_COLS = 64;      // q columns held in registers at once

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// q rows r0 + g and r0 + g + 8, columns [c0, c0 + QCH): lane tg holds
// columns c0 + 16 j + 4 tg .. + 3 of each, the A fragments of k-steps 2 j
// (x, y) and 2 j + 1 (z, w)
template <int QCH>
__device__ __forceinline__ void load_q(float4 (&qa)[QCH / 16], float4 (&qb)[QCH / 16],
                                       const float* qn, int DH, int r0, int T, int c0, int g,
                                       int tg) {
  const int ra = r0 + g, rb = ra + 8;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < QCH / 16; ++j) {
    const int col = c0 + 16 * j + 4 * tg;
    qa[j] = ra < T ? ld4(qn + (long)ra * DH + col) : z;
    qb[j] = rb < T ? ld4(qn + (long)rb * DH + col) : z;
  }
}

// s[kb] += q K^T over columns [c0, c0 + QCH) for key blocks kb < NKB;
// column n of block kb is key 8 kb + n / 2 + 4 (n % 2).  NKB is a constant,
// so the NKB accumulators' products interleave in one basic block: each
// pass (lo.hi, hi.lo, hi.hi) runs over all of them in turn.
template <int DH, int QCH, int NKB>
__device__ __forceinline__ void score_chunk(float (&s)[8][4], const float4 (&qa)[QCH / 16],
                                            const float4 (&qb)[QCH / 16], const float* ks,
                                            int c0, int g, int tg) {
  constexpr int KS = DH + KPAD;
  const float* kr = ks + ((g >> 1) + 4 * (g & 1)) * KS + c0 + 4 * tg;
#pragma unroll
  for (int j = 0; j < QCH / 16; ++j) {
    float4 kv[NKB];
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) kv[kb] = ld4(kr + kb * 8 * KS + 16 * j);
#pragma unroll
    for (int st = 0; st < 2; ++st) {                 // k-steps 2 j (x, y) and 2 j + 1 (z, w)
      uint32_t ah[4], al[4], bh[NKB][2], bl[NKB][2];
      split(st ? qa[j].z : qa[j].x, ah[0], al[0]);
      split(st ? qb[j].z : qb[j].x, ah[1], al[1]);
      split(st ? qa[j].w : qa[j].y, ah[2], al[2]);
      split(st ? qb[j].w : qb[j].y, ah[3], al[3]);
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) {
        split(st ? kv[kb].z : kv[kb].x, bh[kb][0], bl[kb][0]);
        split(st ? kv[kb].w : kv[kb].y, bh[kb][1], bl[kb][1]);
      }
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) mma_tf32(s[kb], al, bh[kb]);
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) mma_tf32(s[kb], ah, bl[kb]);
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) mma_tf32(s[kb], ah, bh[kb]);
    }
  }
}

// the scores of one 16-row query tile: s = q K^T over all DH columns for the
// tile's nkb key blocks, QCH columns at a time (chunk 0 of q already in qa,
// qb; the next chunk's loads are in flight during this chunk's products)
template <int DH, int QCH>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], float4 (&qa)[QCH / 16],
                                            float4 (&qb)[QCH / 16], const float* qn,
                                            const float* ks, int r0, int T, int nkb, int g,
                                            int tg) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[kb][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < DH; c0 += QCH) {
    float4 na[QCH / 16], nb[QCH / 16];
    const bool more = c0 + QCH < DH;
    if (more) load_q<QCH>(na, nb, qn, DH, r0, T, c0 + QCH, g, tg);
    switch (nkb) {
      case 2: score_chunk<DH, QCH, 2>(s, qa, qb, ks, c0, g, tg); break;
      case 4: score_chunk<DH, QCH, 4>(s, qa, qb, ks, c0, g, tg); break;
      case 6: score_chunk<DH, QCH, 6>(s, qa, qb, ks, c0, g, tg); break;
      default: score_chunk<DH, QCH, 8>(s, qa, qb, ks, c0, g, tg); break;
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < QCH / 16; ++j) {
        qa[j] = na[j];
        qb[j] = nb[j];
      }
    }
  }
}

// mask, row statistics, P V and the stores of one 16-row query tile
template <int DH>
__device__ __forceinline__ void finish_tile(float (&s)[8][4], const float* vs, float* accn,
                                            float* mn, float* ln, int r0, int T, int len,
                                            int nkb, float scale, float softcap, int g, int tg) {
  constexpr int VS = DH + VPAD;
  constexpr int PW = DH < 128 ? DH : 128;   // output columns of one pass
  constexpr int NBP = PW / 8;               // n-blocks of a pass
  float mx[2] = {-INFINITY, -INFINITY};     // rows r0 + g, r0 + g + 8
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + ((e & 2) ? 8 : 0);
        const int key = kb * 8 + tg + ((e & 1) ? 4 : 0);
        float x = s[kb][e] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        x = key >= T ? -INFINITY : (key <= row && key < len ? x : NEG_INF);
        s[kb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[kb][e] - mx[e >> 1]);
        s[kb][e] = p;
        sum[e >> 1] += p;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const int row = r0 + g + 8 * h;
    if (tg == 0 && row < T) {
      mn[row] = mx[h];
      ln[row] = sum[h];
    }
  }

  // acc = P V.  B column n of n-block j (= 4 J + e) of a pass is output
  // column p0 + 32 J + 4 n + e: lane g reads one float4 of a V row per J and
  // lane tg ends up holding columns p0 + 32 J + 8 tg .. + 7 of its two rows.
#pragma unroll
  for (int p0 = 0; p0 < DH; p0 += PW) {
    float o[NBP][4];
#pragma unroll
    for (int j = 0; j < NBP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      if (kb < nkb) {
        uint32_t ah[4], al[4];             // keys 8 kb + tg (k = tg), 8 kb + tg + 4 (k = tg + 4)
        split(s[kb][0], ah[0], al[0]);
        split(s[kb][2], ah[1], al[1]);
        split(s[kb][1], ah[2], al[2]);
        split(s[kb][3], ah[3], al[3]);
        const float* v0 = vs + (kb * 8 + tg) * VS + p0 + 4 * g;
#pragma unroll
        for (int J = 0; J < NBP / 4; ++J) {
          const float4 a = ld4(v0 + 32 * J), b = ld4(v0 + 4 * VS + 32 * J);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split(av[e], bh[e][0], bl[e][0]);
            split(bv[e], bh[e][1], bl[e][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_tf32(o[4 * J + e], al, bh[e]);
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_tf32(o[4 * J + e], ah, bl[e]);
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_tf32(o[4 * J + e], ah, bh[e]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row < T) {
        float* dst = accn + (long)row * DH + p0 + 8 * tg;
#pragma unroll
        for (int J = 0; J < NBP / 4; ++J) {
          st4(dst + 32 * J, o[4 * J][2 * h], o[4 * J + 1][2 * h], o[4 * J + 2][2 * h],
              o[4 * J + 3][2 * h]);
          st4(dst + 32 * J + 4, o[4 * J][2 * h + 1], o[4 * J + 1][2 * h + 1],
              o[4 * J + 2][2 * h + 1], o[4 * J + 3][2 * h + 1]);
        }
      }
    }
  }
}

// key blocks of 8 that query tile `tile` computes: the causal diagonal and
// kv_len; with kv_len <= 0 every score is masked and all T keys count
__device__ __forceinline__ int key_blocks(int tile, int T, int len) {
  const int n = len > 0 ? min(2 * (tile + 1), (min(len, T) + 7) / 8) : (T + 7) / 8;
  return min(8, (n + NKB_STEP - 1) / NKB_STEP * NKB_STEP);
}

// grid (N / kv_repeat, ceil(kv_repeat / GROUPS)), 128 GROUPS threads: warp w
// takes query tile w % 4 of row group blockIdx.y * GROUPS + w / 4 of K/V row
// blockIdx.x.  GROUPS = 1 keeps a warp under 170 registers, three blocks
// (12 warps) per SM.
template <int DH, int GROUPS>
__global__ void __launch_bounds__(128 * GROUPS, GROUPS == 1 ? 3 : 1) flash_block_kernel(
    const float* __restrict__ q,         // [N, T, DH]
    const float* __restrict__ k,         // [N / kv_repeat, T, DH]
    const float* __restrict__ v,
    const int32_t* __restrict__ kv_len,  // [N]
    float* __restrict__ acc,             // [N, T, DH]
    float* __restrict__ m_out,           // [N, T]
    float* __restrict__ l_out,
    int T, int kv_repeat, float scale, float softcap) {
  constexpr int KS = DH + KPAD, VS = DH + VPAD;
  constexpr int QCH = DH < QCH_COLS ? DH : QCH_COLS;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [TMAX][KS]
  float* vs = ks + TMAX * KS;                // [TMAX][VS]

  const int x = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int grp = blockIdx.y * GROUPS + warp / WARPS, tile = warp % WARPS;
  const bool active = grp < kv_repeat;
  const long n = (long)x * kv_repeat + grp;

  // K, then V, of the row: rows [T, 64) zero-filled
  constexpr int Q4 = DH / 4;
  const float* kg = k + (long)x * T * DH;
  const float* vg = v + (long)x * T * DH;
  for (int i = threadIdx.x; i < TMAX * Q4; i += blockDim.x) {
    const int r = i / Q4, c = (i % Q4) * 4;
    cp_async16(ks + r * KS + c, r < T ? kg + (long)r * DH + c : kg, r < T);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < TMAX * Q4; i += blockDim.x) {
    const int r = i / Q4, c = (i % Q4) * 4;
    cp_async16(vs + r * VS + c, r < T ? vg + (long)r * DH + c : vg, r < T);
  }
  cp_async_commit();

  const int len = active ? kv_len[n] : 0;
  const float* qn = q + n * T * DH;
  const bool has = active && 16 * tile < T;
  const int nkb = key_blocks(tile, T, len);
  float s[8][4];
  float4 qa[QCH / 16], qb[QCH / 16];
  if (has) load_q<QCH>(qa, qb, qn, DH, 16 * tile, T, 0, g, tg);   // during the copies
  cp_async_wait<1>();
  __syncthreads();                           // K has landed
  if (has) tile_scores<DH, QCH>(s, qa, qb, qn, ks, 16 * tile, T, nkb, g, tg);
  cp_async_wait<0>();
  __syncthreads();                           // V has landed
  if (has)
    finish_tile<DH>(s, vs, acc + n * T * DH, m_out + n * T, l_out + n * T, 16 * tile, T, len,
                    nkb, scale, softcap, g, tg);
}

template <int DH, int GROUPS>
int launch(const float* q, const float* k, const float* v, const int32_t* kv_len, float* acc,
           float* m, float* l, int N, int T, int kv_repeat, float scale, float softcap,
           cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * TMAX * (2 * DH + KPAD + VPAD);
  static bool smem_set = false;        // the attribute is the function's; set it once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<DH, GROUPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid(N / kv_repeat, (kv_repeat + GROUPS - 1) / GROUPS);
  flash_block_kernel<DH, GROUPS><<<grid, 128 * GROUPS, smem, stream>>>(
      q, k, v, kv_len, acc, m, l, T, kv_repeat, scale, softcap);
  return (int)cudaGetLastError();
}

// without GQA a block serves one row group; with it, two that share K/V
template <int DH>
int launch_dh(const float* q, const float* k, const float* v, const int32_t* kv_len, float* acc,
              float* m, float* l, int N, int T, int kv_repeat, float scale, float softcap,
              cudaStream_t st) {
  return kv_repeat == 1
             ? launch<DH, 1>(q, k, v, kv_len, acc, m, l, N, T, kv_repeat, scale, softcap, st)
             : launch<DH, 2>(q, k, v, kv_len, acc, m, l, N, T, kv_repeat, scale, softcap, st);
}

}  // namespace

// Dh 64, 128 and 256 are instantiated; another returns cudaErrorInvalidValue.
extern "C" int flash_block_launch(const void* q, const void* k, const void* v,
                                  const void* kv_len, void* acc, void* m, void* l,
                                  int N, int T, int Dh, int kv_repeat, float scale,
                                  float softcap, void* stream) {
  if (T < 0 || T > TMAX || kv_repeat < 1 || N % kv_repeat) return (int)cudaErrorInvalidValue;
  if (N == 0 || T == 0) return 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const int32_t* lens = (const int32_t*)kv_len;
  float *af = (float*)acc, *mf = (float*)m, *lf = (float*)l;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Dh) {
    case 64: return launch_dh<64>(qf, kf, vf, lens, af, mf, lf, N, T, kv_repeat, scale, softcap, st);
    case 128:
      return launch_dh<128>(qf, kf, vf, lens, af, mf, lf, N, T, kv_repeat, scale, softcap, st);
    case 256:
      return launch_dh<256>(qf, kf, vf, lens, af, mf, lf, N, T, kv_repeat, scale, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
