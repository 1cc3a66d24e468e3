// GEAR decode attention over the compressed KV history, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gear_decode.py::gear_decode (Pallas `_kernel`),
// the fused dequant + low-rank + outlier decode attention of one query token
// per (batch, kv-head) row over that row's closed chunks, and its paged twin
// gear_decode_paged, which reads each chunk from a pool page named by the
// slot's block table (page 0 is the pool's zero page).  Streaming prefill
// runs the dense kernel as its history scorer with the block's G x T query
// rows per (batch, kv-head) row.
//
// What bounds it on the H100: bytes.  A decode step reads each row's packed
// codes, quant stats, low-rank factors and outliers once (~15 KB per row and
// 64-token chunk at 4 bits, head_dim 128) and does a few hundred flops per
// byte read at most -- far below the ~295 flop/byte the card needs before
// compute matters.  A step also has few rows (batch x kv heads = 128 on the
// main path), too few to fill 132 SMs with one block per row.
//
// What the design does about it: flash-decoding.  One block per (chunk, row)
// dequantizes its chunk straight from the packed words into shared memory
// (f32), adds the outliers, scores with the factored low-rank term
// q.k_hat + (q.B_c).A_c^T, and writes an unnormalised partial (acc, m, l).
// The FP16 cache is never materialised in device memory.  A second small
// kernel merges each row's partials.  Blocks whose chunk starts at or past
// the row's n_comp return at once, so a step reads only the live history.
// That skip is exact for every row with n_comp > 0; for n_comp == 0 the
// merged triple is (0, -1e30, 0) instead of the reference's uniform softmax
// over masked rows, which changes no output that the FP16-buffer merge keeps
// (see ops._merge_buffer).  An outlier index stored twice is added twice,
// as the reference's one-hot sum does: each K channel's and each V token's
// outliers are added by one thread, in order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float bf(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (C, BH); one block per (chunk c, row bh).  PAGED reads the chunk's
// operands from pool page row bt[b, c] * H + h (each pool row holds one
// chunk: S = nb tokens, 1 chunk row); the dense layout reads row bh at chunk
// offset c.  Nothing else differs, so both give the same bits on the same
// values.
template <bool PAGED>
__global__ void __launch_bounds__(THREADS) gear_decode_partial(
    const float* __restrict__ q,                 // [BH, G, Dh]
    const int32_t* __restrict__ k_packed,        // [BH, S, L]
    const __nv_bfloat16* __restrict__ k_scale,   // [BH, C, Dh]
    const __nv_bfloat16* __restrict__ k_zero,
    const int32_t* __restrict__ v_packed,        // [BH, S, L]
    const __nv_bfloat16* __restrict__ v_scale,   // [BH, S, gv]
    const __nv_bfloat16* __restrict__ v_zero,
    const __nv_bfloat16* __restrict__ k_a,       // [BH, S, r] or null
    const __nv_bfloat16* __restrict__ k_b,       // [BH, C, Dh, r]
    const __nv_bfloat16* __restrict__ v_a,
    const __nv_bfloat16* __restrict__ v_b,
    const __nv_bfloat16* __restrict__ k_sp_val,  // [BH, C, Dh, ks] or null
    const int32_t* __restrict__ k_sp_idx,
    const __nv_bfloat16* __restrict__ v_sp_val,  // [BH, S, kv]
    const int32_t* __restrict__ v_sp_idx,
    const int32_t* __restrict__ n_comp,          // [BH]
    float* __restrict__ part_acc,                // [BH, C, G, Dh]
    float* __restrict__ part_m,                  // [BH, C, G]
    float* __restrict__ part_l,
    const int32_t* __restrict__ bt,              // [B, C] block tables (PAGED only)
    int H, int G, int S, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    float scale) {
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int C = S / nb;
  const int t0 = c * nb;
  const int n_valid = n_comp[bh];
  if (t0 >= n_valid) return;  // chunk wholly past this row's history

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int per = 32 / bits;
  const int L = Dh / per;
  const uint32_t mask = (1u << bits) - 1u;
  const int vgrp = Dh / gv;

  extern __shared__ float smem[];
  float* khat = smem;               // [nb, Dh]
  float* vhat = khat + nb * Dh;     // [nb, Dh]
  float* qs = vhat + nb * Dh;       // [G, Dh]
  float* sc = qs + G * Dh;          // [G, nb] scores, then probabilities
  float* qb = sc + G * nb;          // [G, r]
  float* pa = qb + G * (r > 0 ? r : 1);  // [G, r]

  long row_tok, row_chk;                        // first token row, chunk row
  if (PAGED) {
    const long page_row = (long)bt[(bh / H) * C + c] * H + bh % H;
    row_tok = page_row * nb;
    row_chk = page_row;
  } else {
    row_tok = (long)bh * S + t0;
    row_chk = (long)bh * C + c;
  }
  const long out_chk = (long)bh * C + c;        // partial-output row

  for (int i = tid; i < G * Dh; i += THREADS) qs[i] = q[(long)bh * G * Dh + i];

  // ---- dequantize the chunk's K and V into shared memory -----------------
  for (int i = tid; i < nb * Dh; i += THREADS) {
    const int t = i / Dh, d = i % Dh;
    const int lane_w = d / per, sh = (d % per) * bits;
    const uint32_t kw = (uint32_t)k_packed[(row_tok + t) * L + lane_w];
    const uint32_t vw = (uint32_t)v_packed[(row_tok + t) * L + lane_w];
    const float kc = (float)((kw >> sh) & mask);
    const float vc = (float)((vw >> sh) & mask);
    khat[i] = kc * bf(k_scale, row_chk * Dh + d) + bf(k_zero, row_chk * Dh + d);
    const long vs = (row_tok + t) * gv + d / vgrp;
    vhat[i] = vc * bf(v_scale, vs) + bf(v_zero, vs);
  }
  __syncthreads();

  // ---- outliers: one thread per K channel / per V token, in index order ---
  if (k_sp_val != nullptr) {
    for (int d = tid; d < Dh; d += THREADS) {
      const long base = (row_chk * Dh + d) * ks;
      for (int j = 0; j < ks; ++j) {
        const int t = k_sp_idx[base + j];
        if (t >= 0 && t < nb) khat[t * Dh + d] += bf(k_sp_val, base + j);
      }
    }
    for (int t = tid; t < nb; t += THREADS) {
      const long base = (row_tok + t) * kv;
      for (int j = 0; j < kv; ++j) {
        const int d = v_sp_idx[base + j];
        if (d >= 0 && d < Dh) vhat[t * Dh + d] += bf(v_sp_val, base + j);
      }
    }
  }
  // ---- low-rank query projection q.B_c ------------------------------------
  if (k_a != nullptr) {
    for (int p = warp; p < G * r; p += WARPS) {
      const int g = p / r, rr = p % r;
      float acc = 0.f;
      for (int d = lane; d < Dh; d += 32)
        acc += qs[g * Dh + d] * bf(k_b, (row_chk * Dh + d) * r + rr);
      acc = warp_sum(acc);
      if (lane == 0) qb[p] = acc;
    }
  }
  __syncthreads();

  // ---- scores: q.k_hat + (q.B_c).A_c^T, scaled, masked past n_comp --------
  for (int p = warp; p < G * nb; p += WARPS) {
    const int g = p / nb, t = p % nb;
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32) acc += qs[g * Dh + d] * khat[t * Dh + d];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (k_a != nullptr) {
        float lr = 0.f;
        for (int rr = 0; rr < r; ++rr) lr += qb[g * r + rr] * bf(k_a, (row_tok + t) * r + rr);
        acc += lr;
      }
      sc[p] = (t0 + t < n_valid) ? acc * scale : NEG_INF;
    }
  }
  __syncthreads();

  // ---- chunk-local softmax statistics -------------------------------------
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int t = lane; t < nb; t += 32) mx = fmaxf(mx, sc[g * nb + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < nb; t += 32) {
      const float e = expf(sc[g * nb + t] - mx);
      sc[g * nb + t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[out_chk * G + g] = mx;
      part_l[out_chk * G + g] = sum;
    }
  }
  __syncthreads();

  // ---- p.A_v ----------------------------------------------------------------
  if (v_a != nullptr) {
    for (int p = warp; p < G * r; p += WARPS) {
      const int g = p / r, rr = p % r;
      float acc = 0.f;
      for (int t = lane; t < nb; t += 32) acc += sc[g * nb + t] * bf(v_a, (row_tok + t) * r + rr);
      acc = warp_sum(acc);
      if (lane == 0) pa[p] = acc;
    }
    __syncthreads();
  }

  // ---- acc = p.V_hat + (p.A_v).B_v^T ----------------------------------------
  for (int i = tid; i < G * Dh; i += THREADS) {
    const int g = i / Dh, d = i % Dh;
    float acc = 0.f;
    for (int t = 0; t < nb; ++t) acc += sc[g * nb + t] * vhat[t * Dh + d];
    if (v_a != nullptr) {
      float lr = 0.f;
      for (int rr = 0; rr < r; ++rr) lr += pa[g * r + rr] * bf(v_b, (row_chk * Dh + d) * r + rr);
      acc += lr;
    }
    part_acc[(out_chk * G + g) * Dh + d] = acc;
  }
}

// grid (BH); merges the live chunks' partials of one row.
__global__ void __launch_bounds__(THREADS) gear_decode_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int32_t* __restrict__ n_comp,
    float* __restrict__ acc, float* __restrict__ m_out, float* __restrict__ l_out,
    int G, int C, int nb, int Dh) {
  const int bh = blockIdx.x;
  int live = (n_comp[bh] + nb - 1) / nb;
  live = live < 0 ? 0 : (live > C ? C : live);
  for (int g = 0; g < G; ++g) {
    float m = NEG_INF;
    for (int c = 0; c < live; ++c) m = fmaxf(m, part_m[((long)bh * C + c) * G + g]);
    float l = 0.f;
    for (int c = 0; c < live; ++c) {
      const long j = ((long)bh * C + c) * G + g;
      l += part_l[j] * expf(part_m[j] - m);
    }
    for (int d = threadIdx.x; d < Dh; d += THREADS) {
      float a = 0.f;
      for (int c = 0; c < live; ++c) {
        const long j = ((long)bh * C + c) * G + g;
        a += part_acc[j * Dh + d] * expf(part_m[j] - m);
      }
      acc[((long)bh * G + g) * Dh + d] = a;
    }
    if (threadIdx.x == 0) {
      m_out[(long)bh * G + g] = m;
      l_out[(long)bh * G + g] = l;
    }
  }
}

template <bool PAGED>
int launch(const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
           const void* v_packed, const void* v_scale, const void* v_zero,
           const void* k_a, const void* k_b, const void* v_a, const void* v_b,
           const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val,
           const void* v_sp_idx, const void* n_comp, const void* bt, void* part_acc,
           void* part_m, void* part_l, void* acc, void* m, void* l,
           int BH, int H, int G, int C, int nb, int Dh, int bits, int gv, int r, int ks,
           int kv, float scale, void* stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)nb * Dh + (size_t)G * Dh + (size_t)G * nb + 2 * (size_t)G * (r > 0 ? r : 1));
  cudaError_t err = cudaFuncSetAttribute(
      gear_decode_partial<PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  gear_decode_partial<PAGED><<<dim3(C, BH), THREADS, smem, st>>>(
      (const float*)q, (const int32_t*)k_packed,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)k_zero,
      (const int32_t*)v_packed, (const __nv_bfloat16*)v_scale, (const __nv_bfloat16*)v_zero,
      (const __nv_bfloat16*)k_a, (const __nv_bfloat16*)k_b,
      (const __nv_bfloat16*)v_a, (const __nv_bfloat16*)v_b,
      (const __nv_bfloat16*)k_sp_val, (const int32_t*)k_sp_idx,
      (const __nv_bfloat16*)v_sp_val, (const int32_t*)v_sp_idx,
      (const int32_t*)n_comp, (float*)part_acc, (float*)part_m, (float*)part_l,
      (const int32_t*)bt, H, G, C * nb, nb, Dh, bits, gv, r, ks, kv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gear_decode_combine<<<BH, THREADS, 0, st>>>(
      (const float*)part_acc, (const float*)part_m, (const float*)part_l,
      (const int32_t*)n_comp, (float*)acc, (float*)m, (float*)l, G, C, nb, Dh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gear_decode_launch(
    const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
    const void* v_packed, const void* v_scale, const void* v_zero,
    const void* k_a, const void* k_b, const void* v_a, const void* v_b,
    const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
    const void* n_comp, void* part_acc, void* part_m, void* part_l,
    void* acc, void* m, void* l,
    int BH, int G, int S, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    float scale, void* stream) {
  return launch<false>(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a, k_b, v_a,
                       v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx, n_comp, nullptr, part_acc,
                       part_m, part_l, acc, m, l, BH, 1, G, S / nb, nb, Dh, bits, gv, r, ks,
                       kv, scale, stream);
}

// Paged twin: pool operands [P*H, nb or 1, ...] and block tables bt [B, C].
extern "C" int gear_decode_paged_launch(
    const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
    const void* v_packed, const void* v_scale, const void* v_zero,
    const void* k_a, const void* k_b, const void* v_a, const void* v_b,
    const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
    const void* n_comp, const void* bt, void* part_acc, void* part_m, void* part_l,
    void* acc, void* m, void* l,
    int BH, int H, int G, int C, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    float scale, void* stream) {
  return launch<true>(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a, k_b, v_a,
                      v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx, n_comp, bt, part_acc,
                      part_m, part_l, acc, m, l, BH, H, G, C, nb, Dh, bits, gv, r, ks, kv,
                      scale, stream);
}
