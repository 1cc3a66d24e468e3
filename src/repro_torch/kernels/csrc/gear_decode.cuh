// GEAR decode attention over the compressed KV history, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gear_decode.py::gear_decode (Pallas `_kernel`),
// the fused dequant + low-rank + outlier decode attention of a row's query
// rows over that (batch, kv-head) row's closed chunks, and its paged twin
// gear_decode_paged, which reads each chunk from a pool page named by the
// slot's block table (page 0 is the pool's zero page).  The streaming
// prefill's history scorer is the same function with G * T query rows per
// row and one extent per in-flight block.
//
// The math never forms k_hat or v_hat.  The per-chunk, per-channel K stats
// fold into the query and the per-token V stats into p:
//   score_t = sum_d (q_d s_d) code_td + q.z + (q.B_c).a_t + sum_d q_d sp_td
//   acc_d   = sum_t (p_t s_t,g(d)) code_td + sum_t p_t z_t,g(d)
//             + (p.A_v).B_v,d + sum_t p_t sp_td
// One source, two regimes, one body per regime shared by the dense and the
// PAGED layouts (only the chunk's row addresses differ), so the paged
// triple equals the dense one on gathered operands bit for bit.
//
// (a) Decode (G <= 16 query rows per row: llama2's G = 1, hymba's G = 5,
//     gemma's G = 8, starcoder2's G = 12; built for G = 1, G <= 8 and
//     8 < G <= 16, so a row's registers hold only the rows it can have).
//     Bound by bytes: each live chunk's fields are read once, in 16-byte
//     cp.async copies into a double-buffered stage, the next chunk's copy in
//     flight while the current one is scored.  Scores and P.V run on CUDA
//     cores straight from the packed words; a thread owns Dh / 128 channels
//     of the per-channel terms (two at head_dim 256).  Outliers are added as 2^-24
//     fixed-point shared-memory atomics: integer sums do not depend on their
//     order, so every run and both layouts give the same bits, and an index
//     stored twice adds twice.  Each block takes a run of one row's chunks
//     (flash-decoding splits, sized by the wrapper so the grid covers the
//     card); the last block of a row, found by an atomic ticket, merges the
//     row's splits in split order in the same launch.
// (b) History scorer (more than 16 query rows: the streaming prefill's
//     64-row blocks).  Bound by operations, so both products run on the
//     tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).  The codes
//     are small integers, exact in bf16; the f32 operand on the other side
//     (q * s_K, p * s_V, q, p, and the low-rank / zero-point terms) is split
//     into a bf16 hi + lo pair and multiplied twice, which keeps ~2^-16
//     relative error and never rounds k_hat.  The outliers (bf16 values)
//     are densified into bf16 tiles in slot order and take two more passes.
//     One CTA per (row, in-flight block, 64 query rows) walks the chunks
//     under the block's extent with an online softmax in registers, so one
//     launch scores every in-flight block of a layer, heaviest blocks first.
//     At head_dim 256 a warp's 16 x 256 f32 O tile and its Q fragments would
//     take ~290 registers, so the channels are split across warps instead:
//     8 warps, warps w and w + 4 own the same 16 query rows and one 128-
//     channel half each (Q fragments and O columns).  Each scores its half;
//     the two partial score tiles meet in shared memory (the K code tile's
//     space, free once the products that read it are done) and both warps
//     sum them in the same order, lower half + upper half, so they hold the
//     same scores, softmax and P bit for bit and each runs P.V for its own
//     O columns.  Its tiles take ~152 KB of shared memory beside the two
//     stage buffers: one CTA of 256 threads per SM.
// ptxas -v (sm_90a, nvcc 12.9, printed by chip_smoke.py phase 2): history
// bodies 255 registers (Dh 256: 28-60 bytes of spill stores; Dh 128: 14-30;
// Dh 64: 236 registers, none); decode builds 64-255 registers, with spills
// of up to ~200 bytes, but 772-3,456 bytes for 2-bit codes at 8 < G <= 16
// (16 rows x 16 codes of accumulators a thread; no serving path runs it).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;                   // most query rows of the decode regime
constexpr int GMID = 8;                    // its middle build: 1 < G <= GMID
constexpr float FIX = 16777216.f;          // 2^24: outlier fixed point
constexpr float INV_FIX = 1.f / 16777216.f;

typedef __nv_bfloat16 bf16;

// every operand of either regime; a null low-rank / outlier pointer means
// the policy has none
struct Operands {
  const int32_t* k_packed;   // [rows, S, L]
  const bf16* k_scale;       // [rows, C, Dh]
  const bf16* k_zero;
  const int32_t* v_packed;   // [rows, S, L]
  const bf16* v_scale;       // [rows, S, gv]
  const bf16* v_zero;
  const bf16* k_a;           // [rows, S, r]
  const bf16* k_b;           // [rows, C, Dh, r]
  const bf16* v_a;
  const bf16* v_b;
  const bf16* k_sp_val;      // [rows, C, Dh, ks]
  const int32_t* k_sp_idx;
  const bf16* v_sp_val;      // [rows, S, kv]
  const int32_t* v_sp_idx;
  const int32_t* bt;         // [B, C] block tables (PAGED only)
  int H, C, nb, Dh, bits, gv, r, ks, kv;
};

// byte offsets of one chunk's fields inside a stage buffer (16-byte aligned)
struct Stage {
  int kp, vp, ksc, kzr, vsc, vzr, ka, kb, va, vb, ksv, ksi, vsv, vsi, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ inline Stage make_stage(const Operands& p) {
  const int L = p.Dh * p.bits / 32;
  Stage s;
  int o = 0;
  auto take = [&](int bytes) { const int at = o; o += align16(bytes); return at; };
  s.kp = take(p.nb * L * 4);
  s.vp = take(p.nb * L * 4);
  s.ksc = take(p.Dh * 2);
  s.kzr = take(p.Dh * 2);
  s.vsc = take(p.nb * p.gv * 2);
  s.vzr = take(p.nb * p.gv * 2);
  s.ka = take(p.nb * p.r * 2);
  s.kb = take(p.Dh * p.r * 2);
  s.va = take(p.nb * p.r * 2);
  s.vb = take(p.Dh * p.r * 2);
  s.ksv = take(p.Dh * p.ks * 2);
  s.ksi = take(p.Dh * p.ks * 4);
  s.vsv = take(p.nb * p.kv * 2);
  s.vsi = take(p.nb * p.kv * 4);
  s.bytes = o;
  return s;
}

// first token row and chunk row of chunk c of row bh
template <bool PAGED>
__device__ __forceinline__ void chunk_rows(const Operands& p, int bh, int c, long& row_tok,
                                           long& row_chk) {
  if (PAGED) {
    const long page_row = static_cast<long>(p.bt[(bh / p.H) * p.C + c]) * p.H + bh % p.H;
    row_tok = page_row * p.nb;
    row_chk = page_row;
  } else {
    row_tok = static_cast<long>(bh) * p.C * p.nb + static_cast<long>(c) * p.nb;
    row_chk = static_cast<long>(bh) * p.C + c;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// copy `bytes` (a multiple of 4) from global to shared, 16 bytes a thread
// where the source allows it, spread over the block's threads
__device__ __forceinline__ void stage_copy(uint8_t* dst, const void* src, int bytes) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int nt = blockDim.x;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0 && (bytes & 15) == 0) {
    for (int i = threadIdx.x * 16; i < bytes; i += nt * 16) cp_async16(dst + i, s + i);
  } else {
    for (int i = threadIdx.x * 4; i < bytes; i += nt * 4) cp_async4(dst + i, s + i);
  }
}

// issue the copies of chunk c of row bh into stage buffer `buf`
template <bool PAGED>
__device__ void stage_chunk(const Operands& p, const Stage& st, uint8_t* buf, int bh, int c) {
  long rt, rc;
  chunk_rows<PAGED>(p, bh, c, rt, rc);
  const int L = p.Dh * p.bits / 32;
  stage_copy(buf + st.kp, p.k_packed + rt * L, p.nb * L * 4);
  stage_copy(buf + st.vp, p.v_packed + rt * L, p.nb * L * 4);
  stage_copy(buf + st.ksc, p.k_scale + rc * p.Dh, p.Dh * 2);
  stage_copy(buf + st.kzr, p.k_zero + rc * p.Dh, p.Dh * 2);
  stage_copy(buf + st.vsc, p.v_scale + rt * p.gv, p.nb * p.gv * 2);
  stage_copy(buf + st.vzr, p.v_zero + rt * p.gv, p.nb * p.gv * 2);
  if (p.k_a != nullptr) {
    stage_copy(buf + st.ka, p.k_a + rt * p.r, p.nb * p.r * 2);
    stage_copy(buf + st.kb, p.k_b + rc * p.Dh * p.r, p.Dh * p.r * 2);
    stage_copy(buf + st.va, p.v_a + rt * p.r, p.nb * p.r * 2);
    stage_copy(buf + st.vb, p.v_b + rc * p.Dh * p.r, p.Dh * p.r * 2);
  }
  if (p.k_sp_val != nullptr) {
    stage_copy(buf + st.ksv, p.k_sp_val + rc * p.Dh * p.ks, p.Dh * p.ks * 2);
    stage_copy(buf + st.ksi, p.k_sp_idx + rc * p.Dh * p.ks, p.Dh * p.ks * 4);
    stage_copy(buf + st.vsv, p.v_sp_val + rt * p.kv, p.nb * p.kv * 2);
    stage_copy(buf + st.vsi, p.v_sp_idx + rt * p.kv, p.nb * p.kv * 4);
  }
  cp_async_commit();
}

__device__ __forceinline__ float bfv(const uint8_t* buf, int off, int i) {
  return __bfloat162float(reinterpret_cast<const bf16*>(buf + off)[i]);
}

// integer code -> float, exactly (codes < 2^23)
__device__ __forceinline__ float code_f(uint32_t c) {
  return __int_as_float(0x4B000000 | c) - 8388608.f;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ long long to_fix(float x) { return __float2ll_rn(x * FIX); }
__device__ __forceinline__ void add_fix(long long* dst, float x) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            static_cast<unsigned long long>(to_fix(x)));
}

// ===========================================================================
// (a) decode regime: G <= GMAX query rows per row, CUDA cores, split chunks

// shared-memory carve-up of the decode kernel (byte offsets)
struct DecodeSmem {
  int stage1, q, qs, qz, qb, kout, sc, corr, mrun, lrun, pz, pa, vout, red, merge, ticket, bytes;
};

__host__ inline DecodeSmem decode_smem(const Stage& st, int G, int Dh, int nb, int r, int gv,
                                       int n_splits) {
  DecodeSmem s;
  int o = align16(st.bytes);                 // stage 0 at offset 0
  auto take = [&](int bytes) { const int at = o; o += align16(bytes); return at; };
  s.stage1 = take(st.bytes);
  s.q = take(G * Dh * 4);
  s.qs = take(G * (Dh + 8) * 4);             // two halves of Dh / 2 + 4 floats per row
  s.qz = take(G * 4);
  s.qb = take(G * (r > 0 ? r : 1) * 4);
  s.kout = take(G * nb * 8);
  s.sc = take(G * nb * 4);
  s.corr = take(G * 4);
  s.mrun = take(G * 4);
  s.lrun = take(G * 4);
  s.pz = take(G * gv * 4);
  s.pa = take(G * (r > 0 ? r : 1) * 4);
  s.vout = take(G * Dh * 8);
  s.red = take(G * Dh * 4);
  s.merge = take((2 * n_splits + 1) * G * 4);  // the splits' m, l (then weights); final m
  s.ticket = take(16);
  s.bytes = o;
  return s;
}

template <int N>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(src)[i];
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = src[i];
  }
}

// grid (n_splits, BH), G <= GM: split s of row bh takes chunks [s * cps, (s + 1) * cps)
// of the row's live ones; a row with a single active split writes its
// triple at once, otherwise its last block (atomic ticket) merges the
// splits' partials in split order and clears the ticket for the next launch.
template <bool PAGED, int BITS, int DH, int GM>
__global__ void __launch_bounds__(THREADS) gear_decode_split(
    Operands p, Stage st, DecodeSmem sm, const float* __restrict__ q,
    const int32_t* __restrict__ n_comp, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int* __restrict__ tickets,
    float* __restrict__ out_acc, float* __restrict__ out_m, float* __restrict__ out_l, int G,
    int cps, float scale) {
  constexpr int PER = 32 / BITS;           // codes per packed word
  constexpr int L = DH / PER;              // words per token
  constexpr int HALF_W = L / 2;            // words of one score thread
  constexpr int TG = THREADS / L;          // token groups of the P.V pass
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int XC = (DH + THREADS - 1) / THREADS;  // channels of a thread's per-channel terms
  static_assert(L % 2 == 0 && THREADS % L == 0 && PER % 4 == 0 && DH <= XC * THREADS,
                "unsupported shape");
  constexpr int QS_ROW = DH + 8;           // halves DH / 2 + 4 apart: no bank conflict
  constexpr int QS_HALF = DH / 2 + 4;

  const int nb = p.nb;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int n_valid = n_comp[bh];
  const int n_live = min(max((n_valid + nb - 1) / nb, 0), p.C);
  const int n_active = max(1, (n_live + cps - 1) / cps);
  if (split >= n_active) return;
  const int c_begin = split * cps, c_end = min(n_live, c_begin + cps);

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem + sm.q);
  float* qs = reinterpret_cast<float*>(smem + sm.qs);
  float* qz = reinterpret_cast<float*>(smem + sm.qz);
  float* qb = reinterpret_cast<float*>(smem + sm.qb);
  long long* kout = reinterpret_cast<long long*>(smem + sm.kout);
  float* sc = reinterpret_cast<float*>(smem + sm.sc);
  float* corr = reinterpret_cast<float*>(smem + sm.corr);
  float* mrun = reinterpret_cast<float*>(smem + sm.mrun);
  float* lrun = reinterpret_cast<float*>(smem + sm.lrun);
  float* pz = reinterpret_cast<float*>(smem + sm.pz);
  float* pa = reinterpret_cast<float*>(smem + sm.pa);
  long long* vout = reinterpret_cast<long long*>(smem + sm.vout);
  float* red = reinterpret_cast<float*>(smem + sm.red);
  int* ticket = reinterpret_cast<int*>(smem + sm.ticket);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool sparse = p.k_sp_val != nullptr;
  const int r = p.r;                       // 0 without low-rank factors

  for (int i = tid; i < G * DH; i += THREADS) q_s[i] = q[static_cast<long>(bh) * G * DH + i];
  for (int i = tid; i < G * nb; i += THREADS) kout[i] = 0;
  if (tid < G) {
    mrun[tid] = NEG_INF;
    lrun[tid] = 0.f;
  }
  if (c_begin < c_end) stage_chunk<PAGED>(p, st, smem, bh, c_begin);

  const int w = tid % L, tg = tid / L;     // P.V pass: word w of every TG-th token
  const int grp = (w * PER) / (DH / p.gv); // this thread's V stat group
  float acc[GM][PER];
  float xacc[XC][GM];                      // per-channel terms of channels tid + x * THREADS
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int x = 0; x < XC; ++x) xacc[x][g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[g][j] = 0.f;
  }

  for (int c = c_begin; c < c_end; ++c) {
    uint8_t* buf = smem + (((c - c_begin) & 1) ? sm.stage1 : 0);
    cp_async_wait_all();
    __syncthreads();                       // chunk c staged; chunk c - 1 consumed
    if (c + 1 < c_end)
      stage_chunk<PAGED>(p, st, smem + (((c + 1 - c_begin) & 1) ? sm.stage1 : 0), bh, c + 1);
    const int t0 = c * nb;

    // -- fold the chunk's K stats into the query; q.z, q.B_c; K outliers ----
    for (int d = tid; d < DH; d += THREADS) {
      const float s = bfv(buf, st.ksc, d);
      const int pos = d < DH / 2 ? d : d + 4;
      for (int g = 0; g < G; ++g) qs[g * QS_ROW + pos] = q_s[g * DH + d] * s;
    }
    const int n_lr = 1 + r;
    for (int pi = warp; pi < G * n_lr; pi += WARPS) {
      const int g = pi / n_lr, item = pi % n_lr;
      float v = 0.f;
      for (int d = lane; d < DH; d += 32)
        v += q_s[g * DH + d] *
             (item == 0 ? bfv(buf, st.kzr, d) : bfv(buf, st.kb, d * r + item - 1));
      v = warp_sum(v);
      if (lane == 0) {
        if (item == 0) qz[g] = v;
        else qb[g * r + item - 1] = v;
      }
    }
    if (sparse) {
      const int32_t* idx = reinterpret_cast<const int32_t*>(buf + st.ksi);
      for (int e = tid; e < DH * p.ks; e += THREADS) {
        const int t = idx[e];
        if (t >= 0 && t < nb) {
          const int d = e / p.ks;
          const float val = bfv(buf, st.ksv, e);
          for (int g = 0; g < G; ++g) add_fix(&kout[g * nb + t], q_s[g * DH + d] * val);
        }
      }
    }
    for (int i = tid; i < G * DH; i += THREADS) vout[i] = 0;
    __syncthreads();

    // -- scores: two threads per token, half the words each ------------------
    const uint32_t* kwords = reinterpret_cast<const uint32_t*>(buf + st.kp);
    for (int base = 0; base < nb; base += THREADS / 2) {
      const int t = base + (tid >> 1), half = tid & 1;
      const bool on = t < nb;
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
      if (on) {
        uint32_t wv[HALF_W];
        load_words<HALF_W>(kwords + t * L + half * HALF_W, wv);
        const float* qh = qs + half * QS_HALF;
#pragma unroll
        for (int i = 0; i < HALF_W; ++i) {
          float cf[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) cf[j] = code_f((wv[i] >> (BITS * j)) & MASK);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
#pragma unroll
              for (int j4 = 0; j4 < PER / 4; ++j4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qh + g * QS_ROW + i * PER + 4 * j4);
                dot[g] += qv.x * cf[4 * j4] + qv.y * cf[4 * j4 + 1] + qv.z * cf[4 * j4 + 2] +
                          qv.w * cf[4 * j4 + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
      if (on && half == 0) {
        for (int g = 0; g < G; ++g) {
          float s = dot[g] + qz[g];
          for (int rr = 0; rr < r; ++rr) s += qb[g * r + rr] * bfv(buf, st.ka, t * r + rr);
          if (sparse) s += static_cast<float>(kout[g * nb + t]) * INV_FIX;
          sc[g * nb + t] = t0 + t < n_valid ? s * scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // -- online softmax per query row; clear the K outlier sums --------------
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < nb; t += 32) mx = fmaxf(mx, sc[g * nb + t]);
      mx = warp_max(mx);
      const float m_old = mrun[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nb; t += 32) {
        const float e = __expf(sc[g * nb + t] - m_new);
        sc[g * nb + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = __expf(m_old - m_new);
        corr[g] = cr;
        lrun[g] = lrun[g] * cr + sum;
        mrun[g] = m_new;
      }
    }
    for (int i = tid; i < G * nb; i += THREADS) kout[i] = 0;
    __syncthreads();

    // -- p.z_V per stat group and p.A_v; V outliers -------------------------
    const int n_pv = p.gv + r;
    for (int pi = warp; pi < G * n_pv; pi += WARPS) {
      const int g = pi / n_pv, item = pi % n_pv;
      float v = 0.f;
      for (int t = lane; t < nb; t += 32)
        v += sc[g * nb + t] * (item < p.gv ? bfv(buf, st.vzr, t * p.gv + item)
                                           : bfv(buf, st.va, t * r + item - p.gv));
      v = warp_sum(v);
      if (lane == 0) {
        if (item < p.gv) pz[g * p.gv + item] = v;
        else pa[g * r + item - p.gv] = v;
      }
    }
    if (sparse) {
      const int32_t* idx = reinterpret_cast<const int32_t*>(buf + st.vsi);
      for (int e = tid; e < nb * p.kv; e += THREADS) {
        const int d = idx[e];
        if (d >= 0 && d < DH) {
          const int t = e / p.kv;
          const float val = bfv(buf, st.vsv, e);
          for (int g = 0; g < G; ++g) add_fix(&vout[g * DH + d], sc[g * nb + t] * val);
        }
      }
    }
    __syncthreads();

    // -- acc = corr * acc + sum_t (p_t s_t) codes_t + per-channel terms ------
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float cr = corr[g];
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[g][j] *= cr;
      }
    }
    const uint32_t* vwords = reinterpret_cast<const uint32_t*>(buf + st.vp);
    for (int t = tg; t < nb; t += TG) {
      const uint32_t word = vwords[t * L + w];
      const float vs = bfv(buf, st.vsc, t * p.gv + grp);
      float cf[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) cf[j] = code_f((word >> (BITS * j)) & MASK);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pv = sc[g * nb + t] * vs;
#pragma unroll
          for (int j = 0; j < PER; ++j) acc[g][j] += pv * cf[j];
        }
      }
    }
    // the per-channel terms, XC channels a thread: p.z_V, (p.A_v).B_v, outliers
#pragma unroll
    for (int xc = 0; xc < XC; ++xc) {
      const int d = tid + xc * THREADS;
      if (d < DH) {
        const int gd = d / (DH / p.gv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            float x = pz[g * p.gv + gd];
            for (int rr = 0; rr < r; ++rr) x += pa[g * r + rr] * bfv(buf, st.vb, d * r + rr);
            if (sparse) x += static_cast<float>(vout[g * DH + d]) * INV_FIX;
            xacc[xc][g] = xacc[xc][g] * corr[g] + x;
          }
        }
      }
    }
  }

  // -- this split's (acc, m, l): token groups summed in order ----------------
  for (int i = 0; i < TG; ++i) {
    if (tg == i) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            float* dst = red + g * DH + w * PER + j;
            *dst = i == 0 ? acc[g][j] : *dst + acc[g][j];
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int xc = 0; xc < XC; ++xc) {
    const int d = tid + xc * THREADS;
    if (d < DH) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) red[g * DH + d] += xacc[xc][g];
    }
  }
  __syncthreads();
  const long out0 = static_cast<long>(bh) * G;
  if (n_active == 1) {
    for (int i = tid; i < G * DH; i += THREADS) out_acc[out0 * DH + i] = red[i];
    if (tid < G) {
      out_m[out0 + tid] = mrun[tid];
      out_l[out0 + tid] = lrun[tid];
    }
    return;
  }
  const int n_splits = gridDim.x;
  const long part0 = (static_cast<long>(bh) * n_splits + split) * G;
  for (int i = tid; i < G * DH; i += THREADS) part_acc[part0 * DH + i] = red[i];
  if (tid < G) {
    part_m[part0 + tid] = mrun[tid];
    part_l[part0 + tid] = lrun[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(&tickets[bh], 1);
  __syncthreads();
  if (*ticket != n_active - 1) return;
  // the merging block: every split's (m, l) in one round of loads, the
  // weights exp(m_s - m) once, then each output sums its splits in order
  __threadfence();
  float* sm_m = reinterpret_cast<float*>(smem + sm.merge);   // [n_active][G], then weights
  float* sm_l = sm_m + n_splits * G;                          // [n_active][G]
  float* m_fin = sm_l + n_splits * G;                         // [G]
  const long row0 = static_cast<long>(bh) * n_splits * G;
  for (int i = tid; i < n_active * G; i += THREADS) {
    sm_m[i] = __ldcg(part_m + row0 + i);
    sm_l[i] = __ldcg(part_l + row0 + i);
  }
  __syncthreads();
  if (tid < G) {
    float m = NEG_INF;
    for (int s = 0; s < n_active; ++s) m = fmaxf(m, sm_m[s * G + tid]);
    float l = 0.f;
    for (int s = 0; s < n_active; ++s) l += sm_l[s * G + tid] * __expf(sm_m[s * G + tid] - m);
    m_fin[tid] = m;
    out_m[out0 + tid] = m;
    out_l[out0 + tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < n_active * G; i += THREADS) sm_m[i] = __expf(sm_m[i] - m_fin[i % G]);
  __syncthreads();
  for (int i = tid; i < G * DH; i += THREADS) {
    const float* w = sm_m + i / DH;
    const float* src = part_acc + row0 * DH + i;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_active; ++s) a += __ldcg(src + static_cast<long>(s) * G * DH) * w[s * G];
    out_acc[out0 * DH + i] = a;
  }
  if (tid == 0) tickets[bh] = 0;           // ready for the next launch
}

// ===========================================================================
// (b) history regime: more than GMAX query rows, tensor cores

constexpr int HT = 64;                     // tokens per chunk the history kernel takes

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// f32 A fragment (pairs in register order) -> bf16 hi + lo fragments
__device__ __forceinline__ void split_hi_lo(const float (&x)[8], uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = as_u32(h);
    lo[i] = as_u32(__floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y));
  }
}

// an n8 accumulator tile used as the A operand of a k16 step (its 8 columns
// as k 0..7, k 8..15 zero), split hi + lo
__device__ __forceinline__ void tile_as_a(const float (&f)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float x[8] = {f[0], f[1], f[2], f[3], 0.f, 0.f, 0.f, 0.f};
  split_hi_lo(x, hi, lo);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16_rn(x); }

// shared-memory tiles of the history kernel, after the two stage buffers
template <int DH>
struct HistTiles {
  static constexpr int KP = DH + 8;        // row stride (bf16) of token-major tiles
  static constexpr int TP = HT + 8;        // row stride of channel-major tiles
  static constexpr int KC = 0;                          // K codes     [HT][KP]
  static constexpr int KSP = KC + HT * KP * 2;          // K outliers  [HT][KP]
  static constexpr int VT = KSP + HT * KP * 2;          // V codes     [DH][TP]
  static constexpr int VSP = VT + DH * TP * 2;          // V outliers  [DH][TP]
  static constexpr int BX = VSP + DH * TP * 2;          // [k_b | k_z]^T [8][KP]
  static constexpr int KA2 = BX + 8 * KP * 2;           // [k_a | 1]   [HT][8]
  static constexpr int BV2 = KA2 + HT * 8 * 2;          // [v_a | v_z]^T [8][TP]
  static constexpr int BV3 = BV2 + 8 * TP * 2;          // [v_b | group one-hot] [DH][8]
  static constexpr int BYTES = BV3 + DH * 8 * 2;
};

// channel halves of the history kernel: 1, or 2 at head_dim 256 (warps w and
// w + 4 share query rows, one 128-channel half each)
template <int DH>
struct HistSplit {
  static constexpr int CH = DH > 128 ? 2 : 1;
  static constexpr int THREADS = CH * 128;
  static constexpr int MIN_BLOCKS = CH == 1 ? 2 : 1;
};

// grid (BH, NB * ceil(R / 64)): one CTA per (row bh, in-flight block, 64
// query rows), the last blocks first (the streaming extents grow with the
// block index).  Block `blk` of row bh sees the first ext[bh * ext_row +
// blk * ext_blk] tokens.  q [BH, NB, R, Dh] f32 -> acc [BH, NB, R, Dh],
// m, l [BH, NB, R].  Each warp owns 16 query rows (and, at head_dim 256,
// one half of the channels).
template <bool PAGED, int DH, int GV>
__global__ void __launch_bounds__(HistSplit<DH>::THREADS, HistSplit<DH>::MIN_BLOCKS)
gear_history_mma(
    Operands p, Stage st, const float* __restrict__ q, const int32_t* __restrict__ ext,
    int ext_row, int ext_blk, float* __restrict__ out_acc, float* __restrict__ out_m,
    float* __restrict__ out_l, int NB, int R, float scale) {
  using T = HistTiles<DH>;
  constexpr int CH = HistSplit<DH>::CH;
  constexpr int NT = HistSplit<DH>::THREADS;
  constexpr int DHH = DH / CH;             // channels of one warp
  constexpr int KP = T::KP, TP = T::TP;
  constexpr int KK = DHH / 16;             // k16 steps over a warp's channels
  constexpr int NTD = DHH / 8;             // n8 tiles over a warp's channels
  constexpr int NT_PER_GROUP = DH / GV / 8;
  constexpr int NT_RUN = NT_PER_GROUP < NTD ? NT_PER_GROUP : NTD;  // tiles sharing a V group
  static_assert((DH / GV) % 8 == 0, "V stat groups must span whole n8 tiles");
  static_assert(NT_PER_GROUP % NTD == 0 || NTD % NT_PER_GROUP == 0,
                "V stat groups must not straddle a channel half");
  static_assert(CH == 1 || 2 * WARPS * 32 * 32 * 4 <= HT * KP * 2,
                "the score exchange must fit in the K code tile");

  const int bh = blockIdx.x;
  const int n_qt = (R + 63) / 64;
  const int y = gridDim.y - 1 - blockIdx.y;
  const int blk = y / n_qt, qt = y % n_qt;
  const int n_valid = ext[bh * ext_row + blk * ext_blk];
  const int n_live = min(max((n_valid + HT - 1) / HT, 0), p.C);

  extern __shared__ __align__(16) uint8_t smem[];
  const int stage_bytes = align16(st.bytes);
  uint8_t* tiles = smem + 2 * stage_bytes;
  bf16* kc = reinterpret_cast<bf16*>(tiles + T::KC);
  bf16* ksp = reinterpret_cast<bf16*>(tiles + T::KSP);
  bf16* vt = reinterpret_cast<bf16*>(tiles + T::VT);
  bf16* vsp = reinterpret_cast<bf16*>(tiles + T::VSP);
  bf16* bx = reinterpret_cast<bf16*>(tiles + T::BX);
  bf16* ka2 = reinterpret_cast<bf16*>(tiles + T::KA2);
  bf16* bv2 = reinterpret_cast<bf16*>(tiles + T::BV2);
  bf16* bv3 = reinterpret_cast<bf16*>(tiles + T::BV3);
  float* xsc = reinterpret_cast<float*>(tiles + T::KC);   // CH == 2: [half][warp][32][lane]

  const int tid = threadIdx.x, warp = (tid / 32) % WARPS, lane = tid % 32;
  const int half = tid / 128;              // this warp's channel half (0 when CH == 1)
  const int ch0 = half * DHH;              // its first channel
  const int g = lane >> 2, t4 = lane & 3;
  const bool sparse = p.k_sp_val != nullptr;
  const int r = p.r;                       // 0 without low-rank factors
  const int per = 32 / p.bits, L = DH / per;
  const uint32_t mask = (1u << p.bits) - 1u;

  // this warp's 16 query rows as f32 A fragments: rows g, g + 8; columns
  // ch0 + 16 kk + 2 t4 + {0, 1} and + {8, 9}
  const int rq = qt * 64 + warp * 16 + g;
  const float* qb = q + (static_cast<long>(bh) * NB + blk) * R * DH + ch0;
  float qf[KK][8];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int c0 = kk * 16 + 2 * t4;
    float2 v00 = make_float2(0.f, 0.f), v10 = v00, v01 = v00, v11 = v00;
    if (rq < R) {
      v00 = *reinterpret_cast<const float2*>(qb + static_cast<long>(rq) * DH + c0);
      v01 = *reinterpret_cast<const float2*>(qb + static_cast<long>(rq) * DH + c0 + 8);
    }
    if (rq + 8 < R) {
      v10 = *reinterpret_cast<const float2*>(qb + static_cast<long>(rq + 8) * DH + c0);
      v11 = *reinterpret_cast<const float2*>(qb + static_cast<long>(rq + 8) * DH + c0 + 8);
    }
    qf[kk][0] = v00.x; qf[kk][1] = v00.y; qf[kk][2] = v10.x; qf[kk][3] = v10.y;
    qf[kk][4] = v01.x; qf[kk][5] = v01.y; qf[kk][6] = v11.x; qf[kk][7] = v11.y;
  }
  float acc[NTD][4];
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  if (n_live > 0) stage_chunk<PAGED>(p, st, smem, bh, 0);
  for (int c = 0; c < n_live; ++c) {
    const uint8_t* buf = smem + ((c & 1) ? stage_bytes : 0);
    cp_async_wait_all();
    __syncthreads();                       // chunk c staged; chunk c - 1's tiles consumed
    if (c + 1 < n_live) stage_chunk<PAGED>(p, st, smem + (((c + 1) & 1) ? stage_bytes : 0), bh,
                                           c + 1);

    // ---- build the chunk's bf16 operand tiles ------------------------------
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(buf + st.kp);
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(buf + st.vp);
    for (int i = tid; i < HT * L; i += NT) {
      const int t = i / L, w = i % L;      // K: token-major, a row's words side by side
      const uint32_t word = kw[t * L + w];
      for (int j = 0; j < per; j += 2)
        *reinterpret_cast<__nv_bfloat162*>(kc + t * KP + w * per + j) = __floats2bfloat162_rn(
            code_f((word >> (p.bits * j)) & mask), code_f((word >> (p.bits * (j + 1))) & mask));
    }
    for (int i = tid; i < HT * L; i += NT) {
      const int t = i % HT, w = i / HT;    // V: channel-major, neighbours on neighbouring tokens
      const uint32_t word = vw[t * L + w];
      for (int j = 0; j < per; ++j)
        vt[(w * per + j) * TP + t] = to_bf(code_f((word >> (p.bits * j)) & mask));
    }
    if (sparse) {
      // one thread per K channel / V token adds its outliers in slot order
      const int32_t* kidx = reinterpret_cast<const int32_t*>(buf + st.ksi);
      for (int d = tid; d < DH; d += NT) {
        for (int t = 0; t < HT; ++t) ksp[t * KP + d] = to_bf(0.f);
        for (int j = 0; j < p.ks; ++j) {
          const int t = kidx[d * p.ks + j];
          if (t >= 0 && t < HT)
            ksp[t * KP + d] =
                to_bf(__bfloat162float(ksp[t * KP + d]) + bfv(buf, st.ksv, d * p.ks + j));
        }
      }
      const int32_t* vidx = reinterpret_cast<const int32_t*>(buf + st.vsi);
      for (int t = tid; t < HT; t += NT) {
        for (int d = 0; d < DH; ++d) vsp[d * TP + t] = to_bf(0.f);
        for (int j = 0; j < p.kv; ++j) {
          const int d = vidx[t * p.kv + j];
          if (d >= 0 && d < DH)
            vsp[d * TP + t] =
                to_bf(__bfloat162float(vsp[d * TP + t]) + bfv(buf, st.vsv, t * p.kv + j));
        }
      }
    }
    for (int i = tid; i < 8 * DH; i += NT) {
      const int n = i / DH, d = i % DH;    // [k_b | k_z]^T
      bx[n * KP + d] = n < r ? to_bf(bfv(buf, st.kb, d * r + n))
                             : (n == r ? to_bf(bfv(buf, st.kzr, d)) : to_bf(0.f));
      const int k = i % 8, dd = i / 8;     // [v_b | one-hot of the V stat group]
      const int gk = k - r;
      bv3[dd * 8 + k] = k < r ? to_bf(bfv(buf, st.vb, dd * r + k))
                              : to_bf(gk == dd / (DH / GV) ? 1.f : 0.f);
    }
    for (int i = tid; i < 8 * HT; i += NT) {
      const int t = i / 8, k = i % 8;      // [k_a | 1]
      ka2[t * 8 + k] = k < r ? to_bf(bfv(buf, st.ka, t * r + k)) : to_bf(k == r ? 1.f : 0.f);
      const int n = i / HT, tt = i % HT;   // [v_a | v_z]^T
      bv2[n * TP + tt] = n < r ? to_bf(bfv(buf, st.va, tt * r + n))
                               : (n < r + GV ? to_bf(bfv(buf, st.vzr, tt * GV + n - r))
                                             : to_bf(0.f));
    }
    __syncthreads();

    // ---- scores: (q s_K) . codes + q . sp + (q [k_b | k_z]) . [k_a | 1] ----
    // (over this warp's channels: at head_dim 256 a partial sum)
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    float ex[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* ksc = reinterpret_cast<const bf16*>(buf + st.ksc);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c0 = ch0 + kk * 16 + 2 * t4;
      const float2 s01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ksc + c0));
      const float2 s89 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ksc + c0 + 8));
      const float xs[8] = {qf[kk][0] * s01.x, qf[kk][1] * s01.y, qf[kk][2] * s01.x,
                           qf[kk][3] * s01.y, qf[kk][4] * s89.x, qf[kk][5] * s89.y,
                           qf[kk][6] * s89.x, qf[kk][7] * s89.y};
      uint32_t shi[4], slo[4], uhi[4], ulo[4];
      split_hi_lo(xs, shi, slo);
      split_hi_lo(qf[kk], uhi, ulo);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* b = kc + (nt * 8 + g) * KP + c0;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
        mma_bf16(sc[nt], shi, b0, b1);
        mma_bf16(sc[nt], slo, b0, b1);
        if (sparse) {
          const bf16* bs = ksp + (nt * 8 + g) * KP + c0;
          const uint32_t s0 = ld32(bs), s1 = ld32(bs + 8);
          mma_bf16(sc[nt], uhi, s0, s1);
          mma_bf16(sc[nt], ulo, s0, s1);
        }
      }
      const bf16* b = bx + g * KP + c0;
      mma_bf16(ex, uhi, ld32(b), ld32(b + 8));
      mma_bf16(ex, ulo, ld32(b), ld32(b + 8));
    }
    {
      uint32_t ehi[4], elo[4];
      tile_as_a(ex, ehi, elo);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t b0 = ld32(ka2 + (nt * 8 + g) * 8 + 2 * t4);
        mma_bf16(sc[nt], ehi, b0, 0u);
        mma_bf16(sc[nt], elo, b0, 0u);
      }
    }
    if constexpr (CH == 2) {
      // the two halves' partial scores meet in the K code tile (free once
      // every warp has passed the barrier); both warps of a row group add
      // them lower + upper, so they hold the same bits
      __syncthreads();
      float* mine = xsc + ((half * WARPS + warp) * 32) * 32 + lane;
      const float* other = xsc + (((1 - half) * WARPS + warp) * 32) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(nt * 4 + e) * 32] = sc[nt][e];
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float o = other[(nt * 4 + e) * 32];
          sc[nt][e] = half == 0 ? sc[nt][e] + o : o + sc[nt][e];
        }
    }

    // ---- scale, mask past the extent, online softmax -----------------------
    const int t0 = c * HT;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + 2 * t4 + (e & 1);
        const float x = t0 + t < n_valid ? sc[nt][e] * scale : NEG_INF;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = __expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(sc[nt][e] - m_run[e >> 1]);
        sc[nt][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      acc[nt][0] *= corr[0]; acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1]; acc[nt][3] *= corr[1];
    }

    // ---- acc += (p s_V) . codes + p . sp + (p [v_a | v_z]) . [v_b | 1] -----
    // (this warp's O columns ch0 .. ch0 + DHH: its tile n is channel tile ch0 / 8 + n)
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* vsc = reinterpret_cast<const bf16*>(buf + st.vsc);
#pragma unroll
    for (int kk = 0; kk < HT / 16; ++kk) {
      const int tk = kk * 16 + 2 * t4;     // tokens tk, tk + 1, tk + 8, tk + 9
      const float pv[8] = {sc[2 * kk][0], sc[2 * kk][1], sc[2 * kk][2], sc[2 * kk][3],
                           sc[2 * kk + 1][0], sc[2 * kk + 1][1], sc[2 * kk + 1][2],
                           sc[2 * kk + 1][3]};
      uint32_t phi[4], plo[4];
      split_hi_lo(pv, phi, plo);
      uint32_t shi[4], slo[4];
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        if (n % NT_RUN == 0) {             // first tile of a V stat group within the half
          const int gi = (ch0 / 8 + n) / NT_PER_GROUP;
          const float v0 = __bfloat162float(vsc[tk * GV + gi]);
          const float v1 = __bfloat162float(vsc[(tk + 1) * GV + gi]);
          const float v8 = __bfloat162float(vsc[(tk + 8) * GV + gi]);
          const float v9 = __bfloat162float(vsc[(tk + 9) * GV + gi]);
          const float xv[8] = {pv[0] * v0, pv[1] * v1, pv[2] * v0, pv[3] * v1,
                               pv[4] * v8, pv[5] * v9, pv[6] * v8, pv[7] * v9};
          split_hi_lo(xv, shi, slo);
        }
        const bf16* b = vt + (ch0 + n * 8 + g) * TP + tk;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
        mma_bf16(acc[n], shi, b0, b1);
        mma_bf16(acc[n], slo, b0, b1);
      }
      if (sparse) {
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          const bf16* b = vsp + (ch0 + n * 8 + g) * TP + tk;
          const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
          mma_bf16(acc[n], phi, b0, b1);
          mma_bf16(acc[n], plo, b0, b1);
        }
      }
      const bf16* b = bv2 + g * TP + tk;
      mma_bf16(f, phi, ld32(b), ld32(b + 8));
      mma_bf16(f, plo, ld32(b), ld32(b + 8));
    }
    {
      uint32_t fhi[4], flo[4];
      tile_as_a(f, fhi, flo);
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        const uint32_t b0 = ld32(bv3 + (ch0 + n * 8 + g) * 8 + 2 * t4);
        mma_bf16(acc[n], fhi, b0, 0u);
        mma_bf16(acc[n], flo, b0, 0u);
      }
    }
  }

  // ---- unnormalized triple of rows rq, rq + 8 -------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  const long o0 = (static_cast<long>(bh) * NB + blk) * R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rq + 8 * h;
    if (row >= R) continue;
    float* dst = out_acc + (o0 + row) * DH + ch0;
#pragma unroll
    for (int n = 0; n < NTD; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t4) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    if (t4 == 0 && half == 0) {
      out_m[o0 + row] = m_run[h];
      out_l[o0 + row] = l_run[h];
    }
  }
}

// ===========================================================================
// launchers

Operands make_operands(const void* k_packed, const void* k_scale, const void* k_zero,
                       const void* v_packed, const void* v_scale, const void* v_zero,
                       const void* k_a, const void* k_b, const void* v_a, const void* v_b,
                       const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val,
                       const void* v_sp_idx, const void* bt, int H, int C, int nb, int Dh,
                       int bits, int gv, int r, int ks, int kv) {
  Operands p;
  p.k_packed = static_cast<const int32_t*>(k_packed);
  p.k_scale = static_cast<const bf16*>(k_scale);
  p.k_zero = static_cast<const bf16*>(k_zero);
  p.v_packed = static_cast<const int32_t*>(v_packed);
  p.v_scale = static_cast<const bf16*>(v_scale);
  p.v_zero = static_cast<const bf16*>(v_zero);
  p.k_a = static_cast<const bf16*>(k_a);
  p.k_b = static_cast<const bf16*>(k_b);
  p.v_a = static_cast<const bf16*>(v_a);
  p.v_b = static_cast<const bf16*>(v_b);
  p.k_sp_val = static_cast<const bf16*>(k_sp_val);
  p.k_sp_idx = static_cast<const int32_t*>(k_sp_idx);
  p.v_sp_val = static_cast<const bf16*>(v_sp_val);
  p.v_sp_idx = static_cast<const int32_t*>(v_sp_idx);
  p.bt = static_cast<const int32_t*>(bt);
  p.H = H; p.C = C; p.nb = nb; p.Dh = Dh; p.bits = bits; p.gv = gv;
  p.r = k_a != nullptr ? r : 0;
  p.ks = k_sp_val != nullptr ? ks : 0;
  p.kv = k_sp_val != nullptr ? kv : 0;
  return p;
}

template <bool PAGED, int BITS, int DH, int GM>
int launch_decode(const Operands& p, const float* q, const int32_t* n_comp, float* part_acc,
                  float* part_m, float* part_l, int* tickets, float* acc, float* m, float* l,
                  int BH, int G, int cps, float scale, cudaStream_t st) {
  const Stage stage = make_stage(p);
  const int n_splits = (p.C + cps - 1) / cps;
  const DecodeSmem sm = decode_smem(stage, G, DH, p.nb, p.r, p.gv, n_splits);
  auto kern = gear_decode_split<PAGED, BITS, DH, GM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, BH);
  kern<<<grid, THREADS, sm.bytes, st>>>(p, stage, sm, q, n_comp, part_acc, part_m, part_l,
                                        tickets, acc, m, l, G, cps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch_decode(const Operands& p, const float* q, const int32_t* n_comp, float* part_acc,
                    float* part_m, float* part_l, int* tickets, float* acc, float* m, float* l,
                    int BH, int G, int cps, float scale, cudaStream_t st) {
#define GEAR_DECODE_GM(B, D, GM) \
  launch_decode<PAGED, B, D, GM>(p, q, n_comp, part_acc, part_m, part_l, tickets, acc, m, l, \
                                 BH, G, cps, scale, st)
#define GEAR_DECODE_CASE(B, D)                                                                \
  if (p.bits == B && p.Dh == D)                                                               \
    return G == 1 ? GEAR_DECODE_GM(B, D, 1)                                                   \
                  : (G <= GMID ? GEAR_DECODE_GM(B, D, GMID) : GEAR_DECODE_GM(B, D, GMAX));
  GEAR_DECODE_CASE(2, 64) GEAR_DECODE_CASE(4, 64) GEAR_DECODE_CASE(8, 64)
  GEAR_DECODE_CASE(2, 128) GEAR_DECODE_CASE(4, 128) GEAR_DECODE_CASE(8, 128)
  GEAR_DECODE_CASE(2, 256) GEAR_DECODE_CASE(4, 256) GEAR_DECODE_CASE(8, 256)
#undef GEAR_DECODE_CASE
#undef GEAR_DECODE_GM
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PAGED, int DH, int GV>
int launch_history(const Operands& p, const float* q, const int32_t* ext, int ext_row,
                   int ext_blk, float* acc, float* m, float* l, int BH, int NB, int R,
                   float scale, cudaStream_t st) {
  const Stage stage = make_stage(p);
  const int smem = 2 * align16(stage.bytes) + HistTiles<DH>::BYTES;
  auto kern = gear_history_mma<PAGED, DH, GV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, NB * ((R + 63) / 64));
  kern<<<grid, HistSplit<DH>::THREADS, smem, st>>>(p, stage, q, ext, ext_row, ext_blk, acc, m, l,
                                                   NB, R, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch_history(const Operands& p, const float* q, const int32_t* ext, int ext_row,
                     int ext_blk, float* acc, float* m, float* l, int BH, int NB, int R,
                     float scale, cudaStream_t st) {
  if (p.nb != HT || p.r + 1 > 8 || p.r + p.gv > 8) return static_cast<int>(cudaErrorInvalidValue);
#define GEAR_HISTORY_CASE(D, V)                                                             \
  if (p.Dh == D && p.gv == V)                                                               \
    return launch_history<PAGED, D, V>(p, q, ext, ext_row, ext_blk, acc, m, l, BH, NB, R,   \
                                       scale, st);
  GEAR_HISTORY_CASE(64, 1) GEAR_HISTORY_CASE(128, 1) GEAR_HISTORY_CASE(128, 2)
  GEAR_HISTORY_CASE(256, 1) GEAR_HISTORY_CASE(256, 4)
#undef GEAR_HISTORY_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The body of both layouts' C entry points (PAGED: pool operands [P*H, one
// chunk's rows, ...] named by block tables bt [B, C]; else dense [BH, S,
// ...] operands).  G <= GMAX takes the decode regime (part_* hold [BH,
// ceil(C / cps), G, ...] split partials; tickets [BH] are zeroed ints that
// the kernel leaves zeroed); more query rows take the history regime with
// one extent per row.
template <bool PAGED>
int decode_entry(const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
                 const void* v_packed, const void* v_scale, const void* v_zero, const void* k_a,
                 const void* k_b, const void* v_a, const void* v_b, const void* k_sp_val,
                 const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
                 const void* n_comp, const void* bt, void* part_acc, void* part_m, void* part_l,
                 void* tickets, void* acc, void* m, void* l, int BH, int H, int G, int C, int nb,
                 int Dh, int bits, int gv, int r, int ks, int kv, int cps, float scale,
                 void* stream) {
  const Operands p = make_operands(k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a,
                                   k_b, v_a, v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx,
                                   PAGED ? bt : nullptr, H, C, nb, Dh, bits, gv, r, ks, kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const int32_t* nc = static_cast<const int32_t*>(n_comp);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (G > GMAX) return dispatch_history<PAGED>(p, qq, nc, 1, 0, a, mm, ll, BH, 1, G, scale, st);
  return dispatch_decode<PAGED>(p, qq, nc, static_cast<float*>(part_acc),
                                static_cast<float*>(part_m), static_cast<float*>(part_l),
                                static_cast<int*>(tickets), a, mm, ll, BH, G, cps, scale, st);
}

}  // namespace
