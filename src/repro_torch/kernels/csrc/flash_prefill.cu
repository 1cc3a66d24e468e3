// Causal flash attention for prefill, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill (Pallas
// `_kernel`), FlashAttention-2 over one (batch, head) row with the mask
// family: causal, optional sliding window, bidirectional prefix, tanh softcap,
// and GQA through kv_repeat (query row x reads K/V row x / kv_repeat; no
// broadcast copy of K/V).
//
// What bounds it on the H100: operations.  At the main path's shapes (32
// heads, head_dim 128, a few hundred to ~1000 tokens) the causal product is
// ~4 S^2/2 Dh flops per head against 4 S Dh bytes of Q/K/V/O, i.e. S/2 flops
// per byte: above the card's ~295 flop/byte ridge from S ~ 600 on.
//
// What the design does about it: both products run on the tensor cores as
// bf16 mma.sync (m16n8k16) with f32 accumulation -- the inputs are already
// bf16, so the Q.K^T products are exact; the online softmax stays in f32
// registers and no score matrix ever reaches device memory.  One block of 4
// warps per (64-query tile, row); each warp owns 16 query rows and loops
// over 64-key tiles staged in shared memory (V stored transposed so its
// B-operand pairs are contiguous), only up to the causal / prefix limit and
// from the window's lower edge.  The ragged tail (S not a multiple of 64) is
// masked inside the kernel.  P is rounded to bf16 before P.V (the row sums l
// use the f32 P); this is the one place the kernel rounds where the f32
// reference does not.  No TMA / wgmma / pipelining yet: simple and right first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;     // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// two consecutive bf16 of row `r` (zero past the end of the sequence)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* base, int r, int col,
                                            int S, int Dh) {
  if (r >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (long)r * Dh + col);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int S, int kv_repeat, float scale, int window, int prefix_len, float softcap) {
  constexpr int KPAD = DH + 8;   // K tile row stride (bf16): conflict-free B reads
  constexpr int VPAD = BK + 8;   // transposed V tile row stride
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KPAD];
  __shared__ __align__(16) __nv_bfloat16 Vt[DH * VPAD];

  const int qtile = blockIdx.x;
  const long row = blockIdx.y;
  const long kvrow = row / kv_repeat;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qtile * BQ;
  const int q0 = qs + warp * 16;
  const __nv_bfloat16* qb = q + row * S * DH;
  const __nv_bfloat16* kb = k + kvrow * S * DH;
  const __nv_bfloat16* vb = v + kvrow * S * DH;

  // this warp's Q rows as A fragments (row g / g+8, cols t4*2 / t4*2+8)
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c0 = kk * 16 + t4 * 2;
    qf[kk][0] = ld_pair(qb, q0 + g, c0, S, DH);
    qf[kk][1] = ld_pair(qb, q0 + g + 8, c0, S, DH);
    qf[kk][2] = ld_pair(qb, q0 + g, c0 + 8, S, DH);
    qf[kk][3] = ld_pair(qb, q0 + g + 8, c0 + 8, S, DH);
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};   // rows g, g+8
  float l_run[2] = {0.f, 0.f};           // this thread's share of the row sums

  // key range that can be unmasked for any query of the tile
  const int qe = min(qs + BQ, S);
  const bool in_prefix = prefix_len > 0 && qs < prefix_len;
  int kv_hi = qe;
  if (in_prefix) kv_hi = max(kv_hi, min(prefix_len, S));
  int kv_lo = 0;
  if (window > 0 && !in_prefix) kv_lo = max(0, qs - window + 1);

  for (int kt = kv_lo / BK; kt * BK < kv_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile is consumed
    // K tile row-major; consecutive threads take consecutive 16-byte pieces
    for (int i = threadIdx.x; i < BK * DH / 8; i += THREADS) {
      const int r = i / (DH / 8), cv = (i % (DH / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * DH + cv);
      *reinterpret_cast<uint4*>(Ks + r * KPAD + cv) = val;
    }
    // V tile transposed; consecutive threads take consecutive keys
    for (int i = threadIdx.x; i < BK * DH / 8; i += THREADS) {
      const int r = i % BK, cv = (i / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * DH + cv);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(cv + j) * VPAD + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * KPAD + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // scale, softcap, mask; tile row max
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + g + (e >= 2 ? 8 : 0);
        const int ki = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = qi >= ki;
        if (window > 0) ok = ok && (qi - ki < window);
        if (prefix_len > 0) ok = ok || (qi < prefix_len && ki < prefix_len);
        ok = ok && ki < S;
        s[nt][e] = ok ? x : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      acc[nt][0] *= corr[0]; acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1]; acc[nt][3] *= corr[1];
    }

    // O += P V, P as bf16 A fragments straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const __nv_bfloat16* vp = Vt + (nt * 8 + g) * VPAD + kk * 16 + t4 * 2;
        mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  // full row sums across the quad, normalize, store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    l_run[h] = 1.f / fmaxf(l_run[h], 1e-30f);
  }
  __nv_bfloat16* ob = o + row * S * DH;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (q0 + g < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)(q0 + g) * DH + col) =
          __floats2bfloat162_rn(acc[nt][0] * l_run[0], acc[nt][1] * l_run[0]);
    if (q0 + g + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)(q0 + g + 8) * DH + col) =
          __floats2bfloat162_rn(acc[nt][2] * l_run[1], acc[nt][3] * l_run[1]);
  }
}

}  // namespace

extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    int bhq, int S, int Dh, int kv_repeat, float scale,
                                    int window, int prefix_len, float softcap, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, bhq);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* qq = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kk = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vv = (const __nv_bfloat16*)v;
  __nv_bfloat16* oo = (__nv_bfloat16*)o;
  if (Dh == 128) {
    flash_prefill_kernel<128><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, S, kv_repeat, scale,
                                                        window, prefix_len, softcap);
  } else if (Dh == 64) {
    flash_prefill_kernel<64><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, S, kv_repeat, scale,
                                                       window, prefix_len, softcap);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
