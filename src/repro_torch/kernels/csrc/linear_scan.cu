// Chunked linear-recurrence scan (Mamba-2 SSD heads, RWKV6 time mix) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/linear_scan_kernel.py::linear_scan_chunked
// (Pallas `_kernel`, grid (BH, chunks) with the state carried in VMEM).
// Per row x (a batch x head pair) and state S in R^{Dk x Dv}:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T S_t                            (inclusive, Mamba)
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)  (bonus, RWKV6)
//
// computed as the reference does, in chunks of W tokens with the factored
// intra-chunk form and the clamps of models/linear_scan.py: with cum the
// chunk-relative inclusive cumsum of log w,
//   q_fac = r * exp(max(q_cum, -30))   (q_cum = cum, or cum - log w for bonus)
//   k_fac = k * exp(min(-cum, 30))
//   y     = tril(q_fac k_fac^T) v  +  q_fac S_chunk_start  (+ (r.u.k) v, bonus)
//   S    <- S * exp(max(cum_last, -30)) + (k * exp(max(cum_last - cum, -30)))^T v
// The clamps make a chunk whose cumulative decay passes e^-30 compute
// something other than the recurrence; the port follows the reference there
// (expf, not __expf, and never the "exact" exp(cum_t - cum_tau)).  The state
// starts at zero or at state0 [BH, Dk, Dv] (the reference's chunked_scan
// takes one; its TPU kernel does not).
//
// Two regimes, chosen by the chunk length:
//
// (a) Step, W = 1 (RWKV6's decode step: S = 1 from the slot's state).  With
//     W = 1 the clamped form closes: y = q_fac S + c v, S' = S e^{max(lw, -30)}
//     + k v^T, with q_fac = r and c = r.u.k (bonus) or q_fac = r e^{max(lw,
//     -30)} and c = q_fac.k_fac (inclusive).  Bound by bytes: the state is
//     read and written once (5.2 MB at rwkv's 160 rows).  `scan_step` streams
//     it: one block per (row, 64 state columns), each thread four state rows
//     of one 16-byte column group in registers, the reduction over Dk in a
//     warp shuffle and one fixed-order pass over the 8 warps; no tile, no
//     padding, one launch.  A longer sequence in chunks of 1 loops the step.
// (b) Chunked, W > 1 (every prefill: chunk = S for an unaligned prompt, 64
//     for an aligned one).  Bound by operations: the causal W^2 / 2 intra
//     product.  Three launches:
//     1. `scan_factors`, one block per (row, chunk, 128-row tile, 16 Dk
//        columns): the chunk-relative cumsum of log w as a segmented
//        parallel scan (16 segments of 8 rows; the carry into the tile and
//        cum_last summed per segment over the chunk's tiles, then over the
//        segments); q_fac and k_fac into a workspace [BH, S, Dk8] (Dk8 = Dk
//        rounded up to 8, zero-padded), e^{max(cum_last, -30)} per (row,
//        chunk), and the tile's state increment (k e^{max(cum_last - cum,
//        -30)})^T v on the tensor cores (3xTF32, as below).
//     2. `scan_states`, one thread per (row, state entry): S_{c+1} = S_c
//        e^{max(cum_last, -30)} + the chunk's tile increments, added in tile
//        order (no float atomics: two calls give the same bits), the next
//        chunk's increments loaded during the update; S_c of every chunk
//        after the first goes to the workspace.
//     3. Given the cumsum and the chunk-start states, the query tiles are
//        independent: `scan_tiles` runs one 128-thread block per (row,
//        chunk, 64-row query tile, 64 v columns), heaviest tiles first.  All
//        Dv columns share a block, so each attention tile is computed once.
//        It streams the key tiles at or before its query tile through a
//        double-buffered cp.async stage (the next tile's copy in flight
//        during the current tile's products) and runs the cross term q_fac
//        S_c, q_fac k_fac^T (causal mask on the diagonal tile, strict for
//        bonus) and att v on the tensor cores: mma.sync m16n8k8 in TF32,
//        each f32 operand split into a TF32 hi + lo pair and multiplied
//        three times (lo.hi + hi.lo + hi.hi), which keeps ~2^-19 relative
//        error per product at f32's exponent range (the factors span e^-30
//        .. e^30); the split is a mask and a subtraction, no conversion
//        instruction.  The attention tile stays in registers: its
//        accumulator fragment is the next product's A fragment with the key
//        order permuted to match.  y is written once.
//
// (c) Backward (training; the reference differentiates its XLA chunked_scan,
//     and its Pallas kernel has none): the vector-Jacobian product of the
//     clamped chunked form, ref.py's linear_scan_bwd_ref.  Given g = dy and
//     the final state's gradient, with G_{c+1} the gradient of the state
//     after chunk c: G_c = diag(e^{max(cum_last, -30)}) G_{c+1} + q_fac^T g_c;
//     dq_fac = (tri * g v^T) k_fac + g S_c^T, dk_fac = (tri * g v^T)^T q_fac,
//     dv = A^T g + k_state G_{c+1} (+ beta g), dk_state = v G_{c+1}^T; the
//     exponentials' masked terms give d cum, whose reverse cumsum within the
//     chunk is d log w.  Bound by operations (the W^2 / 2 pair products and
//     the token-by-state products).  Seven launches, f32 FMAs, no atomics:
//     scan_factors (also writing cum for the masks) and scan_states recompute
//     the forward's factors and chunk-start states rather than keep them
//     (under the `dots` remat policy the layer's forward runs again anyway);
//     bwd_qg: q_fac^T g per 128-row tile, in parallel; bwd_states: one thread
//     per (row, state entry), chunks in reverse, the tiles' sums in order;
//     bwd_dqk and bwd_dv: a 256-thread block per (row, chunk, 64-token tile),
//     products of 64 x 64 shared tiles in 4 x 4 register micro-tiles, f32
//     FMAs (the factors span e^-30 .. e^30: no TF32); bwd_decay: d log w per
//     (row, chunk, log w column) in reverse order, and du per row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float CLAMP = 30.f;
constexpr int TILE = 64;            // rows of a query or key tile
constexpr int TILE_THREADS = 128;   // 4 warps x 16 query rows
constexpr int DVT = 64;             // v columns of a tile block
constexpr int DVP = DVT + 4;        // padded v row in shared memory
constexpr int MAX_KP = 64 + 4;      // padded factor row at Dk = 64
constexpr int FAC_ROWS = 128;       // rows of a factor-pass tile: 16 segments of 8
constexpr int FAC_THREADS = 256;    // 16 Dk columns x 16 segments
constexpr int INC_COLS = 32;        // v columns of a state-increment slice
constexpr int KSTP = 24;            // padded k_state row (conflict-free A fragments)
constexpr int VTP = INC_COLS + 8;   // padded v row (conflict-free B fragments)
constexpr int STATE_THREADS = 256;
constexpr int STEP_THREADS = 256;   // 16 column groups x 16 row groups

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// PTX helpers (cp_async16, split and mma_tf32 are in mma_tf32.cuh)

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 4 : 0)
               : "memory");
}

// acc[n] += a B_n, n < count, both split into hi + lo (lo.hi + hi.lo + hi.hi,
// the small terms first, lo.lo dropped).  B_n (k8 x n8) is read from shared
// memory at s[k * ldk + (8 n + g) * ldn] for k = k0 + tg, k0 + tg + 4 (with
// `pairs`, k0 + 2 tg, k0 + 2 tg + 1: the permuted key order of an attention
// tile reused as an A fragment).  Each pass runs over all n in turn, so the
// accumulators' products interleave.
__device__ __forceinline__ void mma_row(float (*acc)[4], const uint32_t* ah, const uint32_t* al,
                                        const float* s, int ldk, int ldn, int k0, int g, int tg,
                                        bool pairs, int count) {
  uint32_t bh[8][2], bl[8][2];
  const int r0 = pairs ? k0 + 2 * tg : k0 + tg, r1 = pairs ? r0 + 1 : r0 + 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < count) {
      split(s[r0 * ldk + (8 * n + g) * ldn], bh[n][0], bl[n][0]);
      split(s[r1 * ldk + (8 * n + g) * ldn], bh[n][1], bl[n][1]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
    if (n < count) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < 8; ++n)
    if (n < count) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < 8; ++n)
    if (n < count) mma_tf32(acc[n], ah, bh[n]);
}

// Copy rows [0, rows) x columns [0, ncols) of a row-major global array (row
// stride ld floats) into a 64-row shared tile of row stride sld, zero-filling
// rows >= rows and columns [ncols, width).  16-byte copies when `vec` (ld,
// ncols and width multiples of 4, src 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void load_tile(float* dst, int sld, const float* src, long ld,
                                          int rows, int ncols, int width, bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int i = threadIdx.x; i < TILE * q; i += blockDim.x) {
      const int t = i / q, j = (i % q) * 4;
      const bool ok = t < rows && j < ncols;
      cp_async16(dst + t * sld + j, ok ? src + t * ld + j : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * width; i += blockDim.x) {
      const int t = i / width, j = i % width;
      const bool ok = t < rows && j < ncols;
      cp_async4(dst + t * sld + j, ok ? src + t * ld + j : src, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// (a) the step regime

// grid (BH, Dv / (16 VEC)); thread (column group cg, row group rg) holds
// state rows rg, rg + 16, rg + 32, rg + 48 at columns [j, j + VEC)
template <int VEC>
__global__ void __launch_bounds__(STEP_THREADS) scan_step(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u, const float* __restrict__ state0,
    float* __restrict__ y, float* __restrict__ state_out, int S, int Dk, int Dv, int LC,
    int bonus) {
  __shared__ float qs[64], ks[64], ds[64], coef2[2];
  __shared__ float red[STEP_THREADS / 32][16 * VEC];
  const int x = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int cg = tid % 16, rg = tid / 16;
  const int j = blockIdx.y * 16 * VEC + cg * VEC;
  const bool col_ok = j < Dv;

  float st[4][VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = rg + 16 * i;
#pragma unroll
    for (int e = 0; e < VEC; ++e) st[i][e] = 0.f;
    if (state0 != nullptr && d < Dk && col_ok) {
      const float* p = state0 + ((long)x * Dk + d) * Dv + j;
      if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        st[i][0] = q.x; st[i][1] = q.y; st[i][2] = q.z; st[i][3] = q.w;
      } else {
        st[i][0] = p[0];
      }
    }
  }

  for (int t = 0; t < S; ++t) {
    const long row = (long)x * S + t;
    if (tid < 64) {
      const int d = tid;
      float q = 0.f, kk = 0.f, dec = 0.f, term = 0.f;
      if (d < Dk) {
        const float w = lw[row * LC + (LC == 1 ? 0 : d)];
        const float rr = r[row * Dk + d];
        kk = k[row * Dk + d];
        dec = expf(fmaxf(w, -CLAMP));
        if (bonus) {          // q_cum = cum - log w = 0: q_fac = r
          q = rr;
          term = rr * u[(long)x * Dk + d] * kk;
        } else {
          q = rr * dec;
          term = q * (kk * expf(fminf(-w, CLAMP)));
        }
      }
      qs[d] = q;
      ks[d] = kk;
      ds[d] = dec;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) term += __shfl_xor_sync(0xffffffffu, term, o);
      if (lane == 0) coef2[tid / 32] = term;
    }
    float vv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) vv[e] = 0.f;
    if (col_ok) {
      const float* p = v + row * Dv + j;
      if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        vv[0] = q.x; vv[1] = q.y; vv[2] = q.z; vv[3] = q.w;
      } else {
        vv[0] = p[0];
      }
    }
    __syncthreads();
    const float coef = coef2[0] + coef2[1];
    float p[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = rg + 16 * i;
      if (d < Dk) {
        const float q = qs[d], kk = ks[d], dec = ds[d];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          p[e] += q * st[i][e];
          st[i][e] = st[i][e] * dec + kk * vv[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] += __shfl_xor_sync(0xffffffffu, p[e], 16);
    if (lane < 16) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[tid / 32][cg * VEC + e] = p[e];
    }
    __syncthreads();
    if (tid < 16 && col_ok) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < STEP_THREADS / 32; ++w) s += red[w][cg * VEC + e];
        y[row * Dv + j + e] = s + coef * vv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = rg + 16 * i;
    if (d < Dk && col_ok) {
      float* p = state_out + ((long)x * Dk + d) * Dv + j;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
      } else {
        p[0] = st[i][0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the chunked regime

// 1. grid (BH * C * n128, Dk8 / 16), one block per 128-row tile of a chunk
// and 16 Dk columns; thread (col, seg) owns Dk column d and the tile's rows
// seg * 8 .. + 7; for the state increment, warp w < 4 owns 8 v columns of
// each 32-column slice
__global__ void __launch_bounds__(FAC_THREADS) scan_factors(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ lw, float* __restrict__ qf, float* __restrict__ kf,
    float* __restrict__ decay, float* __restrict__ part, float* __restrict__ cum_out, int S,
    int Dk, int Dv, int LC, int W, int bonus, int vec) {
  __shared__ float before_s[16][17], all_s[16][17], tot[16][17];
  __shared__ float kst[FAC_ROWS][KSTP];
  __shared__ __align__(16) float vt[FAC_ROWS][VTP];
  const int C = S / W, Dkp = pad8(Dk), n128 = cdiv(W, FAC_ROWS);
  const int xc = blockIdx.x / n128, tile = blockIdx.x % n128;
  const int x = xc / C, c = xc % C;
  const int col = threadIdx.x % 16, seg = threadIdx.x / 16;
  const int d = blockIdx.y * 16 + col;
  const bool real = d < Dk;
  const long row0 = (long)x * S + (long)c * W;          // the chunk's first token
  const float* lwc = lw + row0 * LC + (LC == 1 ? 0 : min(d, Dk - 1));

  // the carry into this tile and cum_last: per segment over the tiles, then
  // over the 16 segments (the same order in every block of the chunk)
  float before = 0.f, all = 0.f;
  for (int j = 0; j < n128; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = j * FAC_ROWS + seg * 8 + i;
      if (t < W) s += lwc[(long)t * LC];
    }
    if (j < tile) before += s;
    all += s;
  }
  before_s[seg][col] = before;
  all_s[seg][col] = all;

  const int t0 = tile * FAC_ROWS;
  float w[8], rr[8], kk[8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + seg * 8 + i;
    const bool ok = t < W;
    w[i] = ok ? lwc[(long)t * LC] : 0.f;
    rr[i] = ok && real ? r[(row0 + t) * Dk + d] : 0.f;
    kk[i] = ok && real ? k[(row0 + t) * Dk + d] : 0.f;
    s += w[i];
  }
  tot[seg][col] = s;
  __syncthreads();
  float cum = 0.f, last = 0.f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    cum += before_s[p][col];
    last += all_s[p][col];
  }
  if (tile == 0 && seg == 0 && d < Dkp)
    decay[((long)x * C + c) * Dkp + d] = real ? expf(fmaxf(last, -CLAMP)) : 0.f;
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if (p < seg) cum += tot[p][col];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + seg * 8 + i;
    cum += w[i];
    if (t < W && d < Dkp) {
      const long o = (row0 + t) * Dkp + d;
      const float qc = bonus ? cum - w[i] : cum;
      qf[o] = real ? rr[i] * expf(fmaxf(qc, -CLAMP)) : 0.f;
      kf[o] = real ? kk[i] * expf(fminf(-cum, CLAMP)) : 0.f;
      if (cum_out != nullptr) cum_out[o] = real ? cum : 0.f;    // the backward's masks
    }
    kst[seg * 8 + i][col] = t < W && real ? kk[i] * expf(fmaxf(last - cum, -CLAMP)) : 0.f;
  }

  // the tile's state increment k_state^T v on the tensor cores, over
  // slices of INC_COLS v columns: warp w < INC_COLS / 8 owns columns 8 w ..
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int rows = min(FAC_ROWS, W - t0), nk = cdiv(rows, 8);
  float* pp = part + (((long)x * C + c) * n128 + tile) * Dk * Dv + (long)blockIdx.y * 16 * Dv;
  for (int j0 = 0; j0 < Dv; j0 += INC_COLS) {
    const int ncols = min(INC_COLS, Dv - j0);
    __syncthreads();            // kst written; the previous slice's readers are done
    const float* vg = v + (row0 + t0) * Dv + j0;
    if (vec) {
      for (int i = threadIdx.x; i < FAC_ROWS * INC_COLS / 4; i += FAC_THREADS) {
        const int t = i / (INC_COLS / 4), j = (i % (INC_COLS / 4)) * 4;
        *reinterpret_cast<float4*>(&vt[t][j]) =
            t < rows && j < ncols ? *reinterpret_cast<const float4*>(vg + (long)t * Dv + j)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = threadIdx.x; i < FAC_ROWS * INC_COLS; i += FAC_THREADS) {
        const int t = i / INC_COLS, j = i % INC_COLS;
        vt[t][j] = t < rows && j < ncols ? vg[(long)t * Dv + j] : 0.f;
      }
    }
    __syncthreads();
    if (warp < INC_COLS / 8 && warp * 8 < ncols) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < nk; ++ks) {         // A[d][t] = k_state[t][d]
        uint32_t ah[4], al[4];
        split(kst[ks * 8 + tg][g], ah[0], al[0]);
        split(kst[ks * 8 + tg][g + 8], ah[1], al[1]);
        split(kst[ks * 8 + tg + 4][g], ah[2], al[2]);
        split(kst[ks * 8 + tg + 4][g + 8], ah[3], al[3]);
        mma_row(acc, ah, al, &vt[0][warp * 8], VTP, 1, ks * 8, g, tg, false, 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dl = g + (i >= 2 ? 8 : 0), j = warp * 8 + 2 * tg + (i & 1);
        if (blockIdx.y * 16 + dl < Dk && j < ncols) pp[(long)dl * Dv + j0 + j] = acc[0][i];
      }
    }
  }
}

// shared floats of scan_tiles at a padded factor row of KP floats
__host__ __device__ inline int tiles_smem_floats(int KP) {
  return 2 * TILE * KP + 2 * TILE * DVP + TILE;
}

// 3. grid (BH * C * n_tiles, Dv / 64); warp w owns query rows 16 w .. 16 w + 15
__global__ void __launch_bounds__(TILE_THREADS, 3) scan_tiles(
    const float* __restrict__ qf, const float* __restrict__ kf, const float* __restrict__ r,
    const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ u,
    const float* __restrict__ state0, const float* __restrict__ starts, float* __restrict__ y,
    int BH, int S, int Dk, int Dv, int W, int bonus, int vec) {
  extern __shared__ float smem[];
  const int Dkp = pad8(Dk), KP = Dkp + 4, nks = Dkp / 8;
  float* kfs = smem;                       // [2][TILE][KP] key factors
  float* vs = kfs + 2 * TILE * KP;         // [2][TILE][DVP] v (stage 1 first holds S_c)
  float* rk = vs + 2 * TILE * DVP;         // [TILE] bonus r.u.k of the query rows

  const int C = S / W, nt = cdiv(W, TILE), rows_c = BH * C;
  const int qi = nt - 1 - blockIdx.x / rows_c;          // heaviest query tiles first
  const int xc = blockIdx.x % rows_c, x = xc / C, c = xc % C;
  const int dv0 = blockIdx.y * DVT;
  const int ncols = min(DVT, Dv - dv0), ntv = pad8(ncols) / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int m0 = warp * 16;
  const long tok0 = (long)x * S + (long)c * W;
  const int q0 = qi * TILE, rows_q = min(TILE, W - q0);
  // the chunk-start state: state0 for the first chunk, scan_states' S_c after it
  const float* start = c == 0 ? (state0 == nullptr ? nullptr : state0 + (long)x * Dk * Dv)
                              : starts + ((long)x * C + c) * Dk * Dv;

  if (start != nullptr)
    load_tile(vs + TILE * DVP, DVP, start + dv0, Dv, Dk, ncols, pad8(ncols), vec);
  load_tile(kfs, KP, kf + tok0 * Dkp, Dkp, min(TILE, W), Dkp, Dkp, true);
  load_tile(vs, DVP, v + tok0 * Dv + dv0, Dv, min(TILE, W), ncols, pad8(ncols), vec);
  cp_async_commit();

  if (bonus) {
    const int t = threadIdx.x / 2, h = threadIdx.x % 2;
    float s = 0.f;
    if (t < rows_q) {
      const long o = (tok0 + q0 + t) * Dk;
      for (int d = h; d < Dk; d += 2) s += r[o + d] * u[(long)x * Dk + d] * k[o + d];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (h == 0) rk[t] = s;
  }

  // the warp's query factors as A fragments, split once
  uint32_t qh[8][4], ql[8][4];
  {
    const int ra = q0 + m0 + g, rb = ra + 8;
    const float* pa = qf + (tok0 + ra) * Dkp + tg;
    const float* pb = qf + (tok0 + rb) * Dkp + tg;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s < nks) {
        split(ra < W ? pa[s * 8] : 0.f, qh[s][0], ql[s][0]);
        split(rb < W ? pb[s * 8] : 0.f, qh[s][1], ql[s][1]);
        split(ra < W ? pa[s * 8 + 4] : 0.f, qh[s][2], ql[s][2]);
        split(rb < W ? pb[s * 8 + 4] : 0.f, qh[s][3], ql[s][3]);
      }
    }
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  if (start != nullptr) {                  // q_fac S_c
    const float* s0 = vs + TILE * DVP;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      if (s < nks) mma_row(acc, qh[s], ql[s], s0, DVP, 1, s * 8, g, tg, false, ntv);
  }

  for (int kj = 0; kj <= qi; ++kj) {
    if (kj > 0) cp_async_wait_all();
    __syncthreads();            // tile kj landed; every warp is done with the other stage
    if (kj < qi) {
      const int k1 = (kj + 1) * TILE, rows = min(TILE, W - k1), st = (kj + 1) & 1;
      load_tile(kfs + st * TILE * KP, KP, kf + (tok0 + k1) * Dkp, Dkp, rows, Dkp, Dkp, true);
      load_tile(vs + st * TILE * DVP, DVP, v + (tok0 + k1) * Dv + dv0, Dv, rows, ncols,
                pad8(ncols), vec);
      cp_async_commit();
    }
    const float* kb = kfs + (kj & 1) * TILE * KP;
    const float* vb = vs + (kj & 1) * TILE * DVP;

    float att[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) att[n][i] = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s)         // B[d][tau] = k_fac[tau][d]: rows of kb are keys
      if (s < nks) mma_row(att, qh[s], ql[s], kb, 1, KP, s * 8, g, tg, false, 8);
    if (kj == qi) {             // causal mask of the diagonal tile, strict for bonus
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + g + (i >= 2 ? 8 : 0), key = n * 8 + 2 * tg + (i & 1);
          if (bonus ? key >= row : key > row) att[n][i] = 0.f;
        }
    }
    // att v: the accumulator of key block n is the A fragment of k-step n
    // with keys (2 tg, 2 tg + 1) in the slots of (tg, tg + 4)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t ah[4], al[4];
      split(att[n][0], ah[0], al[0]);
      split(att[n][2], ah[1], al[1]);
      split(att[n][1], ah[2], al[2]);
      split(att[n][3], ah[3], al[3]);
      mma_row(acc, ah, al, vb, DVP, 1, n * 8, g, tg, true, ntv);
    }
  }

  // y of the query tile (the diagonal tile's v is still staged)
  const float* vd = vs + (qi & 1) * TILE * DVP;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < ntv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + g + (i >= 2 ? 8 : 0), col = n * 8 + 2 * tg + (i & 1);
        float val = acc[n][i];
        if (bonus) val += rk[row] * vd[row * DVP + col];
        if (row < rows_q && col < ncols) y[(tok0 + q0 + row) * Dv + dv0 + col] = val;
      }
    }
  }
}

// 2. grid (BH, Dk Dv / 256); thread e owns state entry e of its row:
// S_{c+1} = S_c e^{max(cum_last, -30)} + the chunk's tile increments in tile
// order; S_c (c >= 1) goes to `starts` for scan_tiles' cross term
__global__ void __launch_bounds__(STATE_THREADS) scan_states(
    const float* __restrict__ decay, const float* __restrict__ part,
    const float* __restrict__ state0, float* __restrict__ starts, float* __restrict__ state_out,
    int S, int Dk, int Dv, int W) {
  const int C = S / W, n128 = cdiv(W, FAC_ROWS), Dkp = pad8(Dk);
  const int x = blockIdx.x, e = blockIdx.y * STATE_THREADS + threadIdx.x;
  if (e >= Dk * Dv) return;
  const int d = e / Dv;
  const long size = (long)Dk * Dv;
  // the increment of chunk c, its tiles in order
  auto increment = [&](int c) {
    const float* p = part + ((long)x * C + c) * n128 * size + e;
    float inc = 0.f;
    for (int i = 0; i < n128; ++i) inc += p[i * size];
    return inc;
  };
  float st = state0 != nullptr ? state0[x * size + e] : 0.f;
  float inc = C > 0 ? increment(0) : 0.f;
  for (int c = 0; c < C; ++c) {
    const float next = c + 1 < C ? increment(c + 1) : 0.f;     // in flight during the update
    st = st * decay[((long)x * C + c) * Dkp + d] + inc;
    if (c + 1 < C) starts[((long)x * C + c + 1) * size + e] = st;
    inc = next;
  }
  state_out[x * size + e] = st;
}

struct Workspace {
  float *qf, *kf, *decay, *part, *starts;
};

// workspace of the chunked regime, in floats: two factor arrays [BH, S, Dk8],
// e^{cum_last} [BH, C, Dk8], tile increments [BH, C, n128, Dk, Dv] and the
// chunk-start states [BH, C, Dk, Dv] (none for a single chunk)
long long workspace_floats(int BH, int S, int Dk, int Dv, int W, Workspace* ws, float* base) {
  if (W <= 1 || S == 0) return 0;
  const long long C = S / W, fac = (long long)BH * S * pad8(Dk);
  const long long dec = (long long)BH * C * pad8(Dk);
  const long long part = (long long)BH * C * cdiv(W, FAC_ROWS) * Dk * Dv;
  const long long starts = C > 1 ? (long long)BH * C * Dk * Dv : 0;
  if (ws != nullptr) {
    ws->qf = base;
    ws->kf = base + fac;
    ws->decay = base + 2 * fac;
    ws->part = base + 2 * fac + dec;
    ws->starts = base + 2 * fac + dec + part;
  }
  return 2 * fac + dec + part + starts;
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }


// ---------------------------------------------------------------------------
// (c) the backward: the vector-Jacobian product of the chunked form

constexpr int BT = 64;              // tokens of a backward tile
constexpr int BLD = BT + 1;         // row stride of every backward shared tile (odd: no
                                    // bank conflicts whichever way mm44 walks it)
constexpr int BTILE = BT * BLD;     // floats of one shared tile
constexpr int BWD_THREADS = 256;    // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int DQK_TILES = 7;        // shared tiles of bwd_dqk
constexpr int DV_TILES = 6;         // shared tiles of bwd_dv

// rows [0, nrows) x columns [0, ncols) of a row-major global array (row
// stride ld floats) into a [64][BLD] shared tile, zeros elsewhere in its 64 x 64
__device__ __forceinline__ void load64(float* dst, const float* src, long ld, int nrows,
                                       int ncols) {
  for (int i = threadIdx.x; i < BT * BT; i += blockDim.x) {
    const int t = i / BT, j = i % BT;
    dst[t * BLD + j] = t < nrows && j < ncols ? src[(long)t * ld + j] : 0.f;
  }
}

// acc[a][b] += sum_{k < K} X(ty + 16 a, k) Y(tx + 16 b, k), X(row, k) =
// X[row * xr + k * xk], Y(col, k) = Y[col * yc + k * yk], in f32 FMAs
__device__ __forceinline__ void mm44(float (&acc)[4][4], const float* X, int xr, int xk,
                                     const float* Y, int yc, int yk, int K) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kk = 0; kk < K; ++kk) {
    float xa[4], yb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xa[a] = X[(ty + 16 * a) * xr + kk * xk];
#pragma unroll
    for (int b = 0; b < 4; ++b) yb[b] = Y[(tx + 16 * b) * yc + kk * yk];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// the causal mask of a diagonal tile on a micro-tile whose rows are the
// earlier index (key tau) and whose columns the later (query t), or the
// other way round with `rows_are_queries`: keep tau < t, and tau == t unless bonus
__device__ __forceinline__ void mask44(float (&acc)[4][4], bool rows_are_queries, int bonus) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int row = ty + 16 * a, col = tx + 16 * b;
      const int t = rows_are_queries ? row : col, tau = rows_are_queries ? col : row;
      if (bonus ? tau >= t : tau > t) acc[a][b] = 0.f;
    }
}

__device__ __forceinline__ void store44(float* dst, const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[(ty + 16 * a) * BLD + tx + 16 * b] = acc[a][b];
}

// a per-(token, Dk column) micro-tile of the tile's tokens to out [BH, S,
// LC]: as it is, or (one log w column) summed over Dk in order through scr
__device__ __forceinline__ void emit_terms(const float (&val)[4][4], float* out, float* scr,
                                           int LC, long tok, int ni, int Dk) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (LC != 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = ty + 16 * a, d = tx + 16 * b;
        if (t < ni && d < Dk) out[(tok + t) * Dk + d] = val[a][b];
      }
    return;
  }
  __syncthreads();
  store44(scr, val);
  __syncthreads();
  if (tid < ni) {
    float sum = 0.f;
    for (int d = 0; d < Dk; ++d) sum += scr[tid * BLD + d];
    out[tok + tid] = sum;
  }
}

// B1. grid BH * C * n128: P = q_fac^T g over the 128-row tile's tokens, into
// the layout of scan_factors' increments (whose buffer it reuses)
__global__ void __launch_bounds__(BWD_THREADS) bwd_qg(
    const float* __restrict__ qf, const float* __restrict__ dy, float* __restrict__ part, int S,
    int Dk, int Dv, int W) {
  __shared__ float qs[BTILE], gs[BTILE];
  const int C = S / W, n128 = cdiv(W, FAC_ROWS), Dkp = pad8(Dk);
  const int xc = blockIdx.x / n128, tile = blockIdx.x % n128, x = xc / C, c = xc % C;
  const long tok0 = (long)x * S + (long)c * W + tile * FAC_ROWS;
  const int rows = min(FAC_ROWS, W - tile * FAC_ROWS);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* pp = part + ((long)xc * n128 + tile) * Dk * Dv;
  for (int v0 = 0; v0 < Dv; v0 += BT) {
    const int nv = min(BT, Dv - v0);
    float acc[4][4];
    zero44(acc);
    for (int t0 = 0; t0 < rows; t0 += BT) {
      const int n = min(BT, rows - t0);
      __syncthreads();
      load64(qs, qf + (tok0 + t0) * Dkp, Dkp, n, Dk);
      load64(gs, dy + (tok0 + t0) * Dv + v0, Dv, n, nv);
      __syncthreads();
      mm44(acc, qs, 1, BLD, gs, 1, BLD, n);          // (d, v) += q_fac[t][d] g[t][v]
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = ty + 16 * a, j = tx + 16 * b;
        if (d < Dk && j < nv) pp[(long)d * Dv + v0 + j] = acc[a][b];
      }
  }
}

// B2. grid (BH, Dk Dv / 256), one thread per state entry, chunks in reverse:
// G_{c+1} to `after`, G_c = G_{c+1} e^{max(cum_last, -30)} + chunk c's P in
// tile order; G_0 is the gradient of state0
__global__ void __launch_bounds__(STATE_THREADS) bwd_states(
    const float* __restrict__ decay, const float* __restrict__ part,
    const float* __restrict__ dstate, float* __restrict__ after, float* __restrict__ dstate0,
    int S, int Dk, int Dv, int W) {
  const int C = S / W, n128 = cdiv(W, FAC_ROWS), Dkp = pad8(Dk);
  const int x = blockIdx.x, e = blockIdx.y * STATE_THREADS + threadIdx.x;
  if (e >= Dk * Dv) return;
  const int d = e / Dv;
  const long size = (long)Dk * Dv;
  float gr = dstate != nullptr ? dstate[x * size + e] : 0.f;
  for (int c = C - 1; c >= 0; --c) {
    after[((long)x * C + c) * size + e] = gr;
    const float* p = part + ((long)x * C + c) * n128 * size + e;
    float qg = 0.f;
    for (int i = 0; i < n128; ++i) qg += p[i * size];
    gr = gr * decay[((long)x * C + c) * Dkp + d] + qg;
  }
  if (dstate0 != nullptr) dstate0[x * size + e] = gr;
}

struct BwdArgs {
  const float *r, *k, *v, *lw, *u, *state0, *dy;
  const float *qf, *kf, *cum, *decay, *starts, *after;
  float *dr, *dk, *dv, *dlw, *du, *ddl, *xs, *es, *as, *dupart;
  int S, Dk, Dv, LC, W, bonus;
};

// B3. grid BH * C * nt, one block per (row, chunk, 64-token tile i): the
// gradients of q_fac, k_fac and k_state of the tile's tokens, then dr, dk,
// the masked exponential terms (a, e and d cum = a - b - e; summed over Dk
// in Dk order when log w has one column), the tile's share of du and, in
// tile 0, d dl = sum_v S_c G_{c+1}.  Shared tiles: 0 k_fac of tile j, 1
// q_fac of tile j, 2 / 3 g / v of tile i, 4 g of tile j (G_{c+1} in the
// cross pass), 5 v of tile j (S_c in the cross pass), 6 scratch.
__global__ void __launch_bounds__(BWD_THREADS) bwd_dqk(BwdArgs p) {
  extern __shared__ float smem[];
  float *fk = smem, *fq = fk + BTILE, *gi = fq + BTILE, *vi = gi + BTILE;
  float *gj = vi + BTILE, *vj = gj + BTILE, *scr = vj + BTILE, *gam = scr + BTILE;
  const int S = p.S, Dk = p.Dk, Dv = p.Dv, W = p.W, bonus = p.bonus;
  const int C = S / W, nt = cdiv(W, BT), Dkp = pad8(Dk), nvs = cdiv(Dv, BT);
  const int xc = blockIdx.x / nt, i = blockIdx.x % nt, x = xc / C, c = xc % C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long tok0 = (long)x * S + (long)c * W, size = (long)Dk * Dv;
  const int q0 = i * BT, ni = min(BT, W - q0);
  const float* s_c = c == 0 ? (p.state0 == nullptr ? nullptr : p.state0 + x * size)
                            : p.starts + (long)xc * size;
  const float* g_n = p.after + (long)xc * size;

  float acc_dq[4][4], acc_dk[4][4], acc_ds[4][4];
  zero44(acc_dq);
  zero44(acc_dk);
  zero44(acc_ds);
  float gam_r = 0.f, ddl_r = 0.f;

  // cross terms: dq_fac += g S_c^T, dk_state = v G_{c+1}^T, gamma = g . v, d dl
  for (int s = 0; s < nvs; ++s) {
    const int v0 = s * BT, nv = min(BT, Dv - v0);
    __syncthreads();
    load64(gi, p.dy + (tok0 + q0) * Dv + v0, Dv, ni, nv);
    load64(vi, p.v + (tok0 + q0) * Dv + v0, Dv, ni, nv);
    if (s_c != nullptr) load64(vj, s_c + v0, Dv, Dk, nv);
    load64(gj, g_n + v0, Dv, Dk, nv);
    __syncthreads();
    if (s_c != nullptr) mm44(acc_dq, gi, BLD, 1, vj, BLD, 1, nv);
    mm44(acc_ds, vi, BLD, 1, gj, BLD, 1, nv);
    if (tid < BT)
      for (int j = 0; j < nv; ++j) gam_r = fmaf(gi[tid * BLD + j], vi[tid * BLD + j], gam_r);
    if (i == 0 && s_c != nullptr && tid < Dk)
      for (int j = 0; j < nv; ++j) ddl_r = fmaf(vj[tid * BLD + j], gj[tid * BLD + j], ddl_r);
  }
  if (tid < BT) gam[tid] = gam_r;
  if (i == 0 && tid < Dk) p.ddl[(long)xc * Dk + tid] = ddl_r;

  // intra-chunk: keys j <= i give dq_fac (dA = g_i v_j^T, then dA k_fac_j),
  // queries j >= i give dk_fac (dA^T = v_i g_j^T, then dA^T q_fac_j)
  for (int j = 0; j < nt; ++j) {
    const int nj = min(BT, W - j * BT);
    const long tj = tok0 + (long)j * BT;
    float a1[4][4], a2[4][4];
    zero44(a1);
    zero44(a2);
    for (int s = 0; s < nvs; ++s) {
      const int v0 = s * BT, nv = min(BT, Dv - v0);
      __syncthreads();
      if (nvs > 1) {
        load64(gi, p.dy + (tok0 + q0) * Dv + v0, Dv, ni, nv);
        load64(vi, p.v + (tok0 + q0) * Dv + v0, Dv, ni, nv);
      }
      if (j != i) {
        load64(gj, p.dy + tj * Dv + v0, Dv, nj, nv);
        load64(vj, p.v + tj * Dv + v0, Dv, nj, nv);
      }
      __syncthreads();
      const float* gb = j == i ? gi : gj;
      const float* vb = j == i ? vi : vj;
      if (j <= i) mm44(a1, gi, BLD, 1, vb, BLD, 1, nv);      // (t, tau)
      if (j >= i) mm44(a2, vi, BLD, 1, gb, BLD, 1, nv);      // (tau, t)
    }
    if (j == i) {
      mask44(a1, true, bonus);
      mask44(a2, false, bonus);
    }
    if (j <= i) {
      __syncthreads();
      load64(fk, p.kf + tj * Dkp, Dkp, nj, Dk);
      store44(scr, a1);
      __syncthreads();
      mm44(acc_dq, scr, BLD, 1, fk, 1, BLD, nj);
    }
    if (j >= i) {
      __syncthreads();
      load64(fq, p.qf + tj * Dkp, Dkp, nj, Dk);
      store44(scr, a2);
      __syncthreads();
      mm44(acc_dk, scr, BLD, 1, fq, 1, BLD, nj);
    }
  }

  // through the exponentials
  float xv[4][4], ev[4][4], av[4][4], duv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int t = ty + 16 * a, d = tx + 16 * b;
      xv[a][b] = ev[a][b] = av[a][b] = duv[a][b] = 0.f;
      if (t >= ni || d >= Dk) continue;
      const long tok = tok0 + q0 + t;
      const float rr = p.r[tok * Dk + d], kk = p.k[tok * Dk + d];
      const float cm = p.cum[tok * Dkp + d], cw = p.cum[(tok0 + W - 1) * Dkp + d];
      const float w = p.lw[tok * p.LC + (p.LC == 1 ? 0 : d)];
      const float qc = bonus ? cm - w : cm;
      const float eq = expf(fmaxf(qc, -CLAMP)), ek = expf(fminf(-cm, CLAMP));
      const float es = expf(fmaxf(cw - cm, -CLAMP));
      float dr = acc_dq[a][b] * eq;
      float dk = acc_dk[a][b] * ek + acc_ds[a][b] * es;
      if (bonus) {
        const float gu = gam[t] * p.u[(long)x * Dk + d];
        dr = fmaf(gu, kk, dr);
        dk = fmaf(gu, rr, dk);
        duv[a][b] = gam[t] * rr * kk;
      }
      p.dr[tok * Dk + d] = dr;
      p.dk[tok * Dk + d] = dk;
      const float ta = qc >= -CLAMP ? acc_dq[a][b] * (rr * eq) : 0.f;
      const float tb = cm >= -CLAMP ? acc_dk[a][b] * (kk * ek) : 0.f;
      const float te = cw - cm >= -CLAMP ? acc_ds[a][b] * (kk * es) : 0.f;
      xv[a][b] = ta - tb - te;
      ev[a][b] = te;
      av[a][b] = ta;
    }
  emit_terms(xv, p.xs, scr, p.LC, tok0 + q0, ni, Dk);
  emit_terms(ev, p.es, scr, p.LC, tok0 + q0, ni, Dk);
  if (bonus) emit_terms(av, p.as, scr, p.LC, tok0 + q0, ni, Dk);
  if (bonus) {                            // the tile's du: sum over its tokens in order
    __syncthreads();
    store44(scr, duv);
    __syncthreads();
    if (tid < Dk) {
      float sum = 0.f;
      for (int t = 0; t < ni; ++t) sum += scr[t * BLD + tid];
      p.dupart[((long)xc * nt + i) * Dk + tid] = sum;
    }
  }
}

// B4. grid BH * C * nt: dv of a 64-token tile i, per 64 v columns:
// k_state G_{c+1} + sum over query tiles j >= i of A_ji^T g_j (+ beta g).
// Shared tiles: 0 k_fac of tile i, 1 k_state of tile i, 2 q_fac of tile j,
// 3 G_{c+1}, 4 g of tile j, 5 A_ji^T
__global__ void __launch_bounds__(BWD_THREADS) bwd_dv(BwdArgs p) {
  extern __shared__ float smem[];
  float *ki = smem, *kst = ki + BTILE, *fq = kst + BTILE, *gn = fq + BTILE;
  float *gj = gn + BTILE, *scr = gj + BTILE, *beta = scr + BTILE;
  const int S = p.S, Dk = p.Dk, Dv = p.Dv, W = p.W, bonus = p.bonus;
  const int C = S / W, nt = cdiv(W, BT), Dkp = pad8(Dk);
  const int xc = blockIdx.x / nt, i = blockIdx.x % nt, x = xc / C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long tok0 = (long)x * S + (long)(xc % C) * W, size = (long)Dk * Dv;
  const int q0 = i * BT, ni = min(BT, W - q0);
  const float* g_n = p.after + (long)xc * size;

  load64(ki, p.kf + (tok0 + q0) * Dkp, Dkp, ni, Dk);
  for (int e = tid; e < BT * BT; e += blockDim.x) {
    const int t = e / BT, d = e % BT;
    float val = 0.f;
    if (t < ni && d < Dk) {
      const long tok = tok0 + q0 + t;
      const float cm = p.cum[tok * Dkp + d], cw = p.cum[(tok0 + W - 1) * Dkp + d];
      val = p.k[tok * Dk + d] * expf(fmaxf(cw - cm, -CLAMP));
    }
    kst[t * BLD + d] = val;
  }
  if (bonus && tid < BT) {
    float sum = 0.f;
    if (tid < ni) {
      const long o = (tok0 + q0 + tid) * Dk;
      for (int d = 0; d < Dk; ++d) sum += p.r[o + d] * p.u[(long)x * Dk + d] * p.k[o + d];
    }
    beta[tid] = sum;
  }
  for (int v0 = 0; v0 < Dv; v0 += BT) {
    const int nv = min(BT, Dv - v0);
    float acc[4][4];
    zero44(acc);
    __syncthreads();
    load64(gn, g_n + v0, Dv, Dk, nv);
    __syncthreads();
    mm44(acc, kst, BLD, 1, gn, 1, BLD, Dk);           // (t, v) += k_state[t][d] G[d][v]
    for (int j = i; j < nt; ++j) {
      const int nj = min(BT, W - j * BT);
      const long tj = tok0 + (long)j * BT;
      __syncthreads();
      load64(fq, p.qf + tj * Dkp, Dkp, nj, Dk);
      load64(gj, p.dy + tj * Dv + v0, Dv, nj, nv);
      __syncthreads();
      float at[4][4];
      zero44(at);
      mm44(at, ki, BLD, 1, fq, BLD, 1, Dk);           // A^T (tau, t) = k_fac_i . q_fac_j
      if (j == i) mask44(at, false, bonus);
      store44(scr, at);
      __syncthreads();
      mm44(acc, scr, BLD, 1, gj, 1, BLD, nj);         // (tau, v) += A^T[tau][t] g_j[t][v]
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = ty + 16 * a, j = tx + 16 * b;
        if (t >= ni || j >= nv) continue;
        const long o = (tok0 + q0 + t) * Dv + v0 + j;
        p.dv[o] = bonus ? fmaf(beta[t], p.dy[o], acc[a][b]) : acc[a][b];
      }
  }
}

// B5. grid BH * C, one thread per log w column: d log w = the reverse
// cumsum of d cum within the chunk + d cum_last (sum_t e + d dl dl where
// cum_last >= -30), minus a for bonus; block (x, 0) also sums row x's du
// over its chunks and tiles in order
__global__ void __launch_bounds__(64) bwd_decay(BwdArgs p) {
  const int S = p.S, Dk = p.Dk, W = p.W, LC = p.LC;
  const int C = S / W, nt = cdiv(W, BT), Dkp = pad8(Dk);
  const int xc = blockIdx.x, x = xc / C, c = xc % C, j = threadIdx.x;
  const long tok0 = (long)x * S + (long)c * W;
  if (j < LC) {
    float last = 0.f;
    for (int t = 0; t < W; ++t) last += p.es[(tok0 + t) * LC + j];
    for (int d = LC == 1 ? 0 : j; d < (LC == 1 ? Dk : j + 1); ++d)
      if (p.cum[(tok0 + W - 1) * Dkp + d] >= -CLAMP)
        last = fmaf(p.ddl[(long)xc * Dk + d], p.decay[(long)xc * Dkp + d], last);
    float run = 0.f;
    for (int t = W - 1; t >= 0; --t) {
      const long o = (tok0 + t) * LC + j;
      run += p.xs[o];
      p.dlw[o] = p.bonus ? run + last - p.as[o] : run + last;
    }
  }
  if (p.bonus && c == 0 && j < Dk) {
    float sum = 0.f;
    for (int cc = 0; cc < C; ++cc)
      for (int i = 0; i < nt; ++i) sum += p.dupart[(((long)x * C + cc) * nt + i) * Dk + j];
    p.du[(long)x * Dk + j] = sum;
  }
}

// workspace of the backward, in floats (each part a multiple of 4): q_fac,
// k_fac and cum [BH, S, Dk8]; e^{cum_last} [BH, C, Dk8]; the increments,
// then P [BH, C, n128, Dk, Dv]; S_c and G_{c+1} [BH, C, Dk, Dv]; the final
// state [BH, Dk, Dv]; d dl [BH, C, Dk]; d cum, e and a [BH, S, LC]; du per
// tile [BH, C, nt, Dk]
struct BwdWorkspace {
  float *qf, *kf, *cum, *decay, *part, *starts, *after, *fin, *ddl, *xs, *es, *as, *dupart;
};

long long bwd_workspace_floats(int BH, int S, int Dk, int Dv, int LC, int W, BwdWorkspace* ws,
                               float* base) {
  if (S == 0 || W < 1) return 0;
  auto r4 = [](long long n) { return (n + 3) & ~3LL; };
  const long long C = S / W, fac = r4((long long)BH * S * pad8(Dk));
  const long long states = r4((long long)BH * C * Dk * Dv), tok = r4((long long)BH * S * LC);
  const long long sizes[13] = {fac, fac, fac, r4((long long)BH * C * pad8(Dk)),
                               r4((long long)BH * C * cdiv(W, FAC_ROWS) * Dk * Dv), states, states,
                               r4((long long)BH * Dk * Dv), r4((long long)BH * C * Dk), tok, tok,
                               tok, r4((long long)BH * C * cdiv(W, BT) * Dk)};
  float** slots[13] = {&ws->qf, &ws->kf, &ws->cum, &ws->decay, &ws->part, &ws->starts,
                       &ws->after, &ws->fin, &ws->ddl, &ws->xs, &ws->es, &ws->as, &ws->dupart};
  long long off = 0;
  for (int n = 0; n < 13; ++n) {
    if (base != nullptr) *slots[n] = base + off;
    off += sizes[n];
  }
  return off;
}

}  // namespace

// Bytes of workspace linear_scan_launch needs for these shapes (0 in the step regime).
extern "C" long long linear_scan_workspace_bytes(int BH, int S, int Dk, int Dv, int W) {
  return 4 * workspace_floats(BH, S, Dk, Dv, W, nullptr, nullptr);
}

extern "C" int linear_scan_launch(const void* r, const void* k, const void* v, const void* lw,
                                  const void* u, const void* state0, void* y, void* state,
                                  void* workspace, int BH, int S, int Dk, int Dv, int LC, int W,
                                  int bonus, void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || (LC != 1 && LC != Dk) || W < 1 || S % W)
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float *rf = (const float*)r, *kf = (const float*)k, *vf = (const float*)v;
  const float *lwf = (const float*)lw, *uf = (const float*)u, *s0 = (const float*)state0;
  float *yf = (float*)y, *sf = (float*)state;
  const bool vec = Dv % 4 == 0 && aligned16(v) && aligned16(y) && aligned16(state0) &&
                   aligned16(state);

  if (W == 1) {
    if (vec)
      scan_step<4><<<dim3(BH, cdiv(Dv, 64)), STEP_THREADS, 0, st>>>(rf, kf, vf, lwf, uf, s0, yf,
                                                                    sf, S, Dk, Dv, LC, bonus);
    else
      scan_step<1><<<dim3(BH, cdiv(Dv, 16)), STEP_THREADS, 0, st>>>(rf, kf, vf, lwf, uf, s0, yf,
                                                                    sf, S, Dk, Dv, LC, bonus);
    return (int)cudaGetLastError();
  }

  Workspace ws{};
  workspace_floats(BH, S, Dk, Dv, W, &ws, (float*)workspace);
  const int C = S / W;
  if (S > 0) {
    if (workspace == nullptr || !aligned16(workspace)) return (int)cudaErrorInvalidValue;
    static bool smem_set = false;       // the attribute is the function's; set it once
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          scan_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(sizeof(float) * tiles_smem_floats(MAX_KP)));
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    scan_factors<<<dim3(BH * C * cdiv(W, FAC_ROWS), cdiv(pad8(Dk), 16)), FAC_THREADS, 0, st>>>(
        rf, kf, vf, lwf, ws.qf, ws.kf, ws.decay, ws.part, nullptr, S, Dk, Dv, LC, W, bonus,
        (int)vec);
  }
  scan_states<<<dim3(BH, cdiv(Dk * Dv, STATE_THREADS)), STATE_THREADS, 0, st>>>(
      ws.decay, ws.part, s0, ws.starts, sf, S, Dk, Dv, W);
  if (S > 0) {
    const size_t smem = sizeof(float) * tiles_smem_floats(pad8(Dk) + 4);
    scan_tiles<<<dim3(BH * C * cdiv(W, TILE), cdiv(Dv, DVT)), TILE_THREADS, smem, st>>>(
        ws.qf, ws.kf, rf, kf, vf, uf, s0, ws.starts, yf, BH, S, Dk, Dv, W, bonus, (int)vec);
  }
  return (int)cudaGetLastError();
}

// Bytes of workspace linear_scan_bwd_launch needs for these shapes.
extern "C" long long linear_scan_bwd_workspace_bytes(int BH, int S, int Dk, int Dv, int LC,
                                                     int W) {
  BwdWorkspace ws{};
  return 4 * bwd_workspace_floats(BH, S, Dk, Dv, LC, W, &ws, nullptr);
}

// The backward of linear_scan_launch: given dy [BH, S, Dv] and dstate [BH,
// Dk, Dv] (or null: zero), writes dr, dk [BH, S, Dk], dv [BH, S, Dv], dlw
// [BH, S, LC], du [BH, Dk] (bonus) and dstate0 [BH, Dk, Dv] (or null).  Any
// W that divides S (W = 1 too) runs the chunked form's seven launches.
extern "C" int linear_scan_bwd_launch(const void* r, const void* k, const void* v,
                                      const void* lw, const void* u, const void* state0,
                                      const void* dy, const void* dstate, void* dr, void* dk,
                                      void* dv, void* dlw, void* du, void* dstate0,
                                      void* workspace, int BH, int S, int Dk, int Dv, int LC,
                                      int W, int bonus, void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || (LC != 1 && LC != Dk) || W < 1 || S % W ||
      (bonus && (u == nullptr || du == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static bool smem_set = false;
  const int dqk_smem = (int)sizeof(float) * (DQK_TILES * BTILE + BT);
  const int dv_smem = (int)sizeof(float) * (DV_TILES * BTILE + BT);
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dqk_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dv, cudaFuncAttributeMaxDynamicSharedMemorySize, dv_smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  BwdWorkspace ws{};
  bwd_workspace_floats(BH, S, Dk, Dv, LC, W, &ws, (float*)workspace);
  const float *rf = (const float*)r, *kf = (const float*)k, *vf = (const float*)v;
  const float *lwf = (const float*)lw, *s0 = (const float*)state0;
  const bool vec = Dv % 4 == 0 && aligned16(v);
  const int C = S / W, n128 = cdiv(W, FAC_ROWS), nt = cdiv(W, BT);

  // the forward's factors and chunk-start states, recomputed
  scan_factors<<<dim3(BH * C * n128, cdiv(pad8(Dk), 16)), FAC_THREADS, 0, st>>>(
      rf, kf, vf, lwf, ws.qf, ws.kf, ws.decay, ws.part, ws.cum, S, Dk, Dv, LC, W, bonus,
      (int)vec);
  scan_states<<<dim3(BH, cdiv(Dk * Dv, STATE_THREADS)), STATE_THREADS, 0, st>>>(
      ws.decay, ws.part, s0, ws.starts, ws.fin, S, Dk, Dv, W);
  // the reverse state pass
  bwd_qg<<<BH * C * n128, BWD_THREADS, 0, st>>>(ws.qf, (const float*)dy, ws.part, S, Dk, Dv, W);
  bwd_states<<<dim3(BH, cdiv(Dk * Dv, STATE_THREADS)), STATE_THREADS, 0, st>>>(
      ws.decay, ws.part, (const float*)dstate, ws.after, (float*)dstate0, S, Dk, Dv, W);
  // the intra-chunk terms, then d log w and du
  BwdArgs a{rf, kf, vf, lwf, (const float*)u, s0, (const float*)dy,
            ws.qf, ws.kf, ws.cum, ws.decay, ws.starts, ws.after,
            (float*)dr, (float*)dk, (float*)dv, (float*)dlw, (float*)du,
            ws.ddl, ws.xs, ws.es, ws.as, ws.dupart, S, Dk, Dv, LC, W, bonus};
  bwd_dqk<<<BH * C * nt, BWD_THREADS, dqk_smem, st>>>(a);
  bwd_dv<<<BH * C * nt, BWD_THREADS, dv_smem, st>>>(a);
  bwd_decay<<<BH * C, 64, 0, st>>>(a);
  return (int)cudaGetLastError();
}
