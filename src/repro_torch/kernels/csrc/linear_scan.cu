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
//     chunk is d log w.  Bound by operations: the W^2 / 2 pair products and
//     the token-by-state products (2.6 GFLOP at rwkv6-3b's training shape),
//     which the f32 CUDA cores run ~7x slower than the TF32 tensor cores.  So
//     every product runs on the tensor cores in 3xTF32, as scan_tiles' do:
//     TF32 keeps f32's exponent, so the factors' e^-30 .. e^30 span is safe,
//     and the hi + lo split keeps ~2^-19 relative error per product (each
//     gradient holds its 2e-3 limit; none needed f32 FMAs).  The CUDA cores
//     keep the elementwise work (factors, exponentials, the masked terms),
//     the state passes and the sums.  With the products there, bytes bound
//     the call about as much (95.7 MB at rwkv6-3b's shape), and the
//     workspace of the recompute adds to them: the owner block's reads and
//     writes of its epilogue, not its products, take the largest share.
//     Three launches when a chunk is one 64-token tile (every training
//     shape), five when it has more, and bwd_du for bonus; no float atomics:
//     scan_factors recomputes the forward's factors (and cum, for the masks)
//     and, on the four warps the increment leaves idle, q_fac^T g per 128-row
//     tile; scan_states recomputes the chunk-start states and then walks the
//     chunks in reverse for G_{c+1}; bwd_pair runs one 256-thread block per
//     64-token tile pair (i >= j) of a chunk, so at chunk = S no block walks
//     the chunk's tiles: it stages q_fac and k_fac with 16-byte cp.async at
//     Dk8 width (hymba's Dk 16 runs 16 columns, not 64) and g, v (and for
//     the diagonal pair S_c and G_{c+1}) in 64-column slices, forms A and dA
//     once each, and from them the pair's shares of dq, dk and dv; the
//     off-diagonal pairs write their shares to the workspace, and each tile's
//     owner (its diagonal pair, launched after them) adds them in a fixed
//     order to the tile's cross terms and runs the epilogue, coalesced, once
//     its tiles are free; with one tile a chunk it also finishes d log w's
//     reverse cumsum.  At Dk 64 a block holds 104 KB, so two share an SM and
//     one's copies run under the other's products.  bwd_decay (more than one
//     tile a chunk): d log w's reverse cumsum as a segmented scan over 256
//     threads; bwd_du: du, the tiles' sums in order.
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
constexpr int FAC_SLICE = FAC_ROWS * (KSTP + VTP);   // floats of k_state and a v slice
constexpr int STEP_THREADS = 256;   // 16 column groups x 16 row groups

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// dynamic shared bytes of scan_factors: k_state and a v slice, and in the
// backward q_fac and a g slice beside them
inline int fac_smem_bytes(bool backward) {
  return (int)sizeof(float) * FAC_SLICE * (backward ? 2 : 1);
}

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
template <int NB = 8>           // NB >= count: the accumulator's blocks
__device__ __forceinline__ void mma_row(float (*acc)[4], const uint32_t* ah, const uint32_t* al,
                                        const float* s, int ldk, int ldn, int k0, int g, int tg,
                                        bool pairs, int count) {
  uint32_t bh[NB][2], bl[NB][2];
  const int r0 = pairs ? k0 + 2 * tg : k0 + tg, r1 = pairs ? r0 + 1 : r0 + 4;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (n < count) {
      split(s[r0 * ldk + (8 * n + g) * ldn], bh[n][0], bl[n][0]);
      split(s[r1 * ldk + (8 * n + g) * ldn], bh[n][1], bl[n][1]);
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
    if (n < count) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
    if (n < count) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
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
// each 32-column slice.  Given dy (the backward), warps 4-7 compute the
// tile's q_fac^T g into qgpart the same way, in the same slices.
__global__ void __launch_bounds__(FAC_THREADS) scan_factors(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ lw, float* __restrict__ qf, float* __restrict__ kf,
    float* __restrict__ decay, float* __restrict__ part, float* __restrict__ cum_out,
    const float* __restrict__ dy, float* __restrict__ qgpart, int S, int Dk, int Dv, int LC,
    int W, int bonus, int vec) {
  __shared__ float before_s[16][17], all_s[16][17], tot[16][17];
  extern __shared__ __align__(16) float fsm[];     // fac_smem_bytes(dy != nullptr)
  float(*kst)[KSTP] = reinterpret_cast<float(*)[KSTP]>(fsm);
  float(*vt)[VTP] = reinterpret_cast<float(*)[VTP]>(fsm + FAC_ROWS * KSTP);
  float(*qst)[KSTP] = reinterpret_cast<float(*)[KSTP]>(fsm + FAC_SLICE);   // backward only
  float(*gt)[VTP] = reinterpret_cast<float(*)[VTP]>(fsm + FAC_SLICE + FAC_ROWS * KSTP);
  const bool qg = dy != nullptr;
  const int C = S / W, Dkp = pad8(Dk), n128 = cdiv(W, FAC_ROWS);
  const int xc = blockIdx.x / n128, tile = blockIdx.x % n128;
  const int x = xc / C, c = xc % C;
  const int col = threadIdx.x % 16, seg = threadIdx.x / 16;
  const int d = blockIdx.y * 16 + col;
  const bool real = d < Dk;
  const long row0 = (long)x * S + (long)c * W;          // the chunk's first token
  const float* lwc = lw + row0 * LC + (LC == 1 ? 0 : min(d, Dk - 1));
  const int t0 = tile * FAC_ROWS, rows = min(FAC_ROWS, W - t0);

  // a slice of INC_COLS v (and g) columns of the tile into shared memory,
  // zero-filled, asynchronously; the first one lands under the factors' work
  auto stage = [&](float (*dst)[VTP], const float* src, int ncols) {
    if (vec) {
      for (int i = threadIdx.x; i < FAC_ROWS * INC_COLS / 4; i += FAC_THREADS) {
        const int t = i / (INC_COLS / 4), j = (i % (INC_COLS / 4)) * 4;
        const bool ok = t < rows && j < ncols;
        cp_async16(&dst[t][j], ok ? src + (long)t * Dv + j : src, ok);
      }
    } else {
      for (int i = threadIdx.x; i < FAC_ROWS * INC_COLS; i += FAC_THREADS) {
        const int t = i / INC_COLS, j = i % INC_COLS;
        const bool ok = t < rows && j < ncols;
        cp_async4(&dst[t][j], ok ? src + (long)t * Dv + j : src, ok);
      }
    }
  };
  auto stage_slice = [&](int j0) {
    stage(vt, v + (row0 + t0) * Dv + j0, min(INC_COLS, Dv - j0));
    if (qg) stage(gt, dy + (row0 + t0) * Dv + j0, min(INC_COLS, Dv - j0));
    cp_async_commit();
  };
  stage_slice(0);

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
    const float qc = bonus ? cum - w[i] : cum;
    const float qv = t < W && real ? rr[i] * expf(fmaxf(qc, -CLAMP)) : 0.f;
    if (t < W && d < Dkp) {
      const long o = (row0 + t) * Dkp + d;
      qf[o] = qv;
      kf[o] = real ? kk[i] * expf(fminf(-cum, CLAMP)) : 0.f;
      if (cum_out != nullptr) cum_out[o] = real ? cum : 0.f;    // the backward's masks
    }
    kst[seg * 8 + i][col] = t < W && real ? kk[i] * expf(fmaxf(last - cum, -CLAMP)) : 0.f;
    if (qg) qst[seg * 8 + i][col] = qv;
  }

  // the tile's state increment k_state^T v on the tensor cores, over
  // slices of INC_COLS v columns: warp w < INC_COLS / 8 owns columns 8 w ..;
  // in the backward, warp w + 4 owns the same columns of q_fac^T g
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int nk = cdiv(rows, 8);
  const long slot = (((long)x * C + c) * n128 + tile) * Dk * Dv + (long)blockIdx.y * 16 * Dv;
  for (int j0 = 0; j0 < Dv; j0 += INC_COLS) {
    const int ncols = min(INC_COLS, Dv - j0);
    if (j0 > 0) {
      __syncthreads();          // the previous slice's readers are done
      stage_slice(j0);
    }
    cp_async_wait_all();
    __syncthreads();            // the slice and kst landed
    const int wc = warp % 4;
    if ((warp < 4 || qg) && wc * 8 < ncols) {
      float(*a)[KSTP] = warp < 4 ? kst : qst;
      float(*b)[VTP] = warp < 4 ? vt : gt;
      float* pp = (warp < 4 ? part : qgpart) + slot;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < nk; ++ks) {         // A[d][t] = k_state[t][d] (q_fac[t][d])
        uint32_t ah[4], al[4];
        split(a[ks * 8 + tg][g], ah[0], al[0]);
        split(a[ks * 8 + tg][g + 8], ah[1], al[1]);
        split(a[ks * 8 + tg + 4][g], ah[2], al[2]);
        split(a[ks * 8 + tg + 4][g + 8], ah[3], al[3]);
        mma_row<1>(acc, ah, al, &b[0][wc * 8], VTP, 1, ks * 8, g, tg, false, 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dl = g + (i >= 2 ? 8 : 0), j = wc * 8 + 2 * tg + (i & 1);
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
// order; S_c (c >= 1) goes to `starts` for scan_tiles' cross term.  Given
// qgpart (the backward), the same thread then walks the chunks in reverse:
// G_{c+1} to `after`, G_c = G_{c+1} e^{max(cum_last, -30)} + chunk c's
// q_fac^T g in tile order; G_0 is the gradient of state0
__global__ void __launch_bounds__(STATE_THREADS) scan_states(
    const float* __restrict__ decay, const float* __restrict__ part,
    const float* __restrict__ state0, float* __restrict__ starts, float* __restrict__ state_out,
    const float* __restrict__ qgpart, const float* __restrict__ dstate,
    float* __restrict__ after, float* __restrict__ dstate0, int S, int Dk, int Dv, int W) {
  const int C = S / W, n128 = cdiv(W, FAC_ROWS), Dkp = pad8(Dk);
  const int x = blockIdx.x, e = blockIdx.y * STATE_THREADS + threadIdx.x;
  if (e >= Dk * Dv) return;
  const int d = e / Dv;
  const long size = (long)Dk * Dv;
  // chunk c's tiles of `from`, summed in order
  auto tiles = [&](const float* from, int c) {
    const float* p = from + ((long)x * C + c) * n128 * size + e;
    float inc = 0.f;
    for (int i = 0; i < n128; ++i) inc += p[i * size];
    return inc;
  };
  auto dec = [&](int c) { return decay[((long)x * C + c) * Dkp + d]; };
  float st = state0 != nullptr ? state0[x * size + e] : 0.f;
  float inc = C > 0 ? tiles(part, 0) : 0.f, dl = C > 0 ? dec(0) : 0.f;
  for (int c = 0; c < C; ++c) {     // the next chunk's loads in flight during the update
    const float next = c + 1 < C ? tiles(part, c + 1) : 0.f, dn = c + 1 < C ? dec(c + 1) : 0.f;
    st = st * dl + inc;
    if (c + 1 < C) starts[((long)x * C + c + 1) * size + e] = st;
    inc = next;
    dl = dn;
  }
  state_out[x * size + e] = st;
  if (qgpart == nullptr) return;
  float gr = dstate != nullptr ? dstate[x * size + e] : 0.f;
  float qg = C > 0 ? tiles(qgpart, C - 1) : 0.f;
  dl = C > 0 ? dec(C - 1) : 0.f;
  for (int c = C - 1; c >= 0; --c) {
    const float qn = c > 0 ? tiles(qgpart, c - 1) : 0.f, dn = c > 0 ? dec(c - 1) : 0.f;
    after[((long)x * C + c) * size + e] = gr;
    gr = gr * dl + qg;
    qg = qn;
    dl = dn;
  }
  if (dstate0 != nullptr) dstate0[x * size + e] = gr;
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
constexpr int BLD = BT + 4;         // row stride of a 64-column backward tile
constexpr int BWD_THREADS = 256;    // 8 warps: 4 groups of 16 rows x 2 column halves
constexpr int BWD_SMALL = 9 * BT;   // gamma, beta, d dl, per-token sums [3][2]

// floats of bwd_pair's shared memory at a q_fac / k_fac row stride of KP =
// Dk8 + 4: two factor tiles, four 64-column tiles and the small arrays.
// Every row stride is 4 mod 8 words, so each fragment read below is free of
// bank conflicts but the k_state A fragment's (two-way).  At Dk 64: 104 KB,
// two blocks an SM.
__host__ __device__ inline int pair_smem_floats(int KP) {
  return 2 * BT * KP + 4 * BT * BLD + BWD_SMALL;
}

// index of the off-diagonal tile pair (query tile i > key tile j) of a chunk
__host__ __device__ inline int pair_index(int i, int j) { return i * (i - 1) / 2 + j; }

// the A fragment (m16n8k8, split into hi + lo) of X(row, k) = X[row * xr +
// k * xk] at rows g, g + 8 and k = k0 + tg, k0 + tg + 4, or with `pairs`
// k0 + 2 tg, k0 + 2 tg + 1 (the key order of mma_row's `pairs`)
__device__ __forceinline__ void frag_a(uint32_t* ah, uint32_t* al, const float* X, int xr,
                                       int xk, int k0, int g, int tg, bool pairs) {
  const int c0 = pairs ? k0 + 2 * tg : k0 + tg, c1 = pairs ? c0 + 1 : c0 + 4;
  split(X[g * xr + c0 * xk], ah[0], al[0]);
  split(X[(g + 8) * xr + c0 * xk], ah[1], al[1]);
  split(X[g * xr + c1 * xk], ah[2], al[2]);
  split(X[(g + 8) * xr + c1 * xk], ah[3], al[3]);
}

// acc[n] (n < count <= 4, the warp's 8-column blocks) += sum over k < K (a
// multiple of 8) of X(row, k) Y(k, col) for the warp's 16 rows, in 3xTF32:
// X as frag_a reads it, Y(k, col) = Y[k * yk + col * yn] as mma_row does
__device__ __forceinline__ void mma_tile(float (*acc)[4], const float* X, int xr, int xk,
                                         const float* Y, int yk, int yn, int K, int count,
                                         bool pairs, int g, int tg) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    frag_a(ah, al, X, xr, xk, k0, g, tg, pairs);
    mma_row<4>(acc, ah, al, Y, yk, yn, k0, g, tg, pairs, count);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// an accumulator's blocks n < count, at rows m0 + g (+ 8) and columns c0 + 8 n
// + 2 tg (+ 1) of a row-major [BT][ld] array: written, or added in
__device__ __forceinline__ void store_acc(float* dst, int ld, const float (&acc)[4][4], int m0,
                                          int c0, int count, int g, int tg) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    if (n < count)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (m0 + g + 8 * hf) * ld + c0 + 8 * n + 2 * tg) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
}
__device__ __forceinline__ void add_acc(float (&acc)[4][4], const float* src, int ld, int m0,
                                        int c0, int count, int g, int tg) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    if (n < count)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 q =
            *reinterpret_cast<const float2*>(src + (m0 + g + 8 * hf) * ld + c0 + 8 * n + 2 * tg);
        acc[n][2 * hf] += q.x;
        acc[n][2 * hf + 1] += q.y;
      }
}

struct BwdArgs {
  const float *r, *k, *v, *lw, *u, *state0, *dy;
  const float *qf, *kf, *cum, *decay, *starts, *after;
  float *dr, *dk, *dv, *dlw, *du, *ddl, *xs, *es, *as, *dupart, *pq, *pk, *pv;
  int BH, S, Dk, Dv, LC, W, bonus, vec;
};

// B1. The intra-chunk terms of one tile pair (query tile i >= key tile j)
// of a chunk, in three phases on 8 warps (warp = row group of 16 x column
// half h), every product on the tensor cores in 3xTF32:
//   1. A = q_fac_i k_fac_j^T (rows t, while g and v land) and dA = g_i v_j^T,
//      masked on the diagonal pair (strict for bonus), into shared memory;
//   2. dq_fac_i += dA k_fac_j (rows t) and dk_fac_j = dA^T q_fac_i (rows tau),
//      each warp on half of the Dk8 columns;
//   3. dv_j = A^T g_i (rows tau), each warp on half of a 64-column slice.
// An off-diagonal pair (OWNER false; grid BH * C * nt (nt - 1) / 2, the
// pairs of the ragged last query tile last) writes its three shares to the
// workspace.  The owner of tile m (grid BH * C * nt) runs the diagonal pair
// (m, m) and adds tile m's cross terms g S_c^T (to dq), dk_state = v G_{c+1}^T
// and k_state G_{c+1} (to dv), then the off-diagonal shares in a fixed order
// (dq: j = 0 .. m - 1; dk, dv: i = m + 1 .. nt - 1) and beta g; in tile 0 d dl
// = sum_v S_c G_{c+1}.  Once phase 3 has freed the tiles, its epilogue runs
// coalesced: dr, dk, the tile's du, and the masked exponential terms (a, e
// and d cum = a - b - e, summed over Dk per token when log w has one
// column): with one tile a chunk, straight into d log w's reverse cumsum;
// else to the workspace for bwd_decay.  No float atomics.
template <bool OWNER>
__global__ void __launch_bounds__(BWD_THREADS, 2) bwd_pair(BwdArgs p) {
  extern __shared__ __align__(16) float bsm[];
  const int S = p.S, Dk = p.Dk, Dv = p.Dv, W = p.W, bonus = p.bonus;
  const int C = S / W, nt = cdiv(W, BT), npairs = nt * (nt - 1) / 2;
  const int Dkp = pad8(Dk), KP = Dkp + 4, Dv8 = pad8(Dv), nvs = cdiv(Dv, BT);
  const int rows_c = p.BH * C, slot = blockIdx.x / rows_c, xc = blockIdx.x % rows_c;
  const int x = xc / C, c = xc % C;
  int i = slot, j = slot;
  if (!OWNER) {                     // pair `slot` = pair_index(i, j)
    i = 1;
    while (pair_index(i + 1, 0) <= slot) ++i;
    j = slot - pair_index(i, 0);
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int m0 = (warp & 3) * 16, h = warp >> 2;
  const long tok0 = (long)x * S + (long)c * W, size = (long)Dk * Dv;
  const long ti = tok0 + (long)i * BT, tj = tok0 + (long)j * BT;
  const int ni = min(BT, W - i * BT), nj = min(BT, W - j * BT);
  const int nbk = Dkp / 8, hk = (nbk + 1) / 2;
  const int kn0 = h ? hk : 0, kcnt = h ? nbk - hk : hk;    // the warp's Dk8 column blocks
  float* qs = bsm;                  // [BT][KP] q_fac of tile i
  float* ks = qs + BT * KP;         // [BT][KP] k_fac of tile j; the owner's k_state in phase 3
  float* gs = ks + BT * KP;         // [BT][BLD] g of tile i, a 64-column slice
  float* vs = gs + BT * BLD;        // [BT][BLD] v of tile j, a slice; then dA (t, tau)
  float* ss = vs + BT * BLD;        // [BT][BLD] S_c (rows d), a slice; then A (t, tau)
  float* gn = ss + BT * BLD;        // [BT][BLD] G_{c+1} (rows d), a slice
  float* gam = gn + BT * BLD;       // [BT] gamma_t = g_t . v_t
  float* beta = gam + BT;           // [BT] beta_t = r_t . u . k_t
  float* ddl_s = beta + BT;         // [BT] d dl of the chunk (tile 0)
  float* rsum = ddl_s + BT;         // [3][2][BT] d cum, e, a per token and row half
  const float* s_c = !OWNER ? nullptr
                     : c == 0   ? (p.state0 == nullptr ? nullptr : p.state0 + x * size)
                                : p.starts + (long)xc * size;
  const float* g_n = p.after + (long)xc * size;
  const bool vec = p.vec;
  const unsigned FULL = 0xffffffffu;

  load_tile(qs, KP, p.qf + ti * Dkp, Dkp, ni, Dkp, Dkp, true);
  load_tile(ks, KP, p.kf + tj * Dkp, Dkp, nj, Dkp, Dkp, true);
  cp_async_commit();
  const int tq = tid / 4, part = tid % 4;   // gamma, beta, d dl: row tq, columns part + 4 n
  if (OWNER && bonus) {             // beta of token tq, while the tiles land
    float b = 0.f;
    const long o = (tj + tq) * Dk;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int d = part + 4 * q;
      if (tq < nj && d < Dk) b += p.r[o + d] * p.u[(long)x * Dk + d] * p.k[o + d];
    }
    b += __shfl_xor_sync(FULL, b, 1);
    b += __shfl_xor_sync(FULL, b, 2);
    if (part == 0) beta[tq] = b;
  }

  // phase 1
  float acc_a[4][4], acc_da[4][4], acc_dq[4][4], acc_ks[4][4];
  zero_acc(acc_a);
  zero_acc(acc_da);
  zero_acc(acc_dq);
  zero_acc(acc_ks);
  float gam_r = 0.f, ddl_r = 0.f;
  for (int s = 0; s < nvs; ++s) {
    const int v0 = s * BT, nv = min(BT, Dv - v0), nvp = pad8(nv);
    if (s > 0) __syncthreads();     // the previous slice's readers are done
    load_tile(gs, BLD, p.dy + ti * Dv + v0, Dv, ni, nv, nvp, vec);
    load_tile(vs, BLD, p.v + tj * Dv + v0, Dv, nj, nv, nvp, vec);
    if (OWNER) {
      if (s_c != nullptr) load_tile(ss, BLD, s_c + v0, Dv, Dk, nv, nvp, vec);
      load_tile(gn, BLD, g_n + v0, Dv, Dk, nv, nvp, vec);
    }
    cp_async_commit();
    if (s == 0) {                   // A (rows t, tau blocks 4 h ..) while the slices land
      cp_async_wait<1>();
      __syncthreads();
      mma_tile(acc_a, qs + m0 * KP, KP, 1, ks + 32 * h * KP, 1, KP, Dkp, 4, false, g, tg);
    }
    cp_async_wait<0>();
    __syncthreads();
    // dA (rows t, tau blocks 4 h ..); the owner's g S_c^T (rows t) and
    // dk_state (rows tau) on the warp's Dk8 blocks
    for (int k0 = 0; k0 < nvp; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a(ah, al, gs + m0 * BLD, BLD, 1, k0, g, tg, false);
      mma_row<4>(acc_da, ah, al, vs + 32 * h * BLD, 1, BLD, k0, g, tg, false, 4);
      if (OWNER && s_c != nullptr)
        mma_row<4>(acc_dq, ah, al, ss + 8 * kn0 * BLD, 1, BLD, k0, g, tg, false, kcnt);
      if (OWNER) {
        frag_a(ah, al, vs + m0 * BLD, BLD, 1, k0, g, tg, false);
        mma_row<4>(acc_ks, ah, al, gn + 8 * kn0 * BLD, 1, BLD, k0, g, tg, false, kcnt);
      }
    }
    if (OWNER)
      for (int col = part; col < nvp; col += 4) {
        if (bonus) gam_r = fmaf(gs[tq * BLD + col], vs[tq * BLD + col], gam_r);
        if (i == 0 && s_c != nullptr) ddl_r = fmaf(ss[tq * BLD + col], gn[tq * BLD + col], ddl_r);
      }
  }
  if (OWNER) {                      // the diagonal pair's causal mask, strict for bonus
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = m0 + g + (e >= 2 ? 8 : 0), tau = 32 * h + 8 * n + 2 * tg + (e & 1);
        if (bonus ? tau >= t : tau > t) acc_a[n][e] = acc_da[n][e] = 0.f;
      }
    // gamma and d dl over a row's 4 threads (xor: the same sum in each)
    gam_r += __shfl_xor_sync(FULL, gam_r, 1);
    gam_r += __shfl_xor_sync(FULL, gam_r, 2);
    ddl_r += __shfl_xor_sync(FULL, ddl_r, 1);
    ddl_r += __shfl_xor_sync(FULL, ddl_r, 2);
    if (part == 0) {
      gam[tq] = gam_r;
      ddl_s[tq] = ddl_r;
      if (i == 0 && tq < Dk) p.ddl[(long)xc * Dk + tq] = ddl_r;
    }
  }
  __syncthreads();                  // every warp is done with the slices of v and S_c
  store_acc(ss, BLD, acc_a, m0, 32 * h, 4, g, tg);
  store_acc(vs, BLD, acc_da, m0, 32 * h, 4, g, tg);
  __syncthreads();

  // phase 2: dq (rows t) += dA k_fac_j, dk_fac (rows tau) = dA^T q_fac_i
  float acc_dk[4][4];
  zero_acc(acc_dk);
  mma_tile(acc_dq, vs + m0 * BLD, BLD, 1, ks + 8 * kn0, KP, 1, 8 * cdiv(nj, 8), kcnt, true, g,
           tg);
  mma_tile(acc_dk, vs + m0, 1, BLD, qs + 8 * kn0, KP, 1, 8 * cdiv(ni, 8), kcnt, true, g, tg);
  const long pslot = (long)xc * npairs + slot;
  if (!OWNER) {
    store_acc(p.pq + pslot * BT * Dkp, Dkp, acc_dq, m0, 8 * kn0, kcnt, g, tg);
    store_acc(p.pk + pslot * BT * Dkp, Dkp, acc_dk, m0, 8 * kn0, kcnt, g, tg);
  } else {
    for (int jj = 0; jj < i; ++jj)
      add_acc(acc_dq, p.pq + ((long)xc * npairs + pair_index(i, jj)) * BT * Dkp, Dkp, m0,
              8 * kn0, kcnt, g, tg);
    for (int ii = i + 1; ii < nt; ++ii)
      add_acc(acc_dk, p.pk + ((long)xc * npairs + pair_index(ii, i)) * BT * Dkp, Dkp, m0,
              8 * kn0, kcnt, g, tg);
  }

  // phase 3: dv (rows tau) = A^T g_i (+ the owner's k_state G_{c+1}), per
  // 64-column slice, the warp's half of it
  __syncthreads();                  // every warp is done with k_fac
  if (OWNER) {                      // k_state of tile j over k_fac, 4 loads in flight
    const float* cw = p.cum + (tok0 + W - 1) * Dkp;
    const int per = BT * Dkp / BWD_THREADS;
    for (int q0 = 0; q0 < per; q0 += 4) {
      float kv[4], cv[4], wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + (q0 + q) * BWD_THREADS, t = e / Dkp, d = e % Dkp;
        const bool ok = q0 + q < per && t < nj && d < Dk;
        kv[q] = ok ? p.k[(tj + t) * Dk + d] : 0.f;
        cv[q] = ok ? p.cum[(tj + t) * Dkp + d] : 0.f;
        wv[q] = ok ? cw[d] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = tid + (q0 + q) * BWD_THREADS, t = e / Dkp, d = e % Dkp;
        if (q0 + q < per)
          ks[t * KP + d] = t < nj && d < Dk ? kv[q] * expf(fmaxf(wv[q] - cv[q], -CLAMP)) : 0.f;
      }
    }
  }
  for (int s = 0; s < nvs; ++s) {
    const int v0 = s * BT, nv = min(BT, Dv - v0), nvp = pad8(nv);
    if (nvs > 1) {                  // restage the slice (one slice: still staged)
      if (s > 0) __syncthreads();
      load_tile(gs, BLD, p.dy + ti * Dv + v0, Dv, ni, nv, nvp, vec);
      if (OWNER) load_tile(gn, BLD, g_n + v0, Dv, Dk, nv, nvp, vec);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int vcnt = min(4, max(0, nvp / 8 - 4 * h));
    float acc_dv[4][4];
    zero_acc(acc_dv);
    mma_tile(acc_dv, ss + m0, 1, BLD, gs + 32 * h, BLD, 1, 8 * cdiv(ni, 8), vcnt, true, g, tg);
    if (!OWNER) {
      store_acc(p.pv + pslot * BT * Dv8 + v0, Dv8, acc_dv, m0, 32 * h, vcnt, g, tg);
      continue;
    }
    mma_tile(acc_dv, ks + m0 * KP, KP, 1, gn + 32 * h, BLD, 1, Dkp, vcnt, true, g, tg);
    for (int ii = i + 1; ii < nt; ++ii)
      add_acc(acc_dv, p.pv + ((long)xc * npairs + pair_index(ii, i)) * BT * Dv8 + v0, Dv8, m0,
              32 * h, vcnt, g, tg);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= vcnt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tau = m0 + g + (e >= 2 ? 8 : 0), col = 32 * h + 8 * n + 2 * tg + (e & 1);
        if (tau >= nj || col >= nv) continue;
        float val = acc_dv[n][e];
        if (bonus) val = fmaf(beta[tau], gs[tau * BLD + col], val);
        p.dv[(tj + tau) * Dv + v0 + col] = val;
      }
    }
  }
  if (!OWNER) return;

  // the owner's epilogue, through the exponentials, once every tile is free:
  // dq_fac, dk_fac and dk_state to shared memory, then a thread per (token,
  // Dk column) in rows of tpr threads (coalesced loads and stores).  One tile
  // a chunk (`fold`): the masked terms stay in shared memory and this block
  // finishes d log w; else they go to the workspace for bwd_decay
  const bool fold = nt == 1;
  float* dqs = qs;                  // [BT][KP] dq_fac
  float* dks = ks;                  // [BT][KP] dk_fac
  float* dss = gn;                  // [BT][BLD] dk_state
  float* xt = vs;                   // [BT][BLD] d cum (fold, per-Dk log w)
  float* at = ss;                   // [BT][BLD] a (fold, per-Dk log w, bonus)
  float* cdu = gs;                  // [rows a pass][BT] du per column and row slot
  float* cde = gs + 32 * BT;        // [rows a pass][BT] e per column and row slot
  __syncthreads();                  // phase 3's readers are done
  store_acc(dqs, KP, acc_dq, m0, 8 * kn0, kcnt, g, tg);
  store_acc(dks, KP, acc_dk, m0, 8 * kn0, kcnt, g, tg);
  store_acc(dss, BLD, acc_ks, m0, 8 * kn0, kcnt, g, tg);
  __syncthreads();
  const int tpr = Dkp <= 8 ? 8 : Dkp <= 16 ? 16 : Dkp <= 32 ? 32 : 64;
  const int rpp = BWD_THREADS / tpr, d = tid % tpr, r0 = tid / tpr;
  const int span = min(tpr, 32), half = tpr == 64 ? warp % 2 : 0;
  const float* cum_w = p.cum + (tok0 + W - 1) * Dkp;
  const int nrow = BT / rpp;        // rows a thread takes
  const bool dok = d < Dk;
  const float cwd = dok ? cum_w[d] : 0.f, ud = bonus && dok ? p.u[(long)x * Dk + d] : 0.f;
  float du_c = 0.f, e_c = 0.f;
  for (int j0 = 0; j0 < nrow; j0 += 4) {
    float rv[4], kv[4], cv[4], wv[4];             // 4 rows' loads in flight
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = r0 + (j0 + q) * rpp;
      const bool ok = j0 + q < nrow && t < ni && dok;
      const long tok = ti + t;
      rv[q] = ok ? p.r[tok * Dk + d] : 0.f;
      kv[q] = ok ? p.k[tok * Dk + d] : 0.f;
      cv[q] = ok ? p.cum[tok * Dkp + d] : 0.f;
      wv[q] = ok ? p.lw[tok * p.LC + (p.LC == 1 ? 0 : d)] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j0 + q >= nrow) break;
      const int t = r0 + (j0 + q) * rpp;
      float xv = 0.f, ev = 0.f, av = 0.f;
      if (t < ni && dok) {
        const long tok = ti + t;
        const float rr = rv[q], kk = kv[q], cm = cv[q], cw = cwd;
        const float qc = bonus ? cm - wv[q] : cm;
        const float eq = expf(fmaxf(qc, -CLAMP)), ek = expf(fminf(-cm, CLAMP));
        const float es = expf(fmaxf(cw - cm, -CLAMP));
        const float gq = dqs[t * KP + d], gk = dks[t * KP + d], gst = dss[t * BLD + d];
        float dr = gq * eq;
        float dk = gk * ek + gst * es;
        if (bonus) {
          const float gu = gam[t] * ud;
          dr = fmaf(gu, kk, dr);
          dk = fmaf(gu, rr, dk);
          du_c += gam[t] * rr * kk;
        }
        p.dr[tok * Dk + d] = dr;
        p.dk[tok * Dk + d] = dk;
        av = qc >= -CLAMP ? gq * (rr * eq) : 0.f;
        const float tb = cm >= -CLAMP ? gk * (kk * ek) : 0.f;
        ev = cw - cm >= -CLAMP ? gst * (kk * es) : 0.f;
        xv = av - tb - ev;
        e_c += ev;
        if (p.LC != 1 && fold) {
          xt[t * BLD + d] = xv;
          if (bonus) at[t * BLD + d] = av;
        } else if (p.LC != 1) {
          p.xs[tok * Dk + d] = xv;
          p.es[tok * Dk + d] = ev;
          if (bonus) p.as[tok * Dk + d] = av;
        }
      }
      if (p.LC == 1) {              // each token's sums over Dk: the row's lanes, then halves
#pragma unroll
        for (int o = 1; o < 32; o *= 2)
          if (o < span) {
            xv += __shfl_xor_sync(FULL, xv, o);
            ev += __shfl_xor_sync(FULL, ev, o);
            av += __shfl_xor_sync(FULL, av, o);
          }
        if (lane % span == 0) {
          rsum[(0 + half) * BT + t] = xv;
          rsum[(2 + half) * BT + t] = ev;
          rsum[(4 + half) * BT + t] = av;
          if (tpr < 64) rsum[BT + t] = rsum[3 * BT + t] = rsum[5 * BT + t] = 0.f;
        }
      }
    }
  }
  cdu[r0 * BT + d] = du_c;          // each column's sums over this thread's rows
  cde[r0 * BT + d] = e_c;
  __syncthreads();
  if (bonus && tid < Dk) {
    float sum = 0.f;
    for (int q = 0; q < rpp; ++q) sum += cdu[q * BT + tid];
    p.dupart[((long)xc * nt + i) * Dk + tid] = sum;
  }
  if (!fold && p.LC == 1 && tid < ni) {
    const long tok = ti + tid;
    p.xs[tok] = rsum[tid] + rsum[BT + tid];
    p.es[tok] = rsum[2 * BT + tid] + rsum[3 * BT + tid];
    if (bonus) p.as[tok] = rsum[4 * BT + tid] + rsum[5 * BT + tid];
  }
  if (fold && p.LC != 1 && tid < Dk) {
    // column d: d cum_last = its e summed over the tile (+ d dl dl), then the
    // reverse cumsum of d cum, token by token
    float last = 0.f;
    for (int q = 0; q < rpp; ++q) last += cde[q * BT + tid];
    if (cum_w[tid] >= -CLAMP) last = fmaf(ddl_s[tid], p.decay[(long)xc * Dkp + tid], last);
    float run = 0.f;
    for (int t = ni - 1; t >= 0; --t) {
      run += xt[t * BLD + tid];
      p.dlw[(ti + t) * Dk + tid] = bonus ? run + last - at[t * BLD + tid] : run + last;
    }
  }
  if (fold && p.LC == 1 && warp == 0) {
    // one column: lane l holds tokens 2 l, 2 l + 1; a suffix scan over the lanes
    const int t0 = 2 * lane, t1 = t0 + 1;
    auto tok_sum = [&](int q, int t) {
      return t < ni ? rsum[(2 * q) * BT + t] + rsum[(2 * q + 1) * BT + t] : 0.f;
    };
    const float x0 = tok_sum(0, t0), x1 = tok_sum(0, t1);
    float e2 = tok_sum(1, t0) + tok_sum(1, t1);
#pragma unroll
    for (int o = 1; o <= 16; o *= 2) e2 += __shfl_xor_sync(FULL, e2, o);
    float dterm = 0.f;              // sum_d d dl dl where cum_last >= -30, over the lanes
    for (int dd = lane; dd < Dk; dd += 32)
      if (cum_w[dd] >= -CLAMP) dterm += ddl_s[dd] * p.decay[(long)xc * Dkp + dd];
#pragma unroll
    for (int o = 1; o <= 16; o *= 2) dterm += __shfl_xor_sync(FULL, dterm, o);
    const float last = e2 + dterm;
    float suf = x0 + x1;            // then the sum over lanes >= this one
#pragma unroll
    for (int o = 1; o <= 16; o *= 2) {
      const float q = __shfl_down_sync(FULL, suf, o);
      if (lane + o < 32) suf += q;
    }
    float after = __shfl_down_sync(FULL, suf, 1);
    if (lane == 31) after = 0.f;
    const float s1 = x1 + after, s0 = x0 + s1;
    if (t1 < ni) p.dlw[ti + t1] = bonus ? s1 + last - tok_sum(2, t1) : s1 + last;
    if (t0 < ni) p.dlw[ti + t0] = bonus ? s0 + last - tok_sum(2, t0) : s0 + last;
  }
}

// B2. grid (BH * C, column groups), chunks of more than one tile only: d
// log w of the chunk's tokens, per log w column j: the reverse cumsum of d
// cum within the chunk, plus d cum_last (sum_t e + d dl dl where cum_last >=
// -30), minus a for bonus.  A block takes DECAY_COLS columns (one when log w
// has one); thread (j, segment) sums a run of tokens, and a suffix scan over
// the segments in shared memory (fixed steps) gives each run what follows it
constexpr int DECAY_COLS = 8;
__global__ void __launch_bounds__(BWD_THREADS) bwd_decay(BwdArgs p) {
  __shared__ float sx[BWD_THREADS], se[BWD_THREADS];
  const int S = p.S, Dk = p.Dk, W = p.W, LC = p.LC;
  const int C = S / W, Dkp = pad8(Dk), cb = min(LC, DECAY_COLS);
  const int xc = blockIdx.x, x = xc / C, c = xc % C, tid = threadIdx.x;
  const int nseg = BWD_THREADS / cb, sg = tid / cb, j = blockIdx.y * cb + tid % cb;
  const int len = cdiv(W, nseg);
  const bool on = sg < nseg && j < LC;
  const int t0 = min(W, sg * len), t1 = min(W, t0 + len);
  const long tok0 = (long)x * S + (long)c * W;
  float xsum = 0.f, esum = 0.f;
  if (on)
    for (int t = t0; t < t1; ++t) {
      xsum += p.xs[(tok0 + t) * LC + j];
      esum += p.es[(tok0 + t) * LC + j];
    }
  sx[tid] = xsum;
  se[tid] = esum;
  __syncthreads();
  for (int off = 1; off < nseg; off *= 2) {
    float ax = 0.f, ae = 0.f;
    if (on && sg + off < nseg) {
      ax = sx[tid + off * cb];
      ae = se[tid + off * cb];
    }
    __syncthreads();
    sx[tid] += ax;
    se[tid] += ae;
    __syncthreads();
  }
  // sum_d d dl dl where cum_last >= -30: column j's, or (one column) over
  // every Dk column, each warp's lanes in a fixed order
  float dterm = 0.f;
  const float* cum_w = p.cum + (tok0 + W - 1) * Dkp;
  if (LC == 1) {
    for (int d = tid % 32; d < Dk; d += 32)
      if (cum_w[d] >= -CLAMP) dterm += p.ddl[(long)xc * Dk + d] * p.decay[(long)xc * Dkp + d];
#pragma unroll
    for (int o = 1; o <= 16; o *= 2) dterm += __shfl_xor_sync(0xffffffffu, dterm, o);
  } else if (on && cum_w[j] >= -CLAMP) {
    dterm = p.ddl[(long)xc * Dk + j] * p.decay[(long)xc * Dkp + j];
  }
  if (!on) return;
  const float last = se[tid % cb] + dterm;    // segment 0's suffix: the chunk's sum of e
  float run = sg + 1 < nseg ? sx[tid + cb] : 0.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const long o = (tok0 + t) * LC + j;
    run += p.xs[o];
    p.dlw[o] = p.bonus ? run + last - p.as[o] : run + last;
  }
}

// B3. grid BH, bonus only: du of row x, the tiles' sums over its chunks
// and tiles in order
__global__ void __launch_bounds__(64) bwd_du(BwdArgs p) {
  const int n = p.S / p.W * cdiv(p.W, BT), x = blockIdx.x, d = threadIdx.x;
  if (d >= p.Dk) return;
  const float* src = p.dupart + (long)x * n * p.Dk + d;      // [chunk][tile] of row x
  float sum = 0.f;
  for (int q0 = 0; q0 < n; q0 += 8) {           // 8 loads in flight, added in order
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q0 + q < n ? src[(long)(q0 + q) * p.Dk] : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < n) sum += v[q];
  }
  p.du[(long)x * p.Dk + d] = sum;
}

// workspace of the backward, in floats (each part a multiple of 4): q_fac,
// k_fac and cum [BH, S, Dk8]; e^{cum_last} [BH, C, Dk8]; the increments and
// q_fac^T g [BH, C, n128, Dk, Dv]; S_c and G_{c+1} [BH, C, Dk, Dv]; the final
// state [BH, Dk, Dv]; d dl [BH, C, Dk]; d cum, e and a [BH, S, LC]; du per
// tile [BH, C, nt, Dk]; the off-diagonal pairs' dq and dk shares [BH, C,
// npairs, 64, Dk8] and dv shares [BH, C, npairs, 64, Dv8]
struct BwdWorkspace {
  float *qf, *kf, *cum, *decay, *part, *qgpart, *starts, *after, *fin, *ddl, *xs, *es, *as,
      *dupart, *pq, *pk, *pv;
};

long long bwd_workspace_floats(int BH, int S, int Dk, int Dv, int LC, int W, BwdWorkspace* ws,
                               float* base) {
  if (S == 0 || W < 1) return 0;
  auto r4 = [](long long n) { return (n + 3) & ~3LL; };
  const long long C = S / W, nt = cdiv(W, BT), npairs = nt * (nt - 1) / 2;
  const long long fac = r4((long long)BH * S * pad8(Dk));
  const long long inc = r4((long long)BH * C * cdiv(W, FAC_ROWS) * Dk * Dv);
  const long long states = r4((long long)BH * C * Dk * Dv), tok = r4((long long)BH * S * LC);
  const long long shares = (long long)BH * C * npairs * BT;
  const long long sizes[17] = {fac, fac, fac, r4((long long)BH * C * pad8(Dk)), inc, inc,
                               states, states, r4((long long)BH * Dk * Dv),
                               r4((long long)BH * C * Dk), tok, tok, tok,
                               r4((long long)BH * C * nt * Dk), shares * pad8(Dk),
                               shares * pad8(Dk), shares * pad8(Dv)};
  float** slots[17] = {&ws->qf, &ws->kf, &ws->cum, &ws->decay, &ws->part, &ws->qgpart,
                       &ws->starts, &ws->after, &ws->fin, &ws->ddl, &ws->xs, &ws->es, &ws->as,
                       &ws->dupart, &ws->pq, &ws->pk, &ws->pv};
  long long off = 0;
  for (int n = 0; n < 17; ++n) {
    if (base != nullptr) *slots[n] = base + off;
    off += sizes[n];
  }
  return off;
}

// the backward kernels' function attributes, set once: scan_factors' q_fac
// and g slices, bwd_pair's tiles at Dk 64 and the most shared memory an SM
// can give (two blocks)
cudaError_t bwd_attributes() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaSuccess) return done;
  const int most = (int)sizeof(float) * pair_smem_floats(MAX_KP);
  cudaError_t err = cudaFuncSetAttribute(scan_factors, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fac_smem_bytes(true));
  const void* pairs[2] = {(const void*)bwd_pair<true>, (const void*)bwd_pair<false>};
  for (const void* fn : pairs) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  done = err;
  return err;
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
    scan_factors<<<dim3(BH * C * cdiv(W, FAC_ROWS), cdiv(pad8(Dk), 16)), FAC_THREADS,
                   fac_smem_bytes(false), st>>>(rf, kf, vf, lwf, ws.qf, ws.kf, ws.decay, ws.part,
                                                nullptr, nullptr, nullptr, S, Dk, Dv, LC, W,
                                                bonus, (int)vec);
  }
  scan_states<<<dim3(BH, cdiv(Dk * Dv, STATE_THREADS)), STATE_THREADS, 0, st>>>(
      ws.decay, ws.part, s0, ws.starts, sf, nullptr, nullptr, nullptr, nullptr, S, Dk, Dv, W);
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

// Blocks of the backward's pair kernel (the owners') resident on one SM at
// head width Dk, from cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 on an
// error.
extern "C" int linear_scan_bwd_blocks_per_sm(int Dk) {
  int n = 0;
  if (bwd_attributes() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bwd_pair<true>, BWD_THREADS,
          sizeof(float) * pair_smem_floats(pad8(Dk) + 4)) != cudaSuccess)
    return -1;
  return n;
}

// The backward of linear_scan_launch: given dy [BH, S, Dv] and dstate [BH,
// Dk, Dv] (or null: zero), writes dr, dk [BH, S, Dk], dv [BH, S, Dv], dlw
// [BH, S, LC], du [BH, Dk] (bonus) and dstate0 [BH, Dk, Dv] (or null).  Any
// W that divides S (W = 1 too) runs the chunked form: scan_factors (with
// q_fac^T g), scan_states (with the reverse pass), bwd_pair over the
// off-diagonal tile pairs when a chunk has more than one 64-token tile, the
// tile owners' bwd_pair, bwd_decay.
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
  if (workspace == nullptr || !aligned16(workspace)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = bwd_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  BwdWorkspace ws{};
  bwd_workspace_floats(BH, S, Dk, Dv, LC, W, &ws, (float*)workspace);
  const float *rf = (const float*)r, *kf = (const float*)k, *vf = (const float*)v;
  const float *lwf = (const float*)lw, *s0 = (const float*)state0, *dyf = (const float*)dy;
  const bool vec = Dv % 4 == 0 && aligned16(v) && aligned16(dy) && aligned16(state0);
  const int C = S / W, nt = cdiv(W, BT), npairs = nt * (nt - 1) / 2;

  // the forward's factors and chunk-start states, recomputed, with q_fac^T g
  // per tile and the reverse state pass
  scan_factors<<<dim3(BH * C * cdiv(W, FAC_ROWS), cdiv(pad8(Dk), 16)), FAC_THREADS,
                 fac_smem_bytes(true), st>>>(rf, kf, vf, lwf, ws.qf, ws.kf, ws.decay, ws.part,
                                             ws.cum, dyf, ws.qgpart, S, Dk, Dv, LC, W, bonus,
                                             (int)vec);
  scan_states<<<dim3(BH, cdiv(Dk * Dv, STATE_THREADS)), STATE_THREADS, 0, st>>>(
      ws.decay, ws.part, s0, ws.starts, ws.fin, ws.qgpart, (const float*)dstate, ws.after,
      (float*)dstate0, S, Dk, Dv, W);
  // the intra-chunk terms, then d log w and du
  BwdArgs a{rf, kf, vf, lwf, (const float*)u, s0, dyf,
            ws.qf, ws.kf, ws.cum, ws.decay, ws.starts, ws.after,
            (float*)dr, (float*)dk, (float*)dv, (float*)dlw, (float*)du,
            ws.ddl, ws.xs, ws.es, ws.as, ws.dupart, ws.pq, ws.pk, ws.pv,
            BH, S, Dk, Dv, LC, W, bonus, (int)vec};
  const size_t smem = sizeof(float) * pair_smem_floats(pad8(Dk) + 4);
  if (nt > 1) bwd_pair<false><<<BH * C * npairs, BWD_THREADS, smem, st>>>(a);
  bwd_pair<true><<<BH * C * nt, BWD_THREADS, smem, st>>>(a);
  if (nt > 1) bwd_decay<<<dim3(BH * C, cdiv(LC, DECAY_COLS)), BWD_THREADS, 0, st>>>(a);
  if (bonus) bwd_du<<<BH, 64, 0, st>>>(a);
  return (int)cudaGetLastError();
}
