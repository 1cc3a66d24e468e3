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
// (expf, not __expf, and never the "exact" exp(cum_t - cum_tau)).
// The state starts at zero, or at an initial state state0 [BH, Dk, Dv] (the
// reference's chunked_scan takes one; its TPU kernel does not): RWKV6's
// decode step scans one token from the slot's recurrent state.
//
// What bounds it on the H100: at chunk = 64 bytes (each token's r, k, v,
// log w read and y written once; ~2 (Dk + Dv) * 64 operations per token
// for the intra product, a few operations per byte).  At chunk = S, the
// shape every prompt whose length is not a multiple of 64 takes, the
// causal W^2 / 2 intra product dominates: ~W (Dk + Dv) operations per token,
// f32 on the SIMT units (no tensor cores: the reference is f32 and Dk = 16
// is too shallow to pay for them), so operations bound it.
//
// What the design does about it: state columns are independent across Dv,
// so a block owns one row's [Dk, 16] state slice (grid (BH, Dv / 16): 100
// blocks for hymba's 25 heads at batch 1, where the TPU grid had 25 rows),
// walks its chunks in order and keeps the slice in shared memory.  A chunk
// of any length is tiled into 64-row query tiles that meet every key tile
// at or before them; each thread keeps a 4 x 4 register tile of the
// attention matrix and 4 outputs, and each key tile's cumulative decay is
// recomputed from a running carry of its chunk (one serial pass per
// column of log w from shared memory), so no [W, Dk] buffer is needed.
// The attention tile is recomputed for each Dv slice; a faster kernel would
// share it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;          // rows of a query or key tile
constexpr int DVT = 16;           // state columns a block owns
constexpr int AT = TILE + 1;      // padded attention row
constexpr float CLAMP = 30.f;

// Chunk-relative inclusive cumsum of log w over rows [0, rows) of one tile,
// continuing from carry[c] (advanced to the tile's last row).  lw points at
// the tile's first row; rows past `rows` repeat the last value.
__device__ void tile_cum(const float* __restrict__ lw, int rows, int LC, float* carry,
                         float* lwt, float* cum) {
  __syncthreads();   // earlier readers of lwt / cum are done, carry writes visible
  for (int i = threadIdx.x; i < TILE * LC; i += THREADS) lwt[i] = i / LC < rows ? lw[i] : 0.f;
  __syncthreads();
  for (int c = threadIdx.x; c < LC; c += THREADS) {
    float acc = carry[c];
    for (int t = 0; t < TILE; ++t) {
      if (t < rows) acc += lwt[t * LC + c];
      cum[t * LC + c] = acc;
    }
    carry[c] = acc;
  }
  __syncthreads();
}

// grid (BH, ceil(Dv / DVT)); one block per (row, 16 state columns).
__global__ void __launch_bounds__(THREADS) linear_scan_kernel(
    const float* __restrict__ r,    // [BH, S, Dk]
    const float* __restrict__ k,    // [BH, S, Dk]
    const float* __restrict__ v,    // [BH, S, Dv]
    const float* __restrict__ lw,   // [BH, S, LC], LC = 1 (broadcast over Dk) or Dk
    const float* __restrict__ u,    // [BH, Dk] (bonus) or null
    const float* __restrict__ state0,  // [BH, Dk, Dv] or null (zero state)
    float* __restrict__ y,          // [BH, S, Dv]
    float* __restrict__ state_out,  // [BH, Dk, Dv]
    int S, int Dk, int Dv, int LC, int W, int bonus) {
  const int x = blockIdx.x;
  const int j0 = blockIdx.y * DVT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int KD = Dk + 1;          // padded factor row
  const bool has_col = j0 + tx < Dv;

  extern __shared__ float smem[];
  float* qf = smem;                  // [TILE, KD] query factors
  float* kf = qf + TILE * KD;        // [TILE, KD] key factors / state keys
  float* att = kf + TILE * KD;       // [TILE, AT]
  float* vt = att + TILE * AT;       // [TILE, DVT]
  float* st = vt + TILE * DVT;       // [Dk, DVT] state slice
  float* lwt = st + Dk * DVT;        // [TILE, LC]
  float* cum = lwt + TILE * LC;      // [TILE, LC]
  float* carry_q = cum + TILE * LC;  // [LC]
  float* carry_k = carry_q + LC;     // [LC]
  float* rk = carry_k + LC;          // [TILE] bonus diagonal r.u.k

  const float* rg = r + (long)x * S * Dk;
  const float* kg = k + (long)x * S * Dk;
  const float* vg = v + (long)x * S * Dv;
  const float* lg = lw + (long)x * S * LC;
  float* yg = y + (long)x * S * Dv;
  const int n_tiles = (W + TILE - 1) / TILE;

  for (int i = tid; i < Dk * DVT; i += THREADS) {
    const int d = i / DVT, jj = i % DVT;
    st[i] = state0 != nullptr && j0 + jj < Dv ? state0[(long)x * Dk * Dv + (long)d * Dv + j0 + jj]
                                              : 0.f;
  }

  // loads tile rows [t0, t0 + rows) of k and v: kf gets k * exp(scale(cum))
  auto load_keys = [&](int t0, int rows, bool for_state) {
    for (int i = tid; i < TILE * Dk; i += THREADS) {
      const int t = i / Dk, d = i % Dk;
      const int c = LC == 1 ? 0 : d;
      float val = 0.f;
      if (t < rows) {
        const float e = for_state ? fmaxf(carry_q[c] - cum[t * LC + c], -CLAMP)
                                  : fminf(-cum[t * LC + c], CLAMP);
        val = kg[(long)(t0 + t) * Dk + d] * expf(e);
      }
      kf[t * KD + d] = val;
    }
    for (int i = tid; i < TILE * DVT; i += THREADS) {
      const int t = i / DVT, jj = i % DVT;
      vt[i] = (t < rows && j0 + jj < Dv) ? vg[(long)(t0 + t) * Dv + j0 + jj] : 0.f;
    }
  };

  for (int base = 0; base < S; base += W) {
    for (int i = tid; i < LC; i += THREADS) carry_q[i] = 0.f;
    for (int qi = 0; qi < n_tiles; ++qi) {
      const int q0 = base + qi * TILE;
      const int rows_q = min(TILE, W - qi * TILE);
      tile_cum(lg + (long)q0 * LC, rows_q, LC, carry_q, lwt, cum);
      for (int i = tid; i < TILE * Dk; i += THREADS) {
        const int t = i / Dk, d = i % Dk;
        const int c = LC == 1 ? 0 : d;
        float val = 0.f;
        if (t < rows_q) {
          float qc = cum[t * LC + c];
          if (bonus) qc -= lwt[t * LC + c];
          val = rg[(long)(q0 + t) * Dk + d] * expf(fmaxf(qc, -CLAMP));
        }
        qf[t * KD + d] = val;
      }
      if (bonus) {
        for (int t = tid; t < TILE; t += THREADS) {
          float s = 0.f;
          if (t < rows_q)
            for (int d = 0; d < Dk; ++d)
              s += rg[(long)(q0 + t) * Dk + d] * u[(long)x * Dk + d] * kg[(long)(q0 + t) * Dk + d];
          rk[t] = s;
        }
      }
      for (int i = tid; i < LC; i += THREADS) carry_k[i] = 0.f;
      __syncthreads();

      // cross-chunk term: q_fac . S(chunk start)
      float acc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] = 0.f;
      for (int d = 0; d < Dk; ++d) {
        const float s = st[d * DVT + tx];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] += qf[(ty + 16 * a) * KD + d] * s;
      }

      // intra-chunk term over key tiles 0..qi
      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = base + kj * TILE;
        const int rows_k = min(TILE, W - kj * TILE);
        tile_cum(lg + (long)k0 * LC, rows_k, LC, carry_k, lwt, cum);
        load_keys(k0, rows_k, false);
        __syncthreads();
        float a4[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) a4[a][b] = 0.f;
        for (int d = 0; d < Dk; ++d) {
          float qv[4], kv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) qv[a] = qf[(ty + 16 * a) * KD + d];
#pragma unroll
          for (int b = 0; b < 4; ++b) kv[b] = kf[(tx + 16 * b) * KD + d];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) a4[a][b] += qv[a] * kv[b];
        }
        const bool diag = kj == qi;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int t = ty + 16 * a, tau = tx + 16 * b;
            const bool keep = !diag || (bonus ? tau < t : tau <= t);
            att[t * AT + tau] = keep ? a4[a][b] : 0.f;
          }
        __syncthreads();
        for (int tau = 0; tau < TILE; ++tau) {
          const float vv = vt[tau * DVT + tx];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a] += att[(ty + 16 * a) * AT + tau] * vv;
        }
      }
      // vt holds the diagonal tile: the bonus term (r.u.k) v_t
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        if (bonus) acc[a] += rk[t] * vt[t * DVT + tx];
        if (t < rows_q && has_col) yg[(long)(q0 + t) * Dv + j0 + tx] = acc[a];
      }
    }

    // state update over the chunk's key tiles; carry_q now holds cum_last
    for (int i = tid; i < LC; i += THREADS) carry_k[i] = 0.f;
    float inc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kj = 0; kj < n_tiles; ++kj) {
      const int k0 = base + kj * TILE;
      const int rows_k = min(TILE, W - kj * TILE);
      tile_cum(lg + (long)k0 * LC, rows_k, LC, carry_k, lwt, cum);
      load_keys(k0, rows_k, true);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e = tid + THREADS * m;
        if (e < Dk * DVT) {
          const int d = e / DVT, jj = e % DVT;
          float s = 0.f;
          for (int tau = 0; tau < TILE; ++tau) s += kf[tau * KD + d] * vt[tau * DVT + jj];
          inc[m] += s;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = tid + THREADS * m;
      if (e < Dk * DVT) {
        const int d = e / DVT;
        st[e] = st[e] * expf(fmaxf(carry_q[LC == 1 ? 0 : d], -CLAMP)) + inc[m];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < Dk * DVT; e += THREADS) {
    const int d = e / DVT, jj = e % DVT;
    if (j0 + jj < Dv) state_out[(long)x * Dk * Dv + (long)d * Dv + j0 + jj] = st[e];
  }
}

}  // namespace

extern "C" int linear_scan_launch(const void* r, const void* k, const void* v, const void* lw,
                                  const void* u, const void* state0, void* y, void* state,
                                  int BH, int S, int Dk, int Dv, int LC, int W, int bonus,
                                  void* stream) {
  if (Dk < 1 || Dk > 64 || (LC != 1 && LC != Dk) || W < 1 || S % W) return (int)cudaErrorInvalidValue;
  const size_t floats = 2 * (size_t)TILE * (Dk + 1) + (size_t)TILE * AT + (size_t)TILE * DVT +
                        (size_t)Dk * DVT + 2 * (size_t)TILE * LC + 2 * (size_t)LC + TILE;
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      linear_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (BH == 0 || Dv == 0) return 0;
  const dim3 grid(BH, (Dv + DVT - 1) / DVT);
  linear_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)lw, (const float*)u,
      (const float*)state0, (float*)y, (float*)state, S, Dk, Dv, LC, W, bonus);
  return (int)cudaGetLastError();
}
