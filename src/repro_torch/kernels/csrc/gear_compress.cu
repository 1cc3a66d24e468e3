// Fused GEAR chunk compression, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gear_compress.py::gear_compress (Pallas
// `_kernel`), the compression event of the streaming prefill: for each
// [nb, d] f32 tile (one chunk of one (batch, kv-head) row) it
//   1. picks the top/bottom-k outliers of every vector (K orientation:
//      each channel over the chunk's tokens; V orientation: each token over
//      its channels) in lax.top_k order (values descending, ties to the
//      lowest index), and takes them out of the tile with set semantics
//      (a position chosen as both top and bottom is one outlier);
//   2. quantizes the remainder per group (K: g tokens per channel; V: g
//      channels per token) with scale = max((max - min) * f32(1/(2^b - 1)),
//      1e-8), codes = clamp(rint((r - min) / scale), 0, 2^b - 1);
//   3. packs the codes into int32 lanes (code j of a lane at bits j*b);
//   4. writes the f32 residual (x - deq) - S against the stats rounded to
//      the cache's storage type, which feeds the power iteration.
// Every floating step uses an explicit round-to-nearest intrinsic
// (__fsub_rn, __fmul_rn, __fdiv_rn, __fadd_rn), so nvcc cannot contract a
// multiply-add into an FMA: codes, stats and the residual follow the plain
// PyTorch version (kernels/ref.py::gear_compress_ref) bit for bit.
// NaN follows the reference's Pallas kernel: a vector that holds a NaN
// picks (NaN, vector length) for each of its outliers and takes nothing
// out, and the group folds propagate NaN (min.NaN / max.NaN), so every
// group holding one gets NaN stats, codes 0 and a NaN residual.
//
// What bounds it on the H100: bytes.  A [64, 128] tile reads 32 KB and
// writes 32 KB of residual plus ~5 KB of codes, stats and outliers (30.24 MB
// for the streaming prefill's 416-tile event, 9.0 us at 3.35 TB/s); the
// arithmetic is a few dozen operations per element.
//
// What the design does about it: one 256-thread block per tile stages it in
// shared memory by 16-byte cp.async copies (~34 KB with the stats and a
// one-bit-per-element outlier mask: six blocks per SM, so a 416-tile event
// is one wave), then
// - K orientation: a thread per channel scans its tokens once, keeping the
//   best k of each extreme in a sorted register list (insertion by selects,
//   no branch), and then its group min/max with its own outliers read as 0;
//   lanes on consecutive channels read conflict-free;
// - V orientation: eight lanes per token, four tokens per warp at a time;
//   each lane keeps its channels' best k per extreme and the eight lanes
//   pick the k winners by a 3-round shuffle tournament (the winner's lane
//   pops its list); with one group per token the same lanes take its min/max,
//   with several a warp takes each (token, group);
// - packing and residual, both orientations: lane L of a pass takes the
//   4-channel quad L of the tile's row-major quads, so its 16-byte reads of
//   the tile, the mask and the K stats are conflict-free, the four
//   independent divisions overlap, the residual goes out in 16-byte stores
//   (512 contiguous bytes per warp), and the per / 4 lanes of a packed word
//   OR their codes together by shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "nan_fold.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = 8;           // outliers per extreme a vector may keep
constexpr int MAX_TILE = 64 * 256;   // most elements of a tile
constexpr int NONE = INT_MAX;        // index of an empty list slot
constexpr unsigned FULL = 0xffffffffu;

// (value, index) pair that wins an lax.top_k comparison: the larger value,
// ties to the lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float stat_round(float s, int stat_bf16) {
  return stat_bf16 ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// x / d and x % d for x >= 0, by a shift where d is a power of two
struct Div {
  int d, shift = -1;
  __device__ explicit Div(int d_) : d(d_) {
    if ((d & (d - 1)) == 0)
      for (shift = 0; (1 << shift) < d; ++shift) {
      }
  }
  __device__ __forceinline__ int div(int x) const { return shift >= 0 ? x >> shift : x / d; }
  __device__ __forceinline__ int mod(int x) const { return shift >= 0 ? x & (d - 1) : x % d; }
};

// the best KCAP (value, index) pairs pushed so far, in lax.top_k order
template <int KCAP>
struct Best {
  float v[KCAP];
  int i[KCAP];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < KCAP; ++q) {
      v[q] = -INFINITY;
      i[q] = NONE;
    }
  }
  // sorted insertion by selects, no branch: x beats entry q only if it
  // beats every entry after q, so entry q takes entry q - 1, x or itself
  __device__ __forceinline__ void push(float x, int idx) {
    bool b[KCAP];
#pragma unroll
    for (int q = 0; q < KCAP; ++q) b[q] = beats(x, idx, v[q], i[q]);
#pragma unroll
    for (int q = KCAP - 1; q > 0; --q) {
      v[q] = b[q - 1] ? v[q - 1] : (b[q] ? x : v[q]);
      i[q] = b[q - 1] ? i[q - 1] : (b[q] ? idx : i[q]);
    }
    v[0] = b[0] ? x : v[0];
    i[0] = b[0] ? idx : i[0];
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int q = 0; q + 1 < KCAP; ++q) {
      v[q] = v[q + 1];
      i[q] = i[q + 1];
    }
    v[KCAP - 1] = -INFINITY;
    i[KCAP - 1] = NONE;
  }
  // among the first n entries
  __device__ __forceinline__ bool has(int idx, int n) const {
    bool r = false;
#pragma unroll
    for (int q = 0; q < KCAP; ++q) r |= q < n && i[q] == idx;
    return r;
  }
};

// the best head of the 8 lists of an 8-lane group (every lane gets it); the
// lane that held it pops it
template <int KCAP>
__device__ __forceinline__ int pick(Best<KCAP>& b) {
  float bv = b.v[0];
  int bi = b.i[0];
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (b.i[0] == bi) b.pop();
  return bi;
}

__device__ __forceinline__ void mark(uint32_t* flag, int bit) {
  atomicOr(&flag[bit >> 5], 1u << (bit & 31));
}

// grid (N); one block per [nb, d] tile.  PC: per-channel (K) orientation;
// KCAP >= n_out: the outlier lists' length.
template <bool PC, int KCAP>
__global__ void __launch_bounds__(THREADS) gear_compress_kernel(
    const float* __restrict__ x,        // [N, nb, d]
    int32_t* __restrict__ packed,       // [N, nb, d / per]
    float* __restrict__ scale,          // [N, nb/g, d] or [N, nb, d/g]
    float* __restrict__ zero,
    float* __restrict__ sp_val,         // [N, d, 2k] or [N, nb, 2k]; null if k == 0
    int32_t* __restrict__ sp_idx,
    float* __restrict__ resid,          // [N, nb, d]
    int nb, int d, int bits, int group, int n_out, int stat_bf16) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = nb * d;
  const int n_stat = PC ? (nb / group) * d : nb * (d / group);
  const int k2 = 2 * n_out;
  const float inv = (float)(1.0 / ((1 << bits) - 1));

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // [nb, d]
  float* s_scale = xs + tile;                         // [n_stat]
  float* s_zero = s_scale + n_stat;                   // [n_stat]
  uint32_t* flag = reinterpret_cast<uint32_t*>(s_zero + n_stat);  // bit t d + c: an outlier

  const float* xg = x + (long)n * tile;
  for (int i = tid; i < tile / 4; i += THREADS) cp_async16(xs + 4 * i, xg + 4 * i, true);
  cp_async_commit();
  for (int i = tid; i < (tile + 31) / 32; i += THREADS) flag[i] = 0;
  cp_async_wait_all();
  __syncthreads();

  // ---- 1. outliers (and, per channel, the group stats) ----------------------
  if (PC) {
    // a thread per channel: a vector of nb tokens.  A NaN never enters a
    // list, so it stays in the remainder and shows in the NaN-propagating
    // group fold; only then are the outliers written.
    for (int c = tid; c < d; c += THREADS) {
      Best<KCAP> top, bot;
      top.init();
      bot.init();
      if (n_out > 0) {
#pragma unroll 8
        for (int t = 0; t < nb; ++t) {
          const float v = xs[t * d + c];
          top.push(v, t);
          bot.push(-v, t);
        }
      }
      // the stats of group gr with this vector's outliers read as 0, or with
      // none taken out; true if they are NaN
      auto group_stats = [&](int gr, bool take_out) {
        float mn = INFINITY, mx = -INFINITY;
#pragma unroll 8
        for (int t = gr * group; t < (gr + 1) * group; ++t) {
          const bool out = take_out && (top.has(t, n_out) || bot.has(t, n_out));
          const float r = out ? 0.f : xs[t * d + c];
          mn = min_nan(mn, r);
          mx = max_nan(mx, r);
        }
        const float s = quant_scale(mn, mx, inv);
        const int si = gr * d + c;
        s_scale[si] = s;
        s_zero[si] = mn;
        scale[(long)n * n_stat + si] = s;
        zero[(long)n * n_stat + si] = mn;
        return mn != mn;
      };
      bool nan = false;
      for (int gr = 0; gr < nb / group; ++gr) nan |= group_stats(gr, n_out > 0);
      if (nan && n_out > 0)                         // a NaN vector: nothing is taken out
        for (int gr = 0; gr < nb / group; ++gr) group_stats(gr, false);
      if (n_out > 0) {
        const long o = ((long)n * d + c) * k2;
#pragma unroll
        for (int j = 0; j < KCAP; ++j) {
          if (j < n_out && nan) {                   // (NaN, nb): nothing taken out
            sp_val[o + j] = sp_val[o + n_out + j] = CUDART_NAN_F;
            sp_idx[o + j] = sp_idx[o + n_out + j] = nb;
          } else if (j < n_out) {
            const int ti = top.i[j], bi = bot.i[j];
            sp_val[o + j] = xs[ti * d + c];
            sp_idx[o + j] = ti;
            sp_val[o + n_out + j] = xs[bi * d + c];
            sp_idx[o + n_out + j] = bi;
            mark(flag, ti * d + c);
            mark(flag, bi * d + c);
          }
        }
      }
    }
  } else if (n_out > 0 || group == d) {
    // eight lanes per token (a vector of d channels), four tokens per warp;
    // with one group per token (group == d) the same lanes take its stats
    const int sub = lane >> 3, l8 = lane & 7, Q = d / 4;
    for (int t0 = 4 * warp; t0 < nb; t0 += 4 * WARPS) {
      const int t = t0 + sub;
      Best<KCAP> top, bot;
      top.init();
      bot.init();
      int nan = 0;                                     // the token holds a NaN
      if (t < nb && n_out > 0) {
        for (int qd = l8; qd < Q; qd += 8) {
          const float4 v = ld4(xs + t * d + 4 * qd);
          const int c = 4 * qd;
          nan |= (v.x != v.x) | (v.y != v.y) | (v.z != v.z) | (v.w != v.w);
          top.push(v.x, c);
          bot.push(-v.x, c);
          top.push(v.y, c + 1);
          bot.push(-v.y, c + 1);
          top.push(v.z, c + 2);
          bot.push(-v.z, c + 2);
          top.push(v.w, c + 3);
          bot.push(-v.w, c + 3);
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) nan |= __shfl_xor_sync(FULL, nan, o);
      int sel_t[KCAP], sel_b[KCAP];                    // the token's outliers (every lane)
#pragma unroll
      for (int j = 0; j < KCAP; ++j) {
        sel_t[j] = sel_b[j] = -1;
        if (j < n_out) {
          const int ti = pick(top), bi = pick(bot);   // every lane, lists in step
          const long o = ((long)n * nb + t) * k2;
          if (nan && t < nb && l8 == 0) {             // (NaN, d): nothing taken out
            sp_val[o + j] = sp_val[o + n_out + j] = CUDART_NAN_F;
            sp_idx[o + j] = sp_idx[o + n_out + j] = d;
          } else if (!nan) {
            sel_t[j] = ti;
            sel_b[j] = bi;
            if (t < nb && l8 == 0) {
              sp_val[o + j] = xs[t * d + ti];
              sp_idx[o + j] = ti;
              sp_val[o + n_out + j] = xs[t * d + bi];
              sp_idx[o + n_out + j] = bi;
              mark(flag, t * d + ti);
              mark(flag, t * d + bi);
            }
          }
        }
      }
      if (group == d) {
        float mn = INFINITY, mx = -INFINITY;
        if (t < nb) {
          for (int qd = l8; qd < Q; qd += 8) {
            const float4 v = ld4(xs + t * d + 4 * qd);
            const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bool out = false;
#pragma unroll
              for (int j = 0; j < KCAP; ++j) out |= sel_t[j] == 4 * qd + e || sel_b[j] == 4 * qd + e;
              const float r = out ? 0.f : va[e];
              mn = min_nan(mn, r);
              mx = max_nan(mx, r);
            }
          }
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
          mn = min_nan(mn, __shfl_xor_sync(FULL, mn, o));
          mx = max_nan(mx, __shfl_xor_sync(FULL, mx, o));
        }
        if (t < nb && l8 == 0) {
          const float s = quant_scale(mn, mx, inv);
          s_scale[t] = s;
          s_zero[t] = mn;
          scale[(long)n * n_stat + t] = s;
          zero[(long)n * n_stat + t] = mn;
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. per token, several groups: the group stats of the remainder, a
  // warp per (token, group)
  if (!PC && group != d) {
    const int gpr = d / group;
    for (int task = warp; task < n_stat; task += WARPS) {
      const int t = task / gpr, c0 = (task % gpr) * group;
      float mn = INFINITY, mx = -INFINITY;
      for (int c = c0 + lane; c < c0 + group; c += 32) {
        const int b = t * d + c;
        const float r = (flag[b >> 5] >> (b & 31)) & 1u ? 0.f : xs[b];
        mn = min_nan(mn, r);
        mx = max_nan(mx, r);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mn = min_nan(mn, __shfl_xor_sync(FULL, mn, o));
        mx = max_nan(mx, __shfl_xor_sync(FULL, mx, o));
      }
      if (lane == 0) {
        const float s = quant_scale(mn, mx, inv);
        s_scale[task] = s;
        s_zero[task] = mn;
        scale[(long)n * n_stat + task] = s;
        zero[(long)n * n_stat + task] = mn;
      }
    }
    __syncthreads();
  }

  // ---- 3-4. codes, packing, residual: a thread per 4-channel quad ----------
  const int per = 32 / bits, qpw = per / 4;           // quads per packed word
  const int nq = nb * (d / 4), gpr = d / group;
  const Div quads(d / 4), groups(group), words(qpw);
  const float maxq = (float)((1 << bits) - 1);
  const bool quad_group = (group & 3) == 0;           // per token: a quad in one group
  for (int e0 = 0; e0 < nq; e0 += THREADS) {
    const int e = e0 + tid;
    uint32_t word = 0;
    if (e < nq) {
      const int t = quads.div(e), c = 4 * quads.mod(e);
      const float4 xv = ld4(xs + 4 * e);
      const uint32_t fl = flag[e >> 3] >> (4 * (e & 7));
      float sc[4], zr[4];
      if (PC) {
        const int row = groups.div(t) * d + c;
        const float4 s4 = ld4(s_scale + row), z4 = ld4(s_zero + row);
        sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
        zr[0] = z4.x; zr[1] = z4.y; zr[2] = z4.z; zr[3] = z4.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int si = t * gpr + groups.div(quad_group ? c : c + k);
          sc[k] = s_scale[si];
          zr[k] = s_zero[si];
        }
      }
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      float ra[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool out = (fl >> k) & 1u;
        const float r = out ? 0.f : xa[k];
        const float code =
            fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(r, zr[k]), sc[k])), 0.f), maxq);
        word |= (uint32_t)code << ((4 * words.mod(e) + k) * bits);
        const float deq = __fadd_rn(__fmul_rn(code, stat_round(sc[k], stat_bf16)),
                                    stat_round(zr[k], stat_bf16));
        ra[k] = __fsub_rn(__fsub_rn(xa[k], deq), out ? xa[k] : 0.f);
      }
      *reinterpret_cast<float4*>(resid + (long)n * tile + 4 * e) =
          make_float4(ra[0], ra[1], ra[2], ra[3]);
    }
    for (int o = 1; o < qpw; o <<= 1) word |= __shfl_xor_sync(FULL, word, o);
    if (e < nq && words.mod(e) == 0) packed[(long)n * (tile / per) + words.div(e)] = (int32_t)word;
  }
}

template <bool PC, int KCAP>
int launch(const float* x, int32_t* packed, float* scale, float* zero, float* sp_val,
           int32_t* sp_idx, float* resid, int N, int nb, int d, int bits, int group,
           int n_out, int stat_bf16, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 0;          // the attribute is the function's; raise it as needed
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gear_compress_kernel<PC, KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  gear_compress_kernel<PC, KCAP><<<N, THREADS, smem, stream>>>(
      x, packed, scale, zero, sp_val, sp_idx, resid, nb, d, bits, group, n_out, stat_bf16);
  return (int)cudaGetLastError();
}

template <bool PC>
int launch_k(const float* x, int32_t* packed, float* scale, float* zero, float* sp_val,
             int32_t* sp_idx, float* resid, int N, int nb, int d, int bits, int group,
             int n_out, int stat_bf16, size_t smem, cudaStream_t st) {
  if (n_out <= 1)
    return launch<PC, 1>(x, packed, scale, zero, sp_val, sp_idx, resid, N, nb, d, bits, group,
                         n_out, stat_bf16, smem, st);
  if (n_out <= 2)
    return launch<PC, 2>(x, packed, scale, zero, sp_val, sp_idx, resid, N, nb, d, bits, group,
                         n_out, stat_bf16, smem, st);
  if (n_out <= 4)
    return launch<PC, 4>(x, packed, scale, zero, sp_val, sp_idx, resid, N, nb, d, bits, group,
                         n_out, stat_bf16, smem, st);
  return launch<PC, MAX_OUT>(x, packed, scale, zero, sp_val, sp_idx, resid, N, nb, d, bits,
                             group, n_out, stat_bf16, smem, st);
}

}  // namespace

extern "C" int gear_compress_launch(
    const void* x, void* packed, void* scale, void* zero, void* sp_val, void* sp_idx,
    void* resid, int N, int nb, int d, int bits, int group, int per_channel, int n_out,
    int stat_bf16, void* stream) {
  const int vec = per_channel ? nb : d;
  if ((bits != 2 && bits != 4 && bits != 8) || nb < 1 || d % (32 / bits) || group < 1 ||
      vec % group || n_out < 0 || n_out > MAX_OUT || 2 * n_out > vec || nb * d > MAX_TILE)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int n_stat = per_channel ? (nb / group) * d : nb * (d / group);
  const size_t smem = sizeof(float) * ((size_t)nb * d + 2 * (size_t)n_stat) +
                      sizeof(uint32_t) * (((size_t)nb * d + 31) / 32);
  const float* xf = (const float*)x;
  int32_t *pk = (int32_t*)packed, *si = (int32_t*)sp_idx;
  float *sc = (float*)scale, *zr = (float*)zero, *sv = (float*)sp_val, *rs = (float*)resid;
  cudaStream_t st = (cudaStream_t)stream;
  return per_channel
             ? launch_k<true>(xf, pk, sc, zr, sv, si, rs, N, nb, d, bits, group, n_out,
                              stat_bf16, smem, st)
             : launch_k<false>(xf, pk, sc, zr, sv, si, rs, N, nb, d, bits, group, n_out,
                               stat_bf16, smem, st);
}
