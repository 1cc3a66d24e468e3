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
//
// What bounds it on the H100: bytes.  A tile reads 32 KB and writes 32 KB of
// residual plus ~5 KB of codes, stats and outliers; the arithmetic is a few
// dozen operations per element.
//
// What the design does about it: one block per tile stages it in shared
// memory once (float4 loads), so the outlier sweeps, the group min/max and
// the packing all read shared memory; each output is written once, in
// contiguous runs.  The whole event for one layer (all batch rows, heads and
// chunks, for K or for V) is one launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = 8;           // outliers per extreme a vector may keep

// (value, index) pair that wins an lax.top_k comparison: the larger value,
// ties to the lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ bool chosen(int t, const int* sel, int j) {
  for (int q = 0; q < j; ++q)
    if (sel[q] == t) return true;
  return false;
}

__device__ __forceinline__ float stat_round(float s, int stat_bf16) {
  return stat_bf16 ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

// grid (N); one block per [nb, d] tile.
__global__ void __launch_bounds__(THREADS) gear_compress_kernel(
    const float* __restrict__ x,        // [N, nb, d]
    int32_t* __restrict__ packed,       // [N, nb, d / per]
    float* __restrict__ scale,          // [N, nb/g, d] or [N, nb, d/g]
    float* __restrict__ zero,
    float* __restrict__ sp_val,         // [N, d, 2k] or [N, nb, 2k]; null if k == 0
    int32_t* __restrict__ sp_idx,
    float* __restrict__ resid,          // [N, nb, d]
    int nb, int d, int bits, int group, int per_channel, int n_out, int stat_bf16) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tile = nb * d;
  const int n_stat = per_channel ? (nb / group) * d : nb * (d / group);

  extern __shared__ float smem[];
  float* xs = smem;                                   // [nb, d]
  float* s_scale = xs + tile;                         // [n_stat]
  float* s_zero = s_scale + n_stat;                   // [n_stat]
  unsigned char* flag = (unsigned char*)(s_zero + n_stat);  // [nb, d] outlier flags

  const float* xg = x + (long)n * tile;
  for (int i = tid; i < tile / 4; i += THREADS)
    reinterpret_cast<float4*>(xs)[i] = reinterpret_cast<const float4*>(xg)[i];
  for (int i = tid; i < tile; i += THREADS) flag[i] = 0;
  __syncthreads();

  // ---- 1. outliers ---------------------------------------------------------
  if (n_out > 0) {
    const int k2 = 2 * n_out;
    if (per_channel) {
      // one thread per (channel, extreme): a vector of nb tokens
      for (int task = tid; task < 2 * d; task += THREADS) {
        const int ch = task % d, bottom = task / d;
        const float sgn = bottom ? -1.f : 1.f;
        int sel[MAX_OUT];
        for (int j = 0; j < n_out; ++j) {
          float bv = -INFINITY;
          int bi = nb;
          for (int t = 0; t < nb; ++t) {
            if (chosen(t, sel, j)) continue;
            const float v = sgn * xs[t * d + ch];
            if (beats(v, t, bv, bi)) { bv = v; bi = t; }
          }
          bi = bi < nb ? bi : 0;                     // only an all-NaN vector picks none
          sel[j] = bi;
          const long o = ((long)n * d + ch) * k2 + bottom * n_out + j;
          sp_val[o] = xs[bi * d + ch];
          sp_idx[o] = bi;
          flag[bi * d + ch] = 1;
        }
      }
    } else {
      // one warp per (token, extreme): a vector of d channels
      for (int task = warp; task < 2 * nb; task += WARPS) {
        const int tok = task % nb, bottom = task / nb;
        const float sgn = bottom ? -1.f : 1.f;
        int sel[MAX_OUT];
        for (int j = 0; j < n_out; ++j) {
          float bv = -INFINITY;
          int bi = d;
          for (int c = lane; c < d; c += 32) {
            if (chosen(c, sel, j)) continue;
            const float v = sgn * xs[tok * d + c];
            if (beats(v, c, bv, bi)) { bv = v; bi = c; }
          }
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
          }
          bi = bi < d ? bi : 0;                      // only an all-NaN vector picks none
          sel[j] = bi;
          if (lane == 0) {
            const long o = ((long)n * nb + tok) * k2 + bottom * n_out + j;
            sp_val[o] = xs[tok * d + bi];
            sp_idx[o] = bi;
            flag[tok * d + bi] = 1;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- 2. group stats of the remainder (outliers read as 0) -----------------
  const float maxq = (float)((1 << bits) - 1);
  const float inv = (float)(1.0 / ((1 << bits) - 1));
  if (per_channel) {
    for (int task = tid; task < n_stat; task += THREADS) {
      const int row = task / d, ch = task % d;
      float mn = INFINITY, mx = -INFINITY;
      for (int t = row * group; t < (row + 1) * group; ++t) {
        const float r = flag[t * d + ch] ? 0.f : xs[t * d + ch];
        mn = fminf(mn, r);
        mx = fmaxf(mx, r);
      }
      const float s = fmaxf(__fmul_rn(__fsub_rn(mx, mn), inv), 1e-8f);
      s_scale[task] = s;
      s_zero[task] = mn;
      scale[(long)n * n_stat + task] = s;
      zero[(long)n * n_stat + task] = mn;
    }
  } else {
    const int gpr = d / group;                       // groups per token
    for (int task = warp; task < n_stat; task += WARPS) {
      const int tok = task / gpr, c0 = (task % gpr) * group;
      float mn = INFINITY, mx = -INFINITY;
      for (int c = c0 + lane; c < c0 + group; c += 32) {
        const float r = flag[tok * d + c] ? 0.f : xs[tok * d + c];
        mn = fminf(mn, r);
        mx = fmaxf(mx, r);
      }
      for (int o = 16; o > 0; o >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if (lane == 0) {
        const float s = fmaxf(__fmul_rn(__fsub_rn(mx, mn), inv), 1e-8f);
        s_scale[task] = s;
        s_zero[task] = mn;
        scale[(long)n * n_stat + task] = s;
        zero[(long)n * n_stat + task] = mn;
      }
    }
  }
  __syncthreads();

  // ---- 3-4. codes, packing, residual: one thread per packed lane ------------
  const int per = 32 / bits;
  const int L = d / per;
  for (int w = tid; w < nb * L; w += THREADS) {
    const int t = w / L, c0 = (w % L) * per;
    uint32_t word = 0;
    for (int j = 0; j < per; ++j) {
      const int c = c0 + j;
      const float xv = xs[t * d + c];
      const bool out = flag[t * d + c] != 0;
      const float r = out ? 0.f : xv;
      const int si = per_channel ? (t / group) * d + c : t * (d / group) + c / group;
      const float s = s_scale[si], z = s_zero[si];
      const float code = fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(r, z), s)), 0.f), maxq);
      word |= (uint32_t)code << (j * bits);
      const float deq = __fadd_rn(__fmul_rn(code, stat_round(s, stat_bf16)),
                                  stat_round(z, stat_bf16));
      resid[(long)n * tile + t * d + c] = __fsub_rn(__fsub_rn(xv, deq), out ? xv : 0.f);
    }
    packed[(long)n * nb * L + w] = (int32_t)word;
  }
}

}  // namespace

extern "C" int gear_compress_launch(
    const void* x, void* packed, void* scale, void* zero, void* sp_val, void* sp_idx,
    void* resid, int N, int nb, int d, int bits, int group, int per_channel, int n_out,
    int stat_bf16, void* stream) {
  const int n_stat = per_channel ? (nb / group) * d : nb * (d / group);
  const size_t smem = sizeof(float) * ((size_t)nb * d + 2 * (size_t)n_stat) + (size_t)nb * d;
  cudaError_t err = cudaFuncSetAttribute(
      gear_compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  gear_compress_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (int32_t*)packed, (float*)scale, (float*)zero, (float*)sp_val,
      (int32_t*)sp_idx, (float*)resid, nb, d, bits, group, per_channel, n_out, stat_bf16);
  return (int)cudaGetLastError();
}
