// Causal attention of in-flight prefill blocks, unnormalised, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill_block (Pallas
// `_block_kernel`): for each query row-group n, the T (<= 64) queries of one
// chunk attend the same chunk's keys with a causal mask and a tail mask
// (key j visible to query t iff j <= t and j < kv_len[n]), and the kernel
// returns the unnormalised triple (acc [N, T, Dh], m [N, T], l [N, T]) that
// ops.gear_attend_block merges with the compressed history's.
//
// What bounds it on the H100: bytes.  Per row-group it reads 3 x T x Dh f32
// and writes T x (Dh + 2) f32, and does 4 T^2 Dh operations: ~2.7
// operations per byte at T = 64, Dh = 128, far below the f32 SIMT roofline.
//
// What the design does about it: one block per row-group stages q, k and v
// once in shared memory (K rows padded by one word so a warp reading 32 keys
// hits 32 banks), scores and exponentiates in shared memory and writes each
// output once.  Everything runs in f32 on the SIMT units, as the reference
// does; the tile is too small for the tensor cores to pay off.  A GQA row
// group reads K/V row n / kv_repeat, so no broadcast copy exists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// grid (N); one block per query row-group.
__global__ void __launch_bounds__(THREADS) flash_block_kernel(
    const float* __restrict__ q,         // [N, T, Dh]
    const float* __restrict__ k,         // [N / kv_repeat, T, Dh]
    const float* __restrict__ v,
    const int32_t* __restrict__ kv_len,  // [N]
    float* __restrict__ acc,             // [N, T, Dh]
    float* __restrict__ m_out,           // [N, T]
    float* __restrict__ l_out,
    int T, int Dh, int kv_repeat, float scale, float softcap) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kd = Dh + 1;                 // padded K row
  const int len = kv_len[n];

  extern __shared__ float smem[];
  float* qs = smem;                      // [T, Dh]
  float* vs = qs + T * Dh;               // [T, Dh]
  float* ks = vs + T * Dh;               // [T, Dh + 1]
  float* sc = ks + T * kd;               // [T, T] scores, then probabilities

  const long qoff = (long)n * T * Dh;
  const long koff = (long)(n / kv_repeat) * T * Dh;
  for (int i = tid; i < T * Dh; i += THREADS) {
    qs[i] = q[qoff + i];
    vs[i] = v[koff + i];
    ks[(i / Dh) * kd + i % Dh] = k[koff + i];
  }
  __syncthreads();

  // ---- scores: lanes walk keys, so K's padded rows spread over the banks ---
  for (int p = tid; p < T * T; p += THREADS) {
    const int t = p / T, j = p % T;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s += qs[t * Dh + d] * ks[j * kd + d];
    s *= scale;
    if (softcap != 0.f) s = softcap * tanhf(s / softcap);
    sc[p] = (j <= t && j < len) ? s : NEG_INF;
  }
  __syncthreads();

  // ---- row statistics: one warp per query ----------------------------------
  for (int t = warp; t < T; t += WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, sc[t * T + j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(sc[t * T + j] - mx);
      sc[t * T + j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_out[(long)n * T + t] = mx;
      l_out[(long)n * T + t] = sum;
    }
  }
  __syncthreads();

  // ---- acc = P V: lanes walk channels -------------------------------------
  for (int i = tid; i < T * Dh; i += THREADS) {
    const int t = i / Dh, d = i % Dh;
    float a = 0.f;
    for (int j = 0; j < T; ++j) a += sc[t * T + j] * vs[j * Dh + d];
    acc[qoff + i] = a;
  }
}

}  // namespace

extern "C" int flash_block_launch(const void* q, const void* k, const void* v,
                                  const void* kv_len, void* acc, void* m, void* l,
                                  int N, int T, int Dh, int kv_repeat, float scale,
                                  float softcap, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)T * (3 * Dh + 1) + (size_t)T * T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  flash_block_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)kv_len,
      (float*)acc, (float*)m, (float*)l, T, Dh, kv_repeat, scale, softcap);
  return (int)cudaGetLastError();
}
