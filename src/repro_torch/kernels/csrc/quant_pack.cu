// Fused per-column quantize + int32 bit-pack, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_pack.py::quant_pack (Pallas `_kernel`,
// one [n, d] tile per grid step), the kernel behind kernels.quantize_chunk.
// For each tile of x [N, n, d] (f32 or bf16) and each column c, over the
// tile's n rows:
//   zero[c]  = min_t x[t, c]
//   scale[c] = max((max_t x[t, c] - zero[c]) * f32(1 / (2^b - 1)), 1e-8)
//   code     = clamp(rint((x - zero) / scale), 0, 2^b - 1)   (half to even)
// and code j of a lane goes to bits [j*b, (j+1)*b) of packed[t, lane].
// Every floating step uses an explicit round-to-nearest intrinsic
// (__fsub_rn, __fmul_rn, __fdiv_rn), so nvcc cannot contract them: codes and
// stats equal the plain PyTorch version (kernels/ref.py::quant_pack_ref) bit
// for bit on finite inputs.  The scale multiplies by the f32 reciprocal, the
// form XLA compiles the reference's division into (ROADMAP section 3).
//
// What bounds it on the H100: bytes.  Each element is read (4 or 2 bytes)
// and becomes b bits of output; the arithmetic is a handful of operations
// per element.
//
// What the design does about it: one block per (tile, 32-column slab), so a
// batch of [64, 128] tiles gives 4 blocks per tile.  8 warps stride the
// slab's rows, each warp reading 32 consecutive columns of one row per load
// (coalesced), and fold their partial min/max through shared memory.  Then
// each thread builds whole int32 lanes from `per` consecutive columns of one
// row, which the block has just read (an L1/L2 hit), and writes each lane
// once; no integer code ever reaches memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 32;                  // columns of a slab
constexpr int ROWS = THREADS / COLS;      // row groups of the min/max pass

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// grid (N, ceil(d / COLS)); one block per (tile, column slab).
template <typename T>
__global__ void __launch_bounds__(THREADS) quant_pack_kernel(
    const T* __restrict__ x,          // [N, n, d]
    int32_t* __restrict__ packed,     // [N, n, d / per]
    float* __restrict__ scale,        // [N, d]
    float* __restrict__ zero,         // [N, d]
    int n, int d, int bits) {
  __shared__ float s_mn[ROWS][COLS], s_mx[ROWS][COLS], s_scale[COLS], s_zero[COLS];
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int cols = min(COLS, d - c0);
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const T* xt = x + (long)tile * n * d;

  float mn = INFINITY, mx = -INFINITY;
  if (tx < cols)
    for (int t = ty; t < n; t += ROWS) {
      const float v = load(xt + (long)t * d + c0 + tx);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  s_mn[ty][tx] = mn;
  s_mx[ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && tx < cols) {
    for (int i = 1; i < ROWS; ++i) {
      mn = fminf(mn, s_mn[i][tx]);
      mx = fmaxf(mx, s_mx[i][tx]);
    }
    const float inv = (float)(1.0 / ((1 << bits) - 1));
    const float s = fmaxf(__fmul_rn(__fsub_rn(mx, mn), inv), 1e-8f);
    s_scale[tx] = s;
    s_zero[tx] = mn;
    scale[(long)tile * d + c0 + tx] = s;
    zero[(long)tile * d + c0 + tx] = mn;
  }
  __syncthreads();

  const int per = 32 / bits;
  const int lanes = cols / per;            // lanes of this slab in one row
  const int L = d / per;                   // lanes of a whole row
  const float maxq = (float)((1 << bits) - 1);
  int32_t* pt = packed + (long)tile * n * L + c0 / per;
  for (int w = threadIdx.x; w < n * lanes; w += THREADS) {
    const int t = w / lanes, l = w % lanes;
    const T* row = xt + (long)t * d + c0 + l * per;
    uint32_t word = 0;
    for (int j = 0; j < per; ++j) {
      const int c = l * per + j;
      const float code =
          fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(load(row + j), s_zero[c]), s_scale[c])), 0.f), maxq);
      word |= (uint32_t)code << (j * bits);
    }
    pt[(long)t * L + l] = (int32_t)word;
  }
}

}  // namespace

extern "C" int quant_pack_launch(const void* x, void* packed, void* scale, void* zero, int N,
                                 int n, int d, int bits, int x_bf16, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || n < 1 || d < 1 || d % (32 / bits))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const dim3 grid(N, (d + COLS - 1) / COLS);
  if (x_bf16)
    quant_pack_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int32_t*)packed, (float*)scale, (float*)zero, n, d, bits);
  else
    quant_pack_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int32_t*)packed, (float*)scale, (float*)zero, n, d, bits);
  return (int)cudaGetLastError();
}
