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
// (__fsub_rn, __fmul_rn, __fadd_rn, __frcp_rn, __fdiv_rn), so nvcc cannot
// contract them.  The
// scale multiplies by the f32 reciprocal, the form XLA compiles the
// reference's division into (ROADMAP section 3).
//
// Contract: codes and stats equal the plain PyTorch version
// (kernels/ref.py::quant_pack_ref) bit for bit on every input, NaN and +-inf
// included.  The column folds propagate NaN (PTX min.NaN / max.NaN, as
// jnp.min / torch.amin do; fminf would drop it), so a column holding a NaN
// gets NaN zero and scale, and the numeric guard that reads the stats sees
// it; every code of such a column is 0, as the plain version's float -> int
// conversion gives on the card.  A +-inf column keeps its infinite stats,
// and its codes (finite / inf, inf / inf) come out 0 on both sides.
// (Signed zeros: min(-0, +0) may pick either sign on either side.)
//
// What bounds it on the H100: bytes.  Each element is read once (4 or 2
// bytes) and becomes b bits of output: 448 [64, 128] tiles at 4 bits are
// 16.97 MB in f32 (5.1 us at 3.35 TB/s) and 9.63 MB in bf16 (2.9 us).  The
// arithmetic is a dozen operations per element, but it runs after the
// last load of a one-wave launch, where nothing overlaps it, so every
// instruction per element shows in the time.  The IEEE division's
// reciprocal, rint and the float -> int conversion would each run on the
// conversion pipe at a quarter of the FMA rate; the design keeps the
// per-element work on the FMA pipe and computes each column's stats once.
//
// What the design does about it (quant_pack_vec, the fast path):
// - one 128-thread block per [n, 32] column slab of a tile (4 per [64,
//   128] tile: 1,792 blocks of 4 warps for 448 tiles), in a 1-D grid whose
//   neighbouring blocks are the slabs of one tile, so a tile's rows are
//   read at about the same time (with the tile index fastest, each row
//   would be read in four passes ~448 blocks apart, which measured
//   slower).  Thread t holds the 16-byte vector t % QS of the slab row (QS
//   = 8 quads in f32, 4 octets in bf16) for the rows t / QS + i * RG (RG =
//   16 or 32) and issues all its R loads (R <= 16) before it uses any; a
//   warp load is whole 128-byte lines in f32 and half lines in bf16.  x is
//   read once: the codes come from the same registers;
// - the column fold: registers over the thread's rows, then every row
//   group's partial through shared memory, which warp 0 folds once per
//   column (two accumulators each for min and max) into the column's zero,
//   scale and reciprocal for all threads to read (two barriers, nothing
//   computed twice);
// - the code of a = x - zero is clamp(rint(a / s), 0, 2^b - 1).  The IEEE division
//   (__fdiv_rn: a reciprocal on the quarter-rate pipe and a branch per
//   element) is replaced by its value: with y = RN(1 / s) once per column,
//   q0 = RN(a y), and two FMA corrections q <- RN(q + RN(a - s q) y), the
//   second of which gives RN(a / s) exactly once q is faithful (Markstein's
//   theorem; nothing underflows where a code can be nonzero, s >= 1e-8).
//   The same float as the plain version's division, hence the same code.
//   NaN (a NaN a or s, inf / inf, and finite / inf, where y = 0) gives a
//   NaN q and code 0, as the division's 0 or NaN quotient does.  q <= (2^b
//   - 1)(1 + 2^-23), so only the lower clamp is needed (fmaxf maps NaN to
//   0), and adding 1.5 * 2^23 rounds q half to even into the low mantissa
//   bits: no conversion-pipe instruction per element;
// - packing: bits is a template constant, so a thread's 4 (f32) or 8
//   (bf16) codes of a row go into its word by constant shifts (the sum's
//   1.5 * 2^23 exponent bits are subtracted once per word), and the per /
//   vec lanes of a word OR theirs together by __shfl_xor_sync, as
//   gear_compress's packing does; bf16 at 8 bits fills two whole words
//   (one 8-byte store).  The word's first lane stores it; every warp store
//   covers whole 32-byte sectors, and the packed output is 1/8 of the
//   bytes at 4 bits in f32, so the stores are not staged for 16-byte width.
// Shapes the fast path does not take go to quant_pack_scalar (scalar
// loads, x read twice, the IEEE division per element), with the same
// NaN-propagating fold: d not a multiple of the vector width (bf16 at 8
// bits with d % 8 == 4), tiles taller than 16 rows per thread (256 rows in
// f32, 512 in bf16), or operands not aligned to 16 bytes.  The entry point
// routes by shape and alignment; nothing falls back at run time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "nan_fold.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int VEC_THREADS = 128;          // a fast-path block: one [n, 32] slab
constexpr int SLAB = 32;                  // columns of a slab
constexpr int MAX_ROWS = 16;              // rows of x a fast-path thread holds
constexpr float ROUND = 12582912.f;       // 1.5 * 2^23
constexpr uint32_t ROUND_BITS = 0x4B400000u;

// clamp(rint(q), 0, maxq) without the conversion pipe: q is clamped first
// (fmaxf maps NaN to 0, as the plain version's float -> int conversion does
// on the card; clamping and rounding commute on [0, maxq]), then q + 1.5 *
// 2^23 rounds it half to even into the low mantissa bits.
__device__ __forceinline__ uint32_t round_code(float q, float maxq) {
  const float t = __fadd_rn(fminf(fmaxf(q, 0.f), maxq), ROUND);
  return __float_as_uint(t) - ROUND_BITS;
}

// RN(a / s) from y = RN(1 / s) by two Markstein corrections (exact
// remainders by FMA): q1 is faithful, and q1 + (a - s q1) y rounds to the
// correctly rounded quotient when y is within 2^-24 of 1 / s and nothing
// underflows (Markstein's theorem).  A NaN or infinite s gives NaN.
__device__ __forceinline__ float div_rn(float a, float s, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-s, q1, a), y, q1);
}

// element k of a 16-byte vector of f32 (k < 4) or bf16 (k < 8), as f32
template <bool BF16>
__device__ __forceinline__ float elem(const uint4& r, int k) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if (!BF16) return __uint_as_float(w[k]);
  const uint32_t h = w[k >> 1];
  return __uint_as_float((k & 1) ? (h & 0xffff0000u) : (h << 16));
}

// ROUND's bits at each of the n code positions of a word, summed (mod 2^32)
__host__ __device__ constexpr uint32_t round_bits_sum(int n, int bits) {
  return n == 0 ? 0u : (ROUND_BITS << ((n - 1) * bits)) + round_bits_sum(n - 1, bits);
}

// The fast path.  grid (N * ceil(d / 32)); one 128-thread block per [n, 32]
// slab of a tile, R rows per thread (n <= R * RG).
template <bool BF16, int BITS, int R>
__global__ void __launch_bounds__(VEC_THREADS) quant_pack_vec(
    const uint4* __restrict__ x,      // [N, n, d / VEC] 16-byte vectors
    int32_t* __restrict__ packed,     // [N, n, d / PER]
    float* __restrict__ scale,        // [N, d]
    float* __restrict__ zero,         // [N, d]
    int n, int d) {
  constexpr int VEC = BF16 ? 8 : 4;               // columns of a 16-byte vector
  constexpr int QS = SLAB / VEC;                  // vectors of a slab row
  constexpr int RG = VEC_THREADS / QS;            // rows one pass of the block covers
  constexpr int PER = 32 / BITS;                  // codes per word
  constexpr int G = PER > VEC ? PER / VEC : 1;    // lanes of one word
  constexpr bool PAIR = VEC * BITS == 64;         // bf16 at 8 bits: two whole words
  constexpr int CODES = PAIR ? 4 : VEC;           // codes a thread puts in one word
  __shared__ __align__(16) float s_mn[RG][SLAB], s_mx[RG][SLAB];
  __shared__ __align__(16) float s_zero[SLAB], s_scale[SLAB], s_rcp[SLAB];
  const int slabs = (d + SLAB - 1) / SLAB;         // a tile's slabs are neighbours in the grid
  const int tile = blockIdx.x / slabs, slab = blockIdx.x % slabs, tid = threadIdx.x;
  const int q = tid % QS, ty = tid / QS;
  const int c0 = slab * SLAB + q * VEC;           // this thread's first column
  const bool col = c0 < d;                        // a partial last slab idles some lanes
  const int Q = d / VEC;
  const uint4* xt = x + (size_t)tile * n * Q + slab * QS + q;

  uint4 v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {                   // every load issued before any is used
    const int t = ty + i * RG;
    v[i] = col && t < n ? __ldg(xt + (size_t)t * Q) : make_uint4(0, 0, 0, 0);
  }

  // ---- column min / max: registers, then warp 0 over the row groups ------
  float mn[VEC], mx[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mn[k] = INFINITY;
    mx[k] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (col && ty + i * RG < n) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float e = elem<BF16>(v[i], k);
        mn[k] = min_nan(mn[k], e);
        mx[k] = max_nan(mx[k], e);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    *reinterpret_cast<float4*>(&s_mn[ty][q * VEC + k]) =
        make_float4(mn[k], mn[k + 1], mn[k + 2], mn[k + 3]);
    *reinterpret_cast<float4*>(&s_mx[ty][q * VEC + k]) =
        make_float4(mx[k], mx[k + 1], mx[k + 2], mx[k + 3]);
  }
  __syncthreads();
  if (tid < SLAB) {                               // warp 0: a column each, once
    float a0 = s_mn[0][tid], a1 = s_mn[1][tid], b0 = s_mx[0][tid], b1 = s_mx[1][tid];
#pragma unroll
    for (int p = 2; p < RG; p += 2) {
      a0 = min_nan(a0, s_mn[p][tid]);
      a1 = min_nan(a1, s_mn[p + 1][tid]);
      b0 = max_nan(b0, s_mx[p][tid]);
      b1 = max_nan(b1, s_mx[p + 1][tid]);
    }
    const float mn_c = min_nan(a0, a1);
    const float sc_c = quant_scale(mn_c, max_nan(b0, b1), (float)(1.0 / ((1 << BITS) - 1)));
    s_zero[tid] = mn_c;
    s_scale[tid] = sc_c;
    s_rcp[tid] = __frcp_rn(sc_c);
    const int c = slab * SLAB + tid;
    if (c < d) {
      scale[(size_t)tile * d + c] = sc_c;
      zero[(size_t)tile * d + c] = mn_c;
    }
  }
  __syncthreads();
  float zr[VEC], sc[VEC], rc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 z4 = *reinterpret_cast<const float4*>(&s_zero[q * VEC + k]);
    const float4 s4 = *reinterpret_cast<const float4*>(&s_scale[q * VEC + k]);
    const float4 y4 = *reinterpret_cast<const float4*>(&s_rcp[q * VEC + k]);
    zr[k] = z4.x; zr[k + 1] = z4.y; zr[k + 2] = z4.z; zr[k + 3] = z4.w;
    sc[k] = s4.x; sc[k + 1] = s4.y; sc[k + 2] = s4.z; sc[k + 3] = s4.w;
    rc[k] = y4.x; rc[k + 1] = y4.y; rc[k + 2] = y4.z; rc[k + 3] = y4.w;
  }

  // ---- codes from the registers, OR-combined across a word's lanes -------
  // A code is the low bits of t = RN(max(q, 0) + 1.5 * 2^23), q = RN(a / s):
  // q <= (2^b - 1)(1 + 2^-23) (a <= max - min, s >= RN((max - min) * inv)),
  // so t never passes ROUND + 2^b - 1 and the upper clamp is not needed.
  // The word adds each t's bits at its code's position and subtracts ROUND's
  // bits at all positions once (mod 2^32 the sum is the codes' OR).
  const int L = d / PER;                          // words per row
  const int base = (c0 % PER) * BITS;             // bit of this thread's first code
  int32_t* pt = packed + (size_t)tile * n * L;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = ty + i * RG;
    uint32_t word[VEC / CODES];
#pragma unroll
    for (int w = 0; w < VEC / CODES; ++w) {
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k < CODES; ++k) {
        const int e = w * CODES + k;
        const float qv = div_rn(__fsub_rn(elem<BF16>(v[i], e), zr[e]), sc[e], rc[e]);
        sum += __float_as_uint(__fadd_rn(fmaxf(qv, 0.f), ROUND)) << (k * BITS);
      }
      word[w] = sum - round_bits_sum(CODES, BITS);
    }
    const bool live = col && t < n;
    if constexpr (PAIR) {
      if (live) *reinterpret_cast<int2*>(pt + (size_t)t * L + c0 / PER) = make_int2((int)word[0], (int)word[1]);
    } else {
      uint32_t wd = word[0] << base;
#pragma unroll
      for (int o = 1; o < G; o <<= 1) wd |= __shfl_xor_sync(FULL, wd, o);
      if (live && q % G == 0) pt[(size_t)t * L + c0 / PER] = (int32_t)wd;
    }
  }
}

// The general path: grid (N, ceil(d / 32)); one 256-thread block per
// (tile, 32-column slab), scalar loads.  8 warps stride the slab's rows,
// fold their partial min / max through shared memory, then each thread
// builds whole int32 lanes from `per` consecutive columns of one row, read
// again (an L1 / L2 hit), with the IEEE division.
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / SLAB;      // row groups of the min/max pass

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void __launch_bounds__(THREADS) quant_pack_scalar(
    const T* __restrict__ x, int32_t* __restrict__ packed, float* __restrict__ scale,
    float* __restrict__ zero, int n, int d, int bits) {
  __shared__ float s_mn[ROWS][SLAB], s_mx[ROWS][SLAB], s_scale[SLAB], s_zero[SLAB];
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * SLAB;
  const int cols = min(SLAB, d - c0);
  const int tx = threadIdx.x % SLAB, ty = threadIdx.x / SLAB;
  const T* xt = x + (size_t)tile * n * d;

  float mn = INFINITY, mx = -INFINITY;
  if (tx < cols)
    for (int t = ty; t < n; t += ROWS) {
      const float v = load(xt + (size_t)t * d + c0 + tx);
      mn = min_nan(mn, v);
      mx = max_nan(mx, v);
    }
  s_mn[ty][tx] = mn;
  s_mx[ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && tx < cols) {
    for (int i = 1; i < ROWS; ++i) {
      mn = min_nan(mn, s_mn[i][tx]);
      mx = max_nan(mx, s_mx[i][tx]);
    }
    const float s = quant_scale(mn, mx, (float)(1.0 / ((1 << bits) - 1)));
    s_scale[tx] = s;
    s_zero[tx] = mn;
    scale[(size_t)tile * d + c0 + tx] = s;
    zero[(size_t)tile * d + c0 + tx] = mn;
  }
  __syncthreads();

  const int per = 32 / bits;
  const int lanes = cols / per;            // lanes of this slab in one row
  const int L = d / per;                   // lanes of a whole row
  const float maxq = (float)((1 << bits) - 1);
  int32_t* pt = packed + (size_t)tile * n * L + c0 / per;
  for (int w = threadIdx.x; w < n * lanes; w += THREADS) {
    const int t = w / lanes, l = w % lanes;
    const T* row = xt + (size_t)t * d + c0 + l * per;
    uint32_t word = 0;
    for (int j = 0; j < per; ++j) {
      const int c = l * per + j;
      const float qv = __fdiv_rn(__fsub_rn(load(row + j), s_zero[c]), s_scale[c]);
      word |= round_code(qv, maxq) << (j * bits);
    }
    pt[(size_t)t * L + l] = (int32_t)word;
  }
}

template <bool BF16, int BITS, int R>
int launch_vec(const void* x, void* packed, void* scale, void* zero, int N, int n, int d,
               cudaStream_t stream) {
  const long blocks = (long)N * ((d + SLAB - 1) / SLAB);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  quant_pack_vec<BF16, BITS, R><<<(unsigned)blocks, VEC_THREADS, 0, stream>>>(
      (const uint4*)x, (int32_t*)packed, (float*)scale, (float*)zero, n, d);
  return (int)cudaGetLastError();
}

template <bool BF16, int BITS>
int launch_vec_rows(int rows, const void* x, void* packed, void* scale, void* zero, int N,
                    int n, int d, cudaStream_t st) {
  if (rows <= 1) return launch_vec<BF16, BITS, 1>(x, packed, scale, zero, N, n, d, st);
  if (rows <= 2) return launch_vec<BF16, BITS, 2>(x, packed, scale, zero, N, n, d, st);
  if (rows <= 4) return launch_vec<BF16, BITS, 4>(x, packed, scale, zero, N, n, d, st);
  if (rows <= 8) return launch_vec<BF16, BITS, 8>(x, packed, scale, zero, N, n, d, st);
  return launch_vec<BF16, BITS, MAX_ROWS>(x, packed, scale, zero, N, n, d, st);
}

template <bool BF16>
int launch_vec_bits(int bits, int rows, const void* x, void* packed, void* scale, void* zero,
                    int N, int n, int d, cudaStream_t st) {
  if (bits == 2) return launch_vec_rows<BF16, 2>(rows, x, packed, scale, zero, N, n, d, st);
  if (bits == 4) return launch_vec_rows<BF16, 4>(rows, x, packed, scale, zero, N, n, d, st);
  return launch_vec_rows<BF16, 8>(rows, x, packed, scale, zero, N, n, d, st);
}

}  // namespace

extern "C" int quant_pack_launch(const void* x, void* packed, void* scale, void* zero, int N,
                                 int n, int d, int bits, int x_bf16, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || n < 1 || d < 1 || d % (32 / bits))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the fast path: 16-byte vectors of x, at most MAX_ROWS rows a thread;
  // 16-byte stat stores and bf16's 8-bit int2 word pairs
  const int vec = x_bf16 ? 8 : 4;
  const int rows = (n + VEC_THREADS * vec / SLAB - 1) / (VEC_THREADS * vec / SLAB);
  if (d % vec == 0 && rows <= MAX_ROWS && ((uintptr_t)x & 15) == 0 &&
      ((uintptr_t)scale & 15) == 0 && ((uintptr_t)zero & 15) == 0 && ((uintptr_t)packed & 7) == 0)
    return x_bf16 ? launch_vec_bits<true>(bits, rows, x, packed, scale, zero, N, n, d, st)
                  : launch_vec_bits<false>(bits, rows, x, packed, scale, zero, N, n, d, st);
  const dim3 grid(N, (d + SLAB - 1) / SLAB);
  if (x_bf16)
    quant_pack_scalar<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (int32_t*)packed, (float*)scale, (float*)zero, n, d, bits);
  else
    quant_pack_scalar<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, (int32_t*)packed, (float*)scale, (float*)zero, n, d, bits);
  return (int)cudaGetLastError();
}
