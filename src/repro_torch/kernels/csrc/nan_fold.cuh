// NaN-propagating folds for the quantizers' column and group statistics
// (sm_80+): fminf / fmaxf drop a NaN, while jnp.min / torch.amin, and so
// the plain versions, keep it.
#pragma once

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a group's scale max((max - min) * inv, 1e-8) from its folded min and max;
// NaN stays NaN
__device__ __forceinline__ float quant_scale(float mn, float mx, float inv) {
  return max_nan(__fmul_rn(__fsub_rn(mx, mn), inv), 1e-8f);
}
