// GEAR decode attention over the compressed KV history: the dense layout's
// entry points.  The kernels, their design and what they replace are in
// gear_decode.cuh; the paged layout's entry is gear_decode_paged.cu (same
// bodies, built as its own library so the two compile in parallel).
#include "gear_decode.cuh"

// Dense operands [BH, S, ...] (bt is ignored).
extern "C" int gear_decode_launch(
    const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
    const void* v_packed, const void* v_scale, const void* v_zero,
    const void* k_a, const void* k_b, const void* v_a, const void* v_b,
    const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
    const void* n_comp, const void* bt, void* part_acc, void* part_m, void* part_l,
    void* tickets, void* acc, void* m, void* l,
    int BH, int H, int G, int C, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    int cps, float scale, void* stream) {
  return decode_entry<false>(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a, k_b, v_a,
                             v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx, n_comp, bt, part_acc,
                             part_m, part_l, tickets, acc, m, l, BH, H, G, C, nb, Dh, bits, gv,
                             r, ks, kv, cps, scale, stream);
}

// The streaming prefill's history scorer: every in-flight block of a layer
// in one launch.  q [BH, NB, R, Dh] f32; block b of row x sees the first
// ext[x * ext_row + b * ext_blk] tokens of the dense cache.
extern "C" int gear_history_launch(
    const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
    const void* v_packed, const void* v_scale, const void* v_zero,
    const void* k_a, const void* k_b, const void* v_a, const void* v_b,
    const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
    const void* ext, int ext_row, int ext_blk, void* acc, void* m, void* l,
    int BH, int NB, int R, int C, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    float scale, void* stream) {
  const Operands p = make_operands(k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a,
                                   k_b, v_a, v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx, nullptr,
                                   1, C, nb, Dh, bits, gv, r, ks, kv);
  return dispatch_history<false>(p, static_cast<const float*>(q),
                                 static_cast<const int32_t*>(ext), ext_row, ext_blk,
                                 static_cast<float*>(acc), static_cast<float*>(m),
                                 static_cast<float*>(l), BH, NB, R, scale,
                                 static_cast<cudaStream_t>(stream));
}
