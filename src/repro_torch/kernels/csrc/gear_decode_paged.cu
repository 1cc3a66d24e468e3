// GEAR decode attention over the compressed KV history: the paged layout's
// entry point (replaces src/repro/kernels/gear_decode.py::gear_decode_paged).
// The bodies are gear_decode.cuh's, shared with the dense layout, so a paged
// triple equals the dense one on gathered operands bit for bit.
#include "gear_decode.cuh"

// Pool operands [P*H, one chunk's rows, ...] and block tables bt [B, C].
extern "C" int gear_decode_paged_launch(
    const void* q, const void* k_packed, const void* k_scale, const void* k_zero,
    const void* v_packed, const void* v_scale, const void* v_zero,
    const void* k_a, const void* k_b, const void* v_a, const void* v_b,
    const void* k_sp_val, const void* k_sp_idx, const void* v_sp_val, const void* v_sp_idx,
    const void* n_comp, const void* bt, void* part_acc, void* part_m, void* part_l,
    void* tickets, void* acc, void* m, void* l,
    int BH, int H, int G, int C, int nb, int Dh, int bits, int gv, int r, int ks, int kv,
    int cps, float scale, void* stream) {
  return decode_entry<true>(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, k_a, k_b, v_a,
                             v_b, k_sp_val, k_sp_idx, v_sp_val, v_sp_idx, n_comp, bt, part_acc,
                             part_m, part_l, tickets, acc, m, l, BH, H, G, C, nb, Dh, bits, gv,
                             r, ks, kv, cps, scale, stream);
}
