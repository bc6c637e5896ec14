// Native host-side ingest packer (the port's copy of the JAX package's
// native/packer.cpp; the two functions and their contract are the same).
//
// Scatters ragged per-symbol observations into padded (B, C, L) device
// batches, the host-side hot loop of pipeline/ingest.py. The NumPy
// fancy-indexing path does the same work with one temporary index pass per
// array; this kernel fuses the value scatter and the observation-mask
// write into one cache-friendly sweep over rows.
//
// Build: on first use by iv_interpolation_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC, into build/native/ at the repository root);
// binding: ctypes. The Python side keeps NumPy where no compiler builds it.

#include <cstdint>

extern "C" {

// colmat:   (R, C) row-major float32 — column values per observation row
// row_sym:  (R,) int32  — local symbol index within the batch
// row_pos:  (R,) int64  — grid slot (minutes from the symbol's t0)
// on_grid:  (R,) uint8  — 0 drops the row (off-grid observation)
// values:   (B, C, L) float32 output, pre-filled with NaN
// obs_mask: (B, L) uint8 output, pre-zeroed
void scatter_pack(const float* colmat, const int32_t* row_sym,
                  const int64_t* row_pos, const uint8_t* on_grid,
                  int64_t R, int64_t C, int64_t L,
                  float* values, uint8_t* obs_mask) {
    for (int64_t r = 0; r < R; ++r) {
        if (!on_grid[r]) continue;
        const int64_t b = row_sym[r];
        const int64_t p = row_pos[r];
        float* dst = values + b * C * L + p;
        const float* src = colmat + r * C;
        for (int64_t c = 0; c < C; ++c) {
            dst[c * L] = src[c];
        }
        obs_mask[b * L + p] = 1;
    }
}

// Gather valid rows back out of a filled grid: the inverse operation used
// by unpacking (device grids -> row tables). positions lists, per output
// row, (symbol index, grid slot).
void gather_unpack(const float* values, const int32_t* out_sym,
                   const int64_t* out_pos, int64_t N, int64_t C, int64_t L,
                   float* out) {
    for (int64_t r = 0; r < N; ++r) {
        const int64_t b = out_sym[r];
        const int64_t p = out_pos[r];
        const float* src = values + b * C * L + p;
        float* dst = out + r * C;
        for (int64_t c = 0; c < C; ++c) {
            dst[c] = src[c * L];
        }
    }
}

}  // extern "C"
