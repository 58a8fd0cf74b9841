// Host data-path kernels of smilecode_tpu_torch (C++, OpenMP).
//
// Copied from smilecode_tpu/native/preproc.cpp. The reference's host data
// path is numpy with many full-volume passes: Seg_norm loops the 55-entry
// label table over the volume (55 passes, the reference's ModeT
// data/trans.py), dice_val_VOI makes 3 passes per label x 54 labels (its
// utils.py). These are single passes. Each parallel loop takes its thread
// count from the caller (`nthreads`), so that the loader's worker threads,
// which already run side by side, each use one.
//
// Exposed via extern "C" for ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Remap uint16 labels through a lookup table: out[i] = index of src[i] in
// `table` (0 if absent). Single pass with a dense 64K LUT.
void seg_remap_u16(const uint16_t* src, int64_t n, const uint16_t* table,
                   int64_t tlen, uint16_t* out, int nthreads) {
    uint16_t lut[65536];
    std::memset(lut, 0, sizeof(lut));
    for (int64_t i = 0; i < tlen; ++i) lut[table[i]] = (uint16_t)i;
#pragma omp parallel for schedule(static) num_threads(nthreads)
    for (int64_t i = 0; i < n; ++i) out[i] = lut[src[i]];
}

// Min-max normalize to [0,1] float32 (reference minmax, float64 accum).
void minmax_normalize_f32(const float* src, int64_t n, float* out, int nthreads) {
    float lo = src[0], hi = src[0];
#pragma omp parallel for reduction(min:lo) reduction(max:hi) schedule(static) num_threads(nthreads)
    for (int64_t i = 0; i < n; ++i) {
        lo = std::min(lo, src[i]);
        hi = std::max(hi, src[i]);
    }
    double scale = 1.0 / ((double)hi - (double)lo);
#pragma omp parallel for schedule(static) num_threads(nthreads)
    for (int64_t i = 0; i < n; ++i)
        out[i] = (float)(((double)src[i] - (double)lo) * scale);
}

// Stride-2 downsample (the half datasets).
void halfres_f32(const float* src, int64_t d, int64_t h, int64_t w, float* out, int nthreads) {
    int64_t dh = (d + 1) / 2, hh = (h + 1) / 2, wh = (w + 1) / 2;
#pragma omp parallel for collapse(2) schedule(static) num_threads(nthreads)
    for (int64_t i = 0; i < dh; ++i)
        for (int64_t j = 0; j < hh; ++j) {
            const float* row = src + (2 * i * h + 2 * j) * w;
            float* orow = out + (i * hh + j) * wh;
            for (int64_t k = 0; k < wh; ++k) orow[k] = row[2 * k];
        }
}

void halfres_u16(const uint16_t* src, int64_t d, int64_t h, int64_t w, uint16_t* out, int nthreads) {
    int64_t dh = (d + 1) / 2, hh = (h + 1) / 2, wh = (w + 1) / 2;
#pragma omp parallel for collapse(2) schedule(static) num_threads(nthreads)
    for (int64_t i = 0; i < dh; ++i)
        for (int64_t j = 0; j < hh; ++j) {
            const uint16_t* row = src + (2 * i * h + 2 * j) * w;
            uint16_t* orow = out + (i * hh + j) * wh;
            for (int64_t k = 0; k < wh; ++k) orow[k] = row[2 * k];
        }
}

// Per-label intersection / |pred| / |true| counts in one pass over both
// volumes; labels are ids in [0, nlabels). Caller computes Dice.
void dice_counts_u16(const uint16_t* pred, const uint16_t* truth, int64_t n,
                     int64_t nlabels, int64_t* inter, int64_t* pred_cnt,
                     int64_t* true_cnt) {
    std::fill(inter, inter + nlabels, 0);
    std::fill(pred_cnt, pred_cnt + nlabels, 0);
    std::fill(true_cnt, true_cnt + nlabels, 0);
    for (int64_t i = 0; i < n; ++i) {
        uint16_t p = pred[i], t = truth[i];
        if (p < nlabels) pred_cnt[p]++;
        if (t < nlabels) true_cnt[t]++;
        if (p == t && p < nlabels) inter[p]++;
    }
}

}  // extern "C"
