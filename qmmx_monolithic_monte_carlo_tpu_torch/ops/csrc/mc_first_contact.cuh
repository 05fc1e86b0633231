// The first-contact family's device code -- its constants, the argument
// struct (mirrored by ops/cuda_mc.py:_McArgs), the uniform draws (one a
// call, and a stream keeping its last call's words), the path state, the
// sweep's grid and state, and the contact, bridge and tie-coin steps --
// shared by mc_first_contact.cu (the single and universe kernel),
// mc_first_contact_sweep.cu (the gbm sweep) and the sampler kernels
// (mc_first_contact_samplers.cu, mc_first_contact_sampler_sweep.cu).  Each source is its own library, so the samplers'
// kernels do not change how the others compile (the non-inlined bar step is
// register-allocated per library).
#pragma once

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 5                       // n, entered, tp, stop, open
#define ROW_COUNTS (N_COUNTS + HIST_BINS)
#define ROW_FLOATS 4                     // sum_r, sum_r2, min_r, max_r
#define BLOCK 256
#define MAX_LEVELS 8
#define BIG 3.4e38f                      // the TPU kernel's empty sentinel
#define SWEEP_ROWS 16                    // grid rows a sweep launch takes

// The host mirror of this struct is ops/cuda_mc.py:_McArgs.
struct McArgs {
    long long num_paths;
    long long ext_offset;                // a universe symbol's injected uniforms
    float level_price[MAX_LEVELS];       // invalid slots zeroed
    float level_valid[MAX_LEVELS];       // 1 / 0
    float prox, stop_pad, tp_pad;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float drift, sig_dt, log_s0;
    uint32_t seed, stream;               // Philox key
    int max_levels, num_bars, lanes, n_rows;
    int use_noise, antithetic;
};

// Uniform (block, row, lane) of the layout in ops/draws.py: injected, or
// word row%4 of Philox with counter (lane, row/4, block lo, block hi).
struct Draw {
    const float* ext;
    long long blk;
    int lanes, n_rows;
    uint32_t seed, stream;

    __device__ __forceinline__ float operator()(int row, int lane) const {
        if (ext) return ext[(blk * n_rows + row) * (long long)lanes + lane];
        const uint4 w = philox4(
            (uint32_t)lane, (uint32_t)(row >> 2), (uint32_t)blk,
            (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        return to_uniform(word_of(w, row & 3));
    }
};

// One stream of a path's uniforms: the words of its last Philox call.
struct StreamDraw {
    int group;
    uint4 words;
};

// Uniform (block, row, lane) of the layout in ops/draws.py, as Draw reads it:
// injected, or word row % 4 of Philox with counter (lane, row / 4, block lo,
// block hi), drawn only when the row leaves the stream's last group.
__device__ __forceinline__ float stream_at(const McArgs& a, const float* __restrict__ ext,
                                           long long blk, int lane, int row, StreamDraw& s) {
    if (ext) return ext[(blk * a.n_rows + row) * (long long)a.lanes + lane];
    if ((row >> 2) != s.group) {
        s.group = row >> 2;
        s.words = philox4((uint32_t)lane, (uint32_t)s.group, (uint32_t)blk,
                          (uint32_t)((unsigned long long)blk >> 32), a.seed, a.stream);
    }
    return to_uniform(word_of(s.words, row & 3));
}

struct PathState {
    float acc;          // running sum of log increments
    float entry, lvl, stop, target;
    bool entered, is_long, done, target_first;
};

// The (stop, tp) rows of one sweep launch.  The host mirror of this struct is
// ops/cuda_mc.py:_SweepGrid.
struct SweepGrid {
    int n_rows;
    float stop_pad[SWEEP_ROWS], tp_pad[SWEEP_ROWS];
};

// A path against every row: the contact once, a row's state in two masks.
struct SweepState {
    float acc, entry, lvl;
    bool entered, is_long;
    unsigned done, target_first;   // bit g: row g resolved / took the target
};

// Row g's stop and target, as bar_step sets them at entry (no noise).
__device__ __forceinline__ float row_stop(const SweepState& st, float pad) {
    return (st.is_long ? st.lvl - pad : st.lvl + pad) + 0.f;
}
__device__ __forceinline__ float row_target(const SweepState& st, float pad) {
    return (st.is_long ? st.lvl + pad : st.lvl - pad) + 0.f;
}

// The first contact at a bar's close: the nearest valid level within prox.
// Sets entry (the close), lvl and the side; false when no level is near.
__device__ __forceinline__ bool contact(const McArgs& a, float log_close,
                                        float log_open, float& entry, float& lvl,
                                        bool& is_long) {
    const float close = expf(log_close);
    float best_d = BIG, best_p = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_LEVELS; ++i) {
        if (i < a.max_levels) {
            const float d = a.level_valid[i] > 0.f
                ? fabsf(close - a.level_price[i]) : BIG;
            if (d < best_d) { best_d = d; best_p = a.level_price[i]; }
        }
    }
    if (!(best_d <= a.prox)) return false;
    entry = close;
    lvl = best_p;
    is_long = close > expf(log_open);
    return true;
}

// Brownian-bridge high and low of bar k (for bars after the entry bar).
__device__ __forceinline__ void bridge(const McArgs& a, const Draw& draw, int lane,
                                       int k, float log_close, float log_open,
                                       float sig2dt, float& high, float& low) {
    const float d2 = (log_close - log_open) * (log_close - log_open);
    const float mid = log_open + log_close;
    const float two_s2 = 2.0f * sig2dt;
    high = expf(0.5f * (mid + sqrtf(
        d2 - two_s2 * logf(draw(a.num_bars + k, lane)))));
    low = expf(0.5f * (mid - sqrtf(
        d2 - two_s2 * logf(draw(2 * a.num_bars + k, lane)))));
}

// Same-bar tie: distance-weighted coin, up share for both sides.
__device__ __forceinline__ bool tie_coin(const McArgs& a, const Draw& draw, int lane,
                                         float high, float low, float entry) {
    const float up = fmaxf(0.f, high - entry);
    const float dn = fmaxf(0.f, entry - low);
    return draw(3 * a.num_bars, lane) < up / (up + dn + 1e-9f);
}
