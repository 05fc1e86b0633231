// The gated lifecycle's device code -- its constants, the argument struct
// (mirrored by ops/cuda_gated.py:_GatedArgs), the uniform layout, the path
// state and the GBM bar step -- shared by mc_gated.cu (the single, sweep and
// universe kernels), mc_gated_corr.cu (the correlated book),
// mc_gated_samplers.cu (the bootstrap, block-bootstrap and Heston kernels)
// and mc_gated_sampler_sweep.cu (the sweeps over a bar store).
// Each source is its own library, so the book's and the samplers' kernels do
// not change how the others compile (the non-inlined bar step is
// register-allocated per library).  A bar's lifecycle is mc_gated_step.cuh,
// included in the body of every bar step.
#pragma once

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 6            // n, entered, wins, losses, open, trades
#define ROW_COUNTS (N_COUNTS + HIST_BINS)
#define ROW_FLOATS 6          // sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
#define PATH_COLS 6           // equity, trades, wins, losses, open, dd
#define BLOCK 256
#define MAX_LEVELS 8
#define GATED_SUB 8           // rows of paths in one block
#define KIND_SOLID 1
#define BIG 3.4e38f           // the TPU kernel's empty sentinel
#define NEVER (-1000000000)   // last touch bar of an untouched level
#define LIFE_HIST_LO (-6.0f)
#define LIFE_BIN_SCALE 9.142857142857142f  // HIST_BINS / (8 - (-6)), float32

// The host mirror of this struct is ops/cuda_gated.py:_GatedArgs.
struct GatedArgs {
    long long num_paths;
    long long ext_offset;               // a universe row's injected uniforms
    float level_price[MAX_LEVELS];       // invalid slots zeroed
    float level_valid[MAX_LEVELS];       // 1 / 0
    int level_kind[MAX_LEVELS];          // KIND_SOLID / KIND_DASHED
    float prox, stop_pad, tp_pad;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float qmin, drift, sig_dt, log_s0;
    uint32_t seed, stream;               // Philox key
    int touch_limit, cooldown_bars, touch_gap, use_conf;
    int max_levels, num_bars, lanes, u_rows;
    int use_noise, antithetic;
};

// Uniforms of one path's block in the layout of ops/draws.GatedLayout:
// rows 4g .. 4g+3 of column col (= sublane * lanes + lane) are injected, or
// the four words of Philox with counter (col, g, block lo, block hi).
struct Draws {
    const float* ext;
    long long blk;
    int row_len, u_rows;
    uint32_t seed, stream;

    __device__ __forceinline__ float4 group(int g, int col) const {
        if (ext) {
            const long long n = row_len;
            const float* q = ext + (blk * u_rows + 4LL * g) * n + col;
            return make_float4(q[0], q[n], q[2 * n], q[3 * n]);
        }
        const uint4 w = philox4((uint32_t)col, (uint32_t)g, (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32),
                                seed, stream);
        return make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z),
                           to_uniform(w.w));
    }
};

// The draws of gbm double bar t2 of a path under ``a`` (gated_block's
// layout: groups g = t2 x (use_noise ? 4 : 2) .. of column col): the
// Box-Muller pair z0, z1 from d0's u1, u2 (the partner column's, negated, on
// a mirrored antithetic lane), bar 2 t2's u3, u4 in d0.z, d0.w and its tie
// coin in d1.x, bar 2 t2 + 1's u3, u4 and tie coin in d1.y, d1.z, d1.w, and
// the two bars' noise uniforms n0, n1 (groups g + 2, g + 3 under use_noise,
// else 0.5).  In uniform rows of the double bar: the tie coins 4 and 7, the
// noise from 8 and 12.
struct GbmDoubleBar {
    float z0, z1;
    float4 d0, d1, n0, n1;
};

__device__ __forceinline__ GbmDoubleBar gbm_double_bar(const GatedArgs& a, const Draws& dr,
                                                       int g, int col, bool mirror,
                                                       int half_lanes) {
    const float4 no_noise = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    GbmDoubleBar d;
    d.d0 = dr.group(g, col);
    d.d1 = dr.group(g + 1, col);
    float u1 = d.d0.x, u2 = d.d0.y;
    if (mirror) {
        const float4 m = dr.group(g, col - half_lanes);
        u1 = m.x; u2 = m.y;
    }
    d.n0 = a.use_noise ? dr.group(g + 2, col) : no_noise;
    d.n1 = a.use_noise ? dr.group(g + 3, col) : no_noise;
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(two_pi() * u2, &sn, &cs);
    d.z0 = rad * cs;
    d.z1 = rad * sn;
    if (mirror) { d.z0 = -d.z0; d.z1 = -d.z1; }
    return d;
}

template <int MAXL>
struct GatedState {
    float log_s, prev_c, entry, stop, target, equity, peak, dd;
    int side, cooldown, trades, wins, losses;
    int touch[MAXL], last_tb[MAXL];
};

// The bridge high and low of a bar from log_open to log_close at variance
// SIG2DT, from its uniforms u3 and u4: statements for the GATED_EXTREMES hook
// of mc_gated_step.cuh.
#define GATED_BRIDGE_EXTREMES(SIG2DT)                                                   \
    const float sig2dt = SIG2DT;                                                        \
    const float diff = log_close - log_open;                                            \
    const float d2 = diff * diff;                                                       \
    const float mid = log_open + log_close;                                             \
    const float high = expf(0.5f * (mid + sqrtf(d2 - 2.0f * sig2dt * logf(u3))));      \
    const float low = expf(0.5f * (mid - sqrtf(d2 - 2.0f * sig2dt * logf(u4))));

// One bar of one path (_one_bar, pallas_mc.py:1325-1512): generate it, manage
// the open position, then evaluate entry.  nu holds the bar's four noise
// uniforms (radius, angle, radius, angle), read only when the bar enters.
template <int MAXL>
__device__ __noinline__ void bar_step(const GatedArgs& a, GatedState<MAXL>& st,
                                      int t, float z, float u3, float u4,
                                      float tie, float4 nu) {
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;

#define GATED_EXTREMES GATED_BRIDGE_EXTREMES(a.sig_dt * a.sig_dt)
#include "mc_gated_step.cuh"
#undef GATED_EXTREMES
}
