// The gated lifecycle's device code -- its constants, the argument struct
// (mirrored by ops/cuda_gated.py:_GatedArgs), the uniform layout, the path
// state and the bar step -- shared by mc_gated.cu (the single, sweep and
// universe kernels) and mc_gated_corr.cu (the correlated book).  Each source
// is its own library, so the book's kernel does not change how the others
// compile (the non-inlined bar step is register-allocated per library).
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

template <int MAXL>
struct GatedState {
    float log_s, prev_c, entry, stop, target, equity, peak, dd;
    int side, cooldown, trades, wins, losses;
    int touch[MAXL], last_tb[MAXL];
};

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

    // 1) position management: stop/target off the bridge high/low
    const bool was_open = st.side != 0;
    bool closed = false;
    if (was_open) {
        const float sig2dt = a.sig_dt * a.sig_dt;
        const float diff = log_close - log_open;
        const float d2 = diff * diff;
        const float mid = log_open + log_close;
        const float high = expf(0.5f * (mid + sqrtf(d2 - 2.0f * sig2dt * logf(u3))));
        const float low = expf(0.5f * (mid - sqrtf(d2 - 2.0f * sig2dt * logf(u4))));
        const bool is_long = st.side > 0;
        const bool stop_hit = is_long ? low <= st.stop : high >= st.stop;
        const bool tgt_hit = is_long ? high >= st.target : low <= st.target;
        closed = stop_hit || tgt_hit;
        if (closed) {
            bool target_first = tgt_hit;
            if (stop_hit && tgt_hit) {
                // same-bar tie: distance-weighted coin, up share for both sides
                const float up = fmaxf(0.f, high - st.entry);
                const float dn = fmaxf(0.f, st.entry - low);
                target_first = tie < up / (up + dn + 1e-9f);
            }
            const float risk = fmaxf(fabsf(st.entry - st.stop), 1e-9f);
            const float reward = fabsf(st.target - st.entry);
            st.equity = st.equity + (target_first ? reward / risk : -1.f);
            st.peak = fmaxf(st.peak, st.equity);
            st.dd = fmaxf(st.dd, st.peak - st.equity);
            if (target_first) ++st.wins; else ++st.losses;
            st.side = 0;
        }
    }

    // 2) entry at the close, for paths flat at the start of the bar
    const bool cd_ok = st.cooldown <= 0;
    st.cooldown = closed ? a.cooldown_bars : max(st.cooldown - 1, 0);
    if (!was_open && cd_ok && c != st.prev_c) {
        float best_d = BIG, best_p = 0.f;
        int best_k = 0, best_i = 0;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
            if (i < a.max_levels) {
                const float d = a.level_valid[i] > 0.f ? fabsf(c - a.level_price[i]) : BIG;
                if (d < best_d) {
                    best_d = d; best_p = a.level_price[i];
                    best_k = a.level_kind[i]; best_i = i;
                }
            }
        }
        if (best_d <= a.prox) {
            // fresh-touch latch, de-duplicated by the gap
            int tc = 0, last_t = 0;
#pragma unroll
            for (int i = 0; i < MAXL; ++i) {
                if (i == best_i) { tc = st.touch[i]; last_t = st.last_tb[i]; }
            }
            if (t - last_t >= a.touch_gap) {
                ++tc;
#pragma unroll
                for (int i = 0; i < MAXL; ++i) {
                    if (i == best_i) { st.touch[i] = tc; st.last_tb[i] = t; }
                }
            }
            // confidence (ops/confidence.compute_confidence order, float32)
            float base = fmaxf(0.f, 1.f - best_d / fmaxf(1e-4f, a.prox));
            base = base + (best_k == KIND_SOLID ? 0.08f : 0.02f);
            base = base + (tc <= 1 ? 0.10f : (tc == 2 ? -0.08f : -0.16f));
            base = base + 0.03f;           // direction always known here
            const float conf = fminf(fmaxf(base, 0.f), 1.f);
            if (tc < a.touch_limit && (!a.use_conf || conf >= a.qmin)) {
                const bool go_long = c > st.prev_c;
                st.side = go_long ? 1 : -1;
                ++st.trades;
                if (a.use_noise) {
                    // per-entry execution noise; the gates saw the true level
                    const float r1 = sqrtf(-2.0f * logf(nu.x));
                    const float r2 = sqrtf(-2.0f * logf(nu.z));
                    float s1, c1, s2, c2;
                    sincosf(two_pi() * nu.y, &s1, &c1);
                    sincosf(two_pi() * nu.w, &s2, &c2);
                    const float lvl = fmaf(r1 * c1, a.lvl_jit, best_p);
                    st.entry = fmaf(r1 * s1, a.entry_slip, c);
                    st.stop = fmaf(r2 * c2, a.stop_slip,
                                   go_long ? lvl - a.stop_pad : lvl + a.stop_pad);
                    st.target = fmaf(r2 * s2, a.tgt_slip,
                                     go_long ? lvl + a.tp_pad : lvl - a.tp_pad);
                } else {
                    st.entry = c;
                    st.stop = go_long ? best_p - a.stop_pad : best_p + a.stop_pad;
                    st.target = go_long ? best_p + a.tp_pad : best_p - a.tp_pad;
                }
            }
        }
    }
    st.prev_c = c;
}
