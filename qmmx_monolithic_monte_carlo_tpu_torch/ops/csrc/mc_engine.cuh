// The full engine's device code -- its constants, the argument struct
// (mirrored by ops/cuda_engine.py:_EngineArgs), the uniform layout, the
// rings, the path state, the gates and the bar step -- shared by
// mc_engine.cu (the single, sweep and universe kernels) and
// mc_engine_corr.cu (the correlated book).  Each source is its own library,
// so the book's kernel does not change how the others compile (the
// non-inlined bar step is register-allocated per library).
#pragma once

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 7            // n, entered, wins, losses, open, trades, escalations
#define N_SKIPS 16
#define ROW_COUNTS (N_COUNTS + N_SKIPS + HIST_BINS)
#define ROW_FLOATS 6          // sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
#define PATH_COLS (7 + N_SKIPS)  // equity, trades, wins, losses, open, dd, escalations, skips
#define BLOCK 256
#define MAX_LEVELS 8
#define ENGINE_SUB 8          // rows of paths in one block
#define VOL_RING 20
#define CLOSE_RING 5
#define TAP_SLOTS 3           // == fatigue_hits
#define LOOKBACK 5            // the escalation walk's window (VOL_LOOKBACK)
#define KIND_SOLID 1
#define BIG 3.4e38f
#define TAP_NEVER (-(1 << 30))
#define LIFE_HIST_LO (-6.0f)
#define LIFE_BIN_SCALE 9.142857142857142f  // HIST_BINS / (8 - (-6)), float32
#define PROX_WINDOW 0.35f     // ExitStrategy's proximity window
#define INF_F __int_as_float(0x7f800000)

// skip-table columns (sim/enginepath.SKIP_REASONS order)
enum { SK_IN_POSITION, SK_COOLDOWN, SK_NOLEVELS, SK_DIR_UNKNOWN, SK_TOO_FAR,
       SK_OVERTOUCHED, SK_EDGE_FATIGUE, SK_TOUCH_BUDGET, SK_TOUCH_COOLDOWN,
       SK_CONF_LOW, SK_ACC_BREAKOUT, SK_CONTRA_LONG, SK_CONTRA_SHORT,
       SK_COMBINED_LOW, SK_ML_CONF_LOW, SK_ONLINE_POLICY };

// The host mirror of this struct is ops/cuda_engine.py:_EngineArgs.
struct EngineArgs {
    long long num_paths;
    long long ext_offset;               // a universe row's injected uniforms
    float level_price[MAX_LEVELS];      // invalid slots zeroed
    float level_round[MAX_LEVELS];      // rounded to cents (touch memory)
    int level_valid[MAX_LEVELS];
    int level_kind[MAX_LEVELS];         // KIND_SOLID / KIND_DASHED
    float prox, prox_conf, stop_pad, tp_pad, qmin;
    float veto_strong, veto_near, confl_within, w_rules, w_ml;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float ml_coef[4], ml_intercept;
    float pol_w[3][7];
    float tm_tol_bps, tm_min_px_bps, tm_decay, tm_fat_vol_k;
    float g_comp, g_vol_k;
    float drift, sig_dt, two_s2, log_s0;
    float vm_base, vm_uamp, vm_sigma, vm_rc, vm_day, vm_open, vm_den, vm_third;
    float vm_half_s2, vm_mean_abs, vm_sd_abs, vm_floor;
    uint32_t seed, stream;              // Philox key
    int cooldown_ms, overtouch_limit, enable_veto, use_blend, ml_usable, ml_ran;
    int policy_on, bar0_minute, has_levels;
    int tm_min_gap_ms, tm_max_bounces, tm_fat_win_ms;
    int g_min_bars, g_clear_bars;
    int max_levels, num_bars, lanes, u_rows, stride;
    int use_noise, antithetic, escalation;
};

// Uniforms of one path in the layout of ops/draws.EngineLayout: row r of
// column col (= sublane * lanes + lane) is injected, or word r % 4 of Philox
// with counter (col, r / 4, block lo, block hi).  The last call's words are
// kept, so rows drawn in increasing order cost one call per four rows.
struct Draws {
    const float* ext;
    long long blk;
    int col, row_len, u_rows;
    uint32_t seed, stream;
    int group;
    uint4 words;

    __device__ float at(int row) {
        if (ext) return ext[(blk * u_rows + row) * (long long)row_len + col];
        if ((row >> 2) != group) {
            group = row >> 2;
            words = philox4((uint32_t)col, (uint32_t)group, (uint32_t)blk,
                            (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        }
        return to_uniform(word_of(words, row & 3));
    }

    // rows (row, row + 1) of another column: the antithetic partner's pair
    __device__ float2 pair_of(int other_col, int row) const {
        if (ext) {
            const float* q = ext + (blk * u_rows + row) * (long long)row_len + other_col;
            return make_float2(q[0], q[row_len]);
        }
        const uint4 w = philox4((uint32_t)other_col, (uint32_t)(row >> 2), (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        return make_float2(to_uniform(word_of(w, row & 3)),
                           to_uniform(word_of(w, (row + 1) & 3)));
    }
};

template <int MAXL>
struct EngineState {
    float log_s, prev_c, entry, stop, target, risk0, equity, peak, dd;
    float run_low, run_high, box_low, box_high;
    int side, cooldown_until, last_dir, trades, wins, losses, escal;
    int box_valid, regime, inside_cnt;
    int c_counts[MAXL];
    unsigned c_latch;                   // bit i: level i latched
    int tm_cnt[2 * MAXL], tm_ts[2 * MAXL];
    float tm_px[2 * MAXL];
    unsigned tm_has;                    // bit 2i + side: has a last touch
    int tap_ts[2 * TAP_SLOTS];          // [edge * 3 + k], newest first
    float tap_ratio[2 * TAP_SLOTS];
    int skips[N_SKIPS];
};

// The shared-memory rings of this thread: slot s of ring R at base[s * BLOCK].
struct Rings {
    float* vol;    // VOL_RING slots
    float* close;  // CLOSE_RING slots
    __device__ float v(int bar) const { return vol[(bar % VOL_RING) * BLOCK]; }
    __device__ float c(int bar) const { return close[(bar % CLOSE_RING) * BLOCK]; }
};

#define FIRST_FAIL(cond, col) \
    if (ok && (cond)) { ok = false; ++st.skips[col]; }

// One bar of one path (sim/enginepath.EngineLifecycle.step on the bar
// generated as pallas_engine.py _one_bar generates it).  z / zv are the
// bar's price and volume normals; u3, u4 the bridge uniforms; noise_row the
// first of its four noise rows, drawn only if it enters.
template <int MAXL>
__device__ __noinline__ void bar_step(const EngineArgs& a, EngineState<MAXL>& st,
                                      Draws& dr, const Rings& rg, int t, float z,
                                      float zv, float u3, float u4, float tie,
                                      int noise_row) {
    // ---- the bar: GBM close, bridge extremes, the volume model
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;
    const float diff = log_close - log_open;
    const float d2 = diff * diff;
    const float mid = log_open + log_close;
    const float h = expf(0.5f * (mid + sqrtf(d2 - a.two_s2 * logf(u3))));
    const float l = expf(0.5f * (mid - sqrtf(d2 - a.two_s2 * logf(u4))));
    const float m_min = fmodf(a.vm_open + (float)t, a.vm_day);
    const float xu = 2.0f * m_min / a.vm_den - 1.0f;
    const float ushape = 1.0f + a.vm_uamp * (xu * xu - a.vm_third);
    float v = a.vm_base * ushape * expf(a.vm_sigma * zv - a.vm_half_s2);
    if (a.vm_rc != 0.0f)
        v = v * (1.0f + a.vm_rc * ((fabsf(z) - a.vm_mean_abs) / a.vm_sd_abs));
    v = fmaxf(v, a.vm_floor);
    const int now_ms = t * 60000;

    // nearest valid level at the close (strict <: the first minimum wins)
    float best_d = INF_F, best_p = 0.f;
    int best_k = 0, best_i = 0;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) {
        if (i < a.max_levels && a.level_valid[i]) {
            const float d = fabsf(c - a.level_price[i]);
            if (d < best_d) { best_d = d; best_p = a.level_price[i]; best_k = a.level_kind[i]; best_i = i; }
        }
    }

    // ---- B) position management
    const bool was_open = st.side != 0;
    const bool is_long = st.side > 0;
    if (was_open) {
        const bool stop_hit = is_long ? l <= st.stop : h >= st.stop;
        const bool tgt_hit = is_long ? h >= st.target : l <= st.target;
        const bool hit = stop_hit || tgt_hit;
        bool tf = tgt_hit && !stop_hit;
        if (stop_hit && tgt_hit) {
            const float up = fmaxf(h - st.entry, 0.f);
            const float dn = fmaxf(st.entry - l, 0.f);
            tf = tie < up / (up + dn + 1e-9f);
        }
        bool escalate = false;
        float esc_target = 0.f, esc_stop = 0.f;
        if (a.escalation && t >= LOOKBACK && hit && tf && fabsf(c - st.target) <= a.prox) {
            // should_escalate_on_target over bars t-5 .. t-1, oldest first
            float P[LOOKBACK], V[LOOKBACK], D[LOOKBACK];
#pragma unroll
            for (int i = 0; i < LOOKBACK; ++i) {
                P[i] = rg.c(t - LOOKBACK + i);
                V[i] = rg.v(t - LOOKBACK + i);
                D[i] = fabsf(P[i] - best_p);
            }
            const bool near = best_d <= PROX_WINDOW;
            const bool toward2 = fabsf(P[4] - best_p) < fabsf(P[3] - best_p);
            const int inferred = toward2 ? (P[3] > best_p ? 0 : 1) : -1;
            const int fallback = c > best_p ? 0 : 1;
            const bool below = (inferred >= 0 ? inferred : fallback) == 1;
            // volume trend toward the level: bars whose distance did not grow
            bool keep[LOOKBACK];
            int cnt = 0;
#pragma unroll
            for (int i = 0; i < LOOKBACK; ++i) {
                keep[i] = i == 0 || D[i] <= D[i - 1];
                cnt += keep[i] ? 1 : 0;
            }
            const int k = max(2, cnt / 2);
            float first = 0.f, last = 0.f;
            int order = -1;
#pragma unroll
            for (int i = 0; i < LOOKBACK; ++i) {
                if (keep[i]) {
                    ++order;
                    if (order < k) first = first + V[i];
                    if (order >= cnt - k) last = last + V[i];
                }
            }
            const float kf = (float)k;
            const float trend_f = last / kf - first / kf;
            const float trend_all = ((0.f + V[3]) + V[4]) / 2.0f - ((0.f + V[0]) + V[1]) / 2.0f;
            const float trend = cnt < 3 ? trend_all : trend_f;
            const bool reversal = trend < 0.f;
            const bool move_down = reversal ? below : !below;
            const bool against = is_long ? move_down : !move_down;
            const bool level_valid = near && a.has_levels;
            const float anchor = level_valid ? best_p : c;
            float up_px = INF_F, dn_px = -INF_F;
            bool any_up = false, any_dn = false;
#pragma unroll
            for (int i = 0; i < MAXL; ++i) {
                if (i < a.max_levels && a.level_valid[i]) {
                    const float lp = a.level_price[i];
                    if (lp > anchor + 1e-9f) { up_px = fminf(up_px, lp); any_up = true; }
                    if (lp < anchor - 1e-9f) { dn_px = fmaxf(dn_px, lp); any_dn = true; }
                }
            }
            const bool found = is_long ? any_up : any_dn;
            float trail = is_long ? fmaxf(st.entry, anchor - PROX_WINDOW)
                                  : fminf(st.entry, anchor + PROX_WINDOW);
            trail = rintf(trail * 100.0f) / 100.0f;
            escalate = !(level_valid && against) && level_valid && !reversal && found;
            esc_target = is_long ? up_px : dn_px;
            esc_stop = trail;
        }
        const bool closed = hit && !escalate;
        if (closed) {
            const float exit_px = tf ? st.target : st.stop;
            const float pnl = is_long ? exit_px - st.entry : st.entry - exit_px;
            st.equity = st.equity + pnl / fmaxf(st.risk0, 1e-9f);
            st.peak = fmaxf(st.peak, st.equity);
            st.dd = fmaxf(st.dd, st.peak - st.equity);
            if (pnl > 0.f) ++st.wins; else ++st.losses;
            st.side = 0;
            st.cooldown_until = now_ms + a.cooldown_ms;
        }
        if (escalate) {
            st.stop = esc_stop;
            st.target = esc_target;
            ++st.escal;
        }
    }

    // ---- C) the entry ladder at the close; the first failing gate counts
    bool ok = true;
    FIRST_FAIL(was_open, SK_IN_POSITION);
    FIRST_FAIL(now_ms < st.cooldown_until, SK_COOLDOWN);
    FIRST_FAIL(!a.has_levels, SK_NOLEVELS);
    int direction = 0;
    if (t > 0) {
        direction = c > st.prev_c + 1e-9f ? 1 : (c < st.prev_c - 1e-9f ? -1 : st.last_dir);
    }
    FIRST_FAIL(direction == 0, SK_DIR_UNKNOWN);
    FIRST_FAIL(best_d > a.prox, SK_TOO_FAR);
    if (ok) {
        // 7) contact latch (moves exactly when gates 2-6 passed) + overtouch
        int tc = 0;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
            if (i < a.max_levels) {
                const bool valid = a.level_valid[i] != 0;
                const float di = valid ? fabsf(a.level_price[i] - c) : INF_F;
                const bool inside = di <= a.prox;
                const bool is_near = i == best_i;
                const bool latched = (st.c_latch >> i) & 1u;
                if (is_near && inside && !latched) ++st.c_counts[i];
                const bool latch_new = (is_near ? inside : (latched && inside)) && valid;
                st.c_latch = latch_new ? (st.c_latch | (1u << i)) : (st.c_latch & ~(1u << i));
                if (is_near) tc = st.c_counts[i];
            }
        }
        FIRST_FAIL(tc >= a.overtouch_limit, SK_OVERTOUCHED);

        // 7b) accumulation gates
        const bool acc = st.regime == 1;
        bool fat[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const bool kth_in = st.tap_ts[e * TAP_SLOTS + TAP_SLOTS - 1] >= now_ms - a.tm_fat_win_ms;
            const float ssum = (st.tap_ratio[e * TAP_SLOTS] + st.tap_ratio[e * TAP_SLOTS + 1])
                               + st.tap_ratio[e * TAP_SLOTS + 2];
            fat[e] = kth_in && ssum / 3.0f >= a.tm_fat_vol_k;
        }
        const int fatigued_edge = fat[0] ? 1 : (fat[1] ? 2 : 0);   // EDGE_TOP / EDGE_BOT
        const int edge_for_this = direction == -1 ? 1 : 2;
        FIRST_FAIL(acc && fatigued_edge == edge_for_this, SK_EDGE_FATIGUE);
        const int short_side = direction == -1 ? 1 : 0;
        int tm_c = 0, tm_t = 0;
        bool tm_h = false;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
            if (i == best_i) {
                tm_c = short_side ? st.tm_cnt[2 * i + 1] : st.tm_cnt[2 * i];
                tm_t = short_side ? st.tm_ts[2 * i + 1] : st.tm_ts[2 * i];
                tm_h = (st.tm_has >> (2 * i + short_side)) & 1u;
            }
        }
        const bool budget = tm_c >= a.tm_max_bounces;
        const bool tm_cool = tm_h && (now_ms - tm_t) < a.tm_min_gap_ms;
        const bool tm_ok = !(budget || tm_cool);
        FIRST_FAIL(acc && !tm_ok && budget, SK_TOUCH_BUDGET);
        FIRST_FAIL(acc && !tm_ok && !budget, SK_TOUCH_COOLDOWN);
        float decay_mult = 1.0f;
        if (acc && tm_ok) {
#pragma unroll
            for (int j = 0; j < 8; ++j) decay_mult = decay_mult * (tm_c > j ? a.tm_decay : 1.0f);
        }

        // 8) confidence x decay
        float base = fmaxf(1.0f - best_d / a.prox_conf, 0.f);
        base = base + (best_k == KIND_SOLID ? 0.08f : 0.02f);
        base = base + (tc <= 1 ? 0.10f : (tc == 2 ? -0.08f : -0.16f));
        base = base + 0.03f;                         // direction is known here
        const float conf = fminf(fmaxf(base, 0.f), 1.f) * decay_mult;
        FIRST_FAIL(conf < a.qmin, SK_CONF_LOW);

        // 9) side, the clean scaffold, 9b) the breakout counter-trend gate
        const bool go_long = direction == 1;
        const float stop_clean = go_long ? best_p - a.stop_pad : best_p + a.stop_pad;
        FIRST_FAIL((st.regime == 2 && !go_long) || (st.regime == 3 && go_long), SK_ACC_BREAKOUT);

        if (ok) {
            // 10) soft volume veto: slope over the newest min(6, t) volumes
            const int n = min(t, 32);
            const int m = min(6, n);
            const int half = max(2, m / 2);
            float v1 = 0.f, v2 = 0.f;
            for (int i = 0; i < m; ++i) {            // oldest first
                const float vi = rg.v(t - m + i);
                if (i < half) v1 = v1 + vi;
                if (i >= m - half) v2 = v2 + vi;
            }
            v1 = v1 / (float)half;
            v2 = v2 / (float)half;
            float slope = (v2 - v1) / (fabsf(v1) + 1e-9f);
            if ((v1 == 0.f && v2 == 0.f) || n < 3) slope = 0.f;
            int confl = 0, confl_pol = 0;
#pragma unroll
            for (int i = 0; i < MAXL; ++i) {
                if (i < a.max_levels && a.level_valid[i]) {
                    const float dl = fabsf(a.level_price[i] - best_p);
                    confl += dl <= a.confl_within ? 1 : 0;
                    confl_pol += dl <= 0.6f ? 1 : 0;
                }
            }
            const bool weak = fabsf(slope) < 0.05f && !(confl >= 2);
            const bool near_v = best_d <= a.veto_near;
            // coming from below <=> direction up <=> a long
            const bool contra_long = go_long ? slope < -a.veto_strong : slope > a.veto_strong;
            const bool contra_short = go_long ? slope > a.veto_strong : slope < -a.veto_strong;
            const bool veto_long = near_v && go_long && contra_long;
            const bool veto_short = near_v && !go_long && contra_short;
            if (a.enable_veto && !weak && (veto_long || veto_short)) {
                ok = false;
                ++st.skips[veto_long ? SK_CONTRA_LONG : SK_CONTRA_SHORT];
            }

            // 11) ML / blended gate
            bool ok_ml = true;
            float proba = 0.f;
            if (a.ml_usable) {
                float zm = a.ml_coef[0] * (best_k == KIND_SOLID ? 1.0f : 0.0f);
                zm = fmaf(a.ml_coef[1], fabsf(best_p - stop_clean), zm);
                zm = fmaf(a.ml_coef[2], (float)tc, zm);
                zm = fmaf(a.ml_coef[3], go_long ? 1.0f : 0.0f, zm);
                zm = zm + a.ml_intercept;
                proba = 1.0f / (1.0f + expf(-zm));
                ok_ml = proba >= a.qmin;
            }
            if (a.use_blend) {
                const float mlp = (a.ml_ran && a.ml_usable) ? proba : conf;
                FIRST_FAIL(fmaf(a.w_rules, conf, a.w_ml * mlp) < a.qmin, SK_COMBINED_LOW);
            } else {
                FIRST_FAIL(a.ml_ran && !ok_ml, SK_ML_CONF_LOW);
            }

            // 12) OnlinePolicy gate; the volume-trend feature is 0
            if (a.policy_on && ok) {
                const float x[7] = {1.0f, fminf(best_d, 1.0f), 0.0f,
                                    go_long ? 0.0f : 1.0f, go_long ? 1.0f : 0.0f,
                                    confl_pol > 1 ? 1.0f : 0.0f,
                                    fminf((float)(a.bar0_minute + t) / 390.0f, 1.0f)};
                float s[3];
#pragma unroll
                for (int act = 0; act < 3; ++act) {
                    float zp = a.pol_w[act][0] * x[0];
#pragma unroll
                    for (int d = 1; d < 7; ++d) zp = zp + a.pol_w[act][d] * x[d];
                    s[act] = zp < -50.f ? 0.f : (zp > 50.f ? 1.f : 1.0f / (1.0f + expf(-zp)));
                }
                const float chosen = go_long ? s[0] : s[1];
                FIRST_FAIL(!(chosen >= 0.6f && s[2] < 0.55f), SK_ONLINE_POLICY);
            }

            if (ok) {
                // open at the close; execution noise jitters the scaffold only
                float fill = c, stop_new = stop_clean;
                float tgt_new = go_long ? best_p + a.tp_pad : best_p - a.tp_pad;
                if (a.use_noise) {
                    const float r1 = sqrtf(-2.0f * logf(dr.at(noise_row)));
                    const float a1 = two_pi() * dr.at(noise_row + 1);
                    const float r2 = sqrtf(-2.0f * logf(dr.at(noise_row + 2)));
                    const float a2 = two_pi() * dr.at(noise_row + 3);
                    float s1, c1, s2, c2;
                    sincosf(a1, &s1, &c1);
                    sincosf(a2, &s2, &c2);
                    const float lvl = fmaf(r1 * c1, a.lvl_jit, best_p);
                    fill = fmaf(r1 * s1, a.entry_slip, c);
                    stop_new = fmaf(r2 * c2, a.stop_slip,
                                    go_long ? lvl - a.stop_pad : lvl + a.stop_pad);
                    tgt_new = fmaf(r2 * s2, a.tgt_slip,
                                   go_long ? lvl + a.tp_pad : lvl - a.tp_pad);
                }
                st.side = go_long ? 1 : -1;
                st.entry = fill;
                st.stop = stop_new;
                st.target = tgt_new;
                st.risk0 = fabsf(fill - stop_new);
                ++st.trades;
            }
        }
    }
    if (t > 0 && c != st.prev_c) st.last_dir = c > st.prev_c ? 1 : -1;

    // ---- D) the minute close of bar t
    rg.vol[(t % VOL_RING) * BLOCK] = v;
    rg.close[(t % CLOSE_RING) * BLOCK] = c;
    const int n_after = t + 1;
    float sum5 = 0.f;
    for (int j = 0; j < min(5, n_after); ++j) sum5 = sum5 + rg.v(t - j);   // newest first
    float sum20 = sum5;
    for (int j = 5; j < min(VOL_RING, n_after); ++j) sum20 = sum20 + rg.v(t - j);
    const float vol_ma_s = sum5 / (float)max(1, min(5, n_after));
    const float vol_ma_l = sum20 / (float)max(1, min(VOL_RING, n_after));

    // the guard: running box (the 60-minute window while W <= 61)
    st.run_low = fminf(st.run_low, l);
    st.run_high = fmaxf(st.run_high, h);
    const int n_win = min(n_after, 61);
    const bool s_def = n_win >= 5, l_def = n_win >= VOL_RING;
    const float gma_s = s_def ? sum5 / 5.0f : 0.f;
    const float gma_l = l_def ? sum20 / 20.0f : 0.f;
    const bool mas_ok = gma_s != 0.f && gma_l != 0.f && s_def && l_def;
    const bool in_bo = st.regime == 2 || st.regime == 3;
    const bool compressed = st.run_high - st.run_low <= fmaxf(c * a.g_comp, 1e-6f);
    if (!in_bo) st.regime = compressed ? 1 : 0;
    if (compressed) { st.box_low = st.run_low; st.box_high = st.run_high; st.box_valid = 1; }
    const bool spike = mas_ok && gma_s > a.g_vol_k * gma_l;
    const bool can_check = st.box_valid && mas_ok;
    const bool bo_up = can_check && c > st.box_high + 1e-6f && spike;
    const bool bo_dn = can_check && !bo_up && c < st.box_low - 1e-6f && spike;
    if (bo_up) st.regime = 2;
    if (bo_dn) st.regime = 3;
    if (bo_up || bo_dn) st.inside_cnt = 0;
    const bool in_box = st.box_low <= c && c <= st.box_high;
    if ((st.regime == 2 || st.regime == 3) && st.box_valid) {
        st.inside_cnt = in_box ? st.inside_cnt + 1 : 0;
        if (in_box && st.inside_cnt >= a.g_clear_bars) st.regime = 1;
    }
    if (n_win < a.g_min_bars) { st.regime = 0; st.box_valid = 0; st.inside_cnt = 0; }

    if (st.regime == 1) {
        // touch registration on the finished bar, per (level, side)
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
            if (i < a.max_levels && a.level_valid[i]) {
                const float lr = a.level_round[i];
                const bool pierced = l - 1e-9f <= lr && lr <= h + 1e-9f;
                const float bps_c = lr <= 0.f ? 0.f : fabsf(c - lr) / lr * 1e4f;
                if (pierced || bps_c <= a.tm_tol_bps) {
                    const int sd = c > lr ? 1 : 0;
                    const int j = 2 * i + sd;
                    const int ts_a = sd ? st.tm_ts[2 * i + 1] : st.tm_ts[2 * i];
                    const float px_a = sd ? st.tm_px[2 * i + 1] : st.tm_px[2 * i];
                    const bool has_a = (st.tm_has >> j) & 1u;
                    const bool too_soon = has_a && (now_ms - ts_a) < a.tm_min_gap_ms;
                    const float bps_last = px_a <= 0.f ? 0.f : fabsf(c - px_a) / px_a * 1e4f;
                    const bool too_close = has_a && bps_last < a.tm_min_px_bps;
                    if (!(too_soon || too_close)) {
                        if (sd) { ++st.tm_cnt[2 * i + 1]; st.tm_ts[2 * i + 1] = now_ms; st.tm_px[2 * i + 1] = c; }
                        else { ++st.tm_cnt[2 * i]; st.tm_ts[2 * i] = now_ms; st.tm_px[2 * i] = c; }
                        st.tm_has |= 1u << j;
                    }
                }
            }
        }
        // edge taps, with the minute-close volume ratio
        const bool ratio_ok = vol_ma_s != 0.f && vol_ma_l != 0.f && vol_ma_l > 0.f;
        const float ratio = ratio_ok ? vol_ma_s / fmaxf(vol_ma_l, 1e-30f) : 1.0f;
        const bool tap[2] = {st.box_valid && h >= st.box_high - 1e-9f,
                             st.box_valid && l <= st.box_low + 1e-9f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (tap[e]) {
#pragma unroll
                for (int k = TAP_SLOTS - 1; k > 0; --k) {
                    st.tap_ts[e * TAP_SLOTS + k] = st.tap_ts[e * TAP_SLOTS + k - 1];
                    st.tap_ratio[e * TAP_SLOTS + k] = st.tap_ratio[e * TAP_SLOTS + k - 1];
                }
                st.tap_ts[e * TAP_SLOTS] = now_ms;
                st.tap_ratio[e * TAP_SLOTS] = ratio;
            }
        }
    } else if (st.regime == 2 || st.regime == 3) {
        // a breakout resets the touch box
#pragma unroll
        for (int j = 0; j < 2 * MAXL; ++j) { st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f; }
        st.tm_has = 0u;
#pragma unroll
        for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
    }
    st.prev_c = c;
}
