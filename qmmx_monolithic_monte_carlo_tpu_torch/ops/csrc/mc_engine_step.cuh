// The engine on one bar (sim/enginepath.EngineLifecycle.step): position
// management with the escalation walk, the entry ladder (the first failing
// gate counts), the minute close, the guard and the touch memory.  The body
// of every engine bar step: mc_engine.cuh's bar_step (GBM) and
// mc_engine_samplers.cu's (the recorded-bar and Heston bars) include it after
// making the bar, so each compiles the same statements.  In scope: a, st, dr,
// rg, t, the bar's close c, high h, low l and volume v, its tie coin tie and
// noise_row, the first of its four noise rows.  No include guard: it is
// included once in each bar step.
//
// The level slots, the latch and touch flags and the guard's window are read
// through the macros LEVEL_SLOTS, LV_PRICE / LV_ROUND / LV_VALID / LV_KIND,
// LATCH_BIT / LATCH_SET, TM_HAS_BIT / TM_HAS_MARK / TM_HAS_CLEAR and
// GUARD_PUSH, which each family defines before its bar steps: mc_engine.cuh
// for the parent kernels (the slots of EngineArgs and bit masks; after
// preprocessing the statements of the parent's own text, so its code stays),
// mc_engine_wide.cuh for the envelope kernels (a level table in shared memory,
// flag arrays, the windowed guard).  HARVEST_CLOSE and HARVEST_ENTRY fold a
// closed trade into the label harvest and latch an entry's features; they
// are empty but in the envelope's harvest builds.
//
// now_ms is an int: exact for every bar below 2^31 / 60000 (the wrappers
// refuse longer horizons); the JAX kernel's float32 t * 60000 is exact below
// 8947 bars (a multiple of 32 below 2^29), so the two agree at W = 390 or 1200.
    const int now_ms = t * 60000;

    // nearest valid level at the close (strict <: the first minimum wins)
    float best_d = INF_F, best_p = 0.f;
    int best_k = 0, best_i = 0;
#pragma unroll
    for (int i = 0; i < LEVEL_SLOTS; ++i) {
        if (i < a.max_levels && LV_VALID(i)) {
            const float d = fabsf(c - LV_PRICE(i));
            if (d < best_d) { best_d = d; best_p = LV_PRICE(i); best_k = LV_KIND(i); best_i = i; }
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
            for (int i = 0; i < LEVEL_SLOTS; ++i) {
                if (i < a.max_levels && LV_VALID(i)) {
                    const float lp = LV_PRICE(i);
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
            HARVEST_CLOSE
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
        for (int i = 0; i < LEVEL_SLOTS; ++i) {
            if (i < a.max_levels) {
                const bool valid = LV_VALID(i) != 0;
                const float di = valid ? fabsf(LV_PRICE(i) - c) : INF_F;
                const bool inside = di <= a.prox;
                const bool is_near = i == best_i;
                const bool latched = LATCH_BIT(i);
                if (is_near && inside && !latched) ++st.c_counts[i];
                const bool latch_new = (is_near ? inside : (latched && inside)) && valid;
                LATCH_SET(i, latch_new);
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
        for (int i = 0; i < LEVEL_SLOTS; ++i) {
            if (i == best_i) {
                tm_c = short_side ? st.tm_cnt[2 * i + 1] : st.tm_cnt[2 * i];
                tm_t = short_side ? st.tm_ts[2 * i + 1] : st.tm_ts[2 * i];
                tm_h = TM_HAS_BIT((2 * i + short_side));
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
            for (int i = 0; i < LEVEL_SLOTS; ++i) {
                if (i < a.max_levels && LV_VALID(i)) {
                    const float dl = fabsf(LV_PRICE(i) - best_p);
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
                HARVEST_ENTRY
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

    // the guard's box over the 60-minute window: the running min/max while W
    // <= 61, the window's past it (GUARD_PUSH)
    GUARD_PUSH
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
        for (int i = 0; i < LEVEL_SLOTS; ++i) {
            if (i < a.max_levels && LV_VALID(i)) {
                const float lr = LV_ROUND(i);
                const bool pierced = l - 1e-9f <= lr && lr <= h + 1e-9f;
                const float bps_c = lr <= 0.f ? 0.f : fabsf(c - lr) / lr * 1e4f;
                if (pierced || bps_c <= a.tm_tol_bps) {
                    const int sd = c > lr ? 1 : 0;
                    const int j = 2 * i + sd;
                    const int ts_a = sd ? st.tm_ts[2 * i + 1] : st.tm_ts[2 * i];
                    const float px_a = sd ? st.tm_px[2 * i + 1] : st.tm_px[2 * i];
                    const bool has_a = TM_HAS_BIT(j);
                    const bool too_soon = has_a && (now_ms - ts_a) < a.tm_min_gap_ms;
                    const float bps_last = px_a <= 0.f ? 0.f : fabsf(c - px_a) / px_a * 1e4f;
                    const bool too_close = has_a && bps_last < a.tm_min_px_bps;
                    if (!(too_soon || too_close)) {
                        if (sd) { ++st.tm_cnt[2 * i + 1]; st.tm_ts[2 * i + 1] = now_ms; st.tm_px[2 * i + 1] = c; }
                        else { ++st.tm_cnt[2 * i]; st.tm_ts[2 * i] = now_ms; st.tm_px[2 * i] = c; }
                        TM_HAS_MARK(j);
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
        for (int j = 0; j < 2 * LEVEL_SLOTS; ++j) { st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f; }
        TM_HAS_CLEAR;
#pragma unroll
        for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
    }
    st.prev_c = c;
