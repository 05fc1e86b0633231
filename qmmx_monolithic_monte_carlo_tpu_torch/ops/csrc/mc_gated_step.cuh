// The gated lifecycle of one bar (_one_bar, pallas_mc.py:1386-1512): manage
// the open position, then evaluate entry.  The body of every gated bar step:
// mc_gated.cuh's bar_step (GBM) and mc_gated_samplers.cu's (the recorded-bar
// and Heston bars) include it after making the bar, so each compiles the
// same statements.  In scope: a, st, t, the bar's close c, its tie coin tie
// and noise uniforms nu, and the hook GATED_EXTREMES, statements that define
// the bar's high and low, run only while a position is open.  Two hooks
// that only mc_gated_sampler_sweep.cu defines (elsewhere they stand for the
// same tokens as before): GATED_TIE, the expression of the tie coin, read
// only on a bar that hits both stop and target (default ``tie``; it draws
// the coin again there), and GATED_ENTRY_NOISE, statements run where a trade
// opens before its noise is read (default empty; it draws nu there).  No
// include guard: it is included once in each bar step.
#ifndef GATED_ENTRY_NOISE
#define GATED_ENTRY_NOISE
#endif
#ifndef GATED_TIE
#define GATED_TIE tie
#endif
    // 1) position management: stop/target off the bridge high/low
    const bool was_open = st.side != 0;
    bool closed = false;
    if (was_open) {
        GATED_EXTREMES
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
                target_first = GATED_TIE < up / (up + dn + 1e-9f);
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
                GATED_ENTRY_NOISE
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
