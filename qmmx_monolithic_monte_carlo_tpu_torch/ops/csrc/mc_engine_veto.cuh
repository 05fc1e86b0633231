// The engine step's soft volume veto at bar t (gate 10): the slope over the
// newest min(6, t) finished volumes (rg.v, oldest first), the confluence
// counts at best_p, and whether it vetoes a long or a short: weak,
// veto_long, veto_short (and confl_pol, the policy's feature).  It depends on
// the bars, the levels and the row's knobs alone, so the rows kernel's
// producers compute it for the consumers (ENGINE_BAR_VETO).
// No include guard: included in place, where the step (mc_engine_step.cuh)
// and the rows kernel's producers (mc_engine_rows.cu) compute it.
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
