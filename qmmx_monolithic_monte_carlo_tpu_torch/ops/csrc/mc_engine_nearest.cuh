// The engine step's nearest valid level at the close c (strict <: the first
// minimum wins): best_d, best_p, best_k, best_i.  It depends on the bar and
// the level slots alone, so the rows kernel's producers compute it for the
// consumers (ENGINE_BAR_NEAREST).
// No include guard: included in place, where the step (mc_engine_step.cuh)
// and the rows kernel's producers (mc_engine_rows.cu) compute it.
    float best_d = INF_F, best_p = 0.f;
    int best_k = 0, best_i = 0;
#pragma unroll
    for (int i = 0; i < LEVEL_SLOTS; ++i) {
        if (i < a.max_levels && LV_VALID(i)) {
            const float d = fabsf(c - LV_PRICE(i));
            if (d < best_d) { best_d = d; best_p = LV_PRICE(i); best_k = LV_KIND(i); best_i = i; }
        }
    }
