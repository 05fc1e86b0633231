// The engine step's OnlinePolicy scores at bar t (gate 12; the volume-trend
// feature is 0): s[3] and the chosen side's score.  It depends on the bars,
// the levels and the row's knobs alone, so the rows kernel's producers
// compute it for the consumers (ENGINE_BAR_POLICY_FAILS).
// No include guard: included in place, where the step (mc_engine_step.cuh)
// and the rows kernel's producers (mc_engine_rows.cu) compute it.
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
