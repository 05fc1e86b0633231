// The double-bar loop of one path of a gbm book, included in engine_walk
// (mc_engine_corr.cu) and the envelope's env_book_walk (mc_engine_wide_corr.cuh)
// after the path's state is set: engine_block's bars with the price normal
// mixed with the market's (bk) before the bar step -- so the mixed shock also
// drives its volume -- and the post-bar equity added to the book curve after
// every bar; the family's bar step (ENGINE_FN / ENGINE_LV / ENGINE_RG).  Text,
// not a function: the parents keep their code (utils/sass_diff).

#pragma unroll 1
    for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
        const int base = t2 * a.stride;
        float u[10];
#pragma unroll
        for (int k = 0; k < 10; ++k) u[k] = dr.at(base + k);
        if (mirror) {
            const float2 m = dr.pair_of(col - half_lanes, base);
            u[0] = m.x; u[1] = m.y;
        }
        const float rad = sqrtf(-2.0f * logf(u[0]));
        float sn, cs;
        sincosf(two_pi() * u[1], &sn, &cs);
        float z0 = rad * cs, z1 = rad * sn;
        if (mirror) { z0 = -z0; z1 = -z1; }
        const float vrad = sqrtf(-2.0f * logf(u[2]));
        float vsn, vcs;
        sincosf(two_pi() * u[3], &vsn, &vcs);
        const float2 zm = bk.market(t2);
        z0 = bk.mix(zm.x, z0);
        z1 = bk.mix(zm.y, z1);
        ENGINE_FN(bar_step)(a, ENGINE_LV st, dr, ENGINE_RG, 2 * t2, z0, vrad * vcs, u[4], u[5], u[6],
                            base + 10);
        bk.add(2 * t2, st.equity);
        ENGINE_FN(bar_step)(a, ENGINE_LV st, dr, ENGINE_RG, 2 * t2 + 1, z1, vrad * vsn, u[7], u[8],
                            u[9], base + 14);
        bk.add(2 * t2 + 1, st.equity);
    }
