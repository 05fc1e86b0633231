// The bars of one path of a book under sampler KIND, included in
// sampler_walk (mc_engine_corr_samplers.cu) and the envelope's env_book_walk
// (mc_engine_wide_corr.cuh) after the path's state is set: its draws on the
// symbol's key (dr) and the market's (md) -- the joint recorded day's index,
// or Heston's market pairs mixed into the symbol's own -- its bars through
// the family's bar steps (ENGINE_FN / ENGINE_LV) with its rings (ENGINE_RG),
// the post-bar equity into the book curve (bk) after every bar.  Text, not a
// function: the parents keep their code (utils/sass_diff).

    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 12;
    float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
    for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
        const int r = t2 * a.stride;
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            const float x0 = md.at(2 * t2), x1 = md.at(2 * t2 + 1);
            const float tie0 = dr.at(r), tie1 = dr.at(r + 1);
            ENGINE_FN(resample_bar_step)(a, s, ENGINE_LV st, dr, ENGINE_RG, 2 * t2, x0, tie0,
                                         r + k_noise, carry);
            bk.add(2 * t2, st.equity);
            ENGINE_FN(resample_bar_step)(a, s, ENGINE_LV st, dr, ENGINE_RG, 2 * t2 + 1, x1, tie1,
                                         r + k_noise + 4, carry);
        } else {
            const float2 zm = normal_pair(md.at(4 * t2), md.at(4 * t2 + 1));
            const float2 qm = normal_pair(md.at(4 * t2 + 2), md.at(4 * t2 + 3));
            const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
            const float2 zv = normal_pair(dr.at(r + 2), dr.at(r + 3));
            const float2 q = normal_pair(dr.at(r + 4), dr.at(r + 5));
            const float u30 = dr.at(r + 6), u40 = dr.at(r + 7), tie0 = dr.at(r + 8);
            const float u31 = dr.at(r + 9), u41 = dr.at(r + 10), tie1 = dr.at(r + 11);
            ENGINE_FN(heston_bar_step)(a, s, ENGINE_LV st, dr, ENGINE_RG, 2 * t2, bk.mix(zm.x, z.x),
                                       zv.x, bk.mix(qm.x, q.x), u30, u40, tie0, r + k_noise,
                                       carry);
            bk.add(2 * t2, st.equity);
            ENGINE_FN(heston_bar_step)(a, s, ENGINE_LV st, dr, ENGINE_RG, 2 * t2 + 1,
                                       bk.mix(zm.y, z.y), zv.y, bk.mix(qm.y, q.y), u31, u41,
                                       tie1, r + k_noise + 4, carry);
        }
        bk.add(2 * t2 + 1, st.equity);
    }
