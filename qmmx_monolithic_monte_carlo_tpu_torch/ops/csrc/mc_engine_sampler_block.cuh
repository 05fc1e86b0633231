// The body of the sampler kernels, included in mc_engine_sampler_kernel
// (mc_engine_samplers.cu) and mc_engine_wide_sampler_kernel
// (mc_engine_wide_samplers.cu): every path of row blockIdx.y of ``args`` /
// ``sargs``, a thread a path in chunks of BLOCK (every thread of a CTA runs the
// same chunks, so cta_add_path_row's barriers line up), the engine along each
// under sampler KIND (the family's state and bar steps, ENGINE_STATE /
// ENGINE_FN / ENGINE_LV of mc_engine.cuh or mc_engine_wide.cuh): partial rows
// [row][CTA], per-path rows [row][path] when per_path is not null.  Under
// ENGINE_WIDE (the envelope's headers) the CTA copies its row of the level
// table ``levels`` into shared memory, and an odd W ends with one bar after
// the pair loop from one more step of rows: the bootstrap samplers' index at
// row 0 and tie at row 2, Heston's cos branch of its price (0, 1), volume
// (2, 3) and variance (4, 5) pairs, bridge at 6, 7 and tie at 8; the noise
// from row 4 (bootstrap) or 12 (Heston), as a first half's.  Text, not a
// function: the parents keep their code (utils/sass_diff).

    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) { s_a = args[blockIdx.y]; s_s = sargs[blockIdx.y]; }
#ifdef ENGINE_WIDE
    __shared__ WideLevel lv[WIDE_LEVELS];
    copy_levels(lv, levels, blockIdx.y, args[blockIdx.y].max_levels);
#endif
    __syncthreads();
    const EngineArgs& a = s_a;
    const SamplerArgs& s = s_s;
    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const int row_len = ENGINE_SUB * a.lanes;
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 12;
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    if (ext) ext += a.ext_offset;
    if (per_path) per_path += (long long)blockIdx.y * a.num_paths * PATH_COLS;
    int chunk = 0;
    for (long long base = (long long)blockIdx.x * BLOCK; base < a.num_paths;
         base += (long long)gridDim.x * BLOCK, ++chunk) {
        const long long p = base + threadIdx.x;
        const bool live = p < a.num_paths;
        ENGINE_STATE st;
        ENGINE_FN(init_state)(a, st, rg);
        if (live) {
            const long long blk = p / row_len;
            const int col = (int)(p - blk * row_len);
            Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                     make_uint4(0u, 0u, 0u, 0u)};
            float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
            for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
                const int r = t2 * a.stride;
                float x0, x1, zv0 = 0.f, zv1 = 0.f, zq0 = 0.f, zq1 = 0.f, tie0, tie1;
                float u30 = 0.f, u40 = 0.f, u31 = 0.f, u41 = 0.f;
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    x0 = dr.at(r); x1 = dr.at(r + 1);
                    tie0 = dr.at(r + 2); tie1 = dr.at(r + 3);
                } else {
                    const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
                    const float2 zv = normal_pair(dr.at(r + 2), dr.at(r + 3));
                    const float2 q = normal_pair(dr.at(r + 4), dr.at(r + 5));
                    x0 = z.x; x1 = z.y; zv0 = zv.x; zv1 = zv.y; zq0 = q.x; zq1 = q.y;
                    u30 = dr.at(r + 6); u40 = dr.at(r + 7); tie0 = dr.at(r + 8);
                    u31 = dr.at(r + 9); u41 = dr.at(r + 10); tie1 = dr.at(r + 11);
                }
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    ENGINE_FN(resample_bar_step)(a, s, ENGINE_LV st, dr, rg, 2 * t2, x0, tie0,
                                                 r + k_noise, carry);
                    ENGINE_FN(resample_bar_step)(a, s, ENGINE_LV st, dr, rg, 2 * t2 + 1, x1,
                                                 tie1, r + k_noise + 4, carry);
                } else {
                    ENGINE_FN(heston_bar_step)(a, s, ENGINE_LV st, dr, rg, 2 * t2, x0, zv0, zq0,
                                               u30, u40, tie0, r + k_noise, carry);
                    ENGINE_FN(heston_bar_step)(a, s, ENGINE_LV st, dr, rg, 2 * t2 + 1, x1, zv1,
                                               zq1, u31, u41, tie1, r + k_noise + 4, carry);
                }
            }
#ifdef ENGINE_WIDE
            if (a.num_bars & 1) {
                const int t = a.num_bars - 1;
                const int r = (a.num_bars >> 1) * a.stride;
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    const float x = dr.at(r), tie = dr.at(r + 2);
                    wide_resample_bar_step<WIN>(a, s, lv, st, dr, rg, t, x, tie, r + k_noise,
                                                carry);
                } else {
                    const float z = normal_pair(dr.at(r), dr.at(r + 1)).x;
                    const float zv = normal_pair(dr.at(r + 2), dr.at(r + 3)).x;
                    const float zq = normal_pair(dr.at(r + 4), dr.at(r + 5)).x;
                    const float u3 = dr.at(r + 6), u4 = dr.at(r + 7), tie = dr.at(r + 8);
                    wide_heston_bar_step<WIN>(a, s, lv, st, dr, rg, t, z, zv, zq, u3, u4, tie,
                                              r + k_noise, carry);
                }
            }
#endif
        }
        const bool entered = st.trades > 0;
        const int open = st.side != 0;
        int cnt[N_COUNTS + N_SKIPS] = {live ? 1 : 0, entered, st.wins, st.losses, open,
                                       st.trades, st.escal};
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
        cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, entered, st.equity, st.dd,
                                             part_counts + seg * ROW_COUNTS,
                                             part_floats + seg * ROW_FLOATS, chunk == 0);
        if (per_path && live) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
            o[6] = (float)st.escal;
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
        }
    }

