// The body of the gbm kernels' per-CTA path loop, included in engine_block
// (mc_engine.cu) and wide_block (mc_engine_wide.cu): the paths of this CTA
// (blockIdx.x of gridDim.x) under arguments ``a``, the engine along each (the
// family's state and bar step, ENGINE_STATE / ENGINE_FN / ENGINE_LV of
// mc_engine.cuh or mc_engine_wide.cuh), reduced to one partial row (crow,
// frow); per-path rows at per_path[p] when per_path is not null.  Under
// ENGINE_WIDE (the envelope's headers) a path's state starts with
// wide_init_state and an odd W ends with a half step: the cos branch of the
// price and volume pairs of one more step of rows (0-3), the bridge at rows
// 4, 5, the tie at 6, antithetic as in the pairs, the noise from row 10.
// Under ENGINE_HARVEST (the harvest build, mc_engine_wide_harvest.cu) each
// close also goes into the CTA's tallies and the thread's sums, written to the
// harvest partial row (hv_crow, hv_frow) with the lifecycle row.
// Text, not a function: the parents keep their code (utils/sass_diff).

    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ unsigned long long s_counts[N_COUNTS + N_SKIPS];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
    if (threadIdx.x < N_COUNTS + N_SKIPS) s_counts[threadIdx.x] = 0ull;
#ifdef ENGINE_HARVEST
    __shared__ unsigned long long s_hv[HV_COUNTS];
    hv_clear(s_hv);
    float hsum[HV_SUMS];
#pragma unroll
    for (int j = 0; j < HV_SUMS; ++j) hsum[j] = 0.f;
#endif
    __syncthreads();

    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const int row_len = ENGINE_SUB * a.lanes;
    const int half_lanes = a.lanes >> 1;
    unsigned long long cnt[N_COUNTS + N_SKIPS];
#pragma unroll
    for (int j = 0; j < N_COUNTS + N_SKIPS; ++j) cnt[j] = 0ull;
    float sum_eq = 0.f, sum_eq2 = 0.f, sum_dd = 0.f;
    float min_eq = BIG, max_eq = -BIG, max_dd = 0.f;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / row_len;
        const int col = (int)(p - blk * row_len);
        // antithetic: right half-lanes take the left partner's normals negated
        const bool mirror = a.antithetic && (col % a.lanes) >= half_lanes;
        Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                 make_uint4(0u, 0u, 0u, 0u)};

        ENGINE_STATE st;
#ifdef ENGINE_WIDE
        wide_init_state<WIN>(a, st, rg);
#ifdef ENGINE_HARVEST
        st.hv_cnt = s_hv;
#endif
#else
        st.log_s = a.log_s0;
        st.prev_c = expf(a.log_s0);
        st.entry = st.stop = st.target = st.risk0 = 0.f;
        st.equity = st.peak = st.dd = 0.f;
        st.run_low = INF_F; st.run_high = -INF_F;
        st.box_low = st.box_high = 0.f;
        st.side = st.last_dir = st.trades = st.wins = st.losses = st.escal = 0;
        st.cooldown_until = -(1 << 30);
        st.box_valid = st.regime = st.inside_cnt = 0;
        st.c_latch = 0u;
        st.tm_has = 0u;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) st.c_counts[i] = 0;
#pragma unroll
        for (int j = 0; j < 2 * MAXL; ++j) { st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f; }
#pragma unroll
        for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) st.skips[j] = 0;
        for (int j = 0; j < VOL_RING; ++j) rg.vol[j * BLOCK] = 0.f;
        for (int j = 0; j < CLOSE_RING; ++j) rg.close[j * BLOCK] = 0.f;
#endif

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
            ENGINE_FN(bar_step)(a, ENGINE_LV st, dr, rg, 2 * t2, z0, vrad * vcs, u[4], u[5],
                                u[6], base + 10);
            ENGINE_FN(bar_step)(a, ENGINE_LV st, dr, rg, 2 * t2 + 1, z1, vrad * vsn, u[7],
                                u[8], u[9], base + 14);
        }
#ifdef ENGINE_WIDE
        if (a.num_bars & 1) {
            const int base = (a.num_bars >> 1) * a.stride;
            float u[7];
#pragma unroll
            for (int k = 0; k < 7; ++k) u[k] = dr.at(base + k);
            if (mirror) {
                const float2 m = dr.pair_of(col - half_lanes, base);
                u[0] = m.x; u[1] = m.y;
            }
            const float rad = sqrtf(-2.0f * logf(u[0]));
            float sn, cs;
            sincosf(two_pi() * u[1], &sn, &cs);
            float z0 = rad * cs;
            if (mirror) z0 = -z0;
            const float vrad = sqrtf(-2.0f * logf(u[2]));
            float vsn, vcs;
            sincosf(two_pi() * u[3], &vsn, &vcs);
            wide_bar_step<WIN>(a, lv, st, dr, rg, a.num_bars - 1, z0, vrad * vcs, u[4], u[5],
                               u[6], base + 10);
        }
#endif

#ifdef ENGINE_HARVEST
#pragma unroll
        for (int j = 0; j < HV_SUMS; ++j) hsum[j] = hsum[j] + st.hv_sum[j];
#endif
        const bool entered = st.trades > 0;
        cnt[0] += 1ull;
        cnt[1] += entered ? 1ull : 0ull;
        cnt[2] += (unsigned long long)st.wins;
        cnt[3] += (unsigned long long)st.losses;
        cnt[4] += st.side != 0 ? 1ull : 0ull;
        cnt[5] += (unsigned long long)st.trades;
        cnt[6] += (unsigned long long)st.escal;
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] += (unsigned long long)st.skips[j];
        sum_eq += st.equity;
        sum_eq2 += st.equity * st.equity;
        sum_dd += st.dd;
        max_dd = fmaxf(max_dd, st.dd);
        if (entered) {
            min_eq = fminf(min_eq, st.equity);
            max_eq = fmaxf(max_eq, st.equity);
            const int bin = min(max((int)((st.equity - LIFE_HIST_LO) * LIFE_BIN_SCALE), 0),
                                HIST_BINS - 1);
            atomicAdd(&s_hist[bin], 1u);
        }
        if (per_path) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = st.side != 0 ? 1.f : 0.f; o[5] = st.dd;
            o[6] = (float)st.escal;
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < N_COUNTS + N_SKIPS; ++j) {
        const unsigned long long v = warp_count<unsigned long long>(cnt[j]);
        if (wl == 0) atomicAdd(&s_counts[j], v);
    }
    sum_eq = warp_sum(sum_eq);
    sum_eq2 = warp_sum(sum_eq2);
    sum_dd = warp_sum(sum_dd);
    min_eq = warp_min(min_eq);
    max_eq = warp_max(max_eq);
    max_dd = warp_max(max_dd);
    if (wl == 0) {
        s_red[0][warp] = sum_eq; s_red[1][warp] = sum_eq2; s_red[2][warp] = sum_dd;
        s_red[3][warp] = min_eq; s_red[4][warp] = max_eq; s_red[5][warp] = max_dd;
    }
    __syncthreads();
    if (threadIdx.x < N_COUNTS + N_SKIPS) crow[threadIdx.x] = (long long)s_counts[threadIdx.x];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK)
        crow[N_COUNTS + N_SKIPS + i] = (long long)s_hist[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
            md = fmaxf(md, s_red[5][w]);
        }
        frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx; frow[5] = md;
    }
#ifdef ENGINE_HARVEST
    hv_cta_row(s_hv, hsum, hv_crow, hv_frow, true);
#endif
