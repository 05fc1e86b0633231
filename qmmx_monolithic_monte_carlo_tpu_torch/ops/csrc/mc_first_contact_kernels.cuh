// The first-contact family's gbm kernels -- the bar step, the per-CTA path
// loop and reduction, and mc_universe_kernel (the single configuration at one
// symbol, and the universe) -- included by mc_first_contact.cu (W/2 <= 64:
// MAXHALF = 20 or 64 sine halves kept in registers for bars W/2..W-1) and by
// mc_first_contact_long.cu, which defines FIRST_CONTACT_LONG first: any even
// W, bar t >= W/2 drawing pair t - W/2 again (Philox is counter-based, and
// sincosf of the same argument gives the same sine), so its paths equal the
// register kernels' bit for bit.  Each source is a library of its own (the
// non-inlined bar step is register-allocated per library), so
// mc_first_contact.cu compiles the statements it had before the long kernels
// came (utils/sass_diff).  The gbm sweep is mc_first_contact_sweep.cu.
#pragma once

// One bar of one path: contact search before entry, stop/target after it.
// Not inlined, for the same reason as philox4 (common.cuh).
__device__ __noinline__ void bar_step(const McArgs& a, const Draw& draw,
                                      PathState& st, int lane, int k,
                                      float z, float sig2dt) {
    const float incr = a.drift + a.sig_dt * z;
    st.acc = st.acc + incr;
    const float log_close = a.log_s0 + st.acc;
    const float log_open = log_close - incr;
    if (!st.entered) {
        if (contact(a, log_close, log_open, st.entry, st.lvl, st.is_long)) {
            st.entered = true;
            float stop_slip = 0.f, tgt_slip = 0.f;
            if (a.use_noise) {
                const int t = 3 * a.num_bars;
                const float r1 = sqrtf(-2.0f * logf(draw(t + 1, lane)));
                const float r2 = sqrtf(-2.0f * logf(draw(t + 3, lane)));
                float s1, c1, s2, c2;
                sincosf(two_pi() * draw(t + 2, lane), &s1, &c1);
                sincosf(two_pi() * draw(t + 4, lane), &s2, &c2);
                st.lvl = st.lvl + r1 * c1 * a.lvl_jit;
                st.entry = st.entry + r1 * s1 * a.entry_slip;
                stop_slip = r2 * c2 * a.stop_slip;
                tgt_slip = r2 * s2 * a.tgt_slip;
            }
            st.stop = (st.is_long ? st.lvl - a.stop_pad : st.lvl + a.stop_pad)
                      + stop_slip;
            st.target = (st.is_long ? st.lvl + a.tp_pad : st.lvl - a.tp_pad)
                        + tgt_slip;
        }
        return;
    }
    float high, low;
    bridge(a, draw, lane, k, log_close, log_open, sig2dt, high, low);
    const bool stop_hit = st.is_long ? low <= st.stop : high >= st.stop;
    const bool tgt_hit = st.is_long ? high >= st.target : low <= st.target;
    if (!(stop_hit || tgt_hit)) return;
    st.done = true;
    st.target_first = stop_hit && tgt_hit
        ? tie_coin(a, draw, lane, high, low, st.entry) : tgt_hit;
}

// The paths of this CTA (blockIdx.x of gridDim.x) under arguments ``a``,
// reduced to one partial row (crow, frow).
template <int MAXHALF>
__device__ __forceinline__ void first_contact_block(const McArgs& a,
                                                    const float* __restrict__ ext,
                                                    long long* __restrict__ crow,
                                                    float* __restrict__ frow) {
    __shared__ unsigned s_counts[ROW_COUNTS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) s_counts[i] = 0u;
    __syncthreads();

    const int half = a.num_bars >> 1;
    const float sig2dt = a.sig_dt * a.sig_dt;
    unsigned cnt[N_COUNTS] = {0u, 0u, 0u, 0u, 0u};
    float sum_r = 0.f, sum_r2 = 0.f, min_r = BIG, max_r = -BIG;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / a.lanes;
        const int lane = (int)(p - blk * a.lanes);
        // antithetic: the right half-lanes take the left partner's normals
        const bool mirror = a.antithetic && lane >= (a.lanes >> 1);
        const int zlane = mirror ? lane - (a.lanes >> 1) : lane;
        const float zsign = mirror ? -1.f : 1.f;
        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};

        PathState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f; st.stop = 0.f; st.target = 0.f;
        st.entered = false; st.is_long = false; st.done = false;
        st.target_first = false;
#ifdef FIRST_CONTACT_LONG
        // bar t >= W/2 takes the sine half of pair t - W/2, drawn again
        for (int t = 0; t < 2 * half && !st.done; ++t) {
            const int k = t < half ? t : t - half;
            const float rad = sqrtf(-2.0f * logf(draw(k, zlane)));
            float s, c;
            sincosf(two_pi() * draw(half + k, zlane), &s, &c);
            bar_step(a, draw, st, lane, t, zsign * (rad * (t < half ? c : s)), sig2dt);
        }
#else
        float zsin[MAXHALF];
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done) break;
            const float rad = sqrtf(-2.0f * logf(draw(k, zlane)));
            float s, c;
            sincosf(two_pi() * draw(half + k, zlane), &s, &c);
            zsin[k] = zsign * (rad * s);
            bar_step(a, draw, st, lane, k, zsign * (rad * c), sig2dt);
        }
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done) break;
            bar_step(a, draw, st, lane, half + k, zsin[k], sig2dt);
        }
#endif

        cnt[0] += 1u;
        if (st.entered) {
            float r = 0.f;
            cnt[1] += 1u;
            if (!st.done) {
                cnt[4] += 1u;
            } else if (st.target_first) {
                cnt[2] += 1u;
                r = fabsf(st.target - st.entry)
                    / fmaxf(fabsf(st.entry - st.stop), 1e-9f);
            } else {
                cnt[3] += 1u;
                r = -1.f;
            }
            sum_r += r;
            sum_r2 += r * r;
            min_r = fminf(min_r, r);
            max_r = fmaxf(max_r, r);
            const int bin = min(max((int)((r - (-1.5f)) * 32.0f), 0), HIST_BINS - 1);
            atomicAdd(&s_counts[N_COUNTS + bin], 1u);
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < N_COUNTS; ++j) {
        const unsigned v = warp_count<unsigned>(cnt[j]);
        if (wl == 0) atomicAdd(&s_counts[j], v);
    }
    sum_r = warp_sum(sum_r);
    sum_r2 = warp_sum(sum_r2);
    min_r = warp_min(min_r);
    max_r = warp_max(max_r);
    if (wl == 0) {
        s_red[0][warp] = sum_r; s_red[1][warp] = sum_r2;
        s_red[2][warp] = min_r; s_red[3][warp] = max_r;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) crow[i] = (long long)s_counts[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, mn = BIG, mx = -BIG;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w];
            mn = fminf(mn, s_red[2][w]); mx = fmaxf(mx, s_red[3][w]);
        }
        frow[0] = s0; frow[1] = s1; frow[2] = mn; frow[3] = mx;
    }
}

// Symbol blockIdx.y of the universe ``rows`` (one symbol for a single
// configuration): partial rows [symbol][CTA].
template <int MAXHALF>
__global__ void __launch_bounds__(BLOCK)
mc_universe_kernel(const McArgs* __restrict__ rows, const float* __restrict__ ext,
                   long long* __restrict__ part_counts, float* __restrict__ part_floats) {
    __shared__ McArgs s_a;
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    first_contact_block<MAXHALF>(s_a, ext ? ext + s_a.ext_offset : nullptr,
                                 part_counts + seg * ROW_COUNTS, part_floats + seg * ROW_FLOATS);
}
