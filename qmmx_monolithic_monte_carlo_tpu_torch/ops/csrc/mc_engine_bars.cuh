// A path's bars into a bar store, under gbm and the recorded-bar and Heston
// samplers: the engine walks' uniform rows (EnvRows) and bar arithmetic
// (mc_engine.cuh's bar_step, mc_engine_sampler_step.cuh's, the envelope's),
// each bar equal to theirs bit for bit.  Shared by the envelope's walk
// (mc_engine_env.cuh, the rows) and the kernels that make a path's bars
// apart from its lifecycle: the engine sweep (mc_engine_bar_sweep.cu) and
// the single-run rows kernel (mc_engine_rows.cu).  Included after
// mc_engine.cuh and sampler.cuh.
#pragma once

#define ENV_GBM 0                     // KIND of the gbm kernels (sampler.cuh has the others)

// The uniform rows of a pair of bars under sampler KIND, from the pair's
// first row (a.stride rows a pair): the first bar's tie coin (the second's
// tie_step rows on) and the first of its four noise rows (the second's four
// on).  env_walk reads them here, the kernels that make the bars apart
// (tie_row_of, noise_row_of) where the lifecycle needs them.
template <int KIND>
struct EnvRows {
    static constexpr int tie = KIND == ENV_GBM ? 6 : KIND == SAMPLER_RESAMPLE ? 2 : 8;
    static constexpr int tie_step = KIND == SAMPLER_RESAMPLE ? 1 : 3;
    static constexpr int noise = KIND == ENV_GBM ? 10 : KIND == SAMPLER_RESAMPLE ? 4 : 12;
};

// The tie coin's and the first noise uniform's rows of bar t under sampler
// KIND.
template <int KIND>
__device__ __forceinline__ int tie_row_of(int t, int stride) {
    return (t >> 1) * stride + EnvRows<KIND>::tie + EnvRows<KIND>::tie_step * (t & 1);
}

template <int KIND>
__device__ __forceinline__ int noise_row_of(int t, int stride) {
    return (t >> 1) * stride + EnvRows<KIND>::noise + 4 * (t & 1);
}

// Bar t into the store at ``b`` (this thread's close at bar t; planes
// ``plane`` floats apart).
__device__ __forceinline__ void put_bar(float* b, int plane, float c, float h, float l, float v) {
    b[0] = c;
    b[plane] = h;
    b[2 * plane] = l;
    b[3 * plane] = v;
}

// One GBM bar (env_bar_step's bar).
__device__ __forceinline__ void gbm_bar(const EngineArgs& a, float& log_s, int t, float z,
                                        float zv, float u3, float u4, float* b, int plane) {
    const float log_open = log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    log_s = log_close;
    ENGINE_BRIDGE(a.two_s2)
    ENGINE_VOLUME_MODEL
    put_bar(b, plane, c, h, l, v);
}

// One recorded bar (env_resample_bar_step's bar).
__device__ __forceinline__ void resample_bar(const SamplerArgs& s, float& log_s, int t, float x,
                                             float& start, float* b, int plane) {
    const float idx = resample_index(s, t, x, start);
    const float log_open = log_s;
    const float log_close = log_open + table_at(s, CH_LOGC, idx);
    const float c = expf(log_close);
    log_s = log_close;
    const float h = expf(log_open + table_at(s, CH_LOGH, idx));
    const float l = expf(log_open + table_at(s, CH_LOGL, idx));
    put_bar(b, plane, c, h, l, table_at(s, CH_VOL, idx));
}

// One Heston bar (env_heston_bar_step's bar).
__device__ __forceinline__ void heston_bar(const EngineArgs& a, const SamplerArgs& s,
                                           float& log_s, int t, float z, float zv, float zq,
                                           float u3, float u4, float& var, float* b, int plane) {
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, var, v_pos);
    const float two_s2 = 2.0f * (v_pos * s.dt);
    const float log_open = log_s;
    const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
    const float c = expf(log_close);
    log_s = log_close;
    ENGINE_BRIDGE(two_s2)
    ENGINE_VOLUME_MODEL
    put_bar(b, plane, c, h, l, v);
}

// make_bars' hook on what it draws: a gbm double bar's two price normals,
// a Heston double bar's price and variance normals, a recorded bar's index
// uniform.  BarsAsDrawn leaves them as drawn (the single run's, the
// universes' and the sweep's bars); the book's (mc_engine_book_rows.cu)
// mixes the market's in.  ``mixes``: whether the normals' hooks are called
// (not for BarsAsDrawn, so its kernels compile as they did before the hook).
struct BarsAsDrawn {
    static constexpr bool mixes = false;
    __device__ __forceinline__ void gbm(int t2, float& z0, float& z1) {}
    __device__ __forceinline__ void heston(int t2, float2& z, float2& q) {}
    __device__ __forceinline__ float index_uniform(const EngineArgs& a, Draws& dr, int t) {
        return dr.at((t >> 1) * a.stride + (t & 1));
    }
};

// Bars t0 .. t1 - 1 (t0 even) of one path under sampler KIND into a store
// (``out``: this path's close of bar t0; bars ``step`` floats apart, planes
// ``plane`` floats apart), from the uniform rows the walks read (the tie and
// noise rows aside; the antithetic mirror takes its partner's first pair),
// carrying the path's log price and its block start (the bootstraps) or
// variance (Heston) from the bars before t0.  PAIRS: t1 is even, so every
// pair has its second bar and its test drops out (the rows kernel's
// producers, at 56 registers, spill less: 2% of its time under Heston on
// the H100).  t1 is a reference: the engine sweep passes its arguments'
// num_bars, which its loops then read from shared memory at each step as
// they did before this function was shared (held in a register instead,
// its bootstrap build ran 0.4% slower on the H100).  ``mix``: the draws' hook.
template <int KIND, bool PAIRS, class Mix>
__device__ __forceinline__ void make_bars(const EngineArgs& a, const SamplerArgs& s, Draws& dr,
                                          float& log_s, float& carry, int t0, const int& t1,
                                          float* out, int step, int plane, Mix& mix) {
    if constexpr (KIND == ENV_GBM) {
        const int half_lanes = a.lanes >> 1;
        const bool mirror = a.antithetic && (dr.col % a.lanes) >= half_lanes;
#pragma unroll 1
        for (int t2 = t0 >> 1; t2 < ((t1 + 1) >> 1); ++t2) {
            const int base = t2 * a.stride;
            const bool pair = PAIRS || 2 * t2 + 1 < t1;
            float u[10];
#pragma unroll
            for (int k = 0; k < 6; ++k) u[k] = dr.at(base + k);
            if (pair) {
                u[7] = dr.at(base + 7);
                u[8] = dr.at(base + 8);
            }
            if (mirror) {
                const float2 m = dr.pair_of(dr.col - half_lanes, base);
                u[0] = m.x; u[1] = m.y;
            }
            const float rad = sqrtf(-2.0f * logf(u[0]));
            float sn, cs;
            sincosf(two_pi() * u[1], &sn, &cs);
            float z0 = rad * cs, z1 = rad * sn;
            if (mirror) { z0 = -z0; z1 = -z1; }
            if constexpr (Mix::mixes) mix.gbm(t2, z0, z1);
            const float vrad = sqrtf(-2.0f * logf(u[2]));
            float vsn, vcs;
            sincosf(two_pi() * u[3], &vsn, &vcs);
            float* const b = out + (long long)(2 * t2 - t0) * step;
            gbm_bar(a, log_s, 2 * t2, z0, vrad * vcs, u[4], u[5], b, plane);
            if (pair) gbm_bar(a, log_s, 2 * t2 + 1, z1, vrad * vsn, u[7], u[8], b + step, plane);
        }
    } else if constexpr (KIND == SAMPLER_RESAMPLE) {
#pragma unroll 1
        for (int t = t0; t < t1; ++t)
            resample_bar(s, log_s, t, mix.index_uniform(a, dr, t), carry,
                         out + (long long)(t - t0) * step, plane);
    } else {
#pragma unroll 1
        for (int t2 = t0 >> 1; t2 < ((t1 + 1) >> 1); ++t2) {
            const int r = t2 * a.stride;
            float2 z = normal_pair(dr.at(r), dr.at(r + 1));
            const float2 zv = normal_pair(dr.at(r + 2), dr.at(r + 3));
            float2 q = normal_pair(dr.at(r + 4), dr.at(r + 5));
            if constexpr (Mix::mixes) mix.heston(t2, z, q);
            float* const b = out + (long long)(2 * t2 - t0) * step;
            heston_bar(a, s, log_s, 2 * t2, z.x, zv.x, q.x, dr.at(r + 6), dr.at(r + 7), carry, b,
                       plane);
            if (PAIRS || 2 * t2 + 1 < t1)
                heston_bar(a, s, log_s, 2 * t2 + 1, z.y, zv.y, q.y, dr.at(r + 9), dr.at(r + 10),
                           carry, b + step, plane);
        }
    }
}

// make_bars with the draws as drawn.
template <int KIND, bool PAIRS>
__device__ __forceinline__ void make_bars(const EngineArgs& a, const SamplerArgs& s, Draws& dr,
                                          float& log_s, float& carry, int t0, const int& t1,
                                          float* out, int step, int plane) {
    BarsAsDrawn as_drawn;
    make_bars<KIND, PAIRS>(a, s, dr, log_s, carry, t0, t1, out, step, plane, as_drawn);
}
