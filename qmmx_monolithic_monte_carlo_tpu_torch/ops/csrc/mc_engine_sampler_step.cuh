// The full engine's path initialisation and its recorded-bar and Heston bar
// steps, shared by the sampler kernels of mc_engine_samplers.cu and the
// book's of mc_engine_corr_samplers.cu (each its own library, so each
// compiles its own copy).  Included after mc_engine.cuh and sampler.cuh.
#pragma once

// A path's engine state at the start of its walk, its rings cleared.
template <int MAXL>
__device__ __forceinline__ void init_state(const EngineArgs& a, EngineState<MAXL>& st,
                                           const Rings& rg) {
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
}

// One recorded bar t of one path from its index uniform x (``start``
// carries a block's start), with its recorded high, low and volume, then the
// engine (mc_engine_step.cuh) on it.  Not inlined (common.cuh).
template <int MAXL>
__device__ __noinline__ void resample_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                               EngineState<MAXL>& st, Draws& dr,
                                               const Rings& rg, int t, float x, float tie,
                                               int noise_row, float& start) {
    const float idx = resample_index(s, t, x, start);
    const float log_open = st.log_s;
    const float log_close = log_open + table_at(s, CH_LOGC, idx);
    const float c = expf(log_close);
    st.log_s = log_close;
    const float h = expf(log_open + table_at(s, CH_LOGH, idx));
    const float l = expf(log_open + table_at(s, CH_LOGL, idx));
    const float v = table_at(s, CH_VOL, idx);
#include "mc_engine_step.cuh"
}

// One Heston bar t of one path from its price normal z, volume normal zv,
// variance normal zq and bridge uniforms u3, u4 (var the variance), with the
// bridge at the bar's variance and the volume model, then the engine
// (mc_engine_step.cuh) on it.  Not inlined (common.cuh).
template <int MAXL>
__device__ __noinline__ void heston_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                             EngineState<MAXL>& st, Draws& dr, const Rings& rg,
                                             int t, float z, float zv, float zq, float u3,
                                             float u4, float tie, int noise_row, float& var) {
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, var, v_pos);
    const float two_s2 = 2.0f * (v_pos * s.dt);
    const float log_open = st.log_s;
    const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
    const float c = expf(log_close);
    st.log_s = log_close;
    ENGINE_BRIDGE(two_s2)
    ENGINE_VOLUME_MODEL
#include "mc_engine_step.cuh"
}
