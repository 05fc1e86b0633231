// The gated lifecycle's recorded-bar and Heston bar steps, shared by the
// sampler kernels of mc_gated_samplers.cu and the book's of
// mc_gated_corr_samplers.cu (each its own library, so each compiles its own
// copy).  Included after mc_gated.cuh and sampler.cuh.
#pragma once

// One recorded bar t of one path from its index uniform x (``start``
// carries a block's start), then the gated lifecycle (mc_gated_step.cuh) on
// it with the recorded high and low.  Not inlined (common.cuh).
template <int MAXL>
__device__ __noinline__ void resample_bar_step(const GatedArgs& a, const SamplerArgs& s,
                                               GatedState<MAXL>& st, int t, float x,
                                               float tie, float4 nu, float& start) {
    const float idx = resample_index(s, t, x, start);
    const float log_open = st.log_s;
    const float log_close = log_open + table_at(s, CH_LOGC, idx);
    const float c = expf(log_close);
    st.log_s = log_close;
    if (t == 0) st.prev_c = expf(log_open + table_at(s, CH_LOGO, idx));
#define GATED_EXTREMES                                                                  \
    const float high = expf(log_open + table_at(s, CH_LOGH, idx));                      \
    const float low = expf(log_open + table_at(s, CH_LOGL, idx));
#include "mc_gated_step.cuh"
#undef GATED_EXTREMES
}

// One Heston bar t of one path from its price normal z, variance normal zq
// and bridge uniforms u3, u4 (v the variance), then the gated lifecycle
// (mc_gated_step.cuh) on it with the bridge high and low at the bar's
// variance.  Not inlined (common.cuh).
template <int MAXL>
__device__ __noinline__ void heston_bar_step(const GatedArgs& a, const SamplerArgs& s,
                                             GatedState<MAXL>& st, int t, float z, float zq,
                                             float u3, float u4, float tie, float4 nu,
                                             float& v) {
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, v, v_pos);
    const float var = v_pos * s.dt;
    const float log_open = st.log_s;
    const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
    const float c = expf(log_close);
    st.log_s = log_close;
#define GATED_EXTREMES GATED_BRIDGE_EXTREMES(var)
#include "mc_gated_step.cuh"
#undef GATED_EXTREMES
}
