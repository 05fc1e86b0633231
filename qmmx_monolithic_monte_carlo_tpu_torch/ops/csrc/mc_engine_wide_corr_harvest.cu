// The engine's correlated book under gbm with the closed-trade label
// harvest: mc_engine_wide_corr_harvest_kernel<WIN, ENV_GBM>, the kernel of
// mc_engine_wide_corr.cuh built with ENGINE_HARVEST (its notes and
// mc_engine_wide.cuh's), replacing the use_harvest branch of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_corr_kernel
// (#12, :2714, unpacked :2981): each symbol's harvest, a partial row per
// (symbol, CTA).  Its rows fold with qmmx_mc_engine_harvest_reduce_rows
// (mc_engine_wide_harvest.cu).  A library of its own.

#define ENGINE_HARVEST
#include "mc_engine_wide_corr.cuh"

extern "C" {

// The book as qmmx_mc_engine_wide_corr's, with symbol s's harvest partial
// rows [s][CTA] at hv_counts and hv_sums.  Returns the first CUDA error.
int qmmx_mc_engine_wide_corr_harvest(const EngineArgs* rows, const WideLevel* levels,
                                     const float2* bw, int n_sym, int max_levels, int num_bars,
                                     const float* ext, const float* ext_m, unsigned m_stream,
                                     float* curve_mem, long long* part_counts,
                                     float* part_floats, float* per_path, long long* hv_counts,
                                     float* hv_sums, int grid, float* scratch, int scratch_ctas,
                                     int* next, void* stream) {
    if (!hv_counts || !hv_sums) return (int)cudaErrorInvalidValue;
    const EnvBook p{rows, nullptr, levels, bw, ext, ext_m, curve_mem, part_counts, part_floats,
                    per_path, hv_counts, hv_sums, scratch, next, m_stream, n_sym, grid};
    return wide_corr_launch<ENV_GBM>(p, max_levels, num_bars, scratch_ctas, stream);
}

}  // extern "C"
