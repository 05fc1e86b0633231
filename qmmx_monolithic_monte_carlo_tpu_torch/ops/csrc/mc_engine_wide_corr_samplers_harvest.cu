// The engine's correlated book under the recorded-bar and Heston samplers
// with the closed-trade label harvest: mc_engine_wide_corr_harvest_kernel<WIN,
// SAMPLER_RESAMPLE | SAMPLER_HESTON>, the kernels of mc_engine_wide_corr.cuh
// built with ENGINE_HARVEST (its notes and mc_engine_wide.cuh's), replacing
// the use_harvest branch of the TPU kernel pallas_engine.py
// _engine_corr_kernel (#12, :2714) under those samplers.  Its rows fold with
// qmmx_mc_engine_harvest_reduce_rows (mc_engine_wide_harvest.cu).  A library
// of its own.

#define ENGINE_HARVEST
#include "mc_engine_wide_corr.cuh"

extern "C" {

int qmmx_engine_wide_corr_sampler_harvest_args_size(void) { return (int)sizeof(SamplerArgs); }

// The book under sampler ``kind`` as qmmx_mc_engine_wide_corr_sampler's, with
// symbol s's harvest partial rows [s][CTA] at hv_counts and hv_sums.
// Returns the first CUDA error.
int qmmx_mc_engine_wide_corr_sampler_harvest(const EngineArgs* rows, const SamplerArgs* sargs,
                                             const WideLevel* levels, const float2* bw,
                                             int n_sym, int kind, int max_levels, int num_bars,
                                             const float* ext, const float* ext_m,
                                             unsigned m_stream, float* curve_mem,
                                             long long* part_counts, float* part_floats,
                                             float* per_path, long long* hv_counts,
                                             float* hv_sums, int grid, float* scratch,
                                             int scratch_ctas, int* next, void* stream) {
    if (!hv_counts || !hv_sums) return (int)cudaErrorInvalidValue;
    const EnvBook p{rows, sargs, levels, bw, ext, ext_m, curve_mem, part_counts, part_floats,
                    per_path, hv_counts, hv_sums, scratch, next, m_stream, n_sym, grid};
    if (kind == SAMPLER_RESAMPLE)
        return wide_corr_launch<SAMPLER_RESAMPLE>(p, max_levels, num_bars, scratch_ctas, stream);
    if (kind == SAMPLER_HESTON)
        return wide_corr_launch<SAMPLER_HESTON>(p, max_levels, num_bars, scratch_ctas, stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
