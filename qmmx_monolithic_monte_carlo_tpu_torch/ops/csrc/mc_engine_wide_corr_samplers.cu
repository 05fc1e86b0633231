// The engine's correlated book under the recorded-bar and Heston samplers
// over the engine's envelope: the kernels mc_engine_wide_corr_kernel<WIN,
// SAMPLER_RESAMPLE | SAMPLER_HESTON> of mc_engine_wide_corr.cuh (its
// notes: what they replace, their design, what bounds them), for up to 64
// levels and an even W past 61 bars, with execution noise.  A library of its
// own, so the parent book sampler kernel (mc_engine_corr_samplers.cu) keeps its
// code.

#include "mc_engine_wide_corr.cuh"

extern "C" {

int qmmx_engine_wide_corr_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// The book under sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON):
// n_sym argument rows at ``rows``, sampler rows at ``sargs``, their [n_sym,
// max_levels] level table at ``levels`` and (beta, weight) pairs at ``bw``
// (device memory), 1 <= max_levels <= 64; partial rows, curves and the
// scratch as qmmx_mc_engine_wide_corr's.  Returns the first CUDA error.
int qmmx_mc_engine_wide_corr_sampler(const EngineArgs* rows, const SamplerArgs* sargs,
                                     const WideLevel* levels, const float2* bw, int n_sym,
                                     int kind, int max_levels, int num_bars,
                                     const float* ext, const float* ext_m, unsigned m_stream,
                                     float* curve_mem, long long* part_counts,
                                     float* part_floats, float* per_path, int grid,
                                     float* scratch, int scratch_ctas, int* next,
                                     void* stream) {
    const EnvBook p{rows, sargs, levels, bw, ext, ext_m, curve_mem, part_counts, part_floats,
                    per_path, nullptr, nullptr, scratch, next, m_stream, n_sym, grid};
    if (kind == SAMPLER_RESAMPLE)
        return wide_corr_launch<SAMPLER_RESAMPLE>(p, max_levels, num_bars, scratch_ctas, stream);
    if (kind == SAMPLER_HESTON)
        return wide_corr_launch<SAMPLER_HESTON>(p, max_levels, num_bars, scratch_ctas, stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
