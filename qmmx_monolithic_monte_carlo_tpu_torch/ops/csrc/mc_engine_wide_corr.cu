// The engine's correlated book under gbm over the engine's envelope: the
// kernel mc_engine_wide_corr_kernel<WIN, ENV_GBM> of
// mc_engine_wide_corr.cuh (its notes: what it replaces, its design, what bounds
// it), for up to 64 levels and an even W past 61 bars, with execution noise
// and antithetic book pairs.  A library of its own, so the parent book kernel
// (mc_engine_corr.cu) keeps its code.

#include "mc_engine_wide_corr.cuh"

extern "C" {

// The book: n_sym argument rows at ``rows``, their [n_sym, max_levels] level
// table at ``levels`` and (beta, weight) pairs at ``bw`` (device memory), at
// 1 <= max_levels <= 64; one partial row per (symbol, CTA) and
// per (book, CTA); the book curves at curve_mem (num_bars x grid x BLOCK
// floats of device memory); the threads' scratch (env_scratch_slots a
// thread) at ``scratch`` for ``scratch_ctas`` CTAs, ``next`` an int of
// device memory.  ext / ext_m and per_path may be null.  Returns the first
// CUDA error.
int qmmx_mc_engine_wide_corr(const EngineArgs* rows, const WideLevel* levels, const float2* bw,
                             int n_sym, int max_levels, int num_bars,
                             const float* ext, const float* ext_m, unsigned m_stream,
                             float* curve_mem, long long* part_counts, float* part_floats,
                             float* per_path, int grid, float* scratch, int scratch_ctas,
                             int* next, void* stream) {
    const EnvBook p{rows, nullptr, levels, bw, ext, ext_m, curve_mem, part_counts, part_floats,
                    per_path, nullptr, nullptr, scratch, next, m_stream, n_sym, grid};
    return wide_corr_launch<ENV_GBM>(p, max_levels, num_bars, scratch_ctas, stream);
}

}  // extern "C"
