// The full engine Monte Carlo on Hopper under the recorded-bar and Heston
// samplers with the closed-trade label harvest, over the engine's envelope.
//
// mc_engine_wide_sampler_harvest_kernel replaces the use_harvest branches
// (pallas_engine.py:1437, :2120) of the TPU kernels _engine_kernel (#8) and
// _engine_universe_kernel (#10) under "bootstrap", "block_bootstrap" and
// "heston": mc_engine_wide_samplers.cu's kernel built with ENGINE_HARVEST
// (mc_engine_wide.cuh's and mc_engine_env.cuh's notes), which also writes
// each cell's harvest partial row [row][CTA].  Design and bound: mc_engine_wide_harvest.cu's notes on
// mc_engine_wide_samplers.cu's work.  Its rows fold with
// qmmx_mc_engine_harvest_reduce_rows (mc_engine_wide_harvest.cu).  A library
// of its own.

#define ENGINE_HARVEST
#include "mc_engine_env.cuh"

template <bool WIN, int KIND>
__global__ void __launch_bounds__(ENV_THREADS, ENV_SAMPLER_MIN_BLOCKS)
mc_engine_wide_sampler_harvest_kernel(const EnvLaunch p) {
    env_rows<WIN, KIND>(p);
}

extern "C" {

int qmmx_engine_wide_sampler_harvest_args_size(void) { return (int)sizeof(SamplerArgs); }

// qmmx_mc_engine_wide_sampler's launch with the harvest rows [row][CTA] at
// hv_counts / hv_sums.  Returns the first CUDA error.
int qmmx_mc_engine_wide_sampler_harvest(const EngineArgs* args, const SamplerArgs* sargs,
                                        const WideLevel* levels, int n_rows, int kind,
                                        int max_levels, int num_bars, const float* ext,
                                        long long* part_counts, float* part_floats,
                                        float* per_path, long long* hv_counts, float* hv_sums,
                                        int grid, float* scratch, int scratch_ctas, int* next,
                                        void* stream) {
    const bool win = num_bars > GUARD_WINDOW;
    if (!env_shape_ok(n_rows, max_levels, num_bars, grid) || !hv_counts || !hv_sums
        || (kind != SAMPLER_RESAMPLE && kind != SAMPLER_HESTON))
        return (int)cudaErrorInvalidValue;
    const EnvLaunch p{args, sargs, levels, ext, part_counts, part_floats, per_path,
                      hv_counts, hv_sums, scratch, next, grid, n_rows};
    const cudaStream_t st = (cudaStream_t)stream;
    return wide_dispatch(win, [&](auto w) {
        constexpr bool WIN = decltype(w)::value;
        return kind == SAMPLER_RESAMPLE
            ? env_launch(mc_engine_wide_sampler_harvest_kernel<WIN, SAMPLER_RESAMPLE>, p,
                         max_levels, scratch_ctas, st)
            : env_launch(mc_engine_wide_sampler_harvest_kernel<WIN, SAMPLER_HESTON>, p,
                         max_levels, scratch_ctas, st);
    });
}

}  // extern "C"
