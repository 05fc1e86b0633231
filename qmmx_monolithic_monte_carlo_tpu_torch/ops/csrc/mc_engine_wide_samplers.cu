// The full engine Monte Carlo on Hopper under the recorded-bar and Heston
// samplers, over the engine's whole envelope: 1-64 level slots, any horizon
// W >= 2, horizons past the guard's 61-bar window.
//
// mc_engine_wide_sampler_kernel replaces the sampler branches ("bootstrap",
// "block_bootstrap", "heston") of the TPU kernels
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_kernel,
// _engine_sweep_kernel, _engine_universe_kernel and
// _engine_universe_sweep_kernel that the parent mc_engine_sampler_kernel
// (mc_engine_samplers.cu: <= 8 levels, an even W <= 61) does not take: up to
// 64 levels, the windowed guard past 61 bars and an odd W's final half step
// (pallas_engine.py:1296-1334).  Rows as in the parent (a configuration,
// grid row, symbol or cell, each reading its own table and its own row of the
// [rows, max_levels] level table); every path equals the parent's where both
// fit.
//
// Design: mc_engine_env.cuh's, as mc_engine_wide.cu, the bars of the
// samplers' walk (env_walk): the bootstrap samplers' index and tie rows,
// Heston's price, volume and variance pairs.
//
// What bounds it on the H100: the parent sampler kernel's work (special
// functions and the per-bar gates; recorded bars' gathers from tables in L2)
// plus the level loops (mc_engine_wide.cu's notes).  This source is a
// library of its own.

#include "mc_engine_env.cuh"

template <bool WIN, int KIND>
__global__ void __launch_bounds__(ENV_THREADS, ENV_SAMPLER_MIN_BLOCKS)
mc_engine_wide_sampler_kernel(const EnvLaunch p) {
    env_rows<WIN, KIND>(p);
}

extern "C" {

int qmmx_engine_wide_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 of the n_rows rows at ``args`` and ``sargs`` with their [n_rows,
// max_levels] level table ``levels`` (device memory) under sampler ``kind``
// (SAMPLER_RESAMPLE or SAMPLER_HESTON), 1 <= max_levels <= 64; the cells,
// the scratch and ``next`` as qmmx_mc_engine_wide_sweep's; ext and
// per_path null when not used; partial rows [row][CTA].  Returns the first
// CUDA error.
int qmmx_mc_engine_wide_sampler(const EngineArgs* args, const SamplerArgs* sargs,
                                const WideLevel* levels, int n_rows, int kind,
                                int max_levels, int num_bars, const float* ext,
                                long long* part_counts, float* part_floats, float* per_path,
                                int grid, float* scratch, int scratch_ctas,
                                int* next, void* stream) {
    const bool win = num_bars > GUARD_WINDOW;
    if (!env_shape_ok(n_rows, max_levels, num_bars, grid)
        || (kind != SAMPLER_RESAMPLE && kind != SAMPLER_HESTON))
        return (int)cudaErrorInvalidValue;
    const EnvLaunch p{args, sargs, levels, ext, part_counts, part_floats, per_path,
                      nullptr, nullptr, scratch, next, grid, n_rows};
    const cudaStream_t st = (cudaStream_t)stream;
    return wide_dispatch(win, [&](auto w) {
        constexpr bool WIN = decltype(w)::value;
        return kind == SAMPLER_RESAMPLE
            ? env_launch(mc_engine_wide_sampler_kernel<WIN, SAMPLER_RESAMPLE>, p, max_levels,
                         scratch_ctas, st)
            : env_launch(mc_engine_wide_sampler_kernel<WIN, SAMPLER_HESTON>, p, max_levels,
                         scratch_ctas, st);
    });
}

}  // extern "C"
