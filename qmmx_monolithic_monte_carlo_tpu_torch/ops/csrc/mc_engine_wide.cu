// The full 12-gate engine Monte Carlo on Hopper over its whole envelope:
// 1-64 level slots, any horizon W >= 2, horizons past the guard's 61-bar
// window.
//
// mc_engine_wide_kernel replaces the branches of the TPU kernels
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_kernel (#8),
// _engine_sweep_kernel (#9), _engine_universe_kernel (#10) and
// _engine_universe_sweep_kernel (#11) that the parent mc_engine_sweep_kernel
// (mc_engine.cu: <= 8 levels, an even W <= 61) does not take: up to
// MAX_KERNEL_LEVELS = 64 levels (pallas_engine.py:95, the kernel compiled for
// levels.max_levels slots, :250, :302-306), the windowed guard past
// GUARD_WINDOW_BARS = 61 bars (:203, :312-315, :949-953, :983-988) and an odd
// W's final half step (:1296-1334), under gbm with execution noise and
// antithetic lanes.  The rows are the parent's: a single configuration, a
// sweep's grid row, a universe's symbol or a sweep of universes' cell, each
// with its own row of the [rows, max_levels] level table; row r equals the
// one-row launch of its arguments bit for bit, and every path equals the
// parent's where both fit.
//
// Design: mc_engine_env.cuh (the flags and contact counts in shared memory
// sized by the row's slots; the touch registers and the guard's rings in a
// scratch of the resident threads, the guard's box a 61-bar block at a time;
// a persistent grid over the (row, CTA) cells).  The wrapper (ops/cuda_engine.py) launches this kernel only
// where the parent does not fit, or with the checks' hook.
//
// What bounds it on the H100: what bounds the parent (the special functions
// and float32 work of each bar, 3 logf / 3 sqrtf / 4 expf a bar), plus the
// level loops (each runs to the row's slot count: the nearest level every
// bar, the latch, confluence and touch-registration loops where a bar reaches
// them) and their flags in shared memory.  Bytes: its arguments, a partial
// row per cell, and in L2 the touch registers where a touch registers and,
// with the windowed guard, two ring loads and stores a bar (and a 61-slot
// pass every 61 bars).

#include "mc_engine_env.cuh"

template <bool WIN>
__global__ void __launch_bounds__(ENV_THREADS, ENV_MIN_BLOCKS) mc_engine_wide_kernel(const EnvLaunch p) {
    env_rows<WIN, ENV_GBM>(p);
}

extern "C" {

int qmmx_engine_wide_level_size(void) { return (int)sizeof(WideLevel); }

int qmmx_engine_env_smem_bytes(int max_levels, int threads) {
    return env_smem_bytes(max_levels, threads);
}

int qmmx_engine_env_scratch_slots(int max_levels, int windowed) {
    return env_scratch_slots(max_levels, windowed != 0);
}

// Pass 1 of the n_rows argument rows at ``rows`` with their [n_rows,
// max_levels] level table at ``levels`` (device memory), 1 <= max_levels <=
// 64, grid cells a row; the threads' scratch (env_scratch_slots a thread,
// the windowed guard's rings when num_bars > 61) at ``scratch`` for
// ``scratch_ctas`` CTAs; ``next`` an int of device memory.  ext and per_path
// may be null.  The fold is mc_engine.cu's.  Returns the first CUDA error.
int qmmx_mc_engine_wide_sweep(const EngineArgs* rows, const WideLevel* levels, int n_rows,
                              int max_levels, int num_bars, const float* ext,
                              long long* part_counts, float* part_floats, float* per_path,
                              int grid, float* scratch, int scratch_ctas, int* next,
                              void* stream) {
    const bool win = num_bars > GUARD_WINDOW;
    if (!env_shape_ok(n_rows, max_levels, num_bars, grid)) return (int)cudaErrorInvalidValue;
    const EnvLaunch p{rows, nullptr, levels, ext, part_counts, part_floats, per_path,
                      nullptr, nullptr, scratch, next, grid, n_rows};
    return wide_dispatch(win, [&](auto w) {
        return env_launch(mc_engine_wide_kernel<decltype(w)::value>, p, max_levels,
                          scratch_ctas, (cudaStream_t)stream);
    });
}

}  // extern "C"
