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
// (pallas_engine.py:1296-1334).  Rows as in the parent (blockIdx.y: a
// configuration, grid row, symbol or cell, each reading its own table and
// its own row of the [rows, max_levels] level table).
//
// Design: the parent's path loop and reduction (cta_add_path_row, chunk by
// chunk) as its own text (mc_engine_sampler_block.cuh), so at <= 8 levels and
// an even W <= 61 it equals the parent bit for bit, on mc_engine_wide.cuh's
// levels, state and guard; an odd W ends with one bar after the pair loop
// (mc_engine_sampler_block.cuh).
//
// What bounds it on the H100: the parent sampler kernel's work (special
// functions and the per-bar gates; recorded bars' gathers from tables in L2)
// plus the level loops over per-level state in local memory and, windowed,
// two 61-float folds a bar.  This source is a library of its own.

#include "mc_engine_wide.cuh"

// Every path of row blockIdx.y of ``args`` / ``sargs`` with its levels (row
// blockIdx.y of ``levels``), a thread a path in chunks of BLOCK: partial rows
// [row][CTA], per-path rows [row][path] when per_path is not null
// (mc_engine_sampler_block.cuh).
template <bool WIN, int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_engine_wide_sampler_kernel(const EngineArgs* __restrict__ args,
                              const SamplerArgs* __restrict__ sargs,
                              const WideLevel* __restrict__ levels,
                              const float* __restrict__ ext,
                              long long* __restrict__ part_counts,
                              float* __restrict__ part_floats, float* __restrict__ per_path) {
#include "mc_engine_sampler_block.cuh"
}

extern "C" {

int qmmx_engine_wide_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 of the n_rows rows at ``args`` and ``sargs`` with their [n_rows,
// max_levels] level table ``levels`` (device memory) under sampler ``kind``
// (SAMPLER_RESAMPLE or SAMPLER_HESTON), 1 <= max_levels <= 64; the windowed
// guard when num_bars > 61; ext and per_path null when not used; partial
// rows [row][CTA].  Returns cudaGetLastError().
int qmmx_mc_engine_wide_sampler(const EngineArgs* args, const SamplerArgs* sargs,
                                const WideLevel* levels, int n_rows, int kind,
                                int max_levels, int num_bars, const float* ext,
                                long long* part_counts, float* part_floats, float* per_path,
                                int grid, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (max_levels < 1 || max_levels > WIDE_LEVELS || num_bars < 2 || n_rows < 1
        || n_rows > 65535
        || (kind != SAMPLER_RESAMPLE && kind != SAMPLER_HESTON))
        return (int)cudaErrorInvalidValue;
    const dim3 g(grid, n_rows);
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        constexpr bool WIN = decltype(win)::value;
        if (kind == SAMPLER_RESAMPLE)
            mc_engine_wide_sampler_kernel<WIN, SAMPLER_RESAMPLE><<<g, BLOCK, 0, st>>>(
                args, sargs, levels, ext, part_counts, part_floats, per_path);
        else
            mc_engine_wide_sampler_kernel<WIN, SAMPLER_HESTON><<<g, BLOCK, 0, st>>>(
                args, sargs, levels, ext, part_counts, part_floats, per_path);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
