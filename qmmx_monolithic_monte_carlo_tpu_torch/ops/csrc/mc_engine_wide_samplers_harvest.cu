// The full engine Monte Carlo on Hopper under the recorded-bar and Heston
// samplers with the closed-trade label harvest, over the engine's envelope.
//
// mc_engine_wide_sampler_harvest_kernel replaces the use_harvest branches
// (pallas_engine.py:1437, :2120) of the TPU kernels _engine_kernel (#8) and
// _engine_universe_kernel (#10) under "bootstrap", "block_bootstrap" and
// "heston": mc_engine_wide_samplers.cu's kernel built with ENGINE_HARVEST
// (mc_engine_wide.cuh's notes; the path loop mc_engine_sampler_block.cuh),
// which also writes each row's harvest partial row [row][CTA] after its last
// chunk.  Design and bound: mc_engine_wide_harvest.cu's notes on
// mc_engine_wide_samplers.cu's work.  Its rows fold with
// qmmx_mc_engine_harvest_reduce_rows (mc_engine_wide_harvest.cu).  A library
// of its own.

#define ENGINE_HARVEST
#include "mc_engine_wide.cuh"

// Every path of row blockIdx.y of ``args`` / ``sargs`` with its levels:
// lifecycle and harvest partial rows [row][CTA], per-path rows [row][path]
// when per_path is not null (mc_engine_sampler_block.cuh).
template <bool WIN, int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_engine_wide_sampler_harvest_kernel(const EngineArgs* __restrict__ args,
                                      const SamplerArgs* __restrict__ sargs,
                                      const WideLevel* __restrict__ levels,
                                      const float* __restrict__ ext,
                                      long long* __restrict__ part_counts,
                                      float* __restrict__ part_floats,
                                      float* __restrict__ per_path,
                                      long long* __restrict__ hv_counts,
                                      float* __restrict__ hv_sums) {
#include "mc_engine_sampler_block.cuh"
}

extern "C" {

int qmmx_engine_wide_sampler_harvest_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 as qmmx_mc_engine_wide_sampler's, with the harvest partial rows
// [row][CTA] at hv_counts and hv_sums.  Returns cudaGetLastError().
int qmmx_mc_engine_wide_sampler_harvest(const EngineArgs* args, const SamplerArgs* sargs,
                                        const WideLevel* levels, int n_rows, int kind,
                                        int max_levels, int num_bars, const float* ext,
                                        long long* part_counts, float* part_floats,
                                        float* per_path, long long* hv_counts, float* hv_sums,
                                        int grid, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (max_levels < 1 || max_levels > WIDE_LEVELS || num_bars < 2 || n_rows < 1
        || n_rows > 65535 || !hv_counts || !hv_sums
        || (kind != SAMPLER_RESAMPLE && kind != SAMPLER_HESTON))
        return (int)cudaErrorInvalidValue;
    const dim3 g(grid, n_rows);
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        constexpr bool WIN = decltype(win)::value;
        if (kind == SAMPLER_RESAMPLE)
            mc_engine_wide_sampler_harvest_kernel<WIN, SAMPLER_RESAMPLE><<<g, BLOCK, 0, st>>>(
                args, sargs, levels, ext, part_counts, part_floats, per_path, hv_counts,
                hv_sums);
        else
            mc_engine_wide_sampler_harvest_kernel<WIN, SAMPLER_HESTON><<<g, BLOCK, 0, st>>>(
                args, sargs, levels, ext, part_counts, part_floats, per_path, hv_counts,
                hv_sums);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
