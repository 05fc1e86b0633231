// The full engine Monte Carlo on Hopper with the closed-trade label harvest,
// over the engine's whole envelope (1-64 level slots, any horizon W >= 2,
// horizons past the guard's 61-bar window), under gbm.
//
// mc_engine_wide_harvest_kernel replaces the use_harvest branches of the TPU
// kernels qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_kernel
// (#8, :1437) and _engine_universe_kernel (#10, :2120): the engine of
// mc_engine_wide.cu (rows: a single configuration or a universe's symbols)
// that also folds every closed trade, labelled by pnl > 0, into its row's
// harvest (models/harvest.py): 64 ML counts (touch count, kind, side, label),
// 8 policy counts (side, confluence, label) and the policy buckets' sums of
// x1 = min(1, distance) and x6 = min(1, minutes / 390), the features latched
// at the trade's entry (pallas_engine.py:854-858, :910-917, :629-648).
//
// Design: mc_engine_wide.cu's kernel built with ENGINE_HARVEST
// (mc_engine_wide.cuh's notes): the path loop is engine_block's text
// (mc_engine_block.cuh) and the bar step mc_engine_step.cuh with its harvest
// hooks filled, so its lifecycle outputs equal the kernel without harvest bit
// for bit (a harvest changes no trade).  The counts are 64-bit shared-memory
// tallies a CTA (one atomicAdd a close, exact in any order) written as int64
// partial rows; the sums are kept in the path's state (dynamically indexed,
// local memory), added into the thread's 16 floats after each path and
// reduced as the lifecycle sums are: warp shuffles, then the warps in order.
// No float atomics, so two runs agree bit for bit and a universe row equals
// its one-row launch.  The wrapper sends every harvest=True launch here, at
// the parents' shapes too, so the parents and the envelope kernel without
// harvest keep their code.  A source of its own: a library of its own.
//
// What bounds it on the H100: what bounds mc_engine_wide.cu (the special
// functions and per-bar gates) plus, a close, two shared atomics and two
// local-memory adds, and, an entry, four stores: a few per cent of a bar's
// work.  The partial rows add 88 words a CTA.
//
// qmmx_mc_engine_harvest_reduce_rows is its pass 2 (the envelope kernels'
// harvest rows of every source): a fixed-order fold of the partial rows,
// counts in int64 and sums in double.

#define ENGINE_HARVEST
#include "mc_engine_wide.cuh"

// The paths of this CTA under arguments ``a`` and levels ``lv``: the
// engine along each, reduced to one lifecycle partial row (crow, frow) and
// one harvest partial row (hv_crow, hv_frow); per-path rows at per_path[p]
// when not null (mc_engine_block.cuh).
template <bool WIN>
__device__ __forceinline__ void wide_harvest_block(const EngineArgs& a, const WideLevel* lv,
                                                   const float* __restrict__ ext,
                                                   long long* __restrict__ crow,
                                                   float* __restrict__ frow,
                                                   float* __restrict__ per_path,
                                                   long long* __restrict__ hv_crow,
                                                   float* __restrict__ hv_frow) {
#include "mc_engine_block.cuh"
}

// Row blockIdx.y of the grid ``rows`` with its levels: partial rows
// [row][CTA] (lifecycle and harvest), per-path rows [row][path].
template <bool WIN>
__global__ void __launch_bounds__(BLOCK)
mc_engine_wide_harvest_kernel(const EngineArgs* __restrict__ rows,
                              const WideLevel* __restrict__ levels,
                              const float* __restrict__ ext,
                              long long* __restrict__ part_counts,
                              float* __restrict__ part_floats, float* __restrict__ per_path,
                              long long* __restrict__ hv_counts, float* __restrict__ hv_sums) {
    __shared__ EngineArgs s_a;
    __shared__ WideLevel s_lv[WIDE_LEVELS];
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    copy_levels(s_lv, levels, blockIdx.y, rows[blockIdx.y].max_levels);
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    wide_harvest_block<WIN>(s_a, s_lv, ext ? ext + s_a.ext_offset : nullptr,
                            part_counts + seg * ROW_COUNTS, part_floats + seg * ROW_FLOATS,
                            per_path ? per_path + (long long)blockIdx.y * s_a.num_paths * PATH_COLS
                                     : nullptr,
                            hv_counts + seg * HV_COUNTS, hv_sums + seg * HV_SUMS);
}

// Pass 2 of the harvest rows: segment blockIdx.x's ``rows`` partial rows
// folded in row order, counts in int64, sums in double.
__global__ void __launch_bounds__(128)
fold_harvest_rows(const long long* __restrict__ part_counts,
                  const float* __restrict__ part_sums, int rows,
                  long long* __restrict__ tot_counts, double* __restrict__ tot_sums) {
    part_counts += (long long)blockIdx.x * rows * HV_COUNTS;
    part_sums += (long long)blockIdx.x * rows * HV_SUMS;
    for (int col = threadIdx.x; col < HV_COUNTS; col += blockDim.x) {
        long long s = 0;
        for (int r = 0; r < rows; ++r) s += part_counts[(long long)r * HV_COUNTS + col];
        tot_counts[(long long)blockIdx.x * HV_COUNTS + col] = s;
    }
    if (threadIdx.x < HV_SUMS) {
        double s = 0.0;
        for (int r = 0; r < rows; ++r) s += (double)part_sums[(long long)r * HV_SUMS + threadIdx.x];
        tot_sums[(long long)blockIdx.x * HV_SUMS + threadIdx.x] = s;
    }
}

extern "C" {

int qmmx_engine_harvest_cols(void) { return HV_COUNTS * 100 + HV_SUMS; }

// Pass 1 of the n_rows argument rows at ``rows`` with their [n_rows,
// max_levels] level table at ``levels`` (device memory), with the harvest:
// lifecycle partial rows as qmmx_mc_engine_wide_sweep's and harvest partial
// rows [row][CTA] at hv_counts (HV_COUNTS int64) and hv_sums (HV_SUMS
// floats).  ext and per_path may be null.  Returns cudaGetLastError().
int qmmx_mc_engine_wide_harvest(const EngineArgs* rows, const WideLevel* levels, int n_rows,
                                int max_levels, int num_bars, const float* ext,
                                long long* part_counts, float* part_floats, float* per_path,
                                long long* hv_counts, float* hv_sums, int grid, void* stream) {
    if (max_levels < 1 || max_levels > WIDE_LEVELS || num_bars < 2 || n_rows < 1
        || n_rows > 65535 || !hv_counts || !hv_sums)
        return (int)cudaErrorInvalidValue;
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        mc_engine_wide_harvest_kernel<decltype(win)::value>
            <<<dim3(grid, n_rows), BLOCK, 0, (cudaStream_t)stream>>>(
                rows, levels, ext, part_counts, part_floats, per_path, hv_counts, hv_sums);
        return (int)cudaGetLastError();
    });
}

// Pass 2 over ``segments`` segments of ``rows`` harvest partial rows each.
// Returns cudaGetLastError().
int qmmx_mc_engine_harvest_reduce_rows(const long long* part_counts, const float* part_sums,
                                       int rows, int segments, long long* tot_counts,
                                       double* tot_sums, void* stream) {
    fold_harvest_rows<<<segments, 128, 0, (cudaStream_t)stream>>>(part_counts, part_sums, rows,
                                                                  tot_counts, tot_sums);
    return (int)cudaGetLastError();
}

}  // extern "C"
