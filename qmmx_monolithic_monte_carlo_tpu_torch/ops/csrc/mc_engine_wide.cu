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
// antithetic lanes.  The rows are the parent's: blockIdx.y a single
// configuration, a sweep's grid row, a universe's symbol or a sweep of
// universes' cell, each with its own row of the [rows, max_levels] level
// table; row r equals the one-row launch of its arguments bit for bit.
//
// Design: the parent's (mc_engine.cu's notes), on mc_engine_wide.cuh's
// levels, state and guard.  The path loop, the reduction (per-thread sums,
// warp shuffles, shared-memory counts) and the per-path rows are
// engine_block's own text (mc_engine_block.cuh), so at <= 8 levels and an even
// W <= 61 this kernel equals the parent bit for bit.  An odd W ends with one
// bar after the pair loop (mc_engine_block.cuh).  The wrapper
// (ops/cuda_engine.py) launches this kernel only where the parent does not
// fit.
//
// What bounds it on the H100: what bounds the parent (the special functions
// and float32 work of each bar, 3 logf / 3 sqrtf / 4 expf a bar), plus the
// level loops (each runs to the row's slot count: the nearest level every
// bar, the latch, confluence and touch-registration loops where a bar reaches
// them) over per-level state in local memory, plus with the windowed guard
// two 61-float folds from local memory a bar.  Bytes stay negligible: it
// reads its arguments and writes a partial row per CTA.

#include "mc_engine_wide.cuh"

// The paths of this CTA under arguments ``a`` and levels ``lv``: the
// engine along each, reduced to one partial row (crow, frow); per-path rows
// at per_path[p] when not null.  The body is engine_block's
// (mc_engine_block.cuh) on the envelope's state and bar step.
template <bool WIN>
__device__ __forceinline__ void wide_block(const EngineArgs& a, const WideLevel* lv,
                                           const float* __restrict__ ext,
                                           long long* __restrict__ crow,
                                           float* __restrict__ frow,
                                           float* __restrict__ per_path) {
#include "mc_engine_block.cuh"
}

// Row blockIdx.y of the grid ``rows`` with its levels (row r of the
// [rows, max_levels] table ``levels``): partial rows [row][CTA], per-path rows
// [row][path].
template <bool WIN>
__global__ void __launch_bounds__(BLOCK)
mc_engine_wide_kernel(const EngineArgs* __restrict__ rows,
                      const WideLevel* __restrict__ levels, const float* __restrict__ ext,
                      long long* __restrict__ part_counts, float* __restrict__ part_floats,
                      float* __restrict__ per_path) {
    __shared__ EngineArgs s_a;
    __shared__ WideLevel s_lv[WIDE_LEVELS];
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    copy_levels(s_lv, levels, blockIdx.y, rows[blockIdx.y].max_levels);
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    wide_block<WIN>(s_a, s_lv, ext ? ext + s_a.ext_offset : nullptr,
                    part_counts + seg * ROW_COUNTS, part_floats + seg * ROW_FLOATS,
                    per_path ? per_path + (long long)blockIdx.y * s_a.num_paths * PATH_COLS
                             : nullptr);
}

extern "C" {

int qmmx_engine_wide_level_size(void) { return (int)sizeof(WideLevel); }

// Pass 1 of the n_rows argument rows at ``rows`` with their [n_rows,
// max_levels] level table at ``levels`` (device memory), 1 <= max_levels <=
// 64; the windowed guard when num_bars > 61.  ext and per_path may be null.
// The fold is mc_engine.cu's.  Returns cudaGetLastError().
int qmmx_mc_engine_wide_sweep(const EngineArgs* rows, const WideLevel* levels, int n_rows,
                              int max_levels, int num_bars, const float* ext,
                              long long* part_counts, float* part_floats, float* per_path,
                              int grid, void* stream) {
    if (max_levels < 1 || max_levels > WIDE_LEVELS || num_bars < 2 || n_rows < 1
        || n_rows > 65535)
        return (int)cudaErrorInvalidValue;
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        mc_engine_wide_kernel<decltype(win)::value>
            <<<dim3(grid, n_rows), BLOCK, 0, (cudaStream_t)stream>>>(
                rows, levels, ext, part_counts, part_floats, per_path);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
