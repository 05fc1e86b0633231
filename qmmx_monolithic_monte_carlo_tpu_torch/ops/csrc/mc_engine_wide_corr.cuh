// The engine's correlated book over its envelope (1-64 level slots, an even
// horizon past the guard's 61-bar window, pallas_engine.py:3064-3072), under
// gbm (mc_engine_wide_corr.cu) or the recorded-bar and Heston samplers
// (mc_engine_wide_corr_samplers.cu): the kernel template the two sources
// instantiate, each a library of its own.
//
// mc_engine_wide_corr_kernel<WIN, KIND> replaces the branches of the TPU
// kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py
// _engine_corr_kernel (#12) that the parent book kernels (mc_engine_corr.cu,
// mc_engine_corr_samplers.cu: <= 8 levels, W <= 61) do not take.  It is the
// parents' structure, symbol by symbol and bar by bar (their notes): one
// thread a path walks every symbol in order; the CTA copies symbol s's
// EngineArgs, its level row (row s of the [S, max_levels] table), its
// SamplerArgs and its (beta, weight) into shared memory between two barriers;
// the symbol's engine runs on mc_engine_wide.cuh's levels, state and guard,
// its bars the parents' walks (mc_engine_book_walk.cuh,
// mc_engine_book_sampler_walk.cuh);
// its weighted post-bar equity goes into the path's book curve (device
// memory, W floats a path); after the last symbol the curve is folded and the
// book added to one more partial row.  Under gbm the market pair mixes into
// the price normal before the volume model (bk.market); under the samplers
// the market stream carries the joint recorded day's index (bootstrap, the
// symbol's ties on its rows 0, 1) or Heston's market pairs (4 rows a step),
// as in mc_engine_corr_samplers.cu.  At <= 8 levels and W <= 61 each symbol and
// the book equal the parent's bit for bit.
//
// What bounds it on the H100: S times one symbol's envelope engine (the
// special functions and the per-bar gates, the level loops over local-memory
// state, the windowed guard's folds) plus the market draws, counted once a
// path.  Three CTAs an SM, as the parents (__launch_bounds__(BLOCK, 3)).

#pragma once

#include "mc_engine_wide.cuh"

#define WIDE_GBM 0            // KIND of the gbm book (sampler.cuh numbers the others)

// One path of a book under symbol arguments ``a`` (and sampler ``s``), its
// levels ``lv``: its draws on the symbol's key (dr) and, under a sampler, the
// market's (md); under gbm the market pair of bk, the antithetic mirror of
// column col - half_lanes; the post-bar equity into the book curve after
// every bar.  The bars are the parents' walks (mc_engine_book_walk.cuh,
// mc_engine_book_sampler_walk.cuh) on the envelope's state and bar steps.
template <bool WIN, int KIND>
__device__ __forceinline__ void wide_walk(const EngineArgs& a, const SamplerArgs& s,
                                          const WideLevel* lv, Draws& dr, Draws& md,
                                          const Rings& rg, int col, bool mirror, int half_lanes,
                                          WideState<WIN>& st, const BookPath& bk) {
    wide_init_state<WIN>(a, st, rg);
    if constexpr (KIND == WIDE_GBM) {
#include "mc_engine_book_walk.cuh"
    } else {
#include "mc_engine_book_sampler_walk.cuh"
    }
}

// A correlated book of n_sym symbols: rows[s], levels row s, sargs[s] (under
// a sampler) and bw[s] are symbol s's; ext / ext_m the injected idiosyncratic
// and market rows (or null: Philox, the market's on m_stream); the book
// curves at curve_mem (W floats a path, a stride of gridDim.x x BLOCK apart).
// Partial rows [S + 1][CTA]; per-path rows [S + 1][path].
template <bool WIN, int KIND>
__global__ void __launch_bounds__(BLOCK, 3)
mc_engine_wide_corr_kernel(const EngineArgs* __restrict__ rows,
                           const SamplerArgs* __restrict__ sargs,
                           const WideLevel* __restrict__ levels,
                           const float2* __restrict__ bw, int n_sym,
                           const float* __restrict__ ext, const float* __restrict__ ext_m,
                           uint32_t m_stream, float* __restrict__ curve_mem,
                           long long* __restrict__ part_counts,
                           float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ float2 s_bw;        // symbol s's (beta, weight)
    __shared__ WideLevel s_lv[WIDE_LEVELS];
    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int max_levels = rows[0].max_levels;
    const int row_len = ENGINE_SUB * lanes, half_lanes = lanes >> 1;
    const int m_rows = (KIND == SAMPLER_HESTON ? 2 : 1) * num_bars;   // market rows a block
    const long long stride = (long long)gridDim.x * BLOCK;
    BookPath bk;
    bk.md = MarketDraws{ext_m, 0, row_len, num_bars, rows[0].seed, m_stream};
    bk.curve = curve_mem + (long long)blockIdx.x * BLOCK + threadIdx.x;
    bk.cstride = (int)stride;

    // every thread runs the same number of chunks (num_paths is a multiple
    // of BLOCK), so the CTA's barriers line up
    int chunk = 0;
    for (long long base = (long long)blockIdx.x * BLOCK; base < num_paths;
         base += stride, ++chunk) {
        const long long p = base + threadIdx.x;
        const long long blk = p / row_len;
        const int col = (int)(p - blk * row_len);
        bk.md.blk = blk;
        bk.col = col;
        bk.partner = col - half_lanes;
        bk.mirror = KIND == WIDE_GBM && rows[0].antithetic && (col % lanes) >= half_lanes;
        for (int t = 0; t < num_bars; ++t) bk.curve[(long long)t * bk.cstride] = 0.f;
        int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;

        for (int sym = 0; sym < n_sym; ++sym) {
            __syncthreads();
            if (threadIdx.x == 0) {
                s_a = rows[sym];
                if (KIND != WIDE_GBM) s_s = sargs[sym];
                s_bw = bw[sym];
            }
            copy_levels(s_lv, levels, sym, max_levels);
            __syncthreads();
            const EngineArgs& a = s_a;
            bk.beta = s_bw.x;
            bk.perp = BookPath::perp_of(s_bw.x);
            bk.weight = s_bw.y;
            Draws dr{ext ? ext + a.ext_offset : nullptr, blk, col, row_len, a.u_rows, a.seed,
                     a.stream, -1, make_uint4(0u, 0u, 0u, 0u)};
            Draws md{ext_m, blk, col, row_len, m_rows, a.seed, m_stream, -1,
                     make_uint4(0u, 0u, 0u, 0u)};
            WideState<WIN> st;
            wide_walk<WIN, KIND>(a, s_s, s_lv, dr, md, rg, col, bk.mirror, half_lanes, st,
                                       bk);

            b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
            b_open |= st.side != 0;
            int cnt[N_COUNTS + N_SKIPS];
            wide_path_row<WIN>(st, true, cnt,
                                     per_path ? per_path + ((long long)sym * num_paths + p)
                                                           * PATH_COLS
                                              : nullptr);
            const long long seg = (long long)sym * gridDim.x + blockIdx.x;
            cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, st.trades > 0, st.equity, st.dd,
                                                 part_counts + seg * ROW_COUNTS,
                                                 part_floats + seg * ROW_FLOATS, chunk == 0);
        }

        const float2 fin = book_fold(bk.curve, bk.cstride, num_bars);   // (final R, drawdown)
        const bool entered = b_trades > 0;
        const int cnt[N_COUNTS + N_SKIPS] = {1, entered, b_wins, b_losses, b_open, b_trades};
        const long long seg = (long long)n_sym * gridDim.x + blockIdx.x;
        cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, entered, fin.x, fin.y,
                                             part_counts + seg * ROW_COUNTS,
                                             part_floats + seg * ROW_FLOATS, chunk == 0);
        if (per_path) {
            float* o = per_path + ((long long)n_sym * num_paths + p) * PATH_COLS;
            o[0] = fin.x; o[1] = (float)b_trades; o[2] = (float)b_wins;
            o[3] = (float)b_losses; o[4] = (float)b_open; o[5] = fin.y;
#pragma unroll
            for (int j = 6; j < PATH_COLS; ++j) o[j] = 0.f;
        }
    }
}

// The host's checks and launch of the book under KIND (WIDE_GBM,
// SAMPLER_RESAMPLE or SAMPLER_HESTON), 1 <= max_levels <= 64; the windowed
// guard when num_bars > 61.  Returns cudaGetLastError().
template <int KIND>
int wide_corr_launch(const EngineArgs* rows, const SamplerArgs* sargs, const WideLevel* levels,
                     const float2* bw, int n_sym, int max_levels, int num_bars,
                     const float* ext, const float* ext_m, unsigned m_stream, float* curve_mem,
                     long long* part_counts, float* part_floats, float* per_path, int grid,
                     void* stream) {
    if (max_levels < 1 || max_levels > WIDE_LEVELS || num_bars < 2 || (num_bars & 1) || n_sym < 1
        || !curve_mem)
        return (int)cudaErrorInvalidValue;
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        mc_engine_wide_corr_kernel<decltype(win)::value, KIND>
            <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(rows, sargs, levels, bw, n_sym, ext,
                                                       ext_m, m_stream, curve_mem, part_counts,
                                                       part_floats, per_path);
        return (int)cudaGetLastError();
    });
}
