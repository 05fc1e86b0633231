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
// the symbol's bars are the parents' walks (mc_engine_book_walk.cuh,
// mc_engine_book_sampler_walk.cuh) on mc_engine_env.cuh's state and bar
// steps; its weighted post-bar equity goes into the path's book curve (device
// memory, W floats a path); after the last symbol the curve is folded and the
// book added to one more partial row.  Under gbm the market pair mixes into
// the price normal before the volume model (bk.market); under the samplers
// the market stream carries the joint recorded day's index (bootstrap, the
// symbol's ties on its rows 0, 1) or Heston's market pairs (4 rows a step),
// as in mc_engine_corr_samplers.cu.  At <= 8 levels and W <= 61 each symbol and
// the book equal the parent's bit for bit.
//
// Design: mc_engine_env.cuh's (its notes), with what a book adds.
// * The flags and contact counts in the CTA's dynamic shared memory beside
//   the rings, the touch registers and the guard's rings in the device
//   scratch of the resident threads; each symbol's walk clears the thread's
//   flag words, counts and rings (env_init_state), not the scratch: a touch
//   register counts only under its flag, a guard slot is read only after its
//   bar wrote it.
// * A persistent grid: the launch's CTAs take the book's cells (the CTAs of
//   the [S + 1, grid] partial rows) from a counter, so a thread owns its
//   scratch for the launch; a cell's paths, chunks and reduction are those of
//   the CTA that took it before, so its partial rows do not depend on which
//   CTA took it.  A thread's book curve lies at its resident index (a stride
//   of the launch's threads), so book_fold reads the path's values in bar
//   order as before.
// * Between the barriers that load symbol s's arguments the CTA also copies
//   its level row to the head of the dynamic shared memory.
//
// What bounds it on the H100: S times one symbol's envelope engine (the
// special functions and the per-bar gates, the level loops over the flags in
// shared memory, the windowed guard's block passes in L2) plus the market
// draws, counted once a path.
//
// The harvest builds (ENGINE_HARVEST: mc_engine_wide_corr{,_samplers}_harvest.cu)
// name the kernel mc_engine_wide_corr_harvest_kernel and give it two more
// outputs: symbol s's closed-trade harvest, a partial row per (symbol, CTA)
// (HV_COUNTS int64 counts, HV_SUMS floats), added chunk by chunk as the
// lifecycle rows are (the book's own row has none).  Each symbol clears the
// CTA's tallies between the barriers that load its arguments.

#pragma once

#include "mc_engine_env.cuh"

// CTAs of ENV_THREADS an SM whose registers the books leave room for
// (__launch_bounds__): 4 (64 registers, 1024 threads an SM; four fit the
// shared memory up to 40 levels).  Of 128 / 80 / 64 registers 64 ran
// fastest on the H100 under gbm and the samplers alike (PERF.md,
// chip_smoke.py --envelope-times --min-blocks).
#define ENV_BOOK_MIN_BLOCKS 4

#ifdef ENGINE_HARVEST
#define WIDE_CORR_KERNEL mc_engine_wide_corr_harvest_kernel
#else
#define WIDE_CORR_KERNEL mc_engine_wide_corr_kernel
#endif

// the book walks shared with the parents take env's bar steps and scratch
#undef ENGINE_FN
#undef ENGINE_LV
#undef ENGINE_RG
#define ENGINE_FN(f) env_##f<WIN>
#define ENGINE_LV
#define ENGINE_RG scratch

// A book launch's pointers and shape (the kernel's one parameter).
struct EnvBook {
    const EngineArgs* args;       // [n_sym]
    const SamplerArgs* sargs;     // [n_sym], the samplers only
    const WideLevel* levels;      // [n_sym, max_levels]
    const float2* bw;             // [n_sym] (beta, weight)
    const float* ext;             // the symbols' injected uniforms, or null (Philox)
    const float* ext_m;           // the market's, or null (Philox on m_stream)
    float* curve;                 // the book curves: W x the launch's threads
    long long* part_counts;       // [n_sym + 1, grid, ROW_COUNTS]
    float* part_floats;           // [n_sym + 1, grid, ROW_FLOATS]
    float* per_path;              // [n_sym + 1, num_paths, PATH_COLS], or null
    long long* hv_counts;         // [n_sym, grid, HV_COUNTS], the harvest builds only
    float* hv_sums;               // [n_sym, grid, HV_SUMS]
    float* scratch;               // [env_scratch_slots][gridDim.x * ENV_THREADS]
    int* next;                    // the next cell, zeroed before the launch
    uint32_t m_stream;            // the market's Philox stream
    int n_sym, grid;              // the cells: the grid's CTAs
};

// One path of a book under symbol arguments ``a`` (and sampler ``s``): its
// draws on the symbol's key (dr) and, under a sampler, the market's (md);
// under gbm the market pair of bk, the antithetic mirror of column col -
// half_lanes; the post-bar equity into the book curve after every bar.  The
// bars are the parents' walks on env's state and bar steps (``scratch``:
// this thread's first scratch slot).
template <bool WIN, int KIND>
__device__ __forceinline__ void env_book_walk(const EngineArgs& a, const SamplerArgs& s,
                                              Draws& dr, Draws& md, float* scratch, int col,
                                              bool mirror, int half_lanes, EnvState& st,
                                              const BookPath& bk) {
    env_init_state(a, st);
    if constexpr (KIND == ENV_GBM) {
#include "mc_engine_book_walk.cuh"
    } else {
#include "mc_engine_book_sampler_walk.cuh"
    }
}

// The book: this CTA takes cells (a CTA index of the [S + 1, grid] partial
// rows) from p.next until none is left; a cell's paths (the cell x the
// CTA's threads, a stride of grid x threads), in chunks of a path a thread,
// walk every symbol; each symbol's path joins its partial row and the book's
// after the last.  Per-path rows [S + 1][path].
template <bool WIN, int KIND>
__global__ void __launch_bounds__(ENV_THREADS, ENV_BOOK_MIN_BLOCKS)
WIDE_CORR_KERNEL(const EnvBook p) {
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ float2 s_bw;        // symbol s's (beta, weight)
    __shared__ int s_cell;
#ifdef ENGINE_HARVEST
    __shared__ unsigned long long s_hv[HV_COUNTS];
#endif
    const int nt = ENV_THREADS, tid = threadIdx.x;
    float* const scratch = p.scratch + (long long)blockIdx.x * nt + tid;
    const EngineArgs* const rows = p.args;
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int max_levels = rows[0].max_levels;
    const int row_len = ENGINE_SUB * lanes, half_lanes = lanes >> 1;
    const int m_rows = (KIND == SAMPLER_HESTON ? 2 : 1) * num_bars;   // market rows a block
    const long long stride = (long long)p.grid * nt;
    BookPath bk;
    bk.md = MarketDraws{p.ext_m, 0, row_len, num_bars, rows[0].seed, p.m_stream};
    bk.curve = p.curve + (long long)blockIdx.x * nt + tid;
    bk.cstride = (int)(gridDim.x * nt);

    for (;;) {
        __syncthreads();                 // the last cell's readers are done
        if (tid == 0) s_cell = atomicAdd(p.next, 1);
        __syncthreads();
        const int bx = s_cell;
        if (bx >= p.grid) break;
        // every thread runs the same number of chunks (num_paths is a
        // multiple of ENV_THREADS), so the CTA's barriers line up
        int chunk = 0;
        for (long long base = (long long)bx * nt; base < num_paths; base += stride, ++chunk) {
            const long long q = base + tid;
            const long long blk = q / row_len;
            const int col = (int)(q - blk * row_len);
            bk.md.blk = blk;
            bk.col = col;
            bk.partner = col - half_lanes;
            bk.mirror = KIND == ENV_GBM && rows[0].antithetic && (col % lanes) >= half_lanes;
            for (int t = 0; t < num_bars; ++t) bk.curve[(long long)t * bk.cstride] = 0.f;
            int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;

            for (int sym = 0; sym < p.n_sym; ++sym) {
                __syncthreads();
                if (tid == 0) {
                    s_a = rows[sym];
                    if (KIND != ENV_GBM) s_s = p.sargs[sym];
                    s_bw = p.bw[sym];
                }
                copy_levels((WideLevel*)env_smem, p.levels, sym, max_levels);
#ifdef ENGINE_HARVEST
                hv_clear(s_hv);
#endif
                __syncthreads();
                const EngineArgs& a = s_a;
                bk.beta = s_bw.x;
                bk.perp = BookPath::perp_of(s_bw.x);
                bk.weight = s_bw.y;
                Draws dr{p.ext ? p.ext + a.ext_offset : nullptr, blk, col, row_len, a.u_rows,
                         a.seed, a.stream, -1, make_uint4(0u, 0u, 0u, 0u)};
                Draws md{p.ext_m, blk, col, row_len, m_rows, a.seed, p.m_stream, -1,
                         make_uint4(0u, 0u, 0u, 0u)};
                EnvState st;
#ifdef ENGINE_HARVEST
                st.hv_cnt = s_hv;
#endif
                env_book_walk<WIN, KIND>(a, s_s, dr, md, scratch, col, bk.mirror, half_lanes,
                                         st, bk);

                b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
                b_open |= st.side != 0;
                const bool entered = st.trades > 0;
                int cnt[N_COUNTS + N_SKIPS] = {1, entered, st.wins, st.losses, st.side != 0,
                                               st.trades, st.escal};
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
                if (p.per_path)
                    env_path_row(st, p.per_path + ((long long)sym * num_paths + q) * PATH_COLS);
                const long long seg = (long long)sym * p.grid + bx;
                env_add_path_row(cnt, entered, st.equity, st.dd, p.part_counts + seg * ROW_COUNTS,
                                 p.part_floats + seg * ROW_FLOATS, chunk == 0);
#ifdef ENGINE_HARVEST
                hv_cta_row(s_hv, st.hv_sum, p.hv_counts + seg * HV_COUNTS,
                           p.hv_sums + seg * HV_SUMS, chunk == 0);
#endif
            }

            const float2 fin = book_fold(bk.curve, bk.cstride, num_bars);   // (final R, drawdown)
            const bool entered = b_trades > 0;
            const int cnt[N_COUNTS + N_SKIPS] = {1, entered, b_wins, b_losses, b_open, b_trades};
            const long long seg = (long long)p.n_sym * p.grid + bx;
            env_add_path_row(cnt, entered, fin.x, fin.y, p.part_counts + seg * ROW_COUNTS,
                             p.part_floats + seg * ROW_FLOATS, chunk == 0);
            if (p.per_path) {
                float* o = p.per_path + ((long long)p.n_sym * num_paths + q) * PATH_COLS;
                o[0] = fin.x; o[1] = (float)b_trades; o[2] = (float)b_wins;
                o[3] = (float)b_losses; o[4] = (float)b_open; o[5] = fin.y;
#pragma unroll
                for (int j = 6; j < PATH_COLS; ++j) o[j] = 0.f;
            }
        }
    }
}

// The host's checks and launch of the book under KIND (ENV_GBM,
// SAMPLER_RESAMPLE or SAMPLER_HESTON), 1 <= max_levels <= 64, an even W; the
// windowed guard when num_bars > 61.  Returns the first CUDA error.
template <int KIND>
int wide_corr_launch(const EnvBook& p, int max_levels, int num_bars, int scratch_ctas,
                     void* stream) {
    if (!env_shape_ok(1, max_levels, num_bars, p.grid) || (num_bars & 1) || p.n_sym < 1
        || !p.curve)
        return (int)cudaErrorInvalidValue;
    return wide_dispatch(num_bars > GUARD_WINDOW, [&](auto win) {
        return env_launch_cells(WIDE_CORR_KERNEL<decltype(win)::value, KIND>, p, p.grid,
                                max_levels, scratch_ctas, (cudaStream_t)stream);
    });
}
