// Correlated-book Monte Carlo on Hopper over the full 12-gate engine under the
// recorded-bar and Heston samplers.
//
// mc_engine_corr_sampler_kernel replaces the sampler branches of the TPU
// kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py
// _engine_corr_kernel (samplers "bootstrap", "block_bootstrap" and "heston",
// pallas_engine.py:332-405 inside _engine_lifecycle_loop) where up to 8
// levels and W <= 61 (mc_engine_wide_corr_samplers.cu takes the rest of the
// envelope).  The structure is
// mc_engine_corr_kernel's (mc_engine_corr.cu): one thread a path walks every
// symbol in order, the CTA copying symbol s's EngineArgs, SamplerArgs and
// (beta, weight) into shared memory between two barriers; the thread runs the
// symbol's engine with its rings in shared memory, adds w_s times the
// post-bar equity into its book curve of W floats (a device-memory buffer, as
// the gbm engine book keeps it) and adds the path to symbol s's partial row;
// after the last symbol it folds the curve and adds the path's book to one
// more partial row (its escalation and skip columns zero), so one fold
// (fold_lifecycle_rows) takes S + 1 segments.
//
// The market stream carries the sampler (ops/draws.MarketLayout), as in
// mc_gated_corr_samplers.cu: under the bootstrap samplers market rows 2 t2
// and 2 t2 + 1 are the index uniforms every symbol shares (joint recorded
// days), each symbol gathering its own table and its recorded volume into
// its volume gates, its ties on its rows 0, 1 (rows 2, 3 unused) and its
// noise from row 4; under Heston market rows 4 t2 .. 4 t2 + 3 are the
// market's price and variance pairs, mixed into the symbol's own (its rows
// 0-1 and 4-5; rows 2-3 its volume pair) as beta * z_mkt + perp * eps
// (fmaf), the mixed price normal also driving its volume model.  The market
// rows are read with the engine's Draws on the market key, drawn again for
// every symbol.
//
// What bounds it on the H100: S times one symbol's sampler engine (the
// engine sampler kernel's work: the special functions and the per-bar gates),
// plus the market draws, counted once a path; a recorded bar's four gathers
// are 4-byte reads from tables in the L2.  Three CTAs an SM, as the gbm book
// kernel (__launch_bounds__(BLOCK, 3): at most 80 registers; at 108 and two
// CTAs an SM the gbm book ran 14% slower on the H100, PERF.md).  The bar steps
// are mc_engine_sampler_step.cuh's (called functions, common.cuh), as in
// mc_engine_samplers.cu.  This source is a library of its own, so the gbm
// book kernel keeps its code.

#include "mc_engine.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_engine_sampler_step.cuh"

// One path of a book under symbol arguments ``a`` and sampler ``s``: its
// draws on the symbol's key (dr) and the market's (md), its bars through the
// sampler's bar step with its rings rg, the post-bar equity into the book
// curve (bk) after every bar.
template <int MAXL, int KIND>
__device__ __forceinline__ void sampler_walk(const EngineArgs& a, const SamplerArgs& s,
                                             Draws& dr, Draws& md, const Rings& rg,
                                             EngineState<MAXL>& st, const BookPath& bk) {
    init_state<MAXL>(a, st, rg);
#include "mc_engine_book_sampler_walk.cuh"
}

// A correlated book under sampler KIND (replaces the sampler branches of
// pallas_engine.py _engine_corr_kernel): rows[s], sargs[s] and bw[s] are
// symbol s's arguments, sampler arguments and (beta, weight); ext / ext_m the
// injected idiosyncratic and market rows (or null: Philox, the market's on
// m_stream); the book curves at curve_mem (W floats a path, a stride of
// gridDim.x x BLOCK apart).  Partial rows [S + 1][CTA]; per-path rows
// [S + 1][path].
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK, 3)
mc_engine_corr_sampler_kernel(const EngineArgs* __restrict__ rows,
                              const SamplerArgs* __restrict__ sargs,
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
    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int row_len = ENGINE_SUB * lanes;
    const int m_rows = (KIND == SAMPLER_HESTON ? 2 : 1) * num_bars;   // market rows a block
    const long long stride = (long long)gridDim.x * BLOCK;
    BookPath bk;
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
        for (int t = 0; t < num_bars; ++t) bk.curve[(long long)t * bk.cstride] = 0.f;
        int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;

        for (int sym = 0; sym < n_sym; ++sym) {
            __syncthreads();
            if (threadIdx.x == 0) { s_a = rows[sym]; s_s = sargs[sym]; s_bw = bw[sym]; }
            __syncthreads();
            const EngineArgs& a = s_a;
            bk.beta = s_bw.x;
            bk.perp = BookPath::perp_of(s_bw.x);
            bk.weight = s_bw.y;
            Draws dr{ext ? ext + a.ext_offset : nullptr, blk, col, row_len, a.u_rows, a.seed,
                     a.stream, -1, make_uint4(0u, 0u, 0u, 0u)};
            Draws md{ext_m, blk, col, row_len, m_rows, a.seed, m_stream, -1,
                     make_uint4(0u, 0u, 0u, 0u)};
            EngineState<MAXL> st;
            sampler_walk<MAXL, KIND>(a, s_s, dr, md, rg, st, bk);

            const bool entered = st.trades > 0;
            const int open = st.side != 0;
            b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
            b_open |= open;
            int cnt[N_COUNTS + N_SKIPS] = {1, entered, st.wins, st.losses, open, st.trades,
                                           st.escal};
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
            const long long seg = (long long)sym * gridDim.x + blockIdx.x;
            cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, entered, st.equity, st.dd,
                                                 part_counts + seg * ROW_COUNTS,
                                                 part_floats + seg * ROW_FLOATS, chunk == 0);
            if (per_path) {
                float* o = per_path + ((long long)sym * num_paths + p) * PATH_COLS;
                o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
                o[6] = (float)st.escal;
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
            }
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

extern "C" {

int qmmx_engine_corr_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// The book under sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON): n_sym
// argument rows at ``rows``, sampler rows at ``sargs`` and (beta, weight)
// pairs at ``bw`` (device memory), one partial row per (symbol, CTA) and per
// (book, CTA), the book curves at curve_mem (num_bars x grid x BLOCK floats
// of device memory).  ext / ext_m and per_path may be null.  Returns
// cudaGetLastError().
int qmmx_mc_engine_corr_sampler(const EngineArgs* rows, const SamplerArgs* sargs,
                                const float2* bw, int n_sym, int kind, int max_levels,
                                int num_bars, const float* ext, const float* ext_m,
                                unsigned m_stream, float* curve_mem, long long* part_counts,
                                float* part_floats, float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || num_bars > 61 || num_bars < 2 || (num_bars & 1)
            || n_sym < 1 || !curve_mem)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (kind == SAMPLER_RESAMPLE) {
        mc_engine_corr_sampler_kernel<MAX_LEVELS, SAMPLER_RESAMPLE><<<grid, BLOCK, 0, s>>>(
            rows, sargs, bw, n_sym, ext, ext_m, m_stream, curve_mem, part_counts, part_floats,
            per_path);
    } else if (kind == SAMPLER_HESTON) {
        mc_engine_corr_sampler_kernel<MAX_LEVELS, SAMPLER_HESTON><<<grid, BLOCK, 0, s>>>(
            rows, sargs, bw, n_sym, ext, ext_m, m_stream, curve_mem, part_counts, part_floats,
            per_path);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
