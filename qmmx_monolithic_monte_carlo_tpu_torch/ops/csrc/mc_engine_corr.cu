// Correlated-book Monte Carlo on Hopper over the full 12-gate engine.
//
// mc_engine_corr_kernel replaces the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_corr_kernel
// where up to 8 levels and W <= 61 (mc_engine_wide_corr.cu takes 9-64 levels
// and W > 61; a book's W is even): a
// correlated book of S symbols on one market factor,
// z_s = beta_s z_mkt + sqrt(1 - beta_s^2) eps_s, with the book's equity curve
// per path.  The TPU grid is (blocks, symbols) with the symbol axis inner, so
// a block's book curve stays resident while every symbol walks the same
// market draws.  Here one thread a path walks every symbol in order: the CTA
// copies symbol s's arguments (its key, levels, spot, volatility, knobs and
// noise stds) and its (beta, weight) into shared memory between two
// barriers, the thread runs the symbol's whole engine with its normal mixed with the
// market's (drawn again for every symbol from the market key, which ignores
// the symbol, as the TPU kernel reseeds its market stream), adds w_s times
// the post-bar equity into its curve of W floats after every bar, and adds
// the path to symbol s's partial row of the CTA.  The mixed shock is the bar
// step's z, so it drives the symbol's volume as well, as in the JAX book.
// After the last symbol the thread folds its curve (the final R; the
// drawdown with the peak from 0) and adds the path's book -- trades, wins,
// losses summed, open on any symbol -- to one more partial row; one fold
// (fold_lifecycle_rows) then takes S + 1 segments.  The curve lives in a
// device-memory buffer: the rings already take 25 KB of shared memory a CTA,
// and with the curves there too (40 KB more at W = 40) the kernel ran 5%
// slower on the H100 (PERF.md).  What bounds it: S times one configuration's
// special functions and Philox, plus the market pair a double-bar step, which
// the bound counts once a path (the kernel regenerates it for every symbol,
// as the TPU kernel does); bytes stay negligible.  With beta = 0 the mix is
// eps exactly, so a book symbol equals the universe's symbol path for path.

#include "mc_engine.cuh"
#include "book.cuh"

// One path of a book under symbol arguments ``a`` (column col of its block,
// the antithetic mirror of column col - half_lanes), its rings rg:
// engine_block's engine with the price normal mixed with the market's (bk)
// before the bar step -- so the mixed shock also drives its volume -- and
// the post-bar equity added to the book curve after every bar.
// engine_block (mc_engine.cu) keeps its own copy of the loop: with one loop
// for both, the single and sweep kernels ran 4% slower on the H100
// (PERF.md).
template <int MAXL>
__device__ __forceinline__ void engine_walk(const EngineArgs& a, Draws& dr, const Rings& rg,
                                            int col, bool mirror, int half_lanes,
                                            EngineState<MAXL>& st, const BookPath& bk) {
    st.log_s = a.log_s0;
    st.prev_c = expf(a.log_s0);
    st.entry = st.stop = st.target = st.risk0 = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.run_low = INF_F; st.run_high = -INF_F;
    st.box_low = st.box_high = 0.f;
    st.side = st.last_dir = st.trades = st.wins = st.losses = st.escal = 0;
    st.cooldown_until = -(1 << 30);
    st.box_valid = st.regime = st.inside_cnt = 0;
    st.c_latch = 0u;
    st.tm_has = 0u;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) st.c_counts[i] = 0;
#pragma unroll
    for (int j = 0; j < 2 * MAXL; ++j) { st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f; }
#pragma unroll
    for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
#pragma unroll
    for (int j = 0; j < N_SKIPS; ++j) st.skips[j] = 0;
    for (int j = 0; j < VOL_RING; ++j) rg.vol[j * BLOCK] = 0.f;
    for (int j = 0; j < CLOSE_RING; ++j) rg.close[j * BLOCK] = 0.f;

#include "mc_engine_book_walk.cuh"
}

// A correlated book (replaces pallas_engine.py _engine_corr_kernel): rows[s]
// are symbol s's arguments (its key, levels, spot, volatility, the 17 knobs
// and noise stds; the ML, policy, touch and guard records shared), bw[s]
// its (beta, weight), ext_m the injected market rows (or null: Philox on
// m_stream).  One thread a path walks every symbol in order -- the TPU
// grid's symbol-inner axis -- so the path's book curve (W floats at
// curve_mem, a stride of gridDim.x x BLOCK apart) sums the symbols'
// weighted post-bar equity.  Partial rows [S + 1][CTA]: symbol s's, then
// the book's (whose escalation and skip columns are zero); per-path rows
// [S + 1][path].  Three CTAs an SM (at most 80 registers): compiled to 108
// registers, two CTAs an SM, it ran slower on the H100 (PERF.md).
template <int MAXL>
__global__ void __launch_bounds__(BLOCK, 3)
mc_engine_corr_kernel(const EngineArgs* __restrict__ rows, const float2* __restrict__ bw,
                      int n_sym, const float* __restrict__ ext, const float* __restrict__ ext_m,
                      uint32_t m_stream, float* __restrict__ curve_mem,
                      long long* __restrict__ part_counts, float* __restrict__ part_floats,
                      float* __restrict__ per_path) {
    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ EngineArgs s_a;
    __shared__ float2 s_bw;        // symbol s's (beta, weight)
    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int row_len = ENGINE_SUB * lanes, half_lanes = lanes >> 1;
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
        bk.mirror = rows[0].antithetic && (col % lanes) >= half_lanes;
        for (int t = 0; t < num_bars; ++t) bk.curve[(long long)t * bk.cstride] = 0.f;
        int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;

        for (int s = 0; s < n_sym; ++s) {
            __syncthreads();
            if (threadIdx.x == 0) { s_a = rows[s]; s_bw = bw[s]; }
            __syncthreads();
            const EngineArgs& a = s_a;
            bk.beta = s_bw.x;
            bk.perp = BookPath::perp_of(s_bw.x);
            bk.weight = s_bw.y;
            Draws dr{ext ? ext + a.ext_offset : nullptr, blk, col, row_len, a.u_rows, a.seed,
                     a.stream, -1, make_uint4(0u, 0u, 0u, 0u)};
            EngineState<MAXL> st;
            engine_walk<MAXL>(a, dr, rg, col, bk.mirror, half_lanes, st, bk);

            const bool entered = st.trades > 0;
            const int open = st.side != 0;
            b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
            b_open |= open;
            int cnt[N_COUNTS + N_SKIPS] = {1, entered, st.wins, st.losses, open, st.trades,
                                           st.escal};
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
            const long long seg = (long long)s * gridDim.x + blockIdx.x;
            cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, entered, st.equity, st.dd,
                                                 part_counts + seg * ROW_COUNTS,
                                                 part_floats + seg * ROW_FLOATS, chunk == 0);
            if (per_path) {
                float* o = per_path + ((long long)s * num_paths + p) * PATH_COLS;
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

// The book: n_sym argument rows at ``rows`` and (beta, weight) pairs at
// ``bw`` (device memory), one partial row per (symbol, CTA) and per (book,
// CTA), the book curves at curve_mem (num_bars x grid x BLOCK floats of
// device memory).  ext / ext_m (injected idio and market uniforms) and
// per_path may be null.  Returns cudaGetLastError().
int qmmx_mc_engine_corr(const EngineArgs* rows, const float2* bw, int n_sym, int max_levels,
                        int num_bars, const float* ext, const float* ext_m, unsigned m_stream,
                        float* curve_mem, long long* part_counts, float* part_floats,
                        float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || num_bars > 61 || num_bars < 2 || (num_bars & 1)
            || n_sym < 1 || !curve_mem)
        return (int)cudaErrorInvalidValue;
    mc_engine_corr_kernel<MAX_LEVELS><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        rows, bw, n_sym, ext, ext_m, m_stream, curve_mem, part_counts, part_floats,
        per_path);
    return (int)cudaGetLastError();
}

}  // extern "C"
