// Correlated-book Monte Carlo on Hopper over the gated lifecycle.
//
// mc_gated_corr_kernel replaces the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _gated_corr_kernel: a
// correlated book of S symbols on one market factor, z_s = beta_s z_mkt +
// sqrt(1 - beta_s^2) eps_s, with the book's equity curve per path.  The TPU
// grid is (blocks, symbols) with the symbol axis inner, so a block's book
// curve stays resident while every symbol walks the same market draws.  Here
// one thread a path walks every symbol in order: the CTA copies symbol s's
// arguments (its key, levels, spot, volatility, knobs and noise stds) and
// its (beta, weight) into shared memory between two barriers, the thread
// runs the symbol's whole lifecycle with its normal mixed with the market's (drawn
// again for every symbol from the market key, which ignores the symbol, as
// the TPU kernel reseeds its market stream), adds w_s times the post-bar
// equity into its curve of W floats after every bar, and adds the path to
// symbol s's partial row of the CTA.  After the last symbol the thread folds
// its curve (the final R; the drawdown with the peak from 0) and adds the
// path's book -- trades, wins, losses summed, open on any symbol -- to one
// more partial row; one fold (fold_lifecycle_rows) then takes S + 1
// segments.  The curve lives in dynamic shared memory (W x BLOCK floats),
// or, for horizons whose curves do not fit there, in a device-memory buffer
// the wrapper passes (at W = 40 shared memory ran 1% faster on the H100,
// PERF.md).  What bounds it: S times one configuration's special functions
// and Philox, plus the market pair a double-bar step, which the bound counts
// once a path (the kernel regenerates it for every symbol, as the TPU kernel
// does); bytes stay negligible.  With beta = 0 the mix is eps exactly, so a
// book symbol equals the universe's symbol path for path.

#include "mc_gated.cuh"
#include "book.cuh"

// One path of a book under symbol arguments ``a`` (column col of its block,
// the antithetic mirror of column col - half_lanes): gated_block's
// lifecycle with the price normal mixed with the market's (bk) and the
// post-bar equity added to the book curve after every bar.  gated_block
// (mc_gated.cu) keeps its own copy of the loop: with one loop for both, the
// single and sweep kernels ran 3% slower on the H100 (PERF.md).
template <int MAXL>
__device__ __forceinline__ void gated_walk(const GatedArgs& a, const Draws& dr, int col,
                                           bool mirror, int half_lanes, GatedState<MAXL>& st,
                                           const BookPath& bk) {
    st.log_s = a.log_s0;
    st.prev_c = expf(a.log_s0);
    st.entry = st.stop = st.target = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }

    const int groups = a.use_noise ? 4 : 2;   // Philox calls per double-bar step
    const float4 no_noise = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
#pragma unroll 1
    for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
        const int g = t2 * groups;
        const float4 d0 = dr.group(g, col);      // u1, u2, u3, u4 of bar 2t2
        const float4 d1 = dr.group(g + 1, col);  // tie; u3, u4, tie of 2t2+1
        float u1 = d0.x, u2 = d0.y;
        if (mirror) {
            const float4 m = dr.group(g, col - half_lanes);
            u1 = m.x; u2 = m.y;
        }
        const float4 n0 = a.use_noise ? dr.group(g + 2, col) : no_noise;
        const float4 n1 = a.use_noise ? dr.group(g + 3, col) : no_noise;
        const float rad = sqrtf(-2.0f * logf(u1));
        float sn, cs;
        sincosf(two_pi() * u2, &sn, &cs);
        float z0 = rad * cs, z1 = rad * sn;
        if (mirror) { z0 = -z0; z1 = -z1; }
        const float2 zm = bk.market(t2);
        z0 = bk.mix(zm.x, z0);
        z1 = bk.mix(zm.y, z1);
        bar_step<MAXL>(a, st, 2 * t2, z0, d0.z, d0.w, d1.x, n0);
        bk.add(2 * t2, st.equity);
        bar_step<MAXL>(a, st, 2 * t2 + 1, z1, d1.y, d1.z, d1.w, n1);
        bk.add(2 * t2 + 1, st.equity);
    }
}

// A correlated book (replaces pallas_mc.py _gated_corr_kernel): rows[s] are
// symbol s's arguments (its key, levels, spot, volatility, knobs and noise
// stds; the gate shared), bw[s] its (beta, weight), ext_m the injected
// market rows (or null: Philox on m_stream).  One thread a path walks every
// symbol in order -- the TPU grid's symbol-inner axis -- so the path's book
// curve (W floats at curve_mem, or in dynamic shared memory when curve_mem
// is null) sums the symbols' weighted post-bar equity.  Partial rows
// [S + 1][CTA]: symbol s's, then the book's; per-path rows [S + 1][path].
template <int MAXL>
__global__ void __launch_bounds__(BLOCK)
mc_gated_corr_kernel(const GatedArgs* __restrict__ rows, const float2* __restrict__ bw,
                     int n_sym, const float* __restrict__ ext, const float* __restrict__ ext_m,
                     uint32_t m_stream, float* __restrict__ curve_mem,
                     long long* __restrict__ part_counts, float* __restrict__ part_floats,
                     float* __restrict__ per_path) {
    extern __shared__ float s_curve[];
    __shared__ GatedArgs s_a;
    __shared__ float2 s_bw;        // symbol s's (beta, weight)
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int row_len = GATED_SUB * lanes, half_lanes = lanes >> 1;
    const long long stride = (long long)gridDim.x * BLOCK;
    BookPath bk;
    bk.md = MarketDraws{ext_m, 0, row_len, num_bars, rows[0].seed, m_stream};
    bk.curve = curve_mem ? curve_mem + (long long)blockIdx.x * BLOCK + threadIdx.x
                         : s_curve + threadIdx.x;
    bk.cstride = curve_mem ? (int)stride : BLOCK;

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
            const GatedArgs& a = s_a;
            bk.beta = s_bw.x;
            bk.perp = BookPath::perp_of(s_bw.x);
            bk.weight = s_bw.y;
            const Draws dr{ext ? ext + a.ext_offset : nullptr, blk, row_len, a.u_rows,
                           a.seed, a.stream};
            GatedState<MAXL> st;
            gated_walk<MAXL>(a, dr, col, bk.mirror, half_lanes, st, bk);

            const bool entered = st.trades > 0;
            const int open = st.side != 0;
            b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
            b_open |= open;
            const int cnt[N_COUNTS] = {1, entered, st.wins, st.losses, open, st.trades};
            const long long seg = (long long)s * gridDim.x + blockIdx.x;
            cta_add_path_row<N_COUNTS>(cnt, entered, st.equity, st.dd,
                                       part_counts + seg * ROW_COUNTS,
                                       part_floats + seg * ROW_FLOATS, chunk == 0);
            if (per_path) {
                float* o = per_path + ((long long)s * num_paths + p) * PATH_COLS;
                o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
            }
        }

        const float2 fin = book_fold(bk.curve, bk.cstride, num_bars);   // (final R, drawdown)
        const bool entered = b_trades > 0;
        const int cnt[N_COUNTS] = {1, entered, b_wins, b_losses, b_open, b_trades};
        const long long seg = (long long)n_sym * gridDim.x + blockIdx.x;
        cta_add_path_row<N_COUNTS>(cnt, entered, fin.x, fin.y, part_counts + seg * ROW_COUNTS,
                                   part_floats + seg * ROW_FLOATS, chunk == 0);
        if (per_path) {
            float* o = per_path + ((long long)n_sym * num_paths + p) * PATH_COLS;
            o[0] = fin.x; o[1] = (float)b_trades; o[2] = (float)b_wins;
            o[3] = (float)b_losses; o[4] = (float)b_open; o[5] = fin.y;
        }
    }
}

extern "C" {

// The book: n_sym argument rows at ``rows`` and (beta, weight) pairs at
// ``bw`` (device memory), one partial row per (symbol, CTA) and per (book,
// CTA).  ext / ext_m (injected idio and market uniforms), curve_mem (the
// book curves in device memory, num_bars x grid x BLOCK floats; null: in
// shared memory) and per_path may be null.  Returns cudaGetLastError().
int qmmx_mc_gated_corr(const GatedArgs* rows, const float2* bw, int n_sym, int max_levels,
                       int num_bars, const float* ext, const float* ext_m, unsigned m_stream,
                       float* curve_mem, long long* part_counts, float* part_floats,
                       float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || n_sym < 1 || num_bars < 2 || (num_bars & 1))
        return (int)cudaErrorInvalidValue;
    const size_t dyn = curve_mem ? 0 : (size_t)num_bars * BLOCK * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mc_gated_corr_kernel<MAX_LEVELS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dyn);
    if (err != cudaSuccess) return (int)err;
    mc_gated_corr_kernel<MAX_LEVELS><<<grid, BLOCK, dyn, (cudaStream_t)stream>>>(
        rows, bw, n_sym, ext, ext_m, m_stream, curve_mem, part_counts, part_floats,
        per_path);
    return (int)cudaGetLastError();
}

}  // extern "C"
