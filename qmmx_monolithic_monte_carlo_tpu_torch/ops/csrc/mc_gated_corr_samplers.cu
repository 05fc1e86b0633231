// Correlated-book Monte Carlo on Hopper over the gated lifecycle under the
// recorded-bar and Heston samplers.
//
// mc_gated_corr_sampler_kernel replaces the sampler branches of the TPU
// kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _gated_corr_kernel
// (samplers "bootstrap", "block_bootstrap" and "heston", pallas_mc.py:
// 1237-1295 inside _gated_lifecycle_loop).  The structure is
// mc_gated_corr_kernel's (mc_gated_corr.cu): one thread a path walks every
// symbol in order, the CTA copying symbol s's GatedArgs, SamplerArgs and
// (beta, weight) into shared memory between two barriers; the thread adds
// w_s times the post-bar equity into its book curve of W floats (dynamic
// shared memory, or the device-memory buffer the wrapper passes past 160
// bars) and adds the path to symbol s's partial row; after the last symbol
// it folds the curve and adds the path's book to one more partial row, so
// one fold (fold_lifecycle_rows) takes S + 1 segments.
//
// The market stream carries the sampler (ops/draws.MarketLayout):
//   bootstrap, block bootstrap: market rows 2 t2 and 2 t2 + 1 are the index
//     uniforms of bars 2 t2 and 2 t2 + 1, so every symbol replays the same
//     recorded bar (joint recorded days; a block's start is drawn at its
//     first bar), each from its own table (SamplerArgs row s: its own
//     history, or the one every symbol shares); the symbol's rows 0, 1 are
//     its tie coins (rows 2, 3 unused), its noise from row 4; beta unused.
//   heston: market rows 4 t2 .. 4 t2 + 3 (one Philox call) are the market's
//     price pair and variance pair; the symbol's own pairs (rows 0-3) are
//     mixed with them as beta * z_mkt + perp * eps (fmaf, the JAX book's
//     fusion), then sampler.cuh's Euler step.
// The market rows are read with sampler.cuh's RowDraws on the market key,
// drawn again for every symbol (the key ignores the symbol, as the TPU kernel
// reseeds its market stream).
//
// What bounds it on the H100: S times one symbol's sampler lifecycle (the
// gated sampler kernel's work: expf a bar and the recorded extremes where a
// position is open, or Heston's Box-Muller pairs, sqrtf and bridge), plus the
// market draws, which the bound counts once a path; a recorded bar's gathers
// are 4-byte reads through the read-only cache from tables that stay in the
// 50 MB L2 (a shared history: 1.97 MB for a year of minutes).  The bar steps
// are mc_gated_sampler_step.cuh's (called functions, common.cuh), as in
// mc_gated_samplers.cu.  This source is a library of its own, so the gbm
// book kernel keeps its code.

#include "mc_gated.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_gated_sampler_step.cuh"

// One path of a book under symbol arguments ``a`` and sampler ``s`` (column
// col of block blk): its draws on the symbol's key (dr) and the market's
// (md), its bars through the sampler's bar step, the post-bar equity into the
// book curve (bk) after every bar.
template <int MAXL, int KIND>
__device__ __forceinline__ void sampler_walk(const GatedArgs& a, const SamplerArgs& s,
                                             RowDraws& dr, RowDraws& md, GatedState<MAXL>& st,
                                             const BookPath& bk) {
    st.log_s = a.log_s0;
    st.prev_c = expf(a.log_s0);
    st.entry = st.stop = st.target = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }

    const int stride = a.u_rows / (a.num_bars >> 1);      // rows a double bar
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 10;
    const float4 no_noise = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
    for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
        const int r = t2 * stride;
        float x0, x1, zq0 = 0.f, zq1 = 0.f, tie0, tie1;
        float u30 = 0.f, u40 = 0.f, u31 = 0.f, u41 = 0.f;
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            x0 = md.at(2 * t2); x1 = md.at(2 * t2 + 1);
            tie0 = dr.at(r); tie1 = dr.at(r + 1);
        } else {
            const float2 zm = normal_pair(md.at(4 * t2), md.at(4 * t2 + 1));
            const float2 qm = normal_pair(md.at(4 * t2 + 2), md.at(4 * t2 + 3));
            const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
            const float2 q = normal_pair(dr.at(r + 2), dr.at(r + 3));
            x0 = bk.mix(zm.x, z.x); x1 = bk.mix(zm.y, z.y);
            zq0 = bk.mix(qm.x, q.x); zq1 = bk.mix(qm.y, q.y);
            u30 = dr.at(r + 4); u40 = dr.at(r + 5); tie0 = dr.at(r + 6);
            u31 = dr.at(r + 7); u41 = dr.at(r + 8); tie1 = dr.at(r + 9);
        }
        float4 n0 = no_noise, n1 = no_noise;
        if (a.use_noise) {
            const int k = r + k_noise;
            n0 = make_float4(dr.at(k), dr.at(k + 1), dr.at(k + 2), dr.at(k + 3));
            n1 = make_float4(dr.at(k + 4), dr.at(k + 5), dr.at(k + 6), dr.at(k + 7));
        }
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            resample_bar_step<MAXL>(a, s, st, 2 * t2, x0, tie0, n0, carry);
            bk.add(2 * t2, st.equity);
            resample_bar_step<MAXL>(a, s, st, 2 * t2 + 1, x1, tie1, n1, carry);
        } else {
            heston_bar_step<MAXL>(a, s, st, 2 * t2, x0, zq0, u30, u40, tie0, n0, carry);
            bk.add(2 * t2, st.equity);
            heston_bar_step<MAXL>(a, s, st, 2 * t2 + 1, x1, zq1, u31, u41, tie1, n1, carry);
        }
        bk.add(2 * t2 + 1, st.equity);
    }
}

// A correlated book under sampler KIND (replaces the sampler branches of
// pallas_mc.py _gated_corr_kernel): rows[s], sargs[s] and bw[s] are symbol
// s's arguments, sampler arguments and (beta, weight); ext / ext_m the
// injected idiosyncratic and market rows (or null: Philox, the market's on
// m_stream).  Partial rows [S + 1][CTA]: symbol s's, then the book's;
// per-path rows [S + 1][path].
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_gated_corr_sampler_kernel(const GatedArgs* __restrict__ rows,
                             const SamplerArgs* __restrict__ sargs,
                             const float2* __restrict__ bw, int n_sym,
                             const float* __restrict__ ext, const float* __restrict__ ext_m,
                             uint32_t m_stream, float* __restrict__ curve_mem,
                             long long* __restrict__ part_counts,
                             float* __restrict__ part_floats, float* __restrict__ per_path) {
    extern __shared__ float s_curve[];
    __shared__ GatedArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ float2 s_bw;        // symbol s's (beta, weight)
    const long long num_paths = rows[0].num_paths;
    const int num_bars = rows[0].num_bars, lanes = rows[0].lanes;
    const int row_len = GATED_SUB * lanes;
    const int m_rows = (KIND == SAMPLER_HESTON ? 2 : 1) * num_bars;   // market rows a block
    const long long stride = (long long)gridDim.x * BLOCK;
    BookPath bk;
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
        for (int t = 0; t < num_bars; ++t) bk.curve[(long long)t * bk.cstride] = 0.f;
        int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;

        for (int sym = 0; sym < n_sym; ++sym) {
            __syncthreads();
            if (threadIdx.x == 0) { s_a = rows[sym]; s_s = sargs[sym]; s_bw = bw[sym]; }
            __syncthreads();
            const GatedArgs& a = s_a;
            bk.beta = s_bw.x;
            bk.perp = BookPath::perp_of(s_bw.x);
            bk.weight = s_bw.y;
            RowDraws dr{ext ? ext + a.ext_offset : nullptr, blk, col, row_len, a.u_rows,
                        a.seed, a.stream, -1, make_uint4(0u, 0u, 0u, 0u)};
            RowDraws md{ext_m, blk, col, row_len, m_rows, a.seed, m_stream, -1,
                        make_uint4(0u, 0u, 0u, 0u)};
            GatedState<MAXL> st;
            sampler_walk<MAXL, KIND>(a, s_s, dr, md, st, bk);

            const bool entered = st.trades > 0;
            const int open = st.side != 0;
            b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
            b_open |= open;
            const int cnt[N_COUNTS] = {1, entered, st.wins, st.losses, open, st.trades};
            const long long seg = (long long)sym * gridDim.x + blockIdx.x;
            cta_add_path_row<N_COUNTS>(cnt, entered, st.equity, st.dd,
                                       part_counts + seg * ROW_COUNTS,
                                       part_floats + seg * ROW_FLOATS, chunk == 0);
            if (per_path) {
                float* o = per_path + ((long long)sym * num_paths + p) * PATH_COLS;
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

template <int KIND>
static int launch(const GatedArgs* rows, const SamplerArgs* sargs, const float2* bw, int n_sym,
                  int num_bars, const float* ext, const float* ext_m, unsigned m_stream,
                  float* curve_mem, long long* part_counts, float* part_floats,
                  float* per_path, int grid, cudaStream_t stream) {
    const size_t dyn = curve_mem ? 0 : (size_t)num_bars * BLOCK * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mc_gated_corr_sampler_kernel<MAX_LEVELS, KIND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dyn);
    if (err != cudaSuccess) return (int)err;
    mc_gated_corr_sampler_kernel<MAX_LEVELS, KIND><<<grid, BLOCK, dyn, stream>>>(
        rows, sargs, bw, n_sym, ext, ext_m, m_stream, curve_mem, part_counts, part_floats,
        per_path);
    return (int)cudaGetLastError();
}

extern "C" {

int qmmx_gated_corr_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// The book under sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON): n_sym
// argument rows at ``rows``, sampler rows at ``sargs`` and (beta, weight)
// pairs at ``bw`` (device memory), one partial row per (symbol, CTA) and per
// (book, CTA).  ext / ext_m, curve_mem (null: the curves in shared memory)
// and per_path may be null.  Returns cudaGetLastError().
int qmmx_mc_gated_corr_sampler(const GatedArgs* rows, const SamplerArgs* sargs, const float2* bw,
                               int n_sym, int kind, int max_levels, int num_bars,
                               const float* ext, const float* ext_m, unsigned m_stream,
                               float* curve_mem, long long* part_counts, float* part_floats,
                               float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || n_sym < 1 || num_bars < 2 || (num_bars & 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (kind == SAMPLER_RESAMPLE)
        return launch<SAMPLER_RESAMPLE>(rows, sargs, bw, n_sym, num_bars, ext, ext_m, m_stream,
                                        curve_mem, part_counts, part_floats, per_path, grid, s);
    if (kind == SAMPLER_HESTON)
        return launch<SAMPLER_HESTON>(rows, sargs, bw, n_sym, num_bars, ext, ext_m, m_stream,
                                      curve_mem, part_counts, part_floats, per_path, grid, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
