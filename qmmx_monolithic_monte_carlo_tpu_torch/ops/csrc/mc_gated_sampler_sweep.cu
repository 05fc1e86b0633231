// The gated lifecycle's grid sweep on Hopper under every sampler: each path's
// bars made once and replayed for every grid row.
//
// mc_gated_sampler_sweep_kernel<MAXL, KIND> replaces the sampler branches
// (bootstrap, block bootstrap, Heston) of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _gated_sweep_kernel (#6,
// :2163), which reseeds and makes a path block's bars again for every grid
// configuration.  It replaces the sweep launch of mc_gated_sampler_kernel
// (mc_gated_samplers.cu, a row a blockIdx.y: each row made the bars again),
// which keeps the single configuration (#4) and the universe (#5).
//
// A grid row changes which trades open (paddings, qmin, touch_limit,
// cooldown_bars, touch_gap, use_conf, proximity) and their noise stds, never
// the bars: a path's closes, highs and lows, its bootstrap open gap, each
// bar's tie coin and its noise uniforms are the same for every row (one key,
// one history).  So one thread makes its path's bars once, into a bar store
// of three planes (close, high, low: 12 bytes a bar), then replays each row's
// lifecycle (mc_gated_step.cuh's statements) over the store in turn, and adds
// the path to that row's partial row (book.cuh's cta_add_path_row) as the
// one-row kernel does.  Highs and lows are made for every bar (the one-row
// kernel makes them on held bars only: the same bits whoever computes them).
// The uniforms a row reads only rarely are not stored but drawn again where
// it reads them: a bar's tie coin where it hits both stop and target
// (GATED_TIE), its four noise uniforms where a trade opens (GATED_ENTRY_NOISE).
//
// The store: W x BLOCK floats a plane, thread index fastest, so a warp's
// loads are whole lines (plain loads: the slot is written again every chunk,
// so never through the read-only cache).  Too large for shared memory at
// useful occupancy (120 KB a CTA at W = 40), it is a device scratch of the
// resident CTAs: 32 MB at W = 40, inside the 50 MB L2.  The grid is
// persistent: physical CTA b takes the one-row kernel's CTAs (virtual CTAs)
// b, b + gridDim.x, ... of ``vgrid``, each in the one-row kernel's chunk
// order, and owns the store slot b, written once a chunk and read by every
// row.  Measured on the card (probes of the design; PERF.md): the
// replay is bound by the lifecycle and by the store's reads, not by making
// the bars (the three samplers cost the same); storing more (the tie coin,
// each bar's nearest level) or replaying two rows side by side (spills) ran
// slower, and two CTAs an SM (no spill) faster than three.
//
// What bounds it on the H100: the bars once a path (Heston: two Box-Muller
// pairs, the variance step and the bridge a double bar; bootstrap: a Philox
// call a double bar and four gathered values a bar), then every row's
// lifecycle (the level search, the touch latch, the confidence division);
// bytes: the store, written once and read (its closes) once a row.
//
// Results: the grid (grid_size(num_paths) virtual CTAs), the path-to-thread
// map, the per-chunk reduction and the bar arithmetic are the one-row
// kernel's, so row g's partial rows [row][CTA] and per-path rows
// [row][path] equal mc_gated_sampler_kernel's one-row launch at row g's
// GatedArgs, bit for bit.  Numerics as mc_gated_samplers.cu: -fmad=false,
// IEEE logf / sqrtf / sincosf / expf, fmaf where the JAX kernel's XLA fuses.
// A library of its own, so mc_gated_sampler_kernel keeps its code.
//
// Its gbm kind, mc_gated_sampler_sweep_kernel<MAXL, SAMPLER_GBM>, replaces
// the gbm branch of the same TPU kernel (#6, pallas_mc.py:2349), and the
// sweep launch of mc_gated.cu's mc_gated_sweep_kernel (a row a blockIdx.y,
// each row making the bars again: a Box-Muller pair a double bar, an expf a
// bar and the bridge on held bars), which keeps the single configuration
// (#4) and the universe (#5).  The same store, persistent grid and replay
// (replay_bar), with gated_block's draws (make_bars<SAMPLER_GBM> through
// mc_gated.cuh's gbm_double_bar: two Philox calls a double bar, four with
// noise; the tie coin and the noise rows drawn again where read).
// The bridge's high and low are made for every bar and stored: a probe on
// the card that stored the log closes instead and made a held bar's high
// and low again for each row (a Philox call, 2 logf, 2 sqrtf, 2 expf) ran
// 1.53x slower, and 3 CTAs an SM (spills) 1.10x slower than 2 (PERF.md).
// The reduction differs from the samplers': gated_block sums a thread's paths in
// path order before one CTA reduction, so each (row, thread) keeps its six
// float sums in a device scratch and each row its counts and histogram in
// shared memory (GATED_GBM_ROWS rows a pass; past them the bars are made
// again); row g's partial rows [row][CTA] and per-path rows [row][path] then
// equal mc_gated_sweep_kernel's one-row launch at row g's GatedArgs, bit for
// bit.  What bounds it: the bars once a path, then every row's lifecycle;
// bytes: the store (12 bytes a bar, written once, read by every row) and
// the scratch (24 bytes a row and path, in L2).

#include "mc_gated.cuh"
#include "book.cuh"
#include "sampler.cuh"

#define SAMPLER_GBM 0               // the gbm kind (sampler.cuh's kinds: 1, 3)
#define GATED_SWEEP_MIN_BLOCKS 2    // CTAs an SM for __launch_bounds__
#define BAR_PLANES 3                // close, high, low
// gbm's reduction (gbm_pass_*)
#define GATED_GBM_ROWS 32           // the rows replayed over one making of the bars
#define GATED_GBM_ACC 6             // a (row, thread)'s float sums
// The most device memory (MiB) the store and the scratch of a launch take
// together: past it fewer CTAs run (from W ~ 10000 at 2 CTAs an SM).
#define GATED_GBM_STORE_MIB 8192

// Make one gbm bar from the log close before it, its normal z and its
// uniforms u3, u4: its close (bar_step's arithmetic) and the bridge's high
// and low (GATED_BRIDGE_EXTREMES, made for every bar).
__device__ __forceinline__ void gbm_bar(const GatedArgs& a, float& log_s, float z, float u3,
                                        float u4, float* b, long long plane) {
    const float log_open = log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    log_s = log_close;
    b[0] = c;
    GATED_BRIDGE_EXTREMES(a.sig_dt * a.sig_dt)
    b[plane] = high;
    b[2 * plane] = low;
}

// Make one path's W bars (the one-row kernel's draws and bar arithmetic:
// gated_block's under gbm, mc_gated_sampler_step.cuh's under the samplers)
// into the store (``bar``: this thread's bar 0 of the close plane; planes
// ``plane`` floats apart, bars BLOCK apart).  Returns the path's previous
// close at bar 0: s0 (gbm, Heston) or the recorded open gap (bootstrap).
template <int KIND>
__device__ __forceinline__ float make_bars(const GatedArgs& a, const SamplerArgs& s,
                                           const float* __restrict__ ext, long long blk,
                                           int col, int stride, float* bar, long long plane) {
    if constexpr (KIND == SAMPLER_GBM) {
        const Draws dr{ext, blk, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream};
        const int half_lanes = a.lanes >> 1;
        const bool mirror = a.antithetic && (col % a.lanes) >= half_lanes;
        const int groups = a.use_noise ? 4 : 2;   // Philox calls a double bar
        float log_s = a.log_s0;
        // (the noise uniforms it draws go unused: a row draws them where it reads them)
#pragma unroll 1
        for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
            const GbmDoubleBar d = gbm_double_bar(a, dr, t2 * groups, col, mirror, half_lanes);
            float* const b = bar + (long long)(2 * t2) * BLOCK;
            gbm_bar(a, log_s, d.z0, d.d0.z, d.d0.w, b, plane);
            gbm_bar(a, log_s, d.z1, d.d1.y, d.d1.z, b + BLOCK, plane);
        }
        return expf(a.log_s0);
    } else {
        RowDraws dr{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1,
                    make_uint4(0u, 0u, 0u, 0u)};
        float log_s = a.log_s0, prev0 = expf(a.log_s0);
        float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
        for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
            const int r = t2 * stride;
            float x[2], zq[2] = {0.f, 0.f}, u3s[2] = {0.f, 0.f}, u4s[2] = {0.f, 0.f};
            if constexpr (KIND == SAMPLER_RESAMPLE) {
                x[0] = dr.at(r); x[1] = dr.at(r + 1);
            } else {
                const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
                const float2 q = normal_pair(dr.at(r + 2), dr.at(r + 3));
                x[0] = z.x; x[1] = z.y; zq[0] = q.x; zq[1] = q.y;
                u3s[0] = dr.at(r + 4); u4s[0] = dr.at(r + 5);
                u3s[1] = dr.at(r + 7); u4s[1] = dr.at(r + 8);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int t = 2 * t2 + j;
                float c, hi, lo;
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    // resample_bar_step's bar and its GATED_EXTREMES
                    const float idx = resample_index(s, t, x[j], carry);
                    const float log_open = log_s;
                    const float log_close = log_open + table_at(s, CH_LOGC, idx);
                    c = expf(log_close);
                    log_s = log_close;
                    if (t == 0) prev0 = expf(log_open + table_at(s, CH_LOGO, idx));
                    hi = expf(log_open + table_at(s, CH_LOGH, idx));
                    lo = expf(log_open + table_at(s, CH_LOGL, idx));
                } else {
                    // heston_bar_step's bar and its GATED_BRIDGE_EXTREMES(var)
                    float v_pos;
                    const float z = x[j];
                    const float sig_bar = heston_step(s, z, zq[j], carry, v_pos);
                    const float var = v_pos * s.dt;
                    const float log_open = log_s;
                    const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
                    c = expf(log_close);
                    log_s = log_close;
                    const float u3 = u3s[j], u4 = u4s[j];
                    GATED_BRIDGE_EXTREMES(var)
                    hi = high;
                    lo = low;
                }
                float* const b = bar + (long long)t * BLOCK;
                b[0] = c;
                b[plane] = hi;
                b[2 * plane] = lo;
            }
        }
        return prev0;
    }
}

// The hooks of mc_gated_step.cuh for a row replayed over the store (in
// scope: a, t, nu and the path's ext, blk, col; the uniform rows a double bar
// ``stride``, the tie coin's k_tie and tie_step, the noise's k_noise): where
// the step reads the bar's tie coin (row (t / 2) stride + k_tie + tie_step
// (t % 2)) or, as a trade opens with noise, its four noise uniforms (rows
// (t / 2) stride + k_noise + 4 (t % 2) on), they are drawn again from the
// path's (ext, blk, col).
#undef GATED_TIE            // mc_gated.cuh's bar step set the defaults
#undef GATED_ENTRY_NOISE
#define GATED_TIE                                                                       \
    RowDraws{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1,        \
             make_uint4(0u, 0u, 0u, 0u)}.at((t >> 1) * stride + k_tie + tie_step * (t & 1))
#define GATED_ENTRY_NOISE                                                               \
    if (a.use_noise) {                                                                  \
        RowDraws nd{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1, \
                    make_uint4(0u, 0u, 0u, 0u)};                                        \
        const int k = (t >> 1) * stride + k_noise + 4 * (t & 1);                        \
        nu = make_float4(nd.at(k), nd.at(k + 1), nd.at(k + 2), nd.at(k + 3));           \
    }

// Bar t of one row's lifecycle (mc_gated_step.cuh) on the stored bar ``b``
// (this thread's close at bar t; high and low in the planes ``plane`` floats
// on, read where a position is open); the tie coin and the noise drawn again
// where read (GATED_TIE, GATED_ENTRY_NOISE).
template <int MAXL>
__device__ __forceinline__ void replay_bar(const GatedArgs& a, GatedState<MAXL>& st, int t,
                                           const float* b, long long plane,
                                           const float* __restrict__ ext, long long blk, int col,
                                           int stride, int k_noise, int k_tie, int tie_step) {
    const float c = b[0];
    float4 nu = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
#define GATED_EXTREMES                                                                  \
    const float high = b[plane];                                                        \
    const float low = b[2 * plane];
#include "mc_gated_step.cuh"
#undef GATED_EXTREMES
}

// gbm's reduction: gated_block sums a thread's paths in path order and
// reduces the CTA once, so the rows go in passes of GATED_GBM_ROWS, each
// (row, thread) of a pass keeping its six float sums in the scratch (``acc``:
// this thread's sums of the pass's row 0, [row][6][thread]) and each row its
// exact counts and histogram in shared memory across a virtual CTA's chunks.
struct GbmPass {
    unsigned long long cnt[GATED_GBM_ROWS][N_COUNTS];
    unsigned hist[GATED_GBM_ROWS][HIST_BINS];
    float red[ROW_FLOATS][BLOCK / 32];
};

// The CTA's shared rows of a gbm pass.
__device__ __forceinline__ GbmPass& gbm_pass() {
    __shared__ GbmPass sp;
    return sp;
}

// Rows 0 .. nr - 1 of a pass set empty (gated_block's start).
__device__ __forceinline__ void gbm_pass_begin(float* acc, int nr) {
    GbmPass& sp = gbm_pass();
    for (int i = threadIdx.x; i < nr * N_COUNTS; i += BLOCK) sp.cnt[i / N_COUNTS][i % N_COUNTS] = 0ull;
    for (int i = threadIdx.x; i < nr * HIST_BINS; i += BLOCK) sp.hist[i / HIST_BINS][i % HIST_BINS] = 0u;
    for (int j = 0; j < nr; ++j) {
        float* const r = acc + (long long)j * GATED_GBM_ACC * BLOCK;
        r[0] = 0.f; r[BLOCK] = 0.f; r[2 * BLOCK] = 0.f;
        r[3 * BLOCK] = BIG; r[4 * BLOCK] = -BIG; r[5 * BLOCK] = 0.f;
    }
}

// This thread's path (``live``) added to row j of the pass, as gated_block
// adds it.
template <int MAXL>
__device__ __forceinline__ void gbm_pass_add(float* acc, int j, bool live,
                                             const GatedState<MAXL>& st) {
    GbmPass& sp = gbm_pass();
    const bool entered = st.trades > 0;
    const unsigned cnt[N_COUNTS] = {
        live ? 1u : 0u, entered ? 1u : 0u, (unsigned)st.wins,
        (unsigned)st.losses, st.side != 0 ? 1u : 0u, (unsigned)st.trades};
#pragma unroll
    for (int k = 0; k < N_COUNTS; ++k) {
        const unsigned s = __reduce_add_sync(0xffffffffu, cnt[k]);
        if ((threadIdx.x & 31) == 0 && s) atomicAdd(&sp.cnt[j][k], (unsigned long long)s);
    }
    if (live) {
        float* const r = acc + (long long)j * GATED_GBM_ACC * BLOCK;
        r[0] = r[0] + st.equity;
        r[BLOCK] = r[BLOCK] + st.equity * st.equity;
        r[2 * BLOCK] = r[2 * BLOCK] + st.dd;
        r[5 * BLOCK] = fmaxf(r[5 * BLOCK], st.dd);
        if (entered) {
            r[3 * BLOCK] = fminf(r[3 * BLOCK], st.equity);
            r[4 * BLOCK] = fmaxf(r[4 * BLOCK], st.equity);
            atomicAdd(&sp.hist[j][life_bin(st.equity)], 1u);
        }
    }
}

// Rows g0 .. g0 + nr - 1 of virtual CTA v: gated_block's CTA reduction of
// the threads' sums into partial rows [row][vgrid].
__device__ __forceinline__ void gbm_pass_end(const float* acc, int g0, int nr, int v, int vgrid,
                                             long long* __restrict__ part_counts,
                                             float* __restrict__ part_floats) {
    GbmPass& sp = gbm_pass();
    const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
    for (int j = 0; j < nr; ++j) {
        const long long seg = (long long)(g0 + j) * vgrid + v;
        long long* const crow = part_counts + seg * ROW_COUNTS;
        float* const frow = part_floats + seg * ROW_FLOATS;
        const float* const r = acc + (long long)j * GATED_GBM_ACC * BLOCK;
        const float sum_eq = warp_sum(r[0]), sum_eq2 = warp_sum(r[BLOCK]);
        const float sum_dd = warp_sum(r[2 * BLOCK]);
        const float min_eq = warp_min(r[3 * BLOCK]), max_eq = warp_max(r[4 * BLOCK]);
        const float max_dd = warp_max(r[5 * BLOCK]);
        __syncthreads();               // the count atomics and the last row's readers
        if (wl == 0) {
            sp.red[0][warp] = sum_eq; sp.red[1][warp] = sum_eq2; sp.red[2][warp] = sum_dd;
            sp.red[3][warp] = min_eq; sp.red[4][warp] = max_eq; sp.red[5][warp] = max_dd;
        }
        __syncthreads();
        if (tid < N_COUNTS) crow[tid] = (long long)sp.cnt[j][tid];
        for (int i = tid; i < HIST_BINS; i += BLOCK) crow[N_COUNTS + i] = (long long)sp.hist[j][i];
        if (tid == 0) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
            for (int w = 0; w < BLOCK / 32; ++w) {
                s0 += sp.red[0][w]; s1 += sp.red[1][w]; s2 += sp.red[2][w];
                mn = fminf(mn, sp.red[3][w]); mx = fmaxf(mx, sp.red[4][w]);
                md = fmaxf(md, sp.red[5][w]);
            }
            frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx;
            frow[5] = md;
        }
    }
    __syncthreads();                   // the pass's readers of the shared rows
}

// Row ``a``'s lifecycle of this thread's path (``live``) over the stored
// bars, from the state the one-row kernel starts a path in (its previous
// close prev0).
template <int MAXL>
__device__ __forceinline__ void replay_row(const GatedArgs& a, GatedState<MAXL>& st, float prev0,
                                           bool live, const float* bar0, long long plane,
                                           const float* __restrict__ ext, long long blk, int col,
                                           int stride, int k_noise, int k_tie, int tie_step) {
    st.log_s = a.log_s0;
    st.prev_c = prev0;
    st.entry = st.stop = st.target = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }
    if (live) {
#pragma unroll 1
        for (int t = 0; t < a.num_bars; ++t)
            replay_bar<MAXL>(a, st, t, bar0 + (long long)t * BLOCK, plane, ext, blk, col, stride,
                             k_noise, k_tie, tie_step);
    }
}

// Every path of ``vgrid`` virtual CTAs (the one-row kernel's grid) against
// the ``n_rows`` rows at ``args`` (device memory; every row on the same draws
// and, under the samplers, the one history at ``sargs``), physical CTA
// blockIdx.x taking virtual CTAs blockIdx.x, blockIdx.x + gridDim.x, ... and
// store slot blockIdx.x of ``store`` (BAR_PLANES x W x BLOCK floats a slot):
// for each chunk of paths (a path a thread) the bars once, then each row
// replayed over them; partial rows [row][virtual CTA], per-path rows
// [row][path] when per_path is not null.  Under the samplers a chunk is added
// to each row's partial row as the one-row kernel adds it (cta_add_path_row);
// under gbm the rows go in passes of GATED_GBM_ROWS, the bars made again each
// pass (gbm_pass_*; ``scratch`` [CTA][row][6][thread], null under the
// samplers).  The two loops stay apart so that the samplers' kernels keep
// their code (one loop for both moved the bootstrap kernel's SASS).
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK, GATED_SWEEP_MIN_BLOCKS)
mc_gated_sampler_sweep_kernel(const GatedArgs* __restrict__ args, int n_rows,
                              const SamplerArgs* __restrict__ sargs,
                              const float* __restrict__ ext, float* store,
                              int vgrid, long long* __restrict__ part_counts,
                              float* __restrict__ part_floats, float* __restrict__ per_path,
                              float* scratch) {
    __shared__ GatedArgs s_bars;        // row 0: what makes the bars, every row's
    __shared__ GatedArgs s_a;           // the row being replayed
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) {
        s_bars = args[0];
        if constexpr (KIND != SAMPLER_GBM) s_s = *sargs;
    }
    __syncthreads();
    const GatedArgs& b = s_bars;
    const SamplerArgs& s = s_s;
    const int row_len = GATED_SUB * b.lanes;
    const int stride = b.u_rows / (b.num_bars >> 1);      // rows a double bar
    // the first noise row of bar 2 t2, and the tie coins of bars 2 t2 and
    // 2 t2 + 1: rows r + 2, r + 3 (bootstrap), r + 4, r + 7 (gbm), r + 6, r + 9
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : KIND == SAMPLER_GBM ? 8 : 10;
    const int k_tie = KIND == SAMPLER_RESAMPLE ? 2 : KIND == SAMPLER_GBM ? 4 : 6;
    const int tie_step = KIND == SAMPLER_RESAMPLE ? 1 : 3;
    const long long plane = (long long)b.num_bars * BLOCK;
    float* const bar0 = store + (long long)blockIdx.x * BAR_PLANES * plane + threadIdx.x;
    if (ext) ext += b.ext_offset;
    if constexpr (KIND == SAMPLER_GBM) {
        const int pass_rows = n_rows < GATED_GBM_ROWS ? n_rows : GATED_GBM_ROWS;
        float* const acc = scratch + (long long)blockIdx.x * pass_rows * GATED_GBM_ACC * BLOCK
                           + threadIdx.x;
        for (int v = blockIdx.x; v < vgrid; v += gridDim.x) {
            for (int g0 = 0; g0 < n_rows; g0 += pass_rows) {
                const int nr = min(pass_rows, n_rows - g0);
                gbm_pass_begin(acc, nr);
                // every thread runs the cell's chunks and rows, so the barriers line up
                for (long long base = (long long)v * BLOCK; base < b.num_paths;
                     base += (long long)vgrid * BLOCK) {
                    const long long p = base + threadIdx.x;
                    const bool live = p < b.num_paths;
                    const long long blk = p / row_len;
                    const int col = (int)(p - blk * row_len);
                    const float prev0 = live ? make_bars<KIND>(b, s, ext, blk, col, stride, bar0,
                                                               plane)
                                             : 0.f;
                    for (int j = 0; j < nr; ++j) {
                        const int g = g0 + j;
                        __syncthreads();       // the last row's readers of s_a are done
                        if (threadIdx.x == 0) s_a = args[g];
                        __syncthreads();
                        GatedState<MAXL> st;
                        replay_row<MAXL>(s_a, st, prev0, live, bar0, plane, ext, blk, col, stride,
                                         k_noise, k_tie, tie_step);
                        gbm_pass_add<MAXL>(acc, j, live, st);
                        if (per_path && live) {
                            float* o = per_path + ((long long)g * b.num_paths + p) * PATH_COLS;
                            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                            o[3] = (float)st.losses; o[4] = st.side != 0 ? 1.f : 0.f;
                            o[5] = st.dd;
                        }
                    }
                }
                gbm_pass_end(acc, g0, nr, v, vgrid, part_counts, part_floats);
            }
        }
    } else {
        for (int v = blockIdx.x; v < vgrid; v += gridDim.x) {
            int chunk = 0;
            for (long long base = (long long)v * BLOCK; base < b.num_paths;
                 base += (long long)vgrid * BLOCK, ++chunk) {
                const long long p = base + threadIdx.x;
                const bool live = p < b.num_paths;
                const long long blk = p / row_len;
                const int col = (int)(p - blk * row_len);
                const float prev0 = live ? make_bars<KIND>(b, s, ext, blk, col, stride, bar0,
                                                           plane)
                                         : 0.f;
                for (int g = 0; g < n_rows; ++g) {
                    // the previous row's readers of s_a passed cta_add_path_row's barriers
                    if (threadIdx.x == 0) s_a = args[g];
                    __syncthreads();
                    GatedState<MAXL> st;
                    replay_row<MAXL>(s_a, st, prev0, live, bar0, plane, ext, blk, col, stride,
                                     k_noise, k_tie, tie_step);
                    const bool entered = st.trades > 0;
                    const int open = st.side != 0;
                    const int cnt[N_COUNTS] = {live ? 1 : 0, entered, st.wins, st.losses, open,
                                               st.trades};
                    const long long seg = (long long)g * vgrid + v;
                    cta_add_path_row<N_COUNTS>(cnt, entered, st.equity, st.dd,
                                               part_counts + seg * ROW_COUNTS,
                                               part_floats + seg * ROW_FLOATS, chunk == 0);
                    if (per_path && live) {
                        float* o = per_path + ((long long)g * b.num_paths + p) * PATH_COLS;
                        o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                        o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
                    }
                }
            }
        }
    }
}

// A CTA's floats of the gbm store and of its scratch (rows of a pass).
static long long gbm_store_floats(int num_bars) {
    return (long long)BAR_PLANES * num_bars * BLOCK;
}

static long long gbm_scratch_floats(int n_rows) {
    return (long long)(n_rows < GATED_GBM_ROWS ? n_rows : GATED_GBM_ROWS) * GATED_GBM_ACC * BLOCK;
}

#undef GATED_ENTRY_NOISE
#undef GATED_TIE

template <int KIND>
static int resident_ctas(int vgrid) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_gated_sampler_sweep_kernel<MAX_LEVELS, KIND>, BLOCK, 0);
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return -(int)rc;
    const int n = per_sm * sms;
    return n < 1 ? 1 : (n < vgrid ? n : vgrid);
}

extern "C" {

// The layouts the host mirrors: 0 GatedArgs, 1 SamplerArgs; 2 the kernel's
// static shared memory under the Heston sampler (bytes, from the runtime); 3
// the bar store's planes; 4 the gbm kernel's static shared memory.
int qmmx_gated_sampler_sweep_size(int which) {
    if (which == 0) return (int)sizeof(GatedArgs);
    if (which == 1) return (int)sizeof(SamplerArgs);
    if (which == 3) return BAR_PLANES;
    cudaFuncAttributes attr;
    const cudaError_t rc = which == 4
        ? cudaFuncGetAttributes(&attr, mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_GBM>)
        : cudaFuncGetAttributes(&attr, mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_HESTON>);
    return rc == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
}

const char* qmmx_gated_sampler_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The physical CTAs of a launch over ``vgrid`` virtual CTAs under sampler
// ``kind``: the CTAs the card holds at once, at most vgrid (the store's
// slots); a CUDA error as its negative.
int qmmx_gated_sampler_sweep_ctas(int kind, int vgrid) {
    if (kind == SAMPLER_RESAMPLE) return resident_ctas<SAMPLER_RESAMPLE>(vgrid);
    if (kind == SAMPLER_HESTON) return resident_ctas<SAMPLER_HESTON>(vgrid);
    return -(int)cudaErrorInvalidValue;
}

// Pass 1 of the n_rows grid rows at ``args`` (device memory, the bars'
// fields equal in every row) under sampler ``kind`` and the one history at
// ``sargs``, on ``ctas`` physical CTAs (qmmx_gated_sampler_sweep_ctas) over
// ``vgrid`` virtual ones, ``store`` ctas x BAR_PLANES x W x BLOCK floats;
// ext and per_path null when not used; partial rows [row][vgrid].  Returns
// cudaGetLastError().
int qmmx_mc_gated_sampler_sweep(const GatedArgs* args, int n_rows, const SamplerArgs* sargs,
                                int kind, int max_levels, const float* ext, float* store,
                                int ctas, int vgrid, long long* part_counts,
                                float* part_floats, float* per_path, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (max_levels > MAX_LEVELS || n_rows < 1 || ctas < 1 || ctas > vgrid)
        return (int)cudaErrorInvalidValue;
    if (kind == SAMPLER_RESAMPLE) {
        mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_RESAMPLE><<<ctas, BLOCK, 0, s>>>(
            args, n_rows, sargs, ext, store, vgrid, part_counts, part_floats, per_path, nullptr);
    } else if (kind == SAMPLER_HESTON) {
        mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_HESTON><<<ctas, BLOCK, 0, s>>>(
            args, n_rows, sargs, ext, store, vgrid, part_counts, part_floats, per_path, nullptr);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The gbm launch of n_rows grid rows over ``vgrid`` virtual CTAs at W bars,
// into out[5]: 0 the physical CTAs (those the card holds at once, at most
// vgrid, and no more than keep the store and the scratch within
// GATED_GBM_STORE_MIB), 1 the store's floats and 2 the scratch's (of all of
// them), 3 the rows replayed over one making of the bars, 4 the store's
// planes (BAR_PLANES).  Returns 0 or a CUDA error.
int qmmx_gated_gbm_sweep_plan(int num_bars, int n_rows, int vgrid, long long* out) {
    if (num_bars < 2 || (num_bars & 1) || n_rows < 1 || vgrid < 1 || !out)
        return (int)cudaErrorInvalidValue;
    const long long cta_bytes = 4 * (gbm_store_floats(num_bars) + gbm_scratch_floats(n_rows));
    const long long budget = ((long long)GATED_GBM_STORE_MIB << 20) / cta_bytes;
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_GBM>, BLOCK, 0);
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1 || budget < 1) return (int)cudaErrorInvalidConfiguration;
    long long ctas = (long long)per_sm * sms;
    ctas = ctas < vgrid ? ctas : vgrid;
    ctas = ctas < budget ? ctas : budget;
    out[0] = ctas;
    out[1] = ctas * gbm_store_floats(num_bars);
    out[2] = ctas * gbm_scratch_floats(n_rows);
    out[3] = n_rows < GATED_GBM_ROWS ? n_rows : GATED_GBM_ROWS;
    out[4] = BAR_PLANES;
    return 0;
}

// Pass 1 of the n_rows gbm grid rows at ``args`` (device memory, the bars'
// fields equal in every row), on ``ctas`` physical CTAs over ``vgrid``
// virtual ones, ``store`` and ``scratch`` as qmmx_gated_gbm_sweep_plan gives
// them for ``ctas``; ext and per_path null when not used; partial rows
// [row][vgrid].  The fold is mc_gated.cu's.  Returns cudaGetLastError().
int qmmx_mc_gated_gbm_sweep(const GatedArgs* args, int n_rows, int max_levels, const float* ext,
                            float* store, float* scratch, int ctas, int vgrid,
                            long long* part_counts, float* part_floats, float* per_path,
                            void* stream) {
    if (max_levels > MAX_LEVELS || n_rows < 1 || ctas < 1 || ctas > vgrid || !store || !scratch)
        return (int)cudaErrorInvalidValue;
    mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_GBM><<<ctas, BLOCK, 0,
                                                            (cudaStream_t)stream>>>(
        args, n_rows, nullptr, ext, store, vgrid, part_counts, part_floats, per_path, scratch);
    return (int)cudaGetLastError();
}

}  // extern "C"
