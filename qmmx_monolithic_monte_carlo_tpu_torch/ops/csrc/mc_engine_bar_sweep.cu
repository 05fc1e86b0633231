// The full engine's grid sweep on Hopper: each path's bars made once and
// replayed for every grid row, under gbm and the recorded-bar and Heston
// samplers, over the engine's whole envelope (1-64 level slots, any W >= 2,
// the windowed guard past 61 bars).
//
// mc_engine_bar_sweep_kernel<WIN, KIND> replaces the gbm and sampler branches
// of the TPU kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py
// _engine_sweep_kernel (#9, :1813, entry :2054), which reseeds and makes a
// path block's bars again for every grid row (:1846-1856).  It takes every
// launch of ops/cuda_engine.engine_sweep_rows: before, the sweep went to
// mc_engine_sweep_kernel (mc_engine.cu) or mc_engine_sampler_kernel
// (mc_engine_samplers.cu) with a row a blockIdx.y, or to their envelope
// kernels with a row a cell, and each row made the bars again.  Those keep
// their one-row uses (the single configuration), the universes and the books.
//
// A grid row changes which trades open and how the touch and guard state
// evolve, never the bars: a path's closes, highs, lows and volumes, each
// bar's tie coin and its noise uniforms are the same for every row (one key,
// one history; the noise stds scale the shared uniforms per row), and so is
// the windowed guard's box over the last 61 bars.  So one thread makes its
// path's bars once, into a bar store of four planes (close, high, low,
// volume: 16 bytes a bar) and, past 61 bars, two more (the guard's box after
// each bar, taken a 61-bar block at a time as env_guard_begin / _end take
// it), then replays each row's engine lifecycle (mc_engine_step.cuh on
// mc_engine_env.cuh's per-level state and rings in shared memory) over the
// store in turn, and adds the path to that row's partial row as the one-row
// kernel does.  The uniforms a row reads only rarely are drawn again where
// it reads them: the tie coin where a bar hits both stop and target
// (ENGINE_TIE), the four noise uniforms where a trade opens (the step's
// dr.at(noise_row ...)).  Measured on the card (probes; PERF.md): the rings
// as views of the store (20 loads a bar through L1) ran 11-14% slower than
// in shared memory; the stored guard box saves ~5% at W = 390.
//
// Store and grid.  The store is W x ENV_THREADS floats a plane, thread index
// fastest, a slot for each resident CTA: 640 bytes a thread at W = 40 (86 MB
// for 4 CTAs of 256 on 132 SMs, over the 50 MB L2), 9.4 KB at W = 390 (949
// MB at 3 CTAs an SM); past BAR_SWEEP_STORE_MIB fewer CTAs run.  The grid
// is persistent: physical CTA b takes the one-row kernel's CTAs (virtual
// CTAs) b, b + gridDim.x, ... and owns store slot b and its threads' slots of
// the env scratch (touch registers, the windowed guard's rings) for the
// whole launch.  Each virtual CTA's paths, the path-to-thread map and the bar
// arithmetic are the one-row kernel's (mc_engine_env.cuh env_rows), so row
// g's partial rows [row][CTA] and per-path rows [row][path] equal the one-row
// launch at row g's EngineArgs bit for bit (and so the parents' where they
// fit: the envelope kernels equal them).  The reductions are the one-row
// kernel's: the samplers add a chunk (a path a thread) to the partial row at
// a time (env_add_path_row); gbm sums a thread's paths in path order and
// reduces the CTA once, so here each (row, thread) keeps its six float
// accumulators in a device scratch ([row][6][thread], in L2) and each row
// its exact counts and histogram in shared memory (BAR_SWEEP_ROWS rows at a
// time: past that the bars are made again for the next rows).

// What bounds it on the H100: every row's lifecycle (the level loops, the
// gates, the flags in shared memory, the touch registers in the scratch) and
// once a path the bars (gbm: 3 logf, 3 sqrtf, 2 sincosf, 4 expf a double
// bar and its Philox calls; bootstrap: four gathers a bar from a table in
// L2; Heston: three Box-Muller pairs and the variance step a double bar);
// bytes: the partial rows, and in L2 / L1 the store (written once, read by
// every row).  Numerics as every engine kernel: -fmad=false, IEEE logf /
// sqrtf / sincosf / expf, fmaf where the JAX kernel's XLA fuses, no float
// atomics.  A library of its own, so the other engine kernels keep their code.

#include "mc_engine_env.cuh"
#include "mc_engine_bars.cuh"

#define BAR_SWEEP_PLANES 4        // close, high, low, volume
#define BAR_SWEEP_ROWS 32         // gbm: the rows replayed over one making of the bars
#define BAR_SWEEP_ACC 6           // gbm: a (row, thread)'s float accumulators
// CTAs of ENV_THREADS an SM for __launch_bounds__, without the windowed guard
// and with it (W > 61): of 2, 3 and 4 these ran fastest on the H100 (PERF.md)
#define BAR_SWEEP_MIN_BLOCKS 4
#define BAR_SWEEP_WIN_MIN_BLOCKS 3
// The most device memory (MiB) the store and the scratch of a launch's CTAs
// take together: past it fewer CTAs run (from W ~ 3500 under the windowed
// guard, where 396 CTAs would want 8 GiB; 220 MB a CTA at W = 35791).
#define BAR_SWEEP_STORE_MIB 8192

// The store's planes: the bars', and under the windowed guard the box's two.
__host__ __device__ __forceinline__ int sweep_planes(bool windowed) {
    return BAR_SWEEP_PLANES + (windowed ? 2 : 0);
}

// gbm: a row's exact counts (64-bit) and histogram in shared memory.
__host__ __device__ __forceinline__ int sweep_row_bytes() {
    return 8 * (N_COUNTS + N_SKIPS) + 4 * HIST_BINS;
}

// A CTA's dynamic shared memory: env_view's (the row's level table, the
// threads' rings, flags and contact counts), then ``rows`` rows' counts and
// histograms (gbm; 0 otherwise).
__host__ __device__ __forceinline__ int sweep_smem_bytes(int levels, int rows) {
    return env_smem_bytes(levels, ENV_THREADS) + rows * sweep_row_bytes();
}

// The rows replayed over one making of the bars: gbm keeps a row's counts in
// shared memory, so at most BAR_SWEEP_ROWS; the samplers add to the partial
// rows directly, so every row.
__host__ __device__ __forceinline__ int sweep_rows_per_pass(int kind, int n_rows) {
    return kind == ENV_GBM && n_rows > BAR_SWEEP_ROWS ? BAR_SWEEP_ROWS : n_rows;
}

// A thread's 4-byte slots of the device scratch: env_scratch_slots, then
// under gbm the pass's rows' float accumulators.
__host__ __device__ __forceinline__ int sweep_scratch_slots(int kind, int levels, int num_bars,
                                                           int n_rows) {
    return env_scratch_slots(levels, num_bars > GUARD_WINDOW)
           + (kind == ENV_GBM ? BAR_SWEEP_ACC * sweep_rows_per_pass(kind, n_rows) : 0);
}

// A path's state at the start of a row's replay (env_init_state's): the
// scalars, and this thread's rings, flag words and contact counts.
__device__ __forceinline__ void sweep_init_state(const EngineArgs& a, EnvState& st) {
    st.log_s = a.log_s0;
    st.prev_c = expf(a.log_s0);
    st.entry = st.stop = st.target = st.risk0 = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.run_low = INF_F; st.run_high = -INF_F;
    st.box_low = st.box_high = 0.f;
    st.block_low = INF_F; st.block_high = -INF_F;
    st.side = st.last_dir = st.trades = st.wins = st.losses = st.escal = 0;
    st.cooldown_until = -(1 << 30);
    st.box_valid = st.regime = st.inside_cnt = 0;
#pragma unroll
    for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
#pragma unroll
    for (int j = 0; j < N_SKIPS; ++j) st.skips[j] = 0;
    const EnvView ev = env_view(a.max_levels, nullptr);
    const int n = a.max_levels, nt = ev.nt;
    for (int i = 0; i < n; ++i) ev.cc[i * nt] = 0;
    for (int k = 0; k < env_latch_words(n); ++k) ev.latch[k * nt] = 0u;
    for (int k = 0; k < env_has_words(n); ++k) ev.tmh[k * nt] = 0u;
    for (int j = 0; j < VOL_RING; ++j) ev.vol[j * nt] = 0.f;
    for (int j = 0; j < CLOSE_RING; ++j) ev.close[j * nt] = 0.f;
}

// ---- making the bars (env_walk's draws and mc_engine_bars.cuh's arithmetic)

// One path's W bars under sampler KIND into the store (``bar``: this
// thread's bar 0 of the close plane; mc_engine_bars.cuh's make_bars).
template <bool WIN, int KIND>
__device__ __forceinline__ void sweep_bars(const EngineArgs& a, const SamplerArgs& s, Draws& dr,
                                           float* bar, int plane, float* scratch) {
    float log_s = a.log_s0;
    float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
    make_bars<KIND, false>(a, s, dr, log_s, carry, 0, a.num_bars, bar, ENV_THREADS, plane);
    if constexpr (WIN) {
        // the windowed guard's box after each bar (env_guard_begin / _end on
        // the thread's guard rings in the scratch), for the replay's GUARD_PUSH
        const EnvView ev = env_view(a.max_levels, scratch);
        EnvState st;
        st.block_low = INF_F; st.block_high = -INF_F;
#pragma unroll 1
        for (int t = 0; t < a.num_bars; ++t) {
            float* const b = bar + (long long)t * ENV_THREADS;
            float lo = 0.f, hi = 0.f;
            env_guard_begin(ev, t, lo, hi);
            env_guard_end(st, ev, t, b[2 * plane], b[plane], lo, hi);
            b[4 * plane] = st.run_low;
            b[5 * plane] = st.run_high;
        }
    }
}

// ---- replaying a row

#undef ENGINE_TIE
#define ENGINE_TIE dr.at(tie_row)
#undef GUARD_PUSH
#define GUARD_PUSH                                                          \
    if constexpr (WIN) {                                                    \
        st.run_low = bar[4 * plane];                                        \
        st.run_high = bar[5 * plane];                                       \
    } else {                                                                \
        st.run_low = fminf(st.run_low, l);                                  \
        st.run_high = fmaxf(st.run_high, h);                                \
    }

// Bar t of one row's lifecycle (mc_engine_step.cuh on env_view's state) on
// the stored bar ``bar`` (this thread's close at bar t; past 61 bars the
// guard's box after it in planes 4 and 5, GUARD_PUSH); the bar's tie coin
// at row ``tie_row`` and its noise from ``noise_row`` of the path's draws
// ``dr``, drawn where read.  Not inlined (common.cuh).
template <bool WIN>
__device__ __noinline__ void replay_bar_step(const EngineArgs& a, EnvState& st, Draws& dr,
                                             float* scratch, int t, const float* bar, int plane,
                                             int tie_row, int noise_row) {
    const EnvView ev = env_view(a.max_levels, scratch);
    const WideLevel* const lv = ev.lv;
    const EnvRings rg{ev.vol, ev.close, ev.nt};
    const float c = bar[0], h = bar[plane], l = bar[2 * plane], v = bar[3 * plane];
#include "mc_engine_step.cuh"
}

// Row ``src`` of the argument rows into the CTA's shared copy, a word a
// thread (every thread calls it; a barrier follows).
__device__ __forceinline__ void copy_args(EngineArgs* dst, const EngineArgs* __restrict__ src) {
    static_assert(sizeof(EngineArgs) % 4 == 0, "EngineArgs is copied in words");
    const int* s = (const int*)src;
    int* d = (int*)dst;
    for (int i = threadIdx.x; i < (int)(sizeof(EngineArgs) / 4); i += ENV_THREADS) d[i] = s[i];
}

// A launch's pointers and shape (the kernel's one parameter).
struct BarSweepLaunch {
    const EngineArgs* args;       // [n_rows]; the bars' fields equal in every row
    const SamplerArgs* sargs;     // the one history, the samplers only
    const WideLevel* levels;      // [n_rows, max_levels]
    const float* ext;             // injected uniforms, or null (Philox)
    float* store;                 // [gridDim.x][sweep_planes(W > 61)][W][ENV_THREADS]
    float* scratch;               // [sweep_scratch_slots][gridDim.x * ENV_THREADS]
    long long* part_counts;       // [n_rows, vgrid, ROW_COUNTS]
    float* part_floats;           // [n_rows, vgrid, ROW_FLOATS]
    float* per_path;              // [n_rows, num_paths, PATH_COLS], or null
    int vgrid, n_rows;            // the one-row kernel's CTAs; the grid rows
};

// Every path of ``vgrid`` virtual CTAs against the rows: physical CTA
// blockIdx.x takes virtual CTAs blockIdx.x, blockIdx.x + gridDim.x, ...,
// each in the one-row kernel's chunk order; for each chunk (a path a
// thread) it makes the bars once into its store slot, then replays each row
// of the pass and adds the path to the row's partial row.
template <bool WIN, int KIND>
__global__ void
__launch_bounds__(ENV_THREADS, WIN ? BAR_SWEEP_WIN_MIN_BLOCKS : BAR_SWEEP_MIN_BLOCKS)
mc_engine_bar_sweep_kernel(const BarSweepLaunch p) {
    constexpr int NC = N_COUNTS + N_SKIPS;
    __shared__ EngineArgs s_bars;        // row 0: what makes the bars, every row's
    __shared__ EngineArgs s_a;           // the row being replayed
    __shared__ SamplerArgs s_s;
    __shared__ float s_red[ROW_FLOATS][ENV_THREADS / 32];
    const int nt = ENV_THREADS, tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    copy_args(&s_bars, p.args);
    if (tid == 0 && KIND != ENV_GBM) s_s = *p.sargs;
    __syncthreads();
    const EngineArgs& b = s_bars;
    const EngineArgs& a = s_a;
    const long long num_paths = b.num_paths;
    const int row_len = ENGINE_SUB * b.lanes;
    const int plane = b.num_bars * nt;
    const int levels = b.max_levels;
    float* const bar0 = p.store + (long long)blockIdx.x * sweep_planes(WIN) * plane + tid;
    float* const scratch = p.scratch + (long long)blockIdx.x * nt + tid;
    const int ws = gridDim.x * nt;
    const float* ext = p.ext ? p.ext + b.ext_offset : nullptr;
    const int pass_rows = sweep_rows_per_pass(KIND, p.n_rows);
    // gbm: the pass's rows' counts and histograms after the flags and counts
    unsigned long long* const s_cnt = (unsigned long long*)(env_smem + env_smem_bytes(levels, nt));
    unsigned* const s_hist = (unsigned*)(s_cnt + (long long)pass_rows * NC);
    float* const acc = scratch + (long long)env_scratch_slots(levels, WIN) * ws;
    for (int v = blockIdx.x; v < p.vgrid; v += gridDim.x) {
        for (int g0 = 0; g0 < p.n_rows; g0 += pass_rows) {
            const int nr = min(pass_rows, p.n_rows - g0);
            if constexpr (KIND == ENV_GBM) {
                for (int i = tid; i < nr * NC; i += nt) s_cnt[i] = 0ull;
                for (int i = tid; i < nr * HIST_BINS; i += nt) s_hist[i] = 0u;
                for (int j = 0; j < nr; ++j) {
                    float* const r = acc + (long long)j * BAR_SWEEP_ACC * ws;
                    r[0] = 0.f; r[ws] = 0.f; r[2 * ws] = 0.f;
                    r[3 * ws] = BIG; r[4 * ws] = -BIG; r[5 * ws] = 0.f;
                }
            }
            int chunk = 0;
            // every thread runs the cell's chunks and rows, so the barriers line up
            for (long long base = (long long)v * nt; base < num_paths;
                 base += (long long)p.vgrid * nt, ++chunk) {
                const long long q = base + tid;
                const bool live = q < num_paths;
                const long long blk = q / row_len;
                const int col = (int)(q - blk * row_len);
                if (live) {
                    Draws dr{ext, blk, col, row_len, b.u_rows, b.seed, b.stream, -1,
                             make_uint4(0u, 0u, 0u, 0u)};
                    sweep_bars<WIN, KIND>(b, s_s, dr, bar0, plane, scratch);
                }
                for (int j = 0; j < nr; ++j) {
                    const int g = g0 + j;
                    __syncthreads();           // the last row's readers of s_a are done
                    copy_args(&s_a, p.args + g);
                    copy_levels((WideLevel*)env_smem, p.levels, g, levels);
                    __syncthreads();
                    EnvState st;
                    sweep_init_state(a, st);
                    if (live) {
                        Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                                 make_uint4(0u, 0u, 0u, 0u)};
#pragma unroll 1
                        for (int t = 0; t < a.num_bars; ++t)
                            replay_bar_step<WIN>(a, st, dr, scratch, t,
                                                 bar0 + (long long)t * nt, plane,
                                                 tie_row_of<KIND>(t, a.stride),
                                                 noise_row_of<KIND>(t, a.stride));
                    }
                    const bool entered = st.trades > 0;
                    if constexpr (KIND == ENV_GBM) {
                        // env_rows' gbm accumulation, the thread's paths in order
                        const unsigned cnt[NC] = {
                            live ? 1u : 0u, entered ? 1u : 0u, (unsigned)st.wins,
                            (unsigned)st.losses, st.side != 0 ? 1u : 0u, (unsigned)st.trades,
                            (unsigned)st.escal, (unsigned)st.skips[0], (unsigned)st.skips[1],
                            (unsigned)st.skips[2], (unsigned)st.skips[3], (unsigned)st.skips[4],
                            (unsigned)st.skips[5], (unsigned)st.skips[6], (unsigned)st.skips[7],
                            (unsigned)st.skips[8], (unsigned)st.skips[9], (unsigned)st.skips[10],
                            (unsigned)st.skips[11], (unsigned)st.skips[12], (unsigned)st.skips[13],
                            (unsigned)st.skips[14], (unsigned)st.skips[15]};
                        unsigned long long* const rc = s_cnt + (long long)j * NC;
#pragma unroll
                        for (int k = 0; k < NC; ++k) {
                            const unsigned s = __reduce_add_sync(0xffffffffu, cnt[k]);
                            if (wl == 0 && s) atomicAdd(&rc[k], (unsigned long long)s);
                        }
                        if (live) {
                            float* const r = acc + (long long)j * BAR_SWEEP_ACC * ws;
                            r[0] = r[0] + st.equity;
                            r[ws] = r[ws] + st.equity * st.equity;
                            r[2 * ws] = r[2 * ws] + st.dd;
                            r[5 * ws] = fmaxf(r[5 * ws], st.dd);
                            if (entered) {
                                r[3 * ws] = fminf(r[3 * ws], st.equity);
                                r[4 * ws] = fmaxf(r[4 * ws], st.equity);
                                const int bin = min(max((int)((st.equity - LIFE_HIST_LO)
                                                              * LIFE_BIN_SCALE), 0),
                                                    HIST_BINS - 1);
                                atomicAdd(&s_hist[j * HIST_BINS + bin], 1u);
                            }
                        }
                    } else {
                        const long long seg = (long long)g * p.vgrid + v;
                        int cnt[NC] = {live ? 1 : 0, entered, st.wins, st.losses,
                                       st.side != 0, st.trades, st.escal};
#pragma unroll
                        for (int k = 0; k < N_SKIPS; ++k) cnt[N_COUNTS + k] = st.skips[k];
                        env_add_path_row(cnt, entered, st.equity, st.dd,
                                         p.part_counts + seg * ROW_COUNTS,
                                         p.part_floats + seg * ROW_FLOATS, chunk == 0);
                    }
                    if (p.per_path && live)
                        env_path_row(st, p.per_path + ((long long)g * num_paths + q) * PATH_COLS);
                }
            }
            if constexpr (KIND == ENV_GBM) {
                // each row of the pass: env_rows' CTA reduction of the threads' sums
                for (int j = 0; j < nr; ++j) {
                    const long long seg = (long long)(g0 + j) * p.vgrid + v;
                    long long* const crow = p.part_counts + seg * ROW_COUNTS;
                    float* const frow = p.part_floats + seg * ROW_FLOATS;
                    const float* const r = acc + (long long)j * BAR_SWEEP_ACC * ws;
                    const float sum_eq = warp_sum(r[0]), sum_eq2 = warp_sum(r[ws]);
                    const float sum_dd = warp_sum(r[2 * ws]);
                    const float min_eq = warp_min(r[3 * ws]), max_eq = warp_max(r[4 * ws]);
                    const float max_dd = warp_max(r[5 * ws]);
                    __syncthreads();           // the count atomics and the last row's readers
                    if (wl == 0) {
                        s_red[0][warp] = sum_eq; s_red[1][warp] = sum_eq2;
                        s_red[2][warp] = sum_dd; s_red[3][warp] = min_eq;
                        s_red[4][warp] = max_eq; s_red[5][warp] = max_dd;
                    }
                    __syncthreads();
                    if (tid < NC) crow[tid] = (long long)s_cnt[(long long)j * NC + tid];
                    for (int i = tid; i < HIST_BINS; i += nt)
                        crow[NC + i] = (long long)s_hist[j * HIST_BINS + i];
                    if (tid == 0) {
                        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
                        for (int w = 0; w < (nt >> 5); ++w) {
                            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
                            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
                            md = fmaxf(md, s_red[5][w]);
                        }
                        frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx;
                        frow[5] = md;
                    }
                }
            }
            __syncthreads();                   // the pass's readers of the shared rows
        }
    }
}

// Call f(kernel) with the kernel of (windowed, kind); returns f's value, or
// cudaErrorInvalidValue for an unknown kind.
template <class F>
static int with_kernel(bool windowed, int kind, F&& f) {
    return wide_dispatch(windowed, [&](auto w) {
        constexpr bool WIN = decltype(w)::value;
        if (kind == ENV_GBM) return f(mc_engine_bar_sweep_kernel<WIN, ENV_GBM>);
        if (kind == SAMPLER_RESAMPLE) return f(mc_engine_bar_sweep_kernel<WIN, SAMPLER_RESAMPLE>);
        if (kind == SAMPLER_HESTON) return f(mc_engine_bar_sweep_kernel<WIN, SAMPLER_HESTON>);
        return (int)cudaErrorInvalidValue;
    });
}

static bool shape_ok(int kind, int n_rows, int max_levels, int num_bars, int vgrid) {
    return (kind == ENV_GBM || kind == SAMPLER_RESAMPLE || kind == SAMPLER_HESTON)
           && env_shape_ok(n_rows, max_levels, num_bars, vgrid)
           && (long long)num_bars * ENV_THREADS < (1ll << 31);
}

// A CTA's floats of the store and of the scratch.
static long long store_floats(int num_bars) {
    return (long long)sweep_planes(num_bars > GUARD_WINDOW) * num_bars * ENV_THREADS;
}

static long long scratch_floats(int kind, int max_levels, int num_bars, int n_rows) {
    return (long long)sweep_scratch_slots(kind, max_levels, num_bars, n_rows) * ENV_THREADS;
}

static int launch_smem_bytes(int kind, int max_levels, int n_rows) {
    return sweep_smem_bytes(max_levels, kind == ENV_GBM ? sweep_rows_per_pass(kind, n_rows) : 0);
}

extern "C" {

// 0 EngineArgs, 1 SamplerArgs, 2 WideLevel (bytes, for the host's layouts);
// 3 the kernels' static shared memory, the most of the six (bytes, from the
// runtime).
int qmmx_engine_bar_sweep_size(int which) {
    if (which == 3) {
        const int kinds[3] = {ENV_GBM, SAMPLER_RESAMPLE, SAMPLER_HESTON};
        int most = 0;
        for (int win = 0; win < 2; ++win)
            for (int k = 0; k < 3; ++k) {
                const int rc = with_kernel(win != 0, kinds[k], [&](auto kernel) {
                    cudaFuncAttributes fa;
                    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
                    return e == cudaSuccess ? (int)fa.sharedSizeBytes : -1;
                });
                if (rc < 0) return -1;
                most = rc > most ? rc : most;
            }
        return most;
    }
    switch (which) {
        case 0: return (int)sizeof(EngineArgs);
        case 1: return (int)sizeof(SamplerArgs);
        case 2: return (int)sizeof(WideLevel);
        default: return -1;
    }
}

const char* qmmx_engine_bar_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The launch of n_rows grid rows over ``vgrid`` virtual CTAs, into out[5]:
// 0 the physical CTAs (those the card holds at once at the launch's shared
// memory, at most vgrid, and no more than keep the store and the scratch
// within BAR_SWEEP_STORE_MIB), 1 the store's floats and 2 the scratch's (of
// all of them), 3 a CTA's dynamic shared memory (bytes), 4 the rows replayed
// over one making of the bars.  Returns 0 or a CUDA error.
int qmmx_engine_bar_sweep_plan(int kind, int max_levels, int num_bars, int n_rows, int vgrid,
                               long long* out) {
    if (!shape_ok(kind, n_rows, max_levels, num_bars, vgrid) || !out)
        return (int)cudaErrorInvalidValue;
    const int smem = launch_smem_bytes(kind, max_levels, n_rows);
    const long long cta_bytes = 4 * (store_floats(num_bars)
                                     + scratch_floats(kind, max_levels, num_bars, n_rows));
    const long long budget = ((long long)BAR_SWEEP_STORE_MIB << 20) / cta_bytes;
    int per_sm = 0;
    const int rc = with_kernel(num_bars > GUARD_WINDOW, kind, [&](auto kernel) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ENV_THREADS,
                                                              (size_t)smem);
        return (int)e;
    });
    if (rc != 0) return rc;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1 || budget < 1) return (int)cudaErrorInvalidConfiguration;
    long long ctas = (long long)per_sm * sms;
    ctas = ctas < vgrid ? ctas : vgrid;
    ctas = ctas < budget ? ctas : budget;
    out[0] = ctas;
    out[1] = ctas * store_floats(num_bars);
    out[2] = ctas * scratch_floats(kind, max_levels, num_bars, n_rows);
    out[3] = smem;
    out[4] = kind == ENV_GBM ? sweep_rows_per_pass(kind, n_rows) : n_rows;
    return 0;
}

// Pass 1 of the n_rows grid rows at ``args`` (device memory; the bars'
// fields equal in every row) with their [n_rows, max_levels] level table
// ``levels`` under sampler ``kind`` (ENV_GBM, SAMPLER_RESAMPLE or
// SAMPLER_HESTON, the one history at ``sargs``), on ``ctas`` physical CTAs
// over ``vgrid`` virtual ones, ``store`` and ``scratch`` as
// qmmx_engine_bar_sweep_plan gives them for ``ctas``; ext and per_path null
// when not used; partial rows [row][vgrid].  The fold is mc_engine.cu's.
// Returns the first CUDA error.
int qmmx_mc_engine_bar_sweep(const EngineArgs* args, const SamplerArgs* sargs,
                             const WideLevel* levels, int n_rows, int kind, int max_levels,
                             int num_bars, const float* ext, float* store, float* scratch,
                             int ctas, int vgrid, long long* part_counts, float* part_floats,
                             float* per_path, void* stream) {
    if (!shape_ok(kind, n_rows, max_levels, num_bars, vgrid) || ctas < 1 || ctas > vgrid
        || !store || !scratch || (kind != ENV_GBM && !sargs))
        return (int)cudaErrorInvalidValue;
    const int smem = launch_smem_bytes(kind, max_levels, n_rows);
    const BarSweepLaunch p{args, sargs, levels, ext, store, scratch, part_counts, part_floats,
                           per_path, vgrid, n_rows};
    return with_kernel(num_bars > GUARD_WINDOW, kind, [&](auto kernel) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
        if (e != cudaSuccess) return (int)e;
        kernel<<<(unsigned)ctas, ENV_THREADS, smem, (cudaStream_t)stream>>>(p);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
