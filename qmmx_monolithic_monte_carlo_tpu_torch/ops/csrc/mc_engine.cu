// The full 12-gate QMMX engine Monte Carlo on Hopper: generate GBM bars and
// volumes, run the engine's whole entry ladder, position management with
// target escalation and the minute-close pipeline along each path, reduce to
// PathStats rows with the first-fail skip table and the escalation count.
//
// Replaces the TPU kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py
// _engine_kernel with its body _engine_lifecycle_loop and _engine_accumulate
// (gbm sampler, with and without execution noise, antithetic) where up to 8
// levels and an even horizon of at most 61 bars; the rest of the envelope
// (9-64 levels, odd W, W > 61) is mc_engine_wide.cu's.  The Pallas kernel advances ~145
// (8, 256) tiles of state per bar and gathers per-level state with one-hots;
// here one CUDA thread carries one path's state machine through its bars,
// bar by bar in the order of sim/enginepath.EngineLifecycle.step (whose
// arithmetic it repeats operation for operation):
//
//   B. stop/target off the bridge high/low with the distance-weighted tie
//      coin; on a target touch near the close, the escalation walk over the
//      5 newest finished bars (volume trend toward the level, approach,
//      next level, the stop trailed and rounded to cents);
//   C. the ladder, first failing gate counted: IN_POSITION, COOLDOWN,
//      NOLEVELS, DIR_UNKNOWN, TOO_FAR, the contact latch and
//      LEVEL_OVERTOUCHED, EDGE_FATIGUE / TOUCH_BUDGET / TOUCH_COOLDOWN and the
//      decay multiplier while accumulating, CONF_LOW, ACC_BREAKOUT_GATE, the
//      soft volume veto, the ML / blend gate, the OnlinePolicy gate;
//   D. the minute close: volume MAs, the guard's running box and regime
//      machine, touch registration per (level, side), the 3-deep edge-tap
//      stacks, the touch-box reset on a breakout.
//
// State: the per-level contact counts and latch and the per-(level, side)
// touch count / last time / last price are arrays of MAXL (a template
// parameter, one instantiation) reached only by unrolled loops on constant
// indices.  The 20-slot volume ring and 5-slot close ring live in shared
// memory, one slice per thread (slot j of thread i at [j][i], no bank
// conflicts); bar u writes slot u mod R and a reader addresses the bar it
// wants, so nothing shifts.  The guard box is the running min/max (valid
// while the horizon fits the 61-bar window: past it the wrapper launches
// mc_engine_wide.cu's windowed guard).
//
// What bounds it on the H100: the throughput of special functions and float32
// operations, not bytes.  Per bar: logf 3, sqrtf 3, expf 4, half a sincosf
// pair twice (price and volume normals), some 10-20 divisions (confidence,
// volume MAs and slope, touch distances in basis points), and a few hundred
// float32 and integer operations of the ladder and the minute close; a
// double-bar step draws 10 uniforms (18 with noise), 2.5 Philox4x32-10 calls.
// In Philox mode the kernel reads only its arguments and writes one partial
// row per CTA.  What the design does about it: the ladder stops at the
// first failing gate (later gates cannot change state), the escalation walk
// runs only on a target touch near the close, the noise normals only on a
// bar that enters; every Philox call's four words are used (a thread keeps
// the last call's words, and ten rows a step straddle calls); the Philox
// call and the bar step are called functions, not inlined.
// Each CTA copies its EngineArgs into shared memory and hands the bar step a
// reference to that copy: a reference to the kernel parameter itself makes
// every thread copy the struct into its stack frame (1072 bytes against
// 624), which cost 28% of the kernel's time at 2^28 paths on the H100.
//
// Numerics: logf, sqrtf, sincosf and expf -- never the fast-math intrinsics
// or nvcc's fast-math flag.  The build passes -fmad=false, so a*b+c rounds
// twice, as the plain PyTorch version computes it -- but where the JAX
// replay's compiler fuses (the four noise terms, the ML gate's dot product,
// the blend), which are explicit fmaf calls here and utils/floats.fma in the
// plain version.  Rounding to cents is rintf (half to even, as jnp.round).
// decay^count is an unrolled product, never powf.  Every constant arrives
// from the host, computed there in float64 or float32 as the plain version
// computes it.
//
// Determinism: a fixed grid (the wrapper sizes it from num_paths alone), a
// fixed path-to-thread map, warp-shuffle trees for the float sums and a
// second kernel that folds the partial rows in row order.  Counts, the skip
// table and escalations are integers from the thread to the int64 totals.
//
// mc_engine_sweep_kernel replaces the TPU kernel pallas_engine.py
// _engine_sweep_kernel: the full engine re-run for each of G knob rows (the
// 17 engine knobs of _pack_eng and the four noise stds; the ML model, policy,
// touch and guard settings shared), every row on the same uniforms (common
// random numbers).  What bounds it: G times what bounds one configuration,
// since the TPU kernel's design regenerates the bars for every row.  Design:
// a grid of (CTAs x G), blockIdx.y the row; a CTA copies its row's
// EngineArgs (packed on the host, the per-row derived values included) into
// shared memory and runs the per-path loop (engine_block, bar_step) on it.
// The single configuration (_engine_kernel's counterpart) is the same kernel
// at one row.  The Philox key and counters ignore the row, so row g equals
// the one-row launch under row g's arguments bit for bit, per-path skip
// counts included; partial rows are laid out [row][CTA] and the fold takes
// one CTA per row.  No per-path state is added.
//
// The same kernel replaces the TPU kernels pallas_engine.py
// _engine_universe_kernel and _engine_universe_sweep_kernel.  A universe of S
// symbols is S rows, row s packed on the host with symbol s's levels, spot,
// volatility (its host-f64 drift, sig_dt and log_s0), all 17 knobs and noise
// stds, the shared ML, policy, touch and guard records, its Philox key
// stream + 256 * symbol and the offset of its injected uniforms ([S, blocks,
// u_rows, 8, lanes]); the sweep of universes is S x G rows, row (s, g) with
// row g of symbol s's knob grid on symbol s's key and uniforms (common random
// numbers within a symbol).  Every row equals the single configuration at its
// arguments bit for bit; the fold takes one CTA per row.
//
// The correlated book (mc_engine_corr.cu) shares this file's device code
// through mc_engine.cuh.

#include "mc_engine.cuh"

// The paths of this CTA (blockIdx.x of gridDim.x) under arguments ``a``:
// the engine along each, reduced to one partial row (crow, frow); per-path
// rows at per_path[p] when per_path is not null.  The envelope kernels walk
// and reduce their paths in this order (mc_engine_env.cuh), so where both fit
// their rows equal this kernel's bit for bit.
template <int MAXL>
__device__ __forceinline__ void engine_block(const EngineArgs& a, const float* __restrict__ ext,
                                             long long* __restrict__ crow,
                                             float* __restrict__ frow,
                                             float* __restrict__ per_path) {
    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ unsigned long long s_counts[N_COUNTS + N_SKIPS];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
    if (threadIdx.x < N_COUNTS + N_SKIPS) s_counts[threadIdx.x] = 0ull;
    __syncthreads();

    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const int row_len = ENGINE_SUB * a.lanes;
    const int half_lanes = a.lanes >> 1;
    unsigned long long cnt[N_COUNTS + N_SKIPS];
#pragma unroll
    for (int j = 0; j < N_COUNTS + N_SKIPS; ++j) cnt[j] = 0ull;
    float sum_eq = 0.f, sum_eq2 = 0.f, sum_dd = 0.f;
    float min_eq = BIG, max_eq = -BIG, max_dd = 0.f;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / row_len;
        const int col = (int)(p - blk * row_len);
        // antithetic: right half-lanes take the left partner's normals negated
        const bool mirror = a.antithetic && (col % a.lanes) >= half_lanes;
        Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                 make_uint4(0u, 0u, 0u, 0u)};

        EngineState<MAXL> st;
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

#pragma unroll 1
        for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
            const int base = t2 * a.stride;
            float u[10];
#pragma unroll
            for (int k = 0; k < 10; ++k) u[k] = dr.at(base + k);
            if (mirror) {
                const float2 m = dr.pair_of(col - half_lanes, base);
                u[0] = m.x; u[1] = m.y;
            }
            const float rad = sqrtf(-2.0f * logf(u[0]));
            float sn, cs;
            sincosf(two_pi() * u[1], &sn, &cs);
            float z0 = rad * cs, z1 = rad * sn;
            if (mirror) { z0 = -z0; z1 = -z1; }
            const float vrad = sqrtf(-2.0f * logf(u[2]));
            float vsn, vcs;
            sincosf(two_pi() * u[3], &vsn, &vcs);
            bar_step<MAXL>(a, st, dr, rg, 2 * t2, z0, vrad * vcs, u[4], u[5],
                                u[6], base + 10);
            bar_step<MAXL>(a, st, dr, rg, 2 * t2 + 1, z1, vrad * vsn, u[7],
                                u[8], u[9], base + 14);
        }

        const bool entered = st.trades > 0;
        cnt[0] += 1ull;
        cnt[1] += entered ? 1ull : 0ull;
        cnt[2] += (unsigned long long)st.wins;
        cnt[3] += (unsigned long long)st.losses;
        cnt[4] += st.side != 0 ? 1ull : 0ull;
        cnt[5] += (unsigned long long)st.trades;
        cnt[6] += (unsigned long long)st.escal;
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] += (unsigned long long)st.skips[j];
        sum_eq += st.equity;
        sum_eq2 += st.equity * st.equity;
        sum_dd += st.dd;
        max_dd = fmaxf(max_dd, st.dd);
        if (entered) {
            min_eq = fminf(min_eq, st.equity);
            max_eq = fmaxf(max_eq, st.equity);
            const int bin = min(max((int)((st.equity - LIFE_HIST_LO) * LIFE_BIN_SCALE), 0),
                                HIST_BINS - 1);
            atomicAdd(&s_hist[bin], 1u);
        }
        if (per_path) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = st.side != 0 ? 1.f : 0.f; o[5] = st.dd;
            o[6] = (float)st.escal;
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < N_COUNTS + N_SKIPS; ++j) {
        const unsigned long long v = warp_count<unsigned long long>(cnt[j]);
        if (wl == 0) atomicAdd(&s_counts[j], v);
    }
    sum_eq = warp_sum(sum_eq);
    sum_eq2 = warp_sum(sum_eq2);
    sum_dd = warp_sum(sum_dd);
    min_eq = warp_min(min_eq);
    max_eq = warp_max(max_eq);
    max_dd = warp_max(max_dd);
    if (wl == 0) {
        s_red[0][warp] = sum_eq; s_red[1][warp] = sum_eq2; s_red[2][warp] = sum_dd;
        s_red[3][warp] = min_eq; s_red[4][warp] = max_eq; s_red[5][warp] = max_dd;
    }
    __syncthreads();
    if (threadIdx.x < N_COUNTS + N_SKIPS) crow[threadIdx.x] = (long long)s_counts[threadIdx.x];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK)
        crow[N_COUNTS + N_SKIPS + i] = (long long)s_hist[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
            md = fmaxf(md, s_red[5][w]);
        }
        frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx; frow[5] = md;
    }
}

// Row blockIdx.y of the grid ``rows`` (one row for a single configuration):
// partial rows [row][CTA], per-path rows [row][path].
template <int MAXL>
__global__ void __launch_bounds__(BLOCK)
mc_engine_sweep_kernel(const EngineArgs* __restrict__ rows, const float* __restrict__ ext,
                       long long* __restrict__ part_counts,
                       float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ EngineArgs s_a;
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    engine_block<MAXL>(s_a, ext ? ext + s_a.ext_offset : nullptr, part_counts + seg * ROW_COUNTS,
                       part_floats + seg * ROW_FLOATS,
                       per_path ? per_path + (long long)blockIdx.y * s_a.num_paths * PATH_COLS
                                : nullptr);
}

extern "C" {

int qmmx_engine_args_size(void) { return (int)sizeof(EngineArgs); }

const char* qmmx_engine_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Pass 1: the n_rows argument rows at ``rows`` (device memory), one grid row
// per blockIdx.y.  ext and per_path may be null (Philox mode; no per-path
// output).  Returns cudaGetLastError().
int qmmx_mc_engine_sweep(const EngineArgs* rows, int n_rows, int max_levels, int num_bars,
                         const float* ext, long long* part_counts, float* part_floats,
                         float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || num_bars > 61 || (num_bars & 1) || n_rows < 1
            || n_rows > 65535)
        return (int)cudaErrorInvalidValue;
    mc_engine_sweep_kernel<MAX_LEVELS><<<dim3(grid, n_rows), BLOCK, 0, (cudaStream_t)stream>>>(
        rows, ext, part_counts, part_floats, per_path);
    return (int)cudaGetLastError();
}

// Pass 2 over ``segments`` segments of ``rows`` partial rows each.  Returns
// cudaGetLastError().
int qmmx_mc_engine_reduce_rows(const long long* part_counts, const float* part_floats,
                               int rows, int segments, long long* tot_counts,
                               double* tot_floats, void* stream) {
    fold_lifecycle_rows<ROW_COUNTS><<<segments, BLOCK, 0, (cudaStream_t)stream>>>(
        part_counts, part_floats, rows, tot_counts, tot_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
