// The full engine's single-run rows on Hopper, warp-specialised: two producer
// warpgroups make the bars, two consumer warpgroups run the engine's
// lifecycle on them, a path a thread on each side.
//
// mc_engine_rows_kernel<KIND> replaces the gbm branch of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_kernel (#8,
// :1415, entry :1769) and its bootstrap, block-bootstrap and Heston branches
// (#8', :472-519), where up to 8 levels and an even W <= 61 (the envelope
// kernels, mc_engine_wide*.cu, take the rest, and the harvest); with a row a
// blockIdx.y, as the parents did, also _engine_universe_kernel (#10, #10')
// and _engine_universe_sweep_kernel (#11, #11'): a row is a symbol or a
// (symbol, grid row) cell.  It takes every launch that went to
// mc_engine_sweep_kernel (mc_engine.cu) and mc_engine_sampler_kernel
// (mc_engine_samplers.cu); those stay built, as the A/B the checks hold this
// kernel against, and the books keep their own kernels.
//
// What held the parents back (PERF.md §5, the engine step's profile): one
// thread made a path's bars and ran its lifecycle, with the bar step a
// called function taking the path state by reference, so the whole state
// (624 bytes) lived in the thread's local memory and every bar read and
// wrote it through L1; the bars were 15-28% of the step.  Here:
//
// * A CTA is two producer and two consumer warpgroups (BLOCK threads
//   each), one CTA an SM.  setmaxnreg gives the producers
//   ROWS_PRODUCER_REGS registers and the consumers ROWS_CONSUMER_REGS (the
//   kernel is one if-else on the role, so the two never reconverge).
// * The producers make a tile of ROWS_TILE bars for each of the CTA's 256
//   paths (a path a thread): close, high, low and volume, 16 bytes a
//   path-bar, into a ring of ROWS_STAGES stages in shared memory, with
//   mc_engine_bars.cuh's make_bars on the parents' draws (Philox or
//   injected; the antithetic mirror takes its partner's first pair, as the
//   parents do), so every bar equals the parents' bit for bit.  mbarriers
//   hand the stages over (full: the producers arrive, the
//   consumers wait; empty: the reverse), so a consumer warp waits for its
//   bars and for no other consumer warp; every consumer arrives at every
//   stage, a thread past num_paths included.
// * The producers also compute what the step decides from the bars, the
//   levels and the row's knobs alone -- the nearest level, the direction,
//   the volume veto's outcome and the policy gate's -- from the step's own
//   text (mc_engine_nearest.cuh, mc_engine_veto.cuh, mc_engine_policy.cuh;
//   the veto reads a path's last GATE_RING volumes from a ring of their
//   own) into a fifth plane of flags, which the consumers' step reads
//   (ENGINE_BAR_NEAREST, ENGINE_BAR_DIRECTION, ENGINE_BAR_VETO,
//   ENGINE_BAR_POLICY_FAILS).  The veto's and the policy's work ran in the
//   divergent part of the ladder, at 3-4 lanes of 32 (PERF.md §6).
// * The consumers replay mc_engine_step.cuh over the tile, the step inlined
//   in a rolled loop, the path's scalars in registers; the per-level state
//   struct-of-arrays in shared memory (slot j of thread i at [j][i]): the
//   volume and close rings, the contact counts and skip counts (bytes: a
//   path counts at most 61 bars), each (level, side)'s touch count and bar
//   (16 bits each) and price, read under the touch flag as the envelope
//   reads them (mc_engine_env.cuh), so a breakout clears the flags alone.
//   The tie coin and the noise uniforms are drawn again where the
//   lifecycle reads them (ENGINE_TIE, the step's dr.at), not stored.
// * The path map (the parents' grid-stride chunks of 256 paths a CTA), the
//   draws and the reductions are the parents': gbm sums a thread's paths in
//   path order and reduces the CTA once (engine_block), the samplers add a
//   chunk at a time (cta_add_path_row's order, on a consumers' barrier), so
//   the partial rows [row][CTA] and the per-path rows [row][path] equal the
//   parents' bit for bit.  Counts reach the rows
//   exactly (a warp's 32-bit sums added to 64-bit shared counters).
//
// The shape was probed on the card (PERF.md §6): two producer
// warpgroups (a path a thread) beat one (two paths a thread) by 3-35%, most
// where a CTA walks one chunk (config #4's universe); 16 bars a stage beat 8
// by 16-22% under gbm and Heston (fewer hand-overs a 40-bar path), 20 bars
// and 3-4 stages gained nothing (14 with the flags plane: 16 no longer fit);
// 2 CTAs an SM (96 consumer registers) spilled over 1 KB a thread and lost.
//
// What bounds it on the H100: the special functions of the bars (gbm: 3
// logf, 3 sqrtf, 4 expf, 2 sincosf and 2.5 Philox calls a double bar; a
// recorded bar: 3 expf and four gathers from the tables in L2; Heston: three
// Box-Muller pairs and the variance step a double bar) and the lifecycle's
// float32 and integer operations a bar, a third to a half of them in the
// divergent ladder past TOO_FAR; bytes: the partial rows.  Numerics as
// every engine kernel: -fmad=false, IEEE logf / sqrtf / sincosf / expf, fmaf
// only where the JAX kernel's XLA fuses, no float atomics.  A library of its
// own, so no other engine kernel's code moves.

#include "mc_engine.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_engine_bars.cuh"

#include "mc_engine_rows.cuh"

// A CTA's dynamic shared memory: the bar ring, the producers' volume ring,
// then the consumers' state.
struct RowsSmem {
    static constexpr int bars = ROWS_STAGES * ROWS_TILE * ROWS_PLANES * BLOCK;  // floats
    static constexpr int gate_vol = bars;                             // [GATE_RING][BLOCK]
    static constexpr int vol = gate_vol + GATE_RING * BLOCK;          // [VOL_RING][BLOCK]
    static constexpr int close = vol + VOL_RING * BLOCK;              // [CLOSE_RING][BLOCK]
    static constexpr int tmcb = close + CLOSE_RING * BLOCK;           // [2 MAX_LEVELS][BLOCK]
    static constexpr int tmpx = tmcb + 2 * MAX_LEVELS * BLOCK;        // [2 MAX_LEVELS][BLOCK]
    static constexpr int bytes8 = tmpx + 2 * MAX_LEVELS * BLOCK;      // then bytes:
    static constexpr int cc = 0;                                      // [MAX_LEVELS][BLOCK]
    static constexpr int skips = MAX_LEVELS * BLOCK;                  // [N_SKIPS][BLOCK]
    static constexpr int size = 4 * bytes8 + (MAX_LEVELS + N_SKIPS) * BLOCK;
};

extern __shared__ __align__(16) unsigned char rows_smem[];

// The producer warpgroups: for each chunk of the CTA's paths (the parents'
// order), every tile of bars of path tid and its bar-only gates, a stage at
// a time.
template <int KIND>
__device__ __forceinline__ void rows_produce(const EngineArgs& a, const SamplerArgs& s,
                                             const float* __restrict__ ext, float* bars,
                                             RowsBarriers& rb) {
    const int tid = threadIdx.x;
    const int row_len = ENGINE_SUB * a.lanes;
    const GateVols gate_vols{(float*)rows_smem + RowsSmem::gate_vol + tid};
    int g = 0;                                   // tiles handed over
    for (long long base = (long long)blockIdx.x * BLOCK; base < a.num_paths;
         base += (long long)gridDim.x * BLOCK) {
        const long long p = base + tid;
        float log_s = a.log_s0;
        float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
        int group = -1;                          // the draws' last Philox call, across tiles
        uint4 words = make_uint4(0u, 0u, 0u, 0u);
        GateState gs{expf(a.log_s0), 0};
        for (int t0 = 0; t0 < a.num_bars; t0 += ROWS_TILE, ++g) {
            const int stage = g % ROWS_STAGES;
            if (g >= ROWS_STAGES) mbar_wait(&rb.empty[stage], (g / ROWS_STAGES - 1) & 1);
            float* const out = bars + stage * (ROWS_TILE * ROWS_PLANES * BLOCK) + tid;
            const int t1 = min(t0 + ROWS_TILE, a.num_bars);
            if (p < a.num_paths) {
                const long long blk = p / row_len;
                const int col = (int)(p - blk * row_len);
                Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, group, words};
                make_bars<KIND, true>(a, s, dr, log_s, carry, t0, t1, out, ROWS_PLANES * BLOCK,
                                      BLOCK);
                group = dr.group;
                words = dr.words;
                tile_gates(a, gs, gate_vols, t0, t1, out);
            }
            mbar_arrive(&rb.full[stage]);
        }
    }
}

// Bar t of a path's lifecycle on the tile's bar at ``bar``.
template <int KIND>
__device__ __forceinline__ void replay_bar(const EngineArgs& a, RowsState& st, const RowDraw& dr,
                                           const Rings& rg, const RowsLevels& lvs, int t,
                                           const float* bar) {
    const float c = bar[0], h = bar[BLOCK], l = bar[2 * BLOCK], v = bar[3 * BLOCK];
    const unsigned bar_flags = __float_as_uint(bar[4 * BLOCK]);
    const int tie_row = tie_row_of<KIND>(t, a.stride);
    const int noise_row = noise_row_of<KIND>(t, a.stride);
#include "mc_engine_step.cuh"
}

// Warpgroups 1-2: thread tid (the parents' thread) walks the parents' paths
// of the CTA, a tile of bars at a time, and reduces them as the parents do.
template <int KIND>
__device__ __forceinline__ void rows_consume(const EngineArgs& a, const float* __restrict__ ext,
                                             const float* bars, RowsBarriers& rb,
                                             long long* __restrict__ crow,
                                             float* __restrict__ frow,
                                             float* __restrict__ per_path) {
    constexpr int NC = N_COUNTS + N_SKIPS;
    __shared__ unsigned long long s_counts[NC];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    const int tid = threadIdx.x - BLOCK;
    float* const f = (float*)rows_smem;
    const Rings rg{f + RowsSmem::vol + tid, f + RowsSmem::close + tid};
    unsigned char* const b8 = rows_smem + 4 * RowsSmem::bytes8;
    const RowsLevels lvs{b8 + RowsSmem::cc + tid, (unsigned*)(f + RowsSmem::tmcb) + tid,
                         f + RowsSmem::tmpx + tid};
    const SlotBytes skips{b8 + RowsSmem::skips + tid};
    if constexpr (KIND == 0) {
        for (int i = tid; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
        if (tid < NC) s_counts[tid] = 0ull;
        consumers_sync();
    }
    const int warp = tid >> 5, wl = tid & 31;
    float sum_eq = 0.f, sum_eq2 = 0.f, sum_dd = 0.f;
    float min_eq = BIG, max_eq = -BIG, max_dd = 0.f;
    int g = 0, chunk = 0;
    for (long long base = (long long)blockIdx.x * BLOCK; base < a.num_paths;
         base += (long long)gridDim.x * BLOCK, ++chunk) {
        const long long p = base + tid;
        const bool live = p < a.num_paths;
        const RowDraw dr{a, ext, p};
        RowsState st;
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
        for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
        st.skips = skips;
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) skips[j] = 0;
#pragma unroll
        for (int i = 0; i < MAX_LEVELS; ++i) C_COUNT(i) = 0;
#pragma unroll
        for (int j = 0; j < VOL_RING; ++j) rg.vol[j * BLOCK] = 0.f;
#pragma unroll
        for (int j = 0; j < CLOSE_RING; ++j) rg.close[j * BLOCK] = 0.f;
        for (int t0 = 0; t0 < a.num_bars; t0 += ROWS_TILE, ++g) {
            const int stage = g % ROWS_STAGES;
            mbar_wait(&rb.full[stage], (g / ROWS_STAGES) & 1);
            if (live) {
                const float* const tile = bars + stage * (ROWS_TILE * ROWS_PLANES * BLOCK) + tid;
                const int t1 = min(t0 + ROWS_TILE, a.num_bars);
#pragma unroll 1
                for (int t = t0; t < t1; ++t)
                    replay_bar<KIND>(a, st, dr, rg, lvs, t,
                                     tile + (t - t0) * (ROWS_PLANES * BLOCK));
            }
            mbar_arrive(&rb.empty[stage]);
        }
        const bool entered = st.trades > 0;
        const int open = st.side != 0;
        if constexpr (KIND == 0) {
            // engine_block's: the thread's paths in path order
            const unsigned cnt[NC] = {
                live ? 1u : 0u, entered ? 1u : 0u, (unsigned)st.wins, (unsigned)st.losses,
                (unsigned)open, (unsigned)st.trades, (unsigned)st.escal,
                skips[0], skips[1], skips[2], skips[3], skips[4], skips[5], skips[6],
                skips[7], skips[8], skips[9], skips[10], skips[11], skips[12], skips[13],
                skips[14], skips[15]};
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const unsigned s = __reduce_add_sync(0xffffffffu, cnt[k]);
                if (wl == 0 && s) atomicAdd(&s_counts[k], (unsigned long long)s);
            }
            if (live) {
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
            }
        } else {
            int cnt[NC] = {live ? 1 : 0, entered, st.wins, st.losses, open, st.trades, st.escal};
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = skips[j];
            rows_add_path_row(cnt, entered, st.equity, st.dd, crow, frow, chunk == 0);
        }
        if (per_path && live) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
            o[6] = (float)st.escal;
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)skips[j];
        }
    }
    if constexpr (KIND == 0) {
        // engine_block's CTA reduction
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
        consumers_sync();
        if (tid < NC) crow[tid] = (long long)s_counts[tid];
        for (int i = tid; i < HIST_BINS; i += BLOCK) crow[NC + i] = (long long)s_hist[i];
        if (tid == 0) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
            for (int w = 0; w < BLOCK / 32; ++w) {
                s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
                mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
                md = fmaxf(md, s_red[5][w]);
            }
            frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx;
            frow[5] = md;
        }
    }
}

// Row blockIdx.y of the rows ``args`` (and ``sargs`` under the samplers):
// partial rows [row][CTA], per-path rows [row][path] when per_path is not null.
template <int KIND>
__global__ void __launch_bounds__(ROWS_THREADS, ROWS_MIN_BLOCKS)
mc_engine_rows_kernel(const EngineArgs* __restrict__ args, const SamplerArgs* __restrict__ sargs,
                      const float* __restrict__ ext, long long* __restrict__ part_counts,
                      float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ RowsBarriers s_rb;
    if (threadIdx.x == 0) {
        s_a = args[blockIdx.y];
        if constexpr (KIND != 0) s_s = sargs[blockIdx.y];
        for (int k = 0; k < ROWS_STAGES; ++k) {
            mbar_init(&s_rb.full[k], BLOCK);
            mbar_init(&s_rb.empty[k], BLOCK);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    float* const bars = (float*)rows_smem;
    if (ext) ext += s_a.ext_offset;
    if (threadIdx.x < BLOCK) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(ROWS_PRODUCER_REGS));
        rows_produce<KIND>(s_a, s_s, ext, bars, s_rb);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(ROWS_CONSUMER_REGS));
        const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
        rows_consume<KIND>(s_a, ext, bars, s_rb, part_counts + seg * ROW_COUNTS,
                           part_floats + seg * ROW_FLOATS,
                           per_path ? per_path + (long long)blockIdx.y * s_a.num_paths * PATH_COLS
                                    : nullptr);
    }
}

// Call f(kernel) with the kernel of sampler ``kind``; returns f's value, or
// cudaErrorInvalidValue for an unknown kind.
template <class F>
static int with_kernel(int kind, F&& f) {
    if (kind == 0) return f(mc_engine_rows_kernel<0>);
    if (kind == SAMPLER_RESAMPLE) return f(mc_engine_rows_kernel<SAMPLER_RESAMPLE>);
    if (kind == SAMPLER_HESTON) return f(mc_engine_rows_kernel<SAMPLER_HESTON>);
    return (int)cudaErrorInvalidValue;
}

extern "C" {

// 0 EngineArgs, 1 SamplerArgs (bytes, for the host's layouts).
int qmmx_engine_rows_size(int which) {
    switch (which) {
        case 0: return (int)sizeof(EngineArgs);
        case 1: return (int)sizeof(SamplerArgs);
        default: return -1;
    }
}

// Pass 1 of the n_rows rows at ``args`` (and ``sargs`` for the samplers;
// device memory) under sampler ``kind`` (0 gbm, SAMPLER_RESAMPLE,
// SAMPLER_HESTON), one grid row per blockIdx.y; ext and per_path null when
// not used; partial rows [row][CTA], folded by mc_engine.cu's fold.  Refuses
// a launch whose registers at launch cannot hold what setmaxnreg gives the
// warpgroups.  Returns the first CUDA error.
int qmmx_mc_engine_rows(const EngineArgs* args, const SamplerArgs* sargs, int n_rows, int kind,
                        int max_levels, int num_bars, const float* ext, long long* part_counts,
                        float* part_floats, float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || num_bars > 61 || (num_bars & 1) || num_bars < 2
        || n_rows < 1 || n_rows > 65535 || (kind != 0 && !sargs))
        return (int)cudaErrorInvalidValue;
    return with_kernel(kind, [&](auto kernel) {
        cudaFuncAttributes fa;
        cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
        if (e != cudaSuccess) return (int)e;
        if (BLOCK * (ROWS_PRODUCER_REGS + ROWS_CONSUMER_REGS) > ROWS_THREADS * fa.numRegs)
            return (int)cudaErrorInvalidConfiguration;
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 RowsSmem::size);
        if (e != cudaSuccess) return (int)e;
        kernel<<<dim3(grid, n_rows), ROWS_THREADS, RowsSmem::size, (cudaStream_t)stream>>>(
            args, sargs, ext, part_counts, part_floats, per_path);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
