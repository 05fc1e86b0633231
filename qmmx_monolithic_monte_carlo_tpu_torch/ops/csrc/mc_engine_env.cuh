// The envelope's engine kernels redesigned for Hopper: mc_engine_wide_kernel
// (gbm, mc_engine_wide.cu), mc_engine_wide_sampler_kernel (the recorded-bar
// and Heston samplers, mc_engine_wide_samplers.cu), the books'
// mc_engine_wide_corr_kernel (mc_engine_wide_corr.cuh) and their harvest
// builds (mc_engine_wide{,_samplers,_corr,_corr_samplers}_harvest.cu, which
// define ENGINE_HARVEST first).  The envelope is the engine at 1-64 level
// slots, any horizon W >= 2 (an odd one ends with a half step; a book's is
// even) and horizons past the guard's 61-bar window.
//
// What held the first envelope kernels back: every thread kept its per-level
// state (64 slots of contact counts and latch, 128 of touch count, time,
// price and flag) and the guard's two 61-float rings in its local-memory
// stack, 2.3-2.8 KB, and folded both rings every bar: at 30 levels x 390
// bars the fold took a third of the time (PERF.md).  The design here does
// the same arithmetic (every path's result is the first kernels' bit for
// bit) and keeps as many threads resident as the registers allow:
//
// * What a bar reads at every level stays on chip: the latch and touch flags
//   as bits of 32-bit words ([i / 32][thread]) and the 16-bit contact counts
//   live in the CTA's dynamic shared memory beside the volume and close
//   rings, struct-of-arrays with the thread as the fast index (slot j of
//   thread i at [j][i]), sized by the launch's max_levels: 172 bytes a thread
//   at 30 levels (env_thread_bytes), 252 at 64: a CTA of 256 threads takes
//   at most 64.5 KB at every level count.
// * What a bar reads only at the nearest level, or where a touch registers,
//   lives in a device-memory scratch of the launch's resident threads
//   ([slot][thread], coalesced, in L2): each (level, side)'s touch count and
//   last touch's bar (16 bits each in a word; the step's milliseconds are
//   bar * 60000, taken when read) and price.  A flag bit says whether they
//   hold anything: a breakout clears the flag words alone, and a count reads
//   0 under a clear flag (env's TM_CNT / TM_CNT_INC), as the cleared state
//   would.  (All of it in shared memory would take 652 bytes a thread at 30
//   levels and hold 320 threads an SM: that ran slower than the first
//   kernels, PERF.md.)
// * The windowed guard (W > 61) keeps its 61-slot low and high rings in the
//   same scratch and takes the window's box a block of 61 bars at a time
//   (env_guard_begin / env_guard_end): at a block's first bar the last
//   block's slots become their suffix minima (maxima), in place; bar t =
//   61k + j's box is the extremum of slot j + 1's suffix (bars t - 60 ..
//   61k - 1) and the running extremum of block k (61k .. t).  Two loads and
//   two stores a bar, and the block pass at the same bar for every lane of a
//   warp.  Min and max are exact in any order and the prices hold no NaN, so
//   this equals the full fold (and the JAX kernel's _ring_fold) bit for bit.
// * The scratch needs a thread to own its slots for the whole launch, so the
//   grid is persistent: the launch's CTAs (at most the card's resident ones)
//   take the row-major (row, CTA) cells of the [rows, grid] partial rows
//   from an atomic counter, and each cell's paths and reduction are what a
//   CTA of that cell did before: its partial row does not depend on which
//   CTA took it, or when, so a row equals its one-row launch bit for bit.
//
// Only the path's scalars stay in the non-inlined bar step's frame.  Counts
// reach the partial rows exactly (per-thread 32-bit, a warp's in 64 bits);
// the float sums go path -> thread -> warp shuffle tree -> warps in order, as
// in the parents, so their partial rows equal the parents' where both fit.
// -fmad=false and the IEEE functions as in every engine kernel.

#pragma once

#include "mc_engine_wide.cuh"

#define ENV_THREADS 256           // a CTA's threads, at every level count
// CTAs of ENV_THREADS an SM whose registers the kernels leave room for
// (__launch_bounds__): gbm at 3 (80 registers and ~260 bytes of spill, 768
// threads an SM), the samplers at 4 (64, ~40-80 bytes of spill, 1024
// threads).  Of 128 / 80 / 64 registers these ran fastest on the H100, the
// spills notwithstanding: more threads hide the bar step's latencies
// (PERF.md, chip_smoke.py --envelope-times --min-blocks).
#define ENV_MIN_BLOCKS 3
#define ENV_SAMPLER_MIN_BLOCKS 4
#define ENV_STATIC_MAX 4096           // bytes: the kernels' static shared memory, at most

// Every env kernel's dynamic shared memory: the row's [max_levels] level
// table, then per thread (env_view) the volume and close rings, the flag
// words and the contact counts.
extern __shared__ __align__(16) unsigned char env_smem[];

__host__ __device__ __forceinline__ int env_latch_words(int levels) { return (levels + 31) >> 5; }
__host__ __device__ __forceinline__ int env_has_words(int levels) { return (2 * levels + 31) >> 5; }

// The shared-memory bytes of one thread: the rings and the flag words in 4
// bytes a slot, the contact counts in 2 (ops/cuda_engine.env_thread_bytes
// mirrors it).
__host__ __device__ __forceinline__ int env_thread_bytes(int levels) {
    return 4 * (VOL_RING + CLOSE_RING + env_latch_words(levels) + env_has_words(levels))
           + 2 * levels;
}

// A CTA's dynamic shared memory at ``levels`` slots and ``threads`` threads.
__host__ __device__ __forceinline__ int env_smem_bytes(int levels, int threads) {
    return (int)sizeof(WideLevel) * levels + threads * env_thread_bytes(levels);
}

// A thread's 4-byte slots of the device scratch (ops/cuda_engine mirrors it):
// [2 * levels] touch count | bar << 16, [2 * levels] touch prices, then with
// the windowed guard 61 lows and 61 highs.
__host__ __device__ __forceinline__ int env_scratch_slots(int levels, bool windowed) {
    return 4 * levels + (windowed ? 2 * GUARD_WINDOW : 0);
}

// This thread's columns of the CTA's shared memory and of the scratch.
struct EnvView {
    const WideLevel* lv;          // the row's level table (shared by the CTA)
    float* vol;                   // VOL_RING slots
    float* close;                 // CLOSE_RING slots
    unsigned* latch;              // [latch words]: bit i % 32 of word i / 32, level i latched
    unsigned* tmh;                // [has words]: bit j % 32 of word j / 32, (level, side) j touched
    unsigned short* cc;           // [levels]: contact counts
    unsigned* tmcb;               // scratch [2 * levels]: touch count | last touch's bar << 16
    float* px;                    // scratch [2 * levels]: the last touch's price, [2i + side]
    float* ring;                  // scratch [2 * 61]: the guard's lows, then highs
    int nt;                       // the stride of a shared slot: the CTA's threads
    int ws;                       // the stride of a scratch slot: the launch's threads
};

__device__ __forceinline__ EnvView env_view(int levels, float* scratch) {
    const int nt = ENV_THREADS, tid = threadIdx.x;
    float* const f = (float*)(env_smem + sizeof(WideLevel) * levels);
    unsigned* const w = (unsigned*)(f + (VOL_RING + CLOSE_RING) * nt);
    const int lw = env_latch_words(levels), hw = env_has_words(levels);
    EnvView v;
    v.lv = (const WideLevel*)env_smem;
    v.vol = f + tid;
    v.close = f + VOL_RING * nt + tid;
    v.latch = w + tid;
    v.tmh = w + lw * nt + tid;
    v.cc = (unsigned short*)(w + (lw + hw) * nt) + tid;
    v.nt = nt;
    v.ws = gridDim.x * nt;
    v.tmcb = (unsigned*)scratch;
    v.px = scratch + 2 * levels * v.ws;
    v.ring = scratch + 4 * levels * v.ws;
    return v;
}

// The volume and close rings of this thread, as Rings at the envelope's CTA size.
struct EnvRings {
    float* vol;
    float* close;
    int nt;
    __device__ float v(int bar) const { return vol[(bar % VOL_RING) * nt]; }
    __device__ float c(int bar) const { return close[(bar % CLOSE_RING) * nt]; }
};

// A path's scalars (the first envelope kernels' state without its per-level
// arrays, which env_view holds), with the windowed guard's running extrema of
// the current 61-bar block.
struct EnvState {
    float log_s, prev_c, entry, stop, target, risk0, equity, peak, dd;
    float run_low, run_high, box_low, box_high;
    float block_low, block_high;
    int side, cooldown_until, last_dir, trades, wins, losses, escal;
    int box_valid, regime, inside_cnt;
    int tap_ts[2 * TAP_SLOTS];          // [edge * 3 + k], newest first
    float tap_ratio[2 * TAP_SLOTS];
    int skips[N_SKIPS];
#ifdef ENGINE_HARVEST
    int pend_ml, pend_pol;              // the open trade's buckets, latched at entry
    float pend_x1, pend_x6;             // and its x1, x6
    float hv_sum[HV_SUMS];              // this path's Σx1, Σx6 [bucket * 2 + label]
    unsigned long long* hv_cnt;         // the CTA's tallies (shared memory)
#endif
};

__device__ __forceinline__ void env_set_bit(unsigned* word, int bit, bool on) {
    *word = on ? (*word | (1u << bit)) : (*word & ~(1u << bit));
}

// The windowed guard before bar t's work: at a block's first bar (t = 61k, k
// >= 1) the last block's 61 slots become their suffix minima and maxima, in
// place; then (lo, hi) = slot j + 1's suffix extrema, the bars t - 60 ..
// 61k - 1 (read early, used by env_guard_end).  Every lane of a warp is at
// the same bar.
__device__ __forceinline__ void env_guard_begin(const EnvView& ev, int t, float& lo,
                                                float& hi) {
    const int j = t % GUARD_WINDOW;
    float* const r = ev.ring;
    const int ws = ev.ws;
    if (j == 0 && t > 0) {
        float a = r[(GUARD_WINDOW - 1) * ws], b = r[(2 * GUARD_WINDOW - 1) * ws];
        for (int k = GUARD_WINDOW - 2; k >= 0; --k) {
            a = fminf(a, r[k * ws]);
            b = fmaxf(b, r[(GUARD_WINDOW + k) * ws]);
            r[k * ws] = a;
            r[(GUARD_WINDOW + k) * ws] = b;
        }
    }
    if (t >= GUARD_WINDOW && j + 1 < GUARD_WINDOW) {
        lo = r[(j + 1) * ws];
        hi = r[(GUARD_WINDOW + j + 1) * ws];
    }
}

// The windowed guard's box after bar t (low l, high h): the block's running
// extrema through t, the bar written to slot t mod 61, and the box their
// extrema with the last block's suffix from env_guard_begin (none in the
// first block or at a block's last bar, whose window is the block).
__device__ __forceinline__ void env_guard_end(EnvState& st, const EnvView& ev, int t, float l,
                                              float h, float lo, float hi) {
    const int j = t % GUARD_WINDOW;
    st.block_low = j == 0 ? l : fminf(st.block_low, l);
    st.block_high = j == 0 ? h : fmaxf(st.block_high, h);
    ev.ring[j * ev.ws] = l;
    ev.ring[(GUARD_WINDOW + j) * ev.ws] = h;
    const bool suffix = t >= GUARD_WINDOW && j + 1 < GUARD_WINDOW;
    st.run_low = suffix ? fminf(lo, st.block_low) : st.block_low;
    st.run_high = suffix ? fmaxf(hi, st.block_high) : st.block_high;
}

#undef LEVEL_SLOTS
#undef LV_PRICE
#undef LV_ROUND
#undef LV_VALID
#undef LV_KIND
#undef LATCH_BIT
#undef LATCH_SET
#undef TM_HAS_BIT
#undef TM_HAS_MARK
#undef TM_HAS_CLEAR
#undef C_COUNT
#undef TM_CNT
#undef TM_CNT_INC
#undef TM_TS
#undef TM_TS_SET
#undef TM_PX
#undef TM_ZERO
#undef RG_STRIDE
#undef GUARD_PUSH

// mc_engine_step.cuh on env_view's columns (``ev`` and ``lv`` in scope).  A
// (level, side)'s touch registers count only under its flag: a clear flag
// reads as the cleared state (count 0; the bar and price are read only under
// the flag), so a breakout clears the flag words alone.
#define LEVEL_SLOTS a.max_levels
#define LV_PRICE(i) lv[i].price
#define LV_ROUND(i) lv[i].round
#define LV_VALID(i) lv[i].valid
#define LV_KIND(i) lv[i].kind
#define LATCH_BIT(i) ((ev.latch[((i) >> 5) * ev.nt] >> ((i) & 31)) & 1u)
#define LATCH_SET(i, on) env_set_bit(ev.latch + ((i) >> 5) * ev.nt, (i) & 31, on)
#define TM_HAS_BIT(j) ((ev.tmh[((j) >> 5) * ev.nt] >> ((j) & 31)) & 1u)
#define TM_HAS_MARK(j) ev.tmh[((j) >> 5) * ev.nt] |= 1u << ((j) & 31)
#define TM_HAS_CLEAR \
    for (int w_ = 0; w_ < env_has_words(a.max_levels); ++w_) ev.tmh[w_ * ev.nt] = 0u
#define C_COUNT(i) ev.cc[(i) * ev.nt]
#define TM_CNT(j) (TM_HAS_BIT(j) ? (int)(ev.tmcb[(j) * ev.ws] & 0xffffu) : 0)
#define TM_CNT_INC(j) \
    ev.tmcb[(j) * ev.ws] = (ev.tmcb[(j) * ev.ws] & 0xffff0000u) + (unsigned)TM_CNT(j) + 1u
#define TM_TS(j) ((int)(ev.tmcb[(j) * ev.ws] >> 16) * 60000)
#define TM_TS_SET(j, ms) \
    ev.tmcb[(j) * ev.ws] = (ev.tmcb[(j) * ev.ws] & 0xffffu) | ((unsigned)((ms) / 60000) << 16)
#define TM_PX(j) ev.px[(j) * ev.ws]
#define TM_ZERO(j)
#define RG_STRIDE ev.nt
#define GUARD_PUSH                                                          \
    if constexpr (WIN) {                                                    \
        env_guard_end(st, ev, t, l, h, g_lo, g_hi);                         \
    } else {                                                                \
        st.run_low = fminf(st.run_low, l);                                  \
        st.run_high = fmaxf(st.run_high, h);                                \
    }

// The views a bar step reads its levels, rings and per-level state through,
// and the windowed guard's suffix extrema, read early.
#define ENV_VIEWS                                                           \
    const EnvView ev = env_view(a.max_levels, scratch);                     \
    const WideLevel* const lv = ev.lv;                                      \
    const EnvRings rg{ev.vol, ev.close, ev.nt};                             \
    float g_lo = 0.f, g_hi = 0.f;                                           \
    if constexpr (WIN) env_guard_begin(ev, t, g_lo, g_hi);

// A path's state at the start of its walk: the scalars, and this thread's
// rings, flag words and contact counts (the slots up to the row's count)
// cleared.  The scratch needs no clearing: a touch register is read only
// under its flag, a guard slot only after its bar wrote it.
__device__ __forceinline__ void env_init_state(const EngineArgs& a, EnvState& st) {
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
#ifdef ENGINE_HARVEST
    st.pend_ml = st.pend_pol = 0;
    st.pend_x1 = st.pend_x6 = 0.f;
#pragma unroll
    for (int j = 0; j < HV_SUMS; ++j) st.hv_sum[j] = 0.f;
#endif
    const EnvView ev = env_view(a.max_levels, nullptr);
    const int n = a.max_levels, nt = ev.nt;
    for (int i = 0; i < n; ++i) ev.cc[i * nt] = 0;
    for (int k = 0; k < env_latch_words(n); ++k) ev.latch[k * nt] = 0u;
    for (int k = 0; k < env_has_words(n); ++k) ev.tmh[k * nt] = 0u;
    for (int j = 0; j < VOL_RING; ++j) ev.vol[j * nt] = 0.f;
    for (int j = 0; j < CLOSE_RING; ++j) ev.close[j * nt] = 0.f;
}

// One GBM bar t of one path (wide_bar_step on env_view's state); ``scratch``
// is this thread's first scratch slot.  Not inlined (common.cuh).
template <bool WIN>
__device__ __noinline__ void env_bar_step(const EngineArgs& a, EnvState& st, Draws& dr,
                                          float* scratch, int t, float z, float zv, float u3,
                                          float u4, float tie, int noise_row) {
    ENV_VIEWS
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;
    ENGINE_BRIDGE(a.two_s2)
    ENGINE_VOLUME_MODEL
#include "mc_engine_step.cuh"
}

// One recorded bar t (wide_resample_bar_step on env_view's state).
template <bool WIN>
__device__ __noinline__ void env_resample_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                                   EnvState& st, Draws& dr, float* scratch,
                                                   int t, float x, float tie, int noise_row,
                                                   float& start) {
    ENV_VIEWS
    const float idx = resample_index(s, t, x, start);
    const float log_open = st.log_s;
    const float log_close = log_open + table_at(s, CH_LOGC, idx);
    const float c = expf(log_close);
    st.log_s = log_close;
    const float h = expf(log_open + table_at(s, CH_LOGH, idx));
    const float l = expf(log_open + table_at(s, CH_LOGL, idx));
    const float v = table_at(s, CH_VOL, idx);
#include "mc_engine_step.cuh"
}

// One Heston bar t (wide_heston_bar_step on env_view's state).
template <bool WIN>
__device__ __noinline__ void env_heston_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                                 EnvState& st, Draws& dr, float* scratch,
                                                 int t, float z, float zv, float zq, float u3,
                                                 float u4, float tie, int noise_row,
                                                 float& var) {
    ENV_VIEWS
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, var, v_pos);
    const float two_s2 = 2.0f * (v_pos * s.dt);
    const float log_open = st.log_s;
    const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
    const float c = expf(log_close);
    st.log_s = log_close;
    ENGINE_BRIDGE(two_s2)
    ENGINE_VOLUME_MODEL
#include "mc_engine_step.cuh"
}

#include "mc_engine_bars.cuh"        // ENV_GBM, EnvRows

// One path's walk under sampler KIND: the pairs of bars, as the parents
// walk them (mc_engine.cu, mc_engine_samplers.cu), then an odd W's half
// step: the cos branch of one more step of rows (gbm: the price and volume
// pairs at 0-3, the bridge at 4, 5, the tie at 6, antithetic as in the
// pairs, the noise from row 10; the bootstrap samplers' index at 0 and tie
// at 2, the noise from 4; Heston's price, volume and variance pairs at 0-5,
// the bridge at 6, 7, the tie at 8, the noise from 12).
template <bool WIN, int KIND>
__device__ __forceinline__ void env_walk(const EngineArgs& a, const SamplerArgs& s,
                                         EnvState& st, const float* ext, long long p,
                                         float* scratch) {
    const int row_len = ENGINE_SUB * a.lanes;
    const long long blk = p / row_len;
    const int col = (int)(p - blk * row_len);
    Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
             make_uint4(0u, 0u, 0u, 0u)};
    using R = EnvRows<KIND>;
    if constexpr (KIND == ENV_GBM) {
        const int half_lanes = a.lanes >> 1;
        // antithetic: right half-lanes take the left partner's normals negated
        const bool mirror = a.antithetic && (col % a.lanes) >= half_lanes;
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
            env_bar_step<WIN>(a, st, dr, scratch, 2 * t2, z0, vrad * vcs, u[4], u[5],
                              u[R::tie], base + R::noise);
            env_bar_step<WIN>(a, st, dr, scratch, 2 * t2 + 1, z1, vrad * vsn, u[7], u[8],
                              u[R::tie + R::tie_step], base + R::noise + 4);
        }
        if (a.num_bars & 1) {
            const int base = (a.num_bars >> 1) * a.stride;
            float u[7];
#pragma unroll
            for (int k = 0; k < 7; ++k) u[k] = dr.at(base + k);
            if (mirror) {
                const float2 m = dr.pair_of(col - half_lanes, base);
                u[0] = m.x; u[1] = m.y;
            }
            const float rad = sqrtf(-2.0f * logf(u[0]));
            float sn, cs;
            sincosf(two_pi() * u[1], &sn, &cs);
            float z0 = rad * cs;
            if (mirror) z0 = -z0;
            const float vrad = sqrtf(-2.0f * logf(u[2]));
            float vsn, vcs;
            sincosf(two_pi() * u[3], &vsn, &vcs);
            env_bar_step<WIN>(a, st, dr, scratch, a.num_bars - 1, z0, vrad * vcs, u[4], u[5],
                              u[R::tie], base + R::noise);
        }
    } else {
        float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
        for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
            const int r = t2 * a.stride;
            if constexpr (KIND == SAMPLER_RESAMPLE) {
                const float x0 = dr.at(r), x1 = dr.at(r + 1);
                const float tie0 = dr.at(r + R::tie), tie1 = dr.at(r + R::tie + R::tie_step);
                env_resample_bar_step<WIN>(a, s, st, dr, scratch, 2 * t2, x0, tie0, r + R::noise,
                                           carry);
                env_resample_bar_step<WIN>(a, s, st, dr, scratch, 2 * t2 + 1, x1, tie1,
                                           r + R::noise + 4, carry);
            } else {
                const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
                const float2 zv = normal_pair(dr.at(r + 2), dr.at(r + 3));
                const float2 q = normal_pair(dr.at(r + 4), dr.at(r + 5));
                const float u30 = dr.at(r + 6), u40 = dr.at(r + 7), tie0 = dr.at(r + R::tie);
                const float u31 = dr.at(r + 9), u41 = dr.at(r + 10);
                const float tie1 = dr.at(r + R::tie + R::tie_step);
                env_heston_bar_step<WIN>(a, s, st, dr, scratch, 2 * t2, z.x, zv.x, q.x, u30, u40,
                                         tie0, r + R::noise, carry);
                env_heston_bar_step<WIN>(a, s, st, dr, scratch, 2 * t2 + 1, z.y, zv.y, q.y, u31,
                                         u41, tie1, r + R::noise + 4, carry);
            }
        }
        if (a.num_bars & 1) {
            const int t = a.num_bars - 1;
            const int r = (a.num_bars >> 1) * a.stride;
            if constexpr (KIND == SAMPLER_RESAMPLE) {
                const float x = dr.at(r), tie = dr.at(r + R::tie);
                env_resample_bar_step<WIN>(a, s, st, dr, scratch, t, x, tie, r + R::noise, carry);
            } else {
                const float z = normal_pair(dr.at(r), dr.at(r + 1)).x;
                const float zv = normal_pair(dr.at(r + 2), dr.at(r + 3)).x;
                const float zq = normal_pair(dr.at(r + 4), dr.at(r + 5)).x;
                const float u3 = dr.at(r + 6), u4 = dr.at(r + 7), tie = dr.at(r + R::tie);
                env_heston_bar_step<WIN>(a, s, st, dr, scratch, t, z, zv, zq, u3, u4, tie,
                                         r + R::noise, carry);
            }
        }
    }
}

// A launch's pointers and shape (the kernels' one parameter).
struct EnvLaunch {
    const EngineArgs* args;       // [n_rows]
    const SamplerArgs* sargs;     // [n_rows], the samplers only
    const WideLevel* levels;      // [n_rows, max_levels]
    const float* ext;             // injected uniforms, or null (Philox)
    long long* part_counts;       // [n_rows, grid, ROW_COUNTS]
    float* part_floats;           // [n_rows, grid, ROW_FLOATS]
    float* per_path;              // [n_rows, num_paths, PATH_COLS], or null
    long long* hv_counts;         // [n_rows, grid, HV_COUNTS], the harvest builds only
    float* hv_sums;               // [n_rows, grid, HV_SUMS]
    float* scratch;               // [env_scratch_slots][gridDim.x * ENV_THREADS]
    int* next;                    // the next (row, CTA) cell, zeroed before the launch
    int grid, n_rows;             // the cells: grid CTAs a row
};

// book.cuh's cta_add_path_row for the envelope's CTAs: adds one path a
// thread (a chunk of the cell's paths) to the cell's partial row, the first
// chunk writing it, so the sampler kernels reduce their paths in the order
// their parents do.
__device__ __forceinline__ void env_add_path_row(const int (&cnt)[N_COUNTS + N_SKIPS],
                                                 bool entered, float eq, float dd,
                                                 long long* __restrict__ crow,
                                                 float* __restrict__ frow, bool first) {
    constexpr int NC = N_COUNTS + N_SKIPS;
    __shared__ unsigned s_cnt[NC];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[6][ENV_THREADS / 32];
    const int nt = ENV_THREADS;
    __syncthreads();                       // the previous chunk's readers are done
    for (int i = threadIdx.x; i < HIST_BINS; i += nt) s_hist[i] = 0u;
    if (threadIdx.x < NC) s_cnt[threadIdx.x] = 0u;
    __syncthreads();
    if (entered) atomicAdd(&s_hist[life_bin(eq)], 1u);
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const unsigned v = warp_count<unsigned>((unsigned)cnt[j]);
        if (wl == 0 && v) atomicAdd(&s_cnt[j], v);
    }
    const float sum_eq = warp_sum(0.f + eq), sum_eq2 = warp_sum(0.f + eq * eq);
    const float sum_dd = warp_sum(0.f + dd);
    const float min_eq = warp_min(entered ? fminf(BIG, eq) : BIG);
    const float max_eq = warp_max(entered ? fmaxf(-BIG, eq) : -BIG);
    const float max_dd = warp_max(fmaxf(0.f, dd));
    if (wl == 0) {
        s_red[0][warp] = sum_eq; s_red[1][warp] = sum_eq2; s_red[2][warp] = sum_dd;
        s_red[3][warp] = min_eq; s_red[4][warp] = max_eq; s_red[5][warp] = max_dd;
    }
    __syncthreads();
    if (threadIdx.x < NC)
        crow[threadIdx.x] = (first ? 0ll : crow[threadIdx.x]) + (long long)s_cnt[threadIdx.x];
    for (int i = threadIdx.x; i < HIST_BINS; i += nt)
        crow[NC + i] = (first ? 0ll : crow[NC + i]) + (long long)s_hist[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < (nt >> 5); ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
            md = fmaxf(md, s_red[5][w]);
        }
        if (first) {
            frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx; frow[5] = md;
        } else {
            frow[0] += s0; frow[1] += s1; frow[2] += s2;
            frow[3] = fminf(frow[3], mn); frow[4] = fmaxf(frow[4], mx);
            frow[5] = fmaxf(frow[5], md);
        }
    }
}

// One path's per-path row (mc_engine.cu's columns).
__device__ __forceinline__ void env_path_row(const EnvState& st, float* o) {
    o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
    o[3] = (float)st.losses; o[4] = st.side != 0 ? 1.f : 0.f; o[5] = st.dd;
    o[6] = (float)st.escal;
#pragma unroll
    for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
}

// The kernel body: this CTA takes (row, CTA) cells from p.next until none
// is left; a cell's paths (a thread a path: the cell's CTA index x the CTA's
// threads, a stride of grid x threads) walk the engine under sampler KIND
// and reduce into the cell's partial row as the parents reduce a CTA's: gbm
// a thread's paths in its registers, then the CTA once (mc_engine.cu); the
// samplers chunk by chunk (mc_engine_samplers.cu).  At a parent's shape a
// cell's partial row is the parent CTA's bit for bit.
template <bool WIN, int KIND>
__device__ __forceinline__ void env_rows(const EnvLaunch& p) {
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ unsigned long long s_counts[N_COUNTS + N_SKIPS];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[ROW_FLOATS][ENV_THREADS / 32];
    __shared__ int s_cell;
#ifdef ENGINE_HARVEST
    __shared__ unsigned long long s_hv[HV_COUNTS];
    __shared__ float s_hred[HV_SUMS][ENV_THREADS / 32];
#endif
    const int nt = ENV_THREADS, tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    float* const scratch = p.scratch + (long long)blockIdx.x * nt + tid;
    const EngineArgs& a = s_a;
    for (;;) {
        __syncthreads();                 // the last cell's readers are done
        if (tid == 0) s_cell = atomicAdd(p.next, 1);
        __syncthreads();
        const int cell = s_cell;
        if (cell >= p.grid * p.n_rows) break;
        const int row = cell / p.grid, bx = cell - row * p.grid;
        if (tid == 0) {
            s_a = p.args[row];
            if constexpr (KIND != ENV_GBM) s_s = p.sargs[row];
        }
        copy_levels((WideLevel*)env_smem, p.levels, row, p.args[row].max_levels);
        for (int i = tid; i < HIST_BINS; i += nt) s_hist[i] = 0u;
        if (tid < N_COUNTS + N_SKIPS) s_counts[tid] = 0ull;
#ifdef ENGINE_HARVEST
        for (int c = tid; c < HV_COUNTS; c += nt) s_hv[c] = 0ull;
        float hsum[HV_SUMS];
#pragma unroll
        for (int j = 0; j < HV_SUMS; ++j) hsum[j] = 0.f;
#endif
        __syncthreads();

        const long long seg = (long long)row * p.grid + bx;
        long long* const crow = p.part_counts + seg * ROW_COUNTS;
        float* const frow = p.part_floats + seg * ROW_FLOATS;
        const float* ext = p.ext ? p.ext + a.ext_offset : nullptr;
        float* const per_path = p.per_path
            ? p.per_path + (long long)row * a.num_paths * PATH_COLS : nullptr;
        const long long stride = (long long)p.grid * nt;
        if constexpr (KIND == ENV_GBM) {
            unsigned cnt[N_COUNTS + N_SKIPS];
#pragma unroll
            for (int j = 0; j < N_COUNTS + N_SKIPS; ++j) cnt[j] = 0u;
            float sum_eq = 0.f, sum_eq2 = 0.f, sum_dd = 0.f;
            float min_eq = BIG, max_eq = -BIG, max_dd = 0.f;
            for (long long q = (long long)bx * nt + tid; q < a.num_paths; q += stride) {
                EnvState st;
                env_init_state(a, st);
#ifdef ENGINE_HARVEST
                st.hv_cnt = s_hv;
#endif
                env_walk<WIN, KIND>(a, s_s, st, ext, q, scratch);
#ifdef ENGINE_HARVEST
#pragma unroll
                for (int j = 0; j < HV_SUMS; ++j) hsum[j] = hsum[j] + st.hv_sum[j];
#endif
                const bool entered = st.trades > 0;
                cnt[0] += 1u;
                cnt[1] += entered ? 1u : 0u;
                cnt[2] += (unsigned)st.wins;
                cnt[3] += (unsigned)st.losses;
                cnt[4] += st.side != 0 ? 1u : 0u;
                cnt[5] += (unsigned)st.trades;
                cnt[6] += (unsigned)st.escal;
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] += (unsigned)st.skips[j];
                sum_eq += st.equity;
                sum_eq2 += st.equity * st.equity;
                sum_dd += st.dd;
                max_dd = fmaxf(max_dd, st.dd);
                if (entered) {
                    min_eq = fminf(min_eq, st.equity);
                    max_eq = fmaxf(max_eq, st.equity);
                    const int bin = min(max((int)((st.equity - LIFE_HIST_LO) * LIFE_BIN_SCALE),
                                            0), HIST_BINS - 1);
                    atomicAdd(&s_hist[bin], 1u);
                }
                if (per_path) env_path_row(st, per_path + q * PATH_COLS);
            }
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
            if (tid < N_COUNTS + N_SKIPS) crow[tid] = (long long)s_counts[tid];
            for (int i = tid; i < HIST_BINS; i += nt)
                crow[N_COUNTS + N_SKIPS + i] = (long long)s_hist[i];
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
        } else {
            int chunk = 0;
            // every thread runs the cell's chunks, so env_add_path_row's barriers line up
            for (long long base = (long long)bx * nt; base < a.num_paths; base += stride, ++chunk) {
                const long long q = base + tid;
                const bool live = q < a.num_paths;
                EnvState st;
                env_init_state(a, st);
#ifdef ENGINE_HARVEST
                st.hv_cnt = s_hv;
#endif
                if (live) env_walk<WIN, KIND>(a, s_s, st, ext, q, scratch);
#ifdef ENGINE_HARVEST
#pragma unroll
                for (int j = 0; j < HV_SUMS; ++j) hsum[j] = hsum[j] + st.hv_sum[j];
#endif
                const bool entered = st.trades > 0;
                const int open = st.side != 0;
                int cnt[N_COUNTS + N_SKIPS] = {live ? 1 : 0, entered, st.wins, st.losses, open,
                                               st.trades, st.escal};
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
                env_add_path_row(cnt, entered, st.equity, st.dd, crow, frow, chunk == 0);
                if (per_path && live) env_path_row(st, per_path + q * PATH_COLS);
            }
        }
#ifdef ENGINE_HARVEST
#pragma unroll
        for (int j = 0; j < HV_SUMS; ++j) {
            const float v = warp_sum(hsum[j]);
            if (wl == 0) s_hred[j][warp] = v;
        }
        __syncthreads();
        for (int c = tid; c < HV_COUNTS; c += nt)
            p.hv_counts[seg * HV_COUNTS + c] = (long long)s_hv[c];
        if (tid < HV_SUMS) {
            float v = 0.f;
            for (int w = 0; w < (nt >> 5); ++w) v += s_hred[tid][w];
            p.hv_sums[seg * HV_SUMS + tid] = v;
        }
#endif
    }
}

// Launch ``kernel`` (an env kernel taking p) over ``cells`` cells: CTAs of
// ENV_THREADS with the level count's dynamic shared memory, as many as the
// card holds at once (and no more than the cells, or the ``scratch_ctas``
// the scratch holds).  Returns the first CUDA error.
template <class K, class P>
__host__ int env_launch_cells(K kernel, const P& p, long long cells, int max_levels,
                              int scratch_ctas, cudaStream_t stream) {
    const int threads = ENV_THREADS, smem = env_smem_bytes(max_levels, threads);
    if (!p.next || !p.scratch || scratch_ctas < 1) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    if (fa.sharedSizeBytes > ENV_STATIC_MAX) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long ctas = (long long)sms * per_sm;
    if (cells < ctas) ctas = cells;
    if (scratch_ctas < ctas) ctas = scratch_ctas;
    e = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)ctas, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// env_launch_cells over an env_rows kernel's (row, CTA) cells.
template <class K>
__host__ int env_launch(K kernel, const EnvLaunch& p, int max_levels, int scratch_ctas,
                        cudaStream_t stream) {
    return env_launch_cells(kernel, p, (long long)p.grid * p.n_rows, max_levels, scratch_ctas,
                            stream);
}

// The checks every env entry makes of its shape.
__host__ __forceinline__ bool env_shape_ok(int n_rows, int max_levels, int num_bars, int grid) {
    return max_levels >= 1 && max_levels <= WIDE_LEVELS && num_bars >= 2 && n_rows >= 1
           && n_rows <= 65535 && grid >= 1 && (long long)grid * n_rows < (1ll << 31);
}
