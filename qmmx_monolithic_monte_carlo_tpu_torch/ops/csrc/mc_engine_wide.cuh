// The full engine's envelope: its device code for 1-64 level slots, any
// horizon W >= 2 (an odd one ends with a half step) and horizons past the
// guard's 61-bar window.  The correlated books' envelope kernels
// (mc_engine_wide_corr.cu, mc_engine_wide_corr_samplers.cu and their harvest
// builds, even W) are built on this header's state and bar steps; the other
// envelope kernels (mc_engine_wide{,_samplers}{,_harvest}.cu) on
// mc_engine_env.cuh, which takes this header's level table, harvest hooks and
// helpers and keeps the per-level state in shared memory instead.  Each
// source is a library of its own, so the parent kernels (mc_engine.cu and its
// three neighbours, <= 8 levels and an even W <= 61) keep their code.
//
// What differs from the parents (mc_engine.cuh), and why:
//
// * Levels.  EngineArgs holds 8 level slots; widening it would change every
//   parent kernel.  The envelope kernels take a [rows, max_levels] table of
//   WideLevel (ops/cuda_engine.py packs it), and each CTA copies its row into
//   shared memory (1 KB at 64 levels) next to its EngineArgs.
// * Per-level state.  The contact counts and latch and the per-(level, side)
//   touch count / last time / last price / flag are arrays of WIDE_LEVELS
//   (64) slots, ~2 KB a thread in local memory.  The parents' latch and
//   touch flags are bits of one unsigned, which a shift by 32 or more (past
//   32 levels, past 16 for the touch flags) leaves undefined; here they are
//   bool arrays.  Every level loop runs to the row's slot count (LEVEL_SLOTS)
//   and is not unrolled, so a bar costs what its levels cost and the code
//   stays one loop body a loop; the arrays' size then costs nothing (at 30
//   levels, widths 32 and 64 ran alike on the H100, PERF.md).
// * The windowed guard (template flag WIN, for W > 61,
//   pallas_engine.py:203).  Each thread keeps 61-slot rings of the bars' lows
//   and highs in local memory (488 bytes), filled with +-inf; bar t writes
//   slot t mod 61 and the box is the min/max over every slot, taken each bar.
//   Min and max are exact in any order and the prices hold no NaN, so this
//   equals the JAX kernel's balanced fold (_ring_fold, :1132-1140); the
//   guard's 5/20-bar MAs read n_after as before.  Without WIN the box is the
//   running min/max, as in the parents.
//
// * The closed-trade harvest (ENGINE_HARVEST, defined by the harvest builds
//   before they include this header: mc_engine_wide*_harvest.cu).  A path's
//   state also latches its open trade's ML bucket, policy bucket, x1 =
//   min(1, distance) and x6 = min(1, (bar0 minute + t) / 390) at entry
//   (HARVEST_ENTRY, pallas_engine.py:910-917) and sums the closes' x1 and x6
//   per (policy bucket, label) in 16 floats; each close adds one to its two
//   (bucket, label) counts in the CTA's shared 64-bit tallies (HARVEST_CLOSE,
//   :629-648), exact in any order.  The float sums go path -> thread (in path
//   order) -> warp shuffle tree -> the fixed per-warp loop (hv_cta_row), as
//   the lifecycle sums do, so a row equals its one-row launch bit for bit.
//   The other builds compile none of it.
//
// mc_engine_step.cuh is the bar's engine, as in the parents; this header
// defines the macros it reads the levels, flags and guard through, and those
// through which the book walks shared with the parents
// (mc_engine_book_walk.cuh, mc_engine_book_sampler_walk.cuh) name the
// envelope's state, bar steps and level table.

#pragma once

#include <type_traits>

#include "mc_engine.cuh"
#include "book.cuh"
#include "sampler.cuh"

#define GUARD_WINDOW 61       // GUARD_WINDOW_BARS: the 60-minute box of the guard
#define WIDE_LEVELS 64        // MAX_KERNEL_LEVELS: the level slots a row may have

#ifdef ENGINE_HARVEST
#define HV_TC_CAP 8           // models/harvest.TC_CAP
#define HV_ML_COLS 64         // ml_counts[bucket][label]: (tc, kind, glf) x 2
#define HV_POL_COLS 8         // pol_counts[bucket][label]: (glf, confl) x 2
#define HV_COUNTS (HV_ML_COLS + HV_POL_COLS)
#define HV_SUMS (2 * HV_POL_COLS)  // Σx1[bucket][label], then Σx6
#endif

// One level slot (host mirror: ops/cuda_engine.py _WIDE_LEVEL); an invalid
// slot is all zeros.
struct WideLevel {
    float price;    // the level's price
    float round;    // rounded to cents (touch memory)
    int valid;
    int kind;       // KIND_SOLID / KIND_DASHED
};

template <bool WIN>
struct WideState {
    float log_s, prev_c, entry, stop, target, risk0, equity, peak, dd;
    float run_low, run_high, box_low, box_high;
    int side, cooldown_until, last_dir, trades, wins, losses, escal;
    int box_valid, regime, inside_cnt;
    int c_counts[WIDE_LEVELS];
    bool c_latch[WIDE_LEVELS];
    int tm_cnt[2 * WIDE_LEVELS], tm_ts[2 * WIDE_LEVELS];
    float tm_px[2 * WIDE_LEVELS];
    bool tm_has[2 * WIDE_LEVELS];       // [2i + side]: has a last touch
    int tap_ts[2 * TAP_SLOTS];          // [edge * 3 + k], newest first
    float tap_ratio[2 * TAP_SLOTS];
    int skips[N_SKIPS];
    float win_low[WIN ? GUARD_WINDOW : 1], win_high[WIN ? GUARD_WINDOW : 1];
#ifdef ENGINE_HARVEST
    int pend_ml, pend_pol;              // the open trade's buckets, latched at entry
    float pend_x1, pend_x6;             // and its x1, x6
    float hv_sum[HV_SUMS];              // this path's Σx1, Σx6 [bucket * 2 + label]
    unsigned long long* hv_cnt;         // the CTA's tallies (shared memory)
#endif
};

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
#undef GUARD_PUSH
#undef ENGINE_STATE
#undef ENGINE_FN
#undef ENGINE_LV

#define LEVEL_SLOTS a.max_levels
#define LV_PRICE(i) lv[i].price
#define LV_ROUND(i) lv[i].round
#define LV_VALID(i) lv[i].valid
#define LV_KIND(i) lv[i].kind
#define LATCH_BIT(i) st.c_latch[i]
#define LATCH_SET(i, on) st.c_latch[i] = on
#define TM_HAS_BIT(j) st.tm_has[j]
#define TM_HAS_MARK(j) st.tm_has[j] = true
#define TM_HAS_CLEAR \
    for (int j = 0; j < 2 * a.max_levels; ++j) st.tm_has[j] = false
#define GUARD_PUSH                                                          \
    if constexpr (WIN) {                                                    \
        st.win_low[t % GUARD_WINDOW] = l;                                   \
        st.win_high[t % GUARD_WINDOW] = h;                                  \
        float lo = st.win_low[0], hi = st.win_high[0];                      \
        for (int k = 1; k < GUARD_WINDOW; ++k) {                            \
            lo = fminf(lo, st.win_low[k]);                                  \
            hi = fmaxf(hi, st.win_high[k]);                                 \
        }                                                                   \
        st.run_low = lo;                                                    \
        st.run_high = hi;                                                   \
    } else {                                                                \
        st.run_low = fminf(st.run_low, l);                                  \
        st.run_high = fmaxf(st.run_high, h);                                \
    }
// the book walks shared with the parents take the envelope's state and steps
#define ENGINE_STATE WideState<WIN>
#define ENGINE_FN(f) wide_##f<WIN>
#define ENGINE_LV lv,

#ifdef ENGINE_HARVEST
#undef HARVEST_CLOSE
#undef HARVEST_ENTRY
#define HARVEST_CLOSE                                                       \
    {                                                                       \
        const int lab = pnl > 0.f ? 1 : 0;                                  \
        const int pj = st.pend_pol * 2 + lab;                               \
        atomicAdd(&st.hv_cnt[st.pend_ml * 2 + lab], 1ull);                  \
        atomicAdd(&st.hv_cnt[HV_ML_COLS + pj], 1ull);                       \
        st.hv_sum[pj] = st.hv_sum[pj] + st.pend_x1;                         \
        st.hv_sum[HV_POL_COLS + pj] = st.hv_sum[HV_POL_COLS + pj] + st.pend_x6; \
    }
#define HARVEST_ENTRY                                                       \
    st.pend_ml = min(tc, HV_TC_CAP - 1) * 4 + (best_k == KIND_SOLID ? 2 : 0) \
                 + (go_long ? 1 : 0);                                       \
    st.pend_pol = (go_long ? 2 : 0) + (confl_pol > 1 ? 1 : 0);              \
    st.pend_x1 = fminf(best_d, 1.0f);                                       \
    st.pend_x6 = fminf((float)(a.bar0_minute + t) / 390.0f, 1.0f);
#endif

// A path's state at the start of its walk (the slots up to the row's count),
// its rings cleared.
template <bool WIN>
__device__ __forceinline__ void wide_init_state(const EngineArgs& a, WideState<WIN>& st,
                                                const Rings& rg) {
    st.log_s = a.log_s0;
    st.prev_c = expf(a.log_s0);
    st.entry = st.stop = st.target = st.risk0 = 0.f;
    st.equity = st.peak = st.dd = 0.f;
    st.run_low = INF_F; st.run_high = -INF_F;
    st.box_low = st.box_high = 0.f;
    st.side = st.last_dir = st.trades = st.wins = st.losses = st.escal = 0;
    st.cooldown_until = -(1 << 30);
    st.box_valid = st.regime = st.inside_cnt = 0;
    for (int i = 0; i < a.max_levels; ++i) { st.c_counts[i] = 0; st.c_latch[i] = false; }
    for (int j = 0; j < 2 * a.max_levels; ++j) {
        st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f; st.tm_has[j] = false;
    }
#pragma unroll
    for (int j = 0; j < 2 * TAP_SLOTS; ++j) { st.tap_ts[j] = TAP_NEVER; st.tap_ratio[j] = 0.f; }
#pragma unroll
    for (int j = 0; j < N_SKIPS; ++j) st.skips[j] = 0;
    if constexpr (WIN) {
        for (int k = 0; k < GUARD_WINDOW; ++k) { st.win_low[k] = INF_F; st.win_high[k] = -INF_F; }
    }
#ifdef ENGINE_HARVEST
    st.pend_ml = st.pend_pol = 0;
    st.pend_x1 = st.pend_x6 = 0.f;
#pragma unroll
    for (int j = 0; j < HV_SUMS; ++j) st.hv_sum[j] = 0.f;
#endif
    for (int j = 0; j < VOL_RING; ++j) rg.vol[j * BLOCK] = 0.f;
    for (int j = 0; j < CLOSE_RING; ++j) rg.close[j * BLOCK] = 0.f;
}

// Row ``row`` of the [rows, max_levels] level table into the CTA's shared
// copy (every thread of the CTA calls it; a barrier follows).
__device__ __forceinline__ void copy_levels(WideLevel* s_lv, const WideLevel* __restrict__ levels,
                                            long long row, int max_levels) {
    for (int i = threadIdx.x; i < max_levels; i += blockDim.x)
        s_lv[i] = levels[row * max_levels + i];
}

// One GBM bar t of one path (mc_engine.cuh's bar_step on the envelope's
// levels and state).  Not inlined (common.cuh).
template <bool WIN>
__device__ __noinline__ void wide_bar_step(const EngineArgs& a, const WideLevel* lv,
                                           WideState<WIN>& st, Draws& dr,
                                           const Rings& rg, int t, float z, float zv, float u3,
                                           float u4, float tie, int noise_row) {
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;
    ENGINE_BRIDGE(a.two_s2)
    ENGINE_VOLUME_MODEL
#include "mc_engine_step.cuh"
}

// One recorded bar t (mc_engine_sampler_step.cuh's resample_bar_step on the
// envelope's levels and state).  Not inlined.
template <bool WIN>
__device__ __noinline__ void wide_resample_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                                    const WideLevel* lv,
                                                    WideState<WIN>& st, Draws& dr,
                                                    const Rings& rg, int t, float x, float tie,
                                                    int noise_row, float& start) {
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

// One Heston bar t (mc_engine_sampler_step.cuh's heston_bar_step on the
// envelope's levels and state).  Not inlined.
template <bool WIN>
__device__ __noinline__ void wide_heston_bar_step(const EngineArgs& a, const SamplerArgs& s,
                                                  const WideLevel* lv,
                                                  WideState<WIN>& st, Draws& dr,
                                                  const Rings& rg, int t, float z, float zv,
                                                  float zq, float u3, float u4, float tie,
                                                  int noise_row, float& var) {
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

// A row's per-path outputs: its partial-row counts and, when asked, its
// per-path row (mc_engine.cu's columns).
template <bool WIN>
__device__ __forceinline__ void wide_path_row(const WideState<WIN>& st, bool live,
                                              int (&cnt)[N_COUNTS + N_SKIPS], float* o) {
    const bool entered = st.trades > 0;
    const int open = st.side != 0;
    cnt[0] = live ? 1 : 0; cnt[1] = entered; cnt[2] = st.wins; cnt[3] = st.losses;
    cnt[4] = open; cnt[5] = st.trades; cnt[6] = st.escal;
#pragma unroll
    for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
    if (o) {
        o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
        o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
        o[6] = (float)st.escal;
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
    }
}

#ifdef ENGINE_HARVEST
// The CTA's tallies zeroed (every thread calls it; a barrier follows before
// the first close).
__device__ __forceinline__ void hv_clear(unsigned long long* s_hv) {
    for (int c = threadIdx.x; c < HV_COUNTS; c += BLOCK) s_hv[c] = 0ull;
}

// Adds the CTA's harvest to its partial row (every thread calls it): the
// shared tallies s_hv to the int64 counts crow, each thread's sums hsum to
// the floats frow, reduced as the lifecycle sums are (a warp shuffle tree,
// then the warps in order from 0).  ``first`` writes the row; later calls
// (a book's chunks) add to it, in call order.
__device__ __forceinline__ void hv_cta_row(const unsigned long long* s_hv,
                                           const float (&hsum)[HV_SUMS],
                                           long long* __restrict__ crow,
                                           float* __restrict__ frow, bool first) {
    __shared__ float s_hred[HV_SUMS][BLOCK / 32];
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < HV_SUMS; ++j) {
        const float v = warp_sum(hsum[j]);
        if (wl == 0) s_hred[j][warp] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HV_COUNTS; c += BLOCK)
        crow[c] = (first ? 0ll : crow[c]) + (long long)s_hv[c];
    if (threadIdx.x < HV_SUMS) {
        float s = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) s += s_hred[threadIdx.x][w];
        frow[threadIdx.x] = first ? s : frow[threadIdx.x] + s;
    }
}
#endif

// Call f(windowed) with ``windowed`` a compile-time constant
// (std::true_type / std::false_type); returns f's value.
template <class F>
__host__ int wide_dispatch(bool windowed, F&& f) {
    return windowed ? f(std::true_type{}) : f(std::false_type{});
}
