// The full engine's envelope: what its kernels share at 1-64 level slots,
// any horizon W >= 2 (an odd one ends with a half step) and horizons past the
// guard's 61-bar window -- the level table, the windowed guard's window, the
// closed-trade harvest's hooks and CTA rows, and the host's dispatch on the
// guard.  The envelope kernels (mc_engine_wide{,_samplers,_corr,
// _corr_samplers}{,_harvest}.cu) keep their per-level state as
// mc_engine_env.cuh lays it out.  Each source is a library of its own, so
// the parent kernels (mc_engine.cu and its three neighbours, <= 8 levels and
// an even W <= 61) keep their code.
//
// What differs from the parents (mc_engine.cuh), and why:
//
// * Levels.  EngineArgs holds 8 level slots; widening it would change every
//   parent kernel.  The envelope kernels take a [rows, max_levels] table of
//   WideLevel (ops/cuda_engine.py packs it), and each CTA copies its row into
//   shared memory (1 KB at 64 levels).  Every level loop runs to the row's
//   slot count (LEVEL_SLOTS) and is not unrolled, so a bar costs what its
//   levels cost.
// * The windowed guard (W > 61, pallas_engine.py:203): the box over the last
//   61 bars (mc_engine_env.cuh takes it a 61-bar block at a time); without
//   it the box is the running min/max, as in the parents.
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
// mc_engine_step.cuh is the bar's engine, as in the parents;
// mc_engine_env.cuh defines the macros it reads the levels, flags and guard
// through.

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

// Row ``row`` of the [rows, max_levels] level table into the CTA's shared
// copy (every thread of the CTA calls it; a barrier follows).
__device__ __forceinline__ void copy_levels(WideLevel* s_lv, const WideLevel* __restrict__ levels,
                                            long long row, int max_levels) {
    for (int i = threadIdx.x; i < max_levels; i += blockDim.x)
        s_lv[i] = levels[row * max_levels + i];
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
