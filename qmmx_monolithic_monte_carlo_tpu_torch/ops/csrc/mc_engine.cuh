// The full engine's device code -- its constants, the argument struct
// (mirrored by ops/cuda_engine.py:_EngineArgs), the uniform layout, the
// rings, the path state, the gates and the GBM bar step -- shared by
// mc_engine.cu (the single, sweep and universe kernels), mc_engine_corr.cu
// (the correlated book) and mc_engine_samplers.cu (the bootstrap,
// block-bootstrap and Heston kernels).  Each source is its own library, so
// the book's and the samplers' kernels do not change how the others compile
// (the non-inlined bar step is register-allocated per library).  A bar's
// engine is mc_engine_step.cuh, included in the body of every bar step.
#pragma once

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 7            // n, entered, wins, losses, open, trades, escalations
#define N_SKIPS 16
#define ROW_COUNTS (N_COUNTS + N_SKIPS + HIST_BINS)
#define ROW_FLOATS 6          // sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
#define PATH_COLS (7 + N_SKIPS)  // equity, trades, wins, losses, open, dd, escalations, skips
#define BLOCK 256
#define MAX_LEVELS 8
#define ENGINE_SUB 8          // rows of paths in one block
#define VOL_RING 20
#define CLOSE_RING 5
#define TAP_SLOTS 3           // == fatigue_hits
#define LOOKBACK 5            // the escalation walk's window (VOL_LOOKBACK)
#define KIND_SOLID 1
#define BIG 3.4e38f
#define TAP_NEVER (-(1 << 30))
#define LIFE_HIST_LO (-6.0f)
#define LIFE_BIN_SCALE 9.142857142857142f  // HIST_BINS / (8 - (-6)), float32
#define PROX_WINDOW 0.35f     // ExitStrategy's proximity window
#define INF_F __int_as_float(0x7f800000)

// skip-table columns (sim/enginepath.SKIP_REASONS order)
enum { SK_IN_POSITION, SK_COOLDOWN, SK_NOLEVELS, SK_DIR_UNKNOWN, SK_TOO_FAR,
       SK_OVERTOUCHED, SK_EDGE_FATIGUE, SK_TOUCH_BUDGET, SK_TOUCH_COOLDOWN,
       SK_CONF_LOW, SK_ACC_BREAKOUT, SK_CONTRA_LONG, SK_CONTRA_SHORT,
       SK_COMBINED_LOW, SK_ML_CONF_LOW, SK_ONLINE_POLICY };

// The host mirror of this struct is ops/cuda_engine.py:_EngineArgs.
struct EngineArgs {
    long long num_paths;
    long long ext_offset;               // a universe row's injected uniforms
    float level_price[MAX_LEVELS];      // invalid slots zeroed
    float level_round[MAX_LEVELS];      // rounded to cents (touch memory)
    int level_valid[MAX_LEVELS];
    int level_kind[MAX_LEVELS];         // KIND_SOLID / KIND_DASHED
    float prox, prox_conf, stop_pad, tp_pad, qmin;
    float veto_strong, veto_near, confl_within, w_rules, w_ml;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float ml_coef[4], ml_intercept;
    float pol_w[3][7];
    float tm_tol_bps, tm_min_px_bps, tm_decay, tm_fat_vol_k;
    float g_comp, g_vol_k;
    float drift, sig_dt, two_s2, log_s0;
    float vm_base, vm_uamp, vm_sigma, vm_rc, vm_day, vm_open, vm_den, vm_third;
    float vm_half_s2, vm_mean_abs, vm_sd_abs, vm_floor;
    uint32_t seed, stream;              // Philox key
    int cooldown_ms, overtouch_limit, enable_veto, use_blend, ml_usable, ml_ran;
    int policy_on, bar0_minute, has_levels;
    int tm_min_gap_ms, tm_max_bounces, tm_fat_win_ms;
    int g_min_bars, g_clear_bars;
    int max_levels, num_bars, lanes, u_rows, stride;
    int use_noise, antithetic, escalation;
};

// Uniforms of one path in the layout of ops/draws.EngineLayout: row r of
// column col (= sublane * lanes + lane) is injected, or word r % 4 of Philox
// with counter (col, r / 4, block lo, block hi).  The last call's words are
// kept, so rows drawn in increasing order cost one call per four rows.
struct Draws {
    const float* ext;
    long long blk;
    int col, row_len, u_rows;
    uint32_t seed, stream;
    int group;
    uint4 words;

    __device__ float at(int row) {
        if (ext) return ext[(blk * u_rows + row) * (long long)row_len + col];
        if ((row >> 2) != group) {
            group = row >> 2;
            words = philox4((uint32_t)col, (uint32_t)group, (uint32_t)blk,
                            (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        }
        return to_uniform(word_of(words, row & 3));
    }

    // rows (row, row + 1) of another column: the antithetic partner's pair
    __device__ float2 pair_of(int other_col, int row) const {
        if (ext) {
            const float* q = ext + (blk * u_rows + row) * (long long)row_len + other_col;
            return make_float2(q[0], q[row_len]);
        }
        const uint4 w = philox4((uint32_t)other_col, (uint32_t)(row >> 2), (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        return make_float2(to_uniform(word_of(w, row & 3)),
                           to_uniform(word_of(w, (row + 1) & 3)));
    }
};

template <int MAXL>
struct EngineState {
    float log_s, prev_c, entry, stop, target, risk0, equity, peak, dd;
    float run_low, run_high, box_low, box_high;
    int side, cooldown_until, last_dir, trades, wins, losses, escal;
    int box_valid, regime, inside_cnt;
    int c_counts[MAXL];
    unsigned c_latch;                   // bit i: level i latched
    int tm_cnt[2 * MAXL], tm_ts[2 * MAXL];
    float tm_px[2 * MAXL];
    unsigned tm_has;                    // bit 2i + side: has a last touch
    int tap_ts[2 * TAP_SLOTS];          // [edge * 3 + k], newest first
    float tap_ratio[2 * TAP_SLOTS];
    int skips[N_SKIPS];
};

// The shared-memory rings of this thread: slot s of ring R at base[s * BLOCK].
struct Rings {
    float* vol;    // VOL_RING slots
    float* close;  // CLOSE_RING slots
    __device__ float v(int bar) const { return vol[(bar % VOL_RING) * BLOCK]; }
    __device__ float c(int bar) const { return close[(bar % CLOSE_RING) * BLOCK]; }
};

#define FIRST_FAIL(cond, col) \
    if (ok && (cond)) { ok = false; ++st.skips[col]; }

// The bridge high h and low l of a bar from log_open to log_close, TWO_S2 =
// 2 x its variance, from its uniforms u3 and u4.
#define ENGINE_BRIDGE(TWO_S2)                                                           \
    const float diff = log_close - log_open;                                            \
    const float d2 = diff * diff;                                                       \
    const float mid = log_open + log_close;                                             \
    const float h = expf(0.5f * (mid + sqrtf(d2 - TWO_S2 * logf(u3))));                \
    const float l = expf(0.5f * (mid - sqrtf(d2 - TWO_S2 * logf(u4))));

// The volume v of bar t under the volume model (ops/pathgen.VolumeModel), from
// its price normal z and volume normal zv.
#define ENGINE_VOLUME_MODEL                                                             \
    const float m_min = fmodf(a.vm_open + (float)t, a.vm_day);                          \
    const float xu = 2.0f * m_min / a.vm_den - 1.0f;                                    \
    const float ushape = 1.0f + a.vm_uamp * (xu * xu - a.vm_third);                     \
    float v = a.vm_base * ushape * expf(a.vm_sigma * zv - a.vm_half_s2);                \
    if (a.vm_rc != 0.0f)                                                                \
        v = v * (1.0f + a.vm_rc * ((fabsf(z) - a.vm_mean_abs) / a.vm_sd_abs));          \
    v = fmaxf(v, a.vm_floor);

// How the parent kernels' bar steps (this header's and
// mc_engine_sampler_step.cuh's) read the level slots of EngineArgs, the
// arrays and bit masks of EngineState, the rings and the running guard box
// (mc_engine_step.cuh); each
// expands to the statement the step had before the envelope kernels came
// (mc_engine_env.cuh defines the envelope's), so the parents compile as before.
#define LEVEL_SLOTS MAXL
#define LV_PRICE(i) a.level_price[i]
#define LV_ROUND(i) a.level_round[i]
#define LV_VALID(i) a.level_valid[i]
#define LV_KIND(i) a.level_kind[i]
#define LATCH_BIT(i) (st.c_latch >> i) & 1u
#define LATCH_SET(i, on) st.c_latch = on ? (st.c_latch | (1u << i)) : (st.c_latch & ~(1u << i))
#define TM_HAS_BIT(j) (st.tm_has >> j) & 1u
#define TM_HAS_MARK(j) st.tm_has |= 1u << j
#define TM_HAS_CLEAR st.tm_has = 0u
#define C_COUNT(i) st.c_counts[i]
#define TM_CNT(j) st.tm_cnt[j]
#define TM_CNT_INC(j) ++st.tm_cnt[j]
#define TM_ZERO(j) st.tm_cnt[j] = 0; st.tm_ts[j] = 0; st.tm_px[j] = 0.f
#define TM_TS(j) st.tm_ts[j]
#define TM_TS_SET(j, ms) st.tm_ts[j] = ms
#define TM_PX(j) st.tm_px[j]
#define RG_STRIDE BLOCK
#define GUARD_PUSH                        \
    st.run_low = fminf(st.run_low, l);    \
    st.run_high = fmaxf(st.run_high, h);
// The bar's tie coin where it hits both stop and target: the bar step's
// argument in every family but the engine sweep's (mc_engine_bar_sweep.cu).
#define ENGINE_TIE tie

// How the book walks shared with the envelope's books
// (mc_engine_book_walk.cuh and mc_engine_book_sampler_walk.cuh) name a
// device function f of the family (a bar step), the level table a bar step
// takes (the parents' is in EngineArgs: none) and its rings (the parents'
// Rings rg); mc_engine_wide_corr.cuh defines the envelope's.
#define ENGINE_FN(f) f<MAXL>
#define ENGINE_LV
#define ENGINE_RG rg

// The closed-trade harvest's hooks in the bar's engine (mc_engine_step.cuh):
// at a close (pnl in scope) and at an entry.  Empty for every kernel but the
// envelope's harvest builds (mc_engine_wide.cuh under ENGINE_HARVEST).
#define HARVEST_CLOSE
#define HARVEST_ENTRY

// One bar of one path (sim/enginepath.EngineLifecycle.step on the bar
// generated as pallas_engine.py _one_bar generates it).  z / zv are the
// bar's price and volume normals; u3, u4 the bridge uniforms; noise_row the
// first of its four noise rows, drawn only if it enters.
template <int MAXL>
__device__ __noinline__ void bar_step(const EngineArgs& a, EngineState<MAXL>& st,
                                      Draws& dr, const Rings& rg, int t, float z,
                                      float zv, float u3, float u4, float tie,
                                      int noise_row) {
    // ---- the bar: GBM close, bridge extremes, the volume model
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;
    ENGINE_BRIDGE(a.two_s2)
    ENGINE_VOLUME_MODEL
#include "mc_engine_step.cuh"
}
