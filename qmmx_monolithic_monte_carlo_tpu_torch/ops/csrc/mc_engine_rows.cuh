// The pieces of the warp-specialised engine kernels shared by the rows kernel
// (mc_engine_rows.cu: the single run, the universes) and the book's
// (mc_engine_book_rows.cu): the stage ring's constants and the flags plane,
// the mbarriers and the consumers' named barrier, the producers' bar-only
// gates (tile_gates), the consumers' path state (RowsState, RowsLevels) and
// draws (RowDraw), how mc_engine_step.cuh reads them, and the parents'
// sampler reduction of a chunk on the consumers' barrier.  Each source is a
// library of its own.  Included after mc_engine.cuh, book.cuh, sampler.cuh
// and mc_engine_bars.cuh.  Design notes: mc_engine_rows.cu.
#pragma once

#define ROWS_THREADS (2 * BLOCK)  // producers, then consumers: a path a thread on each side
#define ROWS_TILE 14              // bars a stage (even)
#define ROWS_STAGES 2
#define ROWS_MIN_BLOCKS 1         // CTAs an SM (__launch_bounds__)
// the registers of a producer and of a consumer thread (setmaxnreg): their
// sum over the CTA within what the launch holds, ROWS_THREADS x 65536 /
// (ROWS_THREADS x ROWS_MIN_BLOCKS) in steps of 8
#define ROWS_PRODUCER_REGS 56
#define ROWS_CONSUMER_REGS 200
#define ROWS_PLANES 5             // close, high, low, volume, the bar-only gates' flags
#define GATE_RING 8               // the producers' last volumes a path (the veto reads 6)
// the flags plane (a word a path-bar): the nearest valid level's slot in bits
// 0-2, whether there is one, the direction + 1 in bits 4-5, whether the
// volume veto fires (its switch aside) and on a long, whether the policy
// gate fails
#define ROWS_F_NEAREST 8
#define ROWS_F_DIR_SHIFT 4
#define ROWS_F_VETO 64
#define ROWS_F_VETO_LONG 128
#define ROWS_F_POLICY 256
#define BAR_CONSUMERS 1           // the consumers' named barrier (0 is __syncthreads)

static_assert(ROWS_TILE % 2 == 0, "a tile holds whole double bars");
static_assert(BLOCK % 128 == 0, "whole warpgroups on each side");

// The level loops run over the 8 slots of EngineArgs (the parents' MAXL).
#undef LEVEL_SLOTS
#define LEVEL_SLOTS MAX_LEVELS

// A stage's full and empty mbarriers: every producer thread arrives at full
// when its bars are in, every consumer thread at empty when it has read them
// (arrive releases, the wait acquires: the stage's shared memory is ordered);
// a thread waits for the phase of the stage's k-th use (parity k & 1).
struct RowsBarriers {
    unsigned long long full[ROWS_STAGES], empty[ROWS_STAGES];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar))
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile("{\n"
                 "  .reg .pred done;\n"
                 "WAIT_%=:\n"
                 "  mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "  @!done bra WAIT_%=;\n"
                 "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync %0, %1;\n" :: "n"(BAR_CONSUMERS), "n"(BLOCK) : "memory");
}

// ---- the producer

// A path's state for its bar-only gates: the step's st.prev_c and
// st.last_dir (the direction's), and its last GATE_RING volumes (``rg.v``,
// as the step reads its ring).
struct GateState {
    float prev_c;
    int last_dir;
};

struct GateVols {
    float* vol;
    __device__ float v(int bar) const { return vol[(bar & (GATE_RING - 1)) * BLOCK]; }
};

// The bar-only gates of bars t0 .. t1 - 1 of one path (its bars at ``out``,
// this path's close of bar t0; the step's own text: the nearest level, the
// direction, the volume veto, the policy gate) into the flags plane.
__device__ __forceinline__ void tile_gates(const EngineArgs& a, GateState& st, const GateVols& rg,
                                           int t0, int t1, float* out) {
#pragma unroll 1
    for (int t = t0; t < t1; ++t) {
        float* const bar = out + (t - t0) * (ROWS_PLANES * BLOCK);
        const float c = bar[0];
#include "mc_engine_nearest.cuh"
        int direction = 0;
        if (t > 0) {
            direction = c > st.prev_c + 1e-9f ? 1 : (c < st.prev_c - 1e-9f ? -1 : st.last_dir);
        }
        const bool go_long = direction == 1;
#include "mc_engine_veto.cuh"
        bool policy_fails = false;
        if (a.policy_on) {
#include "mc_engine_policy.cuh"
            policy_fails = !(chosen >= 0.6f && s[2] < 0.55f);
        }
        unsigned f = (unsigned)best_i | (best_d < INF_F ? ROWS_F_NEAREST : 0u)
                     | ((unsigned)(direction + 1) << ROWS_F_DIR_SHIFT);
        if (!weak && (veto_long || veto_short)) f |= ROWS_F_VETO;
        if (veto_long) f |= ROWS_F_VETO_LONG;
        if (policy_fails) f |= ROWS_F_POLICY;
        bar[4 * BLOCK] = __uint_as_float(f);
        if (t > 0 && c != st.prev_c) st.last_dir = c > st.prev_c ? 1 : -1;
        st.prev_c = c;
        rg.vol[(t & (GATE_RING - 1)) * BLOCK] = bar[3 * BLOCK];
    }
}

// ---- the consumers

// This thread's bytes of a shared [slots][BLOCK] array, as an array.
struct SlotBytes {
    unsigned char* p;
    __device__ unsigned char& operator[](int i) const { return p[i * BLOCK]; }
};

// A path's scalars (the parents' EngineState without its per-level arrays,
// which are in shared memory; the skip counts' array a view of them).
struct RowsState {
    float prev_c, entry, stop, target, risk0, equity, peak, dd;
    float run_low, run_high, box_low, box_high;
    int side, cooldown_until, last_dir, trades, wins, losses, escal;
    int box_valid, regime, inside_cnt;
    unsigned c_latch;                   // bit i: level i latched
    unsigned tm_has;                    // bit 2i + side: has a last touch
    int tap_ts[2 * TAP_SLOTS];          // [edge * 3 + k], newest first
    float tap_ratio[2 * TAP_SLOTS];
    SlotBytes skips;
};

// This thread's per-level state in shared memory.
struct RowsLevels {
    unsigned char* cc;                  // [MAX_LEVELS]: contact counts
    unsigned* tmcb;                     // [2 MAX_LEVELS]: touch count | its bar << 16
    float* tmpx;                        // [2 MAX_LEVELS]: the last touch's price
};

// A path's draws where the lifecycle reads them (the tie coin, the noise):
// Draws::at's value of row ``row``, a Philox call each.
struct RowDraw {
    const EngineArgs& a;
    const float* ext;
    long long p;
    __device__ float at(int row) const {
        const int row_len = ENGINE_SUB * a.lanes;
        const long long blk = p / row_len;
        const int col = (int)(p - blk * row_len);
        if (ext) return ext[(blk * a.u_rows + row) * (long long)row_len + col];
        const uint4 w = philox4((uint32_t)col, (uint32_t)(row >> 2), (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32), a.seed, a.stream);
        return to_uniform(word_of(w, row & 3));
    }
};

// mc_engine_step.cuh on RowsState and RowsLevels (``lvs``): the parents'
// macros but for the contact counts and the touch registers, and the
// bar-only gates read from the flags the producers made (``bar_flags``).
#undef C_COUNT
#undef TM_CNT
#undef TM_CNT_INC
#undef TM_TS
#undef TM_TS_SET
#undef TM_PX
#undef TM_ZERO
#undef ENGINE_TIE
#define C_COUNT(i) lvs.cc[(i) * BLOCK]
#define TM_CNT(j) (TM_HAS_BIT(j) ? (int)(lvs.tmcb[(j) * BLOCK] & 0xffffu) : 0)
#define TM_CNT_INC(j) \
    lvs.tmcb[(j) * BLOCK] = (lvs.tmcb[(j) * BLOCK] & 0xffff0000u) + (unsigned)TM_CNT(j) + 1u
#define TM_TS(j) ((int)(lvs.tmcb[(j) * BLOCK] >> 16) * 60000)
#define TM_TS_SET(j, ms) \
    lvs.tmcb[(j) * BLOCK] = (lvs.tmcb[(j) * BLOCK] & 0xffffu) | ((unsigned)((ms) / 60000) << 16)
#define TM_PX(j) lvs.tmpx[(j) * BLOCK]
#define TM_ZERO(j)
#define ENGINE_TIE dr.at(tie_row)
#define ENGINE_BAR_NEAREST                                                  \
    const bool nearest_ = (bar_flags & ROWS_F_NEAREST) != 0u;               \
    const int best_i = nearest_ ? (int)(bar_flags & 7u) : 0;                \
    const float best_p = nearest_ ? LV_PRICE(best_i) : 0.f;                 \
    const float best_d = nearest_ ? fabsf(c - best_p) : INF_F;              \
    const int best_k = nearest_ ? LV_KIND(best_i) : 0;
#define ENGINE_BAR_DIRECTION ((int)((bar_flags >> ROWS_F_DIR_SHIFT) & 3u) - 1)
#define ENGINE_BAR_VETO                                                     \
    const bool weak = (bar_flags & ROWS_F_VETO) == 0u;                      \
    const bool veto_long = (bar_flags & ROWS_F_VETO_LONG) != 0u;            \
    const bool veto_short = !weak && !veto_long;
#define ENGINE_BAR_POLICY_FAILS ((bar_flags & ROWS_F_POLICY) != 0u)

// The parents' sampler reduction of a chunk (book.cuh's cta_add_path_row,
// in its order) on the consumers' barrier.
__device__ void rows_add_path_row(const int (&cnt)[N_COUNTS + N_SKIPS], bool entered, float eq,
                                  float dd, long long* __restrict__ crow,
                                  float* __restrict__ frow, bool first) {
    constexpr int NC = N_COUNTS + N_SKIPS;
    __shared__ unsigned s_cnt[NC];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[6][BLOCK / 32];
    const int tid = threadIdx.x - BLOCK;
    consumers_sync();                        // the previous chunk's readers are done
    for (int i = tid; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
    if (tid < NC) s_cnt[tid] = 0u;
    consumers_sync();
    if (entered) atomicAdd(&s_hist[life_bin(eq)], 1u);
    const int warp = tid >> 5, wl = tid & 31;
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
    consumers_sync();
    if (tid < NC) crow[tid] = (first ? 0ll : crow[tid]) + (long long)s_cnt[tid];
    for (int i = tid; i < HIST_BINS; i += BLOCK)
        crow[NC + i] = (first ? 0ll : crow[NC + i]) + (long long)s_hist[i];
    if (tid == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) {
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
