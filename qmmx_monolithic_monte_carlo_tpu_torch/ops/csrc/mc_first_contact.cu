// First-contact Monte Carlo on Hopper: generate GBM bars, find the first
// level contact, replay stop/target, reduce to PathStats rows.
//
// Replaces the TPU kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py
// _mc_kernel (gbm sampler, with and without execution noise, antithetic).
// The Pallas kernel works on (W, 8192) tiles in VMEM and takes the log-price
// cumsum as a W x W triangular matmul on the MXU; a CUDA thread instead walks
// ONE path's bars in a register loop with a running float32 sum.
//
// What bounds it on the H100: transcendentals, not bytes.  Per path of W bars
// it evaluates up to 2.5W logf, 2.5W sqrtf, W/2 sincosf and 4W expf, plus one
// Philox4x32-10 call (10 rounds of two 32-bit multiply-high/low pairs) for
// each of the 3W+1 uniforms it draws.  Bytes are negligible: a path reads
// nothing unless uniforms are injected, and a CTA writes one partial row.
// What the design does about it: one thread per path, so no transcendental is
// spent on a bar the path does not need -- bridge highs/lows (u3/u4) are drawn
// and evaluated only after contact, and the walk stops at the first stop or
// target hit.  The W/2 sine halves of the paired Box-Muller normals wait in
// registers (MAXHALF-unrolled loops) for bars W/2..W-1; the bar step and the
// Philox call are functions, not inlined, so the unrolled loops stay small.
//
// Numerics: the decision math uses logf, sqrtf, sincosf and expf -- never
// the fast-math intrinsics or nvcc's fast-math flag, whose error flips level
// and stop/target threshold crossings.  The build passes -fmad=false, so
// a*b+c rounds twice, exactly as the plain PyTorch version computes it.
// drift, sig_dt and log_s0 arrive from the host, computed there in float64.
//
// Determinism: a fixed grid (the wrapper sizes it from num_paths alone), a
// fixed path-to-thread map, warp-shuffle trees for the float sums and a second
// kernel that folds the partial rows in row order.  Counts are integers from
// the thread to the final int64 totals.
//
// mc_sweep_kernel replaces the TPU kernel pallas_mc.py _sweep_kernel: the
// stop/target grid under common random numbers.  Each path's bars and its
// first contact are computed once; the stop/target replay (with the tie coin)
// then runs for every grid row.  What bounds it is what bounds the single
// kernel, plus a few float32 compares per row and bar after contact.  Design:
// one thread per path, as above, on the same draws and the same bar
// arithmetic (contact() and bridge(), shared with bar_step); a row's state is
// two bits (resolved, target first) of two masks, its stop and target are
// recomputed from the level and the row's paddings on each bar (two adds),
// and the walk ends when every row has resolved.  At the end of a path each
// row's R is folded into that row's per-thread sums, in the order the single
// kernel folds them, so row g's partial row (row-major [row][CTA]) equals
// the single configuration's for (stop_g, tp_g) bit for bit.  The per-row
// sums live in a per-thread array (local memory, touched once per path); a
// launch takes at most SWEEP_ROWS rows, and the wrapper launches again for
// more (the draws do not depend on the row, so every launch sees the same
// paths).
//
// mc_universe_kernel replaces the TPU kernel pallas_mc.py _universe_kernel:
// the first-contact replay for S symbols in one launch, each with its own
// levels, spot, volatility, paddings and proximity, and its host-f64 drift,
// sig_dt and log_s0.  What bounds it is what bounds one configuration, S
// times.  Design: a grid of (CTAs x S), blockIdx.y the symbol; a CTA copies
// its symbol's McArgs (packed on the host, the symbol's Philox key
// stream + 256 * symbol among them) into shared memory once and runs the
// per-path loop (first_contact_block, bar_step) on that copy, so no thread
// keeps a copy of the struct in its stack frame.  The single configuration
// (_mc_kernel's counterpart) is the same kernel at one symbol: a kernel that
// hands the called bar step a reference to its kernel parameter keeps a
// stack copy of the struct in every thread (it cost the gated and engine
// kernels 28% of their time on the H100).  Symbol s's
// partial rows ([symbol][CTA]) equal its one-symbol launch's bit for bit;
// injected uniforms [S, blocks, rows, lanes] are reached through the
// symbol's ext_offset.

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 5                       // n, entered, tp, stop, open
#define ROW_COUNTS (N_COUNTS + HIST_BINS)
#define ROW_FLOATS 4                     // sum_r, sum_r2, min_r, max_r
#define BLOCK 256
#define MAX_LEVELS 8
#define BIG 3.4e38f                      // the TPU kernel's empty sentinel
#define SWEEP_ROWS 16                    // grid rows a sweep launch takes

// The host mirror of this struct is ops/cuda_mc.py:_McArgs.
struct McArgs {
    long long num_paths;
    long long ext_offset;                // a universe symbol's injected uniforms
    float level_price[MAX_LEVELS];       // invalid slots zeroed
    float level_valid[MAX_LEVELS];       // 1 / 0
    float prox, stop_pad, tp_pad;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float drift, sig_dt, log_s0;
    uint32_t seed, stream;               // Philox key
    int max_levels, num_bars, lanes, n_rows;
    int use_noise, antithetic;
};

// Uniform (block, row, lane) of the layout in ops/draws.py: injected, or
// word row%4 of Philox with counter (lane, row/4, block lo, block hi).
struct Draw {
    const float* ext;
    long long blk;
    int lanes, n_rows;
    uint32_t seed, stream;

    __device__ __forceinline__ float operator()(int row, int lane) const {
        if (ext) return ext[(blk * n_rows + row) * (long long)lanes + lane];
        const uint4 w = philox4(
            (uint32_t)lane, (uint32_t)(row >> 2), (uint32_t)blk,
            (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        return to_uniform(word_of(w, row & 3));
    }
};

struct PathState {
    float acc;          // running sum of log increments
    float entry, lvl, stop, target;
    bool entered, is_long, done, target_first;
};

// The (stop, tp) rows of one sweep launch.  The host mirror of this struct is
// ops/cuda_mc.py:_SweepGrid.
struct SweepGrid {
    int n_rows;
    float stop_pad[SWEEP_ROWS], tp_pad[SWEEP_ROWS];
};

// A path against every row: the contact once, a row's state in two masks.
struct SweepState {
    float acc, entry, lvl;
    bool entered, is_long;
    unsigned done, target_first;   // bit g: row g resolved / took the target
};

// Row g's stop and target, as bar_step sets them at entry (no noise).
__device__ __forceinline__ float row_stop(const SweepState& st, float pad) {
    return (st.is_long ? st.lvl - pad : st.lvl + pad) + 0.f;
}
__device__ __forceinline__ float row_target(const SweepState& st, float pad) {
    return (st.is_long ? st.lvl + pad : st.lvl - pad) + 0.f;
}

// The first contact at a bar's close: the nearest valid level within prox.
// Sets entry (the close), lvl and the side; false when no level is near.
__device__ __forceinline__ bool contact(const McArgs& a, float log_close,
                                        float log_open, float& entry, float& lvl,
                                        bool& is_long) {
    const float close = expf(log_close);
    float best_d = BIG, best_p = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_LEVELS; ++i) {
        if (i < a.max_levels) {
            const float d = a.level_valid[i] > 0.f
                ? fabsf(close - a.level_price[i]) : BIG;
            if (d < best_d) { best_d = d; best_p = a.level_price[i]; }
        }
    }
    if (!(best_d <= a.prox)) return false;
    entry = close;
    lvl = best_p;
    is_long = close > expf(log_open);
    return true;
}

// Brownian-bridge high and low of bar k (for bars after the entry bar).
__device__ __forceinline__ void bridge(const McArgs& a, const Draw& draw, int lane,
                                       int k, float log_close, float log_open,
                                       float sig2dt, float& high, float& low) {
    const float d2 = (log_close - log_open) * (log_close - log_open);
    const float mid = log_open + log_close;
    const float two_s2 = 2.0f * sig2dt;
    high = expf(0.5f * (mid + sqrtf(
        d2 - two_s2 * logf(draw(a.num_bars + k, lane)))));
    low = expf(0.5f * (mid - sqrtf(
        d2 - two_s2 * logf(draw(2 * a.num_bars + k, lane)))));
}

// Same-bar tie: distance-weighted coin, up share for both sides.
__device__ __forceinline__ bool tie_coin(const McArgs& a, const Draw& draw, int lane,
                                         float high, float low, float entry) {
    const float up = fmaxf(0.f, high - entry);
    const float dn = fmaxf(0.f, entry - low);
    return draw(3 * a.num_bars, lane) < up / (up + dn + 1e-9f);
}

// One bar of one path: contact search before entry, stop/target after it.
// Not inlined, for the same reason as philox4 (common.cuh).
__device__ __noinline__ void bar_step(const McArgs& a, const Draw& draw,
                                      PathState& st, int lane, int k,
                                      float z, float sig2dt) {
    const float incr = a.drift + a.sig_dt * z;
    st.acc = st.acc + incr;
    const float log_close = a.log_s0 + st.acc;
    const float log_open = log_close - incr;
    if (!st.entered) {
        if (contact(a, log_close, log_open, st.entry, st.lvl, st.is_long)) {
            st.entered = true;
            float stop_slip = 0.f, tgt_slip = 0.f;
            if (a.use_noise) {
                const int t = 3 * a.num_bars;
                const float r1 = sqrtf(-2.0f * logf(draw(t + 1, lane)));
                const float r2 = sqrtf(-2.0f * logf(draw(t + 3, lane)));
                float s1, c1, s2, c2;
                sincosf(two_pi() * draw(t + 2, lane), &s1, &c1);
                sincosf(two_pi() * draw(t + 4, lane), &s2, &c2);
                st.lvl = st.lvl + r1 * c1 * a.lvl_jit;
                st.entry = st.entry + r1 * s1 * a.entry_slip;
                stop_slip = r2 * c2 * a.stop_slip;
                tgt_slip = r2 * s2 * a.tgt_slip;
            }
            st.stop = (st.is_long ? st.lvl - a.stop_pad : st.lvl + a.stop_pad)
                      + stop_slip;
            st.target = (st.is_long ? st.lvl + a.tp_pad : st.lvl - a.tp_pad)
                        + tgt_slip;
        }
        return;
    }
    float high, low;
    bridge(a, draw, lane, k, log_close, log_open, sig2dt, high, low);
    const bool stop_hit = st.is_long ? low <= st.stop : high >= st.stop;
    const bool tgt_hit = st.is_long ? high >= st.target : low <= st.target;
    if (!(stop_hit || tgt_hit)) return;
    st.done = true;
    st.target_first = stop_hit && tgt_hit
        ? tie_coin(a, draw, lane, high, low, st.entry) : tgt_hit;
}

// The paths of this CTA (blockIdx.x of gridDim.x) under arguments ``a``,
// reduced to one partial row (crow, frow).
template <int MAXHALF>
__device__ __forceinline__ void first_contact_block(const McArgs& a,
                                                    const float* __restrict__ ext,
                                                    long long* __restrict__ crow,
                                                    float* __restrict__ frow) {
    __shared__ unsigned s_counts[ROW_COUNTS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) s_counts[i] = 0u;
    __syncthreads();

    const int half = a.num_bars >> 1;
    const float sig2dt = a.sig_dt * a.sig_dt;
    unsigned cnt[N_COUNTS] = {0u, 0u, 0u, 0u, 0u};
    float sum_r = 0.f, sum_r2 = 0.f, min_r = BIG, max_r = -BIG;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / a.lanes;
        const int lane = (int)(p - blk * a.lanes);
        // antithetic: the right half-lanes take the left partner's normals
        const bool mirror = a.antithetic && lane >= (a.lanes >> 1);
        const int zlane = mirror ? lane - (a.lanes >> 1) : lane;
        const float zsign = mirror ? -1.f : 1.f;
        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};

        PathState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f; st.stop = 0.f; st.target = 0.f;
        st.entered = false; st.is_long = false; st.done = false;
        st.target_first = false;
        float zsin[MAXHALF];
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done) break;
            const float rad = sqrtf(-2.0f * logf(draw(k, zlane)));
            float s, c;
            sincosf(two_pi() * draw(half + k, zlane), &s, &c);
            zsin[k] = zsign * (rad * s);
            bar_step(a, draw, st, lane, k, zsign * (rad * c), sig2dt);
        }
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done) break;
            bar_step(a, draw, st, lane, half + k, zsin[k], sig2dt);
        }

        cnt[0] += 1u;
        if (st.entered) {
            float r = 0.f;
            cnt[1] += 1u;
            if (!st.done) {
                cnt[4] += 1u;
            } else if (st.target_first) {
                cnt[2] += 1u;
                r = fabsf(st.target - st.entry)
                    / fmaxf(fabsf(st.entry - st.stop), 1e-9f);
            } else {
                cnt[3] += 1u;
                r = -1.f;
            }
            sum_r += r;
            sum_r2 += r * r;
            min_r = fminf(min_r, r);
            max_r = fmaxf(max_r, r);
            const int bin = min(max((int)((r - (-1.5f)) * 32.0f), 0), HIST_BINS - 1);
            atomicAdd(&s_counts[N_COUNTS + bin], 1u);
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < N_COUNTS; ++j) {
        const unsigned v = warp_count<unsigned>(cnt[j]);
        if (wl == 0) atomicAdd(&s_counts[j], v);
    }
    sum_r = warp_sum(sum_r);
    sum_r2 = warp_sum(sum_r2);
    min_r = warp_min(min_r);
    max_r = warp_max(max_r);
    if (wl == 0) {
        s_red[0][warp] = sum_r; s_red[1][warp] = sum_r2;
        s_red[2][warp] = min_r; s_red[3][warp] = max_r;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) crow[i] = (long long)s_counts[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, mn = BIG, mx = -BIG;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w];
            mn = fminf(mn, s_red[2][w]); mx = fmaxf(mx, s_red[3][w]);
        }
        frow[0] = s0; frow[1] = s1; frow[2] = mn; frow[3] = mx;
    }
}

// Symbol blockIdx.y of the universe ``rows`` (one symbol for a single
// configuration): partial rows [symbol][CTA].
template <int MAXHALF>
__global__ void __launch_bounds__(BLOCK)
mc_universe_kernel(const McArgs* __restrict__ rows, const float* __restrict__ ext,
                   long long* __restrict__ part_counts, float* __restrict__ part_floats) {
    __shared__ McArgs s_a;
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    first_contact_block<MAXHALF>(s_a, ext ? ext + s_a.ext_offset : nullptr,
                                 part_counts + seg * ROW_COUNTS, part_floats + seg * ROW_FLOATS);
}

// One bar of one path against every row of the grid (bar_step's arithmetic).
__device__ __noinline__ void sweep_bar_step(const McArgs& a, const SweepGrid& gr,
                                            const Draw& draw, SweepState& st,
                                            int lane, int k, float z, float sig2dt) {
    const float incr = a.drift + a.sig_dt * z;
    st.acc = st.acc + incr;
    const float log_close = a.log_s0 + st.acc;
    const float log_open = log_close - incr;
    if (!st.entered) {
        st.entered = contact(a, log_close, log_open, st.entry, st.lvl, st.is_long);
        return;
    }
    float high, low;
    bridge(a, draw, lane, k, log_close, log_open, sig2dt, high, low);
    int coin = -1;                       // the tie coin, drawn once a bar if needed
    for (int g = 0; g < gr.n_rows; ++g) {
        if ((st.done >> g) & 1u) continue;
        const float stop = row_stop(st, gr.stop_pad[g]);
        const float target = row_target(st, gr.tp_pad[g]);
        const bool stop_hit = st.is_long ? low <= stop : high >= stop;
        const bool tgt_hit = st.is_long ? high >= target : low <= target;
        if (!(stop_hit || tgt_hit)) continue;
        st.done |= 1u << g;
        bool tf = tgt_hit;
        if (stop_hit && tgt_hit) {
            if (coin < 0) coin = tie_coin(a, draw, lane, high, low, st.entry) ? 1 : 0;
            tf = coin == 1;
        }
        if (tf) st.target_first |= 1u << g;
    }
}

template <int MAXHALF>
__global__ void __launch_bounds__(BLOCK)
mc_sweep_kernel(const McArgs a, const SweepGrid grid, const float* __restrict__ ext,
                long long* __restrict__ part_counts, float* __restrict__ part_floats) {
    __shared__ SweepGrid s_grid;
    __shared__ unsigned s_counts[SWEEP_ROWS][ROW_COUNTS];
    __shared__ float s_red[SWEEP_ROWS][ROW_FLOATS][BLOCK / 32];
    const int n = grid.n_rows;
    if (threadIdx.x == 0) s_grid = grid;
    for (int i = threadIdx.x; i < n * ROW_COUNTS; i += BLOCK)
        s_counts[i / ROW_COUNTS][i % ROW_COUNTS] = 0u;
    __syncthreads();

    const int half = a.num_bars >> 1;
    const float sig2dt = a.sig_dt * a.sig_dt;
    const unsigned all = (1u << n) - 1u;   // n <= SWEEP_ROWS
    // per-row sums, folded path by path in the single kernel's order
    unsigned n_paths = 0u, n_entered = 0u;
    unsigned n_tp[SWEEP_ROWS], n_stop[SWEEP_ROWS];
    float sum_r[SWEEP_ROWS], sum_r2[SWEEP_ROWS], min_r[SWEEP_ROWS], max_r[SWEEP_ROWS];
    for (int g = 0; g < n; ++g) {
        n_tp[g] = n_stop[g] = 0u;
        sum_r[g] = sum_r2[g] = 0.f; min_r[g] = BIG; max_r[g] = -BIG;
    }

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / a.lanes;
        const int lane = (int)(p - blk * a.lanes);
        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};

        SweepState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f;
        st.entered = false; st.is_long = false;
        st.done = 0u; st.target_first = 0u;
        float zsin[MAXHALF];
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done == all) break;
            const float rad = sqrtf(-2.0f * logf(draw(k, lane)));
            float sn, cs;
            sincosf(two_pi() * draw(half + k, lane), &sn, &cs);
            zsin[k] = rad * sn;
            sweep_bar_step(a, s_grid, draw, st, lane, k, rad * cs, sig2dt);
        }
#pragma unroll
        for (int k = 0; k < MAXHALF; ++k) {
            if (k >= half || st.done == all) break;
            sweep_bar_step(a, s_grid, draw, st, lane, half + k, zsin[k], sig2dt);
        }

        n_paths += 1u;
        if (!st.entered) continue;
        n_entered += 1u;
        for (int g = 0; g < n; ++g) {
            float r = 0.f;
            if ((st.done >> g) & 1u) {
                if ((st.target_first >> g) & 1u) {
                    n_tp[g] += 1u;
                    const float stop = row_stop(st, s_grid.stop_pad[g]);
                    const float target = row_target(st, s_grid.tp_pad[g]);
                    r = fabsf(target - st.entry) / fmaxf(fabsf(st.entry - stop), 1e-9f);
                } else {
                    n_stop[g] += 1u;
                    r = -1.f;
                }
            }
            sum_r[g] += r;
            sum_r2[g] += r * r;
            min_r[g] = fminf(min_r[g], r);
            max_r[g] = fmaxf(max_r[g], r);
            const int bin = min(max((int)((r - (-1.5f)) * 32.0f), 0), HIST_BINS - 1);
            atomicAdd(&s_counts[g][N_COUNTS + bin], 1u);
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    const unsigned w_paths = warp_count<unsigned>(n_paths);
    const unsigned w_entered = warp_count<unsigned>(n_entered);
    for (int g = 0; g < n; ++g) {
        const unsigned w_tp = warp_count<unsigned>(n_tp[g]);
        const unsigned w_stop = warp_count<unsigned>(n_stop[g]);
        const float s0 = warp_sum(sum_r[g]), s1 = warp_sum(sum_r2[g]);
        const float mn = warp_min(min_r[g]), mx = warp_max(max_r[g]);
        if (wl == 0) {
            atomicAdd(&s_counts[g][0], w_paths);
            atomicAdd(&s_counts[g][1], w_entered);
            atomicAdd(&s_counts[g][2], w_tp);
            atomicAdd(&s_counts[g][3], w_stop);
            atomicAdd(&s_counts[g][4], w_entered - w_tp - w_stop);
            s_red[g][0][warp] = s0; s_red[g][1][warp] = s1;
            s_red[g][2][warp] = mn; s_red[g][3][warp] = mx;
        }
    }
    __syncthreads();
    // partial rows are laid out [row][CTA]: row g of this launch is segment g
    for (int i = threadIdx.x; i < n * ROW_COUNTS; i += BLOCK) {
        const int g = i / ROW_COUNTS, c = i % ROW_COUNTS;
        part_counts[((long long)g * gridDim.x + blockIdx.x) * ROW_COUNTS + c] =
            (long long)s_counts[g][c];
    }
    if (threadIdx.x < n) {
        const int g = threadIdx.x;
        float s0 = 0.f, s1 = 0.f, mn = BIG, mx = -BIG;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[g][0][w]; s1 += s_red[g][1][w];
            mn = fminf(mn, s_red[g][2][w]); mx = fmaxf(mx, s_red[g][3][w]);
        }
        float* row = part_floats + ((long long)g * gridDim.x + blockIdx.x) * ROW_FLOATS;
        row[0] = s0; row[1] = s1; row[2] = mn; row[3] = mx;
    }
}

// Second pass: fold the partial rows in row order, one CTA for each segment
// of ``rows`` rows (one segment for a single run, one per grid row for a
// sweep).  Thread t owns count column t (coalesced across threads); threads
// 0-3 own the float columns and accumulate them in float64.
__global__ void __launch_bounds__(BLOCK)
mc_reduce_rows_kernel(const long long* __restrict__ part_counts,
                      const float* __restrict__ part_floats, int rows,
                      long long* __restrict__ tot_counts,
                      double* __restrict__ tot_floats) {
    part_counts += (long long)blockIdx.x * rows * ROW_COUNTS;
    part_floats += (long long)blockIdx.x * rows * ROW_FLOATS;
    tot_counts += (long long)blockIdx.x * ROW_COUNTS;
    tot_floats += (long long)blockIdx.x * ROW_FLOATS;
    for (int col = threadIdx.x; col < ROW_COUNTS; col += BLOCK) {
        long long s = 0;
        for (int r = 0; r < rows; ++r) s += part_counts[(long long)r * ROW_COUNTS + col];
        tot_counts[col] = s;
    }
    if (threadIdx.x < ROW_FLOATS) {
        const int col = threadIdx.x;
        double acc = col == 2 ? (double)BIG : col == 3 ? -(double)BIG : 0.0;
        for (int r = 0; r < rows; ++r) {
            const double v = (double)part_floats[(long long)r * ROW_FLOATS + col];
            acc = col < 2 ? acc + v : col == 2 ? fmin(acc, v) : fmax(acc, v);
        }
        tot_floats[col] = acc;
    }
}

extern "C" {

int qmmx_mc_args_size(void) { return (int)sizeof(McArgs); }

int qmmx_sweep_grid_size(void) { return (int)sizeof(SweepGrid); }

const char* qmmx_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Sweep pass 1 over the rows of ``grid`` (at most SWEEP_ROWS): partial rows
// [row][CTA] at part_counts / part_floats.  Returns cudaGetLastError().
int qmmx_mc_sweep(const McArgs* a, const SweepGrid* grid, const float* ext,
                  long long* part_counts, float* part_floats, int ctas, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (grid->n_rows < 1 || grid->n_rows > SWEEP_ROWS) return (int)cudaErrorInvalidValue;
    const int half = a->num_bars / 2;
    if (half <= 20) {
        mc_sweep_kernel<20><<<ctas, BLOCK, 0, s>>>(*a, *grid, ext, part_counts, part_floats);
    } else if (half <= 64) {
        mc_sweep_kernel<64><<<ctas, BLOCK, 0, s>>>(*a, *grid, ext, part_counts, part_floats);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Pass 1: the n_rows symbol rows at ``rows`` (device memory; one for a single
// configuration), one per blockIdx.y, partial rows [symbol][CTA].  ext may be
// null (Philox mode).  Returns cudaGetLastError().
int qmmx_mc_universe(const McArgs* rows, int n_rows, int num_bars, const float* ext,
                     long long* part_counts, float* part_floats, int ctas, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows < 1 || n_rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(ctas, n_rows);
    const int half = num_bars / 2;
    if (half <= 20) {
        mc_universe_kernel<20><<<grid, BLOCK, 0, s>>>(rows, ext, part_counts, part_floats);
    } else if (half <= 64) {
        mc_universe_kernel<64><<<grid, BLOCK, 0, s>>>(rows, ext, part_counts, part_floats);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Pass 2 over ``segments`` segments of ``rows`` partial rows each.  Returns
// cudaGetLastError().
int qmmx_mc_reduce_rows(const long long* part_counts, const float* part_floats,
                        int rows, int segments, long long* tot_counts,
                        double* tot_floats, void* stream) {
    mc_reduce_rows_kernel<<<segments, BLOCK, 0, (cudaStream_t)stream>>>(
        part_counts, part_floats, rows, tot_counts, tot_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
