// The first-contact (stop, tp) sweep on Hopper under the recorded-bar and
// Heston samplers: each path's bars made once and replayed against every grid
// row, as mc_first_contact_sweep_kernel (mc_first_contact_sweep.cu) does under gbm.
//
// mc_first_contact_sampler_sweep_kernel<KIND> replaces the sampler branches
// (bootstrap, block bootstrap, Heston) of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _sweep_kernel (#3,
// :1978; bars :2023-2032, once a block; the rows :2048), which generates a
// path block's bars once and replays every row against them.  It replaces
// the sweep launch of mc_first_contact_sampler_kernel (a row a blockIdx.y:
// each row made the bars again, 8.4-8.7x the one-row launch at 9 rows), which
// keeps the single configuration and the universe.
//
// Design: one thread walks one path's bars once -- the contact once, then
// each bar's high and low (the recorded offsets, or Heston's bridge) made once
// and checked against every open row, the tie coin drawn at most once a bar --
// and stops when every row has resolved, so a path costs the bars of its
// longest row.  A row's state is two bits of the SweepState masks.  The rows'
// sums are reduced as the gbm sweep reduces them: counts in shared memory,
// float sums path by path in the thread, then a warp shuffle tree, then the
// warps in order.  A row's stop and target are lvl -+ pad plus a zero slip,
// as enter() of mc_first_contact_samplers.cu sets them without noise, and the
// contact, the bars and the tie coin do not depend on the row; so row g's
// partial rows equal the one-row launch of mc_first_contact_sampler_kernel
// at row g's (stop, tp), bit for bit.
//
// What bounds it on the H100: the one-row kernel's work for the longest row
// of a path (bootstrap: a Philox call and up to four gathered table values a
// bar; Heston: two Box-Muller pairs, the variance step and the bridge's two
// logf / sqrtf a bar) plus a compare a row a bar.  Bytes: the arguments and
// a partial row per (row, CTA).  A library of its own, so the gbm kernels
// and mc_first_contact_sampler_kernel keep their code.
//
// Numerics as mc_first_contact_samplers.cu: -fmad=false, IEEE logf, sqrtf,
// sincosf and expf, fmaf exactly where the JAX kernel's XLA fuses
// (sampler.cuh).

#include "mc_first_contact.cuh"
#include "sampler.cuh"

// After contact: every open row's stop and target against the bar's high and
// low; a row hit on both sides takes the distance-weighted tie coin (row
// tie_row), drawn once a bar for all of them.
__device__ __forceinline__ void resolve_rows(const SweepGrid& gr, const Draw& draw,
                                             SweepState& st, int lane, int tie_row,
                                             float high, float low) {
    int coin = -1;
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
            if (coin < 0) {
                const float up = fmaxf(0.f, high - st.entry);
                const float dn = fmaxf(0.f, st.entry - low);
                coin = draw(tie_row, lane) < up / (up + dn + 1e-9f) ? 1 : 0;
            }
            tf = coin == 1;
        }
        if (tf) st.target_first |= 1u << g;
    }
}

// One recorded bar (index idx) of one path against every row (resample_step's
// arithmetic).  Not inlined (common.cuh).
__device__ __noinline__ void sweep_resample_step(const McArgs& a, const SamplerArgs& s,
                                                 const SweepGrid& gr, const Draw& draw,
                                                 SweepState& st, int lane, float idx) {
    const float logc = table_at(s, CH_LOGC, idx);
    st.acc = st.acc + logc;
    const float log_close = a.log_s0 + st.acc;
    const float log_prev = log_close - logc;
    if (!st.entered) {
        st.entered = contact(a, log_close, log_prev + table_at(s, CH_LOGO, idx), st.entry,
                             st.lvl, st.is_long);
        return;
    }
    resolve_rows(gr, draw, st, lane, a.num_bars, expf(log_prev + table_at(s, CH_LOGH, idx)),
                 expf(log_prev + table_at(s, CH_LOGL, idx)));
}

// One Heston bar k of one path against every row (heston_bar's arithmetic).
__device__ __noinline__ void sweep_heston_bar(const McArgs& a, const SamplerArgs& s,
                                              const SweepGrid& gr, const Draw& draw,
                                              SweepState& st, float& v, int lane, int k,
                                              float z, float zq) {
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, v, v_pos);
    const float incr = fmaf(sig_bar, z, (s.mu - 0.5f * v_pos) * s.dt);
    st.acc = st.acc + incr;
    const float log_close = a.log_s0 + st.acc;
    const float log_open = log_close - incr;
    if (!st.entered) {
        st.entered = contact(a, log_close, log_open, st.entry, st.lvl, st.is_long);
        return;
    }
    float high, low;
    bridge(a, draw, lane, k, log_close, log_open, v_pos * s.dt, high, low);
    resolve_rows(gr, draw, st, lane, 3 * a.num_bars, high, low);
}

// The rows of ``grid`` (at most SWEEP_ROWS) under the one argument row at
// ``args`` and ``sargs``, copied into shared memory once a CTA with the grid;
// partial rows [row][CTA], as the gbm sweep's.
template <int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_first_contact_sampler_sweep_kernel(const McArgs* __restrict__ args,
                                      const SamplerArgs* __restrict__ sargs,
                                      const SweepGrid grid, const float* __restrict__ ext,
                                      long long* __restrict__ part_counts,
                                      float* __restrict__ part_floats) {
    __shared__ McArgs s_a;
    __shared__ SamplerArgs s_s;
    __shared__ SweepGrid s_grid;
    __shared__ unsigned s_counts[SWEEP_ROWS][ROW_COUNTS];
    __shared__ float s_red[SWEEP_ROWS][ROW_FLOATS][BLOCK / 32];
    const int n = grid.n_rows;
    if (threadIdx.x == 0) { s_a = *args; s_s = *sargs; s_grid = grid; }
    for (int i = threadIdx.x; i < n * ROW_COUNTS; i += BLOCK)
        s_counts[i / ROW_COUNTS][i % ROW_COUNTS] = 0u;
    __syncthreads();
    const McArgs& a = s_a;
    const SamplerArgs& s = s_s;
    const float* const x = ext ? ext + a.ext_offset : nullptr;

    const unsigned all = (1u << n) - 1u;   // n <= SWEEP_ROWS
    // per-row sums, folded path by path in the one-row kernel's order
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
        const Draw draw{x, blk, a.lanes, a.n_rows, a.seed, a.stream};

        SweepState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f;
        st.entered = false; st.is_long = false;
        st.done = 0u; st.target_first = 0u;
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            float start = 0.f;
            for (int k = 0; k < a.num_bars && st.done != all; ++k) {
                const float u = needs_draw(s, k) ? draw(k, lane) : 0.f;
                sweep_resample_step(a, s, s_grid, draw, st, lane,
                                    resample_index(s, k, u, start));
            }
        } else {
            const int half = a.num_bars >> 1;
            const int qoff = 3 * a.num_bars + 1 + (a.use_noise ? 4 : 0);   // the shock's rows
            float v = s.v0;
            for (int k = 0; k < a.num_bars && st.done != all; ++k) {
                const bool cos_half = k < half;     // pair k, or the sine of pair k - W/2
                const int pair = cos_half ? k : k - half;
                const float2 z = normal_pair(draw(pair, lane), draw(half + pair, lane));
                const float2 q = normal_pair(draw(qoff + pair, lane),
                                             draw(qoff + half + pair, lane));
                sweep_heston_bar(a, s, s_grid, draw, st, v, lane, k, cos_half ? z.x : z.y,
                                 cos_half ? q.x : q.y);
            }
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

extern "C" {

// The layouts the host mirrors: 0 McArgs, 1 SamplerArgs, 2 SweepGrid.
int qmmx_sampler_sweep_struct_size(int which) {
    return which == 0 ? (int)sizeof(McArgs) : which == 1 ? (int)sizeof(SamplerArgs)
                                                         : (int)sizeof(SweepGrid);
}

// Pass 1 of the (stop, tp) rows of ``grid`` (at most SWEEP_ROWS; a host
// pointer) under the one argument row at ``args`` and ``sargs`` (device
// memory, no noise) and sampler ``kind`` (SAMPLER_RESAMPLE at any W,
// SAMPLER_HESTON at an even W); ext null in Philox mode; partial rows
// [row][CTA].  Returns cudaGetLastError().
int qmmx_mc_sampler_sweep(const McArgs* args, const SamplerArgs* sargs, const SweepGrid* grid,
                          int kind, int num_bars, const float* ext, long long* part_counts,
                          float* part_floats, int ctas, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (grid->n_rows < 1 || grid->n_rows > SWEEP_ROWS || num_bars < 1)
        return (int)cudaErrorInvalidValue;
    if (kind == SAMPLER_RESAMPLE) {
        mc_first_contact_sampler_sweep_kernel<SAMPLER_RESAMPLE><<<ctas, BLOCK, 0, s>>>(
            args, sargs, *grid, ext, part_counts, part_floats);
    } else if (kind == SAMPLER_HESTON && !(num_bars & 1)) {
        mc_first_contact_sampler_sweep_kernel<SAMPLER_HESTON><<<ctas, BLOCK, 0, s>>>(
            args, sargs, *grid, ext, part_counts, part_floats);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
