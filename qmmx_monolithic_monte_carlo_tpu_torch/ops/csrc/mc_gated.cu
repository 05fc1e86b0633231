// Gated multi-trade lifecycle Monte Carlo on Hopper: generate GBM bars, run
// the engine's gated trade lifecycle along each path, reduce to PathStats rows.
//
// Replaces the TPU kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py
// _gated_kernel with its body _gated_lifecycle_loop and _gated_accumulate
// (gbm sampler, with and without execution noise, antithetic).  The Pallas
// kernel advances (8, 1024) tiles of ~30 state registers per bar and gathers
// the per-level touch state with one-hots; here one CUDA thread carries one
// path's state machine through its bars: cooldown, nearest level within
// CONTACT_PROX, the per-level fresh-touch latch and LEVEL_OVERTOUCHED budget,
// the confidence gate, stop/target with the distance-weighted tie coin, and
// equity / peak / drawdown.  The per-level arrays (touch count, last touch
// bar) are reached only by unrolled selects on constant indices (MAXL is a
// template parameter), never by a run-time index.
//
// What bounds it on the H100: transcendentals and Philox, not bytes.  Per bar
// the TPU kernel evaluates about 2.5 logf, 2.5 sqrtf, 3 expf and one sin or
// cos and draws 4 uniforms (8 a double-bar step, 16 with noise).  In Philox
// mode the kernel reads nothing but its arguments and writes one partial row
// per CTA, so bytes are negligible; injected uniforms (tests only) are read
// once.  What the design does about it: every Philox4x32-10 call yields four
// uniforms, so a path makes W calls (2W with noise), not 4W; the bridge
// high/low (2 logf, 2 sqrtf, 2 expf) are evaluated only on bars where the path
// holds a position, and the noise normals only on a bar that enters -- the
// flat bars, most of them, cost one expf plus half a Box-Muller pair.  The
// Philox call and the bar step are called functions, not inlined (an inlined
// build of the first-contact kernel took 215 s and ran 7.7x slower).
//
// Numerics: logf, sqrtf, sincosf and expf -- never the fast-math intrinsics
// or nvcc's fast-math flag, whose error flips level, gate and stop/target
// threshold crossings.  The build passes -fmad=false, so a*b+c rounds twice,
// as the plain PyTorch version computes it -- but for the four noise terms
// (level + normal * std), which the JAX reference's compiler fuses: they are
// explicit fmaf calls here and sim/gatedpath.fma in the plain version.
// drift, sig_dt and log_s0 arrive from the host, computed there in float64
// and rounded to float32.  Bar 0's previous close is expf(log_s0), computed
// as every close is.
//
// Determinism: a fixed grid (the wrapper sizes it from num_paths alone), a
// fixed path-to-thread map, warp-shuffle trees for the float sums and a
// second kernel that folds the partial rows in row order.  Counts are
// integers from the thread to the final int64 totals.

#include "common.cuh"

#define HIST_BINS 128
#define N_COUNTS 6            // n, entered, wins, losses, open, trades
#define ROW_COUNTS (N_COUNTS + HIST_BINS)
#define ROW_FLOATS 6          // sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
#define PATH_COLS 6           // equity, trades, wins, losses, open, dd
#define BLOCK 256
#define MAX_LEVELS 8
#define GATED_SUB 8           // rows of paths in one block
#define KIND_SOLID 1
#define BIG 3.4e38f           // the TPU kernel's empty sentinel
#define NEVER (-1000000000)   // last touch bar of an untouched level
#define LIFE_HIST_LO (-6.0f)
#define LIFE_BIN_SCALE 9.142857142857142f  // HIST_BINS / (8 - (-6)), float32

// The host mirror of this struct is ops/cuda_gated.py:_GatedArgs.
struct GatedArgs {
    long long num_paths;
    float level_price[MAX_LEVELS];       // invalid slots zeroed
    float level_valid[MAX_LEVELS];       // 1 / 0
    int level_kind[MAX_LEVELS];          // KIND_SOLID / KIND_DASHED
    float prox, stop_pad, tp_pad;
    float lvl_jit, entry_slip, stop_slip, tgt_slip;
    float qmin, drift, sig_dt, log_s0;
    uint32_t seed, stream;               // Philox key
    int touch_limit, cooldown_bars, touch_gap, use_conf;
    int max_levels, num_bars, lanes, u_rows;
    int use_noise, antithetic;
};

// Uniforms of one path's block in the layout of ops/draws.GatedLayout:
// rows 4g .. 4g+3 of column col (= sublane * lanes + lane) are injected, or
// the four words of Philox with counter (col, g, block lo, block hi).
struct Draws {
    const float* ext;
    long long blk;
    int row_len, u_rows;
    uint32_t seed, stream;

    __device__ __forceinline__ float4 group(int g, int col) const {
        if (ext) {
            const long long n = row_len;
            const float* q = ext + (blk * u_rows + 4LL * g) * n + col;
            return make_float4(q[0], q[n], q[2 * n], q[3 * n]);
        }
        const uint4 w = philox4((uint32_t)col, (uint32_t)g, (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32),
                                seed, stream);
        return make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z),
                           to_uniform(w.w));
    }
};

template <int MAXL>
struct GatedState {
    float log_s, prev_c, entry, stop, target, equity, peak, dd;
    int side, cooldown, trades, wins, losses;
    int touch[MAXL], last_tb[MAXL];
};

// One bar of one path (_one_bar, pallas_mc.py:1325-1512): generate it, manage
// the open position, then evaluate entry.  nu holds the bar's four noise
// uniforms (radius, angle, radius, angle), read only when the bar enters.
template <int MAXL>
__device__ __noinline__ void bar_step(const GatedArgs& a, GatedState<MAXL>& st,
                                      int t, float z, float u3, float u4,
                                      float tie, float4 nu) {
    const float log_open = st.log_s;
    const float log_close = log_open + (a.drift + a.sig_dt * z);
    const float c = expf(log_close);
    st.log_s = log_close;

    // 1) position management: stop/target off the bridge high/low
    const bool was_open = st.side != 0;
    bool closed = false;
    if (was_open) {
        const float sig2dt = a.sig_dt * a.sig_dt;
        const float diff = log_close - log_open;
        const float d2 = diff * diff;
        const float mid = log_open + log_close;
        const float high = expf(0.5f * (mid + sqrtf(d2 - 2.0f * sig2dt * logf(u3))));
        const float low = expf(0.5f * (mid - sqrtf(d2 - 2.0f * sig2dt * logf(u4))));
        const bool is_long = st.side > 0;
        const bool stop_hit = is_long ? low <= st.stop : high >= st.stop;
        const bool tgt_hit = is_long ? high >= st.target : low <= st.target;
        closed = stop_hit || tgt_hit;
        if (closed) {
            bool target_first = tgt_hit;
            if (stop_hit && tgt_hit) {
                // same-bar tie: distance-weighted coin, up share for both sides
                const float up = fmaxf(0.f, high - st.entry);
                const float dn = fmaxf(0.f, st.entry - low);
                target_first = tie < up / (up + dn + 1e-9f);
            }
            const float risk = fmaxf(fabsf(st.entry - st.stop), 1e-9f);
            const float reward = fabsf(st.target - st.entry);
            st.equity = st.equity + (target_first ? reward / risk : -1.f);
            st.peak = fmaxf(st.peak, st.equity);
            st.dd = fmaxf(st.dd, st.peak - st.equity);
            if (target_first) ++st.wins; else ++st.losses;
            st.side = 0;
        }
    }

    // 2) entry at the close, for paths flat at the start of the bar
    const bool cd_ok = st.cooldown <= 0;
    st.cooldown = closed ? a.cooldown_bars : max(st.cooldown - 1, 0);
    if (!was_open && cd_ok && c != st.prev_c) {
        float best_d = BIG, best_p = 0.f;
        int best_k = 0, best_i = 0;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
            if (i < a.max_levels) {
                const float d = a.level_valid[i] > 0.f ? fabsf(c - a.level_price[i]) : BIG;
                if (d < best_d) {
                    best_d = d; best_p = a.level_price[i];
                    best_k = a.level_kind[i]; best_i = i;
                }
            }
        }
        if (best_d <= a.prox) {
            // fresh-touch latch, de-duplicated by the gap
            int tc = 0, last_t = 0;
#pragma unroll
            for (int i = 0; i < MAXL; ++i) {
                if (i == best_i) { tc = st.touch[i]; last_t = st.last_tb[i]; }
            }
            if (t - last_t >= a.touch_gap) {
                ++tc;
#pragma unroll
                for (int i = 0; i < MAXL; ++i) {
                    if (i == best_i) { st.touch[i] = tc; st.last_tb[i] = t; }
                }
            }
            // confidence (ops/confidence.compute_confidence order, float32)
            float base = fmaxf(0.f, 1.f - best_d / fmaxf(1e-4f, a.prox));
            base = base + (best_k == KIND_SOLID ? 0.08f : 0.02f);
            base = base + (tc <= 1 ? 0.10f : (tc == 2 ? -0.08f : -0.16f));
            base = base + 0.03f;           // direction always known here
            const float conf = fminf(fmaxf(base, 0.f), 1.f);
            if (tc < a.touch_limit && (!a.use_conf || conf >= a.qmin)) {
                const bool go_long = c > st.prev_c;
                st.side = go_long ? 1 : -1;
                ++st.trades;
                if (a.use_noise) {
                    // per-entry execution noise; the gates saw the true level
                    const float r1 = sqrtf(-2.0f * logf(nu.x));
                    const float r2 = sqrtf(-2.0f * logf(nu.z));
                    float s1, c1, s2, c2;
                    sincosf(two_pi() * nu.y, &s1, &c1);
                    sincosf(two_pi() * nu.w, &s2, &c2);
                    const float lvl = fmaf(r1 * c1, a.lvl_jit, best_p);
                    st.entry = fmaf(r1 * s1, a.entry_slip, c);
                    st.stop = fmaf(r2 * c2, a.stop_slip,
                                   go_long ? lvl - a.stop_pad : lvl + a.stop_pad);
                    st.target = fmaf(r2 * s2, a.tgt_slip,
                                     go_long ? lvl + a.tp_pad : lvl - a.tp_pad);
                } else {
                    st.entry = c;
                    st.stop = go_long ? best_p - a.stop_pad : best_p + a.stop_pad;
                    st.target = go_long ? best_p + a.tp_pad : best_p - a.tp_pad;
                }
            }
        }
    }
    st.prev_c = c;
}

template <int MAXL>
__global__ void __launch_bounds__(BLOCK)
mc_gated_kernel(const GatedArgs a, const float* __restrict__ ext,
                long long* __restrict__ part_counts,
                float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ unsigned long long s_counts[N_COUNTS];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
    if (threadIdx.x < N_COUNTS) s_counts[threadIdx.x] = 0ull;
    __syncthreads();

    const int row_len = GATED_SUB * a.lanes;
    const int half_lanes = a.lanes >> 1;
    const int groups = a.use_noise ? 4 : 2;   // Philox calls per double-bar step
    unsigned long long cnt[N_COUNTS] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
    float sum_eq = 0.f, sum_eq2 = 0.f, sum_dd = 0.f;
    float min_eq = BIG, max_eq = -BIG, max_dd = 0.f;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / row_len;
        const int col = (int)(p - blk * row_len);
        // antithetic: right half-lanes take the left partner's normals negated
        const bool mirror = a.antithetic && (col % a.lanes) >= half_lanes;
        const Draws dr{ext, blk, row_len, a.u_rows, a.seed, a.stream};

        GatedState<MAXL> st;
        st.log_s = a.log_s0;
        st.prev_c = expf(a.log_s0);
        st.entry = st.stop = st.target = 0.f;
        st.equity = st.peak = st.dd = 0.f;
        st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }

        const float4 no_noise = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
#pragma unroll 1
        for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
            const int g = t2 * groups;
            const float4 d0 = dr.group(g, col);      // u1, u2, u3, u4 of bar 2t2
            const float4 d1 = dr.group(g + 1, col);  // tie; u3, u4, tie of 2t2+1
            float u1 = d0.x, u2 = d0.y;
            if (mirror) {
                const float4 m = dr.group(g, col - half_lanes);
                u1 = m.x; u2 = m.y;
            }
            const float4 n0 = a.use_noise ? dr.group(g + 2, col) : no_noise;
            const float4 n1 = a.use_noise ? dr.group(g + 3, col) : no_noise;
            const float rad = sqrtf(-2.0f * logf(u1));
            float sn, cs;
            sincosf(two_pi() * u2, &sn, &cs);
            float z0 = rad * cs, z1 = rad * sn;
            if (mirror) { z0 = -z0; z1 = -z1; }
            bar_step<MAXL>(a, st, 2 * t2, z0, d0.z, d0.w, d1.x, n0);
            bar_step<MAXL>(a, st, 2 * t2 + 1, z1, d1.y, d1.z, d1.w, n1);
        }

        const bool entered = st.trades > 0;
        cnt[0] += 1ull;
        cnt[1] += entered ? 1ull : 0ull;
        cnt[2] += (unsigned long long)st.wins;
        cnt[3] += (unsigned long long)st.losses;
        cnt[4] += st.side != 0 ? 1ull : 0ull;
        cnt[5] += (unsigned long long)st.trades;
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
        }
    }

    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < N_COUNTS; ++j) {
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
    long long* crow = part_counts + (long long)blockIdx.x * ROW_COUNTS;
    if (threadIdx.x < N_COUNTS) crow[threadIdx.x] = (long long)s_counts[threadIdx.x];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK)
        crow[N_COUNTS + i] = (long long)s_hist[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
            md = fmaxf(md, s_red[5][w]);
        }
        float* row = part_floats + (long long)blockIdx.x * ROW_FLOATS;
        row[0] = s0; row[1] = s1; row[2] = s2; row[3] = mn; row[4] = mx; row[5] = md;
    }
}

// Second pass: fold the partial rows in row order (one CTA).  Thread t owns
// count column t; threads 0-5 own the float columns and accumulate them in
// float64 (sums, then min, max, max).
__global__ void __launch_bounds__(BLOCK)
mc_gated_reduce_rows_kernel(const long long* __restrict__ part_counts,
                            const float* __restrict__ part_floats, int rows,
                            long long* __restrict__ tot_counts,
                            double* __restrict__ tot_floats) {
    for (int col = threadIdx.x; col < ROW_COUNTS; col += BLOCK) {
        long long s = 0;
        for (int r = 0; r < rows; ++r) s += part_counts[(long long)r * ROW_COUNTS + col];
        tot_counts[col] = s;
    }
    if (threadIdx.x < ROW_FLOATS) {
        const int col = threadIdx.x;
        double acc = col == 3 ? (double)BIG : col == 4 ? -(double)BIG : 0.0;
        for (int r = 0; r < rows; ++r) {
            const double v = (double)part_floats[(long long)r * ROW_FLOATS + col];
            acc = col < 3 ? acc + v : col == 3 ? fmin(acc, v) : fmax(acc, v);
        }
        tot_floats[col] = acc;
    }
}

extern "C" {

int qmmx_gated_args_size(void) { return (int)sizeof(GatedArgs); }

const char* qmmx_gated_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Pass 1.  ext and per_path may be null (Philox mode; no per-path output).
// Returns cudaGetLastError().
int qmmx_mc_gated(const GatedArgs* a, const float* ext, long long* part_counts,
                  float* part_floats, float* per_path, int grid, void* stream) {
    if (a->max_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    mc_gated_kernel<MAX_LEVELS><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        *a, ext, part_counts, part_floats, per_path);
    return (int)cudaGetLastError();
}

// Pass 2.  Returns cudaGetLastError().
int qmmx_mc_gated_reduce_rows(const long long* part_counts, const float* part_floats,
                              int rows, long long* tot_counts, double* tot_floats,
                              void* stream) {
    mc_gated_reduce_rows_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
        part_counts, part_floats, rows, tot_counts, tot_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
