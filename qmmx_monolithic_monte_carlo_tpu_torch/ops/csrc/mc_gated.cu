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
// Each CTA copies its GatedArgs into shared memory and hands the bar step a
// reference to that copy: a reference to the kernel parameter itself makes
// every thread copy the struct into its stack frame (376 bytes against 176),
// which cost 28% of the kernel's time at 2^28 paths on the H100.
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
//
// mc_gated_sweep_kernel replaces the TPU kernel pallas_mc.py
// _gated_sweep_kernel: the whole gated lifecycle re-run for each of G knob
// rows (paddings, q_min, touch limit, cooldown, touch gap, confidence switch,
// the four noise stds), every row on the same uniforms (common random
// numbers).  What bounds it: G times what bounds one configuration, since the
// TPU kernel's design regenerates the bars for every row.  Design: a grid of
// (CTAs x G), blockIdx.y the row; a CTA copies its row's GatedArgs into
// shared memory and runs the per-path loop (gated_block, bar_step) on it.
// The single configuration (_gated_kernel's counterpart) is the same kernel
// at one row.  The Philox key and counters ignore the row, so row g equals
// the one-row launch under row g's arguments bit for bit, per path included;
// partial rows are laid out [row][CTA] and the fold takes one CTA per row.
// Sharing a block's bars across rows is left to a later change.
//
// The same kernel replaces the TPU kernel pallas_mc.py _gated_universe_kernel:
// a universe of S symbols is S rows, row s packed on the host with symbol s's
// levels, spot, volatility (its host-f64 drift, sig_dt and log_s0), paddings,
// proximity and noise stds, the shared gate knobs, its Philox key
// stream + 256 * symbol and the offset of its injected uniforms
// ([S, blocks, u_rows, 8, lanes]).  Row s equals the single configuration at
// symbol s's arguments bit for bit; the fold takes one CTA per symbol.
//
// The correlated book (mc_gated_corr.cu) shares this file's device code
// through mc_gated.cuh.

#include "mc_gated.cuh"

// The paths of this CTA (blockIdx.x of gridDim.x) under arguments ``a``:
// the lifecycle of each, reduced to one partial row (crow, frow); per-path
// rows at per_path[p] when per_path is not null.
template <int MAXL>
__device__ __forceinline__ void gated_block(const GatedArgs& a, const float* __restrict__ ext,
                                            long long* __restrict__ crow,
                                            float* __restrict__ frow,
                                            float* __restrict__ per_path) {
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
        frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx; frow[5] = md;
    }
}

// Row blockIdx.y of the grid ``rows`` (one row for a single configuration):
// partial rows [row][CTA], per-path rows [row][path].
template <int MAXL>
__global__ void __launch_bounds__(BLOCK)
mc_gated_sweep_kernel(const GatedArgs* __restrict__ rows, const float* __restrict__ ext,
                      long long* __restrict__ part_counts,
                      float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ GatedArgs s_a;
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    gated_block<MAXL>(s_a, ext ? ext + s_a.ext_offset : nullptr, part_counts + seg * ROW_COUNTS,
                      part_floats + seg * ROW_FLOATS,
                      per_path ? per_path + (long long)blockIdx.y * s_a.num_paths * PATH_COLS
                               : nullptr);
}

extern "C" {

int qmmx_gated_args_size(void) { return (int)sizeof(GatedArgs); }

const char* qmmx_gated_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Pass 1: the n_rows argument rows at ``rows`` (device memory), one grid row
// per blockIdx.y.  ext and per_path may be null (Philox mode; no per-path
// output).  Returns cudaGetLastError().
int qmmx_mc_gated_sweep(const GatedArgs* rows, int n_rows, int max_levels,
                        const float* ext, long long* part_counts, float* part_floats,
                        float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || n_rows < 1 || n_rows > 65535)
        return (int)cudaErrorInvalidValue;
    mc_gated_sweep_kernel<MAX_LEVELS><<<dim3(grid, n_rows), BLOCK, 0, (cudaStream_t)stream>>>(
        rows, ext, part_counts, part_floats, per_path);
    return (int)cudaGetLastError();
}

// Pass 2 over ``segments`` segments of ``rows`` partial rows each.  Returns
// cudaGetLastError().
int qmmx_mc_gated_reduce_rows(const long long* part_counts, const float* part_floats,
                              int rows, int segments, long long* tot_counts,
                              double* tot_floats, void* stream) {
    fold_lifecycle_rows<ROW_COUNTS><<<segments, BLOCK, 0, (cudaStream_t)stream>>>(
        part_counts, part_floats, rows, tot_counts, tot_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
