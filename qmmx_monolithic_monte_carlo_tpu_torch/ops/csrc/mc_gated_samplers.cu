// Gated multi-trade lifecycle Monte Carlo on Hopper under the recorded-bar and
// Heston samplers: stream resampled recorded bars (iid or in blocks) or
// Heston bars through the gated lifecycle, reduce to PathStats rows.
//
// Replaces the sampler branches of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _gated_kernel
// (_gated_lifecycle_loop, samplers "bootstrap", "block_bootstrap" and
// "heston", pallas_mc.py:1187-1375), with and without execution noise, and
// the same branches of _gated_universe_kernel (pallas_mc.py:1568) and
// _gated_sweep_kernel (pallas_mc.py:2163) as rows.  The
// Pallas kernel advances (8, 1024) tiles a double bar at a time and gathers
// the recorded bars by a one-hot blend over the table's lane tiles; here one
// CUDA thread carries one path through its bars, with the lifecycle of
// mc_gated_step.cuh on each bar, and one extra float of sampler state:
// the block's start (block bootstrap) or the variance (Heston).
//
// What bounds it on the H100.  Bootstrap: a Philox call a double bar (four
// rows: two index uniforms, two tie coins), an expf a bar for the close and
// two more where a position is open, and a 4-byte read a bar (the log
// return; the high and low offsets too where a position is open), each a
// 32-byte sector from L2 while the tables fit there.  Heston: the gbm
// kernel's work plus a second Box-Muller pair a double bar and a sqrtf a bar.
// Integer multiplies (Philox) and the special-function unit bound it, as they
// bound the gbm kernel.  What the design does about it: the bridge or the
// recorded extremes only on bars that hold a position, the noise normals only
// on a bar that enters, and a block-bootstrap bar that starts no block reads
// no index.  The Philox call and the bar step are called functions (common.cuh).
//
// A bootstrap path's previous close at bar 0 is its recorded open gap,
// exp(log s0 + logo) (pallas_mc.py:1353-1357).  Numerics as mc_gated.cu, with
// fmaf where the JAX kernel's XLA fuses the Heston step (sampler.cuh).
//
// Rows: blockIdx.y picks the row, as in mc_gated_sweep_kernel: one row for a
// single configuration (#4), a grid row of (stop, tp, gate knobs, noise stds)
// on the same draws and history for the sweep (#6), a symbol on its own key,
// injected uniforms and history for the universe (#5).  A CTA works on one
// row and the x index runs fastest, so resident CTAs share one or two rows'
// tables in L2 at a time.
//
// Reduction: each chunk of BLOCK paths adds to the CTA's partial row in chunk
// order (book.cuh's cta_add_path_row), then the family's fold
// (fold_lifecycle_rows of mc_gated.cu, one segment a row); per-path rows when
// asked.  Row r equals the one-row launch of its arguments bit for bit.  This
// source is a library of its own, so the gbm kernels keep their code.

#include "mc_gated.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_gated_sampler_step.cuh"

// Every path of row blockIdx.y of ``args`` / ``sargs`` (a single
// configuration is one row), a thread a path in chunks of BLOCK (every thread
// of a CTA runs the same chunks, so cta_add_path_row's barriers line up):
// partial rows [row][CTA], per-path rows [row][path] when per_path is not
// null.
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_gated_sampler_kernel(const GatedArgs* __restrict__ args, const SamplerArgs* __restrict__ sargs,
                        const float* __restrict__ ext, long long* __restrict__ part_counts,
                        float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ GatedArgs s_a;
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) { s_a = args[blockIdx.y]; s_s = sargs[blockIdx.y]; }
    __syncthreads();
    const GatedArgs& a = s_a;
    const SamplerArgs& s = s_s;
    const int row_len = GATED_SUB * a.lanes;
    const int stride = a.u_rows / (a.num_bars >> 1);      // rows a double bar
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 10;
    const float4 no_noise = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    if (ext) ext += a.ext_offset;
    if (per_path) per_path += (long long)blockIdx.y * a.num_paths * PATH_COLS;
    int chunk = 0;
    for (long long base = (long long)blockIdx.x * BLOCK; base < a.num_paths;
         base += (long long)gridDim.x * BLOCK, ++chunk) {
        const long long p = base + threadIdx.x;
        const bool live = p < a.num_paths;
        GatedState<MAXL> st;
        st.log_s = a.log_s0;
        st.prev_c = expf(a.log_s0);
        st.entry = st.stop = st.target = 0.f;
        st.equity = st.peak = st.dd = 0.f;
        st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
        for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }
        if (live) {
            const long long blk = p / row_len;
            const int col = (int)(p - blk * row_len);
            RowDraws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                        make_uint4(0u, 0u, 0u, 0u)};
            float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
            for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
                const int r = t2 * stride;
                float x0, x1, zq0 = 0.f, zq1 = 0.f, tie0, tie1;
                float u30 = 0.f, u40 = 0.f, u31 = 0.f, u41 = 0.f;
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    x0 = dr.at(r); x1 = dr.at(r + 1);
                    tie0 = dr.at(r + 2); tie1 = dr.at(r + 3);
                } else {
                    const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
                    const float2 q = normal_pair(dr.at(r + 2), dr.at(r + 3));
                    x0 = z.x; x1 = z.y; zq0 = q.x; zq1 = q.y;
                    u30 = dr.at(r + 4); u40 = dr.at(r + 5); tie0 = dr.at(r + 6);
                    u31 = dr.at(r + 7); u41 = dr.at(r + 8); tie1 = dr.at(r + 9);
                }
                float4 n0 = no_noise, n1 = no_noise;
                if (a.use_noise) {
                    const int k = r + k_noise;
                    n0 = make_float4(dr.at(k), dr.at(k + 1), dr.at(k + 2), dr.at(k + 3));
                    n1 = make_float4(dr.at(k + 4), dr.at(k + 5), dr.at(k + 6), dr.at(k + 7));
                }
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    resample_bar_step<MAXL>(a, s, st, 2 * t2, x0, tie0, n0, carry);
                    resample_bar_step<MAXL>(a, s, st, 2 * t2 + 1, x1, tie1, n1, carry);
                } else {
                    heston_bar_step<MAXL>(a, s, st, 2 * t2, x0, zq0, u30, u40, tie0, n0, carry);
                    heston_bar_step<MAXL>(a, s, st, 2 * t2 + 1, x1, zq1, u31, u41, tie1, n1,
                                          carry);
                }
            }
        }
        const bool entered = st.trades > 0;
        const int open = st.side != 0;
        const int cnt[N_COUNTS] = {live ? 1 : 0, entered, st.wins, st.losses, open, st.trades};
        cta_add_path_row<N_COUNTS>(cnt, entered, st.equity, st.dd,
                                   part_counts + seg * ROW_COUNTS,
                                   part_floats + seg * ROW_FLOATS, chunk == 0);
        if (per_path && live) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
        }
    }
}

extern "C" {

int qmmx_gated_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 of the n_rows rows at ``args`` and ``sargs`` (device memory) under
// sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON), one grid row per
// blockIdx.y; ext and per_path null when not used; partial rows [row][CTA].
// Returns cudaGetLastError().
int qmmx_mc_gated_sampler(const GatedArgs* args, const SamplerArgs* sargs, int n_rows,
                          int kind, int max_levels, const float* ext, long long* part_counts,
                          float* part_floats, float* per_path, int grid, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (max_levels > MAX_LEVELS || n_rows < 1 || n_rows > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 g(grid, n_rows);
    if (kind == SAMPLER_RESAMPLE) {
        mc_gated_sampler_kernel<MAX_LEVELS, SAMPLER_RESAMPLE><<<g, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats, per_path);
    } else if (kind == SAMPLER_HESTON) {
        mc_gated_sampler_kernel<MAX_LEVELS, SAMPLER_HESTON><<<g, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats, per_path);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
