// Full 12-gate engine Monte Carlo on Hopper under the recorded-bar and Heston
// samplers: stream resampled recorded bars (iid or in blocks, with their real
// volumes) or Heston bars through the engine, reduce to PathStats rows with
// the first-fail skip table and the escalations.
//
// Replaces the sampler branches of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_kernel
// (_engine_lifecycle_loop, samplers "bootstrap", "block_bootstrap" and
// "heston", pallas_engine.py:207-519 and the per-step split :1299-1334),
// with and without execution noise, where up to 8 levels and an even W <= 61
// (mc_engine_wide_samplers.cu takes the rest of the envelope); and the same
// branches of _engine_sweep_kernel
// (pallas_engine.py:1813), _engine_universe_kernel (:2098) and
// _engine_universe_sweep_kernel (:2282) as rows.  One CUDA thread carries
// one path through its bars, with the engine of mc_engine_step.cuh on each
// bar, and one extra float of sampler state: the block's start (block
// bootstrap) or the variance (Heston).  Under the bootstrap samplers a bar's
// volume is its recorded volume (channel 4 of the tables), so the guard and
// veto gates see real volume; Heston's bars take the gbm volume model on the
// bar's price normal.
//
// What bounds it on the H100: what bounds the gbm engine kernel (the special
// functions and the per-bar gates; 46x its bound at 2^28, PERF.md), less the
// bridge and volume model for recorded bars (an expf for the close, two for
// the recorded high and low, and five 4-byte reads a bar, each a 32-byte
// sector from L2 while the tables fit there), plus a Box-Muller pair a double
// bar and a sqrtf a bar for Heston.  The design keeps the gbm kernel's: one
// thread a path, the arguments in shared memory, the rings in shared memory,
// the bar step a called function.
//
// Rows: blockIdx.y picks the row, as in mc_engine_sweep_kernel: one row for a
// single configuration (#8), a grid row of knobs and noise stds on the same
// draws and history for the sweep (#9), a symbol on its own key, injected
// uniforms and history (its recorded volumes into the volume gates) for the
// universe (#10), a (symbol, grid row) cell for the sweep of universes (#11).
// A CTA works on one row and the x index runs fastest, so resident CTAs share
// one or two rows' tables in L2 at a time.  Row r equals the one-row launch
// of its arguments bit for bit.
//
// Numerics as mc_engine.cu, with fmaf where the JAX kernel's XLA fuses the
// Heston step (sampler.cuh).  Reduction: each chunk of BLOCK paths adds to the
// CTA's partial row in chunk order (book.cuh's cta_add_path_row), then the
// family's fold (fold_lifecycle_rows of mc_engine.cu); per-path rows when
// asked.  This source is a library of its own, so the gbm kernels keep their
// code.

#include "mc_engine.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_engine_sampler_step.cuh"

// Every path of row blockIdx.y of ``args`` / ``sargs`` (a single
// configuration is one row), a thread a path in chunks of BLOCK (every thread
// of a CTA runs the same chunks, so cta_add_path_row's barriers line up):
// partial rows [row][CTA], per-path rows [row][path] when per_path is not
// null.  The envelope's sampler kernels reduce their paths in this order
// (mc_engine_env.cuh).
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_engine_sampler_kernel(const EngineArgs* __restrict__ args,
                         const SamplerArgs* __restrict__ sargs, const float* __restrict__ ext,
                         long long* __restrict__ part_counts, float* __restrict__ part_floats,
                         float* __restrict__ per_path) {
    __shared__ float s_vol[VOL_RING * BLOCK];
    __shared__ float s_close[CLOSE_RING * BLOCK];
    __shared__ EngineArgs s_a;
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) { s_a = args[blockIdx.y]; s_s = sargs[blockIdx.y]; }
    __syncthreads();
    const EngineArgs& a = s_a;
    const SamplerArgs& s = s_s;
    const Rings rg{s_vol + threadIdx.x, s_close + threadIdx.x};
    const int row_len = ENGINE_SUB * a.lanes;
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 12;
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    if (ext) ext += a.ext_offset;
    if (per_path) per_path += (long long)blockIdx.y * a.num_paths * PATH_COLS;
    int chunk = 0;
    for (long long base = (long long)blockIdx.x * BLOCK; base < a.num_paths;
         base += (long long)gridDim.x * BLOCK, ++chunk) {
        const long long p = base + threadIdx.x;
        const bool live = p < a.num_paths;
        EngineState<MAXL> st;
        init_state<MAXL>(a, st, rg);
        if (live) {
            const long long blk = p / row_len;
            const int col = (int)(p - blk * row_len);
            Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, -1,
                     make_uint4(0u, 0u, 0u, 0u)};
            float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
            for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
                const int r = t2 * a.stride;
                float x0, x1, zv0 = 0.f, zv1 = 0.f, zq0 = 0.f, zq1 = 0.f, tie0, tie1;
                float u30 = 0.f, u40 = 0.f, u31 = 0.f, u41 = 0.f;
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    x0 = dr.at(r); x1 = dr.at(r + 1);
                    tie0 = dr.at(r + 2); tie1 = dr.at(r + 3);
                } else {
                    const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
                    const float2 zv = normal_pair(dr.at(r + 2), dr.at(r + 3));
                    const float2 q = normal_pair(dr.at(r + 4), dr.at(r + 5));
                    x0 = z.x; x1 = z.y; zv0 = zv.x; zv1 = zv.y; zq0 = q.x; zq1 = q.y;
                    u30 = dr.at(r + 6); u40 = dr.at(r + 7); tie0 = dr.at(r + 8);
                    u31 = dr.at(r + 9); u41 = dr.at(r + 10); tie1 = dr.at(r + 11);
                }
                if constexpr (KIND == SAMPLER_RESAMPLE) {
                    resample_bar_step<MAXL>(a, s, st, dr, rg, 2 * t2, x0, tie0,
                                                 r + k_noise, carry);
                    resample_bar_step<MAXL>(a, s, st, dr, rg, 2 * t2 + 1, x1,
                                                 tie1, r + k_noise + 4, carry);
                } else {
                    heston_bar_step<MAXL>(a, s, st, dr, rg, 2 * t2, x0, zv0, zq0,
                                               u30, u40, tie0, r + k_noise, carry);
                    heston_bar_step<MAXL>(a, s, st, dr, rg, 2 * t2 + 1, x1, zv1,
                                               zq1, u31, u41, tie1, r + k_noise + 4, carry);
                }
            }
        }
        const bool entered = st.trades > 0;
        const int open = st.side != 0;
        int cnt[N_COUNTS + N_SKIPS] = {live ? 1 : 0, entered, st.wins, st.losses, open,
                                       st.trades, st.escal};
#pragma unroll
        for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = st.skips[j];
        cta_add_path_row<N_COUNTS + N_SKIPS>(cnt, entered, st.equity, st.dd,
                                             part_counts + seg * ROW_COUNTS,
                                             part_floats + seg * ROW_FLOATS, chunk == 0);
        if (per_path && live) {
            float* o = per_path + p * PATH_COLS;
            o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
            o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
            o[6] = (float)st.escal;
#pragma unroll
            for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)st.skips[j];
        }
    }
}

extern "C" {

int qmmx_engine_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 of the n_rows rows at ``args`` and ``sargs`` (device memory) under
// sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON), one grid row per
// blockIdx.y; ext and per_path null when not used; partial rows [row][CTA].
// Returns cudaGetLastError().
int qmmx_mc_engine_sampler(const EngineArgs* args, const SamplerArgs* sargs, int n_rows,
                           int kind, int max_levels, int num_bars, const float* ext,
                           long long* part_counts, float* part_floats, float* per_path,
                           int grid, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (max_levels > MAX_LEVELS || num_bars > 61 || (num_bars & 1) || n_rows < 1
        || n_rows > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 g(grid, n_rows);
    if (kind == SAMPLER_RESAMPLE) {
        mc_engine_sampler_kernel<MAX_LEVELS, SAMPLER_RESAMPLE><<<g, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats, per_path);
    } else if (kind == SAMPLER_HESTON) {
        mc_engine_sampler_kernel<MAX_LEVELS, SAMPLER_HESTON><<<g, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats, per_path);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
