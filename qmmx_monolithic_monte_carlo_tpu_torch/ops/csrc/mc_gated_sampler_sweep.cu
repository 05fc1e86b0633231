// The gated lifecycle's grid sweep on Hopper under the recorded-bar and Heston
// samplers: each path's bars made once and replayed for every grid row.
//
// mc_gated_sampler_sweep_kernel<KIND> replaces the sampler branches
// (bootstrap, block bootstrap, Heston) of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _gated_sweep_kernel (#6,
// :2163), which reseeds and makes a path block's bars again for every grid
// configuration.  It replaces the sweep launch of mc_gated_sampler_kernel
// (mc_gated_samplers.cu, a row a blockIdx.y: each row made the bars again),
// which keeps the single configuration (#4) and the universe (#5).
//
// A grid row changes which trades open (paddings, qmin, touch_limit,
// cooldown_bars, touch_gap, use_conf, proximity) and their noise stds, never
// the bars: a path's closes, highs and lows, its bootstrap open gap, each
// bar's tie coin and its noise uniforms are the same for every row (one key,
// one history).  So one thread makes its path's bars once, into a bar store
// of three planes (close, high, low: 12 bytes a bar), then replays each row's
// lifecycle (mc_gated_step.cuh's statements) over the store in turn, and adds
// the path to that row's partial row (book.cuh's cta_add_path_row) as the
// one-row kernel does.  Highs and lows are made for every bar (the one-row
// kernel makes them on held bars only: the same bits whoever computes them).
// The uniforms a row reads only rarely are not stored but drawn again where
// it reads them: a bar's tie coin where it hits both stop and target
// (GATED_TIE), its four noise uniforms where a trade opens (GATED_ENTRY_NOISE).
//
// The store: W x BLOCK floats a plane, thread index fastest, so a warp's
// loads are whole lines (plain loads: the slot is written again every chunk,
// so never through the read-only cache).  Too large for shared memory at
// useful occupancy (120 KB a CTA at W = 40), it is a device scratch of the
// resident CTAs: 32 MB at W = 40, inside the 50 MB L2.  The grid is
// persistent: physical CTA b takes the one-row kernel's CTAs (virtual CTAs)
// b, b + gridDim.x, ... of ``vgrid``, each in the one-row kernel's chunk
// order, and owns the store slot b, written once a chunk and read by every
// row.  Measured on the card (probes of the design; PERF.md): the
// replay is bound by the lifecycle and by the store's reads, not by making
// the bars (the three samplers cost the same); storing more (the tie coin,
// each bar's nearest level) or replaying two rows side by side (spills) ran
// slower, and two CTAs an SM (no spill) faster than three.
//
// What bounds it on the H100: the bars once a path (Heston: two Box-Muller
// pairs, the variance step and the bridge a double bar; bootstrap: a Philox
// call a double bar and four gathered values a bar), then every row's
// lifecycle (the level search, the touch latch, the confidence division);
// bytes: the store, written once and read (its closes) once a row.
//
// Results: the grid (grid_size(num_paths) virtual CTAs), the path-to-thread
// map, the per-chunk reduction and the bar arithmetic are the one-row
// kernel's, so row g's partial rows [row][CTA] and per-path rows
// [row][path] equal mc_gated_sampler_kernel's one-row launch at row g's
// GatedArgs, bit for bit.  Numerics as mc_gated_samplers.cu: -fmad=false,
// IEEE logf / sqrtf / sincosf / expf, fmaf where the JAX kernel's XLA fuses.
// A library of its own, so mc_gated_sampler_kernel keeps its code.

#include "mc_gated.cuh"
#include "book.cuh"
#include "sampler.cuh"

#define GATED_SWEEP_MIN_BLOCKS 2    // CTAs an SM for __launch_bounds__
#define BAR_PLANES 3                // close, high, low

// Make one path's W bars (the one-row kernel's draws and bar arithmetic,
// mc_gated_sampler_step.cuh) into the store (``bar``: this thread's bar 0 of
// the close plane; planes ``plane`` floats apart, bars BLOCK apart).  Returns
// the path's previous close at bar 0: the recorded open gap (bootstrap) or
// s0 (Heston).
template <int KIND>
__device__ __forceinline__ float make_bars(const GatedArgs& a, const SamplerArgs& s,
                                           const float* __restrict__ ext, long long blk,
                                           int col, int stride, float* bar, long long plane) {
    RowDraws dr{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1,
                make_uint4(0u, 0u, 0u, 0u)};
    float log_s = a.log_s0, prev0 = expf(a.log_s0);
    float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
#pragma unroll 1
    for (int t2 = 0; t2 < (a.num_bars >> 1); ++t2) {
        const int r = t2 * stride;
        float x[2], zq[2] = {0.f, 0.f}, u3s[2] = {0.f, 0.f}, u4s[2] = {0.f, 0.f};
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            x[0] = dr.at(r); x[1] = dr.at(r + 1);
        } else {
            const float2 z = normal_pair(dr.at(r), dr.at(r + 1));
            const float2 q = normal_pair(dr.at(r + 2), dr.at(r + 3));
            x[0] = z.x; x[1] = z.y; zq[0] = q.x; zq[1] = q.y;
            u3s[0] = dr.at(r + 4); u4s[0] = dr.at(r + 5);
            u3s[1] = dr.at(r + 7); u4s[1] = dr.at(r + 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int t = 2 * t2 + j;
            float c, hi, lo;
            if constexpr (KIND == SAMPLER_RESAMPLE) {
                // resample_bar_step's bar and its GATED_EXTREMES
                const float idx = resample_index(s, t, x[j], carry);
                const float log_open = log_s;
                const float log_close = log_open + table_at(s, CH_LOGC, idx);
                c = expf(log_close);
                log_s = log_close;
                if (t == 0) prev0 = expf(log_open + table_at(s, CH_LOGO, idx));
                hi = expf(log_open + table_at(s, CH_LOGH, idx));
                lo = expf(log_open + table_at(s, CH_LOGL, idx));
            } else {
                // heston_bar_step's bar and its GATED_BRIDGE_EXTREMES(var)
                float v_pos;
                const float z = x[j];
                const float sig_bar = heston_step(s, z, zq[j], carry, v_pos);
                const float var = v_pos * s.dt;
                const float log_open = log_s;
                const float log_close = fmaf(sig_bar, z, fmaf(s.mu - 0.5f * v_pos, s.dt, log_open));
                c = expf(log_close);
                log_s = log_close;
                const float u3 = u3s[j], u4 = u4s[j];
                GATED_BRIDGE_EXTREMES(var)
                hi = high;
                lo = low;
            }
            float* const b = bar + (long long)t * BLOCK;
            b[0] = c;
            b[plane] = hi;
            b[2 * plane] = lo;
        }
    }
    return prev0;
}

// Bar t of one row's lifecycle (mc_gated_step.cuh) on the stored bar ``b``
// (this thread's close at bar t; high and low in the planes ``plane`` floats
// on, read where a position is open).  Where the step reads the bar's tie
// coin (row (t / 2) stride + k_tie + tie_step (t % 2)) or, as a trade opens
// with noise, its four noise uniforms (rows (t / 2) stride + k_noise + 4 (t %
// 2) on), it draws them again from the path's (ext, blk, col).
template <int MAXL>
__device__ __forceinline__ void replay_bar(const GatedArgs& a, GatedState<MAXL>& st, int t,
                                           const float* b, long long plane,
                                           const float* __restrict__ ext, long long blk, int col,
                                           int stride, int k_noise, int k_tie, int tie_step) {
    const float c = b[0];
    float4 nu = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
#undef GATED_TIE            // mc_gated.cuh's bar step set the defaults
#undef GATED_ENTRY_NOISE
#define GATED_EXTREMES                                                                  \
    const float high = b[plane];                                                        \
    const float low = b[2 * plane];
#define GATED_TIE                                                                       \
    RowDraws{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1,        \
             make_uint4(0u, 0u, 0u, 0u)}.at((t >> 1) * stride + k_tie + tie_step * (t & 1))
#define GATED_ENTRY_NOISE                                                               \
    if (a.use_noise) {                                                                  \
        RowDraws nd{ext, blk, col, GATED_SUB * a.lanes, a.u_rows, a.seed, a.stream, -1, \
                    make_uint4(0u, 0u, 0u, 0u)};                                        \
        const int k = (t >> 1) * stride + k_noise + 4 * (t & 1);                        \
        nu = make_float4(nd.at(k), nd.at(k + 1), nd.at(k + 2), nd.at(k + 3));           \
    }
#include "mc_gated_step.cuh"
#undef GATED_ENTRY_NOISE
#undef GATED_TIE
#undef GATED_EXTREMES
}

// Every path of ``vgrid`` virtual CTAs (the one-row kernel's grid) against
// the ``n_rows`` rows at ``args`` (device memory; every row on the same draws
// and the one history at ``sargs``), physical CTA blockIdx.x taking virtual
// CTAs blockIdx.x, blockIdx.x + gridDim.x, ... and store slot blockIdx.x of
// ``store`` (BAR_PLANES x W x BLOCK floats a slot): partial rows [row][virtual
// CTA], per-path rows [row][path] when per_path is not null.
template <int MAXL, int KIND>
__global__ void __launch_bounds__(BLOCK, GATED_SWEEP_MIN_BLOCKS)
mc_gated_sampler_sweep_kernel(const GatedArgs* __restrict__ args, int n_rows,
                              const SamplerArgs* __restrict__ sargs,
                              const float* __restrict__ ext, float* store,
                              int vgrid, long long* __restrict__ part_counts,
                              float* __restrict__ part_floats, float* __restrict__ per_path) {
    __shared__ GatedArgs s_bars;        // row 0: what makes the bars, every row's
    __shared__ GatedArgs s_a;           // the row being replayed
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) { s_bars = args[0]; s_s = *sargs; }
    __syncthreads();
    const GatedArgs& b = s_bars;
    const SamplerArgs& s = s_s;
    const int row_len = GATED_SUB * b.lanes;
    const int stride = b.u_rows / (b.num_bars >> 1);      // rows a double bar
    const int k_noise = KIND == SAMPLER_RESAMPLE ? 4 : 10;
    // the tie coins of bars 2 t2 and 2 t2 + 1: rows r + 2, r + 3 (bootstrap), r + 6, r + 9
    const int k_tie = KIND == SAMPLER_RESAMPLE ? 2 : 6, tie_step = KIND == SAMPLER_RESAMPLE ? 1 : 3;
    const long long plane = (long long)b.num_bars * BLOCK;
    float* const bar0 = store + (long long)blockIdx.x * BAR_PLANES * plane + threadIdx.x;
    if (ext) ext += b.ext_offset;
    for (int v = blockIdx.x; v < vgrid; v += gridDim.x) {
        int chunk = 0;
        for (long long base = (long long)v * BLOCK; base < b.num_paths;
             base += (long long)vgrid * BLOCK, ++chunk) {
            const long long p = base + threadIdx.x;
            const bool live = p < b.num_paths;
            const long long blk = p / row_len;
            const int col = (int)(p - blk * row_len);
            const float prev0 = live ? make_bars<KIND>(b, s, ext, blk, col, stride, bar0, plane)
                                     : 0.f;
            for (int g = 0; g < n_rows; ++g) {
                // the previous row's readers of s_a passed cta_add_path_row's barriers
                if (threadIdx.x == 0) s_a = args[g];
                __syncthreads();
                const GatedArgs& a = s_a;
                GatedState<MAXL> st;
                st.log_s = a.log_s0;
                st.prev_c = prev0;
                st.entry = st.stop = st.target = 0.f;
                st.equity = st.peak = st.dd = 0.f;
                st.side = st.cooldown = st.trades = st.wins = st.losses = 0;
#pragma unroll
                for (int i = 0; i < MAXL; ++i) { st.touch[i] = 0; st.last_tb[i] = NEVER; }
                if (live) {
#pragma unroll 1
                    for (int t = 0; t < a.num_bars; ++t)
                        replay_bar<MAXL>(a, st, t, bar0 + (long long)t * BLOCK, plane, ext, blk,
                                         col, stride, k_noise, k_tie, tie_step);
                }
                const bool entered = st.trades > 0;
                const int open = st.side != 0;
                const int cnt[N_COUNTS] = {live ? 1 : 0, entered, st.wins, st.losses, open,
                                           st.trades};
                const long long seg = (long long)g * vgrid + v;
                cta_add_path_row<N_COUNTS>(cnt, entered, st.equity, st.dd,
                                           part_counts + seg * ROW_COUNTS,
                                           part_floats + seg * ROW_FLOATS, chunk == 0);
                if (per_path && live) {
                    float* o = per_path + ((long long)g * b.num_paths + p) * PATH_COLS;
                    o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                    o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
                }
            }
        }
    }
}

template <int KIND>
static int resident_ctas(int vgrid) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_gated_sampler_sweep_kernel<MAX_LEVELS, KIND>, BLOCK, 0);
    if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return -(int)rc;
    const int n = per_sm * sms;
    return n < 1 ? 1 : (n < vgrid ? n : vgrid);
}

extern "C" {

// The layouts the host mirrors: 0 GatedArgs, 1 SamplerArgs; 2 the kernel's
// static shared memory under the Heston sampler (bytes, from the runtime); 3
// the bar store's planes.
int qmmx_gated_sampler_sweep_size(int which) {
    if (which == 0) return (int)sizeof(GatedArgs);
    if (which == 1) return (int)sizeof(SamplerArgs);
    if (which == 3) return BAR_PLANES;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_HESTON>)
        != cudaSuccess)
        return -1;
    return (int)attr.sharedSizeBytes;
}

const char* qmmx_gated_sampler_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The physical CTAs of a launch over ``vgrid`` virtual CTAs under sampler
// ``kind``: the CTAs the card holds at once, at most vgrid (the store's
// slots); a CUDA error as its negative.
int qmmx_gated_sampler_sweep_ctas(int kind, int vgrid) {
    if (kind == SAMPLER_RESAMPLE) return resident_ctas<SAMPLER_RESAMPLE>(vgrid);
    if (kind == SAMPLER_HESTON) return resident_ctas<SAMPLER_HESTON>(vgrid);
    return -(int)cudaErrorInvalidValue;
}

// Pass 1 of the n_rows grid rows at ``args`` (device memory, the bars'
// fields equal in every row) under sampler ``kind`` and the one history at
// ``sargs``, on ``ctas`` physical CTAs (qmmx_gated_sampler_sweep_ctas) over
// ``vgrid`` virtual ones, ``store`` ctas x BAR_PLANES x W x BLOCK floats;
// ext and per_path null when not used; partial rows [row][vgrid].  Returns
// cudaGetLastError().
int qmmx_mc_gated_sampler_sweep(const GatedArgs* args, int n_rows, const SamplerArgs* sargs,
                                int kind, int max_levels, const float* ext, float* store,
                                int ctas, int vgrid, long long* part_counts,
                                float* part_floats, float* per_path, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (max_levels > MAX_LEVELS || n_rows < 1 || ctas < 1 || ctas > vgrid)
        return (int)cudaErrorInvalidValue;
    if (kind == SAMPLER_RESAMPLE) {
        mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_RESAMPLE><<<ctas, BLOCK, 0, s>>>(
            args, n_rows, sargs, ext, store, vgrid, part_counts, part_floats, per_path);
    } else if (kind == SAMPLER_HESTON) {
        mc_gated_sampler_sweep_kernel<MAX_LEVELS, SAMPLER_HESTON><<<ctas, BLOCK, 0, s>>>(
            args, n_rows, sargs, ext, store, vgrid, part_counts, part_floats, per_path);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
