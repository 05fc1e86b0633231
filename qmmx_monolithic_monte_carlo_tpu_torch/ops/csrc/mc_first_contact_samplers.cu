// First-contact Monte Carlo on Hopper under the recorded-bar and Heston
// samplers: resample recorded bars (iid or in blocks) or generate Heston bars,
// find the first level contact, replay stop/target, reduce to PathStats rows.
//
// Replaces the sampler branches of the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _mc_kernel:
// _bootstrap_block (sampler "bootstrap" and "block_bootstrap") and
// _heston_block ("heston"), with and without execution noise; and the same
// branches of _universe_kernel (pallas_mc.py:828) and _sweep_kernel
// (pallas_mc.py:1978), which have no noise, as rows.  The Pallas
// kernel builds a (W, 8192) tile of bars and takes the log-price cumsum as a
// W x W triangular matmul; a CUDA thread walks ONE path's bars in a register
// loop with a running float32 sum, as mc_first_contact.cu does for gbm.
//
// What bounds it on the H100.  Bootstrap: per bar one Philox call (the index
// uniform) and 1-3 expf, and a read of the recorded bar's channels: at most
// four 4-byte values a bar (log return, open offset before contact, high and
// low offsets after it), each a 32-byte sector from L2 (or device memory once
// the tables outgrow L2), so gathered bytes and Philox's integer multiplies
// both count.  Heston: gbm's work plus the variance shock's Box-Muller pair
// (a logf, a sqrtf, a sincosf a pair) and a sqrtf a bar, and both pairs drawn
// again for the second half of the bars (below).  What the design does
// about it: one thread per path walks only as far as its first stop or target
// hit, the open offset is read only before contact and the high/low offsets
// and bridge draws only after it; a block-bootstrap bar that starts no block
// draws no uniform.  Heston walks the bars in order (the variance chain needs
// them so); bar t >= W/2 takes the sine halves of pair t - W/2
// (pallas_mc.py:190-201), which the thread draws again there, Philox being
// counter-based, rather than keeping 2 x W/2 of them in registers (250
// registers and one CTA an SM at W/2 = 20, spills at 64).
//
// Numerics as mc_first_contact.cu: IEEE logf, sqrtf, sincosf and expf,
// -fmad=false, and fmaf exactly where the JAX kernel's XLA fuses (sampler.cuh).
// The previous close of a recorded bar is log_close - log return, the TPU
// kernel's form (the XLA pipeline chains log s0 + cumsum instead).
//
// Rows: blockIdx.y picks the row, as in mc_universe_kernel, so one launch
// serves the single configuration (#1, one row), the (stop, tp) sweep (#3,
// rows on the same draws and history; each row walks its bars again, where
// mc_first_contact_sampler_sweep.cu walks them once for every row) and the universe (#2, a row
// a symbol on its own key, injected uniforms and history).  A CTA works on one
// row, and the x index runs fastest, so resident CTAs share one or two rows'
// tables in L2 at a time.
//
// Determinism: a fixed grid, a fixed path-to-thread map, warp-shuffle trees and
// the family's row fold (mc_reduce_rows_kernel of mc_first_contact.cu, one
// segment a row), so a run is reproducible bit for bit, and row r equals the
// one-row launch of its arguments.  This source is a library of its own, so
// the gbm kernels of mc_first_contact.cu keep their code and registers.

#include "mc_first_contact.cuh"
#include "sampler.cuh"

// At contact: the entry, its execution noise (rows tie + 1 .. tie + 4) and
// the stop/target scaffold, as bar_step of mc_first_contact.cu sets them.
__device__ __forceinline__ void enter(const McArgs& a, const Draw& draw, PathState& st,
                                      int lane, int tie_row) {
    st.entered = true;
    float stop_slip = 0.f, tgt_slip = 0.f;
    if (a.use_noise) {
        const float r1 = sqrtf(-2.0f * logf(draw(tie_row + 1, lane)));
        const float r2 = sqrtf(-2.0f * logf(draw(tie_row + 3, lane)));
        float s1, c1, s2, c2;
        sincosf(two_pi() * draw(tie_row + 2, lane), &s1, &c1);
        sincosf(two_pi() * draw(tie_row + 4, lane), &s2, &c2);
        st.lvl = st.lvl + r1 * c1 * a.lvl_jit;
        st.entry = st.entry + r1 * s1 * a.entry_slip;
        stop_slip = r2 * c2 * a.stop_slip;
        tgt_slip = r2 * s2 * a.tgt_slip;
    }
    st.stop = (st.is_long ? st.lvl - a.stop_pad : st.lvl + a.stop_pad) + stop_slip;
    st.target = (st.is_long ? st.lvl + a.tp_pad : st.lvl - a.tp_pad) + tgt_slip;
}

// After contact: stop and target against the bar's high and low, the
// distance-weighted tie coin (row tie_row) when both are hit.
__device__ __forceinline__ void resolve(const Draw& draw, PathState& st, int lane,
                                        int tie_row, float high, float low) {
    const bool stop_hit = st.is_long ? low <= st.stop : high >= st.stop;
    const bool tgt_hit = st.is_long ? high >= st.target : low <= st.target;
    if (!(stop_hit || tgt_hit)) return;
    st.done = true;
    bool tf = tgt_hit;
    if (stop_hit && tgt_hit) {
        const float up = fmaxf(0.f, high - st.entry);
        const float dn = fmaxf(0.f, st.entry - low);
        tf = draw(tie_row, lane) < up / (up + dn + 1e-9f);
    }
    st.target_first = tf;
}

// One recorded bar (index idx) of one path.  Not inlined (common.cuh).
__device__ __noinline__ void resample_step(const McArgs& a, const SamplerArgs& s,
                                           const Draw& draw, PathState& st, int lane,
                                           float idx) {
    const float logc = table_at(s, CH_LOGC, idx);
    st.acc = st.acc + logc;
    const float log_close = a.log_s0 + st.acc;
    const float log_prev = log_close - logc;
    if (!st.entered) {
        if (contact(a, log_close, log_prev + table_at(s, CH_LOGO, idx), st.entry, st.lvl,
                    st.is_long))
            enter(a, draw, st, lane, a.num_bars);
        return;
    }
    resolve(draw, st, lane, a.num_bars, expf(log_prev + table_at(s, CH_LOGH, idx)),
            expf(log_prev + table_at(s, CH_LOGL, idx)));
}

// One Heston bar k of one path from its price normal z and variance normal zq.
__device__ __noinline__ void heston_bar(const McArgs& a, const SamplerArgs& s,
                                        const Draw& draw, PathState& st, float& v, int lane,
                                        int k, float z, float zq) {
    float v_pos;
    const float sig_bar = heston_step(s, z, zq, v, v_pos);
    const float incr = fmaf(sig_bar, z, (s.mu - 0.5f * v_pos) * s.dt);
    st.acc = st.acc + incr;
    const float log_close = a.log_s0 + st.acc;
    const float log_open = log_close - incr;
    if (!st.entered) {
        if (contact(a, log_close, log_open, st.entry, st.lvl, st.is_long))
            enter(a, draw, st, lane, 3 * a.num_bars);
        return;
    }
    float high, low;
    bridge(a, draw, lane, k, log_close, log_open, v_pos * s.dt, high, low);
    resolve(draw, st, lane, 3 * a.num_bars, high, low);
}

// The paths of this CTA under arguments (a, s), reduced to one partial row
// (crow, frow) as first_contact_block of mc_first_contact.cu reduces them.
template <int KIND>
__device__ __forceinline__ void sampler_block(const McArgs& a, const SamplerArgs& s,
                                              const float* __restrict__ ext,
                                              long long* __restrict__ crow,
                                              float* __restrict__ frow) {
    __shared__ unsigned s_counts[ROW_COUNTS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) s_counts[i] = 0u;
    __syncthreads();

    unsigned cnt[N_COUNTS] = {0u, 0u, 0u, 0u, 0u};
    float sum_r = 0.f, sum_r2 = 0.f, min_r = BIG, max_r = -BIG;

    const long long stride = (long long)gridDim.x * BLOCK;
    for (long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
         p < a.num_paths; p += stride) {
        const long long blk = p / a.lanes;
        const int lane = (int)(p - blk * a.lanes);
        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};

        PathState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f; st.stop = 0.f; st.target = 0.f;
        st.entered = false; st.is_long = false; st.done = false;
        st.target_first = false;
        if constexpr (KIND == SAMPLER_RESAMPLE) {
            float start = 0.f;
            for (int k = 0; k < a.num_bars && !st.done; ++k) {
                const float u = needs_draw(s, k) ? draw(k, lane) : 0.f;
                resample_step(a, s, draw, st, lane, resample_index(s, k, u, start));
            }
        } else {
            const int half = a.num_bars >> 1;
            const int qoff = 3 * a.num_bars + 1 + (a.use_noise ? 4 : 0);   // the shock's rows
            float v = s.v0;
            for (int k = 0; k < a.num_bars && !st.done; ++k) {
                const bool cos_half = k < half;     // pair k, or the sine of pair k - W/2
                const int pair = cos_half ? k : k - half;
                const float2 z = normal_pair(draw(pair, lane), draw(half + pair, lane));
                const float2 q = normal_pair(draw(qoff + pair, lane),
                                             draw(qoff + half + pair, lane));
                heston_bar(a, s, draw, st, v, lane, k, cos_half ? z.x : z.y,
                           cos_half ? q.x : q.y);
            }
        }

        cnt[0] += 1u;
        if (st.entered) {
            float r = 0.f;
            cnt[1] += 1u;
            if (!st.done) {
                cnt[4] += 1u;
            } else if (st.target_first) {
                cnt[2] += 1u;
                r = fabsf(st.target - st.entry) / fmaxf(fabsf(st.entry - st.stop), 1e-9f);
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

// Row blockIdx.y of ``args`` / ``sargs`` (a single configuration is one row;
// a sweep's grid rows share the draws and the history, a universe's symbols
// each bring their key, injected uniforms and history): the row's McArgs and
// SamplerArgs copied into shared memory once a CTA (see mc_universe_kernel),
// partial rows [row][CTA].
template <int KIND>
__global__ void __launch_bounds__(BLOCK)
mc_first_contact_sampler_kernel(const McArgs* __restrict__ args,
                                const SamplerArgs* __restrict__ sargs,
                                const float* __restrict__ ext,
                                long long* __restrict__ part_counts,
                                float* __restrict__ part_floats) {
    __shared__ McArgs s_a;
    __shared__ SamplerArgs s_s;
    if (threadIdx.x == 0) { s_a = args[blockIdx.y]; s_s = sargs[blockIdx.y]; }
    __syncthreads();
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    sampler_block<KIND>(s_a, s_s, ext ? ext + s_a.ext_offset : nullptr,
                        part_counts + seg * ROW_COUNTS, part_floats + seg * ROW_FLOATS);
}

extern "C" {

int qmmx_sampler_args_size(void) { return (int)sizeof(SamplerArgs); }

// Pass 1 of the n_rows rows at ``args`` and ``sargs`` (device memory) under
// sampler ``kind`` (SAMPLER_RESAMPLE or SAMPLER_HESTON), one grid row per
// blockIdx.y; ext null in Philox mode; partial rows [row][CTA].  Returns
// cudaGetLastError().
int qmmx_mc_sampler(const McArgs* args, const SamplerArgs* sargs, int n_rows, int kind,
                    int num_bars, const float* ext, long long* part_counts,
                    float* part_floats, int ctas, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows < 1 || n_rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(ctas, n_rows);
    if (kind == SAMPLER_RESAMPLE) {
        mc_first_contact_sampler_kernel<SAMPLER_RESAMPLE><<<grid, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats);
    } else if (kind == SAMPLER_HESTON && !(num_bars & 1)) {
        mc_first_contact_sampler_kernel<SAMPLER_HESTON><<<grid, BLOCK, 0, s>>>(
            args, sargs, ext, part_counts, part_floats);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
