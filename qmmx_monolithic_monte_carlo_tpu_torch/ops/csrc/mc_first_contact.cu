// First-contact Monte Carlo on Hopper: generate GBM bars, find the first
// level contact, replay stop/target, reduce to PathStats rows.
//
// mc_universe_kernel replaces the TPU kernels
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _mc_kernel (#1, :584, gbm,
// with and without execution noise, antithetic; any even W) and
// _universe_kernel (#2, :828: S symbols in one launch, each with its own
// levels, spot, volatility, paddings and proximity, and its host-f64 drift,
// sig_dt and log_s0).  The Pallas kernels work on (W, 8192) tiles in VMEM
// and take the log-price cumsum as a W x W triangular matmul on the MXU; a
// CUDA thread instead walks ONE path's bars with a running float32 sum.  The
// single configuration is the kernel at one symbol.
//
// What bounds it on the H100: transcendentals and integer multiplies, not
// bytes.  Per path of W bars it evaluates up to 2.5W logf, 2.5W sqrtf, W/2
// sincosf and 4W expf, plus Philox4x32-10 calls (40 multiplies each) for its
// 3W + 1 uniforms.  A path reads nothing unless uniforms are injected, and a
// CTA writes one partial row.  What the design does about it (the gbm
// sweep's, mc_first_contact_sweep.cu, at one row):
// - One thread a path, and no transcendental on a bar the path does not
//   need: the bridge's high and low only after contact, the walk stops at
//   the first stop or target hit.
// - The symbol's McArgs sits in shared memory, copied once a CTA (a (CTAs x
//   S) grid, blockIdx.y the symbol); no thread keeps a copy of it.
// - The path state stays in registers across a rolled bar loop with the bar
//   step inlined.
// - The sine halves of the Box-Muller pairs wait in dynamic shared memory,
//   [half][CTA thread] floats, thread index fastest: ``cap`` of them a
//   thread (every one up to W = 2 FC_MAX_CAP), and a bar whose pair lies
//   past ``cap`` draws the pair again (Philox is counter-based, an injected
//   uniform is read again, and sincosf of the same argument gives the same
//   sine).  So one kernel takes every even W.  Probed on the card (PERF.md):
//   at W = 390 keeping 24 halves ran 0.83x / 0.86x the time of keeping 64
//   (paths / config #4's universe), 32 about as fast, 40 and more much
//   slower (the spills' local memory loses L1 to shared memory); W = 40
//   keeps its 20 either way.
// - FC_MIN_BLOCKS CTAs an SM (__launch_bounds__: 64 registers); of 2 to 6
//   these ran fastest.
// - The radius, angle, high and low streams (rows k, W/2 + k, W + t, 2W + t
//   of ops/draws.GbmLayout) each keep their last Philox call's four words
//   (StreamDraw): a path reads each stream in increasing row order, so a
//   group of four rows costs one call, not four.  The tie coin (row 3W) and
//   the entry's noise (rows 3W + 1 .. 3W + 4), read at most once a path,
//   draw where they are read.
// - Antithetic lanes: the right half-lanes read the left partner's radius
//   and angle streams and negate its normals.
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
// the thread to the final int64 totals.  The grid, the map, the bar
// arithmetic, the per-thread fold order and the reduction are those of the
// kernel this one replaced (the sine halves in an unrolled register array up
// to W = 128, past it a build drawing every pair again), so its partial rows
// [symbol][CTA] are that kernel's bit for bit, whatever ``cap`` is; symbol
// s's equal its one-symbol launch's, injected uniforms [S, blocks, rows,
// lanes] reached through the symbol's ext_offset.
//
// The gbm sweep (#3) is mc_first_contact_sweep.cu; the bootstrap,
// block-bootstrap and Heston kernels are mc_first_contact_samplers.cu.  Each
// is a library of its own and shares this kernel's device code through
// mc_first_contact.cuh.  The fold (mc_reduce_rows_kernel) serves them all.

#include "mc_first_contact.cuh"

// The launch (qmmx_mc_universe) owns this policy; qmmx_mc_universe_plan
// reports it to the host.
#define FC_MIN_BLOCKS 4              // CTAs an SM for __launch_bounds__
#define FC_MAX_CAP 24                // sine halves a thread keeps, at most

// Symbol blockIdx.y of the universe ``rows`` (one symbol for a single
// configuration), the first ``cap`` sine halves of a path in dynamic shared
// memory: partial rows [symbol][CTA].
__global__ void __launch_bounds__(BLOCK, FC_MIN_BLOCKS)
mc_universe_kernel(const McArgs* __restrict__ rows, int cap, const float* __restrict__ ext,
                   long long* __restrict__ part_counts, float* __restrict__ part_floats) {
    extern __shared__ float s_sin[];                 // [cap][BLOCK]
    __shared__ McArgs s_a;
    __shared__ unsigned s_counts[ROW_COUNTS];
    __shared__ float s_red[ROW_FLOATS][BLOCK / 32];
    if (threadIdx.x == 0) s_a = rows[blockIdx.y];
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) s_counts[i] = 0u;
    __syncthreads();
    const McArgs& a = s_a;
    if (ext) ext += a.ext_offset;
    const int w = a.num_bars, half = w >> 1;
    const float sig2dt = a.sig_dt * a.sig_dt;
    const float two_s2 = 2.0f * sig2dt;
    float* const sin_k = s_sin + threadIdx.x;
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
        StreamDraw rad_s{-1, {}}, ang_s{-1, {}}, hi_s{-1, {}}, lo_s{-1, {}};
        PathState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f; st.stop = 0.f; st.target = 0.f;
        st.entered = false; st.is_long = false; st.done = false;
        st.target_first = false;
#pragma unroll 1
        for (int t = 0; t < w && !st.done; ++t) {
            const int k = t < half ? t : t - half;    // the bar's Box-Muller pair
            float z;
            if (t >= half && k < cap) {
                z = sin_k[k * BLOCK];
            } else {
                const float rad = sqrtf(-2.0f * logf(stream_at(a, ext, blk, zlane, k, rad_s)));
                float sn, cs;
                sincosf(two_pi() * stream_at(a, ext, blk, zlane, half + k, ang_s), &sn, &cs);
                if (t < half) {
                    if (k < cap) sin_k[k * BLOCK] = zsign * (rad * sn);
                    z = zsign * (rad * cs);
                } else {
                    z = zsign * (rad * sn);
                }
            }
            // the bar: contact search before entry ...
            const float incr = a.drift + a.sig_dt * z;
            st.acc = st.acc + incr;
            const float log_close = a.log_s0 + st.acc;
            const float log_open = log_close - incr;
            if (!st.entered) {
                if (contact(a, log_close, log_open, st.entry, st.lvl, st.is_long)) {
                    st.entered = true;
                    float stop_slip = 0.f, tgt_slip = 0.f;
                    if (a.use_noise) {
                        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};
                        const int r = 3 * w;
                        const float r1 = sqrtf(-2.0f * logf(draw(r + 1, lane)));
                        const float r2 = sqrtf(-2.0f * logf(draw(r + 3, lane)));
                        float s1, c1, s2, c2;
                        sincosf(two_pi() * draw(r + 2, lane), &s1, &c1);
                        sincosf(two_pi() * draw(r + 4, lane), &s2, &c2);
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
                continue;
            }
            // ... then bridge()'s high and low against the stop and target
            const float d2 = (log_close - log_open) * (log_close - log_open);
            const float mid = log_open + log_close;
            const float high = expf(0.5f * (mid + sqrtf(
                d2 - two_s2 * logf(stream_at(a, ext, blk, lane, w + t, hi_s)))));
            const float low = expf(0.5f * (mid - sqrtf(
                d2 - two_s2 * logf(stream_at(a, ext, blk, lane, 2 * w + t, lo_s)))));
            const bool stop_hit = st.is_long ? low <= st.stop : high >= st.stop;
            const bool tgt_hit = st.is_long ? high >= st.target : low <= st.target;
            if (!(stop_hit || tgt_hit)) continue;
            st.done = true;
            if (stop_hit && tgt_hit) {
                const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};
                st.target_first = tie_coin(a, draw, lane, high, low, st.entry);
            } else {
                st.target_first = tgt_hit;
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
    const long long seg = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    long long* const crow = part_counts + seg * ROW_COUNTS;
    for (int i = threadIdx.x; i < ROW_COUNTS; i += BLOCK) crow[i] = (long long)s_counts[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, mn = BIG, mx = -BIG;
        for (int wp = 0; wp < BLOCK / 32; ++wp) {
            s0 += s_red[0][wp]; s1 += s_red[1][wp];
            mn = fminf(mn, s_red[2][wp]); mx = fmaxf(mx, s_red[3][wp]);
        }
        float* const frow = part_floats + seg * ROW_FLOATS;
        frow[0] = s0; frow[1] = s1; frow[2] = mn; frow[3] = mx;
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

// The sine halves a thread keeps at an even W: all W/2 up to FC_MAX_CAP,
// none unless ``keep`` (each pair drawn again).
static int universe_cap(int w, int keep) {
    return keep ? (w / 2 < FC_MAX_CAP ? w / 2 : FC_MAX_CAP) : 0;
}

extern "C" {

int qmmx_mc_args_size(void) { return (int)sizeof(McArgs); }

const char* qmmx_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// What a launch at an even W >= 2 takes (``keep`` as in qmmx_mc_universe):
// out[0] the sine halves a thread keeps, out[1] the kernel's CTAs an SM
// (__launch_bounds__), out[2] its static shared memory (bytes, from the
// runtime), out[3] its dynamic shared memory.  Returns a CUDA error code.
int qmmx_mc_universe_plan(int w, int keep, int* out) {
    if (w < 2 || (w & 1)) return (int)cudaErrorInvalidValue;
    const int cap = universe_cap(w, keep);
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(&attr, mc_universe_kernel);
    if (rc != cudaSuccess) return (int)rc;
    out[0] = cap;
    out[1] = FC_MIN_BLOCKS;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = cap * BLOCK * (int)sizeof(float);
    return 0;
}

// Pass 1: the n_rows symbol rows at ``rows`` (device memory; one for a single
// configuration) at an even W >= 2, one per blockIdx.y, keeping a path's
// first sine halves in shared memory (universe_cap) unless ``keep`` is 0;
// ext null in Philox mode; partial rows [symbol][CTA].  Returns
// cudaGetLastError().
int qmmx_mc_universe(const McArgs* rows, int n_rows, int num_bars, int keep, const float* ext,
                     long long* part_counts, float* part_floats, int ctas, void* stream) {
    if (n_rows < 1 || n_rows > 65535 || num_bars < 2 || (num_bars & 1))
        return (int)cudaErrorInvalidValue;
    const int cap = universe_cap(num_bars, keep);
    const int smem = cap * BLOCK * (int)sizeof(float);
    mc_universe_kernel<<<dim3(ctas, n_rows), BLOCK, smem, (cudaStream_t)stream>>>(
        rows, cap, ext, part_counts, part_floats);
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
