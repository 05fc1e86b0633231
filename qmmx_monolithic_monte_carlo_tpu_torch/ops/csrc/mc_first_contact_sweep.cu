// The first-contact (stop, tp) sweep on Hopper under gbm: each path's bars and
// first contact made once and replayed against every grid row, with the path
// state in registers and every word of a Philox call used.
//
// mc_first_contact_sweep_kernel replaces the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _sweep_kernel (#3, :1978,
// gbm) at every even W: the stop/target grid under common random numbers.
// It replaced mc_sweep_kernel (a row a launch, the sine halves in an unrolled
// register array up to W = 128, past it each pair drawn again); the single
// configuration and the universe are mc_first_contact.cu's
// mc_universe_kernel, which has since taken this design at one row.
//
// What bounds it on the H100: the first-contact walk's transcendentals and
// integer multiplies (Philox4x32-10: 40 a call), plus a compare a row a bar
// after contact.  Bytes: the arguments and a partial row per (row, CTA).
// What the design does about it:
// - The arguments (McArgs, SweepGrid) sit in shared memory, copied once a
//   CTA; no thread keeps a copy of them (mc_sweep_kernel handed a reference
//   to its kernel parameters to a non-inlined bar step, so every thread kept
//   a stack copy).
// - The path state (the log-price sum, entry, level, side, the two row masks)
//   stays in registers across a rolled bar loop with the bar step inlined.
// - The sine halves of the Box-Muller pairs wait in shared memory, [half][CTA
//   thread] floats, thread index fastest: ``cap`` of them a thread (W/2 up to
//   W = 128; 64 KB a CTA at most, so three CTAs fit an SM), and a bar whose
//   pair lies past ``cap`` draws the pair again (sincosf of the same
//   argument gives the same sine).
// - The radius, angle, high and low streams (rows k, W/2 + k, W + t, 2W + t
//   of ops/draws.GbmLayout) each keep their last Philox call's four words
//   (mc_first_contact.cuh's StreamDraw): a
//   path reads each stream in increasing row order, so a group of four rows
//   costs one call, not four.  The tie coin (row 3W, at most once a bar)
//   draws its own call.
// - The rows' sums stay where mc_sweep_kernel kept them: per-thread arrays
//   touched once a path, counts and histogram in shared memory.
//
// Results: the grid (grid_size(num_paths)), the path-to-thread map, the bar
// arithmetic (contact(), the bridge's expressions, -fmad=false), the
// per-thread fold order and the reduction are mc_sweep_kernel's, so row g's
// partial rows [row][CTA] equal mc_sweep_kernel's and the one-row
// mc_universe_kernel launch's at row g's (stop, tp), bit for bit, whatever
// ``cap`` is.  This source is a library of its own, so no other kernel's code
// moves.

#include "mc_first_contact.cuh"

// CTAs an SM for __launch_bounds__: four where a CTA keeps at most
// FC_SWEEP_NARROW_CAP sine halves a thread (four CTAs' shared memory fits an
// SM: 64 registers, faster at W = 40 despite the spills), else three (80
// registers; shared memory holds no fourth CTA, and at W = 390 the spills of
// 64 registers cost more than they gave).  The launch (qmmx_fc_sweep) owns
// this policy; qmmx_fc_sweep_plan reports it to the host.
#define FC_SWEEP_MIN_BLOCKS 3
#define FC_SWEEP_MIN_BLOCKS_NARROW 4
#define FC_SWEEP_NARROW_CAP 45
#define FC_SWEEP_MAX_CAP 64          // sine halves a thread keeps, at most

// The rows of ``grid`` (at most SWEEP_ROWS) under ``args``, the first ``cap``
// sine halves of a path in dynamic shared memory: partial rows [row][CTA].
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
mc_first_contact_sweep_kernel(const McArgs args, const SweepGrid grid, int cap,
                              const float* __restrict__ ext, long long* __restrict__ part_counts,
                              float* __restrict__ part_floats) {
    extern __shared__ float s_sin[];                 // [cap][BLOCK]
    __shared__ McArgs s_a;
    __shared__ SweepGrid s_grid;
    __shared__ unsigned s_counts[SWEEP_ROWS][ROW_COUNTS];
    __shared__ float s_red[SWEEP_ROWS][ROW_FLOATS][BLOCK / 32];
    if (threadIdx.x == 0) { s_a = args; s_grid = grid; }
    for (int i = threadIdx.x; i < SWEEP_ROWS * ROW_COUNTS; i += BLOCK)
        s_counts[i / ROW_COUNTS][i % ROW_COUNTS] = 0u;
    __syncthreads();
    const McArgs& a = s_a;
    const SweepGrid& gr = s_grid;
    const int n = gr.n_rows;
    const int w = a.num_bars, half = w >> 1;
    const float sig2dt = a.sig_dt * a.sig_dt;
    const float two_s2 = 2.0f * sig2dt;
    const unsigned all = (1u << n) - 1u;   // n <= SWEEP_ROWS
    float* const sin_k = s_sin + threadIdx.x;
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
        StreamDraw rad_s{-1, {}}, ang_s{-1, {}}, hi_s{-1, {}}, lo_s{-1, {}};
        SweepState st;
        st.acc = 0.f; st.entry = 0.f; st.lvl = 0.f;
        st.entered = false; st.is_long = false;
        st.done = 0u; st.target_first = 0u;
#pragma unroll 1
        for (int t = 0; t < w && st.done != all; ++t) {
            const int k = t < half ? t : t - half;    // the bar's Box-Muller pair
            float z;
            if (t >= half && k < cap) {
                z = sin_k[k * BLOCK];
            } else {
                const float rad = sqrtf(-2.0f * logf(stream_at(a, ext, blk, lane, k, rad_s)));
                float sn, cs;
                sincosf(two_pi() * stream_at(a, ext, blk, lane, half + k, ang_s), &sn, &cs);
                if (t < half) {
                    if (k < cap) sin_k[k * BLOCK] = rad * sn;
                    z = rad * cs;
                } else {
                    z = rad * sn;
                }
            }
            // the bar (sweep_bar_step's arithmetic): contact before entry ...
            const float incr = a.drift + a.sig_dt * z;
            st.acc = st.acc + incr;
            const float log_close = a.log_s0 + st.acc;
            const float log_open = log_close - incr;
            if (!st.entered) {
                st.entered = contact(a, log_close, log_open, st.entry, st.lvl, st.is_long);
                continue;
            }
            // ... then bridge()'s high and low, and every open row's stop and target
            const float d2 = (log_close - log_open) * (log_close - log_open);
            const float mid = log_open + log_close;
            const float high = expf(0.5f * (mid + sqrtf(
                d2 - two_s2 * logf(stream_at(a, ext, blk, lane, w + t, hi_s)))));
            const float low = expf(0.5f * (mid - sqrtf(
                d2 - two_s2 * logf(stream_at(a, ext, blk, lane, 2 * w + t, lo_s)))));
            int coin = -1;                   // the tie coin, drawn once a bar if needed
            for (int g = 0; g < n; ++g) {
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
                        const Draw draw{ext, blk, a.lanes, a.n_rows, a.seed, a.stream};
                        coin = tie_coin(a, draw, lane, high, low, st.entry) ? 1 : 0;
                    }
                    tf = coin == 1;
                }
                if (tf) st.target_first |= 1u << g;
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
                    const float stop = row_stop(st, gr.stop_pad[g]);
                    const float target = row_target(st, gr.tp_pad[g]);
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
        for (int wp = 0; wp < BLOCK / 32; ++wp) {
            s0 += s_red[g][0][wp]; s1 += s_red[g][1][wp];
            mn = fminf(mn, s_red[g][2][wp]); mx = fmaxf(mx, s_red[g][3][wp]);
        }
        float* row = part_floats + ((long long)g * gridDim.x + blockIdx.x) * ROW_FLOATS;
        row[0] = s0; row[1] = s1; row[2] = mn; row[3] = mx;
    }
}

// The sine halves a thread keeps at an even W: all W/2 up to
// FC_SWEEP_MAX_CAP, none unless ``keep`` (each pair drawn again).
static int sweep_cap(int w, int keep) {
    return keep ? (w / 2 < FC_SWEEP_MAX_CAP ? w / 2 : FC_SWEEP_MAX_CAP) : 0;
}

// The build a launch keeping ``cap`` sine halves a thread takes, and its
// __launch_bounds__ CTAs an SM.
static void sweep_build(int cap, const void** fn, int* min_blocks) {
    const bool narrow = cap <= FC_SWEEP_NARROW_CAP;
    *fn = narrow ? (const void*)mc_first_contact_sweep_kernel<FC_SWEEP_MIN_BLOCKS_NARROW>
                 : (const void*)mc_first_contact_sweep_kernel<FC_SWEEP_MIN_BLOCKS>;
    *min_blocks = narrow ? FC_SWEEP_MIN_BLOCKS_NARROW : FC_SWEEP_MIN_BLOCKS;
}

extern "C" {

// The layouts the host mirrors: 0 McArgs, 1 SweepGrid.
int qmmx_fc_sweep_size(int which) {
    return which == 0 ? (int)sizeof(McArgs) : which == 1 ? (int)sizeof(SweepGrid) : -1;
}

const char* qmmx_fc_sweep_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// What a launch at an even W >= 2 takes (``keep`` as in qmmx_fc_sweep):
// out[0] the sine halves a thread keeps, out[1] its build's CTAs an SM
// (__launch_bounds__), out[2] its static shared memory (bytes, from the
// runtime), out[3] its dynamic shared memory.  Returns a CUDA error code.
int qmmx_fc_sweep_plan(int w, int keep, int* out) {
    if (w < 2 || (w & 1)) return (int)cudaErrorInvalidValue;
    const int cap = sweep_cap(w, keep);
    const void* fn;
    int min_blocks;
    sweep_build(cap, &fn, &min_blocks);
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
    if (rc != cudaSuccess) return (int)rc;
    out[0] = cap;
    out[1] = min_blocks;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = cap * BLOCK * (int)sizeof(float);
    return 0;
}

// Pass 1 of the (stop, tp) rows of ``grid`` (at most SWEEP_ROWS; host
// pointers, as ``a``) at an even W >= 2, keeping a path's first sine halves
// in shared memory (sweep_cap) unless ``keep`` is 0; ext null in Philox
// mode; partial rows [row][CTA].  Every build opts in to its dynamic shared
// memory, which with the static passes the 48 KB a kernel gets without.
// Returns cudaGetLastError().
int qmmx_fc_sweep(const McArgs* a, const SweepGrid* grid, int keep, const float* ext,
                  long long* part_counts, float* part_floats, int ctas, void* stream) {
    const int w = a->num_bars;
    if (grid->n_rows < 1 || grid->n_rows > SWEEP_ROWS || w < 2 || (w & 1))
        return (int)cudaErrorInvalidValue;
    const int cap = sweep_cap(w, keep);
    const int smem = cap * BLOCK * (int)sizeof(float);
    const void* fn;
    int min_blocks;
    sweep_build(cap, &fn, &min_blocks);
    const cudaError_t rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                smem);
    if (rc != cudaSuccess) return (int)rc;
    cudaStream_t s = (cudaStream_t)stream;
    if (min_blocks == FC_SWEEP_MIN_BLOCKS_NARROW)
        mc_first_contact_sweep_kernel<FC_SWEEP_MIN_BLOCKS_NARROW><<<ctas, BLOCK, smem, s>>>(
            *a, *grid, cap, ext, part_counts, part_floats);
    else
        mc_first_contact_sweep_kernel<FC_SWEEP_MIN_BLOCKS><<<ctas, BLOCK, smem, s>>>(
            *a, *grid, cap, ext, part_counts, part_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
