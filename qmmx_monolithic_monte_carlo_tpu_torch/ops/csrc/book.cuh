// Pieces of the correlated-book kernels (mc_gated_corr.cu, mc_engine_corr.cu):
// the market factor's draws and mix, the book curve and its fold, and the
// partial rows a CTA adds its paths to.  Included after common.cuh and the
// lifecycle family's header, which define BLOCK, HIST_BINS, BIG and the
// lifecycle histogram range.
#pragma once

// The lifecycle histogram bin of a path's total R.
__device__ __forceinline__ int life_bin(float eq) {
    return min(max((int)((eq - LIFE_HIST_LO) * LIFE_BIN_SCALE), 0), HIST_BINS - 1);
}

// The market rows of a book (ops/draws.MarketLayout): rows 2 t2 and 2 t2 + 1
// of column col, injected (f32[blocks, W, 8, lanes]) or words of Philox with
// counter (col, row / 4, block lo, block hi) on the market key, which every
// symbol shares.
struct MarketDraws {
    const float* ext;
    long long blk;
    int row_len, rows;
    uint32_t seed, stream;

    __device__ float2 pair(int col, int t2) const {
        const int r = 2 * t2;
        if (ext) {
            const float* q = ext + (blk * rows + r) * (long long)row_len + col;
            return make_float2(q[0], q[row_len]);
        }
        const uint4 w = philox4((uint32_t)col, (uint32_t)(r >> 2), (uint32_t)blk,
                                (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        return (r & 3) ? make_float2(to_uniform(w.z), to_uniform(w.w))
                       : make_float2(to_uniform(w.x), to_uniform(w.y));
    }
};

// The market side of one path of a book while it walks one symbol: the
// market draws, the antithetic mirror (the partner column's normals
// negated), the symbol's loading beta and perp = sqrt(max(0, 1 - beta^2)),
// its weight, and the path's book curve (bar t at curve[t * cstride]).
struct BookPath {
    MarketDraws md;
    int col, partner;
    bool mirror;
    float beta, perp, weight;
    float* curve;
    int cstride;

    // perp as the JAX book computes it: 1 - beta^2 fused, IEEE sqrtf
    static __device__ __forceinline__ float perp_of(float beta) {
        return sqrtf(fmaxf(0.f, fmaf(-beta, beta, 1.0f)));
    }

    // The (cos, sin) market normals of double-bar step t2.
    __device__ __forceinline__ float2 market(int t2) const {
        const float2 u = md.pair(mirror ? partner : col, t2);
        const float rad = sqrtf(-2.0f * logf(u.x));
        float sn, cs;
        sincosf(two_pi() * u.y, &sn, &cs);
        float z0 = rad * cs, z1 = rad * sn;
        if (mirror) { z0 = -z0; z1 = -z1; }
        return make_float2(z0, z1);
    }

    // beta * z_mkt + perp * eps, beta * z_mkt fused into the sum
    __device__ __forceinline__ float mix(float zm, float eps) const {
        return fmaf(beta, zm, perp * eps);
    }

    // bar t's post-bar equity into the book curve, the product fused
    __device__ __forceinline__ void add(int t, float equity) const {
        float* c = curve + (long long)t * cstride;
        *c = fmaf(weight, equity, *c);
    }
};

// The book's final R and drawdown of one path's curve of W bars: the peak
// starts at 0 and tracks the curve over time.
__device__ __forceinline__ float2 book_fold(const float* curve, int cstride, int num_bars) {
    float peak = 0.f, pdd = 0.f;
    for (int t = 0; t < num_bars; ++t) {
        const float c = curve[(long long)t * cstride];
        peak = fmaxf(peak, c);
        pdd = fmaxf(pdd, peak - c);
    }
    return make_float2(curve[(long long)(num_bars - 1) * cstride], pdd);
}

// Adds one path a thread to a partial row of a book kernel (every thread of
// the CTA calls it): the NC count columns cnt, the histogram of the total R
// of entered paths, and the floats [sum_eq, sum_eq2, sum_dd, min_eq, max_eq,
// max_dd] (min and max over entered paths), each reduced as the lifecycle
// kernels reduce a CTA's paths.  The first chunk of a CTA's paths writes the
// row; later chunks add to it, in chunk order.
template <int NC>
__device__ void cta_add_path_row(const int (&cnt)[NC], bool entered, float eq, float dd,
                                 long long* __restrict__ crow, float* __restrict__ frow,
                                 bool first) {
    __shared__ unsigned s_cnt[NC];
    __shared__ unsigned s_hist[HIST_BINS];
    __shared__ float s_red[6][BLOCK / 32];
    __syncthreads();                       // the previous row's readers are done
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK) s_hist[i] = 0u;
    if (threadIdx.x < NC) s_cnt[threadIdx.x] = 0u;
    __syncthreads();
    if (entered) atomicAdd(&s_hist[life_bin(eq)], 1u);
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const unsigned v = warp_count<unsigned>((unsigned)cnt[j]);
        if (wl == 0 && v) atomicAdd(&s_cnt[j], v);
    }
    const float sum_eq = warp_sum(0.f + eq), sum_eq2 = warp_sum(0.f + eq * eq);
    const float sum_dd = warp_sum(0.f + dd);
    const float min_eq = warp_min(entered ? fminf(BIG, eq) : BIG);
    const float max_eq = warp_max(entered ? fmaxf(-BIG, eq) : -BIG);
    const float max_dd = warp_max(fmaxf(0.f, dd));
    if (wl == 0) {
        s_red[0][warp] = sum_eq; s_red[1][warp] = sum_eq2; s_red[2][warp] = sum_dd;
        s_red[3][warp] = min_eq; s_red[4][warp] = max_eq; s_red[5][warp] = max_dd;
    }
    __syncthreads();
    if (threadIdx.x < NC)
        crow[threadIdx.x] = (first ? 0ll : crow[threadIdx.x]) + (long long)s_cnt[threadIdx.x];
    for (int i = threadIdx.x; i < HIST_BINS; i += BLOCK)
        crow[NC + i] = (first ? 0ll : crow[NC + i]) + (long long)s_hist[i];
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, mn = BIG, mx = -BIG, md = 0.f;
        for (int w = 0; w < BLOCK / 32; ++w) {
            s0 += s_red[0][w]; s1 += s_red[1][w]; s2 += s_red[2][w];
            mn = fminf(mn, s_red[3][w]); mx = fmaxf(mx, s_red[4][w]);
            md = fmaxf(md, s_red[5][w]);
        }
        if (first) {
            frow[0] = s0; frow[1] = s1; frow[2] = s2; frow[3] = mn; frow[4] = mx; frow[5] = md;
        } else {
            frow[0] += s0; frow[1] += s1; frow[2] += s2;
            frow[3] = fminf(frow[3], mn); frow[4] = fmaxf(frow[4], mx);
            frow[5] = fmaxf(frow[5], md);
        }
    }
}
