// The recorded-bar and Heston samplers' device code, shared by the sampler
// kernels of the three families (mc_first_contact_samplers.cu,
// mc_gated_samplers.cu, mc_engine_samplers.cu); included after common.cuh.
// The host mirror of SamplerArgs is ops/kernel_args.py:SamplerArgs, and
// ops/samplers.py computes the same float32 values.
//
// Bootstrap: a bar's index is min(floor(u H), H - 1) of its uniform u, in
// float32 as the TPU kernels compute it (exact for H < 2^24, which the host
// checks); a block-bootstrap bar takes its block's start min(floor(u (H -
// L)), H - L - 1), drawn at the block's first bar, plus its offset t - L
// floor(t / L).  The TPU kernels gather a value by a one-hot blend over every
// 128-lane tile of the table (O(H) a value); here one read through the
// read-only cache (__ldg) gathers it: the same value.  The tables are
// [5, H] float32 in device memory (1.97 MB for a year of 1-minute bars,
// resident in the 50 MB L2).
//
// Heston: full-truncation Euler, v+ = max(v, 0), sig_bar = sqrtf(v+ dt).
// Under jit XLA's CPU compiler fuses some of the step's multiply-adds, and
// folds kappa * (theta - v+) * dt into (theta - v+) * (kappa * dt); the JAX
// kernels in interpret mode compute (found bit for bit on jitted copies of
// their expressions; tests/test_torch_samplers.py):
//   shock  = fmaf(rho, z, rho_perp * zq) for rho >= 0, and
//            fmaf(rho_perp, zq, rho * z) for a negative rho
//   v'     = fmaf(xi * sig_bar, shock, fmaf(theta - v+, kappa_dt, v))
//   streamed close (gated, engine): fmaf(sig_bar, z, fmaf(mu - v+/2, dt, log_s))
//   block increment (first contact): fmaf(sig_bar, z, (mu - v+/2) * dt)
// The sources build with -fmad=false, so these fmaf calls are the only fused
// operations.
#pragma once

#define SAMPLER_RESAMPLE 1    // bootstrap; block bootstrap when block_len > 0
#define SAMPLER_HESTON 3

struct SamplerArgs {
    const float* tables;      // [5, H]: logc, logh, logl, logo, volume
    int hist_len, block_len;  // H; L (0: iid)
    float hf, bl;             // H and L as float32
    float v0, theta, xi, rho, rho_perp, mu, dt, kappa_dt;
};

enum { CH_LOGC, CH_LOGH, CH_LOGL, CH_LOGO, CH_VOL };

__device__ __forceinline__ float table_at(const SamplerArgs& s, int ch, float idx) {
    return __ldg(s.tables + (long long)ch * s.hist_len + (int)idx);
}

// The recorded bar of bar t from its index uniform u; ``start`` carries the
// block's start between the bars of a block.  Block bootstrap draws u only
// where a block starts (``needs_draw``).
__device__ __forceinline__ bool needs_draw(const SamplerArgs& s, int t) {
    if (!s.block_len) return true;
    const float tf = (float)t;
    return tf - s.bl * floorf(tf / s.bl) == 0.f;
}

__device__ __forceinline__ float resample_index(const SamplerArgs& s, int t, float u,
                                                float& start) {
    if (!s.block_len) return fminf(floorf(u * s.hf), s.hf - 1.0f);
    const float tf = (float)t;
    const float off = tf - s.bl * floorf(tf / s.bl);
    if (off == 0.f) {
        const float span = s.hf - s.bl;
        start = fminf(floorf(u * span), span - 1.0f);
    }
    return start + off;
}

// One Euler step of the variance from v: returns sig_bar and sets v_pos and
// the next variance (z, zq: the bar's price and variance normals).
__device__ __forceinline__ float heston_step(const SamplerArgs& s, float z, float zq,
                                             float& v, float& v_pos) {
    v_pos = fmaxf(v, 0.f);
    const float sig_bar = sqrtf(v_pos * s.dt);
    const float shock = s.rho >= 0.f ? fmaf(s.rho, z, s.rho_perp * zq)
                                     : fmaf(s.rho_perp, zq, s.rho * z);
    v = fmaf(s.xi * sig_bar, shock, fmaf(s.theta - v_pos, s.kappa_dt, v));
    return sig_bar;
}

// A bar's Box-Muller pair from its radius and angle uniforms.
__device__ __forceinline__ float2 normal_pair(float u1, float u2) {
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(two_pi() * u2, &sn, &cs);
    return make_float2(rad * cs, rad * sn);
}

// Uniforms of one path in the lifecycle layouts (ops/draws.GatedLayout,
// EngineLayout): row r of column col is injected, or word r % 4 of Philox
// with counter (col, r / 4, block lo, block hi); the last call's words are
// kept, so rows read in increasing order cost one call per four rows.
struct RowDraws {
    const float* ext;
    long long blk;
    int col, row_len, u_rows;
    uint32_t seed, stream;
    int group;
    uint4 words;

    __device__ float at(int row) {
        if (ext) return ext[(blk * u_rows + row) * (long long)row_len + col];
        if ((row >> 2) != group) {
            group = row >> 2;
            words = philox4((uint32_t)col, (uint32_t)group, (uint32_t)blk,
                            (uint32_t)((unsigned long long)blk >> 32), seed, stream);
        }
        return to_uniform(word_of(words, row & 3));
    }
};
