// Pieces shared by the port's CUDA kernels: the Philox4x32-10 generator,
// the uniform conversion of utils/prng.py, warp-shuffle reductions, and the
// row fold of the lifecycle kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float two_pi() { return (float)6.283185307179586; }

// Philox4x32-10 (Salmon et al., SC'11); utils/prng.py computes the same bits.
// Not inlined: one copy serves every draw site of a kernel, which keeps the
// kernels' code within the instruction cache (and nvcc quick).
__device__ __noinline__ uint4 philox4(uint32_t c0, uint32_t c1, uint32_t c2,
                                      uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
        c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    }
    return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int k) {
    return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// A 32-bit word -> a uniform in (0, 1): the top 24 bits times 2^-24, plus
// 1e-12 (utils/prng.to_uniform), two roundings under -fmad=false.
__device__ __forceinline__ float to_uniform(uint32_t bits) {
    return (float)(bits >> 8) * 5.9604644775390625e-08f + 1e-12f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_count(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Second pass of the lifecycle kernels (gated, engine): fold the partial rows
// in row order, one CTA of 256 threads for each segment of ``rows`` rows (one
// segment for a single run, one per grid row for a sweep).  Thread t owns
// count column t; threads 0-5 own the float columns [sum_eq, sum_eq2, sum_dd,
// min_eq, max_eq, max_dd] and accumulate them in float64 (sums, then min,
// max, max; the empty min/max sentinel is the kernels' +-3.4e38).
template <int ROW_COUNTS>
__global__ void __launch_bounds__(256)
fold_lifecycle_rows(const long long* __restrict__ part_counts,
                    const float* __restrict__ part_floats, int rows,
                    long long* __restrict__ tot_counts, double* __restrict__ tot_floats) {
    part_counts += (long long)blockIdx.x * rows * ROW_COUNTS;
    part_floats += (long long)blockIdx.x * rows * 6;
    tot_counts += (long long)blockIdx.x * ROW_COUNTS;
    tot_floats += (long long)blockIdx.x * 6;
    for (int col = threadIdx.x; col < ROW_COUNTS; col += blockDim.x) {
        long long s = 0;
        for (int r = 0; r < rows; ++r) s += part_counts[(long long)r * ROW_COUNTS + col];
        tot_counts[col] = s;
    }
    if (threadIdx.x < 6) {
        const int col = threadIdx.x;
        const double big = (double)3.4e38f;
        double acc = col == 3 ? big : col == 4 ? -big : 0.0;
        for (int r = 0; r < rows; ++r) {
            const double v = (double)part_floats[(long long)r * 6 + col];
            acc = col < 3 ? acc + v : col == 3 ? fmin(acc, v) : fmax(acc, v);
        }
        tot_floats[col] = acc;
    }
}
