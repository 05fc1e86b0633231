// First-contact Monte Carlo on Hopper past 128 bars: the gbm kernel of
// mc_first_contact.cu (mc_universe_kernel, one symbol for a single
// configuration or a row a symbol) at any even horizon W.
//
// Replaces the branch W > 128 of the TPU kernels
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py _mc_kernel (#1, any even
// W: :724-738) and _universe_kernel (#2), which mc_first_contact.cu does not
// take: it keeps the W/2 sine halves of the
// Box-Muller pairs in registers for bars W/2..W-1, at most 64 of them.
//
// Design: the same kernels' text (mc_first_contact_kernels.cuh) with
// FIRST_CONTACT_LONG defined, so the walk keeps no sine halves: bar t < W/2
// takes the cosine half of pair t, bar t >= W/2 the sine half of pair
// t - W/2, its two uniforms drawn again (Philox is counter-based; an injected
// uniform is read again) and sincosf of the same argument taken again.  Every
// path therefore equals the register kernels' bit for bit where both fit,
// antithetic lanes included.  The fold is mc_first_contact.cu's.
//
// What bounds it on the H100: the register kernels' transcendentals and
// Philox calls, plus for each bar walked past W/2 one more logf, sqrtf and
// sincosf and two more uniforms.  Bytes stay negligible.  This source is a
// library of its own, so mc_first_contact.cu's kernels keep their code.

#define FIRST_CONTACT_LONG
#include "mc_first_contact.cuh"
#include "mc_first_contact_kernels.cuh"

extern "C" {

// Pass 1 of the n_rows symbol rows at ``rows`` (device memory) at any even
// W, one per blockIdx.y: partial rows [symbol][CTA].  Returns
// cudaGetLastError().
int qmmx_mc_universe_long(const McArgs* rows, int n_rows, int num_bars, const float* ext,
                          long long* part_counts, float* part_floats, int ctas, void* stream) {
    if (n_rows < 1 || n_rows > 65535 || num_bars < 2 || (num_bars & 1))
        return (int)cudaErrorInvalidValue;
    mc_universe_kernel<0><<<dim3(ctas, n_rows), BLOCK, 0, (cudaStream_t)stream>>>(
        rows, ext, part_counts, part_floats);
    return (int)cudaGetLastError();
}

}  // extern "C"
