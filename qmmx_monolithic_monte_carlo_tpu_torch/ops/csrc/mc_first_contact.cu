// First-contact Monte Carlo on Hopper: generate GBM bars, find the first
// level contact, replay stop/target, reduce to PathStats rows.
//
// Replaces the TPU kernel qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py
// _mc_kernel (gbm sampler, with and without execution noise, antithetic).
// The Pallas kernel works on (W, 8192) tiles in VMEM and takes the log-price
// cumsum as a W x W triangular matmul on the MXU; a CUDA thread instead walks
// ONE path's bars in a register loop with a running float32 sum.
//
// What bounds it on the H100: transcendentals, not bytes.  Per path of W bars
// it evaluates up to 2.5W logf, 2.5W sqrtf, W/2 sincosf and 4W expf, plus one
// Philox4x32-10 call (10 rounds of two 32-bit multiply-high/low pairs) for
// each of the 3W+1 uniforms it draws.  Bytes are negligible: a path reads
// nothing unless uniforms are injected, and a CTA writes one partial row.
// What the design does about it: one thread per path, so no transcendental is
// spent on a bar the path does not need -- bridge highs/lows (u3/u4) are drawn
// and evaluated only after contact, and the walk stops at the first stop or
// target hit.  The W/2 sine halves of the paired Box-Muller normals wait in
// registers (MAXHALF-unrolled loops, W/2 <= 64) for bars W/2..W-1; the bar
// step and the Philox call are functions, not inlined, so the unrolled loops
// stay small.  Past W/2 = 64 the same kernels come from
// mc_first_contact_long.cu, which draws a pair again for its sine half.
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
// the thread to the final int64 totals.
//
// The gbm sweep (#3, pallas_mc.py _sweep_kernel) is mc_first_contact_sweep.cu.
//
// mc_universe_kernel replaces the TPU kernel pallas_mc.py _universe_kernel:
// the first-contact replay for S symbols in one launch, each with its own
// levels, spot, volatility, paddings and proximity, and its host-f64 drift,
// sig_dt and log_s0.  What bounds it is what bounds one configuration, S
// times.  Design: a grid of (CTAs x S), blockIdx.y the symbol; a CTA copies
// its symbol's McArgs (packed on the host, the symbol's Philox key
// stream + 256 * symbol among them) into shared memory once and runs the
// per-path loop (first_contact_block, bar_step) on that copy, so no thread
// keeps a copy of the struct in its stack frame.  The single configuration
// (_mc_kernel's counterpart) is the same kernel at one symbol: a kernel that
// hands the called bar step a reference to its kernel parameter keeps a
// stack copy of the struct in every thread (it cost the gated and engine
// kernels 28% of their time on the H100).  Symbol s's
// partial rows ([symbol][CTA]) equal its one-symbol launch's bit for bit;
// injected uniforms [S, blocks, rows, lanes] are reached through the
// symbol's ext_offset.
//
// The kernels' text is mc_first_contact_kernels.cuh, which the long-horizon
// build (mc_first_contact_long.cu) shares.  The bootstrap, block-bootstrap
// and Heston kernels (mc_first_contact_samplers.cu) share this file's device
// code through mc_first_contact.cuh.

#include "mc_first_contact.cuh"
#include "mc_first_contact_kernels.cuh"

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

extern "C" {

int qmmx_mc_args_size(void) { return (int)sizeof(McArgs); }

const char* qmmx_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Pass 1: the n_rows symbol rows at ``rows`` (device memory; one for a single
// configuration), one per blockIdx.y, partial rows [symbol][CTA].  ext may be
// null (Philox mode).  Returns cudaGetLastError().
int qmmx_mc_universe(const McArgs* rows, int n_rows, int num_bars, const float* ext,
                     long long* part_counts, float* part_floats, int ctas, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows < 1 || n_rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(ctas, n_rows);
    const int half = num_bars / 2;
    if (half <= 20) {
        mc_universe_kernel<20><<<grid, BLOCK, 0, s>>>(rows, ext, part_counts, part_floats);
    } else if (half <= 64) {
        mc_universe_kernel<64><<<grid, BLOCK, 0, s>>>(rows, ext, part_counts, part_floats);
    } else {
        return (int)cudaErrorInvalidValue;
    }
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
