// The engine's correlated book on Hopper, warp-specialised as the rows kernel
// (mc_engine_rows.cu): two producer warpgroups make every symbol's bars, two
// consumer warpgroups run every symbol's lifecycle on them and keep the
// book, a path a thread on each side.
//
// mc_engine_book_rows_kernel<KIND> replaces the TPU kernel
// qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py _engine_corr_kernel
// (#12, :2692, entry :2920) under gbm (KIND 0) and its bootstrap,
// block-bootstrap and Heston branches (#12', :332-405 under ``corr``; KIND 1,
// 3) where up to 8 levels and an even W <= 61 (the envelope books,
// mc_engine_wide_corr*.cu, take the rest, and the harvest).  It takes every
// launch that went to mc_engine_corr_kernel (mc_engine_corr.cu) and
// mc_engine_corr_sampler_kernel (mc_engine_corr_samplers.cu); those stay
// built, as the A/B the checks hold this kernel against.
//
// A book of S symbols on one market factor: symbol s's price normal is
// beta_s z_mkt + sqrt(1 - beta_s^2) eps_s (fmaf, book.cuh's BookPath::mix),
// its volume driven by the mixed shock; the book's equity curve a path sums
// w_s times each symbol's post-bar equity.  What held the parents back: one
// thread made a path's bars and ran its lifecycle through called bar steps
// that took the path state by reference (all of it in local memory), drew the
// market pair again for every symbol, and the CTA drained at two barriers a
// symbol to copy its arguments; at 2^20 paths a symbol the 4096 CTAs' curves
// (168 MB) did not stay in the L2.  Here:
//
// * One pipeline through every symbol of a chunk.  The producers make a tile
//   of bars (BookForm: 14 or 8 by sampler) for each of the chunk's 256 paths,
//   symbol after symbol in the parents' order (a tile never spans two
//   symbols), with
//   mc_engine_bars.cuh's make_bars and its draws' hook (BookMix: the market's
//   normals mixed into the price normal before the bar -- and Heston's
//   variance normal -- or, under the bootstraps, the market's joint day-index
//   uniforms), and the rows kernel's bar-only gates (tile_gates) into the
//   stage ring; mbarriers hand the stages to the consumers, who run
//   mc_engine_step.cuh inlined (RowsState in registers, the per-level state in
//   shared memory) and add w_s x equity into the path's curve after every bar
//   (BookPath::add's order).  The producers run up to BOOK_STAGES tiles ahead,
//   from symbol s into s + 1 and into the next chunk.
// * The symbols' arguments in flight: a ring of BOOK_ARG_SLOTS (EngineArgs,
//   SamplerArgs, beta and weight) in shared memory, symbol k of the launch in
//   slot k % BOOK_ARG_SLOTS.  The producers copy a symbol's slot before its
//   first tile, after that tile's stage is free (so the consumers are past
//   every symbol that used the slot) and meet at their own named barrier; the
//   consumers read it once the first tile's stage is full.  No CTA-wide
//   barrier a symbol.
// * A persistent grid: the launch's CTAs (one an SM) take the parents' CTAs
//   (cells) in turn, a cell's paths, chunks and reductions the parents', so
//   the partial rows [S + 1][cell] and the per-path rows [S + 1][path] equal
//   the parents' bit for bit: a symbol's path joins its row a chunk at a time
//   on the consumers' named barrier (cta_add_path_row's order), the book's
//   after the last symbol (book_fold).  The curves and the market cache (below)
//   lie in a device scratch at the resident thread (the L2 holds them: 5.4 MB
//   at W = 40).
// * The market drawn once a chunk: the producers keep each path's market
//   draws of the chunk's first symbol in the scratch and read them back for
//   the others (the values the parents draw again for every symbol).  On the
//   card this beat drawing them for every symbol, and the curves in device
//   memory beat them in shared memory at a shorter tile (PERF.md).
//
// What bounds it on the H100: S times the symbols' bars (gbm: 3 logf, 3 sqrtf,
// 4 expf, 2 sincosf and 2.5 Philox calls a double bar; a recorded bar 3 expf
// and four gathers from a table in the L2; Heston three Box-Muller pairs and
// the variance step) and lifecycles, plus the market pair, counted once a
// path; bytes: the partial rows.  Numerics as every engine kernel:
// -fmad=false, IEEE logf / sqrtf / sincosf / expf, fmaf only where the JAX
// book's XLA fuses, no float atomics; counts reach the rows exactly.  A
// library of its own, so no other engine kernel's code moves.

#include "mc_engine.cuh"
#include "book.cuh"
#include "sampler.cuh"
#include "mc_engine_bars.cuh"
#include "mc_engine_rows.cuh"

#define BOOK_STAGES 2
// each sampler's tile (bars a stage, even) and the registers of a producer
// and of a consumer thread (setmaxnreg; their sum over the CTA within what
// the launch holds, as the rows kernel's): gbm, the bootstraps, Heston, as
// the probes on the card chose them (PERF.md)
#define BOOK_TILE_GBM 14
#define BOOK_TILE_RESAMPLE 8
#define BOOK_TILE_HESTON 14
#define BOOK_PRODUCER_REGS_GBM 80
#define BOOK_CONSUMER_REGS_GBM 176
#define BOOK_PRODUCER_REGS_RESAMPLE 88
#define BOOK_CONSUMER_REGS_RESAMPLE 168
#define BOOK_PRODUCER_REGS_HESTON 88
#define BOOK_CONSUMER_REGS_HESTON 168
#define BOOK_ARG_SLOTS 4          // symbols' arguments in flight (a power of two)
#define BAR_PRODUCERS 2           // the producers' named barrier

// the producers may be BOOK_STAGES tiles, so BOOK_STAGES symbols, ahead
static_assert(BOOK_ARG_SLOTS > BOOK_STAGES, "a slot is free when the producers reuse it");
static_assert((BOOK_ARG_SLOTS & (BOOK_ARG_SLOTS - 1)) == 0, "slots a power of two");

// Sampler KIND's form: its tile and register split.
template <int KIND>
struct BookForm {
    static constexpr int tile = KIND == ENV_GBM ? BOOK_TILE_GBM
                                : KIND == SAMPLER_RESAMPLE ? BOOK_TILE_RESAMPLE : BOOK_TILE_HESTON;
    static constexpr int producer_regs =
        KIND == ENV_GBM ? BOOK_PRODUCER_REGS_GBM
        : KIND == SAMPLER_RESAMPLE ? BOOK_PRODUCER_REGS_RESAMPLE : BOOK_PRODUCER_REGS_HESTON;
    static constexpr int consumer_regs =
        KIND == ENV_GBM ? BOOK_CONSUMER_REGS_GBM
        : KIND == SAMPLER_RESAMPLE ? BOOK_CONSUMER_REGS_RESAMPLE : BOOK_CONSUMER_REGS_HESTON;
    static_assert(tile % 2 == 0, "a tile holds whole double bars");
};

// A stage's full and empty mbarriers (mc_engine_rows.cuh's RowsBarriers at
// BOOK_STAGES).
struct BookBarriers {
    unsigned long long full[BOOK_STAGES], empty[BOOK_STAGES];
};

// A symbol's arguments, in a slot of the ring.
struct BookSlot {
    EngineArgs a;
    SamplerArgs s;
    float2 bw;                    // (beta, weight)
};

// A CTA's dynamic shared memory at TILE bars a stage: the rows kernel's
// (mc_engine_rows.cu's RowsSmem).
template <int TILE>
struct BookSmem {
    static constexpr int bars = BOOK_STAGES * TILE * ROWS_PLANES * BLOCK;  // floats
    static constexpr int gate_vol = bars;                             // [GATE_RING][BLOCK]
    static constexpr int vol = gate_vol + GATE_RING * BLOCK;          // [VOL_RING][BLOCK]
    static constexpr int close = vol + VOL_RING * BLOCK;              // [CLOSE_RING][BLOCK]
    static constexpr int tmcb = close + CLOSE_RING * BLOCK;           // [2 MAX_LEVELS][BLOCK]
    static constexpr int tmpx = tmcb + 2 * MAX_LEVELS * BLOCK;        // [2 MAX_LEVELS][BLOCK]
    static constexpr int bytes8 = tmpx + 2 * MAX_LEVELS * BLOCK;
    static constexpr int cc = 0;                                      // [MAX_LEVELS][BLOCK]
    static constexpr int skips = MAX_LEVELS * BLOCK;                  // [N_SKIPS][BLOCK]
    static constexpr int size = 4 * bytes8 + (MAX_LEVELS + N_SKIPS) * BLOCK;
};

extern __shared__ __align__(16) unsigned char book_smem[];

// A book launch's pointers and shape (the kernel's one parameter).
struct BookRows {
    const EngineArgs* args;       // [n_sym]
    const SamplerArgs* sargs;     // [n_sym], the samplers only
    const float2* bw;             // [n_sym] (beta, weight)
    const float* ext;             // the symbols' injected uniforms, or null (Philox)
    const float* ext_m;           // the market's, or null (Philox on m_stream)
    float* scratch;               // [book_scratch_floats(W)][gridDim.x * BLOCK]
    long long* part_counts;       // [n_sym + 1, grid, ROW_COUNTS]
    float* part_floats;           // [n_sym + 1, grid, ROW_FLOATS]
    float* per_path;              // [n_sym + 1, num_paths, PATH_COLS], or null
    uint32_t m_stream;            // the market's Philox stream
    int n_sym, grid;              // grid: the cells, the parents' CTAs
};

// A resident thread's scratch floats at W bars: its curve, then its market
// draws of a chunk's first symbol: a gbm pair or a recorded bar's index
// uniform a bar, Heston's two pairs a double bar.
__host__ __device__ __forceinline__ int book_scratch_floats(int num_bars) {
    return 3 * num_bars;
}

__device__ __forceinline__ void producers_sync() {
    asm volatile("bar.sync %0, %1;\n" :: "n"(BAR_PRODUCERS), "n"(BLOCK) : "memory");
}

// ---- the producers

// make_bars' draws' hook in a book (book.cuh's BookPath, the parents' walks):
// the market's draws of the path (md: the antithetic mirror's on its
// partner's column, negated), drawn (``keep``: and kept at ``cache``, a float
// ``cstride`` apart) or read back from ``cache`` (``kept``), mixed into the
// symbol's normals as beta * z_mkt + perp * eps.
template <int KIND>
struct BookMix {
    static constexpr bool mixes = true;
    Draws md;
    float beta, perp;
    bool mirror, keep, kept;
    float* cache;
    int cstride;

    __device__ __forceinline__ float mkt(int j, float drawn) {
        if (keep) cache[j * cstride] = drawn;
        return drawn;
    }

    // gbm: the market's (cos, sin) normals of double bar t2
    __device__ __forceinline__ void gbm(int t2, float& z0, float& z1) {
        float zm0, zm1;
        if (kept) {
            zm0 = cache[(2 * t2) * cstride];
            zm1 = cache[(2 * t2 + 1) * cstride];
        } else {
            const float u0 = md.at(2 * t2), u1 = md.at(2 * t2 + 1);
            const float rad = sqrtf(-2.0f * logf(u0));
            float sn, cs;
            sincosf(two_pi() * u1, &sn, &cs);
            zm0 = rad * cs;
            zm1 = rad * sn;
            if (mirror) { zm0 = -zm0; zm1 = -zm1; }
            zm0 = mkt(2 * t2, zm0);
            zm1 = mkt(2 * t2 + 1, zm1);
        }
        z0 = fmaf(beta, zm0, perp * z0);
        z1 = fmaf(beta, zm1, perp * z1);
    }

    // Heston: the market's price and variance pairs of double bar t2
    __device__ __forceinline__ void heston(int t2, float2& z, float2& q) {
        float2 zm, qm;
        if (kept) {
            zm = make_float2(cache[(4 * t2) * cstride], cache[(4 * t2 + 1) * cstride]);
            qm = make_float2(cache[(4 * t2 + 2) * cstride], cache[(4 * t2 + 3) * cstride]);
        } else {
            zm = normal_pair(md.at(4 * t2), md.at(4 * t2 + 1));
            qm = normal_pair(md.at(4 * t2 + 2), md.at(4 * t2 + 3));
            zm = make_float2(mkt(4 * t2, zm.x), mkt(4 * t2 + 1, zm.y));
            qm = make_float2(mkt(4 * t2 + 2, qm.x), mkt(4 * t2 + 3, qm.y));
        }
        z.x = fmaf(beta, zm.x, perp * z.x);
        z.y = fmaf(beta, zm.y, perp * z.y);
        q.x = fmaf(beta, qm.x, perp * q.x);
        q.y = fmaf(beta, qm.y, perp * q.y);
    }

    // the bootstraps: bar t's index uniform, the market's (joint recorded days)
    __device__ __forceinline__ float index_uniform(const EngineArgs& a, Draws& dr, int t) {
        return kept ? cache[t * cstride] : mkt(t, md.at(t));
    }
};

// Copy symbol ``sym``'s arguments into ``slot`` (the producers together).
template <int KIND>
__device__ __forceinline__ void fill_slot(const BookRows& p, int sym, BookSlot& slot) {
    const int tid = threadIdx.x;
    const int* const a = (const int*)(p.args + sym);
    for (int i = tid; i < (int)(sizeof(EngineArgs) / 4); i += BLOCK) ((int*)&slot.a)[i] = a[i];
    if constexpr (KIND != ENV_GBM) {
        const int* const s = (const int*)(p.sargs + sym);
        for (int i = tid; i < (int)(sizeof(SamplerArgs) / 4); i += BLOCK)
            ((int*)&slot.s)[i] = s[i];
    }
    if (tid == 0) slot.bw = p.bw[sym];
}

// The producer warpgroups: for each of the CTA's cells and its chunks (the
// parents' order), every symbol's tiles of path tid's bars and their
// bar-only gates, a stage at a time.
template <int KIND>
__device__ __forceinline__ void book_produce(const BookRows& p, BookSlot* slots, float* bars,
                                             BookBarriers& rb) {
    constexpr int TILE = BookForm<KIND>::tile;
    using Smem = BookSmem<TILE>;
    const int tid = threadIdx.x;
    const long long num_paths = p.args[0].num_paths;
    const int num_bars = p.args[0].num_bars, lanes = p.args[0].lanes;
    const int row_len = ENGINE_SUB * lanes, half_lanes = lanes >> 1;
    const bool antithetic = KIND == ENV_GBM && p.args[0].antithetic;
    const uint32_t seed = p.args[0].seed;
    const int m_rows = (KIND == SAMPLER_HESTON ? 2 : 1) * num_bars;   // market rows a block
    const GateVols gate_vols{(float*)book_smem + Smem::gate_vol + tid};
    const int cstride = gridDim.x * BLOCK;
    float* const cache = p.scratch + (long long)num_bars * cstride + blockIdx.x * BLOCK + tid;
    int g = 0, k = 0;                            // tiles handed over, symbols begun
    for (int cell = blockIdx.x; cell < p.grid; cell += gridDim.x) {
        for (long long base = (long long)cell * BLOCK; base < num_paths;
             base += (long long)p.grid * BLOCK) {
            const long long q = base + tid;
            const bool live = q < num_paths;
            const long long blk = q / row_len;
            const int col = (int)(q - blk * row_len);
            const bool mirror = antithetic && (col % lanes) >= half_lanes;
            for (int sym = 0; sym < p.n_sym; ++sym, ++k) {
                // the symbol's first stage free: the consumers are past the
                // symbols that had its slot
                if (g >= BOOK_STAGES)
                    mbar_wait(&rb.empty[g % BOOK_STAGES], (g / BOOK_STAGES - 1) & 1);
                BookSlot& slot = slots[k & (BOOK_ARG_SLOTS - 1)];
                fill_slot<KIND>(p, sym, slot);
                producers_sync();
                const EngineArgs& a = slot.a;
                const SamplerArgs& s = slot.s;
                const float* const ext = p.ext ? p.ext + a.ext_offset : nullptr;
                BookMix<KIND> mix{Draws{p.ext_m, blk, mirror ? col - half_lanes : col, row_len,
                                        m_rows, seed, p.m_stream, -1, make_uint4(0u, 0u, 0u, 0u)},
                                  slot.bw.x, BookPath::perp_of(slot.bw.x), mirror,
                                  sym == 0, sym > 0, cache, cstride};
                float log_s = a.log_s0;
                float carry = KIND == SAMPLER_HESTON ? s.v0 : 0.f;
                int group = -1;                  // the draws' last Philox call, across tiles
                uint4 words = make_uint4(0u, 0u, 0u, 0u);
                GateState gs{expf(a.log_s0), 0};
                for (int t0 = 0; t0 < num_bars; t0 += TILE, ++g) {
                    const int stage = g % BOOK_STAGES;
                    if (t0 > 0 && g >= BOOK_STAGES)
                        mbar_wait(&rb.empty[stage], (g / BOOK_STAGES - 1) & 1);
                    float* const out = bars + stage * (TILE * ROWS_PLANES * BLOCK) + tid;
                    const int t1 = min(t0 + TILE, num_bars);
                    if (live) {
                        Draws dr{ext, blk, col, row_len, a.u_rows, a.seed, a.stream, group, words};
                        make_bars<KIND, true>(a, s, dr, log_s, carry, t0, t1, out,
                                              ROWS_PLANES * BLOCK, BLOCK, mix);
                        group = dr.group;
                        words = dr.words;
                        tile_gates(a, gs, gate_vols, t0, t1, out);
                    }
                    mbar_arrive(&rb.full[stage]);
                }
            }
        }
    }
}

// ---- the consumers

// The tie coin's row of bar t in a book symbol's layout (ops/draws
// EngineLayout(book=True)): the bootstraps draw their index uniforms from
// the market, so their ties sit on the symbol's rows 0, 1 of a pair; gbm's
// and Heston's rows are the single run's.
template <int KIND>
__device__ __forceinline__ int book_tie_row_of(int t, int stride) {
    if constexpr (KIND == SAMPLER_RESAMPLE) return (t >> 1) * stride + (t & 1);
    return tie_row_of<KIND>(t, stride);
}

// Bar t of a book symbol's lifecycle on the tile's bar at ``bar`` (the rows
// kernel's replay_bar at the book's tie row).
template <int KIND>
__device__ __forceinline__ void book_replay_bar(const EngineArgs& a, RowsState& st,
                                                const RowDraw& dr, const Rings& rg,
                                                const RowsLevels& lvs, int t, const float* bar) {
    const float c = bar[0], h = bar[BLOCK], l = bar[2 * BLOCK], v = bar[3 * BLOCK];
    const unsigned bar_flags = __float_as_uint(bar[4 * BLOCK]);
    const int tie_row = book_tie_row_of<KIND>(t, a.stride);
    const int noise_row = noise_row_of<KIND>(t, a.stride);
#include "mc_engine_step.cuh"
}

// Warpgroups 2-3: thread tid (the parents' thread) walks the paths of the
// CTA's cells through every symbol, a tile of bars at a time; each symbol's
// path joins its partial row, the path's book the book's.
template <int KIND>
__device__ __forceinline__ void book_consume(const BookRows& p, const BookSlot* slots,
                                             const float* bars, BookBarriers& rb) {
    constexpr int NC = N_COUNTS + N_SKIPS;
    constexpr int TILE = BookForm<KIND>::tile;
    using Smem = BookSmem<TILE>;
    const int tid = threadIdx.x - BLOCK;
    float* const f = (float*)book_smem;
    const Rings rg{f + Smem::vol + tid, f + Smem::close + tid};
    unsigned char* const b8 = book_smem + 4 * Smem::bytes8;
    const RowsLevels lvs{b8 + Smem::cc + tid, (unsigned*)(f + Smem::tmcb) + tid,
                         f + Smem::tmpx + tid};
    const SlotBytes skips{b8 + Smem::skips + tid};
    const long long num_paths = p.args[0].num_paths;
    const int num_bars = p.args[0].num_bars;
    // this thread's book curve: bar t at curve[t * cstride]
    const int cstride = gridDim.x * BLOCK;
    float* const curve = p.scratch + blockIdx.x * BLOCK + tid;
    int g = 0, k = 0;                            // tiles taken, symbols begun
    for (int cell = blockIdx.x; cell < p.grid; cell += gridDim.x) {
        int chunk = 0;
        for (long long base = (long long)cell * BLOCK; base < num_paths;
             base += (long long)p.grid * BLOCK, ++chunk) {
            const long long q = base + tid;
            const bool live = q < num_paths;
            for (int t = 0; t < num_bars; ++t) curve[t * cstride] = 0.f;
            int b_trades = 0, b_wins = 0, b_losses = 0, b_open = 0;
            for (int sym = 0; sym < p.n_sym; ++sym, ++k) {
                // the symbol's first stage full: its arguments are in their slot
                mbar_wait(&rb.full[g % BOOK_STAGES], (g / BOOK_STAGES) & 1);
                const BookSlot& slot = slots[k & (BOOK_ARG_SLOTS - 1)];
                const EngineArgs& a = slot.a;
                const float weight = slot.bw.y;
                const RowDraw dr{a, p.ext ? p.ext + a.ext_offset : nullptr, q};
                RowsState st;
                st.prev_c = expf(a.log_s0);
                st.entry = st.stop = st.target = st.risk0 = 0.f;
                st.equity = st.peak = st.dd = 0.f;
                st.run_low = INF_F; st.run_high = -INF_F;
                st.box_low = st.box_high = 0.f;
                st.side = st.last_dir = st.trades = st.wins = st.losses = st.escal = 0;
                st.cooldown_until = -(1 << 30);
                st.box_valid = st.regime = st.inside_cnt = 0;
                st.c_latch = 0u;
                st.tm_has = 0u;
#pragma unroll
                for (int j = 0; j < 2 * TAP_SLOTS; ++j) {
                    st.tap_ts[j] = TAP_NEVER;
                    st.tap_ratio[j] = 0.f;
                }
                st.skips = skips;
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) skips[j] = 0;
#pragma unroll
                for (int i = 0; i < MAX_LEVELS; ++i) C_COUNT(i) = 0;
#pragma unroll
                for (int j = 0; j < VOL_RING; ++j) rg.vol[j * BLOCK] = 0.f;
#pragma unroll
                for (int j = 0; j < CLOSE_RING; ++j) rg.close[j * BLOCK] = 0.f;
                for (int t0 = 0; t0 < num_bars; t0 += TILE, ++g) {
                    const int stage = g % BOOK_STAGES;
                    if (t0 > 0) mbar_wait(&rb.full[stage], (g / BOOK_STAGES) & 1);
                    if (live) {
                        const float* const tile =
                            bars + stage * (TILE * ROWS_PLANES * BLOCK) + tid;
                        const int t1 = min(t0 + TILE, num_bars);
#pragma unroll 1
                        for (int t = t0; t < t1; ++t) {
                            float* const c = curve + t * cstride;
                            const float c0 = *c;                     // read ahead of the step
                            book_replay_bar<KIND>(a, st, dr, rg, lvs, t,
                                                  tile + (t - t0) * (ROWS_PLANES * BLOCK));
                            *c = fmaf(weight, st.equity, c0);        // BookPath::add
                        }
                    }
                    mbar_arrive(&rb.empty[stage]);
                }
                const bool entered = st.trades > 0;
                const int open = st.side != 0;
                b_trades += st.trades; b_wins += st.wins; b_losses += st.losses;
                b_open |= open;
                int cnt[NC] = {live ? 1 : 0, entered, st.wins, st.losses, open, st.trades,
                               st.escal};
#pragma unroll
                for (int j = 0; j < N_SKIPS; ++j) cnt[N_COUNTS + j] = skips[j];
                const long long seg = (long long)sym * p.grid + cell;
                rows_add_path_row(cnt, entered, st.equity, st.dd, p.part_counts + seg * ROW_COUNTS,
                                  p.part_floats + seg * ROW_FLOATS, chunk == 0);
                if (p.per_path && live) {
                    float* o = p.per_path + ((long long)sym * num_paths + q) * PATH_COLS;
                    o[0] = st.equity; o[1] = (float)st.trades; o[2] = (float)st.wins;
                    o[3] = (float)st.losses; o[4] = (float)open; o[5] = st.dd;
                    o[6] = (float)st.escal;
#pragma unroll
                    for (int j = 0; j < N_SKIPS; ++j) o[7 + j] = (float)skips[j];
                }
            }
            const float2 fin = book_fold(curve, cstride, num_bars);   // (final R, drawdown)
            const bool entered = b_trades > 0;
            const int cnt[NC] = {live ? 1 : 0, entered, b_wins, b_losses, b_open, b_trades};
            const long long seg = (long long)p.n_sym * p.grid + cell;
            rows_add_path_row(cnt, entered, fin.x, fin.y, p.part_counts + seg * ROW_COUNTS,
                              p.part_floats + seg * ROW_FLOATS, chunk == 0);
            if (p.per_path && live) {
                float* o = p.per_path + ((long long)p.n_sym * num_paths + q) * PATH_COLS;
                o[0] = fin.x; o[1] = (float)b_trades; o[2] = (float)b_wins;
                o[3] = (float)b_losses; o[4] = (float)b_open; o[5] = fin.y;
#pragma unroll
                for (int j = 6; j < PATH_COLS; ++j) o[j] = 0.f;
            }
        }
    }
}

// The book: the launch's CTAs take the cells blockIdx.x, + gridDim.x, ...
template <int KIND>
__global__ void __launch_bounds__(ROWS_THREADS, ROWS_MIN_BLOCKS)
mc_engine_book_rows_kernel(const BookRows p) {
    __shared__ BookSlot s_slots[BOOK_ARG_SLOTS];
    __shared__ BookBarriers s_rb;
    if (threadIdx.x == 0) {
        for (int k = 0; k < BOOK_STAGES; ++k) {
            mbar_init(&s_rb.full[k], BLOCK);
            mbar_init(&s_rb.empty[k], BLOCK);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    float* const bars = (float*)book_smem;
    if (threadIdx.x < BLOCK) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(BookForm<KIND>::producer_regs));
        book_produce<KIND>(p, s_slots, bars, s_rb);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(BookForm<KIND>::consumer_regs));
        book_consume<KIND>(p, s_slots, bars, s_rb);
    }
}

// Call f(kernel, form) with the kernel of sampler ``kind`` and its BookForm;
// returns f's value, or cudaErrorInvalidValue for an unknown kind.
template <class F>
static int with_book_kernel(int kind, F&& f) {
    if (kind == ENV_GBM) return f(mc_engine_book_rows_kernel<ENV_GBM>, BookForm<ENV_GBM>());
    if (kind == SAMPLER_RESAMPLE)
        return f(mc_engine_book_rows_kernel<SAMPLER_RESAMPLE>, BookForm<SAMPLER_RESAMPLE>());
    if (kind == SAMPLER_HESTON)
        return f(mc_engine_book_rows_kernel<SAMPLER_HESTON>, BookForm<SAMPLER_HESTON>());
    return (int)cudaErrorInvalidValue;
}

extern "C" {

// 0 EngineArgs, 1 SamplerArgs (bytes, for the host's layouts).
int qmmx_engine_book_rows_size(int which) {
    switch (which) {
        case 0: return (int)sizeof(EngineArgs);
        case 1: return (int)sizeof(SamplerArgs);
        default: return -1;
    }
}

// A resident thread's scratch floats at ``num_bars`` (book_scratch_floats).
int qmmx_engine_book_rows_scratch(int num_bars) { return book_scratch_floats(num_bars); }

// The book under sampler ``kind`` (0 gbm, SAMPLER_RESAMPLE, SAMPLER_HESTON):
// n_sym argument rows at ``args``, sampler rows at ``sargs`` (the samplers)
// and (beta, weight) pairs at ``bw`` (device memory); ext / ext_m (the
// injected symbol and market rows) and per_path may be null.  ``grid`` is the
// parents' CTA count (the cells of the partial rows [n_sym + 1][grid]); the
// launch runs at most ``scratch_ctas`` CTAs (the scratch holds
// qmmx_engine_book_rows_scratch(num_bars) floats for each of their threads).
// Refuses a launch whose registers at launch cannot hold what setmaxnreg
// gives the warpgroups.  Returns the first CUDA error.
int qmmx_mc_engine_book_rows(const EngineArgs* args, const SamplerArgs* sargs, const float2* bw,
                             int n_sym, int kind, int max_levels, int num_bars,
                             const float* ext, const float* ext_m, unsigned m_stream,
                             float* scratch, int scratch_ctas, long long* part_counts,
                             float* part_floats, float* per_path, int grid, void* stream) {
    if (max_levels > MAX_LEVELS || num_bars > 61 || (num_bars & 1) || num_bars < 2
        || n_sym < 1 || grid < 1 || scratch_ctas < 1 || !scratch
        || (kind != 0 && !sargs))
        return (int)cudaErrorInvalidValue;
    const BookRows p{args, sargs, bw, ext, ext_m, scratch, part_counts, part_floats, per_path,
                     m_stream, n_sym, grid};
    return with_book_kernel(kind, [&](auto kernel, auto form) {
        using Form = decltype(form);
        constexpr int smem = BookSmem<Form::tile>::size;
        cudaFuncAttributes fa;
        cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
        if (e != cudaSuccess) return (int)e;
        if (BLOCK * (Form::producer_regs + Form::consumer_regs) > ROWS_THREADS * fa.numRegs)
            return (int)cudaErrorInvalidConfiguration;
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
        int per_sm = 0, dev = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROWS_THREADS,
                                                          (size_t)smem);
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        int ctas = sms * per_sm;
        if (grid < ctas) ctas = grid;
        if (scratch_ctas < ctas) ctas = scratch_ctas;
        kernel<<<ctas, ROWS_THREADS, smem, (cudaStream_t)stream>>>(p);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
