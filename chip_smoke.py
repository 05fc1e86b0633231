#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qmmx_monolithic_monte_carlo_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — require CUDA; print the nvidia-smi name and power limit; TF32 off;
2. build  — compile the CUDA kernels from ops/csrc/ into build/kernels/, one
   nvcc per source, all started together;
   first contact (kernel #1, ops/csrc/mc_first_contact.cu):
3. injected uniforms — kernel vs plain PyTorch version on the same uniforms
   (W = 40, lanes 8192, 16 blocks; plain, execution noise, antithetic);
4. Philox — kernel vs plain version on the Philox stream at 2^22 paths, and
   the row-reduction kernel vs its plain version on the kernel's rows;
   kernel and plain timed at 2^24 paths;
5. main path — the port CLI's ``paths --backend cuda`` at the benchmark's
   size (2^28 paths x 40 bars, sigma 0.3), launch counts set to 0 just
   before and read just after, the output checked, paths/s timed;
   gated lifecycle (kernel #4, ops/csrc/mc_gated.cu):
6. injected uniforms — kernel on the card vs plain version on CPU copies,
   path by path (W = 40, lanes 1024, 8 blocks of 8 x 1024 = 65536 paths;
   engine defaults, multi-trade, tight gates, execution noise, antithetic);
   every path that differs is traced bar by bar: the plain lifecycle over
   the card's bars must equal the kernel's row exactly, and over the CPU's
   bars must part from it at a bar where a decision flips;
7. Philox — kernel vs plain version, both on the card, path by path at 2^22
   paths with and without noise; the row fold vs its plain fold; kernel and
   plain timed at 2^24 paths;
8. main path — the port CLI's ``paths --gated --backend cuda`` at 2^28 paths
   x 40 bars, launch counts set to 0 just before and read just after, the
   output checked, paths/s timed; the kernel alone timed at 2^28;
   full 12-gate engine (kernel #8, ops/csrc/mc_engine_rows.cu: two producer
   warpgroups make the bars, two consumer warpgroups run the lifecycle):
9. injected uniforms — kernel on the card vs plain version on CPU copies,
   path by path (W = 40, 8 blocks of 8 x 256 = 16384 paths, levels 100.0 /
   100.4 / 99.6; engine defaults, accumulation gates active, ML and policy
   gates armed, the same with a policy that lets entries through and with the
   blended gate, execution noise, antithetic); every differing path is traced
   bar by bar as in phase 6 (the card's bars run through the plain engine on
   the card, so its sigmoid is CUDA's too); each case's rows kernel equal to
   the parent it replaced bit for bit, partial rows and per path (the gates
   its producers compute, the policy's among them, armed);
10. Philox — kernel vs plain version, both on the card, path by path at 2^22
   paths with and without noise; the row fold vs its plain fold; the work
   counts for the bound; the rows kernel equal to the parent it replaced
   (mc_engine_sweep_kernel, mc_engine.cu) bit for bit, partial rows and per
   path, with and without noise; kernel, parent and plain timed at 2^22;
11. main path — the port CLI's ``paths --engine --backend cuda`` at 2^28
   paths x 40 bars, launch counts set to 0 just before and read just after
   (``mc_engine_rows`` and its fold once a run, no other kernel), the output
   checked, paths/s timed; the kernel alone and the parent timed at 2^28;
   the common-random-number grid sweeps (kernels #3, #6, #9):
12. first-contact sweep (``mc_first_contact_sweep_kernel``, mc_first_contact_sweep.cu:
   McArgs in shared memory, the path state in registers, a Philox call a
   group of four rows a stream): injected
   uniforms, the CLI's 3 x 3 (stop, tp) grid (BASELINE config #5's three
   rows among them), each row against the plain version on CPU copies;
   Philox at 2^22 on the same 9 rows, each row equal to the single
   configuration's launch bit for bit and within budget of the plain
   version on the card, the fold against its plain fold; config #5 at its
   full size (2^30 paths x 40 bars x 3 rows), kernel alone, timed; the
   port CLI's ``sweep --backend cuda`` at 2^28 paths (the 3 x 3 grid),
   launch counts set to 0 just before and read just after (one sweep launch
   and one fold a run, nothing else), rows and keys in the JAX CLI's order;
13. gated sweep (the gbm kind of ``mc_gated_sampler_sweep_kernel``,
   mc_gated_sampler_sweep.cu: each path's bars made once into a bar store,
   every row replayed over them): injected uniforms
   path by path, 3 rows with a noise-std row, every differing path traced
   as in phase 6; Philox at 2^22, each row equal to the one-row launch of
   ``mc_gated_sweep_kernel`` (``mc_paths_gated_fused``'s) bit for bit, per
   path included, and the plain version on the card equal to the kernel on
   every path; ``PathStats.from_lifecycle`` / ``from_outcomes``
   bins on the card equal to the CPU's; the CLI's ``sweep --gated --backend
   cuda --num-paths 2^26 --touch-limits 2 4`` (18 rows) with its launches;
14. engine sweep (``mc_engine_bar_sweep_kernel``, mc_engine_bar_sweep.cu: each
   path's bars made once into a bar store, every row replayed over them):
   injected uniforms path by path with the four configurations of the JAX
   engine sweep test,
   then with [G] noise stds (level jitter 0 and 0.02, the main path's rows,
   and a slip row), every differing path traced as in phase 9; Philox at
   2^22, each row of both grids equal to the one-row launch
   (``mc_paths_engine_fused``'s: ``mc_engine_rows_kernel`` at one row) bit
   for bit, skip counts included; kernel vs plain on the card path by path
   at 2^20 x both grids; the CLI's ``sweep
   --engine --backend cuda --num-paths 2^24 --jitter-stds 0 0.02`` (18 rows)
   with its launches; the kernel alone at 2^26 paths x 9 rows;
   the per-symbol universes (kernels #2, #5, #10, #11), three symbols with
   their own levels, s0, sigma and [S] knobs (and [S] noise stds for the
   lifecycles), and BASELINE config #4's universe (100 symbols, one blue
   level at s0 = 100 + i, sigma 0.25, 2^20 paths a symbol, 40 bars):
15. first-contact universe (``mc_universe_kernel``, mc_first_contact.cu):
   injected uniforms, each symbol against the plain version on CPU copies;
   Philox at 2^22 a symbol, each symbol equal to its one-symbol launch (the
   single configuration's) at its inputs and key bit for bit and within
   budget of the plain version
   on the card (both timed), the fold against its plain fold; the
   one-symbol universe equal to today's single run; on the main path's
   inputs (config #4's 100 symbols) at 2^16 paths a symbol, each symbol
   within budget of the plain version on the card; ``mc_paths_universe_fused``
   on config #4's universe, warm-up then timed, with its launches;
16. gated universe (``mc_gated_sweep_kernel``, a row per symbol): injected
   uniforms path by path with [S] noise stds, every differing path traced as
   in phase 6; Philox at 2^22 a symbol, each symbol equal to the single
   kernel bit for bit (per path included), the plain version on the card
   equal to the kernel on every path, at three symbols and on symbols 0, 11,
   ..., 99 of config #4's full-width launch at 2^16 paths a symbol (each
   against the single plain version keyed as its symbol);
   ``mc_paths_gated_universe_fused`` on
   config #4's universe with its launches;
17. engine universe (``mc_engine_rows_kernel``, a row per symbol, the sweep
   of universes at one grid row): injected uniforms path by path with [S]
   knobs (proximity, paddings, q_min) and noise stds, every differing path
   traced as in phase 9; Philox, each symbol equal to the single kernel bit
   for bit at 2^22 (and the launch to the parent's), to the plain version on
   the card on every path at
   2^20, and symbols 0, 11, ..., 99 of config #4's full-width launch equal to
   the plain version on the card on every path at 2^16 a symbol; BASELINE
   config #4 through
   ``mc_paths_engine_universe_fused``, one
   warm-up then timed, with its launches; then the per-symbol refresh
   (``universe_policy_refresh``) on run_all.py's [100, 64, 4] float32 shapes
   on the card, timed and held against the float64 fit on the CPU (1e-4);
18. sweep of universes (``mc_engine_rows_kernel``, S x G rows): an [S, G]
   grid ([S, G] stop paddings, [G] q_min and noise stds) on injected
   uniforms path by path, every differing path traced; Philox, cell (s, g)
   equal to the engine universe under row g's knobs bit for bit (and the
   launch to the parent's), the plain
   version on the card equal to the kernel on every path, and so on the
   main path's inputs (config #4's first 8 symbols x the 4 configurations)
   at 2^16 paths a symbol; the entry ``mc_paths_engine_universe_sweep_fused``
   at those 8 symbols x 4 rows x 2^20 paths with its launches;
   the correlated books (kernels #7 and #12: one market factor, z_s =
   beta_s z_mkt + sqrt(1 - beta_s^2) eps_s, and the book's equity curve),
   three symbols with their own levels, s0, sigma, beta, weight, [S] knobs
   and noise stds, and the main path's book (100 symbols, spots 100 .. 199
   with the CLI's level scaffold, sigma 0.3, betas 0.2 .. 0.8, equal
   weights, 2^20 paths a symbol, 40 bars):
19. gated book (``mc_gated_corr_kernel``, mc_gated_corr.cu): injected uniforms
   (8 blocks of 8 x 1024 paths a symbol, antithetic) path by path, symbols
   and the book, every differing path traced as in phase 6 (a book path by
   its symbols' lifecycles over the CPU's and the card's bars, combined as
   the book combines them); Philox at
   2^20 a symbol, every symbol at beta 0 equal to the gated universe kernel
   (#5) bit for bit, per path included, and a one-symbol book of weight 1
   equal to its symbol; on the main path's inputs (a book of its symbols 0,
   11, ..., 99) at 2^16 paths a symbol the plain version on the card equal to the
   kernel on every path, symbols and book; the kernel alone at the main-path size (the curves in shared
   memory), and the fold; the port CLI's ``book
   --backend cuda`` at the main-path size, launch counts set to 0 just
   before and read just after (one ``mc_gated_corr`` and one fold a run,
   nothing else), rows in the JAX CLI's form; the CLI's defaults once;
20. engine book (``mc_engine_book_rows_kernel``, mc_engine_book_rows.cu): the
   same, with the ML and policy gates armed, noise and antithetic in one
   injected case and the accumulation gates active in another, every case
   and the main path's sample equal bit for bit to the parent it replaced
   (``mc_engine_corr_kernel``), the identity against the engine universe
   kernel (#10), the parent timed at the main path's size, and ``book
   --engine --backend cuda``;
   the recorded-bar and Heston samplers of kernels #1, #4 and #8 (bootstrap,
   block bootstrap with ``--block-len 10``, Heston at the JAX defaults), the
   recorded bars a 98,280-bar CSV history (252 sessions of 390 1-minute bars:
   cents-rounded closes, opening gaps, highs and lows beyond open and close,
   nonzero volumes) written from a seed:
21. first contact (``mc_first_contact_sampler_kernel``, mc_first_contact_samplers.cu): for
   each sampler, injected uniforms at 2^16 paths (the gated's at 2^15, the engine's at 2^14;
   and with execution noise
   for bootstrap and Heston), kernel vs plain on CPU copies on totals;
   Philox at 2^22, kernel vs plain on the card, both timed; the kernel
   alone at 2^28 x 40 with its bound; the port CLI's ``paths --backend cuda
   --sampler ...`` at 2^28 paths x 40 bars on the CSV history (bootstrap
   once more on the CLI's default 390-bar fixture), launch counts set to 0
   just before and read just after (the sampler kernel and the fold once a
   run, nothing else), the output checked, paths/s timed;
22. gated (``mc_gated_sampler_kernel``, mc_gated_samplers.cu): the same, path
   by path, every differing injected path traced as in phase 6, and ``paths
   --gated``;
23. engine (``mc_engine_rows_kernel``, mc_engine_rows.cu): the same,
   path by path with its two budgets, every differing injected path traced
   as in phase 9, each sampler's Philox launch equal to the parent's
   (``mc_engine_sampler_kernel``) bit for bit, and ``paths --engine`` (the
   recorded volumes reach the volume gates);
   the samplers of the sweeps and universes, a row axis on the three sampler
   kernels (kernels #2, #3, #5, #6, #9, #10, #11):
24. first contact (``mc_first_contact_sampler_kernel`` with a row a symbol;
   the sweep's grid rows ``mc_first_contact_sampler_sweep_kernel``,
   mc_first_contact_sampler_sweep.cu, each path walked once for every row):
   under bootstrap, block bootstrap and Heston, injected
   uniforms on a 3-symbol universe with its own histories and on the CLI's
   3 x 3 grid, kernel vs plain on CPU copies; Philox at 2^22 a row, every
   universe symbol and sweep row equal to its one-row launch bit for bit, the
   row folds against their plain folds, the plain version on the card;
   BASELINE config #4 (100 symbols x 2^20 x 40, each symbol its own year of
   1-minute bars) through ``mc_paths_universe_fused``, its 100 symbols
   against the plain version on the card at 2^16 paths a symbol, each symbol
   of the full-width launch equal to its one-row launch bit for bit, the
   bootstrap universe against 100 one-symbol launches; ``sweep --backend cuda --sampler
   bootstrap | block_bootstrap --bars-csv`` at 2^28 (3 x 3), Heston through
   ``mc_paths_sweep_fused``; launch counts set to 0 just before each main
   path and read just after (one sampler launch and one fold a run);
25. gated: the same with and without noise ([S] and [G] stds), path by path,
   every differing injected path traced as in phase 6, symbols 0, 11, ...,
   99 of config #4's full-width launch against the plain version on the
   card; the sweep's grid rows through ``mc_gated_sampler_sweep_kernel``
   (mc_gated_sampler_sweep.cu: each path's bars made once for every row);
   ``sweep --gated`` at 2^26 x 18 rows (``--touch-limits 2 4``), one sweep
   launch and one fold a run, each of the 18 rows equal to its one-row
   launch of ``mc_gated_sampler_kernel`` bit for bit;
26. engine: the same with the engine's two budgets, every differing path
   traced as in phase 9, symbols 0, 11, ..., 99 of config #4's full-width
   launch against the plain version on the card (launch-bound a symbol at a
   time) and all 100 of
   the full-width launch against their one-row launches; ``sweep --engine``
   at 2^24 x 18 rows (``--jitter-stds 0 0.02``) through
   ``mc_engine_bar_sweep_kernel`` (mc_engine_bar_sweep.cu), each row equal to
   its one-row launch of ``mc_engine_rows_kernel``; and the sweep of universes
   (config #4's first 8 symbols x 4 configurations at 2^20 a cell), each
   cell equal to its one-row launch at 2^14 (per path) and at 2^20;
   the samplers of the books (kernels #7 and #12 under bootstrap, block
   bootstrap and Heston: the market stream carries the joint recorded day's
   index, or Heston's second market pair), three symbols with their own
   histories (and levels, s0, sigma, beta, weight, knobs), and the main
   path's book on one shared year of 1-minute bars:
27. gated book (``mc_gated_corr_sampler_kernel``, mc_gated_corr_samplers.cu):
   for each sampler, injected uniforms with and without [S] noise stds, path
   by path, symbols and the book, every differing path traced (as in phase
   19); Philox at 2^16 a symbol against the plain version on the card path
   by path; swapping two symbols' histories swaps their rows bit for bit,
   and one shared [1, 5, H] table equals its copies; a book of the main
   path's symbols 0, 11, ..., 99 at 2^16 against the plain version on the card
   path by path; the
   kernel alone at 100 x 2^20; the port CLI's ``book --backend cuda
   --sampler ...`` at 100 x 2^20 x 40 on the CSV history, launch counts set
   to 0 just before and read just after (one sampler launch and one fold a
   run, nothing else);
28. engine book samplers (``mc_engine_book_rows_kernel``,
   mc_engine_book_rows.cu): the same with the engine's two budgets, every
   injected and Philox case equal bit for bit to the parent it replaced
   (``mc_engine_corr_sampler_kernel``), the parent timed at the main path's
   size, the plain version on the card on
   a book of the main path's symbols 0, 11, ..., 99 (launch-bound a symbol at
   a time), and
   ``book --engine``;
   the engine's envelope (the envelope kernels ``mc_engine_wide*.cu``, where
   the parents take at most 8 levels and an even W <= 61), at the reference's
   30-level session shape (``env_ladder``) over a trading day of 390 bars:
29. gbm (``mc_engine_wide_kernel``, mc_engine_wide.cu): injected uniforms,
   kernel vs plain on CPU copies path by path, every differing path traced
   and an agreeing path held to 16 price ulps a trade, at 30 levels x 40
   bars, 64 x 16, 8 x 62, 8 x 63 with noise and antithetic, 3 x 25 and 30 x
   390 (2^13 paths); Philox at 30 x 390 x 2^16, kernel equal to the plain
   version on the card on every path; the envelope kernel forced to run at 3
   levels x 40 bars equal to the parent kernel bit for bit at 2^20, and the
   two timed at phase 11's 2^28 x 40; the sweep's 18 rows (3 x 3 x jitter 0,
   0.02; ``mc_engine_bar_sweep_kernel``) and 8 universe symbols (each its own
   30-level ladder) at 30 x 390 each equal to its one-row launch bit for bit,
   the sweep's jitter row (0.25,
   0.15, 0.02) at 2048 paths equal to the plain version on the card on every
   path; the port CLI's ``paths --engine --backend cuda`` on a 30-level DB at
   390 bars x 2^24 paths and ``sweep --engine`` at 2^20 x 18 rows, launch
   counts set to 0 just before and read just after (the envelope kernel and
   the fold once, nothing else; one timed run, its kernel warm from the
   phase's checks), the kernel alone timed; the envelope kernels' ptxas
   registers, stack and spill, and digests of the main paths' folded int64
   count totals (the skip table, escalations, the harvest's counts) at seed
   7 (the sweep's at seed 5), which do not depend on the CTA size
   (``count_digest``);
30. the samplers and books (``mc_engine_wide_sampler_kernel``,
   ``mc_engine_wide_corr_kernel``): bootstrap, block bootstrap and Heston at
   30 x 390 on a recorded year and at W 25 with noise, injected (CPU copies,
   traced) and Philox (the card, every path); ``paths --engine --sampler``
   at 2^24 x 390; the books under gbm and the three samplers at 10 symbols x
   30 levels x 390 bars x 2^20 a symbol through ``mc_paths_engine_corr_fused``
   (one timed run, its launches), every symbol and the book of its
   symbols 0 and 9 equal to the plain version on the card on every path at
   2^14 a symbol; the book kernels forced at the parent's shape (3 symbols
   x 3 levels x 40 bars x 2^16) equal to the parent book kernels bit for
   bit, per path included;
   the closed-trade label harvest (``harvest=True`` of kernels #8, #10 and
   #12: the envelope kernels' harvest builds ``mc_engine_wide*_harvest.cu``)
   rides on the plain runs above: in phases 9, 17, 20, 29 and 30 the plain
   version runs once with the harvest (which changes no trade) and the
   kernel a second time with it; its partial and per-path rows equal the
   launch without the harvest bit for bit, and its harvest equals the plain
   version's as the differing paths allow (``check_harvest``); every symbol
   of config #4's full-width launch and the 3-symbol universe equals its
   one-row harvest launch bit for bit, the book's symbols at beta 0 the
   universe's; phase 17 also runs config #4 with the harvest (its launches,
   every statistic equal to the run without) and the per-symbol refresh on
   what it harvested (``models/harvest.ml_batch_from_harvest``), phase 20
   ``book --engine --harvest`` (each symbol's labels and refreshed ML gate);
31. the learning flywheel on the card: the port CLI's ``flywheel --rounds 3
   --num-paths 2^28 --explore-paths 2^24 --backend cuda`` (launch counts set
   to 0 just before and read just after; round 0 cold, later rounds armed,
   the exploration merged), ``sim/flywheel.holdout_eval`` at 2^26 training
   paths a round and 2^24 held-out paths on three seed pairs, a round on the
   30-level DB at 390 bars x 2^22 (the windowed guard), the recorded-bar
   flywheel (``policy_iteration`` under block_bootstrap, the sampler harvest
   kernel) and ``book --engine --harvest --sampler block_bootstrap`` at 100 x
   2^20; each harvest kernel timed against the same kernel without the
   harvest in turn; the harvest rows' fold against its plain fold;
32. first contact past 128 bars (``mc_universe_kernel`` keeps at most 24
   sine halves a thread and the gbm sweep 64, and they draw the pairs past
   them again; ``long_phases``): at W =
   390 injected uniforms against the plain version on CPU copies, Philox at
   2^20 (single with noise and antithetic, the 3 x 3 sweep, a 3-symbol
   universe) against the plain version on the card, the same launches
   forced to keep no sine half (``cap = 0``) at W = 40, 90, 92 and 128
   equal to the launches keeping every half they keep (up to 24 for the
   single run and the universe, 64 for the sweep) bit for bit (the gbm sweep,
   ``mc_first_contact_sweep_kernel``, each row also against the one-row
   ``mc_universe_kernel`` keeping every half it keeps; W 90 and 92 the last
   of the sweep's four-CTA build and the first of its three-CTA one), the
   gbm sweep's 18 rows at W = 390 each equal to its one-row launch; the
   port CLI's ``paths --num-bars 390`` (default ``--backend auto``) at 2^28
   and ``sweep --num-bars 390`` at 2^26, config #4's universe at 390 bars
   through ``mc_paths_universe_fused``, launch counts set to 0 just before
   and read just after; the samplers at W = 390 (single, sweep, universe)
   against their plain versions on the card, an 18-row sampler sweep (two
   launches) each row equal to its one-row launch bit for bit, and ``paths
   --sampler ... --num-bars 390`` at 2^28 through the CLI; every kernel
   timed beside its bound.  Flip budgets F = 2 + paths/1024 x ceil(W / 40).

``python3 chip_smoke.py --single-sampler-times [TREE]`` runs none of these: it
times the nine single-configuration sampler launches of the port in TREE
(default: this one) at 2^28 x 40, for a parent unpacked with ``git archive``
against this tree in one call.  ``python3 chip_smoke.py --parent-times``
runs none of them either: it times every parent engine kernel against its
envelope kernel forced to run where the parent fits (``parent_times``), with
their count digests.  ``python3 chip_smoke.py --envelope-times TREE
[--no-guard | --min-blocks G,S[,B]] [--books]`` times the envelope
kernels of the port in TREE at their main paths' shapes, the books included
(``--books``: the books alone; at 100 x 2^20 x 40 the parent book, the book
rows kernel and the envelope book forced in turns), with count
digests and ptxas resources (``envelope_times``), for a parent unpacked with
``git archive`` against this tree in turns (the two options build probes: no
windowed guard, or other ``__launch_bounds__``, B the books').
``python3 chip_smoke.py --fc-rows-digests TREE`` prints the digests of first
contact's gbm partial rows (``fc_rows_cases``) of the port in TREE.
``python3 chip_smoke.py --sampler-sweep-times TREE`` times the first-contact
sampler sweeps of the port in TREE at 9 rows x 2^28 x 40 and 9 x 2^24 x 390,
with count digests and ptxas resources (``sampler_sweep_times``), in turns
with another tree in the same way.
``python3 chip_smoke.py --sweep-times TREE [--engine | --redesign]`` times
the sweeps, first contact's single run and universe and the engine's single
run and universe of the port in TREE at their main paths' shapes
(``sweep_times``; ``--engine``: the engine sweeps alone, ``--redesign``: the
engine's single run at 2^28 x 40 and config #4's engine universe, gbm and
the three samplers, alone), in turns with another tree in the same way.

Harvest (``check_harvest``, ``gap_within``): where every path
agrees the count tables are equal; each path whose trades differ can move
each of its trades to another (bucket, label), so the L1 gap of each count
table is at most 2 a trade of those paths; a sum may move by those trades'
x1 and x6 (each <= 1), an agreeing trade's x1 (a distance to a level) by 16
price ulps (the bars' ulps on CPU copies), and by the reduction orders
(float32 sums of n non-negative terms in two orders: 2 (n - 1) 2^-24 of the
larger).

Tolerances.  First contact (phases 3-4): the kernel sums each path's log
increments serially in float32 and uses CUDA's logf/expf/sincosf, the plain
version PyTorch's; their ulps flip O(1) threshold crossings per 1024 paths.
So: n exact; entered/tp/stop/open within F = 2 + paths/1024; sum_r within
F * max|R|; histogram L1 within 2F; min_r and max_r within 1e-3.
Gated (phases 6-7): the same ulps, and a flipped decision persists within its
path.  So, path by path: at most F paths differ, a path differing when its
(trades, wins, losses, open) differ or its equity or dd moved by more than
1e-3 per trade (a flip can keep the counts and move a trade); 1e-3 per trade
is the drift of paths that agree, because a log-price ulp (4.8e-7 near log
100) moves a price by ~6 price ulps and R = reward / risk (risk >= 0.3)
carries it on.  On totals: n exact; entered within F; histogram L1 within
2F; sums within F * max|equity|.  The row folds: counts exact, float64 sums
within 1e-9 relative.
Engine (phases 9-10): the gated rules, a path's trades also differing when
its escalations differ; besides, a path whose trades agree differs when any
of its 16 per-path skip counts differ (a ulp can move a first-fail reason
from one gate to another and change no trade).  That is a threshold
crossing of its own, at any of the gates a bar reaches, so those paths have
a budget of their own: at most F paths whose trades differ and at most F
whose first-fail reasons alone differ.  Every differing path of an injected
comparison is traced (as in phase 6) before either budget is applied.  Each
skip counter's total within W times the number of differing paths (a path
moves at most one reason a bar, so 0 where no path differs) and
escalations within F.  Past NUM_BARS = 40 bars (phases 29-30) a path meets
its decisions on more bars, and the budgets grow with the horizon: F = 2 +
paths/1024 x ceil(W / 40).
Sweeps (phases 12-14): each row under its family's rules above; a row of a
sweep kernel and the single-configuration launch under that row's knobs:
equal, bit for bit.  Universes (phases 15-18): each symbol (or cell) under
its family's rules; a symbol of a universe kernel and the single kernel at
the symbol's inputs and key: equal, bit for bit.  Books (phases 19-20):
each symbol and the book under their family's rules (the book's row is a
lifecycle row of the book's R per path); a book symbol at beta 0 and the
universe kernel's symbol: equal, bit for bit.  Samplers (phases 21-23):
each family's rules above.  Sampler rows (phases 24-26): each symbol or
grid row under its family's rules; a row of a launch and the one-row launch
of its arguments: equal, bit for bit, per path included.  Book samplers
(phases 27-28): each symbol and the book under their family's rules, and
the sampler rows' ulp rules below; the book's R is sum_s w_s R_s with sum_s
w_s = 1, so the book row counts its ulps in the largest of its symbols' (a
book path that agrees drifts at most 16 of them a book trade).  Their
traces also take a differing path whose two runs never part, when the kernel
equals the plain lifecycle on the card's bars and its counts agree: drift
alone, the bars' ulps carried past 1e-3 a trade by R = reward / risk where
a noisy stop lands near the entry (``drift_only``; such a path still counts
against F).  The sampler
rows' injected
comparisons on CPU copies count drift in price ulps (a float32 ulp of the
row's highest level or spot, over its stop padding, in R): a lifecycle path
that agrees drifts at most 16 a trade (and one more), and a histogram is
held after binning each true edge tie as the kernel bins it: a path whose
two values sit in adjacent bins, each within 8 a trade of the edge between
them (recorded bars on a cent grid put R = 1 on an edge for hundreds of
block-bootstrap paths).  First contact besides must equal the plain version
on the card on the same uniforms exactly, histogram included.

Bounds (``bound_ms``): the larger of the bytes each kernel must move over
3.35 TB/s and its operations over the card's peak rate for their type: float32
operations over 67 TFLOP/s (the H100 SXM's dense float32 peak), and the
issue rates of the special-function unit (logf, expf, sqrtf and division
each take one MUFU operation, 16 per SM per clock) and of 32-bit integer
multiplies (Philox4x32-10: 40 per call, 64 per SM per clock), at the card's
``clocks.max.sm`` and SM count.  A recorded bar's gathered value (log
return, offsets, volume) counts one 32-byte sector: against device memory's
rate once the tables outgrow the 50 MB L2, and only listed
(``gather_bytes``) while they fit there, since the card's table above gives
no L2 rate.  Heston counts its second Box-Muller pair and a sqrtf a bar.
The work depends on the data (where paths
enter, how long they hold), so it is counted by the plain versions on the
first 2^22 paths of the timed inputs (the universes' main paths: 2^16 paths
of each symbol) and scaled to their size.  For the
engine the count is a floor: the work every bar does, plus the gates that the
plain version's skip table shows were reached (engine_ops).  A book's bound
is its symbols' lifecycles plus the market pair, counted once a path
(book_market_ops; under the samplers book_sampler_market_ops), though the
kernels draw it again for every symbol.  A sweep's bound
counts each path's bars once and each row's decisions on them (sweep_ops,
gated_sweep_ops, engine_sweep_ops), so the gated and engine sweeps'
regeneration of the bars for every row shows against it.

The line before last is a JSON object of the kernels (route, source, the TPU
kernel each replaces, launches in its main-path run, max error, times and
bounds); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

NUM_BARS = 40
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
MAIN_PATHS = 1 << 28
PHILOX_PATHS = 1 << 22
PLAIN_PATHS = 1 << 24
LANES = 8192
GATED_LANES = 1024
GATED_INJECT_BLOCKS = 8
CSRC = "qmmx_monolithic_monte_carlo_tpu_torch/ops/csrc/"
FC_SOURCE = CSRC + "mc_first_contact.cu"
FC_SWEEP_SOURCE = CSRC + "mc_first_contact_sweep.cu"
GATED_SOURCE = CSRC + "mc_gated.cu"
GATED_SWEEP_SOURCE = CSRC + "mc_gated_sampler_sweep.cu"
ENGINE_SOURCE = CSRC + "mc_engine.cu"
ENGINE_ROWS_SOURCE = CSRC + "mc_engine_rows.cu"
GATED_CORR_SOURCE = CSRC + "mc_gated_corr.cu"
BOOK_ROWS_SOURCE = CSRC + "mc_engine_book_rows.cu"
BAR_SWEEP_SOURCE = CSRC + "mc_engine_bar_sweep.cu"
FC_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:584"
GATED_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1067"
ENGINE_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1415"
SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1978"
GATED_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:2163"
ENGINE_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1813"
# BASELINE config #5 (benchmarks/run_all.py:221-260): three (stop, tp) rows,
# 2^30 paths x 40 bars
CONFIG5 = [(0.25, 0.15), (0.35, 0.25), (0.45, 0.35)]
CONFIG5_PATHS = 1 << 30
SWEEP_INJECT_BLOCKS = 4
SWEEP_WORK_PATHS = 1 << 18        # the CLI sweeps' bounds: the plain version's work on these
ENGINE_SWEEP_WORK_PATHS = 1 << 14
ENGINE_LANES = 256
ENGINE_INJECT_BLOCKS = 8
# the JAX engine kernel tests' levels (tests/test_pallas_engine.py:25-32)
ENGINE_ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
               {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
               {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
# the port CLI's levels when its DB is empty (host/cli.py), for the work counts
CLI_ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
            {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
            {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
SFU_PER_SM_CLK = 16
IMUL_PER_SM_CLK = 64
PHILOX_IMULS = 40
# the injected sampler comparisons (phases 24-26), in price ulps (``r_ulp``):
# a true edge tie lies within TIE_ULPS of a bin edge on both sides (a trade);
# a lifecycle path that agrees drifts at most DRIFT_ULPS a trade (and one more)
TIE_ULPS = 8
DRIFT_ULPS = 16


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line with the seconds since the start, so the log shows where
    the run's time goes."""
    print(f"{msg} (+{time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Card:
    """Peak rates of this card for the bounds."""

    def __init__(self, clock_mhz: float, sms: int):
        self.clock_hz, self.sms = clock_mhz * 1e6, sms

    def bound(self, *, bytes_: float, f32: float, sfu: float, imul: float) -> dict:
        parts = {
            "bytes_ms": bytes_ / HBM_BYTES_S * 1e3,
            "f32_ms": f32 / F32_FLOPS * 1e3,
            "sfu_ms": sfu / (SFU_PER_SM_CLK * self.sms * self.clock_hz) * 1e3,
            "imul_ms": imul / (IMUL_PER_SM_CLK * self.sms * self.clock_hz) * 1e3,
        }
        ms = max(parts.values())
        return {"bound_ms": ms,
                "bound_by": "bytes" if parts["bytes_ms"] == ms else "operations",
                "bound_parts": parts}


def fc_ops(work, entered: int, scale: float, by_groups: bool = True) -> dict:
    """Operations of the first-contact kernel (no noise) from the plain
    version's work counts [Box-Muller pairs, bars walked, bars after contact,
    ..., Philox calls], scaled by ``scale``.  A Philox4x32-10 call gives four
    uniforms, rows 4j .. 4j + 3 of a path's layout (``ops/draws.GbmLayout``),
    so the least work counts one call for each group of four rows a path
    touches (the last entry, ``cuda_mc.philox_groups``: its radius, angle,
    high and low rows, rounded up to groups a path); ``by_groups=False``
    counts a call a uniform, as the bound did before the recount and the
    Heston sampler's bound still does (``fc_sampler_ops``)."""
    pairs, walked, post = (float(x) * scale for x in work[:3])
    entered *= scale
    logf = pairs + 2 * post
    sqrtf = pairs + 2 * post
    expf = (walked - post) + entered + 2 * post     # closes, the entry's open, high/low
    sincos = pairs
    div = entered                                   # reward / risk
    philox = float(work[-1]) * scale if by_groups else 2 * pairs + 2 * post
    # float32 work counted one operation per transcendental plus ~20 per bar
    f32 = logf + sqrtf + expf + 2 * sincos + div + 20 * walked
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def gated_ops(n_paths: float, held: float, trades: float) -> dict:
    """Operations of the gated kernel (no noise) for ``n_paths`` paths of
    NUM_BARS bars, ``held`` bars on which a position was open (bridge high/low
    evaluated) and ``trades`` entries."""
    pairs = n_paths * NUM_BARS / 2
    bars = n_paths * NUM_BARS
    logf = pairs + 2 * held
    sqrtf = pairs + 2 * held
    expf = bars + n_paths + 2 * held                # closes, bar 0's prev close, high/low
    div = 2 * trades                                # confidence, reward / risk
    philox = n_paths * NUM_BARS                     # W calls of four words a path
    f32 = logf + sqrtf + expf + 2 * pairs + div + 30 * bars
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def engine_gate_divs(counts, scale: float, num_bars: int = NUM_BARS) -> float:
    """The divisions of the gates a configuration reached (the confidence
    division past the contact latch, the slope's 3 past the veto, one a
    close), from the plain version's int64 totals ``counts`` on a sample,
    scaled by ``scale``."""
    c = [float(x) for x in counts]
    skips = c[7:23]
    reached7 = (c[0] * num_bars - sum(skips[:5])) * scale
    reached10 = reached7 - sum(skips[5:11]) * scale
    return reached7 + 3 * reached10 + (c[2] + c[3]) * scale


def engine_ops(n_paths: float, counts, scale: float, num_bars: int = NUM_BARS,
               n_levels: int = 0) -> dict:
    """A floor on the engine kernel's operations (no noise) for ``n_paths``
    paths of ``num_bars`` bars, from the plain version's int64 totals ``counts``
    (n, entered, wins, losses, open, trades, escalations, 16 skips, ...) on a
    sample, scaled by ``scale``.  Every bar: the close, bridge high/low and
    volume (3 logf, 3 sqrtf, 4 expf, half of two sincosf pairs), 4 divisions
    (minute of day, volume coupling, two minute-close MAs) and the guard's
    MAs once defined; a bar that reaches the contact latch adds the
    confidence division, one that reaches the veto the slope's 3; a close,
    the R division.  ~100 float32 operations of logic a bar besides, and
    with ``n_levels`` (the envelope kernels, which count them) the nearest
    level's search over every level a bar (3 operations a level)."""
    bars = n_paths * num_bars
    guard_divs = n_paths * sum((t + 1 >= 5) + (t + 1 >= 20) for t in range(num_bars))
    logf, sqrtf, expf = 3 * bars, 3 * bars, 4 * bars
    div = 4 * bars + guard_divs + engine_gate_divs(counts, scale, num_bars)
    philox = n_paths * math.ceil(10 * num_bars / 2 / 4)   # 10 rows a step, 4 a call
    f32 = logf + sqrtf + expf + 2 * bars + div + 100 * bars + 3 * n_levels * bars
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def sweep_ops(work, entered: int, rows: int, scale: float) -> dict:
    """Operations of the first-contact sweep for its work counts [Box-Muller
    pairs, bars walked (to the last row's hit), bars walked after contact,
    bars x rows checked after contact, Philox calls], scaled by ``scale``:
    each path's bars and contact once (``fc_ops``), plus every row's
    stop/target recomputed and checked (~8 float32 operations a row and bar)
    and its R division."""
    ops = fc_ops(work, entered, scale)
    row_bars = float(work[3]) * scale
    extra_div = (rows - 1) * entered * scale
    ops["f32"] += 8 * row_bars + extra_div
    ops["sfu"] += extra_div
    return ops


def gated_sweep_ops(n_paths: float, held_rows, trades_rows) -> dict:
    """A floor on the gated sweep's operations with each path's bars made
    once: ``gated_ops`` for the bars (bridge extremes on the bars the row
    that holds longest holds), plus each further row's decisions (~30
    float32 operations a bar) and its confidence and R divisions."""
    ops = gated_ops(n_paths, max(held_rows), sum(trades_rows))
    ops["f32"] += (len(held_rows) - 1) * 30 * n_paths * NUM_BARS
    return ops


def engine_sweep_ops(n_paths: float, counts_rows, scale: float, num_bars: int = NUM_BARS,
                     n_levels: int = 0) -> dict:
    """A floor on the engine sweep's operations with each path's bars, its
    volumes and their MAs made once: ``engine_ops`` for the first row, plus
    for each further row the divisions of the gates it reached and ~100
    float32 operations of logic a bar (and, with ``n_levels``, the nearest
    level's search a bar)."""
    ops = engine_ops(n_paths, counts_rows[0], scale, num_bars, n_levels)
    for c in counts_rows[1:]:
        div = engine_gate_divs(c, scale, num_bars)
        ops["sfu"] += div
        ops["f32"] += div + (100 + 3 * n_levels) * n_paths * num_bars
    return ops


def hist_bins(values, lifecycle: bool):
    """Each float32 value's histogram bin as the kernels and the plain
    versions bin it: a first-contact path's R, or a lifecycle path's equity."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_gated import LIFE_BIN_SCALE
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import (HIST_BINS, HIST_HI, HIST_LO,
                                                                   LIFE_HIST_LO)

    v = values.float()
    b = ((v - LIFE_HIST_LO) * LIFE_BIN_SCALE if lifecycle
         else (v - HIST_LO) * (HIST_BINS / (HIST_HI - HIST_LO)))
    return torch.clamp(b.to(torch.int32), 0, HIST_BINS - 1).to(torch.int64)


def edge_ties(want_hist, cpu_vals, kernel_vals, counted, agree, near, lifecycle: bool):
    """The plain histogram ``want_hist`` (of the ``counted`` paths'
    ``cpu_vals``) with every true edge tie binned as the kernel bins its
    ``kernel_vals``: a path that agrees with the kernel (``agree``) whose
    two values sit in adjacent bins, each within ``near`` (a float or one a
    path) of the edge between them, a value on an edge moved across it by
    the ulps of the other side's transcendentals.  Returns (that histogram,
    the tie count).  Recorded bars on a cent grid make ties common: a
    block-bootstrap path often enters exactly at a level, and with equal
    paddings its R is then 1 within a price ulp, on a bin edge.  The
    per-path values must give the plain histogram back."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_gated import LIFE_BIN_SCALE
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import (HIST_BINS, HIST_HI, HIST_LO,
                                                                   LIFE_HIST_LO)

    n = want_hist.shape[0]
    bc, bk = hist_bins(cpu_vals, lifecycle), hist_bins(kernel_vals, lifecycle)
    if not torch.equal(torch.bincount(bc[counted], minlength=n), want_hist):
        raise AssertionError("the per-path values do not give the plain histogram")
    hi = torch.maximum(bc, bk).double()
    edge = (LIFE_HIST_LO + hi / float(LIFE_BIN_SCALE) if lifecycle
            else HIST_LO + hi * ((HIST_HI - HIST_LO) / HIST_BINS))
    on_edge = (((cpu_vals.double() - edge).abs() <= near)
               & ((kernel_vals.double() - edge).abs() <= near))
    tie = agree & counted & ((bc - bk).abs() == 1) & on_edge
    return (want_hist - torch.bincount(bc[tie], minlength=n)
            + torch.bincount(bk[tie], minlength=n)), int(tie.sum())


def r_ulp(price: float, stop: float) -> float:
    """One float32 price ulp at ``price`` in R units (over the stop
    distance ``stop``): the scale of the drift between the kernel's bars
    and the plain version's on the CPU, a few ulps of a price apart."""
    import numpy as np

    return float(np.spacing(np.float32(price))) / stop


def compare(name: str, want, got, n_paths: int, quiet: bool = False, ties=None,
            tie_ulp: float = 0.0, num_bars: int = NUM_BARS) -> float:
    """Hold first-contact kernel totals ``got`` against plain totals ``want``
    (both (int64 counts, float64 floats)); returns |delta mean R|.  ``quiet``
    logs only a failure.  ``ties`` = (the plain version's per-path R, the
    kernel's), f32[P] with NaN where a path did not enter: the histogram is
    then held after binning each true edge tie (both R within TIE_ULPS price
    ulps, ``tie_ulp`` = ``r_ulp`` of the row, of one bin edge) as the kernel
    bins it (``edge_ties``).  The flip budget is F = 2 + paths/1024 x
    ceil(``num_bars`` / 40)."""
    import torch

    wc, wf = (t.cpu() for t in want)
    gc, gf = (t.cpu() for t in got)
    flips = 2 + n_paths // 1024 * math.ceil(num_bars / NUM_BARS)
    bad = []
    want_hist, n_ties = wc[5:], None
    if ties is not None:
        rc, rk = (t.cpu() for t in ties)
        want_hist, n_ties = edge_ties(wc[5:], rc, rk, torch.isfinite(rc), torch.isfinite(rk),
                                      TIE_ULPS * tie_ulp, lifecycle=False)
    if int(gc[0]) != int(wc[0]) or int(wc[0]) != n_paths:
        bad.append(f"n {int(gc[0])} vs {int(wc[0])}")
    for i, fld in enumerate(("entered", "tp", "stop", "open"), start=1):
        if abs(int(gc[i]) - int(wc[i])) > flips:
            bad.append(f"{fld} {int(gc[i])} vs {int(wc[i])} (budget {flips})")
    max_abs_r = max(abs(float(wf[2])), abs(float(wf[3])))
    if abs(float(gf[0]) - float(wf[0])) > flips * max_abs_r:
        bad.append(f"sum_r {float(gf[0])} vs {float(wf[0])}")
    l1 = int((gc[5:] - want_hist).abs().sum())
    if l1 > 2 * flips:
        bad.append(f"hist L1 {l1} > {2 * flips}")
    for j, fld in ((2, "min_r"), (3, "max_r")):
        if abs(float(gf[j]) - float(wf[j])) > 1e-3:
            bad.append(f"{fld} {float(gf[j])} vs {float(wf[j])}")
    d_mean = abs(float(gf[0]) / max(int(gc[1]), 1)
                 - float(wf[0]) / max(int(wc[1]), 1))
    if not quiet or bad:
        log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} tp {int(gc[2])}/{int(wc[2])} "
            f"stop {int(gc[3])}/{int(wc[3])} open {int(gc[4])}/{int(wc[4])} "
            f"sum_r {float(gf[0]):.6f}/{float(wf[0]):.6f} hist L1 {l1}"
            + ("" if n_ties is None else f" (after {n_ties} edge ties)")
            + f" |d mean_r| {d_mean:.3e}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return d_mean


def compare_lifecycle(name: str, want, got, n_paths: int, engine: bool = False,
                      trace=None, quiet: bool = False, tie_ulp: float | None = None,
                      num_bars: int = NUM_BARS):
    """Hold gated (or, with ``engine``, engine) kernel output ``got`` against
    the plain version's ``want`` (both (int64 counts, float64 floats, f32[P,
    6] per-path rows; the engine's counts carry escalations and 16 skip
    counters before the histogram, its rows an escalation column and the
    path's 16 skip counts)), path by path and on totals; returns the largest
    |d equity| or |d dd| on the paths that agree, and the bool[P] mask of the
    paths that differ.  ``trace(differ)``, when given, runs on the differing
    paths before any budget is applied (it raises unless each is a flipped
    decision); ``quiet`` logs only a failure.  With ``tie_ulp`` (``r_ulp`` of
    the row: a price ulp in R) every path that agrees must drift at most
    DRIFT_ULPS of it a trade (and one more), and the histogram is held after
    binning each true edge tie (a path that agrees and entered on both
    sides, both equities within TIE_ULPS of it a trade of one bin edge) as
    the kernel bins it (``edge_ties``)."""
    import torch

    wc, wf, wr = (t.cpu() for t in want[:3])
    gc, gf, gr = (t.cpu() for t in got[:3])
    # a path meets its decisions bar by bar: F per NUM_BARS bars of horizon
    flips = 2 + n_paths // 1024 * max(1, -(-num_bars // NUM_BARS))
    hist = 23 if engine else 6
    bad = []
    if int(gc[0]) != int(wc[0]) or int(wc[0]) != n_paths:
        bad.append(f"n {int(gc[0])} vs {int(wc[0])}")
    if abs(int(gc[1]) - int(wc[1])) > flips:
        bad.append(f"entered {int(gc[1])} vs {int(wc[1])} (budget {flips})")
    max_eq = float(wr[:, 0].abs().max())
    for j, fld in ((0, "sum_eq"), (2, "sum_dd")):
        if abs(float(gf[j]) - float(wf[j])) > flips * max(max_eq, 1.0):
            bad.append(f"{fld} {float(gf[j])} vs {float(wf[j])}")
    # a flipped decision may keep a path's counts and still move its trades,
    # so a path's trades differ when its counts (the engine's escalations
    # too) differ or its equity/dd moved more than the ulp drift allows
    # (1e-3 per trade); an engine path whose trades agree differs still when
    # a first-fail reason moved from one gate to another (its skip counts)
    cols = [1, 2, 3, 4] + ([6] if engine else [])
    err = (gr[:, [0, 5]] - wr[:, [0, 5]]).abs().amax(dim=1)
    trades_differ = ((gr[:, cols] != wr[:, cols]).any(dim=1)
                     | (err > 1e-3 * torch.clamp(wr[:, 1], min=1.0)))
    reason_only = torch.zeros_like(trades_differ)
    if engine:
        reason_only = (gr[:, 7:23] != wr[:, 7:23]).any(dim=1) & ~trades_differ
    differ = trades_differ | reason_only
    n_differ = int(differ.sum())
    want_hist, n_ties, drift = wc[hist:], None, None
    if tie_ulp is not None:
        trades = wr[:, 1].double()
        want_hist, n_ties = edge_ties(wc[hist:], wr[:, 0], gr[:, 0], wr[:, 1] > 0,
                                      ~differ & (gr[:, 1] > 0),
                                      TIE_ULPS * tie_ulp * torch.clamp(trades, min=1.0),
                                      lifecycle=True)
        # the drift of the paths that agree, in price ulps a trade (and one more)
        per = err.double() / (tie_ulp * (trades + 1.0))
        drift = float(per[~differ].max()) if bool((~differ).any()) else 0.0
        if drift > DRIFT_ULPS:
            bad.append(f"a path that agrees drifts {drift:.3f} price ulps a trade "
                       f"(limit {DRIFT_ULPS})")
    l1 = int((gc[hist:] - want_hist).abs().sum())
    if l1 > 2 * flips:
        bad.append(f"hist L1 {l1} > {2 * flips}")
    if trace is not None:
        trace(differ)
    if int(trades_differ.sum()) > flips:
        bad.append(f"{int(trades_differ.sum())} paths' trades differ (budget {flips})")
    if int(reason_only.sum()) > flips:
        bad.append(f"{int(reason_only.sum())} paths differ in first-fail reasons only "
                   f"(budget {flips})")
    extra = ""
    if engine:
        if abs(int(gc[6]) - int(wc[6])) > flips:
            bad.append(f"escalations {int(gc[6])} vs {int(wc[6])} (budget {flips})")
        d_skips = (gc[7:23] - wc[7:23]).abs()
        if int(d_skips.max()) > num_bars * n_differ:
            bad.append(f"skip counters differ by {d_skips.tolist()} "
                       f"(budget {num_bars * n_differ})")
        if not torch.equal(gc[7:23], gr[:, 7:23].to(torch.int64).sum(dim=0)):
            bad.append("the kernel's skip totals differ from its per-path skip counts")
        extra = (f" escalations {int(gc[6])}/{int(wc[6])}; skip counters "
                 f"{gc[7:23].tolist()} (max |d| {int(d_skips.max())});")
    max_err = float(err[~differ].max()) if bool((~differ).any()) else 0.0
    if engine:
        extra += f" reasons only {int(reason_only.sum())};"
    if not quiet or bad:
        log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} trades {int(gc[5])}/{int(wc[5])} "
            f"wins {int(gc[2])}/{int(wc[2])} losses {int(gc[3])}/{int(wc[3])} "
            f"open {int(gc[4])}/{int(wc[4])} sum_eq {float(gf[0]):.6f}/{float(wf[0]):.6f} "
            f"hist L1 {l1}" + ("" if n_ties is None else f" (after {n_ties} edge ties)")
            + f";{extra} paths differing {n_differ}, max |d eq|,|d dd| elsewhere "
            f"{max_err:.3e}" + ("" if drift is None else
                                f" ({drift:.3f} price ulps a trade and one more)"))
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return max_err, differ


def engine_trace(bars, tie, nzs, levels, params, kw, noise, device):
    """Drive the plain ``EngineLifecycle`` over ``bars`` on ``device``,
    recording after every bar (side, trades, wins, losses, escalations,
    first-fail reason) as int[P, W, 6], the equity as f32[P, W] and (entry,
    stop, target) as f32[P, W, 3]; returns (per-path rows, ints, equity,
    prices)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_engine import path_rows
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.regular import GUARD_WINDOW_BARS
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import (
        EngineLifecycle, skip_columns)

    life = EngineLifecycle(bars.open[:, 0].to(device), levels, params, noise=noise,
                           windowed=bars.close.shape[1] > GUARD_WINDOW_BARS, **kw)
    ints, skips, equity, prices = [], 0, [], []
    for t in range(bars.close.shape[1]):
        cols = (bars.high, bars.low, bars.close, bars.volume, tie)
        nz = tuple(n[:, t].to(device) for n in nzs) if nzs is not None else None
        reason = life.step(t, *(x[:, t].to(device) for x in cols), nz)
        skips = skips + skip_columns(reason)
        ints.append(torch.stack([life.side, life.trades, life.wins, life.losses,
                                 life.escal, reason], 1).cpu())
        equity.append(life.equity.cpu())
        prices.append(torch.stack([life.entry, life.stop, life.target], 1).cpu())
    return (path_rows(life.outcome(), skips).cpu(), torch.stack(ints, 1),
            torch.stack(equity, 1), torch.stack(prices, 1))


def trace_engine_flips(name, u, differ, kernel_rows, cpu_rows, levels, params, gates,
                       sigma, noise, antithetic, dev, s0: float = 100.0,
                       market=None, sampler=None, drift_ok: bool = False,
                       num_bars: int = NUM_BARS) -> dict:
    """Phase 6's trace for the engine: the plain engine over the bars the
    plain version makes on the CPU (run on the CPU) and over those it makes
    on the card (run on the card).  For every differing path the card run
    equals the kernel's row exactly, the CPU run the plain row, and the two
    runs part at some bar (a decision or a first-fail reason went the other
    way).  A book symbol's ``market`` = (market uniforms, beta); a
    non-gbm ``sampler`` (``ops/samplers.Sampler``) builds the bars.  With
    ``drift_ok`` a differing path whose runs never part may instead be
    drift alone (``drift_only``)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import Sampler
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import engine_knobs

    idx = torch.nonzero(differ).flatten()
    if idx.numel() == 0:
        return {"paths": 0}
    sampler = Sampler() if sampler is None else sampler
    layout = EngineLayout(num_bars, noise is not None, sampler.kind, market is not None)
    kw = engine_knobs(**gates)
    runs = []
    for src, where in ((u, torch.device("cpu")), (u.to(dev), dev)):
        mkw = ({} if market is None
               else dict(market_uniforms=market[0].to(where), beta=market[1]))
        bars, tie, nzs = cuda_engine.engine_bars_from_uniforms(
            src, layout, s0=s0, mu=0.0, sigma=sigma, dt=DT, antithetic=antithetic,
            sampler=sampler, **mkw)
        pick = type(bars)(*(x[idx.to(x.device)] for x in bars))
        runs.append(engine_trace(pick, tie[idx.to(tie.device)],
                                 None if nzs is None else nzs[:, idx.to(nzs.device)],
                                 levels, params, kw, noise, where))
    (rows_cpu, i_cpu, _, px_cpu), (rows_dev, i_dev, _, px_dev) = runs
    trade_cols = [1, 2, 3, 4, 6]
    equal_trades = int((kernel_rows[idx][:, trade_cols] == cpu_rows[idx][:, trade_cols])
                       .all(dim=1).sum())
    if not torch.equal(rows_dev, kernel_rows[idx]):
        raise AssertionError(f"{name}: the kernel differs from the plain engine "
                             "on the card's own bars")
    if not torch.equal(rows_cpu, cpu_rows[idx]):
        raise AssertionError(f"{name}: the traced engine differs from the plain version")
    parted = (i_cpu != i_dev).any(dim=2)
    n_drift = drift_only(name, parted.any(dim=1), kernel_rows[idx], cpu_rows[idx],
                         px_dev[:, -1], trade_cols) if drift_ok else 0
    if not n_drift and not bool(parted.any(dim=1).all()):
        for k in torch.nonzero(~parted.any(dim=1)).flatten().tolist():
            d = (px_cpu[k] - px_dev[k]).abs()
            log(f"    untraced path {int(idx[k])}: kernel {kernel_rows[idx[k], :7].tolist()} "
                f"plain {cpu_rows[idx[k], :7].tolist()}; max |d entry, stop, target| "
                f"{d.amax(dim=0).tolist()} at bars {d.argmax(dim=0).tolist()}")
        raise AssertionError(f"{name}: a differing path shows no flipped decision")
    flipped = parted.any(dim=1)
    flip_bar = parted.int().argmax(dim=1)
    log(f"  {name}: {idx.numel() - n_drift} differing paths ({equal_trades} with equal trade "
        f"counts), each traced to a flipped decision or first-fail reason at bars "
        f"{flip_bar[flipped].tolist()}; kernel == plain engine on the card's bars")
    return {"paths": idx.numel(), "equal_trade_counts": equal_trades}


def drift_only(name, parted, kernel_rows, cpu_rows, prices, count_cols) -> int:
    """The differing paths of a trace whose runs over the CPU's and the
    card's bars never part (no decision flipped; the kernel equal to the
    plain lifecycle on the card's bars is checked before): each must keep
    its counts (``count_cols`` of the rows), its equity moved only by the
    bars' ulps, amplified where a noisy stop lands near the entry (R =
    reward / risk with a small risk).  Logs them with their last (entry,
    stop, target) on the card's bars (``prices``; None for a book path);
    returns how many there are."""
    import torch

    drift = ~parted
    if not bool(drift.any()):
        return 0
    if not torch.equal(kernel_rows[drift][:, count_cols], cpu_rows[drift][:, count_cols]):
        raise AssertionError(f"{name}: a differing path shows no flipped decision and its "
                             "counts differ")
    for k in torch.nonzero(drift).flatten().tolist():
        at = ""
        if prices is not None:
            entry, stop, target = (float(x) for x in prices[k])
            at = (f", last entry {entry:.9g} stop {stop:.9g} target {target:.9g}: risk "
                  f"{abs(entry - stop):.6g}")
        log(f"    {name}: drift only, no decision parts: equity {float(cpu_rows[k, 0]):.7g} "
            f"(plain on CPU) vs {float(kernel_rows[k, 0]):.7g} (kernel, == the plain "
            f"lifecycle on the card's bars){at}")
    return int(drift.sum())


# The closed-trade harvest (kernels #8, #10, #12 with harvest=True, the
# envelope kernels' harvest builds, ops/csrc/mc_engine_wide*_harvest.cu): the
# largest sum error of each harvest kernel's checks against its plain version
# (keyed by its launch counter), for the kernels line.
HV_ERR: dict = {}


def differing_trades(rows_a, rows_b) -> int:
    """Trades (the larger side's) on the paths whose trades differ between
    two runs' per-path rows (``ops/cuda_engine.path_rows``): a count column
    (trades, wins, losses, open, escalations) differs, or equity / drawdown
    by more than 1e-3 a trade (a path that agrees drifts less).  The
    harvest's bound (``gap_within``) is set by it."""
    import torch

    a, b = rows_a.cpu(), rows_b.cpu()
    cols = [1, 2, 3, 4, 6]
    err = (a[:, [0, 5]] - b[:, [0, 5]]).abs().amax(dim=1)
    differ = (a[:, cols] != b[:, cols]).any(dim=1) | (err > 1e-3 * torch.clamp(b[:, 1], min=1.0))
    return int(torch.maximum(a[differ, 1], b[differ, 1]).sum())


def gap_within(got, want, differing_trades: int, x1_drift: float = 0.0) -> tuple:
    """Whether two harvests (``models/harvest.EngineHarvest``) of the same
    paths agree as far as their differing paths allow, and how far they
    part: ``differing_trades`` is the count of trades (the larger side's) on
    paths whose trades differ between the two runs.  Each such trade can
    move one count of each table to another (bucket, label): the L1 gap of
    each count table is at most 2 a trade.  A sum can move by such a
    trade's x (<= 1) on either side; an agreeing trade's x1 = min(1,
    distance) by ``x1_drift`` where the two runs' bars part by price ulps
    (x6 depends on the bar index alone); and two float32 sums of the same n
    non-negative terms in different orders differ by at most 2 (n - 1)
    2^-24 times the larger: so |d| <= 2 d + n x1_drift + 2 n 2^-24 max.
    Returns (ok, {"ml_l1", "pol_l1", "sum_excess"}), the excess the largest
    amount by which a sum of a bucket that holds a trade passes its bound
    (<= 0 when ok; -inf with no trade)."""
    import torch

    g, w = (h.to("cpu") for h in (got, want))
    d = int(differing_trades)
    ml_l1 = int((g.ml_counts - w.ml_counts).abs().sum())
    pol_l1 = int((g.pol_counts - w.pol_counts).abs().sum())
    n = torch.maximum(g.pol_counts, w.pol_counts).to(torch.float64)
    excess, ok_sums = -float("inf"), True
    for a, b, drift in ((g.pol_sum_x1, w.pol_sum_x1, x1_drift),
                        (g.pol_sum_x6, w.pol_sum_x6, 0.0)):
        a, b = a.double(), b.double()
        bound = 2.0 * d + n * drift + 2.0 * n * 2.0 ** -24 * torch.maximum(a.abs(), b.abs())
        over = (a - b).abs() - bound
        ok_sums = ok_sums and bool((over <= 0.0).all())
        if bool((n > 0).any()):       # the margin where a bucket holds a trade
            excess = max(excess, float(over[n > 0].max()))
    ok = ml_l1 <= 2 * d and pol_l1 <= 2 * d and ok_sums
    return ok, {"ml_l1": ml_l1, "pol_l1": pol_l1, "sum_excess": excess}


def check_harvest(name: str, what: str, got, want, kernel_rows, plain_rows,
                  price: float) -> None:
    """A harvest kernel's harvest ``got`` against the plain version's ``want``
    of the same paths (``gap_within``): the count tables equal
    where every path agrees, else within 2 a trade of the differing paths'
    trades; the sums within those trades, DRIFT_ULPS price ulps (at
    ``price``) of x1 a trade (an agreeing path's bars part by ulps on CPU
    copies) and the reduction orders.  Records the largest sum error under
    ``HV_ERR[what]``."""
    import numpy as np

    d = differing_trades(kernel_rows, plain_rows)
    ok, gap = gap_within(got, want, d,
                            x1_drift=DRIFT_ULPS * float(np.spacing(np.float32(price))))
    g, w = got.to("cpu"), want.to("cpu")
    err = max(float((g.pol_sum_x1.double() - w.pol_sum_x1.double()).abs().max()),
              float((g.pol_sum_x6.double() - w.pol_sum_x6.double()).abs().max()))
    log(f"  {name} harvest: labeled {int(g.n_labeled.sum())}/{int(w.n_labeled.sum())} "
        f"(kernel/plain), count L1 {gap['ml_l1']} (ML) {gap['pol_l1']} (policy) with "
        f"{d} trades on differing paths, sums max |d| {err:.3e} (the bound's least "
        f"margin {-gap['sum_excess']:.3e})")
    if not ok:
        raise AssertionError(f"{name}: the harvest kernel's harvest disagrees with the plain "
                             f"version's: {gap}")
    HV_ERR[what] = max(HV_ERR.get(what, 0.0), err)


HV_MAIN: dict = {}   # the harvest kernels' main-path times, for the kernels line


HV_PLAIN: dict = {}  # the harvest kernels' plain versions (with the harvest): ms and shape


def harvest_bound(card, bytes_: float, ops: dict, trades: float, rows: int, grid: int) -> dict:
    """A harvest kernel's bound: its envelope kernel's bytes and operations
    (``ops``) plus the harvest's: the harvest partial rows it writes (``rows``
    launch rows x ``grid`` CTAs x 72 int64 counts and 16 float sums) and ~10
    float32 operations a trade (a close's two sums and two tallies, an
    entry's four latches)."""
    ops = dict(ops, f32=ops["f32"] + 10.0 * trades)
    return card.bound(bytes_=bytes_ + rows * grid * (72 * 8 + 16 * 4), **ops)


def hv_row(h, i):
    """Row ``i`` of an [S]-batched harvest."""
    from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV

    return HV.EngineHarvest(*(f[i] for f in h))


def same_launch(name: str, plain_launch, harvest_launch) -> None:
    """The harvest launch's partial rows (and per-path rows) equal the launch
    without harvest bit for bit: a harvest changes no trade."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(plain_launch, harvest_launch)):
        raise AssertionError(f"{name}: the harvest launch's rows differ from the launch "
                             "without harvest")


def lifecycle_trace(bars, tie, nzs, levels, params, gate, noise):
    """Drive the plain ``Lifecycle`` over ``bars`` on the CPU, recording after
    every bar its integer state (side, trades, wins, losses, cooldown, touch
    counts, last touch bars) as int[P, W, k] and (entry, stop, target,
    equity) as f32[P, W, 4]; returns (outcome, ints, floats)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import Lifecycle

    life = Lifecycle(bars.open[:, 0], levels, params, gate, noise=noise)
    ints, floats = [], []
    for t in range(bars.close.shape[1]):
        nz = tuple(n[:, t] for n in nzs) if nzs is not None else None
        life.step(t, bars.high[:, t], bars.low[:, t], bars.close[:, t], tie[:, t], nz)
        ints.append(torch.cat([torch.stack([life.side, life.trades, life.wins,
                                            life.losses, life.cooldown], 1),
                               life.touch, life.last_tb], 1))
        floats.append(torch.stack([life.entry, life.stop, life.target, life.equity], 1))
    return life.outcome(), torch.stack(ints, 1), torch.stack(floats, 1)


def trace_flips(name, u, differ, kernel_rows, cpu_rows, levels, params, gate,
                noise, antithetic, dev, s0: float = 100.0, sigma: float = SIGMA,
                market=None, sampler=None, drift_ok: bool = False) -> dict:
    """Show that the paths on which the kernel and the plain version on CPU
    copies differ are flipped decisions, not a kernel fault.

    The bars are generated twice from the same uniforms, by the plain version
    on the CPU and on the card (PyTorch's transcendentals against CUDA's),
    and the same plain ``Lifecycle`` runs on the CPU over each.  Checks, for
    every differing path: the run over the card's bars equals the kernel's
    per-path row exactly, the run over the CPU's bars equals the plain row,
    and the two runs' integer state parts at some bar (a stop, target, tie,
    entry, direction, level or touch decision went the other way).  Prints
    the first flipped bar of the first path whose counts agree, with the bar's
    close/high/low on both sides in ulps.  A book symbol's ``market`` =
    (market uniforms, beta); a non-gbm ``sampler`` (``ops/samplers.Sampler``)
    builds the bars.  With ``drift_ok`` a differing path whose runs never
    part may instead be drift alone (``drift_only``)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import Sampler

    idx = torch.nonzero(differ).flatten()
    if idx.numel() == 0:
        return {"paths": 0}
    sampler = Sampler() if sampler is None else sampler
    layout = GatedLayout(NUM_BARS, noise is not None, sampler.kind, market is not None)
    kw = dict(s0=s0, mu=0.0, sigma=sigma, dt=DT, antithetic=antithetic, sampler=sampler)
    runs = []
    for src in (u, u.to(dev)):
        mkw = ({} if market is None
               else dict(market_uniforms=market[0].to(src.device), beta=market[1]))
        bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(src, layout, **kw, **mkw)
        pick = type(bars)(*(x[idx.to(x.device)].cpu() for x in bars))
        runs.append((pick, tie[idx.to(tie.device)].cpu(),
                     None if nzs is None else nzs[:, idx.to(nzs.device)].cpu()))
    (b_cpu, _, _), (b_dev, _, _) = runs
    out_cpu, i_cpu, f_cpu = lifecycle_trace(*runs[0], levels, params, gate, noise)
    out_dev, i_dev, f_dev = lifecycle_trace(*runs[1], levels, params, gate, noise)

    def rows(o):
        return torch.stack([o.equity, o.trades.float(), o.wins.float(),
                            o.losses.float(), o.open_at_end.float(), o.max_dd], 1)

    if not torch.equal(rows(out_dev), kernel_rows[idx]):
        raise AssertionError(f"{name}: the kernel differs from the plain lifecycle "
                             "on the card's own bars")
    if not torch.equal(rows(out_cpu), cpu_rows[idx]):
        raise AssertionError(f"{name}: the traced lifecycle differs from the plain version")
    parted = (i_cpu != i_dev).any(dim=2)                        # [n, W]
    n_drift = drift_only(name, parted.any(dim=1), kernel_rows[idx], cpu_rows[idx],
                         f_dev[:, -1, :3], [1, 2, 3, 4]) if drift_ok else 0
    if not n_drift and not bool(parted.any(dim=1).all()):
        raise AssertionError(f"{name}: a differing path shows no flipped decision")
    flipped = parted.any(dim=1)
    flip_bar = parted.int().argmax(dim=1)

    def ulps(a, b):
        return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()

    bar_ulps = torch.stack([ulps(getattr(b_cpu, k), getattr(b_dev, k)).amax(dim=1)
                            for k in ("close", "high", "low")], 1)
    same_counts = (kernel_rows[idx, 1:5] == cpu_rows[idx, 1:5]).all(dim=1) & flipped
    log(f"  {name}: {int(flipped.sum())} differing paths ({int(same_counts.sum())} with "
        f"equal counts), each traced to a flipped decision at bars "
        f"{flip_bar[flipped].tolist()}; bars differ by at most "
        f"{int(bar_ulps.max())} ulps; kernel == plain lifecycle on the card's bars")
    if bool(same_counts.any()):
        k = int(torch.nonzero(same_counts).flatten()[0])
        t = int(flip_bar[k])
        cols = ("side", "trades", "wins", "losses")

        lv = levels.price[levels.valid]

        def at(b, fs, i, tt):
            st = fs[k, tt - 1].tolist() if tt > 0 else [0.0] * 4
            dist = float((b.close[k, tt] - lv).abs().min())
            return (f"close {b.close[k, tt]:.9g} high {b.high[k, tt]:.9g} "
                    f"low {b.low[k, tt]:.9g} level dist {dist:.9g} "
                    f"(prox {params.contact_prox}) | before: entry {st[0]:.9g} "
                    f"stop {st[1]:.9g} target {st[2]:.9g} | after: "
                    + " ".join(f"{c} {int(v)}" for c, v in zip(cols, i[k, tt, :4])))

        log(f"    path {int(idx[k])} flips at bar {t} "
            f"(close/high/low differ by "
            f"{[int(ulps(getattr(b_cpu, c)[k, t:t + 1], getattr(b_dev, c)[k, t:t + 1])) for c in ('close', 'high', 'low')]} ulps there):")
        log(f"      cpu bars : {at(b_cpu, f_cpu, i_cpu, t)}")
        log(f"      card bars: {at(b_dev, f_dev, i_dev, t)}")
        log(f"      equity: plain on CPU {float(cpu_rows[idx[k], 0]):.7g}, lifecycle "
            f"on the card's bars {float(out_dev.equity[k]):.7g}, kernel "
            f"{float(kernel_rows[idx[k], 0]):.7g}")
    return {"paths": idx.numel(), "equal_counts": int(same_counts.sum()),
            "max_bar_ulps": int(bar_ulps.max())}


def check_fold(name, plain, got) -> float:
    """A row-fold kernel's totals ``got`` against its plain fold ``plain``;
    returns the largest float error."""
    plain_c, plain_f = (t.cpu() for t in plain)
    got_c, got_f = (t.cpu() for t in got)
    if not bool((plain_c == got_c).all()):
        raise AssertionError(f"{name} counts differ from the plain fold")
    diff = (got_f - plain_f).abs()
    # float64 folds of float32 rows in two orders: relative 1e-9 is ample
    if float((diff / plain_f.abs().clamp(min=1.0)).max()) > 1e-9:
        raise AssertionError(f"{name} floats differ by {diff.tolist()}")
    return float(diff.max())


def launch_counts() -> dict:
    """Every kernel's launch count, across the port's three kernel modules."""
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc

    return {k: v for m in (cuda_mc, cuda_gated, cuda_engine) for k, v in m.LAUNCHES.items()}


CLI_RUNS = 2      # a CLI main path: one warm-up, one timed run
ENV_RUNS = 1      # phases 29-30: one run, its kernels warm from the phase's own checks


def run_cli(cli, argv, reset, expect: dict, n_paths: int = None, work: int = None,
            unit: str = None, runs: int = CLI_RUNS) -> tuple[list, list, dict]:
    """The CLI ``runs`` times (one warm-up, then timed; a single run is
    timed, its kernels warm from the phase's own checks), the launch counts
    set to 0 just before and read just after; the kernels named in
    ``expect`` (their counts a run) must have been launched exactly that
    often a run and no other kernel at all.  ``work`` counts what a run
    simulates (default: paths x output rows).  Returns (the last run's JSON
    lines, seconds, the counts of ``expect``)."""
    import torch

    reset()
    secs = []
    for _ in range(runs):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"cli exited {rc}")
    counts = launch_counts()
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    log(f"  cli output: {json.dumps(lines[-1])}" + (f" (last of {len(lines)} rows)"
                                                    if len(lines) > 1 else ""))
    log(f"  launches in the main-path runs: { {k: v for k, v in counts.items() if v} }")
    expect = {k: v * runs for k, v in expect.items()}
    if {k: v for k, v in counts.items() if v} != expect:
        raise AssertionError(f"the main path launched {counts}, not exactly {expect}")
    for out in lines:
        floats = {k: v for k, v in out.items() if isinstance(v, float)}
        if not all(math.isfinite(v) for v in floats.values()):
            raise AssertionError(f"non-finite cli output: {out}")
        if "hit_rate" in out and not 0.0 < out["hit_rate"] < 1.0:
            raise AssertionError(f"hit_rate out of (0, 1): {out}")
    timed_s = secs[1:] or secs          # one run: its kernels warm from the phase's checks
    rep_s = sum(timed_s) / len(timed_s)
    work = work or (n_paths or MAIN_PATHS) * len(lines)
    unit = unit or ("paths x rows" if len(lines) > 1 else "paths")
    log("  cli wall per run: " + (f"warm-up {secs[0]:.3f} s, reps " if runs > 1 else "")
        + f"{', '.join(f'{s:.3f}' for s in timed_s)} s -> "
        f"{work / rep_s:.6e} {unit}/s end to end")
    return lines, secs, {k: counts[k] for k in expect}


def check_sweep_output(lines: list, combos: list, keys: list) -> None:
    """A ``sweep`` run's rows: the JAX CLI's keys in its order, one row per
    grid point in the JAX CLI's row order."""
    if len(lines) != len(combos):
        raise AssertionError(f"{len(lines)} sweep rows, not {len(combos)}")
    for out, combo in zip(lines, combos):
        if list(out) != keys:
            raise AssertionError(f"sweep row keys {list(out)}, not {keys}")
        grid = [out[k] for k in keys if k in ("stop_padding", "tp_padding", "touch_limit",
                                               "q_min_prob", "level_jitter_std")]
        if grid != list(combo):
            raise AssertionError(f"sweep row {grid} out of the grid's order ({combo})")


def stack_params(cfgs):
    """EngineParams whose leaves stack the configurations ``cfgs`` ([G])."""
    import dataclasses

    import torch

    return type(cfgs[0])(**{f.name: torch.stack([getattr(c, f.name) for c in cfgs])
                            for f in dataclasses.fields(cfgs[0])})


def check_paths_output(out: dict) -> None:
    """The ``paths`` main paths' output: every path counted, some entered."""
    if out["paths"] != float(MAIN_PATHS) or not out["entered"] > 0:
        raise AssertionError(f"unexpected path counts: {out}")


# ---- the universes (kernels #2, #5, #10, #11) and BASELINE config #4
UNI_SYMBOLS = 100          # BASELINE config #4 (benchmarks/run_all.py:147-220)
UNI_PATHS = 1 << 20        # paths a symbol
UNI_SIGMA = 0.25
UNI_SAMPLE_PATHS = 1 << 16    # a symbol: config #4's inputs, kernel vs plain on the card
# the lifecycles' plain versions on the card are launch-bound a symbol at a
# time: phases 16-17, 19-20 and 25-28 hold the main path's inputs on 10 of its
# 100 symbols spread over them (0, 11, ..., 99): a universe's taken from its
# full-width launch, each keyed as its symbol; a book's as a book of their own
CARD_PLAIN_PICK = [round(i * (UNI_SYMBOLS - 1) / 9) for i in range(10)]
UNI_ENGINE_PATHS = 1 << 20     # a symbol, for the engine universe's plain on the card
UNI_SWEEP_PATHS = 1 << 18      # a symbol, for the sweep of universes' plain on the card
UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:828"
GATED_UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1568"
ENGINE_UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2098"
ENGINE_UNI_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2282"
# three symbols with their own levels, spot, volatility and knobs
UNI3_ROWS = [[ENGINE_ROWS[0], ENGINE_ROWS[2]],
             [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
             [{"color": "green", "type": "solid", "index": 0, "price": 99.7}, ENGINE_ROWS[1]]]
UNI3_S0 = (100.0, 100.1, 99.9)
UNI3_SIGMA = (0.3, 0.2, 0.35)
# the engine universe sweep's main path: config #4's first 8 symbols x the 4
# configurations of tests/test_pallas_engine.py:320-325
UNI_SWEEP_SYMBOLS = 8


def entry(name, source, replaces, launches, err, ms, plain, bound, **extra) -> dict:
    """One kernel of the ``kernels`` line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bound_parts": bound["bound_parts"], **extra}


def run_entry(name: str, fn, reset, expect: dict, runs: int = 2):
    """A user's entry point ``fn`` ``runs`` times (one warm-up, then timed),
    the launch counts set to 0 just before and read just after: exactly the
    kernels of ``expect`` ran, that often.  Returns (the last output, the
    seconds of each run, the counts of ``expect``)."""
    import torch

    reset()
    secs, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = {k: v for k, v in launch_counts().items() if v}
    log(f"  launches in the main-path runs: {counts}; wall per run "
        f"{', '.join(f'{x:.3f}' for x in secs)} s")
    if counts != expect:
        raise AssertionError(f"{name} launched {counts}, not exactly {expect}")
    return out, secs, {k: counts[k] for k in expect}


def timed(fn):
    """(fn(), milliseconds) on the host clock around fn and a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def config4(n_sym: int | None = None):
    """BASELINE config #4's universe (benchmarks/run_all.py:153-162): symbol
    i has one blue level at 100 + i, s0 100 + i and sigma 0.25, at most 4
    level slots; its first ``n_sym`` symbols."""
    import numpy as np

    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U

    n_sym = UNI_SYMBOLS if n_sym is None else n_sym
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0 + i}]
            for i in range(n_sym)]
    return (U.stack_levels(rows, max_levels=4),
            np.array([100.0 + i for i in range(n_sym)], np.float32),
            np.full(n_sym, UNI_SIGMA, np.float32))


def plain_picks(single, c4, pick):
    """The plain version on config #4's symbols ``pick``: ``single(symbol,
    levels, s0, sigma)`` for each, the single configuration's plain version
    keyed as that symbol (as the universe keys it), stacked as the
    universe's plain version stacks its symbols."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row

    from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV

    outs = [single(i, grid_row(c4[0], i), float(c4[1][i]), float(c4[2][i])) for i in pick]
    return tuple(HV.stack(x) if isinstance(x[0], HV.EngineHarvest) else torch.stack(x)
                 for x in zip(*outs))


def check_universe_stats(name: str, stats, n_sym: int, pps: int) -> None:
    """A universe run's [S] PathStats: every symbol counted in full, every
    symbol entered, finite sums, lifecycle accounting."""
    import torch

    if tuple(stats.n.shape) != (n_sym,) or not bool((stats.n == pps).all()):
        raise AssertionError(f"{name}: path counts {stats.n.tolist()}, not {n_sym} x {pps}")
    if not bool((stats.n_entered > 0).all()):
        raise AssertionError(f"{name}: a symbol never entered")
    for f in ("sum_r", "sum_r2", "sum_dd", "max_dd", "sum_trades"):
        if not bool(torch.isfinite(getattr(stats, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    if not bool((stats.sum_trades >= stats.n_entered).all()):
        raise AssertionError(f"{name}: fewer trades than entered paths")


def same_on_card(name, want, got, n_cells, n_paths, cell, engine=True):
    """Each cell's kernel output ``got`` (counts, floats, per-path rows)
    equals the plain version's ``want`` on every path (a gated lifecycle
    unless ``engine``); returns the largest float error."""
    err = 0.0
    for i in range(n_cells):
        e, differ = compare_lifecycle(f"{name} {cell(i)}", *(
            tuple(x[i] for x in t) for t in (want, got)), n_paths, engine=engine,
            quiet=True)
        if bool(differ.any()):
            raise AssertionError(f"{name} {cell(i)}: kernel and plain on the card differ "
                                 f"on {int(differ.sum())} paths")
        err = max(err, e)
    d = (got[0].cpu() - want[0].cpu()).abs().amax()
    log(f"    every one of {n_cells} cells equals the plain version on every path "
        f"(counts |d| {int(d)}, sum_eq |d| max "
        f"{float((got[1][..., 0].cpu() - want[1][..., 0].cpu()).abs().max()):.3e})")
    return err


def universe_phases(dev, card, reset) -> list:
    """Phases 15-18: the four universe kernels against their plain versions
    and their single kernels, BASELINE config #4 and its refresh; returns
    their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 GbmLayout)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    params = EngineParams.default()
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = np.array(UNI3_S0, np.float32), np.array(UNI3_SIGMA, np.float32)
    # per-symbol knobs ([S] leaves) and noise stds: proximity and paddings
    # (tests/test_pallas_mc.py:260-305) for #2 and #5; those and q_min
    # (tests/test_pallas_engine.py:352-405) for #10
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    p3e = p3.replace(q_min_prob=[0.60, 0.40, 0.55])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    c4 = config4()
    main_scale = UNI_PATHS / UNI_SAMPLE_PATHS

    def sym(s):
        return dict(s0=float(s0_3[s]), sigma=float(sg_3[s]), symbol=s)

    def row_bytes(mod, n_rows, pps):
        """Bytes of the partial rows ``n_rows`` rows of ``pps`` paths write."""
        return n_rows * grid_size(pps) * (mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 4)

    def fold_cols(rows, mod):
        return rows[0].numel() * 8 + rows[1].numel() * 4 + rows[0].shape[0] * (
            mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 8)

    def fold(mod, rows):
        """Partial rows [S, R, C] (and per-path rows) -> ([S, C] totals, per-path rows)."""
        return (*mod.reduce_rows(rows[0], rows[1]), rows[2])

    def main_inputs(what, cells):
        log(f"  {what} on the main path's inputs ({cells}) at {UNI_SAMPLE_PATHS} paths a "
            "symbol, Philox: kernel vs plain on the card")

    out = []

    # ---- phase 15: first-contact universe (kernel #2)
    lanes = cuda_mc.UNIVERSE_LANES
    nb = 4
    log(f"[15] first-contact universe (mc_universe_kernel), injected uniforms: 3 symbols x "
        f"{nb * lanes} paths (own levels, s0, sigma, prox, paddings), kernel vs plain on "
        "CPU copies")
    u = torch.from_numpy(np.random.default_rng(600).uniform(
        1e-9, 1.0, (3, nb, GbmLayout(NUM_BARS).n_rows, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=nb * lanes, num_bars=NUM_BARS, dt=DT, lanes=lanes)
    want = cuda_mc.universe_totals_reference(0, lv3, p3, s0_3, sg_3, external_uniforms=u, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(0, lv3, p3, s0_3, sg_3, device=dev,
                                                     external_uniforms=u.to(dev), **kw))
    torch.cuda.synchronize()
    uni_err = 0.0
    for s in range(3):
        uni_err = max(uni_err, compare(f"symbol {s}", (want[0][s], want[1][s]),
                                       (got[0][s], got[1][s]), nb * lanes))
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the one-symbol launch "
        "(first_contact_rows) at its inputs and key bit for bit; kernel vs plain on the card")
    kw = dict(paths_per_symbol=PHILOX_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
              external_uniforms=None)
    run = lambda: cuda_mc.universe_rows(7, lv3, p3, s0_3, sg_3, device=dev, **kw)
    rows = run()
    got = cuda_mc.reduce_rows(*rows)
    for s in range(3):
        one = cuda_mc.first_contact_rows(
            7, grid_row(lv3, s), grid_row(p3, s), num_paths=PHILOX_PATHS, num_bars=NUM_BARS,
            mu=0.0, dt=DT, lanes=lanes, noise=None, antithetic=False, external_uniforms=None,
            device=dev, **sym(s))
        tot = cuda_mc.reduce_rows(*one)
        if not (torch.equal(one[0], rows[0][s]) and torch.equal(one[1], rows[1][s])
                and torch.equal(tot[0], got[0][s]) and torch.equal(tot[1], got[1][s])):
            raise AssertionError(f"universe symbol {s} differs from its one-symbol launch")
    (wc, wf, work), uni_plain_ms = timed(lambda: cuda_mc.universe_totals_reference(
        7, lv3, p3, s0_3, sg_3, device=dev, chunk_blocks=64, work=True, **kw))
    for s in range(3):
        uni_err = max(uni_err, compare(f"philox symbol {s}", (wc[s], wf[s]),
                                       (got[0][s], got[1][s]), PHILOX_PATHS))
    uni_red_err = check_fold("mc_universe_reduce_rows", cuda_mc.reduce_rows_reference(*rows),
                             got)
    uni_ms = cuda_ms(run, 3)
    uni_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                           **fc_ops(work.sum(0).cpu(), int(wc[:, 1].sum()), 1.0))
    red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*rows, what="mc_universe_reduce_rows"), 20)
    red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*rows), 20)
    red_bound = card.bound(bytes_=fold_cols(rows, cuda_mc), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals its one-symbol launch bit for bit; at 3 x {PHILOX_PATHS} "
        f"paths: kernel {uni_ms:.3f} ms, bound {uni_bound['bound_ms']:.3f} ms "
        f"{uni_bound['bound_parts']}, plain {uni_plain_ms:.3f} ms; fold {red_ms:.4f} ms")
    lv1, s0_1, sg_1 = config4(1)
    a = cuda_mc.mc_paths_universe_fused(3, lv1, params, s0_1, sg_1,
                                        paths_per_symbol=PHILOX_PATHS, device=dev)
    b = cuda_mc.mc_paths_fused(3, grid_row(lv1, 0), params, num_paths=PHILOX_PATHS,
                               s0=100.0, sigma=UNI_SIGMA, lanes=lanes, device=dev)
    if not (torch.equal(a.sum_r[0], b.sum_r) and torch.equal(a.hist[0], b.hist)):
        raise AssertionError("the one-symbol universe differs from the single run")
    log("  the one-symbol universe equals today's single run (mc_paths_fused) bit for bit")
    main_inputs("mc_universe_kernel", f"config #4's {UNI_SYMBOLS} symbols")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev)
    sc, sf, swork = cuda_mc.universe_totals_reference(0, c4[0], params, *c4[1:], work=True,
                                                      **c4kw)
    kc, kf = cuda_mc.reduce_rows(*cuda_mc.universe_rows(0, c4[0], params, *c4[1:], **c4kw))
    c4_err = max(compare(f"config #4 symbol {s}", (sc[s], sf[s]), (kc[s], kf[s]),
                         UNI_SAMPLE_PATHS, quiet=True) for s in range(UNI_SYMBOLS))
    uni_err = max(uni_err, c4_err)
    log(f"    every symbol within budget (2 + {UNI_SAMPLE_PATHS // 1024}): entered/tp/stop/open "
        f"|d| max {int((kc[:, 1:5].cpu() - sc[:, 1:5].cpu()).abs().max())}, hist L1 max "
        f"{int((kc[:, 5:].cpu() - sc[:, 5:].cpu()).abs().sum(1).max())}, |d mean_r| max "
        f"{c4_err:.3e}")
    log(f"[15] main path: mc_paths_universe_fused, config #4's universe ({UNI_SYMBOLS} symbols "
        f"x {UNI_PATHS} paths x {NUM_BARS} bars)")
    st, secs, launches = run_entry(
        "mc_paths_universe_fused", lambda: cuda_mc.mc_paths_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_universe": 2, "mc_universe_reduce_rows": 2})
    check_universe_stats("first-contact universe", st, UNI_SYMBOLS, UNI_PATHS)
    if not bool((st.n_tp + st.n_stop + st.n_open == st.n_entered).all()):
        raise AssertionError("first-contact universe: tp + stop + open != entered")
    main_ms = cuda_ms(lambda: cuda_mc.universe_rows(
        0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT,
        lanes=lanes, external_uniforms=None, device=dev), 2)
    main_bound = card.bound(bytes_=row_bytes(cuda_mc, UNI_SYMBOLS, UNI_PATHS),
                            **fc_ops(swork.sum(0).cpu(), int(sc[:, 1].sum()), main_scale))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / main_ms * 1e3:.6e} paths/s), bound "
        f"{main_bound['bound_ms']:.3f} ms {main_bound['bound_parts']}")
    out += [entry("mc_universe", FC_SOURCE, UNI_REPLACES, launches["mc_universe"], uni_err,
                  uni_ms, uni_plain_ms, uni_bound, symbols=3, paths=PHILOX_PATHS,
                  main_path_ms=main_ms, main_path_bound_ms=main_bound["bound_ms"],
                  main_s=secs[1:]),
            entry("mc_universe_reduce_rows", FC_SOURCE, UNI_REPLACES,
                  launches["mc_universe_reduce_rows"], uni_red_err, red_ms, red_plain_ms,
                  red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 16: gated universe (kernel #5)
    lanes = GATED_LANES
    gate = GateConfig.from_params(params)
    n_inj = nb * 8 * lanes
    log(f"[16] gated universe (mc_gated_sweep_kernel, a row per symbol), injected uniforms: "
        f"3 symbols x {n_inj} paths, [S] knobs and noise stds, kernel vs plain on CPU "
        "copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(601).uniform(
        1e-9, 1.0, (3, nb, GatedLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3)
    want = cuda_gated.gated_universe_totals_reference(0, lv3, p3, s0_3, sg_3, gate,
                                                      external_uniforms=u, per_path=True, **kw)
    pc, pf, prow = cuda_gated.gated_universe_rows(0, lv3, p3, s0_3, sg_3, gate, device=dev,
                                                  external_uniforms=u.to(dev), per_path=True,
                                                  **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    g_err = 0.0
    for s in range(3):
        err, _ = compare_lifecycle(
            f"symbol {s}", (want[0][s], want[1][s], want[2][s]), (gc[s], gf[s], prow[s]), n_inj,
            trace=lambda d: trace_flips(f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(),
                                        grid_row(lv3, s), grid_row(p3, s), gate,
                                        grid_row(noise3, s), False, dev, s0=float(s0_3[s]),
                                        sigma=float(sg_3[s])))
        g_err = max(g_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the single kernel "
        "(gated_rows) at its inputs and key bit for bit, per path included; kernel vs plain "
        "on the card path by path")
    kw = dict(paths_per_symbol=PHILOX_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
              noise=noise3, external_uniforms=None)
    rows = cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate, device=dev,
                                          per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(*rows[:2])
    for s in range(3):
        one = cuda_gated.gated_rows(7, grid_row(lv3, s), grid_row(p3, s), gate,
                                    num_paths=PHILOX_PATHS, num_bars=NUM_BARS, mu=0.0, dt=DT,
                                    lanes=lanes, noise=grid_row(noise3, s), antithetic=False,
                                    external_uniforms=None, device=dev, per_path=True, **sym(s))
        if not all(torch.equal(a, b[s]) for a, b in zip(one, rows)):
            raise AssertionError(f"gated universe symbol {s} differs from the single kernel")
    (wc, wf, wrow, held), g_plain_ms = timed(lambda: cuda_gated.gated_universe_totals_reference(
        7, lv3, p3, s0_3, sg_3, gate, device=dev, chunk_blocks=64, per_path=True, work=True,
        **kw))
    for s in range(3):
        err, differ = compare_lifecycle(f"philox symbol {s}", (wc[s], wf[s], wrow[s]),
                                        (gc[s], gf[s], rows[2][s]), PHILOX_PATHS)
        g_err = max(g_err, err)
        if bool(differ.any()):
            raise AssertionError(f"gated universe symbol {s}: kernel and plain on the card "
                                 "differ")
    g_red_err = check_fold("mc_gated_universe_reduce_rows",
                           cuda_gated.reduce_rows_reference(*rows[:2]), (gc, gf))
    rows = rows[:2]
    run = lambda: cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate, device=dev, **kw)
    g_ms = cuda_ms(run, 3)
    # the noise terms add 2 Philox calls a double bar and a Box-Muller pair an entry
    g_ops = gated_ops(3 * PHILOX_PATHS, float(held.sum()), float(wc[:, 5].sum()))
    g_ops["imul"] *= 2
    g_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4, **g_ops)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*rows, what="mc_gated_universe_reduce_rows"),
                       20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*rows), 20)
    g_red_bound = card.bound(bytes_=fold_cols(rows, cuda_gated), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals the single kernel bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x {PHILOX_PATHS} paths with noise: kernel "
        f"{g_ms:.3f} ms, bound {g_bound['bound_ms']:.3f} ms {g_bound['bound_parts']}, plain "
        f"{g_plain_ms:.3f} ms; fold {g_red_ms:.4f} ms")
    pick = CARD_PLAIN_PICK
    n_cmp = len(pick)
    main_inputs("the gated universe", f"symbols {pick} of config #4's full-width launch, "
                "path by path")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                noise=None, external_uniforms=None, device=dev, per_path=True)
    sc, sf, srow, held = plain_picks(lambda i, lv, s0, sg: cuda_gated.gated_totals_reference(
        0, lv, params, num_paths=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, s0=s0, mu=0.0, sigma=sg,
        dt=DT, lanes=lanes, device=dev, chunk_blocks=64, per_path=True, work=True, symbol=i),
        c4, pick)
    got = fold(cuda_gated, cuda_gated.gated_universe_rows(0, c4[0], params, *c4[1:], **c4kw))
    g_err = max(g_err, same_on_card(
        "gated", (sc, sf, srow), tuple(x[pick] for x in got), n_cmp, UNI_SAMPLE_PATHS,
        lambda j: f"symbol {pick[j]}", engine=False))
    del srow, got
    log(f"[16] main path: mc_paths_gated_universe_fused, config #4's universe "
        f"({UNI_SYMBOLS} x {UNI_PATHS} paths)")
    st, secs, launches = run_entry(
        "mc_paths_gated_universe_fused", lambda: cuda_gated.mc_paths_gated_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_gated_universe": 2, "mc_gated_universe_reduce_rows": 2})
    check_universe_stats("gated universe", st, UNI_SYMBOLS, UNI_PATHS)
    g_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                  external_uniforms=None, device=dev)
    g_main_ms = cuda_ms(lambda: cuda_gated.gated_universe_rows(0, c4[0], params, *c4[1:],
                                                               **g_main), 2)
    g_main_bound = card.bound(
        bytes_=row_bytes(cuda_gated, UNI_SYMBOLS, UNI_PATHS),
        **gated_ops(UNI_SYMBOLS * UNI_PATHS,
                    float(held.sum()) * main_scale * UNI_SYMBOLS / n_cmp,
                    float(sc[:, 5].sum()) * main_scale * UNI_SYMBOLS / n_cmp))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {g_main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / g_main_ms * 1e3:.6e} paths/s), bound "
        f"{g_main_bound['bound_ms']:.3f} ms {g_main_bound['bound_parts']}")
    out += [entry("mc_gated_universe", GATED_SOURCE, GATED_UNI_REPLACES,
                  launches["mc_gated_universe"], g_err, g_ms, g_plain_ms, g_bound, symbols=3,
                  paths=PHILOX_PATHS, noise=True, main_path_ms=g_main_ms,
                  main_path_bound_ms=g_main_bound["bound_ms"], main_s=secs[1:]),
            entry("mc_gated_universe_reduce_rows", GATED_SOURCE, GATED_UNI_REPLACES,
                  launches["mc_gated_universe_reduce_rows"], g_red_err, g_red_ms,
                  g_red_plain_ms, g_red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 17: engine universe (kernel #10), BASELINE config #4 and its refresh
    lanes = ENGINE_LANES
    n_inj = nb * 8 * lanes
    log(f"[17] engine universe (mc_engine_rows_kernel, a row per symbol), injected "
        f"uniforms: 3 symbols x {n_inj} paths, [S] knobs and noise stds, kernel vs plain on "
        "CPU copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(602).uniform(
        1e-6, 1.0, (3, nb, EngineLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3)
    want = cuda_engine.engine_universe_totals_reference(0, lv3, p3e, s0_3, sg_3,
                                                        external_uniforms=u, per_path=True,
                                                        harvest=True, **kw)
    pc, pf, prow = cuda_engine.engine_universe_rows(0, lv3, p3e, s0_3, sg_3, device=dev,
                                                    external_uniforms=u.to(dev), per_path=True,
                                                    **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    *h_rows, h_c, h_s = cuda_engine.engine_universe_rows(
        0, lv3, p3e, s0_3, sg_3, device=dev, external_uniforms=u.to(dev), per_path=True,
        harvest=True, **kw)
    same_launch("engine universe, injected", (pc, pf, prow), h_rows)
    h_got = cuda_engine.reduce_harvest(h_c, h_s)
    torch.cuda.synchronize()
    e_err = 0.0
    for s in range(3):
        err, _ = compare_lifecycle(
            f"symbol {s}", (want[0][s], want[1][s], want[2][s]), (ec[s], ef[s], prow[s]), n_inj,
            engine=True,
            trace=lambda d: trace_engine_flips(f"symbol {s}", u[s], d, prow[s].cpu(),
                                               want[2][s].cpu(), grid_row(lv3, s),
                                               grid_row(p3e, s), {}, float(sg_3[s]),
                                               grid_row(noise3, s), False, dev,
                                               s0=float(s0_3[s])))
        e_err = max(e_err, err)
        check_harvest(f"symbol {s}", "mc_engine_wide_universe_harvest", hv_row(h_got, s),
                      hv_row(want[3], s), prow[s], want[2][s], 100.4)
    e_paths = UNI_ENGINE_PATHS
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the single kernel "
        f"(engine_rows) bit for bit, per path and skip counts included; at {e_paths} paths a "
        "symbol kernel vs plain on the card path by path")
    kw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None)
    for harvest in (False, True):
        rows = cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev,
                                                per_path=True, paths_per_symbol=PHILOX_PATHS,
                                                harvest=harvest, **kw)
        for s in range(3):
            one = cuda_engine.engine_rows(7, grid_row(lv3, s), grid_row(p3e, s),
                                          num_paths=PHILOX_PATHS, mu=0.0, device=dev,
                                          per_path=True, harvest=harvest,
                                          **dict(kw, noise=grid_row(noise3, s)), **sym(s))
            if not all(torch.equal(a, b[s]) for a, b in zip(one, rows)):
                raise AssertionError(f"engine universe symbol {s} differs from the single "
                                     "kernel" + (" (harvest)" if harvest else ""))
    log("  with the harvest too: each symbol's rows and harvest rows equal the single "
        "harvest kernel's bit for bit")
    same_as_parent("engine universe, Philox", cuda_engine,
                   lambda: cuda_engine.engine_universe_rows(
                       7, lv3, p3e, s0_3, sg_3, device=dev, per_path=True,
                       paths_per_symbol=PHILOX_PATHS, **kw))
    del rows, one
    kw = dict(kw, paths_per_symbol=e_paths)
    rows = cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev, per_path=True,
                                            **kw)
    ec, ef = cuda_engine.reduce_rows(*rows[:2])
    (wc, wf, wrow), e_plain_ms = timed(lambda: cuda_engine.engine_universe_totals_reference(
        7, lv3, p3e, s0_3, sg_3, device=dev, chunk_blocks=512, per_path=True, **kw))
    for s in range(3):
        err, differ = compare_lifecycle(f"card symbol {s}", (wc[s], wf[s], wrow[s]),
                                        (ec[s], ef[s], rows[2][s]), e_paths, engine=True)
        e_err = max(e_err, err)
        if bool(differ.any()):
            raise AssertionError(f"engine universe symbol {s}: kernel and plain on the card "
                                 "differ")
    e_red_err = check_fold("mc_engine_universe_reduce_rows",
                           cuda_engine.reduce_rows_reference(*rows[:2]), (ec, ef))
    rows = rows[:2]
    e_ms = cuda_ms(lambda: cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev,
                                                            **kw), 3)
    e_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                         **engine_ops(3 * e_paths, wc.sum(0).cpu(), 1.0))
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(
        *rows, what="mc_engine_universe_reduce_rows"), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*rows), 20)
    e_red_bound = card.bound(bytes_=fold_cols(rows, cuda_engine), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals the single kernel bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x {e_paths} paths with noise: kernel "
        f"{e_ms:.3f} ms, bound {e_bound['bound_ms']:.3f} ms {e_bound['bound_parts']}, plain "
        f"{e_plain_ms:.3f} ms; fold {e_red_ms:.4f} ms")
    pick = CARD_PLAIN_PICK
    n_cmp = len(pick)
    main_inputs("the engine universe", f"symbols {pick} of config #4's full-width launch, "
                "path by path")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev, per_path=True)
    (sc, sf, srow, shv), uh_plain_ms = timed(lambda: plain_picks(
        lambda i, lv, s0, sg: cuda_engine.engine_totals_reference(
            0, lv, params, num_paths=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, s0=s0, mu=0.0,
            sigma=sg, dt=DT, lanes=lanes, device=dev, chunk_blocks=512, per_path=True,
            symbol=i, harvest=True), c4, pick))
    HV_PLAIN["mc_engine_wide_universe_harvest"] = dict(
        ms=uh_plain_ms, paths=UNI_SAMPLE_PATHS, symbols=n_cmp, num_bars=NUM_BARS)
    k_rows = cuda_engine.engine_universe_rows(0, c4[0], params, *c4[1:], **c4kw)
    got = fold(cuda_engine, k_rows)
    e_err = max(e_err, same_on_card(
        "engine", (sc, sf, srow), tuple(x[pick] for x in got), n_cmp, UNI_SAMPLE_PATHS,
        lambda j: f"symbol {pick[j]}"))
    # the harvest: the full-width launch again with it, its rows those of the
    # launch without; the picked symbols against the plain version's harvest,
    # every symbol's harvest rows against its one-row launch
    *h_rows, h_c, h_s = cuda_engine.engine_universe_rows(0, c4[0], params, *c4[1:],
                                                         harvest=True, **c4kw)
    same_launch("config #4's universe", k_rows, h_rows)
    h_got = cuda_engine.reduce_harvest(h_c, h_s)
    for j, i in enumerate(pick):
        check_harvest(f"config #4 symbol {i}", "mc_engine_wide_universe_harvest",
                      hv_row(h_got, i), hv_row(shv, j), k_rows[2][i], srow[j], 2 * c4[1][i])
    for i in range(UNI_SYMBOLS):
        one = cuda_engine.engine_rows(0, grid_row(c4[0], i), params, num_paths=UNI_SAMPLE_PATHS,
                                      num_bars=NUM_BARS, s0=float(c4[1][i]), mu=0.0,
                                      sigma=float(c4[2][i]), dt=DT, lanes=lanes, device=dev,
                                      symbol=i, harvest=True)
        if not (torch.equal(one[2], h_c[i]) and torch.equal(one[3], h_s[i])
                and torch.equal(one[0], h_rows[0][i])):
            raise AssertionError(f"config #4 symbol {i}: the harvest rows differ from its "
                                 "one-row launch")
    log(f"  every one of config #4's {UNI_SYMBOLS} symbols: its harvest rows equal its "
        "one-row harvest launch bit for bit")
    del srow, got, k_rows, h_rows, one
    log(f"[17] main path: BASELINE config #4, mc_paths_engine_universe_fused ({UNI_SYMBOLS} "
        f"symbols x {UNI_PATHS} paths x {NUM_BARS} bars, sigma {UNI_SIGMA}, default params), "
        "one warm-up then timed")
    (st, skips, escal), secs, launches = run_entry(
        "mc_paths_engine_universe_fused", lambda: cuda_engine.mc_paths_engine_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_engine_rows_universe": 2, "mc_engine_universe_reduce_rows": 2})
    check_universe_stats("engine universe", st, UNI_SYMBOLS, UNI_PATHS)
    # one level a symbol: no next level to escalate to, so no escalation
    if not (tuple(skips.shape) == (UNI_SYMBOLS, 16) and bool((skips.sum(1) > 0).all())
            and tuple(escal.shape) == (UNI_SYMBOLS,)):
        raise AssertionError(f"engine universe: skips {tuple(skips.shape)}, escalations "
                             f"{tuple(escal.shape)}")
    log(f"  config #4 wall {secs[-1]:.3f} s ({UNI_SYMBOLS * UNI_PATHS / secs[-1]:.6e} paths/s "
        f"end to end); symbol 0: entered {int(st.n_entered[0])}, trades "
        f"{int(st.sum_trades[0])}, mean equity {float(st.mean_r[0]):.6f}, escalations "
        f"{int(escal[0])}")
    e_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                  external_uniforms=None, device=dev)
    e_main_ms = cuda_ms(lambda: cuda_engine.engine_universe_rows(0, c4[0], params, *c4[1:],
                                                                 **e_main), 1)
    e_main_parent_ms = cuda_ms(parent_run(cuda_engine, lambda: cuda_engine.engine_universe_rows(
        0, c4[0], params, *c4[1:], **e_main)), 1)
    e_main_bound = card.bound(
        bytes_=row_bytes(cuda_engine, UNI_SYMBOLS, UNI_PATHS),
        **engine_ops(UNI_SYMBOLS * UNI_PATHS, sc.sum(0).cpu(),
                     main_scale * UNI_SYMBOLS / n_cmp))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {e_main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / e_main_ms * 1e3:.6e} paths/s), bound "
        f"{e_main_bound['bound_ms']:.3f} ms {e_main_bound['bound_parts']}; the parent "
        f"{e_main_parent_ms:.3f} ms")
    log(f"[17] main path: BASELINE config #4 with the harvest (run_all.py:166-200), "
        f"mc_paths_engine_universe_fused(harvest=True), one warm-up then timed; the "
        "per-symbol refresh on it")
    (st_h, skips_h, escal_h, hv4), secs_h, launches_h = run_entry(
        "mc_paths_engine_universe_fused(harvest=True)",
        lambda: cuda_engine.mc_paths_engine_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT,
            harvest=True),
        reset, {"mc_engine_wide_universe_harvest": 2, "mc_engine_universe_reduce_rows": 2,
                "mc_engine_harvest_reduce_rows": 2})
    if not (torch.equal(st_h.hist, st.hist) and torch.equal(st_h.sum_r, st.sum_r)
            and torch.equal(skips_h, skips) and torch.equal(escal_h, escal)):
        raise AssertionError("config #4 with the harvest differs from config #4 without it")
    if not torch.equal(hv4.n_labeled.cpu(), (st.n_tp + st.n_stop).to(torch.int64).cpu()):
        raise AssertionError("config #4's harvest does not label every closed trade once")
    # the harvest build against the envelope kernel it is built from, forced
    # at config #4's shape (the launch without the harvest goes to the rows kernel)
    hv_t = interleaved_ms({
        "wide": forced(cuda_engine, lambda: cuda_engine.engine_universe_rows(
            0, c4[0], params, *c4[1:], **e_main)),
        "harvest": lambda: cuda_engine.engine_universe_rows(
            0, c4[0], params, *c4[1:], harvest=True, **e_main)})
    u_scale = main_scale * UNI_SYMBOLS / n_cmp
    HV_MAIN["mc_engine_wide_universe_harvest"] = dict(
        ms=hv_t["harvest"], ms_without=hv_t["wide"], ms_parent=e_main_ms, paths=UNI_PATHS,
        symbols=UNI_SYMBOLS,
        launches=launches_h["mc_engine_wide_universe_harvest"], config4_s=secs_h[1:],
        bound=harvest_bound(card, row_bytes(cuda_engine, UNI_SYMBOLS, UNI_PATHS), engine_ops(
            UNI_SYMBOLS * UNI_PATHS, sc.sum(0).cpu(), u_scale, NUM_BARS, 4),
            float(sc.sum(0)[5]) * u_scale, UNI_SYMBOLS, grid_size(UNI_PATHS)))
    log(f"  config #4 with the harvest: wall {secs_h[-1]:.3f} s, every statistic equal to the "
        f"run without; {int(hv4.n_labeled.sum())} labels; kernel alone {hv_t['harvest']:.3f} "
        f"ms, the envelope kernel without the harvest {hv_t['wide']:.3f} ms "
        f"({hv_t['harvest'] / hv_t['wide']:.4f}x; the rows kernel {e_main_ms:.3f} ms)")
    # the refresh on what config #4 harvested (run_all.py:196-200): the
    # per-symbol weighted bucket rows of ml_batch_from_harvest
    xs, ys, ws = HV.ml_batch_from_harvest(hv4, stop_padding=float(params.stop_padding))
    U.universe_policy_refresh(None, xs, ys, ws)
    model, refresh_ms = timed(lambda: U.universe_policy_refresh(None, xs, ys, ws))
    ref = U.universe_policy_refresh(None, xs.cpu().double(), ys.cpu(), ws.cpu().double(),
                                    device="cpu")
    if model.coef.device.type != dev.type or model.coef.dtype != torch.float32:
        raise AssertionError(f"the refresh ran on {model.coef.device} in {model.coef.dtype}")

    def proba(m, x):
        z = (x.cpu().double() @ m.coef.cpu().double()[..., None])[..., 0]
        return torch.sigmoid(z + m.intercept.cpu().double()[:, None])

    # the stop-padding feature is one constant beside the intercept: its
    # coefficient is float32 rounding at these weights (millions of labels;
    # the float64 fit puts it at ~0), so the fit is held by its
    # probabilities at every harvested row and by its other coefficients
    used = ws.cpu() > 0
    d_p = float((proba(model, xs) - proba(ref, xs)).abs()[used].max())
    d_coef = float((model.coef.cpu().double() - ref.coef)[:, [0, 2, 3]].abs().max())
    if not (d_p <= 1e-5 and d_coef <= 1e-4 and bool(torch.isfinite(model.coef).all())
            and bool(torch.isfinite(model.intercept).all())):
        raise AssertionError(f"the refresh on the harvest differs from its float64 CPU fit: "
                             f"probabilities {d_p}, coefficients {d_coef}")
    d_icpt = d_p
    log(f"  refresh: universe_policy_refresh on config #4's harvest (xs [{UNI_SYMBOLS}, 64, 4],"
        f" {int(ws.sum())} labels) float32 on the card {refresh_ms:.3f} ms (Newton steps "
        f"{model.n_iter.tolist()[:4]}...); vs the float64 CPU fit: max |d probability| "
        f"{d_p:.3e} at the harvested rows, max |d coef| (kind, touch count, side) "
        f"{d_coef:.3e}")
    out += [entry("mc_engine_rows_universe", ENGINE_ROWS_SOURCE, ENGINE_UNI_REPLACES,
                  launches["mc_engine_rows_universe"], e_err, e_ms, e_plain_ms, e_bound,
                  symbols=3, paths=e_paths, noise=True, main_path_ms=e_main_ms,
                  main_path_parent_ms=e_main_parent_ms,
                  main_path_bound_ms=e_main_bound["bound_ms"], config4_s=secs[1:],
                  refresh_ms=refresh_ms, refresh_max_abs_err=max(d_coef, d_icpt),
                  refresh_source="harvest"),
            entry("mc_engine_universe_reduce_rows", ENGINE_SOURCE, ENGINE_UNI_REPLACES,
                  launches["mc_engine_universe_reduce_rows"], e_red_err, e_red_ms,
                  e_red_plain_ms, e_red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 18: sweep of universes (kernel #11)
    stops = torch.tensor([[0.35, 0.25, 0.45], [0.20, 0.30, 0.25], [0.45, 0.35, 0.30]])
    qmin = torch.tensor([0.60, 0.45, 0.60])
    grid = params.replace(stop_padding=stops, q_min_prob=qmin)
    g_noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.02]),
                      entry_slip_std=torch.tensor([0.0, 0.0, 0.01]),
                      stop_slip_std=torch.tensor([0.0, 0.0, 0.015]),
                      target_slip_std=torch.tensor([0.0, 0.0, 0.015]))
    nb2 = 2
    n_inj = nb2 * 8 * lanes
    log(f"[18] sweep of universes (mc_engine_rows_kernel, S x G rows), injected uniforms: "
        f"3 symbols x 3 rows x {n_inj} paths ([S, G] stop paddings, [G] q_min and noise "
        "stds), kernel vs plain on CPU copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(603).uniform(
        1e-6, 1.0, (3, nb2, EngineLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=g_noise)
    want = cuda_engine.engine_universe_sweep_totals_reference(
        0, lv3, grid, s0_3, sg_3, external_uniforms=u, per_path=True, **kw)
    pc, pf, prow = cuda_engine.engine_universe_sweep_rows(
        0, lv3, grid, s0_3, sg_3, device=dev, external_uniforms=u.to(dev), per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc.flatten(0, 1), pf.flatten(0, 1))
    ec, ef = ec.view(3, 3, -1), ef.view(3, 3, -1)
    torch.cuda.synchronize()
    es_err = 0.0
    for s in range(3):
        for g in range(3):
            err, _ = compare_lifecycle(
                f"cell ({s}, {g})", (want[0][s, g], want[1][s, g], want[2][s, g]),
                (ec[s, g], ef[s, g], prow[s, g]), n_inj, engine=True,
                trace=lambda d: trace_engine_flips(
                    f"cell ({s}, {g})", u[s], d, prow[s, g].cpu(), want[2][s, g].cpu(),
                    grid_row(lv3, s),
                    params.replace(stop_padding=stops[s, g], q_min_prob=qmin[g]), {},
                    float(sg_3[s]), grid_row(g_noise, g), False, dev, s0=float(s0_3[s])))
            es_err = max(es_err, err)
    es_paths = UNI_SWEEP_PATHS
    log(f"  Philox at {es_paths} paths a symbol: cell (s, g) vs the engine universe at row "
        "g's knobs bit for bit, per path included; kernel vs plain on the card path by path")
    kw = dict(paths_per_symbol=es_paths, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=g_noise,
              external_uniforms=None)
    rows = cuda_engine.engine_universe_sweep_rows(7, lv3, grid, s0_3, sg_3, device=dev,
                                                  per_path=True, **kw)
    for g in range(3):
        uni = cuda_engine.engine_universe_rows(
            7, lv3, params.replace(stop_padding=stops[:, g], q_min_prob=qmin[g]), s0_3, sg_3,
            device=dev, per_path=True, **dict(kw, noise=grid_row(g_noise, g)))
        if not all(torch.equal(a, b[:, g]) for a, b in zip(uni, rows)):
            raise AssertionError(f"sweep-of-universes row {g} differs from the engine universe")
    same_as_parent("sweep of universes, Philox", cuda_engine,
                   lambda: cuda_engine.engine_universe_sweep_rows(7, lv3, grid, s0_3, sg_3,
                                                                  device=dev, per_path=True, **kw))
    ec, ef = cuda_engine.reduce_rows(rows[0].flatten(0, 1), rows[1].flatten(0, 1))
    (wc, wf, wrow), es_plain_ms = timed(
        lambda: cuda_engine.engine_universe_sweep_totals_reference(
            7, lv3, grid, s0_3, sg_3, device=dev, chunk_blocks=512, per_path=True, **kw))
    for s in range(3):
        for g in range(3):
            err, differ = compare_lifecycle(
                f"card cell ({s}, {g})", (wc[s, g], wf[s, g], wrow[s, g]),
                (ec[3 * s + g], ef[3 * s + g], rows[2][s, g]), es_paths, engine=True)
            es_err = max(es_err, err)
            if bool(differ.any()):
                raise AssertionError(f"cell ({s}, {g}): kernel and plain on the card differ")
    es_red_err = check_fold("mc_engine_universe_sweep_reduce_rows",
                            cuda_engine.reduce_rows_reference(rows[0].flatten(0, 1),
                                                              rows[1].flatten(0, 1)), (ec, ef))
    rows = tuple(x.flatten(0, 1) for x in rows[:2])
    es_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
        7, lv3, grid, s0_3, sg_3, device=dev, **kw), 3)
    es_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                          **engine_sweep_ops(3 * es_paths, [wc[:, g].sum(0).cpu()
                                                            for g in range(3)], 1.0))
    es_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(
        *rows, what="mc_engine_universe_sweep_reduce_rows"), 20)
    es_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*rows), 20)
    es_red_bound = card.bound(bytes_=fold_cols(rows, cuda_engine), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every cell equals the engine universe bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x 3 x {es_paths} paths with noise: kernel "
        f"{es_ms:.3f} ms, bound {es_bound['bound_ms']:.3f} ms {es_bound['bound_parts']}, plain "
        f"{es_plain_ms:.3f} ms; fold {es_red_ms:.4f} ms")
    cfgs = [EngineParams.default(),
            EngineParams.default(stop_padding=0.20, tp_padding=0.40),
            EngineParams.default(q_min_prob=0.40, enable_veto=False),
            EngineParams.default(overtouch_limit=2, cooldown_s=180.0)]
    grid4 = stack_params(cfgs)
    c8 = config4(UNI_SWEEP_SYMBOLS)
    main_inputs("the sweep of universes", f"config #4's first {UNI_SWEEP_SYMBOLS} symbols x "
                "4 rows, path by path")
    c8kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev, per_path=True)
    sc, sf, srow = cuda_engine.engine_universe_sweep_totals_reference(
        0, c8[0], grid4, *c8[1:], chunk_blocks=512, **c8kw)
    krows = cuda_engine.engine_universe_sweep_rows(0, c8[0], grid4, *c8[1:], **c8kw)
    es_err = max(es_err, same_on_card(
        "engine", tuple(x.flatten(0, 1) for x in (sc, sf, srow)),
        fold(cuda_engine, tuple(x.flatten(0, 1) for x in krows)), UNI_SWEEP_SYMBOLS * 4,
        UNI_SAMPLE_PATHS, lambda i: f"cell ({i // 4}, {i % 4})"))
    del srow, krows
    log(f"[18] main path: mc_paths_engine_universe_sweep_fused, config #4's first "
        f"{UNI_SWEEP_SYMBOLS} symbols x the 4 configurations of "
        f"tests/test_pallas_engine.py:320-325 x {UNI_PATHS} paths")
    (st, skips, escal), secs, launches = run_entry(
        "mc_paths_engine_universe_sweep_fused",
        lambda: cuda_engine.mc_paths_engine_universe_sweep_fused(
            0, c8[0], grid4, *c8[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_engine_rows_universe_sweep": 2, "mc_engine_universe_sweep_reduce_rows": 2})
    if tuple(st.n.shape) != (UNI_SWEEP_SYMBOLS, 4) or not bool((st.n == UNI_PATHS).all()):
        raise AssertionError(f"sweep of universes: counts {st.n.tolist()}")
    if not (bool((st.n_entered > 0).all()) and bool(torch.isfinite(st.sum_r).all())
            and len({tuple(x) for x in skips[0].tolist()}) == 4):
        raise AssertionError("sweep of universes: a cell never entered, a non-finite sum, or "
                             "two rows deciding alike")
    es_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                   external_uniforms=None, device=dev)
    es_main_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
        0, c8[0], grid4, *c8[1:], **es_main), 1)
    es_main_bound = card.bound(
        bytes_=row_bytes(cuda_engine, UNI_SWEEP_SYMBOLS * 4, UNI_PATHS),
        **engine_sweep_ops(UNI_SWEEP_SYMBOLS * UNI_PATHS, [sc[:, g].sum(0).cpu()
                                                           for g in range(4)], main_scale))
    log(f"  kernel alone at {UNI_SWEEP_SYMBOLS} x 4 x {UNI_PATHS}: {es_main_ms:.3f} ms "
        f"({UNI_SWEEP_SYMBOLS * 4 * UNI_PATHS / es_main_ms * 1e3:.6e} paths x rows/s), bound "
        f"{es_main_bound['bound_ms']:.3f} ms {es_main_bound['bound_parts']}")
    out += [entry("mc_engine_rows_universe_sweep", ENGINE_ROWS_SOURCE,
                  ENGINE_UNI_SWEEP_REPLACES, launches["mc_engine_rows_universe_sweep"], es_err,
                  es_ms, es_plain_ms, es_bound,
                  symbols=3, grid_rows=3, paths=es_paths, noise=True, main_path_ms=es_main_ms,
                  main_path_bound_ms=es_main_bound["bound_ms"], main_s=secs[1:]),
            entry("mc_engine_universe_sweep_reduce_rows", ENGINE_SOURCE,
                  ENGINE_UNI_SWEEP_REPLACES, launches["mc_engine_universe_sweep_reduce_rows"],
                  es_red_err, es_red_ms, es_red_plain_ms, es_red_bound,
                  rows=int(rows[0].shape[1]), cells=9)]
    return out

# ---- the correlated books (kernels #7, #12): the CLI's ``book`` at 100
# symbols x 2^20 paths x 40 bars, BASELINE config #4's scale, spots 100 ..
# 199, sigma 0.3, betas from 0.2 to 0.8, equal weights
BOOK_SYMBOLS = 100
BOOK_PATHS = 1 << 20
BOOK_SAMPLE_PATHS = 1 << 16    # a symbol: the main path's inputs, kernel vs plain on the card
BOOK_S0 = [100.0 + i for i in range(BOOK_SYMBOLS)]
BOOK_BETAS = [0.2 + 0.6 * i / (BOOK_SYMBOLS - 1) for i in range(BOOK_SYMBOLS)]
BOOK3_BETAS = (0.8, 0.6, 0.3)
BOOK3_WEIGHTS = (0.5, 0.3, 0.2)
GATED_CORR_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:2421"
ENGINE_CORR_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2692"


def book_market_ops(n_paths: float, n_sym: int, num_bars: int = NUM_BARS) -> dict:
    """The operations a book adds to its symbols' lifecycles, the market
    counted once a path: a Box-Muller pair a double-bar step (logf, sqrtf,
    sincosf; half a Philox call, two rows of four words), the mix and the
    curve's fused multiply-add a symbol and bar, the fold a bar."""
    pairs = n_paths * num_bars / 2
    f32 = 4 * pairs + n_paths * num_bars * (n_sym * 4 + 3)
    return dict(f32=f32, sfu=2 * pairs, imul=PHILOX_IMULS * pairs / 2)


def book_argv(engine: bool) -> list:
    """The main path's ``book`` arguments."""
    return (["book"] + (["--engine"] if engine else [])
            + ["--backend", "cuda", "--num-symbols", str(BOOK_SYMBOLS), "--num-paths",
               str(BOOK_PATHS), "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA),
               "--s0s", ",".join(repr(x) for x in BOOK_S0),
               "--betas", ",".join(repr(x) for x in BOOK_BETAS)])


def check_book_output(lines: list, n_sym: int, engine: bool) -> None:
    """A ``book`` run's rows: one a symbol with the JAX CLI's keys in its
    order, then the book's; finite, hit rates in (0, 1), the book's VaR below
    its mean and its drawdowns ordered."""
    keys = ["symbol", "beta", "weight", "hit_rate", "mean_r", "mean_trades", "max_dd"]
    keys += ["escalations"] if engine else []
    if len(lines) != n_sym + 1:
        raise AssertionError(f"{len(lines)} book rows, not {n_sym + 1}")
    for s, row in enumerate(lines[:-1]):
        if list(row) != keys or row["symbol"] != s:
            raise AssertionError(f"book row {s}: keys {list(row)}, not {keys}")
        if not row["mean_trades"] >= 1.0:
            raise AssertionError(f"book row {s}: fewer trades than entered paths: {row}")
    port = lines[-1]
    if list(port) != ["portfolio", "mean_r", "std_r", "var_05", "cvar_05", "max_dd",
                      "mean_dd"] or port["portfolio"] is not True:
        raise AssertionError(f"book row: {port}")
    if not (port["cvar_05"] <= port["var_05"] <= port["mean_r"]
            and port["max_dd"] >= port["mean_dd"] >= 0.0 and port["std_r"] > 0.0):
        raise AssertionError(f"book risk out of order: {port}")


def check_book_harvest_output(lines: list, plain: list) -> None:
    """``book --engine --harvest``'s rows: the rows of the run without it,
    each symbol's with its ``labeled`` count (> 0) and the four coefficients
    of its refreshed ML gate (finite) after them."""
    if len(lines) != len(plain) or lines[-1] != plain[-1]:
        raise AssertionError("book --harvest: its book row or row count differs from the "
                             "run without")
    for r, b in zip(lines[:-1], plain[:-1]):
        keys = [k for k in r if k not in ("labeled", "ml_coef")]
        if list(r)[-2:] != ["labeled", "ml_coef"] or {k: r[k] for k in keys} != b:
            raise AssertionError(f"book --harvest: a symbol row differs: {r} vs {b}")
        if not (r["labeled"] > 0 and len(r["ml_coef"]) == 4
                and all(math.isfinite(c) for c in r["ml_coef"])):
            raise AssertionError(f"book --harvest: a symbol's labels or coefficients: {r}")
    log(f"  every symbol row carries labeled and ml_coef (symbol 0: {lines[0]['labeled']:.0f} "
        f"labels, coef {lines[0]['ml_coef']}); every other key as without --harvest")


def book_phases(dev, card, reset, cli) -> list:
    """Phases 19-20: the two book kernels against their plain versions and
    the universe kernels, and the CLI's ``book`` / ``book --engine`` at the
    main-path size; returns their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
    from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.guard import GuardParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.touch import TouchMemoryParams
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import SKIP_REASONS, engine_knobs
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    params = EngineParams.default()
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = np.array(UNI3_S0, np.float32), np.array(UNI3_SIGMA, np.float32)
    b3, w3 = np.array(BOOK3_BETAS, np.float32), np.array(BOOK3_WEIGHTS, np.float32)
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    p3e = p3.replace(q_min_prob=[0.60, 0.40, 0.55])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    # the main path's book: the CLI's level scaffold around each spot
    lv100 = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                             {"color": "orange", "type": "dashed", "index": 0,
                              "price": x + 0.4}] for x in BOOK_S0], max_levels=4)
    s0_100 = np.array(BOOK_S0, np.float32)
    sg_100 = np.full(BOOK_SYMBOLS, SIGMA, np.float32)
    b100 = np.array(BOOK_BETAS, np.float32)
    w100 = np.full(BOOK_SYMBOLS, 1.0 / BOOK_SYMBOLS, np.float32)
    book100 = (lv100, params, s0_100, sg_100, b100, w100)
    main_scale = BOOK_PATHS / BOOK_SAMPLE_PATHS
    out = []

    def book_trace(name, differ, kernel_rows, cpu_rows, symbol_runs, weights):
        """Phase 6's trace for the book's differing paths: every symbol's
        plain lifecycle over the bars the plain version makes on the CPU and
        over those it makes on the card (``symbol_runs(s, on_card, idx)`` ->
        (equity f32[n, W], rows f32[n, 6], integer state int[n, W, k])),
        combined as the book combines them (``sim/book.BookCurve``).  The
        card's combine equals the kernel's book row exactly, the CPU's the
        plain row, and on every differing path some symbol's integer state
        parts between the two at some bar (a decision flipped; its final row
        may agree with the plain one, as a close a bar later does)."""
        from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_gated import lifecycle_rows
        from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import BookCurve
        from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import LifecycleOutcome

        idx = torch.nonzero(differ).flatten()
        if idx.numel() == 0:
            return
        parted = torch.zeros(idx.numel(), dtype=torch.bool)
        books = []
        runs = [[symbol_runs(s, on_card, idx) for s in range(len(weights))]
                for on_card in (False, True)]
        for side in runs:
            book = BookCurve(idx.numel(), NUM_BARS)
            for (eq, rows, _), w in zip(side, weights):
                book.add_curve(float(w), eq.T.contiguous())
                book.add_symbol(LifecycleOutcome(
                    equity=rows[:, 0], trades=rows[:, 1].int(), wins=rows[:, 2].int(),
                    losses=rows[:, 3].int(), open_at_end=rows[:, 4] > 0, max_dd=rows[:, 5]))
            books.append(lifecycle_rows(book.outcome()))
        for (_, _, i_cpu), (_, _, i_dev) in zip(*runs):
            parted |= (i_cpu != i_dev).flatten(1).any(dim=1)
        if not torch.equal(books[1], kernel_rows[idx][:, :6]):
            raise AssertionError(f"{name}: the kernel's book differs from the plain book "
                                 "on the card's bars")
        if not torch.equal(books[0], cpu_rows[idx][:, :6]):
            raise AssertionError(f"{name}: the traced book differs from the plain version")
        if not bool(parted.all()):
            raise AssertionError(f"{name}: a differing book path shows no flipped decision "
                                 "in any symbol")
        log(f"  {name} book: {idx.numel()} differing paths, each traced to a flipped "
            "decision of a symbol; kernel == plain book on the card's bars")

    def injected(name, mod, want, got, n, trace_one, trace_book):
        err = 0.0
        for s in range(3):
            e, _ = compare_lifecycle(
                f"{name} symbol {s}", (want[0][s], want[1][s], want[2][s]),
                (got[0][s], got[1][s], got[2][s]), n, engine=mod is cuda_engine,
                trace=lambda dd: trace_one(s, dd))
            err = max(err, e)
        e, _ = compare_lifecycle(
            f"{name} book", (want[0][3], want[1][3], want[2][3]),
            (got[0][3], got[1][3], got[2][3]), n, engine=mod is cuda_engine,
            trace=lambda dd: book_trace(name, dd, got[2][3].cpu(), want[2][3].cpu(),
                                        trace_book, w3))
        return max(err, e)

    def beta0_and_one_symbol(name, rows_fn, uni_fn, one_fn, paths, hv_fns=None):
        """At ``paths`` a symbol (one path a thread: a book CTA's rows then add
        its paths in the universe's order, so its float sums are the
        universe's too); ``hv_fns``: the harvest launches of the two, whose
        harvest rows must agree as well."""
        a = rows_fn(0.0, paths)
        b = uni_fn(paths)
        if not all(torch.equal(x[:3], y) for x, y in zip(a, b)):
            raise AssertionError(f"{name} at beta 0 differs from the universe kernel")
        if hv_fns is not None:
            a, b = hv_fns[0](0.0, paths), hv_fns[1](paths)
            if not all(torch.equal(x, y) for x, y in zip(a[-2:], b[-2:])):
                raise AssertionError(f"{name} at beta 0: its symbols' harvest rows differ "
                                     "from the universe harvest kernel's")
            log("  with the harvest: every symbol's harvest rows at beta 0 equal the "
                "universe's (its one-row launches') bit for bit")
        c, f, r = one_fn(paths)
        cols = [0, 1, 2, 3, 4, 5]
        if not (torch.equal(r[1][:, :6], r[0][:, :6]) and torch.equal(f[1], f[0])
                and torch.equal(c[1][cols], c[0][cols])
                and torch.equal(c[1][-128:], c[0][-128:])):
            raise AssertionError(f"{name}: the one-symbol book of weight 1 differs from its "
                                 "symbol")
        log(f"  Philox at {paths} paths a symbol: every symbol of the book at beta 0 equals "
            "the universe kernel's bit for bit (partial and per-path rows); a one-symbol "
            "book of weight 1 equals its symbol's row bit for bit")

    def book_row(i):
        return "the book" if i == BOOK_SYMBOLS else f"symbol {i}"

    def alone(name, rows_fn):
        rows_fn()                                        # warm
        ms = cuda_ms(rows_fn, 2)
        log(f"  {name} alone at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {ms:.3f} ms "
            f"({BOOK_SYMBOLS * BOOK_PATHS / ms * 1e3:.6e} paths x symbols/s)")
        return ms

    # ---- phase 19: the gated book (kernel #7)
    lanes = GATED_LANES
    gate = GateConfig.from_params(params)
    nb = GATED_INJECT_BLOCKS
    n_inj = nb * 8 * lanes
    log(f"[19] gated book (mc_gated_corr_kernel), injected uniforms: 3 symbols x {n_inj} "
        "paths (own levels, s0, sigma, beta, weight, knobs, [S] noise stds), antithetic, "
        "kernel vs plain on CPU copies path by path, every differing path traced")
    rng = np.random.default_rng(700)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (3, nb, GatedLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    um = torch.from_numpy(rng.uniform(1e-9, 1.0, (nb, NUM_BARS, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3,
              antithetic=True, per_path=True)
    want = cuda_gated.gated_corr_totals_reference(0, lv3, p3, s0_3, sg_3, b3, w3, gate,
                                                  external_uniforms=u, market_uniforms=um,
                                                  **kw)
    pc, pf, prow = cuda_gated.gated_corr_rows(0, lv3, p3, s0_3, sg_3, b3, w3, gate, device=dev,
                                              external_uniforms=u.to(dev),
                                              market_uniforms=um.to(dev), **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    def gated_runs(s, on_card, idx):
        src = dev if on_card else torch.device("cpu")
        bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(
            u[s].to(src), GatedLayout(NUM_BARS, True), s0=float(s0_3[s]), mu=0.0,
            sigma=float(sg_3[s]), dt=DT, antithetic=True, market_uniforms=um.to(src),
            beta=float(b3[s]))
        pick = type(bars)(*(x[idx.to(src)].cpu() for x in bars))
        out, ints, floats = lifecycle_trace(pick, tie[idx.to(src)].cpu(),
                                            nzs[:, idx.to(src)].cpu(), grid_row(lv3, s),
                                            grid_row(p3, s), gate, grid_row(noise3, s))
        return floats[:, :, 3], cuda_gated.lifecycle_rows(out), ints

    g_err = injected("gated", cuda_gated, want, (gc, gf, prow), n_inj,
                     lambda s, d: trace_flips(
                         f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(),
                         grid_row(lv3, s), grid_row(p3, s), gate, grid_row(noise3, s), True,
                         dev, s0=float(s0_3[s]), sigma=float(sg_3[s]),
                         market=(um, float(b3[s]))), gated_runs)
    g_red_err = check_fold("mc_gated_corr_reduce_rows",
                           cuda_gated.reduce_rows_reference(pc, pf), (gc, gf))
    gkw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None,
               device=dev, per_path=True)
    beta0_and_one_symbol(
        "the gated book",
        lambda beta, n: cuda_gated.gated_corr_rows(7, lv3, p3, s0_3, sg_3, beta, w3, gate,
                                                   paths_per_symbol=n, **gkw),
        lambda n: cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate,
                                                 paths_per_symbol=n, **gkw),
        lambda n: (lambda r: (*cuda_gated.reduce_rows(r[0], r[1]), r[2]))(
            cuda_gated.gated_corr_rows(7, U.stack_levels(UNI3_ROWS[:1], max_levels=8),
                                       params, [100.0], [SIGMA], [0.7], [1.0], gate,
                                       paths_per_symbol=n, **dict(gkw, noise=None))),
        BOOK_PATHS)
    pick = CARD_PLAIN_PICK
    n_cmp = len(pick)
    cmp_book = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0,
                                  "price": BOOK_S0[i]},
                                 {"color": "orange", "type": "dashed", "index": 0,
                                  "price": BOOK_S0[i] + 0.4}] for i in pick], max_levels=4),
                params) + tuple(x[pick] for x in book100[2:])
    log(f"  on the main path's inputs (its symbols {pick}, a book of their own) at "
        f"{BOOK_SAMPLE_PATHS} paths a symbol, Philox: kernel vs plain on the card, path by path")
    skw = dict(paths_per_symbol=BOOK_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
               noise=None, external_uniforms=None, device=dev, per_path=True)
    (sc, sf, srow, held), g_plain_ms = timed(lambda: cuda_gated.gated_corr_totals_reference(
        0, *cmp_book, chunk_blocks=64, work=True, **skw))
    krows = cuda_gated.gated_corr_rows(0, *cmp_book, **skw)
    g_err = max(g_err, same_on_card(
        "gated book", (sc, sf, srow), (*cuda_gated.reduce_rows(krows[0], krows[1]), krows[2]),
        n_cmp + 1, BOOK_SAMPLE_PATHS, lambda i: "the book" if i == n_cmp else f"symbol {i}",
        engine=False))
    del srow, krows
    g_sample_ms = cuda_ms(lambda: cuda_gated.gated_corr_rows(0, *cmp_book, **dict(
        skw, per_path=False)), 2)
    main = dict(paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                external_uniforms=None, device=dev)
    g_main_ms = alone("the gated book kernel",
                      lambda: cuda_gated.gated_corr_rows(0, *book100, **main))
    cmp_scale = main_scale * BOOK_SYMBOLS / n_cmp    # the sample's work, for all 100
    g_ops = gated_ops(BOOK_SYMBOLS * BOOK_PATHS, float(held.sum()) * cmp_scale,
                      float(sc[:-1, 5].sum()) * cmp_scale)
    for k, v in book_market_ops(BOOK_PATHS, BOOK_SYMBOLS).items():
        g_ops[k] += v
    g_rows = cuda_gated.gated_corr_rows(0, *book100, **main)
    g_row_bytes = g_rows[0].numel() * 8 + g_rows[1].numel() * 4
    g_bound = card.bound(bytes_=g_row_bytes, **g_ops)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_rows, what="mc_gated_corr_reduce_rows"),
                       20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_rows), 20)
    g_red_bound = card.bound(bytes_=g_row_bytes + (BOOK_SYMBOLS + 1) * (
        cuda_gated.ROW_COUNTS * 8 + cuda_gated.ROW_FLOATS * 8), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  bound at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {g_bound['bound_ms']:.3f} ms "
        f"{g_bound['bound_parts']}; plain on the card at {n_cmp} x "
        f"{BOOK_SAMPLE_PATHS} paths {g_plain_ms:.3f} ms (kernel there {g_sample_ms:.3f} ms); "
        f"fold of {BOOK_SYMBOLS + 1} x {grid_size(BOOK_PATHS)} rows {g_red_ms:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        db = ["--db", os.path.join(tmp, "smoke.db")]
        log(f"[19] main path: cli book --backend cuda, {BOOK_SYMBOLS} symbols x {BOOK_PATHS} "
            f"paths x {NUM_BARS} bars (spots {BOOK_S0[0]:g}..{BOOK_S0[-1]:g}, sigma {SIGMA}, "
            "betas 0.2..0.8, equal weights)")
        lines, g_secs, g_launches = run_cli(
            cli, db + book_argv(False), reset,
            {"mc_gated_corr": 1, "mc_gated_corr_reduce_rows": 1},
            work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
        check_book_output(lines, BOOK_SYMBOLS, False)
        log(f"  book row: {json.dumps(lines[-1])}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(db + ["book", "--backend", "cuda"])
        dflt = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
        if rc != 0:
            raise AssertionError(f"cli book (defaults) exited {rc}")
        check_book_output(dflt, 8, False)
        log(f"  cli book --backend cuda at its defaults (8 x {1 << 16}): {len(dflt)} rows in "
            "the JAX CLI's form")
    out += [entry("mc_gated_corr", GATED_CORR_SOURCE, GATED_CORR_REPLACES,
                  g_launches["mc_gated_corr"], g_err, g_main_ms, g_plain_ms, g_bound,
                  symbols=BOOK_SYMBOLS, paths=BOOK_PATHS, plain_paths=BOOK_SAMPLE_PATHS,
                  kernel_ms_at_plain_size=g_sample_ms, cli_s=g_secs[1:]),
            entry("mc_gated_corr_reduce_rows", GATED_SOURCE, GATED_CORR_REPLACES,
                  g_launches["mc_gated_corr_reduce_rows"], g_red_err, g_red_ms, g_red_plain_ms,
                  g_red_bound, rows=int(g_rows[0].shape[1]), segments=BOOK_SYMBOLS + 1)]
    del g_rows

    # ---- phase 20: the engine book (kernel #12)
    lanes = ENGINE_LANES
    n_inj = ENGINE_INJECT_BLOCKS * 8 * lanes
    w_pass = np.zeros((3, 7), np.float32)
    w_pass[0, 0], w_pass[0, 6] = -0.6, 20.0     # phase 9's policy that lets longs
    w_pass[1, 0], w_pass[1, 6] = -0.2, 20.0     # through from bar ~20, shorts from ~12
    w_pass[2, 0] = -1.0
    armed = dict(policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_pass)),
                 ml_model=MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2],
                                                        np.float32), 0.55))
    accumulating = dict(
        guard_params=GuardParams.default().replace(min_bars=6, compression_bp=300.0),
        touch_params=TouchMemoryParams.default().replace(
            max_bounces=1, min_time_gap_ms=120_000, fatigue_vol_k=0.0))
    e_err = 0.0
    for case, gates, sig, nz, anti, blocks in (
            ("ml and policy gates armed, noise, antithetic", armed, sg_3, noise3, True,
             ENGINE_INJECT_BLOCKS),
            ("accumulation", accumulating, np.full(3, 0.05, np.float32), None, False, 4)):
        n = blocks * 8 * lanes
        log(f"[20] engine book (mc_engine_book_rows_kernel), injected uniforms: 3 symbols x "
            f"{n} paths ([S] knobs, beta, weight), {case}: kernel vs plain on CPU copies path "
            "by path, every differing path traced; kernel vs the parent bit for bit")
        rng = np.random.default_rng(800 + blocks)
        u = torch.from_numpy(rng.uniform(1e-6, 1.0, (
            3, blocks, EngineLayout(NUM_BARS, nz is not None).u_rows, 8, lanes)).astype(
                np.float32))
        um = torch.from_numpy(rng.uniform(1e-6, 1.0, (blocks, NUM_BARS, 8, lanes)).astype(
            np.float32))
        kw = dict(paths_per_symbol=n, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=nz,
                  antithetic=anti, per_path=True, **gates)
        want = cuda_engine.engine_corr_totals_reference(0, lv3, p3e, s0_3, sig, b3, w3,
                                                        external_uniforms=u,
                                                        market_uniforms=um, harvest=True,
                                                        **kw)

        def inj(kw=kw, sig=sig, u=u, um=um):
            return cuda_engine.engine_corr_rows(0, lv3, p3e, s0_3, sig, b3, w3, device=dev,
                                                external_uniforms=u.to(dev),
                                                market_uniforms=um.to(dev), **kw)

        pc, pf, prow = inj()
        same_as_parent(f"engine book, {case}", cuda_engine, inj)
        ec, ef = cuda_engine.reduce_rows(pc, pf)
        *h_rows, h_c, h_s = cuda_engine.engine_corr_rows(
            0, lv3, p3e, s0_3, sig, b3, w3, device=dev, external_uniforms=u.to(dev),
            market_uniforms=um.to(dev), harvest=True, **kw)
        same_launch(f"engine book, {case}", (pc, pf, prow), h_rows)
        h_got = cuda_engine.reduce_harvest(h_c, h_s)
        torch.cuda.synchronize()
        def engine_runs(s, on_card, idx, u=u, um=um, gates=gates, sig=sig, nz=nz, anti=anti):
            src = dev if on_card else torch.device("cpu")
            bars, tie, nzs = cuda_engine.engine_bars_from_uniforms(
                u[s].to(src), EngineLayout(NUM_BARS, nz is not None), s0=float(s0_3[s]),
                mu=0.0, sigma=float(sig[s]), dt=DT, antithetic=anti,
                market_uniforms=um.to(src), beta=float(b3[s]))
            pick = type(bars)(*(x[idx.to(src)] for x in bars))
            rows, ints, eq, _ = engine_trace(pick, tie[idx.to(src)],
                                          None if nzs is None else nzs[:, idx.to(src)],
                                          grid_row(lv3, s), grid_row(p3e, s),
                                          engine_knobs(**gates), grid_row(nz, s), src)
            return eq, rows[:, :6], ints

        e_err = max(e_err, injected(
            "engine", cuda_engine, want, (ec, ef, prow), n,
            lambda s, d: trace_engine_flips(
                f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(), grid_row(lv3, s),
                grid_row(p3e, s), gates, float(sig[s]), grid_row(nz, s), anti, dev,
                s0=float(s0_3[s]), market=(um, float(b3[s]))), engine_runs))
        for s in range(3):
            check_harvest(f"book symbol {s}, {case}", "mc_engine_wide_corr_harvest",
                          hv_row(h_got, s), hv_row(want[3], s), prow[s], want[2][s], 100.4)
        skips = ec[:3, 7:23].sum(dim=0).tolist()
        named = dict(zip((r.name for r in SKIP_REASONS), skips))
        if case == "accumulation" and not (named["EDGE_FATIGUE"] + named["TOUCH_BUDGET"]
                                           + named["TOUCH_COOLDOWN"]) > 0:
            raise AssertionError(f"accumulation case: no accumulation gate fired: {named}")
        if case.startswith("ml and policy") and not (
                (named["ML_CONF_LOW"] > 0 or named["ONLINE_POLICY"] > 0) and int(ec[3, 5]) > 0):
            raise AssertionError(f"{case}: a gate never fired or nothing entered: {named}")
        if bool(ec[3, 6:23].any()):
            raise AssertionError("the engine book's escalation and skip columns are not zero")
    e_red_err = check_fold("mc_engine_corr_reduce_rows",
                           cuda_engine.reduce_rows_reference(pc, pf), (ec, ef))
    ekw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None,
               device=dev, per_path=True)
    beta0_and_one_symbol(
        "the engine book",
        lambda beta, n: cuda_engine.engine_corr_rows(7, lv3, p3e, s0_3, sg_3, beta, w3,
                                                     paths_per_symbol=n, **ekw),
        lambda n: cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3,
                                                   paths_per_symbol=n, **ekw),
        lambda n: (lambda r: (*cuda_engine.reduce_rows(r[0], r[1]), r[2]))(
            cuda_engine.engine_corr_rows(7, U.stack_levels(UNI3_ROWS[:1], max_levels=8),
                                         params, [100.0], [SIGMA], [0.7], [1.0],
                                         paths_per_symbol=n, **dict(ekw, noise=None))),
        BOOK_PATHS,
        (lambda beta, n: cuda_engine.engine_corr_rows(
            7, lv3, p3e, s0_3, sg_3, beta, w3, paths_per_symbol=n, harvest=True,
            **dict(ekw, per_path=False)),
         lambda n: cuda_engine.engine_universe_rows(
             7, lv3, p3e, s0_3, sg_3, paths_per_symbol=n, harvest=True,
             **dict(ekw, per_path=False))))
    pick = CARD_PLAIN_PICK
    n_cmp = len(pick)
    log(f"  on the main path's inputs (its symbols {pick}, a book of their own) at "
        f"{BOOK_SAMPLE_PATHS} paths a symbol, Philox: kernel vs plain on the card, path by path")
    skw = dict(paths_per_symbol=BOOK_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
               noise=None, external_uniforms=None, device=dev, per_path=True)
    cmp_book = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0,
                                  "price": BOOK_S0[i]},
                                 {"color": "orange", "type": "dashed", "index": 0,
                                  "price": BOOK_S0[i] + 0.4}] for i in pick], max_levels=4),
                params) + tuple(x[pick] for x in book100[2:])
    (sc, sf, srow, shv), e_plain_ms = timed(lambda: cuda_engine.engine_corr_totals_reference(
        0, *cmp_book, chunk_blocks=64, harvest=True, **skw))
    krows = cuda_engine.engine_corr_rows(0, *cmp_book, **skw)
    same_as_parent("the main path's book sample", cuda_engine,
                   lambda: cuda_engine.engine_corr_rows(0, *cmp_book, **skw))
    e_err = max(e_err, same_on_card(
        "engine book", (sc, sf, srow), (*cuda_engine.reduce_rows(krows[0], krows[1]), krows[2]),
        n_cmp + 1, BOOK_SAMPLE_PATHS, lambda i: "the book" if i == n_cmp else f"symbol {i}"))
    *h_rows, h_c, h_s = cuda_engine.engine_corr_rows(0, *cmp_book, harvest=True, **skw)
    same_launch("the main path's book sample", krows, h_rows)
    h_got = cuda_engine.reduce_harvest(h_c, h_s)
    for j in range(n_cmp):
        check_harvest(f"book sample symbol {pick[j]}", "mc_engine_wide_corr_harvest",
                      hv_row(h_got, j), hv_row(shv, j), krows[2][j], srow[j],
                      2 * BOOK_S0[pick[j]])
    del srow, krows, h_rows
    e_sample_ms = cuda_ms(lambda: cuda_engine.engine_corr_rows(0, *cmp_book, **dict(
        skw, per_path=False)), 1)
    main = dict(paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                external_uniforms=None, device=dev)
    e_main_ms = alone("the engine book kernel",
                      lambda: cuda_engine.engine_corr_rows(0, *book100, **main))
    e_main_parent_ms = cuda_ms(parent_run(
        cuda_engine, lambda: cuda_engine.engine_corr_rows(0, *book100, **main)), 1)
    log(f"  the parent (mc_engine_corr_kernel) at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: "
        f"{e_main_parent_ms:.3f} ms")
    sc = sc.cpu()
    # the sample's work, for all 100 symbols' paths
    e_ops = engine_ops(BOOK_SYMBOLS * BOOK_PATHS, sc[:-1].sum(0),
                       main_scale * BOOK_SYMBOLS / n_cmp)
    for k, v in book_market_ops(BOOK_PATHS, BOOK_SYMBOLS).items():
        e_ops[k] += v
    e_rows = cuda_engine.engine_corr_rows(0, *book100, **main)
    e_row_bytes = e_rows[0].numel() * 8 + e_rows[1].numel() * 4
    e_bound = card.bound(bytes_=e_row_bytes, **e_ops)
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_rows,
                                                       what="mc_engine_corr_reduce_rows"), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_rows), 20)
    e_red_bound = card.bound(bytes_=e_row_bytes + (BOOK_SYMBOLS + 1) * (
        cuda_engine.ROW_COUNTS * 8 + cuda_engine.ROW_FLOATS * 8), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  bound at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {e_bound['bound_ms']:.3f} ms "
        f"{e_bound['bound_parts']}; plain on the card at {n_cmp} x "
        f"{BOOK_SAMPLE_PATHS} paths {e_plain_ms:.3f} ms (kernel there {e_sample_ms:.3f} ms); "
        f"fold of {BOOK_SYMBOLS + 1} x {grid_size(BOOK_PATHS)} rows {e_red_ms:.4f} ms")
    log(f"  work per path and symbol (first {BOOK_SAMPLE_PATHS} paths of {n_cmp} symbols): "
        f"trades {float(sc[:-1, 5].sum()) / BOOK_SAMPLE_PATHS / n_cmp:.4f}, skips "
        f"{[round(float(x) / BOOK_SAMPLE_PATHS / n_cmp, 4) for x in sc[:-1, 7:23].sum(0)]}")
    with tempfile.TemporaryDirectory() as tmp:
        db = ["--db", os.path.join(tmp, "smoke.db")]
        log(f"[20] main path: cli book --engine --backend cuda, {BOOK_SYMBOLS} symbols x "
            f"{BOOK_PATHS} paths x {NUM_BARS} bars")
        lines, e_secs, e_launches = run_cli(
            cli, db + book_argv(True), reset,
            {"mc_engine_rows_corr": 1, "mc_engine_corr_reduce_rows": 1},
            work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
        check_book_output(lines, BOOK_SYMBOLS, True)
        log(f"  book row: {json.dumps(lines[-1])}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(db + ["book", "--engine", "--backend", "cuda"])
        dflt = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
        if rc != 0:
            raise AssertionError(f"cli book --engine (defaults) exited {rc}")
        check_book_output(dflt, 8, True)
        log(f"  cli book --engine --backend cuda at its defaults (8 x {1 << 16}): {len(dflt)} "
            "rows in the JAX CLI's form")
        log(f"[20] main path: cli book --engine --harvest --backend cuda, {BOOK_SYMBOLS} "
            f"symbols x {BOOK_PATHS} paths x {NUM_BARS} bars: each symbol's labels and its "
            "refreshed ML gate")
        h_lines, h_secs, h_launches = run_cli(
            cli, db + book_argv(True) + ["--harvest"], reset,
            {"mc_engine_wide_corr_harvest": 1, "mc_engine_corr_reduce_rows": 1,
             "mc_engine_harvest_reduce_rows": 1},
            work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
        check_book_harvest_output(h_lines, lines)
    # the harvest build against the envelope kernel it is built from, forced
    h_t = interleaved_ms({
        "wide": forced(cuda_engine, lambda: cuda_engine.engine_corr_rows(0, *book100, **main)),
        "harvest": lambda: cuda_engine.engine_corr_rows(0, *book100, harvest=True, **main)})
    b_trades = float(sc[:-1, 5].sum()) * main_scale * BOOK_SYMBOLS / n_cmp
    HV_MAIN["mc_engine_wide_corr_harvest"] = dict(
        ms=h_t["harvest"], ms_without=h_t["wide"], ms_parent=e_main_ms, paths=BOOK_PATHS,
        symbols=BOOK_SYMBOLS,
        launches=h_launches["mc_engine_wide_corr_harvest"], cli_s=h_secs[1:],
        bound=harvest_bound(card, e_row_bytes, e_ops, b_trades, BOOK_SYMBOLS,
                            grid_size(BOOK_PATHS)))
    log(f"  the harvest book kernel alone at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: "
        f"{h_t['harvest']:.3f} ms, the envelope kernel without the harvest {h_t['wide']:.3f} ms "
        f"({h_t['harvest'] / h_t['wide']:.4f}x; the book rows kernel {e_main_ms:.3f} ms, "
        f"the parent {e_main_parent_ms:.3f} ms)")
    out += [entry("mc_engine_rows_corr", BOOK_ROWS_SOURCE, ENGINE_CORR_REPLACES,
                  e_launches["mc_engine_rows_corr"], e_err, e_main_ms, e_plain_ms, e_bound,
                  symbols=BOOK_SYMBOLS, paths=BOOK_PATHS, plain_paths=BOOK_SAMPLE_PATHS,
                  plain_symbols=n_cmp, kernel_ms_at_plain_size=e_sample_ms,
                  parent_ms=e_main_parent_ms, envelope_ms=h_t["wide"], cli_s=e_secs[1:]),
            entry("mc_engine_corr_reduce_rows", ENGINE_SOURCE, ENGINE_CORR_REPLACES,
                  e_launches["mc_engine_corr_reduce_rows"], e_red_err, e_red_ms,
                  e_red_plain_ms, e_red_bound, rows=int(e_rows[0].shape[1]),
                  segments=BOOK_SYMBOLS + 1)]
    return out



# ---- the recorded-bar and Heston samplers of kernels #1, #4 and #8
SAMPLERS = ("bootstrap", "block_bootstrap", "heston")
SAMPLER_HIST_BARS = 390 * 252      # a year of regular sessions of 1-minute bars
SAMPLER_BLOCK_LEN = 10
SAMPLER_INJECT_PATHS = {"first contact": 1 << 16, "gated": 1 << 15, "engine": 1 << 14}
FC_SAMPLER_SOURCE = CSRC + "mc_first_contact_samplers.cu"
FC_SAMPLER_SWEEP_SOURCE = CSRC + "mc_first_contact_sampler_sweep.cu"
GATED_SAMPLER_SOURCE = CSRC + "mc_gated_samplers.cu"
GATED_SAMPLER_SWEEP_SOURCE = CSRC + "mc_gated_sampler_sweep.cu"
ENGINE_SAMPLER_SOURCE = CSRC + "mc_engine_samplers.cu"
L2_BYTES = 50e6


def history_arrays(n_bars: int, seed: int = 11):
    """t, o, h, l, c, v numpy arrays of ``n_bars`` 1-minute bars in 390-bar
    sessions, from ``seed``: a random walk of the log close with a U-shaped
    intraday volatility and a gap at each session's open, closes and opens
    rounded to cents, highs and lows a few cents beyond them, volumes
    U-shaped and positive."""
    import numpy as np

    rng = np.random.default_rng(seed)
    minute = np.arange(n_bars) % 390
    ushape = 1.0 + 0.6 * ((2.0 * minute / 389.0 - 1.0) ** 2 - 1.0 / 3.0)
    gap = np.where(minute == 0, rng.normal(0.0, 3e-3, n_bars), 0.0)
    log_c = np.log(100.0) + np.cumsum(gap + rng.normal(0.0, 6e-4, n_bars) * ushape)
    c = np.round(np.exp(log_c), 2)
    prev = np.concatenate([[c[0]], c[:-1]])
    o = np.where(minute == 0, np.round(prev * np.exp(gap), 2), prev)
    h = np.round(np.maximum(o, c) + np.abs(rng.normal(0.0, 0.03, n_bars)), 2)
    lo = np.round(np.minimum(o, c) - np.abs(rng.normal(0.0, 0.03, n_bars)), 2)
    v = np.maximum(np.round(rng.lognormal(np.log(2e4), 0.5, n_bars) * ushape), 1.0)
    t = 1_700_000_000_000 + 60_000 * np.arange(n_bars)
    return t, o, h, lo, c, v


def write_history(path: str, n_bars: int, seed: int = 11) -> None:
    """``history_arrays`` as a recorded-bar CSV (t,o,h,l,c,v)."""
    t, o, h, lo, c, v = history_arrays(n_bars, seed)
    with open(path, "w") as f:
        f.write("t,o,h,l,c,v\n")
        f.write("".join(f"{t[i]},{o[i]:.2f},{h[i]:.2f},{lo[i]:.2f},{c[i]:.2f},{v[i]:.0f}\n"
                        for i in range(n_bars)))


def universe_history(n_sym: int, n_bars: int, seed0: int):
    """A universe's recorded histories, symbol i's ``n_bars`` bars from seed
    ``seed0 + i`` (``history_arrays``, as the CSV would hold them after the
    parse): a PathBars of float32 [S, H] o/h/l/c/v tensors."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars

    cols = [history_arrays(n_bars, seed0 + i)[1:] for i in range(n_sym)]
    return PathBars(*(torch.from_numpy(np.stack([np.asarray(c[k], np.float32) for c in cols]))
                      for k in range(5)))


def gather_bound(card, bytes_: float, ops: dict, gathers: float, table_bytes: float,
                 live_bytes: float | None = None) -> dict:
    """``card.bound`` with the tables read once and a recorded bar's gathered
    values as 32-byte sectors: against device memory's rate when the tables
    a launch reads at once (``live_bytes``: one row's, where each row reads
    its own and a CTA works on one row; default all of them) outgrow the
    L2, listed only while they fit there."""
    g = 32.0 * gathers
    live = table_bytes if live_bytes is None else live_bytes
    b = card.bound(bytes_=bytes_ + table_bytes + (g if live > L2_BYTES else 0.0), **ops)
    b["bound_parts"]["gather_bytes"] = g
    return b


def fc_sampler_ops(sampler: str, work, entered: int, scale: float):
    """(operations, gathered values) of the first-contact sampler kernel (no
    noise) from the plain version's work counts [Box-Muller pairs, bars
    walked, bars after contact], scaled by ``scale``."""
    pairs, walked, post = (float(x) * scale for x in work[:3])
    entered *= scale
    if sampler == "heston":
        ops = fc_ops(work, entered / scale, scale, by_groups=False)
        ops["sfu"] += 2 * pairs + walked          # the shock pair's logf, sqrtf; sig_bar
        ops["f32"] += 4 * pairs + 8 * walked
        ops["imul"] += PHILOX_IMULS * 2 * pairs   # the shock pair's two rows
        return ops, 0.0
    draws = walked / (SAMPLER_BLOCK_LEN if sampler == "block_bootstrap" else 1)
    expf = walked + entered + 2 * post              # closes, the entry's open, high/low
    sfu = expf + entered                            # and reward / risk
    gathers = walked + (walked - post) + 2 * post   # log return; open before, high/low after
    return dict(f32=sfu + 10 * walked, sfu=sfu, imul=PHILOX_IMULS * draws), gathers


def gated_sampler_ops(sampler: str, n_paths: float, held: float, trades: float):
    """(operations, gathered values) of the gated sampler kernel (no noise)
    for ``n_paths`` paths of NUM_BARS bars, ``held`` bars on which a
    position was open and ``trades`` entries."""
    bars = n_paths * NUM_BARS
    if sampler == "heston":
        ops = gated_ops(n_paths, held, trades)
        pairs = bars / 2
        ops["sfu"] += 2 * pairs + bars
        ops["f32"] += 4 * pairs + 8 * bars
        ops["imul"] = PHILOX_IMULS * bars * 10 / 8      # 10 rows a double bar
        return ops, 0.0
    expf = bars + n_paths + 2 * held                     # closes, bar 0's open, high/low
    sfu = expf + 2 * trades
    return (dict(f32=sfu + 30 * bars, sfu=sfu, imul=PHILOX_IMULS * bars / 2),
            bars + n_paths + 2 * held)


def engine_sampler_ops(sampler: str, n_paths: float, counts, scale: float,
                       num_bars: int = NUM_BARS, n_levels: int = 0):
    """(operations, gathered values) of the engine sampler kernel (no
    noise): ``engine_ops``' floor with the bar made as the sampler makes it
    (recorded: an expf each for close, high and low, no bridge, no volume
    model, four gathered values; Heston: a second Box-Muller pair a double
    bar and a sqrtf a bar, 12 rows a double bar)."""
    ops = engine_ops(n_paths, counts, scale, num_bars, n_levels)
    bars = n_paths * num_bars
    if sampler == "heston":
        ops["sfu"] += bars + bars                         # the shock pair, sig_bar
        ops["f32"] += 10 * bars
        ops["imul"] = PHILOX_IMULS * n_paths * math.ceil(12 * num_bars / 2 / 4)
        return ops, 0.0
    # no bridge (3 logf + 3 sqrtf a bar less 1 of each for the volume pair),
    # one expf fewer, no minute-of-day or coupling division
    ops["sfu"] -= 6 * bars + bars + 2 * bars
    ops["f32"] -= 6 * bars + bars + 2 * bars + 2 * bars
    ops["imul"] = PHILOX_IMULS * n_paths * num_bars / 2
    return ops, 4 * bars


def sampler_argv(family: str, sampler: str, csv) -> list:
    """The main path's ``paths`` arguments under ``sampler`` (``csv`` the
    history, None for the CLI's default fixture)."""
    argv = ["paths"] + ({"gated": ["--gated"], "engine": ["--engine"]}.get(family, []))
    argv += ["--backend", "cuda", "--num-paths", str(MAIN_PATHS), "--num-bars",
             str(NUM_BARS), "--sigma", str(SIGMA), "--sampler", sampler]
    if sampler != "heston" and csv is not None:
        argv += ["--bars-csv", csv]
    if sampler == "block_bootstrap":
        argv += ["--block-len", str(SAMPLER_BLOCK_LEN)]
    return argv


def sampler_phases(dev, card, reset, cli) -> list:
    """Phases 21-23: the three sampler kernels against their plain versions
    and through the CLI's ``paths [--gated | --engine] --sampler ...``;
    returns their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.io import native
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 GbmLayout)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    params = EngineParams.default()
    cli_levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02,
                         stop_slip_std=0.015, target_slip_std=0.015)
    gate = GateConfig.from_params(params)
    entries = []
    tmp = tempfile.TemporaryDirectory()
    csv = os.path.join(tmp.name, "bars.csv")
    t0 = time.perf_counter()
    write_history(csv, SAMPLER_HIST_BARS)
    cols = native.parse_bars_csv(csv)
    tables = torch.stack(bootstrap_tables(*(cols[k] for k in "ohlcv")))
    table_bytes = tables.numel() * 4
    log(f"[21-23] history: {SAMPLER_HIST_BARS} bars written and parsed in "
        f"{time.perf_counter() - t0:.3f} s; tables {table_bytes} bytes; opening gaps "
        f"{int((tables[3] != 0).sum())}, volume {float(cols['v'].min()):.0f}.."
        f"{float(cols['v'].max()):.0f}")

    def skw(s):
        return (dict(sampler=s) if s == "heston" else
                dict(sampler=s, tables=tables, block_len=SAMPLER_BLOCK_LEN))

    def cli_runs(family, s, expect):
        out = {}
        with tempfile.TemporaryDirectory() as db:
            for hist in ((csv, None) if (family, s) == ("first contact", "bootstrap")
                         else (csv,)):
                argv = ["--db", os.path.join(db, "smoke.db")] + sampler_argv(family, s, hist)
                what = "the 390-bar fixture" if hist is None else f"{SAMPLER_HIST_BARS} bars"
                log(f"  main path: cli {' '.join(argv[2:2 + argv[2:].index('--backend')])} "
                    f"--backend cuda --sampler {s} at {MAIN_PATHS} paths ({what})")
                (res,), secs, launches = run_cli(cli, argv, reset, expect)
                check_paths_output(res)
                out.setdefault("secs", secs[1:])
                out.setdefault("launches", launches)
                out["out"] = res
        return out

    families = (
        ("first contact", "21", cuda_mc, FC_SAMPLER_SOURCE, FC_REPLACES, "mc_first_contact_sampler",
         "mc_reduce_rows"),
        ("gated", "22", cuda_gated, GATED_SAMPLER_SOURCE, GATED_REPLACES, "mc_gated_sampler",
         "mc_gated_reduce_rows"),
        ("engine", "23", cuda_engine, ENGINE_ROWS_SOURCE, ENGINE_REPLACES,
         "mc_engine_rows_sampler", "mc_engine_reduce_rows"))
    for family, ph, mod, source, replaces, kname, fold in families:
        lanes = {"first contact": LANES, "gated": GATED_LANES, "engine": ENGINE_LANES}[family]
        block = lanes if family == "first contact" else 8 * lanes
        n_blocks = SAMPLER_INJECT_PATHS[family] // block
        common = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=lanes)
        kernel = "mc_engine_rows_kernel" if family == "engine" else kname + "_kernel"
        log(f"[{ph}] {family} samplers ({kernel}, {source.split('/')[-1]}): injected "
            f"uniforms at {SAMPLER_INJECT_PATHS[family]} paths, kernel vs plain on CPU copies"
            + ("" if family == "first contact" else
               ", path by path, every differing path traced"))

        def rows_fn(seed, s, n, nz=None, ext=None, per_path=False, levels=cli_levels):
            kw = dict(common, num_paths=n, noise=nz, antithetic=False, external_uniforms=ext,
                      device=dev, **skw(s))
            if family == "first contact":
                return cuda_mc.first_contact_rows(seed, levels, params, **kw)
            if family == "gated":
                return cuda_gated.gated_rows(seed, levels, params, gate, per_path=per_path, **kw)
            return cuda_engine.engine_rows(seed, levels, params, per_path=per_path, **kw)

        def plain_fn(seed, s, n, nz=None, ext=None, device=dev, levels=cli_levels, **extra):
            kw = dict(common, num_paths=n, noise=nz, antithetic=False, external_uniforms=ext,
                      device=device, **skw(s), **extra)
            if family == "first contact":
                return cuda_mc.fused_totals_reference(seed, levels, params, **kw)
            if family == "gated":
                return cuda_gated.gated_totals_reference(seed, levels, params, gate, **kw)
            return cuda_engine.engine_totals_reference(seed, levels, params, **kw)

        def layout_rows(s, nz):
            if family == "first contact":
                return (GbmLayout(NUM_BARS, nz, s).n_rows, lanes)
            lay = (GatedLayout if family == "gated" else EngineLayout)(NUM_BARS, nz, s)
            return (lay.u_rows, 8, lanes)

        err = {s: 0.0 for s in SAMPLERS}
        for s, nz in [(s, None) for s in SAMPLERS] + [("bootstrap", noise), ("heston", noise)]:
            case = s + ("+noise" if nz is not None else "")
            rng = np.random.default_rng(2100 + 10 * int(ph) + len(case))
            u = torch.from_numpy(rng.uniform(
                1e-9 if family == "first contact" else 1e-6, 1.0,
                (n_blocks, *layout_rows(s, nz is not None))).astype(np.float32))
            n = SAMPLER_INJECT_PATHS[family]
            if family == "first contact":
                want = plain_fn(0, s, n, nz, u, device=torch.device("cpu"))
                got = mod.reduce_rows(*rows_fn(0, s, n, nz, u.to(dev)))
                torch.cuda.synchronize()
                err[s] = max(err[s], compare(case, want, got, n))
                continue
            want = plain_fn(0, s, n, nz, u, device=torch.device("cpu"), per_path=True)
            pc, pf, prow = rows_fn(0, s, n, nz, u.to(dev), per_path=True)
            got = (*mod.reduce_rows(pc, pf), prow)
            torch.cuda.synchronize()
            samp = make_sampler(s, tables=skw(s).get("tables"), block_len=SAMPLER_BLOCK_LEN)
            if family == "gated":
                trace = (lambda d, u=u, prow=prow, want=want, nz=nz, case=case, samp=samp:
                         trace_flips(case, u, d, prow.cpu(), want[2].cpu(), cli_levels, params,
                                     gate, nz, False, dev, sampler=samp))
            else:
                trace = (lambda d, u=u, prow=prow, want=want, nz=nz, case=case, samp=samp:
                         trace_engine_flips(case, u, d, prow.cpu(), want[2].cpu(), cli_levels,
                                            params, {}, SIGMA, nz, False, dev, sampler=samp))
            e, _ = compare_lifecycle(case, want, got, n, engine=family == "engine", trace=trace)
            err[s] = max(err[s], e)

        log(f"[{ph}] {family} samplers, Philox: kernel vs plain on the card at "
            f"{PHILOX_PATHS} paths (the main path's inputs), kernel alone at {MAIN_PATHS}")
        for s in SAMPLERS:
            extra = (dict(work=True) if family in ("first contact", "gated") else {})
            if family == "gated":
                extra.update(per_path=True, chunk_blocks=64)
            if family == "engine":
                extra.update(per_path=True, chunk_blocks=512)
            want, plain_ms = timed(lambda: plain_fn(0, s, PHILOX_PATHS, **extra))
            if family == "first contact":
                got = mod.reduce_rows(*rows_fn(0, s, PHILOX_PATHS))
                torch.cuda.synchronize()
                err[s] = max(err[s], compare(f"{s} philox", want[:2], got, PHILOX_PATHS))
            else:
                pc, pf, prow = rows_fn(0, s, PHILOX_PATHS, per_path=True)
                got = (*mod.reduce_rows(pc, pf), prow)
                torch.cuda.synchronize()
                err[s] = max(err[s], compare_lifecycle(f"{s} philox", want, got, PHILOX_PATHS,
                                                       engine=family == "engine")[0])
                del prow, got
                if family == "engine":
                    same_as_parent(f"{s} philox", cuda_engine,
                                   lambda: rows_fn(0, s, PHILOX_PATHS, per_path=True))
            rows = rows_fn(0, s, PHILOX_PATHS)
            ms = cuda_ms(lambda: rows_fn(0, s, PHILOX_PATHS), 3)
            rows_fn(0, s, MAIN_PATHS)
            main_ms = cuda_ms(lambda: rows_fn(0, s, MAIN_PATHS), 1)
            row_bytes = rows[0].numel() * 8 + rows[1].numel() * 4
            tb = 0.0 if s == "heston" else table_bytes

            def bound(n):
                sc = n / PHILOX_PATHS
                if family == "first contact":
                    ops, g = fc_sampler_ops(s, want[2].cpu(), int(want[0][1]), sc)
                elif family == "gated":
                    ops, g = gated_sampler_ops(s, n, float(want[3]) * sc,
                                               float(want[0][5]) * sc)
                else:
                    ops, g = engine_sampler_ops(s, n, want[0].cpu(), sc)
                return gather_bound(card, row_bytes, ops, g, tb)

            b, b_main = bound(PHILOX_PATHS), bound(MAIN_PATHS)
            log(f"  {s}: kernel {ms:.3f} ms at {PHILOX_PATHS} ({PHILOX_PATHS / ms * 1e3:.6e} "
                f"paths/s), plain on the card {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
                f"{b['bound_parts']}; alone at {MAIN_PATHS}: {main_ms:.3f} ms "
                f"({MAIN_PATHS / main_ms * 1e3:.6e} paths/s), bound {b_main['bound_ms']:.3f} ms")
            run = cli_runs(family, s, {kname: 1, fold: 1})
            out = run["out"]
            if family != "first contact" and not out["trades"] >= out["entered"] > 0:
                raise AssertionError(f"trades < entered: {out}")
            if family == "engine" and s != "heston" and not sum(
                    out["skips"].get(k, 0) for k in ("CONTRA_VOL_LONG", "CONTRA_VOL_SHORT")) > 0:
                raise AssertionError(f"the recorded volumes moved no volume veto: {out}")
            entries.append(entry(f"{kname}/{s}", source, replaces, run["launches"][kname],
                                 err[s], ms, plain_ms, b, paths=PHILOX_PATHS,
                                 main_path_ms=main_ms, main_path_bound_ms=b_main["bound_ms"],
                                 cli_s=run["secs"], sampler=s))
    tmp.cleanup()
    return entries


# ---- the samplers of the sweeps and universes: a row axis on the three
# sampler kernels (kernels #2, #3, #5, #6, #9, #10, #11)
ROWS_INJECT_HIST_BARS = 390 * 20    # the 3-symbol universe's own histories
ROWS_INJECT_BLOCKS = {"first contact": 4, "gated": 1, "engine": 1}
# kernel vs plain on the card: paths a universe symbol, paths a sweep row
ROWS_PLAIN_PATHS = {"first contact": 1 << 20, "gated": 1 << 20, "engine": 1 << 17}
ROWS_SWEEP_PLAIN_PATHS = {"first contact": 1 << 18, "gated": 1 << 18, "engine": 1 << 16}
# config #4's main inputs, kernel vs plain on the card (and the bounds' work):
# paths a symbol, on all its symbols for first contact and on CARD_PLAIN_PICK
# for the lifecycles (every symbol of the full-width launch is also held to its
# one-row launch)
ROWS_SAMPLE_PATHS = {"first contact": 1 << 16, "gated": 1 << 16, "engine": 1 << 15}
ROWS_UNI_SWEEP_SAMPLE_PATHS = 1 << 14
ROWS_UNI_SWEEP_SAMPLE_SYMBOLS = 2   # of the sweep of universes' 8, kernel vs plain on the card
# the CLI's grids: 3 x 3 (stop, tp), x touch limits 2, 4 (gated), x level-jitter
# stds 0, 0.02 (engine), and its path counts (phases 12-14)
GRID9 = [(sp, tp) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)]
ROWS_CLI_PATHS = {"first contact": MAIN_PATHS, "gated": 1 << 26, "engine": 1 << 24}
ROWS_SOURCES = {"first contact": FC_SAMPLER_SOURCE, "gated": GATED_SAMPLER_SOURCE,
                "engine": ENGINE_ROWS_SOURCE}


def rows_ops(family: str, sampler: str, work, sample_pps: int, scale: float):
    """(operations, gathered values) of a launch whose rows are a universe's
    symbols (or a sweep of universes' cells, [S, G]), from the plain
    version's per-row output ``work`` on a sample of ``sample_pps`` paths a
    row, scaled by ``scale`` (the launch's paths over the sample's): each
    symbol's bars made once, the further rows of a symbol its decisions
    again."""
    c = work[0].cpu()
    if family == "first contact":
        w = work[2].cpu().reshape(-1, work[2].shape[-1]).sum(0)
        return fc_sampler_ops(sampler, w, int(c[..., 1].sum()), scale)
    if family == "gated":
        return gated_sampler_ops(sampler, c.shape[0] * sample_pps * scale,
                                 float(work[3].sum()) * scale, float(c[..., 5].sum()) * scale)
    cells = c.reshape(c.shape[0], -1, c.shape[-1])          # [S, G, C]
    n_paths = cells.shape[0] * sample_pps * scale             # a grid row's, every symbol's
    ops, g = engine_sampler_ops(sampler, n_paths, cells[:, 0].sum(0), scale)
    for j in range(1, cells.shape[1]):
        div = engine_gate_divs(cells[:, j].sum(0), scale)
        ops["sfu"] += div
        ops["f32"] += div + 100 * n_paths * NUM_BARS
    return ops, g


def sampler_sweep_ops(family: str, sampler: str, work, n_paths: float, n_rows: int,
                      scale: float):
    """(operations, gathered values) of a sampler sweep of ``n_rows`` rows
    of ``n_paths`` paths, from the plain sweep's output ``work`` on a sample
    (its rows the CLI's 3 x 3 grid), scaled by ``scale``: each path's bars
    once (the gated and engine sampler kernels make them again for every
    row; first contact's sweep kernel walks them once), every row's
    decisions, as ``sweep_ops``, ``gated_sweep_ops`` and ``engine_sweep_ops``
    count them."""
    c = work[0].cpu()
    extra_rows = n_rows - 1
    if family == "first contact":
        w = work[2].cpu()
        ops, g = fc_sampler_ops(sampler, w[:3], int(c[0, 1]), scale)
        row_bars = float(w[3]) * scale * n_rows / c.shape[0]
        extra_div = extra_rows * int(c[0, 1]) * scale
        ops["f32"] += 8 * row_bars + extra_div
        ops["sfu"] += extra_div
        return ops, g
    if family == "gated":
        held = work[3].cpu().double()
        ops, g = gated_sampler_ops(sampler, n_paths, float(held.max()) * scale,
                                   float(c[:, 5].double().mean()) * n_rows * scale)
        ops["f32"] += extra_rows * 30 * n_paths * NUM_BARS
        return ops, g
    ops, g = engine_sampler_ops(sampler, n_paths, c[0], scale)
    div = float(sum(engine_gate_divs(c[j], scale) for j in range(1, c.shape[0])))
    div *= extra_rows / max(c.shape[0] - 1, 1)
    ops["sfu"] += div
    ops["f32"] += div + 100 * extra_rows * n_paths * NUM_BARS
    return ops, g


def rows_sweep_argv(family: str, sampler: str, csv: str) -> list:
    """The CLI's ``sweep`` under a bootstrap sampler at the gbm sweeps' sizes."""
    argv = ["sweep", "--backend", "cuda", "--num-paths", str(ROWS_CLI_PATHS[family]),
            "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA), "--sampler", sampler,
            "--bars-csv", csv]
    if family == "gated":
        argv += ["--gated", "--touch-limits", "2", "4"]
    if family == "engine":
        argv += ["--engine", "--jitter-stds", "0", "0.02"]
    if sampler == "block_bootstrap":
        argv += ["--block-len", str(SAMPLER_BLOCK_LEN)]
    return argv


def sampler_rows_phases(dev, card, reset, cli) -> list:
    """Phases 24-26: the three sampler kernels with a row a symbol (#2, #5,
    #10), a grid row (#3, #6, #9) or a cell (#11), under bootstrap, block
    bootstrap and Heston: injected uniforms against the plain version (a
    3-symbol universe with its own histories, the CLI's 3 x 3 grid; gated
    and engine with and without noise, path by path, every differing path
    traced); Philox at 2^22, every row equal to its one-row launch bit for
    bit, the row fold against its plain fold, the plain version on the card
    path by path; config #4 with a year of 1-minute bars a symbol, the
    sweeps at the CLI's sizes (``sweep --sampler bootstrap | block_bootstrap``
    through the CLI, Heston through the Python entries) and the engine's
    sweep of universes at 8 x 4 x 2^20; the bootstrap universe against 100
    one-symbol launches.  Returns their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.io import native
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 GbmLayout)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import (bootstrap_tables,
                                                                   universe_tables)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    cpu = torch.device("cpu")
    params = EngineParams.default()
    gate = GateConfig.from_params(params)
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = [float(x) for x in UNI3_S0], [float(x) for x in UNI3_SIGMA]
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    jit9 = torch.linspace(0.0, 0.04, 9)
    noise9 = McNoise(level_jitter_std=jit9, entry_slip_std=torch.full((9,), 0.01),
                     stop_slip_std=torch.full((9,), 0.015),
                     target_slip_std=torch.full((9,), 0.015))
    stops9, tps9 = [g[0] for g in GRID9], [g[1] for g in GRID9]
    grid9 = params.replace(stop_padding=stops9, tp_padding=tps9)
    # a price ulp in R of each injected row: its highest level or spot over its stop
    uni_ulp = [r_ulp(max(s0_3[i], *(r["price"] for r in UNI3_ROWS[i])), sp)
               for i, sp in enumerate(p3.stop_padding.tolist())]
    sweep_ulp = [r_ulp(max(100.0, *(r["price"] for r in CLI_ROWS)), sp) for sp in stops9]
    cli_levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    t0 = time.perf_counter()
    tables3 = universe_tables(universe_history(3, ROWS_INJECT_HIST_BARS, 31))
    c4 = config4()
    c4_hist = universe_history(UNI_SYMBOLS, SAMPLER_HIST_BARS, 1000)
    c4_tables = universe_tables(c4_hist).to(dev)
    c4_table_bytes = c4_tables.numel() * 4
    tmp = tempfile.TemporaryDirectory()
    csv = os.path.join(tmp.name, "bars.csv")
    write_history(csv, SAMPLER_HIST_BARS)
    cols = native.parse_bars_csv(csv)
    tables1 = torch.stack(bootstrap_tables(*(cols[k] for k in "ohlcv")))
    log(f"[24-26] histories: 3 symbols x {ROWS_INJECT_HIST_BARS} bars; config #4's "
        f"{UNI_SYMBOLS} symbols x {SAMPLER_HIST_BARS} bars, tables {c4_table_bytes} bytes on "
        f"the card; the CLI's {SAMPLER_HIST_BARS}-bar CSV; "
        f"{time.perf_counter() - t0:.3f} s")

    def skw(s, tables=None):
        return (dict(sampler=s) if s == "heston" else
                dict(sampler=s, tables=tables, block_len=SAMPLER_BLOCK_LEN))

    def row_skw(s, tables, i):
        return skw(s, None if tables is None else tables[i])

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    class Family:
        """One family's launchers, plain versions and one-row launches."""

        def __init__(self, name):
            self.name = name
            self.fc, self.engine = name == "first contact", name == "engine"
            self.mod = {"first contact": cuda_mc, "gated": cuda_gated,
                        "engine": cuda_engine}[name]
            self.lanes = {"first contact": cuda_mc.UNIVERSE_LANES, "gated": GATED_LANES,
                          "engine": ENGINE_LANES}[name]
            self.sweep_lanes = LANES if self.fc else self.lanes
            self.block = self.lanes if self.fc else 8 * self.lanes
            self.sweep_block = self.sweep_lanes if self.fc else 8 * self.lanes
            self.p3 = p3.replace(q_min_prob=[0.60, 0.40, 0.55]) if self.engine else p3
            self.prefix = {"first contact": "mc", "gated": "mc_gated",
                           "engine": "mc_engine"}[name]

        def layout_rows(self, s, noisy):
            if self.fc:
                return (GbmLayout(NUM_BARS, noisy, s).n_rows, self.lanes)
            lay = (GatedLayout if self.name == "gated" else EngineLayout)(NUM_BARS, noisy, s)
            return (lay.u_rows, 8, self.lanes)

        # -- universes: (seed, levels, params, s0, sigma) of S symbols
        def uni(self, seed, lv, p, s0, sg, pps, s, tables, nz=None, ext=None, plain=False,
                device=None, per_path=False, work=False, chunk_blocks=64):
            kw = dict(paths_per_symbol=pps, num_bars=NUM_BARS, dt=DT, lanes=self.lanes,
                      external_uniforms=ext, device=dev if device is None else device,
                      **skw(s, tables))
            if plain:
                kw.update(chunk_blocks=chunk_blocks)
                if self.fc:
                    return cuda_mc.universe_totals_reference(seed, lv, p, s0, sg, work=work,
                                                             per_path=per_path, **kw)
                if self.engine:
                    return cuda_engine.engine_universe_totals_reference(
                        seed, lv, p, s0, sg, noise=nz, per_path=per_path, **kw)
                return cuda_gated.gated_universe_totals_reference(
                    seed, lv, p, s0, sg, gate, noise=nz, per_path=per_path, work=work, **kw)
            if self.fc:
                return cuda_mc.universe_rows(seed, lv, p, s0, sg, **kw)
            if self.engine:
                return cuda_engine.engine_universe_rows(seed, lv, p, s0, sg, noise=nz,
                                                        per_path=per_path, **kw)
            return cuda_gated.gated_universe_rows(seed, lv, p, s0, sg, gate, noise=nz,
                                                  per_path=per_path, **kw)

        def uni_entry(self, lv, p, s0, sg, pps, s, tables):
            kw = dict(paths_per_symbol=pps, num_bars=NUM_BARS, dt=DT, **skw(s, tables))
            if self.fc:
                return cuda_mc.mc_paths_universe_fused(0, lv, p, s0, sg, **kw)
            if self.engine:
                return cuda_engine.mc_paths_engine_universe_fused(0, lv, p, s0, sg, **kw)[0]
            return cuda_gated.mc_paths_gated_universe_fused(0, lv, p, s0, sg, gate, **kw)

        # -- the single configuration's plain version at symbol ``symbol`` (gated, engine)
        def plain_single(self, seed, lv, p, n, s, tables, s0, sg, symbol, per_path=False,
                         work=False, chunk_blocks=64):
            kw = dict(num_paths=n, num_bars=NUM_BARS, s0=s0, mu=0.0, sigma=sg, dt=DT,
                      lanes=self.lanes, external_uniforms=None, device=dev, symbol=symbol,
                      per_path=per_path, chunk_blocks=chunk_blocks, **skw(s, tables))
            if self.engine:
                return cuda_engine.engine_totals_reference(seed, lv, p, **kw)
            return cuda_gated.gated_totals_reference(seed, lv, p, gate, work=work, **kw)

        # -- the one-row launch of symbol ``symbol`` or of one grid row
        def single(self, seed, lv, p, n, s, tables, s0=100.0, sg=SIGMA, nz=None, symbol=0,
                   per_path=False, lanes=None, gate_g=None):
            kw = dict(num_paths=n, num_bars=NUM_BARS, s0=s0, mu=0.0, sigma=sg, dt=DT,
                      lanes=lanes or self.lanes, noise=nz, antithetic=False,
                      external_uniforms=None, device=dev, symbol=symbol, **skw(s, tables))
            if self.fc:
                return cuda_mc.first_contact_rows(seed, lv, p, **kw)
            if self.engine:
                return cuda_engine.engine_rows(seed, lv, p, per_path=per_path, **kw)
            return cuda_gated.gated_rows(seed, lv, p, gate if gate_g is None else gate_g,
                                         per_path=per_path, **kw)

        # -- sweeps over the rows of ``grid`` (params with [G] stop and tp)
        def sweep(self, seed, lv, grid, n, s, tables, nz=None, ext=None, plain=False,
                  device=None, per_path=False, work=False, chunk_blocks=64, gate_g=None):
            kw = dict(num_paths=n, num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                      lanes=self.sweep_lanes, external_uniforms=ext,
                      device=dev if device is None else device, **skw(s, tables))
            if plain:
                kw.update(chunk_blocks=chunk_blocks)
            stops, tps = grid.stop_padding.tolist(), grid.tp_padding.tolist()
            if self.fc:
                if plain:
                    return cuda_mc.sweep_totals_reference(seed, lv, params, stops, tps,
                                                          work=work, per_path=per_path, **kw)
                return cuda_mc.sweep_rows(seed, lv, params, stops, tps, **kw)
            if self.engine:
                fn = (cuda_engine.engine_sweep_totals_reference if plain
                      else cuda_engine.engine_sweep_rows)
                return fn(seed, lv, grid, noise=nz, per_path=per_path, **kw)
            gate_g = gate if gate_g is None else gate_g
            if plain:
                return cuda_gated.gated_sweep_totals_reference(
                    seed, lv, params, stops, tps, gate_g, noise=nz, per_path=per_path,
                    work=work, **kw)
            return cuda_gated.gated_sweep_rows(seed, lv, params, stops, tps, gate_g, noise=nz,
                                               per_path=per_path, **kw)

        def sweep_entry(self, lv, grid, n, s, nz=None, gate_g=None):
            kw = dict(num_paths=n, num_bars=NUM_BARS, sigma=SIGMA, **skw(s, tables1))
            stops, tps = grid.stop_padding.tolist(), grid.tp_padding.tolist()
            if self.fc:
                return cuda_mc.mc_paths_sweep_fused(0, lv, params, stops, tps, **kw)
            if self.engine:
                return cuda_engine.mc_paths_engine_sweep_fused(0, lv, grid, noise=nz, **kw)[0]
            return cuda_gated.mc_paths_gated_sweep_fused(
                0, lv, params, stops, tps, gate if gate_g is None else gate_g, noise=nz, **kw)

        def fold(self, rows):
            return self.mod.reduce_rows(rows[0], rows[1])

        def check(self, name, want, got, n, tie_ulp, trace=None, ties=None):
            """Kernel ``got`` against plain ``want`` under the family's rules,
            a histogram's true edge ties binned as the kernel bins them
            (``tie_ulp``: ``r_ulp`` of the row; first contact: ``ties`` = the
            plain per-path R, the kernel's)."""
            if self.fc:
                return compare(name, want[:2], got[:2], n, ties=ties, tie_ulp=tie_ulp)
            return compare_lifecycle(name, want, got, n, engine=self.engine, trace=trace,
                                     tie_ulp=tie_ulp)[0]

        def on_card(self, name, card, got):
            """First contact has no per-path output: the plain version on the
            card on the same uniforms must equal the kernel exactly (counts
            and histogram), and gives the kernel's per-path R."""
            if self.fc and not torch.equal(card[0].cpu(), got[0].cpu()):
                raise AssertionError(f"{name}: the kernel differs from the plain version on "
                                     "the card on the same uniforms")
            return card[2] if self.fc else None

        def trace(self, name, u, prow, wrow, lv, p, nz, s0, sg, samp):
            if self.fc:
                return None
            if self.engine:
                return lambda d: trace_engine_flips(name, u, d, prow.cpu(), wrow.cpu(), lv, p,
                                                    {}, sg, nz, False, dev, s0=s0,
                                                    sampler=samp)
            return lambda d: trace_flips(name, u, d, prow.cpu(), wrow.cpu(), lv, p, gate, nz,
                                         False, dev, s0=s0, sigma=sg, sampler=samp)

    def sampler_of(s, tables, i=None):
        t = None if tables is None or s == "heston" else (tables if i is None else tables[i])
        return make_sampler(s, tables=t, block_len=SAMPLER_BLOCK_LEN)

    out = []
    for fam_name, ph in (("first contact", "24"), ("gated", "25"), ("engine", "26")):
        fam = Family(fam_name)
        mod = fam.mod
        pre = fam.prefix
        uni_kname, sweep_kname = (("mc_universe_sampler", "mc_sweep_sampler") if fam.fc else
                                  ("mc_engine_rows_universe_sampler" if fam.engine
                                   else f"{pre}_universe_sampler",
                                   "mc_engine_bar_sweep_sampler" if fam.engine
                                   else f"{pre}_sweep_sampler"))
        uni_fold, sweep_fold = f"{pre}_universe_reduce_rows", f"{pre}_sweep_reduce_rows"
        replaces = {"first contact": (UNI_REPLACES, SWEEP_REPLACES),
                    "gated": (GATED_UNI_REPLACES, GATED_SWEEP_REPLACES),
                    "engine": (ENGINE_UNI_REPLACES, ENGINE_SWEEP_REPLACES)}[fam_name]
        source = ROWS_SOURCES[fam_name]
        sweep_source = (FC_SAMPLER_SWEEP_SOURCE if fam.fc else GATED_SAMPLER_SWEEP_SOURCE
                        if fam_name == "gated" else BAR_SWEEP_SOURCE)
        nb = ROWS_INJECT_BLOCKS[fam_name]
        plain_n, sweep_n = ROWS_PLAIN_PATHS[fam_name], ROWS_SWEEP_PLAIN_PATHS[fam_name]
        n_uni, n_sw = nb * fam.block, nb * fam.sweep_block
        log(f"[{ph}] {fam_name} sampler rows ({source.split('/')[-1]}): injected uniforms, "
            f"3 symbols x {n_uni} paths with their own histories and [S] knobs"
            + ("" if fam.fc else " (and [S] noise stds)") + f"; the CLI's 3 x 3 grid x {n_sw} "
            "paths" + ("" if fam.fc else " (and [G] noise stds)") + "; kernel vs plain on CPU "
            "copies" + ("" if fam.fc else ", path by path, every differing path traced"))
        err = {s: 0.0 for s in SAMPLERS}
        cases = [(s, False) for s in SAMPLERS] + ([] if fam.fc else
                                                   [(s, True) for s in SAMPLERS])
        for s, noisy in cases:
            case = s + ("+noise" if noisy else "")
            rng = np.random.default_rng(2400 + 10 * int(ph) + len(case))
            low = 1e-9 if fam.fc else 1e-6
            u = torch.from_numpy(rng.uniform(low, 1.0, (3, nb, *fam.layout_rows(s, noisy)))
                                 .astype(np.float32))
            nz = noise3 if noisy else None
            want = fam.uni(0, lv3, fam.p3, s0_3, sg_3, n_uni, s, tables3, nz=nz, ext=u,
                           plain=True, device=cpu, per_path=True, chunk_blocks=16)
            rows = fam.uni(0, lv3, fam.p3, s0_3, sg_3, n_uni, s, tables3, nz=nz, ext=u.to(dev),
                           per_path=True)
            got = (*fam.fold(rows), *rows[2:])
            r_card = fam.on_card(case, fam.uni(0, lv3, fam.p3, s0_3, sg_3, n_uni, s, tables3,
                                               ext=u.to(dev), plain=True, per_path=True)
                                 if fam.fc else None, got)
            torch.cuda.synchronize()
            for i in range(3):
                name = f"{case} symbol {i}"
                tr = None if fam.fc else fam.trace(
                    name, u[i], rows[2][i], want[2][i], grid_row(lv3, i), grid_row(fam.p3, i),
                    None if nz is None else grid_row(nz, i), s0_3[i], sg_3[i],
                    sampler_of(s, tables3, i))
                err[s] = max(err[s], fam.check(
                    name, tuple(x[i] for x in want), tuple(x[i] for x in got), n_uni,
                    uni_ulp[i], tr, ties=None if r_card is None else (want[2][i], r_card[i])))
            u = torch.from_numpy(rng.uniform(
                low, 1.0, (nb, *fam.layout_rows(s, noisy)[:-1], fam.sweep_lanes))
                .astype(np.float32))
            nz = noise9 if noisy else None
            want = fam.sweep(0, cli_levels, grid9, n_sw, s, tables1, nz=nz, ext=u, plain=True,
                             device=cpu, per_path=True, chunk_blocks=16)
            rows = fam.sweep(0, cli_levels, grid9, n_sw, s, tables1, nz=nz, ext=u.to(dev),
                             per_path=True)
            got = (*fam.fold(rows), *rows[2:])
            r_card = fam.on_card(case, fam.sweep(0, cli_levels, grid9, n_sw, s, tables1,
                                                 ext=u.to(dev), plain=True, per_path=True)
                                 if fam.fc else None, got)
            torch.cuda.synchronize()
            for g in range(len(GRID9)):
                name = f"{case} row {g}"
                tr = None if fam.fc else fam.trace(
                    name, u, rows[2][g], want[2][g], cli_levels, grid_row(grid9, g),
                    None if nz is None else grid_row(nz, g), 100.0, SIGMA,
                    sampler_of(s, tables1))
                err[s] = max(err[s], fam.check(
                    name, tuple(x[g] for x in want), tuple(x[g] for x in got), n_sw,
                    sweep_ulp[g], tr, ties=None if r_card is None else (want[2][g], r_card[g])))

        log(f"[{ph}] {fam_name} sampler rows, Philox at {PHILOX_PATHS} paths a row: every "
            "universe symbol and sweep row equal to its one-row launch bit for bit"
            + ("" if fam.fc else " (per path included)") + "; the row folds against their "
            f"plain folds; the plain version on the card at {plain_n} paths a "
            f"symbol and {sweep_n} a grid row")
        stats = {}
        for s in SAMPLERS:
            nz3, nz9 = (None, None) if fam.fc else (noise3, noise9)
            rows = fam.uni(7, lv3, fam.p3, s0_3, sg_3, PHILOX_PATHS, s, tables3, nz=nz3,
                           per_path=not fam.fc)
            for i in range(3):
                one = fam.single(7, grid_row(lv3, i), grid_row(fam.p3, i), PHILOX_PATHS, s,
                                 None if tables3 is None else tables3[i], s0=s0_3[i],
                                 sg=sg_3[i], nz=None if nz3 is None else grid_row(nz3, i),
                                 symbol=i, per_path=not fam.fc)
                if not equal(one, tuple(x[i] for x in rows)):
                    raise AssertionError(f"{fam_name} {s} universe symbol {i} differs from "
                                         "its one-row launch")
            uni_red_err = check_fold(f"{pre} {s} universe fold",
                                     mod.reduce_rows_reference(*rows[:2]), fam.fold(rows))
            del rows
            sw = fam.sweep(7, cli_levels, grid9, PHILOX_PATHS, s, tables1, nz=nz9,
                           per_path=not fam.fc)
            for g in range(len(GRID9)):
                one = fam.single(7, cli_levels, grid_row(grid9, g), PHILOX_PATHS, s, tables1,
                                 nz=None if nz9 is None else grid_row(nz9, g),
                                 per_path=not fam.fc, lanes=fam.sweep_lanes)
                if not equal(one, tuple(x[g] for x in sw)):
                    raise AssertionError(f"{fam_name} {s} sweep row {g} differs from its "
                                         "one-row launch")
            sw_red_err = check_fold(f"{pre} {s} sweep fold",
                                    mod.reduce_rows_reference(*sw[:2]), fam.fold(sw))
            del sw
            # the plain version on the card (and its work, for the bounds)
            want, uni_plain_ms = timed(lambda: fam.uni(
                7, lv3, fam.p3, s0_3, sg_3, plain_n, s, tables3, nz=nz3, plain=True,
                per_path=not fam.fc, work=not fam.engine))
            rows = fam.uni(7, lv3, fam.p3, s0_3, sg_3, plain_n, s, tables3, nz=nz3,
                           per_path=not fam.fc)
            got = (*fam.fold(rows), *rows[2:])
            if fam.fc:
                for i in range(3):
                    err[s] = max(err[s], compare(f"{s} philox symbol {i}", (want[0][i],
                                                 want[1][i]), (got[0][i], got[1][i]),
                                                 plain_n, quiet=True))
            else:
                err[s] = max(err[s], same_on_card(f"{s} universe", want[:3], got, 3,
                                                  plain_n, lambda i: f"symbol {i}",
                                                  engine=fam.engine))
            uni_work = want
            uni_ms = cuda_ms(lambda: fam.uni(7, lv3, fam.p3, s0_3, sg_3, plain_n, s,
                                             tables3, nz=nz3), 3)
            sw_want, sw_plain_ms = timed(lambda: fam.sweep(
                7, cli_levels, grid9, sweep_n, s, tables1, nz=nz9, plain=True,
                per_path=not fam.fc, work=not fam.engine))
            sw = fam.sweep(7, cli_levels, grid9, sweep_n, s, tables1, nz=nz9,
                           per_path=not fam.fc)
            got = (*fam.fold(sw), *sw[2:])
            if fam.fc:
                for g in range(len(GRID9)):
                    err[s] = max(err[s], compare(f"{s} philox row {g}", (sw_want[0][g],
                                                 sw_want[1][g]), (got[0][g], got[1][g]),
                                                 sweep_n, quiet=True))
            else:
                err[s] = max(err[s], same_on_card(f"{s} sweep", sw_want[:3], got, len(GRID9),
                                                  sweep_n, lambda g: f"row {g}",
                                                  engine=fam.engine))
            sw_ms = cuda_ms(lambda: fam.sweep(7, cli_levels, grid9, sweep_n, s,
                                              tables1, nz=nz9), 3)
            stats[s] = dict(uni_red_err=uni_red_err, sw_red_err=sw_red_err,
                            uni_plain_ms=uni_plain_ms, uni_ms=uni_ms, uni_work=uni_work,
                            sw_plain_ms=sw_plain_ms, sw_ms=sw_ms, sw_work=sw_want)
            log(f"  {s}: every row equals its one-row launch; folds within "
                f"{max(uni_red_err, sw_red_err):.3e}; universe 3 x {plain_n}: kernel "
                f"{uni_ms:.3f} ms, plain on the card {uni_plain_ms:.3f} ms; sweep 9 x "
                f"{sweep_n}: kernel {sw_ms:.3f} ms, plain {sw_plain_ms:.3f} ms")

        def part_bytes(n_rows, pps):
            return n_rows * grid_size(pps) * (mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 4)

        def rows_bound(n_rows, pps, s, work, sample_pps, table_bytes, live_bytes):
            """The bound of a universe's (or a sweep of universes') launch of
            ``n_rows`` rows of ``pps`` paths, from the plain version's
            ``work`` on ``sample_pps`` paths a row of a sample of the rows
            (rows that share a symbol share its bars: ``rows_ops``)."""
            sample_rows = math.prod(work[0].shape[:-1])
            ops, g = rows_ops(fam_name, s, work, sample_pps,
                              n_rows * pps / (sample_rows * sample_pps))
            return gather_bound(card, part_bytes(n_rows, pps), ops, g,
                                0.0 if s == "heston" else table_bytes,
                                live_bytes=0.0 if s == "heston" else live_bytes)

        def sweep_bound(n_rows, n_paths, s, work, scale, table_bytes):
            """A sweep's bound: each path's bars once, each row's decisions."""
            ops, g = sampler_sweep_ops(fam_name, s, work, n_paths, n_rows, scale)
            return gather_bound(card, part_bytes(n_rows, n_paths), ops, g,
                                0.0 if s == "heston" else table_bytes)

        lanes = fam.lanes
        pps_sample = ROWS_SAMPLE_PATHS[fam_name]
        for s in SAMPLERS:
            st_ = stats[s]
            tb1 = float(tables1.numel() * 4)
            tb3 = float(tables3.numel() * 4)
            uni_b = rows_bound(3, plain_n, s, st_["uni_work"], plain_n, tb3, tb3 / 3)
            sw_b = sweep_bound(len(GRID9), sweep_n, s, st_["sw_work"], 1.0, tb1)

            log(f"[{ph}] main path: mc_paths_{'' if fam.fc else pre[3:] + '_'}universe_fused "
                f"--sampler {s}, config #4 ({UNI_SYMBOLS} symbols x {UNI_PATHS} paths x "
                f"{NUM_BARS} bars" + ("" if s == "heston" else
                                     f", each symbol its own {SAMPLER_HIST_BARS} bars") + ")")
            c4t = None if s == "heston" else c4_tables
            pick = list(range(UNI_SYMBOLS)) if fam.fc else CARD_PLAIN_PICK
            log(f"  the main path's inputs, config #4's "
                + (f"{UNI_SYMBOLS}" if fam.fc else f"{len(pick)} {pick} of its")
                + f" symbols at {pps_sample} paths a symbol from its full-width launch: "
                "kernel vs plain on the card")
            if fam.fc:
                sample = fam.uni(0, c4[0], params, *c4[1:], pps_sample, s, c4t, plain=True,
                                 work=True)
            else:
                sample = plain_picks(lambda i, lv, s0, sg: fam.plain_single(
                    0, lv, params, pps_sample, s, None if c4t is None else c4t[i], s0, sg, i,
                    per_path=True, work=not fam.engine), c4, pick)
            krows = fam.uni(0, c4[0], params, *c4[1:], pps_sample, s, c4t,
                            per_path=not fam.fc)
            if fam.engine:
                same_as_parent(f"config #4 {s}", cuda_engine, lambda: fam.uni(
                    0, c4[0], params, *c4[1:], pps_sample, s, c4t, per_path=True))
            kgot = tuple(x[pick] for x in (*fam.fold(krows), *krows[2:]))
            if fam.fc:
                e = max(compare(f"config #4 {s} symbol {i}", (sample[0][i], sample[1][i]),
                                (kgot[0][i], kgot[1][i]), pps_sample, quiet=True)
                        for i in range(UNI_SYMBOLS))
                log(f"    every symbol within budget, |d mean_r| max {e:.3e}")
            else:
                e = same_on_card(f"config #4 {s}", sample[:3], kgot, len(pick), pps_sample,
                                 lambda j: f"symbol {pick[j]}", engine=fam.engine)
            err[s] = max(err[s], e)
            del krows, kgot
            st, secs, launches = run_entry(
                f"{fam_name} universe {s}", lambda: fam.uni_entry(
                    c4[0], params, *c4[1:], UNI_PATHS, s, c4t), reset,
                {uni_kname: 2, uni_fold: 2})
            check_universe_stats(f"{fam_name} universe {s}", st, UNI_SYMBOLS, UNI_PATHS)
            # every row of the full-width launch against its one-row launch
            wide = fam.uni(0, c4[0], params, *c4[1:], UNI_PATHS, s, c4t)
            for i in range(UNI_SYMBOLS):
                one = fam.single(0, grid_row(c4[0], i), params, UNI_PATHS, s,
                                 None if c4t is None else c4t[i], s0=float(c4[1][i]),
                                 sg=float(c4[2][i]), symbol=i)
                if not equal(one, tuple(x[i] for x in wide)):
                    raise AssertionError(f"{fam_name} universe {s}: symbol {i} of the "
                                         "full-width launch differs from its one-row launch")
            del wide, one
            log(f"  each of the {UNI_SYMBOLS} symbols of the {UNI_SYMBOLS} x {UNI_PATHS} "
                "launch equals its one-row launch bit for bit (partial rows)")
            main_ms = cuda_ms(lambda: fam.uni(0, c4[0], params, *c4[1:], UNI_PATHS, s, c4t), 2)
            main_b = rows_bound(UNI_SYMBOLS, UNI_PATHS, s, sample, pps_sample, c4_table_bytes,
                                c4_table_bytes / UNI_SYMBOLS)
            log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS}: {main_ms:.3f} ms "
                f"({UNI_SYMBOLS * UNI_PATHS / main_ms * 1e3:.6e} paths/s), bound "
                f"{main_b['bound_ms']:.3f} ms {main_b['bound_parts']}")
            del sample
            extra = {}
            if s == "bootstrap":
                # L2: one launch over 100 symbols' 196.6 MB of tables against 100
                # one-symbol launches, each on its own table, and on one table
                own = cuda_ms(lambda: [fam.single(0, grid_row(c4[0], i), params, UNI_PATHS, s,
                                                  c4_tables[i], s0=float(c4[1][i]),
                                                  sg=float(c4[2][i]), symbol=i)
                                       for i in range(UNI_SYMBOLS)], 1)
                same = cuda_ms(lambda: [fam.single(0, grid_row(c4[0], 0), params, UNI_PATHS, s,
                                                   c4_tables[0], s0=float(c4[1][0]),
                                                   sg=float(c4[2][0]))
                                        for _ in range(UNI_SYMBOLS)], 1)
                extra = dict(singles_own_tables_ms=own, singles_one_table_ms=same)
                log(f"  L2: the universe {main_ms:.3f} ms; {UNI_SYMBOLS} one-symbol launches "
                    f"at {UNI_PATHS} paths, each on its own table {own:.3f} ms, all on one "
                    f"table {same:.3f} ms")
            out.append(entry(f"{uni_kname}/{s}", source, replaces[0], launches[uni_kname],
                             err[s], st_["uni_ms"], st_["uni_plain_ms"], uni_b, sampler=s,
                             symbols=3, paths=plain_n, main_path_ms=main_ms,
                             main_path_bound_ms=main_b["bound_ms"], main_s=secs[1:],
                             fold_err=st_["uni_red_err"], **extra))

            n_cli = ROWS_CLI_PATHS[fam_name]
            cli_grid, cli_noise, cli_gate, combos = grid9, None, None, list(GRID9)
            keys = ["stop_padding", "tp_padding", "hit_rate", "mean_r"]
            if fam.engine:
                jit18 = torch.tensor([j for _ in GRID9 for j in (0.0, 0.02)])
                cli_grid = params.replace(stop_padding=[g[0] for g in GRID9 for _ in (0, 1)],
                                          tp_padding=[g[1] for g in GRID9 for _ in (0, 1)])
                cli_noise = McNoise(level_jitter_std=jit18, entry_slip_std=torch.zeros(18),
                                    stop_slip_std=torch.zeros(18),
                                    target_slip_std=torch.zeros(18))
                combos = [(sp, tp, j) for sp, tp in GRID9 for j in (0.0, 0.02)]
                keys += ["mean_trades", "mean_dd", "escalations", "level_jitter_std"]
            elif not fam.fc:
                cli_grid = params.replace(stop_padding=[g[0] for g in GRID9 for _ in (2, 4)],
                                          tp_padding=[g[1] for g in GRID9 for _ in (2, 4)])
                cli_gate = gate.replace(touch_limit=[tl for _ in GRID9 for tl in (2, 4)])
                combos = [(sp, tp, tl) for sp, tp in GRID9 for tl in (2, 4)]
                keys += ["touch_limit", "mean_trades", "mean_dd"]
            n_rows = len(combos)
            if s == "heston":
                log(f"[{ph}] main path: mc_paths_{pre[3:] + '_' if not fam.fc else ''}sweep_fused"
                    f" --sampler heston at {n_cli} paths x {n_rows} rows (the CLI's sweep has "
                    "no Heston)")
                st, secs, launches = run_entry(
                    f"{fam_name} sweep heston", lambda: fam.sweep_entry(
                        cli_levels, cli_grid, n_cli, s, nz=cli_noise, gate_g=cli_gate), reset,
                    {sweep_kname: 2, sweep_fold: 2})
                if tuple(st.n.shape) != (n_rows,) or not bool((st.n == n_cli).all()):
                    raise AssertionError(f"{fam_name} Heston sweep: path counts {st.n}")
                cli_s = secs[1:]
            else:
                log(f"[{ph}] main path: cli {' '.join(rows_sweep_argv(fam_name, s, 'CSV'))}")
                with tempfile.TemporaryDirectory() as db:
                    lines, secs, launches = run_cli(
                        cli, ["--db", os.path.join(db, "smoke.db")]
                        + rows_sweep_argv(fam_name, s, csv), reset,
                        {sweep_kname: 1, sweep_fold: 1}, n_paths=n_cli)
                check_sweep_output(lines, combos, keys)
                cli_s = secs[1:]
            # every row of the full-width launch against its one-row launch
            wide = fam.sweep(0, cli_levels, cli_grid, n_cli, s, tables1, nz=cli_noise,
                             gate_g=cli_gate)
            for g in range(n_rows):
                one = fam.single(0, cli_levels, grid_row(cli_grid, g), n_cli, s, tables1,
                                 nz=grid_row(cli_noise, g), lanes=fam.sweep_lanes,
                                 gate_g=grid_row(cli_gate, g))
                if not equal(one, tuple(x[g] for x in wide)):
                    raise AssertionError(f"{fam_name} sweep {s}: row {g} of the full-width "
                                         "launch differs from its one-row launch")
            del wide, one
            log(f"  each of the {n_rows} rows of the {n_cli} x {n_rows} launch equals its "
                "one-row launch bit for bit (partial rows)")
            sw_main_ms = cuda_ms(lambda: fam.sweep(0, cli_levels, cli_grid, n_cli, s, tables1,
                                                   nz=cli_noise, gate_g=cli_gate), 1)
            sw_main_b = sweep_bound(n_rows, n_cli, s, st_["sw_work"],
                                    n_cli / sweep_n, tb1)
            log(f"  kernel alone at {n_cli} paths x {n_rows} rows: {sw_main_ms:.3f} ms "
                f"({n_cli * n_rows / sw_main_ms * 1e3:.6e} paths x rows/s), bound "
                f"{sw_main_b['bound_ms']:.3f} ms {sw_main_b['bound_parts']} (each path's bars "
                "counted once)")
            out.append(entry(f"{sweep_kname}/{s}", sweep_source, replaces[1],
                             launches[sweep_kname],
                             err[s], st_["sw_ms"], st_["sw_plain_ms"], sw_b, sampler=s,
                             grid_rows=len(GRID9), paths=sweep_n,
                             main_path_ms=sw_main_ms, main_path_bound_ms=sw_main_b["bound_ms"],
                             main_rows=n_rows, cli_s=cli_s, fold_err=st_["sw_red_err"]))

        if fam.engine:
            # the sweep of universes (#11): config #4's first 8 symbols x the 4
            # configurations of tests/test_pallas_engine.py:320-325
            n8 = UNI_SWEEP_SYMBOLS
            lv8, s0_8, sg_8 = config4(n8)
            g4 = params.replace(stop_padding=[0.35, 0.25, 0.45, 0.35],
                                tp_padding=[0.25, 0.35, 0.25, 0.15],
                                q_min_prob=[0.6, 0.55, 0.6, 0.5])
            for s in SAMPLERS:
                t8 = None if s == "heston" else c4_tables[:n8]
                kw = dict(paths_per_symbol=ROWS_UNI_SWEEP_SAMPLE_PATHS, num_bars=NUM_BARS,
                          dt=DT, lanes=lanes, device=dev, **skw(s, t8))
                log(f"[{ph}] sweep of universes (#11) --sampler {s}: {n8} symbols x 4 rows; "
                    f"Philox, each cell equal to its one-row launch; kernel vs plain on the "
                    f"card, the first {ROWS_UNI_SWEEP_SAMPLE_SYMBOLS} symbols at "
                    f"{ROWS_UNI_SWEEP_SAMPLE_PATHS} paths a cell")
                cells = cuda_engine.engine_universe_sweep_rows(0, lv8, g4, s0_8, sg_8,
                                                               per_path=True, **kw)
                same_as_parent(f"sweep of universes {s}", cuda_engine,
                               lambda: cuda_engine.engine_universe_sweep_rows(
                                   0, lv8, g4, s0_8, sg_8, per_path=True, **kw))
                for i in range(n8):
                    for g in range(4):
                        one = fam.single(0, grid_row(lv8, i), grid_row(g4, g),
                                         ROWS_UNI_SWEEP_SAMPLE_PATHS, s,
                                         None if t8 is None else t8[i], s0=float(s0_8[i]),
                                         sg=float(sg_8[i]), symbol=i, per_path=True)
                        if not equal(one, (cells[0][i, g], cells[1][i, g], cells[2][i, g])):
                            raise AssertionError(f"sweep of universes {s} cell ({i}, {g}) "
                                                 "differs from its one-row launch")
                del cells
                n2 = ROWS_UNI_SWEEP_SAMPLE_SYMBOLS
                lv2, s0_2, sg_2 = config4(n2)
                kw2 = dict(kw, **skw(s, None if t8 is None else t8[:n2]))
                want, us_plain_ms = timed(
                    lambda: cuda_engine.engine_universe_sweep_totals_reference(
                        0, lv2, g4, s0_2, sg_2, per_path=True, chunk_blocks=64, **kw2))
                cells = cuda_engine.engine_universe_sweep_rows(0, lv2, g4, s0_2, sg_2,
                                                               per_path=True, **kw2)
                c, f = cuda_engine.reduce_rows(cells[0].flatten(0, 1), cells[1].flatten(0, 1))
                got = (c.view(n2, 4, -1), f.view(n2, 4, -1), cells[2])
                e = same_on_card(f"sweep of universes {s}", tuple(x.flatten(0, 1) for x in want),
                                 tuple(x.flatten(0, 1) for x in got), n2 * 4,
                                 ROWS_UNI_SWEEP_SAMPLE_PATHS, lambda k: f"cell {divmod(k, 4)}")
                del cells
                us_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
                    0, lv2, g4, s0_2, sg_2, **kw2), 3)
                tb8 = 0.0 if t8 is None else float(t8.numel() * 4)
                us_b = rows_bound(n2 * 4, ROWS_UNI_SWEEP_SAMPLE_PATHS, s, want,
                                  ROWS_UNI_SWEEP_SAMPLE_PATHS, tb8 * n2 / n8, tb8 / n8)
                main_kw = dict(kw, paths_per_symbol=UNI_PATHS)
                main_kw.pop("device")
                st, secs, launches = run_entry(
                    f"sweep of universes {s}",
                    lambda: cuda_engine.mc_paths_engine_universe_sweep_fused(
                        0, lv8, g4, s0_8, sg_8, **main_kw)[0], reset,
                    {"mc_engine_rows_universe_sweep_sampler": 2,
                     "mc_engine_universe_sweep_reduce_rows": 2})
                if tuple(st.n.shape) != (n8, 4) or not bool((st.n == UNI_PATHS).all()):
                    raise AssertionError(f"sweep of universes {s}: path counts {st.n}")
                wide = cuda_engine.engine_universe_sweep_rows(
                    0, lv8, g4, s0_8, sg_8, **dict(kw, paths_per_symbol=UNI_PATHS))
                for i in range(n8):
                    for g in range(4):
                        one = fam.single(0, grid_row(lv8, i), grid_row(g4, g), UNI_PATHS, s,
                                         None if t8 is None else t8[i], s0=float(s0_8[i]),
                                         sg=float(sg_8[i]), symbol=i)
                        if not equal(one, (wide[0][i, g], wide[1][i, g])):
                            raise AssertionError(f"sweep of universes {s}: cell ({i}, {g}) of "
                                                 "the full-width launch differs from its "
                                                 "one-row launch")
                del wide, one
                log(f"  each of the {n8} x 4 cells of the {n8} x 4 x {UNI_PATHS} launch equals "
                    "its one-row launch bit for bit (partial rows)")
                us_main_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
                    0, lv8, g4, s0_8, sg_8, **dict(kw, paths_per_symbol=UNI_PATHS)), 2)
                us_main_b = rows_bound(n8 * 4, UNI_PATHS, s, want,
                                       ROWS_UNI_SWEEP_SAMPLE_PATHS, tb8, tb8 / n8)
                log(f"  kernel alone at {n8} x 4 x {UNI_PATHS}: {us_main_ms:.3f} ms, bound "
                    f"{us_main_b['bound_ms']:.3f} ms; {n2} x 4 x {ROWS_UNI_SWEEP_SAMPLE_PATHS}: "
                    f"kernel {us_ms:.3f} ms, plain on the card {us_plain_ms:.3f} ms")
                out.append(entry(f"mc_engine_rows_universe_sweep_sampler/{s}", source,
                                 ENGINE_UNI_SWEEP_REPLACES,
                                 launches["mc_engine_rows_universe_sweep_sampler"],
                                 max(err[s], e),
                                 us_ms, us_plain_ms, us_b, sampler=s, symbols=n2, grid_rows=4,
                                 paths=ROWS_UNI_SWEEP_SAMPLE_PATHS, main_path_ms=us_main_ms,
                                 main_path_bound_ms=us_main_b["bound_ms"], main_s=secs[1:]))
    tmp.cleanup()
    return out


# ---- the samplers of the books (kernels #7 and #12): joint recorded days from
# the market stream, Heston's second market pair
GATED_CORR_SAMPLER_SOURCE = CSRC + "mc_gated_corr_samplers.cu"
BOOK_SAMPLER_INJECT_BLOCKS = {"gated": 1, "engine": 1}
BOOK_SAMPLER_PHILOX_PATHS = 1 << 16


def book_sampler_market_ops(sampler: str, n_paths: float, n_sym: int,
                            num_bars: int = NUM_BARS) -> dict:
    """The operations a sampler book adds to its symbols' sampler
    lifecycles, the market counted once a path: bootstrap, the market's
    index uniforms (a Philox call a path's four rows); Heston, two
    Box-Muller pairs a double-bar step (one Philox call) and the mixes of
    both pairs a symbol and bar; the curve's fused multiply-add a symbol and
    bar, the fold a bar."""
    bars = n_paths * num_bars
    if sampler == "heston":
        pairs = bars / 2
        return dict(f32=8 * pairs + bars * (n_sym * 6 + 3), sfu=4 * pairs,
                    imul=PHILOX_IMULS * pairs)
    return dict(f32=bars * (n_sym + 3), sfu=0.0, imul=PHILOX_IMULS * bars / 4)


def book_sampler_argv(engine: bool, sampler: str, csv: str) -> list:
    """The main path's ``book`` arguments under ``sampler`` on the history
    ``csv`` (the bootstrap samplers)."""
    argv = book_argv(engine) + ["--sampler", sampler]
    if sampler != "heston":
        argv += ["--bars-csv", csv]
    if sampler == "block_bootstrap":
        argv += ["--block-len", str(SAMPLER_BLOCK_LEN)]
    return argv


def book_sampler_phases(dev, card, reset, cli) -> list:
    """Phases 27-28: the book sampler kernels (#7', #12') under bootstrap,
    block bootstrap and Heston: injected uniforms on a 3-symbol book whose
    symbols have their own histories, with and without noise, against the
    plain version on CPU copies path by path (every symbol and the book,
    every differing path traced); Philox on the 3-symbol book at 2^16
    against the plain version on the card path by path; swapping two
    symbols' histories swaps their rows, and one shared [1, 5, H] table
    equals its copies; the CLI's ``book [--engine] --backend cuda --sampler
    S`` at 100 symbols x 2^20 x 40 on a year of 1-minute bars; the main
    path's kernel against the plain version on the card (a book of its
    symbols 0, 11, ..., 99 at 2^16).  Returns their entries
    of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.io import native
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 MarketLayout)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import (bootstrap_tables,
                                                                   universe_tables)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import BookCurve
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import engine_knobs
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig, LifecycleOutcome
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    cpu = torch.device("cpu")
    params = EngineParams.default()
    gate = GateConfig.from_params(params)
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = [float(x) for x in UNI3_S0], [float(x) for x in UNI3_SIGMA]
    b3, w3 = list(BOOK3_BETAS), list(BOOK3_WEIGHTS)
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    sym_ulp = [r_ulp(max(s0_3[i], *(r["price"] for r in UNI3_ROWS[i])), sp)
               for i, sp in enumerate(p3.stop_padding.tolist())]
    # the book's R is sum_s w_s R_s with sum_s w_s = 1: its drift is at most
    # the symbols' largest price ulp in R a trade of the book (and one more)
    ulps4 = sym_ulp + [max(sym_ulp)]
    lv100 = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                             {"color": "orange", "type": "dashed", "index": 0,
                              "price": x + 0.4}] for x in BOOK_S0], max_levels=4)
    book100 = (lv100, params, BOOK_S0, [SIGMA] * BOOK_SYMBOLS, BOOK_BETAS,
               [1.0 / BOOK_SYMBOLS] * BOOK_SYMBOLS)
    t0 = time.perf_counter()
    tables3 = universe_tables(universe_history(3, ROWS_INJECT_HIST_BARS, 41))
    tmp = tempfile.TemporaryDirectory()
    csv = os.path.join(tmp.name, "bars.csv")
    write_history(csv, SAMPLER_HIST_BARS)
    cols = native.parse_bars_csv(csv)
    tables1 = torch.stack(bootstrap_tables(*(cols[k] for k in "ohlcv")))[None].to(dev)
    table_bytes = tables1.numel() * 4
    log(f"[27-28] histories: 3 symbols x {ROWS_INJECT_HIST_BARS} bars; the CLI's "
        f"{SAMPLER_HIST_BARS}-bar CSV, one [1, 5, H] table every symbol shares "
        f"({table_bytes} bytes); {time.perf_counter() - t0:.3f} s")

    def skw(s, tables):
        return (dict(sampler=s) if s == "heston" else
                dict(sampler=s, tables=tables, block_len=SAMPLER_BLOCK_LEN))

    entries = []
    for family, ph in (("gated", "27"), ("engine", "28")):
        eng = family == "engine"
        mod = cuda_engine if eng else cuda_gated
        lanes = ENGINE_LANES if eng else GATED_LANES
        p3f = p3.replace(q_min_prob=[0.60, 0.40, 0.55]) if eng else p3
        kname = "mc_engine_rows_corr_sampler" if eng else "mc_gated_corr_sampler"
        source = BOOK_ROWS_SOURCE if eng else GATED_CORR_SAMPLER_SOURCE
        replaces = ENGINE_CORR_REPLACES if eng else GATED_CORR_REPLACES
        Lay = EngineLayout if eng else GatedLayout

        def rows_fn(seed, book, n, s, tables, nz=None, ext=None, m_ext=None, per_path=False):
            kw = dict(paths_per_symbol=n, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=nz,
                      external_uniforms=ext, market_uniforms=m_ext, device=dev,
                      per_path=per_path, **skw(s, tables))
            if eng:
                return cuda_engine.engine_corr_rows(seed, *book, **kw)
            return cuda_gated.gated_corr_rows(seed, *book[:6], gate, **kw)

        def plain_fn(seed, book, n, s, tables, nz=None, ext=None, m_ext=None, device=dev,
                     **extra):
            kw = dict(paths_per_symbol=n, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=nz,
                      external_uniforms=ext, market_uniforms=m_ext, device=device,
                      **skw(s, tables), **extra)
            if eng:
                return cuda_engine.engine_corr_totals_reference(seed, *book, **kw)
            return cuda_gated.gated_corr_totals_reference(seed, *book[:6], gate, **kw)

        book3 = (lv3, p3f, s0_3, sg_3, b3, w3)
        err = {s: 0.0 for s in SAMPLERS}
        nb = BOOK_SAMPLER_INJECT_BLOCKS[family]
        n_inj = nb * 8 * lanes
        log(f"[{ph}] {family} book samplers "
            f"({'mc_engine_book_rows' if eng else kname}_kernel, {source.split('/')[-1]}): "
            f"injected uniforms, 3 symbols x {n_inj} paths (own histories, levels, s0, "
            "sigma, beta, weight, knobs; [S] noise stds), kernel vs plain on CPU copies path "
            "by path, every differing path traced"
            + ("; kernel vs the parent (mc_engine_corr_sampler_kernel) bit for bit" if eng
               else ""))
        for s in SAMPLERS:
            samp = make_sampler(s, tables=tables3, block_len=SAMPLER_BLOCK_LEN, symbols=3)
            for nz in (None, noise3):
                case = f"{s}{'+noise' if nz is not None else ''}"
                rng = np.random.default_rng(2700 + 10 * int(ph) + len(case))
                u = torch.from_numpy(rng.uniform(1e-6, 1.0, (
                    3, nb, Lay(NUM_BARS, nz is not None, s, True).u_rows, 8, lanes)).astype(
                        np.float32))
                um = torch.from_numpy(rng.uniform(1e-6, 1.0, (
                    nb, MarketLayout(NUM_BARS, s).u_rows, 8, lanes)).astype(np.float32))
                want = plain_fn(0, book3, n_inj, s, tables3, nz, u, um, device=cpu,
                                per_path=True)
                pc, pf, prow = rows_fn(0, book3, n_inj, s, tables3, nz, u.to(dev), um.to(dev),
                                       per_path=True)
                if eng:
                    same_as_parent(f"engine book {case}", cuda_engine,
                                   lambda s=s, nz=nz, u=u, um=um: rows_fn(
                                       0, book3, n_inj, s, tables3, nz, u.to(dev), um.to(dev),
                                       per_path=True))
                got = (*mod.reduce_rows(pc, pf), prow)
                torch.cuda.synchronize()

                def symbol_runs(i, on_card, idx, u=u, um=um, nz=nz, samp=samp):
                    """Symbol i's plain lifecycle over the bars the plain version
                    makes on the CPU or on the card (``book_phases``' trace)."""
                    src = dev if on_card else cpu
                    kw = dict(s0=s0_3[i], mu=0.0, sigma=sg_3[i], dt=DT,
                              market_uniforms=um.to(src), beta=b3[i], sampler=samp.row(i))
                    if eng:
                        bars, tie, nzs = cuda_engine.engine_bars_from_uniforms(
                            u[i].to(src), EngineLayout(NUM_BARS, nz is not None, s, True),
                            **kw)
                        pick = type(bars)(*(x[idx.to(src)] for x in bars))
                        rows, ints, eq, _ = engine_trace(
                            pick, tie[idx.to(src)], None if nzs is None else nzs[:, idx.to(src)],
                            grid_row(lv3, i), grid_row(p3f, i), engine_knobs(),
                            grid_row(nz, i), src)
                        return eq, rows[:, :6], ints
                    bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(
                        u[i].to(src), GatedLayout(NUM_BARS, nz is not None, s, True), **kw)
                    pick = type(bars)(*(x[idx.to(src)].cpu() for x in bars))
                    out, ints, floats = lifecycle_trace(
                        pick, tie[idx.to(src)].cpu(),
                        None if nzs is None else nzs[:, idx.to(src)].cpu(), grid_row(lv3, i),
                        grid_row(p3f, i), gate, grid_row(nz, i))
                    return floats[:, :, 3], cuda_gated.lifecycle_rows(out), ints

                def trace_one(i, d, u=u, um=um, nz=nz, samp=samp, prow=prow, want=want):
                    kw = dict(s0=s0_3[i], market=(um, b3[i]), sampler=samp.row(i),
                              drift_ok=True)
                    if eng:
                        return trace_engine_flips(
                            f"{case} symbol {i}", u[i], d, prow[i].cpu(), want[2][i].cpu(),
                            grid_row(lv3, i), grid_row(p3f, i), {}, sg_3[i], grid_row(nz, i),
                            False, dev, **kw)
                    return trace_flips(f"{case} symbol {i}", u[i], d, prow[i].cpu(),
                                       want[2][i].cpu(), grid_row(lv3, i), grid_row(p3f, i),
                                       gate, grid_row(nz, i), False, dev, sigma=sg_3[i], **kw)

                def trace_book(d, prow=prow, want=want, symbol_runs=symbol_runs):
                    idx = torch.nonzero(d).flatten()
                    if idx.numel() == 0:
                        return
                    books, parted = [], torch.zeros(idx.numel(), dtype=torch.bool)
                    runs = [[symbol_runs(i, on_card, idx) for i in range(3)]
                            for on_card in (False, True)]
                    for side in runs:
                        bk = BookCurve(idx.numel(), NUM_BARS)
                        for (eq, rows, _), w in zip(side, w3):
                            bk.add_curve(w, eq.cpu().T.contiguous())
                            rows = rows.cpu()
                            bk.add_symbol(LifecycleOutcome(
                                equity=rows[:, 0], trades=rows[:, 1].int(),
                                wins=rows[:, 2].int(), losses=rows[:, 3].int(),
                                open_at_end=rows[:, 4] > 0, max_dd=rows[:, 5]))
                        books.append(cuda_gated.lifecycle_rows(bk.outcome()))
                    for (_, _, i_cpu), (_, _, i_dev) in zip(*runs):
                        parted |= (i_cpu.cpu() != i_dev.cpu()).flatten(1).any(dim=1)
                    if not torch.equal(books[1], prow[3].cpu()[idx][:, :6]):
                        raise AssertionError(f"{case}: the kernel's book differs from the "
                                             "plain book on the card's bars")
                    if not torch.equal(books[0], want[2][3].cpu()[idx][:, :6]):
                        raise AssertionError(f"{case}: the traced book differs from the "
                                             "plain version")
                    n_drift = drift_only(f"{case} book", parted, prow[3].cpu()[idx],
                                         want[2][3].cpu()[idx], None, [1, 2, 3, 4])
                    log(f"  {case} book: {idx.numel() - n_drift} differing paths, each traced "
                        "to a flipped decision of a symbol; kernel == plain book on the card's "
                        "bars")

                for i in range(4):
                    name = f"{case} " + ("book" if i == 3 else f"symbol {i}")
                    e, _ = compare_lifecycle(
                        name, tuple(x[i] for x in want), tuple(x[i] for x in got), n_inj,
                        engine=eng, tie_ulp=ulps4[i],
                        trace=(lambda d, i=i, trace_one=trace_one: trace_one(i, d)) if i < 3
                        else trace_book)
                    err[s] = max(err[s], e)
                if eng and bool(want[0][3, 6:23].any()):
                    raise AssertionError("the engine book's escalation and skip columns "
                                         "are not zero")

        n_ph = BOOK_SAMPLER_PHILOX_PATHS
        log(f"[{ph}] {family} book samplers, Philox: 3 symbols x {n_ph} paths, kernel vs "
            "plain on the card path by path; two symbols' histories swapped; one shared "
            "history against its copies")
        for s in SAMPLERS:
            want = plain_fn(3, book3, n_ph, s, tables3, per_path=True, chunk_blocks=64)
            pc, pf, prow = rows_fn(3, book3, n_ph, s, tables3, per_path=True)
            if eng:
                same_as_parent(f"engine book {s} philox", cuda_engine,
                               lambda s=s: rows_fn(3, book3, n_ph, s, tables3, per_path=True))
            err[s] = max(err[s], same_on_card(f"{s} philox", want,
                                              (*mod.reduce_rows(pc, pf), prow), 4, n_ph,
                                              lambda i: "book" if i == 3 else f"symbol {i}",
                                              engine=eng))
            if s == "heston":
                continue
            # symbols 0 and 1 alike but for their histories (and their keys,
            # swapped with them): swapping the histories swaps their rows
            twin = (U.stack_levels([UNI3_ROWS[0]] * 3, max_levels=8), params,
                    [s0_3[0]] * 3, [sg_3[0]] * 3, b3, w3)
            u1 = torch.from_numpy(np.random.default_rng(2790 + int(ph)).uniform(
                1e-6, 1.0, (1, 1, Lay(NUM_BARS, False, s, True).u_rows, 8, lanes)).astype(
                    np.float32)).expand(3, -1, -1, -1, -1).contiguous().to(dev)
            um1 = torch.from_numpy(np.random.default_rng(2791 + int(ph)).uniform(
                1e-6, 1.0, (1, MarketLayout(NUM_BARS, s).u_rows, 8, lanes)).astype(
                    np.float32)).to(dev)
            a = rows_fn(0, twin, 8 * lanes, s, tables3, ext=u1, m_ext=um1, per_path=True)[2]
            b = rows_fn(0, twin, 8 * lanes, s, tables3[[1, 0, 2]], ext=u1, m_ext=um1,
                        per_path=True)[2]
            if not (torch.equal(a[0], b[1]) and torch.equal(a[1], b[0])
                    and torch.equal(a[2], b[2]) and not torch.equal(a[0], a[1])):
                raise AssertionError(f"{s}: swapping two symbols' histories does not swap "
                                     "their rows")
            one = rows_fn(3, book3, n_ph, s, tables3[:1], per_path=True)
            copies = rows_fn(3, book3, n_ph, s, tables3[:1].expand(3, -1, -1).contiguous(),
                             per_path=True)
            if not all(torch.equal(x, y) for x, y in zip(one, copies)):
                raise AssertionError(f"{s}: one shared table differs from its copies")
            log(f"  {s}: history swap swaps rows 0 and 1 bit for bit; [1, 5, H] == "
                "[3, 5, H] copies bit for bit")

        pick = CARD_PLAIN_PICK
        n_cmp = len(pick)
        cmp_book = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0,
                                      "price": BOOK_S0[i]},
                                     {"color": "orange", "type": "dashed", "index": 0,
                                      "price": BOOK_S0[i] + 0.4}] for i in pick],
                                   max_levels=4),) + tuple(
            [x[i] for i in pick] if isinstance(x, list) else x for x in book100[1:])
        log(f"[{ph}] main path: {BOOK_SYMBOLS} symbols x {BOOK_PATHS} paths x {NUM_BARS} bars "
            f"on the {SAMPLER_HIST_BARS}-bar history; kernel vs plain on the card at "
            f"{BOOK_SAMPLE_PATHS} paths a symbol on its symbols {pick}, a book of their own")
        for s in SAMPLERS:
            tb = None if s == "heston" else tables1
            extra = dict(per_path=True, chunk_blocks=64 if not eng else 256)
            if not eng:
                extra["work"] = True
            res, plain_ms = timed(lambda: plain_fn(0, cmp_book, BOOK_SAMPLE_PATHS, s, tb,
                                                   **extra))
            krows = rows_fn(0, cmp_book, BOOK_SAMPLE_PATHS, s, tb, per_path=True)
            err[s] = max(err[s], same_on_card(
                f"{family} book {s}", res[:3], (*mod.reduce_rows(krows[0], krows[1]), krows[2]),
                n_cmp + 1, BOOK_SAMPLE_PATHS,
                lambda i: "the book" if i == n_cmp else f"symbol {i}", engine=eng))
            del krows
            sample_ms = cuda_ms(lambda: rows_fn(0, cmp_book, BOOK_SAMPLE_PATHS, s, tb), 1)
            rows_fn(0, book100, BOOK_PATHS, s, tb)                     # warm
            main_ms = cuda_ms(lambda: rows_fn(0, book100, BOOK_PATHS, s, tb), 2)
            parent_ms = (cuda_ms(parent_run(cuda_engine, lambda: rows_fn(
                0, book100, BOOK_PATHS, s, tb)), 1) if eng else None)
            sc = res[0].cpu()
            scale = BOOK_PATHS / BOOK_SAMPLE_PATHS * BOOK_SYMBOLS / n_cmp
            # the sample's work (its n_cmp symbols, for the engine) scaled to
            # the main path's symbol-paths
            if eng:
                ops, gathers = engine_sampler_ops(s, BOOK_SYMBOLS * BOOK_PATHS,
                                                  sc[:n_cmp].sum(0), scale)
            else:
                ops, gathers = gated_sampler_ops(
                    s, BOOK_SYMBOLS * BOOK_PATHS, float(res[3].sum()) * scale,
                    float(sc[:-1, 5].sum()) * scale)
            for k, v in book_sampler_market_ops(s, BOOK_PATHS, BOOK_SYMBOLS).items():
                ops[k] = ops[k] + v
            row_bytes = (BOOK_SYMBOLS + 1) * grid_size(BOOK_PATHS) * (
                mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 4)
            bound = gather_bound(card, row_bytes, ops, gathers,
                                 0.0 if s == "heston" else table_bytes)
            log(f"  {s}: kernel alone at {BOOK_SYMBOLS} x {BOOK_PATHS} paths {main_ms:.3f} ms "
                f"({BOOK_SYMBOLS * BOOK_PATHS / main_ms * 1e3:.6e} paths x symbols/s), bound "
                f"{bound['bound_ms']:.3f} ms {bound['bound_parts']}; at {n_cmp} x "
                f"{BOOK_SAMPLE_PATHS}: kernel {sample_ms:.3f} ms, plain on the card "
                f"{plain_ms:.3f} ms" + (f"; the parent at {BOOK_SYMBOLS} x {BOOK_PATHS} "
                                        f"{parent_ms:.3f} ms" if eng else ""))
            with tempfile.TemporaryDirectory() as db:
                argv = ["--db", os.path.join(db, "smoke.db")] + book_sampler_argv(eng, s, csv)
                log(f"  main path: cli book{' --engine' if eng else ''} --backend cuda "
                    f"--sampler {s}" + ("" if s == "heston" else " --bars-csv (a year)"))
                lines, secs, launches = run_cli(
                    cli, argv, reset, {kname: 1, f"mc_{family}_corr_reduce_rows": 1},
                    work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
            check_book_output(lines, BOOK_SYMBOLS, eng)
            log(f"  book row: {json.dumps(lines[-1])}")
            entries.append(entry(f"{kname}/{s}", source, replaces, launches[kname], err[s],
                                 main_ms, plain_ms, bound, sampler=s, symbols=BOOK_SYMBOLS,
                                 paths=BOOK_PATHS, plain_symbols=n_cmp,
                                 plain_paths=BOOK_SAMPLE_PATHS,
                                 kernel_ms_at_plain_size=sample_ms, cli_s=secs[1:],
                                 **({"parent_ms": parent_ms} if eng else {})))
    tmp.cleanup()
    return entries


# ---- the engine's envelope (phases 29-30): the reference's recovered
# 30-level session (qmmx_monolithic.py:2712-2755) over a trading day of
# 1-minute bars
ENV_LEVELS = 30
ENV_BARS = 390
ENV_PATHS = 1 << 24             # paths --engine at the envelope (the CLI and the kernel alone)
ENV_PHILOX_PATHS = 1 << 16      # Philox, kernel vs plain on the card
ENV_DAY_INJECT_BLOCKS = 4       # 30 levels x 390 bars injected: 4 x 8 x 256 = 2^13 paths
ENV_INJECT_BLOCKS = 1           # the other injected shapes: 2048 paths
ENV_PARENT_PATHS = 1 << 20      # the envelope kernel against its parent, bit for bit
ENV_ROW_PATHS = 1 << 16         # sweep rows and universe symbols against one-row launches
ENV_SWEEP_PATHS = 1 << 20       # sweep --engine at the envelope: 18 rows
ENV_UNI_SYMBOLS = 8
ENV_SAMPLER_INJECT_BLOCKS = {ENV_BARS: 1, 25: 1}
ENV_BOOK_SYMBOLS = 10
ENV_BOOK_PATHS = 1 << 20
ENV_BOOK_PLAIN_PATHS = 1 << 14  # a symbol: the book's plain version on the card ...
ENV_BOOK_PARENT_PATHS = 1 << 16  # a symbol: the book kernels forced at the parent's shape
ENV_BOOK_PLAIN_PICK = [0, 9]    # ... on a book of its first and last symbol (launch-bound,
                                # ~20 ms a bar-step)
ENV_SWEEP_PLAIN_ROWS = [1]      # the sweep's plain version on its row 1 (jitter 0.02) x 2048 paths
WIDE_SOURCE = CSRC + "mc_engine_wide.cu"
WIDE_SAMPLER_SOURCE = CSRC + "mc_engine_wide_samplers.cu"
WIDE_CORR_SOURCE = CSRC + "mc_engine_wide_corr.cu"
WIDE_CORR_SAMPLER_SOURCE = CSRC + "mc_engine_wide_corr_samplers.cu"
WIDE_REPLACES = ENGINE_REPLACES + " (#8-#11)"


def env_ladder(n: int, s0: float = 100.0, step: float = 0.12) -> list:
    """tests/test_engine_envelope.py's n-level ladder around ``s0`` (four
    colours x solid/dashed, 0.12 apart), as DB rows, cents-rounded."""
    return [{"color": ("blue", "orange", "black", "teal")[i % 4],
             "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
             "price": round(s0 + (i - n // 2) * step, 2)} for i in range(n)]


@contextlib.contextmanager
def forced_envelope(CE):
    """While open, ``cuda_engine`` launches the envelope kernels even where
    their parents fit (its ``_FORCE_ENVELOPE`` hook)."""
    CE._FORCE_ENVELOPE = True
    try:
        yield
    finally:
        CE._FORCE_ENVELOPE = False


def forced(CE, fn):
    """``fn`` as a launch that runs under ``forced_envelope``."""
    def run():
        with forced_envelope(CE):
            return fn()
    return run


@contextlib.contextmanager
def forced_parent(CE):
    """While open, ``cuda_engine`` launches the parents the rows kernel
    replaced (mc_engine_sweep_kernel, mc_engine_sampler_kernel) where the
    rows kernel would run (its ``_FORCE_PARENT`` hook)."""
    CE._FORCE_PARENT = True
    try:
        yield
    finally:
        CE._FORCE_PARENT = False


def parent_run(CE, fn):
    """``fn`` as a launch that runs under ``forced_parent``."""
    def run():
        with forced_parent(CE):
            return fn()
    return run


def same_as_parent(name: str, CE, launch) -> None:
    """``launch()`` on the rows kernel (mc_engine_rows.cu; a book's
    mc_engine_book_rows.cu) and on the parent it replaced: every output
    tensor (partial rows, per-path rows) equal bit for bit, or raise."""
    import torch

    got = launch()
    want = parent_run(CE, launch)()
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the rows kernel differs from the parent kernel")
    log(f"  {name}: the rows kernel == the parent bit for bit (partial counts "
        f"{count_digest(got[0])})")


def envelope_phases(dev, card, reset, cli) -> list:
    """Phases 29-30: the envelope kernels (``mc_engine_wide*.cu``) at 30
    levels x 390 bars and the envelope's other shapes.  [29] gbm: injected
    uniforms against the plain version on CPU copies path by path (30 x 40,
    64 x 16, 8 x 62, 8 x 63 with noise and antithetic, 3 x 25, 30 x 390 at
    2^14), every differing path traced; Philox at 30 x 390 x 2^16 against the
    plain version on the card; the envelope kernel at 3 levels x 40 bars equal
    to the parent bit for bit at 2^20, both timed at 2^28; the sweep's 18 rows
    and 8 universe symbols each equal to its one-row launch at 30 x 390, its
    jitter row against the plain version on the card path by path at 2048
    paths; ``paths --engine`` at 2^24 and ``sweep --engine`` at 2^20 x
    18 rows on a 30-level DB at 390 bars.  [30] the samplers at 30 x 390 (a
    recorded year) and at W 25, injected and Philox, ``paths --engine
    --sampler`` at 2^24; the books (gbm and the samplers) at 10 symbols x 30
    levels x 390 x 2^20 through the Python entry, a book of its symbols 0 and
    9, every symbol and the book, against the plain version on the card path
    by path at 2^14 a symbol, and forced at 3 x 3 levels x 40 bars equal to
    the parent book kernels bit for bit.  Returns their ``kernels`` entries."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.io import db as qdb
    from qmmx_monolithic_monte_carlo_tpu_torch.io import native
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    CE = cuda_engine
    params = EngineParams.default()
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02,
                         stop_slip_std=0.015, target_slip_std=0.015)
    lv30 = Levels.from_rows(env_ladder(ENV_LEVELS), max_levels=ENV_LEVELS)
    lanes = ENGINE_LANES
    row_bytes_1 = grid_size(ENV_PATHS) * (CE.ROW_COUNTS * 8 + CE.ROW_FLOATS * 4)
    tmp = tempfile.TemporaryDirectory()
    db_path = os.path.join(tmp.name, "env.db")
    conn = qdb.db_connect(db_path)
    qdb.db_init(conn)
    qdb.replace_levels(conn, env_ladder(ENV_LEVELS))
    conn.close()
    csv = os.path.join(tmp.name, "bars.csv")
    write_history(csv, SAMPLER_HIST_BARS)
    cols = native.parse_bars_csv(csv)
    tables = torch.stack(bootstrap_tables(*(cols[k] for k in "ohlcv")))
    table_bytes = tables.numel() * 4

    def skw(s):
        return ({} if s == "gbm" else dict(sampler=s) if s == "heston" else
                dict(sampler=s, tables=tables, block_len=SAMPLER_BLOCK_LEN))

    def injected(case, n_lv, w, nz, anti, nb, s="gbm", seed=0):
        """Injected uniforms: the envelope kernel on the card against the
        plain version on CPU copies, path by path, every differing path
        traced (a non-gbm ``s`` under its sampler)."""
        lv = Levels.from_rows(env_ladder(n_lv), max_levels=n_lv)
        rng = np.random.default_rng(2900 + seed)
        u = torch.from_numpy(rng.uniform(1e-6, 1.0, (
            nb, EngineLayout(w, nz is not None, s).u_rows, 8, lanes)).astype(np.float32))
        n = nb * 8 * lanes
        kw = dict(num_paths=n, num_bars=w, sigma=SIGMA, dt=DT, lanes=lanes, noise=nz,
                  antithetic=anti, per_path=True, **skw(s))
        want = CE.engine_totals_reference(0, lv, params, external_uniforms=u, harvest=True,
                                          **kw)
        name = "mc_engine_wide" + ("" if s == "gbm" else "_sampler")
        before = CE.LAUNCHES[name]
        pc, pf, rows = CE.engine_rows(0, lv, params, device=dev, external_uniforms=u.to(dev),
                                      **kw)
        got = (*CE.reduce_rows(pc, pf), rows)
        *h_rows, h_c, h_s = CE.engine_rows(0, lv, params, device=dev,
                                           external_uniforms=u.to(dev), harvest=True, **kw)
        torch.cuda.synchronize()
        if CE.LAUNCHES[name] != before + 1:
            raise AssertionError(f"{case}: the launch did not go to {name}")
        same_launch(case, (pc, pf, rows), h_rows)
        samp = None if s == "gbm" else make_sampler(s, tables=tables,
                                                    block_len=SAMPLER_BLOCK_LEN)
        err, _ = compare_lifecycle(
            case, want, got, n, engine=True, num_bars=w,
            tie_ulp=r_ulp(max(env_ladder(n_lv), key=lambda r: r["price"])["price"],
                          float(params.stop_padding)),
            trace=lambda d: trace_engine_flips(case, u, d, rows.cpu(), want[2].cpu(), lv,
                                               params, {}, SIGMA, nz, anti, dev,
                                               sampler=samp, num_bars=w))
        check_harvest(case, name + "_harvest", CE.reduce_harvest(h_c, h_s), want[3], rows,
                      want[2], max(r["price"] for r in env_ladder(n_lv)) + 1.0)
        return err

    def philox(case, lv, w, n, s="gbm", nz=None):
        """Philox: kernel against the plain version on the card, equal on
        every path (one device's transcendentals); logs the digests of the
        kernel's folded int64 totals and of its harvest's counts at seed 7
        (``count_digest``); returns (error, plain ms, the plain version's
        int64 counts)."""
        kw = dict(num_paths=n, num_bars=w, sigma=SIGMA, dt=DT, lanes=lanes, noise=nz,
                  per_path=True, **skw(s))
        want, plain_ms = timed(lambda: CE.engine_totals_reference(
            7, lv, params, device=dev, chunk_blocks=n // (8 * lanes), harvest=True, **kw))
        pc, pf, rows = CE.engine_rows(7, lv, params, device=dev, **kw)
        got = (*CE.reduce_rows(pc, pf), rows)
        err, differ = compare_lifecycle(case, want, got, n, engine=True, num_bars=w)
        if bool(differ.any()):
            raise AssertionError(f"{case}: kernel and plain on the card differ on "
                                 f"{int(differ.sum())} paths")
        *h_rows, h_c, h_s = CE.engine_rows(7, lv, params, device=dev, harvest=True, **kw)
        same_launch(case, (pc, pf, rows), h_rows)
        h_got = CE.reduce_harvest(h_c, h_s)
        check_harvest(case, "mc_engine_wide" + ("" if s == "gbm" else "_sampler") + "_harvest",
                      h_got, want[3], rows, want[2], 2 * 100.0)
        log(f"  {case}: count digests (the totals, the harvest's): {count_digest(got[0])}, "
            f"{count_digest(h_got.ml_counts, h_got.pol_counts)}")
        return err, plain_ms, want[0].cpu()

    entries = []
    # ---------------------------------------------------------------- [29]
    log(f"[29] gbm engine envelope (mc_engine_wide_kernel, mc_engine_wide.cu): injected "
        "uniforms, kernel vs plain on CPU copies path by path, every differing path traced")
    for name in ("mc_engine_wide", "mc_engine_wide_samplers", "mc_engine_wide_harvest",
                 "mc_engine_wide_samplers_harvest"):
        for fn, res in sorted(ptxas_resources(build.BUILD_LOG.get(name, {}).get("log", ""))
                              .items()):
            log(f"  ptxas {fn[:72]}: {res}")
    err = 0.0
    for case, n_lv, w, nz, anti, nb in (
            ("30 levels, W 40", 30, 40, None, False, ENV_INJECT_BLOCKS),
            ("64 levels, W 16", 64, 16, None, False, ENV_INJECT_BLOCKS),
            ("8 levels, W 62", 8, 62, None, False, ENV_INJECT_BLOCKS),
            ("8 levels, W 63, noise, antithetic", 8, 63, noise, True, ENV_INJECT_BLOCKS),
            ("3 levels, W 25", 3, 25, None, False, ENV_INJECT_BLOCKS),
            (f"30 levels, W {ENV_BARS}", 30, ENV_BARS, None, False, ENV_DAY_INJECT_BLOCKS)):
        err = max(err, injected(case, n_lv, w, nz, anti, nb, seed=n_lv + w))
    log(f"[29] Philox at {ENV_LEVELS} levels x {ENV_BARS} bars x {ENV_PHILOX_PATHS} paths, "
        "kernel vs plain on the card; the envelope kernel vs its parent at 3 levels x "
        f"{NUM_BARS} bars x {ENV_PARENT_PATHS} paths")
    e, plain_ms, counts = philox("philox", lv30, ENV_BARS, ENV_PHILOX_PATHS)
    err = max(err, e)
    HV_PLAIN["mc_engine_wide_harvest"] = dict(ms=plain_ms, paths=ENV_PHILOX_PATHS,
                                              num_bars=ENV_BARS, levels=ENV_LEVELS)
    HV_MAIN["env_counts"] = counts
    cli_levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    pkw = dict(num_paths=ENV_PARENT_PATHS, num_bars=NUM_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
               noise=noise, per_path=True, device=dev)
    parent = parent_run(CE, lambda: CE.engine_rows(3, cli_levels, params, **pkw))()
    with forced_envelope(CE):
        wide = CE.engine_rows(3, cli_levels, params, **pkw)
    if not all(torch.equal(a, b) for a, b in zip(parent, wide)):
        raise AssertionError("the envelope kernel differs from its parent where both fit")
    del parent, wide
    log("  the envelope kernel == mc_engine_sweep_kernel bit for bit: partial rows and "
        "every path's row")
    # what the parent saves where both fit: phase 11's kernel, its shape and inputs
    kw11 = dict(num_paths=MAIN_PATHS, num_bars=NUM_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
                device=dev)
    parent_ms = cuda_ms(parent_run(CE, lambda: CE.engine_rows(0, cli_levels, params, **kw11)), 1)
    with forced_envelope(CE):
        forced_ms = cuda_ms(lambda: CE.engine_rows(0, cli_levels, params, **kw11), 1)
    log(f"  at 3 levels x {NUM_BARS} bars x {MAIN_PATHS} paths: the parent {parent_ms:.3f} ms, "
        f"the envelope kernel forced {forced_ms:.3f} ms ({forced_ms / parent_ms:.3f}x)")
    HV_MAIN["forced_3x40_ms"] = forced_ms        # phase 31's harvest kernel against it

    grid18 = [(sp, tp, j) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)
              for j in (0.0, 0.02)]
    g_params = params.replace(stop_padding=[c[0] for c in grid18],
                              tp_padding=[c[1] for c in grid18])
    jit = torch.tensor([c[2] for c in grid18])
    g_noise = McNoise(level_jitter_std=jit, entry_slip_std=torch.zeros_like(jit),
                      stop_slip_std=torch.zeros_like(jit), target_slip_std=torch.zeros_like(jit))
    rkw = dict(num_paths=ENV_ROW_PATHS, num_bars=ENV_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
               per_path=True, device=dev)
    pc, pf, rows = CE.engine_sweep_rows(5, lv30, g_params, noise=g_noise, **rkw)
    log(f"  the sweep's 18 rows at seed 5: count digest {count_digest(CE.reduce_rows(pc, pf)[0])}")
    for g in range(len(grid18)):
        one = CE.engine_rows(5, lv30, grid_row(g_params, g), noise=grid_row(g_noise, g), **rkw)
        if not (torch.equal(pc[g], one[0]) and torch.equal(pf[g], one[1])
                and torch.equal(rows[g], one[2])):
            raise AssertionError(f"sweep row {g} differs from its one-row launch")
    s0_u = [100.0 + i for i in range(ENV_UNI_SYMBOLS)]
    lv_u = U.stack_levels([env_ladder(ENV_LEVELS, s0) for s0 in s0_u], max_levels=ENV_LEVELS)
    ukw = dict(paths_per_symbol=ENV_ROW_PATHS, num_bars=ENV_BARS, dt=DT, lanes=lanes,
               per_path=True, device=dev)
    pc, pf, rows = CE.engine_universe_rows(6, lv_u, params, s0_u, UNI_SIGMA, **ukw)
    for s in range(ENV_UNI_SYMBOLS):
        one = CE.engine_rows(6, grid_row(lv_u, s), params, num_paths=ENV_ROW_PATHS,
                             num_bars=ENV_BARS, s0=s0_u[s], sigma=UNI_SIGMA, dt=DT,
                             lanes=lanes, per_path=True, device=dev, symbol=s)
        if not (torch.equal(pc[s], one[0]) and torch.equal(pf[s], one[1])
                and torch.equal(rows[s], one[2])):
            raise AssertionError(f"universe symbol {s} differs from its one-row launch")
    del pc, pf, rows, one
    log(f"  the sweep's {len(grid18)} rows (3 x 3 x jitter 0, 0.02) and {ENV_UNI_SYMBOLS} "
        f"universe symbols (each its own {ENV_LEVELS}-level ladder) at {ENV_BARS} bars x "
        f"{ENV_ROW_PATHS} paths each equal their one-row launch bit for bit, per path included")

    log(f"[29] main path: cli paths --engine --backend cuda on a {ENV_LEVELS}-level DB at "
        f"--num-bars {ENV_BARS}, --num-paths {ENV_PATHS}")
    argv = ["--db", db_path, "paths", "--engine", "--backend", "cuda", "--num-paths",
            str(ENV_PATHS), "--num-bars", str(ENV_BARS), "--sigma", str(SIGMA)]
    (out,), secs, launches = run_cli(cli, argv, reset,
                                     {"mc_engine_wide": 1, "mc_engine_reduce_rows": 1},
                                     n_paths=ENV_PATHS, runs=ENV_RUNS)
    if out["paths"] != float(ENV_PATHS) or not out["trades"] >= out["entered"] > 0:
        raise AssertionError(f"unexpected path counts: {out}")
    kw1 = dict(num_paths=ENV_PATHS, num_bars=ENV_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
               device=dev)
    main_ms = cuda_ms(lambda: CE.engine_rows(0, lv30, params, **kw1), 2)
    HV_MAIN["env_ms"] = main_ms                  # phase 31's harvest kernel against it
    bound = card.bound(bytes_=row_bytes_1, **engine_ops(
        ENV_PATHS, counts, ENV_PATHS / ENV_PHILOX_PATHS, ENV_BARS, ENV_LEVELS))
    log(f"  kernel alone at {ENV_PATHS} paths x {ENV_BARS} bars x {ENV_LEVELS} levels: "
        f"{main_ms:.3f} ms ({ENV_PATHS / main_ms * 1e3:.6e} paths/s), bound "
        f"{bound['bound_ms']:.3f} ms {bound['bound_parts']}; plain on the card at "
        f"{ENV_PHILOX_PATHS}: {plain_ms:.3f} ms")
    entries.append(entry("mc_engine_wide", WIDE_SOURCE, WIDE_REPLACES,
                         launches["mc_engine_wide"], err, main_ms, plain_ms, bound,
                         paths=ENV_PATHS, num_bars=ENV_BARS, levels=ENV_LEVELS,
                         plain_paths=ENV_PHILOX_PATHS, cli_s=secs,
                         parent_ms_3x40=parent_ms, forced_ms_3x40=forced_ms))

    log(f"[29] main path: cli sweep --engine --backend cuda on the {ENV_LEVELS}-level DB, "
        f"--num-bars {ENV_BARS}, --num-paths {ENV_SWEEP_PATHS}, --jitter-stds 0 0.02 (18 rows)")
    argv = ["--db", db_path, "sweep", "--engine", "--backend", "cuda", "--num-paths",
            str(ENV_SWEEP_PATHS), "--num-bars", str(ENV_BARS), "--sigma", str(SIGMA),
            "--jitter-stds", "0", "0.02"]
    lines, secs, launches = run_cli(
        cli, argv, reset, {"mc_engine_bar_sweep": 1, "mc_engine_sweep_reduce_rows": 1},
        n_paths=ENV_SWEEP_PATHS, runs=ENV_RUNS)
    if len(lines) != len(grid18):
        raise AssertionError(f"{len(lines)} sweep rows, not {len(grid18)}")
    skw_ = dict(num_paths=ENV_SWEEP_PATHS, num_bars=ENV_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
                device=dev)
    sweep_ms = cuda_ms(lambda: CE.engine_sweep_rows(0, lv30, g_params, noise=g_noise, **skw_), 1)
    # the plain sweep is launch-bound a row at a time (~20 ms a bar-step): the kernel
    # against it on a grid of the sweep's rows ENV_SWEEP_PLAIN_ROWS (the jitter row),
    # path by path (every row of the sweep equals its one-row launch, above); their work
    # counts (a row's gates) stand for every row's in the bound
    pl_rows = ENV_SWEEP_PLAIN_ROWS
    n_pl, r_pl = 8 * lanes, len(pl_rows)
    pl_grid = params.replace(stop_padding=g_params.stop_padding[pl_rows],
                             tp_padding=g_params.tp_padding[pl_rows])
    pl_noise = McNoise(level_jitter_std=jit[pl_rows], entry_slip_std=torch.zeros(r_pl),
                       stop_slip_std=torch.zeros(r_pl), target_slip_std=torch.zeros(r_pl))
    pl_kw = dict(noise=pl_noise, num_paths=n_pl, num_bars=ENV_BARS, sigma=SIGMA, dt=DT,
                 lanes=lanes, device=dev, per_path=True)
    s_plain, s_plain_ms = timed(lambda: CE.engine_sweep_totals_reference(
        0, lv30, pl_grid, **pl_kw))
    pc, pf, rows = CE.engine_sweep_rows(0, lv30, pl_grid, **pl_kw)
    s_err = same_on_card("envelope sweep", s_plain, (*CE.reduce_rows(pc, pf), rows), r_pl, n_pl,
                         lambda g: f"row {pl_rows[g]} (jitter {float(jit[pl_rows[g]])})")
    del pc, pf, rows
    s_bound = card.bound(bytes_=len(grid18) * grid_size(ENV_SWEEP_PATHS) * (
        CE.ROW_COUNTS * 8 + CE.ROW_FLOATS * 4), **engine_sweep_ops(
            ENV_SWEEP_PATHS, [s_plain[0].sum(0).cpu()] * len(grid18),
            ENV_SWEEP_PATHS / (n_pl * r_pl), ENV_BARS, ENV_LEVELS))
    log(f"  kernel alone at {ENV_SWEEP_PATHS} paths x 18 rows: {sweep_ms:.3f} ms "
        f"({ENV_SWEEP_PATHS * 18 / sweep_ms * 1e3:.6e} paths x rows/s), bound "
        f"{s_bound['bound_ms']:.3f} ms (each path's bars counted once); plain on the card at "
        f"{n_pl} x {r_pl} rows: {s_plain_ms:.3f} ms")
    entries.append(entry("mc_engine_bar_sweep/envelope", BAR_SWEEP_SOURCE,
                         ENGINE_SWEEP_REPLACES, launches["mc_engine_bar_sweep"], s_err,
                         sweep_ms, s_plain_ms, s_bound,
                         paths=ENV_SWEEP_PATHS, grid_rows=len(grid18), num_bars=ENV_BARS,
                         levels=ENV_LEVELS, plain_paths=n_pl, plain_rows=r_pl,
                         cli_s=secs))

    # ---------------------------------------------------------------- [30]
    log(f"[30] engine samplers at the envelope (mc_engine_wide_sampler_kernel, "
        f"mc_engine_wide_samplers.cu): {ENV_LEVELS} levels at W {ENV_BARS} on the "
        f"{SAMPLER_HIST_BARS}-bar history and at W 25 with noise; injected uniforms vs "
        "plain on CPU copies path by path (every differing path traced), Philox vs plain "
        f"on the card at {ENV_PHILOX_PATHS}; cli paths --engine --sampler at {ENV_PATHS}")
    for s in SAMPLERS:
        err = 0.0
        for w, nz in ((ENV_BARS, None), (25, noise)):
            case = f"{s}, W {w}" + (", noise" if nz is not None else "")
            err = max(err, injected(case, ENV_LEVELS, w, nz, False,
                                    ENV_SAMPLER_INJECT_BLOCKS[w], s=s, seed=len(case)))
            e, p_ms, p_counts = philox(f"{case}, philox", lv30, w, ENV_PHILOX_PATHS, s=s, nz=nz)
            err = max(err, e)
            if w == ENV_BARS:
                plain_ms, counts = p_ms, p_counts
                if s == "block_bootstrap":
                    HV_PLAIN["mc_engine_wide_sampler_harvest"] = dict(
                        ms=p_ms, paths=ENV_PHILOX_PATHS, num_bars=w, levels=ENV_LEVELS,
                        sampler=s)
        argv = (["--db", db_path, "paths", "--engine", "--backend", "cuda", "--num-paths",
                 str(ENV_PATHS), "--num-bars", str(ENV_BARS), "--sigma", str(SIGMA),
                 "--sampler", s] + ([] if s == "heston" else ["--bars-csv", csv])
                + (["--block-len", str(SAMPLER_BLOCK_LEN)] if s == "block_bootstrap" else []))
        log(f"  main path: cli paths --engine --backend cuda --sampler {s} at {ENV_PATHS} x "
            f"{ENV_BARS} on the {ENV_LEVELS}-level DB")
        (out,), secs, launches = run_cli(
            cli, argv, reset, {"mc_engine_wide_sampler": 1, "mc_engine_reduce_rows": 1},
            n_paths=ENV_PATHS, runs=ENV_RUNS)
        if out["paths"] != float(ENV_PATHS) or not out["trades"] >= out["entered"] > 0:
            raise AssertionError(f"unexpected path counts: {out}")
        main_ms = cuda_ms(lambda: CE.engine_rows(0, lv30, params, **kw1, **skw(s)), 1)
        ops, gathers = engine_sampler_ops(s, ENV_PATHS, counts, ENV_PATHS / ENV_PHILOX_PATHS,
                                          ENV_BARS, ENV_LEVELS)
        bound = gather_bound(card, row_bytes_1, ops, gathers,
                             0.0 if s == "heston" else table_bytes)
        log(f"  {s}: kernel alone at {ENV_PATHS} paths x {ENV_BARS} bars: {main_ms:.3f} ms "
            f"({ENV_PATHS / main_ms * 1e3:.6e} paths/s), bound {bound['bound_ms']:.3f} ms "
            f"{bound['bound_parts']}; plain on the card at {ENV_PHILOX_PATHS}: "
            f"{plain_ms:.3f} ms")
        entries.append(entry(f"mc_engine_wide_sampler/{s}", WIDE_SAMPLER_SOURCE,
                             WIDE_REPLACES, launches["mc_engine_wide_sampler"], err, main_ms,
                             plain_ms, bound, sampler=s, paths=ENV_PATHS, num_bars=ENV_BARS,
                             levels=ENV_LEVELS, plain_paths=ENV_PHILOX_PATHS, cli_s=secs))

    s0_b = [100.0 + 10.0 * i for i in range(ENV_BOOK_SYMBOLS)]
    lv_b = U.stack_levels([env_ladder(ENV_LEVELS, s0) for s0 in s0_b], max_levels=ENV_LEVELS)
    betas = [0.2 + 0.6 * i / (ENV_BOOK_SYMBOLS - 1) for i in range(ENV_BOOK_SYMBOLS)]
    book = (lv_b, params, s0_b, [SIGMA] * ENV_BOOK_SYMBOLS, betas,
            [1.0 / ENV_BOOK_SYMBOLS] * ENV_BOOK_SYMBOLS)
    pick = ENV_BOOK_PLAIN_PICK
    n_cmp = len(pick)
    cmp_book = (U.stack_levels([env_ladder(ENV_LEVELS, s0_b[i]) for i in pick],
                               max_levels=ENV_LEVELS), params) + tuple(
        [x[i] for i in pick] for x in book[2:])
    log(f"[30] engine books at the envelope (mc_engine_wide_corr_kernel, "
        f"mc_engine_wide_corr(_samplers).cu): {ENV_BOOK_SYMBOLS} symbols x {ENV_LEVELS} levels "
        f"x {ENV_BARS} bars x {ENV_BOOK_PATHS} paths a symbol through "
        f"mc_paths_engine_corr_fused; a book of its symbols {pick}, every symbol and the "
        f"book, vs plain on the card path by path at {ENV_BOOK_PLAIN_PATHS} a symbol")
    tables1 = tables[None].to(dev)
    # the parent's shape: 3 symbols x 3 levels x 40 bars
    par_book = (U.stack_levels([CLI_ROWS] * 3, max_levels=8), params, [100.0, 100.2, 99.8],
                [SIGMA, 0.25, 0.35], [0.2, 0.5, 0.8], [0.5, 0.3, 0.2])
    for s in ("gbm",) + SAMPLERS:
        bkw = dict(num_bars=ENV_BARS, dt=DT, lanes=lanes, device=dev,
                   **({} if s == "gbm" else dict(sampler=s) if s == "heston" else
                      dict(sampler=s, tables=tables1, block_len=SAMPLER_BLOCK_LEN)))
        pkw = dict(bkw, num_bars=NUM_BARS, paths_per_symbol=ENV_BOOK_PARENT_PATHS,
                   per_path=True)
        par = CE.engine_corr_rows(0, *par_book, **pkw)
        env = forced(CE, lambda: CE.engine_corr_rows(0, *par_book, **pkw))()
        if not all(torch.equal(x, y) for x, y in zip(par, env)):
            raise AssertionError(f"book {s}: the envelope kernel forced at 3 levels x "
                                 f"{NUM_BARS} bars differs from the parent book kernel")
        log(f"  {s}: forced at 3 symbols x 3 levels x {NUM_BARS} bars x "
            f"{ENV_BOOK_PARENT_PATHS}, every symbol, the book and every path's row equal "
            f"to the parent's bit for bit (counts {count_digest(CE.reduce_rows(*env[:2])[0])})")
        del par, env
        res, plain_ms = timed(lambda: CE.engine_corr_totals_reference(
            0, *cmp_book, paths_per_symbol=ENV_BOOK_PLAIN_PATHS, per_path=True,
            chunk_blocks=ENV_BOOK_PLAIN_PATHS // (8 * lanes), harvest=True, **bkw))
        krows = CE.engine_corr_rows(0, *cmp_book, paths_per_symbol=ENV_BOOK_PLAIN_PATHS,
                                    per_path=True, **bkw)
        err = same_on_card(f"book {s}", res[:3], (*CE.reduce_rows(krows[0], krows[1]), krows[2]),
                           n_cmp + 1, ENV_BOOK_PLAIN_PATHS,
                           lambda i: "the book" if i == n_cmp else f"symbol {i}")
        *h_rows, h_c, h_s = CE.engine_corr_rows(0, *cmp_book, paths_per_symbol=ENV_BOOK_PLAIN_PATHS,
                                                per_path=True, harvest=True, **bkw)
        same_launch(f"book {s}", krows, h_rows)
        h_got = CE.reduce_harvest(h_c, h_s)
        for j in range(n_cmp):
            check_harvest(f"book {s} symbol {pick[j]}",
                          "mc_engine_wide_corr" + ("" if s == "gbm" else "_sampler") + "_harvest",
                          hv_row(h_got, j), hv_row(res[3], j), krows[2][j], res[2][j],
                          2 * s0_b[pick[j]])
        res = res[:3]
        del krows, h_rows
        if s in ("gbm", "block_bootstrap"):
            HV_PLAIN["mc_engine_wide_corr" + ("" if s == "gbm" else "_sampler") + "_harvest"] = \
                dict(ms=plain_ms, paths=ENV_BOOK_PLAIN_PATHS, symbols=n_cmp, num_bars=ENV_BARS,
                     levels=ENV_LEVELS, sampler=s)
        kname = "mc_engine_wide_corr" + ("" if s == "gbm" else "_sampler")
        log(f"  main path: mc_paths_engine_corr_fused --sampler {s}, {ENV_BOOK_SYMBOLS} x "
            f"{ENV_BOOK_PATHS} x {ENV_BARS} bars, one timed run")
        (sym, port, skips, escal), secs, launches = run_entry(
            f"book {s}", lambda: CE.mc_paths_engine_corr_fused(
                0, *book, paths_per_symbol=ENV_BOOK_PATHS, **bkw),
            reset, {kname: ENV_RUNS, "mc_engine_corr_reduce_rows": ENV_RUNS}, runs=ENV_RUNS)
        check_universe_stats(f"book {s}", sym, ENV_BOOK_SYMBOLS, ENV_BOOK_PATHS)
        if not (math.isfinite(float(port.mean_r)) and float(port.n) == ENV_BOOK_PATHS):
            raise AssertionError(f"book {s}: the book's row is not whole: {port}")
        main_ms = cuda_ms(lambda: CE.engine_corr_rows(0, *book, paths_per_symbol=ENV_BOOK_PATHS,
                                                      **bkw), 1)
        scale = ENV_BOOK_PATHS / ENV_BOOK_PLAIN_PATHS * ENV_BOOK_SYMBOLS / n_cmp
        sc = res[0][:n_cmp].sum(0).cpu()
        n_sp = ENV_BOOK_SYMBOLS * ENV_BOOK_PATHS
        if s == "gbm":
            ops, gathers = engine_ops(n_sp, sc, scale, ENV_BARS, ENV_LEVELS), 0.0
            mk = book_market_ops(ENV_BOOK_PATHS, ENV_BOOK_SYMBOLS, ENV_BARS)
        else:
            ops, gathers = engine_sampler_ops(s, n_sp, sc, scale, ENV_BARS, ENV_LEVELS)
            mk = book_sampler_market_ops(s, ENV_BOOK_PATHS, ENV_BOOK_SYMBOLS, ENV_BARS)
        for k, v in mk.items():
            ops[k] = ops[k] + v
        row_bytes = (ENV_BOOK_SYMBOLS + 1) * grid_size(ENV_BOOK_PATHS) * (
            CE.ROW_COUNTS * 8 + CE.ROW_FLOATS * 4)
        bound = gather_bound(card, row_bytes, ops, gathers,
                             0.0 if s in ("gbm", "heston") else table_bytes)
        log(f"  {s}: kernel alone {main_ms:.3f} ms ({n_sp / main_ms * 1e3:.6e} paths x "
            f"symbols/s, entry wall {secs[-1]:.3f} s), bound {bound['bound_ms']:.3f} ms "
            f"{bound['bound_parts']}; plain on the card at {n_cmp} x "
            f"{ENV_BOOK_PLAIN_PATHS}: {plain_ms:.3f} ms; book mean R {float(port.mean_r):.6f}")
        entries.append(entry(f"{kname}" + ("" if s == "gbm" else f"/{s}"),
                             WIDE_CORR_SOURCE if s == "gbm" else WIDE_CORR_SAMPLER_SOURCE,
                             ENGINE_CORR_REPLACES, launches[kname], err, main_ms, plain_ms,
                             bound, sampler=s, symbols=ENV_BOOK_SYMBOLS, paths=ENV_BOOK_PATHS,
                             num_bars=ENV_BARS, levels=ENV_LEVELS, plain_symbols=n_cmp,
                             plain_paths=ENV_BOOK_PLAIN_PATHS, entry_s=secs))
    tmp.cleanup()
    return entries


# ---- the learning flywheel on the card (phase 31): the closed-trade harvest
# (kernels #8, #10, #12 with harvest=True: the envelope kernels' harvest
# builds, ops/csrc/mc_engine_wide*_harvest.cu) feeding models/harvest and
# sim/flywheel at full width
HV_SOURCE = CSRC + "mc_engine_wide_harvest.cu"
HV_SAMPLER_SOURCE = CSRC + "mc_engine_wide_samplers_harvest.cu"
HV_CORR_SOURCE = CSRC + "mc_engine_wide_corr_harvest.cu"
HV_CORR_SAMPLER_SOURCE = CSRC + "mc_engine_wide_corr_samplers_harvest.cu"
HV_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1437"      # #8's use_harvest
HV_UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2120"  # #10's
HV_CORR_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2714"  # #12's
FLY_ROUNDS = 3                   # flywheel_demo.py's defaults (:114-122)
FLY_PATHS = 1 << 28
FLY_EXPLORE = 1 << 24
HOLDOUT_TRAIN = 1 << 26          # held-out evaluation: training paths a round ...
HOLDOUT_EVAL = 1 << 24           # ... and held-out paths, on three seed pairs
HOLDOUT_SEEDS = ((0, 4242), (1, 4243), (2, 4244))
FLY_ENV_PATHS = 1 << 22          # a round on the 30-level DB at 390 bars
FLY_SAMPLER_PATHS = 1 << 24      # the recorded-bar flywheel (the sampler harvest kernel)
FLY_KEYS = ["round", "labeled", "explored", "hit_rate", "mean_r", "trades", "escalations",
            "ml_present", "skips"]


def check_flywheel_output(lines: list, rounds: int, explore: bool) -> None:
    """``flywheel``'s rows: one a round with the JAX CLI's keys; round 0 the
    cold start (no ML gate armed, so no ML_CONF_LOW skip), every later round
    armed by the previous round's refresh (ML_CONF_LOW skips) and, with
    exploration, merging explored labels; a refreshed ML model every round."""
    if [r.get("round") for r in lines] != list(range(rounds)):
        raise AssertionError(f"flywheel: rounds {[r.get('round') for r in lines]}")
    for r in lines:
        if list(r) != FLY_KEYS:
            raise AssertionError(f"flywheel: keys {list(r)}, not {FLY_KEYS}")
        if not (r["labeled"] > 0 and r["trades"] > 0 and r["ml_present"]
                and 0.0 < r["hit_rate"] < 1.0 and math.isfinite(r["mean_r"])):
            raise AssertionError(f"flywheel: round {r['round']}: {r}")
        armed = r["round"] > 0
        if ("ML_CONF_LOW" in r["skips"]) != armed:
            raise AssertionError(f"flywheel: round {r['round']}'s ML_CONF_LOW skips "
                                 f"{r['skips'].get('ML_CONF_LOW')}")
        if explore and armed and not (r["explored"] > 0 and r["labeled"] > r["explored"]):
            raise AssertionError(f"flywheel: round {r['round']} merged no exploration: {r}")


def interleaved_ms(fns: dict, rounds: int = 2) -> dict:
    """Each of ``fns`` (name -> launch) timed by CUDA events, one launch at a
    time in turn, ``rounds`` turns after one warm-up launch of each; the mean
    milliseconds of each."""
    for fn in fns.values():
        fn()
    ms = {k: 0.0 for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ms[k] += cuda_ms(fn, 1) / rounds
    return ms


def harvest_phases(dev, card, reset, cli, e_counts) -> list:
    """Phase 31: the learning flywheel on the card.  The port CLI's
    ``flywheel --rounds 3 --num-paths 2^28 --explore-paths 2^24 --backend
    cuda`` (its rows checked); ``sim/flywheel.holdout_eval`` at 2^26 training
    paths a round and 2^24 held-out paths on three seed pairs (its rows
    printed); a round on the 30-level DB at 390 bars x 2^22 (the windowed
    guard); the recorded-bar flywheel (``policy_iteration`` under
    block_bootstrap at 2^24) and ``book --engine --harvest --sampler
    block_bootstrap`` at 100 x 2^20, the sampler harvest kernels' main paths;
    each harvest kernel timed against the same kernel without the harvest
    (3 levels x 40 x 2^28 against the envelope kernel forced, 30 levels x 390 x
    2^24, the samplers' at 2^24 and 100 x 2^20); the harvest rows' fold
    against its plain fold.  (``book --engine --harvest`` and config #4's
    refresh on its harvest are phases 20 and 17.)  Returns the ``kernels``
    entries of the harvest kernels and their fold."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.io import db as qdb
    from qmmx_monolithic_monte_carlo_tpu_torch.io import native
    from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars, bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim import flywheel as FW
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import SKIP_REASONS
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    params = EngineParams.default()
    lanes = ENGINE_LANES
    cli3 = Levels.from_rows(CLI_ROWS, max_levels=len(CLI_ROWS))     # the CLI's kernel levels
    lv30 = Levels.from_rows(env_ladder(ENV_LEVELS), max_levels=ENV_LEVELS)
    tmp = tempfile.TemporaryDirectory()
    env_db = os.path.join(tmp.name, "env.db")
    conn = qdb.db_connect(env_db)
    qdb.db_init(conn)
    qdb.replace_levels(conn, env_ladder(ENV_LEVELS))
    conn.close()
    csv = os.path.join(tmp.name, "bars.csv")
    write_history(csv, SAMPLER_HIST_BARS)
    cols = native.parse_bars_csv(csv)
    hist = PathBars(*(torch.as_tensor(cols[k], dtype=torch.float32) for k in "ohlcv"))
    tables = torch.stack(bootstrap_tables(*(cols[k] for k in "ohlcv")))

    log(f"[31] main path: cli flywheel --backend cuda --rounds {FLY_ROUNDS} --num-paths "
        f"{FLY_PATHS} --explore-paths {FLY_EXPLORE} (simulate -> harvest -> refresh -> "
        "re-simulate armed)")
    n_launch = FLY_ROUNDS + (FLY_ROUNDS - 1)
    argv = ["--db", os.path.join(tmp.name, "fly.db"), "flywheel", "--backend", "cuda",
            "--rounds", str(FLY_ROUNDS), "--num-paths", str(FLY_PATHS), "--explore-paths",
            str(FLY_EXPLORE), "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA)]
    fly, fly_secs, fly_launches = run_cli(
        cli, argv, reset, {"mc_engine_wide_harvest": n_launch, "mc_engine_reduce_rows": n_launch,
                           "mc_engine_harvest_reduce_rows": n_launch},
        work=FLY_ROUNDS * FLY_PATHS + (FLY_ROUNDS - 1) * FLY_EXPLORE, unit="paths",
        runs=ENV_RUNS)
    check_flywheel_output(fly, FLY_ROUNDS, True)
    for r in fly:
        log(f"  round {r['round']}: {json.dumps(r)}")
    log(f"  {FLY_ROUNDS} rounds in {fly_secs[-1]:.3f} s: {fly_secs[-1] / FLY_ROUNDS:.3f} s a "
        f"round (a simulation of {FLY_PATHS} paths, from round 1 one of {FLY_EXPLORE} more, "
        "the harvest's fold and the two refreshes)")

    log(f"[31] holdout_eval: {HOLDOUT_TRAIN} training paths a round (2 rounds, exploration "
        f"{FLY_EXPLORE}), {HOLDOUT_EVAL} held-out paths, seed pairs {list(HOLDOUT_SEEDS)}")
    hold_rows = []
    for a, b in HOLDOUT_SEEDS:
        (train, rows), h_ms = timed(lambda: FW.holdout_eval(
            a, b, cli3, params, rounds=2, num_paths=HOLDOUT_TRAIN, eval_paths=HOLDOUT_EVAL,
            num_bars=NUM_BARS, sigma=SIGMA, backend="cuda", device=dev,
            explore_paths=FLY_EXPLORE))
        if [r["arm"] for r in rows] != ["disarmed", "round0", "round1"]:
            raise AssertionError(f"holdout_eval arms {[r['arm'] for r in rows]}")
        if rows[0]["ml_armed"] or rows[0]["skips_ml"] != 0 or not all(
                r["ml_armed"] and r["skips_ml"] > 0 for r in rows[1:]):
            raise AssertionError(f"holdout_eval: the arms' ML gates: {rows}")
        for r in rows:
            if not all(math.isfinite(v) for v in r.values() if isinstance(v, float)):
                raise AssertionError(f"holdout_eval: non-finite row {r}")
            log(f"  seeds ({a}, {b}) {json.dumps(r)}")
        log(f"  seeds ({a}, {b}): {h_ms / 1e3:.3f} s; labels a round "
            f"{[t.labeled for t in train]} (explored {[t.explored for t in train]})")
        hold_rows.append(rows)

    log(f"[31] main path: cli flywheel --backend cuda --rounds 1 on the {ENV_LEVELS}-level DB "
        f"at --num-bars {ENV_BARS} --num-paths {FLY_ENV_PATHS} (the windowed guard)")
    argv = ["--db", env_db, "flywheel", "--backend", "cuda", "--rounds", "1", "--num-paths",
            str(FLY_ENV_PATHS), "--num-bars", str(ENV_BARS), "--sigma", str(SIGMA)]
    env_fly, env_secs, _ = run_cli(
        cli, argv, reset, {"mc_engine_wide_harvest": 1, "mc_engine_reduce_rows": 1,
                           "mc_engine_harvest_reduce_rows": 1},
        n_paths=FLY_ENV_PATHS, runs=ENV_RUNS)
    check_flywheel_output(env_fly, 1, False)

    log(f"[31] main path: sim/flywheel.policy_iteration under block_bootstrap (the "
        f"{SAMPLER_HIST_BARS}-bar history), 2 rounds x {FLY_SAMPLER_PATHS} paths, "
        "backend cuda")
    s_rounds, s_secs, s_launches = run_entry(
        "policy_iteration (block_bootstrap)", lambda: FW.policy_iteration(
            0, cli3, params, rounds=2, num_paths=FLY_SAMPLER_PATHS, num_bars=NUM_BARS,
            sigma=SIGMA, backend="cuda", device=dev, sampler="block_bootstrap",
            hist_bars=hist, block_len=SAMPLER_BLOCK_LEN),
        reset, {"mc_engine_wide_sampler_harvest": 2, "mc_engine_reduce_rows": 2,
                "mc_engine_harvest_reduce_rows": 2}, runs=1)
    ml_low = [r.name for r in SKIP_REASONS].index("ML_CONF_LOW")
    if not (s_rounds[0].labeled > 0 and int(s_rounds[0].skips[ml_low]) == 0
            and int(s_rounds[1].skips[ml_low]) > 0 and bool(s_rounds[1].ml_model.present)):
        raise AssertionError("the recorded-bar flywheel: round 0 not cold or round 1 unarmed")
    log(f"  labels a round {[r.labeled for r in s_rounds]}, ML_CONF_LOW skips "
        f"{[int(r.skips[ml_low]) for r in s_rounds]}")

    log(f"[31] main path: cli book --engine --harvest --backend cuda --sampler block_bootstrap "
        f"on the history, {BOOK_SYMBOLS} symbols x {BOOK_PATHS} paths")
    bargv = (["--db", os.path.join(tmp.name, "book.db")] + book_argv(True)
             + ["--harvest", "--sampler", "block_bootstrap", "--bars-csv", csv, "--block-len",
                str(SAMPLER_BLOCK_LEN)])
    b_lines, b_secs, b_launches = run_cli(
        cli, bargv, reset, {"mc_engine_wide_corr_sampler_harvest": 1,
                            "mc_engine_corr_reduce_rows": 1, "mc_engine_harvest_reduce_rows": 1},
        work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols", runs=ENV_RUNS)
    check_book_output([{k: v for k, v in r.items() if k not in ("labeled", "ml_coef")}
                       for r in b_lines], BOOK_SYMBOLS, True)
    if not all(r["labeled"] > 0 and len(r["ml_coef"]) == 4
               and all(math.isfinite(c) for c in r["ml_coef"]) for r in b_lines[:-1]):
        raise AssertionError("book --harvest --sampler: a symbol's labels or coefficients")

    log("[31] each harvest kernel against the same kernel without the harvest, CUDA events "
        "(the gbm kernels' at 2^28 and 2^24 x 390 against phase 29's times of the kernels "
        "without it, the others one launch at a time in turn)")
    kw11 = dict(num_paths=MAIN_PATHS, num_bars=NUM_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
                device=dev)

    t = {"wide": HV_MAIN["forced_3x40_ms"],
         "harvest": cuda_ms(lambda: CE.engine_rows(0, cli3, params, harvest=True, **kw11), 1)}
    kw_env = dict(num_paths=ENV_PATHS, num_bars=ENV_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
                  device=dev)
    t_env = {"wide": HV_MAIN["env_ms"],
             "harvest": cuda_ms(lambda: CE.engine_rows(0, lv30, params, harvest=True, **kw_env),
                                1)}
    kw_s = dict(num_paths=FLY_SAMPLER_PATHS, num_bars=NUM_BARS, sigma=SIGMA, dt=DT, lanes=lanes,
                device=dev, sampler="block_bootstrap", tables=tables, block_len=SAMPLER_BLOCK_LEN)
    t_s = interleaved_ms({
        "wide": forced(CE, lambda: CE.engine_rows(0, cli3, params, **kw_s)),
        "harvest": lambda: CE.engine_rows(0, cli3, params, harvest=True, **kw_s)})
    book100 = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                                {"color": "orange", "type": "dashed", "index": 0,
                                 "price": x + 0.4}] for x in BOOK_S0], max_levels=4), params,
               BOOK_S0, [SIGMA] * BOOK_SYMBOLS, BOOK_BETAS,
               [1.0 / BOOK_SYMBOLS] * BOOK_SYMBOLS)
    kw_b = dict(paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, device=dev,
                sampler="block_bootstrap", tables=tables[None].to(dev),
                block_len=SAMPLER_BLOCK_LEN)
    t_b = interleaved_ms({
        "wide": forced(CE, lambda: CE.engine_corr_rows(0, *book100, **kw_b)),
        "harvest": lambda: CE.engine_corr_rows(0, *book100, harvest=True, **kw_b)})
    for name, tt, shape in (("gbm", t, f"3 levels x {NUM_BARS} x {MAIN_PATHS}"),
                            ("gbm", t_env, f"{ENV_LEVELS} levels x {ENV_BARS} x {ENV_PATHS}"),
                            ("block_bootstrap", t_s, f"3 levels x {NUM_BARS} x "
                                                     f"{FLY_SAMPLER_PATHS}"),
                            ("block_bootstrap book", t_b, f"{BOOK_SYMBOLS} x {BOOK_PATHS} x "
                                                          f"{NUM_BARS}")):
        log(f"  {name} at {shape}: without the harvest {tt['wide']:.3f} ms, with it "
            f"{tt['harvest']:.3f} ms ({tt['harvest'] / tt['wide']:.4f}x)")
    for k in ("mc_engine_wide_universe_harvest", "mc_engine_wide_corr_harvest"):
        m = HV_MAIN[k]
        log(f"  {k} (phases 17, 20): without the harvest {m['ms_without']:.3f} ms (the "
            f"parent {m['ms_parent']:.3f} ms), with it {m['ms']:.3f} ms "
            f"({m['ms'] / m['ms_without']:.4f}x)")

    log("[31] the harvest rows' fold (fold_harvest_rows) against its plain fold")
    pc, pf, h_c, h_s = CE.engine_rows(0, cli3, params, harvest=True, **kw11)
    got = CE.reduce_harvest(h_c, h_s)
    plain = CE.reduce_harvest(h_c.cpu(), h_s.cpu())
    if not (torch.equal(got.ml_counts.cpu(), plain.ml_counts)
            and torch.equal(got.pol_counts.cpu(), plain.pol_counts)):
        raise AssertionError("the harvest fold's counts differ from its plain fold")
    fold_err = max(float((a.cpu().double() - b.double()).abs().max())
                   for a, b in ((got.pol_sum_x1, plain.pol_sum_x1),
                                (got.pol_sum_x6, plain.pol_sum_x6)))
    if fold_err > 1e-6 * max(1.0, float(plain.pol_sum_x6.abs().max())):
        raise AssertionError(f"the harvest fold's sums differ by {fold_err}")
    fold_ms = cuda_ms(lambda: CE.reduce_harvest(h_c, h_s), 20)
    fold_plain_ms = cuda_ms(lambda: HV.EngineHarvest.from_columns(
        h_c.sum(dim=-2), h_s.double().sum(dim=-2)), 20)
    fold_bytes = h_c.numel() * 8 + h_s.numel() * 4 + 72 * 8 + 16 * 8
    fold_bound = card.bound(bytes_=fold_bytes, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  {h_c.shape[1]} rows: counts exact, sums max |d| {fold_err:.3e}; kernel "
        f"{fold_ms:.4f} ms, plain {fold_plain_ms:.4f} ms, bound {fold_bound['bound_ms']:.4f} ms")
    del pc, pf, h_c, h_s
    tmp.cleanup()

    grid = grid_size(MAIN_PATHS)
    gbm_bound = harvest_bound(card, grid * (CE.ROW_COUNTS * 8 + CE.ROW_FLOATS * 4), engine_ops(
        MAIN_PATHS, e_counts, MAIN_PATHS / PHILOX_PATHS, NUM_BARS, 3),
        float(e_counts[5]) * MAIN_PATHS / PHILOX_PATHS, 1, grid)
    env_counts = HV_MAIN["env_counts"]
    env_bound = harvest_bound(card, grid_size(ENV_PATHS) * (CE.ROW_COUNTS * 8
                                                            + CE.ROW_FLOATS * 4), engine_ops(
        ENV_PATHS, env_counts, ENV_PATHS / ENV_PHILOX_PATHS, ENV_BARS, ENV_LEVELS),
        float(env_counts[5]) * ENV_PATHS / ENV_PHILOX_PATHS, 1, grid_size(ENV_PATHS))
    s_grid = grid_size(FLY_SAMPLER_PATHS)
    s_ops, s_gathers = engine_sampler_ops("block_bootstrap", FLY_SAMPLER_PATHS, e_counts,
                                          FLY_SAMPLER_PATHS / PHILOX_PATHS, NUM_BARS, 3)
    s_bound = gather_bound(card, s_grid * (CE.ROW_COUNTS * 8 + CE.ROW_FLOATS * 4 + 72 * 8
                                           + 16 * 4), dict(s_ops, f32=s_ops["f32"] + 10.0 * float(
                                               e_counts[5]) * FLY_SAMPLER_PATHS / PHILOX_PATHS),
                           s_gathers, tables.numel() * 4)
    b_grid = grid_size(BOOK_PATHS)
    b_ops, b_gathers = engine_sampler_ops("block_bootstrap", BOOK_SYMBOLS * BOOK_PATHS,
                                          e_counts, BOOK_SYMBOLS * BOOK_PATHS / PHILOX_PATHS)
    for k, v in book_sampler_market_ops("block_bootstrap", BOOK_PATHS, BOOK_SYMBOLS).items():
        b_ops[k] = b_ops[k] + v
    b_bound = gather_bound(card, (BOOK_SYMBOLS + 1) * b_grid * (CE.ROW_COUNTS * 8
                                                                + CE.ROW_FLOATS * 4)
                           + BOOK_SYMBOLS * b_grid * (72 * 8 + 16 * 4),
                           dict(b_ops, f32=b_ops["f32"] + 10.0 * float(e_counts[5])
                                * BOOK_SYMBOLS * BOOK_PATHS / PHILOX_PATHS),
                           b_gathers, tables.numel() * 4)
    uni, corr = HV_MAIN["mc_engine_wide_universe_harvest"], HV_MAIN["mc_engine_wide_corr_harvest"]

    def plain(k):
        return HV_PLAIN[k]["ms"]

    return [
        entry("mc_engine_wide_harvest", HV_SOURCE, HV_REPLACES,
              fly_launches["mc_engine_wide_harvest"], HV_ERR["mc_engine_wide_harvest"],
              t["harvest"], plain("mc_engine_wide_harvest"), gbm_bound, paths=MAIN_PATHS,
              levels=3, num_bars=NUM_BARS, ms_without_harvest=t["wide"],
              ms_30x390=t_env["harvest"], ms_30x390_without_harvest=t_env["wide"],
              bound_ms_30x390=env_bound["bound_ms"], plain_shape=HV_PLAIN["mc_engine_wide_harvest"],
              flywheel_s=fly_secs, holdout_rows=len(hold_rows)),
        entry("mc_engine_wide_universe_harvest", HV_SOURCE, HV_UNI_REPLACES, uni["launches"],
              HV_ERR["mc_engine_wide_universe_harvest"], uni["ms"],
              plain("mc_engine_wide_universe_harvest"), uni["bound"], symbols=uni["symbols"],
              paths=uni["paths"], ms_without_harvest=uni["ms_without"],
              parent_ms_without_harvest=uni["ms_parent"],
              plain_shape=HV_PLAIN["mc_engine_wide_universe_harvest"],
              config4_s=uni["config4_s"]),
        entry("mc_engine_wide_sampler_harvest", HV_SAMPLER_SOURCE, HV_REPLACES,
              s_launches["mc_engine_wide_sampler_harvest"],
              HV_ERR["mc_engine_wide_sampler_harvest"], t_s["harvest"],
              plain("mc_engine_wide_sampler_harvest"), s_bound, sampler="block_bootstrap",
              paths=FLY_SAMPLER_PATHS, levels=3, num_bars=NUM_BARS,
              ms_without_harvest=t_s["wide"],
              plain_shape=HV_PLAIN["mc_engine_wide_sampler_harvest"], entry_s=s_secs),
        entry("mc_engine_wide_corr_harvest", HV_CORR_SOURCE, HV_CORR_REPLACES,
              corr["launches"], HV_ERR["mc_engine_wide_corr_harvest"], corr["ms"],
              plain("mc_engine_wide_corr_harvest"), corr["bound"], symbols=corr["symbols"],
              paths=corr["paths"], ms_without_harvest=corr["ms_without"],
              parent_ms_without_harvest=corr["ms_parent"],
              plain_shape=HV_PLAIN["mc_engine_wide_corr_harvest"], cli_s=corr["cli_s"]),
        entry("mc_engine_wide_corr_sampler_harvest", HV_CORR_SAMPLER_SOURCE, HV_CORR_REPLACES,
              b_launches["mc_engine_wide_corr_sampler_harvest"],
              HV_ERR["mc_engine_wide_corr_sampler_harvest"], t_b["harvest"],
              plain("mc_engine_wide_corr_sampler_harvest"), b_bound, sampler="block_bootstrap",
              symbols=BOOK_SYMBOLS, paths=BOOK_PATHS, ms_without_harvest=t_b["wide"],
              plain_shape=HV_PLAIN["mc_engine_wide_corr_sampler_harvest"], cli_s=b_secs),
        entry("mc_engine_harvest_reduce_rows", HV_SOURCE, HV_REPLACES,
              fly_launches["mc_engine_harvest_reduce_rows"], fold_err, fold_ms, fold_plain_ms,
              fold_bound, rows=grid),
    ]



# ---- first contact past 128 bars (phase 32): kernels #1-#3 and their
# samplers at the desk's 390-bar day (the gbm kernels keep 24 or 64 sine
# halves a thread and draw the pairs past them again)
LONG_BARS = 390
LONG_INJECT_BLOCKS = 4           # 4 x 8192 paths injected, against the plain version on CPU copies
LONG_PHILOX_PATHS = 1 << 20      # kernel vs plain on the card; the bounds' work sample
LONG_SAMPLER_PATHS = 1 << 18     # the samplers' rows against the plain version on the card
LONG_PATHS = 1 << 24             # the kernels alone (the sweep: 9 rows of it)
LONG_SYMBOLS = 3


def long_phases(dev, card, reset, cli) -> list:
    """Phase 32: first contact at W = 390, where the gbm kernels keep 24
    (``mc_universe_kernel``) or 64 (the sweep) of the 195 sine halves a
    thread (their launches counted with ``_long``) and
    ``--backend auto`` takes the kernels.  gbm: injected uniforms (noise,
    antithetic) against the plain version on CPU copies; Philox at 2^20
    against the plain version on the card, single (noise, antithetic), the 3
    x 3 sweep and a 3-symbol universe; the same launches forced to keep no
    sine half (``cuda_mc._FORCE_LONG``: ``cap = 0``) at W = 40, 90, 92 and
    128 equal to the launches keeping every half they keep (up to 24 for the
    single run and the universe, 64 for the sweep) bit for bit (the gbm
    sweep, its sine halves kept and drawn again, row by row against the
    one-row launch keeping every half it keeps), the gbm sweep at 18 rows x W 390 (two
    launches) each row against its one-row launch; ``paths --num-bars
    390`` (default ``--backend auto``) at 2^28 and ``sweep --num-bars 390`` at
    2^26 through the CLI, config #4's universe at 390 bars through
    ``mc_paths_universe_fused``; each kernel timed beside its bound.  The
    samplers (bootstrap, block bootstrap, Heston; their kernels always draw
    their pairs again) at W = 390: single, sweep and universe against the
    plain version on the card at 2^18 a row, timed, an 18-row sweep (two
    launches of ``mc_first_contact_sampler_sweep_kernel``) each row equal to
    its one-row launch bit for bit, and ``paths --sampler ... --num-bars
    390`` at 2^28 through the CLI.  Flip budgets F = 2 +
    paths/1024 x ceil(W / 40).  Returns the ``kernels`` entries."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    w = LONG_BARS
    params = EngineParams.default()
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
                         target_slip_std=0.015)
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    common = dict(num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=LANES)
    grid9 = [(sp, tp) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)]
    stops9, tps9 = [c[0] for c in grid9], [c[1] for c in grid9]
    lv3 = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                           {"color": "orange", "type": "dashed", "index": 0, "price": x + 0.4}]
                          for x in (100.0, 50.0, 75.0)], max_levels=8)
    s0_3, sg_3 = np.array([100.0, 50.0, 75.0], np.float32), np.array([0.3, 0.4, 0.25], np.float32)
    ukw = dict(num_bars=w, dt=DT, lanes=LANES, external_uniforms=None, device=dev)

    def cmp(name, want, got, n):
        return compare(name, want, got, n, num_bars=w)

    log(f"[32] first contact at W = {w} (mc_universe_kernel, 24 sine halves kept), "
        "injected uniforms: "
        f"kernel vs plain on CPU copies, {LONG_INJECT_BLOCKS * LANES} paths")
    err = {"mc_first_contact_long": 0.0, "mc_sweep_long": 0.0, "mc_universe_long": 0.0}
    n_inj = LONG_INJECT_BLOCKS * LANES
    for case, nz, anti in (("plain", None, False), ("noise+antithetic", noise, True)):
        u = torch.from_numpy(np.random.default_rng(3200 + len(case)).uniform(
            1e-9, 1.0, (LONG_INJECT_BLOCKS, GbmLayout(w, nz is not None).n_rows, LANES))
            .astype(np.float32))
        kw = dict(common, num_paths=n_inj, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(0, levels, params, external_uniforms=u, **kw)
        got = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(
            0, levels, params, device=dev, external_uniforms=u.to(dev), **kw))
        err["mc_first_contact_long"] = max(err["mc_first_contact_long"], cmp(case, want, got, n_inj))

    log(f"[32] Philox at {LONG_PHILOX_PATHS} paths: single (noise, antithetic), the 3 x 3 "
        f"sweep, a {LONG_SYMBOLS}-symbol universe, kernel vs plain on the card")
    kw = dict(common, num_paths=LONG_PHILOX_PATHS, external_uniforms=None)
    want, fc_plain_ms = timed(lambda: cuda_mc.fused_totals_reference(
        7, levels, params, device=dev, noise=noise, antithetic=True, **kw))
    got = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(7, levels, params, device=dev,
                                                          noise=noise, antithetic=True, **kw))
    err["mc_first_contact_long"] = max(err["mc_first_contact_long"],
                                       cmp("philox+noise+antithetic", want, got,
                                           LONG_PHILOX_PATHS))
    sc, _, work = cuda_mc.fused_totals_reference(0, levels, params, device=dev, work=True,
                                                 noise=None, antithetic=False, **kw)
    (swc, swf, swork), sw_plain_ms = timed(lambda: cuda_mc.sweep_totals_reference(
        0, levels, params, stops9, tps9, device=dev, work=True, **kw))
    got = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(0, levels, params, stops9, tps9, device=dev,
                                                  **kw))
    for g in range(len(grid9)):
        err["mc_sweep_long"] = max(err["mc_sweep_long"], cmp(
            f"sweep row {g}", (swc[g], swf[g]), (got[0][g], got[1][g]), LONG_PHILOX_PATHS))
    (uwc, uwf, uwork), uni_plain_ms = timed(lambda: cuda_mc.universe_totals_reference(
        7, lv3, params, s0_3, sg_3, paths_per_symbol=LONG_PHILOX_PATHS, work=True, **ukw))
    got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(
        7, lv3, params, s0_3, sg_3, paths_per_symbol=LONG_PHILOX_PATHS, **ukw))
    for i in range(LONG_SYMBOLS):
        err["mc_universe_long"] = max(err["mc_universe_long"], cmp(
            f"universe symbol {i}", (uwc[i], uwf[i]), (got[0][i], got[1][i]), LONG_PHILOX_PATHS))

    log("[32] no sine half kept (cuda_mc._FORCE_LONG: cap = 0) at W = 40, 90, 92 and 128 "
        f"against the launches keeping every half they keep (up to 24 for the single run and "
        f"universe, 64 for the sweep) at {LONG_PHILOX_PATHS} paths: partial rows bit for bit")
    for wf in (40, 90, 92, 128):
        fkw = dict(common, num_bars=wf, num_paths=LONG_PHILOX_PATHS, external_uniforms=None)

        def launches():
            return (cuda_mc.first_contact_rows(3, levels, params, device=dev, noise=noise,
                                               antithetic=True, **fkw),
                    cuda_mc.sweep_rows(3, levels, params, stops9, tps9, device=dev, **fkw),
                    cuda_mc.universe_rows(3, lv3, params, s0_3, sg_3,
                                          paths_per_symbol=LONG_PHILOX_PATHS,
                                          **dict(ukw, num_bars=wf)))

        reg = launches()
        cuda_mc._FORCE_LONG = True
        try:
            forced_rows = launches()
        finally:
            cuda_mc._FORCE_LONG = False
        for name, a, b in zip(("single", "sweep", "universe"), reg, forced_rows):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"W {wf} {name}: cap = 0 differs from the sine halves "
                                     "kept")
        # the gbm sweep kernel (every sine half in shared memory, then none
        # under _FORCE_LONG) against the one-row kernel keeping the halves it
        # keeps, row by row
        for gi, (sp, tp) in enumerate(zip(stops9, tps9)):
            one = cuda_mc.first_contact_rows(3, levels, params.replace(
                stop_padding=sp, tp_padding=tp), device=dev, noise=None, antithetic=False,
                **fkw)
            for name, sw in (("kept", reg[1]), ("drawn again", forced_rows[1])):
                if not (torch.equal(one[0], sw[0][gi]) and torch.equal(one[1], sw[1][gi])):
                    raise AssertionError(f"W {wf}: gbm sweep row {gi} (sine halves {name}) "
                                         "differs from the one-row kernel")
    log("  single (noise, antithetic), sweep and universe: cap = 0 == the sine halves kept, "
        "bit for bit at W = 40, 90, 92 and 128; each gbm sweep row, sine halves kept or drawn "
        "again, == its one-row launch keeping the halves it keeps")

    def row_bytes_of(rows):
        return rows[0].numel() * 8 + rows[1].numel() * 4

    def run_fc(n):
        return cuda_mc.first_contact_rows(0, levels, params, device=dev, noise=None,
                                          antithetic=False, **dict(kw, num_paths=n))

    def run_sw(n):
        return cuda_mc.sweep_rows(0, levels, params, stops9, tps9, device=dev,
                                  **dict(kw, num_paths=n))

    run_fc(LONG_PATHS)
    fc_ms = cuda_ms(lambda: run_fc(LONG_PATHS), 2)
    fc_rows = run_fc(LONG_PATHS)
    fc_bound = card.bound(bytes_=row_bytes_of(fc_rows),
                          **fc_ops(work.cpu(), int(sc[1]), LONG_PATHS / LONG_PHILOX_PATHS))
    sw_paths = LONG_PATHS
    run_sw(sw_paths)
    sw_ms = cuda_ms(lambda: run_sw(sw_paths), 2)
    sw_bound = card.bound(bytes_=row_bytes_of(run_sw(sw_paths)), **sweep_ops(
        swork.cpu(), int(swc[0, 1]), len(grid9), sw_paths / LONG_PHILOX_PATHS))
    log(f"  kernels alone: single at {LONG_PATHS} paths {fc_ms:.3f} ms, bound "
        f"{fc_bound['bound_ms']:.3f} ms {fc_bound['bound_parts']}, plain at "
        f"{LONG_PHILOX_PATHS} {fc_plain_ms:.3f} ms; sweep at 9 x {sw_paths} {sw_ms:.3f} ms, "
        f"bound {sw_bound['bound_ms']:.3f} ms, plain at 9 x {LONG_PHILOX_PATHS} "
        f"{sw_plain_ms:.3f} ms")

    log(f"[32] main path: cli paths --num-bars {w} --num-paths {MAIN_PATHS} (--backend auto)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--num-paths", str(MAIN_PATHS),
                "--num-bars", str(w), "--sigma", str(SIGMA)]
        (out,), fc_secs, fc_launches = run_cli(
            cli, argv, reset, {"mc_first_contact_long": 1, "mc_reduce_rows": 1})
    check_paths_output(out)
    fc_main_ms = cuda_ms(lambda: run_fc(MAIN_PATHS), 1)
    fc_main_bound = card.bound(bytes_=row_bytes_of(fc_rows),
                               **fc_ops(work.cpu(), int(sc[1]), MAIN_PATHS / LONG_PHILOX_PATHS))
    log(f"  kernel alone at {MAIN_PATHS} paths: {fc_main_ms:.3f} ms "
        f"({MAIN_PATHS / fc_main_ms * 1e3:.6e} paths/s), bound "
        f"{fc_main_bound['bound_ms']:.3f} ms")
    sw_cli_paths = 1 << 26
    log(f"[32] main path: cli sweep --num-bars {w} --num-paths {sw_cli_paths} (3 x 3 grid, "
        "--backend auto)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--num-paths",
                str(sw_cli_paths), "--num-bars", str(w), "--sigma", str(SIGMA)]
        sw_out, sw_secs, sw_launches = run_cli(
            cli, argv, reset, {"mc_sweep_long": 1, "mc_sweep_reduce_rows": 1},
            n_paths=sw_cli_paths)
    check_sweep_output(sw_out, grid9, ["stop_padding", "tp_padding", "hit_rate", "mean_r"])
    c4 = config4()
    log(f"[32] main path: mc_paths_universe_fused, config #4's universe ({UNI_SYMBOLS} symbols "
        f"x {UNI_PATHS} paths) at {w} bars")
    st, uni_secs, uni_launches = run_entry(
        "mc_paths_universe_fused", lambda: cuda_mc.mc_paths_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=w, dt=DT),
        reset, {"mc_universe_long": 2, "mc_universe_reduce_rows": 2})
    check_universe_stats("first-contact universe at 390 bars", st, UNI_SYMBOLS, UNI_PATHS)
    uni_rows = cuda_mc.universe_rows(0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS,
                                     **dict(ukw, lanes=cuda_mc.UNIVERSE_LANES))
    uni_ms = cuda_ms(lambda: cuda_mc.universe_rows(
        0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS,
        **dict(ukw, lanes=cuda_mc.UNIVERSE_LANES)), 2)
    c4kw = dict(ukw, lanes=cuda_mc.UNIVERSE_LANES)
    cc, _, cwork = cuda_mc.universe_totals_reference(0, c4[0], params, *c4[1:], work=True,
                                                     paths_per_symbol=UNI_SAMPLE_PATHS, **c4kw)
    uni_bound = card.bound(bytes_=row_bytes_of(uni_rows), **fc_ops(
        cwork.sum(0).cpu(), int(cc[:, 1].sum()), UNI_PATHS / UNI_SAMPLE_PATHS))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {uni_ms:.3f} ms, bound "
        f"{uni_bound['bound_ms']:.3f} ms {uni_bound['bound_parts']}; plain at "
        f"{LONG_SYMBOLS} x {LONG_PHILOX_PATHS} {uni_plain_ms:.3f} ms")
    del uni_rows

    log(f"[32] the samplers at W = {w}: single, the 3 x 3 sweep and a {LONG_SYMBOLS}-symbol "
        f"universe (the history shared) against the plain version on the card at "
        f"{LONG_SAMPLER_PATHS} paths a row, an 18-row sweep (two launches) against its "
        f"one-row launches; kernels alone; cli paths --sampler ... --num-bars {w} at "
        f"{MAIN_PATHS}")
    tmp = tempfile.TemporaryDirectory()
    csv = os.path.join(tmp.name, "bars.csv")
    write_history(csv, SAMPLER_HIST_BARS)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))
    table_bytes = tables.numel() * 4
    samp = []
    kws = dict(kw, num_paths=LONG_SAMPLER_PATHS)
    stops18 = [sp for sp in (0.15, 0.25, 0.35, 0.45, 0.55, 0.65) for _ in range(3)]
    tps18 = [tp for _ in range(6) for tp in (0.15, 0.25, 0.35)]
    # gbm, 18 rows at W = 390: two launches of mc_first_contact_sweep_kernel (64
    # sine halves kept, the rest drawn again), each row equal to its one-row
    # launch of mc_universe_kernel bit for bit
    before = cuda_mc.LAUNCHES["mc_sweep_long"]
    sw18 = cuda_mc.sweep_rows(0, levels, params, stops18, tps18, device=dev, **kws)
    if cuda_mc.LAUNCHES["mc_sweep_long"] != before + 2:
        raise AssertionError(f"gbm: 18 sweep rows took "
                             f"{cuda_mc.LAUNCHES['mc_sweep_long'] - before} launches")
    for gi, (sp, tp) in enumerate(zip(stops18, tps18)):
        one = cuda_mc.first_contact_rows(
            0, levels, params.replace(stop_padding=sp, tp_padding=tp), device=dev,
            noise=None, antithetic=False, **kws)
        if not (torch.equal(one[0], sw18[0][gi]) and torch.equal(one[1], sw18[1][gi])):
            raise AssertionError(f"gbm W {w}: sweep row {gi} of 18 differs from its one-row "
                                 "launch")
    del sw18
    log(f"  gbm sweep at 18 rows x {LONG_SAMPLER_PATHS} x {w} (two launches): every row == "
        "its one-row launch bit for bit")
    for smp in SAMPLERS:
        skw = (dict(sampler=smp) if smp == "heston" else
               dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN))
        ukw_s = dict(ukw, **({} if smp == "heston" else
                             dict(sampler=smp, tables=tables[None].expand(LONG_SYMBOLS, -1, -1)
                                  .contiguous(), block_len=SAMPLER_BLOCK_LEN)),
                     **({"sampler": smp} if smp == "heston" else {}))
        tb = 0.0 if smp == "heston" else table_bytes
        e = 0.0
        (pc_, pf_, pwork), p_ms = timed(lambda: cuda_mc.fused_totals_reference(
            0, levels, params, device=dev, noise=None, antithetic=False, work=True, **kws, **skw))
        got = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(0, levels, params, device=dev,
                                                              noise=None, antithetic=False,
                                                              **kws, **skw))
        e = max(e, cmp(f"{smp} single", (pc_, pf_), got, LONG_SAMPLER_PATHS))
        ms = cuda_ms(lambda: cuda_mc.first_contact_rows(
            0, levels, params, device=dev, noise=None, antithetic=False,
            **dict(kws, num_paths=LONG_PATHS), **skw), 2)
        ops, g = fc_sampler_ops(smp, pwork.cpu(), int(pc_[1]), LONG_PATHS / LONG_SAMPLER_PATHS)
        bnd = gather_bound(card, row_bytes_of(fc_rows), ops, g, tb)
        (sc_, sf_, swk), sp_ms = timed(lambda: cuda_mc.sweep_totals_reference(
            0, levels, params, stops9, tps9, device=dev, work=True, **kws, **skw))
        got = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(0, levels, params, stops9, tps9,
                                                      device=dev, **kws, **skw))
        for gi in range(len(grid9)):
            e = max(e, cmp(f"{smp} sweep row {gi}", (sc_[gi], sf_[gi]), (got[0][gi], got[1][gi]),
                           LONG_SAMPLER_PATHS))
        # 18 rows: two launches of the sampler sweep kernel, each row equal to
        # its one-row launch of mc_first_contact_sampler_kernel bit for bit
        before = cuda_mc.LAUNCHES["mc_sweep_sampler"]
        sw18 = cuda_mc.sweep_rows(0, levels, params, stops18, tps18, device=dev, **kws, **skw)
        if cuda_mc.LAUNCHES["mc_sweep_sampler"] != before + 2:
            raise AssertionError(f"{smp}: 18 sweep rows took "
                                 f"{cuda_mc.LAUNCHES['mc_sweep_sampler'] - before} launches")
        for gi, (sp, tp) in enumerate(zip(stops18, tps18)):
            one = cuda_mc.first_contact_rows(
                0, levels, params.replace(stop_padding=sp, tp_padding=tp), device=dev,
                noise=None, antithetic=False, **kws, **skw)
            if not (torch.equal(one[0], sw18[0][gi]) and torch.equal(one[1], sw18[1][gi])):
                raise AssertionError(f"{smp} W {w}: sweep row {gi} of 18 differs from its "
                                     "one-row launch")
        del sw18
        s_ms = cuda_ms(lambda: cuda_mc.sweep_rows(0, levels, params, stops9, tps9, device=dev,
                                                  **dict(kws, num_paths=sw_paths), **skw), 2)
        ops, g = sampler_sweep_ops("first contact", smp, (sc_, sf_, swk), sw_paths, len(grid9),
                                   sw_paths / LONG_SAMPLER_PATHS)
        s_bnd = gather_bound(card, len(grid9) * grid_size(sw_paths) * (
            cuda_mc.ROW_COUNTS * 8 + cuda_mc.ROW_FLOATS * 4), ops, g, tb)
        (uc_, uf_, uwk), u_ms_plain = timed(lambda: cuda_mc.universe_totals_reference(
            0, lv3, params, s0_3, sg_3, paths_per_symbol=LONG_SAMPLER_PATHS, work=True, **ukw_s))
        got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(
            0, lv3, params, s0_3, sg_3, paths_per_symbol=LONG_SAMPLER_PATHS, **ukw_s))
        for i in range(LONG_SYMBOLS):
            e = max(e, cmp(f"{smp} universe symbol {i}", (uc_[i], uf_[i]), (got[0][i], got[1][i]),
                           LONG_SAMPLER_PATHS))
        u_ms = cuda_ms(lambda: cuda_mc.universe_rows(
            0, lv3, params, s0_3, sg_3, paths_per_symbol=LONG_SAMPLER_PATHS, **ukw_s), 2)
        ops, g = rows_ops("first contact", smp, (uc_, uf_, uwk), LONG_SAMPLER_PATHS, 1.0)
        u_bnd = gather_bound(card, LONG_SYMBOLS * grid_size(LONG_SAMPLER_PATHS) * (
            cuda_mc.ROW_COUNTS * 8 + cuda_mc.ROW_FLOATS * 4), ops, g, tb)
        argv = ["--db", os.path.join(tmp.name, "smoke.db")] + sampler_argv(
            "first contact", smp, csv)
        argv[argv.index("--num-bars") + 1] = str(w)
        (res,), secs, launches = run_cli(cli, argv, reset,
                                         {"mc_first_contact_sampler": 1, "mc_reduce_rows": 1})
        check_paths_output(res)
        log(f"  {smp}: the 18 rows of two sweep launches each equal to their one-row "
            f"launch; single at {LONG_PATHS} {ms:.3f} ms (bound {bnd['bound_ms']:.3f} ms, "
            f"plain at {LONG_SAMPLER_PATHS} {p_ms:.3f} ms); sweep at 9 x {sw_paths} {s_ms:.3f} ms "
            f"(bound {s_bnd['bound_ms']:.3f} ms, plain at 9 x {LONG_SAMPLER_PATHS} "
            f"{sp_ms:.3f} ms); universe at {LONG_SYMBOLS} x {LONG_SAMPLER_PATHS} {u_ms:.3f} ms "
            f"(bound {u_bnd['bound_ms']:.3f} ms, plain {u_ms_plain:.3f} ms)")
        samp.append(entry(f"mc_first_contact_sampler/{smp}/W{w}", FC_SAMPLER_SOURCE,
                          FC_REPLACES, launches["mc_first_contact_sampler"], e, ms, p_ms, bnd,
                          sampler=smp, num_bars=w, cli_s=secs[1:],
                          paths=LONG_PATHS, plain_paths=LONG_SAMPLER_PATHS,
                          sweep_ms=s_ms, sweep_paths=sw_paths, sweep_rows=len(grid9),
                          sweep_source=FC_SAMPLER_SWEEP_SOURCE,
                          sweep_bound_ms=s_bnd["bound_ms"], sweep_plain_ms=sp_ms,
                          universe_ms=u_ms, universe_symbols=LONG_SYMBOLS,
                          universe_paths=LONG_SAMPLER_PATHS, universe_bound_ms=u_bnd["bound_ms"],
                          universe_plain_ms=u_ms_plain))
    tmp.cleanup()
    return [
        entry("mc_first_contact_long", FC_SOURCE, FC_REPLACES,
              fc_launches["mc_first_contact_long"], err["mc_first_contact_long"], fc_ms,
              fc_plain_ms, fc_bound, num_bars=w, paths=LONG_PATHS, plain_paths=LONG_PHILOX_PATHS,
              main_path_ms=fc_main_ms, main_path_bound_ms=fc_main_bound["bound_ms"],
              cli_s=fc_secs[1:]),
        entry("mc_sweep_long", FC_SWEEP_SOURCE, SWEEP_REPLACES, sw_launches["mc_sweep_long"],
              err["mc_sweep_long"], sw_ms, sw_plain_ms, sw_bound, num_bars=w, paths=sw_paths,
              grid_rows=len(grid9), plain_paths=LONG_PHILOX_PATHS, cli_s=sw_secs[1:]),
        entry("mc_universe_long", FC_SOURCE, UNI_REPLACES,
              uni_launches["mc_universe_long"], err["mc_universe_long"], uni_ms, uni_plain_ms,
              uni_bound, num_bars=w, symbols=UNI_SYMBOLS, paths=UNI_PATHS,
              plain_symbols=LONG_SYMBOLS, plain_paths=LONG_PHILOX_PATHS, main_s=uni_secs[1:]),
    ] + samp


def single_sampler_times(tree: str) -> int:
    """The nine single-configuration sampler launches (first contact, gated,
    engine x bootstrap, block bootstrap, Heston: ``first_contact_rows``,
    ``gated_rows``, ``engine_rows``) of the port in ``tree`` at 2^28 x 40 on
    the CLI's levels and ``history_arrays``' year of 1-minute bars (tables
    on the host, as the CLI hands them over), each by CUDA events over 3
    runs after a warm-up; prints the sampler libraries' ptxas lines, each
    time, and one JSON line with all of them, the card's name and power
    limit."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"tree {os.path.abspath(tree)}; {smi}", flush=True)
    libs = ("mc_first_contact_samplers", "mc_gated_samplers", "mc_engine_samplers")
    build.build_all(libs)
    ptxas = {name: [line.strip() for line in build.BUILD_LOG[name]["log"].splitlines()
                    if any(k in line for k in ("Compiling entry", "registers", "spill"))]
             for name in libs}
    for name, lines in ptxas.items():
        for line in lines:
            print(f"  {name}: {line}")
    dev = torch.device("cuda", 0)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))
    params = EngineParams.default()
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    gate = GateConfig.from_params(params)
    common = dict(num_paths=MAIN_PATHS, num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA,
                  dt=DT, noise=None, antithetic=False, external_uniforms=None, device=dev)

    def launch(family, sampler):
        kw = dict(common, sampler=sampler)
        if sampler != "heston":
            kw.update(tables=tables, block_len=SAMPLER_BLOCK_LEN)
        if family == "first contact":
            return cuda_mc.first_contact_rows(0, levels, params, lanes=cuda_mc.SINGLE_LANES,
                                              **kw)
        if family == "gated":
            return cuda_gated.gated_rows(0, levels, params, gate, lanes=GATED_LANES, **kw)
        return cuda_engine.engine_rows(0, levels, params, lanes=ENGINE_LANES, **kw)

    times = {}
    for family in ("first contact", "gated", "engine"):
        for sampler in SAMPLERS:
            launch(family, sampler)
            torch.cuda.synchronize()
            times[f"{family}/{sampler}"] = ms = cuda_ms(lambda: launch(family, sampler), 3)
            print(f"  {family} {sampler}: {ms:.3f} ms at {MAIN_PATHS} x {NUM_BARS}", flush=True)
    print(json.dumps({"tree": os.path.abspath(tree), "card": smi, "ms": times,
                      "ptxas": ptxas}))
    return 0

def parent_times() -> int:
    """Each parent engine kernel against its envelope kernel, forced
    (``cuda_engine._FORCE_ENVELOPE``) where the parent fits (<= 8 levels, an
    even W <= 61), at its main path's shape: the single configuration (3
    levels x 40 x 2^28), the three single samplers (2^26 on
    ``history_arrays``' year of bars), config #4's universe (100 x 2^20) and
    the book and its three samplers (100 x 2^20); one launch of each in
    turn, two turns, CUDA events (the sweep has one kernel at every shape,
    ``mc_engine_bar_sweep_kernel``: ``--sweep-times`` times it against
    another tree's).  Prints each pair, then one JSON line with them and the
    card's name and power limit.  Outside the main run (``--parent-times``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    wide = ["mc_engine_wide", "mc_engine_wide_samplers", "mc_engine_wide_corr",
            "mc_engine_wide_corr_samplers"]
    build.build_all(["mc_engine", "mc_engine_samplers", "mc_engine_corr",
                     "mc_engine_corr_samplers"] + wide)
    for name in wide:
        for fn, res in sorted(ptxas_resources(build.BUILD_LOG[name]["log"]).items()):
            print(f"  ptxas {fn[:72]}: {res}", flush=True)
    dev = torch.device("cuda", 0)
    params = EngineParams.default()
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))
    one = dict(num_bars=NUM_BARS, sigma=SIGMA, dt=DT, lanes=ENGINE_LANES, device=dev)

    def samp(s, book=False):
        return ({} if s == "gbm" else dict(sampler=s) if s == "heston" else
                dict(sampler=s, tables=tables[None].to(dev) if book else tables,
                     block_len=SAMPLER_BLOCK_LEN))

    c4 = config4()
    book = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                             {"color": "orange", "type": "dashed", "index": 0,
                              "price": x + 0.4}] for x in BOOK_S0], max_levels=4), params,
            BOOK_S0, [SIGMA] * BOOK_SYMBOLS, BOOK_BETAS, [1.0 / BOOK_SYMBOLS] * BOOK_SYMBOLS)
    cases = {f"single (mc_engine_sweep_kernel, 1 row) 3 x {NUM_BARS} x {MAIN_PATHS}":
             lambda: CE.engine_rows(0, levels, params, num_paths=MAIN_PATHS, **one)}
    for s in SAMPLERS:
        cases[f"sampler {s} (mc_engine_sampler_kernel) 3 x {NUM_BARS} x {1 << 26}"] = (
            lambda s=s: CE.engine_rows(0, levels, params, num_paths=1 << 26, **one, **samp(s)))
    cases[f"universe (mc_engine_sweep_kernel) config #4 {UNI_SYMBOLS} x {UNI_PATHS}"] = (
        lambda: CE.engine_universe_rows(0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS,
                                        num_bars=NUM_BARS, dt=DT, lanes=ENGINE_LANES,
                                        device=dev))
    for s in ("gbm",) + SAMPLERS:
        kernel = "mc_engine_corr_kernel" if s == "gbm" else "mc_engine_corr_sampler_kernel"
        cases[f"book {s} ({kernel}) {BOOK_SYMBOLS} x {BOOK_PATHS}"] = (
            lambda s=s: CE.engine_corr_rows(0, *book, paths_per_symbol=BOOK_PATHS,
                                            num_bars=NUM_BARS, dt=DT, lanes=ENGINE_LANES,
                                            device=dev, **samp(s, book=True)))
    out = {}
    for name, fn in cases.items():
        def forced(fn=fn):
            with forced_envelope(CE):
                return fn()
        fn = parent_run(CE, fn)       # the parent, not the rows kernel that replaced it
        fn()
        forced()                                          # warm both
        torch.cuda.synchronize()
        t = interleaved_ms({"parent": fn, "envelope": forced})
        dig = {k: count_digest(CE.reduce_rows(*f()[:2])[0])
               for k, f in (("parent", fn), ("envelope", forced))}
        out[name] = dict(t, ratio=t["envelope"] / t["parent"], counts=dig)
        print(f"  {name}: parent {t['parent']:.3f} ms, envelope forced {t['envelope']:.3f} ms "
              f"({t['envelope'] / t['parent']:.4f}x); count digests {dig['parent']}, "
              f"{dig['envelope']}", flush=True)
    print(json.dumps({"card": smi, "parent_vs_envelope_ms": out}))
    return 0



ENV_TIMES_LEVELS = (8, 30, 64)   # the level counts timed at 390 bars x 2^24


def count_digest(*tensors) -> str:
    """A digest of int64 count totals (folded partial rows: the counts, the
    skip table, escalations, the histogram; a harvest's counts): equal totals
    give equal digests, whatever the kernel's CTA size."""
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_resources(log: str, names=("mc_engine_wide", "bar_step")) -> dict:
    """{function: {registers, stack, spill}} of the functions whose mangled
    names hold one of ``names`` (the ``mc_engine_wide*`` kernels and the bar
    steps: their stack frames) in an nvcc ``-Xptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and any(n in fn for n in names):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if m:
                out.setdefault(fn, {}).update(stack=int(m.group(1)), spill=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def probe_tree(tree: str, name: str, edits: dict) -> str:
    """A copy of ``tree``'s package under ``tree/build/<name>`` with each
    ``ops/csrc`` source of ``edits`` rewritten by its (pattern, replacement)
    once: a timing probe, not a result."""
    src = os.path.join(tree, "qmmx_monolithic_monte_carlo_tpu_torch")
    dst = os.path.join(tree, "build", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "qmmx_monolithic_monte_carlo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, (pattern, repl) in edits.items():
        path = os.path.join(dst, "qmmx_monolithic_monte_carlo_tpu_torch", "ops", "csrc", source)
        text, n = re.subn(pattern, repl, open(path).read())
        if n != 1:
            raise RuntimeError(f"{path}: {pattern!r} matched {n} times, not once")
        open(path, "w").write(text)
    return dst


def no_guard_tree(tree: str) -> str:
    """``tree``'s package whose gbm envelope kernel never takes the windowed
    guard (the running box at any W): the guard's cost, by ``probe_tree``."""
    return probe_tree(tree, "no-guard", {"mc_engine_wide.cu": (
        r"wide_dispatch\((num_bars > GUARD_WINDOW|win),", "wide_dispatch(false,")})


def min_blocks_tree(tree: str, gbm: int, sampler: int, book=None) -> str:
    """``tree``'s package with its envelope kernels' ``__launch_bounds__``
    CTAs an SM set to ``gbm`` and ``sampler`` (mc_engine_env.cuh's
    ENV_MIN_BLOCKS, ENV_SAMPLER_MIN_BLOCKS) and, given ``book``, the books'
    (mc_engine_wide_corr.cuh's ENV_BOOK_MIN_BLOCKS), by ``probe_tree``."""
    edits = {"mc_engine_env.cuh": (
        r"#define ENV_MIN_BLOCKS \d+\n#define ENV_SAMPLER_MIN_BLOCKS \d+\n",
        f"#define ENV_MIN_BLOCKS {gbm}\n#define ENV_SAMPLER_MIN_BLOCKS {sampler}\n")}
    if book:
        edits["mc_engine_wide_corr.cuh"] = (r"#define ENV_BOOK_MIN_BLOCKS \d+\n",
                                            f"#define ENV_BOOK_MIN_BLOCKS {book}\n")
    name = "-".join(str(x) for x in (gbm, sampler, book) if x)
    return probe_tree(tree, f"min-blocks-{name}", edits)


def envelope_times(tree: str, no_guard: bool = False, min_blocks=None,
                   books_only: bool = False) -> int:
    """The envelope kernels of the port in ``tree`` (``mc_engine_wide*``)
    timed at their main paths' shapes by CUDA events (a warm-up, then the mean
    of two runs), each with a digest of its folded int64 count totals
    (``count_digest``): gbm at 8, 30 and 64 levels x 390 bars x 2^24 on
    ``env_ladder``; at 30 x 390 the three samplers (2^24, ``history_arrays``'
    year), the sweep's 18 rows (3 x 3 x jitter 0, 0.02) at 2^20 and the
    harvest build at 2^24; at the CLI's 3 levels x 40 x 2^28 the envelope
    kernel forced beside the parent and the harvest build (the flywheel's
    round); the books (``mc_engine_wide_corr_kernel``) under gbm and the three
    samplers at 10 symbols x 30 levels x 390 x 2^20 (and the harvest builds
    under gbm and block bootstrap), their digests with every path's row of a
    2^16-path run, and at the parents' 100 x 2^20 x 40 the parent book
    (``parent_run``), the book as routed (the book rows kernel) and the
    envelope book forced, timed in turns (parent, rows, forced, forced, rows,
    parent, one run each), their digests with every path's row of a
    2^13-path run, which must agree.  With ``no_guard`` the tree's gbm envelope kernel is
    built without the windowed guard (``no_guard_tree``) and only gbm at 390
    bars is timed; with ``min_blocks`` (gbm, sampler[, book]) the tree's
    envelope kernels are built with those ``__launch_bounds__`` CTAs an SM
    (``min_blocks_tree``); ``books_only`` times the books' cases alone.
    Builds into the tree's ``build/kernels-times`` and prints the
    ptxas registers, stack and spill of each ``mc_engine_wide*`` kernel
    built; prints each time, then one JSON line with all of them, the card's
    name and power limit.  Run once a tree, in turns with another tree
    (``--envelope-times TREE [--no-guard]``)."""
    tree = os.path.abspath(tree)
    root = (no_guard_tree(tree) if no_guard else
            min_blocks_tree(tree, *min_blocks) if min_blocks else tree)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from pathlib import Path

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.BUILD_DIR = Path(root) / "build" / "kernels-times"
    names = (["mc_engine_wide"] if no_guard else
             ["mc_engine", "mc_engine_wide", "mc_engine_wide_samplers", "mc_engine_wide_harvest",
              "mc_engine_wide_samplers_harvest", "mc_engine_corr", "mc_engine_corr_samplers",
              "mc_engine_wide_corr", "mc_engine_wide_corr_samplers",
              "mc_engine_wide_corr_harvest", "mc_engine_wide_corr_samplers_harvest"]
             + ([CE.BOOK_ROWS_SOURCE] if hasattr(CE, "BOOK_ROWS_SOURCE") else []))
    build.build_all(names)
    ptxas = {}
    for name in names:
        ptxas.update(ptxas_resources(build.BUILD_LOG[name]["log"],
                                     ("mc_engine_wide", "bar_step", "mc_engine_book_rows")))
    for fn, r in sorted(ptxas.items()):
        print(f"  ptxas {fn[:70]}: {r}", flush=True)
    dev = torch.device("cuda", 0)
    params = EngineParams.default()
    one = dict(sigma=SIGMA, dt=DT, lanes=ENGINE_LANES, device=dev)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))

    def ladder(n):
        return Levels.from_rows(env_ladder(n), max_levels=n)

    def rows_case(fn, harvest=False, also=None):
        def run():
            return fn()
        def digest():
            out = fn()
            c, _ = CE.reduce_rows(out[0], out[1])
            extra = also() if also else ()
            if not harvest:
                return count_digest(c, *extra)
            h = CE.reduce_harvest(out[-2], out[-1])
            return count_digest(c, h.ml_counts, h.pol_counts, *extra)
        return run, digest

    cases, turns = {}, []                    # turns: groups of cases timed in turns
    for n in () if books_only else ENV_TIMES_LEVELS:
        cases[f"gbm {n} x {ENV_BARS} x {ENV_PATHS}"] = rows_case(
            lambda n=n: CE.engine_rows(0, ladder(n), params, num_paths=ENV_PATHS,
                                       num_bars=ENV_BARS, **one))
    if not (no_guard or books_only):
        lv30 = ladder(ENV_LEVELS)
        for smp in SAMPLERS:
            skw = (dict(sampler=smp) if smp == "heston" else
                   dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN))
            cases[f"{smp} {ENV_LEVELS} x {ENV_BARS} x {ENV_PATHS}"] = rows_case(
                lambda skw=skw: CE.engine_rows(0, lv30, params, num_paths=ENV_PATHS,
                                               num_bars=ENV_BARS, **one, **skw))
        grid18 = [(sp, tp, j) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)
                  for j in (0.0, 0.02)]
        g_params = params.replace(stop_padding=[c[0] for c in grid18],
                                  tp_padding=[c[1] for c in grid18])
        jit = torch.tensor([c[2] for c in grid18])
        g_noise = McNoise(level_jitter_std=jit, entry_slip_std=torch.zeros_like(jit),
                          stop_slip_std=torch.zeros_like(jit),
                          target_slip_std=torch.zeros_like(jit))
        cases[f"sweep 18 rows {ENV_LEVELS} x {ENV_BARS} x {ENV_SWEEP_PATHS}"] = rows_case(
            lambda: CE.engine_sweep_rows(0, lv30, g_params, noise=g_noise,
                                         num_paths=ENV_SWEEP_PATHS, num_bars=ENV_BARS, **one))
        cases[f"harvest {ENV_LEVELS} x {ENV_BARS} x {ENV_PATHS}"] = rows_case(
            lambda: CE.engine_rows(0, lv30, params, num_paths=ENV_PATHS, num_bars=ENV_BARS,
                                   harvest=True, **one), harvest=True)
        lv3 = Levels.from_rows(CLI_ROWS, max_levels=8)
        kw3 = dict(num_paths=MAIN_PATHS, num_bars=NUM_BARS, **one)
        cases[f"parent (mc_engine_sweep_kernel) 3 x {NUM_BARS} x {MAIN_PATHS}"] = rows_case(
            parent_run(CE, lambda: CE.engine_rows(0, lv3, params, **kw3)))
        cases[f"forced 3 x {NUM_BARS} x {MAIN_PATHS}"] = rows_case(
            forced(CE, lambda: CE.engine_rows(0, lv3, params, **kw3)))
        cases[f"harvest 3 x {NUM_BARS} x {MAIN_PATHS}"] = rows_case(
            lambda: CE.engine_rows(0, lv3, params, harvest=True, **kw3), harvest=True)
    if not no_guard:
        # the books: phase 30's at 30 levels x 390 bars, the parents' at 40 bars
        n_b = ENV_BOOK_SYMBOLS
        s0_b = [100.0 + 10.0 * i for i in range(n_b)]
        book = (U.stack_levels([env_ladder(ENV_LEVELS, s0) for s0 in s0_b],
                               max_levels=ENV_LEVELS), params, s0_b, [SIGMA] * n_b,
                [0.2 + 0.6 * i / (n_b - 1) for i in range(n_b)], [1.0 / n_b] * n_b)
        par_book = (U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                                     {"color": "orange", "type": "dashed", "index": 0,
                                      "price": x + 0.4}] for x in BOOK_S0], max_levels=4),
                    params, BOOK_S0, [SIGMA] * BOOK_SYMBOLS, BOOK_BETAS,
                    [1.0 / BOOK_SYMBOLS] * BOOK_SYMBOLS)
        tables1 = tables[None].to(dev)

        def book_case(fn, harvest=False):
            """rows_case of a book, its digest also over every path's row
            (symbols and book) of a run at 2^16 paths a symbol."""
            return rows_case(lambda: fn(ENV_BOOK_PATHS, False), harvest,
                             also=lambda: (fn(1 << 16, True)[2],))

        for smp in ("gbm",) + SAMPLERS:
            bkw = dict(dt=DT, lanes=ENGINE_LANES, device=dev,
                       **({} if smp == "gbm" else dict(sampler=smp) if smp == "heston" else
                          dict(sampler=smp, tables=tables1, block_len=SAMPLER_BLOCK_LEN)))
            cases[f"book {smp} {n_b} x {ENV_LEVELS} x {ENV_BARS} x {ENV_BOOK_PATHS}"] = \
                book_case(lambda n, pp, bkw=bkw: CE.engine_corr_rows(
                    0, *book, paths_per_symbol=n, num_bars=ENV_BARS, per_path=pp, **bkw))
            if smp in ("gbm", "block_bootstrap"):
                cases[f"book harvest {smp} {n_b} x {ENV_LEVELS} x {ENV_BARS} x "
                      f"{ENV_BOOK_PATHS}"] = book_case(
                    lambda n, pp, bkw=bkw: CE.engine_corr_rows(
                        0, *book, paths_per_symbol=n, num_bars=ENV_BARS, per_path=pp,
                        harvest=True, **bkw), harvest=True)
            group = []
            for form, wrap in (("parent", lambda fn: parent_run(CE, fn)), ("rows", lambda fn: fn),
                               ("forced", lambda fn: forced(CE, fn))):
                name = f"book {form} {smp} {BOOK_SYMBOLS} x {NUM_BARS} x {BOOK_PATHS}"
                cases[name] = rows_case(
                    wrap(lambda bkw=bkw: CE.engine_corr_rows(
                        0, *par_book, paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, **bkw)),
                    also=wrap(lambda bkw=bkw: (CE.engine_corr_rows(
                        0, *par_book, paths_per_symbol=1 << 13, num_bars=NUM_BARS,
                        per_path=True, **bkw)[2],)))
                group.append(name)
            turns.append(group)
    ms, digests = {}, {}
    in_turns = {name for group in turns for name in group}
    for name, (run, digest) in cases.items():
        digests[name] = digest()             # also the warm-up
        torch.cuda.synchronize()
        if name not in in_turns:
            ms[name] = cuda_ms(run, 2)
            print(f"  {name}: {ms[name]:.3f} ms, counts {digests[name]}", flush=True)
    for group in turns:
        for name in group + group[::-1]:
            ms.setdefault(name, []).append(cuda_ms(cases[name][0], 1))
        for name in group:
            print(f"  {name}: {', '.join(f'{t:.3f}' for t in ms[name])} ms, "
                  f"counts {digests[name]}", flush=True)
        if len({digests[name] for name in group}) != 1:
            raise AssertionError(f"{group}: the count digests differ")
    print(json.dumps({"tree": tree, "no_guard": no_guard, "min_blocks": min_blocks,
                      "card": smi, "ms": ms,
                      "digest": digests, "ptxas": ptxas}))
    return 0


SWEEP_TIMES_SHAPES = ((NUM_BARS, MAIN_PATHS), (390, 1 << 24))   # (W, paths), 9 rows


def sampler_sweep_times(tree: str) -> int:
    """The first-contact sampler sweeps (``cuda_mc.sweep_rows`` under
    bootstrap, block bootstrap and Heston) of the port in ``tree`` on the
    CLI's levels and 3 x 3 (stop, tp) grid at 2^28 x 40 and 2^24 x 390 bars
    on ``history_arrays``' year of 1-minute bars, each timed by CUDA events (a
    warm-up that also takes a digest of the folded counts and floats,
    ``count_digest``, then the mean of two runs).  Builds into the tree's
    ``build/kernels-times``; prints the sweep's libraries' ptxas lines, each
    time, then one JSON line with all of them, the card's name and power
    limit.  Run once a tree, in turns with another tree
    (``--sampler-sweep-times TREE``)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from pathlib import Path

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {smi}", flush=True)
    build.BUILD_DIR = Path(tree) / "build" / "kernels-times"
    libs = [n for n in ("mc_first_contact", "mc_first_contact_samplers",
                        "mc_first_contact_sampler_sweep") if (build.CSRC / f"{n}.cu").exists()]
    build.build_all(libs)
    ptxas = {name: [line.strip() for line in build.BUILD_LOG[name]["log"].splitlines()
                    if any(k in line for k in ("Compiling entry", "registers", "spill"))]
             for name in libs[1:]}
    for name, lines in ptxas.items():
        for line in lines:
            print(f"  {name}: {line}")
    dev = torch.device("cuda", 0)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))
    params = EngineParams.default()
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    stops9, tps9 = [g[0] for g in GRID9], [g[1] for g in GRID9]
    ms, digests = {}, {}
    for w, n in SWEEP_TIMES_SHAPES:
        for smp in SAMPLERS:
            skw = (dict(sampler=smp) if smp == "heston" else
                   dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN))

            def run(w=w, n=n, skw=skw):
                return cuda_mc.sweep_rows(0, levels, params, stops9, tps9, num_paths=n,
                                          num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                                          lanes=LANES, external_uniforms=None, device=dev,
                                          **skw)

            name = f"{smp} 9 x {n} x {w}"
            digests[name] = count_digest(*cuda_mc.reduce_rows(*run()))   # also the warm-up
            torch.cuda.synchronize()
            ms[name] = cuda_ms(run, 2)
            print(f"  {name}: {ms[name]:.3f} ms, totals {digests[name]}", flush=True)
    print(json.dumps({"tree": tree, "card": smi, "ms": ms, "digest": digests, "ptxas": ptxas}))
    return 0


# --fc-rows-digests: first contact's gbm partial rows at these horizons, held
# bit for bit against those of the kernel mc_universe_kernel replaced
# (tests/test_torch_universe_gated_redesign.py keeps that kernel's digests)
FC_ROWS_BARS = (2, 40, 128, 130, 390)
FC_ROWS_INJECT_PATHS = 1 << 16      # a symbol, injected (8 blocks of 8192 lanes; 3 of 2048 x 8)
FC_ROWS_PHILOX_PATHS = 1 << 21      # a symbol, Philox: two chunks a thread of 4096 CTAs


def fc_rows_cases(cuda_mc, dev):
    """{case: a function giving its gbm partial rows}: at each W of
    FC_ROWS_BARS, the single run with noise and antithetic lanes and a
    3-symbol universe, on injected uniforms (numpy, seeded by W) and on
    Philox; the public launchers only, so any tree of the port runs them."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    params = EngineParams.default()
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
                         target_slip_std=0.015)
    lv3 = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                           {"color": "orange", "type": "dashed", "index": 0, "price": x + 0.4}]
                          for x in (100.0, 50.0, 75.0)], max_levels=8)
    s0_3, sg_3 = np.array([100.0, 50.0, 75.0], np.float32), np.array([0.3, 0.4, 0.25], np.float32)

    def uniforms(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).uniform(1e-9, 1.0, shape)
                                .astype(np.float32)).to(dev)

    cases = {}
    for w in FC_ROWS_BARS:
        common = dict(num_bars=w, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=LANES)
        n_rows = GbmLayout(w, True).n_rows
        cases[f"single inject W{w}"] = lambda w=w, common=common, n_rows=n_rows: (
            cuda_mc.first_contact_rows(
                0, levels, params, num_paths=FC_ROWS_INJECT_PATHS, noise=noise, antithetic=True,
                external_uniforms=uniforms(w, (FC_ROWS_INJECT_PATHS // LANES, n_rows, LANES)),
                device=dev, **common))
        cases[f"single philox W{w}"] = lambda common=common: cuda_mc.first_contact_rows(
            5, levels, params, num_paths=FC_ROWS_PHILOX_PATHS, noise=noise, antithetic=True,
            external_uniforms=None, device=dev, **common)
        ukw = dict(num_bars=w, dt=DT, lanes=cuda_mc.UNIVERSE_LANES, device=dev)
        n_u = GbmLayout(w).n_rows
        cases[f"universe inject W{w}"] = lambda w=w, ukw=ukw, n_u=n_u: cuda_mc.universe_rows(
            0, lv3, params, s0_3, sg_3, paths_per_symbol=FC_ROWS_INJECT_PATHS // 4,
            external_uniforms=uniforms(1000 + w, (3, FC_ROWS_INJECT_PATHS // 4
                                                  // cuda_mc.UNIVERSE_LANES, n_u,
                                                  cuda_mc.UNIVERSE_LANES)), **ukw)
        cases[f"universe philox W{w}"] = lambda ukw=ukw: cuda_mc.universe_rows(
            5, lv3, params, s0_3, sg_3, paths_per_symbol=FC_ROWS_PHILOX_PATHS,
            external_uniforms=None, **ukw)
    return cases


def fc_rows_digests(tree: str) -> int:
    """The digests (``count_digest`` of the int64 and float32 partial rows) of
    ``fc_rows_cases`` run by the port in ``tree``, as one JSON line, beside
    the card's name and power limit: a parent unpacked with ``git archive``
    gives the digests the redesigned kernel is held to."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from pathlib import Path

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    build.BUILD_DIR = Path(tree) / "build" / "kernels-digests"
    dev = torch.device("cuda", 0)
    out = {name: count_digest(*run()) for name, run in fc_rows_cases(cuda_mc, dev).items()}
    print(json.dumps({"tree": tree, "card": smi, "digest": out}))
    return 0


# --sweep-times: the gbm and the gated sampler sweeps at their main paths' shapes
SWEEP_AB_GBM = ((CONFIG5, 1 << 30, NUM_BARS), (GRID9, MAIN_PATHS, NUM_BARS),
                (GRID9, 1 << 24, 390))           # (rows, paths, W): config #5, the CLI's 9
SWEEP_AB_GATED_PATHS = 1 << 26                   # sweep --gated --touch-limits 2 4: 18 rows
# first contact's single run (``paths``: 2^28 paths, at 40 and 390 bars, on
# the CLI's levels) and config #4's universe (100 x 2^20) at 40 and 390 bars
SWEEP_AB_FC_BARS = (NUM_BARS, 390)
SWEEP_AB_ENGINE_PATHS = 1 << 24                  # sweep --engine --jitter-stds 0 0.02: 18 rows
# the engine kernels' ptxas lines: the sweep, the one-row kernels it replaced,
# the single run's rows kernel and the parents it replaced
SWEEP_AB_PTXAS = ("sweep", "bar_step", "mc_engine_sampler_kernel", "mc_engine_wide_kernel",
                  "mc_engine_wide_sampler_kernel", "mc_engine_rows_kernel")


def sweep_times(tree: str, engine_only: bool = False, redesign_only: bool = False) -> int:
    """The gbm, the gated sampler and the engine sweeps of the port in
    ``tree``, at their main paths' shapes: first contact's single run
    (``cuda_mc.first_contact_rows``) at 2^28 x 40 and 2^28 x 390 on the
    CLI's levels and config #4's universe (``cuda_mc.universe_rows``, 100
    x 2^20) at 40 and 390 bars; the gated sweep's gbm launch
    (``cuda_gated.gated_sweep_rows``) on the CLI's ``sweep --gated
    --touch-limits 2 4`` grid (18 rows) at 2^26 x 40; the gbm first-contact sweep
    (``cuda_mc.sweep_rows``) at config #5 (3 rows x 2^30 x 40), the CLI's 9
    rows at 2^28 x 40 and 9 x 2^24 x 390; the gated sweep
    (``cuda_gated.gated_sweep_rows``) on the CLI's ``sweep --gated
    --touch-limits 2 4`` grid (18 rows) at 2^26 x 40 under bootstrap, block
    bootstrap and Heston on ``history_arrays``' year of 1-minute bars; the
    engine sweep (``cuda_engine.engine_sweep_rows``) on the CLI's ``sweep
    --engine --jitter-stds 0 0.02`` grid (18 rows) at 2^24 x 40 under gbm and
    the three samplers, and at phase 29's envelope (30 levels x 390 bars x
    2^20, 18 rows), and each at one row (the bars and one row's replay); the
    engine's single run (``cuda_engine.engine_rows``, ``paths --engine``) at
    2^28 x 40 on the CLI's levels and config #4's engine universe
    (``engine_universe_rows``, 100 x 2^20 x 40; symbol i on
    ``universe_history``'s history 1000 + i) under gbm and the three
    samplers.  ``engine_only`` (``--engine``) times the engine sweeps alone,
    ``redesign_only`` (``--redesign``) the engine's single run and universe
    alone.
    Each timed by CUDA events (a warm-up that
    also takes a digest of the folded counts and floats, ``count_digest``,
    then the mean of two runs).  Builds into the tree's
    ``build/kernels-times``; prints the sweep kernels' ptxas lines, each time,
    then one JSON line with all of them, the card's name and power limit.
    Run once a tree, in turns with another tree (``--sweep-times TREE``)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the kernels run on the card")
    from pathlib import Path

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import (bootstrap_tables,
                                                                   universe_tables)
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {smi}", flush=True)
    build.BUILD_DIR = Path(tree) / "build" / "kernels-times"
    engine_libs = ("mc_engine", "mc_engine_samplers", "mc_engine_wide",
                   "mc_engine_wide_samplers", "mc_engine_bar_sweep", "mc_engine_rows")
    # (mc_first_contact_long: an earlier tree's first contact past 128 bars)
    fc_libs = ("mc_first_contact", "mc_first_contact_long", "mc_gated", "mc_gated_sampler_sweep",
               "mc_first_contact_sweep", "mc_gated_samplers")
    libs = [n for n in (("mc_engine", "mc_engine_samplers", "mc_engine_rows") if redesign_only
                        else (() if engine_only else fc_libs) + engine_libs)
            if (build.CSRC / f"{n}.cu").exists()]
    t0 = time.perf_counter()
    build.build_all(libs)
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {}
    for name in libs:
        fn = None
        keys = SWEEP_AB_PTXAS if name in engine_libs else ("sweep", "universe", "bar_step")
        for line in build.BUILD_LOG[name]["log"].splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'? ",
                          line + " ")
            if m:
                fn = m.group(1)
            if fn and any(k in fn for k in keys) and re.search(r"registers|spill", line):
                ptxas.setdefault(f"{name}:{fn}", []).append(line.strip())
    for fn, lines in ptxas.items():
        for line in lines:
            print(f"  {fn[:100]}: {line}")
    dev = torch.device("cuda", 0)
    params = EngineParams.default()
    levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    ms, digests = {}, {}
    # the CLI's sweep --gated --touch-limits 2 4 grid: 3 x 3 (stop, tp) x touch limits 2, 4
    stops18 = [r[0] for r in GRID9 for _ in (2, 4)]
    tps18 = [r[1] for r in GRID9 for _ in (2, 4)]
    gate18 = GateConfig.from_params(params).replace(touch_limit=[tl for _ in GRID9
                                                                 for tl in (2, 4)])

    def timed(name, run, fold):
        digests[name] = count_digest(*fold(*run()))          # also the warm-up
        torch.cuda.synchronize()
        ms[name] = cuda_ms(run, 2)
        print(f"  {name}: {ms[name]:.3f} ms, totals {digests[name]}", flush=True)

    # first contact's single run and config #4's universe
    # (mc_universe_kernel), the gated sweep under gbm
    if not (engine_only or redesign_only):
        for w in SWEEP_AB_FC_BARS:
            timed(f"first contact {MAIN_PATHS} x {w}",
                  lambda w=w: cuda_mc.first_contact_rows(
                      0, levels, params, num_paths=MAIN_PATHS, num_bars=w, s0=100.0, mu=0.0,
                      sigma=SIGMA, dt=DT, lanes=LANES, noise=None, antithetic=False,
                      external_uniforms=None, device=dev),
                  cuda_mc.reduce_rows)
        c4 = config4()
        for w in SWEEP_AB_FC_BARS:
            timed(f"universe config #4 {UNI_SYMBOLS} x {UNI_PATHS} x {w}",
                  lambda w=w: cuda_mc.universe_rows(
                      0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=w,
                      dt=DT, lanes=cuda_mc.UNIVERSE_LANES, external_uniforms=None, device=dev),
                  cuda_mc.reduce_rows)
        timed(f"gated sweep gbm 18 x {SWEEP_AB_GATED_PATHS} x {NUM_BARS}",
              lambda: cuda_gated.gated_sweep_rows(
                  0, levels, params, stops18, tps18, gate18, num_paths=SWEEP_AB_GATED_PATHS,
                  num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=GATED_LANES,
                  noise=None, external_uniforms=None, device=dev),
              cuda_gated.reduce_rows)
    tables = torch.stack(bootstrap_tables(*history_arrays(SAMPLER_HIST_BARS)[1:]))
    # the engine's single run and config #4's engine universe
    # (mc_engine_rows_kernel, or the parents in an earlier tree)
    if not engine_only:
        c4 = config4()
        c4_tables = universe_tables(universe_history(UNI_SYMBOLS, SAMPLER_HIST_BARS, 1000)).to(dev)

        def engine_fold(*rows):
            return cuda_engine.reduce_rows(*rows[:2])

        for smp in ("gbm",) + SAMPLERS:
            skw, ukw = (({}, {}) if smp == "gbm" else
                        ((dict(sampler=smp),) * 2) if smp == "heston" else
                        (dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN),
                         dict(sampler=smp, tables=c4_tables, block_len=SAMPLER_BLOCK_LEN)))
            timed(f"paths --engine {smp} {MAIN_PATHS} x {NUM_BARS}",
                  lambda skw=skw: cuda_engine.engine_rows(
                      0, levels, params, num_paths=MAIN_PATHS, num_bars=NUM_BARS, s0=100.0,
                      mu=0.0, sigma=SIGMA, dt=DT, lanes=ENGINE_LANES, noise=None,
                      antithetic=False, external_uniforms=None, device=dev, **skw),
                  engine_fold)
            timed(f"engine universe {smp} config #4 {UNI_SYMBOLS} x {UNI_PATHS} x {NUM_BARS}",
                  lambda ukw=ukw: cuda_engine.engine_universe_rows(
                      0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS,
                      num_bars=NUM_BARS, dt=DT, lanes=ENGINE_LANES, device=dev, **ukw),
                  engine_fold)
    if redesign_only:
        print(json.dumps({"tree": tree, "card": smi, "ms": ms, "digest": digests,
                          "ptxas": ptxas}))
        return 0
    # the engine sweeps: the CLI's 18 rows (3 x 3 x level jitter 0, 0.02)
    jit18 = torch.tensor([j for _ in GRID9 for j in (0.0, 0.02)])
    grid18 = params.replace(stop_padding=[r[0] for r in GRID9 for _ in (0, 1)],
                            tp_padding=[r[1] for r in GRID9 for _ in (0, 1)])
    noise18 = McNoise(level_jitter_std=jit18, entry_slip_std=torch.zeros(18),
                      stop_slip_std=torch.zeros(18), target_slip_std=torch.zeros(18))
    lv30 = Levels.from_rows(env_ladder(ENV_LEVELS), max_levels=ENV_LEVELS)
    ekw = dict(noise=noise18, sigma=SIGMA, dt=DT, lanes=ENGINE_LANES, device=dev)
    grid1 = grid_row(grid18, 1)
    ekw1 = dict(ekw, noise=grid_row(noise18, 1), n_grid=1)
    for smp in ("gbm",) + SAMPLERS:
        skw = ({} if smp == "gbm" else dict(sampler=smp) if smp == "heston" else
               dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN))
        for g, p_g, kw_g in ((18, grid18, ekw), (1, grid1, ekw1)):
            timed(f"engine sweep {smp} {g} x {SWEEP_AB_ENGINE_PATHS} x {NUM_BARS}",
                  lambda p_g=p_g, kw_g=kw_g, skw=skw: cuda_engine.engine_sweep_rows(
                      0, levels, p_g, num_paths=SWEEP_AB_ENGINE_PATHS, num_bars=NUM_BARS,
                      **kw_g, **skw),
                  cuda_engine.reduce_rows)
    for g, p_g, kw_g in ((18, grid18, ekw), (1, grid1, ekw1)):
        timed(f"engine sweep gbm {g} x {ENV_SWEEP_PATHS} x {ENV_BARS} x {ENV_LEVELS} levels",
              lambda p_g=p_g, kw_g=kw_g: cuda_engine.engine_sweep_rows(
                  0, lv30, p_g, num_paths=ENV_SWEEP_PATHS, num_bars=ENV_BARS, **kw_g),
              cuda_engine.reduce_rows)
    if engine_only:
        print(json.dumps({"tree": tree, "card": smi, "ms": ms, "digest": digests,
                          "ptxas": ptxas}))
        return 0
    for rows, n, w in SWEEP_AB_GBM:
        stops, tps = [r[0] for r in rows], [r[1] for r in rows]
        timed(f"gbm sweep {len(rows)} x {n} x {w}",
              lambda stops=stops, tps=tps, n=n, w=w: cuda_mc.sweep_rows(
                  0, levels, params, stops, tps, num_paths=n, num_bars=w, s0=100.0, mu=0.0,
                  sigma=SIGMA, dt=DT, lanes=LANES, external_uniforms=None, device=dev),
              cuda_mc.reduce_rows)
    for smp in SAMPLERS:
        skw = (dict(sampler=smp) if smp == "heston" else
               dict(sampler=smp, tables=tables, block_len=SAMPLER_BLOCK_LEN))
        timed(f"gated sweep {smp} 18 x {SWEEP_AB_GATED_PATHS} x {NUM_BARS}",
              lambda skw=skw: cuda_gated.gated_sweep_rows(
                  0, levels, params, stops18, tps18, gate18, num_paths=SWEEP_AB_GATED_PATHS,
                  num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, lanes=GATED_LANES,
                  noise=None, external_uniforms=None, device=dev, **skw),
              cuda_gated.reduce_rows)
    print(json.dumps({"tree": tree, "card": smi, "ms": ms, "digest": digests, "ptxas": ptxas}))
    return 0


def main() -> int:
    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
    from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
    from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.guard import GuardParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.touch import TouchMemoryParams
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import SKIP_REASONS
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import (LIFE_HIST_HI,
                                                                   LIFE_HIST_LO, PathStats)
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = Card(float(clock), torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[1] device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; {card.sms} SMs, "
        f"clocks.max.sm {clock} MHz")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 2: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    build.build_all(["mc_first_contact", "mc_gated", "mc_engine",
                     "mc_gated_corr",
                     "mc_engine_corr", "mc_first_contact_samplers",
                     "mc_first_contact_sampler_sweep", "mc_gated_samplers",
                     "mc_engine_samplers", "mc_gated_corr_samplers",
                     "mc_engine_corr_samplers", "mc_engine_wide", "mc_engine_wide_samplers",
                     "mc_engine_wide_corr", "mc_engine_wide_corr_samplers",
                     "mc_engine_wide_harvest", "mc_engine_wide_samplers_harvest",
                     "mc_engine_wide_corr_harvest", "mc_engine_wide_corr_samplers_harvest",
                     "mc_first_contact_sweep", "mc_gated_sampler_sweep",
                     "mc_engine_bar_sweep", "mc_engine_rows", "mc_engine_book_rows"])
    log(f"[2] build: {time.perf_counter() - t0:.2f} s wall")
    for name, info in build.BUILD_LOG.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                log(f"    ptxas: {line.strip()}")

    def reset_all():
        for mod in (cuda_mc, cuda_gated, cuda_engine):
            mod.reset_launches()

    levels = Levels.from_rows(
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
         {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
        max_levels=8)
    cli_levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    params = EngineParams.default()
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02,
                         stop_slip_std=0.015, target_slip_std=0.015)
    common = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                  lanes=LANES)

    # ---- phase 3: first contact, injected uniforms
    log("[3] first contact, injected uniforms: kernel vs plain (plain on CPU copies)")
    fc_err = 0.0
    n_blocks = 16
    for case, nz, anti in (("plain", None, False), ("noise", noise, False),
                           ("antithetic", None, True),
                           ("noise+antithetic", noise, True)):
        n_rows = 3 * NUM_BARS + 1 + (4 if nz is not None else 0)
        rng = np.random.default_rng(len(case))
        u = torch.from_numpy(
            rng.uniform(1e-9, 1.0, (n_blocks, n_rows, LANES)).astype(np.float32))
        kw = dict(common, num_paths=n_blocks * LANES, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(0, levels, params,
                                              external_uniforms=u, **kw)
        rows = cuda_mc.first_contact_rows(0, levels, params, device=dev,
                                          external_uniforms=u.to(dev), **kw)
        got = cuda_mc.reduce_rows(*rows)
        torch.cuda.synchronize()
        fc_err = max(fc_err, compare(case, want, got, n_blocks * LANES))

    # ---- phase 4: first contact, Philox stream, and the row reduction
    log(f"[4] first contact, Philox: kernel vs plain at {PHILOX_PATHS} paths "
        "(plain on the card)")
    reduce_err = 0.0
    for case, nz, anti in (("philox", None, False), ("philox+noise", noise, True)):
        kw = dict(common, num_paths=PHILOX_PATHS, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(7, levels, params, device=dev, **kw)
        rows = cuda_mc.first_contact_rows(7, levels, params, device=dev,
                                          external_uniforms=None, **kw)
        got = cuda_mc.reduce_rows(*rows)
        torch.cuda.synchronize()
        fc_err = max(fc_err, compare(case, want, got, PHILOX_PATHS))
        reduce_err = max(reduce_err, check_fold(
            "mc_reduce_rows", cuda_mc.reduce_rows_reference(*rows), got))
    log(f"  mc_reduce_rows: counts exact, float max abs err {reduce_err:.3e}")

    # kernel and plain times at PLAIN_PATHS on the main path's inputs (seed 0,
    # the CLI's levels, Philox, no noise); the work sample for the bounds
    kw = dict(common, num_paths=PLAIN_PATHS, noise=None, antithetic=False,
              external_uniforms=None)

    def run_fc(n=PLAIN_PATHS):
        return cuda_mc.first_contact_rows(0, cli_levels, params, device=dev,
                                          **dict(kw, num_paths=n))

    run_fc()
    fc_ms = cuda_ms(run_fc, 3)
    fc_rows = run_fc()
    plain_ms = cuda_ms(lambda: cuda_mc.fused_totals_reference(
        0, cli_levels, params, device=dev, **kw), 1)
    red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*fc_rows), 20)
    red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*fc_rows), 20)
    sc, _, work = cuda_mc.fused_totals_reference(
        0, cli_levels, params, device=dev, work=True,
        **dict(kw, num_paths=PHILOX_PATHS))
    fc_bound = card.bound(bytes_=fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4,
                          **fc_ops(work.cpu(), int(sc[1]), PLAIN_PATHS / PHILOX_PATHS))
    red_bytes = (fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4
                 + cuda_mc.ROW_COUNTS * 8 + cuda_mc.ROW_FLOATS * 8)
    red_bound = card.bound(bytes_=red_bytes, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths: kernel {fc_ms:.3f} ms "
        f"({PLAIN_PATHS / fc_ms * 1e3:.6e} paths/s), bound {fc_bound['bound_ms']:.3f} ms "
        f"{fc_bound['bound_parts']}, plain {plain_ms:.3f} ms "
        f"({PLAIN_PATHS / plain_ms * 1e3:.6e} paths/s)")
    log(f"  work per path (first {PHILOX_PATHS} paths): pairs, walked, after contact, "
        f"Philox calls {[round(float(x) / PHILOX_PATHS, 4) for x in work.cpu()]}")
    log(f"  row reduction ({fc_rows[0].shape[0]} rows): kernel {red_ms:.4f} ms, "
        f"plain {red_plain_ms:.4f} ms, bound {red_bound['bound_ms']:.4f} ms")

    # ---- phase 5: the first-contact main path through the CLI
    log(f"[5] main path: cli paths --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--backend",
                "cuda", "--num-paths", str(MAIN_PATHS), "--num-bars",
                str(NUM_BARS), "--sigma", str(SIGMA)]
        (fc_out,), fc_secs, fc_launches = run_cli(
            cli, argv, reset_all, {"mc_first_contact": 1, "mc_reduce_rows": 1})
    check_paths_output(fc_out)
    fc_main_ms = cuda_ms(lambda: run_fc(MAIN_PATHS), 2)
    fc_main_bound = card.bound(
        bytes_=fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4,
        **fc_ops(work.cpu(), int(sc[1]), MAIN_PATHS / PHILOX_PATHS))
    log(f"  kernel alone at {MAIN_PATHS} paths: {fc_main_ms:.3f} ms "
        f"({MAIN_PATHS / fc_main_ms * 1e3:.6e} paths/s), bound "
        f"{fc_main_bound['bound_ms']:.3f} ms {fc_main_bound['bound_parts']}")

    # ---- phase 6: gated, injected uniforms
    gcommon = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                   lanes=GATED_LANES)
    n_inj = GATED_INJECT_BLOCKS * 8 * GATED_LANES
    log(f"[6] gated, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_inj} paths")
    gated_err = 0.0
    for case, gate, nz, anti in (
            ("defaults", GateConfig.from_params(params), None, False),
            ("multi-trade", GateConfig.default(touch_limit=100, touch_gap_bars=1,
                                               use_confidence=False), None, False),
            ("tight", GateConfig.default(touch_limit=2, cooldown_bars=3), None, False),
            ("noise", GateConfig.from_params(params), noise, False),
            ("antithetic", GateConfig.from_params(params), None, True)):
        rng = np.random.default_rng(100 + len(case))
        u = torch.from_numpy(rng.uniform(
            1e-9, 1.0, (GATED_INJECT_BLOCKS, GatedLayout(NUM_BARS, nz is not None).u_rows,
                        8, GATED_LANES)).astype(np.float32))
        kw = dict(gcommon, num_paths=n_inj, noise=nz, antithetic=anti)
        want = cuda_gated.gated_totals_reference(0, levels, params, gate,
                                                 external_uniforms=u,
                                                 per_path=True, **kw)
        pc, pf, rows = cuda_gated.gated_rows(0, levels, params, gate, device=dev,
                                             external_uniforms=u.to(dev),
                                             per_path=True, **kw)
        got = (*cuda_gated.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        err, _ = compare_lifecycle(
            case, want, got, n_inj,
            trace=lambda d: trace_flips(case, u, d, rows.cpu(), want[2].cpu(), levels,
                                        params, gate, nz, anti, dev))
        gated_err = max(gated_err, err)

    # ---- phase 7: gated, Philox stream, and the row fold
    log(f"[7] gated, Philox: kernel vs plain at {PHILOX_PATHS} paths (plain on "
        "the card), the main path's inputs")
    gated_red_err = 0.0
    gate = GateConfig.from_params(params)
    for case, nz in (("philox", None), ("philox+noise", noise)):
        kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=nz, antithetic=False)
        want = cuda_gated.gated_totals_reference(
            0, cli_levels, params, gate, device=dev, chunk_blocks=64,
            per_path=True, work=True, **kw)
        pc, pf, rows = cuda_gated.gated_rows(0, cli_levels, params, gate,
                                             device=dev, external_uniforms=None,
                                             per_path=True, **kw)
        got = (*cuda_gated.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        gated_err = max(gated_err, compare_lifecycle(case, want, got, PHILOX_PATHS)[0])
        gated_red_err = max(gated_red_err, check_fold(
            "mc_gated_reduce_rows", cuda_gated.reduce_rows_reference(pc, pf), got[:2]))
        if nz is None:
            g_trades, g_held = float(want[0][5]), float(want[3])
    log(f"  mc_gated_reduce_rows: counts exact, float max abs err {gated_red_err:.3e}")
    log(f"  work per path (first {PHILOX_PATHS} paths): trades "
        f"{g_trades / PHILOX_PATHS:.4f}, bars held {g_held / PHILOX_PATHS:.4f} of {NUM_BARS}")

    kw = dict(gcommon, num_paths=PLAIN_PATHS, noise=None, antithetic=False,
              external_uniforms=None)

    def run_gated(n=PLAIN_PATHS):
        return cuda_gated.gated_rows(0, cli_levels, params, gate, device=dev,
                                     **dict(kw, num_paths=n))

    run_gated()
    g_ms = cuda_ms(run_gated, 3)
    g_rows = run_gated()
    g_plain_ms = cuda_ms(lambda: cuda_gated.gated_totals_reference(
        0, cli_levels, params, gate, device=dev, chunk_blocks=256, **kw), 1)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_rows), 20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_rows), 20)
    g_row_bytes = g_rows[0].numel() * 8 + g_rows[1].numel() * 4

    def g_bound(n):
        s = n / PHILOX_PATHS
        return card.bound(bytes_=g_row_bytes, **gated_ops(n, g_held * s, g_trades * s))

    g_bound_plain = g_bound(PLAIN_PATHS)
    g_red_bound = card.bound(bytes_=g_row_bytes + cuda_gated.ROW_COUNTS * 8
                             + cuda_gated.ROW_FLOATS * 8, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths: kernel {g_ms:.3f} ms "
        f"({PLAIN_PATHS / g_ms * 1e3:.6e} paths/s), bound {g_bound_plain['bound_ms']:.3f} ms "
        f"{g_bound_plain['bound_parts']}, plain {g_plain_ms:.3f} ms "
        f"({PLAIN_PATHS / g_plain_ms * 1e3:.6e} paths/s)")
    log(f"  row fold ({g_rows[0].shape[0]} rows): kernel {g_red_ms:.4f} ms, "
        f"plain {g_red_plain_ms:.4f} ms, bound {g_red_bound['bound_ms']:.4f} ms")

    # ---- phase 8: the gated main path through the CLI
    log(f"[8] main path: cli paths --gated --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--gated",
                "--backend", "cuda", "--num-paths", str(MAIN_PATHS),
                "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA)]
        (g_out,), g_secs, g_launches = run_cli(
            cli, argv, reset_all, {"mc_gated": 1, "mc_gated_reduce_rows": 1})
    check_paths_output(g_out)
    if not g_out["trades"] >= g_out["entered"] > 0:
        raise AssertionError(f"trades < entered: {g_out}")
    if not g_out["mean_trades"] >= 1.0 or not g_out["max_dd"] >= 0.0:
        raise AssertionError(f"mean_trades < 1 or max_dd < 0: {g_out}")
    g_main_ms = cuda_ms(lambda: run_gated(MAIN_PATHS), 3)
    g_main_bound = g_bound(MAIN_PATHS)
    log(f"  kernel alone at {MAIN_PATHS} paths: {g_main_ms:.3f} ms "
        f"({MAIN_PATHS / g_main_ms * 1e3:.6e} paths/s), bound "
        f"{g_main_bound['bound_ms']:.3f} ms {g_main_bound['bound_parts']}")

    # ---- phase 9: engine, injected uniforms
    ecommon = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, dt=DT, lanes=ENGINE_LANES)
    e_levels = Levels.from_rows(ENGINE_ROWS, max_levels=8)
    n_einj = ENGINE_INJECT_BLOCKS * 8 * ENGINE_LANES
    rng = np.random.default_rng(7)
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5
    armed = dict(policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_entry)),
                 ml_model=MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2],
                                                        np.float32), 0.55))
    w_pass = np.zeros((3, 7), np.float32)
    w_pass[0, 0], w_pass[0, 6] = -0.6, 20.0     # longs pass from bar ~20,
    w_pass[1, 0], w_pass[1, 6] = -0.2, 20.0     # shorts from bar ~12
    w_pass[2, 0] = -1.0
    passing = dict(armed, policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_pass)))
    accumulating = dict(
        guard_params=GuardParams.default().replace(min_bars=6, compression_bp=300.0),
        touch_params=TouchMemoryParams.default().replace(
            max_bounces=1, min_time_gap_ms=120_000, fatigue_vol_k=0.0))
    log(f"[9] engine, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_einj} paths")
    engine_err = 0.0
    blend = EngineParams.default(use_blend=True, w_rules=0.5, w_ml=0.7, q_min_prob=0.62)
    for case, sig, gates, nz, anti, e_params in (
            ("defaults", SIGMA, {}, None, False, params),
            ("accumulation", 0.05, accumulating, None, False, params),
            ("ml+policy", SIGMA, armed, None, False, params),
            ("ml+policy passing", SIGMA, passing, None, False, params),
            ("blend", SIGMA, passing, None, False, blend),
            ("noise", SIGMA, {}, noise, False, params),
            ("antithetic", SIGMA, {}, None, True, params)):
        rng = np.random.default_rng(200 + len(case))
        u = torch.from_numpy(rng.uniform(
            1e-6, 1.0, (ENGINE_INJECT_BLOCKS, EngineLayout(NUM_BARS, nz is not None).u_rows,
                        8, ENGINE_LANES)).astype(np.float32))
        kw = dict(ecommon, sigma=sig, num_paths=n_einj, noise=nz, antithetic=anti, **gates)
        # the plain version runs once, with the harvest (which changes no trade)
        want = cuda_engine.engine_totals_reference(0, e_levels, e_params,
                                                   external_uniforms=u, per_path=True,
                                                   harvest=True, **kw)
        pc, pf, rows = cuda_engine.engine_rows(0, e_levels, e_params, device=dev,
                                               external_uniforms=u.to(dev),
                                               per_path=True, **kw)
        got = (*cuda_engine.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        # every gate case (the bar-only gates, the policy's among them, are
        # the rows kernel's producers' work) against the parent, bit for bit
        same_as_parent(case, cuda_engine, lambda kw=kw, e_params=e_params, u=u: (
            cuda_engine.engine_rows(0, e_levels, e_params, device=dev,
                                    external_uniforms=u.to(dev), per_path=True, **kw)))
        err, _ = compare_lifecycle(
            case, want, got, n_einj, engine=True,
            trace=lambda d: trace_engine_flips(case, u, d, rows.cpu(), want[2].cpu(),
                                               e_levels, e_params, gates, sig, nz, anti, dev))
        engine_err = max(engine_err, err)
        *h_rows, h_c, h_s = cuda_engine.engine_rows(0, e_levels, e_params, device=dev,
                                                    external_uniforms=u.to(dev),
                                                    per_path=True, harvest=True, **kw)
        same_launch(case, (pc, pf, rows), h_rows)
        check_harvest(case, "mc_engine_wide_harvest", cuda_engine.reduce_harvest(h_c, h_s),
                      want[3], rows, want[2], 100.4)
        skips = dict(zip((r.name for r in SKIP_REASONS), got[0][7:23].tolist()))
        if case == "accumulation" and not (skips["EDGE_FATIGUE"] + skips["TOUCH_BUDGET"]
                                           + skips["TOUCH_COOLDOWN"]) > 0:
            raise AssertionError(f"accumulation case: no accumulation gate fired: {skips}")
        if case.startswith("ml+policy") and not (skips["ML_CONF_LOW"] > 0
                                                 or skips["ONLINE_POLICY"] > 0):
            raise AssertionError(f"{case} case: neither gate fired: {skips}")
        if case in ("ml+policy passing", "blend") and not int(got[0][5]) > 0:
            raise AssertionError(f"{case} case: no entry passed the gates")
        if case == "blend" and not skips["COMBINED_LOW"] > 0:
            raise AssertionError(f"blend case: the blended gate never fired: {skips}")

    # ---- phase 10: engine, Philox stream, and the row fold
    log(f"[10] engine, Philox: kernel vs plain at {PHILOX_PATHS} paths (plain on "
        "the card), the main path's inputs")
    engine_red_err = 0.0
    for case, nz in (("philox", None), ("philox+noise", noise)):
        kw = dict(ecommon, sigma=SIGMA, num_paths=PHILOX_PATHS, noise=nz, antithetic=False)
        t0 = time.perf_counter()
        want = cuda_engine.engine_totals_reference(
            0, cli_levels, params, device=dev, chunk_blocks=512, per_path=True, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        pc, pf, rows = cuda_engine.engine_rows(0, cli_levels, params, device=dev,
                                               per_path=True, **kw)
        got = (*cuda_engine.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        engine_err = max(engine_err, compare_lifecycle(case, want, got, PHILOX_PATHS, engine=True)[0])
        engine_red_err = max(engine_red_err, check_fold(
            "mc_engine_reduce_rows", cuda_engine.reduce_rows_reference(pc, pf), got[:2]))
        same_as_parent(case, cuda_engine, lambda kw=kw: cuda_engine.engine_rows(
            0, cli_levels, params, device=dev, per_path=True, **kw))
        if nz is None:
            e_counts, e_plain_ms = want[0].cpu(), plain_s * 1e3
    log(f"  mc_engine_reduce_rows: counts exact, float max abs err {engine_red_err:.3e}")
    log(f"  plain version at {PHILOX_PATHS} paths (no noise, plain on the card): "
        f"{e_plain_ms:.3f} ms")
    log(f"  work per path (first {PHILOX_PATHS} paths): trades "
        f"{float(e_counts[5]) / PHILOX_PATHS:.4f}, escalations "
        f"{float(e_counts[6]) / PHILOX_PATHS:.4f}, skips per path "
        f"{[round(float(x) / PHILOX_PATHS, 4) for x in e_counts[7:23]]}")

    kw = dict(ecommon, sigma=SIGMA, noise=None, antithetic=False, external_uniforms=None)

    def run_engine(n=PHILOX_PATHS):
        return cuda_engine.engine_rows(0, cli_levels, params, device=dev,
                                       **dict(kw, num_paths=n))

    run_engine()
    e_ms = cuda_ms(run_engine, 3)
    e_parent_ms = cuda_ms(parent_run(cuda_engine, run_engine), 3)
    e_rows = run_engine()
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_rows), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_rows), 20)
    e_row_bytes = e_rows[0].numel() * 8 + e_rows[1].numel() * 4

    def e_bound(n):
        return card.bound(bytes_=e_row_bytes, **engine_ops(n, e_counts, n / PHILOX_PATHS))

    e_bound_philox = e_bound(PHILOX_PATHS)
    e_red_bound = card.bound(bytes_=e_row_bytes + cuda_engine.ROW_COUNTS * 8
                             + cuda_engine.ROW_FLOATS * 8, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PHILOX_PATHS} paths: kernel {e_ms:.3f} ms "
        f"({PHILOX_PATHS / e_ms * 1e3:.6e} paths/s), bound {e_bound_philox['bound_ms']:.3f} ms "
        f"{e_bound_philox['bound_parts']}, plain {e_plain_ms:.3f} ms, the parent "
        f"{e_parent_ms:.3f} ms")
    log(f"  row fold ({e_rows[0].shape[0]} rows): kernel {e_red_ms:.4f} ms, "
        f"plain {e_red_plain_ms:.4f} ms, bound {e_red_bound['bound_ms']:.4f} ms")

    # ---- phase 11: the engine main path through the CLI
    log(f"[11] main path: cli paths --engine --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--engine",
                "--backend", "cuda", "--num-paths", str(MAIN_PATHS),
                "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA)]
        (e_out,), e_secs, e_launches = run_cli(
            cli, argv, reset_all, {"mc_engine_rows": 1, "mc_engine_reduce_rows": 1})
    check_paths_output(e_out)
    if not e_out["trades"] >= e_out["entered"] > 0 or not e_out["escalations"] > 0:
        raise AssertionError(f"trades < entered, or no escalation: {e_out}")
    sk = e_out["skips"]
    if not (sk.get("TOO_FAR", 0) > 0 and sk.get("CONF_LOW", 0) > 0
            and sk.get("CONTRA_VOL_LONG", 0) + sk.get("CONTRA_VOL_SHORT", 0) > 0):
        raise AssertionError(f"skips lack TOO_FAR, CONF_LOW or a CONTRA_VOL entry: {sk}")
    e_main_ms = cuda_ms(lambda: run_engine(MAIN_PATHS), 2)
    e_main_parent_ms = cuda_ms(parent_run(cuda_engine, lambda: run_engine(MAIN_PATHS)), 1)
    e_main_bound = e_bound(MAIN_PATHS)
    log(f"  kernel alone at {MAIN_PATHS} paths: {e_main_ms:.3f} ms "
        f"({MAIN_PATHS / e_main_ms * 1e3:.6e} paths/s), bound "
        f"{e_main_bound['bound_ms']:.3f} ms {e_main_bound['bound_parts']}; the parent "
        f"{e_main_parent_ms:.3f} ms")

    # ---- phase 12: first-contact sweep (kernel #3)
    stops5, tps5 = [c[0] for c in CONFIG5], [c[1] for c in CONFIG5]
    # the CLI sweep's default 3 x 3 grid, the main path's rows (config #5's
    # three rows among them)
    grid9 = [(sp, tp) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)]
    stops9, tps9 = [c[0] for c in grid9], [c[1] for c in grid9]
    n_sinj = 16 * LANES
    log(f"[12] first-contact sweep, injected uniforms: kernel vs plain (plain on CPU "
        f"copies), {n_sinj} paths, the CLI's 3 x 3 grid {grid9}")
    rng = np.random.default_rng(300)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (16, 3 * NUM_BARS + 1, LANES)).astype(np.float32))
    kw = dict(common, num_paths=n_sinj)
    want = cuda_mc.sweep_totals_reference(0, levels, params, stops9, tps9,
                                          external_uniforms=u, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(
        0, levels, params, stops9, tps9, device=dev, external_uniforms=u.to(dev), **kw))
    torch.cuda.synchronize()
    sw_err = 0.0
    for g, (sp, tp) in enumerate(grid9):
        sw_err = max(sw_err, compare(f"row {g} ({sp}, {tp})", (want[0][g], want[1][g]),
                                     (got[0][g], got[1][g]), n_sinj))
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs and 9 rows: each row "
        "vs the single configuration's launch (first_contact_rows) bit for bit, vs the plain "
        "version on the card")
    kw = dict(common, num_paths=PHILOX_PATHS, external_uniforms=None)
    sw_rows = cuda_mc.sweep_rows(0, cli_levels, params, stops9, tps9, device=dev, **kw)
    got = cuda_mc.reduce_rows(*sw_rows)
    want = cuda_mc.sweep_totals_reference(0, cli_levels, params, stops9, tps9,
                                          device=dev, **kw)
    for g, (sp, tp) in enumerate(grid9):
        one_rows = cuda_mc.first_contact_rows(
            0, cli_levels, params.replace(stop_padding=sp, tp_padding=tp), device=dev,
            noise=None, antithetic=False, **kw)
        one = cuda_mc.reduce_rows(*one_rows)
        if not (torch.equal(one_rows[0], sw_rows[0][g]) and torch.equal(one_rows[1], sw_rows[1][g])
                and torch.equal(one[0], got[0][g]) and torch.equal(one[1], got[1][g])):
            raise AssertionError(f"sweep row {g} differs from the single configuration")
        sw_err = max(sw_err, compare(f"philox row {g}", (want[0][g], want[1][g]),
                                     (got[0][g], got[1][g]), PHILOX_PATHS))
    log("  every row equals the single configuration bit for bit (partial rows and totals)")
    sw_red_err = check_fold("mc_sweep_reduce_rows", cuda_mc.reduce_rows_reference(*sw_rows), got)
    log(f"  mc_sweep_reduce_rows: counts exact, float max abs err {sw_red_err:.3e}")

    kw = dict(common, num_paths=PLAIN_PATHS, external_uniforms=None)

    def run_sw(n=PLAIN_PATHS, rows=CONFIG5):
        return cuda_mc.sweep_rows(0, cli_levels, params, [r[0] for r in rows],
                                  [r[1] for r in rows], device=dev, **dict(kw, num_paths=n))

    run_sw()
    sw_ms = cuda_ms(run_sw, 3)
    sw_rows = run_sw()
    sw_plain_ms = cuda_ms(lambda: cuda_mc.sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, device=dev, **kw), 1)
    sw_red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*sw_rows), 20)
    sw_red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*sw_rows), 20)
    sc, _, swork = cuda_mc.sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, device=dev, work=True,
        **dict(kw, num_paths=PHILOX_PATHS))
    sw_row_bytes = sw_rows[0].numel() * 8 + sw_rows[1].numel() * 4

    def sw_bound(n):
        return card.bound(bytes_=sw_row_bytes, **sweep_ops(swork.cpu(), int(sc[0, 1]), 3,
                                                            n / PHILOX_PATHS))

    sw_bound_plain = sw_bound(PLAIN_PATHS)
    sw_red_bound = card.bound(bytes_=sw_row_bytes + 3 * (cuda_mc.ROW_COUNTS * 8
                                                         + cuda_mc.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths x 3 rows: kernel {sw_ms:.3f} ms "
        f"({PLAIN_PATHS / sw_ms * 1e3:.6e} paths/s), bound {sw_bound_plain['bound_ms']:.3f} ms "
        f"{sw_bound_plain['bound_parts']}, plain {sw_plain_ms:.3f} ms")
    log(f"  work per path (first {PHILOX_PATHS} paths): pairs, walked, after contact, "
        f"rows x bars after contact, Philox calls "
        f"{[round(float(x) / PHILOX_PATHS, 4) for x in swork.cpu()]}")
    log(f"  row fold (3 x {sw_rows[0].shape[1]} rows): kernel {sw_red_ms:.4f} ms, plain "
        f"{sw_red_plain_ms:.4f} ms, bound {sw_red_bound['bound_ms']:.4f} ms")
    c5_ms = cuda_ms(lambda: run_sw(CONFIG5_PATHS), 2)
    c5_bound = sw_bound(CONFIG5_PATHS)
    log(f"  BASELINE config #5 at full size ({CONFIG5_PATHS} paths x {NUM_BARS} bars x 3 "
        f"rows), kernel alone: {c5_ms:.3f} ms ({CONFIG5_PATHS / c5_ms * 1e3:.6e} paths/s), "
        f"bound {c5_bound['bound_ms']:.3f} ms {c5_bound['bound_parts']}")
    log(f"[12] main path: cli sweep --backend cuda --num-paths {MAIN_PATHS} (3 x 3 grid)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--backend", "cuda",
                "--num-paths", str(MAIN_PATHS), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA)]
        sw_out, sw_secs, sw_launches = run_cli(
            cli, argv, reset_all, {"mc_sweep": 1, "mc_sweep_reduce_rows": 1})
    check_sweep_output(sw_out, grid9, ["stop_padding", "tp_padding", "hit_rate", "mean_r"])
    sw_main_ms = cuda_ms(lambda: run_sw(MAIN_PATHS, grid9), 2)
    s9c, _, s9work = cuda_mc.sweep_totals_reference(
        0, cli_levels, params, stops9, tps9, device=dev, work=True,
        **dict(kw, num_paths=SWEEP_WORK_PATHS))
    sw_main_bound = card.bound(bytes_=len(grid9) * grid_size(MAIN_PATHS) * (
        cuda_mc.ROW_COUNTS * 8 + cuda_mc.ROW_FLOATS * 4), **sweep_ops(
        s9work.cpu(), int(s9c[0, 1]), len(grid9), MAIN_PATHS / SWEEP_WORK_PATHS))
    log(f"  kernel alone on the CLI's grid ({MAIN_PATHS} paths x 9 rows): {sw_main_ms:.3f} ms, "
        f"bound {sw_main_bound['bound_ms']:.3f} ms {sw_main_bound['bound_parts']} (work of "
        f"the first {SWEEP_WORK_PATHS} paths)")

    # ---- phase 13: gated sweep (kernel #6)
    g_stops, g_tps = [0.35, 0.35, 0.25], [0.25, 0.25, 0.15]
    g_gate = GateConfig.from_params(params).replace(touch_limit=[4, 4, 2],
                                                    cooldown_bars=[0, 0, 3])
    g_noise = McNoise(entry_slip_std=torch.tensor([0.0, 0.01, 0.0]),
                      level_jitter_std=torch.tensor([0.0, 0.02, 0.0]),
                      stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                      target_slip_std=torch.tensor([0.0, 0.015, 0.0]))
    n_ginj = SWEEP_INJECT_BLOCKS * 8 * GATED_LANES
    log(f"[13] gated sweep, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_ginj} paths x 3 rows (defaults; a noise-std row; touch limit 2 with "
        "cooldown 3)")
    rng = np.random.default_rng(400)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (SWEEP_INJECT_BLOCKS, GatedLayout(NUM_BARS, True).u_rows, 8,
                    GATED_LANES)).astype(np.float32))
    kw = dict(gcommon, num_paths=n_ginj, noise=g_noise)
    want = cuda_gated.gated_sweep_totals_reference(0, levels, params, g_stops, g_tps, g_gate,
                                                   external_uniforms=u, per_path=True, **kw)
    pc, pf, rows = cuda_gated.gated_sweep_rows(0, levels, params, g_stops, g_tps, g_gate,
                                               device=dev, external_uniforms=u.to(dev),
                                               per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    gs_err = 0.0
    for g in range(3):
        err, _ = compare_lifecycle(
            f"row {g}", (want[0][g], want[1][g], want[2][g]), (gc[g], gf[g], rows[g]), n_ginj,
            trace=lambda d: trace_flips(
                f"row {g}", u, d, rows[g].cpu(), want[2][g].cpu(), levels,
                params.replace(stop_padding=g_stops[g], tp_padding=g_tps[g]),
                grid_row(g_gate, g), grid_row(g_noise, g), False, dev))
        gs_err = max(gs_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs: each row vs the "
        "one-row launch (gated_rows) bit for bit, vs the plain version on the card path "
        "by path")
    ps_gate = GateConfig.from_params(params).replace(touch_limit=[2, 4, 4],
                                                     cooldown_bars=[0, 0, 3])
    kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=None)
    t0 = time.perf_counter()
    want = cuda_gated.gated_sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, ps_gate, device=dev, chunk_blocks=64,
        per_path=True, work=True, **kw)
    torch.cuda.synchronize()
    gs_plain_ms = (time.perf_counter() - t0) * 1e3
    gs_rows = cuda_gated.gated_sweep_rows(0, cli_levels, params, stops5, tps5, ps_gate,
                                          device=dev, external_uniforms=None,
                                          per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(*gs_rows[:2])
    for g in range(3):
        one = cuda_gated.gated_rows(0, cli_levels, params.replace(
            stop_padding=stops5[g], tp_padding=tps5[g]), grid_row(ps_gate, g), device=dev,
            external_uniforms=None, antithetic=False, per_path=True, **kw)
        if not all(torch.equal(a, b[g]) for a, b in zip(one, gs_rows)):
            raise AssertionError(f"gated sweep row {g} differs from the one-row launch")
        err, differ = compare_lifecycle(f"philox row {g}", (want[0][g], want[1][g], want[2][g]),
                                        (gc[g], gf[g], gs_rows[2][g]), PHILOX_PATHS)
        gs_err = max(gs_err, err)
        if bool(differ.any()):
            raise AssertionError(f"philox row {g}: the kernel and the plain version on "
                                 "the card differ")
    log("  every row equals the one-row launch bit for bit (partial rows, per-path rows); "
        "the plain version on the card equals the kernel on every path")
    gs_red_err = check_fold("mc_gated_sweep_reduce_rows",
                            cuda_gated.reduce_rows_reference(*gs_rows[:2]), (gc, gf))
    log(f"  mc_gated_sweep_reduce_rows: counts exact, float max abs err {gs_red_err:.3e}")
    # repair: the lifecycle histogram's scalar division on the card
    eq, tr = gs_rows[2][0][:, 0], gs_rows[2][0][:, 1]
    stats_on = {}
    for where in (dev, torch.device("cpu")):
        e, t = eq.to(where), tr.to(where)
        z = torch.zeros_like(e)
        stats_on[where.type] = (
            PathStats.from_lifecycle(equity=e, trades=t, wins=t, losses=z,
                                     open_at_end=z.bool(), max_dd=z).hist.cpu(),
            PathStats.from_outcomes(e, torch.ones_like(t, dtype=torch.int32),
                                    t > 0).hist.cpu())
    if not all(torch.equal(a, b) for a, b in zip(stats_on["cuda"], stats_on["cpu"])):
        raise AssertionError("from_lifecycle / from_outcomes bins differ between the card "
                             "and the CPU")
    lo, span = LIFE_HIST_LO, LIFE_HIST_HI - LIFE_HIST_LO
    moved = int((((eq - lo) / span * 128).int() != ((eq.cpu() - lo) / span * 128).int()
                 .to(dev)).sum())
    log(f"  from_lifecycle / from_outcomes bins of {eq.numel()} equities: card == CPU; "
        f"a division by the CPU scalar on the card would move {moved} of them")

    kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=None, external_uniforms=None)

    def run_gs(n=PHILOX_PATHS, stops=stops5, tps=tps5, gate=ps_gate):
        return cuda_gated.gated_sweep_rows(0, cli_levels, params, stops, tps, gate,
                                           device=dev, **dict(kw, num_paths=n))

    run_gs()
    gs_ms = cuda_ms(run_gs, 3)
    g_sw_rows = run_gs()
    gs_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_sw_rows), 20)
    gs_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_sw_rows), 20)
    gs_row_bytes = g_sw_rows[0].numel() * 8 + g_sw_rows[1].numel() * 4
    gs_held, gs_trades = [float(x) for x in want[3]], [float(x) for x in want[0][:, 5]]
    gs_bound = card.bound(bytes_=gs_row_bytes,
                          **gated_sweep_ops(PHILOX_PATHS, gs_held, gs_trades))
    gs_red_bound = card.bound(bytes_=gs_row_bytes + 3 * (cuda_gated.ROW_COUNTS * 8
                                                         + cuda_gated.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PHILOX_PATHS} paths x 3 rows: kernel {gs_ms:.3f} ms, bound "
        f"{gs_bound['bound_ms']:.3f} ms {gs_bound['bound_parts']}, plain {gs_plain_ms:.3f} ms")
    log(f"  work per path and row: trades {[round(x / PHILOX_PATHS, 4) for x in gs_trades]}, "
        f"bars held {[round(x / PHILOX_PATHS, 4) for x in gs_held]}")
    log(f"  row fold (3 x {g_sw_rows[0].shape[1]} rows): kernel {gs_red_ms:.4f} ms, plain "
        f"{gs_red_plain_ms:.4f} ms, bound {gs_red_bound['bound_ms']:.4f} ms")
    gs_cli_paths = 1 << 26
    log(f"[13] main path: cli sweep --gated --backend cuda --num-paths {gs_cli_paths} "
        "--touch-limits 2 4 (18 rows)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--gated", "--backend",
                "cuda", "--num-paths", str(gs_cli_paths), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA), "--touch-limits", "2", "4"]
        gs_out, gs_secs, gs_launches = run_cli(
            cli, argv, reset_all, {"mc_gated_sweep": 1, "mc_gated_sweep_reduce_rows": 1},
            n_paths=gs_cli_paths)
    check_sweep_output(gs_out, [(sp, tp, tl) for sp, tp in grid9 for tl in (2, 4)],
                       ["stop_padding", "tp_padding", "hit_rate", "mean_r", "touch_limit",
                        "mean_trades", "mean_dd"])
    gate18 = GateConfig.from_params(params).replace(touch_limit=[tl for _ in grid9
                                                                 for tl in (2, 4)])
    stops18, tps18 = [r[0] for r in grid9 for _ in (2, 4)], [r[1] for r in grid9 for _ in (2, 4)]
    gs_main_ms = cuda_ms(lambda: run_gs(gs_cli_paths, stops18, tps18, gate18), 1)
    w18 = cuda_gated.gated_sweep_totals_reference(
        0, cli_levels, params, stops18, tps18, gate18, device=dev, chunk_blocks=32, work=True,
        **dict(kw, num_paths=SWEEP_WORK_PATHS))
    sc18 = gs_cli_paths / SWEEP_WORK_PATHS
    gs_main_bound = card.bound(
        bytes_=18 * grid_size(gs_cli_paths) * (cuda_gated.ROW_COUNTS * 8
                                               + cuda_gated.ROW_FLOATS * 4),
        **gated_sweep_ops(gs_cli_paths, [float(x) * sc18 for x in w18[-1]],
                          [float(x) * sc18 for x in w18[0][:, 5]]))
    log(f"  kernel alone on the CLI's grid ({gs_cli_paths} paths x 18 rows): "
        f"{gs_main_ms:.3f} ms, bound {gs_main_bound['bound_ms']:.3f} ms "
        f"{gs_main_bound['bound_parts']} (work of the first {SWEEP_WORK_PATHS} paths)")

    # ---- phase 14: engine sweep (kernel #9)
    e_cfgs = [EngineParams.default(),
              EngineParams.default(stop_padding=0.20, tp_padding=0.40),
              EngineParams.default(q_min_prob=0.40, enable_veto=False),
              EngineParams.default(overtouch_limit=2, cooldown_s=180.0)]
    e_grid = stack_params(e_cfgs)
    n_einj = SWEEP_INJECT_BLOCKS * 8 * ENGINE_LANES
    log(f"[14] engine sweep, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_einj} paths x the 4 configurations of tests/test_pallas_engine.py:320-325")
    rng = np.random.default_rng(500)
    u = torch.from_numpy(rng.uniform(
        1e-6, 1.0, (SWEEP_INJECT_BLOCKS, EngineLayout(NUM_BARS).u_rows, 8,
                    ENGINE_LANES)).astype(np.float32))
    kw = dict(ecommon, sigma=SIGMA, num_paths=n_einj)
    want = cuda_engine.engine_sweep_totals_reference(0, e_levels, e_grid, external_uniforms=u,
                                                     per_path=True, **kw)
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, e_levels, e_grid, device=dev,
                                                 external_uniforms=u.to(dev),
                                                 per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    es_err = 0.0
    for g in range(4):
        err, _ = compare_lifecycle(
            f"row {g}", (want[0][g], want[1][g], want[2][g]), (ec[g], ef[g], rows[g]), n_einj,
            engine=True,
            trace=lambda d: trace_engine_flips(f"row {g}", u, d, rows[g].cpu(),
                                               want[2][g].cpu(), e_levels, e_cfgs[g], {}, SIGMA,
                                               None, False, dev))
        es_err = max(es_err, err)
    # [G] noise stds: the main path's rows (`--jitter-stds 0 0.02`) and a slip row
    e_noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.02]),
                      entry_slip_std=torch.tensor([0.0, 0.0, 0.01]),
                      stop_slip_std=torch.tensor([0.0, 0.0, 0.015]),
                      target_slip_std=torch.tensor([0.0, 0.0, 0.015]))
    log(f"  injected uniforms with [G] noise stds, {n_einj} paths x 3 rows (level "
        "jitter 0 and 0.02, as `--jitter-stds 0 0.02`; jitter 0.02 with slips)")
    u = torch.from_numpy(rng.uniform(
        1e-6, 1.0, (SWEEP_INJECT_BLOCKS, EngineLayout(NUM_BARS, True).u_rows, 8,
                    ENGINE_LANES)).astype(np.float32))
    kw = dict(ecommon, sigma=SIGMA, num_paths=n_einj, n_grid=3, noise=e_noise)
    want = cuda_engine.engine_sweep_totals_reference(0, e_levels, params, external_uniforms=u,
                                                     per_path=True, **kw)
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, e_levels, params, device=dev,
                                                 external_uniforms=u.to(dev),
                                                 per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    for g in range(3):
        err, _ = compare_lifecycle(
            f"noise row {g}", (want[0][g], want[1][g], want[2][g]), (ec[g], ef[g], rows[g]),
            n_einj, engine=True,
            trace=lambda d: trace_engine_flips(f"noise row {g}", u, d, rows[g].cpu(),
                                               want[2][g].cpu(), e_levels, params, {}, SIGMA,
                                               grid_row(e_noise, g), False, dev))
        es_err = max(es_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs: each row vs the "
        "one-row launch (engine_rows) bit for bit (the four configurations, then the "
        "three noise rows)")
    kw = dict(ecommon, sigma=SIGMA, external_uniforms=None)
    for grid, n_grid, nz, singles in (
            (e_grid, None, None, [(c, None) for c in e_cfgs]),
            (params, 3, e_noise, [(params, grid_row(e_noise, g)) for g in range(3)])):
        es_rows = cuda_engine.engine_sweep_rows(0, cli_levels, grid, n_grid=n_grid, noise=nz,
                                                device=dev, per_path=True,
                                                **dict(kw, num_paths=PHILOX_PATHS))
        for g, (p_g, nz_g) in enumerate(singles):
            one = cuda_engine.engine_rows(0, cli_levels, p_g, noise=nz_g, device=dev,
                                          per_path=True, **dict(kw, num_paths=PHILOX_PATHS))
            if not all(torch.equal(a, b[g]) for a, b in zip(one, es_rows)):
                raise AssertionError(f"engine sweep row {g} (noise {nz_g}) differs from "
                                     "the one-row launch")
    log("  every row equals the one-row launch bit for bit (partial rows, per-path rows "
        "with their skip counts)")
    es_paths = 1 << 20
    log(f"  kernel vs plain, both on the card, path by path at {es_paths} paths x 4 rows, "
        "then x the 3 noise rows")
    t0 = time.perf_counter()
    want = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, e_grid, device=dev, chunk_blocks=512, per_path=True,
        **dict(kw, num_paths=es_paths))
    torch.cuda.synchronize()
    es_plain_ms = (time.perf_counter() - t0) * 1e3
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, cli_levels, e_grid, device=dev,
                                                 per_path=True, **dict(kw, num_paths=es_paths))
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    nkw = dict(kw, num_paths=es_paths, n_grid=3, noise=e_noise)
    n_want = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, params, device=dev, chunk_blocks=512, per_path=True, **nkw)
    n_pc, n_pf, n_rows = cuda_engine.engine_sweep_rows(0, cli_levels, params, device=dev,
                                                       per_path=True, **nkw)
    n_ec, n_ef = cuda_engine.reduce_rows(n_pc, n_pf)
    for name, w, got in (("card row", want, (ec, ef, rows)),
                         ("card noise row", n_want, (n_ec, n_ef, n_rows))):
        for g in range(w[0].shape[0]):
            err, differ = compare_lifecycle(f"{name} {g}", (w[0][g], w[1][g], w[2][g]),
                                            (got[0][g], got[1][g], got[2][g]), es_paths,
                                            engine=True)
            es_err = max(es_err, err)
            if bool(differ.any()):
                raise AssertionError(f"{name} {g}: the kernel and the plain version on the "
                                     "card differ")
    es_red_err = check_fold("mc_engine_sweep_reduce_rows",
                            cuda_engine.reduce_rows_reference(pc, pf), (ec, ef))
    log(f"  mc_engine_sweep_reduce_rows: counts exact, float max abs err {es_red_err:.3e}")
    es_counts = want[0].cpu()

    def run_es(n=es_paths, grid=e_grid, noise=None):
        return cuda_engine.engine_sweep_rows(0, cli_levels, grid, device=dev, noise=noise,
                                             **dict(kw, num_paths=n))

    run_es()
    es_ms = cuda_ms(run_es, 3)
    e_sw_rows = run_es()
    es_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_sw_rows), 20)
    es_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_sw_rows), 20)
    es_row_bytes = e_sw_rows[0].numel() * 8 + e_sw_rows[1].numel() * 4
    es_bound = card.bound(bytes_=es_row_bytes, **engine_sweep_ops(es_paths, es_counts, 1.0))
    es_red_bound = card.bound(bytes_=es_row_bytes + 4 * (cuda_engine.ROW_COUNTS * 8
                                                         + cuda_engine.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {es_paths} paths x 4 rows: kernel {es_ms:.3f} ms, bound "
        f"{es_bound['bound_ms']:.3f} ms {es_bound['bound_parts']}, plain {es_plain_ms:.3f} ms")
    log(f"  row fold (4 x {e_sw_rows[0].shape[1]} rows): kernel {es_red_ms:.4f} ms, plain "
        f"{es_red_plain_ms:.4f} ms, bound {es_red_bound['bound_ms']:.4f} ms")
    es_cli_paths = 1 << 24
    log(f"[14] main path: cli sweep --engine --backend cuda --num-paths {es_cli_paths} "
        "--jitter-stds 0 0.02 (18 rows)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--engine", "--backend",
                "cuda", "--num-paths", str(es_cli_paths), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA), "--jitter-stds", "0", "0.02"]
        es_out, es_secs, es_launches = run_cli(
            cli, argv, reset_all, {"mc_engine_bar_sweep": 1,
                                   "mc_engine_sweep_reduce_rows": 1},
            n_paths=es_cli_paths)
    check_sweep_output(es_out, [(sp, tp, j) for sp, tp in grid9 for j in (0.0, 0.02)],
                       ["stop_padding", "tp_padding", "hit_rate", "mean_r", "mean_trades",
                        "mean_dd", "escalations", "level_jitter_std"])
    if not all(o["escalations"] > 0 for o in es_out):
        raise AssertionError("a row of the engine sweep took no escalation")
    jit18 = torch.tensor([j for _ in grid9 for j in (0.0, 0.02)])
    grid18_e = params.replace(stop_padding=[r[0] for r in grid9 for _ in (0, 1)],
                              tp_padding=[r[1] for r in grid9 for _ in (0, 1)])
    noise18 = McNoise(level_jitter_std=jit18, entry_slip_std=torch.zeros(18),
                      stop_slip_std=torch.zeros(18), target_slip_std=torch.zeros(18))
    es_cli_ms = cuda_ms(lambda: run_es(es_cli_paths, grid18_e, noise18), 1)
    es18_counts = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, grid18_e, noise=noise18, device=dev, chunk_blocks=128,
        **dict(kw, num_paths=ENGINE_SWEEP_WORK_PATHS))[0].cpu()
    es_cli_bound = card.bound(
        bytes_=18 * grid_size(es_cli_paths) * (cuda_engine.ROW_COUNTS * 8
                                               + cuda_engine.ROW_FLOATS * 4),
        **engine_sweep_ops(es_cli_paths, es18_counts, es_cli_paths / ENGINE_SWEEP_WORK_PATHS))
    log(f"  kernel alone on the CLI's grid ({es_cli_paths} paths x 18 rows, with noise): "
        f"{es_cli_ms:.3f} ms, bound {es_cli_bound['bound_ms']:.3f} ms "
        f"{es_cli_bound['bound_parts']} (work of the first {ENGINE_SWEEP_WORK_PATHS} paths)")
    grid9_e = params.replace(stop_padding=[r[0] for r in grid9], tp_padding=[r[1] for r in grid9])
    es9_counts = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, grid9_e, device=dev, chunk_blocks=512,
        **dict(kw, num_paths=1 << 18))[0].cpu()
    es_big = 1 << 26
    es_main_ms = cuda_ms(lambda: run_es(es_big, grid9_e), 1)
    es_main_bound = card.bound(bytes_=es_row_bytes,
                               **engine_sweep_ops(es_big, es9_counts, es_big / (1 << 18)))
    log(f"  kernel alone at {es_big} paths x 9 rows: {es_main_ms:.3f} ms "
        f"({es_big * 9 / es_main_ms * 1e3:.6e} paths x rows/s), bound "
        f"{es_main_bound['bound_ms']:.3f} ms {es_main_bound['bound_parts']}")

    universe = universe_phases(dev, card, reset_all)
    books = book_phases(dev, card, reset_all, cli)
    samplers = sampler_phases(dev, card, reset_all, cli)
    sampler_rows = sampler_rows_phases(dev, card, reset_all, cli)
    book_samplers = book_sampler_phases(dev, card, reset_all, cli)
    envelope = envelope_phases(dev, card, reset_all, cli)
    harvest = harvest_phases(dev, card, reset_all, cli, e_counts)
    long_horizon = long_phases(dev, card, reset_all, cli)
    log(f"all phases done: {time.perf_counter() - _T0:.1f} s since the start")

    print(json.dumps({"kernels": [
        entry("mc_first_contact", FC_SOURCE, FC_REPLACES,
              fc_launches["mc_first_contact"], fc_err, fc_ms, plain_ms, fc_bound,
              paths=PLAIN_PATHS, main_path_ms=fc_main_ms,
              main_path_bound_ms=fc_main_bound["bound_ms"],
              cli_s=fc_secs[1:]),
        entry("mc_reduce_rows", FC_SOURCE, FC_REPLACES,
              fc_launches["mc_reduce_rows"], reduce_err, red_ms, red_plain_ms,
              red_bound, rows=int(fc_rows[0].shape[0])),
        entry("mc_gated", GATED_SOURCE, GATED_REPLACES, g_launches["mc_gated"],
              gated_err, g_ms, g_plain_ms, g_bound_plain, paths=PLAIN_PATHS,
              main_path_ms=g_main_ms, main_path_bound_ms=g_main_bound["bound_ms"],
              cli_s=g_secs[1:]),
        entry("mc_gated_reduce_rows", GATED_SOURCE, GATED_REPLACES,
              g_launches["mc_gated_reduce_rows"], gated_red_err, g_red_ms,
              g_red_plain_ms, g_red_bound, rows=int(g_rows[0].shape[0])),
        entry("mc_engine_rows", ENGINE_ROWS_SOURCE, ENGINE_REPLACES,
              e_launches["mc_engine_rows"], engine_err, e_ms, e_plain_ms, e_bound_philox,
              paths=PHILOX_PATHS, parent_ms=e_parent_ms, main_path_ms=e_main_ms,
              main_path_parent_ms=e_main_parent_ms,
              main_path_bound_ms=e_main_bound["bound_ms"], cli_s=e_secs[1:]),
        entry("mc_engine_reduce_rows", ENGINE_SOURCE, ENGINE_REPLACES,
              e_launches["mc_engine_reduce_rows"], engine_red_err, e_red_ms,
              e_red_plain_ms, e_red_bound, rows=int(e_rows[0].shape[0])),
        entry("mc_sweep", FC_SWEEP_SOURCE, SWEEP_REPLACES, sw_launches["mc_sweep"], sw_err,
              sw_ms, sw_plain_ms, sw_bound_plain, paths=PLAIN_PATHS, grid_rows=3,
              config5_ms=c5_ms, config5_bound_ms=c5_bound["bound_ms"],
              cli_kernel_ms=sw_main_ms, cli_kernel_bound_ms=sw_main_bound["bound_ms"],
              cli_s=sw_secs[1:]),
        entry("mc_sweep_reduce_rows", FC_SOURCE, SWEEP_REPLACES,
              sw_launches["mc_sweep_reduce_rows"], sw_red_err, sw_red_ms, sw_red_plain_ms,
              sw_red_bound, rows=int(sw_rows[0].shape[1]), grid_rows=3),
        entry("mc_gated_sweep", GATED_SWEEP_SOURCE, GATED_SWEEP_REPLACES,
              gs_launches["mc_gated_sweep"], gs_err, gs_ms, gs_plain_ms, gs_bound,
              paths=PHILOX_PATHS, grid_rows=3, cli_kernel_ms=gs_main_ms,
              cli_kernel_bound_ms=gs_main_bound["bound_ms"], cli_s=gs_secs[1:]),
        entry("mc_gated_sweep_reduce_rows", GATED_SOURCE, GATED_SWEEP_REPLACES,
              gs_launches["mc_gated_sweep_reduce_rows"], gs_red_err, gs_red_ms,
              gs_red_plain_ms, gs_red_bound, rows=int(g_sw_rows[0].shape[1]), grid_rows=3),
        entry("mc_engine_bar_sweep", BAR_SWEEP_SOURCE, ENGINE_SWEEP_REPLACES,
              es_launches["mc_engine_bar_sweep"], es_err, es_ms, es_plain_ms, es_bound,
              paths=es_paths, grid_rows=4, main_path_ms=es_main_ms,
              main_path_bound_ms=es_main_bound["bound_ms"], cli_kernel_ms=es_cli_ms,
              cli_kernel_bound_ms=es_cli_bound["bound_ms"], cli_s=es_secs[1:]),
        entry("mc_engine_sweep_reduce_rows", ENGINE_SOURCE, ENGINE_SWEEP_REPLACES,
              es_launches["mc_engine_sweep_reduce_rows"], es_red_err, es_red_ms,
              es_red_plain_ms, es_red_bound, rows=int(e_sw_rows[0].shape[1]), grid_rows=4),
    ] + universe + books + samplers + sampler_rows + book_samplers + envelope + harvest
        + long_horizon}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--single-sampler-times"]:
            code = single_sampler_times(sys.argv[2] if len(sys.argv) > 2
                                        else os.path.dirname(os.path.abspath(__file__)))
        elif sys.argv[1:2] == ["--parent-times"]:
            code = parent_times()
        elif sys.argv[1:2] == ["--sampler-sweep-times"]:
            code = sampler_sweep_times(sys.argv[2] if len(sys.argv) > 2
                                       else os.path.dirname(os.path.abspath(__file__)))
        elif sys.argv[1:2] == ["--sweep-times"]:
            args = sys.argv[2:]
            rest = [a for a in args if not a.startswith("--")]
            code = sweep_times(rest[0] if rest else os.path.dirname(os.path.abspath(__file__)),
                               engine_only="--engine" in args,
                               redesign_only="--redesign" in args)
        elif sys.argv[1:2] == ["--fc-rows-digests"]:
            code = fc_rows_digests(sys.argv[2] if len(sys.argv) > 2
                                   else os.path.dirname(os.path.abspath(__file__)))
        elif sys.argv[1:2] == ["--envelope-times"]:
            args = sys.argv[2:]
            mb = (tuple(int(x) for x in args[args.index("--min-blocks") + 1].split(","))
                  if "--min-blocks" in args else None)
            rest = [a for i, a in enumerate(args) if not a.startswith("--")
                    and (i == 0 or args[i - 1] != "--min-blocks")]
            code = envelope_times(rest[0] if rest else os.path.dirname(os.path.abspath(__file__)),
                                  no_guard="--no-guard" in args, min_blocks=mb,
                                  books_only="--books" in args)
        else:
            code = main()
    except Exception as exc:  # any failed phase: report it, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
