#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aux_ssm_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. setup: require a CUDA card, print its name and power limit, build the
     kernels from `aux_ssm_tpu_torch/ops/cuda/csrc/` and print the build time;
  1. each of the six kernels at the main path's shapes (T=1024, dx=16 flagship
     LGSSM, f32, inputs from a real filter pass) against its plain PyTorch
     version on the same inputs in f32 and in f64, plus the filter and
     affine scans at T=300 and at n=2 (one combine: the chain's floor),
     make_elements, ell and logdensity_steps with a share NAN_SHARE of the
     observations missing, and the f64 kernels against the f64 plain
     versions; filter and affine scans
     interleaved on two streams for 50 rounds, bit-equal to one stream's;
     then the whole MH step in f64 on the card against the CPU at T=64,
     dx=8, given the same noise;
  2. 50 second-order MH steps at T=1024, dx=16, f32: acceptance >= 0.99 (the
     proposal is exact for this Gaussian target) and exactly 10 kernel
     launches per step;
  3. 100 first-order MH steps at delta=0.05: finite states, acceptance in
     (0, 1], samples/s.
The stochastic-volatility (SV) particle-Gibbs path, T=250, D=30, N=25:
  4. the three cSMC sweep kernels against their plain versions on the inputs
     a real SV step hands them (csmc and csmc-guided, f32 and f64), and at
     T=1024, N=4096, k=1 (factor sweeps) and N=1024 (block-lane sweep); the
     factor sweeps' one-warp path (N <= 32: the pair scores of every step,
     then the sweep on one warp, two launches a sweep) also at its edges N=1
     and N=32 (T=256, k=64);
  5. f64 aux-cSMC steps of both styles on the card against the CPU (T=32,
     D=4, N=16), given the same noise;
  6. csmc-guided from the committed run's data, start and adapted delta
     (`benchmarks/results_r5/sv/csmc_guided_*.npz`), without and with the
     gradient shift: 100 + 200 iterations at frozen delta, mean update rate
     in [0.4, 0.6], exactly one block-lane sweep launch and one backward
     sweep (FACTOR_LAUNCHES launches) per iteration, samples/s;
  7. csmc (sequential sweep): 200 burn-in iterations adapting a (T,) delta
     from 1e-2, then 100 sampling iterations: update rate in (0, 1), exactly
     one forward and one backward factor sweep per iteration, FACTOR_LAUNCHES
     launches each.
The scalar-state particle-Gibbs path (theta-logistic PGAS, T=256, N=256, and
the rare-event model at T=2, N=25):
  8. the lane sweep kernel against its plain version for each model functor
     (f32 step by step from the kernel's own carry, f64 whole sweeps with
     identical ancestors; PGAS on and off): theta-logistic on the inputs of a
     real PGAS step, and with PGAS on random inputs at N=1 (the one-warp
     chain's floor), N=33 and N=1024 (the block path's edges), the AR(1) toy
     at T=1024, N=4096 (the wide path), the rare-event guided (on a real
     step's inputs, gradient off and on) and bootstrap models (one warp);
  9. f64 theta-logistic PGAS steps and rare-event steps of every style on the
     card against the CPU, given the same noise, with each step's launches
     (kalman: one cell is M = 1 of the batched scalar layout, two scalar
     filter scans and one scalar affine scan and nothing else);
 10. the theta-logistic PGAS chain, f32, 300 + 600 iterations: exactly one
     lane sweep launch per iteration, update rate in (0, 1), samples/s, mean
     interior ESS and ESS/s;
 11. (cut: its single-cell rare-event chains are cells of phase 29's grid,
     which runs every style on all 100 cells at once).
The spatio-temporal Student-t path (T=1024, 8x8 grid: B=64 components, N=25,
nu=4, tau=-0.25, r_y=1, sigma_x=0.3; benchmarks/spatial_sweep.sh):
 12. the two scalar scan kernels against their plain versions (f32 and f64)
     on the inputs a real spatial kalman-1 step hands them (filter n=1023,
     affine n=1024 reversed, B=64), at T=300, at n=1, and on a 64x64 field
     (B=4096);
 13. the sweeps of the spatial cSMC styles against their plain versions on
     the inputs real steps hand them (T=1024, N=25; f32 step by step, f64
     identical indices): the block-lane sweep with the functor SpatialGuided
     (d=64, gradient shift off and on) and the forward and backward factor
     sweeps at k=64 (a csmc step's, and the guided step's backward sweep),
     the factor sweeps' f32 also against the f64 plain version on the same
     inputs at the same bounds (the pair factors are centred);
 14. f64 spatial steps of every style on the card against the CPU (T=32, 3x3
     grid, N=16), given the same noise;
 15. spatial chains at full width, f32, data from `get_data` seed 42:
     kalman-1 and kalman-2 (update rate toward 0.5), csmc with backward
     sampling, csmc-guided without and with the gradient shift (toward 0.25,
     (T,) delta), each from `init_x_fn`. The published schedule (2500 + 10000
     iterations from delta 1e-5) is cut to SPATIAL_SCHEDULE below and starts
     from delta 1e-2 (the adapted step of the committed JAX kalman run is
     1.02e-2), since the cut burn-in cannot climb from 1e-5. Asserted: exact
     launch counts (a kalman step: two scalar filter scans, one scalar affine
     scan and none of the six d x d kernels), update rates in (0.05, 0.95),
     and a posterior mean nearer the simulated truth than the start was.
     These samplers move ~0.07 a coordinate an iteration, so the cut chains
     are still travelling from the bootstrap filter's start (2 away from the
     truth): they give launch counts, rates and profiles, and no two of them
     can be held against each other. So kalman-1 and csmc-guided, samplers
     that share only the target, run again and longer (SPATIAL_PAIR) from
     the simulated states, which given the data are an exact draw from the
     posterior: every chain is stationary from the first iteration. Each
     sampler runs two replicate chains (one batched step of two chains,
     each its own delta), and the gap between their means,
     pooled over a set of columns, is the Monte-Carlo error: no estimate of
     the autocorrelation enters (at the few autocorrelation times these
     chains last, that estimate of the ESS, printed with each chain, reads
     2-4 times too high). Held: (a) each sampler's means of pooled
     functionals (shift from and spread about the smoothed data, the
     roughness of the increments and the coupling of neighbouring cells'
     increments; 16 time blocks and the whole trajectory of each) against
     their values at the simulated states, one posterior draw, in units of
     the functional's posterior deviation: max |z| <= 6, RMS z <= 1.5; (b)
     the two samplers' means of the same functionals against each other and
     (c) their posterior means of 1024 interior coordinates: max |z| <= 6,
     RMS z <= 2. The posterior-mean fields must also differ by less than the
     posterior deviation in RMS and lie nearer the truth than the data do.
The parallel-in-time (PIT) cSMC path, the `csmc` style's default in the
JAX package's experiment scripts (`--parallel`): the stitching kernels
row_lse, col_sample, block_masses, stitch_draws and within_block_cols, one
launch each a tree level:
 16. the five kernels against their plain versions on the inputs real PIT
     steps hand them (f32, and f64 on the same inputs cast): SV T=250, D=30,
     N=25 level 0 (P=125, k=30) and root; spatial T=1024, 8x8, N=25 level 0
     (P=512, k=64) and root; SV D=1, T=1024, N=4096 level 0 (block_masses,
     P=512, k=1, both stabilisers; stitch_draws from a step with the fused
     draws, within_block_cols from one with the joint draws) and root
     (row_lse, P=1); the two draw kernels again at N=128 (one column
     block) and on random inputs (DRAW_CASES: N=8192, nb=64, P=2, k=1;
     N=2048, P=4, k=30, the features through shared memory), each with
     its issue-rate bound beside the operations bound (the draws' score
     instructions, DRAW_SCORE_INSTRUCTIONS, over 128 lanes an SM a clock;
     col_sample's likewise, COL_GUMBEL_INSTRUCTIONS + 2k a score).
     row_lse and block_masses norm-relative, f32 also against the
     f64 plain version, their -inf entries where the f64 plain version's
     are; block_masses (the float32 exponentials on the SFU) also timed
     against baddbmm + logsumexp and bounded by the SFU's rate; the index
     kernels f64 identical, f32 equal to the
     f32 plain version's (col_sample >= COL_AGREE_F32, the draws >=
     AGREE_F32) and to the f64 plain version's at >= AGREE_F32;
 17. f64 PIT steps on the card against the CPU, given the same noise: SV
     (T=32, D=4), spatial (T=32, 3x3), rare-event (T=6), each on the
     two-pass route (N=16) and the blocked route (forced at N=128; SV and
     rare-event with either draws), the gradient shift off and on, with the
     exact launches a step;
 18. PIT chains at full width, f32: SV csmc (T=250, D=30, N=25, delta (T,)
     adapted from 1e-2 toward 0.5) without and with the gradient shift;
     spatial csmc (T=1024, 8x8, N=25, toward 0.25); SV D=1, T=1024, N=4096
     (`benchmarks/csmc_speed.py:_pit`, the blocked route, delta frozen at
     0.05, 3 + 10 iterations from the simulated states) with the joint and
     with the fused draws. Asserted: the exact stitching launches a step
     (SV: 8 row_lse and 7 col_sample; spatial 10 and 9; N=4096 1 row_lse, 9
     block_masses and 9 within_block_cols, or 9 stitch_draws), update rates
     in [0.05, 0.95] (N=4096: [0.95, 1], the JAX package's chain updated
     0.997); samples/s and a profile of each;
 19. the rare-event csmc with parallel=True in f64 at (y, rho, r2) = (5,
     0.8, 0.5): T=256 with N=25 (two-pass tree), T=64 with N=4096 (blocked
     tree, either draws); moments of x_0 and x_{T-1} within an ESS-scaled
     tolerance of 6 standard errors of the closed form (T=2, the root alone,
     is cut: phase 29's grid runs it on every cell).
The stochastic-volatility auxiliary-Kalman path (kalman-1/2, T=250, D=30:
the MH kernels' D = 32 instance; benchmarks/sv_sweep.sh):
 20. the six MH kernels' D = 32 instance against their plain versions on a
     real SV kalman-1 step's inputs (the committed run's data, xs_true and
     delta), f32 and f64, make_elements, ell and logdensity_steps also with
     a share NAN_SHARE of the observations missing, then make_elements and
     the filter scan on random well-conditioned models at d = 17 and d = 32
     (the instance's edges; `edge_kernels`). At
     D = 30 the f32 plain version itself misses NREL_F32 against f64 on some
     outputs (make_elements' A and C: the cancellation in P_pred - K S K^T,
     1.7e-4 and 7.2e-4), where no f32 kernel can agree with it to NREL_F32:
     such an output (own error e) holds the f32 kernel to f64 at 2 e and to
     the f32 plain version at 3 e (|kernel - f32| <= |kernel - f64| + e),
     every other output at NREL_F32 against both (all printed); each entry
     also carries its device ms by the profiler;
 21. f64 SV kalman steps of both orders (T=32, D=30) on the card against the
     CPU, given the same noise, identical accept decisions;
 22. kalman-1 and kalman-2 chains at T=250, D=30, f32, parallel, 50 + 100
     iterations at the committed runs' adapted delta (frozen), from
     xs_true: exactly 10 kernel launches a step, every one a D = 32
     instance by its profiler name, finite states, an update rate in
     SV_KALMAN_RATE, and the chain's mean within SV_KALMAN_Z_RMS RMS
     posterior deviations of the committed run's (`samples_mean`,
     `samples_std`: a chain that stays near xs_true reads ~1, a wrong target
     drifts away); samples/s and a profile of each step.
The Lorenz-63 parameter-learning Gibbs sampler (`experiments/lorenz.py
--data mider --freq 4`: T=5001, dx=3, the u rows stacked on the two data
rows, dy=5: the MH kernels' D = 16 instance; benchmarks/lorenz_mider.sh):
 23. the six MH kernels against their plain versions on a real Lorenz
     step's inputs (the committed run's mean_x and theta,
     `benchmarks/results_r5/lorenz/mider_freq4.npz`) at delta 1e20 (the
     committed runs' delta, the adaptation's cap: R = 5e19 on the u rows)
     and at 1e-2, f32 and f64, held as phase 20 holds them; at 1e20 each
     entry also carries its device ms by the profiler, printed beside its
     bound on the unpadded bytes; the filter and affine scans also at freq
     2 (T=10001, chunks of 79); and log alpha of the same step at the
     committed state in f32 and f64, by the plain versions (CPU) and the
     kernels (printed, not bounded: f32 sums ~1e5-sized terms);
 24. four f64 Lorenz Gibbs steps (synthetic, T=64, observed every 4,
     parallel, delta 10) on the card against the CPU, given the same noise:
     identical accept decisions, trajectories and theta within STEP_RTOL;
 25. the Mider freq-4 chain, f32, parallel, LORENZ_SCHEDULE iterations from
     the committed run's mean_x and theta at its delta, frozen: exactly 10
     kernel launches a step, every one a D = 16 instance by its profiler
     name, finite states, an update rate in LORENZ_RATE, each theta_i's
     chain mean within LORENZ_THETA_Z committed posterior deviations of the
     committed `theta_samples` mean, the chain's mean trajectory within RMS
     LORENZ_MEAN_RMS (sig_y) of the committed `mean_x` on the observed x2
     and x3; samples/s, a profile of one step and each kernel's device ms
     in it (the driver's `main` runs in phase 31, at C = 1 and C = 8).
The experiment drivers (`experiments/sv.py`, `experiments/spatial.py`) with
resumable checkpoints (`utils/checkpoint.py`), and the divide-and-conquer
sampler (`ops/dnc_sampling.py`), each driver run with the launch counters
reset before it and read after it:
 26. the SV driver at T=250, D=30, f32: kalman-1 at SV_DRIVER_SCHEDULE from
     the driver's own start (`init_x_fn`'s bootstrap-filter draw, degenerate
     at D = 30: the chain accepts nothing until delta has shrunk from its
     default 1e-2, so the burn-in, adapting at `--lr` SV_DRIVER_LR, is long
     enough for delta to settle near the update rate 0.5 once the chain has
     reached the posterior),
     uninterrupted, and again checkpointed
     every SV_DRIVER_EVERY iterations, killed (a dying `runner._save`) after
     its second sampling segment and resumed: the resumed .npz equals the
     uninterrupted one bit for bit in every key but sampling_time, the
     killed and resumed runs' launches add up to the uninterrupted run's,
     the update rate lies in SV_KALMAN_RATE (phase 22's), each save's
     seconds printed; then csmc (parallel-in-time) and csmc-guided with
     `--n-chains` 32 (one batched step) at CSMC_SV_SCHEDULE from the
     driver's start, each counted at C = 1 for CSMC_ONE_CHAIN
     (`csmc_chain_driver`): the launches an iteration of phases 18 and 6 at
     C = 1 and at C, the JAX driver's keys and shapes, finite, the update
     rate in (0, 1), split-R-hat printed; samples/s of all chains; and so
     the sequential csmc (`--no-parallel`) with `--resampling systematic`
     (the generic forward loop over the chain axis, then the backward
     factor sweep; CSMC_SEQ_SCHEDULE) and with `--no-backward --debug-nans` (the forward factor
     sweep, then ancestor scanning over the chain axis; the runner's finite
     check after every step);
 27. the spatial driver at T=1024, 8x8, N=25, f32: kalman-2, csmc
     (parallel-in-time) and csmc-guided with `--n-chains` 8 at
     CSMC_SP_SCHEDULE, each counted at C = 1 likewise: `xs_true` and `ys`
     equal `get_data`'s from the seed, the JAX driver's keys and shapes,
     finite moments, exact launches, equal an iteration at C = 1 and at C
     (kalman: two scalar filter scans and one scalar affine scan a step, the
     chains' 8 x 64 components as 512 columns);
 28. `dnc_sampling` in f64: one draw on the flagship LGSSM's filter output
     (T=1024, dx=16) given fixed noise, card against CPU within STEP_RTOL;
     DNC_DRAWS draws at T=64, dx=4 against as many of the scan sampler's
     (`ops.sampling`, parallel): means and standard deviations at every
     (t, i) within DNC_Z_MAX standard errors.
Chain batching (`parallel/chains.py`): the rare-event grid
(`experiments/rare_event.py`) as one batched sampler over a chain axis:
 29. (its kernel checks run right after the build, before any profile)
     the chain-axis instances of the lane sweep, the backward and forward
     factor sweeps and col_sample (one launch a sweep for C chains, a block
     a chain) on the inputs one grid step at M = 800 hands them (f64): each
     against its plain version (indices identical, values to RTOL_F64), its
     call at C = 1 bit-equal to the call without a chain axis, col_sample's
     chains each equal to a one-chain call with its seed; then the published
     grid (benchmarks/rare_event_sweep.sh: T=2, y=5, 10 x 10 cells x 8
     chains, M = 800, N=25, f64, target 0.5, seed 42) in all six
     configurations (kalman, csmc (PIT), csmc-guided, each without and with
     the gradient shift) at GRID_SCHEDULE: the launches an iteration equal
     at M = 8 and at M = 800 (kalman 3, csmc-guided 1 + 2, csmc 1), every
     cell's moments of x_0 and x_{T-1} whose pooled ESS is at least
     GRID_MIN_ESS within GRID_Z standard errors of the closed form (mean) and
     of a standard deviation estimate (std), the hardest corner (rho 0.999,
     r2 1e-3) reported, the chains' deltas moved apart, samples/s and a
     profile (device busy share) of each; the --no-parallel grid (forward
     factor sweep) and the PIT grid at T=6 (col_sample) briefly; at least
     GRID_MIN_BOUNDED cell coordinates of each configuration must have been
     bounded.
The chain axis through the auxiliary-Kalman MH path (the dense batched
layout: SV kalman-1/2 and the Lorenz Gibbs sampler, C chains as one batched
step; `parallel/chains.py`, `kernels.kalman.chain_major`):
 30. (run right after the build, with phase 29's kernel checks) the six MH
     kernels' chain instances (rows 1-7, a block a (step, chain) pair, F,
     Q, b read once for every chain) on real batched steps' inputs: SV
     kalman-1 at T=250, D=30 (the D = 32 instance), C = 32 chains from the
     committed run's xs_true, each with its own u and delta; the Lorenz
     step at the Mider freq-4 shape (T=5001, the D = 16 instance), C = 8
     chains at the committed mean_x, each with its own theta and u, delta
     1e20. Each against its plain version at phases 20 and 23's bounds
     (`compare`, own_bound), with its device ms by the profiler; its C = 1
     call bit-equal to the one-chain call; chains 0, C / 2 and C - 1 of the
     C-chain launch bit-equal to one-chain launches on their inputs; a
     two-stream round of the chain-axis scans (10 rounds), bit-equal to one
     stream's;
 31. the drivers with `--n-chains`, each C chains as one batched step: the
     SV driver (kalman-1, T=250, D=30, f32) at C = 32 from its own start
     (delta from its default 1e-2, adapted at `--lr` DENSE_SV_LR) for
     DENSE_SV_SCHEDULE: the update rate of all chains in SV_KALMAN_RATE;
     the Lorenz driver on the Mider data (freq 4, T=5001) at C = 8 for
     DENSE_LORENZ_SCHEDULE from its own start (rate in (0, 1): the start
     is far from the posterior); each also at C = 1 for DENSE_ONE_CHAIN,
     to its own .npz: the six MH kernels launch as often an iteration at C
     as at C = 1 (10 an MH step) and nothing else; the output shapes (the
     Lorenz driver's: the JAX driver's .npz keys and shapes at C = 1, as
     phase 25 held them before, and at C); samples/s of all chains; a
     profile of the batched step (its device busy share). Then the batched
     Lorenz Gibbs sampler at C = 8 from the committed run's mean_x and
     theta at its delta 1e20 (frozen) for DENSE_LORENZ_CHAIN, through
     `run_sharded_chains`, held as phase 25's chain (`check_lorenz_chain`:
     update rate in LORENZ_RATE, theta's pooled mean, the mean trajectory).
C chains of the cSMC styles and of the spatial sampler as one batched step
(`chains=True` of the SV and spatial builders):
 32. (run right after the build, with phases 29-30's kernel checks) the
     block-lane sweep's chain instance (row 11, a block a chain, the
     constants shared) on real batched csmc-guided steps' inputs: SV
     (T=250, D=30, N=25) at C = 32 from the committed run's xs_true, each
     chain's delta scaled 0.75-1.25; spatial (T=1024, 8x8, N=25) at C = 8,
     the gradient shift off and on, with the blocks a chain's sweep puts on
     an SM (`block_lane_occupancy`). f32 against the plain version step by
     step from the kernel's own carry (chains 0, C / 2, C - 1) at phase 4's
     bounds; f64 whole sweeps of every chain (the gradient variant: the three
     chains) against the plain version run on CPU copies of the inputs,
     identical indices; C = 1 and chains 0, C / 2, C - 1 bit-equal to
     one-chain launches in f32 and f64; the launch's device ms against C
     one-chain launches'. Then the scalar scans on a batched spatial kalman-1
     step's inputs at C = 8 (512 columns) against their plain versions, and
     each chain's 64 columns against a 64-column launch (f64: bit for bit,
     or within 1e-12).
The last single-card gaps: the chain instances of the blocked route's two
column draws, and the shapes past the kernels' instances:
 33. (run right after the build, with phases 29, 30 and 32's checks)
     stitch_draws' and within_block_cols' chain instances (rows 17-18, a
     seed a chain, each node's pair counted within its chain) on the level-0
     inputs of real batched blocked steps of the SV D=1 model at N=4096:
     T=1024 at C = DRAW_CHAINS = 4 (2048 nodes) and T=64 at C = 32 (1024
     nodes): f64 indices identical to the plain chain twin's, f32 at >=
     AGREE_F32 against the f32 and the f64 twin; the C = 1 call and chains
     0, C / 2, C - 1 of the C launch bit-equal to one-chain launches with
     their seeds (f32 and f64); at C = 4 the launch's time (events and the
     profiler's device ms) beside the C = 1 launch's and 4 one-chain
     launches', the twin's and the bound (operations and issue rate);
 34. (after phase 21) widths past the kernels' instances, steps on the
     card against the CPU, given the same noise: SV kalman-1 at D = 33
     (T=16) in f64 and at D = 49 in f32 (to X_F32), none of the six d x d
     kernels launched (their callers route max(dx, dy) past 32 in f64, past
     48 in f32, to the plain versions, `_build.has_instance`); spatial
     csmc-guided at d = 81 in f64 (9 x 9, T=8, N=16), the block-lane sweep
     launched once a step past the 64 components its lanes keep in
     registers (SpatialGuided's wide path: those components in the warp's
     shared scratch). Then that sweep on a real csmc-guided-grad step's
     inputs at T=1024, d=81, N=25 against its plain version as phase 13
     holds it at d = 64 (f32 step by step, f64 identical ancestors), timed,
     its entry inside the block-lane entry's `functors`;
 35. (after phase 31) the multi-device layer (`aux_ssm_tpu_torch/parallel/`,
     `kernels/{csmc_sharded,pit_sharded}.py`) on meshes of MESH_SHARDS
     shards over the cards there are (one card: all four shards on it; the
     phase's first line names them), f32: the particle-sharded PIT step
     (SV D=1, T=1024, N=4096: 1024 columns a shard) under both draws, x
     and `updated` bit-equal to the one-device blocked step with per-block
     maxima, block_masses launched MESH_SHARDS times a level; the per-shard
     block_masses launch (P=512, 4096 rows, 1024 columns, k=1, per-block
     max) against its plain version in f32 and f64, its device time beside
     the full-width launch's; the time-sharded PIT step (C=4, Tc=256) in
     f64, `updated` identical, x within MESH_PIT_X_ATOL (f32 timed, its
     share of equal picks logged: its chunks' launches have a quarter of the
     nodes, and the plans and cuBLAS's choices that follow the node count
     round f32 otherwise); the time-sharded filter
     and affine scans of the flagship step's elements (T=1024, dx=16, f32
     and f64) against the one-device scan kernels (MESH_SCAN_NREL); SV
     kalman-1 (T=250, D=30) at C=32 through `cli.run_maybe_sharded` with
     a device list, one shard bit-equal to the run without a mesh and each
     of four shards bit-equal to a batched run of its 8 chains with its
     shard generator; batch-sharded spatial kalman-1 steps (T=1024, 8x8)
     against the unsharded step on the same noise, one accepted whatever the
     ratio (the proposals compared) and one drawn (the same accept, x within
     MESH_BATCH_NREL); then `dryrun_multichip` in one process a card
     over NCCL, 2 shards each, every check held in every process and the
     particle-sharded step equal to the one-process run's. Each sharded
     path's time beside the one-device path's; the process group's set-up
     and the first NCCL collective timed. Its sharded runs' launches are
     added to the kernels' counts (the chains mesh's to the chain-instance
     entries), and the per-shard block_masses numbers sit in block_masses'
     entry as `per_shard`.
The float32 D = 48 instance of the six MH kernels (SV at D = 33-48):
 36. (run right after the build, after phase 30's checks) the six kernels'
     D = 48 instance on a real SV kalman-1 step's inputs at D = SV48_D = 40,
     T = 128 (simulated, seed 36; delta SV48_DELTA), f32 against the f32
     plain version and the f64 plain version at phase 20's bounds (no f64
     kernel: f64 stops at 32), with each kernel's device ms by the profiler;
     the chain instances at C = SV48_CHAINS = 32 (C = 1 and three chains
     bit-equal to one-chain launches); make_elements and the filter scan at
     the edges 33 and 48 on random models; the filter and affine combines'
     clock64 cycles (the filter's on its chain's 256 threads, the affine's
    on 128 and 256). Then SV kalman-1 and kalman-2 at
     C = 1 and C = 32 from the simulated states at their frozen deltas,
     SV48_SCHEDULE: in f32 through the instance (10 launches a step at both
     C, nothing else) and in f64 through the plain route on the card (no
     launch): the f32 update rate within SV48_RATE_SE standard errors
     (batch means) of the f64 one, samples/s of all chains of both; a
     profile of the f32 kalman-1 step, its kernels the D = 48 instance's by
     name.
For phase 36 (~45 s, and scan.cu's D = 48 instances in the build), phase
20's edges run make_elements and the filter scan only (all six before: the
other four pad d as make_elements does, and the card tests and the host
build run them at the edges), and phase 36's own one-chain runs are 5 + 80
(10 + 150 before: the f64 plain route takes ~75 ms a step). To make room
before, phase 3 runs 100 steps (200 before), phase 10 300 + 1000
iterations (300 + 2000 before), phase 11 is cut for phase 29 (its chains
ran 500 + 1200 a bounded cell, 300 + 400 the hardest), phase 15's
replicate chains 300 + 700 (kalman-1) and 300 + 700 (csmc-guided) (300
+ 3000, then 300 + 2000, then 300 + 1500, then 300 + 1000 before), and phase 19 at T=256 300
+ 300 (300 + 700, then 300 + 400 before; its T=2 chain is cut for phase
29): every bound
is in units of the chain's own Monte-Carlo error, so a shorter chain
widens it and keeps its meaning. For phases 30-31, phase 29's SV driver run
with `--n-chains 2` (the chain loop, 10 + 20 iterations: launches and
shapes) is cut: phase 31's batched runs replace it; phase 22's chains run
50 + 100 (100 + 200 before) and phase 25's 50 + 100 (100 + 300 before):
phase 31's batched Lorenz chain holds the same bounds over 8 chains; phase
26's kalman-1 runs 300 + 200 adapting at --lr 0.5 (1000 + 200 at the
default 0.1 before: the same settling, in fewer iterations) and phase 19's
N=4096 chains 100 + 200 (100 + 300 before). For phases 33-34, phase 10's
one-chain run is cut to 300 + 600 (300 + 1000 before), phase 18's N=4096
one-chain chains become the C = 4 batched runs (with a C = 1 count run and
a short chain loop beside them), phase 28 draws 256 a sampler (512
before; for phase 35, 128), and phase 34 drops its d = 64 step (phases 13-14 hold that
width); phase 29's grid stays at 300 + 600 (at 200 + 400 a csmc-guided
gradient cell's x_T spread missed its bound at 7.1 standard errors, ESS
131). The
whole takes 383-605 s with the build on an H100, as fast as the host is
(with phase 29: 403-491 s; with phases 30-31: 442-603 s, then 445.5 s after
the last cuts of phases 15 and 19; with phases 33-34 596.0 s on a host that
ran one theta-logistic chain at half the usual samples/s, before the last
cuts of phases 26 and 28; with phase 35 470.5 s from a `git archive` on
a host whose phases 0-7 took 109.5 s, 601.5 s on a slow one; with phase
36 572.4 s on a host whose phases 1-7 took as long as that one's, before
its cuts and the D = 48 filter combine's call, 668.1 s on a slower one
after them); phase 36 ~30-48 s, phase 35
~28 s, phase 33 ~16 s, phases 20-22 take ~30 s, phases 23-25
~26 s, phases 26-28 27-55 s, phase 29 50-110 s, phase 30 ~12 s, phase 31
~21-31 s, the build ~43-56 s before phase 36 and 84-88 s in its first
runs (scan.cu alone 82 s with the D = 48 filter combine inlined; 52 s with
it called and without its 128-thread cycles instance).
Each kernel's entry of the JSON summary carries its bound: the least time the
card could take for the call, the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the 67
TFLOP/s of float32 outside the tensor cores; the entries of row_lse (each
of its shapes) and block_masses also carry `sfu_bound_ms`, their
exponentials (one a score) over the SFU's 16 a clock on each SM at the
card's top SM clock (nvidia-smi clocks.max.sm). No
single PyTorch call computes any of these kernels' functions (`torch.cumsum`
and `torch.cumprod` scan one array under + or *; the scalar scans combine
tuples of two and five arrays, the filter's through a reciprocal; row_lse
and block_masses take two, `torch.baddbmm` and `torch.logsumexp` (over each
128-column block, in chunks of nodes), timed beside them as `two_call_ms`;
the draws hash counters and take Gumbel argmaxes and inverse CDFs over
gathered blocks, for which torch has no call), so `library_ms` is null
throughout.
A factor sweep's entry counts the launches of both its kernels, and its
`ms` is the wrapper's whole call; `pair_scores_ms` times the first kernel
alone where N <= 32. The line before the last is the kernels' JSON summary;
the D = 32 instances have entries of their own (`make_elements_d32`, ...:
phase 20's numbers at the SV shape, phase 22's launches), and so have the
D = 48 instances (`make_elements_d48`, ...: phase 36's numbers at D = 40,
C = 1, with its C = 32 entry inside as `chains`; their launches those of
phase 36's f32 chains, C = 1 and 32), and so have the
six kernels at the Lorenz shape (`make_elements_lorenz`, ...: phase 23's
numbers at delta 1e20, phase 25's launches); the launches of phases 26-27's
uninterrupted driver runs are added to each kernel's count (the SV kalman
ones to the D = 32 entries); the four chain-axis instances of phase 29 have
entries of their own (`lane_scan_chains`, ...: phase 29's numbers, their
launches those of the grid runs), and so have the six MH kernels' chain
instances (`make_elements_chains`, ...: phase 30's numbers at the SV shape,
C = 32, with its Lorenz-shape entry inside; their launches those of phase
31's C > 1 runs, not its C = 1 ones), and so have the block-lane sweep's
chain instance at each shape (`block_lane_scan_chains`: phase 32's numbers
at SV C = 32, its launches those of phase 26's csmc-guided `--n-chains 32`
run; `block_lane_scan_spatial_chains`: spatial C = 8, the gradient variant
inside, its launches those of phase 27's csmc-guided `--n-chains 8` run and
phase 15's pair) and the scalar scans at C B columns
(`scalar_{filter,affine}_scan_chains`: phase 32's 512 columns, their
launches those of phase 27's kalman-2 run and phase 15's pair); the C > 1
runs' factor sweeps and col_sample launches count on phase 29's chain
entries (and so do phase 26's sequential csmc runs' and, for the lane sweep,
phase 10's batched theta-logistic run's); the chain instances of the draws
have entries of their own (`stitch_draws_chains`, `within_block_cols_chains`:
phase 33's numbers at C = 4, its C = 32 shape inside, their launches those
of phase 18's C = 4 runs; the C = 1 count runs count on the draws' own
entries). The chain entries' `plain_ms` is named by `plain_on` and
`plain_dtype` where it is not the f32 call on the card; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T, DX = 1024, 16
DELTA = 0.05
NREL_F32 = 1e-4   # norm-relative bound, f32 kernel vs f32 plain and vs f64 plain
NREL_F64 = 1e-8   # norm-relative bound, f64 kernel vs f64 plain (logic check)
STEP_RTOL = 1e-9  # f64 step on the card vs the CPU
NAN_SHARE = 0.2   # observations made missing for phase 1's masked MH kernels

SV_PARAMS = (0.0, 0.9, 2.0, 0.25)  # nu, phi, tau, rho of experiments/sv.py
SV_T, SV_D, SV_N = 250, 30, 25     # the published grid (benchmarks/sv_sweep.sh)
SV_NPZ = str(Path(__file__).resolve().parent / "benchmarks/results_r5/sv/{}.npz")
# f32 sweeps: prefix sums in another order may flip an index where a uniform
# falls within rounding of a CDF step; the JAX package's own bound between
# its kernel and its oracle (tests/test_csmc_fwd.py) is >= 99.5% of indices
# equal and values within 2e-4 where they are.
AGREE_F32, TOL_F32 = 0.995, 2e-4
# At the spatial shapes (|x / sigma_x| ~ 50, d = 64) the f32 sweeps and
# stitching kernels are also held against the f64 plain version on the same
# f32 inputs, at the same bounds: the pair factors are centred
# (`csmc_base._centred`), so their terms are of the scores' size.
RTOL_F64 = 1e-9   # f64 sweeps: identical indices, values to rtol (and atol) 1e-9
# A factor sweep at N <= 32 (every model's N here but theta-logistic's 64 and
# the random N=4096 inputs) launches two kernels: the pair scores of every
# step, then the sweep on one warp. Past 32 it launches one.
FACTOR_LAUNCHES = 2

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

CSMC_KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces)
    "forward_factor_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/csmc_fwd.cu",
                            "aux_ssm_tpu/ops/pallas/csmc_fwd.py:296"),
    "backward_factor_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/csmc_fwd.cu",
                             "aux_ssm_tpu/ops/pallas/csmc_fwd.py:455"),
    "lane_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/csmc_lane.cu",
                  "aux_ssm_tpu/ops/pallas/csmc_fwd.py:667"),
    "block_lane_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/csmc_block_lane.cu",
                        "aux_ssm_tpu/ops/pallas/csmc_fwd.py:932"),
}

SCALAR_KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces)
    "scalar_filter_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scalar_scan.cu",
                           "aux_ssm_tpu/ops/pallas/scalar_scan.py:166"),
    "scalar_affine_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scalar_scan.cu",
                           "aux_ssm_tpu/ops/pallas/scalar_scan.py:205"),
}

KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces, launches per MH step)
    "make_elements": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                      "aux_ssm_tpu/ops/pallas/kalman_fused.py:233", 2),
    "filter_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scan.cu",
                    "aux_ssm_tpu/ops/pallas/filter_scan.py:368", 2),
    "ell": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
            "aux_ssm_tpu/ops/pallas/kalman_fused.py:276", 2),
    "backward_maps": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                      "aux_ssm_tpu/ops/pallas/kalman_fused.py:483", 1),
    "affine_scan": ("aux_ssm_tpu_torch/ops/cuda/csrc/scan.cu",
                    "aux_ssm_tpu/ops/pallas/kalman_fused.py:317", 1),
    "logdensity_steps": ("aux_ssm_tpu_torch/ops/cuda/csrc/kalman_fused.cu",
                         "aux_ssm_tpu/ops/pallas/kalman_fused.py:402", 2),
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card: CUDA events around `reps` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(tensors, elements, operations):
    """The least time the card could take: `tensors` (inputs and outputs, each
    moved once) plus `elements` more values of the first tensor's width, over
    the memory rate, against `operations` over the float32 rate."""
    import torch
    flat = [t for t in tensors if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in flat) + elements * flat[0].element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, operations / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": int(operations), "library_ms": None}


def flatten(args):
    return [z for a in args for z in (a if isinstance(a, tuple) else (a,))]


def as_tuple(z):
    return z if isinstance(z, tuple) else (z,)


def nrel(got, want):
    """Frobenius norm-relative error, computed in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def compare(name, wrapper, plain, args, ops, reps=20, own_bound=False, device_time=False,
            f64_kernel=True):
    """Kernel vs plain on the same f32 inputs and vs plain on their f64 cast;
    the f64 kernel vs the f64 plain version (unless not `f64_kernel`: the
    float32-only D = 48 instance); times of kernel and plain (f32);
    the bound from the call's tensors and `ops` operations. With
    `own_bound`, an output whose f32 plain version itself misses NREL_F32
    against the f64 plain version (its own error e) holds the f32 kernel to
    f64 at 2 e and to the f32 plain version at 3 e, what |kernel - f32| <=
    |kernel - f64| + |f64 - f32| allows (printed: at these inputs f32 is the
    limit, not the kernel). With `device_time`, also the kernel's device ms a
    call by torch.profiler."""
    import torch
    args64 = tuple(tuple(z.double() for z in a) if isinstance(a, tuple)
                   else a.double() if isinstance(a, torch.Tensor) else a for a in args)
    got = as_tuple(wrapper(*args))
    want32 = as_tuple(plain(*args))
    want64 = as_tuple(plain(*args64))
    got64 = as_tuple(wrapper(*args64)) if f64_kernel else (None,) * len(got)
    torch.cuda.synchronize()
    result = {"max_abs_err": 0.0, "nrel_f32": 0.0, "nrel_f64": 0.0, "nrel_f64_kernel": 0.0,
              "nrel_plain_f32": 0.0}
    if not f64_kernel:
        del result["nrel_f64_kernel"]
    bad = {}
    for i, (g, w32, w64, g64) in enumerate(zip(got, want32, want64, got64)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: output {i} of the kernel is not finite")
        errs = {"max_abs_err": float((g.double() - w32.double()).abs().max()),
                "nrel_f32": nrel(g, w32), "nrel_f64": nrel(g, w64),
                "nrel_f64_kernel": nrel(g64, w64) if f64_kernel else None,
                "nrel_plain_f32": nrel(w32, w64)}
        log(f"  {name}[{i}] shape={tuple(g.shape)} " + " ".join(
            f"{k}={v:.3e}" for k, v in errs.items() if v is not None))
        for k, v in errs.items():
            if v is not None:
                result[k] = max(result[k], v)
        own = errs["nrel_plain_f32"]
        lifted = own_bound and own > NREL_F32
        if lifted:
            log(f"  {name}[{i}]: the f32 plain version misses nrel {NREL_F32:g} against f64 "
                f"({own:.3e}): the f32 kernel is held to f64 at {2 * own:.3e} and to the f32 "
                f"plain version at {3 * own:.3e}")
        for k, lim in (("nrel_f32", 3 * own if lifted else NREL_F32),
                       ("nrel_f64", 2 * own if lifted else NREL_F32),
                       ("nrel_f64_kernel", NREL_F64)):
            if errs[k] is not None and not errs[k] <= lim:
                bad[f"{k}[{i}]"] = (errs[k], lim)
    if bad:
        raise AssertionError(f"{name}: error above bound (error, bound): {bad}")
    result["ms"] = cuda_ms(lambda: wrapper(*args), reps)
    result["plain_ms"] = cuda_ms(lambda: plain(*args), max(1, reps // 4))
    if device_time:
        result["device_ms"] = device_ms(lambda: wrapper(*args), reps)
    result.update(bound(flatten(args) + list(got), 0, ops))
    dev_ms = result.get("device_ms")
    log(f"  {name}: kernel {result['ms']:.4f} ms" + (
        "" if not device_time else " (device not measured)" if dev_ms is None
        else f" (device {dev_ms:.4f})")
        + f", plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.5f} ms by "
        f"{result['bound_by']} ({result['bytes']} B, {result['operations']} operations)")
    return result


def device_ms(fn, reps, tries=5):
    """Milliseconds of the card's kernels a call of fn(), by torch.profiler
    over `reps` calls after one. In a process that has profiled before, a
    session's trace sometimes lists none of its kernels (most calls of
    phase 20 on an H100), so a session that lists fewer kernel events than
    calls is run again, up to `tries` times; None if none listed them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels) >= reps:
            return sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return None


def mh_ops(n, d):
    """Operations of each MH kernel's call on n steps at dx = dy = d,
    counted as the flops of the d x d products, factorisations and solves
    each step's formulas need: elements 12 products + a Cholesky solve; one
    scan combine 8 products + an inverse; ell 4 products + a Cholesky;
    backward maps 5 products + 2 Choleskys; an affine combine 1 product + 1
    mat-vec; log-density 2 Choleskys + 4 triangular solves or mat-vecs. A
    scan needs (its elements - 1) combines at least."""
    d3, d2 = d ** 3, d ** 2
    return {"make_elements": n * 26 * d3, "filter_scan": (n - 1) * 18 * d3, "ell": n * 9 * d3,
            "backward_maps": n * 11 * d3, "affine_scan": n * (2 * d3 + 2 * d2),
            "logdensity_steps": n * (d3 + 8 * d2)}


def mh_inputs(dyn, obs, x, u, delta):
    """A real MH step's kernel inputs at x: the per-step model (Fs, Qs, bs,
    Hs, Rs, cs, ys of steps 1..T-1) and the t = 0 update (m0u, P0u)."""
    from aux_ssm_tpu_torch.ops.filtering import kalman_update
    m0, P0, Fs, Qs, bs = dyn(x)
    ys, Hs, Rs, cs = (z.contiguous() for z in obs(x, u, delta))
    m0u, P0u, _ = kalman_update(ys[0], m0, P0, Hs[0], cs[0], Rs[0])
    return (Fs, Qs, bs, Hs[1:], Rs[1:], cs[1:], ys[1:]), m0u, P0u


def check_mh_kernels(label, steps, m0u, P0u, eps, holes_seed, **kw):
    """The six MH kernels against their plain versions (`compare`, with
    `kw`) on one step's inputs: make_elements, ell and logdensity_steps also
    with a share NAN_SHARE of the observations missing, unless `holes_seed`
    is None. Operations are counted at d = max(dx, dy). Returns (results by
    kernel name, elements, gains, incs)."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps

    Fs, Qs, bs = steps[:3]
    n, dx = bs.shape
    ops = mh_ops(n, max(dx, steps[6].shape[-1]))
    dev = bs.device
    results = {}
    m_el = torch.cat([m0u[None], m0u.new_zeros(n - 1, dx)])
    P_el = torch.cat([P0u[None], P0u.new_zeros(n - 1, dx, dx)])
    results["make_elements"] = compare(f"make_elements{label}", KF.make_elements,
                                       KF.make_elements_plain, steps + (m_el, P_el),
                                       ops["make_elements"], **kw)
    holes = holes_seed is not None
    if holes:
        log(f"  make_elements, and below ell and logdensity_steps, with a share {NAN_SHARE} of "
            "the observations missing (NaN):")
        ys_nan = steps[6].clone()
        gen = torch.Generator(device=dev).manual_seed(holes_seed)
        ys_nan[torch.rand(ys_nan.shape, generator=gen, device=dev) < NAN_SHARE] = float("nan")
        compare(f"make_elements_nan{label}", KF.make_elements, KF.make_elements_plain,
                steps[:6] + (ys_nan, m_el, P_el), ops["make_elements"], **kw)

    elems = _make_associative_elements(*steps, m0u, P0u)
    results["filter_scan"] = compare(f"filter_scan{label}", FS.filter_scan,
                                     FS.filter_scan_plain, (elems,), ops["filter_scan"], **kw)

    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    results["ell"] = compare(f"ell{label}", KF.ell, KF.ell_plain, steps + (ms[:-1], Ps[:-1]),
                             ops["ell"], **kw)
    if holes:
        compare(f"ell_nan{label}", KF.ell, KF.ell_plain, steps[:6] + (ys_nan, ms[:-1], Ps[:-1]),
                ops["ell"], **kw)

    results["backward_maps"] = compare(
        f"backward_maps{label}", KF.backward_maps, KF.backward_maps_plain,
        (Fs, Qs, bs, ms[:-1].contiguous(), Ps[:-1].contiguous(), eps[:-1].contiguous()),
        ops["backward_maps"], **kw)

    gains, incs = _backward_maps(eps, ms, Ps, Fs, Qs, bs)
    results["affine_scan"] = compare(f"affine_scan{label}", FS.affine_scan,
                                     FS.affine_scan_plain, (gains, incs, True),
                                     ops["affine_scan"], **kw)

    xs = FS.affine_scan(gains, incs, reverse=True)[1]
    results["logdensity_steps"] = compare(
        f"logdensity_steps{label}", KF.logdensity_steps, KF.logdensity_steps_plain,
        steps + (xs[:-1].contiguous(), xs[1:].contiguous()), ops["logdensity_steps"], **kw)
    if holes:
        compare(f"logdensity_nan{label}", KF.logdensity_steps, KF.logdensity_steps_plain,
                steps[:6] + (ys_nan, xs[:-1].contiguous(), xs[1:].contiguous()),
                ops["logdensity_steps"], **kw)
    return results, elems, gains, incs


def phase_kernels(dev):
    import torch
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    dyn, obs1, _ = lgssm_flagship.build_model(T, DX, device=dev, dtype=f32)
    x = torch.zeros(T, DX, dtype=f32, device=dev)
    u = x + (0.5 * DELTA) ** 0.5 * torch.randn(T, DX, generator=gen, device=dev)
    steps, m0u, P0u = mh_inputs(dyn, obs1, x, u, DELTA)
    eps = torch.randn(T, DX, generator=gen, device=dev)
    d3, d2 = DX ** 3, DX ** 2
    log(f"phase 1: kernels at T={T}, dx={DX}, dy={steps[6].shape[-1]} (f32; bounds: nrel "
        f"{NREL_F32:g} vs plain f32 and f64, {NREL_F64:g} f64 kernel vs f64 plain)")
    results, elems, gains, incs = check_mh_kernels("", steps, m0u, P0u, eps, holes_seed=11)
    log("  scan at T=300 (the TPU's Hillis-Steele range):")
    compare("filter_scan_T300", FS.filter_scan, FS.filter_scan_plain,
            (tuple(z[:299].contiguous() for z in elems),), 298 * 18 * d3)
    log("  the chain's floor, one combine (n=2):")
    compare("filter_scan_n2", FS.filter_scan, FS.filter_scan_plain,
            (tuple(z[:2].contiguous() for z in elems),), 18 * d3)
    for k in (300, 2):
        log(f"  affine scan at n={k}:")
        compare(f"affine_scan_n{k}", FS.affine_scan, FS.affine_scan_plain,
                (gains[:k].contiguous(), incs[:k].contiguous(), True),
                (k - 1) * (2 * d3 + 2 * d2))
    two_streams(elems, gains, incs)
    return results


def two_streams(elems, gains, incs, rounds=50):
    """Filter and affine scans interleaved on two streams for `rounds` rounds:
    every output must equal, bit for bit, the same call alone on one stream
    (each stream has its own hand-over state)."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS

    scans = {"filter": lambda: FS.filter_scan(elems),
             "affine": lambda: FS.affine_scan(gains, incs, True)}
    alone = {kind: fn() for kind, fn in scans.items()}
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for r in range(rounds):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                for kind in (("filter", "affine") if (r + i) % 2 else ("affine", "filter")):
                    outs.append((kind, scans[kind]()))
    torch.cuda.synchronize()
    bad = sum(not torch.equal(g, w) for kind, out in outs for g, w in zip(out, alone[kind]))
    log(f"  two streams, {rounds} rounds of a filter and an affine scan on each: {len(outs)} "
        f"calls, {bad} outputs differ from one stream's")
    if bad:
        raise AssertionError(f"two streams: {bad} outputs differ from the one-stream run")


def phase_step_reference(dev):
    """Three f64 MH steps (T=64, dx=8, both orders) on the card against the
    CPU, given the same noise."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship

    T_, dx_ = 64, 8
    for order in (1, 2):
        runs = {}
        for where in ("cpu", dev):
            dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(
                T_, dx_, device=where, dtype=torch.float64)
            init, kernel = get_kernel(dyn, obs1 if order == 1 else obs2, tf, parallel=True)
            rng = np.random.default_rng(order)
            state = init(torch.zeros(T_, dx_, dtype=torch.float64, device=where))
            out = []
            for _ in range(3):
                noise = (torch.as_tensor(rng.standard_normal((T_, dx_)), device=where),
                         torch.as_tensor(rng.standard_normal((T_, dx_)), device=where),
                         torch.as_tensor(rng.uniform(), dtype=torch.float64, device=where))
                state = kernel(state, 0.1, noise=noise)
                out.append((state.x.cpu(), bool(state.updated), state.log_target.cpu()))
            runs[str(where)] = out
        worst = 0.0
        for (xc, uc, lc), (xg, ug, lg) in zip(runs["cpu"], runs[str(dev)]):
            if uc != ug:
                raise AssertionError(f"order {order}: accept differs between card and CPU")
            worst = max(worst, nrel(xg, xc), float(abs(lg - lc) / abs(lc)))
        log(f"  step order {order}, T={T_}, dx={dx_}, f64: card vs CPU rel err {worst:.3e} "
            f"(bound {STEP_RTOL:g})")
        if not worst <= STEP_RTOL:
            raise AssertionError(f"order {order}: card and CPU steps differ by {worst:.3e}")


def run_chain(dev, order, n_steps, seed):
    """n_steps MH steps of the flagship at T=1024, dx=16, f32, from x = 0, after
    3 warm-up steps; returns (state, acceptance, seconds, launches)."""
    import torch
    from aux_ssm_tpu_torch import get_kernel
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops import cuda as K

    dyn, obs1, obs2, tf = lgssm_flagship.build_order2_factory(T, DX, device=dev,
                                                              dtype=torch.float32)
    init, kernel = get_kernel(dyn, obs1 if order == 1 else obs2, tf, parallel=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.zeros(T, DX, dtype=torch.float32, device=dev))
    for _ in range(3):
        state = kernel(state, DELTA, generator=gen)
    torch.cuda.synchronize()
    K.reset_launches()
    accepted = torch.zeros((), device=dev)
    tic = time.perf_counter()
    for _ in range(n_steps):
        state = kernel(state, DELTA, generator=gen)
        accepted += state.updated
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    launches = K.launches()
    acc = float(accepted) / n_steps
    if tuple(state.x.shape) != (T, DX) or not bool(torch.isfinite(state.x).all()) \
            or not bool(torch.isfinite(state.log_target)):
        raise AssertionError(f"order {order}: the chain's state is not finite")
    for name, (_, _, per_step) in KERNELS.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(f"order {order}: {name} launched {launches[name]} times, "
                                 f"expected {per_step * n_steps}")
    log(f"  order {order}: {n_steps} steps, acceptance {acc:.4f}, "
        f"{n_steps / seconds:.2f} samples/s, launches {launches}")
    return state, acc, seconds, launches


# ---------------------------------------------------------------------------
# The stochastic-volatility particle-Gibbs path
# ---------------------------------------------------------------------------

def load_sv(name, dev, dtype):
    """(ys, xs_true, adapted delta (T,)) of a committed SV run, T=250, D=30."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch import sv_from_numpy
    z = np.load(SV_NPZ.format(name))
    ys, xs = sv_from_numpy(z["ys"], z["xs_true"], device=dev, dtype=dtype)
    return ys, xs, torch.as_tensor(z["delta"], dtype=dtype, device=dev)


def sv_kernel(style, ys, N, gradient=False):
    """(init, kernel) of the SV sampler `style` with backward sampling."""
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    get = sv.get_csmc_kernel if style == "csmc" else sv.get_guided_csmc_kernel
    return get(ys, *SV_PARAMS, N, backward=True, gradient=gradient)


@contextlib.contextmanager
def recording_sweeps():
    """Record the arguments each cSMC sweep wrapper is called with; the calls
    go through. A wrapper counts its launches on its module's name, which is
    the recorder meanwhile, so these launches count on the recorder."""
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    seen, originals = {}, {name: getattr(CF, name) for name in CSMC_KERNELS}

    def recorder(name, fn):
        def record(*args, **kwargs):
            seen[name] = args
            return fn(*args, **kwargs)
        record.launches = 0
        return record

    for name, fn in originals.items():
        setattr(CF, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(CF, name, fn)


def sv_sweep_inputs(dev, dtype, style, N, seed):
    """The arguments of each sweep in one SV aux-cSMC step at T=250, D=30,
    from the committed xs_true at the committed run's adapted delta."""
    import torch
    ys, xs, delta = load_sv("csmc_no-gradient" if style == "csmc"
                            else "csmc_guided_no-gradient", dev, dtype)
    init, kernel = sv_kernel(style, ys, N)
    with recording_sweeps() as seen:
        kernel(init(xs), delta, generator=torch.Generator(device=dev).manual_seed(seed))
    return seen


def random_factor_inputs(dev, n, N, k, seed):
    """Factor-sweep inputs (rf, cf, rb, cb, res_u, anc_u, w0) in f64."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=torch.float64)
    w0 = 0.1 + 0.9 * torch.rand(N, **kw)
    return (0.5 * torch.randn(n, N, k, **kw), 0.5 * torch.randn(n, N, k, **kw),
            torch.randn(n, N, **kw), torch.randn(n, N, **kw), torch.rand(n, N, **kw),
            torch.rand(n, **kw), w0 / w0.sum())


def carry(log_w):
    """The sweeps' normalised carry exp(lw - max) / sum."""
    import torch
    w = torch.exp(log_w - log_w.max())
    return w / w.sum()


def agree_f32(name, idx, idx_plain, values=()):
    """f32 bounds: >= AGREE_F32 of the indices equal, and each (got, want,
    mask[, slack]) within TOL_F32 (rtol and atol) plus slack where mask.
    Returns (share of equal indices, largest abs error of the values, or of
    the indices if none)."""
    share = float((idx == idx_plain).double().mean())
    err = float((idx - idx_plain).abs().max()) if not values else 0.0
    for got, want, mask, *slack in values:
        g, w = got[mask].double(), want[mask].double()
        if g.numel():
            extra = slack[0][mask] if slack else 0.0
            if bool(((g - w).abs() > TOL_F32 * (1 + w.abs()) + extra).any()):
                raise AssertionError(f"{name} f32: values differ by more than {TOL_F32}")
            err = max(err, float((g - w).abs().max()))
    if not share >= AGREE_F32:
        raise AssertionError(f"{name} f32: only {share:.4f} of the indices agree")
    return share, err


def exact_f64(name, idx, idx_plain, values=()):
    """f64 bounds: identical indices, each (got, want) to RTOL_F64. Returns the
    largest |got - want| / (1 + |want|)."""
    import torch
    if not torch.equal(idx, idx_plain):
        raise AssertionError(f"{name} f64: {int((idx != idx_plain).sum())} indices differ")
    err = 0.0
    for got, want in values:
        err = max(err, float(((got - want).abs() / (1 + want.abs())).max()))
    if not err <= RTOL_F64:
        raise AssertionError(f"{name} f64: values differ by {err:.3e}")
    return err


def resynced(n, step):
    """Concatenate step(t), t < n: the plain version of each step run from
    the kernel's own previous carry."""
    import torch
    outs = [step(t) for t in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(z) for z in zip(*outs))
    return torch.cat(outs)


def check_forward_factor(label, args32, args64, pgas, reps, vs_f64=False):
    """f32: each step of the plain sweep from the kernel's previous carry;
    f64: whole sweeps. `vs_f64`: the f32 kernel also against the f64 plain
    version on the same inputs (from the kernel's carry too), at the f32
    bounds. Returns the result entry."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    name = f"forward_factor_scan[{label}, pgas={pgas}]"
    rf, cf, rb, cb, res_u, anc_u, w0 = args32
    lw, anc = CF.forward_factor_scan(*args32, pgas=pgas)

    def plain_steps(args):
        return resynced(rf.shape[0], lambda t: CF.forward_factor_scan_plain(
            *(z[t:t + 1] for z in args[:6]),
            args[6] if t == 0 else carry(lw[t - 1]).to(args[6].dtype), pgas))

    lw_p, anc_p = plain_steps(args32)
    share, err = agree_f32(name, anc, anc_p, [(lw, lw_p, anc == anc_p)])
    result = {"max_abs_err": err, "index_agree_f32": share}
    if vs_f64:
        lw_u, anc_u = plain_steps(tuple(z.double() for z in args32))
        share_u, err_u = agree_f32(f"{name} against f64", anc, anc_u, [(lw, lw_u, anc == anc_u)])
        log(f"  {name}: f32 kernel against the f64 plain version on the same inputs (log "
            f"weights in [{float(lw_u.min()):.1f}, {float(lw_u.max()):.1f}]): indices "
            f"{share_u:.4f} equal, values max abs err {err_u:.3e}")
        result.update({"index_agree_f64_plain": share_u, "max_abs_err_f64_plain": err_u})
    lw64, anc64 = CF.forward_factor_scan(*args64, pgas=pgas)
    lw64_p, anc64_p = CF.forward_factor_scan_plain(*args64, pgas=pgas)
    result["max_rel_err_f64"] = exact_f64(name, anc64, anc64_p, [(lw64, lw64_p)])
    n, N, k = rf.shape
    # A step: N ancestor searches, N k-dots, a prefix sum and a softmax (and
    # N more k-dots with their softmax and prefix sum under PGAS).
    ops = n * N * (2 * k + math.log2(N) + 8 + pgas * (2 * k + 6))
    if N <= CF.WARP_N:  # the first of the sweep's two kernels, alone
        result["pair_scores_ms"] = cuda_ms(
            lambda: CF.pair_scores(rf, cf, args32[2:5], args32[5]), reps)
    return timed(name, result,
                 lambda: CF.forward_factor_scan(*args32, pgas=pgas),
                 lambda: CF.forward_factor_scan_plain(*args32, pgas=pgas), reps,
                 bound(list(args32) + [lw, anc], 0, ops))


def check_backward_factor(label, args32, args64, reps, vs_f64=False):
    """f32: each step of the plain sweep from the kernel's next index; f64:
    whole sweeps. `vs_f64`: the f32 indices also against the f64 plain
    version on the same inputs, at >= AGREE_F32. Returns the result entry."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    name = f"backward_factor_scan[{label}]"
    rf, cf, rb, lw, us, b_T = args32
    picked = CF.backward_factor_scan(*args32)
    nxt = torch.cat([picked[1:], b_T.reshape(1).to(picked.dtype)])

    def plain_steps(args):
        return resynced(rf.shape[0], lambda t: CF.backward_factor_scan_plain(
            *(z[t:t + 1] for z in args), nxt[t]))

    picked_p = plain_steps(args32[:5])
    result = {}
    share, err = agree_f32(name, picked, picked_p)
    if vs_f64:
        picked_u = plain_steps(tuple(z.double() for z in args32[:5]))
        share_u, _ = agree_f32(f"{name} against f64", picked, picked_u)
        log(f"  {name}: f32 kernel indices equal to the f64 plain version's on the same "
            f"inputs: {share_u:.4f} (f32 plain version: "
            f"{float((picked_p == picked_u).double().mean()):.4f})")
        result["index_agree_f64_plain"] = share_u
    err64 = exact_f64(name, CF.backward_factor_scan(*args64),
                      CF.backward_factor_scan_plain(*args64))
    n, N, k = rf.shape
    # Of cf the draws read one row a step: n k values, not n N k.
    least = bound([rf, rb, lw, us, b_T, picked], n * k, n * N * (2 * k + 6))
    result.update({"max_abs_err": err, "index_agree_f32": share, "max_rel_err_f64": err64})
    if N <= CF.WARP_N:  # the first of the sweep's two kernels, alone
        result["pair_scores_ms"] = cuda_ms(lambda: CF.pair_scores(cf, rf, (lw, rb), us), reps)
    return timed(name, result, lambda: CF.backward_factor_scan(*args32),
                 lambda: CF.backward_factor_scan_plain(*args32), reps, least)


def check_block_lane(label, args32, args64, reps, ops_per_particle=None):
    """f32: each step of the plain sweep from the kernel's previous particles
    and carry; f64: whole sweeps. `ops_per_particle`: the operations of one
    particle's step (default: the SV functor's). Returns the result entry."""
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    name = f"block_lane_scan[{label}]"

    def plain(Mt, Gt, *rest):
        return CF.block_lane_scan_plain(Mt.block_propagate, Gt.block_logw, Mt.params,
                                        Gt.params, *rest)

    def plain_step(t):
        sl = slice(t, t + 1)
        return CF.block_lane_scan_plain(
            Mt.block_propagate, Gt.block_logw, tree_map(lambda z: z[sl], Mt.params),
            tree_map(lambda z: z[sl], Gt.params), eps[sl], res_u[sl], x_star[sl],
            x0 if t == 0 else xs[t - 1], w0 if t == 0 else carry(lw[t - 1]))

    Mt, Gt, eps, res_u, x_star, x0, w0 = args32
    xs, lw, anc = CF.block_lane_scan(*args32)
    xs_p, lw_p, anc_p = resynced(eps.shape[0], plain_step)
    same = anc == anc_p
    share, err = agree_f32(name, anc, anc_p, [(lw, lw_p, same),
                                              (xs, xs_p, same[:, None, :].expand_as(xs))])
    xs64, lw64, anc64 = CF.block_lane_scan(*args64)
    xs64_p, lw64_p, anc64_p = plain(*args64)
    err64 = exact_f64(name, anc64, anc64_p, [(lw64, lw64_p), (xs64, xs64_p)])
    n, d, N = eps.shape
    # SV: a particle's step is three d x d mat-vecs and ~20 elementwise operations a component.
    least = bound([eps, res_u, x_star, x0, w0, *Gt.cuda_operands(), xs, lw, anc], 0,
                  n * N * (ops_per_particle or 6 * d * d + 20 * d))
    return timed(name, {"max_abs_err": err, "index_agree_f32": share, "max_rel_err_f64": err64},
                 lambda: CF.block_lane_scan(*args32), lambda: plain(*args32), reps, least)


def timed(name, result, kernel, plain, reps, least):
    """Add the f32 kernel's and plain version's CUDA-event times and the
    call's bound (`least`, from `bound`); log."""
    result["ms"] = cuda_ms(kernel, reps)
    result["plain_ms"] = cuda_ms(plain, 1)
    result.update(least)
    pair = f" (pair scores {result['pair_scores_ms']:.4f})" if "pair_scores_ms" in result else ""
    log(f"  {name}: index agreement f32 {result['index_agree_f32']:.4f}, max abs err f32 "
        f"{result['max_abs_err']:.3e}, f64 rel err {result['max_rel_err_f64']:.3e}; "
        f"kernel {result['ms']:.4f} ms{pair}, plain {result['plain_ms']:.4f} ms, bound "
        f"{result['bound_ms']:.5f} ms by {result['bound_by']} ({result['bytes']} B, "
        f"{result['operations']} operations)")
    return result


def phase_csmc_kernels(dev):
    """The three sweeps against their plain versions: on the inputs of real SV
    steps (T=250, D=30, N=25), and at the larger sizes the TPU served with
    its chunked (factor, N > 1024) and dense (block-lane, N = 1024) kernels."""
    import torch
    f32, f64 = torch.float32, torch.float64
    log(f"phase 4: cSMC sweeps at SV T={SV_T}, D={SV_D}, N={SV_N} (f32: >= {AGREE_F32} of "
        f"indices equal, values to {TOL_F32} where equal; f64: identical indices, "
        f"rtol {RTOL_F64:g})")
    csmc = {dt: sv_sweep_inputs(dev, dt, "csmc", SV_N, seed=4) for dt in (f32, f64)}
    guided = {dt: sv_sweep_inputs(dev, dt, "csmc-guided", SV_N, seed=4) for dt in (f32, f64)}
    label = f"SV T={SV_T} N={SV_N}"
    results = {
        "forward_factor_scan": check_forward_factor(
            label, csmc[f32]["forward_factor_scan"], csmc[f64]["forward_factor_scan"],
            False, reps=20),
        "backward_factor_scan": check_backward_factor(
            label, guided[f32]["backward_factor_scan"], guided[f64]["backward_factor_scan"],
            reps=20),
        "block_lane_scan": check_block_lane(
            label, guided[f32]["block_lane_scan"], guided[f64]["block_lane_scan"], reps=20),
    }
    check_forward_factor(label, csmc[f32]["forward_factor_scan"],
                         csmc[f64]["forward_factor_scan"], True, reps=20)
    check_backward_factor(label + " csmc", csmc[f32]["backward_factor_scan"],
                          csmc[f64]["backward_factor_scan"], reps=20)

    n, N = 1023, 4096
    log(f"  factor sweeps at T={n + 1}, N={N}, k=1 (random inputs):")
    args64 = random_factor_inputs(dev, n, N, 1, seed=5)
    args32 = tuple(z.float() for z in args64)
    for pgas in (False, True):
        check_forward_factor(f"T={n + 1} N={N}", args32, args64, pgas, reps=3)
    b_T = torch.tensor(3, device=dev)
    bwd64 = args64[:3] + (args64[3], args64[5], b_T)
    check_backward_factor(f"T={n + 1} N={N}", tuple(z.float() for z in bwd64[:5]) + (b_T,),
                          bwd64, reps=3)
    # The one-warp path's edges: one particle, and a full warp.
    n, k = 255, 64
    for N in (1, 32):
        log(f"  factor sweeps at T={n + 1}, N={N}, k={k} (random inputs):")
        args64 = random_factor_inputs(dev, n, N, k, seed=7 + N)
        args32 = tuple(z.float() for z in args64)
        for pgas in (False, True):
            check_forward_factor(f"T={n + 1} N={N}", args32, args64, pgas, reps=3)
        b_T = torch.tensor(N - 1, device=dev)
        bwd64 = args64[:3] + (args64[3], args64[5], b_T)
        check_backward_factor(f"T={n + 1} N={N}", tuple(z.float() for z in bwd64[:5]) + (b_T,),
                              bwd64, reps=3)

    big = {dt: sv_sweep_inputs(dev, dt, "csmc-guided", 1024, seed=6) for dt in (f32, f64)}
    check_block_lane(f"SV T={SV_T} N=1024", big[f32]["block_lane_scan"],
                     big[f64]["block_lane_scan"], reps=3)
    return results


def phase_csmc_step_reference(dev):
    """Two f64 aux-cSMC steps of each SV style (T=32, D=4, N=16, backward
    sampling, gradient shift off and on) on the card against the CPU, given
    the same noise; the card's steps must have launched their sweeps."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import cuda as K

    T_, D_, N_ = 32, 4, 16
    xs, ys = sv.get_data(*SV_PARAMS, D_, T_, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    rng = np.random.default_rng(5)
    delta = rng.uniform(0.2, 1.0, T_)
    sweeps = {"csmc": ("forward_factor_scan", "backward_factor_scan"),
              "csmc-guided": ("block_lane_scan", "backward_factor_scan")}
    for style, used in sweeps.items():
        for gradient in (False, True):
            noises = [(rng.standard_normal((T_, D_)), rng.standard_normal((N_, D_)),
                       rng.uniform(size=(T_ - 1, N_)), rng.standard_normal((T_ - 1, N_, D_)),
                       rng.uniform(size=T_ - 1), rng.uniform(size=T_)) for _ in range(2)]
            runs = {}
            for where in ("cpu", dev):
                init, kernel = sv_kernel(style, ys.to(where), N_, gradient)
                state = init(xs.to(where))
                K.reset_launches()
                out = []
                for noise in noises:
                    state = kernel(state, torch.as_tensor(delta, device=where),
                                   noise=tuple(torch.as_tensor(z, device=where) for z in noise))
                    out.append((state.x.cpu(), state.updated.cpu()))
                runs[str(where)] = out
            launches = K.launches()
            for name in CSMC_KERNELS:
                per_step = FACTOR_LAUNCHES if name.endswith("factor_scan") else 1
                want = len(noises) * per_step if name in used else 0
                if launches[name] != want:
                    raise AssertionError(f"{style}: {name} launched {launches[name]} times on "
                                         f"the card, expected {want}")
            worst = 0.0
            for (xc, uc), (xg, ug) in zip(runs["cpu"], runs[str(dev)]):
                if not torch.equal(uc, ug):
                    raise AssertionError(f"{style}: `updated` differs between card and CPU")
                worst = max(worst, float(((xg - xc).abs() / (1 + xc.abs())).max()))
            log(f"  {style} gradient={gradient}, T={T_}, D={D_}, N={N_}, f64: card vs CPU "
                f"rel err {worst:.3e} (bound {RTOL_F64:g})")
            if not worst <= RTOL_F64:
                raise AssertionError(f"{style}: card and CPU steps differ by {worst:.3e}")


def sv_chain(dev, label, style, ys, x0, cfg, delta_init, gradient, seed, per_iter):
    """run_chain of the SV sampler `style` on the card from x0; checks a finite
    state and the exact sweep launches per iteration (`per_iter`). Returns
    (mean update rate of the sampling phase, samples/s, launches, result)."""
    import torch
    from aux_ssm_tpu_torch.experiments import runner
    from aux_ssm_tpu_torch.ops import cuda as K

    init, kernel = sv_kernel(style, ys, SV_N, gradient)
    gen = torch.Generator(device=dev).manual_seed(seed)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = runner.run_chain(kernel, init(x0), cfg, generator=gen, delta_init=delta_init)
    launches = K.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_iter = max(cfg.burnin, 1) + cfg.n_samples
    if tuple(res.state.x.shape) != tuple(x0.shape) or not bool(torch.isfinite(res.state.x).all()):
        raise AssertionError(f"{label}: the chain's state is not finite")
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"{label}: {name} launched {count} times in {n_iter} "
                                 f"iterations, expected {per_iter.get(name, 0)} per iteration")
    rate = float(res.stats.accept_cum.mean())
    sps = cfg.n_samples / res.sampling_time
    log(f"  {label}: {n_iter} iterations, mean update rate {rate:.4f}, {sps:.2f} samples/s, "
        f"launches {({k: v for k, v in launches.items() if v})}")
    return rate, sps, launches, res


def phase_sv_chains(dev):
    """Phases 6 and 7; returns the sweeps' launches summed over the chains."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig

    f32 = torch.float32
    total = dict.fromkeys(CSMC_KERNELS, 0)
    guided_iter = {"block_lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES}
    log(f"phase 6: csmc-guided, T={SV_T}, D={SV_D}, N={SV_N}, f32, frozen committed delta, "
        f"from xs_true")
    for gradient in (False, True):
        name = "csmc_guided_gradient" if gradient else "csmc_guided_no-gradient"
        ys, xs, delta = load_sv(name, dev, f32)
        rate, _, launches, _ = sv_chain(
            dev, f"csmc-guided gradient={gradient}", "csmc-guided", ys, xs,
            RunConfig(n_samples=200, burnin=100, learning_rate=0.0), delta, gradient,
            seed=10 + gradient, per_iter=guided_iter)
        if not 0.4 <= rate <= 0.6:
            raise AssertionError(f"csmc-guided gradient={gradient}: update rate {rate:.4f} "
                                 "outside [0.4, 0.6]")
        for k in total:
            total[k] += launches[k]

    log(f"phase 7: csmc (sequential sweep), T={SV_T}, D={SV_D}, N={SV_N}, f32, (T,) delta "
        "adapted from 1e-2 toward 0.5, from xs_true")
    ys, xs, _ = load_sv("csmc_no-gradient", dev, f32)
    rate, _, launches, res = sv_chain(
        dev, "csmc", "csmc", ys, xs, RunConfig(n_samples=100, burnin=200, target_alpha=0.5),
        torch.full((SV_T,), 1e-2, dtype=f32, device=dev), False, seed=12,
        per_iter=dict.fromkeys(("forward_factor_scan", "backward_factor_scan"), FACTOR_LAUNCHES))
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"csmc: update rate {rate:.4f} outside (0, 1)")
    log(f"  csmc: adapted delta in [{float(res.delta.min()):.4e}, {float(res.delta.max()):.4e}]")
    for k in total:
        total[k] += launches[k]
    return total


# ---------------------------------------------------------------------------
# The scalar-state particle-Gibbs path: theta-logistic PGAS and rare-event
# ---------------------------------------------------------------------------

TL_T, TL_N = 256, 256                   # theta-logistic PGAS (benchmarks/particle_ess.py)
RE_CELL = (5.0, 0.8, 0.5, 2)            # y, rho, r2, T: tests/test_models_rare_event.py
RE_N = 25                               # benchmarks/rare_event_sweep.sh
# A rare-event kalman step, one cell (M = 1) or M cells: the batched scalar
# layout's scans, whatever M is.
RE_KALMAN_LAUNCHES = {"scalar_filter_scan": 2, "scalar_affine_scan": 1}


def lane_plain(Mt, Gt, Pt, *rest):
    """`lane_scan_plain` on a model, as the wrapper calls it for a CPU tensor."""
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    return CF.lane_scan_plain(Mt.lane_propagate, Gt.lane_logw,
                              None if Pt is None else Pt.lane_logpdf, Mt.params, Gt.params,
                              None if Pt is None else Pt.params, *rest)


def check_lane(label, args32, args64, reps):
    """f32: each step of the plain sweep from the kernel's previous particles
    and carry; f64: whole sweeps. Returns the result entry."""
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    Mt, Gt, Pt, eps, res_u, anc_u, x_star, x0, w0 = args32
    name = f"lane_scan[{label}, pgas={Pt is not None}]"

    def plain_step(t):
        sl = slice(t, t + 1)
        mt_p, gt_p = (tree_map(lambda z: z[sl], m.params) for m in (Mt, Gt))
        return CF.lane_scan_plain(
            Mt.lane_propagate, Gt.lane_logw, None if Pt is None else Pt.lane_logpdf, mt_p, gt_p,
            None if Pt is None else mt_p, eps[sl], res_u[sl], anc_u[sl], x_star[sl],
            x0 if t == 0 else xs[t - 1], w0 if t == 0 else carry(lw[t - 1]))

    xs, lw, anc = CF.lane_scan(*args32)
    xs_p, lw_p, anc_p = resynced(eps.shape[0], plain_step)
    same = anc == anc_p
    share, err = agree_f32(name, anc, anc_p, [(lw, lw_p, same), (xs, xs_p, same)])
    xs64, lw64, anc64 = CF.lane_scan(*args64)
    xs64_p, lw64_p, anc64_p = lane_plain(*args64)
    err64 = exact_f64(name, anc64, anc64_p, [(lw64, lw64_p), (xs64, xs64_p)])
    n, N = eps.shape
    # A particle's step: an ancestor search, the model's propagate and weight
    # (~25 operations, an exp and a log or two among them), its share of the
    # prefix sum and the softmax (and the ancestor score under PGAS).
    ops = n * N * (40 + math.log2(N) + (Pt is not None) * 30)
    least = bound([eps, res_u, anc_u, x_star, x0, w0, *Gt.cuda_operands(), xs, lw, anc], 0, ops)
    return timed(name, {"max_abs_err": err, "index_agree_f32": share, "max_rel_err_f64": err64},
                 lambda: CF.lane_scan(*args32), lambda: lane_plain(*args32), reps, least)


def random_lane_inputs(dev, dtype, n, N, seed):
    """Lane-sweep inputs (eps, res_u, anc_u, x_star, x0, w0) around x = 1."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=torch.float64)
    w0 = 0.1 + 0.9 * torch.rand(N, **kw)
    return tuple(z.to(dtype) for z in (
        torch.randn(n, N, **kw), torch.rand(n, N, **kw), torch.rand(n, **kw),
        1.0 + 0.5 * torch.randn(n, **kw), 1.0 + 0.5 * torch.randn(N, **kw), w0 / w0.sum()))


def theta_data(dev, dtype, T=None):
    """(xs, ys) of the theta-logistic model from a fixed seed, T=256 by default."""
    import torch
    from aux_ssm_tpu_torch.models import theta_logistic as tl
    return tl.get_data(T or TL_T, generator=torch.Generator().manual_seed(0), dtype=dtype, device=dev)


def rare_kernel(style, cell, dev, N=RE_N):
    """(init, kernel) of the f64 rare-event sampler `style` at `cell`."""
    import torch
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind
    from aux_ssm_tpu_torch.models import rare_event as rev
    y, rho, r2, T_ = cell
    kw = dict(dtype=torch.float64, device=dev)
    gradient = style.endswith("-grad")
    if style.startswith("csmc-pit"):
        return ind.get_kernel(*rev.get_feynman_kac(y, rho, r2, T_, **kw), N, parallel=True,
                              gradient=gradient,
                              draws="fused" if style.endswith("-fused") else "joint")
    if style.startswith("kalman"):
        return rev.get_kalman_kernel(y, rho, r2, T_, True, gradient=gradient, **kw)
    if style.startswith("csmc-guided"):
        return rev.get_guided_csmc_kernel(y, rho, r2, T_, N, backward=True, gradient=gradient,
                                          **kw)
    return rev.get_csmc_kernel(y, rho, r2, T_, N, backward=True, gradient=gradient, **kw)


def phase_lane_kernel(dev):
    """Phase 8; returns the lane sweep's result entry (theta-logistic, PGAS,
    at the main path's T=256, N=256)."""
    import torch
    from aux_ssm_tpu_torch.models import ar1_gauss, rare_event as rev, theta_logistic as tl
    f32, f64 = torch.float32, torch.float64
    log(f"phase 8: the lane sweep against its plain version (f32: >= {AGREE_F32} of ancestors "
        f"equal step by step, values to {TOL_F32} where equal; f64: identical ancestors, "
        f"rtol {RTOL_F64:g})")

    seen = {}
    for dt in (f32, f64):  # the inputs of a real PGAS step from the data's neighbourhood
        xs, ys = theta_data(dev, dt)
        init, kernel = tl.get_pgas_kernel(ys, TL_N)
        with recording_sweeps() as rec:
            kernel(init(xs), generator=torch.Generator(device=dev).manual_seed(8))
        seen[dt] = rec["lane_scan"]
    label = f"theta-logistic T={TL_T} N={TL_N}"
    result = check_lane(label, seen[f32], seen[f64], reps=20)
    no_pgas = {dt: a[:2] + (None,) + a[3:] for dt, a in seen.items()}
    check_lane(label, no_pgas[f32], no_pgas[f64], reps=20)
    # The edges of the one-warp and block paths on the same model: N=1 (the
    # chain's floor), N=33 and N=1024.
    for N in (1, 33, 1024):
        edge = {dt: a[:3] + random_lane_inputs(dev, dt, TL_T - 1, N, seed=12)
                for dt, a in seen.items()}
        check_lane(f"theta-logistic T={TL_T} N={N}", edge[f32], edge[f64], reps=20)

    n, N = 1023, 4096
    for pgas in (False, True):
        args = {}
        for dt in (f32, f64):
            _, _, Mt, Gt = ar1_gauss.get_feynman_kac(torch.zeros(n, 1, dtype=dt, device=dev))
            args[dt] = (Mt, Gt, Mt if pgas else None) + random_lane_inputs(dev, dt, n, N, seed=9)
        check_lane(f"AR(1) toy T={n + 1} N={N}", args[f32], args[f64], reps=3)

    y, rho, r2, T_ = RE_CELL
    for style in ("csmc-guided", "csmc-guided-grad"):  # the inputs of a real step, T=2
        seen = {}
        for dt in (f32, f64):
            init, kernel = rev.get_guided_csmc_kernel(y, rho, r2, T_, RE_N, backward=True,
                                                      gradient=style.endswith("-grad"),
                                                      dtype=dt, device=dev)
            x0 = torch.tensor([[3.0], [3.4]], dtype=dt, device=dev)
            with recording_sweeps() as rec:
                kernel(init(x0), 1.0, generator=torch.Generator(device=dev).manual_seed(10))
            seen[dt] = rec["lane_scan"]
        check_lane(f"rare-event {style} T={T_} N={RE_N}", seen[f32], seen[f64], reps=20)
        pgas = {dt: a[:2] + (a[0],) + a[3:] for dt, a in seen.items()}
        check_lane(f"rare-event {style} T={T_} N={RE_N}", pgas[f32], pgas[f64], reps=20)
    for T_b in (2, 9):
        for pgas in (False, True):
            args = {}
            for dt in (f32, f64):
                _, _, Mt, Gt = rev.get_feynman_kac(y, rho, r2, T_b, dtype=dt, device=dev)
                args[dt] = (Mt, Gt, Mt if pgas else None) + random_lane_inputs(
                    dev, dt, T_b - 1, RE_N, seed=11)
            check_lane(f"rare-event bootstrap T={T_b} N={RE_N}", args[f32], args[f64], reps=20)
    return result


def as_noise(z, where, dtype="float64"):
    """A step's noise (NumPy, nested in tuples and lists) as tensors on
    `where`: floats in `dtype`, integers (the PIT level seeds) in int32."""
    import numpy as np
    import torch
    if isinstance(z, (tuple, list)):
        return type(z)(as_noise(v, where, dtype) for v in z)
    if np.issubdtype(np.asarray(z).dtype, np.integer):
        return torch.as_tensor(np.asarray(z), dtype=torch.int32, device=where)
    return torch.as_tensor(z, dtype=getattr(torch, dtype), device=where)


def steps_on_both(label, build, state0, delta, noises, dev, used, dtype="float64",
                  bound=RTOL_F64):
    """The steps of `build(where) -> (init, kernel)` in `dtype` (state0's)
    on the card and on the CPU from the same state and noise: `updated`
    identical, states to `bound` (|card - CPU| / (1 + |CPU|)); the card's
    steps launched each wrapper of `used` once a step (`used` a tuple), or
    `used[name]` times a step and no other wrapper at all (`used` a dict)."""
    import torch
    from aux_ssm_tpu_torch.ops import cuda as K
    runs = {}
    for where in ("cpu", dev):
        init, kernel = build(where)
        state = init(state0.to(where))
        K.reset_launches()
        out = []
        for noise in noises:
            noise = as_noise(noise, where, dtype)
            args = () if delta is None else (torch.as_tensor(delta, dtype=getattr(torch, dtype),
                                                             device=where),)
            state = kernel(state, *args, noise=noise)
            out.append((state.x.cpu(), state.updated.cpu()))
        runs[str(where)] = out
    launches = K.launches()
    want = used if isinstance(used, dict) else {name: 1 for name in used}
    for name in (launches if isinstance(used, dict) else used):
        if launches[name] != want.get(name, 0) * len(noises):
            raise AssertionError(f"{label}: {name} launched {launches[name]} times on the "
                                 f"card, expected {want.get(name, 0) * len(noises)}")
    worst = 0.0
    for (xc, uc), (xg, ug) in zip(runs["cpu"], runs[str(dev)]):
        if not torch.equal(uc, ug):
            raise AssertionError(f"{label}: `updated` differs between card and CPU")
        worst = max(worst, float(((xg - xc).abs() / (1 + xc.abs())).max()))
    log(f"  {label}, {dtype}: card vs CPU rel err {worst:.3e} (bound {bound:g})")
    if not worst <= bound:
        raise AssertionError(f"{label}: card and CPU steps differ by {worst:.3e}")


def phase_scalar_step_reference(dev):
    """Phase 9: f64 steps on the card against the CPU, given the same noise."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.models import theta_logistic as tl

    T_, N_ = 64, 64
    xs, ys = theta_data("cpu", torch.float64, T_)
    rng = np.random.default_rng(9)

    def csmc_noise(T_, N_, aux):
        head = (rng.standard_normal((T_, 1)),) if aux else ()
        return head + (rng.standard_normal((N_, 1)), rng.uniform(size=(T_ - 1, N_)),
                       rng.standard_normal((T_ - 1, N_, 1)), rng.uniform(size=T_ - 1),
                       rng.uniform(size=T_))

    for ancestor_sampling in (False, True):
        for backward in (False, True):
            steps_on_both(
                f"theta-logistic PGAS step T={T_} N={N_} ancestor_sampling={ancestor_sampling} "
                f"backward={backward}",
                lambda where: tl.get_pgas_kernel(ys.to(where), N_, backward=backward,
                                                 ancestor_sampling=ancestor_sampling),
                xs, None, [csmc_noise(T_, N_, aux=False) for _ in range(2)], dev,
                ("lane_scan",) + (("backward_factor_scan",) if backward else ()))

    sweeps = {"csmc": {"forward_factor_scan": FACTOR_LAUNCHES,
                       "backward_factor_scan": FACTOR_LAUNCHES},
              "csmc-guided": {"lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES}}
    for T_ in (2, 6):
        cell = RE_CELL[:3] + (T_,)
        x0 = torch.as_tensor(3.0 + rng.standard_normal((T_, 1)))
        for style in ("kalman", "kalman-grad", "csmc", "csmc-guided", "csmc-guided-grad"):
            if style.startswith("kalman"):
                delta = 0.7
                noises = [(rng.standard_normal((T_, 1)), rng.standard_normal((T_, 1)),
                           rng.uniform()) for _ in range(2)]
                used = RE_KALMAN_LAUNCHES
            else:
                delta = rng.uniform(0.3, 1.5, T_)
                noises = [csmc_noise(T_, RE_N, aux=True) for _ in range(2)]
                used = sweeps[style.removesuffix("-grad")]
            steps_on_both(f"rare-event {style} step T={T_} N={RE_N}",
                          lambda where: rare_kernel(style, cell, where), x0, delta, noises, dev,
                          used)


def profile_steps(label, step, n=30, also=()):
    """Where `n` calls of `step()` spend their time, through torch.profiler:
    wall ms a call, the device's busy ms a call (the sum of its kernels' times,
    one stream) with its share of the wall, kernel launches a call, the
    kernels that take most of the device time and those whose name holds one
    of `also`. Printed; nothing is bounded. Returns the kernels' profiler
    events (none where the profiler sees no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - tic) / n
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if not busy_ms:
        log(f"  profile, {label}: {wall_ms:.3f} ms a step; device time not visible to the "
            "profiler: not measured")
        return []
    launched = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")) / n
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms x{e.count / n:.0f}"
                    for e in kernels[:4] + [e for e in kernels[4:]
                                            if any(name in e.key for name in also)])
    log(f"  profile, {label}: {wall_ms:.3f} ms a step under the profiler, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.0f}%), {launched:.0f} kernel launches a "
        f"step; most device time: {top}")
    return kernels


def interior_ess(samples, max_coords=64):
    """Mean ESS over up to `max_coords` interior trajectory coordinates (the
    middle half of time, strided), the recipe of benchmarks/particle_ess.py."""
    import numpy as np
    from aux_ssm_tpu_torch.utils.ess import effective_sample_size
    T_ = samples.shape[1]
    stride = max(1, (T_ // 2) // 16)
    mid = samples[:, T_ // 4: 3 * T_ // 4: stride, :]
    flat = mid.reshape(mid.shape[0], -1)
    idx = np.unique(np.linspace(0, flat.shape[1] - 1, max_coords).astype(int))
    return float(np.mean([float(effective_sample_size(flat[:, i])) for i in idx]))


def phase_theta_chain(dev, card):
    """Phase 10; returns the one-chain and C = 1 runs' launches, and the
    batched C-chain run's (`theta_chains`)."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.models import theta_logistic as tl
    from aux_ssm_tpu_torch.ops import cuda as K

    burnin, n_samples = 300, 600
    log(f"phase 10: theta-logistic PGAS, T={TL_T}, N={TL_N}, f32, {burnin} + {n_samples} "
        "iterations from x = 0, ancestor sampling and ancestor tracing; then C = "
        f"{TL_CHAINS} chains as one batched step")
    _, ys = theta_data(dev, torch.float32)
    init, kern = tl.get_pgas_kernel(ys, TL_N, ancestor_sampling=True)
    # Bootstrap PGAS has no step size; the runner's delta is ignored.
    K.reset_launches()
    res = runner.run_chain(lambda state, delta, generator=None: kern(state, generator=generator),
                           init(torch.zeros_like(ys)), RunConfig(n_samples=n_samples,
                                                                 burnin=burnin),
                           generator=torch.Generator(device=dev).manual_seed(13),
                           collect_samples=True, delta_init=torch.ones(TL_T, device=dev))
    launches = K.launches()
    if launches["lane_scan"] != burnin + n_samples or any(
            v for k, v in launches.items() if k != "lane_scan"):
        raise AssertionError(f"theta-logistic: launches {launches}, expected exactly one lane "
                             f"sweep in each of {burnin + n_samples} iterations")
    if res.samples.shape != (n_samples, TL_T, 1) or not bool(torch.isfinite(res.state.x).all()):
        raise AssertionError("theta-logistic: the chain's state is not finite")
    rate = float(res.stats.accept_cum.mean())
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"theta-logistic: update rate {rate:.4f} outside (0, 1)")
    ess = interior_ess(res.samples)
    # The posterior mean must track the data (sig_y = 0.1) once the chain has mixed.
    gap = float((res.stats.mean_x - ys).abs().mean())
    log(f"  theta-logistic PGAS: update rate {rate:.4f}, {n_samples / res.sampling_time:.2f} "
        f"samples/s, mean interior ESS {ess:.1f} of {n_samples}, "
        f"{ess / res.sampling_time:.2f} ESS/s, mean |E x - y| {gap:.4f}")
    if not gap < 0.3:
        raise AssertionError(f"theta-logistic: posterior mean {gap:.4f} away from the data")
    gen, box = torch.Generator(device=dev).manual_seed(14), [res.state]
    profile_steps("theta-logistic PGAS", lambda: box.__setitem__(0, kern(box[0], generator=gen)))
    return launches, theta_chains(dev, card, ys, launches)


def rare_chain(dev, style, cell, burnin, n_samples, seed, N, per_iter):
    """run_chain of the f64 rare-event sampler `style` at `cell` with N
    particles, delta adapted from 0.5 toward an update rate of 0.5: the
    posterior mean and standard deviation of x_0 and x_{T-1} must lie within
    6 Monte-Carlo standard errors (from the ESS at the known variance) of the
    closed form, and each wrapper launch `per_iter[name]` times a step.
    Returns the chain's launches."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.models import rare_event as rev
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.utils.ess import effective_sample_size

    y, rho, r2, T_ = cell
    gen = torch.Generator(device=dev).manual_seed(seed)
    init, kernel = rare_kernel(style, cell, dev, N)
    x0 = rev.init_x(y, rho, r2, T_, generator=gen, dtype=torch.float64, device=dev)
    delta0 = torch.full((T_,) if "csmc" in style else (), 0.5, dtype=torch.float64, device=dev)
    K.reset_launches()
    res = runner.run_chain(kernel, init(x0), RunConfig(n_samples=n_samples, burnin=burnin,
                                                       target_alpha=0.5),
                           generator=gen, collect_samples=True, delta_init=delta0)
    launches = K.launches()
    n_iter = burnin + n_samples
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"rare-event {style}: {name} launched {count} times in "
                                 f"{n_iter} iterations, expected {per_iter.get(name, 0)} each")
    rate = float(res.stats.accept_cum.mean())
    moments = rev.conditional_moments(y, rho, r2, T_)
    parts, ok = [], True
    for which, col, (mean, var) in (("x_0", 0, moments[0]), ("x_T-1", -1, moments[1])):
        chain = res.samples[:, col, 0]
        ess = float(effective_sample_size(chain, known_variance=var))
        err_mean = (chain.mean() - mean) / np.sqrt(var)
        err_std = (chain.std() - np.sqrt(var)) / np.sqrt(var)
        tol_mean, tol_std = 6.0 / np.sqrt(ess), 6.0 / np.sqrt(2.0 * ess)
        ok = ok and abs(err_mean) <= tol_mean and abs(err_std) <= tol_std
        parts.append(f"{which}: ESS {ess:.0f}, mean err {err_mean:+.4f} sd (tol {tol_mean:.4f}), "
                     f"std err {err_std:+.4f} (tol {tol_std:.4f})")
    log(f"  {style} at rho={rho}, r2={r2}, T={T_}, N={N}: update rate {rate:.4f}, "
        f"{n_samples / res.sampling_time:.2f} samples/s, delta "
        f"[{float(res.delta.min()):.3e}, {float(res.delta.max()):.3e}]; " + "; ".join(parts))
    if not bool(torch.isfinite(res.state.x).all()) or not np.isfinite(res.samples).all():
        raise AssertionError(f"rare-event {style}: the chain's state is not finite")
    if not (ok and 0.0 < rate < 1.0):
        raise AssertionError(f"rare-event {style}: moments outside the ESS-scaled tolerance of "
                             "the closed form, or update rate outside (0, 1)")
    if not style.endswith("-grad"):
        box = [res.state]
        profile_steps(f"rare-event {style}",
                      lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)))
    return launches


# ---------------------------------------------------------------------------
# The spatio-temporal Student-t path: batched scalar filters, csmc, csmc-guided
# ---------------------------------------------------------------------------

SP_PARAMS = (0.3, 4.0, -0.25, 1)   # sigma_x, nu, tau, r_y of experiments/spatial.py
SP_T, SP_D, SP_N = 1024, 8, 25     # benchmarks/spatial_sweep.sh
SP_SEED = 42
SP_DELTA0 = 1e-2                   # published: 1e-5, with a 2500-iteration burn-in
# style -> (burn-in, samples, target update rate); published: 2500 + 10000.
SPATIAL_SCHEDULE = {"kalman-1": (100, 200, 0.5), "kalman-2": (100, 200, 0.5),
                    "csmc": (100, 200, 0.25), "csmc-guided": (100, 200, 0.25),
                    "csmc-guided-grad": (100, 200, 0.25)}
# The pair held against each other, from an exact posterior draw.
SPATIAL_PAIR = {"kalman-1": (300, 700, 0.5), "csmc-guided": (300, 700, 0.25)}  # two chains each
SP_BLOCKS = 16                     # time blocks of the pooled functionals
Z_MAX, Z_RMS = 6.0, 1.5            # bounds on z-scores against one posterior draw
Z_RMS_CROSS = 2.0                  # on the RMS z between the two samplers
SP_PER_ITER = {"kalman": {"scalar_filter_scan": 2, "scalar_affine_scan": 1},
               "csmc": {"forward_factor_scan": FACTOR_LAUNCHES,
                        "backward_factor_scan": FACTOR_LAUNCHES},
               "csmc-guided": {"block_lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES}}


def spatial_per_iter(style):
    """The kernel launches of one step of `style`, by wrapper."""
    return SP_PER_ITER["kalman" if style.startswith("kalman") else style.removesuffix("-grad")]


def spatial_kernel(style, ys, D, N):
    """(init, kernel) of the spatial sampler `style` (cSMC styles with
    backward sampling)."""
    from aux_ssm_tpu_torch.models import spatial as sp
    sigma_x, nu, tau, r_y = SP_PARAMS
    common = (ys, sigma_x, nu, tau, r_y, D)
    if style.startswith("kalman"):
        return sp.get_kalman_kernel(*common, parallel=True, order=int(style[-1]))
    if style == "csmc-pit":
        return sp.get_csmc_kernel(*common, N, parallel=True)
    get = sp.get_guided_csmc_kernel if style.startswith("csmc-guided") else sp.get_csmc_kernel
    return get(*common, N, backward=True, gradient=style.endswith("-grad"))


def spatial_data(dev, dtype, T=None, D=None, seed=SP_SEED):
    """(xs_true, ys) of `get_data`, each (T, D * D); the published size by default."""
    import numpy as np
    from aux_ssm_tpu_torch.models import spatial as sp
    sigma_x, nu, tau, r_y = SP_PARAMS
    return sp.get_data(np.random.default_rng(seed), sigma_x, r_y, tau, nu, D or SP_D, T or SP_T,
                       dtype=dtype, device=dev)


@contextlib.contextmanager
def recording_scalar_scans():
    """Record the arguments the batched-layout filter and sampler hand the two
    scalar scans; the calls go through and count as usual."""
    import importlib
    from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS
    seen = {}
    homes = {"scalar_filter_scan": importlib.import_module("aux_ssm_tpu_torch.ops.filtering"),
             "scalar_affine_scan": importlib.import_module("aux_ssm_tpu_torch.ops.sampling")}

    def recorder(name):
        fn = getattr(SS, name)

        def record(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return record

    for name, mod in homes.items():
        setattr(mod, name, recorder(name))
    try:
        yield seen
    finally:
        for name, mod in homes.items():
            setattr(mod, name, getattr(SS, name))


def phase_scalar_scans(dev):
    """Phase 12; returns the two scans' result entries at T=1024, B=64."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS
    f32 = torch.float32
    B = SP_D * SP_D
    log(f"phase 12: scalar scans on a spatial kalman-1 step's inputs, T={SP_T}, B={B} (f32; "
        f"bounds: nrel {NREL_F32:g} vs plain f32 and f64, {NREL_F64:g} f64 kernel vs f64 plain)")
    xs, ys = spatial_data(dev, f32)
    init, kernel = spatial_kernel("kalman-1", ys, SP_D, SP_N)
    with recording_scalar_scans() as seen:
        kernel(init(xs), SP_DELTA0, generator=torch.Generator(device=dev).manual_seed(12))
    (elems,), _ = seen["scalar_filter_scan"]
    (gains, incs), kwargs = seen["scalar_affine_scan"]
    elems = tuple(z.contiguous() for z in elems)
    if elems[0].shape != (SP_T - 1, B) or incs.shape != (SP_T, B) or not kwargs.get("reverse"):
        raise AssertionError("the kalman step did not hand the scans the expected inputs")

    # One combine: a reciprocal and ~19 multiply-adds of the filter's five
    # values, 3 of the affine map's two; a scan of n needs n - 1 a column.
    def filter_ops(n, b):
        return (n - 1) * b * 20

    def affine_ops(n, b):
        return (n - 1) * b * 3

    results = {
        "scalar_filter_scan": compare("scalar_filter_scan", SS.scalar_filter_scan,
                                      SS.scalar_filter_scan_plain, (elems,),
                                      filter_ops(SP_T - 1, B), reps=50),
        "scalar_affine_scan": compare("scalar_affine_scan", SS.scalar_affine_scan,
                                      SS.scalar_affine_scan_plain, (gains, incs, True),
                                      affine_ops(SP_T, B), reps=50),
    }
    log("  forward affine scan, and both scans at T=300 (the TPU's block Hillis-Steele range), "
        "at n=1 and on a 64 x 64 field (B=4096):")
    compare("scalar_affine_scan_forward", SS.scalar_affine_scan, SS.scalar_affine_scan_plain,
            (gains, incs, False), affine_ops(SP_T, B))
    for label, cut in (("T300", lambda z: z[:299].contiguous()),
                       ("n1", lambda z: z[:1].contiguous()),
                       ("B4096", lambda z: z.repeat(1, 64))):
        e, g, i = tuple(cut(z) for z in elems), cut(gains[1:]), cut(incs[1:])
        n, b = i.shape
        compare(f"scalar_filter_scan_{label}", SS.scalar_filter_scan, SS.scalar_filter_scan_plain,
                (e,), filter_ops(n, b))
        compare(f"scalar_affine_scan_{label}", SS.scalar_affine_scan, SS.scalar_affine_scan_plain,
                (g, i, True), affine_ops(n, b))
    return results


def phase_spatial_sweeps(dev):
    """Phase 13; returns {wrapper: {style: result entry}} at T=1024, N=25 and
    d = k = 64, on the inputs of one real step of each spatial cSMC style."""
    import torch
    f32, f64 = torch.float32, torch.float64
    d = SP_D * SP_D
    log(f"phase 13: the spatial cSMC styles' sweeps on a real step's inputs, T={SP_T}, "
        f"d=k={d}, N={SP_N} (block-lane sweep with the functor SpatialGuided; factor sweeps)")
    results = {name: {} for name in ("block_lane_scan", "forward_factor_scan",
                                     "backward_factor_scan")}
    for style in ("csmc", "csmc-guided", "csmc-guided-grad"):
        seen = {}
        for dt in (f32, f64):
            xs, ys = spatial_data(dev, dt)
            init, kernel = spatial_kernel(style, ys, SP_D, SP_N)
            with recording_sweeps() as rec:
                kernel(init(xs), torch.full((SP_T,), SP_DELTA0, dtype=dt, device=dev),
                       generator=torch.Generator(device=dev).manual_seed(13))
            seen[dt] = rec
        for name in ("forward_factor_scan", "backward_factor_scan"):
            if name in seen[f32] and tuple(seen[f32][name][0].shape) != (SP_T - 1, SP_N, d):
                raise AssertionError(f"{name}: the {style} step handed it factors of shape "
                                     f"{tuple(seen[f32][name][0].shape)}")
        label = f"spatial {style} T={SP_T} N={SP_N}"
        if style == "csmc":
            results["forward_factor_scan"][style] = check_forward_factor(
                label, seen[f32]["forward_factor_scan"], seen[f64]["forward_factor_scan"],
                False, reps=10, vs_f64=True)
        else:
            # A particle's step: the quadratic form's product with P (and the
            # gradient shift's), 2 operations a nonzero of P, and ~40
            # elementwise operations a component.
            matvecs = 2 if style.endswith("-grad") else 1
            nnz = int((seen[f32]["block_lane_scan"][1].c.prec != 0).sum())
            results["block_lane_scan"][style] = check_block_lane(
                label, seen[f32]["block_lane_scan"], seen[f64]["block_lane_scan"], reps=10,
                ops_per_particle=2 * matvecs * nnz + 40 * d)
        if style != "csmc-guided-grad":  # its backward sweep has the guided style's shapes
            results["backward_factor_scan"][style] = check_backward_factor(
                label, seen[f32]["backward_factor_scan"], seen[f64]["backward_factor_scan"],
                reps=10, vs_f64=True)
    return results


def phase_spatial_step_reference(dev):
    """Phase 14: f64 spatial steps on the card against the CPU, given the same
    noise (T=32, a 3 x 3 grid, N=16)."""
    import numpy as np
    import torch
    T_, D_, N_ = 32, 3, 16
    B_ = D_ * D_
    xs, ys = spatial_data("cpu", torch.float64, T_, D_, seed=14)
    rng = np.random.default_rng(14)
    x0 = xs + torch.as_tensor(0.2 * rng.standard_normal((T_, B_)))
    for style in SPATIAL_SCHEDULE:
        if style.startswith("kalman"):
            delta = 0.05
            noises = [(rng.standard_normal((T_, B_, 1)), rng.standard_normal((T_, B_, 1)),
                       rng.uniform()) for _ in range(2)]
        else:
            delta = rng.uniform(0.05, 0.3, T_)
            noises = [(rng.standard_normal((T_, B_)), rng.standard_normal((N_, B_)),
                       rng.uniform(size=(T_ - 1, N_)), rng.standard_normal((T_ - 1, N_, B_)),
                       rng.uniform(size=T_ - 1), rng.uniform(size=T_)) for _ in range(2)]
        steps_on_both(f"spatial {style} step T={T_} D={D_} N={N_}",
                      lambda where: spatial_kernel(style, ys.to(where), D_, N_), x0, delta,
                      noises, dev, spatial_per_iter(style))


def interior_slab(x):
    """The interior coordinates `interior_ess` reads, of a (T, B[, 1]) state:
    the middle half of time, strided to 16 steps."""
    T_ = x.shape[0]
    stride = max(1, (T_ // 2) // 16)
    return x.reshape(T_, -1)[T_ // 4: 3 * T_ // 4: stride]


def slab_moments(slabs, max_coords=64):
    """(mean, variance, ESS) of up to `max_coords` coordinates of collected
    interior slabs (n, 16 * B), the coordinates `interior_ess` picks."""
    import numpy as np
    from aux_ssm_tpu_torch.utils.ess import effective_sample_size
    flat = slabs.reshape(slabs.shape[0], -1)
    idx = np.unique(np.linspace(0, flat.shape[1] - 1, max_coords).astype(int))
    chains = flat[:, idx].astype(np.float64)
    ess = np.array([float(effective_sample_size(chains[:, i])) for i in range(len(idx))])
    return chains.mean(0), chains.var(0), ess


def smoothed_data(ys):
    """A centred 9-step moving average of the (T, B) data over time, float64:
    a fixed field near the posterior mean that depends on the data alone."""
    import torch.nn.functional as F
    return F.avg_pool1d(ys.double().T[None], 9, stride=1, padding=4,
                        count_include_pad=False)[0].T.contiguous()


KINDS = ("shift", "spread", "roughness", "coupling")


def pooled_functionals(x, ref):
    """len(KINDS) * SP_BLOCKS pooled functionals of a (T, B[, 1]) state on a
    D x D grid, float64: over each of SP_BLOCKS time blocks and the whole
    grid, the mean of x - ref (shift), of (x - ref)^2 (spread about the
    reference field `ref`), of the squared random-walk increments (x_t -
    x_{t-1})^2 with x_{-1} = 0 (roughness), and of the products of the
    increments of neighbouring grid cells (coupling: what the off-diagonal of
    the observation precision leaves in the posterior). The first two live
    on the smooth modes, which these samplers move slowly; the last two on
    the increments, which they move fast."""
    import torch
    x = x.reshape(ref.shape).double()
    D = math.isqrt(x.shape[1])
    r = x - ref
    inc = torch.diff(x, dim=0, prepend=torch.zeros_like(x[:1]))
    g = inc.reshape(-1, D, D)
    coupling = ((g[:, 1:] * g[:, :-1]).mean((1, 2)) + (g[:, :, 1:] * g[:, :, :-1]).mean((1, 2))) / 2
    rows = torch.stack([r.mean(1), r.square().mean(1), inc.square().mean(1), coupling])
    return rows.reshape(len(KINDS) * SP_BLOCKS, -1).mean(-1)


def with_whole(f):
    """(..., len(KINDS) * SP_BLOCKS) block functionals, kind by kind, each
    kind's SP_BLOCKS blocks followed by its value on the whole trajectory (the
    blocks' mean): (..., len(KINDS), SP_BLOCKS + 1)."""
    import numpy as np
    f = np.asarray(f, dtype=np.float64)
    f = f.reshape(*f.shape[:-1], len(KINDS), SP_BLOCKS)
    return np.concatenate([f, f.mean(-1, keepdims=True)], axis=-1)


def z_scores(name, z, rms_bound):
    """Print max |z| and RMS z of `z`; fail beyond Z_MAX or `rms_bound`."""
    import numpy as np
    worst, rms = float(np.abs(z).max()), float(np.sqrt((z ** 2).mean()))
    log(f"    {name}: {z.size} z-scores, max |z| {worst:.2f}, RMS z {rms:.2f} (bounds {Z_MAX:g}, "
        f"{rms_bound:g})")
    if not (worst <= Z_MAX and rms <= rms_bound):
        raise AssertionError(f"spatial: {name}: max |z| {worst:.2f}, RMS z {rms:.2f}")


def replicate_moments(chains):
    """Of a sampler's two replicate chains (n, ..., m): the pooled mean and
    variance of each column, and w = the mean over the last axis of the
    squared gap between the replicates' means in units of the variance (2 /
    ESS of one replicate), so the pooled mean's Monte-Carlo variance is
    variance * w / 4. No autocorrelation estimate enters."""
    import numpy as np
    c1, c2 = chains
    both = np.concatenate([c1, c2])
    var = both.var(0)
    w = ((c1.mean(0) - c2.mean(0)) ** 2 / var).mean(-1, keepdims=True)
    return both.mean(0), var, w


def spatial_chain(dev, style, ys, x0, seed, schedule):
    """run_chain of the spatial sampler `style` on the card from x0, at
    `schedule` = (burn-in, samples, target update rate); checks finite states,
    the exact launches per iteration and the update rate; profiles the step.
    A sample is the interior slab. Returns (launches, posterior-mean field
    (T, B), samples (n, ...))."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.ops import cuda as K

    burnin, n_samples, target = schedule
    T_, B = ys.shape
    is_csmc = style.startswith("csmc")
    init, kernel = spatial_kernel(style, ys, SP_D, SP_N)
    gen = torch.Generator(device=dev).manual_seed(seed)
    delta0 = torch.full((T_,) if is_csmc else (), SP_DELTA0, dtype=ys.dtype, device=dev)

    K.reset_launches()
    res = runner.run_chain(kernel, init(x0), RunConfig(n_samples=n_samples, burnin=burnin,
                                                       target_alpha=target),
                           generator=gen, collect_samples=True, delta_init=delta0,
                           collect_fn=lambda state: interior_slab(state.x).reshape(-1))
    launches = K.launches()
    n_iter = burnin + n_samples
    per_iter = spatial_per_iter(style)
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"spatial {style}: {name} launched {count} times in {n_iter} "
                                 f"iterations, expected {per_iter.get(name, 0)} each")
    x = res.state.x
    if x.numel() != T_ * B or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"spatial {style}: the chain's state is not finite")
    rate = float(res.stats.accept_cum.mean())
    _, _, ess = slab_moments(res.samples[:, :interior_slab(ys).numel()])
    sps = n_samples / res.sampling_time
    log(f"  {style}: {burnin} + {n_samples} iterations, update rate {rate:.4f} (target "
        f"{target}), {sps:.2f} samples/s, delta [{float(res.delta.min()):.3e}, "
        f"{float(res.delta.max()):.3e}], mean interior ESS {ess.mean():.1f} of {n_samples} "
        f"(min {ess.min():.1f}), {ess.mean() / res.sampling_time:.2f} ESS/s, mean EJSD "
        f"{float(res.stats.ejsd.mean()):.4e}, launches a step "
        f"{({k: v // n_iter for k, v in launches.items() if v})}")
    if not 0.05 < rate < 0.95:
        raise AssertionError(f"spatial {style}: update rate {rate:.4f} outside (0.05, 0.95)")
    box = [res.state]
    profile_steps(f"spatial {style}",
                  lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)), n=20,
                  also=("scalar_scan_kernel", "block_lane_kernel", "factor_kernel"))
    return launches, res.stats.mean_x.reshape(T_, B), res.samples


def spatial_replicates(dev, style, ys, x0, seed, schedule, ref):
    """Two replicate chains of the spatial sampler `style` from x0 as one
    batched step (`chains=True` through `run_sharded_chains`: each chain's
    delta adapts on its own rate), at `schedule` = (burn-in, samples, target
    update rate); checks finite states, the exact launches per iteration
    (one chain's step's) and each chain's update rate. A chain's sample is
    its interior slab, then its `pooled_functionals` about `ref`. Returns
    (launches, the chains' posterior-mean fields (2, T, B), each chain's
    samples (n, ...))."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains

    burnin, n_samples, target = schedule
    T_, B = ys.shape
    C = 2
    common = (ys, *SP_PARAMS, SP_D)
    if style.startswith("kalman"):
        init, kernel = sp.get_kalman_kernel(*common, parallel=True, order=int(style[-1]),
                                            chains=True)
    else:
        init, kernel = sp.get_guided_csmc_kernel(*common, SP_N, backward=True, chains=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    delta0 = torch.full((C, T_) if style.startswith("csmc") else (C,), SP_DELTA0,
                        dtype=ys.dtype, device=dev)

    def collect(state):
        return torch.stack([torch.cat([interior_slab(x).reshape(-1).double(),
                                       pooled_functionals(x, ref)]) for x in state.x])

    K.reset_launches()
    res = run_sharded_chains(kernel, init(x0.expand(C, -1, -1).clone()),
                             RunConfig(n_samples=n_samples, burnin=burnin, target_alpha=target),
                             generator=gen, collect_samples=True, delta_init=delta0,
                             collect_fn=collect)
    launches = K.launches()
    n_iter = burnin + n_samples
    per_iter = spatial_per_iter(style)
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"spatial {style}, {C} chains: {name} launched {count} times in "
                                 f"{n_iter} iterations, expected {per_iter.get(name, 0)} each")
    if not bool(torch.isfinite(res.state.x).all()):
        raise AssertionError(f"spatial {style}: the chains' states are not finite")
    rates = res.stats.accept_cum.reshape(C, -1).double().mean(1).tolist()
    log(f"  {style}, {C} chains as one batched step: {burnin} + {n_samples} iterations, update "
        f"rates {[round(r, 4) for r in rates]} (target {target}), "
        f"{C * n_samples / res.sampling_time:.2f} samples/s of both, launches a step "
        f"{({k: v // n_iter for k, v in launches.items() if v})}")
    if not all(0.05 < r < 0.95 for r in rates):
        raise AssertionError(f"spatial {style}: update rates {rates} outside (0.05, 0.95)")
    return launches, res.stats.mean_x.reshape(C, T_, B), list(res.samples)


def spatial_pair(dev, ys, xs_true, add):
    """kalman-1 against csmc-guided, two replicate chains each (one batched
    step of two chains), from the simulated states; see phase 15 of the
    module's docstring. `add(launches)` takes each sampler's launches.
    Returns the two samplers' posterior-mean fields and their coordinates'
    `replicate_moments`."""
    import numpy as np

    log("  kalman-1 and csmc-guided, two chains each, from the simulated states (an exact "
        "posterior draw):")
    n_slab = interior_slab(ys).numel()
    ref = smoothed_data(ys)
    at_truth = with_whole(pooled_functionals(xs_true, ref).cpu().numpy())
    fields, slabs, funcs = {}, {}, {}
    for i, style in enumerate(SPATIAL_PAIR):
        launches, chain_fields, samples = spatial_replicates(dev, style, ys, xs_true, 80 + i,
                                                             SPATIAL_PAIR[style], ref)
        add(launches)
        fields[style] = chain_fields.mean(0)
        slabs[style] = replicate_moments([z[:, :n_slab] for z in samples])
        funcs[style] = replicate_moments([with_whole(z[:, n_slab:]) for z in samples])
        # (a) One posterior draw against the sampler's posterior: their gap is
        # sd * sqrt(1 + w / 4) when the sampler leaves the posterior alone.
        mean, var, w = funcs[style]
        log(f"    {style}, whole trajectory, posterior mean (deviation; ESS of a replicate, the "
            "kind's blocks pooled): " + ", ".join(
                f"{kind} {mean[k, -1]:.5f} ({math.sqrt(var[k, -1]):.5f}; {2 / w[k, 0]:.1f})"
                for k, kind in enumerate(KINDS)))
        z_scores(f"(a) {style}, functionals at the simulated states against the sampler's",
                 (mean - at_truth) / np.sqrt(var * (1 + w / 4)), Z_RMS)
    a, b = SPATIAL_PAIR
    for name, moments in (("(b) functionals", funcs), ("(c) interior coordinates", slabs)):
        (ma, va, wa), (mb, vb, wb) = moments[a], moments[b]
        z = (ma - mb) / np.sqrt((va * wa + vb * wb) / 4)
        if z.ndim == 2:
            log("      RMS z by kind: " + ", ".join(
                f"{kind} {math.sqrt((z[k] ** 2).mean()):.2f}" for k, kind in enumerate(KINDS)))
        z_scores(f"{name}, {a} against {b}, ESS of a replicate {2 / wa.mean():.1f} and "
                 f"{2 / wb.mean():.1f}", z, Z_RMS_CROSS)
    return fields, slabs


def pair_report(fields, slabs, ys, xs_true):
    """The two gross bounds on the pair's posterior-mean fields: they differ
    by less than the posterior deviation in RMS, and each lies nearer the
    truth than the data do."""
    import numpy as np

    def rmse(a, b):
        return float((a - b).pow(2).mean().sqrt())

    a, b = SPATIAL_PAIR
    sd, gap = float(np.sqrt(slabs[a][1].mean())), rmse(fields[a], fields[b])
    log(f"    the posterior-mean fields differ by RMS {gap:.4f} (bound: the posterior sd, "
        f"~{sd:.4f}); their RMSE to the truth {rmse(fields[a], xs_true):.4f} and "
        f"{rmse(fields[b], xs_true):.4f} (bound: the data's, {rmse(ys, xs_true):.4f})")
    if not gap < sd:
        raise AssertionError("spatial: the posterior-mean fields differ by more than the "
                             "posterior sd")
    for style in (a, b):
        if not rmse(fields[style], xs_true) < rmse(ys, xs_true):
            raise AssertionError(f"spatial {style}: the posterior mean is no closer to the truth "
                                 "than the data")


def phase_spatial_chains(dev):
    """Phase 15; returns the launches summed by wrapper of the one-chain
    runs and of the pair's batched runs (two chains a step)."""
    import torch
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.native.precision import precision_stencil

    sigma_x, nu, tau, r_y = SP_PARAMS
    log(f"phase 15: spatial chains, T={SP_T}, D={SP_D} (B={SP_D * SP_D}), N={SP_N}, f32, data "
        f"seed {SP_SEED}, from init_x_fn, delta adapted from {SP_DELTA0:g} (published schedule: "
        "2500 + 10000 iterations from 1e-5)")
    xs_true, ys = spatial_data(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SP_SEED + 1)
    stencil = torch.as_tensor(precision_stencil(tau, r_y), dtype=ys.dtype, device=dev)
    x0 = sp.init_x_fn(ys, sigma_x, nu, stencil, SP_D, max(SP_N, 32), generator=gen)
    if tuple(x0.shape) != (SP_T, SP_D * SP_D) or not bool(torch.isfinite(x0).all()):
        raise AssertionError("spatial: init_x_fn did not return a finite (T, B) trajectory")

    def rmse(a, b):
        return float((a - b).pow(2).mean().sqrt())

    log(f"  RMSE to the simulated truth: data {rmse(ys, xs_true):.4f}, init_x_fn "
        f"{rmse(x0, xs_true):.4f}")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for i, style in enumerate(SPATIAL_SCHEDULE):
        launches, field, _ = spatial_chain(dev, style, ys, x0, 50 + i, SPATIAL_SCHEDULE[style])
        add(launches)
        log(f"  {style}: RMSE of the posterior mean to the truth {rmse(field, xs_true):.4f}")
        if not rmse(field, xs_true) < rmse(x0, xs_true):
            raise AssertionError(f"spatial {style}: the posterior mean is no nearer the truth "
                                 "than the start was")
    one_chain, total = total, {}
    pair_report(*spatial_pair(dev, ys, xs_true, add), ys, xs_true)
    return one_chain, total

# ---------------------------------------------------------------------------
# The parallel-in-time (PIT) cSMC path: the stitching kernels
# ---------------------------------------------------------------------------

STITCH_KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces)
    "row_lse": ("aux_ssm_tpu_torch/ops/cuda/csrc/stitching.cu",
                "aux_ssm_tpu/ops/pallas/stitching.py:105"),
    "col_sample": ("aux_ssm_tpu_torch/ops/cuda/csrc/stitching.cu",
                   "aux_ssm_tpu/ops/pallas/stitching.py:200"),
    "block_masses": ("aux_ssm_tpu_torch/ops/cuda/csrc/stitching.cu",
                     "aux_ssm_tpu/ops/pallas/stitching.py:302"),
    "stitch_draws": ("aux_ssm_tpu_torch/ops/cuda/csrc/stitching.cu",
                     "aux_ssm_tpu/ops/pallas/stitching.py:725"),
    # The column stage of stitch_draws alone, for the default joint draws:
    # the JAX package computes it in XLA (no Pallas kernel).
    "within_block_cols": ("aux_ssm_tpu_torch/ops/cuda/csrc/stitching.cu",
                          "aux_ssm_tpu/ops/pallas/stitching.py:416"),
}
# The index kernels: where (rf, cf, cb) sit in their arguments, and the
# operations of one draw beside its scores (2k + 25 a score: the products,
# the counter hash, two logs and the argmax).
INDEX_KERNELS = {"col_sample": 1, "within_block_cols": 2, "stitch_draws": 4}
# Thread-instructions of one score of the draws' column stage (the counter
# hash, two logs, the product and the lane's argmax step): 260 for a lane's
# four columns in the SASS of within_block_cols_kernel<float, 1>
# (`kernel_times.py --parts draws --sass DIR` writes it). The draws'
# issue-rate floor is this many a score over 128 lanes an SM a clock.
DRAW_SCORE_INSTRUCTIONS = 65
# Thread-instructions of one col_sample score beside its 2k rounded products
# (a multiply and an add each): the counter hash, the two logs and the
# argmax step, counted in the SASS of col_sample_kernel<float, 1, 1>
# (`kernel_times.py --parts rows --sass DIR` writes it). Its issue-rate
# floor is COL_GUMBEL_INSTRUCTIONS + 2k a score over 128 lanes an SM a clock.
COL_GUMBEL_INSTRUCTIONS = 65
# Random-input draws cases of phase 16 (label, P, N, k): nb = 64, where the
# prefix sums' shift-32 steps carry from the low lanes' blocks into the high
# ones, and k = 30, where the lanes read the features through shared memory.
DRAW_CASES = (("N=8192 (nb=64) random, P=2, k=1", 2, 8192, 1),
              ("N=2048 random, P=4, k=30", 4, 2048, 30))
PIT_T, PIT_N, PIT_DELTA = 1024, 4096, 0.05  # benchmarks/csmc_speed.py:_pit, SV D=1 (config 5)
COL_AGREE_F32 = 0.999   # f32 col_sample indices equal to the f32 plain version's
TWO_CALL_BYTES = 2 ** 31  # the scores of one chunk of block_masses' two-call yardstick
# The PIT chains at full width: (burn-in, samples, target); delta (T,) from 1e-2.
PIT_SV_SCHEDULE = (50, 50, 0.5)
PIT_SP_SCHEDULE = (50, 50, 0.25)
PIT_BIG_SCHEDULE = (3, 10)   # frozen delta 0.05; run under either draws
# The JAX package's frozen-delta chain at this size updated 0.997 of the steps
# (benchmarks/RESULTS_r5.md, config 5): N=4096 leaves index 0 about once in
# 4096, so that chain is held to [0.95, 1] instead of (0.05, 0.95).
PIT_BIG_RATE = (0.95, 1.0)
# Rare-event PIT chains against the closed form: cell, N, burn-in, samples,
# the blocked route's draws.
RE_PIT = (((5.0, 0.8, 0.5, 256), RE_N, 300, 300, "joint"),
          ((5.0, 0.8, 0.5, 64), PIT_N, 100, 200, "joint"),
          ((5.0, 0.8, 0.5, 64), PIT_N, 100, 200, "fused"))


def pit_launches(T, N, stitch="auto", draws="joint"):
    """The stitching launches of one PIT step at T steps and N particles."""
    from aux_ssm_tpu_torch.kernels.pit import _use_blocked_stitch, level_sizes
    n = len(level_sizes(T))
    if not n:
        return {}
    if n == 1:
        return {"row_lse": 1}
    if _use_blocked_stitch(N, stitch):
        draw = "stitch_draws" if draws == "fused" else "within_block_cols"
        return {"row_lse": 1, "block_masses": n - 1, draw: n - 1}
    return {"row_lse": n, "col_sample": n - 1}


@contextlib.contextmanager
def recording_stitching():
    """Record the arguments of every call of the stitching wrappers, in
    order; the calls go through. A wrapper counts its launches on its
    module's name, which is the recorder meanwhile, so these launches count
    on the recorder."""
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    seen, originals = {name: [] for name in STITCH_KERNELS}, {
        name: getattr(KS, name) for name in STITCH_KERNELS}

    def recorder(name, fn):
        def record(*args, **kwargs):
            seen[name].append((args, kwargs))
            return fn(*args, **kwargs)
        record.launches = 0
        return record

    for name, fn in originals.items():
        setattr(KS, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(KS, name, fn)


def check_stitch(name, label, args, reps, two_call=False):
    """A stitching kernel against its plain version on `args` (f32, from a
    real step): f32 kernel vs f32 plain, the f64 kernel vs the f64 plain
    version on the same inputs cast, and the f32 kernel vs that f64 plain
    version. Index kernels (col_sample, within_block_cols, stitch_draws):
    f64 indices identical, f32 indices equal to the f32 plain version's at
    >= COL_AGREE_F32 (col_sample) or AGREE_F32 and to the f64 plain
    version's at >= AGREE_F32; row_lse and block_masses norm-relative.
    Returns the result entry, with the f32 kernel's and plain version's
    times and the bound."""
    import torch
    from aux_ssm_tpu_torch.ops import stitching as plain
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    wrapper, plain_fn = getattr(KS, name), getattr(plain, name)
    args64 = tuple(z.double() if isinstance(z, torch.Tensor) and z.is_floating_point() else z
                   for z in args)
    got, want32 = as_tuple(wrapper(*args)), as_tuple(plain_fn(*args))
    got64, want64 = as_tuple(wrapper(*args64)), as_tuple(plain_fn(*args64))
    torch.cuda.synchronize()
    if name in INDEX_KERNELS:
        at = INDEX_KERNELS[name]
        rf, cf, cb = args[at:at + 3]
        for g, w in zip(got64, want64):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}[{label}] f64: {int((g != w).sum())} indices differ "
                                     "from the plain version's")
        share = min(float((g == w).double().mean()) for g, w in zip(got, want32))
        share64 = min(float((g == w).double().mean()) for g, w in zip(got, want64))
        least = COL_AGREE_F32 if name == "col_sample" else AGREE_F32
        log(f"  {name}[{label}] shape={tuple(got[0].shape)}: f64 indices identical; f32 indices "
            f"equal to the f32 plain version's {share:.6f} (bound {least}), to the f64 plain "
            f"version's on the same inputs {share64:.6f} (bound {AGREE_F32})")
        if not (share >= least and share64 >= AGREE_F32):
            raise AssertionError(f"{name}[{label}] f32: only {share:.6f} and {share64:.6f} of "
                                 "the indices agree")
        result = {"index_agree_f32": share, "index_agree_f32_vs_f64": share64,
                  "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want32))}
        score = 2 * rf.shape[-1] + 25   # the products, the counter hash, two logs, the argmax
        P, n = got[0].shape
        if name == "col_sample":
            ops = P * n * cf.shape[1] * score
        elif name == "within_block_cols":
            ops = P * n * 128 * score
        else:  # and each draw's row (tile and offset counts) and block (exp, prefix sum, count)
            ops = P * n * (128 * score + 2 * 128 + 8 * (cf.shape[1] // 128))
        lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
        if name == "col_sample":
            issue = P * n * cf.shape[1] * (COL_GUMBEL_INSTRUCTIONS + 2 * rf.shape[-1])
        else:
            issue = P * n * 128 * DRAW_SCORE_INSTRUCTIONS
        result["issue_bound_ms"] = 1e3 * issue / (lanes * sm_clock_hz())
    else:
        got, want32, got64, want64 = got[0], want32[0], got64[0], want64[0]
        fin = torch.isfinite(want64)
        for z, what in ((got, "f32 kernel"), (got64, "f64 kernel"), (want32, "f32 plain")):
            if not torch.equal(torch.isfinite(z), fin):
                raise AssertionError(f"{name}[{label}]: the {what} is finite elsewhere than the "
                                     "f64 plain version")
        e32, e64k = nrel(got[fin], want32[fin]), nrel(got64[fin], want64[fin])
        e64 = nrel(got[fin], want64[fin])
        result = {"max_abs_err": float((got[fin].double() - want32[fin].double()).abs().max()),
                  "max_abs_err_f64_plain": float((got[fin].double() - want64[fin]).abs().max()),
                  "nrel_f32": e32, "nrel_f64": e64, "nrel_f64_kernel": e64k}
        log(f"  {name}[{label}] shape={tuple(got.shape)} nrel_f32={e32:.3e} nrel_f64={e64:.3e} "
            f"nrel_f64_kernel={e64k:.3e}, {int((~fin).sum())} -inf; f32 against f64 on the same "
            f"inputs max abs err {result['max_abs_err_f64_plain']:.3e}")
        if not (e32 <= NREL_F32 and e64 <= NREL_F32 and e64k <= NREL_F64):
            raise AssertionError(f"{name}[{label}]: error above bound")
        rf, cf = args[:2]
        P, n = got.shape[:2]
        ops = P * n * cf.shape[1] * (2 * rf.shape[-1] + 4)   # the score, the max, exp and sum
        got = (got,)
    result["ms"] = cuda_ms(lambda: wrapper(*args), reps)
    result["plain_ms"] = cuda_ms(lambda: plain_fn(*args), 1)
    tensors = [z for z in args if isinstance(z, torch.Tensor)]
    result.update(bound(tensors + list(got), 0, ops))
    if two_call:
        # Two PyTorch calls of the same function (a reference point only;
        # the port never calls them): the (P, n, N) scores by baddbmm, then
        # logsumexp (block_masses: over each 128-column block, in chunks of
        # nodes whose scores take at most TWO_CALL_BYTES).
        rf, cf, cb = args[:3]
        if name == "block_masses":
            result["two_call_ms"] = cuda_ms(lambda: two_call_masses(rf, cf, cb), reps)
        else:
            result["two_call_ms"] = cuda_ms(lambda: torch.logsumexp(
                torch.baddbmm(cb[:, None, :], rf, cf.transpose(1, 2)), -1), reps)
    if name in ("row_lse", "block_masses"):
        # Every score takes one exponential, which issues on the SFU: 16 a
        # clock on each SM of sm_90, at the card's top SM clock.
        P, n = got[0].shape[:2]
        rate = torch.cuda.get_device_properties(0).multi_processor_count * 16 * sm_clock_hz()
        result["sfu_bound_ms"] = 1e3 * P * n * args[1].shape[1] / rate
    log(f"  {name}[{label}]: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms"
        + (f", baddbmm + logsumexp {result['two_call_ms']:.4f} ms" if two_call else "")
        + f", bound {result['bound_ms']:.5f} ms by {result['bound_by']} ({result['bytes']} B, "
        f"{result['operations']} operations)"
        + (f", SFU bound {result['sfu_bound_ms']:.5f} ms" if "sfu_bound_ms" in result else "")
        + (f", issue bound {result['issue_bound_ms']:.5f} ms" if "issue_bound_ms" in result
           else ""))
    return result


def two_call_masses(rf, cf, cb):
    """block_masses (row-max stabiliser aside) by two PyTorch calls a chunk of
    nodes: baddbmm for the scores, logsumexp over each 128-column block."""
    import torch
    P, n, _ = rf.shape
    N = cf.shape[1]
    out = rf.new_empty(P, n, N // 128)
    step = max(1, TWO_CALL_BYTES // (n * N * rf.element_size()))
    for p in range(0, P, step):
        sl = slice(p, p + step)
        s = torch.baddbmm(cb[sl, None, :], rf[sl], cf[sl].transpose(1, 2))
        out[sl] = torch.logsumexp(s.view(s.shape[0], n, N // 128, 128), -1)
    return out


def sm_clock_hz():
    """The card's top SM clock, from nvidia-smi (clocks.max.sm, MHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    return 1e6 * float(smi.stdout.strip().splitlines()[0])


def pit_step_inputs(init, kernel, x0, delta, seed):
    """The stitching wrappers' arguments of one PIT step from x0."""
    import torch
    with recording_stitching() as seen:
        kernel(init(x0), delta, generator=torch.Generator(device=x0.device).manual_seed(seed))
    return {name: [args for args, _ in calls] for name, calls in seen.items()}


def sv_pit_kernel(ys, N, gradient=False, stitch="auto", draws="joint"):
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    return ind.get_kernel(*sv.get_feynman_kac(ys, *SV_PARAMS), N, parallel=True, gradient=gradient,
                          stitch=stitch, draws=draws)


def pit_big_data(dev, dtype):
    """(xs, ys) of the SV model at D=1, T=PIT_T (csmc_speed.py:_sv_setup)."""
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    return sv.get_data(*SV_PARAMS, 1, PIT_T, generator=torch.Generator().manual_seed(0),
                       dtype=dtype, device=dev)


def random_draw_inputs(dev, P, N, k, seed):
    """Arguments of stitch_draws and within_block_cols on random factors, f32:
    rf, cf ~ N(0, 0.4^2), cb and the row biases ~ N(0, 1), the block masses
    of those factors (by the block_masses wrapper), uniform u and blocks."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    gen = torch.Generator(device=dev).manual_seed(seed)
    rf, cf = (0.4 * torch.randn(P, N, k, generator=gen, device=dev) for _ in range(2))
    cb, rb = (torch.randn(P, N, generator=gen, device=dev) for _ in range(2))
    Lb = KS.block_masses(rf, cf, cb)
    u = torch.rand(P, N, generator=gen, device=dev)
    seed_t = torch.tensor(seed, dtype=torch.int32, device=dev)
    blocks = torch.randint(0, N // 128, (P, N), generator=gen, device=dev)
    return ((seed_t, rb + torch.logsumexp(Lb, -1), u, Lb, rf, cf, cb, 3),
            (seed_t, blocks, rf, cf, cb, 3))


def phase_stitch_kernels(dev):
    """Phase 16; returns {wrapper: result entry}: SV level 0 for row_lse and
    col_sample, N=4096 level 0 for block_masses and the draws, the other
    shapes beside."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    f32 = torch.float32
    log(f"phase 16: the stitching kernels on the inputs real PIT steps hand them (f32 kernel vs "
        f"f32 plain and vs f64 plain: nrel {NREL_F32:g}, indices >= {AGREE_F32} (col_sample vs "
        f"f32 plain >= {COL_AGREE_F32}); f64 kernel vs f64 plain: nrel {NREL_F64:g}, indices "
        f"identical)")
    ys, xs, delta = load_sv("csmc_no-gradient", dev, f32)
    sv_in = pit_step_inputs(*sv_pit_kernel(ys, SV_N), xs, delta, seed=16)
    sxs, sys_ = spatial_data(dev, f32)
    sp_in = pit_step_inputs(*spatial_kernel("csmc-pit", sys_, SP_D, SP_N), sxs,
                            torch.full((SP_T,), SP_DELTA0, dtype=f32, device=dev), seed=16)
    bxs, bys = pit_big_data(dev, f32)
    big_delta = torch.full((PIT_T,), PIT_DELTA, dtype=f32, device=dev)
    big = {(N_, draws): pit_step_inputs(*sv_pit_kernel(bys, N_, stitch="blocked", draws=draws),
                                        bxs, big_delta, seed=16)
           for N_ in (PIT_N, 128) for draws in ("joint", "fused")}
    cases = [("SV", sv_in, pit_launches(SV_T, SV_N)), ("spatial", sp_in, pit_launches(SP_T, SP_N))]
    cases += [(f"N={N_} {draws}", seen, pit_launches(PIT_T, N_, "blocked", draws))
              for (N_, draws), seen in big.items()]
    for label, seen, want in cases:
        calls = {k: len(v) for k, v in seen.items() if v}
        if calls != want:
            raise AssertionError(f"{label}: a PIT step called {calls}, expected {want}")
    sv0 = f"SV T={SV_T} D={SV_D} N={SV_N} level 0"
    sp0 = f"spatial T={SP_T} d={SP_D * SP_D} N={SP_N} level 0"
    big0 = f"SV D=1 T={PIT_T} N={PIT_N} level 0"
    big_in = big[PIT_N, "joint"]
    results = {
        "row_lse": check_stitch("row_lse", sv0, sv_in["row_lse"][0], 50, two_call=True),
        "col_sample": check_stitch("col_sample", sv0, sv_in["col_sample"][0], 50),
        "block_masses": check_stitch("block_masses", big0, big_in["block_masses"][0], 5,
                                     two_call=True),
        "stitch_draws": check_stitch("stitch_draws", big0, big[PIT_N, "fused"]["stitch_draws"][0],
                                     5),
        "within_block_cols": check_stitch("within_block_cols", big0,
                                          big_in["within_block_cols"][0], 5),
    }
    results["row_lse"]["root"] = check_stitch("row_lse", "SV root", sv_in["row_lse"][-1], 50)
    results["row_lse"]["spatial"] = check_stitch("row_lse", sp0, sp_in["row_lse"][0], 50,
                                                 two_call=True)
    results["row_lse"]["spatial_root"] = check_stitch("row_lse", "spatial root",
                                                      sp_in["row_lse"][-1], 50)
    results["row_lse"]["N4096_root"] = check_stitch("row_lse", f"N={PIT_N} root",
                                                    big_in["row_lse"][-1], 20, two_call=True)
    results["col_sample"]["spatial"] = check_stitch("col_sample", sp0, sp_in["col_sample"][0], 50)
    rf, cf, cb = big_in["block_masses"][0]
    results["block_masses"]["per_block_max"] = check_stitch(
        "block_masses", f"N={PIT_N} level 0, per-block max", (rf, cf, cb, True), 5)
    small0 = f"SV D=1 T={PIT_T} N=128 (nb=1) level 0"
    for name, draws in (("stitch_draws", "fused"), ("within_block_cols", "joint")):
        results[name]["nb1"] = check_stitch(name, small0, big[128, draws][name][0], 20)
    bad = KS.draw_log_mismatches(dev)
    log(f"  draw_log against logf on every positive normal float: {bad} differ")
    if bad:
        raise AssertionError(f"draw_log differs from logf on {bad} floats")
    for label, P, N_, k in DRAW_CASES:
        fused, joint = random_draw_inputs(dev, P, N_, k, seed=17)
        results["stitch_draws"][label] = check_stitch("stitch_draws", label, fused, 10)
        results["within_block_cols"][label] = check_stitch("within_block_cols", label, joint, 10)
    return results


def phase_pit_step_reference(dev):
    """Phase 17: f64 PIT steps on the card against the CPU, given the same
    noise; both routes (two-pass at N=16, blocked forced at N=128), the
    gradient shift off and on."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind
    from aux_ssm_tpu_torch.kernels.pit import level_sizes
    from aux_ssm_tpu_torch.models import rare_event as rev, spatial as sp
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv

    rng = np.random.default_rng(17)

    def noise(T_, N_, d):
        sizes = level_sizes(T_)
        return (rng.standard_normal((T_, d)), rng.standard_normal((T_, N_, d)),
                [(rng.uniform(size=(n, N_)), np.int32(rng.integers(0, 2 ** 31 - 1)))
                 for n in sizes[:-1]], (rng.uniform(size=1), rng.uniform(size=1)))

    T_ = 32
    sv_xs, sv_ys = sv.get_data(*SV_PARAMS, 4, T_, generator=torch.Generator().manual_seed(17),
                               device="cpu")
    sp_xs, sp_ys = spatial_data("cpu", torch.float64, T_, 3, seed=17)
    re_x0 = torch.as_tensor(3.0 + rng.standard_normal((6, 1)))
    cases = {
        "SV D=4": (lambda where, **kw: ind.get_kernel(*sv.get_feynman_kac(
            sv_ys.to(where), *SV_PARAMS), parallel=True, **kw), sv_xs, 0.3),
        "spatial 3x3": (lambda where, **kw: ind.get_kernel(*sp.get_feynman_kac(
            sp_ys.to(where), *SP_PARAMS[:3], SP_PARAMS[3], 3), parallel=True, **kw),
            sp_xs + 0.1, 0.02),
        "rare-event": (lambda where, **kw: ind.get_kernel(*rev.get_feynman_kac(
            *RE_CELL[:3], 6, device=where), parallel=True, **kw), re_x0, 0.5),
    }
    for label, (get, x0, delta) in cases.items():
        T_x, d = x0.shape
        routes = [("2pass", 16, "joint"), ("blocked", 128, "joint")]
        if not label.startswith("spatial"):
            routes.append(("blocked", 128, "fused"))
        for stitch, N_, draws in routes:
            for gradient in (False, True):
                steps_on_both(
                    f"PIT {label} T={T_x} N={N_} {stitch} {draws} gradient={gradient}",
                    lambda where: get(where, N=N_, gradient=gradient, stitch=stitch, draws=draws),
                    x0, np.full(T_x, delta), [noise(T_x, N_, d) for _ in range(2)], dev,
                    pit_launches(T_x, N_, stitch, draws))


def pit_chain(dev, label, init, kernel, x0, cfg, delta_init, seed, per_iter, rate_bounds,
              profile_n):
    """run_chain of a PIT kernel on the card from x0: finite state, the exact
    stitching launches per iteration, update rate within `rate_bounds`;
    samples/s and a profile. Returns the chain's launches."""
    import torch
    from aux_ssm_tpu_torch.experiments import runner
    from aux_ssm_tpu_torch.ops import cuda as K
    gen = torch.Generator(device=dev).manual_seed(seed)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = runner.run_chain(kernel, init(x0), cfg, generator=gen, delta_init=delta_init)
    launches = K.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_iter = max(cfg.burnin, 1) + cfg.n_samples
    if tuple(res.state.x.shape) != tuple(x0.shape) or not bool(torch.isfinite(res.state.x).all()):
        raise AssertionError(f"{label}: the chain's state is not finite")
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"{label}: {name} launched {count} times in {n_iter} "
                                 f"iterations, expected {per_iter.get(name, 0)} each")
    rate = float(res.stats.accept_cum.mean())
    log(f"  {label}: {cfg.burnin} + {cfg.n_samples} iterations, update rate {rate:.4f}, "
        f"{cfg.n_samples / res.sampling_time:.2f} samples/s, delta "
        f"[{float(res.delta.min()):.3e}, {float(res.delta.max()):.3e}], launches a step "
        f"{({k: v // n_iter for k, v in launches.items() if v})}, peak device memory "
        f"{peak_gb:.2f} GiB")
    lo, hi = rate_bounds
    if not lo <= rate <= hi:
        raise AssertionError(f"{label}: update rate {rate:.4f} outside {rate_bounds}")
    box = [res.state]
    profile_steps(label, lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)),
                  n=profile_n, also=tuple(STITCH_KERNELS))
    return launches


def phase_pit_chains(dev, card):
    """Phase 18; returns the stitching launches summed over the one-chain and
    C = 1 runs, and those of the N=4096 C = DRAW_CHAINS runs."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig
    f32 = torch.float32
    total = dict.fromkeys(STITCH_KERNELS, 0)
    chained = dict.fromkeys(STITCH_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    log("phase 18: PIT chains at full width, f32")
    ys, xs, _ = load_sv("csmc_no-gradient", dev, f32)
    burnin, n_samples, target = PIT_SV_SCHEDULE
    for gradient in (False, True):
        add(pit_chain(dev, f"SV csmc parallel=True T={SV_T} D={SV_D} N={SV_N} gradient={gradient}",
                      *sv_pit_kernel(ys, SV_N, gradient), xs,
                      RunConfig(n_samples=n_samples, burnin=burnin, target_alpha=target),
                      torch.full((SV_T,), 1e-2, dtype=f32, device=dev), 18 + gradient,
                      pit_launches(SV_T, SV_N), (0.05, 0.95), 10))
    sxs, sys_ = spatial_data(dev, f32)
    burnin, n_samples, target = PIT_SP_SCHEDULE
    add(pit_chain(dev, f"spatial csmc parallel=True T={SP_T} D={SP_D} N={SP_N}",
                  *spatial_kernel("csmc-pit", sys_, SP_D, SP_N), sxs,
                  RunConfig(n_samples=n_samples, burnin=burnin, target_alpha=target),
                  torch.full((SP_T,), SP_DELTA0, dtype=f32, device=dev), 20,
                  pit_launches(SP_T, SP_N), (0.05, 0.95), 10))
    for draws in ("joint", "fused"):
        one, many = pit_big_chains(dev, card, draws)
        add(one)
        for k in chained:
            chained[k] += many[k]
    return total, chained


def phase_pit_rare(dev):
    """Phase 19: rare-event csmc with parallel=True in f64 against the closed
    form; returns the stitching launches summed over the chains."""
    total = dict.fromkeys(STITCH_KERNELS, 0)
    log("phase 19: rare-event csmc parallel=True (PIT), f64, delta adapted from 0.5 toward 0.5; "
        "moments against the closed form (tolerance 6 standard errors, as phase 11)")
    for i, (cell, N_, burnin, n_samples, draws) in enumerate(RE_PIT):
        launches = rare_chain(dev, "csmc-pit" + ("-fused" if draws == "fused" else ""), cell,
                              burnin, n_samples, 40 + i, N_,
                              pit_launches(cell[3], N_, draws=draws))
        for k in total:
            total[k] += launches[k]
    return total


# ---------------------------------------------------------------------------
# The SV auxiliary-Kalman path: kalman-1/2 at the published D = 30, on the MH
# kernels' D = 32 instance
# ---------------------------------------------------------------------------

SV_KALMAN = {"kalman-1": ("kalman1", 1), "kalman-2": ("kalman2", 2)}  # style: committed run, order
SV_KALMAN_SCHEDULE = (50, 100)   # burn-in + sampling iterations at the committed delta, frozen
SV_KALMAN_RATE = (0.35, 0.65)    # update rate: the committed runs adapted delta toward 0.5
SV_KALMAN_Z_RMS = 1.5            # RMS z of the chain's mean against the committed run's
# What each kernel's name holds in the profiler at the D = 32 instance, in
# float32 (kalman_fused.cu: <S, D, NT>; scan.cu: the op <S, D>).
WIDE_NAMES = {"make_elements": r"elements_kernel<float, 32\b",
              "filter_scan": r"FilterOp<float, 32>",
              "ell": r"ell_kernel<float, 32\b",
              "backward_maps": r"backward_maps_kernel<float, 32\b",
              "affine_scan": r"AffineOp<float, 32>",
              "logdensity_steps": r"logdensity_kernel<float, 32\b"}


def random_mh_inputs(dev, T_, d, seed):
    """A random well-conditioned LGSSM at dx = dy = d (F of spectral radius
    ~0.5, Q and R = A A^T / d + I), made in float64 on the CPU and cast to
    float32 on the card: its kernel inputs (as `mh_inputs`) and the normals
    of a draw."""
    import torch
    from aux_ssm_tpu_torch.ops.filtering import kalman_update
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    def spd(*lead):
        A = randn(*lead, d, d)
        return A @ A.mT / d + torch.eye(d, dtype=torch.float64)

    F, Q, b = 0.5 * randn(T_ - 1, d, d) / d ** 0.5, spd(T_ - 1), randn(T_ - 1, d)
    H, R, c, ys = randn(T_, d, d) / d ** 0.5, spd(T_), randn(T_, d), randn(T_, d)
    m0u, P0u, _ = kalman_update(ys[0], randn(d), spd(), H[0], c[0], R[0])
    steps = (F, Q, b, H[1:], R[1:], c[1:], ys[1:])
    cast = [z.to(device=dev, dtype=torch.float32).contiguous()
            for z in steps + (m0u, P0u, randn(T_, d))]
    return tuple(cast[:7]), cast[7], cast[8], cast[9]


def edge_kernels(dev, T_, d, **kw):
    """make_elements and the filter scan on a random well-conditioned model at
    dx = dy = d (`random_mh_inputs`), an instance's edge, against their plain
    versions (`compare`, with `kw`). The other four kernels pad d as
    make_elements does and run at the edges in the card tests
    (`tests/test_torch_cuda.py`) and the host build."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    log(f"  make_elements and the filter scan on a random well-conditioned model at dx=dy={d}, "
        f"T={T_} (the instance's edge):")
    steps, m0u, P0u, _ = random_mh_inputs(dev, T_, d, seed=d)
    n, ops = T_ - 1, mh_ops(T_ - 1, d)
    m_el = torch.cat([m0u[None], m0u.new_zeros(n - 1, d)])
    P_el = torch.cat([P0u[None], P0u.new_zeros(n - 1, d, d)])
    compare(f"make_elements_d{d}_random", KF.make_elements, KF.make_elements_plain,
            steps + (m_el, P_el), ops["make_elements"], **kw)
    compare(f"filter_scan_d{d}_random", FS.filter_scan, FS.filter_scan_plain,
            (_make_associative_elements(*steps, m0u, P0u),), ops["filter_scan"], **kw)


def phase_wide_kernels(dev):
    """Phase 20: the six MH kernels' D = 32 instance on a real SV kalman-1
    step's inputs, and on random models at the instance's edges; returns the
    entries at the SV shape."""
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv

    ys, xs, delta = load_sv("kalman1", dev, torch.float32)
    delta = float(delta)
    dyn, obs1, _, _ = sv.get_kalman_factories(ys, *SV_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(20)
    u = xs + (0.5 * delta) ** 0.5 * torch.randn(xs.shape, generator=gen, device=dev)
    eps = torch.randn(xs.shape, generator=gen, device=dev)
    steps, m0u, P0u = mh_inputs(dyn, obs1, xs, u, delta)
    log(f"phase 20: the MH kernels' D = 32 instance on a real SV kalman-1 step's inputs "
        f"(T={SV_T}, dx=dy={SV_D}, the committed run's xs_true and delta {delta:.4f}; f32 kernel "
        f"vs f32 plain and vs f64 plain at nrel {NREL_F32:g}, or, for an output whose f32 plain "
        f"version misses {NREL_F32:g} against f64 by e, at 3 e and 2 e; f64 kernel vs f64 "
        f"plain at {NREL_F64:g})")
    results = check_mh_kernels("_d32", steps, m0u, P0u, eps, holes_seed=20, own_bound=True,
                               device_time=True)[0]
    for d in (17, 32):
        edge_kernels(dev, SV_T, d, own_bound=True, reps=5)
    return results


def phase_sv_kalman_steps(dev):
    """Phase 21: three f64 SV kalman steps of each order (T=32, D=30: the
    D = 32 instance) on the card against the CPU, given the same noise, with
    identical accept decisions; the card's steps launch each kernel as the
    MH step does."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import cuda as K

    T_, n_steps = 32, 3
    xs, ys = sv.get_data(*SV_PARAMS, SV_D, T_, generator=torch.Generator().manual_seed(21),
                         device="cpu")
    for order in (1, 2):
        runs = {}
        for where in ("cpu", dev):
            init, kernel = sv.get_kalman_kernel(ys.to(where), *SV_PARAMS, True, order)
            rng = np.random.default_rng(order)
            state = init(xs.to(where))
            K.reset_launches()
            out = []
            for _ in range(n_steps):
                noise = (torch.as_tensor(rng.standard_normal((T_, SV_D)), device=where),
                         torch.as_tensor(rng.standard_normal((T_, SV_D)), device=where),
                         torch.as_tensor(rng.uniform(), dtype=torch.float64, device=where))
                state = kernel(state, 0.05, noise=noise)
                out.append((state.x.cpu(), bool(state.updated), state.log_target.cpu()))
            runs[str(where)] = out
        launches = K.launches()
        for name, (_, _, per_step) in KERNELS.items():
            if launches[name] != per_step * n_steps:
                raise AssertionError(f"SV kalman order {order}: {name} launched "
                                     f"{launches[name]} times on the card, expected "
                                     f"{per_step * n_steps}")
        worst = 0.0
        for (xc, uc, lc), (xg, ug, lg) in zip(runs["cpu"], runs[str(dev)]):
            if uc != ug:
                raise AssertionError(f"SV kalman order {order}: accept differs between card "
                                     "and CPU")
            worst = max(worst, nrel(xg, xc), float(abs(lg - lc) / abs(lc)))
        accepted = sum(u for _, u, _ in runs["cpu"])
        log(f"  SV kalman order {order}, T={T_}, D={SV_D}, f64, {accepted} of {n_steps} accepted: "
            f"card vs CPU rel err {worst:.3e} (bound {STEP_RTOL:g})")
        if not worst <= STEP_RTOL:
            raise AssertionError(f"SV kalman order {order}: card and CPU steps differ by "
                                 f"{worst:.3e}")


def phase_sv_kalman_chains(dev, card):
    """Phase 22: kalman-1 and kalman-2 at T=250, D=30, f32, parallel, from
    the committed runs' data, xs_true and adapted delta (frozen); returns
    the six kernels' launches summed over both chains. `card` is the card's
    name and power limit, printed beside samples/s."""
    import re
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import cuda as K

    burnin, n_samples = SV_KALMAN_SCHEDULE
    total = dict.fromkeys(KERNELS, 0)
    log(f"phase 22: SV kalman chains, T={SV_T}, D={SV_D}, f32, parallel, {burnin} + {n_samples} "
        "iterations at the committed run's delta (frozen), from xs_true")
    for style, (name, order) in SV_KALMAN.items():
        ys, xs, delta = load_sv(name, dev, torch.float32)
        committed = np.load(SV_NPZ.format(name))
        init, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, order)
        gen = torch.Generator(device=dev).manual_seed(22 + order)
        K.reset_launches()
        res = runner.run_chain(kernel, init(xs), RunConfig(n_samples=n_samples, burnin=burnin,
                                                           learning_rate=0.0),
                               generator=gen, delta_init=delta)
        launches = K.launches()
        n_iter = burnin + n_samples
        if tuple(res.state.x.shape) != (SV_T, SV_D) or not bool(torch.isfinite(res.state.x).all()):
            raise AssertionError(f"{style}: the chain's state is not finite")
        for kname, count in launches.items():
            want = KERNELS[kname][2] * n_iter if kname in KERNELS else 0
            if count != want:
                raise AssertionError(f"{style}: {kname} launched {count} times in {n_iter} "
                                     f"iterations, expected {want}")
        rate = float(res.stats.accept_cum)
        z = (res.stats.mean_x.cpu().double().numpy() - committed["samples_mean"]) \
            / committed["samples_std"]
        z_rms = float(np.sqrt(np.mean(z ** 2)))
        sps = n_samples / res.sampling_time
        log(f"  {style}: update rate {rate:.4f}, {sps:.2f} samples/s on {card}, RMS z of the "
            f"mean against the committed run's {z_rms:.3f} (bound {SV_KALMAN_Z_RMS}), delta "
            f"{float(delta):.4f}, launches a step "
            f"{({k: v // n_iter for k, v in launches.items() if v})}")
        if not SV_KALMAN_RATE[0] <= rate <= SV_KALMAN_RATE[1]:
            raise AssertionError(f"{style}: update rate {rate:.4f} outside {SV_KALMAN_RATE}")
        if not z_rms <= SV_KALMAN_Z_RMS:
            raise AssertionError(f"{style}: the chain's mean is {z_rms:.3f} RMS posterior "
                                 "deviations from the committed run's")
        box = [res.state]
        events = profile_steps(f"SV {style}",
                               lambda: box.__setitem__(0, kernel(box[0], delta, generator=gen)),
                               also=tuple(WIDE_NAMES))
        names = [e.key for e in events]
        missing = [k for k, pat in WIDE_NAMES.items()
                   if not any(re.search(pat, key) for key in names)]
        narrow = [key for key in names if re.search(r"_kernel<float, 16\b|Op<float, 16>", key)]
        if missing or narrow:
            raise AssertionError(f"{style}: the profiler shows no D = 32 instance of {missing} "
                                 f"or a D = 16 one: {narrow}")
        for k in total:
            total[k] += launches[k]
    return total


# ---------------------------------------------------------------------------
# The Lorenz-63 parameter-learning Gibbs sampler on the Mider data (freq 4:
# T=5001, dx=3, dy=3+2), on the MH kernels' D = 16 instance
# ---------------------------------------------------------------------------

LORENZ_NPZ = str(Path(__file__).resolve().parent
                 / "benchmarks/results_r5/lorenz/mider_freq{}.npz")
LORENZ_SIGMA_X = 3.0               # experiments/lorenz.py SIGMA_X
LORENZ_DELTAS = (1e20, 1e-2)       # the committed runs' delta (the adaptation's cap), and one
                                   # at which the u rows carry weight
LORENZ_SCHEDULE = (50, 100)        # burn-in + sampling iterations at delta 1e20, frozen
LORENZ_RATE = (0.50, 0.76)         # update rate: the committed freq-4 run updated 0.632
LORENZ_THETA_Z = 3.0               # |chain mean - committed mean| in committed posterior sds
LORENZ_MEAN_RMS = 5.0 ** 0.5       # RMS of the mean trajectory against the committed one, on
                                   # the observed x2 and x3: sig_y
# What each kernel's name holds in the profiler at the D = 16 instance, in float32.
NARROW_NAMES = {"make_elements": r"elements_kernel<float, 16\b",
                "filter_scan": r"FilterOp<float, 16>",
                "ell": r"ell_kernel<float, 16\b",
                "backward_maps": r"backward_maps_kernel<float, 16\b",
                "affine_scan": r"AffineOp<float, 16>",
                "logdensity_steps": r"logdensity_kernel<float, 16\b"}


def lorenz_factories(dev, freq, dtype):
    """The committed Mider run of `freq`'s mean_x and theta, and the Lorenz
    MH step's factories (dynamics, observations, target) at that theta."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lorenz

    prob = mider_problem(freq, dtype=dtype, device=dev)
    committed = np.load(LORENZ_NPZ.format(freq))
    x = torch.as_tensor(committed["mean_x"], dtype=dtype, device=dev)
    return x, lorenz.get_kalman_factories(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                          committed["theta"], LORENZ_SIGMA_X, prob.dt)


def lorenz_step_inputs(dev, freq, dtype, delta, seed):
    """A Lorenz MH step at the committed run's mean_x and theta on the Mider
    grid of `freq`: (kernel inputs as `mh_inputs`, m0u, P0u, eps, the
    factories, x, u)."""
    import torch
    x, factories = lorenz_factories(dev, freq, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = x + (0.5 * delta) ** 0.5 * torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
    eps = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
    steps, m0u, P0u = mh_inputs(factories[0], factories[1], x, u, delta)
    return steps, m0u, P0u, eps, factories, x, u


def mh_log_alpha(factories, x, u, eps, delta):
    """log alpha of one parallel MH step at x, given u and the draw's normals:
    the kernel's formula (kernels/kalman.py) from the public ops, so that
    each term can be computed in f32 and f64, by the plain versions (CPU
    tensors) or the kernels (CUDA tensors)."""
    from aux_ssm_tpu_torch.ops import LGSSM, filtering, posterior_logpdf, sampling
    dyn, obs, target = factories

    def propose(x_at, x_eval=None):
        m0, P0, Fs, Qs, bs = dyn(x_at)
        ys, Hs, Rs, cs = obs(x_at, u, delta)
        model = LGSSM(m0, P0, Fs, Qs, bs, Hs, Rs, cs)
        ms, Ps, ell = filtering(ys, model, True)
        if x_eval is None:
            x_eval = sampling(eps, ms, Ps, model, True)
        return posterior_logpdf(ys, x_eval, ell, model), x_eval

    log_fwd, x_prop = propose(x)
    log_rev, _ = propose(x_prop, x)
    aux = (((x_prop - u) ** 2 - (x - u) ** 2) / delta).sum()
    return float(target(x_prop) - target(x) + log_rev - log_fwd - aux)


def phase_lorenz_kernels(dev):
    """Phase 23: the six MH kernels' D = 16 instance on real Lorenz steps'
    inputs (Mider freq 4, T=5001, dx=3, dy=5) at delta 1e20 and 1e-2, the two
    scans also at freq 2 (T=10001); log alpha in f32 against f64. Returns
    the entries at freq 4, delta 1e20."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps

    f32, f64 = torch.float32, torch.float64
    log(f"phase 23: the MH kernels' D = 16 instance on a real Lorenz step's inputs (Mider freq 4, "
        f"T=5001, dx=3, dy=5: the committed run's mean_x and theta; f32 kernel vs f32 plain and "
        f"vs f64 plain at nrel {NREL_F32:g}, or, for an output whose f32 plain version misses "
        f"{NREL_F32:g} against f64 by e, at 3 e and 2 e; f64 kernel vs f64 plain at "
        f"{NREL_F64:g}; bounds on the unpadded bytes, operations at d = 5)")
    results = None
    for i, delta in enumerate(LORENZ_DELTAS):
        steps, m0u, P0u, eps, _, x, u = lorenz_step_inputs(dev, 4, f32, delta, 23 + i)
        log(f"  delta {delta:g} (R = {0.5 * delta:g} on the u rows):")
        got = check_mh_kernels(f"_lorenz_delta{delta:g}", steps, m0u, P0u, eps, None,
                               own_bound=True, device_time=not i, reps=20 if not i else 5)[0]
        results = results or got
        # log alpha of the same step in f32 and f64, plain (CPU) and kernels (card).
        alphas = {}
        for where in ("cpu", dev):
            for dtype in (f32, f64):
                z = tuple(t.to(device=where, dtype=dtype) for t in (x, u, eps))
                alphas[(str(where), str(dtype)[6:])] = mh_log_alpha(
                    lorenz_factories(where, 4, dtype)[1], *z, delta)
        log("  log alpha at the committed state, plain (cpu) and kernels (cuda), f32 / f64: "
            + ", ".join(f"{w} {d} {a:.6f}" for (w, d), a in alphas.items()))
    for k, v in results.items():
        log(f"  {k} at T=5001: {1e6 * v['device_ms'] / 5000:.2f} ns a step on the device, "
            f"{v['device_ms'] / v['bound_ms']:.1f}x its bound on the unpadded bytes"
            if v.get("device_ms") else f"  {k}: device ms not measured")
    log("  the two scans at freq 2 (T=10001, chunks of 79):")
    steps, m0u, P0u, eps, _, _, _ = lorenz_step_inputs(dev, 2, f32, LORENZ_DELTAS[0], 25)
    n = steps[2].shape[0]
    ops = mh_ops(n, 5)
    elems = _make_associative_elements(*steps, m0u, P0u)
    compare("filter_scan_lorenz_T10001", FS.filter_scan, FS.filter_scan_plain, (elems,),
            ops["filter_scan"], reps=5, own_bound=True, device_time=True)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    gains, incs = _backward_maps(eps, ms, Ps, *steps[:3])
    compare("affine_scan_lorenz_T10001", FS.affine_scan, FS.affine_scan_plain,
            (gains, incs, True), ops["affine_scan"], reps=5, own_bound=True, device_time=True)
    return results


def lorenz_synthetic(where, T_=64, every=4):
    """A synthetic Lorenz problem in f64 on `where` (the JAX tests' shape:
    dt 0.02, sig_y 0.5, observed every `every` steps): (xs, problem)."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import lorenz as driver
    from aux_ssm_tpu_torch.models import lorenz

    xs = lorenz.sample_trajectory(driver.M0, np.eye(3), driver.THETA_TRUE, LORENZ_SIGMA_X, 0.02,
                                  T_, generator=torch.Generator().manual_seed(24), device="cpu")
    idx = np.arange(0, T_, every)
    obs = xs.numpy()[idx, 1:] + driver.SIG_Y * np.random.default_rng(24).standard_normal(
        (len(idx), 2))
    prob = driver.make_problem(np.column_stack([idx * 0.02, obs]), idx, T_, 0.02, np.eye(3),
                               driver.SIG_Y, [0.0, 0.0, 0.0], 100.0,
                               dict(dtype=torch.float64, device=where))
    return xs.to(where), prob


def phase_lorenz_steps(dev):
    """Phase 24: four f64 Lorenz Gibbs steps (T=64, observed every 4,
    parallel) on the card against the CPU, given the same noise: identical
    accept decisions, trajectories and theta to STEP_RTOL, 10 MH-kernel
    launches a step on the card."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.models import lorenz
    from aux_ssm_tpu_torch.ops import cuda as K

    T_, n_steps, delta = 64, 4, 10.0  # at delta 10 this grid's steps accept and reject
    runs = {}
    for where in ("cpu", dev):
        xs, prob = lorenz_synthetic(where, T_)
        init, kernel = lorenz.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0,
                                               prob.P0, LORENZ_SIGMA_X, prob.dt,
                                               prob.sigma_theta, True)
        rng = np.random.default_rng(24)
        state = init(xs, prob.theta0)
        K.reset_launches()
        out = []
        for _ in range(n_steps):
            z = [torch.as_tensor(rng.standard_normal((T_, 3)), device=where) for _ in range(2)]
            noise = ((z[0], z[1], torch.as_tensor(rng.uniform(), dtype=torch.float64,
                                                   device=where)),
                     torch.as_tensor(rng.standard_normal(3), device=where))
            state = kernel(state, delta, noise=noise)
            out.append((state.x.cpu(), bool(state.updated), state.theta.cpu()))
        runs[str(where)] = out
    launches = K.launches()
    for name, (_, _, per_step) in KERNELS.items():
        if launches[name] != per_step * n_steps:
            raise AssertionError(f"Lorenz Gibbs: {name} launched {launches[name]} times on the "
                                 f"card, expected {per_step * n_steps}")
    worst = 0.0
    for (xc, uc, tc), (xg, ug, tg) in zip(runs["cpu"], runs[str(dev)]):
        if uc != ug:
            raise AssertionError("Lorenz Gibbs: accept differs between card and CPU")
        worst = max(worst, nrel(xg, xc), nrel(tg, tc))
    accepted = [u for _, u, _ in runs["cpu"]]
    log(f"  Lorenz Gibbs, T={T_}, f64, delta {delta:g}, accepted {accepted}: card vs CPU rel err "
        f"{worst:.3e} (bound {STEP_RTOL:g})")
    if not worst <= STEP_RTOL:
        raise AssertionError(f"Lorenz Gibbs: card and CPU steps differ by {worst:.3e}")


def check_lorenz_chain(label, res, committed, n_samples, launches, n_iter, card):
    """A Lorenz Gibbs run from the committed run's state at its delta (one
    chain, or C chains with a leading chain axis, pooled): finite states,
    the update rate (all chains') in LORENZ_RATE, each theta_i's mean within
    LORENZ_THETA_Z committed posterior deviations of the committed
    `theta_samples` mean, the mean trajectory within RMS LORENZ_MEAN_RMS of
    the committed `mean_x` on the observed x2 and x3; samples/s of all
    chains printed."""
    import numpy as np
    import torch
    x, theta = res.state.x, res.state.theta
    if tuple(x.shape[-2:]) != (5001, 3) or not bool(torch.isfinite(x).all()) \
            or not bool(torch.isfinite(theta).all()):
        raise AssertionError(f"{label}: the chain's state is not finite")
    chains = x.shape[0] if x.dim() == 3 else 1
    rate = float(res.stats.accept_cum.mean())
    ts, want_ts = res.samples.reshape(-1, 3), committed["theta_samples"]
    z = (ts.mean(0) - want_ts.mean(0)) / want_ts.std(0)
    mean_x = res.stats.mean_x.cpu().double().numpy().reshape(-1, 5001, 3).mean(0)
    rms = float(np.sqrt(np.mean((mean_x[:, 1:] - committed["mean_x"][:, 1:]) ** 2)))
    sps = chains * n_samples / res.sampling_time
    log(f"  {label}: update rate {rate:.4f} (committed 0.632), {sps:.2f} samples/s of "
        f"{chains} chain(s) on {card}; theta mean {np.round(ts.mean(0), 3)} against the "
        f"committed {np.round(want_ts.mean(0), 3)} (sd {np.round(want_ts.std(0), 3)}): z "
        f"{np.round(z, 2)} (bound {LORENZ_THETA_Z}); RMS of the mean trajectory against the "
        f"committed on x2, x3 {rms:.4f} (bound {LORENZ_MEAN_RMS:.4f}); launches a step "
        f"{({k: v // n_iter for k, v in launches.items() if v})}")
    if not LORENZ_RATE[0] <= rate <= LORENZ_RATE[1]:
        raise AssertionError(f"{label}: update rate {rate:.4f} outside {LORENZ_RATE}")
    if not np.all(np.abs(z) <= LORENZ_THETA_Z):
        raise AssertionError(f"{label}: theta's chain mean is {z} committed sds off")
    if not rms <= LORENZ_MEAN_RMS:
        raise AssertionError(f"{label}: the mean trajectory is {rms:.4f} RMS off the committed")


def phase_lorenz_chain(dev, card):
    """Phase 25: the Mider freq-4 Gibbs chain, f32, parallel, from the
    committed run's mean_x and theta at its delta (1e20, frozen). Returns the
    six kernels' launches in the chain."""
    import re
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lorenz
    from aux_ssm_tpu_torch.ops import cuda as K

    burnin, n_samples = LORENZ_SCHEDULE
    n_iter = burnin + n_samples
    committed = np.load(LORENZ_NPZ.format(4))
    delta = float(committed["delta"])
    log(f"phase 25: the Lorenz Gibbs chain on the Mider data, freq 4 (T=5001), f32, parallel, "
        f"{burnin} + {n_samples} iterations at the committed run's delta {delta:g} (frozen), "
        "from its mean_x and theta")
    prob = mider_problem(4, device=dev)
    init, kernel = lorenz.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                           LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True)
    x0 = torch.as_tensor(committed["mean_x"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    K.reset_launches()
    res = runner.run_chain(kernel, init(x0, committed["theta"]),
                           RunConfig(n_samples=n_samples, burnin=burnin, learning_rate=0.0),
                           generator=gen, delta_init=delta, collect_samples=True,
                           collect_fn=lambda s: s.theta)
    launches = K.launches()
    for name, count in launches.items():
        want = KERNELS[name][2] * n_iter if name in KERNELS else 0
        if count != want:
            raise AssertionError(f"Lorenz: {name} launched {count} times in {n_iter} "
                                 f"iterations, expected {want}")
    check_lorenz_chain("Lorenz freq 4", res, committed, n_samples, launches, n_iter, card)
    box = [res.state]
    events = profile_steps("Lorenz Gibbs freq 4",
                           lambda: box.__setitem__(0, kernel(box[0], delta, generator=gen)),
                           n=20)
    names = [e.key for e in events]
    missing = [k for k, pat in NARROW_NAMES.items()
               if not any(re.search(pat, key) for key in names)]
    wide = [key for key in names if re.search(r"_kernel<float, 32\b|Op<float, 32>", key)]
    if missing or wide:
        raise AssertionError(f"Lorenz: the profiler shows no D = 16 instance of {missing} or a "
                             f"D = 32 one: {wide}")
    log("  the six kernels in the step (device ms, by the profiler): " + ", ".join(
        f"{k} {sum(e.self_device_time_total for e in events if re.search(pat, e.key)) / 2e4:.4f}"
        for k, pat in NARROW_NAMES.items()))
    return {k: launches[k] for k in KERNELS}


# ---------------------------------------------------------------------------
# The experiment drivers on the card (experiments/sv.py, experiments/spatial.py
# with utils/checkpoint.py) and the divide-and-conquer sampler
# ---------------------------------------------------------------------------

SV_DRIVER_SCHEDULE = (300, 200)    # burn-in + sampling of the checkpointed kalman-1 run
SV_DRIVER_LR = 0.5                 # its delta adaptation's rate (the driver's --lr)
SV_DRIVER_EVERY = 50               # checkpoint period: burn-in 50, ..., 300, sampling 50, ..., 200
SV_KEYS = {"samples_mean", "samples_std", "ejsd", "delta", "xs_true", "ys", "sampling_time"}
SP_KEYS = {"mean_x", "var_x", "ejsd", "delta", "xs_true", "ys", "sampling_time"}
DNC_Z_MAX = 6.0                    # |z| of the D&C draws' moments against the scan sampler's
DNC_DRAWS = 128


class Killed(RuntimeError):
    """Raised by a dying checkpoint save to cut a driver's run short."""


def driver_run(main, argv, per_iter, n_iter, label, card):
    """`main(argv)` of a driver with the launch counters reset before and
    read after: each kernel of `per_iter` launched exactly that many times an
    iteration, no other. Returns (result, the saved .npz as a dict)."""
    import numpy as np
    from aux_ssm_tpu_torch.ops import cuda as K
    K.reset_launches()
    res = main(argv)
    launches = K.launches()
    for name, count in launches.items():
        if count != per_iter.get(name, 0) * n_iter:
            raise AssertionError(f"{label}: {name} launched {count} times in {n_iter} "
                                 f"iterations, expected {per_iter.get(name, 0)} each")
    out = argv[argv.index("--out") + 1]
    with np.load(out) as z:
        saved = {k: z[k] for k in z.files}
    n_samples = int(argv[argv.index("--n-samples") + 1])
    log(f"  {label}: update rate {float(res.stats.accept_cum.mean()):.4f}, "
        f"{n_samples / res.sampling_time:.2f} samples/s on {card}, launches a step "
        f"{({k: v // n_iter for k, v in launches.items() if v})}")
    return res, saved, launches


def check_saved(label, saved, keys, shapes):
    """The driver's .npz holds the JAX driver's keys with its shapes, finite."""
    got = {k: tuple(v.shape) for k, v in saved.items()}
    if set(saved) != keys or any(got[k] != shape for k, shape in shapes.items()):
        raise AssertionError(f"{label}: the driver wrote {got}")
    import numpy as np
    bad = [k for k, v in saved.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{label}: non-finite {bad}")


def phase_sv_driver(dev, card, out_dir):
    """Phase 26: `experiments.sv.main` on the card at T=250, D=30, f32:
    kalman-1 checkpointed every SV_DRIVER_EVERY iterations, killed after its
    second sampling segment and resumed, against an uninterrupted run (bit
    for bit but the sampling time); then csmc (PIT) and csmc-guided with
    `--n-chains` CSMC_CHAINS["sv"] at CSMC_SV_SCHEDULE, each counted at C =
    1 (`csmc_chain_driver`). Returns the kernels' launches of the
    uninterrupted and C = 1 runs, and each style's C run's."""
    import numpy as np
    from aux_ssm_tpu_torch.experiments import runner
    from aux_ssm_tpu_torch.experiments import sv as driver
    from aux_ssm_tpu_torch.ops import cuda as K

    burnin, n_samples = SV_DRIVER_SCHEDULE
    n_iter = burnin + n_samples
    out = Path(out_dir)
    log(f"phase 26: the SV driver, T={SV_T}, D={SV_D}, f32: kalman-1 {burnin} + {n_samples} "
        f"iterations from the driver's start (init_x_fn, --delta-init default, --lr "
        f"{SV_DRIVER_LR}), checkpointed "
        f"every {SV_DRIVER_EVERY}, killed after its second sampling segment and resumed, "
        "against an uninterrupted run")

    def argv(style, name, schedule, *extra):
        return ["--style", style, "--T", str(SV_T), "--D", str(SV_D), "--N", str(SV_N),
                "--burnin", str(schedule[0]), "--n-samples", str(schedule[1]), "--no-verbose",
                "--out", str(out / f"{name}.npz"), *extra]

    mh_step = {name: per_step for name, (_, _, per_step) in KERNELS.items()}
    kalman = argv("kalman-1", "sv_kalman1", SV_DRIVER_SCHEDULE, "--lr", str(SV_DRIVER_LR))
    full, want, total = driver_run(driver.main, kalman, mh_step, n_iter,
                                   "kalman-1 uninterrupted", card)
    rate = float(full.stats.accept_cum)
    if not SV_KALMAN_RATE[0] <= rate <= SV_KALMAN_RATE[1]:
        raise AssertionError(f"SV driver kalman-1: update rate {rate:.4f} outside "
                             f"{SV_KALMAN_RATE}")

    # Killed at the save that ends the second sampling segment.
    save, saves, kill_at = runner._save, [], burnin // SV_DRIVER_EVERY + 2

    def timed_save(directory, payload, step):
        tic = time.perf_counter()
        save(directory, payload, step)
        saves.append((step, time.perf_counter() - tic))
        if len(saves) == kill_at:
            raise Killed()

    ckpt = ["--checkpoint-dir", str(out / "ckpt"), "--checkpoint-every", str(SV_DRIVER_EVERY)]
    resumed_argv = argv("kalman-1", "sv_kalman1_resumed", SV_DRIVER_SCHEDULE, "--lr",
                        str(SV_DRIVER_LR), *ckpt)
    runner._save = timed_save
    try:
        K.reset_launches()
        try:
            driver.main(resumed_argv)
            raise AssertionError("SV driver: the dying save did not cut the run")
        except Killed:
            pass
        killed = K.launches()
        kill_at = 0
        resumed, got, rest = driver_run(driver.main, resumed_argv, mh_step,
                                        n_samples - 2 * SV_DRIVER_EVERY, "kalman-1 resumed",
                                        card)
    finally:
        runner._save = save
    want_steps = ([phase * 10 ** 9 + i for phase, n in ((0, burnin), (1, n_samples))
                   for i in range(SV_DRIVER_EVERY, n + 1, SV_DRIVER_EVERY)])
    if [k for k, _ in saves] != want_steps:
        raise AssertionError(f"SV driver: checkpoints at {[k for k, _ in saves]}")
    if any(killed[k] + rest[k] != total[k] for k in total):
        raise AssertionError(f"SV driver: killed {killed} + resumed {rest} launches differ from "
                             f"the uninterrupted run's {total}")
    check_saved("SV kalman-1", want, SV_KEYS, {"samples_mean": (SV_T, SV_D), "delta": ()})
    differ = [k for k in want if k != "sampling_time" and not np.array_equal(got[k], want[k])]
    if differ or not np.array_equal(resumed.state.x.cpu().numpy(), full.state.x.cpu().numpy()):
        raise AssertionError(f"SV driver: the resumed run differs from the uninterrupted one "
                             f"in {differ or 'the final state'}")
    log(f"  kalman-1 resumed from sampling iteration {2 * SV_DRIVER_EVERY}: every key but "
        f"sampling_time bit for bit the uninterrupted run's; update rate {rate:.4f} (bounds "
        f"{SV_KALMAN_RATE}); checkpoint saves on {card} (step: s) "
        + ", ".join(f"{k}: {t:.4f}" for k, t in saves))

    C = CSMC_CHAINS["sv"]
    log(f"  csmc (parallel-in-time) and csmc-guided, then csmc --no-parallel with "
        f"--resampling systematic and with --no-backward --debug-nans, with --n-chains {C} (one "
        f"batched step), {CSMC_SV_SCHEDULE[0]} + {CSMC_SV_SCHEDULE[1]} from the driver's start, "
        f"each counted at C = 1 for {CSMC_ONE_CHAIN[0]} + {CSMC_ONE_CHAIN[1]}:")

    def check(style):
        def saved_ok(saved):
            check_saved(f"SV {style} --n-chains {C}", saved, SV_KEYS,
                        {"samples_mean": (SV_T, SV_D), "samples_std": (SV_T, SV_D),
                         "ejsd": (SV_T, SV_D), "xs_true": (SV_T, SV_D), "ys": (SV_T, SV_D),
                         "delta": (C, SV_T), "sampling_time": ()})
        return saved_ok

    pit = dict(pit_launches(SV_T, SV_N))
    guided = {"block_lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES}
    chained = {}
    # The sequential csmc under the options that looped chain after chain
    # before: systematic resampling (the generic forward loop, then the
    # backward factor sweep) and ancestor scanning (the forward factor sweep,
    # then the scan; with --debug-nans, the finite check after every step).
    runs = (("csmc", (), "csmc", pit, CSMC_SV_SCHEDULE),
            ("csmc-guided", (), "csmc-guided", guided, CSMC_SV_SCHEDULE),
            ("csmc", ("--no-parallel", "--resampling", "systematic"), "csmc-systematic",
             {"backward_factor_scan": FACTOR_LAUNCHES}, CSMC_SEQ_SCHEDULE),
            ("csmc", ("--no-parallel", "--no-backward", "--debug-nans"), "csmc-scan",
             {"forward_factor_scan": FACTOR_LAUNCHES}, CSMC_SV_SCHEDULE))
    for style, extra, key, per_iter, schedule in runs:
        one, chained[key] = csmc_chain_driver(
            driver.main, ["--style", style, "--T", str(SV_T), "--D", str(SV_D), "--N", str(SV_N),
                          "--no-verbose", *extra], str(out / f"sv_{key}"),
            f"SV {' '.join((style,) + extra)} --n-chains {C}", card, C, schedule, per_iter,
            check(style))
        for k, v in one.items():
            total[k] = total.get(k, 0) + v
    return total, chained


def phase_spatial_driver(dev, card, out_dir):
    """Phase 27: `experiments.spatial.main` on the card at T=1024, 8x8, N=25,
    f32, kalman-2, csmc (parallel-in-time) and csmc-guided with `--n-chains`
    CSMC_CHAINS["spatial"] (one batched step each) at CSMC_SP_SCHEDULE from
    the driver's start, each counted at C = 1 for CSMC_ONE_CHAIN
    (`csmc_chain_driver`): the data equal `get_data`'s from the seed, the
    JAX driver's keys and shapes, finite moments, exact launches, equal an
    iteration at C = 1 and at C. Returns the C = 1 runs' launches and each
    style's C run's."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import spatial as driver

    C = CSMC_CHAINS["spatial"]
    B = SP_D * SP_D
    log(f"phase 27: the spatial driver, T={SP_T}, {SP_D}x{SP_D}, N={SP_N}, f32, seed {SP_SEED}: "
        f"kalman-2, csmc (parallel-in-time) and csmc-guided with --n-chains {C} (one batched "
        f"step), {CSMC_SP_SCHEDULE[0]} + {CSMC_SP_SCHEDULE[1]} iterations, each counted at C = 1 "
        f"for {CSMC_ONE_CHAIN[0]} + {CSMC_ONE_CHAIN[1]}")
    xs, ys = (z.numpy() for z in spatial_data("cpu", torch.float64))

    def check(style):
        kalman = style.startswith("kalman")
        x_shape = (SP_T, B, 1) if kalman else (SP_T, B)

        def saved_ok(saved):
            check_saved(f"spatial {style} --n-chains {C}", saved, SP_KEYS,
                        {"mean_x": x_shape, "var_x": x_shape, "ejsd": x_shape,
                         "xs_true": (SP_T, B), "ys": (SP_T, B), "sampling_time": (),
                         "delta": (C,) if kalman else (C, SP_T)})
            if not (np.array_equal(saved["ys"], ys) and np.array_equal(saved["xs_true"], xs)):
                raise AssertionError(f"spatial {style}: the driver's data are not get_data's")
            if not (saved["var_x"] >= 0).all():
                raise AssertionError(f"spatial {style}: negative posterior variances")
        return saved_ok

    per_iter = {"kalman-2": SP_PER_ITER["kalman"], "csmc": dict(pit_launches(SP_T, SP_N)),
                "csmc-guided": SP_PER_ITER["csmc-guided"]}
    total, chained = {}, {}
    for style, per in per_iter.items():
        one, chained[style] = csmc_chain_driver(
            driver.main, ["--style", style, "--T", str(SP_T), "--D", str(SP_D), "--N", str(SP_N),
                          "--seed", str(SP_SEED), "--no-verbose"],
            str(Path(out_dir) / f"spatial_{style}"), f"spatial {style} --n-chains {C}", card, C,
            CSMC_SP_SCHEDULE, per, check(style))
        for k, v in one.items():
            total[k] = total.get(k, 0) + v
    return total, chained


def phase_dnc_sampling(dev, card):
    """Phase 28: the divide-and-conquer sampler in f64 on the card: one draw
    on the flagship LGSSM's filter output (T=1024, dx=16) given fixed noise
    against the CPU's, then DNC_DRAWS draws at T=64, dx=4 against as many of
    the scan sampler's (`ops.sampling`, parallel) in mean and standard
    deviation at every (t, i)."""
    import warnings
    import torch
    from aux_ssm_tpu_torch import lgssm_from_numpy
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops import dnc_sampling, filtering, sampling

    f64 = torch.float64
    log(f"phase 28: D&C sampling, f64: T={T}, dx={DX} card vs CPU given the same noise "
        f"(bound {STEP_RTOL:g}); {DNC_DRAWS} draws at T=64, dx=4 against the scan sampler's "
        f"(|z| <= {DNC_Z_MAX:g})")
    warnings.filterwarnings("ignore", message="dnc_sampling is a pedagogical")

    def filtered(n, dx, where):
        *params, ys = lgssm_flagship.build_arrays(n, dx)
        model, ys = lgssm_from_numpy(*params, ys, device=where, dtype=f64)
        ms, Ps, _ = filtering(ys, model, True)
        return ms, Ps, model

    ms, Ps, model = filtered(T, DX, dev)
    noise = torch.randn(T, DX, generator=torch.Generator().manual_seed(28), dtype=f64)
    cpu = lambda z: z.cpu()  # noqa: E731
    want = dnc_sampling.sampling(ms.cpu(), Ps.cpu(), type(model)(*map(cpu, model)), noise=noise)
    tic = time.perf_counter()
    got = dnc_sampling.sampling(ms, Ps, model, noise=noise.to(dev))
    torch.cuda.synchronize()
    ms_draw = 1e3 * (time.perf_counter() - tic)
    err = nrel(got.cpu(), want)
    log(f"  T={T}, dx={DX}: card vs CPU rel err {err:.3e}, one draw {ms_draw:.1f} ms on {card}")
    if not (bool(torch.isfinite(got).all()) and err <= STEP_RTOL):
        raise AssertionError(f"D&C sampling: card and CPU draws differ by {err:.3e}")

    n_t, dx = 64, 4
    ms, Ps, model = filtered(n_t, dx, dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    tic = time.perf_counter()
    dnc = torch.stack([dnc_sampling.sampling(ms, Ps, model, generator=gen)
                       for _ in range(DNC_DRAWS)])
    scan = torch.stack([sampling(torch.randn(ms.shape, generator=gen, dtype=f64, device=dev),
                                 ms, Ps, model, True) for _ in range(DNC_DRAWS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    n = DNC_DRAWS
    m1, m2, s1, s2 = dnc.mean(0), scan.mean(0), dnc.std(0), scan.std(0)
    z_mean = (m1 - m2) / torch.sqrt((s1 ** 2 + s2 ** 2) / n)
    z_std = (s1 - s2) / torch.sqrt((s1 ** 2 + s2 ** 2) / (2 * n))
    worst = float(torch.maximum(z_mean.abs().max(), z_std.abs().max()))
    log(f"  T={n_t}, dx={dx}, {n} draws each ({seconds:.1f} s on {card}): max |z| of the means "
        f"{float(z_mean.abs().max()):.2f}, of the standard deviations "
        f"{float(z_std.abs().max()):.2f} over {m1.numel()} coordinates")
    if not worst <= DNC_Z_MAX:
        raise AssertionError(f"D&C sampling: moments {worst:.2f} z from the scan sampler's")


# ---------------------------------------------------------------------------
# Chain batching: the rare-event grid as one batched sampler over a chain axis
# ---------------------------------------------------------------------------

# benchmarks/rare_event_sweep.sh: T=2, y=5, a 10 x 10 (rho, r2) grid x 8
# chains (M = 800), N=25, f64, target 0.5, seed 42; its 2500 + 10000
# iterations are cut to GRID_SCHEDULE.
GRID_SCHEDULE = (300, 600)
GRID_SHORT = (10, 20)       # the T=6 PIT and --no-parallel grids, and each M=8 grid
GRID_Z = 5.0                # the moment bounds, in standard errors
GRID_MIN_ESS = 100          # pooled ESS of a coordinate for its moments to be bounded
GRID_MIN_BOUNDED = 99       # half of the 198 coordinates (99 cells x 2) a grid can bound
GRID_CONFIGS = [(style, gradient) for style in ("kalman-1", "csmc", "csmc-guided")
                for gradient in (False, True)]
# Launches an iteration whatever M is: kalman the scalar scans (batched scalar
# layout), csmc-guided the lane sweep and the backward factor sweep, csmc the
# PIT root's row_lse (T=2: the tree is the root alone).
GRID_PER_ITER = {"kalman-1": RE_KALMAN_LAUNCHES,
                 "csmc": {"row_lse": 1},
                 "csmc-guided": {"lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES}}
# The chain-axis instances: entry -> (the wrapper whose launches it counts,
# source, the TPU kernel it replaces).
CHAIN_KERNELS = {
    "forward_factor_scan_chains": ("forward_factor_scan",) + CSMC_KERNELS["forward_factor_scan"],
    "backward_factor_scan_chains": ("backward_factor_scan",)
    + CSMC_KERNELS["backward_factor_scan"],
    "lane_scan_chains": ("lane_scan",) + CSMC_KERNELS["lane_scan"],
    "col_sample_chains": ("col_sample",) + STITCH_KERNELS["col_sample"],
}


def grid_args(style, gradient, T=2, grid_size=10, n_chains=8, parallel=True,
              schedule=GRID_SCHEDULE):
    """The rare-event driver's arguments for one grid run (its parser's
    flags; benchmarks/rare_event_sweep.sh's values)."""
    from aux_ssm_tpu_torch.experiments import cli
    p = cli.base_parser("grid")
    p.add_argument("--T", type=int, default=2)
    p.add_argument("--y", type=float, default=5.0)
    p.add_argument("--grid-size", type=int, default=10)
    return p.parse_args([
        "--style", style, "--gradient" if gradient else "--no-gradient",
        "--parallel" if parallel else "--no-parallel", "--N", "25", "--precision", "double",
        "--target-alpha", "0.5", "--burnin", str(schedule[0]), "--n-samples", str(schedule[1]),
        "--seed", "42", "--n-chains", str(n_chains), "--grid-size", str(grid_size), "--T", str(T),
        "--y", "5.0", "--no-verbose"])


def grid_run(dev, args):
    """`run_grid` with the launch counters reset before and read after.
    Returns (rows, res, launches an iteration, launches); the run's exact
    initial draws (`init_x`: a scalar filter scan and a scalar affine scan
    for all M chains) are counted apart, and a count that is not a whole
    number of launches an iteration fails."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import rare_event as grid
    from aux_ssm_tpu_torch.models import rare_event as rev
    from aux_ssm_tpu_torch.ops import cuda as K
    rho, r2 = (torch.as_tensor(np.repeat(z, args.n_chains), dtype=torch.float64, device=dev)
               for z in grid.grid_cells(args.grid_size))
    K.reset_launches()
    rev.init_x(args.y, rho, r2, args.T, args.parallel, device=dev)
    init = K.launches()
    K.reset_launches()
    rows, res = grid.run_grid(args, device=dev, dtype=torch.float64)
    launches = {k: v - init[k] for k, v in K.launches().items()}
    n_iter = max(args.burnin, 1) + args.n_samples
    per = {k: v // n_iter for k, v in launches.items() if v}
    if any(v % n_iter for v in launches.values()):
        raise AssertionError(f"grid {args.style}: launches {launches} in {n_iter} iterations "
                             f"beside the initial draws' {init}")
    return rows, res, per, launches


@contextlib.contextmanager
def recording(module, names):
    """Record each call of the wrappers `names` of `module` as (args,
    kwargs), in order; the calls go through (and count their launches on the
    recorder, the wrapper's module name meanwhile)."""
    seen, originals = {name: [] for name in names}, {name: getattr(module, name)
                                                       for name in names}

    def recorder(name, fn):
        def record(*args, **kwargs):
            seen[name].append((args, kwargs))
            return fn(*args, **kwargs)
        record.launches = 0
        return record

    for name, fn in originals.items():
        setattr(module, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def grid_step_calls(dev, style, gradient, T, parallel, module, names):
    """The wrappers' calls of one step of the M=800 grid sampler (f64, from
    the exact initial draws, delta 0.5)."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import rare_event as grid
    from aux_ssm_tpu_torch.models import rare_event as rev
    args = grid_args(style, gradient, T=T, parallel=parallel)
    rho, r2 = (torch.as_tensor(np.repeat(z, args.n_chains), dtype=torch.float64, device=dev)
               for z in grid.grid_cells(args.grid_size))
    M = rho.shape[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    kernel = grid.make_batched_kernel(style, args, rho, r2, device=dev)
    state = grid.GridState(x=rev.init_x(args.y, rho, r2, T, generator=gen, device=dev),
                           updated=torch.zeros(M, T, dtype=torch.bool, device=dev),
                           rho=rho, r2=r2)
    with recording(module, names) as seen:
        kernel(state, torch.full((M, T), 0.5, dtype=torch.float64, device=dev), generator=gen)
    torch.cuda.synchronize()
    return seen


def check_chain_instance(name, kernel, plain, one_chain_pairs, outs_of, ops, tensors,
                         extra=()):
    """A chain-axis instance on the grid's inputs: the kernel against its
    plain version (indices identical, values to RTOL_F64); each pair of
    `one_chain_pairs`, a call at C = 1 and the same call without a chain
    axis, bit-equal; `extra` further checks (label, fn -> bool). Then the
    kernel's time (CUDA events), the plain version's (its one call, host
    clock between synchronisations: a loop over the chains), the kernel's
    device ms (profiler) and the bound. Returns the entry."""
    import torch
    got = outs_of(kernel())
    torch.cuda.synchronize()
    tic = time.perf_counter()
    want = outs_of(plain())
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - tic)
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.int64:
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {int((g != w).sum())} indices differ from the "
                                     "plain version's")
        else:
            if not torch.allclose(g, w, rtol=RTOL_F64, atol=RTOL_F64):
                raise AssertionError(f"{name}: values off by {float((g - w).abs().max()):.3e}")
            err = max(err, float((g - w).abs().max()))
    for chained, single in one_chain_pairs:
        for a, b in zip(outs_of(chained()), outs_of(single())):
            if not torch.equal(a[0], b):
                raise AssertionError(f"{name}: the C = 1 call differs from the one-chain call")
    for label, check in extra:
        if not check():
            raise AssertionError(f"{name}: {label}")
    result = {"max_abs_err": err, "ms": cuda_ms(kernel, 20), "plain_ms": plain_ms,
              "device_ms": device_ms(kernel, 20)}
    result.update(bound(list(tensors) + list(got), 0, ops))
    dev_ms = result["device_ms"]
    log(f"  {name} shapes {[tuple(g.shape) for g in got]}: f64 indices identical to the plain "
        f"version's, values max abs err {err:.3e}; C = 1 bit-equal to the one-chain call"
        + "".join(f"; {label}" for label, _ in extra)
        + f"; kernel {result['ms']:.4f} ms (device "
        + ("not measured" if dev_ms is None else f"{dev_ms:.4f}")
        + f"), plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.5f} ms by "
        f"{result['bound_by']} ({result['bytes']} B, {result['operations']} operations)")
    return result


def phase_chain_kernels(dev):
    """Phase 29's kernel checks: the four chain-axis instances on the inputs
    one M=800 grid step hands them (f64). Run right after the build, before
    any other phase has profiled: in a process that has profiled before, the
    profiler's trace can list no kernels (`device_ms`)."""
    import dataclasses
    import torch
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    from aux_ssm_tpu_torch.ops import stitching as plain_st
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    results = {}

    # csmc-guided (gradient on): the lane sweep and the backward factor sweep.
    seen = grid_step_calls(dev, "csmc-guided", True, 2, True, CF,
                           ("lane_scan", "backward_factor_scan"))
    (Mt, Gt, Pt, *lane), _ = seen["lane_scan"][0]
    C, n, N = lane[0].shape

    def comps(sl):
        return tuple(None if m is None else dataclasses.replace(
            m, params=tree_map(lambda z: z[sl], m.params)) for m in (Mt, Gt, Pt))

    def lane_plain(*a):
        return CF.lane_scan_plain(Mt.lane_propagate, Gt.lane_logw,
                                  None if Pt is None else Pt.lane_logpdf, *a)

    results["lane_scan_chains"] = check_chain_instance(
        "lane_scan_chains[rare-event guided, gradient]",
        lambda: CF.lane_scan(Mt, Gt, Pt, *lane),
        lambda: CF._per_chain(lane_plain, Mt.params, Gt.params,
                              None if Pt is None else Pt.params, *lane, chains=C),
        [(lambda: CF.lane_scan(*comps(slice(0, 1)), *(z[0:1] for z in lane)),
          lambda: CF.lane_scan(*comps(0), *(z[0] for z in lane)))],
        lambda out: out, C * n * N * (40 + math.log2(N)),
        lane + list(Gt.cuda_operands()))
    bwd, _ = seen["backward_factor_scan"][0]
    rf, cf, rb, lw, us, b_T = bwd
    k = rf.shape[-1]
    results["backward_factor_scan_chains"] = check_chain_instance(
        "backward_factor_scan_chains[rare-event guided]",
        lambda: CF.backward_factor_scan(*bwd),
        lambda: CF._per_chain(CF.backward_factor_scan_plain, *bwd),
        [(lambda: CF.backward_factor_scan(*(z[0:1] for z in bwd)),
          lambda: CF.backward_factor_scan(*(z[0] for z in bwd)))],
        lambda out: (out,), C * n * N * (2 * k + 6), [rf, rb, lw, us, b_T])

    # csmc --no-parallel: the forward factor sweep.
    seen = grid_step_calls(dev, "csmc", False, 2, False, CF, ("forward_factor_scan",))
    fwd, kw = seen["forward_factor_scan"][0]
    rf = fwd[0]
    C, n, N, k = rf.shape
    results["forward_factor_scan_chains"] = check_chain_instance(
        "forward_factor_scan_chains[rare-event csmc, sequential]",
        lambda: CF.forward_factor_scan(*fwd, **kw),
        lambda: CF._per_chain(CF.forward_factor_scan_plain, *fwd, **kw),
        [(lambda: CF.forward_factor_scan(*(z[0:1] for z in fwd), **kw),
          lambda: CF.forward_factor_scan(*(z[0] for z in fwd), **kw))],
        lambda out: out, C * n * N * (2 * k + math.log2(N) + 8), list(fwd))

    # csmc (PIT) at T=6: col_sample on level 0 (3 nodes a chain, 2400 pairs).
    seen = grid_step_calls(dev, "csmc", False, 6, True, KS, ("col_sample",))
    (seed, rf, cf, cb, offset), kw = seen["col_sample"][0]
    C = kw["chains"]
    P, n, k = rf.shape
    per = P // C

    def each_chain_as_one():
        got = KS.col_sample(seed, rf, cf, cb, offset, chains=C)
        return all(torch.equal(got[c * per:(c + 1) * per], KS.col_sample(
            seed[c], rf[c * per:(c + 1) * per], cf[c * per:(c + 1) * per],
            cb[c * per:(c + 1) * per], offset)) for c in range(C))

    results["col_sample_chains"] = check_chain_instance(
        "col_sample_chains[rare-event PIT, T=6, level 0]",
        lambda: KS.col_sample(seed, rf, cf, cb, offset, chains=C),
        lambda: plain_st.col_sample(seed, rf, cf, cb, offset, chains=C),
        [(lambda: KS.col_sample(seed[0:1], rf[:per], cf[:per], cb[:per], offset,
                                chains=1)[None],
          lambda: KS.col_sample(seed[0], rf[:per], cf[:per], cb[:per], offset))],
        lambda out: (out,), P * n * cf.shape[1] * (2 * k + 25), [seed, rf, cf, cb],
        extra=[(f"each of the {C} chains' columns equal a one-chain call's with its seed",
                each_chain_as_one)])
    return results


def grid_moments(label, rows, n_chains):
    """Every cell whose pooled ESS of a coordinate is at least GRID_MIN_ESS:
    the mean of x_0 and of x_{T-1} within GRID_Z standard errors of the
    closed form, the standard deviation within GRID_Z standard errors of a
    standard deviation estimate; the hardest corner (rho 0.999, r2 1e-3)
    reported, not bounded. Fewer than GRID_MIN_BOUNDED coordinates bounded
    fails. Returns (cell coordinates bounded, the largest |z|)."""
    bounded, worst, misses = 0, 0.0, []
    for r in rows:
        hard = r["rho"] == 0.999 and r["r2"] == 1e-3
        for t in ("0", "T"):
            ess = r[f"ess_{t}"]
            z_mean = math.sqrt(r[f"err_mean_{t}"] * ess)
            z_std = abs(r[f"err_std_{t}"]) * math.sqrt(2.0 * ess)
            if hard:
                log(f"  {label}: hardest cell rho=0.999, r2=1e-3 (reported, not bounded): "
                    f"x_{t} ESS {ess:.0f}, mean z {z_mean:.2f}, std z {z_std:.2f}, "
                    f"update rate {r['acc']:.4f}, R-hat {r[f'rhat_{t}']:.3f}")
                continue
            if ess < GRID_MIN_ESS:
                continue
            bounded += 1
            worst = max(worst, z_mean, z_std)
            if z_mean >= GRID_Z or z_std >= GRID_Z:
                misses.append((r["rho"], r["r2"], t, round(ess), round(z_mean, 2),
                               round(z_std, 2)))
    if misses:
        raise AssertionError(f"{label}: moments beyond {GRID_Z} standard errors of the closed "
                             f"form (rho, r2, coordinate, ESS, mean z, std z): {misses}")
    if bounded < GRID_MIN_BOUNDED:
        raise AssertionError(f"{label}: only {bounded} cell coordinates reached a pooled ESS of "
                             f"{GRID_MIN_ESS}, fewer than {GRID_MIN_BOUNDED}")
    return bounded, worst


def phase_grid(dev, card):
    """Phase 29 after its kernel checks (`phase_chain_kernels`, run right
    after the build): the grid's six configurations at M = 800, the launches
    an iteration at M = 8, the T=6 PIT and --no-parallel grids. Returns the
    chain-axis instances' launches on those runs."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import rare_event as grid
    log(f"phase 29: the rare-event grid as one batched sampler, T=2, y=5, 10 x 10 cells x 8 "
        f"chains (M=800), N=25, f64, target 0.5, seed 42, {GRID_SCHEDULE[0]} + "
        f"{GRID_SCHEDULE[1]} iterations (published 2500 + 10000)")
    launches = {name: 0 for name in CHAIN_KERNELS}
    counts = {wrapper: name for name, (wrapper, _, _) in CHAIN_KERNELS.items()}
    for style, gradient in GRID_CONFIGS:
        label = f"grid {style}{' gradient' if gradient else ''}"
        args = grid_args(style, gradient)
        rows, res, per, total = grid_run(dev, args)
        _, _, per8, _ = grid_run(dev, grid_args(style, gradient, grid_size=2, n_chains=2,
                                                 schedule=GRID_SHORT))
        if per != GRID_PER_ITER[style] or per8 != per:
            raise AssertionError(f"{label}: launches an iteration {per} at M=800, {per8} at "
                                 f"M=8, expected {GRID_PER_ITER[style]}")
        for wrapper, count in total.items():
            if wrapper in counts:
                launches[counts[wrapper]] += count
        M = len(rows) * args.n_chains
        bounded, worst = grid_moments(label, rows, args.n_chains)
        delta = res.delta.reshape(len(rows), args.n_chains, -1).mean((1, 2)).cpu().numpy()
        if not np.unique(np.round(res.delta.cpu().numpy(), 6)).size > 1:
            raise AssertionError(f"{label}: the chains' deltas did not move apart")
        rate = float(res.stats.accept_cum.mean())
        log(f"  {label}: {M * args.n_samples / res.sampling_time:.1f} samples/s "
            f"({M} chains x {args.n_samples} in {res.sampling_time:.2f} s) on {card}; launches "
            f"an iteration {per} at M=800 and M=8; mean update rate {rate:.4f}; cells' mean "
            f"delta {delta.min():.3e} .. {delta.max():.3e}; {bounded} cell coordinates with "
            f"pooled ESS >= {GRID_MIN_ESS} bounded, largest |z| {worst:.2f}")
        if not 0.0 < rate < 1.0 or not np.isfinite(res.samples).all():
            raise AssertionError(f"{label}: update rate {rate} or non-finite samples")
        kernel = grid.make_batched_kernel(style, args, res.state.rho, res.state.r2, device=dev)
        box, gen = [res.state], torch.Generator(device=dev).manual_seed(9)
        profile_steps(f"{label}, M={M}",
                      lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)),
                      n=20)
    for label, args, expect in (
            ("grid csmc --no-parallel, T=2", grid_args("csmc", False, parallel=False,
                                                       schedule=GRID_SHORT),
             {"forward_factor_scan": FACTOR_LAUNCHES, "backward_factor_scan": FACTOR_LAUNCHES}),
            ("grid csmc (PIT), T=6", grid_args("csmc", False, T=6, schedule=GRID_SHORT),
             {"row_lse": 3, "col_sample": 2})):
        rows, res, per, total = grid_run(dev, args)
        if per != expect:
            raise AssertionError(f"{label}: launches an iteration {per}, expected {expect}")
        for wrapper, count in total.items():
            if wrapper in counts:
                launches[counts[wrapper]] += count
        M = len(rows) * args.n_chains
        log(f"  {label}: M={M}, {args.burnin} + {args.n_samples} iterations, launches an "
            f"iteration {per}, update rate {float(res.stats.accept_cum.mean()):.4f}, "
            f"{M * args.n_samples / res.sampling_time:.1f} samples/s")
        if not np.isfinite(res.samples).all():
            raise AssertionError(f"{label}: non-finite samples")
    missing = [name for name, count in launches.items() if not count]
    if missing:
        raise AssertionError(f"phase 29: {missing} launched no time on the grid's paths")
    return launches


# ---------------------------------------------------------------------------
# The chain axis through the auxiliary-Kalman MH path: C chains of SV
# kalman-1/2 and of the Lorenz Gibbs sampler as one batched step (the dense
# batched layout, x (T, C, d)), the six MH kernels' chain instances
# ---------------------------------------------------------------------------

DENSE_CHAINS = {"sv": 32, "lorenz": 8}   # chains at the SV shape and at the Lorenz shape
DENSE_SV_SCHEDULE = (200, 50)            # burn-in + sampling of the SV driver's C = 32 run
DENSE_SV_LR = 1.0                        # its delta adaptation's rate (the driver's --lr)
DENSE_LORENZ_SCHEDULE = (10, 20)         # burn-in + sampling of the Lorenz driver's C = 8 run
DENSE_LORENZ_CHAIN = (40, 80)            # burn-in + sampling of the batched Lorenz chain
DENSE_ONE_CHAIN = (2, 3)                 # burn-in + sampling of each driver's C = 1 count
DENSE_KERNELS = {f"{name}_chains": (name,) + KERNELS[name][:2] for name in KERNELS}
LORENZ_KEYS = {"mean_x", "ejsd", "theta", "theta_samples", "delta", "sampling_time", "freq"}


def chain_slice(args, c, keep=False):
    """A chain-layout call's arguments cut to chain c: each tensor's chain
    axis (axis 1; a shared operand's is 1 long) dropped, a one-chain call,
    or with `keep` kept 1 long, a C = 1 call. Tuples of tensors (the filter
    scan's elements) are cut inside."""
    import torch

    def cut(t):
        i = min(c, t.shape[1] - 1)
        return (t[:, i:i + 1] if keep else t[:, i]).contiguous()
    return tuple(tuple(cut(z) for z in a) if isinstance(a, tuple)
                 else cut(a) if isinstance(a, torch.Tensor) else a for a in args)


def check_chain_bits(name, wrapper, args, C):
    """The chain instance's C = 1 call bit-equal to the one-chain call, and
    chains 0, C / 2 and C - 1 of the C-chain launch each bit-equal to a
    one-chain launch on their inputs."""
    import torch
    got = as_tuple(wrapper(*args))
    picked = sorted({0, C // 2, C - 1})
    for c in picked:
        one = as_tuple(wrapper(*chain_slice(args, c)))
        if c == 0:
            first = as_tuple(wrapper(*chain_slice(args, 0, keep=True)))
            if not all(torch.equal(a[:, 0], b) for a, b in zip(first, one)):
                raise AssertionError(f"{name}: the C = 1 call differs from the one-chain call")
        if not all(torch.equal(g[:, c], b) for g, b in zip(got, one)):
            raise AssertionError(f"{name}: chain {c} of the C = {C} launch differs from a "
                                 "one-chain launch on its inputs")
    log(f"  {name}: C = 1 bit-equal to the one-chain call; chains {picked} of the C = {C} "
        "launch bit-equal to one-chain launches")


def chain_mh_calls(steps, m0u, P0u, eps):
    """The six MH kernels' calls on one batched step's inputs (steps as
    `mh_inputs` gives them for time-first chains: per-chain tensors (n, C,
    ...), shared ones (n, 1, ...)): (calls by name as (wrapper, plain
    version, arguments), the elements, the gains and increments, the
    operations of each call: C times one chain's)."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.cuda import kalman_fused as KF
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps

    Fs, Qs, bs = steps[:3]
    n, C, dy = steps[6].shape
    dx = bs.shape[-1]
    ops = {k: C * v for k, v in mh_ops(n, max(dx, dy)).items()}
    m_el = torch.cat([m0u[None], m0u.new_zeros((n - 1,) + m0u.shape)])
    P_el = torch.cat([P0u[None], P0u.new_zeros((n - 1,) + P0u.shape)])
    elems = _make_associative_elements(*steps, m0u, P0u)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    gains, incs = _backward_maps(eps, ms, Ps, Fs, Qs, bs)
    xs = FS.affine_scan(gains, incs, reverse=True)[1]
    calls = {
        "make_elements": (KF.make_elements, KF.make_elements_plain, steps + (m_el, P_el)),
        "filter_scan": (FS.filter_scan, FS.filter_scan_plain, (elems,)),
        "ell": (KF.ell, KF.ell_plain, steps + (ms[:-1], Ps[:-1])),
        "backward_maps": (KF.backward_maps, KF.backward_maps_plain,
                          (Fs, Qs, bs, ms[:-1], Ps[:-1], eps[:-1])),
        "affine_scan": (FS.affine_scan, FS.affine_scan_plain, (gains, incs, True)),
        "logdensity_steps": (KF.logdensity_steps, KF.logdensity_steps_plain,
                             steps + (xs[:-1], xs[1:]))}
    return calls, elems, gains, incs, ops


def check_chain_mh_kernels(label, steps, m0u, P0u, eps, **kw):
    """The six MH kernels' chain instances on one batched step's inputs
    (`chain_mh_calls`): each against its plain version (`compare`, with
    `kw`) and `check_chain_bits`. Returns (results by kernel name,
    elements, gains, incs)."""
    calls, elems, gains, incs, ops = chain_mh_calls(steps, m0u, P0u, eps)
    C = steps[6].shape[1]
    results = {}
    for name, (wrapper, plain, args) in calls.items():
        results[name] = compare(f"{name}_chains{label}", wrapper, plain, args, ops[name], **kw)
        check_chain_bits(f"{name}_chains{label}", wrapper, args, C)
    return results, elems, gains, incs


def dense_sv_inputs(dev, C, gen):
    """A real batched SV kalman-1 step's kernel inputs (T=250, D=30, f32,
    time first; `mh_inputs`) for C chains from the committed run's xs_true,
    each with its own u and delta (0.75-1.25 times the committed delta;
    the committed one at C = 1), F, Q and b shared; and the draw's normals
    (T, C, D): (steps, m0u, P0u, eps)."""
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    f32 = torch.float32
    ys, xs, delta = load_sv("kalman1", dev, f32)
    deltas = float(delta) * torch.linspace(0.75 if C > 1 else 1.0, 1.25 if C > 1 else 1.0, C,
                                           dtype=f32, device=dev)
    x = xs[:, None].expand(SV_T, C, SV_D)
    u = x + (0.5 * deltas[:, None]).sqrt() * torch.randn(x.shape, generator=gen, device=dev)
    eps = torch.randn(x.shape, generator=gen, device=dev)
    dyn, obs1, _, _ = sv.get_kalman_factories(ys, *SV_PARAMS, chains=True)
    return (*mh_inputs(dyn, obs1, x, u, deltas), eps)


def dense_lorenz_inputs(dev, C, gen):
    """A real batched Lorenz MH step's kernel inputs (Mider freq 4, T=5001,
    dx=3, dy=5, f32, time first; `mh_inputs`) for C chains at the committed
    run's mean_x, each with its own theta (the committed one scaled by
    0.99-1.01; itself at C = 1) and u, at delta 1e20; and the draw's
    normals: (steps, m0u, P0u, eps)."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments.lorenz import mider_problem
    from aux_ssm_tpu_torch.models import lorenz
    f32 = torch.float32
    prob = mider_problem(4, dtype=f32, device=dev)
    committed = np.load(LORENZ_NPZ.format(4))
    scale = torch.linspace(0.99 if C > 1 else 1.0, 1.01 if C > 1 else 1.0, C, dtype=f32,
                           device=dev)
    theta = torch.as_tensor(committed["theta"], dtype=f32, device=dev) * scale[:, None]
    dyn, obs, _ = lorenz.get_kalman_factories(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0,
                                              prob.P0, theta, LORENZ_SIGMA_X, prob.dt,
                                              chains=True)
    x = torch.as_tensor(committed["mean_x"], dtype=f32, device=dev)[:, None].expand(-1, C, 3)
    delta = torch.full((C,), LORENZ_DELTAS[0], dtype=f32, device=dev)
    u = x + (0.5 * LORENZ_DELTAS[0]) ** 0.5 * torch.randn(x.shape, generator=gen, device=dev)
    eps = torch.randn(x.shape, generator=gen, device=dev)
    return (*mh_inputs(dyn, obs, x, u, delta), eps)


def phase_dense_chain_kernels(dev):
    """Phase 30: the six MH kernels' chain instances (the dense batched
    layout) on real batched steps' inputs: SV kalman-1 at T=250, D=30 (the D
    = 32 instance), C = 32 chains from the committed run's xs_true, each
    with its own u and delta (0.75-1.25 times the committed delta), F, Q
    and b shared; the Lorenz Gibbs step at the Mider freq-4 shape (T=5001,
    the D = 16 instance), C = 8 chains at the committed mean_x, each with
    its own theta (the committed one scaled by 0.99-1.01) and u, at delta
    1e20. Each against its plain version at phases 20 and 23's bounds, with
    its device ms by the profiler; C = 1 and three chains bit-equal to
    one-chain launches; a two-stream round of the chain-axis scans. Run
    right after the build, with phase 29's checks (`device_ms`). Returns
    the entries at the SV shape, each with its Lorenz-shape entry inside."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(30)
    C = DENSE_CHAINS["sv"]
    steps, m0u, P0u, eps = dense_sv_inputs(dev, C, gen)
    log(f"phase 30: the MH kernels' chain instances on a real batched SV kalman-1 step's inputs "
        f"(T={SV_T}, D={SV_D}: the D = 32 instance, C = {C} chains, F, Q, b shared; bounds as "
        "phase 20's)")
    results, elems, gains, incs = check_chain_mh_kernels("", steps, m0u, P0u, eps, reps=5,
                                                         own_bound=True, device_time=True)
    two_streams(elems, gains, incs, rounds=10)

    C = DENSE_CHAINS["lorenz"]
    steps, m0u, P0u, eps = dense_lorenz_inputs(dev, C, gen)
    log(f"  the Lorenz shape: Mider freq 4, T=5001, dx=3, dy=5 (the D = 16 instance), C = {C} "
        f"chains, theta each chain's, delta {LORENZ_DELTAS[0]:g} (bounds as phase 23's)")
    lorenz_results = check_chain_mh_kernels("_lorenz", steps, m0u, P0u, eps, reps=3,
                                            own_bound=True, device_time=True)[0]
    for k, v in results.items():
        v["shape"] = f"T={SV_T}, D={SV_D}, C={DENSE_CHAINS['sv']}"
        v["lorenz"] = {f"T=5001, dx=3, dy=5, C={C}, delta 1e20": lorenz_results[k]}
    return results


def chain_driver(main, argv, out, label, card, chains, schedule, rate_bounds):
    """A driver's `main(argv)` with `--n-chains 1` for DENSE_ONE_CHAIN
    iterations (writing `{out}_one.npz`) and with `--n-chains chains` for
    `schedule` (writing `{out}.npz`), the launch counters reset before and
    read after each: the six MH kernels launch as often an iteration at C =
    `chains` as at C = 1 (10 an MH step), no other kernel. The C run's
    update rate (all chains') must lie in `rate_bounds`; samples/s of all
    chains printed. Returns (the C run's result, its launches, the .npz
    paths by C)."""
    import numpy as np
    from aux_ssm_tpu_torch.ops import cuda as K
    per_iter, paths = {}, {1: f"{out}_one.npz", chains: f"{out}.npz"}
    for C, (burnin, n_samples) in ((1, DENSE_ONE_CHAIN), (chains, schedule)):
        run = argv + ["--n-chains", str(C), "--burnin", str(burnin), "--n-samples",
                      str(n_samples), "--out", paths[C]]
        K.reset_launches()
        res = main(run)
        launches = K.launches()
        n_iter = burnin + n_samples
        per = {k: v / n_iter for k, v in launches.items() if v}
        per_iter[C] = per
        if set(per) != set(KERNELS) or any(v != KERNELS[k][2] for k, v in per.items()):
            raise AssertionError(f"{label} C = {C}: launches an iteration {per}, expected "
                                 f"{({k: c for k, (_, _, c) in KERNELS.items()})}")
    rate = float(res.stats.accept_cum.mean())
    sps = chains * schedule[1] / res.sampling_time
    log(f"  {label}: launches an iteration at C = 1 {per_iter[1]} and at C = {chains} "
        f"{per_iter[chains]} (equal); update rate {rate:.4f} (bounds {rate_bounds}), "
        f"{sps:.2f} samples/s of all {chains} chains ({sps / chains:.2f} a chain) on {card}")
    if res.samples.shape[:2] != (chains, schedule[1]) or res.stats.step.shape != (chains,):
        raise AssertionError(f"{label}: samples {res.samples.shape}, step {res.stats.step.shape}")
    if not np.isfinite(res.samples).all():
        raise AssertionError(f"{label}: non-finite samples")
    if not rate_bounds[0] <= rate <= rate_bounds[1]:
        raise AssertionError(f"{label}: update rate {rate:.4f} outside {rate_bounds}")
    return res, launches, paths


def phase_dense_chain_drivers(dev, card, out_dir):
    """Phase 31: the drivers with `--n-chains` at full width, each C chains
    as one batched step: the SV driver (T=250, D=30, kalman-1, f32) with C =
    32 from its own start (delta from its default 1e-2, adapted at `--lr`
    DENSE_SV_LR), DENSE_SV_SCHEDULE, its update rate held to SV_KALMAN_RATE;
    the Lorenz driver on the Mider data (freq 4, T=5001) with C = 8 at its
    defaults (delta from 1e-2), DENSE_LORENZ_SCHEDULE, its rate held to (0,
    1) (the start is far from the posterior). Each also with `--n-chains 1`
    for DENSE_ONE_CHAIN to its own .npz: the six MH kernels' launches an
    iteration at C = 1 and at C equal (10 a step); the output shapes (the
    Lorenz driver's .npz keys and shapes at C = 1 and at C), samples/s of
    all chains, and a profile of the batched step (its device busy share).
    Then the batched Lorenz Gibbs sampler at C = 8 from the committed run's
    mean_x and theta at its delta 1e20 (frozen), DENSE_LORENZ_CHAIN, held as
    phase 25's chain. Returns the six kernels' launches over the C > 1 runs
    (the two drivers' and the chain's)."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig
    from aux_ssm_tpu_torch.experiments import lorenz as lorenz_driver
    from aux_ssm_tpu_torch.experiments import sv as sv_driver
    from aux_ssm_tpu_torch.models import lorenz
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains

    C = DENSE_CHAINS["sv"]
    log(f"phase 31: the drivers with --n-chains, each as one batched step: SV kalman-1, C = {C}, "
        f"T={SV_T}, D={SV_D}, {DENSE_SV_SCHEDULE[0]} + {DENSE_SV_SCHEDULE[1]} from the driver's "
        f"start (delta from 1e-2, --lr {DENSE_SV_LR}); Lorenz Mider freq 4, C = "
        f"{DENSE_CHAINS['lorenz']}, {DENSE_LORENZ_SCHEDULE[0]} + {DENSE_LORENZ_SCHEDULE[1]} from "
        "the driver's start (launches, shapes, samples/s)")
    res, sv_launches, paths = chain_driver(
        sv_driver.main, ["--style", "kalman-1", "--lr", str(DENSE_SV_LR), "--no-verbose"],
        f"{out_dir}/sv_chains", f"SV driver kalman-1 --n-chains {C}", card, C,
        DENSE_SV_SCHEDULE, SV_KALMAN_RATE)
    ys = torch.as_tensor(np.load(paths[C])["ys"], device=dev)
    _, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, order=1, chains=True)
    gen = torch.Generator(device=dev).manual_seed(31)
    box = [res.state]
    profile_steps(f"SV kalman-1, C = {C} batched",
                  lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)), n=10,
                  also=tuple(WIDE_NAMES))

    C = DENSE_CHAINS["lorenz"]
    res, lz_launches, paths = chain_driver(
        lorenz_driver.main, ["--data", "mider", "--freq", "4", "--no-verbose"],
        f"{out_dir}/lorenz_chains", f"Lorenz driver Mider freq 4 --n-chains {C}", card, C,
        DENSE_LORENZ_SCHEDULE, (0, 1))
    for c, lead, n_samples in ((1, (), DENSE_ONE_CHAIN[1]), (C, (C,), DENSE_LORENZ_SCHEDULE[1])):
        with np.load(paths[c]) as z:
            saved = {k: z[k] for k in z.files}
        check_saved(f"Lorenz --n-chains {c}", saved, LORENZ_KEYS,
                    {"mean_x": (5001, 3), "theta": lead + (3,),
                     "theta_samples": lead + (n_samples, 3)})

    burnin, n_samples = DENSE_LORENZ_CHAIN
    n_iter = burnin + n_samples
    log(f"  the batched Lorenz Gibbs sampler, C = {C}, from the committed run's mean_x and "
        f"theta at its delta 1e20 (frozen), {burnin} + {n_samples}, held as phase 25's chain:")
    prob = lorenz_driver.mider_problem(4, device=dev)
    init, kernel = lorenz.get_gibbs_kernel(prob.ys, prob.Hs, prob.Rs, prob.cs, prob.m0, prob.P0,
                                           LORENZ_SIGMA_X, prob.dt, prob.sigma_theta, True,
                                           chains=True)
    committed = np.load(LORENZ_NPZ.format(4))
    x0 = torch.as_tensor(committed["mean_x"], dtype=torch.float32, device=dev)
    theta0 = torch.as_tensor(committed["theta"], dtype=torch.float32, device=dev)
    K.reset_launches()
    res = run_sharded_chains(kernel, init(x0.expand(C, -1, -1).clone(),
                                          theta0.expand(C, -1).clone()),
                             RunConfig(n_samples=n_samples, burnin=burnin, learning_rate=0.0),
                             generator=gen, delta_init=torch.full((C,), LORENZ_DELTAS[0],
                                                                  device=dev),
                             collect_samples=True, collect_fn=lambda s: s.theta)
    chain_launches = K.launches()
    if any(chain_launches[k] != KERNELS[k][2] * n_iter for k in KERNELS):
        raise AssertionError(f"Lorenz C = {C}: launches {chain_launches} in {n_iter} iterations")
    check_lorenz_chain(f"Lorenz Gibbs, C = {C} batched", res, committed, n_samples,
                       chain_launches, n_iter, card)
    box = [res.state]
    profile_steps(f"Lorenz Gibbs, C = {C} batched",
                  lambda: box.__setitem__(0, kernel(box[0], res.delta, generator=gen)), n=10,
                  also=tuple(NARROW_NAMES))
    return {k: sv_launches[k] + lz_launches[k] + chain_launches[k] for k in KERNELS}


# Phases 32-33: C chains of the cSMC styles and of the spatial sampler as one
# batched step (the block-lane sweep's chain instance, row 11; the scalar
# scans at C B columns).
CSMC_CHAINS = {"sv": 32, "spatial": 8}  # chains at the SV and at the spatial shape
CSMC_SV_SCHEDULE = (20, 40)             # burn-in + sampling of the SV driver's C = 32 runs
CSMC_SP_SCHEDULE = (10, 20)             # burn-in + sampling of the spatial driver's C = 8 runs
CSMC_ONE_CHAIN = (2, 3)                 # burn-in + sampling of each C = 1 count run
# The SV driver's sequential csmc with --resampling systematic: the generic
# forward loop is 249 steps of plain torch a step (~0.5 s an iteration at C
# = 32 on an H100, host-bound), so its C = 32 run is cut to this.
CSMC_SEQ_SCHEDULE = (3, 6)
# The chain instances' entries: entry -> (the wrapper whose launches it
# counts, source, the TPU kernel it replaces).
CSMC_CHAIN_KERNELS = {
    "block_lane_scan_chains": ("block_lane_scan",) + CSMC_KERNELS["block_lane_scan"],
    "block_lane_scan_spatial_chains": ("block_lane_scan",) + CSMC_KERNELS["block_lane_scan"],
    "scalar_filter_scan_chains": ("scalar_filter_scan",) + SCALAR_KERNELS["scalar_filter_scan"],
    "scalar_affine_scan_chains": ("scalar_affine_scan",) + SCALAR_KERNELS["scalar_affine_scan"],
}


def chain_deltas(delta, C):
    """Each of C chains' delta: `delta` ((T,) or a scalar tensor) scaled by
    0.75-1.25 across the chains (by 1 at C = 1), so their u and operands
    differ: (C, T) or (C,)."""
    import torch
    lo, hi = (0.75, 1.25) if C > 1 else (1.0, 1.0)
    scale = torch.linspace(lo, hi, C, dtype=delta.dtype, device=delta.device)
    return delta * (scale[:, None] if delta.dim() else scale)


def block_lane_chain_inputs(dev, dtype, model, C, gradient, seed):
    """The block-lane sweep's arguments in one real batched csmc-guided step
    of C chains (`get_guided_csmc_kernel(..., chains=True)`): SV (T=250, D=30,
    N=25) from the committed run's xs_true at its adapted delta, spatial
    (T=1024, 8x8, N=25) from `get_data`'s states at delta SP_DELTA0, each
    chain's delta scaled 0.75-1.25 (`chain_deltas`) and its own noise."""
    import torch
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    if model == "sv":
        ys, xs, delta = load_sv("csmc_guided_no-gradient", dev, dtype)
        init, kernel = sv.get_guided_csmc_kernel(ys, *SV_PARAMS, SV_N, backward=True,
                                                 gradient=gradient, chains=True)
    else:
        xs, ys = spatial_data(dev, dtype)
        delta = torch.full((SP_T,), SP_DELTA0, dtype=dtype, device=dev)
        init, kernel = sp.get_guided_csmc_kernel(ys, *SP_PARAMS, SP_D, SP_N, backward=True,
                                                 gradient=gradient, chains=True)
    with recording_sweeps() as seen:
        kernel(init(xs.expand(C, -1, -1).clone()), chain_deltas(delta, C),
               generator=torch.Generator(device=dev).manual_seed(seed))
    return seen["block_lane_scan"]


def chain_components(args, sl):
    """(Mt, Gt, eps, ...) of a chain-axis sweep call cut to `sl` on the chain
    axis (an int: one chain, no axis; a slice: the axis kept)."""
    import dataclasses
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    Mt, Gt, *rest = args
    comps = tuple(dataclasses.replace(m, params=tree_map(lambda z: z[sl], m.params))
                  for m in (Mt, Gt))
    return comps + tuple(z[sl] for z in rest)


def on_cpu(obj):
    """A copy of `obj` (tensors, and dataclasses and tuples of them: a sweep
    call's arguments, the model components with their constants) on the
    CPU."""
    import dataclasses
    import torch
    if torch.is_tensor(obj):
        return obj.cpu()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: on_cpu(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(on_cpu(z) for z in obj)
    return obj


def check_block_lane_chains(label, args32, args64, reps, ops_per_particle, whole_f64=True):
    """The block-lane sweep's chain instance on a real batched step's inputs
    (C chains, one launch): f32 against the plain version step by step from
    the kernel's own carry (chains 0, C / 2 and C - 1) at row 11's bounds
    (AGREE_F32, TOL_F32); f64 whole sweeps against the plain version
    (identical indices, RTOL_F64), of every chain (`whole_f64`) or of those
    three; the C = 1 call bit-equal to the one-chain call, and chains 0, C /
    2, C - 1 of the C-chain launch each bit-equal to a one-chain launch on
    their inputs (f32 and f64); the launch's time (CUDA events and the
    profiler's device ms) against C one-chain launches' and the bound. The
    plain version runs on CPU copies of the inputs (its small steps cost
    less there than as card launches); `plain_ms` is its one call over every
    chain's f64 inputs (`plain_on`, `plain_dtype` say so). Returns the
    entry."""
    import torch
    from aux_ssm_tpu_torch.kernels.csmc_base import tree_map
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    name = f"block_lane_scan_chains[{label}]"
    C, n, d, N = args32[2].shape
    picked = sorted({0, C // 2, C - 1})
    xs, lw, anc = CF.block_lane_scan(*args32)
    shares, err = [], 0.0
    for c in picked:
        Mt, Gt, e, r, xst, x0, w0 = on_cpu(chain_components(args32, c))
        xs_c, lw_c = xs[c].cpu(), lw[c].cpu()

        def plain_step(t):
            sl = slice(t, t + 1)
            return CF.block_lane_scan_plain(
                Mt.block_propagate, Gt.block_logw, tree_map(lambda z: z[sl], Mt.params),
                tree_map(lambda z: z[sl], Gt.params), e[sl], r[sl], xst[sl],
                x0 if t == 0 else xs_c[t - 1], w0 if t == 0 else carry(lw_c[t - 1]))

        xs_p, lw_p, anc_p = resynced(n, plain_step)
        anc_c = anc[c].cpu()
        same = anc_c == anc_p
        share, e_c = agree_f32(f"{name} chain {c}", anc_c, anc_p, [
            (lw_c, lw_p, same), (xs_c, xs_p, same[:, None, :].expand_as(xs_c))])
        shares.append(share)
        err = max(err, e_c)
    got64 = CF.block_lane_scan(*args64)
    checked = list(range(C)) if whole_f64 else picked
    cpu64 = on_cpu(args64 if whole_f64 else chain_components(args64, torch.tensor(picked)))
    tic = time.perf_counter()
    want64 = CF.block_lane_scan(*cpu64)  # on the CPU: the plain version, chain by chain
    plain_s = time.perf_counter() - tic
    err64 = exact_f64(name, got64[2][checked].cpu(), want64[2], [
        (got64[1][checked].cpu(), want64[1]), (got64[0][checked].cpu(), want64[0])])
    for args, got in ((args32, (xs, lw, anc)), (args64, got64)):
        for c in picked:
            one = CF.block_lane_scan(*chain_components(args, c))
            if not all(torch.equal(g[c], o) for g, o in zip(got, one)):
                raise AssertionError(f"{name}: chain {c} of the C = {C} launch differs from a "
                                     "one-chain launch on its inputs")
            if c == 0:
                first = CF.block_lane_scan(*chain_components(args, slice(0, 1)))
                if not all(torch.equal(f[0], o) for f, o in zip(first, one)):
                    raise AssertionError(f"{name}: the C = 1 call differs from the one-chain "
                                         "call")
    ones = [chain_components(args32, c) for c in range(C)]

    def each_alone():
        for one in ones:
            CF.block_lane_scan(*one)

    Mt, Gt, *rest = args32
    result = {"max_abs_err": err, "index_agree_f32": min(shares), "max_rel_err_f64": err64,
              "chains": C, "ms": cuda_ms(lambda: CF.block_lane_scan(*args32), reps),
              "plain_ms": 1e3 * plain_s, "plain_on": "cpu", "plain_dtype": "float64",
              "plain_chains": len(checked),
              "one_chain_launches_ms": cuda_ms(each_alone, max(1, reps // 4)),
              "device_ms": device_ms(lambda: CF.block_lane_scan(*args32), reps),
              "one_chain_device_ms": device_ms(lambda: CF.block_lane_scan(*ones[0]), reps)}
    result.update(bound([*rest, *Gt.cuda_operands(), xs, lw, anc], 0,
                        C * n * N * ops_per_particle))
    dev_ms, one_ms = result["device_ms"], result["one_chain_device_ms"]
    log(f"  {name} C={C}, n={n}, d={d}, N={N}: f32 index agreement (chains {picked}) "
        f"{min(shares):.4f}, max abs err {err:.3e}; f64 ({len(checked)} chains) identical "
        f"indices, rel err {err64:.3e}; C = 1 and chains {picked} bit-equal to one-chain "
        f"launches (f32, f64); the C-chain launch {result['ms']:.4f} ms (device "
        + ("not measured" if dev_ms is None else f"{dev_ms:.4f}")
        + f"), {C} one-chain launches {result['one_chain_launches_ms']:.4f} ms (one: device "
        + ("not measured" if one_ms is None else f"{one_ms:.4f}")
        + f"), plain (CPU, f64, {len(checked)} chains) {result['plain_ms']:.1f} ms, bound "
        f"{result['bound_ms']:.5f} ms by {result['bound_by']} ({result['bytes']} B, "
        f"{result['operations']} operations)")
    return result


def phase_block_lane_chains(dev):
    """Phase 32: the block-lane sweep's chain instance (row 11, a block a
    chain) on real batched csmc-guided steps' inputs: SV (T=250, D=30, N=25)
    at C = 32, spatial (T=1024, 8x8, N=25) at C = 8 without and with the
    gradient shift (`check_block_lane_chains`), with the blocks a chain's
    sweep puts on an SM at both shapes; then the scalar scans (rows 12-13)
    on a real batched spatial kalman-1 step's inputs at C = 8 (T=1024, 512
    columns): against their plain versions (`compare`), and each chain's 64
    columns against a 64-column launch on them (f64: bit for bit where the
    two launches' plans are the same, else to 1e-12). Run right after the
    build, with phases 29-30's checks (`device_ms`). Returns the entries."""
    import torch
    from aux_ssm_tpu_torch.models import spatial as sp
    from aux_ssm_tpu_torch.ops.cuda import csmc_fwd as CF
    from aux_ssm_tpu_torch.ops.cuda import scalar_scan as SS
    f32, f64 = torch.float32, torch.float64
    C_sv, C_sp = CSMC_CHAINS["sv"], CSMC_CHAINS["spatial"]
    log(f"phase 32: the block-lane sweep's chain instance on real batched csmc-guided steps' "
        f"inputs: SV T={SV_T}, D={SV_D}, N={SV_N}, C = {C_sv}; spatial T={SP_T}, "
        f"{SP_D}x{SP_D}, N={SP_N}, C = {C_sp}, gradient off and on (bounds as phases 4 and 13)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for model, d, nconst in (("sv_guided", SV_D, 3 * SV_D * SV_D + 2 * SV_D + 1),
                             ("spatial_guided", SP_D * SP_D, None)):
        if nconst is None:
            _, ys = spatial_data(dev, f32, T=2)
            factory, _ = sp.make_guided_factory(ys, *SP_PARAMS, SP_D)
            nconst = factory(ys, torch.ones(2, device=dev))[3].cuda_operands()[0].numel()
        for dt in (f32, f64):
            blocks, staged = CF.block_lane_occupancy(model, 25, d, nconst, dt, dev)
            log(f"  {model}, d={d}, N=25, {dt}: {'staged' if staged else 'not staged'}, "
                f"{blocks} chains an SM at once ({blocks * sms} on the card's {sms} SMs)")
    results = {}
    args = {dt: block_lane_chain_inputs(dev, dt, "sv", C_sv, False, 32) for dt in (f32, f64)}
    results["block_lane_scan_chains"] = check_block_lane_chains(
        f"SV T={SV_T} N={SV_N}", args[f32], args[f64], reps=10,
        ops_per_particle=6 * SV_D * SV_D + 20 * SV_D)
    results["block_lane_scan_chains"]["shape"] = f"T={SV_T}, D={SV_D}, N={SV_N}, C={C_sv}"
    d = SP_D * SP_D
    spatial = {}
    for gradient in (False, True):
        args = {dt: block_lane_chain_inputs(dev, dt, "spatial", C_sp, gradient, 33)
                for dt in (f32, f64)}
        nnz = int((args[f32][1].c.prec != 0).sum())
        spatial[gradient] = check_block_lane_chains(
            f"spatial T={SP_T} N={SP_N}{' gradient' if gradient else ''}", args[f32], args[f64],
            reps=5, ops_per_particle=2 * (2 if gradient else 1) * nnz + 40 * d,
            whole_f64=not gradient)
    results["block_lane_scan_spatial_chains"] = spatial[False]
    spatial[False]["shape"] = f"T={SP_T}, d={d}, N={SP_N}, C={C_sp}"
    spatial[False]["gradient"] = spatial[True]

    log(f"  the scalar scans on a batched spatial kalman-1 step's inputs, C = {C_sp}: "
        f"T={SP_T}, {C_sp * d} columns (nrel bounds as phase 12's):")
    seen = {}
    for dt in (f32, f64):
        xs, ys = spatial_data(dev, dt)
        init, kernel = sp.get_kalman_kernel(ys, *SP_PARAMS, SP_D, parallel=True, order=1,
                                            chains=True)
        with recording_scalar_scans() as rec:
            kernel(init(xs.expand(C_sp, -1, -1).clone()),
                   chain_deltas(torch.tensor(SP_DELTA0, dtype=dt, device=dev), C_sp),
                   generator=torch.Generator(device=dev).manual_seed(32))
        seen[dt] = rec
    (elems,), _ = seen[f32]["scalar_filter_scan"]
    (gains, incs), _ = seen[f32]["scalar_affine_scan"]
    elems = tuple(z.contiguous() for z in elems)
    if incs.shape != (SP_T, C_sp * d):
        raise AssertionError(f"the batched kalman step handed the affine scan {incs.shape}")
    results["scalar_filter_scan_chains"] = compare(
        "scalar_filter_scan_chains", SS.scalar_filter_scan, SS.scalar_filter_scan_plain,
        (elems,), (SP_T - 2) * C_sp * d * 20, reps=20, device_time=True)
    results["scalar_affine_scan_chains"] = compare(
        "scalar_affine_scan_chains", SS.scalar_affine_scan, SS.scalar_affine_scan_plain,
        (gains, incs, True), (SP_T - 1) * C_sp * d * 3, reps=20, device_time=True)
    (elems64,), _ = seen[f64]["scalar_filter_scan"]
    (gains64, incs64), _ = seen[f64]["scalar_affine_scan"]
    calls = {"scalar_filter_scan": (SS.scalar_filter_scan, (tuple(z.contiguous()
                                                                 for z in elems64),)),
             "scalar_affine_scan": (SS.scalar_affine_scan, (gains64, incs64, True))}
    for name, (fn, a) in calls.items():
        got = as_tuple(fn(*a))
        bitwise, worst = [], 0.0
        for c in range(C_sp):
            cols = slice(c * d, (c + 1) * d)
            one = as_tuple(fn(*(tuple(z[:, cols].contiguous() for z in x) if isinstance(x, tuple)
                                else x[:, cols].contiguous() if torch.is_tensor(x) else x
                                for x in a)))
            same = all(torch.equal(g[:, cols], o) for g, o in zip(got, one))
            bitwise.append(same)
            for g, o in zip(got, one):
                worst = max(worst, float(((g[:, cols] - o).abs() / (1 + o.abs())).max()))
        if not worst <= 1e-12:
            raise AssertionError(f"{name}: a chain's columns of the {C_sp * d}-column launch "
                                 f"differ from a {d}-column launch by {worst:.3e}")
        plans = (SS.split_path(SP_T, C_sp * d, sms), SS.split_path(SP_T, d, sms))
        log(f"  {name} (f64): each chain's {d} columns of the {C_sp * d}-column launch against a "
            f"{d}-column launch: {sum(bitwise)} of {C_sp} bit for bit, the rest within "
            f"{worst:.3e} (time-segmented split path: {plans[0]} at {C_sp * d} columns, "
            f"{plans[1]} at {d}; the segments a column follow the column groups and the SMs)")
        results[f"{name}_chains"]["columns"] = C_sp * d
    return results


def csmc_chain_driver(main, argv, out, label, card, chains, schedule, per_iter, check):
    """A driver's `main(argv)` with `--n-chains 1` for CSMC_ONE_CHAIN
    iterations and with `--n-chains chains` for `schedule`, each writing its
    own .npz, the launch counters reset before and read after each: every
    kernel launches `per_iter` an iteration at both, nothing else; the C
    run's update rate (all chains') in (0, 1), its split-R-hat printed, and
    `check(saved)` on its .npz. Prints samples/s of all chains. Returns the
    C run's launches."""
    import contextlib as ctx
    import io
    import numpy as np
    from aux_ssm_tpu_torch.ops import cuda as K
    got = {}
    for C, (burnin, n_samples) in ((1, CSMC_ONE_CHAIN), (chains, schedule)):
        path = f"{out}_{C}.npz"
        run = argv + ["--n-chains", str(C), "--burnin", str(burnin), "--n-samples",
                      str(n_samples), "--out", path]
        K.reset_launches()
        printed = io.StringIO()
        with ctx.redirect_stdout(printed):
            res = main(run)
        launches = K.launches()
        n_iter = burnin + n_samples
        for name, count in launches.items():
            if count != per_iter.get(name, 0) * n_iter:
                raise AssertionError(f"{label} C = {C}: {name} launched {count} times in "
                                     f"{n_iter} iterations, expected {per_iter.get(name, 0)} "
                                     "each")
        got[C] = (res, launches, printed.getvalue(), path)
    res, launches, printed, path = got[chains]
    rate = float(res.stats.accept_cum.mean())
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"{label}: update rate {rate:.4f} outside (0, 1)")
    if "Rhat max=" not in printed or "median=" not in printed:
        raise AssertionError(f"{label}: no split-R-hat printed: {printed!r}")
    with np.load(path) as z:
        check({k: z[k] for k in z.files})
    sps = chains * schedule[1] / res.sampling_time
    rhat = printed[printed.index("Rhat max="):].split(",")[0].strip()
    per = {k: v // sum(schedule) for k, v in launches.items() if v}
    log(f"  {label}: launches an iteration {per} at C = 1 and at C = {chains}; update rate "
        f"{rate:.4f}, {rhat.splitlines()[0]}; "
        f"{sps:.2f} samples/s of all {chains} chains ({sps / chains:.2f} a chain) on {card}")
    return got[1][1], launches


# Phases 33-35: the last single-card gaps. C chains through the PIT's blocked
# route (the chain instances of stitch_draws and within_block_cols, rows
# 17-18), ancestor scanning, systematic resampling and the generic loops
# over the chain axis, theta-logistic PGAS as one batched step; and the
# widths past the kernels' instances, routed to the plain versions by shape.
DRAW_CHAINS = 4         # chains of the batched N=4096 blocked step (phases 18 and 33)
DRAW_MANY = (32, 64)    # chains and T of phase 33's second shape (level 0: 32 nodes a chain)
PIT_BIG_ONE = (1, 2)    # burn-in + sampling of each N=4096 C = 1 count run
PIT_BIG_LOOP = (1, 3)   # ... and of the chain loop at C = DRAW_CHAINS beside it
DRAW_CHAIN_KERNELS = {  # entry -> (the wrapper whose launches it counts, source, replaces)
    "stitch_draws_chains": ("stitch_draws",) + STITCH_KERNELS["stitch_draws"],
    "within_block_cols_chains": ("within_block_cols",) + STITCH_KERNELS["within_block_cols"],
}
TL_CHAINS = 32                  # theta-logistic PGAS chains as one batched step (phase 10)
TL_CHAIN_SCHEDULE = (100, 200)  # burn-in + sampling of that run
TL_LOOP = (1, 3)                # ... of its chain loop and of its C = 1 count run
WIDE_SV_D, WIDE_SP_SIDE = 33, 9  # past f64's last instance (32) and 64 components in registers
WIDE_SV_D32 = 49                 # past f32's last instance (48)
X_F32 = 2e-3                     # f32 steps card vs CPU: float32 moves the drawn path by ~5e-4


def blocked_chain_kernel(ys, N, draws, chains=True):
    """The SV PIT kernel on the blocked route with `draws`, over the chain
    axis (the model's params with a unit chain axis) or one chain's."""
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    return ind.get_kernel(*sv.get_feynman_kac(ys, *SV_PARAMS, chains), N, parallel=True,
                          stitch="blocked", draws=draws)


def draw_chain_call(dev, T_, C, draws, seed):
    """The level-0 call (args, kwargs) of the draws' wrapper in one batched
    blocked step of C chains of the SV D=1 model at T_, N=PIT_N, f32, each
    chain from the simulated states (its own noise), delta PIT_DELTA."""
    import torch
    from aux_ssm_tpu_torch.kernels.csmc_base import CSMCState
    name = "stitch_draws" if draws == "fused" else "within_block_cols"
    bxs, bys = pit_big_data(dev, torch.float32)
    xs, ys = bxs[:T_], bys[:T_]
    _, kernel = blocked_chain_kernel(ys, PIT_N, draws)
    x = xs.expand(C, -1, -1).clone()
    state = CSMCState(x=x, updated=torch.zeros(x.shape[:-1], dtype=torch.bool, device=dev))
    with recording_stitching() as seen:
        kernel(state, torch.full((C, T_), PIT_DELTA, device=dev),
               generator=torch.Generator(device=dev).manual_seed(seed))
    args, kw = seen[name][0]
    kw = {k: v for k, v in kw.items() if k != "col_extra"}
    if kw.get("chains") != C:
        raise AssertionError(f"{name}: the batched step called it with {kw}, not chains={C}")
    return name, args, kw


def chain_nodes(args, P, lo, hi, seed):
    """A draws call's arguments cut to the nodes lo:hi, with `seed`."""
    import torch
    return (seed,) + tuple(z[lo:hi] if torch.is_tensor(z) and z.dim() and z.shape[0] == P else z
                           for z in args[1:])


def check_draw_chains(label, name, args, kw, reps, timing):
    """A draw kernel's chain instance (`chains` C, a seed a chain) on a real
    batched blocked step's level-0 inputs (f32, and cast to f64): the f64
    kernel's indices identical to the plain chain twin's, the f32 kernel's
    equal to the f32 and to the f64 plain twin's at >= AGREE_F32 (phase 16's
    bounds); the C = 1 call bit-equal to the one-chain call, and chains 0, C
    / 2, C - 1 bit-equal to one-chain launches with their seeds, in f32 and
    f64. With `timing`, the C-chain launch's time (CUDA events and the
    profiler's device ms) beside the C = 1 launch's and C one-chain
    launches', the plain twin's and the bound. Returns the entry."""
    import torch
    from aux_ssm_tpu_torch.ops import stitching as plain
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    wrapper, plain_fn = getattr(KS, name), getattr(plain, name)
    C = kw["chains"]
    seeds = args[0]
    at = INDEX_KERNELS[name]
    rf, cf = args[at], args[at + 1]
    P, k, N_ = rf.shape[0], rf.shape[-1], cf.shape[1]
    per = P // C
    args64 = tuple(z.double() if torch.is_tensor(z) and z.is_floating_point() else z
                   for z in args)
    got, want32 = as_tuple(wrapper(*args, **kw)), as_tuple(plain_fn(*args, **kw))
    got64, want64 = as_tuple(wrapper(*args64, **kw)), as_tuple(plain_fn(*args64, **kw))
    torch.cuda.synchronize()
    for g, w in zip(got64, want64):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}[{label}] f64: {int((g != w).sum())} indices differ "
                                 "from the plain chain twin's")
    share = min(float((g == w).double().mean()) for g, w in zip(got, want32))
    share64 = min(float((g == w).double().mean()) for g, w in zip(got, want64))
    if not (share >= AGREE_F32 and share64 >= AGREE_F32):
        raise AssertionError(f"{name}[{label}] f32: only {share:.6f} and {share64:.6f} of the "
                             "indices agree with the plain chain twin")
    picked = sorted({0, C // 2, C - 1})
    for a, out in ((args, got), (args64, got64)):
        for c in picked:
            one = as_tuple(wrapper(*chain_nodes(a, P, c * per, (c + 1) * per, seeds[c])))
            if not all(torch.equal(o[c * per:(c + 1) * per], w) for o, w in zip(out, one)):
                raise AssertionError(f"{name}[{label}]: chain {c} of the C = {C} launch "
                                     "differs from a one-chain launch with its seed")
            if c == 0:
                first = as_tuple(wrapper(*chain_nodes(a, P, 0, per, seeds[0:1]), chains=1))
                if not all(torch.equal(f, w) for f, w in zip(first, one)):
                    raise AssertionError(f"{name}[{label}]: the C = 1 call differs from the "
                                         "one-chain call")
    result = {"chains": C, "nodes": P, "index_agree_f32": share,
              "index_agree_f32_vs_f64": share64,
              "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want32))}
    n = got[0].shape[1]
    score = 2 * k + 25
    if name == "within_block_cols":
        ops = P * n * 128 * score
    else:
        ops = P * n * (128 * score + 2 * 128 + 8 * (N_ // 128))
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    result["issue_bound_ms"] = 1e3 * P * n * 128 * DRAW_SCORE_INSTRUCTIONS / (lanes
                                                                             * sm_clock_hz())
    result["ms"] = cuda_ms(lambda: wrapper(*args, **kw), reps)
    result["plain_ms"] = cuda_ms(lambda: plain_fn(*args, **kw), 1)
    result.update(bound([z for z in args if torch.is_tensor(z)] + list(got), 0, ops))
    line = (f"  {name}_chains[{label}] C={C}, {P} nodes, n={n}, N={N_}, k={k}: f64 indices "
            f"identical to the plain chain twin's; f32 equal to the f32 twin's {share:.6f}, to "
            f"the f64 twin's {share64:.6f} (bound {AGREE_F32}); C = 1 and chains {picked} "
            f"bit-equal to one-chain launches with their seeds (f32, f64); the C-chain launch "
            f"{result['ms']:.4f} ms, plain twin {result['plain_ms']:.2f} ms, bound "
            f"{result['bound_ms']:.5f} ms by {result['bound_by']}, issue bound "
            f"{result['issue_bound_ms']:.5f} ms")
    if timing:
        c1 = chain_nodes(args, P, 0, per, seeds[0:1])
        ones = [chain_nodes(args, P, c * per, (c + 1) * per, seeds[c]) for c in range(C)]

        def each_alone():
            for one in ones:
                wrapper(*one)

        result["device_ms"] = device_ms(lambda: wrapper(*args, **kw), reps)
        result.update({
            "c1_ms": cuda_ms(lambda: wrapper(*c1, chains=1), reps),
            "c1_device_ms": device_ms(lambda: wrapper(*c1, chains=1), reps),
            "one_chain_launches_ms": cuda_ms(each_alone, reps),
            "one_chain_launches_device_ms": device_ms(each_alone, reps)})

        def ms(v):
            return "not measured" if v is None else f"{v:.4f}"

        line += (f"; device ms: the C-chain launch {ms(result['device_ms'])}, C = 1 "
                 f"{ms(result['c1_device_ms'])} (events {result['c1_ms']:.4f}), {C} one-chain "
                 f"launches {ms(result['one_chain_launches_device_ms'])} (events "
                 f"{result['one_chain_launches_ms']:.4f})")
    log(line)
    return result


def phase_draw_chains(dev):
    """Phase 33: the chain instances of stitch_draws (row 17) and
    within_block_cols (row 18) on the level-0 inputs of real batched blocked
    steps of the SV D=1 model, N=PIT_N: T=PIT_T at C = DRAW_CHAINS (2048
    nodes), timed, and T=64 at C = 32 (1024 nodes); each held by
    `check_draw_chains`. Run right after the build, with phases 29, 30 and
    32's checks (`device_ms`). Returns the entries."""
    C_many, T_many = DRAW_MANY
    log(f"phase 33: the draws' chain instances on real batched blocked steps' level-0 inputs "
        f"(SV D=1, N={PIT_N}, f32 and f64): T={PIT_T} at C = {DRAW_CHAINS}, T={T_many} at C = "
        f"{C_many}")
    results = {}
    for draws in ("fused", "joint"):
        name, args, kw = draw_chain_call(dev, PIT_T, DRAW_CHAINS, draws, 33)
        entry = check_draw_chains(f"T={PIT_T} level 0", name, args, kw, 5, timing=True)
        del args
        name, args, kw = draw_chain_call(dev, T_many, C_many, draws, 34)
        entry[f"C{C_many}"] = check_draw_chains(f"T={T_many} level 0", name, args, kw, 5,
                                                timing=False)
        entry["shape"] = (f"SV D=1, T={PIT_T}, N={PIT_N}, level 0 of C = {DRAW_CHAINS} chains "
                          f"({entry['nodes']} nodes)")
        results[f"{name}_chains"] = entry
    return results


def pit_big_chains(dev, card, draws):
    """Phase 18's N=4096 blocked chains over the chain axis: C = DRAW_CHAINS
    chains of the SV D=1 model at T=PIT_T from the simulated states, delta
    frozen at PIT_DELTA, as one batched step (`run_sharded_chains`,
    PIT_BIG_SCHEDULE) beside a C = 1 count run (PIT_BIG_ONE) and the chain
    loop of the one-chain kernel at C (PIT_BIG_LOOP): the stitching launches
    an iteration those of one step at C = 1 and at C, every chain's update
    rate in PIT_BIG_RATE, finite states; samples/s of all chains batched and
    looped, and a profile of the batched step. Returns the launches of the C
    = 1 run and of the C run."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig
    from aux_ssm_tpu_torch.kernels.csmc_base import CSMCState
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.parallel.chains import broadcast_chains, chain_loop
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains
    f32 = torch.float32
    C = DRAW_CHAINS
    bxs, bys = pit_big_data(dev, f32)
    _, batched = blocked_chain_kernel(bys, PIT_N, draws)
    _, one = blocked_chain_kernel(bys, PIT_N, draws, chains=False)
    per_iter = pit_launches(PIT_T, PIT_N, draws=draws)
    start = CSMCState(x=bxs, updated=torch.zeros(PIT_T, dtype=torch.bool, device=dev))
    delta = torch.full((PIT_T,), PIT_DELTA, dtype=f32, device=dev)
    label = f"SV csmc parallel=True D=1 T={PIT_T} N={PIT_N} (blocked, {draws} draws)"
    runs = {}
    for key, kernel, n, (burnin, n_samples) in (("C=1", batched, 1, PIT_BIG_ONE),
                                                 (f"C={C}", batched, C, PIT_BIG_SCHEDULE),
                                                 ("loop", chain_loop(one), C, PIT_BIG_LOOP)):
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        cfg = RunConfig(n_samples=n_samples, burnin=burnin, learning_rate=0.0)
        res = run_sharded_chains(kernel, broadcast_chains(start, n), cfg,
                                 generator=torch.Generator(device=dev).manual_seed(21),
                                 delta_init=broadcast_chains(delta, n))
        launches, n_iter = K.launches(), burnin + n_samples
        scale = n if key == "loop" else 1
        for name_, count in launches.items():
            if count != per_iter.get(name_, 0) * n_iter * scale:
                raise AssertionError(f"{label} {key}: {name_} launched {count} times in "
                                     f"{n_iter} iterations, expected "
                                     f"{per_iter.get(name_, 0) * scale} each")
        if not bool(torch.isfinite(res.state.x).all()) or res.state.x.shape != (n, PIT_T, 1):
            raise AssertionError(f"{label} {key}: the chains' state is not finite")
        rates = res.stats.accept_cum.mean(-1)
        lo, hi = PIT_BIG_RATE
        if not bool(((rates >= lo) & (rates <= hi)).all()):
            raise AssertionError(f"{label} {key}: update rates {rates.tolist()} outside "
                                 f"{PIT_BIG_RATE}")
        runs[key] = (res, launches, n * n_samples / res.sampling_time,
                     torch.cuda.max_memory_allocated() / 2 ** 30)
    res, launches, sps, peak = runs[f"C={C}"]
    per = {k: v // sum(PIT_BIG_SCHEDULE) for k, v in launches.items() if v}
    log(f"  {label}, frozen delta {PIT_DELTA}: C = {C} as one batched step, "
        f"{PIT_BIG_SCHEDULE[0]} + {PIT_BIG_SCHEDULE[1]} iterations, each chain's update rate "
        f"{[round(float(r), 4) for r in res.stats.accept_cum.mean(-1)]}, launches an iteration "
        f"{per} at C = 1 and at C = {C}; {sps:.2f} samples/s of all {C} chains (C = 1: "
        f"{runs['C=1'][2]:.2f}; the chain loop at C = {C}: {runs['loop'][2]:.2f}) on {card}; "
        f"peak device memory {peak:.2f} GiB (C = 1: {runs['C=1'][3]:.2f})")
    gen, box = torch.Generator(device=dev).manual_seed(22), [res.state]
    profile_steps(f"{label}, C = {C} batched",
                  lambda: box.__setitem__(0, batched(box[0], res.delta, generator=gen)), n=3,
                  also=tuple(STITCH_KERNELS))
    return runs["C=1"][1], launches


def theta_chains(dev, card, ys, launches):
    """Phase 10's batched run: C = TL_CHAINS theta-logistic PGAS chains as one
    batched step (`get_pgas_kernel(..., chains=True)`, ancestor scanning) from
    x = 0 for TL_CHAIN_SCHEDULE, beside a C = 1 count run and the chain loop
    of the one-chain kernel at C (TL_LOOP each): one lane sweep an iteration
    at C = 1 and at C and nothing else, finite, the update rate of all chains
    in (0, 1), their pooled posterior mean within 0.3 of the data; samples/s
    of all chains batched and looped, and a profile of the batched step.
    Adds the C = 1 run's launches to `launches`; returns the C run's."""
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig
    from aux_ssm_tpu_torch.models import theta_logistic as tl
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.parallel.chains import broadcast_chains, chain_loop
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains
    C = TL_CHAINS
    init, one = tl.get_pgas_kernel(ys, TL_N)
    _, batched = tl.get_pgas_kernel(ys, TL_N, chains=True)
    if not getattr(batched, "chain_axis", False):
        raise AssertionError("theta-logistic: the chains=True kernel is not marked chain_axis")

    def no_delta(kern):  # bootstrap PGAS has no step size
        return lambda state, delta, generator=None: kern(state, generator=generator)

    runs = {}
    for key, kern, n, (burnin, n_samples) in (("C=1", no_delta(batched), 1, TL_LOOP),
                                               (f"C={C}", no_delta(batched), C,
                                                TL_CHAIN_SCHEDULE),
                                               ("loop", chain_loop(no_delta(one)), C, TL_LOOP)):
        K.reset_launches()
        res = run_sharded_chains(kern, broadcast_chains(init(torch.zeros_like(ys)), n),
                                 RunConfig(n_samples=n_samples, burnin=burnin),
                                 generator=torch.Generator(device=dev).manual_seed(15),
                                 delta_init=torch.ones(n, TL_T, device=dev))
        got, n_iter = K.launches(), burnin + n_samples
        want = n_iter * (n if key == "loop" else 1)
        if got["lane_scan"] != want or any(v for k, v in got.items() if k != "lane_scan"):
            raise AssertionError(f"theta-logistic {key}: launches {got}, expected {want} lane "
                                 "sweeps and nothing else")
        if not bool(torch.isfinite(res.state.x).all()):
            raise AssertionError(f"theta-logistic {key}: the chains' state is not finite")
        runs[key] = (res, got, n * n_samples / res.sampling_time)
    launches["lane_scan"] += runs["C=1"][1]["lane_scan"]
    res, got, sps = runs[f"C={C}"]
    rate = float(res.stats.accept_cum.mean())
    gap = float((res.stats.mean_x.mean(0) - ys).abs().mean())
    log(f"  theta-logistic PGAS, C = {C} as one batched step, {TL_CHAIN_SCHEDULE[0]} + "
        f"{TL_CHAIN_SCHEDULE[1]} iterations: update rate {rate:.4f}, pooled mean |E x - y| "
        f"{gap:.4f}, one lane sweep an iteration at C = 1 and at C = {C}; {sps:.2f} samples/s "
        f"of all {C} chains (C = 1: {runs['C=1'][2]:.2f}; the chain loop at C = {C}: "
        f"{runs['loop'][2]:.2f}) on {card}")
    if not 0.0 < rate < 1.0 or not gap < 0.3:
        raise AssertionError(f"theta-logistic C = {C}: update rate {rate:.4f}, mean gap "
                             f"{gap:.4f}")
    gen, box = torch.Generator(device=dev).manual_seed(16), [res.state]
    profile_steps(f"theta-logistic PGAS, C = {C} batched",
                  lambda: box.__setitem__(0, batched(box[0], generator=gen)))
    return got


def phase_wide_routes(dev):
    """Phase 34: widths past the d x d kernels' instances and past the
    block-lane functors' register width. In f64 on the card against the CPU
    given the same noise (`steps_on_both`, RTOL_F64): two SV kalman-1 steps
    at D = WIDE_SV_D (T=16), the six d x d wrappers launched 0 times (phase
    21 launches them at D = 30); the same in f32 at D = WIDE_SV_D32, past the
    f32 D = 48 instance (phase 36 launches them at D = 40), to X_F32; two
    spatial csmc-guided steps at d = 81
    (side WIDE_SP_SIDE, T=8, N=16), the block-lane sweep launched once a
    step, its lanes' components in the warp's shared scratch (d = 64, in
    registers, is phases 13-14's). Then the block-lane sweep alone on a real
    csmc-guided-grad step's inputs at T=SP_T, d=81, N=SP_N against its plain
    version (`check_block_lane`, as phase 13). Returns that entry."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    f32, f64 = torch.float32, torch.float64
    d = WIDE_SP_SIDE ** 2
    log(f"phase 34: widths past the kernels' instances, card vs CPU: SV kalman-1 at D = "
        f"{WIDE_SV_D} in f64 and D = {WIDE_SV_D32} in f32 (the d x d kernels stop at 32 in f64, "
        f"48 in f32: plain versions), spatial csmc-guided at d = {d} in f64 (the block-lane "
        "sweep past its register width: components in shared memory)")
    rng = np.random.default_rng(34)
    T_ = 16
    xs, ys = sv.get_data(*SV_PARAMS, WIDE_SV_D, T_, generator=torch.Generator().manual_seed(34),
                         device="cpu")
    steps_on_both(f"SV kalman-1 step T={T_} D={WIDE_SV_D}",
                  lambda where: sv.get_kalman_kernel(ys.to(where), *SV_PARAMS, True, 1),
                  xs, 0.05, [(rng.standard_normal((T_, WIDE_SV_D)),
                              rng.standard_normal((T_, WIDE_SV_D)), rng.uniform())
                             for _ in range(2)], dev, {})
    xs, ys = (z.float() for z in sv.get_data(*SV_PARAMS, WIDE_SV_D32, T_, device="cpu",
                                             generator=torch.Generator().manual_seed(34)))
    steps_on_both(f"SV kalman-1 step T={T_} D={WIDE_SV_D32}",
                  lambda where: sv.get_kalman_kernel(ys.to(where), *SV_PARAMS, True, 1),
                  xs, 0.05, [(rng.standard_normal((T_, WIDE_SV_D32)),
                              rng.standard_normal((T_, WIDE_SV_D32)), rng.uniform())
                             for _ in range(2)], dev, {}, dtype="float32", bound=X_F32)
    T_, N_ = 8, 16
    sxs, sys_ = spatial_data("cpu", f64, T_, WIDE_SP_SIDE, seed=34)
    steps_on_both(
        f"spatial csmc-guided step T={T_} d={d} N={N_}",
        lambda where: spatial_kernel("csmc-guided", sys_.to(where), WIDE_SP_SIDE, N_),
        sxs, rng.uniform(0.005, 0.05, T_),
        [(rng.standard_normal((T_, d)), rng.standard_normal((N_, d)),
          rng.uniform(size=(T_ - 1, N_)), rng.standard_normal((T_ - 1, N_, d)),
          rng.uniform(size=T_ - 1), rng.uniform(size=T_)) for _ in range(2)], dev,
        {"block_lane_scan": 1, "backward_factor_scan": FACTOR_LAUNCHES})
    seen = {}
    for dt in (f32, f64):
        xs_, ys_ = spatial_data(dev, dt, D=WIDE_SP_SIDE)
        init, kernel = spatial_kernel("csmc-guided-grad", ys_, WIDE_SP_SIDE, SP_N)
        with recording_sweeps() as rec:
            kernel(init(xs_), torch.full((SP_T,), SP_DELTA0, dtype=dt, device=dev),
                   generator=torch.Generator(device=dev).manual_seed(34))
        seen[dt] = rec["block_lane_scan"]
    if tuple(seen[f32][2].shape) != (SP_T - 1, d, SP_N):
        raise AssertionError(f"block_lane_scan at d = {d}: handed noise of shape "
                             f"{tuple(seen[f32][2].shape)}")
    # As phase 13's: both products with P, 2 operations a nonzero, and ~40
    # elementwise operations a component.
    nnz = int((seen[f32][1].c.prec != 0).sum())
    return check_block_lane(f"spatial csmc-guided-grad T={SP_T} d={d} N={SP_N}", seen[f32],
                            seen[f64], reps=10, ops_per_particle=4 * nnz + 40 * d)


# ---------------------------------------------------------------------------
# Phase 36: the MH kernels' float32 D = 48 instance (SV at D = 33-48)
# ---------------------------------------------------------------------------

SV48_D, SV48_T = 40, 128   # inside the JAX package's Pallas range (f32 d <= 43 at T <= 128)
SV48_EDGES = (33, 48)      # the instance's edges, on random models
SV48_CHAINS = 32           # chains of the dense batched layout
SV48_DELTA = {"kalman-1": 0.05, "kalman-2": 0.1}  # frozen: update rate ~0.5 at this shape
SV48_SCHEDULE = {1: (5, 80), SV48_CHAINS: (5, 40)}  # burn-in + sampling a run, by C
SV48_BATCHES = 10          # batches of a chain's accepts for the rate's standard error
SV48_RATE_SE = 4.0         # f32 kernel route's rate vs the f64 plain route's, in standard errors
# What each kernel's name holds in the profiler at the D = 48 instance.
WIDE48_NAMES = {"make_elements": r"elements_kernel<float, 48\b",
                "filter_scan": r"FilterOp<float, 48>",
                "ell": r"ell_kernel<float, 48\b",
                "backward_maps": r"backward_maps_kernel<float, 48\b",
                "affine_scan": r"AffineOp<float, 48>",
                "logdensity_steps": r"logdensity_kernel<float, 48\b"}


def sv48_data(dev, dtype):
    """(xs, ys) of the SV model at D = SV48_D, T = SV48_T, simulated in
    float64 on the CPU from seed 36 (xs an exact posterior draw given ys),
    on `dev` in `dtype`."""
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    xs, ys = sv.get_data(*SV_PARAMS, SV48_D, SV48_T, generator=torch.Generator().manual_seed(36),
                         device="cpu")
    return xs.to(device=dev, dtype=dtype), ys.to(device=dev, dtype=dtype)


def sv48_step_inputs(dev, C, gen):
    """A real SV kalman-1 step's kernel inputs at D = SV48_D (f32, `mh_inputs`)
    from xs, at the frozen delta: one chain (C = 0: (T, D)), or C chains
    of the dense batched layout (time first, each with its own u and delta
    0.75-1.25 times it, F, Q and b shared); with the draw's normals."""
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    f32 = torch.float32
    xs, ys = sv48_data(dev, f32)
    delta = SV48_DELTA["kalman-1"]
    if not C:
        dyn, obs1, _, _ = sv.get_kalman_factories(ys, *SV_PARAMS)
        u = xs + (0.5 * delta) ** 0.5 * torch.randn(xs.shape, generator=gen, device=dev)
        return (*mh_inputs(dyn, obs1, xs, u, delta),
                torch.randn(xs.shape, generator=gen, device=dev))
    deltas = delta * torch.linspace(0.75, 1.25, C, dtype=f32, device=dev)
    x = xs[:, None].expand(SV48_T, C, SV48_D)
    u = x + (0.5 * deltas[:, None]).sqrt() * torch.randn(x.shape, generator=gen, device=dev)
    dyn, obs1, _, _ = sv.get_kalman_factories(ys, *SV_PARAMS, chains=True)
    return (*mh_inputs(dyn, obs1, x, u, deltas), torch.randn(x.shape, generator=gen, device=dev))


def sv48_kernels(dev):
    """The six MH kernels' D = 48 instance (float32 only: no f64 kernel to
    hold) on a real SV kalman-1 step's inputs at D = SV48_D, T = SV48_T,
    against their plain versions at phase 20's bounds, with device ms by the
    profiler; the same at C = SV48_CHAINS chains of the dense batched layout
    (C = 1 and three chains bit-equal to one-chain launches); make_elements
    and the filter scan at the edges 33 and 48 on random models; the filter
    combine's cycles on its chain's 256 threads, the affine's on 128 and
    256. Returns the entries at C = 1, each with its C entry
    inside."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    gen = torch.Generator(device=dev).manual_seed(36)
    kw = dict(own_bound=True, f64_kernel=False)
    log(f"phase 36: the MH kernels' float32 D = 48 instance on a real SV kalman-1 step's inputs "
        f"(T={SV48_T}, dx=dy={SV48_D}, simulated xs, delta {SV48_DELTA['kalman-1']}; f32 kernel "
        f"vs f32 plain and vs f64 plain at phase 20's bounds; no f64 kernel past 32)")
    steps, m0u, P0u, eps = sv48_step_inputs(dev, 0, gen)
    results, elems, gains, incs = check_mh_kernels("_d48", steps, m0u, P0u, eps, holes_seed=36,
                                                   device_time=True, **kw)
    aff = {nt: FS.combine_cycles((gains, incs), nt, 20, scan="affine")[0] for nt in (128, 256)}
    log(f"  combine cycles at D = 48 (clock64, the mean of a chain of 20): filter "
        f"{FS.combine_cycles(elems, 256, 20)[0]:.0f} on its chain's 256 threads, affine "
        f"{aff[128]:.0f} on 128, {aff[256]:.0f} on 256")
    C = SV48_CHAINS
    log(f"  the chain instances: C = {C} chains of the dense batched layout, F, Q, b shared:")
    steps, m0u, P0u, eps = sv48_step_inputs(dev, C, gen)
    chained = check_chain_mh_kernels("_d48", steps, m0u, P0u, eps, reps=5, device_time=True,
                                     **kw)[0]
    for d in SV48_EDGES:
        edge_kernels(dev, SV48_T, d, reps=3, **kw)
    for k, v in results.items():
        v["shape"] = f"T={SV48_T}, D={SV48_D}"
        v["chains"] = {f"T={SV48_T}, D={SV48_D}, C={C}": chained[k]}
    return results


def sv48_chain(dev, style, order, C, dtype, gen):
    """SV `style` at D = SV48_D, T = SV48_T from xs at its frozen delta, C
    chains (the one-chain kernel at C = 1, the batched one past it), in
    `dtype`: (update rate, its standard error by batch means over each
    chain's SV48_BATCHES batches, samples/s of all chains, launches)."""
    import numpy as np
    import torch
    from aux_ssm_tpu_torch.experiments import RunConfig, runner
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import cuda as K
    from aux_ssm_tpu_torch.parallel.chains import run_sharded_chains
    xs, ys = sv48_data(dev, dtype)
    burnin, n_samples = SV48_SCHEDULE[C]
    cfg = RunConfig(n_samples=n_samples, burnin=burnin, learning_rate=0.0)
    delta = SV48_DELTA[style]
    K.reset_launches()
    if C == 1:
        init, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, order)
        res = runner.run_chain(kernel, init(xs), cfg, generator=gen, delta_init=delta,
                               collect_samples=True, collect_fn=lambda s: s.updated)
    else:
        init, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, order, chains=True)
        res = run_sharded_chains(kernel, init(xs.expand(C, -1, -1).clone()), cfg, generator=gen,
                                 delta_init=torch.full((C,), delta, dtype=dtype, device=dev),
                                 collect_samples=True, collect_fn=lambda s: s.updated)
    launches = K.launches()
    if not bool(torch.isfinite(res.state.x).all()):
        raise AssertionError(f"{style} C = {C} {dtype}: the chain's state is not finite")
    accepts = np.asarray(res.samples, dtype=np.float64).reshape(C, SV48_BATCHES, -1)
    means = accepts.mean(-1).ravel()
    rate, se = float(accepts.mean()), float(means.std(ddof=1) / len(means) ** 0.5)
    return rate, se, C * n_samples / res.sampling_time, launches


def sv48_chains(dev, card):
    """SV kalman-1 and kalman-2 at D = SV48_D, T = SV48_T, C = 1 and C =
    SV48_CHAINS, at their frozen deltas: in float32 through the D = 48
    instance (every MH kernel launched as at D = 30, 10 a step at C = 1 and
    at C) and in float64 through the plain route on the card (no d x d
    kernel: float64 stops at 32); the f32 update rate within SV48_RATE_SE
    standard errors of the f64 one; samples/s of all chains of both.
    Returns the six kernels' launches over the f32 runs."""
    import torch
    total = dict.fromkeys(KERNELS, 0)
    log(f"  SV kalman chains at T={SV48_T}, D={SV48_D}, frozen delta "
        f"{SV48_DELTA}, from xs (an exact posterior draw): f32 through the D = 48 instance "
        f"against f64 through the plain route, both on the card; rates within "
        f"{SV48_RATE_SE:g} standard errors (batch means)")
    for style, (_, order) in SV_KALMAN.items():
        for C in (1, SV48_CHAINS):
            burnin, n_samples = SV48_SCHEDULE[C]
            n_iter = burnin + n_samples
            runs = {}
            for dtype in (torch.float32, torch.float64):
                gen = torch.Generator(device=dev).manual_seed(36 + order)
                runs[dtype] = sv48_chain(dev, style, order, C, dtype, gen)
            (r32, se32, sps32, l32), (r64, se64, sps64, l64) = runs[torch.float32], runs[
                torch.float64]
            want = {k: KERNELS[k][2] * n_iter for k in KERNELS}
            if {k: l32[k] for k in KERNELS} != want or any(
                    v for k, v in l32.items() if k not in KERNELS) or any(l64.values()):
                raise AssertionError(f"{style} C = {C}: launches f32 {l32}, f64 {l64}; expected "
                                     f"{want} in f32 and none in f64")
            z = (r32 - r64) / (se32 ** 2 + se64 ** 2) ** 0.5
            log(f"  {style}, C = {C}, {burnin} + {n_samples}: update rate f32 {r32:.4f} (se "
                f"{se32:.4f}), f64 plain {r64:.4f} (se {se64:.4f}), z {z:+.2f}; samples/s of all "
                f"chains f32 {sps32:.2f}, f64 plain {sps64:.2f} on {card}; f32 launches a step "
                f"{({k: l32[k] // n_iter for k in KERNELS})}")
            if not abs(z) <= SV48_RATE_SE:
                raise AssertionError(f"{style} C = {C}: the f32 rate {r32:.4f} is {z:+.2f} "
                                     f"standard errors from the f64 plain route's {r64:.4f}")
            for k in KERNELS:
                total[k] += l32[k]
    return total


def phase_wide48(dev, card):
    """Phase 36 (right after phase 30): `sv48_kernels`, `sv48_chains`, and a
    profile of the f32 kalman-1 step at D = SV48_D (its kernels the D = 48
    instance's, by name). Returns (the kernel entries, their launches over
    the f32 chain runs)."""
    import re
    import torch
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    tic = time.perf_counter()
    results = sv48_kernels(dev)
    launches = sv48_chains(dev, card)
    xs, ys = sv48_data(dev, torch.float32)
    init, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, 1)
    gen = torch.Generator(device=dev).manual_seed(36)
    box = [init(xs)]
    events = profile_steps(f"SV kalman-1 at T={SV48_T}, D={SV48_D}, f32",
                           lambda: box.__setitem__(0, kernel(box[0], SV48_DELTA["kalman-1"],
                                                             generator=gen)), n=10)
    names = [e.key for e in events]
    missing = [k for k, pat in WIDE48_NAMES.items()
               if not any(re.search(pat, key) for key in names)]
    if events and missing:
        raise AssertionError(f"SV kalman-1 at D = {SV48_D}: the profiler shows no D = 48 "
                             f"instance of {missing}")
    log(f"  phase 36 took {time.perf_counter() - tic:.1f} s")
    return results, launches


MESH_SHARDS = 4                 # shards of each phase-35 mesh, over the cards there are
MESH_CHAINS = 32                # SV kalman-1 chains on the chains mesh (T=250, D=30)
MESH_SCHEDULE = (2, 3)          # their burn-in + sampling iterations
MESH_PIT_X_ATOL = 1e-6          # time-sharded PIT x against the one-device kernel's (f64)
MESH_SCAN_NREL = {"float32": 1e-5, "float64": 1e-12}  # time scans vs one-device scans
MESH_BATCH_NREL = 1e-5          # batch-sharded spatial step's x vs the unsharded one (f32)
MESH_BATCH_DELTA = 1e-3         # its delta
MESH_PROC_TIMEOUT = 300         # seconds each process of the multi-process run may take


def mesh_devices():
    """MESH_SHARDS shards over the cards there are, card by card."""
    import torch
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(MESH_SHARDS)]


def mesh_launches(fn):
    """(fn(), the kernel launches of fn(), by wrapper)."""
    import torch
    from aux_ssm_tpu_torch.ops import cuda as K
    K.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in K.launches().items() if v}


def add_launches(into, got):
    for name, count in got.items():
        into[name] = into.get(name, 0) + count


def same_state(label, a, b, x_atol=0.0):
    import torch
    if not torch.equal(a.updated, b.updated):
        raise AssertionError(f"{label}: `updated` differs from the one-device kernel's")
    gap = float((a.x - b.x).abs().max())
    if gap > x_atol:
        raise AssertionError(f"{label}: x differs by {gap:.3g} (> {x_atol:g})")
    return gap


def mesh_pit(dev, devices, card, launches):
    """Phase 35's PIT part: the SV model at D=1, T=PIT_T, N=PIT_N (phase
    18's), f32. The particle-sharded step under both draws, bit-equal to the
    one-device blocked step with per-block maxima, block_masses launched
    MESH_SHARDS times a level; the per-shard block_masses launch against its
    plain version, its device time beside the full-width launch's; the
    time-sharded step (C = MESH_SHARDS): `updated` identical, x within
    MESH_PIT_X_ATOL. Returns the per-shard block_masses entry."""
    import torch
    from aux_ssm_tpu_torch.kernels import csmc_independent as ind
    from aux_ssm_tpu_torch.kernels import pit
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.ops import stitching as plain
    from aux_ssm_tpu_torch.ops.cuda import stitching as KS
    from aux_ssm_tpu_torch.parallel.mesh import PARTICLES, make_mesh
    from aux_ssm_tpu_torch.parallel.time_scan import TIME
    f32 = torch.float32
    xs, ys = pit_big_data(dev, f32)
    fk = sv.get_feynman_kac(ys, *SV_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(35)
    noise = ((torch.randn(PIT_T, 1, generator=gen, device=dev),
              torch.randn(PIT_T, PIT_N, 1, generator=gen, device=dev))
             + pit.draw_noise(PIT_T, PIT_N, xs, gen))
    below = len(pit.level_sizes(PIT_T)) - 1
    pmesh = make_mesh(devices=devices, axis_names=(PARTICLES,))
    for draws in ("joint", "fused"):
        init1, one = ind.get_kernel(*fk, PIT_N, parallel=True, stitch="blocked", draws=draws,
                                    block_max="block")
        init_s, shard = ind.get_kernel(*fk, PIT_N, parallel=True, draws=draws, mesh=pmesh,
                                       mesh_axis=PARTICLES)
        b, got = mesh_launches(lambda: shard(init_s(xs), PIT_DELTA, noise=noise))
        a = one(init1(xs), PIT_DELTA, noise=noise)
        same_state(f"particle-sharded PIT ({draws})", a, b)
        draw = "stitch_draws" if draws == "fused" else "within_block_cols"
        want = {"block_masses": MESH_SHARDS * below, draw: below, "row_lse": 1}
        if got != want:
            raise AssertionError(f"particle-sharded PIT ({draws}): launches {got}, expected {want}")
        add_launches(launches, got)
        ms = cuda_ms(lambda: shard(init_s(xs), PIT_DELTA, noise=noise), 3)
        ms1 = cuda_ms(lambda: one(init1(xs), PIT_DELTA, noise=noise), 3)
        log(f"  particle-sharded PIT, SV D=1 T={PIT_T} N={PIT_N}, {draws} draws, S={MESH_SHARDS}: "
            f"x and updated bit-equal to the one-device blocked step with per-block maxima "
            f"({int(a.updated.sum())} of {PIT_T} moved); launches {got}; step {ms:.3f} ms, "
            f"one device {ms1:.3f} ms, on {card}")

    # The per-shard block_masses launch, on level 0's inputs of a real step.
    with recording_stitching() as seen:
        one(init1(xs), PIT_DELTA, noise=noise)
    rf, cf, cb = seen["block_masses"][0][0][:3]
    n_cols = PIT_N // MESH_SHARDS
    shard_args = (rf, cf[:, :n_cols].contiguous(), cb[:, :n_cols].contiguous())
    entry = {}
    for dt in (f32, torch.float64):
        args = tuple(z.to(dt) for z in shard_args)
        err = nrel(KS.block_masses(*args, per_block_max=True),
                   plain.block_masses(*args, per_block_max=True))
        bound_ = NREL_F32 if dt == f32 else NREL_F64
        if not err <= bound_:
            raise AssertionError(f"block_masses per shard ({dt}): nrel {err:.3g} > {bound_:g}")
        entry[f"nrel_{str(dt)[6:]}"] = err
    P, n, k = rf.shape
    entry.update(shape=f"P={P}, rows={n}, columns={n_cols}, k={k}, per_block_max",
                 ms=device_ms(lambda: KS.block_masses(*shard_args, per_block_max=True), 10),
                 full_width_ms=device_ms(lambda: KS.block_masses(rf, cf, cb, per_block_max=True),
                                         10),
                 plain_ms=cuda_ms(lambda: plain.block_masses(*shard_args, per_block_max=True),
                                  3))
    log(f"  block_masses per shard ({entry['shape']}): nrel f32 {entry['nrel_float32']:.3g}, "
        f"f64 {entry['nrel_float64']:.3g} against its plain version; device "
        f"{entry['ms']:.4f} ms a shard, {entry['full_width_ms']:.4f} ms the full width "
        f"({PIT_N} columns), plain {entry['plain_ms']:.3f} ms, on {card}")

    # The time-sharded step: its chunks' levels have a quarter of the nodes,
    # and a launch's plan (and cuBLAS's choice for the pair factors) follows
    # the node count, so f32 values may round otherwise than in the
    # one-device step: the check runs in f64, f32 is timed and its share of
    # equal picks logged.
    tmesh = make_mesh(devices=devices, axis_names=(TIME,))
    for dt in (torch.float64, f32):
        xs_t, ys_t = pit_big_data(dev, dt)
        fk_t = sv.get_feynman_kac(ys_t, *SV_PARAMS)
        noise_t = (noise[0].to(dt), noise[1].to(dt),
                   [(u.to(dt), seed) for u, seed in noise[2]], tuple(z.to(dt) for z in noise[3]))
        init1, one = ind.get_kernel(*fk_t, PIT_N, parallel=True)
        init_s, shard = ind.get_kernel(*fk_t, PIT_N, parallel=True, mesh=tmesh, mesh_axis=TIME)
        b, got = mesh_launches(lambda: shard(init_s(xs_t), PIT_DELTA, noise=noise_t))
        a = one(init1(xs_t), PIT_DELTA, noise=noise_t)
        ms = cuda_ms(lambda: shard(init_s(xs_t), PIT_DELTA, noise=noise_t), 3)
        ms1 = cuda_ms(lambda: one(init1(xs_t), PIT_DELTA, noise=noise_t), 3)
        if dt == torch.float64:
            gap = same_state("time-sharded PIT (f64)", a, b, MESH_PIT_X_ATOL)
            what = f"updated identical, x within {gap:.3g}"
        else:
            same = float((a.updated == b.updated).double().mean())
            what = f"a share {same:.4f} of `updated` equal to the one-device step's (not held)"
        add_launches(launches, got)
        log(f"  time-sharded PIT, C={MESH_SHARDS}, Tc={PIT_T // MESH_SHARDS}, {str(dt)[6:]}: "
            f"{what}; launches {got}; step {ms:.3f} ms, one device {ms1:.3f} ms, on {card}")
    return entry


def flagship_scan_inputs(dev, dtype):
    """The filtering elements and backward maps of one flagship MH step (T,
    DX; phase 1's model)."""
    import torch
    from aux_ssm_tpu_torch.models import lgssm_flagship
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.ops.filtering import _make_associative_elements
    from aux_ssm_tpu_torch.ops.sampling import _backward_maps
    gen = torch.Generator(device=dev).manual_seed(35)
    dyn, obs1, _ = lgssm_flagship.build_model(T, DX, device=dev, dtype=dtype)
    x = torch.zeros(T, DX, dtype=dtype, device=dev)
    u = x + (0.5 * DELTA) ** 0.5 * torch.randn(T, DX, generator=gen, dtype=dtype, device=dev)
    steps, m0u, P0u = mh_inputs(dyn, obs1, x, u, DELTA)
    elems = _make_associative_elements(*steps, m0u, P0u)
    _, ms, Ps, _, _ = FS.filter_scan(elems)
    ms, Ps = torch.cat([m0u[None], ms]), torch.cat([P0u[None], Ps])
    eps = torch.randn(T, DX, generator=gen, dtype=dtype, device=dev)
    return elems, _backward_maps(eps, ms, Ps, *steps[:3])


def mesh_scans(dev, devices, card, launches):
    """Phase 35's time scans: the flagship step's elements over a `time`
    mesh, f32 and f64, against the one-device scan kernels (norm-relative,
    MESH_SCAN_NREL)."""
    import torch
    from aux_ssm_tpu_torch.ops.cuda import filter_scan as FS
    from aux_ssm_tpu_torch.parallel import time_scan as ts
    from aux_ssm_tpu_torch.parallel.mesh import make_mesh
    tmesh = make_mesh(devices=devices, axis_names=(ts.TIME,))
    for dt in (torch.float32, torch.float64):
        elems, (gains, incs) = flagship_scan_inputs(dev, dt)
        for name, sharded, one in (
                ("filter", lambda: ts.sharded_filtering_scan(tmesh, elems),
                 lambda: FS.filter_scan(elems)),
                ("affine", lambda: ts.sharded_sampling_scan(tmesh, (gains, incs)),
                 lambda: FS.affine_scan(gains, incs, True))):
            got, counts = mesh_launches(sharded)
            err = max(nrel(g, w) for g, w in zip(got, one()))
            bound_ = MESH_SCAN_NREL[str(dt)[6:]]
            if not err <= bound_:
                raise AssertionError(f"time-sharded {name} scan ({dt}): nrel {err:.3g} > {bound_:g}")
            add_launches(launches, counts)
            log(f"  time-sharded {name} scan, T={T} dx={DX} {str(dt)[6:]}, S={MESH_SHARDS}: nrel "
                f"{err:.3g} against the one-device scan; launches {counts}; "
                f"{cuda_ms(sharded, 5):.3f} ms, one device {cuda_ms(one, 5):.3f} ms, on {card}")


def mesh_chains(dev, devices, card, launches):
    """Phase 35's chains mesh: SV kalman-1 (T=SV_T, D=SV_D) at C =
    MESH_CHAINS through `cli.run_maybe_sharded` with a device list, f32,
    MESH_SCHEDULE iterations from the simulated states. One shard: bit for
    bit the run without a mesh. MESH_SHARDS shards: each shard's chains bit
    for bit a one-process batched run of its chains with its shard
    generator."""
    import argparse
    import torch
    from aux_ssm_tpu_torch.experiments import cli
    from aux_ssm_tpu_torch.experiments.runner import RunConfig
    from aux_ssm_tpu_torch.models import stochastic_volatility as sv
    from aux_ssm_tpu_torch.parallel.chains import shard_seed
    xs, ys = sv.get_data(*SV_PARAMS, SV_D, SV_T, generator=torch.Generator().manual_seed(35),
                         dtype=torch.float32, device=dev)
    init, kernel = sv.get_kalman_kernel(ys, *SV_PARAMS, True, 1, chains=True)
    cfg = RunConfig(burnin=MESH_SCHEDULE[0], n_samples=MESH_SCHEDULE[1], delta_init=0.0441)
    state = sv.get_kalman_kernel(ys, *SV_PARAMS, True, 1)[0](xs)

    def run(n_chains, devices_, seed):
        args = argparse.Namespace(n_chains=n_chains, mesh_chains=0, checkpoint_dir=None,
                                  checkpoint_every=0)
        return cli.run_maybe_sharded(
            torch.Generator(device=dev).manual_seed(seed), kernel, state, cfg, args,
            collect_samples=True, devices=devices_,
            kernel_for=lambda shard, d: sv.get_kalman_kernel(ys.to(d), *SV_PARAMS, True, 1,
                                                             chains=True)[1])[0]

    def same(label, a, b):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"chains mesh: {label}")

    def key(res, sl=slice(None)):
        return res.state.x[sl], res.delta[sl]

    tic = time.perf_counter()
    plain = run(MESH_CHAINS, None, 35)
    t_plain = time.perf_counter() - tic
    one = run(MESH_CHAINS, devices[:1], 35)
    same("one shard differs from the run without a mesh", key(one), key(plain))
    tic = time.perf_counter()
    meshed, got = mesh_launches(lambda: run(MESH_CHAINS, devices, 35))
    t_mesh = time.perf_counter() - tic
    n = MESH_CHAINS // MESH_SHARDS
    for s in range(MESH_SHARDS):
        alone = run(n, None, shard_seed(35, s))
        same(f"shard {s} differs from a batched run of its {n} chains", key(meshed, slice(
            s * n, (s + 1) * n)), key(alone))
    add_launches(launches, got)
    rate = float(meshed.stats.accept_cum.mean())
    log(f"  chains mesh, SV kalman-1 T={SV_T} D={SV_D}, C={MESH_CHAINS} over {MESH_SHARDS} "
        f"shards, {sum(MESH_SCHEDULE)} iterations: one shard bit-equal to the run without a "
        f"mesh, each of the {MESH_SHARDS} shards bit-equal to a batched run of its {n} chains "
        f"with its generator; update rate {rate:.3f}; launches {got}; {t_mesh:.2f} s "
        f"({t_plain:.2f} s without a mesh), on {card}")


def mesh_batch(dev, devices, card, launches):
    """Phase 35's batch sharding: spatial kalman-1 steps (T=SP_T, SP_D x
    SP_D, f32) from the simulated states with the components over a `batch`
    mesh, against the unsharded step on the same noise: one with u = 0
    (accepted either way: the proposals compared) and one with a drawn u;
    the same accept, x within MESH_BATCH_NREL (norm-relative)."""
    import torch
    from aux_ssm_tpu_torch.parallel.batch import batch_sharded_kernel
    from aux_ssm_tpu_torch.parallel.mesh import BATCH, make_mesh
    xs, ys = spatial_data(dev, torch.float32)
    init, kernel = spatial_kernel("kalman-1", ys, SP_D, SP_N)
    sharded = batch_sharded_kernel(kernel, make_mesh(devices=devices, axis_names=(BATCH,)))
    state = init(xs)
    gen = torch.Generator(device=dev).manual_seed(35)
    eps = [torch.randn(state.x.shape, generator=gen, device=dev) for _ in range(2)]
    # u = 0 accepts whatever the ratio: the states are the two proposals.
    for u, what in ((torch.zeros((), device=dev), "the proposal"),
                    (torch.rand((), generator=gen, device=dev), "the step")):
        noise = (eps[0], eps[1], u)
        b, got = mesh_launches(lambda: sharded(state, MESH_BATCH_DELTA, noise=noise))
        a = kernel(state, MESH_BATCH_DELTA, noise=noise)
        if bool(a.updated) != bool(b.updated):
            raise AssertionError(f"batch-sharded spatial {what}: the accept differs")
        err = nrel(b.x, a.x)
        if not err <= MESH_BATCH_NREL:
            raise AssertionError(f"batch-sharded spatial {what}: x nrel {err:.3g} > "
                                 f"{MESH_BATCH_NREL:g}")
        add_launches(launches, got)
        log(f"  batch-sharded spatial kalman-1, {what}, T={SP_T} {SP_D}x{SP_D} (B={SP_D * SP_D}) "
            f"over {MESH_SHARDS} shards, delta {MESH_BATCH_DELTA:g}: accept {bool(a.updated)} in "
            f"both, x nrel {err:.3g}; launches {got}")
    log(f"  the step {cuda_ms(lambda: sharded(state, MESH_BATCH_DELTA, noise=noise), 5):.3f} ms,"
        f" unsharded {cuda_ms(lambda: kernel(state, MESH_BATCH_DELTA, noise=noise), 5):.3f} ms, "
        f"on {card}")


def mesh_processes(card, out_dir):
    """Phase 35's multi-process run: one process a card, 2 shards each,
    joined over NCCL (`experiments.multichip.run_processes`), each running
    `dryrun_multichip` with a timeout of its own; every check must hold in
    every process, and their particle-sharded PIT step must equal the
    one-process dry run's over the same shards."""
    import torch
    from aux_ssm_tpu_torch.experiments import multichip
    n = torch.cuda.device_count()
    tic = time.perf_counter()
    results = multichip.run_processes(n, lambda r: [f"cuda:{r}"] * 2, out_dir,
                                      timeout_s=MESH_PROC_TIMEOUT)
    wall = time.perf_counter() - tic
    one = multichip.dryrun_multichip([f"cuda:{r}" for r in range(n) for _ in range(2)])
    for r, res in enumerate(results):
        got = res["result"]
        bad = [k for k, ok in (("chains", got["chains"]),
                               ("csmc", all(got["csmc"].values())),
                               ("time_scan", max(got["time_scan"].values()) < 1e-12),
                               ("batch", got["batch"]["same_accept"]),
                               *((k, got["pit"][k]) for k in (
                                   "time_sharded", "particle_sharded_joint",
                                   "particle_sharded_fused"))) if not ok]
        if bad:
            raise AssertionError(f"multi-process rank {r}: checks failed: {bad}: {got}")
        if got["pit"]["particle_step"] != one["pit"]["particle_step"]:
            raise AssertionError(f"multi-process rank {r}: the particle-sharded step differs "
                                 "from the one-process run's")
    init = [round(r["init_s"], 3) for r in results]
    first = [None if r["first_collective_s"] is None else round(r["first_collective_s"], 3)
             for r in results]
    log(f"  multi-process: {n} process(es) over NCCL, 2 shards each: every dry-run check holds "
        f"and the particle-sharded step equals the one-process run's; process group set up in "
        f"{init} s, first NCCL all_reduce {first} s, {wall:.1f} s in all with the processes' "
        f"start, on {card}")


def phase_mesh(dev, card, out_dir):
    """Phase 35: the multi-device layer over MESH_SHARDS shards of the cards
    there are (one card: MESH_SHARDS shards on it). Returns (the kernel
    launches of its sharded runs by wrapper, those of the chains mesh's run,
    which are chain instances, and the per-shard block_masses entry)."""
    import torch
    devices = mesh_devices()
    tic = time.perf_counter()
    log(f"phase 35: meshes of {MESH_SHARDS} shards over {torch.cuda.device_count()} card(s): "
        f"{devices}")
    launches, chain_launches = {}, {}
    entry = mesh_pit(dev, devices, card, launches)
    mesh_scans(dev, devices, card, launches)
    mesh_chains(dev, devices, card, chain_launches)
    mesh_batch(dev, devices, card, launches)
    mesh_processes(card, out_dir)
    log(f"  phase 35 took {time.perf_counter() - tic:.1f} s; its sharded runs' launches "
        f"{launches}, the chains mesh's (chain instances) {chain_launches}")
    return launches, chain_launches, entry


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from aux_ssm_tpu_torch.ops.cuda._build import LIBRARY

    dev = torch.device("cuda")
    tic = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    LIBRARY.get()
    ends = {k: round(v, 1) for k, v in LIBRARY.source_seconds.items()}
    log(f"phase 0: kernels built in {LIBRARY.build_seconds:.1f} s into {LIBRARY.build_dir} "
        f"(each source's nvcc ended at {ends} s)")
    log("phase 29, its kernel checks first: the chain-axis instances at M=800 (f64)")
    chain_results = phase_chain_kernels(dev)
    dense_results = phase_dense_chain_kernels(dev)
    wide48, wide48_launches = phase_wide48(dev, card)
    csmc_chain_results = phase_block_lane_chains(dev)
    draw_chain_results = phase_draw_chains(dev)
    log(f"  phases 0, 29's, 30's, 36, 32's and 33's kernel checks took "
        f"{time.perf_counter() - tic:.1f} s")

    results = phase_kernels(dev)
    phase_step_reference(dev)

    log(f"phase 2: second-order chain, T={T}, dx={DX}, f32, delta={DELTA}")
    _, acc2, _, launches = run_chain(dev, order=2, n_steps=50, seed=2)
    if not acc2 >= 0.99:
        raise AssertionError(f"order 2: acceptance {acc2} below 0.99")

    log(f"phase 3: first-order chain, T={T}, dx={DX}, f32, delta={DELTA}")
    _, acc1, _, _ = run_chain(dev, order=1, n_steps=100, seed=3)
    if not 0.0 < acc1 <= 1.0:
        raise AssertionError(f"order 1: acceptance {acc1} outside (0, 1]")

    results.update(phase_csmc_kernels(dev))
    log("phase 5: f64 aux-cSMC steps, card vs CPU")
    phase_csmc_step_reference(dev)
    launches.update(phase_sv_chains(dev))
    log(f"  phases 0-7 took {time.perf_counter() - tic:.1f} s")

    results["lane_scan"] = phase_lane_kernel(dev)
    log("phase 9: f64 scalar-state particle-Gibbs steps, card vs CPU")
    phase_scalar_step_reference(dev)
    theta_one, theta_chained = phase_theta_chain(dev, card)
    launches["lane_scan"] = theta_one["lane_scan"]
    log(f"  phases 0-11 took {time.perf_counter() - tic:.1f} s")

    results.update(phase_scalar_scans(dev))
    spatial_sweeps = phase_spatial_sweeps(dev)
    # One entry a kernel: SV's numbers stay at the top level, those at the
    # spatial model's shapes beside them.
    at = f"T={SP_T}, d=k={SP_D * SP_D}, N={SP_N}"
    results["block_lane_scan"]["functors"] = {
        "SvGuided": f"T={SV_T}, d={SV_D}, N={SV_N}: the entry's own numbers",
        "SpatialGuided": {f"{at}, {style}": entry
                          for style, entry in spatial_sweeps["block_lane_scan"].items()}}
    for name in ("forward_factor_scan", "backward_factor_scan"):
        results[name]["spatial"] = {f"{at}, {style}": entry
                                    for style, entry in spatial_sweeps[name].items()}
    log("phase 14: f64 spatial steps, card vs CPU")
    phase_spatial_step_reference(dev)
    one_chain, pair_launches = phase_spatial_chains(dev)
    for name, count in one_chain.items():
        launches[name] = launches.get(name, 0) + count

    log(f"  phases 0-15 took {time.perf_counter() - tic:.1f} s")
    results.update(phase_stitch_kernels(dev))
    log("phase 17: f64 PIT steps, card vs CPU")
    phase_pit_step_reference(dev)
    log(f"  phases 0-17 took {time.perf_counter() - tic:.1f} s")
    pit_one, pit_chained = phase_pit_chains(dev, card)
    for name, count in pit_one.items():
        launches[name] = count
    log(f"  phases 0-18 took {time.perf_counter() - tic:.1f} s")
    for name, count in phase_pit_rare(dev).items():
        launches[name] += count
    log(f"  phases 0-19 took {time.perf_counter() - tic:.1f} s")
    wide = phase_wide_kernels(dev)
    log("phase 21: f64 SV kalman steps, card vs CPU")
    phase_sv_kalman_steps(dev)
    results["block_lane_scan"]["functors"]["SpatialGuided"][
        f"T={SP_T}, d={WIDE_SP_SIDE ** 2}, N={SP_N}, csmc-guided-grad: components in shared "
        "memory"] = phase_wide_routes(dev)
    wide_launches = phase_sv_kalman_chains(dev, card)
    log(f"  phases 0-22 took {time.perf_counter() - tic:.1f} s")
    lorenz = phase_lorenz_kernels(dev)
    log("phase 24: f64 Lorenz Gibbs steps, card vs CPU")
    phase_lorenz_steps(dev)
    with tempfile.TemporaryDirectory() as tmp:
        lorenz_launches = phase_lorenz_chain(dev, card)
        t25 = time.perf_counter()
        log(f"  phases 0-25 took {t25 - tic:.1f} s")
        sv_driver, sv_chained = phase_sv_driver(dev, card, tmp)
        spatial_driver, sp_chained = phase_spatial_driver(dev, card, tmp)
        phase_dnc_sampling(dev, card)
        t28 = time.perf_counter()
        log(f"  phases 26-28 took {t28 - t25:.1f} s, phases 0-28 {t28 - tic:.1f} s")
        chain_launches = phase_grid(dev, card)
        t29 = time.perf_counter()
        log(f"  phase 29 took {t29 - t28:.1f} s")
        dense_launches = phase_dense_chain_drivers(dev, card, tmp)
    for name, count in (sv_driver | spatial_driver).items():
        if name in KERNELS:
            wide_launches[name] += count
        else:
            launches[name] = launches.get(name, 0) + count
    log(f"  phase 31 took {time.perf_counter() - t29:.1f} s, phases 0-31 "
        f"{time.perf_counter() - tic:.1f} s with the build, on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        mesh_runs, mesh_chain_runs, per_shard = phase_mesh(dev, card, tmp)
    for name, count in mesh_runs.items():
        launches[name] = launches.get(name, 0) + count
    for name, count in mesh_chain_runs.items():
        dense_launches[name] = dense_launches.get(name, 0) + count
    results["block_masses"]["per_shard"] = per_shard
    log(f"  phases 0-35 took {time.perf_counter() - tic:.1f} s with the build, on {card}")

    sources = ({name: entry[:2] for name, entry in KERNELS.items()} | CSMC_KERNELS
               | SCALAR_KERNELS | STITCH_KERNELS)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in sources.items()]
    kernels += [{"name": f"{name}_d32", "route": "cuda", "source": src, "replaces": rep,
                 "launches": wide_launches[name], **wide[name]}
                for name, (src, rep, _) in KERNELS.items()]
    kernels += [{"name": f"{name}_d48", "route": "cuda", "source": src, "replaces": rep,
                 "launches": wide48_launches[name], **wide48[name]}
                for name, (src, rep, _) in KERNELS.items()]
    kernels += [{"name": f"{name}_lorenz", "route": "cuda", "source": src, "replaces": rep,
                 "launches": lorenz_launches[name], **lorenz[name]}
                for name, (src, rep, _) in KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": chain_launches[name], **chain_results[name]}
                for name, (_, src, rep) in CHAIN_KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": dense_launches[one], **dense_results[one]}
                for name, (one, src, rep) in DENSE_KERNELS.items()]
    # The C > 1 driver runs of phases 26-27: the block-lane sweep's chain
    # instance at each shape, the scalar scans at C B columns; their factor
    # sweeps and col_sample launches count on the chain instances of phase 29.
    # Phase 15's pair (two chains a batched step) counts on them too.
    spatial_runs = (*sp_chained.values(), pair_launches)
    csmc_launches = {"block_lane_scan_chains": sv_chained["csmc-guided"]["block_lane_scan"],
                     "block_lane_scan_spatial_chains":
                         sum(run.get("block_lane_scan", 0) for run in spatial_runs),
                     **{f"{name}_chains": sum(run.get(name, 0) for run in spatial_runs)
                        for name in ("scalar_filter_scan", "scalar_affine_scan")}}
    kernels += [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": csmc_launches[name], **csmc_chain_results[name]}
                for name, (_, src, rep) in CSMC_CHAIN_KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": pit_chained[one], **draw_chain_results[name]}
                for name, (one, src, rep) in DRAW_CHAIN_KERNELS.items()]
    for entry in kernels:
        if entry["name"] in ("forward_factor_scan_chains", "backward_factor_scan_chains",
                             "col_sample_chains"):
            one = entry["name"].removesuffix("_chains")
            entry["launches"] += sum(run.get(one, 0) for run in (*sv_chained.values(),
                                                                 *spatial_runs))
        if entry["name"] == "lane_scan_chains":
            entry["launches"] += theta_chained["lane_scan"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
