#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyro_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device and build: the card's name and power limit, and the CUDA
     kernels (``log_matmul.cu``, ``log_chain.cu``, ``markov_scan.cu``,
     ``gaussian_levels.cu``) built from ``pyro_tpu_torch/csrc`` with one
     nvcc each, started together;
  2. K1, log-matmul-exp forward and backward, against its plain PyTorch
     version on the card at the main path's shape (strided halves, never
     copied by the wrapper) and at ragged others; at the main path's shape
     with a quarter of the columns unreachable from half the rows' support
     (z clipped at FLT_MIN), the gradients against the float64 direct
     form; timed at the main path's shape beside the plain version,
     ``torch.matmul`` (the product alone) and two bounds, on the tensor
     cores (3xTF32) and on the f32 CUDA cores;
  3. slice 1 at full width: model_7 of ``examples/hmm.py`` (B=32
     sequences, T=128, D=51 tones, S=256 states) trained for 5 SVI steps
     with AutoDelta, Trace_ELBO and Adam, counting kernel launches and
     operand copies, and one profiled step with K1's (K3's) device time
     beside K3's bound;
  4. K2, the Markov-chain scan, forward and the gradients of all its
     inputs, against its plain PyTorch version (a loop of plain
     log-matmul-exp steps), on the cluster route (the wrapper's choice at
     every case here) at the main path's shape (B=32, T=127, S=256,
     emissions about -35 per step), a ragged small shape with L, one A
     per row, A with -inf entries and a -inf column, and a row of alpha0
     all -inf; the streaming route, forced, at the main path's shape and
     the two ragged ones, and chosen at B=2, T'=4, S=1024; at the main
     path's shape with a quarter of the states unreachable at the first
     step (z clipped at FLT_MIN), on five seeds of such data, each
     gradient of either route against the float64 plain version; the first sequence's forward against a
     float64 filter; both routes timed forward and backward in turns with
     the plain version at S=256 and S=512 (B=32, T'=127), beside the
     bound, the cluster route at each cluster size and rows per cluster
     that fit, beside the clusters the card runs at once, and a loop of
     127 K1 forward launches (the route without K2);
  5. slice 2 at full width: model_1v of ``examples/hmm.py`` (the same
     shape, ``vectorized_markov``) trained for 5 SVI steps with AutoDelta,
     ``TraceEnum_ELBO(max_plate_nesting=3)`` and Adam: the step-0 ELBO
     through K2 against the same ELBO through the plain scan, finite
     losses, exactly 5 K2 forward and 5 K2 backward launches, all on the
     cluster route, and no K1 launch, and one profiled step;
  6. slice 5, the VAE of ``examples/vae.py`` at full width (B=256,
     X=784, H=400, Z=50) with Trace_ELBO and Adam: the first step's loss
     and gradients on the card against the port's own CPU run at the same
     weights, data and guide noise, then 200 SVI steps (finite losses, the
     last 20 below the first 20 on average), the steady step time, and one
     profiled step with its device operations and busy share;
  7. slice 5, NUTS on eight schools through ``MCMC`` with 1024 chains: a
     probe of the first warmup iterations sets the iteration counts (500
     warmup and 500 samples, cut toward 90 s but never below 200 and 200,
     and the cut printed); posterior means of mu and tau within 4 Monte
     Carlo standard errors plus 0.01 of the quadrature values, split r_hat
     under 1.05, the mean accept probability after warmup in [0.6, 0.95],
     no NaN; the wall times, ESS per second, leapfrog passes per second,
     host syncs per pass, one profiled iteration (device operations per
     pass, busy share), and the synchronizing calls of one iteration under
     torch's sync debug mode, at most one a pass;
  8. K4, the Gaussian halving levels (``gaussian_levels.cu``: K4a
     halving, K4b contract, K4c mids), against their plain versions at
     every level of the slice's calls (the level inputs recorded from one
     call through the kernels): the homogeneous ``log_prob`` at
     ``8.10000.32.4`` for K4a, the heterogeneous ``rsample_posterior`` with
     64 draws at ``64.4000.16.4`` for K4b (with its tape) and K4c; each
     kernel's levels timed against the plain version's in turns, beside
     the bound of the same levels (a stride-0 input's bytes counted once),
     with the profiler's device ms beside the CUDA events, K4a's and K4c's
     also level by level; K4c's two launches at every level bitwise equal;
     K4b over
     the n-sweep (n 1, 2, 5, 16, 17, 31, 32; t 2, 3, odd, 4000; up to 8
     rows; P contiguous, sliced or expanded with stride 0) against its
     plain version and the float64 plain version, two launches bitwise
     equal;
  9. slice 6 through ``examples/gaussian_hmm.py``'s models at full width
     (numpy, seed 0): the homogeneous ``GaussianHMM.log_prob`` (B=8,
     T=10,000, hidden 32, obs 4), 10 chained calls as ``bench.py`` chains
     them, three reps, sequences/s; the heterogeneous ``log_prob`` (T=4000,
     hidden 16, a transition per step) and ``rsample_posterior`` with 64
     draws, three reps, draws/s; each log_prob against the port's plain
     levels in float64 on the card; the posterior mean (the samplers at
     zero noise, heterogeneous and homogeneous) against float64, and the
     64 draws' mean against it in standard errors; a homogeneous
     ``rsample_posterior`` of 4 draws; the K4 launches of every call
     (each kernel above 0 over the phase) and one profiled call of each
     entry point with its device busy share;
  10. the K4a and K4b backward kernels (``gaussian_levels.cu``: K4a's
     ``gl_halving_bwd_kernel``, one launch a level; K4b's contract
     backward) against their plain backward versions at every level of one
     training step's backward at full width (the levels' tapes and
     upstream gradients recorded from a step of each path of phase 11
     through the kernels, one launch counted a level), P gradients
     symmetrised; each backward run twice on the same inputs, bitwise
     equal; each kernel's levels timed against the plain version's in
     turns, beside the bound of the same levels, with the profiler's
     device ms over the step's levels and level by level;
  11. slice 7, SVI through K4 at full width, 5 steps each through the
     entry points (``make_train_svi``: Trace_ELBO with the empty guide and
     Adam, lr 0.01): ``lgssm`` (``examples/lgssm.py``: GenericLGSSM, obs 4,
     state 16, on the T=4000 series; K4b) and the homogeneous ``--train``
     model of ``examples/gaussian_hmm.py`` at ``8.10000.32.4`` (K4a): the
     first step's loss and the gradient of every parameter against the
     same step through the plain levels in float64 on the card; finite
     losses; the K4 forward and backward kernels launched in every step;
     the set-up (first step) and steady step times, and one profiled step
     with its device busy share and top device operations;
  12. K2g, the time-varying Markov scan (``markov_scan.cu``: the cluster
     route's ``mstvc_*`` kernels and the streaming route's ``mstv_*``),
     forward and the gradients of all its inputs against its plain version
     in float64 on the card (and in float32, printed), on both routes: at
     model_1vt's shape (B=32, T'=127, S=256, A_t shared, emissions about
     -35 a step; the cluster route the wrapper's choice there), one A_t
     per row (B=8, T'=63, S=64), odd S (7 with L, 257 with one A_t per
     row), T'=1 with L, on five seeds of data with -inf entries, columns no
     state reaches and -inf states of alpha0 (-inf values exactly where
     float64 has them, no NaN), and on data where hs and A_t peak at
     different l (the cluster route's factored sum 0 at half of the
     columns, recomputed exactly); the backward twice on each route,
     bitwise equal; forward and backward of both routes and the plain
     version timed in turns beside the bound;
  13. slice 8 at full width: model_1vt of ``examples/hmm.py`` (model_1v
     with a transition matrix per step, ``probs_x`` (128, 256, 256)) at
     ``32.128.51.256`` with AutoDelta, ``TraceEnum_ELBO(max_plate_nesting=3)``
     and Adam: the first step's loss and gradients through K2g against the
     plain loop in float64 on the card; 5 SVI steps, each with exactly one
     K2g launch each way, on the cluster route, and no K2 or K1 launch,
     finite falling losses, set-up and steady ms, one profiled step with
     K2g's device ms;
  14. the ten chain cases of ``tests/test_vectorized_markov.py``
     (``examples/vectorized_markov.py``) on the card through the route each
     takes (K2, K2g, or the pairwise fallback, whose windows of at most 64
     states take K3f), loss and
     gradients against the port's float64 CPU run; model_5 (history 2) at
     x_dim 16, T=128, 51 tones (windows of 256 states, K1 at (63, 256, 256)
     in the first round): the first step against float64 on the CPU, 3 SVI
     steps with their K1 launches, one profiled step; model_1 (unrolled
     under ``pyro.markov``) at ``20.32.51.16``: its step-0 loss against
     model_1v's at the same params, 3 SVI steps with their launch counts,
     one profiled step;
  15. K5a and K5b, the gamma-Gaussian halving levels (``gaussian_levels.cu``'s
     ``gl_halving_kernel<true>`` and ``gl_contract_kernel<true>``), against
     their plain versions at every level of slice 9's calls (recorded from
     one call each through the kernels): the homogeneous
     ``GammaGaussianHMM.log_prob`` at ``8.10000.32.4`` (K5a, 13 levels), the
     heterogeneous one at ``8.4000.16.4`` (K5b, 12 levels) and the
     homogeneous ``filter`` (K5b at n=32 over the expanded chain, 14
     levels, the chain's precision read in place with stride 0); alpha'
     exactly, every output against the float64 plain version (both
     distances printed); each kernel's levels timed against the plain
     version's in turns, beside the bound of the same levels, each with
     the profiler's device ms beside the CUDA events, K5a's also level by
     level; K5b over phase 8's n-sweep as K4b;
  16. slice 9 through ``examples/gamma_gaussian_hmm.py``'s models at full
     width (numpy, seed 0; Student-t noise through a shared Gamma(2, 2)
     scale): ``GammaGaussianHMM.log_prob`` at ``8.10000.32.4`` (13 K5a
     launches a call) and ``8.4000.16.4`` (12 K5b), 10 chained calls, three
     reps, sequences/s, each against the float64 plain levels on the card
     (and the float32 plain levels beside it); ``filter`` at
     ``8.10000.32.4`` (14 K5b) against float64; one profiled call of each;
     then through K4 at ``8.10000.32.4``, each against float64 and with its
     launch counts: ``IndependentHMM`` (4 channels of hidden 32, obs 1, each
     with its own parameters, against the sum of its channels' GaussianHMMs),
     ``GaussianMRF`` (MVN factors of dims 32, 64 and 36),
     ``GaussianHMM.conjugate_update`` (a Normal likelihood; the identity
     f + g = fg + log Z in float32 and float64) and ``prefix_condition`` at
     t=8000 (the chain rule in float64);
  17. slice 15, the deep Markov model of ``examples/dmm.py`` at the bench
     row's widths, ``20.129.88.100.200.100.rnn600`` (B=20 sequences, T=129,
     88 tones, z 100, transition 200, emission 100, a backward relu RNN of
     600), data from ``synthetic_data`` with seed 0, Trace_ELBO and
     ClippedAdam (lr 3e-3, clip_norm 10), no IAF: the first step's loss
     and gradients on the card against the port's own CPU run at the same
     weights, data and guide noise; 23 SVI steps (finite losses, the last
     five below the first five), every parameter, buffer, optimiser state
     and sampled value on the card; the steady step time over 20 steps
     (host clock and synchronize) and one profiled step (device
     operations, busy share, the five largest device items); two steps
     with two IAFs in the guide, every tensor on the card.  The DMM
     reaches none of the kernels below;
  18. slice 16, the discrete posterior queries on model_1 (``pyro.markov``)
     at ``20.32.51.16`` (``synthetic_sequences`` seed 0), its AutoDelta
     parameters from 3 Adam steps on the card, copied into a CPU run of the
     port: ``TraceEnum_ELBO.compute_marginals`` (K1 forward and backward,
     counted), one marginal per sequence for every x_t, against a float64
     CPU run (the CPU's float32 run beside); ``infer_discrete`` at
     temperature 0 (the MAP path's joint log density against the float64
     CPU run's, its indices equal wherever that run's best path leads the
     card's by more than 1e-3) and at temperature 1 (K1
     forward counted; 256 draws' state frequencies against the card's
     marginals); ``ubersum`` at ``examples/einsum.py``'s equation, dim 32,
     plate size 32, the value against the CPU run and the gradient against
     a float64 one; a sequential
     Bernoulli guide site (loss and gradients against the CPU run and
     parallel enumeration) and a model site with ``num_samples=8`` (finite
     losses, the mean over 200 generators against the CPU run's); ms a call
     of each query (``ubersum`` at plate sizes 8-32), and one profiled call
     of ``compute_marginals`` and of ``infer_discrete`` with its busy share
     and K1's device ms;
  19. slice 17, the Gaussian-process time series through K4 (the card's
     name and power limit on the phase's first line): ``examples/timeseries_gp.py``
     at its widths (obs 2, T=80, nu 1.5, imgp and lcmgp), 300 SVI steps on
     the card (finite losses, the last below the first, K4b launched) against
     the port's CPU run of the same steps from the same parameters (the last
     loss and the one-step forecast); the four models at the EEG shape
     (14 channels, 14,980 steps, numpy seed 0): IndependentMaternGP (n=2,
     K4b over 14 channels with stride 0 over time), LinearlyCoupledMaternGP
     with 4 GPs (n=8, K4b), DependentMaternGP (n=28, K4a) and
     GenericLGSSMWithGPNoiseModel with a z-state of 4 (n=32, K4a): ``log_prob``
     with its K4 launches counted, and the first step's loss and gradients,
     against float64 through the plain levels on the card (the smallest
     Cholesky pivot of the initial and transition covariances printed), 5
     SVI steps with their launches, ms a step over 20 steps after a
     warm-up, one profiled step (device operations, busy share, K4 device
     ms); a DependentMaternGP draw of 14,980 steps through K4c, channels 0
     and 1 correlated through the Wiener factor and then not; the six
     Normal-family guides (AutoNormal, AutoDiagonalNormal,
     AutoMultivariateNormal, AutoLowRankMultivariateNormal, AutoIAFNormal,
     Parameterized's "Normal") on IndependentMaternGP at the EEG shape with
     Gamma(2, 2) priors on its length and kernel scales, 10 steps each:
     finite losses, K4b launched each way, every parameter and draw on the
     card, -ELBO at one latent value against the port's CPU run, ``median``
     and ``quantiles`` on the card;
  20. slice 18, NUTS through the kernels (the card's name and power limit
     on the phase's first line): model_1 at ``20.32.51.16``
     (``synthetic_sequences`` seed 0), its hidden states summed out of the
     MCMC potential: the vmapped potential and gradient of 8 chains at
     fixed unconstrained points (numpy seed 0) against the port's CPU run
     in float64 (and in float32, the rounding reference), exactly 9 K1
     launches each way, each against the plain version at its folded
     operands; NUTS with 8 chains (``max_tree_depth`` 6, printed as a cut;
     a probe and the time of a full-depth tree set the iteration counts
     toward 60 s), the leaf captured, finite draws on their supports, ESS
     and split r_hat, iterations/s, ESS/s, a replayed leaf's ms beside one
     eager potential-and-gradient call, one profiled replay (busy share,
     K1's device ms and launches by kernel name: 9 forward and 9 backward),
     the graphed leaf against the eager leaf over a depth-3 subtree; then
     model_1v (the chain under ``vectorized_markov``) through K2 the same
     way (its potential against float64, one K2 launch each way, each
     against the plain scan at the folded rows, 2 + 2 NUTS iterations with
     the leaf captured); and ``vmap(grad(GaussianHMM.log_prob))`` at the
     ``lgssm`` shape over 4 chains' parameters through K4b against the
     plain levels in float64 on the card;
  21. slice 19, forecasting through K4 (the card's name and power limit on
     the phase's first line), ``examples/forecast_bart.py``'s ``Model``
     (weekly seasonality and a GaussianHMM local level, whose noises'
     batch dim of 1 sends ``log_prob`` down the K4b route): (a) the JAX
     example as it stands, ``load_fake_od`` (744 hours, t_train 595):
     ``Forecaster`` with 500 DCTAdam steps (lr 0.05), a forecast call of
     100 draws over the 149 held-out hours, the MAE; (b) the same Model at
     the length of upstream's BART counts (78,888 hours of a synthetic
     total ridership, numpy seed 0, trained up to two weeks before the
     end): a warm-up ``Forecaster`` step, 20 timed SVI steps, a forecast
     call of 100 draws; (c) ``HMCForecaster`` on (a)'s model and data with
     ``time_reparam="dct"``, 4 vectorized chains (``max_tree_depth`` 6, the
     iteration counts cut by a probe toward 60 s, both printed as cuts),
     NUTS's ``vmap(grad)`` through K4b inside the captured leaf, then a
     forecast call of 100 draws.  For each: the K4 launches by kernel a
     step, a forecast draw and a leaf (the profiler's record of a replayed
     leaf), forward and backward; every K4 level recorded from a training
     step and a forecast draw against its plain version; the first step's
     -ELBO at one latent value and its gradients (the guide's parameters,
     and the log joint's in the latents), or the potential and gradient of
     the chains at fixed points, against float64 through the plain levels
     on the card; (a)'s forecast moments at the guide's median against the
     exact conditional of the local level (dense, float64); ms a step and
     a forecast call (host clock, synced) and the busy share of one
     profiled step or replayed leaf;
  22. slice 20, epidemiology through K3f (``log_chain.cu``; the card's
     name and power limit on the phase's first line):
     ``CompartmentalModel.fit_mcmc(num_quant_bins=4)``, 4 chains, on (a)
     ``examples/sir_hmc.py``'s data at its defaults (SIR, 16 enumerated
     states, T=20), (b) ``SimpleSEIRModel`` at population 1000 over 60
     days (64 states; data from the model's own prior at R0 2, response
     rate 0.5, the first seed of 0, 1, ... with at least 30 observed
     infections) and (c) ``examples/epidemiology_regional.py``'s defaults
     (3 regions, 16 states, T=16: K3f over chains x regions rows), each
     with NUTS at ``max_tree_depth`` 6, 100 + 100 iterations and a relaxed
     SVI start of 200 steps (the cuts printed); for each, K3f's launches
     in one vmapped potential-and-gradient call and in one profiled
     replayed leaf (one each way), every K3f call of that vmapped call
     against ``sequential_logmatmulexp_plain``, the potential and gradient
     at the run's last state against the port's float64 CPU run, ms a
     replayed leaf, leaves an iteration, iterations/s, the leaf's busy
     share and K3f's device ms, ms an SVI step of the start, the posterior
     median of R0, and K3f timed at the run's shape in turns with K1's
     rounds and the plain version, beside its bound; (a)'s R0 median
     against a relaxed NUTS fit's; (d) ``examples/epidemiology_sir.py`` at
     its defaults with 300 SVI steps, then ``predict(forecast=10)``, which
     reach no kernel;
  23. a ``kernels`` JSON line (K1 forward and backward, K2 forward and
     backward on each route, K4a-c, K4a and K4b backward, K2g forward and
     backward on each route, K5a and K5b, K3f forward and backward), the
     card's name and power limit, then the result line.

Tolerances: K1 forward atol 1e-4 on log values; gradients rtol 1e-4 with
atol 1e-5 * max|g| (the kernel sums in another order than cuBLAS, and its
3xTF32 products round like float32); with clipped entries, each gradient
within 1e-3 * max|grad| of float64; the HMM
log-likelihood rtol 1e-4 against the same reduction through the plain
version.  K2 forward atol 1e-4 plus rtol 1e-6 against the plain version
(the carry grows like T times the emission scale, and float32 rounds it at
that size), and the first row atol 1e-4 plus 1e-5 * max|alpha| against a
float64 filter; each gradient within rtol 1e-4 plus atol 1e-5 * max|grad|
of the plain version's at the small shapes, rtol 1e-3 plus atol
1e-4 * max|grad| at the main path's 127 dependent steps, where the plain
version's own float32 gradient was about 7e-4 * max|grad| from float64's
before the carry was kept shifted, and is about 1e-5 since (both
distances are printed); with states unreachable at the first step,
each gradient within 1e-3 * max|grad| of the float64 plain version (whose
backward keeps the clipped entries as a class of their own); the model_1v
ELBO rtol 1e-5 against the same
ELBO through the plain scan.  K4: each output of each level within 1e-4
times its largest entry (plus 1e-5) of the plain version's at the same
inputs (another factorisation order); log_prob rtol 1e-5 against float64
(float32 sums over 12-13 levels of values of order 10^5); the posterior
mean within 1e-3 times its largest entry of float64; the 64 draws' mean
within 6.5 standard errors of it at every entry, the mean squared
t-statistic in [0.8, 1.25].  K4 backward: each output of each level within
1e-4 times its largest entry (plus 1e-5) of the plain backward's, P
gradients symmetrised; a training step's loss rtol 1e-5 and each
parameter's gradient within 1e-3 times its largest entry of float64's.
K2g: finite forward values atol 1e-4 plus rtol 1e-6 of float64, each
gradient within 1e-3 * max|grad| of float64 (as K2's unreachable-states
check); model_1vt's and wide model_5's first step as a training step's
above; the ten chain cases' loss rtol 1e-5 and gradients rtol 1e-4 with
atol 1e-5 * max|grad| against float64 (as the port's CPU parity tests hold
them against the JAX package); model_1 against model_1v rtol 1e-5.  K5: alpha' exactly (a sum of constants);
every other output of each level within 1e-4 times its largest entry (plus
1e-5) of the plain version's and of the float64 plain version's;
GammaGaussianHMM.log_prob within 1e-6 of float64 times the sum of the
magnitudes of its last terms (the log normaliser, lgamma(concentration) and
concentration * log(rate), each near 2e5 at T=10000, cancelling to a result
about a seventh of their sum: float32 rounds each at about 1e-2, and the
reference's arithmetic does the same); the filter's concentration rtol
1e-6, its rate rtol 1e-4, its mean and covariance within 1e-3 times their
largest entry of float64; IndependentHMM, GaussianMRF, conjugate_update's
normaliser and updated log_prob, and prefix_condition's rest rtol 1e-5
against float64 (as GaussianHMM's log_prob), the conjugate identity rtol
1e-5 in float32 and 1e-10 in float64, the chain rule 1e-10 in float64.
The VAE's first-step loss rtol 1e-4 and
each gradient rtol 1e-4 with atol 1e-6 * max|grad| against the CPU run
(float32 sums in another order; TF32 off); the DMM's first-step loss rtol
1e-4 and each gradient within 1e-3 * max|grad| of the CPU run's.  The
queries (TF32 off): the marginals and ubersum's gradients no further from a
float64 CPU run than three times the CPU's own float32 run, plus 1e-6,
and than 3e-4 in probability and 2e-3 * max|grad| (float32 rounds the log messages, log Z about -1.7e3 a sequence and 9.5e3,
at 1.2e-4 and 1e-3, and these outputs are exps of their differences: the
CPU's float32 run is some 1e-4 off in probability, 1e-3 relative in the
gradients); ubersum's value rtol 1e-5 against the CPU run; the MAP path's
joint log density rtol 1e-5 against the float64 CPU run's; each draw frequency within
5 sqrt(p(1-p)/256) + 1/256 of its marginal p; sequential enumeration rtol
1e-5; the sampled
loss's mean within 4 standard errors of the CPU run's.  The GP time
series: the example's last loss rtol 1e-4 and its forecast atol 1e-3
against the CPU run's (300 float32 Adam steps on each device); at the EEG
shape, log_prob rtol 1e-5 (each channel's, for IndependentMaternGP) and
the first step's loss rtol 1e-5 against float64, each gradient within 1e-3
times its largest entry of float64's (as a training step's above); the
draw's channel 0-1 correlation above 0.4 with the coupled factor and within
0.25 of 0 without (as the JAX package's test); the guides' -ELBO at one
latent value rtol 1e-5 against the CPU run.  NUTS through the kernels: the
card's potential and gradient no further from float64 than three times
the CPU's own float32 run, plus 1e-6 of the largest (float32 rounds
model_1's log Z, about 2.7e4 over 8 chains, at a few 1e-3); K1 inside the
call atol 1e-4 plus 1e-6 of its largest log value forward (two ulps at
1e2), its gradients and K2's as K1's and the main path's K2's above; the
graphed subtree within 1e-5 of each field's largest entry of the eager
one; the vmapped ``lgssm`` log_prob and gradients as a training step's
above.  Forecasting: each recorded K4 level as phase 8's; the first step's
-ELBO, and HMCForecaster's potential, rtol 1e-5 against float64, each
gradient within 1e-3 times its largest entry (as a training step's); 4000
draws of the prefix-conditioned noise at the guide's median, each step's
mean within 5 standard errors and its variance within 10% of the exact
conditional's, and the forecaster's 100 draws' mean within 5 standard
errors of the exact mean.  Epidemiology: each K3f call -inf exactly where
its plain version is, no NaN, finite values within 1e-5 * max|out| + 1e-5
and gradients within 1e-4 * max|grad| of the plain version's (the same
sums in another order); the quantized potential and gradient as NUTS's
above; (a)'s quantized R0 median within 1.0 of the relaxed fit's (the JAX
package's test criterion).  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""

import contextlib
import json
import linecache
import math
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

B, T, D, S, NN_DIM, NN_CHANNELS, STEPS = 32, 128, 51, 256, 32, 2, 5
EMISSION = -35.0  # a step's summed emission log-factor on the main path, about
K2_F64_SEEDS = 5  # seeds of the unreachable-states data held against float64

# slice 5: the VAE of examples/vae.py, and NUTS on eight schools as in bench.py
VAE_B, VAE_X, VAE_H, VAE_Z, VAE_BATCHES, VAE_STEPS = 256, 784, 400, 50, 10, 200
NUTS_CHAINS, NUTS_ITERS, NUTS_MIN, NUTS_PROBE, NUTS_BUDGET_S = 1024, 500, 200, 20, 90.0
# posterior mean and sd of mu and tau by 2-D quadrature (eta integrated out;
# mu in [-40, 50], tau in (0, 300])
QUADRATURE = {"mu": (4.398, 3.317), "tau": (3.580, 3.222)}

# slice 6: GaussianHMM at the bench's shapes (bench.py:55,63)
GHMM_SIG, GFS_SIG = "8.10000.32.4", "64.4000.16.4"
GHMM_CALLS = 10  # chained log_prob calls a rep, as bench.py:995-1010
GFS_DRAWS = 64
GHMM_RTOL = 1e-5  # log_prob against the float64 plain levels
GFS_MEAN_TOL = 1e-3  # posterior mean against float64, times its largest entry
GFS_T_MAX = 6.5  # the draws' mean, in standard errors of 64 draws, at most

# slice 7: SVI through K4 (examples/lgssm.py, examples/gaussian_hmm.py --train)
TRAIN_STEPS = 5
TRAIN_GRAD_TOL = 1e-3  # first-step gradients against float64, times each parameter's max|grad|
TRAIN_LOSS_RTOL = 1e-5  # the first step's loss against float64


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn`` on the card over ``iters`` calls, after a warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(fns, iters=10):
    """Time each fn in turns a, b, b, a and return the mean ms of each."""
    first = {name: cuda_ms(fn, iters) for name, fn in fns.items()}
    second = {name: cuda_ms(fn, iters) for name, fn in reversed(list(fns.items()))}
    return {name: (first[name] + second[name]) / 2 for name in fns}


def max_err(a, b):
    return float((a - b).abs().max())


def compare_k1(lm, leaves, split, g, label, f64_check=True):
    """Kernel forward and backward against the plain version on the operands
    ``split(*leaves)`` (views of the leaves, so strided layouts reach the
    kernel as they are), and the first batch item's forward against a
    float64 logsumexp; returns the largest forward and gradient errors."""
    import torch

    grads = []
    outs = []
    for fn in (lm.logmatmulexp, lm.logmatmulexp_plain):
        copies = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*split(*copies))
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append([c.grad for c in copies])
    torch.cuda.synchronize()
    out_k, out_p = outs
    check(torch.isfinite(out_k).all(), f"{label}: non-finite forward output")
    check(out_k.shape == out_p.shape, f"{label}: shape {tuple(out_k.shape)} != {tuple(out_p.shape)}")
    fwd_err = max_err(out_k, out_p)
    check(fwd_err <= 1e-4, f"{label}: forward max abs err {fwd_err} > 1e-4")
    if f64_check:
        x, y = (t.detach() for t in split(*leaves))
        batch = out_k.shape[:-2]
        x0 = x.expand(batch + x.shape[-2:]).reshape(-1, *x.shape[-2:])[0].double()
        y0 = y.expand(batch + y.shape[-2:]).reshape(-1, *y.shape[-2:])[0].double()
        ref = torch.logsumexp(x0[:, :, None] + y0[None], dim=1)
        f64_err = max_err(out_k.reshape(-1, *out_k.shape[-2:])[0].double(), ref)
        check(f64_err <= 1e-4, f"{label}: forward differs from float64 by {f64_err}")
        print(f"  {label}: first item's forward max abs err to float64 {f64_err:.3g}")
    atol = 1e-5 * float(g.abs().max())
    bwd_err = 0.0
    for a, b in zip(*grads):
        check(torch.isfinite(a).all(), f"{label}: non-finite gradient")
        excess = float(((a - b).abs() - (atol + 1e-4 * b.abs())).max())
        check(excess <= 0, f"{label}: gradient outside rtol 1e-4, atol {atol:.3g} by {excess:.3g}")
        bwd_err = max(bwd_err, max_err(a, b))
    print(f"  {label}: forward max abs err {fwd_err:.3g}, gradient max abs err {bwd_err:.3g}")
    return fwd_err, bwd_err


def _pair(x, y):
    return x, y


def _halves(logits):
    pairs = logits.reshape(logits.shape[0], logits.shape[1] // 2, 2, *logits.shape[2:])
    return pairs[..., 0, :, :], pairs[..., 1, :, :]


def check_k1_clipped(lm, logits, g, label):
    """K1's gradients through the strided halves of ``logits``, in which
    some entries' z is 0 (clipped at FLT_MIN), against the float64 direct
    form with the kernel's own out, E = -(out - xs - ys):
    dx = P * ((g exp(E)) @ Q^T), dy = Q * (P^T @ (g exp(E))).  Each within
    1e-3 * max|grad|; the plain version's distance is printed beside it."""
    import torch

    errs = {}
    for name, fn in (("kernel", lm.logmatmulexp), ("plain", lm.logmatmulexp_plain)):
        leaf = logits.detach().clone().requires_grad_()
        n = dict(lm.copies)
        out = fn(*_halves(leaf))
        (out * g).sum().backward()
        torch.cuda.synchronize()
        if name == "kernel":
            check(lm.copies == n, f"{label}: the wrapper copied an operand: {lm.copies} after {n}")
            check(bool((out < -80).any()), f"{label}: no entry was clipped")
            with torch.no_grad():
                x, y = (t.double() for t in _halves(logits.detach()))
                xs, ys = (torch.nan_to_num(m, neginf=0.0) for m in (x.amax(-1, keepdim=True), y.amax(-2, keepdim=True)))
                P, Q = torch.exp(x - xs), torch.exp(y - ys)
                W = g.double() * torch.exp(-(out.detach().double() - xs - ys))
                dx, dy = P * (W @ Q.transpose(-1, -2)), Q * (P.transpose(-1, -2) @ W)
                ref = torch.stack([dx, dy], dim=2).reshape(logits.shape)
                del x, y, P, Q, W, dx, dy
        check(bool(torch.isfinite(leaf.grad).all()), f"{label}: non-finite {name} gradient")
        errs[name] = float((leaf.grad.double() - ref).abs().max() / ref.abs().max())
    print(f"  {label}: gradients to float64 over max|grad|: kernel {errs['kernel']:.3g}, plain {errs['plain']:.3g}")
    check(errs["kernel"] <= 1e-3, f"{label}: kernel gradient {errs['kernel']:.3g} * max|grad| from float64")


def phase_k1(torch, lm):
    print("phase 2: K1 log-matmul-exp against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    # the main path's first round: time-paired strided halves of (B, T, S, S)
    logits = randn(B, T, S, S, scale=2.0)
    x, y = _halves(logits)
    check(not x.is_contiguous(), "the halves must be strided views")
    g = randn(B, T // 2, S, S)
    copies_before = dict(lm.copies)
    fwd_err, bwd_err = compare_k1(lm, [logits], _halves, g, f"({B * T // 2}, {S}, {S}) strided halves")
    check(lm.copies == copies_before, f"the strided halves were copied: {lm.copies} after {copies_before}")
    # half the rows of x have their support in the first quarter of k, from
    # which y reaches no column of the last quarter: z is 0 there
    clipped = logits.clone()
    pairs = clipped.view(B, T // 2, 2, S, S)
    pairs[:, :, 0, : S // 2, S // 4:] = -float("inf")
    pairs[:, :, 1, : S // 4, 3 * S // 4:] = -float("inf")
    check_k1_clipped(lm, clipped, g, f"({B * T // 2}, {S}, {S}) strided halves, a quarter of the columns clipped")
    del clipped, pairs
    big = [randn(16, 512, 512, scale=3.0), randn(16, 512, 512, scale=3.0)]
    compare_k1(lm, big, _pair, randn(16, 512, 512), "(16, 512, 512)")
    ragged = [randn(3, 37, 129, scale=3.0), randn(1, 129, 61, scale=3.0)]
    compare_k1(lm, ragged, _pair, randn(3, 37, 61), "(3, 37, 129) @ (1, 129, 61)")
    ragged16 = [randn(5, 100, 68, scale=3.0), randn(5, 68, 132, scale=3.0)]
    compare_k1(lm, ragged16, _pair, randn(5, 100, 132), "(5, 100, 68) @ (5, 68, 132), 16-byte copies")
    ux = torch.full((4, 8), -300.0, device="cuda")
    ux[:, 0] = 0.0
    uy = torch.full((8, 8), -200.0, device="cuda")
    uy[1:, :] = -1.0
    compare_k1(lm, [ux, uy], _pair, randn(4, 8, scale=5.0), "underflow", f64_check=False)
    ux[0, :] = -float("inf")
    uy = torch.full((8, 8), -200.0, device="cuda")
    uy[:, 3] = -float("inf")
    compare_k1(lm, [ux, uy], _pair, torch.ones(4, 8, device="cuda"), "-inf rows and columns", f64_check=False)
    out = lm.logmatmulexp(ux, uy)
    check(bool((out[0] < -80).all()), "an all -inf row must give log(FLT_MIN)")

    # timing at the main path's first-round shape
    n = x.shape[0] * x.shape[1]
    M = K = N = S
    with torch.no_grad():
        out, xs, ys = lm._forward_cuda(x, y)
        fwd = alternate({
            "kernel": lambda: lm._forward_cuda(x, y),
            "plain": lambda: lm._logmatmulexp_raw(x, y),
        })
        matmul_ms = cuda_ms(lambda: torch.matmul(x, y), 10)
        bwd = alternate({
            "kernel": lambda: lm._backward_cuda(x, y, out, xs, ys, g),
            "plain": lambda: lm._logmatmulexp_bwd(x, y, out, g),
        })
    # products plus an exp per input and a log per output; x, y in and out
    # (with the maxima) out.  Backward: two products and the elementwise
    # terms; x, y, out, g in, dx, dy out.
    fwd_flops = 2 * n * M * N * K + n * (M * K + K * N + M * N)
    fwd_bytes = 4 * n * (M * K + K * N + M * N + M + N)
    bwd_flops = 4 * n * M * N * K + n * (2 * M * K + 2 * K * N + 2 * M * N)
    bwd_bytes = 4 * n * (2 * M * K + 2 * K * N + 2 * M * N)
    fb, bb = bound(fwd_flops, fwd_bytes), bound(bwd_flops, bwd_bytes)
    fb_tc, bb_tc = bound(fwd_flops, fwd_bytes, tf32=True), bound(bwd_flops, bwd_bytes, tf32=True)
    print(f"  timing at ({n}, {M}, {K}) @ ({n}, {K}, {N}) f32, strided halves:")
    for name, t, b_f32, b_tc in (("forward ", fwd, fb, fb_tc), ("backward", bwd, bb, bb_tc)):
        print(f"    {name} kernel {t['kernel']:.4f} ms  plain {t['plain']:.4f} ms  bound on the tensor cores "
              f"{b_tc[0]:.4f} ms ({b_tc[1]}), on the f32 CUDA cores {b_f32[0]:.4f} ms ({b_f32[1]})")
    print(f"    torch.matmul of the same operands (the product alone, no exp/log): {matmul_ms:.4f} ms")
    return {
        "forward": {"max_abs_err": fwd_err, "ms": fwd["kernel"], "plain_ms": fwd["plain"], "bound": fb_tc},
        "backward": {"max_abs_err": bwd_err, "ms": bwd["kernel"], "plain_ms": bwd["plain"], "bound": bb_tc},
        "matmul_ms": matmul_ms,
    }


def bound(flops, nbytes, tf32=False):
    """The card's least time in ms for the work, and what bounds it: on the
    f32 CUDA cores, or (``tf32``) on the tensor cores with the three TF32
    products of the 3xTF32 split."""
    t_ops = (3 * flops / PEAK_TF32_FLOPS if tf32 else flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_slice(torch, lm):
    print(f"phase 3: model_7 SVI at B={B}, T={T}, D={D}, S={S}, nn_dim={NN_DIM}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.distributions import hmm
    from pyro_tpu_torch.examples import hmm as example

    args = example.parse_args([
        "--hidden-dim", str(S), "--num-sequences", str(B), "--max-length", str(T), "--data-dim", str(D),
        "--nn-dim", str(NN_DIM), "--nn-channels", str(NN_CHANNELS), "--num-steps", str(STEPS),
    ])
    sequences, lengths = example.synthetic_sequences(args.seed, B, T, D)
    pyro.clear_param_store()
    model, guide, svi = example.make_svi(args, args.learning_rate)

    # the step-0 parameters: the HMM likelihood through the kernel against
    # the same reduction through the plain version
    with torch.no_grad():
        guide_trace = poutine.trace(guide).get_trace(sequences, lengths)
        model_trace = poutine.trace(poutine.replay(model, trace=guide_trace)).get_trace(sequences, lengths)
        site = model_trace.nodes["y"]
        d, value = site["fn"], site["value"]
        lp = d.log_prob(value)
        v = value.unsqueeze(-1 - d.observation_dist.event_dim)
        factors = d.transition_logits + d.observation_dist.log_prob(v).unsqueeze(-2)  # (B, T, S, S)
        result = hmm._sequential_logmatmulexp(factors, logmatmulexp=lm.logmatmulexp_plain)
        lp_plain = torch.logsumexp(d.initial_logits + torch.logsumexp(result, dim=-1), dim=-1)
        # K3, forward: the 7 halving rounds through K1 against the same rounds
        # through the plain version, in turns
        k3_t = alternate({
            "kernel": lambda: hmm._sequential_logmatmulexp(factors),
            "plain": lambda: hmm._sequential_logmatmulexp(factors, logmatmulexp=lm.logmatmulexp_plain),
        }, iters=3)
    print(f"  K3 forward ({T.bit_length() - 1} rounds of K1 over {tuple(factors.shape)}): kernel "
          f"{k3_t['kernel']:.4f} ms, plain {k3_t['plain']:.4f} ms")
    check(lp.shape == (B,) and bool(torch.isfinite(lp).all()), f"log_prob shape {tuple(lp.shape)} or values bad")
    rel = float(((lp - lp_plain).abs() / lp_plain.abs()).max())
    check(rel <= 1e-4, f"DiscreteHMM.log_prob differs from the plain reduction by rtol {rel}")
    print(f"  DiscreteHMM.log_prob at step-0 params: max rel diff to plain {rel:.3g}")

    lm.launches.update(forward=0, backward=0)
    lm.copies.update(forward=0, backward=0)
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(svi.step(sequences, lengths))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches, copies = dict(lm.launches), dict(lm.copies)
    print(f"  losses {losses}")
    print(f"  ms per step {[round(t, 3) for t in step_ms]} (first step includes guide set-up)")
    print(f"  launches over {STEPS} steps: {launches}; operands copied by the wrapper: {copies}")
    check(all(map(lambda l: l == l and abs(l) != float("inf"), losses)), "non-finite loss")
    check(launches == {"forward": 7 * STEPS, "backward": 7 * STEPS}, f"expected 7 launches per step each, got {launches}")
    check(copies == {"forward": 0, "backward": 0}, f"expected no operand copies, got {copies}")
    k1_ms = profile_step(torch, svi, sequences, lengths)
    # K3, the pairwise reduction: log2 T rounds of K1 over B * T / 2^r items
    items = sum(B * (T >> r) for r in range(1, T.bit_length()))
    k3_flops = items * (6 * S**3 + 9 * S * S)
    k3_bytes = 4 * items * 9 * S * S
    k3 = bound(k3_flops, k3_bytes, tf32=True)
    print(f"  K3 ({T.bit_length() - 1} rounds, {items} items, forward and backward): K1 device time per step "
          f"{k1_ms:.3f} ms, bound on the tensor cores {k3[0]:.4f} ms ({k3[1]})")
    return launches, step_ms


def filter64(alpha0, A, R, L=None):
    """The scan's forward in float64 with the kernel's clip, for one row:
    alpha0 (S,), A (S, S), R and L (T', S)."""
    import torch

    alpha0, A, R = alpha0.double(), A.double(), R.double()
    finite = lambda v: torch.where(torch.isfinite(v), v, torch.zeros_like(v))  # noqa: E731
    c = finite(A.amax(0))
    Q = torch.exp(A - c)
    alpha = alpha0
    for t in range(R.shape[0]):
        h = alpha if L is None else alpha + L[t].double()
        m = finite(h.max())
        z = torch.exp(h - m) @ Q
        alpha = torch.log(z.clamp(min=torch.finfo(torch.float32).tiny)) + m + c + R[t]
    return alpha


def k2_plan(ms, inputs):
    """The route the wrapper chooses for these inputs."""
    alpha0, A = inputs[0], inputs[1]
    B, S = alpha0.shape
    return ms._device_plan(B, S, 1 if A.ndim == 2 else B, alpha0.device)


def compare_k2(ms, inputs, g, label, grad_rtol, grad_atol, route="cluster"):
    """K2 forward and the gradients of all its inputs against the plain
    version, and the first row's forward against ``filter64``; prints each
    gradient's distance to the float64 plain version, for kernel and plain,
    over that gradient's largest entry.  A gradient passes within
    ``grad_atol * max|grad| + grad_rtol * |grad|`` of the plain one.  The
    kernel runs on ``route``: the wrapper's choice if it chooses that route,
    else forced.  Returns the largest forward and gradient errors."""
    import torch

    plan = None if k2_plan(ms, inputs).route == route else ms.ScanPlan(route)
    label = f"{label} [{route}{'' if plan else ', chosen'}]"
    outs, grads = [], []
    for fn in (ms.markov_scan, ms.markov_scan_plain):
        leaves = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
        n, on_route = dict(ms.launches), dict(ms.route_launches[route])
        out = fn(*leaves, plan=plan) if fn is ms.markov_scan else fn(*leaves)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        if fn is ms.markov_scan:
            check(ms.launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1},
                  f"{label}: expected one K2 launch each way, got {ms.launches} after {n}")
            check(ms.route_launches[route] == {"forward": on_route["forward"] + 1,
                                               "backward": on_route["backward"] + 1},
                  f"{label}: expected one launch each way on the {route} route, got {ms.route_launches}")
        outs.append(out.detach())
        grads.append([None if t is None else t.grad for t in leaves])
    out_k, out_p = outs
    fwd_err = max_err(out_k, out_p)
    alpha0, A, R, L = inputs
    ref = filter64(alpha0[0], A if A.ndim == 2 else A[0], R[:, 0], None if L is None else L[:, 0])
    f64_err = max_err(out_k[0].double(), ref)
    print(f"  {label}: forward max abs err {fwd_err:.3g}, first row to float64 {f64_err:.3g}")
    # each gradient's distance to float64, through the plain version
    leaves64 = [None if t is None else t.detach().double().requires_grad_() for t in inputs]
    (ms.markov_scan_plain(*leaves64) * g.double()).sum().backward()
    bwd_err, failures = 0.0, []
    for name, a, b, c in zip(("alpha0", "A", "R", "L"), *grads, leaves64):
        if a is None:
            continue
        scale = float(c.grad.abs().max()) + 1e-30
        k64 = float((a.double() - c.grad).abs().max()) / scale
        p64 = float((b.double() - c.grad).abs().max()) / scale
        excess = float(((a - b).abs() - (grad_atol * float(b.abs().max()) + grad_rtol * b.abs())).max())
        print(f"    d{name}: max abs err {max_err(a, b):.3g} (max|grad| {scale:.3g}); to float64 over "
              f"max|grad|: kernel {k64:.3g}, plain {p64:.3g}")
        bwd_err = max(bwd_err, max_err(a, b))
        if not bool(torch.isfinite(a).all()):
            failures.append(f"non-finite d{name}")
        if excess > 0:
            failures.append(f"d{name} outside atol {grad_atol} * max|grad| + rtol {grad_rtol} of plain by {excess:.3g}")
    check(bool(torch.isfinite(out_k).all()), f"{label}: non-finite forward output")
    fwd_excess = float(((out_k - out_p).abs() - (1e-4 + 1e-6 * out_p.abs())).max())
    check(fwd_excess <= 0, f"{label}: forward outside atol 1e-4 + rtol 1e-6 of plain by {fwd_excess:.3g}")
    check(f64_err <= 1e-4 + 1e-5 * float(ref.abs().max()), f"{label}: forward differs from float64 by {f64_err}")
    check(not failures, f"{label}: " + "; ".join(failures))
    return fwd_err, bwd_err


def check_k2_f64(ms, inputs, g, label, tol, route="cluster"):
    """K2's forward against the plain version, and each gradient within
    ``tol * max|grad|`` of the plain version's in float64, on ``route``."""
    import torch

    plan = None if k2_plan(ms, inputs).route == route else ms.ScanPlan(route)
    label = f"{label} [{route}{'' if plan else ', chosen'}]"
    leaves = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
    out = ms.markov_scan(*leaves, plan=plan)
    (out * g).sum().backward()
    out = out.detach()
    with torch.no_grad():
        out_p = ms.markov_scan_plain(*inputs)
    leaves_p = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
    (ms.markov_scan_plain(*leaves_p) * g).sum().backward()
    leaves64 = [None if t is None else t.detach().double().requires_grad_() for t in inputs]
    (ms.markov_scan_plain(*leaves64) * g.double()).sum().backward()
    torch.cuda.synchronize()
    fwd_excess = float(((out - out_p).abs() - (1e-4 + 1e-6 * out_p.abs())).max())
    check(fwd_excess <= 0, f"{label}: forward outside atol 1e-4 + rtol 1e-6 of plain by {fwd_excess:.3g}")
    errs, failures = [], []
    for name, a, p, c in zip(("alpha0", "A", "R", "L"), leaves, leaves_p, leaves64):
        if a is None:
            continue
        check(bool(torch.isfinite(a.grad).all()), f"{label}: non-finite d{name}")
        scale = float(c.grad.abs().max()) + 1e-30
        err = float((a.grad.double() - c.grad).abs().max()) / scale
        p_err = float((p.grad.double() - c.grad).abs().max()) / scale
        errs.append(f"d{name} {err:.3g} (plain {p_err:.3g})")
        if err > tol:
            failures.append(f"d{name} is {err:.3g} * max|grad| from float64, over {tol}")
    print(f"  {label}: forward max abs err {max_err(out, out_p):.3g}; to float64 over max|grad|: {', '.join(errs)}")
    check(not failures, f"{label}: " + "; ".join(failures))


def k2_bounds(steps, B, S):
    """K2's least times on the card, forward and backward.  Forward: T'
    products of (B, S) @ (S, S) plus an exp per h and a log per output;
    bytes: alpha0, A, R in, alpha_T' out.  Backward: each step's out is
    known (alpha_{t+1} - R_t), so the gradient needs two products of that
    size per step, rx = u @ Q^T and the dA fold, plus the elementwise terms;
    bytes: A, the carry stack and g in, dalpha0, dA and dR out."""
    prod = 2 * steps * B * S * S
    return (bound(prod + 3 * steps * B * S, 4 * (2 * B * S + S * S + steps * B * S)),
            bound(2 * prod + 6 * steps * B * S, 4 * (2 * B * S + 2 * S * S + 2 * steps * B * S)))


def time_k2(torch, ms, inputs, g, with_plain):
    """Forward and backward ms of both routes (and the plain version) in
    turns at ``inputs``."""
    alpha0, A, R, _ = inputs
    stream = ms.ScanPlan("stream")
    with torch.no_grad():
        saved = {}
        for route, plan in (("cluster", None), ("stream", stream)):
            saved[route] = ms._forward_cuda(alpha0, A, R, plan=plan)[1]
        fwd_fns = {
            "cluster": lambda: ms._forward_cuda(alpha0, A, R),
            "stream": lambda: ms._forward_cuda(alpha0, A, R, plan=stream),
        }
        if with_plain:
            fwd_fns["plain"] = lambda: ms.markov_scan_plain(alpha0, A, R)
        fwd = alternate(fwd_fns)
    bwd_fns = {route: (lambda s=s: ms._backward_cuda(A, None, s, g)) for route, s in saved.items()}
    if with_plain:
        leaves = [t.detach().clone().requires_grad_() for t in (alpha0, A, R)]
        out_p = ms.markov_scan_plain(*leaves)
        bwd_fns["plain"] = lambda: torch.autograd.grad(out_p, leaves, g, retain_graph=True)
    bwd = alternate(bwd_fns)
    return fwd, bwd


def sweep_clusters(torch, ms, inputs, g):
    """The cluster route's forward and backward ms at each cluster size C
    and rows per cluster that fit, beside how many such clusters the card
    runs at once; returns {(C, rows): (forward ms, backward ms)}."""
    alpha0, A, R, _ = inputs
    B, S = alpha0.shape
    limit = ms._query(ms._lib().msc_smem_limit, device=alpha0.device)
    out = {}
    for C in (4, 8, 16):
        for rows in (1, 2, 3, 4, 8):
            smem = max(ms.cluster_smem_bytes(S, C, rows), ms.cluster_smem_bytes(S, C, rows, True))
            if not ms.cluster_takes(S, C, rows) or smem > limit:
                continue
            plan = ms.ScanPlan("cluster", C, rows)
            with torch.no_grad():
                saved = ms._forward_cuda(alpha0, A, R, plan=plan)[1]
                f = cuda_ms(lambda: ms._forward_cuda(alpha0, A, R, plan=plan), 10)
            b = cuda_ms(lambda: ms._backward_cuda(A, None, saved, g), 10)
            active = ms.active_clusters(S, C, rows, alpha0.device)
            out[(C, rows)] = (f, b)
            print(f"    C={C:2d} rows={rows}: {-(-B // rows):2d} clusters ({active} run at once), "
                  f"forward {f:.4f} ms, backward {b:.4f} ms")
    return out


def phase_k2(torch, lm, ms):
    print("phase 4: K2 Markov-chain scan against its plain version, both routes")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def log_transition(*shape):
        return torch.log_softmax(randn(*shape, scale=2.0), dim=-1)

    steps = T - 1
    main = [randn(B, S), log_transition(S, S), randn(steps, B, S, scale=3.0) + EMISSION, None]
    g = randn(B, S)
    plan = k2_plan(ms, main)
    check(plan.route == "cluster", f"the main path's shape must take the cluster route, got {plan}")
    print(f"  the wrapper's plan at B={B}, S={S}: {plan}")
    errs = {}
    for route in ("cluster", "stream"):
        errs[route] = compare_k2(ms, main, g, f"B={B}, T'={steps}, S={S}", grad_rtol=1e-3, grad_atol=1e-4,
                                 route=route)
    ragged = [randn(3, 37), log_transition(37, 37), randn(6, 3, 37), randn(6, 3, 37)]
    g_ragged = randn(3, 37)
    per_row = [randn(3, 37), log_transition(3, 37, 37), randn(6, 3, 37), None]
    g_per_row = randn(3, 37)
    for route in ("cluster", "stream"):
        compare_k2(ms, ragged, g_ragged, "ragged B=3, T'=6, S=37, with L", grad_rtol=1e-4, grad_atol=1e-5,
                   route=route)
        compare_k2(ms, per_row, g_per_row, "one A per row, B=3, T'=6, S=37", grad_rtol=1e-4, grad_atol=1e-5,
                   route=route)
    A = log_transition(33, 33)
    A[A < -5.0] = -float("inf")
    A[:, 5] = -float("inf")
    compare_k2(ms, [randn(4, 33), A, randn(7, 4, 33), None], randn(4, 33), "-inf entries and a -inf column of A",
               grad_rtol=1e-4, grad_atol=1e-5)
    alpha0 = randn(4, 33)
    alpha0[2] = -float("inf")
    compare_k2(ms, [alpha0, log_transition(33, 33), randn(7, 4, 33), None], randn(4, 33),
               "an alpha0 row all -inf", grad_rtol=1e-4, grad_atol=1e-5)
    # a quarter of the states unreachable at the first step: their z is 0,
    # clipped at FLT_MIN, while every later step's z of those columns is not;
    # K2_F64_SEEDS draws of such data, each from its own seed
    for seed in range(K2_F64_SEEDS):
        gs = torch.Generator(device="cuda").manual_seed(100 + seed)
        A = torch.log_softmax(torch.randn((S, S), generator=gs, device="cuda") * 2.0, dim=-1)
        A[: S // 4, 3 * S // 4:] = -float("inf")
        alpha0 = torch.randn((B, S), generator=gs, device="cuda")
        alpha0[:, S // 4:] = -float("inf")
        R = torch.randn((steps, B, S), generator=gs, device="cuda") * 3.0 + EMISSION
        gu = torch.randn((B, S), generator=gs, device="cuda")
        for route in ("cluster", "stream"):
            check_k2_f64(ms, [alpha0, A, R, None], gu,
                         f"seed {100 + seed}: B={B}, T'={steps}, S={S}, states unreachable at step 0", 1e-3,
                         route=route)
    large = [randn(2, 1024), log_transition(1024, 1024), randn(4, 2, 1024), randn(4, 2, 1024)]
    check(k2_plan(ms, large).route == "stream", "S=1024 must take the streaming route")
    compare_k2(ms, large, randn(2, 1024), "B=2, T'=4, S=1024, with L", grad_rtol=1e-4, grad_atol=1e-5,
               route="stream")

    # timing: both routes in turns at the main path's shape and at S=512,
    # beside the plain version and the bound; the cluster sizes tried
    result = {}
    for s in (S, 2 * S):
        inputs = main if s == S else [randn(B, s), log_transition(s, s), randn(steps, B, s, scale=3.0) + EMISSION,
                                      None]
        gs = g if s == S else randn(B, s)
        fwd, bwd = time_k2(torch, ms, inputs, gs, with_plain=True)
        fb, bb = k2_bounds(steps, B, s)
        print(f"  timing at B={B}, T'={steps}, S={s} f32 (A shared), plan {k2_plan(ms, inputs)}:")
        for name, t, b in (("forward ", fwd, fb), ("backward", bwd, bb)):
            print(f"    {name} cluster {t['cluster']:.4f} ms ({1e3 * t['cluster'] / steps:.2f} us/step)  "
                  f"stream {t['stream']:.4f} ms ({1e3 * t['stream'] / steps:.2f} us/step)  "
                  f"plain {t['plain']:.4f} ms  bound {b[0]:.4f} ms ({b[1]})")
        print(f"  cluster sizes at S={s}:")
        sweep_clusters(torch, ms, inputs, gs)
        if s == S:
            result = {
                f"{route}_{d}": {"max_abs_err": errs[route][i], "ms": t[route], "plain_ms": t["plain"], "bound": b}
                for route in ("cluster", "stream")
                for i, (d, t, b) in enumerate((("forward", fwd, fb), ("backward", bwd, bb)))
            }
    alpha0, A, R, _ = main
    with torch.no_grad():
        def k1_loop():
            a = alpha0
            for t in range(steps):
                a = lm._forward_cuda(a, A)[0] + R[t]
            return a

        result["k1_loop_ms"] = cuda_ms(k1_loop, 10)
    print(f"  the route without K2, {steps} K1 forward launches: {result['k1_loop_ms']:.4f} ms")
    return result


def phase_enum_slice(torch, lm, ms):
    print(f"phase 5: model_1v SVI (TraceEnum_ELBO) at B={B}, T={T}, D={D}, S={S}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.infer import TraceEnum_ELBO
    from pyro_tpu_torch.ops import markov_product

    args = example.parse_args([
        "--model", "1v", "--hidden-dim", str(S), "--num-sequences", str(B), "--max-length", str(T),
        "--data-dim", str(D), "--num-steps", str(STEPS),
    ])
    sequences, lengths = example.synthetic_sequences(args.seed, B, T, D)
    pyro.clear_param_store()
    model, guide, svi = example.make_svi(args, args.learning_rate)

    # the step-0 ELBO through K2 against the same ELBO through the plain scan
    elbo = TraceEnum_ELBO(max_plate_nesting=3)
    loss_k = float(elbo.loss(model, guide, sequences, lengths))
    markov_product.markov_scan = ms.markov_scan_plain
    try:
        loss_p = float(elbo.loss(model, guide, sequences, lengths))
    finally:
        markov_product.markov_scan = ms.markov_scan
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  step-0 loss through K2 {loss_k!r}, through the plain scan {loss_p!r}, rel diff {rel:.3g}")
    check(rel <= 1e-5, f"model_1v loss through K2 differs from the plain scan by rtol {rel}")

    lm.launches.update(forward=0, backward=0)
    ms.reset_counts()
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(svi.step(sequences, lengths))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    k1, k2 = dict(lm.launches), dict(ms.launches)
    routes = {route: dict(counts) for route, counts in ms.route_launches.items()}
    print(f"  losses {losses}")
    print(f"  ms per step {[round(t, 3) for t in step_ms]}")
    print(f"  launches over {STEPS} steps: K2 {k2} (by route {routes}), K1 {k1}")
    check(all(map(lambda l: l == l and abs(l) != float("inf"), losses)), "non-finite loss")
    check(k2 == {"forward": STEPS, "backward": STEPS}, f"expected one K2 launch each way per step, got {k2}")
    check(routes == {"cluster": k2, "stream": {"forward": 0, "backward": 0}},
          f"expected every K2 launch on the cluster route, got {routes}")
    check(k1 == {"forward": 0, "backward": 0}, f"expected no K1 launch, got {k1}")
    profile_step(torch, svi, sequences, lengths)
    return routes, step_ms


@contextlib.contextmanager
def shared_noise(torch, eps):
    """Within the block, ``torch.randn`` returns ``eps`` on the device asked
    for: the guide's standard-normal draw, the same on the CPU and the card."""
    randn = torch.randn

    def draw(*shape, generator=None, dtype=None, device=None, **kwargs):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else tuple(shape)
        check(shape == tuple(eps.shape), f"unexpected standard-normal draw of shape {shape}")
        return eps.to(device=device, dtype=dtype)

    torch.randn = draw
    try:
        yield
    finally:
        torch.randn = randn


def phase_vae(torch):
    print(f"phase 6: VAE SVI (Trace_ELBO, Adam lr 1e-3) at B={VAE_B}, X={VAE_X}, H={VAE_H}, Z={VAE_Z}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import vae as example
    from pyro_tpu_torch.infer import Trace_ELBO

    torch.manual_seed(0)
    weights = example.VAE(VAE_X, VAE_H, VAE_Z).state_dict()
    pyro.set_default_device("cpu")
    try:
        batches_cpu = example.synthetic_batches(0, VAE_BATCHES, VAE_B, VAE_X)
    finally:
        pyro.set_default_device("cuda")
    batches = batches_cpu.to("cuda")
    eps = torch.randn((VAE_B, VAE_Z), generator=torch.Generator().manual_seed(1))

    def first_step(device, x):
        pyro.set_default_device(device)
        try:
            pyro.clear_param_store()
            vae = example.VAE(VAE_X, VAE_H, VAE_Z).to(device)
            vae.load_state_dict(weights)
            with shared_noise(torch, eps):
                loss = Trace_ELBO().differentiable_loss(vae.model, vae.guide, x)
            loss.backward()
            return float(loss.detach()), {name: p.grad.detach().cpu() for name, p in vae.named_parameters()}
        finally:
            pyro.set_default_device("cuda")

    loss_cpu, grads_cpu = first_step("cpu", batches_cpu[0])
    loss_gpu, grads_gpu = first_step("cuda", batches[0])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"  first step's loss: card {loss_gpu!r}, CPU {loss_cpu!r}, rel diff {rel:.3g}")
    check(rel <= 1e-4, f"the VAE loss on the card differs from the CPU run by rtol {rel}")
    failures = []
    for name, ref in grads_cpu.items():
        g = grads_gpu[name]
        excess = float(((g - ref).abs() - (1e-4 * ref.abs() + 1e-6 * ref.abs().max())).max())
        print(f"    d{name}: max abs err {max_err(g, ref):.3g} (max|grad| {float(ref.abs().max()):.3g})")
        if not bool(torch.isfinite(g).all()) or excess > 0:
            failures.append(f"d{name} outside rtol 1e-4, atol 1e-6 * max|grad| of the CPU run by {excess:.3g}")
    check(not failures, "; ".join(failures))

    pyro.clear_param_store()
    vae = example.VAE(VAE_X, VAE_H, VAE_Z).to("cuda")
    vae.load_state_dict(weights)
    svi = example.make_svi(vae, 1e-3)
    generator = torch.Generator(device="cuda").manual_seed(0)
    losses, step_ms = [], []
    for i in range(VAE_STEPS):
        t0 = time.perf_counter()
        losses.append(svi.step(batches[i % VAE_BATCHES], generator=generator))  # reads the loss: synced
        step_ms.append((time.perf_counter() - t0) * 1e3)
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    check(all(math.isfinite(l) for l in losses), "non-finite VAE loss")
    check(last < first, f"the mean loss of the last 20 steps {last} is not below the first 20's {first}")
    steady = sorted(step_ms[20:])
    mean_ms = sum(steady) / len(steady)
    print(f"  {VAE_STEPS} steps: mean loss of the first 20 {first:.1f}, of the last 20 {last:.1f}")
    print(f"  steady step (steps 20-{VAE_STEPS - 1}): mean {mean_ms:.3f} ms, median {steady[len(steady) // 2]:.3f} ms, "
          f"min {steady[0]:.3f} ms, {1e3 / mean_ms:.1f} steps/s; first step {step_ms[0]:.3f} ms")
    wall, busy, launches, _ = profile_run(torch, lambda: svi.step(batches[0], generator=generator))
    print(f"  device operations per step {launches}")
    return {"step_ms": mean_ms, "steps_per_s": 1e3 / mean_ms, "launches": launches, "busy_share": busy / wall}


def phase_nuts(torch):
    print(f"phase 7: NUTS on eight schools, {NUTS_CHAINS} chains")
    from pyro_tpu_torch.examples import eight_schools as example
    from pyro_tpu_torch.infer import MCMC, NUTS
    from pyro_tpu_torch.ops.stats import effective_sample_size, split_gelman_rubin

    class TimedNUTS(NUTS):
        """NUTS that notes the wall time when warmup ends."""

        def sample_step(self, state, generator):
            if state.i == self._num_warmup:
                torch.cuda.synchronize()
                self.warmup_end = time.perf_counter()
            return super().sample_step(state, generator)

    y, sigma = example.data()
    generator = torch.Generator(device="cuda").manual_seed(0)
    # a probe of the first warmup iterations, the dearest, sets the counts
    probe = NUTS(example.model)
    t0 = time.perf_counter()
    MCMC(probe, num_samples=1, warmup_steps=NUTS_PROBE, num_chains=NUTS_CHAINS).run(y, sigma, generator=generator)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / (NUTS_PROBE + 1)
    n = max(NUTS_MIN, min(NUTS_ITERS, int(NUTS_BUDGET_S / (2 * per_iter))))
    print(f"  probe: {NUTS_PROBE + 1} iterations at {per_iter * 1e3:.1f} ms each, "
          f"{probe.counts['leapfrogs'] / (NUTS_PROBE + 1):.1f} leapfrog passes each")
    if n < NUTS_ITERS:
        print(f"  CUT: {n} warmup iterations and {n} samples instead of {NUTS_ITERS} and {NUTS_ITERS}, "
              f"to stay near {NUTS_BUDGET_S} s")

    kernel = TimedNUTS(example.model)
    mcmc = MCMC(kernel, num_samples=n, warmup_steps=n, num_chains=NUTS_CHAINS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(y, sigma, generator=generator)
    samples = mcmc.get_samples(group_by_chain=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    warmup_s, sample_s, run_s = kernel.warmup_end - t0, t1 - kernel.warmup_end, t1 - t0
    extra = mcmc._diagnostics_extra
    diag = mcmc.diagnostics()
    for site, (mean, sd) in QUADRATURE.items():
        draws = samples[site]
        check(bool(torch.isfinite(draws).all()), f"non-finite draws of {site}")
        ess = float(effective_sample_size(draws))
        mcse = float(draws.std()) / math.sqrt(ess)
        r_hat = float(split_gelman_rubin(draws))
        got = float(draws.mean())
        print(f"  {site}: mean {got:.4f} (quadrature {mean}, sd {float(draws.std()):.3f} against {sd}), "
              f"ESS {ess:.0f}, MC standard error {mcse:.4f}, split r_hat {r_hat:.4f}")
        check(abs(got - mean) <= 4 * mcse + 0.01, f"{site}: posterior mean {got} is over 4 MCSE + 0.01 from {mean}")
        check(r_hat < 1.05, f"{site}: split r_hat {r_hat} >= 1.05")
    check(all(bool(torch.isfinite(v).all()) for v in samples.values()), "non-finite draws")
    accept = float(extra["accept_prob"].mean())
    check(0.6 <= accept <= 0.95, f"mean accept probability after warmup {accept} outside [0.6, 0.95]")
    total_ess = sum(float(diag[site]["n_eff"].sum()) for site in ("eta", "mu", "tau"))
    passes, syncs = kernel.counts["leapfrogs"], kernel.counts["host_syncs"]
    chain_leapfrogs = float(extra["num_steps"].sum())
    print(f"  mean accept probability after warmup {accept:.4f}, divergences "
          f"{float(extra['diverging'].float().mean()) * 100:.3f}% of transitions")
    print(f"  wall: warmup {warmup_s:.2f} s, sampling {sample_s:.2f} s, run {run_s:.2f} s")
    print(f"  ESS per second (eta, mu, tau summed over the run's wall time, as bench.py): {total_ess / run_s:.1f}")
    print(f"  leapfrog passes over the batch: {passes} ({passes / run_s:.1f}/s); chain leapfrogs while sampling "
          f"{chain_leapfrogs:.0f} ({chain_leapfrogs / sample_s:.0f}/s); host syncs {syncs} "
          f"({syncs / passes:.4f} per pass)")
    check(syncs <= passes, f"{syncs} host syncs over {passes} leapfrog passes")

    # the subtree builder replays its leaf as a CUDA graph: against the same
    # leaf run eagerly, from the run's last state at depth 6
    from pyro_tpu_torch.infer.mcmc.nuts import _Leaves

    class EagerNUTS(NUTS):
        """NUTS whose leaf runs eagerly on the card, not from a graph."""

        def _leaves(self, C, n_dim, like):
            return self._leaf_buffers.setdefault((C, n_dim), _Leaves(C, n_dim, self.max_tree_depth, like))

    eager = EagerNUTS(example.model)
    eager.setup(0, y, sigma, generator=torch.Generator(device="cuda").manual_seed(0))
    state = mcmc.last_state
    gen = torch.Generator(device="cuda").manual_seed(5)
    r = torch.randn(state.z.shape, generator=gen, device="cuda")
    inv, step = state.adapt.inverse_mass_diag, state.adapt.step_size
    energy0 = state.potential_energy + 0.5 * (inv * r * r).sum(-1)
    direction = torch.where(torch.rand(step.shape, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    trees = []
    for k in (kernel, eager):
        trees.append(k._build_subtree(6, state.z, r, state.z_grad, energy0, direction, step, inv,
                                      torch.Generator(device="cuda").manual_seed(6))[0])
    worst = 0.0
    for name, a, b in zip(trees[0]._fields, *trees):
        a, b = a.double(), b.double()
        finite = torch.isfinite(b)
        check(bool((torch.isfinite(a) == finite).all()), f"graphed subtree: {name} finite where eager is not")
        scale = float(b[finite].abs().max()) if bool(finite.any()) else 0.0
        err = float((a - b)[finite].abs().max()) if bool(finite.any()) else 0.0
        worst = max(worst, err / (scale + 1e-30))
        check(err <= 1e-5 * scale, f"graphed subtree: {name} is {err} from the eager leaf's (max {scale})")
    n_leaves = trees[1].num_proposals
    print(f"  graphed leaf against the eager leaf, depth-6 subtree of {NUTS_CHAINS} chains: largest difference "
          f"{worst:.3g} of a field's largest entry; leaves per chain {int(n_leaves.min())}-{int(n_leaves.max())}")
    # both from the run's last state with the same draws: 5 iterations each,
    # in turns graphed, eager, eager, graphed
    per_pass = {"graphed": [], "eager": []}
    for name in ("graphed", "eager", "eager", "graphed"):
        k = kernel if name == "graphed" else eager
        k.counts.update(leapfrogs=0, host_syncs=0)
        gen = torch.Generator(device="cuda").manual_seed(7)
        s_ = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            s_ = k.sample_step(s_, gen)
        torch.cuda.synchronize()
        per_pass[name].append((time.perf_counter() - t0) * 1e3 / k.counts["leapfrogs"])
    print(f"  5 iterations from the last state ({k.counts['leapfrogs']} leapfrog passes), ms a pass: graphed leaf "
          f"{per_pass['graphed']}, eager leaf {per_pass['eager']}")

    # one more iteration profiled, and one with every synchronizing call
    # reported by torch's sync debug mode
    state = mcmc.last_state
    kernel.counts.update(leapfrogs=0, host_syncs=0)
    wall, busy, launches, _ = profile_run(torch, lambda: kernel.sample_step(state, generator))
    lf = kernel.counts["leapfrogs"]
    check(all(b.graph is not None for b in kernel._leaf_buffers.values()), "the NUTS leaf was not captured")
    print(f"  profiled iteration: {lf} leapfrog passes, each one launch of the leaf's CUDA graph and "
          f"{launches / max(lf, 1):.1f} device operations")
    kernel.counts.update(leapfrogs=0, host_syncs=0)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kernel.sample_step(state, generator)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync_warnings = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    synced = len(sync_warnings)
    lf = kernel.counts["leapfrogs"]
    print(f"  sync debug mode: {synced} synchronizing calls over {lf} leapfrog passes "
          f"(the kernel counted {kernel.counts['host_syncs']})")
    sources = {}
    for w in sync_warnings:
        where = f"{os.path.relpath(w.filename, HERE)}:{w.lineno} {linecache.getline(w.filename, w.lineno).strip()}"
        sources[where] = sources.get(where, 0) + 1
    print(f"    by source line: {sources}")
    check(synced <= lf, f"{synced} synchronizing calls over {lf} leapfrog passes")
    return {"iterations": n, "run_s": run_s, "ess_per_s": total_ess / run_s, "busy_share": busy / wall}


# -- slice 6: the Gaussian state-space HMM and the K4 kernels -----------------------


def slice_models(torch, dtype=None, example_name="gaussian_hmm"):
    """The two configurations of ``examples/<example_name>.py``
    (``gaussian_hmm`` or ``gamma_gaussian_hmm``) at full width (numpy, seed
    0) on the card: {config: (hmm, data)}, in float32 unless ``dtype`` is
    given."""
    import importlib

    example = importlib.import_module(f"pyro_tpu_torch.examples.{example_name}")
    out = {}
    for config in ("homogeneous", "heterogeneous"):
        arrays = example.make_arrays(config, 0)
        params = {k: torch.tensor(v, dtype=dtype or torch.float32, device="cuda") for k, v in arrays.items()}
        data = params.pop("data")
        out[config] = (example.make_hmm(params, example.CONFIGS[config]["T"]), data)
    return out


LEVEL_WRAPPERS = ("halving_level", "contract_pairs", "level_mids", "gamma_halving_level", "gamma_contract_pairs")


@contextlib.contextmanager
def plain_levels(gl):
    """Within the block the Gaussian and gamma-Gaussian algebras run the K4
    and K5 plain versions, which take any device and type (the reference in
    float64 on the card)."""
    saved = {name: getattr(gl, name) for name in LEVEL_WRAPPERS}
    for name in LEVEL_WRAPPERS:
        setattr(gl, name, getattr(gl, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gl, name, fn)


@contextlib.contextmanager
def record_levels(gl, name):
    """Within the block, the arguments of every call of ``gl.<name>``, all
    positional, defaults included."""
    import inspect

    calls, fn = [], getattr(gl, name)
    signature = inspect.signature(fn)

    def recorder(*args, **kwargs):
        bound_args = signature.bind(*args, **kwargs)
        bound_args.apply_defaults()
        calls.append(tuple(bound_args.arguments.values()))
        return fn(*args, **kwargs)

    setattr(gl, name, recorder)
    try:
        yield calls
    finally:
        setattr(gl, name, fn)


def distinct(x):
    """The distinct elements of ``x``: a dim of stride 0 holds one."""
    return math.prod(size for size, stride in zip(x.shape, x.stride()) if stride != 0)


# The n-sweep of K4b and K5b (one kernel template): (R, t, n, layout of P)
# over n of 1, 2, 5, 16, 17, 31 and 32, t of 2, 3, odd and 4000, up to 8
# rows, P contiguous, each row a slice, or expanded with stride 0.
CONTRACT_SWEEP = [
    (8, 3, 1, "sliced"), (3, 9, 2, "stride0_time"), (2, 2, 5, "contiguous"), (8, 4000, 16, "stride0_rows"),
    (1, 13, 17, "sliced"), (4, 3, 31, "stride0_time"), (8, 9, 32, "contiguous"), (8, 4000, 32, "stride0_both"),
    (8, 4001, 31, "stride0_both"), (2, 2, 32, "sliced"),
]


def contract_inputs(torch, gen, R, t, n, layout):
    """P (R, t, 2n, 2n) symmetric positive definite, info and logZ, laid out
    as ``layout`` (info and logZ sliced with P)."""
    n2 = 2 * n

    def spd(*batch):
        M = torch.randn(*batch, n2, n2, generator=gen, device="cuda")
        return M @ M.transpose(-1, -2) / n2 + torch.eye(n2, device="cuda")

    P = {"stride0_rows": lambda: spd(1, t).expand(R, t, n2, n2),
         "stride0_time": lambda: spd(R, 1).expand(R, t, n2, n2),
         "stride0_both": lambda: spd().expand(R, t, n2, n2),
         "sliced": lambda: spd(R, t + 1)[:, 1:],
         "contiguous": lambda: spd(R, t)}[layout]()
    pad = 3 if layout == "sliced" else 0
    info = torch.randn(R, t + pad, n2, generator=gen, device="cuda")[:, pad:]
    logZ = torch.randn(R, t + pad, generator=gen, device="cuda")[:, pad:]
    return P, info, logZ


def contract_sweep(torch, gl, gamma):
    """K4b (K5b with ``gamma``) over CONTRACT_SWEEP against its plain version
    (``check_k4_level``) and the float64 plain version (each output within
    1e-4 of its largest entry plus 1e-5), two launches bitwise equal;
    returns the largest error to float64 over each output's largest entry,
    the kernel's and the float32 plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {"kernel": 0.0, "plain": 0.0}
    for R, t, n, layout in CONTRACT_SWEEP:
        args = contract_inputs(torch, gen, R, t, n, layout)
        if gamma:
            args += (2.0 + torch.randint(0, 4, (R, t), generator=gen, device="cuda").float(),
                     1.0 + torch.rand(R, t, generator=gen, device="cuda"))
            kernel, plain = gl._gamma_contract_cuda, gl.gamma_contract_pairs_plain
        else:
            def kernel(*a):
                out = gl._contract_cuda(*a, True)
                return out[:3] + out[3]

            def plain(*a):
                out = gl.contract_pairs_plain(*a, tape=True)
                return out[:3] + out[3]
        label = f"{'gamma_' if gamma else ''}contract sweep R={R} t={t} n={n} {layout}"
        outs_k, outs_p, again = kernel(*args), plain(*args), kernel(*args)
        check_k4_level(label, outs_k, outs_p)
        check(all(torch.equal(a, b) for a, b in zip(outs_k, again)), f"{label}: two launches differ")
        if gamma:
            check(torch.equal(outs_k[3], outs_p[3]), f"{label}: alpha' differs from the plain version's")
        for j, ref in enumerate(plain(*(a.double() for a in args))):
            scale = float(ref.abs().max())
            for who, outs in (("kernel", outs_k), ("plain", outs_p)):
                e = max_err(outs[j].double(), ref)
                check(who == "plain" or e <= 1e-4 * scale + 1e-5, f"{label} output {j}: {e:.3g} from float64")
                worst[who] = max(worst[who], e / max(scale, 1e-30))
    print(f"  {'K5b' if gamma else 'K4b'} n-sweep ({len(CONTRACT_SWEEP)} cases, n 1-32, t 2-4001, strided and "
          f"stride-0 P): to float64, times each output's max, kernel {worst['kernel']:.2g}, plain float32 "
          f"{worst['plain']:.2g}; two launches bitwise equal")
    return worst


def device_ms_passes(torch, kernel, calls, name, passes=3, warm_up_s=0.2):
    """The profiler's device ms of the kernels whose name holds ``name``,
    call by call, over each of the last ``passes`` passes over the recorded
    levels ``calls`` in one profiled window (one such kernel a call).
    Warm-up passes come first, for ``warm_up_s`` seconds at least: late in
    this script a profiling window loses the kernel events of its first few
    milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm, start = 0, time.perf_counter()
        while warm < 1 or time.perf_counter() - start < warm_up_s:
            for args in calls:
                kernel(*args)
            torch.cuda.synchronize()
            warm += 1
        for _ in range(passes):
            for args in calls:
                kernel(*args)
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    m = len(calls)
    check(len(times) >= passes * m, f"profiler: {len(times)} {name} kernels of {(warm + passes) * m}")
    times = times[len(times) - passes * m:]
    return [times[i * m:(i + 1) * m] for i in range(passes)]


def levels_device_ms(torch, kernel, calls, name, label, pairs):
    """The profiler's device ms of the kernel whose name holds ``name`` over
    the recorded levels ``calls``: the median of three passes' sums, and
    each level's median, printed beside its ``pairs``; returns the sum."""
    passes = device_ms_passes(torch, kernel, calls, name)
    device = sorted(sum(p) for p in passes)[1]
    by_level = [sorted(p[i] for p in passes)[1] for i in range(len(calls))]
    print(f"    {label} device ms a level (pairs): " + ", ".join(f"{x:.4f} ({q})" for x, q in zip(by_level, pairs)))
    return device


def halving_device_ms(torch, kernel, calls, label):
    """K4a's or K5a's (``gl_halving_kernel``) ``levels_device_ms``."""
    pairs = [args[1].shape[0] * (args[1].shape[1] // 2) for args in calls]
    return levels_device_ms(torch, kernel, calls, "gl_halving_kernel", label, pairs)


def contract_device_ms(torch, kernel, calls, passes=3):
    """The profiler's device ms of the contraction kernel over one pass of
    the recorded levels ``calls``: the median of the last ``passes`` passes,
    each pass the sum of its launches' kernel times."""
    sums = sorted(sum(p) for p in device_ms_passes(torch, kernel, calls, "gl_contract_kernel", passes))
    return sums[passes // 2]


def k4_bounds(name, args):
    """(flops, bytes) of one K4 launch at ``args`` (a backward: one level's
    call of the wrapper): each input read once, each output written once;
    the flops of the factorisations, the solves and the products as the
    kernel does them."""
    if name == "halving":
        P, info, logZ, tape = args
        R, two_m, n2 = info.shape
        n, pairs = n2 // 2, R * (two_m // 2)
        flops = (n**3 / 3 + 2 * n**3 + 8 * n**3) + pairs * (5 * n * n + 6 * n)
        floats = 2 * n2 * n2 + n * n + R * two_m * (n2 + 1) + pairs * (n2 + 1 + (n if tape else 0))
    elif name == "contract":
        # an input read once: its distinct elements (a stride-0 dim counts once)
        P, info, logZ, tape = args
        *lead, t, n2, _ = P.shape
        R = math.prod(lead)
        n, pairs, t_out = n2 // 2, R * (t // 2), R * (t - t // 2)
        flops = pairs * (n * n + n**3 / 3 + n * n * (n2 + 1) + 4 * n * n2 * n + 4 * n * n + 2 * n)
        floats = sum(map(distinct, (P, info, logZ))) + t_out * (n2 * n2 + n2 + 1) + (
            pairs * 3 * n * n + pairs * n if tape else 0)
    elif name in ("gamma_halving", "gamma_contract"):
        # K4a's or K4b's work without a tape, with alpha and beta read per
        # factor and written per pair
        P, info, logZ, alpha, beta = args
        flops, nbytes = k4_bounds(name[len("gamma_"):], (P, info, logZ, False))
        R, t = math.prod(alpha.shape[:-1]), alpha.shape[-1]
        return flops, nbytes + 4 * (distinct(alpha) + distinct(beta) + 2 * R * (t - t // 2))
    elif name == "halving_bwd":
        P, L, ib, g_P, g_info, g_logZ = args
        R, m, n = ib.shape
        pairs = R * m
        # per pair: two substitutions, Kt gi', the rows of s gi'^T and g_ib s^T;
        # once: Kt, Kt (gP' + gP'^T), L^-T gKt, gCt Kt^T and the Cholesky adjoint
        flops = pairs * (12 * n * n + 4 * n) + 17 * n**3
        floats = 3 * 4 * n * n + n * n + pairs * (n + 2 * n + 1) + pairs * 2 * (2 * n + 1)
    elif name == "contract_bwd":
        t, L, P_mk, i_m, g_P, g_info, g_logZ = args
        R, np_, n, _ = L.shape
        pairs, t_out = R * np_, R * (t - np_)
        # per pair: X, [gX1 | gx2], L^-T of it, tril(gB X^T), the Cholesky adjoint
        flops = pairs * (17 * n**3 + 12 * n * n)
        floats = pairs * (n * n + 2 * n * n + n) + t_out * (4 * n * n + 2 * n + 1) + R * t * (4 * n * n + 2 * n + 1)
    else:
        cur, L, P_mk, i_m, eps = args
        D, R, m, n = cur.shape
        Np = i_m.shape[-2]
        items = D * R * Np
        flops = items * (6 * n * n + n)
        floats = D * R * m * n + L.numel() + P_mk.numel() + i_m.numel() + eps.numel() + D * R * (m + Np) * n
    return flops, 4 * floats


def check_k4_level(label, outs_k, outs_p):
    """Each output of a K4 launch within 1e-4 times its largest entry plus
    1e-5 of the plain version's; returns the largest abs error."""
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        if b is None:
            continue
        check(a.shape == b.shape and bool(a.isfinite().all()), f"{label}: bad output {tuple(a.shape)}")
        e = max_err(a, b)
        check(e <= 1e-4 * float(b.abs().max()) + 1e-5, f"{label}: max abs err {e:.3g} over 1e-4 * {float(b.abs().max()):.3g}")
        err = max(err, e)
    return err


def counted(torch, gl, label, fn, keys, total=None):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; the counts of ``keys`` printed and added into ``total``."""
    gl.reset_counts()
    value = fn()
    torch.cuda.synchronize()
    counts = {k: gl.launches[k] for k in keys}
    if total is not None:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    print(f"    {label}: launches {counts}")
    return value, counts


def phase_k4(torch, gl):
    """Phase 8: each K4 kernel against its plain version at every level of
    the slice's calls (the level inputs recorded from one call through the
    kernels), then the call's levels timed kernel against plain in turns,
    beside their bound."""
    print("phase 8: K4 kernels (halving, contract, mids) against their plain versions at the slice's levels")
    models = slice_models(torch)
    hom, hom_data = models["homogeneous"]
    het, het_data = models["heterogeneous"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        with record_levels(gl, "halving_level") as halving:
            hom.log_prob(hom_data)
        with record_levels(gl, "contract_pairs") as contract, record_levels(gl, "level_mids") as mids:
            het.rsample_posterior(het_data, gen, (GFS_DRAWS,))
        torch.cuda.synchronize()
        levels = {
            "halving": (halving, gl._halving_cuda, gl.halving_level_plain,
                        f"homogeneous log_prob at {GHMM_SIG}"),
            "contract": (contract, gl._contract_cuda, gl.contract_pairs_plain,
                         f"heterogeneous rsample_posterior's forward at {GFS_SIG}, with the tape"),
            "mids": (mids, gl._mids_cuda, gl.level_mids_plain,
                     f"heterogeneous rsample_posterior's descent at {GFS_SIG}"),
        }
        result = {}
        for name, (calls, kernel, plain, where) in levels.items():
            check(calls, f"no {name} level was recorded")
            err = 0.0
            for i, args in enumerate(calls):
                outs_k, outs_p = kernel(*args), plain(*args)
                if name == "contract":
                    outs_k = outs_k[:3] + tuple(outs_k[3] or ())
                    outs_p = outs_p[:3] + tuple(outs_p[3] or ())
                elif name == "mids":
                    check(torch.equal(outs_k, kernel(*args)), f"mids level {i}: two launches differ")
                    outs_k, outs_p = (outs_k,), (outs_p,)
                err = max(err, check_k4_level(f"{name} level {i}", outs_k, outs_p))
            t = alternate({
                "kernel": lambda: [kernel(*args) for args in calls],
                "plain": lambda: [plain(*args) for args in calls],
            }, iters=5)
            flops = sum(k4_bounds(name, args)[0] for args in calls)
            nbytes = sum(k4_bounds(name, args)[1] for args in calls)
            b = bound(flops, nbytes)
            first = calls[0][1 if name != "mids" else 0]
            device = ""
            if name == "contract":
                device = f", profiler {contract_device_ms(torch, kernel, calls):.4f} device ms"
            elif name == "halving":
                device = f", profiler {halving_device_ms(torch, kernel, calls, 'K4a'):.4f} device ms"
            else:
                pairs = [args[3].shape[0] * args[3].shape[1] for args in calls]
                ms = levels_device_ms(torch, kernel, calls, "gl_mids_kernel", "K4c", pairs)
                device = f", profiler {ms:.4f} device ms"
            equal = "; two launches bitwise equal" if name == "mids" else ""
            print(f"  {name} over the {len(calls)} levels of the {where} (first level's input "
                  f"{tuple(first.shape)}): max abs err {err:.3g}{equal}; kernel {t['kernel']:.4f} ms{device}, plain "
                  f"{t['plain']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB)")
            result[name] = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"], "bound": b,
                            "levels": len(calls)}
        contract_sweep(torch, gl, gamma=False)
    return result


def phase_gaussian_slice(torch, gl):
    """Phase 9: the slice through its entry points, each call's K4 launches
    counted, each result against the port's plain levels in float64."""
    print(f"phase 9: GaussianHMM log_prob at {GHMM_SIG} and {GFS_SIG}, rsample_posterior with {GFS_DRAWS} draws")
    from pyro_tpu_torch.ops import gaussian as tg

    models = slice_models(torch)
    models64 = slice_models(torch, torch.float64)
    hom, hom_data = models["homogeneous"]
    het, het_data = models["heterogeneous"]
    launches = {"halving": 0, "contract": 0, "mids": 0}
    out = {}

    def counted_k4(label, fn):
        return counted(torch, gl, label, fn, tuple(launches), launches)

    def rel_check(label, got, ref, rtol):
        rel = float(((got.double() - ref).abs() / ref.abs()).max())
        print(f"  {label}: {got.cpu().tolist()} against float64 {ref.cpu().tolist()}, max rel diff {rel:.3g}")
        check(bool(torch.isfinite(got).all()) and rel <= rtol, f"{label}: rel diff {rel:.3g} over {rtol}")

    with torch.no_grad():
        # homogeneous log_prob: the bench's 10 chained calls
        def chained():
            acc = torch.zeros((), device="cuda")
            for _ in range(GHMM_CALLS):
                acc = acc + hom.log_prob(hom_data + 1e-6 * acc).sum()
            return acc

        chained()
        torch.cuda.synchronize()
        times = []
        for rep in range(3):
            t0 = time.perf_counter()
            acc, counts = counted_k4(f"homogeneous log_prob, {GHMM_CALLS} chained calls (rep {rep})", chained)
            times.append(time.perf_counter() - t0)
            check(counts["halving"] > 0 and math.isfinite(float(acc)), f"homogeneous log_prob: {counts}, acc {acc}")
        seqs = GHMM_CALLS * hom_data.shape[0]
        print(f"  homogeneous log_prob: {[round(1e3 * t / GHMM_CALLS, 3) for t in times]} ms a call, "
              f"{seqs / min(times):.1f} sequences/s at best ({seqs} sequences a rep)")
        out["ghmm_seq_per_s"] = seqs / min(times)
        lp, _ = counted_k4("homogeneous log_prob, checked", lambda: hom.log_prob(hom_data))
        with plain_levels(gl):
            lp64 = models64["homogeneous"][0].log_prob(models64["homogeneous"][1])
        rel_check("homogeneous log_prob", lp, lp64, GHMM_RTOL)

        # heterogeneous log_prob
        lp, counts = counted_k4("heterogeneous log_prob", lambda: het.log_prob(het_data))
        check(counts["contract"] > 0, f"heterogeneous log_prob: {counts}")
        with plain_levels(gl):
            lp64 = models64["heterogeneous"][0].log_prob(models64["heterogeneous"][1])
        rel_check("heterogeneous log_prob", lp.reshape(1), lp64.reshape(1), GHMM_RTOL)
        t0 = time.perf_counter()
        for _ in range(GHMM_CALLS):
            het.log_prob(het_data)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / GHMM_CALLS
        print(f"  heterogeneous log_prob: {1e3 * dt:.3f} ms a call, {1 / dt:.1f} sequences/s")

        # heterogeneous rsample_posterior, 64 draws: the bench's 3 launches
        gen = torch.Generator(device="cuda").manual_seed(1)
        het.rsample_posterior(het_data, gen, (GFS_DRAWS,))
        torch.cuda.synchronize()
        times = []
        for rep in range(3):
            t0 = time.perf_counter()
            z, counts = counted_k4(f"rsample_posterior, {GFS_DRAWS} draws (rep {rep})",
                                lambda: het.rsample_posterior(het_data, gen, (GFS_DRAWS,)))
            times.append(time.perf_counter() - t0)
            check(counts["contract"] > 0 and counts["mids"] > 0, f"rsample_posterior: {counts}")
        T, hidden = het_data.shape[0], het._init.dim
        check(z.shape == (GFS_DRAWS, T, hidden) and bool(torch.isfinite(z).all()), f"draws {tuple(z.shape)}")
        print(f"  rsample_posterior: {[round(1e3 * t, 3) for t in times]} ms a call, "
              f"{GFS_DRAWS / min(times):.1f} draws/s at best")
        out["gfs_draws_per_s"] = GFS_DRAWS / min(times)

        # the posterior mean: the sampler at zero noise against float64, and
        # the 64 draws' mean against it in standard errors
        def posterior_mean(hmm, data, homogeneous):
            trans = hmm._conditioned(data)
            zeros = torch.zeros(trans.batch_shape[:-1] + (data.shape[-2] + 1, hmm._init.dim),
                                dtype=data.dtype, device="cuda")
            if homogeneous:
                return tg.sequential_gaussian_filter_sample_homogeneous(hmm._init, trans, noise=zeros)[..., 1:, :]
            return tg.sequential_gaussian_filter_sample(hmm._init, trans.expand(trans.batch_shape),
                                                        noise=zeros)[..., 1:, :]

        for config, homogeneous in (("heterogeneous", False), ("homogeneous", True)):
            hmm, data = models[config]
            mean, counts = counted_k4(f"{config} posterior mean (zero noise)",
                                   lambda: posterior_mean(hmm, data, homogeneous))
            with plain_levels(gl):
                mean64 = posterior_mean(*models64[config], homogeneous)
            err = max_err(mean.double(), mean64)
            scale = float(mean64.abs().max())
            print(f"  {config} posterior mean: max abs err to float64 {err:.3g} (max|mean| {scale:.3g})")
            check(err <= GFS_MEAN_TOL * scale, f"{config} posterior mean {err:.3g} from float64, over "
                                               f"{GFS_MEAN_TOL} * {scale:.3g}")
            if config == "heterogeneous":
                tstat = (z.double().mean(0) - mean64) / (z.double().std(0) / GFS_DRAWS**0.5)
                t_max, t_sq = float(tstat.abs().max()), float((tstat**2).mean())
                print(f"  {GFS_DRAWS} draws' mean against it: max |t| {t_max:.3g} over {tstat.numel()} entries, "
                      f"mean t^2 {t_sq:.4f}")
                check(t_max < GFS_T_MAX and 0.8 < t_sq < 1.25,
                      f"draws' mean: max |t| {t_max:.3g} (limit {GFS_T_MAX}), mean t^2 {t_sq:.4f} (limits 0.8, 1.25)")
        zh, counts = counted_k4("homogeneous rsample_posterior, 4 draws",
                             lambda: hom.rsample_posterior(hom_data, gen, (4,)))
        check(counts["halving"] > 0 and counts["mids"] > 0 and bool(torch.isfinite(zh).all()),
              f"homogeneous rsample_posterior: {counts}")

    for label, fn in (("homogeneous log_prob", lambda: hom.log_prob(hom_data)),
                      ("heterogeneous log_prob", lambda: het.log_prob(het_data)),
                      ("rsample_posterior", lambda: het.rsample_posterior(het_data, gen, (GFS_DRAWS,)))):
        print(f"  {label}, one call:")
        with torch.no_grad():
            wall, busy, _, _ = profile_run(torch, fn, top=5)
        out[f"busy_share {label}"] = busy / wall
    print(f"  K4 launches over phase 9: {launches}")
    check(all(v > 0 for v in launches.values()), f"a K4 kernel was never launched: {launches}")
    out["launches"] = launches
    return out


# -- slice 7: training through K4 ---------------------------------------------------


def _no_guide(*args):
    return None


def train_paths(torch, dtype=None):
    """The two training paths at full width, {path: (model, data)} on the
    card, float32 unless ``dtype`` is given: ``lgssm`` (GenericLGSSM, obs 4,
    state 16, on the T=4000 series of ``examples/lgssm.py``; K4b) and
    ``homogeneous`` (the ``--train`` model of ``examples/gaussian_hmm.py``
    at 8.10000.32.4; K4a).  Their params register at the first run."""
    from pyro_tpu_torch.contrib.timeseries import GenericLGSSM
    from pyro_tpu_torch.examples import gaussian_hmm as example
    from pyro_tpu_torch.examples import lgssm

    dtype = dtype or torch.float32
    targets = lgssm.make_targets(0, dtype)
    params = example.params_from_jax(example.make_arrays("homogeneous", 0), dtype)
    data = params.pop("data")
    model = GenericLGSSM(obs_dim=lgssm.OBS_DIM, state_dim=lgssm.STATE_DIM, name="GenericLGSSM")
    return {"lgssm": (lgssm.make_model(model), targets), "homogeneous": (example.make_train_model(params), data)}


def _sym_p(grads):
    """A backward's (gP, ginfo, glogZ) with gP symmetrised."""
    gP, *rest = grads
    return (0.5 * (gP + gP.transpose(-1, -2)), *rest)


TRAIN_KERNELS = {"lgssm": ("contract", "_contract_bwd_cuda", "contract_pairs_bwd_plain"),
                 "homogeneous": ("halving", "_halving_bwd_cuda", "halving_level_bwd_plain")}


def phase_k4_backward(torch, gl):
    """Phase 10: the K4a and K4b backward kernels against their plain
    versions at every level of one training step's backward (the levels'
    tapes and upstream gradients recorded from a step through the kernels),
    then the step's levels timed kernel against plain in turns, beside
    their bound."""
    print("phase 10: K4a and K4b backward kernels against their plain versions at a training step's levels")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.infer import Trace_ELBO

    result = {}
    for path, (name, kernel_name, plain_name) in TRAIN_KERNELS.items():
        pyro.clear_param_store()
        model, data = train_paths(torch)[path]
        gl.reset_counts()
        with record_levels(gl, kernel_name) as calls:
            Trace_ELBO().differentiable_loss(model, _no_guide, data).backward()
        torch.cuda.synchronize()
        check(calls, f"no {name} backward level was recorded")
        check(gl.launches[f"{name}_bwd"] == len(calls),
              f"{name} backward: {gl.launches[f'{name}_bwd']} launches for {len(calls)} levels")
        kernel, plain = getattr(gl, kernel_name), getattr(gl, plain_name)
        err = 0.0
        with torch.no_grad():
            for i, args in enumerate(calls):
                err = max(err, check_k4_level(f"{name} backward level {i}", _sym_p(kernel(*args)), _sym_p(plain(*args))))
            again = [kernel(*calls[0]), kernel(*calls[0])]
            check(all(torch.equal(a, b) for a, b in zip(*again)), f"{name} backward: two runs differ")
            t = alternate({
                "kernel": lambda: [kernel(*args) for args in calls],
                "plain": lambda: [plain(*args) for args in calls],
            }, iters=5)
            # the backward kernel's device ms, level by level
            if name == "halving":
                pairs = [args[2].shape[0] * args[2].shape[1] for args in calls]
            else:
                pairs = [args[1].shape[0] * args[1].shape[1] for args in calls]
            device = levels_device_ms(torch, kernel, calls, f"gl_{name}_bwd_kernel", f"{name} backward", pairs)
        flops = sum(k4_bounds(f"{name}_bwd", args)[0] for args in calls)
        nbytes = sum(k4_bounds(f"{name}_bwd", args)[1] for args in calls)
        b = bound(flops, nbytes)
        print(f"  {name} backward over the {len(calls)} levels of a {path} training step: max abs err {err:.3g} "
              f"(P gradients symmetrised), two runs bitwise equal; kernel {t['kernel']:.4f} ms, profiler "
              f"{device:.4f} device ms, plain {t['plain']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: "
              f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB)")
        result[f"{name}_bwd"] = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"], "bound": b,
                                 "levels": len(calls)}
    pyro.clear_param_store()
    return result


def _loss_and_grads(torch, model, data):
    """-ELBO of ``model`` (empty guide) and the gradient of every
    unconstrained parameter, as float64."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.infer import Trace_ELBO

    with poutine.trace(param_only=True) as capture:
        loss = Trace_ELBO().differentiable_loss(model, _no_guide, data)
    loss.backward()
    store = pyro.get_param_store()
    return float(loss.detach()), {k: store.get_unconstrained(k).grad.double() for k in capture.trace.param_nodes()}


def first_step(torch, gl, path):
    """The first step's -ELBO and gradients through the kernels in float32,
    then through the plain levels in float64 on the card at the same
    parameters."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.params import param_store_from_jax

    pyro.clear_param_store()
    model, data = train_paths(torch)[path]
    loss32, g32 = _loss_and_grads(torch, model, data)
    store = pyro.get_param_store()
    param_store_from_jax({k: store[k].detach().double().cpu().numpy() for k in g32})
    model, data = train_paths(torch, torch.float64)[path]
    with plain_levels(gl):
        loss64, g64 = _loss_and_grads(torch, model, data)
    pyro.clear_param_store()
    return (loss32, g32), (loss64, g64)


def phase_train(torch, gl):
    """Phase 11: both training paths through their entry points, 5 SVI
    steps each: finite losses, the first step's loss and gradients against
    float64, the K4 forward and backward kernels launched in every step."""
    print(f"phase 11: SVI through K4, {TRAIN_STEPS} steps each: lgssm (GenericLGSSM, T=4000, state 16, obs 4) "
          f"and homogeneous --train at {GHMM_SIG}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import gaussian_hmm as example

    launches, out = {}, {}
    for path, (name, _, _) in TRAIN_KERNELS.items():
        (loss32, g32), (loss64, g64) = first_step(torch, gl, path)
        rel = abs(loss32 - loss64) / abs(loss64)
        print(f"  {path} first step: loss {loss32!r} against float64 {loss64!r} (rel diff {rel:.3g})")
        check(math.isfinite(loss32) and rel <= TRAIN_LOSS_RTOL, f"{path}: loss rel diff {rel:.3g} over {TRAIN_LOSS_RTOL}")
        for k in sorted(g64):
            err, scale = max_err(g32[k], g64[k]), float(g64[k].abs().max())
            print(f"    grad {k} {tuple(g64[k].shape)}: max abs err to float64 {err:.3g} (max|grad| {scale:.3g})")
            check(bool(g32[k].isfinite().all()) and err <= TRAIN_GRAD_TOL * scale,
                  f"{path} grad {k}: {err:.3g} from float64, over {TRAIN_GRAD_TOL} * {scale:.3g}")

        pyro.clear_param_store()
        model, data = train_paths(torch)[path]
        svi = example.make_train_svi(model)
        losses, ms, counts = [], [], {name: 0, f"{name}_bwd": 0}
        for step in range(TRAIN_STEPS):
            gl.reset_counts()
            t0 = time.perf_counter()
            losses.append(svi.step(data))
            ms.append(1e3 * (time.perf_counter() - t0))
            step_counts = dict(gl.launches)
            check(step_counts[name] > 0 and step_counts[f"{name}_bwd"] > 0 and math.isfinite(losses[-1]),
                  f"{path} step {step}: loss {losses[-1]}, launches {step_counts}")
            for k in counts:
                counts[k] += step_counts[k]
        steady = sum(ms[1:]) / (TRAIN_STEPS - 1)
        print(f"  {path}: losses {losses}; set-up (first step) {ms[0]:.3f} ms, steady {steady:.3f} ms a step "
              f"({[round(x, 3) for x in ms[1:]]}); launches over the {TRAIN_STEPS} steps {counts}")
        launches.update(counts)
        print(f"  {path}, one more step:")
        wall, busy, _, _ = profile_run(torch, lambda: svi.step(data), top=6)
        out[path] = {"setup_ms": ms[0], "step_ms": steady, "busy_share": busy / wall}
    pyro.clear_param_store()
    out["launches"] = launches
    return out


# -- slice 8: K2g, the time-varying scan; the pairwise fallback; pyro.markov --

K2G_TOL = 1e-3  # each K2g gradient against the float64 plain version, times its max|grad|
K2G_SEEDS = 5  # seeds of the unreachable-states data
TV_STEPS = 5
M5_X, M5_STEPS = 16, 3  # model_5's hidden dim at full width (the 20.32.51.16 row's), its SVI steps
M1_B, M1_T, M1_S, M1_STEPS = 20, 32, 16, 3  # model_1 at the hmm_enum_steps_per_sec row, 20.32.51.16


def tv_inputs(torch, gen, B, T, S, per_row=False, with_L=False, unreachable=False, emission=0.0):
    """alpha0, A_t (log transition probabilities, shared or one per row), R
    and L on the card, drawn from ``gen``; with ``unreachable``, -inf
    entries, a column no state reaches at every third step and half of
    alpha0's states -inf."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    A = torch.log_softmax(randn(*((T, B, S, S) if per_row else (T, S, S))) * 2.0, dim=-1)
    alpha0 = randn(B, S)
    if unreachable:
        A[A < -6.0] = -float("inf")
        A[::3, ..., :, S // 3] = -float("inf")
        alpha0[:, S // 2:] = -float("inf")
    R = randn(T, B, S) * (3.0 if emission else 1.0) + emission
    L = randn(T, B, S) if with_L else None
    return [alpha0, A, R, L], randn(B, S)


def underflow_inputs(torch, gen, B, T, S, per_row=False):
    """alpha0, A_t and R on which K2g's factored sum is 0 at the even columns
    of every step while the true value is finite: hs peaks at l = 0 (R keeps
    state 0 about 200 above the others) and A_t[0, r] is about -200 at the
    even columns, where the other l have log-weights of order 1."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    A = randn(*((T, B, S, S) if per_row else (T, S, S))) * 2.0
    A[..., 0, 0::2] = randn(*A[..., 0, 0::2].shape) - 200.0
    R = randn(T, B, S)
    R[..., 1::2] -= 400.0
    R[..., 2::2] -= 200.0
    alpha0 = randn(B, S) - 200.0
    alpha0[:, 0] = 0.0
    return [alpha0, A, R, None], randn(B, S)


def tv_plan(ms, inputs, route):
    """The plan that runs K2g on ``route``: None where the wrapper chooses
    that route, else the streaming route forced (the cluster route is never
    forced: a shape it cannot take fails the check)."""
    alpha0, A = inputs[0], inputs[1]
    B, S = alpha0.shape
    chosen = ms._device_plan_tv(B, S, 1 if A.ndim == 3 else B, alpha0.device)
    if chosen.route == route:
        return None
    check(route == "stream", f"K2g at B={B}, S={S}: the wrapper chose {chosen}, not the {route} route")
    return ms.ScanPlan("stream")


def check_k2g(torch, ms, inputs, g, label, route):
    """K2g forward and the gradients of all its inputs against the plain
    version in float64 on the card (-inf exactly where it is -inf, finite
    values within atol 1e-4 + rtol 1e-6, each gradient finite and within
    K2G_TOL * max|grad|), and against the plain version in float32 (printed);
    one launch each way, on ``route``.  Returns the largest forward and
    gradient distances to the float32 plain version."""
    plan = tv_plan(ms, inputs, route)
    label = f"{label} [{route}]"
    n, on_route = dict(ms.tv_launches), dict(ms.tv_route_launches[route])
    leaves = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
    out = ms.markov_scan_tv(*leaves, plan=plan)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    check(ms.tv_launches == {"forward": n["forward"] + 1, "backward": n["backward"] + 1},
          f"{label}: expected one K2g launch each way, got {ms.tv_launches} after {n}")
    check(ms.tv_route_launches[route] == {"forward": on_route["forward"] + 1, "backward": on_route["backward"] + 1},
          f"{label}: expected one launch each way on the {route} route, got {ms.tv_route_launches}")
    runs = {}
    for dtype in (torch.float32, torch.float64):
        lv = [None if t is None else t.detach().to(dtype).requires_grad_() for t in inputs]
        o = ms.markov_scan_tv_plain(*lv)
        (o * g.to(dtype)).sum().backward()
        runs[dtype] = (o.detach(), [None if t is None else t.grad for t in lv])
    (out32, grads32), (out64, grads64) = runs[torch.float32], runs[torch.float64]
    out = out.detach()
    check(torch.equal(torch.isneginf(out), torch.isneginf(out64)) and not bool(torch.isnan(out).any()),
          f"{label}: the -inf entries differ from float64's, or NaN")
    live = torch.isfinite(out64)
    fwd_excess = float(((out.double() - out64).abs() - (1e-4 + 1e-6 * out64.abs()))[live].max())
    check(fwd_excess <= 0, f"{label}: forward outside atol 1e-4 + rtol 1e-6 of float64 by {fwd_excess:.3g}")
    fwd_err = float((out - out32)[live].abs().max())
    bwd_err, errs, failures = 0.0, [], []
    for name, k, p, d in zip(("alpha0", "A", "R", "L"), leaves, grads32, grads64):
        if k is None:
            continue
        if not bool(torch.isfinite(k.grad).all()):
            failures.append(f"non-finite d{name}")
            continue
        scale = float(d.abs().max()) + 1e-30
        err = float((k.grad.double() - d).abs().max()) / scale
        errs.append(f"d{name} {err:.3g} (plain f32 {float((p.double() - d).abs().max()) / scale:.3g})")
        bwd_err = max(bwd_err, max_err(k.grad, p))
        if err > K2G_TOL:
            failures.append(f"d{name} is {err:.3g} * max|grad| from float64, over {K2G_TOL}")
    print(f"  {label}: forward max abs err to plain {fwd_err:.3g} ({int((~live).sum())} entries -inf); "
          f"to float64 over max|grad|: {', '.join(errs)}")
    check(not failures, f"{label}: " + "; ".join(failures))
    return fwd_err, bwd_err


def k2g_bounds(steps, B, S, nA):
    """K2g's least times on the card, forward and backward.  Forward: each
    of T'*B*S*S terms added and accumulated (2 operations); bytes: alpha0,
    A_t, R in, alpha_T' out.  Backward: the same per product, two of them
    (dh and dA_t); bytes: A_t, the forward's two stacks and g in, dalpha0,
    dA_t and dR out."""
    terms = steps * B * S * S
    a = nA * steps * S * S
    return (bound(2 * terms, 4 * (2 * B * S + a + steps * B * S)),
            bound(4 * terms, 4 * (2 * B * S + 2 * a + 3 * steps * B * S)))


def phase_k2g(torch, ms):
    print("phase 12: K2g, the time-varying Markov scan, against its plain version (float64 and float32) on the card, "
          "both routes")
    gen = torch.Generator(device="cuda").manual_seed(12)
    steps = T - 1
    main, g = tv_inputs(torch, gen, B, steps, S, emission=EMISSION)
    shape = f"model_1vt's shape B={B}, T'={steps}, S={S}, A_t shared"
    errs = {route: check_k2g(torch, ms, main, g, shape, route) for route in ("cluster", "stream")}
    cases = [(tv_inputs(torch, gen, *args), label) for args, label in (
        ((8, 63, 64, True), "one A_t per row, B=8, T'=63, S=64"),
        ((4, 9, 7, False, True), "odd S=7 with L, B=4, T'=9"),
        ((2, 5, 257, True), "odd S=257, one A_t per row, B=2, T'=5"),
        ((5, 1, 33, False, True), "T'=1 with L, B=5, S=33"),
    )]
    for seed in range(K2G_SEEDS):
        gs = torch.Generator(device="cuda").manual_seed(1200 + seed)
        cases.append((tv_inputs(torch, gs, B, steps, S, unreachable=True, emission=EMISSION),
                      f"seed {1200 + seed}: B={B}, T'={steps}, S={S}, unreachable states and -inf columns"))
    for per_row, (b_, t_, s_) in ((False, (B, 31, S)), (True, (4, 9, 64))):
        cases.append((underflow_inputs(torch, gen, b_, t_, s_, per_row),
                      f"underflow: hs and A_t peak at different l, B={b_}, T'={t_}, S={s_}"
                      f"{', one A_t per row' if per_row else ''}"))
    for (inputs, g_), label in cases:
        for route in ("cluster", "stream"):
            check_k2g(torch, ms, inputs, g_, label, route)
    # the backward twice on the same inputs, on each route: bitwise equal
    alpha0, A, R, _ = main
    saved = {}
    with torch.no_grad():
        for route in ("cluster", "stream"):
            saved[route] = ms._tv_forward_cuda(alpha0, A, R, plan=tv_plan(ms, main, route))[1]
            check(saved[route][0].route == route, f"K2g: {saved[route][0]} is not the {route} route")
    for route, sv in saved.items():
        again = [ms._tv_backward_cuda(A, None, sv, g), ms._tv_backward_cuda(A, None, sv, g)]
        check(all(torch.equal(a, b) for a, b in zip(*again) if a is not None),
              f"K2g backward [{route}]: two runs differ")
    # timing at model_1vt's shape: both routes and the plain version in turns
    stream = ms.ScanPlan("stream")
    with torch.no_grad():
        fwd = alternate({"cluster": lambda: ms._tv_forward_cuda(alpha0, A, R),
                         "stream": lambda: ms._tv_forward_cuda(alpha0, A, R, plan=stream),
                         "plain": lambda: ms.markov_scan_tv_plain(alpha0, A, R)}, iters=5)
    leaves = [t.detach().clone().requires_grad_() for t in (alpha0, A, R)]
    out_p = ms.markov_scan_tv_plain(*leaves)
    bwd = alternate({"cluster": lambda: ms._tv_backward_cuda(A, None, saved["cluster"], g),
                     "stream": lambda: ms._tv_backward_cuda(A, None, saved["stream"], g),
                     "plain": lambda: torch.autograd.grad(out_p, leaves, g, retain_graph=True)}, iters=5)
    fb, bb = k2g_bounds(steps, B, S, 1)
    print(f"  two runs of the backward bitwise equal on each route; timing at B={B}, T'={steps}, S={S} f32, "
          f"A_t shared ({4 * steps * S * S / 1e6:.1f} MB), plan {saved['cluster'][0]}:")
    for name, t, b in (("forward ", fwd, fb), ("backward", bwd, bb)):
        print(f"    {name} cluster {t['cluster']:.4f} ms ({1e3 * t['cluster'] / steps:.2f} us/step)  "
              f"stream {t['stream']:.4f} ms ({1e3 * t['stream'] / steps:.2f} us/step)  plain {t['plain']:.4f} ms  "
              f"bound {b[0]:.4f} ms ({b[1]})")
    return {f"{route}_{way}": {"max_abs_err": errs[route][i], "ms": t[route], "plain_ms": t["plain"], "bound": b}
            for route in ("cluster", "stream") for i, (way, t, b) in enumerate((("forward", fwd, fb),
                                                                                 ("backward", bwd, bb)))}


@contextlib.contextmanager
def default_dtype(torch, dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def enum_loss_and_grads(torch, model, guide, args, names, nesting, values=None):
    """-ELBO (TraceEnum_ELBO) and the gradients of ``names`` (as float64 on
    the CPU); with ``values``, the params are first set to them."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.infer import TraceEnum_ELBO

    elbo = TraceEnum_ELBO(max_plate_nesting=nesting)
    store = pyro.get_param_store()
    elbo.loss(model, guide, *args)  # registers the params
    for k, v in (values or {}).items():
        store.set_unconstrained(k, v.to(store.get_unconstrained(k).dtype))
    loss = elbo.differentiable_loss(model, guide, *args)
    loss.backward()
    grads = {k: store.get_unconstrained(k).grad.detach().double().cpu() for k in names}
    for k in names:
        store.get_unconstrained(k).grad = None
    return float(loss.detach()), grads


def check_grads(label, g32, g64, tol):
    for k in sorted(g64):
        err, scale = max_err(g32[k], g64[k]), float(g64[k].abs().max())
        print(f"    grad {k} {tuple(g64[k].shape)}: max abs err to float64 {err:.3g} (max|grad| {scale:.3g})")
        check(bool(g32[k].isfinite().all()) and err <= tol * scale,
              f"{label} grad {k}: {err:.3g} from float64, over {tol} * {scale:.3g}")


def phase_tv_slice(torch, lm, ms):
    print(f"phase 13: model_1vt SVI (a transition per step, TraceEnum_ELBO) at B={B}, T={T}, D={D}, S={S}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.ops import markov_product

    args = example.parse_args([
        "--model", "1vt", "--hidden-dim", str(S), "--num-sequences", str(B), "--max-length", str(T),
        "--data-dim", str(D), "--num-steps", str(TV_STEPS),
    ])
    names = ("AutoDelta.probs_x", "AutoDelta.probs_y")
    sequences, lengths = example.synthetic_sequences(args.seed, B, T, D)
    # the first step's loss and gradients through K2g, then through the
    # plain loop in float64 on the card at the same params
    pyro.clear_param_store()
    model, guide, _ = example.make_svi(args)
    loss32, g32 = enum_loss_and_grads(torch, model, guide, (sequences, lengths), names, 3)
    values = {k: pyro.get_param_store().get_unconstrained(k).detach().double() for k in names}
    pyro.clear_param_store()
    with default_dtype(torch, torch.float64):
        markov_product.markov_scan_tv = ms.markov_scan_tv_plain
        try:
            model, guide, _ = example.make_svi(args)
            loss64, g64 = enum_loss_and_grads(torch, model, guide, (sequences.double(), lengths), names, 3, values)
        finally:
            markov_product.markov_scan_tv = ms.markov_scan_tv
    rel = abs(loss32 - loss64) / abs(loss64)
    print(f"  first step: loss through K2g {loss32!r} against the plain loop in float64 {loss64!r} (rel diff {rel:.3g})")
    check(math.isfinite(loss32) and rel <= TRAIN_LOSS_RTOL, f"model_1vt: loss rel diff {rel:.3g} over {TRAIN_LOSS_RTOL}")
    check_grads("model_1vt", g32, g64, TRAIN_GRAD_TOL)

    pyro.clear_param_store()
    _, _, svi = example.make_svi(args, args.learning_rate)
    losses, step_ms, per_step = [], [], []
    for _ in range(TV_STEPS):
        ms.reset_counts()
        lm.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        losses.append(svi.step(sequences, lengths))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((dict(ms.tv_route_launches["cluster"]), dict(ms.tv_launches), dict(ms.launches),
                         dict(lm.launches)))
    steady = sum(step_ms[1:]) / (TV_STEPS - 1)
    print(f"  losses {losses}")
    print(f"  set-up (first step) {step_ms[0]:.3f} ms, steady {steady:.3f} ms a step ({[round(t, 3) for t in step_ms[1:]]})")
    print(f"  launches a step: K2g {per_step[0][1]} (cluster route {per_step[0][0]}), K2 {per_step[0][2]}, "
          f"K1 {per_step[0][3]}")
    check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0], f"model_1vt: losses {losses}")
    for cluster, tv, k2, k1 in per_step:
        check(tv == {"forward": 1, "backward": 1} and cluster == tv,
              f"model_1vt: expected one K2g launch each way a step on the cluster route, got {tv} ({cluster})")
        check(k2 == {"forward": 0, "backward": 0} and k1 == {"forward": 0, "backward": 0},
              f"model_1vt: expected no K2 or K1 launch, got K2 {k2}, K1 {k1}")
    print("  one more step:")
    wall, busy, ops, kernels = profile_run(torch, lambda: svi.step(sequences, lengths), top=6)
    k2g = [e for e in kernels if kernel_name(e).startswith(("mstv_", "mstvc_"))]
    k2g_ms = sum(e.self_device_time_total for e in k2g) / 1e3
    print(f"    K2g kernels {k2g_ms:.3f} ms of the busy time: "
          + ", ".join(f"{kernel_name(e)} {e.self_device_time_total / 1e3:.3f}" for e in k2g))
    pyro.clear_param_store()
    launches = {route: {k: sum(tv[k] for tv in counts) for k in ("forward", "backward")}
                for route, counts in (("cluster", [p[0] for p in per_step]),
                                      ("stream", [{k: p[1][k] - p[0][k] for k in p[1]} for p in per_step]))}
    return {"launches": launches, "setup_ms": step_ms[0], "step_ms": steady, "busy_share": busy / wall}


def phase_fallback(torch, lm, ms):
    print("phase 14: the vectorized chains of tests/test_vectorized_markov.py on the card (all routes), "
          f"model_5 (history 2) at x_dim {M5_X}, T={T}, D={D}, and model_1 (pyro.markov) at "
          f"{M1_B}.{M1_T}.{D}.{M1_S}")
    import functools

    import numpy as np

    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.examples import vectorized_markov as vm
    from pyro_tpu_torch.infer import SVI, TraceEnum_ELBO
    from pyro_tpu_torch.ops import markov_product
    from pyro_tpu_torch.optim import Adam

    def run_case(model, data_fn, args, device, dtype):
        """Loss and param gradients of the vectorized chain on ``device``,
        with the launches and routes it took."""
        pyro.set_default_device(device)
        with default_dtype(torch, dtype):
            pyro.clear_param_store()
            data = data_fn()
            ms.reset_counts()
            lm.launches.update(forward=0, backward=0)
            lm.reset_chain_counts()
            markov_product.reset_routes()
            with poutine.trace(param_only=True) as capture:
                loss = TraceEnum_ELBO(max_plate_nesting=3).differentiable_loss(model, vm.no_guide, data, *args)
            loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
            store = pyro.get_param_store()
            grads = {k: store.get_unconstrained(k).grad.detach().double().cpu() for k in capture.trace.param_nodes()}
            counts = {"routes": dict(markov_product.routes), "K1": dict(lm.launches), "K3f": dict(lm.chain_launches),
                      "K2": dict(ms.launches), "K2g": dict(ms.tv_launches)}
        pyro.clear_param_store()
        pyro.set_default_device("cuda")
        return float(loss.detach()), grads, counts

    # the pairwise fallback's windows hold at most 64 states in these cases:
    # their chains take K3f (at more states they would take K1 a round)
    kernel_of = {"scan": "K2", "general": "K2g", "pairwise": "K3f"}
    for model, kind, shape, history in vm.CASES:
        label = f"{model.__name__} T={shape[-2]} history {history}"
        data_fn = functools.partial(vm.make_data, kind, shape)
        loss32, g32, counts = run_case(model, data_fn, (history, True), "cuda", torch.float32)
        loss64, g64, _ = run_case(model, data_fn, (history, True), "cpu", torch.float64)
        route = vm.ROUTES[model]
        kern = counts[kernel_of[route]]
        rel = abs(loss32 - loss64) / abs(loss64)
        gerr = max(max_err(g32[k], g64[k]) / (float(g64[k].abs().max()) + 1e-30) for k in g64)
        print(f"  {label}: route {route}, launches {counts['K1']} K1, {counts['K3f']} K3f, {counts['K2']} K2, "
              f"{counts['K2g']} K2g; "
              f"loss {loss32:.6f} vs float64 CPU {loss64:.6f} (rel {rel:.3g}); grads to float64 over max|grad| {gerr:.3g}")
        check(counts["routes"][route] == 1 and kern["forward"] > 0 and kern["backward"] > 0,
              f"{label}: expected the {route} route through {kernel_of[route]}, got {counts}")
        check(rel <= 1e-5 and sorted(g32) == sorted(g64), f"{label}: loss rel diff {rel:.3g}")
        for k in g64:
            excess = float(((g32[k] - g64[k]).abs() - (1e-5 * float(g64[k].abs().max()) + 1e-4 * g64[k].abs())).max())
            check(bool(g32[k].isfinite().all()) and excess <= 0, f"{label} grad {k} outside tolerance by {excess:.3g}")

    # model_5 (a second-order chain) at full width: windows of 16^2 = 256
    # states, K1 at (63, 256, 256) in the first round
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(T, D))
    model5 = functools.partial(vm.model_5, x_dim=M5_X, y_dim=2)

    def data5():
        return torch.tensor(bits, dtype=torch.long, device=pyro.get_default_device())

    loss32, g32, counts = run_case(model5, data5, (2, True), "cuda", torch.float32)
    loss64, g64, _ = run_case(model5, data5, (2, True), "cpu", torch.float64)
    rel = abs(loss32 - loss64) / abs(loss64)
    print(f"  model_5 x_dim {M5_X}, T={T}, D={D}: first step loss {loss32!r} vs float64 CPU {loss64!r} (rel {rel:.3g}); "
          f"launches {counts}")
    check(counts["routes"]["pairwise"] == 1 and rel <= TRAIN_LOSS_RTOL, f"model_5: rel {rel:.3g}, {counts}")
    check_grads("model_5", g32, g64, TRAIN_GRAD_TOL)
    pyro.clear_param_store()
    svi = SVI(model5, vm.no_guide, Adam({"lr": 0.05}), TraceEnum_ELBO(max_plate_nesting=3))
    data = data5()
    losses, step_ms, k1 = [], [], []
    for _ in range(M5_STEPS):
        lm.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        losses.append(svi.step(data, 2, True))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        k1.append(dict(lm.launches))
    print(f"  model_5 SVI: losses {losses}; ms a step {[round(t, 3) for t in step_ms]} (the first with set-up); "
          f"K1 launches a step {k1}")
    check(all(math.isfinite(l) for l in losses) and all(k == k1[0] and k["forward"] > 0 and k["backward"] > 0
                                                        for k in k1), f"model_5: {losses}, {k1}")
    print("  model_5, one more step:")
    _, _, _, kernels = profile_run(torch, lambda: svi.step(data, 2, True), top=5)
    print(f"    K1 kernels {sum(e.self_device_time_total for e in kernels if 'lme_' in e.key) / 1e3:.3f} ms")
    pyro.clear_param_store()

    # model_1, unrolled under pyro.markov, at the hmm_enum_steps_per_sec row;
    # its step-0 loss against model_1v's (the vectorized chain) at the same params
    names = ("AutoDelta.probs_x", "AutoDelta.probs_y")
    argv = ["--hidden-dim", str(M1_S), "--num-sequences", str(M1_B), "--max-length", str(M1_T), "--data-dim", str(D)]
    args1 = example.parse_args(["--model", "1", *argv])
    sequences, lengths = example.synthetic_sequences(args1.seed, M1_B, M1_T, D)
    model, guide, svi = example.make_svi(args1, args1.learning_rate)
    loss1, _ = enum_loss_and_grads(torch, model, guide, (sequences, lengths), names, 2)
    values = {k: pyro.get_param_store().get_unconstrained(k).detach() for k in names}
    pyro.clear_param_store()
    model_v, guide_v, _ = example.make_svi(example.parse_args(["--model", "1v", *argv]))
    loss1v, _ = enum_loss_and_grads(torch, model_v, guide_v, (sequences, lengths), names, 3, values)
    rel = abs(loss1 - loss1v) / abs(loss1v)
    print(f"  model_1 at {M1_B}.{M1_T}.{D}.{M1_S}: step-0 loss {loss1!r}, model_1v at the same params {loss1v!r} "
          f"(rel {rel:.3g})")
    check(rel <= 1e-5, f"model_1 against model_1v: rel {rel:.3g}")
    pyro.clear_param_store()
    _, _, svi = example.make_svi(args1, args1.learning_rate)
    losses, step_ms, launches = [], [], []
    for _ in range(M1_STEPS):
        ms.reset_counts()
        lm.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        losses.append(svi.step(sequences, lengths))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({"K1": dict(lm.launches), "K2": dict(ms.launches), "K2g": dict(ms.tv_launches)})
    print(f"  model_1 SVI: losses {losses}; ms a step {[round(t, 3) for t in step_ms]} (the first with set-up); "
          f"launches a step {launches[-1]}")
    check(all(math.isfinite(l) for l in losses), f"model_1: losses {losses}")
    print("  model_1, one more step:")
    profile_run(torch, lambda: svi.step(sequences, lengths), top=5)
    pyro.clear_param_store()
    return {"model_5_k1": k1[0], "model_1": launches[-1]}


# -- slice 9: the Student-t state-space model (K5) and the rest of the family ---------

GGHMM_HET_SIG = "8.4000.16.4"
# log_prob against float64, times the sum of the magnitudes of its last terms:
# the log normaliser, lgamma(concentration) and concentration * log(rate),
# each near 2e5 at T=10000 (concentration 20002), which cancel to a result
# about a seventh of their sum; float32 rounds each term at about 1e-2
GGHMM_TERMS_RTOL = 1e-6
GGHMM_RATE_RTOL = 1e-4  # the filter's Gamma rate against float64 (a float32 tree sum of 10^4 steps' quadratics)
GGHMM_MVN_TOL = 1e-3  # the filter's mean and covariance against float64, times their largest entry
IHMM_CHANNELS, PREFIX_T = 4, 8000
K5_OUTPUTS = ("P'", "info'", "logZ'", "alpha'", "beta'")


def phase_k5(torch, gl):
    """Phase 15: K5a and K5b against their plain versions (and the float64
    plain version) at every level of the slice's calls, the level inputs
    recorded from one call through the kernels; then the call's levels timed
    kernel against plain in turns, beside their bound."""
    print("phase 15: K5a and K5b (gamma-Gaussian halving and contract) against their plain versions at the "
          "slice's levels")
    models = slice_models(torch, example_name="gamma_gaussian_hmm")
    hom, hom_data = models["homogeneous"]
    het, het_data = models["heterogeneous"]
    result = {}
    with torch.no_grad():
        with record_levels(gl, "gamma_halving_level") as halving:
            hom.log_prob(hom_data)
        with record_levels(gl, "gamma_contract_pairs") as contract:
            het.log_prob(het_data)
        with record_levels(gl, "gamma_contract_pairs") as filt:
            hom.filter(hom_data)
        torch.cuda.synchronize()
        sets = {
            "gamma_halving": (halving, gl._gamma_halving_cuda, gl.gamma_halving_level_plain,
                              f"homogeneous log_prob at {GHMM_SIG}"),
            "gamma_contract": (contract, gl._gamma_contract_cuda, gl.gamma_contract_pairs_plain,
                               f"heterogeneous log_prob at {GGHMM_HET_SIG}"),
            "gamma_contract_filter": (filt, gl._gamma_contract_cuda, gl.gamma_contract_pairs_plain,
                                      f"homogeneous filter at {GHMM_SIG} (n=32 over the expanded chain)"),
        }
        for name, (calls, kernel, plain, where) in sets.items():
            check(calls, f"no {name} level was recorded")
            err, to64 = 0.0, {"kernel": [0.0] * 5, "plain": [0.0] * 5}
            for i, args in enumerate(calls):
                outs_k, outs_p = kernel(*args), plain(*args)
                check(torch.equal(outs_k[3], outs_p[3]), f"{name} level {i}: alpha' differs from the plain version's")
                err = max(err, check_k4_level(f"{name} level {i}", outs_k, outs_p))
                outs_64 = plain(*(a.double() for a in args))
                for j, ref in enumerate(outs_64):
                    scale = float(ref.abs().max())
                    ek, ep = max_err(outs_k[j].double(), ref), max_err(outs_p[j].double(), ref)
                    check(ek <= 1e-4 * scale + 1e-5, f"{name} level {i} {K5_OUTPUTS[j]}: {ek:.3g} from float64, "
                                                     f"over 1e-4 * {scale:.3g}")
                    to64["kernel"][j] = max(to64["kernel"][j], ek / max(scale, 1e-30))
                    to64["plain"][j] = max(to64["plain"][j], ep / max(scale, 1e-30))
                del outs_k, outs_p, outs_64
            t = alternate({
                "kernel": lambda: [kernel(*args) for args in calls],
                "plain": lambda: [plain(*args) for args in calls],
            }, iters=5 if name != "gamma_contract_filter" else 2)
            flops = sum(k4_bounds(name[:14], args)[0] for args in calls)
            nbytes = sum(k4_bounds(name[:14], args)[1] for args in calls)
            b = bound(flops, nbytes)
            first = calls[0][1]
            device = (f", profiler {contract_device_ms(torch, kernel, calls):.4f} device ms"
                      if name.startswith("gamma_contract")
                      else f", profiler {halving_device_ms(torch, kernel, calls, 'K5a'):.4f} device ms")
            print(f"  {name[:14]} over the {len(calls)} levels of the {where} (first level's input "
                  f"{tuple(first.shape)}): alpha' exact, max abs err {err:.3g} to the plain version; to float64, "
                  f"times each output's max, kernel "
                  + ", ".join(f"{o} {e:.2g}" for o, e in zip(K5_OUTPUTS, to64["kernel"]))
                  + "; plain float32 " + ", ".join(f"{o} {e:.2g}" for o, e in zip(K5_OUTPUTS, to64["plain"]))
                  + f"; kernel {t['kernel']:.4f} ms{device}, plain {t['plain']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: "
                  f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB)")
            result[name] = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"], "bound": b,
                            "levels": len(calls)}
    del halving, contract, filt, sets
    torch.cuda.empty_cache()
    contract_sweep(torch, gl, gamma=True)
    return result


def final_gamma(hmm, data):
    """The Gamma left over the mixing variable once a GammaGaussianHMM's
    log_prob has integrated out the states: its ``logsumexp()`` is log_prob."""
    from pyro_tpu_torch.ops import gamma_gaussian as tgg

    r = hmm._conditioned(data)
    if r.precision.ndim == 2:
        r = tgg.sequential_gamma_gaussian_tensordot_homogeneous(r)
    else:
        r = tgg.sequential_gamma_gaussian_tensordot(r.expand(r.batch_shape))
    return tgg.gamma_gaussian_tensordot(hmm._init, r, dims=hmm.hidden_dim).event_logsumexp()


def rel_to(torch, label, got, ref, scale, rtol):
    """``got`` within ``rtol * scale`` of the float64 ``ref`` at every entry."""
    diff = (got.double() - ref).abs()
    rel = float((diff / scale).max())
    print(f"  {label}: max abs diff to float64 {float(diff.max()):.4g} ({rel:.3g} of the scale; "
          f"{float((diff / ref.abs()).max()):.3g} of the value)")
    check(bool(torch.isfinite(got).all()) and rel <= rtol, f"{label}: {rel:.3g} over {rtol}")


def independent_models(torch, dtype):
    """IndependentHMM at 8.10000.32.4: IHMM_CHANNELS channels, each a
    GaussianHMM of hidden 32, obs 1 with its own parameters (``make_arrays``
    of ``examples/gaussian_hmm.py`` at seed c), 8 sequences of T=10000.
    Returns the IndependentHMM, its data (8, T, C), and the channels'
    GaussianHMMs (each homogeneous)."""
    import numpy as np

    import pyro_tpu_torch.distributions as tdist
    from pyro_tpu_torch.examples import gaussian_hmm as example

    arrays = [example.make_arrays("homogeneous", c, obs=1) for c in range(IHMM_CHANNELS)]
    p = {k: torch.tensor(np.stack([a[k] for a in arrays]), dtype=dtype, device="cuda") for k in arrays[0]}
    data = p["data"][..., 0].permute(1, 2, 0)  # (C, 8, T, 1) -> (8, T, C)
    step = {k: v.unsqueeze(1) for k, v in p.items() if k not in ("init_loc", "init_scale", "data")}
    base = tdist.GaussianHMM(
        tdist.Normal(p["init_loc"], p["init_scale"]).to_event(1), step["trans_mat"],
        tdist.Normal(step["trans_loc"], step["trans_scale"]).to_event(1), step["obs_mat"],
        tdist.Normal(step["obs_loc"], step["obs_scale"]).to_event(1), duration=example.CONFIGS["homogeneous"]["T"],
    )
    channels = [example.make_hmm({k: v[c] for k, v in p.items()}, example.CONFIGS["homogeneous"]["T"])
                for c in range(IHMM_CHANNELS)]
    return tdist.IndependentHMM(base), data, channels


def mrf_model(torch, dtype):
    """GaussianMRF at 8.10000.32.4: time-homogeneous MVN factors over z_0
    (32), (z, z') (64) and (z', y) (36) with random covariances A A^T / d +
    I (numpy, seed 7), and 8 sequences of T=10000 observations of dim 4."""
    import numpy as np

    import pyro_tpu_torch.distributions as tdist

    rng = np.random.default_rng(7)
    h, o, T = 32, 4, 10_000

    def mvn(d):
        A = rng.standard_normal((d, d))
        cov = torch.tensor(A @ A.T / d + np.eye(d), dtype=dtype, device="cuda")
        return tdist.MultivariateNormal(torch.zeros(d, dtype=dtype, device="cuda"), covariance_matrix=cov)

    mrf = tdist.GaussianMRF(mvn(h), mvn(2 * h), mvn(h + o), duration=T)
    return mrf, torch.tensor(rng.standard_normal((8, T, o)), dtype=dtype, device="cuda")


def phase_gamma_slice(torch, gl):
    """Phase 16: the Student-t slice through its entry points, each call's
    K5 launches counted and each result against the port's plain levels in
    float64; then IndependentHMM, GaussianMRF, conjugate_update and
    prefix_condition through K4 at 8.10000.32.4, each against float64."""
    print(f"phase 16: GammaGaussianHMM log_prob at {GHMM_SIG} and {GGHMM_HET_SIG}, filter at {GHMM_SIG}; "
          f"IndependentHMM, GaussianMRF, conjugate_update and prefix_condition at {GHMM_SIG}")
    import numpy as np

    import pyro_tpu_torch.distributions as tdist

    k5 = ("gamma_halving", "gamma_contract")
    k4 = ("halving", "contract")
    models = slice_models(torch, example_name="gamma_gaussian_hmm")
    models64 = slice_models(torch, torch.float64, example_name="gamma_gaussian_hmm")
    launches, out = {}, {}
    with torch.no_grad():
        for config, sig in (("homogeneous", GHMM_SIG), ("heterogeneous", GGHMM_HET_SIG)):
            hmm, data = models[config]
            T = data.shape[-2]
            # K5a: one launch a level of the largest power-of-two block; K5b: ceil(log2 T)
            expect = ({"gamma_halving": T.bit_length() - 1, "gamma_contract": 0} if config == "homogeneous"
                      else {"gamma_halving": 0, "gamma_contract": (T - 1).bit_length()})

            def chained():
                acc = torch.zeros((), device="cuda")
                for _ in range(GHMM_CALLS):
                    acc = acc + hmm.log_prob(data + 1e-6 * acc).sum()
                return acc

            chained()
            torch.cuda.synchronize()
            times = []
            for rep in range(3):
                t0 = time.perf_counter()
                acc, counts = counted(torch, gl, f"{config} log_prob, {GHMM_CALLS} chained calls (rep {rep})",
                                      chained, k5, launches)
                times.append(time.perf_counter() - t0)
                check(counts == {k: GHMM_CALLS * v for k, v in expect.items()} and math.isfinite(float(acc)),
                      f"{config} log_prob: launches {counts}, expected {expect} a call; acc {acc}")
            seqs = GHMM_CALLS * data.shape[0]
            print(f"  {config} log_prob at {sig}: {[round(1e3 * t / GHMM_CALLS, 3) for t in times]} ms a call, "
                  f"{seqs / min(times):.1f} sequences/s at best ({seqs} sequences a rep); "
                  f"{expect} launches a call")
            out[f"{config}_seq_per_s"] = seqs / min(times)
            lp, _ = counted(torch, gl, f"{config} log_prob, checked", lambda: hmm.log_prob(data), k5, launches)
            with plain_levels(gl):
                hmm64, data64 = models64[config]
                g64 = final_gamma(hmm64, data64)
                lp64 = hmm64.log_prob(data64)
                lp32_plain = hmm.log_prob(data)
            terms = g64.log_normalizer.abs() + torch.lgamma(g64.concentration).abs() + (
                g64.concentration * torch.log(g64.rate)).abs()
            print(f"  {config} log_prob {lp.cpu().tolist()} against float64 {lp64.cpu().tolist()}; its terms "
                  f"(|log normaliser| + |lgamma(conc)| + |conc log rate|) up to {float(terms.max()):.6g}, "
                  f"concentration {g64.concentration.cpu().tolist()}")
            rel_to(torch, f"{config} log_prob through K5", lp, lp64, terms, GGHMM_TERMS_RTOL)
            rel_to(torch, f"{config} log_prob through the float32 plain levels (the reference's arithmetic)",
                   lp32_plain, lp64, terms, GGHMM_TERMS_RTOL)

        # the homogeneous filter: K5b over the expanded chain at n=32
        hom, hom_data = models["homogeneous"]
        T = hom_data.shape[-2]
        (gamma, mvn), counts = counted(torch, gl, "homogeneous filter", lambda: hom.filter(hom_data), k5, launches)
        check(counts == {"gamma_halving": 0, "gamma_contract": (T - 1).bit_length()}, f"filter: launches {counts}")
        with plain_levels(gl):
            gamma64, mvn64 = models64["homogeneous"][0].filter(models64["homogeneous"][1])
        conc_err = max_err(gamma.concentration.double(), gamma64.concentration)
        print(f"  homogeneous filter: concentration {gamma.concentration.cpu().tolist()} (float64 "
              f"{gamma64.concentration.cpu().tolist()}), rate {gamma.rate.cpu().tolist()}")
        check(conc_err <= 1e-6 * float(gamma64.concentration.abs().max()), f"filter concentration: {conc_err:.3g}")
        rel_to(torch, "filter's Gamma rate", gamma.rate, gamma64.rate, gamma64.rate.abs(), GGHMM_RATE_RTOL)
        for name, got, ref in (("mean", mvn.loc, mvn64.loc), ("covariance", mvn.covariance_matrix,
                                                               mvn64.covariance_matrix)):
            rel_to(torch, f"filter's {name}", got, ref, ref.abs().max(), GGHMM_MVN_TOL)
        t0 = time.perf_counter()
        for _ in range(3):
            hom.filter(hom_data)
        torch.cuda.synchronize()
        print(f"  homogeneous filter: {1e3 * (time.perf_counter() - t0) / 3:.3f} ms a call")
        del gamma, mvn, gamma64, mvn64
        torch.cuda.empty_cache()

    het, het_data = models["heterogeneous"]
    for label, fn in (("homogeneous log_prob", lambda: hom.log_prob(hom_data)),
                      ("heterogeneous log_prob", lambda: het.log_prob(het_data)),
                      ("homogeneous filter", lambda: hom.filter(hom_data))):
        print(f"  {label}, one call:")
        with torch.no_grad():
            wall, busy, _, _ = profile_run(torch, fn, top=5)
        out[f"busy_share {label}"] = busy / wall
    del models, models64
    torch.cuda.empty_cache()

    with torch.no_grad():
        # IndependentHMM: each channel its own parameters, so the chain runs K4b
        ihmm, idata, _ = independent_models(torch, torch.float32)
        lp, counts = counted(torch, gl, f"IndependentHMM log_prob ({IHMM_CHANNELS} channels)",
                             lambda: ihmm.log_prob(idata), k4)
        check(counts["contract"] > 0, f"IndependentHMM: launches {counts}")
        _, idata64, channels64 = independent_models(torch, torch.float64)
        with plain_levels(gl):
            lp64 = sum(ch.log_prob(idata64[..., c:c + 1]) for c, ch in enumerate(channels64))
        rel_to(torch, "IndependentHMM log_prob (against its channels' GaussianHMMs)", lp, lp64, lp64.abs(), GHMM_RTOL)
        del ihmm, idata, idata64, channels64
        torch.cuda.empty_cache()

        mrf, mdata = mrf_model(torch, torch.float32)
        lp, counts = counted(torch, gl, "GaussianMRF log_prob", lambda: mrf.log_prob(mdata), k4)
        check(counts["contract"] > 0, f"GaussianMRF: launches {counts}")
        mrf64, mdata64 = mrf_model(torch, torch.float64)
        with plain_levels(gl):
            lp64 = mrf64.log_prob(mdata64)
        rel_to(torch, "GaussianMRF log_prob", lp, lp64, lp64.abs(), GHMM_RTOL)
        del mrf, mdata, mrf64, mdata64
        torch.cuda.empty_cache()

        gmodels = slice_models(torch)
        gmodels64 = slice_models(torch, torch.float64)
        rng = np.random.default_rng(8)
        like_loc = rng.standard_normal(tuple(gmodels["homogeneous"][1].shape))

        def update(hmm, data):
            loc = torch.tensor(like_loc, dtype=data.dtype, device="cuda")
            g = tdist.Normal(loc, torch.ones_like(loc)).to_event(2)
            fg, log_normalizer = hmm.conjugate_update(g)
            return fg.log_prob(data), log_normalizer, hmm.log_prob(data) + g.log_prob(data)

        hom, hom_data = gmodels["homogeneous"]
        (fg_lp, log_normalizer, f_plus_g), counts = counted(torch, gl, "conjugate_update and its identity",
                                                            lambda: update(hom, hom_data), k4)
        check(counts["contract"] > 0 and counts["halving"] > 0, f"conjugate_update: launches {counts}")
        with plain_levels(gl):
            fg_lp64, log_normalizer64, f_plus_g64 = update(*gmodels64["homogeneous"])
        rel_to(torch, "conjugate_update's log_normalizer", log_normalizer, log_normalizer64,
               log_normalizer64.abs(), GHMM_RTOL)
        rel_to(torch, "the updated model's log_prob", fg_lp, fg_lp64, fg_lp64.abs(), GHMM_RTOL)
        rel_to(torch, "f.log_prob + g.log_prob against fg.log_prob + log_normalizer, float32", f_plus_g,
               (fg_lp + log_normalizer).double(), f_plus_g64.abs(), GHMM_RTOL)
        rel_to(torch, "the same identity in float64", f_plus_g64, fg_lp64 + log_normalizer64, f_plus_g64.abs(), 1e-10)

        def prefix(hmm, data):
            right = hmm.prefix_condition(data[:, :PREFIX_T])
            return right.log_prob(data[:, PREFIX_T:])

        rlp, counts = counted(torch, gl, f"prefix_condition at t={PREFIX_T} and the rest's log_prob",
                              lambda: prefix(hom, hom_data), k4)
        check(counts["contract"] > 0 and counts["halving"] > 0, f"prefix_condition: launches {counts}")
        hom64, hom_data64 = gmodels64["homogeneous"]
        with plain_levels(gl):
            rlp64 = prefix(hom64, hom_data64)
            from pyro_tpu_torch.examples import gaussian_hmm as example

            p64 = {k: torch.tensor(v, dtype=torch.float64, device="cuda")
                   for k, v in example.make_arrays("homogeneous", 0).items()}
            p64.pop("data")
            chain = example.make_hmm(p64, PREFIX_T).log_prob(hom_data64[:, :PREFIX_T]) + rlp64
            full = hom64.log_prob(hom_data64)
        rel_to(torch, f"log p(x[t:] | x[:t]) at t={PREFIX_T}", rlp, rlp64, rlp64.abs(), GHMM_RTOL)
        rel_to(torch, "log p(x[:t]) + log p(x[t:] | x[:t]) against log p(x), float64", chain, full, full.abs(), 1e-10)
    del gmodels, gmodels64
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# -- slice 15: the deep Markov model (examples/dmm.py) -------------------------------

# the bench row dmm_elbo_steps_per_sec, 20.129.88.100.200.100.rnn600 (bench.py:41-42)
DMM_SIG = "20.129.88.100.200.100.rnn600"
DMM_B, DMM_T = 20, 129
DMM_STEPS = 20  # timed steady steps
DMM_LOSS_RTOL = 1e-4  # the card's first-step loss against the port's CPU run
DMM_GRAD_TOL = 1e-3  # each gradient against the CPU run's, times its largest entry


def _dmm_grads(dmm):
    """Each parameter's gradient, by its param-store name."""
    import pyro_tpu_torch as pyro

    return {name: p.grad.detach().cpu() for name, p in pyro.get_param_store().get_all_unconstrained().items()}


def _off_card(torch, svi, dmm, data):
    """Every parameter, optimiser state and sampled value of the DMM that is
    not on the card."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine

    tensors = {f"param {n}": v for n, v in pyro.get_param_store().get_all_unconstrained().items()}
    tensors.update({f"buffer {n}": b for n, b in dmm.named_buffers()})
    for name, chain in svi.optim._states.items():
        for i, state in enumerate(chain):
            tensors.update({f"optimiser {name}[{i}].{k}": v for k, v in state.items() if isinstance(v, torch.Tensor)})
    guide_trace = poutine.trace(dmm.guide).get_trace(data)
    model_trace = poutine.trace(poutine.replay(dmm.model, trace=guide_trace)).get_trace(data)
    for label, trace in (("guide", guide_trace), ("model", model_trace)):
        for name, site in trace.nodes.items():
            if site["type"] == "sample":
                tensors[f"{label} site {name}"] = site["value"]
    return sorted(name for name, v in tensors.items() if v.device.type != "cuda")


def _kernel_launches(lm, ms, gl):
    """Launches counted by every hand kernel's wrapper so far."""
    return sum(lm.launches.values()) + sum(ms.launches.values()) + sum(ms.tv_launches.values()) + sum(
        gl.launches.values())


def phase_dmm(torch, lm, ms, gl):
    """Phase 17: the DMM of examples/dmm.py at the bench row's widths
    through its entry points: the first step against the port's CPU run,
    training with ClippedAdam (no hand kernel launched), every tensor on
    the card, two steps with two IAFs, the steady step time and one
    profiled step."""
    print(f"phase 17: DMM SVI (Trace_ELBO, ClippedAdam lr 3e-3, clip_norm 10) at {DMM_SIG}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import dmm as example
    from pyro_tpu_torch.infer import Trace_ELBO

    torch.manual_seed(0)
    weights = example.DMM().state_dict()
    data_cpu = example.synthetic_data(torch.Generator().manual_seed(0), DMM_B, DMM_T)
    data = data_cpu.to("cuda")
    eps = torch.randn((DMM_B, DMM_T, example.Z_DIM), generator=torch.Generator().manual_seed(1))

    def first_step(device, x):
        pyro.set_default_device(device)
        try:
            pyro.clear_param_store()
            dmm = example.DMM().to(device)
            dmm.load_state_dict(weights)
            t0 = time.perf_counter()
            with shared_noise(torch, eps):
                loss = Trace_ELBO().differentiable_loss(dmm.model, dmm.guide, x)
            loss.backward()
            value = float(loss.detach())
            return value, _dmm_grads(dmm), (time.perf_counter() - t0) * 1e3
        finally:
            pyro.set_default_device("cuda")

    loss_cpu, grads_cpu, cpu_ms = first_step("cpu", data_cpu)
    loss_gpu, grads_gpu, _ = first_step("cuda", data)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"  first step's loss: card {loss_gpu!r}, CPU {loss_cpu!r} ({cpu_ms:.0f} ms on the CPU), rel diff {rel:.3g}")
    check(rel <= DMM_LOSS_RTOL, f"the DMM loss on the card differs from the CPU run by rtol {rel}")
    check(sorted(grads_gpu) == sorted(grads_cpu), "the card and the CPU run registered other parameters")
    worst, failures = (-1.0, ""), []
    for name, ref in grads_cpu.items():
        g = grads_gpu[name]
        scale = float(ref.abs().max())
        err = max_err(g, ref) / scale if scale > 0 else max_err(g, ref)
        worst = max(worst, (err, name))
        if not bool(torch.isfinite(g).all()) or err > DMM_GRAD_TOL:
            failures.append(f"d{name}: {err:.3g} x max|grad|")
    print(f"  first step's gradients ({len(grads_cpu)} parameters): largest error {worst[0]:.3g} x max|grad| "
          f"(d{worst[1]}), the bar {DMM_GRAD_TOL}")
    check(not failures, "DMM gradients off the CPU run's: " + "; ".join(failures))

    pyro.clear_param_store()
    dmm = example.DMM().to("cuda")
    dmm.load_state_dict(weights)
    svi = example.make_svi(dmm)
    generator = torch.Generator(device="cuda").manual_seed(0)
    warm = 3
    losses, step_ms = [], []
    launched = _kernel_launches(lm, ms, gl)
    for _ in range(warm + DMM_STEPS):
        t0 = time.perf_counter()
        loss = svi.step(data, generator=generator)  # reads the loss: synced
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launched = _kernel_launches(lm, ms, gl) - launched
    check(launched == 0, f"the DMM's steps launched {launched} hand kernels")
    check(all(math.isfinite(l) for l in losses), "non-finite DMM loss")
    check(sum(losses[-5:]) < sum(losses[:5]), f"the DMM loss did not fall: {losses[:5]} -> {losses[-5:]}")
    off = _off_card(torch, svi, dmm, data)
    check(not off, f"DMM tensors off the card: {off[:5]}")
    steady = sorted(step_ms[warm:])
    mean_ms = sum(steady) / len(steady)
    print(f"  {warm + DMM_STEPS} steps, loss {losses[0]:.1f} -> {losses[-1]:.1f}, no hand kernel launched; every "
          f"parameter, optimiser state and sampled value on the card")
    print(f"  steady step (steps {warm}-{warm + DMM_STEPS - 1}, host clock and synchronize): mean {mean_ms:.3f} ms, "
          f"median {steady[len(steady) // 2]:.3f}, min {steady[0]:.3f}, max {steady[-1]:.3f}, "
          f"{1e3 / mean_ms:.2f} steps/s; first step {step_ms[0]:.3f} ms")
    wall, busy, launches, kernels = profile_run(torch, lambda: svi.step(data, generator=generator), top=5)
    print(f"  device operations per step {launches}, busy {100 * busy / wall:.1f}%")

    pyro.clear_param_store()
    iaf_dmm = example.DMM(num_iafs=2).to("cuda")
    iaf_svi = example.make_svi(iaf_dmm)
    iaf_losses = [iaf_svi.step(data, generator=generator) for _ in range(2)]
    check(all(math.isfinite(l) for l in iaf_losses), f"non-finite DMM loss with two IAFs: {iaf_losses}")
    off = _off_card(torch, iaf_svi, iaf_dmm, data)
    check(not off, f"DMM tensors off the card with two IAFs: {off[:5]}")
    check("iaf_1$$$output_layer.weight" in pyro.get_param_store(), "the second IAF registered no parameters")
    print(f"  two IAFs: 2 steps, losses {iaf_losses[0]:.1f}, {iaf_losses[1]:.1f}, every tensor on the card")
    pyro.clear_param_store()
    del svi, dmm, iaf_svi, iaf_dmm
    torch.cuda.empty_cache()
    return {"step_ms": mean_ms, "steps_per_s": 1e3 / mean_ms, "launches": launches, "busy_share": busy / wall}


# -- slice 16: the discrete posterior queries on model_1 ----------------------------

Q_STEPS, Q_DRAWS, Q_SEEDS = 3, 256, 200
# The marginals and ubersum's gradient are held against float64 CPU runs:
# float32 rounds model_1's log messages (log Z about -1.7e3 a sequence) at
# about 1.2e-4 and ubersum's (log Z about 9.5e3) at about 1e-3, and each of
# these outputs is the exp of a difference of such messages, so float32 on
# any device is 1e-5 to 1e-3 off in relative terms, beyond 1e-5 against
# another float32 run.  The card must come no further from float64 than
# Q_F32_FACTOR times the CPU's own float32 run, plus 1e-6, and never further
# than a fixed ceiling, so that a fault common to both devices fails too:
# Q_MARGINAL_CEIL in probability, Q_GRAD_CEIL times the gradient's largest
# float64 entry (about 3.3 times the CPU's float32 run on an H100 run, 9.1e-5
# and 6.0e-4 at most).
Q_F32_FACTOR = 3.0
Q_MARGINAL_CEIL = 3e-4
Q_GRAD_CEIL = 2e-3
Q_MAP_RTOL = 1e-5  # the MAP path's joint log density against the CPU run's
Q_MAP_TIE = 1e-3  # MAP indices may differ only where the best path leads by at most this
Q_EQUATION, Q_PLATES, Q_DIM = "a,abi,bcij,adj,deij->", "ij", 32  # examples/einsum.py's defaults
Q_MIX_DATA = (0.3, -1.2, 2.1, 1.4, 0.8, -0.4)


def _q_mixture(strategy):
    """A mixture with a Bernoulli guide site per datum enumerated by
    ``strategy``, and a global cost outside the plate."""
    import torch

    import pyro_tpu_torch as pyro
    import pyro_tpu_torch.distributions as dist

    def model(data):
        mu = pyro.param("mu", lambda: torch.tensor(0.7, device=data.device))
        pyro.sample("prior", dist.Normal(mu, torch.tensor(1.0, device=data.device)), obs=torch.tensor(0.5, device=data.device))
        with pyro.plate("data", len(data), dim=-1):
            z = pyro.sample("z", dist.Bernoulli(torch.tensor(0.4, device=data.device)))
            pyro.sample("obs", dist.Normal(torch.where(z > 0, mu, -mu), torch.tensor(1.0, device=data.device)), obs=data)

    def guide(data):
        q = pyro.param("qz", lambda: torch.linspace(0.2, 0.8, len(data), device=data.device))
        with pyro.plate("data", len(data), dim=-1):
            pyro.sample("z", dist.Bernoulli(q), infer={"enumerate": strategy})

    return model, guide


def _q_sampled_model(data):
    """A model site with 8 draws a datum in place of its support."""
    import torch

    import pyro_tpu_torch as pyro
    import pyro_tpu_torch.distributions as dist

    with pyro.plate("data", len(data)):
        z = pyro.sample("z", dist.Bernoulli(torch.tensor(0.3, device=data.device)),
                        infer={"enumerate": "parallel", "num_samples": 8})
        pyro.sample("y", dist.Normal(torch.where(z > 0, 1.5, -1.0), torch.tensor(1.0, device=data.device)), obs=data)


def _q_loss_and_grads(torch, strategy, device):
    """Loss and parameter gradients of ``_q_mixture`` on ``device``."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.infer import TraceEnum_ELBO

    pyro.set_default_device(device)
    try:
        pyro.clear_param_store()
        data = torch.tensor(Q_MIX_DATA, device=device)
        model, guide = _q_mixture(strategy)
        loss = TraceEnum_ELBO(max_plate_nesting=1).differentiable_loss(model, guide, data)
        loss.backward()
        store = pyro.get_param_store()
        grads = {k: store.get_unconstrained(k).grad.detach().cpu() for k in ("mu", "qz")}
        pyro.clear_param_store()
        return float(loss.detach()), grads
    finally:
        pyro.set_default_device("cuda")


def _q_path_log_density(torch, model, sequences, lengths, path):
    """Each sequence's joint log density of the hidden path ``path`` (B, T)
    under the conditioned CPU model, as MAP decoding counts it (the
    transitions and emissions within the lengths), summed in float64."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine

    B, T_ = path.shape
    data = {f"x_{t}": path[:, t].reshape(B, 1) for t in range(T_)}
    pyro.set_default_device("cpu")
    try:
        trace = poutine.trace(poutine.condition(model, data=data)).get_trace(sequences, lengths)
        trace.compute_log_prob()
    finally:
        pyro.set_default_device("cuda")
    total = torch.zeros(B, dtype=torch.float64)
    for name, site in trace.nodes.items():
        if name.startswith(("x_", "y_")):
            total += site["log_prob"].double().reshape(B, -1).sum(-1)
    return total


def phase_queries(torch, lm):
    """Phase 18: compute_marginals, infer_discrete (MAP and draws), ubersum,
    sequential and sampled enumeration, through the port's entry points, on
    model_1 at the hmm_enum_steps_per_sec row's widths."""
    print(f"phase 18: discrete queries on model_1 (pyro.markov) at {M1_B}.{M1_T}.{D}.{M1_S}")
    import functools

    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import einsum as einsum_example
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.infer import TraceEnum_ELBO, infer_discrete

    argv = ["--model", "1", "--hidden-dim", str(M1_S), "--num-sequences", str(M1_B), "--max-length", str(M1_T),
            "--data-dim", str(D)]
    args = example.parse_args(argv)
    names = ("AutoDelta.probs_x", "AutoDelta.probs_y")
    elbo = TraceEnum_ELBO(max_plate_nesting=2)

    def setup(device, values=None):
        """model_1, its guide, data and the guide's probs on ``device``;
        trained for Q_STEPS Adam steps, or with the unconstrained ``values``."""
        pyro.set_default_device(device)
        pyro.clear_param_store()
        sequences, lengths = example.synthetic_sequences(0, M1_B, M1_T, D)
        model, guide, svi = example.make_svi(args, args.learning_rate)
        if values is None:
            losses = [svi.step(sequences, lengths) for _ in range(Q_STEPS)]
            check(all(math.isfinite(l) for l in losses), f"model_1 training losses {losses}")
            print(f"  {Q_STEPS} Adam steps on the card: losses {losses}")
        else:
            svi.evaluate_loss(sequences, lengths)  # registers the params
            store = pyro.get_param_store()
            for k, v in values.items():
                store.set_unconstrained(k, v.to(device, store.get_unconstrained(k).dtype))
        probs = {k: v["value"].detach() for k, v in poutine.trace(guide).get_trace(sequences, lengths).nodes.items()
                 if k in ("probs_x", "probs_y")}
        return model, guide, sequences, lengths, probs

    _, _, _, _, probs = setup("cuda")
    values = {k: pyro.get_param_store().get_unconstrained(k).detach().cpu() for k in names}
    try:
        # the reference: float64 on the CPU, given the guide's float32 probs
        # clamped to float32's [eps, 1 - eps] as its distributions clamp them
        eps = torch.finfo(torch.float32).eps
        with default_dtype(torch, torch.float64):
            pyro.set_default_device("cpu")
            cond_c = poutine.condition(functools.partial(example.model_1, args=args),
                                       data={k: v.cpu().double().clamp(eps, 1 - eps) for k, v in probs.items()})
            seq_c, len_c = example.synthetic_sequences(0, M1_B, M1_T, D)
            t0 = time.perf_counter()
            marg_cpu = elbo.compute_marginals(cond_c, lambda *args: None, seq_c, len_c)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            map_cpu = poutine.trace(infer_discrete(cond_c, first_available_dim=-3, temperature=0)).get_trace(
                seq_c, len_c)
            path_cpu = torch.stack([map_cpu.nodes[f"x_{t}"]["value"].reshape(M1_B) for t in range(M1_T)], -1)
            logp_cpu = _q_path_log_density(torch, cond_c, seq_c, len_c, path_cpu)
        model_32, guide_32, seq_32, len_32, _ = setup("cpu", values)
        marg_cpu32 = elbo.compute_marginals(model_32, guide_32, seq_32, len_32)
    finally:
        pyro.set_default_device("cuda")
    pyro.clear_param_store()
    model, guide, sequences, lengths, probs = setup("cuda", values)
    conditioned = poutine.condition(model, data=probs)

    # compute_marginals: K1 forward and backward
    lm.launches.update(forward=0, backward=0)
    marginals = elbo.compute_marginals(model, guide, sequences, lengths)
    torch.cuda.synchronize()
    marg_launches = dict(lm.launches)
    print(f"  compute_marginals: K1 launches {marg_launches}; the float64 CPU run {cpu_ms:.1f} ms")
    check(marg_launches["forward"] > 0 and marg_launches["backward"] > 0,
          f"compute_marginals launched K1 {marg_launches}")
    check(sorted(marginals) == sorted(marg_cpu) == sorted(f"x_{t}" for t in range(M1_T)),
          f"marginals of {sorted(marginals)}")
    worst = {"card": 0.0, "CPU float32": 0.0, "card to CPU float32": 0.0}
    for name, m in marginals.items():
        probs = m.probs
        check(tuple(probs.shape) == (M1_B, 1, M1_S) and probs.is_cuda,
              f"{name}: marginal of shape {tuple(probs.shape)}, not one per sequence ({M1_B}, 1, {M1_S})")
        ref = marg_cpu[name].probs
        for key, a, b in (("card", probs.cpu(), ref), ("CPU float32", marg_cpu32[name].probs, ref),
                          ("card to CPU float32", probs.cpu(), marg_cpu32[name].probs)):
            worst[key] = max(worst[key], max_err(a.double(), b.double()))
    bar = min(Q_F32_FACTOR * worst["CPU float32"] + 1e-6, Q_MARGINAL_CEIL)
    print(f"  marginals: {len(marginals)} sites of shape ({M1_B}, 1, {M1_S}), one per sequence; largest error to "
          f"the float64 CPU run: card {worst['card']:.3g}, the CPU's float32 run {worst['CPU float32']:.3g} (bar "
          f"{bar:.3g}); card to the CPU's float32 run {worst['card to CPU float32']:.3g}")
    check(worst["card"] <= bar, f"marginals {worst['card']:.3g} from the float64 CPU run, over {bar:.3g}")
    p = torch.stack([marginals[f"x_{t}"].probs.reshape(M1_B, M1_S) for t in range(M1_T)], 1)  # (B, T, S)

    # infer_discrete at temperature 0: the MAP path
    lm.launches.update(forward=0, backward=0)
    map_trace = poutine.trace(infer_discrete(conditioned, first_available_dim=-3, temperature=0)).get_trace(
        sequences, lengths)
    path = torch.stack([map_trace.nodes[f"x_{t}"]["value"].reshape(M1_B) for t in range(M1_T)], -1).cpu()
    logp = _q_path_log_density(torch, cond_c, seq_c, len_c, path)
    rel = float(((logp - logp_cpu).abs() / logp_cpu.abs()).max())
    differ = (path != path_cpu).any(-1)
    lead = float((logp_cpu - logp)[differ].max()) if bool(differ.any()) else 0.0
    print(f"  infer_discrete, temperature 0: K1 launches {dict(lm.launches)}; the MAP path's joint log density "
          f"against the float64 CPU run's: rel {rel:.3g}; {int(differ.sum())} of {M1_B} paths differ from its, "
          f"its best path leading the card's there by {lead:.3g} at most")
    check(rel <= Q_MAP_RTOL, f"MAP log density rel {rel:.3g} from the CPU run")
    check(lead <= Q_MAP_TIE, f"MAP indices differ where the CPU's best path leads by {lead:.3g}")

    # infer_discrete at temperature 1: draws against the marginals
    generator = torch.Generator(device="cuda").manual_seed(0)
    sampler = infer_discrete(conditioned, first_available_dim=-3, temperature=1, generator=generator)
    lm.launches.update(forward=0, backward=0)
    counts = torch.zeros((M1_B, M1_T, M1_S), device="cuda")
    for _ in range(Q_DRAWS):
        tr = poutine.trace(sampler).get_trace(sequences, lengths)
        x = torch.stack([tr.nodes[f"x_{t}"]["value"].reshape(M1_B) for t in range(M1_T)], -1)
        counts.scatter_add_(-1, x[..., None], torch.ones_like(x[..., None], dtype=counts.dtype))
    torch.cuda.synchronize()
    draw_launches = dict(lm.launches)
    check(draw_launches["forward"] > 0, f"infer_discrete at temperature 1 launched K1 {draw_launches}")
    freq = counts / Q_DRAWS
    bar = 5 * (p * (1 - p) / Q_DRAWS).sqrt() + 1 / Q_DRAWS
    excess = float((freq - p).abs().sub(bar).max())
    print(f"  infer_discrete, temperature 1: K1 launches over {Q_DRAWS} draws {draw_launches}; largest "
          f"|frequency - p| less its bar {excess:.3g} (at most 0)")
    check(excess <= 0, f"draw frequencies off the marginals by {excess:.3g} past the bar")

    # ubersum at examples/einsum.py's equation, against the CPU runs
    ops_cpu = einsum_example.make_operands(Q_EQUATION, Q_PLATES, 32, Q_DIM, "cpu")
    ops = [x.cuda() for x in ops_cpu]
    ops64 = [x.double() for x in ops_cpu]
    value, value_cpu = (einsum_example.logprob(Q_EQUATION, *xs, plates=Q_PLATES) for xs in (ops, ops_cpu))
    grads, grads_cpu, grads64 = (einsum_example.gradient(Q_EQUATION, *xs, plates=Q_PLATES) for xs in (ops, ops_cpu, ops64))
    rel = float(((value.cpu() - value_cpu).abs() / value_cpu.abs()).max())
    print(f"  ubersum {Q_EQUATION} (plates {Q_PLATES}, dim {Q_DIM}, plate size 32): {float(value):.6f} against the "
          f"CPU run's {float(value_cpu):.6f} (rel {rel:.3g})")
    check(rel <= 1e-5, f"ubersum off the CPU run: rel {rel:.3g}")
    for name, g, gc, g64 in zip(Q_EQUATION.split("->")[0].split(","), grads, grads_cpu, grads64):
        err, err32 = max_err(g.cpu().double(), g64), max_err(gc.double(), g64)
        print(f"    d/d{name}: max|grad| {float(g64.abs().max()):.3g}; largest error to float64: card {err:.3g}, the "
              f"CPU's float32 run {err32:.3g}; card to the CPU's float32 run {max_err(g.cpu(), gc):.3g}")
        bar = min(Q_F32_FACTOR * err32 + 1e-6, Q_GRAD_CEIL * float(g64.abs().max()))
        check(err <= bar, f"ubersum gradient d/d{name}: {err:.3g} from float64, over {bar:.3g}")

    # sequential and sampled enumeration
    seq_gpu = _q_loss_and_grads(torch, "sequential", "cuda")
    for label, ref in (("CPU run", _q_loss_and_grads(torch, "sequential", "cpu")),
                       ("parallel enumeration", _q_loss_and_grads(torch, "parallel", "cuda"))):
        lrel = abs(seq_gpu[0] - ref[0]) / abs(ref[0])
        gexcess = max(float(((seq_gpu[1][k] - ref[1][k]).abs() - 1e-5 * ref[1][k].abs() - 1e-7).max()) for k in ref[1])
        print(f"  sequential guide site: loss {seq_gpu[0]!r} against the {label}'s {ref[0]!r} (rel {lrel:.3g}); "
              f"gradients past rtol 1e-5 by {gexcess:.3g}")
        check(lrel <= 1e-5 and gexcess <= 0, f"sequential enumeration off the {label}")
    sampled = {}
    for device in ("cuda", "cpu"):
        pyro.set_default_device(device)
        try:
            data = torch.tensor(Q_MIX_DATA, device=device)
            sampled[device] = torch.tensor([
                TraceEnum_ELBO(max_plate_nesting=1).loss(_q_sampled_model, lambda data: None, data,
                                                         generator=torch.Generator(device=device).manual_seed(s))
                .item() for s in range(Q_SEEDS)], dtype=torch.float64)
        finally:
            pyro.set_default_device("cuda")
    se = math.hypot(*(float(v.std()) / math.sqrt(Q_SEEDS) for v in sampled.values()))
    diff = abs(float(sampled["cuda"].mean() - sampled["cpu"].mean()))
    print(f"  sampled model site (num_samples=8): mean loss over {Q_SEEDS} generators {float(sampled['cuda'].mean()):.5f}"
          f" on the card, {float(sampled['cpu'].mean()):.5f} on the CPU ({diff / se:.2f} standard errors apart)")
    check(bool(sampled["cuda"].isfinite().all()) and diff <= 4 * se, f"sampled enumeration: {diff:.3g} > 4 x {se:.3g}")

    # timing: ms a call (host clock around work that ends in a sync), then
    # one profiled call of each query with its busy share and K1's device ms
    def timed(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    queries = {
        "compute_marginals": lambda: elbo.compute_marginals(model, guide, sequences, lengths),
        "infer_discrete t=0": lambda: poutine.trace(infer_discrete(conditioned, first_available_dim=-3, temperature=0))
        .get_trace(sequences, lengths),
        "infer_discrete t=1": lambda: poutine.trace(sampler).get_trace(sequences, lengths),
    }
    times = {name: timed(fn) for name, fn in queries.items()}
    for plate_size in range(8, 33, 8):
        xs = einsum_example.make_operands(Q_EQUATION, Q_PLATES, plate_size, Q_DIM, "cuda")
        for method, fn in (("logprob", einsum_example.logprob), ("gradient", einsum_example.gradient)):
            times[f"ubersum {method} {plate_size}"] = einsum_example.time_fn(
                fn, Q_EQUATION, *xs, iters=10, plates=Q_PLATES) * 1e3
    print("  ms a call: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    profiles = {}
    for name in ("compute_marginals", "infer_discrete t=1"):
        print(f"  {name}, one more call:")
        wall, busy, _, kernels = profile_run(torch, queries[name], top=5)
        k1_ms = sum(e.self_device_time_total for e in kernels if "lme_" in e.key) / 1e3
        print(f"    K1 kernels {k1_ms:.3f} device ms of {busy:.3f} busy ({100 * busy / wall:.1f}% of the wall)")
        profiles[name] = {"wall_ms": wall, "busy_ms": busy, "k1_ms": k1_ms}
    pyro.clear_param_store()
    return {"marginals": marg_launches, "draws": draw_launches, "times": times, "profiles": profiles}


# -- slice 17: Gaussian-process time series through K4, the Normal-family guides -------

GP_EXAMPLE_STEPS = 300  # examples/timeseries_gp.py's default
GP_FORECAST_ATOL = 1e-3  # the card's one-step forecast against the CPU run's, after 300 float32 Adam steps each
GP_LOSS_RTOL = 1e-4  # the card's last loss of those 300 steps against the CPU run's
GP_EEG_T, GP_EEG_CHANNELS = 14_980, 14
GP_EEG_MODELS = {"imgp": "contract", "lcmgp": "contract", "dmgp": "halving", "lgssmgp": "halving"}
GP_TIMED_STEPS, GP_WARM_STEPS = 20, 2
GP_GUIDES = ("AutoNormal", "AutoDiagonalNormal", "AutoMultivariateNormal", "AutoLowRankMultivariateNormal",
             "AutoIAFNormal", "Parameterized")
GP_GUIDE_STEPS = 10
GP_ELBO_RTOL = 1e-5  # the ELBO at one latent value on the card against the CPU run's
# the guide's own term of it, log q(z) (with the per-site -log|J|), held on
# its own: the model's term (about 2.4e5 at the EEG shape) would hide it
GP_GUIDE_LP_RTOL, GP_GUIDE_LP_ATOL = 1e-5, 1e-4
K4_KEYS = ("halving", "contract", "mids", "halving_bwd", "contract_bwd")


def elbo_at_latent(poutine, model, guide, cond, data):
    """The two terms of -ELBO at one latent value, log q(z) and
    log p(data, z): the guide run with its sites ``cond`` conditioned, the
    model conditioned on the values the guide's sites then take."""
    guide_trace = poutine.trace(poutine.condition(guide, data=cond)).get_trace(data)
    values = {name: site["value"] for name, site in guide_trace.nodes.items()
              if site["type"] == "sample" and not site["infer"].get("is_auxiliary")}
    model_trace = poutine.trace(poutine.condition(model, data=values)).get_trace(data)
    return float(guide_trace.log_prob_sum()), float(model_trace.log_prob_sum())


def smallest_pivot(torch, hmm):
    """The smallest diagonal entry of the Cholesky factors of a GaussianHMM's
    initial covariance and transition noise covariance (recovered from the
    information form: the noise's precision is the lower right block of the
    transition factor's), and whether one of them failed."""
    hmm = getattr(hmm, "base_dist", hmm)
    n = hmm.hidden_dim
    pivots, failed = [], False
    for precision in (hmm._init.precision, hmm._trans.precision[..., n:, n:]):
        L, info = torch.linalg.cholesky_ex(torch.linalg.inv(precision))
        failed = failed or bool((info != 0).any()) or not bool(L.isfinite().all())
        pivots.append(float(L.diagonal(dim1=-2, dim2=-1).min()))
    return min(pivots), failed


def _gp_example_run(torch, model, device, data, init=None):
    """``examples/timeseries_gp.py`` at its defaults on ``device``: its
    losses over 300 steps, the one-step forecast, the seconds taken, the
    initial params and the K4b launches."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import timeseries_gp as example
    from pyro_tpu_torch.ops import gaussian_levels as gl
    from pyro_tpu_torch.params import param_store_from_jax

    pyro.set_default_device(device)
    try:
        pyro.clear_param_store()
        gp = example.make_gp(model, name="gp")
        gp.get_dist()
        store = pyro.get_param_store()
        if init is None:
            init = {k: store[k].detach().cpu().numpy().copy() for k in store.get_all_unconstrained()}
        else:
            param_store_from_jax(init)
        window = data.shape[0] - 1
        targets = data[:window].to(device)
        svi = example.make_svi(example.make_model(gp))
        gl.reset_counts()
        t0 = time.perf_counter()
        losses = svi.run_steps(GP_EXAMPLE_STEPS, targets).tolist()
        seconds = time.perf_counter() - t0
        contract = gl.launches["contract"]
        with torch.no_grad():
            forecast = example.one_step_forecast(gp, targets).double().cpu()
        return losses, forecast, seconds, init, contract
    finally:
        pyro.set_default_device("cuda")


def _gp_guide(torch, name):
    """IndependentMaternGP at the EEG shape with Gamma(2, 2) priors on its
    length and kernel scales, its model, and the guide ``name`` over it."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import distributions as dist
    from pyro_tpu_torch.examples import timeseries_gp as example
    from pyro_tpu_torch.infer import autoguide

    gp = example.make_gp("imgp", "eeg", name="gp")
    device = pyro.get_default_device()
    for param in ("length_scale", "kernel_scale"):
        two = torch.full((GP_EEG_CHANNELS,), 2.0, device=device)
        gp.set_prior(param, dist.Gamma(two, two).to_event(1))

    def model(t):
        gp.set_mode("model")
        pyro.factor("log_prob", gp.log_prob(t))

    if name != "Parameterized":
        return gp, model, getattr(autoguide, name)(model)
    gp.autoguide("length_scale", "Normal")
    gp.autoguide("kernel_scale", "Normal")

    def guide(t):
        gp.set_mode("guide")
        return {"length_scale": gp.length_scale, "kernel_scale": gp.kernel_scale}

    return gp, model, guide


def phase_gp(torch, gl, smi):
    """Phase 19: the GP time series of examples/timeseries_gp.py at its
    widths (300 steps, the forecast against the CPU run), the four models at
    the EEG shape through K4 (log_prob and the first step's gradients
    against float64 through the plain levels on the card, launches per call
    and step, ms a step, one profiled step), a DependentMaternGP draw through
    K4c with its cross-channel correlation, and the six Normal-family guides
    on IndependentMaternGP at the EEG shape."""
    print(f"phase 19: GP time series through K4 and the Normal-family guides ({smi})")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import timeseries_gp as example
    from pyro_tpu_torch.infer import SVI, Trace_ELBO
    from pyro_tpu_torch.optim import Adam
    from pyro_tpu_torch.params import param_store_from_jax

    out = {}
    # 1. the example at its own widths, on the card and on the CPU
    data = torch.tensor(example.synthetic_series(0, 81, 2))
    for model in ("imgp", "lcmgp"):
        losses, forecast, seconds, init, contract = _gp_example_run(torch, model, "cuda", data)
        losses_cpu, forecast_cpu, seconds_cpu, _, _ = _gp_example_run(torch, model, "cpu", data, init)
        err = max_err(forecast, forecast_cpu)
        rel = abs(losses[-1] - losses_cpu[-1]) / abs(losses_cpu[-1])
        truth = data[-1].double()
        print(f"  example {model} (T=80, obs 2): {GP_EXAMPLE_STEPS} steps on the card in {seconds:.3f} s "
              f"({1e3 * seconds / GP_EXAMPLE_STEPS:.3f} ms a step; the CPU {1e3 * seconds_cpu / GP_EXAMPLE_STEPS:.3f}), "
              f"{contract} K4b launches ({contract / GP_EXAMPLE_STEPS:.1f} a step); loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (CPU {losses_cpu[-1]:.4f}, rel {rel:.3g}); forecast {forecast.tolist()} "
              f"(CPU {forecast_cpu.tolist()}, max abs diff {err:.3g}; error to the held-out step "
              f"{(forecast - truth).abs().tolist()})")
        check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0], f"{model}: losses {losses[:3]}...")
        check(contract > 0, f"{model}: no K4b launch in {GP_EXAMPLE_STEPS} steps")
        check(rel <= GP_LOSS_RTOL and err <= GP_FORECAST_ATOL,
              f"{model}: the card's run is off the CPU's (loss rel {rel:.3g}, forecast {err:.3g})")

    # 2. the four models at the EEG shape
    series = example.synthetic_series(0, GP_EEG_T, GP_EEG_CHANNELS)
    targets = torch.tensor(series, device="cuda")
    targets64 = torch.tensor(series, dtype=torch.float64, device="cuda")
    for model, kind in GP_EEG_MODELS.items():
        pyro.clear_param_store()
        gp = example.make_gp(model, "eeg", name="gp")
        gl.reset_counts()
        loss32, g32 = _loss_and_grads(torch, example.make_model(gp), targets)
        torch.cuda.synchronize()
        step_counts = {k: gl.launches[k] for k in K4_KEYS}
        store = pyro.get_param_store()
        params64 = {k: store[k].detach().double().cpu().numpy() for k in g32}
        with torch.no_grad():
            lp32, call_counts = counted(torch, gl, f"{model} log_prob", lambda: gp.log_prob(targets), K4_KEYS)
            hmm = gp.get_dist(duration=GP_EEG_T)
            pivot, failed = smallest_pivot(torch, hmm)
        n = getattr(hmm, "base_dist", hmm).hidden_dim
        pyro.clear_param_store()
        with default_dtype(torch, torch.float64), plain_levels(gl):
            gp64 = example.make_gp(model, "eeg", name="gp")
            gp64.get_dist()
            param_store_from_jax(params64)
            with torch.no_grad():
                lp64 = gp64.log_prob(targets64)
            loss64, g64 = _loss_and_grads(torch, example.make_model(gp64), targets64)
        lp_rel = float(((lp32.double() - lp64).abs() / lp64.abs()).max())
        rel = abs(loss32 - loss64) / abs(loss64)
        print(f"  {model} at {GP_EEG_T}.{GP_EEG_CHANNELS} (state dim n={n}): log_prob {float(lp32.sum())!r} against "
              f"float64 {float(lp64.sum())!r} (largest rel diff {lp_rel:.3g}), launches a call {call_counts}; first "
              f"step's loss rel diff {rel:.3g}, its launches {step_counts}; smallest pivot of the precisions "
              f"{pivot:.3g}{' (a factorisation failed)' if failed else ''}")
        check(not failed and lp_rel <= GHMM_RTOL and rel <= TRAIN_LOSS_RTOL,
              f"{model}: log_prob rel {lp_rel:.3g}, loss rel {rel:.3g} against float64; pivot {pivot:.3g}")
        check(call_counts[kind] > 0 and step_counts[kind] > 0 and step_counts[f"{kind}_bwd"] > 0,
              f"{model}: no {kind} launch: {call_counts}, {step_counts}")
        check_grads(model, g32, g64, TRAIN_GRAD_TOL)

        pyro.clear_param_store()
        gp = example.make_gp(model, "eeg", name="gp")
        svi = example.make_svi(example.make_model(gp))
        losses, per_step = [], []
        for _ in range(TRAIN_STEPS):
            gl.reset_counts()
            losses.append(svi.step(targets))
            torch.cuda.synchronize()
            per_step.append({k: v for k, v in gl.launches.items() if v})
        check(all(math.isfinite(l) for l in losses), f"{model}: losses {losses}")
        for _ in range(GP_WARM_STEPS):
            svi.step(targets)
        ms = []
        for _ in range(GP_TIMED_STEPS):
            t0 = time.perf_counter()
            svi.step(targets)  # reads the loss: synced
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        ms.sort()
        mean = sum(ms) / len(ms)
        print(f"    {TRAIN_STEPS} steps: losses {[round(l, 3) for l in losses]}, launches a step {per_step[-1]}; "
              f"{GP_TIMED_STEPS} steps after {GP_WARM_STEPS} more: mean {mean:.3f} ms a step, median "
              f"{ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f}")
        wall, busy, ops, kernels = profile_run(torch, lambda: svi.step(targets), top=4)
        k4_ms = sum(e.self_device_time_total for e in kernels if kernel_name(e).startswith("gl_")) / 1e3
        print(f"    profiled step: {ops} device operations, busy {100 * busy / wall:.1f}%, K4 kernels {k4_ms:.4f} "
              f"device ms")
        out[model] = {"step_ms": mean, "busy_share": busy / wall, "ops": ops, "k4_ms": k4_ms,
                      "call_launches": call_counts, "step_launches": per_step[-1]}

    # a DependentMaternGP draw of the whole length through K4c: channels 0
    # and 1 correlated through the Wiener factor, then not
    pyro.clear_param_store()
    gp = example.make_gp("dmgp", "eeg", name="gp")
    gp.get_dist()
    store = pyro.get_param_store()
    tril = torch.eye(GP_EEG_CHANNELS, device="cuda")
    tril[1, :2] = torch.tensor([0.95, 0.31])
    gen = torch.Generator(device="cuda").manual_seed(0)
    corrs, mids_err, mids_levels = [], 0.0, 0
    for factor in (tril, torch.eye(GP_EEG_CHANNELS, device="cuda")):
        param_store_from_jax({"gp.wiener_noise_tril": factor.cpu().numpy()})
        with torch.no_grad(), record_levels(gl, "level_mids") as mids:
            x, counts = counted(torch, gl, "dmgp rsample", lambda: gp.get_dist(duration=GP_EEG_T).rsample(gen),
                                K4_KEYS)
        check(tuple(x.shape) == (GP_EEG_T, GP_EEG_CHANNELS) and bool(x.isfinite().all()) and counts["mids"] > 0,
              f"dmgp rsample: shape {tuple(x.shape)}, launches {counts}")
        corrs.append(float(torch.corrcoef(x.T.double())[0, 1]))
        # K4c at every level of this draw (n=28, one shared L and P_mk)
        # against its plain version on the recorded inputs
        check(mids, "dmgp rsample: no K4c level was recorded")
        with torch.no_grad():
            for i, args in enumerate(mids):
                mids_err = max(mids_err, check_k4_level(f"dmgp mids level {i}", (gl._mids_cuda(*args),),
                                                        (gl.level_mids_plain(*args),)))
        mids_levels += len(mids)
        del mids
    print(f"  dmgp draw of {GP_EEG_T} steps: channel 0-1 correlation {corrs[0]:.3f} with the coupled Wiener factor "
          f"(above 0.4 wanted), {corrs[1]:.3f} with the identity (within 0.25 of 0 wanted); K4c against its plain "
          f"version at the {mids_levels} levels of the two draws: max abs err {mids_err:.3g}")
    check(corrs[0] > 0.4 and abs(corrs[1]) < 0.25, f"dmgp draw correlations {corrs}")
    out["dmgp_rsample_launches"] = counts

    # 3. the guides on IndependentMaternGP at the EEG shape
    for name in GP_GUIDES:
        pyro.clear_param_store()
        gp, model, guide = _gp_guide(torch, name)
        svi = SVI(model, guide, Adam({"lr": 0.01}), Trace_ELBO())
        gl.reset_counts()
        t0 = time.perf_counter()
        losses = [svi.step(targets) for _ in range(GP_GUIDE_STEPS)]
        seconds = time.perf_counter() - t0
        steps_counts = {k: v for k, v in gl.launches.items() if v}
        store = pyro.get_param_store()
        leaves = store.get_all_unconstrained()
        guide_trace = poutine.trace(guide).get_trace(targets)
        sites = {k: s["value"] for k, s in guide_trace.nodes.items() if s["type"] == "sample"}
        off = sorted(k for k, v in {**leaves, **sites}.items() if v.device.type != "cuda")
        check(all(math.isfinite(l) for l in losses) and not off, f"{name}: losses {losses}, off the card {off}")
        check(steps_counts.get("contract", 0) > 0 and steps_counts.get("contract_bwd", 0) > 0,
              f"{name}: no K4b launch each way in {GP_GUIDE_STEPS} steps: {steps_counts}")
        latent = [k for k in sites if k.startswith("_")]
        cond = {k: sites[k].detach() for k in (latent or sites)}
        summary = ""
        if name not in ("AutoIAFNormal", "Parameterized"):
            with torch.no_grad():
                median, quantiles = guide.median(targets), guide.quantiles([0.1, 0.5, 0.9], targets)
            on_card = all(v.device.type == "cuda" for v in (*median.values(), *quantiles.values()))
            check(on_card and sorted(median) == sorted(quantiles), f"{name}: median/quantiles off the card")
            summary = (f"; median length_scale[:3] {median['gp.length_scale'][:3].tolist()}, its 0.1-0.9 quantiles "
                       f"on the card")
        with torch.no_grad():
            guide_lp, model_lp = elbo_at_latent(poutine, model, guide, cond, targets)
        pyro.set_default_device("cpu")
        try:
            pyro.clear_param_store()
            gp_cpu, model_cpu, guide_cpu = _gp_guide(torch, name)
            Trace_ELBO().loss(model_cpu, guide_cpu, targets.cpu())  # registers the params
            cpu_store = pyro.get_param_store()
            with torch.no_grad():
                for k, v in leaves.items():
                    cpu_store.get_unconstrained(k).copy_(v.detach().cpu())
                guide_lp_cpu, model_lp_cpu = elbo_at_latent(poutine, model_cpu, guide_cpu,
                                                            {k: v.cpu() for k, v in cond.items()}, targets.cpu())
        finally:
            pyro.clear_param_store()
            pyro.set_default_device("cuda")
        elbo_card, elbo_cpu = guide_lp - model_lp, guide_lp_cpu - model_lp_cpu
        rel = abs(elbo_card - elbo_cpu) / abs(elbo_cpu)
        guide_err = abs(guide_lp - guide_lp_cpu)
        print(f"  {name}: {GP_GUIDE_STEPS} steps in {seconds:.3f} s, losses {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"launches {steps_counts}; every param and draw on the card; -ELBO at one latent value "
              f"{elbo_card!r} (CPU {elbo_cpu!r}, rel {rel:.3g}), its guide term log q(z) {guide_lp!r} (CPU "
              f"{guide_lp_cpu!r}, abs diff {guide_err:.3g}){summary}")
        check(rel <= GP_ELBO_RTOL, f"{name}: -ELBO at a fixed latent rel {rel:.3g} from the CPU run's")
        check(guide_err <= GP_GUIDE_LP_RTOL * abs(guide_lp_cpu) + GP_GUIDE_LP_ATOL,
              f"{name}: log q(z) at a fixed latent {guide_lp!r} against the CPU run's {guide_lp_cpu!r}")
    pyro.clear_param_store()
    torch.cuda.empty_cache()
    return out


# -- slice 18: NUTS with the enumerated potential -----------------------------------

NE_CHAINS = 8  # chains of NUTS on model_1 and model_1v at 20.32.51.16
NE_ITERS, NE_MIN, NE_PROBE, NE_BUDGET_S = 150, 10, 3, 60.0  # warmup and samples each; probe iterations; seconds
# NUTS's tree depth in phase 20, cut from the default 10: early-warmup trees
# of model_1 ran to the full depth, 900 leaves an iteration of 8.7 ms each
NE_TREE_DEPTH = 6
NE_1V_ITERS = 2  # model_1v's warmup and samples, each
NE_F32_FACTOR = 3.0  # the card's potential and gradient against float64: at most this times the CPU's float32 run's
NE_LGSSM_CHAINS = 4


@contextlib.contextmanager
def record_calls(module, names):
    """Within the block, every call of ``module.<name>`` for each name:
    {name: [(args, result), ...]}."""
    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        def call(*args):
            out = fn(*args)
            calls[name].append((args, out))
            return out
        return call

    for name in names:
        setattr(module, name, recorder(name, saved[name]))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _flat_potential(torch, model, model_args, nesting, device):
    """The vmapped potential and gradient of ``model`` over flat unconstrained
    vectors (C, D) on ``device``."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.infer.mcmc.util import _ravel_fns, batched_potential_and_grad, get_potential_fn

    pyro.set_default_device(device)
    potential, _, transforms, proto, _ = get_potential_fn(
        model, model_args, generator=torch.Generator(device=device).manual_seed(0), max_plate_nesting=nesting)
    ravel, unravel = _ravel_fns({k: t.inv(proto.nodes[k]["value"]) for k, t in transforms.items()})
    return batched_potential_and_grad(lambda f: potential(unravel(f)))


def _potential_against_cpu(torch, label, model, model_args, nesting, z):
    """The card's vmapped potential and gradient at ``z`` (C, D) against the
    port's CPU run in float64 (and in float32, the rounding reference);
    returns the card's (pe, grad)."""
    import pyro_tpu_torch as pyro

    card_pg = _flat_potential(torch, model, model_args, nesting, "cuda")
    pe, grad = card_pg(z)
    torch.cuda.synchronize()
    cpu = {}
    try:
        for dtype in (torch.float64, torch.float32):
            with default_dtype(torch, dtype):
                cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in model_args)
                cpu_pg = _flat_potential(torch, model, cpu_args, nesting, "cpu")
                cpu[dtype] = cpu_pg(z.cpu().to(dtype))
    finally:
        pyro.set_default_device("cuda")
    return _check_potential(torch, label, (pe, grad), cpu[torch.float64], cpu[torch.float32])


def _check_potential(torch, label, card, cpu64, cpu32):
    """The card's (potential, gradient) no further from the CPU's float64
    run than NE_F32_FACTOR times the CPU's float32 run; returns the card's."""
    (pe, grad), (pe64, g64), (pe32c, g32c) = card, cpu64, cpu32
    pe_err = float((pe.double().cpu() - pe64).abs().max())
    pe_ref = float((pe32c.double() - pe64).abs().max())
    g_err = float((grad.double().cpu() - g64).abs().max())
    g_ref = float((g32c.double() - g64).abs().max())
    g_scale = float(g64.abs().max())
    print(f"  {label}: potential {float(pe64.abs().max()):.1f} at most; card {pe_err:.3g} from float64 "
          f"(the CPU's float32 run {pe_ref:.3g}); gradient (max {g_scale:.1f}) {g_err:.3g} from float64 (CPU float32 "
          f"{g_ref:.3g})")
    check(pe_err <= NE_F32_FACTOR * pe_ref + 1e-6 * float(pe64.abs().max()),
          f"{label}: the card's potential is {pe_err} from float64, over {NE_F32_FACTOR} x the CPU float32's {pe_ref}")
    check(g_err <= NE_F32_FACTOR * g_ref + 1e-6 * g_scale,
          f"{label}: the card's gradient is {g_err} from float64, over {NE_F32_FACTOR} x the CPU float32's {g_ref}")
    return pe, grad


def _check_k1_calls(torch, lm, calls):
    """Each K1 launch recorded inside the vmapped call against the plain
    version at the same (folded) operands."""
    worst_f, worst_b, shapes = 0.0, 0.0, set()
    for (x, y), (out, _, _) in calls["_forward_cuda"]:
        shapes.add((tuple(x.shape), tuple(y.shape)))
        want = lm._logmatmulexp_raw(x, y)
        err = max_err(out, want)
        worst_f = max(worst_f, err)
        # float32 rounds a log value v at 6e-8 |v|: atol 1e-4 plus 1e-6 of the largest
        check(err <= 1e-4 + 1e-6 * float(want.abs().max()),
              f"K1 forward inside the vmapped potential at {tuple(x.shape)} @ {tuple(y.shape)}: {err}")
    for (x, y, out, xs, ys, g), (dx, dy) in calls["_backward_cuda"]:
        for got, want, name in zip((dx, dy), lm._logmatmulexp_bwd(x, y, out, g), ("dx", "dy")):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            worst_b = max(worst_b, err / (scale + 1e-30))
            check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)),
                  f"K1 backward {name} inside the vmapped potential at {tuple(x.shape)}: {err} (max {scale})")
    print(f"  K1 inside the vmapped call: {len(calls['_forward_cuda'])} forward and {len(calls['_backward_cuda'])} "
          f"backward launches, operands {sorted(shapes)}; against the plain version: forward max abs err "
          f"{worst_f:.3g}, backward {worst_b:.3g} of max|grad|")
    return worst_f


def _check_k2_calls(torch, ms, calls):
    """Each K2 launch recorded inside the vmapped call against the plain
    version at the same (folded) operands: the forward, and the gradients
    of all its inputs by autograd of the plain scan."""
    worst_f, worst_b = 0.0, 0.0
    for (alpha0, A, R, L, plan), (out, _) in calls["_forward_cuda"]:
        want = ms.markov_scan_plain(alpha0, A, R, L)
        err = float((out - want).abs().max())
        worst_f = max(worst_f, err)
        check(err <= 1e-4 + 1e-6 * float(want.abs().max()), f"K2 forward inside the vmapped potential: {err}")
        print(f"    K2 forward at B={alpha0.shape[0]} (folded chains), S={alpha0.shape[1]}, T'={R.shape[0]}, "
              f"A {tuple(A.shape)}")
    for (A, L, saved, g), grads in calls["_backward_cuda"]:
        fwd = next(args for args, (_, s) in calls["_forward_cuda"] if s[1].data_ptr() == saved[1].data_ptr())
        leaves = [t.detach().requires_grad_() for t in fwd[:3]] + ([fwd[3].detach().requires_grad_()]
                                                                      if fwd[3] is not None else [])
        with torch.enable_grad():
            out = ms.markov_scan_plain(*leaves[:3], leaves[3] if len(leaves) > 3 else None)
            want = torch.autograd.grad(out, leaves, g)
        for got, w, name in zip(grads, want, ("dalpha0", "dA", "dR", "dL")):
            scale = float(w.abs().max())
            err = float((got - w).abs().max())
            worst_b = max(worst_b, err / (scale + 1e-30))
            check(bool(torch.allclose(got, w, rtol=1e-3, atol=1e-4 * scale)),
                  f"K2 backward {name} inside the vmapped potential: {err} (max {scale})")
    print(f"  K2 inside the vmapped call: {len(calls['_forward_cuda'])} forward and {len(calls['_backward_cuda'])} "
          f"backward launches; against the plain version: forward max abs err {worst_f:.3g}, backward "
          f"{worst_b:.3g} of max|grad|")
    return worst_f


def lgssm_log_prob(dist, targets, trans_matrix, obs_matrix, log_trans_var, log_obs_scale, log_init_var):
    """``GenericLGSSM.get_dist(T).log_prob(targets)`` as a function of its
    parameters (the positive ones by their logs)."""
    import torch

    n = trans_matrix.shape[-1]
    zeros = trans_matrix.new_zeros(n)
    init = dist.MultivariateNormal(zeros, covariance_matrix=torch.diag(log_init_var.exp()))
    trans = dist.MultivariateNormal(zeros[None], covariance_matrix=torch.diag(log_trans_var.exp())[None])
    obs_scale = log_obs_scale.exp()
    obs = dist.Normal(obs_scale.new_zeros(obs_scale.shape)[None], obs_scale[None]).to_event(1)
    hmm = dist.GaussianHMM(init, trans_matrix[None], trans, obs_matrix[None], obs, duration=targets.shape[0])
    return hmm.log_prob(targets)


def _lgssm_vmap_grad(torch, gl):
    """vmap(grad(GaussianHMM.log_prob)) at the lgssm shape (obs 4, state 16,
    T=4000; K4b) over 4 chains' parameters, through the kernels in float32
    against the plain levels in float64 on the card."""
    import numpy as np

    import pyro_tpu_torch.distributions as dist
    from pyro_tpu_torch.examples import lgssm

    rng = np.random.default_rng(0)
    C, n, m = NE_LGSSM_CHAINS, lgssm.STATE_DIM, lgssm.OBS_DIM
    params = [np.eye(n) + 0.03 * rng.standard_normal((C, n, n)), 0.3 * rng.standard_normal((C, n, m)),
              np.log(0.1) + 0.1 * rng.standard_normal((C, n)), np.log(0.2) + 0.1 * rng.standard_normal((C, m)),
              0.1 * rng.standard_normal((C, n))]
    fn = torch.func.vmap(torch.func.grad_and_value(
        lambda *p, targets: lgssm_log_prob(dist, targets, *p), argnums=(0, 1, 2, 3, 4)))
    out = {}
    for dtype in (torch.float32, torch.float64):
        targets = lgssm.make_targets(0, dtype)
        args = [torch.tensor(p, dtype=dtype, device="cuda") for p in params]
        gl.reset_counts()
        if dtype == torch.float32:
            grads, lp = fn(*args, targets=targets)
            torch.cuda.synchronize()
            launches = dict(gl.launches)
        else:
            with plain_levels(gl):
                grads, lp = fn(*args, targets=targets)
        out[dtype] = (lp, grads)
    (lp32, g32), (lp64, g64) = out[torch.float32], out[torch.float64]
    lp_err = float((lp32.double() - lp64).abs().max() / lp64.abs().max())
    print(f"  vmap(grad(GaussianHMM.log_prob)) at the lgssm shape, {C} chains, T={lgssm.make_targets(0).shape[0]}: "
          f"log_prob {[round(float(v), 3) for v in lp64]}, rel err {lp_err:.3g}; K4 launches {launches}")
    check(lp_err <= TRAIN_LOSS_RTOL, f"lgssm vmapped log_prob rel err {lp_err} against float64")
    names = ("trans_matrix", "obs_matrix", "log_trans_var", "log_obs_scale", "log_init_var")
    for name, a, b in zip(names, g32, g64):
        scale = float(b.abs().max())
        err = float((a.double() - b).abs().max())
        print(f"    d/d{name}: {err:.3g} of max {scale:.3g}")
        check(err <= TRAIN_GRAD_TOL * scale, f"lgssm vmapped gradient {name}: {err} over {TRAIN_GRAD_TOL} x {scale}")
    check(launches["contract"] > 0 and launches["contract_bwd"] == launches["contract"],
          f"K4b under vmap(grad): launches {launches}")


def phase_nuts_enum(torch, lm, ms, gl, smi):
    """Phase 20: NUTS over model_1's enumerated potential (K1 inside the
    captured leaf), model_1v's (K2), and vmap(grad) through K4b."""
    print(f"phase 20: NUTS with the enumerated potential, model_1 at {M1_B}.{M1_T}.{D}.{M1_S}, {NE_CHAINS} chains "
          f"({smi})")
    import numpy as np

    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import hmm as example
    from pyro_tpu_torch.infer import MCMC, NUTS
    from pyro_tpu_torch.infer.mcmc.nuts import _Leaves
    from pyro_tpu_torch.ops.stats import effective_sample_size, split_gelman_rubin

    pyro.set_default_device("cuda")
    args = example.parse_args(["--model", "1", "--hidden-dim", str(M1_S), "--num-sequences", str(M1_B),
                               "--max-length", str(M1_T), "--data-dim", str(D)])
    sequences, lengths = example.synthetic_sequences(0, M1_B, M1_T, D)
    model_args = (sequences, lengths, args)
    dims = M1_S * (M1_S - 1) + M1_S * D
    z = torch.tensor(np.random.default_rng(0).uniform(-1.5, 1.5, (NE_CHAINS, dims)).astype(np.float32),
                     device="cuda")

    # the vmapped potential and gradient at fixed points, with K1 inside it
    lm.launches.update(forward=0, backward=0)
    with record_calls(lm, ("_forward_cuda", "_backward_cuda")) as calls:
        _potential_against_cpu(torch, "model_1 potential", example.model_1, model_args, 2, z)
    counts = dict(lm.launches)
    print(f"  K1 launches in one vmapped potential-and-gradient call of {NE_CHAINS} chains: {counts}")
    check(counts == {"forward": 9, "backward": 9}, f"model_1's vmapped potential launched K1 {counts}, not 9 + 9")
    _check_k1_calls(torch, lm, calls)

    # NUTS: a probe sets the iteration counts
    class TimedNUTS(NUTS):
        def sample_step(self, state, generator):
            if state.i == self._num_warmup:
                torch.cuda.synchronize()
                self.warmup_end = time.perf_counter()
            return super().sample_step(state, generator)

    generator = torch.Generator(device="cuda").manual_seed(0)
    print(f"  CUT: max_tree_depth {NE_TREE_DEPTH} instead of 10 (trees of the default depth ran 900 leaves an "
          f"iteration early in warmup)")
    probe = NUTS(example.model_1, max_plate_nesting=2, max_tree_depth=NE_TREE_DEPTH)
    t0 = time.perf_counter()
    MCMC(probe, num_samples=1, warmup_steps=NE_PROBE, num_chains=NE_CHAINS).run(*model_args, generator=generator)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / (NE_PROBE + 1)
    b = next(iter(probe._leaf_buffers.values()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        b.graph.replay()
    torch.cuda.synchronize()
    full_tree_s = (2 ** NE_TREE_DEPTH) * (time.perf_counter() - t0) / 5
    # the probe's early trees are shallow (and its first iteration holds the
    # set-up and the capture); a later tree may run to the full depth, with
    # the host's work between leaves (some 20% more on the first runs)
    n = max(NE_MIN, min(NE_ITERS, int(NE_BUDGET_S / (2 * 1.2 * full_tree_s))))
    print(f"  probe: {NE_PROBE + 1} iterations (with the set-up and the leaf's capture) at {per_iter:.3f} s each, "
          f"{probe.counts['leapfrogs'] / (NE_PROBE + 1):.1f} leaves each; a tree of the full depth {full_tree_s:.3f} s")
    if n < NE_ITERS:
        print(f"  CUT: {n} warmup iterations and {n} samples instead of {NE_ITERS} and {NE_ITERS}, to stay near "
              f"{NE_BUDGET_S} s")
    kernel = TimedNUTS(example.model_1, max_plate_nesting=2, max_tree_depth=NE_TREE_DEPTH)
    mcmc = MCMC(kernel, num_samples=n, warmup_steps=n, num_chains=NE_CHAINS)
    lm.launches.update(forward=0, backward=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(*model_args, generator=generator)
    samples = mcmc.get_samples(group_by_chain=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run_launches = dict(lm.launches)
    run_s, sample_s = t1 - t0, t1 - kernel.warmup_end
    leaves = kernel.counts["leapfrogs"]
    check(all(b.graph is not None for b in kernel._leaf_buffers.values()), "the NUTS leaf was not captured")
    check(run_launches["forward"] > 0 and run_launches["backward"] > 0, f"K1 not launched by the run: {run_launches}")
    print(f"  K1 launches over the run (the wrapper counts a graph's capture, not its replays): {run_launches}")
    total_ess, counted = 0.0, 0
    for site, v in samples.items():
        check(bool(torch.isfinite(v).all()), f"non-finite draws of {site}")
        flat = v.reshape(v.shape[:2] + (-1,))
        # an entry that one chain never changed (a probability clamped at the
        # float32 floor) has no autocorrelation there: its ESS is NaN
        varied = (flat.std(1) > 0).all(0)
        ess = effective_sample_size(flat[..., varied])
        r_hat = split_gelman_rubin(flat[..., varied])
        total_ess += float(ess.sum())
        counted += int(varied.sum())
        print(f"  {site} {tuple(v.shape[2:])}: {int(varied.sum())} of {flat.shape[-1]} entries varied in every "
              f"chain: ESS min {float(ess.min()):.1f} median {float(ess.median()):.1f}, split r_hat max "
              f"{float(r_hat.max()):.3f} median {float(r_hat.median()):.3f} (the chains may settle in different "
              f"labellings of the hidden states)")
    check(bool(((samples["probs_x"].sum(-1) - 1).abs() < 1e-4).all()), "probs_x off the simplex")
    accept = float(mcmc._diagnostics_extra["accept_prob"].mean())
    print(f"  {n} + {n} iterations in {run_s:.2f} s ({2 * n / run_s:.2f} iterations/s; sampling {sample_s:.2f} s), "
          f"{leaves} leaves ({leaves / (2 * n):.1f} an iteration), mean accept probability after warmup {accept:.3f}")
    print(f"  ESS per second (probs_x and probs_y, summed over the {counted} entries that varied, over the run's "
          f"wall time): {total_ess / run_s:.2f}")

    # a replayed leaf against one eager potential-and-gradient call of the same chains
    b = next(iter(kernel._leaf_buffers.values()))
    b.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        b.graph.replay()
    end.record()
    torch.cuda.synchronize()
    leaf_ms = start.elapsed_time(end) / 10
    state = mcmc.last_state
    kernel._potential_and_grad(state.z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        kernel._potential_and_grad(state.z)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"  a replayed leaf {leaf_ms:.3f} ms (CUDA events, 10 replays); one eager potential-and-gradient call of "
          f"the same {NE_CHAINS} chains {eager_ms:.3f} ms (host clock)")
    wall, busy, ops, events = profile_run(torch, b.graph.replay, top=6)
    k1_events = [e for e in events if "lme_" in e.key]
    by_name = {kernel_name(e): e.count for e in k1_events}
    k1_ms = sum(e.self_device_time_total for e in k1_events) / 1e3
    fwd = sum(c for name, c in by_name.items() if name.startswith("lme_max"))
    bwd = sum(c for name, c in by_name.items() if name.startswith("lme_stats"))
    print(f"  profiled leaf: busy {100 * busy / wall:.1f}%, K1 {k1_ms:.3f} device ms, K1 kernels {by_name}: "
          f"{fwd} forward and {bwd} backward launches")
    check(fwd == 9 and bwd == 9, f"the replayed leaf ran K1 {fwd} forward and {bwd} backward, not 9 + 9")

    # the graphed leaf against the same leaf run eagerly, a depth-3 subtree from the last state
    class EagerNUTS(NUTS):
        def _leaves(self, C, n_dim, like):
            return self._leaf_buffers.setdefault((C, n_dim), _Leaves(C, n_dim, self.max_tree_depth, like))

    eager = EagerNUTS(example.model_1, max_plate_nesting=2)
    eager.setup(0, *model_args, generator=torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    r = torch.randn(state.z.shape, generator=gen, device="cuda")
    inv, step = state.adapt.inverse_mass_diag, state.adapt.step_size
    energy0 = state.potential_energy + 0.5 * (inv * r * r).sum(-1)
    direction = torch.where(torch.rand(step.shape, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    trees = [k._build_subtree(3, state.z, r, state.z_grad, energy0, direction, step, inv,
                              torch.Generator(device="cuda").manual_seed(6))[0] for k in (kernel, eager)]
    worst = 0.0
    for name, a, c in zip(trees[0]._fields, *trees):
        a, c = a.double(), c.double()
        finite = torch.isfinite(c)
        check(bool((torch.isfinite(a) == finite).all()), f"graphed model_1 subtree: {name} finite where eager is not")
        scale = float(c[finite].abs().max()) if bool(finite.any()) else 0.0
        err = float((a - c)[finite].abs().max()) if bool(finite.any()) else 0.0
        worst = max(worst, err / (scale + 1e-30))
        check(err <= 1e-5 * scale + 1e-6, f"graphed model_1 subtree: {name} is {err} from the eager leaf's")
    print(f"  graphed leaf against the eager leaf, depth-3 subtree: largest difference {worst:.3g} of a field's "
          f"largest entry")

    # model_1v through K2 under the same NUTS
    args_v = example.parse_args(["--model", "1v", "--hidden-dim", str(M1_S), "--num-sequences", str(M1_B),
                                 "--max-length", str(M1_T), "--data-dim", str(D)])
    model_v_args = (sequences, lengths, args_v)
    ms.reset_counts()
    with record_calls(ms, ("_forward_cuda", "_backward_cuda")) as calls:
        _potential_against_cpu(torch, "model_1v potential", example.model_1v, model_v_args, 3, z)
    print(f"  K2 launches in one vmapped call: {ms.launches}, by route {ms.route_launches}")
    check(ms.launches == {"forward": 1, "backward": 1}, f"model_1v's vmapped potential launched K2 {ms.launches}")
    _check_k2_calls(torch, ms, calls)
    ms.reset_counts()
    kernel_v = NUTS(example.model_1v, max_plate_nesting=3, max_tree_depth=NE_TREE_DEPTH)
    t0 = time.perf_counter()
    mcmc_v = MCMC(kernel_v, num_samples=NE_1V_ITERS, warmup_steps=NE_1V_ITERS, num_chains=NE_CHAINS)
    mcmc_v.run(*model_v_args, generator=torch.Generator(device="cuda").manual_seed(1))
    samples_v = mcmc_v.get_samples()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in samples_v.values()), "non-finite model_1v draws")
    check(all(b.graph is not None for b in kernel_v._leaf_buffers.values()), "the model_1v leaf was not captured")
    check(ms.launches["forward"] > 0 and ms.launches["backward"] > 0, f"K2 not launched by NUTS: {ms.launches}")
    print(f"  model_1v: {NE_1V_ITERS} + {NE_1V_ITERS} iterations in {time.perf_counter() - t0:.2f} s with the set-up, "
          f"{kernel_v.counts['leapfrogs']} leaves; K2 launches {ms.launches} (captured once)")

    _lgssm_vmap_grad(torch, gl)
    return {"leaf_ms": leaf_ms, "iterations": n, "run_s": run_s}


# -- slice 19: forecasting through K4 ---------------------------------------------------

FC_STEPS, FC_DRAWS, FC_LR = 500, 100, 0.05  # examples/forecast_bart.py's defaults
FC_LONG_STEPS = 20  # timed SVI steps at the length of upstream's BART counts, after a warm-up step
FC_MOMENT_DRAWS = 4000  # draws of the prefix-conditioned noise held against its exact moments
FC_SE, FC_VAR_RTOL = 5.0, 0.1  # the draws' mean within 5 standard errors, their variance within 10%
FC_HMC_CHAINS, FC_HMC_ITERS, FC_HMC_MIN, FC_HMC_PROBE, FC_HMC_BUDGET_S = 4, 200, 10, 3, 60.0
# HMCForecaster's tree depth in phase 21, cut from its default 10 as phase 20 cuts NUTS's
FC_HMC_TREE_DEPTH = 6
FC_KEYS = ("contract", "contract_bwd", "mids", "halving", "halving_bwd")


def _per(counts, n):
    return {k: v / n for k, v in counts.items() if v}


def _guide_at(pyro, tdist, values):
    """A guide whose sites are Deltas at ``values``."""

    def guide(*args):
        for name, value in values.items():
            pyro.sample(name, tdist.Delta(value, event_dim=value.ndim))

    return guide


def _forecast_first_step(torch, gl, data, cov, latent):
    """The example Model's -ELBO at one latent value (the AutoNormal guide's
    sites conditioned there) with the gradient of every guide parameter,
    and the gradient of the model's log joint in the latents, through the
    kernels in float32 and through the plain levels in float64 on the card
    at the same parameters."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.examples import forecast_bart as example
    from pyro_tpu_torch.infer import Trace_ELBO
    from pyro_tpu_torch.infer.autoguide import AutoNormal
    from pyro_tpu_torch.params import param_store_from_jax

    out, init = {}, None
    for dtype in (torch.float32, torch.float64):
        pyro.clear_param_store()
        with default_dtype(torch, dtype), (plain_levels(gl) if dtype == torch.float64 else contextlib.nullcontext()):
            model = example.Model()
            guide = AutoNormal(lambda d, c: model(d, c), init_scale=0.1)
            args = (data.to(dtype), cov.to(dtype))
            Trace_ELBO().loss(lambda d, c: model(d, c), guide, *args)  # registers the params
            store = pyro.get_param_store()
            if init is None:
                init = {k: store[k].detach().double().cpu().numpy() for k in store.get_all_unconstrained()}
            else:
                param_store_from_jax(init)
            z = {k: v.detach().to(dtype).requires_grad_() for k, v in latent.items()}
            gl.reset_counts()
            with poutine.trace(param_only=True) as capture:
                guide_trace = poutine.trace(poutine.condition(guide, data=z)).get_trace(*args)
                model_trace = poutine.trace(poutine.condition(model, data=z)).get_trace(*args)
                loss = guide_trace.log_prob_sum() - model_trace.log_prob_sum()
            loss.backward()
            torch.cuda.synchronize()
            grads = {k: store.get_unconstrained(k).grad.double() for k in capture.trace.param_nodes()}
            grads.update({f"latent {k}": v.grad.double() for k, v in z.items()})
            out[dtype] = (float(loss.detach()), grads, dict(gl.launches))
    pyro.clear_param_store()
    return out[torch.float32], out[torch.float64]


def _check_forecast_first_step(torch, gl, label, data, cov, latent):
    (loss32, g32, launches), (loss64, g64, _) = _forecast_first_step(torch, gl, data, cov, latent)
    rel = abs(loss32 - loss64) / abs(loss64)
    print(f"  {label}: first step's -ELBO at one latent value {loss32!r} against float64 {loss64!r} (rel {rel:.3g}); "
          f"its K4 launches {_per(launches, 1)}")
    check(rel <= TRAIN_LOSS_RTOL, f"{label}: first-step loss rel {rel:.3g} against float64")
    check(launches["contract"] > 0 and launches["contract_bwd"] > 0, f"{label}: first step launched {launches}")
    check_grads(label, g32, g64, TRAIN_GRAD_TOL)


def _recorded_levels(torch, gl, label, fn, names):
    """``fn()`` with every call of the K4 wrappers ``names`` recorded, each
    recorded call then run through the kernel and the plain version and
    held against each other (``check_k4_level``); returns {name: (levels,
    max abs err)}."""
    plain = {"contract_pairs": gl.contract_pairs_plain, "level_mids": gl.level_mids_plain,
             "_contract_bwd_cuda": gl.contract_pairs_bwd_plain}
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(record_levels(gl, name)) for name in names}
        fn()
        torch.cuda.synchronize()
    out = {}
    with torch.no_grad():
        for name, recorded in calls.items():
            err = 0.0
            for i, args in enumerate(recorded):
                if name == "contract_pairs":
                    got = gl.contract_pairs(*args)[:3]
                    want = plain[name](*args)[:3]
                elif name == "level_mids":
                    got, want = (gl.level_mids(*args),), (plain[name](*args),)
                else:
                    got, want = _sym_p(gl._contract_bwd_cuda(*args)), _sym_p(plain[name](*args))
                err = max(err, check_k4_level(f"{label} {name} level {i}", got, want))
            out[name] = (len(recorded), err)
    print(f"  {label}: recorded K4 levels against their plain versions (count, max abs err): {out}")
    return out


def _local_level_conditional(np, y, t_obs, trans_scale, obs_scale, init_scale=10.0):
    """The exact mean and variance of y[t_obs:] given y[:t_obs] for the
    local level y_t = z_t + v_t, z_t = z_{t-1} + w_t, z_0 ~ N(0,
    init_scale^2) (t = 1 .. T), densely in float64."""
    T_all = y.shape[0]
    steps = np.arange(1, T_all + 1)
    cov = init_scale**2 + np.minimum.outer(steps, steps) * trans_scale**2 + np.eye(T_all) * obs_scale**2
    o, f = slice(0, t_obs), slice(t_obs, T_all)
    gain = cov[f, o] @ np.linalg.inv(cov[o, o])
    return gain @ y[o], np.diag(cov[f, f] - gain @ cov[o, f])


def _check_forecast_moments(torch, label, forecaster, data, cov, t_train):
    """With the latents at the guide's median: FC_MOMENT_DRAWS draws of the
    prefix-conditioned noise against the exact conditional moments, then
    the forecaster's own FC_DRAWS draws against the exact mean."""
    import numpy as np

    import pyro_tpu_torch as pyro
    import pyro_tpu_torch.distributions as tdist
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.ops.tensor_utils import periodic_repeat

    median = {k: v.detach() for k, v in forecaster.guide.median(data[:t_train], cov[:t_train]).items()}
    with torch.no_grad():
        trace = poutine.trace(poutine.condition(forecaster.model, data=median)).get_trace(data[:t_train], cov)
        cond = trace.nodes["residual"]["fn"]
        prediction = periodic_repeat(median["weekly"], data.shape[0], dim=-2)
        residual = (data - prediction)[:, 0].double().cpu().numpy()
        mean, var = _local_level_conditional(np, residual, t_train, float(median["trans_scale"]),
                                             float(median["obs_scale"]))
        draws = cond.rsample(torch.Generator(device="cuda").manual_seed(2), (FC_MOMENT_DRAWS,))[..., 0].double()
        t_mean = np.abs(draws.mean(0).cpu().numpy() - mean) / np.sqrt(var / FC_MOMENT_DRAWS)
        v_rel = np.abs(draws.var(0).cpu().numpy() - var) / var
        guide = forecaster.guide
        forecaster.guide = _guide_at(pyro, tdist, median)
        try:
            samples = forecaster(data[:t_train], cov, num_samples=FC_DRAWS,
                                 generator=torch.Generator(device="cuda").manual_seed(3))
        finally:
            forecaster.guide = guide
        f_mean = mean + prediction[t_train:, 0].double().cpu().numpy()
        t_fc = np.abs(samples[..., 0].double().mean(0).cpu().numpy() - f_mean) / np.sqrt(var / FC_DRAWS)
    print(f"  {label}: at the guide's median, {FC_MOMENT_DRAWS} draws of the prefix-conditioned noise over "
          f"{data.shape[0] - t_train} steps: mean at most {t_mean.max():.2f} standard errors from the exact "
          f"conditional's (mean {t_mean.mean():.2f}), variance at most {v_rel.max():.3g} of it off; the forecaster's "
          f"{FC_DRAWS} draws at most {t_fc.max():.2f} standard errors from the exact mean")
    check(t_mean.max() <= FC_SE and v_rel.max() <= FC_VAR_RTOL and t_fc.max() <= FC_SE,
          f"{label}: forecast moments off the exact conditional ({t_mean.max():.3g} SE, {v_rel.max():.3g}, "
          f"{t_fc.max():.3g} SE)")


def _hmc_first_step(torch, gl, fc, data, cov):
    """HMCForecaster's vmapped potential and gradient of its chains at fixed
    unconstrained points (numpy seed 0) through the kernels in float32,
    against the plain levels in float64 on the card; returns the K4
    launches of the float32 call."""
    import numpy as np

    dims = sum(v[0].numel() for v in fc._samples.values())
    z = np.random.default_rng(0).uniform(-1.0, 1.0, (FC_HMC_CHAINS, dims))
    out = {}
    for dtype in (torch.float32, torch.float64):
        with default_dtype(torch, dtype), (plain_levels(gl) if dtype == torch.float64 else contextlib.nullcontext()):
            pg = _flat_potential(torch, fc._model_fn, (data.to(dtype), cov.to(dtype)), None, "cuda")
            gl.reset_counts()
            pe, grad = pg(torch.tensor(z, dtype=dtype, device="cuda"))
            torch.cuda.synchronize()
            out[dtype] = (pe.double(), grad.double(), dict(gl.launches))
    (pe32, g32, launches), (pe64, g64, _) = out[torch.float32], out[torch.float64]
    rel = float(((pe32 - pe64).abs() / pe64.abs()).max())
    g_err, g_scale = float((g32 - g64).abs().max()), float(g64.abs().max())
    print(f"  HMCForecaster's vmapped potential of {FC_HMC_CHAINS} chains ({dims} dims): rel err {rel:.3g} against "
          f"float64; gradient {g_err:.3g} of max {g_scale:.3g}; K4 launches in the call {_per(launches, 1)}")
    check(rel <= TRAIN_LOSS_RTOL and g_err <= TRAIN_GRAD_TOL * g_scale,
          f"HMC potential rel {rel:.3g}, gradient {g_err:.3g} of {g_scale:.3g} against float64")
    check(launches["contract"] > 0 and launches["contract_bwd"] > 0, f"HMC potential launched {launches}")
    return launches


def phase_forecast(torch, gl, smi):
    """Phase 21: forecasting through K4: (a) examples/forecast_bart.py as it
    stands, (b) its Model at the length of upstream's BART counts, (c)
    HMCForecaster with the DCT time reparam."""
    print(f"phase 21: forecasting through K4 ({smi})")
    import numpy as np

    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.contrib.forecast import Forecaster, HMCForecaster
    from pyro_tpu_torch.examples import forecast_bart as example
    from pyro_tpu_torch.infer import SVI, Trace_ELBO
    from pyro_tpu_torch.optim import DCTAdam

    pyro.set_default_device("cuda")
    out = {}

    # (a) the JAX example as it stands: load_fake_od, 744 hours, t_train 595
    pyro.clear_param_store()
    data, t_train = example.fake_data()
    T_all = data.shape[0]
    cov = data.new_zeros((T_all, 0))
    latent = {"weekly": data[:t_train - t_train % 168].reshape(-1, 168, 1).mean(0),
              "trans_scale": torch.tensor(0.1, device="cuda"), "obs_scale": torch.tensor(0.2, device="cuda")}
    _check_forecast_first_step(torch, gl, "(a) fake_od", data[:t_train], cov[:t_train], latent)
    pyro.clear_param_store()
    gl.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecaster = Forecaster(example.Model(), data[:t_train], cov[:t_train], num_steps=FC_STEPS, learning_rate=FC_LR,
                            generator=torch.Generator(device="cuda").manual_seed(0))
    train_s = time.perf_counter() - t0  # the losses were read: synced
    train_launches = {k: gl.launches[k] for k in FC_KEYS}
    losses = forecaster.losses
    check(all(math.isfinite(l) for l in losses) and np.mean(losses[-20:]) < np.mean(losses[:20]),
          f"(a): losses {losses[:3]} ... {losses[-3:]}")
    check(train_launches["contract"] > 0 and train_launches["contract_bwd"] > 0, f"(a) training: {train_launches}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    samples, call_launches = counted(torch, gl, "(a) a forecast call", lambda: forecaster(
        data[:t_train], cov, num_samples=FC_DRAWS, generator=gen), FC_KEYS)
    check(call_launches["contract"] > 0 and call_launches["mids"] > 0, f"(a) forecast: {call_launches}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = forecaster(data[:t_train], cov, num_samples=FC_DRAWS, generator=gen)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    check(samples.shape == (FC_DRAWS, T_all - t_train, 1) and bool(samples.isfinite().all()),
          f"(a) forecast {tuple(samples.shape)}")
    mae = float((samples.mean(0)[:, 0] - data[t_train:, 0]).abs().mean())
    print(f"  (a) fake_od (744 hours, t_train {t_train}): {FC_STEPS} DCTAdam steps in {train_s:.3f} s "
          f"({1e3 * train_s / FC_STEPS:.3f} ms a step, with the set-up), loss {losses[0]:.2f} -> {losses[-1]:.2f}; "
          f"K4 launches a step {_per(train_launches, FC_STEPS)}; a forecast call of {FC_DRAWS} draws {call_ms:.3f} ms "
          f"({call_ms / FC_DRAWS:.3f} ms a draw), launches a draw {_per(call_launches, FC_DRAWS)}; MAE over the "
          f"{T_all - t_train} held-out hours {mae:.4f}")
    svi = SVI(lambda d, c: forecaster.model(d, c), forecaster.guide, DCTAdam({"lr": FC_LR}), Trace_ELBO())
    step_levels = _recorded_levels(torch, gl, "(a) a training step", lambda: svi.step(data[:t_train], cov[:t_train]),
                                   ("contract_pairs", "_contract_bwd_cuda"))
    call_levels = _recorded_levels(torch, gl, "(a) a forecast draw", lambda: forecaster(
        data[:t_train], cov, num_samples=1, generator=gen), ("contract_pairs", "level_mids"))
    wall, busy, ops, kernels = profile_run(torch, lambda: svi.step(data[:t_train], cov[:t_train]), top=5)
    k4_ms = sum(e.self_device_time_total for e in kernels if kernel_name(e).startswith("gl_")) / 1e3
    print(f"  (a) profiled step: {ops} device operations, busy {100 * busy / wall:.1f}%, K4 {k4_ms:.4f} device ms")
    _check_forecast_moments(torch, "(a)", forecaster, data, cov, t_train)
    out["fake"] = {"step_ms": 1e3 * train_s / FC_STEPS, "call_ms": call_ms, "mae": mae, "busy_share": busy / wall,
                   "step_launches": _per(train_launches, FC_STEPS), "draw_launches": _per(call_launches, FC_DRAWS),
                   "levels": (step_levels, call_levels)}

    # (b) the same Model at the length of upstream's BART counts
    pyro.clear_param_store()
    data, t_train = example.synthetic_total_ridership(0)
    T_all = data.shape[0]
    cov = data.new_zeros((T_all, 0))
    latent = {"weekly": data[:t_train - t_train % 168].reshape(-1, 168, 1).mean(0),
              "trans_scale": torch.tensor(0.1, device="cuda"), "obs_scale": torch.tensor(0.1, device="cuda")}
    _check_forecast_first_step(torch, gl, f"(b) T={T_all}", data[:t_train], cov[:t_train], latent)
    pyro.clear_param_store()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecaster = Forecaster(example.Model(), data[:t_train], cov[:t_train], num_steps=1, learning_rate=FC_LR,
                            generator=torch.Generator(device="cuda").manual_seed(0))
    warm_s = time.perf_counter() - t0
    svi = SVI(lambda d, c: forecaster.model(d, c), forecaster.guide, DCTAdam({"lr": FC_LR}), Trace_ELBO())
    svi.step(data[:t_train], cov[:t_train])
    _, step_launches = counted(torch, gl, f"(b) a step at T={t_train}",
                               lambda: svi.step(data[:t_train], cov[:t_train]), FC_KEYS)
    ms = []
    for _ in range(FC_LONG_STEPS):
        t0 = time.perf_counter()
        svi.step(data[:t_train], cov[:t_train])  # reads the loss: synced
        ms.append(1e3 * (time.perf_counter() - t0))
    ms.sort()
    step_ms = sum(ms) / len(ms)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, long_call = counted(torch, gl, "(b) a forecast call", lambda: forecaster(
        data[:t_train], cov, num_samples=FC_DRAWS, generator=gen), FC_KEYS)
    long_call_ms = 1e3 * (time.perf_counter() - t0)
    check(samples.shape == (FC_DRAWS, T_all - t_train, 1) and bool(samples.isfinite().all()),
          f"(b) forecast {tuple(samples.shape)}")
    check(step_launches["contract"] > 0 and step_launches["contract_bwd"] > 0 and long_call["mids"] > 0,
          f"(b): launches {step_launches}, {long_call}")
    mae = float((samples.mean(0)[:, 0] - data[t_train:, 0]).abs().mean())
    print(f"  (b) T={T_all} (train {t_train}): warm-up Forecaster (set-up and one step) {warm_s:.3f} s; "
          f"{FC_LONG_STEPS} steps mean {step_ms:.3f} ms, median {ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max "
          f"{ms[-1]:.3f}; launches a step {step_launches}; a forecast call of {FC_DRAWS} draws {long_call_ms:.3f} ms, "
          f"launches a draw {_per(long_call, FC_DRAWS)}; MAE over the {T_all - t_train} held-out hours {mae:.4f}")
    step_levels = _recorded_levels(torch, gl, "(b) a training step", lambda: svi.step(data[:t_train], cov[:t_train]),
                                   ("contract_pairs", "_contract_bwd_cuda"))
    call_levels = _recorded_levels(torch, gl, "(b) a forecast draw", lambda: forecaster(
        data[:t_train], cov, num_samples=1, generator=gen), ("contract_pairs", "level_mids"))
    wall, busy, ops, kernels = profile_run(torch, lambda: svi.step(data[:t_train], cov[:t_train]), top=5)
    k4_ms = sum(e.self_device_time_total for e in kernels if kernel_name(e).startswith("gl_")) / 1e3
    print(f"  (b) profiled step: {ops} device operations, busy {100 * busy / wall:.1f}%, K4 {k4_ms:.4f} device ms")
    out["long"] = {"step_ms": step_ms, "call_ms": long_call_ms, "mae": mae, "busy_share": busy / wall,
                   "step_launches": step_launches, "draw_launches": _per(long_call, FC_DRAWS),
                   "levels": (step_levels, call_levels)}

    # (c) HMCForecaster on the example's model and data, DCT time reparam
    pyro.clear_param_store()
    data, t_train = example.fake_data()
    T_all = data.shape[0]
    cov = data.new_zeros((T_all, 0))
    print(f"  CUT: (c) max_tree_depth {FC_HMC_TREE_DEPTH} instead of HMCForecaster's 10")
    t0 = time.perf_counter()
    probe = HMCForecaster(example.Model(), data[:t_train], cov[:t_train], num_warmup=FC_HMC_PROBE, num_samples=1,
                          num_chains=FC_HMC_CHAINS, time_reparam="dct", max_tree_depth=FC_HMC_TREE_DEPTH,
                          generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    kernel = probe._mcmc.kernel
    b = next(iter(kernel._leaf_buffers.values()))
    check(b.graph is not None, "(c): the NUTS leaf was not captured")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        b.graph.replay()
    torch.cuda.synchronize()
    leaf_s = (time.perf_counter() - t0) / 5
    full_tree_s = (2 ** FC_HMC_TREE_DEPTH) * leaf_s
    n = max(FC_HMC_MIN, min(FC_HMC_ITERS, int(FC_HMC_BUDGET_S / (2 * 1.2 * full_tree_s))))
    print(f"  (c) probe: {FC_HMC_PROBE + 1} iterations with the set-up and the capture in {probe_s:.2f} s, "
          f"{kernel.counts['leapfrogs'] / (FC_HMC_PROBE + 1):.1f} leaves each; a replayed leaf {1e3 * leaf_s:.3f} ms")
    if n < FC_HMC_ITERS:
        print(f"  CUT: (c) {n} warmup iterations and {n} samples instead of {FC_HMC_ITERS} and {FC_HMC_ITERS}, to "
              f"stay near {FC_HMC_BUDGET_S} s")
    leaf_launches = _hmc_first_step(torch, gl, probe, data[:t_train], cov[:t_train])
    gl.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fc = HMCForecaster(example.Model(), data[:t_train], cov[:t_train], num_warmup=n, num_samples=n,
                       num_chains=FC_HMC_CHAINS, time_reparam="dct", max_tree_depth=FC_HMC_TREE_DEPTH,
                       generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = {k: gl.launches[k] for k in FC_KEYS}
    leaves = fc._mcmc.kernel.counts["leapfrogs"]
    check(sorted(fc._samples) == ["obs_scale", "trans_scale", "weekly_dct"], f"(c) sites {sorted(fc._samples)}")
    check(all(bool(v.isfinite().all()) for v in fc._samples.values()), "(c) non-finite draws")
    check(run_launches["contract"] > 0 and run_launches["contract_bwd"] > 0, f"(c) run launches {run_launches}")
    accept = float(fc._mcmc._diagnostics_extra["accept_prob"].mean())
    b = next(iter(fc._mcmc.kernel._leaf_buffers.values()))
    wall, busy, ops, events = profile_run(torch, b.graph.replay, top=5)
    by_name = {}
    for e in events:
        if kernel_name(e).startswith("gl_"):
            by_name[kernel_name(e)] = by_name.get(kernel_name(e), 0) + e.count
    k4_ms = sum(e.self_device_time_total for e in events if kernel_name(e).startswith("gl_")) / 1e3
    print(f"  (c) {FC_HMC_CHAINS} chains, {n} + {n} iterations in {run_s:.2f} s ({2 * n / run_s:.2f} iterations/s), "
          f"{leaves} leaves ({leaves / (2 * n):.1f} an iteration), mean accept probability {accept:.3f}; K4 launches "
          f"over the run {run_launches} (the wrapper counts a graph's capture, not its replays); a leaf's K4 kernels "
          f"by name from the profiler {by_name}, {k4_ms:.4f} device ms")
    check(sum(by_name.values()) > 0, "(c) the replayed leaf ran no K4 kernel")
    gen = torch.Generator(device="cuda").manual_seed(2)
    samples, hmc_call = counted(torch, gl, "(c) a forecast call", lambda: fc(
        data[:t_train], cov, num_samples=FC_DRAWS, generator=gen), FC_KEYS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = fc(data[:t_train], cov, num_samples=FC_DRAWS, generator=gen)
    torch.cuda.synchronize()
    hmc_call_ms = 1e3 * (time.perf_counter() - t0)
    check(samples.shape == (FC_DRAWS, T_all - t_train, 1) and bool(samples.isfinite().all()),
          f"(c) forecast {tuple(samples.shape)}")
    check(hmc_call["contract"] > 0 and hmc_call["mids"] > 0, f"(c) forecast launches {hmc_call}")
    mae = float((samples.mean(0)[:, 0] - data[t_train:, 0]).abs().mean())
    print(f"  (c) a forecast call of {FC_DRAWS} draws {hmc_call_ms:.3f} ms, launches a draw "
          f"{_per(hmc_call, FC_DRAWS)}; MAE {mae:.4f}")
    out["hmc"] = {"iterations": n, "run_s": run_s, "leaf_ms": 1e3 * leaf_s, "call_ms": hmc_call_ms, "mae": mae,
                  "busy_share": busy / wall, "leaf_launches": leaf_launches}
    pyro.clear_param_store()
    torch.cuda.empty_cache()
    return out


# -- slice 20: epidemiology, the quantized compartmental models through K3f -------------

# Cuts for the script's time limit: the relaxed SVI steps are host-bound
# (about 130 ms a step at T = 20 and 540 at SEIR's T = 60 on an H100), so
# the heuristic start, (a)'s relaxed comparison and (d) are cut in depth.
EPI_CHAINS, EPI_ITERS, EPI_TREE_DEPTH, EPI_HEURISTIC, EPI_Q = 4, 100, 6, 100, 4
EPI_RELAXED_ITERS = 50  # (a)'s relaxed NUTS fit, the yardstick of its R0
EPI_SVI_STEPS, EPI_FORECAST = 150, 10  # (d): examples/epidemiology_sir.py, cut from 1000 steps
EPI_SEIR = dict(population=1000, incubation_time=5.5, recovery_time=7.0, duration=60, R0=2.0, rho=0.5, min_obs=30)
EPI_R0_GAP = 1.0  # (a)'s quantized R0 median against the relaxed fit's (tests/test_epidemiology.py:270-312)


def _seir_data(torch):
    """(b)'s data: a draw of SimpleSEIRModel's prior at R0 2 and response
    rate 0.5, the first seed of 0, 1, ... with at least 30 observed
    infections."""
    from pyro_tpu_torch.contrib.epidemiology import SimpleSEIRModel

    c = EPI_SEIR
    ext = SimpleSEIRModel(c["population"], c["incubation_time"], c["recovery_time"], torch.zeros(c["duration"]))
    for seed in range(100):
        sample = ext.generate({"R0": c["R0"], "rho": c["rho"]}, generator=seed)
        obs = torch.stack([sample[f"obs_{t}"] for t in range(c["duration"])])
        if float(obs.sum()) >= c["min_obs"]:
            return obs, seed
    raise SmokeFailure("no SEIR prior draw with enough observed infections")


def _check_chain_calls(torch, lm, calls, label):
    """Every K3f launch recorded in a vmapped call against the plain version
    at the same (folded) inputs; returns (forward, backward) max abs errors
    and the forward inputs' shapes."""
    worst_f, worst_b, shapes = 0.0, 0.0, set()
    for (x,), (out, _) in calls["_chain_forward_cuda"]:
        shapes.add(tuple(x.shape))
        want = lm.sequential_logmatmulexp_plain(x)
        check(bool(torch.equal(out == -torch.inf, want == -torch.inf)) and not bool(torch.isnan(out).any()),
              f"{label}: K3f forward is -inf (or NaN) where the plain version is not")
        finite = torch.isfinite(want)
        if bool(finite.any()):
            err = max_err(out[finite], want[finite])
            worst_f = max(worst_f, err)
            check(err <= 1e-5 * float(want[finite].abs().max()) + 1e-5, f"{label}: K3f forward off by {err}")
    for (x, tape, g), dx in calls["_chain_backward_cuda"]:
        want = lm._chain_backward_plain(x, lm._chain_forward_plain(x)[1], g)
        err = max_err(dx, want)
        worst_b = max(worst_b, err)
        check(not bool(torch.isnan(dx).any()) and err <= 1e-4 * float(want.abs().max()) + 1e-30,
              f"{label}: K3f backward off by {err} (max {float(want.abs().max())})")
    print(f"  {label}: {len(calls['_chain_forward_cuda'])} K3f forward and {len(calls['_chain_backward_cuda'])} "
          f"backward launches at {sorted(shapes)}; against the plain version: forward max abs err {worst_f:.3g}, "
          f"backward {worst_b:.3g}")
    return worst_f, worst_b, sorted(shapes)


def k3f_bounds(lm, T, B, S):
    """(forward, backward) bounds of one K3f launch over B rows of T factors:
    each input read once and each output written once (the forward reads
    the factors and writes their product; its tape of the rounds' outputs
    is the kernel's own residual, not part of the function, so it is not
    counted; the backward reads the factors, the tape it needs and the
    adjoint and writes the factors' adjoint); a pair's S^3 terms take an
    add, an exp and an add forward (the max pass an add and a compare
    more), and twice an add, an exp, a multiply and an add backward, each
    counted as one float32 operation."""
    pairs = B * (T - 1)
    tape = B * sum(lm._level_sizes(T)) * S * S
    out = []
    for flops, nbytes in ((pairs * 5 * S**3, 4 * (T * B * S * S + B * S * S)),
                          (pairs * 8 * S**3, 4 * (2 * T * B * S * S + tape + B * S * S))):
        out.append(bound(flops, nbytes) + (flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3))
    return out


def _time_k3f(torch, lm, x):
    """K3f forward and backward at ``x`` (T, B, S, S) in turns with K1's
    rounds and the plain version (each way: the forward, then the forward
    with the backward); ms of each."""
    g = torch.randn(x.shape[1:], device="cuda")
    _, tape = lm._chain_forward_cuda(x)
    xg = x.detach().requires_grad_()

    def both(fn):
        def run():
            out = fn(xg)
            out.backward(g)
        return run

    fwd = alternate({
        "kernel": lambda: lm._chain_forward_cuda(x),
        "k1": lambda: lm._rounds(x, lm.logmatmulexp),
        "plain": lambda: lm._chain_forward_plain(x),
    }, iters=5)
    bwd = alternate({"kernel": lambda: lm._chain_backward_cuda(x, tape, g)}, iters=5)
    total = alternate({
        "kernel": both(lm.log_chain),
        "k1": both(lambda z: lm._rounds(z, lm.logmatmulexp)),
        "plain": both(lm.sequential_logmatmulexp_plain),
    }, iters=5)
    plain_bwd = max(total["plain"] - fwd["plain"], 0.0)
    return fwd, bwd["kernel"], total, plain_bwd


def _epi_quantized(torch, lm, label, make_model):
    """fit_mcmc(num_quant_bins=4) on ``make_model()`` on the card, and the
    checks and times of phase 22; returns what the kernels line takes."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.infer.mcmc.util import _ravel_fns, batched_potential_and_grad, get_potential_fn

    pyro.set_default_device("cuda")
    pyro.clear_param_store()
    model = make_model()
    svi_s = []
    fit_svi = model.fit_svi

    def timed_fit_svi(**kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = fit_svi(**kwargs)
        torch.cuda.synchronize()
        svi_s.append(time.perf_counter() - t0)
        return losses

    model.fit_svi = timed_fit_svi
    lm.reset_chain_counts()
    lm.launches.update(forward=0, backward=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc = model.fit_mcmc(num_quant_bins=EPI_Q, num_samples=EPI_ITERS, warmup_steps=EPI_ITERS, num_chains=EPI_CHAINS,
                          max_tree_depth=EPI_TREE_DEPTH, heuristic_num_steps=EPI_HEURISTIC,
                          generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"launches": dict(lm.chain_launches), "routes": dict(lm.routes), "k1": dict(lm.launches)}
    kernel = mcmc.kernel
    nuts_s = wall - svi_s[0]
    leaves = kernel.counts["leapfrogs"]
    R0 = model.samples["R0"]
    check(all(bool(torch.isfinite(v).all()) for v in model.samples.values()), f"{label}: non-finite draws")
    check(all(b.graph is not None for b in kernel._leaf_buffers.values()), f"{label}: the NUTS leaf was not captured")
    check(run["launches"]["forward"] > 0 and run["launches"]["backward"] > 0 and run["routes"]["rounds"] == 0
          and run["k1"] == {"forward": 0, "backward": 0},
          f"{label}: the run's chains did not all take K3f: {run}")
    accept = float(mcmc._diagnostics_extra["accept_prob"].mean())
    print(f"  {label}: heuristic SVI {EPI_HEURISTIC} steps in {svi_s[0]:.2f} s "
          f"({1e3 * svi_s[0] / EPI_HEURISTIC:.3f} ms a step); NUTS {EPI_ITERS} + {EPI_ITERS} iterations in "
          f"{nuts_s:.2f} s ({2 * EPI_ITERS / nuts_s:.2f} iterations/s), {leaves} leaves ({leaves / (2 * EPI_ITERS):.1f} an iteration), mean accept probability "
          f"{accept:.3f}, divergences {int(mcmc._diagnostics_extra['diverging'].sum())}; K3f launches over the run "
          f"{run['launches']} (the wrapper counts a graph's capture, not its replays), routes {run['routes']}; "
          f"posterior median of R0 {float(R0.median()):.4f}")

    # a replayed leaf: CUDA events, and one profiled replay
    b = next(iter(kernel._leaf_buffers.values()))
    b.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        b.graph.replay()
    end.record()
    torch.cuda.synchronize()
    leaf_ms = start.elapsed_time(end) / 10
    pwall, busy, _, events = profile_run(torch, b.graph.replay, top=5)
    by_name = {kernel_name(e): e.count for e in events if kernel_name(e).startswith("lc_")}
    k3f_ms = sum(e.self_device_time_total for e in events if kernel_name(e).startswith("lc_")) / 1e3
    print(f"  {label}: a replayed leaf {leaf_ms:.4f} ms (CUDA events, 10 replays), busy {100 * busy / pwall:.1f}% "
          f"of a profiled replay, K3f {k3f_ms:.4f} device ms, K3f kernels {by_name}")
    check(by_name == {"lc_forward_kernel": 1, "lc_backward_kernel": 1},
          f"{label}: the replayed leaf ran K3f {by_name}, not one launch each way")

    # one vmapped potential-and-gradient call at the last state: one launch
    # each way, every launch against the plain version
    z = mcmc.last_state.z
    lm.reset_chain_counts()
    with record_calls(lm, ("_chain_forward_cuda", "_chain_backward_cuda")) as calls:
        pe, grad = kernel._potential_and_grad(z)
        torch.cuda.synchronize()
    call_launches = dict(lm.chain_launches)
    print(f"  {label}: K3f launches in one vmapped potential-and-gradient call of {EPI_CHAINS} chains: {call_launches}")
    check(call_launches == {"forward": 1, "backward": 1}, f"{label}: the vmapped call launched K3f {call_launches}")
    err_f, err_b, shapes = _check_chain_calls(torch, lm, calls, label)

    # the same potential on the CPU in float64 (and float32, the rounding reference)
    cpu = {}
    try:
        for dtype in (torch.float64, torch.float32):
            pyro.set_default_device("cpu")
            with default_dtype(torch, dtype):
                m = make_model()
                m.num_quant_bins, m.relaxed = EPI_Q, False
                potential, _, transforms, proto, _ = get_potential_fn(
                    m._quantized_model, generator=torch.Generator().manual_seed(0))
                _, unravel = _ravel_fns({k: t.inv(proto.nodes[k]["value"]) for k, t in transforms.items()})
                cpu[dtype] = batched_potential_and_grad(lambda f: potential(unravel(f)))(z.cpu().to(dtype))
    finally:
        pyro.set_default_device("cuda")
    _check_potential(torch, f"{label} potential", (pe, grad), cpu[torch.float64], cpu[torch.float32])

    # K3f at this shape in turns with K1's rounds and the plain version
    x = calls["_chain_forward_cuda"][0][0][0].contiguous()
    T, S, B = x.shape[0], x.shape[-1], math.prod(x.shape[1:-2])
    fwd, bwd_ms, total, plain_bwd = _time_k3f(torch, lm, x)
    (fb, fby, f_ops, f_bytes), (bb, bby, b_ops, b_bytes) = k3f_bounds(lm, T, B, S)
    print(f"  {label}: K3f at T={T}, {B} rows, S={S}: forward {fwd['kernel']:.4f} ms (K1's {len(lm._level_sizes(T))} "
          f"rounds {fwd['k1']:.4f}, plain {fwd['plain']:.4f}; bound {fb:.6f} ms by {fby}: operations {f_ops:.6f}, "
          f"bytes {f_bytes:.6f}), backward {bwd_ms:.4f} ms (bound {bb:.6f} ms by {bby}: operations {b_ops:.6f}, "
          f"bytes {b_bytes:.6f}); forward and backward {total['kernel']:.4f} ms, K1's rounds {total['k1']:.4f}, "
          f"plain {total['plain']:.4f}")
    return {
        "R0": R0, "shape": (T, B, S), "leaf_ms": leaf_ms, "leaves": leaves, "run_s": nuts_s,
        "svi_ms": 1e3 * svi_s[0] / EPI_HEURISTIC,
        "busy_share": busy / pwall, "k3f_device_ms": k3f_ms, "launches": run["launches"],
        "forward": {"max_abs_err": err_f, "ms": fwd["kernel"], "plain_ms": fwd["plain"], "k1_ms": fwd["k1"],
                    "bound": (fb, fby)},
        "backward": {"max_abs_err": err_b, "ms": bwd_ms, "plain_ms": plain_bwd,
                     "k1_ms": max(total["k1"] - fwd["k1"], 0.0), "bound": (bb, bby)},
    }


def phase_epidemiology(torch, lm, smi):
    """Phase 22: quantized compartmental models under NUTS through K3f, and
    relaxed SVI with prediction."""
    print(f"phase 22: epidemiology, quantized compartmental models under NUTS through K3f ({smi})")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.contrib.epidemiology import SimpleSEIRModel, SimpleSIRModel
    from pyro_tpu_torch.examples import epidemiology_regional, epidemiology_sir, sir_hmc

    pyro.set_default_device("cuda")
    t_phase = time.perf_counter()
    print(f"  CUT: NUTS max_tree_depth {EPI_TREE_DEPTH} (fit_mcmc's default 8), {EPI_ITERS} warmup and {EPI_ITERS} "
          f"samples ((a)'s relaxed fit {EPI_RELAXED_ITERS} and {EPI_RELAXED_ITERS}), heuristic_num_steps "
          f"{EPI_HEURISTIC} (default 500); (d) {EPI_SVI_STEPS} SVI steps (the example's 1000)")
    out = {}
    a_args = sir_hmc.parse_args([])
    data_a = sir_hmc.generate_data(a_args)
    print(f"  (a) examples/sir_hmc.py's data at its defaults: {data_a.long().tolist()}")
    out["a"] = _epi_quantized(torch, lm, "(a) SIR", lambda: SimpleSIRModel(a_args.population, a_args.recovery_time,
                                                                           data_a))
    # (a) relaxed, the JAX package test's yardstick
    pyro.clear_param_store()
    relaxed = SimpleSIRModel(a_args.population, a_args.recovery_time, data_a)
    t0 = time.perf_counter()
    relaxed.fit_mcmc(num_samples=EPI_RELAXED_ITERS, warmup_steps=EPI_RELAXED_ITERS, num_chains=EPI_CHAINS,
                     max_tree_depth=EPI_TREE_DEPTH, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    r0_q, r0_r = float(out["a"]["R0"].median()), float(relaxed.samples["R0"].median())
    print(f"  (a) relaxed NUTS, {EPI_RELAXED_ITERS} + {EPI_RELAXED_ITERS} iterations in {time.perf_counter() - t0:.2f} "
          f"s: R0 median {r0_r:.4f} against the quantized {r0_q:.4f} (true {a_args.R0})")
    check(abs(r0_q - r0_r) < EPI_R0_GAP, f"(a): quantized R0 median {r0_q} against relaxed {r0_r}")

    seir_obs, seed = _seir_data(torch)
    c = EPI_SEIR
    print(f"  (b) SimpleSEIRModel data (prior draw at seed {seed}): {int(seir_obs.sum())} observed infections over "
          f"{c['duration']} days")
    out["b"] = _epi_quantized(torch, lm, "(b) SEIR", lambda: SimpleSEIRModel(
        c["population"], c["incubation_time"], c["recovery_time"], seir_obs))

    r_args = epidemiology_regional.parse_args([])
    pyro.clear_param_store()
    r_obs = epidemiology_regional.generate_data(r_args)
    out["c"] = _epi_quantized(torch, lm, "(c) regional SIR",
                              lambda: epidemiology_regional.make_model(r_args, r_obs[: r_args.duration]))

    # (d) relaxed SVI and a forecast, no kernel
    d_args = epidemiology_sir.parse_args(["--num-steps", str(EPI_SVI_STEPS), "--forecast", str(EPI_FORECAST)])
    pyro.clear_param_store()
    obs, _ = epidemiology_sir.generate_data(d_args)
    model = SimpleSIRModel(d_args.population, d_args.recovery_time, obs[: d_args.duration])
    lm.reset_chain_counts()
    lm.launches.update(forward=0, backward=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = model.fit_svi(num_steps=EPI_SVI_STEPS, learning_rate=d_args.learning_rate,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    svi_ms = 1e3 * (time.perf_counter() - t0) / EPI_SVI_STEPS
    t0 = time.perf_counter()
    samples = model.predict(forecast=EPI_FORECAST, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    T_all = d_args.duration + EPI_FORECAST
    check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0], f"(d) losses {losses[:3]}...{losses[-3:]}")
    check(all(f"obs_{t}" in samples and bool(torch.isfinite(samples[f"I_{t}"]).all()) for t in range(T_all)),
          "(d): the forecast's sites are missing or not finite")
    check(lm.chain_launches == {"forward": 0, "backward": 0} and lm.launches == {"forward": 0, "backward": 0},
          f"(d) reached a kernel: K3f {lm.chain_launches}, K1 {lm.launches}")
    r0 = samples["R0"]
    print(f"  (d) examples/epidemiology_sir.py: {EPI_SVI_STEPS} SVI steps at {svi_ms:.3f} ms a step (loss {losses[0]:.1f} "
          f"-> {losses[-1]:.1f}), predict(forecast={EPI_FORECAST}) of 100 draws {predict_ms:.1f} ms; R0 "
          f"{float(r0.mean()):.3f} +- {float(r0.std()):.3f} (true {d_args.basic_reproduction_number}); no kernel "
          f"launched")
    pyro.clear_param_store()
    for key in ("a", "b", "c"):
        r = out[key]
        print(f"  summary ({key}): ms a leaf {r['leaf_ms']:.4f}, {r['leaves'] / (2 * EPI_ITERS):.1f} leaves an "
              f"iteration, {2 * EPI_ITERS / r['run_s']:.2f} iterations/s, busy {100 * r['busy_share']:.1f}%, K3f "
              f"{r['k3f_device_ms']:.4f} device ms a leaf, SVI {r['svi_ms']:.3f} ms a step, R0 median "
              f"{float(r['R0'].median()):.4f}; K3f at {r['shape']}: forward {r['forward']['ms']:.4f} ms (bound "
              f"{r['forward']['bound'][0]:.6f}, K1's rounds {r['forward']['k1_ms']:.4f}, plain "
              f"{r['forward']['plain_ms']:.4f}), backward {r['backward']['ms']:.4f} ms (bound "
              f"{r['backward']['bound'][0]:.6f})")
    print(f"  phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return out


def profile_step(torch, svi, sequences, lengths):
    """One more SVI step under torch.profiler: device time by kernel, and
    the device's busy share of the step's wall time."""
    _, busy_ms, _, kernels = profile_run(torch, lambda: svi.step(sequences, lengths))
    k1_ms = sum(e.self_device_time_total for e in kernels if "lme_" in e.key) / 1e3
    k2_ms = sum(e.self_device_time_total for e in kernels if kernel_name(e).startswith(("ms_", "msc_"))) / 1e3
    print(f"    K1 kernels {k1_ms:.3f} ms, K2 kernels {k2_ms:.3f} ms")
    return k1_ms


def kernel_name(event):
    """A profiled kernel's name without its return type and arguments (a
    template kernel's key reads ``void name<...>(...)``)."""
    return event.key.removeprefix("void ").split("(")[0]


def profile_run(torch, fn, top=8):
    """``fn()`` under torch.profiler: its wall time, the device's busy time
    (the sum of kernel and copy times on the card), the number of device
    operations launched, and those operations by name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"  profiled: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches} device operations")
    for e in kernels[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return wall_ms, busy_ms, launches, kernels


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "pyro_tpu_torch")):
        print("chip_smoke: pyro_tpu_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pyro_tpu_torch

    check(os.path.dirname(os.path.dirname(os.path.abspath(pyro_tpu_torch.__file__))) == HERE,
          "pyro_tpu_torch must come from this checkout")
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import gaussian_levels as gl
    from pyro_tpu_torch.ops import log_matmul as lm
    from pyro_tpu_torch.ops import markov_scan as ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build_all(["log_matmul", "log_chain", "markov_scan", "gaussian_levels"])
    print(f"  built log_matmul, log_chain, markov_scan and gaussian_levels in {time.perf_counter() - t0:.2f} s")
    for name in ("log_matmul", "log_chain", "markov_scan", "gaussian_levels"):
        for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print("   ", name, line.strip())

    k1 = phase_k1(torch, lm)
    k1_launches, _ = phase_slice(torch, lm)
    k2 = phase_k2(torch, lm, ms)
    k2_launches, _ = phase_enum_slice(torch, lm, ms)
    phase_vae(torch)
    phase_nuts(torch)
    k4 = phase_k4(torch, gl)
    k4_launches = phase_gaussian_slice(torch, gl)["launches"]
    k4.update(phase_k4_backward(torch, gl))
    train_launches = phase_train(torch, gl)["launches"]  # the backward kernels' main path
    k4_launches.update(halving_bwd=train_launches["halving_bwd"], contract_bwd=train_launches["contract_bwd"])
    k2g = phase_k2g(torch, ms)
    tv_launches = phase_tv_slice(torch, lm, ms)["launches"]
    phase_fallback(torch, lm, ms)
    k5 = phase_k5(torch, gl)
    k5_launches = phase_gamma_slice(torch, gl)["launches"]
    phase_dmm(torch, lm, ms, gl)
    phase_queries(torch, lm)
    phase_gp(torch, gl, smi)
    phase_nuts_enum(torch, lm, ms, gl, smi)
    phase_forecast(torch, gl, smi)
    epi = phase_epidemiology(torch, lm, smi)
    # K3f on the kernels line: its times and bound at (b)'s shape (S=64, the
    # widest, where it does more than launch latency; (a)'s and (c)'s are
    # printed in phase 22), its largest error over (a)-(c), and its launches
    # over the three quantized runs (counted from zero before each)
    k3f_launches = {way: sum(epi[k]["launches"][way] for k in ("a", "b", "c")) for way in ("forward", "backward")}
    k3f = {way: dict(epi["b"][way], max_abs_err=max(epi[k][way]["max_abs_err"] for k in ("a", "b", "c")))
           for way in ("forward", "backward")}

    kernels = []
    scan = "pyro_tpu/ops/markov_product.py:469"
    for name, source, replaces, r, launches in (
        ("logmatmulexp_fwd", "log_matmul.cu", "pyro_tpu/ops/log_matmul.py:36", k1["forward"],
         k1_launches["forward"]),
        ("logmatmulexp_bwd", "log_matmul.cu", "pyro_tpu/ops/log_matmul.py:59", k1["backward"],
         k1_launches["backward"]),
        ("markov_scan_fwd", "markov_scan.cu", scan, k2["cluster_forward"], k2_launches["cluster"]["forward"]),
        ("markov_scan_bwd", "markov_scan.cu", scan, k2["cluster_backward"], k2_launches["cluster"]["backward"]),
        ("markov_scan_stream_fwd", "markov_scan.cu", scan, k2["stream_forward"], k2_launches["stream"]["forward"]),
        ("markov_scan_stream_bwd", "markov_scan.cu", scan, k2["stream_backward"],
         k2_launches["stream"]["backward"]),
        ("gaussian_halving", "gaussian_levels.cu", "pyro_tpu/ops/gaussian.py:448", k4["halving"],
         k4_launches["halving"]),
        ("gaussian_contract", "gaussian_levels.cu", "pyro_tpu/ops/gaussian.py:726", k4["contract"],
         k4_launches["contract"]),
        ("gaussian_mids", "gaussian_levels.cu", "pyro_tpu/ops/gaussian.py:790", k4["mids"], k4_launches["mids"]),
        ("gaussian_halving_bwd", "gaussian_levels.cu", "pyro_tpu/ops/gaussian.py:448", k4["halving_bwd"],
         k4_launches["halving_bwd"]),
        ("gaussian_contract_bwd", "gaussian_levels.cu", "pyro_tpu/ops/gaussian.py:501", k4["contract_bwd"],
         k4_launches["contract_bwd"]),
        ("markov_scan_tv_fwd", "markov_scan.cu", "pyro_tpu/ops/markov_product.py:436", k2g["cluster_forward"],
         tv_launches["cluster"]["forward"]),
        ("markov_scan_tv_bwd", "markov_scan.cu", "pyro_tpu/ops/markov_product.py:436", k2g["cluster_backward"],
         tv_launches["cluster"]["backward"]),
        ("markov_scan_tv_stream_fwd", "markov_scan.cu", "pyro_tpu/ops/markov_product.py:436",
         k2g["stream_forward"], tv_launches["stream"]["forward"]),
        ("markov_scan_tv_stream_bwd", "markov_scan.cu", "pyro_tpu/ops/markov_product.py:436",
         k2g["stream_backward"], tv_launches["stream"]["backward"]),
        ("gamma_gaussian_halving", "gaussian_levels.cu", "pyro_tpu/ops/gamma_gaussian.py:401", k5["gamma_halving"],
         k5_launches["gamma_halving"]),
        ("gamma_gaussian_contract", "gaussian_levels.cu", "pyro_tpu/ops/gamma_gaussian.py:464",
         k5["gamma_contract"], k5_launches["gamma_contract"]),
        ("log_chain_fwd", "log_chain.cu", "pyro_tpu/ops/log_matmul.py:134", k3f["forward"],
         k3f_launches["forward"]),
        ("log_chain_bwd", "log_chain.cu", "pyro_tpu/ops/log_matmul.py:134", k3f["backward"],
         k3f_launches["backward"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pyro_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s (the script through phase 21 took 496.6 s on the H100 "
          f"at 700 W)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
