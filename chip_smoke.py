"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the population log-likelihood matrix ("psi") through
``pharmsol_tpu_torch.log_likelihood_matrix`` with ``device="cuda"``: for
closed-form models, whose engine is the hand-written CUDA kernel
``pharmsol_tpu_torch/csrc/fused_psi.cu`` (K1a, K1b with covariates, seq,
lag, fa or init, and K1c with lag and a seq chain deeper than one or a
time-varying seq, or lag and fa that change with time), for ODE models,
whose engine is
``pharmsol_tpu_torch/csrc/fused_ode.cu`` (K2a, K2e with covariates, lag, fa
or init, K2d, the exact propagation of linear models with ``expm``, and for
stiff models K2b, the SDIRK tier, and K2c, the BDF tier) with
a right-hand side generated from the model's closure, and
for SDE models, whose engine is the particle filter
``pharmsol_tpu_torch/csrc/fused_sde.cu`` (K3a, and K3b with covariates,
lag, fa or init planes) with the drift and diffusion generated the same
way; and the population fit on top of psi,
``pharmsol_tpu_torch.optimize.fit_population`` (NPAG), whose every cycle calls
that entry point and whose weight solve burns in on the card. Phases, each
printing its own lines; any failure raises and the exit code is not 0:

0. environment: torch, CUDA and nvcc versions, the card's name and power
   limit;
1. build: every library from the checkout's sources with nvcc, one process
   each, all at once, timed: the closed-form kernel and the ODE kernel for
   each model RHS used below, the SDE kernel for each SDE model below
   (``-Xptxas -v``: registers and spills);
2. each kernel against its plain PyTorch twin on the card at a ragged shape
   (R=257, S=300).
   K1a: all 12 structures on a multi-dose regimen, and 2-cmt oral with
   infusion, with BLOQ+ALOQ censoring, and with two outputs plus a bias,
   float64 within 1e-10 relative; float32 within the committed per-structure
   budget on the budget's own cases.
   K2a: the bolus+infusion 2-state model, Michaelis-Menten and the
   two-input model, each with dopri5 and tsit5, merged and segment by
   segment, float64 within 1e-8 relative; float32 within the ``ode_dopri5``
   and ``ode_multi_input`` budgets on their own cases. Then the 2-cmt oral
   ODE at tolerances 1e-9 against the closed-form 2-cmt oral psi on the same
   Short data, float64, within 1e-5 relative.
   K2e: every mode of ``utils/f32_budget.py::ODE_FEATURE_CASES`` (constant,
   linear and carried-forward covariates, static lag, fa, lag + fa, lag with
   an infusion, two inputs firing in one segment, time- and covariate-
   dependent lag/fa slot tables, init rows and planes, tsit5) and the
   reference's covariate model at 64 x 48, merged and per segment, float64
   within 1e-8 relative, float32 within each case's budget row; and the
   ``ode_lag_fa`` and ``ode_tv_covariate`` budget cases;
3. the slices at full width through the public entry point, in float32 and
   float64, three calls each with fresh supports: 2-cmt oral "Short" at
   16384 subjects x 512 supports and 1-cmt oral at 10000 x 1000 (K1a), and
   the Short 2-cmt oral ODE at 16384 x 512 (K2a). Each call must take the
   fused engine with exactly one kernel launch, give finite psi of the right
   shape, and agree with the general engine on the card (closed form:
   float32 1e-3 relative, float64 1e-10; ODE: float64 1e-4, float32 within
   the ``ode_dopri5`` budget of the float64 general engine). Each kernel is
   then held against its twin at these shapes;
4. times on the card (CUDA events, after warm-up): each kernel alone, its
   twin, the general engine, one end-to-end call with the lowering cached and
   the steps it is made of, and the host lowering alone; the explicit ODE
   library's anatomy (registers, stack, LDL/STL, resident blocks from its
   occupancy query, one trial's static SASS with its CALL and MUFU sites,
   ``ode_anatomy``), K2a's issue slots per cell-trial, and the layout model
   of the explicit tier (``explicit_layout_costs``) from the twin's trials by
   march call on 64 subjects;
5. K3a on the README SDE model of the reference (a mean-reverting
   elimination rate), 1000 particles, at a ragged reduced shape (19 x 23,
   the first observation, to 1 h):
   its Philox words against ``ops/philox.py``; against its twin, which draws
   the same numbers, at zero diffusion (float64, every cell within 1e-10),
   with noise (float64: 99.9% of cells within 1e-9; float32: 99% within
   1e-4) and on a two-input model with an inject-to-destination route,
   BLOQ+ALOQ censoring and ``em_control='coupled'`` (float64, 99.9% within
   1e-9); kernel, twin and general-engine times. Then against the general
   engine (other draws) at 32 x 16 on the first two observations: the mean
   per-cell difference within four standard errors; and at zero diffusion against the 1-cmt IV closed form
   within 5e-2 (EM at rtol = atol = 1e-2);
6. the README SDE at full width (256 subjects x 64 supports x 1000
   particles) through the public entry point, float32 and float64, two
   calls each with fresh supports, each taking the fused engine with exactly
   one K3a launch and giving psi of the right shape without NaN;
7. K3a alone at full width and one end-to-end call with its steps; its
   bound at full width from the float64 twin's trials on 2 subjects spread
   over the cell x 64 supports (kernel and twin held to each other there),
   recounted with Philox's integer work at the card's INT32 rate and printed
   beside the floating-point-only count; the four-particles-a-thread
   instantiations' registers, resident blocks per SM and the trial loop's
   static instruction mix per particle-trial (``cuobjdump``), with the share
   of the card's issue rate that loop reaches in the measured time;
8. the K2e slice, "ODE covariates 16384 x 512": the reference's covariate
   example (``examples/covariates.py``: creatinine with knots at 0 and 1 h,
   a constant age, lag, 100 mg at 0, 2 and 4 h) through the public entry
   point, three calls per dtype, each on the fused engine with exactly one
   K2e launch, held against the general engine on 2048 subjects (float64
   within 1e-4); then K2e's time, its twin's, the general engine's, one
   end-to-end call with the plan's share, and its bound; the covariate
   library's anatomy, K2e's issue slots per cell-trial and the layout model
   as in 4;
9. K2d against its twin at 64 x 48 on every case of
   ``utils/f32_budget.py::EXPM_CASES`` (the 2-state oral model, the 2-cmt
   oral RHS, the 5-state transit and mammillary model with a bolus and an
   infusion, lag and fa, a carried-forward covariate, init with two outputs,
   and a last segment whose scaled norm passes 2^16) and on the ``ode_expm``
   budget case: float64 within 1e-10 relative, float32 within the
   ``ode_expm`` row, the poisoned cells -inf in both; the generated ``rhs``
   and ``rhs_jvp`` against the closure and ``torch.func.jvp`` of it on the
   card within 1e-12;
10. the population fit at full width, float64: the data of the JAX package's
    ``benches/population_10k.py --fit`` rebuilt from numpy (10 000 subjects,
    1000 start points, 8 cycles), fitted over the closed-form 1-cmt oral
    model (fit A: every psi call one K1a launch; log-likelihood within 0.5
    and fast mass within 0.01 of the JAX package's recorded fit) and over
    the same model as a linear ODE with expm (fit B: every psi call one K2d
    launch; log-likelihood within 1e-6 relative of fit A's), with the stage
    times of each;
11. the K2d slice, "ODE expm transit 16384 x 512": three calls per dtype
    through the public entry point, each one K2d launch, held against the
    general engine on 2048 subjects (float64 within 1e-9); K2d's time, its
    twin's, the general engine's, one end-to-end call with its parts, its
    bound, and for context the time of ``torch.linalg.matrix_exp`` over as
    many blocks as the cell has passes;
12. the NPML burn-in on the host against the card at 10 000 subjects x k
    supports: seconds each and the log-likelihood each reaches;
13. K2b (the SDIRK tier: trbdf2, kvaerno3, kvaerno5) and K2c (the BDF tier,
    order cap 3) against their twins at 64 x 48 on the cases of
    ``utils/f32_budget.py::STIFF_CASES`` (the full TMDD under every solver;
    a fast absorption, target binding with init, widely separated rates, lag
    with an infusion, Michaelis-Menten, an affine covariate, two outputs
    with a censored observation, and a TMDD whose step budget is too small,
    each under one solver in turn) and the ``ode_bdf`` budget case, merged and segment by segment where the plan
    merges: float64 every cell within 1e-6 relative and 99% within 1e-8,
    float32 within the ``ode_bdf`` row (2e-3), the lost cells -inf in both;
14. the stiff slice, "ODE TMDD stiff 16384 x 512" (the TMDD of the JAX
    package's ``benches/stiff_bench.py``, its 16 subjects widened) through
    the public entry point: bdf and trbdf2 three calls per dtype, kvaerno3
    and kvaerno5 one, each on the fused engine with exactly one K2c or K2b
    launch; float64 held within 1e-3 against the bdf general engine on 256
    subjects (every solver: the same equations at the same tolerances); the
    same call with dopri5 on 256 subjects, to count the cells the explicit
    tier loses;
15. K2b's and K2c's times there per solver and dtype, the twin on 10
    subjects spread over the population (two of each dose class, the last
    subject among them) x 512 supports, timed alone for bdf in float64, the
    bound from the twin's counts scaled to the cell (for bdf the trials and
    the rescalings of the difference array that the kernel performs, each
    priced at its order), one end-to-end call with its parts, and the BDF
    order cap 3 against 5; and each TMDD library's anatomy (registers, stack
    frame, local loads and stores in its SASS, resident blocks from the
    occupancy query) with the cell's lane-slots per trial from the twin's
    trials by march call: synced at every march call (the parent layout),
    one cell a lane on its own, and the persistent grid;
16. K3b against its twin at 19 x 23 x 1000 particles on every mode of
    ``utils/f32_budget.py::SDE_FEATURE_CASES`` (a constant and an affine
    covariate, static lag, fa, lag with fa, a dynamic lag/fa through slot
    tables, init rows (K3a's input), covariate-dependent init planes, two
    inputs with an inject-to-destination route): at zero diffusion float64
    every cell within 1e-10; with noise float64 99.9% within 1e-9, float32
    99% within 1e-4;
17. the K3b cell, "SDE covariates 256 x 64 x 1000": the reference's
    covariate example (``examples/covariates.py``) written as an SDE
    (creatinine with knots at 0 and 1 h, a constant age, lag, a diffusion
    on central with sigma in 0.02-0.2, 100 mg at 0, 2 and 4 h) through the
    public entry point, three calls per dtype, each exactly one K3b launch,
    psi finite;
18. K3b's time there, kernel and twin on one subject (subject 0) x 64 supports
    (held to each other), the general engine there (float64), one
    end-to-end call with the plan's share, the bound from the twin's trials
    (recounted as in 7) and its kernels' registers, resident blocks and
    instruction mix as in 7;
19. K1c against its twin at 257 x 300 on every case of
    ``utils/f32_budget.py::K1C_CASES`` (lag_depth with levels and planes,
    zero-lag lanes, lag_post with a static and a dynamic lag, a
    time-dependent lag and fa, fa alone, a 3-compartment case): float64
    within 1e-10, float32 within the case's row;
20. the K1c cells through the public entry point, three calls per dtype,
    each one K1c launch, held against the general engine on 2048 subjects
    (float64 1e-10, float32 within the row): "lag-depth Short 16384 x 512"
    (JAX ``tests/test_pallas_psi.py:1367-1386`` on the ``_lag_depth_subjects``
    regimen) and "dynamic-lag creatinine 10000 x 1000" (the creatinine
    cell's data, its creatinine read by the lag: lag and fa slot tables);
    their times, twins, general engine, end-to-end calls with the plan's
    share and bounds;
21. lag_post (lag with a time-varying seq) at the widest population that
    ``plans/seq.py::_MAX_PLANE_FLOATS`` admits for the Covariate Short model
    with a time-varying weight, one float64 call, held against the general
    engine on 256 subjects, and one float32 call on a quarter of them;
22. the single-subject API and the per-subject batch log-likelihood on the
    card (the general engine's segment march: no kernel of the table runs
    here, and the launch counts stay 0): the 16 reference scenarios of
    ``tests/test_reference_goldens.py`` (float64; a copy of their events and
    parameters is kept here) through ``estimate_predictions`` of the
    Analytical and the ODE model, the analytical predictions against the
    committed ``tests/goldens/reference_scenarios.json`` (rtol 1e-9, atol
    1e-12), the ODE against the analytical ones (REL 1e-2 / ABS 1e-6), and
    ``estimate_log_likelihood`` of both; ``log_likelihood_batch`` over
    phase 10's 10 000 subjects (1-cmt oral), a parameter row each drawn from
    the seed, a combined residual model, one call per dtype (finite,
    [10000]), held against the same call on the CPU on 256 subjects
    (float64 1e-10 relative, float32 within the closed form's budget row of
    the float64 result) and against ``estimate_predictions`` plus
    ``ResidualErrorModels.total_log_likelihood`` on 8 (float64 1e-10); the
    README SDE's predictions for one subject at 1000 particles (finite, on its
    first two observations; at zero diffusion the CPU's within 1e-9)
    and the covariate ODE example's (the CPU's within 1e-10); then
    CUDA-event times per dtype (float32 at a quarter of the repetitions),
    after warm-up with the lowering cached and the prediction cache off, of one
    ``estimate_predictions`` (a Short subject, closed form and ODE), one
    ``estimate_log_likelihood`` and one ``log_likelihood_batch`` at 10 000
    subjects with its host and device parts;
23. the authoring surfaces: models written as DSL text and with the
    declarative API (``utils/authoring_cases.py``; no closure written by
    hand) through ``log_likelihood_matrix`` at full width in both dtypes,
    each call with every launch count set to 0 just before and read just
    after (engine fused, one launch of the cell's kernel and of no other):
    "DSL Short 16384 x 512" (the 1-cmt oral structure with its parameters
    declared in another order: K1a), "DSL creatinine 10000 x 1000" (a
    derived ``ke`` from a time-varying weight: K1b through the kernel-input
    decomposition), "DSL ODE Short 16384 x 512" (K2a), "declarative ODE
    covariates 16384 x 512" (``examples/covariates.py`` as ``ode_model``:
    K2e) and "declarative SDE README 64 x 64 x 1000" (``examples/sde_readme.py``
    as ``sde_model``: K3a; phase 7's cell cut to a quarter of its
    subjects), each held against
    the hand-written closure model's psi (every cell equal where both run
    the same library, float64 1e-12 where the header differs) or the
    general engine on 256 subjects (float64 1e-10), its float32 psi against
    its float64 one (every cell 1e-3, 99.9% within the budget row), the
    kernel against its twin (the SDE's cut to 2 x 8 subjects x supports),
    with the kernel, plan, decomposition and end-to-end times; a DSL model
    reading every intrinsic the RHS generator took for the DSL on K2a at 64
    x 48 (against its twin and the general engine); a ``.pkm``
    artifact of the creatinine model saved, loaded and run (psi equal to
    the source's); and the NPAG fit over the DSL 1-cmt model against the
    closure fit on phase 10's population (cycles, support count,
    log-likelihood within 1e-8);
24. the estimation layer in float64 on the card, each result held against
    the same call on the CPU (``run_estimation``: the card's timed work
    first, with no other process of the script running, then the CPU
    references in worker processes beside the card's MAP fits, which are
    not timed), no kernel of the table launched:
    ``log_likelihood_fn`` on phase 10's 10 000 subjects (value, autograd
    gradient, per-subject Jacobian by ``torch.func.jacfwd``; on 512 of them
    1e-12 / 1e-10 against the CPU) and its times; ``fit_map`` on a Short
    subject (closed form) and a dopri5 subject (1e-8); ``fit_laplace``
    then ``laplace_standard_errors`` on 200 subjects of the JAX package's
    ``test_laplace.py`` population (estimates 1e-6, SEs 1e-5) and a check
    of the dopri5 Laplace path through the forward sensitivities (the JAX
    package's adaptive-ODE Laplace test's 4 subjects and settings, 2 of its
    15 outer iterations, then the SEs there: not a converged fit);
    ``fit_saem`` on the 200 subjects (25 burn-in and 12 averaging
    iterations, an eighth of its defaults) (the CPU generator's
    draws on both: the ll trace's first 20 entries 1e-8, estimates 1e-6,
    the MH decisions that flipped, seconds, the iteration loop's ms per
    iteration, the card's busy share of one iteration by
    ``torch.profiler``);
25. the replicate layer in float64 on the card, each result held against
    the CPU (``run_diagnostics``: the card's timed calls first, alone, then
    the CPU references in one-thread worker processes beside the untimed
    card checks), no kernel of the table launched, the closed-form Laplace
    objective's evaluations replayed from CUDA graphs:
    ``bootstrap_laplace`` (200 replicates), ``sse_laplace`` (100), ``vpc``
    (500) and ``npde`` (1000) of the bootstrap's full fit, ``llp`` (the
    default grid, 48 lanes) on phase 24's 200 subjects, and ``scm`` on the
    JAX package's ``tests/test_scm.py`` population (20 subjects, the weight
    and noise candidates; its fits cut to ``DIAG_SCM_MAX_ITERS`` outer
    iterations and its screens to ``DIAG_SCM_REFIT_ITERS`` steps), the
    refits cut to ``DIAG_REFIT_ITERS`` L-BFGS steps and the SSE and llp fits
    warm-started at the bootstrap's, without standard errors; the timed
    work alone: the calls, one batched objective + gradient at B = 200 x 200
    subjects, eager and replayed (host clock, CUDA events; the card busy
    for the replay's event time), 8 lanes refitted one at a time (B = 1)
    against all 200 at once;
    then the CPU references; the bootstrap's first 8 lanes against
    those lanes refitted alone on the card (1e-10), the first 8 lanes of the
    bootstrap and the SSE and llp's ``DIAG_LLP_HELD`` lanes against the CPU
    (1e-8), the SSE simulations against the CPU's (1e-10), vpc and npde
    (1e-9), scm's effects and final log-likelihood (1e-6);
    In a whole run phases 24 and 25 time their card work one after the
    other and then share one window of CPU references (``RefWindow``);
26. ``batch_nca_device`` on the card in float64 at the JAX package's 5000
    x 32 test profiles and at 100 000 x 32, its ms by CUDA events, then
    every key against the host ``batch_nca`` within 1e-9 relative; no
    kernel of the table;
27. the device split on the one card (``parallel/mesh.py``; meshes (8, 1)
    and (4, 2) over eight times ``cuda:0`` and (1, 1) over ``cuda:0``):
    ``log_likelihood_matrix_sharded(engine="fused")`` against the whole
    ``log_likelihood_matrix(engine="fused")`` on six cells at 4096 subjects
    x 512 supports, Short (K1a), Covariate Short (K1b), lag-depth Short
    (K1c), ODE Short (K2a), ODE expm transit (K2d), and the README SDE at
    64 x 64 x 1000 at zero diffusion (K3a): float64 every cell within 1e-12
    relative on every mesh, float32 on (8, 1) within 1e-5, the launch
    counters set to 0 just before each split call and read just after (one
    launch per subjects shard, no other kernel), and the (8, 1) call run in
    ``utils/profiling.py::profile_trace``: 8 events of the cell's kernel in
    the trace file and its psi within 1e-12 of the whole call's (up to three
    captures, each failed one printed; the K1a cell's capture runs again
    after phase 26); each call's ms (the median of 5 after a warm-up, host
    work included, after the export worker's artifact has come);
    ``log_likelihood_batch_sharded`` against
    ``log_likelihood_batch`` at phase 22's 10 000 subjects (1e-12);
    ``fit_population`` on the (4, 2) mesh against the fit without one on
    phase 10's population (4 cycles of phase 10's 8: supports 1e-10,
    weights 1e-8, every psi call 4 K1a launches); ``export_psi`` of the
    Short model at 1024 x 512, traced on the card by a worker process that
    starts with the script (beside the build), loaded and run against the general
    engine (1e-12; the transit model exports as well, but its
    trace takes about a minute of host time: ``tests/test_torch_export.py``
    exports ``expm``); ``read_pmetrics_native`` on a generated 100 000-row
    CSV against the Python reader (the same Data) and ``run_pkm_host`` on
    ``tests/test_pkm_host.py``'s ODE artifact against the engine on the
    card (1e-8);
28. the closure styles the RHS generator takes (``utils/style_cases.py``),
    each entry-point call with every launch count set to 0 just before and
    read just after (engine fused, one launch of the cell's kernel, no
    other): "ODE Short 16384 x 512" and "ODE TMDD stiff 16384 x 512" under
    bdf written vector-style (``torch.zeros_like``, writes, whole-vector
    arithmetic) against the list-style cells in float32 and float64 (the
    same header key, psi equal in every cell, K2a's and K2c's times and
    the end-to-end calls beside the list-style cells'); the math model
    (every operation of the elementwise set, a state-dependent power, a
    time-varying weight and a lag) at 64 x 48 in the explicit library
    without and with features (K2a, K2e: float64 within 1e-8 of the twin),
    the kvaerno3 (K2b) and bdf (K2c) libraries (every cell 1e-6, 99% within
    1e-8), float32 within the ``ode_dopri5`` / ``ode_bdf`` rows; the transit
    model written as whole-vector arithmetic (the list-style key; K2d
    within 1e-10, float32 within ``ode_expm``); the README SDE with a tanh
    drift term at 8 x 8 x 1000 on K3a (zero diffusion 1e-10, noise 99.9%
    within 1e-9).

For 28 (each cut prints its time beside the time before it): phase 7's
twin for the bound runs in a worker process beside the build (phase 6's
cell takes its data from a seed of its own for it); by depth, phase 22's
float64 README SDE predictions on two observations (four), phase 6's README
SDE cell at two calls per dtype (three).

The earlier paths were cut to make room for 16-21 (each cut prints its
time beside the time before it): phase 14's general engine on 64 subjects
for kvaerno3 and kvaerno5, phase 15's twin timed alone for bdf in float64
only, phase 5's SDE twin on two observations, and phase 13's (and the
build's) stiff cases: the TMDD under every solver, every other case under
one solver in turn. And for 25-26: phase 14's four solvers held to bdf's
general engine on 256 subjects (trbdf2 and kvaerno3 had their own), by
depth the SDE twins of phases 7 and 18 on 2 spread subjects, phase 21's
float32 lag_post call on a quarter of its subjects, phase 22's float32
README SDE on two observations and its float32 times at a quarter of the
repetitions, phase 23's declarative SDE twin on one observation, phase 24's
SAEM fit at a quarter of its default iterations, the SDE kernels of 7 and 18 timed
once, the plans' profiles of 4, 8 and 20 in float64 only. And for 27, by
depth: phase 5's SDE twin on the first observation (it had two) and its
statistical check on the first two (it had four), phase 24's SAEM fit at 25 + 12 iterations (it had 50 + 25) and phase 25's
``sse_laplace`` at 100 simulations (it had 200); then, for phase 27's
medians and its trace check after phase 26, the SDE twins of phases 7 and
18 on one subject (they had two) and phase 23's declarative SDE cell on 64
subjects (it had 256).

``--only stiff`` runs phases 0, 1 (the stiff libraries alone) and 13-15, for
work on K2b or K2c; ``--only explicit`` phases 0, 1 (the explicit tier's
libraries), phase 2's K2a and K2e checks, the ODE parts of 3-4 and 8, for
work on K2a or K2e; ``--only sde`` phases 0, 1 (the SDE libraries), 5-7 and
16-18 (K3a, K3b); ``--only k1c`` phases 0, 1 (the closed-form library) and
19-21; ``--only closed`` phases 0, 1 (the closed-form library), phase 2's
K1a and K1b checks, 3-4 for the two K1a and the two K1b cells, 19-21 (K1c)
and the closed-form kernel's anatomy on the two K1a and the four K1b and K1c
cells (every K1a instantiation's and the cells' K1b and K1c ones'
registers, local memory, stack, local loads and stores and warps per SM;
per cell the issue slots per cell-segment), for work on K1a, K1b or K1c;
``--only single`` phases 0 and 22 (no library is built); ``--only
authoring`` phases 0, 1 (the closed-form library and the ODE and SDE
libraries of phase 23's models) and 23; ``--only estimation`` phases 0 and
24, ``--only diagnostics`` phases 0 and 25, ``--only nca`` phases 0 and 26
(no library is built); ``--only mesh`` phases 0, 1 (the closed-form
library and phase 27's ODE and SDE libraries) and 27; ``--only styles``
phases 0, 1 (phase 28's libraries) and 28. A partial run's last line is
``{"ok": true, "partial": ...}``, not the whole script's verdict.

``--pair DIR`` holds this checkout against another one at ``DIR`` (a
``git archive`` of the parent commit, say), in the order DIR, here, here,
DIR, each side a process of its own that imports its own package: K3a's
README cell (256 x 64 x 1000), K3b's "SDE covariates 256 x 64 x 1000" cell
and "ODE TMDD stiff 16384 x 512" under bdf, trbdf2, kvaerno3 and kvaerno5
through ``log_likelihood_matrix``, three calls per dtype after a warm one
(the stiff kernel also alone, by CUDA events), with the factor of the
medians and whether the sides' ranges part; each side's psi, the change's
held to the parent's cell by cell (SDE at the twin's tolerances, both
drawing the same Philox numbers; stiff by the kernel-twin rule, with the
cells that differ at all counted); the registers of every closed-form, SDE
and ODE kernel the side built (``cuobjdump -res-usage``; for the stiff cell
the TMDD header's explicit, exact and implicit libraries), for the SDE
kernels at four particles a thread their resident blocks per SM and the
trial loop's instruction mix, for the implicit ones their anatomy, and the
stiff cell's lane-slots per trial under each side's layout; and "ODE Short 16384 x 512" (K2a), "ODE
covariates 16384 x 512" (K2e) and, as a check that the exact tier did not
move, "ODE expm transit 16384 x 512" (K2d), each with the kernel alone
(the median of three runs of ten launches), the psi cells that differ at
all, both sides' explicit anatomy, the layout model and each side's issue
slots per cell-trial. ``--pair DIR --only stiff`` (or ``sde``, or
``explicit``) runs that part alone. ``--pair DIR --only closed`` times the
four K1b and K1c cells and K1a's "Short 16384 x 512" and "1-cmt 10000 x
1000" (the kernel alone, the plan alone on the lowered grid and the call),
holds the change's psi to the parent's cell by cell (float64 1e-12
relative; float32 1e-3, 99.9% within 1e-5), and prints every closed-form
kernel's registers, the instantiations' anatomy, the SASS digest of every
K1a, K1b and K1c kernel and each side's issue slots per cell-segment. It
prints the pairs and ``{"ok": true, "partial": "pair"}``.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. All data comes from a numpy
seed. Without a CUDA device the script exits with code 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import json
import pstats
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
SHORT_TIMES = [0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0]
KERNEL_RECORD = {
    "id": "K1a",
    "name": "fused_psi",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_psi.cu",
    "replaces": "pharmsol_tpu/ops/pallas_psi.py:805",
}
ODE_KERNEL_RECORD = {
    "id": "K2a",
    "name": "fused_ode",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_ode.cu",
    "replaces": "pharmsol_tpu/ops/pallas_ode.py:1826",
}
SDE_KERNEL_RECORD = {
    "id": "K3a",
    "name": "fused_sde",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_sde.cu",
    "replaces": "pharmsol_tpu/ops/pallas_sde.py:548",
}
FEATURE_KERNEL_RECORD = {
    "id": "K1b",
    "name": "fused_psi_feature",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_psi.cu",
    "replaces": "pharmsol_tpu/ops/pallas_psi.py:432",
}
ODE_FEATURE_KERNEL_RECORD = {
    "id": "K2e",
    "name": "fused_ode_feature",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_ode.cu",
    "replaces": "pharmsol_tpu/ops/pallas_ode.py:546",
}
EXPM_KERNEL_RECORD = {
    "id": "K2d",
    "name": "fused_ode_expm",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_ode.cu",
    "replaces": "pharmsol_tpu/ops/pallas_ode.py:1152",
}
STIFF_SDIRK_RECORD = {
    "id": "K2b",
    "name": "fused_ode_sdirk",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_ode.cu",
    "replaces": "pharmsol_tpu/ops/pallas_ode.py:949",
}
STIFF_BDF_RECORD = {
    "id": "K2c",
    "name": "fused_ode_bdf",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_ode.cu",
    "replaces": "pharmsol_tpu/ops/pallas_ode.py:1289",
}
SDE_FEATURE_RECORD = {
    "id": "K3b",
    "name": "fused_sde_feature",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_sde.cu",
    "replaces": "pharmsol_tpu/ops/pallas_sde.py:116",
}
K1C_RECORD = {
    "id": "K1c",
    "name": "fused_psi_k1c",
    "route": "cuda",
    "source": "pharmsol_tpu_torch/csrc/fused_psi.cu",
    "replaces": "pharmsol_tpu/ops/pallas_psi.py:498",
}
# the K3b cell: the reference's covariate model as an SDE, subjects x
# supports x the README's particles, and the subjects the twin marches (spread
# over the population) for the kernel-vs-twin check and the bound's counts;
# the same for the K3a cell
SDE_COV_FULL = (256, 64)
SDE_TWIN_ROWS = 1
SDE_CELL_CALLS = 2  # phase 6's calls per dtype
# the K1c cells: lag with a seq chain deeper than one, and a lag and an fa
# that read a time-varying creatinine; the subjects of their check against
# the general engine; the ragged shape of the kernel-vs-twin check; and the
# supports of the lag_post run at the widest population the plane cap admits
K1C_DEPTH_SHAPE = (16384, 512)
K1C_DYN_SHAPE = (10000, 1000)
K1C_CHECK_ROWS = 2048
K1C_RAGGED = (257, 300)
K1C_POST_S = 512
# the lag_post float32 call on a quarter of those subjects (its plan's lane
# walk is host time that goes with the width)
K1C_POST_F32_SHARE = 4
# the stiff cell: the TMDD of benches/stiff_bench.py, subjects x supports; the
# subjects of its check against the general engine, and of its twin
STIFF_SHAPE = (16384, 512)
STIFF_CHECK_ROWS = 256
# the general engine that holds each solver's kernel in phase 14: bdf's, the
# fastest, for all four (the same equations at the same tolerances; trbdf2's
# and kvaerno3's own took 23.1 and 35.2 s on 16 subjects: PERF.md §6)
STIFF_ORACLE = "bdf"
# the stiff check cases at 64 x 48: the TMDD under every solver, each other
# case of STIFF_CASES under one, in turn (every tier compared on three or
# more cases, with the libraries of the TMDD header and one per other case)
STIFF_ALL_SOLVER_CASES = ("tmdd",)
# what the cut parts of this script's earlier paths took before the cuts (its
# previous version on an NVIDIA H100 80GB HBM3 at 700 W, on a faster and a
# slower host), printed beside what they take now: phase 14's general-engine
# oracles (trbdf2's and kvaerno3's own on 256 and 64 subjects), phase 15's
# twins timed alone, phase 5's SDE twin, the build
BEFORE_CUTS_S = {"oracles_256": (42.6, 83.1),
                 "twins_alone": 49.0, "sde_twin": (75.0, 90.0),
                 "build": (119.88, 164.20),
                 # and for phase 28 (the run before these cuts): phase 22's
                 # float64 README SDE predictions (4 observations), the README
                 # SDE cell's six calls, phase 7's bound twin in the main
                 # process
                 "single_sde_f64": 16.2, "sde_cell_calls": 15.1, "sde_bound_twin": 48.9}
STIFF_TWIN_ROWS = 10
STIFF_CHECK_SHAPE = (64, 48)
STIFF_SOLVERS = ("bdf", "trbdf2", "kvaerno3", "kvaerno5")
STIFF_TWIN_WORKERS = 5
STIFF_ORACLE_MAX_STEPS = 500
# the K2d cell: the 5-state transit and mammillary model with expm, subjects x
# supports, and the subjects of its check against the general engine
EXPM_SHAPE = (16384, 512)
EXPM_CHECK_ROWS = 2048
# the population fits: the JAX package's recorded fit of the same data
# (benches/recorded/r05_population_fit.json: results, not times)
FIT_SUBJECTS = 10000
FIT_KW = dict(init_points=1000, max_cycles=8)
FIT_RECORDED = dict(log_likelihood=4237.25, fast_mass=0.496, support=53)
BURNIN_WIDTHS = (4, 16, 40, 128, 400, 1000)
# the K2e slice: the reference's covariate model, subjects x supports, and
# the subjects of its check against the general engine
ODE_COV_SHAPE = (16384, 512)
ODE_COV_CHECK_ROWS = 2048
# subjects of the two K1b cells (Covariate Short, time-varying 10k)
FEATURE_SUBJECTS = (16384, 10000)
# the card's published rates (NVIDIA H100 SXM data sheet, at 700 W): memory,
# and float32 / float64 arithmetic outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# integer work: 64 INT32 lanes per SM (Hopper architecture white paper) on
# 132 SMs at the boost clock that the data sheet's float32 rate implies
# (67e12 = 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz); and the issue rate of
# an SM, four warp-instructions a clock (one scheduler per SM quadrant)
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
H100_INT_OPS_PER_S = 64 * H100_SMS * H100_CLOCK_HZ
H100_WARP_ISSUE_PER_S = 4 * H100_SMS * H100_CLOCK_HZ
# an SM's limits for resident blocks (CUDA programming guide, compute
# capability 9.0): registers, threads, blocks, shared memory (1 KB of it
# reserved per block), and the register file's allocation unit per warp
H100_SM_REGS = 65536
H100_SM_THREADS = 2048
H100_SM_BLOCKS = 32
H100_SM_SHARED = 233472
H100_REG_UNIT = 256
# the SDE cells: the reduced ragged shape of the kernel-vs-twin checks, the
# statistical check against the general engine, and the full-width slice
SDE_REDUCED = (19, 23)
SDE_REDUCED_OBS = 1
SDE_STAT = (32, 16)
SDE_STAT_OBS = 2
SDE_FULL = (256, 64)
SDE_PARTICLES = 1000


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, with the seconds since the script began."""
    print(f"{msg}  [t={time.perf_counter() - _T0:.1f}s]", flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=floor)).max())


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


def short_subjects(pt, n: int, rng, repeat: bool = False, infusion: bool = False,
                   censored: bool = False, two_outputs: bool = False,
                   covariates=None):
    """The reference's "Short" workload (one 100 mg oral dose, 9 observations
    over 12 h), optionally multi-dose, with an infusion, with censored
    observations, with a second output or with covariates
    (``covariates(i, builder) -> builder``)."""
    subjects = []
    for i in range(n):
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        if covariates is not None:
            b = covariates(i, b)
        if repeat:
            b = b.bolus(6.0, 100.0, 0).bolus(12.0, 50.0, 0)
        if infusion:
            b = b.infusion(4.0, 120.0, 0, 2.0)
        values = np.abs(5.0 + rng.randn(len(SHORT_TIMES)))
        for t, v in zip(SHORT_TIMES, values):
            b = b.observation(t, float(v), 0)
        if censored:
            b = b.censored_observation(14.0, 0.1, 0, pt.Censor.BLOQ)
            b = b.censored_observation(0.25, 8.0, 0, pt.Censor.ALOQ)
        if two_outputs:
            for t in (1.0, 5.0, 9.0):
                b = b.observation(t, float(abs(2.0 + rng.randn())), 1)
        subjects.append(b.build())
    return pt.Data(subjects)


def jittered_support(center, n: int, rng, scale: float = 0.15) -> np.ndarray:
    center = np.asarray(center, dtype=np.float64)
    return np.abs(center[None, :] * (1.0 + scale * rng.randn(n, center.size)))


def short_model(pt):
    """The Short cell's model: 2-cmt oral, p = ke, ka, kcp, kpc, v."""
    return pt.Analytical(pt.two_compartments_with_absorption,
                         out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)


def covariate_short_model(pt):
    """The Covariate Short cell's model: allometric (wt/70)**0.75 on the rate
    constants (JAX tests/test_pallas_psi.py:607-637), an absorption lag p[5]
    and a bioavailability p[6]."""
    def allometric(p, t, cov):
        sc = (cov("wt", t) / 70.0) ** 0.75
        return [p[0] * sc, p[1], p[2] * sc, p[3] * sc, p[4], p[5], p[6]]

    return pt.Analytical(
        pt.two_compartments_with_absorption, seq_eq=allometric,
        lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: p[6]},
        out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)


# the lag-depth cell's support centre
LAG_DEPTH_CENTRE = [1.4, 0.2, 0.2, 0.12, 11.5, 0.75]


def lag_depth_cell(pt, rng, n: int) -> tuple:
    """The lag-depth Short cell at ``n`` subjects: JAX
    tests/test_pallas_psi.py:1367-1386, the 2-cmt oral model whose seq
    compounds across the end of the 1.5 h infusion while a lag and an fa act
    on the doses (lag_depth), on the regimen of _lag_depth_subjects (a bolus
    at 0 and the infusion at 1 h), widened: (model, data)."""
    wt = 55.0 + 4.0 * (np.arange(n) % 8)
    times = (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0)
    values = 5.0 * np.exp(-0.2 * np.array(times))[None, :] * np.exp(0.1 * rng.randn(n, 7))
    subjects = []
    for i in range(n):
        b = (pt.Subject.builder(f"d{i}").bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 1.5)
             .covariate("wt", 0.0, float(wt[i])))
        for t, v in zip(times, values[i]):
            b = b.observation(t, float(v), 0)
        subjects.append(b.build())
    model = pt.Analytical(
        pt.two_compartments_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[4],
        seq_eq=lambda p, t, cov: [p[0], p[1] * (1.0 + 0.1 * p[5]), p[2], p[3], p[4], p[5]],
        lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: 1.0 / (1.0 + 0.3 * p[5])},
        nstates=3, ndrugs=1, nout=1)
    return model, pt.Data(subjects)


def kernel_case(pt, structure: str, rng, R: int, S: int, variant: str = ""):
    """(model, data, support, ems) of one phase-2 case."""
    from pharmsol_tpu_torch.engine.analytical import KERNELS
    from pharmsol_tpu_torch.utils.f32_budget import NOMINAL

    fn, nstates, nparams = KERNELS[structure]
    central = 1 if structure.endswith("_with_absorption") else 0
    support = jittered_support(NOMINAL[structure] + [11.0], S, rng)
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    if variant == "two_outputs":
        # y0 = central / v, y1 = peripheral / vp + 0.1 v (a bias row)
        support = np.concatenate(
            [support, jittered_support([20.0], S, rng)], axis=1)
        out = (lambda x, p, t, cov, c=central, v=nparams: torch.stack(
            [x[c] / p[v], x[c + 1] / p[v + 1] + 0.1 * p[v]]))
        nout = 2
        ems = ems.add(1, pt.AssayErrorModel.proportional(
            pt.ErrorPoly(0.0, 0.2), 1.0))
    else:
        out = (lambda x, p, t, cov, c=central, v=nparams: x[c:c + 1] / p[v])
        nout = 1
    model = pt.Analytical(fn, out=out, nstates=nstates, ndrugs=1, nout=nout)
    data = short_subjects(
        pt, R, rng, repeat=True, infusion=variant == "infusion",
        censored=variant == "censoring", two_outputs=variant == "two_outputs")
    return model, data, support, ems


def plan_for(pt, model, data, support, ems, dtype):
    from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedPsiPlan(model, grid, support, lowered, torch.device("cuda"), dtype)


def run_kernel(plan, plain: bool = False) -> torch.Tensor:
    """K1a, or K1b when the plan has a feature input (or their twin)."""
    from pharmsol_tpu_torch.ops.fused_psi import psi_analytical, psi_analytical_plain

    fn = psi_analytical_plain if plain else psi_analytical
    return fn(*plan.streams, plan.support, **plan.kernel_kwargs())


# ---------------------------------------------------------------------------
# ODE models (the RHS of each written with torch ops, as a user would)
# ---------------------------------------------------------------------------


def rhs_bolus_infusion(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * x[0] + b[0],
                        p[0] * x[0] - p[1] * x[1] + rateiv[0]])


def rhs_michaelis_menten(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * x[0] / (p[1] + x[0]) + b[0] + rateiv[0]])


def rhs_two_inputs(x, p, t, b, rateiv, cov):
    return torch.stack([
        -p[0] * x[0] + b[0] + rateiv[1],
        -p[1] * x[1] + b[1],
        p[0] * x[0] + p[1] * x[1] - p[2] * x[2] + rateiv[0],
    ])


def rhs_short(x, p, t, b, rateiv, cov):
    """2-cmt oral as an ODE (the JAX bench.py ODE cell): p = ke, ka, kcp,
    kpc, v, the closed form's parameter order."""
    return torch.stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + rateiv[0],
        p[2] * x[1] - p[3] * x[2],
    ])


# name: (rhs, nstates, ndrugs, output state, volume column, support sampler)
ODE_MODELS = {
    "bolus_infusion": (rhs_bolus_infusion, 2, 1, 1, 2,
                       lambda rng, S: np.column_stack([
                           rng.uniform(0.5, 2.0, S), rng.uniform(0.05, 0.5, S),
                           rng.uniform(30, 90, S)])),
    "michaelis_menten": (rhs_michaelis_menten, 1, 1, 0, 2,
                         lambda rng, S: np.column_stack([
                             rng.uniform(5.0, 20.0, S), rng.uniform(5.0, 30.0, S),
                             rng.uniform(20, 60, S)])),
    "two_inputs": (rhs_two_inputs, 3, 2, 2, 3,
                   lambda rng, S: np.column_stack([
                       rng.uniform(0.5, 2.0, S), rng.uniform(0.3, 1.2, S),
                       rng.uniform(0.05, 0.5, S), rng.uniform(8, 14, S)])),
    "short": (rhs_short, 3, 1, 1, 4,
              lambda rng, S: jittered_support([0.15, 1.2, 0.3, 0.2, 10.0], S, rng, 0.2)),
}


def ode_model(pt, name: str):
    rhs, n, ndrugs, c, v = ODE_MODELS[name][:5]
    return pt.ODE(rhs, out=lambda x, p, t, cov, c=c, v=v: x[c:c + 1] / p[v],
                  nstates=n, ndrugs=ndrugs, nout=1)


def ode_subjects(pt, name: str, n: int, rng):
    """Phase-2 data: the JAX package's test_pallas_ode.py regimen (a bolus,
    an infusion on every third subject, 5 observations), the two-input
    budget regimen, or Short."""
    if name == "short":
        return short_subjects(pt, n, rng)
    subjects = []
    for i in range(n):
        b = pt.Subject.builder(f"o{i}").bolus(0.0, 100.0, 0)
        if name == "two_inputs":
            b = b.bolus(1.0, 60.0, 1).infusion(2.0, 40.0, 1, 1.5)
            times = (0.5, 1.5, 3.0, 5.0, 8.0, 12.0)
        else:
            if i % 3 == 0:
                b = b.infusion(2.0, 50.0, 0, 1.0)
            times = (0.5, 1.0, 2.0, 4.0, 8.0)
        for t in times:
            b = b.observation(t, float(abs(3.0 + rng.randn())), 0)
        subjects.append(b.build())
    return pt.Data(subjects)


def ode_plan_for(model, data, support, ems, dtype):
    from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, support, lowered, torch.device("cuda"), dtype)


def run_ode_kernel(plan, plain: bool = False, merge: bool = True) -> torch.Tensor:
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode, psi_ode_plain

    fn = psi_ode_plain if plain else psi_ode
    return fn(*plan.streams, plan.support, plan.rhs, **plan.kernel_kwargs(merge))


def ode_feature_cases():
    """K2e's phase-2 cases: every mode of ``ODE_FEATURE_CASES`` at 64
    subjects x 48 supports, the reference's covariate model at that shape,
    and the two feature budget rows on their own cases: name -> (model,
    data, support, ems, budget row)."""
    from pharmsol_tpu_torch.utils.f32_budget import (
        ODE_FEATURE_CASES, covariate_model_case, ode_case, ode_feature_case,
    )

    cases = {name: (*ode_feature_case(name, 64, 48, seed=SEED + i), row)
             for i, (name, row) in enumerate(ODE_FEATURE_CASES.items())}
    cases["covariate_model"] = (*covariate_model_case(64, 48, seed=SEED), "ode_lag_fa")
    for name in ("ode_lag_fa", "ode_tv_covariate"):
        cases[f"budget {name}"] = (*ode_case(name), name)
    return cases


def expm_cases():
    """K2d's phase-2 cases at 64 subjects x 48 supports (``EXPM_CASES``: the
    2-state oral model, the 2-cmt oral RHS, the 5-state transit and
    mammillary model with its bolus and infusion, lag and fa, a step
    covariate, init with two outputs, and a poisoned last segment) and the
    ``ode_expm`` budget case: name -> (model, data, support, ems)."""
    from pharmsol_tpu_torch.utils.f32_budget import EXPM_CASES, expm_case, ode_case

    cases = {name: expm_case(name, 64, 48, seed=SEED + i)
             for i, name in enumerate(EXPM_CASES)}
    cases["budget ode_expm"] = ode_case("ode_expm")
    return cases


def explicit_build_targets(feature_cases) -> dict:
    """The explicit tier's libraries (K2a, K2e), one per distinct generated
    source: the K2a models' and the K2e cases', whose RHS is generated with
    their data's covariates by the plan. {key: (name, target)}."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs

    targets = {}
    for name, (rhs, n, ndrugs, _, v, _s) in ODE_MODELS.items():
        gen = generate_rhs(rhs, n, v + 1, ndrugs)
        targets.setdefault(gen.key, (name, _build.generated_target(_build.ODE, gen)))
    for name, (model, data, support, ems, _) in feature_cases.items():
        gen = ode_plan_for(model, data, support, ems, torch.float64).rhs
        targets.setdefault(gen.key, (name, _build.generated_target(_build.ODE, gen)))
    return targets


def ode_build_targets(feature_cases, expm, stiff=None):
    """The ODE library of every RHS this script runs (one per distinct
    generated source): the explicit tier's (``explicit_build_targets``), and
    K2d's cases and the fit's ODE model, whose headers also hold
    ``rhs_jvp``."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs
    from pharmsol_tpu_torch.utils.f32_budget import population_models

    targets = explicit_build_targets(feature_cases)
    for name, (model, data, support, ems) in expm.items():
        gen = ode_plan_for(model, data, support, ems, torch.float64).rhs
        targets.setdefault(gen.key, (f"expm {name}", _build.generated_target(_build.ODE, gen)))
    gen = generate_rhs(population_models()[1]._diffeq, 2, 3, 1, jacobian=True)
    targets.setdefault(gen.key, ("expm fit", _build.generated_target(_build.ODE, gen)))
    return list(targets.values()) + (stiff_build_targets(stiff) if stiff else [])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    from pharmsol_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    card = nvidia_smi()
    log(f"[0] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    log(f"[0] card: {card}  devices: {torch.cuda.device_count()}")
    return card


def phase_build(pt, feature_cases, expm, stiff, only: str = None) -> float:
    """Every library of the run (of the part ``only`` names), one nvcc each,
    all at once."""
    from pharmsol_tpu_torch.ops import _build

    ode_targets = (stiff_build_targets(stiff) if only == "stiff"
                   else [] if only in ("sde", "k1c", "closed", "authoring", "styles")
                   else list(explicit_build_targets(feature_cases).values())
                   if only == "explicit"
                   else ode_build_targets(feature_cases, expm, stiff))
    sde_targets = ([] if only in ("stiff", "k1c", "explicit", "closed", "authoring", "styles")
                   else sde_build_targets(pt) + sde_feature_build_targets(pt))
    if only in (None, "authoring"):
        # phase 23's models: a library each only where their header is new
        ode_new, sde_new = authoring_build_targets(pt)
        ode_targets = dedupe_targets(ode_targets + list(ode_new.values()))
        sde_targets = dedupe_targets(sde_targets + list(sde_new.values()))
    if only in (None, "styles"):
        # phase 28's: the math model's and the tanh SDE's headers are new, the
        # vector-style models share their list-style models' libraries
        ode_new, sde_new = style_build_targets(pt)
        ode_targets = dedupe_targets(ode_targets + ode_new)
        sde_targets = dedupe_targets(sde_targets + sde_new)
    psi_targets = ([] if only in ("stiff", "sde", "explicit", "styles")
                   else [_build.psi_target()])
    targets = (psi_targets + [t for _, t in ode_targets] + [t for _, t in sde_targets])
    names = ([t.name for t in psi_targets]
             + [f"fused_ode ({name})" for name, _ in ode_targets]
             + [f"fused_sde ({name})" for name, _ in sde_targets])
    t0 = time.perf_counter()
    results = _build.build_many(targets, force=True, verbose=True)
    wall = time.perf_counter() - t0
    log(f"[1] built {len(results)} libraries with nvcc in {wall:.2f} s wall, "
        f"one process each ({' '.join(_build.NVCC_FLAGS)})")
    if only is None:
        log(f"[1] cut: the stiff libraries, the TMDD header's under every solver and one per "
            f"other case ({len(stiff_build_targets(stiff))} of them); the build took "
            f"{wall:.1f} s with K3b's libraries among them (before the cut: "
            f"{BEFORE_CUTS_S['build'][0]} - {BEFORE_CUTS_S['build'][1]} s)")
    spilled = []
    for name, (path, seconds, output) in zip(names, results):
        log(f"[1]   {name}: {path.name} in {seconds:.2f} s")
        # ptxas -v: one summary per instantiation; all of K1a, K2a and K2e
        # for the 3-state Short RHS and the covariate model's RHS, K2d for
        # every RHS it is built for, K3a for the README model
        if ((name.startswith("fused_ode") and "short" not in name
             and "covariate_model" not in name and "expm" not in name
             and "stiff" not in name)
                or (name.startswith("fused_sde") and "readme" not in name
                    and "covariates cell" not in name)):
            continue
        kernel, spill = None, ""
        for ln in output.splitlines():
            m = (re.search(r"fused_psi_feature_kernelI([fd])Li(\d+)ELi(\d)E", ln)
                 or re.search(r"prepare_levels_kernelI([fd])Li(\d+)E()", ln)
                 or re.search(r"fused_ode_kernelI([fd])Li(\d+)ELb(\d)E", ln)
                 or re.search(r"fused_ode_implicit_kernelI([fd])Li(\d+)ELb(\d)E", ln)
                 or re.search(r"fused_sde_kernelI([fd])Li(\d+)ELb(\d)E", ln))
            if m and "Compiling entry function" in ln:
                what = ("K1b/K1c level table code" if "prepare_levels" in ln else
                        ("K1a code", "K1b code", "K1c code")[int(m.group(3))]
                        if "fused_psi_feature" in ln else
                        ("K3b" if m.group(3) == "1" else "K3a") + " particles/thread"
                        if "fused_sde" in ln else
                        "K2d expm" + (", features" if m.group(3) == "1" else "")
                        if m.group(2) == "2" else
                        {"3": "K2b trbdf2", "4": "K2b kvaerno3", "5": "K2b kvaerno5",
                         "6": "K2c bdf"}[m.group(2)]
                        + (", features" if m.group(3) == "1" else "")
                        if m.group(2) in "3456" else
                        ("K2e" if m.group(3) == "1" else "K2a") + " solver "
                        + ("dopri5" if m.group(2) == "0" else "tsit5"))
                kernel = f"{'f32' if m.group(1) == 'f' else 'f64'} {what} {m.group(2):>2}"
            elif "spill stores" in ln:
                spill = ln.strip()
            elif "registers" in ln and kernel:
                regs = ln.split("Used")[-1].split(",")[0].strip()
                log(f"[1]   ptxas {name} {kernel}: {regs}; {spill}")
                stores = re.search(r"(\d+) bytes spill stores", spill)
                if stores and int(stores.group(1)) > 0:
                    spilled.append(f"{name} {kernel}")
                kernel, spill = None, ""
    log("[1] spill stores (ptxas): " + (", ".join(spilled) if spilled else "none"))
    if psi_targets:
        _build.load_library()
    return wall


def phase_kernels(pt, rng) -> None:
    from pharmsol_tpu_torch.ops.fused_psi import STRUCTURES
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error
    from pharmsol_tpu_torch.utils.f32_budget import kernel_case as budget_case

    R, S = 257, 300
    cases = [(name, "") for name in STRUCTURES] + [
        ("two_compartments_with_absorption", v)
        for v in ("infusion", "censoring", "two_outputs")]
    for structure, variant in cases:
        name = structure + (f"+{variant}" if variant else "")
        model, data, support, ems = kernel_case(pt, structure, rng, R, S, variant)
        plan64 = plan_for(pt, model, data, support, ems, torch.float64)
        plan32 = plan_for(pt, model, data, support, ems, torch.float32)
        twin64 = run_kernel(plan64, plain=True)
        got64 = run_kernel(plan64)
        got32 = run_kernel(plan32)
        twin32 = run_kernel(plan32, plain=True)
        torch.cuda.synchronize()
        if not (torch.isfinite(got64).all() and torch.isfinite(got32).all()):
            raise AssertionError(f"{name}: non-finite kernel psi")
        e64 = rel_err(got64, twin64, 1e-300)
        ref = twin64.cpu().numpy()
        e32 = f32_error(got32.cpu().numpy(), ref)
        e32_twin = f32_error(twin32.cpu().numpy(), ref)
        log(f"[2] {name:46s} {R}x{S} f64 kernel vs twin rel {e64:.3e} "
            f"(<= 1e-10); f32 vs f64 twin: kernel {e32:.3e}, twin {e32_twin:.3e}")
        if e64 > 1e-10:
            raise AssertionError(f"{name}: f64 kernel vs twin {e64} > 1e-10")
        if variant:
            continue
        # float32 against the committed budget, on the budget's own case
        bmodel, bdata, bsupport, bems = budget_case(structure)
        golden = run_kernel(plan_for(pt, bmodel, bdata, bsupport, bems,
                                     torch.float64), plain=True)
        got = run_kernel(plan_for(pt, bmodel, bdata, bsupport, bems,
                                  torch.float32))
        torch.cuda.synchronize()
        eb = f32_error(got.cpu().numpy(), golden.cpu().numpy())
        budget = F32_BUDGET[structure]
        log(f"[2] {name:46s} budget case f32 kernel {eb:.3e} (<= {budget:g})")
        if eb > budget:
            raise AssertionError(f"{name}: f32 kernel {eb} > budget {budget}")


def phase_feature_kernels(pt) -> None:
    """K1b against its twin on the card, every mode (FEATURE_CASES) at 64
    subjects x 48 supports: float64 within 1e-10 relative, float32 against
    the float64 twin within the mode's budget row; then the feature budget
    rows on their own cases."""
    from pharmsol_tpu_torch.utils.f32_budget import (
        F32_BUDGET, FEATURE_BUDGETS, FEATURE_CASES, f32_error, feature_budget_case,
        feature_case,
    )

    R, S = 64, 48
    for i, (name, row) in enumerate(FEATURE_CASES.items()):
        model, data, support, ems, mode = feature_case(name, R, S, seed=SEED + i)
        plan64 = plan_for(pt, model, data, support, ems, torch.float64)
        plan32 = plan_for(pt, model, data, support, ems, torch.float32)
        if plan64.mode != mode or plan32.mode != mode:
            raise AssertionError(f"K1b {name}: plan mode {plan64.mode}, expected {mode}")
        feats = [k for k, v in plan64.features.items() if v is not None]
        twin64 = run_kernel(plan64, plain=True)
        got64 = run_kernel(plan64)
        got32 = run_kernel(plan32)
        torch.cuda.synchronize()
        if not (torch.isfinite(got64).all() and torch.isfinite(got32).all()):
            raise AssertionError(f"K1b {name}: non-finite kernel psi")
        e64 = rel_err(got64, twin64, 1e-300)
        e32 = f32_error(got32.cpu().numpy(), twin64.cpu().numpy())
        budget = F32_BUDGET[row]
        log(f"[2] K1b {name:15s} {R}x{S} mode {str(mode):8s} f64 kernel vs twin rel "
            f"{e64:.3e} (<= 1e-10); f32 kernel vs f64 twin {e32:.3e} (<= {row} "
            f"{budget:g}); {', '.join(feats)}")
        if e64 > 1e-10:
            raise AssertionError(f"K1b {name}: f64 kernel vs twin {e64} > 1e-10")
        if e32 > budget:
            raise AssertionError(f"K1b {name}: f32 kernel {e32} > {row} {budget}")
    for name in FEATURE_BUDGETS:
        model, data, support, ems = feature_budget_case(name)
        golden = run_kernel(plan_for(pt, model, data, support, ems, torch.float64), plain=True)
        got = run_kernel(plan_for(pt, model, data, support, ems, torch.float32))
        torch.cuda.synchronize()
        eb = f32_error(got.cpu().numpy(), golden.cpu().numpy())
        log(f"[2] K1b budget case {name}: f32 kernel {eb:.3e} (<= {F32_BUDGET[name]:g})")
        if eb > F32_BUDGET[name]:
            raise AssertionError(f"{name}: f32 kernel {eb} > budget {F32_BUDGET[name]}")


def phase_ode_kernels(pt, rng) -> None:
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error, ode_case

    R, S = 257, 300
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    for name in ("bolus_infusion", "michaelis_menten", "two_inputs"):
        data = ode_subjects(pt, name, R, rng)
        support = ODE_MODELS[name][5](rng, S)
        for solver in ("dopri5", "tsit5"):
            model = ode_model(pt, name).with_solver(solver)
            plan64 = ode_plan_for(model, data, support, ems, torch.float64)
            plan32 = ode_plan_for(model, data, support, ems, torch.float32)
            if plan64.merge_runs is None:
                raise AssertionError(f"{name}: no merged runs to check")
            for merge in (True, False):
                twin64 = run_ode_kernel(plan64, plain=True, merge=merge)
                got64 = run_ode_kernel(plan64, merge=merge)
                got32 = run_ode_kernel(plan32, merge=merge)
                torch.cuda.synchronize()
                label = f"{name}/{solver}/{'merged' if merge else 'per-segment'}"
                if not (torch.isfinite(got64).all() and torch.isfinite(got32).all()):
                    raise AssertionError(f"{label}: non-finite kernel psi")
                e64 = rel_err(got64, twin64, 1.0)
                e32 = f32_error(got32.cpu().numpy(), twin64.cpu().numpy())
                log(f"[2] K2a {label:40s} {R}x{S} f64 kernel vs twin rel {e64:.3e} "
                    f"(<= 1e-8); f32 kernel vs f64 twin {e32:.3e}")
                if e64 > 1e-8:
                    raise AssertionError(f"{label}: f64 kernel vs twin {e64} > 1e-8")
    for name in ("ode_dopri5", "ode_multi_input"):
        model, data, support, bems = ode_case(name)
        golden = run_ode_kernel(ode_plan_for(model, data, support, bems,
                                             torch.float64), plain=True)
        got = run_ode_kernel(ode_plan_for(model, data, support, bems, torch.float32))
        torch.cuda.synchronize()
        eb = f32_error(got.cpu().numpy(), golden.cpu().numpy())
        budget = F32_BUDGET[name]
        log(f"[2] K2a budget case {name}: f32 kernel {eb:.3e} (<= {budget:g})")
        if eb > budget:
            raise AssertionError(f"{name}: f32 kernel {eb} > budget {budget}")


def describe_ode_features(plan) -> str:
    """K2e's inputs in a plan, for the log."""
    f = plan.features
    parts = [f"{n} {m}" for n, m in zip(plan.rhs.cov_names, plan.rhs.cov_modes)]
    for key in ("init_rows", "init_planes"):
        if f[key] is not None:
            parts.append(key)
    for key, slots in (("lag_plane", "lag_slots"), ("fa_plane", "fa_slots")):
        if f[key] is not None:
            parts.append(f"{key.split('_')[0]} {'slots' if f[slots] else 'planes'}"
                         f" x{f[key].shape[0]}")
    parts.append("merged runs" if plan.merge_runs else "per segment")
    return ", ".join(parts)


def phase_ode_feature_kernels(pt, cases) -> None:
    """K2e against its twin on the card in every mode (``ode_feature_cases``,
    64 subjects x 48 supports) and on the two feature budget cases: float64
    within 1e-8 relative, merged and segment by segment where the plan
    merges; float32 against the float64 twin within the case's budget row;
    every call one K2e launch and no K2a launch."""
    from pharmsol_tpu_torch.ops import fused_ode
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    for name, (model, data, support, ems, row) in cases.items():
        plan64 = ode_plan_for(model, data, support, ems, torch.float64)
        plan32 = ode_plan_for(model, data, support, ems, torch.float32)
        for merge in ((True, False) if plan64.merge_runs is not None else (True,)):
            twin64 = run_ode_kernel(plan64, plain=True, merge=merge)
            before = (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES)
            got64 = run_ode_kernel(plan64, merge=merge)
            got32 = run_ode_kernel(plan32, merge=merge)
            torch.cuda.synchronize()
            launches = (fused_ode.LAUNCHES - before[0], fused_ode.FEATURE_LAUNCHES - before[1])
            label = f"{name}/{'merged' if merge else 'per-segment'}"
            if launches != (0, 2):
                raise AssertionError(f"K2e {label}: (K2a, K2e) launches {launches}, not (0, 2)")
            if not (torch.isfinite(got64).all() and torch.isfinite(got32).all()):
                raise AssertionError(f"K2e {label}: non-finite kernel psi")
            e64 = rel_err(got64, twin64, 1.0)
            e32 = f32_error(got32.cpu().numpy(), twin64.cpu().numpy())
            log(f"[2] K2e {label:32s} {len(data)}x{support.shape[0]} f64 kernel vs twin rel "
                f"{e64:.3e} (<= 1e-8); f32 kernel vs f64 twin {e32:.3e} (<= {row} "
                f"{F32_BUDGET[row]:g}); {describe_ode_features(plan64)}")
            if e64 > 1e-8:
                raise AssertionError(f"K2e {label}: f64 kernel vs twin {e64} > 1e-8")
            if e32 > F32_BUDGET[row]:
                raise AssertionError(f"K2e {label}: f32 kernel {e32} > {row} {F32_BUDGET[row]}")


def phase_cross_family(pt, rng) -> None:
    """The Short 2-cmt oral ODE at tight tolerances against the closed form."""
    R, S = 257, 300
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    data = short_subjects(pt, R, rng)
    support = ODE_MODELS["short"][5](rng, S)
    pt.set_float_dtype(torch.float64)
    ode = ode_model(pt, "short").with_tolerances(1e-9, 1e-9)
    closed = pt.Analytical(pt.two_compartments_with_absorption,
                           out=lambda x, p, t, cov: x[1:2] / p[4],
                           nstates=3, ndrugs=1, nout=1)
    psi_ode = pt.log_likelihood_matrix(ode, data, support, ems, device="cuda")
    psi_cf = pt.log_likelihood_matrix(closed, data, support, ems, device="cuda")
    torch.cuda.synchronize()
    for m in (ode, closed):
        if pt.last_engine_decision(m)["engine"] != "fused":
            raise AssertionError(f"cross-family: {pt.last_engine_decision(m)}")
    err = rel_err(psi_ode, psi_cf, 1.0)
    log(f"[2] cross-family: Short ODE (rtol = atol = 1e-9) vs closed form "
        f"{R}x{S} f64 rel {err:.3e} (<= 1e-5)")
    if not (err <= 1e-5):
        raise AssertionError(f"ODE vs closed form {err} > 1e-5")


def slice_workloads(pt, rng):
    """The two full-width cells: (label, model, data, centre, S, builder s)."""
    out = []
    t0 = time.perf_counter()
    data = short_subjects(pt, 16384, rng)
    t_build = time.perf_counter() - t0
    out.append(("2cmt_oral_short_16384x512", short_model(pt), data,
                [0.15, 1.2, 0.3, 0.2, 10.0], 512, t_build))
    t0 = time.perf_counter()
    data10k = short_subjects(pt, 10000, rng)
    t_build = time.perf_counter() - t0
    model1 = pt.Analytical(
        pt.one_compartment_with_absorption,
        out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    out.append(("1cmt_oral_10000x1000", model1, data10k,
                [1.2, 0.2, 30.0], 1000, t_build))
    return out


def phase_slice(pt, rng, workloads, ems) -> int:
    from pharmsol_tpu_torch.ops import fused_psi

    supports = {}
    for label, model, data, centre, S, _ in workloads:
        supports[label] = [jittered_support(centre, S, rng, 0.2) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_psi.LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for label, model, data, centre, S, _ in workloads:
            for i, sp in enumerate(supports[label]):
                before = fused_psi.LAUNCHES
                psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
                torch.cuda.synchronize()
                dec = pt.last_engine_decision(model)
                launches = fused_psi.LAUNCHES - before
                if dec["engine"] != "fused":
                    raise AssertionError(f"{label}: engine {dec}")
                if launches != 1:
                    raise AssertionError(f"{label}: {launches} launches in one call")
                if tuple(psi.shape) != (len(data), S) or psi.device.type != "cuda":
                    raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
                if not bool(torch.isfinite(psi).all()):
                    raise AssertionError(f"{label}: non-finite psi")
                results.append((dtype, label, model, data, sp, psi))
    launches = fused_psi.LAUNCHES
    log(f"[3] main path: {len(results)} log_likelihood_matrix calls on cuda, "
        f"engine fused, {launches} kernel launches")
    # agreement with the general engine on the card (not counted above)
    for dtype, label, model, data, sp, psi in results:
        pt.set_float_dtype(dtype)
        want = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda",
                                        engine="general")
        torch.cuda.synchronize()
        if dtype == torch.float32:
            err, tol = rel_err(psi, want, 1e-3), 1e-3
        else:
            err, tol = rel_err(psi, want, 1e-300), 1e-10
        log(f"[3] {label} {str(dtype)[6:]}: fused vs general rel {err:.3e} "
            f"(<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if err > tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return launches


def phase_kernel_at_slice(pt, workloads, ems) -> dict:
    """The kernel against its twin at the main path's shapes."""
    errs = {}
    for dtype in (torch.float32, torch.float64):
        for label, model, data, centre, S, _ in workloads:
            sp = jittered_support(centre, S, np.random.RandomState(SEED + 1), 0.2)
            plan = plan_for(pt, model, data, sp, ems, dtype)
            got, twin = run_kernel(plan), run_kernel(plan, plain=True)
            torch.cuda.synchronize()
            abs_err = float((got.double() - twin.double()).abs().max())
            rel = rel_err(got, twin, 1.0)
            tol = 1e-4 if dtype == torch.float32 else 1e-10
            log(f"[3] kernel vs twin {label} {str(dtype)[6:]}: max abs "
                f"{abs_err:.3e}, rel {rel:.3e} (<= {tol:g})")
            if rel > tol:
                raise AssertionError(f"{label} {dtype}: kernel vs twin {rel} > {tol}")
            errs[(label, dtype)] = abs_err
    return errs


def phase_ode_slice(pt, rng, data, ems) -> tuple:
    """The ODE slice: Short as a 2-cmt oral ODE, 16384 x 512, K2a."""
    from pharmsol_tpu_torch.ops import fused_ode
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    label = f"ode_2cmt_oral_short_{len(data)}x512"
    model = ode_model(pt, "short")
    supports = [ODE_MODELS["short"][5](rng, 512) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_ode.LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = fused_ode.LAUNCHES
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            dec = pt.last_engine_decision(model)
            launches = fused_ode.LAUNCHES - before
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            if launches != 1:
                raise AssertionError(f"{label}: {launches} launches in one call")
            if tuple(psi.shape) != (len(data), 512) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            if not bool(torch.isfinite(psi).all()):
                raise AssertionError(f"{label}: non-finite psi")
            results.append((dtype, sp, psi))
    launches = fused_ode.LAUNCHES
    log(f"[3] ODE main path: {len(results)} log_likelihood_matrix calls on cuda, "
        f"engine fused, {launches} K2a launches")
    # agreement with the float64 general engine on the card (not counted above)
    pt.set_float_dtype(torch.float64)
    general = {}
    for i, sp in enumerate(supports):
        t0 = time.perf_counter()
        general[i] = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda",
                                              engine="general")
        torch.cuda.synchronize()
        log(f"[3] {label} general engine f64 call {i}: "
            f"{time.perf_counter() - t0:.3f} s wall")
    for j, (dtype, sp, psi) in enumerate(results):
        want = general[j % len(supports)]
        if dtype == torch.float64:
            err, tol = rel_err(psi, want, 1.0), 1e-4
        else:
            err, tol = f32_error(psi.cpu().numpy(), want.cpu().numpy()), F32_BUDGET["ode_dopri5"]
        log(f"[3] {label} {str(dtype)[6:]}: fused vs f64 general rel {err:.3e} "
            f"(<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if err > tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return label, model, launches


def phase_ode_feature_slice(pt, rng) -> tuple:
    """The K2e slice: the reference's covariate model (creatinine with two
    knots, a constant age, lag, three doses) at 16384 subjects x 512
    supports through the public entry point, three calls in float32 and
    three in float64 with fresh supports, each on the fused engine with
    exactly one K2e launch and no K2a launch; then each held against the
    general engine on the card on its first 2048 subjects (float64 within
    1e-4, float32 within the ``ode_lag_fa`` budget of the float64 general
    engine)."""
    from pharmsol_tpu_torch.ops import fused_ode
    from pharmsol_tpu_torch.utils.f32_budget import (
        COVARIATE_MODEL_CENTRE, F32_BUDGET, covariate_model_case, f32_error,
    )

    n, S = ODE_COV_SHAPE
    rows = ODE_COV_CHECK_ROWS
    label = f"ode_covariates_{n}x{S}"
    t0 = time.perf_counter()
    model, data, _, ems = covariate_model_case(n, 1, seed=SEED)
    t_build = time.perf_counter() - t0
    supports = [jittered_support(COVARIATE_MODEL_CENTRE, S, rng) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_ode.LAUNCHES = 0
    fused_ode.FEATURE_LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = fused_ode.FEATURE_LAUNCHES
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            if fused_ode.FEATURE_LAUNCHES - before != 1:
                raise AssertionError(f"{label}: {fused_ode.FEATURE_LAUNCHES - before} K2e "
                                     "launches in one call")
            if tuple(psi.shape) != (n, S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            bad = int((~torch.isfinite(psi)).sum())
            if bad:
                raise AssertionError(f"{label} {dtype}: {bad} non-finite psi cells")
            results.append((dtype, sp, psi))
    launches, k2a = fused_ode.FEATURE_LAUNCHES, fused_ode.LAUNCHES
    log(f"[8] {label}: {len(results)} log_likelihood_matrix calls on cuda, engine fused, "
        f"{launches} K2e launches, {k2a} K2a launches")
    if k2a:
        raise AssertionError(f"{label}: the main path launched K2a")
    plan = ode_plan_for(model, data, supports[0], ems, torch.float64)
    log(f"[8] {label}: K2e inputs {describe_ode_features(plan)}")
    sub = pt.Data(data.subjects()[:rows])
    pt.set_float_dtype(torch.float64)
    general = [pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
               for sp in supports]
    torch.cuda.synchronize()
    for j, (dtype, sp, psi) in enumerate(results):
        want = general[j % len(supports)]
        if dtype == torch.float64:
            err, tol = rel_err(psi[:rows], want, 1.0), 1e-4
        else:
            err = f32_error(psi[:rows].cpu().numpy(), want.cpu().numpy())
            tol = F32_BUDGET["ode_lag_fa"]
        log(f"[8] {label} {str(dtype)[6:]}: fused vs f64 general on subjects 0-{rows - 1} "
            f"rel {err:.3e} (<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if err > tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return label, model, data, ems, launches, t_build


def phase_ode_feature_times(pt, label, model, data, ems, t_build, card: str) -> dict:
    """K2e alone, its twin, the general engine on the subjects of the check,
    one end-to-end call and its steps at the slice's shape; K2e held against
    its twin there; the bound of its work."""
    from pharmsol_tpu_torch.likelihood.matrix import _general_psi
    from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain
    from pharmsol_tpu_torch.utils.f32_budget import (
        COVARIATE_MODEL_CENTRE, F32_BUDGET, f32_error,
    )

    n, S = ODE_COV_SHAPE
    rows = ODE_COV_CHECK_ROWS
    sp = jittered_support(COVARIATE_MODEL_CENTRE, S, np.random.RandomState(SEED + 5))
    sub = pt.Data(data.subjects()[:rows])
    grid = model.lower(data.subjects())
    sub_grid = model.lower(sub.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    out, twin64 = {}, None
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        plan = ode_plan_for(model, data, sp, ems, dtype)
        kw = plan.kernel_kwargs()
        counts = {}
        got = run_ode_kernel(plan)
        twin = psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts, **kw)
        torch.cuda.synchronize()
        if dtype == torch.float64:
            # among 8.4 M cells a few take one accept/reject decision the
            # other way at a rounding-level tie (fused multiply-adds), which
            # moves psi by far less than the controller's error: every cell
            # within 1e-6 relative, 99.9% within 1e-8
            twin64 = twin
            abs_err = float((got - twin).abs().max())
            rel, tol = rel_err(got, twin, 1.0), 1e-6
            cell = (got - twin).abs() / twin.abs().clamp(min=1.0)
            share = float((cell <= 1e-8).double().mean())
            if share < 0.999:
                raise AssertionError(f"{label} {dtype}: {share} of cells within 1e-8 < 0.999")
            note = f"; {share * 100:.4f}% of cells within 1e-8 (>= 99.9%)"
        else:
            abs_err = float((got.double() - twin64).abs().max())
            rel, tol = f32_error(got.cpu().numpy(), twin64.cpu().numpy()), F32_BUDGET["ode_lag_fa"]
            note = ", against the f64 twin"
        log(f"[8] K2e vs twin {label} {d}: max abs {abs_err:.3e}, rel {rel:.3e} "
            f"(<= {tol:g}){note}")
        if rel > tol:
            raise AssertionError(f"{label} {dtype}: K2e vs twin {rel} > {tol}")

        def build_plan():  # the plan alone, the grid lowered already
            return _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cuda"), dtype)

        t = {
            "kernel": cuda_ms(lambda: run_ode_kernel(plan), 10),
            "twin": cuda_ms(lambda: run_ode_kernel(plan, plain=True), 1, 1),
            "general": wall_ms(lambda: _general_psi(
                model, sub_grid, sp, lowered, torch.device("cuda"), dtype), 2),
            "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                model, data, sp, ems, device="cuda"), 5),
        }
        psi_rows = run_ode_kernel(plan)
        parts = {
            "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 3),
            "plan": wall_ms(build_plan, 3),
            "finalize": cuda_ms(lambda: plan.finalize(psi_rows), 10),
        }
        # the plan's costliest calls, in float64
        top = []
        if dtype == torch.float64:
            prof = cProfile.Profile()
            prof.runcall(build_plan)
            top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
            top = [(fn, st[3] * 1e3) for (path, _, fn), st in top
                   if "pharmsol_tpu_torch" in path and fn != "__init__"][:6]
        ops = counts["steps"] * ode_step_ops(model)
        nbytes = plan_bytes(plan, kw, n, S)
        t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
        cells = n * S
        for k in ("kernel", "twin", "end_to_end"):
            log(f"[8] {label} {d} {k:10s} {t[k]:10.3f} ms  {cells / (t[k] * 1e-3):.4g} "
                f"cells/s  ({card})")
        log(f"[8] {label} {d} general    {t['general']:10.3f} ms on subjects 0-{rows - 1} "
            f"x {S}  ({card})")
        log(f"[8] {label} {d} end_to_end parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        if top:
            log(f"[8] {label} {d} plan, costliest calls (ms, cumulative, profiled): "
                + ", ".join(f"{fn} {ms:.1f}" for fn, ms in top))
        log(f"[8] {label} {d} shares of end_to_end: kernel {t['kernel'] / t['end_to_end']:.4f}, "
            f"plan {parts['plan'] / t['end_to_end']:.4f}, lowering lookup "
            f"{parts['lower_cached'] / t['end_to_end']:.4f}, finalize "
            f"{parts['finalize'] / t['end_to_end']:.4f} ({card})")
        log(f"[8] {label} {d} K2e bound {t['bound']:.5g} ms by {t['bound_by']} "
            f"({nbytes / 1e6:.2f} MB, {counts['steps']} step attempts, {ops / 1e9:.3f} G "
            f"operations); kernel at {t['bound'] / t['kernel']:.3f} of it")
        t["abs_err"] = abs_err
        t["plan"] = parts["plan"]
        t["steps"] = counts["steps"]
        out[dtype] = t
    dts = (torch.float32, torch.float64)
    out["report"] = explicit_anatomy_report(
        pt, "8", model, data, sp, ems, {dt: out[dt]["kernel"] for dt in dts},
        {dt: out[dt]["steps"] for dt in dts}, card)
    model._lower_cache.clear()
    t0 = time.perf_counter()
    model.lower(data.subjects())
    log(f"[8] {label} host: subject builder {t_build * 1e3:.1f} ms, lowering "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({n} subjects)")
    return out


def ode_end_to_end_parts(model, data, sp, ems, dtype, plan) -> dict:
    """Wall times of the steps of one fused ODE log_likelihood_matrix call."""
    from pharmsol_tpu_torch.engine.grid import CovView
    from pharmsol_tpu_torch.ops.fused_psi import extract_linear_out, streams_from_grid

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    psi_rows = run_ode_kernel(plan)
    return {
        "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 3),
        "streams": wall_ms(lambda: streams_from_grid(
            grid.rows, lowered, inputs=model.ndrugs()), 3),
        "out_coef": wall_ms(lambda: extract_linear_out(
            model._out, sp, model.nstates(), model.nouteqs(), CovView.empty()), 3),
        "plan": wall_ms(lambda: ode_plan_for(model, data, sp, ems, dtype), 3),
        "finalize": cuda_ms(lambda: plan.finalize(psi_rows), 10),
    }


def phase_ode_times(pt, label, model, data, ems, card: str) -> dict:
    """K2a alone, its twin, the general engine and one end-to-end call at the
    main path's shape; K2a held against its twin there."""
    from pharmsol_tpu_torch.likelihood.matrix import _general_psi
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    out = {}
    sp = ODE_MODELS["short"][5](np.random.RandomState(SEED + 3), 512)
    cells = len(data) * 512
    twin64 = None
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        plan = ode_plan_for(model, data, sp, ems, dtype)
        grid = model.lower(data.subjects())
        lowered = ems.lower(model.resolve_output_label, model.nouteqs())
        got, twin = run_ode_kernel(plan), run_ode_kernel(plan, plain=True)
        torch.cuda.synchronize()
        d = str(dtype)[6:]
        if dtype == torch.float64:
            twin64 = twin
            abs_err = float((got - twin).abs().max())
            rel, tol = rel_err(got, twin, 1.0), 1e-8
        else:
            abs_err = float((got.double() - twin64).abs().max())
            rel, tol = f32_error(got.cpu().numpy(), twin64.cpu().numpy()), F32_BUDGET["ode_dopri5"]
        log(f"[3] K2a vs twin {label} {d}: max abs {abs_err:.3e}, rel {rel:.3e} "
            f"(<= {tol:g}{'' if dtype == torch.float64 else ', against the f64 twin'})")
        if rel > tol:
            raise AssertionError(f"{label} {dtype}: K2a vs twin {rel} > {tol}")
        t = {
            "kernel": cuda_ms(lambda: run_ode_kernel(plan), 10),
            "twin": cuda_ms(lambda: run_ode_kernel(plan, plain=True), 2, 1),
            "general": wall_ms(lambda: _general_psi(
                model, grid, sp, lowered, torch.device("cuda"), dtype), 2),
            "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                model, data, sp, ems, device="cuda"), 5),
        }
        for k, ms in t.items():
            log(f"[4] {label} {d} {k:10s} {ms:10.3f} ms  "
                f"{cells / (ms * 1e-3):.4g} cells/s  ({card})")
        parts = ode_end_to_end_parts(model, data, sp, ems, dtype, plan)
        log(f"[4] {label} {d} end_to_end parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        log(f"[4] {label} {d} kernel+finalize share of end_to_end "
            f"{(t['kernel'] + parts['finalize']) / t['end_to_end']:.4f} ({card})")
        from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain

        counts = {}
        kw = plan.kernel_kwargs()
        psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts, **kw)
        ops = counts["steps"] * ode_step_ops(model)
        nbytes = plan_bytes(plan, kw, len(data), 512)
        t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
        log(f"[4] {label} {d} K2a bound {t['bound']:.5g} ms by {t['bound_by']} "
            f"({nbytes / 1e6:.2f} MB, {counts['steps']} step attempts, {ops / 1e9:.3f} G "
            f"operations); kernel at {t['bound'] / t['kernel']:.3f} of it")
        t["abs_err"] = abs_err
        t["steps"] = counts["steps"]
        out[dtype] = t
    dts = (torch.float32, torch.float64)
    out["report"] = explicit_anatomy_report(
        pt, "4", model, data, sp, ems, {dt: out[dt]["kernel"] for dt in dts},
        {dt: out[dt]["steps"] for dt in dts}, card)
    return out


# ---------------------------------------------------------------------------
# SDE models: the README model of the reference (sde_readme.rs) and a
# two-input model with an inject-to-destination route
# ---------------------------------------------------------------------------


def readme_sde(pt, nparticles: int = SDE_PARTICLES, drift=None):
    """examples/sde_readme.py with torch closures: the elimination rate
    ke_latent follows a mean-reverting diffusion around ke0; p = ke0, v,
    sigma_ke; a bolus routed to `central`. ``drift`` replaces the README's
    (phase 28's tanh drift)."""
    from pharmsol_tpu_torch import metadata

    md = (metadata.new("ke_diffusion").parameters(["ke0", "v", "sigma_ke"])
          .states(["central", "ke_latent"]).outputs(["cp"])
          .route(metadata.Route.bolus("iv").to_state("central"))
          .particles(nparticles))
    return pt.SDE(
        drift=drift or (lambda x, p, t, rateiv, cov: torch.stack([-x[1] * x[0],
                                                                  -(x[1] - p[0])])),
        diffusion=lambda p, t, cov: [0.0, p[2]],
        init=lambda p, t, cov: [0.0, p[0]],
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=nparticles, nstates=2, ndrugs=1, nout=1, seed=42,
    ).with_metadata(md)


def readme_data(pt, n: int, rng, labels=("iv", "cp"), n_obs: int = 4):
    """A 100 mg IV bolus at 0 and observations at 1, 2, 4 and 8 h around
    the README's 8.0, 6.2, 4.1 and 1.8; ``labels`` names the route and the
    output. ``n_obs`` keeps the first observations only: the twin's masked
    loop takes as many iterations as the slowest cell takes trials, so its
    time on the card goes with the span, not with the cells."""
    values = np.array([8.0, 6.2, 4.1, 1.8]) * np.exp(0.15 * rng.randn(n, 4))
    subjects = []
    for i in range(n):
        b = pt.Subject.builder(f"r{i}").bolus(0.0, 100.0, labels[0])
        for t, v in list(zip((1.0, 2.0, 4.0, 8.0), values[i]))[:n_obs]:
            b = b.observation(t, float(v), labels[1])
        subjects.append(b.build())
    return pt.Data(subjects)


def readme_ems(pt, label="cp"):
    return pt.AssayErrorModels().add(
        label, pt.AssayErrorModel.additive(pt.ErrorPoly(0.3, 0.1), 0.5))


def readme_support(S: int, rng, sigma: float = 0.05) -> np.ndarray:
    sp = jittered_support([0.2, 10.0, 0.05], S, rng, 0.15)
    sp[:, 2] = sp[:, 2] * (sigma / 0.05)
    return sp


def two_input_sde(pt, nparticles: int = SDE_PARTICLES):
    """Two inputs (a bolus route injecting into `b`, a bolus and an
    infusion into `a`), three states, em_control='coupled'."""
    from pharmsol_tpu_torch import metadata

    md = (metadata.new("two_inputs").parameters(["k1", "k2", "v", "g"])
          .states(["a", "b", "c"]).outputs(["cp"])
          .route(metadata.Route.bolus("oral").to_state("b").inject_input_to_destination())
          .route(metadata.Route.bolus("iv").to_state("a"))
          .route(metadata.Route.infusion("iv").to_state("a"))
          .particles(nparticles))
    return pt.SDE(
        drift=lambda x, p, t, r, cov: torch.stack([
            -p[0] * x[0] + r[1], -p[1] * x[1],
            p[0] * x[0] + p[1] * x[1] - 0.2 * x[2] + r[0]]),
        diffusion=lambda p, t, cov: [0.0, p[3], 0.5 * p[3]],
        out=lambda x, p, t, cov: x[2:3] / p[2],
        nparticles=nparticles, nstates=3, ndrugs=2, nout=1, seed=7,
        em_control="coupled",
    ).with_metadata(md)


def two_input_case(pt, R: int, S: int, rng):
    subjects = []
    for i in range(R):
        b = (pt.Subject.builder(f"c{i}").bolus(0.0, 100.0, "oral")
             .bolus(1.0, 60.0, "iv").infusion(2.0, 40.0, "iv", 1.5))
        for t in (0.5, 1.5, 3.0, 5.0):
            b = b.observation(t, float(abs(8.0 + 2.0 * rng.randn())), "cp")
        b = (b.censored_observation(8.0, 0.5, "cp", pt.Censor.BLOQ)
             .censored_observation(0.25, 9.0, "cp", pt.Censor.ALOQ))
        subjects.append(b.build())
    sp = np.column_stack([rng.uniform(0.5, 2.0, S), rng.uniform(0.3, 1.2, S),
                          rng.uniform(8, 14, S), rng.uniform(0.05, 0.3, S)])
    return pt.Data(subjects), sp


def sde_plan_for(model, data, support, ems, dtype):
    from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedSdePsiPlan(model, grid, support, lowered, torch.device("cuda"), dtype)


def run_sde_kernel(plan, plain: bool = False) -> torch.Tensor:
    from pharmsol_tpu_torch.ops.fused_sde import psi_sde, psi_sde_plain

    fn = psi_sde_plain if plain else psi_sde
    return fn(*plan.streams, plan.support, plan.gen, **plan.kernel_kwargs())


def dedupe_targets(named) -> list:
    """(name, target) pairs, the first of each library path."""
    seen, out = set(), []
    for name, target in named:
        if target.path not in seen:
            seen.add(target.path)
            out.append((name, target))
    return out


def sde_build_targets(pt):
    """The SDE library of each model this script runs."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_sde

    out = []
    for name, model, n_params in (("readme", readme_sde(pt), 3),
                                  ("two_inputs", two_input_sde(pt), 4)):
        spec = model.spec
        gen = generate_sde(spec.drift, spec.diffusion, spec.nstates, n_params, spec.ninput)
        out.append((name, _build.generated_target(_build.SDE, gen)))
    return out


def event_ms(fn):
    """(result, ms) of one call, timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sde_compare(label, got, twin, tol, share, phase: int = 5):
    """Kernel vs twin cell by cell: the share within ``tol`` relative and the
    same non-finite cells. Returns (max abs err over finite cells, max rel)."""
    got, twin = got.double(), twin.double()
    fin_g, fin_t = torch.isfinite(got), torch.isfinite(twin)
    if not bool((fin_g == fin_t).all()):
        raise AssertionError(f"{label}: kernel and twin non-finite in different cells")
    rel = ((got - twin).abs() / twin.abs().clamp(min=1.0))[fin_t]
    within = float((rel <= tol).double().mean()) if rel.numel() else 1.0
    rest = int((rel > tol).sum())
    abs_err = float((got - twin)[fin_t].abs().max()) if rel.numel() else 0.0
    log(f"[{phase}] {label}: {within * 100:.2f}% of {got.numel()} cells within {tol:g} relative "
        f"(>= {share * 100:g}%), {rest} beyond, max rel {float(rel.max()):.3e}, "
        f"max abs {abs_err:.3e}, {int((~fin_t).sum())} non-finite in both")
    if within < share:
        raise AssertionError(f"{label}: {within} of cells within {tol} < {share}")
    return abs_err, float(rel.max())


def phase_sde_kernels(pt, rng) -> dict:
    """K3a against its twin on the card at the reduced ragged shape and, for
    the README model, the first three observations (to 4 h), its Philox
    words against ops/philox.py, and the times of both."""
    from pharmsol_tpu_torch.ops import fused_sde, philox
    from pharmsol_tpu_torch.ops.fused_sde import psi_sde_plain
    from pharmsol_tpu_torch.utils.f32_budget import f32_error

    R, S = SDE_REDUCED
    out = {}
    ems = readme_ems(pt)
    data = readme_data(pt, R, rng, n_obs=SDE_REDUCED_OBS)
    model = readme_sde(pt)
    # the kernel's own Philox words
    gen = sde_plan_for(model, data, readme_support(2, rng), ems, torch.float64).gen
    ctr = torch.as_tensor(rng.randint(0, 2 ** 32, (1 << 16, 4), dtype=np.int64), device="cuda")
    ctr[0] = 0
    ctr[1] = 2 ** 32 - 1
    for seed in (0, 42, (1 << 40) + 7):
        got = fused_sde.philox_words(ctr, seed, gen)
        want = torch.stack(philox.philox4x32(*ctr.unbind(1), philox.seed_key(seed)), 1)
        if not bool((got == want).all()):
            raise AssertionError(f"Philox words differ from the twin's (seed {seed})")
    kat = " ".join(f"{int(v):08x}" for v in fused_sde.philox_words(ctr[:1], 0, gen)[0])
    log(f"[5] K3a Philox4x32-10: 65536 counters x 3 keys equal to ops/philox.py; "
        f"counter 0 key 0 -> {kat}")

    # 1. zero diffusion
    sp0 = readme_support(S, rng, sigma=0.0)
    plan64 = sde_plan_for(model, data, sp0, ems, torch.float64)
    plan32 = sde_plan_for(model, data, sp0, ems, torch.float32)
    got64, twin64 = run_sde_kernel(plan64), run_sde_kernel(plan64, plain=True)
    got32 = run_sde_kernel(plan32)
    torch.cuda.synchronize()
    sde_compare(f"K3a readme sigma_ke=0 {R}x{S}x{SDE_PARTICLES} f64 vs twin", got64, twin64,
                1e-10, 1.0)
    log(f"[5] K3a readme sigma_ke=0 f32 kernel vs f64 twin: "
        f"{f32_error(got32.cpu().numpy(), twin64.cpu().numpy()):.3e} (measured, no budget row)")

    # 2. the README model as it is, em_control='independent'
    sp = readme_support(S, rng)
    for dtype, tol, share in ((torch.float64, 1e-9, 0.999), (torch.float32, 1e-4, 0.99)):
        plan = sde_plan_for(model, data, sp, ems, dtype)
        d = str(dtype)[6:]
        got, k_ms = event_ms(lambda: run_sde_kernel(plan))
        counts = {}
        kw = plan.kernel_kwargs()
        twin, t_ms = event_ms(lambda: psi_sde_plain(*plan.streams, plan.support, plan.gen,
                                                    counts=counts, **kw))
        abs_err, _ = sde_compare(f"K3a readme {R}x{S}x{SDE_PARTICLES} {d} vs twin (same Philox)",
                                 got, twin, tol, share)
        k_ms = cuda_ms(lambda: run_sde_kernel(plan), 3, 1)
        nbytes = plan_bytes(plan, kw, R, S)
        b = sde_bounds(nbytes, counts["trials"] * SDE_PARTICLES, model, dtype, False)
        log(f"[5] K3a readme {R}x{S}x{SDE_PARTICLES} {d} bound {b['bound']:.5g} ms by "
            f"{b['bound_by']} ({nbytes / 1e6:.3f} MB, {counts['trials']} cell trials, "
            f"{b['ops'] / 1e9:.3f} G floating-point and {b['int_ops'] / 1e9:.3f} G integer "
            f"operations; floating point alone {b['bound_float']:.5g} ms); kernel at "
            f"{b['bound'] / k_ms:.4f} of it ({b['bound_float'] / k_ms:.4f} of the float bound)")
        out[dtype] = dict(kernel=k_ms, twin=t_ms, abs_err=abs_err, bound=b["bound"],
                          bound_by=b["bound_by"], bound_float=b["bound_float"])
        general = ""
        if dtype == torch.float64:
            pt.set_float_dtype(dtype)
            _, out[dtype]["general"] = event_ms(lambda: pt.log_likelihood_matrix(
                model, data, sp, ems, device="cuda", engine="general"))
            general = f", general engine {out[dtype]['general']:.3f} ms"
        log(f"[5] K3a readme {R}x{S}x{SDE_PARTICLES} {d}: kernel {k_ms:.3f} ms, "
            f"twin {t_ms:.3f} ms{general}")

    # 3. two inputs, inject-to-destination, BLOQ + ALOQ, em_control='coupled'
    model2 = two_input_sde(pt)
    data2, sp2 = two_input_case(pt, R, S, rng)
    ems2 = readme_ems(pt)
    plan = sde_plan_for(model2, data2, sp2, ems2, torch.float64)
    if plan.dose_states != (1, 1) or plan.streams[6] is None or plan.em_control != "coupled":
        raise AssertionError(f"two-input plan: dose states {plan.dose_states}")
    got, twin = run_sde_kernel(plan), run_sde_kernel(plan, plain=True)
    sde_compare(f"K3a two inputs+censoring+coupled {R}x{S}x{SDE_PARTICLES} f64 vs twin",
                got, twin, 1e-9, 0.999)
    return out


def phase_sde_statistical(pt, rng) -> float:
    """K3a against the general engine (independent generators): the mean
    per-cell psi difference within 4 standard errors of zero."""
    R, S = SDE_STAT
    pt.set_float_dtype(torch.float64)
    ems = readme_ems(pt)
    data = readme_data(pt, R, rng, n_obs=SDE_STAT_OBS)
    sp = readme_support(S, rng)
    model = readme_sde(pt).with_noise("independent")
    fused = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda", engine="fused")
    general, g_ms = event_ms(lambda: pt.log_likelihood_matrix(
        model, data, sp, ems, device="cuda", engine="general"))
    d = (fused - general).double().flatten()
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("statistical check: non-finite cells")
    mean, se = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
    log(f"[5] K3a vs general engine {R}x{S}x{SDE_PARTICLES} f64, the first {SDE_STAT_OBS} "
        f"observations: mean diff {mean:.4f}, "
        f"standard error {se:.4f} (|mean| <= 4 SE), psi means {float(fused.mean()):.4f} / "
        f"{float(general.mean()):.4f}; general engine {g_ms:.3f} ms")
    if abs(mean) > 4.0 * se:
        raise AssertionError(f"statistical check: mean {mean} beyond 4 SE {se}")
    return g_ms


def phase_sde_cross_family(pt, rng) -> None:
    """At zero diffusion the README model is the 1-cmt IV model with
    ke = ke0: the fused SDE psi against the closed form on the same data."""
    R, S = SDE_REDUCED
    pt.set_float_dtype(torch.float64)
    state = rng.get_state()
    data = readme_data(pt, R, rng)
    rng.set_state(state)
    plain = readme_data(pt, R, rng, labels=(0, 0))
    sp = readme_support(S, rng, sigma=0.0)
    model = readme_sde(pt)
    sde = pt.log_likelihood_matrix(model, data, sp, readme_ems(pt), device="cuda")
    if pt.last_engine_decision(model)["engine"] != "fused":
        raise AssertionError(f"cross-family: {pt.last_engine_decision(model)}")
    closed = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                           nstates=1, ndrugs=1, nout=1)
    cf = pt.log_likelihood_matrix(closed, plain, sp[:, :2].copy(), readme_ems(pt, 0),
                                  device="cuda")
    torch.cuda.synchronize()
    err = rel_err(sde, cf, 1.0)
    log(f"[5] cross-family: README SDE at sigma_ke=0 (fused) vs 1-cmt IV closed form "
        f"{R}x{S} f64 rel {err:.3e} (<= 5e-2, EM at rtol = atol = 1e-2)")
    if not (err <= 5e-2):
        raise AssertionError(f"SDE vs closed form {err} > 5e-2")


def phase_sde_slice(pt, rng):
    """The README model at full width through the public entry point."""
    from pharmsol_tpu_torch.ops import fused_sde

    R, S = SDE_FULL
    label = f"readme_sde_{R}x{S}x{SDE_PARTICLES}"
    ems = readme_ems(pt)
    t0 = time.perf_counter()
    # from a seed of its own, so that phase 7's twin can rebuild it in a worker
    # process; the shared generator takes the draws it took before
    data = readme_data(pt, R, np.random.RandomState(SEED + 6))
    t_build = time.perf_counter() - t0
    rng.randn(R, 4)
    model = readme_sde(pt)
    # two calls per dtype since phase 28's cut (were three; the third support
    # is still drawn, so later phases draw what they drew)
    supports = [readme_support(S, rng) for _ in range(3)][:SDE_CELL_CALLS]
    # the main path's run: every launch counted here is one of its calls
    fused_sde.LAUNCHES = 0
    calls = 0
    t_calls = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = fused_sde.LAUNCHES
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            calls += 1
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            if fused_sde.LAUNCHES - before != 1:
                raise AssertionError(f"{label}: {fused_sde.LAUNCHES - before} launches in one call")
            if tuple(psi.shape) != (R, S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            if bool(torch.isnan(psi).any()):
                raise AssertionError(f"{label}: NaN psi")
            log(f"[6] {label} {str(dtype)[6:]}: psi mean {float(psi.double().mean()):.6f}, "
                f"{int(torch.isfinite(psi).sum())} finite of {psi.numel()}")
    launches = fused_sde.LAUNCHES
    t_calls = time.perf_counter() - t_calls
    log(f"[6] SDE main path: {calls} log_likelihood_matrix calls on cuda, engine fused, "
        f"{launches} K3a launches (subject builder {t_build * 1e3:.1f} ms)")
    log(f"[6] cut: the calls took {t_calls:.1f} s, {SDE_CELL_CALLS} per dtype (before the cut, "
        f"3: {BEFORE_CUTS_S['sde_cell_calls']} s): "
        f"{BEFORE_CUTS_S['sde_cell_calls'] - t_calls:.1f} s saved")
    return label, model, data, launches


def phase_sde_times(pt, label, model, data, card: str) -> dict:
    """K3a alone at full width and one end-to-end call with its steps."""
    R, S = SDE_FULL
    ems = readme_ems(pt)
    sp = readme_support(S, np.random.RandomState(SEED + 5))
    cells = R * S
    out = {}
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        plan = sde_plan_for(model, data, sp, ems, dtype)
        # one run (1.8-3.3 s), the kernel warm from phase 6
        kernel = cuda_ms(lambda: run_sde_kernel(plan), 1, 0)
        e2e = wall_ms(lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda"), 1, 0)
        psi_rows = run_sde_kernel(plan)
        parts = {
            "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 3),
            "plan": wall_ms(lambda: sde_plan_for(model, data, sp, ems, dtype), 3),
            "finalize": cuda_ms(lambda: plan.finalize(psi_rows), 10),
        }
        log(f"[7] {label} {d} kernel {kernel:10.3f} ms  {cells / (kernel * 1e-3):.4g} cells/s  ({card})")
        log(f"[7] {label} {d} end_to_end {e2e:10.3f} ms; parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items())
            + f"; kernel share {kernel / e2e:.4f} ({card})")
        out[dtype] = dict(kernel=kernel, end_to_end=e2e)
    return out


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

_ARITH = {"add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
          "div", "neg", "pow", "rpow", "exp", "log", "log1p", "sqrt", "acos", "cos",
          "clamp", "minimum", "maximum", "abs"}


class OpCount(torch.overrides.TorchFunctionMode):
    """Counts the elementwise floating-point operations of the torch code run
    under it (one per output element; a transcendental counts as one)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "").strip("_") in _ARITH and isinstance(out, torch.Tensor):
            self.n += out.numel()
        return out


def count_ops(fn, *args) -> int:
    with OpCount() as c:
        fn(*args)
    return c.n


def bound(nbytes: float, ops: float, dtype, int_ops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the largest of bytes over the memory rate,
    floating-point operations over the arithmetic rate of ``dtype`` and
    integer operations over the INT32 rate (the pipes run side by side)."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(ops / H100_OPS_PER_S[dtype], int_ops / H100_INT_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def feature_tensors(features):
    """The tensors among a closed-form plan's feature inputs (a lag or fa
    argument may be a list of planes; slot tables are host tuples)."""
    for v in features.values():
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, list):
            yield from v


def psi_work(plan, counts=None) -> tuple:
    """(bytes, operations) of one K1a, K1b or K1c call on ``plan``'s inputs:
    each input read once and psi written once; the operations this data
    needs (each support prepared once, or once per row, per spanned segment
    or per change of chain level as the mode asks; one propagate per spanned
    segment and per lagged dose that fires; per observation and cell the
    prediction and ``-z^2 / 2``, and per observation and row, once, its
    ``-log(2 pi) / 2 - log sigma`` and ``1 / sigma``), counted on the twin's
    own functions. K1c's in-kernel chain (``seg_evcode``) and its split
    marches are counted by the twin (``counts`` of ``psi_analytical_plain``:
    prepares, propagates, fires; in levels mode one prepare per level and
    support)."""
    from pharmsol_tpu_torch.ops.fused_psi import STRUCTURES, n_micro

    sdef = STRUCTURES[plan.structure]
    NS, NP = sdef["n_states"], sdef["n_params"]
    R, M, S = plan.R, plan.M, plan.S
    f = plan.features
    item = plan.support.element_size()
    slots = [t for t in (f.get("lag_slots"), f.get("fa_slots")) if t is not None]
    nbytes = (tensor_bytes(*plan.streams, plan.outeq, plan.out_coef, plan.out_bias,
                           *feature_tensors(f)) + (NP + R) * S * item  # params, psi
              + 4 * sum(len(t) for t in slots))
    one = lambda v: torch.full((1, 1), float(v), dtype=torch.float64)  # noqa: E731

    def prep(micro):
        rows = [one(0.2 + 0.1 * i) for i in range(n_micro(sdef) if micro else NP)]
        if not micro and sdef["remap"] is not None:
            rows = sdef["remap"](rows)
        if sdef["eigs"] is not None:
            rows = rows + sdef["eigs"](rows)
        return rows

    prep_ops = count_ops(lambda: sdef["prepare"](prep(f["param_levels"] is not None
                                                      or f["param_planes"] is not None)))
    aux = sdef["prepare"](prep(False))
    xs = [one(1.0)] * NS
    prop = {r: count_ops(sdef["propagate"], aux, xs, one(0.5), one(1.0) if r else None)
            for r in (False, True)}
    seg_dt = plan.streams[0].double().cpu()
    live = seg_dt > 0
    rate = plan.streams[2]
    with_rate = live & (rate.double().cpu() != 0) if rate is not None else torch.zeros_like(live)
    n_obs = int((plan.streams[3].double().cpu() > 0).sum())
    ops = (S * (int(with_rate.sum()) * prop[True] + int((live & ~with_rate).sum()) * prop[False]
                + n_obs * (2 * NS + 5)) + n_obs * 4)
    mode = plan.mode
    k1c_chain = f.get("seg_evcode") is not None or f.get("seg_postdepth") is not None
    if k1c_chain:
        # the twin's tally: level changes and the second part of each split
        # march, priced with the infusion forcing where its segment has one
        with_rate = counts["fires_with_rate"]
        return nbytes, (ops + counts["prepares"] * prep_ops + with_rate * prop[True]
                        + (counts["fires"] - with_rate) * prop[False])
    if mode is None:
        ops += S * prep_ops
    elif mode == "row":
        ops += R * S * (prep_ops + 2 * NP)
    elif mode == "segment":
        ops += int(live.sum()) * S * (prep_ops + 2 * NP)
    elif mode == "levels":
        ops += f["param_levels"].shape[0] * S * prep_ops
    else:
        # planes: one prepare per (row, support) cell and change of depth
        depth = f["seg_depth"].double().cpu()
        prev = torch.zeros(R, dtype=torch.float64)
        changes = 0
        for m in range(M):
            ch = live[:, m] & (depth[:, m] != prev)
            changes += int(ch.sum())
            prev = torch.where(live[:, m], depth[:, m], prev)
        ops += changes * S * prep_ops
    if f["lag_plane"] is not None:
        # a dose fires iff its lag ends before the row's last breakpoint;
        # with slot tables each dose column has its own plane
        t_end = seg_dt.sum(1)
        t_dose = torch.cumsum(seg_dt, 1) - seg_dt  # from the row's first breakpoint
        planes = f["lag_plane"] if isinstance(f["lag_plane"], list) else [f["lag_plane"]]
        lag_slots = f.get("lag_slots") or (0,) * M
        dosed = plan.streams[1].double().cpu() != 0
        fires = sum(int((dosed[:, m, None] & (planes[lag_slots[m]].double().cpu()
                                              < (t_end - t_dose[:, m])[:, None])).sum())
                    for m in range(M) if lag_slots[m] >= 0)
        ops += fires * (prop[False] + NS)
    return nbytes, ops


def plan_bytes(plan, kwargs, R: int, S: int) -> int:
    """Bytes of an ODE or SDE plan's inputs read once and psi written once
    (K2e's covariate streams among them)."""
    def tensors(v):
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, dict):
            for w in v.values():
                yield from tensors(w)
        elif isinstance(v, (tuple, list)):
            for w in v:
                yield from tensors(w)

    return (tensor_bytes(*plan.streams, plan.support, *tensors(list(kwargs.values())))
            + R * S * plan.support.element_size())


def ode_step_ops(model) -> int:
    """Operations of one attempted step of the 7-stage FSAL explicit RK
    (dopri5, tsit5) per cell: six right-hand sides (counted on the model's
    closure) and the stage, solution and error sums (about 80 per state)."""
    n, nin = model.nstates(), model.ndrugs()
    one = torch.ones
    rhs = count_ops(model._diffeq, one(n, dtype=torch.float64), one(8, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64), torch.zeros(nin, dtype=torch.float64),
                    torch.zeros(nin, dtype=torch.float64),
                    lambda name, t=None: torch.tensor(50.0, dtype=torch.float64))
    return 6 * rhs + 80 * n


def sde_trial_ops(model, cov_names=()) -> int:
    """Operations of one Euler-Maruyama trial per particle: two drift
    evaluations (counted on the model's closure, its covariate reads a
    number each), the full and two half steps and the error (about 18 per
    state) and the Box-Muller normals (about 6 each, three per state);
    Philox's integer work is not counted."""
    from pharmsol_tpu_torch.ops.rhs_codegen import LaneCov

    spec = model.spec
    n, nin = spec.nstates, spec.ninput
    cov = LaneCov({name: torch.tensor(1.0, dtype=torch.float64) for name in cov_names})
    drift = count_ops(spec.drift, torch.ones(n, dtype=torch.float64),
                      torch.ones(8, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64),
                      torch.zeros(nin, dtype=torch.float64), cov)
    return 2 * drift + (18 + 3 * 6) * n


def sde_trial_int_ops(n_states: int, dtype, coupled: bool) -> int:
    """Integer operations of one Euler-Maruyama trial per particle: the
    Philox4x32-10 calls (2 or 3 draw slots x one call per group of 4 float32
    or 2 float64 normals), 10 rounds each, and per round the two 32 x 32 ->
    64-bit multiplies and the two 3-input XORs (the round keys are computed
    once a launch). The resampling uniforms, one call per particle and
    observation, are left out."""
    per_call = 4 if dtype == torch.float32 else 2
    groups = -(-n_states // per_call)
    return (2 if coupled else 3) * groups * 10 * 4


def sde_bounds(nbytes: float, particle_trials: float, model, dtype, coupled: bool,
               cov_names=()) -> dict:
    """The SDE kernels' bound on this data, recounted with Philox's integer
    work (``bound``), and the earlier count, floating-point operations only
    (``bound_float``), so that the rows stay comparable."""
    ops = particle_trials * sde_trial_ops(model, cov_names)
    int_ops = particle_trials * sde_trial_int_ops(model.spec.nstates, dtype, coupled)
    new, old = bound(nbytes, ops, dtype, int_ops), bound(nbytes, ops, dtype)
    return dict(bound=new[0], bound_by=new[1], bound_float=old[0], ops=ops, int_ops=int_ops)


def resident_blocks(regs: int, shared: int, threads: int = 256) -> int:
    """Blocks of ``threads`` threads that one SM holds at once, from a
    kernel's registers per thread and shared memory per block (the occupancy
    rules of compute capability 9.0)."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // H100_REG_UNIT) * H100_REG_UNIT
    by_regs = (H100_SM_REGS // per_warp) // warps
    by_shared = H100_SM_SHARED // (-(-shared // 128) * 128 + 1024)
    return min(by_regs, by_shared, H100_SM_THREADS // threads, H100_SM_BLOCKS)


# the classes of the trial loop's static instruction mix, by SASS mnemonic
_SASS_CLASSES = {
    "integer": {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "IMNMX",
                "VIMNMX", "VIADD", "VIADDMNMX", "LEA", "IABS", "POPC", "FLO", "BMSK", "BREV",
                "PRMT", "SGXT", "IDP", "IMUL"},
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK", "FSET", "FSWZADD"},
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP"},
    "sfu_conversion": {"MUFU", "I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND", "I2I", "F2FP"},
    "barrier": {"BAR", "SYNCS", "MEMBAR"},
    "shared_shuffle": {"SHFL", "LDS", "STS", "ATOMS"},
    "memory": {"LDG", "STG", "LDL", "STL", "LD", "ST", "LDC"},
    "move_predicate": {"MOV", "SEL", "P2R", "R2P", "PLOP3", "CS2R", "S2R", "S2UR", "R2UR",
                       "VOTE"},
    "control": {"BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC", "YIELD", "JMP",
                "BREAK", "NANOSLEEP"},
}
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in _SASS_CLASSES.items():
        if base in ops:
            return name
    return "uniform" if base.startswith("U") else "other"


def sass_functions(lib: Path) -> dict:
    """{mangled name: ([(address, mnemonic, operands), ...], {label:
    address})} of every kernel in ``lib`` (``cuobjdump -sass``)."""
    from pharmsol_tpu_torch.ops import _build

    tool = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, insns, labels, pending = {}, None, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            insns, labels, pending = [], {}, []
            out[m.group(1)] = (insns, labels)
            continue
        if insns is None:
            continue
        lab = _SASS_LABEL.match(ln)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _SASS_INSN.search(ln)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    return out


def _branch_target(args: str, labels: dict):
    m = re.search(r"0x([0-9a-f]+)\s*$", args.strip()) or re.search(r"(\.L_x_\d+)", args)
    if m is None:
        return None
    return labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)


def trial_loop_mix(insns, labels=None, ppt: int = 4) -> dict:
    """The static instruction mix of the Euler-Maruyama trial loop: the
    smallest loop (a backward branch and its target) that holds a block
    barrier and the wide multiplies of at least two Philox calls per
    particle (a slow path of a transcendental that branches back into the
    loop holds a few). ``{"all": {class: count, "total": n}, "hot": ...,
    "loop_bytes": span}``: "all" counts every instruction laid out in the
    loop; "hot" leaves out the cold paths inlined in it, each the span that
    the nearest forward branch skips around an inner loop (the large-argument
    reduction of a sine or cosine, which these arguments, in [0, 2 pi],
    never take). None where no such loop is found."""
    labels = labels or {}
    branches = [(addr, _branch_target(args, labels)) for addr, op, args in insns
                if op.startswith("BRA")]
    branches = [(a, t) for a, t in branches if t is not None]
    loops = sorted((a - t, t, a) for a, t in branches if t < a)
    for _, lo, hi in loops:
        body = [(a, op) for a, op, _ in insns if lo <= a <= hi]
        wide = sum(op.startswith(("IMAD.WIDE", "IMAD.HI")) for _, op in body)
        if not (any(sass_class(op) == "barrier" for _, op in body) and wide >= 2 * 10 * 2 * ppt):
            continue
        cold = []
        for _, t, a in loops:
            inner = [op for b, op in body if t <= b <= a]
            if lo < t and a < hi and not any(sass_class(op) == "barrier" for op in inner):
                skips = [(tt - b, b, tt) for b, tt in branches if b < t and tt > a and b >= lo]
                if skips:
                    cold.append(min(skips)[1:])
        out = {"loop_bytes": hi - lo + 16}
        for part, keep in (("all", lambda a: True),
                           ("hot", lambda a: not any(b < a < e for b, e in cold))):
            mix = {}
            for a, op in body:
                if keep(a) and not op.startswith("NOP"):
                    mix[sass_class(op)] = mix.get(sass_class(op), 0) + 1
            mix["total"] = sum(mix.values())
            out[part] = mix
        return out
    return None


_KERNEL_NAMES = (
    # the closed-form tiers of one kernel body (int TIER); before that, K1a's
    # own kernel and K1b/K1c's (bool K1C)
    (r"fused_psi_feature_kernelI([fd])Li(\d+)ELi([012])E", "K1a", "K1b", "K1c"),
    (r"fused_psi_kernelI([fd])Li(\d+)E()", "K1a"),
    (r"fused_psi_feature_kernelI([fd])Li(\d+)E(?:Lb([01])E)?", "K1b", "K1c"),
    (r"fused_sde_kernelI([fd])Li(\d+)E(?:Lb([01])E)?", "K3a", "K3b"),
)


def kernel_key(name: str):
    """"K3a f64 4" for a mangled kernel name (the int is the kernel's
    structure code or particles per thread; the instantiation without a
    tier flag is the base tier's, as before the flag was added), or None."""
    for pattern, *ids in _KERNEL_NAMES:
        m = re.search(pattern, name)
        if m:
            return f"{ids[int(m.group(3) or 0)]} f{'32' if m.group(1) == 'f' else '64'} {m.group(2)}"
    return None


def kernel_registers(lib: Path) -> dict:
    """{"K3a f64 4": registers, ...} of every kernel in ``lib``."""
    return {kernel_key(name): r["reg"] for name, r in kernel_resources(lib).items()
            if kernel_key(name) is not None}


def kernel_resources(lib: Path) -> dict:
    """{mangled name: {"regs", "shared", "local", "stack"}} of every kernel
    in ``lib`` (``cuobjdump -res-usage``)."""
    from pharmsol_tpu_torch.ops import _build

    tool = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for name, rest in re.findall(r"Function (\S+):\s*(.*)", text):
        vals = dict(re.findall(r"(REG|SHARED|LOCAL|STACK):(\d+)", rest))
        out[name] = {k.lower(): int(v) for k, v in vals.items()}
    return out  # keys reg, shared, local, stack


_ODE_KERNEL = re.compile(r"fused_ode_(?:implicit_|explicit_)?kernelI([fd])Li(\d+)ELb([01])E(?:Li(\d+)E)?")
_ODE_SOLVER_NAMES = {0: "dopri5", 1: "tsit5", 2: "expm", 3: "trbdf2", 4: "kvaerno3",
                     5: "kvaerno5", 6: "bdf"}


def ode_kernel_key(name: str):
    """"K2c bdf f64 features cap 3" for a mangled ODE kernel name (the
    persistent-grid kernel of the implicit tiers carries the BDF tier's
    largest order as a template argument), or None."""
    m = _ODE_KERNEL.search(name)
    if m is None:
        return None
    code, feat = int(m.group(2)), m.group(3) == "1"
    kid = ("K2e" if feat else "K2a") if code < 2 else {2: "K2d", 6: "K2c"}.get(code, "K2b")
    key = f"{kid} {_ODE_SOLVER_NAMES[code]} f{'32' if m.group(1) == 'f' else '64'}"
    return key + (" features" if feat else "") + (f" cap {m.group(4)}" if code == 6 and m.group(4)
                                                  else "")


def ode_trial_mix(insns, labels=None) -> dict:
    """The static instruction mix of one explicit Runge-Kutta trial in an ODE
    kernel's SASS. In a lane loop (a warp vote in the kernel: the persistent
    grid rejoins its warp in every pass) it is the smallest loop holding the
    last vote, one pass: a trial and the boundary code a pass may take (a
    call's end, the next call's start, a cell's end), laid out together. In
    the per-row kernel it is the trial loop: of the loops that hold a square
    root (``MUFU.RSQ*``, the error norm's) and no smaller such loop, the one
    with the most square roots (a dose loop holds the RHS's own twice; a
    trial six times and the norm's). ``{"trial": {class: n, "total": n},
    "lane_pass": whether it is a lane loop's pass, "calls": the CALL sites in it
    (the slow paths of division, pow and the other software routines),
    "mufu": {op: n} in it}``; None where no such loop is found. Both sides
    of a branch count: an upper estimate."""
    labels = labels or {}
    branches = [(addr, _branch_target(args, labels)) for addr, op, args in insns
                if op.startswith("BRA")]
    loops = sorted((a - t, t, a) for a, t in branches if t is not None and t < a)

    def body(lo, hi):
        return [op for a, op, _ in insns if lo <= a <= hi]

    def rsq(lo, hi):
        return sum(op.startswith("MUFU.RSQ") for op in body(lo, hi))

    votes = [a for a, op, _ in insns if op.startswith("VOTE")]
    if votes:
        span = next(((lo, hi) for _, lo, hi in loops if lo <= votes[-1] <= hi), None)
    else:
        inner = [(lo, hi) for _, lo, hi in loops if rsq(lo, hi) and not any(
            lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) and rsq(l2, h2) for _, l2, h2 in loops)]
        span = max(inner, key=lambda lh: (rsq(*lh), -(lh[1] - lh[0]))) if inner else None
    if span is None:
        return None
    ops = [op for op in body(*span) if not op.startswith("NOP")]
    mix, mufu = {}, {}
    for op in ops:
        mix[sass_class(op)] = mix.get(sass_class(op), 0) + 1
        if op.startswith("MUFU"):
            mufu[op] = mufu.get(op, 0) + 1
    mix["total"] = len(ops)
    return dict(trial=mix, calls=sum(op.startswith("CALL") for op in ops), mufu=mufu,
                loop_bytes=span[1] - span[0] + 16, lane_pass=bool(votes))


def ode_anatomy(lib: Path) -> dict:
    """Per kernel of an ODE library (``ode_kernel_key``): registers, stack
    frame and local memory (``cuobjdump -res-usage``), the local loads and
    stores in its SASS (``LDL``, ``STL``; a static count), resident blocks
    per SM: from the library's occupancy query where it has one (the
    persistent grids of the implicit tiers and, since the explicit tier's
    redesign, of K2a and K2e: ``blocks_per_sm_runtime``), and from the
    registers at the block the library launches (128 threads for those
    grids, 256 for the per-row kernel's ``dim3(128, 2)``); for K2a and K2e
    the static mix of one trial (``ode_trial_mix``)."""
    from pharmsol_tpu_torch.ops import fused_ode

    sass = sass_functions(lib)
    # a parent checkout's package may have neither query nor grid
    queries = {kind: (getattr(fused_ode, f"{kind}_occupancy_of", None) or (lambda _: None))(lib)
               for kind in ("implicit", "explicit")}
    out = {}
    for name, r in kernel_resources(lib).items():
        key = ode_kernel_key(name)
        if key is None:
            continue
        insns, labels = sass.get(name, ([], {}))
        ops = [op for _, op, _ in insns]
        kind = ("implicit" if "implicit_kernel" in name else
                "explicit" if "explicit_kernel" in name else None)
        threads = (getattr(fused_ode, f"{kind.upper()}_THREADS", 128) if kind else 256)
        a = dict(regs=r.get("reg"), stack=r.get("stack", 0), local=r.get("local", 0),
                 ldl=sum(op.startswith("LDL") for op in ops),
                 stl=sum(op.startswith("STL") for op in ops), threads=threads,
                 blocks_per_sm=resident_blocks(r.get("reg", 255), r.get("shared", 0), threads))
        m = _ODE_KERNEL.search(name)
        if kind == "implicit" and queries["implicit"] is not None:
            a["blocks_per_sm_runtime"] = queries["implicit"](
                m.group(1) == "d", m.group(3) == "1", int(m.group(4) or 3))
        if kind == "explicit" and queries["explicit"] is not None:
            a["blocks_per_sm_runtime"] = queries["explicit"](
                m.group(1) == "d", m.group(3) == "1", int(m.group(2)))
        if key.startswith(("K2a", "K2e")):
            a["trial_mix"] = ode_trial_mix(insns, labels)
        out[key] = a
    return out


def describe_anatomy(a: dict) -> str:
    blocks = a.get("blocks_per_sm_runtime", a["blocks_per_sm"])
    text = (f"{a['regs']} registers, {a['stack']}-byte stack frame, {a['local']} bytes local, "
            f"{a['ldl']} LDL / {a['stl']} STL in its SASS, "
            f"{blocks} resident blocks of {a['threads']} per SM "
            f"({blocks * a['threads'] // 32} warps; {a['blocks_per_sm']} from the registers"
            + (", the runtime's query agrees" if a.get("blocks_per_sm_runtime")
               == a["blocks_per_sm"] else
               "" if "blocks_per_sm_runtime" not in a else ", the runtime's query differs")
            + ")")
    mix = a.get("trial_mix")
    if mix:
        text += ("; one trial's static SASS (upper estimate): " + ", ".join(
            f"{k} {v}" for k, v in sorted(mix["trial"].items()))
            + f"; CALL sites {mix['calls']}; MUFU " + (", ".join(
                f"{k} {v}" for k, v in sorted(mix["mufu"].items())) or "none")
            + ("; a pass of the lane loop: the trial with the boundary code" if mix["lane_pass"]
               else ""))
    return text


def sde_anatomy(lib: Path, n_states: int, n_particles: int, ppt: int = 4) -> dict:
    """For the ``ppt`` particles-a-thread instantiations of the SDE kernels
    in ``lib``: registers, stack frame (which holds the spills), resident
    blocks per SM (from the registers and the static and dynamic shared
    memory), and the trial loop's static instruction mix per
    particle-trial."""
    sass = sass_functions(lib)
    out = {}
    for name, r in kernel_resources(lib).items():
        key = kernel_key(name) or ""
        if not (key.startswith("K3") and key.endswith(f" {ppt}")):
            continue
        item = 4 if " f32 " in key else 8
        shared = r.get("shared", 0) + (n_states + 1) * n_particles * item
        mix = trial_loop_mix(*sass.get(name, ([], {})), ppt=ppt)
        out[key] = dict(regs=r.get("reg"), stack=r.get("stack", 0),
                        blocks_per_sm=resident_blocks(r.get("reg", 255), shared),
                        loop=mix,
                        per_particle_trial=({k: v / ppt for k, v in mix["hot"].items()}
                                            if mix else None),
                        per_particle_trial_all=({k: v / ppt for k, v in mix["all"].items()}
                                                if mix else None))
    return out


def issue_share(loop_total: float, cell_trials: float, kernel_ms: float) -> float:
    """The trial loop's issued warp-instructions over the card's issue rate
    in the measured time: every warp of a cell's block runs the loop body
    once per trial (``loop_total``, the static count without the cold
    paths; a branch counts on both sides, so this is an upper estimate)."""
    return loop_total * 8 * cell_trials / (kernel_ms * 1e-3 * H100_WARP_ISSUE_PER_S)


# ---------------------------------------------------------------------------
# K1b at full width: covariates, seq, lag and fa through the entry point
# ---------------------------------------------------------------------------


def feature_workloads(pt, rng):
    """The two K1b cells: (label, model, data, centre, S, expected mode,
    budget row, rows of the general-engine check, builder s)."""
    out = []
    n_short, n_tv = FEATURE_SUBJECTS
    # Covariate Short: the Short regimen, each subject's weight constant;
    # allometric (wt/70)**0.75 on the rate constants (JAX
    # tests/test_pallas_psi.py:607-637), an absorption lag p[5] and a
    # bioavailability p[6]: K1b in row mode with lag and fa planes
    n = n_short
    wt = rng.uniform(40.0, 120.0, n)
    t0 = time.perf_counter()
    data = short_subjects(pt, n, rng, covariates=lambda i, b: b.covariate("wt", 0.0, wt[i]))
    t_build = time.perf_counter() - t0

    model = covariate_short_model(pt)
    # ka's centre is the Short cell's 1.2 doubled and more: the weight
    # scaling moves the decay constants per subject, and a support whose ka
    # meets one makes the closed form 0/0 (reachable in float32 among the
    # 8.4 M distinct pairs)
    out.append((f"cov_short_2cmt_oral_{n}x512", model, data,
                [0.15, 3.0, 0.3, 0.2, 10.0, 0.5, 0.8], 512, "row", "seq_multiplier_row",
                min(n, 2048), t_build))
    # time-varying creatinine clearance on the benches/population_10k.py
    # shape: knots at 0 h and 24 h, an affine effect on ke: K1b in segment
    # mode
    n = n_tv
    crcl0 = rng.uniform(40.0, 140.0, n)
    crcl24 = crcl0 * rng.uniform(0.7, 1.3, n)
    t0 = time.perf_counter()
    data = short_subjects(pt, n, rng, covariates=lambda i, b: b.covariate(
        "crcl", 0.0, crcl0[i]).covariate("crcl", 24.0, crcl24[i]))
    t_build = time.perf_counter() - t0
    model = pt.Analytical(
        pt.one_compartment_with_absorption,
        seq_eq=lambda p, t, cov: [p[0], p[1] * (0.4 + 0.006 * cov("crcl", t)), p[2]],
        out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    out.append((f"tv_crcl_1cmt_oral_{n}x1000", model, data, [1.2, 0.2, 30.0], 1000,
                "segment", "seq_multiplier_segment", n, t_build))
    return out


def phase_feature_slice(pt, rng, workload, ems) -> int:
    """One K1b cell through the public entry point: three calls in float32
    and three in float64 with fresh supports, each on the fused engine with
    exactly one K1b launch; then each held against the general engine on the
    card on its first ``rows`` subjects (float64 within 1e-8, float32 within
    1e-3 relative)."""
    from pharmsol_tpu_torch.ops import fused_psi

    label, model, data, centre, S, mode, _, rows, _ = workload
    supports = [jittered_support(centre, S, rng, 0.2) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_psi.LAUNCHES = 0
    fused_psi.FEATURE_LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = fused_psi.FEATURE_LAUNCHES
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            if fused_psi.FEATURE_LAUNCHES - before != 1:
                raise AssertionError(f"{label}: {fused_psi.FEATURE_LAUNCHES - before} "
                                     "K1b launches in one call")
            if tuple(psi.shape) != (len(data), S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            bad = int((~torch.isfinite(psi)).sum())
            if bad:
                raise AssertionError(f"{label} {dtype}: {bad} non-finite psi cells of "
                                     f"{psi.numel()}")
            results.append((dtype, sp, psi))
    launches, k1a = fused_psi.FEATURE_LAUNCHES, fused_psi.LAUNCHES
    log(f"[3] {label}: {len(results)} log_likelihood_matrix calls on cuda, engine "
        f"fused, {launches} K1b launches, {k1a} K1a launches")
    if k1a:
        raise AssertionError(f"{label}: the main path launched K1a")
    plan = plan_for(pt, model, data, supports[0], ems, torch.float64)
    if plan.mode != mode:
        raise AssertionError(f"{label}: plan mode {plan.mode}, expected {mode}")
    log(f"[3] {label}: K1b mode {plan.mode}, inputs "
        + ", ".join(k for k, v in plan.features.items() if v is not None))
    sub = pt.Data(data.subjects()[:rows])
    for dtype, sp, psi in results:
        pt.set_float_dtype(dtype)
        want = pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
        torch.cuda.synchronize()
        tol = 1e-8 if dtype == torch.float64 else 1e-3
        err = rel_err(psi[:rows], want, 1.0)
        log(f"[3] {label} {str(dtype)[6:]}: fused vs general on subjects 0-{rows - 1} "
            f"rel {err:.3e} (<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if err > tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return launches


def phase_feature_times(pt, workload, ems, card: str, kernel: str = "K1b",
                        phase: int = 4) -> dict:
    """K1b (or K1c) alone, its twin, the general engine (on the subjects of
    the check), one end-to-end call and its steps, at the cell's shape; the
    kernel held against its twin there; the bound of its work (K1c's chain
    counted by the twin)."""
    from pharmsol_tpu_torch.likelihood.matrix import _general_psi
    from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
    from pharmsol_tpu_torch.ops.fused_psi import psi_analytical_plain
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    label, model, data, centre, S, _, row, rows, t_build = workload
    sp = jittered_support(centre, S, np.random.RandomState(SEED + 4), 0.2)
    sub = pt.Data(data.subjects()[:rows])
    out = {}
    twin64 = None
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        plan = plan_for(pt, model, data, sp, ems, dtype)
        got, twin = run_kernel(plan), run_kernel(plan, plain=True)
        torch.cuda.synchronize()
        if dtype == torch.float64:
            twin64 = twin
            rel, tol = rel_err(got, twin, 1e-300), 1e-10
            vs64 = ""
        else:
            # against the float32 twin: the two round differently (fused
            # multiply-adds), and cells whose ka lies near a decay constant
            # amplify that through (e_k - e_ka) / (ka - l_k); so every cell
            # within 1e-3 and 99.9% within 1e-5 relative, and the float64
            # twin's distance measured beside the budget row of the mode's case
            rel, tol = rel_err(got, twin, 1.0), 1e-3
            cell = (got.double() - twin.double()).abs() / twin.double().abs().clamp(min=1.0)
            share = float((cell <= 1e-5).double().mean())
            if share < 0.999:
                raise AssertionError(f"{label} {dtype}: {share} of cells within 1e-5 < 0.999")
            vs64 = (f"; {share * 100:.4f}% of cells within 1e-5 (>= 99.9%); vs the f64 twin "
                    f"{f32_error(got.cpu().numpy(), twin64.cpu().numpy()):.3e} ({row} "
                    f"{F32_BUDGET[row]:g} on its own case)")
        abs_err = float((got.double() - twin64).abs().max())
        log(f"[{phase}] {kernel} vs twin {label} {d}: max abs {abs_err:.3e}, rel {rel:.3e} "
            f"(<= {tol:g}){vs64}")
        if rel > tol:
            raise AssertionError(f"{label} {dtype}: {kernel} vs twin {rel} > {tol}")
        sub_grid = model.lower(sub.subjects())
        lowered = ems.lower(model.resolve_output_label, model.nouteqs())
        t = {
            "kernel": cuda_ms(lambda: run_kernel(plan), 20),
            "twin": cuda_ms(lambda: run_kernel(plan, plain=True), 3, 1),
            "general": wall_ms(lambda: _general_psi(
                model, sub_grid, sp, lowered, torch.device("cuda"), dtype), 3),
            "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                model, data, sp, ems, device="cuda"), 7),
        }
        psi_rows = run_kernel(plan)
        grid = model.lower(data.subjects())
        full = ems.lower(model.resolve_output_label, model.nouteqs())

        def build_plan():  # the plan alone, the grid lowered already
            return _FusedPsiPlan(model, grid, sp, full, torch.device("cuda"), dtype)

        parts = {
            "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 5),
            "plan": wall_ms(build_plan, 5),
            "finalize": cuda_ms(lambda: plan.finalize(psi_rows), 10),
        }
        counts = {}
        run_twin_counted = lambda: psi_analytical_plain(  # noqa: E731
            *plan.streams, plan.support, counts=counts, **plan.kernel_kwargs())
        if kernel == "K1c":
            run_twin_counted()
        nbytes, ops = psi_work(plan, counts)
        t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
        # where the plan's host time goes: its costliest calls, once, in
        # float64
        if dtype == torch.float64:
            prof = cProfile.Profile()
            prof.runcall(build_plan)
            top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
            top = [(fn, st[3] * 1e3) for (path, _, fn), st in top
                   if "pharmsol_tpu_torch" in path and fn != "__init__"][:6]
            log(f"[{phase}] {label} {str(dtype)[6:]} plan, costliest calls (ms, cumulative, "
                f"profiled): " + ", ".join(f"{fn} {ms:.1f}" for fn, ms in top))
        cells = len(data) * S
        for k in ("kernel", "twin", "end_to_end"):
            log(f"[{phase}] {label} {d} {k:10s} {t[k]:10.3f} ms  {cells / (t[k] * 1e-3):.4g} "
                f"cells/s  ({card})")
        log(f"[{phase}] {label} {d} general    {t['general']:10.3f} ms on subjects 0-{rows - 1} "
            f"x {S}  ({card})")
        log(f"[{phase}] {label} {d} end_to_end parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        log(f"[{phase}] {label} {d} shares of end_to_end: kernel {t['kernel'] / t['end_to_end']:.4f}, "
            f"plan {parts['plan'] / t['end_to_end']:.4f}, lowering lookup "
            f"{parts['lower_cached'] / t['end_to_end']:.4f}, finalize "
            f"{parts['finalize'] / t['end_to_end']:.4f} ({card})")
        log(f"[{phase}] {label} {d} {kernel} bound {t['bound']:.5g} ms by {t['bound_by']} "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations); kernel at "
            f"{t['bound'] / t['kernel']:.3f} of it")
        t["abs_err"] = abs_err
        t["plan"] = parts["plan"]
        out[dtype] = t
    model._lower_cache.clear()
    t0 = time.perf_counter()
    model.lower(data.subjects())
    log(f"[{phase}] {label} host: subject builder {t_build * 1e3:.1f} ms, lowering "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({len(data)} subjects)")
    return out


# ---------------------------------------------------------------------------
# K2d: linear ODE models with expm, and the population fit
# ---------------------------------------------------------------------------


def expm_launch_counts():
    from pharmsol_tpu_torch.ops import fused_ode

    return (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES)


def phase_expm_kernels(pt, cases) -> None:
    """K2d against its twin on the card on every case of ``expm_cases``:
    float64 within 1e-10 relative, float32 against the float64 twin within
    the ``ode_expm`` budget row, the same non-finite cells in both (none but
    in the poisoned case, which must have some), every call one K2d launch
    and no K2a or K2e launch. Then the poisoned case through the entry
    point: -inf in the same cells on the fused and on the general engine."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    budget = F32_BUDGET["ode_expm"]
    for name, (model, data, support, ems) in cases.items():
        plan64 = ode_plan_for(model, data, support, ems, torch.float64)
        plan32 = ode_plan_for(model, data, support, ems, torch.float32)
        if plan64.merge_runs is not None or plan64.solver != "expm":
            raise AssertionError(f"K2d {name}: the plan merges runs or is not expm")
        twin64 = run_ode_kernel(plan64, plain=True)
        before = expm_launch_counts()
        got64 = run_ode_kernel(plan64)
        got32 = run_ode_kernel(plan32)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(expm_launch_counts(), before))
        if launches != (0, 0, 2):
            raise AssertionError(f"K2d {name}: (K2a, K2e, K2d) launches {launches}, not (0, 0, 2)")
        bad = ~torch.isfinite(twin64)
        if not (bool((~torch.isfinite(got64) == bad).all())
                and bool((~torch.isfinite(got32) == bad).all())):
            raise AssertionError(f"K2d {name}: kernel and twin non-finite in different cells")
        if bool(bad.any()) != (name == "poison"):
            raise AssertionError(f"K2d {name}: {int(bad.sum())} non-finite cells")
        ok = ~bad
        e64 = rel_err(got64[ok], twin64[ok], 1e-300)
        e32 = f32_error(got32[ok].cpu().numpy(), twin64[ok].cpu().numpy())
        log(f"[9] K2d {name:18s} {len(data)}x{support.shape[0]} n={plan64.n_states} f64 kernel "
            f"vs twin rel {e64:.3e} (<= 1e-10); f32 kernel vs f64 twin {e32:.3e} (<= ode_expm "
            f"{budget:g}); {int(bad.sum())} poisoned cells in both; "
            f"{describe_ode_features(plan64)}")
        if e64 > 1e-10:
            raise AssertionError(f"K2d {name}: f64 kernel vs twin {e64} > 1e-10")
        if e32 > budget:
            raise AssertionError(f"K2d {name}: f32 kernel {e32} > ode_expm {budget}")
    model, data, support, ems = cases["poison"]
    pt.set_float_dtype(torch.float64)
    fused = pt.log_likelihood_matrix(model, data, support, ems, device="cuda", engine="fused")
    general = pt.log_likelihood_matrix(model, data, support, ems, device="cuda",
                                       engine="general")
    lost = torch.isneginf(fused)
    if not (bool((lost == torch.isneginf(general)).all()) and bool(lost.any())
            and bool(torch.isfinite(fused[~lost]).all())):
        raise AssertionError("K2d poison: fused and general are -inf in different cells")
    log(f"[9] K2d poison through the entry point: {int(lost.sum())} of {lost.numel()} cells "
        f"-inf on the fused and on the general engine alike (scaled norm past 2^16); the "
        f"others agree to {rel_err(fused[~lost], general[~lost], 1e-300):.3e}")


def phase_rhs_jvp(pt, cases) -> None:
    """The generated ``rhs`` and ``rhs_jvp`` as the library computes them on
    the card against the closure and ``torch.func.jvp`` of it, float64, at
    4096 random samples per distinct RHS: within 1e-12 of the scale."""
    from pharmsol_tpu_torch.ops.fused_ode import call_rhs, rhs_jvp_on_device
    from pharmsol_tpu_torch.ops.rhs_codegen import LaneCov

    n = 4096
    seen = set()
    rng = np.random.RandomState(SEED + 11)
    for name, (model, data, support, ems) in cases.items():
        gen = ode_plan_for(model, data, support, ems, torch.float64).rhs
        if gen.key in seen:
            continue
        seen.add(gen.key)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float64, device="cuda")

        x, v = dev(rng.randn(n, gen.n_states) * 20.0), dev(rng.randn(n, gen.n_states))
        p = dev(rng.uniform(0.05, 3.0, (n, gen.n_params)))
        t, rate = dev(rng.uniform(0.0, 24.0, n)), dev(rng.uniform(0.0, 50.0, (n, gen.ninput)))
        # cov(t) = ca + cb t; a covariate of mode "const" has no slope
        ncov = max(len(gen.cov_names), 1)
        slope = np.zeros((1, ncov))
        slope[0, :len(gen.cov_modes)] = [m == "affine" for m in gen.cov_modes]
        ca = dev(rng.uniform(0.0, 2.0, (n, ncov)))
        cb = dev(rng.uniform(-0.1, 0.1, (n, ncov)) * slope)
        cov = LaneCov({nm: ca[:, i] if mode == "const" else (ca[:, i], cb[:, i])
                       for i, (nm, mode) in enumerate(zip(gen.cov_names, gen.cov_modes))})

        def closure(xs):  # the closure in its style, on n lanes
            return torch.stack(call_rhs(gen, list(xs), list(p.t()), t,
                                        [torch.zeros_like(t)] * gen.ninput, list(rate.t()),
                                        cov, (n,), torch.float64, "cuda"))

        want_f, want_jv = torch.func.jvp(closure, (x.t().contiguous(),), (v.t().contiguous(),))
        f, jv = rhs_jvp_on_device(gen, x, p, t, rate, v, ca, cb)
        torch.cuda.synchronize()
        ef = float((f - want_f.t()).abs().max() / want_f.abs().max().clamp(min=1.0))
        ej = float((jv - want_jv.t()).abs().max() / want_jv.abs().max().clamp(min=1.0))
        log(f"[9] rhs_jvp {name:18s} (header {gen.key}, n={gen.n_states}): generated rhs vs "
            f"closure {ef:.3e}, rhs_jvp vs torch.func.jvp {ej:.3e} (<= 1e-12), {n} samples")
        if not (ef <= 1e-12 and ej <= 1e-12):
            raise AssertionError(f"rhs_jvp {name}: rhs {ef}, jvp {ej} > 1e-12")


def fast_mass(fit) -> float:
    """The fitted mass of the fast eliminators (ke > 0.2)."""
    return float(np.sum(fit.weights[fit.support[:, 1] > 0.2]))


def phase_fit(pt, label, model, data, ems, counter, card: str, phase: int = 10) -> dict:
    """One population fit at full width on the card through
    ``pt.optimize.fit_population`` (float64, 10 000 subjects, 1000 start
    points, 8 cycles), the counts set to 0 just before and read just after:
    every psi call of the fit must be one launch of ``counter``'s kernel and
    of no other."""
    from pharmsol_tpu_torch.ops import fused_ode, fused_psi
    from pharmsol_tpu_torch.utils.f32_budget import POPULATION_RANGES
    from pharmsol_tpu_torch.utils.profiling import reset_stages, stage_counts, stage_report

    pt.set_float_dtype(torch.float64)
    reset_stages()
    fused_psi.LAUNCHES = fused_psi.FEATURE_LAUNCHES = 0
    fused_ode.LAUNCHES = fused_ode.FEATURE_LAUNCHES = fused_ode.EXPM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = pt.optimize.fit_population(model, data, ems, ranges=POPULATION_RANGES, **FIT_KW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"K1a": fused_psi.LAUNCHES, "K1b": fused_psi.FEATURE_LAUNCHES,
              "K2a": fused_ode.LAUNCHES, "K2e": fused_ode.FEATURE_LAUNCHES,
              "K2d": fused_ode.EXPM_LAUNCHES}
    stages = stage_counts()
    psi_calls = stages["npag/psi_device"][0]
    dec = pt.last_engine_decision(model)
    if dec["engine"] != "fused":
        raise AssertionError(f"{label}: engine {dec}")
    if counts[counter] != psi_calls or any(v for k, v in counts.items() if k != counter):
        raise AssertionError(f"{label}: {psi_calls} psi calls, launches {counts}")
    if not (np.isfinite(fit.log_likelihood) and np.all(np.isfinite(fit.support))
            and abs(fit.weights.sum() - 1.0) < 1e-9
            and fit.posterior.shape == (len(data), fit.support.shape[0])):
        raise AssertionError(f"{label}: malformed fit")
    mass = fast_mass(fit)
    log(f"[{phase}] {label}: log-likelihood {fit.log_likelihood:.6f}, {fit.support.shape[0]} support "
        f"points (JAX package, recorded: {FIT_RECORDED['support']}), {fit.cycles} cycles, fast "
        f"mass {mass:.6f}, max D-n {fit.d_max:.3e}; {psi_calls} psi calls = {counts[counter]} "
        f"{counter} launches, engine {dec['engine']}; fit {seconds:.3f} s  ({card})")
    for line in stage_report().splitlines():
        log(f"[{phase}] {label}   {line}")
    dev_calls, dev_s = stages.get("npag/weights_device", (0, 0.0))
    return dict(fit=fit, seconds=seconds, launches=counts[counter], psi_calls=psi_calls,
                psi_s=stages["npag/psi_device"][1], weights_s=stages["npag/weights"][1],
                weights_calls=stages["npag/weights"][0], weights_device_s=dev_s,
                weights_device_calls=dev_calls, fast_mass=mass)


def phase_fits(pt, card: str) -> tuple:
    """Fit A (the closed-form 1-cmt oral model, K1a) and Fit B (the same
    model written as a linear ODE with expm, K2d) on the data of the JAX
    package's population benchmark, rebuilt from numpy. Fit A lands on the
    recorded fit (log-likelihood within 0.5, fast mass within 0.01); Fit B
    lands on Fit A (log-likelihood within 1e-6 relative, fast mass within
    1e-3), since the exact propagation is the closed form."""
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    t0 = time.perf_counter()
    data, ems, t_subjects = population_10k_case(FIT_SUBJECTS)
    t_data = time.perf_counter() - t0
    log(f"[10] population data: {len(data)} subjects x 9 observations from RandomState(7) in "
        f"{t_data:.3f} s ({t_subjects:.3f} s building the subjects)")
    closed, ode = population_models()
    a = phase_fit(pt, "fit A closed form 10000", closed, data, ems, "K1a", card)
    b = phase_fit(pt, "fit B expm ODE 10000", ode, data, ems, "K2d", card)
    fa, fb = a["fit"], b["fit"]
    d_ll = abs(fa.log_likelihood - FIT_RECORDED["log_likelihood"])
    d_mass = abs(a["fast_mass"] - FIT_RECORDED["fast_mass"])
    log(f"[10] fit A vs the JAX package's recorded fit: log-likelihood {fa.log_likelihood:.4f} "
        f"vs {FIT_RECORDED['log_likelihood']} (|d| {d_ll:.4f} <= 0.5), fast mass "
        f"{a['fast_mass']:.4f} vs {FIT_RECORDED['fast_mass']} (|d| {d_mass:.4f} <= 0.01)")
    if not (d_ll <= 0.5 and d_mass <= 0.01):
        raise AssertionError(f"fit A: log-likelihood off by {d_ll}, fast mass by {d_mass}")
    r_ll = abs(fb.log_likelihood - fa.log_likelihood) / abs(fa.log_likelihood)
    r_mass = abs(b["fast_mass"] - a["fast_mass"])
    log(f"[10] fit B vs fit A: log-likelihood rel {r_ll:.3e} (<= 1e-6), fast mass |d| "
        f"{r_mass:.3e} (<= 1e-3), support {fb.support.shape[0]} vs {fa.support.shape[0]}, "
        f"cycles {fb.cycles} vs {fa.cycles}")
    if not (r_ll <= 1e-6 and r_mass <= 1e-3):
        raise AssertionError(f"fit B vs fit A: log-likelihood {r_ll}, fast mass {r_mass}")
    for r in (a, b):
        r["data_s"] = t_data
        del r["fit"]
    return a, b, data, ems, closed


def expm_pass_ops(model) -> tuple:
    """Operations of one exact propagation per cell: (fixed, per squaring).
    Fixed: the RHS at zero and its n tangents (counted on the closure, a
    tangent as one RHS) and the 12 Horner rounds; a round and a squaring are
    2 n^2 (n + 1) each (n^2 + n dot products of length n)."""
    n, nin = model.nstates(), model.ndrugs()
    one = torch.ones
    rhs = count_ops(model._diffeq, one(n, dtype=torch.float64), one(8, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64), torch.zeros(nin, dtype=torch.float64),
                    torch.zeros(nin, dtype=torch.float64),
                    lambda name, t=None: torch.tensor(1.0, dtype=torch.float64))
    product = 2 * n * n * (n + 1)
    return rhs * (1 + n) + 12 * product, product


def phase_expm_slice(pt, rng) -> tuple:
    """The K2d cell: the 5-state transit and mammillary model
    (``examples/expm_linear_ode.py``) with expm at 16384 subjects x 512
    supports through the public entry point, three calls per dtype with
    fresh supports, each on the fused engine with exactly one K2d launch and
    no K2a or K2e launch; then held against the general engine on the card
    on its first 2048 subjects (float64 within 1e-9, float32 within the
    ``ode_expm`` row of the float64 general engine)."""
    from pharmsol_tpu_torch.ops import fused_ode
    from pharmsol_tpu_torch.utils.f32_budget import (
        F32_BUDGET, TRANSIT_CENTRE, expm_case, f32_error,
    )

    n, S = EXPM_SHAPE
    rows = EXPM_CHECK_ROWS
    label = f"ode_expm_transit_{n}x{S}"
    t0 = time.perf_counter()
    model, data, _, ems = expm_case("transit", n, 1, seed=SEED)
    t_build = time.perf_counter() - t0
    supports = [jittered_support(TRANSIT_CENTRE, S, rng, 0.2) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_ode.LAUNCHES = fused_ode.FEATURE_LAUNCHES = fused_ode.EXPM_LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = fused_ode.EXPM_LAUNCHES
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            if fused_ode.EXPM_LAUNCHES - before != 1:
                raise AssertionError(f"{label}: {fused_ode.EXPM_LAUNCHES - before} K2d launches "
                                     "in one call")
            if tuple(psi.shape) != (n, S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            bad = int((~torch.isfinite(psi)).sum())
            if bad:
                raise AssertionError(f"{label} {dtype}: {bad} non-finite psi cells")
            results.append((dtype, sp, psi))
    k2a, k2e, launches = expm_launch_counts()
    log(f"[11] {label}: {len(results)} log_likelihood_matrix calls on cuda, engine fused, "
        f"{launches} K2d launches, {k2a} K2a and {k2e} K2e launches")
    if k2a or k2e:
        raise AssertionError(f"{label}: the main path launched K2a or K2e")
    sub = pt.Data(data.subjects()[:rows])
    pt.set_float_dtype(torch.float64)
    general = [pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
               for sp in supports]
    torch.cuda.synchronize()
    for j, (dtype, sp, psi) in enumerate(results):
        want = general[j % len(supports)]
        if dtype == torch.float64:
            err, tol = rel_err(psi[:rows], want, 1.0), 1e-9
        else:
            err = f32_error(psi[:rows].cpu().numpy(), want.cpu().numpy())
            tol = F32_BUDGET["ode_expm"]
        log(f"[11] {label} {str(dtype)[6:]}: fused vs f64 general on subjects 0-{rows - 1} "
            f"rel {err:.3e} (<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if err > tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return label, model, data, ems, launches, t_build


def phase_expm_times(pt, label, model, data, ems, t_build, card: str) -> dict:
    """K2d alone, its twin, the general engine on the subjects of the check,
    one end-to-end call and its steps at the cell's shape; K2d held against
    its twin there; the bound of its work; and, for context only, the time
    ``torch.linalg.matrix_exp`` takes for as many (n + 1) x (n + 1) matrices
    as the cell has passes (it does not compute psi)."""
    from pharmsol_tpu_torch.likelihood.matrix import _general_psi
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, TRANSIT_CENTRE, f32_error

    n, S = EXPM_SHAPE
    rows = EXPM_CHECK_ROWS
    sp = jittered_support(TRANSIT_CENTRE, S, np.random.RandomState(SEED + 6), 0.2)
    sub_grid = model.lower(pt.Data(data.subjects()[:rows]).subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    fixed_ops, squaring_ops = expm_pass_ops(model)
    out, twin64 = {}, None
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        plan = ode_plan_for(model, data, sp, ems, dtype)
        kw = plan.kernel_kwargs()
        counts = {}
        got = run_ode_kernel(plan)
        twin, twin_ms = event_ms(lambda: psi_ode_plain(
            *plan.streams, plan.support, plan.rhs, counts=counts, **kw))
        if dtype == torch.float64:
            twin64 = twin
            abs_err = float((got - twin).abs().max())
            rel, tol = rel_err(got, twin, 1.0), 1e-10
        else:
            abs_err = float((got.double() - twin64).abs().max())
            rel, tol = f32_error(got.cpu().numpy(), twin64.cpu().numpy()), F32_BUDGET["ode_expm"]
        log(f"[11] K2d vs twin {label} {d}: max abs {abs_err:.3e}, rel {rel:.3e} (<= {tol:g}"
            f"{'' if dtype == torch.float64 else ', against the f64 twin'})")
        if rel > tol:
            raise AssertionError(f"{label} {dtype}: K2d vs twin {rel} > {tol}")
        t = {
            "kernel": cuda_ms(lambda: run_ode_kernel(plan), 10),
            "twin": twin_ms,
            "general": wall_ms(lambda: _general_psi(
                model, sub_grid, sp, lowered, torch.device("cuda"), dtype), 2),
            "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                model, data, sp, ems, device="cuda"), 5),
        }
        parts = ode_end_to_end_parts(model, data, sp, ems, dtype, plan)
        ops = counts["passes"] * fixed_ops + counts["squarings"] * squaring_ops
        nbytes = plan_bytes(plan, kw, n, S)
        t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
        cells = n * S
        for k in ("kernel", "twin", "end_to_end"):
            log(f"[11] {label} {d} {k:10s} {t[k]:10.3f} ms  {cells / (t[k] * 1e-3):.4g} "
                f"cells/s  ({card})")
        log(f"[11] {label} {d} general    {t['general']:10.3f} ms on subjects 0-{rows - 1} "
            f"x {S}  ({card})")
        log(f"[11] {label} {d} end_to_end parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        log(f"[11] {label} {d} kernel+finalize share of end_to_end "
            f"{(t['kernel'] + parts['finalize']) / t['end_to_end']:.4f}, plan "
            f"{parts['plan'] / t['end_to_end']:.4f} ({card})")
        log(f"[11] {label} {d} K2d bound {t['bound']:.5g} ms by {t['bound_by']} "
            f"({nbytes / 1e6:.2f} MB, {counts['passes']} passes x {fixed_ops} + "
            f"{counts['squarings']} squarings x {squaring_ops} = {ops / 1e9:.3f} G operations); "
            f"kernel at {t['bound'] / t['kernel']:.3f} of it")
        # context: a library's exponential of as many (n + 1)^2 blocks, in
        # chunks of 2^20 (the whole batch would not fit the card)
        size = model.nstates() + 1
        chunk = 1 << 20
        blocks = torch.randn(chunk, size, size, dtype=dtype, device="cuda") * 0.3
        reps = max(1, -(-counts["passes"] // chunk))
        per_chunk = cuda_ms(lambda: torch.linalg.matrix_exp(blocks), 3, 1)
        t["matrix_exp"] = per_chunk * reps
        log(f"[11] {label} {d} context: torch.linalg.matrix_exp of {counts['passes']} "
            f"{size}x{size} blocks {t['matrix_exp']:.3f} ms ({per_chunk:.3f} ms per 2^20, "
            f"x{reps}); it computes no psi  ({card})")
        del blocks
        t["abs_err"] = abs_err
        t["plan"] = parts["plan"]
        t["passes"], t["squarings"] = counts["passes"], counts["squarings"]
        out[dtype] = t
    model._lower_cache.clear()
    t0 = time.perf_counter()
    model.lower(data.subjects())
    log(f"[11] {label} host: subject builder {t_build * 1e3:.1f} ms, lowering "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({n} subjects)")
    return out


def phase_burnin_threshold(pt, model, data, ems, card: str) -> list:
    """The NPML burn-in on the host (``_burnin_host``, float64 numpy with
    pruning) against the burn-in on the card (``_burnin_device``, float32) on
    the fit's own psi at 10 000 subjects and k Halton supports, k in
    ``BURNIN_WIDTHS``: seconds each (the card's with the synchronisation and
    the copy of lam), and the log-likelihood of the lam each reaches (within
    1e-4 relative). The port's ``_DEVICE_MIN_CELLS`` is set from these
    lines."""
    from pharmsol_tpu_torch.optimize import weights
    from pharmsol_tpu_torch.optimize.npag import _halton
    from pharmsol_tpu_torch.utils.f32_budget import POPULATION_RANGES

    bounds = np.asarray(POPULATION_RANGES)
    pt.set_float_dtype(torch.float64)
    lines = []
    for k in BURNIN_WIDTHS:
        support = bounds[:, 0] + _halton(k, 3) * (bounds[:, 1] - bounds[:, 0])
        log_psi = pt.log_likelihood_matrix(model, data, support, ems, device="cuda")
        psi_t = torch.exp(log_psi - torch.amax(log_psi, dim=1, keepdim=True))
        psi_f32 = psi_t.to(torch.float32)
        psi = psi_t.cpu().numpy()
        weights._burnin_device(psi_f32)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam_dev = weights._burnin_device(psi_f32)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        _, iters = weights._burnin_device_loop(psi_f32)
        t0 = time.perf_counter()
        lam_host = weights._burnin_host(psi)
        t_host = time.perf_counter() - t0
        ll_dev = float(np.sum(np.log(np.maximum(psi @ lam_dev, 1e-300))))
        ll_host = float(np.sum(np.log(np.maximum(psi @ lam_host, 1e-300))))
        rel = abs(ll_dev - ll_host) / max(1.0, abs(ll_host))
        n = psi.shape[0]
        log(f"[12] burn-in {n} x {k:4d} ({n * k:8d} cells): host {t_host:8.4f} s, card "
            f"{t_dev:8.4f} s ({int(iters)} iterations), ratio host/card {t_host / t_dev:7.3f}; "
            f"log-likelihood host {ll_host:.4f}, card {ll_dev:.4f}, rel {rel:.3e} (<= 1e-4)  "
            f"({card})")
        if rel > 1e-4:
            raise AssertionError(f"burn-in k={k}: log-likelihoods differ by {rel} > 1e-4")
        lines.append(dict(k=k, cells=n * k, host_s=t_host, card_s=t_dev, iterations=int(iters)))
    faster = [ln["cells"] for ln in lines if ln["card_s"] < ln["host_s"]]
    log(f"[12] burn-in: the card is faster from {min(faster) if faster else 'no width here'} "
        f"cells; the port's _DEVICE_MIN_CELLS is {weights._DEVICE_MIN_CELLS}")
    return lines


# ---------------------------------------------------------------------------
# stiff ODE models: the SDIRK tier (K2b) and the BDF tier (K2c)
# ---------------------------------------------------------------------------


def stiff_launch_counts():
    from pharmsol_tpu_torch.ops import fused_ode

    return (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES,
            fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES)


def reset_ode_launch_counts():
    from pharmsol_tpu_torch.ops import fused_ode

    fused_ode.LAUNCHES = fused_ode.FEATURE_LAUNCHES = fused_ode.EXPM_LAUNCHES = 0
    fused_ode.SDIRK_LAUNCHES = fused_ode.BDF_LAUNCHES = 0


def stiff_case_at(name: str, solver: str):
    """One stiff case at the check shape, from its own seed."""
    from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES, ode_case, stiff_case

    if name == "budget ode_bdf":
        return ode_case("ode_bdf")
    return stiff_case(name, *STIFF_CHECK_SHAPE, seed=SEED + list(STIFF_CASES).index(name),
                      solver=solver)


def stiff_twin_job(job) -> dict:
    """One plain twin on the card, run in a worker process of its own while
    the libraries build (the twins' masked Python loops are launch-bound,
    1-40 s each, and sixty-five of them in a row would take as long as the
    rest of this script): the
    inputs are rebuilt from the same seeds as the main process's. ``job`` is
    (kind, name, solver, merge, dtype name, order cap): kind ``check`` is the
    case at 64 x 48, kind ``cell`` the stiff cell's subjects
    ``stiff_twin_rows`` x 512 supports, kind ``style`` phase 28's math model
    at 64 x 48. Returns psi [R, S] as numpy, the
    attempts, the attempts per row, for bdf the twin's tally of trials,
    accepts, adaptations and rescalings per row and order, and the twin's
    time by CUDA events (the worker shares the card and the host with the
    other workers and with nvcc: a contended time)."""
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain

    kind, name, solver, merge, dtype_name, cap = job
    if kind == "sde_bound":
        return sde_bound_twin_job(job)
    dtype = getattr(torch, dtype_name)
    pt.set_float_dtype(dtype)
    if kind == "check":
        model, data, support, ems = stiff_case_at(name, solver)
    elif kind == "style":
        model, data, support, ems = style_math_case(solver)
    else:
        data, ems, _ = tmdd_population(pt, STIFF_SHAPE[0], np.random.RandomState(SEED + 8),
                                       rows=stiff_twin_rows(STIFF_SHAPE[0]))
        model = tmdd_model(solver)
        support = tmdd_support(STIFF_SHAPE[1], np.random.RandomState(SEED + 7))
    plan = ode_plan_for_cap(model, data, support, ems, dtype, cap)
    counts = {}
    psi, ms = event_ms(lambda: psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                             counts=counts, **plan.kernel_kwargs(merge)))
    out = dict(psi=psi.cpu().numpy(), steps=counts["steps"], ms=ms,
               steps_by_row=counts["steps_by_row"].cpu().numpy())
    if kind == "cell":
        out["trials_by_call"] = torch.stack(counts["trials_by_call"]).to(torch.int32).cpu().numpy()
    if solver == "bdf":
        out["bdf_by_row"] = counts["bdf_by_row"].cpu().numpy()
    return out


def stiff_twin_jobs(cases) -> list:
    """Every twin this slice needs: the float64 twin of each check case,
    merged and per segment where its plan merges, and the cell's twins per
    solver and dtype, with the order cap 5 beside 3 for bdf."""
    jobs = []
    for (name, solver), (model, data, support, ems) in cases.items():
        merges = ode_plan_for(model, data, support, ems, torch.float64).merge_runs is not None
        for merge in ((True, False) if merges else (False,)):
            jobs.append(("check", name, solver, merge, "float64", 3))
    for solver in STIFF_SOLVERS:
        for dtype_name in ("float64", "float32"):
            jobs.append(("cell", "tmdd", solver, True, dtype_name, 3))
            if solver == "bdf":
                jobs.append(("cell", "tmdd", solver, True, dtype_name, 5))
    return jobs


class StiffTwins:
    """The twins of ``jobs`` (:func:`stiff_twin_jobs`, :func:`style_twin_jobs`),
    computed by ``STIFF_TWIN_WORKERS`` worker processes on the card while the
    main process builds the libraries (nvcc needs no card); :meth:`wait`
    blocks until all are done, :meth:`get` gives one."""

    def __init__(self, jobs):
        import multiprocessing as mp

        self.jobs = list(jobs)
        # the longest first (phase 7's SDE twin, then bdf's)
        self.jobs.sort(key=lambda j: (j[0] != "sde_bound", j[2] != "bdf", j[0] != "cell"))
        self.pool = mp.get_context("spawn").Pool(STIFF_TWIN_WORKERS)
        self.pending = {job: self.pool.apply_async(stiff_twin_job, (job,)) for job in self.jobs}
        self.pool.close()

    def wait(self) -> None:
        """Block until every twin is done: the workers share the card, and a
        kernel timed while they run would read slower than it is."""
        t0 = time.perf_counter()
        for res in self.pending.values():
            res.wait(timeout=900)
        log(f"[1] {len(self.jobs)} plain twins of the stiff slice, phase 7 and phase 28 done in "
            f"{STIFF_TWIN_WORKERS} worker processes, started before the build; waited "
            f"{time.perf_counter() - t0:.1f} s more for them")

    def get(self, *job) -> dict:
        res = self.pending[job].get(timeout=900)
        return dict(res, psi=torch.as_tensor(res["psi"], device="cuda"))

    def stop(self) -> None:
        self.pool.terminate()
        self.pool.join()


def stiff_cases():
    """K2b's and K2c's cases at 64 subjects x 48 supports: the TMDD under
    each of bdf, trbdf2, kvaerno3 and kvaerno5, every other case of
    ``STIFF_CASES`` under one of them in turn, and the ``ode_bdf`` budget
    case under bdf: (name, solver) -> (model, data, support, ems)."""
    from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES

    others = [name for name in STIFF_CASES if name not in STIFF_ALL_SOLVER_CASES]
    pairs = [(name, solver) for name in STIFF_ALL_SOLVER_CASES for solver in STIFF_SOLVERS]
    pairs += [(name, STIFF_SOLVERS[i % len(STIFF_SOLVERS)]) for i, name in enumerate(others)]
    cases = {(name, solver): stiff_case_at(name, solver) for name, solver in pairs}
    cases[("budget ode_bdf", "bdf")] = stiff_case_at("budget ode_bdf", "bdf")
    return cases


def stiff_twin_rows(n: int) -> np.ndarray:
    """The ``STIFF_TWIN_ROWS`` subjects of the stiff cell that the twins
    march: spread evenly over the population (so over the kernel's blocks),
    the last subject among them, two of each of the five dose classes
    (subject i takes 100 mg x (1 + 0.1 (i mod 5)))."""
    base = np.linspace(0, n - 1, STIFF_TWIN_ROWS).astype(np.int64)
    want = (n - STIFF_TWIN_ROWS + np.arange(STIFF_TWIN_ROWS)) % 5
    rows = base + (want - base) % 5
    assert rows[-1] == n - 1 and len(set(rows)) == STIFF_TWIN_ROWS
    assert np.bincount(rows % 5, minlength=5).tolist() == [STIFF_TWIN_ROWS // 5] * 5
    return rows


def tmdd_population(pt, n: int, rng, rows=None):
    """The stiff cell's model and data: the TMDD of the JAX package's
    ``benches/stiff_bench.py:45-72`` uncut, its 16 subjects widened to ``n``
    (100 mg x (1 + 0.1 (i mod 5)) at 0, observations at 0.1 ... 48 h), the
    observed values from the seed; with ``rows``, those subjects of the
    ``n`` alone. Returns (data, ems, seconds to build)."""
    from pharmsol_tpu_torch.utils.f32_budget import TMDD_TIMES

    values = 3.0 * np.exp(-0.1 * np.asarray(TMDD_TIMES))[None, :] * np.exp(
        0.3 * rng.randn(n, len(TMDD_TIMES)))
    t0 = time.perf_counter()
    subjects = []
    for i in (range(n) if rows is None else rows):
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0 * (1 + 0.1 * (int(i) % 5)), 0)
        for j, t in enumerate(TMDD_TIMES):
            b = b.observation(t, float(values[i, j]), 0)
        subjects.append(b.build())
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    return pt.Data(subjects), ems, time.perf_counter() - t0


def tmdd_model(solver: str):
    from pharmsol_tpu_torch.utils.f32_budget import stiff_case

    return stiff_case("tmdd", 1, 1, solver=solver)[0]


def tmdd_support(S: int, rng) -> np.ndarray:
    from pharmsol_tpu_torch.utils.f32_budget import TMDD_CENTRE

    return np.asarray(TMDD_CENTRE)[None, :] * rng.uniform(0.7, 1.3, (S, len(TMDD_CENTRE)))


def stiff_build_targets(cases):
    """One library per (generated header, implicit solver) of the stiff
    cases and of the stiff cell (the cell's RHS is the ``tmdd`` case's), and
    the explicit library of the TMDD RHS for the dopri5 comparison."""
    from pharmsol_tpu_torch.ops import _build

    targets = {}
    for (name, solver), (model, data, support, ems) in cases.items():
        gen = ode_plan_for(model, data, support, ems, torch.float64).rhs
        target = _build.generated_target(_build.ode_kind(solver), gen)
        targets.setdefault(target.path, (f"stiff {name} {solver}", target))
    model, data, support, ems = cases[("tmdd", "bdf")]
    gen = ode_plan_for(model.with_solver("dopri5"), data, support, ems, torch.float64).rhs
    model.with_solver("bdf")
    target = _build.generated_target(_build.ODE, gen)
    targets.setdefault(target.path, ("stiff tmdd dopri5 (explicit tier)", target))
    return list(targets.values())


def compare_stiff(label, got, twin) -> tuple:
    """Float64 kernel against its twin by K2e's full-width rule: the same
    lost cells, every other cell within 1e-6 relative and 99% of them
    within 1e-8 (the twin takes J's columns from ``torch.func.jvp`` of the
    closure, the kernel from the generated ``rhs_jvp``: they differ in the
    last bits, and on the stiffest case, the TMDD under trbdf2, a step
    decision at a rounding tie flips in 0.4% of the cells, which then differ
    by 2e-8 at most; K2e's rule asks 99.9%, on a model that is not stiff).
    Returns (largest error, share within 1e-8)."""
    bad = ~torch.isfinite(twin)
    if not bool((~torch.isfinite(got) == bad).all()):
        raise AssertionError(f"{label}: kernel and twin non-finite in different cells "
                             f"({int((~torch.isfinite(got)).sum())} vs {int(bad.sum())})")
    ok = ~bad
    if not bool(ok.any()):
        return 0.0, 1.0
    rel = (got[ok].double() - twin[ok].double()).abs() / twin[ok].double().abs().clamp(min=1.0)
    err, share = float(rel.max()), float((rel <= 1e-8).double().mean())
    if err > 1e-6 or share < 0.99:
        raise AssertionError(f"{label}: kernel vs twin max {err} (<= 1e-6), {share} of the "
                             "cells within 1e-8 (>= 0.99)")
    return err, share


def hold_f32(label, got32, twin64, budget, twin32_fn) -> tuple:
    """Float32 kernel against the float64 twin within ``budget`` (the
    budget's measure over the cells finite in both). Where that fails, the
    float32 twin decides whose fault it is: if the float32 twin keeps the
    budget the kernel is wrong; if it breaks it too (the algorithm itself
    loses the row in float32), the kernel must reproduce the float32 twin,
    99% of the cells within 1e-3 relative, and the finding is printed.
    Returns (error, note)."""
    from pharmsol_tpu_torch.utils.f32_budget import f32_error

    def err_of(a, b):
        ok = torch.isfinite(a) & torch.isfinite(b)
        return f32_error(a[ok].cpu().numpy(), b[ok].cpu().numpy()) if bool(ok.any()) else 0.0

    lost64, lost32 = ~torch.isfinite(twin64), ~torch.isfinite(got32)
    err = err_of(got32, twin64)
    if err <= budget and bool((lost32 == lost64).all()):
        return err, ""
    twin32 = twin32_fn()
    err_twin = err_of(twin32, twin64)
    same_lost = bool((~torch.isfinite(twin32) == lost32).all())
    if err_twin <= budget and bool((~torch.isfinite(twin32) == lost64).all()):
        raise AssertionError(f"{label}: f32 kernel {err} > {budget} of the f64 twin, or other "
                             f"lost cells, while the f32 twin keeps the row ({err_twin})")
    ok = torch.isfinite(twin32) & torch.isfinite(got32)
    close = ((got32[ok] - twin32[ok]).abs() <= 1e-3 * twin32[ok].abs().clamp(min=1.0))
    share = float(close.double().mean()) if bool(ok.any()) else 1.0
    note = (f"; FINDING: the f32 twin itself is {err_twin:.3e} from the f64 twin "
            f"({int((lost32 != lost64).sum())} cells lost in one only): kernel vs f32 twin "
            f"{share:.4f} of the cells within 1e-3, lost cells "
            f"{'the same' if same_lost else 'differ'}")
    if share < 0.99:
        raise AssertionError(f"{label}: f32 kernel reproduces only {share} of the f32 twin")
    return err, note


def phase_stiff_kernels(pt, cases, twins) -> None:
    """K2b (trbdf2, kvaerno3, kvaerno5) and K2c (bdf, order cap 3) against
    their twins on the card on every case of ``stiff_cases``, merged and
    segment by segment where the plan merges: float64 by K2e's rule (every
    cell within 1e-6; 99% within 1e-8), float32 against the float64 twin
    within the ``ode_bdf`` row (2e-3; the JAX package has no row for the SDIRK
    solvers), the lost cells (-inf) the same in both, some but not all in the
    ``poison`` case and none elsewhere; every call one K2b or one K2c launch
    and no other."""
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET

    budget = F32_BUDGET["ode_bdf"]
    for (name, solver), (model, data, support, ems) in cases.items():
        plan64 = ode_plan_for(model, data, support, ems, torch.float64)
        plan32 = ode_plan_for(model, data, support, ems, torch.float32)
        is_bdf = solver == "bdf"
        if plan64.solver != solver or (plan64.merge_runs is not None
                                       and solver in ("bdf", "kvaerno5")):
            raise AssertionError(f"stiff {name} {solver}: plan {plan64.solver}, "
                                 f"runs {plan64.merge_runs}")
        for merge in ((True, False) if plan64.merge_runs is not None else (False,)):
            twin = twins.get("check", name, solver, merge, "float64", 3)
            twin64 = twin["psi"]
            before = stiff_launch_counts()
            got64 = run_ode_kernel(plan64, merge=merge)
            got32 = run_ode_kernel(plan32, merge=merge)
            torch.cuda.synchronize()
            launches = tuple(a - b for a, b in zip(stiff_launch_counts(), before))
            if launches != ((0, 0, 0, 0, 2) if is_bdf else (0, 0, 0, 2, 0)):
                raise AssertionError(f"stiff {name} {solver}: (K2a, K2e, K2d, K2b, K2c) "
                                     f"launches {launches}")
            lost = int((~torch.isfinite(twin64)).sum())
            if (lost > 0) != (name == "poison") or lost == twin64.numel():
                raise AssertionError(f"stiff {name} {solver}: {lost} of {twin64.numel()} "
                                     "cells lost in the twin")
            tag = f"stiff {name} {solver} {'merged' if merge else 'per segment'}"
            e64, share = compare_stiff(tag + " f64", got64, twin64)
            e32, note = hold_f32(tag + " f32", got32, twin64, budget, lambda: psi_ode_plain(
                *plan32.streams, plan32.support, plan32.rhs, **plan32.kernel_kwargs(merge)))
            log(f"[13] {'K2c' if is_bdf else 'K2b'} {name:17s} {solver:8s} "
                f"{'merged     ' if merge else 'per segment'} {len(data)}x{support.shape[0]} "
                f"n={plan64.n_states} f64 kernel vs twin max rel {e64:.3e} (<= 1e-6), {share:.4f} "
                f"of the cells within 1e-8 (>= 0.99); f32 kernel vs f64 twin {e32:.3e} (<= "
                f"ode_bdf {budget:g}); {lost} lost cells in both; "
                f"{twin['steps'] / twin64.numel():.1f} attempts/cell; twin {twin['ms'] / 1e3:.1f} "
                f"s in its worker; {describe_ode_features(plan64)}{note}")


def stiff_rhs_ops(model) -> int:
    """Operations of one right-hand side, counted on the model's closure."""
    n, nin = model.nstates(), model.ndrugs()
    one = torch.ones
    return count_ops(model._diffeq, one(n, dtype=torch.float64), one(8, dtype=torch.float64),
                     torch.tensor(1.0, dtype=torch.float64), torch.zeros(nin, dtype=torch.float64),
                     torch.zeros(nin, dtype=torch.float64),
                     lambda name, t=None: torch.tensor(50.0, dtype=torch.float64))


def newton_inverse_ops(n: int, rhs: int) -> int:
    """Operations of ``newton_inverse`` as the kernel writes it: n tangents
    for J's columns (a tangent counted as one right-hand side), ``I - c J``
    (2 n^2), and the Gauss-Jordan on the n x 2n augmented matrix: per pivot
    the clamp and the reciprocal (3), the row's scaling (2 n) and, for each
    of the other n - 1 rows, a multiply and a subtract over 2 n entries."""
    return n * rhs + 2 * n * n + n * (3 + 2 * n + 4 * n * (n - 1))


def sdirk_trial_ops(model, solver: str, newton_iters: int) -> int:
    """Operations of one attempted SDIRK step per cell as ``march_sdirk``
    writes it: the step's constants (6), J and the inverse once, the explicit
    first stage; per implicit stage the base and the guess (the tableau
    row's nonzeros as multiply-adds, and 4 more per state), ``newton_iters``
    rounds (a right-hand side, the residual 3 n, the product with Minv
    2 n^2 - n, the update n), one more right-hand side and the residual norm
    (9 n + 3); the solution, error, growth and scale sums (B's and BHAT's
    nonzeros as multiply-adds, and 15 more per state) and the decision (20)."""
    from pharmsol_tpu_torch.engine.ode import SDIRK_TABLEAUS

    tab = SDIRK_TABLEAUS[solver]
    n, rhs = model.nstates(), stiff_rhs_ops(model)

    def nnz(row):
        return sum(1 for v in row if v != 0.0)

    ops = 6 + newton_inverse_ops(n, rhs) + rhs
    for i in range(1, len(tab["C"])):
        ops += n * (2 * nnz(tab["A"][i][:i]) + 3) + 2
        ops += newton_iters * (rhs + 3 * n + (2 * n * n - n) + n)
        ops += rhs + 9 * n + 3
    return ops + n * (2 * nnz(tab["B"]) + 2 * nnz(tab["BHAT"]) + 15) + 20


def bdf_change_ops(k: int, n: int) -> int:
    """Operations of ``bdf_change_D`` at order k as the kernel writes it:
    R's k x k recurrence (3 each, a product more from the second row on)
    with its k^2 multiply-adds over n states, then U's (k + 1)^2
    multiply-adds over n states."""
    return k * k * (3 + 2 * n) + k * (k - 1) + (k + 1) ** 2 * 2 * n


def bdf_ops(model, newton_iters: int, tally) -> int:
    """Operations of K2c's march for a tally [5, 6] of trials, accepts,
    adaptations, clip rescalings and factor rescalings per order, each
    priced as ``march_bdf`` performs it at that order: a trial at order k is
    the clip and the step's constants (9), the predictor and psi sums
    (n (3 k + 1)), the scales (4 n), J and the inverse, ``newton_iters``
    rounds (a right-hand side, the residual 3 n, the product with Minv
    2 n^2 - n, the updates of d and y 2 n), one more right-hand side with its residual (3 n), the two norms
    (8 n + 4) and the decision (8); an accept adds the difference update
    ((k + 2) n + 4), a rejection its factor (10), an adaptation two norms
    and three factors (8 n + 34); a rescaling is ``bdf_change_ops`` at its
    own order."""
    n, rhs = model.nstates(), stiff_rhs_ops(model)
    newton_round = rhs + 3 * n + (2 * n * n - n) + 2 * n
    fixed = (9 + 4 * n + newton_inverse_ops(n, rhs) + newton_iters * newton_round
             + rhs + 3 * n + 8 * n + 4 + 8)
    total = 0
    for k in range(1, tally.shape[1]):
        trials, accepts, adapts, clips, refacs = (int(v) for v in tally[:, k])
        total += trials * (fixed + n * (3 * k + 1)) + accepts * ((k + 2) * n + 4)
        total += (trials - accepts) * 10 + adapts * (8 * n + 34)
        total += (clips + refacs) * bdf_change_ops(k, n)
    return total


def by_dose_class(by_row, n_total: int) -> np.ndarray:
    """The count of each of the five dose classes from the twin's count per
    row on the subjects ``stiff_twin_rows``: a cell's march depends on its
    subject through the dose alone, 100 mg x (1 + 0.1 (i mod 5)), so subject
    i marches as any subject of its class does. Held here: the twin's two
    subjects of each class give the same counts."""
    by_row = np.asarray(by_row).astype(np.int64)
    classes = stiff_twin_rows(n_total) % 5
    out = []
    for c in range(5):
        first, second = np.nonzero(classes == c)[0]
        if not np.array_equal(by_row[first], by_row[second]):
            raise AssertionError(f"the twin's subjects {first} and {second} of dose class {c} "
                                 f"differ in their counts: {by_row[first]} vs {by_row[second]}")
        out.append(by_row[first])
    return np.stack(out)


def scaled_to_cell(by_row, n_total: int):
    """A count of the whole stiff cell from the twin's count per row on the
    subjects ``stiff_twin_rows`` (``by_dose_class``)."""
    n_of = np.bincount(np.arange(n_total) % 5, minlength=5)
    by_class = by_dose_class(by_row, n_total)
    return (n_of.reshape((5,) + (1,) * (by_class.ndim - 1)) * by_class).sum(0)


def warp_slots(per_lane) -> np.ndarray:
    """32 x the largest count of each warp of 32 consecutive lanes along the
    last axis (a ragged last warp still takes 32 slots), summed over the
    warps."""
    x = np.asarray(per_lane, dtype=np.int64)
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, -x.shape[-1] % 32)])
    return 32 * x.reshape(*x.shape[:-1], -1, 32).max(-1).sum(-1)


def lane_slots_by_row(trials_by_call) -> dict:
    """Lane-slots per row from the twin's trials of each lane in each march
    call ([calls, R, S], ``psi_ode_plain``'s ``counts["trials_by_call"]``),
    under the parent's layout (a warp is 32 supports of one row and waits
    for its slowest lane in every march call: ``synced``) and with one cell
    a lane marching its calls on its own (``own``); with the trials per row
    and per cell; and each cell's passes of the persistent grid's loop
    (``passes``: one a trial, one for a march call without a trial, and one
    that ends the cell and starts the next)."""
    tb = np.asarray(trials_by_call, dtype=np.int64)
    per_cell = tb.sum(0)
    return dict(synced=warp_slots(tb).sum(0), own=warp_slots(per_cell),
                trials=per_cell.sum(-1), per_cell=per_cell,
                passes=1 + np.maximum(tb, 1).sum(0))


def lane_slots_refilled(cell_passes, n_cells: int, lanes: int) -> float:
    """Lane-slots of the implicit tiers' persistent grid: each of ``lanes``
    lanes marches the cells ``implicit_lane_cell`` gives it one after the
    other, so a warp takes 32 x its busiest lane's passes. ``cell_passes``
    maps an array of cell indices to their passes."""
    from pharmsol_tpu_torch.ops.fused_ode import implicit_lane_cell

    g = np.arange(lanes, dtype=np.int64)
    per_lane = np.zeros(lanes, dtype=np.int64)
    for k in range(-(-n_cells // lanes)):
        c = implicit_lane_cell(g, k, lanes)
        ok = c < n_cells
        per_lane[ok] += cell_passes(c[ok])
    return float(warp_slots(per_lane))


def stiff_lane_slots(trials_by_call, n_total: int, lanes=None) -> dict:
    """Lane-slots per trial of the whole stiff cell (``n_total`` subjects x
    the twin's supports) from the twin's trials by march call on the
    subjects ``stiff_twin_rows``: synced at every march call (the parent's
    layout), one cell a lane on its own, and, given the grid's ``lanes``,
    the implicit tiers' persistent grid over every cell (its passes per
    trial: a pass without a trial counts)."""
    from pharmsol_tpu_torch.ops.fused_ode import implicit_cell

    rows = lane_slots_by_row(trials_by_call)
    trials = float(scaled_to_cell(rows["trials"], n_total))
    out = dict(synced=float(scaled_to_cell(rows["synced"], n_total)) / trials,
               own=float(scaled_to_cell(rows["own"], n_total)) / trials, refilled=None,
               trials=trials)
    if lanes:
        table = by_dose_class(rows["passes"], n_total)
        S = table.shape[1]
        out["refilled"] = lane_slots_refilled(
            lambda c: table[implicit_cell(c, n_total)[0] % 5, implicit_cell(c, n_total)[1]],
            n_total * S, lanes) / trials
    return out


# the boundary's cost as a share of a trial's, for the explicit tier's
# layout model (a boundary: a call's end, the next call's observation term,
# rates, covariates and dose by two RHS, its starting RHS; a trial: six RHS,
# the stage and error sums and the controller)
LAYOUT_BETAS = (0.25, 0.5, 1.0)


def explicit_layout_costs(trials_by_call, chain: int = 1, betas=LAYOUT_BETAS) -> dict:
    """The explicit tier's march under three layouts, from the twin's trials
    of each lane in each march call ([calls, R, S], ``psi_ode_plain``'s
    ``counts["trials_by_call"]``), per trial: ``slots``, the lane-slots of the
    passes in which some lane of the warp makes a trial; ``passes``, every
    pass of a warp, 32 lane-slots each; ``cost[beta]``, a warp's pass priced
    one trial where any of its lanes makes one and ``beta`` of a trial where
    any of them is at a boundary (a call's end and the next call's start, or
    its cell's end).
    - ``synced`` (the per-row kernel): a warp is 32 supports of one row and
      its lanes meet at every march call: a call costs 32 x its slowest
      lane's trials and one boundary, the cell's end one more;
    - ``support_synced``: the same on the support-major walk, a warp on 32
      neighbouring rows of one support (the cells in support-major order, 32
      at a time);
    - ``row_lanes``: the same warps, each lane marching its calls on its own,
      one trial a pass, the warp rejoined before each trial (a cell takes one
      pass per trial, one per call without a trial and one to end it);
    - ``support_lanes``: that loop on the support-major walk, a warp on 32
      neighbouring rows of one support (``ops/fused_ode.py::
      implicit_lane_cell``).
    With ``chain`` > 1 each lane marches ``chain`` cells one after the other,
    a warp taking the next 32 cells of its walk each time."""
    tb = np.asarray(trials_by_call, dtype=np.int64)
    n_calls, R, S = tb.shape
    trials = float(tb.sum())
    out = {}
    for layout, calls in (("synced", tb.reshape(n_calls, -1)),
                          ("support_synced", tb.transpose(0, 2, 1).reshape(n_calls, -1))):
        worst = np.pad(calls, ((0, 0), (0, -calls.shape[1] % 32))).reshape(n_calls, -1, 32).max(-1)
        n_bounds = 32.0 * worst.shape[1] * (n_calls + 1)
        slots = 32.0 * float(worst.sum())
        out[layout] = dict(slots=slots / trials,
                           passes=(32.0 * float(np.maximum(worst, 1).sum())
                                   + n_bounds / (n_calls + 1)) / trials,
                           cost={b: (slots + b * n_bounds) / trials for b in betas})
    for layout, cells in (("row_lanes", tb.transpose(1, 2, 0)),
                          ("support_lanes", tb.transpose(2, 1, 0))):
        cells = cells.reshape(-1, n_calls)
        n = len(cells)
        W = -(-n // (32 * chain))
        lens = np.zeros((W * 32 * chain, n_calls), dtype=np.int64)
        lens[:n] = np.maximum(cells, 1)
        tri = np.zeros_like(lens)
        tri[:n] = cells
        cell_len = lens.sum(1) + (np.arange(len(lens)) < n)
        # pass i of the chain: warp w's lane j marches cell (i W + w) 32 + j
        order = np.arange(W * 32 * chain).reshape(chain, W, 32)
        lane_off = np.zeros_like(order)
        lane_off[1:] = np.cumsum(cell_len[order], axis=0)[:-1]
        cell_off = np.empty(len(lens), dtype=np.int64)
        cell_off[order.reshape(-1)] = lane_off.reshape(-1)
        cell_warp = np.empty(len(lens), dtype=np.int64)
        cell_warp[order.reshape(-1)] = np.broadcast_to(np.arange(W)[None, :, None],
                                                       order.shape).reshape(-1)
        warp_len = np.zeros(W, dtype=np.int64)
        np.maximum.at(warp_len, cell_warp, cell_off + cell_len)
        width = int(warp_len.max()) + 1
        starts = cell_off[:, None] + np.cumsum(lens, 1) - lens  # each call's first pass
        bnd = np.zeros((W, width), dtype=bool)
        real = np.arange(len(lens)) < n
        bnd[np.repeat(cell_warp[real], n_calls), starts[real].reshape(-1)] = True
        bnd[cell_warp[real], (cell_off + cell_len - 1)[real]] = True
        edges = np.zeros((W, width + 1), dtype=np.int64)
        busy = tri > 0
        w_of = np.broadcast_to(cell_warp[:, None], busy.shape)[busy]
        np.add.at(edges, (w_of, starts[busy]), 1)
        np.add.at(edges, (w_of, (starts + tri)[busy]), -1)
        any_trial = np.cumsum(edges, 1)[:, :width] > 0
        slots = 32.0 * float(any_trial.sum())
        out[layout] = dict(slots=slots / trials, passes=32.0 * float(warp_len.sum()) / trials,
                           cost={b: (slots + b * 32.0 * float(bnd.sum())) / trials
                                 for b in betas})
    return out


def explicit_lane_report(tb, chains=(1, 8)) -> dict:
    """The explicit cell's lane-slots per trial (``lane_slots_by_row``: synced
    at every march call as the per-row kernel is, and one cell a lane on its
    own) and the layout model (``explicit_layout_costs``) at one and at
    several cells a lane, from the twin's trials by march call."""
    rows = lane_slots_by_row(tb)
    trials = float(rows["trials"].sum())
    tb = np.asarray(tb)
    return dict(synced=float(rows["synced"].sum()) / trials,
                own=float(rows["own"].sum()) / trials,
                calls=int(tb.shape[0]), trials_per_cell=trials / (tb.shape[1] * tb.shape[2]),
                zero_calls=float((tb.sum((1, 2)) == 0).sum()),
                layouts={c: explicit_layout_costs(tb, chain=c) for c in chains})


def describe_lane_report(rep: dict) -> str:
    text = (f"{rep['calls']} march calls a cell ({rep['zero_calls']:g} without a trial in any "
            f"lane), {rep['trials_per_cell']:.3f} trials a cell; lane-slots per trial synced "
            f"{rep['synced']:.4f}, one cell a lane on its own {rep['own']:.4f}")
    for chain, lays in rep["layouts"].items():
        text += f"; {chain} cell(s) a lane: " + "; ".join(
            f"{name} slots {v['slots']:.4f} passes {v['passes']:.4f} cost "
            + "/".join(f"{c:.4f}" for c in v["cost"].values())
            for name, v in lays.items())
    return text + " (cost at boundary shares " + "/".join(f"{b:g}" for b in LAYOUT_BETAS) + ")"


def explicit_anatomy_report(pt, tag: str, model, data, sp, ems, kernel_ms: dict, trials: dict,
                            card: str, rows: int = 64) -> dict:
    """Phases 4 and 8: the explicit cell's libraries' anatomy (registers,
    stack, LDL/STL, resident blocks, one trial's static mix with its CALL
    and MUFU sites), the issue slots per cell-trial that the measured kernel
    time allows (``kernel_ms`` per dtype over the cell's ``trials``), and the
    lane model from the float64 twin's trials on ``rows`` subjects."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain

    sub = pt.Data(data.subjects()[:rows])
    plan = ode_plan_for(model, sub, sp, ems, torch.float64)
    lib = _build.generated_target(_build.ODE, plan.rhs).path
    anatomy = ode_anatomy(lib)
    for key, a in sorted(anatomy.items()):
        log(f"[{tag}] anatomy {key}: {describe_anatomy(a)}")
    for dtype, ms in kernel_ms.items():
        slots = ms * 1e-3 * H100_CLOCK_HZ * H100_SMS * 128 / trials[dtype]
        log(f"[{tag}] {str(dtype)[6:]}: {slots:.1f} issue slots per cell-trial at "
            f"{ms:.3f} ms ({trials[dtype]} trials; 132 SMs x 128 lanes x 1.98 GHz) ({card})")
    counts = {}
    psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts, **plan.kernel_kwargs())
    rep = explicit_lane_report(torch.stack(counts["trials_by_call"]).cpu().numpy())
    log(f"[{tag}] lane model, the f64 twin on {rows} subjects x {sp.shape[0]}: "
        + describe_lane_report(rep))
    return dict(anatomy=anatomy, lanes=rep)


def phase_stiff_slice(pt, rng) -> tuple:
    """The stiff cell, "ODE TMDD stiff 16384 x 512", through the public
    entry point on the card: bdf and trbdf2 three calls per dtype with fresh
    supports, kvaerno3 and kvaerno5 one call per dtype; each on the fused
    engine with exactly one K2c (bdf) or K2b launch and no other, psi of the
    right shape without NaN, the share of -inf cells printed; float64 held
    within 1e-3 (the tolerance of the JAX package's
    tests/test_stiff.py:212-238), over the supports the fused engine lost no
    cell of, against bdf's general engine on the first STIFF_CHECK_ROWS
    subjects (every solver: the same equations at the same tolerance). Then
    the same call with dopri5 on 256 subjects: how many cells the explicit
    tier loses."""
    n, S = STIFF_SHAPE
    label = f"ode_tmdd_stiff_{n}x{S}"
    data, ems, t_build = tmdd_population(pt, n, np.random.RandomState(SEED + 8))
    supports = [tmdd_support(S, rng) for _ in range(3)]
    models = {solver: tmdd_model(solver) for solver in STIFF_SOLVERS}
    # the main path's run: every launch counted here is one of its calls
    reset_ode_launch_counts()
    results = {}
    for solver in STIFF_SOLVERS:
        calls = supports if solver in ("bdf", "trbdf2") else supports[:1]
        for dtype in (torch.float32, torch.float64):
            pt.set_float_dtype(dtype)
            for j, sp in enumerate(calls):
                before = stiff_launch_counts()
                psi = pt.log_likelihood_matrix(models[solver], data, sp, ems, device="cuda")
                torch.cuda.synchronize()
                dec = pt.last_engine_decision(models[solver])
                if dec["engine"] != "fused":
                    raise AssertionError(f"{label} {solver}: engine {dec}")
                launched = tuple(a - b for a, b in zip(stiff_launch_counts(), before))
                if launched != ((0, 0, 0, 0, 1) if solver == "bdf" else (0, 0, 0, 1, 0)):
                    raise AssertionError(f"{label} {solver}: (K2a, K2e, K2d, K2b, K2c) launches "
                                         f"{launched} in one call")
                if tuple(psi.shape) != (n, S) or psi.device.type != "cuda":
                    raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
                if bool(torch.isnan(psi).any()):
                    raise AssertionError(f"{label} {solver} {dtype}: NaN in psi")
                lost = int(torch.isneginf(psi).sum())
                results[(solver, dtype, j)] = (psi[:STIFF_CHECK_ROWS].clone(), lost)
                del psi
    _, _, _, k2b, k2c = stiff_launch_counts()
    log(f"[14] {label}: {len(results)} log_likelihood_matrix calls on cuda, engine fused, "
        f"{k2b} K2b launches (trbdf2 6, kvaerno3 2, kvaerno5 2), {k2c} K2c launches (bdf 6), "
        f"no K2a, K2e or K2d launch")
    if stiff_launch_counts()[:3] != (0, 0, 0) or (k2b, k2c) != (10, 6):
        raise AssertionError(f"{label}: launches {stiff_launch_counts()}")
    pt.set_float_dtype(torch.float64)

    def general(solver, rows):
        """The oracle: ``solver``'s general engine on the first ``rows``
        subjects, over the supports none of whose cells the fused engine
        lost there (a lost lane keeps the general engine's masked loop
        turning for its whole step budget in every segment: 1392 s where bdf
        lost one support), with its own budget cut to STIFF_ORACLE_MAX_STEPS
        a segment for the same reason; (psi, the supports kept, seconds)."""
        keep = torch.isfinite(results[(solver, torch.float64, 0)][0][:rows]).all(dim=0)
        cols = torch.nonzero(keep).flatten().cpu().numpy()
        oracle = tmdd_model(solver).with_max_steps(STIFF_ORACLE_MAX_STEPS)
        t0 = time.perf_counter()
        want = pt.log_likelihood_matrix(oracle, pt.Data(data.subjects()[:rows]),
                                        supports[0][cols], ems, device="cuda", engine="general")
        torch.cuda.synchronize()
        lost = int((~torch.isfinite(want)).sum())
        if lost > 0.01 * want.numel():
            raise AssertionError(f"{label} {solver}: the general engine lost {lost} of "
                                 f"{want.numel()} cells")
        return want, keep, time.perf_counter() - t0, lost

    def hold(solver, rows, ref, keep_ref, ref_name, extra=""):
        """``solver``'s fused psi on the first ``rows`` subjects against
        ``ref`` (a general engine's, over its supports ``keep_ref``), cells
        finite in both: float64 within 1e-3, float32 printed (the float32
        march is held to the twin)."""
        for dtype in (torch.float32, torch.float64):
            psi, lost = results[(solver, dtype, 0)]
            same = torch.isfinite(psi[:rows]).all(dim=0) & keep_ref
            got, want = psi[:rows, same], ref[:, same[keep_ref]]
            both = torch.isfinite(got) & torch.isfinite(want)
            rel = (got[both].double() - want[both]).abs() / want[both].abs().clamp(min=1.0)
            err, share = float(rel.max()), float((rel <= 1e-3).double().mean())
            log(f"[14] {label} {solver:8s} {str(dtype)[6:]}: {lost} of {n * S} cells -inf "
                f"({lost / (n * S):.2e}); fused vs the f64 {ref_name} general engine on subjects "
                f"0-{rows - 1} x {int(same.sum())} supports: max rel {err:.3e}, {share:.6f} of "
                f"the cells within 1e-3"
                + (f" (<= 1e-3){extra}" if dtype == torch.float64 else
                   " (printed, not held: the float32 march is held to the twin)"))
        if not err <= 1e-3:
            raise AssertionError(f"{label} {solver}: fused vs the {ref_name} general engine "
                                 f"{err} > 1e-3")

    t_oracles = time.perf_counter()
    rows = STIFF_CHECK_ROWS
    want, keep, general_s, oracle_lost = general(STIFF_ORACLE, rows)
    for solver in sorted(STIFF_SOLVERS, key=lambda x: x != STIFF_ORACLE):
        hold(solver, rows, want, keep, STIFF_ORACLE, extra=(
            f"; general engine {general_s:.1f} s there ({STIFF_ORACLE_MAX_STEPS} steps a "
            f"segment), {oracle_lost} of its cells -inf" if solver == STIFF_ORACLE else ""))
    t_oracles = time.perf_counter() - t_oracles
    log(f"[14] cut: the general-engine oracle took {t_oracles:.1f} s, {STIFF_ORACLE}'s on "
        f"{rows} subjects holding all four solvers (trbdf2's and kvaerno3's own on 256 and "
        f"64, kvaerno5 held to kvaerno3's: {BEFORE_CUTS_S['oracles_256'][0]} - "
        f"{BEFORE_CUTS_S['oracles_256'][1]} s): "
        f"{BEFORE_CUTS_S['oracles_256'][0] - t_oracles:.1f} s saved")
    # the explicit tier on the same model
    explicit = tmdd_model("dopri5")
    small = pt.Data(data.subjects()[:256])
    t0 = time.perf_counter()
    psi = pt.log_likelihood_matrix(explicit, small, supports[0], ems, device="cuda")
    torch.cuda.synchronize()
    lost = int(torch.isneginf(psi).sum())
    log(f"[14] {label}: dopri5 (K2a, {explicit._opts.max_steps} steps a segment) on 256 "
        f"subjects loses {lost} of {psi.numel()} cells ({lost / psi.numel():.4f}) in "
        f"{time.perf_counter() - t0:.2f} s")
    return label, models, data, ems, (k2b, k2c), t_build


def phase_stiff_times(pt, label, models, data, ems, t_build, card: str, twins) -> dict:
    """Times at the stiff cell's shape, per solver and dtype: the kernel
    alone (CUDA events); its twin on the subjects ``stiff_twin_rows`` x 512
    supports (the twin's masked Python loop would need minutes at full
    width), held against the kernel's rows there; the twin's time, taken
    here with the card and the host to itself for bdf in float64 (the other
    solvers' and dtypes' is their worker's, contended, and says so); the bound from the twin's counts per row scaled
    to the cell (``scaled_to_cell``): for the SDIRK solvers the attempts
    times the operations of one trial, for bdf the trials, accepts,
    adaptations and rescalings, each priced at its order (``bdf_ops``); one
    end-to-end call with its parts; and, for bdf, the order cap 3 against
    cap 5: attempts per cell, -inf cells and kernel time."""
    from pharmsol_tpu_torch.ops import _build, fused_ode
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET

    n, S = STIFF_SHAPE
    row_ids = stiff_twin_rows(n)
    rows = torch.as_tensor(row_ids, device="cuda")
    where = f"{len(row_ids)}x{S} (subjects {', '.join(str(i) for i in row_ids)})"
    twin_data = pt.Data([data.subjects()[int(i)] for i in row_ids])
    cells = n * S
    budget = F32_BUDGET["ode_bdf"]
    sp = tmdd_support(S, np.random.RandomState(SEED + 7))
    out = {}

    def held(tag, dtype, got, twin, twin64):
        """(abs err, rel err) of the kernel's rows ``row_ids`` against the twin."""
        got = got[rows]
        if dtype == torch.float64:
            rel, share = compare_stiff(tag, got, twin)
            ok = torch.isfinite(twin)
            return float((got - twin)[ok].abs().max()), rel, f"{share:.4f} within 1e-8"
        rel, note = hold_f32(tag, got, twin64, budget, lambda: twin)
        if note:
            log(f"[15] {tag}{note}")
        ok = torch.isfinite(twin64) & torch.isfinite(got)
        return (float((got.double() - twin64)[ok].abs().max()), rel,
                f"<= ode_bdf {budget:g} of the f64 twin")

    for solver in STIFF_SOLVERS:
        model = models[solver]
        newton_iters = model._opts.newton_iters
        twin64 = twin5_64 = None
        for dtype in (torch.float64, torch.float32):
            pt.set_float_dtype(dtype)
            d = str(dtype)[6:]
            plan = ode_plan_for(model, data, sp, ems, dtype)
            kw = plan.kernel_kwargs()
            got = run_ode_kernel(plan)
            tw = twins.get("cell", "tmdd", solver, True, d, 3)
            lib = _build.generated_target(_build.ode_kind(solver), plan.rhs).path
            if dtype == torch.float64:
                # the anatomy of the solver's library: every instantiation
                out[(solver, "anatomy")] = anatomy = ode_anatomy(lib)
                for key, a in sorted(anatomy.items()):
                    log(f"[15] anatomy {key}: {describe_anatomy(a)}  ({card})")
            query = fused_ode.implicit_occupancy_of(lib)
            lanes = None if query is None else fused_ode.implicit_lanes(
                cells, query(dtype == torch.float64, False, 3) * torch.cuda.get_device_properties(
                    0).multi_processor_count)
            slots = stiff_lane_slots(tw["trials_by_call"], n, lanes)
            log(f"[15] {label} {solver:8s} {d} lane-slots per trial, from the twin's trials by "
                f"march call on {where} scaled to the cell: synced at every march call (the "
                f"parent's layout) {slots['synced']:.4f}, one cell a lane on its own "
                f"{slots['own']:.4f}, "
                + ("persistent grid: this library has no occupancy query" if lanes is None else
                   f"the persistent grid of {lanes} lanes {slots['refilled']:.4f}"))
            if dtype == torch.float64:
                twin64 = tw["psi"]
            abs_err, rel, rule = held(f"{label} {solver} {d}", dtype, got, tw["psi"], twin64)
            attempts = int(scaled_to_cell(tw["steps_by_row"], n))
            twin_ms = None
            if solver == "bdf" and dtype == torch.float64:
                # the twin again, alone on the card and the host
                t_alone = time.perf_counter()
                twin_plan = ode_plan_for(model, twin_data, sp, ems, dtype)
                _, twin_ms = event_ms(lambda: psi_ode_plain(
                    *twin_plan.streams, twin_plan.support, twin_plan.rhs,
                    **twin_plan.kernel_kwargs()))
                t_alone = time.perf_counter() - t_alone
                log(f"[15] cut: the twins timed alone took {t_alone:.1f} s, bdf in float64 "
                    f"only (before the cut, bdf and trbdf2 in both dtypes: "
                    f"{BEFORE_CUTS_S['twins_alone']} s): "
                    f"{BEFORE_CUTS_S['twins_alone'] - t_alone:.1f} s saved")
            t = {
                "kernel": cuda_ms(lambda: run_ode_kernel(plan), 3, 1),
                "twin": twin_ms,
                "twin_in_worker": tw["ms"],
                "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                    model, data, sp, ems, device="cuda"), 3),
            }
            parts = ode_end_to_end_parts(model, data, sp, ems, dtype, plan)
            nbytes = plan_bytes(plan, kw, n, S)
            if solver == "bdf":
                tally = scaled_to_cell(tw["bdf_by_row"], n)
                ops = bdf_ops(model, newton_iters, tally)
                made_of = ("trials by order " + "/".join(str(int(v)) for v in tally[0, 1:])
                           + ", accepts " + str(int(tally[1].sum()))
                           + ", adaptations " + str(int(tally[2].sum()))
                           + ", clip rescalings by order "
                           + "/".join(str(int(v)) for v in tally[3, 1:])
                           + ", factor rescalings by order "
                           + "/".join(str(int(v)) for v in tally[4, 1:])
                           + f", each priced at its order: {ops / attempts:.1f} a trial")
                if int(tally[0].sum()) != attempts:
                    raise AssertionError(f"{label} bdf: the tally holds {int(tally[0].sum())} "
                                         f"trials, the attempts are {attempts}")
            else:
                trial_ops = sdirk_trial_ops(model, solver, newton_iters)
                ops = attempts * trial_ops
                made_of = f"{attempts} attempts x {trial_ops}"
            t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
            lost = int((~torch.isfinite(got)).sum())
            log(f"[15] {label} {solver:8s} {d} kernel     {t['kernel']:10.3f} ms  "
                f"{cells / (t['kernel'] * 1e-3):.4g} cells/s; {attempts / cells:.1f} attempts/cell; "
                f"{lost} cells lost  ({card})")
            alone = "not timed alone" if twin_ms is None else f"{twin_ms:.3f} ms alone"
            log(f"[15] {label} {solver:8s} {d} twin       {alone}, {tw['ms']:.3f} ms in its "
                f"worker beside four others and the build (contended), at {where}; kernel "
                f"rows there vs twin: max abs {abs_err:.3e}, rel {rel:.3e}, {rule}  ({card})")
            log(f"[15] {label} {solver:8s} {d} end_to_end {t['end_to_end']:10.3f} ms  "
                f"{cells / (t['end_to_end'] * 1e-3):.4g} cells/s; parts (ms): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in parts.items())
                + f"; kernel+finalize share {(t['kernel'] + parts['finalize']) / t['end_to_end']:.4f}"
                f", plan {parts['plan'] / t['end_to_end']:.4f}  ({card})")
            log(f"[15] {label} {solver:8s} {d} bound {t['bound']:.5g} ms by {t['bound_by']} "
                f"({nbytes / 1e6:.2f} MB; {ops / 1e9:.3f} G operations: {made_of}; counts "
                f"scaled from the twin's {len(row_ids)} subjects to {n}); kernel at "
                f"{t['bound'] / t['kernel']:.3f} of it")
            t.update(abs_err=abs_err, plan=parts["plan"], attempts_scaled=attempts, lost=lost,
                     operations=ops, lane_slots=slots, lanes=lanes)
            out[(solver, dtype)] = t
            if solver == "bdf":
                # the order cap: 3 (the default, the JAX kernel's) against 5
                plan5 = ode_plan_for_cap(model, data, sp, ems, dtype, 5)
                got5 = run_ode_kernel(plan5)
                tw5 = twins.get("cell", "tmdd", solver, True, d, 5)
                if dtype == torch.float64:
                    twin5_64 = tw5["psi"]
                held(f"{label} bdf cap 5 {d}", dtype, got5, tw5["psi"], twin5_64)
                ms5 = cuda_ms(lambda: run_ode_kernel(plan5), 3, 1)
                a5 = int(scaled_to_cell(tw5["steps_by_row"], n))
                lost5 = int((~torch.isfinite(got5)).sum())
                both = torch.isfinite(got5) & torch.isfinite(got)
                log(f"[15] {label} bdf {d} order cap 3: {attempts / cells:.1f} attempts/cell, "
                    f"{lost} cells -inf, {t['kernel']:.3f} ms; cap 5: {a5 / cells:.1f} "
                    f"attempts/cell, {lost5} cells -inf, {ms5:.3f} ms; psi cap 5 vs cap 3 rel "
                    f"{rel_err(got5[both], got[both], 1.0):.3e}  ({card})")
                t.update(cap5_ms=ms5, cap5_attempts_scaled=a5, cap5_lost=lost5)
                del got5
            del got
    models["bdf"]._lower_cache.clear()
    t0 = time.perf_counter()
    models["bdf"].lower(data.subjects())
    log(f"[15] {label} host: subject builder {t_build * 1e3:.1f} ms, lowering "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({n} subjects)")
    return out


def ode_plan_for_cap(model, data, support, ems, dtype, cap: int):
    from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, support, lowered, torch.device("cuda"), dtype,
                            bdf_max_order=cap)


def stiff_records(times, launches) -> list:
    """K2b's and K2c's entries of the kernels line: K2b's times are
    trbdf2's (kvaerno3 and kvaerno5 beside them), K2c's are bdf's.
    ``plain_ms`` is the twin alone on the card, ``plain_ms_in_worker`` its
    contended time; ``attempts_scaled`` and ``operations`` are the twin's
    counts on ``plain_rows`` scaled to the cell, not a count in the kernel."""
    k2b, k2c = launches

    def entry(record, solver, count):
        t32, t64 = times[(solver, torch.float32)], times[(solver, torch.float64)]
        return dict(
            record, launches=count, max_abs_err=t64["abs_err"],
            max_abs_err_f32=t32["abs_err"], ms=t32["kernel"], plain_ms=t32["twin"],
            bound_ms=t32["bound"], bound_by=t32["bound_by"], library_ms=None,
            ms_f64=t64["kernel"], plain_ms_f64=t64["twin"], bound_ms_f64=t64["bound"],
            plain_ms_in_worker=t32["twin_in_worker"],
            plain_ms_in_worker_f64=t64["twin_in_worker"],
            shape="ode_tmdd_stiff_{}x{}".format(*STIFF_SHAPE),
            plain_shape="{}x{}".format(STIFF_TWIN_ROWS, STIFF_SHAPE[1]),
            plain_rows=[int(i) for i in stiff_twin_rows(STIFF_SHAPE[0])], solver=solver,
            end_to_end_ms=t32["end_to_end"], end_to_end_ms_f64=t64["end_to_end"],
            plan_ms=t32["plan"], plan_ms_f64=t64["plan"],
            attempts_scaled=t32["attempts_scaled"], attempts_scaled_f64=t64["attempts_scaled"],
            operations=t32["operations"], operations_f64=t64["operations"],
            lost_cells=t32["lost"], lost_cells_f64=t64["lost"],
            lane_slots=t32["lane_slots"], lane_slots_f64=t64["lane_slots"])

    b = entry(STIFF_SDIRK_RECORD, "trbdf2", k2b)
    b["solvers"] = {
        s: {str(dt)[6:]: {k: v for k, v in times[(s, dt)].items() if k != "bound_by"}
            for dt in (torch.float32, torch.float64)}
        for s in ("trbdf2", "kvaerno3", "kvaerno5")}
    b["anatomy"] = {s: times[(s, "anatomy")] for s in ("trbdf2", "kvaerno3", "kvaerno5")}
    c = entry(STIFF_BDF_RECORD, "bdf", k2c)
    c["anatomy"] = times[("bdf", "anatomy")]
    for dt, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        for k in ("cap5_ms", "cap5_attempts_scaled", "cap5_lost"):
            c[k + suffix] = times[("bdf", dt)][k]
    return [b, c]


def run_stiff_slice(pt, rng, cases, card: str, twins) -> list:
    """This slice's phases: K2b and K2c against their twins, the stiff cell
    through the entry point, and its times. Returns the two records."""
    phase_stiff_kernels(pt, cases, twins)
    torch.cuda.synchronize()
    label, models, data, ems, launches, t_build = phase_stiff_slice(pt, rng)
    times = phase_stiff_times(pt, label, models, data, ems, t_build, card, twins)
    torch.cuda.synchronize()
    return stiff_records(times, launches)


# ---------------------------------------------------------------------------
# K3b: SDE models with covariates, lag, fa and init; K1c: the rest of the
# closed-form feature tier
# ---------------------------------------------------------------------------


def sde_has_features(plan) -> bool:
    """Whether an SDE plan runs the feature tier (K3b) or the base (K3a)."""
    f = plan.features
    return bool(f["cov_streams"]) or any(f[k] is not None for k in
                                         ("lag_planes", "fa_planes", "init_planes"))


def sde_feature_build_targets(pt):
    """The SDE library of each K3b check case and of the K3b cell, each of
    the tier its plan runs (ops/_build.py::sde_kind)."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.utils.f32_budget import (
        SDE_FEATURE_CASES, sde_covariate_model_case, sde_feature_case,
    )

    targets = {}
    cases = [(name, sde_feature_case(name, *SDE_REDUCED, nparticles=SDE_PARTICLES))
             for name in SDE_FEATURE_CASES]
    cases.append(("covariates cell", sde_covariate_model_case(4, 4, seed=SEED)))
    for name, (model, data, sp, ems) in cases:
        plan = sde_plan_for(model, data, sp, ems, torch.float64)
        kind = _build.sde_kind(sde_has_features(plan))
        target = _build.generated_target(kind, plan.gen)
        targets.setdefault(target.path, (f"{name}{' (K3b)' if kind is not _build.SDE else ''}",
                                         target))
    return list(targets.values())


def sde_launch_counts():
    from pharmsol_tpu_torch.ops import fused_sde

    return fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES


def phase_sde_feature_kernels(pt) -> dict:
    """K3b against its twin on the card at the ragged reduced shape on every
    mode of ``utils/f32_budget.py::SDE_FEATURE_CASES`` (a constant and an
    affine covariate, static lag, fa, lag with fa, a dynamic lag/fa through
    slot tables, init rows (K3a's own input), covariate-dependent init planes,
    two inputs with an inject-to-destination route and a lag each), 1000
    particles: at zero diffusion float64 every cell within 1e-10; with noise
    float64 99.9% within 1e-9 and float32 99% within 1e-4 (both draw the same
    Philox numbers); each call one launch of the tier the plan takes."""
    from pharmsol_tpu_torch.utils.f32_budget import SDE_FEATURE_CASES, sde_feature_case

    R, S = SDE_REDUCED
    worst = {}
    for name in SDE_FEATURE_CASES:
        for sigma, dtype, tol, share in ((False, torch.float64, 1e-10, 1.0),
                                         (True, torch.float64, 1e-9, 0.999),
                                         (True, torch.float32, 1e-4, 0.99)):
            model, data, sp, ems = sde_feature_case(name, R, S, seed=SEED,
                                                    nparticles=SDE_PARTICLES, sigma=sigma)
            plan = sde_plan_for(model, data, sp, ems, dtype)
            feat = sde_has_features(plan)
            before = sde_launch_counts()
            got = run_sde_kernel(plan)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(sde_launch_counts(), before))
            if launched != ((0, 1) if feat else (1, 0)):
                raise AssertionError(f"K3b {name}: (K3a, K3b) launches {launched}")
            twin = run_sde_kernel(plan, plain=True)
            tag = (f"{'K3b' if feat else 'K3a'} {name} {'sigma' if sigma else 'sigma=0'} "
                   f"{R}x{S}x{SDE_PARTICLES} {str(dtype)[6:]} vs twin")
            abs_err, _ = sde_compare(tag, got, twin, tol, share, phase=16)
            key = (dtype, sigma)
            worst[key] = max(worst.get(key, 0.0), abs_err)
    return worst


def sde_trials_scaled(by_row, n_total: int) -> float:
    """The cell's Euler-Maruyama cell trials estimated from the twin's per row
    on the spread subjects: their mean times the cell's subjects (each
    subject's covariates and observations are its own draws, so unlike the
    stiff cell's dose classes no subject stands for a class exactly)."""
    return float(np.mean(np.asarray(by_row, dtype=np.float64))) * n_total


def spread_rows(n: int, k: int) -> np.ndarray:
    """``k`` subjects spread evenly over ``n``, the last among them."""
    return np.linspace(0, n - 1, k).astype(np.int64)


def phase_sde_feature_slice(pt, rng):
    """"SDE covariates 256 x 64 x 1000", the K3b cell: the reference's
    covariate model as an SDE through the public entry point, float32 and
    float64, three calls each with fresh supports, each taking the fused
    engine with exactly one K3b launch and no K3a launch, psi finite and of
    the right shape."""
    from pharmsol_tpu_torch.ops import fused_sde
    from pharmsol_tpu_torch.utils.f32_budget import sde_covariate_model_case

    R, S = SDE_COV_FULL
    label = f"sde_covariates_{R}x{S}x{SDE_PARTICLES}"
    t0 = time.perf_counter()
    model, data, _, ems = sde_covariate_model_case(R, 1, seed=SEED)
    t_build = time.perf_counter() - t0
    supports = [sde_covariate_model_case(1, S, seed=SEED + 10 + j)[2] for j in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_sde.LAUNCHES = fused_sde.FEATURE_LAUNCHES = 0
    calls = 0
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = sde_launch_counts()
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            calls += 1
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            launched = tuple(a - b for a, b in zip(sde_launch_counts(), before))
            if launched != (0, 1):
                raise AssertionError(f"{label}: (K3a, K3b) launches {launched} in one call")
            if tuple(psi.shape) != (R, S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            bad = int((~torch.isfinite(psi)).sum())
            if bad:
                raise AssertionError(f"{label} {dtype}: {bad} non-finite psi cells")
            log(f"[17] {label} {str(dtype)[6:]}: psi mean {float(psi.double().mean()):.6f}, "
                f"all {psi.numel()} cells finite")
    launches = fused_sde.FEATURE_LAUNCHES
    log(f"[17] K3b main path: {calls} log_likelihood_matrix calls on cuda, engine fused, "
        f"{launches} K3b launches, {fused_sde.LAUNCHES} K3a launches (subject builder "
        f"{t_build * 1e3:.1f} ms)")
    return label, model, data, ems, launches


def sde_covariate_model_case_support(S: int, seed: int = SEED + 20) -> np.ndarray:
    """Supports of the K3b cell's model (drawn as its case draws them)."""
    from pharmsol_tpu_torch.utils.f32_budget import sde_covariate_model_case

    return sde_covariate_model_case(1, S, seed=seed)[2]


def sde_twin_rows_check(pt, model, data, sp, ems, dtype, tag, tol, share, phase: int):
    """The kernel and the twin on ``SDE_TWIN_ROWS`` subjects spread over the
    cell x all its supports (the same Philox counters: the rows are the
    sub-population's): (twin ms, trials per row, kernel-vs-twin abs err)."""
    from pharmsol_tpu_torch.ops.fused_sde import psi_sde_plain

    rows = spread_rows(len(data), SDE_TWIN_ROWS)
    sub = pt.Data([data.subjects()[int(i)] for i in rows])
    plan = sde_plan_for(model, sub, sp, ems, dtype)
    got = run_sde_kernel(plan)
    counts = {}
    kw = plan.kernel_kwargs()
    twin, twin_ms = event_ms(lambda: psi_sde_plain(*plan.streams, plan.support, plan.gen,
                                                   counts=counts, **kw))
    abs_err, _ = sde_compare(f"{tag} on subjects {', '.join(str(i) for i in rows)} x "
                             f"{sp.shape[0]} vs twin", got, twin, tol, share, phase=phase)
    return twin_ms, counts["trials_by_row"].double().cpu().numpy(), abs_err


def phase_sde_feature_times(pt, label, model, data, ems, card: str) -> dict:
    """K3b alone at full width, the twin and the kernel on the spread rows
    (held to each other), the general engine there (float64), one end-to-end
    call with its parts and the plan's share, and the bound from the twin's
    trials per row scaled to the cell."""
    from pharmsol_tpu_torch.utils.f32_budget import sde_covariate_model_case

    R, S = SDE_COV_FULL
    sp = sde_covariate_model_case(1, S, seed=SEED + 20)[2]
    cells = R * S
    out = {}
    for dtype, tol, share in ((torch.float64, 1e-9, 0.999), (torch.float32, 1e-4, 0.99)):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        plan = sde_plan_for(model, data, sp, ems, dtype)
        # one run, the kernel warm from phase 17
        kernel = cuda_ms(lambda: run_sde_kernel(plan), 1, 0)
        twin_ms, by_row, abs_err = sde_twin_rows_check(pt, model, data, sp, ems, dtype,
                                                       f"K3b {label} {d}", tol, share, 18)
        trials = sde_trials_scaled(by_row, R)
        e2e = wall_ms(lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda"), 1, 0)
        psi_rows = run_sde_kernel(plan)
        parts = {
            "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 3),
            "plan": wall_ms(lambda: sde_plan_for(model, data, sp, ems, dtype), 3),
            "finalize": cuda_ms(lambda: plan.finalize(psi_rows), 10),
        }
        nbytes = plan_bytes(plan, plan.kernel_kwargs(), R, S)
        b = sde_bounds(nbytes, trials * SDE_PARTICLES, model, dtype,
                       plan.em_control == "coupled", plan.cov_names)
        b_ms, b_by = b["bound"], b["bound_by"]
        general = None
        if dtype == torch.float64:
            rows = spread_rows(R, SDE_TWIN_ROWS)
            sub = pt.Data([data.subjects()[int(i)] for i in rows])
            _, general = event_ms(lambda: pt.log_likelihood_matrix(
                model, sub, sp, ems, device="cuda", engine="general"))
        log(f"[18] {label} {d} kernel {kernel:10.3f} ms  {cells / (kernel * 1e-3):.4g} "
            f"cells/s  ({card})")
        log(f"[18] {label} {d} twin {twin_ms:.3f} ms on {SDE_TWIN_ROWS} subjects x {S}"
            + (f"; general engine {general:.3f} ms there" if general is not None else "")
            + f"  ({card})")
        log(f"[18] {label} {d} end_to_end {e2e:10.3f} ms; parts (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items())
            + f"; kernel share {kernel / e2e:.4f}, plan share {parts['plan'] / e2e:.4f} "
            f"({card})")
        log(f"[18] {label} {d} K3b bound {b_ms:.5g} ms by {b_by} ({nbytes / 1e6:.3f} MB, "
            f"{trials:.0f} cell trials estimated from the twin's {SDE_TWIN_ROWS} subjects, "
            f"{b['ops'] / 1e9:.3f} G floating-point and {b['int_ops'] / 1e9:.3f} G integer "
            f"operations; floating point alone {b['bound_float']:.5g} ms); kernel at "
            f"{b_ms / kernel:.4f} of it ({b['bound_float'] / kernel:.4f} of the float bound)")
        out[dtype] = dict(kernel=kernel, twin=twin_ms, general=general, end_to_end=e2e,
                          plan=parts["plan"], bound=b_ms, bound_by=b_by, abs_err=abs_err,
                          trials=trials, bound_float=b["bound_float"])
    return out


def sde_bound_twin_job(job) -> dict:
    """Phase 7's float64 twin on ``SDE_TWIN_ROWS`` spread subjects of the
    README cell x its supports, in a worker process of :class:`StiffTwins`
    while the libraries build (the masked loop is host-paced, about 50 s);
    the inputs rebuilt from phase 6's and 7's seeds. Returns psi, the trials
    per row and the twin's time (contended)."""
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops.fused_sde import psi_sde_plain

    pt.set_float_dtype(torch.float64)
    plan = sde_bound_plan(pt, readme_sde(pt),
                          readme_data(pt, SDE_FULL[0], np.random.RandomState(SEED + 6)))
    counts = {}
    psi, ms = event_ms(lambda: psi_sde_plain(*plan.streams, plan.support, plan.gen,
                                             counts=counts, **plan.kernel_kwargs()))
    return dict(psi=psi.cpu().numpy(), ms=ms,
                trials_by_row=counts["trials_by_row"].double().cpu().numpy())


SDE_BOUND_JOB = ("sde_bound", "readme", "", True, "float64", 3)


def sde_bound_plan(pt, model, data):
    """The float64 plan of phase 7's twin: the cell's ``SDE_TWIN_ROWS``
    spread subjects x its supports."""
    rows = spread_rows(len(data), SDE_TWIN_ROWS)
    sub = pt.Data([data.subjects()[int(i)] for i in rows])
    return sde_plan_for(model, sub, readme_support(SDE_FULL[1], np.random.RandomState(SEED + 5)),
                        readme_ems(pt), torch.float64)


def phase_sde_full_bound(pt, model, data, card: str, twins=None) -> dict:
    """K3a's bound at the README cell's full width: the twin's trials on
    ``SDE_TWIN_ROWS`` spread subjects x all supports (float64, kernel and
    twin held to each other there), scaled to the cell; both dtypes priced
    on those counts. With ``twins`` the twin comes from its worker process
    (``SDE_BOUND_JOB``), else it runs here."""
    R, S = SDE_FULL
    ems = readme_ems(pt)
    sp = readme_support(S, np.random.RandomState(SEED + 5))
    pt.set_float_dtype(torch.float64)
    if twins is None:
        twin_ms, by_row, _ = sde_twin_rows_check(pt, model, data, sp, ems, torch.float64,
                                                 "K3a readme f64", 1e-9, 0.999, 7)
    else:
        t0 = time.perf_counter()
        res = twins.get(*SDE_BOUND_JOB)
        plan = sde_bound_plan(pt, model, data)
        sde_compare(f"K3a readme f64 on subjects "
                    f"{', '.join(str(i) for i in spread_rows(len(data), SDE_TWIN_ROWS))} x {S} "
                    "vs twin (its worker's)", run_sde_kernel(plan), res["psi"], 1e-9, 0.999, 7)
        twin_ms, by_row = res["ms"], res["trials_by_row"]
        log(f"[7] cut: the bound's twin ran in a worker process beside the build ({twin_ms:.1f} "
            f"ms there, contended); here {time.perf_counter() - t0:.1f} s (before the cut, "
            f"here: {BEFORE_CUTS_S['sde_bound_twin']} s)")
    trials = sde_trials_scaled(by_row, R)
    out = {}
    for dtype in (torch.float32, torch.float64):
        plan = sde_plan_for(model, data, sp, ems, dtype)
        b = sde_bounds(plan_bytes(plan, plan.kernel_kwargs(), R, S), trials * SDE_PARTICLES,
                       model, dtype, plan.em_control == "coupled")
        out[dtype] = dict(b, trials=trials)
        log(f"[7] K3a bound at {R}x{S}x{SDE_PARTICLES} {str(dtype)[6:]}: {b['bound']:.5g} ms "
            f"by {b['bound_by']} ({trials:.0f} cell trials estimated from the float64 twin's "
            f"{SDE_TWIN_ROWS} subjects, {b['ops'] / 1e9:.3f} G floating-point and "
            f"{b['int_ops'] / 1e9:.3f} G integer operations; floating point alone "
            f"{b['bound_float']:.5g} ms; twin {twin_ms:.3f} ms there)  ({card})")
    return out


def phase_sde_anatomy(pt, kernel_id: str, plan, times: dict, trials: dict, card: str,
                      phase: int) -> dict:
    """What holds the SDE kernel at the cell's width, for its four-particles-
    a-thread instantiations: registers and spills, resident blocks per SM (the
    CUDA runtime's count, and the count from the registers beside it), the
    trial loop's static instruction mix per particle-trial, and the share of
    the card's issue rate that loop reaches in the measured kernel time
    (``times``, ``trials``: ms and cell trials per dtype)."""
    from pharmsol_tpu_torch.ops import _build, fused_sde

    feature = kernel_id == "K3b"
    lib = _build.generated_target(_build.sde_kind(feature), plan.gen).path
    found = sde_anatomy(lib, plan.gen.n_states, SDE_PARTICLES)
    out = {}
    for dtype in (torch.float32, torch.float64):
        d = f"f{'32' if dtype == torch.float32 else '64'}"
        a = found.get(f"{kernel_id} {d} 4")
        if a is None:
            raise AssertionError(f"{kernel_id} {d}: no four-particles-a-thread kernel in {lib}")
        a["blocks_per_sm_runtime"] = fused_sde.resident_blocks(plan.gen, dtype, SDE_PARTICLES,
                                                               feature)
        loop = a["loop"]
        if loop is not None:
            a["issue_share"] = issue_share(loop["hot"]["total"], trials[dtype], times[dtype])
        mix = a["per_particle_trial"] or {}
        log(f"[{phase}] {kernel_id} {d} 4 particles/thread: {a['regs']} registers, "
            f"a {a['stack']}-byte stack frame, {a['blocks_per_sm_runtime']} resident blocks "
            f"per SM ({a['blocks_per_sm']} from the registers); trial loop "
            + (f"{loop['all']['total']} instructions laid out ({loop['loop_bytes']} bytes), "
               f"{loop['hot']['total']} without the inlined cold paths; per particle-trial: "
               if loop else "not found; ")
            + ", ".join(f"{k} {v:g}" for k, v in sorted(mix.items()))
            + (f"; issue share {a['issue_share']:.3f} of 4 warp-instructions a clock on "
               f"{H100_SMS} SMs at {H100_CLOCK_HZ / 1e9:.2f} GHz" if "issue_share" in a else "")
            + f"  ({card})")
        out[d] = a
    return out


def k1c_launch_counts():
    from pharmsol_tpu_torch.ops import fused_psi

    return fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES, fused_psi.K1C_LAUNCHES


def phase_k1c_kernels(pt) -> float:
    """K1c against its twin at 257 x 300 on every case of
    ``utils/f32_budget.py::K1C_CASES`` (lag_depth with levels and planes,
    zero-lag lanes, lag_post with a static and a dynamic lag, a time-dependent
    lag and fa, fa alone, a 3-compartment case): float64 every cell within
    1e-10 relative, float32 against the float64 twin within the case's row
    (``lag_seq_depth``, ``seq_colplanes``, or the structure's); each call one
    K1c launch."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, K1C_CASES, f32_error, k1c_case

    R, S = K1C_RAGGED
    worst = 0.0
    for name, row in K1C_CASES.items():
        model, data, sp, ems = k1c_case(name, R, S, seed=SEED)
        got, twin = {}, {}
        for dtype in (torch.float64, torch.float32):
            plan = plan_for(pt, model, data, sp, ems, dtype)
            before = k1c_launch_counts()
            got[dtype] = run_kernel(plan)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(k1c_launch_counts(), before))
            if launched != (0, 0, 1):
                raise AssertionError(f"K1c {name}: (K1a, K1b, K1c) launches {launched}")
            twin[dtype] = run_kernel(plan, plain=True)
        rel = rel_err(got[torch.float64], twin[torch.float64], 1.0)
        abs_err = float((got[torch.float64] - twin[torch.float64]).abs().max())
        e32 = f32_error(got[torch.float32].double().cpu().numpy(),
                        twin[torch.float64].cpu().numpy())
        log(f"[19] K1c {name:17s} {R}x{S} f64 kernel vs twin rel {rel:.3e} (<= 1e-10), abs "
            f"{abs_err:.3e}; f32 kernel vs f64 twin {e32:.3e} (<= {row} {F32_BUDGET[row]:g}); "
            f"mode {plan.mode}, inputs "
            + ", ".join(k for k, v in plan.features.items() if v is not None))
        if not rel <= 1e-10 or not e32 <= F32_BUDGET[row]:
            raise AssertionError(f"K1c {name}: f64 {rel}, f32 {e32}")
        worst = max(worst, abs_err)
    return worst


def k1c_workloads(pt, rng):
    """The two K1c cells, as ``feature_workloads``: (label, model, data,
    centre, S, mode, budget row, rows of the general-engine check, builder
    s)."""
    out = []
    # "lag-depth Short": JAX tests/test_pallas_psi.py:1367-1386, the 2-cmt
    # oral model whose seq compounds across the end of the 1.5 h infusion
    # while a lag and an fa act on the doses (lag_depth), on the regimen of
    # _lag_depth_subjects (a bolus at 0 and the infusion at 1 h), widened
    n, S = K1C_DEPTH_SHAPE
    t0 = time.perf_counter()
    model, data = lag_depth_cell(pt, rng, n)
    t_build = time.perf_counter() - t0
    out.append((f"lag_depth_2cmt_oral_{n}x{S}", model, data,
                LAG_DEPTH_CENTRE, S, "levels", "lag_seq_depth",
                min(n, K1C_CHECK_ROWS), t_build))
    # "dynamic-lag creatinine": the time-varying creatinine 10 000 x 1000 cell
    # of feature_workloads (knots at 0 and 24 h), with the creatinine read by
    # the lag, and a bioavailability: per-dose-segment lag and fa planes
    # (lag_slots, fa_slots). Its seq stays out: with it the lag would need
    # lag_post's column planes, which at this width pass _MAX_PLANE_FLOATS
    # (phase 20 runs lag_post at the widest population the cap admits)
    n, S = K1C_DYN_SHAPE
    crcl0 = rng.uniform(40.0, 140.0, n)
    crcl24 = crcl0 * rng.uniform(0.7, 1.3, n)
    t0 = time.perf_counter()
    data = short_subjects(pt, n, rng, covariates=lambda i, b: b.covariate(
        "crcl", 0.0, crcl0[i]).covariate("crcl", 24.0, crcl24[i]))
    t_build = time.perf_counter() - t0
    model = pt.Analytical(
        pt.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
        lag=lambda p, t, cov: {0: p[3] * cov("crcl", t) / 100.0},
        fa=lambda p, t, cov: {0: p[4]}, nstates=2, ndrugs=1, nout=1)
    out.append((f"dyn_lag_crcl_1cmt_oral_{n}x{S}", model, data, [1.2, 0.2, 30.0, 0.5, 0.8], S,
                None, "one_compartment_with_absorption", min(n, K1C_CHECK_ROWS), t_build))
    return out


def phase_k1c_slice(pt, rng, workload, ems) -> int:
    """One K1c cell through the public entry point: three calls in float32
    and three in float64 with fresh supports, each on the fused engine with
    exactly one K1c launch and no K1a or K1b launch, psi finite and of the
    right shape; held against the general engine on the card on its first
    ``rows`` subjects: float64 within 1e-10 relative, float32 against the
    float64 general engine within the cell's budget row."""
    from pharmsol_tpu_torch.ops import fused_psi
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    label, model, data, centre, S, mode, row, rows, _ = workload
    supports = [jittered_support(centre, S, rng, 0.2) for _ in range(3)]
    # the main path's run: every launch counted here is one of its calls
    fused_psi.LAUNCHES = fused_psi.FEATURE_LAUNCHES = fused_psi.K1C_LAUNCHES = 0
    results = []
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for sp in supports:
            before = k1c_launch_counts()
            psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
            torch.cuda.synchronize()
            dec = pt.last_engine_decision(model)
            if dec["engine"] != "fused":
                raise AssertionError(f"{label}: engine {dec}")
            launched = tuple(a - b for a, b in zip(k1c_launch_counts(), before))
            if launched != (0, 0, 1):
                raise AssertionError(f"{label}: (K1a, K1b, K1c) launches {launched}")
            if tuple(psi.shape) != (len(data), S) or psi.device.type != "cuda":
                raise AssertionError(f"{label}: psi {tuple(psi.shape)} on {psi.device}")
            bad = int((~torch.isfinite(psi)).sum())
            if bad:
                raise AssertionError(f"{label} {dtype}: {bad} non-finite psi cells")
            results.append((dtype, sp, psi))
    launches = fused_psi.K1C_LAUNCHES
    log(f"[20] {label}: {len(results)} log_likelihood_matrix calls on cuda, engine fused, "
        f"{launches} K1c launches, {fused_psi.FEATURE_LAUNCHES} K1b, {fused_psi.LAUNCHES} K1a")
    plan = plan_for(pt, model, data, supports[0], ems, torch.float64)
    if plan.mode != mode:
        raise AssertionError(f"{label}: plan mode {plan.mode}, expected {mode}")
    log(f"[20] {label}: K1c mode {plan.mode}, inputs "
        + ", ".join(k for k, v in plan.features.items() if v is not None))
    sub = pt.Data(data.subjects()[:rows])
    pt.set_float_dtype(torch.float64)
    wants = [pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
             for sp in supports]
    torch.cuda.synchronize()
    for j, (dtype, sp, psi) in enumerate(results):
        want = wants[j % 3]
        if dtype == torch.float64:
            err, tol, what = rel_err(psi[:rows], want, 1.0), 1e-10, "rel"
        else:
            err = f32_error(psi[:rows].double().cpu().numpy(), want.cpu().numpy())
            tol, what = F32_BUDGET[row], f"f32 vs f64 general ({row})"
        log(f"[20] {label} {str(dtype)[6:]}: fused vs general on subjects 0-{rows - 1} "
            f"{what} {err:.3e} (<= {tol:g}); psi mean {float(psi.double().mean()):.6f}")
        if not err <= tol:
            raise AssertionError(f"{label} {dtype}: fused vs general {err} > {tol}")
    return launches


def lag_post_cell(pt, rng):
    """The lag_post cell (lag with a time-varying seq, K1c in planes mode):
    the Covariate Short model, its weight with a second knot at 6 h so that
    its seq varies in time, at the widest population
    ``plans/seq.py::_MAX_PLANE_FLOATS`` admits at ``K1C_POST_S`` supports:
    (label, model, data, support, ems, the number of columns)."""
    from pharmsol_tpu_torch.likelihood.plans.seq import _MAX_PLANE_FLOATS

    S = K1C_POST_S
    M = 1 + len(SHORT_TIMES)  # the dose and the observations
    n_base, n_cols = 5, 7
    # the column planes' caps: M x n_base x R x S, and the lane walk's
    # (M + 1) events x R x S x support columns
    R = int(min(_MAX_PLANE_FLOATS // (M * n_base * S),
                _MAX_PLANE_FLOATS // ((M + 1) * n_cols * S)))
    label = f"lag_post_cov_short_2cmt_oral_{R}x{S}"
    wt0, wt6 = rng.uniform(40.0, 120.0, R), rng.uniform(40.0, 120.0, R)
    data = short_subjects(pt, R, rng, covariates=lambda i, b: b.covariate(
        "wt", 0.0, wt0[i]).covariate("wt", 6.0, wt6[i]))

    def allometric(p, t, cov):
        sc = (cov("wt", t) / 70.0) ** 0.75
        return [p[0] * sc, p[1], p[2] * sc, p[3] * sc, p[4], p[5], p[6]]

    model = pt.Analytical(
        pt.two_compartments_with_absorption, seq_eq=allometric,
        lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: p[6]},
        out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = jittered_support([0.15, 3.0, 0.3, 0.2, 10.0, 0.5, 0.8], S, rng, 0.2)
    return label, model, data, sp, ems, n_cols


def entry_point_plan(pt, model, data, sp, ems) -> tuple:
    """One ``log_likelihood_matrix`` call on the card, with the fused plan it
    builds and the seconds it took to build: (psi, plan, plan seconds)."""
    from pharmsol_tpu_torch.likelihood import matrix

    real, seen = matrix._fused_plan, []

    def recording(*args):
        t0 = time.perf_counter()
        seen.append(real(*args))
        seen.append(time.perf_counter() - t0)
        return seen[-2]

    matrix._fused_plan = recording
    try:
        psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    finally:
        matrix._fused_plan = real
    return psi, seen[0], seen[1]


def phase_lag_post_width(pt, rng, card: str) -> None:
    """The lag_post cell (``lag_post_cell``): one float64 call through the
    public entry point, one K1c launch, held against the general engine on
    256 subjects within 1e-10, the width and the time of the plan built in
    that call printed; then
    one float32 call on the first ``1 / K1C_POST_F32_SHARE`` of the
    subjects, one K1c launch and psi finite."""
    from pharmsol_tpu_torch.likelihood.plans.seq import _MAX_PLANE_FLOATS

    label, model, data, sp, ems, n_cols = lag_post_cell(pt, rng)
    (R, S), M, n_base = (len(data), sp.shape[0]), 1 + len(SHORT_TIMES), 5
    log(f"[21] {label}: the widest population _MAX_PLANE_FLOATS = {_MAX_PLANE_FLOATS} admits "
        f"at {S} supports (cut from the Covariate Short cell's 16384 subjects: the lane walk's "
        f"{M + 1} events x R x S x {n_cols} columns and the {M} x {n_base} x R x S planes)")
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        if dtype == torch.float32:
            data = pt.Data(data.subjects()[:R // K1C_POST_F32_SHARE])
        before = k1c_launch_counts()
        t0 = time.perf_counter()
        psi, plan, plan_s = entry_point_plan(pt, model, data, sp, ems)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launched = tuple(a - b for a, b in zip(k1c_launch_counts(), before))
        if plan.features["seg_postdepth"] is None:
            raise AssertionError(f"{label}: the plan took no lag_post tier")
        if pt.last_engine_decision(model)["engine"] != "fused" or launched != (0, 0, 1):
            raise AssertionError(f"{label}: {pt.last_engine_decision(model)}, (K1a, K1b, "
                                 f"K1c) launches {launched}")
        if tuple(psi.shape) != (len(data), S) or not bool(torch.isfinite(psi).all()):
            raise AssertionError(f"{label} {dtype}: psi {tuple(psi.shape)}, non-finite cells")
        line = (f"[21] {label} {str(dtype)[6:]}: {len(data)} subjects, one K1c launch, the "
                f"call {call_s:.3f} s ({card})")
        if dtype == torch.float64:
            sub = pt.Data(data.subjects()[:256])
            want = pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
            err = rel_err(psi[:256], want, 1.0)
            line += f"; fused vs general on subjects 0-255 rel {err:.3e} (<= 1e-10)"
            if not err <= 1e-10:
                raise AssertionError(f"{label}: fused vs general {err}")
            line += (f"; {plan.features['param_planes'].shape[0]} slots; the plan {plan_s:.3f} "
                     f"s of the call, most of it the lane walk of {R * S} lanes")
        log(line)
    pt.set_float_dtype(torch.float64)


def k1c_record(depth_times, launches, worst_ragged) -> dict:
    """K1c's entry of the kernels line (the lag-depth cell's times)."""
    t32, t64 = depth_times[torch.float32], depth_times[torch.float64]
    return dict(
        K1C_RECORD,
        launches=sum(launches.values()),
        launches_by_cell=launches,
        max_abs_err=t64["abs_err"],
        max_abs_err_f32=t32["abs_err"],
        max_abs_err_ragged=worst_ragged,
        ms=t32["kernel"],
        plain_ms=t32["twin"],
        bound_ms=t32["bound"],
        bound_by=t32["bound_by"],
        library_ms=None,
        ms_f64=t64["kernel"],
        plain_ms_f64=t64["twin"],
        bound_ms_f64=t64["bound"],
        shape="lag_depth_2cmt_oral_{}x{}".format(*K1C_DEPTH_SHAPE),
        end_to_end_ms=t32["end_to_end"],
        end_to_end_ms_f64=t64["end_to_end"],
        plan_ms=t32["plan"],
        plan_ms_f64=t64["plan"],
    )


def sde_feature_record(times, launches, worst) -> dict:
    """K3b's entry of the kernels line."""
    t32, t64 = times[torch.float32], times[torch.float64]
    return dict(
        SDE_FEATURE_RECORD,
        launches=launches,
        max_abs_err=t64["abs_err"],
        max_abs_err_f32=t32["abs_err"],
        max_abs_err_ragged_zero_diffusion=worst[(torch.float64, False)],
        ms=t32["kernel"],
        plain_ms=t32["twin"],
        bound_ms=t32["bound"],
        bound_by=t32["bound_by"],
        library_ms=None,
        ms_f64=t64["kernel"],
        plain_ms_f64=t64["twin"],
        bound_ms_f64=t64["bound"],
        bound_ms_float=t32["bound_float"],
        bound_ms_float_f64=t64["bound_float"],
        general_ms_f64=t64["general"],
        shape="sde_covariates_{}x{}x{}".format(*SDE_COV_FULL, SDE_PARTICLES),
        plain_shape=f"{SDE_TWIN_ROWS}x{SDE_COV_FULL[1]}x{SDE_PARTICLES}",
        end_to_end_ms=t32["end_to_end"],
        end_to_end_ms_f64=t64["end_to_end"],
        plan_ms=t32["plan"],
        plan_ms_f64=t64["plan"],
    )


def run_sde_feature_slice(pt, rng, card: str) -> dict:
    """Phases 16-18: K3b's checks, its cell, its times; K3b's record."""
    t0 = time.perf_counter()
    worst = phase_sde_feature_kernels(pt)
    torch.cuda.synchronize()
    label, model, data, ems, launches = phase_sde_feature_slice(pt, rng)
    times = phase_sde_feature_times(pt, label, model, data, ems, card)
    torch.cuda.synchronize()
    plan = sde_plan_for(model, data, sde_covariate_model_case_support(2), ems, torch.float64)
    anatomy = phase_sde_anatomy(pt, "K3b", plan, {dt: t["kernel"] for dt, t in times.items()},
                                {dt: t["trials"] for dt, t in times.items()}, card, 18)
    log(f"[18] the K3b phases took {time.perf_counter() - t0:.1f} s")
    return dict(sde_feature_record(times, launches, worst), anatomy=anatomy)


def run_k1c_slice(pt, rng, card: str) -> dict:
    """Phases 19-21: K1c's checks, its two cells and their times, lag_post at
    the widest population the cap admits; K1c's record."""
    t0 = time.perf_counter()
    worst = phase_k1c_kernels(pt)
    torch.cuda.synchronize()
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    workloads = k1c_workloads(pt, rng)
    launches = {w[0]: phase_k1c_slice(pt, rng, w, ems) for w in workloads}
    torch.cuda.synchronize()
    times = {w[0]: phase_feature_times(pt, w, ems, card, kernel="K1c", phase=20)
             for w in workloads}
    torch.cuda.synchronize()
    phase_lag_post_width(pt, rng, card)
    torch.cuda.synchronize()
    log(f"[21] the K1c phases took {time.perf_counter() - t0:.1f} s")
    record = k1c_record(times[workloads[0][0]], launches, worst)
    record["cells"] = {label: {str(dt)[6:]: {k: v for k, v in t.items() if k != "bound_by"}
                               for dt, t in by_dtype.items()}
                       for label, by_dtype in times.items()}
    return record


def feature_record_of(label, launches, times) -> dict:
    """K1b's entry of the kernels line (the first cell's times, every cell
    under ``cells``)."""
    f32_, f64_ = times[label][torch.float32], times[label][torch.float64]
    return dict(
        FEATURE_KERNEL_RECORD,
        launches=sum(launches.values()),
        max_abs_err=f64_["abs_err"],
        max_abs_err_f32=f32_["abs_err"],
        ms=f32_["kernel"],
        plain_ms=f32_["twin"],
        bound_ms=f32_["bound"],
        bound_by=f32_["bound_by"],
        library_ms=None,
        ms_f64=f64_["kernel"],
        plain_ms_f64=f64_["twin"],
        bound_ms_f64=f64_["bound"],
        shape=label,
        launches_by_cell=launches,
        cells={cell: {str(dt)[6:]: {k: v for k, v in t.items() if k != "bound_by"}
                      for dt, t in by_dtype.items()}
               for cell, by_dtype in times.items()},
    )


# the instantiations the closed-form anatomy prints: every K1a one, the four
# K1b and K1c cells' (2-cmt oral, code 5, and 1-cmt oral, code 1) in both
# dtypes, and the 3-compartment ones in float64
CLOSED_ANATOMY_KEYS = tuple(
    [f"K1a {d} {c}" for d in ("f32", "f64") for c in range(12)]
    + [f"{k} {d} {c}" for d in ("f32", "f64") for k in ("K1b", "K1c") for c in (1, 5)]
    + [f"{k} f64 {c}" for k in ("K1b", "K1c") for c in (8, 9, 10, 11)])


def closed_anatomy(lib_path: Path) -> dict:
    """{"K1c f64 5": {"regs", "local", "stack", "ldl", "stl", "warps_per_sm",
    "from"}} of the closed-form library's instantiations (``cuobjdump
    -res-usage``; LDL and STL, local loads and stores, counted in the SASS):
    warps per SM from the library's own occupancy query where it has one
    for the tier (``fused_psi_occupancy``, every tier; before it,
    ``fused_psi_feature_occupancy``, K1b and K1c), else from the registers
    at the launch's 256-thread blocks (K1a's one thread a cell)."""
    import ctypes

    lib = ctypes.CDLL(str(lib_path))
    tiered = getattr(lib, "fused_psi_occupancy", None)
    flagged = getattr(lib, "fused_psi_feature_occupancy", None)
    for q in (tiered, flagged):
        if q is not None:
            q.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    local = {}
    for name, (insns, _) in sass_functions(lib_path).items():
        ops = [op.split(".")[0] for _, op, _ in insns]
        local[kernel_key(name)] = (ops.count("LDL"), ops.count("STL"))
    out = {}
    for name, r in kernel_resources(lib_path).items():
        key = kernel_key(name)
        if key not in CLOSED_ANATOMY_KEYS:
            continue
        a = dict(regs=r.get("reg", 0), local=r.get("local", 0), stack=r.get("stack", 0))
        a["ldl"], a["stl"] = local.get(key, (None, None))
        kid, dt, code = key.split()
        query, arg = ((tiered, ("K1a", "K1b", "K1c").index(kid)) if tiered is not None
                      else (flagged, int(kid == "K1c")) if flagged is not None and kid != "K1a"
                      else (None, None))
        if query is not None:
            blocks = ctypes.c_int(0)
            if query(int(dt == "f64"), int(code), arg, ctypes.addressof(blocks)) != 0:
                raise AssertionError(f"{key}: the occupancy query failed")
            a["warps_per_sm"], a["from"] = blocks.value * 128 // 32, "query"
        else:
            a["warps_per_sm"] = resident_blocks(a["regs"], r.get("shared", 0), 256) * 8
            a["from"] = "registers, 256-thread blocks"
        out[key] = a
    return out


def describe_closed_anatomy(a: dict) -> str:
    return (f"{a['regs']} registers, {a['local']} B local, {a['stack']} B stack frame, "
            f"{a.get('ldl')} LDL / {a.get('stl')} STL in the SASS, "
            f"{a['warps_per_sm']} warps per SM ({a['from']})")


def cell_segments(plan) -> int:
    """Cells x spanned segments of a closed-form plan: the segments with a
    span, each row's, times the supports."""
    return int((plan.streams[0] > 0).sum()) * plan.S


def issue_slots(kernel_ms: float, cell_segs: int) -> float:
    """The card's issue slots (4 schedulers x 32 lanes a cycle on every SM)
    in ``kernel_ms``, per cell-segment."""
    return kernel_ms * 1e-3 * H100_CLOCK_HZ * H100_SMS * 128 / cell_segs


def closed_cells(pt):
    """The four K1b and K1c cells as ``feature_workloads`` and
    ``k1c_workloads`` draw them from the seed, with their timing support
    (phase 4's and phase 20's): (label, kernel, model, data, support, ems,
    instantiation key prefix)."""
    rng = np.random.RandomState(SEED)
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    out = []
    for kernel, cells in (("K1b", feature_workloads(pt, rng)), ("K1c", k1c_workloads(pt, rng))):
        for w in cells:
            label, model, data, centre, S = w[:5]
            sp = jittered_support(centre, S, np.random.RandomState(SEED + 4), 0.2)
            out.append((label, kernel, model, data, sp, ems))
    return out


def phase_closed_anatomy(pt, kernel_ms: dict, card: str, k1a_cells=()) -> dict:
    """The closed-form kernel's anatomy on the four K1b and K1c cells and on
    ``k1a_cells`` (label, kernel, model, data, support, ems): every
    instantiation's registers, local memory, stack, local loads and stores
    and warps per SM; per cell and dtype the issue slots per cell-segment of
    the measured kernel time (``kernel_ms[(label, dtype)]``)."""
    from pharmsol_tpu_torch.ops import _build

    inst = closed_anatomy(_build.library_path())
    for key in CLOSED_ANATOMY_KEYS:
        if key in inst:
            log(f"[anatomy] {key}: {describe_closed_anatomy(inst[key])}")
    out = {"instantiations": inst, "cells": {}}
    for label, kernel, model, data, sp, ems in list(k1a_cells) + closed_cells(pt):
        for dtype in (torch.float32, torch.float64):
            d = str(dtype)[6:]
            plan = plan_for(pt, model, data, sp, ems, dtype)
            segs = cell_segments(plan)
            rec = dict(cell_segments=segs)
            if (label, dtype) in kernel_ms:
                rec["kernel_ms"] = kernel_ms[(label, dtype)]
                rec["issue_slots"] = issue_slots(rec["kernel_ms"], segs)
            log(f"[anatomy] {label} {d} ({kernel}): {segs} cell-segments"
                + (f", kernel {rec['kernel_ms']:.4f} ms, {rec['issue_slots']:.1f} issue slots "
                   f"per cell-segment" if "issue_slots" in rec else "") + f" ({card})")
            out["cells"][f"{label} {d}"] = rec
            del plan
    return out


def k1a_record(workloads, launches, errs, times, fit_a=None) -> dict:
    """K1a's entry of the kernels line: the main cell's times in float32,
    float64 beside them; no single PyTorch call computes psi, so
    library_ms is null."""
    main_label = workloads[0][0]
    t32 = times[(main_label, torch.float32)]
    t64 = times[(main_label, torch.float64)]
    rec = dict(
        KERNEL_RECORD,
        launches=launches,
        max_abs_err=errs[(main_label, torch.float64)],
        max_abs_err_f32=errs[(main_label, torch.float32)],
        ms=t32["kernel"],
        plain_ms=t32["twin"],
        bound_ms=t32["bound"],
        bound_by=t32["bound_by"],
        library_ms=None,
        ms_f64=t64["kernel"],
        plain_ms_f64=t64["twin"],
        bound_ms_f64=t64["bound"],
        shape=main_label,
    )
    if fit_a is not None:
        rec["launches_fit"] = fit_a["launches"]
    return rec


def run_closed(pt, rng, card: str) -> list:
    """``--only closed``: phases 0-1 for the closed-form library, phase 2's
    K1a and K1b checks, the two K1a cells and the two K1b cells (phases
    3-4), phases 19-21 (K1c), and the closed-form kernel's anatomy on the
    six cells; K1a's, K1b's and K1c's records."""
    phase_build(pt, {}, {}, {}, only="closed")
    # K1a's draws from a generator of their own: K1b's and K1c's cells get
    # the draws they had before K1a joined this part
    k1a_rng = np.random.RandomState(SEED + 7)
    phase_kernels(pt, k1a_rng)
    phase_feature_kernels(pt)
    torch.cuda.synchronize()
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    workloads = slice_workloads(pt, k1a_rng)
    k1a_launches = phase_slice(pt, k1a_rng, workloads, ems)
    torch.cuda.synchronize()
    errs = phase_kernel_at_slice(pt, workloads, ems)
    k1a_times = phase_times(pt, workloads, ems, card)
    torch.cuda.synchronize()
    features = feature_workloads(pt, rng)
    launches = {w[0]: phase_feature_slice(pt, rng, w, ems) for w in features}
    torch.cuda.synchronize()
    times = {w[0]: phase_feature_times(pt, w, ems, card) for w in features}
    torch.cuda.synchronize()
    k1c = run_k1c_slice(pt, rng, card)
    kernel_ms = {(label, dt): t["kernel"] for label, by in times.items() for dt, t in by.items()}
    kernel_ms.update({(label, dt): t["kernel"] for label, by in k1c["cells"].items()
                      for dt, t in ((torch.float32, by["float32"]), (torch.float64, by["float64"]))})
    kernel_ms.update({key: t["kernel"] for key, t in k1a_times.items()})
    k1a_cells = [(label, "K1a", model, data,
                  jittered_support(centre, S, np.random.RandomState(SEED + 2), 0.2), ems)
                 for label, model, data, centre, S, _ in workloads]
    anatomy = phase_closed_anatomy(pt, kernel_ms, card, k1a_cells)
    return [dict(k1a_record(workloads, k1a_launches, errs, k1a_times), anatomy=anatomy),
            dict(feature_record_of(features[0][0], launches, times), anatomy=anatomy),
            dict(k1c, anatomy=anatomy)]


def pair_closed(pt, ms: dict, psi: dict, kernel_ms: dict, plan_ms: dict) -> dict:
    """The closed-form cells on one side of ``--pair``: the four K1b and K1c
    cells (``closed_cells``) and K1a's two, "Short 16384 x 512" and "1-cmt
    10000 x 1000"; per cell and dtype three ``log_likelihood_matrix`` calls
    after a warm one (``ms``), the kernel alone (the median of three runs of
    ten launches, ``kernel_ms``), the plan alone on the lowered grid (the
    median of five, ``plan_ms``, and its costliest calls) and psi; returns
    the registers of every closed-form kernel, the instantiations' anatomy
    and a digest of each K1a, K1b and K1c kernel's SASS."""
    from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
    from pharmsol_tpu_torch.ops import _build

    _build.load_library()
    cells = closed_cells(pt)
    short = short_subjects(pt, 16384, np.random.RandomState(SEED))
    model = pt.Analytical(pt.two_compartments_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
    segments, profiles = {}, {}
    cells.append(("Short 16384x512", "K1a", model, short,
                  jittered_support([0.15, 1.2, 0.3, 0.2, 10.0], 512,
                                   np.random.RandomState(SEED + 2), 0.2), cells[0][5]))
    one = pt.Analytical(pt.one_compartment_with_absorption,
                        out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    cells.append(("1-cmt 10000x1000", "K1a", one,
                  short_subjects(pt, 10000, np.random.RandomState(SEED + 3)),
                  jittered_support([1.2, 0.2, 30.0], 1000, np.random.RandomState(SEED + 2), 0.2),
                  cells[0][5]))
    for label, _, model, data, sp, ems in cells:
        grid = model.lower(data.subjects())
        lowered = ems.lower(model.resolve_output_label, model.nouteqs())
        for dtype in (torch.float32, torch.float64):
            pt.set_float_dtype(dtype)
            key = f"{label} {str(dtype)[6:]}"
            call = lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")  # noqa: E731
            out = call()
            if tuple(out.shape) != (len(data), sp.shape[0]) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{key}: psi {tuple(out.shape)}, not finite")
            ms[key] = [wall_ms(call, 1, 0) for _ in range(3)]
            psi[key] = out.double().cpu().numpy()
            del out
            build = lambda: _FusedPsiPlan(model, grid, sp, lowered,  # noqa: E731
                                          torch.device("cuda"), dtype)
            plan_ms[key] = statistics.median(wall_ms(build, 1, 0) for _ in range(5))
            prof = cProfile.Profile()
            plan = prof.runcall(build)
            top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
            profiles[key] = [(fn, round(st[3] * 1e3, 1)) for (path, _, fn), st in top
                             if "pharmsol_tpu_torch" in path and fn != "__init__"][:5]
            kernel_ms[key] = statistics.median(cuda_ms(lambda: run_kernel(plan), 10)
                                               for _ in range(3))
            segments[key] = cell_segments(plan)
            del plan
    # lag_post, planes mode (K1c's post-fire model prepared from the planes):
    # the kernel alone and its psi, the plan built once (its lane walk takes
    # seconds)
    label, model, data, sp, ems, _ = lag_post_cell(pt, np.random.RandomState(SEED))
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        key = f"{label} {str(dtype)[6:]}"
        plan = plan_for(pt, model, data, sp, ems, dtype)
        if plan.mode != "planes" or plan.features["seg_postdepth"] is None:
            raise AssertionError(f"{key}: mode {plan.mode}, not lag_post")
        out = run_kernel(plan)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key}: psi not finite")
        psi[key] = out.double().cpu().numpy()
        kernel_ms[key] = statistics.median(cuda_ms(lambda: run_kernel(plan), 10)
                                           for _ in range(3))
        segments[key] = cell_segments(plan)
        del plan, out
    path = _build.library_path()
    regs, sass = {}, {}
    for name, r in kernel_resources(path).items():
        key = kernel_key(name)
        if key is not None:
            regs[key] = r.get("reg")
    for name, (insns, _) in sass_functions(path).items():
        key = kernel_key(name)
        if key is not None and key.startswith("K1"):
            text = "\n".join(f"{op}{args}" for _, op, args in insns)
            sass[key] = hashlib.sha256(text.encode()).hexdigest()[:16]
    return dict(regs=regs, sass=sass, anatomy=closed_anatomy(path), segments=segments,
                profiles=profiles)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def end_to_end_parts(pt, model, data, sp, ems, dtype, plan) -> dict:
    """Wall times of the steps of one fused log_likelihood_matrix call."""
    from pharmsol_tpu_torch.engine.grid import CovView
    from pharmsol_tpu_torch.likelihood.matrix import check_error_model_coverage
    from pharmsol_tpu_torch.ops.fused_psi import extract_linear_out, streams_from_grid

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    psi_rows = run_kernel(plan)

    def finalize():
        psi = plan.finalize(psi_rows)
        return torch.where(torch.isfinite(psi), psi,
                           torch.full_like(psi, -float("inf")))

    return {
        "lower_cached": wall_ms(lambda: model.lower(data.subjects()), 3),
        "error_models": wall_ms(lambda: check_error_model_coverage(
            grid, ems.lower(model.resolve_output_label, model.nouteqs())), 3),
        "streams": wall_ms(lambda: streams_from_grid(grid.rows, lowered), 3),
        "out_coef": wall_ms(lambda: extract_linear_out(
            model._out, sp, model.nstates(), model.nouteqs(), CovView.empty()), 3),
        "plan": wall_ms(lambda: plan_for(pt, model, data, sp, ems, dtype), 3),
        "finalize": cuda_ms(finalize, 10),
    }


def phase_times(pt, workloads, ems, card: str) -> dict:
    from pharmsol_tpu_torch.likelihood.matrix import _general_psi

    times = {}
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        for label, model, data, centre, S, t_build in workloads:
            sp = jittered_support(centre, S, np.random.RandomState(SEED + 2), 0.2)
            cells = len(data) * S
            plan = plan_for(pt, model, data, sp, ems, dtype)
            grid = model.lower(data.subjects())
            lowered = ems.lower(model.resolve_output_label, model.nouteqs())
            t = {
                "kernel": cuda_ms(lambda: run_kernel(plan), 20),
                "twin": cuda_ms(lambda: run_kernel(plan, plain=True), 3, 1),
                "general": wall_ms(lambda: _general_psi(
                    model, grid, sp, lowered, torch.device("cuda"), dtype), 3),
                "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(
                    model, data, sp, ems, device="cuda"), 5),
            }
            d = str(dtype)[6:]
            for k, ms in t.items():
                log(f"[4] {label} {d} {k:10s} {ms:10.3f} ms  "
                    f"{cells / (ms * 1e-3):.4g} cells/s  ({card})")
            parts = end_to_end_parts(pt, model, data, sp, ems, dtype, plan)
            log(f"[4] {label} {d} end_to_end parts (ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()))
            busy = (t["kernel"] + parts["finalize"]) / t["end_to_end"]
            log(f"[4] {label} {d} kernel+finalize share of end_to_end "
                f"{busy:.4f} ({card})")
            nbytes, ops = psi_work(plan)
            t["bound"], t["bound_by"] = bound(nbytes, ops, dtype)
            log(f"[4] {label} {d} K1a bound {t['bound']:.5g} ms by {t['bound_by']} "
                f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations); kernel at "
                f"{t['bound'] / t['kernel']:.3f} of it")
            times[(label, dtype)] = t
    for label, model, data, centre, S, t_build in workloads:
        model._lower_cache.clear()
        t0 = time.perf_counter()
        model.lower(data.subjects())
        t_lower = (time.perf_counter() - t0) * 1e3
        log(f"[4] {label} host: subject builder {t_build * 1e3:.1f} ms, "
            f"lowering {t_lower:.1f} ms ({len(data)} subjects)")
    return times


def expm_record(expm_times, launches, fit_b) -> dict:
    """K2d's entry of the kernels line."""
    e32, e64 = expm_times[torch.float32], expm_times[torch.float64]
    return dict(
        EXPM_KERNEL_RECORD,
        launches=launches + fit_b["launches"],
        launches_width=launches,
        launches_fit=fit_b["launches"],
        max_abs_err=e64["abs_err"],
        max_abs_err_f32=e32["abs_err"],
        ms=e32["kernel"],
        plain_ms=e32["twin"],
        bound_ms=e32["bound"],
        bound_by=e32["bound_by"],
        library_ms=None,
        ms_f64=e64["kernel"],
        plain_ms_f64=e64["twin"],
        bound_ms_f64=e64["bound"],
        shape="ode_expm_transit_{}x{}".format(*EXPM_SHAPE),
        end_to_end_ms=e32["end_to_end"],
        end_to_end_ms_f64=e64["end_to_end"],
        plan_ms=e32["plan"],
        plan_ms_f64=e64["plan"],
        passes=e64["passes"],
        squarings=e64["squarings"],
        matrix_exp_context_ms=e32["matrix_exp"],
        matrix_exp_context_ms_f64=e64["matrix_exp"],
    )


def run_expm_slice(pt, rng, expm, card: str) -> tuple:
    """This slice's phases: K2d and rhs_jvp checks, the two fits, the K2d
    cell and the burn-in threshold. Returns (K2d's record, fit A, fit B)."""
    phase_expm_kernels(pt, expm)
    phase_rhs_jvp(pt, expm)
    torch.cuda.synchronize()
    fit_a, fit_b, fit_data, fit_ems, closed = phase_fits(pt, card)
    torch.cuda.synchronize()
    label, model, data, ems, launches, t_build = phase_expm_slice(pt, rng)
    times = phase_expm_times(pt, label, model, data, ems, t_build, card)
    torch.cuda.synchronize()
    phase_burnin_threshold(pt, closed, fit_data, fit_ems, card)
    torch.cuda.synchronize()
    return expm_record(times, launches, fit_b), fit_a, fit_b


def closing_lines(records, card: str, partial=None) -> None:
    """The last three lines: the kernels, the card, the verdict. A partial
    run (``--only``) drove a part of the paths: its verdict names the part
    and carries no device, so that it cannot pass for the whole script's."""
    print(json.dumps({"kernels": records}))
    print(card)
    if partial is not None:
        print(json.dumps({"ok": True, "partial": partial}))
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def pair_cells(pt):
    """The two SDE cells that ``--pair`` times, each (label, model, data,
    support, ems): K3a's README cell and K3b's covariate cell, drawn as
    phases 6-7 and 17-18 draw them."""
    from pharmsol_tpu_torch.utils.f32_budget import sde_covariate_model_case

    rng = np.random.RandomState(SEED)
    R, S = SDE_FULL
    readme = ("K3a README " + R_S_P_LABEL, readme_sde(pt), readme_data(pt, R, rng),
              readme_support(S, rng), readme_ems(pt))
    model, data, _, ems = sde_covariate_model_case(SDE_COV_FULL[0], 1, seed=SEED)
    cov = ("K3b covariates {}x{}x{}".format(*SDE_COV_FULL, SDE_PARTICLES), model, data,
           sde_covariate_model_case_support(SDE_COV_FULL[1]), ems)
    return readme, cov


def run_pair(other: str, card: str, only=None) -> None:
    """``--pair``: this checkout against the one at ``other``, in the order
    other, here, here, other, each side a process of its own: the cells'
    times per dtype (and for the stiff cell per solver, with the kernel
    alone), the factor of the medians and whether the sides' ranges part;
    the change's psi held to the parent's cell by cell (SDE at the twin's
    tolerances, both drawing the same Philox numbers; stiff by the
    kernel-twin rule, with the cells that differ at all counted); the
    registers of every closed-form, SDE and ODE kernel each side built; the
    SDE kernels' resident blocks and trial-loop mix at four particles a
    thread; the stiff libraries' anatomy and the stiff cell's lane-slots per
    trial under each side's layout. ``only``: "sde" or "stiff" alone."""
    import tempfile

    here = str(Path(__file__).resolve().parent)
    other = str(Path(other).resolve())
    sides, psis = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k, tree in enumerate((other, here, here, other)):
            out = str(Path(tmp) / f"side{k}.npz")
            proc = subprocess.run([sys.executable, __file__, "--pair-worker", tree, out,
                                   only or "all"], capture_output=True, text=True, timeout=900)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PAIR ")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"pair side {tree}: exit {proc.returncode}\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            sides.append(json.loads(lines[-1][5:]))
            with np.load(out) as z:
                psis.append({key: z[key] for key in z.files})
            side = "parent" if tree == other else "change"
            for key, v in sides[-1]["ms"].items():
                log(f"[pair] {side} {key} end-to-end ms: " + ", ".join(f"{x:.3f}" for x in v)
                    + (f"; kernel alone {sides[-1]['kernel_ms'][key]:.3f} ms"
                       if key in sides[-1]["kernel_ms"] else "") + f" ({card})")
    factors = {}
    for what, field in (("end to end", "ms"), ("kernel alone", "kernel_ms"),
                        ("plan alone", "plan_ms")):
        for key in sides[0].get(field, {}):
            one = field != "ms"
            par = ([sides[0][field][key], sides[3][field][key]] if one
                   else sides[0][field][key] + sides[3][field][key])
            chg = ([sides[1][field][key], sides[2][field][key]] if one
                   else sides[1][field][key] + sides[2][field][key])
            factors[f"{key} {what}"] = statistics.median(par) / statistics.median(chg)
            apart = ("faster beyond the spread" if max(chg) < min(par) else
                     "slower beyond the spread" if min(chg) > max(par) else "within the spread")
            log(f"[pair] {key} {what}: parent {min(par):.3f}-{max(par):.3f} ms, change "
                f"{min(chg):.3f}-{max(chg):.3f} ms, factor {factors[f'{key} {what}']:.3f} "
                f"({apart}) ({card})")
    for key in psis[0]:
        for a, b, what in ((0, 3, "parent vs parent"), (1, 2, "change vs change"),
                           (0, 1, "change vs parent")):
            want, got = torch.from_numpy(psis[a][key]), torch.from_numpy(psis[b][key])
            if only == "closed":
                compare_closed(f"pair {key} {what}", got, want, key.endswith("float64"))
                continue
            if key.startswith("ODE ") and not key.startswith("ODE TMDD"):
                differ = int((got != want).sum() - (torch.isnan(got) & torch.isnan(want)).sum())
                cell = (got - want).abs() / want.abs().clamp(min=1.0)
                log(f"[pair] {key} {what}: {differ} of {got.numel()} cells differ at all; "
                    f"max abs {float((got - want).abs().max()):.3e}, max rel "
                    f"{float(cell.max()):.3e}, {float((cell <= 1e-8).double().mean()):.6f} "
                    f"within 1e-8")
                continue
            if key.startswith("ODE TMDD"):
                differ = int((got.double() != want.double()).sum()
                             - (torch.isnan(got) & torch.isnan(want)).sum())
                err, share = compare_stiff(f"pair {key} {what}", got.double(), want.double())
                log(f"[pair] {key} {what}: {differ} of {got.numel()} cells differ at all; "
                    f"max rel {err:.3e} (<= 1e-6), {share:.6f} within 1e-8 (>= 0.99), the "
                    f"same lost cells ({int((~torch.isfinite(got)).sum())})")
                continue
            tol, share = (1e-9, 0.999) if key.endswith("float64") else (1e-4, 0.99)
            sde_compare(f"pair {key} {what}", got, want, tol, share, phase="pair")
    base, change = sides[0]["regs"], sides[1]["regs"]
    for key in sorted(set(base) | set(change)):
        same = "same" if base.get(key) == change.get(key) else "DIFFERENT"
        log(f"[pair] registers {key}: parent {base.get(key)}, change {change.get(key)} ({same})")
    for key in sorted(set(sides[0]["sass"]) | set(sides[1]["sass"])):
        same = "the same" if sides[0]["sass"].get(key) == sides[1]["sass"].get(key) else "DIFFERENT"
        log(f"[pair] SASS {key}: parent {sides[0]['sass'].get(key)}, change "
            f"{sides[1]['sass'].get(key)} ({same} instructions)")
    for key in sorted(set(sides[0]["anatomy"]) | set(sides[1]["anatomy"])):
        for side, a in (("parent", sides[0]["anatomy"].get(key)),
                        ("change", sides[1]["anatomy"].get(key))):
            if a is None:
                continue
            mix = a["per_particle_trial"] or {}
            log(f"[pair] {side} {key}: {a['regs']} registers, a {a['stack']}-byte stack frame, "
                f"{a.get('blocks_per_sm_runtime', a['blocks_per_sm'])} resident blocks per SM "
                f"({a['blocks_per_sm']} from the registers); per particle-trial: "
                + ", ".join(f"{k} {v:g}" for k, v in sorted(mix.items())))
    for side, k in (("parent", 0), ("change", 1)):
        for key, a in sorted(sides[k]["stiff_anatomy"].items()):
            log(f"[pair] {side} anatomy {key}: {describe_anatomy(a)}")
    for key in sorted(set(sides[0].get("closed_anatomy", {}))
                      | set(sides[1].get("closed_anatomy", {}))):
        for side, k in (("parent", 0), ("change", 1)):
            a = sides[k]["closed_anatomy"].get(key)
            if a is not None:
                log(f"[pair] {side} {key}: {describe_closed_anatomy(a)}")
    closed = {}
    if only == "closed":
        closed = pair_closed_slots(card, sides)
        for side, k in (("parent", 0), ("change", 1)):
            for key, top in sides[k]["profiles"].items():
                log(f"[pair] {side} {key} plan, costliest calls (ms, cumulative, profiled): "
                    + ", ".join(f"{fn} {ms}" for fn, ms in top))
    explicit = {}
    if only in (None, "explicit"):
        explicit = pair_explicit_lanes(card, [side["kernel_ms"] for side in sides])
    slots = {}
    if only in (None, "stiff"):
        from pharmsol_tpu_torch.ops.fused_ode import implicit_lanes

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        cells = STIFF_SHAPE[0] * STIFF_SHAPE[1]

        def lanes_of(solver):
            tier = "K2c" if solver == "bdf" else "K2b"
            a = sides[1]["stiff_anatomy"].get(
                f"tmdd {solver}: {tier} {solver} f64" + (" cap 3" if solver == "bdf" else ""))
            if not a or "blocks_per_sm_runtime" not in a:
                return None
            return implicit_lanes(cells, a["blocks_per_sm_runtime"] * sms)

        slots = pair_lane_slots(lanes_of)
        for solver, v in slots.items():
            log(f"[pair] lane-slots per trial, {solver} float64 (the twin's trials by march call "
                f"on {STIFF_TWIN_ROWS} subjects x {STIFF_SHAPE[1]}, scaled to the cell): parent "
                f"{v['synced']:.4f} (synced at every march call), one cell a lane on its own "
                f"{v['own']:.4f}, change "
                + ("no query" if v["refilled"] is None else f"{v['refilled']:.4f}"))
    print(json.dumps({"pair": {
        "order": ["parent", "change", "change", "parent"],
        "ms": [s["ms"] for s in sides], "kernel_ms": [s["kernel_ms"] for s in sides],
        "factors": factors, "registers_parent": base, "registers_change": change,
        "anatomy_parent": sides[0]["anatomy"], "anatomy_change": sides[1]["anatomy"],
        "stiff_anatomy_parent": sides[0]["stiff_anatomy"],
        "stiff_anatomy_change": sides[1]["stiff_anatomy"], "lane_slots": slots,
        "explicit": explicit, "plan_ms": [s.get("plan_ms", {}) for s in sides],
        "closed_anatomy_parent": sides[0].get("closed_anatomy", {}),
        "closed_anatomy_change": sides[1].get("closed_anatomy", {}), "closed": closed}}))


def compare_closed(label: str, got: torch.Tensor, want: torch.Tensor, f64: bool) -> None:
    """Two closed-form psi of one cell held cell by cell: float64 every cell
    within 1e-12 relative, float32 every cell within 1e-3 and 99.9% within
    1e-5; the cells that differ at all counted."""
    got, want = got.double(), want.double()
    differ = int((got != want).sum())
    cell = (got - want).abs() / want.abs().clamp(min=1.0)
    worst = float(cell.max())
    share = float((cell <= 1e-5).double().mean())
    rule = "<= 1e-12" if f64 else "<= 1e-3, 99.9% within 1e-5"
    log(f"[pair] {label}: {differ} of {got.numel()} cells differ at all; max rel {worst:.3e} "
        f"({rule}); {share:.6f} within 1e-5")
    if (f64 and worst > 1e-12) or (not f64 and (worst > 1e-3 or share < 0.999)):
        raise AssertionError(f"{label}: max rel {worst}, {share} within 1e-5")


def pair_closed_slots(card: str, sides: list) -> dict:
    """Each side's issue slots per cell-segment in the closed-form cells
    (``issue_slots``: the kernel alone, the median of the side's two runs,
    over the cell's spanned segments, which the workers counted)."""
    out = {}
    for key, segs in sides[1]["segments"].items():
        t = {side: statistics.median([sides[k]["kernel_ms"][key], sides[3 - k]["kernel_ms"][key]])
             for side, k in (("parent", 0), ("change", 1))}
        slots = {side: issue_slots(v, segs) for side, v in t.items()}
        log(f"[pair] {key}: issue slots per cell-segment parent {slots['parent']:.1f}, change "
            f"{slots['change']:.1f} ({segs} cell-segments) ({card})")
        out[key] = dict(slots, cell_segments=segs)
    return out


def pair_worker(tree: str, psi_out: str, only=None) -> dict:
    """One side of ``--pair``: the package of the checkout at ``tree``. With
    ``only`` None or "sde": times both SDE cells per dtype (three calls after
    a warm one that builds) and reads each SDE library's
    four-particles-a-thread kernels (``sde_anatomy``; resident blocks also
    from the library's own occupancy query where it has one); with None or
    "stiff": the stiff cell under each solver and dtype (``pair_stiff``).
    Writes every cell's psi to ``psi_out`` (npz)."""
    sys.path.insert(0, tree)
    import ctypes

    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops import _build

    root = Path(pt.__file__).resolve().parent
    if root.parent != Path(tree).resolve():
        raise AssertionError(f"imported {root}, not the package of {tree}")
    ms, psi, regs, anatomy, kernel_ms, stiff, explicit = {}, {}, {}, {}, {}, {}, {}
    plan_ms, closed = {}, {}
    if only == "closed":
        closed = pair_closed(pt, ms, psi, kernel_ms, plan_ms)
    if only in (None, "explicit"):
        explicit = pair_explicit(pt, ms, psi, kernel_ms)
    if only in (None, "stiff"):
        stiff = pair_stiff(pt, ms, psi, kernel_ms)
    if only in (None, "sde"):
        cells = pair_cells(pt)
        libs = []
        for label, model, data, sp, ems in cells:
            plan = sde_plan_for(model, data, sp, ems, torch.float64)
            feature = label.startswith("K3b")
            libs.append((_build.generated_target(_build.sde_kind(feature), plan.gen), plan,
                         feature))
        _build.build_many([t for t, _, _ in libs])  # both at once
        _build.load_library()
        for label, model, data, sp, ems in cells:
            for dtype in (torch.float32, torch.float64):
                pt.set_float_dtype(dtype)
                call = lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")  # noqa: E731
                out = call()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{tree} {label}: psi not finite")
                key = f"{label} {str(dtype)[6:]}"
                ms[key] = [wall_ms(call, 1, 0) for _ in range(3)]
                psi[key] = out.double().cpu().numpy()
        for lib in sorted((root / "_build").glob("libfused_*.so")):
            if lib.name.startswith(("libfused_psi", "libfused_sde")):
                regs.update(kernel_registers(lib))
        for target, plan, feature in libs:
            found = sde_anatomy(target.path, plan.gen.n_states, SDE_PARTICLES)
            query = getattr(ctypes.CDLL(str(target.path)), "fused_sde_occupancy", None)
            for key, a in found.items():
                if query is not None:
                    blocks = ctypes.c_int(0)
                    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                    if query(int("f64" in key), SDE_PARTICLES, ctypes.addressof(blocks)) == 0:
                        a["blocks_per_sm_runtime"] = blocks.value
                anatomy[key] = a
    np.savez(psi_out, **psi)
    return dict(tree=tree, ms=ms, regs=dict(regs, **stiff.get("regs", {}),
                                            **explicit.get("regs", {}), **closed.get("regs", {})),
                sass=dict(explicit.get("sass", {}), **closed.get("sass", {})), anatomy=anatomy,
                kernel_ms=kernel_ms, plan_ms=plan_ms, closed_anatomy=closed.get("anatomy", {}),
                segments=closed.get("segments", {}), profiles=closed.get("profiles", {}),
                stiff_anatomy=dict(stiff.get("anatomy", {}), **explicit.get("anatomy", {})))


def explicit_pair_cells(pt):
    """The cells that ``--pair`` times for the explicit tier, each (label,
    model, data, support, ems): "ODE Short 16384 x 512" (K2a) and "ODE
    covariates 16384 x 512" (K2e) with phase 4's and phase 8's timing
    supports, and "ODE expm transit 16384 x 512" (K2d, a check that the exact
    tier did not move)."""
    from pharmsol_tpu_torch.utils.f32_budget import (
        COVARIATE_MODEL_CENTRE, TRANSIT_CENTRE, covariate_model_case, expm_case,
    )

    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    short = short_subjects(pt, 16384, np.random.RandomState(SEED))
    n, S = ODE_COV_SHAPE
    cov_model, cov_data, _, cov_ems = covariate_model_case(n, 1, seed=SEED)
    expm_model, expm_data, _, expm_ems = expm_case("transit", *EXPM_SHAPE[:1], 1, seed=SEED)
    return [
        ("ODE Short 16384x512", ode_model(pt, "short"), short,
         ODE_MODELS["short"][5](np.random.RandomState(SEED + 3), 512), ems),
        ("ODE covariates {}x{}".format(n, S), cov_model, cov_data,
         jittered_support(COVARIATE_MODEL_CENTRE, S, np.random.RandomState(SEED + 5)), cov_ems),
        ("ODE expm transit {}x{}".format(*EXPM_SHAPE), expm_model, expm_data,
         jittered_support(TRANSIT_CENTRE, EXPM_SHAPE[1], np.random.RandomState(SEED + 6), 0.2),
         expm_ems),
    ]


def pair_explicit(pt, ms: dict, psi: dict, kernel_ms: dict) -> dict:
    """The explicit tier's cells on one side of ``--pair``
    (``explicit_pair_cells``): their libraries built at once, then per cell
    and dtype three ``log_likelihood_matrix`` calls after a warm one
    (``ms``), the kernel alone by CUDA events (``kernel_ms``) and psi;
    returns the registers of every kernel of those libraries and the anatomy
    (``ode_anatomy``) of the explicit ones."""
    from pharmsol_tpu_torch.ops import _build

    cells = explicit_pair_cells(pt)
    libs = {}
    for label, model, data, sp, ems in cells:
        small = pt.Data(data.subjects()[:2])
        libs[label] = _build.generated_target(
            _build.ODE, ode_plan_for(model, small, sp, ems, torch.float64).rhs)
    _build.build_many(list(libs.values()))
    for label, model, data, sp, ems in cells:
        for dtype in (torch.float32, torch.float64):
            pt.set_float_dtype(dtype)
            key = f"{label} {str(dtype)[6:]}"
            call = lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")  # noqa: E731
            out = call()
            if tuple(out.shape) != (len(data), sp.shape[0]) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{key}: psi {tuple(out.shape)}, not finite")
            ms[key] = [wall_ms(call, 1, 0) for _ in range(3)]
            psi[key] = out.double().cpu().numpy()
            del out
            plan = ode_plan_for(model, data, sp, ems, dtype)
            # the median of three runs of ten launches: each launch packs its
            # inputs on the host (a copy that waits for the card), which a
            # busy host can stretch
            kernel_ms[key] = statistics.median(cuda_ms(lambda: run_ode_kernel(plan), 10)
                                               for _ in range(3))
            del plan
    regs, anatomy, sass = {}, {}, {}
    for label, target in libs.items():
        for kernel, r in kernel_resources(target.path).items():
            key = ode_kernel_key(kernel)
            if key is not None:
                regs[f"{label}: {key}"] = r.get("reg")
        # a digest of each kernel's instructions (mnemonics and operands), so
        # that the two sides' code can be told equal or not
        for kernel, (insns, _) in sass_functions(target.path).items():
            key = ode_kernel_key(kernel)
            if key is not None:
                text = "\n".join(f"{op}{args}" for _, op, args in insns)
                sass[f"{label}: {key}"] = hashlib.sha256(text.encode()).hexdigest()[:16]
        if "expm" not in label:
            anatomy.update({f"{label}: {k}": a for k, a in ode_anatomy(target.path).items()
                            if k.startswith("K2e" if "covariates" in label else "K2a")})
    return dict(regs=regs, anatomy=anatomy, sass=sass)


def pair_explicit_lanes(card: str, kernel_ms: list) -> dict:
    """The explicit cells' lane model (``explicit_lane_report``, from the f64
    twin's trials by march call on 64 subjects, run here on the card) and
    each side's issue slots per cell-trial from its kernel time (``kernel_ms``
    per side) over the twin's trials at full width."""
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain

    out = {}
    for label, model, data, sp, ems in explicit_pair_cells(pt)[:2]:
        pt.set_float_dtype(torch.float64)
        counts = {}
        plan = ode_plan_for(model, pt.Data(data.subjects()[:64]), sp, ems, torch.float64)
        psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts, **plan.kernel_kwargs())
        rep = explicit_lane_report(torch.stack(counts["trials_by_call"]).cpu().numpy())
        log(f"[pair] {label} lane model (f64 twin on 64 subjects x {sp.shape[0]}): "
            + describe_lane_report(rep))
        slots = {}
        for dtype in (torch.float32, torch.float64):
            d = str(dtype)[6:]
            pt.set_float_dtype(dtype)
            counts = {}
            plan = ode_plan_for(model, data, sp, ems, dtype)
            psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts,
                          **plan.kernel_kwargs())
            del plan
            for side, k in (("parent", 0), ("change", 1)):
                t = statistics.median([kernel_ms[k][f"{label} {d}"],
                                       kernel_ms[3 - k][f"{label} {d}"]])
                slots[f"{side} {d}"] = t * 1e-3 * H100_CLOCK_HZ * H100_SMS * 128 / counts["steps"]
            log(f"[pair] {label} {d}: issue slots per cell-trial parent "
                f"{slots['parent ' + d]:.1f}, change {slots['change ' + d]:.1f} "
                f"({counts['steps']} trials) ({card})")
        out[label] = dict(lanes=rep, issue_slots=slots)
    return out


def pair_stiff(pt, ms: dict, psi: dict, kernel_ms: dict) -> dict:
    """The stiff cell on one side of ``--pair``: its libraries built at once
    (the TMDD header under each implicit solver, and its explicit and exact
    tiers' libraries, whose registers must not move), then per solver and
    dtype three ``log_likelihood_matrix`` calls after a warm one (``ms``),
    the kernel alone by CUDA events (``kernel_ms``) and psi; returns the
    registers of every ODE kernel built, keyed by library and kernel, and
    the implicit libraries' anatomy (``stiff_anatomy``)."""
    from pharmsol_tpu_torch.ops import _build

    n, S = STIFF_SHAPE
    data, ems, _ = tmdd_population(pt, n, np.random.RandomState(SEED + 8))
    sp = tmdd_support(S, np.random.RandomState(SEED + 7))
    small = pt.Data(data.subjects()[:2])
    libs = {}
    for solver in STIFF_SOLVERS:
        gen = ode_plan_for(tmdd_model(solver), small, sp, ems, torch.float64).rhs
        libs[f"tmdd {solver}"] = _build.generated_target(_build.ode_kind(solver), gen)
    libs["tmdd expm tier"] = _build.generated_target(_build.ODE, gen)  # the same header
    gen = ode_plan_for(tmdd_model("dopri5"), small, sp, ems, torch.float64).rhs
    libs["tmdd explicit tier"] = _build.generated_target(_build.ODE, gen)
    _build.build_many(list(libs.values()))
    label = "ODE TMDD stiff {}x{}".format(*STIFF_SHAPE)
    for solver in STIFF_SOLVERS:
        model = tmdd_model(solver)
        for dtype in (torch.float32, torch.float64):
            pt.set_float_dtype(dtype)
            key = f"{label} {solver} {str(dtype)[6:]}"
            call = lambda: pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")  # noqa: E731
            out = call()
            if tuple(out.shape) != (n, S) or bool(torch.isnan(out).any()):
                raise AssertionError(f"{key}: psi {tuple(out.shape)}, NaN in it")
            ms[key] = [wall_ms(call, 1, 0) for _ in range(3)]
            psi[key] = out.cpu().numpy()
            del out
            plan = ode_plan_for(model, data, sp, ems, dtype)
            kernel_ms[key] = cuda_ms(lambda: run_ode_kernel(plan), 3, 1)
            del plan
    regs, anatomy = {}, {}
    for name, target in libs.items():
        for kernel, r in kernel_resources(target.path).items():
            key = ode_kernel_key(kernel)
            if key is not None:
                regs[f"{name}: {key}"] = r.get("reg")
        if name.split()[-1] in STIFF_SOLVERS:
            anatomy.update({f"{name}: {k}": a for k, a in ode_anatomy(target.path).items()})
    return dict(regs=regs, anatomy=anatomy)


def pair_lane_slots(lanes_of) -> dict:
    """Lane-slots per trial of the stiff cell under each solver, float64,
    from the twin's trials by march call on ``stiff_twin_rows`` x 512 (run
    here on the card): the parent's layout and the change's persistent grid
    (``lanes_of(solver)`` lanes, None where the change has no query)."""
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain

    n, S = STIFF_SHAPE
    pt.set_float_dtype(torch.float64)
    data, ems, _ = tmdd_population(pt, n, np.random.RandomState(SEED + 8),
                                   rows=stiff_twin_rows(n))
    sp = tmdd_support(S, np.random.RandomState(SEED + 7))
    out = {}
    for solver in STIFF_SOLVERS:
        plan = ode_plan_for(tmdd_model(solver), data, sp, ems, torch.float64)
        counts = {}
        psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts,
                      **plan.kernel_kwargs())
        tbc = torch.stack(counts["trials_by_call"]).cpu().numpy()
        out[solver] = stiff_lane_slots(tbc, n, lanes_of(solver))
    return out


R_S_P_LABEL = "{}x{}x{}".format(*SDE_FULL, SDE_PARTICLES)


# ---------------------------------------------------------------------------
# phase 22: the single-subject API and the per-subject batch log-likelihood
# ---------------------------------------------------------------------------

# the 16 scenarios of tests/test_reference_goldens.py (ode_optimizations.rs
# :205-1184, numerical_stability.rs :139-312): (name, model pair, events,
# parameters); their analytical predictions are pinned in GOLDENS_PATH
def _obs(*times):
    return [("obs", t) for t in times]


GOLDEN_SCENARIOS = [
    ("single_iv_bolus", "one_cmt",
     [("bolus", 0.0, 100.0, 0)] + _obs(1.0, 2.0, 4.0, 8.0, 12.0, 24.0), [0.1, 50.0]),
    ("multiple_iv_boluses", "one_cmt",
     [("bolus", 0.0, 100.0, 0), ("bolus", 4.0, 50.0, 0), ("bolus", 8.0, 75.0, 0)]
     + _obs(1.0, 2.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 24.0), [0.1, 50.0]),
    ("oral_bolus_with_absorption", "absorption",
     [("bolus", 0.0, 100.0, 0)] + _obs(0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0), [1.0, 0.1, 50.0]),
    ("multiple_oral_doses", "absorption",
     [("bolus", 0.0, 100.0, 0), ("bolus", 8.0, 100.0, 0), ("bolus", 16.0, 100.0, 0)]
     + _obs(1.0, 2.0, 4.0, 8.0, 9.0, 10.0, 12.0, 16.0, 17.0, 20.0, 24.0), [1.0, 0.1, 50.0]),
    ("single_infusion", "one_cmt",
     [("infusion", 0.0, 100.0, 0, 2.0)] + _obs(0.5, 1.0, 2.0, 3.0, 4.0, 8.0, 12.0),
     [0.1, 50.0]),
    ("overlapping_infusions", "one_cmt",
     [("infusion", 0.0, 100.0, 0, 4.0), ("infusion", 2.0, 50.0, 0, 2.0)]
     + _obs(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0), [0.1, 50.0]),
    ("bolus_plus_infusion", "one_cmt",
     [("bolus", 0.0, 100.0, 0), ("infusion", 0.0, 200.0, 0, 8.0)]
     + _obs(1.0, 2.0, 4.0, 8.0, 10.0, 12.0, 24.0), [0.1, 50.0]),
    ("complex_dosing_scenario", "absorption",
     [("bolus", 0.0, 100.0, 0), ("bolus", 6.0, 150.0, 0), ("bolus", 12.0, 100.0, 0)]
     + _obs(1.0, 2.0, 4.0, 6.0, 7.0, 8.0, 12.0, 14.0, 18.0, 24.0), [1.0, 0.1, 50.0]),
    ("mixed_bolus_infusion_iv", "one_cmt",
     [("bolus", 0.0, 100.0, 0), ("infusion", 4.0, 200.0, 0, 4.0), ("bolus", 8.0, 50.0, 0)]
     + _obs(1.0, 2.0, 4.0, 5.0, 6.0, 8.0, 9.0, 10.0, 12.0, 24.0), [0.1, 50.0]),
    ("bolus_at_observation_time", "one_cmt",
     [("bolus", 0.0, 100.0, 0), ("bolus", 2.0, 50.0, 0)] + _obs(0.0, 1.0, 2.0, 3.0, 4.0),
     [0.1, 50.0]),
    ("very_fast_elimination", "one_cmt",
     [("bolus", 0.0, 100.0, 0)] + _obs(0.1, 0.2, 0.5, 1.0, 2.0), [2.0, 50.0]),
    ("very_slow_elimination", "one_cmt",
     [("bolus", 0.0, 100.0, 0)] + _obs(24.0, 48.0, 72.0, 96.0, 168.0), [0.01, 50.0]),
    ("rapid_absorption", "absorption",
     [("bolus", 0.0, 100.0, 0)] + _obs(0.1, 0.25, 0.5, 1.0, 2.0, 4.0), [10.0, 0.1, 50.0]),
    ("stability_infusion", "one_cmt",
     [("bolus", 0.0, 100.0, 0), ("infusion", 24.0, 150.0, 0, 3.0)]
     + _obs(0.0, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 25.0, 26.0, 27.0, 28.0, 32.0, 36.0),
     [0.1, 1.0]),
    ("stability_absorption", "absorption",
     [("bolus", 0.0, 100.0, 0), ("infusion", 24.0, 150.0, 0, 3.0), ("bolus", 48.0, 100.0, 1)]
     + _obs(0.0, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 25.0, 26.0, 27.0, 28.0, 32.0, 36.0, 48.0,
            49.0, 50.0, 52.0, 56.0, 60.0),
     [1.0, 0.1, 1.0]),
    ("stability_two_compartment", "two_cmt",
     [("bolus", 0.0, 100.0, 0), ("infusion", 24.0, 150.0, 0, 3.0)]
     + _obs(0.0, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0, 25.0, 26.0, 27.0, 28.0, 32.0, 36.0),
     [0.1, 3.0, 1.0, 1.0]),
]
GOLDENS_PATH = Path(__file__).resolve().parent / "tests" / "goldens" / "reference_scenarios.json"
GOLDEN_REL, GOLDEN_ABS = 1e-2, 1e-6  # ode_optimizations.rs:14-15
# the batch: phase 10's population, subjects held against the CPU and by hand
SINGLE_BATCH, SINGLE_HELD, SINGLE_BY_HAND = 10000, 256, 8


def golden_pair(pt, kind: str):
    """The reference scenarios' (Analytical, ODE) pair, torch closures."""
    if kind == "one_cmt":
        out = lambda x, p, t, cov: x[:1] / p[1]  # noqa: E731
        return (pt.Analytical(pt.one_compartment, out=out, nstates=1, ndrugs=1, nout=1),
                pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack(
                    [-p[0] * x[0] + b[0] + rateiv[0]]), out=out, nstates=1, ndrugs=1, nout=1))
    if kind == "absorption":
        out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
        return (pt.Analytical(pt.one_compartment_with_absorption, out=out, nstates=2,
                              ndrugs=2, nout=1),
                pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([
                    -p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1] + b[1] + rateiv[0]]),
                    out=out, nstates=2, ndrugs=2, nout=1))
    out = lambda x, p, t, cov: x[:1] / p[3]  # noqa: E731
    return (pt.Analytical(pt.two_compartments, out=out, nstates=2, ndrugs=1, nout=1),
            pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([
                rateiv[0] - p[0] * x[0] - p[1] * x[0] + p[2] * x[1] + b[0],
                p[1] * x[0] - p[2] * x[1]]), out=out, nstates=2, ndrugs=1, nout=1))


def golden_subject(pt, sid: str, events):
    b = pt.Subject.builder(sid)
    for ev in events:
        if ev[0] == "bolus":
            b = b.bolus(ev[1], ev[2], ev[3])
        elif ev[0] == "infusion":
            b = b.infusion(ev[1], ev[2], ev[3], ev[4])
        else:
            b = b.observation(ev[1], ev[2] if len(ev) > 2 else 0.0, 0)
    return b.build()


def kernel_launches() -> dict:
    """Every launch counter of the table's kernels."""
    from pharmsol_tpu_torch.ops import fused_ode, fused_psi, fused_sde

    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": getattr(mod, name)
            for mod in (fused_psi, fused_ode, fused_sde)
            for name in dir(mod) if name.endswith("LAUNCHES")}


def reset_kernel_launches() -> None:
    from pharmsol_tpu_torch.ops import fused_ode, fused_psi, fused_sde

    for mod in (fused_psi, fused_ode, fused_sde):
        for name in dir(mod):
            if name.endswith("LAUNCHES"):
                setattr(mod, name, 0)


def phase_golden_scenarios(pt) -> dict:
    """Phase 22, the 16 reference scenarios on the card, float64."""
    pt.set_float_dtype(torch.float64)
    goldens = json.loads(GOLDENS_PATH.read_text())
    if sorted(goldens) != sorted(s[0] for s in GOLDEN_SCENARIOS):
        raise AssertionError("[22] the scenarios differ from the committed goldens' names")
    worst_golden = worst_ode = 0.0
    for name, kind, events, params in GOLDEN_SCENARIOS:
        analytical, ode = golden_pair(pt, kind)
        subject = golden_subject(pt, name, events)
        got = np.asarray(analytical.estimate_predictions(subject, params, device="cuda")
                         .flat_predictions())
        want = np.asarray(goldens[name])
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, err_msg=name)
        worst_golden = max(worst_golden, float(np.max(np.abs(got - want)
                                                      / np.maximum(np.abs(want), 1e-300))))
        pred_ode = np.asarray(ode.estimate_predictions(subject, params, device="cuda")
                              .flat_predictions())
        abs_err = np.abs(pred_ode - got)
        rel_err = abs_err / np.maximum(np.abs(got), GOLDEN_ABS)
        ok = (abs_err <= GOLDEN_ABS) | (rel_err <= GOLDEN_REL)
        if not ok.all():
            raise AssertionError(f"[22] {name}: ODE {pred_ode[~ok]} against analytical "
                                 f"{got[~ok]} beyond REL {GOLDEN_REL} / ABS {GOLDEN_ABS}")
        worst_ode = max(worst_ode, float(np.max(np.where(abs_err <= GOLDEN_ABS, 0.0, rel_err))))
    analytical, ode = golden_pair(pt, "one_cmt")
    subject = golden_subject(pt, "ll", [("bolus", 0.0, 100.0, 0), ("obs", 1.0, 1.8),
                                        ("obs", 2.0, 1.6), ("obs", 4.0, 1.3), ("obs", 8.0, 0.8)])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.0, 0.1, 0.0, 0.0), 0.0))
    ll_a = analytical.estimate_log_likelihood(subject, [0.1, 50.0], ems, device="cuda")
    ll_o = ode.estimate_log_likelihood(subject, [0.1, 50.0], ems, device="cuda")
    ll_cpu = analytical.estimate_log_likelihood(subject, [0.1, 50.0], ems, device="cpu")
    if not (math.isfinite(ll_a) and abs(ll_a - ll_o) / max(abs(ll_a), 1e-10) < 1e-2
            and abs(ll_a - ll_cpu) <= 1e-10 * abs(ll_cpu)):
        raise AssertionError(f"[22] log-likelihoods: analytical {ll_a}, ODE {ll_o}, "
                             f"CPU {ll_cpu}")
    log(f"[22] 16 reference scenarios on the card, float64: analytical against the "
        f"committed goldens worst {worst_golden:.2e} relative (rtol 1e-9); ODE against "
        f"analytical worst {worst_ode:.2e} relative (REL {GOLDEN_REL}, ABS {GOLDEN_ABS}); "
        f"log-likelihood analytical {ll_a:.10f}, ODE {ll_o:.10f}")
    return {"golden_worst_rel": worst_golden, "ode_worst_rel": worst_ode,
            "ll_analytical": ll_a, "ll_ode": ll_o}


def single_batch_case(pt):
    """Phase 10's population (1-cmt oral, 10 000 subjects), a parameter row
    per subject (ka, ke, v) drawn from the seed, and a combined residual
    model: (model, data, parameters, residual models, the fit's assay
    error models)."""
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    data, ems, _ = population_10k_case(SINGLE_BATCH)
    rng = np.random.RandomState(SEED + 22)
    params = np.column_stack([
        1.2 * np.exp(0.2 * rng.randn(SINGLE_BATCH)),
        np.where(rng.rand(SINGLE_BATCH) < 0.5, 0.08, 0.35) * np.exp(0.1 * rng.randn(SINGLE_BATCH)),
        30.0 * np.exp(0.15 * rng.randn(SINGLE_BATCH)),
    ])
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.combined(0.05, 0.1))
    return population_models()[0], data, params, rems, ems


def phase_single_batch(pt, model, data, params, rems) -> dict:
    """Phase 22, ``log_likelihood_batch`` at full width in both dtypes, held
    against the CPU and against the single-subject API."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    held = pt.Data(data.subjects()[:SINGLE_HELD])
    pt.set_float_dtype(torch.float64)
    cpu = pt.log_likelihood_batch(model, held, params[:SINGLE_HELD], rems, device="cpu")
    out = {}
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        ll = pt.log_likelihood_batch(model, data, params, rems, device="cuda")
        if ll.shape != (SINGLE_BATCH,) or ll.device.type != "cuda" or ll.dtype != dtype:
            raise AssertionError(f"[22] batch: {tuple(ll.shape)} {ll.device} {ll.dtype}")
        if not bool(torch.isfinite(ll).all()):
            raise AssertionError(f"[22] batch {dtype}: {int((~torch.isfinite(ll)).sum())} "
                                 f"subjects not finite")
        got = ll[:SINGLE_HELD].double().cpu()
        if dtype == torch.float64:
            err = rel_err(got, cpu, 1e-300)
            if err > 1e-10:
                raise AssertionError(f"[22] batch float64 against the CPU: {err:.2e} > 1e-10")
        else:
            err = f32_error(got.numpy(), cpu.numpy())
            row = F32_BUDGET["one_compartment_with_absorption"]
            if err > row:
                raise AssertionError(f"[22] batch float32 against the CPU's float64: "
                                     f"{err:.2e} > {row}")
        out[str(dtype).rsplit(".", 1)[-1]] = {"against_cpu": err, "sum": float(ll.double().sum())}
    pt.set_float_dtype(torch.float64)
    ll = pt.log_likelihood_batch(model, data, params, rems, device="cuda")
    worst = 0.0
    for i, s in enumerate(data.subjects()[:SINGLE_BY_HAND]):
        preds = model.estimate_predictions(s, params[i], device="cuda")
        want = rems.total_log_likelihood((0, p.observation, p.prediction)
                                         for p in preds.predictions())
        worst = max(worst, abs(float(ll[i]) - want) / abs(want))
    if worst > 1e-10:
        raise AssertionError(f"[22] batch against estimate_predictions + "
                             f"total_log_likelihood: {worst:.2e} > 1e-10")
    out["by_hand"] = worst
    log(f"[22] log_likelihood_batch at {SINGLE_BATCH} subjects on the card (1-cmt oral, "
        f"combined residual): float64 finite, {out['float64']['against_cpu']:.2e} relative "
        f"against the CPU on {SINGLE_HELD} (1e-10); float32 finite, "
        f"{out['float32']['against_cpu']:.2e} against the CPU's float64 (row "
        f"{F32_BUDGET['one_compartment_with_absorption']}); {worst:.2e} against "
        f"estimate_predictions + total_log_likelihood on {SINGLE_BY_HAND} (1e-10)")
    return out


def phase_single_models(pt) -> dict:
    """Phase 22, an SDE and an ODE subject on the card against the CPU."""
    from pharmsol_tpu_torch.utils.f32_budget import covariate_model_case

    out = {}
    sde = readme_sde(pt)
    subject = readme_data(pt, 1, np.random.RandomState(SEED + 22)).subjects()[0]
    # both dtypes on the subject's first two observations (2 h of the 8: the
    # march is host-paced, its time goes with the span; float64 took all four
    # before phase 28's cut)
    short = readme_data(pt, 1, np.random.RandomState(SEED + 22), n_obs=2).subjects()[0]
    for dtype, subj, n_obs in ((torch.float64, short, 2), (torch.float32, short, 2)):
        pt.set_float_dtype(dtype)
        t0 = time.perf_counter()
        preds = np.asarray(sde.estimate_predictions(subj, [0.2, 10.0, 0.05], device="cuda")
                           .flat_predictions())
        if dtype == torch.float64:
            t_sde = time.perf_counter() - t0
            log(f"[22] cut: the float64 README SDE predictions took {t_sde:.1f} s on 2 "
                f"observations (before the cut, 4: {BEFORE_CUTS_S['single_sde_f64']} s): "
                f"{BEFORE_CUTS_S['single_sde_f64'] - t_sde:.1f} s saved")
        if preds.shape != (n_obs,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"[22] README SDE {dtype}: {preds}")
        out[f"sde_{str(dtype)[-2:]}"] = preds.tolist()
        log(f"[22] README SDE, 1000 particles, {dtype}, {n_obs} observations: "
            f"{', '.join(f'{v:.4f}' for v in preds)}")
    pt.set_float_dtype(torch.float64)
    quiet = [0.2, 10.0, 0.0]
    card = np.asarray(sde.estimate_predictions(subject, quiet, device="cuda").flat_predictions())
    cpu = np.asarray(sde.estimate_predictions(subject, quiet, device="cpu").flat_predictions())
    sde_err = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    if sde_err > 1e-9:
        raise AssertionError(f"[22] README SDE at zero diffusion against the CPU: {sde_err:.2e}")
    log(f"[22] README SDE at zero diffusion: {sde_err:.2e} relative against the CPU (1e-9)")
    model, data, sp, _ = covariate_model_case(4, 4)
    ode_err = 0.0
    for i, s in enumerate(data.subjects()):
        card = np.asarray(model.estimate_predictions(s, sp[i], device="cuda").flat_predictions())
        cpu = np.asarray(model.estimate_predictions(s, sp[i], device="cpu").flat_predictions())
        ode_err = max(ode_err, float(np.max(np.abs(card - cpu) / np.abs(cpu))))
    if ode_err > 1e-10:
        raise AssertionError(f"[22] covariate ODE against the CPU: {ode_err:.2e}")
    pt.set_float_dtype(torch.float32)
    f32 = np.asarray(model.estimate_predictions(data.subjects()[0], sp[0], device="cuda")
                     .flat_predictions())
    pt.set_float_dtype(torch.float64)
    if not np.all(np.isfinite(f32)):
        raise AssertionError(f"[22] covariate ODE float32: {f32}")
    log(f"[22] covariate ODE example: {ode_err:.2e} relative against the CPU on 4 subjects "
        f"(1e-10), float32 finite")
    out.update(sde_zero_diffusion=sde_err, covariate_ode=ode_err)
    return out


def device_busy_ms(fn) -> float:
    """The card's busy time over one call of ``fn``: the sum of its kernels'
    own device times in a ``torch.profiler`` trace (0 when the profiler
    saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_ms(prof)


def kernel_ms(prof) -> float:
    """The device time of a ``torch.profiler`` trace's kernels, ms: the
    device's own events only (an operator's row repeats the time of the
    kernels it launched, so a sum over every row counts it twice)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_single_times(pt, model, data, params, rems, card: str) -> dict:
    """Phase 22's times on the card, CUDA events after warm-up, lowering
    cached, prediction cache off."""
    from pharmsol_tpu_torch.likelihood.matrix import _device_rows
    from pharmsol_tpu_torch.utils.f32_budget import population_models

    subject = short_subjects(pt, 1, np.random.RandomState(SEED + 22)).subjects()[0]
    closed = pt.Analytical(pt.two_compartments_with_absorption,
                           out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
    ode = ode_model(pt, "short")
    sp = [0.15, 1.2, 0.3, 0.2, 10.0]
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    times = {}
    # float32's row at a quarter of float64's repetitions
    for dtype, cut in ((torch.float64, 1), (torch.float32, 4)):
        pt.set_float_dtype(dtype)
        for m in (closed, ode, model):
            m.disable_cache()
        t = {
            "predictions_closed": cuda_ms(
                lambda: closed.estimate_predictions(subject, sp, device="cuda"), 20 // cut),
            "predictions_ode": cuda_ms(
                lambda: ode.estimate_predictions(subject, sp, device="cuda"), 5 // cut + 1),
            "log_likelihood_closed": cuda_ms(
                lambda: closed.estimate_log_likelihood(subject, sp, ems, device="cuda"),
                20 // cut),
            "batch": cuda_ms(
                lambda: pt.log_likelihood_batch(model, data, params, rems, device="cuda"),
                5 // cut + 1),
        }
        # the batch's parts: the host lowering (a model with no cache), the
        # host steps before the march with the lowering cached, the march
        # and reduction alone, and the card's busy time in one call
        fresh = population_models()[0]
        t0 = time.perf_counter()
        fresh.lower(data.subjects())
        t["batch_host_lowering"] = (time.perf_counter() - t0) * 1e3
        fd, dev = pt.float_dtype(), torch.device("cuda")

        def prep():
            grid = model.lower(data.subjects())
            rems.lower(model.resolve_output_label, model.nouteqs())
            rows = _device_rows(grid, dev, fd)
            rs = torch.as_tensor(np.asarray(grid.row_subject, dtype=np.int64), device=dev)
            return grid, rows, torch.as_tensor(params, dtype=fd, device=dev)[rs]

        t["batch_host_prep"] = wall_ms(prep, 3 // cut + 1)
        grid, rows, p_rows = prep()
        t["batch_march"] = cuda_ms(
            lambda: model._batch_predictions(rows, p_rows, grid.cov_names), 5 // cut + 1)
        t["batch_device_busy"] = device_busy_ms(
            lambda: pt.log_likelihood_batch(model, data, params, rems, device="cuda"))
        times[str(dtype).rsplit(".", 1)[-1]] = t
    pt.set_float_dtype(torch.float64)
    for dt, t in times.items():
        log(f"[22] times on {card}, {dt}: estimate_predictions Short closed form "
            f"{t['predictions_closed']:.3f} ms, ODE {t['predictions_ode']:.3f} ms; "
            f"estimate_log_likelihood {t['log_likelihood_closed']:.3f} ms; "
            f"log_likelihood_batch {SINGLE_BATCH} subjects {t['batch']:.3f} ms (host lowering "
            f"uncached {t['batch_host_lowering']:.1f} ms, host steps with it cached "
            f"{t['batch_host_prep']:.3f} ms, march + reduction {t['batch_march']:.3f} ms, "
            f"card busy {t['batch_device_busy']:.3f} ms)")
    return times


def run_single(pt, card: str) -> dict:
    """Phase 22: the single-subject API and the per-subject batch on the
    card. Every kernel's launch count is 0 before and stays 0: this path
    runs the general engine's march."""
    reset_kernel_launches()
    goldens = phase_golden_scenarios(pt)
    torch.cuda.synchronize()
    model, data, params, rems, _ = single_batch_case(pt)
    batch = phase_single_batch(pt, model, data, params, rems)
    models = phase_single_models(pt)
    times = phase_single_times(pt, model, data, params, rems, card)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_launches().items() if v}
    if launched:
        raise AssertionError(f"[22] a kernel of the table launched on this path: {launched}")
    record = {"goldens": goldens, "batch": batch, "models": models, "times": times,
              "card": card}
    log("[22] single: " + json.dumps(record))
    return record


# ---------------------------------------------------------------------------
# Phase 23: the authoring surfaces (DSL text, the declarative API, .pkm)
# ---------------------------------------------------------------------------

# the cells of phase 23 (subjects x supports), the subjects of the creatinine
# cell's check against the general engine, and the README SDE's twin check
# (subjects x supports, their first observation: cut, the twin's particle
# loop goes with the span; phase 5 holds K3a against its twin at 19 x 23)
AUTHORING_SHORT = (16384, 512)
AUTHORING_CREATININE = (10000, 1000)
AUTHORING_CHECK_ROWS = 256
AUTHORING_SDE = (64, 64)
AUTHORING_SDE_TWIN = (2, 8)
AUTHORING_SDE_TWIN_OBS = 1
# each cell's kernel and its launch counter (kernel_launches' keys)
AUTHORING_COUNTERS = {"K1a": "fused_psi.LAUNCHES", "K1b": "fused_psi.FEATURE_LAUNCHES",
                      "K2a": "fused_ode.LAUNCHES", "K2e": "fused_ode.FEATURE_LAUNCHES",
                      "K3a": "fused_sde.LAUNCHES"}


def authoring_build_targets(pt) -> tuple:
    """The libraries of phase 23's ODE and SDE models, generated from the
    authored closures as their plans generate them: ({key: (name, target)}
    for the explicit ODE tier, the same for the SDE kernel). The DSL ODE
    Short model's and the README SDE's headers are their closure models'
    (the same libraries); the covariate example's declares its covariates
    in its own order (a library of its own)."""
    from pharmsol_tpu_torch.dsl import compile_model
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_sde
    from pharmsol_tpu_torch.utils import authoring_cases as ac
    from pharmsol_tpu_torch.utils.f32_budget import covariate_model_case

    ode, sde = {}, {}
    short = compile_model(ac.DSL_ODE_SHORT).model
    gen = ode_plan_for(short, ac.short_data(2, 0), ac.jittered(ac.ODE_SHORT_CENTRE, 2, 0),
                       ac.ems_for(), torch.float64).rhs
    ode.setdefault(gen.key, ("authoring dsl_ode_short", _build.generated_target(_build.ODE, gen)))
    _, data, sp, ems = covariate_model_case(2, 2, named=True)
    gen = ode_plan_for(ac.covariates_ode_model(), data, sp, ems, torch.float64).rhs
    ode.setdefault(gen.key, ("authoring covariate_model declarative",
                             _build.generated_target(_build.ODE, gen)))
    gen = ode_plan_for(compile_model(ac.DSL_INTRINSICS).model, ac.short_data(2, 0),
                       ac.jittered(ac.INTRINSICS_CENTRE, 2, 0), ac.ems_for(), torch.float64).rhs
    ode.setdefault(gen.key, ("authoring dsl intrinsics", _build.generated_target(_build.ODE, gen)))
    spec = ac.readme_sde_model().spec
    gen = generate_sde(spec.drift, spec.diffusion, spec.nstates, 3, spec.ninput)
    sde.setdefault(gen.key, ("readme declarative", _build.generated_target(_build.SDE, gen)))
    return ode, sde


def authoring_cells(pt) -> list:
    """Phase 23's cells, each a dict: its label and kernel; the model written
    through an authoring surface with its data, support and error models,
    and the host time of writing it (DSL compile or declarative build); the
    hand-written closure model it is held against (None: the general
    engine) with its data and support; the plan builder and kernel runner;
    the float32 budget row (None: held against the closure's float32 psi)
    and the twin's tolerance."""
    from pharmsol_tpu_torch.dsl import compile_model
    from pharmsol_tpu_torch.utils import authoring_cases as ac
    from pharmsol_tpu_torch.utils.f32_budget import COVARIATE_MODEL_CENTRE, covariate_model_case

    def timed(build):
        t0 = time.perf_counter()
        out = build()
        return out, (time.perf_counter() - t0) * 1e3

    cells = []
    n, S = AUTHORING_SHORT
    short_named = ac.short_data(n, SEED + 30)
    short_bare = ac.short_data(n, SEED + 30, named=False)
    closure_1cmt = pt.Analytical(pt.one_compartment_with_absorption,
                                 out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1,
                                 nout=1)
    model, ms = timed(lambda: compile_model(ac.DSL_SHORT).model)
    sp = ac.jittered(ac.SHORT_CENTRE, S, SEED + 31)
    cells.append(dict(
        label=f"dsl_short_1cmt_oral_{n}x{S}", kernel="K1a", model=model, data=short_named,
        sp=sp, ems=ac.ems_for(), compile_ms=ms, closure=closure_1cmt, c_data=short_bare,
        c_sp=np.ascontiguousarray(sp[:, [2, 1, 0]]), c_ems=ac.ems_for(label=0),
        plan=plan_for_model, run=run_kernel, row="one_compartment_with_absorption",
        twin_tol=1e-10, n_params=2))
    nc, Sc = AUTHORING_CREATININE
    model, ms = timed(lambda: compile_model(ac.DSL_CREATININE).model)
    cells.append(dict(
        label=f"dsl_creatinine_1cmt_oral_{nc}x{Sc}", kernel="K1b", model=model,
        data=ac.creatinine_data(nc, SEED + 32), sp=ac.jittered(ac.CREATININE_CENTRE, Sc, SEED + 33),
        ems=ac.ems_for(), compile_ms=ms, closure=None, plan=plan_for_model, run=run_kernel,
        row="seq_multiplier_segment", twin_tol=1e-10, n_params=2))
    model, ms = timed(lambda: compile_model(ac.DSL_ODE_SHORT).model)
    sp = ac.jittered(ac.ODE_SHORT_CENTRE, S, SEED + 34)
    cells.append(dict(
        label=f"dsl_ode_short_{n}x{S}", kernel="K2a", model=model, data=short_named, sp=sp,
        ems=ac.ems_for(), compile_ms=ms, closure=ode_model(pt, "short"), c_data=short_bare,
        c_sp=sp, c_ems=ac.ems_for(label=0), plan=ode_plan_for, run=run_ode_kernel,
        row="ode_dopri5", twin_tol=1e-8))
    closure, c_data, _, c_ems = covariate_model_case(n, 1, seed=SEED + 35)
    _, data, _, ems = covariate_model_case(n, 1, seed=SEED + 35, named=True)
    model, ms = timed(ac.covariates_ode_model)
    sp = jittered_support(COVARIATE_MODEL_CENTRE, S, np.random.RandomState(SEED + 36))
    cells.append(dict(
        label=f"declarative_ode_covariates_{n}x{S}", kernel="K2e", model=model, data=data,
        sp=sp, ems=ems, compile_ms=ms, closure=closure, c_data=c_data, c_sp=sp, c_ems=c_ems,
        plan=ode_plan_for, run=run_ode_kernel, row="ode_lag_fa", twin_tol=1e-8))
    R, Ss = AUTHORING_SDE
    data = readme_data(pt, R, np.random.RandomState(SEED + 37))
    model, ms = timed(ac.readme_sde_model)
    sp = readme_support(Ss, np.random.RandomState(SEED + 38))
    cells.append(dict(
        label=f"declarative_readme_sde_{R}x{Ss}x{SDE_PARTICLES}", kernel="K3a", model=model,
        data=data, sp=sp, ems=readme_ems(pt), compile_ms=ms, closure=readme_sde(pt),
        c_data=data, c_sp=sp, c_ems=readme_ems(pt), plan=sde_plan_for, run=run_sde_kernel,
        row=None, twin_tol=1e-9))
    return cells


def authoring_same_library(cell) -> bool:
    """Whether the authored model and its closure run the same library: the
    closed-form kernel always; an ODE or SDE model where the two generate
    the same header."""
    if cell["kernel"] in ("K1a", "K1b"):
        return True
    plans = [cell["plan"](m, d, sp[:2], e, torch.float64) for m, d, sp, e in (
        (cell["model"], cell["data"], cell["sp"], cell["ems"]),
        (cell["closure"], cell["c_data"], cell["c_sp"], cell["c_ems"]))]
    keys = [(p.gen if cell["kernel"] == "K3a" else p.rhs).key for p in plans]
    return keys[0] == keys[1]


def plan_for_model(model, data, support, ems, dtype):
    """``plan_for`` with the package imported here (the closed-form plan)."""
    import pharmsol_tpu_torch as pt

    return plan_for(pt, model, data, support, ems, dtype)


def authoring_times(pt, cell, dtype, card: str) -> dict:
    """The cell's kernel alone (CUDA events), its plan on the lowered grid
    and one call end to end (host clock), and for a closed form the
    kernel-input decomposition alone; ms."""
    from pharmsol_tpu_torch.likelihood.plans.decompose import _decompose_kernel_inputs

    model, data, sp, ems = cell["model"], cell["data"], cell["sp"], cell["ems"]
    sde = cell["kernel"] == "K3a"
    plan = cell["plan"](model, data, sp, ems, dtype)
    t = {
        "kernel": cuda_ms(lambda: cell["run"](plan), 1 if sde else 10, 0 if sde else 1),
        "plan": wall_ms(lambda: cell["plan"](model, data, sp, ems, dtype), 3),
        "end_to_end": wall_ms(lambda: pt.log_likelihood_matrix(model, data, sp, ems,
                                                               device="cuda"),
                              1 if sde else 3, 0 if sde else 1),
    }
    if cell["kernel"] in ("K1a", "K1b"):
        grid = model.lower(data.subjects())
        t["decompose"] = wall_ms(lambda: _decompose_kernel_inputs(
            model._kernel_inputs, sp, grid, cell["n_params"], True), 3, 0)
    cells = len(data) * sp.shape[0]
    d = str(dtype)[6:]
    log(f"[23] {cell['label']} {d}: kernel {t['kernel']:.3f} ms ({cells / (t['kernel'] * 1e-3):.4g} "
        f"cells/s), plan {t['plan']:.3f} ms, end to end {t['end_to_end']:.3f} ms, kernel share "
        f"{t['kernel'] / t['end_to_end']:.4f}"
        + (f"; kernel-input decomposition {t['decompose']:.3f} ms = "
           f"{t['decompose'] / t['end_to_end']:.4f} of the call" if "decompose" in t else "")
        + f"  ({card})")
    return t


def authoring_cell(pt, cell, card: str) -> dict:
    """One phase-23 cell: per dtype, one call through the entry point with
    every launch counter set to 0 just before and read just after (the
    engine fused, exactly one launch of the cell's kernel and of no other);
    psi held against the closure model (every cell equal where both run the
    same library, else float64 within 1e-12 relative) or against the
    general engine on the first subjects (float64 1e-10, float32 1e-3); the
    float32 psi against the float64 one (every cell within 1e-3, 99.9%
    within the model's budget row); the kernel against its twin on the
    same plan (float64: the closed forms every cell within 1e-10, the ODE
    tiers every cell within 1e-6 and 99.9% within 1e-8, the SDE at the
    twin's Philox numbers on a cut shape); the times."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error

    t_cell = time.perf_counter()
    label, kernel = cell["label"], cell["kernel"]
    model, data, sp, ems = cell["model"], cell["data"], cell["sp"], cell["ems"]
    sde = kernel == "K3a"
    rec = {"kernel": kernel, "compile_ms": cell["compile_ms"], "launches": 0}
    same = cell["closure"] is not None and authoring_same_library(cell)
    rec["same_library_as_closure"] = same
    psi64 = None
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        d = str(dtype)[6:]
        reset_kernel_launches()
        psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernel_launches().items() if v}
        dec = pt.last_engine_decision(model)
        if dec["engine"] != "fused":
            raise AssertionError(f"[23] {label} {d}: engine {dec}")
        if launched != {AUTHORING_COUNTERS[kernel]: 1}:
            raise AssertionError(f"[23] {label} {d}: launches {launched}, expected one {kernel}")
        rec["launches"] += 1
        if tuple(psi.shape) != (len(data), sp.shape[0]) or psi.device.type != "cuda":
            raise AssertionError(f"[23] {label}: psi {tuple(psi.shape)} on {psi.device}")
        if bool(torch.isnan(psi).any()) or (not sde and not bool(torch.isfinite(psi).all())):
            raise AssertionError(f"[23] {label} {d}: non-finite psi")
        if cell["closure"] is not None:
            want = pt.log_likelihood_matrix(cell["closure"], cell["c_data"], cell["c_sp"],
                                            cell["c_ems"], device="cuda")
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            if not bool((torch.isfinite(psi) == fin).all()):
                raise AssertionError(f"[23] {label} {d}: finite cells differ from the closure's")
            err = rel_err(psi[fin], want[fin], 1.0)
            diff = int((psi[fin] != want[fin]).sum())
            # the same library on the same inputs: every cell equal; another
            # header (the covariates declared in another order): float64
            # within 1e-12, float32 held by its budget row below
            rule = ("every cell equal" if same else
                    "rel <= 1e-12" if dtype == torch.float64 else "not held (budget row)")
            log(f"[23] {label} {d}: engine fused, {launched}; vs the closure model rel {err:.3e}, "
                f"{diff} of {int(fin.sum())} cells differ at all (same library: {same}; "
                f"{rule})")
            if (same and diff) or (not same and dtype == torch.float64 and err > 1e-12):
                raise AssertionError(f"[23] {label} {d}: vs the closure: rel {err}, {diff} "
                                     "cells differ")
            rec[f"vs_closure_{d}"] = err
            rec[f"cells_differ_{d}"] = diff
        else:
            rows = AUTHORING_CHECK_ROWS
            sub = pt.Data(data.subjects()[:rows])
            want = pt.log_likelihood_matrix(model, sub, sp, ems, device="cuda", engine="general")
            torch.cuda.synchronize()
            err = rel_err(psi[:rows], want, 1.0)
            tol = 1e-10 if dtype == torch.float64 else 1e-3
            log(f"[23] {label} {d}: engine fused, {launched}; vs the general engine on subjects "
                f"0-{rows - 1} rel {err:.3e} (<= {tol:g})")
            if err > tol:
                raise AssertionError(f"[23] {label} {d}: vs the general engine {err} > {tol}")
            rec[f"vs_general_{d}"] = err
        if dtype == torch.float64:
            psi64 = psi
        elif cell["row"] is not None:
            # the budget row of the model's class, held as the earlier phases
            # hold float32 at full width: the closed form is 0/0-prone in
            # float32 where a support's ka meets a decay constant (ROADMAP
            # Queue 1 item 5), so every cell within 1e-3 and 99.9% within
            # the row
            err = f32_error(psi.cpu().numpy(), psi64.cpu().numpy())
            budget = F32_BUDGET[cell["row"]]
            cellwise = ((psi.double() - psi64.double()).abs()
                        / psi64.double().abs().clamp(min=1.0))
            share = float((cellwise <= budget).double().mean())
            log(f"[23] {label} f32 vs its f64 psi: max {err:.3e} (<= 1e-3), {share * 100:.4f}% "
                f"of cells within {cell['row']} {budget:g} (>= 99.9%), "
                f"{int((cellwise > budget).sum())} beyond")
            if err > 1e-3 or share < 0.999:
                raise AssertionError(f"[23] {label}: f32 max {err}, {share} within {budget}")
            rec["f32_vs_f64"] = err
            rec["f32_share_within_row"] = share
        rec[f"times_{d}"] = authoring_times(pt, cell, dtype, card)
    # the kernel against its twin on the same plan (float64); an SDE cell's
    # on its subjects' first AUTHORING_SDE_TWIN_OBS observations (the twin's
    # masked loop takes time with the span)
    pt.set_float_dtype(torch.float64)
    if sde:
        Rt, St = AUTHORING_SDE_TWIN
        sub = readme_data(pt, Rt, np.random.RandomState(SEED + 39), n_obs=AUTHORING_SDE_TWIN_OBS)
        plan = sde_plan_for(model, sub, sp[:St], ems, torch.float64)
        got, twin = run_sde_kernel(plan), run_sde_kernel(plan, plain=True)
        torch.cuda.synchronize()
        abs_err, rel = sde_compare(f"{label} kernel vs twin at {Rt}x{St}x{SDE_PARTICLES} (cut) "
                                   "f64", got, twin, cell["twin_tol"], 0.999, phase=23)
    else:
        plan = cell["plan"](model, data, sp, ems, torch.float64)
        got, twin = cell["run"](plan), cell["run"](plan, plain=True)
        torch.cuda.synchronize()
        abs_err = float((got - twin).abs().max())
        rel = rel_err(got, twin, 1.0)
        # the adaptive ODE march: every cell within 1e-6 and 99.9% within
        # 1e-8 (a step decision can flip at a rounding tie), as phases 2-8
        # hold K2a and K2e; the closed forms: every cell within 1e-10
        every = 1e-6 if kernel in ("K2a", "K2e") else cell["twin_tol"]
        cellwise = (got - twin).abs() / twin.abs().clamp(min=1.0)
        share = float((cellwise <= cell["twin_tol"]).double().mean())
        log(f"[23] {label} kernel vs twin f64: max abs {abs_err:.3e}, rel {rel:.3e} "
            f"(<= {every:g}), {share * 100:.4f}% of cells within {cell['twin_tol']:g} "
            f"(>= 99.9%)")
        if rel > every or share < 0.999:
            raise AssertionError(f"[23] {label}: kernel vs twin {rel}, {share} within "
                                 f"{cell['twin_tol']}")
    rec["twin_rel"] = rel
    rec["seconds"] = time.perf_counter() - t_cell
    log(f"[23] {label}: {rec['launches']} {kernel} launches on the entry point's calls, cell "
        f"{rec['seconds']:.1f} s, written in {cell['compile_ms']:.1f} ms (host)")
    return rec


def authoring_intrinsics(pt) -> dict:
    """The DSL model that reads every intrinsic the RHS generator took for
    the DSL (floor, ceil, round, sin, cos, tan, log10, log2) on K2a, 64
    Short subjects x 48 supports: per dtype one call through the entry point
    (fused, one K2a launch); the kernel against its twin (float64: every
    cell within 1e-6, 99.9% within 1e-8) and against the general engine
    (float64 1e-4, the controller's error)."""
    from pharmsol_tpu_torch.dsl import compile_model
    from pharmsol_tpu_torch.utils import authoring_cases as ac

    model = compile_model(ac.DSL_INTRINSICS).model
    data, sp, ems = ac.short_data(64, SEED + 40), ac.jittered(ac.INTRINSICS_CENTRE, 48, SEED + 41), \
        ac.ems_for()
    rec = {}
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        reset_kernel_launches()
        psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernel_launches().items() if v}
        dec = pt.last_engine_decision(model)
        if dec["engine"] != "fused" or launched != {"fused_ode.LAUNCHES": 1}:
            raise AssertionError(f"[23] intrinsics: engine {dec}, launches {launched}")
        if not bool(torch.isfinite(psi).all()):
            raise AssertionError("[23] intrinsics: non-finite psi")
        if dtype == torch.float64:
            plan = ode_plan_for(model, data, sp, ems, dtype)
            got, twin = run_ode_kernel(plan), run_ode_kernel(plan, plain=True)
            general = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda",
                                               engine="general")
            torch.cuda.synchronize()
            rel = rel_err(got, twin, 1.0)
            share = float(((got - twin).abs() / twin.abs().clamp(min=1.0) <= 1e-8)
                          .double().mean())
            vs_general = rel_err(psi, general, 1.0)
            log(f"[23] DSL intrinsics 64x48 f64: {launched}; kernel vs twin rel {rel:.3e} "
                f"(<= 1e-6), {share * 100:.4f}% within 1e-8 (>= 99.9%); fused vs general "
                f"{vs_general:.3e} (<= 1e-4)")
            if rel > 1e-6 or share < 0.999 or vs_general > 1e-4:
                raise AssertionError(f"[23] intrinsics: twin {rel} / {share}, general "
                                     f"{vs_general}")
            rec.update(twin_rel=rel, vs_general=vs_general)
    return rec


def authoring_artifact(pt, cell) -> dict:
    """The DSL creatinine model saved as a .pkm artifact, loaded back and run
    on the card at full width: psi equal to the model compiled from source
    (float64 and float32), one K1b launch a call."""
    from pharmsol_tpu_torch.dsl import compile_model, load_runtime_artifact
    from pharmsol_tpu_torch.utils import authoring_cases as ac

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "dsl_creatinine.pkm"
    compile_model(ac.DSL_CREATININE).save_artifact(str(path))
    t0 = time.perf_counter()
    loaded = load_runtime_artifact(str(path), validate=True).model
    load_ms = (time.perf_counter() - t0) * 1e3
    rec = {"load_ms": load_ms}
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        reset_kernel_launches()
        got = pt.log_likelihood_matrix(loaded, cell["data"], cell["sp"], cell["ems"],
                                       device="cuda")
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernel_launches().items() if v}
        want = pt.log_likelihood_matrix(cell["model"], cell["data"], cell["sp"], cell["ems"],
                                        device="cuda")
        equal = bool(torch.equal(got, want))
        log(f"[23] .pkm {path.name} ({path.stat().st_size} bytes, loaded in {load_ms:.1f} ms) "
            f"{str(dtype)[6:]}: {launched}, psi equal to the source's: {equal}")
        if launched != {"fused_psi.FEATURE_LAUNCHES": 1} or not equal:
            raise AssertionError(f"[23] .pkm: launches {launched}, psi equal {equal}")
        rec[f"equal_{str(dtype)[6:]}"] = equal
    return rec


def authoring_fits(pt, card: str) -> dict:
    """The NPAG fit over the DSL 1-cmt closed form against the same fit over
    the closure model, on phase 10's population (float64, 10 000 subjects,
    1000 start points, 8 cycles): the same cycles and support count,
    log-likelihood within 1e-8 relative; each fit's psi calls one K1a launch
    each (``phase_fit``)."""
    from pharmsol_tpu_torch.dsl import compile_model
    from pharmsol_tpu_torch.utils import authoring_cases as ac
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    data, ems, _ = population_10k_case(FIT_SUBJECTS)
    named, named_ems, _ = population_10k_case(FIT_SUBJECTS, named=True)
    a = phase_fit(pt, "fit closure 1-cmt 10000", population_models()[0], data, ems, "K1a",
                  card, phase=23)
    b = phase_fit(pt, "fit DSL 1-cmt 10000", compile_model(ac.DSL_POPULATION).model, named,
                  named_ems, "K1a", card, phase=23)
    fa, fb = a.pop("fit"), b.pop("fit")
    r_ll = abs(fb.log_likelihood - fa.log_likelihood) / abs(fa.log_likelihood)
    log(f"[23] DSL fit vs closure fit: log-likelihood {fb.log_likelihood:.6f} vs "
        f"{fa.log_likelihood:.6f} rel {r_ll:.3e} (<= 1e-8), cycles {fb.cycles} vs {fa.cycles}, "
        f"support {fb.support.shape[0]} vs {fa.support.shape[0]}")
    if not (r_ll <= 1e-8 and fb.cycles == fa.cycles
            and fb.support.shape == fa.support.shape):
        raise AssertionError(f"[23] DSL fit vs closure fit: ll rel {r_ll}, cycles "
                             f"{fb.cycles}/{fa.cycles}, support {fb.support.shape}/"
                             f"{fa.support.shape}")
    return {"closure": a, "dsl": b, "log_likelihood": fb.log_likelihood, "ll_rel": r_ll,
            "cycles": fb.cycles, "support": int(fb.support.shape[0])}


def run_authoring(pt, card: str) -> dict:
    """Phase 23: models written as DSL text and with the declarative API (no
    closure written by hand) through the entry points, on the existing
    kernels at full width, in float32 and float64, held against their
    closure models, their twins and the general engine; a .pkm artifact run
    on the card; the NPAG fit over the DSL closed form."""
    t0 = time.perf_counter()
    cells = authoring_cells(pt)
    log(f"[23] the authoring cells' data and models in {time.perf_counter() - t0:.1f} s")
    record = {"cells": {}, "card": card}
    for cell in cells:
        record["cells"][cell["label"]] = authoring_cell(pt, cell, card)
    record["intrinsics"] = authoring_intrinsics(pt)
    record["artifact"] = authoring_artifact(pt, cells[1])
    record["fits"] = authoring_fits(pt, card)
    pt.set_float_dtype(torch.float64)
    record["seconds"] = time.perf_counter() - t0
    log(f"[23] authoring: {record['seconds']:.1f} s for the phase  ({card})")
    log("[23] authoring: " + json.dumps(record, default=float))
    return record


# ---------------------------------------------------------------------------
# Phase 24: the estimation layer (MAP, Laplace/FOCE, FIM, SAEM)
# ---------------------------------------------------------------------------

# (a) the differentiable likelihood on phase 10's population, held against
# the CPU on its first EST_LL_HELD subjects
EST_LL_SUBJECTS = 10000
EST_LL_HELD = 512
EST_LL_PARAMS = (1.2, 0.15, 30.0)
# (c), (d): the population of the JAX package's tests/test_laplace.py
# (its generator, rebuilt from numpy), 1-cmt, proportional error
EST_POP = 200
EST_THETA0 = (0.4, 8.0)
# (c): the dopri5 ODE Laplace path through the forward sensitivities on the
# population and settings of the JAX package's adaptive-ODE Laplace test
# (tests/test_laplace.py::test_laplace_forward_mode_adaptive_ode: 4
# subjects, 2 observations each, omega0 0.3, 12 inner steps), cut from its 15
# outer iterations to 2, then the standard errors there: a check of the
# path, not a fit (every objective evaluation takes seconds on the card). The
# Hessian's smallest eigenvalue there is printed beside the result (after 1
# iteration it is negative and there are no SEs to hold)
EST_ODE_SUBJECTS = 4
EST_ODE_THETA0 = (0.45, 7.0)
EST_ODE_KW = dict(omega0=0.3, inner_steps=12, max_iters=2)
# (d): the SAEM fit at a quarter of the defaults' 200 burn-in and 100
# averaging iterations
EST_SAEM_KW = dict(n_burn=25, n_iters=12)
# card against CPU
EST_TOL = dict(ll_value=1e-12, ll_grad=1e-10, map=1e-8, laplace=1e-6, se=1e-5,
               saem_trace=1e-8, saem=1e-6)


def est_laplace_population(pt, n: int, seed: int = 3, b_noise: float = 0.08):
    """``tests/test_laplace.py::_population`` (the JAX package's test data)
    rebuilt from numpy in its draw order: log-normal ke (omega 0.3) and v
    (0.15) around 0.25 and 10, 100 at 0, five observations with proportional
    noise."""
    rng = np.random.default_rng(seed)
    subjects = []
    for i in range(n):
        ke = 0.25 * np.exp(0.3 * rng.standard_normal())
        v = 10.0 * np.exp(0.15 * rng.standard_normal())
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 2.0, 6.0, 12.0, 24.0):
            c = 100.0 * np.exp(-ke * t) / v
            y = c * (1 + b_noise * rng.standard_normal())
            y += 0.0 * rng.standard_normal()  # the generator's combined-error draw
            b = b.observation(float(t), float(y), 0)
        subjects.append(b.build())
    return pt.Data(subjects)


def est_ode_population(pt, n: int):
    """The data of the JAX package's adaptive-ODE Laplace test, rebuilt from
    numpy in its draw order: log-normal ke and v (0.2) around 0.25 and 10,
    100 at 0, observations at 1 and 6 h with 5% proportional noise."""
    rng = np.random.RandomState(3)
    etas = rng.randn(n, 2) * 0.2
    subjects = []
    for i in range(n):
        ke, v = 0.25 * np.exp(etas[i, 0]), 10.0 * np.exp(etas[i, 1])
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (1.0, 6.0):
            b = b.observation(float(t), float(100.0 * np.exp(-ke * t) / v
                                              * (1 + 0.05 * rng.randn())), 0)
        subjects.append(b.build())
    return pt.Data(subjects)


def est_models(pt):
    """(1-cmt closed form, its dopri5 ODE, proportional residual 0.2)."""
    closed = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                           nstates=1, ndrugs=1, nout=1)
    ode = pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([-p[0] * x[0] + b[0]]),
                 out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.2))
    return closed, ode, rems


def est_map_cases(pt):
    """(b): one Short subject (100 mg oral, the 9 Short observations)
    simulated from the 1-cmt oral closed form (5% proportional noise) and
    that closed form; the first subject of phase 10's population and the
    1-cmt oral model as a dopri5 ODE (default tolerances). (name, model,
    data, ems, x0)."""
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    nominal = np.array([1.2, 0.15, 30.0])
    closed = population_models()[0]
    b = pt.Subject.builder("short").bolus(0.0, 100.0, 0)
    for t in SHORT_TIMES:
        b = b.observation(t, 1.0, 0)
    clean = closed.estimate_predictions(b.build(), nominal, device="cpu").flat_predictions()
    rng = np.random.RandomState(SEED + 24)
    b = pt.Subject.builder("short").bolus(0.0, 100.0, 0)
    for t, c in zip(SHORT_TIMES, clean):
        b = b.observation(t, float(c * (1.0 + 0.05 * rng.randn())), 0)
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.proportional(
        pt.ErrorPoly(0.0, 0.05), 1.0))
    ode = pt.ODE(rhs_bolus_infusion, out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2,
                 ndrugs=1, nout=1)
    data, pop_ems, _ = population_10k_case(1)
    return [("closed-form Short", closed, pt.Data([b.build()]), ems,
             nominal * np.array([1.3, 0.8, 1.2])),
            ("dopri5 ODE", ode, data, pop_ems, np.array([1.5, 0.09, 28.0]))]


def est_ll(pt, device):
    """(a): ``log_likelihood_fn``'s value, autograd gradient and per-subject
    Jacobian (``torch.func.jacfwd``) at ``EST_LL_PARAMS`` on ``n`` subjects."""
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    data, ems, _ = population_10k_case(EST_LL_SUBJECTS)
    model = population_models()[0]
    held = pt.Data(data.subjects()[:EST_LL_HELD])
    out = {}
    for tag, d in (("held", held), ("full", data)) if device == "cuda" else (("held", held),):
        fn = model.log_likelihood_fn(d, ems, device=device)
        per = model.log_likelihood_fn(d, ems, per_subject=True, device=device)
        p = torch.tensor(EST_LL_PARAMS, dtype=torch.float64, device=device, requires_grad=True)
        value = fn(p)
        (grad,) = torch.autograd.grad(value, p)
        jac = torch.func.jacfwd(per)(p.detach())
        out[tag] = dict(value=float(value.detach()), grad=grad.cpu().numpy(),
                        jac=jac.cpu().numpy(), fn=fn, per=per)
    return out


def est_saem_fit(pt, device, introspect=None, **kw):
    closed, _, rems = est_models(pt)
    return pt.optimize.fit_saem(closed, est_laplace_population(pt, EST_POP), rems,
                                list(EST_THETA0), device=device, _introspect=introspect, **kw)


def est_maps(pt, device) -> dict:
    """(b) on ``device``: each MAP fit's estimates and SEs."""
    out = {}
    for name, model, data, ems, x0 in est_map_cases(pt):
        r = pt.optimize.fit_map(model, data, ems, x0, grad_tol=1e-9, max_iters=300,
                                device=device)
        out[f"map {name}"] = dict(parameters=r.parameters, se=r.standard_errors,
                                  converged=r.converged, iterations=r.iterations)
    return out


def est_closed_laplace(pt, device) -> dict:
    """(c)'s closed-form Laplace fit and its standard errors on ``device``."""
    closed, _, rems = est_models(pt)
    pop = est_laplace_population(pt, EST_POP)
    t0 = time.perf_counter()
    lap = pt.optimize.fit_laplace(closed, pop, rems, list(EST_THETA0), device=device)
    t1 = time.perf_counter()
    fim = pt.optimize.laplace_standard_errors(closed, pop, rems, lap, device=device)
    t2 = time.perf_counter()
    return dict(theta=lap.theta, omega=lap.omega, sigma=np.array([lap.residual_models.get(0).b]),
                ll=np.array([lap.log_likelihood]), se=lap.standard_errors,
                omega_se=lap.omega_standard_errors, fim_theta_se=fim.theta_se,
                fim_sigma_se=fim.sigma_se, converged=lap.converged,
                iterations=lap.iterations, s=t1 - t0, fim_s=t2 - t1)


def est_ode_check(pt, device) -> dict:
    """(c)'s dopri5 Laplace check on ``device``: ``EST_ODE_KW``'s outer
    iterations, then the standard errors there, and the smallest eigenvalue
    of the Hessian they invert (the SEs exist where it is positive)."""
    _, ode, _ = est_models(pt)
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.1))
    intro = {}
    t0 = time.perf_counter()
    fit = pt.optimize.fit_laplace(ode, est_ode_population(pt, EST_ODE_SUBJECTS), rems,
                                  list(EST_ODE_THETA0), device=device, _introspect=intro,
                                  **EST_ODE_KW)
    return dict(theta=fit.theta, omega=fit.omega,
                sigma=np.array([fit.residual_models.get(0).b]), se=fit.standard_errors,
                iterations=fit.iterations, s=time.perf_counter() - t0,
                min_eig=float(np.linalg.eigvalsh(intro["hessian"])[0]))


def est_saem(pt, device) -> dict:
    """(d) on ``device``: the SAEM fit at its defaults, its decisions, its
    seconds and its iteration loop's seconds."""
    intro = {}
    t0 = time.perf_counter()
    sae = est_saem_fit(pt, device, intro, **EST_SAEM_KW)
    return dict(theta=sae.theta, omega=sae.omega,
                sigma=np.array([sae.residual_models.get(0).b]), ll_trace=sae.ll_trace,
                accepted=intro["accepted"], accept_rate=sae.accept_rate,
                s=time.perf_counter() - t0, loop_s=intro["loop_s"])


# phase 24's parts after (a), in the order the card runs them: the timed
# ones first, with nothing else running; the CPU references run them all in
# worker processes afterwards, beside the card's MAP fits, which are held
# but not timed (PERF.md asks no time of them)
EST_PARTS = {"Laplace": lambda pt, d: {"laplace": est_closed_laplace(pt, d)},
             "dopri5 Laplace": lambda pt, d: {"laplace ode": est_ode_check(pt, d)},
             "SAEM": lambda pt, d: {"saem": est_saem(pt, d)}, "MAP": est_maps}
EST_UNTIMED = "MAP"


def est_worker(part: str) -> tuple:
    """One of phase 24's CPU reference processes: ``part`` of
    ``EST_PARTS`` (with (a) on the held subjects beside the MAP fits) in
    float64 on the CPU, and its seconds."""
    import pharmsol_tpu_torch as pt

    torch.set_num_threads(2)
    pt.set_float_dtype(torch.float64)
    pt.set_device("cpu")
    t0 = time.perf_counter()
    out = EST_PARTS[part](pt, "cpu")
    if part == "MAP":
        ll = est_ll(pt, "cpu")["held"]
        out["ll"] = {k: ll[k] for k in ("value", "grad", "jac")}
    return out, time.perf_counter() - t0


def est_close(label: str, got, want, tol: float, floor: float = 1e-300) -> float:
    if got is None or want is None:
        raise AssertionError(f"[24] {label}: {got} on the card, {want} on the CPU")
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"[24] {label}: {got} against the CPU's {want}")
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))
    if err > tol:
        raise AssertionError(f"[24] {label} against the CPU: {err:.2e} > {tol:.0e}")
    return err


def est_iteration_busy(pt) -> float:
    """The card's busy time in one SAEM iteration (ms): two short fits (2
    and 3 iterations) under ``torch.profiler``, the difference of their
    kernels' device times, after a first profiled fit that is not kept (the
    profiler's own start-up)."""
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for n_burn in (1, 1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            est_saem_fit(pt, "cuda", n_burn=n_burn, n_iters=1)
            torch.cuda.synchronize()
        busy[n_burn] = kernel_ms(prof)
    if busy[2] <= busy[1]:
        raise AssertionError(f"[24] the profiler saw no device time in an SAEM iteration: {busy}")
    return busy[2] - busy[1]


class RefWindow:
    """The CPU reference processes of phases 24 and 25 and the untimed card
    work beside them: each phase adds its jobs (``add``) and its card work
    (``beside``) after its own timed card work; ``run`` starts one process a
    job, runs the card work, waits for every job and returns their results
    by key and the window's seconds. A whole run shares one window between
    the two phases, after both phases' timed work; a partial run gives each
    its own."""

    def __init__(self):
        self.jobs, self.card = [], []

    def add(self, key, fn, args):
        self.jobs.append((key, fn, args))

    def beside(self, fn):
        self.card.append(fn)

    def run(self) -> tuple:
        import multiprocessing as mp

        t0 = time.perf_counter()
        pool = mp.get_context("spawn").Pool(len(self.jobs))
        try:
            handles = {key: pool.apply_async(fn, args) for key, fn, args in self.jobs}
            pool.close()
            for fn in self.card:
                fn()
            torch.cuda.synchronize()
            done = {key: h.get(timeout=1800) for key, h in handles.items()}
        finally:
            pool.terminate()
            pool.join()
        return done, time.perf_counter() - t0


def run_estimation(pt, card: str, window: RefWindow = None):
    """Phase 24: the estimation layer on the card in float64, every result
    held against the port's own CPU float64 result on the same inputs. The
    card's timed work runs first with no other process of this script
    running, so its times are its own; then the CPU references, one worker
    process per part of ``EST_PARTS`` (:func:`est_worker`), while the card
    runs the untimed MAP fits. No kernel of the table runs
    on this path (the general engine's per-row march): every launch count is
    0 before and stays 0. Given a shared ``window`` (a whole run), the
    references and the MAP fits join it and this returns the phase's
    checks, ``finish(done, window_s)``, for when it has run."""
    t_phase = time.perf_counter()
    pt.set_float_dtype(torch.float64)
    reset_kernel_launches()
    # (a) the differentiable likelihood at full width, then its times
    ll = est_ll(pt, "cuda")
    full, held = ll["full"], ll["held"]
    p = torch.tensor(EST_LL_PARAMS, dtype=torch.float64, device="cuda")

    def value_and_grad():
        x = p.clone().requires_grad_(True)
        return torch.autograd.grad(full["fn"](x), x)

    ll_ms = dict(value=cuda_ms(lambda: full["fn"](p), 5),
                 value_and_grad=cuda_ms(value_and_grad, 5),
                 jacobian=cuda_ms(lambda: torch.func.jacfwd(full["per"])(p), 3))
    if full["jac"].shape != (EST_LL_SUBJECTS, 3) or not np.all(np.isfinite(full["jac"])):
        raise AssertionError(f"[24] per-subject Jacobian: {full['jac'].shape}")
    # the full population's Jacobian rows are the held subjects' (rows are
    # independent) and its column sums the gradient
    est_close("Jacobian rows, full against held", full["jac"][:EST_LL_HELD], held["jac"], 1e-12)
    est_close("Jacobian column sums against the gradient", full["jac"].sum(axis=0),
              full["grad"], 1e-9)
    # (c), (d), then the busy share of one SAEM iteration
    card_fits = {}
    for name, part in EST_PARTS.items():
        if name != EST_UNTIMED:
            card_fits.update(part(pt, "cuda"))
    busy_ms = est_iteration_busy(pt)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t_phase
    shared = window is not None
    window = window if shared else RefWindow()
    for part in EST_PARTS:
        window.add(("24", part), est_worker, (part,))
    # (b) meanwhile
    window.beside(lambda: card_fits.update(EST_PARTS[EST_UNTIMED](pt, "cuda")))
    if shared:
        return lambda done, t_cpu: est_finish(card, card_fits, held, ll_ms, busy_ms, t_card,
                                              done, t_cpu, shared)
    done, t_cpu = window.run()
    return est_finish(card, card_fits, held, ll_ms, busy_ms, t_card, done, t_cpu, shared)


def est_finish(card, card_fits, held, ll_ms, busy_ms, t_card, done, t_cpu, shared) -> dict:
    """Phase 24's checks once its CPU references are in: each card result
    against the CPU's; the phase's lines and record."""
    done = {part: done[("24", part)] for part in EST_PARTS}
    launched = {k: v for k, v in kernel_launches().items() if v}
    if launched:
        raise AssertionError(f"[24] a kernel of the table launched on this path: {launched}")
    cpu = {}
    for out, _ in done.values():
        cpu.update(out)
    worker_s = {part: s for part, (_, s) in done.items()}

    errs = {}
    errs["ll value"] = est_close("log_likelihood_fn value", held["value"], cpu["ll"]["value"],
                                 EST_TOL["ll_value"])
    errs["ll grad"] = est_close("gradient", held["grad"], cpu["ll"]["grad"], EST_TOL["ll_grad"])
    errs["ll jac"] = est_close("per-subject Jacobian", held["jac"], cpu["ll"]["jac"],
                               EST_TOL["ll_grad"], 1e-6)
    log(f"[24] log_likelihood_fn, 1-cmt oral, {EST_LL_SUBJECTS} subjects on {card}: value "
        f"{ll_ms['value']:.2f} ms, value + gradient {ll_ms['value_and_grad']:.2f} ms, "
        f"per-subject Jacobian (jacfwd) {ll_ms['jacobian']:.2f} ms; against the CPU on "
        f"{EST_LL_HELD}: value {errs['ll value']:.2e}, gradient {errs['ll grad']:.2e}, "
        f"Jacobian {errs['ll jac']:.2e}")
    for name in (k for k in card_fits if k.startswith("map ")):
        c, w = card_fits[name], cpu[name]
        if not c["converged"]:
            raise AssertionError(f"[24] {name}: not converged in {c['iterations']}")
        errs[name] = est_close(name, c["parameters"], w["parameters"], EST_TOL["map"])
        errs[name + " se"] = est_close(name + " SEs", c["se"], w["se"], EST_TOL["se"])
        log(f"[24] fit_map {name}: {c['iterations']} iterations on the card (not timed); "
            f"estimates {errs[name]:.2e}, SEs {errs[name + ' se']:.2e} against the CPU")
    c, w = card_fits["laplace"], cpu["laplace"]
    est_keys = ("theta", "omega", "sigma")
    se_keys = ("se", "omega_se", "fim_theta_se", "fim_sigma_se")
    if not c["converged"]:
        raise AssertionError(f"[24] fit_laplace: not converged in {c['iterations']}")
    for key in est_keys + ("ll",):
        errs["laplace " + key] = est_close("fit_laplace " + key, c[key], w[key],
                                           EST_TOL["laplace"])
    for key in se_keys:
        errs["laplace " + key] = est_close("fit_laplace " + key, c[key], w[key], EST_TOL["se"])
    log(f"[24] fit_laplace, {EST_POP} subjects, 1-cmt, proportional: {c['iterations']} "
        f"iterations, {c['s']:.2f} s on the card, "
        f"{1e3 * c['s'] / c['iterations']:.0f} ms per outer iteration; "
        f"laplace_standard_errors {c['fim_s']:.2f} s; theta "
        f"{c['theta'].tolist()} omega {c['omega'].tolist()} sigma {c['sigma'].tolist()}; "
        f"against the CPU: estimates <= {max(errs['laplace ' + k] for k in est_keys):.2e}, "
        f"SEs <= {max(errs['laplace ' + k] for k in se_keys):.2e}")
    c, w = card_fits["laplace ode"], cpu["laplace ode"]
    for key in ("theta", "omega", "sigma"):
        errs["laplace ode " + key] = est_close("ODE fit_laplace " + key, c[key], w[key],
                                               EST_TOL["laplace"])
    eig = f"the Hessian's smallest eigenvalue {c['min_eig']:.6g} on the card, " \
          f"{w['min_eig']:.6g} on the CPU"
    errs["laplace ode se"] = est_close(f"ODE fit_laplace SEs ({eig})", c["se"], w["se"],
                                       EST_TOL["se"])
    log(f"[24] fit_laplace check, dopri5 ODE through the forward sensitivities, "
        f"{EST_ODE_SUBJECTS} subjects, {EST_ODE_KW} (not a converged fit): {c['iterations']} "
        f"outer iterations, then the SEs there ({eig}), {c['s']:.1f} s on the card; "
        f"estimates {max(errs['laplace ode ' + k] for k in ('theta', 'omega', 'sigma')):.2e}, "
        f"SEs {errs['laplace ode se']:.2e} against the CPU")
    c, w = card_fits["saem"], cpu["saem"]
    flips = int(np.sum(c["accepted"] != w["accepted"]))
    first = (int(np.argmax(np.any(c["accepted"] != w["accepted"], axis=(1, 2))))
             if flips else None)
    errs["saem trace"] = est_close("fit_saem ll trace (first 20)", c["ll_trace"][:20],
                                   w["ll_trace"][:20], EST_TOL["saem_trace"])
    for key in ("theta", "omega", "sigma"):
        errs["saem " + key] = est_close("fit_saem " + key, c[key], w[key], EST_TOL["saem"])
    n_it = len(c["ll_trace"])
    it_ms = 1e3 * c["loop_s"] / n_it
    busy = dict(busy_ms=busy_ms, iteration_ms=it_ms, share=busy_ms / it_ms)
    log(f"[24] fit_saem, {EST_POP} subjects, {EST_SAEM_KW} (5 MH steps): "
        f"{c['s']:.2f} s on the card, its iteration loop {it_ms:.2f} ms per iteration; one "
        f"iteration's card "
        f"busy {busy_ms:.2f} ms ({100 * busy['share']:.1f}% of the loop's ms per iteration); "
        f"MH decisions flipped against the CPU: {flips} of {c['accepted'].size}"
        + (f" (first at iteration {first})" if flips else "")
        + f"; ll trace (first 20) {errs['saem trace']:.2e}, estimates "
        f"{max(errs['saem ' + k] for k in ('theta', 'omega', 'sigma')):.2e} against the CPU")
    t_all = t_card + t_cpu
    log(f"[24] phase 24: {t_all:.1f} s ({t_card:.1f} s of timed card work alone, then "
        f"{t_cpu:.1f} s of CPU references in {len(EST_PARTS)} processes of 2 threads beside "
        f"the card's MAP fits" + (", a window shared with phase 25's" if shared else "")
        + ": " + ", ".join(f"{k} {v:.1f} s" for k, v in worker_s.items())
        + "; these CPU seconds are not a comparison with the card's)")
    record = dict(ll_ms=ll_ms, errs=errs, saem_flips=flips, saem_busy=busy,
                  seconds={k: v["s"] for k, v in card_fits.items() if "s" in v},
                  workers_s=worker_s, card_s=t_card, cpu_s=t_cpu, phase_s=t_all, card=card)
    log("[24] estimation: " + json.dumps(record, default=float))
    return record


# ---------------------------------------------------------------------------
# phase 25: the replicate layer; phase 26: NCA's device batch
# ---------------------------------------------------------------------------

# the replicate layer on phase 24's population (EST_POP subjects, the JAX
# package's tests/test_laplace.py data) at the API's widths: 200 bootstrap
# and SSE replicates, 500 VPC and 1000 NPDE replicates, llp's default grid
# (n_grid 12 a side: 2 x 2 x 12 = 48 lanes); the refits cut from the API's 40
# L-BFGS steps (scm: 60) to DIAG_REFIT_ITERS (from the full fit's optimum
# the first bootstrap lanes' largest gradient entry falls from about 50 to
# 5e-2 in 10 steps and to 3e-6 in 16, chip_tools/refit_trace.py; a lane that
# has converged spends each later step in a line search at the objective's
# noise floor, up to 20 evaluations of every lane: at 16 steps the bootstrap
# took 33 s on the card), and the SSE and llp fits
# warm-started at the bootstrap's full fit (its estimates as theta0 and
# omega0, its fitted residual model), for the script's time limit
# the device of phases 25 and 26
CARD = "cuda"
# not cut for phase 28: the refits at 5 steps with llp's grid at 6 points a
# side left llp's held lanes unconverged, card and CPU parting by 2.1e-8 (>
# 1e-8); the bootstrap at 100 replicates took as long as at 200 (host-paced)
DIAG_N_BOOT = 200
DIAG_N_SIM = 100
DIAG_VPC_REP = 500
DIAG_NPDE_REP = 1000
DIAG_REFIT_ITERS = 10
DIAG_LANES = 8            # the lanes held alone on the card and on the CPU
DIAG_SOLO_ITERS = 1       # the one-lane-at-a-time refits (B = 1), for the s a step
# llp's lanes held against the CPU: the two farthest from the optimum on each
# side of each parameter (its lanes run parameter by parameter, low side then
# high, n_grid = 12 points a side, nearest first); they converge within the
# refit's steps, where the nearest reach the noise floor by step 8 and then
# search 18-19 evaluations a step, a cost the CPU reference would repeat
DIAG_LLP_HELD = [b * 12 + r for b in range(4) for r in (10, 11)]
# the stepwise search on the JAX package's tests/test_scm.py population
DIAG_SCM_POP = 20
DIAG_SCM_CANDIDATES = [(0, "wt", "power", 70.0), (0, "junk", "power", 1.0)]
# its fits cut to DIAG_SCM_MAX_ITERS outer iterations (fit_laplace's 100) and
# its candidate screens to DIAG_SCM_REFIT_ITERS L-BFGS steps (scm's 60): its
# CPU reference is a whole search, host-paced, the longest of phase 25's (at 2
# and 4 the search added no effect)
DIAG_SCM_MAX_ITERS = 3
DIAG_SCM_REFIT_ITERS = 3
DIAG_TOL = dict(lanes=1e-10, cpu=1e-8, sims=1e-10, diag=1e-9, scm=1e-6)


def diag_scm_population(pt, n: int = DIAG_SCM_POP, seed: int = 11, beta_true: float = 0.9):
    """``tests/test_scm.py::_population`` rebuilt from numpy in its draw
    order: ke with a strong weight power effect, a pure-noise covariate
    ``junk``, 100 at 0 and five observations with 6% proportional noise."""
    rng = np.random.default_rng(seed)
    subjects = []
    for i in range(n):
        wt = float(rng.uniform(45.0, 110.0))
        junk = float(rng.uniform(0.5, 2.0))
        ke = 0.25 * np.exp(beta_true * np.log(wt / 70.0) + 0.10 * rng.standard_normal())
        v = 10.0 * np.exp(0.15 * rng.standard_normal())
        b = (pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
             .covariate("wt", 0.0, wt).covariate("junk", 0.0, junk))
        for t in (0.5, 2.0, 6.0, 12.0, 24.0):
            c = 100.0 * np.exp(-ke * t) / v
            b = b.observation(float(t), float(c * (1 + 0.06 * rng.standard_normal())), 0)
        subjects.append(b.build())
    return pt.Data(subjects)


def diag_scm_rems(pt):
    return pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.06))


def diag_warm(full) -> tuple:
    """The warm start of the SSE and llp fits: the bootstrap's full fit's
    estimates, omegas and fitted residual models."""
    return list(full.theta), dict(omega0=np.asarray(full.omega)), full.residual_models


def diag_card_calls(pt) -> dict:
    """Phase 25's timed calls on the card, each with its seconds."""
    from pharmsol_tpu_torch.optimize import (bootstrap_laplace, llp, npde, scm, sse_laplace,
                                             vpc)

    closed, _, rems = est_models(pt)
    pop = est_laplace_population(pt, EST_POP)
    out, s = {}, {}
    t0 = time.perf_counter()
    bi = {}
    boot = bootstrap_laplace(closed, pop, rems, list(EST_THETA0), n_boot=DIAG_N_BOOT,
                             refit_iters=DIAG_REFIT_ITERS, device=CARD, _introspect=bi)
    s["bootstrap_laplace"] = time.perf_counter() - t0
    full = boot.full
    theta0, kw, fitted = diag_warm(full)
    t0 = time.perf_counter()
    si = {}
    # the SSE's and llp's full fits without their standard errors: neither
    # reads them (llp takes its own Hessian)
    sse = sse_laplace(closed, pop, fitted, theta0, n_sim=DIAG_N_SIM,
                      refit_iters=DIAG_REFIT_ITERS, device=CARD, _introspect=si,
                      compute_se=False, **kw)
    s["sse_laplace"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v = vpc(closed, pop, fitted, full, n_rep=DIAG_VPC_REP, device=CARD)
    s["vpc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = npde(closed, pop, fitted, full, n_rep=DIAG_NPDE_REP, device=CARD)
    s["npde"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    li = {}
    prof = llp(closed, pop, fitted, theta0, refit_iters=DIAG_REFIT_ITERS, device=CARD,
               _introspect=li, compute_se=False, **kw)
    s["llp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = scm(closed, diag_scm_population(pt), diag_scm_rems(pt), [0.3, 9.0],
              DIAG_SCM_CANDIDATES, refit_iters=DIAG_SCM_REFIT_ITERS, compute_se=False,
              max_iters=DIAG_SCM_MAX_ITERS, device=CARD)
    s["scm"] = time.perf_counter() - t0
    out.update(seconds=s, boot=boot, boot_intro=bi, sse=sse, sse_intro=si, vpc=v, npde=d,
               llp=prof, llp_intro=li, scm=res, full=full)
    return out


def diag_lanes(intro, key: str, lanes, z0, device, iters: int = None):
    """``lanes`` of a replicate program's refit, alone: bootstrap (the weights
    ``lanes``), SSE (the simulated observations) or llp (masks and pins),
    from the warm start ``z0``."""
    from pharmsol_tpu_torch.optimize.bootstrap import _vectorized_refits

    iters = DIAG_REFIT_ITERS if iters is None else iters
    f64 = dict(dtype=torch.float64, device=device)
    z0 = torch.as_tensor(np.asarray(z0), **f64)
    vg = intro["lanes_value_and_grad"]
    if key == "boot":
        return _vectorized_refits(intro["neg_laplace_w_lanes"], z0,
                                  torch.as_tensor(lanes, **f64), iters, vg)
    if key == "sse":
        ones = torch.ones((len(lanes), int(intro["layout"]["n_sub"])), **f64)
        return _vectorized_refits(lambda z, y: intro["neg_laplace_wy_lanes"](z, ones, y), z0,
                                  torch.as_tensor(lanes, **f64), iters, vg)
    M, V = (torch.as_tensor(a, **f64) for a in lanes)
    ones = torch.ones((M.shape[0], int(intro["layout"]["n_sub"])), **f64)

    def obj(z, mv):
        return intro["neg_laplace_w_lanes"](torch.where(mv[0] > 0, mv[1][:, None], z), ones)

    return _vectorized_refits(obj, z0, (M, V), iters, vg)


def diag_intro(pt, device, rems, **kw) -> dict:
    """The Laplace objective's pieces over phase 24's population on
    ``device`` (no fit)."""
    closed, _, _ = est_models(pt)
    intro = {}
    pt.optimize.fit_laplace(closed, est_laplace_population(pt, EST_POP), rems,
                            list(EST_THETA0), _introspect=intro, _build_only=True,
                            device=device, **kw)
    return intro


def diag_worker(part: str, payload: dict) -> tuple:
    """One of phase 25's CPU reference processes, float64 on the CPU: the
    first ``DIAG_LANES`` lanes of a refit program from the card's warm start
    (``boot``, ``sse``, ``llp``), the simulations of the VPC, NPDE and SSE
    (``sims``), or the stepwise search (``scm``); and its seconds."""
    import pharmsol_tpu_torch as pt

    # one thread each: an evaluation is host-paced, and the five workers
    # beside the card's process fill the host's eight cores
    torch.set_num_threads(1)
    pt.set_float_dtype(torch.float64)
    pt.set_device("cpu")
    t0 = time.perf_counter()
    if part in ("boot", "sse", "llp"):
        intro = diag_intro(pt, "cpu", payload["rems"])
        out = diag_lanes(intro, part, payload["lanes"], payload["z0"], "cpu")
    elif part == "sims":
        from pharmsol_tpu_torch.optimize import npde, vpc
        from pharmsol_tpu_torch.optimize.diagnostics import _simulate

        closed, _, _ = est_models(pt)
        pop = est_laplace_population(pt, EST_POP)
        full, rems = payload["full"], payload["rems"]
        out = dict(sse=_simulate(closed, pop, rems, payload["sse_full"], DIAG_N_SIM, 0, True,
                                 32)[1],
                   vpc=vpc(closed, pop, rems, full, n_rep=DIAG_VPC_REP),
                   npde=npde(closed, pop, rems, full, n_rep=DIAG_NPDE_REP))
    else:
        from pharmsol_tpu_torch.optimize import scm

        closed, _, _ = est_models(pt)
        res = scm(closed, diag_scm_population(pt), diag_scm_rems(pt), [0.3, 9.0],
                  DIAG_SCM_CANDIDATES, refit_iters=DIAG_SCM_REFIT_ITERS, compute_se=False,
                  max_iters=DIAG_SCM_MAX_ITERS)
        out = dict(effects=res.effects, ll=res.final.log_likelihood,
                   steps=[(s.action, s.effect, s.lrt) for s in res.steps])
    return out, time.perf_counter() - t0


class _Fit:
    """A diagonal-omega fit's population surface (estimates, omegas,
    transform), picklable for the workers."""

    def __init__(self, theta, omega, transform):
        self.theta = np.asarray(theta)
        self.omega = np.asarray(omega)
        self.omega_cov = None
        self.transform = transform
        self.beta = None


def diag_close(label: str, got, want, tol: float) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"[25] {label}: shape {got.shape} against {want.shape}")
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)):
        raise AssertionError(f"[25] {label}: finite where the reference is not, or not where "
                             f"it is")
    err = float(np.max(np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1e-300),
                       initial=0.0))
    if err > tol:
        raise AssertionError(f"[25] {label}: {err:.2e} > {tol:.0e}")
    return err


def diag_objective_ms(intro, W) -> dict:
    """One batched objective + gradient evaluation at B = len(W) lanes,
    eager and replayed from its CUDA graph (as the refits run it): ms by the
    host clock and by CUDA events. The card's busy time in an evaluation is
    the replay's CUDA-event time (the graph runs the eager evaluation's
    kernels back to back); its share of each wall time is printed."""
    from pharmsol_tpu_torch.optimize._lbfgs import batch_value_and_grad_fn

    f64 = dict(dtype=torch.float64, device=CARD)
    w = torch.as_tensor(W, **f64)
    z = torch.as_tensor(intro["z_opt"], **f64).expand(w.shape[0], -1).clone()
    out = dict(lanes=int(w.shape[0]))
    for tag, graph in (("eager", False), ("graph", True)):
        vg = batch_value_and_grad_fn(lambda Z: intro["neg_laplace_w_lanes"](Z, w), graph=graph)
        # eager (warm from the refits): one host-clock run, one CUDA-event
        # run (about a second each); the graph: its warm-up and capture, then
        # replays
        host = wall_ms(lambda: vg(z), 1 if not graph else 3, warmup=0 if not graph else 2)
        events = cuda_ms(lambda: vg(z), 1 if not graph else 5, warmup=0)
        out[tag] = dict(host_ms=host, events_ms=events)
    busy = out["graph"]["events_ms"]
    for tag in ("eager", "graph"):
        out[tag].update(busy_ms=busy, busy_share=busy / out[tag]["host_ms"])
    return out


def diag_refit_s(intro, W, one_at_a_time: bool) -> float:
    """Seconds of ``DIAG_SOLO_ITERS`` bootstrap L-BFGS steps from the full
    fit's optimum for the lanes of ``W``: one lane at a time (B = 1, one CUDA
    graph whose weight buffer takes each lane's weights in turn) or all at
    once (B = len(W)); each graph captured before the clock starts."""
    from pharmsol_tpu_torch.optimize._lbfgs import BatchLbfgs

    f64 = dict(dtype=torch.float64, device=CARD)
    W = torch.as_tensor(W, **f64)
    lanes = [W[j:j + 1] for j in range(W.shape[0])] if one_at_a_time else [W]
    buf = lanes[0].clone()
    vg = intro["lanes_value_and_grad"](lambda Z: intro["neg_laplace_w_lanes"](Z, buf))
    z0 = torch.as_tensor(intro["z_opt"], **f64).expand(buf.shape[0], -1).clone()
    vg(z0)
    vg(z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in lanes:
        buf.copy_(w)
        opt = BatchLbfgs()
        z, state = z0.clone(), opt.init(z0)
        for _ in range(DIAG_SOLO_ITERS):
            value, grad = opt.value_and_grad_from_state(vg, z, state)
            z, state = opt.step(vg, z, state, value, grad)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_diagnostics(pt, card: str, window: RefWindow = None):
    """Phase 25: the replicate layer on the card in float64. The timed work
    first with no other process of the script running (the calls, one
    batched objective evaluation at B = DIAG_N_BOOT, lanes refitted one at a
    time against all at once); then the CPU references in worker processes
    (the held lanes of each refit program, the simulations, the stepwise
    search) while the card refits the bootstrap's first lanes alone (lane
    independence). No kernel of the table runs here. Given a shared
    ``window`` (a whole run), its references join it and this returns the
    phase's checks, ``finish(done, window_s)``."""
    t_phase = time.perf_counter()
    pt.set_float_dtype(torch.float64)
    reset_kernel_launches()
    card_out = diag_card_calls(pt)
    secs = card_out["seconds"]
    bi, si, li = card_out["boot_intro"], card_out["sse_intro"], card_out["llp_intro"]
    full = card_out["full"]
    k = DIAG_LANES
    # the timings, still with no other process of the script running: one
    # batched evaluation, and lanes refitted one at a time against all at once
    objective = diag_objective_ms(bi, bi["refits"]["W"])
    solo_s = diag_refit_s(bi, bi["refits"]["W"][:k], one_at_a_time=True)
    batched_s = diag_refit_s(bi, bi["refits"]["W"], one_at_a_time=False)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t_phase
    jobs_in = {
        "boot": dict(rems=est_models(pt)[2], lanes=bi["refits"]["W"][:k], z0=bi["z_opt"]),
        "sse": dict(rems=full.residual_models, lanes=si["refits"]["Y"][:k], z0=si["z_opt"]),
        "llp": dict(rems=full.residual_models, z0=li["z_opt"],
                    lanes=(li["refits"]["M"][DIAG_LLP_HELD], li["refits"]["V"][DIAG_LLP_HELD])),
        # the SSE simulates from its own full fit (warm-started at the
        # bootstrap's), whose estimates are its generating values
        "sims": dict(full=_Fit(full.theta, full.omega, full.transform),
                     sse_full=_Fit(card_out["sse"].generating["theta"],
                                   card_out["sse"].generating["omega"], full.transform),
                     rems=full.residual_models),
        "scm": {}}
    shared = window is not None
    window = window if shared else RefWindow()
    for part, payload in jobs_in.items():
        window.add(("25", part), diag_worker, (part, payload))
    # meanwhile, on the card: the bootstrap's first lanes alone
    held_alone = {}
    window.beside(lambda: held_alone.update(z=diag_lanes(
        bi, "boot", jobs_in["boot"]["lanes"], bi["z_opt"], CARD)))

    def finish(done, t_cpu):
        done = {part: done[("25", part)] for part in jobs_in}
        alone = held_alone["z"]
        launched = {n: v for n, v in kernel_launches().items() if v}
        if launched:
            raise AssertionError(f"[25] a kernel of the table launched on this path: {launched}")

        errs = {}
        held = {"boot": list(range(k)), "sse": list(range(k)), "llp": DIAG_LLP_HELD}
        for key, intro in {"boot": bi, "sse": si, "llp": li}.items():
            Z = intro["refits"]["Z"]
            if not np.all(np.isfinite(Z)):
                raise AssertionError(f"[25] {key}: a non-finite refit")
            if key == "boot":
                errs["boot lanes alone"] = diag_close(
                    f"bootstrap: the first {k} of {DIAG_N_BOOT} lanes against them alone",
                    Z[:k], alone[0], DIAG_TOL["lanes"])
            errs[key + " cpu"] = diag_close(f"{key}: lanes {held[key]} against the CPU",
                                            Z[held[key]], done[key][0][0], DIAG_TOL["cpu"])
        cpu_sims = done["sims"][0]
        errs["sse sims"] = diag_close("SSE simulations against the CPU", si["refits"]["Y"],
                                      cpu_sims["sse"], DIAG_TOL["sims"])
        v, d = card_out["vpc"], card_out["npde"]
        errs["vpc"] = max(diag_close("vpc " + f, getattr(v, f), getattr(cpu_sims["vpc"], f),
                                     DIAG_TOL["diag"])
                          for f in ("observed", "predicted", "pi_low", "pi_high"))
        errs["npde"] = diag_close("npde", d.npde, cpu_sims["npde"].npde, DIAG_TOL["diag"])
        res, cpu_scm = card_out["scm"], done["scm"][0]
        if res.effects != cpu_scm["effects"]:
            raise AssertionError(f"[25] scm: {res.effects} on the card, {cpu_scm['effects']} on "
                                 f"the CPU")
        errs["scm"] = diag_close("scm final log-likelihood", res.final.log_likelihood,
                                 cpu_scm["ll"], DIAG_TOL["scm"])
        boot, sse, prof = card_out["boot"], card_out["sse"], card_out["llp"]
        if boot.n_failed or sse.n_failed:
            raise AssertionError(f"[25] failed refits: bootstrap {boot.n_failed}, "
                                 f"SSE {sse.n_failed}")
        pp = prof.parameters
        if not all(np.isfinite(p.estimate) and p.deviance[len(p.deviance) // 2] == 0.0
                   for p in pp.values()):
            raise AssertionError(f"[25] llp: {prof.summary()}")
        if not (np.isfinite(d.mean) and np.isfinite(v.coverage())):
            raise AssertionError(f"[25] vpc / npde: {v.coverage()} {d.summary()}")
        log(f"[25] bootstrap_laplace, {EST_POP} subjects, n_boot {DIAG_N_BOOT}, refit_iters "
            f"{DIAG_REFIT_ITERS}: {secs['bootstrap_laplace']:.2f} s on {card} (its full fit "
            f"{full.iterations} iterations); SEs theta {boot.se()['theta'].tolist()}")
        log(f"[25] sse_laplace, n_sim {DIAG_N_SIM}: {secs['sse_laplace']:.2f} s; relative bias "
            f"theta {sse.relative_bias()['theta'].tolist()}")
        log(f"[25] vpc, n_rep {DIAG_VPC_REP}: {secs['vpc']:.2f} s, coverage {v.coverage():.3f}; "
            f"npde, n_rep {DIAG_NPDE_REP}: {secs['npde']:.2f} s, {d.summary()}")
        log(f"[25] llp, {sum(len(p.grid) - 1 for p in pp.values())} lanes: {secs['llp']:.2f} s; "
            + "; ".join(f"{n} [{p.lower:.4g}, {p.upper:.4g}]" for n, p in pp.items()))
        log(f"[25] scm, {DIAG_SCM_POP} subjects, {len(DIAG_SCM_CANDIDATES)} candidates: "
            f"{secs['scm']:.2f} s, {res.n_fits} fits, effects {list(res.effects)}")
        for tag, o in ((t, objective[t]) for t in ("eager", "graph")):
            log(f"[25] one batched objective + gradient ({tag}), B = {objective['lanes']} x "
                f"{EST_POP} subjects: {o['host_ms']:.1f} ms (host clock), {o['events_ms']:.1f} "
                f"ms (CUDA events), card busy {o['busy_ms']:.2f} ms (the replay's events), "
                f"{100 * o['busy_share']:.1f}% of the host clock")
        log(f"[25] {k} bootstrap lanes refitted one at a time (B = 1), {DIAG_SOLO_ITERS} steps "
            f"each: {solo_s:.2f} s; all {DIAG_N_BOOT} lanes at once, the same steps: "
            f"{batched_s:.2f} s (replayed from CUDA graphs, their capture not timed)")
        log("[25] the bootstrap's first lanes against them alone (1e-10); each program's "
            "against the CPU (1e-8), the simulations (1e-10), vpc and npde (1e-9), scm (1e-6): "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
        t_all = t_card + t_cpu
        worker_s = {part: s for part, (_, s) in done.items()}
        log(f"[25] phase 25: {t_all:.1f} s ({t_card:.1f} s of timed card work alone, then "
            f"{t_cpu:.1f} s of CPU references in {len(jobs_in)} processes of 1 thread beside "
            f"the untimed card checks" + (", a window shared with phase 24's" if shared else "")
            + ": " + ", ".join(f"{n} {s:.1f} s" for n, s in worker_s.items()) + ")")
        record = dict(seconds=secs, objective=objective, solo_s=solo_s, batched_s=batched_s,
                      errs=errs, workers_s=worker_s, card_s=t_card, cpu_s=t_cpu, phase_s=t_all,
                      launches=kernel_launches(), card=card)
        log("[25] diagnostics: " + json.dumps(record, default=float))
        return record

    if shared:
        return finish
    done, t_cpu = window.run()
    return finish(done, t_cpu)


# phase 26: the device NCA batch at the JAX test's 5000 x 32 profiles and at
# a trial-sized population, against the host batch
NCA_SIZES = ((5000, 32), (100000, 32))
NCA_TOL = 1e-9


def nca_profiles(n: int, T: int, seed: int):
    """``tests/test_nca_batch.py::make_profiles`` from numpy: 1-cmt oral
    profiles with log-normal ka, ke and V on a shared grid to 24 h."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.25, 24.0, T)
    ka = 1.2 * np.exp(0.2 * rng.randn(n))
    ke = 0.2 * np.exp(0.3 * rng.randn(n))
    v = 30.0 * np.exp(0.2 * rng.randn(n))
    c = 100.0 * ka[:, None] / (ka - ke)[:, None] * (
        np.exp(-ke[:, None] * t[None, :]) - np.exp(-ka[:, None] * t[None, :])) / v[:, None]
    return t, np.abs(c) + 1e-9


def nca_host(n: int, T: int) -> tuple:
    """The host batch of phase 26's profiles and its s."""
    from pharmsol_tpu_torch.nca.batch import batch_nca

    t, c = nca_profiles(n, T, 1)
    t0 = time.perf_counter()
    out = batch_nca(t, c, dose=100.0)
    return out, time.perf_counter() - t0


def run_nca(pt, card: str) -> dict:
    """Phase 26: ``batch_nca_device`` on the card in float64 at each size of
    ``NCA_SIZES``, its ms by CUDA events; then every key against the host
    ``batch_nca`` (in this process, after the card's timings) within
    ``NCA_TOL`` relative, NaN where the host has NaN. No kernel of the
    table."""
    from pharmsol_tpu_torch.nca.batch_device import batch_nca_device

    t_phase = time.perf_counter()
    pt.set_float_dtype(torch.float64)
    reset_kernel_launches()
    card_out, ms = {}, {}
    for n, T in NCA_SIZES:
        t, c = nca_profiles(n, T, 1)
        tt = torch.as_tensor(t, device=CARD)
        cc = torch.as_tensor(c, device=CARD)
        card_out[(n, T)] = batch_nca_device(tt, cc, dose=100.0, device=CARD)
        ms[f"{n}x{T}"] = cuda_ms(lambda: batch_nca_device(tt, cc, dose=100.0, as_numpy=False,
                                                          device=CARD), 10)
    host = {size: nca_host(*size) for size in NCA_SIZES}
    launched = {k: v for k, v in kernel_launches().items() if v}
    if launched:
        raise AssertionError(f"[26] a kernel of the table launched on this path: {launched}")
    errs, host_s = {}, {}
    for size in NCA_SIZES:
        want, s = host[size]
        got = card_out[size]
        host_s[f"{size[0]}x{size[1]}"] = s
        if set(got) != set(want):
            raise AssertionError(f"[26] keys {sorted(set(got) ^ set(want))}")
        worst = 0.0
        for key, w in want.items():
            g = np.asarray(got[key], dtype=np.float64)
            w = np.asarray(w, dtype=np.float64)
            nan = np.isnan(w)
            if not np.array_equal(nan, np.isnan(g)):
                raise AssertionError(f"[26] {size} {key}: NaN where the host has none, or not")
            e = float(np.max(np.abs(g[~nan] - w[~nan]) / np.maximum(np.abs(w[~nan]), 1e-300),
                             initial=0.0))
            if e > NCA_TOL:
                raise AssertionError(f"[26] {size} {key}: {e:.2e} > {NCA_TOL:.0e}")
            worst = max(worst, e)
        errs[f"{size[0]}x{size[1]}"] = worst
        n_lz = int(np.sum(np.isfinite(np.asarray(got["lambda_z"]))))
        log(f"[26] batch_nca_device {size[0]} x {size[1]} on {card}: "
            f"{ms[f'{size[0]}x{size[1]}']:.3f} ms (CUDA events), lambda_z found for {n_lz}; "
            f"against the host batch ({s:.2f} s on the host): {worst:.2e}")
    t_all = time.perf_counter() - t_phase
    record = dict(ms=ms, errs=errs, host_s=host_s, phase_s=t_all, card=card)
    log(f"[26] phase 26: {t_all:.1f} s; nca: " + json.dumps(record, default=float))
    return record



# phase 27: the device split, the psi export and the native host library
MESH_SHAPES = ((8, 1), (4, 2), (1, 1))
MESH_SUBJECTS = 4096           # the closed-form and ODE cells, x 512 supports
MESH_SDE = (64, 64)            # the README SDE at zero diffusion, x 1000 particles
MESH_F32 = 1e-5                # float32 split against whole, tighter than every row
MESH_REPS = 5                  # timed calls (median) after one warm-up
MESH_FIT_CYCLES = 4            # phase 10's fit runs 8
MESH_EXPORT_SUBJECTS = 1024    # traced in a worker process beside the build
MESH_CSV_SUBJECTS = 10000      # x 10 rows: a 100 000-row CSV
# the kernel function each trace event of a cell's kernel names
MESH_TRACE_NAMES = {"K1a": "fused_psi_feature_kernel", "K1b": "fused_psi_feature_kernel",
                    "K1c": "fused_psi_feature_kernel", "K2a": "fused_ode_explicit_kernel",
                    "K2d": "fused_ode_kernel", "K3a": "fused_sde_kernel"}


def mesh_counters() -> dict:
    """Each phase-27 kernel's launch counter, read now."""
    from pharmsol_tpu_torch.ops import fused_ode, fused_psi, fused_sde

    return {"K1a": fused_psi.LAUNCHES, "K1b": fused_psi.FEATURE_LAUNCHES,
            "K1c": fused_psi.K1C_LAUNCHES, "K2a": fused_ode.LAUNCHES,
            "K2d": fused_ode.EXPM_LAUNCHES, "K3a": fused_sde.LAUNCHES}


def mesh_cells(pt, rng) -> list:
    """Phase 27's cells, (kernel, label, model, data, support, ems): the
    widths of phases 3-21 at ``MESH_SUBJECTS`` subjects (the SDE at
    ``MESH_SDE``, zero diffusion)."""
    from pharmsol_tpu_torch.utils.f32_budget import TRANSIT_CENTRE, expm_case

    n, S = MESH_SUBJECTS, 512
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    short = short_subjects(pt, n, rng)
    cells = [("K1a", f"Short {n}x{S}", short_model(pt), short,
              jittered_support([0.15, 1.2, 0.3, 0.2, 10.0], S, rng), ems)]
    wt = rng.uniform(40.0, 120.0, n)
    cov = short_subjects(pt, n, rng, covariates=lambda i, b: b.covariate("wt", 0.0, wt[i]))
    cells.append(("K1b", f"Covariate Short {n}x{S}", covariate_short_model(pt), cov,
                  jittered_support([0.15, 3.0, 0.3, 0.2, 10.0, 0.5, 0.8], S, rng), ems))
    model, data = lag_depth_cell(pt, rng, n)
    cells.append(("K1c", f"lag-depth Short {n}x{S}", model, data,
                  jittered_support(LAG_DEPTH_CENTRE, S, rng), ems))
    cells.append(("K2a", f"ODE Short {n}x{S}", ode_model(pt, "short"), short,
                  ODE_MODELS["short"][5](rng, S), ems))
    model, data, _, expm_ems = expm_case("transit", n, 1, seed=SEED)
    cells.append(("K2d", f"ODE expm transit {n}x{S}", model, data,
                  jittered_support(TRANSIT_CENTRE, S, rng, 0.2), expm_ems))
    n_sde, s_sde = MESH_SDE
    cells.append(("K3a", f"SDE README {n_sde}x{s_sde}x{SDE_PARTICLES} zero diffusion",
                  readme_sde(pt), readme_data(pt, n_sde, rng),
                  readme_support(s_sde, rng, sigma=0.0), readme_ems(pt)))
    return cells


def cuda_meshes(pt) -> dict:
    """Phase 27's meshes: (8, 1) and (4, 2) over eight times ``cuda:0``,
    (1, 1) over ``cuda:0``."""
    from pharmsol_tpu_torch.parallel import population_mesh

    return {shape: population_mesh(shape=shape, devices=["cuda:0"] * (shape[0] * shape[1]))
            for shape in MESH_SHAPES}


def traced_launches(pt, fn) -> tuple:
    """Run ``fn`` inside ``profile_trace``: (result, the trace file's kernel
    events, its launch calls: the host events whose name holds
    ``LaunchKernel``). The capture first runs one small operation on the
    card and waits for it, so that ``fn``'s first launches fall inside a
    running trace."""
    import tempfile

    from pharmsol_tpu_torch.utils.profiling import profile_trace

    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d) as capture:
            torch.ones(1, device="cuda").add_(1.0)
            torch.cuda.synchronize()
            out = fn()
        with open(capture.path) as f:
            events = json.load(f)["traceEvents"]
    return (out, [e for e in events if e.get("cat") == "kernel"],
            [e for e in events if "LaunchKernel" in str(e.get("name", ""))])


def kernel_events(events: list, function: str) -> list:
    """The trace's events of the kernel function ``function`` (its name
    before the template arguments or the parameter list)."""
    pattern = re.compile(rf"(?<!\w){function}\s*[<(]")
    return [e for e in events if pattern.search(e["name"])]


def mesh_trace_check(pt, label: str, kernel: str, run, whole: torch.Tensor) -> dict:
    """The (8, 1) split call ``run`` inside ``traced_launches``: its launch
    counter at 8, its psi within 1e-12 of ``whole``, and 8 events of the
    cell's kernel in the trace. Up to three captures; each capture that
    holds fewer events is printed (its kernel events' and launch calls'
    times, microseconds after the first launch call) before the next."""
    function = MESH_TRACE_NAMES[kernel]
    failed = []
    for attempt in range(1, 4):
        reset_kernel_launches()
        psi, kernels, launches = traced_launches(pt, run)
        if mesh_counters()[kernel] != 8:
            raise AssertionError(f"[27] {label}: {mesh_counters()[kernel]} launches in the "
                                 f"traced (8, 1) call")
        err = split_err(f"[27] {label}, traced (8, 1)", psi, whole)
        if not err <= 1e-12:
            raise AssertionError(f"[27] {label}: the traced (8, 1) call {err:.3e} > 1e-12")
        mine = kernel_events(kernels, function)
        if len(mine) == 8:
            return dict(traced=8, captures=attempt, traced_err=err, failed_captures=failed)
        t0 = min((e["ts"] for e in launches), default=0.0)
        detail = (f"capture {attempt}: {len(mine)} {function} events at "
                  f"{[round(e['ts'] - t0, 1) for e in mine]} (dur "
                  f"{[round(e.get('dur', 0.0), 1) for e in mine]}), {len(kernels)} kernel "
                  f"events in all, {len(launches)} launch calls at "
                  f"{[round(e['ts'] - t0, 1) for e in launches]}")
        log(f"[27] {label}: the (8, 1) trace lost events; {detail}")
        failed.append(detail)
    raise AssertionError(f"[27] {label}: the (8, 1) trace holds fewer than 8 {function} "
                         f"events in each of 3 captures: {failed}")


def split_err(what: str, got: torch.Tensor, whole: torch.Tensor) -> float:
    """The split psi's largest relative difference from the whole call's
    over the finite cells, which must be the same cells."""
    fin = torch.isfinite(whole)
    if (got.shape != whole.shape or not torch.equal(fin, torch.isfinite(got))
            or not bool(fin.any())):
        raise AssertionError(f"{what}: the split psi's shape or finite cells differ")
    return rel_err(got[fin], whole[fin], 1.0)


def mesh_cell(pt, cell, meshes, card: str) -> dict:
    """One phase-27 cell: the unsharded fused call against the split call
    on each mesh, float64 every cell within 1e-12 relative and float32 on
    (8, 1) within ``MESH_F32``; the launch counters set to 0 just before each
    split call and read just after (one launch per subjects shard), and the
    (8, 1) call traced: one kernel event per shard."""
    from pharmsol_tpu_torch.parallel import log_likelihood_matrix_sharded

    kernel, label, model, data, sp, ems = cell
    out = {"label": label, "ms": {}, "errs": {}, "launches": {}}
    for dtype in (torch.float64, torch.float32):
        pt.set_float_dtype(dtype)
        whole = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused", device="cuda")
        torch.cuda.synchronize()
        tag = "f64" if dtype == torch.float64 else "f32"
        out["ms"][f"whole {tag}"] = wall_ms(lambda: pt.log_likelihood_matrix(
            model, data, sp, ems, engine="fused", device="cuda"), MESH_REPS)
        shapes = MESH_SHAPES if dtype == torch.float64 else MESH_SHAPES[:1]
        for shape in shapes:
            mesh = meshes[shape]
            reset_kernel_launches()
            got = log_likelihood_matrix_sharded(model, data, sp, ems, mesh=mesh, engine="fused")
            torch.cuda.synchronize()
            counts = {k: v for k, v in mesh_counters().items() if v}
            if counts != {kernel: shape[0]}:
                raise AssertionError(f"[27] {label} {shape}: launches {counts}, expected "
                                     f"{shape[0]} of {kernel}")
            if got.shape != whole.shape or got.device != whole.device:
                raise AssertionError(f"[27] {label} {shape}: psi {tuple(got.shape)} on "
                                     f"{got.device}")
            err = split_err(f"[27] {label} {shape}", got, whole)
            tol = 1e-12 if dtype == torch.float64 else MESH_F32
            if not err <= tol:
                raise AssertionError(f"[27] {label} {shape} {tag}: {err:.3e} > {tol:.0e}")
            key = f"{shape[0]}x{shape[1]} {tag}"
            out["errs"][key] = err
            out["launches"][key] = counts[kernel]
            out["ms"][key] = wall_ms(lambda: log_likelihood_matrix_sharded(
                model, data, sp, ems, mesh=mesh, engine="fused"), MESH_REPS)
        if dtype == torch.float64:
            def split_8x1(mesh=meshes[(8, 1)]):
                return log_likelihood_matrix_sharded(model, data, sp, ems, mesh=mesh,
                                                     engine="fused")

            trace = mesh_trace_check(pt, label, kernel, split_8x1, whole)
            out["traced"], out["trace_captures"] = trace["traced"], trace["captures"]
            out["errs"]["traced 8x1 f64"] = trace["traced_err"]
            out["failed_captures"] = trace["failed_captures"]
            if kernel == "K1a":
                out["recheck"] = (label, kernel, split_8x1, whole)
            # shards of fewer rows than one wave, and shards of padding alone
            # (3 occasion rows over 8 shards: the last row repeated)
            few = pt.Data(data.subjects()[:3])
            want = pt.log_likelihood_matrix(model, few, sp, ems, engine="fused", device="cuda")
            reset_kernel_launches()
            got = log_likelihood_matrix_sharded(model, few, sp, ems, mesh=meshes[(8, 1)],
                                                engine="fused")
            torch.cuda.synchronize()
            err = split_err(f"[27] {label}, 3 subjects", got, want)
            if not (err <= 1e-12 and mesh_counters()[kernel] == 8):
                raise AssertionError(f"[27] {label}, 3 subjects on (8, 1): {err:.3e}, "
                                     f"{mesh_counters()[kernel]} launches")
            out["errs"]["3 subjects 8x1 f64"] = err
    log(f"[27] {label} ({kernel}): split against whole "
        + ", ".join(f"{k} {v:.2e}" for k, v in out["errs"].items())
        + f"; launches {out['launches']}, (8, 1) trace {out['traced']} "
        f"{MESH_TRACE_NAMES[kernel]} events (capture {out['trace_captures']}); ms (median "
        f"of {MESH_REPS} after a warm-up, host work included) "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["ms"].items()) + f"  ({card})")
    return out


def mesh_batch_and_fit(pt, meshes, card: str) -> dict:
    """``log_likelihood_batch_sharded`` against ``log_likelihood_batch`` at
    10 000 subjects (float64, 1e-12), and ``fit_population`` on the (4, 2)
    mesh against the same fit without one on phase 10's closed-form
    population (``MESH_FIT_CYCLES`` cycles): supports 1e-10, weights 1e-8,
    every psi call four K1a launches."""
    from pharmsol_tpu_torch.parallel import log_likelihood_batch_sharded
    from pharmsol_tpu_torch.utils.f32_budget import POPULATION_RANGES
    from pharmsol_tpu_torch.utils.profiling import reset_stages, stage_counts

    pt.set_float_dtype(torch.float64)
    out = {}
    model, data, params, rems, ems = single_batch_case(pt)
    want = pt.log_likelihood_batch(model, data, params, rems, device="cuda")
    out["batch ms whole"] = wall_ms(lambda: pt.log_likelihood_batch(
        model, data, params, rems, device="cuda"), MESH_REPS)
    for shape in ((8, 1), (4, 2)):
        got = log_likelihood_batch_sharded(model, data, params, rems, mesh=meshes[shape])
        err = rel_err(got, want, 1.0)
        if not (got.shape == want.shape and err <= 1e-12):
            raise AssertionError(f"[27] batch {shape}: {err:.3e}")
        out[f"batch err {shape[0]}x{shape[1]}"] = err
        out[f"batch ms {shape[0]}x{shape[1]}"] = wall_ms(lambda: log_likelihood_batch_sharded(
            model, data, params, rems, mesh=meshes[shape]), MESH_REPS)
    closed = model
    kw = dict(ranges=POPULATION_RANGES, init_points=FIT_KW["init_points"],
              max_cycles=MESH_FIT_CYCLES)
    t0 = time.perf_counter()
    base = pt.optimize.fit_population(closed, data, ems, device="cuda", **kw)
    torch.cuda.synchronize()
    out["fit s whole"] = time.perf_counter() - t0
    reset_stages()
    reset_kernel_launches()
    t0 = time.perf_counter()
    split = pt.optimize.fit_population(closed, data, ems, mesh=meshes[(4, 2)], **kw)
    torch.cuda.synchronize()
    out["fit s 4x2"] = time.perf_counter() - t0
    psi_calls = stage_counts()["npag/psi_device"][0]
    counts = {k: v for k, v in mesh_counters().items() if v}
    if counts != {"K1a": 4 * psi_calls}:
        raise AssertionError(f"[27] fit on (4, 2): {psi_calls} psi calls, launches {counts}")
    if base.support.shape != split.support.shape:
        raise AssertionError(f"[27] fit: {split.support.shape} against {base.support.shape}")
    e_sup = float(np.max(np.abs(split.support - base.support) / np.abs(base.support)))
    e_w = float(np.max(np.abs(split.weights - base.weights)
                       / np.maximum(np.abs(base.weights), 1e-300)))
    if not (e_sup <= 1e-10 and e_w <= 1e-8):
        raise AssertionError(f"[27] fit: supports {e_sup:.3e}, weights {e_w:.3e}")
    out.update(fit_support_err=e_sup, fit_weight_err=e_w, fit_cycles=split.cycles,
               fit_psi_calls=psi_calls, fit_launches=counts["K1a"])
    log(f"[27] log_likelihood_batch_sharded at {len(params)} subjects against the whole batch: "
        f"{out['batch err 8x1']:.2e} (8, 1), {out['batch err 4x2']:.2e} (4, 2); ms (median "
        f"of {MESH_REPS} after a warm-up, host work included) whole "
        f"{out['batch ms whole']:.2f}, (8, 1) {out['batch ms 8x1']:.2f}, (4, 2) "
        f"{out['batch ms 4x2']:.2f}  ({card})")
    log(f"[27] fit_population on the (4, 2) mesh ({MESH_FIT_CYCLES} cycles; phase 10 runs "
        f"{FIT_KW['max_cycles']}): {split.cycles} cycles, {split.support.shape[0]} supports, "
        f"{psi_calls} psi calls = {counts['K1a']} K1a launches; supports {e_sup:.2e}, weights "
        f"{e_w:.2e} against the fit without a mesh; {out['fit s 4x2']:.3f} s against "
        f"{out['fit s whole']:.3f} s (one fit each)  ({card})")
    return out


def export_case(pt):
    """The export's population: the Short model and regimen at
    ``MESH_EXPORT_SUBJECTS`` subjects x 512 supports from its own seed, so
    that the export worker and this process build the same one: (model,
    data, support, ems)."""
    rng = np.random.RandomState(SEED + 270)
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    return (short_model(pt), short_subjects(pt, MESH_EXPORT_SUBJECTS, rng),
            jittered_support([0.15, 1.2, 0.3, 0.2, 10.0], 512, rng), ems)


def export_worker() -> tuple:
    """In a process of its own: the native library's and the ``.pkm`` host's
    g++ builds (into the checkout's ``_build/``, where phase 27 finds them),
    then ``export_psi`` of ``export_case`` traced on the card in float64;
    (the artifact's bytes, seconds to trace and save). Both are host work,
    so they run beside the build."""
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.native import native_available, pkm_host_available
    from pharmsol_tpu_torch.ops import export_psi

    native_available()
    pkm_host_available()
    pt.set_float_dtype(torch.float64)
    model, data, sp, ems = export_case(pt)
    grid = model.lower(data.subjects())
    low = ems.lower(model.resolve_output_label, model.nouteqs())
    t0 = time.perf_counter()
    blob = export_psi(model, grid, sp.shape, low, device="cuda")
    return blob, time.perf_counter() - t0


def mesh_export(pt, artifact, card: str) -> dict:
    """The export worker's artifact (``artifact``: its bytes, seconds to
    trace and save, seconds phase 27 waited for it) loaded and run on the
    card, against ``engine='general'`` within 1e-12."""
    from pharmsol_tpu_torch.ops import load_exported

    pt.set_float_dtype(torch.float64)
    blob, t_export, t_wait = artifact
    model, data, sp, ems = export_case(pt)
    grid = model.lower(data.subjects())
    low = ems.lower(model.resolve_output_label, model.nouteqs())
    fn = load_exported(blob)
    args = (grid.rows, grid.row_subject, sp, low.kind, low.factor, low.poly)
    psi = fn(*args)
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cuda")
    err = rel_err(psi, want, 1.0)
    if not (psi.device.type == "cuda" and psi.shape == want.shape and err <= 1e-12):
        raise AssertionError(f"[27] export: {tuple(psi.shape)} on {psi.device}, {err:.3e}")
    ms = wall_ms(lambda: fn(*args), 3)
    ms_general = wall_ms(lambda: pt.log_likelihood_matrix(model, data, sp, ems,
                                                          engine="general", device="cuda"), 3)
    log(f"[27] export_psi Short {len(data)}x{sp.shape[0]}: {len(blob)} bytes, traced and saved "
        f"in {t_export:.1f} s in a worker process started with the script (waited "
        f"{t_wait:.1f} s for it here); the loaded call {ms:.2f} ms against the general engine's "
        f"{ms_general:.2f} ms (both with host work, median of 3); {err:.2e}  ({card})")
    return dict(bytes=len(blob), export_s=t_export, wait_s=t_wait, ms=ms,
                general_ms=ms_general, err=err)


def mesh_native(pt, card: str) -> dict:
    """``read_pmetrics_native`` on a generated 100 000-row CSV against the
    Python reader (the same subjects, occasions and events), and
    ``run_pkm_host`` on the ODE artifact of ``tests/test_pkm_host.py``
    against the port's engine on the card (rtol 1e-10, atol 1e-12) within
    1e-8."""
    import io
    import tempfile

    from pharmsol_tpu_torch.data.pmetrics import read_pmetrics
    from pharmsol_tpu_torch.dsl import compile_model, save_artifact
    from pharmsol_tpu_torch.dsl.pure import PureCovariate
    from pharmsol_tpu_torch.native import (
        native_available, pkm_host_available, read_pmetrics_native, run_pkm_host,
    )

    if not (native_available() and pkm_host_available()):
        raise AssertionError("[27] the native library or the pkm host did not build")
    rows = ["ID,EVID,TIME,DUR,DOSE,ADDL,II,INPUT,OUT,OUTEQ,C0,C1,C2,C3,WT"]
    for sid in range(MESH_CSV_SUBJECTS):
        rows.append(f"s{sid},1,0,0,100,.,.,0,.,.,.,.,.,.,{60 + sid % 30}")
        for t in range(9):
            rows.append(f"s{sid},0,{t + 1},.,.,.,.,.,{50 - t},0,.,.,.,.,{60 + sid % 30}")
    text = "\n".join(rows) + "\n"
    t0 = time.perf_counter()
    nat = read_pmetrics_native(text)
    ms_native = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py = read_pmetrics(io.StringIO(text))
    ms_python = (time.perf_counter() - t0) * 1e3

    def events(data):
        return [(s.id, [(type(e).__name__, e.time, getattr(e, "amount", None),
                         getattr(e, "value", None)) for occ in s.occasions()
                        for e in occ.events],
                 [(n, occ.covariates.get(n).observations()) for occ in s.occasions()
                  for n in occ.covariates.names()]) for s in data.subjects()]

    if len(nat) != MESH_CSV_SUBJECTS or events(nat) != events(py):
        raise AssertionError("[27] the native reader's Data differs from the Python reader's")
    src = ("name = portable\nkind = ode\nparams = ka, cl, v\ncovariates = wt@linear\n"
           "states = depot, central\nderived = ke\noutputs = cp\nbolus(oral) -> depot\n"
           "ke = cl * pow(wt / 70.0, 0.75) / v\ndx(depot) = -ka * depot\n"
           "dx(central) = ka * depot - ke * central\nout(cp) = central / v\n")
    runtime = compile_model(src)
    params, obs_times = [1.2, 4.0, 35.0], [1.0, 4.0, 12.0]
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ode.pkm"
        save_artifact(runtime, path)
        t0 = time.perf_counter()
        host = run_pkm_host(path, params, [(0.0, 100.0, 0)], obs_times,
                            cov={"wt": PureCovariate([(0.0, 80.0)])}, dt=0.005)
        ms_host = (time.perf_counter() - t0) * 1e3
    s = pt.Subject.builder("s").bolus(0.0, 100.0, "oral").covariate("wt", 0.0, 80.0)
    for t in obs_times:
        s = s.observation(t, 0.0, "cp")
    card_pred = np.asarray(runtime.model.with_tolerances(1e-10, 1e-12).estimate_predictions(
        s.build(), params, device="cuda").flat_predictions())
    got = np.array([h[0] for h in host])
    err = float(np.max(np.abs(got - card_pred) / np.abs(card_pred)))
    if not err <= 1e-8:
        raise AssertionError(f"[27] pkm host against the card: {err:.3e}")
    log(f"[27] read_pmetrics_native on {len(rows) - 1} rows: {ms_native:.1f} ms, the Python "
        f"reader {ms_python:.1f} ms, the same Data; run_pkm_host (ODE artifact, RK4 dt 0.005) "
        f"{ms_host:.1f} ms, against the engine on the card {err:.2e}  ({card})")
    return dict(csv_rows=len(rows) - 1, native_ms=ms_native, python_ms=ms_python,
                pkm_ms=ms_host, pkm_err=err)


class ExportWorker:
    """Phase 27's ``export_worker`` in a process of its own, started when
    the script starts: its host tracing runs beside the build, and phase 27
    collects the artifact (``pending``)."""

    def __init__(self):
        import multiprocessing as mp

        self.pool = mp.get_context("spawn").Pool(1)
        self.pending = self.pool.apply_async(export_worker)
        self.pool.close()

    def stop(self):
        self.pool.terminate()
        self.pool.join()


def run_mesh(pt, card: str, export: ExportWorker) -> tuple:
    """Phase 27: the device split on the one card (meshes of ``cuda:0``),
    the psi export and the native host library. It first waits for the
    export worker, so that no host tracing runs beside its timings. Returns
    (each cell's launches by kernel for the kernels line, a function that
    runs the K1a cell's trace check again)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    blob, t_export = export.pending.get(timeout=600)
    artifact = (blob, t_export, time.perf_counter() - t0)
    rng = np.random.RandomState(SEED + 27)
    meshes = cuda_meshes(pt)
    cells = mesh_cells(pt, rng)
    t_cells = time.perf_counter() - t_phase
    results = {cell[0]: mesh_cell(pt, cell, meshes, card) for cell in cells}
    fit = mesh_batch_and_fit(pt, meshes, card)
    native = mesh_native(pt, card)
    export = mesh_export(pt, artifact, card)
    pt.set_float_dtype(torch.float64)
    t_all = time.perf_counter() - t_phase
    recheck_args = results["K1a"].pop("recheck")
    record = dict(cells=results, batch_fit=fit, export=export, native=native,
                  data_s=t_cells, phase_s=t_all, card=card)
    log(f"[27] phase 27: {t_all:.1f} s ({t_cells:.1f} s building the cells' data, "
        f"{artifact[2]:.1f} s waiting for the export worker); mesh: "
        + json.dumps(record, default=float))

    def recheck(after: str) -> None:
        label, kernel, run, whole = recheck_args
        pt.set_float_dtype(torch.float64)
        trace = mesh_trace_check(pt, label, kernel, run, whole)
        log(f"[27] {label} ({kernel}) after {after}: the (8, 1) trace holds "
            f"{trace['traced']} {MESH_TRACE_NAMES[kernel]} events (capture "
            f"{trace['captures']}), psi {trace['traced_err']:.2e} from the whole call's  "
            f"({card})")

    return ({k: dict(v["launches"], traced_8x1=v["traced"]) for k, v in results.items()},
            recheck)


def mesh_build(pt) -> None:
    """``--only mesh``'s phase 1: the closed-form library and phase 27's
    others, the ODE Short RHS (K2a), the transit RHS (K2d) and the README
    SDE (K3a), one nvcc each, all at once."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs
    from pharmsol_tpu_torch.utils.f32_budget import expm_case

    rhs, n, ndrugs, _, v, _ = ODE_MODELS["short"]
    model, data, sp, ems = expm_case("transit", 2, 2, seed=SEED)
    targets = [_build.psi_target(),
               _build.generated_target(_build.ODE, generate_rhs(rhs, n, v + 1, ndrugs)),
               _build.generated_target(_build.ODE,
                                       ode_plan_for(model, data, sp, ems, torch.float64).rhs),
               dict(sde_build_targets(pt))["readme"]]
    t0 = time.perf_counter()
    _build.build_many(targets, force=True)
    log(f"[1] built {len(targets)} libraries with nvcc in {time.perf_counter() - t0:.2f} s "
        f"wall, one process each")
    _build.load_library()


# ---------------------------------------------------------------------------
# Phase 28: the closure styles (vector-style code, the elementwise set, a
# state-dependent power) on the kernels
# ---------------------------------------------------------------------------

STYLE_SHORT = (16384, 512)      # the K2a cell, vector-style
STYLE_TMDD = (16384, 512)       # the K2c cell (bdf), vector-style
STYLE_CHECK = (64, 48)          # the math model and the transit model, kernel vs twin
STYLE_SDE = (8, 8)              # the tanh README SDE, x SDE_PARTICLES, first observation
STYLE_REPS = 5                  # kernel alone: CUDA events over this many launches
STYLE_SOLVERS = {"K2a": "dopri5", "K2e": "dopri5", "K2b": "kvaerno3", "K2c": "bdf"}
STYLE_IDS = {"K2a": ODE_KERNEL_RECORD, "K2e": ODE_FEATURE_KERNEL_RECORD,
             "K2b": STIFF_SDIRK_RECORD, "K2c": STIFF_BDF_RECORD, "K2d": EXPM_KERNEL_RECORD,
             "K3a": SDE_KERNEL_RECORD}


def style_math_case(solver: str, features: bool = True):
    """Phase 28's math model (``utils/style_cases.py::math_case``: every
    operation of the generator's elementwise set and a state-dependent
    power; with ``features`` a time-varying weight and a lag) at
    ``STYLE_CHECK``, from its own seed."""
    from pharmsol_tpu_torch.utils.style_cases import math_case

    return math_case(*STYLE_CHECK, seed=SEED + 40, solver=solver, features=features)


def style_twin_jobs() -> list:
    """The float64 twins of the math model under the stiff solvers, run by
    :class:`StiffTwins` while the libraries build."""
    return [("style", "math", solver, True, "float64", 3) for solver in ("bdf", "kvaerno3")]


def style_vector_models(pt):
    """The vector-style spellings of the ODE Short, TMDD (bdf) and transit
    (expm) models, each with its list-style model: name -> (list, vector)."""
    from pharmsol_tpu_torch.utils import style_cases as sc
    from pharmsol_tpu_torch.utils.f32_budget import expm_case

    short = ode_model(pt, "short")
    tmdd = tmdd_model("bdf")
    transit = expm_case("transit", 1, 1)[0]

    def spelled(model, rhs, solver):
        return pt.ODE(rhs, init=model._init, out=model._out, nstates=model.nstates(),
                      ndrugs=model.ndrugs(), nout=model.nouteqs()).with_solver(solver)

    return {"short": (short, spelled(short, sc.short_vector, "dopri5")),
            "tmdd": (tmdd, spelled(tmdd, sc.tmdd_vector, "bdf")),
            "transit": (transit, spelled(transit, sc.transit_vector, "expm"))}


def tanh_sde(pt, nparticles: int = SDE_PARTICLES):
    from pharmsol_tpu_torch.utils.style_cases import readme_tanh_drift

    return readme_sde(pt, nparticles, drift=readme_tanh_drift)


def style_build_targets(pt) -> tuple:
    """Phase 28's libraries: (ode, sde) lists of (name, target). The
    vector-style models share their list-style models' headers, so their
    libraries (the Short explicit, the TMDD bdf and the transit expm one)
    are the other phases' (listed here for ``--only styles``); the math
    model adds its explicit libraries with and without features, its bdf
    and kvaerno3 libraries, and the tanh SDE its K3a library."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs, generate_sde

    ode = []
    for name, (listed, _) in style_vector_models(pt).items():
        solver = listed._opts.solver
        gen = generate_rhs(listed._diffeq, listed.nstates(), {"short": 5}.get(name, 7), 1,
                           jacobian=solver != "dopri5")
        ode.append((f"style {name} {solver}",
                    _build.generated_target(_build.ode_kind(solver), gen)))
    for kernel, solver in STYLE_SOLVERS.items():
        model, data, support, ems = style_math_case(solver, features=kernel != "K2a")
        gen = ode_plan_for(model, data, support, ems, torch.float64).rhs
        ode.append((f"style math {kernel} {solver}",
                    _build.generated_target(_build.ode_kind(solver), gen)))
    spec = tanh_sde(pt).spec
    gen = generate_sde(spec.drift, spec.diffusion, spec.nstates, 3, spec.ninput)
    return dedupe_targets(ode), [("style tanh readme", _build.generated_target(_build.SDE, gen))]


def style_launches(kernel: str) -> int:
    from pharmsol_tpu_torch.ops import fused_ode, fused_sde

    return {"K2a": lambda: fused_ode.LAUNCHES, "K2e": lambda: fused_ode.FEATURE_LAUNCHES,
            "K2d": lambda: fused_ode.EXPM_LAUNCHES, "K2b": lambda: fused_ode.SDIRK_LAUNCHES,
            "K2c": lambda: fused_ode.BDF_LAUNCHES, "K3a": lambda: fused_sde.LAUNCHES}[kernel]()


def style_call(pt, label: str, kernel: str, model, data, sp, ems, out: dict) -> torch.Tensor:
    """One entry-point call on the card with every launch count set to 0 just
    before and read just after: the fused engine, one launch of ``kernel``
    and of no other, psi of the data's shape without NaN; the launch is
    tallied in ``out[kernel]["launches"]``."""
    reset_kernel_launches()
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_launches().items() if v}
    dec = pt.last_engine_decision(model)
    if dec["engine"] != "fused" or style_launches(kernel) != 1 or len(launched) != 1:
        raise AssertionError(f"{label}: engine {dec['engine']} ({dec.get('reason')}), "
                             f"launches {launched}, wanted one {kernel}")
    if tuple(psi.shape) != (len(data), sp.shape[0]) or bool(torch.isnan(psi).any()):
        raise AssertionError(f"{label}: psi {tuple(psi.shape)}, NaN {bool(torch.isnan(psi).any())}")
    rec = out.setdefault(kernel, {})
    rec["launches"] = rec.get("launches", 0) + 1
    return psi


def style_cell(pt, name: str, kernel: str, listed, vector, data, supports, ems, card: str,
               out: dict) -> None:
    """A vector-style cell against its list-style cell at full width: the
    same header key, the vector model's style ``stacked``, in each dtype one
    entry-point call per model on the same supports (one ``kernel`` launch
    each) and psi equal cell for cell; each model's kernel alone and its
    end-to-end call, side by side."""
    n, S = len(data), supports[0].shape[0]
    label = f"style {name} vector {n}x{S}"
    keys = []
    for model in (listed, vector):
        plan = ode_plan_for(model, data, supports[0], ems, torch.float64)
        keys.append((plan.rhs.key, plan.rhs.style))
    if keys[0][0] != keys[1][0] or [k[1] for k in keys] != ["lanes", "stacked"]:
        raise AssertionError(f"{label}: header keys and styles {keys}")
    log(f"[28] {label}: header key {keys[1][0]} equal to the list-style cell's "
        f"(styles lanes / stacked)")
    for dtype, sp in zip((torch.float32, torch.float64), supports):
        d = str(dtype)[6:]
        pt.set_float_dtype(dtype)
        want = style_call(pt, f"{label} list {d}", kernel, listed, data, sp, ems, {})
        got = style_call(pt, f"{label} {d}", kernel, vector, data, sp, ems, out)
        same = bool(((got == want) | (torch.isneginf(got) & torch.isneginf(want))).all())
        diff = float((got - want).nan_to_num(0.0, 0.0, 0.0).abs().max())
        log(f"[28] {label} {d}: one {kernel} launch per call; psi against the list-style "
            f"cell's: max abs diff {diff:.2e}, every cell equal {same}")
        if not same:
            raise AssertionError(f"{label} {d}: psi differs from the list-style cell's")
        times = {}
        for tag, model in (("list", listed), ("vector", vector)):
            plan = ode_plan_for(model, data, sp, ems, dtype)
            times[tag] = (cuda_ms(lambda: run_ode_kernel(plan), STYLE_REPS, 1),
                          wall_ms(lambda: pt.log_likelihood_matrix(model, data, sp, ems,
                                                                   device="cuda"), 3))
            del plan
        log(f"[28] {label} {d}: {kernel} alone {times['vector'][0]:.3f} ms (list-style "
            f"{times['list'][0]:.3f}), end to end {times['vector'][1]:.3f} ms (list-style "
            f"{times['list'][1]:.3f}) ({card})")
        rec = out.setdefault(kernel, {})
        rec[f"cell_{d}"] = dict(shape=f"{name}_vector_{n}x{S}", kernel_ms=times["vector"][0],
                                list_kernel_ms=times["list"][0],
                                end_to_end_ms=times["vector"][1],
                                list_end_to_end_ms=times["list"][1], max_abs_diff=diff)
        del got, want


def style_hold(label: str, kernel: str, got64, twin64, got32, row: str, twin32_fn) -> dict:
    """Kernel against twin by the script's rules: K2a, K2e 1e-8 relative,
    K2b, K2c every cell 1e-6 and 99% within 1e-8 (:func:`compare_stiff`), K2d
    1e-10; float32 against the float64 twin within the budget row ``row``
    (:func:`hold_f32`)."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET

    abs_err = float((got64 - twin64)[torch.isfinite(twin64)].abs().max())
    if kernel in ("K2b", "K2c"):
        err, share = compare_stiff(label, got64, twin64)
        rule = f"max {err:.3e} (<= 1e-6), {share * 100:.2f}% within 1e-8 (>= 99%)"
    else:
        tol = 1e-10 if kernel == "K2d" else 1e-8
        err = rel_err(got64, twin64, 1.0)
        if err > tol or not bool((torch.isfinite(got64) == torch.isfinite(twin64)).all()):
            raise AssertionError(f"{label}: kernel vs twin {err} > {tol}")
        rule = f"max rel {err:.3e} (<= {tol:g})"
    err32, note = hold_f32(label + " f32", got32, twin64, F32_BUDGET[row], twin32_fn)
    log(f"[28] {label}: f64 kernel vs twin {rule}, max abs {abs_err:.3e}; f32 kernel vs f64 "
        f"twin {err32:.3e} (<= {F32_BUDGET[row]:g}, {row}){note}")
    return dict(max_abs_err=abs_err, rel_err=err, f32_err=err32)


def style_checks(pt, twins, out: dict, card: str) -> None:
    """The new headers at STYLE_CHECK: the math model in the explicit (K2a
    without features, K2e with them), kvaerno3 (K2b) and bdf (K2c)
    libraries and the transit model written as whole-vector arithmetic
    (K2d, the list-style key): each once through the entry point (one launch
    of its kernel), then the kernel against its twin."""
    from pharmsol_tpu_torch.utils.f32_budget import expm_case

    for kernel, solver in STYLE_SOLVERS.items():
        model, data, support, ems = style_math_case(solver, features=kernel != "K2a")
        label = f"style math {kernel} {solver} {STYLE_CHECK[0]}x{STYLE_CHECK[1]}"
        pt.set_float_dtype(torch.float64)
        style_call(pt, label, kernel, model, data, support, ems, out)
        plan64 = ode_plan_for(model, data, support, ems, torch.float64)
        plan32 = ode_plan_for(model, data, support, ems, torch.float32)
        if plan64.rhs.style != "lanes" or "pm_tanh(" not in plan64.rhs.source:
            raise AssertionError(f"{label}: header {plan64.rhs.key} style {plan64.rhs.style}")
        got64, got32 = run_ode_kernel(plan64), run_ode_kernel(plan32)
        torch.cuda.synchronize()
        if kernel in ("K2b", "K2c"):
            twin64 = twins.get("style", "math", solver, True, "float64", 3)["psi"]
        else:
            twin64 = run_ode_kernel(plan64, plain=True)
        rec = style_hold(label, kernel, got64, twin64, got32,
                         "ode_dopri5" if solver == "dopri5" else "ode_bdf",
                         lambda: run_ode_kernel(plan32, plain=True))
        rec["ms_f64"] = cuda_ms(lambda: run_ode_kernel(plan64), STYLE_REPS, 1)
        rec["ms"] = cuda_ms(lambda: run_ode_kernel(plan32), STYLE_REPS, 1)
        rec["header"] = plan64.rhs.key
        log(f"[28] {label}: {kernel} alone {rec['ms']:.3f} / {rec['ms_f64']:.3f} ms "
            f"(f32 / f64) ({card})")
        out.setdefault(kernel, {})["math"] = rec
    listed, vector = style_vector_models(pt)["transit"]
    lmodel, data, support, ems = expm_case("transit", *STYLE_CHECK, seed=SEED + 41)
    label = f"style transit vector expm {STYLE_CHECK[0]}x{STYLE_CHECK[1]}"
    style_call(pt, label, "K2d", vector, data, support, ems, out)
    plan64 = ode_plan_for(vector, data, support, ems, torch.float64)
    plan32 = ode_plan_for(vector, data, support, ems, torch.float32)
    want_key = ode_plan_for(lmodel, data, support, ems, torch.float64).rhs.key
    if plan64.rhs.key != want_key or plan64.rhs.style != "stacked":
        raise AssertionError(f"{label}: key {plan64.rhs.key} (list {want_key}), "
                             f"style {plan64.rhs.style}")
    got64, got32 = run_ode_kernel(plan64), run_ode_kernel(plan32)
    twin64 = run_ode_kernel(plan64, plain=True)
    rec = style_hold(label + f" (list-style key {want_key})", "K2d", got64, twin64, got32,
                     "ode_expm", lambda: run_ode_kernel(plan32, plain=True))
    rec["ms_f64"] = cuda_ms(lambda: run_ode_kernel(plan64), STYLE_REPS, 1)
    rec["ms"] = cuda_ms(lambda: run_ode_kernel(plan32), STYLE_REPS, 1)
    rec["header"] = plan64.rhs.key
    log(f"[28] {label}: K2d alone {rec['ms']:.3f} / {rec['ms_f64']:.3f} ms (f32 / f64) ({card})")
    out.setdefault("K2d", {})["transit_vector"] = rec


def style_sde(pt, rng, out: dict, card: str) -> None:
    """K3a on the README SDE with a tanh drift term at STYLE_SDE x
    SDE_PARTICLES, the first observation: once through the entry point (one
    K3a launch), then against its twin at zero diffusion (every cell within
    1e-10) and with noise (float64, 99.9% within 1e-9, the twin's Philox
    numbers)."""
    R, S = STYLE_SDE
    model, ems = tanh_sde(pt), readme_ems(pt)
    data = readme_data(pt, R, rng, n_obs=1)
    label = f"style tanh README SDE {R}x{S}x{SDE_PARTICLES}"
    sp0, sp = readme_support(S, rng, sigma=0.0), readme_support(S, rng)
    pt.set_float_dtype(torch.float64)
    style_call(pt, label, "K3a", model, data, sp, ems, out)
    plan0 = sde_plan_for(model, data, sp0, ems, torch.float64)
    if "pm_tanh(" not in plan0.gen.source:
        raise AssertionError(f"{label}: the drift's header holds no tanh")
    got, twin = run_sde_kernel(plan0), run_sde_kernel(plan0, plain=True)
    abs0, rel0 = sde_compare(f"{label} sigma_ke=0 f64 vs twin", got, twin, 1e-10, 1.0, 28)
    plan = sde_plan_for(model, data, sp, ems, torch.float64)
    got, twin = run_sde_kernel(plan), run_sde_kernel(plan, plain=True)
    abs_n, rel_n = sde_compare(f"{label} f64 vs twin (same Philox)", got, twin, 1e-9, 0.999, 28)
    out["K3a"]["tanh_readme"] = rec = dict(
        max_abs_err=max(abs0, abs_n), zero_diffusion_rel=rel0, noise_rel=rel_n,
        ms_f64=cuda_ms(lambda: run_sde_kernel(plan), 3, 1), header=plan.gen.key)
    log(f"[28] {label}: K3a alone {rec['ms_f64']:.3f} ms (f64) ({card})")


def run_styles(pt, rng, card: str, twins, short_data=None) -> dict:
    """Phase 28: the vector-style ODE Short (K2a) and TMDD bdf (K2c) cells
    against their list-style cells at full width, the math model on K2a,
    K2e, K2b and K2c and the vector-style transit model on K2d at 64 x 48,
    and the tanh README SDE on K3a. Returns, per kernel, what the phase
    measured (``launches``: its entry-point calls' launches)."""
    t0 = time.perf_counter()
    out = {}
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    models = style_vector_models(pt)
    if short_data is None:
        short_data = short_subjects(pt, STYLE_SHORT[0], rng)
    supports = [ODE_MODELS["short"][5](np.random.RandomState(SEED + 42 + i), STYLE_SHORT[1])
                for i in range(2)]
    style_cell(pt, "ode_short", "K2a", *models["short"], short_data, supports, ems, card, out)
    tmdd_data, tmdd_ems, _ = tmdd_population(pt, STYLE_TMDD[0], np.random.RandomState(SEED + 8))
    supports = [tmdd_support(STYLE_TMDD[1], np.random.RandomState(SEED + 44 + i))
                for i in range(2)]
    style_cell(pt, "ode_tmdd_bdf", "K2c", *models["tmdd"], tmdd_data, supports, tmdd_ems,
               card, out)
    del tmdd_data
    style_checks(pt, twins, out, card)
    style_sde(pt, rng, out, card)
    pt.set_float_dtype(torch.float64)
    log(f"[28] the closure styles: K2a, K2e, K2b, K2c, K2d and K3a on vector-style and "
        f"elementwise-set headers, every check within its rule, in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return out


def style_records(styles: dict) -> list:
    """``--only styles``'s kernels line: phase 28's numbers per kernel."""
    return [dict(STYLE_IDS[k], styles=v) for k, v in styles.items()]


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--pair-worker":
        only = None if sys.argv[4] == "all" else sys.argv[4]
        print("PAIR " + json.dumps(pair_worker(sys.argv[2], sys.argv[3], only)), flush=True)
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["stiff", "sde", "k1c", "explicit", "closed",
                                           "single", "authoring", "estimation", "diagnostics",
                                           "nca", "mesh", "styles"],
                        default=None,
                        help="run a part, for work on its kernels: 'stiff' phases 0, 1 (the "
                             "stiff libraries alone) and 13-15 (K2b, K2c); 'explicit' phases "
                             "0, 1 (the explicit tier's libraries), phase 2's K2a and K2e "
                             "checks, 3-4 (ODE Short) and 8 (ODE covariates); 'sde' phases 0, 1 "
                             "(the SDE libraries), 5-7 and 16-18 (K3a, K3b); 'k1c' phases 0, 1 "
                             "(the closed-form library) and 19-21 (K1c); 'closed' phases 0, 1 "
                             "(the closed-form library), phase 2's K1a and K1b checks, 3-4 for "
                             "the two K1a and the two K1b cells, 19-21 (K1c) and the "
                             "closed-form kernel's anatomy on the six cells; 'single' phases 0 "
                             "and 22 (the single-subject API and the per-subject batch, no "
                             "library built); 'authoring' phases 0, 1 (the closed-form library "
                             "and the ODE and SDE libraries of its models) and 23 (models "
                             "written as DSL text and with the declarative API on K1a, K1b, "
                             "K2a, K2e and K3a, a .pkm artifact, the NPAG fit over the DSL "
                             "model); 'estimation' phases 0 and 24 (log_likelihood_fn, "
                             "fit_map, fit_laplace, laplace_standard_errors and fit_saem on the "
                             "card against the CPU, no library built); 'diagnostics' phases 0 "
                             "and 25 (bootstrap_laplace, sse_laplace, vpc, npde, llp and scm "
                             "on the card against the CPU, no library built); 'nca' phases 0 "
                             "and 26 (batch_nca_device on the card against the host batch, no "
                             "library built); 'mesh' phases 0, 1 (the closed-form library and "
                             "the ODE Short, transit and README SDE libraries) and 27 (the "
                             "device split over meshes of cuda:0, export_psi, the native "
                             "reader and the .pkm host); 'styles' phases 0, 1 (phase 28's "
                             "libraries) and 28 (vector-style closures, the elementwise set "
                             "and a state-dependent power on K2a, K2e, K2b, K2c, K2d and K3a). "
                             "The kernels line then "
                             "holds that part's kernels and the last line says {\"ok\": true, "
                             "\"partial\": ...}, not the whole script's verdict")
    parser.add_argument("--pair", metavar="DIR", default=None,
                        help="hold this checkout against the one at DIR, in the order DIR, "
                             "here, here, DIR: K3a's README cell, K3b's covariate cell and the "
                             "stiff cell under each solver timed, their psi compared, the "
                             "kernels' registers and anatomy (with --only sde, stiff, explicit "
                             "or closed: that part alone; closed: the four K1b and K1c cells and "
                             "K1a's two cells, kernel, plan and call)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2

    import pharmsol_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    card = phase_environment()
    if args.pair is not None:
        if args.only not in (None, "sde", "stiff", "explicit", "closed"):
            raise SystemExit("--pair takes --only sde, stiff, explicit or closed")
        run_pair(args.pair, card, args.only)
        print(card)
        print(json.dumps({"ok": True, "partial": "pair"}))
        return 0
    if args.only == "single":
        run_single(pt, card)
        closing_lines([], card, partial="single")
        return 0
    if args.only == "estimation":
        run_estimation(pt, card)
        closing_lines([], card, partial="estimation")
        return 0
    if args.only == "diagnostics":
        run_diagnostics(pt, card)
        closing_lines([], card, partial="diagnostics")
        return 0
    if args.only == "nca":
        run_nca(pt, card)
        closing_lines([], card, partial="nca")
        return 0
    if args.only == "mesh":
        export = ExportWorker()
        try:
            mesh_build(pt)
            traced_launches(pt, lambda: None)
            run_mesh(pt, card, export)
        finally:
            export.stop()
        closing_lines([], card, partial="mesh")
        return 0
    if args.only == "authoring":
        phase_build(pt, {}, {}, {}, only="authoring")
        run_authoring(pt, card)
        closing_lines([], card, partial="authoring")
        return 0
    if args.only == "explicit":
        closing_lines(run_explicit(pt, rng, card), card, partial="explicit")
        return 0
    if args.only == "closed":
        closing_lines(run_closed(pt, rng, card), card, partial="closed")
        return 0
    if args.only in ("sde", "k1c"):
        phase_build(pt, {}, {}, {}, only=args.only)
        if args.only == "sde":
            records = [run_sde_base(pt, rng, card), run_sde_feature_slice(pt, rng, card)]
        else:
            records = [run_k1c_slice(pt, rng, card)]
        closing_lines(records, card, partial=args.only)
        return 0
    if args.only == "styles":
        # the math model's stiff twins run in worker processes while nvcc builds
        twins = StiffTwins(style_twin_jobs())
        try:
            phase_build(pt, {}, {}, {}, only="styles")
            twins.wait()
            records = style_records(run_styles(pt, rng, card, twins))
        finally:
            twins.stop()
        closing_lines(records, card, partial="styles")
        return 0
    stiff = stiff_cases()
    # the stiff slice's and phase 28's twins run in worker processes while
    # nvcc builds
    twins = StiffTwins(stiff_twin_jobs(stiff) + ([] if args.only == "stiff"
                                                 else style_twin_jobs() + [SDE_BOUND_JOB]))
    if args.only == "stiff":
        try:
            phase_build(pt, {}, {}, stiff, only="stiff")
            twins.wait()
            records = run_stiff_slice(pt, rng, stiff, card, twins)
        finally:
            twins.stop()
        closing_lines(records, card, partial="stiff")
        return 0
    # phase 27's export traces in a worker process while nvcc builds
    export = ExportWorker()
    try:
        expm = expm_cases()
        ode_features = ode_feature_cases()
        phase_build(pt, ode_features, expm, stiff)
        torch.cuda.synchronize()
        # the profiler's first start (seconds) while the stiff twins finish
        traced_launches(pt, lambda: None)
        twins.wait()
        return run_all(pt, rng, card, args, expm, ode_features, stiff, twins, export)
    finally:
        twins.stop()
        export.stop()


def run_sde_base(pt, rng, card: str, twins=None) -> dict:
    """Phases 5-7: K3a's checks (timed, for the cut of its twin), its cell,
    its times and its bound at full width (its twin from ``twins``' worker
    where given); K3a's record."""
    t0 = time.perf_counter()
    sde_reduced = phase_sde_kernels(pt, rng)
    t_twin = time.perf_counter() - t0
    log(f"[5] cut: the K3a checks against the twin took {t_twin:.1f} s with "
        f"{SDE_REDUCED_OBS} observations (before the cut, 3: {BEFORE_CUTS_S['sde_twin'][0]} - "
        f"{BEFORE_CUTS_S['sde_twin'][1]} s): {BEFORE_CUTS_S['sde_twin'][0] - t_twin:.1f}"
        f" - {BEFORE_CUTS_S['sde_twin'][1] - t_twin:.1f} s saved")
    general_ms = phase_sde_statistical(pt, rng)
    phase_sde_cross_family(pt, rng)
    torch.cuda.synchronize()
    sde_label, sde, sde_data, sde_launches = phase_sde_slice(pt, rng)
    sde_times = phase_sde_times(pt, sde_label, sde, sde_data, card)
    torch.cuda.synchronize()
    full_bound = phase_sde_full_bound(pt, sde, sde_data, card, twins)
    torch.cuda.synchronize()
    plan = sde_plan_for(sde, sde_data, readme_support(2, np.random.RandomState(SEED + 5)),
                        readme_ems(pt), torch.float64)
    anatomy = phase_sde_anatomy(
        pt, "K3a", plan, {dt: t["kernel"] for dt, t in sde_times.items()},
        {dt: b["trials"] for dt, b in full_bound.items()}, card, 7)
    r32, r64 = sde_reduced[torch.float32], sde_reduced[torch.float64]
    return dict(
        SDE_KERNEL_RECORD,
        launches=sde_launches,
        max_abs_err=r64["abs_err"],
        max_abs_err_f32=r32["abs_err"],
        ms=r32["kernel"],
        plain_ms=r32["twin"],
        bound_ms=r32["bound"],
        bound_by=r32["bound_by"],
        library_ms=None,
        ms_f64=r64["kernel"],
        plain_ms_f64=r64["twin"],
        bound_ms_f64=r64["bound"],
        shape="readme_sde_{}x{}x{}".format(*SDE_REDUCED, SDE_PARTICLES),
        general_ms_f64=r64["general"],
        general_ms_f64_stat=general_ms,
        stat_shape="readme_sde_{}x{}x{}".format(*SDE_STAT, SDE_PARTICLES),
        ms_full=sde_times[torch.float32]["kernel"],
        ms_full_f64=sde_times[torch.float64]["kernel"],
        bound_ms_float=r32["bound_float"],
        bound_ms_float_f64=r64["bound_float"],
        bound_ms_full=full_bound[torch.float32]["bound"],
        bound_ms_full_f64=full_bound[torch.float64]["bound"],
        bound_ms_full_float=full_bound[torch.float32]["bound_float"],
        bound_ms_full_float_f64=full_bound[torch.float64]["bound_float"],
        anatomy=anatomy,
        end_to_end_ms_full=sde_times[torch.float32]["end_to_end"],
        end_to_end_ms_full_f64=sde_times[torch.float64]["end_to_end"],
        shape_full=sde_label,
    )


def explicit_records(ode_label, ode_launches, ode_times, cov_label, cov_launches,
                     cov_times) -> tuple:
    """K2a's and K2e's entries of the kernels line (times of the float32
    runs, float64 beside them)."""
    o32, o64 = ode_times[torch.float32], ode_times[torch.float64]
    ode_record = dict(
        ODE_KERNEL_RECORD,
        launches=ode_launches,
        max_abs_err=o64["abs_err"],
        max_abs_err_f32=o32["abs_err"],
        ms=o32["kernel"],
        plain_ms=o32["twin"],
        bound_ms=o32["bound"],
        bound_by=o32["bound_by"],
        library_ms=None,
        ms_f64=o64["kernel"],
        plain_ms_f64=o64["twin"],
        bound_ms_f64=o64["bound"],
        shape=ode_label,
    )
    c32, c64 = cov_times[torch.float32], cov_times[torch.float64]
    ode_feature_record = dict(
        ODE_FEATURE_KERNEL_RECORD,
        launches=cov_launches,
        max_abs_err=c64["abs_err"],
        max_abs_err_f32=c32["abs_err"],
        ms=c32["kernel"],
        plain_ms=c32["twin"],
        bound_ms=c32["bound"],
        bound_by=c32["bound_by"],
        library_ms=None,
        ms_f64=c64["kernel"],
        plain_ms_f64=c64["twin"],
        bound_ms_f64=c64["bound"],
        shape=cov_label,
        end_to_end_ms=c32["end_to_end"],
        end_to_end_ms_f64=c64["end_to_end"],
        plan_ms=c32["plan"],
        plan_ms_f64=c64["plan"],
    )
    return ode_record, ode_feature_record


def run_explicit(pt, rng, card: str) -> list:
    """``--only explicit``: phases 0-1 for the explicit tier's libraries,
    phase 2's K2a and K2e checks, the ODE Short cell (phases 3-4) and the ODE
    covariates cell (phase 8), with the anatomy and the lane model of each;
    K2a's and K2e's records."""
    cases = ode_feature_cases()
    phase_build(pt, cases, {}, {}, only="explicit")
    phase_ode_kernels(pt, rng)
    phase_ode_feature_kernels(pt, cases)
    torch.cuda.synchronize()
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    short_data = short_subjects(pt, 16384, rng)
    ode_label, ode, ode_launches = phase_ode_slice(pt, rng, short_data, ems)
    torch.cuda.synchronize()
    ode_times = phase_ode_times(pt, ode_label, ode, short_data, ems, card)
    cov_label, cov_model, cov_data, cov_ems, cov_launches, cov_build = \
        phase_ode_feature_slice(pt, rng)
    torch.cuda.synchronize()
    cov_times = phase_ode_feature_times(pt, cov_label, cov_model, cov_data, cov_ems,
                                        cov_build, card)
    return list(explicit_records(ode_label, ode_launches, ode_times, cov_label, cov_launches,
                                 cov_times))


def run_all(pt, rng, card, args, expm, ode_features, stiff, twins, export) -> int:
    """Phases 27, 2-26 and the last lines: phase 27 runs first, in the
    state ``--only mesh`` leaves it, and its K1a trace check runs again
    after phase 26, after the other phases' profilers and CUDA graphs."""
    mesh_launches, mesh_recheck = run_mesh(pt, card, export)
    phase_kernels(pt, rng)
    phase_feature_kernels(pt)
    phase_ode_kernels(pt, rng)
    phase_ode_feature_kernels(pt, ode_features)
    phase_cross_family(pt, rng)
    torch.cuda.synchronize()
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    workloads = slice_workloads(pt, rng)
    launches = phase_slice(pt, rng, workloads, ems)
    torch.cuda.synchronize()
    errs = phase_kernel_at_slice(pt, workloads, ems)
    torch.cuda.synchronize()
    features = feature_workloads(pt, rng)
    feature_launches = {w[0]: phase_feature_slice(pt, rng, w, ems) for w in features}
    torch.cuda.synchronize()
    feature_times = {w[0]: phase_feature_times(pt, w, ems, card) for w in features}
    torch.cuda.synchronize()
    short_data = workloads[0][2]
    ode_label, ode, ode_launches = phase_ode_slice(pt, rng, short_data, ems)
    torch.cuda.synchronize()
    times = phase_times(pt, workloads, ems, card)
    ode_times = phase_ode_times(pt, ode_label, ode, short_data, ems, card)
    torch.cuda.synchronize()
    sde_record = run_sde_base(pt, rng, card, twins)
    cov_label, cov_model, cov_data, cov_ems, cov_launches, cov_build = \
        phase_ode_feature_slice(pt, rng)
    torch.cuda.synchronize()
    cov_times = phase_ode_feature_times(pt, cov_label, cov_model, cov_data, cov_ems,
                                        cov_build, card)
    torch.cuda.synchronize()
    expm_rec, fit_a, fit_b = run_expm_slice(pt, rng, expm, card)
    stiff_recs = run_stiff_slice(pt, rng, stiff, card, twins)
    sde_feature_rec = run_sde_feature_slice(pt, rng, card)
    k1c_rec = run_k1c_slice(pt, rng, card)
    run_single(pt, card)
    run_authoring(pt, card)
    # phases 24 and 25 time their card work alone, one after the other, then
    # share one window of CPU references beside their untimed card work
    window = RefWindow()
    finish_estimation = run_estimation(pt, card, window)
    finish_diagnostics = run_diagnostics(pt, card, window)
    done, window_s = window.run()
    finish_estimation(done, window_s)
    finish_diagnostics(done, window_s)
    run_nca(pt, card)
    # phase 27's trace check again, after every other phase's profilers and
    # CUDA graphs
    mesh_recheck("phases 2-26")
    styles = run_styles(pt, rng, card, twins, short_data=workloads[0][2])

    # times of the float32 runs; float64 beside them; no single PyTorch
    # call computes any of these functions, so library_ms is null
    record = k1a_record(workloads, launches, errs, times, fit_a)
    feature_record = feature_record_of(features[0][0], feature_launches, feature_times)
    ode_record, ode_feature_record = explicit_records(
        ode_label, ode_launches, ode_times, cov_label, cov_launches, cov_times)
    log("[10] fits: " + json.dumps({"fit_a": fit_a, "fit_b": fit_b}))
    # phase 27's launches: one per subjects shard on each mesh, and the
    # (8, 1) call's kernel events in its trace
    for rec in (record, feature_record, ode_record, expm_rec, sde_record, k1c_rec):
        rec["mesh_launches"] = mesh_launches[rec["id"]]
    # phase 28's numbers on the new headers and the vector-style cells
    for rec in (ode_record, ode_feature_record, sde_record, expm_rec, *stiff_recs):
        if rec["id"] in styles:
            rec["styles"] = styles[rec["id"]]
    closing_lines([record, feature_record, ode_record, ode_feature_record, sde_record, expm_rec,
                   *stiff_recs, sde_feature_rec, k1c_rec], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
