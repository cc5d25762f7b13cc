#!/usr/bin/env python3
"""Smoke run of diffpiso_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and build the CUDA kernels from
     diffpiso_tpu_torch/csrc (timed);
  2. every kernel against its plain PyTorch version on the card, at 512^2,
     on the operator planes of a real step (jac2 forward and transposed,
     bit-equal to its plain version at the schedule's edges with the
     kernel launches `jacobi2.solve_launches` derives; the solves must
     also agree on their sweep / iteration counts; the FV
     pair forward and VJP, the corrector bridge / tail forward), plus each
     kernel's time, its plain version's, a library yardstick where one
     PyTorch call computes the same thing, its bound, and its device time
     per launch from torch.profiler (measured after phase 6, so no
     profiler session precedes a timed path); then (2b) the same at the
     lid-driven
     cavity's 512 shapes (pressure plane 513 x 512, faces 514 x 512 and
     513 x 513) on the planes of a cavity step: the bounded FV trio
     (grad2m, div2m, gradT2m) forward and VJP, the stencil matvec in both
     forms (yardstick: one cuSPARSE CSR SpMV), the three BiCGSTAB phases
     in both forms on both face shapes, jac2, pcg2 and the Laplace
     assembly; then (2c) at the spatial mixing layer's 128 x 512 on the
     planes of a step 20 steps into its run: the three per-iteration PCG
     phase kernels (residual, apply, update) with deflation off and on and
     shift 0 and non-zero (planes within rel 1e-6 of their scale, scalars
     within rel 1e-5; rows 10a and 10b also bit-equal to
     `pcgphases.residual_exact` / `pcg_apply_exact`, the residual with sum
     x formed and carried in, one kernel a call; yardsticks: one cuSPARSE
     CSR addmm, b - A x, for 10a and one CSR SpMV, A p, for 10b), one
     whole per-iteration PCG solve forward (warm) and
     adjoint (cold) with the kernels against the plain phases (equal
     iteration counts), the matvec on the (128, 513) u plane in both forms
     (bit-equal), jac2 and the Laplace assembly with its masks;
  2l. row 17, the corrector bridge's and tail's backward kernels
     (csrc/corrector_bwd.cu), on phase 2's step planes at 512^2 and on
     seeded planes at 1024^2 and 1024 x 2048: every cotangent bit-equal to
     the plain twins, with and without the coefficient cotangents; against
     autograd's VJP of the forward plain version, the step's cotangents
     bit-equal (the twins sum in its order), all within rel l2 1e-5; host ms,
     device us per launch, bound and the twins' ms in both forms;
  2m. row 16, the fused spectral apply (csrc/gemm.cuh dp_spectral_apply
     through csrc/pcg2.cu, four launches of the hand-written GEMM a call) on the mixing layer's,
     training's and the DNS's channel_mm planes and the 513 x 512 cavity's
     dct_mm plane: rel l2 <= 1e-5 against the four torch.matmuls and the
     divide (TF32 off), both against float64, repeat bit-equal; host ms,
     device us per GEMM launch, bound, plain and library ms. Row 17 runs
     once per unrolled step on every periodic gradient (5a, 10a, 16a on
     the card, 5b, 10c, 16c) and 0 times elsewhere; row 16 once per M^-1 r of the
     channel_mm loops (7b-c, 8b, 11, 15c's channel_mm run) as the loop
     counters derive, 0 elsewhere (asserted);
  2p. the hand-written GEMM under rows 4, 10d-mm, 16, 16-3d, 15g and 18d
     (csrc/gemm.cuh), on a shape of each tile configuration its plan takes
     and with each epilogue: bit-equal to the fmaf chain in k order
     (`pcg2.gemm_plain`, emulated exactly in float64) in every
     configuration, repeat bit-equal; the plan's choice, device us;
  3. a small-input check: 3 steps at 64^2 on the card against the plain
     path on the CPU;
  4. the main path: 2-D periodic decaying turbulence at 512^2 (viscosity
     1e-4, dt = 0.4/512, advection tol 1e-6, pressure tol 1e-8, fft_mm
     preconditioner, warm-started pressure increments) — 10 warm-up steps,
     then 200 timed steps with every kernel launch counter reset to 0 just
     before them; asserts finite state, warn fraction 0 and each counter at
     calls-per-step x 200;
  5. the gradient path: (a) a 3-step rollout gradient at 128^2 with the
     main path's viscosity and tolerances, where the pressure-adjoint gate
     zeroes most adjoints, on the card against the plain path on the CPU:
     the same gate decision for every adjoint solve and relative l2 <=
     1e-3; (b) grad30,
     the 30-step unrolled gradient of sum v^2 with respect to a forcing
     field from the state phase 4 leaves, under the "outputs" remat
     protocol: one untimed evaluation, then 3 timed ones, each with every
     counter reset to 0 before it and checked after it (the momentum solve
     2 x 30, the pressure solve 4 x 30, every other kernel at the count
     derived below), warn fraction 0, finite non-zero gradient; the gated
     adjoint solves and how far their residuals lie from the gate's limit
     are reported;
  6. the lid-driven cavity (the JAX package's `bench.py workload_cavity`:
     `lid_driven_cavity_setup`, viscosity 1e-3, dt = 0.2/n, advection and
     pressure tol 1e-6, dct_mm preconditioner): (a) at 64^2, 3 steps and
     then the 3-step rollout gradient on the card against the plain path
     on the CPU (equal iteration counts and gate decisions, gradient
     relative l2 <= 1e-3); (b) at 512 from rest, a 2000-step spin-up, then
     200 timed forward steps with every counter reset before them
     (counters at calls-per-step x 200, warn fraction 0, no BiCGSTAB
     fallback, finite state, max |div v| on active cells reported); (c)
     grad30 from the developed state, 1 untimed and 3 timed evaluations
     with the counters checked per evaluation and equal in all four (a
     momentum adjoint whose jac2 misses its tol hands over to BiCGSTAB, as
     in the JAX package on the TPU: its iterations launch the three phase
     kernels per component, its entry and exit residuals the fused stencil
     residual, row 14; such fallbacks are reported), warn 0, finite
     non-zero gradient, the gated adjoints
     reported with residual / limit;
  7. the spatial mixing layer (the JAX package's `bench.py workload_dns`:
     `spatial_mixing_layer_setup`, max iterations (200, 2000), dt = 0.2 x
     128 / ny, tol 1e-6, channel_mm, the inflow perturbation recomputed on
     the card every step at bench's float32 time t0 + i dt, the pressure
     increments carried as guesses within each 100-step call): (a) at 32 x 128, 5 steps and then the 3-step
     rollout gradient on the card against the plain path on the CPU
     (equal pressure iteration counts and gate decisions, gradient
     relative l2 <= 1e-3); (b) at 128 x 512 from its initial state, the
     400-step spin-up, then 400 timed forward steps with every counter
     reset before them (the PCG phase kernels and any BiCGSTAB hand-over at
     the counts the solver loops' own counters derive, the other kernels
     at calls per step x 400, 0 launches of pcg2, the uniform-mask assembly
     and the corrector bridge / tail, warn 0, finite state, max |div v| on
     active cells reported); (c) grad30 from that state with the Dirichlet
     values frozen at the last forward call's time, 1 untimed and 3 timed
     evaluations, counts checked per evaluation and equal in all four,
     warn 0, finite non-zero gradient, gated adjoints reported with
     residual / limit. The turbulence and cavity paths assert 0 launches
     of the PCG phase kernels (they take pcg2);
  2d. the batch-folded jac2 kernel at the batch-8 training shapes (64 x
     256, 8 frames of a network-free run, the predictor's right-hand
     sides), forward and transposed, shared and per-sample tolerances and
     the schedule's edges: bit-equal x and exit residuals and equal
     per-sample sweeps against its plain version and against 8
     single-sample jac2 kernels, and the kernel launches the schedule
     derives;
  2e. the batch-1 training path's single-sample kernels at its own shapes
     (pressure 64 x 256, faces 65 x 256 and 64 x 257), on a step of the
     training setup 20 steps into its run: the checks of 2c plus the
     bounded FV trio forward and VJP and the BiCGSTAB phases;
  8. closure training at batch 1 (the JAX package's `bench.py
     workload_training`: the mixing layer at 64 x 256, dt 0.4, the CNN at
     its published widths, a 10-step unroll, four losses, Adam 1e-5, tol
     1e-6, remat "outputs"): (a) the CNN alone at 64 x 256, forward and
     VJP within rel l2 1e-5 of float64 on the CPU with cuDNN's TF32 switch
     as PyTorch leaves it (this script never sets it); then 32 x 128 x 3
     steps at tol 1e-7, card vs the CPU: loss within rtol 1e-4, weight
     gradient rel l2 <= 1e-3, equal warn and gate decisions; (b) 1 untimed and 5 timed train steps with
     the counters checked (jac2 and the Laplace assembly 20 per step, the
     PCG and BiCGSTAB phases as the loops derive, the periodic kernels and
     the fold 0), no skipped update, then the chunked loop (chunk 10);
  9. closure training at batch 8 (remat "none"): (a) 8 distinct samples
     at tol 1e-7, the batched step vs 8 batch-1 runs (per-sample loss
     within rtol 1e-4, masked-mean weight gradient rel l2 <= 1e-3); (b) 8
     copies of the sample as bench.py stacks them, 1 untimed and 5 timed
     train steps: fold kernel launches equal to what the solver's counters
     derive (per solve `jacobi2.solve_launches` of the slowest sample's
     sweeps), every single-sample kernel 0;
  2f. the large tier's two kernels (bench.py's turb_1024 and dns_512x2048
     rows, where the JAX package's size tiers switch: solvers/tiers.py) at
     1024^2 on the operators of the turbulence run's first step: jac1
     forward and transposed on both components (equal sweeps, x within rel
     1e-6) and the PCG update with M^-1 folded in, on the loop's first
     call and on a mid-loop call (p' within rel 1e-6 of its scale, rz'
     within rel 1e-5); rows 10a and 10b (the PCG residual and apply,
     4096 blocks: csrc/pcgphases.cu's ticket exchange, 8 virtual blocks a
     block) with deflation off and on against their plain versions (as 2c)
     and bit-equal to their exact versions, one kernel a call, on that
     1024^2 system and on the DNS's 512 x 2048 pressure system; then jac1
     on the 512 x 2048 mixing layer's faces (513 x 2048, 512 x 2049) 20
     steps into its run;
  10. turbulence at 1024^2 (bench.py turb_1024: phase 4's configuration at
     n = 1024): (a) 2 steps and the 2-step rollout gradient on the card
     against the plain path on the CPU at full size, at phase 3's pressure
     tol 1e-7 (at 1e-8 a solve can stop within rounding of tol; equal pressure
     iterations, solver loop counters and adjoint gate decisions; velocity
     rtol 2e-4 / atol 2e-5; gradient rel l2 <= 1e-3); (b) 10 warm-up and
     200 timed forward steps, counters reset before them (jac1 twice per
     momentum solve, jac2 and pcg2 never, the folded update once per PCG
     loop, reset and iteration, the other kernels as phase 4's, warn 0);
     (c) grad30 ("outputs" remat, 1 untimed and 3 timed evaluations,
     counts checked per evaluation, gated adjoints reported);
  11. the 512 x 2048 mixing-layer DNS (bench.py dns_512x2048) with phase
     7b-c's protocol: the 400-step spin-up, 400 timed steps, grad30; jac1
     on the faces, the PCG phase kernels with the update (channel_mm
     takes no fold), the BiCGSTAB phases after a jac1 miss, jac2 and pcg2
     never. The earlier paths assert 0 launches of jac1 and the fold.
  2g. the 3-D path's four kernels at 128^3 on the operators of a step from
     the state after bench.py workload_turb3d's spin-up (2 calls of 50
     steps from a seeded 0.5 N(0, 1) state): the rank-3 advection
     assembly, div3 / grad3 forward and VJP, the 7-point matvec in both
     forms and its VJP (and on the pressure Laplacian; yardstick: one
     cuSPARSE CSR SpMV), the whole-solve 3-D Jacobi forward and transposed
     on all three components: elementwise volumes within rel 1e-6 of their
     scale (bit-equal by design; reported), the Jacobi bit-equal with
     equal sweeps;
  12. 3-D decaying turbulence (bench.py workload_turb3d: viscosity 1e-3,
     dt 0.4/n, tol 1e-6 / 1e-8, fft_mm on all three axes): (a) 32^3, 3
     steps and the 3-step rollout gradient (remat "none") on the card
     against the plain path on the CPU (equal pressure iterations, loop
     counters and gate decisions; velocity rtol 2e-4 / atol 2e-5;
     gradient rel l2 <= 1e-3); (b) at 128^3 from phase 2g's state, 3 timed
     calls of 50 steps (pressure guesses from zeros each call), counters
     reset before them: the assembly once per step, grad3 3 and div3 2 per
     step, the whole-solve Jacobi (2 + sweeps per component solve) and the
     7-point matvec (explicit_H's 3 per step, one per PCG operator apply,
     3 per BiCGSTAB apply) as the loops' counters derive, every 2-D kernel
     0; warn 0; steps/s, iterations, sweeps per solve, hand-overs and peak
     memory reported; (c) grad10 with remat "none" (1 untimed and 4 timed
     evaluations), counts checked per evaluation, gated adjoints reported.
     The earlier paths assert 0 launches of the 3-D kernels.
  13. the batched "auto" regime (the JAX package's `batched_safe_pallas()`
     trace of a vmapped step, from 512^2 per-sample planes: the
     grid-over-batch whole solves and the plane kernels with a batch axis;
     `make_batched_train_step`, `runs/ab_batched_512.py`): (a) on the
     operators of a step of (b)'s batch, the advection and Laplace
     assemblies, div2 / grad2 and the matvec (both forms) with a batch axis,
     bit-equal per sample to their single-sample launches; the joint Jacobi
     kernel (csrc/jacobi2_fold.cu) as the grid rule's counterpart at 512^2,
     B = 4, and on (e)'s 257 x 1024 / 256 x 1025 faces, B = 2 (forward /
     transposed, shared / per-sample tol), bit-equal to its plain version
     and per sample to the single-sample jac2 kernel with equal sweeps;
     pcg2 batched at 512^2, B = 4, on right-hand sides of O(dx) content,
     forward (shared tol) and cold adjoint (per-sample tols): equal
     iterations and x within rel 1e-4 of its plain
     version, bit-equal per sample to the single-sample pcg2 kernel
     (yardstick: one batched torch.bmm of the first contraction), and
     again on per-sample variable-coefficient Laplacians at per-sample tols
     where the samples must stop at different iterations; jac1
     batched at 1024^2, B = 2, bit-equal to its plain version and per sample
     to the single-sample jac1 kernel; the bounded FV trio (grad2m, div2m,
     gradT2m) with a batch axis on (e)'s planes, shared face masks,
     bit-equal per sample to the single-sample launches and to plain; (b) runs/ab_batched_512.py's forward
     (bench.py build_turbulence(512, 1e-6), seeds 0-3): 1 untimed and 3
     timed calls of 50 steps, sample-steps/s, per-sample pressure
     iterations, max |div v|, the launches the loops' counters derive, 0 of
     the corrector, the PCG and BiCGSTAB phases, the folded update and every
     single-sample whole solve; (c) grad10 of sum_c mean(v_c^2) over the
     batch with respect to the initial velocity (remat "none"), 1 untimed
     and 3 timed evaluations, peak memory, gated adjoints per sample; then
     batch 2 at 128^2 in "auto" card vs the CPU plain path (3 steps, the
     path's loss and sum_c sum(v_c^2), under which pressure adjoints gate:
     equal gate decisions, gradient rel l2 <= 1e-3); (d)
     batch 2 at 1024^2: 10 + 50 forward steps and grad5 (jac1 batched per
     component, the generic PCG loop; no pcg2, fold or folded update); (e)
     make_batched_train_step in "auto" at HRres 256 x 1024, B = 2 (bench.py
     workload_training's configuration, dt 0.4 x 64 / 256 = 0.1: bench's
     CFL; at dt 0.4 the solves fail and the state blows up): each sample's loss and weight
     gradient against the sample alone through make_train_step at tol 1e-7
     (phase 9a's bars: rtol 1e-4, rel l2 1e-3), then 1 untimed and 3 timed
     train steps, warn 0, the Adam count, the joint Jacobi kernel, the
     Laplace assembly, the matvec and the bounded FV trio as counted,
     nothing else.
  14. 3-D decaying turbulence past the whole-solve budget, where the
     momentum solve runs the trip loop of the JAX package's bicgstab (up
     to 8 trips of 4 sweeps per component while the largest entry
     residual is above tol): (a) 64^3 with the z-block tier forced (bz 16),
     3 steps and the 3-step rollout gradient under "outputs" remat, card
     vs the CPU plain path (12a's gates and hand-over allowance); 2h at
     256^3 (bench.py --n3d 256, the JAX gate's bz 8) on the operators of
     the first step after bench.py's spin-up (2 calls of 50 steps): the
     z-block kernel (15e) forward and transposed on all three components,
     the trip loop's first two calls, bit-equal to its plain version with
     equal per-block sweeps; (b) 3 timed calls of 50 forward steps (the
     assembly once, grad3 3 and div3 2 per step, the z-block kernel as the
     trip counters derive, jac13d and the plane kernel 0, warn 0; steps/s,
     trips, sweeps, hand-overs, peak memory); (c) grad10 under "outputs"
     remat, 1 untimed and 3 timed evaluations (the replay doubles the
     assembly, the FV pair and explicit_H, never a solve), counts checked
     per evaluation, gated adjoints reported; 2h at 512^3 (the plane tier:
     no z block of 4 or more fits) after one spin-up call of 20 steps: the
     plane kernel (15f) the same way, bit-equal; (d) bench.py's --n3d 512
     --fwd-only, cut for time to one timed call of 20 steps: the plane
     kernel as derived, the z-block kernel and jac13d 0, warn 0, peak
     memory. The earlier paths assert 0 launches of both.
  2i. (after phase 6) row 10d, the CG iteration, against its plain version
     on the 513 x 512 cavity's Laplacian in the reference's configuration
     (plain CG, one step from phase 6's state) with deflation on and off,
     and on phase 4's periodic 512^2 Laplacian: planes within 1e-6 of their
     scale, rnorm / p.q / alpha / beta within rel 1e-5 (the block sums run
     in another order); host ms, device us per launch, the bound, the plain
     version, one cuSPARSE SpMV of the same Laplacian; before it rows 10a
     and 10b on the cavity's system (1026 blocks: the ticket exchange, 2
     virtual blocks a block) as in 2f;
  15. the JAX package's default pressure solver (plain CG) and the function
     preconditioners: (a) the 64^2 cavity under CG, 5 steps and the 5-step
     gradient, card vs the CPU plain path (equal warn and gate decisions,
     iterations within 2, velocity rel l2 1e-4, gradient 1e-3); (b) path A,
     the 512 cavity under CG (bench.py build(512, 1e-6), preconditioner
     None) from phase 6's state: 200 forward steps (warn 0) and grad30
     ("outputs" remat, 1 untimed and 3 timed), the CG iteration once per
     iteration and the residual once per warm entry, reset and loop (from
     krylov.cg's counters), no pcg2 or PCG apply / update; (c) one step of
     fft, mg (64^2 turbulence), channel (32 x 128) and dct (64 cavity) card
     vs CPU, then 20 steps of fft and mg from phase 4's 512^2 state and of
     channel from phase 7's 128 x 512 state beside their _mm kinds, the PCG
     phases as the loop counters derive, fft and channel warn 0; (d) path
     B, examples/validate_ghia.py at its defaults (128^2, Re 1000, dct,
     dt 0.01, tol 3e-6, 10 000 steps): correlation > 0.999, rms < 0.06,
     |u_min + 0.338| < 0.02, the distance from the JAX TPU fixture. The
     earlier paths assert 0 launches of the CG iteration.
  2j. rows 8b (the k-sweep Jacobi, csrc/jacobi_sweeps.cu) and 14 (the
     fused stencil residual, csrc/stencil_residual.cu) on the operators of
     the first step of phase 16's 1024 x 2048 run: row 8b at k = 1 (the
     probe) and k = 4 (a trip from the probe's iterate), forward and
     transposed, both components, x_k and the norm bit-equal to the plain
     version, one launch a call; row 14 forward and transposed, negate
     and not, both components, bit-equal to the plain version and to the
     chain it replaces (row 7's matvec kernel, its negation, b - A x), and
     the same on the mixing layer's (129, 512) / (128, 513) faces at phase
     7's state; host ms, device us per launch, the bound, the plain
     version, row 14's cuSPARSE CSR addmm (b + M x).
  16. periodic decaying turbulence at 1024 x 2048 in a (2 pi, 4 pi) box
     (phase 10's configuration, square cells, dt = 0.4/1024), where the
     momentum solve takes the k-sweep tier (a k = 1 probe per component,
     then up to 8 trips of k = 4 while the largest norm after the sweeps is
     above tol; after a miss the fused BiCGSTAB with row 14 at its entry
     and exit) and the pressure solve the loop with M^-1 folded into the
     update at the 1024^2 / 2048^2 bases: (a) 32 x 64 with both tiers
     forced (`forced_sweeps`), 3 steps and the 3-step rollout gradient
     ("outputs" remat) on the card against the CPU plain path (equal warn
     and gate decisions, equal probe / trip / hand-over counts, the other
     loop counts reported, velocity rel l2 <= 1e-5, gradient rel l2 <=
     1e-3); (b) 10
     warm-up and 200 timed forward steps, counters reset before them (row
     8b = 2 x (2 probes + 5 trips), row 14 = 2 per entry or exit residual,
     jac1, jac2 and pcg2 0, the fold and the PCG phases as phase 10b
     derives them; warn 0, max |div v|, sweeps per solve, hand-overs);
     (c) grad30 under "outputs" remat, 1 untimed and 3 timed evaluations,
     counts checked per evaluation, gated adjoints and peak memory
     reported. Every earlier path asserts 0 launches of row 8b; row 14's
     launches follow each path's BiCGSTAB residual counters (its
     `launches` in the kernels line are the mixing layer's forward, where
     hand-overs occur).
  2k. row 13 (the masked advection assembly, csrc/advassembly_masked.cu,
     one launch for both components) bit-equal to its plain version at the
     512 cavity's faces (514 x 512 / 513 x 513, phase 6's state), the
     mixing layer's (phase 7's state at a scalar viscosity: a shape check,
     the mixing path itself assembles in the general body), the pipe's
     32 x 64 (x periodic) and, with a batch axis in "auto", 13e's 257 x
     1024 / 256 x 1025 planes x 2 (each sample equal to the single-sample
     kernel); 17b checks the Kármán shape (513 x 1536 / 512 x 1537) on its
     spun-up state; host ms, device us per launch, the bound, the plain
     version. Every earlier path asserts row 13's launches: once per
     assembly on the cavity paths (6b-c, 15b, 15d), 0 where row 1 takes the
     field or the viscosity is per face (the mixing layers, training, the
     DNS: the general body assembles there).
  17. the channel flows (examples/pipe.py, examples/karman_street.py, the
     temporal mixing layer): (a) card vs the CPU plain path at small sizes:
     the obstacle channel at 32 x 96 (3 steps, then the 3-step gradient of
     sum v^2 with respect to the initial velocity: rel l2 <= 1e-3, equal
     gate decisions), the temporal mixing layer at 32 x 32 (3 steps), the
     pipe at 16 x 16 (10 steps): every solve's order and warn, the momentum
     loop counters equal; pressure iterations equal (plain CG: within 2,
     reported); velocity rel l2 <= 1e-4; (b) the Kármán street at 512 x 1536
     (aspect 3, Re 200, tol 1e-5, caps 100 / 800, `channel`, dt 0.3/512,
     from u = 1): a 400-step spin-up, row 13 on its state (2k), then 2 timed
     calls of 200 steps: steps/s, peak memory, warn 0 on the timed steps
     (the spin-up's warned steps and solves reported), max |div v| over
     fluid cells, the obstacle's faces exactly 0, finite vorticity and the
     wake asymmetry, jac1 2 a step, the PCG phases as the loops derive,
     row 13 1 a step, row 1 and every bypassed kernel 0; (c) the pipe at 32
     x 64 for 3300 steps (steps x dt past 0.8 H^2 / nu; the example's
     float64 momentum solve, diffpiso_tpu_torch/examples/pipe.py):
     Poiseuille rel l2 < 0.05, x-invariance and |v| < 1e-5, warn 0,
     steps/s and CG iterations a step, its launches derived likewise.
  2n. rows 10e (the rank-3 residual, PCG apply and CG iteration,
     csrc/pcgphases3.cu) and 16-3d (the 3-D spectral apply, csrc/spectral3.cu:
     three passes of the hand-written GEMM, six launches) against their plain
     versions on real 3-D pressure systems: the 128^3 turbulence's (after
     2g's spin-up), the 256^3's (after 2h's) and the N = 128 cavity's
     (after 18b's spin-up), deflation off and on, x and p on a dyadic grid
     (exact sums, so the shift term agrees bit for bit): volumes within rel
     1e-6 of their scale plus what the measured alpha / beta differences
     carry (phase 2i's bar), the scalars reported with their relative
     error; row 10e bit-equal to its exact versions (`residual_exact`,
     `pcg_apply_exact`, `cg_iteration3_exact`: every sum in the kernels'
     order; the CG iteration over two chained calls, the sum of p formed
     and then carried), each call's kernels counted (residual 2, apply 3,
     CG iteration 3 carried / 4 formed, one more each deflating); row
     16-3d within rel l2 1e-5 of the six torch.matmuls and the
     divide (its library yardstick) on the loop's first residual (the
     dyadic iterate's residual, the worst-conditioned input, reported), the
     same bits on a repeat; on the
     turbulence systems one whole PCG solve forward (warm) and adjoint
     (cold) with the kernels against the plain versions on the card: equal
     iterations. Host ms, device us per launch, the bound (bytes: 10 / 12 /
     13 volumes; operations for 16-3d), the plain version's ms and the
     library's (a cuSPARSE CSR SpMV of the 7-point operator for row 10e's
     matvec part). Phases 12 and 14 assert rows 10e (residual: warm entries
     + resets + loops; apply and the volume update, row 10c: iterations)
     and 16-3d (loops + resets + iterations) from the loops' counters, and
     row 10e's kernels (every 3-D pressure solve deflates: 3 a residual, 4
     an apply, 4 a CG iteration and one more a CG loop and reset); the
     7-point matvec then runs only BiCGSTAB's applies and explicit_H.
  18. the bounded 3-D lid-driven cavity (the JAX package's tests/test_3d.py
     configuration: (N + 1, N, N) cells, axes (y, x, z), box (1 + 1/N, 1,
     1), OPEN, rank-deficient, `dct` forward and adjoint, deflating, max
     iterations 200 / 800, tol 1e-6 / 1e-6) at viscosity 1e-3 (Re 1000) and
     dt 0.2 / N: (a) N = 16, 5 steps under `dct` and under plain CG and the
     3-step rollout gradient under `dct`, card vs the CPU plain path
     (velocity rtol 2e-4 / atol 2e-5, pressure iterations equal under
     `dct` and within 2 a solve under CG, warn 0, equal gate decisions,
     gradient rel l2 <= 1e-3, a momentum hand-over may differ within 8 ulps
     of tol, as 12a); (b) N = 128: the momentum solves in the z-block tier
     (bz 26 / 43 / 43), a 400-step spin-up from rest, 2n on its pressure
     system, 2 timed calls of 100 steps: steps/s, pressure iterations a
     step, trips and sweeps, max |div v| over fluid cells, peak memory;
     warn 0, u > 0 in the first fluid row below the lid at mid-span, rows
     10e and 15e as the loops derive, row 16-3d and the periodic-only
     kernels (15a, 15b, 6, 17) 0; (c) the same state under plain CG, 20
     steps (CG iterations a step, row 10e's CG iteration once per
     iteration, warn as the solver reports it) and a 2-step rollout
     gradient (its gated adjoints). Every 2-D path asserts 0 launches of
     rows 10e and 16-3d.
  2o. (inside 2n, on the 128^3 and 256^3 turbulence systems) row 15g, the
     whole-solve rank-3 PCG (csrc/pcg3.cu around row 16-3d's apply,
     solvers/pcg3.py): each launch (the warm entry's residual, q, xr, r.z,
     p) against its plain twin on the card, x and p on the dyadic grid:
     volumes bit-equal, the norms equal, p.q and r.z within rel 1.2e-6,
     the sums within 1.2e-6 of their terms' magnitudes (M^-1 r is row
     16-3d, which 2n checks); host ms, device us per launch, the bound,
     the twin's and the library's ms (a cuSPARSE SpMV for the stencil
     launches, torch.dot); whole solves in the adjoint form, cold,
     warm from zeros and warm from half the increment, the kernels against
     the twins on the card: equal iterations. 2n's own adjoint-form solve
     keeps the per-iteration loop (`whole_solve_closed`).
  19. the adjoint warm-start channels (core/piso.py `adjoint_channels`,
     the JAX package's `solve_*_ws`), with which every 3-D adjoint pressure
     solve enters row 15g warm: (a) after phase 12, 32^3 card vs the CPU
     plain path, 3 steps and grad10 with the channels (12a's bars and
     records; every pressure adjoint a warm whole solve); (b) in phase 12c
     and (c) in 14c, grad10 at 128^3 ("none") and 256^3 ("outputs") from
     their states without and then with the channels: warn, gate counts,
     adjoint iterations and row 15g's launches per evaluation, every 15g
     launch > 0 (the residual only with the channels), 0 on every forward
     path, the gradient with the channels within rel l2 1e-3 of the one
     without; (d) after phase 5b, grad30 at 512^2 from phase 4's state
     without and with the channels (runs/ab_adjoint_ws.py: no remat): warn
     0, no rank-3 launch, the gradients compared where every gate decision
     is equal (both decision lists printed otherwise). Phases 12c and 14c
     run every pressure adjoint as a cold whole solve of row 15g; rows 10e,
     10c and 16-3d keep the forward solves and the exit check.
  20. the per-shard solvers (rows 18a-18d, parallel/kernels.py) on the
     one-card (1,1) mesh with forced slivers (the JAX package's
     DIFFPISO_SHARD_FORCE_SLIVERS=1 proxy of the multi-device program):
     (a) each kernel against its plain twin on a 512^2 step's operators
     from phase 4's state (18a-18c bit-equal volumes, 18d's update within
     a stated relative limit from the warm guess and from a cold start),
     host ms, device us, bound, twin ms; (e) 64^2 card vs CPU, 3 steps and
     the 3-step gradient (adjoint="auto"), every solve's trips and
     iterations equal (or a named exception within rounding of tol); (b)
     200 forward steps from phase 4's state: rows 18a-18c at the counts
     the sharded solvers' counters derive, 18d and rows 1-17 at 0, warn 0,
     the velocity within rel 1e-3 of the single-device path's; (c) grad30
     under adjoint="auto" within rel l2 5e-3 of the single-device grad30,
     transposed 18a calls > 0; (d) 20 steps with the whole tier forced, 18d
     once per tier trip. Every earlier path launches none of 18a-18d.
Then one {"kernels": [...]} line, and last the {"ok": true, ...} line.

Exits non-zero, printing no result, without a CUDA device or without the
package next to it.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

N = 512
VISCOSITY = 1e-4
ADV_TOL = 1e-6
P_TOL = 1e-8
WARMUP_STEPS = 10
TIMED_STEPS = 200
UNROLL = 30
GRAD_REPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# fragments of the names of this repository's kernels (csrc/*.cu)
OWN_KERNELS = ("advassembly", "corrector", "fv2", "jac2", "laplace_assembly", "dp_sum_partials",
               "matvec_kernel", "pcg2", "bicg_", "pcgp_", "dp_sgemm", "pcgmm_",
               "fv3_", "matvec3_kernel", "j1_", "j13_", "jm_kernel", "zb_", "pl3_", "cg_", "jsw_",
               "sres_", "advm_", "corrbwd_", "p3_", "g3_", "shm_", "shp_", "shw_")


def device_time(fn, reps: int = 20) -> dict:
    """A placeholder for the device time of `fn`, measured by
    `measure_device_times` after every timed path has run (a profiler
    session may leave tracing hooks that slow the host afterwards)."""
    return {"_device_time": (fn, reps)}


def library_device_time(fn, reps: int = 20) -> dict:
    """`device_time` of a library call (the yardstick of `library_ms`):
    every kernel it launches counts, under the keys library_device_*."""
    return {"_library_device_time": (fn, reps)}


def measure_device_times(entries) -> None:
    """Replace each placeholder of `device_time` / `library_device_time`
    in the entries (and their nested dicts) by its measurement."""
    for entry in entries:
        for sub in [entry] + [v for v in entry.values() if isinstance(v, dict)]:
            if "_device_time" in sub:
                sub.update(profile_device(*sub.pop("_device_time")))
            if "_library_device_time" in sub:
                got = profile_device(*sub.pop("_library_device_time"), own=False)
                sub.update({f"library_{k}": v for k, v in got.items()})


def profile_device(fn, reps: int, own: bool = True, tries: int = 3) -> dict:
    """Device time of `fn` under torch.profiler: the kernels of this
    repository it launches per call (every kernel unless `own`), their mean
    device time per launch and their device time per call (microseconds).
    The host-clock `ms` of a call beside it includes the wrapper's own
    cost. A session that saw no kernel at all is run again, up to `tries`
    times: the profiler drops events in this long process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and (not own or any(k in e.name for k in OWN_KERNELS))]
        if evs:
            break
    total_us = sum(e.time_range.elapsed_us() for e in evs)
    return dict(device_launches_per_call=len(evs) / reps,
                device_us_per_launch=total_us / len(evs) if evs else None,
                device_us_per_call=total_us / reps)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CAV_N = 512
CAV_TOL = 1e-6
CAV_SPINUP = 2000
CAV_STEPS = 200
CAV_SMALL = 64
BICG_PHASES = ("bicg_phase_p", "bicg_phase_s", "bicg_phase_x")
# kernels only the bounded cavity runs; their `launches` come from its paths
# (those only its grad30 launches, from that)
CAVITY_KERNELS = ("grad2m", "div2m", "gradT2m", "stencil_matvec") + BICG_PHASES
CAVITY_GRAD_KERNELS = ("gradT2m",) + BICG_PHASES


def lazy_call(make, call):
    """fn() = call(make()), make() run once, at the first call: a large
    yardstick operand (a 3-D CSR matrix) is built when its device time is
    measured, at the end, and not held until then."""
    box = []

    def fn():
        if not box:
            box.append(make())
        return call(box[0])

    return fn


def csr_of_stencil(c, ly, hy, lx, hx):
    """The 5-point stencil (roll wrap) as one CSR matrix, for the library
    yardstick of the matvec (cuSPARSE SpMV); built once, outside timing."""
    import torch

    ny, nx = c.shape
    idx = torch.arange(ny * nx, device=c.device).reshape(ny, nx)
    cols = [idx, torch.roll(idx, 1, 0), torch.roll(idx, -1, 0), torch.roll(idx, 1, 1),
            torch.roll(idx, -1, 1)]
    rows = torch.cat([idx.reshape(-1)] * 5)
    coo = torch.sparse_coo_tensor(torch.stack([rows, torch.cat([k.reshape(-1) for k in cols])]),
                                  torch.cat([a.reshape(-1) for a in (c, ly, hy, lx, hx)]),
                                  (ny * nx, ny * nx)).coalesce()
    return coo.to_sparse_csr()


def bicg_second_iteration(st_c, invd, b, transpose) -> dict:
    """The arguments of each BiCGSTAB phase in the second iteration of the
    loop on one component, A = -M (or -M^T), from x0 = 0: one iteration of
    the plain phases, then the next one's inputs, each phase's from the
    plain outputs of the one before."""
    import torch

    from diffpiso_tpu_torch.solvers import bicg

    r = rhat = b
    x = p = v = torch.zeros_like(b)
    one = torch.ones((), device=b.device)
    rho, rho_new, alpha, omega = one, torch.sum(b * b), one, one
    for _ in range(2):
        beta = (rho_new / rho) * (alpha / omega)
        args = {"p": (st_c, invd, r, p, v, rhat, beta, omega, -1.0, transpose)}
        p, v, d = bicg.bicg_phase_p_plain(*args["p"])
        alpha = rho_new / d
        args["s"] = (st_c, invd, r, v, alpha, -1.0, transpose)
        s, t, tt, ts = bicg.bicg_phase_s_plain(*args["s"])
        omega = ts / tt
        args["x"] = (invd, p, s, t, x, rhat, alpha, omega)
        x, r, _, rho_next = bicg.bicg_phase_x_plain(*args["x"])
        rho, rho_new = rho_new, rho_next
    return args


def fv_trio_check(label, fs, per, rep, p1, vs, masks) -> tuple:
    """The bounded FV trio (grad2m, div2m, gradT2m) against their plain
    versions on a pressure plane and a face pair: forward, and each VJP
    against the plain transpose; fails beyond 1e-6 x the planes' scale.
    Returns the max abs errors (grad2m, div2m, gradT2m)."""
    import torch

    from diffpiso_tpu_torch.ops import fv2m

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    nfs = (-fs[0], -fs[1])
    g_err = max(maxerr(zip(fv2m.grad2m(fs, per, rep, p1, masks),
                           fv2m.grad2m_plain(fs, per, rep, p1, masks))),
                maxerr([(vjp(lambda a: fv2m.grad2m(fs, per, rep, a, masks), (p1,), vs)[0],
                         fv2m.gradT2m_plain(fs, per, rep, vs, masks))]))
    d_err = max(maxerr([(fv2m.div2m(fs, per, vs), fv2m.div2m_plain(fs, per, vs))]),
                maxerr(zip(vjp(lambda a, b: fv2m.div2m(fs, per, (a, b)), vs, p1),
                           fv2m.grad2m_plain(nfs, per, fv2m.NO_REP, p1))))
    t_err = maxerr([(fv2m.gradT2m(fs, per, rep, vs, masks),
                     fv2m.gradT2m_plain(fs, per, rep, vs, masks))])
    scale = max(float(vs[0].abs().max()), float(vs[1].abs().max()),
                float(p1.abs().max())) * max(fs)
    print(f"{label} FV trio vs plain at {tuple(p1.shape)} (forward and VJP): max abs err grad2m "
          f"{g_err:.3e}, div2m {d_err:.3e}, gradT2m {t_err:.3e} (planes up to {scale:.3e})",
          flush=True)
    if not max(g_err, d_err, t_err) <= 1e-6 * scale:
        fail(f"{label} FV trio: kernel vs plain beyond 1e-6 x scale")
    return g_err, d_err, t_err


def bicg_phases_check(label, st, velocity) -> tuple:
    """The three BiCGSTAB phases against their plain versions on a step's
    momentum operator, both components and both forms, with the inputs of
    the loop's second iteration (p and v nonzero) on the cotangent a
    grad30's last adjoint solves see (2 v): planes bit-equal, scalars
    within rel 1e-5. Returns (planes max abs err, scalars max rel err, the
    inputs by (component, transpose))."""
    import torch

    from diffpiso_tpu_torch.solvers import bicg

    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    ph_err, ph_scalar_rel, ph_inputs = 0.0, 0.0, {}
    for c in range(2):
        invd = torch.where(st.center[c].abs() > 1e-30, 1.0 / -st.center[c], 1.0)
        rhs_c = 2.0 * velocity[c]
        for tr in (True, False):
            args = bicg_second_iteration(st_cs[c], invd, rhs_c, tr)
            ph_inputs[(c, tr)] = args
            for kern, plain, a in ((bicg.fused_bicg_phase_p, bicg.bicg_phase_p_plain, args["p"]),
                                   (bicg.fused_bicg_phase_s, bicg.bicg_phase_s_plain, args["s"]),
                                   (bicg.fused_bicg_phase_x, bicg.bicg_phase_x_plain, args["x"])):
                got, want = kern(*a), plain(*a)
                ph_err = max(ph_err, *(float((g - w).abs().max())
                                       for g, w in zip(got[:2], want[:2])))
                ph_scalar_rel = max(ph_scalar_rel, *(float((g - w).abs() / w.abs().clamp_min(1e-30))
                                                     for g, w in zip(got[2:], want[2:])))
    print(f"{label} BiCGSTAB phases vs plain on faces {tuple(velocity[0].shape)} / "
          f"{tuple(velocity[1].shape)} (both forms): planes max abs err {ph_err:.3e}, scalars max "
          f"rel err {ph_scalar_rel:.3e}", flush=True)
    if not (ph_err == 0.0 and ph_scalar_rel <= 1e-5):
        fail(f"{label} BiCGSTAB phases: planes not bit-equal or scalars beyond rel 1e-5")
    return ph_err, ph_scalar_rel, ph_inputs


def cavity_kernels(dev, kernels: list) -> dict:
    """Phase 2b: the cavity path's kernels against their plain versions at
    the 512 cavity's shapes, on the planes of a step 20 steps from rest.
    Appends the entries of the bounded FV trio, the matvec and the BiCGSTAB
    phases to `kernels` and returns the cavity measurements of jac2, pcg2 and the Laplace
    assembly, keyed by their entry names."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.ops import fv, fv2m, matvec
    from diffpiso_tpu_torch.ops.laplace import laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.solvers import bicg
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, pcg2_plain

    domain, sim, dt = lid_driven_cavity_setup(CAV_N, device=dev)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for _ in range(20):
        o = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                      advection_tol=CAV_TOL, pressure_tol=CAV_TOL, full_output=True)
        if o.warn:
            fail("cavity: a solve warned in the steps that make phase 2b's planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = o.intermediates
    st, lap = it["stencil"], it["laplacian"]
    vs0, vs1 = it["velocity_star"].components
    p1 = o.pressure_inc1
    ny, nx = p1.shape
    dx = domain.dx
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    per = (False, False)
    rep = tuple((lo != "zero", hi != "zero") for lo, hi in domain.pressure_pad_modes())
    masks = tuple(m.contiguous() for m in fv._face_masks(sim.accessible_mask, per, 2))
    cell = ny * nx * 4
    faces = (vs0.numel() + vs1.numel()) * 4

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    g_err, d_err, t_err = fv_trio_check("cavity", fs, per, rep, p1, (vs0, vs1), masks)
    n_faces = vs0.numel() + vs1.numel()
    for name, fn, plain, by, fl, err, line in (
        # grad2m: p and the two face masks in, two face planes out; 3 flops a face
        ("grad2m", lambda: fv2m.grad2m(fs, per, rep, p1, masks),
         lambda: fv2m.grad2m_plain(fs, per, rep, p1, masks), cell + 2 * faces, 3 * n_faces, g_err,
         376),
        # div2m: two face planes in, one cell plane out; 5 flops a cell
        ("div2m", lambda: fv2m.div2m(fs, per, (vs0, vs1)),
         lambda: fv2m.div2m_plain(fs, per, (vs0, vs1)), faces + cell, 5 * ny * nx, d_err, 333),
        # gradT2m: two cotangent and two mask planes in, one cell plane out; 7 flops a cell
        ("gradT2m", lambda: fv2m.gradT2m(fs, per, rep, (vs0, vs1), masks),
         lambda: fv2m.gradT2m_plain(fs, per, rep, (vs0, vs1), masks), 2 * faces + cell,
         7 * ny * nx, t_err, 417),
    ):
        b_, by_ = bound(by, fl)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2m.cu",
            replaces=f"diffpiso_tpu/ops/pallas_fv.py:{line}", max_abs_err=err,
            ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(plain, 50), **device_time(fn),
            bound_ms=b_, bound_by=by_, library_ms=None, shape=[ny, nx],
        ))

    # the matvec, both components and both forms, on explicit_H's input
    w = [a - b for a, b in zip(it["velocity_s2"].components, (vs0, vs1))]
    mv_err = 0.0
    for c in range(2):
        planes = (st.center[c], st.lo[c][0], st.hi[c][0], st.lo[c][1], st.hi[c][1])
        for tr in (False, True):
            mv_err = max(mv_err, maxerr([
                (matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                             (planes[2], planes[4]), w[c], tr),
                 matvec.matvec_plain(*planes, w[c], tr)),
                (vjp(lambda x: matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                                           (planes[2], planes[4]), x, tr),
                     (w[c],), w[c])[0], matvec.matvec_plain(*planes, w[c], not tr))]))
    mv_scale = max(float(x.abs().max()) for x in w) * max(float(a.abs().max()) for a in st.center)
    print(f"cavity stencil matvec vs plain (both components, both forms, forward and VJP): max "
          f"abs err {mv_err:.3e} (products up to {mv_scale:.3e})", flush=True)
    if not mv_err <= 1e-6 * mv_scale:
        fail("cavity stencil matvec: kernel vs plain beyond 1e-6 x scale")
    planes0 = (st.center[0], st.lo[0][0], st.hi[0][0], st.lo[0][1], st.hi[0][1])
    csr = csr_of_stencil(*planes0)
    spmv = csr @ w[0].reshape(-1, 1)
    lib_err = float((spmv.reshape(w[0].shape) - matvec.matvec_plain(*planes0, w[0])).abs().max())
    print(f"cuSPARSE SpMV yardstick vs plain matvec: max abs err {lib_err:.3e}", flush=True)
    x0f = w[0].reshape(-1, 1)

    def mv_k(tr=False):
        return matvec.fused_stencil_matvec(planes0[0], (planes0[1], planes0[3]),
                                           (planes0[2], planes0[4]), w[0], tr)

    b_mv, by_mv = bound(7 * w[0].numel() * 4, 9 * w[0].numel())
    kernels.append(dict(
        name="stencil_matvec", route="cuda", source="diffpiso_tpu_torch/csrc/matvec.cu",
        replaces="diffpiso_tpu/ops/pallas_stencil.py:188", max_abs_err=mv_err,
        ms=cuda_time_ms(mv_k, 200), ms_transposed=cuda_time_ms(lambda: mv_k(True), 200),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(*planes0, w[0]), 50),
        **device_time(mv_k), bound_ms=b_mv, bound_by=by_mv,
        library_ms=cuda_time_ms(lambda: csr @ x0f, 200),
        **library_device_time(lambda: csr @ x0f), shape=list(w[0].shape),
    ))

    # the BiCGSTAB phases on the step's momentum operator, both forms and
    # both face shapes, with the inputs of the loop's second iteration (p
    # and v nonzero) on the cotangent grad30's last adjoint solves (2 v)
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    ph_err, ph_scalar_rel, ph_inputs = bicg_phases_check("cavity", st, o.velocity.components)
    a = ph_inputs[(0, True)]  # grad30's form, on the 514 x 512 faces
    plane = a["x"][0].numel() * 4
    cells = a["x"][0].numel()
    # planes in + out and flops per cell: p 10 + 2, 17; s 8 + 2, 17; x 6 + 2, 12
    for name, kern, plain, args, planes, flops, line in (
        ("bicg_phase_p", bicg.fused_bicg_phase_p, bicg.bicg_phase_p_plain, a["p"], 12, 17, 456),
        ("bicg_phase_s", bicg.fused_bicg_phase_s, bicg.bicg_phase_s_plain, a["s"], 10, 17, 480),
        ("bicg_phase_x", bicg.fused_bicg_phase_x, bicg.bicg_phase_x_plain, a["x"], 8, 12, 502),
    ):
        b_, by_ = bound(planes * plane, flops * cells)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/bicg.cu",
            replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}", max_abs_err=ph_err,
            scalars_max_rel_err=ph_scalar_rel,
            ms=cuda_time_ms(lambda: kern(*args), 200), plain_ms=cuda_time_ms(lambda: plain(*args), 50),
            **device_time(lambda kern=kern, args=args: kern(*args)), bound_ms=b_, bound_by=by_,
            library_ms=None,
            shape=list(a["x"][0].shape),
        ))

    # jac2 on the step's momentum system, both forms
    b_c = tuple(it["rhs"].components)
    x_c = tuple(o.velocity.components)
    sweeps = jac2_edges("cavity", st_cs, b_c, x_c, CAV_TOL)
    k = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33)
    q = jacobi2_plain(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33)
    j_err = maxerr([(k[0], q[0]), (k[1], q[1])])
    # per component: 7 planes in and x out; per face 2 residual matvecs
    # (init, exit) of 11 flops and 13 per sweep, plus the inverse diagonal
    b_jac, by_jac = bound(8 * faces, n_faces * (2 + 22 + 13 * sweeps[False]))
    out = {"jacobi2_solve": dict(
        shapes=[list(vs0.shape), list(vs1.shape)], sweeps=sweeps[False], max_abs_err=j_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33), 50),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33), 10),
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33)),
        bound_ms=b_jac, bound_by=by_jac, library_ms=None)}

    # pcg2 on the first corrector's system, cold (as an adjoint) and warm
    mss, weights = pressure_preconditioner("dct_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    rhs = it["v1_div"]
    iters = {}
    p_err = 0.0
    for label, guess in (("cold", None), ("warm", g1 * 0.5)):
        kx, kr, kk = fused_pcg2_solve(lap, rhs, guess, v0, v0t, v1, v1t, sym, CAV_TOL, 600)
        px, pr, pk = pcg2_plain(lap, rhs, guess, v0, v1, sym, CAV_TOL, 600)
        rel = rel_err(kx, px)
        p_err = max(p_err, float((kx - px).abs().max()))
        print(f"cavity pcg2 ({label}): iterations kernel {kk} plain {pk}, residual kernel "
              f"{kr:.3e} plain {pr:.3e}, x rel err {rel:.3e}", flush=True)
        if kk != pk:
            fail(f"cavity pcg2 ({label}): iteration counts differ ({kk} vs {pk})")
        if not rel <= 1e-4:
            fail(f"cavity pcg2 ({label}): x rel err {rel:.3e} > 1e-4")
        iters[label] = kk
    kk = iters["cold"]
    b_pcg, by_pcg = bound(9 * cell + (ny * ny + nx * nx) * 4 * 2,
                          kk * (4.0 * ny * nx * (ny + nx) + 30 * ny * nx) + 24 * ny * nx)
    out["pcg2_solve"] = dict(
        shape=[ny, nx], iterations=iters, max_abs_err=p_err,
        ms=cuda_time_ms(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, CAV_TOL,
                                                 600), 20),
        plain_ms=cuda_time_ms(lambda: pcg2_plain(lap, rhs, None, v0, v1, sym, CAV_TOL, 600), 5),
        **device_time(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, CAV_TOL,
                                               600), 5),
        bound_ms=b_pcg, bound_by=by_pcg, library_ms=cuda_time_ms(lambda: torch.matmul(v0, rhs), 200))

    # the Laplace assembly with the cavity's masks (bounded flags, 513 rows)
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / ((dx[0] * dx[1] / dt) - a) for a in st.diag_A]
    lmasks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, per, (ny, nx),
                                 torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], lmasks, per)
    p_lap = laplace_assembly_plain(influence[0], influence[1], lmasks, per)
    l_err = maxerr(zip(k_lap[:5], p_lap[:5]))
    l_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    s_rel = rel_err(k_lap[5], p_lap[5])
    print(f"cavity laplace assembly vs plain: planes max abs err {l_err:.3e}, sum|diag| rel err "
          f"{s_rel:.3e}", flush=True)
    if not (l_rel <= 1e-6 and s_rel <= 1e-5):
        fail("cavity laplace assembly: kernel vs plain beyond rel 1e-6 (planes) / 1e-5 (sum)")
    b_lap, by_lap = bound(faces + 8 * cell + 5 * cell + 4, 12 * ny * nx)
    out["laplace_assembly"] = dict(
        shape=[ny, nx], max_abs_err=l_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks, per),
                        200),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], lmasks,
                                                             per), 50),
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks, per)),
        bound_ms=b_lap, bound_by=by_lap, library_ms=None)
    return out


def cavity_step_fn(domain, sim, dt):
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=CAV_TOL, pressure_tol=CAV_TOL)

    return step


def cavity_small_check(dev) -> None:
    """Phase 6a: the 64^2 cavity, 3 steps from rest and then the 3-step
    rollout gradient from the CPU's state, on the card against the plain
    path on the CPU."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    cpu = torch.device("cpu")
    states, iters = {}, {}
    for d in (dev, cpu):
        domain, sim, dt = lid_driven_cavity_setup(CAV_SMALL, device=d)
        step = cavity_step_fn(domain, sim, dt)
        v, p = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
        g1 = g2 = torch.zeros_like(p)
        iters[d.type] = []
        for _ in range(3):
            o = step(v, p, g1, g2)
            if o.warn:
                fail(f"{CAV_SMALL}^2 cavity on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].append(o.p_iterations)
        states[d.type] = (v, p)
    err = max(float((a.cpu() - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(states["cuda"][0].components, states["cpu"][0].components))
    print(f"{CAV_SMALL}^2 cavity x 3 steps, card vs CPU plain path: pressure iterations card "
          f"{iters['cuda']} / CPU {iters['cpu']}, max(|d| - 2e-4|ref|) = {err:.3e}", flush=True)
    if iters["cuda"] != iters["cpu"]:
        fail(f"{CAV_SMALL}^2 cavity: pressure iteration counts differ card vs CPU")
    if not err <= 2e-5:
        fail(f"{CAV_SMALL}^2 cavity: card step disagrees with the CPU beyond rtol 2e-4, atol 2e-5")
    v_cpu, p_cpu = states["cpu"]
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, cpu):
        domain, sim, dt = lid_driven_cavity_setup(CAV_SMALL, device=d)
        v = StaggeredField(tuple(c.to(d) for c in v_cpu.components), periodic=(False, False))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
        r = rollout_loss_grad(cavity_step_fn(domain, sim, dt), v, p_cpu.to(d), f, 3)
        if r.warns:
            fail(f"{CAV_SMALL}^2 cavity rollout gradient on {d.type}: {r.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 4) for a in r.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(f"{CAV_SMALL}^2 cavity x 3-step rollout gradient, card vs CPU plain path: rel l2 "
          f"{g_rel:.3e}; gated adjoints card {sum(g for _, g in decisions['cuda'])} / CPU "
          f"{sum(g for _, g in decisions['cpu'])} of {len(decisions['cpu'])}; pressure adjoint "
          f"residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{CAV_SMALL}^2 cavity gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not g_rel <= 1e-3:
        fail(f"{CAV_SMALL}^2 cavity gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def cavity_path(dev, wrappers: dict) -> tuple:
    """Phases 6b and 6c: the 512 cavity from rest, the spin-up, 200 timed
    forward steps and grad30, every launch counter checked. `wrappers`
    maps each kernel's name to its wrapper (the holder of its counter).
    Returns (forward launches, grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.solvers import krylov

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    domain, sim, dt = lid_driven_cavity_setup(CAV_N, device=dev)
    step = cavity_step_fn(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)

    def advance(k):
        nonlocal v, p, g1, g2
        warns, iters = 0, [0, 0]
        for _ in range(k):
            o = step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            warns += int(o.warn)
            iters[0] += o.p_iterations[0]
            iters[1] += o.p_iterations[1]
        return warns, [i / k for i in iters]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spin_warns, spin_iters = advance(CAV_SPINUP)
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    print(f"cavity {CAV_N}: {CAV_SPINUP}-step spin-up in {spin_s:.1f} s, warned steps "
          f"{spin_warns}, pressure iterations per step {spin_iters}", flush=True)

    # -- 6b: the forward path
    reset()
    fb0 = krylov.bicgstab.fallbacks
    j0 = jac1_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns, iters = advance(CAV_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    j1 = jac1_snapshot()
    fallbacks = krylov.bicgstab.fallbacks - fb0
    STATES["cavity"] = (v, p, g1, g2)
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    active_int = sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, domain.dx) * active_int).abs().max())
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2 ({CAV_N + 1} x {CAV_N} cells, developed, "
                 f"{CAV_SPINUP}-step spin-up), forward",
        steps=CAV_STEPS, steps_per_sec=CAV_STEPS / elapsed, pressure_iters_per_step=iters,
        warn_fraction=warns / CAV_STEPS, spinup_warned_steps=spin_warns,
        bicgstab_fallbacks=fallbacks, max_abs_div_active=div, launches=fwd,
        row3_kernel_launches=j1[1] - j0[1],
    )), flush=True)
    if not finite:
        fail("cavity: non-finite state after the forward path")
    if warns:
        fail(f"cavity: warn fraction {warns / CAV_STEPS} (must be 0)")
    if fallbacks:
        fail(f"cavity: {fallbacks} BiCGSTAB fallbacks (must be 0)")
    # per step: the three pressure gradients, two divergences, explicit_H's
    # two matvecs, one momentum and two pressure solves, one Laplace
    # assembly, one masked advection assembly (row 13); the periodic
    # kernels (row 1 among them) stay off the bounded path
    per_step = {"grad2m": 3, "div2m": 2, "stencil_matvec": 2, "jacobi2_solve": 1,
                "pcg2_solve": 2, "laplace_assembly": 1, "advection_assembly_masked": 1}
    for k in fwd:
        if fwd[k] != per_step.get(k, 0) * CAV_STEPS:
            fail(f"cavity forward: {k} launched {fwd[k]} times, expected "
                 f"{per_step.get(k, 0) * CAV_STEPS}")
    jac1_schedule_check("cavity forward", j0, j1)

    # -- 6c: grad30 from the developed state. Per evaluation, U steps,
    # "outputs" remat (tests/test_torch_cavity.py derives the same counts on
    # the CPU): the forward and the replay run 3U grad2m, 2U div2m and 2U
    # matvecs each; the backward adds 2U grad2m (the div2m VJPs), 3U - 1
    # gradT2m (the initial pressure carries no gradient) and 2U transposed
    # matvecs; the solves run 2U (momentum) and 4U (pressure) times, the
    # Laplace assembly and the masked advection assembly 2U. A momentum solve whose jac2 misses its tol hands
    # over to BiCGSTAB, as the JAX package does on the TPU (the last step's
    # adjoint, on this state): each of its iterations launches the three
    # phase kernels once per component, and its residuals at entry and exit
    # the fused stencil residual once per component each (row 14; the
    # structured loop applies no matvec of its own). Every evaluation runs
    # from the same state, so every evaluation must count the same.
    U = UNROLL
    expected = {"grad2m": 8 * U, "div2m": 4 * U, "gradT2m": 3 * U - 1, "stencil_matvec": 6 * U,
                "jacobi2_solve": 2 * U, "pcg2_solve": 4 * U, "laplace_assembly": 2 * U,
                "advection_assembly_masked": 2 * U}
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False, False))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        wrappers["stencil_matvec"].launches_transposed = 0
        fb0, it0 = krylov.bicgstab.fallbacks, krylov.bicgstab.iterations
        ap0 = dict(krylov.bicgstab.applies)
        rs0 = dict(krylov.bicgstab.residuals)
        j0 = jac1_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        row3 = jac1_schedule_check("cavity grad30", j0, jac1_snapshot())
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg2_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            gated_ratios=[round(a.residual / a.limit, 4) for a in p_adj if a.gated],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            bicgstab_fallbacks=krylov.bicgstab.fallbacks - fb0,
            bicgstab_iterations=krylov.bicgstab.iterations - it0,
            bicgstab_applies={str(t): krylov.bicgstab.applies[t] - ap0[t] for t in (False, True)},
            bicgstab_residuals={str(t): krylov.bicgstab.residuals[t] - rs0[t]
                                for t in (False, True)},
            # (unrolled step, BiCGSTAB iterations, true residual) of each
            # momentum adjoint that needed BiCGSTAB iterations after jac2
            momentum_adjoints_past_jac2=[
                (k, a.iterations, a.residual)
                for k, a in enumerate(a for a in res.adjoints if a.system == "momentum")
                if a.iterations > 0],
            launches=counts, matvec_transposed=wrappers["stencil_matvec"].launches_transposed,
            row3_kernel_launches=row3,
        ))
        print(json.dumps(dict(cavity_grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"cavity grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"cavity grad30: |grad| = {gnorm} (must be finite and > 0)")
        e = evals[-1]
        applies, iters = e["bicgstab_applies"], e["bicgstab_iterations"]
        resid = e["bicgstab_residuals"]
        want = dict(expected, stencil_matvec=6 * U + 2 * (applies["False"] + applies["True"]),
                    stencil_residual=2 * (resid["False"] + resid["True"]),
                    **{k: 2 * iters for k in BICG_PHASES})
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"cavity grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        if e["matvec_transposed"] != 2 * U + 2 * applies["True"]:
            fail(f"cavity grad30: {e['matvec_transposed']} transposed matvecs, "
                 f"expected {2 * U + 2 * applies['True']}")
        same = ("launches", "bicgstab_fallbacks", "bicgstab_iterations", "bicgstab_applies",
                "bicgstab_residuals", "row3_kernel_launches")
        if any(e[k] != evals[0][k] for k in same):
            fail("cavity grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg2_iters_per_step=sum(e["adjoint_pcg2_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        bicgstab_fallbacks_per_eval=[e["bicgstab_fallbacks"] for e in evals],
        bicgstab_iterations_per_eval=[e["bicgstab_iterations"] for e in evals],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )), flush=True)
    return fwd, timed[-1]["launches"]


MIX_RES = (128, 512)  # bench.py workload_dns
MIX_SMALL = (32, 128)  # bench.py --quick
MIX_TOL = 1e-6
MIX_SPINUP = 400  # bench's 1 + 3 calls of 100 steps
MIX_STEPS = 400  # bench's 4 timed calls of 100 steps
MIX_CALL = 100
PCG_PHASES = ("pcg_residual", "pcg_apply", "pcg_update")
# kernels only the mixing layer runs; their `launches` come from its forward path
MIXING_KERNELS = PCG_PHASES


def mixing_setup(res, dev):
    from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup

    return spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.2 * 128 / res[0]},
                                      max_iterations=(200, 2000), device=dev)


def mixing_step_fn(setup, frozen=None):
    """The mixing layer's step as bench.py's DNS workload runs it: the inflow
    perturbation at time `tm` (or the `frozen` Dirichlet values) and
    warm-started pressure increments."""
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None, tm=None):
        dv = frozen if tm is None else setup.dirichlet_values(setup.perturbation(tm))
        return piso_step(v, p, setup.dt, setup.domain, setup.sim, dirichlet_values=dv,
                         forcing_term=f, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=MIX_TOL, pressure_tol=MIX_TOL)

    return step


def bench_t0(k: int, dt: float) -> float:
    """The host time bench.py passes to the call that runs step k: calls of
    MIX_CALL steps, t0 advanced by MIX_CALL dt (a Python float) per call."""
    t0 = 0.0
    for _ in range(k // MIX_CALL):
        t0 += MIX_CALL * dt
    return t0


def bench_time(k: int, dt: float):
    """Step k's perturbation time as bench.py computes it in its scan:
    float32 t0 + i dt."""
    import numpy as np

    return np.float32(np.float32(bench_t0(k, dt)) + np.float32(k % MIX_CALL) * np.float32(dt))


def loop_counters() -> dict:
    """The solver loops' own counters, from which the PCG phase kernels'
    and the BiCGSTAB hand-overs' launches follow."""
    from diffpiso_tpu_torch.solvers import krylov

    p, b = krylov.pcg, krylov.bicgstab
    return dict(pcg_loops=p.loops, pcg_warm_entries=p.warm_entries, pcg_resets=p.resets,
                pcg_iterations=p.iterations, bicgstab_fallbacks=b.fallbacks,
                bicgstab_iterations=b.iterations, applies=b.applies[False],
                applies_T=b.applies[True], residuals=b.residuals[False],
                residuals_T=b.residuals[True], jacobi_sweeps=b.jacobi_sweeps,
                jacobi_probes=b.jacobi_probes, jacobi_trips=b.jacobi_trips)


def derived_launches(c0: dict, c1: dict, fold: bool = False, spectral: bool = False) -> tuple:
    """(launches the loops derive, counter deltas): the PCG residual once per
    warm entry, reset and finished loop; apply once per iteration; the
    update once per iteration or, where M^-1 is folded into it (`fold`:
    the large tier), the folded update once per loop, reset and iteration;
    where the loop's M^-1 r is the fused spectral apply (`spectral`: the
    `channel_mm` preconditioner), row 16 once per loop, reset and iteration;
    the k-sweep tier's kernel (row 8b) one launch per component and probe
    and per component and trip (JAC_K <= its JSW_MAX_K); after a
    Jacobi miss, each BiCGSTAB phase once per component and iteration, the
    fused stencil residual (row 14) once per component and entry or exit
    residual, the matvec once per component and generic operator apply."""
    d = {k: c1[k] - c0[k] for k in c0}
    per_z = d["pcg_loops"] + d["pcg_resets"] + d["pcg_iterations"]
    update = {"pcg_mm_update": per_z} if fold else {"pcg_update": d["pcg_iterations"]}
    if spectral:
        update["spectral_apply"] = per_z
    return ({"pcg_residual": d["pcg_warm_entries"] + d["pcg_resets"] + d["pcg_loops"],
             "pcg_apply": d["pcg_iterations"], **update,
             "jacobi_sweeps": 2 * (d["jacobi_probes"] + d["jacobi_trips"]),
             "stencil_residual": 2 * (d["residuals"] + d["residuals_T"]),
             **{k: 2 * d["bicgstab_iterations"] for k in BICG_PHASES}}, d)


# kernels a call of row 10a or 10b launches (csrc/pcgphases.cu: one
# cooperative launch, every form)
PHASES2_CALL_KERNELS = 1


def phases2_counts() -> tuple:
    """Rows 10a and 10b's kernels launched so far (their wrappers'
    `kernel_launches`)."""
    from diffpiso_tpu_torch.solvers import pcgphases

    return pcgphases.fused_residual.kernel_launches, pcgphases.fused_pcg_apply.kernel_launches


def phases2_check(label: str, k0: tuple, d: dict, cg: bool = False) -> dict:
    """Rows 10a and 10b's kernels since `k0` against what the loops'
    counter deltas `d` derive: PHASES2_CALL_KERNELS a call, the residual
    once per warm entry, reset and loop (of the PCG loop, or of plain CG,
    `cg`), the apply once per PCG iteration (none under CG)."""
    got = tuple(a - b for a, b in zip(phases2_counts(), k0))
    pre = "cg" if cg else "pcg"
    want = ((d[f"{pre}_warm_entries"] + d[f"{pre}_resets"] + d[f"{pre}_loops"])
            * PHASES2_CALL_KERNELS, 0 if cg else d["pcg_iterations"] * PHASES2_CALL_KERNELS)
    print(f"{label}: rows 10a / 10b kernel launches {got} (expected {want})", flush=True)
    if got != want:
        fail(f"{label}: rows 10a / 10b launched {got} kernels, expected {want}")
    return {"pcg_residual": got[0], "pcg_apply": got[1]}


def summable(v, total: float):
    """`v` rounded to a grid of 2^-k with at most 2s steps a cell (s = 50,
    or less on planes past 2^17 cells), and its sum moved to the grid point
    nearest `total` (at most 11 more steps a cell): the plane then sums
    exactly in float32 in any order (every partial sum is under 2^24
    steps)."""
    import numpy as np
    import torch

    a = v.double().cpu().numpy()
    s = min(50.0, (2.0 ** 24 / a.size - 12) / 2)
    k = np.floor(np.log2(s / np.abs(a).max()))
    u = np.rint(a * 2.0 ** k)
    u -= np.rint(u.mean())
    n = u.size
    diff = int(np.clip(np.rint(total * 2.0 ** k), -10 * n, 10 * n) - u.sum())
    flat = u.reshape(-1)
    flat += diff // n
    flat[: diff % n] += 1
    return torch.as_tensor((u / 2.0 ** k).astype(np.float32), device=v.device)


def phases2_exact_check(label, lap, b, rz, x, r, p, deflate) -> None:
    """Phase 2c's bit-for-bit check of rows 10b and 10a against
    `pcgphases.pcg_apply_exact` / `residual_exact` (the plain arithmetic
    with every sum in the kernels' order): the apply with its sum x', then
    the residual of that x' with sum x formed and carried in (as the PCG
    loop's resets and exit take it); each call's kernels counted
    (PHASES2_CALL_KERNELS)."""
    import torch

    from diffpiso_tpu_torch.solvers import pcgphases as ph

    def held(what, pairs, k0, k1, want):
        bad = [k for k, (a, w) in pairs.items() if not torch.equal(a, w)]
        launched = k1 - k0
        print(f"{label} {what} deflate={deflate}: bit-equal to exact: {not bad}; kernels "
              f"{launched} (expected {want})", flush=True)
        if bad:
            fail(f"{label} {what} deflate={deflate}: {', '.join(bad)} not bit-equal to the "
                 "exact version")
        if launched != want:
            fail(f"{label} {what} deflate={deflate}: {launched} kernels, expected {want}")

    k0 = phases2_counts()
    ka = ph.fused_pcg_apply(lap, rz, x, r, p, deflate)
    k1 = phases2_counts()
    ea = ph.pcg_apply_exact(lap, rz, x, r, p, deflate)
    held("pcg_apply", {"x'": (ka[0], ea[0]), "r'": (ka[1], ea[1]), "rnorm": (ka[2], ea[2]),
                       "p.q": (ka[3], ea[3]), "sum x'": (ka[4], ea[4][ph.O_SUMX])},
         k0[1], k1[1], PHASES2_CALL_KERNELS)
    for carried in (False, True):
        k0 = phases2_counts()
        kr = ph.fused_residual(lap, b, ka[0], deflate, sum_x=ka[4] if carried else None)
        k1 = phases2_counts()
        er = ph.residual_exact(lap, b, ea[0], deflate,
                               sum_x=ea[4][ph.O_SUMX] if carried else None)
        held(f"pcg_residual (sum x {'carried' if carried else 'formed'})",
             {"r": (kr[0], er[0]), "rnorm": (kr[1], er[1])}, k0[0], k1[0],
             PHASES2_CALL_KERNELS)


def phases2_inputs(lap, b, x0, deflate):
    """The inputs of `phases2_system_check` on a path's pressure system:
    (x, r, p, rz), x the warm guess `x0`, r its residual (the plain
    version's), p = r (a first CG step), rz = r.p. Where the Laplacian
    carries a shift, x and p go on an exactly summable grid with shift
    sum(.) near the size of the rest (`summable`, as phase 2c's shifted
    checks), so both versions sum them exactly."""
    import torch

    from diffpiso_tpu_torch.solvers import pcgphases

    s_val = float(lap.shift)
    x = summable(x0, float(b.abs().max()) / s_val) if s_val else x0
    r = pcgphases.residual_plain(lap, b, x, deflate)[0]
    p = summable(r, float(pcgphases.lap_matvec(lap, r).abs().max()) / s_val) if s_val else r
    return x, r, p, torch.sum(r * p)


def phases2_system_check(label, lap, b, x0) -> None:
    """Rows 10a and 10b on a path's own pressure system, deflating and not
    (`phases2_inputs`): against the plain versions (planes within rel 1e-6
    of their scale, scalars within rel 1e-5, as phase 2c) and bit for bit
    against the exact versions with each call's kernels counted
    (`phases2_exact_check`). Planes past PCGP_GATHER_MAX (512) blocks take
    csrc/pcgphases.cu's ticket exchange with 2 or more virtual blocks a
    block, which the mixing and training planes of 2c / 2e do not reach."""
    from diffpiso_tpu_torch.solvers import pcgphases

    ny, nx = b.shape
    for deflate in (False, True):
        x, r, p, rz = phases2_inputs(lap, b, x0, deflate)
        for name, got, want, n_planes in (
                ("pcg_residual", pcgphases.fused_residual(lap, b, x, deflate),
                 pcgphases.residual_plain(lap, b, x, deflate), 1),
                ("pcg_apply", pcgphases.fused_pcg_apply(lap, rz, x, r, p, deflate)[:4],
                 pcgphases.pcg_apply_plain(lap, rz, x, r, p, deflate)[:4], 2)):
            e = max(float((a - w).abs().max()) for a, w in zip(got[:n_planes], want[:n_planes]))
            rel = e / max(max(float(w.abs().max()) for w in want[:n_planes]), 1e-30)
            srel = max(float((g - w).abs() / w.abs().clamp_min(1e-30))
                       for g, w in zip(got[n_planes:], want[n_planes:]))
            print(f"{label} {name} at {ny}x{nx} (deflate={deflate}) vs plain: planes max abs "
                  f"err {e:.3e} (rel to scale {rel:.3e}), scalars max rel err {srel:.3e}",
                  flush=True)
            if not (rel <= 1e-6 and srel <= 1e-5):
                fail(f"{label} {name} (deflate={deflate}): kernel vs plain beyond rel 1e-6 of "
                     "the planes' scale / rel 1e-5 (scalars)")
        phases2_exact_check(label, lap, b, rz, x, r, p, deflate)


def mixing_kernels(dev, kernels, setup, label: str) -> dict:
    """Phase 2c (the mixing layer's 128 x 512) and 2e (the batch-1
    training's 64 x 256): on the operators of a real step 20 steps into the
    setup's run, the three PCG phase kernels against their plain versions
    (deflate off and on, shift 0 and 0.1 sum|diag| / n), one whole
    per-iteration PCG solve forward (warm) and adjoint (cold) with the
    kernels against the plain phases on the card, the bounded FV trio
    forward and VJP, the three BiCGSTAB phases, the matvec on the u plane
    ((128, 513): the TPU's row-tiled case) in both forms, jac2 and the
    Laplace assembly with the mixing layer's masks. Appends the PCG phase
    kernels' entries to `kernels` (a list), or with `kernels` None returns
    them with the rest; returns the measurements at these shapes keyed by
    entry name."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.ops import fv, matvec
    from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.solvers import krylov, pcgphases
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply_plain
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain

    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    k = 0
    for k in range(20):
        o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
        if o.warn:
            fail(f"{label}: a solve warned in the steps that make the kernel checks' planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    o = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                  dirichlet_values=setup.dirichlet_values(setup.perturbation(
                      bench_time(k + 1, setup.dt))),
                  pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=MIX_TOL,
                  pressure_tol=MIX_TOL, full_output=True)
    it = o.intermediates
    st, lap = it["stencil"], it["laplacian"]
    rhs, guess = it["v1_div"], 0.5 * g1  # a warm start that has to iterate
    ny, nx = rhs.shape
    plane = ny * nx * 4
    if not float(lap.shift) == 0.0:
        fail(f"{label}: the Laplacian carries a shift (its system is full rank)")
    mss, weights = pressure_preconditioner("channel_mm", lap)
    (v0, _), (v1, _) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)

    def prec(r):
        return spectral_apply_plain(v0, v1, sym, r)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    def scale(planes):
        return max(float(b.abs().max()) for b in planes)

    shifted = LaplaceStencil(center=lap.center, lo=lap.lo, hi=lap.hi,
                             shift=0.1 * lap.center.abs().sum() / (ny * nx),
                             periodic=lap.periodic)
    errs = {k: 0.0 for k in PCG_PHASES}
    rels = {k: 0.0 for k in PCG_PHASES}
    inputs = {}
    # The shifted checks take x and p on an exactly summable grid, with
    # shift sum(.) near the size of L(.): on this full-rank Laplacian's own
    # iterates shift sum(x) outweighs b by ten orders (both float32 versions
    # then lie 2e-3 from float64), and on mean-free ones sum(x) is rounding
    # noise that the kernel and torch.sum take in different orders (measured
    # on the H100); on the grid both sum exactly, and the shift still acts.
    s_val = float(shifted.shift)
    for lab, L in (("shift 0", lap), ("shift > 0", shifted)):
        on_grid = L is shifted
        x0 = summable(guess, float(rhs.abs().max()) / s_val) if on_grid else guess
        for deflate in (False, True):
            kr = pcgphases.fused_residual(L, rhs, x0, deflate)
            pr = pcgphases.residual_plain(L, rhs, x0, deflate)
            r = pr[0]
            z = prec(r)
            if on_grid:
                z = summable(z, float(pcgphases.lap_matvec(lap, z).abs().max()) / s_val)
            rz = torch.sum(r * z)
            args_a = (L, rz, x0, r, z, deflate)
            # x', r', max|r'|, p.q (sum x' is held to its exact version below)
            ka = pcgphases.fused_pcg_apply(*args_a)[:4]
            pa = pcgphases.pcg_apply_plain(*args_a)[:4]
            phases2_exact_check(f"{label} ({lab})", L, rhs, rz, x0, r, z, deflate)
            args_u = (rz, pa[1], prec(pa[1]), z)
            ku, pu = pcgphases.fused_pcg_update(*args_u), pcgphases.pcg_update_plain(*args_u)
            if lab == "shift 0" and not deflate:  # the main path's arguments
                inputs = {"pcg_residual": (L, rhs, x0, deflate), "pcg_apply": args_a,
                          "pcg_update": args_u}
            for name, got, want, n_planes in (("pcg_residual", kr, pr, 1),
                                              ("pcg_apply", ka, pa, 2),
                                              ("pcg_update", ku, pu, 1)):
                e = maxerr(zip(got[:n_planes], want[:n_planes]))
                rel = e / max(scale(want[:n_planes]), 1e-30)
                srel = max(float((g - w).abs() / w.abs().clamp_min(1e-30))
                           for g, w in zip(got[n_planes:], want[n_planes:]))
                print(f"{label} {name} at {ny}x{nx} ({lab}, deflate={deflate}) vs plain: planes max abs err "
                      f"{e:.3e} (rel to scale {rel:.3e}), scalars max rel err {srel:.3e}",
                      flush=True)
                if not (rel <= 1e-6 and srel <= 1e-5):
                    fail(f"{label} {name} ({lab}, deflate={deflate}): kernel vs plain beyond "
                         f"rel 1e-6 of the planes' scale / rel 1e-5 (scalars)")
                errs[name] = max(errs[name], e)
                rels[name] = max(rels[name], srel)

    # one whole solve each way, the kernels against the plain phases on the card
    def solve(adjoint):
        b = 2.0 * rhs if adjoint else rhs
        return krylov.pcg(lap, b, None if adjoint else guess, precond_mm=(mss, weights),
                          tol=MIX_TOL * (max(1.0, float(b.abs().max())) if adjoint else 1.0),
                          max_iter=2000, residual_reset=0 if adjoint else 50,
                          precond_zero_mean=False, early_exit=not adjoint)

    names = ("fused_residual", "fused_pcg_apply", "fused_pcg_update")
    plains = (pcgphases.residual_plain, pcgphases.pcg_apply_plain, pcgphases.pcg_update_plain)
    solves = {}
    for how, adjoint in (("forward, warm", False), ("adjoint, cold", True)):
        res_k = solve(adjoint)
        saved = [getattr(krylov, nm) for nm in names]
        for nm, fn in zip(names, plains):
            setattr(krylov, nm, fn)
        try:
            res_p = solve(adjoint)
        finally:
            for nm, fn in zip(names, saved):
                setattr(krylov, nm, fn)
        rel = rel_err(res_k.x, res_p.x)
        print(f"{label} pressure PCG ({how}): iterations kernels {res_k.iterations} plain "
              f"{res_p.iterations}, residual kernels {res_k.residual_norm:.3e} plain "
              f"{res_p.residual_norm:.3e}, x rel err {rel:.3e}", flush=True)
        if res_k.iterations != res_p.iterations or res_k.iterations == 0:
            fail(f"{label} pressure PCG ({how}): iteration counts differ or are 0")
        if res_k.warn or not rel <= 1e-4:
            fail(f"{label} pressure PCG ({how}): warned or x rel err {rel:.3e} > 1e-4")
        solves[how] = res_k.iterations

    out = {}
    # the library yardsticks (the port never calls them), on the main path's
    # arguments: row 10a's b - A x as one cuSPARSE CSR addmm (without the
    # max), row 10b's q = A p as one CSR SpMV; the Laplacian carries no
    # shift here, so A is the 5-point stencil
    csr = csr_of_stencil(lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    rl, al = inputs["pcg_residual"], inputs["pcg_apply"]
    bcol, xcol, pcol = rl[1].reshape(-1, 1), rl[2].reshape(-1, 1), al[4].reshape(-1, 1)
    library = {
        "pcg_residual": (lambda: torch.addmm(bcol, csr, xcol, alpha=-1.0),
                         pcgphases.residual_plain(*rl)[0]),
        "pcg_apply": (lambda: csr @ pcol, pcgphases.lap_matvec(lap, al[4])),
    }
    # bytes per call of the phases (planes in + out): residual 5 + b, x in, r
    # out; apply 5 + x, r, p in, x', r' out; update r, z, p in, p' out.
    # flops per cell: residual 10, apply 15, update 4
    for name, fn, plain, planes, flops, line in (
        ("pcg_residual", pcgphases.fused_residual, pcgphases.residual_plain, 8, 10, 258),
        ("pcg_apply", pcgphases.fused_pcg_apply, pcgphases.pcg_apply_plain, 10, 15, 1542),
        ("pcg_update", pcgphases.fused_pcg_update, pcgphases.pcg_update_plain, 4, 4, 1579),
    ):
        a = inputs[name]
        b_, by_ = bound(planes * plane, flops * ny * nx)
        lib = dict(library_ms=None)
        if name in library:
            call, want = library[name]
            lib = dict(library_ms=cuda_time_ms(call, 50), **library_device_time(call),
                       library_rel_err=rel_err(call().reshape(want.shape), want))
        entry = dict(
            max_abs_err=errs[name], scalars_max_rel_err=rels[name],
            ms=cuda_time_ms(lambda fn=fn, a=a: fn(*a), 200),
            plain_ms=cuda_time_ms(lambda plain=plain, a=a: plain(*a), 50),
            **device_time(lambda fn=fn, a=a: fn(*a)), bound_ms=b_, bound_by=by_,
            shape=[ny, nx], solve_iterations=solves, **lib,
        )
        if kernels is None:
            out[name] = entry
        else:
            kernels.append(dict(
                name=name, route="cuda", source="diffpiso_tpu_torch/csrc/pcgphases.cu",
                replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}", **entry))

    # the bounded FV trio and the BiCGSTAB phases on the step's planes
    sim, dx = setup.sim, setup.domain.dx
    per = tuple(sim.bool_periodic)
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    rep = tuple((lo != "zero", hi != "zero") for lo, hi in setup.domain.pressure_pad_modes())
    fmasks = tuple(m.contiguous() for m in fv._face_masks(sim.accessible_mask, per, 2))
    vs = tuple(it["velocity_star"].components)
    trio_errs = fv_trio_check(label, fs, per, rep, o.pressure_inc1, vs, fmasks)
    for name, e in zip(("grad2m", "div2m", "gradT2m"), trio_errs):
        out[name] = dict(shape=[ny, nx], max_abs_err=e)
    ph_err, ph_rel, _ = bicg_phases_check(label, st, o.velocity.components)
    for name in BICG_PHASES:
        out[name] = dict(shapes=[list(c.shape) for c in vs], max_abs_err=ph_err,
                         scalars_max_rel_err=ph_rel)

    # the matvec on the u plane (ny, nx + 1), both forms, on explicit_H's input
    w = it["velocity_s2"].components[1] - it["velocity_star"].components[1]
    planes_u = (st.center[1], st.lo[1][0], st.hi[1][0], st.lo[1][1], st.hi[1][1])

    def mv_k(tr=False):
        return matvec.fused_stencil_matvec(planes_u[0], (planes_u[1], planes_u[3]),
                                           (planes_u[2], planes_u[4]), w, tr)

    mv_err = maxerr([(mv_k(tr), matvec.matvec_plain(*planes_u, w, tr)) for tr in (False, True)])
    print(f"{label} stencil matvec on the {tuple(w.shape)} u plane vs plain (both forms): max "
          f"abs err {mv_err:.3e}", flush=True)
    if mv_err != 0.0:
        fail(f"{label} stencil matvec: kernel vs plain not bit-equal on the {tuple(w.shape)} "
             f"plane")
    b_mv, by_mv = bound(7 * w.numel() * 4, 9 * w.numel())
    out["stencil_matvec"] = dict(
        shape=list(w.shape), max_abs_err=mv_err, ms=cuda_time_ms(mv_k, 200),
        ms_transposed=cuda_time_ms(lambda: mv_k(True), 200),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(*planes_u, w), 50),
        **device_time(mv_k), bound_ms=b_mv, bound_by=by_mv)

    # jac2 on the step's momentum system (faces (ny + 1, nx) and (ny, nx + 1)), both forms
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    b_c = tuple(it["rhs"].components)
    x_c = tuple(v.components)
    sweeps = jac2_edges(label, st_cs, b_c, x_c, MIX_TOL)
    kj = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33)
    pj = jacobi2_plain(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33)
    j_err = maxerr([(kj[0], pj[0]), (kj[1], pj[1])])
    faces = sum(c.numel() for c in b_c)
    b_jac, by_jac = bound(8 * faces * 4, faces * (2 + 22 + 13 * sweeps[False]))
    out["jacobi2_solve"] = dict(
        shapes=[list(c.shape) for c in b_c], sweeps=sweeps[False], max_abs_err=j_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33), 50),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33), 10),
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33)),
        bound_ms=b_jac, bound_by=by_jac)

    # the Laplace assembly with the mixing layer's masks (open outflow)
    beta = dx[0] * dx[1] / setup.dt
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / (beta - a) for a in st.diag_A]
    lmasks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, (False, False), (ny, nx),
                                 torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], lmasks, (False, False))
    p_lap = laplace_assembly_plain(influence[0], influence[1], lmasks, (False, False))
    l_err = maxerr(zip(k_lap[:5], p_lap[:5]))
    l_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    s_rel = rel_err(k_lap[5], p_lap[5])
    print(f"{label} laplace assembly vs plain: planes max abs err {l_err:.3e}, sum|diag| rel err "
          f"{s_rel:.3e}", flush=True)
    if not (l_rel <= 1e-6 and s_rel <= 1e-5):
        fail(f"{label} laplace assembly: kernel vs plain beyond rel 1e-6 (planes) / 1e-5 (sum)")
    b_lap, by_lap = bound(faces * 4 + 13 * plane + 4, 12 * ny * nx)
    out["laplace_assembly"] = dict(
        shape=[ny, nx], max_abs_err=l_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks,
                                                       (False, False)), 200),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], lmasks,
                                                             (False, False)), 50),
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks,
                                                     (False, False))),
        bound_ms=b_lap, bound_by=by_lap)
    return out


def mixing_small_check(dev) -> None:
    """Phase 7a: the mixing layer at bench's --quick size, 5 steps from its
    initial state and then the 3-step rollout gradient from the CPU's
    state (Dirichlet values frozen), on the card against the plain path on
    the CPU: equal pressure iteration counts, the velocity within rtol 2e-4
    / atol 2e-5, gradient relative l2 <= 1e-3, every adjoint's gate
    decision equal."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    cpu = torch.device("cpu")
    states, iters = {}, {}
    for d in (dev, cpu):
        setup = mixing_setup(MIX_SMALL, d)
        step = mixing_step_fn(setup)
        v, p = setup.initial_state()
        g1 = g2 = torch.zeros_like(p)
        iters[d.type] = []
        for k in range(5):
            o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
            if o.warn:
                fail(f"{MIX_SMALL} mixing layer on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].append(o.p_iterations)
        states[d.type] = (v, p)
    err = max(float((a.cpu() - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(states["cuda"][0].components, states["cpu"][0].components))
    print(f"{MIX_SMALL} mixing layer x 5 steps, card vs CPU plain path: pressure iterations card "
          f"{iters['cuda']} / CPU {iters['cpu']}, velocity max(|d| - 2e-4|ref|) = {err:.3e}",
          flush=True)
    if iters["cuda"] != iters["cpu"]:
        fail(f"{MIX_SMALL} mixing layer: pressure iteration counts differ card vs CPU")
    if not err <= 2e-5:
        fail(f"{MIX_SMALL} mixing layer: card velocity disagrees with the CPU beyond rtol 2e-4, "
             f"atol 2e-5")
    v_cpu, p_cpu = states["cpu"]
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, cpu):
        setup = mixing_setup(MIX_SMALL, d)
        frozen = setup.dirichlet_values(setup.perturbation(bench_time(5, setup.dt)))
        v = StaggeredField(tuple(c.to(d) for c in v_cpu.components), periodic=(False, False))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
        r = rollout_loss_grad(mixing_step_fn(setup, frozen), v, p_cpu.to(d), f, 3)
        if r.warns:
            fail(f"{MIX_SMALL} mixing rollout gradient on {d.type}: {r.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 4) for a in r.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(f"{MIX_SMALL} mixing layer x 3-step rollout gradient, card vs CPU plain path: rel l2 "
          f"{g_rel:.3e}; gated adjoints card {sum(g for _, g in decisions['cuda'])} / CPU "
          f"{sum(g for _, g in decisions['cpu'])} of {len(decisions['cpu'])}; pressure adjoint "
          f"residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{MIX_SMALL} mixing gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not g_rel <= 1e-3:
        fail(f"{MIX_SMALL} mixing gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def jac1_snapshot() -> tuple:
    """The whole-solve Jacobi kernel launches of rows 9 and 3 (one of them
    runs on a path: jac2, or past its budget jac1 per component) and the
    BiCGSTAB loop's whole-solve Jacobi counters (sweeps, component solves
    that ran none, solves, the jac2 solves' launches their schedule
    derives)."""
    from diffpiso_tpu_torch.solvers import krylov
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve

    b = krylov.bicgstab
    return (fused_jacobi1_solve.kernel_launches, fused_jacobi2_solve.kernel_launches,
            b.jacobi_sweeps, b.jacobi_idle, b.jacobi_solves, b.jacobi2_schedule)


def jac1_schedule_check(what: str, s0: tuple, s1: tuple) -> int:
    """Rows 9 and 3's kernel launches between two `jac1_snapshot`s against
    the schedules the loops' counters derive: row 9 one launch a sweep and
    one for a component solve that stops at entry
    (`jacobi1.schedule_launches`), row 3 `jacobi2.solve_launches` of each
    solve's sweeps, the loop's sum. Fails if they differ or none ran.
    Returns the launches."""
    from diffpiso_tpu_torch.solvers.jacobi1 import schedule_launches

    k1, k2, sweeps, idle, solves, want2 = (b - a for a, b in zip(s0, s1))
    want1 = 0 if k2 or want2 else schedule_launches(sweeps, idle)
    if k1 != want1 or k2 != want2 or not k1 + k2:
        fail(f"{what}: rows 9 / 3 launched {k1} / {k2} kernels, their schedules derive "
             f"{want1} / {want2} ({solves} solves, {sweeps} sweeps, {idle} component solves "
             "with none)")
    return k1 + k2


def same_norm(a, b) -> bool:
    """Exit residuals (scalars or per sample) with equal bits, or both NaN."""
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


JAC_EDGE_SWEEPS = {"tol met at entry": 0, "one sweep": 1, "max_sweeps 0": 0, "max_sweeps 1": 1,
                   "max_sweeps reached": 2, "NaN in b": 0}


def jac2_edges(label: str, st_cs, b_c, x_c, tol) -> dict:
    """Row 3 on one system, forward and transposed, at `tol` and at the
    schedule's edges (tol met at entry, one sweep, max_sweeps 0, 1 and 2
    at tol 0, a NaN in b): x, exit residual and sweeps bit-equal to
    `jacobi2_plain`, each call one whole solve of the kernel launches
    `jacobi2.solve_launches` derives. Fails otherwise. Returns {transpose:
    the sweeps at tol}."""
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        RUN_LENGTH, fused_jacobi2_solve, jacobi2_plain, solve_launches)

    fn = fused_jacobi2_solve
    out = {}
    for tr in (False, True):
        n0 = jacobi2_plain(st_cs, b_c, x_c, -1.0, tr, 0.0, 0)[2]
        n1 = jacobi2_plain(st_cs, b_c, x_c, -1.0, tr, 0.0, 1)[2]
        bn = tuple(b.clone() for b in b_c)
        bn[-1].view(-1)[bn[-1].numel() // 3] = float("nan")
        cases = {"tol": (b_c, tol, 33), "tol met at entry": (b_c, 2.0 * n0, 33),
                 "one sweep": (b_c, (n0 * n1) ** 0.5, 33), "max_sweeps 0": (b_c, tol, 0),
                 "max_sweeps 1": (b_c, tol, 1), "max_sweeps reached": (b_c, 0.0, 2),
                 "NaN in b": (bn, tol, 33)}
        seen = {}
        for case, (b, tl, ms) in cases.items():
            k0, c0 = fn.kernel_launches, fn.launches
            k = fn(st_cs, b, x_c, -1.0, tr, tl, ms)
            launched = fn.kernel_launches - k0
            q = jacobi2_plain(st_cs, b, x_c, -1.0, tr, tl, ms)
            same = (same_bits(k[0], q[0]) and same_bits(k[1], q[1]) and same_norm(k[2], q[2])
                    and k[3] == q[3])
            seen[case] = (k[3], launched)
            # (one sweep stops at sqrt(n0 n1) only where the sweep lowers the residual)
            want = k[3] if case == "one sweep" and not n1 < n0 else JAC_EDGE_SWEEPS.get(case, k[3])
            if not (same and k[3] == want and fn.launches == c0 + 1
                    and launched == solve_launches(k[3], ms, RUN_LENGTH)):
                fail(f"{label} jac2 transpose={tr} ({case}): bit-equal to plain {same}, sweeps "
                     f"{k[3]} (plain {q[3]}), {launched} kernel launches (the schedule: "
                     f"{solve_launches(k[3], ms, RUN_LENGTH)})")
        print(f"{label} jac2 transpose={tr}: bit-equal to plain at every edge; (sweeps, kernel "
              f"launches) {seen}", flush=True)
        out[tr] = seen["tol"][0]
    return out


def batch_edges(label: str, solve, plain, single, b_c, tol, run: int) -> None:
    """A batched whole solve (rows 11a, 11b) on B >= 2 samples at the
    schedule's edges: a NaN in the last sample's b, the last sample
    converged at entry (with max_sweeps 33 and 1), max_sweeps 0, 1 and 2
    at tol 0. `solve` and `plain` map (b, tol, max_sweeps) to ([x per
    component], per-sample exit residuals, per-sample sweeps), `single`
    (sample, b, tol, max_sweeps) to the single-sample kernel's (x, exit
    residual, sweeps); `solve` returns its kernel launches as a fourth
    item. Every output bit-equal to plain and to the single-sample kernel,
    the launches `jacobi2.solve_launches` derives at the wrapper's run
    length `run`. Fails otherwise."""
    import numpy as np

    from diffpiso_tpu_torch.solvers.jacobi2 import solve_launches

    n0 = np.asarray(plain(b_c, 0.0, 0)[1], np.float32)
    nb, last = len(n0), len(n0) - 1
    bn = tuple(b.clone() for b in b_c)
    bn[0][last].view(-1)[bn[0][last].numel() // 2] = float("nan")
    conv = np.full(nb, tol, np.float32)
    conv[last] = 2.0 * n0[last]
    cases = {"NaN in one sample": (bn, tol, 33), "one sample starts converged": (b_c, conv, 33),
             "one starts converged, max_sweeps 1": (b_c, conv, 1),
             "max_sweeps 0": (b_c, tol, 0), "max_sweeps 1": (b_c, tol, 1),
             "max_sweeps reached": (b_c, 0.0, 2)}
    seen = {}
    for case, (b, tl, ms) in cases.items():
        kx, kn, ks, launched = solve(b, tl, ms)
        px, pn, ps = plain(b, tl, ms)
        same = (all(same_bits(k, q) for k, q in zip(kx, px)) and same_norm(kn, pn)
                and np.array_equal(ks, ps))
        tols = np.broadcast_to(np.asarray(tl, np.float32), (nb,))
        for s in range(nb):
            zx, zn, zs = single(s, b, float(tols[s]), ms)
            same &= (all(same_bits(k[s], z) for k, z in zip(kx, zx)) and same_norm(kn[s], zn)
                     and int(ks[s]) == zs)
        want = {"NaN in one sample": ks[last] == 0 and ks[0] > 0,
                "one sample starts converged": ks[last] == 0 and ks[0] > 0,
                "one starts converged, max_sweeps 1": ks[last] == 0 and ks[0] == 1
                }.get(case, True)
        seen[case] = (ks.tolist(), launched)
        if not (same and want and launched == solve_launches(int(ks.max()), ms, run)):
            fail(f"{label} ({case}): bit-equal to plain and the single-sample kernel {same}, "
                 f"sweeps {ks.tolist()}, {launched} kernel launches (the schedule: "
                 f"{solve_launches(int(ks.max()), ms, run)})")
    print(f"{label}: bit-equal to plain and to the single-sample kernels at every edge; "
          f"(sweeps, kernel launches) {seen}", flush=True)


def fold_edge_calls(st_cs, x_c, transpose) -> tuple:
    """`batch_edges`' (solve, plain, single) for the joint solve on the
    samples of `st_cs` (rows 11a, 11b-jac2)."""
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        fused_jacobi2_solve, fused_jacobi2_solve_folded, jacobi2_fold_plain)

    def solve(b, tl, ms):
        l0 = fused_jacobi2_solve_folded.launches
        x0, x1, nt, sw = fused_jacobi2_solve_folded(st_cs, b, x_c, -1.0, transpose, tl, ms)
        return [x0, x1], nt, sw, fused_jacobi2_solve_folded.launches - l0

    def plain(b, tl, ms):
        x0, x1, nt, sw = jacobi2_fold_plain(st_cs, b, x_c, -1.0, transpose, tl, ms)
        return [x0, x1], nt, sw

    def single(s, b, tl, ms):
        one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi)) for c, lo, hi in st_cs]
        z0, z1, zn, zs = fused_jacobi2_solve(one, tuple(v[s] for v in b),
                                             tuple(x[s] for x in x_c), -1.0, transpose, tl, ms)
        return [z0, z1], zn, zs

    return solve, plain, single


def jac1b_edge_calls(st_c, x, transpose) -> tuple:
    """`batch_edges`' (solve, plain, single) for the batched per-component
    solve on the samples of `st_c` (row 11b-jac1); b is a 1-tuple."""
    from diffpiso_tpu_torch.solvers.jacobi1 import (
        fused_jacobi1_solve, fused_jacobi1_solve_batched, jacobi1_batched_plain)

    def solve(b, tl, ms):
        l0 = fused_jacobi1_solve_batched.launches
        kx, nt, sw = fused_jacobi1_solve_batched(st_c, b[0], x, -1.0, transpose, tl, ms)
        return [kx], nt, sw, fused_jacobi1_solve_batched.launches - l0

    def plain(b, tl, ms):
        px, nt, sw = jacobi1_batched_plain(st_c, b[0], x, -1.0, transpose, tl, ms)
        return [px], nt, sw

    def single(s, b, tl, ms):
        one = (st_c[0][s], tuple(a[s] for a in st_c[1]), tuple(a[s] for a in st_c[2]))
        zx, zn, zs = fused_jacobi1_solve(one, b[0][s], x[s], -1.0, transpose, tl, ms)
        return [zx], zn, zs

    return solve, plain, single


def mixing_path(dev, wrappers: dict, resolution=MIX_RES, name: str = "mixing",
                jacobi=("jacobi2_solve", 1)) -> tuple:
    """Phases 7b and 7c (the 128 x 512 mixing layer, bench.py workload_dns)
    and 11 (its dns_512x2048 row, `resolution` (512, 2048)): from its initial
    state, the 400-step spin-up, 400 timed forward steps and grad30, every
    launch counter checked against what the steps and the solver loops'
    counters derive. `jacobi` names the whole-solve Jacobi kernel that the
    momentum solves must take and its launches per solve: jac2 once, or
    past its budget jac1 once per component. Returns (forward launches,
    grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    import numpy as np

    from diffpiso_tpu_torch.ops.fv import fv_divergence

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: M^-1 r must contract in full float32")

    def reset():
        for fn in wrappers.values():
            fn.launches = 0
        wrappers["stencil_matvec"].launches_transposed = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    setup = mixing_setup(resolution, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    jac, per_solve = jacobi
    clock = [0]

    def advance(k):
        nonlocal v, p, g1, g2
        warns, iters = 0, [0, 0]
        for _ in range(k):
            if clock[0] % MIX_CALL == 0:  # each bench call starts its scan from zero guesses
                g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
            o = step(v, p, g1, g2, tm=bench_time(clock[0], setup.dt))
            clock[0] += 1
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            warns += int(o.warn)
            iters[0] += o.p_iterations[0]
            iters[1] += o.p_iterations[1]
        return warns, [i / k for i in iters]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spin_warns, spin_iters = advance(MIX_SPINUP)
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    print(f"{name} {resolution}: {MIX_SPINUP}-step spin-up in {spin_s:.1f} s, warned steps "
          f"{spin_warns}, pressure iterations per step {spin_iters}", flush=True)

    # -- 7b: the forward path
    reset()
    c0, k0 = loop_counters(), phases2_counts()
    j0 = jac1_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns, iters = advance(MIX_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    j1 = jac1_snapshot()
    fwd_T = wrappers["stencil_matvec"].launches_transposed
    STATES[name] = (setup, v, p, g1, g2, clock[0])
    loops, d = derived_launches(c0, loop_counters(), spectral=True)
    r10ab = phases2_check(f"{name} forward", k0, d)
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    active_int = setup.sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, setup.domain.dx) * active_int).abs().max())
    print(json.dumps(dict(
        workload=f"spatial mixing layer DNS {resolution[0]}x{resolution[1]} ({MIX_SPINUP}-step "
                 f"spin-up), forward",
        steps=MIX_STEPS, steps_per_sec=MIX_STEPS / elapsed, pressure_iters_per_step=iters,
        warn_fraction=warns / MIX_STEPS, spinup_warned_steps=spin_warns,
        max_abs_div_active=div, loop_counters=d, launches=fwd,
        **({"row9_kernel_launches": j1[0] - j0[0]} if jac == "jacobi1_solve" else
           {"row3_kernel_launches": j1[1] - j0[1]}),
        row10ab_kernel_launches=r10ab,
    )), flush=True)
    if not finite:
        fail(f"{name}: non-finite state after the forward path")
    if warns:
        fail(f"{name}: warn fraction {warns / MIX_STEPS} (must be 0)")
    # per step: the three pressure gradients, two divergences, explicit_H's
    # two matvecs, one momentum solve, one Laplace assembly; the pressure
    # solves' phase kernels and any BiCGSTAB hand-over as the loops count
    # them; pcg2, both advection assembly kernels (row 1: the masks are not
    # uniform; row 13: the sponge viscosity is per face, so the general body
    # assembles) and the periodic kernels stay off
    S = MIX_STEPS
    want = dict(loops, grad2m=3 * S, div2m=2 * S, stencil_matvec=2 * S + 2 * d["applies"],
                laplace_assembly=S, **{jac: per_solve * S})
    for k in fwd:
        if fwd[k] != want.get(k, 0):
            fail(f"{name} forward: {k} launched {fwd[k]} times, expected {want.get(k, 0)}")
    if fwd_T != 2 * d["applies_T"]:
        fail(f"{name} forward: {fwd_T} transposed matvecs, expected {2 * d['applies_T']}")
    jac1_schedule_check(f"{name} forward", j0, j1)

    # -- 7c: grad30 from the developed state, the Dirichlet values frozen at
    # the last forward call's time (bench.py). Per evaluation, U steps,
    # "outputs" remat (tests/test_torch_mixing.py derives the same counts on
    # the CPU): grad2m 8U, div2m 4U, gradT2m 3U - 1, matvec 4U + 2U
    # transposed, jac2 2U, Laplace assembly 2U; the PCG phases and any
    # BiCGSTAB hand-over as the loops count them (2U warm forward solves,
    # 2U cold adjoint loops).
    U = UNROLL
    frozen = setup.dirichlet_values(setup.perturbation(np.float32(bench_t0(clock[0] - 1,
                                                                           setup.dt))))
    step_g = mixing_step_fn(setup, frozen)
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False, False))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        c0, k0 = loop_counters(), phases2_counts()
        j0 = jac1_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step_g, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        loops, d = derived_launches(c0, loop_counters(), spectral=True)
        r10ab = phases2_check(f"{name} grad30", k0, d)
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            gated_ratios=[round(a.residual / a.limit, 4) for a in p_adj if a.gated],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            loop_counters=d, launches=counts, row10ab_kernel_launches=r10ab,
            matvec_transposed=wrappers["stencil_matvec"].launches_transposed,
        ))
        print(json.dumps({f"{name}_grad_eval": rep, **evals[-1]}), flush=True)
        if res.warns:
            fail(f"{name} grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"{name} grad30: |grad| = {gnorm} (must be finite and > 0)")
        want = dict(loops, grad2m=8 * U, div2m=4 * U, gradT2m=3 * U - 1,
                    stencil_matvec=6 * U + 2 * (d["applies"] + d["applies_T"]),
                    laplace_assembly=2 * U, **{jac: per_solve * 2 * U})
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{name} grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        jac1_schedule_check(f"{name} grad30", j0, jac1_snapshot())
        e = evals[-1]
        if e["matvec_transposed"] != 2 * U + 2 * d["applies_T"]:
            fail(f"{name} grad30: {e['matvec_transposed']} transposed matvecs, expected "
                 f"{2 * U + 2 * d['applies_T']}")
        if d["pcg_warm_entries"] != 2 * U or d["pcg_loops"] < 2 * U:
            fail(f"{name} grad30: the pressure solves did not run 2U warm entries and the 2U "
                 "cold adjoint loops")
        if any(e[k] != evals[0][k] for k in ("launches", "loop_counters")):
            fail(f"{name} grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"spatial mixing layer DNS {resolution[0]}x{resolution[1]}, grad{U} "
                 f"(d sum v^2 / d forcing, Dirichlet values frozen), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg_iters_per_step=sum(e["adjoint_pcg_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        gated_ratios=timed[-1]["gated_ratios"],
        adjoint_ratio_passed_max=timed[-1]["adjoint_ratio_passed_max"],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )), flush=True)
    return fwd, timed[-1]["launches"]


# -- the training workload (bench.py workload_training) ------------------------
TRAIN_RES = (64, 256)
TRAIN_SMALL = (32, 128)  # VALID padding needs ny >= 19
TRAIN_TOL = 1e-6  # bench.py's --tol
TRAIN_STEPS = 10
TRAIN_BATCH = 8
TRAIN_REPS = 5  # bench.py: 1 untimed + 5 timed iterations
TRAIN_CHUNK = 10
TRAIN_CHUNK_REPS = 2  # timed chunks after one untimed (bench.py takes 4)
# card-vs-CPU and batched-vs-single checks: at tol 1e-7, where float32
# solves resolve the weight gradient to 1e-3 (at 1e-5 the JAX package's own
# two solver paths differ by up to 2.3e-3; tests/test_torch_training.py)
TRAIN_CHECK_TOL = 1e-7


def training_setup(res, dev, dt=0.4):
    from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup

    return spatial_mixing_layer_setup(simulation={"HRres": res, "dt": dt},
                                      max_iterations=(200, 2000), device=dev)


def training_cfg(steps=TRAIN_STEPS, tol=TRAIN_TOL, remat="outputs", padding="VALID"):
    from diffpiso_tpu_torch.learning.training import TrainingConfig

    return TrainingConfig(step_count=steps, loss_influence_range=steps, padding=padding,
                          advection_tol=tol, pressure_tol=tol, remat=remat)


def training_frames(setup, cfg, nb):
    """`nb` distinct samples as a dataset's frames: sample s starts from the
    state s steps into a network-free run (perturbations at bench's times
    550 + i dt), with perturbations from its own start and the
    network-free rollout from there as its targets. Returns the batch
    (vel0, p0, targets, perturbations) with a leading axis."""
    import dataclasses

    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.training import make_rollout_fn

    free = make_rollout_fn(setup, dataclasses.replace(cfg, remat="none",
                                                      step_count=max(nb - 1, 1)),
                           with_network=False)
    v, p = setup.initial_state()
    times = [550.0 + i * setup.dt for i in range(nb - 1 + cfg.step_count)]
    pert = torch.stack([setup.perturbation(tm) for tm in times])
    with torch.no_grad():
        vw, pw, _ = free(None, v, p, pert[:max(nb - 1, 1)])
    starts = [(v, p)] + [(StaggeredField(tuple(c[s] for c in vw.components)), pw[s])
                         for s in range(nb - 1)]
    roll = make_rollout_fn(setup, dataclasses.replace(cfg, remat="none"), with_network=False)
    out = []
    for s, (v0, p0) in enumerate(starts):
        pe = pert[s:s + cfg.step_count]
        with torch.no_grad():
            tg, _, _ = roll(None, v0, p0, pe)
        out.append((v0, p0, tg, pe))
    stack = lambda xs: torch.stack(list(xs))
    return (StaggeredField(tuple(stack(o[0].components[c] for o in out) for c in range(2))),
            stack(o[1] for o in out),
            StaggeredField(tuple(stack(o[2].components[c] for o in out) for c in range(2))),
            stack(o[3] for o in out))


def sample(batch, s):
    """Sample s of a batch (vel0, p0, targets, perturbations)."""
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    v, p, tg, pe = batch
    return (StaggeredField(tuple(c[s] for c in v.components)), p[s],
            StaggeredField(tuple(c[s] for c in tg.components)), pe[s])


def weight_grad(loss_fn, params, inputs):
    """(loss, warn, weight gradient as float64 CPU tensors)."""
    import torch

    leaves = [w.detach().clone().requires_grad_(True) for w in params]
    loss, (warn, _) = loss_fn(leaves, *inputs)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), warn, [g.double().cpu() for g in grads]


def rel_l2_list(a, b) -> float:
    import torch

    num = sum(float(torch.sum((x.double().cpu() - y.double().cpu()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double().cpu() ** 2)) for y in b)
    return (num / den) ** 0.5 if den > 0 else float("inf")


def training_kernels(dev, kernels: list) -> dict:
    """Phase 2d: the batch-folded jac2 kernel at the batch-8 training
    workload's 64 x 256 shapes (faces 65 x 256 and 64 x 257), on the
    operators of 8 distinct states (frames of a network-free run) and the
    predictor's right-hand sides, forward and transposed, with a shared and
    a per-sample tolerance and at the schedule's edges (`batch_edges`):
    against its plain version and against 8 calls of the single-sample jac2
    kernel, bit-equal x and exit residuals, equal per-sample sweeps, the
    kernel launches `jacobi2.solve_launches` derives. Appends the kernel's
    entry."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.ops.fv import fv_gradient
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        RUN_LENGTH, fused_jacobi2_solve, fused_jacobi2_solve_folded, jacobi2_fold_plain,
        solve_launches)

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg()
    vel, p, _, pe = training_frames(setup, cfg, TRAIN_BATCH)
    dx = setup.domain.dx
    beta = dx[0] * dx[1] / setup.dt
    sim = setup.sim
    st = assemble_advection_stencil(vel, dx, setup.domain.velocity_pad_modes(),
                                    sim.viscosity, beta, sim.dirichlet_mask, sim.active_mask,
                                    sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
                                    uniform=False)
    dv = setup.dirichlet_values(pe[:, 0])
    rhs = vel * beta - fv_gradient(p, dx, setup.domain.pressure_pad_modes(),
                                   sim.accessible_mask)
    b_c = tuple(torch.where(dm, -d, r).contiguous() for dm, d, r in zip(
        sim.dirichlet_mask.components, dv.components, rhs.components))
    st_cs = [(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)]
    x_c = tuple(c.contiguous() for c in vel.components)
    per_tol = np.asarray([1e-3, 1e-4, 1e-5, 1e-6, 1e-6, 3e-7, 1e-7, 1e-8], np.float32)
    err, rows = 0.0, []
    for transpose in (False, True):
        for tol in (TRAIN_TOL, per_tol):
            l0 = fused_jacobi2_solve_folded.launches
            kx0, kx1, kn, ks = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, transpose,
                                                          tol, 33)
            launched = fused_jacobi2_solve_folded.launches - l0
            px0, px1, pn, ps = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, tol, 33)
            same = (same_bits(kx0, px0) and same_bits(kx1, px1)
                    and same_norm(kn, pn) and np.array_equal(ks, ps)
                    and launched == solve_launches(int(ks.max()), 33, RUN_LENGTH))
            tols = np.broadcast_to(np.asarray(tol, np.float32), (TRAIN_BATCH,))
            single = True
            for s in range(TRAIN_BATCH):
                one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi))
                       for c, lo, hi in st_cs]
                z0, z1, zn, zs = fused_jacobi2_solve(one, tuple(b[s] for b in b_c),
                                                     tuple(x[s] for x in x_c), -1.0, transpose,
                                                     float(tols[s]), 33)
                single &= (same_bits(kx0[s], z0) and same_bits(kx1[s], z1)
                           and same_norm(kn[s], zn) and int(ks[s]) == zs)
            err = max(err, float((kx0 - px0).abs().max()), float((kx1 - px1).abs().max()))
            rows.append(dict(transpose=transpose, per_sample_tol=not np.isscalar(tol),
                             sweeps=ks.tolist(), kernel_launches=launched, bit_equal_plain=same,
                             bit_equal_single_sample_kernel=single))
            print(f"jac2 fold (B={TRAIN_BATCH}, {TRAIN_RES[0]}x{TRAIN_RES[1]}) transpose="
                  f"{transpose} per-sample tol={not np.isscalar(tol)}: sweeps {ks.tolist()}, "
                  f"{launched} kernel launches, bit-equal to plain {same}, to 8 single-sample "
                  f"kernels {single}", flush=True)
            if not (same and single):
                fail(f"jac2 fold transpose={transpose}: not bit-equal to its plain version and "
                     f"the single-sample kernel per sample, or not the schedule's launches")
        batch_edges(f"jac2 fold (B={TRAIN_BATCH}) transpose={transpose}",
                    *fold_edge_calls(st_cs, x_c, transpose), b_c, TRAIN_TOL, RUN_LENGTH)
    _, _, _, sw = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, TRAIN_TOL, 33)
    cells = [b.numel() for b in b_c]  # B planes per component
    # 14 planes in and 2 out per sample; per cell and component: the inverse
    # diagonal (2 flops), the entry and exit residual matvecs (11 each) and
    # 13 per sweep the sample runs (each sample's own sweeps)
    bytes_moved = sum(8 * 4 * c for c in cells)
    flops = sum(c / TRAIN_BATCH * float(np.sum(2 + 22 + 13 * sw)) for c in cells)
    b_f, by_f = bound(bytes_moved, flops)
    fn = lambda: fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, TRAIN_TOL, 33)
    kernels.append(dict(
        name="jacobi2_solve_folded", route="cuda",
        source="diffpiso_tpu_torch/csrc/jacobi2_fold.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:839",
        max_abs_err=err, ms=cuda_time_ms(fn, 50), **device_time(fn),
        plain_ms=cuda_time_ms(lambda: jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, False,
                                                         TRAIN_TOL, 33), 10),
        bound_ms=b_f, bound_by=by_f, library_ms=None,
        launches_count="kernel launches (per solve: jacobi2.solve_launches of the slowest "
                       "sample's sweeps)",
        batch=TRAIN_BATCH, sweeps=sw.tolist(), checks=rows,
    ))
    return {}


def network_check(dev) -> None:
    """The closure CNN at its published widths on a 64 x 256 input (VALID,
    restore_shape): forward and its VJP (input and weights) on the card
    against float64 on the CPU, rel l2 <= 1e-5, with cuDNN's TF32 switch
    left as the caller has it (PyTorch's default: on). TF32 in the forward
    or the backward would miss by ~1e-3."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.models.networks import fullyconv_apply, init_fullyconv

    params = init_fullyconv(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4,) + TRAIN_RES).astype(np.float32)
    ct = rng.standard_normal((2,) + TRAIN_RES).astype(np.float32)
    res = {}
    for key, d, dt in (("cuda", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        leaves = [torch.as_tensor(x, dtype=dt, device=d).requires_grad_(True)]
        leaves += [w.to(d, dt).requires_grad_(True) for w in params]
        y = fullyconv_apply(leaves[1:], leaves[0], "VALID", restore_shape=True)
        g = torch.autograd.grad(y, leaves, torch.as_tensor(ct, dtype=dt, device=d))
        res[key] = [y.detach()] + list(g)
    errs = [rel_l2_list([a], [b]) for a, b in zip(res["cuda"], res["cpu"])]
    print(f"closure CNN {TRAIN_RES[0]}x{TRAIN_RES[1]} (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}), card vs CPU float64: forward rel l2 {errs[0]:.3e}, "
          f"input VJP {errs[1]:.3e}, weight VJP max {max(errs[2:]):.3e}", flush=True)
    if not max(errs) <= 1e-5:
        fail(f"closure CNN: card vs float64 rel l2 {max(errs):.3e} > 1e-5 (TF32?)")


def training_small_check(dev) -> None:
    """Phase 8a: the closure CNN alone (`network_check`); then the training
    loss and its weight gradient at 32 x 128 (3 steps, the published
    network, VALID) on the card against the plain path on the CPU: loss
    within rtol 1e-4, gradient rel l2 <= 1e-3, equal warn and every
    adjoint's gate decision."""
    import torch

    from diffpiso_tpu_torch.learning.training import make_loss_fn, make_rollout_fn
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    network_check(dev)
    res = {}
    for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        setup = training_setup(TRAIN_SMALL, d)
        cfg = training_cfg(steps=3, tol=TRAIN_CHECK_TOL)
        rollout = make_rollout_fn(setup, cfg)
        loss_fn = make_loss_fn(setup, cfg, rollout)
        params = init_fullyconv(torch.Generator().manual_seed(0), device=d)
        inputs = sample(training_frames(setup, cfg, 1), 0)
        loss, warn, grads = weight_grad(loss_fn, params, inputs)
        gates = [(a.system, bool(a.gated)) for s in rollout.stashes for a in s.adjoints]
        res[key] = (loss, bool(warn), grads, gates)
    lc, lp = res["cuda"][0], res["cpu"][0]
    g_rel = rel_l2_list(res["cuda"][2], res["cpu"][2])
    print(f"training {TRAIN_SMALL[0]}x{TRAIN_SMALL[1]} x 3 steps (tol {TRAIN_CHECK_TOL}), card vs "
          f"CPU plain path: loss {lc:.6e} / {lp:.6e}, weight gradient rel l2 {g_rel:.3e}, warn "
          f"{res['cuda'][1]} / {res['cpu'][1]}, gated adjoints "
          f"{sum(g for _, g in res['cuda'][3])} / {sum(g for _, g in res['cpu'][3])} of "
          f"{len(res['cpu'][3])}", flush=True)
    if res["cuda"][1] != res["cpu"][1] or res["cuda"][3] != res["cpu"][3]:
        fail("training card vs CPU: warn or adjoint gate decisions differ")
    if not abs(lc - lp) <= 1e-4 * abs(lp):
        fail(f"training card vs CPU: loss {lc} vs {lp} beyond rtol 1e-4")
    if not g_rel <= 1e-3:
        fail(f"training card vs CPU: weight gradient rel l2 {g_rel:.3e} > 1e-3")


def training_b1_path(dev, wrappers: dict) -> dict:
    """Phase 8b: bench.py workload_training at batch 1: 64 x 256, 10-step
    unroll, four losses, Adam 1e-5, remat "outputs", synthetic targets from
    a network-free rollout; 1 untimed and 5 timed train steps with the
    launches counted over the timed ones (jac2 and the Laplace assembly 2 x
    10 per step: forward, adjoint / replay; the PCG phases and any
    BiCGSTAB hand-over as the loops' counters derive), then the chunked
    loop (chunk 10). Returns the launches of the 5 timed steps."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        make_chunked_train_step, make_loss_fn, make_rollout_fn, make_train_step)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg()
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    opt = Adam(1e-5)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = opt.init(params)
    inputs = sample(training_frames(setup, cfg, 1), 0)
    step = make_train_step(loss_fn, opt)
    params, state, loss, parts, warn = step(params, state, *inputs)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    c0 = loop_counters()
    j0 = jac1_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns = 0
    for _ in range(TRAIN_REPS):
        params, state, loss, parts, warn = step(params, state, *inputs)
        warns += int(warn)
    loss_v = float(loss)
    per_iter = (time.perf_counter() - t0) / TRAIN_REPS
    counts = {k: fn.launches for k, fn in wrappers.items()}
    row3 = jac1_schedule_check("training batch 1", j0, jac1_snapshot())
    loops, d = derived_launches(c0, loop_counters(), spectral=True)
    stack = lambda x: torch.stack([x] * TRAIN_CHUNK)
    v0, p0, tg, pe = inputs
    cin = (StaggeredField(tuple(stack(c) for c in v0.components)), stack(p0),
           StaggeredField(tuple(stack(c) for c in tg.components)), stack(pe))
    cstep = make_chunked_train_step(loss_fn, opt, TRAIN_CHUNK)
    pc, sc, losses, _, cwarns = cstep(params, state, *cin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CHUNK_REPS):
        pc, sc, losses, _, cw = cstep(pc, sc, *cin)
        cwarns = np.concatenate([cwarns, cw])
    torch.cuda.synchronize()
    per_chunk_iter = (time.perf_counter() - t0) / (TRAIN_CHUNK_REPS * TRAIN_CHUNK)
    finite = bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(w).all()) for w in pc)
    print(json.dumps(dict(
        workload=f"closure training iteration {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
                 f"{TRAIN_STEPS}-step unroll, 4 losses, Adam, batch 1",
        train_iterations_per_sec=1.0 / per_iter, samples_per_sec=1.0 / per_iter,
        unrolled_steps_per_sec=TRAIN_STEPS / per_iter, loss=loss_v, warn=bool(warns),
        parts=[float(x) for x in parts], count=int(state.count),
        chunked_train_iterations_per_sec=1.0 / per_chunk_iter, chunked_scan_chunk=TRAIN_CHUNK,
        chunked_warn=bool(cwarns.any()), timed_iterations=TRAIN_REPS, launches=counts,
        loop_counters=d, row3_kernel_launches=row3,
    )), flush=True)
    if warns or cwarns.any() or not finite:
        fail("training batch 1: a step warned or its loss / weights are not finite")
    if int(sc.count) != 1 + TRAIN_REPS + (1 + TRAIN_CHUNK_REPS) * TRAIN_CHUNK:
        fail(f"training batch 1: Adam count {int(sc.count)}: an update was skipped")
    # per train step: the mixing layer's kernels (jac2 once per forward step
    # and per adjoint, the bounded FV trio, the matvec, the Laplace assembly,
    # the PCG phases) and never the periodic ones, pcg2 or the fold
    for k in ("jacobi2_solve", "grad2m", "div2m", "gradT2m", "stencil_matvec", "laplace_assembly",
              "pcg_apply"):
        if not counts[k]:
            fail(f"training batch 1: {k} never launched")
    n_solves = 2 * TRAIN_STEPS * TRAIN_REPS
    if counts["jacobi2_solve"] != n_solves or counts["laplace_assembly"] != n_solves:
        fail(f"training batch 1: jac2 {counts['jacobi2_solve']} / Laplace assembly "
             f"{counts['laplace_assembly']} launches, expected {n_solves} each")
    for k, want in loops.items():
        if counts[k] != want:
            fail(f"training batch 1: {k} launched {counts[k]} times, the loops derive {want}")
    # (both advection assembly kernels: the layer's sponge viscosity is per
    # face, so the general body assembles)
    for k in ("advection_assembly", "advection_assembly_masked", "pcg2_solve", "div2", "grad2",
              "corrector1_bridge", "corrector2_tail", "corrector1_bridge_bwd",
              "corrector2_tail_bwd", "jacobi2_solve_folded", "jacobi1_solve",
              "pcg_mm_update", *T3_KERNELS, *T3_TIER_KERNELS.values()):
        if counts[k]:
            fail(f"training batch 1: {k} launched {counts[k]} times (must stay off this path)")
    return counts


class GradCapture:
    """An optimizer whose update is zero and whose new state is the gradient
    it was given: a train step's state output is its (masked-mean)
    gradient."""

    def init(self, params):
        import torch

        return tuple(torch.zeros_like(p) for p in params)

    def update(self, grads, state):
        import torch

        return [torch.zeros_like(g) for g in grads], tuple(grads)


def training_batched_check(dev) -> None:
    """Phase 9a: 8 distinct samples at 64 x 256 (10 steps, tol 1e-7): the
    batched train step on the card against 8 batch-1 card runs, per-sample
    loss within rtol 1e-4 and the masked-mean weight gradient within rel l2
    1e-3 of the mean of the 8 single-sample gradients."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.learning.training import (
        make_batched_train_step, make_loss_fn, make_rollout_fn)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg(tol=TRAIN_CHECK_TOL, remat="none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = training_frames(setup, cfg, TRAIN_BATCH)
    opt = GradCapture()
    _, mean_g, _, parts, bwarns = make_batched_train_step(loss_fn, opt)(params, opt.init(params),
                                                                          *batch)
    losses = parts.sum(-1)
    single_l, single_g, single_w = [], [], []
    b1_cfg = training_cfg(tol=TRAIN_CHECK_TOL)
    b1_loss = make_loss_fn(setup, b1_cfg, make_rollout_fn(setup, b1_cfg))
    for s in range(TRAIN_BATCH):
        loss, warn, grads = weight_grad(b1_loss, params, sample(batch, s))
        single_l.append(loss)
        single_g.append(grads)
        single_w.append(bool(warn))
    want_g = [sum(g[i] for g in single_g) / TRAIN_BATCH for i in range(len(params))]
    l_rel = max(abs(float(losses[s]) - single_l[s]) / abs(single_l[s]) for s in range(TRAIN_BATCH))
    g_rel = rel_l2_list(mean_g, want_g)
    print(f"training batch {TRAIN_BATCH} (distinct samples, tol {TRAIN_CHECK_TOL}) vs "
          f"{TRAIN_BATCH} batch-1 runs on the card: per-sample loss max rel {l_rel:.3e}, "
          f"masked-mean weight gradient rel l2 {g_rel:.3e}, warns {np.asarray(bwarns).tolist()} / "
          f"{single_w}", flush=True)
    if np.asarray(bwarns).any() or any(single_w):
        fail("training batch 8 check: a solve warned")
    if not l_rel <= 1e-4:
        fail(f"training batch 8 vs batch 1: per-sample loss rel {l_rel:.3e} > 1e-4")
    if not g_rel <= 1e-3:
        fail(f"training batch 8 vs batch 1: gradient rel l2 {g_rel:.3e} > 1e-3")


def training_b8_path(dev, wrappers: dict) -> dict:
    """Phase 9b: bench.py workload_training at batch 8 as bench stacks it (8
    copies of the sample), remat "none": 1 untimed and 5 timed train steps,
    launches counted over the timed ones. The fold kernel launches exactly
    as its per-sample sweep counters derive (per solve:
    `jacobi2.solve_launches` of its slowest sample's sweeps), and no
    single-sample 2-D kernel launches (the batched regime runs the plain
    formulations elsewhere, as the JAX package's vmapped step does under
    no_pallas)."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        make_batched_train_step, make_loss_fn, make_rollout_fn)
    from diffpiso_tpu_torch.models.networks import init_fullyconv
    from diffpiso_tpu_torch.solvers import krylov

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg(remat="none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    opt = Adam(1e-5)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = opt.init(params)
    v0, p0, tg, pe = sample(training_frames(setup, cfg, 1), 0)
    stack = lambda x: torch.stack([x] * TRAIN_BATCH)
    batch = (StaggeredField(tuple(stack(c) for c in v0.components)), stack(p0),
             StaggeredField(tuple(stack(c) for c in tg.components)), stack(pe))
    step = make_batched_train_step(loss_fn, opt)
    params, state, loss, parts, warns = step(params, state, *batch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    solves0 = krylov.bicgstab_batched.jacobi_solves
    sweeps0 = krylov.bicgstab_batched.jacobi_sweeps
    sched0 = krylov.bicgstab_batched.jacobi_schedule
    fb0 = krylov.bicgstab_batched.fallbacks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    any_warn = False
    for _ in range(TRAIN_REPS):
        params, state, loss, parts, warns = step(params, state, *batch)
        any_warn |= bool(np.asarray(warns).any())
    loss_v = float(loss)
    per_iter = (time.perf_counter() - t0) / TRAIN_REPS
    counts = {k: fn.launches for k, fn in wrappers.items()}
    solves = krylov.bicgstab_batched.jacobi_solves - solves0
    sweeps = krylov.bicgstab_batched.jacobi_sweeps - sweeps0
    # `jacobi2.solve_launches` of each solve's slowest sample's sweeps
    derived = krylov.bicgstab_batched.jacobi_schedule - sched0
    print(json.dumps(dict(
        workload=f"closure training iteration {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
                 f"{TRAIN_STEPS}-step unroll, 4 losses, Adam, batch {TRAIN_BATCH}",
        train_iterations_per_sec=1.0 / per_iter, samples_per_sec=TRAIN_BATCH / per_iter,
        unrolled_steps_per_sec=TRAIN_STEPS * TRAIN_BATCH / per_iter, loss=loss_v,
        warn=any_warn, count=int(state.count), folded_solves=solves,
        fold_sweeps_per_solve_mean=sweeps / solves if solves else 0,
        bicgstab_fallback_samples=krylov.bicgstab_batched.fallbacks - fb0,
        launches=counts,
    )), flush=True)
    if any_warn or not np.isfinite(loss_v):
        fail("training batch 8: a sample warned or the loss is not finite")
    if int(state.count) != 1 + TRAIN_REPS:
        fail(f"training batch 8: Adam count {int(state.count)}: an update was skipped")
    # a forward and an adjoint momentum solve per unrolled step and iteration
    if solves != 2 * TRAIN_STEPS * TRAIN_REPS:
        fail(f"training batch 8: {solves} folded solves, expected "
             f"{2 * TRAIN_STEPS * TRAIN_REPS}")
    if not (counts["jacobi2_solve_folded"] == derived > 0):
        fail(f"training batch 8: fold launches {counts['jacobi2_solve_folded']}, the sweep "
             f"counters derive {derived}")
    for k, c in counts.items():
        if k != "jacobi2_solve_folded" and c:
            fail(f"training batch 8: {k} launched {c} times (the batched regime runs it plain)")
    return counts


# -- the large-plane tier (bench.py turb_1024 and dns_512x2048) ----------------
LARGE_N = 1024  # bench.py turb_1024: workload_turbulence at n = 1024
LARGE_CHECK_STEPS = 2  # phase 10a: steps and rollout-gradient depth, card vs CPU
# phase 10a's pressure tol: at the main path's 1e-8 a 1024^2 corrector can end
# its solve with a residual within rounding of tol, so the iteration it stops
# at depends on the summation order (the second step's first corrector: 2
# iterations on the card, 1 on the CPU, measured on the H100); phase 3's 1e-7
# keeps the counts the algorithm's. The timed paths keep 1e-8.
LARGE_CHECK_P_TOL = 1e-7
DNS_RES = (512, 2048)  # bench.py dns_512x2048: workload_dns at HRres (512, 2048)
# kernels only the large tier runs; their `launches` come from the 1024^2 forward path
LARGE_KERNELS = ("jacobi1_solve", "pcg_mm_update")


def turbulence_step_fn(domain, sim, dt, p_tol=P_TOL):
    """bench.py build_turbulence's step: advection tol 1e-6, pressure tol
    1e-8, warm-started pressure increments."""
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None, full_output=False, adjoint_channels=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=p_tol,
                         full_output=full_output, adjoint_channels=adjoint_channels)

    return step


def jacobi1_check(label, st, b_c, x_c) -> tuple:
    """jac1 against its plain version on each component, forward and
    transposed: equal sweeps, exit residual and x, bit for bit. Returns
    (sweeps of each (component, transpose), max abs err)."""
    import torch

    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain

    sweeps, err = {}, 0.0
    for c in range(len(b_c)):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            args = (st_c, b_c[c], x_c[c], -1.0, transpose, ADV_TOL, 33)
            kx, kn, ks = fused_jacobi1_solve(*args)
            px, pn, ps = jacobi1_plain(*args)
            bit = torch.equal(kx, px) and kn == pn
            err = max(err, float((kx - px).abs().max()))
            print(f"{label} jac1 component {c} {tuple(b_c[c].shape)} transpose={transpose}: "
                  f"sweeps kernel {ks} plain {ps}, residual kernel {kn:.3e} plain {pn:.3e}, "
                  f"bit-equal {bit}", flush=True)
            if ks != ps or not bit:
                fail(f"{label} jac1 component {c} transpose={transpose}: kernel and plain "
                     f"differ (sweeps {ks} vs {ps}; bit-equal {bit})")
            sweeps[(c, transpose)] = ks
    return sweeps, err


def jacobi1_edges(label, solve, plain, st_c, b, x) -> dict:
    """A whole-solve Jacobi kernel (`solve`: row 9 or 15d) against its plain
    version on one path operator at the edges of its schedule, forward and
    transposed: tol met at entry (no sweep; x comes back as x itself, as in
    the plain version), exactly one sweep (tol between the entry residual
    and the first sweep's), max_sweeps 0, 1 and reached (2 at tol 0), a NaN
    in b (it stops at entry), the tolerances from the same form's entry
    and first-sweep residuals. Each: the sweeps the edge must take (0, 1,
    0, 1, 2, 0), equal exit residual and x, bit for bit. Returns {case:
    sweeps}."""
    import math

    import torch

    bn = b.clone()
    bn.view(-1)[b.numel() // 3] = float("nan")
    out = {}
    for tr in (False, True):
        n0 = plain(st_c, b, x, -1.0, tr, 0.0, 0)[1]
        n1 = plain(st_c, b, x, -1.0, tr, 0.0, 1)[1]
        cases = {"tol met at entry": (b, 2.0 * n0, 33, 0),
                 "one sweep": (b, math.sqrt(n0 * n1), 33, 1), "max_sweeps 0": (b, ADV_TOL, 0, 0),
                 "max_sweeps 1": (b, ADV_TOL, 1, 1), "max_sweeps reached": (b, 0.0, 2, 2),
                 "NaN in b": (bn, ADV_TOL, 33, 0)}
        for name, (bb, tol, ms, want) in cases.items():
            kx, kn, ks = solve(st_c, bb, x, -1.0, tr, tol, ms)
            px, pn, ps = plain(st_c, bb, x, -1.0, tr, tol, ms)
            same = ks == ps == want and torch.equal(kx, px) and (
                kn == pn or (math.isnan(kn) and math.isnan(pn)))
            if ps == 0:
                same = same and kx is x
            out[f"{name}{' T' if tr else ''}"] = ks
            if not same:
                fail(f"{label} {name} transpose={tr}: kernel and plain differ or miss the edge "
                     f"(sweeps {ks} vs {ps}, want {want}; residual {kn} vs {pn})")
    print(f"{label} schedule edges, sweeps: {out}", flush=True)
    return out


def jacobi1_entry(st_c, b, x, sweeps: int, err: float) -> dict:
    """Times and bound of one forward jac1 solve of one component (st_c =
    (center, lo, hi)) that takes `sweeps` sweeps: 7 planes in (5
    coefficients, b, x0), x out; per cell the inverse diagonal (2 flops),
    the entry and exit residuals (2 x 11) and 13 per sweep."""
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain

    args = (st_c, b, x, -1.0, False, ADV_TOL, 33)
    cells = b.numel()
    b_ms, b_by = bound(8 * cells * 4, cells * (2 + 22 + 13 * sweeps))
    return dict(max_abs_err=err, sweeps=sweeps,
                ms=cuda_time_ms(lambda: fused_jacobi1_solve(*args), 20),
                **device_time(lambda: fused_jacobi1_solve(*args), 5),
                plain_ms=cuda_time_ms(lambda: jacobi1_plain(*args), 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def large_kernels(dev, kernels: list) -> dict:
    """Phase 2f: the large tier's two kernels against their plain versions
    on the card. At 1024^2, on the operators of the first step of the
    turbulence run (bench.py turb_1024): jac1 forward and transposed on
    both components (equal sweeps, exit residual and x, bit for bit; on
    component 0 the schedule's edges, `jacobi1_edges`), and the folded PCG
    update on the loop's first call (p = 0, rz_old = 1, r the deflated
    divergence) and on the call after one apply (p' within rel 1e-6 of its
    scale, rz' within rel 1e-5: the hand-written GEMM sums in another order
    than torch.matmul); then jac1 on the 512 x 2048 mixing layer's faces
    (513 x 2048, 512 x 2049, each with the schedule's edges), on the
    operators of a step 20 steps into its run. Appends both kernels'
    entries (times at 1024^2) to `kernels`; returns jac1's measurements on
    the DNS faces."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers import pcgphases
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain
    from diffpiso_tpu_torch.solvers.pcg2 import gemm
    from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update, pcg_mm_update_plain

    n = LARGE_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = turbulence_step_fn(domain, sim, 0.4 / n)(v, zero, zero, zero,
                                                   full_output=True).intermediates
    st, b_c, x_c = it["stencil"], it["rhs"].components, v.components
    sweeps, err = jacobi1_check(f"{n}^2", st, b_c, x_c)
    jacobi1_edges(f"{n}^2 jac1", fused_jacobi1_solve, jacobi1_plain,
                  (st.center[0], st.lo[0], st.hi[0]), b_c[0], x_c[0])
    kernels.append(dict(
        name="jacobi1_solve", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi1.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:989",
        launches_count="whole solves of one component (each: the entry residual fused with "
                       "sweep 0, then one launch a further sweep: jacobi1.schedule_launches)",
        **jacobi1_entry((st.center[0], st.lo[0], st.hi[0]), b_c[0], x_c[0], sweeps[(0, False)],
                        err)))

    lap = it["laplacian"]
    mss, weights = pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    r0 = it["v1_div"] - torch.sum(it["v1_div"]) / (n * n)  # the deflated cold start
    zeros = torch.zeros_like(r0)
    first = (torch.ones((), device=dev), r0, zeros)
    p1, rz1 = pcg_mm_update_plain(v0, v1, sym, *first)
    r1 = pcgphases.pcg_apply_plain(lap, rz1, zeros, r0, p1, True)[1]
    # rows 10a / 10b on this system (4096 blocks), warm from M^-1 r0
    phases2_system_check(f"2f {n}^2", lap, it["v1_div"], p1)
    mid = (rz1, r1, p1)
    mm_err, f64_rel = 0.0, {}
    for label, args in (("first call", first), ("mid-loop", mid)):
        kp, krz = fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *args)
        pp, prz = pcg_mm_update_plain(v0, v1, sym, *args)
        p64, _ = pcg_mm_update_plain(*(a.double() for a in (v0, v1, sym, *args)))
        e = float((kp - pp).abs().max())
        scale = float(pp.abs().max())
        p_rel = e / scale
        rz_rel = abs(float(krz) - float(prz)) / abs(float(prz))
        mm_err = max(mm_err, e)
        # each float32 version against float64, in units of the scale
        f64_rel[label] = [float((x.double() - p64).abs().max()) / scale for x in (kp, pp)]
        print(f"{n}^2 mm_update ({label}) vs plain: p' max abs err {e:.3e} (rel to scale "
              f"{p_rel:.3e}), rz' rel err {rz_rel:.3e}; vs float64: kernel "
              f"{f64_rel[label][0]:.3e}, plain {f64_rel[label][1]:.3e}", flush=True)
        if not (p_rel <= 1e-6 and rz_rel <= 1e-5):
            fail(f"{n}^2 mm_update ({label}): kernel vs plain beyond rel 1e-6 of p's scale / "
                 f"rel 1e-5 (rz')")
    # v0, v1, the symbol, r and p in, p' out; four contractions of 2 n^3
    # flops each (in general 4 n0 n1 (n0 + n1)), r.z and the update
    b_mm, by_mm = bound((2 * n * n + 4 * n * n) * 4, 4 * n * n * (2 * n) + 4 * n * n)
    kernels.append(dict(
        name="pcg_mm_update", route="cuda", source="diffpiso_tpu_torch/csrc/pcg_mm_update.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:1966", max_abs_err=mm_err,
        ms=cuda_time_ms(lambda: fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *mid), 50),
        **device_time(lambda: fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *mid), 10),
        plain_ms=cuda_time_ms(lambda: pcg_mm_update_plain(v0, v1, sym, *mid), 50),
        bound_ms=b_mm, bound_by=by_mm, p_rel_err_vs_float64_kernel_plain=f64_rel,
        # yardstick: one 1024^3 fp32 contraction through cuBLAS (the op needs
        # four); the port never calls it
        library_ms=cuda_time_ms(lambda: torch.matmul(v0, r1), 200),
        gemm_ms=cuda_time_ms(lambda: gemm(v0, r1), 200),
    ))

    setup = mixing_setup(DNS_RES, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for k in range(20):
        o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
        if o.warn:
            fail("dns: a solve warned in the steps that make the kernel checks' planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                   dirichlet_values=setup.dirichlet_values(setup.perturbation(
                       bench_time(20, setup.dt))),
                   pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=MIX_TOL,
                   pressure_tol=MIX_TOL, full_output=True).intermediates
    # rows 10a / 10b on the DNS pressure system (4096 blocks)
    phases2_system_check(f"2f dns {DNS_RES}", it["laplacian"], it["v1_div"], 0.5 * g1)
    st, b_c = it["stencil"], it["rhs"].components
    sweeps, err = jacobi1_check(f"dns {DNS_RES}", st, b_c, v.components)
    for c in range(2):
        jacobi1_edges(f"dns {tuple(b_c[c].shape)} jac1", fused_jacobi1_solve, jacobi1_plain,
                      (st.center[c], st.lo[c], st.hi[c]), b_c[c], v.components[c])
    out = {}
    for c in range(2):
        shape = "x".join(map(str, b_c[c].shape))
        out[f"dns_{shape}"] = jacobi1_entry((st.center[c], st.lo[c], st.hi[c]), b_c[c],
                                            v.components[c], sweeps[(c, False)], err)
    return {"jacobi1_solve": out}


def large_small_check(dev) -> None:
    """Phase 10a: turbulence at 1024^2 from one seeded solenoidal state, 2
    steps and then the 2-step rollout gradient (from the same state), at
    pressure tol 1e-7 (LARGE_CHECK_P_TOL), on the card against the plain
    path on the CPU at full size: equal
    pressure iterations per step, equal solver loop counters (PCG loops,
    warm entries, resets, iterations; jac1 sweeps; BiCGSTAB hand-overs and
    iterations) for the steps and for the gradient, equal adjoint gate
    decisions, the velocity within rtol 2e-4 / atol 2e-5, the gradient
    within rel l2 1e-3."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    n = LARGE_N
    res = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=d)
        v0 = random_solenoidal(domain, torch.Generator().manual_seed(1), device=d)
        p0 = domain.centered_grid(0.0, device=d)
        step = turbulence_step_fn(domain, sim, 0.4 / n, LARGE_CHECK_P_TOL)
        v, p, g1, g2 = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
        c0, iters = loop_counters(), []
        for _ in range(LARGE_CHECK_STEPS):
            o = step(v, p, g1, g2)
            if o.warn:
                fail(f"{n}^2 steps on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters.append(list(o.p_iterations))
        c1 = loop_counters()
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v0.components), periodic=(True, True))
        bwd0 = row17_launches()
        r = rollout_loss_grad(step, v0, p0, f, LARGE_CHECK_STEPS)
        row17_check(f"{n}^2 rollout gradient", d, bwd0, LARGE_CHECK_STEPS)
        c2 = loop_counters()
        if r.warns:
            fail(f"{n}^2 rollout gradient on {d.type}: {r.warns} steps warned")
        res[key] = dict(
            v=[c.cpu() for c in v.components], iters=iters,
            steps={k: c1[k] - c0[k] for k in c0}, grad_counters={k: c2[k] - c1[k] for k in c0},
            grad=[c.cpu().double() for c in r.grad.components],
            decisions=[(a.system, a.gated) for a in r.adjoints],
            ratios=[round(a.residual / a.limit, 3) for a in r.adjoints if a.limit is not None],
            seconds=time.perf_counter() - t0)
    card, cpu = res["card"], res["cpu"]
    err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(card["v"], cpu["v"]))
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(card["grad"], cpu["grad"]))
    den = sum(float(torch.sum(b ** 2)) for b in cpu["grad"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(json.dumps(dict(
        check=f"{n}^2 x {LARGE_CHECK_STEPS} steps and rollout gradient, card vs CPU plain path",
        pressure_iters=[card["iters"], cpu["iters"]], step_counters=[card["steps"], cpu["steps"]],
        grad_counters=[card["grad_counters"], cpu["grad_counters"]],
        velocity_excess=err, grad_rel_l2=g_rel,
        gated=[sum(g for _, g in card["decisions"]), sum(g for _, g in cpu["decisions"]),
               len(cpu["decisions"])],
        pressure_adjoint_ratios=[card["ratios"], cpu["ratios"]],
        seconds=[card["seconds"], cpu["seconds"]])), flush=True)
    for key in ("iters", "steps", "grad_counters", "decisions"):
        if card[key] != cpu[key]:
            fail(f"{n}^2 card vs CPU: {key} differ, card {card[key]} vs CPU {cpu[key]}")
    if not err <= 2e-5:
        fail(f"{n}^2 card steps disagree with the CPU plain path beyond rtol 2e-4, atol 2e-5")
    if not g_rel <= 1e-3:
        fail(f"{n}^2 rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def large_turbulence_path(dev, wrappers: dict, res=(LARGE_N, LARGE_N), box=None) -> tuple:
    """Phases 10b-c (1024^2, bench.py turb_1024) and 16b-c (1024 x 2048 in
    the (2 pi, 4 pi) box): periodic turbulence at `res` (dt = 0.4 / ny, the
    cells square) from a seeded solenoidal state: 10 warm-up steps, then
    200 timed forward steps, then grad30 ("outputs" remat; 1 untimed and 3
    timed evaluations), every launch counter reset before each and checked
    after: the momentum solve in its tier (1024^2: jac1 twice per solve;
    1024 x 2048: the k-sweep kernel as the probe and trip counters derive),
    jac2 and pcg2 never, the folded update once per PCG loop, reset and
    iteration, the other PCG phases and any BiCGSTAB hand-over (its phases,
    the fused stencil residual) as the loops' counters derive, the periodic
    kernels once per step (grad30: phase 5b's counts). Reports steps/s,
    sweeps per solve, hand-overs and peak memory. Returns (forward
    launches, grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.solvers import tiers

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: the pressure solves must contract in full float32")
    res = tuple(res)
    n = f"{res[0]}^2" if res[0] == res[1] else f"{res[0]}x{res[1]}"
    label = "turb" + (str(res[0]) if res[0] == res[1] else f"{res[0]}x{res[1]}")
    tier = tiers.momentum_tier([res, res])
    # whole momentum solves per solve: jac1 one per component; the k-sweep
    # tier's launches follow from its counters (derived_launches)
    per_solve = {"jac1": {"jacobi1_solve": 2}, "sweeps": {}}[tier]
    domain, sim = decaying_turbulence_setup(res, box_size=box, viscosity=VISCOSITY, device=dev)
    step = turbulence_step_fn(domain, sim, 0.4 / res[0])
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    def check(what, counts, want):
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{n} {what}: {k} launched {counts[k]} times, expected {want.get(k, 0)}")

    for _ in range(WARMUP_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    reset()
    c0, k0 = loop_counters(), phases2_counts()
    j0 = jac1_snapshot()
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters[0] += o.p_iterations[0]
        iters[1] += o.p_iterations[1]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    j1 = jac1_snapshot()
    loops, d = derived_launches(c0, loop_counters(), fold=True)
    r10ab = phases2_check(f"{n} forward", k0, d)
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    print(json.dumps(dict(
        workload=f"decaying turbulence {n} (periodic, random solenoidal IC), forward",
        steps=TIMED_STEPS, steps_per_sec=TIMED_STEPS / elapsed,
        pressure_iters_per_step=[iters[0] / TIMED_STEPS, iters[1] / TIMED_STEPS],
        warn_fraction=warns / TIMED_STEPS,
        max_abs_div=float(fv_divergence(v, domain.dx).abs().max()), momentum_tier=tier,
        **sweep_stats(d, TIMED_STEPS), loop_counters=d, launches=fwd,
        row10ab_kernel_launches=r10ab,
        **({"row9_kernel_launches": j1[0] - j0[0]} if tier == "jac1" else {}))), flush=True)
    if not finite:
        fail(f"{n}: non-finite state after the forward path")
    if warns:
        fail(f"{n}: warn fraction {warns / TIMED_STEPS} (must be 0)")
    S = TIMED_STEPS
    check("forward", fwd, dict(
        loops, advection_assembly=S, laplace_assembly=S, div2=S, grad2=S,
        corrector1_bridge=S, corrector2_tail=S,
        stencil_matvec=2 * (d["applies"] + d["applies_T"]),
        **{k: c * S for k, c in per_solve.items()}))
    if tier == "sweeps" and d["jacobi_probes"] != S:
        fail(f"{n} forward: {d['jacobi_probes']} k-sweep probes, expected one per momentum "
             f"solve ({S})")
    if tier == "jac1":
        jac1_schedule_check(f"{n} forward", j0, j1)

    # grad30 from the developed state: phase 5b's counts with jac1 twice per
    # momentum solve and the pressure solves' loops derived (2U warm forward
    # solves, 2U cold adjoint loops)
    U = UNROLL
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(True, True))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        c0, k0 = loop_counters(), phases2_counts()
        j0 = jac1_snapshot()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        loops, d = derived_launches(c0, loop_counters(), fold=True)
        r10ab = phases2_check(f"{n} grad30", k0, d)
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            adjoint_ratio_gated_min=min((a.residual / a.limit for a in p_adj if a.gated),
                                        default=None),
            **sweep_stats(d, 2 * U), max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            loop_counters=d, launches=counts, row10ab_kernel_launches=r10ab))
        print(json.dumps({f"{label}_grad_eval": rep, **evals[-1]}), flush=True)
        if res.warns:
            fail(f"{n} grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"{n} grad30: |grad| = {gnorm} (must be finite and > 0)")
        check("grad30", counts, dict(
            loops, advection_assembly=2 * U, laplace_assembly=2 * U,
            div2=3 * U - 1, grad2=3 * U, corrector1_bridge=2 * U, corrector2_tail=2 * U,
            corrector1_bridge_bwd=U, corrector2_tail_bwd=U,
            stencil_matvec=2 * (d["applies"] + d["applies_T"]),
            **{k: c * 2 * U for k, c in per_solve.items()}))
        if d["pcg_warm_entries"] != 2 * U or d["pcg_loops"] < 2 * U:
            fail(f"{n} grad30: the pressure solves did not run 2U warm entries and the 2U "
                 "cold adjoint loops")
        if tier == "sweeps" and d["jacobi_probes"] != 2 * U:
            fail(f"{n} grad30: {d['jacobi_probes']} k-sweep probes, expected one per forward "
                 f"and adjoint momentum solve ({2 * U})")
        if tier == "jac1":
            jac1_schedule_check(f"{n} grad30", j0, jac1_snapshot())
        if any(evals[-1][k] != evals[0][k] for k in ("launches", "loop_counters")):
            fail(f"{n} grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"decaying turbulence {n}, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg_iters_per_step=sum(e["adjoint_pcg_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        adjoint_ratio_passed_max=timed[-1]["adjoint_ratio_passed_max"],
        adjoint_ratio_gated_min=timed[-1]["adjoint_ratio_gated_min"],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
        max_memory_allocated_bytes=max(e["max_memory_allocated_bytes"] for e in timed),
    )), flush=True)
    return fwd, timed[-1]["launches"]


def sweep_stats(d: dict, solves: int) -> dict:
    """The k-sweep tier's work per momentum solve from the loop counters'
    deltas `d` over `solves` solves (empty where the tier did not run):
    probes and trips, sweeps per component (1 a probe, JAC_K a trip) and
    the hand-overs to BiCGSTAB."""
    if not d["jacobi_probes"]:
        return {}
    return dict(sweep_trips_per_solve=d["jacobi_trips"] / solves,
                sweeps_per_solve=(d["jacobi_probes"] + JAC_K * d["jacobi_trips"]) / solves,
                handovers=d["bicgstab_fallbacks"], bicgstab_iterations=d["bicgstab_iterations"])



# -- the k-sweep momentum tier: periodic turbulence at 1024 x 2048 ----------------------
SWEEP_RES = (1024, 2048)  # phase 16: planes past jac1's budget within 8 MiB
SWEEP_BOX = (2 * math.pi, 4 * math.pi)  # square cells: dx = dy = 2 pi / 1024
SWEEP_SMALL = (32, 64)  # 16a: card vs CPU with the tiers forced
SWEEP_SMALL_STEPS = 3
SWEEP_SMALL_P_TOL = 1e-7  # phase 3's and 10a's: decisions away from rounding of tol
# kernels only the k-sweep tier (and, for row 14, a BiCGSTAB hand-over) runs
SWEEP_KERNELS = ("jacobi_sweeps", "stencil_residual")


@contextlib.contextmanager
def forced_sweeps():
    """The k-sweep momentum tier and the folded-update pressure tier on
    every plane (tiers.jac2_eligible, jac1_eligible and pcg2_eligible
    closed, as the CPU tests force them: there is no knob)."""
    from diffpiso_tpu_torch.solvers import tiers

    names = ("jac2_eligible", "jac1_eligible", "pcg2_eligible")
    real = [getattr(tiers, k) for k in names]
    for k in names:
        setattr(tiers, k, lambda *a, **kw: False)
    try:
        yield
    finally:
        for k, fn in zip(names, real):
            setattr(tiers, k, fn)


def residual_check(label, st, b_c, x_c) -> float:
    """Row 14 against its plain version and against the chain it replaces
    (row 7's matvec kernel, the negation of the '-M' operator when negating,
    b - A x through `krylov._axpy`) on each component, forward and
    transposed, negate and not: r and max |r| bit-equal. Returns the max
    abs error."""
    import torch

    from diffpiso_tpu_torch.ops import matvec
    from diffpiso_tpu_torch.ops.stencil_residual import (
        fused_stencil_residual, stencil_residual_plain)
    from diffpiso_tpu_torch.solvers import krylov

    err = 0.0
    for c in range(len(b_c)):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            m = matvec.fused_stencil_matvec(*st_c, x_c[c], transpose)
            for negate in (False, True):
                kr, kn = fused_stencil_residual(*st_c, b_c[c], x_c[c], negate, transpose)
                pr, pn = stencil_residual_plain(*st_c, b_c[c], x_c[c], negate, transpose)
                chain = krylov._axpy(-1.0, -m if negate else m, b_c[c])
                err = max(err, float((kr - pr).abs().max()), float((kr - chain).abs().max()))
                if not (torch.equal(kr, pr) and torch.equal(kr, chain)
                        and float(kn) == float(pn) == float(chain.abs().max())):
                    fail(f"{label} row 14 component {c} transpose={transpose} "
                         f"negate={negate}: not bit-equal to the plain version and the chain")
    print(f"{label} row 14 (fused stencil residual) on faces {[tuple(b.shape) for b in b_c]}, "
          f"both forms, negate and not: bit-equal to plain and to the matvec chain", flush=True)
    return err


def sweeps_kernels(dev, kernels: list) -> dict:
    """Phase 2j: rows 8b and 14 on the card, on the operators of the first
    step of phase 16's run (1024 x 2048 in the (2 pi, 4 pi) box from its
    seeded solenoidal state; b the momentum right-hand side, x0 the
    velocity, the solve's guess): row 8b at k = 1 (the probe) and k = JAC_K
    (a trip from the probe's iterate), forward and transposed, on both
    components, x_k and the norm bit-equal to the plain version; row 14 by
    `residual_check`, then the same on the mixing layer's (129, 512) /
    (128, 513) faces at phase 7's state. At 1024 x 2048: host ms per call,
    device us per launch and launches per call, the bound, the plain
    version and, for row 14, one cuSPARSE CSR addmm (b + M x). Appends
    both kernels' entries to `kernels`; returns row 14's measurements on
    the mixing faces."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.stencil_residual import (
        fused_stencil_residual, stencil_residual_plain)
    from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps, jacobi_sweeps_plain

    domain, sim = decaying_turbulence_setup(SWEEP_RES, box_size=SWEEP_BOX, viscosity=VISCOSITY,
                                            device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = turbulence_step_fn(domain, sim, 0.4 / SWEEP_RES[0])(v, zero, zero, zero,
                                                              full_output=True).intermediates
    st, b_c, x_c = it["stencil"], it["rhs"].components, v.components
    sw_err, norms = 0.0, {}
    for c in range(2):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            x = x_c[c]
            for k in (1, JAC_K):
                before = fused_jacobi_sweeps.launches
                kx, kn = fused_jacobi_sweeps(st_c, b_c[c], x, k, -1.0, transpose)
                if fused_jacobi_sweeps.launches - before != 1:
                    fail(f"row 8b k={k}: {fused_jacobi_sweeps.launches - before} launches, "
                         "expected 1")
                px, pn = jacobi_sweeps_plain(st_c, b_c[c], x, k, -1.0, transpose)
                sw_err = max(sw_err, float((kx - px).abs().max()))
                norms[f"c{c}_T{int(transpose)}_k{k}"] = float(kn)
                if not (torch.equal(kx, px) and float(kn) == float(pn)):
                    fail(f"row 8b component {c} transpose={transpose} k={k}: x_k or the norm "
                         f"not bit-equal to the plain version ({float(kn)!r} vs {float(pn)!r})")
                x = kx  # the trip continues from the probe's iterate
    print(f"{SWEEP_RES} row 8b (k-sweep Jacobi) k = 1 and {JAC_K}, both forms, both components: "
          f"bit-equal to plain; norms after the sweeps {norms}", flush=True)
    res_err = residual_check(f"{SWEEP_RES}", st, b_c, x_c)

    cells = b_c[0].numel()
    st0 = (st.center[0], st.lo[0], st.hi[0])
    # row 8b: 7 planes in (5 coefficients, b, x0), x_k out; per cell the
    # inverse diagonal (2 flops), 13 a sweep, 10 for the exit residual
    probe_b = bound(8 * cells * 4, cells * (2 + 13 + 10))
    trip_b = bound(8 * cells * 4, cells * (2 + 13 * JAC_K + 10))

    def sweeps(k):
        return lambda: fused_jacobi_sweeps(st0, b_c[0], x_c[0], k, -1.0, False)

    def sweeps_plain(k):
        return lambda: jacobi_sweeps_plain(st0, b_c[0], x_c[0], k, -1.0, False)

    kernels.append(dict(
        name="jacobi_sweeps", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi_sweeps.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:558", max_abs_err=sw_err,
        launches_count="kernel launches (one a call: the k sweeps and the norm, a probe "
                       "and a trip alike)",
        shape=list(SWEEP_RES), k=JAC_K, ms=cuda_time_ms(sweeps(JAC_K), 50),
        **device_time(sweeps(JAC_K), 10), plain_ms=cuda_time_ms(sweeps_plain(JAC_K), 10),
        bound_ms=trip_b[0], bound_by=trip_b[1], library_ms=None,
        probe=dict(k=1, ms=cuda_time_ms(sweeps(1), 50), **device_time(sweeps(1), 10),
                   plain_ms=cuda_time_ms(sweeps_plain(1), 10), bound_ms=probe_b[0],
                   bound_by=probe_b[1])))

    # row 14: 7 planes in, r out; per cell 9 flops of the stencil, 1 the
    # subtraction, 1 the |.| max
    b_r, by_r = bound(8 * cells * 4, 11 * cells)
    csr = csr_of_stencil(st0[0], st0[1][0], st0[2][0], st0[1][1], st0[2][1])
    bcol, xcol = b_c[0].reshape(-1, 1), x_c[0].reshape(-1, 1)
    lib = torch.addmm(bcol, csr, xcol).reshape(b_c[0].shape)
    lib_rel = rel_err(lib, stencil_residual_plain(*st0, b_c[0], x_c[0], True)[0])

    def resid():
        return fused_stencil_residual(*st0, b_c[0], x_c[0], True, False)

    kernels.append(dict(
        name="stencil_residual", route="cuda",
        source="diffpiso_tpu_torch/csrc/stencil_residual.cu",
        replaces="diffpiso_tpu/ops/pallas_stencil.py:487", max_abs_err=res_err,
        shape=list(SWEEP_RES), ms=cuda_time_ms(resid, 200), **device_time(resid),
        plain_ms=cuda_time_ms(lambda: stencil_residual_plain(*st0, b_c[0], x_c[0], True), 50),
        bound_ms=b_r, bound_by=by_r,
        # yardstick: b + M x as one cuSPARSE CSR addmm, without the max; the
        # port never calls it
        library_ms=cuda_time_ms(lambda: torch.addmm(bcol, csr, xcol), 50),
        **library_device_time(lambda m=csr: torch.addmm(bcol, m, xcol)),
        library_rel_err=lib_rel))
    del csr

    # row 14 on the mixing layer's faces, on the operators of a step from
    # phase 7's state
    setup, mv, mp, g1, g2, clock = STATES["mixing"]
    it = piso_step(mv, mp, setup.dt, setup.domain, setup.sim,
                   dirichlet_values=setup.dirichlet_values(setup.perturbation(
                       bench_time(clock, setup.dt))),
                   pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=MIX_TOL,
                   pressure_tol=MIX_TOL, full_output=True).intermediates
    mst, mb_c = it["stencil"], it["rhs"].components
    err = residual_check(f"mixing {MIX_RES}", mst, mb_c, mv.components)
    out = {}
    for c in range(2):
        args = ((mst.center[c], mst.lo[c], mst.hi[c]), mb_c[c], mv.components[c])
        n_c = mb_c[c].numel()
        b_m, by_m = bound(8 * n_c * 4, 11 * n_c)

        def fn(args=args):
            return fused_stencil_residual(*args[0], *args[1:], True, False)

        out["mixing_" + "x".join(map(str, mb_c[c].shape))] = dict(
            max_abs_err=err, ms=cuda_time_ms(fn, 200), **device_time(fn),
            plain_ms=cuda_time_ms(lambda args=args: stencil_residual_plain(
                *args[0], *args[1:], True), 50),
            bound_ms=b_m, bound_by=by_m)
    return {"stencil_residual": out}


def sweeps_small_check(dev) -> None:
    """Phase 16a: periodic turbulence at 32 x 64 in the (2 pi, 4 pi) box with
    the k-sweep and folded-update tiers forced (`forced_sweeps`), from one
    seeded solenoidal state: 3 steps and then the 3-step rollout gradient
    ("outputs" remat, from the same state), at pressure tol 1e-7, on the
    card against the plain path on the CPU: equal warn and adjoint gate
    decisions, equal k-sweep probes, trips and hand-overs for the steps and
    for the gradient, the k-sweep kernel launched on the card, the velocity
    within rel l2 1e-5, the gradient within rel l2 1e-3. The other loop
    counters are reported, not compared: the folded update's GEMM sums in
    another order than torch.matmul, so a pressure solve can stop one
    iteration apart within rounding of tol (on the H100: 6 against 7 PCG
    iterations over the 3 steps, velocity 6.3e-8 apart)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps

    res, U = SWEEP_SMALL, SWEEP_SMALL_STEPS
    out = {}
    with forced_sweeps():
        for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
            domain, sim = decaying_turbulence_setup(res, box_size=SWEEP_BOX,
                                                    viscosity=VISCOSITY, device=d)
            v0 = random_solenoidal(domain, torch.Generator().manual_seed(1), device=d)
            p0 = domain.centered_grid(0.0, device=d)
            step = turbulence_step_fn(domain, sim, 0.4 / res[0], SWEEP_SMALL_P_TOL)
            v, p, g1, g2 = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
            launches0, c0, warns = fused_jacobi_sweeps.launches, loop_counters(), []
            for _ in range(U):
                o = step(v, p, g1, g2)
                v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
                warns.append(bool(o.warn))
            c1 = loop_counters()
            f = StaggeredField(tuple(torch.zeros_like(c) for c in v0.components),
                               periodic=(True, True))
            bwd0 = row17_launches()
            r = rollout_loss_grad(step, v0, p0, f, U, remat="outputs")
            row17_check(f"{res[0]}x{res[1]} rollout gradient", d, bwd0, U)
            c2 = loop_counters()
            out[key] = dict(
                v=[c.cpu() for c in v.components], warns=warns + [r.warns],
                steps={k: c1[k] - c0[k] for k in c0}, grad_counters={k: c2[k] - c1[k] for k in c0},
                grad=[c.cpu() for c in r.grad.components],
                decisions=[(a.system, a.gated) for a in r.adjoints],
                launches=fused_jacobi_sweeps.launches - launches0)
    card, cpu = out["card"], out["cpu"]
    v_rel, g_rel = rel_l2(card["v"], cpu["v"]), rel_l2(card["grad"], cpu["grad"])
    print(json.dumps(dict(
        check=f"{res[0]}x{res[1]} x {U} steps and rollout gradient in the k-sweep tier (forced), "
              "card vs CPU plain path",
        step_counters=[card["steps"], cpu["steps"]],
        grad_counters=[card["grad_counters"], cpu["grad_counters"]],
        velocity_rel_l2=v_rel, grad_rel_l2=g_rel, row_8b_launches_card=card["launches"],
        gated=[sum(g for _, g in card["decisions"]), sum(g for _, g in cpu["decisions"]),
               len(cpu["decisions"])])), flush=True)
    sweep_keys = ("jacobi_probes", "jacobi_trips", "bicgstab_fallbacks")
    for key in ("warns", "steps", "grad_counters", "decisions"):
        a, b = card[key], cpu[key]
        if key in ("steps", "grad_counters"):
            a, b = ({k: c[k] for k in sweep_keys} for c in (a, b))
        if a != b:
            fail(f"{res} k-sweep tier card vs CPU: {key} differ, card {a} vs CPU {b}")
    if any(card["warns"]):
        fail(f"{res} k-sweep tier: a step or the gradient warned")
    if not (card["steps"]["jacobi_probes"] == U and card["launches"] > 0):
        fail(f"{res} k-sweep tier: the tier did not run on the card")
    if not v_rel <= 1e-5:
        fail(f"{res} k-sweep tier: card vs CPU velocity rel l2 {v_rel:.3e} > 1e-5")
    if not g_rel <= 1e-3:
        fail(f"{res} k-sweep tier: card vs CPU gradient rel l2 {g_rel:.3e} > 1e-3")

# -- 3-D decaying turbulence (bench.py workload_turb3d) ----------------------------
T3_N = 128  # bench.py workload_turb3d: min(n, 128) at the default n
T3_SMALL = 32  # phase 12a: card vs CPU (bench.py --quick's n)
T3_VISCOSITY = 1e-3  # build_turbulence_3d's default
T3_CALL = 50  # steps per bench.py call
T3_SPINUP_CALLS = 2
T3_TIMED_CALLS = 3
T3_UNROLL = 10  # grad10, remat "none" (bench.py remats from n >= 192 only)
T3_GRAD_REPS = 4
# the 3-D path's kernels; their `launches` come from its forward run
T3_KERNELS = ("advection_assembly3", "div3", "grad3", "stencil_matvec3d", "jacobi1_solve_3d")
# phase 14: the 3-D momentum tiers past the whole solve's budget
T3_BIG = 256  # bench.py workload_turb3d --n3d 256: the z-block tier (bz 8)
T3_BIG_REMAT = "outputs"  # bench.py remats its gradient from 192^3 on
T3_BIG_GRAD_REPS = 3  # bench.py's 4 evaluations: 1 untimed, 3 timed
T3_ZB_SMALL = 64  # 14a: card vs CPU with the z-block tier forced
T3_ZB_SMALL_BZ = 16
T3_HUGE = 512  # 14d: bench.py --n3d 512 --fwd-only, the plane tier
T3_HUGE_CALL = 20  # cut for time: bench.py's calls are 50 steps, 2 spin-up and 3 timed
JAC_K = 4  # sweeps per tier-kernel call (krylov.bicgstab's trip loop)
# launches a call of the tier kernels (solvers/jacobi3d.py): 15e the entry
# residual fused with sweep 0, then one a sweep (at least 2); 15f up to 4
# sweeps a launch
ZB_CALL_LAUNCHES = max(JAC_K, 2)
PL_CALL_LAUNCHES = -(-JAC_K // 4)
# the tier kernels (z block, plane), by the tier that runs them
T3_TIER_KERNELS = {"zblock": "jacobi_zblock_3d", "plane": "jacobi_sweep_3d"}


def turb3d_state(n, dev, seed=0):
    """bench.py build_turbulence_3d's initial state: 0.5 N(0, 1) per
    component from a seeded generator (not solenoidal: the spin-up projects
    it), zero pressure."""
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField

    gen = torch.Generator(device=dev).manual_seed(seed)
    comps = tuple(0.5 * torch.randn((n,) * 3, generator=gen, device=dev) for _ in range(3))
    return StaggeredField(comps, periodic=(True,) * 3), torch.zeros((n,) * 3, device=dev)


def turb3d_step(n, dev):
    """bench.py build_turbulence_3d(n, 1e-6, p_tol=1e-8): the periodic box
    at viscosity 1e-3, dt 0.4/n, advection tol 1e-6, pressure tol 1e-8."""
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup

    domain, sim = decaying_turbulence_setup((n,) * 3, viscosity=T3_VISCOSITY, device=dev)
    return domain, turbulence_step_fn(domain, sim, 0.4 / n)


def turb3d_call(step, v, p, steps=T3_CALL):
    """One bench.py call: `steps` steps, the pressure increments carried as
    guesses from zeros. Returns (v, p, pressure iterations summed, warned
    steps)."""
    import torch

    g1 = g2 = torch.zeros_like(p)
    iters, warns = [0, 0], 0
    for _ in range(steps):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        iters[0] += o.p_iterations[0]
        iters[1] += o.p_iterations[1]
        warns += int(o.warn)
    return v, p, iters, warns


def turb3d_kernels(dev, kernels: list) -> tuple:
    """Phase 2g: the 3-D path's four kernels against their plain versions on
    the card at 128^3, on the operators of a step from the state after
    bench.py's spin-up (2 calls of 50 steps, which phase 12 then times
    from): the advection assembly on that state; div3 of v* and grad3 of
    the first pressure increment, forward and VJP; the 7-point matvec in
    both forms and its VJP on the momentum operator of component 0, and
    forward on the pressure Laplacian; the whole-solve Jacobi forward and
    transposed on all three components (equal sweeps; on component 0 the
    schedule's edges, `jacobi1_edges`). Each must be
    bit-equal or within the stated bound: elementwise volumes within rel
    1e-6 of their scale (8 ulps), Jacobi bit-equal x and residual. Appends
    the four kernels' entries (div3 and grad3 apart) to `kernels`; returns
    the developed state."""
    import torch

    from diffpiso_tpu_torch.ops import fv3, matvec
    from diffpiso_tpu_torch.ops.advassembly import assembly_scalars
    from diffpiso_tpu_torch.ops.advassembly3 import (
        advection_assembly3_plain, fused_advection_assembly3)
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve_3d, jacobi1_3d_plain

    n = T3_N
    domain, step = turb3d_step(n, dev)
    v, p = turb3d_state(n, dev)
    for call in range(T3_SPINUP_CALLS):
        v, p, _, warns = turb3d_call(step, v, p)
        if warns:
            fail(f"{n}^3 spin-up call {call}: {warns} steps warned")
    o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
    it, p1 = o.intermediates, o.pressure_inc1
    vol = n ** 3 * 4
    dx = domain.dx
    beta = dx[0] * dx[1] * dx[2] / (0.4 / n)
    scal = assembly_scalars(dx, T3_VISCOSITY, beta)
    w = v.components
    report = {}

    def compare(name, got, want, bound_rel=1e-6):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        bit = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rel = max(rel_err(a, b) for a, b in zip(got, want))
        report.setdefault(name, []).append(dict(bit_equal=bit, max_abs_err=err, rel_err=rel))
        if not rel <= bound_rel:
            fail(f"{n}^3 {name}: kernel vs plain rel err {rel:.3e} > {bound_rel:g}")
        return err

    # 15a: 3 volumes in, 24 out; ~138 flops per cell
    adv_err = compare("advection_assembly3", fused_advection_assembly3(*w, *scal),
                      advection_assembly3_plain(*w, *scal))
    b_adv, by_adv = bound(27 * vol, 138 * n ** 3)
    kernels.append(dict(
        name="advection_assembly3", route="cuda", source="diffpiso_tpu_torch/csrc/advassembly3.cu",
        replaces="diffpiso_tpu/ops/pallas_advassembly.py:539", max_abs_err=adv_err,
        ms=cuda_time_ms(lambda: fused_advection_assembly3(*w, *scal), 50),
        **device_time(lambda: fused_advection_assembly3(*w, *scal)),
        plain_ms=cuda_time_ms(lambda: advection_assembly3_plain(*w, *scal), 10),
        bound_ms=b_adv, bound_by=by_adv, library_ms=None))

    # 15b on the step's v* and first pressure increment; VJPs: the other
    # kernel with negated factors
    fs = tuple(dx[0] * dx[1] * dx[2] / d for d in dx)
    nfs = tuple(-f for f in fs)
    vs = it["velocity_star"].components

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    div_err = max(compare("div3", fv3.div3(fs, vs), fv3.div3_plain(fs, vs)),
                  compare("div3", vjp(lambda *a: fv3.div3(fs, a), vs, p1),
                          fv3.grad3_plain(nfs, p1)))
    grad_err = max(compare("grad3", fv3.grad3(fs, p1), fv3.grad3_plain(fs, p1)),
                   compare("grad3", vjp(lambda a: fv3.grad3(fs, a), (p1,), vs),
                           fv3.div3_plain(nfs, vs)))
    # div: 3 volumes in, 1 out, 8 flops per cell; grad: 1 in, 3 out, 6 flops
    for name, fn, plain, fl, err, line in (
            ("div3", lambda: fv3.div3(fs, vs), lambda: fv3.div3_plain(fs, vs), 8, div_err, 128),
            ("grad3", lambda: fv3.grad3(fs, p1), lambda: fv3.grad3_plain(fs, p1), 6, grad_err,
             162)):
        b_fv, by_fv = bound(4 * vol, fl * n ** 3)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv3.cu",
            replaces=f"diffpiso_tpu/ops/pallas_fv.py:{line}", max_abs_err=err,
            ms=cuda_time_ms(fn, 100), **device_time(fn), plain_ms=cuda_time_ms(plain, 20),
            bound_ms=b_fv, bound_by=by_fv, library_ms=None))

    # 15c: the momentum operator of component 0 on v** - v* (as explicit_H
    # applies it), both forms and the VJP; the Laplacian on p1 (as the PCG
    # applies it)
    st, lap = it["stencil"], it["laplacian"]
    c0, lo0, hi0 = st.center[0], st.lo[0], st.hi[0]
    x0 = (it["velocity_s2"].components[0] - vs[0]).contiguous()
    mv_err = 0.0
    for transpose in (False, True):
        args = (c0, lo0[0], hi0[0], lo0[1], hi0[1], lo0[2], hi0[2], x0)
        mv_err = max(mv_err, compare("stencil_matvec3d",
                                     matvec.fused_stencil_matvec3d(c0, lo0, hi0, x0, transpose),
                                     matvec.matvec3_plain(*args, transpose)))
        leaves = vjp(lambda x: matvec.fused_stencil_matvec3d(c0, lo0, hi0, x, transpose), (x0,),
                     p1)
        mv_err = max(mv_err, compare("stencil_matvec3d", leaves,
                                     matvec.matvec3_plain(*args[:7], p1, not transpose)))
    lap_args = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1], lap.lo[2], lap.hi[2], p1)
    mv_err = max(mv_err, compare("stencil_matvec3d",
                                 matvec.fused_stencil_matvec3d(lap.center, lap.lo, lap.hi, p1),
                                 matvec.matvec3_plain(*lap_args)))
    b_mv, by_mv = bound(9 * vol, 13 * n ** 3)
    csr = csr_of_stencil3(*lap_args[:7])
    pv = p1.reshape(-1, 1)
    kernels.append(dict(
        name="stencil_matvec3d", route="cuda", source="diffpiso_tpu_torch/csrc/matvec3.cu",
        replaces="diffpiso_tpu/ops/pallas_stencil.py:371", max_abs_err=mv_err,
        ms=cuda_time_ms(lambda: matvec.fused_stencil_matvec3d(lap.center, lap.lo, lap.hi, p1),
                        100),
        **device_time(lambda: matvec.fused_stencil_matvec3d(lap.center, lap.lo, lap.hi, p1)),
        plain_ms=cuda_time_ms(lambda: matvec.matvec3_plain(*lap_args), 20),
        bound_ms=b_mv, bound_by=by_mv,
        # yardstick: one cuSPARSE CSR SpMV of the same operator; the port never calls it
        library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, pv), 50),
        **library_device_time(lazy_call(lambda: csr_of_stencil3(*lap_args[:7]),
                                        lambda m: torch.sparse.mm(m, pv)))))
    del csr

    # 15d on the step's right-hand sides from the developed velocity, each
    # component forward and transposed
    sweeps, jac_err = {}, 0.0
    b_c = it["rhs"].components
    for c in range(3):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            a = (st_c, b_c[c], w[c], -1.0, transpose, ADV_TOL, 33)
            kx, kn, ks = fused_jacobi1_solve_3d(*a)
            px, pn, ps = jacobi1_3d_plain(*a)
            bit = torch.equal(kx, px) and kn == pn
            jac_err = max(jac_err, float((kx - px).abs().max()))
            print(f"{n}^3 jac13d component {c} transpose={transpose}: sweeps kernel {ks} plain "
                  f"{ps}, residual kernel {kn:.3e} plain {pn:.3e}, bit-equal {bit}", flush=True)
            if ks != ps or not bit:
                fail(f"{n}^3 jac13d component {c} transpose={transpose}: kernel and plain "
                     f"differ (sweeps {ks} vs {ps}; bit-equal {bit})")
            sweeps[(c, transpose)] = ks
    st0 = (st.center[0], st.lo[0], st.hi[0])
    jacobi1_edges(f"{n}^3 jac13d", fused_jacobi1_solve_3d, jacobi1_3d_plain, st0, b_c[0], w[0])
    a0 = (st0, b_c[0], w[0], -1.0, False, ADV_TOL, 33)
    sw = sweeps[(0, False)]
    # 9 volumes in (7 coefficients, b, x0), x out; per cell the entry and exit
    # residuals (2 x 15 flops), the inverse diagonal (2) and 18 per sweep
    b_jac, by_jac = bound(10 * vol, n ** 3 * (32 + 18 * sw))
    kernels.append(dict(
        name="jacobi1_solve_3d", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi1_3d.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:1173", max_abs_err=jac_err,
        sweeps=sw, sweeps_per_component={f"{c}{'T' if tr else ''}": s
                                         for (c, tr), s in sweeps.items()},
        launches_count="kernel launches (per component solve: the entry residual fused with "
                       "sweep 0, then one a further sweep: jacobi1.schedule_launches)",
        ms=cuda_time_ms(lambda: fused_jacobi1_solve_3d(*a0), 20),
        **device_time(lambda: fused_jacobi1_solve_3d(*a0), 5),
        plain_ms=cuda_time_ms(lambda: jacobi1_3d_plain(*a0), 5),
        bound_ms=b_jac, bound_by=by_jac, library_ms=None))
    print(json.dumps(dict(check=f"{n}^3 3-D kernels vs plain", results=report)), flush=True)
    return v, p


def csr_of_stencil3(c, lz, hz, ly, hy, lx, hx):
    """The 7-point stencil (roll wrap) as one CSR matrix, for the library
    yardstick of the 7-point matvec (cuSPARSE SpMV); built once, outside
    timing."""
    import torch

    nz, ny, nx = c.shape
    dev = c.device
    idx = torch.arange(nz * ny * nx, device=dev).reshape(nz, ny, nx)
    cols = [idx, torch.roll(idx, 1, 0), torch.roll(idx, -1, 0), torch.roll(idx, 1, 1),
            torch.roll(idx, -1, 1), torch.roll(idx, 1, 2), torch.roll(idx, -1, 2)]
    vals = torch.stack([v.reshape(-1) for v in (c, lz, hz, ly, hy, lx, hx)], 1)
    col = torch.stack([k.reshape(-1) for k in cols], 1)
    crow = torch.arange(0, 7 * idx.numel() + 1, 7, device=dev)
    return torch.sparse_csr_tensor(crow, col.reshape(-1), vals.reshape(-1),
                                   size=(idx.numel(), idx.numel()))


def turb3d_counters() -> dict:
    """The loop counters of the 3-D path: the generic PCG loop's, the
    BiCGSTAB hand-overs and applies, the whole-solve Jacobi's sweeps and
    component solves, and the trip loop's trips and sweeps (the z-block
    and plane tiers)."""
    from diffpiso_tpu_torch.solvers import krylov, pcg3

    b, w = krylov.bicgstab, pcg3.fused_pcg3_solve
    return dict(loop_counters(), jacobi_solves_3d=b.jacobi_solves, jacobi_idle=b.jacobi_idle,
                jacobi_trips=b.jacobi_trips,
                jacobi_block_sweeps=b.jacobi_block_sweeps, pcg3_loops=w.loops,
                pcg3_warm_entries=w.warm_entries, pcg3_iterations=w.iterations)


def turb3d_derived(c0: dict, c1: dict, tier: str = "jac13d") -> tuple:
    """(the 3-D launches the loops derive, counter deltas): the momentum
    tier's kernel (the whole-solve Jacobi as `jacobi1.schedule_launches`
    derives it from the sweeps and the component solves that ran none; per
    trip one call per component, the z-block
    kernel ZB_CALL_LAUNCHES launches a call, the plane kernel
    PL_CALL_LAUNCHES); the 7-point
    matvec three times per BiCGSTAB operator apply (one per component); the
    pressure loop's rank-3 phases (row 10e: the residual once per warm
    entry, reset and finished loop, the apply once per iteration), the
    update (row 10c, on the volume) once per iteration, and the 3-D
    spectral apply (row 16-3d) once per loop, reset and iteration; of
    those, the whole solves of row 15g (the adjoint pressure solves, their
    own counters in `pcg3_*`) launch instead its residual once per warm
    entry, q, xr and p once per iteration, r.z once per loop and
    iteration, row 10e's residual once per loop (the exit check), and row
    16-3d as the loop does (M^-1 r once per loop and iteration)."""
    from diffpiso_tpu_torch.solvers.jacobi1 import schedule_launches

    d = {k: c1[k] - c0[k] for k in c0}
    jac = {"jac13d": ("jacobi1_solve_3d", schedule_launches(d["jacobi_sweeps"], d["jacobi_idle"])),
           "zblock": (T3_TIER_KERNELS["zblock"], 3 * ZB_CALL_LAUNCHES * d["jacobi_trips"]),
           "plane": (T3_TIER_KERNELS["plane"], 3 * PL_CALL_LAUNCHES * d["jacobi_trips"])}[tier]
    l3, w3, i3 = d["pcg3_loops"], d["pcg3_warm_entries"], d["pcg3_iterations"]
    its = d["pcg_iterations"] - i3
    return {jac[0]: jac[1],
            "stencil_matvec3d": 3 * (d["applies"] + d["applies_T"]),
            "pcg_residual3": d["pcg_warm_entries"] - w3 + d["pcg_resets"] + d["pcg_loops"],
            "pcg_apply3": its, "pcg_update": its,
            "spectral_apply3": d["pcg_loops"] + d["pcg_resets"] + d["pcg_iterations"],
            "pcg3_residual": w3, "pcg3_q": i3, "pcg3_xr": i3, "pcg3_p": i3,
            "pcg3_dots": l3 + i3}, d


def tier_solves_ok(d: dict, tier: str, solves: int) -> bool:
    """Whether the counter deltas `d` show `solves` momentum solves of three
    components in `tier`: one whole solve per component (jac13d), or the
    trip loop (at least one trip a solve) and no whole solve."""
    if tier == "jac13d":
        return d["jacobi_solves_3d"] == 3 * solves and d["jacobi_trips"] == 0
    return d["jacobi_solves_3d"] == 0 and d["jacobi_trips"] >= solves


@contextlib.contextmanager
def forced_zblock(bz):
    """The z-block tier at block size bz on every volume (as the CPU tests
    force it: there is no knob), or nothing when bz is None."""
    from diffpiso_tpu_torch.solvers import tiers

    if bz is None:
        yield
        return
    real = tiers.momentum_tier_3d, tiers.zblock_eligible
    tiers.momentum_tier_3d = lambda shapes, dtype="float32": "zblock"
    tiers.zblock_eligible = lambda shape, dtype="float32": bz
    try:
        yield
    finally:
        tiers.momentum_tier_3d, tiers.zblock_eligible = real


# BiCGSTAB's counters: they move only when a Jacobi solve hands over
HANDOVER_COUNTERS = ("bicgstab_fallbacks", "bicgstab_iterations", "applies", "applies_T")


def less_records(counters: dict, records: list, step_solves: int, skip: set,
                 steps: bool) -> dict:
    """`counters` with BiCGSTAB's sums less the records (one value per
    HANDOVER_COUNTERS entry) of the momentum solves in `skip` that fall in
    the steps (`steps`) or in the gradient."""
    out = dict(counters)
    for i in skip:
        if (i < step_solves) == steps:
            for k, v in zip(HANDOVER_COUNTERS, records[i]):
                out[k] -= v
    return out


def turb3d_small_check(dev, n=T3_SMALL, bz=None, remat="none", channels=False,
                       unroll=3) -> None:
    """Phase 12a (and 14a): the 3-D turbulence at n^3 (32^3) from one seeded
    0.5 N(0, 1) state, 3 steps and then the 3-step rollout gradient (under
    `remat`, from the same state), on the card against the plain path on
    the CPU at the main path's tolerances, in the tier the volume takes or,
    with `bz`, in the z-block tier at that block size (14a: 64^3, bz 16,
    remat "outputs"; the caller forces the tier, `forced_zblock`); with
    `channels` the gradient (then `unroll` steps deep: 19a, grad10) runs
    with the adjoint warm-start channels, every pressure adjoint a warm
    whole solve of row 15g: equal
    pressure iterations per step, equal loop counters (PCG loops, warm
    entries, resets, iterations; Jacobi solves, sweeps and trips; BiCGSTAB
    hand-overs and iterations) for the steps and for the
    gradient, equal adjoint gate decisions, the velocity within rtol 2e-4 /
    atol 2e-5, the gradient within rel l2 1e-3.

    Each momentum solve is also recorded on both devices (its Jacobi
    hand-over residual: the largest exit residual of its component solves,
    or the trip loop's last entry residual; and what it added to
    BiCGSTAB's counters: hand-over, iterations, applies in both forms), and
    the records must be equal solve
    by solve. One exception, bounded: a momentum solve whose Jacobi exit
    residual (the largest over its components, the hand-over test) lies
    within 8 ulps of its right-hand side's scale of tol on both devices is
    decided by rounding, and card and CPU may then differ in that hand-over;
    that solve alone leaves the record comparison, and BiCGSTAB's summed
    counters are compared less its records. The adjoint solves sit there by
    construction: their tol is tol x max|g| and their b is g, so tol is 8-17
    ulps of b's scale, and the exit residual b - A x is formed at that
    scale (measured on the H100: one transposed solve at 32^3 handed over on
    the CPU and not on the card, with equal sweeps)."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.solvers import base, krylov

    label = (f"{n}^3" if bz is None else f"{n}^3 z-block bz {bz}") + (
        " with adjoint channels" if channels else "")
    tier = "jac13d" if bz is None else "zblock"
    rng = np.random.RandomState(1)
    comps = [(0.5 * rng.randn(n, n, n)).astype(np.float32) for _ in range(3)]
    res = {}
    real, real_bi = krylov.fused_jacobi1_solve_3d, base.bicgstab
    real_trips = krylov._jacobi_trips
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        jac, trips, bi = [], [], []

        def recorded(st_c, b, x, sgn, transpose, tol, max_sweeps, jac=jac):
            out = real(st_c, b, x, sgn, transpose, tol, max_sweeps)
            jac.append((out[1], float(b.abs().max()), tol))
            return out

        def recorded_trips(tier_, st_cs, rhs, x0_c, sgn, transpose, tol, trips=trips):
            out = real_trips(tier_, st_cs, rhs, x0_c, sgn, transpose, tol)
            trips.append((out[1], max(float(c.abs().max()) for c in rhs), tol))
            return out

        def recorded_bi(*args, bi=bi, **kwargs):
            b0 = loop_counters()
            out = real_bi(*args, **kwargs)
            b1 = loop_counters()
            bi.append(tuple(b1[k] - b0[k] for k in HANDOVER_COUNTERS))
            return out

        krylov.fused_jacobi1_solve_3d, base.bicgstab = recorded, recorded_bi
        krylov._jacobi_trips = recorded_trips
        try:
            t0 = time.perf_counter()
            domain, step = turb3d_step(n, d)
            v0 = StaggeredField(tuple(torch.as_tensor(c, device=d) for c in comps),
                                periodic=(True,) * 3)
            p0 = torch.zeros((n,) * 3, device=d)
            v, p, g1, g2 = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
            c0, iters = turb3d_counters(), []
            for _ in range(3):
                o = step(v, p, g1, g2)
                if o.warn:
                    fail(f"{label} steps on {key}: a solve warned")
                v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
                iters.append(list(o.p_iterations))
            c1, step_solves = turb3d_counters(), len(bi)
            f = StaggeredField(tuple(torch.zeros_like(c) for c in v0.components),
                               periodic=(True,) * 3)
            r = rollout_loss_grad(step, v0, p0, f, unroll, remat=remat,
                                  adjoint_channels=channels)
            c2 = turb3d_counters()
        finally:
            krylov.fused_jacobi1_solve_3d, base.bicgstab = real, real_bi
            krylov._jacobi_trips = real_trips
        if r.warns:
            fail(f"{label} rollout gradient on {key}: {r.warns} steps warned")
        # one momentum solve: (its hand-over residual, its b's scale, tol);
        # in jac13d the largest of its three component solves
        solves = trips if bz is not None else [
            (max(j[0] for j in jac[i:i + 3]), max(j[1] for j in jac[i:i + 3]), jac[i][2])
            for i in range(0, len(jac), 3)]
        if len(solves) != len(bi) or (bz is not None and jac):
            fail(f"{label} on {key}: {len(bi)} momentum solves ran {len(jac)} Jacobi component "
                 f"solves and {len(trips)} trip loops, expected 3 each or one loop each")
        res[key] = dict(
            records=bi, step_solves=step_solves, v=[c.cpu() for c in v.components], iters=iters,
            steps={k: c1[k] - c0[k] for k in c0}, grad_counters={k: c2[k] - c1[k] for k in c0},
            grad=[c.cpu().double() for c in r.grad.components],
            decisions=[(a.system, a.gated) for a in r.adjoints], solves=solves,
            seconds=time.perf_counter() - t0)
    card, cpu = res["card"], res["cpu"]
    err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(card["v"], cpu["v"]))
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(card["grad"], cpu["grad"]))
    den = sum(float(torch.sum(b ** 2)) for b in cpu["grad"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    if len(card["solves"]) != len(cpu["solves"]):
        fail(f"{label} card vs CPU: {len(card['solves'])} vs {len(cpu['solves'])} momentum "
             "solves")
    # hand-overs that differ, each with its residual's distance from tol in
    # ulps of b's scale on both devices
    differing = []
    for i, (a, b) in enumerate(zip(card["solves"], cpu["solves"])):
        if (a[0] < a[2]) != (b[0] < b[2]):
            differing.append(dict(solve=i, ulps=[abs(x[0] - x[2]) / float(np.spacing(
                np.float32(x[1]))) for x in (a, b)]))
    print(json.dumps(dict(
        check=f"{label} x 3 steps and {unroll}-step rollout gradient (remat {remat}), card vs "
              "CPU plain path",
        pressure_iters=[card["iters"], cpu["iters"]], step_counters=[card["steps"], cpu["steps"]],
        grad_counters=[card["grad_counters"], cpu["grad_counters"]],
        handovers_decided_by_rounding=differing, velocity_excess=err, grad_rel_l2=g_rel,
        gated=[sum(g for _, g in card["decisions"]), sum(g for _, g in cpu["decisions"]),
               len(cpu["decisions"])],
        seconds=[card["seconds"], cpu["seconds"]])), flush=True)
    for x in differing:
        if not max(x["ulps"]) <= 8:
            fail(f"{label} card vs CPU: momentum solve {x['solve']} hands over on one device "
                 f"only, {x['ulps']} ulps from tol (more than 8)")
    # every other momentum solve: the same hand-over, BiCGSTAB iterations and
    # applies in both forms on both devices
    skip = {x["solve"] for x in differing}
    for i, (a, b) in enumerate(zip(card["records"], cpu["records"])):
        if i not in skip and a != b:
            fail(f"{label} card vs CPU: momentum solve {i} differs, "
                 f"({', '.join(HANDOVER_COUNTERS)}) card {a} vs CPU {b}")
    for key in ("iters", "steps", "grad_counters", "decisions"):
        a, b = card[key], cpu[key]
        if isinstance(a, dict):
            # BiCGSTAB's sums less the differing solves' records
            a, b = (less_records(x[key], x["records"], x["step_solves"], skip, key == "steps")
                    for x in (card, cpu))
        if a != b:
            fail(f"{label} card vs CPU: {key} differ, card {card[key]} vs CPU {cpu[key]}")
    if not tier_solves_ok(card["steps"], tier, 3):
        fail(f"{label}: the 3 steps' counters {card['steps']} do not show 3 momentum solves "
             f"in the {tier} tier")
    g3 = card["grad_counters"]
    if g3["pcg3_loops"] != 2 * unroll or g3["pcg3_warm_entries"] != (2 * unroll if channels
                                                                     else 0):
        fail(f"{label}: the gradient's pressure adjoints ran {g3['pcg3_loops']} whole solves "
             f"({g3['pcg3_warm_entries']} warm), expected {2 * unroll}"
             f"{' warm' if channels else ' cold'}")
    if not err <= 2e-5:
        fail(f"{label} card steps disagree with the CPU plain path beyond rtol 2e-4, atol 2e-5")
    if not g_rel <= 1e-3:
        fail(f"{label} rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def turb3d_tier_kernels(dev, kernels: list, n: int, tier: str, spinup_calls: int,
                        call_steps: int) -> tuple:
    """Phase 2h: the tier kernel of the momentum solve at n^3 (15e, the z
    block at 256^3 with the JAX gate's bz; 15f, the plane sweeps at 512^3)
    against its plain version on the card, on the operators of the first
    step after bench.py's spin-up (`spinup_calls` calls of `call_steps`
    steps from the seeded 0.5 N(0, 1) state; 14b and 14d time from that
    state): each component forward and transposed, the trip loop's first
    two calls (the second from the first's x, where the z blocks already
    at tol sweep zero times). Each must be bit-equal (x and the entry
    residual; 15e also every block's sweeps). Appends the kernel's entry to
    `kernels`; returns the developed state."""
    import torch

    from diffpiso_tpu_torch.solvers import tiers
    from diffpiso_tpu_torch.solvers.jacobi3d import (
        fused_jacobi_sweep_3d, fused_jacobi_zblock_3d, jacobi_plane3_plain,
        jacobi_zblock3_plain)

    shape = (n,) * 3
    if tiers.momentum_tier_3d([shape] * 3) != tier:
        fail(f"{n}^3: the momentum tier is {tiers.momentum_tier_3d([shape] * 3)}, not {tier}")
    bz = tiers.zblock_eligible(shape)
    domain, step = turb3d_step(n, dev)
    v, p = turb3d_state(n, dev)
    for call in range(spinup_calls):
        v, p, _, warns = turb3d_call(step, v, p, call_steps)
        if warns:
            fail(f"{n}^3 spin-up call {call}: {warns} steps warned")
    o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
    st, b_c = o.intermediates["stencil"], o.intermediates["rhs"].components
    del o
    if tier == "zblock":
        def kernel(st_c, b, x, tr):
            return fused_jacobi_zblock_3d(st_c, b, x, -1.0, tr, ADV_TOL, JAC_K, bz)

        def plain(st_c, b, x, tr):
            return jacobi_zblock3_plain(st_c, b, x, -1.0, tr, ADV_TOL, JAC_K, bz)
    else:
        def kernel(st_c, b, x, tr):
            return fused_jacobi_sweep_3d(st_c, b, x, -1.0, tr, JAC_K)

        def plain(st_c, b, x, tr):
            return jacobi_plane3_plain(st_c, b, x, -1.0, tr, JAC_K)

    name = T3_TIER_KERNELS[tier]
    report, err, block_sweeps = [], 0.0, None
    for c in range(3):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            x = v.components[c].contiguous()
            for trip in (1, 2):
                kout, pout = kernel(st_c, b_c[c], x, transpose), plain(st_c, b_c[c], x, transpose)
                bit = torch.equal(kout[0], pout[0]) and float(kout[1]) == float(pout[1])
                sweeps = [o_[2].tolist() for o_ in (kout, pout)] if tier == "zblock" else None
                err = max(err, float((kout[0] - pout[0]).abs().max()))
                report.append(dict(component=c, transpose=transpose, trip=trip, bit_equal=bit,
                                   entry_residual=[float(kout[1]), float(pout[1])],
                                   block_sweeps=sweeps))
                if not bit or (sweeps and sweeps[0] != sweeps[1]):
                    fail(f"{n}^3 {name} component {c} transpose={transpose} trip {trip}: kernel "
                         f"and plain differ (bit-equal {bit}; sweeps {sweeps})")
                if (c, transpose, trip) == (0, False, 1) and sweeps:
                    block_sweeps = sweeps[0]
                x = kout[0]
                del kout, pout
    print(json.dumps(dict(check=f"{n}^3 {name} vs plain (bz {bz})", results=report)),
          flush=True)
    # timed on component 0's forward first trip; its operands copied, so the
    # step's buffers are freed before the timed path
    ops0 = [t_.clone() for t_ in (st.center[0], *st.lo[0], *st.hi[0], b_c[0])]
    st0 = (ops0[0], tuple(ops0[1:4]), tuple(ops0[4:7]))
    b0, x0 = ops0[7], v.components[0].contiguous().clone()
    del st, b_c
    vol = n ** 3 * 4
    cells = n ** 3
    if tier == "zblock":
        # 9 volumes in (7 coefficients, b, x), x out; per cell the entry
        # residual (15 flops) and per sweep of its block 18 (dlt 2, the
        # update 1, the matvec 13, the residual update 2): this call's sweeps
        swept = sum(block_sweeps) * bz * n * n
        b_k, by_k = bound(10 * vol, 15 * cells + 18 * swept)
        extra = dict(bz=bz, block_sweeps=block_sweeps,
                     launches_count=f"kernel launches (per call: {ZB_CALL_LAUNCHES}, the entry "
                                    "residual fused with sweep 0, then one a sweep)")
    else:
        # 9 volumes in, x out; per cell the z terms and rhs (6 flops), then
        # per sweep the in-plane residual (11) and the update (2)
        b_k, by_k = bound(10 * vol, cells * (6 + 13 * JAC_K))
        extra = dict(launches_count=f"kernel launches (per call: {PL_CALL_LAUNCHES}, "
                                    f"{JAC_K} sweeps in one launch)")
    src, line = ("jacobi_zblock3", 1443) if tier == "zblock" else ("jacobi_plane3", 1315)
    kernels.append(dict(
        name=name, route="cuda", source=f"diffpiso_tpu_torch/csrc/{src}.cu",
        replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}",
        max_abs_err=err, shape=list(shape), **extra,
        ms=cuda_time_ms(lambda: kernel(st0, b0, x0, False), 10),
        **device_time(lambda: kernel(st0, b0, x0, False), 5),
        plain_ms=cuda_time_ms(lambda: plain(st0, b0, x0, False), 3),
        bound_ms=b_k, bound_by=by_k, library_ms=None))
    return v, p


def turb3d_grad_expected(U: int, remat: str, derived: dict) -> dict:
    """The 3-D kernels' launches per grad evaluation of U steps. Remat
    "none": the assembly U; grad3 3U forward + 2U (the div3 VJPs); div3 2U
    forward + 2U (the correctors' grad3 VJPs) + U - 1 (the predictor's: the
    initial pressure carries no gradient); the matvec's explicit_H 3U
    forward + 3U transposed (its VJP). Remat "outputs" replays each step's
    forward but its solves in the backward pass: the assembly 2U, grad3 8U,
    div3 7U - 1, explicit_H 9U. The solves' kernels as the loops' counters
    derive (`derived`: U forward and U transposed momentum solves, 2U warm
    forward pressure loops and 2U adjoint whole solves of row 15g, none
    replayed)."""
    replay = remat == "outputs"
    out = dict(derived, advection_assembly3=(2 if replay else 1) * U,
               grad3=(8 if replay else 5) * U, div3=(7 if replay else 5) * U - 1)
    out["stencil_matvec3d"] = (9 if replay else 6) * U + derived["stencil_matvec3d"]
    return out


def turb3d_path(dev, wrappers: dict, state, n=T3_N, tier="jac13d", remat="none",
                calls=T3_TIMED_CALLS, call_steps=T3_CALL, unroll=T3_UNROLL,
                grad_reps=T3_GRAD_REPS, channels=(False,)) -> tuple:
    """Phases 12b and 12c (and 14b-d): bench.py workload_turb3d at n^3
    (128^3) from the state the spin-up (2 calls of 50 steps) left, in the
    momentum tier the volume takes (`tier`, asserted): `calls` timed calls
    of `call_steps` forward steps, then grad{unroll} under `remat` (1
    untimed and `grad_reps` timed evaluations; none when `grad_reps` is 0),
    every launch counter reset before each and checked after: the 3-D
    assembly once per step, grad3 three and div3 two times, the tier's
    Jacobi kernel and the 7-point matvec as the loops' counters derive
    (plus the matvec's three explicit_H applies per step), every other
    kernel never; row 15g never in the forward, on every pressure adjoint
    in the gradient. The gradient runs once per flag of `channels`
    (without, then with the adjoint warm-start channels: phase 19b-c), and
    with both the gradient with the channels must lie within rel l2 1e-3
    of the one without. Returns (forward launches, grad launches per
    evaluation or None, {flag: grad launches per evaluation})."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.fv import fv_divergence

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: the pressure solves must contract in full float32")
    domain, step = turb3d_step(n, dev)
    v, p = state

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    def check(what, counts, want):
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{n}^3 {what}: {k} launched {counts[k]} times, expected {want.get(k, 0)}")

    reset()
    c0, r0 = turb3d_counters(), rank3_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    # live before the run: the state, and the operands earlier phases keep
    # for their device-time measurement at the end
    held = torch.cuda.memory_allocated()
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        v, p, it, w = turb3d_call(step, v, p, call_steps)
        iters = [iters[0] + it[0], iters[1] + it[1]]
        warns += w
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    derived, d = turb3d_derived(c0, turb3d_counters(), tier)
    r10e = rank3_kernels_check(f"{n}^3 forward", r0, derived, d)
    S = calls * call_steps
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    jacobi = (dict(jacobi_sweeps_per_solve=d["jacobi_sweeps"] / d["jacobi_solves_3d"])
              if tier == "jac13d" else
              dict(momentum_tier=tier, trips_per_solve=d["jacobi_trips"] / S,
                   sweeps_per_trip=d["jacobi_block_sweeps"] / max(d["jacobi_trips"], 1)))
    print(json.dumps(dict(
        workload=f"3-D decaying turbulence {n}^3 (periodic, random IC projected by spin-up), "
                 "forward",
        steps=S, steps_per_sec=S / elapsed,
        pressure_iters_per_step=[iters[0] / S, iters[1] / S], warn_fraction=warns / S,
        **jacobi, bicgstab_fallbacks=d["bicgstab_fallbacks"],
        max_abs_div=float(fv_divergence(v, domain.dx).abs().max()),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        memory_allocated_before_bytes=held, loop_counters=d, launches=fwd,
        row10e_kernel_launches=r10e)), flush=True)
    if not finite:
        fail(f"{n}^3: non-finite state after the forward path")
    if warns:
        fail(f"{n}^3: warn fraction {warns / S} (must be 0)")
    if not tier_solves_ok(d, tier, S):
        fail(f"{n}^3: the counters {d} do not show one momentum solve per step in the {tier} "
             "tier")
    if any(fwd.get(k) for k in PCG3_KERNELS):
        fail(f"{n}^3 forward: row 15g launched ({ {k: fwd.get(k) for k in PCG3_KERNELS} }) on a "
             "forward path")
    # per step: the assembly, three gradients (predictor, both correctors),
    # two divergences, explicit_H's three matvecs
    check("forward", fwd, dict(derived, advection_assembly3=S, grad3=3 * S, div3=2 * S,
                               stencil_matvec3d=3 * S + derived["stencil_matvec3d"]))
    if not grad_reps:
        return fwd, None, {}

    # grad{U} from the developed state; per evaluation U forward and U
    # transposed momentum solves, 2U warm forward pressure loops and 2U
    # adjoint whole solves of row 15g, cold or, with the channels, warm
    # (turb3d_grad_expected)
    U = unroll
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(True,) * 3)
    runs, grads = {}, {}
    for ch in channels:
        evals = []
        tag = " with adjoint channels" if ch else ""
        for rep in range(1 + grad_reps):
            reset()
            c0, r0 = turb3d_counters(), rank3_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rollout_loss_grad(step, v, p, forcing, U, remat=remat, adjoint_channels=ch)
            torch.cuda.synchronize()
            elapsed_g = time.perf_counter() - t0
            counts = read()
            derived, d = turb3d_derived(c0, turb3d_counters(), tier)
            r10e = rank3_kernels_check(f"{n}^3 grad{U}", r0, derived, d)
            p_adj = [a for a in res.adjoints if a.system == "pressure"]
            gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
            evals.append(dict(
                timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
                warn_fraction=res.warns / U,
                pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U
                                         for k in (0, 1)],
                adjoint_pcg_iters_per_step=sum(a.iterations for a in p_adj) / U,
                adjoint_pcg_iters_per_eval=sum(a.iterations for a in p_adj),
                adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                               for s in ("momentum", "pressure")],
                adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj
                                              if not a.gated), default=None),
                adjoint_ratio_gated_min=min((a.residual / a.limit for a in p_adj if a.gated),
                                            default=None),
                row15g_launches={k: counts[k] for k in PCG3_KERNELS},
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                memory_allocated_before_bytes=held, loop_counters=d, launches=counts,
                row10e_kernel_launches=r10e))
            print(json.dumps(dict(turb3d_grad_eval=rep, n=n, channels=ch, **evals[-1])),
                  flush=True)
            if res.warns:
                fail(f"{n}^3 grad{U}{tag}: warn fraction {res.warns / U} (must be 0)")
            if not (gnorm > 0 and gnorm < float("inf")):
                fail(f"{n}^3 grad{U}{tag}: |grad| = {gnorm} (must be finite and > 0)")
            if not tier_solves_ok(d, tier, 2 * U) or d["pcg3_loops"] != 2 * U \
                    or d["pcg3_warm_entries"] != (2 * U if ch else 0):
                fail(f"{n}^3 grad{U}{tag}: not 2U momentum solves in the {tier} tier and 2U "
                     f"{'warm' if ch else 'cold'} adjoint whole solves (row 15g): {d}")
            if not all(counts[k] for k in PCG3_KERNELS if ch or k != "pcg3_residual"):
                fail(f"{n}^3 grad{U}{tag}: a row 15g launch never ran: {evals[-1]['row15g_launches']}")
            check(f"grad{U}{tag}", counts, turb3d_grad_expected(U, remat, derived))
            if any(evals[-1][k] != evals[0][k] for k in ("launches", "loop_counters")):
                fail(f"{n}^3 grad{U}{tag}: an evaluation from the same state counted differently")
        grads[ch] = [c.detach().double() for c in res.grad.components]
        del res
        timed = [e for e in evals if e["timed"]]
        print(json.dumps(dict(
            workload=f"3-D decaying turbulence {n}^3, grad{U} (d sum v^2 / d forcing), remat "
                     f"{remat}{tag}",
            evaluations=len(timed),
            unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
            pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
            adjoint_pcg_iters_per_step=sum(e["adjoint_pcg_iters_per_step"] for e in timed)
            / len(timed),
            adjoint_pcg_iters_per_eval=timed[-1]["adjoint_pcg_iters_per_eval"],
            warn_fraction=max(e["warn_fraction"] for e in timed),
            adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
            adjoint_ratio_passed_max=timed[-1]["adjoint_ratio_passed_max"],
            adjoint_ratio_gated_min=timed[-1]["adjoint_ratio_gated_min"],
            row15g_launches_per_eval=timed[-1]["row15g_launches"],
            max_memory_allocated_bytes=max(e["max_memory_allocated_bytes"] for e in timed),
            memory_allocated_before_bytes=timed[-1]["memory_allocated_before_bytes"],
            grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
        )), flush=True)
        runs[ch] = timed[-1]["launches"]
    if len(grads) == 2:
        g_rel = rel_l2_list(grads[True], grads[False])
        print(json.dumps(dict(check=f"19 {n}^3 grad{U} with vs without adjoint channels",
                              grad_rel_l2=g_rel)), flush=True)
        if not g_rel <= 1e-3:
            fail(f"{n}^3 grad{U}: with vs without the adjoint channels rel l2 {g_rel:.3e} > 1e-3")
    del grads
    return fwd, runs[channels[0]], runs


# -- the batched "auto" regime (runs/ab_batched_512.py; make_batched_train_step) ----------
BAT_N = 512  # runs/ab_batched_512.py: bench.py build_turbulence(512, 1e-6)
BAT_SEEDS = (0, 1, 2, 3)  # batch 4: initial_state(seed=s) for s in range(4)
BAT_CALL = 50  # steps per call
BAT_TIMED_CALLS = 3
BAT_UNROLL = 10  # grad10, remat "none" (the vmapped JAX trace's)
BAT_GRAD_REPS = 3
BAT_PCG_TOL = 1e-7  # 13a: pcg2 batched forward, on right-hand sides of O(dx) content
BAT_SMALL = 128  # 13c: card vs CPU, batch 2, in "auto" forced
BAT_SMALL_STEPS = 3
BAT_LARGE_N = 1024  # 13d: batch 2 of bench.py's turb_1024 planes
BAT_LARGE_SEEDS = (0, 1)
BAT_LARGE_WARMUP = 10
BAT_LARGE_STEPS = 50
BAT_LARGE_UNROLL = 5  # the depth that keeps phase 13 within a few minutes
BAT_LARGE_GRAD_REPS = 2
BAT_TRAIN_RES = (256, 1024)  # 13e: the 257 x 1024 face crosses the 512^2 gate
# 13e's dt: bench.py's 0.4 at 64 x 256 scaled with the grid (its CFL). At dt
# 0.4 the 256 x 1024 layer's pressure solves run to their 2000 iterations and
# the state blows up within 3 steps (|v| 37 -> 5e10, the plain path on the CPU)
BAT_TRAIN_DT = 0.4 * TRAIN_RES[0] / BAT_TRAIN_RES[0]
BAT_TRAIN_B = 2
BAT_TRAIN_REPS = 3
# the batched entries of the kernels line; their `launches` come from 13b's
# forward run (jacobi1_solve_batched: 13d's)
BAT_ENTRIES = ("pcg2_solve_batched", "jacobi2_solve_folded_grid", "advection_assembly_batched",
               "laplace_assembly_batched", "div2_batched", "grad2_batched",
               "stencil_matvec_batched")
# the bounded FV trio's batched entries; their `launches` come from 13e's
# timed train steps
BAT_TRAIN_ENTRIES = ("grad2m_batched", "div2m_batched", "gradT2m_batched")
BAT_WRAPPER = {"jacobi2_solve_folded_grid": "jacobi2_solve_folded",
               "grad2m_batched": "grad2m", "div2m_batched": "div2m",
               "gradT2m_batched": "gradT2m",
               "advection_assembly_batched": "advection_assembly",
               "laplace_assembly_batched": "laplace_assembly", "div2_batched": "div2",
               "grad2_batched": "grad2", "stencil_matvec_batched": "stencil_matvec"}


def batched_turbulence(n, seeds, dev):
    """runs/ab_batched_512.py's batch: bench.py build_turbulence(n, 1e-6)
    (viscosity 1e-4, dt 0.4/n, pressure tol 1e-8, fft_mm) and one seeded
    solenoidal state per sample. Returns (domain, step, velocity, pressure)."""
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_batch, decaying_turbulence_setup

    domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=dev)
    vel, p = decaying_turbulence_batch(domain, seeds, device=dev)
    return domain, turbulence_step_fn(domain, sim, 0.4 / n), vel, p


def batched_counters() -> dict:
    """The batched loops' counters, from which the batched kernels'
    launches follow."""
    from diffpiso_tpu_torch.solvers import krylov

    b = krylov.bicgstab_batched
    return dict(jacobi_solves=b.jacobi_solves, jacobi_sweeps=b.jacobi_sweeps,
                jacobi_schedule=b.jacobi_schedule, fallbacks=b.fallbacks, bicgstab_iterations=b.iterations,
                applies=b.applies[False] + b.applies[True], pcg2_solves=krylov.pcg2_batched.solves,
                pcg2_loops=krylov.pcg2_batched.loops, pcg_applies=krylov.pcg_batched.applies,
                pcg_iterations=krylov.pcg_batched.iterations)


def batched_derived(c0: dict, c1: dict, jac: str) -> tuple:
    """(the batched whole-solve kernels' launches the loops derive, counter
    deltas): per Jacobi solve (`jac`: the joint kernel, or jac1 per
    component) `jacobi2.solve_launches` of its slowest sample's sweeps (the
    loop's `jacobi_schedule`); per pcg2 solve the entry and exit launches
    plus one per iteration of its slowest sample; the matvec kernel once
    per component and BiCGSTAB operator apply and once per generic-PCG
    operator apply."""
    d = {k: c1[k] - c0[k] for k in c0}
    return ({jac: d["jacobi_schedule"],
             "pcg2_solve_batched": 2 * d["pcg2_solves"] + d["pcg2_loops"],
             "stencil_matvec": 2 * d["applies"] + d["pcg_applies"]}, d)


def sample_iters(its) -> list:
    """Per-sample pressure iterations per step, (corrector 1, corrector 2)."""
    return [[float(x) for x in row] for row in its.mean(axis=0).T]


def same_bits(a, b) -> bool:
    """Bit-equal float32 tensors or scalars (a NaN equals the same NaN: a
    diverging Jacobi sample overflows alike in both)."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                                  b.contiguous().view(torch.int32))
    return np.asarray(a, np.float32).view(np.int32).tolist() == \
        np.asarray(b, np.float32).view(np.int32).tolist()


def batched_check(label, got, want_fn, nb) -> None:
    """Every sample of the batched outputs `got` (tensors or arrays with a
    leading batch axis) bit-equal to `want_fn(s)`, the single-sample
    outputs."""
    import numpy as np
    import torch

    for s in range(nb):
        for a, b in zip(got, want_fn(s)):
            if not same_bits(a[s], b):
                fail(f"{label}: sample {s} is not bit-equal to the single-sample launch")


def batched_kernels(dev, kernels: list) -> dict:
    """Phase 13a: the batched kernels on the card against their plain
    versions and the single-sample kernels, on the operators of a step of
    13b's batch (512^2, B = 4, the first step from the seeded states): rows
    1, 2, 5 and 7 with a batch axis (bit-equal per sample to the
    single-sample launch), the joint Jacobi kernel as the grid rule's
    counterpart (forward / transposed, shared / per-sample tol: bit-equal to
    its plain version and per sample to jacobi2.cu, equal sweeps), pcg2
    batched forward (shared tol) and cold adjoint (per-sample tols: equal
    iterations and x within rel 1e-4 of its plain version, bit-equal per
    sample to pcg2.cu); jac1 batched at 1024^2, B = 2 (bit-equal to its
    plain version and to jacobi1.cu per sample, equal sweeps); the joint
    kernel on 13e's 257 x 1024 / 256 x 1025 faces, B = 2; pcg2 batched
    also on variable-coefficient Laplacians at per-sample tols where the
    samples stop at different iterations; the bounded FV trio with a batch
    axis on 13e's planes (bit-equal per sample and to plain). Appends the
    entries; returns the faces' measurements."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops import fv, fv2, fv2m, matvec
    from diffpiso_tpu_torch.ops.advassembly import (
        advection_assembly_plain, assembly_scalars, fused_advection_assembly)
    from diffpiso_tpu_torch.ops.fv import fv_gradient
    from diffpiso_tpu_torch.ops.laplace import assemble_pressure_laplacian, laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver, safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi1 import (
        BATCHED_RUN_LENGTH, fused_jacobi1_solve, fused_jacobi1_solve_batched,
        jacobi1_batched_plain)
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        RUN_LENGTH, fused_jacobi2_solve, fused_jacobi2_solve_folded, jacobi2_fold_plain,
        solve_launches)
    from diffpiso_tpu_torch.solvers.pcg2 import (
        SampleLap, fused_pcg2_solve, fused_pcg2_solve_batched, gemm_batched, pcg2_batched_plain)

    n, nb = BAT_N, len(BAT_SEEDS)
    domain, step, vel, p = batched_turbulence(n, BAT_SEEDS, dev)
    zero = torch.zeros_like(p)
    with regime.batched_regime("auto"):
        it = step(vel, p, zero, zero, full_output=True).intermediates
    dx = domain.dx
    beta = dx[0] * dx[1] / (0.4 / n)
    plane = n * n * 4

    def one(t, s):
        return t[s].contiguous()

    # row 1: the advection assembly
    scal = assembly_scalars(dx, VISCOSITY, beta)
    w0, w1 = vel.components
    k_adv = fused_advection_assembly(w0, w1, *scal)
    batched_check("batched advection assembly", k_adv,
                  lambda s: fused_advection_assembly(one(w0, s), one(w1, s), *scal), nb)
    p_adv = advection_assembly_plain(w0, w1, *scal)
    adv_err = max(float((a - b).abs().max()) for a, b in zip(k_adv, p_adv))
    b_adv, by_adv = bound(nb * 14 * plane, nb * 62 * n * n)
    kernels.append(dict(
        name="advection_assembly_batched", route="cuda",
        source="diffpiso_tpu_torch/csrc/advassembly.cu",
        replaces="diffpiso_tpu/ops/pallas_advassembly.py:189", max_abs_err=adv_err,
        ms=cuda_time_ms(lambda: fused_advection_assembly(w0, w1, *scal), 100),
        **device_time(lambda: fused_advection_assembly(w0, w1, *scal)),
        plain_ms=cuda_time_ms(lambda: advection_assembly_plain(w0, w1, *scal), 20),
        bound_ms=b_adv, bound_by=by_adv, library_ms=None, batch=nb))

    # row 2: the Laplace assembly (masks shared)
    st = it["stencil"]
    sim_masks = laplace_mask_planes(torch.ones(n + 2, n + 2, device=dev),
                                    torch.ones(n + 2, n + 2, device=dev), (True, True), (n, n),
                                    torch.float32)
    infl = [((dx[0] * dx[1] / dx[0] ** 2) / (beta - a)).contiguous() for a in st.diag_A]
    k_lap = fused_laplace_assembly(infl[0], infl[1], sim_masks, (True, True))
    batched_check("batched Laplace assembly", k_lap,
                  lambda s: fused_laplace_assembly(one(infl[0], s), one(infl[1], s), sim_masks,
                                                   (True, True)), nb)
    p_lap = laplace_assembly_plain(infl[0], infl[1], sim_masks, (True, True))
    lap_err = max(float((a - b).abs().max()) for a, b in zip(k_lap[:5], p_lap[:5]))
    b_lap, by_lap = bound(nb * 15 * plane + 4 * nb, nb * 12 * n * n)
    kernels.append(dict(
        name="laplace_assembly_batched", route="cuda",
        source="diffpiso_tpu_torch/csrc/laplace_assembly.cu",
        replaces="diffpiso_tpu/ops/pallas_assembly.py:136", max_abs_err=lap_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(infl[0], infl[1], sim_masks,
                                                       (True, True)), 100),
        **device_time(lambda: fused_laplace_assembly(infl[0], infl[1], sim_masks,
                                                     (True, True))),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(infl[0], infl[1], sim_masks,
                                                             (True, True)), 20),
        bound_ms=b_lap, bound_by=by_lap, library_ms=None, batch=nb))

    # row 5: div2 / grad2 on v* and on the divergence plane
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    vs0, vs1 = (c.contiguous() for c in it["velocity_star"].components)
    pp = it["v1_div"].contiguous()
    k_div, k_grad = fv2.div2(fs, (vs0, vs1)), fv2.grad2(fs, pp)
    batched_check("batched div2", (k_div,), lambda s: (fv2.div2(fs, (one(vs0, s), one(vs1, s))),),
                  nb)
    batched_check("batched grad2", k_grad, lambda s: fv2.grad2(fs, one(pp, s)), nb)
    div_err = float((k_div - fv2.div2_plain(fs, (vs0, vs1))).abs().max())
    grad_err = max(float((a - b).abs().max()) for a, b in zip(k_grad, fv2.grad2_plain(fs, pp)))
    for name, fn, plain, fl, err in (
        ("div2_batched", lambda: fv2.div2(fs, (vs0, vs1)),
         lambda: fv2.div2_plain(fs, (vs0, vs1)), 5, div_err),
        ("grad2_batched", lambda: fv2.grad2(fs, pp), lambda: fv2.grad2_plain(fs, pp), 4,
         grad_err),
    ):
        b_fv, by_fv = bound(nb * 3 * plane, nb * fl * n * n)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2.cu",
            replaces=("diffpiso_tpu/ops/pallas_fv.py:225" if name == "div2_batched"
                      else "diffpiso_tpu/ops/pallas_fv.py:260"),
            max_abs_err=err, ms=cuda_time_ms(fn, 100), plain_ms=cuda_time_ms(plain, 20),
            **device_time(fn), bound_ms=b_fv, bound_by=by_fv, library_ms=None, batch=nb))

    # row 7: the matvec on the x-velocity's operator, both forms
    st0 = (st.center[0].contiguous(), tuple(a.contiguous() for a in st.lo[0]),
           tuple(a.contiguous() for a in st.hi[0]))
    mv_err = 0.0
    for transpose in (False, True):
        k_mv = matvec.fused_stencil_matvec(*st0, vs0, transpose)
        batched_check(f"batched matvec transpose={transpose}", (k_mv,),
                      lambda s: (matvec.fused_stencil_matvec(
                          one(st0[0], s), tuple(one(a, s) for a in st0[1]),
                          tuple(one(a, s) for a in st0[2]), one(vs0, s), transpose),), nb)
        mv_err = max(mv_err, float((k_mv - matvec.matvec_plain(
            st0[0], st0[1][0], st0[2][0], st0[1][1], st0[2][1], vs0, transpose)).abs().max()))
    b_mv, by_mv = bound(nb * 7 * plane, nb * 9 * n * n)
    kernels.append(dict(
        name="stencil_matvec_batched", route="cuda", source="diffpiso_tpu_torch/csrc/matvec.cu",
        replaces="diffpiso_tpu/ops/pallas_stencil.py:188", max_abs_err=mv_err,
        ms=cuda_time_ms(lambda: matvec.fused_stencil_matvec(*st0, vs0), 100),
        **device_time(lambda: matvec.fused_stencil_matvec(*st0, vs0)),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(st0[0], st0[1][0], st0[2][0],
                                                          st0[1][1], st0[2][1], vs0), 20),
        bound_ms=b_mv, bound_by=by_mv, library_ms=None, batch=nb))
    print(f"batched plane kernels (B={nb}, {n}^2): advection assembly, Laplace assembly, "
          f"div2 / grad2, matvec both forms bit-equal per sample to their single-sample "
          f"launches; max abs err vs plain {adv_err:.3e}, {lap_err:.3e}, {div_err:.3e} / "
          f"{grad_err:.3e}, {mv_err:.3e}", flush=True)
    if max(adv_err, div_err, grad_err, mv_err) != 0.0:
        fail("a batched elementwise kernel differs from its plain version")

    def fold_checks(label, st_cs, b_c, x_c, per_tol, tol):
        """The joint kernel on B samples against its plain version and the
        single-sample jac2 kernel per sample, forward and transposed,
        shared and per-sample tol. Returns (max abs err, rows)."""
        nbs = b_c[0].shape[0]
        err, rows = 0.0, []
        for transpose in (False, True):
            for tl in (tol, per_tol):
                l0 = fused_jacobi2_solve_folded.launches
                kx0, kx1, kn, ks = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, transpose,
                                                              tl, 33)
                launched = fused_jacobi2_solve_folded.launches - l0
                px0, px1, pn, ps = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, tl, 33)
                same = (same_bits(kx0, px0) and same_bits(kx1, px1) and same_norm(kn, pn)
                        and np.array_equal(ks, ps)
                        and launched == solve_launches(int(ks.max()), 33, RUN_LENGTH))
                tols = np.broadcast_to(np.asarray(tl, np.float32), (nbs,))
                single = True
                for s in range(nbs):
                    o = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi))
                         for c, lo, hi in st_cs]
                    z0, z1, zn, zs = fused_jacobi2_solve(o, tuple(b[s] for b in b_c),
                                                         tuple(x[s] for x in x_c), -1.0,
                                                         transpose, float(tols[s]), 33)
                    single &= (same_bits(kx0[s], z0) and same_bits(kx1[s], z1)
                               and same_norm(kn[s], zn) and int(ks[s]) == zs)
                for k, q in ((kx0, px0), (kx1, px1)):  # over the finite cells
                    d = (k - q)[torch.isfinite(k) & torch.isfinite(q)]
                    err = max(err, float(d.abs().max()) if d.numel() else 0.0)
                rows.append(dict(transpose=transpose, per_sample_tol=not np.isscalar(tl),
                                 sweeps=ks.tolist(), kernel_launches=launched,
                                 bit_equal_plain=same, bit_equal_single_sample_kernel=single))
                print(f"jac2 grid rule ({label}) transpose={transpose} per-sample tol="
                      f"{not np.isscalar(tl)}: sweeps {ks.tolist()}, {launched} kernel launches, "
                      f"bit-equal to plain {same}, to {nbs} single-sample kernels {single}",
                      flush=True)
                if not (same and single):
                    fail(f"jac2 grid rule ({label}) transpose={transpose}: not bit-equal to "
                         f"its plain version and the single-sample kernel per sample, or not "
                         f"the schedule's launches")
            batch_edges(f"jac2 grid rule ({label}) transpose={transpose}",
                        *fold_edge_calls(st_cs, x_c, transpose), b_c, tol, RUN_LENGTH)
        return err, rows

    def fold_entry(label, st_cs, b_c, x_c, err, rows):
        _, _, _, sw = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
        nbs = b_c[0].shape[0]
        cells = [b.numel() for b in b_c]
        flops = sum(c / nbs * float(np.sum(2 + 22 + 13 * sw)) for c in cells)
        b_f, by_f = bound(sum(8 * 4 * c for c in cells), flops)
        fn = lambda: fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
        return dict(max_abs_err=err, ms=cuda_time_ms(fn, 20), **device_time(fn, 5),
                    plain_ms=cuda_time_ms(lambda: jacobi2_fold_plain(st_cs, b_c, x_c, -1.0,
                                                                     False, ADV_TOL, 33), 5),
                    bound_ms=b_f, bound_by=by_f, library_ms=None, batch=nbs,
                    sweeps=sw.tolist(), checks=rows, shapes=label)

    st_cs = [(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)]
    b_c = tuple(c.contiguous() for c in it["rhs"].components)
    x_c = tuple(c.contiguous() for c in vel.components)
    per_tol = np.asarray([1e-4, 1e-5, 1e-6, 3e-7], np.float32)
    err, rows = fold_checks(f"{n}^2, B={nb}", st_cs, b_c, x_c, per_tol, ADV_TOL)
    kernels.append(dict(
        name="jacobi2_solve_folded_grid", route="cuda",
        source="diffpiso_tpu_torch/csrc/jacobi2_fold.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:861",
        launches_count="kernel launches (per solve: jacobi2.solve_launches of the slowest "
                       "sample's sweeps)",
        **fold_entry(f"{n}x{n}", st_cs, b_c, x_c, err, rows)))

    # pcg2 batched: forward (shared tol, cold) and cold adjoint (per-sample
    # tols), on the step's Laplacians with right-hand sides of O(dx) content:
    # the divergence of each state plus seeded noise (the step's own is at
    # rounding level from solenoidal states, where the iteration a solve
    # stops at depends on the summation order, as at 1024^2, phase 10a)
    lap = it["laplacian"]
    gen = torch.Generator(device=dev).manual_seed(13)
    noisy = tuple(c + 0.1 * torch.randn(c.shape, generator=gen, device=dev)
                  for c in vel.components)
    rhs = fv2.div2_plain(fs, noisy).contiguous()
    mss = MatmulSpectralSolver(kinds=("fourier", "fourier"), shape=(n, n))
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    weights = tuple(torch.mean(torch.abs(a), dim=(-2, -1)) for a in lap.lo)
    sym = safe_symbol(mss, weights, torch.float32, dev).contiguous()
    # The step's Laplacians are so near constant-coefficient that the
    # spectral preconditioner solves them in one iteration; so a third case
    # runs per-sample variable-coefficient Laplacians (seeded influence
    # planes in [0.5, 1.5)) with O(1) mean-free right-hand sides and
    # per-sample tols, where the samples stop at different iterations and
    # the loop exits per sample and freezes the finished ones
    vgen = torch.Generator(device=dev).manual_seed(17)
    ones = torch.ones(n + 2, n + 2, device=dev)
    lap_v = assemble_pressure_laplacian(
        StaggeredField(tuple(0.5 + torch.rand((nb, n, n), generator=vgen, device=dev)
                             for _ in range(2)), (True, True)), ones, ones, (True, True), True)
    rhs_v = torch.randn((nb, n, n), generator=vgen, device=dev)
    rhs_v = (rhs_v - rhs_v.mean(dim=(1, 2), keepdim=True)).contiguous()
    sym_v = safe_symbol(mss, tuple(torch.mean(torch.abs(a), dim=(-2, -1)) for a in lap_v.lo),
                        torch.float32, dev).contiguous()
    pcg_rows, pcg_err, kk_fwd = [], 0.0, None
    for mode, lp, rh, sy, tol in (
            ("forward", lap, rhs, sym, BAT_PCG_TOL),
            ("adjoint", lap, rhs, sym, np.asarray([3e-5, 1e-5, 3e-6, 1e-6], np.float32)),
            ("adjoint, variable coefficients", lap_v, rhs_v, sym_v,
             np.asarray([3e-3, 1e-3, 3e-4, 1e-4], np.float32))):
        kx, krn, kk = fused_pcg2_solve_batched(lp, rh, None, v0, v0t, v1, v1t, sy, tol, 1000)
        px, prn, pk = pcg2_batched_plain(lp, rh, None, v0, v1, sy, tol, 1000)
        rel = max(rel_err(kx[s], px[s]) for s in range(nb))
        tols = np.broadcast_to(np.asarray(tol, np.float32), (nb,))
        single = True
        for s in range(nb):
            sx, srn, sk = fused_pcg2_solve(SampleLap(lp, s), one(rh, s), None, v0, v0t, v1,
                                           v1t, one(sy, s), float(tols[s]), 1000)
            single &= same_bits(kx[s], sx) and same_bits(krn[s], srn) and int(kk[s]) == sk
        pcg_err = max(pcg_err, float((kx - px).abs().max()))
        pcg_rows.append(dict(mode=mode, iterations=kk.tolist(), plain_iterations=pk.tolist(),
                             x_rel_err=rel, bit_equal_single_sample_kernel=single))
        print(f"pcg2 batched ({mode}, B={nb}, {n}^2): iterations kernel {kk.tolist()} plain "
              f"{pk.tolist()}, x rel err {rel:.3e}, bit-equal to {nb} single-sample kernels "
              f"{single}", flush=True)
        if not np.array_equal(kk, pk):
            fail(f"pcg2 batched ({mode}): iteration counts differ from the plain version")
        if not rel <= 1e-4:
            fail(f"pcg2 batched ({mode}): x rel err {rel:.3e} > 1e-4")
        if not single:
            fail(f"pcg2 batched ({mode}): not bit-equal to the single-sample kernel per sample")
        if mode == "forward":
            kk_fwd = kk
    if len(set(pcg_rows[-1]["iterations"])) < 2:
        fail("pcg2 batched (variable coefficients): every sample stopped at the same iteration, "
             "so the per-sample exit and freeze went unchecked")
    g_rel = max(rel_err(gemm_batched(v0, rhs)[s], v0 @ rhs[s]) for s in range(nb))
    if not g_rel <= 1e-5:
        fail(f"batched GEMM vs torch.matmul: rel err {g_rel:.3e} > 1e-5")
    # operations: each sample's iterations of 4 n^3 GEMMs (8 n^3 flops) and
    # ~30 flops a cell, 24 a cell for the entry and exit residuals; bytes:
    # 11 planes a sample
    b_pcg, by_pcg = bound(nb * 11 * plane, float(np.sum(kk_fwd)) * (8.0 * n ** 3 + 30 * n * n)
                          + nb * 24 * n * n)
    fwd = lambda: fused_pcg2_solve_batched(lap, rhs, None, v0, v0t, v1, v1t, sym, BAT_PCG_TOL,
                                           1000)
    v0b = v0.expand(nb, n, n)
    kernels.append(dict(
        name="pcg2_solve_batched", route="cuda", source="diffpiso_tpu_torch/csrc/pcg2.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:2333",
        launches_count="host-loop launches (per solve: entry residual, one per iteration of "
                       "the slowest sample, exit residual)",
        max_abs_err=pcg_err, ms=cuda_time_ms(fwd, 10), **device_time(fwd, 3),
        plain_ms=cuda_time_ms(lambda: pcg2_batched_plain(lap, rhs, None, v0, v1, sym,
                                                         BAT_PCG_TOL, 1000), 3),
        single_sample_ms_x_batch=nb * cuda_time_ms(
            lambda: fused_pcg2_solve(SampleLap(lap, 0), one(rhs, 0), None, v0, v0t, v1, v1t,
                                     one(sym, 0), BAT_PCG_TOL, 1000), 5),
        bound_ms=b_pcg, bound_by=by_pcg,
        # yardstick: one batched cuBLAS product of the first contraction over
        # the batch; the port never calls it
        library_ms=cuda_time_ms(lambda: torch.bmm(v0b, rhs), 100),
        gemm_batched_ms=cuda_time_ms(lambda: gemm_batched(v0, rhs), 100),
        batch=nb, iterations=kk_fwd.tolist(), checks=pcg_rows))

    # jac1 batched at 1024^2, B = 2
    nl = BAT_LARGE_N
    _, step_l, vel_l, p_l = batched_turbulence(nl, BAT_LARGE_SEEDS, dev)
    zl = torch.zeros_like(p_l)
    with regime.batched_regime("auto"):
        itl = step_l(vel_l, p_l, zl, zl, full_output=True).intermediates
    stl, b_l = itl["stencil"], itl["rhs"].components
    nbl = len(BAT_LARGE_SEEDS)
    j1_err, j1_rows, j1_sweeps = 0.0, [], None
    for c in range(2):
        stc = (stl.center[c].contiguous(), tuple(a.contiguous() for a in stl.lo[c]),
               tuple(a.contiguous() for a in stl.hi[c]))
        bc, xc = b_l[c].contiguous(), vel_l.components[c].contiguous()
        for transpose in (False, True):
            for tl in (ADV_TOL, np.asarray([1e-5, 1e-6], np.float32)):
                l0 = fused_jacobi1_solve_batched.launches
                kx, kn, ks = fused_jacobi1_solve_batched(stc, bc, xc, -1.0, transpose, tl, 33)
                launched = fused_jacobi1_solve_batched.launches - l0
                px, pn, ps = jacobi1_batched_plain(stc, bc, xc, -1.0, transpose, tl, 33)
                same = (same_bits(kx, px) and same_norm(kn, pn) and np.array_equal(ks, ps)
                        and launched == solve_launches(int(ks.max()), 33, BATCHED_RUN_LENGTH))
                tols = np.broadcast_to(np.asarray(tl, np.float32), (nbl,))
                single = True
                for s in range(nbl):
                    o = (stc[0][s], tuple(a[s] for a in stc[1]), tuple(a[s] for a in stc[2]))
                    zx, zn, zs = fused_jacobi1_solve(o, bc[s], xc[s], -1.0, transpose,
                                                     float(tols[s]), 33)
                    single &= same_bits(kx[s], zx) and same_norm(kn[s], zn) and int(ks[s]) == zs
                j1_err = max(j1_err, float((kx - px).abs().max()))
                j1_rows.append(dict(component=c, transpose=transpose,
                                    per_sample_tol=not np.isscalar(tl), sweeps=ks.tolist(),
                                    kernel_launches=launched, bit_equal_plain=same,
                                    bit_equal_single_sample_kernel=single))
                print(f"jac1 batched ({nl}^2, B={nbl}) component {c} transpose={transpose} "
                      f"per-sample tol={not np.isscalar(tl)}: sweeps {ks.tolist()}, {launched} "
                      f"kernel launches, bit-equal to plain {same}, to {nbl} single-sample "
                      f"kernels {single}", flush=True)
                if not (same and single):
                    fail(f"jac1 batched component {c} transpose={transpose}: not bit-equal to "
                         f"its plain version and the single-sample kernel per sample, or not "
                         f"the schedule's launches")
                if c == 0 and not transpose and np.isscalar(tl):
                    j1_sweeps = ks
            batch_edges(f"jac1 batched ({nl}^2, B={nbl}) component {c} transpose={transpose}",
                        *jac1b_edge_calls(stc, xc, transpose), (bc,), ADV_TOL,
                        BATCHED_RUN_LENGTH)
    stc = (stl.center[0].contiguous(), tuple(a.contiguous() for a in stl.lo[0]),
           tuple(a.contiguous() for a in stl.hi[0]))
    j1 = (stc, b_l[0].contiguous(), vel_l.components[0].contiguous(), -1.0, False, ADV_TOL, 33)
    cells = nl * nl
    b_j1, by_j1 = bound(nbl * 8 * cells * 4, cells * float(np.sum(2 + 22 + 13 * j1_sweeps)))
    kernels.append(dict(
        name="jacobi1_solve_batched", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi1.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:1012",
        launches_count="kernel launches (per component solve: jacobi2.solve_launches of the "
                       "slowest sample's sweeps at jacobi1.BATCHED_RUN_LENGTH)",
        max_abs_err=j1_err, ms=cuda_time_ms(lambda: fused_jacobi1_solve_batched(*j1), 20),
        **device_time(lambda: fused_jacobi1_solve_batched(*j1), 5),
        plain_ms=cuda_time_ms(lambda: jacobi1_batched_plain(*j1), 5),
        bound_ms=b_j1, bound_by=by_j1, library_ms=None, batch=nbl, sweeps=j1_sweeps.tolist(),
        checks=j1_rows))

    # the joint kernel on 13e's faces (257 x 1024, 256 x 1025), B = 2
    setup = training_setup(BAT_TRAIN_RES, dev, BAT_TRAIN_DT)
    cfg = training_cfg(remat="none")
    tvel, tp, _, tpe = training_frames(setup, cfg, BAT_TRAIN_B)
    tdx = setup.domain.dx
    tbeta = tdx[0] * tdx[1] / setup.dt
    sim = setup.sim
    tst = assemble_advection_stencil(tvel, tdx, setup.domain.velocity_pad_modes(),
                                     sim.viscosity, tbeta, sim.dirichlet_mask, sim.active_mask,
                                     sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
                                     uniform=False)
    dv = setup.dirichlet_values(tpe[:, 0])
    trhs = tvel * tbeta - fv_gradient(tp, tdx, setup.domain.pressure_pad_modes(),
                                      sim.accessible_mask)
    tb_c = tuple(torch.where(dm, -d, r).contiguous() for dm, d, r in zip(
        sim.dirichlet_mask.components, dv.components, trhs.components))
    tst_cs = [(tst.center[i].contiguous(), tuple(a.contiguous() for a in tst.lo[i]),
               tuple(a.contiguous() for a in tst.hi[i])) for i in range(2)]
    tx_c = tuple(c.contiguous() for c in tvel.components)
    err, rows = fold_checks(f"{BAT_TRAIN_RES}, B={BAT_TRAIN_B}", tst_cs, tb_c, tx_c,
                            np.asarray([1e-5, 1e-7], np.float32), TRAIN_TOL)
    faces = "x".join(map(str, tb_c[0].shape[1:])) + "," + "x".join(map(str, tb_c[1].shape[1:]))
    measured = {"jacobi2_solve_folded_grid": {"training_faces": fold_entry(
        faces, tst_cs, tb_c, tx_c, err, rows)}}

    # row 12: the bounded FV trio with a batch axis on 13e's planes (the
    # pressure (B, 256, 1024), its 257 x 1024 / 256 x 1025 faces, the face
    # masks shared), bit-equal per sample to the single-sample launch and
    # to the plain version
    nb_t = BAT_TRAIN_B
    per = tuple(sim.bool_periodic)
    tfs = (tdx[0] * tdx[1] / tdx[0], tdx[0] * tdx[1] / tdx[1])
    rep = tuple((lo != "zero", hi != "zero") for lo, hi in setup.domain.pressure_pad_modes())
    fmasks = tuple(m.to(torch.float32).contiguous()
                   for m in fv._face_masks(sim.accessible_mask, per, 2))
    tpc = tp.contiguous()
    nyc, nxc = tpc.shape[-2:]
    cell, fcells = nyc * nxc, tx_c[0][0].numel() + tx_c[1][0].numel()
    trio_errs = []
    for name, key, fn, plain, by, fl, line in (
        # p and the two shared face masks in, two face planes out; 3 flops a face
        ("grad2m_batched", "grad2m", lambda p, c: fv2m.grad2m(tfs, per, rep, p, fmasks),
         lambda p, c: fv2m.grad2m_plain(tfs, per, rep, p, fmasks),
         4 * (nb_t * (cell + fcells) + fcells), 3 * nb_t * fcells, 376),
        # two face planes in, one cell plane out; 5 flops a cell
        ("div2m_batched", "div2m", lambda p, c: (fv2m.div2m(tfs, per, c),),
         lambda p, c: (fv2m.div2m_plain(tfs, per, c),), 4 * nb_t * (fcells + cell),
         5 * nb_t * cell, 333),
        # two cotangent planes and the two shared masks in, one cell plane out; 7 flops a cell
        ("gradT2m_batched", "gradT2m", lambda p, c: (fv2m.gradT2m(tfs, per, rep, c, fmasks),),
         lambda p, c: (fv2m.gradT2m_plain(tfs, per, rep, c, fmasks),),
         4 * (nb_t * (fcells + cell) + fcells), 7 * nb_t * cell, 417),
    ):
        got = fn(tpc, tx_c)
        batched_check(f"batched {key}", got,
                      lambda s, fn=fn: fn(one(tpc, s), tuple(one(c, s) for c in tx_c)), nb_t)
        e = max(float((a - b).abs().max()) for a, b in zip(got, plain(tpc, tx_c)))
        trio_errs.append(e)
        b_t, by_t = bound(by, fl)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2m.cu",
            replaces=f"diffpiso_tpu/ops/pallas_fv.py:{line}", max_abs_err=e,
            ms=cuda_time_ms(lambda fn=fn: fn(tpc, tx_c), 100),
            **device_time(lambda fn=fn: fn(tpc, tx_c)),
            plain_ms=cuda_time_ms(lambda plain=plain: plain(tpc, tx_c), 20),
            bound_ms=b_t, bound_by=by_t, library_ms=None, batch=nb_t, shape=[nyc, nxc]))
    print(f"batched bounded FV trio (B={nb_t}, {nyc}x{nxc}, shared face masks): grad2m, div2m, "
          f"gradT2m bit-equal per sample to their single-sample launches; max abs err vs plain "
          f"{trio_errs}", flush=True)
    if max(trio_errs) != 0.0:
        fail("a batched bounded FV kernel differs from its plain version")
    return measured


def batched_paths(dev, wrappers: dict) -> dict:
    """Phases 13b-13d: the batched turbulence rows in the "auto" regime the
    size rule picks. 13b: runs/ab_batched_512.py's forward at 512^2, B = 4
    (seeds 0-3): one untimed and 3 timed calls of 50 steps (guesses from
    zeros each call), counters reset before the timed ones: the plane
    kernels with a batch axis once (assemblies), 3 (grad2) and 2 (div2)
    times per step, the matvec 2 per step (explicit_H) plus its hand-over
    and loop applies, the joint Jacobi kernel (the grid rule) and pcg2
    batched as the loops' counters derive; 0 launches of the corrector,
    the PCG and BiCGSTAB phases, the folded update and every single-sample
    whole solve. 13c: grad10 of sum_c mean(v_c^2) over the batch with
    respect to the batched initial velocity (remat "none"), 1 untimed and 3
    timed evaluations, counts per evaluation; then batch 2 at 128^2 in
    "auto" card vs the CPU plain path (3 steps, the path's loss and
    sum_c sum(v_c^2), under which pressure adjoints gate: equal gate
    decisions, gradient rel l2 <= 1e-3). 13d: batch 2 at 1024^2: 10 warm-up and 50
    timed forward steps and grad5 (1 untimed and 2 timed): jac1 batched per
    component, the generic PCG loop (matvec applies), no pcg2, no fold, no
    folded update. Returns each run's launches."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.core.rollout import batched_rollout, batched_rollout_loss_grad
    from diffpiso_tpu_torch.ops.fv import fv_divergence

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    def check(what, counts, want):
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{what}: {k} launched {counts[k]} times, expected {want.get(k, 0)}")

    def forward(label, step, domain, vel, p, calls, steps, jac):
        nb = p.shape[0]
        reset()
        c0 = batched_counters()
        torch.cuda.reset_peak_memory_stats()
        its, warns = [], np.zeros(nb, dtype=np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            out = batched_rollout(step, vel, p, steps)
            vel, p = out.velocity, out.pressure
            its.append(out.p_iterations)
            warns += out.warns
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read()
        derived, d = batched_derived(c0, batched_counters(), jac)
        S = calls * steps
        finite = all(bool(torch.isfinite(c).all()) for c in vel.components) \
            and bool(torch.isfinite(p).all())
        with regime.batched_regime("auto"):
            div = float(fv_divergence(vel, domain.dx).abs().max())
        print(json.dumps(dict(
            workload=f"{label}, forward", batch=nb, steps=S,
            sample_steps_per_sec=S * nb / elapsed, steps_per_sec=S / elapsed,
            pressure_iters_per_step_per_sample=sample_iters(np.concatenate(its)),
            warn_steps_per_sample=warns.tolist(), bicgstab_fallback_samples=d["fallbacks"],
            jacobi_sweeps_per_solve=d["jacobi_sweeps"] / max(d["jacobi_solves"], 1),
            max_abs_div=div, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            loop_counters=d, launches=counts)), flush=True)
        if not finite:
            fail(f"{label}: non-finite state after the forward path")
        if warns.any():
            fail(f"{label}: a sample warned ({warns.tolist()} steps)")
        return vel, p, counts, derived, d, S

    def grad(label, step, vel, p, unroll, reps, want_fn):
        nb = p.shape[0]
        evals = []
        for rep in range(1 + reps):
            reset()
            c0 = batched_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batched_rollout_loss_grad(step, vel, p, unroll)
            torch.cuda.synchronize()
            elapsed_g = time.perf_counter() - t0
            counts = read()
            derived, d = batched_derived(c0, batched_counters(), want_fn.jac)
            p_adj = [a for a in res.adjoints if a.system == "pressure"]
            gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
            evals.append(dict(
                timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
                warn_steps_per_sample=res.warns.tolist(),
                pressure_iters_per_step_per_sample=sample_iters(res.p_iterations),
                adjoint_pcg_iters_per_step_per_sample=(
                    np.sum([a.iterations for a in p_adj], axis=0) / unroll).tolist(),
                adjoint_gated_per_sample=[np.sum([a.gated for a in res.adjoints
                                                  if a.system == s], axis=0).tolist()
                                          for s in ("momentum", "pressure")],
                adjoint_ratio_passed_max=max((float(r / l) for a in p_adj
                                              for r, l, g in zip(a.residual, a.limit, a.gated)
                                              if not g), default=None),
                adjoint_ratio_gated_min=min((float(r / l) for a in p_adj
                                             for r, l, g in zip(a.residual, a.limit, a.gated)
                                             if g), default=None),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                loop_counters=d, launches=counts))
            print(json.dumps(dict(grad_eval=rep, workload=label, **evals[-1])), flush=True)
            if res.warns.any():
                fail(f"{label}: a sample warned")
            if not (gnorm > 0 and gnorm < float("inf")):
                fail(f"{label}: |grad| = {gnorm} (must be finite and > 0)")
            check(label, counts, want_fn(derived, d))
            if any(evals[-1][k] != evals[0][k] for k in ("launches", "loop_counters")):
                fail(f"{label}: an evaluation from the same state counted differently")
        timed = [e for e in evals if e["timed"]]
        print(json.dumps(dict(
            workload=label, batch=nb, evaluations=len(timed),
            sample_steps_per_sec=unroll * nb * len(timed) / sum(e["seconds"] for e in timed),
            unrolled_steps_per_sec=unroll * len(timed) / sum(e["seconds"] for e in timed),
            pressure_iters_per_step_per_sample=timed[-1]["pressure_iters_per_step_per_sample"],
            adjoint_pcg_iters_per_step_per_sample=timed[-1][
                "adjoint_pcg_iters_per_step_per_sample"],
            adjoint_gated_per_sample=timed[-1]["adjoint_gated_per_sample"],
            max_memory_allocated_bytes=max(e["max_memory_allocated_bytes"] for e in timed),
            grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"])), flush=True)
        return timed[-1]["launches"]

    out = {}
    # 13b: batch-4 512^2 forward
    n = BAT_N
    domain, step, vel, p = batched_turbulence(n, BAT_SEEDS, dev)
    if regime.batched_pallas_mode(vel) != "auto":
        fail(f"{n}^2 batch: the size rule does not pick the auto regime")
    first = batched_rollout(step, vel, p, BAT_CALL)  # the untimed call
    vel, p, fwd, derived, d, S = forward(
        f"batched turbulence {n}^2 x {len(BAT_SEEDS)} (runs/ab_batched_512.py)", step, domain,
        first.velocity, first.pressure, BAT_TIMED_CALLS, BAT_CALL, "jacobi2_solve_folded")
    if d["jacobi_solves"] != S or d["pcg2_solves"] != 2 * S:
        fail(f"{n}^2 batch: {d['jacobi_solves']} joint Jacobi and {d['pcg2_solves']} pcg2 "
             f"solves in {S} steps (expected 1 and 2 per step)")
    check(f"{n}^2 batch forward", fwd, dict(
        advection_assembly=S, laplace_assembly=S, grad2=3 * S, div2=2 * S,
        stencil_matvec=2 * S + derived["stencil_matvec"],
        jacobi2_solve_folded=derived["jacobi2_solve_folded"],
        pcg2_solve_batched=derived["pcg2_solve_batched"]))
    out["batched512"] = fwd

    # 13c: grad10 from that state. Per evaluation, U steps: the assemblies
    # U; grad2 3U forward + 2U (the div2 VJPs); div2 2U forward + 2U (the
    # correctors' grad2 VJPs) + U - 1 (the predictor's: the initial pressure
    # carries no gradient); the matvec 2U (explicit_H) + 2U transposed (its
    # VJP); U forward and U transposed momentum solves; 2U forward and 2U
    # adjoint pcg2 solves
    U = BAT_UNROLL

    def want512(derived, d):
        if d["jacobi_solves"] != 2 * U or d["pcg2_solves"] != 4 * U:
            fail(f"{n}^2 batch grad{U}: not 2U joint Jacobi and 4U pcg2 solves")
        return dict(advection_assembly=U, laplace_assembly=U, grad2=5 * U, div2=5 * U - 1,
                    stencil_matvec=4 * U + derived["stencil_matvec"],
                    jacobi2_solve_folded=derived["jacobi2_solve_folded"],
                    pcg2_solve_batched=derived["pcg2_solve_batched"])

    want512.jac = "jacobi2_solve_folded"
    out["batched512_grad10"] = grad(
        f"batched turbulence {n}^2 x {len(BAT_SEEDS)}, grad{U} (d sum_c mean v_c^2 / d v0), "
        "remat none", step, vel, p, U, BAT_GRAD_REPS, want512)

    # 13c, card vs CPU: batch 2 at 128^2 in the auto regime, with the path's
    # loss and with sum_c sum(v_c^2): under the mean the cotangents stay
    # below 1, so every adjoint tol is the bare 1e-8 and no adjoint is
    # gated; under the sum most pressure adjoints end above the gate's limit
    # (100 x adj_tol), so the per-sample gate decisions are held card vs CPU
    ns = BAT_SMALL

    def sum_square(v):
        return sum(torch.sum(c * c) for c in v.components)

    for loss_name, loss_fn in (("sum_c mean(v_c^2)", None), ("sum_c sum(v_c^2)", sum_square)):
        grads, decisions, iters = {}, {}, {}
        for where, dv in (("cuda", dev), ("cpu", torch.device("cpu"))):
            _, step_s, vel_s, p_s = batched_turbulence(ns, (0, 1), dv)
            with regime.batched_regime("auto"):
                r = batched_rollout_loss_grad(step_s, vel_s, p_s, BAT_SMALL_STEPS,
                                              *(() if loss_fn is None else (loss_fn,)))
            if r.warns.any():
                fail(f"{ns}^2 batch 2 gradient on {where}: a sample warned")
            grads[where] = [c.cpu().double() for c in r.grad.components]
            decisions[where] = [(a.system, np.asarray(a.gated).tolist()) for a in r.adjoints]
            iters[where] = r.p_iterations.tolist()
        g_rel = rel_l2_list(grads["cuda"], grads["cpu"])
        n_gated = sum(sum(g) for _, g in decisions["cpu"])
        # the pressure iterations are reported, not required equal: from
        # solenoidal states the first corrector's right-hand side sits at
        # rounding level, so where a solve stops at tol 1e-8 depends on the
        # summation order (phase 10a)
        print(f"{ns}^2 batch 2 x {BAT_SMALL_STEPS}-step gradient of {loss_name} in the auto "
              f"regime, card vs CPU plain path: rel l2 {g_rel:.3e}; gated adjoints card "
              f"{sum(sum(g) for _, g in decisions['cuda'])} / CPU {n_gated} of "
              f"{2 * len(decisions['cpu'])}; pressure iterations card {iters['cuda']} / CPU "
              f"{iters['cpu']}", flush=True)
        if decisions["cuda"] != decisions["cpu"]:
            fail(f"{ns}^2 batch 2 gradient of {loss_name}: gate decisions differ, card "
                 f"{decisions['cuda']} vs CPU {decisions['cpu']}")
        if loss_fn is not None and not n_gated:
            fail(f"{ns}^2 batch 2 gradient of {loss_name}: no adjoint gated, so this check "
                 "does not cover the gate")
        if not g_rel <= 1e-3:
            fail(f"{ns}^2 batch 2 gradient of {loss_name}: card vs CPU rel l2 {g_rel:.3e} > 1e-3")

    # 13d: batch 2 at 1024^2
    nl = BAT_LARGE_N
    domain_l, step_l, vel_l, p_l = batched_turbulence(nl, BAT_LARGE_SEEDS, dev)
    warm = batched_rollout(step_l, vel_l, p_l, BAT_LARGE_WARMUP)
    vel_l, p_l, fwd_l, derived, d, S = forward(
        f"batched turbulence {nl}^2 x {len(BAT_LARGE_SEEDS)}", step_l, domain_l, warm.velocity,
        warm.pressure, 1, BAT_LARGE_STEPS, "jacobi1_solve_batched")
    if d["jacobi_solves"] != 2 * S or d["pcg2_solves"]:
        fail(f"{nl}^2 batch: {d['jacobi_solves']} jac1 component solves (expected 2 per step), "
             f"{d['pcg2_solves']} pcg2 solves (expected none)")
    check(f"{nl}^2 batch forward", fwd_l, dict(
        advection_assembly=S, laplace_assembly=S, grad2=3 * S, div2=2 * S,
        stencil_matvec=2 * S + derived["stencil_matvec"],
        jacobi1_solve_batched=derived["jacobi1_solve_batched"]))
    out["batched1024"] = fwd_l
    Ul = BAT_LARGE_UNROLL

    def want1024(derived, d):
        if d["jacobi_solves"] != 4 * Ul or d["pcg2_solves"]:
            fail(f"{nl}^2 batch grad{Ul}: not 4U jac1 component solves and no pcg2")
        return dict(advection_assembly=Ul, laplace_assembly=Ul, grad2=5 * Ul, div2=5 * Ul - 1,
                    stencil_matvec=4 * Ul + derived["stencil_matvec"],
                    jacobi1_solve_batched=derived["jacobi1_solve_batched"])

    want1024.jac = "jacobi1_solve_batched"
    out["batched1024_grad"] = grad(
        f"batched turbulence {nl}^2 x {len(BAT_LARGE_SEEDS)}, grad{Ul}, remat none", step_l,
        vel_l, p_l, Ul, BAT_LARGE_GRAD_REPS, want1024)
    return out


def batched_training_path(dev, wrappers: dict) -> dict:
    """Phase 13e: make_batched_train_step in the "auto" regime: bench.py
    workload_training's configuration (the mixing layer, max iterations
    (200, 2000), the fullyconv CNN at its published widths, a 10-step
    unroll, four losses, Adam 1e-5, tol 1e-6, remat "none") at HRres
    256 x 1024, whose 257 x 1024 face crosses the 512^2 gate, at dt 0.1
    (bench's dt 0.4 at 64 x 256 scaled with the grid), batch 2 (two frames
    of a run): first each sample's loss and weight gradient
    (the batched loss's per-sample gradient, the train step's own) against
    that sample run alone through make_train_step, at phase 9a's tol 1e-7
    and bars (loss rtol 1e-4, gradient rel l2 1e-3), and the batched step's
    masked-mean gradient against their mean; then 1 untimed and 3 timed
    train steps: warn 0, the Adam count, the joint Jacobi kernel (the grid
    rule) as its counters derive, the Laplace assembly 10 times per step,
    the matvec (explicit_H forward and transposed) plus the loops' applies,
    the bounded FV trio with a batch axis (per step of U = 10: grad2m 3U
    forward + 2U div2m VJPs, div2m 2U, gradT2m 3U - 1: the initial
    pressure carries no gradient), nothing else (the pressure takes
    channel_mm's generic loop)."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        make_batched_train_step, make_loss_fn, make_rollout_fn, make_train_step)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    nb = BAT_TRAIN_B
    setup = training_setup(BAT_TRAIN_RES, dev, BAT_TRAIN_DT)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    # the checks at tol 1e-7
    ccfg = training_cfg(tol=TRAIN_CHECK_TOL, remat="none")
    closs = make_loss_fn(setup, ccfg, make_rollout_fn(setup, ccfg))
    batch = training_frames(setup, ccfg, nb)
    if regime.resolve_regime(batch[0]) != "auto":
        fail(f"training {BAT_TRAIN_RES}: the size rule does not pick the auto regime")
    per = [w.detach().unsqueeze(0).expand(nb, *w.shape).clone().requires_grad_(True)
           for w in params]
    with regime.batched_regime("auto"):
        losses, (bwarns, _) = closs(per, *batch)
        pgrads = torch.autograd.grad(losses.sum(), per)
    opt = GradCapture()
    _, mean_g, _, _, _ = make_batched_train_step(closs, opt)(params, opt.init(params), *batch)
    b1_cfg = training_cfg(tol=TRAIN_CHECK_TOL)
    b1_step = make_train_step(make_loss_fn(setup, b1_cfg, make_rollout_fn(setup, b1_cfg)), opt)
    l_rel, g_rels, singles, single_w = [], [], [], []
    for s in range(nb):
        _, g1, loss1, _, w1 = b1_step(params, opt.init(params), *sample(batch, s))
        singles.append(g1)
        single_w.append(bool(w1))
        l_rel.append(abs(float(losses[s].detach()) - float(loss1)) / abs(float(loss1)))
        g_rels.append(rel_l2_list([g[s] for g in pgrads], g1))
    want_g = [sum(g[i] for g in singles) / nb for i in range(len(params))]
    m_rel = rel_l2_list(mean_g, want_g)
    print(f"training {BAT_TRAIN_RES[0]}x{BAT_TRAIN_RES[1]} batch {nb} in the auto regime (tol "
          f"{TRAIN_CHECK_TOL}) vs each sample alone through make_train_step: loss rel "
          f"{[f'{x:.3e}' for x in l_rel]}, weight gradient rel l2 {[f'{x:.3e}' for x in g_rels]}, "
          f"masked mean vs the mean {m_rel:.3e}; warns {np.asarray(bwarns).tolist()} / "
          f"{single_w}", flush=True)
    if np.asarray(bwarns).any() or any(single_w):
        fail("training auto regime check: a solve warned")
    if not max(l_rel) <= 1e-4:
        fail(f"training auto regime: per-sample loss rel {max(l_rel):.3e} > 1e-4")
    if not max(g_rels + [m_rel]) <= 1e-3:
        fail(f"training auto regime: weight gradient rel l2 {max(g_rels + [m_rel]):.3e} > 1e-3")

    from diffpiso_tpu_torch.solvers import krylov

    cfg = training_cfg(remat="none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    adam = Adam(1e-5)
    state = adam.init(params)
    batch = training_frames(setup, cfg, nb)
    STATES["batched_training"] = (setup, batch[0])
    step = make_batched_train_step(loss_fn, adam)
    params, state, loss, parts, warns = step(params, state, *batch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    c0 = batched_counters()
    t0 = time.perf_counter()
    any_warn = False
    for _ in range(BAT_TRAIN_REPS):
        params, state, loss, parts, warns = step(params, state, *batch)
        any_warn |= bool(np.asarray(warns).any())
    loss_v = float(loss)
    per_iter = (time.perf_counter() - t0) / BAT_TRAIN_REPS
    counts = {k: fn.launches for k, fn in wrappers.items()}
    derived, d = batched_derived(c0, batched_counters(), "jacobi2_solve_folded")
    print(json.dumps(dict(
        workload=f"closure training iteration {BAT_TRAIN_RES[0]}x{BAT_TRAIN_RES[1]} (dt "
                 f"{BAT_TRAIN_DT}), {TRAIN_STEPS}-step unroll, 4 losses, Adam, batch {nb}, "
                 "auto regime",
        train_iterations_per_sec=1.0 / per_iter, samples_per_sec=nb / per_iter,
        unrolled_steps_per_sec=TRAIN_STEPS * nb / per_iter, loss=loss_v, warn=any_warn,
        count=int(state.count), loop_counters=d, launches=counts)), flush=True)
    if any_warn or not np.isfinite(loss_v):
        fail("training auto regime: a sample warned or the loss is not finite")
    if int(state.count) != 1 + BAT_TRAIN_REPS:
        fail(f"training auto regime: Adam count {int(state.count)}: an update was skipped")
    R = TRAIN_STEPS * BAT_TRAIN_REPS
    if d["jacobi_solves"] != 2 * R or d["pcg2_solves"]:
        fail(f"training auto regime: {d['jacobi_solves']} joint Jacobi solves (expected "
             f"{2 * R}), {d['pcg2_solves']} pcg2 solves (expected none)")
    want = dict(laplace_assembly=R, stencil_matvec=4 * R + derived["stencil_matvec"],
                jacobi2_solve_folded=derived["jacobi2_solve_folded"], grad2m=5 * R,
                div2m=2 * R, gradT2m=3 * R - BAT_TRAIN_REPS)
    for k, c in counts.items():
        if c != want.get(k, 0):
            fail(f"training auto regime: {k} launched {c} times, expected {want.get(k, 0)}")
    return counts


# -- the default pressure solver (CG, row 10d) and the function preconditioners -----------
# final states of earlier paths, which phases 2i and 15 start from: "cavity"
# (v, p, g1, g2) after phase 6b; "mixing" (setup, v, p, g1, g2, step clock)
# after phase 7b; "turbulence" (v, p, g1, g2) after phase 4
STATES = {}
CG_STEPS = 200  # 15b: forward steps of the 512 cavity under CG (bench.py's protocol)
CG_SMALL_STEPS = 5  # 15a: steps and rollout-gradient depth at 64^2, card vs CPU
KIND_STEPS = 20  # 15c: forward steps of each function kind at full size
GHIA_N = 128  # 15d: examples/validate_ghia.py at its defaults
GHIA_FIXTURE = "tests/fixtures/ldc_re1000_N128_t100_centerline_u.npz"
GHIA_U_MIN = -0.338  # tests/test_ghia_fixture.py's bar, +- 0.02


def cg_cavity(n, dev):
    """(domain, sim, dt) of the n cavity in the reference's configuration:
    bench.py build(n, 1e-6) with preconditioner None (plain CG) forward and
    adjoint."""
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup

    return lid_driven_cavity_setup(n, dev, preconditioner=None, adjoint_preconditioner="same")


def cg_counters() -> dict:
    from diffpiso_tpu_torch.solvers import krylov

    c = krylov.cg
    return dict(cg_loops=c.loops, cg_warm_entries=c.warm_entries, cg_resets=c.resets,
                cg_iterations=c.iterations)


def cg_derived(c0: dict, c1: dict) -> tuple:
    """(launches CG's counters derive, counter deltas): the iteration kernel
    once per iteration, the residual kernel once per warm entry, reset and
    finished loop."""
    d = {k: c1[k] - c0[k] for k in c0}
    return ({"cg_iteration": d["cg_iterations"],
             "pcg_residual": d["cg_warm_entries"] + d["cg_resets"] + d["cg_loops"]}, d)


# kernels a call of row 10d launches, by (deflate, sum of p carried in)
CG_KERNELS = {(True, False): 5, (True, True): 4, (False, False): 4, (False, True): 3}


def exact_check(cgk, label, lap, x, r, p, deflate) -> None:
    """Phase 2i's bit-for-bit check of row 10d against
    `cg.cg_iteration_exact`, two chained calls: the first forms sum p, the
    second takes the first's sum p' (as `krylov.cg` carries it); each call's
    kernels counted."""
    import torch

    sp = None
    for call in range(2):
        k0 = cgk.fused_cg_iteration.kernel_launches
        got = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True, sum_p=sp)
        launched = cgk.fused_cg_iteration.kernel_launches - k0
        xe, re_, pe, ne, slots = cgk.cg_iteration_exact(lap, x, r, p, deflate, sum_p=sp)
        pairs = {"x'": (got[0], xe), "r'": (got[1], re_), "p'": (got[2], pe),
                 "rnorm": (got[3], ne), "p.q": (got[4][0], slots[2]),
                 "alpha": (got[4][1], slots[4]), "beta": (got[4][2], slots[7]),
                 "sum p'": (got[5], slots[8])}
        bad = [k for k, (a, w) in pairs.items() if not torch.equal(a, w)]
        want = CG_KERNELS[(bool(deflate), sp is not None)]
        print(f"cg_iteration {label} deflate={deflate} call {call} (sum p "
              f"{'carried' if sp is not None else 'formed'}): bit-equal to "
              f"cg_iteration_exact: {not bad}; kernels {launched} (expected {want})", flush=True)
        if bad:
            fail(f"cg_iteration {label} deflate={deflate} call {call}: {', '.join(bad)} not "
                 f"bit-equal to cg_iteration_exact")
        if launched != want:
            fail(f"cg_iteration {label} deflate={deflate} call {call}: {launched} kernels, "
                 f"expected {want}")
        x, r, p, sp = got[0], got[1], got[2], got[5]


def cg_kernels(dev, kernels: list) -> None:
    """Phase 2i: row 10d against its plain version on the card, on the
    513 x 512 cavity's Laplacian in the reference's configuration (one CG
    step from phase 6's developed state) and the (x, r, p) of that solve's
    third iteration, with the kernel's deflation on and off, and on the
    periodic 512^2 Laplacian of phase 4's state. The inputs come from the
    deflated recurrence (mean-free r and p, as the solver hands them over):
    on this shifted all-Neumann system an undeflated recurrence feeds the
    indefinite shift direction (measured on the H100: beta 4.2e3 by the
    third iteration), where every rounding difference is amplified. The
    kernel must be bit-equal to `cg.cg_iteration_exact` (the same
    elementwise arithmetic with every sum in the kernels' order,
    `pcgphases.tree_sum_plain`): x', r', p', rnorm, p.q, alpha, beta and
    the sum of p' it carries to the next call, called with the sum of p
    formed by its own first launch and with that sum carried from the
    previous call, each call launching CG_KERNELS[(deflate, carried)]
    kernels (the wrapper's `kernel_launches`). Against the plain version
    (torch.sum's order), as a second check, rnorm, p.q, alpha and beta
    must agree within rel 1e-5, and each plane within
    1e-6 of its scale plus what the two versions' measured scalar
    difference carries into it, the elementwise arithmetic being the same
    (`--fmad=false`): x' = x + alpha p takes |d alpha| max|p|, r' = proj(r
    - alpha q) |d alpha| max|q| (the deflation removes the constant that a
    rounding difference of sum p adds to q), p' = r' + beta p both r''s and
    |d beta| max|p|. Without deflation a rounding difference in sum p (a
    cancelling sum of a mean-free p) reaches r' undamped as shift x that
    difference (measured on the H100: r' 3e-5 of its scale apart), so that
    case takes p on an exactly summable grid whose sum makes shift sum p
    as large as L p (`summable`, as phase 2c's shifted PCG checks): then
    both versions sum it exactly and the shift term is exercised. Appends
    the kernel's entry."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import pcgphases

    domain, sim, dt = cg_cavity(CAV_N, dev)
    v, p, g1, g2 = STATES["cavity"]
    o = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                  advection_tol=CAV_TOL, pressure_tol=CAV_TOL, full_output=True)
    cav_lap, b = o.intermediates["laplacian"], o.intermediates["v1_div"]
    # the periodic 512^2 Laplacian of phase 4's state
    tdomain, tsim = STATES["turbulence_setup"]
    tv, tp, tg1, tg2 = STATES["turbulence"]
    to = piso_step(tv, tp, 0.4 / N, tdomain, tsim, pressure_inc1_guess=tg1,
                   pressure_inc2_guess=tg2, advection_tol=ADV_TOL, pressure_tol=P_TOL,
                   full_output=True)
    # rows 10a / 10b on the system the cavity under CG runs (1026 blocks)
    phases2_system_check(f"2i cavity {tuple(b.shape)} (CG)", cav_lap, b, g1)
    cases = (("cavity", cav_lap, b, g1, True), ("cavity", cav_lap, b, g1, False),
             ("turbulence", to.intermediates["laplacian"], to.intermediates["v1_div"],
              tg1, True))
    err, rel_planes, rel_scalars, inputs = 0.0, 0.0, 0.0, None
    for label, lap, rhs, x0, deflate in cases:
        r, _ = pcgphases.residual_plain(lap, rhs, x0, True)
        x, pp = x0, r
        for _ in range(2):  # the deflated recurrence to the third iteration's inputs
            x, r, pp, _ = cgk.cg_iteration_plain(lap, x, r, pp, True)
        if not deflate:
            pp = summable(pp, float(pcgphases.lap_matvec(lap, pp).abs().max())
                          / float(lap.shift))
        exact_check(cgk, label, lap, x, r, pp, deflate)
        got = cgk.fused_cg_iteration(lap, x, r, pp, deflate, with_scalars=True)
        want = cgk.cg_iteration_plain(lap, x, r, pp, deflate, with_scalars=True)
        rs = max(float((a - w).abs() / w.abs().clamp_min(1e-30))
                 for a, w in zip((got[3], *got[4]), (want[3], *want[4])))
        d_alpha = float((got[4][1] - want[4][1]).abs())
        d_beta = float((got[4][2] - want[4][2]).abs())
        p_max = float(pp.abs().max())
        q_max = float(pcgphases.lap_matvec(lap, pp).abs().max())
        carried = (d_alpha * p_max, d_alpha * q_max, d_alpha * q_max + d_beta * p_max)
        e, rp, readings = 0.0, 0.0, []
        for name, a, w, c in zip(("x'", "r'", "p'"), got[:3], want[:3], carried):
            scale = float(w.abs().max())
            ea = float((a - w).abs().max())
            bar = 1e-6 * scale + c
            readings.append(f"{name} {ea / scale:.3e} of scale (bar {bar / scale:.3e})")
            e, rp = max(e, ea), max(rp, ea / scale)
            if not ea <= bar:
                fail(f"cg_iteration {label} deflate={deflate}: {name} {ea:.3e} apart, above "
                     f"1e-6 of its scale {scale:.3e} + the scalars' carried {c:.3e}")
        print(f"cg_iteration {label} {tuple(x.shape)} deflate={deflate}: planes max abs err "
              f"{e:.3e}: {', '.join(readings)}; rnorm / p.q / alpha / beta max rel err "
              f"{rs:.3e} (|d alpha| {d_alpha:.3e}, |d beta| {d_beta:.3e}); rnorm "
              f"{float(want[3]):.4e}, alpha {float(want[4][1]):.4e}, beta "
              f"{float(want[4][2]):.4e}", flush=True)
        if not rs <= 1e-5:
            fail(f"cg_iteration {label} deflate={deflate}: scalars rel {rs:.3e} > 1e-5 "
                 f"against the plain version")
        err, rel_planes, rel_scalars = max(err, e), max(rel_planes, rp), max(rel_scalars, rs)
        if label == "cavity" and deflate:
            inputs = (lap, x, r, pp, deflate)
    lap, x, r, pp, deflate = inputs
    ny, nx = x.shape
    csr = csr_of_stencil(lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    pf = pp.reshape(-1, 1)
    # least traffic: 5 stencil planes, x, r, p in; x', r', p' out. Operations
    # per cell: the matvec 9 and its shift 2, three dot products 6, two axpys
    # and p' 6, the deflation 2, max 1
    b_, by_ = bound(11 * ny * nx * 4, 26 * ny * nx)
    # the path's call: the sum of p carried from the previous call
    carried = pcgphases.tree_sum_plain(pp)
    kernels.append(dict(
        name="cg_iteration", route="cuda", source="diffpiso_tpu_torch/csrc/cg.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:350", shape=[ny, nx],
        max_abs_err=err, planes_max_rel_err=rel_planes, scalars_max_rel_err=rel_scalars,
        bit_equal_to_exact=True,
        kernels_per_call={f"deflate={d}, sum carried={c}": k
                          for (d, c), k in CG_KERNELS.items()},
        ms=cuda_time_ms(lambda: cgk.fused_cg_iteration(*inputs, sum_p=carried), 200),
        plain_ms=cuda_time_ms(lambda: cgk.cg_iteration_plain(*inputs), 50),
        **device_time(lambda: cgk.fused_cg_iteration(*inputs, sum_p=carried)),
        uncarried=dict(ms=cuda_time_ms(lambda: cgk.fused_cg_iteration(*inputs), 200),
                       **device_time(lambda: cgk.fused_cg_iteration(*inputs))),
        bound_ms=b_, bound_by=by_,
        library_ms=cuda_time_ms(lambda: csr @ pf, 200),
        library_call="one cuSPARSE CSR SpMV of the same Laplacian (the matvec part)",
        # device time of the SpMV and of the SpMV with the iteration's two
        # dot products (p.q, r.r)
        **library_device_time(lambda: csr @ pf),
        spmv_dots=library_device_time(lambda: (
            torch.dot(pf.reshape(-1), (csr @ pf).reshape(-1)),
            torch.dot(r.reshape(-1), r.reshape(-1))))))


def cg_small_check(dev) -> None:
    """Phase 15a: the 64^2 cavity under CG, 5 steps from rest and the 5-step
    rollout gradient from the CPU's state, on the card against the plain
    path on the CPU: equal warn flags and gate decisions; per-solve
    iterations within 2 (float32 CG stops where max|r| crosses tol, which
    rounding can move by an iteration or two over tens of iterations; each
    difference is reported); velocity rel l2 <= 1e-4, gradient rel l2 <=
    1e-3."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    cpu = torch.device("cpu")
    states, iters, warns = {}, {}, {}
    for d in (dev, cpu):
        domain, sim, dt = cg_cavity(CAV_SMALL, d)
        step = cavity_step_fn(domain, sim, dt)
        v, p = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
        g1 = g2 = torch.zeros_like(p)
        iters[d.type], warns[d.type] = [], []
        for _ in range(CG_SMALL_STEPS):
            o = step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].extend(o.p_iterations)
            warns[d.type].append(bool(o.warn))
        states[d.type] = (v, p)
    diffs = [a - b for a, b in zip(iters["cuda"], iters["cpu"])]
    v_rel = rel_l2([c.cpu() for c in states["cuda"][0].components],
                   list(states["cpu"][0].components))
    print(f"{CAV_SMALL}^2 cavity under CG x {CG_SMALL_STEPS} steps, card vs CPU plain path: "
          f"pressure iterations card {iters['cuda']} / CPU {iters['cpu']} (differences "
          f"{diffs}), warn card {warns['cuda']} / CPU {warns['cpu']}, velocity rel l2 "
          f"{v_rel:.3e}", flush=True)
    if warns["cuda"] != warns["cpu"] or any(warns["cpu"]):
        fail(f"{CAV_SMALL}^2 cavity under CG: warn flags differ or a step warned")
    if any(abs(x) > 2 for x in diffs):
        fail(f"{CAV_SMALL}^2 cavity under CG: iterations differ by more than 2: {diffs}")
    if not v_rel <= 1e-4:
        fail(f"{CAV_SMALL}^2 cavity under CG: velocity rel l2 {v_rel:.3e} > 1e-4")
    v_cpu, p_cpu = states["cpu"]
    grads, decisions, ratios, adj_iters = {}, {}, {}, {}
    for d in (dev, cpu):
        domain, sim, dt = cg_cavity(CAV_SMALL, d)
        v = StaggeredField(tuple(c.to(d) for c in v_cpu.components), periodic=(False, False))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
        r = rollout_loss_grad(cavity_step_fn(domain, sim, dt), v, p_cpu.to(d), f, CG_SMALL_STEPS)
        if r.warns:
            fail(f"{CAV_SMALL}^2 cavity CG gradient on {d.type}: {r.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, bool(a.gated)) for a in r.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 4) for a in r.adjoints
                          if a.limit is not None]
        adj_iters[d.type] = [a.iterations for a in r.adjoints if a.system == "pressure"]
    g_rel = rel_l2(grads["cuda"], grads["cpu"])
    print(f"{CAV_SMALL}^2 cavity under CG, {CG_SMALL_STEPS}-step rollout gradient, card vs CPU: "
          f"rel l2 {g_rel:.3e}; gated adjoints card {sum(g for _, g in decisions['cuda'])} / "
          f"CPU {sum(g for _, g in decisions['cpu'])} of {len(decisions['cpu'])}; pressure "
          f"adjoint iterations card {adj_iters['cuda']} / CPU {adj_iters['cpu']}; residual / "
          f"gate limit card {ratios['cuda']}, CPU {ratios['cpu']}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{CAV_SMALL}^2 cavity CG gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not g_rel <= 1e-3:
        fail(f"{CAV_SMALL}^2 cavity CG gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def rel_l2(a, b) -> float:
    import torch

    num = sum(float(torch.sum((x.double() - y.double()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double() ** 2)) for y in b)
    return (num / den) ** 0.5 if den > 0 else float("inf")


def cg_cavity_path(dev, wrappers: dict) -> tuple:
    """Phase 15b, path A: the 513 x 512 cavity in the reference's
    configuration (plain CG forward and adjoint, tol 1e-6, at most 600
    iterations, resets every 50) from the state phase 6 leaves: 200 forward
    steps, then grad30 under "outputs" remat (1 untimed and 3 timed
    evaluations). The launch counts are asserted from the loops' counters:
    the iteration kernel once per CG iteration, the residual kernel once per
    warm entry, reset and loop, none of pcg2, the PCG apply / update or the
    folded update; the other kernels as phase 6's. Returns (forward launches,
    grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.solvers import krylov

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    domain, sim, dt = cg_cavity(CAV_N, dev)
    step = cavity_step_fn(domain, sim, dt)
    v, p, g1, g2 = STATES["cavity"]
    reset()
    c0, b0, k0 = cg_counters(), loop_counters(), phases2_counts()
    warns, iters, div = 0, [[], []], 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CG_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters[0].append(o.p_iterations[0])
        iters[1].append(o.p_iterations[1])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    derived, d = cg_derived(c0, cg_counters())
    bd = {k: loop_counters()[k] - b0[k] for k in b0}
    r10ab = phases2_check("cavity under CG forward", k0, d, cg=True)
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    active_int = sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, domain.dx) * active_int).abs().max())
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2 ({CAV_N + 1} x {CAV_N} cells) under plain CG (the "
                 f"reference's configuration), from phase 6's developed state, forward",
        steps=CG_STEPS, steps_per_sec=CG_STEPS / elapsed,
        pressure_iters_per_step=[sum(i) / CG_STEPS for i in iters],
        pressure_iters_max=[max(i) for i in iters], resets_per_step=d["cg_resets"] / CG_STEPS,
        cg_counters=d, warn_fraction=warns / CG_STEPS, bicgstab_fallbacks=bd["bicgstab_fallbacks"],
        max_abs_div_active=div,
        host_us_per_cg_iteration=elapsed / max(d["cg_iterations"], 1) * 1e6, launches=fwd,
        row10ab_kernel_launches=r10ab,
    )), flush=True)
    if not finite:
        fail("cavity under CG: non-finite state after the forward path")
    if warns:
        fail(f"cavity under CG: warn fraction {warns / CG_STEPS} (must be 0)")
    per_step = {"grad2m": 3, "div2m": 2, "stencil_matvec": 2, "jacobi2_solve": 1,
                "laplace_assembly": 1, "advection_assembly_masked": 1}
    want = {k: per_step.get(k, 0) * CG_STEPS for k in fwd}
    want.update(derived)
    want["stencil_matvec"] += 2 * (bd["applies"] + bd["applies_T"])
    want["stencil_residual"] = 2 * (bd["residuals"] + bd["residuals_T"])
    want.update({k: 2 * bd["bicgstab_iterations"] for k in BICG_PHASES})
    for k in fwd:
        if fwd[k] != want[k]:
            fail(f"cavity under CG forward: {k} launched {fwd[k]} times, expected {want[k]}")
    if not fwd["cg_iteration"]:
        fail("cavity under CG forward: no CG iteration ran")

    # grad30 ("outputs" remat, bench.py's protocol) from the state the
    # forward run leaves; phase 6c's counts for every kernel but the
    # pressure solves', which CG's counters derive
    U = UNROLL
    expected = {"grad2m": 8 * U, "div2m": 4 * U, "gradT2m": 3 * U - 1, "stencil_matvec": 6 * U,
                "jacobi2_solve": 2 * U, "laplace_assembly": 2 * U,
                "advection_assembly_masked": 2 * U}
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False, False))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        c0, b0, k0 = cg_counters(), loop_counters(), phases2_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        derived, d = cg_derived(c0, cg_counters())
        bd = {k: loop_counters()[k] - b0[k] for k in b0}
        r10ab = phases2_check("cavity under CG grad30", k0, d, cg=True)
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_cg_iters=[a.iterations for a in p_adj],
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            gated_ratios=[round(a.residual / a.limit, 4) for a in p_adj if a.gated],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            cg_counters=d, bicgstab_fallbacks=bd["bicgstab_fallbacks"],
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), launches=counts,
            row10ab_kernel_launches=r10ab,
        ))
        print(json.dumps(dict(cavity_cg_grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"cavity under CG grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"cavity under CG grad30: |grad| = {gnorm} (must be finite and > 0)")
        want = dict(expected, **derived)
        want["stencil_matvec"] += 2 * (bd["applies"] + bd["applies_T"])
        want["stencil_residual"] = 2 * (bd["residuals"] + bd["residuals_T"])
        want.update({k: 2 * bd["bicgstab_iterations"] for k in BICG_PHASES})
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"cavity under CG grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        if any(evals[-1][k] != evals[0][k] for k in ("launches", "cg_counters")):
            fail("cavity under CG grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2 under plain CG, grad{U} (d sum v^2 / d forcing), "
                 f"remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_cg_iters_per_step=sum(timed[-1]["adjoint_cg_iters"]) / U,
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        gated_ratios=timed[-1]["gated_ratios"],
        max_memory_allocated_bytes=max(e["max_memory_allocated_bytes"] for e in timed),
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )), flush=True)
    return fwd, timed[-1]["launches"]


def kind_sim(sim, kind):
    """`sim` with the pressure preconditioner of `kind`, forward and adjoint."""
    import dataclasses

    return dataclasses.replace(sim, pressure_solver=dataclasses.replace(
        sim.pressure_solver, preconditioner=kind, adjoint_preconditioner=kind))


def kinds_small_check(dev) -> None:
    """Phase 15c's checks: one step of each function kind on the card
    against the CPU plain path (fft and mg on the 64^2 turbulence, channel
    on the 32 x 128 mixing layer, dct on the 64 cavity): equal warn,
    iterations within 1, velocity rel l2 <= 1e-5."""
    import dataclasses

    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup, lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    for kind in ("fft", "mg", "channel", "dct"):
        outs = {}
        for d in (dev, torch.device("cpu")):
            if kind == "channel":
                setup = mixing_setup(MIX_SMALL, d)
                setup = dataclasses.replace(setup, sim=kind_sim(setup.sim, kind))
                v, p = setup.initial_state()
                o = mixing_step_fn(setup)(v, p, torch.zeros_like(p), torch.zeros_like(p),
                                          tm=bench_time(0, setup.dt))
            elif kind == "dct":
                domain, sim, dt = lid_driven_cavity_setup(CAV_SMALL, d, preconditioner=kind,
                                                          adjoint_preconditioner=kind)
                o = cavity_step_fn(domain, sim, dt)(domain.staggered_grid(0.0, device=d),
                                                    domain.centered_grid(0.0, device=d),
                                                    None, None)
            else:
                domain, sim = decaying_turbulence_setup((64, 64), viscosity=1e-3, device=d)
                v = random_solenoidal(domain, torch.Generator().manual_seed(1), device=d)
                o = piso_step(v, domain.centered_grid(0.0, device=d), 0.4 / 64, domain,
                              kind_sim(sim, kind), advection_tol=ADV_TOL, pressure_tol=1e-7)
            outs[d.type] = (bool(o.warn), list(o.p_iterations),
                            [c.cpu() for c in o.velocity.components])
        rel = rel_l2(outs["cuda"][2], outs["cpu"][2])
        print(f"{kind}: one step, card vs CPU plain path: warn {outs['cuda'][0]} / "
              f"{outs['cpu'][0]}, pressure iterations {outs['cuda'][1]} / {outs['cpu'][1]}, "
              f"velocity rel l2 {rel:.3e}", flush=True)
        if outs["cuda"][0] != outs["cpu"][0] or outs["cpu"][0]:
            fail(f"{kind}: one step warned or warn differs card vs CPU")
        if any(abs(a - b) > 1 for a, b in zip(outs["cuda"][1], outs["cpu"][1])):
            fail(f"{kind}: pressure iterations differ by more than 1 card vs CPU")
        if not rel <= 1e-5:
            fail(f"{kind}: velocity rel l2 {rel:.3e} > 1e-5 card vs CPU")


def kinds_path(dev, wrappers: dict) -> dict:
    """Phase 15c: a short run of each function kind at full size, from the
    states earlier phases leave: 20 forward steps of `fft` and of `mg` from
    phase 4's 512^2 turbulence state, 20 of `channel` from phase 7's 128 x
    512 mixing-layer state, each beside 20 steps of the `_mm` kind that path
    runs, from the same state; the PCG phase kernels' launches against the
    loop counters (residual: warm entries + resets + loops; apply and
    update: iterations), pcg2, the folded update and CG's kernel 0. `fft` and
    `channel` must warn 0. Returns the launches of each run."""
    import dataclasses

    import torch

    from diffpiso_tpu_torch.core.piso import piso_step

    out = {}
    tdomain, tsim = STATES["turbulence_setup"]
    setup, mv, mp, mg1, mg2, clock = STATES["mixing"]
    for kind, base in (("fft", "fft_mm"), ("mg", "fft_mm"), ("channel", "channel_mm")):
        rows = {}
        for k in (base, kind):
            if kind == "channel":
                st = dataclasses.replace(setup, sim=kind_sim(setup.sim, k))
                stepper = mixing_step_fn(st)
                v, p, g1, g2 = mv, mp, mg1, mg2

                def step(v, p, g1, g2, i, stepper=stepper, st=st):
                    return stepper(v, p, g1, g2, tm=bench_time(clock + i, st.dt))
            else:
                sim = kind_sim(tsim, k)
                v, p, g1, g2 = STATES["turbulence"]

                def step(v, p, g1, g2, i, sim=sim):
                    return piso_step(v, p, 0.4 / N, tdomain, sim, pressure_inc1_guess=g1,
                                     pressure_inc2_guess=g2, advection_tol=ADV_TOL,
                                     pressure_tol=P_TOL)
            for fn in wrappers.values():
                fn.launches = 0
            c0 = loop_counters()
            warns, iters = 0, [0, 0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(KIND_STEPS):
                o = step(v, p, g1, g2, i)
                v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
                warns += int(o.warn)
                iters[0] += o.p_iterations[0]
                iters[1] += o.p_iterations[1]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = {n_: fn.launches for n_, fn in wrappers.items()}
            derived, d = derived_launches(c0, loop_counters(), spectral=k == "channel_mm")
            # row 16 is the loop's M^-1 r under channel_mm only (fft_mm takes
            # pcg2; the function kinds apply their own M^-1)
            if launches["spectral_apply"] != derived.get("spectral_apply", 0):
                fail(f"{k}: row 16 launched {launches['spectral_apply']} times, the loops "
                     f"derive {derived.get('spectral_apply', 0)}")
            rows[k] = dict(steps_per_sec=KIND_STEPS / elapsed,
                           pressure_iters_per_step=[i / KIND_STEPS for i in iters],
                           warn_fraction=warns / KIND_STEPS, pcg_counters={
                               x: d[x] for x in ("pcg_loops", "pcg_warm_entries", "pcg_resets",
                                                 "pcg_iterations")},
                           finite=all(bool(torch.isfinite(c).all()) for c in v.components))
            if k == kind:
                for n_ in ("pcg_residual", "pcg_apply", "pcg_update"):
                    if launches[n_] != derived[n_]:
                        fail(f"{kind}: {n_} launched {launches[n_]} times, the loops derive "
                             f"{derived[n_]}")
                # row 13 stays off both: the turbulence is uniform periodic
                # (row 1), the mixing layer's viscosity per face
                for n_ in ("pcg2_solve", "pcg_mm_update", "cg_iteration",
                           "advection_assembly_masked"):
                    if launches[n_]:
                        fail(f"{kind}: {n_} launched {launches[n_]} times (must be 0)")
                rows[k]["launches"] = {n_: launches[n_] for n_ in (
                    "pcg_residual", "pcg_apply", "pcg_update", "stencil_matvec")}
                out[kind] = launches
        path = "mixing 128 x 512" if kind == "channel" else f"turbulence {N}^2"
        print(json.dumps(dict(workload=f"{path}, {KIND_STEPS} forward steps, `{kind}` beside "
                                       f"`{base}` from the same state", **rows)), flush=True)
        if not rows[kind]["finite"]:
            fail(f"{kind}: non-finite state")
        if kind in ("fft", "channel") and rows[kind]["warn_fraction"]:
            fail(f"{kind}: warn fraction {rows[kind]['warn_fraction']} (must be 0)")
    return out


def ghia_path(dev) -> dict:
    """Phase 15d, path B: examples/validate_ghia.py at its defaults on the
    card (128 x 128 + the lid row, Re 1000, `dct` forward and adjoint, dt
    0.01, tol 3e-6, to t = 100: 10 000 steps in chunks of 500, first-order
    lid). Passes at correlation > 0.999 and rms < 0.06 against the Ghia
    table (the example's bar) and |u_min - (-0.338)| < 0.02 (the bar of
    tests/test_ghia_fixture.py, whose fixture is the JAX package's TPU
    result); reports the largest difference from that fixture."""
    import numpy as np

    from diffpiso_tpu_torch.eval.ghia import validate_ghia
    from diffpiso_tpu_torch.ops.advassembly_masked import fused_advection_assembly_masked

    fused_advection_assembly_masked.launches = 0
    res = validate_ghia(GHIA_N, device=dev, log=lambda s: print(f"ghia {s}", flush=True))
    if fused_advection_assembly_masked.launches != res["steps"]:
        fail(f"Ghia validation: row 13 launched {fused_advection_assembly_masked.launches} "
             f"times in {res['steps']} steps (one assembly a step)")
    fix = np.load(GHIA_FIXTURE)
    line = dict(
        workload=f"Ghia validation, lid-driven cavity {GHIA_N}^2 at Re 1000 (dct, dt 0.01, "
                 f"tol 3e-6, t = 100)",
        steps=res["steps"], seconds=res["seconds"], steps_per_sec=res["steps_per_sec"],
        correlation=res["correlation"], rms=res["rms"], u_min=res["u_min"],
        max_abs_diff_from_jax_fixture=float(np.abs(res["u"] - fix["u"]).max()),
        warned_steps=res["warned_steps"], pressure_iters_per_step=res["pressure_iters_per_step"],
        advection_assembly_masked_launches=fused_advection_assembly_masked.launches,
        u_at_ghia_y=[float(u) for u in res["u_at_ghia_y"]])
    print(json.dumps(line), flush=True)
    if not res["finite"]:
        fail("Ghia validation: non-finite state")
    if not (res["correlation"] > 0.999 and res["rms"] < 0.06):
        fail(f"Ghia validation: correlation {res['correlation']:.5f} (bar > 0.999) or rms "
             f"{res['rms']:.4f} (bar < 0.06)")
    if not abs(res["u_min"] - GHIA_U_MIN) < 0.02:
        fail(f"Ghia validation: u_min {res['u_min']:+.4f}, bar {GHIA_U_MIN} +- 0.02")
    return line


# -- the channel flows: row 13 (the masked advection assembly), the obstacle channel
# (examples/karman_street.py), the temporal mixing layer, the pipe ---------------------------
KARMAN_NY = 512  # 512 x 1536 cells: the cylinder (diameter 0.15) spans 77 cells
KARMAN_SPINUP = 400
KARMAN_CALL = 200  # steps per timed call
KARMAN_CALLS = 2
KARMAN_SMALL = 32  # 17a: 32 x 96, card vs CPU
PIPE_RES = (32, 64)  # examples/pipe.py's defaults
# 17c: steps x dt = 3300 x 2.5 = 8250 passes 0.8 H^2 / nu = 8192, where the
# example asserts its Poiseuille bar
PIPE_STEPS = 3300
PIPE_SMALL, PIPE_SMALL_STEPS = 16, 10
TEMPORAL_RES, TEMPORAL_STEPS = (32, 32), 3  # tests/test_temporal_mixing.py's setup
SMALL_STEPS = 3  # 17a: obstacle channel steps and gradient depth
# 17a: plain CG (the pipe, the temporal layer) stops where its float32
# residual crosses tol, which other sums round across: iterations within 2
# (phase 15a's allowance), reported; every other count must be equal
CG_ITER_SLACK = 2


def stencil_planes(st) -> list:
    """(centers, los, his, diag_As) -> the 12 planes, component by component:
    center, lo_y, lo_x, hi_y, hi_x, diag_A."""
    centers, los, his, diags = st
    return [x for c in range(2) for x in (centers[c], *los[c], *his[c], diags[c])]


def masked_check(label, vel, pad_modes, dx, nu, beta, dm, act, ns, periodic) -> dict:
    """Row 13 against its plain version on one field: every plane bit-equal;
    host ms per call (the pad outside, as on the path), device time per
    launch, the bound (each input read once, each output written once), the
    plain version's ms."""
    from diffpiso_tpu_torch.ops.advassembly_masked import (
        advection_assembly_masked_plain, fused_advection_assembly_masked)
    from diffpiso_tpu_torch.ops.fv import pad_staggered

    import torch

    vp = pad_staggered(vel, pad_modes, 1)
    args = (vp, vel, dx, nu, beta, dm, act, ns, periodic)
    got = stencil_planes(fused_advection_assembly_masked(*args))
    want = stencil_planes(advection_assembly_masked_plain(*args))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    shapes = [tuple(c.shape) for c in vel.components]
    print(f"row 13 {label} {shapes}: bit-equal to plain {same}, max abs err {err:.3e}",
          flush=True)
    if not same:
        fail(f"row 13 {label}: kernel and plain version differ (max abs err {err:.3e})")
    masks = [act, *dm.components] + ([] if ns is None else [ns])
    moved = sum(p.numel() * 4 for p in vp) + sum(m.numel() * m.element_size() for m in masks) \
        + sum(6 * c.numel() * 4 for c in vel.components)
    # per face and axis ~26 operations (4 window adds and scales, the link
    # coefficients, the diagonal's two terms), plus the Dirichlet select
    b_ms, b_by = bound(moved, sum(c.numel() for c in vel.components) * 60)
    return dict(shapes=shapes, max_abs_err=err, ms=cuda_time_ms(
        lambda: fused_advection_assembly_masked(*args), 100),
        **device_time(lambda: fused_advection_assembly_masked(*args)),
        plain_ms=cuda_time_ms(lambda: advection_assembly_masked_plain(*args), 20),
        bound_ms=b_ms, bound_by=b_by, bytes=moved)


def masked_kernels(dev) -> dict:
    """Phase 2k (all but the Karman shape, which 17b checks on its spun-up
    state): row 13 bit-equal to its plain version at the 512 cavity's faces
    (phase 6's state), the mixing layer's (phase 7's state, with its scalar
    viscosity: its path takes the general body for its per-face sponge),
    the pipe's 32 x 64 (x periodic, a state 50 steps in) and, with a batch
    axis, 13e's 256 x 1024 x 2 planes in "auto", each sample equal to the
    single-sample kernel."""
    import torch

    from diffpiso_tpu_torch.core.setups import DEFAULT_PHYSICAL, lid_driven_cavity_setup
    from diffpiso_tpu_torch.examples.pipe import pipe_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.advassembly_masked import fused_advection_assembly_masked
    from diffpiso_tpu_torch.ops.fv import pad_staggered

    nu = DEFAULT_PHYSICAL["viscosity"]  # the mixing layer's, before its sponge ramp
    out = {}
    domain, sim, dt = lid_driven_cavity_setup(CAV_N, device=dev)
    v = STATES["cavity"][0]
    beta = domain.dx[0] * domain.dx[1] / dt
    out["cavity"] = masked_check("cavity 512", v, domain.velocity_pad_modes(), domain.dx,
                                 sim.viscosity, beta, sim.dirichlet_mask, sim.active_mask,
                                 sim.no_slip_mask, sim.bool_periodic)
    setup, v = STATES["mixing"][:2]
    d = setup.domain
    # a shape check only: the mixing path itself assembles in the general body
    out["mixing_shape_scalar_nu"] = masked_check(
        "mixing 128 x 512 shape, scalar nu", v, d.velocity_pad_modes(), d.dx, nu,
        d.dx[0] * d.dx[1] / setup.dt, setup.sim.dirichlet_mask, setup.sim.active_mask,
        setup.sim.no_slip_mask, setup.sim.bool_periodic)
    ps = pipe_setup(*PIPE_RES, device=dev)
    v, p, g1, g2 = ps.initial_state()
    for _ in range(50):
        o = ps.step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    d = ps.domain
    out["pipe"] = masked_check(f"pipe {PIPE_RES[0]} x {PIPE_RES[1]}", v, d.velocity_pad_modes(),
                               d.dx, ps.nu, d.dx[0] * d.dx[1] / ps.dt, ps.sim.dirichlet_mask,
                               ps.sim.active_mask, ps.sim.no_slip_mask, ps.sim.bool_periodic)
    setup, vb = STATES["batched_training"]
    d, sim = setup.domain, setup.sim
    beta = d.dx[0] * d.dx[1] / setup.dt
    args = (d.velocity_pad_modes(), d.dx, nu, beta, sim.dirichlet_mask, sim.active_mask,
            sim.no_slip_mask, sim.bool_periodic)
    out["batched"] = masked_check("13e planes x 2", vb, *args)
    both = stencil_planes(fused_advection_assembly_masked(pad_staggered(vb, args[0], 1), vb,
                                                         *args[1:]))
    for s in range(vb.components[0].shape[0]):
        vs = StaggeredField(tuple(c[s] for c in vb.components), periodic=vb.periodic)
        one = stencil_planes(fused_advection_assembly_masked(pad_staggered(vs, args[0], 1), vs,
                                                            *args[1:]))
        if not all(torch.equal(a[s], b) for a, b in zip(both, one)):
            fail(f"row 13 batched: sample {s} differs from the single-sample kernel")
    print("row 13 on 13e's planes x 2 (auto): each sample bit-equal to the single-sample "
          "kernel", flush=True)
    return out


def solve_log():
    """Wraps the forward solves (solvers/base.py `_adv_solve_impl` and
    `_pressure_solve_impl`) to log each solve in order as (system, warn,
    iterations, final residual): which solve warned, and how far from its
    limit. Returns the list and an undo function."""
    from diffpiso_tpu_torch.solvers import base

    log = []
    adv, pre = base._adv_solve_impl, base._pressure_solve_impl

    def put(system, res):
        log.append((system, bool(res.warn), int(res.iterations), float(res.residual_norm)))

    def adv_logged(*a, **k):
        out = adv(*a, **k)
        put("momentum", out[1])
        return out

    def pre_logged(*a, **k):
        res = pre(*a, **k)
        put("pressure", res)
        return res

    base._adv_solve_impl, base._pressure_solve_impl = adv_logged, pre_logged

    def undo():
        base._adv_solve_impl, base._pressure_solve_impl = adv, pre

    return log, undo


def initial_velocity_grad(step, vel, p, steps) -> tuple:
    """(final velocity, d sum v^2 / d initial velocity, the adjoint solves,
    warned steps) of `steps` steps from (vel, p) with zero pressure guesses;
    each step records its solves (SolveStash), remat "none"."""
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.solvers.base import SolveStash

    leaves = tuple(c.detach().requires_grad_(True) for c in vel.components)
    v = StaggeredField(leaves, periodic=vel.periodic)
    g1 = g2 = torch.zeros_like(p)
    stashes, warns = [], 0
    with torch.enable_grad():
        for _ in range(steps):
            stashes.append(SolveStash())
            with stashes[-1].recording():
                o = step(v, p, g1, g2)
            warns += int(o.warn)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        grads = torch.autograd.grad(sum(torch.sum(c * c) for c in v.components), leaves)
    return ([c.detach() for c in v.components], grads,
            [a for s in stashes for a in s.adjoints], warns)


def channel_small_check(dev) -> None:
    """Phase 17a: the three channel flows at small sizes on the card against
    the plain path on the CPU: the obstacle channel at 32 x 96 (3 steps from
    u = 1, then the 3-step gradient of sum v^2 with respect to the initial
    velocity: gradient rel l2 <= 1e-3, equal gate decisions), the temporal
    mixing layer at 32 x 32 (tests/test_temporal_mixing.py's setup, 3
    steps) and the pipe at 16 x 16 (10 steps). Every solve's system and warn
    equal in order, the momentum loop counters equal; pressure iterations
    equal for the obstacle's PCG and within CG_ITER_SLACK for plain CG,
    reported; velocities within rel l2 1e-4."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.core.masks import temporal_mixing_layer_masks
    from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
    from diffpiso_tpu_torch.examples.karman_street import karman_setup
    from diffpiso_tpu_torch.examples.pipe import pipe_setup
    from diffpiso_tpu_torch.fields.box import Box
    from diffpiso_tpu_torch.fields.domain import Domain
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.material import CLOSED, PERIODIC
    from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver

    def temporal(d):
        ny, nx = TEMPORAL_RES
        dm, dv, act, acc, _ = temporal_mixing_layer_masks(
            TEMPORAL_RES, np.full(nx, 0.5, np.float32), np.full(nx, -0.5, np.float32), device=d)
        domain = Domain(TEMPORAL_RES, Box.from_size((1.0, 1.0)),
                        boundaries=[(CLOSED, CLOSED), PERIODIC])
        sim = SimulationParameters(
            dirichlet_mask=dm, dirichlet_values=dv, active_mask=act, accessible_mask=acc,
            no_slip_mask=None, viscosity=1e-3, laplace_rank_deficient=True,
            bool_periodic=(False, True), linear_solver=AdvectionSolver(max_iterations=200),
            pressure_solver=PressureSolver(max_iterations=2000, deflate_mean=True))
        y = (np.arange(ny) + 0.5) / ny - 0.5
        u = (np.tanh(y * 10.0)[:, None].repeat(nx, 1) * 0.5).astype(np.float32)
        x = np.arange(nx) / nx
        v = (0.02 * np.sin(2 * np.pi * 2 * x)[None, :].repeat(ny + 1, 0)).astype(np.float32)
        vel = StaggeredField((torch.as_tensor(v, device=d), torch.as_tensor(u, device=d)),
                             periodic=(False, True))

        def step(v, p, g1, g2):
            return piso_step(v, p, 0.01, domain, sim, advection_tol=1e-5, pressure_tol=1e-5)

        return step, vel, domain.centered_grid(0.0, device=d), TEMPORAL_STEPS

    def pipe(d):
        ps = pipe_setup(PIPE_SMALL, PIPE_SMALL, device=d)
        vel, p, _, _ = ps.initial_state()
        return ps.step, vel, p, PIPE_SMALL_STEPS

    def karman(d):
        ks = karman_setup(KARMAN_SMALL, device=d)
        vel, p, _, _ = ks.initial_state()
        return ks.step, vel, p, SMALL_STEPS

    cpu = torch.device("cpu")
    for name, make, cg in (("obstacle channel 32 x 96", karman, False),
                           ("temporal mixing layer 32 x 32", temporal, True),
                           ("pipe 16 x 16", pipe, True)):
        out = {}
        for key, d in (("card", dev), ("cpu", cpu)):
            step, v, p, steps = make(d)
            log, undo = solve_log()
            c0 = loop_counters()
            g1 = g2 = torch.zeros_like(p)
            try:
                for _ in range(steps):
                    o = step(v, p, g1, g2)
                    v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            finally:
                undo()
            d_ = {k: loop_counters()[k] - c0[k] for k in c0}
            out[key] = dict(log=log, counters=d_, v=[c.cpu() for c in v.components])
            if name.startswith("obstacle"):
                step, v0, p0, steps = make(d)
                _, grads, adj, warns = initial_velocity_grad(step, v0, p0, steps)
                out[key].update(grad=[g.cpu() for g in grads], warns=warns,
                                gates=[(a.system, bool(a.gated)) for a in adj])
        card, ref = out["card"], out["cpu"]
        systems = [e[:2] for e in card["log"]] == [e[:2] for e in ref["log"]]
        iters = [e[2] for e in card["log"] if e[0] == "pressure"], \
            [e[2] for e in ref["log"] if e[0] == "pressure"]
        worst = max(abs(a - b) for a, b in zip(*iters))
        momentum = {k: card["counters"][k] for k in card["counters"] if not k.startswith("pcg")}
        v_rel = rel_l2(card["v"], ref["v"])
        line = dict(check=f"{name}, card vs CPU", solves=len(ref["log"]),
                    pressure_iterations_card=iters[0], pressure_iterations_cpu=iters[1],
                    momentum_counters_card=momentum, velocity_rel_l2=v_rel)
        if "grad" in card:
            line.update(gradient_rel_l2=rel_l2(card["grad"], ref["grad"]),
                        gated_card=sum(g for _, g in card["gates"]),
                        gated_cpu=sum(g for _, g in ref["gates"]), adjoints=len(ref["gates"]))
        print(json.dumps(line), flush=True)
        if not systems or any(e[1] for e in ref["log"] + card["log"]):
            fail(f"17a {name}: the solves' order or warn differ, or a solve warned")
        if momentum != {k: ref["counters"][k] for k in momentum}:
            fail(f"17a {name}: the momentum loop counters differ card vs CPU")
        if worst > (CG_ITER_SLACK if cg else 0):
            fail(f"17a {name}: pressure iterations differ by {worst} card vs CPU")
        if not v_rel <= 1e-4:
            fail(f"17a {name}: velocity rel l2 {v_rel:.3e} > 1e-4 card vs CPU")
        if "grad" in card:
            if card["gates"] != ref["gates"] or card["warns"] or ref["warns"]:
                fail(f"17a {name}: gradient gate decisions differ or a step warned")
            if not line["gradient_rel_l2"] <= 1e-3:
                fail(f"17a {name}: gradient rel l2 {line['gradient_rel_l2']:.3e} > 1e-3")


def channel_counts(fwd: dict, steps: int, d: dict, extra: dict, jacobi) -> dict:
    """The launches a bounded 2-D path's `steps` forward steps must count,
    from the steps and the loops' counter deltas `d` (loop_counters) and
    `extra` (the pressure solves' derived launches): per step row 13 once,
    the Laplace assembly once, grad2m 3, div2m 2, explicit_H's 2 matvecs,
    the whole-solve Jacobi `jacobi` = (name, launches per solve) once; the
    BiCGSTAB hand-overs and generic applies as counted; every other kernel
    0. `jacobi` None: the momentum solve runs in float64 (the pipe), in the
    generic loop on plain operations, and launches no kernel."""
    want = dict(advection_assembly_masked=steps, laplace_assembly=steps, grad2m=3 * steps,
                div2m=2 * steps, stencil_matvec=2 * steps, **extra)
    if jacobi is not None:
        jac, per_solve = jacobi
        want.update({k: 2 * d["bicgstab_iterations"] for k in BICG_PHASES})
        want.update({jac: per_solve * steps},
                    stencil_matvec=2 * steps + 2 * (d["applies"] + d["applies_T"]),
                    stencil_residual=2 * (d["residuals"] + d["residuals_T"]))
    return {k: want.get(k, 0) for k in fwd}


def karman_path(dev, wrappers: dict) -> tuple:
    """Phase 17b: examples/karman_street.py at ny 512 (512 x 1536 cells;
    aspect 3, Re 200, tol 1e-5, caps 100 / 800, the `channel`
    preconditioner, dt 0.3/512, from u = 1): the 400-step spin-up, row 13
    on the spun-up state against its plain version (phase 2k's Karman
    shape), then 2 timed calls of 200 steps with every counter reset before
    them: steps/s per call, the path's own peak memory (less what the
    earlier phases hold), warn 0 on the timed steps (the
    spin-up's warned steps and the solve that warned reported), max |div
    v| over fluid cells, the obstacle's faces exactly at their Dirichlet
    zeros, finite vorticity and the wake asymmetry, every launch as the
    steps and the loops' counters derive (jac1 on both components, the PCG
    phases, row 13 once a step) and 0 of row 1 and every bypassed kernel.
    Returns (launches, the phase-2k entry of the Karman shape)."""
    import torch

    from diffpiso_tpu_torch.examples.karman_street import karman_setup, wake_asymmetry
    from diffpiso_tpu_torch.ops.fv import fv_divergence

    # the path's own peak: the device memory the earlier phases still hold
    # (STATES) is read before the set-up and taken off
    held = torch.cuda.memory_allocated()
    ks = karman_setup(KARMAN_NY, device=dev)
    sim, domain = ks.sim, ks.domain
    v, p, g1, g2 = ks.initial_state()
    log, undo = solve_log()

    def advance(k):
        nonlocal v, p, g1, g2
        warned, iters = [], [0, 0]
        for i in range(k):
            n0 = len(log)
            o = ks.step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            if o.warn:
                warned.append((i, [e for e in log[n0:] if e[1]]))
            iters[0] += o.p_iterations[0]
            iters[1] += o.p_iterations[1]
        del log[:]
        return warned, [x / k for x in iters]

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spin_warned, spin_iters = advance(KARMAN_SPINUP)
        torch.cuda.synchronize()
        spin_s = time.perf_counter() - t0
        print(f"karman {KARMAN_NY} x {3 * KARMAN_NY}: {KARMAN_SPINUP}-step spin-up in "
              f"{spin_s:.1f} s, warned steps {len(spin_warned)} (first: {spin_warned[:3]}), "
              f"pressure iterations per step {spin_iters}", flush=True)
        beta = domain.dx[0] * domain.dx[1] / ks.dt
        entry = masked_check(f"karman {KARMAN_NY} x {3 * KARMAN_NY}", v,
                             domain.velocity_pad_modes(), domain.dx, sim.viscosity, beta,
                             sim.dirichlet_mask, sim.active_mask, sim.no_slip_mask,
                             sim.bool_periodic)
        for fn in wrappers.values():
            fn.launches = 0
        wrappers["stencil_matvec"].launches_transposed = 0
        c0 = loop_counters()
        torch.cuda.reset_peak_memory_stats()
        calls, warned, iters = [], [], []
        for _ in range(KARMAN_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w, it = advance(KARMAN_CALL)
            torch.cuda.synchronize()
            calls.append(KARMAN_CALL / (time.perf_counter() - t0))
            warned += w
            iters.append(it)
    finally:
        undo()
    fwd = {k: fn.launches for k, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    steps = KARMAN_CALLS * KARMAN_CALL
    derived, d = derived_launches(c0, loop_counters())
    active_int = sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, domain.dx) * active_int).abs().max())
    solid = sim.no_slip_mask[1:-1, 1:-1]
    solid_v = torch.zeros_like(sim.dirichlet_mask.components[0])
    solid_v[:-1] |= solid
    solid_v[1:] |= solid
    solid_u = torch.zeros_like(sim.dirichlet_mask.components[1])
    solid_u[:, :-1] |= solid
    solid_u[:, 1:] |= solid
    obstacle_max = max(float(v.components[0][solid_v].abs().max()),
                       float(v.components[1][solid_u].abs().max()))
    w = ks.vorticity(v)
    finite_w = bool(torch.isfinite(w).all())
    asym = wake_asymmetry(w.cpu().numpy()) if finite_w else float("nan")
    print(json.dumps(dict(
        workload=f"Karman street {KARMAN_NY} x {3 * KARMAN_NY} (examples/karman_street.py: Re "
                 f"200, tol 1e-5, channel preconditioner, {KARMAN_SPINUP}-step spin-up), forward",
        steps=steps, steps_per_sec_per_call=calls, pressure_iters_per_step_per_call=iters,
        warned_steps=len(warned), warned_solves=warned[:5],
        spinup_warned_steps=len(spin_warned), spinup_warned_solves=spin_warned[:5],
        peak_memory_gb=peak, held_before_gb=held / 1e9, max_abs_div_fluid=div, obstacle_faces_max_abs=obstacle_max,
        wake_asymmetry=asym, loop_counters=d, launches=fwd)), flush=True)
    if not finite_w or not all(bool(torch.isfinite(c).all()) for c in v.components):
        fail("karman: non-finite state or vorticity")
    if warned:
        fail(f"karman: {len(warned)} timed steps warned; the first: {warned[:3]}")
    if obstacle_max != 0.0:
        fail(f"karman: the obstacle's faces moved off their Dirichlet zeros ({obstacle_max})")
    want = channel_counts(fwd, steps, d, {k: derived[k] for k in PCG_PHASES},
                          ("jacobi1_solve", 2))
    for k in fwd:
        if fwd[k] != want[k]:
            fail(f"karman forward: {k} launched {fwd[k]} times, expected {want[k]}")
    if fwd["advection_assembly"] or not fwd["pcg_apply"]:
        fail("karman forward: row 1 launched, or the PCG phases did not run")
    return fwd, entry


def pipe_path(dev, wrappers: dict) -> dict:
    """Phase 17c: examples/pipe.py at 32 x 64 for PIPE_STEPS steps from
    rest (plain CG with mean deflation, tol 1e-7, the momentum solve in
    float64 as the example runs it): Poiseuille rel < 0.05, x-invariance and
    |v| below 1e-5 (tests/test_channel.py's bars), warn 0 (a warned step is
    reported with the solves that set it), steps/s, CG iterations and
    momentum iterations per step; every launch as the steps and the loops'
    counters derive (the CG iteration and residual kernels, row 13 once a
    step, no momentum kernel: the float64 solve runs plain)."""
    import torch

    from diffpiso_tpu_torch.examples.pipe import pipe_setup

    ps = pipe_setup(*PIPE_RES, device=dev)
    if not PIPE_STEPS * ps.dt > ps.steady_time:
        fail("pipe: the run ends before the example's analytic check applies")
    v, p, g1, g2 = ps.initial_state()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["stencil_matvec"].launches_transposed = 0
    c0, k0 = loop_counters(), cg_counters()
    warned, iters = [], 0
    log, undo = solve_log()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(PIPE_STEPS):
            n0 = len(log)
            o = ps.step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            if o.warn:
                warned.append((i, [e for e in log[n0:] if e[1]]))
            iters += o.p_iterations[0] + o.p_iterations[1]
            del log[:]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        undo()
    fwd = {k: fn.launches for k, fn in wrappers.items()}
    _, d = derived_launches(c0, loop_counters())
    cg, dk = cg_derived(k0, cg_counters())
    rel = ps.poiseuille_error(v)
    u = v.components[1]
    x_var = float((u - u.mean(dim=1, keepdim=True)).abs().max())
    v_max = float(v.components[0].abs().max())
    print(json.dumps(dict(
        workload=f"pipe {PIPE_RES[0]} x {PIPE_RES[1]} (examples/pipe.py: nu 0.1, force 0.01, "
                 f"plain CG, tol 1e-7, float64 momentum solve), forward from rest",
        steps=PIPE_STEPS, time=PIPE_STEPS * ps.dt, steady_time=ps.steady_time,
        steps_per_sec=PIPE_STEPS / elapsed, cg_iterations_per_step=iters / PIPE_STEPS,
        momentum_iterations_per_step=d["bicgstab_iterations"] / PIPE_STEPS,
        warned_steps=len(warned), warned_solves=warned[:5],
        poiseuille_rel_l2=rel, x_variation=x_var, max_abs_v=v_max,
        cg_counters=dk, loop_counters=d, launches=fwd)), flush=True)
    if not all(bool(torch.isfinite(c).all()) for c in v.components):
        fail("pipe: non-finite state")
    if warned:
        fail(f"pipe: {len(warned)} steps warned; the first: {warned[:3]}")
    if not rel < 0.05:
        fail(f"pipe: Poiseuille rel l2 {rel:.4f} (bar < 0.05)")
    if not (x_var < 1e-5 and v_max < 1e-5):
        fail(f"pipe: x variation {x_var:.3e} / max |v| {v_max:.3e} (bars < 1e-5)")
    want = channel_counts(fwd, PIPE_STEPS, d, cg, None)
    for k in fwd:
        if fwd[k] != want[k]:
            fail(f"pipe forward: {k} launched {fwd[k]} times, expected {want[k]}")
    return fwd


# -- rows 17 and 16: the corrector's backward and the fused spectral apply ----------
BWD_KERNELS = ("corrector1_bridge_bwd", "corrector2_tail_bwd")
BWD_SHAPES = ((1024, 1024), (1024, 2048))  # 2l: the other periodic gradients' planes
SPEC_CASES = (  # 2m: (label, preconditioner, plane)
    ("mixing", "channel_mm", MIX_RES), ("training", "channel_mm", TRAIN_RES),
    ("dns", "channel_mm", DNS_RES), ("cavity", "dct_mm", (CAV_N + 1, CAV_N)))


def row17_launches() -> tuple:
    from diffpiso_tpu_torch.ops import corrector

    return corrector.corrector1_bridge_bwd.launches, corrector.corrector2_tail_bwd.launches


def row17_check(label, dev, before, steps) -> None:
    """A periodic rollout gradient of `steps` steps launches row 17 (both
    kernels) once a step on the card; on the CPU its plain twins run."""
    got = [a - b for a, b in zip(row17_launches(), before)]
    want = [steps, steps] if dev.type == "cuda" else [0, 0]
    if got != want:
        fail(f"{label} on {dev.type}: row 17 launched {got} times, expected {want}")


def synthetic_bridge(shape, dev, beta, seed) -> tuple:
    """The bridge's 17 planes and the tail's 7 at the scales of a step at
    beta = dxprod / dt (bma ~ beta, the stencil's centre ~ -beta), from a
    seeded generator on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen, device=dev)

    planes = [r(1e-3), r(0.5), r(0.5), r(0.1, beta), r(0.1, beta)]
    for _ in range(2):
        planes += [r(0.3, -beta - 4.0)] + [r(0.2) for _ in range(4)]
    planes += [r(0.3, -1.0), r(0.3, -1.0)]
    return planes, [r(1e-3), planes[1], planes[2], r(0.5), r(0.5), planes[3], planes[4]]


def corrector_bwd_kernels(dev, kernels, scalars, bridge_in, tail_in) -> None:
    """Phase 2l: row 17, the corrector bridge's and tail's backward kernels
    (csrc/corrector_bwd.cu), on the 512^2 step's planes of phase 2 and on
    synthetic planes at 1024^2 and 1024 x 2048 (the other periodic
    gradients' shapes): every cotangent bit-equal to the plain twin
    (`bridge_bwd_plain`, `tail_bwd_plain`), without the coefficient
    cotangents (the step's form) and with them; against autograd's VJP of
    the forward plain version, the step's cotangents bit for bit and every
    cotangent within rel l2 1e-5; host ms, device
    us per launch, bound, the twin's ms in both forms. No single PyTorch call
    forms the VJP: library_ms is null."""
    import torch

    from diffpiso_tpu_torch.ops import corrector

    f0, f1, dxprod, beta = scalars
    cases = [(f"{N}^2 (the step's planes)", (N, N), bridge_in, tail_in, scalars)]
    for shape in BWD_SHAPES:
        # the turbulence paths at these shapes: dx = 2 pi / ny square cells, dt 0.4 / ny
        dx_ = 2 * math.pi / shape[0]
        sc = (dx_, dx_, dx_ * dx_, dx_ * dx_ / (0.4 / shape[0]))
        pl, tl = synthetic_bridge(shape, dev, sc[3], shape[1])
        cases.append((f"{shape[0]}x{shape[1]}", shape, pl, tl, sc))
    entries = {k: dict(name=k, route="cuda", source="diffpiso_tpu_torch/csrc/corrector_bwd.cu",
                       replaces=rep, library_ms=None, max_abs_err=0.0)
               for k, rep in zip(BWD_KERNELS, ("diffpiso_tpu/ops/pallas_corrector.py:433",
                                               "diffpiso_tpu/ops/pallas_corrector.py:474"))}
    for label, shape, b_in, t_in, (f0, f1, dxprod, beta) in cases:
        gen = torch.Generator(device=dev).manual_seed(3)
        cts = [torch.randn(shape, generator=gen, device=dev) for _ in range(5)]
        plane_bytes = shape[0] * shape[1] * 4
        cells = shape[0] * shape[1]
        for name, wrapper, twin, args in (
                ("corrector1_bridge_bwd", corrector.corrector1_bridge_bwd,
                 corrector.bridge_bwd_plain, (f0, f1, dxprod, beta, b_in, cts)),
                ("corrector2_tail_bwd", corrector.corrector2_tail_bwd,
                 corrector.tail_bwd_plain, (f0, f1, dxprod, t_in, cts[:2]))):
            rows = {}
            for coeffs in (False, True):
                got, want = wrapper(*args, coeffs), twin(*args, coeffs)
                same = all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(got, want))
                err = max(float((a - b).abs().max()) for a, b in zip(got, want) if a is not None)
                entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
                if not same:
                    fail(f"{name} {label} coeffs={coeffs}: not bit-equal to its plain twin "
                         f"(max abs err {err:.3e})")
                # bytes: the bridge reads 19 planes (+ p with coeffs) and writes 1
                # (+ 14); the tail reads 4 (+ p, h0, h1) and writes 3 (+ 2); flops
                # per cell of the transposed chain, counted once
                planes_moved = {("corrector1_bridge_bwd", False): 20,
                                ("corrector1_bridge_bwd", True): 35,
                                ("corrector2_tail_bwd", False): 7,
                                ("corrector2_tail_bwd", True): 12}[name, coeffs]
                flops = {"corrector1_bridge_bwd": 47 + (62 if coeffs else 0),
                         "corrector2_tail_bwd": 13 + (14 if coeffs else 0)}[name]
                b_ms, b_by = bound(planes_moved * plane_bytes, flops * cells)
                # (bound as defaults: the device time is measured after the paths)
                rows[coeffs] = dict(
                    shape=list(shape), bit_equal=same,
                    ms=cuda_time_ms(lambda: wrapper(*args, coeffs), 100),
                    plain_ms=cuda_time_ms(lambda: twin(*args, coeffs), 20),
                    bound_ms=b_ms, bound_by=b_by,
                    **device_time(lambda w=wrapper, a=args, c=coeffs: w(*a, c)))
            # against autograd's VJP of the forward plain version: the step's
            # cotangents (p, v; the tail's h) bit for bit, every cotangent in rel l2
            fwd = corrector.bridge_plain if name == "corrector1_bridge_bwd" else corrector.tail_plain
            ins = args[4] if name == "corrector1_bridge_bwd" else args[3]
            c = args[5] if name == "corrector1_bridge_bwd" else args[4]
            n_step = 3 if name == "corrector1_bridge_bwd" else 5
            vjp_rel = 0.0
            for coeffs in (False, True):
                leaves = [x.detach().requires_grad_(coeffs or i < n_step)
                          for i, x in enumerate(ins)]
                asked = [x for x in leaves if x.requires_grad]
                with torch.enable_grad():
                    ref = torch.autograd.grad(fwd(*args[:len(args) - 2], *leaves), asked, c)
                got = [g for g in wrapper(*args, coeffs) if g is not None]
                if not coeffs and not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    fail(f"{name} {label}: the step's cotangents are not bit-equal to "
                         f"autograd's VJP of the plain forward")
                num = sum(float(torch.sum((a.double() - b.double()) ** 2))
                          for a, b in zip(got, ref))
                den = sum(float(torch.sum(b.double() ** 2)) for b in ref)
                vjp_rel = max(vjp_rel, (num / den) ** 0.5)
            print(json.dumps(dict(kernel=name, plane=label, bit_equal_to_twin=True,
                                  step_cotangents_bit_equal_to_autograd=True,
                                  vjp_rel_l2_vs_autograd=vjp_rel,
                                  pressure_only={k: v for k, v in rows[False].items()
                                                 if k != "_device_time"},
                                  with_coefficients={k: v for k, v in rows[True].items()
                                                     if k != "_device_time"})), flush=True)
            if not vjp_rel <= 1e-5:
                fail(f"{name} {label}: rel l2 {vjp_rel:.3e} against autograd's VJP > 1e-5")
            e = entries[name]
            key = "x".join(map(str, shape))
            if shape == (N, N):
                e.update(rows[False], vjp_rel_l2_vs_autograd=vjp_rel,
                         form=f"pressure-only (the step's), {N}^2")
                e["with_coefficients"] = rows[True]
            else:
                e[f"at_{key}"] = dict(rows[False], vjp_rel_l2_vs_autograd=vjp_rel)
                e[f"at_{key}_with_coefficients"] = rows[True]
    kernels.extend(entries.values())


def spectral_kernels(dev, kernels) -> None:
    """Phase 2m: row 16, the fused spectral apply (csrc/gemm.cuh
    dp_spectral_apply through csrc/pcg2.cu's pcg2_precondition: four
    launches of the hand-written GEMM in one call), on the mixing
    layer's, training's and the DNS's channel_mm planes and the 513 x 512
    cavity's dct_mm plane (random r, symbol weights 1): within rel l2 1e-5
    of the four torch.matmul contractions and the divide (TF32 off), both
    against float64; the same bits on a repeated call; host ms, device us per
    GEMM launch, bound, the plain version's ms and the library yardstick's
    (the four torch.matmuls on the stored transposes and the divide)."""
    import torch

    from diffpiso_tpu_torch.solvers.fourier import (MatmulSpectralSolver, safe_symbol,
                                                    spectral_apply_plain)
    from diffpiso_tpu_torch.solvers.spectral_apply import fused_spectral_apply

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: the spectral apply's yardstick must contract in full float32")
    kinds = {"channel_mm": ("dct2", "dct4"), "dct_mm": ("dct2", "dct2")}
    entry = dict(name="spectral_apply", route="cuda",
                 source="diffpiso_tpu_torch/csrc/pcg2.cu (pcg2_precondition: "
                        "csrc/gemm.cuh dp_spectral_apply)",
                 replaces="diffpiso_tpu/solvers/pallas_krylov.py:2634",
                 launches_count="one per M^-1 r call (four GEMM launches)")
    for label, kind, shape in SPEC_CASES:
        solver = MatmulSpectralSolver(kinds=kinds[kind], shape=tuple(shape))
        (v0, v0t), (v1, v1t) = solver.mats(torch.float32, dev)
        sym = safe_symbol(solver, (1.0, 1.0), torch.float32, dev)
        r = torch.randn(tuple(shape), generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)
        z = fused_spectral_apply(v0, v0t, v1, v1t, sym, r)
        want = spectral_apply_plain(v0, v1, sym, r)
        z64 = spectral_apply_plain(v0.double(), v1.double(), sym.double(), r.double())
        rel = rel_l2(z, want)
        repeat = torch.equal(z, fused_spectral_apply(v0, v0t, v1, v1t, sym, r))
        n0, n1 = shape
        b_ms, b_by = bound((2 * n0 * n0 + 2 * n1 * n1 + 3 * n0 * n1) * 4,
                           4.0 * n0 * n1 * (n0 + n1) + n0 * n1)
        row = dict(
            plane=list(shape), preconditioner=kind, rel_l2_vs_plain=rel,
            kernel_rel_l2_vs_float64=rel_l2(z.double(), z64),
            plain_rel_l2_vs_float64=rel_l2(want.double(), z64), repeat_bit_equal=repeat,
            max_abs_err=float((z - want).abs().max()),
            ms=cuda_time_ms(lambda: fused_spectral_apply(v0, v0t, v1, v1t, sym, r), 50),
            plain_ms=cuda_time_ms(lambda: spectral_apply_plain(v0, v1, sym, r), 50),
            library_ms=cuda_time_ms(lambda: v0t @ ((v0 @ r @ v1t) / sym) @ v1, 50),
            bound_ms=b_ms, bound_by=b_by,
            **device_time(lambda a=(v0, v0t, v1, v1t, sym, r): fused_spectral_apply(*a)))
        print(json.dumps(dict(kernel="spectral_apply", case=label,
                              **{k: v for k, v in row.items() if k != "_device_time"})),
              flush=True)
        if not (rel <= 1e-5 and repeat):
            fail(f"spectral_apply {label}: rel l2 {rel:.3e} vs plain (limit 1e-5), repeat "
                 f"bit-equal {repeat}")
        if label == "mixing":
            entry.update(row)
        else:
            entry[label] = row
    kernels.append(entry)


GEMM_PLAN_CASES = (  # 2p: (M, N, K, batch): a shape of each configuration the plan takes
    (1024, 2048, 1024, 1), (1024, 1024, 1024, 1), (513, 512, 513, 1), (128, 512, 512, 1),
    (128, 128, 128, 128))


def gemm_plan_check(dev) -> None:
    """Phase 2p: the hand-written GEMM (csrc/gemm.cuh) on a shape of each
    tile configuration its plan takes (10d-mm's at 1024 x 2048 and 1024^2,
    the cavity's, the mixing layer's, a batched 128^3 plane pass) and with
    the 3-D z pass's separable divide at 128 x 16384 x 128: bit-equal to its
    plain version (`pcg2.gemm_plain`, each output's fmaf chain in k order,
    emulated exactly in float64) in the plan's configuration and in every
    other, with and without the stored divide, and the same bits on a
    repeated call; prints the plan's choice and device us per launch."""
    import torch

    from diffpiso_tpu_torch.solvers import pcg2

    cfgs = pcg2.gemm_configs()
    g = torch.Generator(device=dev).manual_seed(17)
    for m, n, k, nb in GEMM_PLAN_CASES:
        a = torch.randn((m, k), generator=g, device=dev)
        b = torch.randn((k, n) if nb == 1 else (nb, k, n), generator=g, device=dev)
        s = 0.5 + torch.rand((m, n), generator=g, device=dev)

        def run(sv=None, config=None):
            return (pcg2.gemm(a, b, sv, config) if nb == 1
                    else pcg2.gemm_batched(a, b, sv, config=config))

        want = pcg2.gemm_plain(a, b)
        c = run()
        ok = torch.equal(c, want) and torch.equal(run(), c) and torch.equal(run(s), want / s)
        forced = [torch.equal(run(config=i), c) for i in range(len(cfgs))]
        dt = profile_device(run, 10)
        print(json.dumps(dict(kernel="dp_sgemm", shape=[m, n, k, nb],
                              plan=pcg2.gemm_plan(m, n, nb), bit_equal_to_plain=ok,
                              every_configuration_bit_equal=all(forced),
                              device_us_per_launch=dt["device_us_per_launch"],
                              tflops=2.0 * m * n * k * nb / dt["device_us_per_launch"] / 1e6)),
              flush=True)
        if not (ok and all(forced)):
            fail(f"dp_sgemm {m}x{n}x{k} x {nb}: not the fmaf chain's bits (plan {ok}, "
                 f"configurations {forced})")
    m, n, k = 128, 16384, 128
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((k, n), generator=g, device=dev)
    ez, eyx = torch.randn(m, generator=g, device=dev), torch.randn(n, generator=g, device=dev)
    ez[0], eyx[0] = 0.0, 0.0  # a singular mode
    w = torch.full((1,), 0.7, device=dev)
    want = pcg2.gemm_plain(a, b, sep=(ez, eyx, w))
    got = [pcg2.gemm_div_sep(a, b, ez, eyx, w, config=i) for i in [None, *range(len(cfgs))]]
    if not all(torch.equal(x, want) for x in got) or got[0][0, 0] != 0:
        fail("dp_sgemm's separable divide: not the fmaf chain's bits")
    print(json.dumps(dict(kernel="dp_sgemm", shape=[m, n, k, 1], epilogue="div_sep",
                          plan=pcg2.gemm_plan(m, n, 1), bit_equal_to_plain=True,
                          every_configuration_bit_equal=True)), flush=True)


# -- phases 2n and 18: the rank-3 pressure loop (row 10e, row 16-3d) and the bounded 3-D
# lid-driven cavity -----------------------------------------------------------------------

CAV3_N = 128  # 18b-c: the 3-D cavity at N = 128 (a (129, 128, 128) pressure grid)
CAV3_SMALL = 16  # 18a: card vs CPU
CAV3_SMALL_STEPS = 5
CAV3_SMALL_UNROLL = 3
CAV3_NU = 1e-3  # Re 1000, bench.py workload_cavity's viscosity
CAV3_TOL = 1e-6  # tests/test_3d.py test_cavity_3d_smoke's advection and pressure tol
CAV3_SPINUP = 400
CAV3_CALL = 100
CAV3_CALLS = 2
CAV3_CG_STEPS = 20
CAV3_CG_UNROLL = 2  # 18c: the gated adjoints of a 2-step rollout gradient under CG
RANK3_KERNELS = ("pcg_residual3", "pcg_apply3", "cg_iteration3", "spectral_apply3")


def cavity3d_case(n, dev, kind="dct"):
    """(domain, sim, dt) of the bounded 3-D lid-driven cavity: the JAX
    package's tests/test_3d.py configuration (an (n + 1, n, n) grid, axes
    (y, x, z), box (1 + 1/n, 1, 1), OPEN, the rank-deficient pressure
    system, AdvectionSolver(max_iterations=200), PressureSolver(
    max_iterations=800, deflate_mean=True) with `kind` forward and adjoint)
    at viscosity 1e-3 (Re 1000) and dt 0.2 / n."""
    from diffpiso_tpu_torch import Box, Domain, OPEN
    from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks_3d
    from diffpiso_tpu_torch.core.piso import SimulationParameters
    from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver

    dm, dv, act, acc, ns = lid_driven_cavity_masks_3d(n, device=dev)
    domain = Domain((n + 1, n, n), Box.from_size((1.0 + 1.0 / n, 1.0, 1.0)), boundaries=OPEN)
    sim = SimulationParameters(
        dirichlet_mask=dm, dirichlet_values=dv, active_mask=act, accessible_mask=acc,
        no_slip_mask=ns, viscosity=CAV3_NU, laplace_rank_deficient=True,
        bool_periodic=(False,) * 3, linear_solver=AdvectionSolver(max_iterations=200),
        pressure_solver=PressureSolver(max_iterations=800, deflate_mean=True,
                                       preconditioner=kind, adjoint_preconditioner=kind))
    return domain, sim, 0.2 / n


def cavity3d_step(domain, sim, dt):
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None, full_output=False):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=CAV3_TOL, pressure_tol=CAV3_TOL,
                         full_output=full_output)

    return step


def dyadic(v, mean_free=False):
    """`v` rounded to k 2^m with |k| <= K, K = 2^24 // cells (at least 1):
    every float32 sum over the volume is then exact in any order, so the
    shift term shift * sum(.) of the kernels and of torch.sum agree bit for
    bit. `mean_free`: the first |sum k| cells that can move one step toward
    it do, so the sum is exactly 0, as the deflated loops' iterates are
    (a large exact sum would make the shift term a constant far above the
    deflated residual, and the mean, a sum in another order in each
    version, would then differ at that constant's rounding)."""
    import math

    import torch

    kmax = max(1, 2 ** 24 // v.numel())
    if mean_free:
        v = v - torch.mean(v)
    # a step that keeps max|v| within K; where K < 4 (256^3 and up) one of the
    # size of v's spread, so that most cells stay off 0 (the rest clip to +-K)
    step = 2.0 ** (math.ceil(math.log2(max(float(v.abs().max()), 1e-30) / kmax)) if kmax >= 4
                   else round(math.log2(max(float(v.std()), 1e-30))))
    k = torch.clamp(torch.round(v / step), -kmax, kmax).reshape(-1)
    if mean_free:
        d = int(k.double().sum())
        if d:
            room = torch.nonzero(k > -kmax if d > 0 else k < kmax).flatten()
            if room.numel() < abs(d):
                fail("dyadic: too few cells to make the sum 0")
            k[room[:abs(d)]] -= 1.0 if d > 0 else -1.0
    return k.reshape(v.shape) * step


# 2n: the relative error a rank-3 scalar may have against its plain
# version. The kernels take their sums as fixed-order block sums, torch.sum
# in its own order: rnorm (a max), p.q (the form p A p) and alpha agree to
# rounding, as in phase 2i. beta = -r'.q / p.q sums terms of both signs (r'
# is what the update leaves), so it cancels: it lay up to 5.59e-5 from
# plain on the N = 128 cavity's system (PERF.md, 2n). A block sum lost or
# counted twice moves a sum by about 1 / blocks (at least 1 / 4096 on these
# grids), which every limit catches.
RANK3_SCALAR_REL = 1e-5
RANK3_BETA_REL = 1e-4
# 2n: row 16-3d's rel l2 from the float64 apply on the dyadic iterate's
# residual. Its low modes cancel in the analysis, and the GEMM's single
# running k sum carries the rounding of its wandering partials there: at
# 256^3 it lay 1.13e-5 from float64 (torch.matmul 2.2e-6), past the 1e-5
# bar against plain that the loop's own residual meets (PERF.md, 2n).
RANK3_WHITE_F64 = 2e-5


def kernels_vs_plain_solves(label, solves, names, plains, slack, module=None,
                            phase="2n") -> dict:
    """Each solve of `solves` ({how: () -> SolveResult}) once with the
    kernels and once with `module`'s (default `krylov`) attributes `names`
    bound to the plain versions `plains`, on the card: iterations within
    `slack` and not 0, no warn, x within rel 1e-4. Returns {how: the
    kernels' iterations}."""
    from diffpiso_tpu_torch.solvers import krylov

    module = krylov if module is None else module
    its = {}
    for how, solve in solves.items():
        res_k = solve()
        saved = [getattr(module, nm) for nm in names]
        for nm, fn in zip(names, plains):
            setattr(module, nm, fn)
        try:
            res_p = solve()
        finally:
            for nm, fn in zip(names, saved):
                setattr(module, nm, fn)
        rx = rel_err(res_k.x, res_p.x)
        print(f"{phase} {label} ({how}): iterations kernels {res_k.iterations} plain "
              f"{res_p.iterations}, residual kernels {res_k.residual_norm:.3e} plain "
              f"{res_p.residual_norm:.3e}, x rel err {rx:.3e}", flush=True)
        if abs(res_k.iterations - res_p.iterations) > slack or res_k.iterations == 0:
            fail(f"{label} ({how}): iterations {res_k.iterations} vs plain "
                 f"{res_p.iterations} (slack {slack}), or 0")
        if res_k.warn or not rx <= 1e-4:
            fail(f"{label} ({how}): warned or x rel err {rx:.3e} > 1e-4")
        its[how] = res_k.iterations
    return its


def cg_plain_step(*args, sum_p=None, **kw):
    """`cg.cg_iteration_plain` in the place of `krylov.fused_cg_iteration`:
    its outputs and no carried sum (the plain version forms sum p itself)."""
    from diffpiso_tpu_torch.solvers import cg as cgk

    return (*cgk.cg_iteration_plain(*args, **kw), None)


# kernels a call of row 10e launches: by (phase, deflate), and for the CG
# iteration by (deflate, sum of p carried in)
RANK3_CALL_KERNELS = {("residual", False): 2, ("residual", True): 3, ("apply", False): 3,
                      ("apply", True): 4, (False, False): 4, (False, True): 3, (True, False): 5,
                      (True, True): 4}


def rank3_exact_check(label, lap, b, x, r, p, rz, deflate) -> None:
    """Phase 2n's bit-for-bit check of row 10e against its exact versions
    (`pcgphases.residual_exact`, `pcg_apply_exact`,
    `cg.cg_iteration3_exact`: the plain arithmetic with every sum in the
    kernels' order): the residual, the apply, and two chained CG
    iterations, the first forming sum p, the second taking the first's sum
    p' (as `krylov.cg` carries it); each call's kernels counted
    (RANK3_CALL_KERNELS)."""
    import torch

    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import pcgphases as ph

    def held(what, pairs, wrapper, k0, want):
        bad = [k for k, (a, w) in pairs.items() if not torch.equal(a, w)]
        launched = wrapper.kernel_launches - k0
        print(f"2n {label} row 10e {what} deflate={deflate}: bit-equal to exact: {not bad}; "
              f"kernels {launched} (expected {want})", flush=True)
        if bad:
            fail(f"{label} row 10e {what} deflate={deflate}: {', '.join(bad)} not bit-equal to "
                 "the exact version")
        if launched != want:
            fail(f"{label} row 10e {what} deflate={deflate}: {launched} kernels, expected {want}")

    k0 = ph.fused_residual3.kernel_launches
    kr, kn = ph.fused_residual(lap, b, x, deflate)
    er, en, _ = ph.residual_exact(lap, b, x, deflate)
    held("residual", {"r": (kr, er), "rnorm": (kn, en)}, ph.fused_residual3, k0,
         RANK3_CALL_KERNELS[("residual", deflate)])
    k0 = ph.fused_pcg_apply3.kernel_launches
    ka = ph.fused_pcg_apply(lap, rz, x, r, p, deflate)
    ea = ph.pcg_apply_exact(lap, rz, x, r, p, deflate)
    held("apply", dict(zip(("x'", "r'", "rnorm", "p.q"), zip(ka, ea[:4]))), ph.fused_pcg_apply3,
         k0, RANK3_CALL_KERNELS[("apply", deflate)])
    sp = None
    for call in range(2):
        k0 = cgk.fused_cg_iteration3.kernel_launches
        got = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True, sum_p=sp)
        xe, re_, pe, ne, slots = cgk.cg_iteration3_exact(lap, x, r, p, deflate, sum_p=sp)
        pairs = {"x'": (got[0], xe), "r'": (got[1], re_), "p'": (got[2], pe),
                 "rnorm": (got[3], ne), "p.q": (got[4][0], slots[ph.O3_PQ]),
                 "alpha": (got[4][1], slots[ph.O3_ALPHA]), "beta": (got[4][2], slots[ph.O3_BETA]),
                 "sum p'": (got[5], slots[ph.O3_SUMP])}
        held(f"CG iteration call {call} (sum p {'carried' if sp is not None else 'formed'})",
             pairs, cgk.fused_cg_iteration3, k0, RANK3_CALL_KERNELS[(deflate, sp is not None)])
        x, r, p, sp = got[0], got[1], got[2], got[5]


def rank3_kernel_counts() -> dict:
    """Row 10e's kernels launched so far (its wrappers' `kernel_launches`)."""
    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import pcgphases

    return {"pcg_residual3": pcgphases.fused_residual3.kernel_launches,
            "pcg_apply3": pcgphases.fused_pcg_apply3.kernel_launches,
            "cg_iteration3": cgk.fused_cg_iteration3.kernel_launches}


def rank3_kernels_check(label, k0: dict, derived: dict, d: dict) -> dict:
    """Row 10e's kernels since `k0` against the calls the loops derive
    (`derived`, with the counter deltas `d`): every 3-D pressure solve
    deflates, so a residual launches 3, an apply 4, a CG iteration 4 and
    one more where it forms the sum of p (each CG loop's first iteration
    and each reset's). Returns the kernels by wrapper."""
    got = {k: v - k0[k] for k, v in rank3_kernel_counts().items()}
    want = {"pcg_residual3": 3 * derived.get("pcg_residual3", 0),
            "pcg_apply3": 4 * derived.get("pcg_apply3", 0),
            "cg_iteration3": 4 * derived.get("cg_iteration3", 0)
            + (d.get("cg_loops", 0) + d.get("cg_resets", 0) if derived.get("cg_iteration3")
               else 0)}
    if got != want:
        fail(f"{label}: row 10e kernels {got}, the loops derive {want}")
    return got


def rank3_kernels(dev, label, lap, b, guess, precond, spec=None, cg_solves=False) -> dict:
    """Phase 2n: row 10e (the residual, the PCG apply, the CG iteration) and,
    with `spec` = (MatmulSpectralSolver, weights), row 16-3d against their
    plain versions on the card, on a real 3-D pressure system (`lap`, the
    right-hand side `b` of a step and a warm guess), deflation off and on:
    x and p on the dyadic grid (`dyadic`: exact sums), p = M^-1 r of the
    state's own preconditioner `precond`, both mean-free (exactly) when
    deflating. The volumes within rel 1e-6 of
    their scale plus what the measured alpha / beta differences carry into
    them (phase 2i's bar: the scalars are ratios of sums taken in another
    order); the scalars within RANK3_SCALAR_REL (beta RANK3_BETA_REL) of
    plain. Row 16-3d on the loop's first residual (of the warm guess)
    within rel l2 1e-5 of the six contractions and the divide, the same
    bits on a repeated call; on the dyadic x's residual (white in x: the
    worst-conditioned input) within rel l2 RANK3_WHITE_F64 of the float64
    apply, and the same errors of the plain version reported. Whole solves, the kernels against the plain
    versions on the card (`kernels_vs_plain_solves`): with `spec`, one PCG
    solve forward (warm, resets every 50) and adjoint (cold), equal
    iterations; with `cg_solves`, one CG solve as the 3-D cavity's step
    runs it (warm, tol CAV3_TOL, resets every 50, 800 iterations at most)
    and one cold solve of the unit-scaled right-hand side to 1e-4 (some
    hundred iterations, every reset's residual), iterations within
    CG_ITER_SLACK. Returns {row: measurements}."""
    import torch

    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import krylov, pcgphases, spectral_apply3
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply3_plain

    shape = tuple(b.shape)
    cells = b.numel()
    vol = cells * 4
    out = {k: dict(shape=list(shape), max_abs_err=0.0, scalars_max_rel_err=0.0)
           for k in RANK3_KERNELS[:3]}

    def rel(a, w):
        return float((a - w).abs() / w.abs().clamp_min(1e-30))

    def check(name, got, want, carried):
        for a, w, c in zip(got, want, carried):
            e = float((a - w).abs().max())
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
            if not e <= 1e-6 * float(w.abs().max()) + c:
                fail(f"{label} {name}: kernel vs plain {e:.3e} beyond rel 1e-6 of the scale "
                     f"{float(w.abs().max()):.3e} plus {c:.3e} carried")

    inputs = {}
    for deflate in (False, True):
        # deflating, x and p are mean-free, as the loop's iterates are
        x = dyadic(guess, deflate)
        kr, pr = pcgphases.fused_residual(lap, b, x, deflate), pcgphases.residual_plain(
            lap, b, x, deflate)
        check("pcg_residual3", kr[:1], pr[:1], (0.0,))
        r = pr[0]
        p = dyadic(precond(r), deflate)
        rz = torch.sum(r * p)
        q_max = float(pcgphases.lap_matvec(lap, p).abs().max())
        p_max = float(p.abs().max())
        ka = pcgphases.fused_pcg_apply(lap, rz, x, r, p, deflate)
        pa = pcgphases.pcg_apply_plain(lap, rz, x, r, p, deflate)
        d_alpha = abs(float(rz / ka[3]) - float(rz / pa[3]))
        check("pcg_apply3", ka[:2], pa[:2], (d_alpha * p_max, d_alpha * q_max))
        kc = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True)
        pc = cgk.cg_iteration_plain(lap, x, r, p, deflate, with_scalars=True)
        da, db = (float((kc[4][i] - pc[4][i]).abs()) for i in (1, 2))
        check("cg_iteration3", kc[:3], pc[:3],
              (da * p_max, da * q_max, da * q_max + db * p_max))
        # rnorm; rnorm, p.q; rnorm, p.q, alpha, beta
        srel = {"pcg_residual3": [rel(kr[1], pr[1])],
                "pcg_apply3": [rel(ka[2], pa[2]), rel(ka[3], pa[3])],
                "cg_iteration3": [rel(kc[3], pc[3])] + [rel(a, w) for a, w in zip(kc[4], pc[4])]}
        for k, v in srel.items():
            out[k]["scalars_max_rel_err"] = max(out[k]["scalars_max_rel_err"], max(v))
        print(json.dumps(dict(check=f"2n {label} row 10e, deflate={deflate}",
                              scalars_rel_err=srel)), flush=True)
        for k, v in srel.items():
            limits = [RANK3_SCALAR_REL] * len(v)
            if k == "cg_iteration3":
                limits[3] = RANK3_BETA_REL
            if not all(e <= lim for e, lim in zip(v, limits)):
                fail(f"{label} {k} deflate={deflate}: scalars rel err {v} beyond {limits}")
        rank3_exact_check(label, lap, b, x, r, p, rz, deflate)
        if not deflate:
            inputs = {"pcg_residual3": (lap, b, x, False),
                      "pcg_apply3": (lap, rz, x, r, p, False),
                      "cg_iteration3": (lap, x, r, p, False)}
    ops = (lap.center, *lap.lo, *lap.hi)
    csr = csr_of_stencil3(*ops)
    xv = inputs["pcg_residual3"][2].reshape(-1, 1)
    spmv_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, xv), 20)
    spmv_dev = library_device_time(lazy_call(lambda: csr_of_stencil3(*ops),
                                             lambda m: torch.sparse.mm(m, xv)))
    del csr
    # per call: volumes in and out; flops per cell (7-point stencil and shift 15, the
    # updates and dot products)
    for name, fn, plain, vols, flops in (
            ("pcg_residual3", pcgphases.fused_residual, pcgphases.residual_plain, 10, 17),
            ("pcg_apply3", pcgphases.fused_pcg_apply, pcgphases.pcg_apply_plain, 12, 22),
            ("cg_iteration3", cgk.fused_cg_iteration, cgk.cg_iteration_plain, 13, 28)):
        a = inputs[name]
        b_ms, b_by = bound(vols * vol, flops * cells)
        out[name].update(
            ms=cuda_time_ms(lambda fn=fn, a=a: fn(*a), 50),
            plain_ms=cuda_time_ms(lambda plain=plain, a=a: plain(*a), 20),
            **device_time(lambda fn=fn, a=a: fn(*a)), bound_ms=b_ms, bound_by=b_by,
            # yardstick of the matvec part: one cuSPARSE CSR SpMV of the 7-point operator
            library_ms=spmv_ms, **spmv_dev)
    if cg_solves:
        def cg_solve(cold):
            rhs = b / b.abs().max() if cold else b
            return krylov.cg(lap, rhs, None if cold else guess, tol=1e-4 if cold else CAV3_TOL,
                             max_iter=2000 if cold else 800, residual_reset=50,
                             deflate_mean=True)

        its = kernels_vs_plain_solves(
            f"{label} pressure CG",
            {"forward, warm": lambda: cg_solve(False), "cold, unit scale": lambda: cg_solve(True)},
            ("fused_residual", "fused_cg_iteration"),
            (pcgphases.residual_plain, cg_plain_step), CG_ITER_SLACK)
        for name in ("pcg_residual3", "cg_iteration3"):
            out[name]["cg_solve_iterations"] = its
    if spec is None:
        return out

    solver, weights = spec
    ops3 = spectral_apply3.spectral3_operands(solver, weights, torch.float32, dev)
    sym = safe_symbol(solver, weights, torch.float32, dev)
    mats64 = [(v.double(), vt.double()) for v, vt in ops3.mats]

    def accuracy(r):
        z = spectral_apply3.fused_spectral_apply_3d(ops3, r)
        want = spectral_apply3_plain(ops3.mats, sym, r)
        z64 = spectral_apply3_plain(mats64, sym.double(), r.double())
        return z, want, dict(rel_l2_vs_plain=rel_l2(z, want),
                             kernel_rel_l2_vs_float64=rel_l2(z.double(), z64),
                             plain_rel_l2_vs_float64=rel_l2(want.double(), z64))

    # the dyadic iterate's residual, whose spectrum is the stencil's image of
    # a near-white field (high modes dominate r, low modes z), the worst
    # conditioning a residual can have here; and the loop's own first
    # residual, of the warm guess
    white_r = pcgphases.residual_plain(lap, b, dyadic(guess, True), True)[0]
    white = accuracy(white_r)[2]
    r = pcgphases.residual_plain(lap, b, guess, True)[0]
    z, want, acc = accuracy(r)
    repeat = torch.equal(z, spectral_apply3.fused_spectral_apply_3d(ops3, r))
    nz, ny, nx = shape
    b_ms, b_by = bound((2 * cells + 2 * (nz * nz + ny * ny + nx * nx) + nz + ny * nx) * 4,
                       4.0 * cells * (nz + ny + nx) + cells)
    # the plain version is the six torch.matmul contractions (cuBLAS) and the
    # divide: one timing is both the plain and the library reading
    plain_ms = cuda_time_ms(lambda: spectral_apply3_plain(ops3.mats, sym, r), 10)
    out["spectral_apply3"] = dict(
        shape=list(shape), **acc, repeat_bit_equal=repeat, dyadic_residual=white,
        max_abs_err=float((z - want).abs().max()),
        ms=cuda_time_ms(lambda: spectral_apply3.fused_spectral_apply_3d(ops3, r), 10),
        plain_ms=plain_ms, library_ms=plain_ms,
        **device_time(lambda: spectral_apply3.fused_spectral_apply_3d(ops3, r), 5),
        bound_ms=b_ms, bound_by=b_by)
    del white_r
    print(json.dumps(dict(check=f"2n {label} row 16-3d", **{
        k: v for k, v in out["spectral_apply3"].items() if k != "_device_time"})), flush=True)
    rl2, w64 = acc["rel_l2_vs_plain"], white["kernel_rel_l2_vs_float64"]
    if not (rl2 <= 1e-5 and w64 <= RANK3_WHITE_F64 and repeat):
        fail(f"{label} spectral_apply3: rel l2 {rl2:.3e} vs plain (limit 1e-5), on the dyadic "
             f"residual {w64:.3e} vs float64 (limit {RANK3_WHITE_F64}), repeat bit-equal {repeat}")

    # one whole solve each way, the kernels against the plain versions on the
    # card (the adjoint form in the loop: the path gives it to row 15g, 2o)
    def solve(adjoint):
        rhs = 2.0 * b if adjoint else b
        with whole_solve_closed():
            return krylov.pcg(lap, rhs, None if adjoint else guess, precond_mm=spec,
                              tol=P_TOL * (max(1.0, float(rhs.abs().max())) if adjoint else 1.0),
                              max_iter=2000, residual_reset=0 if adjoint else 50,
                              deflate_mean=True, precond_zero_mean=True,
                              early_exit=not adjoint)

    solves = kernels_vs_plain_solves(
        f"{label} pressure PCG",
        {"forward, warm": lambda: solve(False), "adjoint, cold": lambda: solve(True)},
        ("fused_residual", "fused_pcg_apply", "fused_pcg_update", "fused_spectral_apply_3d"),
        (pcgphases.residual_plain, pcgphases.pcg_apply_plain, pcgphases.pcg_update_plain,
         lambda o, v: spectral_apply3_plain(o.mats, sym, v)), 0)
    for name in RANK3_KERNELS[:3]:
        out[name]["solve_iterations"] = solves
    return out


@contextlib.contextmanager
def whole_solve_closed():
    """The adjoint-form volume solves in the per-iteration loop (row 10e)
    instead of the whole solve of row 15g (as the CPU tests reach it: there
    is no knob)."""
    from diffpiso_tpu_torch.solvers import tiers

    real = tiers.volume_whole_solve
    tiers.volume_whole_solve = lambda *a, **k: False
    try:
        yield
    finally:
        tiers.volume_whole_solve = real


# row 15g's launch wrappers (solvers/pcg3.py), in the order of one iteration
PCG3_KERNELS = ("pcg3_residual", "pcg3_q", "pcg3_xr", "pcg3_dots", "pcg3_p")
# 2o: the relative error a row 15g scalar may have against its twin (sums in
# another order: rnorm exact, p.q and r.z like row 10e's scalars, which lay
# within 1.16e-6 on these systems, PERF.md); a sum of terms of both signs
# (sum r', sum z, sum p') is judged against the sum of their magnitudes
PCG3_SCALAR_REL = 1.2e-6
PCG3_RESULTS = {}


# kernels a call of each row-15g launch makes (the residual: sum x, then r)
PCG3_CALL_KERNELS = {"pcg3_residual": 2, "pcg3_q": 1, "pcg3_xr": 1, "pcg3_dots": 1, "pcg3_p": 1}


def pcg3_exact_check(label, lap, b, x, p, sp, xr_in, start, dots, rz1, rz, out) -> None:
    """Phase 2o's bit-for-bit check of row 15g's scalars: each launch called
    once through a solve's scratch (`Pcg3Work`) on phase 2o's inputs, every
    sum it forms (sum x, p.q, sum r', r.z, sum z, sum r, sum p') bit-equal
    to `pcgphases.tree_sum_plain(..., max_blocks=P3_MAX_BLOCKS)` of the same
    terms (the kernel's own output volumes), every norm to the max of |.|
    of its volume, and each call's kernels (the wrapper's
    `kernel_launches`) as PCG3_CALL_KERNELS says. Marks `out` (phase 2o's
    results) with bit_equal_to_tree_sum and kernels_per_call."""
    import torch

    from diffpiso_tpu_torch.solvers import pcg3
    from diffpiso_tpu_torch.solvers.pcgphases import _MAX_BLOCKS3, tree_sum_plain

    def ts(v):
        return tree_sum_plain(v, max_blocks=_MAX_BLOCKS3)

    w = pcg3.Pcg3Work("2o", lap, b)

    def call(name, *args):
        wrapper = getattr(pcg3, name)
        k0 = wrapper.kernel_launches
        res = wrapper(*args, work=w)
        got = wrapper.kernel_launches - k0
        out[name]["kernels_per_call"] = got
        if got != PCG3_CALL_KERNELS[name]:
            fail(f"{label} {name}: {got} kernels a call, expected {PCG3_CALL_KERNELS[name]}")
        return res

    pairs = []
    r, norm = call("pcg3_residual", lap, b, x)
    pairs += [("pcg3_residual", "sum x", w.out[2].clone(), ts(x)),
              ("pcg3_residual", "max|r|", norm.clone(), r.abs().max())]
    q, pq = call("pcg3_q", lap, p, sp)
    pairs.append(("pcg3_q", "p.q", pq.clone(), ts(p * q)))
    _, ro, rnorm, sr = call("pcg3_xr", *xr_in)
    pairs += [("pcg3_xr", "sum r'", sr.clone(), ts(ro)),
              ("pcg3_xr", "max|r'|", rnorm.clone(), ro.abs().max())]
    (r0, z0), (r1, z1) = start, dots
    rzs, sz, sr0 = (t.clone() for t in call("pcg3_dots", r0, z0, True))
    pairs += [("pcg3_dots", "r.z (start)", rzs, ts(r0 * z0)), ("pcg3_dots", "sum z", sz, ts(z0)),
              ("pcg3_dots", "sum r", sr0, ts(r0))]
    pairs.append(("pcg3_dots", "r.z", call("pcg3_dots", r1, z1, False).clone(), ts(r1 * z1)))
    pn, spn = call("pcg3_p", z1, p, rz1, rz)
    pairs.append(("pcg3_p", "sum p'", spn, ts(pn)))
    for name, what, got, want in pairs:
        eq = torch.equal(got.reshape(()), want.reshape(()))
        out[name]["bit_equal_to_tree_sum"] = out[name].get("bit_equal_to_tree_sum", True) and eq
        if not eq:
            fail(f"{label} {name}: {what} {float(got)!r} is not tree_sum_plain's "
                 f"{float(want)!r}")
    print(f"{label} row 15g: every sum bit-equal to tree_sum_plain, kernels a call "
          f"{ {k: out[k]['kernels_per_call'] for k in PCG3_KERNELS} }", flush=True)


def pcg3_kernels(dev, label, lap, b, guess, spec) -> dict:
    """Phase 2o: row 15g's launches against their plain twins on the card, on
    a real 3-D pressure system (`lap`, the right-hand side `b` of a step, a
    warm guess; `spec` = (MatmulSpectralSolver, weights)), x and p on the
    dyadic grid (`dyadic`: exact sums, so sum x and sum p agree bit for
    bit): the residual, q, xr and p volumes bit-equal given the same
    scalars, the norms equal, p.q and r.z within PCG3_SCALAR_REL, the sums
    within it of their terms' magnitudes; then every scalar a launch forms
    bit-equal to `pcgphases.tree_sum_plain` (the kernels' order) of the same
    terms, with each call's kernels counted (`pcg3_exact_check`; M^-1 r is
    row 16-3d's apply,
    which 2n holds on the same systems). Host ms, device us per launch, the
    bound (bytes: 10 / 9 / 6 / 2 / 3 volumes), the plain twin's ms, the
    library's (a cuSPARSE CSR SpMV of the 7-point operator for the stencil
    launches; torch.dot for r.z).
    Then whole solves of row 15g, the kernels against the twins on the card:
    cold, warm from a zeros guess and warm from half the step's increment,
    in the adjoint form (no reset, no early exit): equal iterations.
    Returns {launch: measurements}."""
    import torch

    from diffpiso_tpu_torch.solvers import krylov, pcg3, pcgphases, spectral_apply3
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply3_plain

    solver, weights = spec
    ops = spectral_apply3.spectral3_operands(solver, weights, torch.float32, dev)
    plain_ops = spectral_apply3.Spectral3(ops.mats, None, None, None,
                                          safe_symbol(solver, weights, torch.float32, dev))
    shape = tuple(b.shape)
    cells = b.numel()
    vol = cells * 4
    out = {k: dict(shape=list(shape), max_abs_err=0.0, scalars_max_rel_err=0.0, bit_equal=True)
           for k in PCG3_KERNELS}

    def vols(name, got, want):
        for a, w in zip(got, want):
            eq = torch.equal(a, w)
            out[name]["bit_equal"] = out[name]["bit_equal"] and eq
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], float((a - w).abs().max()))
            if not eq:
                fail(f"{label} {name}: kernel volume differs from its twin (max abs "
                     f"{float((a - w).abs().max()):.3e})")

    def scal(name, got, want, terms=None):
        scale = abs(float(want)) if terms is None else float(terms.abs().sum())
        e = abs(float(got) - float(want)) / max(scale, 1e-30)
        out[name]["scalars_max_rel_err"] = max(out[name]["scalars_max_rel_err"], e)
        if not e <= PCG3_SCALAR_REL:
            fail(f"{label} {name}: scalar {float(got)!r} vs twin {float(want)!r}, rel {e:.3e} > "
                 f"{PCG3_SCALAR_REL}")

    # the warm entry's residual on a dyadic x (an exact sum: the shift term agrees)
    xd = dyadic(guess)
    kr, pr = pcg3.pcg3_residual(lap, b, xd), pcg3.residual_plain(lap, b, xd)
    vols("pcg3_residual", kr[:1], pr[:1])
    scal("pcg3_residual", kr[1], pr[1])
    # one iteration from the mean-free dyadic x: r, z = M^-1 r, p on the dyadic grid
    x = dyadic(guess, True)
    r = pcg3.residual_plain(lap, b, x)[0]
    def precond_plain(v):
        return spectral_apply3_plain(plain_ops.mats, plain_ops.sym, v)

    z = precond_plain(r)
    kd, pd = pcg3.pcg3_dots(r, z, start=True), pcg3.dots_plain(r, z, True)
    scal("pcg3_dots", kd[0], pd[0])
    scal("pcg3_dots", kd[1], pd[1], z)
    scal("pcg3_dots", kd[2], pd[2], r)
    p = dyadic(z)
    sp = torch.sum(p)
    kq, pq_ = pcg3.pcg3_q(lap, p, sp), pcg3.q_plain(lap, p, sp)
    vols("pcg3_q", kq[:1], pq_[:1])
    scal("pcg3_q", kq[1], pq_[1])
    q, pq = pq_
    rz, sr = torch.sum(r * p), torch.sum(r)
    xr_in = (x, r, p, q, rz, pq, sr, 1.0, float(cells))
    kx, px = pcg3.pcg3_xr(*xr_in), pcg3.xr_plain(*xr_in)
    vols("pcg3_xr", kx[:2], px[:2])
    scal("pcg3_xr", kx[2], px[2])
    scal("pcg3_xr", kx[3], px[3], px[1])
    r1 = px[1]
    z1 = precond_plain(r1)
    scal("pcg3_dots", pcg3.pcg3_dots(r1, z1), pcg3.dots_plain(r1, z1, False))
    rz1 = torch.sum(r1 * z1)
    kp, pp = pcg3.pcg3_p(z1, p, rz1, rz), pcg3.p_plain(z1, p, rz1, rz)
    vols("pcg3_p", kp[:1], pp[:1])
    scal("pcg3_p", kp[1], pp[1], pp[0])
    pcg3_exact_check(label, lap, b, xd, p, sp, xr_in, (r, z), (r1, z1), rz1, rz, out)
    print(json.dumps(dict(check=f"2o {label} row 15g launches vs their twins", **{
        k: {kk: vv for kk, vv in v.items() if kk != "shape"} for k, v in out.items()})),
          flush=True)

    # timings at the path's shapes; the stencil launches' yardstick one cuSPARSE SpMV
    csr = csr_of_stencil3(lap.center, *lap.lo, *lap.hi)
    xv = x.reshape(-1, 1)
    spmv_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, xv), 20)
    del csr

    def spmv_dev():
        return library_device_time(lazy_call(
            lambda: csr_of_stencil3(lap.center, *lap.lo, *lap.hi),
            lambda m: torch.sparse.mm(m, xv)), 5)

    def dot_dev():
        return library_device_time(lambda: torch.dot(r1.reshape(-1), z1.reshape(-1)), 5)

    rows = (
        # name, kernel, twin, bytes, flops, library call
        ("pcg3_residual", lambda: pcg3.pcg3_residual(lap, b, xd),
         lambda: pcg3.residual_plain(lap, b, xd), 10 * vol, 17 * cells, spmv_ms),
        ("pcg3_q", lambda: pcg3.pcg3_q(lap, p, sp), lambda: pcg3.q_plain(lap, p, sp),
         9 * vol, 17 * cells, spmv_ms),
        ("pcg3_xr", lambda: pcg3.pcg3_xr(*xr_in), lambda: pcg3.xr_plain(*xr_in), 6 * vol,
         7 * cells, None),
        ("pcg3_dots", lambda: pcg3.pcg3_dots(r1, z1), lambda: pcg3.dots_plain(r1, z1, False),
         2 * vol, 2 * cells,
         cuda_time_ms(lambda: torch.dot(r1.reshape(-1), z1.reshape(-1)), 20)),
        ("pcg3_p", lambda: pcg3.pcg3_p(z1, p, rz1, rz), lambda: pcg3.p_plain(z1, p, rz1, rz),
         3 * vol, 3 * cells, None),
    )
    lib_dev = {"pcg3_residual": spmv_dev, "pcg3_q": spmv_dev, "pcg3_dots": dot_dev}
    for name, fn, plain, nbytes, flops, lib in rows:
        b_ms, b_by = bound(nbytes, flops)
        plain_ms = cuda_time_ms(plain, 10)
        out[name].update(ms=cuda_time_ms(fn, 20), plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib,
                         **device_time(fn, 5), **(lib_dev[name]() if name in lib_dev else {}))

    # whole solves, the kernels against the twins on the card
    def twin(fn):  # the twin in a wrapper's place: the solve's scratch unused
        return lambda *a, work=None: fn(*a)

    twins = (twin(pcg3.residual_plain), twin(pcg3.q_plain), twin(pcg3.xr_plain),
             lambda o, v: precond_plain(v),
             lambda r_, z_, start=False, work=None: pcg3.dots_plain(r_, z_, start),
             twin(pcg3.p_plain), pcgphases.residual_plain)
    rhs = 2.0 * b
    tol = P_TOL * max(1.0, float(rhs.abs().max()))

    def solve(x0):
        return krylov.pcg(lap, rhs, x0, precond_mm=spec, tol=tol, max_iter=2000,
                          residual_reset=0, deflate_mean=True, precond_zero_mean=True,
                          early_exit=False)

    its = kernels_vs_plain_solves(
        f"{label} row 15g whole solve",
        {"cold": lambda: solve(None), "warm from zeros": lambda: solve(torch.zeros_like(b)),
         "warm from half the increment": lambda: solve(2.0 * guess)},
        ("pcg3_residual", "pcg3_q", "pcg3_xr", "fused_spectral_apply_3d", "pcg3_dots", "pcg3_p",
         "fused_residual3"), twins, 0, module=pcg3, phase="2o")
    for name in PCG3_KERNELS:
        out[name]["solve_iterations"] = its
    return out


def pcg3_merge(kernels: list, results: dict) -> None:
    """The kernel entries of row 15g's launches from phase 2o's results
    {label: {launch: measurements}}: the 128^3 turbulence's numbers at the
    top level, the 256^3's beside them."""
    what = {
        "pcg3_residual": ("pcg3.cu (g3_residual)", 1777,
                          "one per warm entry (2 launches: sum x, then r, each folded)"),
        "pcg3_q": ("pcg3.cu (g3_q)", 1789, "one per iteration (1 launch)"),
        "pcg3_xr": ("pcg3.cu (g3_xr)", 1801, "one per iteration (1 launch)"),
        "pcg3_dots": ("pcg3.cu (g3_dots)", 1840,
                      "one per M^-1 r (1 launch; the r.z of :1840; at the start sum z0, "
                      "sum r0)"),
        "pcg3_p": ("pcg3.cu (g3_p)", 1852, "one per iteration (1 launch)"),
    }
    for name in PCG3_KERNELS:
        src, line, count = what[name]
        entry = dict(name=name, route="cuda", source=f"diffpiso_tpu_torch/csrc/{src}",
                     replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}",
                     launches_count=count)
        first = True
        for label, res in results.items():
            if first:
                entry.update(res[name])
                first = False
            else:
                entry[label] = res[name]
        kernels.append(entry)


def rank3_state(step, v, p):
    """(laplacian, first right-hand side, a warm guess that has to iterate)
    of one step from (v, p): the step's own Laplacian and divergence, half
    its first pressure increment."""
    import torch

    o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
    it = o.intermediates
    return it["laplacian"], it["v1_div"], 0.5 * o.pressure_inc1


def rank3_merge(kernels: list, results: dict) -> None:
    """The kernel entries of rows 10e and 16-3d from phase 2n's results
    {label: {row: measurements}}: the 128^3 turbulence's numbers at the
    top level, every state's beside them."""
    meta = {
        "pcg_residual3": ("pcgphases3.cu (p3_residual)", 236,
                          "one per call (2 kernel launches, 3 deflating)"),
        "pcg_apply3": ("pcgphases3.cu (p3_apply)", 1517,
                       "one per call (3 kernel launches, 4 deflating)"),
        "cg_iteration3": ("pcgphases3.cu (p3_cg_iteration)", 325,
                          "one per iteration (3 kernel launches with the sum of p carried, 4 "
                          "where it is formed; one more deflating)"),
        "spectral_apply3": ("spectral3.cu (spec3_apply: csrc/gemm.cuh)", 2559,
                            "one per M^-1 r call (six GEMM launches)"),
    }
    for name in RANK3_KERNELS:
        src, line, count = meta[name]
        entry = dict(name=name, route="cuda", source=f"diffpiso_tpu_torch/csrc/{src}",
                     replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}",
                     launches_count=count)
        first = True
        for label, res in results.items():
            if name not in res:
                continue
            if first:
                entry.update(res[name])
                first = False
            else:
                entry[label] = res[name]
        kernels.append(entry)


def cavity3d_counters() -> dict:
    return dict(turb3d_counters(), **cg_counters())


def cavity3d_derived(c0: dict, c1: dict, tier: str) -> tuple:
    """(the launches the loops derive on the 3-D cavity, counter deltas):
    the momentum tier's kernel and the 7-point matvec of BiCGSTAB's applies
    as `turb3d_derived`; row 10e's residual once per warm entry, reset and
    finished loop of PCG and of CG, its apply and the update (row 10c) once
    per PCG iteration, its CG iteration once per CG iteration; no spectral
    apply (the `dct` preconditioner runs through torch.fft)."""
    derived, d = turb3d_derived(c0, c1, tier)
    derived.pop("spectral_apply3")
    derived["pcg_residual3"] += d["cg_warm_entries"] + d["cg_resets"] + d["cg_loops"]
    derived["cg_iteration3"] = d["cg_iterations"]
    return derived, d


def cavity3d_small_check(dev) -> None:
    """Phase 18a: the 3-D cavity at N = 16 on the card against the plain
    path on the CPU, from rest: 5 steps under `dct` and under plain CG
    (warn 0; the velocity within rtol 2e-4 / atol 2e-5; pressure iterations
    equal under `dct`, within 2 a solve under CG, as 15a), then the 3-step
    rollout gradient under `dct` (rel l2 1e-3, equal gate decisions). Each
    momentum solve's hand-over (the largest Jacobi exit residual of its
    components) may differ between the devices only within 8 ulps of tol,
    as 12a allows; the rest of its record must be equal."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.solvers import base, krylov

    n = CAV3_SMALL
    res = {}
    real, real_bi = krylov.fused_jacobi1_solve_3d, base.bicgstab
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        jac, bi = [], []

        def recorded(st_c, b, x, sgn, transpose, tol, max_sweeps, jac=jac):
            o = real(st_c, b, x, sgn, transpose, tol, max_sweeps)
            jac.append((o[1], float(b.abs().max()), tol))
            return o

        def recorded_bi(*args, bi=bi, **kwargs):
            b0 = loop_counters()
            o = real_bi(*args, **kwargs)
            b1 = loop_counters()
            bi.append(tuple(b1[k] - b0[k] for k in HANDOVER_COUNTERS))
            return o

        krylov.fused_jacobi1_solve_3d, base.bicgstab = recorded, recorded_bi
        t0 = time.perf_counter()
        out = {}
        try:
            for kind in ("dct", None):
                domain, sim, dt = cavity3d_case(n, d, kind)
                step = cavity3d_step(domain, sim, dt)
                v0, p0 = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
                v, p, g1, g2 = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
                iters, warns = [], 0
                for _ in range(CAV3_SMALL_STEPS):
                    o = step(v, p, g1, g2)
                    warns += int(o.warn)
                    v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
                    iters.append(list(o.p_iterations))
                out[str(kind)] = dict(v=[c.cpu() for c in v.components], iters=iters,
                                      warns=warns)
            domain, sim, dt = cavity3d_case(n, d, "dct")
            step = cavity3d_step(domain, sim, dt)
            v0, p0 = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
            gen = np.random.RandomState(18)
            f = StaggeredField(tuple(torch.as_tensor(
                (1e-2 * gen.randn(*c.shape)).astype(np.float32), device=d)
                for c in v0.components), periodic=(False,) * 3)
            r = rollout_loss_grad(step, v0, p0, f, CAV3_SMALL_UNROLL, remat="none")
        finally:
            krylov.fused_jacobi1_solve_3d, base.bicgstab = real, real_bi
        solves = [(max(j[0] for j in jac[i:i + 3]), max(j[1] for j in jac[i:i + 3]), jac[i][2])
                  for i in range(0, len(jac), 3)]
        res[key] = dict(out=out, records=bi, solves=solves, warns=r.warns,
                        grad=[c.cpu().double() for c in r.grad.components],
                        decisions=[(a.system, a.gated) for a in r.adjoints],
                        seconds=time.perf_counter() - t0)
    card, cpu = res["card"], res["cpu"]
    err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
              for kind in card["out"] for a, b in zip(card["out"][kind]["v"], cpu["out"][kind]["v"]))
    g_rel = rel_l2(card["grad"], cpu["grad"])
    differing = []
    for i, (a, b) in enumerate(zip(card["solves"], cpu["solves"])):
        if (a[0] < a[2]) != (b[0] < b[2]):
            differing.append(dict(solve=i, ulps=[abs(x[0] - x[2]) / float(np.spacing(
                np.float32(x[1]))) for x in (a, b)]))
    print(json.dumps(dict(
        check=f"18a 3-D cavity N = {n}: {CAV3_SMALL_STEPS} steps under dct and CG and the "
              f"{CAV3_SMALL_UNROLL}-step rollout gradient, card vs CPU plain path",
        pressure_iters={k: [card["out"][k]["iters"], cpu["out"][k]["iters"]] for k in card["out"]},
        warns=[[card["out"][k]["warns"] for k in card["out"]] + [card["warns"]],
               [cpu["out"][k]["warns"] for k in cpu["out"]] + [cpu["warns"]]],
        handovers_decided_by_rounding=differing, velocity_excess=err, grad_rel_l2=g_rel,
        gated=[sum(g for _, g in card["decisions"]), sum(g for _, g in cpu["decisions"]),
               len(cpu["decisions"])],
        seconds=[card["seconds"], cpu["seconds"]])), flush=True)
    for x in (card, cpu):
        if any(x["out"][k]["warns"] for k in x["out"]) or x["warns"]:
            fail(f"18a 3-D cavity N = {n}: a step warned")
    if len(card["solves"]) != len(cpu["solves"]):
        fail(f"18a: {len(card['solves'])} vs {len(cpu['solves'])} momentum solves")
    for x in differing:
        if not max(x["ulps"]) <= 8:
            fail(f"18a: momentum solve {x['solve']} hands over on one device only, "
                 f"{x['ulps']} ulps from tol (more than 8)")
    skip = {x["solve"] for x in differing}
    for i, (a, b) in enumerate(zip(card["records"], cpu["records"])):
        if i not in skip and a != b:
            fail(f"18a: momentum solve {i} differs, card {a} vs CPU {b}")
    if card["out"]["dct"]["iters"] != cpu["out"]["dct"]["iters"]:
        fail("18a: pressure iterations under dct differ between card and CPU")
    for a, b in zip(card["out"]["None"]["iters"], cpu["out"]["None"]["iters"]):
        if any(abs(x - y) > CG_ITER_SLACK for x, y in zip(a, b)):
            fail(f"18a: CG iterations differ by more than {CG_ITER_SLACK} a solve: {a} vs {b}")
    if card["decisions"] != cpu["decisions"]:
        fail("18a: adjoint gate decisions differ between card and CPU")
    if not err <= 2e-5:
        fail("18a: card steps disagree with the CPU plain path beyond rtol 2e-4, atol 2e-5")
    if not g_rel <= 1e-3:
        fail(f"18a rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def cavity3d_path(dev, wrappers: dict, rank3: dict) -> tuple:
    """Phases 18b and 18c: the 3-D cavity at N = 128 from rest. 18b under
    `dct`: a 400-step spin-up, phase 2n on the spun-up state's pressure
    system (into `rank3`), then 2 timed calls of 100 steps; steps/s,
    pressure iterations a step, the momentum tier with its trips and sweeps,
    max|div v|, peak memory; warn 0; u > 0 in the first fluid row below the
    lid at mid-span; every launch count derived from the loops' counters
    (`cavity3d_derived`): row 10e and the z-block kernel as the counters
    say, row 16-3d and every periodic-only kernel (rows 15a, 15b, 6, 17)
    never. 18c: the same state under plain CG, 20 steps (CG iterations a
    step, row 10e's CG iteration once per iteration, warn as the solver
    reports it), and a 2-step rollout gradient (its gated adjoints).
    Returns (18b's launches, 18c's launches)."""
    import dataclasses

    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.solvers import tiers
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner

    n = CAV3_N

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    def check(what, counts, want):
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"3-D cavity {n} {what}: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")

    domain, sim, dt = cavity3d_case(n, dev, "dct")
    shapes = [tuple(c.shape) for c in sim.dirichlet_mask.components]
    tier = tiers.momentum_tier_3d(shapes)
    bz = [tiers.zblock_eligible(s) for s in shapes]
    print(json.dumps(dict(workload=f"3-D lid-driven cavity N = {n}: setup", face_shapes=shapes,
                          momentum_tier=tier, zblock_bz=bz)), flush=True)
    if tier != "zblock":
        fail(f"3-D cavity {n}: the momentum solves take the {tier} tier, expected zblock")
    step = cavity3d_step(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    t0 = time.perf_counter()
    for k in range(CAV3_SPINUP):
        o = step(v, p, g1, g2)
        if o.warn:
            fail(f"3-D cavity {n} spin-up: step {k} warned")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    torch.cuda.synchronize()
    spinup_s = time.perf_counter() - t0
    lap, b, guess = rank3_state(step, v, p)
    pre = pressure_preconditioner("dct", lap)
    rank3["cavity128"] = rank3_kernels(dev, f"3-D cavity {n}", lap, b, guess,
                                       lambda r: pre(r).contiguous(), cg_solves=True)
    del lap, b, guess

    reset()
    c0, r0 = cavity3d_counters(), rank3_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    iters, warns = [0, 0], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAV3_CALLS):
        v, p, it, w = turb3d_call(step, v, p, CAV3_CALL)
        iters = [iters[0] + it[0], iters[1] + it[1]]
        warns += w
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    derived, d = cavity3d_derived(c0, cavity3d_counters(), tier)
    r10e = rank3_kernels_check(f"3-D cavity {n} dct forward", r0, derived, d)
    S = CAV3_CALLS * CAV3_CALL
    u = v.components[1]
    mid = n // 2
    u_lid = float(u[n - 1, mid, mid])
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    print(json.dumps(dict(
        workload=f"3-D lid-driven cavity N = {n} (({n + 1}, {n}, {n}) cells, Re 1000, "
                 "dt 0.2/N), dct, forward",
        spinup_steps=CAV3_SPINUP, spinup_seconds=spinup_s, steps=S, steps_per_sec=S / elapsed,
        pressure_iters_per_step=[iters[0] / S, iters[1] / S], warn_fraction=warns / S,
        momentum_tier=tier, zblock_bz=bz, trips_per_solve=d["jacobi_trips"] / S,
        sweeps_per_trip=d["jacobi_block_sweeps"] / max(d["jacobi_trips"], 1),
        bicgstab_fallbacks=d["bicgstab_fallbacks"],
        u_first_fluid_row_mid=u_lid, u_bottom_mid=float(u[2, mid, mid]),
        max_abs_div=float((fv_divergence(v, domain.dx)
                           * sim.active_mask[1:-1, 1:-1, 1:-1]).abs().max()),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        memory_allocated_before_bytes=held, loop_counters=d, launches=fwd,
        row10e_kernel_launches=r10e)), flush=True)
    if not finite:
        fail(f"3-D cavity {n}: non-finite state after the forward path")
    if warns:
        fail(f"3-D cavity {n}: warn fraction {warns / S} (must be 0)")
    if not u_lid > 0.0:
        fail(f"3-D cavity {n}: u = {u_lid} in the first fluid row below the lid (must be > 0)")
    if not tier_solves_ok(d, tier, S) or d["pcg_loops"] == 0:
        fail(f"3-D cavity {n}: the counters {d} do not show one z-block momentum solve a step "
             "and the PCG loops")
    # per step: explicit_H's three matvecs (the corrector runs unfused with masks)
    check("dct forward", fwd, dict(derived, stencil_matvec3d=3 * S + derived["stencil_matvec3d"]))

    # 18c: plain CG from the same state
    sim_cg = dataclasses.replace(sim, pressure_solver=dataclasses.replace(
        sim.pressure_solver, preconditioner=None, adjoint_preconditioner=None))
    step_cg = cavity3d_step(domain, sim_cg, dt)
    reset()
    c0, r0 = cavity3d_counters(), rank3_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vc, pc, it, w = turb3d_call(step_cg, v, p, CAV3_CG_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    cg_fwd = read()
    derived, d = cavity3d_derived(c0, cavity3d_counters(), tier)
    r10e = rank3_kernels_check(f"3-D cavity {n} CG forward", r0, derived, d)
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False,) * 3)
    rg = rollout_loss_grad(step_cg, v, p, forcing, CAV3_CG_UNROLL, remat="none")
    p_adj = [a for a in rg.adjoints if a.system == "pressure"]
    print(json.dumps(dict(
        workload=f"3-D lid-driven cavity N = {n}, plain CG (preconditioner None), forward "
                 f"from the dct run's state, and a {CAV3_CG_UNROLL}-step rollout gradient",
        steps=CAV3_CG_STEPS, steps_per_sec=CAV3_CG_STEPS / elapsed,
        cg_iters_per_step=[it[0] / CAV3_CG_STEPS, it[1] / CAV3_CG_STEPS],
        warn_fraction=w / CAV3_CG_STEPS, loop_counters=d, launches=cg_fwd,
        row10e_kernel_launches=r10e,
        grad_warns=rg.warns, adjoint_cg_iters=[a.iterations for a in p_adj],
        adjoint_gated=[sum(a.gated for a in rg.adjoints if a.system == s)
                       for s in ("momentum", "pressure")])), flush=True)
    if d["cg_iterations"] == 0 or d["pcg_loops"] != 0:
        fail(f"3-D cavity {n} under CG: the counters {d} do not show the CG loop alone")
    if w:
        print(f"3-D cavity {n} under CG: {w} of {CAV3_CG_STEPS} steps warned (the solver "
              "reports it; plain CG's max_iterations 800)", flush=True)
    check("CG forward", cg_fwd,
          dict(derived, stencil_matvec3d=3 * CAV3_CG_STEPS + derived["stencil_matvec3d"]))
    return fwd, cg_fwd


def turb3d_rank3(dev, n, state) -> dict:
    """Phases 2n and 2o on the 3-D turbulence at n^3: the pressure system of
    one step from `state` (the state the spin-up leaves) under `fft_mm`."""
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply3_plain

    _, step = turb3d_step(n, dev)
    lap, b, guess = rank3_state(step, *state)
    solver, weights = spec = pressure_preconditioner("fft_mm", lap)
    mats = solver.mats(b.dtype, b.device)
    sym = safe_symbol(solver, weights, b.dtype, b.device)
    out = rank3_kernels(dev, f"turbulence {n}^3", lap, b, guess,
                        lambda r: spectral_apply3_plain(mats, sym, r), spec)
    # 2o: row 15g on the same system
    PCG3_RESULTS[f"turbulence{n}"] = pcg3_kernels(dev, f"turbulence {n}^3", lap, b, guess, spec)
    return out


# every kernel wrapper of the port (each holds its launch counter): name,
# module under diffpiso_tpu_torch, attribute, launches per step of the main
# path (phase 4, 512^2 turbulence)
KERNEL_WRAPPERS = (
    ("advection_assembly", "ops.advassembly", "fused_advection_assembly", 1),
    ("laplace_assembly", "ops.laplace_assembly", "fused_laplace_assembly", 1),
    ("jacobi2_solve", "solvers.jacobi2", "fused_jacobi2_solve", 1),
    ("pcg2_solve", "solvers.pcg2", "fused_pcg2_solve", 2),
    ("div2", "ops.fv2", "div2", 1),
    ("grad2", "ops.fv2", "grad2", 1),
    ("corrector1_bridge", "ops.corrector", "corrector1_bridge", 1),
    ("corrector2_tail", "ops.corrector", "corrector2_tail", 1),
    # the bounded cavity's kernels stay off the periodic path
    ("grad2m", "ops.fv2m", "grad2m", 0),
    ("div2m", "ops.fv2m", "div2m", 0),
    ("gradT2m", "ops.fv2m", "gradT2m", 0),
    ("stencil_matvec", "ops.matvec", "fused_stencil_matvec", 0),
    # the BiCGSTAB phases run only after a jac2 solve that misses its tol
    ("bicg_phase_p", "solvers.bicg", "fused_bicg_phase_p", 0),
    ("bicg_phase_s", "solvers.bicg", "fused_bicg_phase_s", 0),
    ("bicg_phase_x", "solvers.bicg", "fused_bicg_phase_x", 0),
    # the per-iteration PCG phases: only the mixing layer's channel_mm
    # solves take them; the periodic and cavity paths take pcg2
    ("pcg_residual", "solvers.pcgphases", "fused_residual", 0),
    ("pcg_apply", "solvers.pcgphases", "fused_pcg_apply", 0),
    ("pcg_update", "solvers.pcgphases", "fused_pcg_update", 0),
    # the batch-folded jac2: only the batched training regime takes it
    ("jacobi2_solve_folded", "solvers.jacobi2", "fused_jacobi2_solve_folded", 0),
    # the large tier's kernels: only planes past jac2's and pcg2's budgets
    ("jacobi1_solve", "solvers.jacobi1", "fused_jacobi1_solve", 0),
    ("pcg_mm_update", "solvers.pcgmm", "fused_pcg_mm_update", 0),
    # the 3-D kernels: only the 3-D turbulence takes them
    ("advection_assembly3", "ops.advassembly3", "fused_advection_assembly3", 0),
    ("div3", "ops.fv3", "div3", 0),
    ("grad3", "ops.fv3", "grad3", 0),
    ("stencil_matvec3d", "ops.matvec", "fused_stencil_matvec3d", 0),
    ("jacobi1_solve_3d", "solvers.jacobi1", "fused_jacobi1_solve_3d", 0),
    # the 3-D tiers past the whole solve's budget: only 3-D turbulence at
    # 256^3 (the z block) and 512^3 (the plane sweeps) takes them (phase 14)
    ("jacobi_zblock_3d", "solvers.jacobi3d", "fused_jacobi_zblock_3d", 0),
    ("jacobi_sweep_3d", "solvers.jacobi3d", "fused_jacobi_sweep_3d", 0),
    # the batched "auto" regime's whole solves: only batches of 512^2-class
    # planes take them (phase 13)
    ("pcg2_solve_batched", "solvers.pcg2", "fused_pcg2_solve_batched", 0),
    ("jacobi1_solve_batched", "solvers.jacobi1", "fused_jacobi1_solve_batched", 0),
    # the CG iteration: only pressure solves with no preconditioner (the
    # reference's configuration, phase 15b) take it
    ("cg_iteration", "solvers.cg", "fused_cg_iteration", 0),
    # the k-sweep momentum tier: only planes past jac1's budget within 8
    # MiB (phase 16: 1024 x 2048) take it
    ("jacobi_sweeps", "solvers.jacobi_sweeps", "fused_jacobi_sweeps", 0),
    # the fused stencil residual: the entry and exit of a BiCGSTAB
    # hand-over (none on this path)
    ("stencil_residual", "ops.stencil_residual", "fused_stencil_residual", 0),
    # the masked advection assembly (row 13): rank-2 fields with a scalar
    # viscosity that row 1 declines (bounded and mixed-periodicity domains:
    # the cavity, the channel flows)
    ("advection_assembly_masked", "ops.advassembly_masked", "fused_advection_assembly_masked", 0),
    # the corrector's backward (row 17): only the periodic gradients take it,
    # once per unrolled step each
    ("corrector1_bridge_bwd", "ops.corrector", "corrector1_bridge_bwd", 0),
    ("corrector2_tail_bwd", "ops.corrector", "corrector2_tail_bwd", 0),
    # the fused spectral apply (row 16): M^-1 r of the per-iteration PCG
    # loop under channel_mm (the mixing layers, training, the DNS)
    ("spectral_apply", "solvers.spectral_apply", "fused_spectral_apply", 0),
    # the rank-3 pressure loop (row 10e, row 16-3d): every 3-D pressure solve
    # (the 3-D turbulence, phases 12 and 14; the 3-D cavity, phase 18)
    ("pcg_residual3", "solvers.pcgphases", "fused_residual3", 0),
    ("pcg_apply3", "solvers.pcgphases", "fused_pcg_apply3", 0),
    ("cg_iteration3", "solvers.cg", "fused_cg_iteration3", 0),
    ("spectral_apply3", "solvers.spectral_apply3", "fused_spectral_apply_3d", 0),
    # the whole-solve rank-3 PCG (row 15g): every 3-D adjoint pressure solve
    # under fft_mm (the gradients of phases 12, 14 and 19)
    ("pcg3_residual", "solvers.pcg3", "pcg3_residual", 0),
    ("pcg3_q", "solvers.pcg3", "pcg3_q", 0),
    ("pcg3_xr", "solvers.pcg3", "pcg3_xr", 0),
    ("pcg3_dots", "solvers.pcg3", "pcg3_dots", 0),
    ("pcg3_p", "solvers.pcg3", "pcg3_p", 0),
    # the per-shard solvers (rows 18a-18d): only solves inside
    # parallel.sharded_solvers take them (phase 20)
    ("shard_momentum", "parallel.kernels", "momentum_trip", 0),
    ("shard_pcg_matvec", "parallel.kernels", "pcg_matvec", 0),
    ("shard_pcg_update", "parallel.kernels", "pcg_update", 0),
    ("shard_pressure_whole", "parallel.kernels", "pressure_whole", 0),
)


C2_UNROLL = 30  # 19d: runs/ab_adjoint_ws.py's grad30 (no remat)
C2_REPS = 2


def channels_2d_path(dev, wrappers: dict, domain, sim, dt, v, p) -> dict:
    """Phase 19d: the JAX package's runs/ab_adjoint_ws.py protocol on the port:
    grad30 of sum v^2 with respect to a forcing field at 512^2 (phase 4's
    configuration) from the state phase 4 leaves, remat "none", without and
    with the adjoint warm-start channels, 1 untimed and C2_REPS timed
    evaluations each: warn 0, row 15g and the rank-3 kernels 0 (a 2-D
    path), unrolled steps/s, the adjoint iterations and gate decisions; the
    two gradients within rel l2 1e-3 where every adjoint's gate decision is
    the same, else both decision lists printed (a gated adjoint zeroes its
    share of the gradient, so gradients with other decisions differ by
    construction). Returns the launches of one evaluation with the
    channels."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    step = turbulence_step_fn(domain, sim, dt)
    U = C2_UNROLL
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=v.periodic)
    runs = {}
    for ch in (False, True):
        secs = []
        for rep in range(1 + C2_REPS):
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rollout_loss_grad(step, v, p, forcing, U, remat="none", adjoint_channels=ch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = {k: fn.launches for k, fn in wrappers.items()}
            if res.warns:
                fail(f"19d grad{U} channels={ch}: {res.warns} steps warned")
            if any(counts[k] for k in PCG3_KERNELS + RANK3_KERNELS):
                fail(f"19d grad{U} channels={ch}: a rank-3 pressure kernel launched on a 2-D "
                     "path")
        adj = res.adjoints
        runs[ch] = dict(
            unrolled_steps_per_sec=U * C2_REPS / sum(secs[1:]),
            adjoint_pressure_iters_per_eval=sum(a.iterations for a in adj
                                                if a.system == "pressure"),
            adjoint_momentum_iters_per_eval=sum(a.iterations for a in adj
                                                if a.system == "momentum"),
            gated=[sum(a.gated for a in adj if a.system == s) for s in ("momentum", "pressure")],
            decisions=[(a.system, bool(a.gated)) for a in adj],
            grad=[c.detach().double() for c in res.grad.components], launches=counts)
        print(json.dumps(dict(
            workload=f"19d decaying turbulence {p.shape[0]}^2, grad{U} (remat none), adjoint "
                     f"channels "
                     f"{ch}", **{k: v_ for k, v_ in runs[ch].items()
                                 if k not in ("grad", "decisions", "launches")})), flush=True)
        del res
    same = runs[True]["decisions"] == runs[False]["decisions"]
    g_rel = rel_l2_list(runs[True]["grad"], runs[False]["grad"])
    print(json.dumps(dict(check=f"19d {p.shape[0]}^2 grad{U} with vs without adjoint channels",
                          same_gate_decisions=same, grad_rel_l2=g_rel,
                          **({} if same else {"decisions_without": runs[False]["decisions"],
                                              "decisions_with": runs[True]["decisions"]}))),
          flush=True)
    if same and not g_rel <= 1e-3:
        fail(f"19d: with vs without the adjoint channels rel l2 {g_rel:.3e} > 1e-3 at equal "
             "gate decisions")
    return runs[True]["launches"]


# -- phase 20: the per-shard solvers (rows 18a-18d) on the one-card sliver mesh ----------
# The JAX package's forced-sliver (1,1) mesh (`DIFFPISO_SHARD_FORCE_SLIVERS=1`):
# the multi-device program (halo slivers, outer trips, cut blocks) on one
# card, every exchange the block's own edge planes, every sum local.

# the four wrappers of parallel/kernels.py, by their KERNEL_WRAPPERS names
SHARD_KERNELS = ("shard_momentum", "shard_pcg_matvec", "shard_pcg_update",
                 "shard_pressure_whole")
SH_WARMUP = 5
SH_STEPS = 200  # 20b
SH_UNROLL = 30  # 20c
SH_GRAD_REPS = 1  # timed grad30 evaluations after an untimed one
SH_WHOLE_STEPS = 20  # 20d
SH_SMALL = 64  # 20e
SH_SMALL_STEPS = 3
SH_SMALL_TOL = 1e-6  # 20e pressure tol: its adjoints at 1e-7 end near the float32 floor
# 20e: a decision within rounding of tol: at the trip or iteration where one
# device stopped, both devices' norms lie within this band around tol
SH_ROUNDING_BAND = 0.1
# 20a row 18d against its twin: local iterations equal, n0 exact, and the
# update x' - x within these relative limits (the GEMM sums in its own k
# order), from the warm guess and from a cold start at tol SH_WHOLE_COLD_TOL
# of max|b - mean b|. The limits are about 4x the readings on an H100 80GB
# HBM3 at 700 W (2.23e-5 warm, where one ulp of x' is a large share of the
# small update; 5.07e-6 cold, 5 local iterations)
SH_WHOLE_COLD_TOL = 1e-4
SH_WHOLE_WARM_REL = 1e-4
SH_WHOLE_COLD_REL = 2e-5


def shard_ctx(**kw):
    """sharded_solvers on the one-card (1,1) mesh with forced slivers."""
    from diffpiso_tpu_torch.parallel import make_mesh, sharded_solvers

    return sharded_solvers(make_mesh((1, 1)), ("y", "x"), force_slivers=True, **kw)


def shard_counters() -> dict:
    """The sharded solvers' own counters, from which rows 18a-18d's launches
    follow."""
    from diffpiso_tpu_torch.parallel import kernels as K
    from diffpiso_tpu_torch.parallel import shard_kernels as sk
    from diffpiso_tpu_torch.solvers import base

    p = sk.sharded_pressure_pcg
    return dict(trips=sk.sharded_momentum_solve.trips, p_iterations=p.iterations,
                p_matvecs=p.matvecs,
                whole_trips=sk._whole_tier.trips, whole_local=sk._whole_tier.local_iterations,
                fallbacks=base._sharded_adv_solve.fallbacks, transposed=K.momentum_trip.transposed)


def shard_derived(c0: dict, c1: dict) -> tuple:
    """(launches the loops derive, counter deltas): 18a one per trip and
    component, 18b one per phase iteration and per entry or verification
    matvec, 18c one per phase iteration, 18d one per whole-tier trip."""
    d = {k: c1[k] - c0[k] for k in c0}
    return ({"shard_momentum": d["trips"], "shard_pcg_matvec": d["p_iterations"] + d["p_matvecs"],
             "shard_pcg_update": d["p_iterations"], "shard_pressure_whole": d["whole_trips"]}, d)


def shard_check_counts(label: str, counts: dict, derived: dict) -> None:
    """Rows 18a-18d at their derived counts, every other kernel at 0."""
    for k, n in counts.items():
        want = derived.get(k, 0)
        if n != want:
            fail(f"{label}: {k} launched {n} times, expected {want}")


def shard_kernels_check(dev, kernels: list) -> None:
    """Phase 20a: rows 18a-18d on the card against their plain twins on the
    same inputs, on the operators of a 512^2 step from phase 4's state,
    inside the forced-sliver (1,1) context (the slivers the block's own
    edge planes): 18a (a trip from the step's guess, k = 4, forward and
    transposed, both components: x' bit-equal, n0 exact, equal sweeps), 18b
    and 18c (on the step's first pressure system, p = M^-1 r: q, x', r'
    bit-equal, max|r'| exact, the sums within rel 1e-5 of the sum of
    magnitudes), 18d (one whole-tier trip from the warm guess and one from
    x = 0: equal local iterations, n0 exact, the update x' - x within
    SH_WHOLE_WARM_REL / SH_WHOLE_COLD_REL of the twin's, relative to its
    largest magnitude: the GEMM sums in its own k order). Host ms a call,
    device us a launch, the bound and the plain twins' ms; no PyTorch call
    computes any of these functions (library_ms null). Appends the four
    entries to `kernels`."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.parallel import halo
    from diffpiso_tpu_torch.parallel import kernels as K
    from diffpiso_tpu_torch.parallel import shard_kernels as sk
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner

    domain, sim = STATES["turbulence_setup"]
    v, p, g1, g2 = STATES["turbulence"]
    it = turbulence_step_fn(domain, sim, 0.4 / N)(v, p, g1, g2, full_output=True).intermediates
    cells = N * N
    plane = 4 * cells
    with shard_ctx() as ctx:
        active, sharded = sk._active_axes(ctx)
        st, b_c, x_c = it["stencil"], it["rhs"].components, v.components
        err_a, sweeps = 0.0, {}
        for c in range(2):
            planes = tuple(a.contiguous() for a in (st.center[c], st.lo[c][0], st.hi[c][0],
                                                    st.lo[c][1], st.hi[c][1]))
            b, x = b_c[c].contiguous(), x_c[c].contiguous()
            for tr in (False, True):
                slv = sk.sliver_values(ctx, x, planes, active, tr)
                got = K.momentum_trip(planes, b, x, slv, -1.0, ADV_TOL, tr, sharded, 4)
                want = K.momentum_trip_plain(planes, b, x, slv, -1.0, ADV_TOL, tr, sharded, 4)
                err_a = max(err_a, float((got[0] - want[0]).abs().max()))
                sweeps[f"c{c}_T{int(tr)}"] = want[2]
                if not (torch.equal(got[0], want[0]) and float(got[1]) == float(want[1])
                        and int(got[2]) == want[2]):
                    fail(f"20a row 18a component {c} transpose={tr}: x', n0 or sweeps not "
                         f"equal to the twin ({float(got[1])!r} vs {float(want[1])!r}, "
                         f"{int(got[2])} vs {want[2]} sweeps)")
        planes0 = tuple(a.contiguous() for a in (st.center[0], st.lo[0][0], st.hi[0][0],
                                                 st.lo[0][1], st.hi[0][1]))
        b0, x0 = b_c[0].contiguous(), x_c[0].contiguous()
        s_f = sk.sliver_values(ctx, x0, planes0, active, False)
        s_t = sk.sliver_values(ctx, x0, planes0, active, True)
        print(f"20a {N}^2 row 18a (momentum trip, k = 4) both forms, both components: bit-equal "
              f"to the twin, sweeps {sweeps}", flush=True)

        lap, rhs = it["laplacian"], it["v1_div"].contiguous()
        planes_p = tuple(a.contiguous() for a in (lap.center, lap.lo[0], lap.hi[0], lap.lo[1],
                                                  lap.hi[1]))
        shift = lap.shift.to(torch.float32).reshape(())
        mm, w = pressure_preconditioner("fft_mm", lap)
        mats, eigs = halo.spectral_constants(mm.kinds, (N, N), torch.float32, dev)
        pc = (*halo.precond_blocks(mats, eigs, ctx.mesh, ("y", "x")),
              *(t.reshape(()) for t in w))
        r = rhs - rhs.mean()
        z = halo.local_spectral_precond(r, *pc, "y", "x", ctx.mesh)
        slv_p = sk.sliver_values(ctx, z, planes_p, active, False)
        q, pq, sp = K.pcg_matvec(planes_p, z, slv_p, sharded)
        qw, pqw, spw = K.pcg_matvec_plain(planes_p, z, slv_p, sharded)
        err_b = float((q - qw).abs().max())
        sums_b = (abs(float(pq) - float(pqw)) / float((z * qw).abs().sum()),
                  abs(float(sp) - float(spw)) / float(z.abs().sum()))
        if not (torch.equal(q, qw) and max(sums_b) <= 1e-5):
            fail(f"20a row 18b: q not bit-equal or sums off (rel {sums_b})")
        pq_t = pqw + shift * spw * spw
        alpha = torch.where(pq_t.abs() > 1e-30, torch.sum(r * z) / pq_t, 0.0)
        cs = alpha * shift * spw
        cbar = torch.sum(r) / cells
        x_p = g1.contiguous()
        got = K.pcg_update(x_p, r, z, qw, alpha, cs, cbar)
        want = K.pcg_update_plain(x_p, r, z, qw, alpha, cs, cbar)
        err_c = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        sum_c = abs(float(got[3]) - float(want[3])) / float(want[1].abs().sum())
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and float(got[2]) == float(want[2]) and sum_c <= 1e-5):
            fail(f"20a row 18c: x' / r' not bit-equal, max|r'| not exact or sum r' off "
                 f"(rel {sum_c:.3e})")
        print(f"20a {N}^2 rows 18b, 18c on the first pressure system: q, x', r' bit-equal, "
              f"sums rel {sums_b[0]:.2e} / {sums_b[1]:.2e} / {sum_c:.2e}", flush=True)

        vb = []
        for d in range(2):
            Vs, Es = sk.local_basis(mm.kinds[d], N, 1, True)
            vb.append((torch.as_tensor(Vs[0], dtype=torch.float32, device=dev),
                       torch.as_tensor(Es[0], dtype=torch.float32, device=dev)))
        (v0, e0), (v1, e1) = vb
        sym = pc[6] * e0[:, None] + pc[7] * e1[None, :]
        sym = torch.where(sym.abs() < 1e-12, torch.inf, sym).contiguous()
        v0t, v1t = v0.t().contiguous(), v1.t().contiguous()
        S0 = x_p.sum()
        tol32 = np.float32(P_TOL)
        sc = torch.stack([shift, S0, torch.tensor(tol32, device=dev),
                          torch.tensor(np.float32(0.1) * tol32, device=dev),
                          rhs.mean() - shift * S0]).to(torch.float32)
        slv_x = sk.sliver_values(ctx, x_p, planes_p, active, False)
        max_it = sim.pressure_solver.max_iterations
        gd = K.pressure_whole(planes_p, rhs, x_p, slv_x, v0, v0t, v1, v1t, sym, sc, sharded,
                              False, max_it)
        wd = K.pressure_whole_plain(planes_p, rhs, x_p, slv_x, v0, v1, sym, sc, sharded, False,
                                    max_it)
        err_d = float((gd[0] - wd[0]).abs().max())
        # the warm trip moves x by little: hold the update x' - x
        rel_d = err_d / float((wd[0] - x_p).abs().max())
        # a cold trip (x = 0, tol 1e-4 of max|b - mean b|), where x' is all update
        x_c0 = torch.zeros_like(x_p)
        tol_c = np.float32(SH_WHOLE_COLD_TOL * float((rhs - rhs.mean()).abs().max()))
        sc_c = torch.stack([shift, torch.zeros((), device=dev), torch.tensor(tol_c, device=dev),
                            torch.tensor(np.float32(0.1) * tol_c, device=dev),
                            rhs.mean()]).to(torch.float32)
        slv_c = sk.sliver_values(ctx, x_c0, planes_p, active, False)
        gc = K.pressure_whole(planes_p, rhs, x_c0, slv_c, v0, v0t, v1, v1t, sym, sc_c, sharded,
                              False, max_it)
        wc = K.pressure_whole_plain(planes_p, rhs, x_c0, slv_c, v0, v1, sym, sc_c, sharded,
                                    False, max_it)
        rel_c = float((gc[0] - wc[0]).abs().max()) / float(wc[0].abs().max())
        print(f"20a {N}^2 row 18d (whole-tier trip) from the warm guess: local iterations card "
              f"{gd[3]} / twin {wd[3]}, n0 {float(gd[1])!r} / {float(wd[1])!r}, x' max abs "
              f"diff {err_d:.3e}, rel to max|x' - x| {rel_d:.3e}; cold: local iterations card "
              f"{gc[3]} / twin {wc[3]}, n0 {float(gc[1])!r} / {float(wc[1])!r}, x' rel "
              f"{rel_c:.3e}", flush=True)
        if not (gd[3] == wd[3] and float(gd[1]) == float(wd[1]) and rel_d <= SH_WHOLE_WARM_REL
                and gc[3] == wc[3] > 1 and float(gc[1]) == float(wc[1])
                and rel_c <= SH_WHOLE_COLD_REL):
            fail("20a row 18d: the trip disagrees with its twin beyond rounding")

        # 18a: 7 planes in (5 coefficients, b, x), x' out, the slivers; per
        # cell 11 flops the measure, 15 a sweep (iv, x' update, the delta's
        # stencil, r update, |.| max)
        k_a = sweeps["c0_T0"]
        b_a = bound(8 * plane + 4 * 2 * (N + N), cells * (11 + 15 * k_a))

        def trip():
            return K.momentum_trip(planes0, b0, x0, s_f, -1.0, ADV_TOL, False, sharded, 4)

        def trip_t():
            return K.momentum_trip(planes0, b0, x0, s_t, -1.0, ADV_TOL, True, sharded, 4)

        kernels.append(dict(
            name="shard_momentum", route="cuda",
            source="diffpiso_tpu_torch/csrc/shard_momentum.cu",
            replaces="diffpiso_tpu/parallel/shard_kernels.py:388", max_abs_err=err_a,
            launches_count="calls (one per trip and component: the measure and k = 4 sweep "
                           "launches each)",
            shape=[N, N], sweeps=k_a, ms=cuda_time_ms(trip, 50), **device_time(trip, 10),
            plain_ms=cuda_time_ms(lambda: K.momentum_trip_plain(
                planes0, b0, x0, s_f, -1.0, ADV_TOL, False, sharded, 4), 10),
            bound_ms=b_a[0], bound_by=b_a[1], library_ms=None,
            transposed=dict(ms=cuda_time_ms(trip_t, 50), **device_time(trip_t, 10),
                            sweeps=sweeps["c0_T1"])))
        # 18b: 6 planes in, q out; 12 flops a cell (stencil 9, p q, 2 sums)
        b_b = bound(7 * plane + 4 * 2 * (N + N), 12 * cells)
        kernels.append(dict(
            name="shard_pcg_matvec", route="cuda", source="diffpiso_tpu_torch/csrc/shard_pcg.cu",
            replaces="diffpiso_tpu/parallel/shard_kernels.py:577", max_abs_err=err_b,
            launches_count="calls (one per phase iteration and per entry or verification "
                           "matvec)",
            shape=[N, N], ms=cuda_time_ms(lambda: K.pcg_matvec(planes_p, z, slv_p, sharded), 200),
            **device_time(lambda: K.pcg_matvec(planes_p, z, slv_p, sharded)),
            plain_ms=cuda_time_ms(lambda: K.pcg_matvec_plain(planes_p, z, slv_p, sharded), 50),
            bound_ms=b_b[0], bound_by=b_b[1], library_ms=None))
        # 18c: x, r, p, q in; x', r' out; 9 flops a cell
        b_c_ = bound(6 * plane, 9 * cells)

        def upd():
            return K.pcg_update(x_p, r, z, qw, alpha, cs, cbar)

        kernels.append(dict(
            name="shard_pcg_update", route="cuda", source="diffpiso_tpu_torch/csrc/shard_pcg.cu",
            replaces="diffpiso_tpu/parallel/shard_kernels.py:599", max_abs_err=err_c,
            launches_count="calls (one per phase iteration)", shape=[N, N],
            ms=cuda_time_ms(upd, 200), **device_time(upd),
            plain_ms=cuda_time_ms(lambda: K.pcg_update_plain(x_p, r, z, qw, alpha, cs, cbar), 50),
            bound_ms=b_c_[0], bound_by=b_c_[1], library_ms=None))
        # 18d: 7 planes in, x' out, the bases and the symbol; per local
        # iteration the four contractions 2 x 2 (m0^2 m1 + m0 m1^2) flops and
        # ~30 flops a cell of stencil, dots and updates
        k_d = gd[3]
        b_d = bound(8 * plane + 4 * (2 * N * N + cells),
                    k_d * (4 * N * N * N * 2 + 30 * cells) + 12 * cells)

        def whole():
            return K.pressure_whole(planes_p, rhs, x_p, slv_x, v0, v0t, v1, v1t, sym, sc, sharded,
                                    False, max_it)

        kernels.append(dict(
            name="shard_pressure_whole", route="cuda",
            source="diffpiso_tpu_torch/csrc/shard_whole.cu",
            replaces="diffpiso_tpu/parallel/shard_kernels.py:807", max_abs_err=err_d,
            max_rel_err=rel_d, cold_rel_err=rel_c, cold_local_iterations=gc[3],
            launches_count="calls (one per whole-tier trip)", shape=[N, N],
            local_iterations=k_d, ms=cuda_time_ms(whole, 5, warmup=1),
            **device_time(whole, 3),
            plain_ms=cuda_time_ms(lambda: K.pressure_whole_plain(
                planes_p, rhs, x_p, slv_x, v0, v1, sym, sc, sharded, False, max_it), 2,
                warmup=1),
            bound_ms=b_d[0], bound_by=b_d[1], library_ms=None))


def shard_run(step, state, n, ctx=None):
    """n steps from `state` = (v, p, g1, g2), inside `ctx` (a context
    manager; None: the single-device path). Returns (state, pressure
    iterations summed per corrector, warns)."""
    v, p, g1, g2 = state
    its, warns = [0, 0], 0
    with ctx if ctx is not None else contextlib.nullcontext():
        for _ in range(n):
            o = step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            its[0] += o.p_iterations[0]
            its[1] += o.p_iterations[1]
            warns += int(o.warn)
    return (v, p, g1, g2), its, warns


def shard_forward_path(dev, wrappers: dict) -> dict:
    """Phase 20b: the 512^2 turbulence (phase 4's configuration) from phase
    4's final state on the forced-sliver (1,1) mesh: SH_WARMUP steps, then
    SH_STEPS timed with every counter reset before them (rows 18a-18c at
    the counts the sharded solvers' counters derive, 18d and rows 1-17 at
    0, warn 0); steps/s, pressure iterations and momentum trips a step,
    BiCGSTAB fallbacks; then the same SH_STEPS on the single-device path
    from the same state, the velocities within rel 1e-3. Returns the
    launches."""
    import torch

    domain, sim = STATES["turbulence_setup"]
    step = turbulence_step_fn(domain, sim, 0.4 / N)
    state, _, _ = shard_run(step, STATES["turbulence"], SH_WARMUP, shard_ctx())
    for fn in wrappers.values():
        fn.launches = 0
    c0 = shard_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end, its, warns = shard_run(step, state, SH_STEPS, shard_ctx())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    derived, d = shard_derived(c0, shard_counters())
    ref, _, ref_warns = shard_run(step, state, SH_STEPS)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(end[0].components, ref[0].components))
    print(json.dumps(dict(
        workload=f"20b decaying turbulence {N}^2, sharded solvers on the (1,1) mesh with forced "
                 "slivers, forward",
        steps=SH_STEPS, steps_per_sec=SH_STEPS / elapsed,
        pressure_iters_per_step=[its[0] / SH_STEPS, its[1] / SH_STEPS],
        momentum_trips_per_step=d["trips"] / SH_STEPS, bicgstab_fallbacks=d["fallbacks"],
        warn_fraction=warns / SH_STEPS, velocity_rel_vs_single_device=rel,
        single_device_warns=ref_warns, launches=counts)), flush=True)
    if warns:
        fail(f"20b: {warns} steps warned")
    shard_check_counts("20b", counts, derived)
    if not all(counts[k] > 0 for k in SHARD_KERNELS[:3]):
        fail("20b: a row of 18a-18c never launched on the sliver path")
    if not rel <= 1e-3:
        fail(f"20b: velocity after {SH_STEPS} steps rel {rel:.3e} from the single-device path "
             "(> 1e-3)")
    STATES["sharded"] = end
    return counts


def shard_grad_path(dev, wrappers: dict) -> dict:
    """Phase 20c: grad30 (remat "outputs", d sum v^2 / d forcing) from 20b's
    final state under adjoint="auto" (every transposed momentum solve and
    pressure adjoint on the shards): 1 untimed and SH_GRAD_REPS timed
    evaluations with the counters checked per evaluation (rows 18a-18c as
    derived, 18a's transposed calls > 0, every other row 0), warn 0;
    unrolled steps/s, the gated adjoints, and the gradient against the
    single-device grad30 from the same state (rel l2 <= 5e-3, the JAX
    package's own bound for sharded against unsharded). Returns the
    launches of one evaluation."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    domain, sim = STATES["turbulence_setup"]
    step = turbulence_step_fn(domain, sim, 0.4 / N)
    v, p, _, _ = STATES["sharded"]
    forcing = StaggeredField(tuple(torch.zeros(N, N, device=dev) for _ in range(2)),
                             periodic=(True, True))
    U = SH_UNROLL
    secs = []
    for rep in range(1 + SH_GRAD_REPS):
        for fn in wrappers.values():
            fn.launches = 0
        c0 = shard_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shard_ctx(adjoint="auto"):
            res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        derived, d = shard_derived(c0, shard_counters())
        if res.warns:
            fail(f"20c grad{U}: {res.warns} steps warned")
        shard_check_counts(f"20c grad{U}", counts, derived)
        if not d["transposed"] > 0:
            fail(f"20c grad{U}: no transposed momentum trip ran on the shards")
    ref = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
    g_rel = rel_l2_list(res.grad.components, ref.grad.components)
    dec = [(a.system, bool(a.gated)) for a in res.adjoints]
    dec_ref = [(a.system, bool(a.gated)) for a in ref.adjoints]
    print(json.dumps(dict(
        workload=f"20c decaying turbulence {N}^2, grad{U} (remat outputs), sharded solvers on the "
                 "(1,1) mesh with forced slivers, adjoint auto",
        evaluations=SH_GRAD_REPS, unrolled_steps_per_sec=U * SH_GRAD_REPS / sum(secs[1:]),
        pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
        momentum_trips_per_eval=d["trips"], transposed_momentum_calls=d["transposed"],
        bicgstab_fallbacks=d["fallbacks"],
        adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                       for s in ("momentum", "pressure")],
        single_device_adjoint_gated=[sum(a.gated for a in ref.adjoints if a.system == s)
                                     for s in ("momentum", "pressure")],
        same_gate_decisions=dec == dec_ref, grad_rel_l2_vs_single_device=g_rel,
        launches=counts)), flush=True)
    if not g_rel <= 5e-3:
        fail(f"20c: grad{U} rel l2 {g_rel:.3e} from the single-device grad{U} (> 5e-3); "
             f"decisions {dec} vs {dec_ref}")
    return counts


def shard_whole_path(dev, wrappers: dict) -> dict:
    """Phase 20d: the whole-solve tier forced (whole_tier="always"),
    SH_WHOLE_STEPS steps from 20b's final state: 18d once per tier trip,
    18a-18c as derived (the fall-through to the phase PCG), rows 1-17 at 0,
    warn 0; 18d's calls, local iterations, and the pressure iterations a
    step (local iterations plus the phase PCG's). Returns the launches."""
    import torch

    domain, sim = STATES["turbulence_setup"]
    step = turbulence_step_fn(domain, sim, 0.4 / N)
    for fn in wrappers.values():
        fn.launches = 0
    c0 = shard_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, its, warns = shard_run(step, STATES["sharded"], SH_WHOLE_STEPS,
                              shard_ctx(whole_tier="always"))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    derived, d = shard_derived(c0, shard_counters())
    print(json.dumps(dict(
        workload=f"20d decaying turbulence {N}^2, whole-solve tier forced (always), (1,1) mesh "
                 "with forced slivers",
        steps=SH_WHOLE_STEPS, steps_per_sec=SH_WHOLE_STEPS / elapsed,
        pressure_iters_per_step=[its[0] / SH_WHOLE_STEPS, its[1] / SH_WHOLE_STEPS],
        whole_tier_trips=d["whole_trips"], local_iterations=d["whole_local"],
        local_iterations_per_trip=d["whole_local"] / max(1, d["whole_trips"]),
        phase_iterations=d["p_iterations"], warn_fraction=warns / SH_WHOLE_STEPS,
        launches=counts)), flush=True)
    if warns:
        fail(f"20d: {warns} steps warned")
    shard_check_counts("20d", counts, derived)
    if not counts["shard_pressure_whole"] > 0:
        fail("20d: row 18d never launched")
    return counts


def shard_small_check(dev) -> None:
    """Phase 20e: 64^2 turbulence, SH_SMALL_STEPS steps and the 3-step
    rollout gradient (adjoint="auto") in the forced-sliver context on the
    card and on the CPU (the twins): each solve's decisions (momentum:
    its per-trip entry norms; pressure: its per-iteration norms; the
    fallbacks) equal, or a named exception within rounding of tol (at the
    trip or iteration where one device stopped, both norms within
    SH_ROUNDING_BAND of tol); velocity rel 1e-4, gradient rel l2 1e-3, the
    adjoint gate decisions equal."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.parallel import shard_kernels as sk

    out = []
    for d in (dev, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((SH_SMALL, SH_SMALL), viscosity=VISCOSITY,
                                                device=d)
        v = random_solenoidal(domain, torch.Generator().manual_seed(3), device=d)
        p = domain.centered_grid(0.0, device=d)
        zero = torch.zeros_like(p)
        step = turbulence_step_fn(domain, sim, 0.4 / SH_SMALL, p_tol=SH_SMALL_TOL)
        log = []
        sk.RECORD = log
        try:
            fb0 = shard_counters()["fallbacks"]
            (vo, _, _, _), _, warns = shard_run(step, (v, p, zero, zero), SH_SMALL_STEPS,
                                                shard_ctx())
            f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                               periodic=(True, True))
            with shard_ctx(adjoint="auto"):
                res = rollout_loss_grad(step, v, p, f, 3, remat="outputs")
            fb = shard_counters()["fallbacks"] - fb0
        finally:
            sk.RECORD = None
        if warns or res.warns:
            fail(f"20e on {d.type}: warned ({warns} forward, {res.warns} gradient steps)")
        out.append(dict(v=[c.cpu() for c in vo.components], log=log, fallbacks=fb,
                        grad=[c.cpu() for c in res.grad.components],
                        gated=[(a.system, bool(a.gated)) for a in res.adjoints]))
    card, cpu = out
    exceptions = []
    if len(card["log"]) != len(cpu["log"]):
        fail(f"20e: {len(card['log'])} solves on the card, {len(cpu['log'])} on the CPU")
    for i, ((kind, a, tol), (_, b, _)) in enumerate(zip(card["log"], cpu["log"])):
        if len(a) == len(b):
            continue
        j = min(len(a), len(b)) - 1
        near = all(abs(s[j] / tol - 1.0) <= SH_ROUNDING_BAND for s in (a, b))
        exceptions.append(dict(solve=i, system=kind, card=len(a), cpu=len(b), tol=tol,
                               card_norm=a[j], cpu_norm=b[j], within_rounding=near))
        if not near:
            fail(f"20e: solve {i} ({kind}) decided differently: card {len(a)} vs CPU {len(b)} "
                 f"trips / iterations, norms {a[j]!r} / {b[j]!r} at tol {tol!r}")
    v_rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(card["v"], cpu["v"]))
    g_rel = rel_l2_list(card["grad"], cpu["grad"])
    print(json.dumps(dict(
        check=f"20e {SH_SMALL}^2 sharded solvers (1,1) forced slivers, {SH_SMALL_STEPS} steps + "
              "3-step gradient (adjoint auto), card vs CPU",
        solves=len(cpu["log"]), decisions_equal=not exceptions, exceptions=exceptions,
        fallbacks=[card["fallbacks"], cpu["fallbacks"]], velocity_rel=v_rel, grad_rel_l2=g_rel,
        same_gate_decisions=card["gated"] == cpu["gated"])), flush=True)
    if card["fallbacks"] != cpu["fallbacks"] or card["gated"] != cpu["gated"]:
        fail("20e: fallbacks or adjoint gate decisions differ between the card and the CPU")
    if not (v_rel <= 1e-4 and g_rel <= 1e-3):
        fail(f"20e: card vs CPU velocity rel {v_rel:.3e} (> 1e-4) or gradient rel l2 "
             f"{g_rel:.3e} (> 1e-3)")


def kernel_wrappers() -> dict:
    """{name: (wrapper, launches per main-path step)} of KERNEL_WRAPPERS."""
    import importlib

    return {name: (getattr(importlib.import_module(f"diffpiso_tpu_torch.{mod}"), attr), per_step)
            for name, mod, attr, per_step in KERNEL_WRAPPERS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    from diffpiso_tpu_torch import native
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.advassembly import (
        advection_assembly_plain, assembly_scalars, fused_advection_assembly)
    from diffpiso_tpu_torch.ops import corrector, fv2
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.ops.laplace import (
        assemble_pressure_laplacian, laplace_mask_planes)
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers import krylov
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, gemm, pcg2_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 1: the card and the build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    build_s = native.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)

    # -- phase 2: kernels vs plain at 512^2 on a real step's operators ------------
    domain, sim = decaying_turbulence_setup((N, N), viscosity=VISCOSITY, device=dev)
    dt = 0.4 / N
    dx = domain.dx
    beta = dx[0] * dx[1] / dt
    gen = torch.Generator(device=dev).manual_seed(0)
    vel = random_solenoidal(domain, gen, device=dev)
    plane_bytes = N * N * 4
    kernels = []

    scal = assembly_scalars(dx, VISCOSITY, beta)
    w0, w1 = vel.components
    k_planes = fused_advection_assembly(w0, w1, *scal)
    p_planes = advection_assembly_plain(w0, w1, *scal)
    adv_err = max(float((a - b).abs().max()) for a, b in zip(k_planes, p_planes))
    adv_rel = max(rel_err(a, b) for a, b in zip(k_planes, p_planes))
    if not adv_rel <= 1e-6:
        fail(f"advection assembly: max rel err {adv_rel:.3e} > 1e-6")
    b_adv, by_adv = bound(14 * plane_bytes, 62 * N * N)
    kernels.append(dict(
        name="advection_assembly", route="cuda",
        source="diffpiso_tpu_torch/csrc/advassembly.cu",
        replaces="diffpiso_tpu/ops/pallas_advassembly.py:189",
        max_abs_err=adv_err,
        ms=cuda_time_ms(lambda: fused_advection_assembly(w0, w1, *scal), 200),
        **device_time(lambda: fused_advection_assembly(w0, w1, *scal)),
        plain_ms=cuda_time_ms(lambda: advection_assembly_plain(w0, w1, *scal), 50),
        bound_ms=b_adv, bound_by=by_adv, library_ms=None,
    ))

    stencil = assemble_advection_stencil(
        vel, dx, domain.velocity_pad_modes(), VISCOSITY, beta, sim.dirichlet_mask,
        sim.active_mask, sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
        uniform=sim.uniform_masks)
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / (beta - a) for a in stencil.diag_A]
    masks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, (True, True),
                                (N, N), torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], masks, (True, True))
    p_lap = laplace_assembly_plain(influence[0], influence[1], masks, (True, True))
    lap_err = max(float((a - b).abs().max()) for a, b in zip(k_lap[:5], p_lap[:5]))
    lap_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    sum_rel = rel_err(k_lap[5], p_lap[5])
    if not (lap_rel <= 1e-6 and sum_rel <= 1e-5):
        fail(f"laplace assembly: planes rel err {lap_rel:.3e} (limit 1e-6), "
             f"sum|diag| rel err {sum_rel:.3e} (limit 1e-5)")
    b_lap, by_lap = bound(15 * plane_bytes + 4, 12 * N * N)
    kernels.append(dict(
        name="laplace_assembly", route="cuda",
        source="diffpiso_tpu_torch/csrc/laplace_assembly.cu",
        replaces="diffpiso_tpu/ops/pallas_assembly.py:136",
        max_abs_err=lap_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], masks,
                                                       (True, True)), 200),
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], masks,
                                                     (True, True))),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], masks,
                                                             (True, True)), 50),
        bound_ms=b_lap, bound_by=by_lap, library_ms=None,
    ))

    st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i]) for i in range(2)]
    b_c = tuple(c * beta for c in vel.components)
    x_c = tuple(vel.components)
    jac_sweeps = jac2_edges(f"{N}^2", st_cs, b_c, x_c, ADV_TOL)
    kx0, kx1, _, _ = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
    px0, px1, _, _ = jacobi2_plain(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
    jac_err = max(float((kx0 - px0).abs().max()), float((kx1 - px1).abs().max()))
    sw = jac_sweeps[False]
    # 14 planes in, 2 out; per cell and component: 2 residual matvecs (init,
    # exit) of 11 flops and 13 per sweep, plus the inverse diagonal
    b_jac, by_jac = bound(16 * plane_bytes, 2 * N * N * (2 + 22 + 13 * sw))
    kernels.append(dict(
        name="jacobi2_solve", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi2.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:803",
        max_abs_err=jac_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33), 50),
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33), 10),
        bound_ms=b_jac, bound_by=by_jac, library_ms=None,
        launches_count="whole solves (each: jacobi2.solve_launches kernel launches, one a "
                       "sweep, the first fused with the entry residual, in runs of "
                       "jacobi2.RUN_LENGTH between host reads)",
    ))

    kx0, kx1, _, _ = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
    v_star = StaggeredField((kx0, kx1), periodic=(True, True))
    lap = assemble_pressure_laplacian(
        StaggeredField(tuple(influence), periodic=(True, True)), sim.active_mask,
        sim.accessible_mask, (True, True), True)
    rhs = fv_divergence(v_star, dx)
    mss, weights = pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    kx, kr, kk = fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, P_TOL, 1000)
    px, pr, pk = pcg2_plain(lap, rhs, None, v0, v1, sym, P_TOL, 1000)
    pcg_rel = rel_err(kx, px)
    print(f"pcg2 (cold): iterations kernel {kk} plain {pk}, residual kernel {kr:.3e} "
          f"plain {pr:.3e}, x rel err {pcg_rel:.3e}", flush=True)
    if kk != pk:
        fail(f"pcg2: iteration counts differ ({kk} vs {pk})")
    if not pcg_rel <= 1e-4:
        fail(f"pcg2: x rel err {pcg_rel:.3e} > 1e-4")
    g = gemm(v0, rhs)
    g_rel = rel_err(g, v0 @ rhs)
    if not g_rel <= 1e-5:
        fail(f"pcg2 GEMM vs torch.matmul: rel err {g_rel:.3e} > 1e-5")
    # bound of this run's solve: kk applies of 4 n^3 GEMMs; 10 planes in
    # (5 stencil, b, x0, symbol, two bases) and x out
    b_pcg, by_pcg = bound(11 * plane_bytes, kk * (8.0 * N ** 3 + 30 * N * N) + 24 * N * N)
    kernels.append(dict(
        name="pcg2_solve", route="cuda", source="diffpiso_tpu_torch/csrc/pcg2.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:2283",
        max_abs_err=float((kx - px).abs().max()),
        ms=cuda_time_ms(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym,
                                                 P_TOL, 1000), 20),
        plain_ms=cuda_time_ms(lambda: pcg2_plain(lap, rhs, None, v0, v1, sym, P_TOL, 1000), 5),
        bound_ms=b_pcg, bound_by=by_pcg,
        # yardstick: one 512^3 fp32 contraction through cuBLAS; the port never calls it
        library_ms=cuda_time_ms(lambda: torch.matmul(v0, rhs), 200),
        gemm_ms=cuda_time_ms(lambda: gemm(v0, rhs), 200),
        **device_time(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, P_TOL,
                                               1000), 5),
        iterations=kk,
    ))

    # the FV pair on the step's planes: div2 of v*, grad2 of the pressure
    # increment; the VJPs are the other kernel with negated factors
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    nfs = (-fs[0], -fs[1])
    vs0, vs1 = v_star.components

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    div_err = max(
        float((fv2.div2(fs, (vs0, vs1)) - fv2.div2_plain(fs, (vs0, vs1))).abs().max()),
        *[float((a - b).abs().max()) for a, b in zip(
            vjp(lambda a, b: fv2.div2(fs, (a, b)), (vs0, vs1), kx), fv2.grad2_plain(nfs, kx))])
    grad_err = max(
        *[float((a - b).abs().max()) for a, b in zip(fv2.grad2(fs, kx), fv2.grad2_plain(fs, kx))],
        float((vjp(lambda a: fv2.grad2(fs, a), (kx,), (vs0, vs1))[0]
               - fv2.div2_plain(nfs, (vs0, vs1))).abs().max()))
    fv_scale = max(float(vs0.abs().max()), float(kx.abs().max())) * max(fs)
    print(f"fv2 div2 / grad2 vs plain (forward and VJP): max abs err {div_err:.3e} / "
          f"{grad_err:.3e}", flush=True)
    if not max(div_err, grad_err) <= 1e-6 * fv_scale:
        fail(f"fv2: kernel vs plain max abs err {max(div_err, grad_err):.3e} > 1e-6 x scale")
    # div: 2 planes in, 1 out, 5 flops per cell; grad: 1 in, 2 out, 4 flops
    for name, fn, plain, fl, err in (
        ("div2", lambda: fv2.div2(fs, (vs0, vs1)), lambda: fv2.div2_plain(fs, (vs0, vs1)), 5,
         div_err),
        ("grad2", lambda: fv2.grad2(fs, kx), lambda: fv2.grad2_plain(fs, kx), 4, grad_err),
    ):
        b_fv, by_fv = bound(3 * plane_bytes, fl * N * N)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2.cu",
            replaces=("diffpiso_tpu/ops/pallas_fv.py:225" if name == "div2"
                      else "diffpiso_tpu/ops/pallas_fv.py:260"),
            max_abs_err=err, ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(plain, 50),
            **device_time(fn),
            bound_ms=b_fv, bound_by=by_fv, library_ms=None,
        ))

    # the corrector bridge on the step's planes (p_inc1 = the pcg2 solution
    # above, v* the jac2 solution, the stencil of the step), then the tail
    # on the second corrector's solve of the bridge's divergence
    bma = [beta - a for a in stencil.diag_A]
    dxprod = dx[0] * dx[1]
    bridge_in = [kx, vs0, vs1, *bma]
    for d in range(2):
        bridge_in += [stencil.center[d], stencil.lo[d][0], stencil.hi[d][0],
                      stencil.lo[d][1], stencil.hi[d][1]]
    bridge_in += list(stencil.diag_A)

    def bridge_kernel(p, v0, v1):
        v2, h, hdiv = corrector.corrector1_bridge(p, (v0, v1), bma, stencil, stencil.diag_A,
                                                  beta, dx)
        return (*v2, *h, hdiv)

    def bridge_ref(p, v0, v1):
        return corrector.bridge_plain(fs[0], fs[1], dxprod, beta, p, v0, v1, *bridge_in[3:])

    b_out = bridge_kernel(kx, vs0, vs1)
    b_ref = bridge_ref(kx, vs0, vs1)
    b_err = max(float((a - b).abs().max()) for a, b in zip(b_out, b_ref))
    b_rel = max(rel_err(a, b) for a, b in zip(b_out, b_ref))
    # (the backward is row 17's kernel: phase 2l)
    print(f"corrector bridge kernel vs plain: forward max rel err {b_rel:.3e} (abs "
          f"{b_err:.3e})", flush=True)
    if not b_rel <= 1e-6:
        fail(f"corrector bridge: kernel vs plain rel err {b_rel:.3e} > 1e-6")
    _, _, h0, h1, hdiv = b_out
    kx2, _, _ = fused_pcg2_solve(lap, hdiv, None, v0, v0t, v1, v1t, sym, P_TOL, 1000)
    tail_in = [kx2, b_out[0], b_out[1], h0, h1, *bma]

    def tail_kernel(p, a, b):
        return corrector.corrector2_tail(p, (a, b), (h0, h1), bma, dx)

    def tail_ref(p, a, b):
        return corrector.tail_plain(fs[0], fs[1], dxprod, p, a, b, h0, h1, *bma)

    t_out, t_ref = tail_kernel(*tail_in[:3]), tail_ref(*tail_in[:3])
    t_err = max(float((a - b).abs().max()) for a, b in zip(t_out, t_ref))
    t_rel = max(rel_err(a, b) for a, b in zip(t_out, t_ref))
    print(f"corrector tail kernel vs plain: forward max rel err {t_rel:.3e} (abs "
          f"{t_err:.3e})", flush=True)
    if not t_rel <= 1e-6:
        fail(f"corrector tail: kernel vs plain rel err {t_rel:.3e} > 1e-6")
    # bridge: 17 planes in, 5 out; per cell 2 x (grad 2, delta 3, v 1,
    # H 12, H/bma 1) + div 5 = 43 flops. tail: 7 in, 2 out, 2 x 6 flops.
    b_br, by_br = bound(22 * plane_bytes, 43 * N * N)
    kernels.append(dict(
        name="corrector1_bridge", route="cuda", source="diffpiso_tpu_torch/csrc/corrector.cu",
        replaces="diffpiso_tpu/ops/pallas_corrector.py:526", max_abs_err=b_err,
        ms=cuda_time_ms(lambda: bridge_kernel(kx, vs0, vs1), 200),
        **device_time(lambda: bridge_kernel(kx, vs0, vs1)),
        plain_ms=cuda_time_ms(lambda: bridge_ref(kx, vs0, vs1), 50),
        bound_ms=b_br, bound_by=by_br, library_ms=None,
    ))
    b_tl, by_tl = bound(9 * plane_bytes, 12 * N * N)
    kernels.append(dict(
        name="corrector2_tail", route="cuda", source="diffpiso_tpu_torch/csrc/corrector.cu",
        replaces="diffpiso_tpu/ops/pallas_corrector.py:633", max_abs_err=t_err,
        ms=cuda_time_ms(lambda: tail_kernel(*tail_in[:3]), 200),
        **device_time(lambda: tail_kernel(*tail_in[:3])),
        plain_ms=cuda_time_ms(lambda: tail_ref(*tail_in[:3]), 50),
        bound_ms=b_tl, bound_by=by_tl, library_ms=None,
    ))

    # -- phase 2l: the corrector's backward kernels (row 17) on the step's planes,
    # then at 1024^2 and 1024 x 2048 ---------------------------------------------------
    corrector_bwd_kernels(dev, kernels, (fs[0], fs[1], dxprod, beta), bridge_in, tail_in)

    # -- phase 2m: the fused spectral apply (row 16) on the channel_mm planes and the
    # cavity's dct_mm plane --------------------------------------------------------------
    spectral_kernels(dev, kernels)

    # -- phase 2p: the GEMM's tile plan, bit-equal to the fmaf chain in every configuration
    gemm_plan_check(dev)

    # -- phase 2b: the cavity path's kernels at the 512 cavity's shapes ------------
    cavity_measured = cavity_kernels(dev, kernels)

    # -- phase 2c: the mixing layer's kernels at 128 x 512 --------------------------
    mixing_measured = mixing_kernels(dev, kernels, mixing_setup(MIX_RES, dev), "mixing")

    # -- phase 2d: the batch-folded jac2 at the batch-8 training shapes ---------------
    training_kernels(dev, kernels)

    # -- phase 2e: the batch-1 training path's kernels at its 64 x 256 shapes -----------
    training_measured = mixing_kernels(dev, None, training_setup(TRAIN_RES, dev), "training")

    # -- phase 2f: the large tier's kernels at 1024^2 and the 512 x 2048 DNS faces -------
    large_measured = large_kernels(dev, kernels)

    # -- phase 2g: the 3-D kernels at 128^3, on the state after bench.py's spin-up --------
    turb3d_state_dev = turb3d_kernels(dev, kernels)
    # -- phase 2n: rows 10e and 16-3d on the 128^3 pressure system of that state -----------
    rank3 = {"turbulence128": turb3d_rank3(dev, T3_N, turb3d_state_dev)}

    # -- phase 3: small input, card vs the plain path on the CPU --------------------
    n_small = 64
    outs = {}
    for d in (dev, torch.device("cpu")):
        dom_s, sim_s = decaying_turbulence_setup((n_small, n_small), viscosity=1e-3, device=d)
        g_s = torch.Generator().manual_seed(1)
        v = random_solenoidal(dom_s, g_s, device=d)
        p = dom_s.centered_grid(0.0, device=d)
        g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
        for _ in range(3):
            o = piso_step(v, p, 0.4 / n_small, dom_s, sim_s, pressure_inc1_guess=g1,
                          pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=1e-7)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        outs[d.type] = [c.cpu() for c in v.components]
    small_err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
                    for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"64^2 x 3 steps, card vs CPU plain path: max(|d| - 2e-4|ref|) = {small_err:.3e}",
          flush=True)
    if not small_err <= 2e-5:
        fail("64^2 card step disagrees with the CPU plain path beyond rtol 2e-4, atol 2e-5")

    # -- phase 4: the main path --------------------------------------------------
    pressure = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(pressure), torch.zeros_like(pressure)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)

    def step(v, p, g1, g2):
        return piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    for _ in range(WARMUP_STEPS):
        o = step(v, pressure, g1, g2)
        v, pressure, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    wrappers = kernel_wrappers()
    for fn, _ in wrappers.values():
        fn.launches = 0
    fallbacks0 = krylov.bicgstab.fallbacks
    j0 = jac1_snapshot()
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        o = step(v, pressure, g1, g2)
        v, pressure, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters[0] += o.p_iterations[0]
        iters[1] += o.p_iterations[1]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, (fn, _) in wrappers.items()}
    fallbacks = krylov.bicgstab.fallbacks - fallbacks0
    row3 = jac1_schedule_check("main path", j0, jac1_snapshot())

    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(pressure).all())
    div = float(fv_divergence(v, dx).abs().max())
    print(json.dumps(dict(
        workload=f"decaying turbulence {N}^2 (periodic, random solenoidal IC), forward",
        steps=TIMED_STEPS, steps_per_sec=TIMED_STEPS / elapsed,
        pressure_iters_per_step=[iters[0] / TIMED_STEPS, iters[1] / TIMED_STEPS],
        warn_fraction=warns / TIMED_STEPS, bicgstab_fallbacks=fallbacks,
        max_abs_div=div, launches=launches, row3_kernel_launches=row3,
    )), flush=True)
    if not finite:
        fail("non-finite state after the main path")
    if warns:
        fail(f"warn fraction {warns / TIMED_STEPS} (must be 0)")
    STATES["turbulence"] = (v, pressure, g1, g2)
    STATES["turbulence_setup"] = (domain, sim)
    for k, (_, per_step) in wrappers.items():
        if launches[k] != per_step * TIMED_STEPS:
            fail(f"{k}: {launches[k]} wrapper launches, expected {per_step * TIMED_STEPS}")

    # -- phase 5: the gradient path ---------------------------------------------
    # (a) small input at the main path's viscosity and tolerances: a 3-step
    # rollout gradient on the card vs the plain path on the CPU, from one
    # initial state. At 128^2 the float32 residual of most cold pressure
    # adjoints ends above 100 x adj_tol, so the gate zeroes them: each
    # adjoint's decision must come out the same on both devices, or the
    # gradients would differ completely.
    n_grad = 128
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, torch.device("cpu")):
        dom_s, sim_s = decaying_turbulence_setup((n_grad, n_grad), viscosity=VISCOSITY, device=d)
        v_s = random_solenoidal(dom_s, torch.Generator().manual_seed(1), device=d)
        f_s = StaggeredField(tuple(torch.zeros(n_grad, n_grad, device=d) for _ in range(2)),
                             periodic=(True, True))

        def step_s(v, p, g1, g2, f, dom_s=dom_s, sim_s=sim_s):
            return piso_step(v, p, 0.4 / n_grad, dom_s, sim_s, forcing_term=f,
                             pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=ADV_TOL, pressure_tol=P_TOL)

        bwd0 = row17_launches()
        r_s = rollout_loss_grad(step_s, v_s, dom_s.centered_grid(0.0, device=d), f_s, 3)
        row17_check(f"{n_grad}^2 rollout gradient", d, bwd0, 3)
        if r_s.warns:
            fail(f"{n_grad}^2 rollout gradient on {d.type}: {r_s.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r_s.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r_s.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 3) for a in r_s.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    n_gated = sum(g for _, g in decisions["cpu"])
    print(f"{n_grad}^2 x 3-step rollout gradient (viscosity {VISCOSITY}, pressure tol {P_TOL}), "
          f"card vs CPU plain path: rel l2 {g_rel:.3e}; gated adjoints card "
          f"{sum(g for _, g in decisions['cuda'])} / CPU {n_gated} of {len(decisions['cpu'])}; "
          f"pressure adjoint residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}",
          flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{n_grad}^2 rollout gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not n_gated:
        fail(f"{n_grad}^2 rollout gradient: no adjoint gated, so this check does not cover the gate")
    if not g_rel <= 1e-3:
        fail(f"{n_grad}^2 rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")

    # (b) grad30 at 512^2 from the state phase 4 leaves. Launches per
    # evaluation, U = 30 unrolled steps, "outputs" remat: each step runs
    # once forward and once more as the backward's replay, in which the
    # solves hand back their recorded outputs. So the assemblies, the
    # bridge and the tail run 2U; the momentum solve runs U forward + U
    # transposed adjoints, the pressure solve 2U forward + 2U adjoints.
    # div2: U (div v*) + U (replay) + U - 1 (VJP of the predictor's
    # grad2 of p: the initial pressure carries no gradient, so the first
    # step has none); grad2: U (predictor) + U (replay) + U (VJP of div v*).
    # The corrector's backward kernels (row 17): U each, one per step.
    U = UNROLL
    expected = {
        "advection_assembly": 2 * U, "laplace_assembly": 2 * U,
        "jacobi2_solve": 2 * U, "pcg2_solve": 4 * U,
        "div2": 3 * U - 1, "grad2": 3 * U,
        "corrector1_bridge": 2 * U, "corrector2_tail": 2 * U,
        "grad2m": 0, "div2m": 0, "gradT2m": 0, "stencil_matvec": 0,
        "pcg_residual": 0, "pcg_apply": 0, "pcg_update": 0, "jacobi2_solve_folded": 0,
        "jacobi1_solve": 0, "pcg_mm_update": 0, **{k: 0 for k in T3_KERNELS},
        **{k: 0 for k in T3_TIER_KERNELS.values()},
        "pcg2_solve_batched": 0, "jacobi1_solve_batched": 0, "jacobi_sweeps": 0,
        "advection_assembly_masked": 0, "corrector1_bridge_bwd": U, "corrector2_tail_bwd": U,
        "spectral_apply": 0,
    }
    forcing = StaggeredField(tuple(torch.zeros(N, N, device=dev) for _ in range(2)),
                             periodic=(True, True))

    def step_g(v, p, g1, g2, f):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    evals = []
    for rep in range(1 + GRAD_REPS):
        for fn, _ in wrappers.values():
            fn.launches = 0
        fb0, it0 = krylov.bicgstab.fallbacks, krylov.bicgstab.iterations
        ap0 = sum(krylov.bicgstab.applies.values())
        rs0 = sum(krylov.bicgstab.residuals.values())
        j0 = jac1_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step_g, v, pressure, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = {k: fn.launches for k, (fn, _) in wrappers.items()}
        row3 = jac1_schedule_check("grad30", j0, jac1_snapshot())
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg2_iters_per_step=sum(a.iterations for a in p_adj) / U,
            # adjoint solves whose gradient the (1 - failed) gate zeroed, as in
            # the JAX package: a float32 adjoint at tol 1e-8 x max|g| can end
            # above 100 x that tol (reported, not a failure). Beside it, the
            # pressure adjoints' residual / limit nearest the gate on either
            # side: the largest that passed and the smallest that was gated.
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            adjoint_ratio_gated_min=min((a.residual / a.limit for a in p_adj if a.gated),
                                        default=None),
            bicgstab_fallbacks=krylov.bicgstab.fallbacks - fb0,
            bicgstab_iterations=krylov.bicgstab.iterations - it0, launches=counts,
            row3_kernel_launches=row3,
        ))
        print(json.dumps(dict(grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"grad30: |grad| = {gnorm} (must be finite and > 0)")
        # a BiCGSTAB fallback, should one occur, runs its phases and the
        # fused stencil residual at its entry and exit
        applies = sum(krylov.bicgstab.applies.values()) - ap0
        resid = sum(krylov.bicgstab.residuals.values()) - rs0
        want_all = dict(expected, stencil_matvec=2 * applies, stencil_residual=2 * resid,
                        **{k: 2 * evals[-1]["bicgstab_iterations"] for k in BICG_PHASES})
        for k, want in want_all.items():
            if counts[k] != want:
                fail(f"grad30: {k} launched {counts[k]} times, expected {want}")
    timed = [e for e in evals if e["timed"]]
    grad30 = dict(
        workload=f"decaying turbulence {N}^2, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg2_iters_per_step=sum(e["adjoint_pcg2_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )
    print(json.dumps(grad30), flush=True)
    # 19d: the same state, grad30 without and with the adjoint warm-start channels
    c2d = channels_2d_path(dev, {k: fn for k, (fn, _) in wrappers.items()}, domain, sim, dt, v,
                           pressure)

    # -- phase 6: the lid-driven cavity -----------------------------------------
    cavity_small_check(dev)
    cav_fwd, cav_grad = cavity_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 2i: row 10d (the CG iteration) at the 513 x 512 cavity's shapes ------
    cg_kernels(dev, kernels)

    # -- phase 7: the spatial mixing layer ------------------------------------------
    mixing_small_check(dev)
    mix_fwd, mix_grad = mixing_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 8: closure training at batch 1 (bench.py workload_training) -------------
    training_small_check(dev)
    train_b1 = training_b1_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 9: closure training at batch 8 --------------------------------------------
    training_batched_check(dev)
    train_b8 = training_b8_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 10: turbulence at 1024^2 (bench.py turb_1024) -----------------------------
    large_small_check(dev)
    turb1024_fwd, turb1024_grad = large_turbulence_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 11: the 512 x 2048 mixing-layer DNS (bench.py dns_512x2048) ---------------
    dns_fwd, dns_grad = mixing_path(dev, {k: fn for k, (fn, _) in wrappers.items()}, DNS_RES,
                                    "dns", ("jacobi1_solve", 2))

    # -- phase 12: 3-D decaying turbulence (bench.py workload_turb3d) ---------------------
    turb3d_small_check(dev)
    # (c) and 19b: grad10 without and with the adjoint warm-start channels
    turb3d_fwd, turb3d_grad, turb3d_ch = turb3d_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()}, turb3d_state_dev,
        channels=(False, True))
    # 19a: 32^3 card vs CPU, grad10 with the adjoint warm-start channels
    turb3d_small_check(dev, T3_SMALL, channels=True, unroll=T3_UNROLL)

    # -- phase 13: the batched "auto" regime (per-sample planes from 512^2) -----------------
    batched_measured = batched_kernels(dev, kernels)
    bat = batched_paths(dev, {k: fn for k, (fn, _) in wrappers.items()})
    bat["batched_training"] = batched_training_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 14: 3-D turbulence past the whole solve's budget (bench.py --n3d 256, 512) -----
    # (a) 64^3 card vs CPU in the z-block tier, forced at bz 16
    with forced_zblock(T3_ZB_SMALL_BZ):
        turb3d_small_check(dev, T3_ZB_SMALL, T3_ZB_SMALL_BZ, T3_BIG_REMAT)
    # 2h at 256^3 (the z block) on the state after bench.py's spin-up, then
    # (b) the forward and (c) grad10 under "outputs" remat from it
    state_big = turb3d_tier_kernels(dev, kernels, T3_BIG, "zblock", T3_SPINUP_CALLS, T3_CALL)
    # 2n at 256^3 on the same state
    rank3["turbulence256"] = turb3d_rank3(dev, T3_BIG, state_big)
    # (c) and 19c: grad10 without and with the adjoint warm-start channels
    big_fwd, big_grad, big_ch = turb3d_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()}, state_big, T3_BIG, "zblock",
        T3_BIG_REMAT, grad_reps=T3_BIG_GRAD_REPS, channels=(False, True))
    del state_big
    torch.cuda.empty_cache()
    # 2h at 512^3 (the plane sweeps) after one spin-up call of 20 steps,
    # then (d) one timed call of 20 forward steps (bench.py --fwd-only,
    # cut for time)
    state_huge = turb3d_tier_kernels(dev, kernels, T3_HUGE, "plane", 1, T3_HUGE_CALL)
    huge_fwd, _, _ = turb3d_path(dev, {k: fn for k, (fn, _) in wrappers.items()}, state_huge,
                              T3_HUGE, "plane", calls=1, call_steps=T3_HUGE_CALL, grad_reps=0)
    del state_huge
    torch.cuda.empty_cache()

    # -- phase 15: the default pressure solver (plain CG) and the function kinds -------
    # (a) 64^2 card vs CPU under CG; (b) path A: the 512 cavity under CG
    # from phase 6's state, forward and grad30
    cg_small_check(dev)
    cga_fwd, cga_grad = cg_cavity_path(dev, {k: fn for k, (fn, _) in wrappers.items()})
    # (c) fft, mg on the 512^2 turbulence and channel on the 128 x 512 mixing
    # layer, after one step of each card vs CPU
    kinds_small_check(dev)
    kinds = kinds_path(dev, {k: fn for k, (fn, _) in wrappers.items()})
    # (d) path B: the Ghia validation at 128^2, Re 1000, to t = 100
    ghia_path(dev)

    # -- phase 2j: rows 8b and 14 at 1024 x 2048, row 14 on the mixing faces ---------------
    sweeps_measured = sweeps_kernels(dev, kernels)

    # -- phase 16: periodic turbulence at 1024 x 2048, the k-sweep tier -------------------
    # (a) 32 x 64 card vs CPU with the tiers forced; (b) the forward and (c)
    # grad30 at full size
    sweeps_small_check(dev)
    sweep_fwd, sweep_grad = large_turbulence_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()}, SWEEP_RES, SWEEP_BOX)

    # -- phase 2k: row 13 at the cavity, mixing, pipe and batched shapes -------------------
    masked_measured = masked_kernels(dev)

    # -- phase 17: the channel flows -----------------------------------------------------
    # (a) card vs CPU at small sizes; (b) the Karman street at 512 x 1536 (row 13
    # at its shape on the spun-up state); (c) the pipe at 32 x 64 to steady state
    channel_small_check(dev)
    karman_fwd, karman_entry = karman_path(dev, {k: fn for k, (fn, _) in wrappers.items()})
    pipe_fwd = pipe_path(dev, {k: fn for k, (fn, _) in wrappers.items()})
    kernels.append(dict(
        name="advection_assembly_masked", route="cuda",
        source="diffpiso_tpu_torch/csrc/advassembly_masked.cu",
        replaces="diffpiso_tpu/ops/pallas_advassembly.py:365", library_ms=None,
        launches_count="one launch per assembly (both components)",
        **karman_entry, **masked_measured))

    # -- phase 18: the bounded 3-D lid-driven cavity ---------------------------------------
    # (a) N = 16 card vs CPU under dct and CG; (b) N = 128 under dct, 2n on its
    # spun-up pressure system; (c) the same state under plain CG
    cavity3d_small_check(dev)
    cav3_fwd, cav3_cg = cavity3d_path(dev, {k: fn for k, (fn, _) in wrappers.items()}, rank3)
    rank3_merge(kernels, rank3)
    pcg3_merge(kernels, PCG3_RESULTS)
    # every 2-D path launched none of the rank-3 pressure kernels
    two_d = {"turbulence forward": launches, "turbulence grad30": grad30["launches_per_eval"],
             "cavity forward": cav_fwd, "cavity grad30": cav_grad, "mixing forward": mix_fwd,
             "mixing grad30": mix_grad, "training batch 1": train_b1,
             "training batch 8": train_b8, "turbulence 1024 forward": turb1024_fwd,
             "turbulence 1024 grad30": turb1024_grad, "dns forward": dns_fwd,
             "dns grad30": dns_grad, "cavity CG forward": cga_fwd,
             "cavity CG grad30": cga_grad, "turbulence 1024x2048 forward": sweep_fwd,
             "turbulence 1024x2048 grad30": sweep_grad, "karman forward": karman_fwd,
             "pipe": pipe_fwd, "turbulence grad30 with adjoint channels": c2d, **bat, **kinds}
    for path, counts in two_d.items():
        for k in RANK3_KERNELS + PCG3_KERNELS:
            if counts.get(k) != 0:
                fail(f"{path}: {k} launched {counts.get(k)} times on a 2-D path (expected 0)")

    # -- phase 20: the per-shard solvers (rows 18a-18d) on the (1,1) sliver mesh ----------
    # (a) each kernel against its twin on a 512^2 step's operators; (e) 64^2 card
    # vs CPU; (b) the forward path, (c) grad30 under adjoint="auto", (d) the
    # whole-solve tier, each from phase 4's 512^2 state
    shard_kernels_check(dev, kernels)
    shard_small_check(dev)
    flat = {k: fn for k, (fn, _) in wrappers.items()}
    shard_fwd = shard_forward_path(dev, flat)
    shard_grad = shard_grad_path(dev, flat)
    shard_whole = shard_whole_path(dev, flat)
    # every earlier path launched none of rows 18a-18d
    earlier = dict(two_d, **{
        "turbulence 128^3 forward": turb3d_fwd, "turbulence 128^3 grad10": turb3d_grad,
        "turbulence 128^3 grad10 with channels": turb3d_ch[True],
        f"turbulence {T3_BIG}^3 forward": big_fwd, f"turbulence {T3_BIG}^3 grad10": big_grad,
        f"turbulence {T3_BIG}^3 grad10 with channels": big_ch[True],
        f"turbulence {T3_HUGE}^3 forward": huge_fwd, "3-D cavity forward": cav3_fwd,
        "3-D cavity CG": cav3_cg})
    for path, counts in earlier.items():
        for k in SHARD_KERNELS:
            if counts.get(k) != 0:
                fail(f"{path}: {k} launched {counts.get(k)} times outside the sharded context "
                     "(expected 0)")

    # each kernel's `launches` come from the path it is checked on: the PCG
    # phases from the mixing layer's forward run; the cavity's own kernels
    # from its forward run (gradT2m, which only a backward pass launches,
    # and the BiCGSTAB phases, which only its adjoint's fallback launches,
    # from its grad30 evaluation); the large tier's from the 1024^2
    # turbulence forward run, the 3-D kernels from the 128^3 forward run, the
    # z-block and plane kernels from the 256^3 and 512^3 forward runs, the
    # others from the 512^2 turbulence forward run; every path's counts
    # stand beside them
    for entry in kernels:
        name = entry["name"]
        key = BAT_WRAPPER.get(name, name)  # a batched entry's wrapper counter
        if name == "shard_pressure_whole":
            entry["path"] = (f"sharded turbulence {N}^2, whole tier (always), (1,1) mesh, forced "
                             "slivers")
            entry["launches"] = shard_whole[name]
        elif name in SHARD_KERNELS:
            entry["path"] = f"sharded turbulence {N}^2 forward, (1,1) mesh, forced slivers"
            entry["launches"] = shard_fwd[name]
        elif name in BAT_ENTRIES:
            entry["path"] = "batched turbulence 512^2 x 4 forward"
            entry["launches"] = bat["batched512"][key]
        elif name in BAT_TRAIN_ENTRIES:
            entry["path"] = "batched training 256x1024 x 2, auto regime"
            entry["launches"] = bat["batched_training"][key]
        elif name == "jacobi1_solve_batched":
            entry["path"] = "batched turbulence 1024^2 x 2 forward"
            entry["launches"] = bat["batched1024"][name]
        elif name in T3_KERNELS:
            entry["path"] = "turbulence 128^3 forward"
            entry["launches"] = turb3d_fwd[name]
        elif name == T3_TIER_KERNELS["zblock"]:
            entry["path"] = f"turbulence {T3_BIG}^3 forward"
            entry["launches"] = big_fwd[name]
        elif name == T3_TIER_KERNELS["plane"]:
            entry["path"] = f"turbulence {T3_HUGE}^3 forward"
            entry["launches"] = huge_fwd[name]
        elif name == "cg_iteration":
            entry["path"] = f"cavity {CAV_N} under CG forward"
            entry["launches"] = cga_fwd[name]
        elif name == "cg_iteration3":
            entry["path"] = f"3-D cavity {CAV3_N} under CG forward"
            entry["launches"] = cav3_cg[name]
        elif name in PCG3_KERNELS:
            entry["path"] = (f"turbulence {T3_N}^3 grad{T3_UNROLL} with adjoint channels (one "
                             "evaluation)")
            entry["launches"] = turb3d_ch[True][name]
        elif name in RANK3_KERNELS:
            entry["path"] = "turbulence 128^3 forward"
            entry["launches"] = turb3d_fwd[name]
        elif name == "jacobi_sweeps":
            entry["path"] = "turbulence 1024x2048 forward"
            entry["launches"] = sweep_fwd[name]
        elif name == "advection_assembly_masked":
            entry["path"] = f"Karman street {KARMAN_NY} x {3 * KARMAN_NY} forward"
            entry["launches"] = karman_fwd[name]
        elif name in BWD_KERNELS:
            entry["path"] = f"turbulence {N}^2 grad30 (one evaluation)"
            entry["launches"] = grad30["launches_per_eval"][name]
        elif name == "spectral_apply":
            entry["path"] = "mixing forward"
            entry["launches"] = mix_fwd[name]
        elif name == "stencil_residual":
            # a hand-over's entry and exit residual: the mixing layer's forward
            # hands over; the 1024 x 2048 run's counts stand beside it
            entry["path"] = "mixing forward"
            entry["launches"] = mix_fwd[name]
        elif name in LARGE_KERNELS:
            entry["path"] = "turbulence 1024 forward"
            entry["launches"] = turb1024_fwd[name]
        elif name == "jacobi2_solve_folded":
            entry["path"] = "training batch 8"
            entry["launches"] = train_b8[name]
        elif name in MIXING_KERNELS:
            entry["path"] = "mixing forward"
            entry["launches"] = mix_fwd[name]
        elif name in CAVITY_KERNELS:
            grad_only = name in CAVITY_GRAD_KERNELS
            entry["path"] = "cavity grad30" if grad_only else "cavity forward"
            entry["launches"] = cav_grad[name] if grad_only else cav_fwd[name]
        else:
            entry["path"] = "turbulence forward"
            entry["launches"] = launches[name]
        entry["grad30_launches"] = grad30["launches_per_eval"][key]
        entry["cavity_launches"] = cav_fwd[key]
        entry["cavity_grad30_launches"] = cav_grad[key]
        entry["mixing_launches"] = mix_fwd[key]
        entry["mixing_grad30_launches"] = mix_grad[key]
        entry["training_b1_launches"] = train_b1[key]
        entry["training_b8_launches"] = train_b8[key]
        entry["turb1024_launches"] = turb1024_fwd[key]
        entry["turb1024_grad30_launches"] = turb1024_grad[key]
        entry["dns_launches"] = dns_fwd[key]
        entry["dns_grad30_launches"] = dns_grad[key]
        entry["turb3d_launches"] = turb3d_fwd[key]
        entry["turb3d_grad10_launches"] = turb3d_grad[key]
        entry["turb3d_grad10_channels_launches"] = turb3d_ch[True][key]
        entry[f"turb3d{T3_BIG}_grad10_channels_launches"] = big_ch[True][key]
        entry["grad30_channels_launches"] = c2d[key]
        entry[f"turb3d{T3_BIG}_launches"] = big_fwd[key]
        entry[f"turb3d{T3_BIG}_grad10_launches"] = big_grad[key]
        entry[f"turb3d{T3_HUGE}_launches"] = huge_fwd[key]
        for path, counts in bat.items():
            entry[f"{path}_launches"] = counts[key]
        entry["cavity_cg_launches"] = cga_fwd[key]
        entry["cavity_cg_grad30_launches"] = cga_grad[key]
        entry["turb1024x2048_launches"] = sweep_fwd[key]
        entry["turb1024x2048_grad30_launches"] = sweep_grad[key]
        for kind, counts in kinds.items():
            entry[f"{kind}_launches"] = counts[key]
        entry["karman_launches"] = karman_fwd[key]
        entry["pipe_launches"] = pipe_fwd[key]
        entry["cavity3d_launches"] = cav3_fwd[key]
        entry["cavity3d_cg_launches"] = cav3_cg[key]
        entry["sharded_launches"] = shard_fwd[key]
        entry["sharded_grad30_launches"] = shard_grad[key]
        entry["sharded_whole_tier_launches"] = shard_whole[key]
        entry.update(large_measured.get(name, {}))
        entry.update(batched_measured.get(name, {}))
        entry.update(sweeps_measured.get(name, {}))
        if name in cavity_measured:
            entry["cavity"] = cavity_measured[name]
        if name in mixing_measured:
            entry["mixing"] = mixing_measured[name]
        if name in training_measured:
            entry["training"] = training_measured[name]
        if not entry["launches"]:
            fail(f"{name}: never launched on its path")
    measure_device_times(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
