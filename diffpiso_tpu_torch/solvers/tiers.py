"""The size tiers of the solves: which whole-solve kernel or loop a shape
takes, as the JAX package decides it on the TPU.

The port's own copies of the shape rules in
diffpiso_tpu/solvers/pallas_krylov.py, as plain functions of shape, dtype
and basis kinds:

  jac2_eligible       `jac2_eligible:1067`   two rank-2 components,
                                             13 x sum(cells) x 4 B <= 72 MiB
  jac1_eligible       `jac1_eligible:1039`   20 x cells x 4 B <= 120 MiB
  phase_tier          `eligible:86`          12 planes <= 13 MiB, else a
                                             plane <= 8 MiB with every
                                             kind `fourier` (or no kinds)
  cg_tier             `eligible:86`, no kinds  `krylov.cg`'s phase kernel
                                             (row 10d) or its generic loop;
                                             volumes: `volume_phases`
  volume_phases       (`eligible3:176`,      every volume: the rank-3 phases
                      `spectral_eligible_3d`) (10e), the 3-D apply (16-3d);
                                             the budgets not copied
  pcg2_eligible       `pcg2_eligible:2369`   `_pcg2_plane_bytes` of the
                                             padded plane <= 24 MiB
  mm_update_eligible  `mm_update_large_eligible:1980`  every kind
                                             `fourier`, a plane <= 8 MiB,
                                             2 (n0^2 + n1^2) x 4 B + 8
                                             planes + 2 MiB <= 127 MiB
  jac13d_eligible     `jac13d_eligible:1194` a rank-3 volume,
                                             15 x cells x 4 B <= 120 MiB
  zblock_eligible     `zblock_eligible:1468` the largest divisor bz >= 4
                                             of nz with 36 bz planes
                                             <= 110 MiB (`_zblock_size`)
  eligible_3d         `eligible_3d:1222`     13 (ny, nx) planes <= 13 MiB

The budgets are the TPU's VMEM, but the tiers they pick are not
interchangeable, so the port follows them: jac1 decides convergence per
component where jac2 decides it jointly (other sweeps, other iterates),
and the per-iteration PCG loop applies residual resets and the warm early
exit, which pcg2 ignores. In 3-D the three Jacobi tiers differ in their
sweeps: the whole solve (jac13d) couples z within each sweep, the z-block
tier only inside a block, the plane tier freezes z within a launch. Budgets that only change the layout are not
copied (see ROADMAP.md, rules for the port). One clause is left out on
purpose: pcg2's adjoint alignment exclusion (`pallas_krylov.py:2394-2403`)
is the cost of Mosaic re-padding an unaligned periodic plane. Adjoint
solves run with no residual reset and no early exit in both tiers, so it
changes no decision of the algorithm, only rounding; without it the
port's small periodic planes (64^2, 128^2) stay on pcg2 for their adjoints
too. The environment switches of the JAX gates are not copied either: the
port has no knob that selects a tier.

B samples at once in the "auto" batched regime (diffpiso_tpu_torch/regime.py)
run their whole solves per sample by `batched_momentum_tier` /
`batched_pressure_tier`, the rules of the JAX kernels' grid-over-batch
`custom_vmap` rules."""

from __future__ import annotations

MIB = 1024 * 1024
_LARGE_PLANE_BYTES = 8 * MIB
_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}


def _itemsize(dtype) -> int:
    return _ITEMSIZE[str(dtype).replace("torch.", "")]


def _cells(shape) -> int:
    return int(shape[0]) * int(shape[1])


def jac2_eligible(shapes, dtype="float32") -> bool:
    """The joint whole-solve momentum kernel: exactly two rank-2 components
    whose ~13 resident planes each fit 72 MiB."""
    if len(shapes) != 2 or any(len(s) != 2 for s in shapes):
        return False
    item = _itemsize(dtype)
    return item <= 4 and 13 * sum(_cells(s) for s in shapes) * item <= 72 * MIB


def jac1_eligible(shape, dtype="float32") -> bool:
    """The per-component whole-solve momentum kernel: 20 planes of one
    rank-2 component within 120 MiB."""
    item = _itemsize(dtype)
    return len(shape) == 2 and item <= 4 and 20 * _cells(shape) * item <= 120 * MIB


def phase_tier(shape, kinds=None, dtype="float32") -> bool:
    """The per-iteration phase kernels: 12 planes within 13 MiB, or, in the
    large tier, a plane of at most 8 MiB when the preconditioner's bases are
    all `fourier` (no kinds: the momentum solves' shape-only gate)."""
    item = _itemsize(dtype)
    if len(shape) != 2 or item > 4:
        return False
    plane = _cells(shape) * item
    if 12 * plane <= 13 * MIB:
        return True
    if plane > _LARGE_PLANE_BYTES:
        return False
    return kinds is None or all(k == "fourier" for k in kinds)


def cg_tier(shape, dtype="float32") -> str:
    """What an unpreconditioned CG solve (and a PCG solve whose
    preconditioner is a function: `fft`, `dct`, `channel`, `mg`) runs:
    'phases' (one CG iteration kernel a step, the residual kernel at the
    warm start, each reset and the exit; for PCG the apply / update
    phases) on every volume (`volume_phases`) and on planes where the JAX
    gate `eligible` opens with no kinds (12 planes within 13 MiB, or any
    2-D plane up to 8 MiB); otherwise 'generic' (plain ops around the
    matvec kernels: planes past 8 MiB). Both follow the same recurrence,
    with the same resets and exit test."""
    if volume_phases(shape):
        return "phases"
    return "phases" if phase_tier(shape, None, dtype) else "generic"


def volume_phases(shape) -> bool:
    """Whether a pressure solve runs the rank-3 phase kernels (row 10e:
    the residual, the PCG apply, the CG iteration; the PCG update as
    (nz ny, nx) planes) and, for the `_mm` kinds, the fused 3-D spectral
    apply (row 16-3d): every volume (`krylov.pcg`, `krylov.cg` and the
    function-preconditioned PCG all ask here; the pressure solves run in
    float32 only, `base.PressureSolver`). The JAX gates `eligible3` (12
    volumes within 110 MiB of VMEM, `pallas_krylov.py:176-194`) and
    `spectral_eligible_3d` (`:2474-2508`) are not copied. Their budget is
    the TPU's layout, and their default, off, was measured against XLA
    fusing the generic loop's ops on the TPU; on the H100 nothing fuses
    them. Both branches run the same recurrence (the same residuals,
    resets, exit test and preconditioner), so the choice changes rounding,
    not the algorithm: it is one of "the phase kernels or XLA for the PCG
    loop", which ROADMAP.md's rules for the port leave to the port."""
    return len(shape) == 3


def _pcg2_plane_bytes(shape, item) -> int:
    n0, n1 = shape
    return (n0 * n0 + n1 * n1 + 16 * n0 * n1) * item


def pcg2_eligible(shape, periodic=None, dtype="float32") -> bool:
    """The whole-solve spectral PCG: its bases and ~16 planes within 24 MiB,
    measured on the plane padded to (8, 128) multiples along bounded axes
    (the TPU pads those once; periodic axes are not padded)."""
    item = _itemsize(dtype)
    if len(shape) != 2 or item > 4:
        return False
    per = tuple(periodic) if periodic is not None else (False, False)
    padded = (shape[0] + (0 if per[0] else (-shape[0]) % 8),
              shape[1] + (0 if per[1] else (-shape[1]) % 128))
    return _pcg2_plane_bytes(padded, item) <= 24 * MIB


def mm_update_eligible(shape, kinds, dtype="float32") -> bool:
    """M^-1 folded into the PCG update: all-`fourier` bases, a plane of at
    most 8 MiB, the two bases (twice), 8 planes and 2 MiB within 127 MiB."""
    item = _itemsize(dtype)
    if len(shape) != 2 or item > 4 or any(k != "fourier" for k in kinds):
        return False
    n0, n1 = shape
    plane = n0 * n1 * item
    if plane > _LARGE_PLANE_BYTES:
        return False
    return 2 * (n0 * n0 + n1 * n1) * item + 8 * plane + 2 * MIB <= 127 * MIB


def jac13d_eligible(shape, dtype="float32") -> bool:
    """The 3-D whole-solve momentum kernel: 15 volumes of one rank-3
    component within 120 MiB (128^3 meets it exactly)."""
    item = _itemsize(dtype)
    return len(shape) == 3 and item <= 4 and 15 * _volume(shape) * item <= 120 * MIB


def _zblock_size(shape, dtype="float32", budget_bytes=110 * MIB):
    """The largest divisor bz >= 4 of nz whose 36 resident z blocks of bz
    planes fit the budget; None if none does."""
    nz = int(shape[0])
    plane = int(shape[1]) * int(shape[2]) * _itemsize(dtype)
    best = None
    for bz in range(4, nz + 1):
        if nz % bz == 0 and 36 * bz * plane <= budget_bytes:
            best = bz
    return best


def zblock_eligible(shape, dtype="float32"):
    """The z-block tier (the 256^3 class): the block size bz, or None."""
    if len(shape) != 3 or _itemsize(dtype) > 4:
        return None
    return _zblock_size(shape, dtype)


def eligible_3d(shape, dtype="float32") -> bool:
    """The z-plane sweep tier: 13 (ny, nx) planes within 13 MiB."""
    item = _itemsize(dtype)
    return len(shape) == 3 and item <= 4 and 13 * int(shape[1]) * int(shape[2]) * item <= 13 * MIB


def _volume(shape) -> int:
    return int(shape[0]) * int(shape[1]) * int(shape[2])


def momentum_tier_3d(shapes, dtype="float32") -> str:
    """What a structured momentum solve on rank-3 components runs first, in
    the order of the JAX package's `krylov.bicgstab` (krylov.py:340-360):
    'jac13d' (one whole solve per component, every component within its
    budget), 'zblock' (k full 3-D sweeps per z block, every component with
    a block size), 'plane' (k in-plane sweeps with z frozen) or 'none'
    (BiCGSTAB from the guess, no Jacobi)."""
    if all(jac13d_eligible(s, dtype) for s in shapes):
        return "jac13d"
    if all(zblock_eligible(s, dtype) for s in shapes):
        return "zblock"
    if all(eligible_3d(s, dtype) for s in shapes):
        return "plane"
    return "none"


def momentum_tier(shapes, dtype="float32") -> str:
    """What a structured momentum solve on rank-2 components runs first:
    'jac2' (both components in one whole solve), 'jac1' (one whole solve
    per component), 'sweeps' (k-sweep launches, `fused_jacobi_sweeps`:
    planes up to 8 MiB past jac1's budget) or 'none' (BiCGSTAB from the
    guess, no Jacobi: the JAX package's fused gate is closed too)."""
    if jac2_eligible(shapes, dtype):
        return "jac2"
    if all(jac1_eligible(s, dtype) for s in shapes):
        return "jac1"
    if all(phase_tier(s, None, dtype) for s in shapes):
        return "sweeps"
    return "none"


def pressure_tier(shape, kinds, periodic, zero_mean: bool, deflate: bool,
                  dtype="float32") -> str:
    """What a spectral pressure solve runs: 'pcg2' (the whole solve; only
    for a preconditioner that zeroes the mean mode), 'mm_update' (the
    per-iteration loop with M^-1 folded into the update) or 'loop' (the
    per-iteration loop, M^-1 r between the apply and the update). The fold
    needs the preconditioner's output to be mean-free when deflating, as
    the loop then projects nothing."""
    if zero_mean and pcg2_eligible(shape, periodic, dtype):
        return "pcg2"
    if (phase_tier(shape, kinds, dtype) and mm_update_eligible(shape, kinds, dtype)
            and (zero_mean or not deflate)):
        return "mm_update"
    return "loop"


# -- B samples at once: the per-sample tiers of the "auto" regime -------------------


def batched_momentum_tier(shapes, dtype="float32") -> str:
    """What a batched momentum solve on rank-2 components runs first, per
    sample, under "auto" (the vmapped `krylov.bicgstab` under
    `batched_safe_pallas`): 'jac2' (the grid-over-batch rule of the joint
    solve, or its fold below 1 MiB planes: one kernel here), 'jac1' (the
    per-component grid rule past jac2's budget) or 'none' (BiCGSTAB from
    the guess: the k-sweep tier's gate is closed under
    `batched_safe_pallas`, so no Jacobi runs past jac1's budget). `shapes`
    are the per-sample component shapes."""
    if jac2_eligible(shapes, dtype):
        return "jac2"
    if all(jac1_eligible(s, dtype) for s in shapes):
        return "jac1"
    return "none"


def batched_pressure_tier(shape, periodic, zero_mean: bool, dtype="float32") -> str:
    """What a batched spectral pressure solve runs under "auto", per sample:
    'pcg2' (the whole solve's grid-over-batch rule, a mean-free
    preconditioner within pcg2's budget) or 'loop' (the generic
    per-iteration loop with resets and early exit; the phase kernels and
    the folded update bow out under `batched_safe_pallas`). `shape` is the
    per-sample plane."""
    if zero_mean and pcg2_eligible(shape, periodic, dtype):
        return "pcg2"
    return "loop"
