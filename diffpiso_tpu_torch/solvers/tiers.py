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
  pcg2_eligible       `pcg2_eligible:2369`   `_pcg2_plane_bytes` of the
                                             padded plane <= 24 MiB
  mm_update_eligible  `mm_update_large_eligible:1980`  every kind
                                             `fourier`, a plane <= 8 MiB,
                                             2 (n0^2 + n1^2) x 4 B + 8
                                             planes + 2 MiB <= 127 MiB

The budgets are the TPU's VMEM, but the tiers they pick are not
interchangeable, so the port follows them: jac1 decides convergence per
component where jac2 decides it jointly (other sweeps, other iterates),
and the per-iteration PCG loop applies residual resets and the warm early
exit, which pcg2 ignores. Budgets that only change the layout are not
copied (see ROADMAP.md, rules for the port). One clause is left out on
purpose: pcg2's adjoint alignment exclusion (`pallas_krylov.py:2394-2403`)
is the cost of Mosaic re-padding an unaligned periodic plane. Adjoint
solves run with no residual reset and no early exit in both tiers, so it
changes no decision of the algorithm, only rounding; without it the
port's small periodic planes (64^2, 128^2) stay on pcg2 for their adjoints
too. The environment switches of the JAX gates are not copied either: the
port has no knob that selects a tier."""

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
