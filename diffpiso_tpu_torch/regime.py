"""The batched regimes: how B samples at once run, as the JAX package
decides it (`learning/training.py _batched_pallas_mode` and the trace
contexts of `ops/pallas_stencil.py`).

`batched_pallas_mode` is the size rule ("fold" below 512^2 per-sample
planes, "auto" from there, "never" for batched volumes), `batched_regime`
the context that the batched entry points (the batched train step, the
batched rollout) enter with its answer, and `batched_mode` what the
batched solves and plane kernels read. Under "fold" (the default outside
any context, as under `no_pallas()` + `fold_only_pallas()`) batched planes
run plain but for the batch-folded momentum Jacobi; under "auto" (as under
`batched_safe_pallas()`) the plane kernels take a batch axis and the whole
solves run per sample (solvers/tiers.py `batched_momentum_tier` /
`batched_pressure_tier`); the iteration-phase kernels and the corrector
glue stay plain (their JAX gates close under `batched_safe_pallas`).

Below both ops/ and solvers/: each reads the regime from here."""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np

_REGIME: contextvars.ContextVar = contextvars.ContextVar("diffpiso_batched_regime",
                                                         default=None)


def batched_pallas_mode(vel0, threshold: int = 512 * 512) -> str:
    """The JAX package's regime rule of the batched step
    (`learning/training.py _batched_pallas_mode`, its size rule): "fold"
    below 512^2 per-sample component planes, "auto" from there; batched 3-D
    volumes (rank-4 leaves) resolve to "never". `vel0` is a batched
    StaggeredField (components (B, ny, nx))."""
    elems = 0
    for a in vel0.components:
        if a.ndim > 3:
            return "never"
        if a.ndim == 3:
            elems = max(elems, int(np.prod(a.shape[-2:])))
    return "auto" if elems >= threshold else "fold"


def resolve_regime(vel0) -> str:
    """The regime a batched entry point runs `vel0`'s samples in: the one an
    enclosing `batched_regime` names (as `DIFFPISO_BATCHED_PALLAS` set to a
    mode overrides the JAX package's size rule: how tests force "auto" at
    small planes), else the size rule's answer."""
    entered = _REGIME.get()
    return entered if entered is not None else batched_pallas_mode(vel0)


@contextlib.contextmanager
def batched_regime(mode: str):
    """The regime of the batched solves and plane kernels within the
    context: the counterpart of `batched_safe_pallas()` ("auto") and of
    `no_pallas()` + `fold_only_pallas()` ("fold"). An argument of the
    caller's (the batched train step and rollout enter `resolve_regime`'s
    answer; tests may enter "auto" at small planes around them), not a
    setting of the environment."""
    if mode not in ("fold", "auto"):
        raise ValueError(f"batched regime must be 'fold' or 'auto', got {mode!r}")
    token = _REGIME.set(mode)
    try:
        yield
    finally:
        _REGIME.reset(token)


def batched_mode() -> str:
    """The batched regime in force: "fold" outside any `batched_regime`."""
    return _REGIME.get() or "fold"


# -- the closed-kernels context (the JAX package's `no_pallas()`) ----------------------

_CLOSED: contextvars.ContextVar = contextvars.ContextVar("diffpiso_kernels_closed",
                                                         default=False)


@contextlib.contextmanager
def kernels_closed():
    """Within the context every kernel gate of ops/ and solvers/
    answers no, as under the JAX package's `no_pallas()`: the assemblies,
    FV ops, matvecs and corrector glue take their plain formulation, the
    momentum solves run BiCGSTAB with no Jacobi tier in front of it, and
    the pressure solves run the generic per-iteration loops. These change
    results (the tiers change the algorithm), so they are followed, not
    only the kernels' presence. `parallel/shard_kernels.py sharded_solvers`
    enters it (the solves it dispatches run its own kernels, rows 18a-18d)."""
    token = _CLOSED.set(True)
    try:
        yield
    finally:
        _CLOSED.reset(token)


def kernels_open() -> bool:
    """Whether the kernel gates may open (False inside `kernels_closed`)."""
    return not _CLOSED.get()
