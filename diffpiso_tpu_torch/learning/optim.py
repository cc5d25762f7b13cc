"""Adam with `optax.adam`'s exact semantics, as functions on tensors.

    mu  = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
    count += 1
    mu_hat = mu / (1 - b1^count)      nu_hat = nu / (1 - b2^count)
    update = -lr mu_hat / (sqrt(nu_hat + eps_root) + eps)
    params += update

b1 0.9, b2 0.999, eps 1e-8, eps_root 0. The state (count, mu, nu) is
plain tensors, so a train step that skips an update can keep the old
parameters and the old state, count included, with one select
(`torch.optim.Adam` would have to be rolled back). The bias corrections
are formed in float64 and rounded to the moments' dtype, as optax does
with x64 enabled."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
            mu=tuple(torch.zeros_like(p) for p in params),
            nu=tuple(torch.zeros_like(p) for p in params),
        )

    def update(self, grads: Sequence[torch.Tensor], state: AdamState):
        """(updates, new state) for `grads`."""
        b1, b2 = self.b1, self.b2
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu))
        count = state.count + 1
        c = count.to(torch.float64)
        bc1 = 1 - torch.pow(torch.full_like(c, b1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, b2), c)
        updates = tuple(
            -self.learning_rate * ((m / bc1.to(m.dtype))
                                   / (torch.sqrt(v / bc2.to(v.dtype) + self.eps_root) + self.eps))
            for m, v in zip(mu, nu))
        return updates, AdamState(count=count, mu=mu, nu=nu)


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]):
    return [p + u for p, u in zip(params, updates)]


def select(ok: torch.Tensor, new, old):
    """`new` where the 0-d bool `ok` holds, else `old`, leaf by leaf (a list
    of tensors or an AdamState)."""
    if isinstance(old, AdamState):
        return AdamState(*(select(ok, n, o) for n, o in zip(new, old)))
    if isinstance(old, torch.Tensor):
        return torch.where(ok, new, old)
    return type(old)(torch.where(ok, n, o) for n, o in zip(new, old))
