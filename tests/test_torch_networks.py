"""The closure CNN (diffpiso_tpu_torch/models/networks.py) against the JAX
package's `fullyconv_apply` at its published widths (kernels 7/5/5/3/3/1/1,
features 16, 16, 32, 64, 64, 64 -> 2, bias-free, leaky-ReLU 0.2): the
forward and its VJP with respect to the input and every weight, for VALID
with restore_shape, SAME, and a buffer width, within rtol 1e-5. Weights
cross with convert.py (HWIO <-> OIHW); inputs are made with numpy from a
seed. Both packages compute cross-correlation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.models.networks import fullyconv_apply as jax_apply
from diffpiso_tpu.models.networks import init_fullyconv as jax_init
from diffpiso_tpu.models.networks import receptive_field_half_width as jax_half
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.models.networks import (
    FullyConv,
    fullyconv_apply,
    init_fullyconv,
    receptive_field_half_width,
)
from tests.torch_parity import n, t

CASES = {
    "valid_restore": dict(padding="VALID", restore_shape=True, buffer_width=None),
    "same": dict(padding="SAME", restore_shape=False, buffer_width=None),
    "same_buffer": dict(padding="SAME", restore_shape=False, buffer_width=((2, 1), (3, 4))),
    "valid_restore_buffer": dict(padding="VALID", restore_shape=True,
                                 buffer_width=((1, 2), (0, 3))),
}


def _weights(seed=0):
    params = jax_init(jax.random.PRNGKey(seed), in_channels=4)
    return [np.asarray(w, np.float32) for w in params]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_widths_init_and_receptive_field_match_jax():
    hwio = _weights()
    oihw = init_fullyconv(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(w.shape) for w in oihw] == [
        tuple(w.shape) for w in convert.fullyconv_params_from_jax(hwio, device="cpu")]
    assert [w.shape[0] for w in oihw] == [16, 16, 32, 64, 64, 64, 2]
    assert [w.shape[-1] for w in oihw] == [7, 5, 5, 3, 3, 1, 1]
    assert receptive_field_half_width() == jax_half() == 9
    # Glorot-normal: the same std per layer (fan = k * k * channels)
    for a, b in zip(oihw, hwio):
        k, _, ci, co = b.shape
        std = (2.0 / (k * k * ci + k * k * co)) ** 0.5
        assert abs(float(a.std()) / std - 1) < 0.25 if a.numel() > 100 else True
    # the conversion round-trips exactly
    back = convert.fullyconv_params_to_jax(convert.fullyconv_params_from_jax(hwio, device="cpu"))
    for a, b in zip(back, hwio):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax(case):
    kw = CASES[case]
    rng = np.random.default_rng(3)
    hwio = _weights()
    x = rng.standard_normal((2, 24, 40, 4)).astype(np.float32)  # NHWC
    want, vjp = jax.vjp(lambda w, a: jax_apply(w, a, **kw), [jnp.asarray(w) for w in hwio],
                        jnp.asarray(x))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    want_w, want_x = vjp(jnp.asarray(ct))

    params = [w.requires_grad_(True) for w in convert.fullyconv_params_from_jax(hwio, device="cpu")]
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    got = fullyconv_apply(params, xt, **kw)
    assert got.shape == (2, 2, 24, 40)
    np.testing.assert_allclose(n(got.permute(0, 2, 3, 1)), n(want), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(n(want)))))
    gw = torch.autograd.grad(got, params + [xt], t(ct).permute(0, 3, 1, 2))
    for a, b in zip(convert.fullyconv_params_to_jax(gw[:-1]), want_w):
        assert _rel(a, n(b)) <= 1e-5
    assert _rel(n(gw[-1].permute(0, 2, 3, 1)), n(want_x)) <= 1e-5
    if kw["padding"] == "VALID" and kw["restore_shape"]:
        # the restored border is zero
        h = receptive_field_half_width()
        (t0, _), (l0, _) = kw["buffer_width"] or ((0, 0), (0, 0))
        assert float(got.detach()[..., :t0 + h, :].abs().max()) == 0.0
        assert float(got.detach()[..., :, :l0 + h].abs().max()) == 0.0


def test_per_sample_weights_are_one_convolution_per_sample():
    """The batched step's grouped convolution: sample b through weight copy b
    equals the plain network on sample b with those weights."""
    rng = np.random.default_rng(4)
    base = convert.fullyconv_params_from_jax(_weights(), device="cpu")
    per = [torch.stack([w, 1.5 * w, -w]) for w in base]
    x = t(rng.standard_normal((3, 4, 20, 32)))
    got = fullyconv_apply(per, x, padding="SAME")
    for b in range(3):
        want = fullyconv_apply([w[b] for w in per], x[b], padding="SAME")
        torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-6)


def test_module_wraps_the_functional_forward_and_valid_needs_room():
    base = convert.fullyconv_params_from_jax(_weights(), device="cpu")
    net = FullyConv(base, padding="VALID", restore_shape=True)
    x = torch.randn(1, 4, 19, 40, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(net(x), fullyconv_apply(base, x, "VALID", None, True))
    assert len(list(net.parameters())) == 7
    with pytest.raises(ValueError, match="VALID padding needs input >= 19"):
        fullyconv_apply(base, x[..., :18, :], "VALID")
