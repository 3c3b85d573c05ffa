"""The PyTorch port's losses and optimizers against the JAX package's optax
ones. The optimizers take 10 updates from one fixed sequence of gradients,
shared by both packages, on an MLP's parameter shapes; the parameters must
agree within 1e-6 of each leaf's largest entry (sums of ten float32 steps
round differently at that size, e.g. XLA's ``rsqrt`` is not correctly
rounded on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_agents_torch.models.optimizers import (
    apply_updates,
    loss_function_factory as torch_loss,
    optimizer_factory as torch_optimizer,
)
from rl_agents_tpu.models.optimizers import (
    loss_function_factory as jax_loss,
    optimizer_factory as jax_optimizer,
)

torch.set_num_threads(1)

SHAPES = [(4, 32), (32,), (32, 32), (32,), (32, 2), (2,)]


@pytest.mark.parametrize("name", ["l2", "l1", "smooth_l1", "bce"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    pred = (3 * rng.standard_normal(257)).astype(np.float32)
    target = (3 * rng.standard_normal(257)).astype(np.float32)
    if name == "bce":
        target = rng.random(257).astype(np.float32)  # labels in [0, 1], pred are logits
    expected = float(jax_loss(name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(torch_loss(name)(torch.tensor(pred), torch.tensor(target)))
    assert got == pytest.approx(expected, rel=1e-6, abs=1e-6)


def test_smooth_l1_is_huber_with_delta_one():
    pred, target = torch.linspace(-3, 3, 61), torch.zeros(61)
    assert float(torch_loss("smooth_l1")(pred, target)) == pytest.approx(
        float(torch.nn.functional.smooth_l1_loss(pred, target, beta=1.0)), rel=1e-6)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        torch_loss("l3")
    with pytest.raises(ValueError):
        torch_optimizer("SGD")


@pytest.mark.parametrize("name,weight_decay", [("ADAM", 0.0), ("ADAM", 1e-2), ("RMS_PROP", 0.0),
                                               ("RANGER", 0.0), ("RANGER", 1e-2)])
def test_ten_updates_on_shared_gradients_match_optax(name, weight_decay):
    rng = np.random.default_rng(1)
    params = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    params[-1][:] = 0.0  # a zero-norm leaf: the trust ratio falls back to 1
    grads = [[(rng.standard_normal(s) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
              for s in SHAPES] for _ in range(10)]
    opt_j = jax_optimizer(name, lr=5e-4, weight_decay=weight_decay)
    opt_t = torch_optimizer(name, lr=5e-4, weight_decay=weight_decay)
    p_j = [jnp.asarray(p) for p in params]
    p_t = [torch.tensor(p) for p in params]
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for g in grads:
        u_j, s_j = opt_j.update([jnp.asarray(x) for x in g], s_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u_t, s_t = opt_t.update([torch.tensor(x) for x in g], s_t, p_t)
        p_t = apply_updates(p_t, u_t)
    for a, b in zip(p_t, p_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * np.max(np.abs(b)))
    moved = sum(float(np.max(np.abs(a.numpy() - p))) for a, p in zip(p_t, params))
    assert moved > 1e-3
    if "count" in s_t:  # the step count lives on the device, for CUDA-graph capture
        assert isinstance(s_t["count"], torch.Tensor) and int(s_t["count"]) == 10


def test_radam_switches_to_the_rectified_step_where_optax_does():
    """RANGER's RAdam returns the bias-corrected momentum until the variance
    rectification term passes 5 (optax's threshold), then rectifies: each
    update's direction is compared, step by step, over the switch."""
    rng = np.random.default_rng(2)
    param = (0.3 * rng.standard_normal((8, 8))).astype(np.float32)
    opt_j, opt_t = jax_optimizer("RANGER", lr=1.0), torch_optimizer("RANGER", lr=1.0)
    s_j, s_t = opt_j.init([jnp.asarray(param)]), opt_t.init([torch.tensor(param)])
    for _ in range(8):
        g = rng.standard_normal((8, 8)).astype(np.float32)
        u_j, s_j = opt_j.update([jnp.asarray(g)], s_j, [jnp.asarray(param)])
        u_t, s_t = opt_t.update([torch.tensor(g)], s_t, [torch.tensor(param)])
        np.testing.assert_allclose(u_t[0].numpy(), np.asarray(u_j[0]), rtol=1e-5, atol=1e-6)
