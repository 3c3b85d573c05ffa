"""The spectral-penalty LMI solver of the PyTorch port against the JAX
package's: the penalty and its gradient at fixed points within 1e-5, the
verdicts on ``tests/agents/test_lmi.py``'s four systems equal, and every
certified solution passing the exact float64 check. The descent itself does
not follow JAX's bit for bit: ``eigvalsh`` differs by ulps between the two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.control import IntervalFeedbackAgent, extended_matrices
from rl_agents_torch.utils import lmi as torch_lmi
from rl_agents_tpu.agents.control import IntervalFeedbackAgent as JaxIntervalFeedbackAgent
from rl_agents_tpu.utils import lmi as jax_lmi

torch.set_num_threads(1)

# tests/agents/test_lmi.py's systems
STABLE = dict(A0=[[-1.0, 1.0], [0.0, -2.0]], dA=[[[0.0, 0.0], [0.0, 0.1]]], B=[[0.0], [1.0]])
UNSTABLE = dict(A0=[[0.0, 1.0], [0.0, 0.0]], dA=[[[0.0, 0.0], [0.0, 0.1]]], B=[[0.0], [1.0]])
TAU, DELTA, EPS = 1e-2, 1e-3, 1e-6


def _jax_build(cA0, cA1, cA2, cB, synthesize):
    """The ``build`` of rl_agents_tpu/utils/lmi.py:180-190."""
    cA0, cA1, cA2, cB = (jnp.asarray(m, jnp.float32) for m in (cA0, cA1, cA2, cB))

    def build(theta):
        M = jax_lmi._interval_lmi_matrix(theta, cA0, cA1, cA2, cB, synthesize)
        Omega = theta["Q"] + jnp.minimum(theta["Qp"], theta["Qn"]) \
            + 2 * jnp.minimum(theta["Psi_p"], theta["Psi_n"])
        if synthesize:
            return M, [theta["P"], theta["Zp"], theta["Zn"], theta["Gamma"], Omega]
        return M, [theta["P"], theta["P"] + jnp.minimum(theta["Zp"], theta["Zn"]),
                   theta["Gamma"], Omega]
    return build


def _jax_penalty(build, theta):
    """The penalty of rl_agents_tpu/utils/lmi.py:54-60."""
    M, elementwise = build(theta)
    M = 0.5 * (M + M.T)
    pen = jax.nn.relu(jax_lmi._lmax_smooth(M, TAU) + DELTA)
    for g in elementwise:
        pen = pen + jnp.sum(jax.nn.relu(EPS - g))
    return pen


@pytest.mark.parametrize("synthesize", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_penalty_and_gradient_match_jax_at_fixed_points(synthesize, seed):
    """The port's penalty (M through its affine map, as the descent computes
    it) against JAX's at a point where every term is live."""
    matrices = extended_matrices(**STABLE)
    matrix, constraints, theta0 = torch_lmi.interval_lmi_problem(*matrices, synthesize,
                                                                 device="cpu")
    affine = torch_lmi.affine_matrix(matrix, theta0)
    rng = np.random.default_rng(seed)
    theta = {k: (rng.uniform(-0.2, 1.5, v.shape) if k in torch_lmi.DIAG_VARS
                 else rng.normal(size=v.shape)).astype(np.float32) for k, v in theta0.items()}
    x = torch_lmi.flatten(affine, {k: torch.tensor(v) for k, v in theta.items()})
    loss_t, grad_t = torch_lmi.penalty_and_grad(affine, constraints, x, TAU, DELTA, EPS)
    grads_t = torch_lmi.unflatten(affine, grad_t)
    loss_j, grads_j = jax.value_and_grad(
        lambda th: _jax_penalty(_jax_build(*matrices, synthesize), th))(
        {k: jnp.asarray(v) for k, v in theta.items()})
    assert float(loss_j) > 0.1  # the point is infeasible: every term is live
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=1e-5)
    for k in theta:
        np.testing.assert_allclose(grads_t[k].numpy(), np.asarray(grads_j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the affine map reproduces the matrix built block by block
    direct = matrix({k: torch.tensor(v) for k, v in theta.items()})
    mapped = affine.offset + (x @ affine.basis).reshape(direct.shape)
    np.testing.assert_allclose(mapped.numpy(), direct.numpy(), rtol=0, atol=1e-5)


CASES = {
    "analysis_stable": (STABLE, False, 8000),
    "analysis_unstable": (UNSTABLE, False, 2000),
    "synthesis_stable": (STABLE, True, 8000),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_verdicts_equal_jax_and_certificates_are_exact(name):
    system, synthesize, iters = CASES[name]
    matrices = extended_matrices(**system)
    sol_j = jax_lmi.solve_interval_lmi(*matrices, synthesize_control=synthesize, iters=iters)
    sol_t = torch_lmi.solve_interval_lmi(*matrices, synthesize_control=synthesize, iters=iters,
                                         device="cpu")
    assert (sol_t is None) == (sol_j is None)
    if sol_t is None:
        assert torch_lmi.solve_spectral_feasibility.steps == iters
        return
    assert np.all(np.diag(sol_t["P"]) > 0)
    if synthesize:
        cA0, _, _, cB = matrices
        assert sol_t["K0"].shape == (1, 4)
        assert np.max(np.real(np.linalg.eigvals(cA0 + cB @ sol_t["K0"]))) < 0


def test_every_certified_solution_passes_the_float64_check():
    for system, synthesize in ((STABLE, False), (STABLE, True)):
        matrices = extended_matrices(**system)
        matrix, constraints, theta0 = torch_lmi.interval_lmi_problem(*matrices, synthesize,
                                                                     device="cpu")
        theta, ok = torch_lmi.solve_spectral_feasibility(matrix, constraints, theta0)
        assert ok and torch_lmi.solve_spectral_feasibility.steps % 1000 == 0
        as_tensors = {k: torch.tensor(v) for k, v in theta.items()}
        assert torch_lmi._certify(matrix, constraints, as_tensors, EPS, 0.0)
        # JAX's own exact check agrees on the port's solution
        assert jax_lmi._certify(_jax_build(*matrices, synthesize),
                                {k: jnp.asarray(v) for k, v in theta.items()}, EPS, 0.0)


def test_interval_feedback_agent_lmi_path_matches_jax():
    """test_lmi.py's end-to-end case: both agents certify through the LMI,
    with no pole-placement fallback, and act within the same control."""
    config = dict(STABLE, D=[[0.0], [1.0]], perturbation_bound=0.1)
    agent_t = IntervalFeedbackAgent(None, dict(config), device="cpu")
    agent_j = JaxIntervalFeedbackAgent(None, dict(config))
    agent_t.reset()
    agent_j.reset()
    assert agent_t.Xf is not None and agent_j.Xf is not None
    np.testing.assert_array_equal(agent_t.S, agent_j.S)
    obs = {"interval_min": np.array([0.5, 0.0]), "interval_max": np.array([0.6, 0.1]),
           "reference_state": np.zeros(2), "state": np.array([0.55, 0.05])}
    u_t, u_j = agent_t.act(obs), agent_j.act(obs)
    assert np.isfinite(u_t).all() and u_t.shape == u_j.shape == (1,)
    assert np.sign(u_t[0]) == np.sign(u_j[0])
