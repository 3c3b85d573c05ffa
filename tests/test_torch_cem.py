"""CEM of the PyTorch port against the JAX package, and the corpus configs of
this slice.

``cem_plan`` is fed the standard normal draws that the JAX planner makes from
its key (rl_agents_tpu/agents/cem.py:50-52: the chain splits three ways each
iteration and the first subkey draws ``[candidates, horizon, action_size]``).
The fitted mean and the best returns agree within 1e-6, the plans are equal,
and ``refit`` takes the same candidates as ``jax.lax.top_k`` (lowest index
first among equal returns: CartPole at ``gamma = 1`` returns integers) with
the same mean and biased std."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.cem import CEMAgent, CEMNoise, LatentCEMAgent, cem_plan, refit
from rl_agents_torch.convert import from_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import highway as torch_highway
from rl_agents_tpu.agents import cem as jcem
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import highway as jax_highway

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
ATOL = 1e-6


def _normals(key, iterations, candidates, horizon, action_size):
    """The draws of one JAX plan, ``[iterations, candidates, horizon, S]``."""
    out = []
    for _ in range(iterations):
        key, ks, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.normal(ks, (candidates, horizon, action_size))))
    return np.stack(out)


def _plan_both(env_j, params_j, states_j, env_t, params_t, state_cls, plan, seeds):
    """JAX plans of each state with its own key, and one batched port plan."""
    means_j, best_j, normals = [], [], []
    for b, seed in enumerate(seeds):
        key = jax.random.PRNGKey(seed)
        state = jax.tree.map(lambda x: jnp.asarray(x)[b], states_j)
        mean, best = jcem.cem_plan(env_j, params_j, state, key, **plan)
        means_j.append(np.asarray(mean))
        best_j.append(np.asarray(best))
        normals.append(_normals(key, plan["iterations"], plan["candidates"], plan["horizon"],
                                plan["action_size"]))
    noise = CEMNoise(normal=np.stack(normals, axis=1), env=None)
    mean_t, best_t = cem_plan(env_t, params_t, from_numpy(state_cls, states_j, device="cpu"),
                              None, noise=noise, device="cpu", **plan)
    np.testing.assert_allclose(mean_t.numpy(), np.stack(means_j), atol=ATOL)
    np.testing.assert_allclose(best_t.numpy(), np.stack(best_j), atol=ATOL)
    return mean_t.numpy(), np.stack(means_j)


def test_cartpole_plans_match_jax():
    """``CartPoleEnv/CEMAgent.json``'s sizes at gamma 1: integer returns, so
    the top candidates are chosen among ties."""
    config = json.loads((CONFIGS / "CartPoleEnv" / "CEMAgent.json").read_text())
    plan = dict(horizon=config["horizon"], iterations=config["iterations"],
                candidates=config["candidates"], top_candidates=config["top_candidates"],
                gamma=config["gamma"], action_size=1, discrete=True)
    B = 3
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(2).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    mean_t, mean_j = _plan_both(
        env_j, params_j, states, torch_cartpole.CartPoleEnv(max_episode_steps=200),
        from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        torch_cartpole.CartPoleState, plan, seeds=[0, 1, 2])
    np.testing.assert_array_equal(mean_t[:, :, 0] > 0.5, mean_j[:, :, 0] > 0.5)


@pytest.mark.parametrize("continuous", [False, True])
def test_highway_plans_match_jax(continuous):
    """``HighwayEnv/agents/CEMAgent/cem.json`` on the uncut highway env, and
    the same sizes over the continuous action space."""
    config = json.loads((CONFIGS / "HighwayEnv" / "agents" / "CEMAgent" / "cem.json").read_text())
    env_config = {"action": {"type": "ContinuousAction"}} if continuous else {}
    handle_j = jax_highway.make(env_config)
    handle_t = torch_highway.make(env_config, device="cpu")
    S = 2 if continuous else 1
    plan = dict(horizon=config["horizon"], iterations=config["iterations"],
                candidates=config["candidates"], top_candidates=config["top_candidates"],
                gamma=1.0, action_size=S, discrete=not continuous)
    states = jax.tree.map(lambda x: np.asarray(x)[None], handle_j.state)
    _plan_both(handle_j.functional, handle_j.params, states, handle_t.functional,
               handle_t.params, type(handle_t.state), plan, seeds=[4])


def test_refit_takes_the_lowest_indices_among_ties():
    rng = np.random.default_rng(0)
    returns = rng.integers(0, 4, (5, 40)).astype(np.float32)
    actions = rng.normal(size=(5, 40, 6, 2)).astype(np.float32)
    mean_t, std_t = refit(torch.tensor(actions), torch.tensor(returns), 7)
    for b in range(5):
        _, top = jax.lax.top_k(jnp.asarray(returns[b]), 7)
        best = jnp.asarray(actions[b])[top]
        np.testing.assert_allclose(mean_t[b].numpy(), np.asarray(best.mean(axis=0)), atol=ATOL)
        np.testing.assert_allclose(std_t[b].numpy(), np.asarray(best.std(axis=0)), atol=ATOL)
        order = torch.sort(torch.tensor(returns[b]), descending=True, stable=True).indices[:7]
        np.testing.assert_array_equal(order.numpy(), np.asarray(top))


def test_agent_plans_and_seeds():
    env = torch_factory.load_environment({"id": "cartpole", "max_episode_steps": 50}, device="cpu")
    agent = torch_factory.load_agent(str(CONFIGS / "CartPoleEnv" / "CEMAgent.json"), env,
                                     device="cpu")
    assert isinstance(agent, CEMAgent) and agent.discrete
    agent.seed(0)
    obs, _ = env.reset(seed=0)
    total = 0.0
    for _ in range(20):
        plan = agent.plan(obs)
        assert len(plan) == 12 and set(plan) <= {0, 1}
        obs, reward, done, truncated, _ = env.step(plan[0])
        total += reward
        if done or truncated:
            break
    assert total >= 15  # CEM keeps the pole up longer than a random policy


def test_latent_cem_matches_jax():
    """The two-model variant under the same draws (the JAX agent's key
    splits once per plan, then twice per iteration)."""
    config = {"horizon": 5, "iterations": 3, "candidates": 40, "top_candidates": 4}
    env = torch_factory.load_environment({"id": "cartpole"}, device="cpu")

    def transition_t(state, action, belief):
        return belief, state + 0.1 * action

    def reward_t(belief, state):
        return -(state ** 2).sum(dim=-1)

    def transition_j(state, action, belief):
        return belief, state + 0.1 * action

    def reward_j(belief, state):
        return -jnp.sum(state ** 2, axis=-1)

    jax_env = jax_cartpole.make({})
    agent_j = jcem.LatentCEMAgent(jax_env, dict(config), transition_model=transition_j,
                                  reward_model=reward_j)
    agent_j.seed(3)
    _, sub = jax.random.split(agent_j.key)
    want = agent_j.plan(np.zeros(1), np.ones(1))
    normals = []
    for _ in range(config["iterations"]):
        sub, ks = jax.random.split(sub)
        normals.append(np.asarray(jax.random.normal(ks, (40, 5, 1))))
    agent_t = LatentCEMAgent(env, dict(config), transition_model=transition_t,
                             reward_model=reward_t, device="cpu")
    got = agent_t.plan(np.zeros(1), np.ones(1), normals=np.stack(normals))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0] < 0  # it pushes the positive state toward zero


# ---------------------------------------------------------------------------
# The corpus configs that this slice's agents unblock
# ---------------------------------------------------------------------------

SLICE_CORPUS = [
    ("CartPoleEnv/CEMAgent.json", "CartPoleEnv/env.json", "CEMAgent"),
    ("HighwayEnv/agents/CEMAgent/cem.json", "HighwayEnv/env.json", "CEMAgent"),
    ("HighwayEnv/agents/PlaTyPOOSAgent/baseline.json", "HighwayEnv/env.json", "PlaTyPOOSAgent"),
    ("HighwayEnv/agents/MCTSAgent/closed_loop.json", "HighwayEnv/env.json", "MCTSAgent"),
    ("FiniteMDPEnv/agents/sparse_sampling.json", "FiniteMDPEnv/env_garnet.json",
     "SparseSamplingAgent"),
    ("SailingEnv/agents/brue.json", "SailingEnv/env.json", "BRUEAgent"),
]


@pytest.mark.parametrize("agent_file,env_file,name", SLICE_CORPUS)
def test_slice_corpus_config_constructs(agent_file, env_file, name):
    env = torch_factory.load_environment(CONFIGS / env_file, device="cpu")
    agent = torch_factory.load_agent(CONFIGS / agent_file, env, device="cpu")
    assert type(agent).__name__ == name
    if name == "MCTSAgent":
        assert agent.config["closed_loop"]
