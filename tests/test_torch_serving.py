"""Policy export and serving of the port (``rl_agents_torch/serving.py``)
against the agent and against the JAX package's exported policy.

The DQN greedy policy (an MLP on CartPole and an EgoAttentionNetwork on
highway, the sizes of ``tests/test_serving.py``) is exported with a symbolic
batch, saved and loaded with ``torch`` alone; at batch 1, 7 and 64 its
actions equal the agent's greedy actions and its Q values the agent's within
1e-6, and on JAX's weights (carried by ``convert``) it matches JAX's own
exported policy within 1e-5. An MCTS plan batch on CartPole (16 trees, 6
episodes, horizon 4: ``tests/test_serving.py:78-115``) over env-state
NamedTuples exports and returns the same plans when served."""
import jax
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.dqn.agent import q_values
from rl_agents_torch.agents.tree_search.mcts import mcts_plan_batch
from rl_agents_torch.convert import flax_params_to_torch
from rl_agents_torch.envs.cartpole import CartPoleEnv
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.serving import load_policy, register_pytree_serialization, save_policy
from rl_agents_tpu.agents.dqn.agent import DQNAgent as JaxDQNAgent
from rl_agents_tpu.envs.cartpole import make as make_jax_cartpole
from rl_agents_tpu.envs.highway import make as make_jax_highway
from rl_agents_tpu.serving import load_policy as jax_load_policy
from rl_agents_tpu.serving import save_policy as jax_save_policy

torch.set_num_threads(1)

Q_ATOL = 1e-6
JAX_ATOL = 1e-5
EGO_MODEL = {"type": "EgoAttentionNetwork", "embedding_layer": {"layers": [32, 32]},
             "others_embedding_layer": {"layers": [32, 32]},
             "attention_layer": {"feature_size": 32, "heads": 2},
             "output_layer": {"layers": [32]}}
CASES = {
    "mlp": ({"id": "cartpole"}, {"type": "MultiLayerPerceptron", "layers": [16, 16]}),
    "ego_attention": ({"id": "highway-v0", "vehicles_count": 8, "lanes_count": 3}, EGO_MODEL),
}


def _agent(case):
    env_config, model = CASES[case]
    env = load_environment(env_config, device="cpu")
    agent = load_agent({"__class__": "DQNAgent", "model": model}, env, device="cpu")
    agent.seed(0)
    return env, agent


def _observations(env, batch, seed):
    """Observations from ``batch`` seeded resets (the highway's presence
    flags included), as float32 numpy."""
    return np.stack([np.asarray(env.reset(seed=seed + i)[0], np.float32)
                     for i in range(batch)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_policy_serves_the_agents_greedy_actions(case, tmp_path):
    env, agent = _agent(case)
    policy = load_policy(save_policy(agent, tmp_path / "policy.pt2"))
    agent.eval()
    for batch in (1, 7, 64):
        obs = _observations(env, batch, seed=10 * batch)
        actions, q = policy(obs)
        assert actions.shape == (batch,) and q.shape == (batch, env.action_space.n)
        with torch.no_grad():
            want = q_values(agent.model, agent.train_state.params, torch.tensor(obs))
        np.testing.assert_allclose(q.numpy(), want.numpy(), rtol=0, atol=Q_ATOL)
        np.testing.assert_array_equal(actions.numpy(), want.argmax(dim=1).numpy())
        assert [agent.act(o) for o in obs[:3]] == actions[:3].tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_policy_matches_jaxs_on_the_same_weights(case, tmp_path):
    env_config, model = CASES[case]
    env_j = make_jax_cartpole({}) if case == "mlp" else \
        make_jax_highway({"vehicles_count": 8, "lanes_count": 3})
    agent_j = JaxDQNAgent(env_j, {"model": model})
    agent_j.seed(0)
    env, agent = _agent(case)
    flax_params_to_torch(agent.model, jax.tree.map(np.asarray, agent_j.train_state.params))
    agent.train_state = agent.train_state._replace(
        params={k: v.detach().clone() for k, v in agent.model.named_parameters()})
    ours = load_policy(save_policy(agent, tmp_path / "policy.pt2"))
    theirs = jax_load_policy(jax_save_policy(agent_j, tmp_path / "policy.stablehlo"))
    obs = _observations(env, 7, seed=3)
    actions, q = ours(obs)
    actions_j, q_j = theirs(obs)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=0, atol=JAX_ATOL)
    np.testing.assert_array_equal(actions.numpy(), np.asarray(actions_j))


def test_mcts_plan_batch_exports_and_serves_the_same_plans(tmp_path):
    env = CartPoleEnv(max_episode_steps=200)
    params = env.default_params("cpu")
    probs = torch.ones(2) / 2
    trees, episodes, horizon = 16, 6, 4
    generator = torch.Generator().manual_seed(0)
    states, _ = env.reset(params, generator, trees)
    noise = -torch.log(-torch.log(torch.rand((episodes, horizon, 2, 2, trees),
                                             generator=generator)))

    class Plan(torch.nn.Module):
        def forward(self, states, noise):
            actions, lengths, _ = mcts_plan_batch(env, params, states, None, probs, probs, 2,
                                                  episodes, horizon, 0.95, 40.0, noise=noise,
                                                  device="cpu")
            return actions, lengths

    direct = Plan()(states, noise)
    register_pytree_serialization(states)
    torch.export.save(torch.export.export(Plan(), (states, noise), strict=False),
                      tmp_path / "planner.pt2")
    # check_guards=False: torch writes the guard on ``states.x_dot``'s size
    # as ``args[0]_dot`` (it rewrites the prefix ``states.x``), which does
    # not parse; the program itself is checked against the direct plans
    served = torch.export.load(tmp_path / "planner.pt2").module(check_guards=False)
    for got, want in zip(served(states, noise), direct):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_namedtuple_registration_is_idempotent_and_refuses_a_conflict():
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    pair = Pair(torch.zeros(1), torch.ones(1))
    register_pytree_serialization(pair, [pair], {"p": pair})
    register_pytree_serialization(pair)  # the same name again: nothing to do
    import torch.utils._pytree as pytree

    assert pytree.SUPPORTED_SERIALIZED_TYPES[Pair].serialized_type_name.endswith("Pair")

    class Other(NamedTuple):
        x: torch.Tensor

    pytree._register_namedtuple(Other, serialized_type_name="elsewhere.Other")
    with pytest.raises(ValueError, match="elsewhere.Other"):
        register_pytree_serialization(Other(torch.zeros(1)))
