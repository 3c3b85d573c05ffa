"""The PyTorch port's DQN (replay ring, n-step collapse, exploration, the
Bellman loss and its gradients, the train step and ``record``) against the
JAX package's, on the same inputs."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.dqn import exploration as torch_exploration
from rl_agents_torch.agents.dqn.agent import DQNAgent as TorchDQNAgent
from rl_agents_torch.agents.dqn.agent import loss_and_gradients
from rl_agents_torch.agents.dqn.replay import Batch as TorchBatch
from rl_agents_torch.agents.dqn.replay import ReplayMemory as TorchReplay
from rl_agents_torch.agents.dqn.replay import n_step_collapse as torch_collapse
from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_tpu.agents.dqn import exploration as jax_exploration
from rl_agents_tpu.agents.dqn.agent import make_train_step as jax_make_train_step
from rl_agents_tpu.agents.dqn.replay import Batch as JaxBatch
from rl_agents_tpu.agents.dqn.replay import ReplayMemory as JaxReplay
from rl_agents_tpu.agents.dqn.replay import n_step_collapse as jax_collapse
from rl_agents_tpu.envs.base import Discrete
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment
from rl_agents_tpu.models.optimizers import loss_function_factory as jax_loss
from rl_agents_tpu.models.optimizers import optimizer_factory as jax_optimizer

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
CARTPOLE_AGENT = {"__class__": "DQNAgent",
                  "model": {"type": "MultiLayerPerceptron", "layers": [32, 32]},
                  "batch_size": 16, "memory_capacity": 200, "target_update": 7,
                  "exploration": {"method": "EpsilonGreedy", "tau": 30}}


def _leaf_tree(params_t, agent_t):
    """A port parameter dict as JAX's tree of flax-layout arrays."""
    with torch.no_grad():
        for name, p in agent_t.model.named_parameters():
            p.copy_(params_t[name])
    return torch_params_to_flax(agent_t.model)


def _carry(agent_j, agent_t):
    """Give the port agent the JAX agent's parameters, target and a fresh
    optimizer state."""
    params = jax.tree.map(np.asarray, agent_j.train_state.params)
    flax_params_to_torch(agent_t.model, params)
    values = {k: v.detach().clone() for k, v in agent_t.model.named_parameters()}
    agent_t.train_state = agent_t.train_state._replace(
        params=values, target_params={k: v.clone() for k, v in values.items()},
        opt_state=agent_t.optimizer.init(list(values.values())))


def _assert_trees_close(tree_t, tree_j, rel=0.0, atol=0.0):
    """Leaf by leaf within ``atol + rel * (the leaf's largest entry)``."""
    leaves_t = jax.tree_util.tree_leaves(tree_t)
    leaves_j = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree_j))
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol + rel * np.max(np.abs(b)))


def test_ring_writes_and_wraps_like_jax():
    rng = np.random.default_rng(0)
    mem_j, mem_t = JaxReplay(5, (3,)), TorchReplay(5, (3,), device="cpu")
    for i in range(8):
        s, ns = rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)
        args = (s, i % 3, float(i) / 2, ns, i % 4 == 3)
        mem_j.push(*args)
        mem_t.push(*args)
        assert (mem_t.position, len(mem_t)) == (mem_j.position, len(mem_j))
    assert mem_t.position == 3 and mem_t.is_full()
    for field in JaxBatch._fields:
        np.testing.assert_array_equal(getattr(mem_t.data, field).numpy(),
                                      np.asarray(getattr(mem_j.data, field)))
    batch = mem_t.sample(4, indices=[4, 0, 2, 2])
    np.testing.assert_array_equal(batch.action.numpy(), np.asarray(mem_j.data.action)[[4, 0, 2, 2]])
    drawn = mem_t.sample(64)
    assert drawn.state.shape == (64, 3)
    state = mem_t.state_dict()
    fresh = TorchReplay(5, (3,), device="cpu")
    fresh.load_state_dict(state)
    assert torch.equal(fresh.data.state, mem_t.data.state) and fresh.position == 3


def test_replay_memory_follows_the_device_rule():
    """Like every entry point of the port, the replay memory defaults to the
    card and raises without one; ``device="cpu"`` keeps its ring on the CPU."""
    memory = TorchReplay(4, (2,), device="cpu")
    assert memory.device == torch.device("cpu")
    assert all(field.device.type == "cpu" for field in memory.data)
    memory.push(np.ones(2, np.float32), 1, 0.5, np.zeros(2, np.float32), False)
    assert memory.sample(3, indices=[0, 0, 0]).reward.tolist() == [0.5] * 3
    if torch.cuda.is_available():
        assert TorchReplay(4, (2,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            TorchReplay(4, (2,))


@pytest.mark.parametrize("stride", [1, 4])
def test_n_step_collapse_equals_jax(stride):
    rng = np.random.default_rng(stride)
    C = 64
    data = dict(state=rng.standard_normal((C, 2)).astype(np.float32),
                action=rng.integers(0, 3, C).astype(np.int32),
                reward=rng.standard_normal(C).astype(np.float32),
                next_state=rng.standard_normal((C, 2)).astype(np.float32),
                terminal=rng.random(C) < 0.2)
    start = rng.integers(0, 60, 32)
    for n, size in ((3, 60), (4, 37)):
        out_j = jax_collapse(JaxBatch(*(jnp.asarray(v) for v in data.values())),
                             jnp.asarray(start), size, n, jnp.float32(0.9), stride=stride)
        batch_t = TorchBatch(*(torch.tensor(v) for v in data.values()))
        out_t = torch_collapse(batch_t, torch.tensor(start), size, n, 0.9, stride=stride)
        for field in ("state", "action", "next_state", "terminal"):
            np.testing.assert_array_equal(getattr(out_t, field).numpy(),
                                          np.asarray(getattr(out_j, field)))
        np.testing.assert_allclose(out_t.reward.numpy(), np.asarray(out_j.reward), rtol=0, atol=1e-6)


@pytest.mark.parametrize("config", [{"method": "EpsilonGreedy", "tau": 20},
                                    {"method": "EpsilonGreedy", "temperature": 0.5,
                                     "final_temperature": 0.9},
                                    {"method": "Boltzmann", "temperature": 0.7},
                                    {"method": "Boltzmann", "temperature": 0.0},
                                    {"method": "Greedy"}])
def test_exploration_schedules_and_draws_equal_jax(config):
    policy_j = jax_exploration.exploration_factory(dict(config), Discrete(4))
    policy_t = torch_exploration.exploration_factory(dict(config), Discrete(4))
    policy_j.seed(11)
    policy_t.seed(11)
    rng = np.random.default_rng(0)
    for t in range(60):
        values = rng.standard_normal(4)
        for policy in (policy_j, policy_t):
            policy.step_time()
            policy.update(values)
        assert policy_t.get_distribution() == pytest.approx(policy_j.get_distribution())
        assert policy_t.sample() == policy_j.sample()
    if config["method"] == "EpsilonGreedy":
        assert policy_t.epsilon == policy_j.epsilon
        assert policy_t.config["final_temperature"] == min(config.get("temperature", 1.0),
                                                           config.get("final_temperature", 0.1))


def _fixed_batch(obs_shape, batch, num_actions, seed):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((batch,) + obs_shape).astype(np.float32)
    next_state = rng.standard_normal((batch,) + obs_shape).astype(np.float32)
    if len(obs_shape) == 2:  # entity observations: a presence column
        for x in (state, next_state):
            x[:, :, 0] = rng.random(x.shape[:2]) > 0.3
            x[:, 0, 0] = 1.0
    return dict(state=state, action=rng.integers(0, num_actions, batch).astype(np.int32),
                reward=rng.standard_normal(batch).astype(np.float32), next_state=next_state,
                terminal=rng.random(batch) < 0.25)


LOSS_CASES = [
    ("CartPoleEnv/env.json", {"type": "MultiLayerPerceptron", "layers": [32, 32]}, "l2"),
    ("HighwayEnv/env.json", {"type": "DuelingNetwork", "base_module": {"layers": [32]}},
     "smooth_l1"),
    ("HighwayEnv/env.json", json.loads((CONFIGS / "HighwayEnv/agents/DQNAgent/ego_attention.json")
                                       .read_text())["model"], "l2"),
]


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("env_path,model,loss", LOSS_CASES)
def test_loss_and_gradients_match_jax_value_and_grad(env_path, model, loss, double):
    config = {"__class__": "DQNAgent", "model": dict(model), "loss_function": loss,
              "double": double, "gamma": 0.9}
    env_j = jax_load_environment(CONFIGS / env_path)
    env_t = torch_load_environment(CONFIGS / env_path, device="cpu")
    agent_j = jax_load_agent(json.loads(json.dumps(config)), env_j)
    agent_t = torch_load_agent(json.loads(json.dumps(config)), env_t, device="cpu")
    _carry(agent_j, agent_t)
    # a target network distinct from the online one
    target = jax.tree.map(lambda p: p * 0.9 + 0.01, agent_j.train_state.params)
    target_t = _leaf_tree(agent_t.train_state.params, agent_t)  # for the names
    flax_params_to_torch(agent_t.model, jax.tree.map(np.asarray, target))
    target_t = {k: v.detach().clone() for k, v in agent_t.model.named_parameters()}
    data = _fixed_batch(agent_t.obs_shape, 32, env_t.action_space.n, seed=5)
    batch_j = JaxBatch(*(jnp.asarray(v) for v in data.values()))
    batch_t = TorchBatch(*(torch.tensor(v if k != "action" else v.astype(np.int64))
                           for k, v in data.items()))

    _, compute_loss = jax_make_train_step(agent_j.model, jax_optimizer("ADAM"), jax_loss(loss),
                                          0.9, double)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: compute_loss(p, target, batch_j))(agent_j.train_state.params)
    loss_t, grads_t = loss_and_gradients(agent_t.model, agent_t.loss_function,
                                         agent_t.train_state.params, target_t, batch_t, 0.9,
                                         double)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    grads_t = _leaf_tree(dict(zip(agent_t.train_state.params, grads_t)), agent_t)
    _assert_trees_close(grads_t, grads_j, rel=1e-5)
    assert float(agent_t.compute_loss(agent_t.train_state.params, target_t, batch_t)) == \
        pytest.approx(float(loss_j), rel=1e-5)


def test_one_train_step_matches_jax():
    env_j = jax_load_environment(CONFIGS / "HighwayEnv/env.json")
    env_t = torch_load_environment(CONFIGS / "HighwayEnv/env.json", device="cpu")
    config = load_agent_config(CONFIGS / "HighwayEnv/agents/DQNAgent/ego_attention.json")
    agent_j = jax_load_agent(json.loads(json.dumps(config)), env_j)
    agent_t = torch_load_agent(json.loads(json.dumps(config)), env_t, device="cpu")
    _carry(agent_j, agent_t)
    data = _fixed_batch(agent_t.obs_shape, 32, 5, seed=6)
    data["reward"] *= 30  # large residuals: some gradients are clipped to [-1, 1]
    batch_j = JaxBatch(*(jnp.asarray(v) for v in data.values()))
    batch_t = TorchBatch(*(torch.tensor(v if k != "action" else v.astype(np.int64))
                           for k, v in data.items()))
    state_j, loss_j = agent_j.train_step(agent_j.train_state, batch_j)
    state_t, loss_t = agent_t.train_step(agent_t.train_state, batch_t)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    # ADAM's first step is lr * g / (|g| + 1e-8): an entry whose gradient is
    # near 1e-8 turns rounding of g into a part of lr (6.3e-7 measured here)
    _assert_trees_close(_leaf_tree(state_t.params, agent_t), state_j.params, atol=1e-6)
    assert int(state_t.opt_state["count"]) == 1


def test_record_matches_jax_with_its_minibatch_indices():
    """50 steps of ``record`` on CartPole, fed the same transitions; the port
    samples at the indices the JAX agent's own key splits draw. Actions
    (through the shared exploration seed and the argmax of Q), the target
    sync steps and the parameters agree: the parameters within 1e-6 absolute
    (rounding of the gradients, about 1e-7 relative, carried through 35 ADAM
    steps of at most lr = 5e-4 each; the largest difference measured here
    is under 1e-7)."""
    env_j = jax_load_environment({"id": "cartpole"})
    env_t = torch_load_environment({"id": "cartpole"}, device="cpu")
    agent_j = jax_load_agent(json.loads(json.dumps(CARTPOLE_AGENT)), env_j)
    agent_t = torch_load_agent(json.loads(json.dumps(CARTPOLE_AGENT)), env_t, device="cpu")
    _carry(agent_j, agent_t)
    indices = []
    sample_j = agent_j.memory.sample

    def spy(key, batch_size):
        indices.append(np.asarray(jax.random.randint(key, (batch_size,), 0, agent_j.memory.size)))
        return sample_j(key, batch_size)

    agent_j.memory.sample = spy
    agent_j.seed(4)
    agent_t.seed(4)
    obs, _ = env_j.reset(seed=4)
    syncs_j, syncs_t = [], []
    for step in range(50):
        action = agent_j.act(obs)
        assert agent_t.act(obs) == action
        next_obs, reward, terminal, truncated, info = env_j.step(action)
        agent_j.record(obs, action, reward, next_obs, terminal, info)
        agent_t.record(obs, action, reward, next_obs, terminal, info,
                       indices=indices[-1] if len(agent_t.memory) + 1 >= 16 else None)
        # a sync step leaves the target equal to the parameters just updated
        state_j, state_t = agent_j.train_state, agent_t.train_state
        syncs_j.append(len(indices) > 0 and all(
            np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(state_j.params),
                                                 jax.tree_util.tree_leaves(state_j.target_params))))
        syncs_t.append(len(indices) > 0 and all(
            torch.equal(state_t.params[k], state_t.target_params[k]) for k in state_t.params))
        obs = env_j.reset()[0] if terminal or truncated else next_obs
    assert len(indices) == 35 and agent_t.steps == agent_j.steps == 35
    assert syncs_t == syncs_j and sum(syncs_t) == 5
    _assert_trees_close(_leaf_tree(agent_t.train_state.params, agent_t),
                        agent_j.train_state.params, atol=1e-6)
    _assert_trees_close(_leaf_tree(agent_t.train_state.target_params, agent_t),
                        agent_j.train_state.target_params, atol=1e-6)


def test_save_load_round_trip_and_greedy_eval(tmp_path):
    env = torch_load_environment({"id": "cartpole"}, device="cpu")
    agent = torch_load_agent(json.loads(json.dumps(CARTPOLE_AGENT)), env, device="cpu")
    obs, _ = env.reset(seed=0)
    for _ in range(30):
        action = agent.act(obs)
        next_obs, reward, terminal, truncated, info = env.step(action)
        agent.record(obs, action, reward, next_obs, terminal, info)
        obs = env.reset()[0] if terminal or truncated else next_obs
    agent.config["checkpoint_format"] = "orbax"  # as in JAX: a save_pytree directory
    path = agent.save(tmp_path / "model.tar")
    assert path == tmp_path / "model.orbax" and path.is_dir()
    other = torch_load_agent(json.loads(json.dumps(CARTPOLE_AGENT)), env, device="cpu")
    other.initialize_model()
    other.load(path)
    for a, b in ((agent.train_state.params, other.train_state.params),
                 (agent.train_state.target_params, other.train_state.target_params),
                 (agent.train_state.opt_state["mu"], other.train_state.opt_state["mu"])):
        items = zip(a.values(), b.values()) if isinstance(a, dict) else zip(a, b)
        assert all(torch.equal(x, y) for x, y in items)
    assert int(other.train_state.opt_state["count"]) == 15
    other.eval()
    assert isinstance(other.exploration_policy, torch_exploration.Greedy)
    values = other.get_state_action_values(obs)
    assert other.act(obs) == int(np.argmax(values))
    assert other.action_distribution(obs)[int(np.argmax(values))] == 1.0
    before = len(other.memory)
    other.record(obs, 0, 1.0, obs, False, {})
    assert len(other.memory) == before  # no learning in eval mode


def test_multi_agent_record_pushes_one_row_per_ego():
    env = torch_load_environment(CONFIGS / "IntersectionEnv/env_multi_agent.json", device="cpu")
    config = load_agent_config(CONFIGS / "IntersectionEnv/agents/DQNAgent/ego_attention.json")
    config.update(batch_size=6, memory_capacity=64)
    agent = torch_load_agent(config, env, device="cpu")
    obs, _ = env.reset(seed=0)
    assert isinstance(obs, tuple) and len(obs) == 4
    first = np.stack(obs)
    for _ in range(3):
        actions = agent.act(obs)
        assert isinstance(actions, tuple) and len(actions) == 4
        next_obs, reward, terminal, truncated, info = env.step(actions)
        agent.record(obs, actions, reward, next_obs, terminal, info)
        obs = next_obs
    assert len(agent.memory) == 12 and agent.steps == 2  # learning from the 6th row
    np.testing.assert_array_equal(agent.memory.data.state[:4].numpy(), first)


def test_dqn_agent_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    env = torch_load_environment({"id": "cartpole"}, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_load_agent(json.loads(json.dumps(CARTPOLE_AGENT)), env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDQNAgent(env, json.loads(json.dumps(CARTPOLE_AGENT)))
