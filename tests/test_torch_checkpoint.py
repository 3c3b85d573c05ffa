"""The port's checkpoint store (``rl_agents_torch/trainer/checkpoint.py``):
round trips of nests of tensors, NamedTuples and generators, retention of
the last k steps, overwrites, ``FileNotFoundError`` on an empty or missing
store, the atomic write, the DQN agent's ``"checkpoint_format": "orbax"``
path against the JAX agent's, and the fused learners' whole states (the
sharded one at world size 2 is held in
``tests/test_torch_sharded_actor_learner.py``)."""
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.dqn.replay import Batch
from rl_agents_torch.envs.cartpole import CartPoleEnv
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.models.optimizers import optimizer_factory
from rl_agents_torch.models.zoo import MultiLayerPerceptron
from rl_agents_torch.parallel.actor_learner import make_actor_learner, make_sharded_actor_learner
from rl_agents_torch.trainer.checkpoint import CheckpointStore, load_pytree, save_pytree
from rl_agents_tpu.agents.dqn.agent import DQNAgent as JaxDQNAgent
from rl_agents_tpu.envs.cartpole import make as make_jax_cartpole

torch.set_num_threads(1)


def _tree():
    generator = torch.Generator().manual_seed(5)
    torch.rand(3, generator=generator)
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.zeros(4, dtype=torch.float64)},
            "opt_state": {"count": torch.tensor(7), "mu": [torch.ones(2), torch.full((2,), 3.0)]},
            "batch": Batch(torch.ones(2, 4), torch.tensor([0, 1]), torch.tensor([1.0, 0.5]),
                           torch.zeros(2, 4), torch.tensor([True, False])),
            "generator": generator, "meta": ("name", 3, 0.5, None, True)}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_round_trip_with_and_without_a_template(tmp_path):
    tree = _tree()
    store = CheckpointStore(tmp_path / "ckpt")
    store.save(0, tree)
    _same(tree, store.restore())  # no template: tensors on the CPU, types rebuilt
    template = _tree()
    template["params"]["w"] = torch.zeros(3, 4, dtype=torch.float64)  # restore as float64
    template["generator"] = torch.Generator()
    restored = store.restore(template=template)
    assert restored["params"]["w"].dtype == torch.float64
    assert restored["generator"] is template["generator"]
    assert torch.equal(torch.rand(4, generator=restored["generator"]),
                       torch.rand(4, generator=tree["generator"]))
    store.close()


def test_retention_keeps_the_last_k(tmp_path):
    store = CheckpointStore(tmp_path / "ckpt", max_to_keep=3)
    for step in range(6):
        store.save(step, {"w": torch.full((4,), float(step))})
    assert store.all_steps() == [3, 4, 5] and store.latest_step() == 5
    assert torch.equal(store.restore()["w"], torch.full((4,), 5.0))
    assert torch.equal(store.restore(step=3)["w"], torch.full((4,), 3.0))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4", "5"]


def test_overwrite_and_missing_checkpoints(tmp_path):
    save_pytree(tmp_path / "latest", {"w": torch.zeros(3)})
    save_pytree(tmp_path / "latest", {"w": torch.full((3,), 9.0)})
    assert torch.equal(load_pytree(tmp_path / "latest")["w"], torch.full((3,), 9.0))
    with pytest.raises(FileNotFoundError):
        load_pytree(tmp_path / "absent")
    assert not (tmp_path / "absent").exists()  # nothing written on the way
    with pytest.raises(FileNotFoundError):
        CheckpointStore(tmp_path / "empty").restore()
    store = CheckpointStore(tmp_path / "ckpt")
    store.save(1, {"w": torch.ones(2)})
    store.save(1, {"w": torch.full((2,), 2.0)})  # the same step again replaces it
    assert store.all_steps() == [1] and torch.equal(store.restore()["w"], torch.full((2,), 2.0))


def test_a_failed_save_leaves_the_last_checkpoint(tmp_path):
    save_pytree(tmp_path / "latest", {"w": torch.ones(2)})
    with pytest.raises(TypeError, match="object"):
        save_pytree(tmp_path / "latest", {"w": torch.zeros(2), "bad": object()})
    assert torch.equal(load_pytree(tmp_path / "latest")["w"], torch.ones(2))


def test_dqn_orbax_format_saves_a_pytree_directory_as_jax_does(tmp_path):
    config = {"__class__": "DQNAgent", "model": {"type": "MultiLayerPerceptron", "layers": [8]},
              "checkpoint_format": "orbax"}
    env = load_environment({"id": "cartpole"}, device="cpu")
    agent = load_agent(dict(config), env, device="cpu")
    agent.seed(0)
    q_before = agent.get_state_action_values(np.ones(4))
    path = agent.save(tmp_path / "model.tar")
    jax_path = JaxDQNAgent(make_jax_cartpole({}), dict(config)).save(tmp_path / "jax" / "model.tar")
    assert path == tmp_path / "model.orbax" and path.is_dir()
    assert path.name == jax_path.name and jax_path.is_dir()
    other = load_agent(dict(config), env, device="cpu")
    other.seed(1)
    other.initialize_model()
    assert not np.allclose(other.get_state_action_values(np.ones(4)), q_before)
    assert other.load(tmp_path / "model.tar") == tmp_path / "model.tar"
    np.testing.assert_array_equal(other.get_state_action_values(np.ones(4)), q_before)
    assert int(other.train_state.opt_state["count"]) == int(agent.train_state.opt_state["count"])


def test_fused_learner_state_resumes_as_the_uninterrupted_run(tmp_path):
    """The whole ``ActorLearnerState`` (params, optimizer, ring, env states,
    counters, generator) round-trips: a run restored from step 10 continues
    to step 20 as the uninterrupted run does."""
    kw = dict(num_envs=4, capacity=64, batch_size=8, learning_starts=8, device="cpu")

    def fresh():
        init_fn, segment_fn = make_actor_learner(CartPoleEnv(max_episode_steps=30),
                                                 MultiLayerPerceptron(4, (16,), out=2),
                                                 optimizer_factory("ADAM"), **kw)
        return init_fn(torch.Generator().manual_seed(0)), segment_fn

    state, segment_fn = fresh()
    segment_fn(state, steps=10)
    save_pytree(tmp_path / "state", state)
    segment_fn(state, steps=10)
    template, segment2 = fresh()
    restored = load_pytree(tmp_path / "state", template=template)
    assert int(restored.time) == 10
    segment2(restored, steps=10)
    _same(state, restored)


def test_sharded_learner_state_round_trips_at_world_one(tmp_path):
    init_fn, segment_fn, shardings_fn = make_sharded_actor_learner(
        CartPoleEnv(max_episode_steps=30), MultiLayerPerceptron(4, (16,), out=2),
        optimizer_factory("ADAM"), num_shards=2, envs_per_shard=2, capacity=16, batch_size=4,
        learning_starts=8, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    segment_fn(state, steps=6)
    store = CheckpointStore(tmp_path / "ckpt")
    store.save(6, state, shardings_fn(state))
    assert (tmp_path / "ckpt" / "6" / "rank-0.pt").is_file()  # this rank's rows
    template = init_fn(torch.Generator().manual_seed(1))
    _same(state, store.restore(template=template))
