"""The port's sharded fused actor-learner against the JAX package's
``make_sharded_actor_learner``, with every draw injected per shard.

JAX draws a step's randomness shard by shard: ``split(keys[s], 6)`` gives
the random actions, the epsilon tests, the env steps, the resets, the
minibatch indices and the next key (``parallel/actor_learner.py:391-392``).
The test replays that chain with ``jax.random`` and hands the same numbers
to the port as a ``SegmentDraws`` with a shard axis. At S = 4 shards of E = 2
envs, rings of C = 64, B = 4 rows a shard and learning from 8 rows, the
rings, actions, rewards, counters and the EMA must be equal, the states
within ``STATE_TOL`` and the parameters within ``PARAM_ATOL``, as in
``tests/test_torch_actor_learner.py``: CartPole with a (64, 64) MLP for 30
steps and a narrow EgoAttentionNetwork on highway (6 vehicles, 3 lanes, as
in ``__graft_entry__.py::dryrun_multichip``) for 8. JAX runs on a 2-host x
2-device pod mesh of the virtual CPU devices; the port runs at world size 1
with no group, at world size 1 and 2 on gloo (two processes, two shards
each), and tensor-parallel at dp 1 x tp 2, which must give the replicated
run's parameters within 1e-5."""
import os
import subprocess
import sys
import textwrap
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.envs.cartpole import CartPoleEnv as TorchCartPole
from rl_agents_torch.envs.highway import HighwayEnv as TorchHighway
from rl_agents_torch.models.optimizers import optimizer_factory
from rl_agents_torch.models.zoo import EgoAttentionNetwork as TorchEgo
from rl_agents_torch.models.zoo import MultiLayerPerceptron as TorchMLP
from rl_agents_torch.parallel.actor_learner import SegmentDraws, make_sharded_actor_learner

torch.set_num_threads(1)

# JAX is imported by the JAX-side helpers only: the gloo workers import this
# module for its port-side helpers and run no JAX

REPO = Path(__file__).resolve().parent.parent
S, E, C, B = 4, 2, 64, 4
LEARNER = dict(num_shards=S, envs_per_shard=E, capacity=C, batch_size=B, learning_starts=8,
               eps_tau=20.0, target_update=4)
PARAM_ATOL = 1e-6
STATE_TOL = dict(rtol=1e-6, atol=1e-6)  # as tests/test_torch_actor_learner.py: folded constants
TP_ATOL = 1e-5
EGO = dict(out=5, embedding_layers=(16,), others_embedding_layers=(16,), output_layers=(16,),
           feature_size=16, heads=2)
CASES = {"cartpole": 30, "highway": 8}


def _torch_env(case):
    if case == "cartpole":
        return TorchCartPole(max_episode_steps=50)
    return TorchHighway(vehicles=6, lanes=3, max_episode_steps=20)


def _torch_model(case, obs_shape):
    if case == "cartpole":
        return TorchMLP(4, (64, 64), out=2)
    return TorchEgo(obs_shape[-1], **EGO)


def _jax_env_and_model(case):
    from rl_agents_tpu.envs.cartpole import CartPoleEnv
    from rl_agents_tpu.envs.highway import HighwayEnv
    from rl_agents_tpu.models import EgoAttentionNetwork, MultiLayerPerceptron

    if case == "cartpole":
        return CartPoleEnv(max_episode_steps=50), MultiLayerPerceptron(layers=(64, 64), out=2)
    return HighwayEnv(vehicles=6, lanes=3, max_episode_steps=20), EgoAttentionNetwork(**EGO)


def _reset_noise(case, env, keys):
    """The port's reset noise for JAX's reset keys ``[..., 2]``."""
    import jax

    flat = keys.reshape(-1, 2)
    if case == "cartpole":
        _, obs = jax.vmap(env.reset, in_axes=(None, 0))(env.default_params(), flat)
        return np.asarray(obs).reshape(keys.shape[:-1] + (4,))
    parts = [jax.vmap(lambda k: jax.random.split(k, 3)[i])(flat) for i in range(3)]
    spacing = jax.vmap(lambda k: jax.random.uniform(k, (env.vehicles,)))(parts[0])
    lane = jax.vmap(lambda k: jax.random.randint(k, (env.vehicles,), 0, env.lanes))(parts[1])
    speed = jax.vmap(lambda k: jax.random.uniform(k, (env.vehicles,)))(parts[2])
    shape = keys.shape[:-1] + (env.vehicles,)
    return tuple(np.asarray(x).reshape(shape) for x in (spacing, lane, speed))


def _jax_draws(case, env, keys, steps, num_actions):
    """The draws of ``steps`` JAX steps from the per-shard keys ``[S, 2]``."""
    import jax

    explore, actions, resets, samples = [], [], [], []
    size = 0
    for _ in range(steps):
        subkeys = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
        ka, kr, ks, kb, km, keys = (subkeys[:, i] for i in range(6))
        actions.append(np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (E,), 0, num_actions))(ka)))
        explore.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (E,)))(kr)))
        resets.append(_reset_noise(case, env, jax.vmap(lambda k: jax.random.split(k, E))(kb)))
        size = min(size + E, C)
        samples.append(np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (B,), 0, max(size, 1)))(km)))
    reset = np.stack(resets) if case == "cartpole" else tuple(np.stack(r) for r in zip(*resets))
    return dict(explore=np.stack(explore), random_actions=np.stack(actions), reset=reset,
                sample=np.stack(samples))


@lru_cache(maxsize=None)
def _jax_run(case):
    """JAX's sharded learner on a (host=2, dp=2) pod mesh; returns the
    inputs the port needs (as numpy) and JAX's final state."""
    import jax
    import optax

    from rl_agents_tpu.parallel.actor_learner import make_sharded_actor_learner as jax_sharded
    from rl_agents_tpu.parallel.distributed import make_pod_mesh

    env_j, model_j = _jax_env_and_model(case)
    mesh = make_pod_mesh(axes=("host", "dp"), hosts=2, devices=jax.devices()[:4])
    init_j, segment_j, _ = jax_sharded(env_j, model_j, optax.adam(5e-4), mesh, **LEARNER)
    key = jax.random.PRNGKey(0 if case == "cartpole" else 1)
    state = init_j(key)
    _, _, ke = jax.random.split(key, 3)
    # copies: the segment donates the state, and np.asarray may alias its buffers
    inputs = dict(params=jax.tree.map(np.array, state.params),
                  reset0=_reset_noise(case, env_j, jax.random.split(ke, S * E).reshape(S, E, 2)),
                  draws=_jax_draws(case, env_j, state.keys, CASES[case],
                                   env_j.action_space.n))
    state, reward = segment_j(state, steps=CASES[case])
    return inputs, jax.tree.map(np.asarray, state), float(reward)


def _tensor(x):
    if isinstance(x, tuple):
        return tuple(_tensor(v) for v in x)
    return torch.tensor(x, dtype=torch.int64 if np.issubdtype(x.dtype, np.integer) else None)


def _rows(x, lo, hi, axis):
    if isinstance(x, tuple):
        return tuple(_rows(v, lo, hi, axis) for v in x)
    return x[(slice(None),) * axis + (slice(lo, hi),)]


def port_run(case, inputs, mesh=None, shards=(0, S), tp=False):
    """The port's learner over shards ``shards`` of the JAX inputs; returns
    the state, the mean reward and the model."""
    env_t = _torch_env(case)
    model_t = _torch_model(case, env_t.observation_space.shape)
    flax_params_to_torch(model_t, inputs["params"])
    lo, hi = shards
    draws = {k: _rows(v, lo, hi, 1) for k, v in inputs["draws"].items()}
    draws = SegmentDraws(*(_tensor(draws[f]) for f in SegmentDraws._fields))
    init_fn, segment_fn, shardings_fn = make_sharded_actor_learner(
        env_t, model_t, optimizer_factory("ADAM", lr=5e-4), mesh, tp=tp, device="cpu",
        **LEARNER)
    state = init_fn(torch.Generator().manual_seed(0), params=dict(model_t.named_parameters()),
                    reset_noise=_tensor(_rows(inputs["reset0"], lo, hi, 0)))
    state, reward = segment_fn(state, steps=CASES[case], draws=draws)
    return state, float(reward), model_t, shardings_fn


def _sorted_leaves(tree):
    """The leaves of a nest of dicts in ``jax.tree_util``'s order (sorted keys)."""
    if isinstance(tree, dict) or hasattr(tree, "keys"):
        return [x for k in sorted(tree.keys()) for x in _sorted_leaves(tree[k])]
    return [np.array(tree)]  # a copy: torch_params_to_flax's arrays alias the model


def flax_params(params_t, model_t):
    with torch.no_grad():
        for name, p in model_t.named_parameters():
            p.copy_(params_t[name])
    return _sorted_leaves(torch_params_to_flax(model_t))


def host_state(state, model_t):
    """The port's state as numpy arrays, in JAX's layout."""
    buf = state.buffer
    return dict(action=buf.action.numpy(), reward=buf.reward.numpy(),
                terminal=buf.terminal.numpy(), state=buf.state.numpy(),
                next_state=buf.next_state.numpy(), obs=state.obs.numpy(),
                episode_return=state.episode_return.numpy(),
                counters=[int(state.position), int(state.size), int(state.time),
                          int(state.completed_count), int(state.opt_state["count"])],
                completed_return=float(state.completed_return),
                params=flax_params(state.params, model_t),
                target=flax_params(state.target_params, model_t))


def check(case, got, state_j, reward_j, reward_t):
    """The discipline of tests/test_torch_actor_learner.py::_check. On
    highway JAX's fused program folds the reward's constants (its params are
    built inside the jitted step), so its rewards differ from the port's by
    an ulp (22 of 256 ring entries, 5.96e-08): they, the running returns and
    the EMA are held within ``STATE_TOL`` there (ROADMAP.md §3)."""
    buf_j = state_j.buffer
    for field in ("action", "terminal"):
        np.testing.assert_array_equal(got[field], getattr(buf_j, field), err_msg=field)
    for field in ("state", "next_state"):
        np.testing.assert_allclose(got[field], getattr(buf_j, field), **STATE_TOL)
    np.testing.assert_allclose(got["obs"], state_j.obs, **STATE_TOL)
    assert got["counters"] == [int(state_j.position), int(state_j.size), int(state_j.time),
                               int(state_j.completed_count), int(state_j.opt_state[0].count)]
    if case == "cartpole":
        np.testing.assert_array_equal(got["reward"], buf_j.reward)
        np.testing.assert_array_equal(got["episode_return"], state_j.episode_return)
        assert got["completed_return"] == float(state_j.completed_return)
    else:
        np.testing.assert_allclose(got["reward"], buf_j.reward, **STATE_TOL)
        np.testing.assert_allclose(got["episode_return"], state_j.episode_return, **STATE_TOL)
        assert got["completed_return"] == pytest.approx(float(state_j.completed_return),
                                                        rel=1e-6, abs=1e-6)
    assert reward_t == pytest.approx(reward_j, abs=1e-6)
    for ported, reference in ((got["params"], state_j.params),
                              (got["target"], state_j.target_params)):
        for a, b in zip(ported, _sorted_leaves(reference)):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_equals_jax(case):
    inputs, state_j, reward_j = _jax_run(case)
    state, reward, model_t, _ = port_run(case, inputs)
    assert int(state.completed_count) > 0 or case == "highway"
    assert int(state.opt_state["count"]) == CASES[case] - 8 // E + 1
    check(case, host_state(state, model_t), state_j, reward_j, reward)


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    torch.set_num_threads(1)
    from rl_agents_torch.parallel.distributed import make_pod_mesh, maybe_initialize_distributed
    from rl_agents_torch.parallel.mesh import make_mesh
    from rl_agents_torch.trainer.checkpoint import load_pytree, save_pytree
    import test_torch_sharded_actor_learner as t

    rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert maybe_initialize_distributed("file://" + out + "/store", world, rank)
    results = {{}}
    for case in {cases!r}:
        inputs = np.load(out + f"/{{case}}.npy", allow_pickle=True).item()
        if {tp!r}:
            mesh = make_mesh(axes=("dp", "tp"), shape=(1, world))
            shards = (0, t.S)
        else:
            mesh = make_pod_mesh(axes=("host", "dp"), hosts=1)
            shards = (rank * t.S // world, (rank + 1) * t.S // world)
        state, reward, model, shardings_fn = t.port_run(case, inputs, mesh, shards, {tp!r})
        if {tp!r}:  # the tp shards gathered whole
            state = state._replace(**{{k: {{n: v.full_tensor() for n, v in getattr(state, k).items()}}
                                       for k in ("params", "target_params")}})
        else:
            path = out + f"/{{case}}-checkpoint"
            save_pytree(path, state, shardings_fn(state))
            restored = load_pytree(path, template=state)
            for a, b in zip(t.leaves(state), t.leaves(restored)):
                assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
        got = t.host_state(state, model)
        got["params"] = [np.asarray(p) for p in got["params"]]
        got["target"] = [np.asarray(p) for p in got["target"]]
        results[case] = dict(got, mean_reward=reward)
    np.save(out + f"/rank{{rank}}.npy", results, allow_pickle=True)
    dist.destroy_process_group()
""")


def leaves(tree):
    """The tensors and generator states of a nest, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def spawn(tmp_path, world, cases, tp=False):
    """Run the port in ``world`` gloo processes; returns each rank's results."""
    for case in cases:
        np.save(tmp_path / f"{case}.npy", _jax_run(case)[0], allow_pickle=True)
    code = _WORKER.format(repo=str(REPO), tests=str(REPO / "tests"), cases=tuple(cases), tp=tp)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_SIZE",
                                                                    "RANK", "LOCAL_"))}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}\n{err[-4000:]}"
    return [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).item() for r in range(world)]


def test_two_ranks_equal_jax_and_the_checkpoint_round_trips(tmp_path):
    """World size 2 on gloo, two shards a rank: the concatenated rows equal
    JAX's, the replicated parameters agree on both ranks and with JAX, and
    each rank's state saved with ``save_pytree`` (its rows in
    ``rank-{r}.pt``) restores equal."""
    ranks = spawn(tmp_path, 2, sorted(CASES))
    for case in sorted(CASES):
        _, state_j, reward_j = _jax_run(case)
        got = dict(ranks[0][case])
        for field in ("action", "reward", "terminal", "state", "next_state", "obs",
                      "episode_return"):
            got[field] = np.concatenate([r[case][field] for r in ranks])
        for a, b in zip(ranks[0][case]["params"], ranks[1][case]["params"]):
            np.testing.assert_array_equal(a, b)
        assert ranks[0][case]["completed_return"] == ranks[1][case]["completed_return"]
        check(case, got, state_j, reward_j, got["mean_reward"])
    assert (tmp_path / "cartpole-checkpoint" / "rank-1.pt").is_file()


def test_tensor_parallel_equals_replicated(tmp_path):
    """dp 1 x tp 2 on gloo: the MLP's weights and biases shard over tp, and
    after the same 30 steps the parameters are the replicated run's within
    1e-5."""
    inputs, _, _ = _jax_run("cartpole")
    state, _, model_t, _ = port_run("cartpole", inputs)
    want = host_state(state, model_t)
    ranks = spawn(tmp_path, 2, ["cartpole"], tp=True)
    for rank in ranks:
        got = rank["cartpole"]
        for field in ("action", "reward", "terminal"):
            np.testing.assert_array_equal(got[field], want[field])
        assert got["counters"] == want["counters"]
        for key in ("params", "target"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_allclose(a, b, rtol=0, atol=TP_ATOL)




def test_the_sharded_learner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_actor_learner(TorchCartPole(), TorchMLP(4, (8,), out=2),
                                   optimizer_factory("ADAM"), num_shards=2)
