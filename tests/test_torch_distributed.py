"""The port's ``torch.distributed`` layer (``rl_agents_torch/parallel/
{distributed,mesh}.py``) against the JAX package's multi-host tests.

The pod-mesh topology and its errors are ``tests/test_multihost.py:34-66``'s,
on an 8-rank group of torch's in-process fake backend. On a one-rank gloo
group (a file store, so that pytest-xdist's workers never share a port) the
collectives run and must change nothing: the sharded learner equals the
no-group program exactly. Two gloo processes bootstrap from the
environment's ``WORLD_SIZE`` and ``RANK`` as ``tests/test_multiprocess_
bootstrap.py`` does, build a host-major mesh, take a sharded DQN train step
(each rank half the batch) that equals one single-process step on the whole
batch within 1e-5 and JAX's step on the same weights within 1e-5, and plan
sharded OPD and KL-OLOP batches whose actions equal the unsharded plans'."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rl_agents_torch.agents.dqn.replay import Batch
from rl_agents_torch.agents.tree_search.batch import olop_plan_batch
from rl_agents_torch.agents.tree_search.deterministic import opd_plan_batch
from rl_agents_torch.envs.cartpole import CartPoleEnv
from rl_agents_torch.models.optimizers import optimizer_factory
from rl_agents_torch.models.zoo import MultiLayerPerceptron
from rl_agents_torch.parallel.actor_learner import make_sharded_actor_learner
from rl_agents_torch.parallel.distributed import (
    data_axes,
    make_pod_mesh,
    maybe_initialize_distributed,
    pod_shape,
)
from rl_agents_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    mlp_param_spec,
    shard_batch,
    sharded_planner_batch,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STEP_ATOL = 1e-5
TREES = 16
OPD = dict(num_actions=2, expansions=5, gamma=0.9, plan_capacity=8)
OLOP = dict(num_actions=2, episodes=6, horizon=3, gamma=0.9, threshold_coeff=4.0)


@pytest.fixture
def group(tmp_path):
    """A process group in this process, destroyed at the end of the test."""
    def init(backend="gloo", world=1):
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp_path}/store", rank=0,
                                    world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_pod_mesh_topology(group):
    group("fake", world=8)
    mesh = make_pod_mesh(axes=("host", "dp"), hosts=2)
    assert mesh.mesh_dim_names == ("host", "dp") and tuple(mesh.shape) == (2, 4)
    assert mesh.mesh.reshape(-1).tolist() == list(range(8))  # host-major
    mesh3 = make_pod_mesh(axes=("host", "dp", "tp"), hosts=2, local_shape=(2, 2))
    assert tuple(mesh3.shape) == (2, 2, 2) and data_axes(mesh3) == ("host", "dp")
    assert make_mesh().mesh_dim_names == ("dp", "tp") and tuple(make_mesh().shape) == (8, 1)


def test_pod_mesh_errors(group):
    group("fake", world=8)
    with pytest.raises(ValueError):
        make_pod_mesh(axes=("host", "dp"), hosts=3)  # 8 % 3 != 0
    with pytest.raises(ValueError):
        make_pod_mesh(axes=("host", "dp", "tp"), hosts=2, local_shape=(3, 1))
    assert pod_shape(8, 3, 2, (2, 2)) == (2, 2, 2)
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        make_pod_mesh()


def test_maybe_initialize_distributed_is_a_no_op_alone(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed() is False and not dist.is_initialized()
    assert maybe_initialize_distributed("localhost:1", 1, 0) is False


def test_mlp_param_spec_shards_output_dims_that_divide(group):
    group("fake", world=2)
    mesh = make_mesh(axes=("dp", "tp"), shape=(1, 2))
    model = MultiLayerPerceptron(4, (8, 6), out=3)
    spec = mlp_param_spec(dict(model.named_parameters()), mesh=mesh)
    assert [type(p).__name__ for p in spec.values()] == [
        "Shard", "Shard", "Shard", "Shard", "Replicate", "Replicate"]


def _learner(mesh=None):
    return make_sharded_actor_learner(
        CartPoleEnv(max_episode_steps=30), MultiLayerPerceptron(4, (16,), out=2),
        optimizer_factory("ADAM"), mesh, num_shards=2, envs_per_shard=2, capacity=32,
        batch_size=4, learning_starts=8, device="cpu")


def test_one_rank_group_runs_the_collectives_and_changes_nothing(group, monkeypatch):
    init_fn, segment_fn, _ = _learner()
    alone = init_fn(torch.Generator().manual_seed(3))
    segment_fn(alone, steps=12)
    group("gloo", world=1)
    mesh = make_pod_mesh(axes=("host", "dp"), hosts=1)
    calls = []
    reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: calls.append(1) or reduce(t, **kw))
    init_fn, segment_fn, _ = _learner(mesh)
    grouped = init_fn(torch.Generator().manual_seed(3))
    segment_fn(grouped, steps=12)
    assert len(calls) == 2 * 12  # the statistics and the gradients, every step
    for a, b in zip(alone.params.values(), grouped.params.values()):
        assert torch.equal(a, b)
    for a, b in zip(alone.buffer, grouped.buffer):
        assert torch.equal(a, b)
    assert float(alone.completed_return) == float(grouped.completed_return)


def example_batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return Batch(state=torch.tensor(rng.random((n, 4)), dtype=torch.float32),
                 action=torch.tensor(rng.integers(0, 2, n)),
                 reward=torch.tensor(rng.random(n), dtype=torch.float32),
                 next_state=torch.tensor(rng.random((n, 4)), dtype=torch.float32),
                 terminal=torch.tensor(rng.random(n) < 0.2))


def train_step_case(mesh):
    """One sharded step from seeded weights; returns (new params, global
    loss, the weights it started from)."""
    model = MultiLayerPerceptron(4, (32, 32), out=2)
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.3)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    optimizer = optimizer_factory("ADAM", lr=1e-3)
    step, place = make_sharded_train_step(mesh, model, optimizer, gamma=0.99, tp=False)
    placed, opt_state = place(params, optimizer.init(list(params.values())))
    target = {k: v.clone() for k, v in placed.items()}
    new, _, loss = step(placed, target, opt_state, shard_batch(mesh, example_batch(),
                                                                ("host", "dp")))
    return {k: v.numpy() for k, v in new.items()}, float(loss), params


def planner_case():
    env = CartPoleEnv(max_episode_steps=50)
    params = env.default_params("cpu")
    states, _ = env.reset(params, torch.Generator().manual_seed(1), TREES)
    noise = torch.rand((OPD["plan_capacity"], 2, TREES),
                       generator=torch.Generator().manual_seed(2))
    return env, params, states, noise


def plans(mesh):
    env, params, states, noise = planner_case()
    opd = sharded_planner_batch(
        mesh, lambda p, s, n: opd_plan_batch(env, p, s, None, noise=n, device="cpu", **OPD)[:2],
        params, states, noise, noise_axis=-1)
    olop = sharded_planner_batch(
        mesh, lambda p, s, n: olop_plan_batch(env, p, s, device="cpu", **OLOP)[:2],
        params, states)
    return [x.numpy() for x in (*opd, *olop)]


_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np, torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    torch.set_num_threads(1)
    from rl_agents_torch.parallel.distributed import (
        data_layout, make_pod_mesh, maybe_initialize_distributed)
    import test_torch_distributed as t

    out = sys.argv[1]
    # WORLD_SIZE and RANK come from the environment, the store from the argument
    assert maybe_initialize_distributed("file://" + out + "/store") is True
    assert maybe_initialize_distributed() is True  # idempotent
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and rank == int(os.environ["RANK"]) and dist.get_backend() == "gloo"
    ranks = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(ranks, torch.tensor([rank]))
    assert [int(r) for r in ranks] == [0, 1]
    mesh = make_pod_mesh(axes=("host", "dp"))  # LOCAL_WORLD_SIZE=1: one rank a host
    assert tuple(mesh.shape) == (2, 1) and mesh.mesh[rank].tolist() == [rank]
    assert data_layout(mesh)[1:] == (2, rank)
    params, loss, _ = t.train_step_case(mesh)
    np.save(out + f"/rank{{rank}}.npy", dict(params=params, loss=loss, plans=t.plans(mesh)),
            allow_pickle=True)
    dist.destroy_process_group()
""")


def test_two_processes_bootstrap_train_and_plan(tmp_path):
    code = _WORKER.format(repo=str(REPO), tests=str(REPO / "tests"))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=dict(base, WORLD_SIZE="2", RANK=str(r), LOCAL_WORLD_SIZE="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}\n{err[-4000:]}"
    ranks = [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).item() for r in range(2)]

    # the sharded step against one step on the whole batch, in this process
    want, want_loss, params0 = train_step_case(None)
    for rank in ranks:
        assert rank["loss"] == pytest.approx(want_loss, rel=1e-6)
        for name, value in want.items():
            np.testing.assert_allclose(rank["params"][name], value, rtol=0, atol=STEP_ATOL)
    jax_params = _jax_train_step(params0)
    for name, value in jax_params.items():
        np.testing.assert_allclose(ranks[0]["params"][name], value, rtol=0, atol=STEP_ATOL)

    # sharded plans against the unsharded batch: actions and lengths equal
    for got, expected in zip(ranks[0]["plans"], plans(None)):
        np.testing.assert_array_equal(got, expected)
    for a, b in zip(ranks[0]["plans"], ranks[1]["plans"]):
        np.testing.assert_array_equal(a, b)


def _jax_train_step(params):
    """JAX's ``make_sharded_train_step`` step on one device, the same
    weights and batch; returns the port's layout."""
    import jax
    import jax.numpy as jnp
    import optax

    from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
    from rl_agents_tpu.agents.dqn.replay import Batch as JaxBatch
    from rl_agents_tpu.models import MultiLayerPerceptron as JaxMLP
    from rl_agents_tpu.parallel.distributed import make_pod_mesh as jax_pod_mesh
    from rl_agents_tpu.parallel.mesh import make_sharded_train_step as jax_step

    model_t = MultiLayerPerceptron(4, (32, 32), out=2)
    with torch.no_grad():
        for name, p in model_t.named_parameters():
            p.copy_(params[name])
    flax = jax.tree.map(jnp.asarray, torch_params_to_flax(model_t))
    mesh = jax_pod_mesh(axes=("host", "dp"), hosts=1, devices=jax.devices()[:1])
    optimizer = optax.adam(1e-3)
    train_step, _, _ = jax_step(mesh, JaxMLP(layers=(32, 32), out=2), optimizer, gamma=0.99,
                                tp=False)
    batch = JaxBatch(*(jnp.asarray(x.numpy()) for x in example_batch()))
    new, _, _ = jax.jit(train_step)(flax, flax, optimizer.init(flax), batch)
    flax_params_to_torch(model_t, jax.tree.map(np.asarray, new))
    return {k: v.detach().numpy() for k, v in model_t.named_parameters()}
