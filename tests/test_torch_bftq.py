"""Budgeted FTQ in the PyTorch port against the JAX package: the dense
Pareto hull (against JAX's dense hull and its monotone chain, on random
clouds with ties, vertical runs and collinear points), optimal mixtures,
``parse_betas``, ``sample_simplex``, the ``BudgetedMLP`` forward on
converted flax weights, the targets and the fit, and the agent on two-way
and intersection.

Hull points, counts and mixture indices are equal; floats are equal where
the port writes XLA's fused multiply-adds (the hull's cross product, the
mixture's interpolation, the targets), the network forward within 1e-6 and
the fit's parameters within 1e-5 of each leaf's largest entry."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_agents_torch.agents.budgeted_ftq import bftq as tq
from rl_agents_torch.agents.budgeted_ftq import greedy_policy as tg
from rl_agents_torch.agents.budgeted_ftq.agent import sample_simplex as torch_simplex
from rl_agents_torch.agents.budgeted_ftq.models import BudgetedMLP as TorchMLP
from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_torch.models.optimizers import optimizer_factory as torch_optimizer
from rl_agents_torch.trainer.evaluation import Evaluation
from rl_agents_tpu.agents.budgeted_ftq import bftq as jq
from rl_agents_tpu.agents.budgeted_ftq import greedy_policy as jg
from rl_agents_tpu.agents.budgeted_ftq.agent import sample_simplex as jax_simplex
from rl_agents_tpu.agents.budgeted_ftq.models import BudgetedMLP as JaxMLP

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
FIELDS = ("qc", "qr", "action", "budget", "valid", "count")


def _cloud(rng, S, P, grid=None):
    """Random clouds; on a coarse grid they hold ties, vertical runs and
    collinear points."""
    if grid:
        qr = rng.integers(0, grid, (S, P)) / grid
        qc = rng.integers(0, grid, (S, P)) / grid
    else:
        qr, qc = rng.random((S, P)), rng.random((S, P))
    return (qr.astype(np.float32), qc.astype(np.float32),
            rng.integers(0, 4, (S, P)).astype(np.int64), rng.random((S, P)).astype(np.float32))


def _jax_frontiers(qr, qc, actions, budgets, fn, jit=False):
    """JAX's frontier of each state, op by op (the dense form's semantics,
    which its chain shares), or compiled."""
    args = (jnp.asarray(qr), jnp.asarray(qc), jnp.asarray(actions.astype(np.int32)),
            jnp.asarray(budgets))
    if jit:
        return jax.jit(jax.vmap(fn))(*args)
    return jax.vmap(fn)(*args)


def _assert_frontiers_equal(got, want, cloud=None):
    """Equal frontiers. Given the ``cloud`` (qr, qc, actions, budgets), a
    point that has exact duplicates may be any of them: ``jnp.lexsort`` sorts
    unstably, so which duplicate JAX keeps is its sort's choice, while the
    port's sort is stable."""
    for name in FIELDS:
        got_field, want_field = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if cloud is None or name not in ("action", "budget"):
            np.testing.assert_array_equal(got_field, want_field, err_msg=name)
            continue
        qr, qc, actions, budgets = cloud
        values = actions if name == "action" else budgets
        for s in range(got_field.shape[0]):
            for p in range(int(got.count[s])):
                if got_field[s, p] == want_field[s, p]:
                    continue
                twins = (qc[s] == got.qc[s, p].item()) & (qr[s] == got.qr[s, p].item())
                assert twins.sum() > 1 and got_field[s, p] in values[s][twins], (name, s, p)


@pytest.mark.parametrize("grid", [None, 4, 7])
def test_dense_hull_matches_jax_dense_hull_and_chain(grid):
    rng = np.random.default_rng(grid or 0)
    qr, qc, actions, budgets = _cloud(rng, 24, 30, grid)
    want = _jax_frontiers(qr, qc, actions, budgets, jg.pareto_frontier)
    args = [torch.tensor(x) for x in (qr, qc, actions, budgets)]
    got = tg.pareto_frontier(*args)
    cloud = (qr, qc, actions, budgets) if grid else None
    _assert_frontiers_equal(got, want, cloud)
    # chunked over states at a small budget: the same frontiers
    _assert_frontiers_equal(tg.pareto_frontier(*args, budget=2 * 30 ** 3), want, cloud)
    assert tg.pareto_frontier.chunks == 12
    # and over blocks of 7 points when one state's comparison exceeds the budget
    _assert_frontiers_equal(tg.pareto_frontier(*args, budget=30 * 30 * 7), want, cloud)
    assert tg.pareto_frontier.chunks == 24 * 5
    # the monotone chain, in both packages, state by state; without ties it
    # is the dense hull, while on a grid it also keeps the lower points of
    # the cheapest vertical run, which the dense form drops (in JAX too)
    for s in range(6):
        chain = jg._pareto_frontier_chain(*(jnp.asarray(x[s]) for x in
                                            (qr, qc, actions.astype(np.int32), budgets)))
        mine = tg._pareto_frontier_chain(*(a[s] for a in args))
        one = tg.Frontier(*(x[None] for x in mine))
        _assert_frontiers_equal(one, jax.tree.map(lambda x: np.asarray(x)[None], chain),
                                None if cloud is None else tuple(x[s:s + 1] for x in cloud))
        if grid is None:
            _assert_frontiers_equal(one, tg.Frontier(*(x[s:s + 1] for x in got)))
        assert int(mine.count) >= int(got.count[s])


def test_compiled_jax_hull_collapses_where_the_port_keeps_the_chain():
    """The JAX package's dense hull compiled (as ``batch_mixtures`` and the
    BFTQ targets run it) fuses its cross product into one multiply-add; at a
    point's own pair the product's rounding error is left, negative about
    half the time, and covers the point. On random clouds the compiled hull
    keeps one point where the chain, the dense form run op by op and the
    port keep the frontier (ROADMAP.md §3). On a grid, where the products
    are exact, all agree."""
    for grid, collapsed in ((None, True), (4, False)):
        qr, qc, actions, budgets = _cloud(np.random.default_rng(0), 8, 30, grid)
        compiled = _jax_frontiers(qr, qc, actions, budgets, jg.pareto_frontier, jit=True)
        eager = _jax_frontiers(qr, qc, actions, budgets, jg.pareto_frontier)
        got = tg.pareto_frontier(*(torch.tensor(x) for x in (qr, qc, actions, budgets)))
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(eager.count))
        if collapsed:
            assert (np.asarray(compiled.count) <= got.count.numpy()).all()
            assert (np.asarray(compiled.count) < got.count.numpy()).sum() >= 6
        else:
            _assert_frontiers_equal(got, compiled, (qr, qc, actions, budgets))


def test_hull_of_collinear_and_vertical_points():
    """Points on one line keep only its ends; a vertical run keeps its top."""
    qc = np.array([[0.0, 0.25, 0.5, 0.75, 1.0, 0.5, 0.5]], np.float32)
    qr = np.array([[0.0, 0.25, 0.5, 0.75, 1.0, 0.2, 0.6]], np.float32)
    actions, budgets = np.arange(7)[None], np.linspace(0, 1, 7, dtype=np.float32)[None]
    got = tg.pareto_frontier(*(torch.tensor(x) for x in (qr, qc, actions, budgets)))
    want = _jax_frontiers(qr, qc, actions, budgets, jg.pareto_frontier)
    _assert_frontiers_equal(got, want)
    assert int(got.count[0]) == 3  # (0, 0), the top of the run at 0.5, (1, 1)


@pytest.mark.parametrize("grid", [None, 5])
def test_batch_mixtures_match_jax(grid):
    rng = np.random.default_rng(11)
    S, B, A = 32, 10, 3
    q = (rng.integers(0, grid, (S, B, 2 * A)) / grid if grid else rng.random((S, B, 2 * A)))
    q = q.astype(np.float32)
    betas_disc = np.linspace(0, 1, B).astype(np.float32)
    beta = rng.random(S).astype(np.float32)
    beta[:4] = [0.0, -0.5, 1.0, 2.0]  # below the cheapest point, saturating above
    with jax.disable_jit():  # the frontier's semantics, op by op
        want = jg.batch_mixtures(jnp.asarray(q), jnp.asarray(betas_disc), jnp.asarray(beta))
    got = tg.batch_mixtures(torch.tensor(q), torch.tensor(betas_disc), torch.tensor(beta))
    for name in tg.Mixture._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("spec", ["np.arange(0, 1, 0.1)", "np.arange(0, 1, 0.01)",
                                  "np.linspace(0, 1, 11)", "np.linspace(0.5, 2, 4)",
                                  [0.0, 0.25, 1.0], "np.linspace(0, 1)"])
def test_parse_betas_matches_jax(spec):
    got = tq.parse_betas(spec)
    np.testing.assert_array_equal(got, jq.parse_betas(spec))
    assert got.dtype == np.float32
    with pytest.raises(ValueError):
        tq.parse_betas("__import__('os')")


def test_sample_simplex_matches_jax():
    for seed in range(6):
        coeff = np.random.default_rng(seed).random(4)
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        x_j = jax_simplex(coeff, 0.7, 0, 1, rng_j)
        x_t = torch_simplex(coeff, 0.7, 0, 1, rng_t)
        np.testing.assert_array_equal(x_t, x_j)
        assert abs(float(coeff @ x_t) - 0.7) < 1e-9 and (x_t >= -1e-12).all()


def _networks(size_state, n_actions, layers, encoder, size_encoder, seed):
    net_j = JaxMLP(size_state=size_state, n_actions=n_actions, layers=tuple(layers),
                   size_beta_encoder=size_encoder, beta_encoder_type=encoder)
    params_j = net_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, size_state + 1)))
    net_t = TorchMLP(size_state, n_actions, layers, size_encoder, encoder)
    flax_params_to_torch(net_t, jax.tree.map(np.asarray, params_j))
    return (net_j, params_j), (net_t, {k: v.detach().clone() for k, v in net_t.named_parameters()})


@pytest.mark.parametrize("encoder,size", [("LINEAR", 10), ("REPEAT", 5), ("LINEAR", 1),
                                          ("LINEAR", 0)])
def test_budgeted_mlp_forward_and_parameter_names(encoder, size):
    (net_j, params_j), (net_t, _) = _networks(6, 3, [16, 8], encoder, size, seed=1)
    x = np.random.default_rng(0).normal(size=(12, 7)).astype(np.float32)
    want = np.asarray(net_j.apply(params_j, jnp.asarray(x)))
    with torch.no_grad():
        got = net_t(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    back = torch_params_to_flax(net_t)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params_j))


def _batch(rng, N, D, A):
    return dict(state=rng.normal(size=(N, D)).astype(np.float32),
                action=rng.integers(0, A, N).astype(np.int64),
                reward=rng.uniform(size=N).astype(np.float32),
                next_state=rng.normal(size=(N, D)).astype(np.float32),
                terminal=rng.uniform(size=N) < 0.1,
                cost=(rng.uniform(size=N) < 0.2).astype(np.float32),
                beta=rng.uniform(size=N).astype(np.float32))


@pytest.mark.parametrize("clamp_qc", [None, [0.0, 1.5]])
def test_targets_and_fit_match_jax(clamp_qc):
    """``bench_bftq_fit``'s pipeline at a small size: one target computation
    (the forward over states x budgets, the hulls, the mixtures) and a fit of
    20 full-batch ADAM steps from the same parameters."""
    N, D, A = 48, 6, 3
    config = {"gamma": 0.9, "gamma_c": 0.8, "betas_for_duplication": [],
              "betas_for_discretisation": "np.linspace(0, 1, 10)", "loss_function": "l2",
              "loss_function_c": "l2", "weights_losses": [1.0, 0.5], "epochs": 1,
              "regression_epochs": 20, "clamp_qc": clamp_qc, "reset_network_each_epoch": False,
              "optimizer": {"type": "ADAM", "learning_rate": 1e-3, "weight_decay": 0.0}}
    (net_j, params_j), (net_t, params_t) = _networks(D, A, [32, 32], "LINEAR", 10, seed=2)
    bftq_j = jq.BudgetedFittedQ(net_j, dict(config))
    data = _batch(np.random.default_rng(3), N, D, A)
    batch_j = jq.BFTQBatch(**{k: jnp.asarray(v.astype(np.int32) if k == "action" else v)
                              for k, v in data.items()})
    batch_t = tq.BFTQBatch(**{k: torch.tensor(v) for k, v in data.items()})
    betas = tq.parse_betas(config["betas_for_discretisation"])
    # JAX op by op: its compiled hull collapses (ROADMAP.md §3)
    with jax.disable_jit():
        x = np.concatenate([np.repeat(data["next_state"], len(betas), axis=0),
                            np.tile(betas, N)[:, None]], axis=1)
        q_j = np.asarray(net_j.apply(params_j, jnp.asarray(x))).reshape(N, len(betas), -1)
        mix_j = jg.batch_mixtures(jnp.asarray(q_j), jnp.asarray(betas), batch_j.beta)
        for bootstrap in (True, False):
            want = bftq_j._compute_targets(params_j, batch_j, jnp.asarray(betas),
                                           jnp.asarray(bootstrap))
            got = tq.compute_targets(net_t, params_t, batch_t, torch.tensor(betas), bootstrap,
                                     config["gamma"], config["gamma_c"], clamp_qc)
            for a, b in zip(got, want):  # XLA fuses what op-by-op JAX rounds twice
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    with torch.no_grad():
        q_t = net_t(torch.tensor(x)).reshape(N, len(betas), -1)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-6)
    mix_t = tg.batch_mixtures(q_t, torch.tensor(betas), batch_t.beta)
    next_mix = tq.next_mixtures(net_t, params_t, batch_t, torch.tensor(betas))
    for name in ("action_inf", "action_sup", "budget_inf", "budget_sup"):
        np.testing.assert_array_equal(getattr(mix_t, name).numpy(),
                                      np.asarray(getattr(mix_j, name)), err_msg=name)
        assert torch.equal(getattr(next_mix, name), getattr(mix_t, name)), name
    assert (mix_t.action_inf != mix_t.action_sup).any()
    target_r, target_c = got = tq.compute_targets(net_t, params_t, batch_t, torch.tensor(betas),
                                                  True, config["gamma"], config["gamma_c"],
                                                  clamp_qc)
    # the targets of the next states' mixtures are the same
    for a, b in zip(tq.mixture_targets(next_mix, batch_t, config["gamma"], config["gamma_c"],
                                       clamp_qc), got):
        assert torch.equal(a, b)
    sb_j = jnp.concatenate([batch_j.state, batch_j.beta[:, None]], axis=1)
    fit_j = bftq_j._make_fit(optax.adam(1e-3), config["regression_epochs"])
    out_params_j, _, losses_j = fit_j(params_j, optax.adam(1e-3).init(params_j), sb_j,
                                      batch_j.action, jnp.asarray(target_r.numpy()),
                                      jnp.asarray(target_c.numpy()))
    loss = tq.make_loss(net_t, A, *(tq.loss_function_factory("l2"),) * 2, [1.0, 0.5])
    optimizer = torch_optimizer("ADAM", lr=1e-3)
    fit_t = tq.make_fit(loss, optimizer, config["regression_epochs"])
    sb_t = torch.cat([batch_t.state, batch_t.beta[:, None]], dim=1)
    out_params_t, _, losses_t = fit_t(params_t, optimizer.init(list(params_t.values())), sb_t,
                                      batch_t.action, target_r, target_c)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-5)
    with torch.no_grad():
        for name, p in net_t.named_parameters():
            p.copy_(out_params_t[name])
    got_tree = torch_params_to_flax(net_t)
    for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, out_params_j))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


class _Costful:
    """A port env handle whose info carries the action as its cost."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        info["cost"] = float(action == 0)
        return obs, reward, done, truncated, info


@pytest.mark.parametrize("env_file,agent_file", [
    ("TwoWayEnv/env.json", "TwoWayEnv/agents/BFTQAgent/baseline.json"),
    ("IntersectionEnv/env.json", "IntersectionEnv/BFTQAgent.json"),
])
def test_agent_trains_through_the_batched_episodes(tmp_path, env_file, agent_file):
    """The corpus's BFTQ configs, cut in width and epochs, through
    ``Evaluation.train()``: one batch collected by the exploring agent (its
    budgets and random actions from the same numpy stream as JAX's agent),
    recorded with beta duplication, fitted, saved; then a greedy act."""
    env_config = dict(load_agent_config(CONFIGS / env_file))
    env_config["max_episode_steps"] = 6
    env = _Costful(torch_load_environment(env_config, device="cpu"))
    config = load_agent_config(CONFIGS / agent_file)
    config.update(epochs=2, regression_epochs=5, batch_size=20,
                  betas_for_duplication=[0.0, 1.0], betas_for_discretisation="np.linspace(0, 1, 4)")
    config["network"] = dict(config.get("network", {}), layers=[16], size_beta_encoder=3)
    agent = torch_load_agent(config, env, device="cpu")
    assert agent.batched
    evaluation = Evaluation(env, agent, directory=tmp_path, num_episodes=1, training=True,
                            sim_seed=0)
    evaluation.train()
    assert agent.bftq.memory_size == 2 * 14  # one batch of 14 samples, duplicated
    assert agent.bftq.batch == 1 and agent.bftq.epoch == 1
    assert (evaluation.run_directory / "checkpoint-final.tar").is_file()
    agent.eval()
    obs, _ = env.reset(seed=1)
    assert agent.act(obs) in range(env.action_space.n)
    assert 0.0 <= agent.beta <= 1.0 + 1e-6
    fresh = torch_load_agent(config, env, device="cpu")
    fresh.load(evaluation.run_directory / "checkpoint-final.tar")
    for key, value in agent.bftq.params.items():
        assert torch.equal(fresh.bftq.params[key], value)


def test_exploration_draws_the_jax_agent_stream():
    """With epsilon at 1 the agent acts by the random budgeted policy only:
    from one seed the actions and next budgets equal the JAX agent's."""
    from rl_agents_tpu.agents.budgeted_ftq.agent import BFTQAgent as JaxAgent
    from rl_agents_tpu.factory import load_environment as jax_load_environment

    config = {"exploration": {"temperature": 1.0, "final_temperature": 1.0, "tau": 10},
              "network": {"beta_encoder_type": "LINEAR", "size_beta_encoder": 3,
                          "activation_type": "RELU", "layers": [8]}}
    env_j = jax_load_environment(CONFIGS / "TwoWayEnv" / "env.json")
    env_t = torch_load_environment(CONFIGS / "TwoWayEnv" / "env.json", device="cpu")
    agent_j = JaxAgent(env_j, dict(config))
    agent_t = torch_load_agent(dict(config, __class__="BFTQAgent"), env_t, device="cpu")
    agent_j.seed(4)
    agent_t.seed(4)
    obs = env_t.reset(seed=0)[0]
    for _ in range(20):
        assert agent_t.act(obs) == agent_j.act(obs)
        assert agent_t.beta == agent_j.beta
