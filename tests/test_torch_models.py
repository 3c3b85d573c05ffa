"""The PyTorch port's model zoo against the JAX package's flax models.

Each model is built by both packages, the flax parameters are carried across
with ``convert.flax_params_to_torch``, and the forwards must agree within
1e-5 (bfloat16 models within 2e-2 relative). Every DQN corpus config whose
environment the port has builds a parameter tree equal to JAX's in names and
shapes."""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_torch.models import zoo as torch_zoo
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment
from rl_agents_tpu.models import zoo as jax_zoo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "scripts" / "configs"
TOL = 1e-5


def _shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_shapes(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(np.shape(value))
    return out


def _entities(batch, entities, features, seed, absent=0.4):
    """Kinematics-like observations: column 0 is presence, some entities
    absent, the ego always present."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, entities, features)).astype(np.float32)
    x[:, :, 0] = (rng.random((batch, entities)) >= absent).astype(np.float32)
    x[:, 0, 0] = 1.0
    return x


def _pair(config, obs_shape, x, seed=0):
    """(flax model, params, port model with the params carried across)."""
    model_j = jax_zoo.model_factory(dict(config))
    params = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    model_t = torch_zoo.model_factory(dict(config), obs_shape)
    assert _shapes(params) == _shapes(torch_params_to_flax(model_t))
    flax_params_to_torch(model_t, params)
    return model_j, params, model_t


def _forward_pair(model_j, params, model_t, x, **kwargs):
    y_j = np.asarray(model_j.apply(params, jnp.asarray(x), **kwargs))
    with torch.no_grad():
        tensor = torch.tensor(x)
        y_t = (model_t.get_attention_matrix(tensor) if kwargs else model_t(tensor))
    return y_j, y_t.float().numpy()


EGO = {"type": "EgoAttentionNetwork", "out": 5,
       "embedding_layer": {"layers": [64, 64]}, "others_embedding_layer": {"layers": [64, 64]},
       "attention_layer": {"feature_size": 64, "heads": 4}, "output_layer": {"layers": [64]}}
MODELS = {
    "mlp": ({"type": "MultiLayerPerceptron", "layers": [32, 32], "out": 2}, (4,)),
    "mlp_tanh": ({"type": "MultiLayerPerceptron", "layers": [16], "out": 3,
                  "activation": "TANH"}, (15, 5)),
    "dueling": ({"type": "DuelingNetwork", "out": 5, "base_module": {"layers": [32, 32]},
                 "value": {"layers": [16]}, "advantage": {"layers": [16]}}, (15, 5)),
    "conv": ({"type": "ConvolutionalNetwork", "out": 3, "head_mlp": {"layers": [20]}},
             (7, 11, 11)),
    "ego_attention": (EGO, (15, 7)),
    "ego_self_attention": (dict(EGO, self_attention_layer={"heads": 2},
                                attention_layer={"feature_size": 64, "heads": 2}), (12, 7)),
    "attention": ({"type": "AttentionNetwork", "out": 3, "embedding_layer": {"layers": [32, 32]},
                   "attention_layer": {"feature_size": 32, "heads": 2},
                   "output_layer": {"layers": [32]}}, (8, 5)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_flax_on_carried_weights(name):
    config, obs_shape = MODELS[name]
    if len(obs_shape) == 2:
        x = _entities(9, *obs_shape, seed=1)
    else:
        x = np.random.default_rng(1).standard_normal((9,) + obs_shape).astype(np.float32)
    model_j, params, model_t = _pair(config, obs_shape, x)
    y_j, y_t = _forward_pair(model_j, params, model_t, x)
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("self_attention", [False, True])
def test_attention_matrix_masks_absent_entities(self_attention):
    config = dict(EGO, self_attention_layer={"heads": 4} if self_attention else None)
    x = _entities(6, 15, 7, seed=2, absent=0.5)
    model_j, params, model_t = _pair(config, (15, 7), x)
    y_j, y_t = _forward_pair(model_j, params, model_t, x,
                             method=jax_zoo.EgoAttentionNetwork.get_attention_matrix)
    assert y_t.shape == (6, 4, 1, 15)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)
    absent = x[:, :, 0] < 0.5
    assert np.all(y_t[:, :, 0, :][np.repeat(absent[:, None, :], 4, axis=1)] < 1e-6)
    np.testing.assert_allclose(y_t.sum(-1), 1.0, atol=1e-6)


def test_entry_model_at_its_exact_shapes():
    """``__graft_entry__.entry()``: batch 8, 15 entities, 7 features, 4 heads,
    5 outputs, on its own zero input and on observations with absent entities."""
    sys.path.insert(0, str(REPO))
    from __graft_entry__ import entry

    fn, (params, x) = entry()
    params = jax.tree.map(np.asarray, params)
    model_t = torch_zoo.EgoAttentionNetwork(7, out=5, embedding_layers=(64, 64),
                                            others_embedding_layers=(64, 64),
                                            output_layers=(64,), feature_size=64, heads=4)
    assert _shapes(params) == _shapes(torch_params_to_flax(model_t))
    flax_params_to_torch(model_t, params)
    for inputs in (np.asarray(x), _entities(8, 15, 7, seed=3)):
        y_j = np.asarray(fn(params, jnp.asarray(inputs)))
        with torch.no_grad():
            y_t = model_t(torch.tensor(inputs)).numpy()
        assert y_t.shape == (8, 5)
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)


def test_conv_head_reads_the_feature_map_in_nhwc_order():
    config, obs_shape = MODELS["conv"]
    x = np.random.default_rng(4).standard_normal((5,) + obs_shape).astype(np.float32)
    model_j, params, model_t = _pair(config, obs_shape, x)
    y_j, y_t = _forward_pair(model_j, params, model_t, x)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)
    # on env_grid.json's 11 x 11 map the last feature map is 1 x 1; on a
    # 16 x 16 map it is 2 x 2, and an NCHW flatten would read the head's
    # first kernel in the wrong row order
    big = np.random.default_rng(5).standard_normal((5, 7, 16, 16)).astype(np.float32)
    model_j, params, model_t = _pair(config, (7, 16, 16), big)
    y_j, y_t = _forward_pair(model_j, params, model_t, big)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)
    with torch.no_grad():
        features = torch.tensor(big)
        for conv in (model_t.Conv_0, model_t.Conv_1, model_t.Conv_2):
            features = torch.relu(conv(features))
        nchw = model_t.head(features.reshape(5, -1)).numpy()
    assert np.max(np.abs(nchw - y_j)) > 1e-3


def test_gelu_is_the_tanh_approximation():
    config = {"type": "MultiLayerPerceptron", "layers": [32, 32], "out": 2, "activation": "GELU"}
    x = 3 * np.random.default_rng(6).standard_normal((9, 4)).astype(np.float32)
    model_j, params, model_t = _pair(config, (4,), x)
    y_j, y_t = _forward_pair(model_j, params, model_t, x)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL)
    z = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(torch_zoo.activation_factory("GELU")(z).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z.numpy()))), atol=1e-6)
    assert torch.max(torch.abs(torch.nn.functional.gelu(z) - torch_zoo.activation_factory("GELU")(z))) > 1e-4


@pytest.mark.parametrize("name", ["ego_attention", "conv", "dueling"])
def test_bfloat16_models_compute_in_bfloat16_with_float32_parameters(name):
    config, obs_shape = MODELS[name]
    config = dict(config, dtype="bfloat16")
    if len(obs_shape) == 2:
        x = _entities(9, *obs_shape, seed=7)
    else:
        x = np.random.default_rng(7).standard_normal((9,) + obs_shape).astype(np.float32)
    model_j, params, model_t = _pair(config, obs_shape, x)
    assert all(p.dtype == torch.float32 for p in model_t.parameters())
    y_j = np.asarray(model_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        y_t = model_t(torch.tensor(x))
    assert y_t.dtype == torch.bfloat16 and str(y_j.dtype) == "bfloat16"
    y_j = y_j.astype(np.float32)
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2e-2,
                               atol=2e-2 * float(np.max(np.abs(y_j))))


def test_others_embedding_defaults_to_the_ego_widths(caplog):
    """``ExitEnv/agents/DQNAgent.json`` sets only ``embedding_layer``."""
    config = {"type": "EgoAttentionNetwork", "out": 5, "embedding_layer": {"layers": [64, 64]},
              "attention_layer": {"feature_size": 64, "heads": 2}}
    with caplog.at_level("WARNING"):
        model = torch_zoo.model_factory(config, (15, 5))
    assert "others_embedding defaults to the ego embedding widths" in caplog.text
    assert model.others_embedding.Dense_1.weight.shape == (64, 64)


def test_trainable_parameters_count():
    model = torch_zoo.model_factory({"type": "MultiLayerPerceptron", "layers": [32, 32],
                                     "out": 4}, (6,))
    assert torch_zoo.trainable_parameters(model) == 6 * 32 + 32 + 32 * 32 + 32 + 32 * 4 + 4


# every DQN config of the corpus whose environment is ported, on its env
CORPUS = [
    ("CartPoleEnv/DQNAgent.json", "CartPoleEnv/env.json"),
    ("HighwayEnv/agents/DQNAgent/dqn.json", "HighwayEnv/env.json"),
    ("HighwayEnv/agents/DQNAgent/ddqn.json", "HighwayEnv/env.json"),
    ("HighwayEnv/agents/DQNAgent/dueling_ddqn.json", "HighwayEnv/env.json"),
    ("HighwayEnv/agents/DQNAgent/ego_attention.json", "HighwayEnv/env.json"),
    ("ExitEnv/agents/DQNAgent.json", "ExitEnv/env.json"),
    ("ExitEnv/agents/DQNAgent/ego_attention_7feat.json", "ExitEnv/env.json"),
    ("IntersectionEnv/agents/DQNAgent/baseline.json", "IntersectionEnv/env.json"),
    ("IntersectionEnv/agents/DQNAgent/baseline5fps.json", "IntersectionEnv/env_5fps.json"),
    ("IntersectionEnv/agents/DQNAgent/ego_attention.json", "IntersectionEnv/env_5fps.json"),
    ("IntersectionEnv/agents/DQNAgent/ego_attention_2h.json", "IntersectionEnv/env_5fps.json"),
    ("IntersectionEnv/agents/DQNAgent/ego_attention_8h.json", "IntersectionEnv/env_5fps.json"),
    ("IntersectionEnv/agents/DQNAgent/self_attention.json", "IntersectionEnv/env_multi_agent.json"),
    ("IntersectionEnv/agents/DQNAgent/self_attention_2h.json", "IntersectionEnv/env_5fps.json"),
    ("IntersectionEnv/agents/DQNAgent/grid.json", "IntersectionEnv/env_grid.json"),
    ("IntersectionEnv/agents/DQNAgent/grid_convnet.json", "IntersectionEnv/env_grid.json"),
]


@pytest.mark.parametrize("agent_path,env_path", CORPUS)
def test_corpus_dqn_config_builds_the_jax_parameter_tree(agent_path, env_path):
    config = load_agent_config(CONFIGS / agent_path)
    env_j = jax_load_environment(CONFIGS / env_path)
    env_t = torch_load_environment(CONFIGS / env_path, device="cpu")
    agent_j = jax_load_agent(json.loads(json.dumps(config)), env_j)
    agent_t = torch_load_agent(json.loads(json.dumps(config)), env_t, device="cpu")
    params = jax.tree.map(np.asarray, agent_j.train_state.params)
    assert _shapes(params) == _shapes(torch_params_to_flax(agent_t.model))
    flax_params_to_torch(agent_t.model, params)
    agent_t.train_state.params.update(
        {k: v.detach().clone() for k, v in agent_t.model.named_parameters()})
    obs = np.stack([np.asarray(env_j.reset(seed=s)[0], dtype=np.float32) for s in range(3)])
    if obs.dtype == object or obs.ndim > len(agent_t.obs_shape) + 1:  # multi-agent tuples
        obs = obs.reshape((-1,) + agent_t.obs_shape)
    np.testing.assert_allclose(agent_t.get_batch_state_action_values(obs),
                               np.asarray(agent_j.get_batch_state_action_values(obs)),
                               rtol=0, atol=TOL)
