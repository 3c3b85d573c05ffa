"""Config loading and budget allocation: the PyTorch port against the JAX
package, on the shipped config corpus."""
import json
from pathlib import Path

import pytest
import torch

from rl_agents_torch.agents.tree_search import common as torch_common
from rl_agents_torch.configuration import load_json_config as torch_load
from rl_agents_torch.factory import agent_class
from rl_agents_tpu.agents.tree_search import common as jax_common
from rl_agents_tpu.configuration import load_json_config as jax_load

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
CONFIG_FILES = sorted(p.relative_to(CONFIGS).as_posix()
                      for p in [*CONFIGS.glob("CartPoleEnv/*.json"),
                                *CONFIGS.glob("FiniteMDPEnv/**/*.json"),
                                *CONFIGS.glob("SailingEnv/**/*.json")])


@pytest.mark.parametrize("relpath", CONFIG_FILES)
def test_corpus_config_loads_identically(relpath):
    assert torch_load(CONFIGS / relpath) == jax_load(CONFIGS / relpath)


def test_base_config_chain_loads_identically(tmp_path):
    (tmp_path / "configs" / "Family" / "sub").mkdir(parents=True)
    base = {"__class__": "OLOPAgent", "gamma": 0.9,
            "upper_bound": {"type": "kullback-leibler", "time": "global"}}
    middle = {"base_config": "configs/Family/base.json", "budget": 50,
              "upper_bound": {"time": "local"}}
    child = {"base_config": "../middle.json", "gamma": 0.95,
             "upper_bound": {"threshold": 2.0}}
    (tmp_path / "pyproject.toml").write_text("")
    (tmp_path / "configs" / "Family" / "base.json").write_text(json.dumps(base))
    (tmp_path / "configs" / "Family" / "middle.json").write_text(json.dumps(middle))
    path = tmp_path / "configs" / "Family" / "sub" / "child.json"
    path.write_text(json.dumps(child))
    loaded = torch_load(path)
    assert loaded == jax_load(path)
    assert loaded == {"__class__": "OLOPAgent", "gamma": 0.95, "budget": 50,
                      "upper_bound": {"type": "kullback-leibler", "time": "local",
                                      "threshold": 2.0}}


@pytest.mark.parametrize("gamma", [0.5, 0.8, 0.9, 0.95, 0.99])
def test_allocation_and_horizon_match(gamma):
    for budget in range(2, 401):
        assert torch_common.olop_horizon(budget, gamma) == jax_common.olop_horizon(budget, gamma)
        try:
            expected = jax_common.allocation(budget, gamma)
        except ValueError:
            with pytest.raises(ValueError):
                torch_common.allocation(budget, gamma)
            continue
        assert torch_common.allocation(budget, gamma) == expected


def test_agent_class_resolves_reference_paths_and_refuses_the_rest():
    olop = agent_class("<class 'rl_agents.agents.tree_search.olop.OLOPAgent'>")
    assert olop is agent_class("OLOPAgent")
    assert olop.__module__ == "rl_agents_torch.agents.tree_search.olop"
    mcts = agent_class("<class 'rl_agents.agents.tree_search.mcts.MCTSAgent'>")
    assert mcts.__module__ == "rl_agents_torch.agents.tree_search.mcts"
    gape = agent_class("<class 'rl_agents.agents.tree_search.mdp_gape.MDPGapEAgent'>")
    assert gape.__module__ == "rl_agents_torch.agents.tree_search.mdp_gape"
    dqn = agent_class("<class 'rl_agents.agents.deep_q_network.pytorch.DQNAgent'>")
    assert dqn is agent_class("DQNAgent")
    assert dqn.__module__ == "rl_agents_torch.agents.dqn.agent"
    ftq = agent_class("<class 'rl_agents.agents.fitted_q.pytorch.FTQAgent'>")
    assert ftq.__module__ == "rl_agents_torch.agents.fitted_q"
    cem = agent_class("<class 'rl_agents.agents.cross_entropy_method.cem.CEMAgent'>")
    assert cem is agent_class("CEMAgent")
    assert cem.__module__ == "rl_agents_torch.agents.cem"
    linear = agent_class("<class 'rl_agents.agents.linear.linear_feedback.LinearFeedbackAgent'>")
    assert linear.__module__ == "rl_agents_torch.agents.control"
    # the corpus's one class that no package ships
    with pytest.raises(NotImplementedError, match="not yet ported"):
        agent_class("<class 'rl_agents.agents.robust.robust_epc.ModelBiasAgent'>")


@pytest.mark.parametrize("path,module", [
    ("rl_agents.agents.tree_search.graph_based.GraphBasedPlannerAgent", "graph_based"),
    ("rl_agents.agents.tree_search.graph_based_stochastic.StochasticGraphBasedPlannerAgent",
     "graph_based_stochastic"),
    ("rl_agents.agents.tree_search.deterministic.DeterministicPlannerAgent", "deterministic"),
    ("rl_agents.agents.tree_search.state_aware.StateAwarePlannerAgent", "state_aware"),
])
def test_agent_class_resolves_the_graph_and_tree_planners(path, module):
    cls = agent_class(f"<class '{path}'>")
    assert cls is agent_class(path.rsplit(".", 1)[-1])
    assert cls.__module__ == f"rl_agents_torch.agents.tree_search.{module}"
    from rl_agents_tpu.factory import agent_class as jax_agent_class

    reference = jax_agent_class(f"<class '{path}'>")
    assert cls.__name__ == reference.__name__
    defaults, reference_defaults = cls.default_config(), reference.default_config()
    assert defaults == reference_defaults
