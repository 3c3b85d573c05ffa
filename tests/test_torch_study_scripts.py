"""The study scripts of the PyTorch port (``rl_agents_torch/scripts``)
against the JAX package's (``scripts/planners_*.py``), mirroring
``tests/test_experiments_cli.py``'s study tests at a tiny budget on the CPU:
the same CSV columns, the VI oracle's Q* equal to JAX's, OPD's simple regret
0, the merge study's 6 rows, and the tree figures written."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch.scripts import planners_evaluation as study
from rl_agents_torch.scripts import planners_robust_evaluation as robust_study
from rl_agents_torch.scripts import planners_visualization as visualization

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOOP_ENV = REPO / "scripts" / "configs" / "FiniteMDPEnv" / "env_loop.json"


@pytest.fixture
def jax_scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import planners_evaluation

    return planners_evaluation


def test_vi_oracle_equals_jaxs(jax_scripts):
    got = study.make_oracle(str(LOOP_ENV), "cpu")
    want = jax_scripts.make_oracle(str(LOOP_ENV))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert study.make_oracle({"id": "cartpole"}, "cpu") is None
    assert list(study.agent_configs()) == list(jax_scripts.agent_configs())
    assert study.agent_configs() == jax_scripts.agent_configs()
    assert study.COLUMNS == jax_scripts.COLUMNS


def test_planner_study_regret_csv(tmp_path, jax_scripts):
    """The planner-efficiency study writes the reference's exact CSV schema
    and measures simple regret against the VI oracle
    (reference: scripts/planners_evaluation.py:147-156,178-190)."""
    study.main(["--budgets", "1", "--budget-max", "1", "--seeds", "2", "--agents", "random",
                "OPD", "--out", str(tmp_path), "--device", "cpu"])
    lines = (tmp_path / "data.csv").read_text().strip().splitlines()
    header = lines[0].split(",")
    assert header == jax_scripts.COLUMNS
    rows = [dict(zip(header, ln.split(","))) for ln in lines[1:]]
    assert len(rows) == 4  # 2 agents x 1 budget x 2 seeds
    opd_regret = [float(r["simple_regret"]) for r in rows if r["agent"] == "OPD"]
    assert opd_regret == [0.0, 0.0]  # OPD finds the oracle action on the loop MDP
    assert all(float(r["gap"]) > 0 for r in rows)
    # OPD is deterministic: its rows are JAX's
    want = jax_scripts.evaluate_cell(str(LOOP_ENV), "OPD", jax_scripts.agent_configs()["OPD"],
                                     10, 2, jax_scripts.make_oracle(str(LOOP_ENV)))
    for got_row, want_row in zip([r for r in rows if r["agent"] == "OPD"], want):
        for column in ("budget", "seed", "length"):
            assert int(got_row[column]) == want_row[column]
        for column in ("total_reward", "return", "mean_return", "gap"):
            assert float(got_row[column]) == pytest.approx(want_row[column], abs=1e-6)
    assert (tmp_path / "simple_regret_vs_budget.png").is_file()


def test_robust_merge_study(tmp_path):
    """The MergeEnv robust-control benchmark (reference:
    scripts/configs/MergeEnv/benchmark_robust_control.json): 3 agents x 2
    envs, each a returns row."""
    runs = robust_study.main(["--study", "merge", "--seeds", "1", "--budget", "15",
                              "--horizon", "4", "--out", str(tmp_path), "--device", "cpu"])
    lines = (tmp_path / "results.csv").read_text().splitlines()
    assert lines[0] == "agent,environment,mean_return,std_return"
    rows = [ln.split(",") for ln in lines[1:]]
    assert len(rows) == 6
    assert {r[0] for r in rows} == {"assume_aggressive", "assume_defensive", "agg_def"}
    assert {r[1] for r in rows} == {"env_agg", "env_def"}
    assert all(float(r[2]) > 0 for r in rows)
    assert len(runs) == 6


def test_robust_toy_study(tmp_path):
    robust_study.main(["--seeds", "2", "--budget", "12", "--horizon", "5", "--out",
                       str(tmp_path), "--device", "cpu"])
    rows = [ln.split(",") for ln in (tmp_path / "results.csv").read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == ["nominal", "DROP"]
    assert all(np.isfinite(float(r[2])) and float(r[3]) >= 0 for r in rows)


def test_visualization_writes_each_planners_tree(tmp_path):
    paths = visualization.main(["--budget", "20", "--out", str(tmp_path), "--device", "cpu"])
    assert sorted(paths) == ["kl-olop", "opd", "uct"]
    assert all(path.is_file() and path.stat().st_size > 0 for path in paths.values())


def test_scripts_default_to_the_card(tmp_path):
    for module in (study, robust_study, visualization):
        assert module.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            study.main(["--agents", "OPD", "--budgets", "1", "--seeds", "1", "--out",
                        str(tmp_path)])
