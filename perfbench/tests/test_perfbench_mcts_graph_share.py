"""The reader of ``planner.mcts_graph_share.batch`` on made-up counters of
the spanned pass: the replayed episodes over all episodes, in %, and None
where no episode was counted or the pass has nothing."""
import pytest

from perfbench.pbcore.manifest import Manifest
from perfbench.tests.conftest import ROOT


def share(counters):
    record = {"program": None if counters is None else {"counters": counters}}
    return Manifest(ROOT).module("metrics", "planner.mcts_graph_share.batch").read(record)


@pytest.mark.parametrize("counters, expected", [
    (None, None),
    ({}, None),
    ({"mcts.steps": 195, "host.syncs": 2}, None),
    ({"mcts.episode_graph.replays": 30, "mcts.steps": 390}, 100.0),
    ({"mcts.episode_eager.calls": 30, "mcts.steps": 390}, 0.0),
    ({"mcts.episode_graph.replays": 15, "mcts.episode_eager.calls": 5}, 75.0),
])
def test_the_share_of_replayed_episodes(counters, expected):
    assert share(counters) == expected
