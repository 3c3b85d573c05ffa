"""The reader of ``planner.olop_graph_share.batch`` on made-up counters of
the spanned pass: the replayed episodes over all episodes, in %, and None
where no episode was counted or the pass has nothing."""
import pytest

from perfbench.pbcore.manifest import Manifest
from perfbench.tests.conftest import ROOT


def share(counters):
    record = {"program": None if counters is None else {"counters": counters}}
    return Manifest(ROOT).module("metrics", "planner.olop_graph_share.batch").read(record)


@pytest.mark.parametrize("counters, expected", [
    (None, None),
    ({}, None),
    ({"kl_bound_indexed_.launches": 72, "host.syncs": 3}, None),
    ({"olop.episode_graph.replays": 72, "kl_bound_indexed_.launches": 72}, 100.0),
    ({"olop.episode_eager.calls": 72, "env.transition_kernel.launches": 432}, 0.0),
    ({"olop.episode_graph.replays": 3, "olop.episode_eager.calls": 1}, 75.0),
])
def test_the_share_of_replayed_episodes(counters, expected):
    assert share(counters) == expected
