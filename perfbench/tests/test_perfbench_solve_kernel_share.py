"""The reader of ``planner.solve_kernel_share.batch`` on made-up counters of
the spanned pass: the solves that launched the kernel over all solves, in %,
and None where no solve was counted or the pass has nothing."""
import pytest

from perfbench.pbcore.manifest import Manifest
from perfbench.tests.conftest import ROOT


def share(counters):
    record = {"program": None if counters is None else {"counters": counters}}
    return Manifest(ROOT).module("metrics", "planner.solve_kernel_share.batch").read(record)


@pytest.mark.parametrize("counters, expected", [
    (None, None),
    ({}, None),
    ({"newton_iteration.trips": 840, "host.syncs": 5}, None),
    ({"max_expectation_under_constraint.kernel_launches": 105, "gape.steps": 105}, 100.0),
    ({"max_expectation_under_constraint.eager_calls": 105, "newton_iteration.trips": 840}, 0.0),
    ({"max_expectation_under_constraint.kernel_launches": 3,
      "max_expectation_under_constraint.eager_calls": 1}, 75.0),
])
def test_the_share_of_solves_that_launched_the_kernel(counters, expected):
    assert share(counters) == expected
