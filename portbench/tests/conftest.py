"""The CPU tests draw the tiny model's weights at tiny.TINY_STD; the tests
marked `cuda` run the cells' own sizes and draw them as the benchmark does."""

import pytest

from portbench import weights
from portbench.tests.tiny import TINY_STD


@pytest.fixture(autouse=True)
def tiny_weights(request, monkeypatch):
    if request.node.get_closest_marker("cuda") is None:
        monkeypatch.setattr(weights, "STD", TINY_STD)
