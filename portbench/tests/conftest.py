import copy
import json

import pytest

from portbench.harness.spec import PACKAGE


@pytest.fixture
def dgde_tree():
    """The shipped configuration's tree, a fresh copy."""
    with open(PACKAGE / "configs" / "dgde.json") as f:
        return copy.deepcopy(json.load(f)["config"])
