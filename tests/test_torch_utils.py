"""The port's ``utils/assignment.py`` and ``utils/misc.py`` against the JAX
package's: the Hungarian solver equal to JAX's and to scipy's
``linear_sum_assignment`` on random square and rectangular costs (and on
ties), the transport-matrix assignment, and the seeding, source backup and
dataset catalog."""

import os
import random

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from dcd_tpu.utils import assignment as jax_assignment
from dcd_tpu.utils import misc as jax_misc
from dcd_tpu_torch.utils import assignment, misc
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("shape", [(1, 1), (5, 5), (7, 12), (12, 7), (30, 30), (3, 40)])
def test_hungarian_matches_jax_and_scipy(shape):
    rng = np.random.RandomState(sum(shape))
    for trial in range(5):
        cost = rng.rand(*shape) if trial < 4 else rng.randint(0, 3, shape).astype(np.float64)
        r, c = assignment.hungarian_assignment(cost)
        jr, jc = jax_assignment.hungarian_assignment(cost)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)
        sr, sc = linear_sum_assignment(cost)
        assert len(r) == min(shape) and len(set(c.tolist())) == len(c)
        np.testing.assert_allclose(cost[r, c].sum(), cost[sr, sc].sum(), rtol=1e-12)
        if trial < 4:  # a unique optimum: the same pairs
            np.testing.assert_array_equal(r, sr)
            np.testing.assert_array_equal(c, sc)


def test_assignment_from_transport_and_empty():
    P = np.random.RandomState(3).rand(6, 9)
    for a, b in zip(assignment.assignment_from_transport(P),
                    jax_assignment.assignment_from_transport(P)):
        np.testing.assert_array_equal(a, b)
    r, c = assignment.hungarian_assignment(np.zeros((0, 4)))
    assert r.shape == c.shape == (0,)


def test_seed_all_rng_seeds_torch_numpy_and_random():
    assert misc.seed_all_rng(123) == 123
    draws = (random.random(), np.random.rand(), torch.rand(1).item())
    misc.seed_all_rng(123)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == draws
    assert jax_misc.seed_all_rng(123) == 123
    assert (random.random(), np.random.rand()) == draws[:2]  # JAX's seeds the same two
    fresh = misc.seed_all_rng(None)
    assert 0 <= fresh < 2**31 and misc.seed_all_rng(-1) >= 0


def test_backup_source_tree_and_catalog(tmp_path):
    src = tmp_path / "src"
    for rel in ("a.py", "pkg/b.yaml", "pkg/c.bin", "__pycache__/d.py", ".git/e.py", "logs/f.md"):
        os.makedirs((src / rel).parent, exist_ok=True)
        (src / rel).write_text(rel)
    got = misc.backup_source_tree(str(src), str(tmp_path / "out"))
    want = jax_misc.backup_source_tree(str(src), str(tmp_path / "jax_out"))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(got) == files(want) == ["a.py", os.path.join("pkg", "b.yaml")]
    assert misc.DATASET_CATALOG == jax_misc.DATASET_CATALOG
    for name in misc.DATASET_CATALOG:
        assert misc.resolve_dataset(name, "/data") == jax_misc.resolve_dataset(name, "/data")
    with pytest.raises(KeyError, match="unknown dataset"):
        misc.resolve_dataset("nuscenes", "/data")
