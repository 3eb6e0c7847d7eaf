"""tests/test_fuzz.py's random graphs through the PyTorch port, on the CPU:
the second half of its rgba32f seeds against the JAX package per node
(tests/test_torch_fuzz.py holds the first), and its sharded graphs on 2, 3
and 8 row slabs of the CPU (``HaloShardedProgram``) against the port
unsharded.
"""

import numpy as np
import pytest
import torch

from reforge_tpu_torch.parallel import HaloShardedProgram, make_row_mesh

import test_fuzz as ref
from test_torch_fuzz import _image, _port, _quiet, check_random_graph  # noqa: F401


@pytest.mark.parametrize("seed", range(12, 24))
def test_random_graph_renders(seed):
    check_random_graph(seed)


@pytest.mark.parametrize("slabs", [2, 3, 8])
@pytest.mark.parametrize("seed", range(6))
def test_random_graph_halo_sharded(seed, slabs):
    """test_fuzz.py's sharded graphs (seeds 4000 + k) on 2, 3 and 8 row
    slabs of the CPU (H = 24 divides each) through HaloShardedProgram,
    against the port unsharded."""
    cfg_text = ref._random_config(np.random.default_rng(4000 + seed))
    prog, img = _port(cfg_text, "rgba32f"), _image()
    x = torch.from_numpy(img.copy())
    whole = prog(x, 0.25).numpy()
    sharded = HaloShardedProgram(prog, make_row_mesh(slabs, ["cpu"] * slabs))
    got = sharded(sharded.shard_input(x), 0.25).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-4, err_msg=cfg_text)
