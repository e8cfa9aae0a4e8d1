"""The port's multi-process bootstrap (``glass_tpu_torch/parallel/mesh.py``,
``multihost.py``), on the CPU.

``python -m glass_tpu_torch.parallel.multihost`` in 2 processes over gloo
(as tests/test_parallel.py::test_multihost_two_process_cluster_parity runs
JAX's): both ranks print equal losses, and they equal the one-process
``run_smoke`` within rtol 1e-6 with the smoke model's dropout (0.1) on,
since the masks are drawn for the whole graph and sliced. And the
bootstrap's refusals: JAX's mesh errors, more than one rank without a
process group (naming the launch), a rank of several devices, and a
partial set of coordinator flags.
"""

import re
import sys

import numpy as np
import pytest

from chip_smoke import run_ranks
from glass_tpu_torch.parallel import mesh as tmesh
from glass_tpu_torch.parallel.multihost import run_smoke

LOSSES = re.compile(r"step_loss=([\d.]+) epoch_loss=([\d.]+)")


@pytest.mark.parametrize("shards", [["--graph_shards", "2"],
                                    ["--data_shards", "2"]],
                         ids=["graph", "data"])
def test_two_process_run_equals_one_process(tmp_path, shards):
    cmd = [sys.executable, "-m", "glass_tpu_torch.parallel.multihost",
           "--coordinator", f"file://{tmp_path / 'rendezvous'}",
           "--num_processes", "2", "--cpu_collectives", "gloo",
           "--device", "-1", *shards]
    outs = run_ranks([cmd + ["--process_id", str(i)] for i in range(2)],
                     [tmp_path / f"rank{i}.log" for i in range(2)],
                     timeout=300, env=dict(OMP_NUM_THREADS="1"))
    losses = []
    for out in outs:
        m = LOSSES.search(out)
        assert m, out[-2000:]
        losses.append((float(m[1]), float(m[2])))
        assert "backend=gloo" in out
    assert losses[0] == losses[1]
    ref = run_smoke(1, 1, device="cpu")
    np.testing.assert_allclose(losses[0], [ref["step_loss"],
                                           ref["epoch_loss"]], rtol=1e-6)


def test_mesh_without_a_process_group():
    m = tmesh.make_mesh()
    assert (m.shape, m.data_rank, m.graph_rank, m.graph_group,
            m.data_group, m.backend) == ({"data": 1, "graph": 1}, 0, 0,
                                         None, None, None)
    with pytest.raises(ValueError, match="not divisible by graph_shards=2"):
        tmesh.make_mesh(graph_shards=2)
    with pytest.raises(RuntimeError, match="--num_processes N"):
        tmesh.make_mesh(graph_shards=2, data_shards=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh(graph_shards=1, data_shards=3)


def test_bootstrap_refusals():
    with pytest.raises(ValueError, match="owns one device"):
        tmesh.initialize_distributed(local_cpu_devices=2)
    with pytest.raises(ValueError, match="go together"):
        tmesh.initialize_distributed(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="go together"):
        tmesh.initialize_distributed(num_processes=2, process_id=0)
