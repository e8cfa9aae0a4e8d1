"""The port's batch-inference CLI (``glass_tpu_torch/cli/glass_predict.py``)
against ``glass_tpu.cli.glass_predict``, on the CPU.

A checkpoint written by the JAX experiment CLI (``glass_test --ckpt_dir``,
21 epochs on the density miniature of tests/test_torch_protocol.py) is
scored by both CLIs with ``--device -1 --logits``: on the test split and
on a ``--subgraphs`` TSV, on the default route and on the RCM route (the
"pallas" route with RCM, forced in both packages through ``_auto_route``;
both planners under the JAX constants). Held: the same number of rows, the
index, original node-id and prediction columns equal, the logits within
rtol 1e-4 (atol 1e-6 for logits near 0) of each other (f32 on two
frameworks, the tolerance of the other parity tests), and the split's
micro-F1 equal.
"""

import numpy as np
import pytest

from glass_tpu.cli import glass_predict as jpredict
from glass_tpu.cli import glass_test as jtest
from glass_tpu.train import protocol as jprotocol
from glass_tpu_torch.cli import glass_predict as tpredict
from glass_tpu_torch.train import protocol as tprotocol
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401
from test_torch_protocol import density_root  # noqa: F401

FLAGS = ["--dataset", "density", "--use_deg", "--use_maxzeroone",
         "--device", "-1", "--logits"]


@pytest.fixture
def jax_checkpoint(density_root, tmp_path):  # noqa: F811
    ckpt = tmp_path / "ckpt"
    jtest.main(FLAGS[:4] + ["--device", "-1", "--repeat", "1",
                            "--max_epochs", "21", "--data_root", density_root,
                            "--ckpt_dir", str(ckpt)])
    path = ckpt / "density_seed0_best.npz"
    assert path.exists()
    return density_root, str(path)


def score(cli, capsys, argv):
    """(rows split into columns, the return value, stderr)."""
    capsys.readouterr()
    ret = cli.main(argv)
    out, err = capsys.readouterr()
    return [line.split("\t") for line in out.splitlines()], ret, err


def assert_same_output(t, j):
    (trows, tret, terr), (jrows, jret, jerr) = t, j
    assert len(trows) == len(jrows) > 0
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3], (a, b)
        np.testing.assert_allclose(np.float64(a[3].split(",")),
                                   np.float64(b[3].split(",")),
                                   rtol=1e-4, atol=1e-6)
    assert tret == jret and terr == jerr


def write_subgraphs(path, rng, n=120, count=17):
    lines = []
    for _ in range(count):
        k = int(rng.integers(1, 8))
        nodes = rng.choice(n, k, replace=False)
        lines.append("-".join(map(str, nodes)) + "\tignored\tcolumns\n")
    path.write_text("".join(lines) + "\n")


@pytest.mark.parametrize("route", ["default", "rcm"])
@pytest.mark.parametrize("source", ["split", "subgraphs"])
def test_predict_matches_jax_cli(monkeypatch, capsys, tmp_path,
                                 jax_checkpoint, route, source):
    data_root, ckpt = jax_checkpoint
    argv = FLAGS + ["--data_root", data_root, "--ckpt", ckpt]
    if source == "subgraphs":
        tsv = tmp_path / "subgraphs.tsv"
        write_subgraphs(tsv, np.random.default_rng(4))
        argv += ["--subgraphs", str(tsv), "--batch_size", "5"]
    if route == "rcm":
        for module in (jprotocol, tprotocol):
            monkeypatch.setattr(module, "_auto_route",
                                lambda cfg, n, dev: ("pallas", True))
    t = score(tpredict, capsys, argv)
    j = score(jpredict, capsys, argv)
    assert_same_output(t, j)
    rows = t[0]
    assert [r[0] for r in rows] == [str(i) for i in range(len(rows))]
    if source == "subgraphs":
        # input order, original ids (the file's), one row per line
        want = [l.split("\t")[0] for l in tsv.read_text().splitlines() if l]
        assert [r[1] for r in rows] == want
        assert t[1] is None
    else:
        assert 0.0 <= t[1] <= 1.0 and "micro-F1" in t[2]


def test_predict_refuses_ids_outside_the_graph(tmp_path, jax_checkpoint):
    data_root, ckpt = jax_checkpoint
    tsv = tmp_path / "bad.tsv"
    tsv.write_text("3-120\n")
    with pytest.raises(ValueError, match="outside"):
        tpredict.main(FLAGS + ["--data_root", data_root, "--ckpt", ckpt,
                               "--subgraphs", str(tsv)])
