"""The port's experiment CLI (``glass_tpu_torch/cli/glass_test.py``), its
configs and the utilities the CLI run leans on (checkpoints, AUROC, the
step meter), against glass_tpu's, on the CPU.

- The flat-config reader equals ``yaml.safe_load`` on the eight configs
  (values and types) and on extra scalar forms; the port's eight configs
  are byte-equal copies of ``glass_tpu/configs``.
- Each once-unported flag runs or raises what a launch needs:
  ``--autotune`` reuses its calibration file and plans under it;
  ``--ring`` and ``--sharding auto`` on a one-rank mesh train;
  ``--graph_shards``/``--data_shards`` > 1 without a process group raise
  naming the launch; the coordinator flags alone raise that they go
  together, and ``--multihost`` outside torchrun that its environment is
  missing (the multi-process runs are tests/test_torch_parallel.py's).
- ``main(["--device", "-1", ...])`` trains end to end on a density
  miniature; its best-val checkpoint serves through
  ``Predictor.from_checkpoint`` and loads into the JAX package's
  ``load_checkpoint`` (the ``params_to_flax`` layout). On 2 processes a
  run resumed with ``--resume`` ends as the uninterrupted run: every rank
  restores the run state, rank 0 alone writes it.
- AUROC equals sklearn's ``roc_auc_score`` (binary with ties, multilabel
  macro, multiclass one-vs-rest) within 1e-12. On a task with one class
  the port raises ``ValueError``, as sklearn did before it began to warn and
  return nan (1.9 here), and the protocol skips its AUROC line.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from sklearn.metrics import roc_auc_score

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.train import metrics as jmetrics
from glass_tpu.utils import checkpoint as jckpt
from glass_tpu.utils.profiling import StepMeter as JStepMeter
from glass_tpu_torch import GLASS, Predictor, build_graph
from glass_tpu_torch.cli import glass_test
from glass_tpu_torch.data.loaders import load_dataset
from glass_tpu_torch.train import metrics as tmetrics
from glass_tpu_torch.utils import checkpoint as tckpt
from glass_tpu_torch.utils.profiling import StepMeter

REPO = Path(__file__).resolve().parent.parent
JAX_CONFIGS = REPO / "glass_tpu" / "configs"
PORT_CONFIGS = REPO / "glass_tpu_torch" / "configs"
CONFIG_NAMES = ("component", "coreness", "cut_ratio", "density", "em_user",
                "hpo_metab", "hpo_neuro", "ppi_bp")


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_config_copy_is_byte_equal_and_reads_as_yaml(name):
    original = (JAX_CONFIGS / f"{name}.yml").read_bytes()
    assert (PORT_CONFIGS / f"{name}.yml").read_bytes() == original
    ref = yaml.safe_load(original.decode())
    out = glass_test.load_config(name, None)
    assert out == ref
    assert {k: type(v) for k, v in out.items()} == \
        {k: type(v) for k, v in ref.items()}


def test_port_has_exactly_the_eight_configs():
    assert sorted(p.stem for p in PORT_CONFIGS.glob("*.yml")) == \
        sorted(CONFIG_NAMES)
    assert ('glass_tpu_torch = ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp", '
            '"configs/*.yml"]') in (REPO / "pyproject.toml").read_text()


def test_flat_reader_matches_yaml_on_scalar_forms():
    text = ("a: 1\nb: 1.0\nc: .5\nd: -3\ne: true\nf: null\ng: foo bar\n"
            "h: '1'\ni: 1e-3\nj: 1.5e-3\nk: 0.0067\nl:\n# comment\n"
            "m: x # trailing\nn: +2\no: 1_000\np: No\nq: \"quoted\"\n\n")
    out = glass_test.read_flat_config(text)
    ref = yaml.safe_load(text)
    assert out == ref
    assert {k: type(v) for k, v in out.items()} == \
        {k: type(v) for k, v in ref.items()}


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "a: [1, 2]\n", "- 1\n",
                                  "a: |\n  x\n", "a: 1\na: 2\n", "just text\n"])
def test_flat_reader_refuses_what_is_not_flat(text):
    with pytest.raises(ValueError, match="flat"):
        glass_test.read_flat_config(text)


# ---------------------------------------------------------- unported flags


# what each flag that once raised naming "item 12" does now: the message it
# raises without a launch, or None where a one-rank mesh trains
PORTED_FLAGS = {"--multihost": "env:// rendezvous", "--coordinator": "go together",
                "--num_processes": "go together", "--process_id": "go together",
                "--graph_shards": "torchrun", "--data_shards": "torchrun",
                "--ring": None, "--sharding": None}


@pytest.mark.parametrize("flags,item", [
    (["--autotune"], "item 6"),
    (["--multihost"], "item 12"),
    (["--coordinator", "localhost:1"], "item 12"),
    (["--num_processes", "2"], "item 12"),
    (["--process_id", "0"], "item 12"),
    (["--graph_shards", "2"], "item 12"),
    (["--data_shards", "2"], "item 12"),
    (["--ring"], "item 12"),
    (["--sharding", "auto"], "item 12"),
], ids=lambda v: v if isinstance(v, str) else v[0])
def test_unported_flags_name_their_roadmap_item(flags, item, request,
                                                monkeypatch, tmp_path,
                                                capsys):
    """Once each raised NotImplementedError naming its ROADMAP item; each
    is ported now (module docstring)."""
    if flags == ["--autotune"]:
        # ported with the planner (once it raised naming item 6): the run
        # plans its layout under the calibration file, here one it reuses
        cal = tmp_path / "autotune.json"
        cal.write_text(json.dumps({"band_step_cost_s": 2e-7,
                                   "bcsr_step_cost_s": 9e-7,
                                   "stream_bps": 9e11}))
        monkeypatch.setenv("GLASS_TPU_AUTOTUNE", "")
        root = request.getfixturevalue("density_root")
        mean, _ = glass_test.main([
            "--dataset", "density", "--use_deg", "--device", "-1",
            "--max_epochs", "2", "--spmm", "pallas", "--data_root",
            str(root), *flags, "--autotune_file", str(cal)])
        assert f"using existing calibration {cal}" in capsys.readouterr().out
        assert os.environ["GLASS_TPU_AUTOTUNE"] == str(cal)
        assert np.isfinite(mean)
        return
    item = PORTED_FLAGS[flags[0]]
    if item is None:  # a one-rank mesh: the run trains
        root = request.getfixturevalue("density_root")
        mean, _ = glass_test.main([
            "--dataset", "density", "--use_deg", "--device", "-1",
            "--max_epochs", "2", "--data_root", str(root), *flags])
        assert np.isfinite(mean)
        return
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    root = request.getfixturevalue("density_root")
    with pytest.raises((ValueError, RuntimeError), match=item):
        glass_test.main(["--dataset", "density", "--use_one", "--device",
                         "-1", "--data_root", str(root), *flags])


def test_feature_flag_is_required():
    with pytest.raises(NotImplementedError, match="--use_deg"):
        glass_test.main(["--dataset", "density", "--device", "-1"])


def test_pretrained_table_dim_message(tmp_path):
    np.savez(tmp_path / "density_64.npz", embedding=np.zeros((10, 64), np.float32))
    with pytest.raises(FileNotFoundError, match="hidden_dim"):
        glass_test.load_pretrained_table(str(tmp_path), "density", 8)
    with pytest.raises(FileNotFoundError, match="gnn_emb"):
        glass_test.load_pretrained_table(str(tmp_path / "none"), "density", 8)
    np.testing.assert_array_equal(
        glass_test.load_pretrained_table(str(tmp_path), "density", 64),
        np.zeros((10, 64), np.float32))


# ------------------------------------------------------------- end to end


@pytest.fixture
def density_root(tmp_path):
    import networkx as nx

    rng = np.random.default_rng(0)
    n = 120
    g = nx.Graph()
    g.add_nodes_from(range(n))
    src = rng.integers(0, n, size=500)
    dst = rng.integers(0, n, size=500)
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    subg = [sorted(rng.choice(n, size=5, replace=False).tolist())
            for _ in range(200)]
    labels = ["A" if i % 2 else "B" for i in range(200)]
    d = tmp_path / "data" / "dataset_" / "density"
    d.mkdir(parents=True)
    np.save(d / "tmp.npy", {"G": g, "subG": subg, "subGLabel": labels})
    return tmp_path / "data"


def test_cli_trains_and_its_checkpoint_serves(tmp_path, density_root, capsys):
    ckpt_dir = tmp_path / "ckpt"
    mean, err = glass_test.main([
        "--dataset", "density", "--use_deg", "--use_maxzeroone",
        "--repeat", "2", "--max_epochs", "21", "--device", "-1",
        "--data_root", str(density_root), "--ckpt_dir", str(ckpt_dir),
        "--report_auroc",
    ])
    out = capsys.readouterr().out
    assert np.isfinite(mean) and 0.0 <= mean <= 1.0 and np.isfinite(err)
    for seed in (0, 1):
        assert f"(seed {seed})" in out
    assert "iter 20 loss" in out and "tst auroc" in out
    assert "average" in out and "throughput:" in out
    ckpt = ckpt_dir / "density_seed0_best.npz"
    assert ckpt.exists() and (ckpt_dir / "density_seed0_state.npz").exists()

    # the checkpoint serves through the port ...
    base = load_dataset("density", np.random.default_rng(0), str(density_root))
    base.set_degree_feature()
    cfg = glass_test.load_config("density", None)
    graph = build_graph(base.edge_index, base.edge_weight, base.n_node,
                        cfg["aggr"], device="cpu")
    model = GLASS(base.max_deg, cfg["hidden_dim"], cfg["conv_layer"], (1,),
                  (cfg["pool"],), z_ratio=cfg["z_ratio"], seed=5,
                  device="cpu")
    pred = Predictor.from_checkpoint(model, graph, torch.from_numpy(base.x),
                                     ckpt, device="cpu")
    logits = pred([[0, 1, 2], [5, 7]])
    assert logits.shape == (2, 1) and np.isfinite(logits).all()

    # ... and loads into the JAX package's checkpoint reader
    import jax
    import jax.numpy as jnp
    from glass_tpu.ops.graph import build_graph as jax_build_graph

    fm = FlaxGLASS(max_deg=base.max_deg, hidden_channels=cfg["hidden_dim"],
                   num_layers=cfg["conv_layer"], output_channels=(1,),
                   pools=(cfg["pool"],), z_ratio=cfg["z_ratio"])
    jg = jax_build_graph(base.edge_index, base.edge_weight, base.n_node,
                         cfg["aggr"])
    like = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jg,
                          jnp.asarray(base.x), jnp.asarray(np.array([[0, 1]])),
                          None)  # the parameter tree's shapes, not its values
    tree = jckpt.load_checkpoint(ckpt, like)
    flat = jckpt._flatten(tree)
    assert flat.keys() == tckpt.params_to_flax(model).keys()
    for k, v in tckpt.params_to_flax(model).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_two_process_resume_restores_every_rank(tmp_path, density_root):
    """glass_test on 2 processes (2 graph shards, gloo), stopped after
    epoch 10 and resumed with --resume to 21, ends as the uninterrupted
    run: rank 0's end line (but its train time) and average equal, and the
    final run state equal in every array. Every rank restores the run
    state (a rank that did not would train other epochs than its peer);
    rank 0 alone narrates."""
    from chip_smoke import END_LINE, run_ranks

    def launch(name, ckpt, epochs, *extra):
        argv = [sys.executable, "-m", "glass_tpu_torch.cli.glass_test",
                "--dataset", "density", "--use_deg", "--device", "-1",
                "--data_root", str(density_root), "--graph_shards", "2",
                "--max_epochs", str(epochs), "--ckpt_dir", str(ckpt),
                "--coordinator", f"file://{tmp_path / name}.rendezvous",
                "--num_processes", "2", "--cpu_collectives", "gloo", *extra]
        return run_ranks([argv + ["--process_id", str(i)] for i in range(2)],
                         [tmp_path / f"{name}{i}.log" for i in range(2)],
                         timeout=300, env=dict(OMP_NUM_THREADS="1"))

    a = launch("a", tmp_path / "a", 21)
    launch("b1", tmp_path / "b", 10)
    b = launch("b2", tmp_path / "b", 21, "--resume")
    assert "resumed at epoch 10" in b[0]
    assert "repeat 0" not in b[1] and "resumed" not in b[1]

    def ending(log):
        lines = log.splitlines()
        end = [m for m in map(END_LINE.match, lines) if m]
        assert len(end) == 1, lines[-5:]
        return ((end[0][1], end[0][3], end[0][4]),
                [l for l in lines if l.startswith("average ")])

    assert ending(b[0]) == ending(a[0])
    sa = np.load(tmp_path / "a" / "density_seed0_state.npz")
    sb = np.load(tmp_path / "b" / "density_seed0_state.npz")
    assert set(sa.files) == set(sb.files)
    for k in sa.files:
        if k == "__meta__":
            assert str(sa[k]) == str(sb[k])
        else:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# -------------------------------------------------------------- checkpoints


def test_params_to_flax_round_trips(tmp_path):
    model = GLASS(6, 16, 2, (3,), ("mean",), seed=3, device="cpu")
    flat = tckpt.params_to_flax(model)
    assert "/params/conv/input_emb/embedding" in flat
    assert flat["/params/conv/conv_0/trans_1/kernel"].shape == (16, 16)
    other = tckpt.params_from_flax(
        GLASS(6, 16, 2, (3,), ("mean",), seed=4, device="cpu"), flat)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    tckpt.save_checkpoint(tmp_path / "m", model)  # gets the .npz suffix
    assert [p.name for p in tmp_path.iterdir()] == ["m.npz"]
    loaded = tckpt.load_checkpoint(tmp_path / "m.npz")
    assert loaded.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k])


# ------------------------------------------------------------------- AUROC


def auroc_cases(rng):
    n = 60
    score = np.round(rng.normal(size=n), 1)  # ties
    yield "binary_ties", score, (rng.random(n) > 0.5).astype(np.float32)
    yield "multilabel", rng.normal(size=(n, 4)), \
        (rng.random((n, 4)) > 0.5).astype(np.float32)
    logits = rng.normal(size=(n, 5))
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    yield "multiclass", prob, np.arange(n) % 5


@pytest.mark.parametrize("case", ["binary_ties", "multilabel", "multiclass"])
def test_auroc_matches_sklearn(case):
    cases = {c[0]: c[1:] for c in auroc_cases(np.random.default_rng(0))}
    pred, label = cases[case]
    kw = dict(multi_class="ovr") if case == "multiclass" else {}
    assert tmetrics.auroc(pred, label) == pytest.approx(
        roc_auc_score(label, pred, **kw), abs=1e-12)


@pytest.mark.parametrize("shape", ["one_logit", "two_class", "multiclass",
                                   "multilabel"])
def test_auroc_from_logits_matches_jax(shape):
    rng = np.random.default_rng(1)
    n = 50
    if shape == "one_logit":
        logits, y = rng.normal(size=(n, 1)), (np.arange(n) % 2).astype(float)
    elif shape == "two_class":
        logits, y = rng.normal(size=(n, 2)), np.arange(n) % 2
    elif shape == "multiclass":
        logits, y = rng.normal(size=(n, 4)), np.arange(n) % 4
    else:
        logits = rng.normal(size=(n, 3))
        y = (rng.random((n, 3)) > 0.4).astype(np.float32)
    assert tmetrics.auroc_from_logits(logits, y) == pytest.approx(
        jmetrics.auroc_from_logits(logits, y), abs=1e-12)


def test_auroc_raises_where_sklearn_does():
    with pytest.raises(ValueError, match="one class"):
        tmetrics.auroc(np.arange(4.0), np.ones(4))
    with pytest.raises(ValueError, match="one class"):
        tmetrics.auroc(np.ones((4, 2)), np.array([[1, 0]] * 4))
    with pytest.raises(ValueError, match="Number of classes"):
        tmetrics.auroc(np.full((4, 3), 1 / 3), np.array([0, 1, 0, 1]))
    with pytest.raises(ValueError, match="one class"):
        tmetrics.auroc_from_logits(np.zeros((4, 1)), np.zeros(4))


def test_step_meter_matches_jax():
    a, b = JStepMeter(edges_per_step=1000, subgraphs_per_step=6), \
        StepMeter(edges_per_step=1000, subgraphs_per_step=6)
    for m in (a, b):
        m.steps, m._elapsed = 40, 0.25
    assert a.summary() == b.summary()
    assert (a.steps_per_s, a.edges_per_s, a.subgraphs_per_s) == \
        (b.steps_per_s, b.edges_per_s, b.subgraphs_per_s)
    b.start()
    b.tick(3)
    assert b.steps == 43 and b.seconds > 0.25
