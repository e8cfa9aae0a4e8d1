"""The port's experiment protocol (``glass_tpu_torch/train/protocol.py``)
against glass_tpu's, on the CPU.

Parity: the same config runs through both protocols on the density
miniature of tests/test_cli.py (dropout 0 in the config, f32, 2 repeats, 25
epochs: with 200 subgraphs at batch 2 the eval gate opens at epoch 20) and
on SubGNN-format miniatures (binary and multilabel). The parity runs take
degree features (``--use_deg``): with ``--use_one`` every column of the
embedding's GraphNorm has zero variance, s = rsqrt(eps) ~ 316 amplifies the
rounding of the column mean, which the two frameworks sum in another order,
and the first step's loss already differs by 5.0e-4 relative (measured);
with degree features the two trajectories stay within 2.4e-7 of each other
in every parameter over 300 steps (measured). The JAX run's initial
parameters of each repeat are recorded and loaded into the port through
``protocol.init_params``, the hook the protocol draws a repeat's parameters
through. Held: every epoch's mean loss within rtol 1e-4, the val/tst scores
of every logged line and the final mean and error equal, and the log lines
alike in format. The numpy rng is drawn in the same order by both, so the
batches are the same.

On the port alone: the on-card metric path equals the host path, repeats
are deterministic with the cached trainer, a killed and resumed run equals
the uninterrupted one bit for bit (tests/test_protocol.py:107-141 for
JAX), the routing, the refusals of the sharded options and AUROC logging.
"""

import re

import numpy as np
import pytest
import torch

from glass_tpu.train import loop as jloop
from glass_tpu.train import protocol as jprotocol
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import params_from_flax
from glass_tpu_torch.ops.graph import DENSE_NODE_LIMIT, build_graph
from glass_tpu_torch.train import loop as tloop
from glass_tpu_torch.train import protocol as tprotocol

LOSS_RTOL = 1e-4
# the separable SubGNN miniatures train to losses of 1e-5 and below, where
# a loss is the f32 rounding of log1p(exp(-logit)) for logits near 11:
# measured at most 9.1e-8 apart there
LOSS_ATOL = 1e-6

DENSITY = dict(dataset="density", pool="size", aggr="sum", hidden_dim=8,
               conv_layer=1, dropout=0.0, lr=1e-3, z_ratio=1.0, batch_size=2,
               resi=0.9, feature="deg", use_maxzeroone=True)


@pytest.fixture
def density_root(tmp_path):
    """A dataset_/density/tmp.npy miniature, as tests/test_cli.py writes
    one (a networkx graph, 200 subgraphs of 5 nodes, letter labels)."""
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
    return str(tmp_path / "data")


def run_jax(monkeypatch, **kw):
    """(logs, epoch losses, {seed: flat initial params}, result)."""
    inits, losses = {}, []
    real_init = jloop.Trainer.init
    real_epoch = jloop.Trainer.train_epoch
    real_epochs = jloop.Trainer.train_epochs

    def init(self, seed, pos):
        out = real_init(self, seed, pos)
        inits[seed] = _flatten(out[0])
        return out

    def epoch(self, *a):
        out = real_epoch(self, *a)
        losses.append(float(out[-1]))
        return out

    def epochs(self, *a):
        out = real_epochs(self, *a)
        losses.extend(float(v) for v in out[-1])
        return out

    with monkeypatch.context() as m:
        m.setattr(jloop.Trainer, "init", init)
        m.setattr(jloop.Trainer, "train_epoch", epoch)
        m.setattr(jloop.Trainer, "train_epochs", epochs)
        logs = []
        res = jprotocol.run_experiment(jprotocol.ExperimentConfig(**kw),
                                       log=logs.append)
    return logs, losses, inits, res


def run_port(monkeypatch, inits=None, **kw):
    """(logs, epoch losses, result); with ``inits``, each repeat starts from
    the recorded JAX parameters of its seed."""
    losses = []
    real_epoch = tloop.Trainer.train_epoch

    def epoch(self, *a):
        out = real_epoch(self, *a)
        losses.append(out.loss)
        return out

    with monkeypatch.context() as m:
        m.setattr(tloop.Trainer, "train_epoch", epoch)
        if inits is not None:
            m.setattr(tprotocol, "init_params",
                      lambda model, cfg, base, mode, seed:
                      params_from_flax(model, inits[seed]))
        logs = []
        res = tprotocol.run_experiment(
            tprotocol.ExperimentConfig(device="cpu", **kw), log=logs.append)
    return [str(l) for l in logs], losses, res


ITER = re.compile(r"iter (\d+) loss (\S+) val (\S+) tst (\S+)$")


def assert_same_trajectory(jlogs, jlosses, jres, tlogs, tlosses, tres):
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    jl = [str(l) for l in jlogs if not l.startswith(("end:", "throughput:"))]
    tl = [l for l in tlogs if not l.startswith(("end:", "throughput:"))]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        ma, mb = ITER.match(a), ITER.match(b)
        if ma is None:
            assert a == b
            continue
        assert mb is not None, b
        assert (ma[1], ma[3], ma[4]) == (mb[1], mb[3], mb[4]), (a, b)
        assert float(mb[2]) == pytest.approx(float(ma[2]), abs=1.01e-4)
    assert any(ITER.match(l) for l in tl)
    for prefix in ("end: epoch", "throughput: "):
        assert sum(l.startswith(prefix) for l in tl + tlogs) == \
            sum(str(l).startswith(prefix) for l in jlogs)
    assert tres == jres


def test_protocol_matches_jax_on_density(monkeypatch, density_root):
    kw = dict(DENSITY, repeat=2, max_epochs=25, data_root=density_root)
    jlogs, jlosses, inits, jres = run_jax(monkeypatch, **kw)
    assert sorted(inits) == [0, 1] and len(jlosses) == 50
    tlogs, tlosses, tres = run_port(monkeypatch, inits, **kw)
    assert_same_trajectory(jlogs, jlosses, jres, tlogs, tlosses, tres)


def write_subgnn(root, name, multilabel, n_nodes=40, n_sub=30, seed=0):
    """tests/test_protocol_real.py::write_dataset's recipe."""
    rng = np.random.default_rng(seed)
    d = root / "dataset" / name
    d.mkdir(parents=True)
    half = n_nodes // 2
    edges = []
    for _ in range(n_nodes * 4):
        edges.append(tuple(rng.integers(0, half, size=2)))
        edges.append(tuple(rng.integers(half, n_nodes, size=2)))
    lines = []
    for i in range(n_sub):
        com = i % 2
        lo, hi = (0, half) if com == 0 else (half, n_nodes)
        nodes = rng.choice(np.arange(lo, hi), size=5, replace=False)
        lab = ["A", "B"][com]
        if multilabel and com == 0:
            lab = "A-C"
        split = ["train"] * 3 + ["val", "test"]
        lines.append(f"{'-'.join(map(str, nodes))}\t{lab}\t{split[i % 5]}\n")
    (d / "subgraphs.pth").write_text("".join(lines))
    (d / "edge_list.txt").write_text("".join(f"{a} {b}\n" for a, b in edges))


@pytest.mark.parametrize("name,multilabel",
                         [("ppi_bp", False), ("hpo_neuro", True)])
def test_protocol_matches_jax_on_subgnn_data(monkeypatch, tmp_path, name,
                                             multilabel):
    write_subgnn(tmp_path, name, multilabel)
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    kw = dict(dataset=name, pool="sum", aggr="mean", hidden_dim=8,
              conv_layer=1, dropout=0.0, lr=1e-2, z_ratio=0.9, batch_size=3,
              resi=0.7, feature="deg", use_maxzeroone=True, repeat=1,
              max_epochs=60, data_root=str(tmp_path), report_auroc=True)
    jlogs, jlosses, inits, jres = run_jax(monkeypatch, **kw)
    tlogs, tlosses, tres = run_port(monkeypatch, inits, **kw)
    assert any("tst auroc" in l for l in tlogs)
    assert_same_trajectory(jlogs, jlosses, jres, tlogs, tlosses, tres)


def test_device_metrics_match_host_metrics(monkeypatch, density_root):
    kw = dict(DENSITY, repeat=1, max_epochs=21, data_root=density_root)
    runs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("GLASS_TPU_HOST_EVAL_METRICS", mode)
        logs, _, res = run_port(monkeypatch, **kw)
        runs[mode] = (res, [l for l in logs if l.startswith("iter")])
    assert runs["0"] == runs["1"]
    assert runs["0"][1]


def test_repeats_deterministic_with_trainer_cache(monkeypatch, density_root):
    kw = dict(DENSITY, repeat=2, max_epochs=21, data_root=density_root)
    _, l1, r1 = run_port(monkeypatch, **kw)
    _, l2, r2 = run_port(monkeypatch, **kw)
    assert r1 == r2 and l1 == l2


def test_kill_and_resume_bit_equivalence(monkeypatch, tmp_path, density_root):
    """A run stopped after epoch 10 and resumed to 20 equals the
    uninterrupted 20-epoch run: the same score, the same final run state in
    every array and in its metadata."""
    kw = dict(DENSITY, repeat=1, data_root=density_root, dropout=0.3)
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    _, la, ra = run_port(monkeypatch, max_epochs=21, ckpt_dir=str(dir_a), **kw)
    run_port(monkeypatch, max_epochs=10, ckpt_dir=str(dir_b), **kw)
    logs, lb, rb = run_port(monkeypatch, max_epochs=21, ckpt_dir=str(dir_b),
                            resume=True, **kw)
    assert any("resumed at epoch 10" in l for l in logs), logs[:3]
    assert rb == ra and lb == la[10:]
    sa = np.load(dir_a / "density_seed0_state.npz")
    sb = np.load(dir_b / "density_seed0_state.npz")
    assert set(sa.files) == set(sb.files)
    assert any(k.startswith("adam/") for k in sa.files)
    for k in sa.files:
        if k == "__meta__":
            assert str(sa[k]) == str(sb[k])
        else:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert (dir_a / "density_seed0_best.npz").exists()


def test_auto_route_gate():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    big = DENSE_NODE_LIMIT + 1
    cfg = tprotocol.ExperimentConfig(dataset="density", spmm_mode=None)
    assert tprotocol._auto_route(cfg, big, cuda) == ("pallas", True)
    assert tprotocol._auto_route(cfg, big, cpu) == (None, False)
    assert tprotocol._auto_route(cfg, 100, cuda) == (None, False)
    seg = tprotocol.ExperimentConfig(dataset="density", spmm_mode="segment")
    assert tprotocol._auto_route(seg, big, cuda) == ("segment", False)
    # the routed graph with the default layout: the planner is unported,
    # and the refusal names the command-line fix
    with pytest.raises(NotImplementedError, match="--sparse_layout band|bcsr"):
        build_graph(np.zeros((2, 0), np.int64), None, 4, "gcn",
                    materialize_bcsr=True, sparse_layout="auto", device="cpu")


@pytest.mark.parametrize("option", [dict(graph_shards=2), dict(data_shards=2),
                                    dict(ring=True), dict(sharding="auto")],
                         ids=["graph_shards", "data_shards", "ring",
                              "sharding"])
def test_sharded_options_raise(option):
    cfg = tprotocol.ExperimentConfig(device="cpu", **option)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tprotocol.run_experiment(cfg, log=lambda *_: None)


def test_inert_sparse_layout_warns(monkeypatch, density_root):
    logs, _, _ = run_port(monkeypatch, **dict(
        DENSITY, repeat=1, max_epochs=2, data_root=density_root,
        sparse_layout="band"))
    assert any("no effect" in l for l in logs), logs[:5]


def test_rcm_route_runs(monkeypatch, density_root):
    """rcm=True relabels the nodes through the port's RCM (the scipy
    branch) and trains to a score in [0, 1]."""
    _, losses, (scores, mean, _) = run_port(monkeypatch, **dict(
        DENSITY, repeat=1, max_epochs=21, data_root=density_root, rcm=True))
    assert len(losses) == 21 and np.isfinite(losses).all()
    assert 0.0 <= mean <= 1.0


def test_pretrained_embedding_is_loaded(monkeypatch, density_root):
    emb = np.random.default_rng(0).normal(size=(120, 8)).astype(np.float32)
    seen = []
    real = tprotocol._load_pretrained_embedding

    def spy(model, table):
        real(model, table)
        seen.append(model.conv.input_emb.weight.detach().numpy().copy())

    monkeypatch.setattr(tprotocol, "_load_pretrained_embedding", spy)
    run_port(monkeypatch, **dict(DENSITY, repeat=1, max_epochs=1,
                                 data_root=density_root, feature="nodeid",
                                 node_emb=emb))
    np.testing.assert_array_equal(seen[0], emb)
