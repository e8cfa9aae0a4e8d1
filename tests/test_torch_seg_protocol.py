"""The port's GNN-seg protocol and CLI against glass_tpu's, on the CPU
(``glass_tpu_torch/train/seg_protocol.py``, ``cli/gnn_seg.py``).

``run_seg_experiment`` runs in both packages with component's best
hyperparameters (1 GCN layer, hidden 16, dropout 0), the port from JAX's
initial parameters (``model.init(PRNGKey(0), ...)``, converted), on
miniatures the tests write under ``tmp_path``: a component-format
synthetic ("one" feature, 50/25/25 split re-drawn by the loader) and an
hpo_neuro-format SubGNN set (multilabel, "deg" feature). The window is
the whole run, LOSS_EPOCHS epochs (8 evals): every epoch's mean loss
within rtol 1e-5 and every log line equal (the iter lines, the loss to its
4 printed decimals, the end line, the scores); 40 epochs keep the test
short, and no early stop ends either run before them.

The CLI (``--device -1``) trains a density-format miniature on the gin
conv, prints JAX's log format and returns (mean, err).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.data.loaders import load_dataset as jax_load_dataset
from glass_tpu.data.seg import segregate as jax_segregate
from glass_tpu.nn.seg import GSegGNN as FlaxGSegGNN
from glass_tpu.train import seg_protocol as jseg
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch.cli import gnn_seg
from glass_tpu_torch.nn.seg import GSegGNN
from glass_tpu_torch.train import seg_protocol as tseg
from glass_tpu_torch.train.loop import LOSSES
from glass_tpu_torch.utils.checkpoint import params_from_flax
from glass_tpu_torch.utils.graphs import InferencePrograms, TrainingStep

from test_torch_protocol import write_subgnn

LOSS_RTOL = 1e-5
LOSS_EPOCHS = 40
ITER = re.compile(r"iter (\d+) loss (\S+) val (\S+) tst (\S+)$")


def write_synthetic(root, name, n=120, n_sub=80, seed=0):
    """A ``dataset_/{name}/tmp.npy`` as the reference bundles it: a
    networkx graph, subgraph node lists of 3-10 nodes, letter labels
    (two classes, by size)."""
    import networkx as nx

    rng = np.random.default_rng(seed)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(rng.integers(0, n, 4 * n).tolist(),
                         rng.integers(0, n, 4 * n).tolist()))
    subg = [sorted(rng.choice(n, size=rng.integers(3, 11),
                              replace=False).tolist()) for _ in range(n_sub)]
    labels = ["A" if len(s) > 6 else "B" for s in subg]
    d = root / "dataset_" / name
    d.mkdir(parents=True)
    np.save(d / "tmp.npy", {"G": g, "subG": subg, "subGLabel": labels})
    return root


@pytest.fixture(params=["component", "hpo_neuro"])
def mini(request, tmp_path, monkeypatch):
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    if request.param == "component":
        write_synthetic(tmp_path, "component")
    else:
        write_subgnn(tmp_path, "hpo_neuro", multilabel=True, n_nodes=60,
                     n_sub=60)
    return request.param, str(tmp_path)


def jax_initial_state(dataset, data_root, cfg):
    """JAX's initial parameters of repeat 0 as a port state dict (flax's
    init reads only the shapes of the training split)."""
    base = jax_load_dataset(dataset, np.random.default_rng(0), data_root)
    feature = "one" if dataset == "component" else "deg"
    trn = jax_segregate(base, feature)["train"]
    model = FlaxGSegGNN(hidden_channels=cfg["hidden_dim"],
                        output_channels=base.output_channels,
                        num_layers=cfg["conv_layer"], dropout=0.0,
                        activation="elu", conv="gcn")
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(trn.adj_norm),
                        jnp.asarray(trn.adj_sum), jnp.asarray(trn.feats),
                        jnp.asarray(trn.mask))
    port = GSegGNN(trn.feats.shape[-1], cfg["hidden_dim"],
                   base.output_channels, cfg["conv_layer"], device="cpu")
    return params_from_flax(port, _flatten(params)).state_dict()


def run(monkeypatch, module, cfg, **kw):
    """(log lines, per-epoch losses, result) of one package's run."""
    losses, logs = [], []
    real = module.plateau_step

    def plateau_step(state, loss, **k):
        losses.append(float(np.float32(loss)))
        return real(state, loss, **k)

    with monkeypatch.context() as m:
        m.setattr(module, "plateau_step", plateau_step)
        res = module.run_seg_experiment(cfg, log=logs.append, **kw)
    return [str(l) for l in logs], losses, res


def test_seg_protocol_matches_jax(monkeypatch, mini):
    dataset, root = mini
    hp = dict(tseg.BEST_HYPERPARAMS["component"])
    assert hp == jseg.BEST_HYPERPARAMS["component"] and hp["dropout"] == 0.0
    kw = dict(dataset=dataset, repeat=1, max_epochs=LOSS_EPOCHS,
              data_root=root, **hp)
    jlogs, jlosses, jres = run(monkeypatch, jseg, jseg.SegConfig(**kw))
    init = jax_initial_state(dataset, root, hp)
    tlogs, tlosses, tres = run(monkeypatch, tseg,
                               tseg.SegConfig(device="cpu", **kw),
                               init_state=init)
    assert len(jlosses) == LOSS_EPOCHS, "the early stop ended the JAX run"
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL, atol=0)
    assert jlosses[-1] < jlosses[0]
    assert sum(bool(ITER.match(l)) for l in jlogs) == LOSS_EPOCHS // 5
    assert tlogs == jlogs
    assert tres[1:] == pytest.approx(jres[1:], abs=0)


def test_best_hyperparams_match_jax():
    assert tseg.BEST_HYPERPARAMS == jseg.BEST_HYPERPARAMS
    fields = {f for f in tseg.SegConfig.__dataclass_fields__}
    assert fields - set(jseg.SegConfig.__dataclass_fields__) == {"device"}
    assert tseg.SegConfig(device="cpu").device == "cpu"


def test_gnn_seg_cli_on_density(tmp_path, capsys):
    write_synthetic(tmp_path, "density", seed=1)
    mean, err = gnn_seg.main(["--dataset", "density", "--device", "-1",
                              "--max_epochs", "11", "--repeat", "2",
                              "--test", "--data_root", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Namespace(")
    assert [l for l in out if l.startswith("repeat ")] == ["repeat 0",
                                                         "repeat 1"]
    iters = [ITER.match(l) for l in out if l.startswith("iter ")]
    assert iters and all(iters)
    assert sum(l.startswith("end: val ") for l in out) == 2
    assert out[-3] == f"{mean} {err}" and out[-2] == str(mean)
    assert out[-1] == f"best params {jseg.BEST_HYPERPARAMS['density']}"
    assert np.isfinite([mean, err]).all() and 0.0 <= mean <= 1.0


def seg_tensors(seed=0, s=40, l=6, f=5):
    """A random split of ``s`` padded subgraphs of up to ``l`` nodes."""
    rng = np.random.default_rng(seed)
    mask = rng.random((s, l)) < 0.8
    mask[:, 0] = True
    adj = (rng.random((s, l, l)) < 0.4) * mask[:, None, :] * mask[:, :, None]
    deg = np.maximum(adj.sum(-1, keepdims=True), 1)
    arrays = (adj / deg, adj.astype(np.float64), rng.random((s, l, f)), mask,
              (rng.random(s) < 0.5))
    dtypes = (np.float32, np.float32, np.float32, bool, np.float32)
    return tseg.SegTensors(*(torch.from_numpy(a.astype(d))
                             for a, d in zip(arrays, dtypes)))


def test_train_epoch_equals_the_per_step_formula():
    """train_epoch (a TrainingStep over (B,) rows gathered with
    index_select, the losses in an (nb,) device buffer) against the
    formula it replaced: per step ``take(idx)`` by indexing and
    ``train_step``, then ``torch.stack(losses).mean()``; from one state
    and dropout seed, dropout 0.4, 3 epochs of 4 steps: the epoch means
    and the parameters bit-equal."""
    data = seg_tensors()
    loss_fn = LOSSES["bce"]
    runs = []
    for new in (False, True):
        model = GSegGNN(5, 16, 1, 2, dropout=0.4, seed=0, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        gen = torch.Generator().manual_seed(3)
        step = TrainingStep(lambda idx: tseg.train_step(
            model, opt, loss_fn, data.take(idx), gen), opt, gen)
        rng = np.random.default_rng(1)
        means = []
        for _ in range(3):
            order = torch.from_numpy(rng.permutation(40)[:36].reshape(4, 9))
            if new:
                means.append(tseg.train_epoch(step, order))
            else:
                losses = [tseg.train_step(
                    model, opt, loss_fn,
                    tseg.SegTensors(*(t[idx] for t in data)), gen)
                    for idx in order]
                means.append(float(torch.stack(losses).mean()))
        runs.append((means, model.state_dict()))
    (old, p_old), (new, p_new) = runs
    assert new == old and len(set(new)) == 3
    for k, v in p_old.items():
        assert torch.equal(p_new[k], v), k


def test_infer_runs_one_program_a_batch_shape():
    """infer through InferencePrograms (eager on the CPU): the logits of
    the batches equal the plain forward's batch by batch, and a 10-row
    split in batches of 4 keeps one program for the full batches and one
    for the remainder."""
    data = seg_tensors(s=10)
    model = GSegGNN(5, 16, 3, 2, seed=0, device="cpu")
    programs = InferencePrograms(torch.device("cpu"))
    got = tseg.infer(model, data, 4, programs)
    with torch.no_grad():
        want = torch.cat([model(*(t[s:s + 4] for t in data[:4]))
                          for s in (0, 4, 8)])
    np.testing.assert_array_equal(got, want.numpy())
    assert got.shape == (10, 3)
    assert sorted(k[0][0][0] for k in programs.programs) == [2, 4]
