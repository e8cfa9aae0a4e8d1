"""The port's SSL pretraining protocol, search and CLI against glass_tpu's,
on the CPU (``glass_tpu_torch/train/ssl.py``, ``train/tpe.py``,
``compat/optuna_lite.py``, ``cli/gnn_emb.py``).

``pretrain_once`` runs in both packages from the same initial parameters
(JAX's ``model.init(PRNGKey(seed), ...)``, converted) with dropout 0, on
the same graph and seed: every per-batch loss within rtol 1e-5, every val
F1 equal, the best table within 1e-5 x max|table|, over 6 epochs of 6
batches (on the 1,000-node band, JAX's own "pallas" run drifts from its
dense run by 4.4e-6 relative by step 36 and 2.1e-5 by step 66: Adam
carries the band kernel's rounding on; the port's follows JAX's dense
run within 1.3e-6 over 66 steps). The shim's samplers
draw JAX's draws for the same seeds and histories, and its sqlite study
resumes without optuna, as ``tests/test_ssl.py`` holds the JAX one. The
CLI writes a table on the CPU that the port's ``glass_test --use_nodeid``
trains from.
"""

import builtins
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.compat import optuna_lite as jlite
from glass_tpu.data.basegraph import BaseGraphData as JaxBase
from glass_tpu.nn.pretrain import EdgeGNN as FlaxEdgeGNN
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.train import ssl as jssl
from glass_tpu.train.tpe import TPESampler as JaxTPE
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch.compat import optuna_lite as tlite
from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.nn.pretrain import EdgeGNN
from glass_tpu_torch.train import ssl as tssl
from glass_tpu_torch.train.tpe import TPESampler
from glass_tpu_torch.utils.checkpoint import params_from_flax

# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401
from test_torch_protocol import write_subgnn
from test_torch_ssl import undirected_edges

LOSS_RTOL, TABLE_TOL = 1e-5, 1e-5


class Recorder:
    """Wraps a ssl module's ``plateau_step`` and ``binary_f1`` while a run
    lasts: every batch's loss, every val F1."""

    def __init__(self, monkeypatch, module):
        self.losses, self.scores = [], []
        real_step, real_f1 = module.plateau_step, module.binary_f1

        def plateau_step(state, loss, **kw):
            self.losses.append(float(np.float32(loss)))
            return real_step(state, loss, **kw)

        def binary_f1(pred, label):
            self.scores.append(real_f1(pred, label))
            return self.scores[-1]

        monkeypatch.setattr(module, "plateau_step", plateau_step)
        monkeypatch.setattr(module, "binary_f1", binary_f1)


def banded_edges(rng, n, width=60):
    """A symmetric (2, E) edge list within ``width`` of the diagonal, no
    duplicates or self-loops: both planners give it a band."""
    r = rng.integers(0, n, 4 * n)
    c = np.clip(r + rng.integers(-width, width + 1, 4 * n), 0, n - 1)
    ei = np.stack([r, c])[:, r != c]
    return np.unique(np.concatenate([ei, ei[::-1]], axis=1).T, axis=0).T.copy()


def ssl_bases(seed=0, n=300, banded=False):
    rng = np.random.default_rng(seed)
    ei = banded_edges(rng, n) if banded else undirected_edges(rng, n=n, e=2400)
    kw = dict(x=np.zeros((n, 1), np.int64), edge_index=ei,
              edge_weight=np.ones(ei.shape[1], np.float32),
              pos=np.zeros((1, 2), np.int64), y=np.zeros(1),
              mask=np.zeros(1, np.int64))
    jb, tb = JaxBase(**kw), BaseGraphData(**kw)
    jb.set_node_id_feature()
    tb.set_node_id_feature()
    return jb, tb


def flax_init_state(cfg, jb, seed):
    """The port's state dict of JAX's initial parameters in
    ``pretrain_once`` (``model.init(PRNGKey(seed), graph, x, pos[:2])``;
    flax's init reads only shapes of the graph and the pairs)."""
    graph = jax_build_graph(jb.edge_index, jb.edge_weight, jb.n_node,
                            cfg.aggr, materialize_dense=True)
    model = FlaxEdgeGNN(max_deg=jb.max_deg, hidden_channels=cfg.hidden_dim,
                        num_layers=cfg.conv_layer, dropout=cfg.dropout,
                        activation="relu", jk=bool(cfg.jk),
                        spmm_mode=cfg.spmm_mode)
    params = model.init(jax.random.PRNGKey(seed), graph,
                        jnp.asarray(jb.x.astype(np.int32)),
                        jnp.zeros((2, 2), jnp.int32))
    port = EdgeGNN(jb.max_deg, cfg.hidden_dim, cfg.conv_layer,
                   dropout=cfg.dropout, jk=bool(cfg.jk),
                   spmm_mode=cfg.spmm_mode, device="cpu")
    return params_from_flax(port, _flatten(params)).state_dict()


@pytest.mark.parametrize("spmm_mode, aggr, jk, n", [
    (None, "mean", 0, 300),       # dense below 8,192 nodes, as JAX routes it
    ("segment", "gcn", 1, 300),
    ("pallas", "mean", 0, 1000),  # the planner's band and its transpose
])
def test_pretrain_once_matches_jax(monkeypatch, spmm_mode, aggr, jk, n):
    jb, tb = ssl_bases(n=n, banded=spmm_mode == "pallas")
    graphs = []
    real_build = tssl.build_graph

    def build_graph(*a, **kw):
        graphs.append(real_build(*a, **kw))
        return graphs[-1]

    monkeypatch.setattr(tssl, "build_graph", build_graph)
    kw = dict(dataset="unused", hidden_dim=8, conv_layer=2, dropout=0.0,
              aggr=aggr, jk=jk, lr=1e-3, batch_size=512, max_epochs=6,
              batches_per_epoch=6, eval_every=5, early_stop=100,
              spmm_mode=spmm_mode)
    seed = 3
    jcfg = jssl.SSLConfig(**kw)
    tcfg = tssl.SSLConfig(**kw, device="cpu")
    jrec, trec = Recorder(monkeypatch, jssl), Recorder(monkeypatch, tssl)
    jlogs, tlogs = [], []
    j_score, j_table = jssl.pretrain_once(jcfg, jb, seed, log=jlogs.append)
    t_score, t_table = tssl.pretrain_once(
        tcfg, tb, seed, log=tlogs.append,
        init_state=flax_init_state(jcfg, jb, seed))
    assert len(trec.losses) == len(jrec.losses) == 6 * 6
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_RTOL,
                               atol=0)
    assert trec.losses[-1] < trec.losses[0]
    assert len(trec.scores) == 2 and trec.scores == jrec.scores
    assert t_score == j_score > 0.5
    if spmm_mode == "pallas":
        g = graphs[0]
        assert g.plan == "band" and g.band_t is not g.band
    assert t_table.shape == j_table.shape == (n, 8 * (2 if jk else 1))
    scale = float(np.abs(j_table).max())
    assert float(np.abs(t_table - j_table).max()) <= TABLE_TOL * scale
    assert [l.split()[:2] for l in tlogs] == [l.split()[:2] for l in jlogs]


def test_pretrain_once_draws_its_own_parameters_from_the_seed():
    """Without an initial state the parameters come from ``seed``: two runs
    of one seed give one table, bit for bit, on the dense path; the early
    stop ends the run."""
    _, tb = ssl_bases(seed=1, n=120)
    cfg = tssl.SSLConfig(dataset="unused", hidden_dim=8, conv_layer=2,
                         dropout=0.3, batch_size=256, max_epochs=40,
                         batches_per_epoch=2, eval_every=2, early_stop=2,
                         spmm_mode="dense", device="cpu")
    logs = []
    a = tssl.pretrain_once(cfg, tb, 5, log=logs.append)
    b = tssl.pretrain_once(cfg, tb, 5, log=lambda *_: None)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert len(logs) < 40  # stopped early: 2 evals without a better score


def test_pretrain_once_on_segment_is_bit_reproducible_on_the_cpu(
        monkeypatch):
    """Two runs of one seed and state on the "segment" path give one loss
    trajectory and one table, bit for bit, on all CPU threads: without
    that, Adam turns a run's rounding noise into another trajectory (a
    1e-7 change of the initial state moves the table by 7e-4 of its size
    on the segment parity case above)."""
    jb, tb = ssl_bases(n=300)
    kw = dict(dataset="unused", hidden_dim=8, conv_layer=2, dropout=0.0,
              aggr="gcn", jk=1, lr=1e-3, batch_size=512, max_epochs=2,
              batches_per_epoch=6, eval_every=5, early_stop=100,
              spmm_mode="segment")
    init = flax_init_state(jssl.SSLConfig(**kw), jb, 3)
    rec = Recorder(monkeypatch, tssl)
    tables = [tssl.pretrain_once(tssl.SSLConfig(**kw, device="cpu"), tb, 3,
                                 log=lambda *_: None, init_state=init)[1]
              for _ in range(3)]
    steps = len(rec.losses) // 3
    assert steps == 2 * 6
    for k in (1, 2):
        assert rec.losses[k * steps:(k + 1) * steps] == rec.losses[:steps]
        np.testing.assert_array_equal(tables[k], tables[0])


def test_batches_gathered_on_the_device_are_the_host_gather(monkeypatch):
    """pretrain_once gathers each batch on the device from the resident
    training pairs, by the slice of the epoch's permutation it copied: the
    pairs and labels are those the host's numpy gather
    ``pos_trn[order[ib * bs:(ib + 1) * bs]]`` selects, epoch by epoch, in
    the JAX protocol's rng order."""
    _, tb = ssl_bases(n=120)
    cfg = tssl.SSLConfig(dataset="unused", hidden_dim=8, conv_layer=2,
                         dropout=0.3, batch_size=200, max_epochs=3,
                         batches_per_epoch=4, eval_every=5, early_stop=100,
                         spmm_mode="dense", device="cpu")
    seen = []
    real_forward, real_bce = EdgeGNN.forward, tssl.bce_with_logits

    def forward(model, graph, x, pos, *, training=False, generator=None):
        if training:
            seen.append([pos.clone()])
        return real_forward(model, graph, x, pos, training=training,
                            generator=generator)

    def bce(logits, y):
        seen[-1].append(y.clone())
        return real_bce(logits, y)

    monkeypatch.setattr(EdgeGNN, "forward", forward)
    monkeypatch.setattr(tssl, "bce_with_logits", bce)
    tssl.pretrain_once(cfg, tb, 4, log=lambda *_: None)

    rng = np.random.default_rng(4)
    pos_all, y_all = tb.get_lp_dataset(rng)
    perm = rng.permutation(pos_all.shape[0])
    trn = perm[: int(0.95 * perm.shape[0])]
    pos_trn, y_trn = pos_all[trn], y_all[trn]
    bs = min(cfg.batch_size, trn.shape[0])
    nb = min(cfg.batches_per_epoch, trn.shape[0] // bs or 1)
    want = []
    for _ in range(cfg.max_epochs):
        order = rng.permutation(trn.shape[0])
        want += [order[ib * bs: (ib + 1) * bs] for ib in range(nb)]
    assert nb == 4 and len(seen) == len(want) == 3 * nb
    for (pos, y), sel in zip(seen, want):
        np.testing.assert_array_equal(pos.numpy(), pos_trn[sel])
        np.testing.assert_array_equal(y.numpy(), y_trn[sel])


# ------------------------------------------------------------- the search

def test_tpe_sampler_draws_jax_draws():
    space = dict(a=[0, 1, 2, 3], b=["x", "y", "z"])
    rng = np.random.default_rng(7)
    hist = []
    for t in range(40):
        want = JaxTPE(seed=3, n_startup=8).suggest(space, hist, t)
        got = TPESampler(seed=3, n_startup=8).suggest(space, hist, t)
        assert got == want
        hist.append({"params": got, "score": float(rng.normal())})


@pytest.mark.parametrize("sampler", ["tpe", "random"])
@pytest.mark.parametrize("direction", ["maximize", "minimize"])
def test_lite_samplers_draw_jax_draws(sampler, direction):
    def obj(trial):
        a = trial.suggest_categorical("a", ["x", "y", "z"])
        k = trial.suggest_int("k", 2, 5)
        d = trial.suggest_float("d", 0.0, 0.5, step=0.1)
        return (1.0 if a == "y" else 0.0) + k * 0.01 - d * 0.001

    studies = []
    for lite in (jlite, tlite):
        s = (lite.LiteTPESampler(seed=2, n_startup=5) if sampler == "tpe"
             else lite.LiteRandomSampler(seed=2))
        st = lite.create_study(direction, None, "demo", sampler=s)
        st.optimize(obj, n_trials=20)
        studies.append([(t.number, t.params, t.value) for t in st.trials])
    assert studies[0] == studies[1]


@pytest.fixture
def no_optuna(monkeypatch):
    """``import optuna`` raises, whether or not it is installed: the port's
    search runs on its sqlite shim alone."""
    real_import = builtins.__import__

    def guarded(name, *a, **k):
        if name == "optuna":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)


def test_hpo_random_search_resumes_from_study_file(tmp_path, monkeypatch,
                                                   no_optuna):
    """tests/test_ssl.py's random-search resume, on the port."""
    calls = []

    def fake_pretrain(trial_cfg, log=print):
        calls.append(trial_cfg)
        return 0.5 + 0.01 * len(calls), np.zeros((4, 2), np.float32)

    monkeypatch.setattr(tssl, "pretrain", fake_pretrain)
    cfg = tssl.SSLConfig(dataset="stub", hidden_dim=2)
    storage = f"sqlite:///{tmp_path / 'study.db'}"
    saved = []
    best1 = tssl.run_hpo(cfg, 4, saved.append, log=lambda *_: None,
                         storage=storage, sampler="random")
    assert len(calls) == 4 and (tmp_path / "study.db").exists()
    logs = []
    best2 = tssl.run_hpo(cfg, 6, saved.append, log=logs.append,
                         storage=storage, sampler="random")
    assert len(calls) == 6
    assert any("resumed study: 4 completed trials" in l for l in logs)
    assert best2["score"] >= best1["score"]
    ref_storage = f"sqlite:///{tmp_path / 'ref.db'}"
    tssl.run_hpo(cfg, 6, lambda e: None, log=lambda *_: None,
                 storage=ref_storage, sampler="random")
    got = tlite.create_study("maximize", storage, "stub", load_if_exists=True)
    ref = tlite.create_study("maximize", ref_storage, "stub",
                             load_if_exists=True)
    assert [t.params for t in got.trials] == [t.params for t in ref.trials]


def test_hpo_tpe_resumes_from_study_file_as_jax_does(tmp_path, monkeypatch,
                                                     no_optuna):
    """tests/test_ssl.py's TPE resume, on the port; and the port's study
    file holds the trials JAX's run_hpo writes for the same objective."""
    def fake_pretrain(trial_cfg, log=print):
        return ((1.0 if trial_cfg.aggr == "gcn" else 0.1)
                + 0.01 * trial_cfg.conv_layer,
                np.zeros((4, 2), np.float32))

    monkeypatch.setattr(tssl, "pretrain", fake_pretrain)
    monkeypatch.setattr(jssl, "pretrain", fake_pretrain)
    cfg = tssl.SSLConfig(dataset="stub", hidden_dim=2)
    jcfg = jssl.SSLConfig(dataset="stub", hidden_dim=2)
    ref_storage = f"sqlite:///{tmp_path / 'ref.db'}"
    tssl.run_hpo(cfg, 16, lambda e: None, log=lambda *_: None,
                 storage=ref_storage)
    storage = f"sqlite:///{tmp_path / 'study.db'}"
    tssl.run_hpo(cfg, 5, lambda e: None, log=lambda *_: None, storage=storage)
    logs = []
    best = tssl.run_hpo(cfg, 16, lambda e: None, log=logs.append,
                        storage=storage)
    assert any("resumed study: 5 completed trials" in l for l in logs)
    jax_storage = f"sqlite:///{tmp_path / 'jax.db'}"
    jssl.run_hpo(jcfg, 16, lambda e: None, log=lambda *_: None,
                 storage=jax_storage)
    trials = [[(t.number, t.params, t.value) for t in lite.create_study(
        "maximize", s, "stub", load_if_exists=True).trials]
        for lite, s in ((tlite, storage), (tlite, ref_storage),
                        (jlite, jax_storage))]
    assert trials[0] == trials[1] == trials[2]
    assert best["params"]["aggr"] == "gcn"


# ---------------------------------------------------------------- the CLI

def test_gnn_emb_writes_a_table_glass_test_trains_from(tmp_path, monkeypatch,
                                                       no_optuna):
    """``gnn_emb --device -1`` writes {path}/{name}_64.npz and the study;
    a second invocation with the same budget trains nothing; the port's
    ``glass_test --use_nodeid`` starts its trunk's embedding from the
    table, row for row."""
    from glass_tpu_torch.cli import glass_test, gnn_emb
    from glass_tpu_torch.train import loop

    write_subgnn(tmp_path, "ppi_bp", False, n_nodes=60, n_sub=150)
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    emb_dir = tmp_path / "Emb"
    argv = ["--dataset", "ppi_bp", "--use_nodeid", "--device", "-1",
            "--optruns", "1", "--max_epochs", "2", "--sampler", "random",
            "--data_root", str(tmp_path), "--path", str(emb_dir)]
    best = gnn_emb.main(argv)
    table = np.load(emb_dir / "ppi_bp_64.npz")["embedding"]
    assert table.shape == (60, 64) and np.isfinite(table).all()
    assert (emb_dir / "ppi_bp.db").exists() and best["score"] > 0
    trained = []
    monkeypatch.setattr(tssl, "pretrain", lambda *a, **k: trained.append(a))
    assert gnn_emb.main(argv)["score"] == best["score"]
    assert trained == []

    starts = []
    real_epoch = loop.Trainer._epoch

    def epoch(trainer, pos_b, y_b):
        if not starts:
            starts.append(trainer.model.conv.input_emb.weight.detach()
                          .clone().numpy())
        return real_epoch(trainer, pos_b, y_b)

    monkeypatch.setattr(loop.Trainer, "_epoch", epoch)
    glass_test.main(["--dataset", "ppi_bp", "--use_nodeid",
                     "--use_maxzeroone", "--device", "-1", "--max_epochs",
                     "1", "--data_root", str(tmp_path), "--emb_path",
                     str(emb_dir)])
    np.testing.assert_array_equal(starts[0], table)


def test_glass_test_names_the_ports_gnn_emb(tmp_path):
    from glass_tpu_torch.cli.glass_test import load_pretrained_table

    with pytest.raises(FileNotFoundError,
                       match="python -m glass_tpu_torch.cli.gnn_emb"):
        load_pretrained_table(str(tmp_path), "ppi_bp", 64)


def test_ssl_config_has_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(jssl.SSLConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tssl.SSLConfig)}
    assert tf.pop("device") == "cuda"
    assert tf == jf
    assert tssl.SEARCH_SPACE == jssl.SEARCH_SPACE
