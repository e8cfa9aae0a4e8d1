"""GLASS with mean aggregation and two conv layers (ppi_bp's configuration:
jumping knowledge, sum pool, cross entropy) against the benchmark's plain
reference, ``benchmark/reference/glass_mean.py``.

On the CPU, at 300 nodes of a degree-skewed graph and hidden 64, from the
same seeded weights: the inference logits, each leaf's first gradient
(read from Adam's first moment, as the benchmark reads it) and the
parameters after 3 Adam steps with the dropout masks drawn alike, over the
sparse-block and the BCSR layouts (the plain versions of their kernels,
the backward over A^T's own layout). Each tolerance states its reason; a
bf16 forward fails each of them. Also: the mean layout's A^T is its own
object, equal to the dense transpose; ``glass_mean.py`` with gcn is
``glass.py``; an isolated node counts degree 1 in the port and the
reference alike; the step's SpMM launch counters (``train.spmm``,
``train.spmm_t``) are recorded only under a profile.

Marked ``card`` (they skip without one; on the card machine, which has no
JAX: ``python -m pytest --noconftest -m card tests/test_torch_mean_aggr.py``):
the sparse-block kernel over a mean A^T against its plain version, and a
captured two-layer ``Trainer`` whose losses are bit-equal over two runs
and whose step holds 4 SpMM launches, 2 of them over A^T. This file
imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glass_tpu_torch import GLASS, TrainConfig, Trainer, build_graph
from glass_tpu_torch.ops import sblock_spmm as tsb
from glass_tpu_torch.ops.labeling import max_zero_one
from glass_tpu_torch.train.loop import make_train_batches
from glass_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import byname  # noqa: E402
from benchmark import generate as gen  # noqa: E402
from benchmark.reference import glass, glass_mean  # noqa: E402

MODEL = dict(hidden_dim=64, conv_layer=2, aggr="mean", pool="sum",
             z_ratio=0.95, jk=True, activation="elu", dropout=0.5, lr=5e-4,
             resi=0.2, batch_size=16, loss="ce", use_maxzeroone=True)
CLASSES = 6
SEED = 2**31 + 24
STEPS = 3
# Both sides sum in f32 in different orders (the layouts' plain versions
# against the reference's edge sums), about 1e-7 of a value a sum; GraphNorm
# over all nodes and the 2-layer chain grow that to about 1e-6 of the
# largest logit (3e-7 and 5e-7 read on the two layouts). A bf16 forward is
# off by 3e-3 and more.
LOGITS_TOL = 5e-6
# a leaf's first gradient against its largest element: the same sums run
# backward through both layers (0.9e-6 and 1.5e-6 read)
GRAD_TOL = 2e-5
# Adam moves an element by about lr a step whatever its gradient's size, so
# a rounding-level gradient whose sign differs parts the two by up to
# 2 lr a step: held against the norm of the leaf's change (1.4e-4 and
# 0.4e-4 read; bf16 0.17)
CHANGE_TOL = 1e-3


def graph_inputs(seed=SEED, n=300, e=3000):
    """A tiny stand-in of the cell: the powerlaw recipe's skewed degrees,
    degree ids, and a train split of lognormal subgraphs."""
    recipe = byname.load(REPO / "benchmark" / "graphs", "powerlaw")
    ei, n = recipe.make(dict(nodes=n, undirected_edges=e, exponent=2.5),
                        gen.sub_seed(seed, gen.GRAPH))
    spec = dict(kind="lognormal", count=200, train_share=0.8, mean_nodes=10.2,
                sd_nodes=10.5, min_nodes=2, max_nodes=128, classes=CLASSES)
    pos, y = gen.train_split(spec, dict(nodes=n), seed)
    return ei, n, gen.degree_ids(ei, n), pos, y


def program(ei, n, ids, layout, device, weights, compute_dtype=None):
    graph = build_graph(ei, None, n, MODEL["aggr"], materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        device=device)
    model = GLASS(int(ids.max()), 64, MODEL["conv_layer"], (CLASSES,),
                  (MODEL["pool"],), dropout=MODEL["dropout"],
                  z_ratio=MODEL["z_ratio"], jk=True, spmm_mode="pallas",
                  compute_dtype=compute_dtype, device=device)
    model.load_state_dict(weights, strict=True)
    return graph, torch.from_numpy(ids).to(device), model


def weights_of(ids, device):
    shapes = glass_mean.param_shapes(MODEL, int(ids.max()), CLASSES)
    return gen.make_weights(shapes, SEED, device)


def rel_gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.fixture(scope="module")
def inputs():
    return graph_inputs()


@pytest.mark.parametrize("layout", ["sblock", "bcsr"])
def test_logits_match_the_reference(inputs, layout):
    ei, n, ids_np, pos_np, _ = inputs
    cpu = torch.device("cpu")
    w = weights_of(ids_np, cpu)
    graph, ids, model = program(ei, n, ids_np, layout, cpu, w)
    assert graph.plan is None and getattr(graph, layout) is not None
    pos = torch.from_numpy(pos_np[:40])
    with torch.no_grad():
        got = model(graph, ids, pos, max_zero_one(pos, n))
    adj = glass_mean.Adjacency(torch.from_numpy(ei), n, "mean")
    want = glass_mean.predict(w, MODEL, adj, ids, pos)
    assert rel_gap(got, want) <= LOGITS_TOL


def test_a_bf16_forward_fails_the_tolerances(inputs):
    ei, n, ids_np, pos_np, _ = inputs
    cpu = torch.device("cpu")
    w = weights_of(ids_np, cpu)
    graph, ids, model = program(ei, n, ids_np, "sblock", cpu, w,
                                compute_dtype="bfloat16")
    pos = torch.from_numpy(pos_np[:40])
    with torch.no_grad():
        got = model(graph, ids, pos, max_zero_one(pos, n))
    adj = glass_mean.Adjacency(torch.from_numpy(ei), n, "mean")
    want = glass_mean.predict(w, MODEL, adj, ids, pos)
    assert rel_gap(got, want) > 10 * LOGITS_TOL
    prog, ref, w = train_both(inputs, "sblock", "bfloat16")
    assert max(rel_gap(prog["first_grad"][k], g)
               for k, g in ref["first_grad"].items()) > 10 * GRAD_TOL
    assert max(change_gap(prog, ref, w, k) for k in ref["params"]) \
        > 10 * CHANGE_TOL


def train_both(inputs, layout, compute_dtype=None):
    """(program, reference, weights): the first gradient a leaf and the
    parameters after STEPS Adam steps, from the same weights, batches and
    dropout seed."""
    ei, n, ids_np, pos_np, y_np = inputs
    cpu = torch.device("cpu")
    w = weights_of(ids_np, cpu)
    graph, ids, model = program(ei, n, ids_np, layout, cpu, w, compute_dtype)
    pos_b, y_b = make_train_batches(np.random.default_rng(3), pos_np, y_np,
                                    MODEL["batch_size"])
    trainer = Trainer(model, graph, ids, TrainConfig(
        lr=MODEL["lr"], resi=MODEL["resi"], batch_size=MODEL["batch_size"],
        loss="ce"))
    drop = gen.sub_seed(SEED, gen.DROPOUT)
    trainer.init(drop)
    trainer.train_epoch(pos_b[:1], y_b[:1])
    named = dict(model.named_parameters())
    state = trainer.optimizer.state
    first = {k: state[p]["exp_avg"] / (1 - glass_mean.BETAS[0])
             for k, p in named.items()}
    trainer.train_epoch(pos_b[1:STEPS], y_b[1:STEPS])
    prog = dict(first_grad=first,
                params={k: p.detach() for k, p in named.items()})
    adj = glass_mean.Adjacency(torch.from_numpy(ei), n, "mean")
    batches = [(torch.from_numpy(p), torch.from_numpy(y))
               for p, y in zip(pos_b[:STEPS], y_b[:STEPS])]
    ref = glass_mean.train_steps(w, MODEL, adj, ids, batches, drop)
    return prog, ref, w


@pytest.fixture(scope="module", params=["sblock", "bcsr"])
def trained(request, inputs):
    return train_both(inputs, request.param)


def test_first_gradients_match(trained):
    prog, ref, _ = trained
    assert set(prog["first_grad"]) == set(ref["first_grad"])
    gaps = {k: rel_gap(prog["first_grad"][k], g)
            for k, g in ref["first_grad"].items() if float(g.abs().max())}
    assert max(gaps.values()) <= GRAD_TOL, gaps


def change_gap(prog, ref, w, k):
    """The gap of leaf k's parameters after the steps, against the norm of
    the reference's change of the leaf."""
    v = ref["params"][k].double()
    gap = float((prog["params"][k].double() - v).norm())
    return gap / max(float((v - w[k].double()).norm()), 1e-12)


def test_parameters_after_three_adam_steps_match(trained):
    prog, ref, w = trained
    gaps = {k: change_gap(prog, ref, w, k) for k in ref["params"]}
    assert max(gaps.values()) <= CHANGE_TOL, gaps


def test_mean_transposed_layout_is_its_own_and_the_dense_transpose(inputs):
    ei, n, *_ = inputs
    g = build_graph(ei, None, n, "mean", materialize_dense=True,
                    materialize_bcsr=True, sparse_layout="sblock",
                    device="cpu")
    assert g.sblock_t is not g.sblock
    eye = torch.eye(n)
    a = tsb.sblock_spmm_reference(g.sblock, eye)
    a_t = tsb.sblock_spmm_reference(g.sblock_t, eye)
    assert torch.equal(a, g.dense) and torch.equal(a_t, g.dense.T)
    assert not torch.equal(a, a_t)
    bc = build_graph(ei, None, n, "mean", materialize_dense=False,
                     materialize_bcsr=True, sparse_layout="bcsr",
                     device="cpu")
    assert bc.bcsr_t is not bc.bcsr
    gcn = build_graph(ei, None, n, "gcn", materialize_dense=False,
                      materialize_bcsr=True, sparse_layout="sblock",
                      device="cpu")
    assert gcn.sblock_t is gcn.sblock  # symmetric: one layout


def test_glass_mean_with_gcn_is_glass(inputs):
    ei, n, ids_np, pos_np, _ = inputs
    edges = torch.from_numpy(ei)
    a, b = glass_mean.Adjacency(edges, n, "gcn"), glass.Adjacency(edges, n)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.row, b.row)
    assert torch.equal(a.col, b.col)
    w = weights_of(ids_np, torch.device("cpu"))
    model = dict(MODEL, aggr="gcn")
    pos = torch.from_numpy(pos_np[:20])
    ids = torch.from_numpy(ids_np)
    assert torch.equal(glass_mean.predict(w, model, a, ids, pos),
                       glass.predict(w, model, b, ids, pos))
    with pytest.raises(NotImplementedError, match="sum"):
        glass_mean.Adjacency(edges, n, "sum")


@pytest.mark.parametrize("aggr", ["mean", "gcn"])
def test_an_isolated_node_counts_degree_one(aggr):
    # node 3 has no edge at all; node 4 only ends edges (no row of its own)
    ei = np.array([[0, 1, 1, 2, 0, 2], [1, 0, 2, 1, 4, 4]])
    n = 5
    g = build_graph(ei, None, n, aggr, materialize_dense=True, device="cpu")
    adj = glass_mean.Adjacency(torch.from_numpy(ei), n, aggr)
    want = torch.zeros(n, n)
    want[adj.row, adj.col] = adj.weight
    assert torch.allclose(g.dense, want, rtol=1e-6, atol=0)
    assert torch.isfinite(g.dense).all()
    assert not g.dense[3].any() and not g.dense[:, 3].any()


def test_step_counters_recorded_only_under_a_profile(inputs, tmp_path):
    ei, n, ids_np, pos_np, y_np = inputs
    cpu = torch.device("cpu")
    graph, ids, model = program(ei, n, ids_np, "sblock", cpu,
                                weights_of(ids_np, cpu))
    trainer = Trainer(model, graph, ids, TrainConfig(lr=5e-4, batch_size=16))
    trainer.init(0)
    pos_b, y_b = make_train_batches(np.random.default_rng(0), pos_np, y_np,
                                    16)
    profiling.reset_spans()
    trainer.train_epoch(pos_b[:2], y_b[:2])
    assert "train.spmm" not in profiling.span_table()
    with profiling.trace("mean_aggr", log_dir=str(tmp_path)):
        trainer.train_epoch(pos_b[:2], y_b[:2])
    table = profiling.span_table()
    # the CPU runs the layouts' plain versions: no kernel launches
    assert table["train.spmm"] == dict(count=2, value=0,
                                       parent="glass.train.step")
    assert table["train.spmm_t"]["count"] == 2
    assert trainer._step_spmm == (0, 0)
    profiling.reset_spans()


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
def test_kernel_over_a_mean_transposed_layout(card):
    ei, n, *_ = graph_inputs(n=2000, e=60000)
    g = build_graph(ei, None, n, "mean", materialize_dense=False,
                    materialize_bcsr=True, sparse_layout="sblock", device=card)
    assert g.sblock_t is not g.sblock
    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(5)).to(
        card).requires_grad_(True)
    for sb in (g.sblock, g.sblock_t):
        got = tsb.sblock_spmm(sb, x.detach())
        plain = tsb.sblock_spmm_reference(sb, x.detach())
        torch.testing.assert_close(got, plain, rtol=0,
                                   atol=1e-5 * float(plain.abs().max()))
    gy = torch.randn(n, 64, generator=torch.Generator().manual_seed(6)).to(
        card)
    (dx,) = torch.autograd.grad(tsb.sblock_spmm(g.sblock, x, g.sblock_t), x,
                                gy)
    want = tsb.sblock_spmm_reference(g.sblock_t, gy)
    torch.testing.assert_close(dx, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def card_losses(device, log_dir):
    ei, n, ids_np, pos_np, y_np = graph_inputs(n=2000, e=60000)
    graph, ids, model = program(ei, n, ids_np, "sblock", device,
                                weights_of(ids_np, device))
    trainer = Trainer(model, graph, ids, TrainConfig(
        lr=MODEL["lr"], resi=MODEL["resi"], batch_size=16, loss="ce"))
    trainer.init(11)
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(2):
        pos_b, y_b = make_train_batches(rng, pos_np, y_np, 16)
        losses.append(trainer.train_epoch(pos_b, y_b).step_losses)
    profiling.reset_spans()
    pos_b, y_b = make_train_batches(rng, pos_np, y_np, 16)
    with profiling.trace("mean_aggr", log_dir=str(log_dir)):
        losses.append(trainer.train_epoch(pos_b, y_b).step_losses)
    table = profiling.span_table()
    profiling.reset_spans()
    return np.concatenate(losses), table, len(pos_b)


@pytest.mark.card
def test_captured_two_layer_training_is_bit_reproducible(card, tmp_path):
    a, table, steps = card_losses(card, tmp_path)
    b, _, _ = card_losses(card, tmp_path)
    assert np.isfinite(a).all()
    assert np.array_equal(a, b)
    assert table["train.spmm"]["value"] == 4 * steps
    assert table["train.spmm_t"]["value"] == 2 * steps
