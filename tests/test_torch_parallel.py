"""The port's sharded paths (``glass_tpu_torch/parallel``) against
``glass_tpu.parallel``, on the CPU.

The port's ranks are processes of their own over gloo
(``chip_smoke.spawn``, the rank bodies in
tests/torch_ranks.py), one spawn per mesh shape; JAX runs the same cases
in this process on the conftest's virtual CPU devices (its Pallas kernels
in interpret mode). Both start from the same flax parameters, dropout 0,
and both planners score with the JAX planner's constants and terms.

Per case of JAX's dry-run matrix (the all-gather segment SpMM, the
overlap split, the ring, dense, BCSR, band and hybrid in f32 and int8, and
the AutoTrainer) on 2 x 2 and 1 x 2 (data x graph) meshes, after 3 steps:
every rank's losses equal; the losses within rtol 1e-5 of JAX's (int8:
1e-4); the parameters within 1e-5 x max|parameter| of each tensor (int8:
3 * lr, Adam's step, as tests/test_torch_train.py holds the unsharded
int8 path: its kernels round x to bf16, where the two frameworks' last
bits can round apart); the eval logits within 1e-5 x max|logit| (int8:
rtol 1e-4 and 1e-3 x max, tests/test_torch_quant.py's bound) and the eval
score equal. Also: the batch-divisibility and AutoTrainer refusals, the
collectives' values and autograd rules, the sharding-invariant dropout
(sharded runs with dropout 0.1 equal the one-process run within rtol
1e-6), run_experiment on 2 x 2 against JAX's sharded run_experiment
(epoch losses within rtol 1e-5, log lines equal), and a sharded run
resumed from its run state equal to the uninterrupted run on every rank.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops import graph as jgraph
from glass_tpu.parallel import mesh as jmesh
from glass_tpu.parallel import partition as jpart
from glass_tpu.parallel.auto import AutoTrainer as JAutoTrainer
from glass_tpu.parallel.train import ShardedTrainer as JShardedTrainer
from glass_tpu.train import loop as jloop
from glass_tpu.train import metrics as jmetrics
from glass_tpu.train import protocol as jprotocol
from glass_tpu.train.schedule import plateau_init
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, params_from_flax
from glass_tpu_torch.parallel.multihost import run_smoke
from test_torch_planner import CONSTANTS, REFERENCE_TERMS
from test_torch_protocol import DENSITY, ITER, density_root  # noqa: F401

from chip_smoke import spawn

import torch_ranks as R

MESHES = [(2, 2), (1, 2)]  # (data, graph)
SPAWN_TIMEOUT = 600


def jax_constants() -> dict:
    """The JAX planner's constants and model terms, for the port's ranks."""
    return dict({n: getattr(jgraph, n) for n in CONSTANTS}, **REFERENCE_TERMS)


def flax_model(mode):
    return FlaxGLASS(max_deg=R.MAX_DEG, hidden_channels=R.HIDDEN,
                     num_layers=R.LAYERS, output_channels=(3,),
                     pools=("size",), dropout=0.0, activation="elu",
                     z_ratio=0.8, jk=True, spmm_mode=mode)


@functools.lru_cache(maxsize=1)
def init_params():
    """The flax parameters every case starts from."""
    ei, x, pos, _ = R.problem()
    g = jgraph.build_graph(ei, None, R.N_NODE, "gcn")
    return flax_model("segment").init(
        jax.random.PRNGKey(0), g, jnp.asarray(x.astype(np.int32)),
        jnp.asarray(pos[: R.BATCH]), jnp.zeros(R.N_NODE, jnp.int32))


@functools.lru_cache(maxsize=None)
def port_runs(data_shards: int, graph_shards: int) -> tuple:
    """Every case on the port's ranks of one mesh shape (one spawn)."""
    return tuple(spawn(R.train_cases, data_shards * graph_shards,
                       args=(data_shards, graph_shards, tuple(R.CASES),
                             _flatten(init_params()), jax_constants()),
                       timeout=SPAWN_TIMEOUT))


def jax_case(case: str, data_shards: int, graph_shards: int) -> dict:
    """The case on JAX's sharded trainers: 3 one-step epochs, then eval."""
    kw, mode = R.CASES[case]
    n = R.N_AUTO if case == "auto" else R.N_NODE
    ei, x, pos, y = R.problem(n)
    pos_e, y_e, n_real, y_pad, mask = R.eval_inputs(pos, y)
    mesh = jmesh.make_mesh(graph_shards=graph_shards, data_shards=data_shards,
                           devices=jax.devices()[: data_shards * graph_shards])
    cfg = jloop.TrainConfig(lr=R.LR, batch_size=R.BATCH, loss="ce")
    if case == "auto":
        g = jgraph.build_graph(ei, None, n, "gcn", materialize_dense=True)
        tr = JAutoTrainer(flax_model(mode), g, jnp.asarray(x.astype(np.int32)),
                          cfg, mesh)
    else:
        pg = jpart.partition_graph(ei, None, n, "gcn", graph_shards, **kw)
        tr = JShardedTrainer(flax_model(mode), pg, x, cfg, mesh)
    params = init_params()
    opt, plateau = tr.tx.init(params), plateau_init(R.LR)
    key = jax.random.PRNGKey(1)
    losses = []
    for i in range(R.STEPS):
        sl = slice(i * R.BATCH, (i + 1) * R.BATCH)
        params, opt, plateau, key, loss = tr.train_epoch(
            params, opt, plateau, key, jnp.asarray(pos[None, sl]),
            jnp.asarray(y[None, sl]))
        losses.append(float(loss))
    return dict(losses=losses, params=_flatten(params),
                logits=tr.evaluate(params, pos_e, n_real),
                score=tr.evaluate_score(params, pos_e, y_pad, mask),
                want_score=jmetrics.micro_f1(tr.evaluate(params, pos_e,
                                                         n_real), y_e))


@pytest.fixture(autouse=True)
def jax_planner(monkeypatch):
    """The JAX planner without a calibration file (the ranks get the same
    constants through jax_constants)."""
    monkeypatch.delenv("GLASS_TPU_AUTOTUNE", raising=False)


@pytest.mark.parametrize("case", list(R.CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_trainer_matches_jax(mesh, case):
    ranks = port_runs(*mesh)
    got = ranks[0][case]
    for other in ranks[1:]:
        assert other[case]["losses"] == got["losses"]
        assert other[case]["score"] == got["score"]
    ref = jax_case(case, *mesh)
    int8 = case.endswith("int8")
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=1e-4 if int8 else 1e-5)
    model = params_from_flax(GLASS(R.MAX_DEG, R.HIDDEN, R.LAYERS, (3,),
                                   ("size",), device="cpu"), ref["params"])
    for name, want in model.state_dict().items():
        want = want.numpy()
        tol = 3 * R.LR if int8 else 1e-5 * float(np.abs(want).max())
        assert float(np.abs(got["params"][name] - want).max()) <= tol, name
    scale = float(np.abs(ref["logits"]).max())
    if int8:
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-4,
                                   atol=1e-3 * scale)
    else:
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=0,
                                   atol=1e-5 * scale)
    assert got["score"] == ref["score"] == ref["want_score"]
    np.testing.assert_allclose(got["step_logits"], got["logits"][: R.BATCH],
                               rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_refusals(mesh):
    """A batch the data axis does not divide raises on every rank, as
    JAX's _check_batch does; the AutoTrainer's graph axis needs a dense
    layout (JAX's message)."""
    errors = port_runs(*mesh)[0]["errors"]
    if mesh[0] > 1:
        assert "does not divide the 'data' mesh axis" in errors["batch"]
    else:
        assert "batch" not in errors
    assert "auto-partitioned" in errors["auto"]


def test_collectives_and_their_gradients():
    """The tiled all-gather (backward: reduce-scatter of the summed
    cotangents), the ring shift, and the sum and max all-reduces on 2 gloo
    ranks; a mesh built again reuses its subgroups (another shape has its
    own), and they still reduce."""
    out = spawn(R.collectives, 2, timeout=SPAWN_TIMEOUT)
    x = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
         for r in range(2)]
    weight = np.arange(12, dtype=np.float32).reshape(6, 2) + 1
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["gathered"], np.concatenate(x))
        # every rank's cotangent is `weight`; their sum's block r
        np.testing.assert_array_equal(o["dx"], 2 * weight[3 * r: 3 * r + 3])
        np.testing.assert_array_equal(o["shifted"], x[(r + 1) % 2])
        np.testing.assert_array_equal(o["summed"], x[0] + x[1])
        np.testing.assert_array_equal(o["maxed"], np.maximum(x[0], x[1]))
        assert o["mesh_reused"] and o["mesh_shapes_apart"]
        np.testing.assert_array_equal(o["mesh_sums"], x[0] + x[1])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_dropout_equals_one_process(mesh):
    """With dropout 0.1 (masks drawn for the whole graph from one seed and
    sliced) the sharded smoke run equals the one-process run."""
    ref = run_smoke(1, 1, device="cpu")
    for out in spawn(R.dropout_smoke, mesh[0] * mesh[1], args=mesh,
                     timeout=SPAWN_TIMEOUT):
        np.testing.assert_allclose([out["step_loss"], out["epoch_loss"]],
                                   [ref["step_loss"], ref["epoch_loss"]],
                                   rtol=1e-6)


def test_sharded_protocol_matches_jax(monkeypatch, density_root):
    """run_experiment on 2 data x 2 graph ranks against JAX's sharded
    run_experiment on 4 devices, from JAX's initial parameters: every
    epoch's loss within rtol 1e-5, the log lines equal (scores exactly,
    losses to their 4 printed decimals)."""
    kw = dict(DENSITY, repeat=1, max_epochs=22, data_root=density_root,
              graph_shards=2, data_shards=2)
    inits, jlosses = {}, []
    real_init = JShardedTrainer.init
    real_epoch = JShardedTrainer.train_epoch
    real_epochs = JShardedTrainer.train_epochs

    def init(self, seed, pos):
        out = real_init(self, seed, pos)
        inits[seed] = _flatten(out[0])
        return out

    def epoch(self, *a):
        out = real_epoch(self, *a)
        jlosses.append(float(out[-1]))
        return out

    def epochs(self, *a):
        out = real_epochs(self, *a)
        jlosses.extend(float(v) for v in out[-1])
        return out

    with monkeypatch.context() as m:
        m.setattr(JShardedTrainer, "init", init)
        m.setattr(JShardedTrainer, "train_epoch", epoch)
        m.setattr(JShardedTrainer, "train_epochs", epochs)
        m.setattr(jmesh, "make_mesh", functools.partial(
            jmesh.make_mesh, devices=jax.devices()[:4]))
        jlogs = []
        jres = jprotocol.run_experiment(jprotocol.ExperimentConfig(**kw),
                                        log=jlogs.append)
    assert len(jlosses) == 22
    ranks = spawn(R.run_protocol, 4, args=(kw, inits, jax_constants()),
                  timeout=SPAWN_TIMEOUT)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    jl = [str(l) for l in jlogs if not l.startswith(("end:", "throughput:"))]
    tl = [l for l in got["logs"] if not l.startswith(("end:", "throughput:"))]
    assert len(jl) == len(tl) and any(ITER.match(l) for l in tl)
    for a, b in zip(jl, tl):
        ma, mb = ITER.match(a), ITER.match(b)
        if ma is None:
            assert a == b
            continue
        assert (ma[1], ma[3], ma[4]) == (mb[1], mb[3], mb[4]), (a, b)
        assert float(mb[2]) == pytest.approx(float(ma[2]), abs=1.01e-4)
    assert list(got["result"][0]) == list(jres[0])
    assert tuple(got["result"][1:]) == tuple(jres[1:])


def test_sharded_resume_restores_every_rank(tmp_path, density_root):
    """A 2-rank (graph) run stopped after epoch 10 and resumed to 21 equals
    the uninterrupted 21-epoch run on every rank: the same epoch losses and
    result, and the same final run state in every array and in its
    metadata. Every rank restores the state; rank 0 alone writes it and
    the best parameters."""
    kw = dict(DENSITY, repeat=1, data_root=density_root, dropout=0.3,
              graph_shards=2)
    ranks = spawn(R.resume_protocol, 2, args=(kw, str(tmp_path)),
                  timeout=SPAWN_TIMEOUT)
    for r, runs in enumerate(ranks):
        assert any("resumed at epoch 10" in l for l in runs["b2"]["logs"]), r
        assert runs["a"]["losses"] == ranks[0]["a"]["losses"], r
        assert runs["b1"]["losses"] + runs["b2"]["losses"] \
            == runs["a"]["losses"], r
        assert runs["b2"]["result"] == runs["a"]["result"], r
        for name in ("a", "b1", "b2"):
            assert bool(runs[name]["writes"]) == (r == 0), (r, name)
    assert any(w.endswith("_best.npz") for w in ranks[0]["a"]["writes"])
    sa = np.load(tmp_path / "a" / "density_seed0_state.npz")
    sb = np.load(tmp_path / "b" / "density_seed0_state.npz")
    assert set(sa.files) == set(sb.files)
    assert any(k.startswith("adam/") for k in sa.files)
    for k in sa.files:
        if k == "__meta__":
            assert str(sa[k]) == str(sb[k])
        else:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
