"""Rank bodies for the multi-process tests of the port's sharded paths
(tests/test_torch_parallel.py), run by ``chip_smoke.spawn`` in processes
of their own. This module imports the port alone (no
JAX), so that a spawned rank starts quickly; the tests hold what the ranks
return against the JAX package in the parent process.
"""

import numpy as np
import torch

N_NODE, MAX_DEG, HIDDEN, LAYERS, BATCH, STEPS = 3 * 128 + 45, 6, 16, 2, 4, 3
LR = 1e-3
# JAX's AutoTrainer splits the dense rows evenly: its graph has an even
# node count (N_NODE is odd, so that partition_graph pads the last block)
N_AUTO = N_NODE + 1

# case -> (partition_graph keywords, spmm mode); "auto" is the AutoTrainer
# on the whole graph's dense adjacency
CASES = {
    "segment": (dict(overlap=False), "segment"),
    "overlap": (dict(), "segment"),
    "ring": (dict(ring=True), "segment"),
    "dense": (dict(materialize_dense=True), "dense"),
    "bcsr_f32": (dict(materialize_bcsr=True, sparse_layout="bcsr"), "pallas"),
    "bcsr_int8": (dict(materialize_bcsr=True, sparse_layout="bcsr",
                       dense_dtype="int8"), "pallas"),
    "band_f32": (dict(materialize_bcsr=True, sparse_layout="band"), "pallas"),
    "band_int8": (dict(materialize_bcsr=True, sparse_layout="band",
                       dense_dtype="int8"), "pallas"),
    "hybrid_f32": (dict(materialize_bcsr=True, sparse_layout="hybrid"),
                   "pallas"),
    "hybrid_int8": (dict(materialize_bcsr=True, sparse_layout="hybrid",
                         dense_dtype="int8"), "pallas"),
    "auto": (dict(), "dense"),
}


def problem(n: int = N_NODE, seed: int = 0):
    """A banded symmetric graph of n nodes with a few far edges (a hybrid
    residue), n % 128 != 0; degree features; (STEPS * BATCH) subgraphs with
    3 classes by size."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 1500)
    dst = np.clip(src + rng.integers(-60, 60, src.size), 0, n - 1)
    far_s = rng.integers(0, 64, 12)
    far_d = n - 1 - rng.integers(0, 64, 12)
    s, d = np.r_[src, far_s], np.r_[dst, far_d]
    ei = np.stack([np.r_[s, d], np.r_[d, s]])
    deg = np.bincount(ei[0], minlength=n)
    x = np.minimum(deg, MAX_DEG).reshape(-1, 1).astype(np.int64)
    pos = np.full((STEPS * BATCH, 8), -1, np.int64)
    y = np.zeros(STEPS * BATCH, np.int64)
    for i in range(STEPS * BATCH):
        k = int(rng.integers(2, 9))
        pos[i, :k] = rng.choice(n, k, replace=False)
        y[i] = (k - 2) // 3
    return ei, x, pos, y


def set_planner_constants(consts: dict) -> None:
    from glass_tpu_torch.ops import graph as tg

    for name, value in consts.items():
        setattr(tg, name, value)


def make_model(spmm_mode: str, dropout: float = 0.0, device="cpu"):
    from glass_tpu_torch import GLASS

    return GLASS(MAX_DEG, HIDDEN, LAYERS, (3,), ("size",), dropout=dropout,
                 activation="elu", z_ratio=0.8, jk=True, spmm_mode=spmm_mode,
                 device=device)


def eval_inputs(pos, y):
    from glass_tpu_torch.train.loop import make_eval_batches
    from glass_tpu_torch.train.metrics import pad_eval_labels

    pos_e, y_e, n_real = make_eval_batches(pos, y, BATCH)
    y_pad, mask = pad_eval_labels(y_e, pos_e.shape[0], BATCH)
    return pos_e, y_e, n_real, y_pad, mask


def train_cases(rank: int, data_shards: int, graph_shards: int, cases,
                init: dict, consts: dict) -> dict:
    """Each case's ShardedTrainer (AutoTrainer for "auto") on this rank
    from the flax parameters ``init``: STEPS train_step losses, the final
    parameters, the eval logits and the score; then the refusals."""
    from glass_tpu_torch import build_graph, params_from_flax
    from glass_tpu_torch.parallel import (AutoTrainer, ShardedTrainer,
                                          make_mesh, partition_graph)
    from glass_tpu_torch.train.loop import TrainConfig

    set_planner_constants(consts)
    mesh = make_mesh(graph_shards=graph_shards, data_shards=data_shards)
    cfg = TrainConfig(lr=LR, batch_size=BATCH, loss="ce")
    out = {}
    for case in cases:
        kw, mode = CASES[case]
        ei, x, pos, y = problem(N_AUTO if case == "auto" else N_NODE)
        pos_e, _, n_real, y_pad, mask = eval_inputs(pos, y)
        model = params_from_flax(make_model(mode), init)
        if case == "auto":
            g = build_graph(ei, None, N_AUTO, "gcn", materialize_dense=True,
                            device="cpu")
            tr = AutoTrainer(model, g, x, cfg, mesh)
        else:
            pg = partition_graph(ei, None, N_NODE, "gcn", graph_shards, **kw)
            tr = ShardedTrainer(model, pg, x, cfg, mesh)
        tr.init(0)
        losses = [tr.train_step(pos[i * BATCH:(i + 1) * BATCH],
                                y[i * BATCH:(i + 1) * BATCH])
                  for i in range(STEPS)]
        out[case] = dict(
            losses=losses,
            params={k: v.numpy().copy()
                    for k, v in tr.model.state_dict().items()},
            logits=tr.evaluate(pos_e, n_real),
            score=tr.evaluate_score(pos_e, y_pad, mask),
            step_logits=tr.eval_step(pos[:BATCH]).numpy())
    # the refusals: a batch the data axis does not divide, and the
    # AutoTrainer's graph axis without a dense layout
    errors = {}
    try:
        tr.train_step(pos[: data_shards * 2 + 1], y[: data_shards * 2 + 1])
    except ValueError as e:
        errors["batch"] = str(e)
    if graph_shards > 1:
        ei, x, _, _ = problem(N_AUTO)
        g = build_graph(ei, None, N_AUTO, "gcn", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout="bcsr",
                        device="cpu")
        try:
            AutoTrainer(make_model("pallas"), g, x, cfg, mesh)
        except ValueError as e:
            errors["auto"] = str(e)
    out["errors"] = errors
    return out


def record_losses() -> list:
    """The list every ShardedTrainer epoch's loss is appended to, from
    here on in this process."""
    from glass_tpu_torch.parallel import train as ptrain

    losses = []
    real_epoch = ptrain.ShardedTrainer.train_epoch
    real_epochs = ptrain.ShardedTrainer.train_epochs

    def epoch(self, *a):
        out = real_epoch(self, *a)
        losses.append(out.loss)
        return out

    def epochs(self, *a):
        out = real_epochs(self, *a)
        losses.extend(float(v) for v in out)
        return out

    ptrain.ShardedTrainer.train_epoch = epoch
    ptrain.ShardedTrainer.train_epochs = epochs
    return losses


def run_protocol(rank: int, kw: dict, inits: dict, consts: dict) -> dict:
    """The port's run_experiment on this rank with each repeat's initial
    parameters from ``inits`` (flax, by seed): the epoch losses and the
    log lines."""
    from glass_tpu_torch import params_from_flax
    from glass_tpu_torch.train import protocol as tprotocol

    set_planner_constants(consts)
    losses = record_losses()
    tprotocol.init_params = (lambda model, cfg, base, mode, seed:
                             params_from_flax(model, inits[seed]))
    logs = []
    res = tprotocol.run_experiment(
        tprotocol.ExperimentConfig(device="cpu", **kw), log=logs.append)
    return dict(losses=losses, logs=[str(l) for l in logs], result=res)


def resume_protocol(rank: int, kw: dict, root: str) -> dict:
    """run_experiment on this rank three times: to 21 epochs writing under
    root/a, to 10 under root/b, then resumed from root/b to 21. Per run:
    the epoch losses, the log lines, the result, and the checkpoint files
    this rank wrote."""
    import torch.distributed as dist

    from glass_tpu_torch.train import protocol as tprotocol
    from glass_tpu_torch.utils import checkpoint as ckpt

    losses, writes = record_losses(), []
    real_state, real_best = ckpt.save_run_state, ckpt.save_checkpoint

    def save_run_state(path, **k):
        writes.append(str(path))
        return real_state(path, **k)

    def save_checkpoint(path, model):
        writes.append(str(path))
        return real_best(path, model)

    ckpt.save_run_state, ckpt.save_checkpoint = save_run_state, save_checkpoint
    runs = {}
    for name, extra in (("a", dict(max_epochs=21, ckpt_dir=f"{root}/a")),
                        ("b1", dict(max_epochs=10, ckpt_dir=f"{root}/b")),
                        ("b2", dict(max_epochs=21, ckpt_dir=f"{root}/b",
                                    resume=True))):
        del losses[:], writes[:]
        logs = []
        res = tprotocol.run_experiment(
            tprotocol.ExperimentConfig(device="cpu", **kw, **extra),
            log=logs.append)
        runs[name] = dict(losses=list(losses), logs=[str(l) for l in logs],
                          result=res, writes=list(writes))
        # the next run starts once rank 0 has written this one's last state
        # (separate launches in real use)
        dist.barrier()
    return runs


def dropout_smoke(rank: int, data_shards: int, graph_shards: int) -> dict:
    """multihost.run_smoke (dropout 0.1) on this rank's mesh."""
    from glass_tpu_torch.parallel.multihost import run_smoke

    return run_smoke(graph_shards, data_shards, device="cpu")


def collectives(rank: int) -> dict:
    """The collective helpers and their autograd rules on this rank, and
    whether a mesh built again reuses its subgroups."""
    from glass_tpu_torch.ops import collectives as col
    from glass_tpu_torch.parallel import make_mesh
    import torch.distributed as dist

    world = dist.get_world_size()
    group = dist.new_group(list(range(world)))
    meshes = [make_mesh(graph_shards=world) for _ in range(2)]
    other = make_mesh(graph_shards=1)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    x.requires_grad_(True)
    g = col.gather_rows(x, group)
    (g * (torch.arange(g.numel()).reshape(g.shape) + 1)).sum().backward()
    s = col.ring_shift(x.detach().clone().requires_grad_(True), group)
    return dict(gathered=g.detach().numpy(), dx=x.grad.numpy(),
                shifted=s.detach().numpy(),
                summed=col.all_reduce(x.detach(), group).numpy(),
                maxed=col.all_reduce(x.detach(), group, "max").numpy(),
                mesh_reused=(meshes[0].graph_group is meshes[1].graph_group
                             and meshes[0].data_group is meshes[1].data_group),
                mesh_shapes_apart=other.data_group is not meshes[0].graph_group,
                mesh_sums=col.all_reduce(x.detach(), meshes[1].graph_group)
                .numpy())
