"""The reference experiment protocol: repeats, eval gating, model selection,
early stopping (counterpart of ``glass_tpu/train/protocol.py``; reference:
GLASSTest.py:178-269).

Reproduced as the JAX package reproduces it:

- per repeat: seed = (1 << repeat) - 1, dataset re-split (synthetics re-roll
  their 50/25/25 mask), fresh parameters (drawn from ``seed``) and a fresh
  dropout stream (from ``seed + 1``);
- ``num_div = |test| / batch_size``, divided by 5 for synthetics
  (GLASSTest.py:197-201);
- epochs up to 300; eval only once ``i >= 100 / num_div``;
- model selection: new best val -> record test score; val within 1e-5 of
  best -> probe test and keep the max (GLASSTest.py:233-252);
- early stop counter increments on worse-than-best val and when val is
  saturated (>= 1 - 1e-5), stop when > 100 / num_div (GLASSTest.py:253-262);
- report mean +- std/sqrt(n) of the per-repeat test scores.

The numpy ``rng`` is drawn in the JAX protocol's order: the load and split,
then one ``make_train_batches`` per epoch, then each val and test
``make_eval_batches``. The JAX protocol runs the epochs before the eval gate
as one multi-epoch program (``Trainer.train_epochs``) to save remote-TPU
dispatches; PyTorch runs eagerly, so every epoch takes the per-epoch branch
here, with the same math and the same batches.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.data.loaders import SYNTHETIC_DATASETS, load_dataset
from glass_tpu_torch.nn.modules import GLASS
from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.graph import DENSE_NODE_LIMIT, build_graph
from glass_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    make_eval_batches,
    make_train_batches,
)
from glass_tpu_torch.train.metrics import binary_f1, micro_f1, pad_eval_labels
from glass_tpu_torch.utils.profiling import StepMeter


@dataclasses.dataclass
class ExperimentConfig:
    """Mirrors the per-dataset YAML schema (reference: config/*.yml + test()
    defaults GLASSTest.py:178-187); the fields of the JAX class, plus
    ``device`` ("cuda", the default, or "cpu")."""

    dataset: str = "density"
    pool: str = "size"
    aggr: str = "mean"
    hidden_dim: int = 64
    conv_layer: int = 8
    dropout: float = 0.3
    jk: int = 1
    lr: float = 1e-3
    z_ratio: float = 0.8
    batch_size: Optional[int] = None
    resi: float = 0.7
    # command-line flags (GLASSTest.py:14-30)
    feature: str = "one"  # one | deg | nodeid
    use_maxzeroone: bool = True
    repeat: int = 1
    max_epochs: int = 300
    # framework knobs
    spmm_mode: Optional[str] = None
    dense_dtype: str = "f32"  # "bf16" | "int8": narrower adjacencies
    # "bf16": bf16 activations, f32 params/optimizer/GraphNorm stats/loss
    compute_dtype: Optional[str] = None
    ckpt_dir: Optional[str] = None  # save best-val params + run state per repeat
    resume: bool = False  # resume from ckpt_dir's run-state checkpoint
    ckpt_every: int = 10  # run-state checkpoint cadence (epochs)
    # the sharded paths (ROADMAP Queue 1 item 12): anything but these
    # defaults raises NotImplementedError
    graph_shards: int = 1
    data_shards: int = 1
    ring: bool = False
    sharding: Optional[str] = None
    # block-sparse layout for --spmm pallas: "band" | "bcsr" ("auto" and
    # "hybrid" are ROADMAP Queue 1 item 6)
    sparse_layout: str = "auto"
    # reverse Cuthill-McKee node reordering before building the graph
    rcm: bool = False
    node_emb: Optional[np.ndarray] = None  # pretrained (N, hidden) table
    data_root: Optional[str] = None
    # also log test AUROC at each test probe (reference metrics.py:23-27)
    report_auroc: bool = False
    device: str = "cuda"


def apply_feature(base: BaseGraphData, feature: str) -> None:
    if feature == "one":
        base.set_one_feature()
    elif feature == "deg":
        base.set_degree_feature()
    elif feature == "nodeid":
        base.set_node_id_feature()
    else:
        raise NotImplementedError(f"unknown feature {feature!r}")


def _check_ported(cfg: ExperimentConfig) -> None:
    if (cfg.graph_shards > 1 or cfg.data_shards > 1 or cfg.ring
            or cfg.sharding is not None):
        raise NotImplementedError(
            "graph_shards/data_shards > 1, ring and sharding are the sharded "
            "paths, ROADMAP Queue 1 item 12 (not ported yet)")


def run_experiment(cfg: ExperimentConfig, log: Callable[[str], None] = print):
    """Runs ``cfg.repeat`` seeded repeats; returns (scores, mean, stderr)."""
    _check_ported(cfg)
    scores = []
    cache: dict = {}
    for repeat in range(cfg.repeat):
        seed = (1 << repeat) - 1
        log(f"repeat {repeat} (seed {seed})")
        scores.append(_run_one(cfg, seed, log, cache))
    mean = float(np.average(scores))
    err = float(np.std(scores) / np.sqrt(len(scores)))
    log(f"average {mean:.3f} error {err:.3f}")
    return scores, mean, err


def _auto_route(cfg: ExperimentConfig, n_node: int, device: torch.device):
    """(spmm_mode, use_rcm) after auto-routing on the card, as the JAX
    protocol routes on the TPU: a graph beyond the dense-adjacency limit
    with no ``spmm_mode`` is RCM-reordered and sent to the "pallas" route.
    The layout planner behind it (``sparse_layout="auto"``) is ROADMAP
    Queue 1 item 6, so that route needs ``sparse_layout`` "band" or
    "bcsr" (``build_graph`` says so). RCM is prediction-invariant."""
    if (
        cfg.spmm_mode is None
        and n_node > DENSE_NODE_LIMIT
        and device.type == "cuda"
        and cfg.sharding in (None, "auto")
    ):
        return "pallas", True
    return cfg.spmm_mode, cfg.rcm


def make_glass_model(cfg: ExperimentConfig, base, spmm_mode, *, seed: int = 0,
                     device="cuda") -> GLASS:
    """The GLASS module exactly as the experiment protocol constructs it
    (reference buildModel, GLASSTest.py:129-175), its parameters drawn from
    ``seed``."""
    return GLASS(
        max_deg=base.max_deg,
        hidden_channels=cfg.hidden_dim,
        num_layers=cfg.conv_layer,
        output_channels=(base.output_channels,),
        pools=(cfg.pool,),
        dropout=cfg.dropout,
        activation="elu",
        z_ratio=cfg.z_ratio,
        jk=bool(cfg.jk),
        spmm_mode=spmm_mode,
        compute_dtype=("bfloat16" if cfg.compute_dtype in ("bf16", "bfloat16")
                       else None),
        seed=seed,
        device=device,
    )


def init_params(model: GLASS, cfg: ExperimentConfig, base, spmm_mode,
                seed: int) -> None:
    """Draws a repeat's initial parameters into ``model`` in place: those of
    a fresh :func:`make_glass_model` from ``seed`` (built on the CPU)."""
    fresh = make_glass_model(cfg, base, spmm_mode, seed=seed, device="cpu")
    model.load_state_dict(fresh.state_dict())


def _run_one(
    cfg: ExperimentConfig,
    seed: int,
    log: Callable[[str], None],
    cache: Optional[dict] = None,
) -> float:
    rng = np.random.default_rng(seed)
    base = load_dataset(cfg.dataset, rng, cfg.data_root)
    apply_feature(base, cfg.feature)

    device = resolve_device(cfg.device)
    spmm_mode, use_rcm = _auto_route(cfg, base.n_node, device)
    if cfg.sparse_layout != "auto" and spmm_mode != "pallas":
        # an explicit layout request that the execution route ignores is a
        # silent no-op users mistake for a real A/B
        log(f"warning: --sparse_layout {cfg.sparse_layout} has no effect "
            f"without the pallas route (effective spmm mode: "
            f"{spmm_mode or 'auto/dense'}); pass --spmm pallas to force it")
    if use_rcm:
        from glass_tpu_torch.native import rcm_ordering

        base.relabel_nodes(rcm_ordering(base.edge_index, base.n_node))

    binary = base.binary
    loss = "bce" if binary else "ce"
    score_fn = binary_f1 if binary else micro_f1

    tcfg = TrainConfig(
        lr=cfg.lr,
        resi=cfg.resi,
        batch_size=cfg.batch_size,
        loss=loss,
        use_z=cfg.use_maxzeroone,
    )

    trn_pos, trn_y = base.get_split("train")
    val_pos, val_y = base.get_split("valid")
    tst_pos, tst_y = base.get_split("test")
    ydtype = np.float32 if binary else np.int64
    trn_y, val_y, tst_y = (a.astype(ydtype) for a in (trn_y, val_y, tst_y))

    # Repeats re-roll the subgraph split, never the edges or the model config
    # (reference: datasets.py:119-123 only permutes the mask), so the graph
    # on the card and the Trainer are reused across repeats; the parameters,
    # Adam, the plateau state and the dropout stream are re-drawn per seed.
    trainer = None if cache is None else cache.get("trainer")
    if trainer is None:
        x = torch.from_numpy(base.x.astype(np.int64)).to(device)
        graph = build_graph(
            base.edge_index, base.edge_weight, base.n_node, cfg.aggr,
            materialize_dense=(
                None if spmm_mode is None else spmm_mode == "dense"
            ),
            dense_dtype=cfg.dense_dtype,
            materialize_bcsr=spmm_mode == "pallas",
            sparse_layout=cfg.sparse_layout,
            device=device,
        )
        model = make_glass_model(cfg, base, spmm_mode, seed=seed,
                                 device=device)
        trainer = Trainer(model, graph, x, tcfg)
        if cache is not None:
            cache["trainer"] = trainer
    init_params(trainer.model, cfg, base, spmm_mode, seed)
    trainer.init(seed + 1)  # Adam, plateau, and dropout from seed + 1
    if cfg.node_emb is not None:
        _load_pretrained_embedding(trainer.model, cfg.node_emb)

    num_div = tst_y.shape[0] / cfg.batch_size
    if cfg.dataset in SYNTHETIC_DATASETS:
        num_div /= 5
    eval_after = 100 / num_div
    stop_after = 100 / num_div

    # eval loaders shuffle (reference GLASSTest.py:118-119): batch composition
    # sets the zero-one labels, so each evaluation re-draws its batches.
    # Scores are counted on the card by default (one (3,) readback per
    # evaluation); GLASS_TPU_HOST_EVAL_METRICS=1 reads the logits back and
    # scores them on the host; --report_auroc does so for test probes.
    device_metrics = os.environ.get("GLASS_TPU_HOST_EVAL_METRICS", "0") != "1"

    def _device_score(pos_s, y_s):
        b, y_p, _ = make_eval_batches(pos_s, y_s, cfg.batch_size, rng)
        y_pad, mask = pad_eval_labels(y_p, b.shape[0], cfg.batch_size)
        return trainer.evaluate_score(b, y_pad, mask)

    def val_score_fn():
        if device_metrics:
            return _device_score(val_pos, val_y)
        b, y_p, n_real = make_eval_batches(val_pos, val_y, cfg.batch_size, rng)
        return score_fn(trainer.evaluate(b, n_real), y_p)

    def tst_score():
        if device_metrics and not cfg.report_auroc:
            return _device_score(tst_pos, tst_y)
        b, y_p, n_real = make_eval_batches(tst_pos, tst_y, cfg.batch_size, rng)
        logits = trainer.evaluate(b, n_real)
        if cfg.report_auroc:
            from glass_tpu_torch.train.metrics import auroc_from_logits

            try:
                log(f"  tst auroc {auroc_from_logits(logits, y_p):.4f}")
            except ValueError:  # degenerate split (single class present)
                pass
        return score_fn(logits, y_p)

    nb_per_epoch = trn_y.shape[0] // cfg.batch_size
    meter = StepMeter(
        # one SpMM edge-traversal per conv layer, forward; backward ~doubles
        edges_per_step=base.edge_index.shape[1] * cfg.conv_layer * 2,
        subgraphs_per_step=cfg.batch_size,
    )
    val_score, tst_best, early_stop = 0.0, 0.0, 0
    t0 = time.time()

    # Full-state resume: parameters, Adam, plateau, both random streams and
    # the protocol counters are restored, so the continued run draws the
    # batches the uninterrupted run would have drawn.
    state_path = None
    start_epoch = 0
    if cfg.ckpt_dir is not None:
        state_path = Path(cfg.ckpt_dir) / f"{cfg.dataset}_seed{seed}_state.npz"
        if cfg.resume and state_path.exists():
            from glass_tpu_torch.utils.checkpoint import load_run_state

            trainer.plateau, meta = load_run_state(
                state_path, model=trainer.model, optimizer=trainer.optimizer,
                generator=trainer.generator, np_rng=rng)
            start_epoch = meta["epoch"] + 1
            val_score = meta["val_score"]
            tst_best = meta["tst_best"]
            early_stop = meta["early_stop"]
            log(f"resumed at epoch {start_epoch} (val {val_score:.4f})")

    def save_state(epoch):
        if state_path is None:
            return
        from glass_tpu_torch.utils.checkpoint import save_run_state

        save_run_state(
            state_path, model=trainer.model, optimizer=trainer.optimizer,
            plateau=trainer.plateau, generator=trainer.generator, np_rng=rng,
            epoch=epoch, val_score=val_score, tst_best=tst_best,
            early_stop=early_stop,
        )

    i = start_epoch - 1
    loss_val = float("nan")
    for i in range(i + 1, cfg.max_epochs):
        pos_b, y_b = make_train_batches(rng, trn_pos, trn_y, cfg.batch_size)
        # every 10th epoch is timed (the epoch ends in its losses' readback)
        metered = i % 10 == 0
        if metered:
            meter.start()  # time the training epoch only, not the evals
        loss_val = trainer.train_epoch(pos_b, y_b).loss
        if metered:
            meter.tick(nb_per_epoch)
        if i >= eval_after:
            score = val_score_fn()
            if score > val_score:
                early_stop = 0
                val_score = score
                tst_best = tst_score()
                log(f"iter {i} loss {loss_val:.4f} val {val_score:.4f} tst {tst_best:.4f}")
                if cfg.ckpt_dir is not None:
                    from glass_tpu_torch.utils.checkpoint import save_checkpoint

                    save_checkpoint(
                        f"{cfg.ckpt_dir}/{cfg.dataset}_seed{seed}_best.npz",
                        trainer.model,
                    )
            elif score >= val_score - 1e-5:
                probe = tst_score()
                tst_best = max(probe, tst_best)
                log(f"iter {i} loss {loss_val:.4f} val {val_score:.4f} tst {probe:.4f}")
            else:
                early_stop += 1
                if i % 10 == 0:
                    log(f"iter {i} loss {loss_val:.4f} val {score:.4f} tst {tst_score():.4f}")
        if val_score >= 1 - 1e-5:
            early_stop += 1
        if (i + 1) % cfg.ckpt_every == 0:
            save_state(i)
        if early_stop > stop_after:
            break
    if (i + 1) % cfg.ckpt_every != 0:  # final state, unless just saved
        save_state(i)
    log(
        f"end: epoch {i + 1}, train time {time.time() - t0:.2f} s, "
        f"val {val_score:.3f}, tst {tst_best:.3f}"
    )
    log(f"throughput: {meter.summary()}")
    return tst_best


def _load_pretrained_embedding(model: GLASS, emb: np.ndarray) -> None:
    """Warm-starts the trunk embedding table from a pretrained (N, H) array
    in place (reference: GLASSTest.py:153-157,
    Embedding.from_pretrained(freeze=False))."""
    tgt = model.conv.input_emb.weight
    assert tuple(tgt.shape) == emb.shape, \
        f"pretrained emb {emb.shape} != table {tuple(tgt.shape)}"
    with torch.no_grad():
        tgt.copy_(torch.as_tensor(emb, dtype=tgt.dtype))
