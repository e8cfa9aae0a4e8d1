"""Parameter checkpoints interchangeable with ``glass_tpu``, and the
port's own run-state checkpoints (counterpart of
``glass_tpu/utils/checkpoint.py``).

``glass_tpu.utils.checkpoint.save_checkpoint(path.npz, params)`` writes one
array per flax leaf, keyed by its tree path, e.g.
``/params/conv/conv_0/trans_1/kernel``, ``/params/conv/input_emb/embedding``,
``/params/conv/gn_out/mean_scale`` or ``/params/pred_0/bias`` (GLASS), or
``/params/conv/conv_0/trans/kernel`` or ``/params/pred/TorchLinear_1/bias``
(the pretraining ``EdgeGNN``, whose MLP head keeps flax's automatic
names), or ``/params/conv_0/kernel`` (a GCN layer),
``/params/conv_0/TorchLinear_0/kernel`` (a GIN layer),
``/params/gn_0/mean_scale`` or ``/params/pred/TorchLinear_0/bias``
(GNN-seg's ``GSegGNN``), or ``/params/proj/kernel`` and
``/params/att_dst`` (``AttentionConv``). The port's modules carry the
flax names, so each path maps onto one ``state_dict`` key:
drop ``params``, join with dots, and rename the leaf (a flax ``kernel`` is
``(in, out)`` and becomes the transposed ``weight``; an ``embedding``
becomes ``weight``). ``params_from_flax`` reads that layout into a model and
``params_to_flax`` writes a model into it, so a checkpoint saved by either
package loads into both.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn


def atomic_savez(path: Path, **arrays) -> None:
    """np.savez through a temp file beside ``path`` and os.replace, so a
    kill mid-write never leaves a truncated .npz at the final path. The
    temp name carries the process id: the ranks of a multi-process run
    may write one cache file at once."""
    path = Path(path)
    # the temp name keeps the .npz suffix: np.savez appends one otherwise
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    """The arrays of a ``glass_tpu`` ``.npz`` checkpoint, by key."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _torch_key(key: str):
    """(state_dict key, transpose?) of one flax parameter path."""
    parts = key.strip("/").split("/")
    if len(parts) < 2 or parts[0] != "params":
        raise KeyError(f"not a flax parameter path: {key!r}")
    *path, leaf = parts[1:]
    if leaf == "kernel":
        return ".".join(path + ["weight"]), True
    if leaf == "embedding":
        return ".".join(path + ["weight"]), False
    return ".".join(path + [leaf]), False


def params_from_flax(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copies flax parameters (flattened as ``glass_tpu`` checkpoints flatten
    them) into ``model`` in place and returns it. Raises ``KeyError`` on a
    missing or unexpected key and ``ValueError`` on a shape mismatch."""
    state = model.state_dict()
    converted = {}
    for key, arr in flat.items():
        name, transpose = _torch_key(key)
        converted[name] = np.asarray(arr).T if transpose else np.asarray(arr)
    missing = sorted(set(state) - set(converted))
    unexpected = sorted(set(converted) - set(state))
    if missing or unexpected:
        raise KeyError(
            f"flax parameters do not match the model: missing {missing}, "
            f"unexpected {unexpected}")
    for name, arr in converted.items():
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(
                f"{name}: flax shape {tuple(arr.shape)} != model shape "
                f"{tuple(state[name].shape)}")
    with torch.no_grad():
        for name, arr in converted.items():
            state[name].copy_(torch.tensor(arr))
    return model


def params_to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax`: ``model``'s parameters as
    flattened flax leaves (f32 numpy arrays on the host), keyed as
    ``glass_tpu`` checkpoints key them."""
    flat = {}
    for name, value in model.state_dict().items():
        *path, leaf = name.split(".")
        arr = value.detach().cpu().numpy()
        module = model.get_submodule(".".join(path))
        if isinstance(module, nn.Embedding) and leaf == "weight":
            leaf = "embedding"
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        flat["/" + "/".join(["params", *path, leaf])] = np.ascontiguousarray(arr)
    return flat


def save_checkpoint(path, model: nn.Module) -> None:
    """Saves ``model``'s parameters as a ``glass_tpu`` ``.npz`` parameter
    checkpoint (a path without the suffix gets it), loadable by
    ``Predictor.from_checkpoint`` and by ``glass_tpu``'s ``load_checkpoint``."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_savez(path, **params_to_flax(model))


def save_run_state(path, *, model: nn.Module, optimizer, plateau, generator,
                   np_rng, epoch: int, val_score: float, tst_best: float,
                   early_stop: int) -> None:
    """Everything a training run needs to resume bit-exactly: the model's
    ``state_dict``, the Adam state, the plateau state, the dropout
    generator's state, the numpy Generator's state (batch shuffles and eval
    permutations draw from it) and the protocol counters.

    The file is the port's own ``.npz`` layout and is not interchangeable
    with a ``glass_tpu`` run state: the dropout streams of the two packages
    differ by design, and Adam's state is PyTorch's. Adam's hyperparameters
    are not stored: the Trainer sets them, and the learning rate comes from
    the plateau state each epoch."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {f"model/{k}": v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}
    opt = optimizer.state_dict()
    for idx, state in opt["state"].items():
        for name, v in state.items():
            flat[f"adam/{idx}/{name}"] = torch.as_tensor(v).cpu().numpy()
    flat["dropout_rng"] = generator.get_state().numpy()
    flat["__meta__"] = np.asarray(json.dumps(dict(
        epoch=int(epoch), val_score=float(val_score),
        tst_best=float(tst_best), early_stop=int(early_stop),
        np_rng=np_rng.bit_generator.state,
        plateau=[float(plateau.lr), float(plateau.best), int(plateau.num_bad)],
    )))
    atomic_savez(path, **flat)


def load_run_state(path, *, model: nn.Module, optimizer, generator, np_rng):
    """Restores a :func:`save_run_state` checkpoint in place into
    ``model``, ``optimizer``, ``generator`` and ``np_rng``. Returns
    (plateau, meta) with meta's epoch, val_score, tst_best and early_stop.
    The optimizer keeps its own hyperparameters, its learning rate the same
    object (a device tensor that a captured step reads, on the card); its
    state tensors are new ones."""
    from glass_tpu_torch.train.schedule import PlateauState

    with np.load(Path(path), allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(str(arrays.pop("__meta__")))
    model.load_state_dict({k[len("model/"):]: torch.from_numpy(v)
                           for k, v in arrays.items() if k.startswith("model/")})
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in arrays.items():
        if k.startswith("adam/"):
            _, idx, name = k.split("/")
            state.setdefault(int(idx), {})[name] = torch.from_numpy(v)
    lrs = [group["lr"] for group in optimizer.param_groups]
    optimizer.load_state_dict({"state": state, "param_groups":
                               optimizer.state_dict()["param_groups"]})
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    generator.set_state(torch.from_numpy(arrays["dropout_rng"]))
    np_rng.bit_generator.state = meta.pop("np_rng")
    lr, best, num_bad = meta.pop("plateau")
    plateau = PlateauState(lr=np.float32(lr), best=np.float32(best),
                           num_bad=int(num_bad))
    return plateau, meta
