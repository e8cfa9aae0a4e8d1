"""Reads ``glass_tpu`` parameter checkpoints into the port's modules.

``glass_tpu.utils.checkpoint.save_checkpoint(path.npz, params)`` writes one
array per flax leaf, keyed by its tree path, e.g.
``/params/conv/conv_0/trans_1/kernel``, ``/params/conv/input_emb/embedding``,
``/params/conv/gn_out/mean_scale`` or ``/params/pred_0/bias``. The port's
modules carry the flax names, so each path maps onto one ``state_dict`` key:
drop ``params``, join with dots, and rename the leaf (a flax ``kernel`` is
``(in, out)`` and becomes the transposed ``weight``; an ``embedding``
becomes ``weight``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn


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
    if len(parts) < 3 or parts[0] != "params":
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
