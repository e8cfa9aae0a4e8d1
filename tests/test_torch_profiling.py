"""The port's ``trace`` and ``nan_check_mode``
(``glass_tpu_torch/utils/profiling.py``) on the CPU, beside glass_tpu's.

``trace`` writes one non-empty Chrome trace under the directory it is
given, holding the block's name and its ops. ``nan_check_mode`` raises
``FloatingPointError`` where JAX's raises it, at an op that makes a NaN in
the forward (the same inputs through both packages), raises as well at a
backward op that makes one from finite forward values, lets a finite
GNN-seg step through, and leaves autograd's anomaly switches and the
dispatch mode stack as it found them, on a normal exit and on an error.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from glass_tpu.utils import profiling as jprof
from glass_tpu_torch.nn.seg import GSegGNN
from glass_tpu_torch.utils import profiling as tprof


def switches():
    return (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            _get_current_dispatch_mode())


def seg_step():
    """One GNN-seg forward and backward at a small size."""
    rng = np.random.default_rng(0)
    adj = torch.from_numpy(rng.random((3, 5, 5), dtype=np.float32))
    feats = torch.from_numpy(rng.random((3, 5, 4), dtype=np.float32))
    mask = torch.ones(3, 5, dtype=torch.bool)
    model = GSegGNN(4, 8, 2, 2, device="cpu")
    model(adj, adj, feats, mask).sum().backward()
    return model


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace("seg_step", str(tmp_path)):
        seg_step()
    files = list(tmp_path.glob("seg_step.*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "seg_step" in names and "aten::bmm" in names


def test_nan_check_mode_raises_in_the_forward_as_jax():
    x = np.array([-1.0, 4.0], np.float32)
    with pytest.raises(FloatingPointError):
        with jprof.nan_check_mode():
            jax.jit(jnp.sqrt)(jnp.asarray(x)).block_until_ready()
    before = switches()
    with pytest.raises(FloatingPointError, match="sqrt"):
        with tprof.nan_check_mode():
            torch.sqrt(torch.from_numpy(x))
    assert switches() == before
    assert torch.isnan(torch.sqrt(torch.from_numpy(x))).any()  # off again


def test_nan_check_mode_raises_in_the_backward():
    before = switches()
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises((FloatingPointError, RuntimeError)):
        with tprof.nan_check_mode():
            y = torch.sqrt(x) * 0.0  # finite: 0; d/dx: 0 * inf = nan
            assert torch.isfinite(y).all()
            y.sum().backward()
    assert switches() == before
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()  # off again: no error
    assert torch.isnan(x.grad).all()


def test_nan_check_mode_lets_a_finite_step_through():
    before = switches()
    with tprof.nan_check_mode():
        assert switches()[2] is not None and torch.is_anomaly_enabled()
        model = seg_step()
    assert switches() == before
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
