"""The port's HBM read probes (``glass_tpu_torch/ops/hbm_probe.py``, the
plain versions of ``csrc/hbm_probe.cu``) against the Pallas probe kernels
of ``tools/hbm_probe.py``, run in interpret mode on the CPU, and the timing
arithmetic of ``tools/torch_hbm_probe.py``.

- ``_read_kernel`` at S 1, 2 and 4 and ``_read2_kernel`` at S 2 and 4, with
  iters 1 and 2, on data that differs in every element: the port's result
  equals the Pallas kernel's exactly (both are a copy of 8 x 128 values per
  chunk).
- The shape rules (stripes divide the chunk, at least 8 rows a stripe, an
  even chunk count, 512-lane f32 rows) raise ``ValueError``.
- The tool's differential timing recovers the per-pass time from synthetic
  timers, taking the least of three at both ends.
The CUDA kernel is held bit-equal to the same plain versions on the card by
chip_smoke.py.
"""

import functools
import importlib.util
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu_torch.ops import hbm_probe as hp

REPO = Path(__file__).resolve().parent.parent


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_probe():
    """tools/hbm_probe.py with every pl.pallas_call in interpret mode (its
    module environment restored)."""
    keys = ("JAX_COMPILATION_CACHE_DIR",
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in keys}
    mod = load_module("hbm_probe_tpu", REPO / "tools" / "hbm_probe.py")
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    real = mod.pl

    class InterpretPallas:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def pallas_call(*args, **kwargs):
            return real.pallas_call(*args, interpret=True, **kwargs)

    mod.pl = InterpretPallas()
    return mod


@pytest.fixture(scope="module")
def tool():
    return load_module("torch_hbm_probe", REPO / "tools" / "torch_hbm_probe.py")


def tpu_read2(mod, xs, chunk_rows, iters):
    """The pallas_call of tools/hbm_probe.py::dma_read2_probe."""
    from jax.experimental.pallas import tpu as pltpu

    stripes = len(xs)
    n_steps = xs[0].shape[0] // (chunk_rows // stripes)
    kernel = functools.partial(mod._read2_kernel, stripes=stripes,
                               chunk_rows=chunk_rows, n_steps=n_steps,
                               iters=iters)
    call = mod.pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_steps * 8, 128), jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(iters, n_steps),
            in_specs=[mod.pl.BlockSpec(memory_space=mod.pl.ANY)] * stripes,
            out_specs=mod.pl.BlockSpec((8, 128), lambda it_, i: (i, 0)),
            scratch_shapes=[
                pltpu.VMEM((mod.NBUF, chunk_rows, mod.LANES), jnp.float32),
                pltpu.SemaphoreType.DMA((mod.NBUF, stripes)),
            ],
        ),
    )
    return np.asarray(call(*[jnp.asarray(x) for x in xs]))


CHUNK, STEPS = 32, 4


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("stripes", [1, 2, 4])
def test_read_matches_the_tpu_kernel(tpu_probe, stripes, iters):
    rng = np.random.default_rng(stripes * 10 + iters)
    x = rng.normal(size=(STEPS * CHUNK, hp.LANES)).astype(np.float32)
    call = tpu_probe._make_read_call(x.shape, stripes, CHUNK, STEPS, iters)
    ref = np.asarray(call(jnp.asarray(x)))
    out = hp.hbm_read(torch.from_numpy(x), CHUNK, stripes, iters)
    assert out.dtype == torch.float32 and out.shape == (STEPS * 8, 128)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        hp.hbm_read_reference(torch.from_numpy(x), CHUNK, stripes, iters)
        .numpy(), ref)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("stripes", [2, 4])
def test_read2_matches_the_tpu_kernel(tpu_probe, stripes, iters):
    rng = np.random.default_rng(100 + stripes * 10 + iters)
    xs = [rng.normal(size=(STEPS * CHUNK // stripes, hp.LANES))
          .astype(np.float32) for _ in range(stripes)]
    ref = tpu_read2(tpu_probe, xs, CHUNK, iters)
    out = hp.hbm_read2([torch.from_numpy(x) for x in xs], CHUNK, iters)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape, chunk_rows, stripes, iters, match", [
    ((128, 512), 32, 3, 1, "multiple of stripes"),
    ((128, 512), 32, 8, 1, "at least 8 rows"),
    ((96, 512), 32, 1, 1, "multiple of 2"),
    ((100, 512), 32, 1, 1, "multiple of chunk_rows"),
    ((128, 256), 32, 1, 1, r"\(rows, 512\)"),
    ((128, 512), 32, 16, 1, "stripes must lie"),
    ((128, 512), 32, 1, 0, "iters"),
])
def test_shape_refusals(shape, chunk_rows, stripes, iters, match):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        hp.hbm_read(x, chunk_rows, stripes, iters)


def test_read2_shape_refusals():
    xs = [torch.zeros(64, 512), torch.zeros(32, 512)]
    with pytest.raises(ValueError, match="one shape"):
        hp.hbm_read2(xs, 32, 1)
    with pytest.raises(ValueError, match="whole stripes"):
        hp.hbm_read2([torch.zeros(60, 512)] * 2, 32, 1)
    with pytest.raises(ValueError, match="multiple of 2"):
        hp.hbm_read2([torch.zeros(48, 512)] * 2, 32, 1)


def test_tiling_fits_the_card():
    for rows_s, stripes in ((2048, 1), (1800, 1), (256, 8), (8, 8),
                            (1 << 16, 1)):
        ctas, q, smem = hp.tiling(rows_s, stripes, 132)
        assert ctas * q >= rows_s > (ctas - 1) * q
        assert smem <= hp.SMEM_CAP and q * hp.ROW_BYTES <= hp.TX_LIMIT


def test_differential_timing(tool):
    calls = []

    def timer(n):  # 2 ms of fixed cost, 0.25 ms a pass, noise on 2 of 3
        calls.append(n)
        noise = 1e-3 if len(calls) % 3 else 0.0
        return 2e-3 + n * 2.5e-4 + noise

    assert tool.differential_seconds(timer, 40) == pytest.approx(2.5e-4,
                                                                 rel=1e-12)
    assert calls == [40] * 3 + [10] * 3
    assert tool.differential_seconds(lambda n: n * 1e-3, 3) == \
        pytest.approx(1e-3)
    with pytest.raises(ValueError, match="no passes"):
        tool.differential_seconds(timer, 1)
    assert tool.probe_rows(512, 2048) == 262144
    assert tool.probe_rows(100, 2048) % (8 * 2048) == 0


def test_tool_exits_nonzero_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--mb", "1"]) == 1
