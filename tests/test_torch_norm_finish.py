"""The fused GraphNorm's reductions as single launches that finish their own
per-feature algebra (``glass_tpu_torch/ops/fused_norm.py``,
``csrc/graph_norm.cu``), on the CPU.

- The plain finishes (the derived vectors K1, K2 and K4 return beside
  their sums) against the same expressions evaluated in JAX on the
  interpret-mode sums of ``pallas_norm._stats`` and ``_bwd_reduce_call``,
  each side summing x on its own: forward vectors (mu, am, var, g, h)
  within rtol 1e-5 (tests/test_pallas_norm.py's forward tolerance);
  backward vectors (a, c2, c1, dw, db, dalpha), scaled by s^3 and by sums
  in another order, within 1e-4 * max|ref| (this file's and
  tests/test_torch_fused_norm.py's VJP bound).
- The autograd Function runs the five passes and no aten operation of its
  own (a TorchDispatchMode around stub passes).
- The reductions' launch geometry (``reduce_grid``): P, rows per CTA and
  the workspace, and the grid-stride walk covering every row once.

chip_smoke.py holds the CUDA kernels against the plain versions on the card.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from glass_tpu.ops import pallas_norm as jpn
from glass_tpu_torch.ops import fused_norm as fn

EPS = 1e-5
FORWARD_RTOL = 1e-5
BACKWARD_TOL = 1e-4  # * max|ref|
H100_SMS = 132


def finish_inputs(seed=4, n=777, h=33):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(n, h)).astype(np.float32)
    w = rng.normal(size=h).astype(np.float32)
    b = rng.normal(size=h).astype(np.float32)
    ms = (rng.normal(size=h) * 0.3 + 1).astype(np.float32)
    return x, dy, w, b, ms


def jax_finishes(x, dy, w, b, ms, dtype):
    """pallas_norm's per-feature expressions (``_fwd``, ``_bwd``) on the
    interpret-mode sums of its K1/K2 (``_stats``) and K4 passes."""
    h = x.shape[1]
    jx = jnp.asarray(x).astype(dtype)
    jdy = jnp.asarray(dy).astype(dtype)
    w, b, ms = (jnp.asarray(v) for v in (w, b, ms))
    mu, var, am, xp, npad, hpad = jpn._stats(jx, ms, EPS, True)
    n = x.shape[0]
    s = jax.lax.rsqrt(var + EPS)
    g = w * s
    hv = b - g * ms * mu
    dyp, _, _ = jpn._pads(jdy)
    r1, r2 = jpn._bwd_reduce_call(dyp, xp, am, True, npad, hpad)
    r1, r2 = r1[0, :h], r2[0, :h]
    mo = mu * (1.0 - ms)
    a = w * s
    c2 = -(w * s**3 / n) * r2
    c1 = -(w * ms * s / n) * r1 - c2 * (ms * mu + ms * mo)
    dalpha = -w * mu * s * r1 + w * mu * mo * s**3 * r2
    out = dict(mu=mu, am=am[0, :h], var=var, g=g, h=hv, a=a, c2=c2, c1=c1,
               dw=s * r2, db=r1, dalpha=dalpha)
    return {k: np.asarray(v) for k, v in out.items()}


def port_finishes(x, dy, w, b, ms, dtype):
    tx = torch.from_numpy(x).to(dtype)
    tdy = torch.from_numpy(dy).to(dtype)
    tw, tb, tms = (torch.from_numpy(v) for v in (w, b, ms))
    k1 = dict(zip(fn.OUTPUTS["colsum"], fn.colsum(tx, tms)))
    k2 = dict(zip(fn.OUTPUTS["varsum"],
                  fn.varsum(tx, k1["am"], k1["mu"], tms, tw, tb, EPS)))
    k4 = dict(zip(fn.OUTPUTS["bwd_reduce"],
                  fn.bwd_reduce(tdy, tx, k1["am"], k1["mu"], k2["var"], tw,
                                tms, EPS)))
    return {k: v.numpy() for k, v in {**k1, **k2, **k4}.items()}


FORWARD = ("mu", "am", "var", "g", "h")
BACKWARD = ("a", "c2", "c1", "dw", "db", "dalpha")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", ["forward", "backward"])
def test_plain_finishes_match_jax_expressions_on_pallas_sums(part, dtype):
    args = finish_inputs()
    ref = jax_finishes(*args, getattr(jnp, dtype))
    out = port_finishes(*args, getattr(torch, dtype))
    for name in FORWARD if part == "forward" else BACKWARD:
        assert out[name].dtype == np.float32 and out[name].shape == (33,)
        if part == "forward":
            np.testing.assert_allclose(out[name], ref[name],
                                       rtol=FORWARD_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(
                out[name], ref[name], rtol=0,
                atol=BACKWARD_TOL * np.abs(ref[name]).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_finishes_match_the_functions_own_algebra(dtype):
    """The outputs the Function takes from the finishes against the
    unfused formula's (mu, var from ops/norm.py's means; y and the
    gradients through autograd of graph_norm) at f32."""
    from glass_tpu_torch.ops.norm import graph_norm

    x, dy, w, b, ms = finish_inputs(seed=5, n=500, h=24)
    out = port_finishes(x, dy, w, b, ms, dtype)
    xf = torch.from_numpy(x).to(dtype).float()
    mu = xf.mean(0)
    np.testing.assert_allclose(out["mu"], mu.numpy(), rtol=FORWARD_RTOL)
    var = ((xf - mu * torch.from_numpy(ms)) ** 2).mean(0)
    np.testing.assert_allclose(out["var"], var.numpy(), rtol=FORWARD_RTOL)
    params = [torch.from_numpy(v).requires_grad_() for v in (w, b, ms)]
    xk = xf.clone().requires_grad_()
    y = graph_norm(xk, *params)
    grads = torch.autograd.grad(y, [xk, *params],
                                torch.from_numpy(dy).to(dtype).float())
    for name, g in zip(("dw", "db", "dalpha"), grads[1:]):
        np.testing.assert_allclose(out[name], g.numpy(), rtol=0,
                                   atol=BACKWARD_TOL * g.abs().max().item(),
                                   err_msg=name)


class _Record(TorchDispatchMode):
    """Every aten operation dispatched inside the block, by name."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_runs_no_tensor_op_between_the_passes(dtype):
    """With stub passes that hand back results made beforehand, forward and
    backward through the autograd Function dispatch no aten operation: the
    per-feature algebra lives in the passes."""
    x, dy, w, b, ms = finish_inputs(seed=6, n=40, h=8)
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    params = [torch.from_numpy(v).requires_grad_() for v in (w, b, ms)]
    tdy = torch.from_numpy(dy).to(dtype)
    with torch.no_grad():  # every pass's result, made outside the mode
        k1 = fn.PLAIN.colsum(tx, params[2])
        k2 = fn.PLAIN.varsum(tx, k1[2], k1[1], params[2], *params[:2], EPS)
        y = fn.PLAIN.affine(tx, k2[2], k2[3])
        k4 = fn.PLAIN.bwd_reduce(tdy, tx, k1[2], k1[1], k2[1], params[0],
                                 params[2], EPS)
        dx = fn.PLAIN.bwd_dx(tdy, tx, *k4[2:5])
    log = []

    def stub(name, result):
        def run(*args):
            log.append(name)
            return result
        return run

    passes = SimpleNamespace(colsum=stub("colsum", k1),
                             varsum=stub("varsum", k2),
                             affine=stub("affine", y),
                             bwd_reduce=stub("bwd_reduce", k4),
                             bwd_dx=stub("bwd_dx", dx))
    with _Record(log):
        out = fn._FusedGraphNorm.apply(tx, *params, EPS, passes)
        grads = torch.autograd.grad(out, [tx, *params], tdy)
    assert log == list(fn.KERNELS)
    assert grads[0] is dx
    assert [g is r for g, r in zip(grads[1:], k4[5:])] == [True] * 3


def test_one_launch_per_pass():
    assert fn.LAUNCHES_PER_PASS == {k: 1 for k in fn.KERNELS}
    assert sum(fn.LAUNCHES_PER_PASS.values()) == 5
    assert set(fn.OUTPUTS) == set(fn.SUMS) == {"colsum", "varsum",
                                               "bwd_reduce"}


def walk(grid: fn.ReduceGrid, n: int) -> list:
    """Rows each CTA reads on the kernel's grid-stride walk: tiles
    blockIdx.x, + P, + 2P, ... of rows_per_tile rows."""
    tiles = -(-n // grid.rows_per_tile)
    return [sum(min(grid.rows_per_tile, n - k * grid.rows_per_tile)
                for k in range(b, tiles, grid.p)) for b in range(grid.p)]


@pytest.mark.parametrize("f", [17, 64, 200])
@pytest.mark.parametrize("n", [1, 1000, 3001, 57_344])
def test_reduce_grid(n, f):
    for itemsize in (4, 2):  # f32, bf16
        vmax = 16 // itemsize
        for v in {1, vmax if f % vmax == 0 else 1}:
            for sums in (1, 2):
                grid = fn.reduce_grid(n, f, v, sums, H100_SMS)
                groups = -(-f // v)
                assert grid.col_tiles == 1  # F <= RED_THREADS groups
                assert grid.rows_per_tile == fn.RED_THREADS // groups
                tiles = -(-n // grid.rows_per_tile)
                assert grid.p == min(H100_SMS, tiles)
                rows = walk(grid, n)
                assert sum(rows) == n  # every row read once
                assert max(rows) == grid.rows_per_cta
                assert grid.workspace_bytes == (fn.PARTIALS_OFFSET
                                                + sums * grid.p * f * 4)


def test_reduce_grid_at_em_user():
    """57,344 x 64: one CTA an SM, 14 row tiles of 32 rows (f32) or 7 of 64
    (bf16) at most per CTA, K4's partials 66 KiB."""
    f32 = fn.reduce_grid(57_344, 64, 4, 2, H100_SMS)
    assert f32 == fn.ReduceGrid(132, 1, 32, 448, 256 + 2 * 132 * 64 * 4)
    bf16 = fn.reduce_grid(57_344, 64, 8, 1, H100_SMS)
    assert bf16 == fn.ReduceGrid(132, 1, 64, 448, 256 + 132 * 64 * 4)
    # P differs between the small phases' N, so a counter left non-zero
    # by one launch would show in the next
    assert len({fn.reduce_grid(n, 64, 4, 1, H100_SMS).p
                for n in (3001, 1000)}) == 2


def test_reduce_grid_wide_and_empty():
    wide = fn.reduce_grid(10, 5000, 1, 1, H100_SMS)
    assert (wide.col_tiles, wide.rows_per_tile, wide.p) == (10, 1, 10)
    empty = fn.reduce_grid(0, 64, 4, 2, H100_SMS)
    assert (empty.p, empty.rows_per_cta) == (1, 0)


def test_workspace_is_kept_per_device_and_stream_and_grows(monkeypatch):
    monkeypatch.setattr(fn, "_WORKSPACE", {})
    cpu = torch.device("cpu")
    first = fn._workspace(cpu, 7, 1000)
    assert first.numel() == 1000 and not first.any()
    assert fn._workspace(cpu, 7, 600) is first
    assert fn._workspace(cpu, 8, 600) is not first
    grown = fn._workspace(cpu, 7, 4000)
    assert grown.numel() == 4000 and fn._workspace(cpu, 7, 10) is grown
