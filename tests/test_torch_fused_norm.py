"""The port's fused GraphNorm (``glass_tpu_torch/ops/fused_norm.py``)
against glass_tpu's (``glass_tpu/ops/pallas_norm.py``), whose Pallas kernels
run in interpret mode on the CPU as tests/test_pallas_norm.py runs them.

On the CPU the port runs the plain versions of its five CUDA passes, so
these tests hold the plain versions (and the autograd algebra around them)
against the JAX kernels; chip_smoke.py holds the CUDA kernels against the
same plain versions on the card.

Tolerances:
- forward f32: rtol 1e-5, atol 1e-5 (tests/test_pallas_norm.py's own);
- VJP (dx, dw, db, dalpha) f32: rtol 1e-4, atol 1e-5 * max|ref| (dw, db
  and dalpha reach 1e4 here; measured at most 3.4e-7 * max);
- bf16 x: y and dx within one bf16 ulp of the reference value (2^-7 |ref|,
  plus 1e-6 for values that cancel to near zero in f32);
- a zero-variance column (s = rsqrt(eps) ~ 316 amplifies the rounding of
  c - alpha*mu, s^3 ~ 3e7 in the gradients, tests/test_pallas_norm.py:94-96):
  its values are rounding noise in both packages, held within
  2e-3 * max|ref| of the whole tensor (measured at most 6.7e-4 over seeds
  0-2); every other column keeps the tolerances above;
- per pass against its Pallas kernel: sums within 1e-6 * max|ref|
  (f32 sums in another order), elementwise passes within 1e-6 * max|ref| in
  f32 and one bf16 ulp in bf16;
- GLASS with GLASS_TPU_FUSED_NORM=1 in both packages against flax with the
  same weights: logits and gradients at tests/test_torch_model.py's
  rtol 1e-4, atol 1e-5 (gradients atol 1e-5 * max|grad|).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.ops import pallas_norm as jpn
from glass_tpu.ops.pallas_norm import fused_graph_norm as jax_fused
from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.ops.labeling import max_zero_one as jax_max_zero_one
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, build_graph, params_from_flax
from glass_tpu_torch.nn import modules as tmodules
from glass_tpu_torch.ops import fused_norm as fn
from glass_tpu_torch.ops.norm import graph_norm
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401

BF16_ULP = 2.0 ** -7
ZERO_VAR_TOL = 2e-3


def norm_inputs(seed, n, h, zero_col=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h)) * 3 + 1.5).astype(np.float32)
    w = rng.normal(size=h).astype(np.float32)
    b = rng.normal(size=h).astype(np.float32)
    a = (rng.normal(size=h) * 0.3 + 1).astype(np.float32)
    if zero_col is not None:
        x[:, zero_col] = 2.7
        a[zero_col] = 1.0
    return x, w, b, a, np.cos(np.arange(h)).astype(np.float32)


def jax_run(x, w, b, a, scale, dtype):
    jx = jnp.asarray(x).astype(dtype)
    args = [jnp.asarray(v) for v in (w, b, a)]

    def loss(x, w, b, a):
        return (jax_fused(x, w, b, a, 1e-5, True).astype(jnp.float32) ** 2
                * scale).sum()

    y = jax_fused(jx, *args, 1e-5, True)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jx, *args)
    return ([np.asarray(y.astype(jnp.float32))]
            + [np.asarray(g.astype(jnp.float32)) for g in grads])


def torch_run(x, w, b, a, scale, dtype, fused=fn.fused_graph_norm):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    params = [torch.from_numpy(v).requires_grad_() for v in (w, b, a)]
    y = fused(tx, *params)
    assert y.dtype == dtype
    (y.float() ** 2 * torch.from_numpy(scale)).sum().backward()
    assert tx.grad.dtype == dtype
    return [y.detach().float().numpy()] + [
        t.grad.float().numpy() for t in (tx, *params)]


NAMES = ("y", "dx", "dw", "db", "dalpha")


@pytest.mark.parametrize("h", [64, 200])
def test_plain_fused_norm_matches_jax_interpret(h):
    x, w, b, a, scale = norm_inputs(0, 3000, h)
    ref = jax_run(x, w, b, a, scale, jnp.float32)
    out = torch_run(x, w, b, a, scale, torch.float32)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
    for name, o, r in zip(NAMES[1:], out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_plain_fused_norm_bf16_within_one_ulp():
    x, w, b, a, scale = norm_inputs(0, 3000, 64)
    ref = jax_run(x, w, b, a, scale, jnp.bfloat16)
    out = torch_run(x, w, b, a, scale, torch.bfloat16)
    for name, o, r in zip(NAMES[:2], out[:2], ref[:2]):
        assert (np.abs(o - r) <= BF16_ULP * np.abs(r) + 1e-6).all(), name
    for name, o, r in zip(NAMES[2:], out[2:], ref[2:]):
        np.testing.assert_allclose(o, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_plain_fused_norm_zero_variance_column():
    col = 3
    x, w, b, a, scale = norm_inputs(0, 3000, 64, zero_col=col)
    ref = jax_run(x, w, b, a, scale, jnp.float32)
    out = torch_run(x, w, b, a, scale, torch.float32)
    keep = np.arange(64) != col
    for name, o, r in zip(NAMES, out, ref):
        big = np.abs(r).max()
        diff = np.abs(o - r)
        assert diff[..., col].max() <= ZERO_VAR_TOL * big, name
        np.testing.assert_allclose(
            o[..., keep], r[..., keep],
            rtol=1e-5 if name == "y" else 1e-4,
            atol=1e-5 if name == "y" else 1e-5 * big, err_msg=name)


def pallas_pass(kernel, x, dy, vecs):
    """One JAX Pallas pass in interpret mode, on the JAX wrapper's padding."""
    n, h = x.shape
    xp, npad, hpad = jpn._pads(jnp.asarray(x))
    rv = [jpn._rowvec(jnp.asarray(v), hpad) for v in vecs]
    kw = dict(interpret=True, npad=npad, hpad=hpad)
    if kernel == "colsum":
        (s,) = jpn._reduce_call(jpn._colsum_kernel, 1, xp, **kw)
        return [np.asarray(s[0, :h])]
    if kernel == "varsum":
        import functools

        (s,) = jpn._reduce_call(functools.partial(jpn._varsum_kernel,
                                                  n_real=n), 1, xp, *rv, **kw)
        return [np.asarray(s[0, :h])]
    if kernel == "bwd_reduce":
        dyp, _, _ = jpn._pads(jnp.asarray(dy))
        r1, r2 = jpn._bwd_reduce_call(dyp, xp, rv[0], True, npad, hpad)
        return [np.asarray(r1[0, :h]), np.asarray(r2[0, :h])]
    if kernel == "affine":
        out = jpn._elementwise_call(jpn._affine_kernel, [xp], rv, x.dtype,
                                    True, npad, hpad)
    else:
        dyp, _, _ = jpn._pads(jnp.asarray(dy))
        out = jpn._elementwise_call(jpn._bwd_dx_kernel, [dyp, xp], rv,
                                    x.dtype, True, npad, hpad)
    return [np.asarray(out[:n, :h].astype(jnp.float32))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", fn.KERNELS)
def test_each_plain_pass_matches_its_pallas_kernel(kernel, dtype):
    rng = np.random.default_rng(1)
    n, h = 777, 33  # the JAX wrapper pads both; the port bound-checks
    x = (rng.normal(size=(n, h)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(n, h)).astype(np.float32)
    n_vecs = {"colsum": 0, "varsum": 1, "affine": 2, "bwd_reduce": 1,
              "bwd_dx": 3}[kernel]
    vecs = [rng.normal(size=h).astype(np.float32) for _ in range(n_vecs)]
    # the finishes' own inputs (mu, mean_scale, weight, bias, var > 0): the
    # raw sums do not read them
    mu, ms, w, b = (torch.from_numpy(rng.normal(size=h).astype(np.float32))
                    for _ in range(4))
    var = torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(np.float32))
    jx = jnp.asarray(x).astype(dtype)
    jdy = jnp.asarray(dy).astype(dtype)
    ref = pallas_pass(kernel, jx, jdy, vecs)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tdy = torch.from_numpy(dy).to(tdt)
    tv = [torch.from_numpy(v) for v in vecs]
    args = {"colsum": (tx, ms), "varsum": (tx, *tv, mu, ms, w, b, 1e-5),
            "affine": (tx, *tv),
            "bwd_reduce": (tdy, tx, *tv, mu, var, w, ms, 1e-5),
            "bwd_dx": (tdy, tx, *tv)}[kernel]
    out = getattr(fn, kernel)(*args)
    out = [t.float().numpy() for t in (out[:fn.SUMS[kernel]]
                                       if kernel in fn.SUMS else (out,))]
    assert len(out) == len(ref)
    elementwise = kernel in ("affine", "bwd_dx")
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        if elementwise and dtype == "bfloat16":
            assert (np.abs(o - r) <= BF16_ULP * np.abs(r) + 1e-6).all()
        else:
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_matches_unfused_graph_norm(dtype):
    x, w, b, a, scale = norm_inputs(2, 1500, 48)
    out = torch_run(x, w, b, a, scale, dtype)
    ref = torch_run(x, w, b, a, scale, dtype, fused=graph_norm)
    if dtype == torch.float32:
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
        for name, o, r in zip(NAMES[1:], out[1:], ref[1:]):
            np.testing.assert_allclose(o, r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)
    else:
        assert (np.abs(out[0] - ref[0]) <= BF16_ULP * np.abs(ref[0])
                + 1e-6).all()


def test_cpu_tensors_take_the_plain_passes_and_launch_nothing():
    x, w, b, a, _ = norm_inputs(3, 200, 17)
    args = [torch.from_numpy(v) for v in (x, w, b, a)]
    before = (fn.fused_graph_norm.launches,
              dict(fn.fused_graph_norm.launches_by_kernel))
    y = fn.fused_graph_norm(*args)
    assert torch.equal(y, fn.fused_graph_norm_reference(*args))
    assert (fn.fused_graph_norm.launches,
            fn.fused_graph_norm.launches_by_kernel) == before


def test_passes_refuse_types_shapes_and_devices():
    x = torch.zeros(10, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn.fused_graph_norm(x.double(), *[torch.ones(4)] * 3)
    with pytest.raises(ValueError, match=r"\(N, F\)"):
        fn.fused_graph_norm(torch.zeros(10), *[torch.ones(10)] * 3)
    vec = torch.zeros(4)
    with pytest.raises(ValueError, match="per-feature"):
        fn.varsum(x, torch.zeros(5), vec, vec, vec, vec, 1e-5)
    with pytest.raises(ValueError, match="does not match x"):
        fn.bwd_reduce(torch.zeros(10, 4, dtype=torch.bfloat16), x,
                      *[vec] * 5, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fn.colsum(torch.zeros(4, 10).t(), vec)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fn.colsum(torch.zeros(10, 4, device="meta"),
                  torch.zeros(4, device="meta"))


@pytest.mark.parametrize("switch", ["0", "1"])
def test_graph_norm_module_follows_the_switch(monkeypatch, switch):
    monkeypatch.setenv("GLASS_TPU_FUSED_NORM", switch)
    calls = []
    real = tmodules.fused_graph_norm
    monkeypatch.setattr(tmodules, "fused_graph_norm",
                        lambda *a: calls.append(1) or real(*a))
    gn = tmodules.GraphNorm(5)
    x = torch.randn(30, 5, generator=torch.Generator().manual_seed(0))
    y = gn(x)
    assert len(calls) == (switch == "1")
    torch.testing.assert_close(y, graph_norm(x, gn.weight, gn.bias,
                                             gn.mean_scale),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "band"])
def test_glass_with_fused_norm_matches_flax(monkeypatch, mode):
    """GLASS_TPU_FUSED_NORM=1 in both packages: the flax model's GraphNorms
    run the Pallas kernels in interpret mode, the port's the plain passes."""
    monkeypatch.setenv("GLASS_TPU_FUSED_NORM", "1")
    rng = np.random.default_rng(5)
    n, max_deg, hidden, layers = 300, 6, 16, 2
    src, dst = rng.integers(0, n, 1200), rng.integers(0, n, 1200)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    x = rng.integers(0, max_deg + 1, (n, 1))
    pos = np.full((4, 10), -1, np.int64)
    for i in range(4):
        k = int(rng.integers(2, 11))
        pos[i, :k] = rng.choice(n, k, replace=False)
    y = rng.integers(0, 3, 4)
    kw = (dict(materialize_dense=True) if mode == "dense" else
          dict(materialize_dense=False, materialize_bcsr=True,
               sparse_layout="band"))
    jg = jax_build_graph(ei, None, n, "gcn", **kw)
    tg = build_graph(ei, None, n, "gcn", device="cpu", **kw)
    z = jax_max_zero_one(jnp.asarray(pos), n)
    fm = FlaxGLASS(max_deg=max_deg, hidden_channels=hidden,
                   num_layers=layers, output_channels=(3,), pools=("mean",),
                   dropout=0.0, activation="elu", z_ratio=0.8, jk=True,
                   spmm_mode="pallas" if mode == "band" else mode)
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos), z)

    def loss(p):
        logits = fm.apply(p, jg, jnp.asarray(x), jnp.asarray(pos), z)
        return (jax.nn.log_softmax(logits)[jnp.arange(4), y]).sum(), logits

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(params)
    tm = GLASS(max_deg, hidden, layers, (3,), ("mean",), activation="elu",
               z_ratio=0.8, jk=True,
               spmm_mode="pallas" if mode == "band" else mode, seed=0,
               device="cpu")
    params_from_flax(tm, _flatten(params))
    tz = torch.from_numpy(np.array(z))
    logits = tm(tg, torch.from_numpy(x), torch.from_numpy(pos), tz)
    torch.log_softmax(logits, -1)[torch.arange(4), torch.from_numpy(y)] \
        .sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    flat = _flatten(grads)
    from glass_tpu_torch.utils.checkpoint import _torch_key

    named = dict(tm.named_parameters())
    for key, g in flat.items():
        name, transpose = _torch_key(key)
        got = named[name].grad.numpy()
        got = got.T if transpose else got
        np.testing.assert_allclose(got, g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max() + 1e-7,
                                   err_msg=key)
