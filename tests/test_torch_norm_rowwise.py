"""The fused GraphNorm's elementwise passes, K3 (affine) and K5 (bwd_dx), as
``glass_tpu_torch/csrc/graph_norm.cu`` runs them: a flat walk of the (N, F)
operands in 16-byte chunks on persistent CTAs, planned on the host by
``ops/fused_norm.py::elementwise_plan``. On the CPU:

- the plan, walked in Python as the kernel walks it: every element taken
  once, each chunk's columns those its thread loaded once (the flat index
  -> column map across row boundaries), every CTA launched given a chunk;
- the plain K3 and K5 at component's F = 17 and an odd bf16 F: bit-equal
  to the same f32 operations in the same order, one rounding each and
  one rounding to x's dtype, as numpy takes them (the kernel does the
  same, held bit-equal to the plain versions on the card by
  chip_smoke.py); and against the JAX ``_affine_kernel`` and
  ``_bwd_dx_kernel`` in interpret mode (as tests/test_torch_fused_norm.py
  runs them), which XLA's CPU compiler contracts into FMAs: within that
  contraction's rounding;
- the packed arguments against the C structs they fill, and the launch
  constants against the C source's.

chip_smoke.py holds the CUDA kernel against the plain versions on the card.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from glass_tpu_torch.ops import fused_norm as fn
from test_torch_fused_norm import pallas_pass

H100_SMS = 132
BF16_ULP = 2.0 ** -7
CSRC = Path(fn.__file__).resolve().parent.parent / "csrc" / "graph_norm.cu"


def walk(plan: fn.ElementwisePlan, n: int, f: int) -> None:
    """The kernel's walk of the plan, checked: the entry point takes the
    plan (glass_norm_elementwise's checks: live a multiple of the period,
    the grid covering min(live, chunks) threads), thread t < live takes
    chunks t, t + live, ... with the columns of its first chunk, the thread
    that reaches the partial last chunk takes it value by value, and every
    CTA holds a thread with a chunk."""
    v, live, total = plan.v, plan.live, n * f
    full = total // v
    launched = plan.ctas * plan.threads
    assert live % (f // np.gcd(f, v)) == 0
    assert launched >= min(live, -(-total // v))
    # each launched walking thread's chunks, in its loop's order
    t = np.arange(min(live, launched))
    steps = np.arange(plan.chunks_per_thread)
    chunk = t[:, None] + live * steps[None, :]
    taken = chunk[chunk < full]
    assert (chunk < full).sum(1).max() <= plan.chunks_per_thread
    owner = np.broadcast_to(t[:, None], chunk.shape)[chunk < full]
    # the columns a thread loads once: those of its first chunk
    first = (t[:, None] * v + np.arange(v)[None, :]) % f
    elems = taken[:, None] * v + np.arange(v)[None, :]
    assert (elems % f == first[owner]).all()
    rest = total - full * v
    tail = []
    if rest:
        t_tail = full % live
        assert t_tail < launched
        tail = full * v + np.arange(rest)
        assert (tail % f == first[t_tail][:rest]).all()
    seen = np.concatenate([elems.ravel(), tail])
    assert seen.size == total
    assert (np.sort(seen) == np.arange(total)).all()  # each element once
    # every CTA launched has a thread with a chunk
    assert (plan.ctas - 1) * plan.threads < min(live, -(-total // v))


@pytest.mark.parametrize("f", [1, 3, 17, 64, 200])
@pytest.mark.parametrize("n", [1, 63, 64, 1000, 3001, 17_260, 57_344])
def test_elementwise_plan_walk(n, f):
    for itemsize in (4, 2):  # f32, bf16
        for aligned in (False, True):
            plan = fn.elementwise_plan(n, f, itemsize, aligned, H100_SMS)
            v = 16 // itemsize if aligned else 1
            assert plan.v == v and plan.threads == fn.EW_THREADS
            # at most one wave of EW_CTAS_PER_SM CTAs an SM
            assert plan.ctas <= H100_SMS * fn.EW_CTAS_PER_SM
            walk(plan, n, f)


def test_elementwise_plan_at_the_main_shapes():
    """em_user (57,344 x 64) fills the wave exactly, f32 and bf16; at
    component's 17,260 x 17 the period is 17 chunks, so 3,975 periods walk
    and no lane idles; an unaligned x walks one value at a time."""
    wave = H100_SMS * fn.EW_CTAS_PER_SM * fn.EW_THREADS
    f32 = fn.elementwise_plan(57_344, 64, 4, True, H100_SMS)
    assert f32 == fn.ElementwisePlan(264, 256, wave, 4, 14)
    bf16 = fn.elementwise_plan(57_344, 64, 2, True, H100_SMS)
    assert bf16 == fn.ElementwisePlan(264, 256, wave, 8, 7)
    comp = fn.elementwise_plan(17_260, 17, 4, True, H100_SMS)
    assert comp == fn.ElementwisePlan(264, 256, 3_975 * 17, 4, 2)
    odd = fn.elementwise_plan(17_260, 17, 4, False, H100_SMS)
    assert (odd.v, odd.live % 17, odd.chunks_per_thread) == (1, 0, 5)


def test_elementwise_plan_past_one_wave():
    """A period longer than a wave (F of over 270,000 one-value columns)
    still walks: one period of threads, more CTAs than one wave."""
    plan = fn.elementwise_plan(2, 300_001, 4, False, H100_SMS)
    assert plan.live == 300_001 and plan.ctas == -(-300_001 // 256)
    walk(plan, 2, 300_001)


@pytest.mark.parametrize("n,f", [(1, 514), (3, 1025)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_elementwise_plan_period_past_its_grid(n, f, itemsize):
    """Few rows of a long period: one period of walking threads is more
    than the CTAs the chunks need (f32 (1, 514): 257 walk, 129 chunks, one
    CTA), and the plan still walks."""
    plan = fn.elementwise_plan(n, f, itemsize, True, H100_SMS)
    assert plan.live > plan.ctas * plan.threads
    walk(plan, n, f)


def elementwise_inputs(seed, n, f, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, f)) * 3 + 1.5).astype(np.float32)
    dy = rng.normal(size=(n, f)).astype(np.float32)
    vecs = [rng.normal(size=f).astype(np.float32) for _ in range(3)]
    jx, jdy = (jnp.asarray(a).astype(dtype) for a in (x, dy))
    tdt = getattr(torch, dtype)
    tx, tdy = (torch.from_numpy(a).to(tdt) for a in (x, dy))
    return jx, jdy, tx, tdy, vecs


def two_roundings(kernel, x, dy, vecs):
    """The pass in numpy f32, one rounding per operation in the JAX
    expression's order (numpy contracts nothing into an FMA)."""
    if kernel == "affine":
        return x * vecs[0] + vecs[1]
    return (dy * vecs[0] + x * vecs[1]) + vecs[2]


@pytest.mark.parametrize("kernel", ["affine", "bwd_dx"])
@pytest.mark.parametrize("dtype,n,f", [("float32", 301, 17),
                                       ("bfloat16", 301, 17),
                                       ("bfloat16", 257, 33)])
def test_plain_elementwise_against_pallas_and_numpy(kernel, dtype, n, f):
    """Bit-equal to the two-rounding expression; against the interpret-mode
    Pallas kernel within the FMA contraction XLA's CPU compiler applies to
    it (x*g + h as one fma: bit-equal to that for K3 f32; K5's three terms
    within 2^-22 of their magnitudes' sum), and one bf16 ulp where the
    contraction moves an f32 value across a bf16 rounding boundary."""
    jx, jdy, tx, tdy, vecs = elementwise_inputs(7, n, f, dtype)
    k = 2 if kernel == "affine" else 3
    ref = pallas_pass(kernel, jx, jdy, vecs[:k])[0]
    tv = [torch.from_numpy(v) for v in vecs[:k]]
    args = (tx, *tv) if kernel == "affine" else (tdy, tx, *tv)
    out = getattr(fn, kernel)(*args)
    assert out.dtype == tx.dtype and out.shape == (n, f)
    out = out.float().numpy()  # bf16 widens exactly
    x, dy = (np.asarray(a.astype(jnp.float32)) for a in (jx, jdy))
    exact = jnp.asarray(two_roundings(kernel, x, dy, vecs))
    np.testing.assert_array_equal(
        out, np.asarray(exact.astype(dtype).astype(jnp.float32)))
    if dtype == "bfloat16":
        assert (np.abs(out - ref) <= BF16_ULP * np.maximum(
            np.abs(out), np.abs(ref))).all()
    elif kernel == "affine":
        fma = (x.astype(np.float64) * vecs[0] + vecs[1]).astype(np.float32)
        np.testing.assert_array_equal(ref, fma)
    else:
        terms = (np.abs(dy * vecs[0]) + np.abs(x * vecs[1])
                 + np.abs(vecs[2]))
        assert (np.abs(out - ref) <= 2.0 ** -22 * terms).all()


def c_struct_fields(name: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % name, CSRC.read_text(),
                     re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = re.match(r"(long long|double)\s+(.*)", decl,
                                    re.S).groups()
            fields += [("q" if ctype == "long long" else "d")
                       for _ in names.split(",")]
    return fields


def test_packed_arguments_match_the_c_structs():
    source = CSRC.read_text()
    for name in ("EW_THREADS", "EW_CTAS_PER_SM", "RED_THREADS",
                 "PARTIALS_OFFSET"):
        value = re.search(r"constexpr int %s = (\d+);" % name, source)
        assert int(value.group(1)) == getattr(fn, name), name
    for struct_name, packed in (("ReduceArgs", fn._REDUCE_ARGS),
                                ("ElementwiseArgs", fn._ELEMENTWISE_ARGS)):
        fields = c_struct_fields(struct_name)
        fmt = re.sub(r"(\d+)(\w)", lambda m: m.group(2) * int(m.group(1)),
                     packed.format.lstrip("<"))
        assert list(fmt) == fields, struct_name
        assert packed.size == 8 * len(fields)  # no padding either side

