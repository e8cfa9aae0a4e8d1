"""glass_tpu_torch, chip_smoke.py and the port's tools (tools/torch_*.py)
import neither JAX nor glass_tpu, nor sklearn, PyYAML or networkx (absent
on the machine with the card).

Checked twice: a fresh interpreter imports every module of the port and
chip_smoke.py's imports and then looks at ``sys.modules``; and an AST scan
of the same files looks at every import statement. Note that the name
``glass_tpu_torch`` itself starts with ``glass_tpu``: the rule is
``name == "glass_tpu" or name.startswith("glass_tpu.")``.

Nor do they read a file of the JAX package's tree: the port builds its own
copy of the host library's source (``glass_tpu_torch.native.SOURCE`` lies
under ``glass_tpu_torch/``), and an AST scan of the same files finds no
string constant that names a path into ``native/`` or ``glass_tpu/``: no
``"native"`` or ``"glass_tpu"`` joined into a path (an operand of ``/`` or
an argument of ``Path``, ``PurePath``, ``os.path.join`` or ``open``), no
constant holding ``native/``, and none holding ``glass_tpu/`` but a
``file.py:line`` label (the kernels line's ``replaces``). Docstrings are
exempt.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = (sorted((REPO / "glass_tpu_torch").rglob("*.py"))
         + [REPO / "chip_smoke.py"]
         + sorted((REPO / "tools").glob("torch_*.py")))


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "glass_tpu", "sklearn",
                   "yaml", "networkx")


def test_forbidden_rule_is_precise():
    assert forbidden("glass_tpu") and forbidden("glass_tpu.ops.graph")
    assert forbidden("jax.numpy") and forbidden("flax")
    assert forbidden("sklearn.metrics")
    assert forbidden("yaml") and forbidden("networkx.classes")
    assert not forbidden("glass_tpu_torch") and not forbidden("glass_tpu_torch.ops")
    assert not forbidden("jaxtyping")


def test_port_imports_no_jax_in_a_fresh_interpreter():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import glass_tpu_torch
names = [m.name for m in pkgutil.walk_packages(glass_tpu_torch.__path__,
                                               "glass_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({{"imported": names, "modules": sorted(sys.modules)}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "glass_tpu_torch.ops.bcsr_spmm" in result["imported"]
    assert "glass_tpu_torch.train.loop" in result["imported"]
    assert "glass_tpu_torch.cli.glass_test" in result["imported"]
    assert "glass_tpu_torch.train.protocol" in result["imported"]
    assert "glass_tpu_torch.cli.gnn_seg" in result["imported"]
    assert "glass_tpu_torch.train.seg_protocol" in result["imported"]
    for name in ("mesh", "partition", "train", "auto", "multihost"):
        assert f"glass_tpu_torch.parallel.{name}" in result["imported"]
    assert "glass_tpu_torch.ops.collectives" in result["imported"]
    assert "glass_tpu_torch.ops.embedding" in result["imported"]
    bad = [m for m in result["modules"] if forbidden(m)]
    assert bad == []
    # kernels are built at first use, not on import
    assert "triton" not in result["modules"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if forbidden(n)] == []


PATH_CALLS = {"Path", "PurePath", "join", "open"}
TREE_PART = re.compile(r"(^|[/\\])(native|glass_tpu)[/\\]")
KERNEL_LABEL = re.compile(r"glass_tpu/[\w/]+\.py:\d+( \w+)?")


def reference_paths(source: str) -> list:
    """(line, constant) of every string constant of ``source``, docstrings
    aside, that names a path into the JAX package's tree (module
    docstring)."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    joined = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            joined.update((id(node.left), id(node.right)))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in PATH_CALLS:
                joined.update(id(a) for a in node.args)
    found = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                ) or id(node) in docs:
            continue
        s = node.value
        if (s in ("native", "glass_tpu") and id(node) in joined) or \
                (TREE_PART.search(s) and not KERNEL_LABEL.fullmatch(s)):
            found.append((node.lineno, s))
    return sorted(found)


def test_reference_path_rule_is_precise():
    bad = ('SOURCE = Path(__file__).resolve().parents[1] / "native" / '
           '"glass_host.cpp"\n'
           'lib = os.path.join(ROOT, "native", "libglass_host.so")\n'
           'src = open("native/glass_host.cpp")\n'
           'mod = REPO / "glass_tpu/ops/graph.py"\n')
    assert [line for line, _ in reference_paths(bad)] == [1, 2, 3, 4]
    good = ('"""Counterpart of native/glass_host.cpp."""\n'
            'SOURCE = Path(__file__).resolve().parent / "csrc" / '
            '"glass_host.cpp"\n'
            'emit("native", ok=True)\n'
            'replaces = "glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel"\n'
            'other = "glass_tpu/ops/pallas_band.py:465"\n')
    assert reference_paths(good) == []


def test_port_builds_its_own_host_source():
    from glass_tpu_torch import native

    port = (REPO / "glass_tpu_torch").resolve()
    assert native.SOURCE.resolve().is_relative_to(port)
    assert native.SOURCE.is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_path_into_the_reference_tree(path):
    assert reference_paths(path.read_text()) == []
