"""glass_tpu_torch, chip_smoke.py and the port's tools (tools/torch_*.py)
import neither JAX nor glass_tpu, nor sklearn, PyYAML or networkx (absent
on the machine with the card).

Checked twice: a fresh interpreter imports every module of the port and
chip_smoke.py's imports and then looks at ``sys.modules``; and an AST scan
of the same files looks at every import statement. Note that the name
``glass_tpu_torch`` itself starts with ``glass_tpu``: the rule is
``name == "glass_tpu" or name.startswith("glass_tpu.")``.
"""

import ast
import json
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
