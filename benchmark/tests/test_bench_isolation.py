"""Nothing the benchmark runs imports JAX, flax or the JAX package; the
reference imports nothing of the program; no file reads the JAX
package's benchmark or its records; and a run leaves none of them in
``sys.modules``. Module names are compared by their top-level name, whole:
``glass_tpu_torch`` is not ``glass_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "glass_tpu"}
OLD_RECORDS = ("bench.py", "BENCH_", "BASELINE", "e2e_bench")


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                  p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_sees_every_kind_of_file():
    names = {p.relative_to(BENCH).as_posix() for p in sources()}
    assert {"run.py", "harness.py", "reference/glass.py",
            "metrics/mfu.train.py"} <= names


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_name_comparison(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import glass_tpu_torch.ops\n"
                     "from glass_tpu.ops import x\n")
    assert top_level_imports(probe) == {"glass_tpu_torch", "glass_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    imported = top_level_imports(path)
    assert "glass_tpu_torch" not in imported
    assert not imported & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in sources()
                                  if p.name != Path(__file__).name],
                         ids=lambda p: p.name)
def test_no_old_records_read(path):
    text = path.read_text()
    assert not [r for r in OLD_RECORDS if r in text]


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "glass_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_run_loads_none_of_them(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import harness\n"
        "from pathlib import Path\n"
        f"root = tiny.make_root(Path({str(tmp_path)!r}))\n"
        "out = tiny.run(root, 'em_user.train')\n"
        "print(out['correct'], harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"
