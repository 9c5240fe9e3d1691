"""No file of the benchmark imports JAX, its libraries or the JAX
package, by the top-level name of each import compared whole
(``mca_tpu_torch`` begins with ``mca_tpu`` and is not it); the reference
imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mca_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_the_scan_sees_every_file():
    names = {f.relative_to(BENCH).as_posix() for f in FILES}
    assert {"run.py", "reference/model.py", "drivers/train_loop.py", "metrics/mfu.train.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "mca_tpu_torch" not in set(top_level_imports(path))


def test_names_compare_whole(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import mca_tpu_torch.train\nfrom jax.numpy import ones\nimport flaxen\n")
    assert set(top_level_imports(f)) & FORBIDDEN == {"jax"}
