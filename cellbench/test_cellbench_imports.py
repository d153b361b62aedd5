"""Independence of the yardstick, read with `ast`: nothing under
cellbench imports JAX or the JAX package, and the references, the work
counts, the metric readers and the comparison import nothing of the
program either (a top-level name compared whole: `fftlab_torch` is not
`fftlab`).

    python -m pytest cellbench -q
"""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "fftlab"}
PROGRAM = {"fftlab_torch"}
YARDSTICK = sorted([*(HERE / "reference").glob("*.py"), *(HERE / "work").glob("*.py"),
                    *(HERE / "metrics").glob("*.py"), HERE / "compare.py", HERE / "trace.py"])


def imported(path: Path) -> set:
    """Top-level names of every module `path` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX, f"{path} imports {imported(path) & JAX}"


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert not imported(path) & (PROGRAM | JAX), f"{path} imports {imported(path)}"


def test_reference_folder_is_read():
    assert {p.name for p in (HERE / "reference").glob("*.py")} >= {"c2c.py", "filter.py"}


def test_the_guard_sees_a_nested_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    import fftlab.plan as p\n    from jax import numpy\n")
    assert imported(f) == {"fftlab", "jax"}
