"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under bench/, and nothing of the program in the reference.  Names
are compared by their whole top-level name, so ``repro_torch`` is not
``repro``."""
import ast
from pathlib import Path

import pytest

from bench.tests.conftest import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def local_imports(path: Path) -> set[Path]:
    """The benchmark's own modules that `path` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        for m in mods:
            if m.split(".")[0] != "bench":
                continue
            parts = m.split(".")[1:]
            cands = [BENCH.joinpath(*parts).with_suffix(".py"), BENCH.joinpath(*parts, "__init__.py")]
            if isinstance(node, ast.ImportFrom):
                cands += [BENCH.joinpath(*parts, a.name).with_suffix(".py") for a in node.names]
            out |= {c for c in cands if c.exists()}
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_names(path) & FORBIDDEN


def test_reference_reaches_nothing_of_the_program():
    seen, todo = set(), set((BENCH / "reference").glob("*.py"))
    while todo:
        path = todo.pop()
        seen.add(path)
        assert "repro_torch" not in top_names(path) and not top_names(path) & FORBIDDEN, path
        todo |= local_imports(path) - seen
    assert BENCH / "weights.py" in seen


def test_the_name_test_is_whole():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".")[0] != "repro"
