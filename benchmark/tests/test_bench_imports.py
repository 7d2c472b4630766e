"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the program in the plain references."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        got = _top_level_imports(path)
        assert not got & {"emr2a_tpu_torch", "emr2a_tpu", "jax", "jaxlib", "flax"}, (path, got)
    # what the references take from the rest of the benchmark is plain too
    for path in (BENCH / "core" / "seeded.py", *sorted((BENCH / "inputs").glob("*.py"))):
        assert "emr2a_tpu_torch" not in _top_level_imports(path), path


def test_nothing_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "emr2a_tpu"}, path
