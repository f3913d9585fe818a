"""Nothing under perfbench/ imports JAX or the JAX package, compared by
whole top-level names (`repro_torch` is not `repro`), and the plain
references import nothing of the port."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    mods = top_level_imports(path)
    assert "repro_torch" not in mods
    assert not mods & {"perfbench"} or path.name == "__init__.py"


def test_the_check_compares_whole_names():
    from perfbench.harness import FORBIDDEN as RUNTIME

    assert set(RUNTIME) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
