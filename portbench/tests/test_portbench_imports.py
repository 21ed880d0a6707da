"""Nothing under portbench/ imports JAX or the JAX package ``repro`` (top
level names compared whole: the port ``repro_torch`` begins with
``repro``), and the reference imports nothing of the port either."""

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    are the package's own)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources(where: Path):
    return sorted(p for p in where.rglob("*.py") if "_cache" not in p.parts)


def test_no_jax_anywhere():
    found = {str(p.relative_to(ROOT)): sorted(set(_imports(p)) & FORBIDDEN)
             for p in _sources(PKG)}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_port():
    for p in _sources(PKG / "reference"):
        names = set(_imports(p))
        assert not names & (FORBIDDEN | {"repro_torch", "portbench"}), p
        assert names <= {"__future__", "contextlib", "dataclasses", "math",
                         "typing", "torch", "numpy"}, (p, names)


def test_names_are_compared_whole():
    from portbench import harness

    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "reprox", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.tier", "jaxlib.xla",
                                      "flax", "jax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_the_scan_sees_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy\nfrom repro.core import tier\n"
                   "import repro_torch\nfrom . import sibling\n"
                   "importlib.import_module('flax.linen')\n")
    assert set(_imports(src)) == {"jax", "repro", "repro_torch", "flax"}
