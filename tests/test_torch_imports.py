"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``
(only the tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_scan_sees_the_port():
    names = {p.name for p in FILES}
    assert {"engine.py", "decode_attention.py", "serve.py", "injector.py",
            "live.py", "stress.py", "moe.py", "mesh.py", "sharding.py",
            "mixtral_8x22b.py", "dbrx_132b.py", "chip_smoke.py", "shapes.py",
            "specs.py", "dryrun.py", "analysis.py", "reanalyze.py",
            "report.py", "hooks.py", "scheduling.py", "kernels.py",
            "roofline.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
