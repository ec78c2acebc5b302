"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the references load nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]"
         f"\n{code}\nprint(' '.join(sorted({{m.split('.')[0] for m in "
         f"sys.modules}})))"],
        capture_output=True, text=True, timeout=240, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    mods = _loaded("import perfbench.run, perfbench.harness, "
                   "perfbench.check, perfbench.layers, perfbench.sweep, "
                   "perfbench.calibrate, perfbench.size_pool\n"
                   "from perfbench import harness\n"
                   "harness.reader('service_mean_ms')\n"
                   "import repro_torch.launch.serve, "
                   "repro_torch.cluster.live, repro_torch.serving.engine")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.decoder, "
                   "perfbench.reference.ladn")
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_no_source_names_jax_or_repro():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if path.parent.name == "reference":
                    assert n.split(".")[0] != "repro_torch", (path, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, "reproduce_me", object())
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in harness.forbidden_modules()
