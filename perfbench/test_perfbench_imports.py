"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the references load nothing of the port: neither ``reference/`` nor a
model kind's reference part (everything of ``models/<kind>.py`` but
``model_config``, the one function that reaches the port)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

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
                   "perfbench.calibrate, perfbench.size_pool, "
                   "perfbench.models.dense\n"
                   "from perfbench import harness\n"
                   "harness.reader('service_mean_ms')\n"
                   "cell = harness.load_cell("
                   "'starcoder2-7b-edge2.code-unshared')\n"
                   "cell.kind.model_config(cell.conf, "
                   "cell.kind.spec(cell.conf))\n"
                   "harness.reader_hooks(cell)\n"
                   "import repro_torch.launch.serve, "
                   "repro_torch.cluster.live, repro_torch.serving.engine")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.decoder, "
                   "perfbench.reference.ladn")
    assert not mods & (FORBIDDEN | {"repro_torch"})


# a kind of its own file, loaded by path as the harness loads every kind
TEST_KIND = '''from perfbench.models import dense

spec, make_weights = dense.spec, dense.make_weights
copy_weights, engine_params = dense.copy_weights, dense.engine_params
weight_bytes, page_bytes = dense.weight_bytes, dense.page_bytes
logits_at, flops = dense.logits_at, dense.flops


def model_config(conf, s):
    from repro_torch.configs.base import ModelConfig  # noqa: F401
    return dense.model_config(conf, s)
'''

# everything of a kind but model_config, at a tiny size
_REFERENCE_PART = """
import json, numpy as np, torch
conf = json.loads(open({conf!r}).read())
s = kind.spec(conf, {{"layers": 1, "d_model": 32, "heads": 2,
                      "kv_heads": 1, "d_ff": 48, "vocab": 61}})
w = kind.make_weights(s, 2**31 + 5, torch.device("cpu"))
kind.engine_params(s, kind.copy_weights(w))
seqs = [np.arange(7) % 61]
for p in ("fp32", "fp8"):
    kind.logits_at(w, s, seqs, [2], p)
kind.flops(s, 0, 7), kind.weight_bytes(s), kind.page_bytes(s, 16)
"""


@pytest.mark.parametrize("which", ["dense", "test-kind"])
def test_a_kinds_reference_part_loads_nothing_of_the_port(which, tmp_path):
    conf = str(HERE / "configs" / "starcoder2-7b-edge2.json")
    if which == "dense":
        load = "from perfbench.models import dense as kind"
    else:
        (tmp_path / "perfbench" / "models").mkdir(parents=True)
        (tmp_path / "perfbench" / "models" / "other.py").write_text(TEST_KIND)
        load = ("import importlib.util\n"
                "p = importlib.util.spec_from_file_location('k', "
                f"{str(tmp_path / 'perfbench' / 'models' / 'other.py')!r})\n"
                "kind = importlib.util.module_from_spec(p)\n"
                "p.loader.exec_module(kind)")
    mods = _loaded(load + _REFERENCE_PART.format(conf=conf))
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods
    _assert_port_only_in_model_config(
        HERE / "models" / "dense.py" if which == "dense"
        else tmp_path / "perfbench" / "models" / "other.py")


def _assert_port_only_in_model_config(path):
    """The port is imported nowhere in a kind's file but inside its
    ``model_config``."""
    tree = ast.parse(path.read_text())
    allowed = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "model_config":
            allowed |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) \
                and id(node) not in allowed:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert all(n.split(".")[0] != "repro_torch" for n in names), \
                (path, names)


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
    for path in (HERE / "models").glob("*.py"):
        _assert_port_only_in_model_config(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, "reproduce_me", object())
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in harness.forbidden_modules()
