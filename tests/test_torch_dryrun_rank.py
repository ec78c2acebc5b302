"""The dry run's count of one rank's program on a mesh of more than one
rank.  The trace runs rank 0 of a fake process group in a process of its
own (spawned here, so that no default group is left in a test worker):
for reduced qwen2-1.5b (head-parallel attention), recurrentgemma-9b
(tensor-parallel RG-LRU, a local-attention ring cut over "model") and
mixtral-8x22b (experts cut over "model" and "data") at the smoke train,
prefill and decode shapes on (2, 2), its collectives (kind, count, bytes)
equal those rank 0 issues running the same step on four real ``gloo``
ranks, and its argument bytes of the params equal rank 0's
``place_params`` blocks; a full-width record on 16 x 16 carries a
collective term."""
import json
import os
import pickle
import subprocess
import sys

import pytest

from _torch_dist import dry_count_rank, run_ranks
from repro_torch.configs import get_config, reduced, smoke_shape

ARCHS = ("qwen2-1.5b", "recurrentgemma-9b", "mixtral-8x22b")
KINDS = ("train", "prefill", "decode")
MESH = (2, 2)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

# rank 0's count on the fake group, in a fresh interpreter
FAKE = r"""
import json, pickle, sys
from repro_torch.launch import dryrun, specs
cases, out = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
res = {}
for name, cfg, shape, sizes in cases:
    mesh = specs.MeshShape(("data", "model"), sizes)
    c = dryrun.trace(cfg, shape, mesh)
    p, spec = specs.param_specs(cfg, mesh)
    res[name] = {"collectives": {k: v for k, v in c["tallies"].items()
                                 if k.startswith("c10d.")},
                 "param_bytes": specs.argument_bytes(p, spec, mesh)[1]}
rec = dryrun.run_one("qwen2-1.5b", "decode_32k", "16x16", verbose=False)
res["16x16"] = {k: rec[k] for k in ("collective_bytes", "collective_s",
                                    "n_collectives", "collective_note",
                                    "chips")}
json.dump(res, open(out, "w"))
"""


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fake_group_count_equals_four_gloo_ranks(tmp_path):
    cases = [(f"{arch}_{kind}", reduced(get_config(arch)), smoke_shape(kind),
              MESH) for arch in ARCHS for kind in KINDS]
    blob, out = tmp_path / "cases.pkl", tmp_path / "fake.json"
    with open(blob, "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    fake = subprocess.run([sys.executable, "-c", FAKE, str(blob), str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert fake.returncode == 0, fake.stderr[-3000:]
    run_ranks(dry_count_rank, 4, tmp_path, cases, str(tmp_path))
    got = json.loads(out.read_text())
    for name, *_ in cases:
        real = json.loads((tmp_path / f"{name}.json").read_text())
        assert got[name]["collectives"] == real["collectives"], name
        assert got[name]["collectives"], name
        assert got[name]["param_bytes"] == real["placed_bytes"], name
    big = got["16x16"]
    assert big["chips"] == 256 and big["n_collectives"] > 0
    assert big["collective_bytes"] > 0 and big["collective_s"] > 0
    assert "rank 0" in big["collective_note"]
