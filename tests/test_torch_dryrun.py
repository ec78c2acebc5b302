"""The port's dry run against the reference's, on the CPU.

The reference lowers each step with XLA and reads the compiled
``memory_analysis`` / ``cost_analysis`` and the trip-scaled dot FLOPs of
its HLO (``roofline.analysis.scaled_cost``); the port counts one eager
step on fake tensors (``repro_torch.launch.dryrun``).  Held here: the
input shapes, ``config_for_shape``, ``skip_reason`` and ``model_flops``
for all 10 archs x 4 shapes; the specs leaf for leaf at reduced width;
argument bytes equal to the compiled ones exactly; prefill and decode
FLOPs equal to ``scaled_cost`` exactly; the train step by the remat
identity; the loop shortcut against the full loops; and ``reanalyze``.

The reference's ``launch/dryrun.py`` is never imported: it sets
``XLA_FLAGS`` for 512 host devices at import.
"""
import dataclasses
import gzip
import json

import jax
import pytest
import torch

from repro.configs import (ARCH_IDS, SHAPES as J_SHAPES,
                           SHAPES_BY_NAME as J_SHAPES_BY_NAME)
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import reduced as jax_reduced
from repro.configs import smoke_shape as jax_smoke_shape
from repro.launch.specs import input_specs as jax_input_specs
from repro.models.transformer import config_for_shape as jax_cfs
from repro.roofline import analysis as jax_ra
from repro.train.steps import (make_decode_step as jax_decode_step,
                               make_prefill_step as jax_prefill_step,
                               make_train_step as jax_train_step)
from repro_torch.configs import (SHAPES, SHAPES_BY_NAME, get_config,
                                 get_shape, reduced, smoke_shape)
from repro_torch.launch import dryrun, specs
from repro_torch.models.transformer import (config_for_shape, forward,
                                            init_layer_states, init_params)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import reanalyze, report


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMBOS = [(a, s.name) for a in ARCH_IDS for s in J_SHAPES]


def _cut(name: str, seq_len: int = 32, batch: int = 2):
    return (dataclasses.replace(jax_get_shape(name), seq_len=seq_len,
                                global_batch=batch),
            dataclasses.replace(get_shape(name), seq_len=seq_len,
                                global_batch=batch))


def _flat(arch: str):
    """(reference, port) reduced configs with the reference's layers
    flat, as the port keeps them."""
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                scan_layers=False),
            dataclasses.replace(reduced(get_config(arch)),
                                scan_layers=False))


def _counted(cfg, shape, shortcut: bool = True):
    c = dryrun.trace(cfg, shape, None)
    if not shortcut:
        fake = torch._subclasses.fake_tensor.FakeTensorMode()
        args, kwargs, _ = specs.input_specs(cfg, shape, None, fake)
        with fake:
            _, c["tallies"] = ra.count_ops(dryrun.step_for_shape(cfg, shape),
                                           *args, shortcut=False, **kwargs)
    return c


# ---------------------------------------------------------------------------
# shapes, configs, skips, model FLOPs: all 40 combos
# ---------------------------------------------------------------------------


def test_shapes_equal_the_reference_field_for_field():
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in J_SHAPES]
    assert sorted(SHAPES_BY_NAME) == sorted(J_SHAPES_BY_NAME)
    for s in J_SHAPES:
        assert str(get_shape(s.name)) == str(s)
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.asdict(smoke_shape(kind)) == \
            dataclasses.asdict(jax_smoke_shape(kind))
    with pytest.raises(KeyError):
        get_shape("nope")


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_config_for_shape_skip_reason_and_model_flops(arch, shape):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jshape, tshape = jax_get_shape(shape), get_shape(shape)
    try:
        want = dataclasses.asdict(jax_cfs(jcfg, jshape))
    except ValueError:
        with pytest.raises(ValueError):
            config_for_shape(tcfg, tshape)
        assert dryrun.skip_reason(arch, shape) is not None
    else:
        assert dataclasses.asdict(config_for_shape(tcfg, tshape)) == want
        assert dryrun.skip_reason(arch, shape) is None
    # the reference's own skip rule, restated (its module sets XLA_FLAGS)
    ref_skip = (jshape.kind == "decode" and jshape.seq_len > 65536
                and not jcfg.is_subquadratic())
    assert (dryrun.skip_reason(arch, shape) is not None) == ref_skip
    assert ra.model_flops(tcfg, tshape) == jax_ra.model_flops(jcfg, jshape)


# ---------------------------------------------------------------------------
# specs at reduced width
# ---------------------------------------------------------------------------


def _leaf_multiset(leaves):
    return sorted((tuple(x.shape), str(x.dtype).replace("torch.", ""))
                  for x in leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_specs_match_the_reference_leaf_for_leaf(arch, kind):
    jcfg, tcfg = _flat(arch)
    jshape, tshape = _cut(kind)
    jargs, _ = jax_input_specs(jcfg, jshape, None)
    targs, _, tspecs = specs.input_specs(tcfg, tshape, None)
    jl = jax.tree_util.tree_leaves(jargs)
    tl = [t for t, _ in specs._pairs(targs, tspecs)]
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in tl)
    assert _leaf_multiset(tl) == _leaf_multiset(jl)
    total, rank = specs.argument_bytes(targs, tspecs, None)
    assert total == rank == sum(x.size * x.dtype.itemsize for x in jl)


def test_per_rank_bytes_follow_the_pspecs():
    """On 16 x 16 each leaf's bytes divide by the mesh axes of its spec:
    qwen2-1.5b's embedding (V, d) is cut on "model" and "data", its norm
    scales are whole, its decode tokens cut over "data"."""
    cfg = get_config("qwen2-1.5b")
    mesh = specs.mesh_shape("16x16")
    shape = get_shape("decode_32k")
    args, _, sp = specs.input_specs(cfg, shape, mesh)
    params, toks, states = args
    assert sp[0]["embed"]["embed"] == ("model", "data")
    assert sp[0]["final_norm"]["scale"] == (None,)
    assert sp[1]["tokens"] == ("data", None)
    assert sp[2][0]["k"] == ("data", None, "model", None)
    total, rank = specs.argument_bytes(args, sp, mesh)
    want = sum(-(-ra.nbytes(t) // specs._shards(s, mesh))
               for t, s in specs._pairs(args, sp))
    assert rank == want and total > 100 * rank


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_output_pspecs_cover_every_output(kind):
    """``output_pspecs`` (the reference pins ``out_shardings`` instead)
    gives each output of the step one mesh axis or None a dim; the
    logits shard the vocabulary on "model"."""
    _, tcfg = _flat("xlstm-350m")
    _, tshape = _cut(kind)
    mesh = specs.mesh_shape("2x16x16")
    fake = torch._subclasses.fake_tensor.FakeTensorMode()
    args, kwargs, _ = specs.input_specs(tcfg, tshape, mesh, fake)
    with fake:
        out = dryrun.step_for_shape(tcfg, tshape)(*args, **kwargs)
    pairs = list(specs._pairs(out, specs.output_pspecs(tcfg, tshape, mesh,
                                                       out)))
    assert pairs and all(len(s) == t.dim() for t, s in pairs)
    if kind != "train_4k":
        assert pairs[0][1] == ("pod", "model")   # batch 2 cut on pod alone


# ---------------------------------------------------------------------------
# exact argument bytes and FLOPs against the compiled reference
# ---------------------------------------------------------------------------


def _jax_step(cfg, kind):
    if kind == "train":
        return jax_train_step(cfg)
    if kind == "prefill":
        return jax_prefill_step(cfg)
    return jax_decode_step(cfg, sample=False)


_COMPILED = {}


def _reference(arch, kind):
    """The compiled reference step at B 2, S 32: (argument bytes, the
    trip-scaled dot FLOPs of its HLO)."""
    if (arch, kind) not in _COMPILED:
        jcfg, _ = _flat(arch)
        jshape, _ = _cut(kind)
        args, kw = jax_input_specs(jcfg, jshape, None)
        comp = jax.jit(_jax_step(jcfg, jshape.kind)).lower(*args,
                                                           **kw).compile()
        cost = comp.cost_analysis()
        flops, _, _ = jax_ra.scaled_cost(comp.as_text(),
                                         float(cost.get("flops", 0.0)),
                                         float(cost.get("bytes accessed",
                                                        0.0)))
        _COMPILED[arch, kind] = (
            comp.memory_analysis().argument_size_in_bytes, flops)
    return _COMPILED[arch, kind]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_bytes_equal_the_compiled_reference(arch, kind):
    _, tcfg = _flat(arch)
    _, tshape = _cut(kind)
    want, _ = _reference(arch, kind)
    c = dryrun.trace(tcfg, tshape, None)
    assert c["argument_bytes_total"] == c["argument_bytes"] == want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_serving_flops_equal_the_reference_scaled_cost(arch, kind):
    _, tcfg = _flat(arch)
    _, tshape = _cut(kind)
    _, want = _reference(arch, kind)
    got = ra.totals(dryrun.trace(tcfg, tshape, None)["tallies"])["flops"]
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-350m"])
def test_train_flops_remat_identity(arch):
    """XLA's dot walk does not see remat's rerun, the eager count does:
    (remat on) - (remat off) is exactly one train-mode forward of the
    blocks (the embedding gathers and the norms count no FLOPs; the CE
    head is not rerun) less one term: ``torch.utils.checkpoint`` stops
    the rerun once the backward's saved tensors are rebuilt, so each
    block's last product, whose output only feeds the residual add
    (``ffn.w_down``, mLSTM ``w_down``, sLSTM ``w_out``), is not rerun:
    2 x tokens x in x out of that weight, per layer.  With remat off
    qwen2-1.5b equals the reference's trip-scaled count exactly."""
    _, tcfg = _flat(arch)
    _, tshape = _cut("train_4k")

    def flops(cfg):
        return ra.totals(dryrun.trace(cfg, tshape, None)["tallies"])["flops"]

    on = flops(dataclasses.replace(tcfg, remat=True))
    off = flops(dataclasses.replace(tcfg, remat=False))
    fake = torch._subclasses.fake_tensor.FakeTensorMode()
    args, _, _ = specs.input_specs(tcfg, tshape, None, fake)
    params, _, batch = args
    with fake, torch.no_grad():
        _, tallies = ra.count_ops(forward, params, tcfg, batch, "train")
    tokens = tshape.global_batch * tshape.seq_len
    last = [lay["ffn"]["w_down"] if "ffn" in lay else
            lay["mixer"].get("w_down", lay["mixer"].get("w_out"))
            for lay in params["layers"]]
    not_rerun = sum(2 * tokens * w.shape[0] * w.shape[1] for w in last)
    assert on - off == ra.totals(tallies)["flops"] - not_rerun > 0
    if arch == "qwen2-1.5b":
        assert off == _reference(arch, "train_4k")[1]


# ---------------------------------------------------------------------------
# the loop shortcut, decode's shared position, the step on fake tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind,over", [
    ("xlstm-350m", "prefill_32k", {}),           # mLSTM and sLSTM scans
    ("recurrentgemma-9b", "prefill_32k", {}),    # the RG-LRU loop
    ("qwen2-1.5b", "train_4k", {"microbatches": 4}),   # microbatches
])
def test_loop_shortcut_equals_the_full_loop(arch, kind, over):
    _, tcfg = _flat(arch)
    tcfg = dataclasses.replace(tcfg, **over)
    _, tshape = _cut(kind, seq_len=16, batch=4)
    short = _counted(tcfg, tshape)["tallies"]
    full = _counted(tcfg, tshape, shortcut=False)["tallies"]
    assert short == full
    assert ra.totals(short)["n_ops"] > 0


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-9b"])
def test_loop_shortcut_through_a_differentiated_recurrence(arch):
    """A recurrence differentiated after its loop (the xLSTM and RG-LRU
    train steps) weights its representative step's backward too: the
    FLOPs equal the full loop's; what differs is only the gradient sums
    autograd's engine adds where a step's state meets the next step
    (``aten.add``, no FLOPs, so the bytes stay a lower bound) and
    ``fill``'s detaches."""
    _, tcfg = _flat(arch)
    tcfg = dataclasses.replace(tcfg, microbatches=4)
    _, tshape = _cut("train_4k", seq_len=16, batch=4)
    short = _counted(tcfg, tshape)["tallies"]
    full = _counted(tcfg, tshape, shortcut=False)["tallies"]
    differ = {k for k in set(short) | set(full)
              if short.get(k) != full.get(k)}
    assert differ == {"aten.add.Tensor", "aten.detach.default"}
    assert ra.totals(short)["flops"] == ra.totals(full)["flops"]
    assert short["aten.add.Tensor"][2] < full["aten.add.Tensor"][2]
    assert short["aten.detach.default"][2] == 0


def test_shared_decode_position_is_every_rows_position():
    """``init_layer_states(filled_pos=)`` gives one 0-d ``pos`` a layer
    (the reference's layout); decode broadcasts it, so the logits equal
    those of per-row positions at the same depth."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32")
    dev = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    shared = init_layer_states(cfg, 3, 16, dev, filled_pos=9)
    rows = init_layer_states(cfg, 3, 16, dev)
    gen = torch.Generator().manual_seed(1)
    for a, b in zip(shared, rows):
        assert a["pos"].shape == () and b["pos"].shape == (3,)
        for k in ("k", "v"):
            a[k].copy_(torch.randn(a[k].shape, generator=gen))
            b[k].copy_(a[k])
        b["pos"].fill_(9)
    toks = {"tokens": torch.tensor([[1], [2], [3]], dtype=torch.int32)}
    out_a = forward(params, cfg, toks, "decode", states=shared)
    out_b = forward(params, cfg, toks, "decode", states=rows)
    assert torch.equal(out_a["logits"], out_b["logits"])
    assert out_a["states"][0]["pos"].tolist() == [10, 10, 10]


@pytest.mark.parametrize("kind", ["train_4k", "decode_32k"])
def test_moe_on_one_rank_counts_the_ports_collectives(kind):
    """On ``1x1`` a MoE config runs the port's mesh path (the smoke mesh's
    one-rank gloo group takes fake tensors): its all-reduces and
    all-gathers are the record's collective bytes, and its FLOPs are the
    local path's."""
    _, tcfg = _flat("mixtral-8x22b")
    _, tshape = _cut(kind, batch=4)
    one = dryrun.trace(tcfg, tshape, specs.mesh_shape("1x1"))
    rec = dryrun.analyse(tcfg, tshape, specs.mesh_shape("1x1"), one, 0.0)
    kinds = rec["collective_by_kind"]
    assert set(kinds) == {"c10d.allreduce_.default",
                          "c10d.allgather_.default"}
    assert rec["collective_bytes"] == sum(kinds.values()) > 0
    assert rec["n_collectives"] > 0
    # one rank: the bytes stay counted, but no link carries them
    assert rec["collective_s"] == 0 and rec["bottleneck"] != "collective"
    assert rec["collective_note"] == dryrun.ONE_RANK
    local = dryrun.trace(tcfg, tshape, None)["tallies"]
    assert rec["flops"] == ra.totals(local)["flops"]
    assert not any(k.startswith("c10d.") for k in local)


def test_counting_pass_touches_no_storage():
    """Every argument is a fake tensor: full-width qwen2-1.5b at decode_32k
    (123 GB of arguments) traces on the CPU in a few seconds."""
    rec = dryrun.run_one("qwen2-1.5b", "decode_32k", "1x1", verbose=False)
    assert rec["argument_bytes"] == rec["argument_bytes_total"] > 100e9
    assert rec["fits_hbm"] is False
    assert rec["collective_bytes"] == 0 and rec["bottleneck"] == "memory"


# ---------------------------------------------------------------------------
# records, the CLI, reanalyze and the report
# ---------------------------------------------------------------------------


def test_cli_reanalyze_and_report(tmp_path, capsys):
    """One full-width combo through ``main`` on two meshes: the record's
    terms under the H100 peaks; on 16 x 16 (in a process of its own: the
    trace starts a fake process group there) rank 0's own FLOPs and a
    collective term over NVLink; the saved tallies re-derive each record
    exactly; the report renders."""
    import os
    import subprocess
    import sys
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    out = tmp_path / "torch_dryrun_1x1.jsonl"
    counts = tmp_path / "counts"
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k",
                 "--out", str(out), "--save-counts", str(counts),
                 "--tag", "t", "--set", "microbatches=4"])
    out16 = tmp_path / "torch_dryrun_16x16.jsonl"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "prefill_32k", "--mesh", "16x16", "--out",
         str(out16), "--save-counts", str(counts)], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    (one,) = report.load(str(out))
    (big,) = report.load(str(out16))
    assert one["chips"] == 1
    assert one["compute_s"] == one["flops"] / PEAK_FLOPS_BF16
    assert one["memory_s"] == one["bytes"] / HBM_BW
    assert one["tag"] == "t" and one["overrides"] == {"microbatches": "4"}
    assert big["chips"] == 256 and big["collective_bytes"] > 0
    assert big["collective_s"] == big["collective_bytes"] / NVLINK_BW
    assert big["collective_note"] == dryrun.RANK_ZERO
    assert big["argument_bytes"] < one["argument_bytes"]
    # rank 0 prefills 2 of the 32 rows (its "data" share): more than its
    # 1 / 256 share of the work (qwen2's 12 heads do not divide 16 "model"
    # ranks: it attends every head of its rows), less than its rows' all
    assert one["flops"] / 256 < big["flops"] < one["flops"] / 16
    assert big["flops_per_rank"] == big["flops"]
    re_recs = {r["mesh"]: r for r in
               (reanalyze.reanalyze_file(str(p))
                for p in sorted(counts.glob("*.counts.json.gz")))}
    assert re_recs == {"1x1": one, "16x16": big}
    with gzip.open(next(counts.glob("*1x1*")), "rt") as f:
        assert json.load(f)["tallies"]["kernel.flash_attention"][0] == 28
    (call,) = big["kernel_calls"]["flash_attention"]
    assert json.loads(call)["shapes"][0] == [2, 12, 32768, 128]
    capsys.readouterr()
    report.main(["--results", str(tmp_path)])
    text = capsys.readouterr().out
    assert "| qwen2-1.5b | prefill_32k |" in text
    assert "rank 0" in text and "**compute**" in text


def test_skipped_combo_is_recorded(tmp_path, monkeypatch):
    """Every published config serves long_500k (recurrent, windowed or a
    ``long_context_window``), in the reference too; without the window a
    full-attention arch is skipped and recorded so."""
    full = dataclasses.replace(get_config("qwen2-1.5b"),
                               long_context_window=None)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: full)
    out = tmp_path / "d.jsonl"
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--out",
                 str(out)])
    (rec,) = report.load(str(out))
    assert rec["skipped"] == "full attention without long-context variant"
    assert report.latest_by_combo([rec]) == {}
    assert report.fmt_bytes(None) == "-"
    assert report.fmt_bytes(3 * 2**30) == "3.0GB"
