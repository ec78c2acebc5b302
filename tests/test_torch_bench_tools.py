"""The port's Table V, Fig. 5-8, kernel and roofline benches and the bench
runner, on the CPU: the helpers equal the reference's
(``benchmarks/scheduling.py``), and each bench prints the reference's
``name,us_per_call,derived`` rows.  On the CPU the kernel bench runs the
plain versions and says so (``plain-cpu``); on the card
``test_torch_tools_cuda.py`` holds a CUDA tensor to the kernels."""
import dataclasses
import itertools
import json
import re

import numpy as np
import pytest
import torch

from benchmarks.scheduling import agent_cfg as jax_agent_cfg
from benchmarks.scheduling import convergence_episode as jax_convergence
from benchmarks.scheduling import env_for_scale as jax_env_for_scale
from benchmarks.scheduling import episodes_for_scale as jax_episodes
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench import kernels as kbench
from repro_torch.bench import scheduling
from repro_torch.bench.roofline import bench_roofline
from repro_torch.bench.serving import bench_tablev
from repro_torch.launch import dryrun

ROW = re.compile(r"^[\w./=:-]+,\d+(\.\d+)?,[^,]*$")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj) -> dict:
    """A config's fields with arrays and tuples as lists."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, (tuple, list, np.ndarray)) or hasattr(v,
                                                                 "shape"):
            v = np.asarray(v).tolist()
        out[f.name] = v
    return out


# ---------------------------------------------------------------------------
# the scheduling helpers against the reference
# ---------------------------------------------------------------------------


CURVES = [[], [5.0], [5.0, 5.0], [10.0, 5.0], [2.0] * 10, [0.0] * 5,
          [10.0, 8.0, 6.0] + [5.0] * 12,
          [10.0, 8.0, 6.0] + list(5.0 + 0.01 * np.random.default_rng(
              0).standard_normal(12))] + \
    [list(np.linspace(10.0, 1.0, n)) for n in range(8)]


@pytest.mark.parametrize("curve", CURVES + [
    list(np.random.default_rng(s).gamma(2.0, 1.0, n) + np.linspace(
        3.0, 0.0, n)) for s, n in ((1, 6), (2, 12), (3, 25), (4, 60))])
def test_convergence_episode_equals_the_reference(curve):
    assert scheduling.convergence_episode(curve) == jax_convergence(curve)
    for tol in (0.01, 0.2):
        assert scheduling.convergence_episode(curve, tol) == \
            jax_convergence(curve, tol)


@pytest.mark.parametrize("scale", ["quick", "paper"])
def test_env_and_agent_configs_equal_the_reference(scale):
    assert scheduling.episodes_for_scale(scale) == jax_episodes(scale)
    assert _fields(scheduling.env_for_scale(scale)) == \
        _fields(jax_env_for_scale(scale))
    assert _fields(scheduling.env_for_scale(scale, max_tasks=4)) == \
        _fields(jax_env_for_scale(scale, max_tasks=4))
    assert _fields(scheduling.agent_cfg(scale)) == \
        _fields(jax_agent_cfg(scale))
    assert _fields(scheduling.agent_cfg(scale, init_alpha=0.2)) == \
        _fields(jax_agent_cfg(scale, init_alpha=0.2))


# ---------------------------------------------------------------------------
# each bench on the CPU
# ---------------------------------------------------------------------------


def test_fig5_one_episode_on_the_cpu():
    records = []
    rows, curves = scheduling.bench_fig5_learning(
        "quick", device="cpu", episodes=1, records=records)
    methods = ["lad-ts", "d2sac-ts", "sac-ts", "dqn-ts", "opt-ts",
               "random-ts"]
    assert [r.split(",")[0] for r in rows] == [
        f"fig5_learning/{m}" for m in methods]
    assert all(ROW.match(r) and "final_delay=" in r for r in rows)
    assert [len(curves[m]) for m in methods] == [1, 1, 1, 1, 3, 3]
    assert all(np.isfinite(c).all() for c in curves.values())
    # the CPU runs the plain chain: no kernel launches
    assert [r["ladn_launches"] for r in records] == [0] * 6
    assert records[0]["task_steps"] == 15 * 8


def test_sweep_and_fig8_rows():
    rows = scheduling.bench_sweep("quick", "num_bs", (4,), device="cpu",
                                  episodes=1, eval_episodes=1,
                                  methods=("random-ts", "opt-ts"))
    rows += scheduling.bench_fig8_params("quick", device="cpu", episodes=1,
                                         eval_episodes=1, steps=(1,),
                                         alphas=())
    assert [r.split(",")[0] for r in rows] == [
        "sweep_num_bs=4/random-ts", "sweep_num_bs=4/opt-ts",
        "fig8a_denoise_I=1/lad-ts"]
    assert all(ROW.match(r) and "delay=" in r for r in rows)


def test_tablev_on_the_cpu():
    rows, records = bench_tablev(num_requests=(1, 4), device="cpu")
    assert [r.split(",")[0] for r in rows] == [
        "tableV_N=1/centralized", "tableV_N=1/dedgeai",
        "tableV_N=4/centralized", "tableV_N=4/dedgeai"]
    assert all(ROW.match(r) for r in rows) and "speedup=" in rows[-1]
    for rec in records:
        assert rec["completed"] == rec["requests"] == rec["count"]
        assert all(e["kv_leak"] == 0 for e in rec["engines"])
        # the reference's depths: the cloud 4 layers, the edges 2 / 3
        layers = [e["layers"] for e in rec["engines"]]
        assert layers == ([4] if rec["mode"] == "centralized"
                          else [2, 3, 2, 3])
        assert sum(rec["launches"].values()) == 0   # plain versions


def test_kernel_bench_labels_the_plain_versions():
    rows, records = kbench.bench_kernels("cpu")
    assert [r.split(",")[0] for r in rows] == [
        "kernel_flash_attention/S512/float32",
        "kernel_flash_decode/S2048/float32",
        "kernel_paged_flash_decode/S2048/float32",
        "kernel_ladn_denoise/T256/float32"]
    assert all(ROW.match(r) and r.endswith("mode=plain-cpu") for r in rows)
    for rec in records:
        assert rec["mode"] == "plain-cpu" and rec["ok"]
        assert rec["max_abs_err"] == 0.0 and rec["bound_us"] > 0
        assert (rec["library_us"] is None) == (rec["kernel"] ==
                                               "ladn_denoise")


def test_kernel_shapes_build_their_cases():
    """The main path's shape tables (one copy, ``chip_smoke.py`` reads
    them) give inputs of the shapes they name."""
    q, kp, vp, tbl, lens = kbench.paged_decode_case(
        kbench.PAGED_SHAPES["serve"], torch.float32, device="cpu")
    assert tuple(q.shape) == (8, 12, 128) and tuple(tbl.shape) == (8, 15)
    assert tuple(kp.shape) == (41, 2, 16, 128)
    q, k, v = kbench.attention_case(kbench.ATTN_SHAPES["qwen2_chunk"],
                                    device="cpu")
    assert tuple(q.shape) == (1, 12, 64, 128)
    assert tuple(k.shape) == (1, 2, 240, 128) and q.dtype == torch.bfloat16
    q, k, v, lens = kbench.flash_decode_case(
        kbench.DECODE_SHAPES["rg_round"], device="cpu")
    assert tuple(k.shape) == (4, 1, 160, 256) and lens.tolist() == [
        129, 145, 160, 131]
    args = kbench.ladn_case(*kbench.LADN_SHAPES["act"], device="cpu")
    assert tuple(args[0].shape) == (20, 1, 20)
    assert kbench.ladn_bound(*kbench.LADN_SHAPES["act"])[1] == "bytes"


@pytest.mark.parametrize("Sq,Skv,window,q_offset", [
    (64, 64, None, 0), (16, 112, None, 48), (8, 112, None, 8),
    (128, 128, 32, 0), (64, 224, 50, 64), (33, 17, None, 0)])
def test_attention_pairs_plain_and_library(monkeypatch, Sq, Skv, window,
                                           q_offset):
    """The attention rows' helpers at small shapes: ``attn_pairs`` counts
    what ``attn_mask`` admits; the tiled plain version (taken where the
    dense scores would not fit, as at the 32768-token prefill) and the
    SDPA call both equal ``attention_ref`` (f32, 1e-5)."""
    from repro_torch.kernels import ref
    mask = kbench.attn_mask(Sq, Skv, window, q_offset, torch.device("cpu"))
    assert kbench.attn_pairs(Sq, Skv, window, q_offset) == int(mask.sum())
    gen = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn((2, 6, Sq, 32), generator=gen)
    k, v = (torch.randn((2, 2, Skv, 32), generator=gen) for _ in range(2))
    want = ref.attention_ref(q, k, v, window=window, q_offset=q_offset)
    live = mask.any(dim=1)       # rows with a key (the others: no caller)
    assert torch.equal(kbench.attention_plain(q, k, v, window, q_offset),
                       want)
    monkeypatch.setattr(kbench, "DENSE_SCORES_MAX", 0)
    tiled = kbench.attention_plain(q, k, v, window, q_offset)
    lib = kbench.attention_library(q, k, v, window, q_offset)()
    for got in (tiled, lib):
        assert got.shape == want.shape
        assert (got - want)[:, :, live].abs().max().item() <= 1e-5


def _record_kernel_calls(monkeypatch):
    """Each kernel wrapper's CPU call, as (name, geometry) in a list."""
    from repro_torch.kernels import ops
    calls, orig = [], ops.kernel_call

    def record(name, plain, *args, **kwargs):
        if name == "paged_flash_decode":
            q, kp, _, tables, lens = args
            calls.append((name, tuple(q.shape) + tuple(kp.shape[1:])
                          + (kp.shape[0], tables.shape[1]), lens))
        elif name == "flash_attention":
            q, k = args[:2]
            calls.append((name, tuple(q.shape) + tuple(k.shape[1:3])
                          + (kwargs["window"], kwargs["q_offset"])))
        else:
            calls.append((name, tuple(args[0].shape)
                          + tuple(args[1].shape[1:3])))
        return orig(name, plain, *args, **kwargs)

    monkeypatch.setattr(ops, "kernel_call", record)
    return calls


def test_main_path_tables_hold_phase_22s_shapes(monkeypatch):
    """Phase 22's kernel calls are in the tables that phases 2, 9 and 10
    (and 22b) hold to the plain versions: 22a's qwen2-1.5b prefill of
    32768 tokens and decode against a full 32768-slot ring, recorded
    from the counting pass at published width (fake tensors), and 22c's
    Table V rounds and prefill chunks, recorded from a CPU run (reduced
    width: the geometry is the same)."""
    from repro_torch.configs import InputShape, get_config
    calls = _record_kernel_calls(monkeypatch)
    cfg = get_config("qwen2-1.5b")
    mesh = dryrun.mesh_shape("1x1")
    for S, B, kind in ((32768, 1, "prefill"), (32768, 8, "decode")):
        dryrun.trace(cfg, InputShape("cut", S, B, kind), mesh)
    B, H, KV, Sq, Skv, hd, win, off, _ = kbench.ATTN_SHAPES[
        "qwen2_prefill_32k"]
    Bd, Hd, KVd, W, hdd = kbench.DECODE_SHAPES["qwen2_ring_32k"][:5]
    assert set(calls) == {
        ("flash_attention", (B, H, Sq, hd, KV, Skv, win, off)),
        ("flash_decode", (Bd, Hd, hdd, KVd, W))}
    calls.clear()
    # Table V replays its trace on the cluster's clock; a virtual one that
    # reads 1 us later at each read (the trace's mean arrival gap at 1e6
    # requests/s) makes which lanes a round holds independent of the
    # machine's speed and load
    from repro_torch.bench import serving
    from repro_torch.cluster.live import EdgeCluster

    def virtual_clock_cluster(*args, **kwargs):
        reads = itertools.count()
        return EdgeCluster(*args, clock=lambda: next(reads) * 1e-6,
                           **kwargs)

    monkeypatch.setattr(serving, "EdgeCluster", virtual_clock_cluster)
    bench_tablev(device="cpu")
    B, _, _, _, ps, P, W, lens = kbench.PAGED_SHAPES["tablev_round"]
    paged = [c for c in calls if c[0] == "paged_flash_decode"]
    # (lanes, page size, pool pages, table width)
    assert {(g[0], g[4], g[6], g[7]) for _, g, _ in paged} == {(B, ps, P, W)}
    seen = {tuple(ln.tolist()) for _, _, ln in paged}
    assert lens in seen and max(map(max, seen)) == max(lens)
    B, H, KV, Sq, Skv, hd, win, off, _ = kbench.ATTN_SHAPES["tablev_chunk"]
    assert {c[1][2:3] + c[1][5:] for c in calls
            if c[0] == "flash_attention"} == {(Sq, Skv, win, off)}


def test_roofline_bench_reads_the_dry_run(tmp_path):
    """A 16 x 16 record (traced in a process of its own: the dry run
    starts a fake process group of 256 ranks there) read back as one
    row with its collective term."""
    import os
    import subprocess
    import sys
    assert bench_roofline(str(tmp_path))[0].startswith(
        "roofline_1x1/missing,0,")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "16x16", "--out",
         str(tmp_path / "torch_dryrun_16x16.jsonl")], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    rows = bench_roofline(str(tmp_path))
    (row,) = [r for r in rows if r.startswith("roofline_16x16/")]
    assert row.startswith("roofline_16x16/xlstm-350m/decode_32k,")
    coll = re.search(r"collective=([^;]*);", row).group(1)
    assert ROW.match(row) and float(coll) > 0 and "fits=1" in row


def test_runner_writes_bench_files_and_trajectory(tmp_path, capsys,
                                                  monkeypatch):
    """``--only a,b --out-dir D --trajectory``: each bench with records
    writes ``BENCH_<name>.json``; the trajectory gains one entry."""
    seen = {}

    def fake_fig5(scale, device=None, records=None):
        seen["fig5"] = (scale, device)
        records.append({"bench": "fig5_learning", "method": "lad-ts"})
        return ["fig5_learning/lad-ts,1,final_delay=0.100s"], {}

    def fake_tablev(device=None, full_scale=False):
        seen["tablev"] = (device, full_scale)
        return (["tableV_N=1/dedgeai,1,mean=0.100s"],
                [{"bench": "tablev", "mean_s": np.float64(0.1)}])

    import repro_torch.bench.serving as serving
    monkeypatch.setattr(scheduling, "bench_fig5_learning", fake_fig5)
    monkeypatch.setattr(serving, "bench_tablev", fake_tablev)
    out = tmp_path / "out"
    bench_main.main(["--only", "fig5,tablev,roofline", "--device", "cpu",
                     "--scale", "paper", "--full-scale", "--results",
                     str(tmp_path), "--out-dir", str(out), "--trajectory"])
    assert seen == {"fig5": ("paper", "cpu"), "tablev": ("cpu", True)}
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == ["name,us_per_call,derived",
                           "fig5_learning/lad-ts,1,final_delay=0.100s",
                           "tableV_N=1/dedgeai,1,mean=0.100s"]
    assert sorted(p.name for p in out.iterdir()) == [
        "BENCH_fig5.json", "BENCH_tablev.json", "BENCH_trajectory.json"]
    doc = json.loads((out / "BENCH_tablev.json").read_text())
    assert doc["records"] == [{"bench": "tablev", "mean_s": 0.1}]
    assert doc["scale"] == "paper" and doc["full_scale"] is True
    traj = json.loads((out / "BENCH_trajectory.json").read_text())
    assert traj["runs"][0]["benches"] == ["fig5", "tablev"]
    with pytest.raises(SystemExit):
        bench_main.main(["--only", "fig5,nope"])
