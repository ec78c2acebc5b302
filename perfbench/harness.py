"""One run of one cell: set-up, the measured window, the check and the
result line.

``run()`` is what ``run.py`` calls on the card.  ``setup()``,
``serve()`` and ``judge()`` are its parts; the CPU tests drive them at
reduced sizes (``Options.shrink``) and never reach ``result()``, which
refuses to report without a card.

The model is the configuration's kind (``models/<kind>.py``, every
function of ``KIND_FUNCS``).  In a traced run the readers of the cell's
per-layer metrics may hook the run: each distinct ``prepare(served)``
runs before the engines are built, ``begin(served)`` after the warm-up
and ``collect(served, rec)`` when the window has drained, before the
probes are restored.  An untraced run calls none.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import check, model, traffic
from perfbench.probes import Probes
from perfbench.trace import SubWindow

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KIND_FUNCS = ("spec", "model_config", "make_weights", "copy_weights",
              "engine_params", "weight_bytes", "page_bytes", "logits_at",
              "flops")
HOOKS = ("prepare", "begin", "collect")
# the profiled sub-window: whole steps from this share of the window on,
# for this many seconds
TRACE_AT = 0.3
TRACE_S = 3.0


# ---------------------------------------------------------------------------
# cells, found by name
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = REPO
    kind: object = None      # the configuration's model kind, if not given

    def __post_init__(self):
        if self.kind is None:
            self.kind = model_kind(self.conf["model"], self.root)


def _exec(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_kind(name: str, root: Path = REPO):
    """``perfbench/models/<name>.py``, which has to define every function
    of ``KIND_FUNCS``."""
    path = Path(root) / "perfbench" / "models" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"model kind {name!r}: no file {path}")
    mod = _exec(path, "perfbench_model_" + name.replace(".", "_")
                .replace("-", "_"))
    missing = [f for f in KIND_FUNCS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"model kind {name!r}: {path} defines no "
                             f"{', '.join(missing)}")
    return mod


def load_cell(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``: its configuration
    file with its model kind (checked here), its traffic mix
    ``perfbench/traffic/<traffic>.json``, its limits
    ``perfbench/limits/<cell>.json`` (empty when there are none yet) and
    the metrics it reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf_path = root / confs[w["config"]]["file"]
    conf = model.load(conf_path)
    if "model" not in conf:
        raise KeyError(f"{conf_path}: no \"model\" key naming its kind "
                       f"in perfbench/models/")
    here = root / "perfbench"
    mix = traffic.load(here / "traffic" / f"{w['traffic']}.json")
    lim_path = here / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), conf, mix, limits, e2e, per, root)


def _reader(metric: str, root: Path):
    path = Path(root) / "perfbench" / "readers" / f"{metric}.py"
    return _exec(path, "perfbench_reader_" + metric.replace(".", "_")
                 .replace("-", "_"))


def reader(metric: str, root: Path = REPO
           ) -> Callable[[Dict], Optional[float]]:
    """``perfbench/readers/<metric>.py``'s ``read``."""
    return _reader(metric, root).read


def reader_hooks(cell: Cell) -> Dict[str, List[Callable]]:
    """The hooks that the readers of the cell's per-layer metrics define
    (``HOOKS``), each distinct function once, in the order of
    ``BENCHMARK.json``.  Whatever a hook patches is undone by
    ``Probes.restore`` (``Probes._patch`` or ``Probes.on_restore``)."""
    hooks: Dict[str, List[Callable]] = {h: [] for h in HOOKS}
    for m in cell.per_layer:
        mod = _reader(m["name"], cell.root)
        for h in HOOKS:
            fn = getattr(mod, h, None)
            if fn is not None and fn not in hooks[h]:
                hooks[h].append(fn)
    return hooks


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool = False
    device: str = "cuda"
    shrink: Optional[Dict] = None      # CPU rehearsal: the model's sizes
    num_pages: Optional[int] = None    # the file's unless given
    rate: Optional[float] = None       # the mix's unless given (the sweep)
    sample: Optional[int] = None       # the limits file's unless given


@dataclasses.dataclass
class Served:
    cell: Cell
    opts: Options
    spec: Dict
    cfg: object
    weights: Dict[str, torch.Tensor]
    engines: List
    scheduler: object
    cluster: object
    probes: Probes
    actor: Dict      # the reference's copy: theta [(w, b)], X
    hooks: Dict[str, List[Callable]] = dataclasses.field(
        default_factory=dict)


def setup(cell: Cell, opts: Options,
          breakage: Optional[Callable] = None) -> Served:
    """Weights from the seed, the LAD-TS actor from the configuration's
    ``actor_seed`` (one deployed policy for every run), the edge pair's
    engines, the cluster; the probes installed; every shape of the cell
    warmed; in a traced run the readers' ``prepare`` hooks before the
    engines are built and their ``begin`` hooks after the warm-up.
    ``breakage(served)`` (the fault test) runs last."""
    from repro_torch.cluster.live import EdgeCluster
    from repro_torch.serving.engine import ServeEngine

    conf, serve_c, kind = cell.conf, cell.conf["serve"], cell.kind
    dev = torch.device(opts.device)
    spec = kind.spec(conf, opts.shrink)
    cfg = kind.model_config(conf, spec)
    num_pages = opts.num_pages or serve_c["num_pages"]
    if not num_pages:
        raise ValueError(f"{conf['name']}: no num_pages (size_pool.py)")
    E = serve_c["engines"]
    w0 = kind.make_weights(spec, opts.seed, dev)
    weights = [w0] + [kind.copy_weights(w0) for _ in range(E - 1)]
    probes = Probes(timing=opts.trace)
    actor = model.make_actor(conf["scheduler"], dev)
    # the reference's copy, taken before the program holds the actor
    ref_actor = {"theta": [(layer["w"].to("cpu", copy=True),
                            layer["b"].to("cpu", copy=True))
                           for layer in actor["theta"]],
                 "X": actor["X"].to("cpu", copy=True)}
    scheduler = policy(conf["scheduler"], actor, dev)
    probes.install_steps()
    probes.install_kernels()
    served = Served(cell, opts, spec, cfg, w0, [], scheduler, None, probes,
                    ref_actor, reader_hooks(cell) if opts.trace else {})
    for hook in served.hooks.get("prepare", ()):
        hook(served)
    engines = served.engines
    engines.extend(ServeEngine(cfg, kind.engine_params(spec, w), paged=True,
                               max_len=serve_c["max_len"],
                               max_lanes=serve_c["lanes"],
                               page_size=serve_c["page_size"],
                               num_pages=num_pages,
                               prefill_chunk=serve_c["prefill_chunk"],
                               prefix_cache=serve_c["prefix_cache"],
                               arch_id=conf["port_arch"], device=dev,
                               seed=opts.seed + i)
                   for i, w in enumerate(weights))
    cluster = served.cluster = EdgeCluster(engines, scheduler,
                                           seed=opts.seed)
    warm(engines, cluster, spec, serve_c["prefill_chunk"])
    probes.install_engines(engines)
    probes.install_scheduler(cluster.scheduler)
    for hook in served.hooks.get("begin", ()):
        hook(served)
    if breakage is not None:
        breakage(served)
    return served


def policy(sch: Dict, actor: Dict, dev: torch.device):
    """The port's LAD-TS scheduler acting with ``actor``: the agents'
    state as the port lays it out, its LADN and latent store replaced by
    the harness's (nothing else of it is read while acting)."""
    from repro_torch.cluster.schedulers import PolicyScheduler
    from repro_torch.core import agents
    from repro_torch.core.diffusion import DiffusionPolicyConfig

    acfg = agents.AgentConfig(
        hidden=tuple(sch["hidden"]), train_after=40, replay_capacity=200,
        diffusion=DiffusionPolicyConfig(num_steps=sch["chain_steps"],
                                        beta_min=sch["beta_min"],
                                        beta_max=sch["beta_max"]))
    gen = torch.Generator(device=dev).manual_seed(int(sch["actor_seed"]))
    state = agents.ladts_init(gen, acfg, sch["state_dim"], sch["engines"],
                              sch["max_tasks"], sch["stations"])
    theta = [{"w": layer["w"], "b": layer["b"]} for layer in actor["theta"]]
    state = state._replace(theta=theta, theta_act=theta,
                           X=actor["X"].clone())
    return PolicyScheduler(sch["name"], acfg, state,
                           num_engines=sch["engines"],
                           n_max=sch["max_tasks"])


def warm(engines, cluster, spec: Dict, chunk: int) -> None:
    """The cell's shapes and no others: one full prefill chunk and one
    decode round at full lanes per engine (the round always spans every
    lane), then the scheduler's placement path; each engine is reset
    after."""
    rng = np.random.default_rng(0)
    for e in engines:
        prompt = rng.integers(0, spec["vocab"], (1, chunk), dtype=np.int32)
        e.generate(prompt, 2)
        e.reset()
    cluster.scheduler.select_one(
        cluster.carry, torch.zeros((cluster.obs_dim,), dtype=torch.float32),
        0, 0, torch.Generator().manual_seed(0))
    if engines[0].device.type == "cuda":
        torch.cuda.synchronize()


def requests(cell: Cell, opts: Options, vocab: int, edges: int) -> List:
    """The run's requests, from the mix and the seed."""
    from repro_torch.cluster.request import Request
    mix = cell.mix
    if opts.rate is not None:
        mix = {**mix, "arrival": {**mix["arrival"], "rate": opts.rate}}
    reqs = traffic.generate(mix, opts.seconds, opts.seed, vocab, edges)
    return [Request(rid=r["rid"], prompt=r["prompt"][None, :],
                    max_new_tokens=r["max_new_tokens"],
                    arrival_s=r["arrival_s"], origin=r["origin"])
            for r in reqs]


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def serve(served: Served, reqs: List, t_start: float) -> Dict:
    """Drive ``EdgeCluster.submit`` and ``step`` from the arrival clock,
    an open loop: the window opens at the first due arrival; every
    request due in [0, seconds) is submitted at its due time, and the run
    steps on until each finished or ``drain_s`` passed after the window.
    With ``trace`` a sub-window of whole steps is profiled.  Returns the
    record the readers read."""
    opts, mix, cluster = served.opts, served.cell.mix, served.cluster
    probes = served.probes
    clock = time.monotonic
    gc.collect()
    gc.freeze()
    gc.disable()
    sub = SubWindow() if opts.trace else None
    trace_at, traced = opts.seconds * TRACE_AT, None
    steps: List[tuple] = []
    place: List[tuple] = []
    n, i = len(reqs), 0
    probes.recording = True
    t0 = clock()
    setup_s = time.perf_counter() - t_start
    end = t0 + opts.seconds
    drain_end = end + float(mix.get("drain_s", 0.0))
    while True:
        now = clock()
        if sub is not None:
            if traced is None and now - t0 >= trace_at and now < end:
                sub.start()
                probes.profiling = True
                traced = {"t0": clock() - t0}
            elif probes.profiling and now - t0 >= traced["t0"] + TRACE_S:
                probes.profiling = False
                sub.stop()
                traced["t1"] = clock() - t0
        while i < n and t0 + reqs[i].arrival_s <= now:
            r = reqs[i]
            r.t_arrival = t0 + r.arrival_s
            ts = time.perf_counter()
            with probes.phase("placement"):
                cluster.submit(r)
            place.append((time.perf_counter() - ts, probes.profiling))
            i += 1
        if i >= n and (not cluster.busy or now >= drain_end):
            break
        if cluster.busy:
            ts = clock()
            cluster.step()
            te = clock()
            steps.append((ts - t0, te - ts, probes.profiling))
        else:
            nxt = t0 + reqs[i].arrival_s if i < n else end
            with probes.phase("waiting for an arrival"):
                time.sleep(min(0.002, max(nxt - now, 0.0)))
    t_close = clock()
    probes.recording = False
    if probes.profiling:
        probes.profiling = False
        sub.stop()
        traced["t1"] = t_close - t0
    gc.enable()
    gc.unfreeze()
    if traced is not None:
        traced.update(sub.read())
    return {"t0": t0, "close": t_close - t0, "setup_s": setup_s,
            "seconds": opts.seconds, "submitted": i, "steps": steps,
            "place": place, "trace": traced}


# ---------------------------------------------------------------------------
# after the window
# ---------------------------------------------------------------------------


def settle(served: Served, reqs: List, rec: Dict) -> Dict:
    """What the readers and the check need, read off the program (first
    by the readers' ``collect`` hooks in a traced run); then the probes
    are restored and the program's engines and pools let go."""
    probes = served.probes
    for hook in served.hooks.get("collect", ()):
        hook(served, rec)
    rec["requests"] = reqs[:rec["submitted"]]
    rec["prefill_calls"] = probes.prefill
    rec["decode_calls"] = probes.decode
    rec["attn_calls"] = probes.attn
    rec["paged_calls"] = [(*c[:6], [int(x) for x in c[6].tolist()], c[7])
                          for c in probes.paged]
    rec["placements"] = check.placements_to_host(probes.placements)
    rec["spec"] = served.spec
    rec["kind"] = served.cell.kind
    rec["serve"] = served.cell.conf["serve"]
    probes.restore()
    served.engines.clear()
    served.cluster = served.scheduler = None
    probes.placements.clear()
    probes.paged.clear()
    gc.collect()
    if served.weights["embed"].device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def finished(rec: Dict) -> List:
    """The requests due in the window that finished."""
    return [r for r in rec["requests"] if r.done]


def judge(served: Served, rec: Dict) -> Dict:
    """The check's numbers and their verdict."""
    cell, opts = served.cell, served.opts
    k = opts.sample or cell.limits.get("sample", 16)
    sample = check.pick_sample(finished(rec), k, opts.seed)
    numbers = {"logit_gap": check.logit_gap(cell.kind, served.weights,
                                            served.spec, sample)}
    numbers.update(check.denoise_err(rec["placements"], rec["requests"],
                                     served.actor, cell.conf["scheduler"]))
    numbers["sampled"] = len(sample)
    numbers["sampled_tokens"] = int(sum(len(r.tokens) for r in sample))
    return {"numbers": numbers, "verdict": check.verdict(numbers,
                                                         cell.limits)}


def attempted_failed(rec: Dict):
    reqs = rec["requests"]
    return len(reqs), sum(not r.done for r in reqs)


def metrics(cell: Cell, rec: Dict, trace: bool) -> Dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer
    metrics (on); a reader that finds nothing leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def diagnostics(rec: Dict) -> Dict:
    """Readings for the log (standard error), never for the result."""
    from perfbench import layers
    steps = rec["steps"]
    return {"steps": len(steps),
            "first_step_s": steps[0][1] if steps else None,
            "later_step_ms": (1e3 * float(np.mean([d for _, d, _ in
                                                   steps[1:]]))
                              if len(steps) > 1 else None),
            "engine_skew": layers.engine_skew(rec),
            "finished": len(finished(rec)),
            "submitted": rec["submitted"],
            "close_s": rec["close"],
            "place_s_total": sum(d for d, _ in rec["place"]),
            "service_p95_ms": layers.service_p95_ms(rec),
            "mfu": layers.mfu(rec)}


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def result(cell: Cell, opts: Options, rec: Dict, verdict: Dict,
           peak: int) -> Dict:
    """The result line.  Device numbers exist only on the card."""
    if opts.device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the benchmark reports no "
                           "device metrics from the CPU")
    attempted, failed = attempted_failed(rec)
    ok = bool(verdict) and all(v["ok"] for v in verdict.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics(cell, rec, opts.trace), "device": device}
    if opts.trace:
        tr = rec["trace"] or {}
        if not tr.get("busy_s"):
            raise RuntimeError("the profiled sub-window saw no device "
                               "operation")
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in verdict.items()}
    return line


def run(cell_name: str, opts: Options, t_start: float) -> Dict:
    """One run on the card: returns the result line, or raises."""
    cell = load_cell(cell_name)
    if torch.cuda.device_count() < cell.chips:
        raise RuntimeError(f"{cell_name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} found")
    served = setup(cell, opts)
    reqs = requests(cell, opts, served.spec["vocab"],
                    cell.conf["serve"]["engines"])
    rec = serve(served, reqs, t_start)
    peak = torch.cuda.max_memory_allocated()
    rec = settle(served, reqs, rec)
    checked = judge(served, rec)
    line = result(cell, opts, rec, checked["verdict"], peak)
    for k, v in diagnostics(rec).items():
        print(f"[perfbench] {k} = {v}", file=sys.stderr)
    for k, v in checked["numbers"].items():
        if k not in checked["verdict"]:
            print(f"[perfbench] {k} = {v} (reported, not compared)",
                  file=sys.stderr)
    for k, v in checked["verdict"].items():
        print(f"[perfbench] check {k} = {v['value']} limit {v['limit']} "
              f"{'ok' if v['ok'] else 'FAIL'}", file=sys.stderr)
    return line
