#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first that fails:

1. setup: print the card's name and power limit, build every kernel from
   the sources in the checkout (one ``nvcc`` per source, all at once),
   turn TF32 off;
2. ``paged_flash_decode`` against its plain PyTorch version at the serve
   path's shapes, at 8 lanes of 2048 tokens and at the closed loop's
   rounds of its two paged archs (page 8, an 18-page table: qwen2-1.5b,
   and starcoder2-3b's 24 query heads over 2 KV heads), at phase 16's
   crash drill (page 16, a 7-page table), at phases 18 and 19's rounds
   (page 16, a 7-page table over 11 pages, both archs) and at phase 20c's
   dbrx-132b round (H 48 over KV 8, page 16, a 14-page table) and at
   phase 22c's Table V round (page 16, a 7-page table over 9 pages), in
   bf16 and f32,
   with its time, its bound, the plain version's time and one library call's time;
   each call is two kernels, split and merge, and a profiler trace of one
   call shows both, with the grids its split plan gives;
3. decode against prefill on the card: full-width qwen2-1.5b in f32 with
   2 layers serves one request greedily, and a teacher-forced paged
   prefill over the same tokens must pick the same token everywhere;
   3b: the same for xLSTM: xlstm-350m at published width in f32 with 4
   layers (3 mLSTM, 1 sLSTM) decodes 16 greedy tokens from the dense slot
   pool after a 64-token prompt, and the ``train``-mode forward over the
   same tokens picks the same token everywhere;
4. serve: ``repro_torch.launch.serve.main`` at full qwen2-1.5b width and
   depth in bf16 (2 engines, 8 requests, JSQ), every request completed,
   no KV leak, and the kernel launched once per layer per decode round;
   4b: where a decode round's time goes (``torch.profiler``);
5. ``ladn_denoise`` against its plain version at the LAD-TS path's
   shapes (acting, update terms, live placement; phase 8's, phase 13's
   on its 11-wide QoS observation and phase 17's on the 6-wide
   availability observation) and one shape above 32 wide, f32, with its
   time, its bound, the launch floor (the library's
   empty kernel in a CUDA graph) and the plain version's time; a
   profiler trace of one call per shape must show the instantiation,
   grid and shared memory ``ladn_denoise.plan`` gives; the compiler's
   registers and spills per instantiation (none may spill);
6. LAD-TS training in the simulator at the paper's Table III/IV size
   (B 20, N_max 50, I 5, K 64, |R| 1000, updates after 300): one episode,
   finite average delay, the kernel launched three times per task step;
   6b: where a task step's time goes (``torch.profiler``);
7. simulator evaluation: the trained policy through ``evaluate_scheduler``
   and the opt / random / local heuristics through ``evaluate_method``,
   one episode each, opt beating random;
8. live LAD-TS: ``serve.main`` with ``--scheduler lad-ts`` at phase 4's
   full width (in-sim training first), every request completed, no KV
   leak, decode launches as in phase 4, and one ``ladn_denoise`` launch
   per placement plus the cluster's warm-up;
9. ``flash_attention`` against its plain version at the dense prefill's
   shapes (recurrentgemma-9b heads at 128 and 4096 positions) and the
   paged prefill chunks' (qwen2-1.5b, with a query offset: the serve
   path's and the last chunk of a 2048-token prompt; the closed loop's
   last chunk of a 64-token prompt at qwen2-1.5b's and starcoder2-3b's
   heads) and phase 15's dense prefills (llava-next-mistral-7b's 640
   tokens at 32 heads over 8, musicgen-large's 128 at hd 64 and a group
   of 1), phase 16's f32 prefills (the paged qwen2 16-token chunk
   against a 7 x 16-token table, recurrentgemma's 64- and 16-token dense
   prompts), phases 18 and 19's 8-token chunks (both paged archs) and
   phase 20's (H 48 over KV 8: mixtral-8x22b's 128-token prefill in its
   4096 window, dbrx-132b's 64-token chunk at offset 64 against 224
   keys, and the f32 pass's 4 x 143-token train-mode forwards) and
   phase 22's (22a's qwen2-1.5b prefill of 32768 tokens, whose plain
   version runs in 1024 x 1024 tiles, and 22c's 64-token Table V chunk
   against 112 keys), and the default entry point's f32 calls (``serve``
   without ``--full-scale``: qwen2-1.5b's reduced 64-query chunk,
   recurrentgemma-9b's reduced 32-token prefill), bf16 and f32, with
   its time, its bound (f32 at the tensor cores' 3xTF32 rate, and at the
   CUDA cores' beside it), the plain version's and SDPA's; a profiler
   trace of one call per shape must show one kernel with the grid, block
   and shared memory its tile plan gives; the compiler's registers and
   spills per instantiation, none of the f32 kernel's six may spill;
10. ``flash_decode`` against its plain version at the dense decode
   round's shapes (4 slots of recurrentgemma-9b, a 160-slot ring with
   per-slot lengths, and a wrapped 2048-slot ring) and phase 15's rounds
   (llava's 672-slot rings in bf16, musicgen's 160-slot rings in f32, as
   its dequantised int8 rings reach it), phase 16's f32 76-slot ring and
   phase 20b's mixtral-8x22b round (4 slots of a 144-slot ring, H 48 over
   KV 8, bf16 and f32) and phase 22a's 8 rows of a full 32768-slot
   ring, likewise, its split and merge
   launches traced as in phase 2;
11. decode against teacher-forced forward on the card: full-width
   recurrentgemma-9b in f32 with 3 layers serves one 2040-token prompt
   greedily for 16 tokens, so decode crosses the 2048 window and the ring
   wraps, and the ``train``-mode forward over the same tokens must pick
   the same token everywhere;
12. serve: ``serve.main`` at full recurrentgemma-9b width and depth in
   bf16 (38 layers, 2 dense engines, 8 requests, JSQ), every request
   completed, no slot leaked, ``flash_decode`` launched once per attention
   layer per decode round and ``flash_attention`` once per attention
   layer per prefill; 12b: where a dense decode round's time goes;
13. the closed loop: ``repro_torch.bench.serving.bench_closed_loop`` with
   the fleet at published width and depth (qwen2-1.5b, starcoder2-3b,
   xlstm-350m, qwen2-1.5b; bf16): LAD-TS trained in the QoS simulator,
   the sim half, then a 24-request mixed-QoS trace under all seven
   schedulers, every request finished ``ok``, no KV leak, and in each
   run ``paged_flash_decode`` launched once per attention layer per paged
   decode round, ``flash_attention`` once per attention layer per paged
   prefill chunk and ``ladn_denoise`` once per LAD-TS placement plus the
   warm-up;
14. the multimodal paths against teacher forcing, at published width with
   2 layers in f32: llava-next-mistral-7b decodes 16 greedy tokens after
   576 seeded patches and a 64-token prompt, musicgen-large (model-dtype
   cache) 16 tokens of 4 codebooks, and the ``train``-mode forward over
   the same input picks the same tokens; musicgen's int8 cache gives
   decode logits within the reference's relative bound (0.05) of the
   model-dtype cache's; recurrentgemma-9b's 2040-token prefill with
   ``use_assoc_scan`` gives last logits within 1e-4 of the loop's;
15. serve: ``serve.main`` at full llava-next-mistral-7b and then
   musicgen-large width and depth in bf16 (2 dense engines of 4 slots, 8
   requests, prompts of 64 and 128 tokens, JSQ), every request completed,
   no slot leaked, ``flash_attention`` once per attention layer per
   prefill and ``flash_decode`` once per attention layer per decode round
   (warm-up included); 15b: where a musicgen decode round's time goes,
   with the share of dequantising its int8 rings;
16. crash invariants on the card (f32, published width): qwen2-1.5b with
   2 layers (paged, prefix cache on) and recurrentgemma-9b with 3 layers
   (dense, one local-attention layer) each crash with a dispatched round
   pending, mid-prefill and mid-decode: the orphans are exactly the
   unfinished requests, no KV is held (paged: the pool's references equal
   the prefix cache's size), the retried requests give the uncrashed
   engine's greedy tokens, a stall and a slowdown gate ``dispatch`` as
   the reference does, and the launches are the dispatched passes';
17. ``serve.main`` under ``--chaos`` at qwen2-1.5b's published width and
   depth in bf16 (2 engines, 16 requests, LAD-TS trained in the
   fault-enabled simulator): every request terminal, completion rate 1,
   the injector exhausted, nothing quarantined, no KV held, launches as
   the run implies (``ladn_denoise`` one per placement + the warm-up);
18. ``bench_chaos(full_scale=True)``: qwen2-1.5b and starcoder2-3b at
   published width and depth through one crash under four schedulers,
   completion rate 1, retries within the cap, no KV held, nothing
   quarantined, launches exact; the fault-enabled simulator's
   failure-aware picks no DOWN station;
19. ``bench_stress(full_scale=True)`` on phase 13's fleet with its ladder
   cut (JSQ; 8, 32 and 128 req/s; the overlap A/B at 32): every run
   terminal, none failed, no KV held, nothing quarantined, launches
   exact; the saturation rate, goodput per stage and overlap speedup;
20. MoE serving on the 1 x 1 NCCL smoke mesh (``launch.mesh``), at
   published width: 20a one MoE layer of mixtral-8x22b (d 6144, f 16384,
   E 8, K 2) and of dbrx-132b (f 10752, E 16, K 4) in bf16 at a 128-token
   prefill, 4 decode rows and the engine's round: the local, sharded and
   weights-stationary paths agree within 2e-2 of max |out|, the mesh
   paths issue their collectives, each path's time beside the experts'
   streaming bound; 20b mixtral-8x22b cut to 4 of 56 layers (bf16,
   dense slot pool) and 20c dbrx-132b cut to 4 of 40 layers (bf16, paged
   pool) each serve 8 requests (prompt 128, 16 new tokens, 4 slots)
   through ``ServeEngine(mesh=...)``: every request ``ok``, no KV held,
   the attention kernels launched layers x passes with the warm-up (the
   dense engine's rings decode through ``flash_decode``'s split-only and
   merge-only entries, one each a layer and round),
   prefill logits with and without the mesh within 2e-2, a decode
   round's breakdown; then 2 layers in f32: greedy tokens with the mesh
   equal those without, and at capacity factor E / K greedy decode equals
   the train-mode argmax;
21. LM training: 21a qwen2-1.5b at published width cut to 2 layers in
   f32, one train step on the card (attention's forward the CUDA kernel,
   its backward the plain chunked attention) against the same step on
   the CPU (loss within 1e-4, each gradient leaf within 1e-3 of its
   largest entry), ``flash_attention`` launched layers x microbatches
   times, and bf16 on the card against f32 (2e-2); 21b ``launch.train
   --arch qwen2-1.5b --smoke --steps 40``: the eval loss 0.2 below the
   first; 21c qwen2-1.5b at published width and depth in bf16, batch 8 x
   512 tokens, the config's 8 microbatches and remat: a warm-up step and
   5 timed steps (finite, params moving, launches exact), tokens/s, host
   enqueue against wall time a step, peak memory and a profiled step's
   device time; 21d mixtral-8x22b at published width cut to 2 layers in
   f32: one step's gradients on the smoke mesh with the hoisted expert
   layout equal the step's without the mesh (1e-4);
22. the tooling: 22a ``launch.dryrun``'s counting pass (fake CPU
   tensors) for qwen2-1.5b at published width and depth in bf16 at a
   train (2 x 512), a prefill (1 x 32768) and a decode shape (8 against a
   32768-deep ring), then each step on the card: the allocated inputs'
   bytes equal the dry run's argument bytes exactly, the counted bound
   under the H100 peaks over the measured time (CUDA events) is at most
   1.05, peak memory, and the attention kernels launched layers x
   calls; 22b ``bench.kernels.bench_kernels()``: every kernel at the
   reference's bench shapes and the main path's equal to its plain
   version; 22c ``bench_tablev(full_scale=True)``: every request ``ok``,
   no KV held, ``paged_flash_decode`` = layers x decode rounds and
   ``flash_attention`` = layers x prefill chunks; 22d Figs. 5, 6a and 8a
   at quick scale, cut to the budget after one timed episode: finite
   delays, ``ladn_denoise`` 3 a training step and 1 an evaluation step;
   22e ``bench_roofline()`` and the report over 22a's records;
23. the reference's placement on the 1 x 1 NCCL mesh (every weight
   placed by ``param_pspecs``, every collective issued on one-rank
   groups): 23a ``flash_decode``'s split-only entry
   (``ops.flash_decode_partials``) then its merge-only entry
   (``ops.decode_merge``) against the one-call kernel and the plain
   versions at recurrentgemma-9b's and llava-next-mistral-7b's decode
   rounds in bf16 and f32, and a 160-slot ring cut by hand into 4
   slices, the last empty, against the whole ring's plain decode, with
   each pass's time and bound; 23b qwen2-1.5b (paged) and 23c
   recurrentgemma-9b (dense) at published width and depth in bf16
   through ``build_sharded_engine``: 8 and 4 greedy requests with the
   tokens of a meshless engine on the same weights, no KV held, exact
   launches (both: a split-only entry and the merge = attention layers
   x decode rounds with the warm-up), placed bytes (the page pool's
   block or the rings included) = the dry run's argument bytes for
   the same mesh, and a decode round's host and device ms with the mesh
   and without; 23d a reduced qwen2-1.5b train step (f32) on placed
   params = the meshless step within 1e-5;
24. one rank's program on the production mesh: 24a xlstm-350m (dense,
   published width and depth, bf16) through ``build_sharded_engine`` on
   the 1 x 1 mesh (the tensor-parallel mLSTM and the whole sLSTM):
   tokens = the meshless engine's, placed bytes = the dry run's (23b
   and 23c run qwen2-1.5b and recurrentgemma-9b through the
   head-parallel attention and the tensor-parallel RG-LRU, and 20b /
   20c check the MoE engines' placed bytes too); then, the smoke
   mesh's group destroyed, the dry run traces rank 0's program of
   minitron-8b x train_4k and llava-next-mistral-7b, recurrentgemma-9b
   and mixtral-8x22b x prefill_32k on 16 x 16 (a fake process group of
   256 ranks, on the CPU); 24b ``flash_attention`` at every shape those
   traces recorded (2, 1 and 3 query heads over 1 K/V head) against
   its plain version (absolute, and in each query row against its
   RMS, a limit a planted fault must pass: ``ROW_TOL``; phase 9's
   shapes too) and SDPA, timed beside the bound; 24c llava x
   prefill_32k's rank-0 program on the card under a fake group over
   CUDA tensors (the fake collectives move nothing): placed bytes = the
   dry run's, device time against the dry run's compute and memory
   terms (bound / measured <= 1.05), ``flash_attention`` = layers;
25. the paged pool cut into page blocks over the data ranks, as the
   reference places it: 25a ``paged_flash_decode``'s split-only entry
   (``ops.paged_flash_decode_partials``) then ``decode_merge`` at phase
   2's serve shape, 8 lanes of 2048 tokens and the dbrx-132b round, bf16
   and f32: over one page block bit for bit the one-call kernel's
   output, over 4 blocks (each rank's partials on the card in turn,
   through its compacted table) the plain decode's within the tolerance,
   a planted fault (one rank's partials dropped) above it, each pass's
   time beside its bound and the plain version's; 25b rank 0 of 16 x 16
   under a fake group over CUDA tensors: a qwen2-1.5b paged engine at
   published width and depth with 1024 pages holds 64 of them, bytes =
   the dry run's count, 1/16 of the whole pool (23b and 20c now run the
   split pass and the merge over the 1 x 1 mesh's one page block);
26. Mellum2's sliding layers on the paged pool: 26a
   ``paged_flash_decode_window`` against its plain version at the
   mellum2-12b-edge2 cell's decode round (32 lanes of 256-3583 tokens, H
   32 over KV 4, hd 128, page 16, a 228-page table, window 1024; lanes
   under the window, at it, one past it mid-page), bf16 and f32, the key
   at each window edge made to decide the output, so that a window one
   shorter or longer, or none, fails the tolerance; its two kernels
   traced against the split plan, its time, bound, the plain version's
   and SDPA's over the gathered windows; 26b ``serve.main`` at full
   mellum2-12b width and depth in bf16 (2 paged engines, 8 requests of
   1100-token prompts, JSQ): every request completed, no KV held,
   ``paged_flash_decode_window`` launched 21 times a decode round (the
   sliding layers), ``paged_flash_decode`` 7 (the full ones) and
   ``flash_attention`` 28 a prefill chunk;
then the kernels line (one JSON object listing every ported kernel) and
the last line, ``{"ok": true, "device": {...}}``.

Every kernel's launch count is read from its main path's run, with the
counts set to 0 just before it.  Phases 16-19 fail if the cluster
quarantined an engine: a kernel or card fault must fail the run, not be
absorbed.  It needs nothing but the checkout:
weights are random, drawn from seeds.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:
    # the kernels' main-path shapes, inputs, bounds and timer (one copy,
    # shared with ``python -m repro_torch.bench kernels``)
    from repro_torch.bench.kernels import (
        ATTN_SHAPES, DECODE_SHAPES, LADN_SHAPES, LADN_TOL, LADN_WIDE,
        PAGED_SHAPES, PS, TOL, attention_case, attention_library,
        attention_bound, attention_plain, attention_timing, attn_pairs,
        bound,
        flash_decode_case, ladn_bound, ladn_case, paged_decode_case,
        sdpa_paged_inputs, time_ms)
    from repro_torch.launch.mesh import HBM_BW
except ImportError as exc:      # a copy of this script alone
    print(f"[chip_smoke] FAIL: cannot import the port from {ROOT}/src: "
          f"{exc}", flush=True)
    sys.exit(1)

SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full-scale", "--edges", "2",
              "--scheduler", "jsq", "--requests", "8", "--prompt-len", "128",
              "--tokens", "32", "--rate", "8", "--device", "cuda"]
N_REQUESTS = 8

# seconds one simulator episode may take before num_slots is cut
EPISODE_BUDGET_S = 120.0
MIN_SLOTS = 20

RG = "recurrentgemma-9b"
RG_SERVE_ARGS = ["--arch", RG, "--full-scale", "--edges", "2",
                 "--scheduler", "jsq", "--requests", "8", "--prompt-len",
                 "128", "--tokens", "32", "--rate", "8", "--kv-slots", "4",
                 "--device", "cuda"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def eager_ms(fn, iters: int = 200) -> float:
    """Wall time per call when called from Python one after another (what
    the eager serving loop pays, launch overhead included)."""
    import torch
    for _ in range(10):
        fn()
    start, end = _events()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: setup
# ---------------------------------------------------------------------------


def phase_setup() -> str:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        from repro_torch.kernels import decode_attention
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT}/src: {exc}")
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    card = res.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build, flash_attention, ladn_denoise
    sources = [decode_attention.SOURCE, ladn_denoise.SOURCE,
               flash_attention.SOURCE, decode_attention.FLASH_DECODE_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(build.build, s) for s in sources]:
            fut.result()
    log(f"phase 1 ok: built {len(sources)} kernels in "
        f"{time.perf_counter() - t0:.2f} s; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    for src in sources:
        info = build.build_info[src.stem]
        log(f"  {os.path.basename(info['path'])}: {info['seconds']:.2f} s "
            f"(cached={info['cached']})")
        for line in info.get("ptxas", "").splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"    ptxas: {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def traced_launches(fn, calls: int = 4, pad: int = 64):
    """The kernels one ``fn()`` call launches, read from a
    ``torch.profiler`` trace: each one's name, grid and shared-memory bytes
    (None where the trace holds none).  A session's first kernel records
    can be missing from its trace (on an H100, up to ~10 of them late in
    this script's run), so the trace holds ``pad`` short spin kernels, then ``calls``
    calls, then one more spin kernel.  None unless a spin record comes
    first and last (nothing of the calls was lost) and the calls' kernels
    split into ``calls`` equal calls."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(100_000)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e.get("ts", 0))
    spin = ["spin_kernel" in e["name"] for e in kernels]
    mine = [{"kernel": e["name"], "grid": e.get("args", {}).get("grid"),
             "block": e.get("args", {}).get("block"),
             "smem": e.get("args", {}).get("shared memory")}
            for e, is_spin in zip(kernels, spin) if not is_spin]
    if not (kernels and spin[0] and spin[-1]) or len(mine) % calls:
        return None
    per = len(mine) // calls
    if any(mine[i]["kernel"] != mine[i % per]["kernel"]
           for i in range(len(mine))):
        return None
    return mine[:per]


def check_split_launches(label: str, fn, Bs, Hs, KVs, n_positions,
                         unit) -> list:
    """Trace one decode wrapper call (``traced_launches``) and hold what it
    launched to the split plan: one split kernel of grid
    (B * KV * ceil(G / 16), n_splits) and one merge kernel of grid B * H.
    Returns the traced launches, each named ``split`` or ``merge`` (None
    where the trace was incomplete)."""
    from repro_torch.kernels import decode_attention
    per, n = decode_attention.split_plan(Bs, KVs, n_positions, unit)
    want = {"split": [Bs * KVs * -(-(Hs // KVs) // 16), n, 1],
            "merge": [Bs * Hs, 1, 1]}
    launched = traced_launches(fn)
    for row in launched or []:
        row["kernel"] = ("split" if "split_kernel" in row["kernel"] else
                         "merge" if "merge_kernel" in row["kernel"] else
                         row["kernel"])
    seen = "not measured (incomplete trace)" if launched is None else launched
    log(f"    {label}: plan {per} positions x {n} splits; traced launches "
        f"{seen}")
    if launched is not None:
        if [r["kernel"] for r in launched] != ["split", "merge"]:
            fail(f"{label}: one call launched {launched}, expected a split "
                 f"and a merge kernel")
        for r in launched:
            if r["grid"] is not None and list(r["grid"]) != want[r["kernel"]]:
                fail(f"{label}: {r['kernel']} grid {r['grid']}, the plan "
                     f"gives {want[r['kernel']]}")
    return launched


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    result = {}
    for shape, (Bs, Hs, KVs, hd, ps, Ps, Ws, lens_t) in PAGED_SHAPES.items():
        log(f"  paged_flash_decode {shape} (B={Bs} H={Hs} KV={KVs} hd={hd}"
            f" ps={ps} P={Ps} W={Ws})")
        for name in ("bfloat16", "float32"):
            q, kp, vp, tables, lens = paged_decode_case(
                PAGED_SHAPES[shape], getattr(torch, name))
            got = decode_attention.paged_flash_decode(q, kp, vp, tables,
                                                      lens)
            torch.cuda.synchronize()
            want = ref.paged_decode_ref(q, kp, vp, tables, lens)
            # an idle lane (length 0) gives zeros, as the reference's
            # kernel does; the plain version gives the mean of V there
            live = lens > 0
            err = (got[live].float() - want[live].float()).abs().max().item()
            if not err <= TOL[name]:
                fail(f"paged_flash_decode {shape} {name}: max abs err "
                     f"{err:.3e} > {TOL[name]:.0e}")
            if got[~live].count_nonzero().item():
                fail(f"paged_flash_decode {shape} {name}: idle lanes not "
                     f"zero")
            # a zero-length lane gives zeros
            z = decode_attention.paged_flash_decode(q, kp, vp, tables,
                                                    torch.zeros_like(lens))
            if z.abs().max().item() != 0.0:
                fail(f"paged_flash_decode {shape} {name}: length-0 lanes "
                     f"not zero")

            def kernel():
                return decode_attention.paged_flash_decode(q, kp, vp, tables,
                                                           lens)
            launched = check_split_launches(
                f"paged_flash_decode {shape} {name}", kernel, Bs, Hs, KVs,
                Ws * ps, ps)
            ms = time_ms(kernel)
            call_ms = eager_ms(kernel)
            plain_ms = time_ms(lambda: ref.paged_decode_ref(q, kp, vp,
                                                            tables, lens))
            sq, sk, sv, mask = sdpa_paged_inputs(q, kp, vp, tables, lens)
            lib_out = F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True)[:, :, 0]
            lib_err = (lib_out.float() - want.float()).abs().max().item()
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True))
            size = q.element_size()
            ctx = int(sum(min(int(n), Ws * ps) for n in lens_t))
            nbytes = (2 * q.numel() * size            # q in, out
                      + 2 * ctx * KVs * hd * size     # the K and V it needs
                      + tables.numel() * 4 + lens.numel() * 4)
            bound_ms, bound_by = bound(nbytes, 4 * ctx * Hs * hd, name)
            row = {"max_abs_err": err, "ms": ms, "eager_ms": call_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_err": lib_err, "bound_ms": bound_ms,
                   "bound_by": bound_by, "launched": launched,
                   "kernel_launches_per_call": (None if launched is None
                                                else len(launched))}
            result.setdefault(shape, {})[name] = row
            log(f"  paged_flash_decode {shape} {name}: err={err:.3e} (tol "
                f"{TOL[name]:.0e}) kernel={ms:.4f} ms (eager call "
                f"{call_ms:.4f} ms) plain={plain_ms:.4f} ms "
                f"sdpa={library_ms:.4f} ms (err {lib_err:.2e}) "
                f"bound={bound_ms:.6f} ms ({bound_by})")
            del q, kp, vp, tables, lens, got, want, sk, sv, lib_out
            torch.cuda.empty_cache()
    log(f"phase 2 ok: paged_flash_decode matches paged_decode_ref at "
        f"{', '.join(PAGED_SHAPES)}")
    return result


# ---------------------------------------------------------------------------
# phase 3: decode against teacher-forced prefill
# ---------------------------------------------------------------------------


def phase_decode_vs_prefill() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (forward, init_params,
                                                init_paged_states)
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                         dev)
    eng = ServeEngine(cfg, params, max_len=64, page_size=PS,
                      prefill_chunk=64, device=dev)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 40),
                                               dtype=np.int32)
    n_new = 10
    toks = np.concatenate(eng.generate(prompt, n_new).tokens)
    if eng.kv_leak:
        fail(f"decode engine leaked {eng.kv_leak} page references")
    seq = np.concatenate([prompt[0], toks[:-1]]).astype(np.int32)
    S = seq.shape[0]
    npages = -(-S // PS)
    states = init_paged_states(cfg, 1 + npages, PS, dev)
    out = forward(params, cfg,
                  {"tokens": torch.from_numpy(seq[None]).to(dev),
                   "start": 0,
                   "block_table": torch.arange(1, 1 + npages,
                                               dtype=torch.int32,
                                               device=dev)},
                  mode="paged_prefill", states=states)
    logits = out["chunk_logits"][0, prompt.shape[1] - 1:].float()
    pred = logits.argmax(-1).cpu().numpy()
    if not np.isfinite(logits.cpu().numpy()).all():
        fail("prefill logits are not finite")
    for i in np.flatnonzero(pred != toks):
        top2 = torch.topk(logits[i], 2).values
        fail(f"decode token {i} = {toks[i]} but prefill argmax = {pred[i]}"
             f" (top-2 logit gap {(top2[0] - top2[1]).item():.3e})")
    log(f"phase 3 ok: {n_new} greedy decode tokens equal the teacher-forced"
        f" prefill argmax (full width, 2 layers, f32)")
    del eng, params, states, out
    torch.cuda.empty_cache()


XLSTM = "xlstm-350m"


def phase_xlstm_decode_vs_forward() -> None:
    """xlstm-350m at published width, f32, 4 layers: 16 greedy tokens
    from the dense slot pool against the train-mode forward's argmax, and
    the decode logits' distance from the teacher-forced ones."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (apply_head, forward,
                                                init_params)
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(XLSTM), num_layers=4,
                              dtype="float32")
    if [b.mixer for b in cfg.layer_pattern()] != ["mlstm"] * 3 + ["slstm"]:
        fail(f"phase 3b: unexpected layers {cfg.layer_pattern()}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(13),
                         dev)
    plen, n_new = 64, 16
    eng = ServeEngine(cfg, params, max_len=plen + n_new, kv_slots=2,
                      device=dev)
    if eng.paged:
        fail("phase 3b: xlstm-350m did not get a dense engine")
    prompt = np.random.default_rng(13).integers(0, cfg.vocab_size,
                                                (1, plen), dtype=np.int32)
    ops.reset_launches()
    t0 = time.perf_counter()
    toks = np.concatenate(eng.generate(prompt, n_new).tokens)
    gen_s = time.perf_counter() - t0
    if any(ops.launches.values()):
        fail(f"phase 3b: an xLSTM engine launched {ops.launches}; it has "
             f"no attention layer")
    if eng.kv_leak:
        fail(f"phase 3b: the engine holds {eng.kv_leak} slots when idle")
    seq = torch.from_numpy(
        np.concatenate([prompt[0], toks[:-1]]).astype(np.int32)[None]
    ).to(dev)
    hidden = forward(params, cfg, {"tokens": seq}, mode="train")["hidden"]
    want = apply_head(params, cfg, hidden[:, plen - 1:])[0].float()
    if not torch.isfinite(want).all():
        fail("phase 3b: teacher-forced logits are not finite")
    pred = want.argmax(-1).cpu().numpy()
    for i in np.flatnonzero(pred != toks):
        top2 = torch.topk(want[i], 2).values
        fail(f"phase 3b: decode token {i} (position {plen + i}) = "
             f"{toks[i]} but the teacher-forced argmax = {pred[i]} (top-2 "
             f"logit gap {(top2[0] - top2[1]).item():.3e})")
    # the decode path's own logits over the same tokens
    out = forward(params, cfg, {"tokens": seq[:, :plen]}, mode="prefill",
                  max_len=plen + n_new)
    got, states = [out["last_logits"][0]], out["states"]
    for j in range(plen, plen + n_new - 1):
        out = forward(params, cfg, {"tokens": seq[:, j:j + 1]},
                      mode="decode", states=states)
        got.append(out["logits"][0])
        states = out["states"]
    err = (torch.stack(got).float() - want).abs().max().item()
    log(f"phase 3b ok: {n_new} greedy decode tokens of xlstm-350m (d "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, 3 mLSTM "
        f"+ 1 sLSTM layers, f32) after a {plen}-token prompt equal the "
        f"teacher-forced train-mode argmax; max abs logit error of decode "
        f"against teacher forcing {err:.3e}; engine prefill + decode "
        f"{gen_s:.2f} s; no kernel launched")
    del eng, params, hidden, want, got, states, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve through the port's launcher
# ---------------------------------------------------------------------------


def _check_serve(st: dict, label: str) -> int:
    """The serve phases' shared checks; returns the decode rounds."""
    if st["completed"] != N_REQUESTS or st["count"] != N_REQUESTS:
        fail(f"{label}: {st['completed']} of {N_REQUESTS} requests "
             f"completed")
    leaks = [e["kv_leak"] for e in st["engines"]]
    if any(leaks):
        fail(f"{label}: KV page leak per engine: {leaks}")
    if any(e["layers"] != 28 for e in st["engines"]):
        fail(f"{label}: engines are not full depth: {st['engines']}")
    rounds = sum(e["decode_rounds"] for e in st["engines"])
    want = sum(e["layers"] * e["decode_rounds"] for e in st["engines"])
    got = st["launches"]["paged_flash_decode"]
    if rounds == 0 or got != want:
        fail(f"{label}: paged_flash_decode launched {got} times after "
             f"warm-up, expected 28 x {rounds} decode rounds = {want}")
    chunks = sum(e["prefills"] for e in st["engines"])
    want = sum(e["layers"] * e["prefills"] for e in st["engines"])
    got = st["launches"]["flash_attention"]
    if chunks == 0 or got != want:
        fail(f"{label}: flash_attention launched {got} times after warm-up,"
             f" expected 28 x {chunks} paged prefill chunks = {want}")
    return rounds


def phase_serve() -> int:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    t0 = time.perf_counter()
    st = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ops.launches["paged_flash_decode"]
    attn_launches = ops.launches["flash_attention"]
    rounds = _check_serve(st, "phase 4")
    got = st["launches"]["paged_flash_decode"]
    leaks = [e["kv_leak"] for e in st["engines"]]
    if launches <= 0:
        fail("paged_flash_decode never launched on the main path")
    log(f"phase 4 ok: 8/8 completed, kv_leak={leaks}, {rounds} decode "
        f"rounds, {got} kernel launches after warm-up ({launches} with "
        f"warm-up); flash_attention {st['launches']['flash_attention']} = "
        f"28 x {sum(e['prefills'] for e in st['engines'])} prefill chunks "
        f"({attn_launches} with warm-up); service mean="
        f"{st['mean_s'] * 1e3:.1f} ms "
        f"p95={st['p95_s'] * 1e3:.1f} ms; {st['tok_s']:.1f} generated "
        f"tok/s over {st['wall_s']:.2f} s of serving ({total:.1f} s with "
        f"build and warm-up); decode ms/token per engine "
        f"{[round(e['token_ms'], 3) for e in st['engines']]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, attn_launches


def _by_kernel(prof) -> dict:
    """Device microseconds by kernel name in a ``torch.profiler`` session,
    without the spin kernels that pad a trace."""
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type is not None and "CUDA" in str(evt.device_type):
            us = getattr(evt, "self_device_time_total", 0.0)
            if us > 0 and "spin_kernel" not in evt.key:
                by_kernel[evt.key] = us
    return by_kernel


def _profile_prefill(step, n_attn: int, label: str) -> None:
    """Device time of ``step()`` (prefill work), by ``torch.profiler``,
    per prefill and the ``flash_attention`` share of it; ``n_attn`` is the
    kernel's launches per prefill.  The trace starts with spin kernels, so
    that its first records, which a session can lose, are not the
    prefill's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    before = ops.launches["flash_attention"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(100_000)
        step()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    n = (ops.launches["flash_attention"] - before) // n_attn
    if not by_kernel or n <= 0:
        log(f"  {label}: device time not measured (the profiler saw no "
            f"device time, or no prefill ran)")
        return
    busy = sum(by_kernel.values()) / 1e3 / n
    attn = sum(v for k, v in by_kernel.items()
               if "flash_attention" in k) / 1e3 / n
    log(f"  {label}: {n} prefill(s), device busy {busy:.3f} ms per "
        f"prefill, flash_attention {attn:.4f} ms of it ({n_attn} launches, "
        f"{attn / n_attn * 1e3:.2f} us each)")


def _kernel_share(by_kernel: dict, word: str, rounds: int):
    """Device ms per round of the kernels whose names hold ``word`` (a
    decode call's split and merge kernels), and the split of it by kernel.
    The merge is a programmatic dependent launch: its time counts from
    when its blocks start, which may be before the split kernel ends."""
    mine = {k: v / 1e3 / rounds for k, v in by_kernel.items() if word in k}

    def part(k):
        return ("split" if "split_kernel" in k else
                "merge" if "merge_kernel" in k else k)
    parts = ", ".join(f"{part(k)} {v:.3f}" for k, v in sorted(mine.items()))
    return sum(mine.values()), parts


def phase_round_breakdown(rounds: int = 4) -> None:
    """Where a full-scale decode round's time goes: one 28-layer bf16
    engine with all 8 lanes decoding; host enqueue time of ``dispatch``,
    wall time to results, and the device time by kernel from
    ``torch.profiler`` over ``rounds`` rounds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.request import Request
    from repro_torch.serving.builders import build_engines
    eng = build_engines("qwen2-1.5b", 1, 160, device="cuda",
                        full_scale=True)[0]
    rng = np.random.default_rng(5)
    for rid in range(PAGED_SHAPES["serve"][0]):      # the serve's 8 lanes
        eng.admit(Request(rid=rid, max_new_tokens=32,
                          prompt=rng.integers(0, eng.cfg.vocab_size,
                                              (1, 128), dtype=np.int32)))
    # the lanes' two 64-token prefill chunks, then a warm round
    _profile_prefill(lambda: [eng.step() for _ in range(2)],
                     eng.cfg.num_layers,
                     "phase 4b: paged prefill chunks (64 tokens, 28 layers)")
    eng.step()
    torch.cuda.synchronize()

    def timed_round():
        t0 = time.perf_counter()
        eng.dispatch()
        t1 = time.perf_counter()
        eng.collect()
        return t1 - t0, time.perf_counter() - t0

    host = [timed_round() for _ in range(rounds)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    enqueue_ms = 1e3 * sum(h[0] for h in host) / rounds
    wall_ms = 1e3 * sum(h[1] for h in host) / rounds
    busy_ms = sum(by_kernel.values()) / 1e3 / rounds
    attn_ms, attn_parts = _kernel_share(by_kernel, "paged_decode", rounds)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    busy = (f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.2f}), paged_flash_decode "
            f"{attn_ms:.3f} ms of it ({attn_parts})" if by_kernel else
            "device busy not measured (the profiler saw no device time)")
    log(f"phase 4b: decode round (8 lanes, 28 layers, bf16): enqueue "
        f"{enqueue_ms:.2f} ms, wall {wall_ms:.2f} ms, {busy}")
    for name, us in top:
        log(f"  device {us / 1e3 / rounds:8.3f} ms/round  {name[:90]}")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: ladn_denoise against its plain version
# ---------------------------------------------------------------------------


def check_ladn_launch(label: str, fn, plan):
    """Trace one ``ladn_denoise_fused`` call (``traced_launches``): one
    kernel, of the plan's instantiation, grid and shared memory.
    Returns the traced launch, its kernel named by the trace (None where
    the trace was incomplete)."""
    import re
    launched = traced_launches(fn)
    want = {"grid": [plan.blocks, plan.agents, 1], "smem": plan.smem}
    seen = "not measured (incomplete trace)" if launched is None else launched
    log(f"    {label}: plan {plan.kernel}, {plan.rows} row(s) a block, "
        f"grid {want['grid']}, {plan.smem} B shared; traced {seen}")
    if launched is None:
        return None
    if len(launched) != 1 or plan.kernel not in launched[0]["kernel"]:
        fail(f"{label}: one call launched {launched}, expected one "
             f"{plan.kernel}")
    row = launched[0]
    for key, value in want.items():
        if row[key] is not None and (list(row[key]) if key == "grid"
                                     else row[key]) != value:
            fail(f"{label}: {key} {row[key]}, the plan gives {value}")
    name = re.findall(r"ladn_\w+_kernel<\d+>", row["kernel"])
    return {"kernel": name[0] if name else row["kernel"][:60],
            "grid": row["grid"], "smem": row["smem"]}


def phase_ladn_kernel() -> dict:
    import torch
    from repro_torch.core.diffusion import DiffusionSchedule
    from repro_torch.kernels import build, ladn_denoise, ref
    info = build.build_info["ladn_denoise"]
    ptxas = [r for r in ptxas_report(info.get("ptxas", ""))
             if "ladn" in r["kernel"]]
    for row in ptxas:
        log(f"  ptxas {row['kernel']}: {row.get('registers')} registers, "
            f"{row['stack']} B stack, spills {row['spill_stores']} B stored"
            f" / {row['spill_loads']} B loaded"
            f"{' (a cached build)' if info['cached'] else ''}")
    # one row per width class, none spilling
    kernels = sorted(r["kernel"] for r in ptxas
                     if r["kernel"].startswith(("ladn_regs_kernel",
                                                "ladn_smem_kernel")))
    want = sorted(ladn_denoise.Plan(w, 1, 1, 1, 0).kernel
                  for w in ladn_denoise.WIDTHS)
    if kernels != want:
        fail(f"ladn_denoise: ptxas reports {kernels}, expected one kernel "
             f"per width class: {want}")
    spills = [r for r in ptxas if r["spill_stores"] or r["spill_loads"]]
    if spills:
        fail(f"ladn_denoise: a kernel spills: {spills}")
    floor_ms = time_ms(ladn_denoise.noop)
    log(f"  ladn_noop (the library's empty kernel, one warp): "
        f"{floor_ms:.4f} ms a launch in a CUDA graph (the floor)")
    # only this run's compiler report goes into the kernels line
    result = {"floor_ms": floor_ms}
    if not info["cached"]:
        result["ptxas"] = ptxas
    for name, shape in {**LADN_SHAPES, **LADN_WIDE}.items():
        G, T, I, A, S, H = shape  # noqa: E741
        plan = ladn_denoise.plan(G, T, A, S, H, I)
        args = ladn_case(*shape)
        # the plain version's schedule on the card (nothing is copied from
        # the host inside the timed graph); the kernel folds the numpy one
        plain_args = args[:-1] + (DiffusionSchedule(
            *(torch.as_tensor(a, device="cuda") for a in args[-1])),)
        got = ladn_denoise.ladn_denoise_fused(*args)
        torch.cuda.synchronize()
        want = ref.ladn_denoise_ref(*plain_args)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=LADN_TOL, rtol=LADN_TOL):
            fail(f"ladn_denoise {name} {shape}: max abs err {err:.3e} "
                 f"beyond atol/rtol {LADN_TOL:.0e}")

        def kernel():
            return ladn_denoise.ladn_denoise_fused(*args)

        launched = check_ladn_launch(f"ladn_denoise {name}", kernel, plan)
        ms = time_ms(kernel)
        call_ms = eager_ms(kernel)
        plain_ms = time_ms(lambda: ref.ladn_denoise_ref(*plain_args))
        bound_ms, bound_by = ladn_bound(*shape)
        result[name] = {"shape": dict(zip("GTIASH", shape)),
                        "launched": launched,
                        "max_abs_err": err, "ms": ms, "eager_ms": call_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "floor_ms": floor_ms}
        log(f"  ladn_denoise {name} G,T,I,A,S,H={shape} ({plan.kernel}): "
            f"err={err:.3e} (tol {LADN_TOL:.0e}) kernel={ms:.4f} ms (eager "
            f"call {call_ms:.4f} ms) floor={floor_ms:.4f} ms "
            f"plain={plain_ms:.4f} ms bound={bound_ms:.6f} ms ({bound_by})")
    log(f"phase 5 ok: ladn_denoise matches ladn_denoise_ref at "
        f"{', '.join({**LADN_SHAPES, **LADN_WIDE})} (no single PyTorch call "
        f"computes the chain: no library time)")
    return result


# ---------------------------------------------------------------------------
# phase 6: LAD-TS training in the simulator at Table III/IV
# ---------------------------------------------------------------------------


def phase_sim_train():
    """One training episode at the paper's size; returns (EnvParams,
    AgentConfig, capacities, trained states, ladn launches)."""
    import dataclasses as dc
    import math
    import torch
    from repro_torch.core import agents as ag
    from repro_torch.core import env as envlib
    from repro_torch.core.trainer import (build_episode_fn, init_agents,
                                          train_method)
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    p, cfg = envlib.EnvParams(), ag.AgentConfig()
    f = envlib.sample_capacities(torch.Generator(device=dev).manual_seed(0),
                                 p)
    # probe: one slot of task steps (warms the libraries) to size the run
    gen = torch.Generator(device=dev).manual_seed(1)
    probe = dc.replace(p, num_slots=1)
    episode = build_episode_fn("lad-ts", probe, cfg)
    states = init_agents("lad-ts", probe, cfg, gen)
    for _ in range(2):
        t0 = time.perf_counter()
        _, avg = episode(states, envlib.sample_episode(gen, probe, f=f),
                         gen)
        float(avg)
        step_s = (time.perf_counter() - t0) / probe.max_tasks
    slots = min(p.num_slots, max(MIN_SLOTS, int(
        EPISODE_BUDGET_S / (step_s * p.max_tasks))))
    if slots < p.num_slots:
        log(f"  cut: num_slots {p.num_slots} -> {slots} (a task step takes "
            f"{step_s * 1e3:.1f} ms; one {p.num_slots}-slot episode would "
            f"take {step_s * p.max_tasks * p.num_slots:.0f} s)")
        p = dc.replace(p, num_slots=slots)
    ops.reset_launches()
    t0 = time.perf_counter()
    delays, states = train_method("lad-ts", p, cfg, episodes=1, seed=0,
                                  f=f, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches["ladn_denoise"]
    steps = p.num_slots * p.max_tasks
    if not math.isfinite(delays[0]) or delays[0] <= 0:
        fail(f"phase 6: average delay {delays[0]} is not finite and > 0")
    if launches != 3 * steps:
        fail(f"phase 6: ladn_denoise launched {launches} times, expected "
             f"3 per task step (act, target, entropy) x {steps} = "
             f"{3 * steps}")
    size = states.replay.size
    if int(size.min()) <= cfg.train_after or int(states.steps.min()) <= 0:
        fail(f"phase 6: updates never started (pool sizes "
             f"{size.tolist()}, updates {states.steps.tolist()})")
    log(f"phase 6 ok: lad-ts, B={p.num_bs} N_max={p.max_tasks} "
        f"slots={p.num_slots} I={cfg.diffusion.num_steps} "
        f"K={cfg.batch_size} |R|={cfg.replay_capacity} "
        f"train_after={cfg.train_after}: avg delay {delays[0]:.4f} s; "
        f"{wall:.1f} s per episode, {wall / steps * 1e3:.2f} ms per task "
        f"step; ladn_denoise launches {launches} = 3 x {steps}; updates per "
        f"agent {states.steps.min().item()}..{states.steps.max().item()}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return p, cfg, f, states, launches


def phase_task_step_breakdown(p, cfg, f, states, slots: int = 1) -> None:
    """Where a training task step's time goes, with every agent updating:
    ``slots`` x N_max task steps from the trained states; host enqueue
    (until the episode returns), wall time to its result, and device time
    by kernel from ``torch.profiler``."""
    import dataclasses as dc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import env as envlib
    from repro_torch.core.trainer import build_episode_fn
    dev = torch.device("cuda")
    q = dc.replace(p, num_slots=slots)
    steps = q.num_slots * q.max_tasks
    episode = build_episode_fn("lad-ts", q, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    ep = envlib.sample_episode(gen, q, f=f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, avg = episode(states, ep, gen)
    t1 = time.perf_counter()
    float(avg)
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, avg = episode(states, ep, gen)
        float(avg)
    by_kernel = _by_kernel(prof)
    enqueue_ms = (t1 - t0) * 1e3 / steps
    wall_ms = (t2 - t0) * 1e3 / steps
    busy_ms = sum(by_kernel.values()) / 1e3 / steps
    ladn_ms = sum(v for k, v in by_kernel.items()
                  if "ladn_regs_kernel" in k or "ladn_smem_kernel" in k
                  ) / 1e3 / steps
    busy = (f"device busy {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.3f}), ladn_denoise {ladn_ms:.4f} ms "
            f"of it" if by_kernel else
            "device busy not measured (the profiler saw no device time)")
    log(f"phase 6b: training task step (B={q.num_bs}, every agent "
        f"updating, mean of {steps}): enqueue {enqueue_ms:.2f} ms, wall "
        f"{wall_ms:.2f} ms, {busy}; {len(by_kernel)} kernel names")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {us / 1e3 / steps:8.4f} ms/step  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 7: simulator evaluation
# ---------------------------------------------------------------------------


def phase_sim_eval(p, cfg, f, states) -> int:
    import torch
    from repro_torch.cluster.schedulers import PolicyScheduler
    from repro_torch.cluster.simulate import evaluate_scheduler
    from repro_torch.core.trainer import evaluate_method
    from repro_torch.kernels import ops
    sched = PolicyScheduler("lad-ts", cfg, states, num_engines=p.num_bs,
                            n_max=p.max_tasks)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = evaluate_scheduler(sched, p, 1, seed=3, f=f, device="cuda")
    wall = time.perf_counter() - t0
    launches = ops.launches["ladn_denoise"]
    steps = p.num_slots * p.max_tasks
    if launches != steps:
        fail(f"phase 7: the policy launched ladn_denoise {launches} times, "
             f"expected one per task step = {steps}")
    if not res["count"] or not all(
            torch.isfinite(torch.tensor(res[k])) for k in ("mean_s",
                                                           "p95_s")):
        fail(f"phase 7: policy evaluation gave {res}")
    means = {}
    for method in ("opt-ts", "random-ts", "local-ts"):
        means[method] = evaluate_method(method, p, cfg, None, seed=3,
                                        n_episodes=1, f=f, device="cuda")
    if not means["opt-ts"] < means["random-ts"]:
        fail(f"phase 7: opt-ts {means['opt-ts']:.4f} s does not beat "
             f"random-ts {means['random-ts']:.4f} s")
    log(f"phase 7 ok: lad-ts policy over {res['count']} tasks: mean "
        f"{res['mean_s']:.4f} s p95 {res['p95_s']:.4f} s ({wall:.1f} s, "
        f"{launches} ladn_denoise launches); heuristics' mean delay: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in means.items()))
    return launches


# ---------------------------------------------------------------------------
# phase 8: live LAD-TS serve
# ---------------------------------------------------------------------------


def phase_live_ladts() -> int:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = list(SERVE_ARGS)
    args[args.index("--scheduler") + 1] = "lad-ts"
    ops.reset_launches()
    t0 = time.perf_counter()
    st = serve.main(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    rounds = _check_serve(st, "phase 8")
    got = st["launches"]["ladn_denoise"]
    if got != N_REQUESTS + 1:
        fail(f"phase 8: ladn_denoise launched {got} times while serving, "
             f"expected one per placement ({N_REQUESTS}) + the warm-up")
    log(f"phase 8 ok: lad-ts served {N_REQUESTS}/{N_REQUESTS}, kv_leak "
        f"{[e['kv_leak'] for e in st['engines']]}, {rounds} decode rounds, "
        f"{st['launches']['paged_flash_decode']} decode launches, "
        f"ladn_denoise {got} = {N_REQUESTS} placements + 1 warm-up "
        f"({ops.launches['ladn_denoise']} with training); training "
        f"{st['train_s']:.2f} s; service mean={st['mean_s'] * 1e3:.1f} ms "
        f"p95={st['p95_s'] * 1e3:.1f} ms; {st['tok_s']:.1f} generated "
        f"tok/s over {st['wall_s']:.2f} s of serving ({total:.1f} s in all)")
    return got


# ---------------------------------------------------------------------------
# phase 9: flash_attention against its plain version
# ---------------------------------------------------------------------------


def ptxas_report(log: str) -> list:
    """Each kernel's registers, stack and spill bytes from an
    ``nvcc -Xptxas -v`` log, the template arguments read from the mangled
    name (``flash_attention_mma<hd, split>``, ``..._tf32<hd, split>``,
    ``ladn_regs_kernel<width>``)."""
    import re
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append({"mangled": name, "stack": int(m.group(1)),
                         "spill_stores": int(m.group(2)),
                         "spill_loads": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and "registers" not in rows[-1]:
            rows[-1]["registers"] = int(m.group(1))
    for row in rows:
        mangled = row.pop("mangled")
        base = re.search(r"([a-z_]+(?:mma|tf32|kernel))[IE]", mangled)
        args = re.findall(r"Li(\d+)E", mangled)
        row["kernel"] = (f"{base.group(1) if base else mangled}"
                         + (f"<{', '.join(args)}>" if args else ""))
    return rows


def check_attention_launch(label: str, fn, plan):
    """Trace one ``flash_attention`` call (``traced_launches``): one
    kernel, of the grid, block and shared memory ``plan`` gives (the C
    entry point derives them from the plan's split on its own).  Returns
    the traced launches (None where the trace was incomplete)."""
    import re
    launched = traced_launches(fn)
    seen = "not measured (incomplete trace)" if launched is None else [
        {"kernel": (re.findall(r"flash_attention_\w+<[^>]*>", r["kernel"])
                    or [r["kernel"][:60]])[0], "grid": r["grid"],
         "block": r["block"], "smem": r["smem"]}
        for r in launched]
    log(f"    {label}: plan {plan.rows} rows x {plan.bk}-key tiles, "
        f"{plan.stages} stage(s), {plan.blocks} blocks of {plan.threads} "
        f"threads, {plan.smem} B shared; traced launches {seen}")
    if launched is not None:
        if len(launched) != 1 or "flash_attention" not in \
                launched[0]["kernel"]:
            fail(f"{label}: one call launched {launched}, expected one "
                 f"flash_attention kernel")
        grid = launched[0]["grid"]
        if grid is not None and list(grid) != [plan.blocks, 1, 1]:
            fail(f"{label}: grid {grid}, the tile plan gives "
                 f"[{plan.blocks}, 1, 1]")
        block = launched[0]["block"]
        if block is not None and list(block) != [plan.threads, 1, 1]:
            fail(f"{label}: block {block}, the tile plan gives "
                 f"[{plan.threads}, 1, 1]")
        smem = launched[0]["smem"]
        if smem is not None and smem != plan.smem:
            fail(f"{label}: {smem} B of shared memory, the tile plan gives "
                 f"{plan.smem}")
    return None if launched is None else seen


# flash_attention's error in each query row, max |got - want| over the
# row's RMS of want: a causal output's scale falls as 1 / sqrt(position)
# (about 0.009 at 32k keys), so an absolute limit alone would pass a
# wrong late row.  The limit lies between the sound kernel's largest
# reading (bf16: an ulp of a row's largest entries, about 0.035 at 32k
# keys) and a planted fault's (0.8 or more), on the H100
LATE_ROWS = 1024
ROW_TOL = {"bfloat16": 1e-1, "float32": 1e-4}


def row_rel_err(got, want) -> float:
    """The largest, over every (batch, head, query) row, of max |got -
    want| over the RMS of want in that row."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((g - w).abs().amax(-1) / rms).max().item()


def planted_fault(q, k, v, want, win, off, bk):
    """(what, its ``row_rel_err`` against ``want``) for the plain version
    with one key tile of ``bk`` keys wrong in the last ``LATE_ROWS``
    rows, the rows whose outputs are smallest: the far tile (keys
    [0, bk)) dropped from a causal mask, the window one tile short
    (``win - bk``) from a windowed one.  None where the fault would
    change no late row or leave one with no key."""
    Sq, Skv = q.shape[2], k.shape[2]
    n = min(LATE_ROWS, Sq)
    late = off + Sq - n                   # the first late row's position
    if win is None:
        if late < bk or Skv <= bk:
            return None
        what = f"far {bk}-key tile dropped"
        bad = attention_plain(q[:, :, -n:], k[:, :, bk:], v[:, :, bk:],
                              None, late - bk)
    else:
        if win <= bk or attn_pairs(n, Skv, win - bk, late) == \
                attn_pairs(n, Skv, win, late):
            return None
        what = f"window {win} one {bk}-key tile short"
        bad = attention_plain(q[:, :, -n:], k, v, win - bk, late)
    return what, row_rel_err(bad, want[:, :, -n:])


def attention_row(name: str, spec) -> dict:
    """``flash_attention`` at ``spec`` (an ``ATTN_SHAPES``-style tuple)
    against its plain version (``TOL``, and ``ROW_TOL`` in each query
    row, a limit that a planted fault must pass) and SDPA, one traced
    launch with ``tile_plan``'s grid, and its device time beside the
    plain version's, SDPA's and the bound."""
    import torch
    from repro_torch.kernels import flash_attention
    B, Hq, KVh, Sq, Skv, hd, win, off, dt = spec
    dtype = getattr(torch, dt)
    q, k, v = attention_case(spec)
    got = flash_attention.flash_attention(q, k, v, window=win, q_offset=off)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, win, off)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL[dt]:
        fail(f"flash_attention {name}: max abs err {err:.3e} > "
             f"{TOL[dt]:.0e}")
    plan = flash_attention.tile_plan(B, Hq, KVh, Sq, Skv, hd, dtype, win,
                                     off)
    n = min(LATE_ROWS, Sq)
    rel = row_rel_err(got, want)
    rel_late = row_rel_err(got[:, :, -n:], want[:, :, -n:])
    fault = planted_fault(q, k, v, want, win, off, plan.bk)
    if not rel <= ROW_TOL[dt]:
        fail(f"flash_attention {name}: a query row's max err over its RMS "
             f"{rel:.3e} > {ROW_TOL[dt]:.0e}")
    if fault is not None and not fault[1] > ROW_TOL[dt]:
        fail(f"flash_attention {name}: the plain version with the "
             f"{fault[0]} reads {fault[1]:.3e} <= {ROW_TOL[dt]:.0e}: the "
             f"row check would pass it")
    kw = attention_timing(Sq, Skv)

    def kernel():
        return flash_attention.flash_attention(q, k, v, window=win,
                                               q_offset=off)

    launched = check_attention_launch(f"flash_attention {name}", kernel,
                                      plan)
    ms = time_ms(kernel, **kw)
    call_ms = eager_ms(kernel, iters=20 if kw else 200)
    plain_ms = time_ms(lambda: attention_plain(q, k, v, win, off), **kw)
    library = attention_library(q, k, v, win, off)
    lib_out = library()
    lib_err = (lib_out.float() - want.float()).abs().max().item()
    library_ms = time_ms(library, **kw)
    pairs = attn_pairs(Sq, Skv, win, off)
    size = q.element_size()
    nbytes = size * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * B * Hq * hd * pairs
    bound_ms, bound_by = attention_bound(nbytes, flops, dt)
    row = {
        "shape": dict(B=B, H=Hq, KV=KVh, Sq=Sq, Skv=Skv, hd=hd,
                      window=win, q_offset=off, dtype=dt),
        "max_abs_err": err, "row_rel_err": rel,
        "row_rel_err_late": rel_late,
        "fault": None if fault is None else {"what": fault[0],
                                             "row_rel_err": fault[1]},
        "ms": ms, "eager_ms": call_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_err": lib_err, "bound_ms": bound_ms,
        "bound_by": bound_by, "launched": launched}
    if dt == "float32":     # the same work at the CUDA cores' f32 rate
        row["bound_ms_cuda_cores"] = bound(nbytes, flops, dt)[0]
    planted = ("no planted fault applies" if fault is None else
               f"{fault[0]}: {fault[1]:.3e}")
    log(f"  flash_attention {name} {dt}: err={err:.3e} (tol "
        f"{TOL[dt]:.0e}); row err / row RMS {rel:.3e}, last {n} rows "
        f"{rel_late:.3e} (tol {ROW_TOL[dt]:.0e}; {planted}) "
        f"kernel={ms:.4f} ms (eager call {call_ms:.4f}"
        f" ms) plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms (err "
        f"{lib_err:.2e}) bound={bound_ms:.6f} ms ({bound_by})")
    del q, k, v, got, want, lib_out, library
    torch.cuda.empty_cache()
    return row


def phase_flash_attention() -> dict:
    from repro_torch.kernels import build
    info = build.build_info["flash_attention"]
    ptxas = ptxas_report(info.get("ptxas", ""))
    for row in ptxas:
        log(f"  ptxas {row['kernel']}: {row.get('registers')} registers, "
            f"{row['stack']} B stack, spills {row['spill_stores']} B stored"
            f" / {row['spill_loads']} B loaded"
            f"{' (a cached build)' if info['cached'] else ''}")
    # the f32 kernel keeps a warp's 16 x hd output in registers beside its
    # tf32 fragments: every instantiation must be there, none spilling
    tf32 = {r["kernel"]: r for r in ptxas if "tf32" in r["kernel"]}
    want = {f"flash_attention_tf32<{hd}, {s}>" for hd in (64, 128, 256)
            for s in (1, 4)}
    if ptxas and set(tf32) != want:
        fail(f"phase 9: ptxas reports f32 kernels {sorted(tf32)}, expected "
             f"{sorted(want)}")
    spilled = [k for k, r in tf32.items()
               if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        fail(f"phase 9: {spilled} spill registers")
    # only this run's compiler report goes into the kernels line
    result = {} if info["cached"] else {"ptxas": ptxas}
    for name, spec in ATTN_SHAPES.items():
        result[name] = attention_row(name, spec)
    log(f"phase 9 ok: flash_attention matches its plain version at "
        f"{', '.join(ATTN_SHAPES)}")
    return result


# ---------------------------------------------------------------------------
# phase 10: flash_decode against its plain version
# ---------------------------------------------------------------------------


def phase_flash_decode() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    dev = torch.device("cuda")
    result = {}
    for name, (Bs, Hq, KVh, W_, hd, lens, dt) in DECODE_SHAPES.items():
        q, k, v, lengths = flash_decode_case(DECODE_SHAPES[name])
        got = decode_attention.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        want = ref.decode_ref(q, k, v, lengths)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[dt]:
            fail(f"flash_decode {name}: max abs err {err:.3e} > "
                 f"{TOL[dt]:.0e}")
        z = decode_attention.flash_decode(q, k, v, torch.zeros_like(lengths))
        if z.abs().max().item() != 0.0:
            fail(f"flash_decode {name}: length-0 lanes not zero")

        def kernel():
            return decode_attention.flash_decode(q, k, v, lengths)

        launched = check_split_launches(f"flash_decode {name}", kernel, Bs,
                                        Hq, KVh, W_, decode_attention.TILE)
        ms = time_ms(kernel)
        call_ms = eager_ms(kernel)
        plain_ms = time_ms(lambda: ref.decode_ref(q, k, v, lengths))
        mask = (torch.arange(W_, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sq = q[:, :, None, :]
        lib_out = F.scaled_dot_product_attention(sq, k, v, attn_mask=mask,
                                                 enable_gqa=True)[:, :, 0]
        lib_err = (lib_out.float() - want.float()).abs().max().item()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, k, v, attn_mask=mask, enable_gqa=True))
        ctx = sum(min(n, W_) for n in lens)
        size = q.element_size()
        nbytes = (2 * q.numel() * size + 2 * ctx * KVh * hd * size
                  + 4 * Bs)
        bound_ms, bound_by = bound(nbytes, 4 * ctx * Hq * hd, dt)
        result[name] = {
            "shape": dict(B=Bs, H=Hq, KV=KVh, W=W_, hd=hd, lengths=list(lens),
                          dtype=dt),
            "max_abs_err": err, "ms": ms, "eager_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "launched": launched,
            "kernel_launches_per_call": (None if launched is None
                                         else len(launched))}
        log(f"  flash_decode {name} {dt}: err={err:.3e} (tol "
            f"{TOL[dt]:.0e}) kernel={ms:.4f} ms (eager call {call_ms:.4f}"
            f" ms) plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms (err "
            f"{lib_err:.2e}) bound={bound_ms:.6f} ms ({bound_by})")
    log(f"phase 10 ok: flash_decode matches decode_ref at "
        f"{', '.join(DECODE_SHAPES)}")
    return result


# ---------------------------------------------------------------------------
# phase 11: dense decode across the window wrap against teacher forcing
# ---------------------------------------------------------------------------


def phase_dense_decode_vs_forward() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (apply_head, forward,
                                                init_params)
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(RG), num_layers=3, dtype="float32")
    if [b.mixer for b in cfg.layer_pattern()] != ["rglru", "rglru", "attn"]:
        fail(f"phase 11: unexpected layers {cfg.layer_pattern()}")
    window = cfg.layer_pattern()[2].window
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(11),
                         dev)
    plen, n_new = window - 8, 16
    eng = ServeEngine(cfg, params, max_len=plen + n_new, kv_slots=1,
                      device=dev)
    if eng.paged:
        fail("phase 11: recurrentgemma-9b did not get a dense engine")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                                (1, plen), dtype=np.int32)
    ops.reset_launches()
    toks = np.concatenate(eng.generate(prompt, n_new).tokens)
    launches = dict(ops.launches)
    if eng.kv_leak:
        fail(f"phase 11: the engine holds {eng.kv_leak} slots when idle")
    seq = np.concatenate([prompt[0], toks[:-1]]).astype(np.int32)
    hidden = forward(params, cfg, {"tokens": torch.from_numpy(seq[None])
                                   .to(dev)}, mode="train")["hidden"]
    logits = apply_head(params, cfg, hidden[:, plen - 1:])[0].float()
    if not torch.isfinite(logits).all():
        fail("phase 11: teacher-forced logits are not finite")
    pred = logits.argmax(-1).cpu().numpy()
    for i in np.flatnonzero(pred != toks):
        top2 = torch.topk(logits[i], 2).values
        fail(f"phase 11: decode token {i} (position {plen + i}) = "
             f"{toks[i]} but the teacher-forced argmax = {pred[i]} (top-2 "
             f"logit gap {(top2[0] - top2[1]).item():.3e})")
    if launches["flash_decode"] != n_new - 1 or \
            launches["flash_attention"] != 1:
        fail(f"phase 11: launches {launches}, expected flash_attention 1 "
             f"(one prefill, one attention layer) and flash_decode "
             f"{n_new - 1}")
    log(f"phase 11 ok: {n_new} greedy decode tokens from a {plen}-token "
        f"prompt (positions {plen}..{plen + n_new - 1} cross the "
        f"{window}-token window, so the ring wraps) equal the "
        f"teacher-forced train-mode argmax (full width, 3 layers, f32); "
        f"launches {launches}")
    del eng, params, hidden, logits


# ---------------------------------------------------------------------------
# phase 12: serve full-width recurrentgemma-9b from dense slot pools
# ---------------------------------------------------------------------------


def phase_dense_serve(label: str, arch: str, argv: list):
    """``serve.main(argv)`` on full-depth dense engines of ``arch``: every
    request completed, no slot held, ``flash_decode`` once per attention
    layer per decode round and ``flash_attention`` once per attention
    layer per prefill, after the warm-up and with it.  Returns
    (flash_attention, flash_decode) launches with the warm-up, and the
    summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config(arch)
    n_attn = sum(b.mixer == "attn" for b in cfg.layer_pattern())
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = serve.main(argv)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    engines = st["engines"]
    if st["completed"] != N_REQUESTS or st["count"] != N_REQUESTS:
        fail(f"{label}: {st['completed']} of {N_REQUESTS} requests "
             f"completed")
    if any(e["kv_leak"] for e in engines):
        fail(f"{label}: slots held after serving: {engines}")
    if any(e["layers"] != cfg.num_layers or e["paged"] for e in engines):
        fail(f"{label}: engines are not full-depth dense engines: "
             f"{engines}")
    rounds = sum(e["decode_rounds"] for e in engines)
    prefills = sum(e["prefills"] for e in engines)
    got = st["launches"]
    if rounds == 0 or got["flash_decode"] != n_attn * rounds:
        fail(f"{label}: flash_decode launched {got['flash_decode']} times "
             f"after warm-up, expected {n_attn} x {rounds} decode rounds")
    if prefills != N_REQUESTS or \
            got["flash_attention"] != n_attn * prefills:
        fail(f"{label}: flash_attention launched {got['flash_attention']}"
             f" times over {prefills} prefills after warm-up, expected "
             f"{n_attn} per prefill")
    # the warm-up runs one prefill and one decode round per engine
    warm = len(engines)
    total_attn = ops.launches["flash_attention"]
    total_dec = ops.launches["flash_decode"]
    if total_attn != n_attn * (prefills + warm) or \
            total_dec != n_attn * (rounds + warm):
        fail(f"{label}: with warm-up flash_attention {total_attn} and "
             f"flash_decode {total_dec}, expected {n_attn} x "
             f"{prefills + warm} and {n_attn} x {rounds + warm}")
    log(f"{label} ok: {arch}: {N_REQUESTS}/{N_REQUESTS} completed on "
        f"{len(engines)} dense {cfg.num_layers}-layer bf16 engines, kv_leak "
        f"{[e['kv_leak'] for e in engines]}; flash_decode {total_dec} = "
        f"{n_attn} x ({rounds} decode rounds + {warm} warm-up), "
        f"flash_attention {total_attn} = {n_attn} x ({prefills} prefills + "
        f"{warm} warm-up); service mean={st['mean_s'] * 1e3:.1f} ms "
        f"p95={st['p95_s'] * 1e3:.1f} ms; {st['tok_s']:.1f} generated "
        f"tok/s over {st['wall_s']:.2f} s of serving ({total:.1f} s with "
        f"weights and warm-up); decode ms/token per engine "
        f"{[round(e['token_ms'], 3) for e in engines]}; peak memory "
        f"{peak:.2f} GiB")
    return total_attn, total_dec, st


def phase_dense_round_breakdown(label: str, arch: str, prompt_len: int,
                                rounds: int = 4) -> None:
    """Where a full-scale dense decode round's time goes: one full-depth
    bf16 engine of ``arch`` with its 4 slots decoding; host enqueue time
    of ``dispatch``, wall time to results, and device time by kernel from
    ``torch.profiler`` over ``rounds`` rounds.  Also the host time of one
    ``prompt_len``-token prefill and its device time.  With an int8 cache,
    the share of the round that dequantising the rings takes: one call of
    ``attention._dequantize_kv`` at the round's ring shape, CUDA-graph
    timed, times two per attention layer."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.request import Request
    from repro_torch.models import attention
    from repro_torch.serving import compiled
    from repro_torch.serving.builders import build_engines
    eng = build_engines(arch, 1, prompt_len + 32, device="cuda",
                        full_scale=True)[0]
    cfg = eng.cfg
    shape = ((1, cfg.num_codebooks, prompt_len) if cfg.num_codebooks
             else (1, prompt_len))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
               for _ in range(eng.kv_slots + 1)]
    eng.generate(prompts[-1], 2)           # warm the libraries
    eng.reset()
    prefill = compiled.prefill_step(cfg, eng.max_len)
    tokens = torch.from_numpy(prompts[0]).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(eng.params, {"tokens": tokens})
    t1 = time.perf_counter()
    float(logits.flatten()[0])
    t2 = time.perf_counter()
    n_attn = sum(b.mixer == "attn" for b in cfg.layer_pattern())
    _profile_prefill(lambda: prefill(eng.params, {"tokens": tokens}),
                     n_attn, f"{label}: dense prefill ({prompt_len} "
                     f"tokens, {cfg.num_layers} layers)")
    for rid in range(eng.kv_slots):
        eng.admit(Request(rid=rid, max_new_tokens=32, prompt=prompts[rid]))
    for _ in range(3):               # admission and prefills, warm rounds
        eng.step()
    torch.cuda.synchronize()

    def timed_round():
        t0 = time.perf_counter()
        eng.dispatch()
        t1 = time.perf_counter()
        eng.collect()
        return t1 - t0, time.perf_counter() - t0

    host = [timed_round() for _ in range(rounds)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    enqueue_ms = 1e3 * sum(h[0] for h in host) / rounds
    wall_ms = 1e3 * sum(h[1] for h in host) / rounds
    busy_ms = sum(by_kernel.values()) / 1e3 / rounds
    attn_ms, attn_parts = _kernel_share(by_kernel, "flash_decode", rounds)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    busy = (f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.2f}), flash_decode {attn_ms:.3f} ms "
            f"of it, a share of {attn_ms / busy_ms:.3f} ({attn_parts})"
            if by_kernel else
            "device busy not measured (the profiler saw no device time)")
    if cfg.kv_cache_dtype == "int8":
        ring = eng._pool_states[0]
        one_ms = time_ms(lambda: attention._dequantize_kv(
            ring["k"], ring["k_scale"], torch.float32))
        deq_ms = 2 * n_attn * one_ms
        busy += (f"; dequantising the int8 rings {deq_ms:.3f} ms a round "
                 f"(2 x {n_attn} calls of {one_ms:.4f} ms at "
                 f"{tuple(ring['k'].shape)}, CUDA-graph timed)"
                 + (f", a share of {deq_ms / busy_ms:.3f}" if by_kernel
                    else ""))
    log(f"{label}: dense decode round ({arch}, {eng.kv_slots} slots, "
        f"{cfg.num_layers} layers, bf16): enqueue {enqueue_ms:.2f} ms, "
        f"wall {wall_ms:.2f} ms, {busy}; one {prompt_len}-token prefill: "
        f"{(t1 - t0) * 1e3:.1f} ms to enqueue, {(t2 - t0) * 1e3:.1f} ms "
        f"to its logits")
    for name, us in top:
        log(f"  device {us / 1e3 / rounds:8.3f} ms/round  {name[:90]}")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the closed loop on the published-width heterogeneous fleet
# ---------------------------------------------------------------------------

CL_REQUESTS = 24
CL_SCHEDULERS = {"lad-ts", "deadline", "prefix-affinity", "jsq",
                 "round-robin", "random", "local"}
# published depths of the fleet's archs
CL_DEPTHS = {"qwen2-1.5b": 28, "starcoder2-3b": 30, XLSTM: 24}


def _closed_loop_launches(rec: dict) -> dict:
    """The launches a live run implies: per paged (all-attention) engine,
    its layers x its decode rounds and x its prefill chunks; one
    ``ladn_denoise`` per LAD-TS placement plus the cluster's warm-up."""
    paged = [e for e in rec["engines"] if e["paged"]]
    return {"paged_flash_decode": sum(e["layers"] * e["decode_rounds"]
                                      for e in paged),
            "flash_attention": sum(e["layers"] * e["prefills"]
                                   for e in paged),
            "ladn_denoise": (CL_REQUESTS + 1 if rec["scheduler"] == "lad-ts"
                             else 0),
            "flash_decode": 0, "flash_decode_partials": 0, "decode_merge": 0,
            "paged_flash_decode_partials": 0, "paged_flash_decode_window": 0}


def phase_closed_loop() -> dict:
    """Returns each kernel's launches summed over the live runs."""
    import math
    import torch
    from repro_torch.bench.serving import bench_closed_loop
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    _, records = bench_closed_loop(num_requests=CL_REQUESTS, device="cuda",
                                   full_scale=True,
                                   log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launched = dict(ops.launches)
    sim = [r for r in records if r["bench"] == "closedloop_sim"]
    live = [r for r in records if r["bench"] == "closedloop_live"]
    if {r["scheduler"] for r in live} != CL_SCHEDULERS or \
            {r["scheduler"] for r in sim} != CL_SCHEDULERS - {
                "prefix-affinity"}:
        fail(f"phase 13: schedulers sim {[r['scheduler'] for r in sim]}, "
             f"live {[r['scheduler'] for r in live]}")
    for r in sim:
        if not r["count"] or not math.isfinite(r["mean_s"]):
            fail(f"phase 13: sim {r['scheduler']} gave {r}")
    sums = dict.fromkeys(ops.launches, 0)
    for r in live:
        name = r["scheduler"]
        depths = {e["arch"]: e["layers"] for e in r["engines"]}
        if depths != CL_DEPTHS or [e["paged"] for e in r["engines"]] != [
                e["arch"] != XLSTM for e in r["engines"]]:
            fail(f"phase 13: {name}: the fleet is not at published depth "
                 f"or not on the expected pools: {r['engines']}")
        if not (r["completed"] == r["count"] == CL_REQUESTS
                and r["unfinished"] == 0):
            fail(f"phase 13: {name}: {r['completed']} of {CL_REQUESTS} "
                 f"requests finished ok ({r['unfinished']} unfinished)")
        if any(e["kv_leak"] for e in r["engines"]):
            fail(f"phase 13: {name}: KV held after the run: "
                 f"{[e['kv_leak'] for e in r['engines']]}")
        want = _closed_loop_launches(r)
        if r["launches"] != want:
            fail(f"phase 13: {name}: launches {r['launches']}, the loop "
                 f"implies {want} (engines {r['engines']})")
        for k, v in r["launches"].items():
            sums[k] += v
        log(f"  live {name}: service mean {r['mean_s'] * 1e3:.1f} / p50 "
            f"{r['p50_s'] * 1e3:.1f} / p95 {r['p95_s'] * 1e3:.1f} / p99 "
            f"{r['p99_s'] * 1e3:.1f} ms; deadline miss "
            f"{r['deadline_miss_rate']:.3f}, weighted goodput "
            f"{r['weighted_goodput']:.3f}; prefill tokens saved "
            f"{r['prefill_tokens_saved']}, hit rate "
            f"{r['prefix_hit_rate']:.3f}; wall {r['wall_s']:.2f} s, "
            f"{r['tok_s']:.1f} generated tok/s; peak memory "
            f"{r['peak_mem_gib']:.2f} GiB; requests per engine "
            f"{[e['requests'] for e in r['engines']]}, decode ms/token "
            f"{[round(e['token_ms'], 2) for e in r['engines']]}; launches "
            f"{r['launches']}")
    for r in sim:
        log(f"  sim {r['scheduler']}: delay mean {r['mean_s']:.4f} s p95 "
            f"{r['p95_s']:.4f} s; deadline miss "
            f"{r.get('deadline_miss_rate', 0.0):.3f}, weighted goodput "
            f"{r.get('weighted_goodput', 0.0):.3f}; {r['wall_s']:.2f} s")
    for k in ("paged_flash_decode", "flash_attention", "ladn_denoise"):
        if sums[k] <= 0 or launched[k] < sums[k]:
            fail(f"phase 13: {k} launched {sums[k]} times in the live "
                 f"runs, {launched[k]} in the phase")
    log(f"phase 13 ok: {len(live)} schedulers x {CL_REQUESTS}/"
        f"{CL_REQUESTS} requests ok on the published-width fleet, no KV "
        f"leak; live launches {sums} as the loop implies ({launched} with "
        f"training, the sim half and warm-up); {total:.1f} s")
    return sums


# ---------------------------------------------------------------------------
# phase 14: the multimodal paths and the RG-LRU prefix scan on the card
# ---------------------------------------------------------------------------

LLAVA = "llava-next-mistral-7b"
MUSICGEN = "musicgen-large"
INT8_REL = 0.05      # tests/test_perf_features.py::test_int8_cache_close_to_bf16
ASSOC_TOL = 1e-4


def _teacher_forced(label, cfg, params, eng, prompt, n_new, patches=None):
    """``eng`` decodes ``n_new`` greedy tokens after ``prompt``; the
    ``train``-mode forward over [patches | prompt | generated] must pick
    the same token (every codebook) at every position.  Returns the
    launches of the engine's run and the tokens (n_new,) or (n_new, K)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import apply_head, forward
    dev = torch.device("cuda")
    ops.reset_launches()
    toks = np.concatenate(eng.generate(prompt, n_new,
                                       patches=patches).tokens)
    launches = dict(ops.launches)
    if eng.kv_leak:
        fail(f"{label}: the engine holds {eng.kv_leak} slots when idle")
    seq = np.concatenate([prompt[0], toks[:-1].T], axis=-1).astype(np.int32)
    inputs = {"tokens": torch.from_numpy(seq[None]).to(dev)}
    if patches is not None:
        inputs["patches"] = patches
    hidden = forward(params, cfg, inputs, mode="train")["hidden"]
    start = cfg.vision_patches + prompt.shape[-1] - 1
    logits = apply_head(params, cfg, hidden[:, start:])[0].float()
    if not torch.isfinite(logits).all():
        fail(f"{label}: teacher-forced logits are not finite")
    pred = logits.argmax(-1).cpu().numpy()
    for i in np.unique(np.argwhere(pred != toks)[:, 0]):
        top2 = torch.topk(logits[i], 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).min().item()
        fail(f"{label}: decode step {i} gave {toks[i]} but the teacher-"
             f"forced argmax is {pred[i]} (least top-2 logit gap "
             f"{gap:.3e})")
    return launches, toks


def phase_multimodal_decode_vs_forward() -> dict:
    """llava-next-mistral-7b (576 patches, 64-token prompt) and
    musicgen-large (model-dtype cache; 4 codebooks, sinusoidal positions)
    at published width, 2 layers, f32: 16 greedy tokens from the dense
    slot pool equal teacher forcing.  musicgen's int8 cache: decode logits
    over the same tokens within ``INT8_REL`` of the model-dtype cache's.
    recurrentgemma-9b at phase 11's size: the prefill's last logits with
    ``use_assoc_scan`` within ``ASSOC_TOL`` of the loop's.  Returns the
    launches of each engine run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    plen, n_new, layers = 64, 16, 2
    out = {}
    # llava: patches in front of the prompt
    cfg = dataclasses.replace(get_config(LLAVA), num_layers=layers,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(14)
    params = init_params(cfg, gen, dev)
    P = cfg.vision_patches
    eng = ServeEngine(cfg, params, max_len=P + plen + n_new, kv_slots=1,
                      device=dev)
    if eng.paged:
        fail("phase 14: llava-next-mistral-7b did not get a dense engine")
    prompt = np.random.default_rng(14).integers(0, cfg.vocab_size,
                                                (1, plen), dtype=np.int32)
    patches = torch.randn((1, P, cfg.vision_dim), generator=gen, device=dev)
    launches, _ = _teacher_forced("phase 14 llava", cfg, params, eng,
                                  prompt, n_new, patches)
    want = {"flash_attention": layers, "flash_decode": layers * (n_new - 1)}
    if {k: launches[k] for k in want} != want:
        fail(f"phase 14 llava: launches {launches}, expected {want}")
    out[LLAVA] = launches
    log(f"  phase 14 llava: {n_new} greedy tokens after {P} patches and a "
        f"{plen}-token prompt equal the teacher-forced argmax (d "
        f"{cfg.d_model}, {layers} layers, f32); launches {launches}")
    del eng, params, patches
    _free_card()
    # musicgen: 4 codebooks and sinusoidal positions, model-dtype cache
    cfg = dataclasses.replace(get_config(MUSICGEN), num_layers=layers,
                              dtype="float32", kv_cache_dtype="model")
    K = cfg.num_codebooks
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(15),
                         dev)
    eng = ServeEngine(cfg, params, max_len=plen + n_new, kv_slots=1,
                      paged=False, device=dev)
    prompt = np.random.default_rng(15).integers(0, cfg.vocab_size,
                                                (1, K, plen), dtype=np.int32)
    launches, toks = _teacher_forced("phase 14 musicgen", cfg, params, eng,
                                     prompt, n_new)
    if {k: launches[k] for k in want} != want:
        fail(f"phase 14 musicgen: launches {launches}, expected {want}")
    out[MUSICGEN] = launches
    # the int8 cache over the same tokens against the model-dtype logits
    seq = np.concatenate([prompt[0], toks[:-1].T], axis=-1).astype(np.int32)
    seq = torch.from_numpy(seq[None]).to(dev)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ops.reset_launches()
    ref_out = forward(params, cfg, {"tokens": seq[..., :plen]},
                      mode="prefill", max_len=plen + n_new)
    q_out = forward(params, cfg8, {"tokens": seq[..., :plen]},
                    mode="prefill", max_len=plen + n_new)
    if q_out["states"][0]["k"].dtype != torch.int8:
        fail("phase 14 musicgen: the int8 config did not build int8 rings")
    ref_st, q_st = ref_out["states"], q_out["states"]
    rel = []
    for j in range(plen, plen + n_new - 1):
        step = {"tokens": seq[..., j:j + 1]}
        ref_out = forward(params, cfg, step, mode="decode", states=ref_st)
        q_out = forward(params, cfg8, step, mode="decode", states=q_st)
        ref_st, q_st = ref_out["states"], q_out["states"]
        a, b = ref_out["logits"].float(), q_out["logits"].float()
        if not torch.isfinite(b).all():
            fail(f"phase 14 musicgen int8: decode logits at {j} not finite")
        rel.append((a - b).abs().max().item() / a.abs().max().item())
    if not max(rel) < INT8_REL:
        fail(f"phase 14 musicgen int8: decode logits {max(rel):.3e} "
             f"(relative) from the model-dtype cache's, bound {INT8_REL}")
    q_launches = dict(ops.launches)
    out[MUSICGEN + "_int8"] = q_launches
    log(f"  phase 14 musicgen: {n_new} greedy tokens x {K} codebooks after "
        f"a {plen}-token prompt equal the teacher-forced argmax (d "
        f"{cfg.d_model}, {layers} layers, f32, model-dtype cache); "
        f"launches {launches}; int8 cache: {n_new - 1} decode steps' "
        f"logits within {max(rel):.3e} (relative, bound {INT8_REL}) of the "
        f"model-dtype cache's; launches of both runs {q_launches}")
    del eng, params, ref_st, q_st
    _free_card()
    # RG-LRU: the log-depth prefix scan against the loop, phase 11's size
    cfg = dataclasses.replace(get_config(RG), num_layers=3, dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(11),
                         dev)
    S = cfg.layer_pattern()[2].window - 8
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, S), dtype=np.int32)).to(dev)
    times, logits = {}, {}
    for assoc in (False, True):
        c = dataclasses.replace(cfg, use_assoc_scan=assoc)
        forward(params, c, {"tokens": toks}, mode="prefill")   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[assoc] = forward(params, c, {"tokens": toks},
                                mode="prefill")["last_logits"].float()
        torch.cuda.synchronize()
        times[assoc] = (time.perf_counter() - t0) * 1e3
    err = (logits[True] - logits[False]).abs().max().item()
    if not (torch.isfinite(logits[True]).all() and err <= ASSOC_TOL):
        fail(f"phase 14 rg-lru: use_assoc_scan's last logits {err:.3e} from "
             f"the loop's, tolerance {ASSOC_TOL}")
    log(f"  phase 14 rg-lru: {S}-token prefill (3 layers, f32) with "
        f"use_assoc_scan: last logits within {err:.3e} of the loop's (tol "
        f"{ASSOC_TOL}); prefill wall {times[True]:.1f} ms against the "
        f"loop's {times[False]:.1f} ms")
    del params
    log("phase 14 ok: llava and musicgen decode equal teacher forcing, "
        "the int8 bound holds, the prefix scan matches the loop")
    return out


# ---------------------------------------------------------------------------
# phase 15: serve full-width llava-next-mistral-7b and musicgen-large
# ---------------------------------------------------------------------------


def _mm_serve_args(arch: str, prompt_len: int) -> list:
    return ["--arch", arch, "--full-scale", "--edges", "2", "--scheduler",
            "jsq", "--requests", str(N_REQUESTS), "--prompt-len",
            str(prompt_len), "--tokens", "32", "--rate", "8", "--kv-slots",
            "4", "--device", "cuda"]


def _free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: crash invariants on the card
# ---------------------------------------------------------------------------

CRASH_PLEN, CRASH_NEW = 64, 12
# steps after a retry before the mid-decode crash: the paged engine's four
# 16-token chunks, then decode rounds (the dense engine prefills at once)
CRASH_DECODE_STEPS = 6


class _ManualClock:
    """An engine clock the phase sets; reading it does not advance it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _crash_drill(label: str, cfg, params, n_attn: int, **engine_kw):
    """Crash drill on one engine (see ``phase_crash_drill``); returns its
    kernel launches."""
    import numpy as np
    import torch
    from repro_torch.cluster.request import Request
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    clock = _ManualClock()
    eng = ServeEngine(cfg, params, clock=clock, device=dev, **engine_kw)
    rng = np.random.default_rng(16)
    # four prompts sharing their first 3/4
    prompts = rng.integers(0, cfg.vocab_size, (4, CRASH_PLEN), dtype=np.int32)
    prompts[:, :3 * CRASH_PLEN // 4] = prompts[0, :3 * CRASH_PLEN // 4]

    def requests():
        return [Request(rid=i, prompt=prompts[i:i + 1],
                        max_new_tokens=CRASH_NEW) for i in range(4)]

    clean = requests()
    for r in clean:
        eng.admit(r)
    eng.run_to_completion()
    eng.reset()                     # raises on a page leak
    torch.cuda.synchronize()
    ops.reset_launches()
    live = requests()
    for r in live:
        eng.admit(r)
    notes = []
    for when, steps in (("mid-prefill", 0),
                        ("mid-decode", CRASH_DECODE_STEPS)):
        for _ in range(steps):
            eng.step()
        if not eng.dispatch():
            fail(f"{label}: nothing to dispatch before the {when} crash")
        unfinished = sorted(r.rid for r in live if r.status != "ok")
        if eng.paged:
            lanes = [ln for ln in eng._lanes if ln is not None]
            prefilling = sum(not ln.decoding for ln in lanes)
            if (when == "mid-prefill") != (prefilling > 0):
                fail(f"{label}: {prefilling} lanes prefilling at the {when}"
                     f" crash")
        orphans = eng.fail(f"drill {when}")
        torch.cuda.synchronize()
        rids = [r.rid for r in orphans]
        if sorted(rids) != unfinished or len(set(rids)) != len(rids):
            fail(f"{label} {when}: orphans {rids}, unfinished {unfinished}")
        if eng.kv_leak:
            fail(f"{label} {when}: {eng.kv_leak} KV references held after "
                 f"the crash")
        refs = (eng._pool.total_refs, eng.prefix_cached_pages) \
            if eng.paged else None
        if refs and refs[0] != refs[1]:
            fail(f"{label} {when}: pool references {refs[0]} != prefix "
                 f"cache size {refs[1]}")
        held = f", pool refs = cached pages = {refs[0]}" if refs else ""
        notes.append(f"{when}: {len(orphans)} orphans, kv_leak 0{held}")
        eng.recover()
        for r in orphans:
            r.reset_for_retry()
            eng.admit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    for a, b in zip(clean, live):
        ta = np.stack([np.asarray(t).ravel() for t in a.tokens])
        tb = np.stack([np.asarray(t).ravel() for t in b.tokens])
        if b.status != "ok" or not np.array_equal(ta, tb):
            fail(f"{label}: request {b.rid} after two crashes gave "
                 f"{tb.ravel().tolist()} ({b.status}), the uncrashed "
                 f"engine {ta.ravel().tolist()}")
    # a stall freezes dispatch until its window ends; a slowdown of 3
    # lets one dispatch in three through until recover
    gate = Request(rid=9, prompt=prompts[:1, :16], max_new_tokens=24)
    eng.admit(gate)
    eng.degrade(stall_s=1.0)
    stalled = [eng.dispatch() for _ in range(4)]
    clock.t += 2.0
    healed = eng.dispatch()
    eng.collect()
    eng.degrade(slow_every=3)
    slowed = []
    for _ in range(9):
        slowed.append(eng.dispatch())
        eng.collect()
    eng.recover()
    eng.run_to_completion()
    torch.cuda.synchronize()
    if any(stalled) or not healed or slowed != [False, False, True] * 3:
        fail(f"{label}: dispatch gating stalled {stalled}, after the "
             f"window {healed}, slowed {slowed}")
    if gate.status != "ok" or eng.kv_leak:
        fail(f"{label}: the gated request ended {gate.status}, kv_leak "
             f"{eng.kv_leak}")
    launches = dict(ops.launches)
    attn, dec = (("flash_attention", "paged_flash_decode") if eng.paged
                 else ("flash_attention", "flash_decode"))
    want = {k: 0 for k in launches}
    want[attn] = n_attn * eng.prefills
    want[dec] = n_attn * eng.decode_rounds
    if launches != want:
        fail(f"{label}: launches {launches}, the dispatched passes imply "
             f"{want} ({eng.prefills} prefill passes, {eng.decode_rounds} "
             f"decode rounds, dropped ones included)")
    log(f"  {label}: {'; '.join(notes)}; retried tokens equal the "
        f"uncrashed engine's; gating stall {stalled} -> {healed}, slowed "
        f"{slowed}; launches {launches} = {n_attn} attention layers x "
        f"{eng.prefills} prefill passes / {eng.decode_rounds} decode rounds")
    del eng
    return launches


def phase_crash_drill() -> dict:
    """16. Crash invariants on the card, f32 at published width: qwen2-1.5b
    with 2 layers (paged, prefix cache on, page 16, chunk 16) and
    recurrentgemma-9b with 3 layers (dense, 4 slots, one local-attention
    layer), each serving 4 requests whose 64-token prompts share their
    first 48.  Per engine: a clean run; then ``fail()`` with a dispatched
    round not yet collected, once mid-prefill and once mid-decode: the
    orphans are exactly the unfinished requests, ``kv_leak == 0`` and (paged)
    the pool's references equal the prefix cache's size; after
    ``recover`` and ``reset_for_retry`` the requests drain to the clean
    run's greedy tokens; ``degrade(stall_s=)`` and
    ``degrade(slow_every=3)`` gate ``dispatch`` as the reference does; the
    launches are the dispatched passes' (dropped rounds included).
    Returns the summed launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    dev = torch.device("cuda")
    total = {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(16),
                         dev)
    got = _crash_drill("phase 16 qwen2 paged", cfg, params, 2,
                       max_len=CRASH_PLEN + CRASH_NEW, kv_slots=4,
                       page_size=16, prefill_chunk=16, prefix_cache=True)
    total = {k: total.get(k, 0) + v for k, v in got.items()}
    del params
    _free_card()
    cfg = dataclasses.replace(get_config(RG), num_layers=3, dtype="float32")
    if [b.mixer for b in cfg.layer_pattern()] != ["rglru", "rglru", "attn"]:
        fail(f"phase 16: unexpected layers {cfg.layer_pattern()}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(17),
                         dev)
    got = _crash_drill("phase 16 recurrentgemma dense", cfg, params, 1,
                       max_len=CRASH_PLEN + CRASH_NEW, kv_slots=4)
    total = {k: total.get(k, 0) + v for k, v in got.items()}
    del params
    log(f"phase 16 ok: crashes mid-prefill and mid-decode with a round "
        f"pending orphan exactly the unfinished requests and hold no KV; "
        f"retries give the uncrashed tokens; launches {total}; "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 17: serve.main under --chaos
# ---------------------------------------------------------------------------

CHAOS_REQUESTS = 16
CHAOS_SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full-scale", "--edges", "2",
                    "--scheduler", "lad-ts", "--chaos", "--fault-seed", "0",
                    "--requests", str(CHAOS_REQUESTS), "--prompt-len", "128",
                    "--tokens", "32", "--rate", "8", "--device", "cuda"]


def _terminal(st: dict, n: int, label: str) -> None:
    """Every request ended ok, failed or abandoned, none failed for want
    of retries, and nothing was quarantined."""
    ended = st["count"] + st["failed"] + st["abandoned"]
    if ended != n or st["unfinished"] or st["completion_rate"] != 1.0:
        fail(f"{label}: {st['count']} ok + {st['failed']} failed + "
             f"{st['abandoned']} abandoned of {n}, completion rate "
             f"{st['completion_rate']}")


def _paged_launches(engines: list) -> dict:
    """The launches a live run implies: per paged engine, its layers x
    its decode rounds and x its prefill chunks."""
    paged = [e for e in engines if e["paged"]]
    return {"paged_flash_decode": sum(e["layers"] * e["decode_rounds"]
                                      for e in paged),
            "flash_attention": sum(e["layers"] * e["prefills"]
                                   for e in paged),
            "ladn_denoise": 0, "flash_decode": 0,
            "flash_decode_partials": 0, "decode_merge": 0,
            "paged_flash_decode_partials": 0, "paged_flash_decode_window": 0}


def phase_chaos_serve() -> dict:
    """17. ``serve.main`` under ``--chaos`` at qwen2-1.5b's published width
    and depth (28 layers, bf16): 2 paged engines, 16 requests at 8 req/s,
    prompt 128, 32 new tokens, LAD-TS trained in the fault-enabled
    simulator (S = 6) placing on the availability observation, one crash
    and one slowdown from ``--fault-seed 0``.  Every request terminal with
    completion rate 1, the injector exhausted, nothing quarantined, no KV
    held; launches: 28 x decode rounds and x prefill chunks dispatched,
    ``ladn_denoise`` one per placement (first tries and retries) + the
    warm-up.  Returns the launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launches()
    t0 = time.perf_counter()
    st = serve.main(CHAOS_SERVE_ARGS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    fs, sched = st["fault_stats"], st["fault_schedule"]
    for ev in sched:
        log(f"  phase 17 schedule: t={ev['t_s']:.3f} s engine "
            f"{ev['engine']} {ev['kind']} duration {ev['duration_s']} "
            f"factor {ev['factor']}")
    _terminal(st, CHAOS_REQUESTS, "phase 17")
    if fs["injected"] != len(sched) or fs["quarantined"]:
        fail(f"phase 17: {fs['injected']} of {len(sched)} events fired, "
             f"{fs['quarantined']} engines quarantined")
    if [e["kv_leak"] for e in st["engines"]] != [0, 0] or \
            [e["layers"] for e in st["engines"]] != [28, 28]:
        fail(f"phase 17: engines {st['engines']}")
    want = _paged_launches(st["engines"])
    want["ladn_denoise"] = st["placements"] + 1
    if st["launches"] != want:
        fail(f"phase 17: launches {st['launches']}, the run implies {want}"
             f" ({st['placements']} placements + the warm-up)")
    if fs["orphaned"] == 0:
        log("  phase 17: the crash found its engine idle (no orphans); "
            "phase 16 is the phase that proves orphans")
    log(f"phase 17 ok: lad-ts under --chaos: {st['count']} ok, "
        f"{st['failed']} failed, {st['abandoned']} abandoned of "
        f"{CHAOS_REQUESTS}; {fs['orphaned']} orphans, {st['retries']} "
        f"retries, {st['placements']} placements; kv_leak [0, 0]; launches "
        f"{st['launches']}; service mean {st['mean_s'] * 1e3:.1f} ms p95 "
        f"{st['p95_s'] * 1e3:.1f} ms; training {st['train_s']:.2f} s, "
        f"serving {st['wall_s']:.2f} s ({total:.1f} s in all)")
    return st["launches"]


# ---------------------------------------------------------------------------
# phase 18: the chaos bench on the published-width fleet
# ---------------------------------------------------------------------------

CHAOS_DEPTHS = {"qwen2-1.5b": 28, "starcoder2-3b": 30}


def phase_chaos_bench() -> dict:
    """18. ``bench_chaos(full_scale=True)``: qwen2-1.5b and starcoder2-3b
    at published width and depth in bf16 (paged, 2 slots, chunk 8); 16
    requests at 48 req/s, prompt 16, 6 new tokens; a calibration pass,
    then one crash at 0.3 x its makespan for 0.35 x it under
    failure-aware (QoS), deadline, JSQ and round-robin.  Each run: every
    request terminal with completion rate 1, retries <= 2 x requests,
    kv_leak [0, 0], nothing quarantined, launches as the engines'
    dispatched passes imply; the simulator twin's failure-aware picks no
    DOWN station.  Returns the live runs' summed launches."""
    import torch
    from repro_torch.bench.serving import bench_chaos
    from repro_torch.faults import RetryPolicy
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    _, records = bench_chaos(device="cuda", full_scale=True,
                             log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    live = [r for r in records if r["bench"] == "chaos_live"]
    sim = {r["scheduler"]: r for r in records if r["bench"] == "chaos_sim"}
    cap = (RetryPolicy().max_attempts - 1) * 16
    sums = dict.fromkeys(ops.launches, 0)
    for r in live:
        name = r["scheduler"]
        if {e["arch"]: e["layers"] for e in r["engines"]} != CHAOS_DEPTHS:
            fail(f"phase 18: {name}: fleet {r['engines']}")
        _terminal(r, 16, f"phase 18 {name}")
        if r["retries"] > cap or r["kv_leak"] != [0, 0] or \
                r["quarantined"]:
            fail(f"phase 18: {name}: retries {r['retries']} (cap {cap}), "
                 f"kv_leak {r['kv_leak']}, quarantined {r['quarantined']}")
        want = _paged_launches(r["engines"])
        if r["launches"] != want:
            fail(f"phase 18: {name}: launches {r['launches']}, the run "
                 f"implies {want}")
        for k, v in r["launches"].items():
            sums[k] += v
        log(f"  live {name}: cr {r['completion_rate']:.3f}, "
            f"{r['completed']} ok / {r['failed']} failed / "
            f"{r['abandoned']} abandoned, {r['orphaned']} orphans, "
            f"{r['retries']} retries, orphan recovery "
            f"{r['orphan_recovery_mean_s'] * 1e3:.1f} ms, goodput "
            f"{r['goodput_rps']:.2f} req/s, weighted goodput "
            f"{r.get('weighted_goodput', 0.0):.3f}, mean service "
            f"{r['mean_s'] * 1e3:.1f} ms, wall {r['wall_s']:.2f} s "
            f"(calibration makespan {r['makespan_calib_s']:.3f} s); "
            f"launches {r['launches']}; peak {r['peak_mem_gib']:.2f} GiB")
    if [r["scheduler"] for r in live] != ["failure-aware", "deadline", "jsq",
                                          "round-robin"]:
        fail(f"phase 18: live schedulers {[r['scheduler'] for r in live]}")
    if sim["failure-aware"]["wrong_choice_rate"] != 0.0:
        fail(f"phase 18: failure-aware's wrong-choice rate in the sim is "
             f"{sim['failure-aware']['wrong_choice_rate']}")
    log(f"phase 18 ok: 4 schedulers x 16 requests through one crash on the "
        f"published-width fleet, completion rate 1, no KV leak, nothing "
        f"quarantined; sim wrong-choice rates "
        f"{ {k: round(v['wrong_choice_rate'], 3) for k, v in sim.items()} };"
        f" live launches {sums}; {total:.1f} s")
    return sums


# ---------------------------------------------------------------------------
# phase 19: the stress bench on the published-width closed-loop fleet
# ---------------------------------------------------------------------------

STRESS_RATES = (8.0, 32.0, 128.0)
STRESS_WINDOW_S = 0.35


def phase_stress() -> dict:
    """19. ``bench_stress(full_scale=True)`` on the closed loop's fleet
    (qwen2-1.5b, starcoder2-3b, xlstm-350m, qwen2-1.5b; bf16), its ladder
    cut to fit this script's time: JSQ only, offered rates 8, 32 and 128
    req/s over a 0.35 s window (stages of 3, 11 and 45 requests; the
    reference's quick ladder runs 8 to 2048 req/s for JSQ and
    round-robin), and the overlap A/B at 32 req/s (best of two each).
    Every run: each request terminal, none failed (no faults are
    injected), kv_leak 0, nothing quarantined, launches as the engines'
    passes imply.  Records the saturation rate, goodput per stage and the
    overlap speedup.  Returns the summed launches."""
    import torch
    from repro_torch.bench.stress import bench_stress
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    _, records = bench_stress(rates=STRESS_RATES, schedulers=("jsq",),
                              window_s=STRESS_WINDOW_S, device="cuda",
                              full_scale=True,
                              log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stages = [r for r in records if r["bench"] == "stress_stage"]
    (summary,) = [r for r in records if r["bench"] == "stress_summary"]
    (ab,) = [r for r in records if r["bench"] == "stress_ab"]
    sums = dict.fromkeys(ops.launches, 0)
    ab_n = round(ab["offered_rate"] * STRESS_WINDOW_S)
    for st in stages + ab["runs"]:
        label = (f"phase 19 {st['offered_rate']:g} req/s"
                 f"{'' if 'stage' in st else ' (A/B)'}")
        depths = {e["arch"]: e["layers"] for e in st["engines"]}
        if depths != CL_DEPTHS:
            fail(f"{label}: fleet {st['engines']}")
        n = st.get("num_requests", ab_n)
        if st["failed"] or st["completed"] + st["abandoned"] != n:
            fail(f"{label}: {st['completed']} ok, {st['abandoned']} "
                 f"abandoned, {st['failed']} failed of {n}")
        if any(e["kv_leak"] for e in st["engines"]) or st["quarantined"]:
            fail(f"{label}: kv_leak {[e['kv_leak'] for e in st['engines']]}"
                 f", quarantined {st['quarantined']}")
        want = _paged_launches(st["engines"])
        if st["launches"] != want:
            fail(f"{label}: launches {st['launches']}, the run implies "
                 f"{want}")
        for k, v in st["launches"].items():
            sums[k] += v
    for st in stages:
        log(f"  stage {st['stage']}: {st['offered_rate']:g} req/s, "
            f"{st['num_requests']} requests: throughput "
            f"{st['throughput_rps']:.2f} req/s, goodput "
            f"{st['goodput_rps']:.2f} req/s, p50/p95/p99 "
            f"{st['p50_s']:.3f}/{st['p95_s']:.3f}/{st['p99_s']:.3f} s, "
            f"miss {st['deadline_miss_rate']:.3f}, shed {st['abandoned']},"
            f" wall {st['wall_s']:.2f} s")
    log(f"phase 19 ok: saturation at {summary['saturation_rate']:g} req/s "
        f"(peak goodput {summary['peak_goodput_rps']:.2f} req/s); overlap "
        f"A/B at {ab['offered_rate']:g} req/s: serial "
        f"{ab['serial_wall_s']:.3f} s, overlapped {ab['overlap_wall_s']:.3f}"
        f" s, speedup {ab['overlap_speedup']:.3f}x; every run terminal, "
        f"none failed, no KV leak, nothing quarantined; launches {sums}; "
        f"{total:.1f} s")
    return sums


# ---------------------------------------------------------------------------
# phase 20: MoE serving on the smoke mesh
# ---------------------------------------------------------------------------

MIXTRAL, DBRX = "mixtral-8x22b", "dbrx-132b"
MOE_LAYERS = 4           # of mixtral's 56 and dbrx's 40: the bf16 serve
MOE_F32_LAYERS = 2       # the f32 mesh and teacher-forcing pass
MOE_PLEN, MOE_NEW = 128, 16
MOE_SLOTS = 4
MOE_REL = 2e-2           # bf16: max |a - b| over max |b|
# one MoE layer's token batches as (rows T, routing groups): a 128-token
# prefill, 4 decode rows, and the engine's decode round (mixtral: 4 dense
# slots, one group each; dbrx: 8 paged lanes in one batch)
MOE_LAYER_CASES = {MIXTRAL: {"prefill": (128, 1), "decode": (4, 1),
                             "round": (4, 4)},
                   DBRX: {"prefill": (128, 1), "decode": (4, 1),
                          "round": (8, 1)}}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _moe_pairs(p, cfg, x, groups: int) -> int:
    """(token, expert) pairs this batch computes: per group and expert,
    the assigned tokens up to the capacity."""
    import torch
    from repro_torch.models import moe
    xf = x.reshape(-1, x.shape[-1])
    w, _ = moe._route(p["router"], cfg, xf, groups)
    assigned = (w > 0).view(groups, -1, w.shape[-1]).sum(1)
    C = moe._capacity(cfg, xf.shape[0] // groups)
    return int(torch.clamp(assigned, max=C).sum().item())


def _device_ms(fn, calls: int = 3):
    """Device ms per ``fn()`` call from a ``torch.profiler`` trace (the
    summed kernel time; spin kernels first, as in ``_profile_prefill``),
    and the trace's kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(100_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    return (sum(by_kernel.values()) / 1e3 / calls if by_kernel else None,
            by_kernel)


def phase_moe_layer(arch: str) -> dict:
    """20a. One MoE layer of ``arch`` at published width in bf16: the local
    path, and the sharded and weights-stationary paths on the 1 x 1 NCCL
    mesh with the rank's ``place_params`` block, at each of
    ``MOE_LAYER_CASES``.  The mesh paths agree with the local one within
    ``MOE_REL``, each issues its collectives (counted by
    ``moe.collectives``; their NCCL kernels are read from the profiler
    traces), and each path's time, as called from Python and on the
    device, stands beside the expert weights' streaming bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe
    dev = torch.device("cuda")
    cfg = get_config(arch)
    E = cfg.moe.num_experts
    gen = torch.Generator(device=dev).manual_seed(20)
    p = moe.init_moe(gen, cfg, torch.bfloat16, dev)
    mesh = make_smoke_mesh(dev)
    ctx = sharding.ShardingContext(mesh)
    mine = sharding.place_params(mesh, {"layers": [{"ffn": p}]},
                                 cfg)["layers"][0]["ffn"]
    if mine["we_up"].shape != (1, E, cfg.d_model, cfg.d_ff):
        fail(f"phase 20a {arch}: the rank's block is "
             f"{tuple(mine['we_up'].shape)}")
    wbytes = sum(p[k].numel() * p[k].element_size()
                 for k in ("we_up", "we_down", "we_gate"))
    cfgs = {"local": cfg,
            "sharded": dataclasses.replace(cfg, moe_stationary_serve=False),
            "stationary": dataclasses.replace(cfg, moe_stationary_serve=True)}
    # collectives per call: the output over 'model' and the aux mean over
    # both axes; stationary: also the row gather, and 2 pre-activations
    # per expert over 'data' and the output over both axes
    want_coll = {"local": {"all_reduce": 0, "all_gather": 0},
                 "sharded": {"all_reduce": 3, "all_gather": 1},
                 "stationary": {"all_reduce": 2 * E + 4, "all_gather": 1}}
    result = {"weight_bytes": wbytes}
    nccl = set()
    for case, (T, groups) in MOE_LAYER_CASES[arch].items():
        x = torch.randn((groups, T // groups, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)

        def run(path, x=x, groups=groups):
            if path == "local":
                return moe.apply_moe(p, cfg, x, groups)[0]
            with sharding.use(ctx):
                return moe.apply_moe(mine, cfgs[path], x, groups)[0]

        outs = {}
        for path in cfgs:
            moe.reset_collectives()
            outs[path] = run(path).float()
            torch.cuda.synchronize()
            if moe.collectives != want_coll[path]:
                fail(f"phase 20a {arch} {case} {path}: collectives "
                     f"{moe.collectives}, expected {want_coll[path]}")
        if not torch.isfinite(outs["local"]).all():
            fail(f"phase 20a {arch} {case}: local output not finite")
        scale = outs["local"].abs().max().item()
        errs = {path: (outs[path] - outs["local"]).abs().max().item() / scale
                for path in ("sharded", "stationary")}
        for path, rel in errs.items():
            if not rel <= MOE_REL:
                fail(f"phase 20a {arch} {case}: {path} differs from local "
                     f"by {rel:.3e} of max |out| > {MOE_REL:.0e}")
        ms = {path: eager_ms(lambda path=path: run(path), iters=30)
              for path in cfgs}
        graph_ms = time_ms(lambda: run("local"), iters=5, reps=3)
        dev_ms = {}
        for path in cfgs:
            dev_ms[path], by_kernel = _device_ms(lambda path=path: run(path))
            nccl.update(k for k in by_kernel if "nccl" in k.lower())
        pairs = _moe_pairs(p, cfg, x, groups)
        nbytes = wbytes + p["router"].numel() * 4 + 2 * x.numel() * 2
        flops = pairs * 3 * 2 * cfg.d_model * cfg.d_ff
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        result[case] = {"T": T, "groups": groups, "rel_err": errs,
                        "ms": ms, "local_graph_ms": graph_ms,
                        "device_ms": dev_ms,
                        "pairs": pairs, "bound_ms": bound_ms,
                        "bound_by": bound_by}
        log(f"  20a {arch} {case} (T={T}, {groups} group(s), {pairs} "
            f"token-expert pairs): sharded {errs['sharded']:.2e}, "
            f"stationary {errs['stationary']:.2e} of max |out| from local;"
            f" eager ms local {ms['local']:.3f} (graph {graph_ms:.3f}), "
            f"sharded {ms['sharded']:.3f}, stationary "
            f"{ms['stationary']:.3f}; device ms "
            + ", ".join(f"{k} not measured" if v is None else
                        f"{k} {v:.3f}" for k, v in dev_ms.items())
            + f"; bound {bound_ms:.3f} ms ({bound_by}:"
            f" {wbytes / 1e9:.2f} GB of experts at "
            f"{HBM_BW / 1e12:.2f} TB/s)")
    result["nccl_kernels"] = sorted(nccl)
    log(f"phase 20a ok: {arch} one layer (d {cfg.d_model}, f {cfg.d_ff}, E "
        f"{E}, K {cfg.moe.top_k}, bf16): the three paths agree within "
        f"{MOE_REL:.0e}; NCCL kernels in the mesh paths' traces: "
        f"{sorted(nccl) or 'none seen'}")
    del p, mine
    _free_card()
    return result


def _prefill_mesh_vs_none(cfg, params, placed, mesh, prompt, max_len):
    """Prefill last logits through the mesh (``placed``, the rank's
    params) and without it (``params``): the largest difference over the
    largest |logit|, and the (token, layer) routing decisions whose top-k
    sets differ between the two runs.  The stationary path sums a token's
    experts in f32 and the local path in the model dtype, so in bf16 a
    later layer's top-k can flip on a near tie, and a flipped token takes
    other experts (and may push another past an expert's capacity)."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward
    routes = {"mesh": [], "none": []}
    route = moe._route

    def recording(key):
        def spy(router_w, c, xf, groups=1):
            w, aux = route(router_w, c, xf, groups)
            idx = torch.topk(w, c.moe.top_k, dim=-1).indices
            routes[key].append(idx.sort(-1).values)
            return w, aux
        return spy

    try:
        moe._route = recording("mesh")
        with sharding.use(sharding.ShardingContext(mesh)):
            a = forward(placed, cfg, {"tokens": prompt}, mode="prefill",
                        max_len=max_len)["last_logits"].float()
        moe._route = recording("none")
        b = forward(params, cfg, {"tokens": prompt}, mode="prefill",
                    max_len=max_len)["last_logits"].float()
    finally:
        moe._route = route
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"prefill logits not finite ({cfg.name}, {cfg.dtype})")
    flips = sum(int((x != y).any(-1).sum().item())
                for x, y in zip(routes["mesh"], routes["none"]))
    rel = (a - b).abs().max().item() / b.abs().max().item()
    return rel, flips


def _moe_round_breakdown(eng, prompts, rounds: int = 4) -> dict:
    """Where a MoE engine's decode round goes: host enqueue of
    ``dispatch``, wall time to results, device time by kernel class from
    ``torch.profiler``, and the idle share, with every slot decoding."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.request import Request
    for rid, pr in enumerate(prompts):
        eng.admit(Request(rid=rid, max_new_tokens=MOE_NEW, prompt=pr))
    for _ in range(4):                 # admission, prefills, warm rounds
        eng.step()
    torch.cuda.synchronize()

    def timed_round():
        t0 = time.perf_counter()
        eng.dispatch()
        t1 = time.perf_counter()
        eng.collect()
        return t1 - t0, time.perf_counter() - t0

    host = [timed_round() for _ in range(rounds)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
    eng.run_to_completion()
    by_kernel = _by_kernel(prof)
    enqueue_ms = 1e3 * sum(h[0] for h in host) / rounds
    wall_ms = 1e3 * sum(h[1] for h in host) / rounds
    busy_ms = sum(by_kernel.values()) / 1e3 / rounds

    def kind(name):
        low = name.lower()
        if "nccl" in low:
            return "nccl"
        if "decode" in low and ("split" in low or "merge" in low):
            return "attention"
        if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet",
                                  "cublas")):
            return "matmul"
        return "other"

    kinds = {}
    for name, us in by_kernel.items():
        kinds[kind(name)] = kinds.get(kind(name), 0.0) + us / 1e3 / rounds
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
            "busy_ms": busy_ms if by_kernel else None,
            "idle_share": 1 - busy_ms / wall_ms if by_kernel else None,
            "by_kind_ms": kinds,
            "top": [(name[:90], us / 1e3 / rounds) for name, us in top]}


def phase_moe_serve(arch: str) -> dict:
    """20b / 20c. ``arch`` at published width cut to ``MOE_LAYERS`` layers
    in bf16, served by ``ServeEngine(mesh=make_smoke_mesh("cuda"))`` (the
    engine ``build_sharded_engine`` builds): 8 requests of 128 prompt
    tokens and 16 new ones over 4 slots (mixtral: the dense pool; dbrx:
    the paged pool, 8 lanes, page 16, 64-token chunks), every request
    ``ok``, no KV held, launches = layers x passes with the warm-up; the
    prefill logits with and without the mesh within ``MOE_REL``; a decode
    round's breakdown.  Then ``MOE_F32_LAYERS`` layers in f32: the mesh
    engine's greedy tokens equal the unsharded engine's, and at capacity
    factor E / K (no token dropped) greedy decode equals the train-mode
    argmax.  Returns the bf16 serve's launches."""
    import numpy as np
    import torch
    from repro_torch.cluster.request import Request
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import (apply_head, forward,
                                                init_params)
    from repro_torch.serving.engine import ServeEngine
    label = "phase 20b" if arch == MIXTRAL else "phase 20c"
    dev = torch.device("cuda")
    mesh = make_smoke_mesh(dev)
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    max_len = MOE_PLEN + MOE_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer_gb = _tree_bytes(params["layers"][0]) / 1e9
    rest_gb = _tree_bytes(params) / 1e9 - MOE_LAYERS * layer_gb
    log(f"{label}: {arch} at published width cut to {MOE_LAYERS} of "
        f"{full.num_layers} layers: {layer_gb:.2f} GB a layer in bf16, "
        f"{MOE_LAYERS * layer_gb + rest_gb:.1f} GB with embed and head "
        f"({full.num_layers * layer_gb + rest_gb:.0f} GB at full depth); "
        f"drawn in {init_s:.1f} s")
    eng = ServeEngine(cfg, params, max_len=max_len, kv_slots=MOE_SLOTS,
                      mesh=mesh, device=dev, arch_id=arch)
    if eng.paged != (arch == DBRX):
        fail(f"{label}: {arch} got a {'paged' if eng.paged else 'dense'} "
             f"engine")
    rng = np.random.default_rng(20)
    V = cfg.vocab_size
    ops.reset_launches()
    moe.reset_collectives()
    eng.generate(rng.integers(0, V, (1, MOE_PLEN), dtype=np.int32), 2)
    warm = (eng.prefills, eng.decode_rounds)
    eng.reset()
    reqs = [Request(rid=i, max_new_tokens=MOE_NEW,
                    prompt=rng.integers(0, V, (1, MOE_PLEN), dtype=np.int32))
            for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.admit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    if any(r.status != "ok" or len(r.tokens) != MOE_NEW for r in reqs):
        fail(f"{label}: statuses {[r.status for r in reqs]}")
    if eng.kv_leak:
        fail(f"{label}: the engine holds {eng.kv_leak} slots or pages idle")
    prefills, rounds = eng.prefills + warm[0], eng.decode_rounds + warm[1]
    n = MOE_LAYERS
    # the dense engine's rings are cut over the mesh's one "model" rank,
    # the paged engine's pool into one page block over its one "data"
    # rank: a round is the split pass and the merge pass, apart
    decode_kernels = (("paged_flash_decode_partials" if eng.paged
                       else "flash_decode_partials"), "decode_merge")
    want = {"flash_attention": n * prefills,
            **{k: n * rounds for k in decode_kernels}}
    for k, v in launches.items():
        if v != want.get(k, 0):
            fail(f"{label}: launches {launches}, expected {want} ({n} "
                 f"layers x {prefills} prefill passes, {rounds} decode "
                 f"rounds, warm-up included)")
    if moe.collectives["all_reduce"] == 0:
        fail(f"{label}: the MoE layers issued no collective on the mesh")
    # phase 24a: the placed blocks (the experts' hoisted block, the dense
    # pool's rings or the page pool's block) are the dry run's argument
    # bytes
    placed = _placed_bytes(eng.params, eng._paged_states if eng.paged
                           else eng._pool_states)
    dry = _dry_bytes(cfg, "1x1", MOE_SLOTS, max_len,
                     pages=eng.num_pages if eng.paged else 0,
                     page_size=eng.page_size)
    if placed != dry:
        fail(f"{label}: placed bytes {placed} != the dry run's argument "
             f"bytes {dry}")
    log(f"{label}: placed {placed} B = the dry run's argument bytes")
    toks = sum(len(r.tokens) for r in reqs)
    log(f"{label}: {N_REQUESTS}/{N_REQUESTS} ok on a "
        f"{'paged' if eng.paged else 'dense'} {n}-layer bf16 engine, "
        f"kv_leak 0; flash_attention {launches['flash_attention']} = {n} x "
        f"{prefills} prefill passes, "
        + ", ".join(f"{k} {launches[k]}" for k in decode_kernels)
        + f" = {n} x {rounds} decode rounds each (warm-up"
        f" included); MoE collectives {dict(moe.collectives)}; {toks} "
        f"tokens in {wall:.2f} s ({toks / wall:.1f} tok/s)")
    # prefill logits with and without the mesh: within MOE_REL unless a
    # routing decision flipped (the f32 pass below holds them to 1e-4)
    prompt = torch.from_numpy(reqs[0].prompt).to(dev)
    rel, flips = _prefill_mesh_vs_none(cfg, params, eng.params, mesh, prompt,
                                       max_len)
    if rel > MOE_REL and not flips:
        fail(f"{label}: prefill logits with the mesh differ from those "
             f"without by {rel:.3e} of max |logit| > {MOE_REL:.0e}, with "
             f"every routing decision equal")
    eng.reset()
    rb = _moe_round_breakdown(eng, [r.prompt for r in reqs[:MOE_SLOTS]])
    stream_ms = _tree_bytes(eng.params) / HBM_BW * 1e3
    busy = ("device busy not measured (the profiler saw no device time)"
            if rb["busy_ms"] is None else
            f"device busy {rb['busy_ms']:.2f} ms (idle share "
            f"{rb['idle_share']:.3f}) by kind "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        sorted(rb["by_kind_ms"].items())))
    log(f"{label}: decode round ({MOE_SLOTS} requests decoding, {n} layers,"
        f" bf16, mesh): enqueue {rb['enqueue_ms']:.2f} ms, wall "
        f"{rb['wall_ms']:.2f} ms, {busy}; every weight read once: "
        f"{stream_ms:.3f} ms at {HBM_BW / 1e12:.2f} TB/s; prefill "
        f"logits mesh vs none {rel:.2e} of max |logit| with {flips} "
        f"routing decisions flipped; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name, ms in rb["top"]:
        log(f"  device {ms:8.3f} ms/round  {name}")
    del eng, params
    _free_card()

    # f32 at MOE_F32_LAYERS layers: mesh against no mesh, teacher forcing
    cfg32 = dataclasses.replace(full, num_layers=MOE_F32_LAYERS,
                                dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                           dev)
    gb32 = _tree_bytes(params32) / 1e9
    prompts = rng.integers(0, V, (MOE_SLOTS, MOE_PLEN), dtype=np.int32)
    rel32, flips32 = _prefill_mesh_vs_none(
        cfg32, params32, sharding.place_params(mesh, params32, cfg32), mesh,
        torch.from_numpy(prompts[:1]).to(dev), max_len)
    if not rel32 <= TOL["float32"]:
        fail(f"{label} f32: prefill logits with the mesh differ from those "
             f"without by {rel32:.3e} of max |logit| ({flips32} routing "
             f"decisions flipped)")

    def greedy(c, m):
        e = ServeEngine(c, params32, max_len=max_len, kv_slots=MOE_SLOTS,
                        mesh=m, device=dev, arch_id=arch)
        out = np.stack([np.asarray(t) for t in
                        e.generate(prompts, MOE_NEW).tokens])
        if e.kv_leak:
            fail(f"{label} f32: the engine holds {e.kv_leak} when idle")
        return out                              # (MOE_NEW, MOE_SLOTS)

    with_mesh, without = greedy(cfg32, mesh), greedy(cfg32, None)
    if not np.array_equal(with_mesh, without):
        bad = np.argwhere(with_mesh != without)
        fail(f"{label} f32: greedy tokens with the mesh differ from "
             f"those without at (step, request) {bad[:4].tolist()}")
    m = full.moe
    cfg_nodrop = dataclasses.replace(cfg32, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    toks = greedy(cfg_nodrop, mesh)
    seq = np.concatenate([prompts, toks[:-1].T], axis=1)
    hidden = forward(params32, cfg_nodrop,
                     {"tokens": torch.from_numpy(seq).to(dev)},
                     mode="train")["hidden"]
    logits = apply_head(params32, cfg_nodrop,
                        hidden[:, MOE_PLEN - 1:]).float()
    if not torch.isfinite(logits).all():
        fail(f"{label} f32: teacher-forced logits are not finite")
    pred = logits.argmax(-1).cpu().numpy()            # (slots, MOE_NEW)
    if not np.array_equal(pred, toks.T):
        r, i = np.argwhere(pred != toks.T)[0]
        top2 = torch.topk(logits[r, i], 2).values
        fail(f"{label} f32: request {r} decode step {i} gave {toks[i, r]}"
             f" but the teacher-forced argmax is {pred[r, i]} (top-2 gap "
             f"{(top2[0] - top2[1]).item():.3e})")
    log(f"{label} ok: f32 at {MOE_F32_LAYERS} layers ({gb32:.1f} GB): "
        f"prefill logits mesh vs none {rel32:.2e} of max |logit| ({flips32}"
        f" flips); {MOE_SLOTS} x {MOE_NEW} greedy tokens with the mesh = "
        f"without; at"
        f" capacity factor {m.num_experts / m.top_k:g} greedy decode = the "
        f"train-mode argmax")
    del params32, hidden, logits
    _free_card()
    return {"launches": launches, "wall_s": wall, "round": rb,
            "prefill_rel": rel, "prefill_flips": flips,
            "prefill_rel_f32": rel32, "prefill_flips_f32": flips32}


# ---------------------------------------------------------------------------
# phase 21: LM training
# ---------------------------------------------------------------------------

QWEN = "qwen2-1.5b"
TRAIN_GRAD_TOL = 1e-3       # card vs CPU, f32: of each leaf's largest entry
TRAIN_LOSS_TOL = 1e-4
TRAIN_BF16_TOL = 2e-2       # bf16 vs f32 on the card: loss, and the grads'
                            # norm-relative difference
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 8, 512
TRAIN_TIMED_STEPS = 5
TRAIN_MESH_TOL = 1e-4


def _worst_leaf_rel(got, want) -> float:
    """max over leaves of max |a - b| / max |b|, leaf by leaf on the card
    (``want`` may lie on the CPU)."""
    from repro_torch.core.optim import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.to(a.device)
        scale = max(b.float().abs().max().item(), 1e-12)
        worst = max(worst, (a.float() - b.float()).abs().max().item()
                    / scale)
    return worst


def phase_train_grads() -> dict:
    """21a. qwen2-1.5b at published width cut to 2 layers, f32, remat off:
    one train step's loss and gradients on the card (attention forward
    the CUDA kernel, its backward the plain chunked attention) against
    the same step on the CPU's plain path, ``flash_attention`` launched
    layers x microbatches times; then bf16 on the card against f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.optim import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.train.steps import make_grad_step, microbatches
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = dataclasses.replace(get_config(QWEN), num_layers=2,
                              dtype="float32", remat=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(21),
                         dev)
    batch = synth_batch(cfg, DataConfig(batch=2, seq_len=128), 0, dev)
    k = microbatches(cfg, 2)
    ops.reset_launches()
    grads, m = make_grad_step(cfg)(params, batch)
    torch.cuda.synchronize()
    launches = ops.launches["flash_attention"]
    if launches != cfg.num_layers * k:
        fail(f"phase 21a: flash_attention launched {launches} times, not "
             f"layers x microbatches = {cfg.num_layers} x {k}")
    t0 = time.perf_counter()
    want_g, want = make_grad_step(cfg)(
        tree_map(lambda t: t.to(cpu), params),
        {n: v.to(cpu) for n, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    loss, ref_loss = float(m["total_loss"]), float(want["total_loss"])
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    grad_rel = _worst_leaf_rel(grads, want_g)
    if not (loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL):
        fail(f"phase 21a: card vs CPU loss rel {loss_rel:.2e} (tol "
             f"{TRAIN_LOSS_TOL:.0e}), worst grad leaf rel {grad_rel:.2e} "
             f"(tol {TRAIN_GRAD_TOL:.0e})")
    del want_g
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    g16, m16 = make_grad_step(cfg16)(p16, batch)
    l16 = float(m16["total_loss"])
    bf16_loss_rel = abs(l16 - loss) / abs(loss)
    num = sum((a.float() - b).square().sum() for a, b in
              zip(tree_leaves(g16), tree_leaves(grads)))
    den = sum(b.square().sum() for b in tree_leaves(grads))
    bf16_grad_rel = float(torch.sqrt(num / den))
    if not (bf16_loss_rel <= TRAIN_BF16_TOL
            and bf16_grad_rel <= TRAIN_BF16_TOL):
        fail(f"phase 21a: bf16 vs f32 loss rel {bf16_loss_rel:.2e}, grads "
             f"norm-relative {bf16_grad_rel:.2e} (tol {TRAIN_BF16_TOL:.0e})")
    log(f"phase 21a ok: {QWEN} (2 layers, f32) card vs CPU: loss "
        f"{loss:.6f} vs {ref_loss:.6f} (rel {loss_rel:.2e}), worst grad "
        f"leaf rel {grad_rel:.2e}; flash_attention {launches} launches = "
        f"{cfg.num_layers} layers x {k} microbatches; CPU step "
        f"{cpu_s:.1f} s; bf16 vs f32: loss rel {bf16_loss_rel:.2e}, grads "
        f"norm-rel {bf16_grad_rel:.2e}")
    return {"launches": launches, "loss_rel": loss_rel,
            "grad_rel": grad_rel, "bf16_loss_rel": bf16_loss_rel,
            "bf16_grad_rel": bf16_grad_rel}


def phase_train_loss_falls() -> dict:
    """21b. ``launch.train --arch qwen2-1.5b --smoke --steps 40`` on the
    card: the held-out eval loss at least 0.2 below the first step's."""
    from repro_torch.launch import train
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = train.main(["--arch", QWEN, "--smoke", "--steps", "40"])
    first, final = out["first_loss"], out["eval_loss"]
    if not final < first - 0.2:
        fail(f"phase 21b: eval loss {final:.4f} is not 0.2 below the first "
             f"step's {first:.4f}")
    launches = ops.launches["flash_attention"]
    if launches == 0:
        fail("phase 21b: flash_attention never launched")
    log(f"phase 21b ok: loss {first:.4f} -> eval {final:.4f}, "
        f"{out['tokens_per_s']:.0f} tokens/s, flash_attention {launches} "
        f"launches")
    return {"first_loss": first, "eval_loss": final, "launches": launches,
            "tokens_per_s": out["tokens_per_s"]}


def phase_train_full() -> dict:
    """21c. qwen2-1.5b at published width and depth in bf16 (remat on, the
    config's microbatches), batch 8 x 512 tokens: one warm-up step, then
    ``TRAIN_TIMED_STEPS`` timed steps (finite losses, params moving,
    ``flash_attention`` = steps x layers x microbatches x 2: the
    checkpointed forward runs again in the backward); tokens/s, the
    host's enqueue time against the wall time per step, peak memory, and
    one profiled step's device busy time by kernel family."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import make_train_step, microbatches
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = get_config(QWEN)
    B, S = TRAIN_FULL_BATCH, TRAIN_FULL_SEQ
    k = microbatches(cfg, B)
    n = TRAIN_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    state = opt.init(params)
    step = make_train_step(cfg, opt.AdamWConfig(warmup_steps=1,
                                                total_steps=n + 2))
    dc = DataConfig(batch=B, seq_len=S)
    batches = [synth_batch(cfg, dc, s, dev) for s in range(n + 2)]
    t0 = time.perf_counter()
    params, state, m = step(params, state, batches[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = params["layers"][0]["mixer"]["wq"].clone()
    ops.reset_launches()
    losses, enqueue = [], []
    t0 = time.perf_counter()
    for s in range(1, n + 1):
        t1 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        enqueue.append(time.perf_counter() - t1)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches["flash_attention"]
    want = n * cfg.num_layers * k * (2 if cfg.remat else 1)
    if launches != want:
        fail(f"phase 21c: flash_attention launched {launches} times, not "
             f"{n} steps x {cfg.num_layers} layers x {k} microbatches x 2")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 21c: losses {losses}")
    moved = (params["layers"][0]["mixer"]["wq"].float()
             - before.float()).abs().max().item()
    if not moved > 0:
        fail("phase 21c: the params did not move")
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / n * 1e3
    enq_ms = sum(enqueue) / n * 1e3
    tokens_s = n * B * S / wall
    # the device side only: a step enqueues ~10^5 ops, whose host records
    # would make the trace slow to take and to read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(100_000)
        params, state, m = step(params, state, batches[n + 1])
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    prof_s = time.perf_counter() - t0
    busy_ms = sum(by_kernel.values()) / 1e3 if by_kernel else None
    families = {}
    for name, us in by_kernel.items():
        fam = ("flash_attention" if "flash_attention" in name else
               "gemm" if any(w in name for w in (
                   "gemm", "nvjet", "xmma", "cutlass", "sm90_", "Kernel2"))
               else "elementwise/other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    if busy_ms is None:
        log("phase 21c: device time not measured (the profiler saw no "
            "device time)")
    log(f"phase 21c ok: {QWEN} full width and depth ({cfg.num_layers} "
        f"layers, bf16, remat, {k} microbatches), batch {B} x {S}: "
        f"{tokens_s:.1f} tokens/s, {step_ms:.1f} ms a step (host enqueue "
        f"{enq_ms:.1f} ms), warm-up step {warm_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; profiled step "
        f"({prof_s:.1f} s): device busy "
        f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms, idle "
        f"share {None if busy_ms is None else round(1 - busy_ms / step_ms, 3)}"
        f"; " + ", ".join(f"{f} {v:.1f} ms"
                          for f, v in sorted(families.items())))
    for name, us in top:
        log(f"    {us / 1e3:9.3f} ms  {name[:110]}")
    log(f"  phase 21c took {time.perf_counter() - t_phase:.1f} s")
    return {"tokens_per_s": tokens_s, "step_ms": step_ms,
            "enqueue_ms": enq_ms, "warmup_s": warm_s,
            "device_busy_ms": busy_ms, "device_ms_by_family": families,
            "peak_bytes": peak, "launches": launches, "losses": losses,
            "microbatches": k}


def phase_train_moe_mesh() -> dict:
    """21d. mixtral-8x22b at published width cut to 2 layers, f32: one
    train step's gradients on the 1 x 1 NCCL smoke mesh with
    ``hoist_moe_layout`` (the sharded MoE path and its differentiable
    collectives) against the same step without the mesh, within
    ``TRAIN_MESH_TOL`` of each leaf's largest entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.optim import tree_map
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params
    from repro_torch.train.steps import make_grad_step
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MIXTRAL), num_layers=2,
                              dtype="float32", hoist_moe_layout=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                         dev)
    batch = synth_batch(cfg, DataConfig(batch=1, seq_len=64), 0, dev)
    t0 = time.perf_counter()
    grads, m = make_grad_step(cfg)(params, batch)
    want = tree_map(lambda t: t.to("cpu"), grads)
    del grads
    _free_card()
    moe.reset_collectives()
    with sharding.use(sharding.ShardingContext(make_smoke_mesh(dev))):
        got, m_mesh = make_grad_step(cfg)(params, batch)
    torch.cuda.synchronize()
    counts = dict(moe.collectives)
    if not (counts["all_reduce"] > 0 and counts["all_gather"] > 0):
        fail(f"phase 21d: the mesh step issued no collectives ({counts})")
    rel = _worst_leaf_rel(got, want)
    loss_rel = abs(float(m_mesh["total_loss"]) - float(m["total_loss"])) \
        / abs(float(m["total_loss"]))
    if not (rel <= TRAIN_MESH_TOL and loss_rel <= TRAIN_MESH_TOL):
        fail(f"phase 21d: mesh vs local worst grad leaf rel {rel:.2e}, "
             f"loss rel {loss_rel:.2e} (tol {TRAIN_MESH_TOL:.0e})")
    log(f"phase 21d ok: {MIXTRAL} (2 layers, f32) on the smoke mesh with "
        f"the hoisted layout: worst grad leaf rel {rel:.2e}, loss rel "
        f"{loss_rel:.2e}, collectives {counts} "
        f"({time.perf_counter() - t0:.1f} s)")
    del got, want, params
    _free_card()
    return {"grad_rel": rel, "loss_rel": loss_rel, "collectives": counts}


# ---------------------------------------------------------------------------
# phase 22: the tooling (dry run, kernel bench, Table V, Figs. 5-8, roofline)
# ---------------------------------------------------------------------------

# 22a's cut shapes of qwen2-1.5b at published width and depth, bf16: what
# one card holds of each kind
TOOL_SHAPES = (("train_cut", 512, 2, "train"),
               ("prefill_cut", 32768, 1, "prefill"),
               ("decode_cut", 32768, 8, "decode"))
MAX_SHARE = 1.05          # bound / measured: above 1, the count is wrong
TOOL_EPISODE_BUDGET_S = 40.0


def phase_tooling_dryrun(card: str):
    """22a. The dry run against the card: for each kind, the counting pass
    of ``launch.dryrun`` (fake CPU tensors) at a cut shape, then the same
    step on the card: the allocated inputs' bytes equal the dry run's
    argument bytes exactly, the counted bound over the measured device
    time (CUDA events, one step after a warm-up) is at most 1.05, and
    the attention kernels launch layers x calls."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import mesh_shape
    from repro_torch.models.transformer import init_layer_states, init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import microbatches
    dev = torch.device("cuda")
    cfg = get_config(QWEN)
    L, V = cfg.num_layers, cfg.vocab_size
    mesh = mesh_shape("1x1")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(22),
                         dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    out, records = {}, []
    for name, S, B, kind in TOOL_SHAPES:
        shape = InputShape(name, S, B, kind)
        t0 = time.perf_counter()
        rec = dryrun.analyse(cfg, shape, mesh, dryrun.trace(cfg, shape,
                                                             mesh),
                             time.perf_counter() - t0)
        records.append(rec)
        toks = torch.randint(0, V, (B, 1 if kind == "decode" else S),
                             generator=gen, device=dev, dtype=torch.int32)
        if kind == "train":
            labels = torch.randint(0, V, (B, S), generator=gen, device=dev,
                                   dtype=torch.int32)
            args = (params, opt.init(params),
                    {"tokens": toks, "labels": labels})
            calls = {"flash_attention": L * microbatches(cfg, B)
                     * (2 if cfg.remat else 1)}
        elif kind == "prefill":
            args = (params, {"tokens": toks})
            calls = {"flash_attention": L}
        else:
            args = (params, {"tokens": toks},
                    init_layer_states(cfg, B, S, dev, filled_pos=S - 1))
            calls = {"flash_decode": L}
        allocated = _tree_bytes(args)
        if allocated != rec["argument_bytes_total"]:
            fail(f"22a {name}: allocated inputs {allocated} B, the dry run "
                 f"counts {rec['argument_bytes_total']} B")
        step = dryrun.step_for_shape(cfg, shape)
        step(*args)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = step(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        launches = {k: ops.launches[k] for k in calls}
        if launches != calls:
            fail(f"22a {name}: launches {launches}, expected {calls}")
        first = res[0] if kind != "train" else res[2]["loss"]
        if not torch.isfinite(torch.as_tensor(first).float()).all():
            fail(f"22a {name}: the step's output is not finite")
        bound_ms = max(rec["compute_s"], rec["memory_s"]) * 1e3
        share = bound_ms / ms
        if not share <= MAX_SHARE:
            fail(f"22a {name}: bound {bound_ms:.3f} ms over measured "
                 f"{ms:.3f} ms = {share:.3f} > {MAX_SHARE}: the count is "
                 f"wrong")
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[name] = {"B": B, "S": S, "kind": kind, "ms": ms,
                     "bound_ms": bound_ms, "bound_by": rec["bottleneck"],
                     "share": share, "flops": rec["flops"],
                     "bytes": rec["bytes"],
                     "argument_bytes": rec["argument_bytes_total"],
                     "peak_gib": peak, "trace_s": rec["trace_s"],
                     "launches": launches}
        log(f"  22a {name} ({kind}, B {B} x S {S}; {card}): argument bytes "
            f"{allocated} = the dry run's; peak {peak:.2f} GiB; counted "
            f"{rec['flops']:.4e} FLOPs, {rec['bytes']:.4e} B (traced in "
            f"{rec['trace_s']} s on the CPU); bound {bound_ms:.3f} ms "
            f"({rec['bottleneck']}) against {ms:.3f} ms measured: share "
            f"{share:.4f}; launches {launches}")
        del args, res
        _free_card()
    shares = ", ".join(f"{v['share']:.4f}" for v in out.values())
    log(f"phase 22a ok: qwen2-1.5b (28 layers, bf16) train / prefill / "
        f"decode: exact argument bytes, shares {shares} (<= {MAX_SHARE}), "
        f"launches = layers x calls")
    return out, records


def phase_tooling_kernels(card: str) -> list:
    """22b. ``bench.kernels.bench_kernels()`` on the card: every row's
    kernel equal to its plain version (bf16 2e-2, f32 1e-4)."""
    from repro_torch.bench.kernels import bench_kernels
    t0 = time.perf_counter()
    rows, records = bench_kernels()
    bad = [r for r in records if not (r["ok"] and r["mode"] == "cuda")]
    if bad:
        fail(f"22b: rows off their plain version: {bad}")
    for r in rows:
        log(f"  22b {r}")
    log(f"phase 22b ok: {len(records)} kernel rows match their plain "
        f"versions ({card}; {time.perf_counter() - t0:.1f} s)")
    return records


def phase_tooling_tablev(card: str) -> dict:
    """22c. ``bench_tablev(full_scale=True)``: N = 1, 8, 32 through the
    4-layer cloud engine and the 2 / 3-layer edges at published width:
    every request ``ok``, no KV held, ``paged_flash_decode`` launched
    layers x decode rounds and ``flash_attention`` layers x prefill
    chunks, summed over each run's engines."""
    from repro_torch.bench.serving import bench_tablev
    t0 = time.perf_counter()
    rows, records = bench_tablev(full_scale=True)
    sums = {"paged_flash_decode": 0, "flash_attention": 0}
    for r in records:
        if r["completed"] != r["requests"] or r["count"] != r["requests"]:
            fail(f"22c: {r['mode']} N={r['requests']}: {r['completed']} "
                 f"completed")
        if any(e["kv_leak"] for e in r["engines"]):
            fail(f"22c: {r['mode']} N={r['requests']}: KV held "
                 f"{[e['kv_leak'] for e in r['engines']]}")
        want = {"paged_flash_decode": sum(e["layers"] * e["decode_rounds"]
                                          for e in r["engines"]),
                "flash_attention": sum(e["layers"] * e["prefills"]
                                       for e in r["engines"]),
                "ladn_denoise": 0, "flash_decode": 0,
                "flash_decode_partials": 0, "decode_merge": 0,
                "paged_flash_decode_partials": 0,
                "paged_flash_decode_window": 0}
        if r["launches"] != want:
            fail(f"22c: {r['mode']} N={r['requests']}: launches "
                 f"{r['launches']}, the run implies {want}")
        for k in sums:
            sums[k] += r["launches"][k]
    for r in rows:
        log(f"  22c {r}")
    log(f"phase 22c ok: Table V at published width ({card}): "
        f"{len(records)} runs, every request ok, no KV held, launches "
        f"{sums} ({time.perf_counter() - t0:.1f} s)")
    return {"launches": sums, "rows": rows}


def phase_tooling_scheduling(card: str) -> dict:
    """22d. Figs. 5, 6a and 8a at quick scale, cut to the budget: one
    timed lad-ts episode first, then fig5 with every method at 2
    episodes, one fig6a point and fig8a at I 5 (2 episodes each when the
    timed episode allows, else 1): finite delays, and ``ladn_denoise``
    launched 3 times a training task step and once an evaluation step
    for the diffusion policies, never for the others."""
    import math
    from repro_torch.bench import scheduling as sch
    from repro_torch.core.trainer import train_method
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    train_method("lad-ts", sch.env_for_scale("quick"), sch.agent_cfg("quick"),
                 episodes=1, device="cuda")
    ep_s = time.perf_counter() - t0
    eps = 2 if 13 * ep_s <= TOOL_EPISODE_BUDGET_S else 1
    ops.reset_launches()
    records = []
    rows, _ = sch.bench_fig5_learning("quick", episodes=2, records=records)
    rows += sch.bench_sweep("quick", "max_tasks", (8,), episodes=eps,
                            eval_episodes=1, records=records)
    rows += sch.bench_fig8_params("quick", episodes=eps, eval_episodes=1,
                                  steps=(5,), alphas=(), records=records)
    total = 0
    for r in records:
        delays = r["delays"] + ([r["eval_delay"]] if "eval_delay" in r
                                else [])
        if not all(math.isfinite(d) and d > 0 for d in delays):
            fail(f"22d: {r['bench']} {r['method']}: delays {delays}")
        chain = r["method"] in ("lad-ts", "d2sac-ts")
        want = 3 * r["task_steps"] if chain else 0
        want_eval = r.get("eval_steps", 0) if chain else 0
        got = (r["ladn_launches"], r.get("eval_ladn_launches", 0))
        if got != (want, want_eval):
            fail(f"22d: {r['bench']} {r['method']}: ladn_denoise launches "
                 f"{got}, expected {(want, want_eval)}")
        total += sum(got)
    if ops.launches["ladn_denoise"] != total:
        fail(f"22d: ladn_denoise launched {ops.launches['ladn_denoise']} "
             f"times, the runs account for {total}")
    for r in rows:
        log(f"  22d {r}")
    log(f"phase 22d ok: quick-scale Figs. 5, 6a and 8a ({card}; one lad-ts "
        f"episode {ep_s:.2f} s, {eps} episode(s) a sweep run): delays "
        f"finite, ladn_denoise {total} = 3 a training step + 1 an "
        f"evaluation step ({time.perf_counter() - t0:.1f} s)")
    return {"launches": total, "episode_s": ep_s, "rows": rows}


def phase_tooling_roofline(card: str, records: list) -> list:
    """22e. ``bench_roofline()`` and the report over 22a's records, written
    to a temporary directory."""
    import tempfile
    from repro_torch.bench.roofline import bench_roofline
    from repro_torch.roofline import report
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "torch_dryrun_1x1.jsonl"), "w") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
        rows = bench_roofline(tmp)
        report.main(["--results", tmp])
    mine = [r for r in rows if r.startswith("roofline_1x1/qwen2-1.5b/")]
    if len(mine) != len(records):
        fail(f"22e: roofline rows {rows}")
    for r in mine:
        log(f"  22e {r} ({card})")
    log("phase 22e ok: the roofline bench and report read 22a's records")
    return mine


# ---------------------------------------------------------------------------
# phase 23: the reference's placement on the 1 x 1 NCCL mesh
# ---------------------------------------------------------------------------

# flash_decode's two passes apart: recurrentgemma-9b's dense round and
# llava-next-mistral-7b's, bf16 and f32, and the recurrentgemma ring cut
# by hand into 4 slices of 40 slots (one empty for every lane) as 4
# "model" ranks would hold it
SPLIT_SHAPES = {
    "rg_round": DECODE_SHAPES["rg_round"],
    "rg_round_f32": DECODE_SHAPES["rg_round_f32"],
    "llava_round": DECODE_SHAPES["llava_round"],
    "llava_round_f32": DECODE_SHAPES["llava_round"][:6] + ("float32",),
}
SPLIT_CUT = ("rg_cut4", (4, 16, 1, 160, 256, (100, 45, 80, 119)), 4)
PLACE_SERVE_NEW = 12


def _split_bound(B, H, KV, hd, lens, n, elem: int, dt: str):
    """(partials bound, merge bound): each input read once, each output
    written once at HBM rate, or the arithmetic at the dtype's peak
    (partials: q K^T and P V over the valid positions; merge: a weight,
    a multiply-add and a denominator term per partial entry)."""
    G = H // KV
    valid = sum(lens)
    part_out = B * KV * n * G * (hd + 2) * 4
    p = bound(B * H * hd * elem + 2 * valid * KV * hd * elem + 4 * B
              + part_out, 4 * valid * H * hd, dt)
    m = bound(part_out + B * H * hd * elem, B * KV * n * G * (2 * hd + 3),
              "float32")
    return p, m


def phase_split_kernels() -> dict:
    """23a. ``flash_decode_partials`` then ``decode_merge`` (each pass of
    ``flash_decode`` alone) against the one-call ``flash_decode`` and the
    plain versions (``ref.decode_partials_ref``, ``ref.decode_merge_ref``
    and ``ref.decode_ref``) at ``SPLIT_SHAPES``, within ``TOL``; then the
    ring of ``SPLIT_CUT`` cut into slices, each slice's partials (an empty
    one where a split holds no valid slot) concatenated and merged,
    against the whole ring's plain decode.  Each pass's time (CUDA-graph
    replay), its plain version's and its bound."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    rows = {}
    for name, spec in SPLIT_SHAPES.items():
        B, H, KV, S, hd, lens, dt = spec
        tol = TOL[dt]
        q, k, v, L = flash_decode_case(spec)
        per, n = da.split_plan(B, KV, S, da.TILE)
        acc, m, l = ops.flash_decode_partials(q, k, v, L)
        two = ops.decode_merge(acc, m, l, q.dtype)
        one = ops.flash_decode(q, k, v, L)
        pa, pm, pl = ref.decode_partials_ref(q, k, v, L, per_split=per,
                                             n_splits=n)
        plain = ref.decode_merge_ref(pa, pm, pl, q.dtype)
        want = ref.decode_ref(q, k, v, L)
        torch.cuda.synchronize()
        if not torch.equal(torch.isinf(m), torch.isinf(pm)):
            fail(f"23a {name}: the empty partials differ from the plain "
                 f"version's")
        live = ~torch.isinf(pm)
        err_acc = (acc - pa).abs().max().item()
        err_ml = max((m[live] - pm[live]).abs().max().item(),
                     (l - pl).abs().max().item() / pl.abs().max().item())
        err = {"vs_one_call": (two.float() - one.float()).abs().max().item(),
               "vs_plain": (two.float() - want.float()).abs().max().item(),
               "plain_merge": (plain.float() - want.float()).abs().max()
               .item(), "partials_acc": err_acc, "partials_m_l": err_ml}
        if not (err["vs_one_call"] <= tol and err["vs_plain"] <= tol
                and err["plain_merge"] <= tol
                and err_acc <= tol * max(pa.abs().max().item(), 1.0)
                and err_ml <= tol):
            fail(f"23a {name}: errors {err} over tolerance {tol}")
        times = {
            "partials_ms": time_ms(lambda: ops.flash_decode_partials(
                q, k, v, L)),
            "merge_ms": time_ms(lambda: ops.decode_merge(acc, m, l,
                                                         q.dtype)),
            "one_call_ms": time_ms(lambda: ops.flash_decode(q, k, v, L)),
            "plain_partials_ms": time_ms(lambda: ref.decode_partials_ref(
                q, k, v, L, per_split=per, n_splits=n), iters=10, reps=3),
            "plain_merge_ms": time_ms(lambda: ref.decode_merge_ref(
                acc, m, l, q.dtype), iters=10, reps=3)}
        (pb, pby), (mb, mby) = _split_bound(B, H, KV, hd, lens, n,
                                            q.element_size(), dt)
        rows[name] = {"shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                                "lens": list(lens), "dtype": dt,
                                "n_splits": n, "per_split": per},
                      "max_abs_err": err, **times,
                      "partials_bound_ms": pb, "partials_bound_by": pby,
                      "merge_bound_ms": mb, "merge_bound_by": mby}
        log(f"  23a {name} ({n} splits of {per}): partials "
            f"{times['partials_ms']:.4f} ms (plain "
            f"{times['plain_partials_ms']:.4f}, bound {pb:.6f} {pby}), merge "
            f"{times['merge_ms']:.4f} (plain {times['plain_merge_ms']:.4f},"
            f" bound {mb:.6f} {mby}), one call {times['one_call_ms']:.4f};"
            f" err vs one call {err['vs_one_call']:.2e}, vs plain "
            f"{err['vs_plain']:.2e}")
    name, spec, M = SPLIT_CUT
    for dt in ("bfloat16", "float32"):
        spec_dt = spec + (dt,)
        B, H, KV, S, hd, lens, _ = spec_dt
        q, k, v, L = flash_decode_case(spec_dt)
        Wl = S // M
        parts = [ops.flash_decode_partials(
            q, k[:, :, j * Wl:(j + 1) * Wl].contiguous(),
            v[:, :, j * Wl:(j + 1) * Wl].contiguous(),
            torch.clamp(L - j * Wl, 0, Wl).to(torch.int32))
            for j in range(M)]
        if not torch.isinf(parts[-1][1]).all():
            fail(f"23a {name}: the last slice is not empty everywhere")
        acc, m, l = (torch.cat([p[i] for p in parts], 2) for i in range(3))
        out = ops.decode_merge(acc, m, l, q.dtype).float()
        want = ref.decode_ref(q, k, v, L).float()
        plain = ref.decode_merge_ref(acc, m, l, q.dtype).float()
        e = max((out - want).abs().max().item(),
                (plain - want).abs().max().item())
        if not (torch.isfinite(out).all() and e <= TOL[dt]):
            fail(f"23a {name} {dt}: {M} slices merged differ from the "
                 f"whole ring by {e:.3e} (finite "
                 f"{bool(torch.isfinite(out).all())})")
        rows[f"{name}_{dt}"] = {"slices": M, "lens": list(lens),
                                "max_abs_err": e}
        log(f"  23a {name} {dt}: {M} slices of {Wl} (the last empty), "
            f"merged = the whole ring's plain decode to {e:.2e}")
    log("phase 23a ok: the split-only and merge-only flash_decode entries "
        "= the one-call kernel and the plain versions")
    return rows


_KV_LEAVES = ("k", "v", "k_scale", "v_scale", "k_pages", "v_pages")


def _placed_bytes(placed, states=None) -> int:
    """Bytes of a rank's placed params and of the K/V leaves of its
    slot pool or page pool block."""
    n = _tree_bytes(placed)
    for layer in states or []:
        n += sum(t.numel() * t.element_size() for k, t in layer.items()
                 if k in _KV_LEAVES)
    return n


def _dry_bytes(cfg, mesh_tag: str, slots: int = 0, max_len: int = 0,
               pages: int = 0, page_size: int = 0,
               params: bool = True) -> int:
    """One rank's argument bytes of ``cfg``'s params (unless not
    ``params``), and, with ``slots``, a dense pool's K/V rings or, with
    ``pages``, a page pool of ``pages`` x ``page_size``, as the dry run
    counts them (each leaf cut by ``state_pspecs``)."""
    import torch
    from repro_torch.launch import sharding, specs
    from repro_torch.models.transformer import (init_layer_states,
                                                init_paged_states)
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = specs.mesh_shape(mesh_tag)
    fake = FakeTensorMode()
    args, sp = [], []
    if params:
        p, p_spec = specs.param_specs(cfg, mesh, fake)
        args, sp = [p], [p_spec]
    cpu = torch.device("cpu")
    with fake:
        if pages:
            st = init_paged_states(cfg, pages, page_size, cpu)
        elif slots:
            st = init_layer_states(cfg, slots, max_len, cpu)
        else:
            st = []
    s_spec = sharding.state_pspecs(st, mesh)
    args.append([{k: t for k, t in layer.items() if k in _KV_LEAVES}
                 for layer in st])
    sp.append([{k: t for k, t in layer.items() if k in _KV_LEAVES}
               for layer in s_spec])
    return specs.argument_bytes(args, sp, mesh)[1]


def _placement_serve(label, arch, paged, n_req, plen, max_len, slots):
    """A ``build_sharded_engine`` engine of ``arch`` at published width
    and depth (bf16) on the 1 x 1 NCCL mesh and a meshless engine on the
    same weights (the 1 x 1 blocks are the whole tensors): a warm-up
    request, then ``n_req`` greedy requests through each, tokens equal,
    no KV held, the mesh run's launches exact; placed bytes against the
    dry run's; a decode round with the mesh and without."""
    import numpy as np
    import torch
    from repro_torch.cluster.request import Request
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.serving.builders import build_sharded_engine
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    eng = build_sharded_engine(arch, max_len, full_scale=True,
                               kv_slots=slots, paged=paged, seed=23,
                               device="cuda")
    cfg = eng.cfg
    meshless = ServeEngine(cfg, eng.params, max_len=max_len,
                           kv_slots=slots, paged=paged, device="cuda",
                           seed=23, arch_id=arch)
    rng = np.random.default_rng(23)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, (1, plen), dtype=np.int32)
               for _ in range(n_req)]
    n_attn = sum(b.mixer == "attn" for b in cfg.layer_pattern())
    out, launched = {}, {}
    for name, e in (("mesh", eng), ("meshless", meshless)):
        ops.reset_launches()
        sharding.reset_collectives()
        e.generate(rng.integers(0, V, (1, plen), dtype=np.int32), 2)
        warm = (e.prefills, e.decode_rounds)
        e.reset()
        reqs = [Request(rid=i, max_new_tokens=PLACE_SERVE_NEW, prompt=p)
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.admit(r)
        e.run_to_completion()
        torch.cuda.synchronize()
        if any(r.status != "ok" for r in reqs) or e.kv_leak:
            fail(f"{label} {name}: statuses {[r.status for r in reqs]}, "
                 f"kv_leak {e.kv_leak}")
        out[name] = np.stack([np.concatenate([np.asarray(t).ravel()
                                              for t in r.tokens])
                              for r in reqs])
        launched[name] = (dict(ops.launches), e.prefills + warm[0],
                          e.decode_rounds + warm[1],
                          dict(sharding.collectives))
    if not np.array_equal(out["mesh"], out["meshless"]):
        bad = np.argwhere(out["mesh"] != out["meshless"])
        fail(f"{label}: mesh tokens differ from the meshless engine's at "
             f"(request, step) {bad[:4].tolist()}")
    launches, prefills, rounds, coll = launched["mesh"]
    # a round is the split pass and the merge pass apart: over the 1 x 1
    # mesh's one page block, or the ring cut over its one "model" rank
    want = {"flash_attention": n_attn * prefills,
            ("paged_flash_decode_partials" if paged
             else "flash_decode_partials"): n_attn * rounds,
            "decode_merge": n_attn * rounds}
    want = {k: v for k, v in want.items() if v}      # xLSTM: no attention
    if {k: v for k, v in launches.items() if v} != want:
        fail(f"{label}: launches {launches}, expected {want} ({n_attn} "
             f"attention layers x {prefills} prefills / {rounds} decode "
             f"rounds, warm-up included)")
    if not (coll["all_gather"] > 0 and coll["all_reduce"] > 0):
        fail(f"{label}: the mesh run issued collectives {coll}")
    report = eng.placement_report()
    placed = _placed_bytes(eng.params, eng._paged_states if paged else
                           eng._pool_states)
    dry = _dry_bytes(cfg, "1x1", slots, max_len,
                     pages=eng.num_pages if paged else 0,
                     page_size=eng.page_size)
    if placed != dry:
        fail(f"{label}: placed bytes {placed} != the dry run's argument "
             f"bytes {dry}")
    breakdown = {}
    for name, e in (("mesh", eng), ("meshless", meshless)):
        e.reset()
        breakdown[name] = _moe_round_breakdown(e, prompts[:slots])
    log(f"{label} ok: {arch} at published width and depth ({cfg.num_layers}"
        f" layers, {n_attn} attention, bf16, "
        f"{'paged' if paged else 'dense'}) on the 1 x 1 NCCL mesh: "
        f"{n_req} x {PLACE_SERVE_NEW} greedy tokens = the meshless "
        f"engine's; launches {want}; collectives {coll}; placed "
        f"{placed} B = the dry run's argument bytes ({time.perf_counter() - t0:.1f} s)")
    for name, rb in breakdown.items():
        busy = ("not measured" if rb["busy_ms"] is None else
                f"{rb['busy_ms']:.3f} ms (idle {rb['idle_share']:.3f}), "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            sorted(rb["by_kind_ms"].items())))
        log(f"  {label} decode round {name}: enqueue {rb['enqueue_ms']:.2f}"
            f" ms, wall {rb['wall_ms']:.2f} ms, device busy {busy}")
    layer0 = report.get("layers.0", {})
    log(f"  {label} placement: embed {report.get('embed')}, layer 0 "
        f"{layer0}")
    del eng, meshless
    _free_card()
    return {"launches": launches, "collectives": coll,
            "placed_bytes": placed, "dry_run_bytes": dry,
            "round": breakdown, "layer0": layer0}


def phase_placement_train() -> dict:
    """23d. One train step of reduced qwen2-1.5b (f32) on the 1 x 1 NCCL
    mesh from its placed params against the meshless step: gradients and
    new params within 1e-5 of each leaf's largest entry."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.steps import make_grad_step, make_train_step
    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced(get_config(QWEN)), num_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(23),
                         dev)
    batch = synth_batch(cfg, DataConfig(batch=4, seq_len=64), 0, dev)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    grads, _ = make_grad_step(cfg)(params, batch)
    new, _, _ = make_train_step(cfg, opt.AdamWConfig(**kw))(
        params, opt.init(params), batch)
    mesh = make_smoke_mesh(dev)
    placed = sharding.place_params(mesh, params, cfg)
    with sharding.use(sharding.ShardingContext(mesh)):
        g_mesh, _ = make_grad_step(cfg)(placed, batch)
        n_mesh, _, m = make_train_step(cfg, opt.AdamWConfig(**kw))(
            placed, opt.init(placed), batch)
    rel = _worst_leaf_rel(g_mesh, grads)
    rel_p = _worst_leaf_rel(n_mesh, new)
    if not (rel <= 1e-5 and rel_p <= 1e-5):
        fail(f"23d: mesh vs meshless grads {rel:.2e}, params {rel_p:.2e}")
    log(f"phase 23d ok: reduced {QWEN} (f32) one step on the 1 x 1 mesh = "
        f"the meshless step: grads {rel:.2e}, params {rel_p:.2e} of each "
        f"leaf's largest entry")
    return {"grad_rel": rel, "param_rel": rel_p}


def phase_placement(card: str) -> dict:
    """23. The reference's placement on the 1 x 1 NCCL mesh."""
    t0 = time.perf_counter()
    out = {"23a": phase_split_kernels()}
    _free_card()
    out["23b"] = _placement_serve("phase 23b", QWEN, True, 8, 128, 160, 4)
    out["23c"] = _placement_serve("phase 23c", RG, False, 4, 128, 160, 4)
    out["23d"] = phase_placement_train()
    _free_card()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23 ok in {out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 24: one rank's program on the production mesh
# ---------------------------------------------------------------------------

MINITRON = "minitron-8b"
# (arch, shape) whose rank-0 programs on 16 x 16 the dry run traces on
# the CPU; their flash_attention calls are phase 24b's shapes
RANK_COMBOS = ((MINITRON, "train_4k"), (LLAVA, "prefill_32k"),
               (RG, "prefill_32k"), (MIXTRAL, "prefill_32k"))
RANK_MESH = "16x16"


def phase_rank_serve() -> dict:
    """24a. xlstm-350m (dense, published width and depth, bf16) through
    ``build_sharded_engine`` on the 1 x 1 NCCL mesh: the tensor-parallel
    mLSTM (its C / n rows) and the whole sLSTM, tokens = the meshless
    engine's, placed bytes = the dry run's.  (Phases 23b and 23c run
    qwen2-1.5b and recurrentgemma-9b through the head-parallel attention
    and the tensor-parallel RG-LRU; phases 20b / 20c hold the MoE
    engines' placed bytes.)"""
    return _placement_serve("phase 24a", XLSTM, False, 4, 128, 160, 4)


def phase_rank_traces() -> dict:
    """The dry run of ``RANK_COMBOS`` on 16 x 16: rank 0's program traced
    on the CPU on a fake process group of 256 ranks (this process holds
    no other group by now)."""
    from repro_torch.launch import dryrun
    recs = {}
    for arch, shape in RANK_COMBOS:
        rec = dryrun.run_one(arch, shape, RANK_MESH, verbose=False)
        recs[(arch, shape)] = rec
        log(f"  24 dry run {arch} x {shape} on {RANK_MESH}, rank 0: "
            f"{rec['flops']:.4e} FLOPs, {rec['bytes']:.4e} B, collectives "
            f"{rec['collective_bytes']:.4e} B in {rec['n_collectives']} "
            f"calls; compute {rec['compute_s']:.4e} s, memory "
            f"{rec['memory_s']:.4e} s, collective {rec['collective_s']:.4e}"
            f" s: {rec['bottleneck']} (traced in {rec['trace_s']} s)")
    return recs


def phase_rank_attention(recs: dict) -> dict:
    """24b. ``flash_attention`` at every shape the 16 x 16 rank-0 programs
    of ``RANK_COMBOS`` call it with (read from the traces' recorded
    calls), against its plain version (``TOL``, and ``ROW_TOL`` in each
    query row, a planted fault reading above it) and SDPA, timed beside
    the bound."""
    import json as _json
    rows = {}
    for (arch, shape), rec in recs.items():
        calls = rec["kernel_calls"].get("flash_attention", {})
        if not calls:
            fail(f"24b: the {arch} x {shape} trace recorded no "
                 f"flash_attention call")
        for i, (key, n) in enumerate(sorted(calls.items())):
            c = _json.loads(key)
            (B, Hq, Sq, hd), (_, KVh, Skv, _) = c["shapes"][:2]
            spec = (B, Hq, KVh, Sq, Skv, hd, c["window"], c["q_offset"],
                    c["dtype"])
            name = f"rank16_{arch}_{shape}" + (f"_{i}" if i else "")
            row = attention_row(name, spec)
            row["calls_per_step"] = n
            row["G"] = Hq // KVh
            rows[name] = row
    log(f"phase 24b ok: flash_attention = its plain version at the "
        f"{RANK_MESH} rank-0 shapes {', '.join(rows)}")
    return rows


def phase_rank_program(card: str, rec: dict) -> dict:
    """24c. Rank 0's program of llava-next-mistral-7b x prefill_32k on
    16 x 16, on the card: the dry run's ``rank_program`` on a fake
    process group of 256 ranks over CUDA tensors (the fake collectives
    move nothing and leave their outputs uninitialised, so this times
    and checks no values): the rank's placed params and its 2 rows of
    the batch, whose bytes equal the dry run's argument bytes; one
    prefill after a warm-up between CUDA events, against the dry run's
    compute and memory terms (bound / measured <= ``MAX_SHARE``);
    ``flash_attention`` launches = layers."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import mesh_shape
    from repro_torch.models.transformer import config_for_shape, init_params
    dev = torch.device("cuda")
    shape = get_shape("prefill_32k")
    cfg = config_for_shape(get_config(LLAVA), shape)
    B, S, P = shape.global_batch, shape.seq_len, cfg.vision_patches
    gen = torch.Generator(device=dev).manual_seed(24)
    t0 = time.perf_counter()
    with dryrun.rank_zero(mesh_shape(RANK_MESH), device=dev) as mesh:
        params = init_params(cfg, gen, dev)
        batch = {"patches": torch.randn((B, P, cfg.vision_dim),
                                        generator=gen, device=dev).to(
                                            getattr(torch, cfg.dtype)),
                 "tokens": torch.randint(0, cfg.vocab_size, (B, S - P),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
        step, args = dryrun.rank_program(cfg, shape, mesh, (params, batch))
        del params
        _free_card()
        held = _tree_bytes(args)
        if held != rec["argument_bytes"]:
            fail(f"24c: rank 0 holds {held} B, the dry run counts "
                 f"{rec['argument_bytes']} B")
        step(*args)                                    # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del args, step
    _free_card()
    want = {"flash_attention": cfg.num_layers}
    if {k: v for k, v in launches.items() if v} != want:
        fail(f"24c: launches {launches}, expected {want}")
    bound_ms = max(rec["compute_s"], rec["memory_s"]) * 1e3
    share = bound_ms / ms
    if not share <= MAX_SHARE:
        fail(f"24c: bound {bound_ms:.3f} ms over measured {ms:.3f} ms = "
             f"{share:.3f} > {MAX_SHARE}: the count is wrong")
    log(f"phase 24c ok: {LLAVA} x prefill_32k rank 0 of {RANK_MESH} on the "
        f"card ({card}; fake collectives): {held} B placed = the dry run's "
        f"argument bytes; {ms:.3f} ms measured against the dry run's "
        f"compute {rec['compute_s'] * 1e3:.3f} ms, memory "
        f"{rec['memory_s'] * 1e3:.3f} ms (collective "
        f"{rec['collective_s'] * 1e3:.3f} ms over NVLink, not run): share "
        f"{share:.4f}; launches {launches}; peak {peak:.1f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"ms": ms, "bound_ms": bound_ms, "share": share,
            "compute_ms": rec["compute_s"] * 1e3,
            "memory_ms": rec["memory_s"] * 1e3,
            "collective_ms": rec["collective_s"] * 1e3,
            "argument_bytes": held, "launches": launches, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase 25: the paged pool cut into page blocks over the data ranks
# ---------------------------------------------------------------------------

# paged_flash_decode's split pass alone at phase 2's serve shape, 8 lanes
# of 2048 tokens and the dbrx-132b round, over 4 page blocks as 4 data
# ranks would hold them
PAGED_CUT_SHAPES = ("serve", "long_2048", "dbrx_round")
PAGED_CUT_RANKS = 4
# 25b: a qwen2-1.5b engine's pool of 1024 pages (16 x 64) on 16 x 16
PAGED_CUT_PAGES = 1024


def _paged_split_bound(q, kp, tables, lens, n: int, dt: str):
    """(partials bound, merge bound) of the paged split pass and the
    merge at one call's inputs: each input read once (q, the K/V rows of
    the valid positions, the table, the lengths), each output written
    once (the f32 partials; the merge's output), at HBM rate, or the
    arithmetic at the dtype's peak (as ``_split_bound``)."""
    B, H, hd = q.shape
    KV, ps = kp.shape[1], kp.shape[2]
    G, W = H // KV, tables.shape[1]
    elem = q.element_size()
    valid = int(sum(min(int(x), W * ps) for x in lens.tolist()))
    part_out = B * KV * n * G * (hd + 2) * 4
    part = bound(B * H * hd * elem + 2 * valid * KV * hd * elem
                 + tables.numel() * 4 + 4 * B + part_out,
                 4 * valid * H * hd, dt)
    merge = bound(part_out + B * H * hd * elem,
                  B * KV * n * G * (2 * hd + 3), "float32")
    return part, merge


def phase_paged_cut_kernels() -> dict:
    """25a. ``paged_flash_decode_partials`` then ``decode_merge`` at
    ``PAGED_CUT_SHAPES`` in bf16 and f32: over one page block (the
    table compacted by ``attention._owned_table``, as the 1 x 1 mesh
    runs it) the merged output equals the one-call ``paged_flash_decode``
    bit for bit; over ``PAGED_CUT_RANKS`` blocks (the pool padded to a
    multiple of them, each rank's partials on the card in turn,
    concatenated) it is the plain decode's within ``TOL`` on live lanes
    and zero on idle ones; dropping one rank's partials must break that
    (a planted fault).  Each pass's time (CUDA-graph replay), its plain
    version's and its bound."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    rows = {}
    for shape in PAGED_CUT_SHAPES:
        spec = PAGED_SHAPES[shape]
        Bs, Hs, KVs, hd, ps, Ps, Ws, _ = spec
        for dt in ("bfloat16", "float32"):
            tol = TOL[dt]
            q, kp, vp, tables, lens = paged_decode_case(spec,
                                                        getattr(torch, dt))
            per, n = da.split_plan(Bs, KVs, Ws * ps, ps)
            table, length = attention._owned_table(tables, lens, ps, 0, Ps)
            acc, m, l = da.paged_flash_decode_partials(q, kp, vp, table,
                                                       length)
            two = da.decode_merge(acc, m, l, q.dtype)
            one = da.paged_flash_decode(q, kp, vp, tables, lens)
            torch.cuda.synchronize()
            if not torch.equal(two, one):
                fail(f"25a {shape} {dt}: one page block's partials merged "
                     f"differ from the one-call kernel by "
                     f"{(two.float() - one.float()).abs().max().item():.3e}")
            pa, pm, pl = ref.paged_decode_partials_ref(
                q, kp, vp, table, length, per_split=per, n_splits=n)
            if not torch.equal(torch.isinf(m), torch.isinf(pm)):
                fail(f"25a {shape} {dt}: the empty partials differ from the "
                     f"plain version's")
            err_acc = (acc - pa).abs().max().item()
            if not err_acc <= tol * max(pa.abs().max().item(), 1.0):
                fail(f"25a {shape} {dt}: partials differ from the plain "
                     f"version's by {err_acc:.3e}")
            # the pool dealt to PAGED_CUT_RANKS ranks by page block
            D = PAGED_CUT_RANKS
            pad = -Ps % D
            kq = torch.cat([kp, kp.new_zeros((pad,) + kp.shape[1:])])
            vq = torch.cat([vp, vp.new_zeros((pad,) + vp.shape[1:])])
            Pl = (Ps + pad) // D
            lanes = torch.clamp(lens, max=Ws * ps)
            parts, held = [], []
            for d in range(D):
                tb, ln = attention._owned_table(tables, lanes, ps, d * Pl, Pl)
                parts.append(da.paged_flash_decode_partials(
                    q, kq[d * Pl:(d + 1) * Pl], vq[d * Pl:(d + 1) * Pl], tb,
                    ln))
                held.append(int(ln.sum()))
            want = ref.paged_decode_ref(q, kp, vp, tables, lens).float()
            live = lens > 0

            def merged(ps_):
                a, m_, l_ = (torch.cat([p_[i] for p_ in ps_], 2)
                             for i in range(3))
                return da.decode_merge(a, m_, l_, q.dtype).float()

            out = merged(parts)
            err = (out[live] - want[live]).abs().max().item()
            if not (err <= tol and not out[~live].any()):
                fail(f"25a {shape} {dt}: {D} page blocks merged differ from "
                     f"the plain decode by {err:.3e} (tol {tol:.0e}), idle "
                     f"lanes zero {not out[~live].any()}")
            drop = max(range(D), key=lambda d: held[d])
            fault = (merged(parts[:drop] + parts[drop + 1:])[live]
                     - want[live]).abs().max().item()
            if not fault > tol:
                fail(f"25a {shape} {dt}: rank {drop}'s partials dropped, "
                     f"yet the merge is within {fault:.3e} of the plain "
                     f"decode")
            times = {
                "partials_ms": time_ms(lambda: da.paged_flash_decode_partials(
                    q, kp, vp, table, length)),
                "merge_ms": time_ms(lambda: da.decode_merge(acc, m, l,
                                                            q.dtype)),
                "one_call_ms": time_ms(lambda: da.paged_flash_decode(
                    q, kp, vp, tables, lens)),
                "table_eager_ms": eager_ms(lambda: attention._owned_table(
                    tables, lens, ps, 0, Ps)),
                "plain_partials_ms": time_ms(
                    lambda: ref.paged_decode_partials_ref(
                        q, kp, vp, table, length, per_split=per,
                        n_splits=n), iters=10, reps=3),
                "plain_merge_ms": time_ms(lambda: ref.decode_merge_ref(
                    acc, m, l, q.dtype), iters=10, reps=3)}
            (pb, pby), (mb, mby) = _paged_split_bound(q, kp, tables, lens,
                                                      n, dt)
            rows[f"{shape}_{dt}"] = {
                "shape": {"B": Bs, "H": Hs, "KV": KVs, "hd": hd, "ps": ps,
                          "P": Ps, "W": Ws, "lens": list(spec[7]),
                          "dtype": dt, "n_splits": n, "per_split": per},
                "max_abs_err": err, "partials_err": err_acc,
                "fault_err": fault, "ranks": D, "rank_positions": held,
                **times, "partials_bound_ms": pb, "partials_bound_by": pby,
                "merge_bound_ms": mb, "merge_bound_by": mby}
            log(f"  25a {shape} {dt} ({n} splits of {per}): one block = the "
                f"one-call kernel bit for bit; {D} blocks (positions "
                f"{held}) = plain to {err:.2e}, one dropped {fault:.2e}; "
                f"partials {times['partials_ms']:.4f} ms (plain "
                f"{times['plain_partials_ms']:.4f}, bound {pb:.6f} {pby}), "
                f"merge {times['merge_ms']:.4f} (plain "
                f"{times['plain_merge_ms']:.4f}, bound {mb:.6f} {mby}), "
                f"compacted table {times['table_eager_ms']:.4f} (eager), "
                f"one call "
                f"{times['one_call_ms']:.4f}")
            del q, kp, vp, kq, vq, parts, acc, pa
            torch.cuda.empty_cache()
    log("phase 25a ok: the paged split-only entry and the merge = the "
        "one-call kernel over one page block and the plain decode over "
        f"{PAGED_CUT_RANKS}")
    return rows


def phase_paged_cut_rank(card: str) -> dict:
    """25b. Rank 0 of 16 x 16 under a fake process group over CUDA
    tensors: a qwen2-1.5b paged engine at published width and depth in
    bf16 with ``PAGED_CUT_PAGES`` pages, its pool built (no round runs:
    the fake collectives move nothing).  Its block is 1/16 of the pool,
    and its placed params and pool are the dry run's argument bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.specs import mesh_shape
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda")
    cfg = get_config(QWEN)
    t0 = time.perf_counter()
    with dryrun.rank_zero(mesh_shape(RANK_MESH), device=dev) as mesh:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(25),
                             dev)
        eng = ServeEngine(cfg, params, max_len=2048, kv_slots=8,
                          num_pages=PAGED_CUT_PAGES, mesh=mesh, device=dev,
                          arch_id=QWEN)
        del params
        eng._ensure_paged_states()
        block = sharding.page_block(mesh, PAGED_CUT_PAGES)
        pool = _placed_bytes({}, eng._paged_states)
        placed = _placed_bytes(eng.params, eng._paged_states)
        del eng
    _free_card()
    D = mesh.shape["data"]
    whole = _dry_bytes(cfg, "1x1", pages=PAGED_CUT_PAGES, page_size=16,
                       params=False)
    dry_pool = _dry_bytes(cfg, RANK_MESH, pages=PAGED_CUT_PAGES,
                          page_size=16, params=False)
    dry = _dry_bytes(cfg, RANK_MESH, pages=PAGED_CUT_PAGES, page_size=16)
    if not (block == (0, PAGED_CUT_PAGES // D) and pool == dry_pool
            and pool * D == whole and placed == dry):
        fail(f"25b: rank 0 holds pages {block} of {PAGED_CUT_PAGES}, pool "
             f"{pool} B (the dry run's {dry_pool} B, the whole pool "
             f"{whole} B over {D} data ranks), placed {placed} B (the dry "
             f"run's {dry} B)")
    log(f"phase 25b ok: {QWEN} paged engine at published width and depth "
        f"on rank 0 of {RANK_MESH} ({card}; fake collectives): pages "
        f"{block[0]}..{block[0] + block[1] - 1} of {PAGED_CUT_PAGES}, pool "
        f"{pool} B = the dry run's = 1/{D} of {whole} B; params and pool "
        f"{placed} B = the dry run's argument bytes "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"pages": block[1], "pool_bytes": pool, "whole_pool_bytes": whole,
            "placed_bytes": placed, "dry_run_bytes": dry}


# ---------------------------------------------------------------------------
# phase 26: Mellum2's sliding layers on the paged pool
# ---------------------------------------------------------------------------

MELLUM = "mellum2-12b"
MELLUM_WINDOW = 1024
# the decode round of the benchmark's mellum2-12b-edge2 cell: 32 lanes, H
# 32 over KV 4, hd 128, page 16, max_len 3648 -> a 228-page table; lanes
# of 256-3583 tokens (the mix's prompt clip), with the window's edges: a
# lane under it, at it, one past it (its first key at position 1, mid
# page), nine past it, one a page past it
MELLUM_LENS = (256, 1017, 1024, 1025, 1033, 1040, 2048, 3583,
               *(300 + 139 * i for i in range(24)))
MELLUM_ROUND = (32, 32, 4, 128, 16, 1 + 32 * 228, 228, MELLUM_LENS)
# serve.main at full scale: 1100-token prompts, so decode crosses the
# window, two engines of the published size
MELLUM_SERVE_ARGS = ["--arch", MELLUM, "--full-scale", "--edges", "2",
                     "--scheduler", "jsq", "--requests", "8", "--prompt-len",
                     "1100", "--tokens", "32", "--rate", "8", "--device",
                     "cuda"]


def _spike_window_edges(q, kp, vp, tables, lens, window: int) -> None:
    """Make the key on each side of a lane's window edge decide its
    output: in lanes past the window, the first key inside it (even
    lanes) or the last key before it (odd lanes) gets a K along its query
    group's mean query, scaled to take most of the softmax, so a window
    off by one moves the output by O(1), not by one key in 1024."""
    import torch
    Bs, Hs, _ = q.shape
    KVs, ps = kp.shape[1], kp.shape[2]
    G = Hs // KVs
    tbl = tables.cpu()
    for b, n in enumerate(int(x) for x in lens.cpu()):
        if n <= window:
            continue
        j = n - window - (b % 2)
        page, off = int(tbl[b, j // ps]), j % ps
        u = q[b].float().reshape(KVs, G, -1).mean(1)
        k = 24.0 * u / u.norm(dim=-1, keepdim=True)
        kp[page, :, off] = k.to(kp.dtype)
        vp[page, :, off] = torch.full_like(vp[page, :, off], 4.0)


def _window_library_inputs(q, kp, vp, tables, lens, window: int):
    """Each lane's window gathered dense, (B, KV, window, hd), and its
    mask, for SDPA."""
    import torch
    Ps, KVs, ps, hd = kp.shape
    n = lens.long()[:, None]
    pos = (n - window).clamp(min=0) + torch.arange(window, device=q.device)
    valid = pos < n
    pos = torch.where(valid, pos, 0)
    page = torch.gather(tables.long(), 1, pos // ps).clamp(0, Ps - 1)
    k = kp[page, :, pos % ps].permute(0, 2, 1, 3).contiguous()
    v = vp[page, :, pos % ps].permute(0, 2, 1, 3).contiguous()
    return q[:, :, None, :], k, v, valid[:, None, None, :]


def phase_window_decode() -> dict:
    """26a. ``ops.paged_flash_decode_window`` at the mellum2 cell's decode
    round in bf16 and f32, against ``ref.paged_decode_window_ref`` within
    ``TOL`` on live lanes (zero on idle ones), the keys at each window edge
    made to decide the output: the window one shorter, one longer, and no
    window (``paged_flash_decode``) must each miss the plain version by
    more than ``TOL``; its two kernels traced against the split plan over
    min(window, W x ps) positions; its time, the plain version's, SDPA's
    over each lane's window gathered dense beforehand, and its bound (the
    K/V of the positions in each lane's window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    Bs, Hs, KVs, hd, ps, Ps, Ws, lens_t = MELLUM_ROUND
    W = MELLUM_WINDOW
    rows = {}
    for dt in ("bfloat16", "float32"):
        q, kp, vp, tables, lens = paged_decode_case(MELLUM_ROUND,
                                                    getattr(torch, dt))
        _spike_window_edges(q, kp, vp, tables, lens, W)
        before = ops.launches["paged_flash_decode_window"]

        def kernel(w=W):
            return ops.paged_flash_decode_window(q, kp, vp, tables, lens, w)
        got = kernel()
        torch.cuda.synchronize()
        if ops.launches["paged_flash_decode_window"] - before != 1:
            fail(f"26a {dt}: one call counted "
                 f"{ops.launches['paged_flash_decode_window'] - before} "
                 f"launches")
        want = ref.paged_decode_window_ref(q, kp, vp, tables, lens,
                                           W).float()
        live = lens > 0
        err = (got.float() - want)[live].abs().max().item()
        if not err <= TOL[dt]:
            fail(f"26a {dt}: max abs err {err:.3e} > {TOL[dt]:.0e}")
        past = lens > W
        faults = {
            "window_less_one": kernel(W - 1),
            "window_plus_one": kernel(W + 1),
            "no_window": ops.paged_flash_decode(q, kp, vp, tables, lens)}
        fault_err = {k: (v.float() - want)[past].abs().max().item()
                     for k, v in faults.items()}
        if not min(fault_err.values()) > TOL[dt]:
            fail(f"26a {dt}: a wrong window passes the tolerance "
                 f"{TOL[dt]:.0e}: {fault_err}")
        launched = check_split_launches(f"26a {dt}", kernel, Bs, Hs, KVs,
                                        min(W, Ws * ps), ps)
        sq, sk, sv, mask = _window_library_inputs(q, kp, vp, tables, lens, W)
        lib = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                             enable_gqa=True)[:, :, 0]
        lib_err = (lib.float() - want)[live].abs().max().item()
        times = {
            "ms": time_ms(kernel), "eager_ms": eager_ms(kernel),
            "plain_ms": time_ms(lambda: ref.paged_decode_window_ref(
                q, kp, vp, tables, lens, W), iters=10, reps=3),
            "full_length_ms": time_ms(lambda: ops.paged_flash_decode(
                q, kp, vp, tables, lens)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True))}
        size = q.element_size()
        ctx = [min(int(n), W, Ws * ps) for n in lens_t]
        pages = sum(-(-c // ps) + 1 for c in ctx if c)
        nbytes = (2 * q.numel() * size + 2 * sum(ctx) * KVs * hd * size
                  + 4 * pages + 4 * Bs)
        bound_ms, bound_by = bound(nbytes, 4 * sum(ctx) * Hs * hd, dt)
        rows[dt] = {"shape": {"B": Bs, "H": Hs, "KV": KVs, "hd": hd,
                              "ps": ps, "P": Ps, "W": Ws, "window": W,
                              "lens": list(lens_t), "dtype": dt},
                    "max_abs_err": err, "fault_err": fault_err,
                    "library_err": lib_err, **times, "bound_ms": bound_ms,
                    "bound_by": bound_by, "launched": launched,
                    "kernel_launches_per_call": (None if launched is None
                                                 else len(launched))}
        misses = ", ".join(f"{k} {v:.3e}" for k, v in fault_err.items())
        log(f"  26a {dt}: err={err:.3e} (tol {TOL[dt]:.0e}); a wrong window "
            f"misses by {misses}; "
            f"kernel={times['ms']:.4f} ms (eager call "
            f"{times['eager_ms']:.4f}) plain={times['plain_ms']:.4f} "
            f"full length={times['full_length_ms']:.4f} "
            f"sdpa={times['library_ms']:.4f} (err {lib_err:.2e}) "
            f"bound={bound_ms:.6f} ms ({bound_by})")
        del q, kp, vp, tables, lens, got, want, faults, sk, sv, lib
        torch.cuda.empty_cache()
    log("phase 26a ok: paged_flash_decode_window matches "
        "paged_decode_window_ref at the mellum2 cell's round")
    return rows


def phase_window_serve() -> dict:
    """26b. ``serve.main`` at full mellum2-12b width and depth in bf16 (2
    paged engines, 8 requests of 1100-token prompts, JSQ), the launch
    counts set to 0 just before: every request completed, no KV held,
    and after the warm-up ``paged_flash_decode_window`` launched once per
    sliding layer (21) and ``paged_flash_decode`` once per full layer (7)
    a decode round, ``flash_attention`` once per layer (28) a prefill
    chunk; the counts with the warm-up too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config(MELLUM)
    slide = sum(b.window is not None for b in cfg.layer_pattern())
    full = cfg.num_layers - slide
    ops.reset_launches()
    t0 = time.perf_counter()
    st = serve.main(MELLUM_SERVE_ARGS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    if st["completed"] != N_REQUESTS or st["count"] != N_REQUESTS:
        fail(f"26b: {st['completed']} of {N_REQUESTS} requests completed")
    leaks = [e["kv_leak"] for e in st["engines"]]
    if any(leaks) or not all(e["paged"] for e in st["engines"]):
        fail(f"26b: engines {st['engines']}")
    rounds = sum(e["decode_rounds"] for e in st["engines"])
    chunks = sum(e["prefills"] for e in st["engines"])
    want = {"paged_flash_decode_window": slide * rounds,
            "paged_flash_decode": full * rounds,
            "flash_attention": cfg.num_layers * chunks}
    got = {k: st["launches"][k] for k in want}
    if (slide, full) != (21, 7) or not rounds or not chunks or got != want:
        fail(f"26b: launches after warm-up {got}, {slide} sliding and "
             f"{full} full layers over {rounds} rounds and {chunks} chunks "
             f"give {want}")
    others = {k: v for k, v in st["launches"].items()
              if k not in want and v}
    if others:
        fail(f"26b: other kernels launched: {others}")
    with_warmup = {k: ops.launches[k] for k in want}
    log(f"phase 26b ok: {MELLUM} served {N_REQUESTS}/{N_REQUESTS}, "
        f"kv_leak={leaks}; after warm-up {got} = {slide} / {full} / "
        f"{cfg.num_layers} x {rounds} rounds / {chunks} chunks (with "
        f"warm-up {with_warmup}); service mean={st['mean_s'] * 1e3:.1f} ms "
        f"p95={st['p95_s'] * 1e3:.1f} ms over {st['wall_s']:.2f} s "
        f"({total:.1f} s with build and warm-up); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": got, "launches_with_warmup": with_warmup,
            "rounds": rounds, "chunks": chunks}


def main() -> None:
    import torch
    t0 = time.perf_counter()
    card = phase_setup()
    checks = phase_kernel()
    phase_decode_vs_prefill()
    phase_xlstm_decode_vs_forward()
    launches, paged_attn_launches = phase_serve()
    phase_round_breakdown()
    ladn = phase_ladn_kernel()
    p, cfg, f, states, ladn_launches = phase_sim_train()
    phase_task_step_breakdown(p, cfg, f, states)
    eval_launches = phase_sim_eval(p, cfg, f, states)
    live_launches = phase_live_ladts()
    del states
    _free_card()
    attn = phase_flash_attention()
    dec = phase_flash_decode()
    phase_dense_decode_vs_forward()
    _free_card()
    attn_launches, dec_launches, _ = phase_dense_serve("phase 12", RG,
                                                       RG_SERVE_ARGS)
    _free_card()
    phase_dense_round_breakdown("phase 12b", RG, 128)
    _free_card()
    closed = phase_closed_loop()
    _free_card()
    mm_forced = phase_multimodal_decode_vs_forward()
    _free_card()
    mm = {}
    for arch, plen in ((LLAVA, 64), (MUSICGEN, 128)):
        attn_n, dec_n, _ = phase_dense_serve("phase 15", arch,
                                             _mm_serve_args(arch, plen))
        mm[arch] = {"flash_attention": attn_n, "flash_decode": dec_n}
        _free_card()
    phase_dense_round_breakdown("phase 15b", MUSICGEN, 128)
    _free_card()
    chaos = {"16": phase_crash_drill()}
    _free_card()
    chaos["17"] = phase_chaos_serve()
    _free_card()
    chaos["18"] = phase_chaos_bench()
    _free_card()
    chaos["19"] = phase_stress()
    _free_card()
    for k in ("paged_flash_decode", "flash_attention", "flash_decode",
              "ladn_denoise"):
        if not any(v[k] for v in chaos.values()):
            fail(f"{k} never launched in phases 16-19")
    moe_layer = {arch: phase_moe_layer(arch) for arch in (MIXTRAL, DBRX)}
    moe_serve = {}
    for arch in (MIXTRAL, DBRX):
        moe_serve[arch] = phase_moe_serve(arch)
        _free_card()

    train = {"21a": phase_train_grads()}
    _free_card()
    train["21b"] = phase_train_loss_falls()
    _free_card()
    train["21c"] = phase_train_full()
    _free_card()
    train["21d"] = phase_train_moe_mesh()
    _free_card()

    t22 = time.perf_counter()
    tool = {}
    tool["22a"], dry_records = phase_tooling_dryrun(card)
    tool["22b"] = phase_tooling_kernels(card)
    _free_card()
    tool["22c"] = phase_tooling_tablev(card)
    _free_card()
    tool["22d"] = phase_tooling_scheduling(card)
    tool["22e"] = phase_tooling_roofline(card, dry_records)
    tool["seconds"] = time.perf_counter() - t22
    log(f"phase 22 ok in {tool['seconds']:.1f} s")
    place = phase_placement(card)
    t24 = time.perf_counter()
    rank = {"24a": phase_rank_serve()}
    _free_card()
    torch.distributed.destroy_process_group()      # the smoke mesh's
    rank_recs = phase_rank_traces()
    rank["24b"] = phase_rank_attention(rank_recs)
    rank["24c"] = phase_rank_program(card, rank_recs[(LLAVA, "prefill_32k")])
    rank["seconds"] = time.perf_counter() - t24
    log(f"phase 24 ok in {rank['seconds']:.1f} s ({card})")
    t25 = time.perf_counter()
    cut = {"25a": phase_paged_cut_kernels()}
    _free_card()
    cut["25b"] = phase_paged_cut_rank(card)
    cut["seconds"] = time.perf_counter() - t25
    log(f"phase 25 ok in {cut['seconds']:.1f} s ({card})")
    t26 = time.perf_counter()
    win = {"26a": phase_window_decode()}
    _free_card()
    win["26b"] = phase_window_serve()
    _free_card()
    win["seconds"] = time.perf_counter() - t26
    log(f"phase 26 ok in {win['seconds']:.1f} s ({card})")

    def tooling(name):
        """Phase 22's launches of one kernel, and its 22b rows."""
        runs = {"22a": {k: v["launches"].get(name, 0)
                        for k, v in tool["22a"].items()},
                "22c": tool["22c"]["launches"].get(name, 0),
                "22d": tool["22d"]["launches"] if name == "ladn_denoise"
                else 0}
        rows = [{k: r[k] for k in ("shape", "dtype", "us_per_call",
                                   "plain_us", "library_us", "bound_us",
                                   "max_abs_err")}
                for r in tool["22b"] if r["kernel"] == name]
        return {"launches_tooling": runs, "tooling_bench": rows}

    def by_moe_arch(name):
        return {a: v["launches"][name] for a, v in moe_serve.items()}

    def by_phase(name):
        return {ph: v[name] for ph, v in chaos.items()}

    bf = checks["serve"]["bfloat16"]
    act = ladn["act"]
    ladn_shapes = {k: v for k, v in ladn.items()
                   if k not in ("ptxas", "floor_ms")}
    pre = attn["rg_prefill"]
    shapes = {k: v for k, v in attn.items() if k != "ptxas"}
    shapes.update(rank["24b"])          # the 16 x 16 rank-0 shapes
    rnd = dec["rg_round"]
    kernels = [{
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:132",
        "launches": launches,
        "launches_closedloop": closed["paged_flash_decode"],
        "launches_chaos": by_phase("paged_flash_decode"),
        "launches_moe": by_moe_arch("paged_flash_decode"),
        "kernel_launches_per_call": bf["kernel_launches_per_call"],
        "max_abs_err": max(c["bfloat16"]["max_abs_err"]
                           for c in checks.values()),
        "max_abs_err_f32": max(c["float32"]["max_abs_err"]
                               for c in checks.values()),
        "ms": bf["ms"], "eager_ms": bf["eager_ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], "shapes": checks, "check": "ok",
        **tooling("paged_flash_decode")}, {
        "name": "ladn_denoise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ladn_denoise.cu",
        "replaces": "src/repro/kernels/ladn_denoise.py:34",
        "launches": ladn_launches,
        "launches_eval": eval_launches, "launches_live": live_launches,
        "launches_closedloop": closed["ladn_denoise"],
        "launches_chaos": by_phase("ladn_denoise"),
        "max_abs_err": max(v["max_abs_err"] for v in ladn_shapes.values()),
        "ms": act["ms"], "eager_ms": act["eager_ms"],
        "plain_ms": act["plain_ms"], "bound_ms": act["bound_ms"],
        "bound_by": act["bound_by"], "library_ms": None,
        "floor_ms": ladn["floor_ms"],
        **({"ptxas": ladn["ptxas"]} if "ptxas" in ladn else {}),
        # the traced kernel of each shape (null where the trace was
        # incomplete)
        "instantiation": {k: v["launched"] and v["launched"]["kernel"]
                          for k, v in ladn_shapes.items()},
        "shapes": ladn_shapes, "check": "ok",
        **tooling("ladn_denoise")}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": attn_launches,
        "launches_paged_prefill": paged_attn_launches,
        "launches_closedloop": closed["flash_attention"],
        "launches_chaos": by_phase("flash_attention"),
        "launches_moe": by_moe_arch("flash_attention"),
        # phase 15's serve runs (warm-up included) and phase 14's engines
        "launches_multimodal": {a: v["flash_attention"]
                                for a, v in mm.items()},
        "launches_teacher_forced": {a: v["flash_attention"]
                                    for a, v in mm_forced.items()},
        # phase 21's train steps: 21a (f32, 2 layers), 21b (the launcher),
        # 21c (the timed full-scale steps)
        "launches_train": {ph: train[ph]["launches"]
                           for ph in ("21a", "21b", "21c")},
        # phase 24c: rank 0 of 16 x 16, llava x prefill_32k, one prefill
        "launches_rank16": rank["24c"]["launches"]["flash_attention"],
        "max_abs_err": max(v["max_abs_err"] for k, v in shapes.items()
                           if v["shape"]["dtype"] == "bfloat16"),
        "max_abs_err_f32": max(v["max_abs_err"] for k, v in shapes.items()
                               if v["shape"]["dtype"] == "float32"),
        # each query row's max error over its RMS (ROW_TOL), and the
        # smallest reading of a planted fault
        "row_rel_err": max(v["row_rel_err"] for v in shapes.values()
                           if v["shape"]["dtype"] == "bfloat16"),
        "row_rel_err_f32": max(v["row_rel_err"] for v in shapes.values()
                               if v["shape"]["dtype"] == "float32"),
        "fault_row_rel_err": min(v["fault"]["row_rel_err"]
                                 for v in shapes.values()
                                 if v["fault"] is not None),
        **({"ptxas": attn["ptxas"]} if "ptxas" in attn else {}),
        "ms": pre["ms"], "eager_ms": pre["eager_ms"],
        "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
        "shapes": shapes, "check": "ok",
        **tooling("flash_attention")}, {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:48",
        "launches": dec_launches,
        "launches_multimodal": {a: v["flash_decode"] for a, v in mm.items()},
        "launches_chaos": by_phase("flash_decode"),
        "launches_moe": by_moe_arch("flash_decode"),
        "launches_teacher_forced": {a: v["flash_decode"]
                                    for a, v in mm_forced.items()},
        "kernel_launches_per_call": rnd["kernel_launches_per_call"],
        "max_abs_err": max(v["max_abs_err"] for k, v in dec.items()
                           if v["shape"]["dtype"] == "bfloat16"),
        "max_abs_err_f32": max(v["max_abs_err"] for k, v in dec.items()
                               if v["shape"]["dtype"] == "float32"),
        "ms": rnd["ms"], "eager_ms": rnd["eager_ms"],
        "plain_ms": rnd["plain_ms"], "bound_ms": rnd["bound_ms"],
        "bound_by": rnd["bound_by"], "library_ms": rnd["library_ms"],
        "shapes": dec, "check": "ok",
        **tooling("flash_decode")}]
    split = place["23a"]["rg_round"]
    for name, pre, what in (
            ("flash_decode_partials", "partials", "partials_acc"),
            ("decode_merge", "merge", "vs_plain")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/decode_attention.py:110",
            # phase 23c's mesh run (recurrentgemma-9b, warm-up included)
            "launches": place["23c"]["launches"][name],
            "launches_moe": by_moe_arch(name),
            # the merge also ends each paged round of phase 23b's run
            **({"launches_paged": place["23b"]["launches"][name]}
               if name == "decode_merge" else {}),
            "max_abs_err": max(r["max_abs_err"][what] if isinstance(
                r["max_abs_err"], dict) else r["max_abs_err"]
                for r in place["23a"].values()),
            "ms": split[f"{pre}_ms"], "plain_ms": split[f"plain_{pre}_ms"],
            "bound_ms": split[f"{pre}_bound_ms"],
            "bound_by": split[f"{pre}_bound_by"], "library_ms": None,
            "one_call_ms": split["one_call_ms"],
            "shapes": {k: v for k, v in place["23a"].items()},
            "check": "ok"})
    pcut = cut["25a"]["serve_bfloat16"]
    kernels.append({
        "name": "paged_flash_decode_partials", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:220",
        # phase 23b's mesh run (qwen2-1.5b, warm-up included)
        "launches": place["23b"]["launches"][
            "paged_flash_decode_partials"],
        "launches_moe": by_moe_arch("paged_flash_decode_partials"),
        "max_abs_err": max(r["max_abs_err"] for k, r in cut["25a"].items()
                           if k.endswith("bfloat16")),
        "max_abs_err_f32": max(r["max_abs_err"] for k, r in
                               cut["25a"].items() if k.endswith("float32")),
        "ms": pcut["partials_ms"], "plain_ms": pcut["plain_partials_ms"],
        "bound_ms": pcut["partials_bound_ms"],
        "bound_by": pcut["partials_bound_by"], "library_ms": None,
        "merge_ms": pcut["merge_ms"], "one_call_ms": pcut["one_call_ms"],
        "shapes": cut["25a"], "check": "ok"})
    wbf = win["26a"]["bfloat16"]
    kernels.append({
        "name": "paged_flash_decode_window", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        # the port's own (a sliding layer's paged decode): no Pallas kernel
        "replaces": None,
        # phase 26b's mellum2-12b serve run, with and after the warm-up
        "launches": win["26b"]["launches_with_warmup"][
            "paged_flash_decode_window"],
        "launches_after_warmup": win["26b"]["launches"][
            "paged_flash_decode_window"],
        "kernel_launches_per_call": wbf["kernel_launches_per_call"],
        "max_abs_err": wbf["max_abs_err"],
        "max_abs_err_f32": win["26a"]["float32"]["max_abs_err"],
        # the smallest miss of a wrong window (one shorter, one longer,
        # none) against the tolerance
        "fault_err": min(min(r["fault_err"].values())
                         for r in win["26a"].values()),
        "ms": wbf["ms"], "eager_ms": wbf["eager_ms"],
        "plain_ms": wbf["plain_ms"], "bound_ms": wbf["bound_ms"],
        "bound_by": wbf["bound_by"], "library_ms": wbf["library_ms"],
        "full_length_ms": wbf["full_length_ms"], "shapes": win["26a"],
        "check": "ok"})
    log("phase 20: " + json.dumps({"moe_layer": moe_layer, "moe_serve": {
        a: {k: v[k] for k in ("launches", "wall_s", "round", "prefill_rel",
                              "prefill_flips", "prefill_rel_f32")}
        for a, v in moe_serve.items()}}))
    log("phase 21: " + json.dumps(train))
    log("phase 22: " + json.dumps({k: v for k, v in tool.items()
                                   if k not in ("22b",)}))
    log("phase 23: " + json.dumps({k: v for k, v in place.items()
                                   if k != "23a"}))
    log("phase 24: " + json.dumps({k: v for k, v in rank.items()
                                   if k != "24b"}))
    log("phase 25: " + json.dumps({k: v for k, v in cut.items()
                                   if k != "25a"}))
    log("phase 26: " + json.dumps({k: v for k, v in win.items()
                                   if k != "26a"}))
    log(f"kernels line ({time.perf_counter() - t0:.1f} s total)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
