#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first that fails:

1. setup: print the card's name and power limit, build every kernel from
   the sources in the checkout, turn TF32 off;
2. each kernel against its plain PyTorch version at the main path's
   shapes, in bf16 and f32, with its time, its bound, the plain version's
   time and one library call's time;
3. decode against prefill on the card: full-width qwen2-1.5b in f32 with
   2 layers serves one request greedily, and a teacher-forced paged
   prefill over the same tokens must pick the same token everywhere;
4. serve: ``repro_torch.launch.serve.main`` at full qwen2-1.5b width and
   depth in bf16 (2 engines, 8 requests), every request completed, no KV
   leak, and the kernel launched once per layer per decode round;
5. the kernels line: one JSON object listing every ported kernel;
6. the last line: ``{"ok": true, "device": {...}}``.

It needs nothing but the checkout: weights are random, drawn from seeds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s and FLOP/s by dtype
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}    # tests/test_kernels.py:45

# main-path shapes of paged_flash_decode under phase 4's serve flags:
# max_lanes 8, qwen2-1.5b heads, page 16, max_len 128 + 32 = 160 ->
# 1 + 4 * 10 pages and a 10 + 4 + 1 wide block table
B, H, KV, HD, PS, P, W = 8, 12, 2, 128, 16, 41, 15
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full-scale", "--edges", "2",
              "--scheduler", "jsq", "--requests", "8", "--prompt-len", "128",
              "--tokens", "32", "--rate", "8", "--device", "cuda"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so Python
    and launch overhead stay out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = _events()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


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
    decode_attention.build()
    info = decode_attention.build_info
    log(f"phase 1 ok: built {os.path.basename(info['path'])} in "
        f"{info['seconds']:.2f} s (cached={info['cached']}); torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "bytes stack" in line:
            log(f"  ptxas: {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------


def _decode_case(dtype, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    # ragged, including a 1-token lane and a full table (W * PS tokens)
    lengths = np.asarray([1, W * PS, 37, 16, 17, 100, 2, 160], np.int32)
    tables = np.stack([rng.permutation(np.arange(1, P))[:W]
                       for _ in range(B)]).astype(np.int32)
    for b, ln in enumerate(lengths):      # unmapped tail: out of range
        n = -(-int(ln) // PS)
        tables[b, n:] = rng.choice([-7, P, P + 1000], size=W - n)
    q = torch.from_numpy(rng.standard_normal((B, H, HD), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, KV, PS, HD), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, KV, PS, HD), np.float32))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev), lengths)


def _sdpa_inputs(q, kp, vp, tables, lens):
    """Dense (B, KV, W*PS, hd) K/V gathered through the tables, and the
    length mask, for the library yardstick."""
    import torch
    tbl = tables.long().clamp(0, P - 1)
    k = kp[tbl].permute(0, 2, 1, 3, 4).reshape(B, KV, W * PS, HD)
    v = vp[tbl].permute(0, 2, 1, 3, 4).reshape(B, KV, W * PS, HD)
    mask = (torch.arange(W * PS, device=q.device)[None, :]
            < lens[:, None].long())[:, None, None, :]
    return q[:, :, None, :], k.contiguous(), v.contiguous(), mask


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    result = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        q, kp, vp, tables, lens, lens_np = _decode_case(dtype)
        got = decode_attention.paged_flash_decode(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        want = ref.paged_decode_ref(q, kp, vp, tables, lens)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[name]:
            fail(f"paged_flash_decode {name}: max abs err {err:.3e} > "
                 f"{TOL[name]:.0e}")
        # a zero-length lane gives zeros
        z = decode_attention.paged_flash_decode(q, kp, vp, tables,
                                                torch.zeros_like(lens))
        if z.abs().max().item() != 0.0:
            fail(f"paged_flash_decode {name}: length-0 lanes not zero")
        def kernel():
            return decode_attention.paged_flash_decode(q, kp, vp, tables,
                                                       lens)
        ms = time_ms(kernel)
        call_ms = eager_ms(kernel)
        plain_ms = time_ms(lambda: ref.paged_decode_ref(q, kp, vp, tables,
                                                        lens))
        sq, sk, sv, mask = _sdpa_inputs(q, kp, vp, tables, lens)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                 enable_gqa=True)[:, :, 0]
        lib_err = (lib_out.float() - want.float()).abs().max().item()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True))
        size = q.element_size()
        ctx = int(sum(min(int(n), W * PS) for n in lens_np))
        nbytes = (2 * q.numel() * size            # q in, out
                  + 2 * ctx * KV * HD * size      # the K and V it needs
                  + tables.numel() * 4 + lens.numel() * 4)
        flops = 4 * ctx * H * HD
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        flops_ms = flops / PEAK_FLOPS[name] * 1e3
        result[name] = {
            "max_abs_err": err, "ms": ms, "eager_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_err": lib_err,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(f"  paged_flash_decode {name}: err={err:.3e} (tol "
            f"{TOL[name]:.0e}) kernel={ms:.4f} ms (eager call "
            f"{call_ms:.4f} ms) plain={plain_ms:.4f} ms "
            f"sdpa={library_ms:.4f} ms (err {lib_err:.2e}) "
            f"bound={result[name]['bound_ms']:.6f} ms "
            f"({result[name]['bound_by']})")
    log(f"phase 2 ok: paged_flash_decode matches paged_decode_ref at "
        f"B={B} H={H} KV={KV} hd={HD} ps={PS} P={P} W={W}")
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


# ---------------------------------------------------------------------------
# phase 4: serve through the port's launcher
# ---------------------------------------------------------------------------


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
    if st["completed"] != 8 or st["count"] != 8:
        fail(f"{st['completed']} of 8 requests completed")
    leaks = [e["kv_leak"] for e in st["engines"]]
    if any(leaks):
        fail(f"KV page leak per engine: {leaks}")
    if any(e["layers"] != 28 for e in st["engines"]):
        fail(f"engines are not full depth: {st['engines']}")
    rounds = sum(e["decode_rounds"] for e in st["engines"])
    want = sum(e["layers"] * e["decode_rounds"] for e in st["engines"])
    got = st["launches"]["paged_flash_decode"]
    if rounds == 0 or got != want:
        fail(f"paged_flash_decode launched {got} times after warm-up, "
             f"expected 28 x {rounds} decode rounds = {want}")
    if launches <= 0:
        fail("paged_flash_decode never launched on the main path")
    log(f"phase 4 ok: 8/8 completed, kv_leak={leaks}, {rounds} decode "
        f"rounds, {got} kernel launches after warm-up ({launches} with "
        f"warm-up); service mean={st['mean_s'] * 1e3:.1f} ms "
        f"p95={st['p95_s'] * 1e3:.1f} ms; {st['tok_s']:.1f} generated "
        f"tok/s over {st['wall_s']:.2f} s of serving ({total:.1f} s with "
        f"build and warm-up); decode ms/token per engine "
        f"{[round(e['token_ms'], 3) for e in st['engines']]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


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
    for rid in range(B):
        eng.admit(Request(rid=rid, max_new_tokens=32,
                          prompt=rng.integers(0, eng.cfg.vocab_size,
                                              (1, 128), dtype=np.int32)))
    for _ in range(3):               # two prefill chunks, then warm rounds
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
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type is not None and "CUDA" in str(evt.device_type):
            us = getattr(evt, "self_device_time_total", 0.0)
            if us > 0:
                by_kernel[evt.key] = us
    enqueue_ms = 1e3 * sum(h[0] for h in host) / rounds
    wall_ms = 1e3 * sum(h[1] for h in host) / rounds
    busy_ms = sum(by_kernel.values()) / 1e3 / rounds
    attn_ms = sum(v for k, v in by_kernel.items()
                  if "paged_decode" in k) / 1e3 / rounds
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    busy = (f"device busy {busy_ms:.2f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.2f}), paged_flash_decode "
            f"{attn_ms:.3f} ms of it" if by_kernel else
            "device busy not measured (the profiler saw no device time)")
    log(f"phase 4b: decode round (8 lanes, 28 layers, bf16): enqueue "
        f"{enqueue_ms:.2f} ms, wall {wall_ms:.2f} ms, {busy}")
    for name, us in top:
        log(f"  device {us / 1e3 / rounds:8.3f} ms/round  {name[:90]}")
    del eng
    torch.cuda.empty_cache()


def main() -> None:
    import torch
    t0 = time.perf_counter()
    phase_setup()
    checks = phase_kernel()
    phase_decode_vs_prefill()
    launches = phase_serve()
    phase_round_breakdown()
    bf = checks["bfloat16"]
    kernels = [{
        "name": "paged_flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:132",
        "launches": launches, "max_abs_err": bf["max_abs_err"],
        "max_abs_err_f32": checks["float32"]["max_abs_err"],
        "ms": bf["ms"], "eager_ms": bf["eager_ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], "check": "ok"}]
    log(f"phase 5: kernels line ({time.perf_counter() - t0:.1f} s total)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
