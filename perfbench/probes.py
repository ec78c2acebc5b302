"""The harness's instruments, wrapped around the port's calls from
outside: nothing in the port is edited.

* always: each LAD-TS placement's observation, draws, the kernel's x_0
  and the action, kept by reference for the check;
* with ``timing``: host time of every call to the paged prefill and
  decode step callables made in the window (the factories in
  ``serving/compiled.py`` are wrapped before the engines are built; the
  warm-up's calls, which capture the CUDA graphs and in a checkout's
  first run build the kernels, are set-up and not kept), and, inside the profiled
  sub-window, the shapes of every ``flash_attention`` and
  ``paged_flash_decode`` call and a ``pb:<phase>`` range around each
  host phase (placement, admission, prefill enqueue, decode enqueue,
  collect, waiting for an arrival) for the trace to name idle gaps by.

A reader's hooks (``harness.reader_hooks``) add their own instruments
the same way, and :meth:`restore` undoes them with the rest.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import torch

class Probes:
    def __init__(self, timing: bool):
        self.timing = bool(timing)
        self.profiling = False
        self.prefill: List[tuple] = []     # (perf_counter, seconds, traced)
        self.decode: List[tuple] = []
        self.attn: List[tuple] = []        # flash_attention shapes, traced
        self.paged: List[tuple] = []       # paged_flash_decode, traced
        self.placements: List[dict] = []
        self.recording = False
        self._x0 = None
        self._undo: List[Callable[[], None]] = []

    # ------------------------------------------------------------------
    def phase(self, name: str):
        """A ``pb:<name>`` range in the profile while it records."""
        if self.profiling:
            return torch.profiler.record_function(f"pb:{name}")
        return contextlib.nullcontext()

    def _patch(self, obj, name: str, new) -> None:
        old = getattr(obj, name)
        setattr(obj, name, new)
        self._undo.append(lambda: setattr(obj, name, old))

    def on_restore(self, undo: Callable[[], None]) -> None:
        """Have :meth:`restore` call ``undo`` (a reader's hook that
        changes the program's state other than by :meth:`_patch`)."""
        self._undo.append(undo)

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _timed(self, fn, sink: List[tuple], label: str):
        def call(*args, **kw):
            traced, kept = self.profiling, self.recording
            t = time.perf_counter()
            with self.phase(label):
                out = fn(*args, **kw)
            if kept:
                sink.append((t, time.perf_counter() - t, traced))
            return out
        return call

    # ------------------------------------------------------------------
    def install_steps(self) -> None:
        """Wrap the paged step factories, so each engine built after this
        gets timed callables (timing runs only)."""
        if not self.timing:
            return
        from repro_torch.serving import compiled
        pre, dec = compiled.paged_prefill_step, compiled.paged_decode_step
        self._patch(compiled, "paged_prefill_step",
                    lambda *a, **k: self._timed(pre(*a, **k), self.prefill,
                                                "prefill enqueue"))
        self._patch(compiled, "paged_decode_step",
                    lambda *a, **k: self._timed(dec(*a, **k), self.decode,
                                                "decode enqueue"))

    def install_kernels(self) -> None:
        """Record the attention kernels' shapes while the profile runs
        (timing runs only)."""
        if not self.timing:
            return
        from repro_torch.kernels import ops
        fa, pd = ops.flash_attention, ops.paged_flash_decode

        def flash_attention(q, k, v, *, causal=True, window=None,
                            q_offset=0):
            if self.profiling:
                self.attn.append((q.shape[0], q.shape[1], k.shape[1],
                                  q.shape[2], k.shape[2], q.shape[3],
                                  window, int(q_offset), q.element_size()))
            return fa(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)

        def paged_flash_decode(q, k_pages, v_pages, block_tables, lengths):
            if self.profiling:
                # ``lengths`` is a fresh tensor of every call: read after
                # the window
                self.paged.append((q.shape[0], q.shape[1], k_pages.shape[1],
                                   q.shape[2], k_pages.shape[2],
                                   block_tables.shape[1], lengths,
                                   q.element_size()))
            return pd(q, k_pages, v_pages, block_tables, lengths)

        self._patch(ops, "flash_attention", flash_attention)
        self._patch(ops, "paged_flash_decode", paged_flash_decode)

    def install_engines(self, engines) -> None:
        """Phase ranges around each engine's dispatch and collect."""
        if not self.timing:
            return
        for e in engines:
            for name, label in (("dispatch", "admission"),
                                ("collect", "collect")):
                fn = getattr(e, name)
                self._patch(e, name, self._ranged(fn, label))

    def _ranged(self, fn, label: str):
        def call(*args, **kw):
            with self.phase(label):
                return fn(*args, **kw)
        return call

    def install_scheduler(self, scheduler) -> None:
        """Keep every placement's inputs and outputs for the check (the
        tensors are fresh at each call and never written later, so they
        are kept by reference: no copy, no launch)."""
        from repro_torch.kernels import ops
        denoise = ops.ladn_denoise

        def ladn_denoise(*args, **kw):
            out = denoise(*args, **kw)
            self._x0 = out[0]
            return out

        self._patch(ops, "ladn_denoise", ladn_denoise)
        fns = scheduler._fns
        act = fns.act

        def recorded_act(state, s, n, generator=None, noise=None,
                         greedy=False):
            self._x0 = None
            a, x_used, new = act(state, s, n, generator=generator,
                                 noise=noise, greedy=greedy)
            if self.recording:
                self.placements.append({
                    "s": s, "eps0": noise["chain"].eps0,
                    "chain": noise["chain"].chain,
                    "gumbel": noise["gumbel"], "x0": self._x0, "a": a})
            return a, x_used, new

        self._patch(scheduler, "_fns", fns._replace(act=recorded_act))
