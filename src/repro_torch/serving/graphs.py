"""The paged steps replayed from CUDA graphs cut at the attention kernels.

A paged prefill chunk or decode round is about a hundred small operations
a layer, and on a busy engine the host's time to enqueue them, not the
device's time to run them, paces the step.  On a CUDA device outside a
mesh, :class:`PiecewiseStep` runs the forward as L + 1 captured segments
(``models.transformer.paged_segment``) with each layer's attention kernel
called eagerly between two replays:

* ``ops.flash_attention`` takes the chunk's start as a launch argument
  and plans its tiles from it, so a graph holding it would freeze one
  start; each layer's kernel is called with that layer's window (a
  windowed layer's decode through ``ops.paged_flash_decode_window``);
* the kernels stay Python calls of ``ops``, so ``ops.launches`` counts
  them, and a wrapper installed on ``ops`` sees every call, as in an
  eager step.

The segments read the step's inputs from static buffers and hand the
kernel's inputs on through buffers of their own; the kernel's output is
copied into one before the next replay.  The residual stream goes from
one segment to the next in the graphs' shared memory pool, as it would
inside one graph: nothing between two replays allocates from that pool.
A call replays the graphs captured for its params and page pools (keyed
on the tensors' storage, so engines that share this callable each get
theirs) and shapes; the first such call runs the segments eagerly on a
side stream (the call's result, and the warm-up the capture needs), then
captures them.  Token picking stays outside the graphs.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.launch import sharding
from repro_torch.models import attention, transformer
from repro_torch.train.steps import pick_tokens

_INPUTS = {"paged_prefill": ("tokens", "block_table"),
           "paged_decode": ("tokens", "block_tables", "lengths")}


def _leaves(tree, out: list) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order: a
    plain walk, in a third of ``core.optim.tree_leaves``'s time."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return out
    for v in (tree.values() if isinstance(tree, dict) else tree):
        _leaves(v, out)
    return out


class PagedPieces:
    """One call shape's segments over static buffers: the step's inputs
    (a chunk's ``start`` a 0-d int32), the kernel's inputs (copied in at
    the end of each segment), its output (copied in after it) and the
    logits.  Holds no params and no pools."""

    def __init__(self, cfg, mode: str, batch: dict):
        self.cfg, self.mode = cfg, mode
        self.windows = [blk.window for blk in cfg.layer_pattern()]
        self.L = len(self.windows)
        self.inputs = {n: torch.empty_like(batch[n]) for n in _INPUTS[mode]}
        if mode == "paged_prefill":
            self.inputs["start"] = torch.zeros(
                (), dtype=torch.int32, device=batch["tokens"].device)
        self.x = None              # the residual stream, segment to segment
        self.args = None           # the kernel's inputs, made on first use
        self.o = None              # the kernel's output
        self.out = None
        self.graphs = []

    def segment(self, params, states, i: int) -> None:
        """Segment ``i`` from the buffers into the buffers.  Under capture
        the previous segment's residual stream is freed here, into the
        pool, once this segment has read it."""
        res = transformer.paged_segment(params, self.cfg, self.inputs,
                                        self.mode, states, i, self.x, self.o)
        if i == self.L:
            self.x, self.out = None, res
            return
        self.x, args = res
        if self.args is None:
            self.args = [torch.empty_like(t) for t in args]
        for buf, t in zip(self.args, args):
            buf.copy_(t)

    def run(self, params, states, batch: dict,
            segment: Optional[Callable[[int], None]] = None
            ) -> torch.Tensor:
        """The step on ``batch``: its inputs copied in, then segment 0 and
        after each layer's kernel the next segment, each run by
        ``segment(i)`` (eagerly when None).  Returns the logits buffer."""
        if segment is None:
            def segment(i):
                self.segment(params, states, i)
        for name in _INPUTS[self.mode]:
            self.inputs[name].copy_(batch[name])
        if self.mode == "paged_prefill":
            start = int(batch["start"])
            self.inputs["start"].fill_(start)
        else:
            # fresh each round: a kernel's wrapper may keep it
            n = self.inputs["lengths"] + 1
        for i in range(self.L):
            segment(i)
            if self.mode == "paged_prefill":
                o = attention.paged_chunk_attend(*self.args, start,
                                                 self.windows[i])
            else:
                o = attention.paged_decode_attend(
                    *self.args, states[i], self.inputs["block_tables"], n,
                    self.windows[i])
            if self.o is None:
                self.o = torch.empty_like(o)
            self.o.copy_(o)
        segment(self.L)
        return self.out


class PiecewiseStep:
    """``eager`` (``train.steps.make_paged_prefill_step`` or
    ``make_paged_decode_step``'s callable for ``cfg``), with the same
    signature and results, replayed from :class:`PagedPieces`' graphs
    wherever the call allows: CUDA tensors, no mesh, a non-empty batch,
    no capture already under way.  Any other call runs ``eager``.

    ``counts`` holds the calls that captured, replayed and ran eagerly;
    each call also sets ``graph`` ("capture", "replay" or "eager") on the
    innermost open tracing span.  A capture is dropped when any of its
    params or pools is freed."""

    def __init__(self, cfg, mode: str, eager: Callable, sample: bool = False,
                 temperature: float = 1.0):
        self.cfg, self.mode, self.eager = cfg, mode, eager
        self.sample, self.temperature = sample, temperature
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._pieces: Dict[tuple, PagedPieces] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __call__(self, params, batch, states, generator=None):
        key = self._key(params, batch, states)
        if key is None:
            use = "eager"
            args = (params, batch, states)
            if self.mode == "paged_decode":
                args += (generator,)
            out = self.eager(*args)
        else:
            pieces = self._pieces.get(key)
            with torch.no_grad(), torch.cuda.device(key[0]):
                if pieces is None:
                    use, logits = "capture", self._capture(key, params,
                                                           batch, states)
                else:
                    use = "replay"
                    pieces.run(params, states, batch,
                               lambda i: pieces.graphs[i].replay())
                    logits = pieces.out.clone()
            if self.mode == "paged_prefill":
                out = logits, states
            else:
                out = logits, pick_tokens(logits, self.sample,
                                          self.temperature, generator), states
        self.counts["eager" if use == "eager" else use + "s"] += 1
        tracing.note(graph=use)
        return out

    def _key(self, params, batch, states) -> Optional[tuple]:
        """None for a call that runs eagerly; else what its graphs bake
        in: the input shapes and dtypes, and the params' and pools'
        storage."""
        tok = batch["tokens"]
        if (tok.device.type != "cuda" or tok.numel() == 0
                or sharding.current() is not None
                or torch.cuda.is_current_stream_capturing()):
            return None
        shapes = tuple((tuple(batch[n].shape), batch[n].dtype)
                       for n in _INPUTS[self.mode])
        return (tok.device, shapes, *(t.data_ptr()
                                      for t in self._tensors(params, states)))

    @staticmethod
    def _tensors(params, states) -> list:
        return _leaves((params, states), [])

    def _capture(self, key, params, batch, states) -> torch.Tensor:
        """Run the segments eagerly on a side stream (the call's logits),
        then capture each into one memory pool there."""
        pieces = PagedPieces(self.cfg, self.mode, batch)
        cur = torch.cuda.current_stream()
        side = self._streams.get(cur.device)
        if side is None:
            side = self._streams[cur.device] = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            logits = pieces.run(params, states, batch)
            pool = torch.cuda.graph_pool_handle()
            for i in range(pieces.L + 1):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                try:
                    pieces.segment(params, states, i)
                finally:
                    g.capture_end()
                pieces.graphs.append(g)
        cur.wait_stream(side)
        self._pieces[key] = pieces
        for t in self._tensors(params, states):
            weakref.finalize(t, self._pieces.pop, key, None)
        return logits
