"""What the models and the kernel wrappers tell the dry run's counting
pass (``roofline/analysis.py``); inert outside it.

:func:`trips` lets a Python loop whose iterations run the same ops count
one iteration trip-count times; :func:`kernel_call` makes a kernel's
plain version count as the kernel does on the card (and tells the pass
its shapes).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves


class _Count(threading.local):
    add = None         # the running counting pass's tally callback
    call = None        # its callback for a kernel call's shapes
    shortcut = False   # run one iteration of a :func:`trips` loop
    scale = 1          # the weight of the ops dispatched now
    in_kernel = False  # inside :func:`kernel_call`'s plain version


COUNT = _Count()


def trips(n: int, backward_inside: bool = False):
    """``range(n)`` for a Python loop whose iterations all run the same
    ops.  Under the counting pass with its shortcut on, only iterations
    0 and 1 run, the second weighted n - 1 times: the counts are the
    whole loop's, the values are not (:func:`fill` pads the per-step
    outputs to their shape).  Iteration 1 stands for the rest because
    iteration 0 may meet a constant where the others meet a carried
    state.  While autograd records a body whose backward runs after the
    loop (a recurrence in a differentiable forward), iteration 1's
    autograd nodes carry the weight into the backward too;
    ``backward_inside`` marks a body that takes its own gradients (the
    train step's microbatches)."""
    if not COUNT.shortcut or n <= 2:
        yield from range(n)
        return
    yield 0
    hooks = (_WeightNodes(n - 1) if torch.is_grad_enabled()
             and not backward_inside else contextlib.nullcontext())
    COUNT.scale *= n - 1
    try:
        with hooks:
            yield 1
    finally:
        COUNT.scale //= n - 1


class _WeightNodes(TorchFunctionMode):
    """Weights the backward of every autograd node the ops inside it
    create: a pre-hook multiplies ``COUNT.scale`` by ``w`` and a hook
    divides it back.  Each op's new nodes are those between its outputs'
    ``grad_fn`` and its inputs' (composite ops such as ``einsum`` make
    several)."""

    def __init__(self, w: int):
        super().__init__()
        self.w = w
        self.seen = set()

    def _pre(self, grad_outputs):
        COUNT.scale *= self.w

    def _post(self, grad_inputs, grad_outputs):
        COUNT.scale //= self.w

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        stop = {t.grad_fn for t in _tensors((args, kwargs))}
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if (node is None or node in stop or node in self.seen
                    or type(node).__name__ == "AccumulateGrad"):
                continue
            self.seen.add(node)
            node.register_prehook(self._pre)
            node.register_hook(self._post)
            todo += [nxt for nxt, _ in node.next_functions]
        return out


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def fill(steps: list, n: int) -> list:
    """A loop's per-iteration outputs, the last repeated up to ``n`` when
    :func:`trips` ran fewer iterations (detached: its gradient is the
    weighted iteration's own)."""
    if len(steps) == n:
        return steps
    last = steps[-1].detach() if steps[-1].requires_grad else steps[-1]
    return steps + [last] * (n - len(steps))


def kernel_call(name: str, plain, *args, **kwargs):
    """``plain(*args, **kwargs)``, the plain version of kernel ``name``.
    Under the counting pass its ops count their FLOPs (the reference's
    count) but write nothing: the kernel keeps its intermediates on chip
    and writes only its output, tallied once as ``kernel.<name>``."""
    if COUNT.add is None or COUNT.in_kernel:
        return plain(*args, **kwargs)
    COUNT.in_kernel = True
    try:
        out = plain(*args, **kwargs)
    finally:
        COUNT.in_kernel = False
    outs = out if isinstance(out, tuple) else (out,)
    COUNT.add(f"kernel.{name}", 0,
              sum(t.numel() * t.element_size() for t in outs))
    if COUNT.call is not None:
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        COUNT.call(name, {
            "shapes": [list(t.shape) for t in tensors],
            "dtype": str(tensors[0].dtype).replace("torch.", ""),
            **{k: v for k, v in kwargs.items()
               if v is None or isinstance(v, (bool, int, float))}})
    return out
