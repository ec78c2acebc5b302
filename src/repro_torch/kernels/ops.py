"""Public wrappers around the port's kernels, with launch counters.

Port of ``repro/kernels/ops.py``.  Each wrapper picks by the device of
the tensors it is given: a CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to the hand-written
kernel, or the call raises.  There is no fallback from a failed kernel to
the plain version.

``launches`` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention, ref

launches = {"paged_flash_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Paged flash decode (see ``kernels/decode_attention.py``).

    q (B,H,hd); k/v_pages (P,KV,ps,hd); block_tables (B,W) int32;
    lengths (B,) int32.  Returns (B,H,hd)."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_tables,
                                    lengths)
    out = decode_attention.paged_flash_decode(q, k_pages, v_pages,
                                              block_tables, lengths)
    launches["paged_flash_decode"] += 1
    return out
