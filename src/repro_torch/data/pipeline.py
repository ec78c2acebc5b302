"""Synthetic data pipeline for LM training.

Port of ``repro/data/pipeline.py``.  A deterministic, seekable token
source per architecture family: step -> batch is a pure function of
(seed, step), so a restart resumes the same stream.  The draws are the
reference's own numpy draws (``SeedSequence([seed, step])``), so a batch
equals the reference's bit for bit; it is handed over as tensors on the
caller's device.  The modality front ends are stubs, as in the reference:
audio configs get K codebook streams, vision configs seeded patch
embeddings in front of the text with the loss masked to the text.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0


def _rng_for_step(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_batch_np(cfg, dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch of ``step`` as numpy arrays: tokens and labels int32
    (B, S) or (B, K, S) for codebooks; vision configs add patches
    (B, P, vision_dim) f32 and a (B, S) f32 mask, S counting the patches.

    Tokens follow a patterned distribution (a ramp of +3 plus noise) so
    that the CE loss has learnable structure."""
    rng = _rng_for_step(dc.seed, step)
    B, S, V = dc.batch, dc.seq_len, cfg.vocab_size

    def stream(shape):
        base = rng.integers(0, V, size=(shape[0],) + (1,) * (len(shape) - 1))
        ramp = np.cumsum(np.ones(shape, np.int64), axis=-1)
        noise = rng.integers(0, max(V // 64, 2), size=shape)
        return ((base + 3 * ramp + noise) % V).astype(np.int32)

    if cfg.num_codebooks:
        toks = stream((B, cfg.num_codebooks, S + 1))
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.vision_patches:
        text_len = S - cfg.vision_patches
        if text_len <= 1:
            raise ValueError(f"seq_len {S} must exceed the "
                             f"{cfg.vision_patches} vision patches by 2")
        toks = stream((B, text_len + 1))
        patches = rng.standard_normal((B, cfg.vision_patches,
                                       cfg.vision_dim), dtype=np.float32)
        # hidden layout = [patches | text]; labels shifted over the whole
        # sequence, the loss masked to the text (patch targets are undefined)
        labels = np.zeros((B, S), np.int32)
        labels[:, cfg.vision_patches:] = toks[:, 1:]
        mask = np.zeros((B, S), np.float32)
        mask[:, cfg.vision_patches:] = 1.0
        return {"tokens": toks[:, :-1], "patches": patches,
                "labels": labels, "mask": mask}
    toks = stream((B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synth_batch(cfg, dc: DataConfig, step: int,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """:func:`synth_batch_np` as tensors on ``device`` (``cuda`` unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in synth_batch_np(cfg, dc, step).items()}


def batches(cfg, dc: DataConfig, start_step: int = 0,
            device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synth_batch(cfg, dc, step, device)
        step += 1
