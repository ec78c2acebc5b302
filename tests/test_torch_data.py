"""Port data pipeline against the reference's: the same numpy draws give
the same batches bit for bit (text, codebook and patch configs over
several steps), and the reference's own pipeline cases on the port."""
import numpy as np
import pytest
import torch

from _torch_parity import configs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synth_batch as jax_synth_batch
from repro_torch.data.pipeline import (DataConfig, batches, synth_batch,
                                       synth_batch_np)

ARCHS = ["qwen2-1.5b", "musicgen-large", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_reference_bit_for_bit(arch, seed):
    jcfg, tcfg = configs(arch=arch)
    for step in (0, 1, 5, 999):
        want = jax_synth_batch(jcfg, JDataConfig(batch=3, seq_len=40,
                                                 seed=seed), step)
        got = synth_batch(tcfg, DataConfig(batch=3, seq_len=40, seed=seed),
                          step, "cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].device.type == "cpu"
            assert got[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v)


def test_batches_iterates_from_a_start_step():
    _, tcfg = configs()
    dc = DataConfig(batch=2, seq_len=16)
    it = batches(tcfg, dc, start_step=3, device="cpu")
    for step in (3, 4, 5):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      synth_batch_np(tcfg, dc, step)["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_shapes_and_determinism(arch):
    _, cfg = configs(arch=arch)
    dc = DataConfig(batch=2, seq_len=64)
    b1 = synth_batch(cfg, dc, 3, "cpu")
    b2 = synth_batch(cfg, dc, 3, "cpu")
    b3 = synth_batch(cfg, dc, 4, "cpu")
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert int((b1["tokens"] - b3["tokens"]).abs().max()) > 0
    assert int(b1["tokens"].max()) < cfg.vocab_size
    if cfg.vision_patches:
        assert b1["patches"].shape == (2, cfg.vision_patches,
                                       cfg.vision_dim)
        assert float(b1["mask"][:, :cfg.vision_patches].max()) == 0.0
    if cfg.num_codebooks:
        assert b1["tokens"].shape == (2, cfg.num_codebooks, 64)


def test_synth_batch_is_learnable_structure():
    """The ramp pattern makes next-token entropy lower than uniform."""
    _, cfg = configs()
    toks = synth_batch(cfg, DataConfig(batch=4, seq_len=128), 0,
                       "cpu")["tokens"].numpy()
    diffs = np.diff(toks, axis=1) % cfg.vocab_size
    assert (np.abs(diffs - 3) < cfg.vocab_size // 32).mean() > 0.5


def test_vision_batch_needs_text_after_the_patches():
    _, cfg = configs(arch="llava-next-mistral-7b")
    with pytest.raises(ValueError, match="must exceed"):
        synth_batch_np(cfg, DataConfig(batch=1,
                                       seq_len=cfg.vision_patches + 1), 0)
