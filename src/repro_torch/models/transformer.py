"""Unified decoder: attention, RG-LRU and xLSTM blocks, dense or MoE
feed-forwards, dense and paged modes.

Port of ``repro/models/transformer.py`` for stacks of attention, RG-LRU,
mLSTM or sLSTM mixers with dense MLPs, MoE FFNs or none (``ffn="none"``:
xLSTM blocks carry their own projections).  Params keep the reference's keys
and ``(in, out)`` layout, except that layers are one flat list
(``params["layers"][i]``) where the reference may stack them for
``lax.scan``; ``repro_torch.convert.params_from_jax`` unstacks.  Layer
states are a flat list too, one dict per layer, each with a leading
batch (slot) axis and a per-row ``pos`` (B,) int32.

Forward modes: ``train`` (hidden states, differentiable; the loss is in
``repro_torch.train.losses``), ``prefill``, ``decode``, ``paged_prefill``
and ``paged_decode``.  The modality front ends are stubs, as in the
reference: audio configs (``num_codebooks``) take K codebook token
streams (B, K, S), sum their embeddings and have one head per codebook;
vision configs take patch embeddings (B, P, vision_dim) through the
projector, placed in front of the text.  MoE blocks (``ffn="moe"``,
``repro_torch.models.moe``) route each token to its top-k experts; every
mode returns the summed load-balance ``aux`` term (0 without MoE).  In
``decode`` mode each row is its own MoE routing group, as each slot is
its own batch-1 decode under the reference's ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import sharding
from repro_torch.models import attention, moe, rglru, xlstm
from repro_torch.models.layers import (apply_mlp, dense_init, init_mlp,
                                       init_rmsnorm, rmsnorm,
                                       sinusoidal_positions)


_MIXERS = ("attn", "rglru", "mlstm", "slstm")
_FFNS = ("dense", "moe", "none")


def _check_block(blk) -> None:
    if blk.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {blk.mixer!r}; options {_MIXERS}")
    if blk.ffn not in _FFNS:
        raise ValueError(f"unknown feed-forward {blk.ffn!r}; options "
                         f"{_FFNS}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


_INIT_MIXER = {"attn": attention.init_attention, "rglru": rglru.init_rglru,
               "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}


def _init_block(generator, cfg, blk, dtype, device) -> dict:
    """norm1 and the mixer, then norm2 and the MLP or the MoE unless
    ``ffn="none"`` (the reference leaves both out there too)."""
    _check_block(blk)
    p = {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
         "mixer": _INIT_MIXER[blk.mixer](generator, cfg, dtype, device)}
    if blk.ffn == "dense":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                            dtype, device)
    elif blk.ffn == "moe":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ffn"] = moe.init_moe(generator, cfg, dtype, device)
    return p


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random params drawn from ``generator`` (a generator on ``device``).
    Audio configs stack one embedding (K, V, d) and one head (K, d, V) per
    codebook; vision configs add the projector {w_proj (vision_dim, d),
    w_up (d, d)}."""
    dtype = getattr(torch, cfg.dtype)

    def table(in_dim, out_dim):
        if not cfg.num_codebooks:
            return dense_init(generator, in_dim, out_dim, dtype, device)
        return torch.stack([dense_init(generator, in_dim, out_dim, dtype,
                                       device)
                            for _ in range(cfg.num_codebooks)])

    params: Dict[str, Any] = {
        "embed": {"embed": table(cfg.vocab_size, cfg.d_model)},
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cfg.vision_patches:
        params["projector"] = {
            "w_proj": dense_init(generator, cfg.vision_dim, cfg.d_model,
                                 dtype, device),
            "w_up": dense_init(generator, cfg.d_model, cfg.d_model, dtype,
                               device)}
    if not cfg.tie_embeddings:
        params["head"] = {"head": table(cfg.d_model, cfg.vocab_size)}
    params["layers"] = [_init_block(generator, cfg, blk, dtype, device)
                        for blk in cfg.layer_pattern()]
    return params


def abstract_params(cfg, fake_mode=None) -> dict:
    """The params of ``cfg`` as fake CPU tensors of ``fake_mode`` (a new
    ``FakeTensorMode`` unless given): the reference's ``jax.eval_shape``
    of ``init_params``, shapes and dtypes with no storage.  Run a step on
    them inside the same mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mode or FakeTensorMode():
        return init_params(cfg, torch.Generator(device="cpu"),
                           torch.device("cpu"))


def init_layer_states(cfg, batch: int, max_len: int, device: torch.device,
                      filled_pos: Optional[int] = None) -> List[dict]:
    """Empty per-layer states with a leading batch (slot) axis: dense
    K/V rings (``attention.init_kv_cache``), RG-LRU, mLSTM or sLSTM
    states, each with a ``pos`` (batch,) int32.

    ``filled_pos`` stamps a token count for a decode of the whole batch
    at one depth (the dry run pretends a ``max_len``-deep cache is
    already written): each ``pos`` is then one 0-d int32 shared by every
    row, the reference's layout, which the decode forward broadcasts."""
    states = []
    for blk in cfg.layer_pattern():
        _check_block(blk)
        if blk.mixer == "attn":
            states.append(attention.init_kv_cache(cfg, blk, batch, max_len,
                                                  device))
        elif blk.mixer == "rglru":
            states.append(rglru.init_rglru_state(cfg, batch, device))
        elif blk.mixer == "mlstm":
            states.append(xlstm.init_mlstm_state(cfg, batch, device))
        else:
            states.append(xlstm.init_slstm_state(cfg, batch, device))
    if filled_pos is not None:
        for st in states:
            st["pos"] = torch.tensor(filled_pos, dtype=torch.int32,
                                     device=device)
    return states


def init_paged_states(cfg, num_pages: int, page_size: int,
                      device: torch.device) -> List[dict]:
    """One (num_pages, KV, page_size, hd) k/v pool per layer."""
    states = []
    for blk in cfg.layer_pattern():
        if blk.mixer != "attn":
            raise ValueError(
                f"paged serving requires attention mixers, got {blk.mixer}")
        states.append(attention.init_paged_kv_cache(cfg, blk, num_pages,
                                                    page_size, device))
    return states


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


# the recurrent mixers' (decode step, prompt scan)
_RECURRENT = {"rglru": (rglru.rglru_step, rglru.rglru_scan),
              "mlstm": (xlstm.mlstm_step, xlstm.mlstm_scan),
              "slstm": (xlstm.slstm_step, xlstm.slstm_scan)}


def _apply_block(cfg, blk, p, x, positions, state, mode, max_len=None,
                 paged=None):
    """Returns (x_out, new_state, aux); ``new_state`` is None in train
    mode and ``aux`` is None unless the block is MoE.  ``max_len`` sizes
    prefill's caches and, on a mesh, tells decode its rings' size."""
    _check_block(blk)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    new_state = None
    if mode in ("paged_prefill", "paged_decode") and blk.mixer != "attn":
        raise ValueError(
            f"paged serving requires attention mixers, got {blk.mixer}")
    if blk.mixer != "attn":
        step, scan = _RECURRENT[blk.mixer]
        if mode == "decode":
            mix, new_state = step(p["mixer"], cfg, h, state)
        elif blk.mixer == "rglru":
            # a train forward keeps no state (on a mesh: no gather of it)
            mix, new_state = scan(p["mixer"], cfg, h,
                                  use_assoc_scan=cfg.use_assoc_scan,
                                  with_state=mode != "train")
        else:
            mix, new_state = scan(p["mixer"], cfg, h)
    elif mode == "train":
        mix = attention.attend_train(p["mixer"], cfg, blk, h, positions)
    elif mode == "prefill":
        mix, new_state = attention.prefill(p["mixer"], cfg, blk, h,
                                           positions, max_len=max_len)
    elif mode == "decode":
        mix, new_state = attention.decode(p["mixer"], cfg, blk, h, state,
                                          max_len=max_len)
    elif mode == "paged_prefill":
        mix, new_state = attention.paged_prefill_chunk(
            p["mixer"], cfg, blk, h, state, paged["block_table"],
            paged["start"], num_pages=paged["num_pages"])
    else:
        mix, new_state = attention.paged_decode(
            p["mixer"], cfg, blk, h, state, paged["block_tables"],
            paged["lengths"], num_pages=paged["num_pages"])
    x, aux = _feed_forward(cfg, blk, p, x + mix, mode)
    return x, new_state, aux


def _feed_forward(cfg, blk, p, x, mode):
    """The block's residual feed-forward after its mixer: (x_out, aux),
    ``aux`` None unless the block is MoE."""
    if blk.ffn == "none":
        return x, None
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if blk.ffn == "dense":
        return x + apply_mlp(p["ffn"], h2, cfg.d_ff), None
    # a decode row is one slot's batch-1 decode in the reference; a step
    # whose rows are split over ranks routes the gathered rows
    groups = x.shape[0] * sharding.batch_ranks() if mode == "decode" else 1
    y, aux = moe.apply_moe(p["ffn"], cfg, h2, groups=groups)
    return x + y, aux


# ---------------------------------------------------------------------------
# embeddings & heads
# ---------------------------------------------------------------------------


def _embedding(emb: torch.Tensor, cfg):
    """(table, lookup(table, ids), vocab-parallel) for the embedding
    ``emb``.  On a mesh whose "model" ranks cut the vocabulary, the table
    is this rank's rows [j V / M, (j + 1) V / M) (FSDP's "data" cut
    gathered); the lookup takes the ids in its range and gives zeros for
    the rest, and the caller sums the partial embeddings over "model".
    Otherwise the whole table and a plain row lookup."""
    ctx = sharding.current()
    if ctx is None:
        return emb, (lambda t, ids: t[ids]), False
    V, d = cfg.vocab_size, cfg.d_model
    shape = (cfg.num_codebooks, V, d) if cfg.num_codebooks else (V, d)
    vocab = sharding.splits("embed", shape)
    table = sharding.weight(emb, "embed", shape,
                            keep=("model",) if vocab else (), role="vocab")
    if not vocab:
        return table, (lambda t, ids: t[ids]), False
    Vl = table.shape[-2]
    lo = ctx.mesh.local_rank("model") * Vl

    def lookup(t, ids):
        local = ids - lo
        ok = (local >= 0) & (local < Vl)
        return t[local.clamp(0, Vl - 1)] * ok[..., None].to(t.dtype)

    return table, lookup, True


def embed_inputs(params, cfg, inputs: dict, pos_offset) -> torch.Tensor:
    """tokens (B, S) or (B, K, S) codebook streams -> (B, S', d).

    Codebook embeddings are summed in codebook order; vision patches
    (B, P, vision_dim) go through ``gelu(patches @ w_proj) @ w_up`` in
    f32 (the reference promotes f32 patches times model-dtype weights to
    f32) and are put in front of the text, S' = P + S.  Without RoPE the
    f32 sinusoidal table of positions ``pos_offset + arange(S')`` is
    added in the model dtype; ``pos_offset`` is an int or (B, 1)."""
    sharding.locate("embed")
    toks = inputs["tokens"].long()
    emb, lookup, vocab = _embedding(params["embed"]["embed"], cfg)
    if cfg.num_codebooks:
        x = lookup(emb[0], toks[:, 0])
        for k in range(1, cfg.num_codebooks):
            x = x + lookup(emb[k], toks[:, k])
    else:
        x = lookup(emb, toks)
    if vocab:
        x = sharding.reduce(x, sharding.current().mesh, ("model",))
    if cfg.vision_patches and inputs.get("patches") is not None:
        pr = params["projector"]
        d, dv = cfg.d_model, cfg.vision_dim
        w_proj = sharding.weight(pr["w_proj"], "w_proj", (dv, d))
        w_up = sharding.weight(pr["w_up"], "w_up", (d, d))
        pe = F.gelu(inputs["patches"].float() @ w_proj.float(),
                    approximate="tanh") @ w_up.float()
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    if not cfg.use_rope:
        pos = pos_offset + torch.arange(x.shape[1], device=x.device)
        pe = sinusoidal_positions(pos, cfg.d_model)
        x = x + pe.to(x.dtype)
    return x


def apply_head(params, cfg, x, whole: bool = False) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V), or (B, S, K, V) for codebooks.

    On a mesh whose "model" ranks cut the vocabulary of the head (or of
    the tied embedding), each rank computes its vocabulary slice of the
    logits and the slices are all-gathered over "model"; with ``whole``
    (the train loss) the head's shards are gathered first and every rank
    computes every logit."""
    sharding.locate("head")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    ctx = sharding.current()
    if ctx is None:
        if cfg.tie_embeddings:
            return x @ params["embed"]["embed"].T
        if cfg.num_codebooks:
            return torch.einsum("bsd,kdv->bskv", x, params["head"]["head"])
        return x @ params["head"]["head"]
    V, d, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks
    if cfg.tie_embeddings:
        name, w = "embed", params["embed"]["embed"]
        shape = (K, V, d) if K else (V, d)
    else:
        name, w = "head", params["head"]["head"]
        shape = (K, d, V) if K else (d, V)
    tp = sharding.splits(name, shape) and not whole
    mesh = ctx.mesh
    if tp:
        x = sharding.enter(x, mesh, ("model",))
    w = sharding.weight(w, name, shape, keep=("model",) if tp else ())
    if cfg.tie_embeddings:
        w = w.transpose(-1, -2)
    logits = (torch.einsum("bsd,kdv->bskv", x, w) if K else x @ w)
    if tp:
        logits = sharding.all_gather(logits, mesh, "model", -1,
                                     sum_grads=False)
    return logits


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


MODES = ("train", "prefill", "decode", "paged_prefill", "paged_decode")


def forward(params, cfg, inputs: dict, mode: str,
            states: Optional[List[dict]] = None,
            max_len: Optional[int] = None) -> dict:
    """Run the model.

    train         : inputs {tokens (B,S)[, patches]}
                                                 -> {hidden, aux}
    prefill       : inputs {tokens (B,S)[, patches]}
                                                 -> {last_logits, states,
                                                     aux}
    decode        : inputs {tokens (B,1)} + states (each row at its own
                    ``pos``)                     -> {logits, states, aux}
    paged_prefill : inputs {tokens (1,C), start int, block_table (W,)}
                    + paged states               -> {chunk_logits, states,
                                                     aux}
    paged_decode  : inputs {tokens (B,1), block_tables (B,W) int32,
                    lengths (B,) int32} + states -> {logits, states, aux}
                    (both paged modes take ``num_pages``, the whole
                    pool's size, where a mesh's data ranks may cut it)

    ``aux`` is the f32 sum of the MoE layers' load-balance terms (0
    without MoE; in decode mode each layer's term is the mean of its
    rows').  Audio configs take tokens (B, K, S) and give logits
    (..., K, V).
    ``max_len`` sizes prefill's caches (patches included).  Decode writes
    the dense K/V caches in place, and the paged modes the pools.

    ``train`` runs under the caller's grad mode, and with ``cfg.remat``
    checkpoints each block (``torch.utils.checkpoint``) when grad is on;
    the serving modes run under ``torch.no_grad()``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown forward mode {mode!r}; options {MODES}")
    if mode == "train":
        return _forward(params, cfg, inputs, mode, states, max_len)
    with torch.no_grad():
        return _forward(params, cfg, inputs, mode, states, max_len)


def _remat_block(cfg, blk, p, x, positions):
    """One train-mode block under ``torch.utils.checkpoint``: only its
    input is kept, and the backward recomputes it inside the sharding
    context of the forward (the MoE layer reads it)."""
    ctx = sharding.current()

    tag = ctx.where if ctx is not None else ""

    def run(p_, x_):
        with sharding.use(ctx):
            sharding.locate(tag)
            out, _, a = _apply_block(cfg, blk, p_, x_, positions, None,
                                     "train")
        return out, a

    return checkpoint(run, p, x, use_reentrant=False)


def _forward(params, cfg, inputs, mode, states, max_len) -> dict:
    paged = None
    pos_offset = 0
    if mode == "paged_prefill":
        paged = {"block_table": inputs["block_table"],
                 "start": int(inputs["start"]),
                 "num_pages": inputs.get("num_pages")}
        pos_offset = paged["start"]
    elif mode == "paged_decode":
        paged = {"block_tables": inputs["block_tables"],
                 "lengths": inputs["lengths"],
                 "num_pages": inputs.get("num_pages")}
        pos_offset = inputs["lengths"][:, None]
    elif mode == "decode":
        # each row's own position, where the reference vmaps a scalar; a
        # 0-d pos (``init_layer_states(filled_pos=)``) is every row's
        B = inputs["tokens"].shape[0]
        states = [dict(st, pos=st["pos"].expand(B)) if st["pos"].dim() == 0
                  else st for st in states]
        pos_offset = states[0]["pos"][:, None]
    x = embed_inputs(params, cfg, inputs, pos_offset)
    positions = None
    if mode in ("train", "prefill"):
        positions = torch.arange(x.shape[1], device=x.device)
    new_states = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for i, (blk, p) in enumerate(zip(cfg.layer_pattern(), params["layers"])):
        st = states[i] if states is not None else None
        sharding.locate(f"layers.{i}")
        if remat:
            (x, a), ns = _remat_block(cfg, blk, p, x, positions), None
        else:
            x, ns, a = _apply_block(cfg, blk, p, x, positions, st, mode,
                                    max_len=max_len, paged=paged)
        new_states.append(ns)
        if a is not None:
            aux = aux + a
    if mode == "train":
        return {"hidden": x, "aux": aux}
    if mode == "prefill":
        return {"last_logits": apply_head(params, cfg, x[:, -1:])[:, 0],
                "states": new_states, "aux": aux}
    if mode == "paged_prefill":
        return {"chunk_logits": apply_head(params, cfg, x),
                "states": new_states, "aux": aux}
    return {"logits": apply_head(params, cfg, x)[:, 0], "states": new_states,
            "aux": aux}


def paged_segment(params, cfg, inputs: dict, mode: str, states, i: int,
                  x: Optional[torch.Tensor] = None,
                  o: Optional[torch.Tensor] = None):
    """Segment ``i`` of the meshless paged forward cut at its L attention
    kernels, for i in 0..L: layer i-1's attention output projection of
    its kernel's output ``o``, its residual and feed-forward on the
    residual stream ``x`` (i > 0), then layer i's norm and attention up to
    its kernel (i < L), or the final norm and the head (i = L).

    ``inputs`` are the paged mode's (:func:`forward`), with a chunk's
    ``start`` an int or a 0-d integer tensor on the device.  Returns
    ``(x, kernel inputs)`` for i < L: a chunk's (q, kd, vd)
    (``attention.paged_chunk_inputs``), a round's (q,)
    (``attention.paged_decode_query``); for i = L the chunk's logits
    (1, C, V) or the round's (B, V).  Segment 0, then each layer's
    kernel (``attention.paged_chunk_attend`` / ``paged_decode_attend``)
    followed by the next segment, computes what :func:`forward` does."""
    layers = cfg.layer_pattern()
    prefill = mode == "paged_prefill"
    if i == 0:
        x = embed_inputs(params, cfg, inputs, inputs["start"] if prefill
                         else inputs["lengths"][:, None])
    else:
        blk, p = layers[i - 1], params["layers"][i - 1]
        mix = (attention.paged_chunk_out(p["mixer"], cfg, o) if prefill
               else attention.paged_decode_out(p["mixer"], cfg, o, x.dtype))
        x, _ = _feed_forward(cfg, blk, p, x + mix, mode)
    if i == len(layers):
        logits = apply_head(params, cfg, x)
        return logits if prefill else logits[:, 0]
    blk, p = layers[i], params["layers"][i]
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if prefill:
        return x, attention.paged_chunk_inputs(
            p["mixer"], cfg, blk, h, states[i], inputs["block_table"],
            inputs["start"])
    q, _ = attention.paged_decode_query(p["mixer"], cfg, blk, h, states[i],
                                        inputs["block_tables"],
                                        inputs["lengths"])
    return x, (q,)


def config_for_shape(cfg, shape):
    """Long-context decode on full-attention archs switches to the
    beyond-paper sliding-window variant (weights are unchanged)."""
    long_decode = shape.kind == "decode" and shape.seq_len > 65536
    if long_decode and not cfg.is_subquadratic():
        raise ValueError(
            f"{cfg.name} cannot serve {shape.name}: full attention and no "
            "long_context_window configured")
    if (long_decode and cfg.long_context_window is not None
            and cfg.sliding_window is None):
        return dataclasses.replace(cfg,
                                   sliding_window=cfg.long_context_window)
    return cfg
