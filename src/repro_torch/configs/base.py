"""Configuration system for the DEdgeAI/LAD-TS reproduction framework.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing
of ``repro``); the two must build field-identical configs, which
``tests/test_torch_model.py`` checks.

Every servable architecture is described by a :class:`ModelConfig`.  A config
is a *pure data* object — models are built from it functionally (no global
registry side effects).  Reduced variants (for CPU smoke tests) are derived
with :func:`reduced`, keeping the family-specific structure (MoE, SSM, hybrid
patterns, GQA ratios) while shrinking dimensions.

Block kinds
-----------
The unified decoder is a stack of blocks.  Each block has
  * a *mixer*  : how tokens exchange information
      - "attn"    : GQA multi-head attention (full causal, optionally RoPE,
                    optionally sliding-window / local)
      - "mlstm"   : xLSTM matrix-memory cell (linear-attention style)
      - "slstm"   : xLSTM scalar-memory cell
      - "rglru"   : RecurrentGemma real-gated linear recurrent unit
  * a *ffn*    : "dense" (optionally gated/SwiGLU), "moe", or "none"
                 (xLSTM blocks carry their own projections).

``layer_pattern()`` expands the per-arch pattern into ``num_layers`` block
specs.  A :class:`LayerTypesConfig` (the port's own; the reference has no
such config) names each attention layer's kind, as Hugging Face's
``layer_types`` does, and gives every kind its own window and RoPE.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block-level description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RopeSpec:
    """One attention kind's rotary embedding (``models/layers.py``).

    ``default``: inverse frequencies ``theta ** (-2i / hd)``.  ``yarn``
    (Hugging Face's ``_compute_yarn_parameters``): the same frequencies
    blended with their interpolation by ``factor`` along a linear ramp
    between the dims that ``beta_fast`` and ``beta_slow`` rotations span
    over ``original_max_position`` positions, and cos / sin scaled by
    ``attention_factor``."""

    theta: float = 10_000.0
    kind: str = "default"        # default | yarn
    factor: float = 1.0
    original_max_position: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One decoder block: a sequence mixer plus a feed-forward."""

    mixer: str = "attn"          # attn | mlstm | slstm | rglru
    ffn: str = "dense"           # dense | moe | none
    window: Optional[int] = None  # sliding/local attention window (tokens)
    use_rope: bool = True        # rotary embeddings (attn only)
    rope: Optional[RopeSpec] = None  # None: default RoPE at cfg.rope_theta

    def is_recurrent(self) -> bool:
        return self.mixer in ("mlstm", "slstm", "rglru")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # None: dropless, every routed row is computed (models/moe.py)
    capacity_factor: Optional[float] = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity --------------------------------------------------------------
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | vlm | audio
    citation: str = ""

    # transformer dimensions --------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention behaviour -----------------------------------------------------
    qkv_bias: bool = False       # Qwen2-style bias on QKV projections
    use_rope: bool = True        # rotary embeddings (False -> sinusoidal adds)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # arch-native SWA (Mixtral)
    local_window: Optional[int] = None        # local-attn window (RG hybrid)
    long_context_window: Optional[int] = None  # beyond-paper SW variant used
    # only for the long_500k serving shape on otherwise-full-attention archs.

    # layer pattern -----------------------------------------------------------
    # pattern of block templates, tiled to num_layers.  Encoded as a tuple of
    # (mixer, ffn) pairs; window defaults resolved in layer_pattern().
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)

    # ffn behaviour -----------------------------------------------------------
    gated_ffn: bool = True       # SwiGLU-style gated MLP
    moe: Optional[MoEConfig] = None

    # recurrent dims (ssm / hybrid) -------------------------------------------
    rg_lru_dim: int = 0          # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4        # temporal conv in recurrent blocks

    # modality frontend stubs ---------------------------------------------------
    # [vlm]: number of image patch embeddings prepended per sample and the
    # (stub) vision encoder output dim fed through the (real) projector.
    vision_patches: int = 0
    vision_dim: int = 0
    # [audio]: number of EnCodec codebooks (MusicGen sums their embeddings and
    # has one LM head per codebook).
    num_codebooks: int = 0

    # numerics / training ------------------------------------------------------
    dtype: str = "bfloat16"
    # KV cache storage: "model" (= dtype) or "int8" (per-slot symmetric
    # quantization; beyond-paper serving optimization, §Perf)
    kv_cache_dtype: str = "model"
    # chunk size of the online-softmax attention (VMEM-tile twin); smaller
    # chunks shrink the transient (Cq x Ckv) f32 score buffers
    attn_chunk: int = 1024
    # RG-LRU recurrence evaluation: sequential lax.scan (Griffin's TPU
    # reference behaviour) vs parallel lax.associative_scan (§Perf)
    use_assoc_scan: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # scan over layers keeps the HLO size O(1) in depth — essential for the
    # 512-partition dry-run compiles on a single CPU core.
    scan_layers: bool = True
    remat: bool = True           # activation checkpointing in train_step
    # gradient-accumulation microbatches per train step.  Bounds the live
    # remat residual stack (L x B/k x S x d) that dominates training HBM.
    microbatches: int = 8
    # Hoist the MoE expert-weight re-layout (E,d,f) -> (M,r,d,f_lp) out of
    # the layer x microbatch loops: transform params once per step and
    # inverse-transform the accumulated grads (beyond-paper, §Perf).
    hoist_moe_layout: bool = False
    # Weights-stationary serving MoE (beyond-paper, §Perf): when the token
    # count is tiny (decode), all-gather the TOKENS across the data axis
    # and keep expert weights fully sharded (expert on 'model', d on
    # 'data') instead of re-gathering GBs of weights per decode step.
    moe_stationary_serve: bool = False
    moe_stationary_max_tokens: int = 4096

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0, (
            f"{self.name}: q heads {self.num_heads} not a multiple of kv "
            f"heads {self.num_kv_heads}")

    # ------------------------------------------------------------------
    def layer_pattern(self) -> Tuple[BlockSpec, ...]:
        """Expand ``pattern`` to ``num_layers`` BlockSpecs."""
        blocks = []
        for i in range(self.num_layers):
            mixer, ffn = self.pattern[i % len(self.pattern)]
            window = None
            if mixer == "attn":
                if self.family == "hybrid" and len(self.pattern) > 1:
                    window = self.local_window
                elif self.sliding_window is not None:
                    window = self.sliding_window
            blocks.append(BlockSpec(mixer=mixer, ffn=ffn, window=window,
                                    use_rope=self.use_rope))
        return tuple(blocks)

    # ------------------------------------------------------------------
    @property
    def uniform_blocks(self) -> bool:
        """True when every layer has an identical BlockSpec (scan-friendly)."""
        pat = self.layer_pattern()
        return all(b == pat[0] for b in pat)

    def is_subquadratic(self) -> bool:
        """Can this arch serve the 500k-token decode shape?

        True when every block is recurrent or windowed attention, OR when a
        beyond-paper ``long_context_window`` has been configured.
        """
        if self.long_context_window is not None:
            return True
        for b in self.layer_pattern():
            if b.mixer == "attn" and b.window is None:
                return False
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used in roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = 0
        n += v * d                                   # token embedding
        if not self.tie_embeddings:
            n += d * v                               # lm head
        if self.num_codebooks:
            n += (self.num_codebooks - 1) * v * d    # extra codebook embeds
            n += (self.num_codebooks - 1) * d * v    # extra heads
        if self.vision_patches:
            n += self.vision_dim * d + d * d         # projector MLP
        for blk in self.layer_pattern():
            if blk.mixer == "attn":
                n += d * (self.num_heads * hd)       # wq
                n += 2 * d * (self.num_kv_heads * hd)  # wk, wv
                n += (self.num_heads * hd) * d       # wo
            elif blk.mixer == "mlstm":
                n += 3 * d * (self.num_heads * hd) + 2 * d * self.num_heads
                n += (self.num_heads * hd) * d
                n += 2 * d * 2 * d                   # up/down proj (ffn=none)
            elif blk.mixer == "slstm":
                n += 4 * d * d + 4 * d * d           # input + recurrent gates
            elif blk.mixer == "rglru":
                rd = self.rg_lru_dim or d
                n += d * rd * 2 + rd * d + 2 * rd * rd // 8  # in/gate/out + lru
            if blk.ffn == "dense":
                mult = 3 if self.gated_ffn else 2
                n += mult * d * f
            elif blk.ffn == "moe":
                mult = 3 if self.gated_ffn else 2
                n += self.moe.num_experts * mult * d * f
                n += d * self.moe.num_experts        # router
            n += 2 * d                               # 2 norms
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mult = 3 if self.gated_ffn else 2
        dense_like = self.param_count()
        n_moe_blocks = sum(1 for b in self.layer_pattern() if b.ffn == "moe")
        inactive = n_moe_blocks * (self.moe.num_experts - self.moe.top_k) * mult * d * f
        return dense_like - inactive


@dataclasses.dataclass(frozen=True)
class AttentionKind:
    """What one named kind of attention layer attends: its window (None:
    full causal) and its RoPE."""

    window: Optional[int] = None
    rope: RopeSpec = RopeSpec()


@dataclasses.dataclass(frozen=True)
class LayerTypesConfig(ModelConfig):
    """A config whose attention layers come in named kinds: one period of
    ``layer_types`` tiled to ``num_layers`` (Hugging Face's
    ``layer_types``), each name a kind of ``attention_kinds`` with its own
    window and RoPE.  A subclass, so that every other config keeps its
    fields as the reference's."""

    layer_types: Tuple[str, ...] = ("full_attention",)
    attention_kinds: Tuple[Tuple[str, AttentionKind], ...] = (
        ("full_attention", AttentionKind()),)

    def layer_pattern(self) -> Tuple[BlockSpec, ...]:
        kinds = dict(self.attention_kinds)
        blocks = []
        for i, blk in enumerate(super().layer_pattern()):
            kind = kinds[self.layer_types[i % len(self.layer_types)]]
            blocks.append(dataclasses.replace(blk, window=kind.window,
                                              rope=kind.rope)
                          if blk.mixer == "attn" else blk)
        return tuple(blocks)


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Shrink a config to a CPU-smoke-test variant of the same family.
    A :class:`LayerTypesConfig` keeps at least one period of its layer
    kinds, each window cut to at most 64."""
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    extra = {}
    if isinstance(cfg, LayerTypesConfig):
        num_layers = max(num_layers, len(cfg.layer_types))
        extra["attention_kinds"] = tuple(
            (name, dataclasses.replace(
                kind, window=None if kind.window is None
                else min(kind.window, 64)))
            for name, kind in cfg.attention_kinds)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(cfg.moe.num_experts, max_experts),
                        top_k=min(cfg.moe.top_k, 2),
                        capacity_factor=cfg.moe.capacity_factor)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=max(4 * d_model // 2, 128) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        vision_dim=min(cfg.vision_dim, 128) if cfg.vision_dim else 0,
        vision_patches=min(cfg.vision_patches, 16) if cfg.vision_patches else 0,
        rg_lru_dim=d_model if cfg.rg_lru_dim else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        local_window=min(cfg.local_window, 64) if cfg.local_window else None,
        long_context_window=(min(cfg.long_context_window, 64)
                             if cfg.long_context_window else None),
        moe=moe,
        scan_layers=False,
        microbatches=1,
        dtype="float32",
        **extra,
    )
