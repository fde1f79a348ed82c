"""Model configuration: the fields of ``repro.models.config`` this port reads.

A plain-Python copy (the JAX module imports jax). It keeps the fields the
ported slices use, with the JAX package's names and defaults, and
``validate`` refuses what the port does not implement (sinusoidal
position embeddings in ``_embed``, which the JAX package's ``_embed`` has
no branch for either) instead of running it wrong.

The layer stack is ``prefix_pattern`` (unstacked blocks, e.g. DeepSeek's
first dense layer) followed by ``pattern`` repeated ``n_repeats`` times.
An encoder-decoder (whisper) adds an encoder stack of ``enc_pattern``
repeated ``n_enc_repeats`` times (models/encdec.py); its decoder layers
carry cross-attention (``LayerSpec.cross_attn``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""

    kind: str = "attn"        # "attn" | "mamba"
    mlp: str = "dense"        # "dense" | "moe" | "none" (no ln2)
    cross_attn: bool = False  # decoder layers of enc-dec models


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    d_ff_expert: int = 0        # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 = full-rank Q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 64             # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"       # dense | moe | ssm | hybrid | audio | vlm
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 = d_model // n_heads
    d_ff: int = 512
    prefix_pattern: tuple[LayerSpec, ...] = ()
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 2
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)
    rope: str = "full"          # full | half ("2d") | none
    rope_theta: float = 10000.0
    pos_emb: str = "none"       # none | learned
    max_position: int = 8192    # rows of the learned position table
    attention: str = "gqa"      # gqa | mla
    attn_window: Optional[int] = None
    qkv_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    logit_softcap: float = 0.0  # > 0: logits = c * tanh(logits / c)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[Mamba2Config] = None
    enc_dec: bool = False       # whisper: an encoder stack, cross-attn
    n_enc_repeats: int = 0
    enc_pattern: tuple[LayerSpec, ...] = ()
    frontend: str = "none"      # none | audio | vision (a stub: the caller
                                # passes frame or patch embeddings)
    frontend_len: int = 0       # patches prepended (vision) or enc len (audio)
    tie_embeddings: bool = False
    dtype: str = "float32"          # activation/compute dtype: float32 |
                                    # bfloat16 (matmuls accumulate in f32,
                                    # norms and softmax compute in f32)
    param_dtype: str = "float32"    # float32 | bfloat16
    serve_quant_bits: int = 0
    serve_quant_group: int = 128
    remat_policy: str = "nothing"   # nothing | dots (keep matmul outputs)
    banded_window_attn: bool = False  # SWA prefill over the live band only
    chunked_decode: bool = False    # decode reads K in attn_block_kv blocks
    attn_scores_dtype: str = "float32"  # the chunked core's scores dtype
    moe_impl: str = "spmd"      # spmd | shard_map (expert-parallel
                                # all-to-all dispatch under a mesh with a
                                # "model" axis, models/moe_shardmap.py)
    kv_cache_bits: int = 0      # 8: int8 KV pools with f32 scale pools
    remat: bool = True          # recompute each repeat in a "train" pass
                                # backward (models/transformer.py)
    attn_block_kv: int = 512    # KV block of the chunked attention core
    fsdp: bool = False          # params' embed dims also split over "data"
                                # (distributed/partitioning.py)
    scan_layers: bool = True    # the JAX package scans the repeats; the
                                # port's stack is always a Python loop over
                                # them, so the field changes no value here
    tp: int = 1                 # the tensor-parallel width the model code
                                # runs under: a rank's config in TP serving
                                # (partitioning.py, tp_local_cfg) has tp > 1,
                                # so row-parallel linears all-reduce over
                                # "model"; elsewhere 1 and no collective

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return len(self.prefix_pattern) + len(self.pattern) * self.n_repeats

    @property
    def adtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def all_layer_specs(self) -> list[LayerSpec]:
        return list(self.prefix_pattern) + list(self.pattern) * self.n_repeats

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        unsupported = []
        specs = self.all_layer_specs() + list(self.enc_pattern)
        if any(s.kind not in ("attn", "mamba")
               or s.mlp not in ("dense", "moe", "none") for s in specs):
            unsupported.append("layer kinds other than attn/mamba or MLPs "
                               "other than dense/moe/none")
        if any(s.mlp == "moe" for s in specs) and self.moe is None:
            raise ValueError(f"{self.name}: MoE layers need cfg.moe")
        if any(s.kind == "mamba" for s in specs) and self.mamba is None:
            raise ValueError(f"{self.name}: mamba layers need cfg.mamba")
        if self.moe_impl not in ("spmd", "shard_map"):
            unsupported.append(f"moe_impl={self.moe_impl}")
        if self.attention == "mla" and self.mla is None:
            raise ValueError(f"{self.name}: MLA attention needs cfg.mla")
        if self.attention not in ("gqa", "mla"):
            unsupported.append(f"attention={self.attention}")
        if self.enc_dec and not (self.n_enc_repeats > 0
                                 and self.enc_pattern):
            raise ValueError(f"{self.name}: an enc-dec model needs an "
                             f"encoder (n_enc_repeats > 0 and enc_pattern)")
        if self.frontend not in ("none", "audio", "vision"):
            unsupported.append(f"frontend={self.frontend}")
        if self.norm not in ("rmsnorm", "layernorm"):
            unsupported.append(f"norm={self.norm}")
        if self.act not in ("silu", "gelu"):
            unsupported.append(f"act={self.act}")
        if self.rope not in ("full", "half", "none"):
            unsupported.append(f"rope={self.rope}")
        if self.pos_emb not in ("none", "learned"):
            unsupported.append(f"pos_emb={self.pos_emb}")
        for field in ("dtype", "param_dtype", "attn_scores_dtype"):
            if getattr(self, field) not in DTYPES:
                unsupported.append(f"{field}={getattr(self, field)}")
        if self.remat_policy not in ("nothing", "dots"):
            unsupported.append(f"remat_policy={self.remat_policy}")
        if self.kv_cache_bits not in (0, 8):
            unsupported.append(f"kv_cache_bits={self.kv_cache_bits}")
        if unsupported:
            raise NotImplementedError(
                f"{self.name}: not ported yet: {', '.join(unsupported)}")
