"""Model configuration: the fields of ``repro.models.config`` this port reads.

A plain-Python copy (the JAX module imports jax). It keeps the fields the
serving slice uses, with the JAX package's names and defaults, and
``validate`` refuses what the slice does not implement yet (MoE, MLA,
Mamba, enc-dec, other norms or activations) instead of running it wrong.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""

    kind: str = "attn"        # "attn" (the only kind ported so far)
    mlp: str = "dense"        # "dense" (the only MLP ported so far)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 = d_model // n_heads
    d_ff: int = 512
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 2
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    act: str = "silu"
    rope: str = "full"
    rope_theta: float = 10000.0
    attn_window: Optional[int] = None
    tie_embeddings: bool = False
    dtype: str = "float32"
    param_dtype: str = "float32"
    serve_quant_bits: int = 0
    serve_quant_group: int = 128
    kv_cache_bits: int = 0      # 8: int8 KV pools with f32 scale pools

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def all_layer_specs(self) -> list[LayerSpec]:
        return list(self.pattern) * self.n_repeats

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        unsupported = []
        if any(s.kind != "attn" or s.mlp != "dense"
               for s in self.all_layer_specs()):
            unsupported.append("non-attention or MoE layers")
        if self.norm != "rmsnorm":
            unsupported.append(f"norm={self.norm}")
        if self.act != "silu":
            unsupported.append(f"act={self.act}")
        if self.rope != "full":
            unsupported.append(f"rope={self.rope}")
        if self.dtype != "float32" or self.param_dtype != "float32":
            unsupported.append("non-f32 compute")
        if self.kv_cache_bits not in (0, 8):
            unsupported.append(f"kv_cache_bits={self.kv_cache_bits}")
        if unsupported:
            raise NotImplementedError(
                f"{self.name}: not ported yet: {', '.join(unsupported)}")
