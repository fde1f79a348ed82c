"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: 72L d8192 64H GQA(kv=8),
attn:mamba 1:7 interleave (attn at index 4 of each 8-layer period), MoE 16
experts top-2 (d_ff 24576) on every other layer, vocab 65536, no RoPE.

Jamba uses Mamba-1 blocks upstream; the JAX package's SSM substrate is
Mamba2/SSD, and so is the port's. ``moe_impl="shard_map"``, as in the
JAX package: the explicit all-to-all expert-parallel dispatch
(models/moe_shardmap.py), taken only under a mesh with a "model" axis;
without one the spmd dispatch runs.

At published widths one period does not fit one 80 GB card (each MoE
layer is 16 x 3 x 8192 x 24576 f32 weights, 38.7 GB); a card run cuts the
depth, e.g. ``pattern=CONFIG.pattern[4:6], n_repeats=1``: the attention +
dense-MLP layer, then a mamba + MoE layer.
"""
from repro_torch.models.config import LayerSpec, Mamba2Config, ModelConfig, \
    MoEConfig

_M = LayerSpec(kind="mamba", mlp="dense")
_MM = LayerSpec(kind="mamba", mlp="moe")
_A = LayerSpec(kind="attn", mlp="dense")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    vocab_size=65536,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    # period 8: attn at 4, MoE at odd indices
    pattern=(_M, _MM, _M, _MM, _A, _MM, _M, _MM),
    n_repeats=9,
    norm="rmsnorm",
    act="silu",
    rope="none",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    moe_impl="shard_map",
    mamba=Mamba2Config(d_state=128, head_dim=64, expand=2, d_conv=4,
                       n_groups=1, chunk=128),
    serve_quant_bits=4,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, n_repeats=1,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    mamba=Mamba2Config(d_state=16, head_dim=16, expand=2, d_conv=4,
                       n_groups=1, chunk=16),
    fsdp=False)
