"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434]: 27L d2048 16H, MLA
(kv_lora 512, nope 128 + rope 64, v 128), MoE 64 routed top-6 + 2 shared
experts (d_ff_expert 1408), first layer dense (d_ff 10944), vocab 102400.

``moe_impl="shard_map"``, as in the JAX package: the explicit all-to-all
expert-parallel dispatch (models/moe_shardmap.py), taken only under a mesh
with a "model" axis; without one the spmd dispatch runs.
"""
from repro_torch.models.config import LayerSpec, MLAConfig, ModelConfig, \
    MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    vocab_size=102400,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # first dense layer
    prefix_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    n_repeats=26,
    norm="rmsnorm",
    act="silu",
    rope="full",
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408),
    moe_impl="shard_map",
    serve_quant_bits=4,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    vocab_size=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, n_repeats=2,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32))
