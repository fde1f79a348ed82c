"""Mixtral-8x22B [arXiv:2401.04088]: 56L d6144 48H GQA(kv=8) MoE 8 experts
top-2 (d_ff 16384), vocab 32768, SWA window 4096, untied head."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    vocab_size=32768,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    n_repeats=56,
    norm="rmsnorm",
    act="silu",
    rope="full",
    rope_theta=1e6,
    attn_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    serve_quant_bits=4,
    fsdp=True,
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, n_repeats=2, attn_window=32,
                       moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
                       fsdp=False)
