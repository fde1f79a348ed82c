"""Qwen2-0.5B [arXiv:2407.10671]: 24L d896 14H GQA(kv=2) d_ff 4864,
vocab 151936, QKV bias, tied embeddings."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    vocab_size=151936,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_repeats=24,
    norm="rmsnorm",
    act="silu",
    rope="full",
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, n_repeats=2)
