"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B backbone — 24L d2048 16H
GQA(kv=8) d_ff 8192, vocab 92553. The InternViT frontend is a stub: the
caller passes precomputed patch embeddings (``ext_embeds``), prepended to
the token sequence."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    vocab_size=92553,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_repeats=24,
    norm="rmsnorm",
    act="silu",
    rope="full",
    frontend="vision",
    frontend_len=256,  # 448px, patch 14, pixel-shuffle 0.5 -> 256 tokens
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, n_repeats=2, frontend_len=8)
