"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: 16L d2048 32H GQA(kv=8)
d_ff 8192, vocab 128256, tied embeddings."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    vocab_size=128256,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_repeats=16,
    norm="rmsnorm",
    act="silu",
    rope="full",
    rope_theta=5e5,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=160, n_repeats=2)
