"""ChatGLM3-6B [arXiv:2406.12793]: 28L d4096 32H GQA(kv=2) d_ff 13696,
vocab 65024, RoPE on half the channels ("2d"), QKV bias."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    vocab_size=65024,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_repeats=28,
    norm="rmsnorm",
    act="silu",
    rope="half",
    qkv_bias=True,
    serve_quant_bits=4,
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=96, n_heads=4, n_kv_heads=2,
                       head_dim=24, d_ff=192, n_repeats=2)
