"""Granite-20B-Code [arXiv:2405.04324]: GPT-BigCode style — 52L d6144 48H
MQA(kv=1) d_ff 24576, vocab 49152, LayerNorm + biases, learned positions."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    vocab_size=49152,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_repeats=52,
    norm="layernorm",
    act="gelu",
    rope="none",
    pos_emb="learned",
    max_position=32768,  # widened for decode_32k (native 8192)
    qkv_bias=True,
    o_bias=True,
    mlp_bias=True,
    serve_quant_bits=4,
    fsdp=True,
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=96, n_heads=4, n_kv_heads=1,
                       head_dim=24, d_ff=192, n_repeats=2, max_position=512,
                       fsdp=False)
