"""Whisper-medium [arXiv:2212.04356]: enc-dec, 24+24L d1024 16H MHA d_ff
4096, vocab 51865. The conv audio frontend is a stub: the encoder takes
precomputed frame embeddings (models/encdec.py::encode)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    vocab_size=51865,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    # decoder layers: causal self-attn + cross-attn + MLP
    pattern=(LayerSpec(kind="attn", mlp="dense", cross_attn=True),),
    n_repeats=24,
    enc_dec=True,
    enc_pattern=(LayerSpec(kind="attn", mlp="dense"),),
    n_enc_repeats=24,
    norm="layernorm",
    act="gelu",
    rope="none",
    pos_emb="learned",
    max_position=32768,  # whisper uses 448; widened for the decode_32k cell
    frontend="audio",
)

SMOKE = CONFIG.replace(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, n_repeats=2, n_enc_repeats=2,
                       max_position=512)
