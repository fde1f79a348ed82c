"""Mamba2-2.7B [arXiv:2405.21060]: 64L d2560, attention-free SSD,
d_state 128, head_dim 64, expand 2 (d_inner 5120, 80 heads), vocab 50280,
tied embeddings."""
from repro_torch.models.config import LayerSpec, Mamba2Config, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    vocab_size=50280,
    d_model=2560,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    pattern=(LayerSpec(kind="mamba", mlp="none"),),
    n_repeats=64,
    norm="rmsnorm",
    act="silu",
    rope="none",
    mamba=Mamba2Config(d_state=128, head_dim=64, expand=2, d_conv=4,
                       n_groups=1, chunk=128),
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    vocab_size=512, d_model=64, n_repeats=2,
    mamba=Mamba2Config(d_state=16, head_dim=16, expand=2, d_conv=4,
                       n_groups=1, chunk=16))
