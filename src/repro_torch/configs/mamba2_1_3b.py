"""mamba2-1.3b — attention-free SSM (SSD, state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=2048 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, 64 SSD heads of dim 64.
Sub-quadratic: runs the long_500k cell (constant-size recurrent state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab_size=50280,
    attn_variant="none",
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # Mamba2 blocks replace the FFN entirely
    ssm=SSMConfig(
        d_state=128,
        head_dim=64,
        expand=2,
        conv_width=4,
        n_groups=1,
        chunk_size=256,
    ),
    tie_embeddings=True,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=True,
    sub_quadratic=True,
    source="arXiv:2405.21060; unverified",
))
