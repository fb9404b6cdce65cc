"""qwen1.5-0.5b — dense, QKV bias, MHA (kv=16).

[hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    vocab_size=151936,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    qkv_bias=True,
    d_ff=2816,
    ffn_activation="silu_gated",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    sharding_profile="tp",
    microbatches_train_4k=2,
    supports_decode=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
