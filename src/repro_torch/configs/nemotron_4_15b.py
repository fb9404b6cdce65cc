"""nemotron-4-15b — dense GQA with squared-ReLU (non-gated) FFN.

[arXiv:2402.16819; unverified]
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    vocab_size=256000,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    ffn_activation="squared_relu",
    rope_theta=10_000.0,
    sharding_profile="fsdp",
    microbatches_train_4k=8,
    supports_decode=True,
    sub_quadratic=False,
    source="arXiv:2402.16819; unverified",
))
