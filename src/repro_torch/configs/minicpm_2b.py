"""minicpm-2b — dense llama-like arch trained with a WSD schedule.

[arXiv:2404.06395; hf]
40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753.
MiniCPM's mup-style residual scaling is carried as ``ffn_mult``
(depth-scaled residual multiplier 1.4/sqrt(40)).  The port serves it;
the WSD learning-rate schedule belongs to training, which is not ported.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    vocab_size=122753,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    ffn_activation="silu_gated",
    tie_embeddings=True,
    ffn_mult=1.4 / (40 ** 0.5),
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=True,
    sub_quadratic=False,
    source="arXiv:2404.06395; hf",
))
