"""granite-moe-3b-a800m — fine-grained MoE, top-8 of 40 experts.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    vocab_size=49155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    ffn_activation="silu_gated",
    moe=MoEConfig(
        n_experts=40,
        top_k=8,
        d_ff_expert=512,
        n_shared_experts=0,
        period=1,
        first_k_dense=0,
    ),
    tie_embeddings=True,
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=True,
    sub_quadratic=False,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
