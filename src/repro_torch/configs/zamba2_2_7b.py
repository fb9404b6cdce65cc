"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One shared transformer block (attention + FFN, single weight copy) is
applied every 6 Mamba2 layers (9 applications); each application keeps
its own KV cache.  Zamba2's per-application LoRA adapters are omitted
(noted in DESIGN.md §5) — weight sharing is the architectural property
that matters for KV/cache behaviour.
Sub-quadratic backbone: runs the long_500k cell (attention at decode is
O(seq) per step; SSM state is O(1)).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    vocab_size=32000,
    attn_variant="gqa",
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=0,                     # backbone blocks are pure Mamba2
    hybrid_period=6,
    hybrid_d_ff=10240,
    ssm=SSMConfig(
        d_state=64,
        head_dim=64,
        expand=2,
        conv_width=4,
        n_groups=1,
        chunk_size=256,
    ),
    tie_embeddings=True,
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=True,
    sub_quadratic=True,
    source="arXiv:2411.15242; hf",
))
