"""ds27b — the paper's own evaluation model (§A.2, downscaled DeepSeek).

30L hidden=2560, dense intermediate 12288, 32 heads, MLA attention,
72 routed experts (d_ff 1536, top-6) + 2 shared experts, 1 initial
dense layer.  The DeepSeek Sparse Attention indexer is orthogonal to
DualPath's loading path (it reduces *compute*, not KV residency) and is
not reproduced; MLA is, since it determines the per-token KV bytes that
drive the paper's Table 1 cache-compute ratios.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="ds27b",
    family="moe",
    n_layers=30,
    d_model=2560,
    vocab_size=129280,
    attn_variant="mla",
    n_heads=32,
    n_kv_heads=32,             # MLA: all heads share the latent KV
    head_dim=192,              # nope(128) + rope(64)
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    d_ff=12288,
    ffn_activation="silu_gated",
    moe=MoEConfig(
        n_experts=72,
        top_k=6,
        d_ff_expert=1536,
        n_shared_experts=2,
        period=1,
        first_k_dense=1,
    ),
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=8,
    supports_decode=True,
    sub_quadratic=False,
    source="paper §A.2",
))
