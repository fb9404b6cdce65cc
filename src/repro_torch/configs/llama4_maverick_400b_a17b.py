"""llama4-maverick-400b-a17b — MoE, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Maverick interleaves dense and MoE FFNs (period 2) and adds one shared
expert per MoE layer; with 128 routed experts of d_ff 8192 on 24 MoE
layers this lands at ~398 B total / ~17 B active parameters, matching
the 400b-a17b designation.

The training fields (optimizer, its state dtype, microbatches) are the
reference's, carried so the two configs compare field for field.  The
port serves this model and trains it (the MoE family's path, through the
grouped GEMM's backward), tested at reduced size; at published width its
f32 gradient accumulators alone outgrow one card (74 GB at depth 2).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    vocab_size=202048,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    ffn_activation="silu_gated",
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_ff_expert=8192,
        n_shared_experts=1,
        period=2,
        first_k_dense=0,
    ),
    rope_theta=500_000.0,
    sharding_profile="ep_fsdp",
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
    microbatches_train_4k=16,
    supports_decode=True,
    sub_quadratic=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
