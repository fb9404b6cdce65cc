"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The modality frontend is a stub: callers pass precomputed patch
embeddings (b, s, frontend_embed_dim), which ``embed["frontend_proj"]``
projects to d_model; the backbone below is a standard GQA decoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    vocab_size=64000,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    ffn_activation="silu_gated",
    rope_theta=5_000_000.0,
    frontend_embed_dim=7168,      # anyres patch embeddings, precomputed
    sharding_profile="fsdp",
    microbatches_train_4k=8,
    supports_decode=True,
    sub_quadratic=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
