"""gemma2-2b — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Layers alternate sliding-window (4096) and global attention; attention
logits softcapped at 50, final logits at 30; extra post-attention norms.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    vocab_size=256000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    ffn_activation="gelu_gated",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    local_window=4096,
    local_global_period=2,
    post_attn_norm=True,
    embed_scale=2304 ** 0.5,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=True,
    sub_quadratic=False,
    source="arXiv:2408.00118; hf",
))
