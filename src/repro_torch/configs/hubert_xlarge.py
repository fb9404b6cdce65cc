"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[arXiv:2106.07447; unverified]
48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504 (cluster units).
Encoder-only: bidirectional attention, no decode step (the port's
``decode_step``, ``append_step`` and ``ServingSystem`` refuse it).  The
CNN waveform frontend is a stub: callers pass precomputed frame
embeddings (b, s, frontend_embed_dim), projected by
``embed["frontend_proj"]``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    vocab_size=504,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    ffn_activation="gelu",
    causal=False,
    frontend_embed_dim=1280,     # precomputed conv-frame embeddings
    rope_theta=10_000.0,
    sharding_profile="tp",
    microbatches_train_4k=4,
    supports_decode=False,
    sub_quadratic=False,
    source="arXiv:2106.07447; unverified",
))
