"""Hardware and model descriptors for the simulator and the serving
clock (port of ``repro.sim.spec``).

``HOPPER_NODE`` is the paper's testbed as the reference models it (8
engines, 400 Gb/s compute and storage NICs, 500 GB/s DRAM, data-sheet
H100 peaks).  The simulator and the serving runtime's clock charge
modelled seconds from these numbers; they are inputs to a model, not
measurements.  ``REDUCED_TEST_NODE`` scales a node down to the
``reduced()`` models, so storage reads cost modelled seconds comparable
to their compute.  ``DS_660B`` and ``QWEN25_32B`` are the paper's
evaluation models as the simulator describes them.  (The reference's TPU
profiles are not ported.)
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analysis import ClusterSpec


@dataclass(frozen=True)
class GPUSpec:
    flops: float                 # effective dense FLOP/s for inference dtype
    hbm_bw: float                # bytes/s
    hbm_bytes: float
    mfu_prefill: float = 0.55    # achievable fraction during prefill
    mbu_decode: float = 0.70     # achievable HBM-bandwidth fraction in decode


HOPPER_GPU = GPUSpec(flops=990e12, hbm_bw=3.35e12, hbm_bytes=80e9)


@dataclass(frozen=True)
class NodeSpec:
    g: int                       # engines per node
    cnic_bw: float               # per-engine compute-NIC bandwidth [B/s]
    snic_bw: float               # per-node storage-NIC bandwidth [B/s]
    dram_bw: float               # per-node DRAM bandwidth [B/s]
    gpu: GPUSpec = field(default_factory=lambda: HOPPER_GPU)

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec(g=self.g, B=self.cnic_bw,
                           s=self.snic_bw / self.cnic_bw, M=self.dram_bw)


# 400 Gbps = 50 GB/s
HOPPER_NODE = NodeSpec(g=8, cnic_bw=50e9, snic_bw=50e9, dram_bw=500e9,
                       gpu=HOPPER_GPU)

REDUCED_TEST_NODE = NodeSpec(
    g=1, cnic_bw=2e6, snic_bw=1e6, dram_bw=20e6,
    gpu=GPUSpec(flops=50e9, hbm_bw=5e9, hbm_bytes=1e9))


@dataclass(frozen=True)
class ModelSimSpec:
    """Analytic per-token quantities the simulator needs."""

    name: str
    n_layers: int
    kv_bytes_per_token: int          # loadable KV bytes per context token
    active_param_bytes: float        # bytes touched per decode step
    active_params: float             # active parameter count
    n_heads: int
    qk_head_dim: int
    sparse_topk: int = 0             # DSA-style sparse attention (0 = dense)
    linear_ctx_flops: float = 0.0    # extra FLOPs per (token x ctx-token):
                                     # DSA lightning-indexer style terms
    ssm_state_bytes: int = 0         # opaque recurrent-state blob per seq
    total_param_bytes: float = 0.0   # full weight bytes (MoE: all experts)

    @classmethod
    def from_config(cls, cfg: ModelConfig, kv_dtype_bytes: int = 2,
                    param_dtype_bytes: int = 2) -> "ModelSimSpec":
        """The reference's ``from_config``: the SSM family carries its
        constant-size state (``ModelConfig.ssm_state_bytes``, every leaf
        counted at 4 bytes as the reference counts it); the other
        families carry none."""
        qk = cfg.head_dim if cfg.attn_variant != "mla" else (
            cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
        return cls(
            name=cfg.name,
            n_layers=cfg.n_layers,
            kv_bytes_per_token=cfg.kv_bytes_per_token(kv_dtype_bytes),
            active_param_bytes=cfg.active_param_count() * param_dtype_bytes,
            active_params=cfg.active_param_count(),
            n_heads=max(cfg.n_heads, 1),
            qk_head_dim=max(qk, 1),
            ssm_state_bytes=cfg.ssm_state_bytes(),
            total_param_bytes=cfg.param_count() * param_dtype_bytes,
        )

    def active_param_bytes_resident(self, group_size: int) -> float:
        """Weight bytes one engine touches per decode step: its shard of
        the resident weights (decode batches activate ~all experts)."""
        tot = self.total_param_bytes or self.active_param_bytes
        return tot / max(group_size, 1)

    # --- compute/IO models -------------------------------------------------
    def linear_flops_per_token(self) -> float:
        return 2.0 * self.active_params

    def attn_flops_per_token(self, ctx: int) -> float:
        """Attention FLOPs for one new token at context length ctx."""
        eff_ctx = min(ctx, self.sparse_topk) if self.sparse_topk else ctx
        return (4.0 * self.n_layers * self.n_heads * self.qk_head_dim *
                eff_ctx + self.linear_ctx_flops * ctx)

    def prefill_flops(self, cached: int, bsz: int) -> float:
        """Append ``bsz`` tokens on top of ``cached`` context."""
        lin = self.linear_flops_per_token() * bsz
        attn = 4.0 * self.n_layers * self.n_heads * self.qk_head_dim * \
            bsz * (cached + (bsz + 1) / 2.0)
        if self.sparse_topk:
            attn = min(attn, 4.0 * self.n_layers * self.n_heads *
                       self.qk_head_dim * bsz * self.sparse_topk)
        attn += self.linear_ctx_flops * bsz * (cached + (bsz + 1) / 2.0)
        return lin + attn

    def decode_step_flops(self, ctx: int) -> float:
        return self.linear_flops_per_token() + self.attn_flops_per_token(ctx)

    def decode_step_bytes(self, ctx: int) -> float:
        """HBM bytes touched per decode step per sequence (KV read)."""
        eff_ctx = min(ctx, self.sparse_topk) if self.sparse_topk else ctx
        return self.kv_bytes_per_token * eff_ctx + self.ssm_state_bytes

    def cache_compute_ratio(self, ctx: int, append: int) -> float:
        """GB of KV to load per PFLOP of compute (paper Table 1)."""
        load = self.kv_bytes_per_token * ctx
        comp = self.prefill_flops(ctx, append)
        return (load / 1e9) / (comp / 1e15)


# --- the paper's evaluation models (simulator descriptors) -----------------
# DS 660B (DeepSeek-V3.2): MLA rank 512 + 64 rope, 61 layers, DSA topk 2048,
# ~37B active params.  KV fp8 => 576 B/token/layer.
DS_660B = ModelSimSpec(
    name="ds660b", n_layers=61,
    kv_bytes_per_token=61 * (512 + 64),          # fp8 latent
    active_param_bytes=37e9 * 1,                 # fp8 weights
    active_params=37e9, n_heads=128, qk_head_dim=192,
    sparse_topk=2048,
    total_param_bytes=660e9,
)

QWEN25_32B = ModelSimSpec(
    name="qwen2.5-32b", n_layers=64,
    kv_bytes_per_token=64 * 2 * 8 * 128 * 2,     # GQA kv=8, fp16 (Table 1)
    active_param_bytes=32.8e9 * 2,
    active_params=32.8e9, n_heads=40, qk_head_dim=128,
    total_param_bytes=32.8e9 * 2,
)
