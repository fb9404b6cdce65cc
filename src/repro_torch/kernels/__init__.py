"""The port's hand-written Hopper kernels and their plain versions.

Each wrapper launches its kernel (CUDA C++, or Triton for the causal
conv) for CUDA tensors (or raises) and computes its plain PyTorch
version (``ref``) for CPU tensors, and counts its launches in
``<wrapper>.launches``.  Four wrappers are gradients, which autograd runs
when training: ``flash_attention_bwd`` is ``flash_attention``'s, reading
the log-sum-exp its forward kept, ``grouped_gemm_bwd`` is
``grouped_gemm``'s (dX and dW of the MoE experts' products),
``ssd_chunk_scan_bwd`` is the SSD scan's, reading the scratch its forward
kept, and ``causal_conv_bwd`` is the conv's.  The decode kernels
(``paged_attention``, ``mla_decode``, ``ssm_step``) have no backward and
raise when their inputs require grad.
"""
from repro_torch.kernels.causal_conv import causal_conv, causal_conv_bwd
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.grouped_gemm import grouped_gemm, grouped_gemm_bwd
from repro_torch.kernels.kv_gather import kv_layer_gather
from repro_torch.kernels.kv_scatter import kv_layer_scatter
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_chunk_scan_bwd
from repro_torch.kernels.ssm_step import ssm_step

WRAPPERS = (kv_layer_gather, kv_layer_scatter, flash_attention,
            paged_attention, grouped_gemm, mla_decode, ssd_chunk_scan,
            ssm_step, causal_conv, flash_attention_bwd, grouped_gemm_bwd,
            ssd_chunk_scan_bwd, causal_conv_bwd)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["causal_conv", "causal_conv_bwd", "flash_attention",
           "flash_attention_bwd",
           "grouped_gemm", "grouped_gemm_bwd",
           "kv_layer_gather", "kv_layer_scatter", "mla_decode",
           "paged_attention", "ssd_chunk_scan", "ssd_chunk_scan_bwd",
           "ssm_step",
           "reset_launch_counts", "launch_counts"]
