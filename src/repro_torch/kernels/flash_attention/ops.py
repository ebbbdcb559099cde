"""Public flash-attention op: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. Forward only (the port serves; the
training backward is later work)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    prefix_len=0, q_offset=0):
    """GQA flash attention. q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len, q_offset=q_offset)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
