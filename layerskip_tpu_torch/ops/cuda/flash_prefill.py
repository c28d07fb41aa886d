"""Flash prefill attention: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``layerskip_tpu/ops/pallas/flash_prefill.py``. The kernel
(``csrc/flash_prefill.cu``) computes causal GQA attention of a prompt block
over the KV cache with a scalar past offset, an optional runtime window, a
score scale and a softcap, with an online fp32 softmax. Its source says what
bounds it on the H100 and how its design answers that. It has two routes:
bfloat16 inputs run on the tensor cores (wgmma, with K/V tiles copied
asynchronously), float32 inputs on the CUDA cores in full fp32.

``flash_prefill_attention`` launches the kernel for CUDA tensors and raises
on anything the kernel does not take; only CPU tensors go to
``flash_prefill_attention_plain``, the same function written out in torch.
It counts its launches in ``flash_prefill_attention.launches`` and, of
those, the tensor-core route's in ``flash_prefill_attention.tensor_core_launches``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_prefill_attention_plain(
    q: torch.Tensor,  # [B, T, Hq, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    past: int,
    *,
    q_heads_per_kv: int,
    sliding_window: int = 0,
    score_scale: float = 0.0,  # 0 => head_dim ** -0.5
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """The kernel's function as a masked softmax in torch: fp32 scores from
    the operands' exact products, masked lanes give p = 0, the denominator is
    clamped at 1e-30 (a fully masked row returns 0) and p is rounded to v's
    dtype before the PV product. Returns [B, T, Hq, Dh] in q's dtype."""
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = q_heads_per_kv
    assert hq == hkv * g, (hq, hkv, g)
    qg = q.float().reshape(b, t, hkv, g, dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float())
    scores = scores * (float(score_scale) or dh ** -0.5)
    if logit_softcap:
        cap = float(logit_softcap)
        scores = cap * torch.tanh(scores / cap)
    q_pos = int(past) + torch.arange(t, device=q.device)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]  # [T, S]
    window = int(sliding_window or 0)
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores > NEG_INF * 0.5, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # [B, Hkv, G, T, 1]
    pv = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    out = pv / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, dh).to(q.dtype)


def _check_cuda_args(q, k, v, g):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_prefill: {name} on {x.device}, q on {q.device}")
        if x.dtype not in _DTYPE_CODES or x.dtype != q.dtype:
            raise ValueError(f"flash_prefill: {name} dtype {x.dtype} (q {q.dtype});"
                             " the kernel takes float32 or bfloat16")
        if x.dim() != 4 or x.stride(3) != 1:
            raise ValueError(f"flash_prefill: {name} must be 4-D with a contiguous "
                             f"head_dim, got shape {tuple(x.shape)} strides {x.stride()}")
    b, t, hq, dh = q.shape
    if q.dtype == torch.bfloat16:  # TMA: 16-byte aligned bases and row strides
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(x.stride(i) % 8 for i in range(3)):
                raise ValueError(f"flash_prefill: bf16 {name} needs 16-byte aligned rows, "
                                 f"got strides {x.stride()} at {x.data_ptr():#x}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {dh} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh \
            or hq != k.shape[2] * g:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} G={g}")


def flash_prefill_attention(
    q: torch.Tensor,  # [B, T, Hq, Dh] post-RoPE
    k: torch.Tensor,  # [B, S, Hkv, Dh] cache, read through its strides
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    past: int,  # shared prefill offset (a Python int)
    *,
    q_heads_per_kv: int,
    sliding_window: int = 0,  # runtime window, 0 = dense causal
    score_scale: float = 0.0,  # 0 => head_dim ** -0.5
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Returns [B, T, Hq, Dh] in q's dtype. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    kw = dict(q_heads_per_kv=q_heads_per_kv, sliding_window=sliding_window,
              score_scale=score_scale, logit_softcap=logit_softcap)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, past, **kw)
    g = int(q_heads_per_kv)
    _check_cuda_args(q, k, v, g)
    from layerskip_tpu_torch.ops.cuda.build import load_library

    lib = _bind(load_library("flash_prefill"))
    b, t, hq, dh = q.shape
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_prefill_launch(
            _DTYPE_CODES[q.dtype], dh,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            b, t, k.shape[1], hq, g, int(past), int(sliding_window or 0),
            float(score_scale) or dh ** -0.5, float(logit_softcap or 0.0),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: cudaError {rc}")
    flash_prefill_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_prefill_attention.tensor_core_launches += 1
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.tensor_core_launches = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        i64, i32, ptr, f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, *([i64] * 12),
                       i32, i32, i32, i32, i32, i32, i32, f32, f32, ptr]
        fn.restype = i32
    return lib
