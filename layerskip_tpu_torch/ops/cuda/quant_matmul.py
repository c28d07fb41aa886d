"""Weight-quantized matrix products: CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of ``layerskip_tpu/ops/pallas/quant_matmul.py``. One CUDA
source (``csrc/quant_matmul.cu``) carries all four products; its header says
what bounds them on the H100 and how the design answers that.

  * ``quant_matmul_t``  (K4)  x [M, K] @ (q [N, K] int8 * scale [N])^T
  * ``quant_matmul``    (K5)  x [M, K] @ (q [K, N] int8 * scale [N])
  * ``int4_matmul``     (K6)  x [M, K] @ dequant(q [K/2, N] uint8, scale [K/G, N])
  * ``int4_matmul_t``   (K7)  x [M, K] @ dequant(q [N, K/2] uint8, scale [N, K/G])^T

Each returns [M, N] in x's dtype (float32 or bfloat16). int8: fp32
accumulation of ``x * float(q)``, the per-channel scale applied to the fp32
accumulator, one rounding. int4 (offset-binary nibble pairs, see
``ops/linear.py::pack_int4``): each weight times its group's scale in fp32,
rounded to x's dtype before the product, then fp32 accumulation and one
rounding. This is the TPU kernels' ``fused`` variant, the one the JAX
package dispatches; its ``groupdot``, ``bittrick`` and ``fused16`` variants
are TPU formulations of the same product and are not ported.

A wrapper launches its kernel for CUDA tensors, at every M, and raises on
anything the kernel does not take; only CPU tensors go to its ``_plain``
version. ``quantize_weights`` is the JAX module's plain quantizer.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from layerskip_tpu_torch.ops.linear import unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KN, _NK = 0, 1  # weight layouts of the C interface: [K, N] and [N, K]


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> ([K, N] int8, [N] fp32 scales), symmetric per-channel."""
    wf = w.float()
    scale = (wf.abs().amax(dim=0) / 127.0).clamp_min(1e-8)
    q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------- plain


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K5's function in torch: (x @ float(q)) in fp32, times scale, in x.dtype."""
    return (torch.matmul(x.float(), w_q.float()) * scale.float()).to(x.dtype)


def quant_matmul_t_plain(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """K4's function in torch, with q stored [N, K]."""
    return (torch.matmul(x.float(), w_q.float().T) * scale.float()).to(x.dtype)


def _int4_weight(q: torch.Tensor, scale: torch.Tensor, group: int, k_last: bool,
                 dtype: torch.dtype) -> torch.Tensor:
    """Dequantized int4 weight, each value rounded to ``dtype``, as fp32."""
    qf = unpack_int4(q, k_last).float()
    if k_last:  # [N, K], scale [N, K/G]
        n, k = qf.shape
        w = (qf.reshape(n, k // group, group) * scale[:, :, None]).reshape(n, k)
    else:  # [K, N], scale [K/G, N]
        k, n = qf.shape
        w = (qf.reshape(k // group, group, n) * scale[:, None, :]).reshape(k, n)
    return w.to(dtype).float()


def int4_matmul_plain(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor,
                      *, group: int) -> torch.Tensor:
    """K6's function in torch: x @ dequant(q) with the weight rounded to
    x.dtype, fp32 accumulation, one rounding."""
    w = _int4_weight(q_packed, scale.float(), group, False, x.dtype)
    return torch.matmul(x.float(), w).to(x.dtype)


def int4_matmul_t_plain(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor,
                        *, group: int) -> torch.Tensor:
    """K7's function in torch, with q stored [N, K/2] and scale [N, K/G]."""
    w = _int4_weight(q_packed, scale.float(), group, True, x.dtype)
    return torch.matmul(x.float(), w.T).to(x.dtype)


# ---------------------------------------------------------------- kernels


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(name, x, q, scale, q_dtype, q_shape, scale_shape, group):
    for what, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x dtype {x.dtype}; the kernel takes float32 or bfloat16")
    if x.dim() != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: x must be [M, K] with K contiguous, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if q.dtype != q_dtype or not q.is_contiguous() or tuple(q.shape) != q_shape:
        raise ValueError(f"{name}: q must be a contiguous {q_dtype} {q_shape}, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if scale.dtype != torch.float32 or not scale.is_contiguous() \
            or tuple(scale.shape) != scale_shape:
        raise ValueError(f"{name}: scale must be a contiguous float32 {scale_shape}, "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if group and (group % 2 or x.shape[1] % group):
        raise ValueError(f"{name}: group {group} must be even and divide K={x.shape[1]}")


def _entry():
    """The C entry point, bound on first use (the library is built at the
    first launch and cached by ``build.load_library``)."""
    from layerskip_tpu_torch.ops.cuda.build import load_library

    fn = load_library("quant_matmul").quant_matmul_launch
    if fn.argtypes is None:
        i64, i32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i32, i32, i32, ptr, i64, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    return fn


def _launch(layout, bits, x, q, scale, n, group, vec_bytes):
    launch = _entry()
    m, k = x.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    row = n if layout == _KN else q.shape[1]  # bytes per weight row
    vec = int(row % vec_bytes == 0 and q.data_ptr() % vec_bytes == 0)
    # the launch goes to the calling thread's current device
    dev = x.device
    ctx = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
           else contextlib.nullcontext())
    with ctx:
        rc = launch(layout, _DTYPE_CODES[x.dtype], bits, x.data_ptr(), x.stride(0),
                    q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n, group, vec,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError {rc}")
    return out


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5: x [M, K] @ (w_q [K, N] int8 * scale [N]) -> [M, N] in x.dtype."""
    if _all_cpu(x, w_q, scale):
        return quant_matmul_plain(x, w_q, scale)
    k, n = x.shape[-1], w_q.shape[-1]
    _check("quant_matmul", x, w_q, scale, torch.int8, (k, n), (n,), 0)
    out = _launch(_KN, 8, x, w_q, scale, n, 0, 4)
    quant_matmul.launches += 1
    return out


def quant_matmul_t(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K4: x [M, K] @ (w_q [N, K] int8 * scale [N])^T -> [M, N] in x.dtype."""
    if _all_cpu(x, w_q, scale):
        return quant_matmul_t_plain(x, w_q, scale)
    k, n = x.shape[-1], w_q.shape[0]
    _check("quant_matmul_t", x, w_q, scale, torch.int8, (n, k), (n,), 0)
    out = _launch(_NK, 8, x, w_q, scale, n, 0, 16)
    quant_matmul_t.launches += 1
    return out


def int4_matmul(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor,
                *, group: int) -> torch.Tensor:
    """K6: x [M, K] @ dequant(q_packed [K/2, N], scale [K/G, N]) -> [M, N]."""
    if _all_cpu(x, q_packed, scale):
        return int4_matmul_plain(x, q_packed, scale, group=group)
    k, n, g = x.shape[-1], q_packed.shape[-1], int(group)
    _check("int4_matmul", x, q_packed, scale, torch.uint8, (k // 2, n),
           (k // g if g else -1, n), g or -1)
    out = _launch(_KN, 4, x, q_packed, scale, n, g, 4)
    int4_matmul.launches += 1
    return out


def int4_matmul_t(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor,
                  *, group: int) -> torch.Tensor:
    """K7: x [M, K] @ dequant(q_packed [N, K/2], scale [N, K/G])^T -> [M, N]."""
    if _all_cpu(x, q_packed, scale):
        return int4_matmul_t_plain(x, q_packed, scale, group=group)
    k, n, g = x.shape[-1], q_packed.shape[0], int(group)
    _check("int4_matmul_t", x, q_packed, scale, torch.uint8, (n, k // 2),
           (n, k // g if g else -1), g or -1)
    out = _launch(_NK, 4, x, q_packed, scale, n, g, 16)
    int4_matmul_t.launches += 1
    return out


for _fn in (quant_matmul, quant_matmul_t, int4_matmul, int4_matmul_t):
    _fn.launches = 0

