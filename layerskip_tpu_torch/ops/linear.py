"""Weight application: dense or weight-quantized products (port of
``layerskip_tpu/ops/linear.py``).

``apply_weight(x, w)`` and ``apply_weight_t(x, w)`` are the projection
primitives of the Llama forward. ``w`` is a plain tensor (``torch.matmul`` /
``F.linear``, as the JAX package leaves dense products to XLA) or a
``QuantTensor``: int8 per-output-channel or int4 K-groupwise weights with
fp32 scales. Every ``QuantTensor`` product goes through one of four
wrappers in ``ops/cuda/quant_matmul.py``: on a CUDA tensor each launches
its hand-written kernel at every M, on a CPU tensor it runs the kernel's
plain torch version.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def pack_int4(q: torch.Tensor, k_last: bool = False) -> torch.Tensor:
    """Pack int4 values (any int dtype, range [-8, 7]) two per byte along K.

    Byte ``i`` along K holds element ``2i`` in its low nibble and ``2i+1``
    in its high nibble, OFFSET-BINARY (``u = q + 8``, so stored nibbles are
    unsigned 0..15): the JAX package's layout, bit for bit. K is the last
    axis with ``k_last``, else the second to last."""
    axis = -1 if k_last else -2
    k = q.shape[axis]
    assert k % 2 == 0, f"int4 packing needs even K, got {k}"
    qn = (q.to(torch.int32) + 8) & 0xF
    if k_last:
        lo, hi = qn[..., 0::2], qn[..., 1::2]
    else:
        lo, hi = qn[..., 0::2, :], qn[..., 1::2, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor, k_last: bool = False) -> torch.Tensor:
    """Inverse of ``pack_int4``: uint8 nibble pairs -> int8 values in [-8, 7]."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    if k_last:  # [..., N, K/2] -> [..., N, K]
        return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    st = torch.stack([lo, hi], dim=-2)  # [..., K/2, 2, N]
    return st.reshape(*p.shape[:-2], p.shape[-2] * 2, p.shape[-1])


@dataclasses.dataclass
class QuantTensor:
    """Quantized weights + fp32 scales (int8 per-channel or int4 groupwise).

    ``group == 0`` (int8, per output channel): q [..., K, N] int8 (or
    [..., N, K] when ``k_last``), scale [..., N] fp32.

    ``group == G > 0`` (int4, K-groupwise): q is nibble-packed uint8
    [..., K/2, N] (``k_last``: [..., N, K/2]), see ``pack_int4``, with
    scale [..., K/G, N] (``k_last``: [..., N, K/G]).

    Stacked [L, ...] weights index as ``w[i]`` (views, no copy), as the
    dense layer weights do. ``k_last`` mirrors the dense orientation split:
    wq/wk/wv are stored [out, in] (see ``apply_weight_t``).
    """

    q: torch.Tensor
    scale: torch.Tensor
    k_last: bool = False
    group: int = 0

    @property
    def shape(self):
        """LOGICAL (dense-equivalent) shape: unpacked K for int4."""
        s = list(self.q.shape)
        if self.group:
            s[-1 if self.k_last else -2] *= 2
        return tuple(s)

    def __getitem__(self, idx) -> "QuantTensor":
        return QuantTensor(q=self.q[idx], scale=self.scale[idx],
                           k_last=self.k_last, group=self.group)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        if self.group:
            g = self.group
            qf = unpack_int4(self.q, self.k_last).float()
            if self.k_last:  # [..., N, K], scale [..., N, K/G]
                *lead, n, k = qf.shape
                wf = qf.reshape(*lead, n, k // g, g) * self.scale[..., None]
                return wf.reshape(*lead, n, k).to(dtype)
            *lead, k, n = qf.shape
            wf = qf.reshape(*lead, k // g, g, n) * self.scale[..., :, None, :]
            return wf.reshape(*lead, k, n).to(dtype)
        if self.k_last:  # [..., N, K] * scale[..., N, 1]
            return (self.q.float() * self.scale[..., :, None]).to(dtype)
        return (self.q.float() * self.scale[..., None, :]).to(dtype)


def _qdot(x2: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """[M, K] @ one layer's quantized weight -> [M, N] in x's dtype, through
    the wrapper of its orientation and width (K4-K7)."""
    from layerskip_tpu_torch.ops.cuda import quant_matmul as qmm  # imports this module

    if w.group:
        fn = qmm.int4_matmul_t if w.k_last else qmm.int4_matmul
        return fn(x2, w.q, w.scale, group=w.group)
    fn = qmm.quant_matmul_t if w.k_last else qmm.quant_matmul
    return fn(x2, w.q, w.scale)


def apply_weight(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> [..., N]; w may be dense or a QuantTensor."""
    if isinstance(w, QuantTensor):
        assert w.q.dim() == 2, "apply_weight expects a single layer's weight"
        assert not w.k_last, "k_last QuantTensor goes through apply_weight_t"
        out = _qdot(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return torch.matmul(x, w)


def apply_weight_t(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w^T where w is stored [N, K] (HF [out, in] orientation)."""
    if isinstance(w, QuantTensor):
        assert w.q.dim() == 2 and w.k_last
        out = _qdot(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return F.linear(x, w)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] accumulated AND returned in fp32.

    The JAX package asks XLA for fp32 results of bf16 products
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round them
    to bf16, and rounded logits tie where fp32 ones do not. On CUDA the
    product takes bf16 operands with an fp32 output (``torch.mm``'s
    ``out_dtype``); elsewhere the operands are upcast, which gives the same
    exact products.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda and a.dtype == b.dtype and hasattr(torch.ops.aten.mm, "dtype"):
        lead = a.shape[:-1]
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*lead, b.shape[-1])
    return torch.matmul(a.float(), b.float())
