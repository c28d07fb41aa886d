"""Paged short-query attention: CUDA kernel wrappers and their plain PyTorch
versions.

Counterpart of ``layerskip_tpu/ops/pallas/paged_decode.py``. One CUDA source
(``csrc/paged_decode.cu``) carries both kernels; its header says what bounds
them on the H100 and how the design answers that.

  * ``paged_decode_attention``     (K2)  q over a bf16 or fp32 page pool
  * ``paged_decode_attention_q8``  (K3)  q over an int8 pool with per-(token,
                                         head) bf16 scales

q [B, T, Hq, Dh] (T <= 16) attends over pools [P, Hkv, page, Dh] read through
a page table [B, max_pages] int32, with per-row positions [T] or [B, T], a
runtime window, a static score scale (0 means Dh^-0.5) and softcap, and the
tree clause (``tree_chain`` [B, T], ``tree_scratch`` [] or [B],
``tree_fanout``). The result is [B, T, Hq, Dh] in q's dtype.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; it counts its launches in ``launches`` and, of those,
the ones with the tree clause (fanout > 1) in ``tree_launches``; only CPU tensors go to its ``_plain`` version, which
computes the kernel's function as one masked softmax: K2 rounds p to the
pool's dtype before PV; K3 dequantizes k and v in fp32 and keeps p in fp32
(the TPU kernel's numerics, not the gathered fallback's, which dequantizes
to q's dtype first). The kernels split each row's keys into chunks of
``chunk_keys`` keys over ``SPLITS`` blocks and merge the partial softmaxes
(the source's header); the plain versions take one softmax over all keys,
which is the same function up to fp32 rounding.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_QUERY = 16  # the kernels' short-query limit: drafts and verify windows
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2  # kv dtype code of the int8 pool
SPLITS = 8  # virtual ranks that split one row's chunks (kSplits in csrc/paged_decode.cu)
_CHUNK_K_BYTES = 8192  # K bytes of one chunk (kChunkKBytes)


def chunk_keys(head_dim: int, kv_dtype: torch.dtype) -> int:
    """Keys per chunk of the kernels' split for a pool dtype: 8 KB of K, at
    least 16 keys (``Geo::kChunk`` in csrc/paged_decode.cu)."""
    esize = torch.tensor([], dtype=kv_dtype).element_size()
    return max(16, _CHUNK_K_BYTES // (head_dim * esize))


# ---------------------------------------------------------------- plain


def _gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [P, H, page, X] through table [B, maxp] -> [B, maxp * page, H, X]."""
    b, maxp = table.shape
    _, h, page, x = pool.shape
    return pool[table.long()].permute(0, 1, 3, 2, 4).reshape(b, maxp * page, h, x)


def _visible(q_pos, s, window, chain, scratch, fanout) -> torch.Tensor:
    """[B, T, S] key visibility: causal and window clauses on each key's
    position, and the tree clause on its chain (``_key_coords``)."""
    b = q_pos.shape[0]
    key = torch.arange(s, device=q_pos.device)[None, :].expand(b, s)
    key_pos, key_chain = key, None
    if fanout > 1:
        rel = key - scratch[:, None]
        in_scr = rel >= 0
        key_pos = torch.where(in_scr, scratch[:, None] + torch.div(
            rel, fanout, rounding_mode="floor"), key)
        key_chain = torch.where(in_scr, torch.remainder(rel, fanout), -1)
    qp = q_pos[:, :, None]
    mask = key_pos[:, None, :] <= qp
    if key_chain is not None:
        mask &= (key_chain[:, None, :] < 0) | (key_chain[:, None, :] == chain[:, :, None])
    if window > 0:
        mask &= key_pos[:, None, :] > qp - window
    return mask


def _masked_scores(q, k, q_positions, *, q_heads_per_kv, sliding_window, tree_chain,
                   tree_scratch, tree_fanout, score_scale, logit_softcap):
    """[B, Hkv, G, T, S] fp32 scores of q over a gathered [B, S, Hkv, Dh] k:
    scaled, softcapped and masked to NEG_INF."""
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = q_heads_per_kv
    assert hq == hkv * g, (hq, hkv, g)
    q_pos, chain, scratch, fanout, window = _rows(q, q_positions, tree_chain,
                                                  tree_scratch, tree_fanout,
                                                  sliding_window)
    scores = torch.einsum("bthgd,bshd->bhgts", q.float().reshape(b, t, hkv, g, dh),
                          k.float())
    scores = scores * (float(score_scale) or dh ** -0.5)
    if logit_softcap:
        cap = float(logit_softcap)
        scores = cap * torch.tanh(scores / cap)
    mask = _visible(q_pos.long(), s, window, chain, scratch, fanout)
    return torch.where(mask[:, None, None], scores, NEG_INF)


def _attend(q, k, v, q_positions, *, p_dtype, **kw):
    """The kernels' function over a gathered [B, S, Hkv, Dh] view."""
    b, t, hq, dh = q.shape
    scores = _masked_scores(q, k, q_positions, **kw)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores > NEG_INF * 0.5, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # [B, Hkv, G, T, 1]
    pv = torch.einsum("bhgts,bshd->bthgd", p.to(p_dtype).float(), v.float())
    out = pv / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, dh).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, table, q_positions, *,
                                 q_heads_per_kv, sliding_window=0, tree_chain=None,
                                 tree_scratch=None, tree_fanout=0, score_scale=0.0,
                                 logit_softcap=0.0):
    """K2's function in torch: p rounded to the pool's dtype before PV."""
    return _attend(q, _gather(k_pool, table), _gather(v_pool, table), q_positions,
                   q_heads_per_kv=q_heads_per_kv, sliding_window=sliding_window,
                   tree_chain=tree_chain, tree_scratch=tree_scratch,
                   tree_fanout=tree_fanout, score_scale=score_scale,
                   logit_softcap=logit_softcap, p_dtype=v_pool.dtype)


def paged_decode_attention_q8_plain(q, k_pool, k_scale, v_pool, v_scale, table,
                                    q_positions, *, q_heads_per_kv, sliding_window=0,
                                    tree_chain=None, tree_scratch=None, tree_fanout=0,
                                    score_scale=0.0, logit_softcap=0.0):
    """K3's function in torch: k and v dequantized in fp32, p in fp32."""
    def deq(pool, scale):
        return _gather(pool, table).float() * _gather(scale[..., None], table).float()

    return _attend(q, deq(k_pool, k_scale), deq(v_pool, v_scale), q_positions,
                   q_heads_per_kv=q_heads_per_kv, sliding_window=sliding_window,
                   tree_chain=tree_chain, tree_scratch=tree_scratch,
                   tree_fanout=tree_fanout, score_scale=score_scale,
                   logit_softcap=logit_softcap, p_dtype=torch.float32)


def _rows(q, q_positions, tree_chain, tree_scratch, tree_fanout, sliding_window):
    """Per-row int32 positions [B, T], chains [B, T] and scratch starts [B]
    (None without a tree), the fanout, and the window as an int."""
    b, t = q.shape[:2]
    dev = q.device
    pos = torch.as_tensor(q_positions, device=dev).to(torch.int32).expand(b, t)
    fanout = int(tree_fanout or 0)
    chain = scratch = None
    if fanout > 1:
        chain = torch.as_tensor(tree_chain, device=dev).to(torch.int32).expand(b, t)
        scratch = torch.as_tensor(tree_scratch, device=dev).to(torch.int32).reshape(-1)
        scratch = scratch.expand(b)
    return pos, chain, scratch, fanout, int(sliding_window or 0)


# ---------------------------------------------------------------- kernels


def paged_decode_attention(q, k_pool, v_pool, table, q_positions, *, q_heads_per_kv,
                           sliding_window=0, tree_chain=None, tree_scratch=None,
                           tree_fanout=0, score_scale=0.0, logit_softcap=0.0):
    """K2: short-query GQA over a bf16 or fp32 page pool; [B, T, Hq, Dh].
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    kw = dict(q_heads_per_kv=q_heads_per_kv, sliding_window=sliding_window,
              tree_chain=tree_chain, tree_scratch=tree_scratch, tree_fanout=tree_fanout,
              score_scale=score_scale, logit_softcap=logit_softcap)
    if _all_cpu(q, k_pool, v_pool, table):
        return paged_decode_attention_plain(q, k_pool, v_pool, table, q_positions, **kw)
    if k_pool.dtype != q.dtype:
        raise ValueError(f"paged_decode: pool dtype {k_pool.dtype} differs from q's "
                         f"{q.dtype}")
    out = _launch(q, k_pool, v_pool, None, None, table, q_positions, **kw)
    paged_decode_attention.launches += 1
    paged_decode_attention.tree_launches += int(tree_fanout or 0) > 1
    return out


def paged_decode_attention_q8(q, k_pool, k_scale, v_pool, v_scale, table, q_positions, *,
                              q_heads_per_kv, sliding_window=0, tree_chain=None,
                              tree_scratch=None, tree_fanout=0, score_scale=0.0,
                              logit_softcap=0.0):
    """K3: K2 over an int8 pool with [P, Hkv, page] bf16 scales,
    dequantized in the kernel."""
    kw = dict(q_heads_per_kv=q_heads_per_kv, sliding_window=sliding_window,
              tree_chain=tree_chain, tree_scratch=tree_scratch, tree_fanout=tree_fanout,
              score_scale=score_scale, logit_softcap=logit_softcap)
    if _all_cpu(q, k_pool, k_scale, v_pool, v_scale, table):
        return paged_decode_attention_q8_plain(q, k_pool, k_scale, v_pool, v_scale,
                                               table, q_positions, **kw)
    if k_pool.dtype != torch.int8:
        raise ValueError(f"paged_decode_q8: pool dtype {k_pool.dtype}, want int8")
    if k_pool.dim() != 4:
        raise ValueError(f"paged_decode_q8: pool {tuple(k_pool.shape)}, want [P, Hkv, page, Dh]")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (s.device != q.device or s.dtype != torch.bfloat16 or not s.is_contiguous()
                or tuple(s.shape) != tuple(k_pool.shape[:3])):
            raise ValueError(f"paged_decode_q8: {name} {tuple(s.shape)} {s.dtype} on "
                             f"{s.device}, want a contiguous bf16 "
                             f"{tuple(k_pool.shape[:3])} on {q.device}")
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, table, q_positions, **kw)
    paged_decode_attention_q8.launches += 1
    paged_decode_attention_q8.tree_launches += int(tree_fanout or 0) > 1
    return out


# kernel launches, and of those the ones that ran the tree clause
paged_decode_attention.launches = paged_decode_attention.tree_launches = 0
paged_decode_attention_q8.launches = paged_decode_attention_q8.tree_launches = 0


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _launch(q, k_pool, v_pool, k_scale, v_scale, table, q_positions, *, q_heads_per_kv,
            sliding_window, tree_chain, tree_scratch, tree_fanout, score_scale,
            logit_softcap) -> torch.Tensor:
    """Check what the kernel takes, then launch it on the current stream."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode: q on {dev}; the kernel takes CUDA tensors")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"paged_decode: q dtype {q.dtype}; the kernel takes float32 "
                         "or bfloat16")
    if q.dim() != 4 or q.stride(3) != 1:
        raise ValueError(f"paged_decode: q must be 4-D with a contiguous head_dim, got "
                         f"shape {tuple(q.shape)} strides {q.stride()}")
    b, t, hq, dh = q.shape
    g = int(q_heads_per_kv)
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {dh} not in {HEAD_DIMS}")
    if not 1 <= t <= MAX_QUERY:
        raise ValueError(f"paged_decode: {t} queries; the kernel takes 1..{MAX_QUERY}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if x.device != dev or not x.is_contiguous() or x.dim() != 4 \
                or x.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be a contiguous, 16-byte "
                             f"aligned [P, Hkv, page, Dh] tensor on {dev}")
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype \
            or k_pool.shape[3] != dh or g < 1 or hq != k_pool.shape[1] * g:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} k_pool {tuple(k_pool.shape)} "
                         f"{k_pool.dtype} v_pool {tuple(v_pool.shape)} {v_pool.dtype} G={g}")
    if table.device != dev or table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != b:
        raise ValueError(f"paged_decode: table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device}; want [{b}, max_pages] int32 on {dev}")
    table = table.contiguous()
    pos, chain, scratch, fanout, window = _rows(q, q_positions, tree_chain, tree_scratch,
                                                tree_fanout, sliding_window)
    pos = pos.contiguous()
    if chain is not None:
        chain, scratch = chain.contiguous(), scratch.contiguous()
    from layerskip_tpu_torch.ops.cuda.build import load_library

    lib = _bind(load_library("paged_decode"))
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=dev)
    kv_code = _INT8 if k_scale is not None else _Q_CODES[q.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode_launch(
            _Q_CODES[q.dtype], kv_code, dh,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            table.data_ptr(), pos.data_ptr(),
            chain.data_ptr() if chain is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            b, t, g, k_pool.shape[1], k_pool.shape[2], table.shape[1], window, fanout,
            float(score_scale) or dh ** -0.5, float(logit_softcap or 0.0),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {rc}")
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        i64, i32, ptr, f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [i32, i32, i32, *([ptr] * 10), *([i64] * 6),
                       *([i32] * 8), f32, f32, ptr]
        fn.restype = i32
    return lib
