"""Paged KV cache: a shared page pool and per-slot page tables (port of
``layerskip_tpu/ops/paged_kv.py``).

Continuous serving cannot afford one worst-case-length KV buffer per slot.
A slot owns just enough fixed-size pages for its prompt, token budget and
speculation overhang, drawn from a pool shared by every slot.

  * pool: ``[P, Hkv, page, Dh]`` per layer (``[L, P, Hkv, page, Dh]``
    stacked), page-major and head-contiguous, so one (page, head) is one
    contiguous ``[page, Dh]`` tile for the decode kernels (K2/K3).
  * table: ``[B, max_pages]`` int32. Logical position ``p`` of row ``b``
    lives at ``pool[table[b, p // page], :, p % page]``.
  * Unmapped entries point at the first trash page, appended past the
    allocatable pages. Writes past a slot's mapping (padded prompt tails,
    idle rows in a round) land there and are never visible: the mask
    ``key <= q_pos`` and an allocation that maps every position a frontier
    can reach keep trash out of every live query's view.
  * Allocation is host-side (``PageAllocator``, ``PrefixCache``); the device
    only ever reads a fully built table.

Unlike the JAX package, which replicates the table per layer
(``[L, B, max_pages]``) and returns new buffers, the port keeps ONE
``[B, max_pages]`` tensor shared by k, v and both layer groups, and updates
the pool and the table in place (insert and park write the table rows).
The two are equivalent because the JAX package always updates every copy
of the table together. The JAX insert parks the rows it does not insert at
``trash_start``; the port's insert runs only the inserted rows, so only the
geometry (``paged_geometry``, kept equal to the JAX package's) still
reserves that region. ``tree_compact`` moves tree speculation's winning
chain (generation/tree.py) into the contiguous frontier, in place: a
W-slot gather into a new tensor, then a scatter, so the overlapping source
and destination never mix.

Under tensor parallelism (parallel/collectives.py) a rank's pools hold its
``Hkv/tp`` kv heads; the tables, the allocator and the prefix cache are the
same on every rank, which take the same host decisions from the same full
logits, so they evolve alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.ops.kv_cache import KVCache
from layerskip_tpu_torch.parallel.collectives import axis, size


def _page_slots(table: torch.Tensor, write_pos: Union[int, torch.Tensor], t: int,
                page: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pool page [B, T], in-page offset [B, T]) of the logical slots
    ``write_pos + arange(T)`` (``write_pos`` an int, a 0-d or a [B] tensor).
    Positions past the table wrap onto its last entry, a trash page."""
    b, maxp = table.shape
    steps = torch.arange(t, device=table.device)
    if isinstance(write_pos, torch.Tensor):
        pos = write_pos.to(table.device).long().reshape(-1, 1) + steps
    else:
        pos = int(write_pos) + steps[None, :]
    pos = pos.expand(b, t)
    lp = (pos // page).clamp(max=maxp - 1)
    return table.gather(1, lp).long(), pos % page


def _move_slots(bufs, lead: int, table: torch.Tensor, start: torch.Tensor,
                idx: torch.Tensor, page: int) -> None:
    """In each of ``bufs`` ([(L,) P, Hkv, page(, Dh)], ``lead`` = 1 when
    stacked over layers) copy the logical slots ``idx`` [B, W] to
    ``start + arange(W)`` [B] through ``table``: every source is gathered
    before any destination is written."""
    w = idx.shape[1]
    lp = (idx.long() // page).clamp(max=table.shape[1] - 1)
    src = (slice(None),) * lead + (table.gather(1, lp).long(), slice(None),
                                   idx.long() % page)
    pidx, poff = _page_slots(table, start, w, page)
    dst = (slice(None),) * lead + (pidx, slice(None), poff)
    blocks = [buf[src] for buf in bufs]  # advanced indexing copies
    for buf, blk in zip(bufs, blocks):
        buf[dst] = blk


@dataclasses.dataclass
class PagedKV:
    """One paged K or V buffer of a layer group.

    pool: [(L,) P, Hkv, page, Dh]; table: [B, max_pages] int32 (shared).
    ``capacity`` is the logical per-slot capacity the table maps (trash
    excluded); ``trash_start`` the page-aligned position where park and
    overflow writes begin. A stacked buffer indexes per layer as ``kv[j]``
    and reports ``shape[0] == L``, as ``run_layers`` expects.
    """

    pool: torch.Tensor
    table: torch.Tensor
    capacity: int
    trash_start: int

    @property
    def shape(self):
        return self.pool.shape

    @property
    def page_size(self) -> int:
        return self.pool.shape[-2]

    @property
    def max_pages(self) -> int:
        return self.table.shape[-1]

    def __getitem__(self, idx) -> "PagedKV":
        return dataclasses.replace(self, pool=self.pool[idx])

    def write(self, new: torch.Tensor, write_pos) -> "PagedKV":
        """Scatter a [B, T, Hkv, Dh] block at logical offset ``write_pos``
        through the table, in place (per-layer view)."""
        pidx, poff = _page_slots(self.table, write_pos, new.shape[1], self.page_size)
        self.pool[pidx, :, poff] = new.to(self.pool.dtype)
        return self

    def tree_compact(self, start: torch.Tensor, idx: torch.Tensor) -> "PagedKV":
        """Move the logical slots ``idx`` [B, W] to ``start .. start + W - 1``
        ([B]) through the table, in place, stacked or per layer (tree
        speculation's winning-chain compaction)."""
        _move_slots((self.pool,), self.pool.dim() - 4, self.table, start, idx,
                    self.page_size)
        return self

    def gather_view(self, dtype=None) -> torch.Tensor:
        """The logical [B, max_pages * page, Hkv, Dh] view (the gathered
        path and the tests; the kernels read pages in place)."""
        v = _gather_pages(self.pool, self.table)
        return v if dtype is None else v.to(dtype)


@dataclasses.dataclass
class PagedQuantKV:
    """int8 paged K or V buffer: ``PagedKV``'s layout with ``QuantKV``'s
    per-(token, head) symmetric quantization.

    pool: [(L,) P, Hkv, page, Dh] int8; scale: [(L,) P, Hkv, page] bf16;
    table as in ``PagedKV``."""

    pool: torch.Tensor
    scale: torch.Tensor
    table: torch.Tensor
    capacity: int
    trash_start: int

    @property
    def shape(self):
        return self.pool.shape

    @property
    def page_size(self) -> int:
        return self.pool.shape[-2]

    @property
    def max_pages(self) -> int:
        return self.table.shape[-1]

    def __getitem__(self, idx) -> "PagedQuantKV":
        return dataclasses.replace(self, pool=self.pool[idx], scale=self.scale[idx])

    def write(self, new: torch.Tensor, write_pos) -> "PagedQuantKV":
        """Quantize a [B, T, Hkv, Dh] block as ``QuantKV.write`` does (the
        fp32 scale rounds, then is stored in bf16) and scatter it through
        the table, in place."""
        nf = new.float()
        scale = (nf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)  # [B, T, Hkv]
        q = torch.round(nf / scale[..., None]).clamp(-127, 127).to(torch.int8)
        pidx, poff = _page_slots(self.table, write_pos, new.shape[1], self.page_size)
        self.pool[pidx, :, poff] = q
        self.scale[pidx, :, poff] = scale.to(self.scale.dtype)
        return self

    def tree_compact(self, start: torch.Tensor, idx: torch.Tensor) -> "PagedQuantKV":
        """``PagedKV.tree_compact`` over the int8 pool: the raw int8 values
        and their scales move, with no requantization."""
        _move_slots((self.pool, self.scale), self.pool.dim() - 4, self.table, start, idx,
                    self.page_size)
        return self

    def gather_view(self, dtype=None) -> torch.Tensor:
        """Dequantized logical [B, max_pages * page, Hkv, Dh] view (fp32,
        or ``dtype``)."""
        q = _gather_pages(self.pool, self.table).float()
        s = _gather_pages(self.scale[..., None], self.table).float()
        v = q * s
        return v if dtype is None else v.to(dtype)


def _gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [P, H, page, X] through table [B, maxp] -> [B, maxp * page, H, X]."""
    b, maxp = table.shape
    _, h, page, x = pool.shape
    v = pool[table.long()]  # [B, maxp, H, page, X]
    return v.permute(0, 1, 3, 2, 4).reshape(b, maxp * page, h, x)


def paged_geometry(capacity: int, page_size: int, prompt_bucket: int
                   ) -> Tuple[int, int, int]:
    """(cap_pages, trash_pages, max_pages) for a logical per-slot
    ``capacity`` plus a trash region absorbing ``prompt_bucket`` parked
    writes starting at the page-aligned ``trash_start = cap_pages * page``."""
    cap_pages = -(-capacity // page_size)
    trash_pages = -(-prompt_bucket // page_size)
    return cap_pages, trash_pages, cap_pages + trash_pages


def init_paged_group(
    cfg: ModelConfig,
    nlayers: int,
    batch: int,
    pool_pages: int,
    page_size: int,
    capacity: int,
    prompt_bucket: int,
    dtype=None,
    quant: bool = False,
    table: Optional[torch.Tensor] = None,
    device="cuda",
) -> KVCache:
    """KVCache-shaped (k, v) pair of stacked ``PagedKV``/``PagedQuantKV``.

    ``pool_pages`` counts allocatable pages; the trash pages are appended.
    Every table entry starts at the first trash page. Pass ``table`` to
    share one table between layer groups (the engine does)."""
    dtype = dtype or cfg.dtype
    cap_pages, trash_pages, max_pages = paged_geometry(capacity, page_size, prompt_bucket)
    # under tp a rank's pool holds its kv heads; tables stay whole
    shape = (nlayers, pool_pages + trash_pages,
             cfg.num_key_value_heads // size(axis("tp")), page_size, cfg.head_dim)
    if table is None:
        table = torch.full((batch, max_pages), pool_pages, dtype=torch.int32, device=device)
    if tuple(table.shape) != (batch, max_pages) or table.dtype != torch.int32:
        raise ValueError(f"table {tuple(table.shape)} {table.dtype}, want "
                         f"({batch}, {max_pages}) int32")
    cap = cap_pages * page_size

    def mk():
        if quant:
            return PagedQuantKV(
                pool=torch.zeros(shape, dtype=torch.int8, device=table.device),
                scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=table.device),
                table=table, capacity=cap, trash_start=cap)
        return PagedKV(pool=torch.zeros(shape, dtype=dtype, device=table.device),
                       table=table, capacity=cap, trash_start=cap)

    return KVCache(k=mk(), v=mk())


class PageAllocator:
    """Host-side refcounted free-list allocator over ``pool_pages`` pages.

    Trash pages (indices >= pool_pages) are permanently mapped and never
    allocated. ``PagePoolExhausted`` is the scheduler's backpressure signal:
    the request waits until a finished slot frees its pages. Pages are
    refcounted so the prefix cache can share read-only prompt pages across
    slots (each sharer and the cache hold one reference each; a page returns
    to the free list when the last reference drops)."""

    def __init__(self, pool_pages: int, page_size: int):
        self.page_size = page_size
        self.pool_pages = pool_pages
        self._free = list(range(pool_pages - 1, -1, -1))  # pop() -> page 0 first
        self._owned = {}  # slot -> [page, ...]
        self._refs = {}  # page -> live reference count (absent == free)

    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-max(int(tokens), 1) // self.page_size)

    def addref(self, pages) -> None:
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1

    def decref(self, pages) -> None:
        for p in pages:
            n = self._refs.get(p, 0) - 1
            if n <= 0:
                self._refs.pop(p, None)
                self._free.append(p)
            else:
                self._refs[p] = n

    def allocate(self, slot: int, tokens: int, shared=()):
        """Map ``tokens`` logical positions for ``slot``; returns the page
        list. ``shared`` pages (an already referenced prefix) gain a
        reference and come first; only the rest draws fresh pages. Frees the
        slot's previous pages first (slot reuse)."""
        self.release(slot)
        shared = list(shared)
        need = self.pages_needed(tokens) - len(shared)
        if need > len(self._free):
            raise PagePoolExhausted(
                f"need {need} pages for slot {slot}, "
                f"{len(self._free)} free of {self.pool_pages}")
        fresh = [self._free.pop() for _ in range(max(need, 0))]
        self.addref(shared)
        self.addref(fresh)
        pages = shared + fresh
        self._owned[slot] = pages
        return pages

    def release(self, slot: int) -> None:
        self.decref(self._owned.pop(slot, ()))

    def owned(self, slot: int) -> list:
        return list(self._owned.get(slot, ()))

    def snapshot(self):
        return (list(self._free), {s: list(p) for s, p in self._owned.items()},
                dict(self._refs))

    def restore(self, snap) -> None:
        self._free = list(snap[0])
        self._owned = {s: list(p) for s, p in snap[1].items()}
        self._refs = dict(snap[2])


class PrefixCache:
    """Host-side prompt-prefix page cache.

    Keys are page-aligned token prefixes. A page is cacheable only when
    prompt tokens fill it: decode writes begin at ``prompt_len``, so full
    prompt pages never change after the prefill (the sharing-safety
    invariant). An entry holds one allocator reference per page; sharers add
    their own. ``match`` returns the longest cached aligned prefix strictly
    shorter than the prompt (the engine re-processes at least one suffix
    token for the first logits). Eviction is LRU over entries and frees only
    pages whose last reference is the cache's."""

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self._entries = {}  # key (tuple of tokens) -> [pages]
        self._clock = 0
        self._last_used = {}  # key -> clock
        self.hits = 0
        self.hit_tokens = 0

    def match(self, prompt):
        """-> (prefix_tokens, pages) for the longest cached aligned prefix
        shorter than ``prompt``; (0, []) on a miss."""
        pg = self.page_size
        toks = tuple(prompt)
        for n in range((len(toks) - 1) // pg, 0, -1):
            key = toks[: n * pg]
            pages = self._entries.get(key)
            if pages is not None:
                self._clock += 1
                self._last_used[key] = self._clock
                self.hits += 1
                self.hit_tokens += n * pg
                return n * pg, list(pages)
        return 0, []

    def put(self, prompt, pages) -> None:
        """Register every aligned full-page prefix of ``prompt`` whose pages
        are ``pages[:n]`` (the slot's prompt pages, in logical order)."""
        pg = self.page_size
        toks = tuple(prompt)
        for n in range(1, len(toks) // pg + 1):
            key = toks[: n * pg]
            if key in self._entries:
                continue
            entry = pages[:n]
            if len(entry) < n:
                break
            self.alloc.addref(entry)
            self._entries[key] = list(entry)
            self._clock += 1
            self._last_used[key] = self._clock

    def evict(self, pages_wanted: int) -> int:
        """Drop LRU entries until about ``pages_wanted`` pages could return
        to the free list (pages still shared by live slots survive and only
        lose the cache's reference). Returns the entries dropped."""
        order = sorted(self._entries, key=lambda k: self._last_used[k])
        dropped = 0
        freed_before = self.alloc.free_pages()
        for key in order:
            if self.alloc.free_pages() - freed_before >= pages_wanted:
                break
            self.alloc.decref(self._entries.pop(key))
            self._last_used.pop(key, None)
            dropped += 1
        return dropped

    def clear(self) -> None:
        for key in list(self._entries):
            self.alloc.decref(self._entries.pop(key))
        self._last_used.clear()


class PagePoolExhausted(RuntimeError):
    pass
