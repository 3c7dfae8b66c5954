"""Paged cache blocks behind the ``CacheOps`` surface.

Reference: ``src/repro/runtime/cachepool.py`` — ``PageAllocator``,
``token_hash_chain``, ``PrefixCache``, the ``CacheOps`` protocol,
``ContiguousCacheOps`` and ``PagedCachePool`` (page groups by cache
length, the zero page, block tables, gather/scatter adapters,
copy-on-write, prefix sharing, capacity admission, pool telemetry).
The host side (allocator, hash chain, prefix cache, block tables,
refcounts) is a near-copy; the device side differs where torch does:

* **in place.** The reference's adapters are functional (jit, donated
  buffers); here they write the pool's tensors in place and return the
  same tree.  ``device_view`` and ``slot_view`` gather pages by advanced
  indexing, which COPIES: a step run on a view changes the pool only
  through ``commit_rows`` / ``slot_commit``.
* **the sink page.** torch has no ``mode="drop"`` scatter, and a write
  that landed on page 0 would corrupt the pristine fill every
  unallocated block reads.  Every group's page tensors therefore hold
  one extra page at index ``n_pages`` that no table maps and nothing
  reads: masked lanes, shared pages and the zero page are scattered
  there (``scatter_ids``, ``commit_rows``), so a masked write costs no
  host sync.  Comparisons with the reference's pool skip it.
* **SSM state.** The cumulative leaves stay slot-contiguous
  (``state["slot"]``), as in the reference.  ``device_view`` and
  ``slot_view`` hand out COPIES of them too, so a step run on a view
  (a paged draft, whose view is dropped) never writes the pool;
  ``commit_rows`` folds them back under the lane mask and
  ``slot_commit`` writes the slot's.  A model with no position-indexed
  cache at all (mamba2) has no page groups.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.models import cache_layout, init_caches, reset_cache_slot, write_cache_slot
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import tree_map

__all__ = [
    "PageAllocator",
    "PrefixCache",
    "token_hash_chain",
    "CacheOps",
    "ContiguousCacheOps",
    "PagedCachePool",
]


def _fill(name: str) -> int:
    return -1 if name == "pos" else 0


# ---------------------------------------------------------------------------
# page allocator (pure host state)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free-list page allocator with reference counts.

    Page 0 is the reserved zero page: never allocated, refcount pinned.
    Invariants: ``n_free + len(live) + 1 == n_pages``; ``alloc`` never
    returns a live page; refcounts never go negative; freeing everything
    restores ``n_free`` to ``n_pages - 1``.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (zero page + 1 usable)")
        self.n_pages = n_pages
        # pop() from the tail -> pages hand out in ascending order
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.refcount = np.zeros((n_pages,), np.int64)
        self.refcount[0] = 1  # the zero page is permanently pinned
        self.high_water = 0   # max live pages ever (capacity reporting)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def live(self) -> List[int]:
        return [p for p in range(1, self.n_pages) if self.refcount[p] > 0]

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError(f"page pool exhausted ({self.n_pages} pages)")
        pid = self._free.pop()
        assert self.refcount[pid] == 0, f"double allocation of page {pid}"
        self.refcount[pid] = 1
        self.high_water = max(self.high_water, self.n_pages - 1 - len(self._free))
        return pid

    def incref(self, pid: int) -> None:
        if pid == 0:
            return  # the zero page is shared by construction
        if self.refcount[pid] <= 0:
            raise ValueError(f"incref on free page {pid}")
        self.refcount[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if pid == 0:
            return False
        if self.refcount[pid] <= 0:
            raise ValueError(f"decref on free page {pid} (refcount underflow)")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)
            return True
        return False


# ---------------------------------------------------------------------------
# prefix hashing + cache
# ---------------------------------------------------------------------------


def token_hash_chain(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Digest ``i`` commits to the whole prefix ``tokens[0:(i+1)*page_size]``:
    each full page's tokens (int64 little-endian bytes) hashed with the
    previous page's digest by SHA-256.  A partial tail page is never
    hashed (never shared)."""
    chain: List[bytes] = []
    h = b""
    for i in range(len(tokens) // page_size):
        page = np.asarray(tokens[i * page_size: (i + 1) * page_size], np.int64).tobytes()
        h = hashlib.sha256(h + page).digest()
        chain.append(h)
    return chain


class PrefixCache:
    """Chain-digest -> page-run map with LRU eviction.  Entry ``i`` holds
    the page ids of blocks ``[0, i+1)`` and its own reference on each."""

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        self._entries: "OrderedDict[bytes, Tuple[int, ...]]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, chain: Sequence[bytes]) -> Tuple[int, Tuple[int, ...]]:
        """Longest cached prefix: ``(n_pages, page_ids)`` (0 = miss)."""
        for i in range(len(chain), 0, -1):
            pages = self._entries.get(chain[i - 1])
            if pages is not None:
                self._entries.move_to_end(chain[i - 1])
                return i, pages
        return 0, ()

    def insert(self, key: bytes, pages: Sequence[int]) -> bool:
        """Record a page run (one reference a page); False if the key was
        present (its LRU position refreshed)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        for p in pages:
            self._alloc.incref(p)
        self._entries[key] = tuple(pages)
        return True

    def evict_lru(self) -> int:
        """Release the least-recently-used entry; returns pages FREED."""
        if not self._entries:
            return 0
        _, pages = self._entries.popitem(last=False)
        return sum(1 for p in pages if self._alloc.decref(p))

    def drop_all(self) -> int:
        freed = 0
        while self._entries:
            freed += self.evict_lru()
        return freed


# ---------------------------------------------------------------------------
# the CacheOps protocol + contiguous implementation
# ---------------------------------------------------------------------------


@runtime_checkable
class CacheOps(Protocol):
    """The cache-lifecycle surface both pool layouts implement."""

    kind: str

    def alloc(self):
        """Allocate the device cache state for ``n_slots`` lanes."""
        ...

    def write(self, state, single, slot: int):
        """Copy a single-request tree (leaves ``(n_periods, 1, ...)``) into ``slot``."""
        ...

    def read(self, state, slot: int):
        """``slot``'s logical cache as a single-request tree."""
        ...

    def reset(self, state, slot: int):
        """Evict ``slot``: its logical cache back to the pristine fill."""
        ...

    def snapshot(self, state, slot: int):
        """A copy of ``slot``'s logical cache."""
        ...

    def restore(self, state, snap, slot: int):
        """Put a :meth:`snapshot` back into ``slot``."""
        ...


class ContiguousCacheOps:
    """Every slot owns ``max_len`` rows of the stacked pool for life.
    ``read`` hands out a VIEW of the slot (admission prefills straight
    into it); the other operations write the pool in place."""

    kind = "contiguous"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = device

    def alloc(self):
        return init_caches(self.cfg, self.n_slots, self.max_len, dtype=self.dtype,
                           device=self.device)

    def write(self, state, single, slot):
        return write_cache_slot(state, single, slot)

    def read(self, state, slot):
        """A VIEW of the slot's rows (leaves ``(n_periods, 1, ...)``)."""
        return tree_map(lambda leaf: leaf[:, slot:slot + 1], state)

    def reset(self, state, slot):
        return reset_cache_slot(state, self.cfg, slot)

    def snapshot(self, state, slot):
        return tree_map(lambda leaf: leaf[:, slot:slot + 1].clone(), state)

    def restore(self, state, snap, slot):
        return write_cache_slot(state, snap, slot)


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------


class PagedCachePool:
    """Fixed-size pages + free-list block tables (see the module docstring).

    Device state (from :meth:`alloc`): ``state["pages"][key][leaf]`` of
    shape ``(n_periods, n_pages + 1, page_size, ...)`` for every
    position-indexed cache ``key`` (the last page is the sink), and
    ``state["slot"][key][leaf]`` of shape ``(n_periods, n_slots, ...)``
    for the cumulative SSM leaves.  Adapters: :meth:`device_view`,
    :meth:`commit_rows`, :meth:`slot_view`, :meth:`slot_commit`.  Host
    lifecycle: :meth:`prepare_admission`, :meth:`ensure_rows`,
    :meth:`finish_admission`, :meth:`free_slot`, :meth:`can_admit`.
    """

    kind = "paged"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, page_size: int,
                 dtype=torch.float32, *, n_pages: Optional[int] = None,
                 prefix_sharing: bool = False, registry=None, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.dtype = dtype
        self.device = resolve_device(device)
        layout = cache_layout(cfg, max_len)
        self.slot_keys = [k for k, _, L in layout if L is None]

        # one allocator + one block table per cache length L
        by_len: Dict[int, List[str]] = {}
        for key, _, L in layout:
            if L is not None:
                by_len.setdefault(L, []).append(key)
        for L in by_len:
            if L % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide every cache length; got L={L} "
                    "(sliding window shorter than a page? use a page_size that divides "
                    "the smallest window)")

        self.shareable = bool(by_len) and not self.slot_keys and set(by_len) == {max_len}
        if prefix_sharing and not self.shareable:
            raise ValueError(
                "prefix_sharing requires a model whose caches are all full-context "
                "position-indexed (no sliding windows, no SSM state); "
                f"{cfg.name} has layout {[(k, L) for k, _, L in layout]}")
        self.prefix_sharing = prefix_sharing

        self.groups: Dict[str, dict] = {}
        for L, keys in sorted(by_len.items()):
            nb = L // page_size
            if L == max_len and n_pages is not None:
                npg = n_pages
            else:
                npg = n_slots * nb + 1  # the contiguous footprint + the zero page
                if L == max_len and prefix_sharing:
                    npg += n_slots * nb  # headroom for resident prefix entries
            self.groups[f"L{L}"] = {
                "L": L, "nb": nb, "keys": list(keys),
                "alloc": PageAllocator(npg),
                "table": np.zeros((n_slots, nb), np.int64),
            }
        self._tables_dev = None  # device mirror, rebuilt when dirty
        self._dirty = True
        self.prefix: Optional[PrefixCache] = None
        if prefix_sharing:
            self.prefix = PrefixCache(self.groups[f"L{max_len}"]["alloc"])

        if registry is None:
            from repro_torch.runtime.telemetry import MetricsRegistry
            registry = MetricsRegistry()
        self._registry = registry
        self._m_allocs = registry.counter(
            "page_allocs_total", "pages handed out by the free-list allocator",
            labelnames=("group",))
        self._m_cow = registry.counter("cow_copies_total", "copy-on-write page duplications")
        self._m_prefix_evictions = registry.counter(
            "prefix_evictions_total", "prefix-cache LRU entries released under page pressure")
        self._m_pages_free = registry.gauge(
            "pages_free", "free pages per group", labelnames=("group",))
        self._m_pages_live = registry.gauge(
            "pages_live", "resident (refcounted) pages per group", labelnames=("group",))
        self._m_pages_hw = registry.gauge(
            "pages_high_water", "max pages ever live per group", labelnames=("group",))
        self._m_prefix_entries = registry.gauge(
            "prefix_entries", "prefix-cache entries resident")

        # the paged pool stores exactly the contiguous initializer's leaves
        # (shapes and dtypes only: no memory on the meta device)
        single = init_caches(cfg, 1, max_len, dtype=dtype, device="meta")
        self._templates = {key: {name: (leaf.shape, leaf.dtype) for name, leaf in node.items()}
                           for key, node in single.items()}

    # -- device state -------------------------------------------------------

    def sink(self, gk: str) -> int:
        """The group's sink page: the write target of dropped rows."""
        return self.groups[gk]["alloc"].n_pages

    def alloc(self):
        pages = {}
        for g in self.groups.values():
            n = g["alloc"].n_pages + 1  # + the sink page
            for key in g["keys"]:
                pages[key] = {
                    name: torch.full((shape[0], n, self.page_size) + tuple(shape[3:]),
                                     _fill(name), dtype=dt, device=self.device)
                    for name, (shape, dt) in self._templates[key].items()}
        slot = {key: {name: torch.zeros((shape[0], self.n_slots) + tuple(shape[2:]), dtype=dt,
                                        device=self.device)
                      for name, (shape, dt) in self._templates[key].items()}
                for key in self.slot_keys}
        return {"pages": pages, "slot": slot}

    def _dev(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def device_tables(self):
        """Device mirror of the block tables, uploaded when they changed."""
        if self._dirty or self._tables_dev is None:
            self._tables_dev = {gk: self._dev(g["table"]) for gk, g in self.groups.items()}
            self._dirty = False
        return self._tables_dev

    def slot_tables(self, slot: int):
        """One slot's table rows (device), for the B=1 admission path."""
        return {gk: self._dev(g["table"][slot]) for gk, g in self.groups.items()}

    def scatter_ids(self, slot: int):
        """Per-group scatter targets for a whole-slot commit: the slot's
        page per block, with the non-writable ones (the zero page and any
        SHARED page) sent to the sink."""
        out = {}
        for gk, g in self.groups.items():
            row = g["table"][slot].copy()
            drop = (row == 0) | (g["alloc"].refcount[row] > 1)
            row[drop] = self.sink(gk)
            out[gk] = self._dev(row)
        return out

    def zero_pages(self, state, gk: str, pids: Sequence[int]):
        """Pristine-fill pages ``pids`` of one group, in place (a fresh page
        must not show its previous occupant's rows)."""
        idx = self._dev(np.asarray(pids, np.int64))
        for key in self.groups[gk]["keys"]:
            for name, arr in state["pages"][key].items():
                arr[:, idx] = _fill(name)
        return state

    def copy_page(self, state, gk: str, src: int, dst: int):
        """Copy-on-write body: duplicate one page of one group, in place."""
        for key in self.groups[gk]["keys"]:
            for arr in state["pages"][key].values():
                arr[:, dst] = arr[:, src]
        return state

    # -- gather/scatter adapters ---------------------------------------------

    def device_view(self, state, tables):
        """Gather the logical ``(n_periods, B, L, ...)`` cache tree the model
        steps consume (a copy; unallocated blocks show the zero page)."""
        view = {}
        for gk, g in self.groups.items():
            t = tables[gk]  # (B, nb)
            for key in g["keys"]:
                view[key] = {}
                for name, arr in state["pages"][key].items():
                    gathered = arr[:, t]  # (P, B, nb, ps, *tail)
                    view[key][name] = gathered.reshape(
                        gathered.shape[:2] + (g["L"],) + gathered.shape[4:])
        for key in self.slot_keys:
            view[key] = {name: arr.clone() for name, arr in state["slot"][key].items()}
        return view

    def commit_rows(self, state, tables, view, pos, mask, n_rows: int = 1):
        """Scatter ``n_rows`` rows per lane from a view back into the pages,
        in place: row ``j`` of lane ``b`` at logical position ``pos[b] + j``
        (mod L for rolling windows).  Masked lanes write to the sink.  For
        the speculative verify the view's rejected rows carry their
        restored pre-segment bits, so the scatter IS the page restore.
        The SSM leaves of the mask's lanes are copied back whole."""
        ps = self.page_size
        pos = pos.to(torch.long)
        B = pos.shape[0]
        lanes = torch.arange(B, device=pos.device)[:, None]
        rows = torch.arange(n_rows, device=pos.device)[None]
        keep = mask.to(torch.bool)[:, None]
        for gk, g in self.groups.items():
            idx = (pos[:, None] + rows) % g["L"]                  # (B, R) logical rows
            pid = tables[gk].gather(1, idx // ps)
            pid = torch.where(keep, pid, torch.full_like(pid, self.sink(gk)))
            off = idx % ps
            for key in g["keys"]:
                for name, arr in state["pages"][key].items():
                    arr[:, pid, off] = view[key][name][:, lanes, idx].to(arr.dtype)
        for key in self.slot_keys:
            for name, arr in state["slot"][key].items():
                m = mask.to(torch.bool).reshape((1, -1) + (1,) * (arr.ndim - 2))
                arr.copy_(torch.where(m, view[key][name].to(arr.dtype), arr))
        return state

    def slot_view(self, state, slot_tables, slot: int):
        """One slot's logical cache as a ``(n_periods, 1, ...)`` tree (a copy;
        the chunked-prefill admission view)."""
        view = {}
        for gk, g in self.groups.items():
            t = slot_tables[gk]  # (nb,)
            for key in g["keys"]:
                view[key] = {}
                for name, arr in state["pages"][key].items():
                    gathered = arr[:, t]  # (P, nb, ps, *tail)
                    view[key][name] = gathered.reshape(
                        (gathered.shape[0], 1, g["L"]) + gathered.shape[3:])
        for key in self.slot_keys:
            view[key] = {name: arr[:, slot:slot + 1].clone()
                         for name, arr in state["slot"][key].items()}
        return view

    def slot_commit(self, state, scatter_ids, slot: int, view):
        """Scatter a whole single-slot view back, in place: every WRITABLE
        block gets its page worth of rows; shared and zero blocks go to
        the sink (their view rows equal the page content by construction:
        prefix pages are read-only and padded segment writes were rolled
        back before the commit)."""
        for gk, g in self.groups.items():
            sp = scatter_ids[gk]  # (nb,)
            for key in g["keys"]:
                for name, arr in state["pages"][key].items():
                    v = view[key][name]  # (P, 1, L, *tail)
                    arr[:, sp] = v.reshape((v.shape[0], g["nb"], self.page_size)
                                           + v.shape[3:]).to(arr.dtype)
        for key in self.slot_keys:
            for name, arr in state["slot"][key].items():
                arr[:, slot:slot + 1] = view[key][name].to(arr.dtype)
        return state

    # -- host lifecycle ------------------------------------------------------

    def _evict_prefix(self) -> int:
        """Release one LRU prefix entry (counted); returns pages freed."""
        had = len(self.prefix)
        freed = self.prefix.evict_lru()
        if len(self.prefix) < had:
            self._m_prefix_evictions.inc()
        return freed

    def _alloc_page(self, gk: str) -> int:
        """Allocate one page, evicting LRU prefix entries under pressure."""
        g = self.groups[gk]
        while True:
            try:
                pid = g["alloc"].alloc()
                self._m_allocs.inc(group=gk)
                return pid
            except MemoryError:
                if self.prefix is None or not self._evict_prefix():
                    raise MemoryError(
                        f"page pool {gk} exhausted ({g['alloc'].n_pages} pages, none "
                        "evictable); raise ServingConfig.n_pages") from None

    def _attach_fresh(self, state, slot: int, gk: str, blocks: Sequence[int]):
        """Allocate + pristine-fill pages for ``blocks`` of ``slot``."""
        g = self.groups[gk]
        fresh = []
        for b in blocks:
            pid = self._alloc_page(gk)
            g["table"][slot, b] = pid
            fresh.append(pid)
        if fresh:
            state = self.zero_pages(state, gk, fresh)
            self._dirty = True
        return state

    def _ensure_exclusive(self, state, slot: int, gk: str, block: int):
        """Copy-on-write: make ``block`` of ``slot`` privately owned."""
        g = self.groups[gk]
        pid = int(g["table"][slot, block])
        if pid != 0 and g["alloc"].refcount[pid] == 1:
            return state
        dst = self._alloc_page(gk)
        if pid == 0:
            # a fresh block: pristine-fill instead of copying the zero page
            state = self.zero_pages(state, gk, [dst])
        else:
            state = self.copy_page(state, gk, pid, dst)
            g["alloc"].decref(pid)
            self._m_cow.inc()
        g["table"][slot, block] = dst
        self._dirty = True
        return state

    def ensure_rows(self, state, slot: int, lo: int, hi: int):
        """Make positions ``[lo, hi]`` of ``slot`` writable in every group:
        allocate missing blocks (pristine), copy-on-write shared ones."""
        ps = self.page_size
        for gk, g in self.groups.items():
            L = g["L"]
            blocks = sorted({(p % L) // ps for p in range(lo, hi + 1)})
            missing = [b for b in blocks if g["table"][slot, b] == 0]
            if missing:
                state = self._attach_fresh(state, slot, gk, missing)
            for b in blocks:
                if g["alloc"].refcount[int(g["table"][slot, b])] > 1:
                    state = self._ensure_exclusive(state, slot, gk, b)
        return state

    def prepare_admission(self, state, slot: int, prompt: Sequence[int]):
        """Prefix match + attach, then the rest of the prompt's blocks (plus
        the first decode block) fresh; a sliding-window group takes its
        whole window; the slot's SSM leaves start from zero (the chunked
        prefill carries them from chunk to chunk).  Returns ``(state,
        matched_tokens, chain)``."""
        plen = len(prompt)
        self._zero_slot_leaves(state, slot)
        for g in self.groups.values():
            assert (g["table"][slot] == 0).all(), (
                f"slot {slot} still holds pages — free_slot before re-admission")
        matched = 0
        chain: List[bytes] = []
        if self.prefix is not None:
            chain = token_hash_chain(prompt, self.page_size)
            # the block of position plen (the first decode write) must stay
            # writable, so a page-aligned prompt never attaches its last page
            n_match, pages = self.prefix.match(chain[: max(0, (plen - 1) // self.page_size)])
            if n_match:
                g = self.groups[f"L{self.max_len}"]
                for b in range(n_match):
                    g["alloc"].incref(pages[b])
                    g["table"][slot, b] = pages[b]
                self._dirty = True
                matched = n_match * self.page_size
        ps = self.page_size
        for gk, g in self.groups.items():
            if g["L"] < self.max_len:
                blocks = list(range(g["nb"]))  # the whole rolling window
            else:
                blocks = list(range(matched // ps, plen // ps + 1))
            missing = [b for b in blocks if g["table"][slot, b] == 0]
            state = self._attach_fresh(state, slot, gk, missing)
        return state, matched, chain

    def finish_admission(self, slot: int, chain: Sequence[bytes], matched: int) -> int:
        """After the tail prefill: publish this slot's full-page runs into
        the prefix cache; returns the number of NEW entries."""
        if self.prefix is None or not chain:
            return 0
        g = self.groups[f"L{self.max_len}"]
        inserted = 0
        for i in range(matched // self.page_size + 1, len(chain) + 1):
            if self.prefix.insert(chain[i - 1], g["table"][slot, :i].tolist()):
                inserted += 1
        return inserted

    def free_slot(self, slot: int) -> None:
        """Release every table reference of the slot (freed pages keep
        their stale bits: allocation pristine-fills)."""
        for g in self.groups.values():
            row = g["table"][slot]
            for b in range(g["nb"]):
                if row[b]:
                    g["alloc"].decref(int(row[b]))
            row[:] = 0
        self._dirty = True

    def can_admit(self, prompt: Sequence[int]) -> bool:
        """Enough free (or LRU-evictable) pages for the prompt's worst-case
        block span in every group (prefix savings not assumed)."""
        plen = len(prompt)
        for g in self.groups.values():
            need = g["nb"] if g["L"] < self.max_len else plen // self.page_size + 1
            free = g["alloc"].n_free
            if free < need and self.prefix is not None:
                while free < need and self._evict_prefix() >= 0 and len(self.prefix):
                    free = g["alloc"].n_free
                free = g["alloc"].n_free
            if free < need:
                return False
        return True

    # -- CacheOps completeness (host/test paths) ------------------------------

    def write(self, state, single, slot):
        """Copy a fully populated single-request tree into ``slot`` (the
        slot's whole block span allocated and made exclusive)."""
        for gk, g in self.groups.items():
            missing = [b for b in range(g["nb"]) if g["table"][slot, b] == 0]
            state = self._attach_fresh(state, slot, gk, missing)
        for gk in self.groups:
            for b in range(self.groups[gk]["nb"]):
                state = self._ensure_exclusive(state, slot, gk, b)
        return self.slot_commit(state, self.scatter_ids(slot), slot, single)

    def read(self, state, slot):
        return self.slot_view(state, self.slot_tables(slot), slot)

    def _zero_slot_leaves(self, state, slot: int) -> None:
        for key in self.slot_keys:
            for arr in state["slot"][key].values():
                arr[:, slot] = 0

    def reset(self, state, slot):
        self.free_slot(slot)
        self._zero_slot_leaves(state, slot)
        return state

    def snapshot(self, state, slot):
        return self.read(state, slot)  # a gather is already a copy

    def restore(self, state, snap, slot):
        return self.write(state, snap, slot)

    # -- reporting -----------------------------------------------------------

    def scrape_gauges(self) -> None:
        """Refresh the occupancy gauges from the allocators."""
        for gk, g in self.groups.items():
            a = g["alloc"]
            self._m_pages_free.set(a.n_free, group=gk)
            self._m_pages_live.set(a.n_pages - 1 - a.n_free, group=gk)
            self._m_pages_hw.set(a.high_water, group=gk)
        if self.prefix is not None:
            self._m_prefix_entries.set(len(self.prefix))

    def report(self) -> dict:
        """Pages resident / high-water per group, beside the contiguous
        pool's footprint for the same slots."""
        out = {"page_size": self.page_size, "groups": {}}
        for gk, g in self.groups.items():
            a = g["alloc"]
            out["groups"][gk] = {
                "n_pages": a.n_pages, "live": len(a.live()), "high_water": a.high_water,
                "contiguous_pages_equiv": self.n_slots * g["nb"],
            }
        if self.prefix is not None:
            out["prefix_entries"] = len(self.prefix)
        return out
