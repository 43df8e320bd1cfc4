"""Paged KV-cache pool + host-side allocator (vLLM's PagedAttention)
and the shared-prefix radix cache built on top of it (SGLang's
RadixAttention, at page granularity).

:class:`PagedPool` holds the global page pool as torch tensors on one
device, ``[L, n_pages, page, Hk, hd]`` per K/V, page-major; the paged
attention kernels (``kernels/paged_attention.py``,
``kernels/chunked_prefill.py``) read it through per-sequence page
tables, and :func:`write_prefill_pages` scatters a single-shot
prefill's K/V into pages in place. Everything else —
:class:`PagedAllocator`, :class:`PrefixTree`,
:class:`PagedSeqLedger`, :func:`prefix_page_key` — is pure host-side
bookkeeping, copied unchanged from the JAX package's
``serving/kv_cache.py`` so both engines run the identical allocation
and prefix-sharing state machine.

Fragmentation-free by construction: every allocation is page-granular,
exactly the property the vLLM paper exploits to push batch sizes up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclass
class PagedPool:
    """Device-side page pool for one model: [L, n_pages, page, Hk, hd].

    The engine updates ``k``/``v`` in place (the JAX engine rebinds a
    new pool after every functional update)."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int

    @classmethod
    def create(cls, cfg: ModelConfig, n_pages: int, page_size: int = 128,
               dtype: Optional[torch.dtype] = None,
               device: "str | torch.device" = "cuda") -> "PagedPool":
        dtype = dtype or getattr(torch, cfg.dtype)
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   page_size=page_size)

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]


class OutOfPagesError(RuntimeError):
    pass


class PagedAllocator:
    """Host-side page accounting. Deterministic (free list is a stack)."""

    def __init__(self, n_pages: int, page_size: int,
                 pages_per_seq: int) -> None:
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        # seq_id -> (page ids, current token length)
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        self.n_pages = n_pages

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def can_admit(self, prompt_tokens: int, max_new: int) -> bool:
        return self.pages_needed(prompt_tokens + max_new) <= self.free_pages

    def alloc(self, seq_id: int, n_tokens: int) -> List[int]:
        """Allocate pages for a prefill of ``n_tokens``."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            raise OutOfPagesError(
                f"need {need} pages, only {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        self._lens[seq_id] = n_tokens
        return pages

    def extend(self, seq_id: int, n_new: int = 1) -> List[int]:
        """Grow a sequence by ``n_new`` tokens; allocate pages on
        boundary crossings. Returns any newly-allocated pages."""
        pages = self._tables[seq_id]
        old_len = self._lens[seq_id]
        new_len = old_len + n_new
        need = self.pages_needed(new_len) - len(pages)
        fresh: List[int] = []
        if need > 0:
            if need > len(self._free):
                raise OutOfPagesError(
                    f"seq {seq_id}: need {need} pages, "
                    f"{len(self._free)} free")
            fresh = [self._free.pop() for _ in range(need)]
            pages.extend(fresh)
        self._lens[seq_id] = new_len
        return fresh

    def free(self, seq_id: int) -> None:
        for p in self._tables.pop(seq_id):
            self._free.append(p)
        del self._lens[seq_id]

    # --- raw page ops (prefix-tree ownership) --------------------------
    # The prefix tree owns pages directly rather than through a seq
    # table: its pages belong to *content* (a shared prefix), not to any
    # one sequence's lifetime.
    def alloc_raw(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list with no seq accounting."""
        if n > len(self._free):
            raise OutOfPagesError(
                f"need {n} raw pages, only {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free_raw(self, pages: Sequence[int]) -> None:
        """Return raw pages (from :meth:`alloc_raw`) to the free list."""
        self._free.extend(pages)

    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def table(self, seq_id: int) -> List[int]:
        return self._tables[seq_id]

    # ------------------------------------------------------------------
    def table_array(self, seq_ids: List[Optional[int]]) -> np.ndarray:
        """[B, pages_per_seq] int32 physical page ids (0-padded) for the
        current batch — the scalar-prefetch operand of the kernel."""
        out = np.zeros((len(seq_ids), self.pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            pages = self._tables[sid]
            out[i, :len(pages)] = pages
        return out

    def lens_array(self, seq_ids: List[Optional[int]]) -> np.ndarray:
        return np.array([0 if sid is None else self._lens[sid]
                         for sid in seq_ids], np.int32)

    # --- checkpoint/restore -------------------------------------------
    def state_dict(self) -> dict:
        return {"free": list(self._free),
                "tables": {str(k): v for k, v in self._tables.items()},
                "lens": {str(k): v for k, v in self._lens.items()}}

    def load_state_dict(self, state: dict) -> None:
        self._free = list(state["free"])
        self._tables = {int(k): list(v) for k, v in state["tables"].items()}
        self._lens = {int(k): int(v) for k, v in state["lens"].items()}


# ----------------------------------------------------------------------
# Shared-prefix radix cache (SGLang RadixAttention, page-granular)
# ----------------------------------------------------------------------

def prefix_page_key(prefix_group: Optional[Hashable],
                    shared_prefix_tokens: int,
                    page_size: int) -> Tuple[Hashable, ...]:
    """Page-granular cache key for a request's shared prompt prefix:
    one hashable element per *full* page of the prefix. Only full pages
    are shareable — a partially-filled page cannot be referenced by two
    sequences that diverge inside it (that is the copy-on-write
    boundary), so the partial remainder is always prefilled privately.
    Returns () when the request carries no shareable prefix."""
    if prefix_group is None or shared_prefix_tokens < page_size:
        return ()
    return tuple((prefix_group, i)
                 for i in range(shared_prefix_tokens // page_size))


def pages_needed_array(n_tokens: np.ndarray, page_size: int) -> np.ndarray:
    """Vectorized :meth:`PagedAllocator.pages_needed`: per-sequence
    page counts (ceil division, min 1 page per live sequence) over an
    int array of token counts. Used by the flat-array simulator core's
    telemetry to reproduce the object engine's per-slot page rounding
    without a per-slot Python loop."""
    tokens = np.asarray(n_tokens)
    return np.maximum(1, -(-tokens // page_size))


class PrefixNode:
    """One radix-tree node: a run of consecutive prefix pages.

    ``key`` is the compressed key segment (one element per page) and
    ``pages`` the physical page ids backing it (``len(pages) ==
    len(key)``). ``refcount`` counts live sequences currently reading
    these pages (locked via :meth:`PrefixTree.lock`); only unreferenced
    *leaves* are evictable. ``last_access`` drives LRU eviction."""

    __slots__ = ("key", "pages", "children", "parent", "refcount",
                 "last_access")

    def __init__(self, key: Tuple[Hashable, ...], pages: List[int],
                 parent: Optional["PrefixNode"],
                 last_access: float = 0.0) -> None:
        self.key = key
        self.pages = pages
        self.children: Dict[Hashable, "PrefixNode"] = {}
        self.parent = parent
        self.refcount = 0
        self.last_access = last_access

    def is_leaf(self) -> bool:
        return not self.children


class PrefixTree:
    """Radix tree of shared-prefix KV pages over a :class:`PagedAllocator`.

    The RadixAttention design at page granularity: tree paths spell out
    prefix *content* (one key element per full page), nodes own the
    physical pages backing their segment, and a sequence whose prompt
    starts with a cached prefix skips prefilling the matched pages
    entirely. Contracts:

    * **Refcounts pin pages.** :meth:`lock` increments every node from
      the matched node to the root; :meth:`release` undoes it. A locked
      node (or any ancestor of one — ancestors always carry >= their
      descendants' locks) is never evicted, so a running sequence's
      cached prefix cannot vanish under it.
    * **LRU eviction under page pressure.** :meth:`insert` allocates
      new pages via the shared allocator's raw free list; when the list
      runs dry it evicts unreferenced leaves oldest-``last_access``
      first (iteratively, so a fully-unreferenced chain unwinds). If
      pressure persists the insert is truncated — caching is
      best-effort, correctness never depends on a hit.
    * **Copy-on-write past a shared page.** A sequence extending
      *through* a cached page (decode continuing past the prefix, or a
      prompt diverging inside a page) must not mutate pages other
      sequences reference: :meth:`cow_extend` hands it a private copy
      of the boundary page instead. Pure ownership transfer here — the
      engine does the actual device-side page copy.
    * **Checkpointable.** ``state_dict`` / ``load_state_dict`` round-
      trip the tree structure and page ownership; refcounts are
      deliberately *not* serialized (locks belong to live sequences,
      which do not survive a restore).

    Determinism: no randomness; LRU ties break on insertion order.
    """

    def __init__(self, allocator: PagedAllocator) -> None:
        self.allocator = allocator
        self.page_size = allocator.page_size
        self.root = PrefixNode((), [], None)
        self.n_evicted_pages = 0      # cumulative pages LRU-evicted
        self.n_cow_pages = 0          # cumulative copy-on-write copies

    # --- introspection -------------------------------------------------
    def total_pages(self) -> int:
        """Pages currently owned by the tree (resident cached prefix)."""
        return sum(len(n.pages) for n in self._nodes())

    def path_pages(self, node: PrefixNode) -> List[int]:
        """Position-ordered physical pages spelling the path from the
        root to (and including) ``node`` — the page-table prefix a
        sequence reading ``node``'s cached run references."""
        segs: List[List[int]] = []
        while node is not None and node is not self.root:
            segs.append(node.pages)
            node = node.parent
        out: List[int] = []
        for seg in reversed(segs):
            out.extend(seg)
        return out

    def cached_tokens(self, key: Sequence[Hashable]) -> int:
        """Resident-prefix overlap for ``key`` in tokens, without
        touching LRU state (pure probe — what the cluster router calls
        per routing decision)."""
        _, n_pages = self._walk(key)
        return n_pages * self.page_size

    def _nodes(self) -> List[PrefixNode]:
        out: List[PrefixNode] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                out.append(node)
            stack.extend(node.children.values())
        return out

    # --- match / lock lifecycle ---------------------------------------
    def _walk(self, key: Sequence[Hashable]
              ) -> Tuple[PrefixNode, int]:
        """Longest-prefix walk. Returns (deepest node whose pages are
        used, total pages matched). A partial match inside a node's
        segment counts its matched pages and stops there."""
        node = self.root
        i = 0
        n = len(key)
        while i < n:
            child = node.children.get(key[i])
            if child is None:
                break
            seg = child.key
            j = 1
            while j < len(seg) and i + j < n and seg[j] == key[i + j]:
                j += 1
            i += j
            node = child
            if j < len(seg):      # diverged / exhausted mid-segment
                return node, i
        return node, i

    def match(self, key: Sequence[Hashable],
              now: Optional[float] = None) -> Tuple[PrefixNode, int]:
        """Longest cached prefix of ``key``: (node, n_pages_matched).
        ``now`` (when given) refreshes LRU stamps along the path —
        probes that must not perturb eviction order pass None (or use
        :meth:`cached_tokens`)."""
        node, n_pages = self._walk(key)
        if now is not None:
            self._touch(node, now)
        return node, n_pages

    def _touch(self, node: PrefixNode, now: float) -> None:
        while node is not None and node is not self.root:
            node.last_access = now
            node = node.parent

    def lock(self, node: PrefixNode) -> None:
        """Pin ``node``'s pages (and its ancestors') against eviction
        for the lifetime of one reading sequence."""
        while node is not None and node.parent is not None:
            node.refcount += 1
            node = node.parent

    def release(self, node: PrefixNode) -> None:
        """Undo one :meth:`lock` (sequence finished or aborted).

        Termination is parent-based, not identity-based, so releasing
        a lock into a tree that was since :meth:`clear`-ed (the holder
        survived a failure wipe) walks the orphaned chain and stops at
        its old root instead of raising — a harmless no-op on dead
        state."""
        while node is not None and node.parent is not None:
            if node.refcount <= 0:
                raise ValueError("release without matching lock")
            node.refcount -= 1
            node = node.parent

    # --- insert / evict ------------------------------------------------
    def insert(self, key: Sequence[Hashable], now: float,
               pages: Optional[List[int]] = None
               ) -> Tuple[PrefixNode, int]:
        """Make ``key`` resident: after a sequence prefills a shareable
        prefix, its full pages enter the tree so future sequences hit.

        ``pages`` (when given) donates the caller's freshly-written
        physical pages for the *uncached tail* of the key — the engine
        path, where page ids must match what was written on device.
        Without it, pages are drawn from the allocator's free list (the
        simulator path, where page identity is pure accounting),
        evicting LRU leaves on pressure and truncating the insert if
        pressure persists.

        Returns (deepest resident node for this key, pages added).
        """
        node, n_matched = self._walk(key)
        self._touch(node, now)
        remaining = list(key[n_matched:])
        if not remaining:
            return node, 0
        if node is not self.root and n_matched < self._depth_pages(node):
            # partial match inside `node`'s segment: the new key
            # diverges mid-node — split so the shared run is its own
            # node and both continuations hang off it
            node = self._split(node, n_matched - self._depth_pages(node.parent))
        if pages is None:
            # pin the attach point while claiming: under pressure the
            # LRU sweep must not evict the (possibly unreferenced)
            # matched path we are about to hang the new child off —
            # that would orphan the child and leak its pages
            self.lock(node)
            try:
                take = self._claim_pages(len(remaining))
            finally:
                self.release(node)
        else:
            if len(pages) != len(remaining):
                raise ValueError(
                    f"donated {len(pages)} pages for {len(remaining)} "
                    "uncached key pages")
            take = list(pages)
        if not take:
            return node, 0
        child = PrefixNode(tuple(remaining[:len(take)]), take, node,
                           last_access=now)
        node.children[child.key[0]] = child
        return child, len(take)

    def _depth_pages(self, node: Optional[PrefixNode]) -> int:
        d = 0
        while node is not None and node is not self.root:
            d += len(node.key)
            node = node.parent
        return d

    def _split(self, node: PrefixNode, at: int) -> PrefixNode:
        """Split ``node``'s segment after ``at`` pages; returns the new
        upper node (which keeps the shared run)."""
        upper = PrefixNode(node.key[:at], node.pages[:at], node.parent,
                           last_access=node.last_access)
        upper.refcount = node.refcount
        node.parent.children[upper.key[0]] = upper
        node.key = node.key[at:]
        node.pages = node.pages[at:]
        node.parent = upper
        upper.children[node.key[0]] = node
        return upper

    def _claim_pages(self, n: int) -> List[int]:
        """Up to ``n`` pages from the free list, evicting LRU
        unreferenced leaves under pressure; may return fewer."""
        short = n - self.allocator.free_pages
        if short > 0:
            self.evict(short)
        take = min(n, self.allocator.free_pages)
        return self.allocator.alloc_raw(take) if take > 0 else []

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` cached pages, unreferenced leaves
        first, oldest ``last_access`` first. Returns pages freed."""
        freed = 0
        while freed < n_pages:
            leaves = [nd for nd in self._nodes()
                      if nd.is_leaf() and nd.refcount == 0]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_access)
            self.allocator.free_raw(victim.pages)
            freed += len(victim.pages)
            self.n_evicted_pages += len(victim.pages)
            del victim.parent.children[victim.key[0]]
        return freed

    def clear(self) -> int:
        """Drop the whole cache (replica failure: the KV pool died with
        the device). All pages return to the allocator regardless of
        refcounts — the sequences holding locks died too. Returns pages
        freed."""
        freed = 0
        for node in self._nodes():
            self.allocator.free_raw(node.pages)
            freed += len(node.pages)
        self.root = PrefixNode((), [], None)
        return freed

    # --- copy-on-write boundary ---------------------------------------
    def cow_extend(self, node: PrefixNode) -> int:
        """A sequence must write into (extend past) ``node``'s last
        page while others reference it: allocate a private copy and
        hand ownership to the caller (who frees it with
        ``allocator.free_raw`` when the sequence retires). Raises
        :class:`OutOfPagesError` only when eviction cannot make room."""
        pages = self._claim_pages(1)
        if not pages:
            raise OutOfPagesError("no page available for copy-on-write")
        self.n_cow_pages += 1
        return pages[0]

    # --- checkpoint/restore -------------------------------------------
    def state_dict(self) -> dict:
        """Structure + page ownership + LRU stamps. Refcounts are not
        saved: locks belong to live sequences, which don't survive a
        restore (the engine re-locks on resume)."""
        def pack(node: PrefixNode) -> dict:
            return {"key": list(node.key), "pages": list(node.pages),
                    "last_access": node.last_access,
                    "children": [pack(c) for c in
                                 sorted(node.children.values(),
                                        key=lambda c: repr(c.key[0]))]}
        return {"n_evicted_pages": self.n_evicted_pages,
                "n_cow_pages": self.n_cow_pages,
                "root": pack(self.root)}

    def load_state_dict(self, state: dict) -> None:
        def unpack(rec: dict, parent: Optional[PrefixNode]) -> PrefixNode:
            node = PrefixNode(tuple(rec["key"]), list(rec["pages"]),
                              parent, last_access=rec["last_access"])
            for crec in rec["children"]:
                child = unpack(crec, node)
                node.children[child.key[0]] = child
            return node
        self.n_evicted_pages = int(state.get("n_evicted_pages", 0))
        self.n_cow_pages = int(state.get("n_cow_pages", 0))
        self.root = unpack(state["root"], None)


# ----------------------------------------------------------------------
# Per-sequence page tables with shared-prefix reuse (engine host side)
# ----------------------------------------------------------------------

@dataclass
class _SeqPages:
    """One live sequence's page state inside a :class:`PagedSeqLedger`.

    ``pages`` is the position-ordered physical page table (what the
    kernel's scalar-prefetch operand is built from); ``owned`` the
    subset this sequence must return to the free list when it retires —
    the rest belong to the :class:`PrefixTree` and are pinned via
    ``node``'s refcount instead."""

    pages: List[int]
    owned: List[int]
    seq_len: int
    key: Tuple[Hashable, ...] = ()
    node: Optional[PrefixNode] = None
    cached_pages: int = 0
    donated: bool = False


class PagedSeqLedger:
    """Host-side per-sequence page bookkeeping for the engine's paged
    path with shared-prefix reuse. Pure accounting, importable without
    JAX — the engine does the device-side writes; the differential
    parity suite and the hypothesis page-conservation property drive
    this class directly.

    Composition contract (mirrors the simulator's prefix integration):

    * :meth:`admit` walks the tree for the sequence's prefix key, locks
      the matched path (refcount pin), and allocates private pages only
      for the *uncached* remainder — the page table interleaves
      tree-owned prefix pages with privately-owned suffix pages in
      position order.
    * :meth:`donate` (at prefill completion) hands the freshly-written
      full prefix pages to the tree via ``PrefixTree.insert(pages=...)``
      — page *identity* must survive donation because the KV was
      written on device — then re-pins the deepened path and enforces
      the residency budget by LRU-evicting unreferenced leaves.
    * :meth:`extend` grows the sequence one decode token at a time,
      allocating on page-boundary crossings (evicting cache leaves
      under pressure). If a write would land inside a page the
      sequence does not own, the boundary page is copy-on-write
      replaced via ``PrefixTree.cow_extend`` — unreachable with
      full-page prefix keys (the suffix always starts page-aligned,
      so decode never extends *into* a shared page) but kept as the
      guard the tree API is designed around.
    * :meth:`free` returns owned pages and releases the tree pin.

    Conservation invariant (hypothesis-tested):
    ``allocator.free_pages + owned_pages() + tree.total_pages()``
    equals the pool size at every point.
    """

    def __init__(self, allocator: PagedAllocator,
                 tree: Optional[PrefixTree] = None,
                 cache_pages_budget: Optional[int] = None) -> None:
        self.allocator = allocator
        self.tree = tree
        self.cache_pages_budget = cache_pages_budget
        self.page_size = allocator.page_size
        self._seqs: Dict[int, _SeqPages] = {}
        self.n_cow_copies = 0        # device-copy events the engine owes

    # --- introspection -------------------------------------------------
    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id].seq_len

    def table(self, seq_id: int) -> List[int]:
        return self._seqs[seq_id].pages

    def cached_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].cached_pages * self.page_size

    def owned_pages(self) -> int:
        """Pages privately owned by live sequences (conservation leg)."""
        return sum(len(rec.owned) for rec in self._seqs.values())

    def probe(self, key: Sequence[Hashable]) -> int:
        """Resident-prefix overlap for ``key`` in tokens; pure read."""
        if self.tree is None or not key:
            return 0
        return self.tree.cached_tokens(key)

    # --- allocation helpers --------------------------------------------
    def _claim(self, n: int) -> List[int]:
        """``n`` pages off the free list, evicting unreferenced cache
        leaves under pressure; raises :class:`OutOfPagesError` when
        eviction cannot make room (never returns fewer)."""
        short = n - self.allocator.free_pages
        if short > 0 and self.tree is not None:
            self.tree.evict(short)
        return self.allocator.alloc_raw(n)

    def can_admit(self, n_tokens: int,
                  key: Sequence[Hashable] = ()) -> bool:
        """Whether a prefill of ``n_tokens`` can be admitted right now:
        uncached pages needed vs free + evictable cache pages."""
        cached = 0
        if self.tree is not None and key:
            cached = min(self.tree.cached_tokens(key), n_tokens)
            cached -= cached % self.page_size
        need = -(-(n_tokens - cached) // self.page_size)
        avail = self.allocator.free_pages
        if self.tree is not None:
            avail += sum(len(nd.pages) for nd in self.tree._nodes()
                         if nd.refcount == 0)
        return need <= avail

    # --- lifecycle -----------------------------------------------------
    def admit(self, seq_id: int, n_tokens: int,
              key: Sequence[Hashable] = (), now: float = 0.0) -> int:
        """Open a sequence of ``n_tokens`` prompt tokens. Returns the
        tokens served from the prefix cache (page-granular; the caller
        starts its chunked prefill at that boundary)."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already admitted")
        # only full pages the prompt actually covers are shareable
        key = tuple(key)[:n_tokens // self.page_size]
        node: Optional[PrefixNode] = None
        path: List[int] = []
        cached_pages = 0
        if self.tree is not None and key:
            cand, matched = self.tree.match(key, now)
            cached_pages = min(matched, n_tokens // self.page_size)
            if cached_pages > 0:
                node = cand
                self.tree.lock(node)
                path = self.tree.path_pages(node)[:cached_pages]
        cached = cached_pages * self.page_size
        need = -(-(n_tokens - cached) // self.page_size)
        try:
            fresh = self._claim(need) if need > 0 else []
        except OutOfPagesError:
            if node is not None:
                self.tree.release(node)
            raise
        self._seqs[seq_id] = _SeqPages(
            pages=path + fresh, owned=fresh, seq_len=n_tokens,
            key=tuple(key), node=node, cached_pages=cached_pages)
        return cached

    def donate(self, seq_id: int, now: float) -> int:
        """Prefill finished: make the sequence's shareable full pages
        resident. Pages the tree does not already cover transfer
        ownership (they stay in this sequence's table — the KV is
        already written in them); the pin moves to the deepest resident
        node so the whole referenced path survives until :meth:`free`.
        Returns pages donated."""
        rec = self._seqs[seq_id]
        if self.tree is None or not rec.key or rec.donated:
            return 0
        rec.donated = True
        _, matched_now = self.tree.match(rec.key, now)
        # a concurrent donor may have made more of the key resident
        # since admit; our lock guarantees it cannot have become less
        donated = list(rec.pages[matched_now:len(rec.key)])
        new_node, added = self.tree.insert(rec.key, now, pages=donated)
        if added:
            owned = set(donated)
            rec.owned = [p for p in rec.owned if p not in owned]
        if rec.node is not None:
            self.tree.release(rec.node)
        self.tree.lock(new_node)
        rec.node = new_node
        if self.cache_pages_budget is not None:
            over = self.tree.total_pages() - self.cache_pages_budget
            if over > 0:
                self.tree.evict(over)
        return added

    def extend(self, seq_id: int, n_new: int = 1
               ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Grow a sequence by ``n_new`` decode tokens. Returns
        (freshly-allocated pages, copy-on-write (old, new) page pairs
        the caller must copy device-side)."""
        rec = self._seqs[seq_id]
        fresh: List[int] = []
        cows: List[Tuple[int, int]] = []
        P = self.page_size
        for _ in range(n_new):
            idx = rec.seq_len // P
            if idx < len(rec.pages):
                page = rec.pages[idx]
                if page not in rec.owned and self.tree is not None:
                    # writing into a shared page: private copy first
                    new_page = self.tree.cow_extend(rec.node)
                    rec.pages[idx] = new_page
                    rec.owned.append(new_page)
                    cows.append((page, new_page))
                    self.n_cow_copies += 1
            else:
                page = self._claim(1)[0]
                rec.pages.append(page)
                rec.owned.append(page)
                fresh.append(page)
            rec.seq_len += 1
        return fresh, cows

    def free(self, seq_id: int) -> None:
        """Retire a sequence: owned pages return to the free list, the
        cached-path pin is released (a release into a tree that was
        since cleared is a harmless no-op on dead state)."""
        rec = self._seqs.pop(seq_id)
        self.allocator.free_raw(rec.owned)
        if rec.node is not None and self.tree is not None:
            self.tree.release(rec.node)

    # --- kernel operands ------------------------------------------------
    def table_array(self, seq_ids: List[Optional[int]],
                    width: int) -> np.ndarray:
        """[B, width] int32 physical page ids (0-padded) — the paged
        kernel's scalar-prefetch operand, shared pages included."""
        out = np.zeros((len(seq_ids), width), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            pages = self._seqs[sid].pages
            out[i, :len(pages)] = pages
        return out

    def lens_array(self, seq_ids: List[Optional[int]]) -> np.ndarray:
        return np.array([0 if sid is None else self._seqs[sid].seq_len
                         for sid in seq_ids], np.int32)


def write_prefill_pages(pool: PagedPool,
                        layer_kv: Tuple[torch.Tensor, torch.Tensor],
                        pages: List[int], n_tokens: int, *,
                        start_token: int = 0) -> PagedPool:
    """Scatter a prefilled [L, S, Hk, hd] K/V into the pool's ``pages``,
    in place, positions ``[start_token, n_tokens)``: page ``i`` takes
    positions ``start_token + i * page`` onward, a last partial page
    zero-padded, as the JAX function writes them.

    ``start_token`` skips the leading cache-resident positions: with a
    shared-prefix hit the donor already wrote pages for tokens
    ``[0, start_token)``, so ``pages`` covers positions from
    ``start_token`` (page-aligned) onward only. Returns ``pool``."""
    if start_token % pool.page_size:
        raise ValueError(
            f"start_token {start_token} must be page-aligned "
            f"({pool.page_size})")
    k_new, v_new = layer_kv
    P = pool.page_size
    for i, page in enumerate(pages):
        lo = start_token + i * P
        hi = min(lo + P, n_tokens)
        if lo >= n_tokens:
            break
        for dst, src in ((pool.k, k_new), (pool.v, v_new)):
            dst[:, page, :hi - lo] = src[:, lo:hi].to(dst.dtype)
            dst[:, page, hi - lo:] = 0
    return pool
