"""The continuous-batching serving engine of the port.

Port of the JAX package's ``serving/engine.py`` for the dense
transformer, on both of its caches. It drives the identical
``DriftScheduler`` state machine — admission, dispatch, completion
feedback (Eq. 5-6) — and, on the paged path, the identical page
bookkeeping (``kv_cache.PagedSeqLedger`` with the shared-prefix
``PrefixTree``), so at temperature 0 it emits the same tokens,
completion order and TTFT stamps as the JAX engine on the same weights
and requests.

* Slot-ring cache (``EngineConfig.paged=False``, the default): a
  fixed ring of ``n_slots`` contiguous per-slot caches
  (``api.init_cache``; a window-sized ring for sliding-window archs).
  A slot's prompt bucket prefills in one shot through ``api.prefill``
  (one flash-attention kernel launch per layer) the iteration its last
  prompt chunk is consumed, and the resulting cache is copied into the
  slot. Every slot decodes each step through ``api.decode_step`` at its
  own depth (``pos = cache["lens"]``); a free slot's lane computes
  masked garbage, as on the TPU.
* Paged cache (``paged=True``): ``n_slots`` sequences decode together,
  one token per engine step, through
  :func:`transformer.decode_step_paged`: one batched paged-decode kernel
  launch per layer.
* Chunked prefill (``EngineConfig.chunk_prefill_tokens``): a joining
  slot's prompt is consumed across iterations against a per-step token
  budget shared by prefilling slots in join order. On the paged path
  every chunk executes the iteration its budget is consumed, through
  :func:`transformer.prefill_chunk_paged` (one chunked-prefill kernel
  launch per layer); ``None`` prefills the whole bucket in the admission
  step. The final chunk covers the bucket's padding tail and its
  last-position logits give the first token, stamped as
  ``Request.prefill_end``.
* Shared-prefix reuse (``EngineConfig.prefix_cache``, paged only): a
  joining request whose prompt starts with a resident shared prefix
  references the tree's refcount-pinned pages and starts prefill at the
  cached boundary; freshly written full prefix pages are donated at
  prefill completion and the pin is released at retirement.

* P/D disaggregation (paged only; driven by ``cluster/driver.py``): a
  ``handoff_hook`` on a prefill engine takes a request over the moment
  its first token exists; :meth:`extract_sequence` copies the slot's
  pages off the pool as tensors on the engine's device (the payload
  layout of the JAX engine, whose arrays are numpy), the slot is
  released, and :meth:`accept_handoff` on a decode engine queues the
  request until a slot dispatches it and :meth:`_admit_prefilled`
  writes the payload into freshly allocated pages.

The pool holds one extra page the allocator never hands out; inactive
slots scatter their masked decode writes there. Both caches are updated
in place. The other model families come with later slices
(ROADMAP.md).

EOS: with randomly-initialised models there is no semantic EOS, so
requests stop at their ground-truth output length (oracle EOS, clipped
by max_tokens).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.request import Request, RequestState
from ..core.scheduler import DriftScheduler
from ..models import transformer
from ..models.config import ModelConfig
from ..models.layers import resolve_device
from ..models.registry import get_serving_api
from ..models.steps import sample_logits
from ..obs import events as tr
from ..obs import resolve_recorder
from .kv_cache import (PagedAllocator, PagedPool, PagedSeqLedger, PrefixTree,
                       prefix_page_key)
from .metrics import RunMetrics, summarize_run


@dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    max_len: int = 256               # per-slot cache capacity
    prompt_buckets: Tuple[int, ...] = (16, 32, 64)
    temperature: float = 0.0
    batch_wait_steps: int = 0
    # vLLM-style paged KV pool instead of the slot-ring cache
    # (transformer-family archs)
    paged: bool = False
    page_size: int = 16
    # --- iteration-level prefill (Sarathi chunking) ---
    # per-STEP prefill token budget shared by prefilling slots in join
    # order; None = unbounded (whole-bucket prefill in the admission step)
    chunk_prefill_tokens: Optional[int] = None
    # --- shared-prefix radix cache over the paged pool ---
    # requires paged=True: sharing is physical (page-table aliasing)
    prefix_cache: bool = False
    # extra pool pages reserved for cache residency; also the LRU
    # budget the tree is evicted back to after each donation
    prefix_cache_pages: int = 64


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class SlotState:
    req: Optional[Request] = None
    generated: int = 0
    target: int = 0
    last_token: int = 0
    # --- chunked-prefill progress (request prompt tokens, bucket-clipped)
    prompt_len: int = 0
    prefill_remaining: int = 0     # uncached prompt tokens not yet consumed
    cached_tokens: int = 0         # prompt tokens served from the cache
    pending_prefill: bool = False  # device prefill not yet executed
    tokens: Optional[torch.Tensor] = None  # [1, bucket] prompt ids
    bucket: int = 0
    prefill_pos: int = 0           # bucket position device prefill reached


class ServingEngine:
    """Continuous-batching engine for one model on one device."""

    def __init__(self, cfg: ModelConfig, params, scheduler: DriftScheduler,
                 config: Optional[EngineConfig] = None,
                 trace=None, *,
                 device: "str | torch.device" = "cuda") -> None:
        self.cfg = cfg
        self.params = params
        self.sched = scheduler
        self.ecfg = config or EngineConfig()
        self.device = resolve_device(device)
        self.trace = resolve_recorder(trace)
        # replica id stamped on emitted events (None = standalone)
        self.trace_rid: Optional[int] = None
        if self.trace.enabled:
            self.sched.drift.trace = self.trace
        # raises NotImplementedError for the families later slices port
        self.api = get_serving_api(cfg)
        c = self.ecfg.chunk_prefill_tokens
        if c is not None and c < 1:
            raise ValueError(
                f"chunk_prefill_tokens must be >= 1 or None, got {c}")
        if self.ecfg.prefix_cache and not self.ecfg.paged:
            raise ValueError(
                "prefix_cache requires paged=True: prefix sharing is "
                "physical page-table aliasing over the paged pool")
        n, S = self.ecfg.n_slots, self.ecfg.max_len
        self.slots: List[SlotState] = [SlotState() for _ in range(n)]
        self.step_count = 0
        self.busy_steps = 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._join_order: List[int] = []   # slot ids, chunk-budget order
        # --- per-chunk device execution counters ---
        self.n_prefill_launches = 0
        self.n_decode_launches = 0
        self.prefill_chunk_log: List[Tuple[int, int]] = []  # (slot, length)
        # --- P/D disaggregation plumbing (cluster driver) ---
        # called as hook(slot, req, now) when a slot's prefill completes;
        # returning True means the driver took the request over (KV
        # extracted for transfer) and the engine must not decode it
        self.handoff_hook = None
        self._pending_injections: Dict = {}   # req_id -> KV payload
        # --- prefix-cache counters (mirror WorkerSimulator's) ---
        self.prefix_tree = None
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        self.prefix_tokens_saved = 0

        if self.ecfg.paged:
            pages_per_seq = -(-S // self.ecfg.page_size)
            extra = (self.ecfg.prefix_cache_pages
                     if self.ecfg.prefix_cache else 0)
            # pool has one extra page the allocator never hands out:
            # inactive slots scatter their (masked) writes into it
            self.alloc = PagedAllocator(
                n_pages=n * pages_per_seq + extra,
                page_size=self.ecfg.page_size,
                pages_per_seq=pages_per_seq)
            if self.ecfg.prefix_cache:
                self.prefix_tree = PrefixTree(self.alloc)
            self.ledger = PagedSeqLedger(
                self.alloc, self.prefix_tree,
                cache_pages_budget=(self.ecfg.prefix_cache_pages
                                    if self.ecfg.prefix_cache else None))
            self.pool = PagedPool.create(cfg, self.alloc.n_pages + 1,
                                         self.ecfg.page_size,
                                         device=self.device)
        else:
            self.cache = self.api.init_cache(cfg, n, S, device=self.device)

    @property
    def _pool(self) -> Dict[str, torch.Tensor]:
        return {"k": self.pool.k, "v": self.pool.v}

    # --- slot management --------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.req is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.req is not None]

    # --- prefix-cache plumbing -------------------------------------------
    def _shared_eff(self, req: Request, prompt_len: int) -> int:
        """Shareable prefix tokens after bucket clipping."""
        if req.prefix_group is None:
            return 0
        return min(req.shared_prefix_tokens, prompt_len)

    def _prefix_key(self, req: Request, prompt_len: int) -> tuple:
        return prefix_page_key(req.prefix_group,
                               self._shared_eff(req, prompt_len),
                               self.ecfg.page_size)

    def prefix_cached_tokens(self, req: Request) -> int:
        """Resident shared-prefix overlap this engine holds for
        ``req``, in tokens. Pure probe (no LRU/refcount perturbation)."""
        if self.prefix_tree is None:
            return 0
        prompt_len = min(max(req.prompt_tokens, 1),
                         _bucket(max(req.prompt_tokens, 1),
                                 self.ecfg.prompt_buckets))
        key = self._prefix_key(req, prompt_len)
        if not key:
            return 0
        return min(self.prefix_tree.cached_tokens(key), prompt_len)

    def prefix_cache_stats(self) -> Dict[str, int]:
        """Cumulative cache counters (all zero when disabled)."""
        return {
            "hits": self.n_prefix_hits,
            "misses": self.n_prefix_misses,
            "tokens_saved": self.prefix_tokens_saved,
            "evicted_pages": (self.prefix_tree.n_evicted_pages
                              if self.prefix_tree else 0),
            "resident_pages": (self.prefix_tree.total_pages()
                               if self.prefix_tree else 0),
            "invalidations": 0,
        }

    # --- tokenization -----------------------------------------------------
    def _tokenize(self, req: Request, bucket: int, prompt_len: int,
                  shared_eff: int) -> np.ndarray:
        """[1, bucket] int32 prompt ids, byte-identical to the JAX engine.

        Legacy layout (no shareable prefix): prompt bytes right-aligned,
        zero padding in front. Prefix layout (``prefix_cache`` + a
        shareable prefix): a deterministic content-hashed group prefix
        occupies positions ``[0, shared_eff)`` — every member of a prefix
        group computes identical KV there, which is what makes donated
        pages reusable — and the request's own bytes fill the rest
        cyclically (no trailing padding, so the last position stays a
        real token for the prefill logits)."""
        vocab = max(self.cfg.vocab - 1, 1)
        tokens = np.zeros((1, bucket), np.int32)
        if self.prefix_tree is not None and shared_eff > 0:
            seed = zlib.crc32(repr(req.prefix_group).encode())
            pos = np.arange(bucket, dtype=np.int64)
            tokens[0] = (seed + pos * 2654435761) % vocab + 1
            body = np.frombuffer(req.prompt.encode() or b"\x01",
                                 dtype=np.uint8).astype(np.int64)
            tail = bucket - shared_eff
            if tail > 0:
                reps = np.resize(body, tail)
                tokens[0, shared_eff:] = reps % vocab + 1
        else:
            ids = np.frombuffer(req.prompt.encode()[:prompt_len * 4],
                                dtype=np.uint8)[:prompt_len]
            # widen before the modulo: uint8 % a vocab above 255 raises
            # under numpy 2 (same ids wherever the uint8 form works)
            ids = ids.astype(np.int64)
            if len(ids):
                tokens[0, -len(ids):] = ids % vocab + 1
        return tokens

    # --- admission --------------------------------------------------------
    def _admit(self, req: Request, slot: int, now: float) -> None:
        """Open a slot for ``req``: tokenize, probe/pin the prefix
        cache, allocate pages (paged mode) and queue the prompt for
        chunked prefill. The device prefill runs chunk by chunk
        (:meth:`_advance_prefill`, paged) or in one shot when the last
        chunk lands (:meth:`_run_prefill`, slot-ring)."""
        prompt_len = max(req.prompt_tokens, 1)
        bucket = _bucket(prompt_len, self.ecfg.prompt_buckets)
        prompt_len = min(prompt_len, bucket)      # truncate to the bucket
        shared_eff = self._shared_eff(req, prompt_len)
        tokens = self._tokenize(req, bucket, prompt_len, shared_eff)
        cached = 0
        if self.ecfg.paged:
            key = (self._prefix_key(req, prompt_len)
                   if self.prefix_tree is not None else ())
            evicted_before = (self.prefix_tree.n_evicted_pages
                              if self.prefix_tree is not None else 0)
            cached = self.ledger.admit(slot, bucket, key, now)
            cached = min(cached, shared_eff)
            if key:
                if cached > 0:
                    self.n_prefix_hits += 1
                    self.prefix_tokens_saved += cached
                else:
                    self.n_prefix_misses += 1
                if self.trace.enabled:
                    self.trace.emit(
                        now, tr.PREFIX_HIT if cached > 0
                        else tr.PREFIX_MISS,
                        req_id=req.req_id, rid=self.trace_rid,
                        tenant=req.tenant.label,
                        **({"tokens": cached} if cached > 0 else {}))
            if self.trace.enabled and self.prefix_tree is not None:
                delta = self.prefix_tree.n_evicted_pages - evicted_before
                if delta > 0:
                    self.trace.emit(now, tr.PREFIX_EVICT,
                                    rid=self.trace_rid, pages=delta)
        req.cached_prompt_tokens = cached
        st = self.slots[slot]
        st.req = req
        st.generated = 0
        st.target = max(1, min(req.true_output_tokens, req.max_tokens,
                               self.ecfg.max_len - bucket - 2))
        st.prompt_len = prompt_len
        st.cached_tokens = cached
        st.prefill_remaining = prompt_len - cached
        st.pending_prefill = True
        st.tokens = torch.from_numpy(tokens).to(self.device)
        st.bucket = bucket
        st.prefill_pos = cached
        self._join_order.append(slot)
        req.state = RequestState.EXECUTING
        req.exec_start = now

    def _insert_cache(self, slot: int, cache_1: Dict) -> None:
        """Copy a batch-1 prefill cache into slot ``slot`` of the ring
        (in place): axis 1 of the ``[L, B, ...]`` leaves, axis 0 of
        ``lens``."""
        for name, full in self.cache.items():
            axis = 1 if full.ndim > 1 else 0
            full.select(axis, slot).copy_(cache_1[name].select(axis, 0))

    def _run_prefill(self, slot: int, now: float) -> None:
        """Single-shot device prefill of the slot-ring cache: the slot's
        last prompt chunk landed, so run the whole bucket at once, copy
        its cache into the slot and emit the first token."""
        st = self.slots[slot]
        logits, cache_1 = self.api.prefill(self.cfg, self.params, st.tokens,
                                           max_len=self.ecfg.max_len)
        tok = sample_logits(logits, self._gen, self.ecfg.temperature)
        self._insert_cache(slot, cache_1)
        self._emit_first_token(slot, int(tok[0]), now)

    def _advance_prefill(self, slot: int, take: int, now: float) -> None:
        """Execute this iteration's device chunk for a paged slot through
        the fused kernel. The ``take`` prompt tokens the budget loop just
        consumed map 1:1 onto bucket positions
        ``[prefill_pos, prefill_pos + take)``; the final chunk extends
        through the bucket's padding tail so its last position yields
        the first-token logits. The prefill-completing iteration donates
        shareable pages and emits the first token."""
        st = self.slots[slot]
        final = st.prefill_remaining <= 0
        start, end = st.prefill_pos, st.prefill_pos + take
        if final:
            end = st.bucket
            if end <= start:
                # fully-cached prompt: re-run the last bucket position
                # (recomputing KV already resident in the cached pages)
                # purely for the first-token logits
                start = end - 1
        if end <= start:
            return                       # budget exhausted, mid-prompt
        chunk_len = end - start
        pt = torch.from_numpy(self.ledger.table_array(
            [slot], self.alloc.pages_per_seq)).to(self.device)
        q_offset = torch.tensor([start], dtype=torch.int32, device=self.device)
        logits = transformer.prefill_chunk_paged(
            self.cfg, self.params, self._pool, st.tokens[:, start:end], pt,
            q_offset)
        self.n_prefill_launches += 1
        self.prefill_chunk_log.append((slot, chunk_len))
        st.prefill_pos = end
        if final:
            if self.prefix_tree is not None:
                self.ledger.donate(slot, now)
            tok = sample_logits(logits, self._gen, self.ecfg.temperature)
            self._emit_first_token(slot, int(tok[0]), now)

    def _emit_first_token(self, slot: int, tok: int, now: float) -> None:
        """Prefill-completion bookkeeping: first token, honest TTFT
        anchor, and the P/D handoff hook (a hooked request leaves for a
        decode replica instead of joining this engine's decode set)."""
        st = self.slots[slot]
        st.generated = 1                       # prefill emitted one token
        st.last_token = tok
        st.pending_prefill = False
        st.tokens = None
        st.req.prefill_end = now               # first token exists now
        if self.trace.enabled:
            self.trace.emit(now, tr.FIRST_TOKEN, req_id=st.req.req_id,
                            rid=self.trace_rid,
                            tenant=st.req.tenant.label,
                            ttft=now - st.req.arrival_time)
        if self.handoff_hook is not None \
                and self.handoff_hook(slot, st.req, now):
            self._release_slot(slot)

    # --- P/D disaggregation: KV extraction / injection --------------------
    def _release_slot(self, slot: int) -> None:
        """Free a slot without completing its request (the request
        lives on elsewhere — P/D handoff or failure reroute): no
        ``sched.complete``, so no drift feedback fires here."""
        st = self.slots[slot]
        if self.ecfg.paged:
            self.ledger.free(slot)
        self._join_order.remove(slot)
        st.req = None
        st.generated = 0
        st.target = 0
        st.prefill_remaining = 0
        st.cached_tokens = 0
        st.pending_prefill = False
        st.tokens = None

    def _slot_pages(self, slot: int) -> torch.Tensor:
        """The slot's page table as one int64 index tensor on the
        engine's device (one host-to-device copy per handoff)."""
        return torch.tensor(self.ledger.table(slot), dtype=torch.int64,
                            device=self.device)

    def extract_sequence(self, slot: int) -> Dict:
        """Snapshot a prefilled slot's state for a P/D handoff: the
        sequence's page *contents* gathered off the pool (the real KV
        page movement — prefix-tree pages are copied too, the receiver
        gets private pages) plus the decode-resume scalars. ``k`` and
        ``v`` are ``[L, n_seq_pages, page, Hk, D]`` tensors on the
        engine's device: copies (index gathers), so the slot's pages
        may be reused as soon as it is released."""
        if not self.ecfg.paged:
            raise ValueError("KV extraction requires the paged pool")
        st = self.slots[slot]
        pages = self._slot_pages(slot)
        return {
            "k": self.pool.k[:, pages],
            "v": self.pool.v[:, pages],
            "seq_len": st.bucket,          # resident tokens (whole bucket)
            "bucket": st.bucket,
            "prompt_len": st.prompt_len,
            "last_token": st.last_token,
            "generated": st.generated,
            "target": st.target,
        }

    def accept_handoff(self, req: Request, payload: Dict) -> None:
        """Queue a prefilled request whose KV transfer just landed:
        back of its tenant queue at the original enqueue timestamp,
        estimate untouched; the KV payload is injected into the paged
        pool when a slot dispatches it."""
        self._pending_injections[req.req_id] = payload
        self.sched.queues.enqueue(req, req.enqueue_time)

    def pop_pending_injection(self, req_id: int) -> Optional[Dict]:
        """Detach a queued request's undispatched KV payload (the
        cluster driver re-transfers it when the request is stolen off
        this engine's queue)."""
        return self._pending_injections.pop(req_id, None)

    def _admit_prefilled(self, req: Request, slot: int, payload: Dict,
                         now: float) -> None:
        """Open a slot for a request that already prefilled elsewhere:
        allocate pages, write the transferred KV into them in place, and
        enter decode directly (no prefill chunks, no first token — both
        happened on the source replica)."""
        if not self.ecfg.paged:
            raise ValueError("KV injection requires the paged pool")
        self.ledger.admit(slot, payload["seq_len"], (), now)
        pages = self._slot_pages(slot)
        for name in ("k", "v"):
            pool = getattr(self.pool, name)
            pool[:, pages] = payload[name].to(device=pool.device,
                                              dtype=pool.dtype)
        st = self.slots[slot]
        st.req = req
        st.generated = payload["generated"]
        st.target = payload["target"]
        st.last_token = payload["last_token"]
        st.prompt_len = payload["prompt_len"]
        st.cached_tokens = 0
        st.prefill_remaining = 0
        st.pending_prefill = False
        st.tokens = None
        st.bucket = payload["bucket"]
        st.prefill_pos = payload["seq_len"]
        self._join_order.append(slot)
        req.state = RequestState.EXECUTING
        if req.exec_start is None:
            req.exec_start = now

    def abort_all(self, now: float) -> List[Request]:
        """Failure path: drop every in-flight slot and pending KV
        injection; stranded requests go back to the caller (the cluster
        driver resets and reroutes them). Pool contents die with the
        replica, so a prefix tree is emptied too."""
        stranded = []
        for slot in list(self._join_order):
            stranded.append(self.slots[slot].req)
            self._release_slot(slot)
        self._pending_injections.clear()
        if self.prefix_tree is not None:
            self.prefix_tree.clear()
        return stranded

    def _retire(self, slot: int, now: float) -> None:
        st = self.slots[slot]
        req = st.req
        req.exec_end = now
        self.sched.complete(req, st.generated, now)
        if self.trace.enabled:
            self.trace.emit(now, tr.COMPLETE, req_id=req.req_id,
                            rid=self.trace_rid, tenant=req.tenant.label,
                            observed=st.generated, e2e=req.e2e_latency,
                            ttft=req.ttft,
                            inter_token=req.inter_token_latency)
        self._release_slot(slot)

    # --- main loop ----------------------------------------------------------
    def step(self, now: float) -> int:
        """One engine iteration: admit into free slots, consume the
        per-step prefill chunk budget in join order (running a device
        chunk for each slot that got budget), advance every decoding slot
        one token, retire finished ones. Returns number of completions
        this step. Per-iteration admission honours the scheduler's
        ``max_new_per_step`` knob."""
        joined = 0
        cap = self.sched.max_new_per_step
        for slot in self.free_slots():
            if self.sched.queue_depth() == 0:
                break
            if cap is not None and joined >= cap:
                break
            if self.prefix_tree is not None and not self.ledger.can_admit(
                    self.alloc.pages_per_seq * self.ecfg.page_size):
                # conservative page guard: admission waits for
                # retirements/evictions to free room (only reachable
                # with a prefix cache — the plain pool is sized exactly)
                break
            req = self.sched.dispatch(now)
            if req is None:
                break
            payload = self._pending_injections.pop(req.req_id, None)
            if payload is not None:
                self._admit_prefilled(req, slot, payload, now)
            else:
                self._admit(req, slot, now)
            joined += 1

        # chunked prefill: apportion the per-step budget in join order;
        # a slot's prefill-completing iteration also emits its first
        # token (and joins this step's decode batch)
        budget = (math.inf if self.ecfg.chunk_prefill_tokens is None
                  else self.ecfg.chunk_prefill_tokens)
        for slot in list(self._join_order):
            st = self.slots[slot]
            if not st.pending_prefill:
                continue
            take = int(min(st.prefill_remaining, budget))
            st.prefill_remaining -= take
            budget -= take
            if take and self.trace.enabled:
                self.trace.emit(now, tr.PREFILL_CHUNK,
                                req_id=st.req.req_id, rid=self.trace_rid,
                                tenant=st.req.tenant.label, tokens=take)
            if self.ecfg.paged:
                # every chunk executes on device the iteration its
                # budget is consumed (fused chunked-prefill kernel)
                self._advance_prefill(slot, take, now)
            elif st.prefill_remaining <= 0:
                self._run_prefill(slot, now)
            if budget <= 0:
                break

        decoding = [i for i in self.active_slots()
                    if not self.slots[i].pending_prefill]
        if not decoding:
            if self.active_slots():
                # prefill-only iteration (budget exhausted mid-prompt)
                self.step_count += 1
                self.busy_steps += 1
            return 0

        tokens = np.zeros((self.ecfg.n_slots,), np.int64)
        for i in decoding:
            tokens[i] = self.slots[i].last_token
        if self.ecfg.paged:
            toks = self._decode_paged(tokens, decoding)
        else:
            # every lane at its own depth; lens is replaced, not mutated
            logits, self.cache = self.api.decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(tokens).to(self.device), self.cache["lens"])
            self.n_decode_launches += 1
            toks = sample_logits(logits, self._gen,
                                 self.ecfg.temperature).cpu().numpy()

        done = 0
        tron = self.trace.enabled
        for i in decoding:
            st = self.slots[i]
            st.generated += 1
            st.last_token = int(toks[i])
            if tron:
                self.trace.emit(now, tr.DECODE_STEP,
                                req_id=st.req.req_id, rid=self.trace_rid,
                                n=st.generated)
            if st.generated >= st.target:       # oracle EOS
                self._retire(i, now)
                done += 1
        self.step_count += 1
        self.busy_steps += 1
        if tron:
            self.trace.emit(now, tr.GAUGE, rid=self.trace_rid,
                            name="queue_depth",
                            value=self.sched.queue_depth())
            self.trace.emit(now, tr.GAUGE, rid=self.trace_rid,
                            name="active_slots",
                            value=len(self.active_slots()))
            if self.ecfg.paged:
                self.trace.emit(now, tr.GAUGE, rid=self.trace_rid,
                                name="kv_free_pages",
                                value=self.alloc.free_pages)
        return done

    def _decode_paged(self, tokens: np.ndarray,
                      decoding: List[int]) -> np.ndarray:
        """The paged decode iteration: build the page tables (inactive
        slots on the scratch page), run one batched-kernel step, extend
        each decoding slot's ledger. Returns the sampled tokens [n]."""
        sids = [i if (self.slots[i].req is not None
                      and not self.slots[i].pending_prefill) else None
                for i in range(self.ecfg.n_slots)]
        pt = self.ledger.table_array(sids, self.alloc.pages_per_seq)
        scratch = self.pool.n_pages - 1          # never allocated: inactive
        for i, sid in enumerate(sids):           # slots write there
            if sid is None:
                pt[i, :] = scratch
        lens = self.ledger.lens_array(sids)
        # page-loop bound for the batched kernel: next power of two
        # above the deepest live sequence, clamped to the table width
        needed = max(1, -(-int(lens.max()) // self.ecfg.page_size))
        max_pages = 1
        while max_pages < needed:
            max_pages *= 2
        max_pages = min(max_pages, self.alloc.pages_per_seq)
        logits = transformer.decode_step_paged(
            self.cfg, self.params, self._pool,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pt).to(self.device),
            torch.from_numpy(lens).to(self.device),
            max_pages=max_pages)
        self.n_decode_launches += 1
        toks = sample_logits(logits, self._gen,
                             self.ecfg.temperature).cpu().numpy()
        for i in decoding:
            _, cows = self.ledger.extend(i, 1)
            for old, new in cows:
                # copy-on-write boundary: the ledger handed this slot a
                # private copy of a shared page — mirror it on the
                # device before the next write lands there. Unreachable
                # with full-page prefix keys (suffix pages are always
                # private) but wired for partial-page layouts.
                self.pool.k[:, new] = self.pool.k[:, old]
                self.pool.v[:, new] = self.pool.v[:, old]
        return toks

    def run_until_drained(self, *, max_steps: int = 100_000,
                          dt: float = 1.0) -> RunMetrics:
        """Process everything queued in the scheduler; ``dt`` is the
        simulated wall-clock per engine step."""
        now = 0.0
        if self.trace.enabled:
            self.trace.begin_segment(
                f"engine:{self.sched.policy.name}")
        for _ in range(max_steps):
            if (self.sched.queue_depth() == 0
                    and not self.active_slots()):
                break
            self.step(now)
            now += dt
        return summarize_run(self.sched.policy.name,
                             self.sched.config.bias_enabled,
                             self.sched.completed,
                             busy_time=float(self.busy_steps) * dt)
