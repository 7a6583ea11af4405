"""Paged KV-cache pool: refcounted block-table + free-list allocator
with content-addressed prefix sharing.

A copy of ``repro.serving.kv_cache`` for the port (host numpy code;
the port imports nothing of ``repro``).  The device side of paging
lives in repro_torch.models.attention (pool-wide page slabs,
block-table gather) and repro_torch.kernels.paged_attention (the CUDA
kernel).  This module is the host side: a per-model ``PagePool``
hands out page ids from a free list, tracks peak occupancy, and
renders per-request block-table rows; ``PagedSequence`` is one
request's generation state over the pool.

Why pages: the ring-buffer engine reserves ``max_len`` KV slots per
batch slot, so memory scales with the worst case.  A pool is sized in
*pages* (num_pages x page_size tokens, shared by every in-flight
request); a request holds ceil(tokens / page_size) pages for exactly
as long as it runs, and releases them the step it finishes.  That is
what lets the continuous-batching scheduler pack short (easy) and long
(hard) requests onto the same device pool — the serving-side half of
the paper's multiplexing win.

Why sharing: the paper's zoo repeatedly probes models with the *same*
input, and production prompts share long system-prefix heads.  Pages
are therefore *refcounted*: a new request whose prompt shares a
page-aligned prefix with a resident sequence maps the same physical
pages (found through ``PrefixIndex``, a chain-hash over page-aligned
prompt-token chunks), prefills only the divergent tail, and the pools'
admission cost becomes *unique* pages.  ``free`` is decref-to-zero;
a write into a page with refcount > 1 must copy-on-write first
(Engine does the device copy; the pool does the bookkeeping).

Page 0 is the scratch page (attention.SCRATCH_PAGE): padding
block-table entries and inactive decode rows point at it, and nothing
written there is ever visible through the mask.  The allocator never
hands it out.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import threading
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.models.attention import SCRATCH_PAGE
from repro_torch.serving.observability.tracer import NULL_TRACER


class OutOfPages(ValueError):
    """The pool cannot satisfy an allocation.  A ValueError (bad
    request sizing and pool exhaustion read the same way to a caller
    validating inputs), but distinct so the scheduler can treat it as
    backpressure — hold the request until running ones free pages —
    rather than a permanent rejection."""


@dataclasses.dataclass
class PagedCacheConfig:
    """Geometry of one model's KV page pool."""
    num_pages: int                  # total pages incl. the scratch page
    page_size: int = 64             # tokens per page

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page {SCRATCH_PAGE} is scratch), "
                f"got {self.num_pages}")


# ---------------------------------------------------------------------------
# Prefix index: page-aligned prompt chunks -> resident physical pages
# ---------------------------------------------------------------------------

def _chunk_key(prev: bytes, tokens: np.ndarray, partial: bool) -> bytes:
    """Chain hash of one page chunk.  Keying on the whole token chain
    (prev digest + this chunk's bytes) makes a key a content address
    for *prefix + chunk*, so two prompts can only collide on a key if
    their page-aligned prefixes are token-identical (modulo sha1)."""
    h = hashlib.sha1(prev)
    h.update(b"P" if partial else b"F")       # a partial chunk never
    h.update(tokens.tobytes())                # aliases a full one
    return h.digest()


def chunk_keys(tokens, page_size: int) -> List[Tuple[bytes, bool]]:
    """(key, is_partial) for every page-aligned chunk of ``tokens`` —
    the content-address chain ``PrefixIndex`` keys pages by.  A
    zero-token prompt yields no
    keys — empty chunks are never indexed (see ``PagePool.pages_for``:
    zero tokens need zero pages)."""
    toks = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int64)
    keys: List[Tuple[bytes, bool]] = []
    prev = b""
    for start in range(0, len(toks), page_size):
        chunk = toks[start:start + page_size]
        partial = len(chunk) < page_size
        prev = _chunk_key(prev, chunk, partial)
        keys.append((prev, partial))
    return keys


@dataclasses.dataclass
class _PrefixEntry:
    page: int           # resident physical page holding this chunk's KV
    count: int          # resident sequences currently backing the entry


class PrefixIndex:
    """Content-addressed map from page-aligned prompt chunks to
    resident physical pages.

    Entries exist only while at least one registered (resident)
    sequence still holds the page, so a lookup can never hand out a
    freed page: ``PagePool.decref`` purges a page's entries the moment
    its refcount reaches zero, and retiring sequences ``unregister``
    their claims first.  The terminal *partial* chunk of a prompt is
    indexed too (under a distinct key tag): that is what lets a fully
    identical prompt share its boundary page — the page decode later
    copy-on-writes.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._page_keys: Dict[int, Set[bytes]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def _keys_for(self, tokens) -> List[Tuple[bytes, bool]]:
        """(key, is_partial) per page-aligned chunk (see chunk_keys)."""
        return chunk_keys(tokens, self.page_size)

    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest indexed page-aligned prefix of ``tokens``.

        Returns (pages, matched_len): matched_len is a multiple of
        page_size (full chunks only), except when the *entire* prompt —
        including its partial terminal chunk — is resident, in which
        case matched_len == len(tokens) and the last returned page is
        the resident's partially-filled boundary page.
        """
        toks = np.asarray(tokens).reshape(-1)
        pages: List[int] = []
        matched = 0
        for key, partial in self._keys_for(toks):
            ent = self._entries.get(key)
            if ent is None:
                break
            pages.append(ent.page)
            matched = len(toks) if partial else matched + self.page_size
        return pages, matched

    def register(self, tokens, pages: Sequence[int]) -> List[bytes]:
        """Register a resident sequence's prompt chunks -> its pages.
        Returns the keys this sequence now backs; the sequence must
        keep them and hand them to ``unregister`` when it retires."""
        out: List[bytes] = []
        for i, (key, _partial) in enumerate(self._keys_for(tokens)):
            if i >= len(pages):
                break
            ent = self._entries.get(key)
            if ent is None:
                ent = _PrefixEntry(page=int(pages[i]), count=0)
                self._entries[key] = ent
                self._page_keys.setdefault(ent.page, set()).add(key)
            elif ent.page != int(pages[i]):
                # same content resident under a different physical page
                # (e.g. after a copy-on-write): don't back an entry
                # whose page this sequence does not hold
                continue
            ent.count += 1
            out.append(key)
        return out

    def unregister(self, keys: Sequence[bytes]) -> None:
        """Drop one backing per key; entries fall away at zero.
        Lenient: keys already purged by a page free are skipped."""
        for key in keys:
            ent = self._entries.get(key)
            if ent is None:
                continue
            ent.count -= 1
            if ent.count <= 0:
                del self._entries[key]
                pk = self._page_keys.get(ent.page)
                if pk is not None:
                    pk.discard(key)
                    if not pk:
                        del self._page_keys[ent.page]

    def disown(self, keys: Sequence[bytes], page: int) -> List[bytes]:
        """A sequence stops backing entries that point at ``page``
        (it copy-on-wrote the page away).  Returns the surviving keys."""
        kept: List[bytes] = []
        for key in keys:
            ent = self._entries.get(key)
            if ent is not None and ent.page == int(page):
                self.unregister([key])
            else:
                kept.append(key)
        return kept

    def drop_page(self, page: int) -> None:
        """Purge every entry that maps to ``page`` (the page is being
        freed — a legacy ``free(pages)`` caller may not have
        unregistered first; the index must never outlive the page)."""
        for key in self._page_keys.pop(int(page), set()):
            self._entries.pop(key, None)

# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------

class PagePool:
    """Refcounted free-list allocator over one model's page pool (host
    side only).

    Pages are handed out lowest-id-first so repeated traces allocate
    deterministically; ``peak_in_use`` records the high-water mark of
    *unique* pages — the benchmarks report it as the real memory
    ceiling, and with prefix sharing it is what admission budgets
    against (a shared page costs nothing extra).
    """

    def __init__(self, num_pages: int, page_size: int = 64,
                 prefix_sharing: bool = True):
        self.cfg = PagedCacheConfig(num_pages=num_pages, page_size=page_size)
        self.prefix_sharing = prefix_sharing
        # mutating ops take this lock: a disaggregated backend allocates
        # from its decode executor thread (KV transfer) while the event
        # loop releases retiring sequences — heap/refcount updates must
        # not interleave.  RLock: release() nests into decref().
        self._lock = threading.RLock()
        # min-heap: lowest-id-first hand-out stays deterministic across
        # churn at O(log F) per page instead of a sort per free()
        self._free: List[int] = list(range(SCRATCH_PAGE + 1, num_pages))
        heapq.heapify(self._free)
        self._ref: Dict[int, int] = {}
        self._index = PrefixIndex(page_size)
        # pages some holder may still write while shared (a resident's
        # partially-filled boundary page mapped by an identical prompt),
        # each with the number of its holders that map it as their
        # boundary page: only those ever write into it, so only they
        # may need a copy-on-write allocation
        self._cow_writers: Dict[int, int] = {}
        self.peak_in_use = 0
        # tracing: alloc/free instants record here when a backend binds
        # a live tracer (it sets both attrs); the null default is free
        self.tracer = NULL_TRACER
        self.trace_track = "pool/events"

    # ---- geometry -----------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.cfg.num_pages

    @property
    def page_size(self) -> int:
        return self.cfg.page_size

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Unique physical pages held (shared pages count once)."""
        return len(self._ref)

    @property
    def shared_pages(self) -> int:
        return sum(1 for r in self._ref.values() if r > 1)

    @property
    def prefix_entries(self) -> int:
        return len(self._index)

    @property
    def cow_headroom(self) -> int:
        """Free pages admission must hold back: a writable shared page
        may still need one copy-on-write copy per writer but the last.
        Its writers are the resident that filled it and each holder
        that mapped it as its boundary page (``mark_cow_risk``), never
        more than its holders; a holder that maps it as an interior
        page (it shared a sequence that had grown past the page) never
        writes it and costs nothing.  (The JAX package's copy charges
        refcount - 1 for every such page, which counts those interior
        holders too.)"""
        return sum(max(min(w, self._ref.get(p, 0)) - 1, 0)
                   for p, w in self._cow_writers.items())

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` KV entries.  Zero tokens
        need zero pages — an empty sequence holds nothing and must
        index nothing (the prefix index refuses empty chunks for the
        same reason); negative counts are a sizing bug and raise."""
        n = int(num_tokens)
        if n < 0:
            raise ValueError(f"num_tokens must be >= 0, got {n}")
        return -(-n // self.page_size)

    # ---- alloc / refcounts --------------------------------------------
    def alloc(self, n: int) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise OutOfPages(
                    f"KV page pool exhausted: request needs {n} pages but "
                    f"only {len(self._free)} of {self.num_pages - 1} "
                    f"allocatable pages are free ({self.pages_in_use} held "
                    f"by in-flight requests); raise num_pages, shrink "
                    f"max_new_tokens, or wait for running requests to "
                    f"finish")
            pages = [heapq.heappop(self._free) for _ in range(n)]
            for pg in pages:
                self._ref[pg] = 1
            self.peak_in_use = max(self.peak_in_use, len(self._ref))
            if self.tracer.enabled:
                self.tracer.instant("page_alloc", track=self.trace_track,
                                    args={"n": n,
                                          "free": len(self._free)})
            return pages

    def refcount(self, page: int) -> int:
        """Current reference count (0 for a free page)."""
        return self._ref.get(int(page), 0)

    def incref(self, pages: Sequence[int]) -> None:
        """Add one reference per listed page (prefix sharing: a new
        request maps a resident's pages).  All pages must be held."""
        with self._lock:
            bad = [pg for pg in pages if int(pg) not in self._ref]
            if bad:
                raise ValueError(
                    f"incref of free/foreign pages {sorted(bad)}")
            for pg in pages:
                self._ref[int(pg)] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reference per listed page; a page reaching zero
        returns to the free list (and any prefix-index entries still
        pointing at it are purged, so the index never outlives the
        page).  ``decref([])`` is a no-op by contract — retiring an
        empty sequence must succeed.  Duplicates in one call and
        free/foreign pages are rejected before anything mutates."""
        with self._lock:
            uniq = {int(pg) for pg in pages}
            bad = uniq - set(self._ref)
            if bad or len(uniq) != len(pages):
                raise ValueError(
                    f"double free / foreign pages "
                    f"{sorted(bad) or list(pages)}")
            freed = 0
            for pg in pages:
                pg = int(pg)
                self._ref[pg] -= 1
                if self._ref[pg] == 0:
                    del self._ref[pg]
                    self._index.drop_page(pg)
                    self._cow_writers.pop(pg, None)
                    heapq.heappush(self._free, pg)
                    freed += 1
                elif self._ref[pg] == 1:
                    # exclusive again: no copy-on-write can be pending
                    self._cow_writers.pop(pg, None)
            if freed and self.tracer.enabled:
                self.tracer.instant("page_free", track=self.trace_track,
                                    args={"n": freed,
                                          "free": len(self._free)})

    def free(self, pages: Sequence[int]) -> None:
        """Decref-to-zero compatibility alias: with refcounts, "free"
        means dropping this holder's reference — the page only returns
        to the free list when no other sequence still maps it."""
        self.decref(pages)

    def mark_cow_risk(self, page: int) -> None:
        """Flag a shared page that the caller — a new holder that maps
        it as its boundary page — may still write, as may the resident
        that filled it (admission reserves ``cow_headroom`` free pages
        against these)."""
        with self._lock:
            pg = int(page)
            if self.refcount(pg) > 1:
                self._cow_writers[pg] = self._cow_writers.get(pg, 1) + 1

    # ---- prefix sharing -----------------------------------------------
    def lookup_prefix(self, tokens) -> Tuple[List[int], int]:
        """Resident pages matching ``tokens``' page-aligned prefix:
        (pages, matched_len).  Pure — call ``incref`` to map them."""
        if not self.prefix_sharing:
            return [], 0
        with self._lock:
            return self._index.lookup(tokens)

    def register_prefix(self, tokens, pages: Sequence[int]) -> List[bytes]:
        """Index a now-resident sequence's prompt chunks so later
        requests can share them.  Returns the backing keys (store on
        the sequence; ``release`` hands them back)."""
        if not self.prefix_sharing:
            return []
        with self._lock:
            return self._index.register(tokens, pages)

    def unregister_prefix(self, keys: Sequence[bytes]) -> None:
        with self._lock:
            self._index.unregister(keys)

    def disown_prefix(self, keys: Sequence[bytes], page: int) -> List[bytes]:
        with self._lock:
            return self._index.disown(keys, page)

    def release(self, seq: "PagedSequence") -> None:
        """Retire one sequence: unregister its prefix-index claims,
        then decref its pages.  Pages still shared by other residents
        survive; exclusive ones return to the free list.  ``None``
        entries (pages already reclaimed out of a banded layer's
        attention span) are skipped — the sequence no longer holds
        them."""
        with self._lock:
            keys = getattr(seq, "prefix_keys", None)
            if keys:
                self._index.unregister(keys)
                seq.prefix_keys = []
            self.decref([pg for pg in seq.pages if pg is not None])

    # ---- rendering / stats --------------------------------------------
    def block_table(self, pages: Sequence[int], max_pages: int) -> np.ndarray:
        """Render an ordered page list as a padded block-table row."""
        if len(pages) > max_pages:
            raise ValueError(f"{len(pages)} pages > block table width "
                             f"{max_pages}")
        row = np.full((max_pages,), SCRATCH_PAGE, np.int32)
        row[:len(pages)] = np.asarray(pages, np.int32)
        return row

    def stats(self) -> Dict[str, int]:
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "pages_in_use": self.pages_in_use, "num_free": self.num_free,
                "peak_pages_in_use": self.peak_in_use,
                "shared_pages": self.shared_pages,
                "prefix_entries": self.prefix_entries,
                "cow_headroom": self.cow_headroom}

@dataclasses.dataclass
class PagedSequence:
    """One request's generation state over a PagePool.

    ``tokens`` holds generated tokens only (the first comes from
    prefill); ``pos`` is the position the *next* decode insert writes,
    i.e. prompt_len + number of decode steps taken.  ``seed`` roots the
    request's sampling-key chain (the token at position i is sampled
    with fold_in(key(seed), i)), so a sampled generation is a function
    of (seed, prompt) alone — independent of batch composition, engine
    history, and whether it decoded solo or continuously batched.

    ``shared_prefix_len`` is how many prompt tokens were mapped from a
    resident sequence instead of prefilled (0 = no sharing), and
    ``prefix_keys`` are this sequence's prefix-index claims —
    ``PagePool.release`` retires both together.

    Chunked prefill (Engine.begin_prefill / prefill_chunk) makes the
    state *resumable*: ``prefill_pos`` is the next prompt position to
    run, ``prefill_done`` flips once the final prompt token's logits
    sampled the first token, and pages are allocated chunk by chunk —
    ``pages`` always lists exactly what this sequence holds, so
    ``PagePool.release(seq)`` is a complete rollback at any phase
    (that is what makes mid-prefill cancellation leak-free).
    ``stop_tokens`` ends generation early; ``temperature`` overrides
    the engine's sampling temperature for this request only.
    """
    pages: List[Optional[int]]       # None = reclaimed out-of-span slot
    block_table: np.ndarray          # (max_pages,) int32, scratch-padded
    prompt_len: int
    pos: int
    max_new_tokens: int
    last_token: int
    seed: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    shared_prefix_len: int = 0
    prefix_keys: List[bytes] = dataclasses.field(default_factory=list)
    # resumable-prefill state (chunked prefill / streaming API)
    prompt: Optional[np.ndarray] = None   # needed while prefill resumes
    prefill_pos: int = 0                  # next prompt position to compute
    prefill_done: bool = True             # False between begin and finish
    prefix_mapped: bool = True            # False until the lazy shared-
    #   prefix lookup ran (first prefill_chunk; begin defers it so a
    #   burst of admissions can still share a prefix the first of them
    #   only registers when ITS prefill seals)
    insert_from: int = 0                  # writes below this go to scratch
    stop_tokens: FrozenSet[int] = frozenset()
    temperature: Optional[float] = None   # None = engine default
    reclaimed_upto: int = 0               # page slots below this index were
    #   span-reclaimed (None in ``pages``); the decode-time reclaim scan
    #   resumes here instead of rescanning freed slots every token

    @property
    def done(self) -> bool:
        if not self.prefill_done:
            return False
        if self.tokens and int(self.tokens[-1]) in self.stop_tokens:
            return True
        return len(self.tokens) >= self.max_new_tokens

    @property
    def finish_reason(self) -> str:
        """"stop" | "length" once ``done``; generation-loop callers
        surface it through the FINISHED event."""
        if self.tokens and int(self.tokens[-1]) in self.stop_tokens:
            return "stop"
        return "length"


def pool_bytes_per_page(cfg, page_size: int) -> int:
    """Device bytes one page costs across every layer of a model
    (shape-only: the pool is laid out on the ``meta`` device, so
    nothing is allocated)."""
    from repro_torch.models import transformer as tf
    caches = tf.init_caches(cfg, num_pages=1, page_size=page_size,
                            device="meta")
    return sum(x.numel() * x.element_size()
               for slabs in caches.values() for x in slabs.values())


def pool_bytes_per_token(cfg, page_size: int) -> int:
    """Device bytes one resident token costs across every layer of a
    model — pool_bytes_per_page / page_size.  This is the lower bound
    on decode device-memory reads per generated token for a
    full-attention stack (every resident token's K/V is read once per
    step when the kernel is KV-head-grouped)."""
    return pool_bytes_per_page(cfg, page_size) // page_size
