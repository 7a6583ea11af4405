"""Serving engine: the ring-cache ``generate`` and the paged path
(prefill into a shared page pool, token-level continuous decode).

Port of ``repro.serving.engine``.  ``generate`` is the classic
fixed-shape path: one ring-buffer KV slab (or mamba state) per batch
slot, every request of the batch at the same position.  On the paged
path KV lives in a pool of (page_size)-token pages shared by all
in-flight requests (``PagePool``); each request holds
ceil(tokens / page_size) pages addressed through a block-table row, and
a decode batch mixes requests at *different* positions.  Prefix sharing
maps a resident prompt's pages into a new request, a cross-request
logit cache serves repeat prompts with no device work, and a decode
step that would write into a shared page copies it first
(copy-on-write) inside the same step.

Differences from the JAX engine:

* Where the JAX engine jits its decode steps, the port replays CUDA
  graphs (``repro_torch.graphs.CudaGraphed``): on a CUDA device each
  ring decode step of ``generate`` and each paged ``decode_step_batch``
  is one replay of a captured step, the plain paged step or the one
  with the fused copy-on-write (the reference's ``paged_decode_fn`` /
  ``paged_decode_cow_fn``), and each ``verify_step_batch`` one replay
  of the multi-token verify step (``paged_verify_fn``), captured per
  width.  A capture or replay that fails raises; nothing runs the step
  eagerly instead.  On the CPU the same step functions run directly on
  the same buffers.  Prefill stays eager (its shapes follow each
  prompt).
* There is no donation: the pool and the ring / Mamba caches are
  allocated once (the ring caches once per batch size, on first use)
  and updated in place, at the fixed addresses the graphs hold.  A
  failure in the middle of a step can leave the pool partly written,
  so any device-side exception marks the caches poisoned
  (``caches_poisoned``), as a failed donating call does in the JAX
  engine.
* Temperature > 0 draws each row's token from a ``torch.Generator``
  seeded from (the request's seed, the token's position): a row's token
  does not depend on its batch mates, as in the JAX engine, but the
  stream differs from ``jax.random``'s.  ``generate`` seeds row i of
  its batch from ``ServeConfig.seed + i`` the same way, where the JAX
  engine draws the whole batch from one key per step.  Greedy decoding
  (temperature 0) is an exact argmax in both.
* Not ported yet: the host-RAM tier.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import CudaGraphed
from repro_torch.models import transformer as tf
from repro_torch.models.attention import SCRATCH_PAGE
from repro_torch.serving.kv_cache import OutOfPages, PagePool, PagedSequence
from repro_torch.serving.observability.tracer import NULL_TRACER


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256                  # cache capacity per request
    temperature: float = 0.0            # 0 = greedy
    seed: int = 0


@dataclasses.dataclass
class _Ring:
    """Engine-owned ring / Mamba caches for one batch size, and the
    decode step over them: (token (B, 1) int32, pos (1,) int64) ->
    logits (B, V)."""
    caches: Dict[str, Any]
    decode: Callable


def _row_seed(seed: int, position: int) -> int:
    """Generator seed of the token sampled at ``position`` of a request
    rooted at ``seed``: a hash of the pair alone.  Every bit depends on
    both, because the CPU generator keeps only the low 32 bits of its
    seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(position)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Engine:
    """Ring-cache generation and paged prefill / decode for one model on
    one device."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        # serializes the entry points that write the pool in place
        # (prefill_chunk / decode_step_batch): a backend executor and a
        # MuxServer.probe prewarm on the caller thread must never overlap
        # on one engine.  RLock: prefill_into_pages nests prefill_chunk.
        self._device_lock = threading.RLock()
        # ring caches and their decode step, by batch size (generate)
        self._rings: Dict[int, _Ring] = {}
        # wall seconds of each graph capture, by step name
        self.capture_s: Dict[str, float] = {}
        # paged state (populated by init_paged)
        self.pool: Optional[PagePool] = None
        self._paged_caches = None
        self._paged_decode: Optional[Callable] = None
        self._paged_decode_cow: Optional[Callable] = None
        self._paged_verify: Optional[Callable] = None
        self._lazy_decode_alloc = False
        self._max_pages = 0
        self._decode_batch = 0
        self._caches_poisoned = False
        # prefix-sharing accounting: prompt tokens run through prefill
        # (padded) vs mapped from a resident shared prefix, and
        # copy-on-write page copies made
        self.prefill_tokens_computed = 0
        self.prefill_tokens_shared = 0
        self.whole_prompt_prefills = 0      # flash-attention prefills
        self.cow_count = 0
        # cross-request logit cache: full-prompt hash -> the final prompt
        # token's logits row (bounded LRU; disabled at capacity 0)
        self._logit_cache: "collections.OrderedDict[bytes, np.ndarray]" = \
            collections.OrderedDict()
        self._logit_cache_cap = 0
        self.logit_cache_hits = 0
        self.logit_cache_misses = 0
        # probe-path prewarm residents (prompt key -> held sequence)
        self._prewarmed: "collections.OrderedDict[bytes, PagedSequence]" = \
            collections.OrderedDict()
        self._prewarm_cap = 0
        # window/chunked span reclaim (None = a full-span layer exists)
        self._layer_spans: Optional[List[Tuple[str, int]]] = None
        self._span_reclaim = True
        self.reclaimed_pages = 0
        self.tracer = NULL_TRACER
        self.trace_track = f"engine:{cfg.name}/events"

    @property
    def caches_poisoned(self) -> bool:
        """True once a paged step failed on the device: the pool may be
        partly written, so the engine cannot serve the paged path again
        (rebuild via init_paged)."""
        return self._caches_poisoned

    def _check_capacity(self, p: int, max_new_tokens: int) -> None:
        if p + max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt length {p} + max_new_tokens {max_new_tokens} "
                f"exceeds the engine's cache capacity "
                f"max_len={self.scfg.max_len}; raise ServeConfig.max_len "
                f"or shorten the request")

    def _sample_rows(self, logits, seeds, positions, temps=None) -> np.ndarray:
        """Per-row sampling of logits (B, V) (see ``_pick``); only the
        chosen ids reach the host."""
        return self._pick(logits, seeds, positions, temps).cpu().numpy()

    def _pick(self, logits, seeds, positions, temps=None) -> torch.Tensor:
        """Per-row sampling of logits (B, V) into (B,) int32 ids on the
        logits' device: rows at temperature <= 0 take the argmax; a
        sampled row draws from a generator on the logits' device seeded
        by (seeds[i], positions[i]), independent of its batch mates."""
        if temps is None:
            t = np.full((logits.shape[0],), self.scfg.temperature, np.float32)
        else:
            t = np.asarray([self.scfg.temperature if x is None else x
                            for x in temps], np.float32)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in np.nonzero(t > 0.0)[0]:
            gen = torch.Generator(device=logits.device).manual_seed(
                _row_seed(seeds[i], positions[i]))
            probs = torch.softmax(logits[i].float() / float(t[i]), -1)
            ids[i] = torch.multinomial(probs, 1, generator=gen)[0]
        return ids

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _compiled(self, fn: Callable, name: str) -> Callable:
        """A decode step in the form the device runs it: replayed from a
        CUDA graph on the card, the function itself on the CPU."""
        return CudaGraphed(fn, name) if self.device.type == "cuda" else fn

    def _ring(self, b: int) -> _Ring:
        """The ring / Mamba caches of batch ``b`` (capacity max_len,
        bf16 as ``tf.prefill`` makes them) and their decode step,
        allocated on first use.  The step is captured here, while the
        caches hold nothing yet: its warm-up advances a Mamba state,
        which every prefill resets (``tf.reset_caches``) before use."""
        ring = self._rings.get(b)
        if ring is None:
            caches = tf.init_caches(self.cfg, b, self.scfg.max_len,
                                    torch.bfloat16, device=self.device)

            def decode(token, pos):
                logits, _ = tf.decode_step(self.params, self.cfg, token,
                                           caches, pos)
                return logits[:, 0]

            name = f"ring_decode_b{b}"
            ring = _Ring(caches, self._compiled(decode, name))
            if isinstance(ring.decode, CudaGraphed):
                self.capture_s[name] = ring.decode.capture(
                    torch.zeros((b, 1), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((1,), dtype=torch.long, device=self.device))
            self._rings[b] = ring
        return ring

    def generate(self, prompts, *, max_new_tokens: int) -> Dict[str, Any]:
        """Ring-cache generation for a batch at one shared position.
        prompts: (B, P) int token ids (a tensor or an array).  The
        prompt fills the engine's ring caches for batch B (reset first);
        each decode step replays that batch's captured step (CUDA) or
        runs it (CPU); sampling stays outside the step.

        Returns {tokens (B, P+N) on the engine's device, prefill_s,
        decode_s, tokens_per_s}; the times run to a device synchronise.
        """
        if not torch.is_tensor(prompts):
            prompts = torch.as_tensor(np.asarray(prompts))
        prompts = prompts.to(self.device)
        b, p = prompts.shape[:2]
        self._check_capacity(p, max_new_tokens)
        seeds = [self.scfg.seed + i for i in range(b)]
        with self._device_lock:            # one request owns the caches
            ring = self._ring(b)
            # the position of each decode step's input token, on the
            # device before the loop: a step reads nothing from the host
            positions = torch.arange(p, p + max_new_tokens, dtype=torch.long,
                                     device=self.device)
            t0 = time.perf_counter()
            logits, _ = tf.prefill(self.params, self.cfg, prompts,
                                   caches=ring.caches)
            tok = self._pick(logits[:, 0], seeds, [p] * b)
            self._sync()
            t1 = time.perf_counter()
            out = [prompts, tok.reshape(b, 1).to(prompts.dtype)]
            for i in range(max_new_tokens - 1):
                logits = ring.decode(tok.reshape(b, 1), positions[i:i + 1])
                tok = self._pick(logits, seeds, [p + i + 1] * b)
                out.append(tok.reshape(b, 1).to(prompts.dtype))
            self._sync()
            t2 = time.perf_counter()
        return {"tokens": torch.cat(out, dim=1), "prefill_s": t1 - t0,
                "decode_s": t2 - t1,
                "tokens_per_s": b * max_new_tokens / max(t2 - t1, 1e-9)}

    # ------------------------------------------------------------------
    # Paged path: pool-backed caches, token-level continuous decode
    # ------------------------------------------------------------------
    def init_paged(self, *, num_pages: int, page_size: int = 64,
                   decode_batch: int = 8,
                   prefix_sharing: bool = True,
                   logit_cache: int = 0,
                   span_reclaim: bool = True,
                   lazy_decode_alloc: bool = False) -> PagePool:
        """Allocate the paged KV pool in ``cfg.kv_cache_dtype`` (int8
        pools store quantized pages, dequantized in the kernel).  The
        pool is sized in *pages*, not batch slots.
        ``prefix_sharing=False`` disables the prefix index.
        ``logit_cache`` is the LRU capacity of the cross-request logit
        cache (0 = off).  Decode frees pages that have fallen wholly
        below every layer's attention span unless
        ``span_reclaim=False``.  ``lazy_decode_alloc=True`` seals a
        prefill with only the prompt's pages (prompt + 1 tokens)
        instead of the whole prompt + budget span; decode steps then
        grow the sequence page by page.  The speculative drafter runs
        its engine this way, so that a rejected draft's pages can be
        handed back (``rollback_pages``)."""
        self.pool = PagePool(num_pages=num_pages, page_size=page_size,
                             prefix_sharing=prefix_sharing)
        self._max_pages = self.pool.pages_for(self.scfg.max_len)
        self._decode_batch = decode_batch
        self._caches_poisoned = False
        self.prefill_tokens_computed = 0
        self.prefill_tokens_shared = 0
        self.whole_prompt_prefills = 0      # flash-attention prefills
        self.cow_count = 0
        self._logit_cache = collections.OrderedDict()
        self._logit_cache_cap = int(logit_cache)
        self.logit_cache_hits = 0
        self.logit_cache_misses = 0
        self._prewarmed = collections.OrderedDict()
        self._prewarm_cap = max(1, min(4, int(logit_cache)))
        self._span_reclaim = span_reclaim
        self._layer_spans = self._banded_spans()
        self.reclaimed_pages = 0
        self._lazy_decode_alloc = lazy_decode_alloc
        # free the old pool (and the graphs that hold it) before the new
        self._paged_decode = self._paged_decode_cow = None
        self._paged_verify = None
        self._paged_caches = None
        self._paged_caches = tf.init_caches(
            self.cfg, num_pages=num_pages, page_size=page_size,
            device=self.device)
        self._paged_decode = self._compiled(self._paged_step(cow=False),
                                            "paged_decode")
        self._paged_decode_cow = self._compiled(self._paged_step(cow=True),
                                                "paged_decode_cow")
        self._paged_verify = self._compiled(self._verify_step(),
                                            "paged_verify")
        return self.pool

    def _paged_step(self, cow: bool) -> Callable:
        """The paged decode step over this pool, as one function of one
        (decode_batch, 2 + max_pages [+ 2]) int32 operand: per row the
        input token, its position and its block-table row, and with
        ``cow`` a copy-on-write source and destination page (scratch ->
        scratch on rows that copy nothing).  The COW form first copies
        src -> dst across every layer's slabs, as the JAX engine's
        ``paged_decode_cow_fn`` does.  Returns logits (decode_batch, V).
        """
        caches, m = self._paged_caches, self._max_pages

        def step(packed):
            if cow:
                src = packed[:, 2 + m].long()
                dst = packed[:, 3 + m].long()
                for slabs in caches.values():
                    for x in slabs.values():
                        x[:, dst] = x[:, src]
            logits, _ = tf.decode_step(self.params, self.cfg, packed[:, :1],
                                       caches, packed[:, 1],
                                       block_tables=packed[:, 2:2 + m])
            return logits[:, 0]
        return step

    def _verify_step(self) -> Callable:
        """The speculative verify step over this pool, as one function
        of one (decode_batch, width + 1 + max_pages) int32 operand: per
        row the ``width`` fed tokens, the absolute position of the first
        (``q_offset``) and the block-table row; the width follows from
        the operand's shape.  Runs ``tf.verify_paged`` (the tail-prefill
        path at per-row positions) and returns logits for every fed
        position, (decode_batch, width, V), as the JAX engine's
        ``paged_verify_fn`` does."""
        caches, m = self._paged_caches, self._max_pages

        def step(packed):
            w = packed.shape[1] - 1 - m
            logits, _ = tf.verify_paged(self.params, self.cfg, packed[:, :w],
                                        caches, packed[:, w + 1:],
                                        packed[:, w])
            return logits
        return step

    def capture_verify_step(self, width: int) -> float:
        """Capture the verify step at (decode_batch, ``width``) before
        traffic, on an operand that touches only the scratch page (every
        row token 0 at position 0 of a block table of scratch pages).
        Returns the capture's wall seconds (0.0 on the CPU, which
        captures nothing)."""
        if self.pool is None:
            raise RuntimeError("no paged KV pool: call init_paged() first")
        step = self._paged_verify
        if not isinstance(step, CudaGraphed):
            return 0.0
        packed = torch.full(
            (self._decode_batch, width + 1 + self._max_pages), SCRATCH_PAGE,
            dtype=torch.int32, device=self.device)
        packed[:, :width + 1] = 0
        with self._device_lock:
            secs = self.capture_s[f"paged_verify_w{width}"] = \
                step.capture(packed)
        return secs

    def capture_decode_steps(self) -> Dict[str, float]:
        """Capture both paged decode steps (plain and copy-on-write) at
        the engine's (decode_batch, max_pages) before traffic, so that
        no served step pays a capture.  The capture's inputs touch only
        the scratch page: every row inactive (token 0 at position 0 of a
        block table of scratch pages), every copy scratch -> scratch.
        Returns the wall seconds of each capture ({} on the CPU, which
        captures nothing)."""
        if self.pool is None:
            raise RuntimeError("no paged KV pool: call init_paged() first")
        out = {}
        with self._device_lock:
            for name, step, width in (
                    ("paged_decode", self._paged_decode, 2),
                    ("paged_decode_cow", self._paged_decode_cow, 4)):
                if isinstance(step, CudaGraphed):
                    out[name] = self.capture_s[name] = step.capture(
                        torch.full((self._decode_batch,
                                    width + self._max_pages), SCRATCH_PAGE,
                                   dtype=torch.int32, device=self.device))
        return out

    @property
    def decode_batch(self) -> int:
        """Decode-batch capacity of the paged path (0 before
        init_paged)."""
        return self._decode_batch

    # ---- window/chunked span reclaim ----------------------------------
    def _banded_spans(self) -> Optional[List[Tuple[str, int]]]:
        """(kind, span) per pattern layer when EVERY layer is banded
        (swa/chunked); None when any layer attends the full context —
        the block tables are shared across layers, so a page is only
        freeable once no layer can ever look at it again."""
        spans: List[Tuple[str, int]] = []
        for spec in self.cfg.pattern:
            if (spec.mixer == "attn" and spec.attn_kind == "swa"
                    and self.cfg.window):
                spans.append(("swa", int(self.cfg.window)))
            elif (spec.mixer == "attn" and spec.attn_kind == "chunked"
                    and self.cfg.chunk):
                spans.append(("chunked", int(self.cfg.chunk)))
            else:
                return None
        return spans

    def _reclaim_out_of_span(self, seq: PagedSequence) -> None:
        """Decref pages wholly below every layer's attention span.  The
        lower bounds of swa (pos - window + 1) and chunked (chunk floor)
        layers never decrease, so once a page's last token falls below
        the minimum across layers no future query can see it; its
        block-table slot points at scratch and the page returns to the
        pool."""
        if self._layer_spans is None or not self._span_reclaim:
            return
        pos = seq.pos                  # next insert/query position
        lo = None
        for kind, span in self._layer_spans:
            l = pos - span + 1 if kind == "swa" else (pos // span) * span
            lo = l if lo is None else min(lo, l)
        if lo is None or lo <= 0:
            return
        freeable = min(lo // self.pool.page_size, len(seq.pages))
        if freeable <= seq.reclaimed_upto:
            return                     # nothing new fell out of span
        freed: List[int] = []
        for idx in range(seq.reclaimed_upto, freeable):
            pg = seq.pages[idx]
            if pg is None:
                continue               # already reclaimed
            seq.prefix_keys = self.pool.disown_prefix(seq.prefix_keys, pg)
            seq.pages[idx] = None
            seq.block_table[idx] = SCRATCH_PAGE
            freed.append(pg)
        seq.reclaimed_upto = freeable
        if freed:
            self.pool.decref(freed)
            self.reclaimed_pages += len(freed)
            self.tracer.instant("span_reclaim", track=self.trace_track,
                                args={"pages": len(freed), "pos": pos})

    # ---- probe-path prewarm -------------------------------------------
    def prewarm_logits(self, prompt) -> Optional[np.ndarray]:
        """Probe-path prewarm: run — or reuse — the prompt's prefill,
        keep its pages resident in a small LRU of held sequences, and
        cache the final-token logits row, so a follow-up admission of
        the same prompt is a zero-FLOP logit-cache hit.  Returns the
        logits row; best-effort — a full pool or an engine without a
        logit cache returns None."""
        if self.pool is None or self._logit_cache_cap <= 0:
            return None
        prompt_np = np.asarray(prompt, np.int32).reshape((-1,))
        if len(prompt_np) < 1:
            return None
        key = self._prompt_key(prompt_np)
        if key in self._prewarmed:
            self._prewarmed.move_to_end(key)
            return self._logit_cache_get(key)
        try:
            seq = self.prefill_into_pages(prompt_np, max_new_tokens=1)
        except (OutOfPages, ValueError):
            return None                # probe must never fail admission
        self._prewarmed[key] = seq
        while len(self._prewarmed) > self._prewarm_cap:
            _, old = self._prewarmed.popitem(last=False)
            self.pool.release(old)
        self.tracer.instant("prewarm", track=self.trace_track,
                            args={"pages": len(seq.pages),
                                  "residents": len(self._prewarmed)})
        return self._logit_cache_get(key)

    def shed_prewarmed(self) -> int:
        """Release every probe-prewarmed resident (prewarmed pages are a
        cache; real requests outrank them).  Returns the number shed."""
        shed = 0
        while self._prewarmed:
            _, old = self._prewarmed.popitem(last=False)
            self.pool.release(old)
            shed += 1
        return shed

    def _shared_prefix(self, prompt_np: np.ndarray,
                       p: int) -> Tuple[List[int], int, int]:
        """Resident pages this prompt can map: (mapped_pages,
        matched_len, shared_len).  shared_len (the tokens *not*
        recomputed) is clamped to p - 1 — prefill must always run at
        least the final prompt token to produce next-token logits."""
        if self.pool is None or not self.pool.prefix_sharing:
            return [], 0, 0
        mapped, matched = self.pool.lookup_prefix(prompt_np)
        shared_len = min(matched, p - 1)
        if shared_len <= 0:
            return [], 0, 0
        return mapped, matched, shared_len

    def admission_page_cost(self, prompt, max_new_tokens: int, *,
                            chunk_tokens: Optional[int] = None
                            ) -> Tuple[int, int]:
        """(pages a fresh admission would allocate now, free pages to
        hold back for its future copy-on-write).  With prefix sharing
        this is the *unique*-page cost; the headroom is 1 when the
        prompt would map a resident's partially-filled boundary page.
        With ``chunk_tokens`` (chunked prefill) admission budgets the
        first chunk rather than the whole prompt."""
        prompt_np = np.asarray(prompt, np.int32).reshape((-1,))
        p = len(prompt_np)
        total = self.pool.pages_for(self._sealed_span(p, max_new_tokens))
        mapped, matched, shared_len = self._shared_prefix(prompt_np, p)
        headroom = (1 if (mapped and matched == p and p % self.pool.page_size)
                    else 0)
        if chunk_tokens is not None and shared_len + chunk_tokens < p:
            first = self.pool.pages_for(shared_len + chunk_tokens)
            return max(first - len(mapped), 0), headroom
        return total - len(mapped), headroom

    @staticmethod
    def _prompt_key(prompt_np: np.ndarray) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(prompt_np, np.int64).tobytes()).digest()

    def _logit_cache_get(self, key: bytes) -> Optional[np.ndarray]:
        row = self._logit_cache.get(key)
        if row is not None:
            self._logit_cache.move_to_end(key)
        return row

    def _logit_cache_put(self, key: bytes, row: np.ndarray) -> None:
        if self._logit_cache_cap <= 0:
            return
        self._logit_cache[key] = row
        self._logit_cache.move_to_end(key)
        while len(self._logit_cache) > self._logit_cache_cap:
            self._logit_cache.popitem(last=False)

    # ---- resumable prefill --------------------------------------------
    def begin_prefill(self, prompt, *, max_new_tokens: int,
                      seed: Optional[int] = None,
                      temperature: Optional[float] = None,
                      stop_tokens: Sequence[int] = ()) -> PagedSequence:
        """Host-side admission of one request: validate and return a
        *resumable* sequence — ``prefill_chunk`` then runs the prompt
        through the device in chunks, allocating pages as it goes,
        until the first token samples.  ``PagePool.release(seq)`` at any
        point hands back exactly what the sequence holds.  The
        shared-prefix lookup is deferred to the first ``prefill_chunk``
        call, so a burst of admissions begun together can still share a
        prefix the first of them only registers when it seals."""
        if self.pool is None:
            raise RuntimeError("no paged KV pool: call init_paged() first")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (prefill always samples the "
                f"first token), got {max_new_tokens}")
        prompt_np = np.asarray(prompt, np.int32).reshape((-1,))
        p = len(prompt_np)
        if p < 1:
            raise ValueError("prompt must hold at least one token")
        self._check_capacity(p, max_new_tokens)
        seq_seed = self.scfg.seed if seed is None else seed
        return PagedSequence(
            pages=[],
            block_table=self.pool.block_table([], self._max_pages),
            prompt_len=p, pos=0, max_new_tokens=max_new_tokens,
            last_token=-1, seed=seq_seed, shared_prefix_len=0,
            prompt=prompt_np, prefill_pos=0, prefill_done=False,
            prefix_mapped=False, insert_from=0,
            stop_tokens=frozenset(int(t) for t in stop_tokens),
            temperature=temperature)

    def _map_shared_prefix(self, seq: PagedSequence) -> None:
        """Lazy first-chunk mapping: incref any resident shared-prefix
        pages and, on a fully-resident repeat prompt with a cached
        final-token logits row, seal the prefill with no device work
        (the logit-cache fast path).  Runs once per sequence; an
        OutOfPages from the fast path leaves the mapped pages held and
        the sequence resumable."""
        pool, ps = self.pool, self.pool.page_size
        p = seq.prompt_len
        mapped, matched, shared_len = self._shared_prefix(seq.prompt, p)
        seq.prefix_mapped = True
        if mapped:
            pool.incref(mapped)
            if matched == p and p % ps:
                # the resident's partially-filled boundary page is now
                # shared; whichever holder inserts into it first must
                # copy-on-write (admission reserved the headroom)
                pool.mark_cow_risk(mapped[-1])
            for i, pg in enumerate(mapped):
                seq.block_table[i] = pg
            seq.pages = list(mapped)
            seq.prefill_pos = shared_len
            seq.shared_prefix_len = shared_len
            seq.insert_from = len(mapped) * ps
        if matched == p and self._logit_cache_cap > 0:
            row = self._logit_cache_get(self._prompt_key(seq.prompt))
            if row is not None:
                self._grow_pages(seq, pool.pages_for(
                    self._sealed_span(p, seq.max_new_tokens)))
                tok = int(self._sample_rows(
                    torch.from_numpy(row)[None], [seq.seed], [p],
                    temps=[seq.temperature])[0])
                self.logit_cache_hits += 1
                self.prefill_tokens_shared += p
                seq.shared_prefix_len = p
                self.tracer.instant("logit_cache_hit",
                                    track=self.trace_track,
                                    args={"prompt_len": int(p)})
                self._seal_prefill(seq, tok)

    def _sealed_span(self, p: int, max_new_tokens: int) -> int:
        """Token span a sealing prefill reserves pages for: the whole
        prompt + decode budget, or prompt + 1 under lazy decode
        allocation (decode steps then grow page by page)."""
        return (p + 1) if self._lazy_decode_alloc else (p + max_new_tokens)

    def set_lazy_decode_alloc(self, enabled: bool) -> None:
        """Turn lazy decode allocation on or off after ``init_paged``
        (the scheduler pushes ``PagedLLMConfig.lazy_decode_alloc`` here
        at startup).  Only sequences sealed from now on are affected."""
        self._lazy_decode_alloc = bool(enabled)

    def _grow_pages(self, seq: PagedSequence, upto: int) -> None:
        """Extend ``seq`` to hold ``upto`` pages (alloc + block-table
        update).  Raises OutOfPages with nothing mutated."""
        need = upto - len(seq.pages)
        if need <= 0:
            return
        new = self.pool.alloc(need)
        for pg in new:
            seq.block_table[len(seq.pages)] = pg
            seq.pages.append(pg)

    def _seal_prefill(self, seq: PagedSequence, tok: int) -> None:
        seq.last_token = tok
        seq.tokens = [tok]
        seq.pos = seq.prompt_len
        seq.prefill_pos = seq.prompt_len
        seq.prefill_done = True
        seq.prefix_keys = self.pool.register_prefix(seq.prompt, seq.pages)

    def prefill_chunk(self, seq: PagedSequence, *,
                      chunk_tokens: Optional[int] = None) -> bool:
        """Run the next prefill chunk of a sequence started by
        ``begin_prefill``; returns True once the prompt is fully
        prefilled and the first token sampled.

        ``chunk_tokens`` (a multiple of page_size) caps this step's
        prompt span — the q_offset tail path computes positions
        ``prefill_pos .. prefill_pos + chunk - 1`` against everything
        already resident.  ``None`` runs the whole remaining prompt.
        Pages for the chunk (plus the decode budget, on the final
        chunk) allocate here; OutOfPages raises *before* any device
        work with the sequence unchanged."""
        with self._device_lock:
            return self._prefill_chunk_locked(seq, chunk_tokens=chunk_tokens)

    def _prefill_chunk_locked(self, seq: PagedSequence, *,
                              chunk_tokens: Optional[int] = None) -> bool:
        if seq.prefill_done:
            return True
        pool = self.pool
        ps = pool.page_size
        if chunk_tokens is not None and (chunk_tokens < ps
                                         or chunk_tokens % ps):
            raise ValueError(
                f"chunk_tokens must be a positive multiple of the page "
                f"size {ps}, got {chunk_tokens}")
        if not seq.prefix_mapped:
            self._map_shared_prefix(seq)    # OutOfPages: seq resumable
            if seq.prefill_done:            # logit-cache fast path
                return True
        p = seq.prompt_len
        o = seq.prefill_pos
        length = p - o if chunk_tokens is None else min(chunk_tokens, p - o)
        final = o + length >= p
        span = (self._sealed_span(p, seq.max_new_tokens) if final
                else (o + length))
        self._grow_pages(seq, pool.pages_for(span))    # OutOfPages: no-op
        dev = self.device
        bt = torch.as_tensor(seq.block_table[None], device=dev)
        try:
            if o == 0 and final:
                # whole prompt in one call (no resident prefix), padded
                # to its page rounding
                pad = pool.pages_for(p) * ps
                toks = np.zeros((1, pad), np.int32)
                toks[0, :p] = seq.prompt
                logits, _ = tf.prefill_paged(
                    self.params, self.cfg, torch.as_tensor(toks, device=dev),
                    self._paged_caches, bt, p - 1)
                self.whole_prompt_prefills += 1
            else:
                # q_offset tail path: positions < o are read back from
                # pages earlier chunks (or a resident shared prefix)
                # already filled; writes below ``insert_from`` go to
                # scratch so a shared boundary page is never touched
                pad = (chunk_tokens if chunk_tokens is not None
                       else pool.pages_for(length) * ps)
                toks = np.zeros((1, pad), np.int32)
                toks[0, :length] = seq.prompt[o:o + length]
                last = (p - 1 - o) if final else (length - 1)
                logits, _ = tf.prefill_paged(
                    self.params, self.cfg, torch.as_tensor(toks, device=dev),
                    self._paged_caches, bt, last, q_offset=o,
                    insert_from=seq.insert_from)
            self.prefill_tokens_computed += int(pad)
            if final:
                row = logits[0, 0].float().cpu().numpy()
                tok = int(self._sample_rows(
                    torch.from_numpy(row)[None], [seq.seed], [p],
                    temps=[seq.temperature])[0])
            elif dev.type == "cuda":
                torch.cuda.synchronize(dev)   # surface a device fault here
        except Exception:
            # the pool may be partly written; the caller still holds (and
            # must release) the sequence — its page list is exact, so
            # release() is a complete rollback
            self._caches_poisoned = True
            raise
        if final:
            self.prefill_tokens_shared += seq.shared_prefix_len
            if self._logit_cache_cap > 0:
                self.logit_cache_misses += 1
                self._logit_cache_put(self._prompt_key(seq.prompt), row)
            self._seal_prefill(seq, tok)
        else:
            seq.prefill_pos = o + length
        return seq.prefill_done

    def prefill_into_pages(self, prompt, *, max_new_tokens: int,
                           seed: Optional[int] = None,
                           temperature: Optional[float] = None,
                           stop_tokens: Sequence[int] = ()) -> PagedSequence:
        """Admit one request in one call: ``begin_prefill`` + the whole
        prompt through ``prefill_chunk``.  The returned sequence can join
        a running decode batch immediately.  Raises ValueError if
        prompt + max_new_tokens exceeds max_len, and OutOfPages when the
        pool cannot hold the request; any failure releases everything
        the admission held."""
        seq = self.begin_prefill(prompt, max_new_tokens=max_new_tokens,
                                 seed=seed, temperature=temperature,
                                 stop_tokens=stop_tokens)
        try:
            while not seq.prefill_done:
                self.prefill_chunk(seq)
        except Exception:
            self.pool.release(seq)  # failed admission must not leak pages
            raise
        return seq

    def decode_step_batch(self, seqs: Sequence[PagedSequence]) -> np.ndarray:
        """One decode step for up to ``decode_batch`` running sequences
        at *different* positions.  Rows beyond len(seqs) are inactive:
        they write to the scratch page and their samples are discarded.
        Advances each sequence in place; returns the sampled tokens
        (len(seqs),)."""
        with self._device_lock:
            return self._decode_step_batch_locked(seqs)

    def _decode_step_batch_locked(self, seqs: Sequence[PagedSequence]
                                  ) -> np.ndarray:
        if self.pool is None:
            raise RuntimeError("no paged KV pool: call init_paged() first")
        cap = self._decode_batch
        if len(seqs) > cap:
            raise ValueError(f"{len(seqs)} sequences > decode_batch={cap}")
        ps = self.pool.page_size
        # lazy decode allocation: a sequence sealed without its whole
        # decode span grows page by page as it advances (a no-op for one
        # that reserved it).  OutOfPages raises before any device work
        # with every page list exact; the starving sequence is tagged so
        # that the scheduler fails it alone.
        for seq in seqs:
            try:
                self._grow_pages(seq, self.pool.pages_for(seq.pos + 1))
            except OutOfPages as exc:
                exc.grow_seq = seq
                raise
        # copy-on-write: a sequence about to insert into a page other
        # sequences still map gets a private copy as part of this step
        # (sharing must never let one request's decode tokens leak into
        # another's prefix).  Pages allocate BEFORE any device work —
        # OutOfPages here leaves the pool intact and only this request
        # need fail — and refcount / block-table bookkeeping waits until
        # the step succeeds.  ``pending`` mirrors the decrefs that
        # bookkeeping will apply, so the second holder of a page the
        # first row is already copying keeps the original page.
        cow: List[Tuple[int, PagedSequence, int, int, int]] = []
        pending: Dict[int, int] = {}
        for i, seq in enumerate(seqs):
            idx = seq.pos // ps
            old = seq.pages[idx]
            if self.pool.refcount(old) - pending.get(old, 0) > 1:
                try:
                    new = self.pool.alloc(1)[0]
                except OutOfPages as exc:
                    # roll back this step's earlier COW allocations
                    self.pool.decref([n for _, _, _, _, n in cow])
                    exc.cow_seq = seq
                    raise
                cow.append((i, seq, idx, old, new))
                pending[old] = pending.get(old, 0) + 1
        # one operand per step (see _paged_step): columns token, pos,
        # the block-table row, and on a COW step src / dst; inactive
        # rows decode token 0 at position 0 into the scratch page
        m = self._max_pages
        packed = np.full((cap, (4 if cow else 2) + m), SCRATCH_PAGE,
                         np.int32)
        packed[:, :2] = 0
        seeds = np.zeros((cap,), np.int64)
        temps: List[Optional[float]] = [None] * cap
        for i, seq in enumerate(seqs):
            packed[i, 0] = seq.last_token
            packed[i, 1] = seq.pos
            packed[i, 2:2 + m] = seq.block_table
            seeds[i] = seq.seed
            temps[i] = seq.temperature
        # COWing rows decode against their private copy: the step copies
        # old -> new across every layer's slabs, then the insert lands in
        # the copy; rows that copy nothing ride scratch -> scratch
        for r, (i, seq, idx, old, new) in enumerate(cow):
            packed[i, 2 + idx] = new
            packed[r, 2 + m:] = (old, new)
        step = self._paged_decode_cow if cow else self._paged_decode
        try:
            logits = step(torch.from_numpy(packed).to(self.device))
            # row i's next token sits at position pos[i] + 1; keying the
            # sample by (seq.seed, position) keeps a sampled generation
            # independent of batch composition
            nxt = self._sample_rows(logits, seeds, packed[:, 1] + 1,
                                    temps=temps)
        except Exception:
            self._caches_poisoned = True
            self.pool.decref([n for _, _, _, _, n in cow])
            raise
        for i, seq, idx, old, new in cow:
            # the copy diverged from the indexed prefix the moment the
            # step inserted, so this sequence stops backing entries for
            # the old page; the remaining holders keep them valid
            seq.prefix_keys = self.pool.disown_prefix(seq.prefix_keys, old)
            self.pool.decref([old])
            seq.pages[idx] = new
            seq.block_table[idx] = new
            self.cow_count += 1
            self.tracer.instant("cow", track=self.trace_track,
                                args={"old": int(old), "new": int(new),
                                      "fused": True})
        for i, seq in enumerate(seqs):
            seq.pos += 1
            seq.last_token = int(nxt[i])
            seq.tokens.append(int(nxt[i]))
            self._reclaim_out_of_span(seq)
        return nxt[:len(seqs)]

    # ---- speculative decoding: verify + draft-page rollback ----------
    def verify_step_batch(self, rows: Sequence[Tuple[PagedSequence,
                                                     Sequence[int]]],
                          *, width: int) -> List[np.ndarray]:
        """Verify up to ``decode_batch`` rows of drafted tokens in one
        multi-token step.  Each row feeds ``[seq.last_token, d_1 ..
        d_k]`` at absolute positions ``seq.pos .. seq.pos + k`` and gets
        back the greedy pick after every fed token: ``out[i][j]`` is the
        token the model emits after the row's context plus drafts
        ``d_1 .. d_j``.  ``width`` fixes the step's shape (width >= k + 1
        for every row; short rows right-pad).

        Sequence state is not advanced: the caller commits what it
        accepts (``spec_decode.SpeculativeBackend``).  K/V written above
        a row's finally committed position is masked by position and
        overwritten before it becomes visible, so the verifier needs no
        rollback; inactive rows write the scratch page."""
        with self._device_lock:
            return self._verify_step_batch_locked(rows, width)

    def _verify_step_batch_locked(self, rows, width: int) -> List[np.ndarray]:
        if self.pool is None:
            raise RuntimeError("no paged KV pool: call init_paged() first")
        cap = self._decode_batch
        if len(rows) > cap:
            raise ValueError(f"{len(rows)} verify rows > "
                             f"decode_batch={cap}")
        for seq, drafts in rows:
            if len(drafts) + 1 > width:
                raise ValueError(f"{len(drafts)} drafts + 1 exceeds the "
                                 f"verify width {width}")
        # one operand (see _verify_step): the fed tokens, q_offset and
        # the block-table row; inactive rows feed token 0 at position 0
        # of a block table of scratch pages
        m = self._max_pages
        packed = np.full((cap, width + 1 + m), SCRATCH_PAGE, np.int32)
        packed[:, :width + 1] = 0
        for i, (seq, drafts) in enumerate(rows):
            packed[i, 0] = seq.last_token
            packed[i, 1:1 + len(drafts)] = drafts
            packed[i, width] = seq.pos
            packed[i, width + 1:] = seq.block_table
        try:
            logits = self._paged_verify(torch.from_numpy(packed).to(
                self.device))
            # greedy only: speculating rows run at temperature <= 0
            picks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        except Exception:
            self._caches_poisoned = True
            raise
        return [picks[i, :len(drafts) + 1]
                for i, (seq, drafts) in enumerate(rows)]

    def rollback_pages(self, seq: PagedSequence, span_tokens: int) -> int:
        """Hand back the pages of ``seq`` past the page covering
        ``span_tokens`` tokens (refcounted decref; their block-table
        slots fall back to scratch).  The speculative drafter calls this
        after a verify round to free what its rejected drafts took; the
        page list stays exact throughout.  Returns the pages freed."""
        keep = self.pool.pages_for(span_tokens)
        freed: List[int] = []
        while len(seq.pages) > keep:
            pg = seq.pages.pop()
            seq.block_table[len(seq.pages)] = SCRATCH_PAGE
            if pg is not None:
                seq.prefix_keys = self.pool.disown_prefix(seq.prefix_keys, pg)
                freed.append(pg)
        if freed:
            self.pool.decref(freed)
        return len(freed)

    def generate_paged(self, prompt, *, max_new_tokens: int,
                       seed: Optional[int] = None,
                       temperature: Optional[float] = None,
                       stop_tokens: Sequence[int] = ()) -> Dict[str, Any]:
        """Single-request convenience over the paged entry points
        (prefill -> solo decode batch -> release pages)."""
        t0 = time.time()
        seq = self.prefill_into_pages(prompt, max_new_tokens=max_new_tokens,
                                      seed=seed, temperature=temperature,
                                      stop_tokens=stop_tokens)
        t1 = time.time()
        try:
            while not seq.done:
                self.decode_step_batch([seq])
            t2 = time.time()
        finally:
            self.pool.release(seq)      # a failed decode must not leak
        prompt_np = np.asarray(prompt, np.int32).reshape((-1,))
        tokens = np.concatenate([prompt_np, np.asarray(seq.tokens, np.int32)])
        return {"tokens": tokens, "prefill_s": t1 - t0, "decode_s": t2 - t1,
                "finish_reason": seq.finish_reason,
                "tokens_per_s": len(seq.tokens) / max(t2 - t1, 1e-9)}
