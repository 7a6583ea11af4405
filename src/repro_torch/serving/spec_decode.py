"""Speculative multiplexed decoding: the mux zoo as its own drafter.

Port of ``repro.serving.spec_decode``, trimmed to what the port calls
(the in-process target; the disaggregated and remote backends are not
ported).  ``SpeculativeBackend`` wraps a *target* backend (the large
model the request was admitted to) together with a *draft* ``Engine``
(the mux-selected small model) and turns every decode sweep into a
DRAFT -> VERIFY pair:

  DRAFT   the draft engine greedily decodes ``k`` tokens ahead for every
          speculating row into its own paged cache (lazy page
          allocation, page by page)
  VERIFY  the target engine scores all ``k`` drafts in one batched
          multi-token step (``Engine.verify_step_batch``: the tail-
          prefill path at per-row absolute positions, a CUDA graph on
          the card) and the longest draft prefix matching the target's
          own greedy picks commits, plus the target's pick at the first
          divergence

Rows speculate only at temperature <= 0 and verification takes the
target's argmax after every fed position, so the committed stream is
the target's greedy stream.  (On the card the verify step's attention
is the gathered fp32-score tail and plain decode's is the paged kernel:
the two can split a near-tie of the top two logits.)  Whatever breaks
the happy path degrades to plain decode, never to wrong tokens:

  * draft length: ``k_fn(prompt)`` (the probe score mapping) gives the
    request's draft length, clamped to ``[0, draft_k]``; k = 0 never
    drafts
  * acceptance EMA: when a request's acceptance moving average falls
    under ``ema_floor`` it decodes plain from then on
    (``spec_fallbacks`` counts these)
  * shared pages: a row whose verify span touches a page other
    sequences still map decodes plain this sweep (plain decode owns the
    fused copy-on-write; verify must never write a shared page)
  * draft-engine failure: OutOfPages falls back per request; any other
    draft failure turns speculation off for the whole backend, whose
    target is untouched and keeps serving plain

Draft-side pages are the only speculative allocation (the target seals
its whole prompt + decode span at admission), and they roll back after
every verify through ``Engine.rollback_pages``: the draft sequence's
page list is exact at every step, so releasing it at any point leaks
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.backend import (ModelBackend, _engine_warmup,
                                         _ExecutorMixin)
from repro_torch.serving.kv_cache import OutOfPages
from repro_torch.serving.observability.tracer import backend_track


@dataclasses.dataclass
class _SpecState:
    """Per-request speculation state beside the target sequence.
    ``dseq`` is the draft engine's sequence: its ``pos`` is kept in
    target coordinates (the draft's "prompt" is the target's prompt
    plus every committed token, so absolute positions line up), and its
    page list is exact at all times."""
    k: int                        # draft length (mux-score assigned)
    dseq: Any = None              # draft PagedSequence (spawned lazily)
    ema: float = 1.0              # acceptance-rate moving average
    fallback: bool = False        # back to plain decode for good
    draft_tokens: int = 0
    accepted_tokens: int = 0


class SpeculativeBackend(_ExecutorMixin, ModelBackend):
    """DRAFT -> VERIFY decode over a target backend and a draft engine.

    ``target`` must expose a verify surface (``verify_engine``):
    ``InProcessBackend`` does.  The draft engine should be built with
    ``lazy_decode_alloc=True`` (pages allocate as drafting advances, so
    rejected drafts have something to roll back) and
    ``span_reclaim=False`` (rollback and span reclaim must not fight
    over the page list)."""

    def __init__(self, target: ModelBackend, draft_engine, *,
                 draft_k: int = 4,
                 k_fn: Optional[Callable[[np.ndarray], int]] = None,
                 ema_alpha: float = 0.4, ema_floor: float = 0.35,
                 name: Optional[str] = None):
        engine = getattr(target, "verify_engine", None)
        if engine is None:
            raise ValueError(
                f"backend {target.name!r} has no verify surface "
                f"(verify_engine): wrap an InProcessBackend")
        if draft_engine.pool is None:
            raise ValueError("the draft engine needs a paged pool: call "
                             "Engine.init_paged first")
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if draft_engine.decode_batch < engine.decode_batch:
            raise ValueError(
                f"draft decode_batch {draft_engine.decode_batch} < target "
                f"decode_batch {engine.decode_batch}: every spec row must "
                f"fit one draft decode call")
        # drafting runs dseq.pos up to seq.pos + k, and seq.pos tops out
        # at the target's max_len - 1: the draft cache must cover that
        need = engine.scfg.max_len + draft_k
        if draft_engine.scfg.max_len < need:
            raise ValueError(
                f"draft max_len {draft_engine.scfg.max_len} < target "
                f"max_len + draft_k = {need}: drafts would run off the "
                f"draft engine's block table")
        self.target = target
        self.draft = draft_engine
        self.engine = engine                  # the verify (target) engine
        self._verify_exec = getattr(target, "verify_executor", "device")
        self.draft_k = draft_k
        self.k_fn = k_fn
        self.ema_alpha = float(ema_alpha)
        self.ema_floor = float(ema_floor)
        self._width = draft_k + 1             # the one verify shape
        self.name = name or f"spec:{target.name}"
        self._states: Dict[int, _SpecState] = {}
        self._spec_dead = False               # draft engine failed hard
        self.draft_tokens = 0
        self.accepted_tokens = 0
        self.spec_fallbacks = 0
        self.verify_rounds = 0
        self._init_executors(["draft"])

    # ---- lifecycle / plumbing (delegate to the target) ----------------
    @property
    def concurrent_prefill(self) -> bool:          # type: ignore[override]
        return bool(self.target.concurrent_prefill)

    async def start(self) -> None:
        await _ExecutorMixin.start(self)
        await self.target.start()

    async def stop(self) -> None:
        await self.target.stop()
        await _ExecutorMixin.stop(self)

    def bind_metrics(self, metrics, model_id: int) -> None:
        super().bind_metrics(metrics, model_id)
        self.target.bind_metrics(metrics, model_id)

    def bind_tracer(self, tracer) -> None:
        super().bind_tracer(tracer)
        self.target.bind_tracer(tracer)
        self.draft.tracer = tracer
        self.draft.trace_track = backend_track(self.name, "draft_engine")
        self.draft.pool.tracer = tracer
        self.draft.pool.trace_track = backend_track(self.name, "draft_pool")

    # ---- pass-through surface -----------------------------------------
    def begin(self, prompt, *, max_new_tokens, seed=None, temperature=None,
              stop_tokens=()):
        return self.target.begin(prompt, max_new_tokens=max_new_tokens,
                                 seed=seed, temperature=temperature,
                                 stop_tokens=stop_tokens)

    async def prefill_chunk(self, seq, *, chunk_tokens=None) -> bool:
        return await self.target.prefill_chunk(seq,
                                               chunk_tokens=chunk_tokens)

    async def probe(self, prompt):
        return await self.target.probe(prompt)

    def release(self, seq) -> None:
        st = self._states.pop(id(seq), None)
        if st is not None and st.dseq is not None:
            self.draft.pool.release(st.dseq)
            st.dseq = None
        self.target.release(seq)

    def capacity(self):
        return self.target.capacity()

    def admission_cost(self, prompt, max_new_tokens, *, chunk_tokens=None):
        return self.target.admission_cost(prompt, max_new_tokens,
                                          chunk_tokens=chunk_tokens)

    def admissible(self, prompt, max_new_tokens, *, chunk_tokens=None):
        return self.target.admissible(prompt, max_new_tokens,
                                      chunk_tokens=chunk_tokens)

    def fits_ever(self, prompt_len, max_new_tokens):
        return self.target.fits_ever(prompt_len, max_new_tokens)

    @property
    def healthy(self) -> bool:
        # a dead draft engine only turns speculation off; the backend
        # keeps serving plain decode off the (healthy) target
        return self.target.healthy

    def warmup(self, prompt_lens, chunk_tokens=None) -> None:
        """The target's and the draft engine's warmups (on the card each
        captures its paged decode steps first), then the verify step,
        captured at its one serving shape (decode_batch, draft_k + 1) on
        scratch-only inputs, where the reference compiles it."""
        self.target.warmup(prompt_lens, chunk_tokens=chunk_tokens)
        _engine_warmup(self.draft, prompt_lens, None)
        self.engine.capture_verify_step(self._width)

    def stats(self) -> Dict[str, Any]:
        s = dict(self.target.stats())
        s.update({
            "name": self.name,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "spec_fallbacks": self.spec_fallbacks,
            "verify_rounds": self.verify_rounds,
            "draft_pool": self.draft.pool.stats(),
        })
        return s

    # ---- eligibility ---------------------------------------------------
    def _state_for(self, seq) -> _SpecState:
        st = self._states.get(id(seq))
        if st is None:
            k = self.draft_k if self.k_fn is None else int(
                self.k_fn(seq.prompt))
            k = max(0, min(k, self.draft_k))
            st = _SpecState(k=k)
            if k == 0:              # hard input: never drafts at all
                st.fallback = True
            self._states[id(seq)] = st
        return st

    def _greedy(self, seq) -> bool:
        t = (self.engine.scfg.temperature if seq.temperature is None
             else seq.temperature)
        return t <= 0.0

    def _cow_safe(self, seq) -> bool:
        """Verify writes target K/V at positions pos .. pos + width - 1;
        every page under that span must be this sequence's alone."""
        pool, ps = self.engine.pool, self.engine.pool.page_size
        lo = seq.pos // ps
        hi = min((seq.pos + self._width - 1) // ps, len(seq.pages) - 1)
        for idx in range(lo, hi + 1):
            pg = seq.pages[idx]
            if pg is not None and pool.refcount(pg) > 1:
                return False
        return True

    # ---- DRAFT phase (runs on the draft executor thread) ---------------
    def _spawn_draft(self, seq):
        """Prefill the draft cache with everything the target has
        committed: the prompt and the generated tokens up to (not
        including) the target's ``last_token``, whose K/V the next feed
        inserts, so ``dseq.pos`` lands at ``seq.pos``."""
        toks = np.asarray(seq.prompt, np.int32).reshape((-1,))
        if len(seq.tokens) > 1:
            toks = np.concatenate(
                [toks, np.asarray(seq.tokens[:-1], np.int32)])
        dseq = self.draft.prefill_into_pages(
            toks, max_new_tokens=4 * self._width + 8, temperature=0.0)
        dseq.tokens = [int(seq.last_token)]
        dseq.last_token = int(seq.last_token)
        return dseq

    def _draft_phase(self, rows: List[Tuple[Any, _SpecState]]
                     ) -> List[Tuple[Any, _SpecState, List[int]]]:
        """Catch the draft cache up to the target, then greedily draft
        ``st.k`` tokens a row in batched rounds.  OutOfPages anywhere
        stops drafting for the sweep (rows keep what they drafted; empty
        rows decode plain); page lists stay exact throughout."""
        live: List[Tuple[Any, _SpecState]] = []
        for seq, st in rows:
            try:
                if st.dseq is None:
                    st.dseq = self._spawn_draft(seq)
                elif seq.pos - st.dseq.pos > self._width:
                    # the row decoded plain for a while (COW routing):
                    # re-prefilling is cheaper than replaying the gap
                    self.draft.pool.release(st.dseq)
                    st.dseq = None
                    st.dseq = self._spawn_draft(seq)
            except (OutOfPages, ValueError):
                self._fall_back(seq, st)    # draft pool / capacity: plain
                continue
            live.append((seq, st))
        drafts: Dict[int, List[int]] = {id(seq): [] for seq, _ in live}
        try:
            # catch-up: replay committed tokens the draft cache lacks (at
            # most ``width`` a row, usually the one-token backlog a fully
            # accepted round leaves); the sampled token is dropped, only
            # the K/V insert matters
            while True:
                lag = [(seq, st) for seq, st in live
                       if st.dseq.pos < seq.pos]
                if not lag:
                    break
                for seq, st in lag:
                    st.dseq.last_token = int(
                        seq.tokens[st.dseq.pos - seq.prompt_len])
                self.draft.decode_step_batch([st.dseq for _, st in lag])
                for seq, st in lag:
                    st.dseq.tokens.pop()
                    if st.dseq.pos == seq.pos:
                        st.dseq.last_token = int(seq.last_token)
                        st.dseq.tokens = [int(seq.last_token)]
            # draft rounds: one greedy token a round for every row still
            # drafting (rows with a smaller k drop out early)
            for r in range(max((st.k for _, st in live), default=0)):
                batch = [(seq, st) for seq, st in live if st.k > r]
                if not batch:
                    break
                out = self.draft.decode_step_batch(
                    [st.dseq for _, st in batch])
                for (seq, st), tok in zip(batch, out):
                    drafts[id(seq)].append(int(tok))
        except OutOfPages:
            pass        # backpressure: verify what we have, retry later
        return [(seq, st, drafts[id(seq)]) for seq, st in live]

    # ---- commit / reconcile (host side) --------------------------------
    def _fall_back(self, seq, st: _SpecState) -> None:
        if st.fallback:
            return
        st.fallback = True
        self.spec_fallbacks += 1
        if st.dseq is not None:
            self.draft.pool.release(st.dseq)
            st.dseq = None
        tracer = self._tracer
        if tracer.enabled:
            tracer.instant("spec_fallback",
                           args={"rid": getattr(seq, "trace_rid", None),
                                 "ema": round(st.ema, 3)})

    def _commit_row(self, seq, st: _SpecState, drafts: List[int],
                    picks: np.ndarray) -> int:
        """Commit the verified prefix and the target's pick after it onto
        the target sequence (token by token, honouring stop tokens and
        the budget as plain decode would), then reconcile the draft
        cache and roll its rejected-draft pages back.  Returns the
        accepted draft count."""
        a = 0
        while a < len(drafts) and drafts[a] == int(picks[a]):
            a += 1
        commit = drafts[:a] + [int(picks[a])]
        old_pos = seq.pos
        for t in commit:
            seq.tokens.append(int(t))
            seq.pos += 1
            seq.last_token = int(t)
            if (int(t) in seq.stop_tokens
                    or len(seq.tokens) >= seq.max_new_tokens):
                break
        k = len(drafts)
        st.draft_tokens += k
        st.accepted_tokens += a
        self.draft_tokens += k
        self.accepted_tokens += a
        st.ema = ((1.0 - self.ema_alpha) * st.ema
                  + self.ema_alpha * (a / k))
        # reconcile: the draft K/V matches the committed stream up to
        # old_pos + min(a + 1, k) (a rejected draft's insert spoiled the
        # next slot; the k-th draft was never inserted), so the draft
        # position is that bound or the target's new position, whichever
        # comes first; a remaining gap (<= 1 token) replays as catch-up
        # next sweep.  Rejected-draft pages roll back now.
        dseq = st.dseq
        d = min(seq.pos, old_pos + min(a + 1, k))
        j = d - old_pos
        dseq.pos = d
        dseq.last_token = int(commit[j - 1]) if j else int(seq.tokens[
            old_pos - seq.prompt_len])
        dseq.tokens = [dseq.last_token]
        self.draft.rollback_pages(dseq, d + 1)
        if st.ema < self.ema_floor:
            self._fall_back(seq, st)    # drafting stopped paying
        return a

    # ---- the decode sweep ----------------------------------------------
    async def decode_batch(self, seqs: Sequence) -> np.ndarray:
        spec: List[Tuple[Any, _SpecState]] = []
        plain: List[Any] = []
        for seq in seqs:
            st = self._state_for(seq)
            if (not self._spec_dead and not st.fallback
                    and self._greedy(seq) and self._cow_safe(seq)):
                spec.append((seq, st))
            else:
                plain.append(seq)
        rows: List[Tuple[Any, _SpecState, List[int]]] = []
        if spec:
            try:
                rows = await self._run("draft", self._draft_phase, spec,
                                       op="DRAFT")
            except Exception:
                # the draft engine died mid-flight: speculation off for
                # good, everything served plain; the target is untouched,
                # so no request fails over a drafter fault
                self._spec_dead = True
                for seq, st in spec:
                    self._fall_back(seq, st)
                rows = []
        verify = [(seq, st, dr) for seq, st, dr in rows if dr]
        plain.extend(seq for seq, st, dr in rows if not dr)
        if verify:
            vrows = [(seq, dr) for seq, _, dr in verify]
            picks = await self.target._run(
                self._verify_exec,
                lambda: self.engine.verify_step_batch(vrows,
                                                      width=self._width),
                op="VERIFY")
            self.verify_rounds += 1
            drafted = accepted = 0
            for (seq, st, dr), pk in zip(verify, picks):
                accepted += self._commit_row(seq, st, dr, pk)
                drafted += len(dr)
            tracer = self._tracer
            if tracer.enabled and drafted:
                tracer.counter("accept_rate",
                               {"rate": accepted / drafted})
        if plain:
            await self.target.decode_batch(plain)
        return np.asarray([int(seq.tokens[-1]) for seq in seqs], np.int32)
