"""Continuous-batching request scheduler (host side of the serving engine).

A copy of `automodel_tpu/serving/scheduler.py` (host-only), kept here so
the port imports nothing of the JAX package. Lifecycle instants go to the
engine's tracer (`observability/trace.py`; the null tracer when tracing
is off). Speculative decoding, the disaggregated handoff (and its
`handoff_admit` fault probe), failure evacuation and the online frontend's
hooks (cancel, pause, arrival gating off) wait for the slices that port
those tiers.

The engine-loop half of the throughput story (arXiv:2605.25645: the win
over batch-synchronous generate comes from the loop, not just the kernel).
Every engine step the scheduler packs ONE fixed-shape token batch — the
`token_budget` rows the jitted step consumes — from whatever work exists:

- admission by free pages: a waiting request is admitted only when a slot
  is free AND the pool can hold its whole known sequence plus one decode
  page of slack (so a fresh admit never immediately preempts itself);
- decode first: every running request with exactly one pending token (its
  last sampled one) gets a row — decode latency is the SLO currency;
- chunked prefill rides the leftover budget: prompt tokens are fed in
  chunks of at most `prefill_chunk`, interleaved with other requests'
  decode steps instead of head-of-line blocking them;
- preempt-and-requeue on pool exhaustion: when a growing request needs a
  page and none is free, the YOUNGEST running request is preempted
  recompute-style (vLLM's recompute policy): its pages are freed and it
  re-queues at the queue head with `known = prompt + generated so far`, so
  its re-prefill reproduces the exact cache state. Greedy decoding is
  bit-reproducible across preemption; sampled decoding is too, because the
  engine derives each token's key as fold_in(request seed, position).

The unifying invariant: a request is just a `known` token list and a `fed`
counter (tokens whose KV is written). Prefill, decode, and post-preemption
re-prefill are all "feed known[fed:fed+c]"; a step that feeds the LAST
known token samples the next one from its logits. No phase flags.

Prefix sharing (serving/prefix_cache.py, opt-in): admission walks a radix
tree over known tokens at page granularity; matched pages are adopted
straight into the new slot's table and `fed` starts past them, so prefill
begins at the divergence point (a full hit's first step is already a
decode row). Running requests donate each newly COMPLETED full page, so
even concurrent requests share; finished/preempted/expired ones donate on
release. A slot about to append into a still-shared page gets a
copy-on-write replacement (`StepPlan.cow_src/cow_dst` carries the one-page
device copy). Cached-but-unreferenced pages are reclaimed (LRU) strictly
behind the free list, so admission-by-free-pages and preempt-and-requeue
keep working. The radix match also enables the first non-FIFO admission
policy, `admission_policy="prefix-hit"`: when the pool is too tight for
the queue head, prefer the arrived waiter with the highest hit ratio —
it adds decode load with the least prefill work, protecting decode
latency (the SLO currency) while the pool is contended.

The scheduler owns request/page state only; it never touches device
memory — it emits a `StepPlan` of numpy arrays the engine uploads.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from automodel_tpu_torch.observability.trace import NULL_TRACER
from automodel_tpu_torch.serving.kv_pages import PageAllocator, pages_for
from automodel_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    PrefixCacheConfig,
    PrefixMatch,
)


@dataclasses.dataclass
class Request:
    """One generation request. `temperature <= 0` → greedy; sampling keys
    derive from `seed` (per token position, preemption-stable)."""

    prompt: list
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token_id: int | None = None
    seed: int = 0
    arrival: int = 0       # earliest engine step at which it may be admitted
    # graceful degradation under overload: a request not finished by engine
    # step `deadline` is EVICTED (pages freed, finish_reason "timed_out")
    # instead of occupying pool pages forever; None → no deadline
    deadline: int | None = None
    rid: int = -1          # set by the scheduler (submission order)

    # runtime state (scheduler-owned)
    generated: list = dataclasses.field(default_factory=list)
    fed: int = 0           # tokens of `known` whose KV is written
    preemptions: int = 0
    admitted_at: int = -1
    finished_at: int = -1
    finish_reason: str | None = None
    prefix_hit_tokens: int = 0  # prefill tokens skipped via the radix cache
    donated_pages: int = 0      # full pages already offered to the tree
    # wall-clock latency stamps (serve-loop-owned — the loop is the only
    # layer that knows when a step's arrival window actually opened):
    # ttft_s stays -1 for requests that never committed a token
    arrived_t: float = -1.0     # wall time the request became servable
    ttft_s: float = -1.0        # time to first committed token (seconds)

    @property
    def known(self) -> list:
        return self.prompt + self.generated

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class StepPlan:
    """One fixed-shape engine-step input batch (numpy; engine uploads)."""

    tok: np.ndarray          # (T,) int32 token ids (0 on pad rows)
    slot: np.ndarray         # (T,) int32 owning slot, -1 pad
    pos: np.ndarray          # (T,) int32 sequence position, -1 pad
    page: np.ndarray         # (T,) int32 destination page (trash for pads)
    off: np.ndarray          # (T,) int32 destination in-page offset
    page_tables: np.ndarray  # (S, P) int32, padded entries → trash page
    sample_tok: np.ndarray   # (S,) int32 row to sample from, -1 = no sample
    temp: np.ndarray         # (S,) float32 per-slot temperature
    seed: np.ndarray         # (S,) int32 per-slot base seed
    # copy-on-write page copies (≤ 1 per slot per step; trash→trash = no-op)
    cow_src: np.ndarray = None  # (S,) int32 source page
    cow_dst: np.ndarray = None  # (S,) int32 destination page
    scheduled: list = dataclasses.field(default_factory=list)
    # scheduled: [(slot, n_tokens, samples: bool)] — host bookkeeping

    @property
    def n_tokens(self) -> int:
        return sum(c for _, c, _ in self.scheduled)

    @property
    def n_samples(self) -> int:
        return sum(1 for *_, s in self.scheduled if s)


class Scheduler:
    """Continuous-batching scheduler over `max_slots` engine slots."""

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int,
        max_slots: int,
        pages_per_slot: int,
        token_budget: int,
        prefill_chunk: int | None = None,
        prefix_cache: PrefixCacheConfig | None = None,
        admission_policy: str = "fifo",
        alloc: PageAllocator | None = None,
        prefix: PrefixCache | None = None,
        tracer=None,             # observability.trace.Tracer (None → no-op)
        track: str = "engine",
    ):
        # lifecycle tracing (observability/trace.py): the null tracer makes
        # every emit a constant-time no-op, so the untraced hot path is
        # unchanged. `track` names this scheduler's engine in the exported
        # timeline (replica0 / prefill1 / decode0 / ...).
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.track = track
        # `alloc`/`prefix` injection is the ENGINE-LIFETIME cache hook:
        # ServingEngine owns one allocator + radix tree and threads them
        # through every scheduler it makes, so cached pages survive across
        # serve_batch calls. Standalone construction (tests, one-shot runs)
        # keeps building a private pair — per-call semantics unchanged.
        self.alloc = (
            alloc if alloc is not None else PageAllocator(num_pages, page_size)
        )
        self.page_size = page_size
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk or token_budget
        self.trash_page = num_pages  # pool arrays carry num_pages + 1 pages
        if admission_policy not in ("fifo", "prefix-hit"):
            raise ValueError(f"unknown admission_policy {admission_policy!r}")
        if admission_policy == "prefix-hit" and not (
            prefix_cache and prefix_cache.enabled
        ):
            raise ValueError("admission_policy='prefix-hit' needs the prefix cache")
        self.admission_policy = admission_policy
        if prefix is not None:
            self.prefix: PrefixCache | None = prefix
        else:
            self.prefix = (
                PrefixCache(self.alloc, page_size, prefix_cache)
                if prefix_cache is not None and prefix_cache.enabled
                else None
            )
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}   # slot → request
        self._admit_order: list[int] = []       # slots, oldest admit first
        self.finished: list[Request] = []
        self._next_rid = 0
        self.n_preemptions = 0
        self.n_timed_out = 0
        self.n_cow = 0
        self.n_prefix_hits = 0        # admissions that adopted cached pages
        self.prefill_skipped = 0      # prompt tokens never re-prefilled

    # -- request lifecycle --------------------------------------------------
    def submit(self, req: Request) -> None:
        # hard errors, not asserts: these guard user input and must survive
        # python -O (a request that slips through can stall the serve loop)
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        total = len(req.prompt) + req.max_new_tokens
        max_tokens = self.pages_per_slot * self.page_size
        if total > max_tokens:
            raise ValueError(
                f"request needs {total} positions > pages_per_slot*page_size"
                f" = {max_tokens}"
            )
        if pages_for(total, self.page_size) > self.alloc.num_pages:
            raise ValueError(
                f"request needs {pages_for(total, self.page_size)} pages but "
                f"the whole pool holds {self.alloc.num_pages} — it could "
                "never finish even alone"
            )
        if req.rid < 0:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.waiting.append(req)
        self.tracer.instant(
            "request.submit", track=self.track, rid=req.rid,
            prompt_len=len(req.prompt), max_new=req.max_new_tokens,
        )

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _match(self, req: Request) -> PrefixMatch:
        if self.prefix is None:
            return PrefixMatch(pages=[], fed=0, matched_tokens=0,
                               cow_pending=False)
        return self.prefix.lookup(req.known)

    def _need(self, req: Request, match: PrefixMatch) -> int:
        """Pages a fresh admit must still find: whole known sequence + 1
        decode page of slack, minus adopted pages, plus one for the pending
        copy-on-write split when the first write lands in a shared page."""
        return (
            pages_for(len(req.known) + 1, self.page_size)
            - len(match.pages)
            + (1 if match.cow_pending else 0)
        )

    def _admit(self, step_idx: int) -> None:
        while self.waiting and len(self.running) < self.max_slots:
            picked = self._pick_admission(step_idx)
            if picked is None:
                break
            i, req, match = picked
            del self.waiting[i]
            slot = next(
                s for s in range(self.max_slots) if s not in self.running
            )
            self.running[slot] = req
            self._admit_order.append(slot)
            if req.admitted_at < 0:
                req.admitted_at = step_idx
            if match.pages:
                # radix hit: the matched prefix's pages go straight into the
                # slot's table and `fed` advances past them — prefill starts
                # at the divergence point (full hit → first step is decode)
                self.alloc.adopt(slot, match.pages)
                req.fed = match.fed
                req.prefix_hit_tokens += match.fed
                req.donated_pages = (
                    len(match.pages) - (1 if match.cow_pending else 0)
                )
                self.prefill_skipped += match.fed
                self.n_prefix_hits += 1
            self.tracer.instant(
                "request.admit", track=self.track, step=step_idx,
                rid=req.rid, slot=slot, prefix_fed=match.fed,
            )
        # FIFO admission (default): if the head doesn't fit, nothing behind
        # it jumps the queue (no starvation of long prompts). Under
        # "prefix-hit", a tight pool admits the best-hit-ratio waiter
        # instead — the head stays at the front and still goes first the
        # moment it fits.

    def _admissible(self, req: Request, avail: int) -> PrefixMatch | None:
        """The match to admit `req` with, or None if it cannot fit. Adopting
        a tree-only page PINS it — it stops counting as reclaimable — so the
        radix hit only stands when `need` fits what would remain available
        after adoption. When the warm admit does not fit but a cold one
        would (the tree itself is hogging the pool), fall back to a cold
        admission: the un-adopted cached pages stay evictable and the
        pressure ladder reclaims them during prefill."""
        match = self._match(req)
        if match.pages:
            pinned = sum(
                1 for p in match.pages if self.alloc.refcount(p) == 1
            )
            if self._need(req, match) + pinned <= avail:
                return match
            match = PrefixMatch(pages=[], fed=0, matched_tokens=0,
                                cow_pending=False)
        if self._need(req, match) <= avail:
            return match
        return None

    def _pick_admission(self, step_idx: int):
        """Choose the next waiter: queue index, request, radix match.
        FIFO fast path: the head, whenever it fits. The prefix-hit scan
        below only runs while the pool is too tight for the head, so its
        per-waiter radix walks stay off the uncontended hot path."""
        avail = self.alloc.num_free + (
            self.prefix.reclaimable() if self.prefix else 0
        )
        head = self.waiting[0]
        if head.arrival <= step_idx:
            match = self._admissible(head, avail)
            if match is not None:
                return 0, head, match
        if self.admission_policy == "fifo":
            return None
        # pool too tight for the head (or head not arrived): prefer the
        # arrived waiter with the highest hit ratio among those that fit
        best = None
        for i, req in enumerate(self.waiting):
            if req.arrival > step_idx:
                continue
            match = self._admissible(req, avail)
            if match is None:
                continue
            ratio = match.fed / max(len(req.known), 1)
            key = (ratio, -i)  # tie → submission order
            if best is None or key > best[0]:
                best = (key, i, req, match)
        return best[1:] if best is not None else None

    def _donate(self, slot: int) -> None:
        """Offer a slot's newly completed full pages to the radix tree (the
        tree takes its own allocator reference, so the pages survive the
        slot). Runs after every feed and on release — content below `fed`
        is immutable, so a donated page can never change under the tree."""
        if self.prefix is None:
            return
        req = self.running[slot]
        full = req.fed // self.page_size
        if full <= req.donated_pages:
            return
        self.prefix.insert(
            req.known[: full * self.page_size],
            self.alloc.table(slot)[:full],
        )
        req.donated_pages = full

    def _release_slot(self, slot: int, donate: bool = True) -> Request:
        """Remove a running request from its slot: donate its full pages to
        the prefix tree (completion, preemption, and deadline eviction all
        seed future hits), then drop the slot's references — shared pages
        live on, exclusive ones return to the free list."""
        if donate:
            self._donate(slot)
        req = self.running.pop(slot)
        self._admit_order.remove(slot)
        self.alloc.free_slot(slot)
        return req

    def _preempt_youngest(self, protected) -> bool:
        """Free the youngest running request whose slot is not `protected`
        (the requester and every slot with rows already planned this step —
        their pages must not be recycled mid-step); requeue it at the queue
        head, recompute-style. Returns False if no victim. With the prefix
        cache on, the victim's full pages were donated — its requeued
        "re-prefill" is mostly a radix hit that re-adopts its own pages."""
        for slot in reversed(self._admit_order):
            if slot in protected:
                continue
            victim = self._release_slot(slot)
            victim.fed = 0
            victim.donated_pages = 0
            victim.preemptions += 1
            self.n_preemptions += 1
            self.waiting.appendleft(victim)
            self.tracer.instant(
                "request.preempt", track=self.track, rid=victim.rid,
                preemptions=victim.preemptions,
            )
            return True
        return False

    def _reclaim(self, n: int) -> int:
        """Allocator reclaim hook: cached pages, strictly behind free ones."""
        return self.prefix.reclaim(n) if self.prefix is not None else 0

    def _ensure(self, slot: int, num_tokens: int, protected) -> bool:
        """ensure() + the pool-pressure ladder: free list first, then evict
        cached-but-unreferenced prefix pages (LRU), then preempt-and-requeue
        the youngest unprotected request. False → stall this slot a step."""
        while not self.alloc.ensure(slot, num_tokens, reclaim=self._reclaim):
            if not self._preempt_youngest(protected):
                return False
        return True

    def _free_page_for_cow(self, protected) -> bool:
        """One free page for a copy-on-write split, same pressure ladder."""
        while not (self.alloc.num_free >= 1 or self._reclaim(1) >= 1):
            if not self._preempt_youngest(protected):
                return False
        return True

    def _expire_deadlines(self, step_idx: int) -> None:
        """Evict requests whose deadline has passed — running requests free
        their slot and pages (relieving pool pressure under overload),
        waiting ones just leave the queue. Runs BETWEEN engine steps (at the
        top of schedule()), so no mid-step plan ever references recycled
        pages. The partial generation stays on the Request."""
        for slot, req in list(self.running.items()):
            if req.deadline is not None and step_idx >= req.deadline:
                req.finish_reason = "timed_out"
                req.finished_at = step_idx
                self.finished.append(req)
                self._release_slot(slot)
                self.n_timed_out += 1
                self.tracer.instant(
                    "request.expire", track=self.track, step=step_idx,
                    rid=req.rid, resident=1,
                )
        expired = [
            r for r in self.waiting
            if r.deadline is not None and step_idx >= r.deadline
        ]
        for req in expired:
            self.waiting.remove(req)
            req.finish_reason = "timed_out"
            req.finished_at = step_idx
            self.finished.append(req)
            self.n_timed_out += 1
            self.tracer.instant(
                "request.expire", track=self.track, step=step_idx,
                rid=req.rid, resident=0,
            )

    @property
    def next_deadline(self) -> int | None:
        """Earliest pending deadline across running+waiting (None if none) —
        lets the serve loop distinguish 'stalled forever' from 'stalled
        until an eviction frees pages'."""
        ds = [
            r.deadline
            for r in list(self.running.values()) + list(self.waiting)
            if r.deadline is not None
        ]
        return min(ds) if ds else None

    # -- step planning ------------------------------------------------------
    def schedule(self, step_idx: int) -> StepPlan | None:
        """Build the next step's token batch, or None when nothing runs this
        step (queue empty or all arrivals in the future)."""
        self._expire_deadlines(step_idx)
        self._admit(step_idx)
        T, S, P = self.token_budget, self.max_slots, self.pages_per_slot
        plan = StepPlan(
            tok=np.zeros(T, np.int32),
            slot=np.full(T, -1, np.int32),
            pos=np.full(T, -1, np.int32),
            page=np.full(T, self.trash_page, np.int32),
            off=np.zeros(T, np.int32),
            page_tables=np.full((S, P), self.trash_page, np.int32),
            sample_tok=np.full(S, -1, np.int32),
            temp=np.zeros(S, np.float32),
            seed=np.zeros(S, np.int32),
            cow_src=np.full(S, self.trash_page, np.int32),
            cow_dst=np.full(S, self.trash_page, np.int32),
        )
        row = 0
        planned = set()
        # decode rows first (pending == 1), then prefill chunks; within each
        # class oldest admit first
        order = list(self._admit_order)
        decode = [s for s in order if len(self.running[s].known) - self.running[s].fed == 1]
        prefill = [s for s in order if s not in decode]
        for slot in decode + prefill:
            req = self.running.get(slot)
            if req is None or row >= T:
                continue
            pending = len(req.known) - req.fed
            c = min(pending, T - row, self.prefill_chunk)
            if c <= 0:
                continue
            # pool exhausted → the pressure ladder (reclaim cached pages,
            # then preempt-and-requeue); stall this slot a step if dry
            if not self._ensure(slot, req.fed + c, planned | {slot}):
                continue
            # copy-on-write on divergence: the first write of this chunk
            # lands in a page another table or the radix tree still reads —
            # give the slot a private copy (one-page device copy in-plan)
            first_page = req.fed // self.page_size
            if self.alloc.refcount(self.alloc.table(slot)[first_page]) > 1:
                if not self._free_page_for_cow(planned | {slot}):
                    continue
                pair = self.alloc.cow(slot, first_page)
                if pair is not None:  # the ladder may have dropped the share
                    plan.cow_src[slot], plan.cow_dst[slot] = pair
                    self.n_cow += 1
            planned.add(slot)
            samples = req.fed + c == len(req.known)
            table = self.alloc.table(slot)
            for j in range(c):
                p = req.fed + j
                plan.tok[row + j] = req.known[p]
                plan.slot[row + j] = slot
                plan.pos[row + j] = p
                plan.page[row + j] = table[p // self.page_size]
                plan.off[row + j] = p % self.page_size
            if samples:
                plan.sample_tok[slot] = row + c - 1
            plan.temp[slot] = req.temperature
            plan.seed[slot] = req.seed
            plan.scheduled.append((slot, c, samples))
            row += c
        for slot, req in self.running.items():
            t = self.alloc.table(slot)
            plan.page_tables[slot, : len(t)] = t
        if not plan.scheduled:
            return None
        return plan

    def update(self, plan: StepPlan, sampled: np.ndarray, step_idx: int) -> int:
        """Absorb one engine step's sampled tokens; finish/free requests.
        Returns the number of tokens committed this step (the number of
        sampling slots)."""
        sampled = np.asarray(sampled)
        committed_total = 0
        for slot, c, samples in plan.scheduled:
            req = self.running[slot]
            req.fed += c
            if samples:
                tok = int(sampled[slot])
                req.generated.append(tok)
                committed_total += 1
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    req.finish_reason = "eos"
                elif len(req.generated) >= req.max_new_tokens:
                    req.finish_reason = "length"
                if len(req.generated) == 1:
                    self.tracer.instant(
                        "request.first_token", track=self.track,
                        step=step_idx, rid=req.rid,
                    )
                self.tracer.instant(
                    "request.commit", track=self.track, step=step_idx,
                    rid=req.rid, n=1,
                )
            if req.done:
                req.finished_at = step_idx
                self.finished.append(req)
                self._release_slot(slot)
                self.tracer.instant(
                    "request.done", track=self.track, step=step_idx,
                    rid=req.rid, reason=req.finish_reason,
                    n_generated=len(req.generated),
                )
                continue
            # donate every newly completed full page while still running, so
            # CONCURRENT requests with the same prefix share immediately
            self._donate(slot)
        return committed_total
