"""Continuous-batching serving engine: a dense slot pool or a shared KV
page pool.

Port of ``repro/serving/engine.py``.  One engine wraps one model replica
on one device and serves admitted requests with one of two memory models:

**Dense slot pool** (recurrent, windowed, int8-cache and vision
configs).  A fixed pool of ``kv_slots`` per-request states (K/V rings
``max_len`` deep, or at most the window, and RG-LRU or xLSTM states).
Each step runs one batch-1 prefill per joining request (a vision
request's patches go in front of its prompt), then one batched decode
round over every slot, each slot at its own position; free slots ride
along and their outputs are dropped.

Audio configs (``num_codebooks`` K) take (1, K, S) prompts and emit one
(1, K) token row per step.

**Paged page pool** (all-attention configs; picked by
``paged_supported``).  KV memory is a shared pool of fixed-size pages per
layer; each request holds only the pages its prompt plus generation
need, named by a per-request block table.  Admission is gated on free
pages and a free lane (up to ``max_lanes``); prefill is chunked, one
``prefill_chunk``-token chunk per prefilling lane per step, followed by
one decode round across the lanes that finished prefilling.  Completed
prompt blocks stay in a prefix cache, shared by refcount with later
prompts whose token-block chain matches; a lane that diverges mid-block
forks the cached page copy-on-write.

Stepping is split into :meth:`dispatch`, which admits, enqueues this
step's prefill chunks and decode round on the device and returns without
waiting for it, and :meth:`collect`, which makes one device-to-host
transfer and finalizes requests.  ``step() == dispatch(); collect()``.
Dispatch moves host data to the device through pinned buffers with
``non_blocking=True``, so it never waits for queued device work; tokens
that feed the next round stay on the device.

**Sharded engines.**  With ``mesh=`` (``launch.mesh.make_smoke_mesh()``
for one card, ``make_production_mesh()`` with one process per rank) the
engine holds this rank's block of every weight
(``launch.sharding.place_params``: tensor-parallel on "model", FSDP on
"data", the MoE experts' hoisted blocks) and runs every step inside the
mesh's ``ShardingContext``.  Every rank runs the same engine on the same
requests and keeps the same host books.  A dense slot pool is cut
(``launch.sharding.place_states``): slots over "data", each K/V ring's
positions over "model"; a prefill runs on every rank and only the rank
holding the slot keeps it (its slice of the rings), and a decode round
computes each rank's own slots, its tokens all-gathered over "data".  A
page pool stays whole on every rank, every lane on every rank (the
reference cuts its pages over "data").  :meth:`placement_report` names
the layout each layer used.

Health (``repro_torch.faults``): :meth:`fail` crashes the engine (DOWN:
queued and in-flight requests are orphaned, an uncollected dispatch is
dropped, every page reference or slot is reclaimed), :meth:`degrade`
stalls it for a window on the engine's clock (self-healing) or lets it
serve one step out of ``slow_every`` until :meth:`recover`, and
:meth:`shed` hands the cluster's watchdog the queued requests it
abandons.  A dropped round's kernels have already been enqueued: its
launches stay counted (``decode_rounds``, ``prefills`` count at
dispatch), and everything runs on one stream, so pages it freed and a
later prefill reuses are written after the dropped round's writes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.cluster.request import Request
from repro_torch.faults.policy import AVAILABILITY, Health
from repro_torch.launch import sharding
from repro_torch.serving import compiled
from repro_torch.serving.paged_kv import (BlockTable, PagePool, PrefixCache,
                                          cdiv, paged_supported)
from repro_torch.train.steps import pick_tokens
from repro_torch.workload.capability import (EngineCapability,
                                             cold_token_seconds)
from repro_torch.workload.queueing import EDFQueue


@dataclasses.dataclass
class RequestResult:
    """Batch-level result of the blocking :meth:`ServeEngine.generate`."""

    tokens: list
    prefill_s: float
    decode_s: float
    queue_s: float

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s + self.queue_s


@dataclasses.dataclass
class _Lane:
    """One in-flight request."""

    req: Request
    table: BlockTable
    prompt_len: int
    chunk_pos: int = 0       # next prompt position to prefill
    length: int = 0          # KV positions written so far
    last_tok: Optional[torch.Tensor] = None   # (1,) int32, on the device

    @property
    def decoding(self) -> bool:
        return self.chunk_pos >= self.prompt_len


@dataclasses.dataclass
class _Pending:
    """Device work enqueued by :meth:`ServeEngine.dispatch`, awaiting its
    :meth:`~ServeEngine.collect`.

    ``prefill`` holds ``(req, tok_device, pos, finished)`` for each prompt
    that completed prefilling this step; ``decode`` holds the round's
    device tokens plus ``(slot/lane, req, pos, finished)`` per
    participant.
    Finish decisions are structural (token counts), resolved at dispatch
    time; only values and timestamps wait for the transfer."""

    prefill: List[Tuple[Request, torch.Tensor, int, bool]] = \
        dataclasses.field(default_factory=list)
    decode: Optional[Tuple[torch.Tensor,
                           List[Tuple[int, Request, int, bool]]]] = None


class ServeEngine:
    """Continuous-batching engine for one model replica on one device."""

    def __init__(self, cfg, params, *, max_len: int = 256,
                 kv_slots: int = 4, sample: bool = False,
                 temperature: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 paged: Optional[bool] = None, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_lanes: Optional[int] = None,
                 prefill_chunk: int = 64,
                 prefix_cache: Optional[bool] = None,
                 arch_id: Optional[str] = None,
                 device: DeviceLike = None, seed: int = 0, mesh=None):
        self.device = resolve_device(device)
        wdev = params["embed"]["embed"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params live on {wdev}, engine device is "
                             f"{self.device}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.params = (params if mesh is None
                       else sharding.place_params(mesh, params, cfg))
        self.max_len = max_len
        self.kv_slots = kv_slots
        self.sample = sample
        self.arch_id = arch_id or cfg.name
        self._clock = clock
        self._queue = EDFQueue()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._zero_tok = torch.zeros(
            (1, cfg.num_codebooks) if cfg.num_codebooks else (1,),
            dtype=torch.int32, device=self.device)
        self._ewma_tok_s = 0.0         # measured seconds per decode token
        self._next_rid = 0
        self.peak_inflight = 0
        self.decode_rounds = 0         # decode rounds dispatched since reset
        # prefill forward passes dispatched since reset: one per chunk on
        # the paged path, one per prompt on the dense path
        self.prefills = 0
        self._pending: Optional[_Pending] = None
        self._round_t0 = 0.0
        self.health = Health.HEALTHY
        self.fail_reason: Optional[str] = None
        self._stall_until = 0.0        # stalled until this engine-clock time
        self._slow_every = 1           # slowed: serve one step out of this
        self._step_seq = 0             # gated dispatches while slowed
        self.prefill_tokens_saved = 0
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.cow_forks = 0

        self.paged = paged_supported(cfg) if paged is None else bool(paged)
        self._prefix: Optional[PrefixCache] = None
        if self.paged:
            self.page_size = page_size
            self.prefill_chunk = prefill_chunk
            if num_pages is None:
                # the KV token budget a dense pool would hold, plus the
                # null page
                num_pages = 1 + kv_slots * cdiv(max_len, page_size)
            self.num_pages = num_pages
            self.max_lanes = max_lanes or 2 * kv_slots
            # fixed table width: a max_len request plus null padding for
            # chunked-prefill overshoot writes
            self._row_width = (cdiv(max_len, page_size)
                               + cdiv(prefill_chunk, page_size) + 1)
            self._pool = PagePool(num_pages, page_size)
            self._lanes: List[Optional[_Lane]] = [None] * self.max_lanes
            self._paged_states = None  # built lazily on first admission
            self._paged_prefill = compiled.paged_prefill_step(
                cfg, num_pages, page_size, mesh=mesh)
            self._paged_decode = compiled.paged_decode_step(
                cfg, num_pages, page_size, sample, temperature, mesh=mesh)
            if prefix_cache is None or prefix_cache:
                self._prefix = PrefixCache(self._pool)
                self._page_copy = compiled.page_copy_step(
                    cfg, num_pages, page_size, mesh=mesh)
            else:
                self._page_copy = None
        else:
            self.page_size = 0
            self._prefill = compiled.prefill_step(cfg, max_len, mesh=mesh)
            self._slots: List[Optional[Request]] = [None] * kv_slots
            # each slot's last token, on the device: (1,) int32
            self._last_tok: List[Optional[torch.Tensor]] = [None] * kv_slots
            self._pool_states = None   # per-layer states, slot axis first
            self._pool_decode = compiled.pool_decode_step(
                cfg, kv_slots, sample, temperature, mesh=mesh,
                max_len=max_len)
            self._insert = compiled.pool_insert()
            self._pool_specs = None    # a mesh's cut of the slot pool

    # ------------------------------------------------------------------
    # continuous-batching core
    # ------------------------------------------------------------------
    def admit(self, req: Request) -> None:
        """Enqueue a request; it joins the decode batch when capacity (a
        dense slot, or a lane and enough free pages) opens up."""
        if self.health is Health.DOWN:
            raise RuntimeError(
                f"engine {getattr(self, 'engine_id', '?')} "
                f"({self.arch_id}) is DOWN"
                f"{f' ({self.fail_reason})' if self.fail_reason else ''}; "
                f"cannot admit request {req.rid}")
        req.t_enqueue = self._clock()
        req.engine_id = getattr(self, "engine_id", None)
        if req.patches is not None:     # onto the device at admission
            req.patches = (
                req.patches.to(self.device, non_blocking=True)
                if isinstance(req.patches, torch.Tensor)
                else self._to_device(np.asarray(req.patches, np.float32)))
        self._queue.append(req)

    def step(self) -> List[Request]:
        """One scheduling iteration; returns requests finished this step."""
        if not self.dispatch():
            return []
        return self.collect()

    def dispatch(self) -> bool:
        """Enqueue one step's device work without waiting for the device.

        Returns False when the engine is gated off this step (DOWN,
        stalled, or slowdown-skipped) or idle.  A DEGRADED engine is
        either stalled (frozen until ``_stall_until``, then it recovers
        by itself) or slowed (serving one step out of ``_slow_every``
        until :meth:`recover`)."""
        if self._pending is not None:
            raise RuntimeError("dispatch() with an uncollected step in "
                               "flight; call collect() first")
        if self.health is Health.DOWN:
            return False
        if self.health is Health.DEGRADED:
            now = self._clock()
            if now < self._stall_until:
                return False
            if self._stall_until and self._slow_every <= 1:
                self.recover()          # stall window elapsed
            else:
                self._stall_until = 0.0
                self._step_seq += 1
                if self._step_seq % self._slow_every:
                    return False
        if not self._queue and not self._inflight_requests():
            return False
        self._pending = (self._dispatch_paged() if self.paged
                         else self._dispatch_dense())
        return True

    def collect(self) -> List[Request]:
        """Wait for the dispatched step and finalize requests.

        One device-to-host transfer per engine per step: the prefill
        first-tokens and the decode round's tokens travel together.
        Returns the requests finished this step, prefill completions
        first."""
        if self._pending is None:
            return []
        pend, self._pending = self._pending, None
        finished: List[Request] = []
        parts = [tok for _, tok, _, _ in pend.prefill]
        if pend.decode is not None:
            parts.append(pend.decode[0])
        if not parts:
            return finished
        host = torch.cat(parts).cpu().numpy()      # blocks until ready
        if pend.decode is not None:
            self._note_round(self._round_t0, len(pend.decode[1]))

        for j, (req, _, pos, fin) in enumerate(pend.prefill):
            req.tokens[pos] = host[j:j + 1]
            req.t_prefill_end = self._clock()
            if fin:
                req.finish(req.t_prefill_end)
                finished.append(req)

        if pend.decode is not None:
            tok_np = host[len(pend.prefill):]
            now = self._clock()
            for i, req, pos, fin in pend.decode[1]:
                req.tokens[pos] = tok_np[i:i + 1]
                if fin:
                    req.finish(now)
                    finished.append(req)
        return finished

    @property
    def pending_collect(self) -> bool:
        """True between a dispatch() and its collect()."""
        return self._pending is not None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for queued device
        work: a blocking copy from pageable memory would synchronise the
        stream, so CUDA copies go through a pinned buffer."""
        t = torch.from_numpy(np.array(a, order="C"))    # own, writable
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch_dense(self) -> _Pending:
        pend = _Pending()
        # admission: every joining request's prefill is enqueued here and
        # its first token read in collect()
        free = [i for i, r in enumerate(self._slots) if r is None]
        while free and self._queue:
            req = self._queue.popleft()
            i = free.pop(0)
            req.t_prefill_start = self._clock()
            batch = {"tokens": self._to_device(req.prompt)}
            if req.patches is not None:
                batch["patches"] = req.patches
            logits, st = self._prefill(self.params, batch)
            self.prefills += 1
            tok = self._pick(logits)               # on the device
            pos = len(req.tokens)
            req.tokens.append(tok)
            if len(req.tokens) >= req.max_new_tokens:
                pend.prefill.append((req, tok, pos, True))
                free.insert(0, i)
                continue
            pend.prefill.append((req, tok, pos, False))
            self._ensure_pool()
            if self.mesh is None:
                self._pool_states = self._insert(self._pool_states, st, i)
            else:
                sharding.insert_state(self.mesh, self._pool_states,
                                      self._pool_specs, st, i)
            self._slots[i] = req
            self._last_tok[i] = tok
        self._note_inflight(sum(r is not None for r in self._slots))

        # one decode round over every slot; free slots decode their stale
        # state and their tokens are dropped
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if active:
            toks = torch.stack([t if t is not None else self._zero_tok
                                for t in self._last_tok])   # (slots, 1[, K])
            self._round_t0 = self._clock()
            tok_all, self._pool_states = self._pool_decode(
                self.params, self._decode_tokens(toks), self._pool_states,
                self._gen)
            self.decode_rounds += 1
            entries = []
            for i in active:
                req = self._slots[i]
                tk = tok_all[i:i + 1]              # device slice
                pos = len(req.tokens)
                req.tokens.append(tk)
                self._last_tok[i] = tk
                fin = len(req.tokens) >= req.max_new_tokens
                entries.append((i, req, pos, fin))
                if fin:
                    self._slots[i] = None
            pend.decode = (tok_all, entries)
        return pend

    def _dispatch_paged(self) -> _Pending:
        pend = _Pending()
        # 1. admission — head-of-line, gated on free pages (worst case
        # reserved up front) and a free lane, in queue (EDF/FIFO) order
        free = [i for i, ln in enumerate(self._lanes) if ln is None]
        while free and self._queue:
            req = self._queue[0]
            plen = self._prompt_len(req)
            total = plen + req.max_new_tokens
            need = self._pool.pages_needed(total)
            if need > self._row_width - 1 - cdiv(self.prefill_chunk,
                                                 self.page_size):
                raise ValueError(
                    f"request needs {need} pages > per-request capacity "
                    f"(max_len={self.max_len})")
            # prefix match, capped at plen - 1 so the last position is
            # always prefilled (its logits give the first token)
            m = None
            if self._prefix is not None:
                m = self._prefix.match(req.prompt, max_tokens=plen - 1)
                self.prefix_lookups += 1
            shared = m.pages if m is not None else []
            # retain matched pages first so eviction below cannot free
            # them, then make room for the private remainder
            if m is not None:
                self._prefix.acquire(m)
            need_new = need - len(shared)
            ok = (self._pool.num_free >= need_new
                  or (self._prefix is not None
                      and self._prefix.ensure_free(need_new)))
            if not ok:
                if m is not None:
                    self._prefix.release_match(m)
                break
            self._queue.popleft()
            i = free.pop(0)
            table = BlockTable(self._pool, total, shared=shared)
            matched = len(shared) * self.page_size
            if m is not None and m.cow_page is not None:
                # copy-on-write fork of the partially matching cached page
                self._ensure_paged_states()
                dst = table.pages[len(shared)]
                self._paged_states = self._page_copy(
                    self._paged_states, m.cow_page, dst)
                self._pool.release([m.cow_page])   # fork done: drop src
                matched += m.cow_tokens
                self.cow_forks += 1
            if matched:
                self.prefix_hits += 1
                self.prefill_tokens_saved += matched
                req.prefix_tokens = matched
            self._lanes[i] = _Lane(req=req, table=table, prompt_len=plen,
                                   chunk_pos=matched, length=matched)
        self._note_inflight(sum(ln is not None for ln in self._lanes))

        # 2. one prefill chunk per still-prefilling lane
        self._ensure_paged_states()
        C = self.prefill_chunk
        for i, lane in enumerate(self._lanes):
            if lane is None or lane.decoding:
                continue
            req = lane.req
            if req.t_prefill_start is None:
                req.t_prefill_start = self._clock()
            c0 = lane.chunk_pos
            chunk = np.asarray(req.prompt[..., c0:c0 + C], np.int32)
            pad = C - chunk.shape[-1]
            if pad:
                widths = [(0, 0)] * (chunk.ndim - 1) + [(0, pad)]
                chunk = np.pad(chunk, widths)
            row = np.asarray(lane.table.row(self._row_width), np.int32)
            logits, self._paged_states = self._paged_prefill(
                self.params,
                {"tokens": self._to_device(chunk), "start": c0,
                 "block_table": self._to_device(row)},
                self._paged_states)
            self.prefills += 1
            lane.chunk_pos = c0 + C
            lane.length = min(lane.chunk_pos, lane.prompt_len)
            if lane.decoding:                      # last chunk of prompt
                last = lane.prompt_len - 1 - c0
                tok = self._pick(logits[0, last][None])
                pos = len(req.tokens)
                req.tokens.append(tok)
                lane.last_tok = tok
                fin = len(req.tokens) >= req.max_new_tokens
                pend.prefill.append((req, tok, pos, fin))
                # index the completed prompt blocks before any release so
                # cached pages carry their reference when the lane lets go
                if self._prefix is not None:
                    self._prefix.insert(req.prompt, lane.table.pages)
                if fin:
                    self._free_lane(i)

        # 3. one decode round across the lanes that finished prefilling;
        # idle/prefilling lanes ride along masked (null table, length 0)
        active = [i for i, ln in enumerate(self._lanes)
                  if ln is not None and ln.decoding]
        if active:
            L, W = self.max_lanes, self._row_width
            rows = [self._zero_tok] * L
            tables = np.zeros((L, W), np.int32)
            lengths = np.zeros((L,), np.int32)
            for i in active:
                lane = self._lanes[i]
                rows[i] = lane.last_tok
                tables[i] = lane.table.row(W)
                lengths[i] = lane.length
            self._round_t0 = self._clock()
            _, tok_all, self._paged_states = self._paged_decode(
                self.params,
                {"tokens": self._decode_tokens(torch.stack(rows)),
                 "block_tables": self._to_device(tables),
                 "lengths": self._to_device(lengths)},
                self._paged_states, self._gen)
            self.decode_rounds += 1
            entries = []
            for i in active:
                lane = self._lanes[i]
                req = lane.req
                tk = tok_all[i:i + 1]              # device slice
                pos = len(req.tokens)
                req.tokens.append(tk)
                lane.last_tok = tk
                lane.length += 1                   # decode wrote one KV
                fin = len(req.tokens) >= req.max_new_tokens
                entries.append((i, req, pos, fin))
                if fin:
                    self._free_lane(i)
            pend.decode = (tok_all, entries)
        return pend

    def run_to_completion(self, max_steps: int = 1_000_000) -> List[Request]:
        """Step until queue and lanes drain; returns finished requests."""
        done = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            done += self.step()
        return done

    def reset(self) -> None:
        """Drop queued/in-flight work and measurement state.  A dense
        engine frees its slots (their states need no zeroing: every
        position is written before it is read); a paged one releases every
        lane and prefix-cache reference and checks that the pool returns
        to all-free (a leak here is a bug)."""
        self._queue.clear()
        self._ewma_tok_s = 0.0
        self._next_rid = 0
        self.peak_inflight = 0
        self.decode_rounds = 0
        self.prefills = 0
        self._pending = None
        self.health = Health.HEALTHY
        self.fail_reason = None
        self._stall_until = 0.0
        self._slow_every = 1
        self._step_seq = 0
        self.prefill_tokens_saved = 0
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.cow_forks = 0
        if not self.paged:
            self._slots = [None] * self.kv_slots
            self._last_tok = [None] * self.kv_slots
            return
        for lane in self._lanes:
            if lane is not None:
                lane.table.release()
        self._lanes = [None] * self.max_lanes
        if self._prefix is not None:
            self._prefix.clear()
        if self._pool.num_free != self.num_pages - 1:
            raise RuntimeError(
                f"page pool leak on reset: {self._pool.num_free} free of "
                f"{self.num_pages - 1} allocatable after releasing all "
                f"lanes and the prefix cache")
        self._pool.reset()

    # ------------------------------------------------------------------
    # health transitions (repro_torch.faults)
    # ------------------------------------------------------------------
    def fail(self, reason: str = "injected crash") -> List[Request]:
        """Hard crash: mark DOWN, drain queued and in-flight requests and
        reclaim every KV page reference or dense slot they held.

        Returns the orphans (queued first, then those finished inside a
        dropped dispatch, then in-flight) so the cluster can re-offload
        them; their per-attempt state is not reset here.  An uncollected
        dispatch is dropped: its device tokens are never read."""
        orphans: List[Request] = list(self._queue)
        self._queue.clear()
        if self._pending is not None:
            pend, self._pending = self._pending, None
            orphans += [req for req, _, _, fin in pend.prefill if fin]
            if pend.decode is not None:
                orphans += [req for _, req, _, fin in pend.decode[1] if fin]
        if self.paged:
            for i, lane in enumerate(self._lanes):
                if lane is not None:
                    orphans.append(lane.req)
                    self._free_lane(i)
        else:
            for i, req in enumerate(self._slots):
                if req is not None:
                    orphans.append(req)
                    self._slots[i] = None
                    self._last_tok[i] = None
        self.health = Health.DOWN
        self.fail_reason = str(reason)
        return orphans

    def recover(self) -> None:
        """Return to HEALTHY after a crash, stall, or slowdown window."""
        self.health = Health.HEALTHY
        self.fail_reason = None
        self._stall_until = 0.0
        self._slow_every = 1

    def degrade(self, *, stall_s: float = 0.0, slow_every: int = 1,
                reason: str = "injected degradation") -> None:
        """Soft fault: freeze for ``stall_s`` seconds of the engine's clock
        (a transient straggler, self-healing) and/or serve only one step
        out of ``slow_every`` (a sustained slowdown, until
        :meth:`recover`)."""
        if self.health is Health.DOWN:
            raise RuntimeError("cannot degrade a DOWN engine; recover it "
                               "first")
        self.health = Health.DEGRADED
        self.fail_reason = str(reason)
        if stall_s > 0:
            self._stall_until = self._clock() + stall_s
        self._slow_every = max(int(slow_every), 1)

    @property
    def available(self) -> bool:
        """Placement-eligible (DEGRADED still serves, DOWN does not)."""
        return self.health is not Health.DOWN

    @property
    def availability(self) -> float:
        """Observation feature: 1 healthy, 0.5 degraded, 0 down."""
        return AVAILABILITY[self.health]

    def shed(self, pred) -> List[Request]:
        """Remove queued (not yet running) requests matching ``pred``: the
        cluster watchdog's shedding hook."""
        return self._queue.drain(pred)

    @property
    def kv_leak(self) -> int:
        """Outstanding KV reservations: busy dense slots, or page
        references owed to live lanes (total refs net of the prefix
        cache's one reference per entry).  0 whenever idle."""
        if not self.paged:
            return sum(r is not None for r in self._slots)
        held = self._prefix.size if self._prefix is not None else 0
        return self._pool.total_refs - held

    # ------------------------------------------------------------------
    # backlog signals (the scheduler's q_b / Eqn-3 observation)
    # ------------------------------------------------------------------
    def _inflight_requests(self) -> List[Request]:
        if not self.paged:
            return [r for r in self._slots if r is not None]
        return [ln.req for ln in self._lanes if ln is not None]

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._inflight_requests())
                or self._pending is not None)

    @property
    def pending_tokens(self) -> int:
        """Tokens still to generate across queued + in-flight requests."""
        n = sum(r.max_new_tokens for r in self._queue)
        n += sum(r.max_new_tokens - len(r.tokens)
                 for r in self._inflight_requests())
        return n

    @property
    def pending_seconds(self) -> float:
        """Measured backlog estimate: pending tokens x EWMA token time."""
        return self.pending_tokens * self._ewma_tok_s

    # ------------------------------------------------------------------
    # prefix-cache signals (the prefix-affinity scheduler's feature)
    # ------------------------------------------------------------------
    def expected_prefix_tokens(self, req: Request) -> int:
        """Prompt tokens this engine could skip for ``req`` right now: a
        pure peek at the prefix index (no reference taken, no LRU bump).
        0 for dense and cache-off engines."""
        if not self.paged or self._prefix is None:
            return 0
        return self._prefix.match(
            req.prompt, max_tokens=self._prompt_len(req) - 1).tokens

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admissions that reused at least one cached page."""
        if not self.prefix_lookups:
            return 0.0
        return self.prefix_hits / self.prefix_lookups

    @property
    def prefix_cached_pages(self) -> int:
        return self._prefix.size if self._prefix is not None else 0

    @property
    def prefix_evictions(self) -> int:
        return self._prefix.evictions if self._prefix is not None else 0

    @property
    def est_token_seconds(self) -> float:
        """Seconds per decode token: measured EWMA once the engine has run
        a round, else a FLOPs-based cold prior."""
        if self._ewma_tok_s > 0:
            return self._ewma_tok_s
        return cold_token_seconds(self.cfg)

    @property
    def capability(self) -> EngineCapability:
        """Snapshot of this engine as an edge-server capability
        descriptor: its live f_b' (measured tok/s) and per-step cost."""
        active = self.cfg.active_param_count()
        return EngineCapability(
            arch=self.arch_id, model_name=self.cfg.name,
            num_layers=self.cfg.num_layers, d_model=self.cfg.d_model,
            active_params=active, rho_gcycles=2.0 * active / 1e9,
            tok_s=1.0 / self.est_token_seconds,
            measured=self._ewma_tok_s > 0, paged=self.paged,
            prefix_hit_rate=self.prefix_hit_rate,
            prefix_cached_tokens=self.prefix_cached_pages * self.page_size)

    # ------------------------------------------------------------------
    # blocking compatibility API
    # ------------------------------------------------------------------
    def generate(self, prompts: np.ndarray, num_tokens: int,
                 patches=None) -> RequestResult:
        """prompts (B, S) [or (B, K, S) audio] int, with patches
        (B, P, vision_dim) for vision configs -> per-step (B,) [or
        (B, K)] tokens plus measured timing (admit all, drain)."""
        prompts = np.asarray(prompts, np.int32)
        reqs = []
        for b in range(prompts.shape[0]):
            reqs.append(Request(
                rid=self._next_rid, prompt=prompts[b:b + 1],
                max_new_tokens=max(num_tokens, 1),
                patches=None if patches is None else patches[b:b + 1]))
            self._next_rid += 1
            self.admit(reqs[-1])
        self.run_to_completion()
        toks = [np.concatenate([r.tokens[s] for r in reqs], axis=0)
                for s in range(max(num_tokens, 1))]
        t_dec0 = max(r.t_prefill_end for r in reqs)
        t_end = max(r.t_finish for r in reqs)
        return RequestResult(
            tokens=toks,
            prefill_s=sum(r.prefill_s for r in reqs),
            decode_s=max(t_end - t_dec0, 0.0),
            queue_s=max(max(r.queue_s for r in reqs), 0.0))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """(1, V) [or (1, K, V)] logits -> (1,) [or (1, K)] int32 tokens,
        on the device."""
        return pick_tokens(logits, self.sample, 1.0, self._gen)

    def _decode_tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """Stacked last tokens (B, 1) [or (B, 1, K)] -> the decode step's
        (B, 1) [or (B, K, 1)]."""
        return toks.transpose(1, 2) if self.cfg.num_codebooks else toks

    @staticmethod
    def _prompt_len(req: Request) -> int:
        return int(req.prompt.shape[-1])

    def _note_round(self, t0: float, active: int) -> None:
        # a round advances every active lane one token: the per-token
        # drain rate is round time / active lanes, windowed from this
        # engine's dispatch to its results being ready
        dt = (self._clock() - t0) / active
        self._ewma_tok_s = (0.7 * self._ewma_tok_s + 0.3 * dt
                            if self._ewma_tok_s else dt)

    def _note_inflight(self, n: int) -> None:
        self.peak_inflight = max(self.peak_inflight, n)

    def _free_lane(self, i: int) -> None:
        self._lanes[i].table.release()
        self._lanes[i] = None

    def _ensure_pool(self) -> None:
        """Build the slot pool at first admission: every layer's state
        with ``kv_slots`` rows; on a mesh, this rank's block of it."""
        if self._pool_states is None:
            from repro_torch.models.transformer import init_layer_states
            states = init_layer_states(
                self.cfg, self.kv_slots, self.max_len, self.device)
            if self.mesh is not None:
                self._pool_specs = sharding.pool_pspecs(states, self.mesh)
                states = sharding.place_states(self.mesh, states,
                                               self._pool_specs)
            self._pool_states = states

    def placement_report(self) -> dict:
        """The layout each layer's weights and rings took in this engine's
        steps so far (``launch.sharding.placement_report``), merged over
        its steps; empty without a mesh."""
        steps = ((self._paged_prefill, self._paged_decode) if self.paged
                 else (self._prefill, self._pool_decode))
        report: dict = {}
        for step in steps:
            ctx = getattr(step, "sharding", None)
            for tag, leaves in sharding.placement_report(ctx).items() \
                    if ctx is not None else ():
                report.setdefault(tag, {}).update(leaves)
        return report

    def _ensure_paged_states(self) -> None:
        if self._paged_states is None:
            from repro_torch.models.transformer import init_paged_states
            self._paged_states = init_paged_states(
                self.cfg, self.num_pages, self.page_size, self.device)
