"""Continuous-batching decode engine (real-compute path).

Port of `repro/serving/engine.py`: the decode *instance* of the
disaggregated deployment (paper §2.1). Prefill runs per admission into a
one-slot cache that is then copied into the slot; decode proceeds in rounds
over a fixed slot array. Admission, slot insert, `decode_round` and
`run_trace` keep the reference's semantics, and prompt tokens come from the
same `np.random.default_rng(seed)`, so a seeded trace is the same on both
sides. Greedy argmax is taken on the device, with one host copy per round.
`use_kernels` reaches prefill as well as decode (the reference engine
passes it to decode only), so an SSM model's admissions run the SSD scan
kernel. The slot insert copies every per-layer cache leaf, KV, MLA latent,
SSM or RG-LRU state: a "pre" or "post" layer's cache (no layer axis) at
[slot], the stacked caches (the hybrid's nested "sub{i}" ones too) at
[:, slot].
A decode round writes the last token at position context_len - 1, so the
first decode token goes to position prompt_len; the reference writes it at
context_len and never writes prompt_len, which leaves a stale slot that
the decode kernel reads and the oracle masks (ROADMAP.md §3).
A sliding-window model's cache is a ring of min(s_max, window) slots
(`models/attention.py`) while positions still run to s_max - 1; the one-slot
prefill cache is the same ring, and the page accounting counts the ring's
tokens, not the context's (the reference's counts the context).
A vision-stub model's requests carry F patch embeddings (`_stub_extras`,
drawn from the engine's rng after the prompt, as in the reference), which
the prefill writes at positions 0..F-1 ahead of the prompt. The port's
decode positions, page admission and finishing test count them; the
reference's leave them out, so its first decode writes at position
prompt_len + 1, inside the patches and prompt (ROADMAP.md §3).
An encoder-decoder model's requests carry `enc_len` stub encoder frames
each (`_stub_extras`), which the admission's prefill encodes into the
slot's cross K/V; those are sized by the engine's fixed `enc_len` (at
least 1) and left out of the page accounting, as in the reference, so
every request must bring exactly `enc_len` frames.

On the card the decode step is a CUDA graph (`DecodeGraph`), captured at
the first round or by `precompile` (the reference jits it at its first
call) and replayed every round: each round writes the tokens and
positions into pinned host buffers, copies each to its static device
buffer with one non-blocking copy, replays, and copies the greedy tokens
back. `graphs=False` asks for eager rounds (the CPU has only those).
Prefill stays eager: the reference's jitted prefill compiles once per
prompt length, and a graph per length would capture at almost every
admission. It writes the slot's cache in place, which the graph reads.

Spans (`spans.py`, recorded in a traced window): `engine.admit` (rid,
prompt_len, slot) over an admission, with `engine.admit.cache` (the
one-slot cache), `engine.prefill`, `engine.admit.insert` and
`engine.admit.token` (the first token's host read); `engine.round`
(batch) over a round, with `engine.round.inputs` (positions, the pinned
staging and its copies), `engine.round.step` (the replay or the step),
`engine.round.tokens` (the copy that waits for the device) and
`engine.round.finish` (pages, tokens, finishing).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.core import graphs as G
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_cache import PageTableManager, spec_for
from repro_torch.serving.request import Phase, Request
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class EngineMetrics:
    decode_rounds: int = 0
    tokens_out: int = 0
    prefills: int = 0
    round_batch_sizes: List[int] = dataclasses.field(default_factory=list)
    # host-clock seconds of each decode round / admission prefill; each
    # ends in a device-to-host copy of its tokens, which waits for the device
    round_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    ft_units: int = 0          # finetune units run in co-located rounds


class DecodeGraph:
    """`decode_step` plus its greedy argmax over a fixed batch, captured
    once on one cache. `tokens` and `positions` are the static inputs,
    `logits` and `next_tokens` the static outputs, all allocated outside
    the graph (`core/graphs.py`'s invariant). Capture warms the step up on
    the cache and then puts the cache back as it was. `pool`: the memory
    pool to capture into (a new one by default); `stream`: the stream to
    warm up and capture on (a side stream by default), whose SMs the
    replays keep to."""

    def __init__(self, params, cfg: ModelConfig, cache, *,
                 use_kernels: bool = False, tokens=None, positions=None,
                 pool=None, stream=None):
        some = tree_leaves(cache["scan"])[0]      # (layers, slots, ...)
        slots, dev = some.shape[1], some.device
        self.tokens = torch.zeros((slots,), dtype=torch.int32, device=dev) \
            if tokens is None else tokens
        self.positions = torch.zeros_like(self.tokens) \
            if positions is None else positions
        self.cache = cache
        self._addresses = G.addresses(cache)

        def step():
            return MD.decode_step(params, cfg, self.tokens, self.positions,
                                  cache, use_kernels=use_kernels)[0]

        saved = G.snapshot(cache)
        out = {}
        G.on_side_stream(lambda: out.setdefault("logits", step()), stream)
        G.restore(saved)
        del saved
        self.logits = torch.empty_like(out.pop("logits"))
        self.next_tokens = torch.zeros_like(self.tokens)

        def body():
            logits = step()
            self.logits.copy_(logits)
            self.next_tokens.copy_(logits.argmax(dim=-1))

        self.pool = pool or torch.cuda.graph_pool_handle()
        self.graph = G.capture(body, self.pool, stream)

    def __call__(self, tokens, positions, cache):
        """Replay on these inputs (copied into the static buffers unless
        they are those). Returns the static `logits`, which the next
        replay overwrites."""
        if cache is not self.cache and \
                G.addresses(cache) != self._addresses:
            raise ValueError("the decode graph was captured on another cache")
        if tokens is not self.tokens:
            self.tokens.copy_(tokens)
        if positions is not self.positions:
            self.positions.copy_(positions)
        self.graph.replay()
        return self.logits


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 s_max: int = 256, enc_len: int = 0,
                 use_kernels: bool = False, page_tokens: int = 16,
                 num_pages: Optional[int] = None, seed: int = 0,
                 device=None, graphs: Optional[bool] = None):
        if cfg.enc_layers and enc_len < 1:
            raise ValueError(f"{cfg.name} cross-attends to its requests' "
                             "encoder frames: give the engine enc_len >= 1")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.s_max = s_max
        self.enc_len = enc_len
        self.use_kernels = use_kernels
        self.rng = np.random.default_rng(seed)
        # bf16 cache whatever the params' dtype, as in the reference engine
        self.cache = MD.init_cache(cfg, max_slots, s_max, enc_len,
                                   device=self.device)
        self.metrics = EngineMetrics()
        # page accounting (Harli's allocator plugs in via set_usable), of
        # the tokens a slot holds: at most the ring's length when windowed
        self.cache_len = cfg.effective_cache_len(s_max)
        pages_per_seq = -(-self.cache_len // page_tokens)
        npages = num_pages or max_slots * pages_per_seq
        self.pages = PageTableManager(spec_for(cfg, npages, page_tokens),
                                      max_slots, pages_per_seq)
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.last_token = np.zeros((max_slots,), np.int32)
        # positions ahead of each slot's prompt: its stub patches
        self.front = np.zeros((max_slots,), np.int32)
        # decode rounds replay a CUDA graph unless this is False (the
        # default on the card; the CPU has no graphs, and True raises there)
        self.graphs = G.resolve(graphs, self.device)
        # the decode step's static inputs and their pinned host buffers
        pin = self.device.type == "cuda"
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                  device=self.device)
        self.positions = torch.zeros_like(self.tokens)
        self._tokens_host = torch.zeros((max_slots,), dtype=torch.int32,
                                        pin_memory=pin)
        self._positions_host = torch.zeros((max_slots,), dtype=torch.int32,
                                           pin_memory=pin)
        self._decode: Optional[DecodeGraph] = None

    def precompile(self) -> None:
        """Capture the decode step on this engine's cache (left as it was):
        the reference's jit of `decode_step`, here a CUDA graph."""
        G.resolve(True, self.device)
        self._decode = DecodeGraph(self.params, self.cfg, self.cache,
                                   use_kernels=self.use_kernels,
                                   tokens=self.tokens,
                                   positions=self.positions)

    # ------------------------------------------------------------- admit --
    def try_admit(self, req: Request, prompt_tokens: np.ndarray,
                  extras: Optional[Dict] = None) -> bool:
        """Prefill `prompt_tokens` into a free slot. extras: per-request
        inputs beside the tokens: a vision stub's "frontend" (F, d) patch
        embeddings, which take positions 0..F-1 ahead of the prompt (the
        page admission counts them, and so do the decode positions and
        the finishing test), or an encoder-decoder's "enc_frames"
        (enc_len, d)."""
        front = 0 if not extras or "frontend" not in extras \
            else len(extras["frontend"])
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None or not self.pages.admit(
                slot, min(front + req.prompt_len, self.cache_len)):
            return False
        t0 = time.perf_counter_ns()
        with spans.top("engine.admit", t0, rid=req.rid,
                       prompt_len=req.prompt_len, slot=slot):
            req.slot, req.phase = slot, Phase.PREFILLING
            self.slots[slot] = req
            self.front[slot] = front
            batch = {"tokens": torch.as_tensor(prompt_tokens[None, :],
                                               device=self.device)}
            for k, v in (extras or {}).items():
                batch[k] = torch.as_tensor(v[None], device=self.device)
            with spans.span("engine.admit.cache"):
                one_cache = MD.init_cache(self.cfg, 1, self.s_max,
                                          self.enc_len, device=self.device)
            with spans.span("engine.prefill"):
                logits, one_cache = MD.prefill(self.params, self.cfg, batch,
                                               one_cache,
                                               use_kernels=self.use_kernels)
            with spans.span("engine.admit.insert"):
                self._insert_slot_cache(slot, one_cache)
            with spans.span("engine.admit.token"):
                tok = int(torch.argmax(logits[0]))
            self.metrics.prefill_s.append(
                (time.perf_counter_ns() - t0) / 1e9)
            self.last_token[slot] = tok
            req.generated = 1
            req.phase = Phase.DECODING
            self.metrics.prefills += 1
            self.metrics.tokens_out += 1
        return True

    def _insert_slot_cache(self, slot: int, one_cache) -> None:
        """Copy the one-slot cache into `slot`: "pre" and "post" layers'
        leaves (no layer axis) at [slot], the stacked ones at [:, slot]."""
        for part in ("pre", "post"):
            for dst, src in zip(tree_leaves(self.cache[part]),
                                tree_leaves(one_cache[part])):
                dst[slot] = src[0]
        for dst, src in zip(tree_leaves(self.cache["scan"]),
                            tree_leaves(one_cache["scan"])):
            dst[:, slot] = src[:, 0]

    # ------------------------------------------------------------- rounds --
    def context(self, slot: int) -> int:
        """Positions the slot's request holds: its stub patches, prompt
        and generated tokens."""
        return int(self.front[slot]) + self.slots[slot].context_len

    def active_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None and
                r.phase == Phase.DECODING]

    def decode_round(self, step: Optional[Callable] = None) -> Dict[int, int]:
        """One decode step over all active slots. Returns {rid: token}.

        step(tokens, positions, cache) -> (logits, cache) replaces the
        decode step (the co-located runner passes its round). Without it
        the round replays the decode graph (captured at the first round),
        or runs `decode_step` eagerly when `self.graphs` is False. The
        round's time ends with the device-to-host copy of its tokens, which
        waits for everything the round queued on the stream (the host
        buffers are rewritten only after it)."""
        active = [(i, r) for i, r in enumerate(self.slots)
                  if r is not None and r.phase == Phase.DECODING]
        if not active:
            return {}
        t0 = time.perf_counter_ns()
        with spans.top("engine.round", t0, batch=len(active)):
            with spans.span("engine.round.inputs"):
                positions = self._positions_host.numpy()
                positions[:] = 0
                for i, r in active:
                    # position of the token fed
                    positions[i] = self.context(i) - 1
                np.copyto(self._tokens_host.numpy(), self.last_token)
                self.tokens.copy_(self._tokens_host, non_blocking=True)
                self.positions.copy_(self._positions_host, non_blocking=True)
            with spans.span("engine.round.step"):
                next_tokens = self._step(step)
            with spans.span("engine.round.tokens"):
                next_tokens = next_tokens.cpu().numpy()
            self.metrics.round_s.append((time.perf_counter_ns() - t0) / 1e9)
            with spans.span("engine.round.finish"):
                return self._finish(active, next_tokens)

    def _step(self, step: Optional[Callable]) -> torch.Tensor:
        """The round's greedy tokens on the device."""
        if step is None and self.graphs:
            if self._decode is None:
                self.precompile()
            self._decode(self.tokens, self.positions, self.cache)
            return self._decode.next_tokens
        if step is None:
            logits, self.cache = MD.decode_step(
                self.params, self.cfg, self.tokens, self.positions,
                self.cache, use_kernels=self.use_kernels)
        else:
            logits, self.cache = step(self.tokens, self.positions,
                                      self.cache)
        return logits.argmax(dim=-1).to(torch.int32)

    def _finish(self, active, next_tokens: np.ndarray) -> Dict[int, int]:
        """Account the round: each slot's page, token and finishing test."""
        out: Dict[int, int] = {}
        self.metrics.decode_rounds += 1
        self.metrics.round_batch_sizes.append(len(active))
        for i, r in active:
            # a full ring takes the token in place of its oldest
            if self.pages.lengths[r.slot] < self.cache_len and \
                    not self.pages.extend(r.slot, 1):
                continue  # memory pressure: request stalls this round
            self.last_token[i] = next_tokens[i]
            r.generated += 1
            self.metrics.tokens_out += 1
            out[r.rid] = int(next_tokens[i])
            if r.generated >= r.max_new_tokens or \
                    self.context(i) >= self.s_max - 1:
                r.phase = Phase.DONE
                self.pages.release(r.slot)
                self.slots[i] = None
        return out

    # ---------------------------------------------------------------- run --
    def run_trace(self, reqs: List[Request], vocab: Optional[int] = None,
                  max_rounds: int = 10_000,
                  round_fn: Optional[Callable[[], object]] = None
                  ) -> EngineMetrics:
        """Drive the engine to completion in round-order (arrival order).
        round_fn, when given, runs each round in place of `decode_round`."""
        vocab = vocab or self.cfg.vocab_size
        pending = sorted(reqs, key=lambda r: r.arrival)
        qi = 0
        rounds = 0
        while rounds < max_rounds:
            while qi < len(pending):
                r = pending[qi]
                toks = self.rng.integers(0, vocab, size=r.prompt_len,
                                         dtype=np.int32)
                if self.try_admit(r, toks, self._stub_extras(r)):
                    qi += 1
                else:
                    break
            if not self.active_requests() and qi >= len(pending):
                break
            (round_fn or self.decode_round)()
            rounds += 1
        return self.metrics

    def _stub_extras(self, req: Request) -> Optional[Dict]:
        """A vision stub's patch embeddings or an encoder-decoder's frame
        embeddings for `req`, drawn from the engine's rng after its
        prompt, as the reference draws them."""
        cfg = self.cfg
        if cfg.frontend == "vision" and cfg.frontend_tokens:
            return {"frontend": self.rng.normal(
                size=(cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
        if cfg.enc_layers:
            return {"enc_frames": self.rng.normal(
                size=(self.enc_len, cfg.d_model)).astype(np.float32)}
        return None
