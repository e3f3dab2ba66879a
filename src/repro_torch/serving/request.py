"""Request bookkeeping for the serving engine.

The port's own copy of `Request`/`Phase` from `repro/serving/request.py`
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

# Segment-id namespaces for Request.prefix_segments. The ids only need to
# be collision-free across namespaces; bases live here (not in
# core/prefix_tree.py) because serving must not import core.
GROUP_SEG_BASE = 1_000_000_000      # shared system-prompt / template groups
SESSION_SEG_BASE = 2_000_000_000    # per-session prompt remainders


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float                 # seconds since trace start
    prompt_len: int
    max_new_tokens: int
    # sticky-routing key (-1 = sessionless): requests sharing a session
    # benefit from prefix-cache reuse when routed to the same instance
    session_id: int = -1
    # symbolic prompt structure for cross-session prefix sharing
    # (core/prefix_tree.py): ordered (segment_id, n_tokens) runs summing
    # to prompt_len. Empty = opaque prompt, cached session-keyed only.
    # Survives reset_for_retry — it is prompt identity, not placement
    # state.
    prefix_segments: Tuple[Tuple[int, int], ...] = ()
    # tokens of the prompt already resident in the target instance's prefix
    # cache (core/prefix_cache.py): they need no prefill compute
    cache_hit_tokens: int = 0
    # chunked-prefill progress (prefill_mode="chunked"): effective prompt
    # tokens already processed in decode-round chunks
    prefilled_tokens: int = 0
    phase: Phase = Phase.QUEUED
    slot: int = -1                 # decode slot index (-1 = unassigned)
    generated: int = 0
    prefill_start: float = -1.0    # time a prefill worker picked it up
    prefill_done: float = -1.0     # time prefill finished (TTFT component)
    prefill_worker: int = -1       # pool worker that ran the prefill
    finish: float = -1.0
    # times the request lost its KV to an instance failure and re-entered
    # the router (cluster failure layer, core/cluster.py)
    restarts: int = 0
    # prompt-position tokens whose KV already arrived on the forced
    # destination via live migration (survivability layer): a partial
    # transfer that lost the preemption race re-prefills only the unsent
    # tail. Cleared by reset_for_retry alongside the cache-hit credit.
    migrated_tokens: int = 0
    # admission-control shed count (degradation ladder): each shed re-entry
    # waits a seeded jittered exponential backoff that lands in TTFT
    retries: int = 0
    # multi-LoRA serving (core/adapters.py): the tenant adapter this
    # request must be served with (-1 = base model), and the version the
    # router stamped from the AdapterRegistry at dispatch
    adapter_id: int = -1
    adapter_version: int = 0
    # per-tenant SLO overrides (None = RouterConfig defaults): request_slo
    # scores each tenant's requests against its own targets
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def effective_prompt_len(self) -> int:
        """Prompt tokens that actually need prefill compute: the prefix-cache
        hit is already resident on the target instance, and migrated KV
        (partial or full transfers that beat the preemption deadline) is
        likewise already on the destination. KV accounting still charges
        the full prompt (resident prefixes occupy cache capacity)."""
        return max(self.prompt_len - self.cache_hit_tokens
                   - self.migrated_tokens, 1)

    def tpot_samples(self) -> List[float]:
        """Per-output-token latencies (decode QoS metric)."""
        ts = self.token_times
        return [ts[i] - ts[i - 1] for i in range(1, len(ts))]

    def reset_for_retry(self) -> None:
        """Strip all per-placement prefill state so the request can re-enter
        the router after its instance died: the KV cache (including any
        prefix-cache credit) is gone, so prefill restarts at full length.
        Decode progress bookkeeping (``generated``/``token_times``) is kept
        — already-emitted tokens happened, and the re-prefill gap shows up
        between consecutive token times as the churn TPOT penalty."""
        self.cache_hit_tokens = 0
        self.migrated_tokens = 0
        self.prefilled_tokens = 0
        self.prefill_start = -1.0
        self.prefill_done = -1.0
        self.prefill_worker = -1
        self.phase = Phase.QUEUED
        self.slot = -1
        self.restarts += 1
