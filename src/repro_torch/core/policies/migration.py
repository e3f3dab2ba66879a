"""Built-in live-KV-migration destination policies (survivability layer,
core/cluster.py ``KVMigrationConfig.policy``).

When an instance receives a spot-style preemption warning, the cluster
loop streams each victim request's KV to a peer over the interconnect;
these policies pick the peer. They must be deterministic — migration
runs on the seeded failure path and feeds the churn bit-identity tests.

The port's own copy of `repro/core/policies/migration.py` (plain Python and
numpy; keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

from repro_torch.core.api import MigrationPolicy, register_policy


@register_policy("kv_headroom")
class KVHeadroomDest(MigrationPolicy):
    """Most free KV admission budget under the unified allocator's
    conservative reservation (``DecodeInstanceSim.kv_headroom_chunks``):
    the migrated context must be admitted on arrival, so headroom — not
    queue length — is the binding constraint. Load and instance id break
    ties deterministically."""

    def pick_dest(self, req, cand, router):
        return max(cand, key=lambda i: (i.kv_headroom_chunks(),
                                        -i.load(), -i.inst_id))


@register_policy("least_loaded")
class LeastLoadedDest(MigrationPolicy):
    """Join-shortest-queue on the occupancy signal — the same heuristic
    as the routing-kind ``least_loaded`` (per-kind namespaces let the
    name be reused). Ignores KV headroom, so a lightly-loaded but
    memory-full peer can stall the migrated request at admission; kept
    as the comparison baseline for ``kv_headroom``."""

    def pick_dest(self, req, cand, router):
        return min(cand, key=lambda i: (i.load(), i.inst_id))
