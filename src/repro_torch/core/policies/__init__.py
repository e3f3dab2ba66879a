"""Built-in control-plane policies (core/api.py registry).

Importing this package registers every built-in policy:

  * routing    — least_loaded / round_robin / random / predicted_latency /
                 session_affinity (core/policies/routing.py)
  * routing    — cache_aware, the registry's proof-of-API plugin
                 (core/policies/cache_aware.py, docs/api.md walkthrough)
  * routing    — cache_aware_gossip, the fleet-scale variant scoring
                 gossiped cache digests with zero synchronous peeks
                 (core/policies/cache_aware_gossip.py, core/gossip.py)
  * prefill    — chained / pooled / chunked deployment modes
                 (core/policies/placement.py)
  * scaling    — decode_fleet / pooled_prefill / chunked_budget autoscaler
                 loops (core/policies/scaling.py)
  * migration  — kv_headroom / least_loaded live-KV-migration destination
                 choices (core/policies/migration.py)
  * adapter_placement — affinity_packed / replicate_hot multi-LoRA
                 serving placements (core/policies/adapter_placement.py)

The registry imports this package lazily on first resolve, so user code
never needs to import it explicitly; third-party policies just call
``repro_torch.core.api.register_policy`` from their own module.

The port's own copy of `repro/core/policies/__init__.py` (plain Python and
numpy; keep the two in step), with its names, seeds and arithmetic.
"""

from repro_torch.core.policies import adapter_placement  # noqa: F401
from repro_torch.core.policies import cache_aware  # noqa: F401
from repro_torch.core.policies import cache_aware_gossip  # noqa: F401
from repro_torch.core.policies import migration  # noqa: F401
from repro_torch.core.policies import placement  # noqa: F401
from repro_torch.core.policies import routing  # noqa: F401
from repro_torch.core.policies import scaling  # noqa: F401
