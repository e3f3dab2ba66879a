"""Cluster-scale experiment in one command: route a multi-tenant trace
through the routing plane and compare harli co-location against a
separate-fleet deployment on cluster goodput (DistServe's SLO-attaining
throughput), QoS attainment and finetune throughput.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sim \
        [--scenario spike] [--duration 60] [--rps 10] [--instances 2] \
        [--policy predicted_latency] [--prefill-mode pooled] \
        [--prefill-workers 2] [--chunk-budget 256] [--sessions 32] \
        [--prefix-cache-chunks 16] [--gossip-period 2] [--no-autoscale] \
        [--churn-rate 2 --churn-warning 5 --migration-bw 8 --ladder] \
        [--tenants 4 --adapters --adapter-policy affinity_packed]

or rerun a saved experiment exactly:

    PYTHONPATH=src python -m repro_torch.launch.cluster_sim \
        --spec examples/specs/spike_pooled.json

The port's counterpart of `examples/cluster_sim.py`, with its flags, its
validation errors and its output; it reads the saved specs of
`examples/specs/` unchanged (they are data). Every instance is priced by
`core/costmodel.py` on NVIDIA H100s with the constants fitted on the card
(`H100_CONSTANTS`): a spec's `sim.tp` (2 unless the spec or an
`instance_overrides` entry says otherwise) is the number of H100s one
instance spans. The numbers are the cost model's prediction, not a
measurement of the card.

Everything goes through ``ExperimentSpec`` (repro_torch.core.api): the CLI
flags build a spec, ``--spec file.json`` loads one, and either way
``spec.validate()`` rejects contradictory combinations (a chunk budget
in pooled mode, pool workers in chained mode, unknown policy names) with
the fix in the error message instead of silently ignoring the knob.
``--dump-spec out.json`` writes the flags back out as a spec file.

Three deployment modes (docs/cluster.md):
  * ``--prefill-mode chained``  — per-instance serialized prefill
  * ``--prefill-mode pooled``   — disaggregated prefill pool (default)
  * ``--prefill-mode chunked``  — prefill chunks mixed into decode rounds
    under a QoS-priced per-round token budget (no prefill tier at all);
    ``--fuse-quantum`` additionally lets chunk-carrying rounds run a
    reduced finetune quantum when the predictor prices both as fitting

``--prefill-workers 0`` still selects chained mode for backward
compatibility. ``--policy`` accepts any registered routing policy —
including plugins like ``cache_aware`` — via the control-plane registry.
With ``--sessions > 0`` every serving instance gets a session prefix
cache, so cache-aware routing (``session_affinity`` / ``cache_aware``)
shortens effective prefill on hits; ``--prefix-cache-chunks 0`` disables
it (the cache-less baseline). The cache is a cross-session radix
tree, so requests sharing a system prompt (``--scenario
shared_prefix``) hit each other's entries. ``--gossip-period`` turns on
the asynchronous cache-summary plane (``--gossip-staleness`` /
``--gossip-topk`` tune it) and ``--policy cache_aware_gossip`` routes
from those digests alone — zero synchronous cache peeks at dispatch.

``--tenants N`` splits the trace across N tenants (skewed harmonic
weights) with per-tenant attainment reporting; adding ``--adapters``
closes the finetune->serve loop — each tenant's colocated finetune job
publishes versioned LoRA adapters that decode instances hot-load on
demand (weight bytes charged to the unified allocator). ``--static-
adapters`` freezes publication at v1 (the static-deployment baseline).
"""

import argparse

from repro_torch.core.adapters import AdapterServingConfig, TenantConfig
from repro_torch.core.api import (ExperimentSpec, SpecError,
                                  available_policies, resolve_policy)
from repro_torch.core.autoscaler import AutoscalerConfig
from repro_torch.core.cluster import (ClusterConfig, DegradationConfig,
                                      KVMigrationConfig)
from repro_torch.core.gossip import GossipConfig
from repro_torch.core.prefill_pool import PrefillPoolConfig
from repro_torch.core.prefix_cache import PrefixCacheConfig
from repro_torch.core.router import RouterConfig
from repro_torch.core.simulator import ChunkedPrefillConfig, SimConfig
from repro_torch.serving.trace import FailureConfig, SCENARIOS, peak_rps


def build_spec(args, ap) -> ExperimentSpec:
    """Translate CLI flags into an ExperimentSpec, erroring loudly on
    contradictory combinations. Mode-gated flags default to None so an
    *explicit* flag is detectable even when its value equals the config
    default (--prefill-workers 2 with chained mode must error, not
    silently match PrefillPoolConfig()); ExperimentSpec.validate() stays
    the deeper net for spec files."""
    sessions_explicit = args.sessions is not None
    for name, default in CLI_DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, default)
    n_sessions = args.sessions
    policy_cls = resolve_policy("routing", args.policy)
    if n_sessions == 0 and not sessions_explicit \
            and getattr(policy_cls, "needs_sessions", False):
        # session-keyed policies (declared via RoutingPolicy.
        # needs_sessions, plugins included) get sessions by default; an
        # explicit --sessions 0 stays 0 — the user asked for the
        # sessionless baseline
        n_sessions = 32
    mode = args.prefill_mode
    workers = args.prefill_workers
    if mode is None:
        mode = "chained" if workers is not None and workers <= 0 \
            else "pooled"
    if mode == "pooled":
        if workers is not None and workers <= 0:
            ap.error("--prefill-mode pooled needs --prefill-workers >= 1 "
                     "(0 selects chained mode)")
        prefill = PrefillPoolConfig(
            n_workers=workers if workers is not None else 2,
            ordering=args.prefill_ordering or "edf")
    else:
        if workers is not None and workers > 0:
            ap.error(f"--prefill-workers only applies to --prefill-mode "
                     f"pooled (mode is {mode!r}; 0 selects chained)")
        if args.prefill_ordering is not None:
            ap.error(f"--prefill-ordering only applies to --prefill-mode "
                     f"pooled (mode is {mode!r})")
        prefill = None
    if mode != "chunked":
        if args.chunk_budget is not None:
            ap.error(f"--chunk-budget only applies to --prefill-mode "
                     f"chunked (mode is {mode!r})")
        if args.fuse_quantum:
            ap.error(f"--fuse-quantum only applies to --prefill-mode "
                     f"chunked (mode is {mode!r})")
    chunked = ChunkedPrefillConfig(
        budget_tokens=args.chunk_budget if args.chunk_budget is not None
        else 256,
        fuse_quantum=args.fuse_quantum)
    cache = PrefixCacheConfig(chunks=args.prefix_cache_chunks) \
        if n_sessions > 0 and args.prefix_cache_chunks > 0 else None
    if args.gossip_period is None:
        for flag, val in (("--gossip-staleness", args.gossip_staleness),
                          ("--gossip-topk", args.gossip_topk)):
            if val is not None:
                ap.error(f"{flag} only applies with --gossip-period "
                         "(the gossip plane is off without a publish "
                         "cadence)")
        # cache_aware_gossip cannot route without digests, so the policy
        # alone turns the plane on at its defaults
        gossip = GossipConfig() \
            if args.policy == "cache_aware_gossip" else None
    else:
        if cache is None:
            ap.error("--gossip-period needs a per-instance prefix cache "
                     "(--prefix-cache-chunks >= 1 with sessions); there "
                     "is nothing to gossip without one")
        base = GossipConfig()
        gossip = GossipConfig(
            period_s=args.gossip_period,
            staleness_bound_s=args.gossip_staleness
            if args.gossip_staleness is not None
            else 5.0 * args.gossip_period,
            top_k=args.gossip_topk
            if args.gossip_topk is not None else base.top_k)
    if args.churn_rate is None or args.churn_rate <= 0:
        for flag, val in (("--churn-warning", args.churn_warning),
                          ("--churn-checkpoint-interval",
                           args.churn_checkpoint_interval)):
            if val is not None:
                ap.error(f"{flag} only applies with --churn-rate > 0 "
                         "(the fleet is stable without it)")
        failures = None
    else:
        failures = FailureConfig(
            rate_per_min=args.churn_rate,
            warning_s=args.churn_warning
            if args.churn_warning is not None else 0.0,
            checkpoint_interval_s=args.churn_checkpoint_interval
            if args.churn_checkpoint_interval is not None else 20.0,
            seed=args.seed)
    if args.migration_bw is None:
        if args.migration_policy is not None:
            ap.error("--migration-policy only applies with --migration-bw "
                     "(live KV migration is off without a link)")
        migration = None
    else:
        if failures is None or failures.warning_s <= 0:
            ap.error("--migration-bw requires --churn-rate > 0 and "
                     "--churn-warning > 0 (migration only fires on "
                     "preemption warnings)")
        migration = KVMigrationConfig(
            bw_gbps=args.migration_bw,
            policy=args.migration_policy or "kv_headroom")
    if not args.ladder:
        for flag, val in (("--shed-viol-frac", args.shed_viol_frac),
                          ("--shed-backoff-base", args.shed_backoff_base),
                          ("--shed-max-retries", args.shed_max_retries)):
            if val is not None:
                ap.error(f"{flag} only applies with --ladder "
                         "(the degradation ladder is off without it)")
        degradation = None
    else:
        base = DegradationConfig()
        degradation = DegradationConfig(
            shed_viol_frac=args.shed_viol_frac
            if args.shed_viol_frac is not None else base.shed_viol_frac,
            backoff_base_s=args.shed_backoff_base
            if args.shed_backoff_base is not None else base.backoff_base_s,
            max_retries=args.shed_max_retries
            if args.shed_max_retries is not None else base.max_retries)
    if args.tenants is None or args.tenants <= 0:
        for flag, val in (("--adapter-rank", args.adapter_rank),
                          ("--adapter-publish-iters",
                           args.adapter_publish_iters),
                          ("--adapter-policy", args.adapter_policy)):
            if val is not None:
                ap.error(f"{flag} only applies with --tenants >= 1 and "
                         "--adapters")
        if args.adapters or args.static_adapters:
            ap.error("--adapters/--static-adapters require --tenants >= 1 "
                     "(adapters serve tenant traffic)")
        tenants = ()
        adapters = None
    else:
        # skewed harmonic mix: tenant i gets weight 1/(i+1), normalized
        w = [1.0 / (i + 1) for i in range(args.tenants)]
        tot = sum(w)
        tenants = tuple(TenantConfig(name=f"tenant{i}", weight=wi / tot)
                        for i, wi in enumerate(w))
        if not args.adapters and not args.static_adapters:
            for flag, val in (("--adapter-rank", args.adapter_rank),
                              ("--adapter-publish-iters",
                               args.adapter_publish_iters),
                              ("--adapter-policy", args.adapter_policy)):
                if val is not None:
                    ap.error(f"{flag} requires --adapters (tenants "
                             "without adapters serve the base model)")
            adapters = None
        else:
            adapters = AdapterServingConfig(
                rank=args.adapter_rank
                if args.adapter_rank is not None else 16,
                publish_every_iters=args.adapter_publish_iters
                if args.adapter_publish_iters is not None else 1.0,
                continuous=not args.static_adapters,
                policy=args.adapter_policy or "affinity_packed")
    return ExperimentSpec(
        name=f"{args.scenario}_{mode}_{args.policy}",
        inf_model=args.inf, ft_model=args.ft,
        scenario=args.scenario, duration_s=args.duration,
        mean_rps=args.rps, n_sessions=n_sessions, seed=args.seed,
        tenants=tenants,
        sim=SimConfig(mode="harli", qos_s=args.qos_ms / 1e3,
                      seed=args.seed + 2),
        cluster=ClusterConfig(
            n_initial=args.instances,
            autoscale=not args.no_autoscale,
            prefill_mode=mode,
            prefill=prefill,
            chunked=chunked,
            prefix_cache=cache,
            gossip=gossip,
            failures=failures,
            migration=migration,
            degradation=degradation,
            adapters=adapters,
            router=RouterConfig(policy=args.policy,
                                ttft_slo_s=args.ttft_slo,
                                tpot_slo_s=args.qos_ms / 1e3),
            autoscaler=AutoscalerConfig()))


def describe(spec: ExperimentSpec) -> str:
    cl = spec.cluster
    mode = cl.resolved_mode()
    if mode == "pooled":
        p = cl.prefill or PrefillPoolConfig()
        return f"pool({p.n_workers},{p.ordering})"
    if mode == "chunked":
        fused = "+fused-quantum" if cl.chunked.fuse_quantum else ""
        return f"chunked(budget={cl.chunked.budget_tokens}{fused})"
    return "per-instance chain"


CLI_DEFAULTS = dict(scenario="spike", duration=60.0, rps=10.0,
                    instances=2, policy="least_loaded", sessions=0,
                    prefix_cache_chunks=16, inf="llama3-8b",
                    ft="llama3-8b", qos_ms=40.0, ttft_slo=4.0, seed=0)


def main(argv=None):
    # experiment-shaping flags default to None (filled from CLI_DEFAULTS
    # in build_spec) so --spec can reject any explicit one: a spec file
    # runs as-is, and silently dropping a flag next to it would be the
    # ignored-knob bug class
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="run a saved ExperimentSpec JSON as-is (combine "
                         "only with --dump-spec; other flags error)")
    ap.add_argument("--dump-spec", default=None, metavar="FILE",
                    help="write the flag-built spec to FILE and exit")
    ap.add_argument("--scenario", default=None, choices=SCENARIOS)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--rps", type=float, default=None)
    ap.add_argument("--instances", type=int, default=None)
    ap.add_argument("--policy", default=None,
                    choices=available_policies("routing"))
    ap.add_argument("--prefill-mode", default=None,
                    choices=available_policies("prefill"),
                    help="deployment mode; default derives from "
                         "--prefill-workers (0 = chained, else pooled)")
    ap.add_argument("--prefill-workers", type=int, default=None,
                    help="initial prefill-pool size (pooled mode, default "
                         "2); 0 = chained mode")
    ap.add_argument("--prefill-ordering", default=None,
                    choices=("edf", "fifo"))
    ap.add_argument("--chunk-budget", type=int, default=None,
                    help="initial per-round prefill token budget "
                         "(chunked mode)")
    ap.add_argument("--fuse-quantum", action="store_true",
                    help="chunked mode: fuse a reduced finetune quantum "
                         "into chunk-carrying rounds when the predictor "
                         "prices both as fitting the round budget")
    ap.add_argument("--sessions", type=int, default=None,
                    help="sticky sessions in the trace "
                         "(session_affinity / cache_aware)")
    ap.add_argument("--prefix-cache-chunks", type=int, default=None,
                    help="per-instance session prefix cache capacity in "
                         "allocator chunks; 0 disables the cache")
    ap.add_argument("--gossip-period", type=float, default=None,
                    help="cache-digest publish cadence in seconds; turns "
                         "on the gossip plane (cache_aware_gossip turns "
                         "it on by itself at the defaults)")
    ap.add_argument("--gossip-staleness", type=float, default=None,
                    help="digest staleness bound in seconds (default "
                         "5x the period; requires --gossip-period)")
    ap.add_argument("--gossip-topk", type=int, default=None,
                    help="prefix fingerprints per digest (default 8, "
                         "clamped by the digest byte budget; requires "
                         "--gossip-period)")
    ap.add_argument("--inf", default=None)
    ap.add_argument("--ft", default=None)
    ap.add_argument("--qos-ms", type=float, default=None)
    ap.add_argument("--ttft-slo", type=float, default=None)
    ap.add_argument("--churn-rate", type=float, default=None,
                    help="instance failures per minute (Poisson, seeded); "
                         "0 or unset = stable fleet")
    ap.add_argument("--churn-warning", type=float, default=None,
                    help="spot-style preemption warning in seconds; 0 = "
                         "hard kills (requires --churn-rate)")
    ap.add_argument("--churn-checkpoint-interval", type=float,
                    default=None,
                    help="finetune checkpoint cadence in seconds on "
                         "colocated instances (default 20; requires "
                         "--churn-rate)")
    ap.add_argument("--migration-bw", type=float, default=None,
                    help="live KV migration link bandwidth in GB/s "
                         "(requires --churn-rate > 0 and --churn-warning "
                         "> 0); unset = warned instances drain in place")
    ap.add_argument("--migration-policy", default=None,
                    choices=available_policies("migration"),
                    help="migration destination policy (default "
                         "kv_headroom; requires --migration-bw)")
    ap.add_argument("--ladder", action="store_true",
                    help="enable the overload degradation ladder "
                         "(finetune breaker -> load shedding -> "
                         "hard rejection)")
    ap.add_argument("--shed-viol-frac", type=float, default=None,
                    help="SLO-violation fraction that escalates the "
                         "ladder to load shedding (requires --ladder)")
    ap.add_argument("--shed-backoff-base", type=float, default=None,
                    help="first shed-retry backoff in seconds "
                         "(requires --ladder)")
    ap.add_argument("--shed-max-retries", type=int, default=None,
                    help="shed retries before hard rejection "
                         "(requires --ladder)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="split the trace across N tenants (skewed "
                         "harmonic weights) with per-tenant attainment "
                         "reporting; 0 or unset = single-tenant")
    ap.add_argument("--adapters", action="store_true",
                    help="serve a per-tenant LoRA adapter, continuously "
                         "republished from the colocated finetune jobs "
                         "(requires --tenants >= 1)")
    ap.add_argument("--static-adapters", action="store_true",
                    help="adapter serving with publication frozen at v1 "
                         "(the static-deployment baseline; implies "
                         "--adapters)")
    ap.add_argument("--adapter-rank", type=int, default=None,
                    help="LoRA rank of published adapters (default 16; "
                         "requires --adapters)")
    ap.add_argument("--adapter-publish-iters", type=float, default=None,
                    help="finetune iterations per adapter version "
                         "(default 1; requires --adapters)")
    ap.add_argument("--adapter-policy", default=None,
                    choices=available_policies("adapter_placement"),
                    help="adapter placement policy (default "
                         "affinity_packed; requires --adapters)")
    ap.add_argument("--no-autoscale", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    if args.spec is not None:
        explicit = [f"--{n.replace('_', '-')}" for n in
                    list(CLI_DEFAULTS) + ["prefill_mode",
                                          "prefill_workers",
                                          "prefill_ordering",
                                          "chunk_budget",
                                          "gossip_period",
                                          "gossip_staleness",
                                          "gossip_topk",
                                          "churn_rate",
                                          "churn_warning",
                                          "churn_checkpoint_interval",
                                          "migration_bw",
                                          "migration_policy",
                                          "shed_viol_frac",
                                          "shed_backoff_base",
                                          "shed_max_retries",
                                          "tenants",
                                          "adapter_rank",
                                          "adapter_publish_iters",
                                          "adapter_policy"]
                    if getattr(args, n) is not None]
        explicit += [f"--{n.replace('_', '-')}" for n in
                     ("fuse_quantum", "no_autoscale", "ladder",
                      "adapters", "static_adapters")
                     if getattr(args, n)]
        if explicit:
            ap.error(f"--spec runs the file as-is; drop "
                     f"{', '.join(explicit)} (edit the spec instead, or "
                     "build one from flags with --dump-spec)")
        try:
            spec = ExperimentSpec.load(args.spec)
            spec.validate()
        except (OSError, SpecError) as e:
            ap.error(str(e))
    else:
        spec = build_spec(args, ap)
        try:
            spec.validate()
        except SpecError as e:
            ap.error(str(e))
    if args.dump_spec is not None:
        spec.save(args.dump_spec)
        print(f"spec written to {args.dump_spec}")
        return

    cl = spec.cluster
    cache = cl.prefix_cache
    churn = ""
    if cl.gossip is not None:
        churn += f"  gossip={cl.gossip.period_s:g}s/" \
                 f"{cl.gossip.staleness_bound_s:g}s" \
                 f"(k={cl.gossip.effective_top_k()})"
    if cl.failures is not None:
        churn = f"  churn={cl.failures.rate_per_min:g}/min"
        if cl.failures.warning_s > 0:
            churn += f" (warn {cl.failures.warning_s:g}s)"
    if cl.migration is not None:
        churn += f"  migration={cl.migration.bw_gbps:g}GB/s" \
                 f"({cl.migration.policy})"
    if cl.degradation is not None:
        churn += "  ladder=on"
    if spec.tenants:
        churn += f"  tenants={len(spec.tenants)}"
        if cl.adapters is not None:
            mode_s = "continuous" if cl.adapters.continuous else "static"
            churn += f"  adapters={mode_s}({cl.adapters.policy})"
    probe = spec.requests()
    print(f"spec={spec.name}  scenario={spec.scenario}: {len(probe)} "
          f"requests over {spec.duration_s:.0f}s "
          f"(mean {len(probe)/spec.duration_s:.1f} rps, "
          f"peak {peak_rps(probe):.1f} rps)  fleet_0={cl.n_initial}  "
          f"policy={cl.router.policy}  prefill={describe(spec)}  "
          f"prefix_cache={'on' if cache else 'off'}  "
          f"autoscale={cl.autoscale}{churn}")
    print(f"SLOs: TTFT<={cl.router.ttft_slo_s:.1f}s "
          f"TPOT<={cl.router.tpot_slo_s*1e3:.0f}ms\n")

    mode = cl.resolved_mode()
    out = {}
    for sim_mode in ("separate", "harli"):
        res = spec.with_mode(sim_mode).run()
        out[sim_mode] = res
        s = res.stats
        acts = [d for d in res.decisions if d.action != "none"]
        print(f"{sim_mode:9s} goodput={s.goodput:6.2f} req/s  "
              f"throughput={s.throughput:6.2f} req/s  "
              f"SLO-attain={s.slo_attainment*100:5.1f}%")
        print(f"{'':9s} TTFT-attain={s.ttft_attainment*100:5.1f}% "
              f"TPOT-attain={s.tpot_attainment*100:5.1f}% "
              f"rejected={s.rejected}  "
              f"QoS-violations={res.qos_violation_frac*100:5.2f}%")
        if cl.failures is not None:
            print(f"{'':9s} churn: {res.failures} kills "
                  f"({res.preemptions} warned), {res.requeued_requests} "
                  f"requeued ({res.requeue_rejected} rejected), "
                  f"ft-iters lost {res.ft_lost_iterations:.1f}, "
                  f"ckpt-commits {res.checkpoint_commits}")
        if cl.migration is not None:
            print(f"{'':9s} migration: {res.migrated_requests} live-"
                  f"migrated ({res.migrated_kv_tokens} KV tokens "
                  f"shipped), {res.migration_reprefills} re-prefilled "
                  f"after losing the race")
        if cl.degradation is not None:
            print(f"{'':9s} ladder: peak level {res.ladder_peak}, "
                  f"{res.breaker_epochs} breaker epochs / "
                  f"{res.shed_epochs} shed epochs, {res.shed_requests} "
                  f"shed ({res.shed_rejected} hard-rejected)")
        if mode != "chained":
            print(f"{'':9s} TTFT p99={s.ttft_p99:5.2f}s = "
                  f"queue {s.ttft_queue_p99:.2f} + "
                  f"prefill {s.ttft_prefill_p99:.2f} + "
                  f"decode-wait {s.ttft_decode_wait_p99:.2f} (stage p99s)",
                  end="")
            if mode == "pooled":
                print(f"  prefill-pool={res.final_prefill} final / "
                      f"{res.peak_prefill} peak")
            else:
                print(f"  chunk-budget={res.final_chunk_budget} final")
        if cache is not None:
            tot = res.prefix_hits + res.prefix_misses
            print(f"{'':9s} prefix-cache: {res.prefix_hits}/{tot} hits, "
                  f"{res.prefix_hit_tokens} prefill tokens saved "
                  f"({res.prefix_shared_hit_tokens} cross-session)")
        if cl.gossip is not None:
            print(f"{'':9s} gossip: {res.gossip_published} digests "
                  f"({res.gossip_bytes}B) published, "
                  f"{res.dispatch_peeks} sync peeks at dispatch, "
                  f"{res.gossip_stale_discards} stale discards, "
                  f"max used age {res.gossip_max_used_age:.1f}s")
        if cl.adapters is not None:
            print(f"{'':9s} adapters: {res.adapter_loads} hot-loads "
                  f"({res.adapter_evictions} evicted, "
                  f"{res.adapter_load_failures} fell back to base), "
                  f"{res.adapter_load_time_s:.2f}s total swap time, "
                  f"versions {res.adapter_versions_published} published "
                  f"/ {res.adapter_versions_served} served")
        if spec.tenants and s.tenants:
            for tid in sorted(s.tenants):
                tn = s.tenants[tid]
                name = spec.tenants[tid].name \
                    if tid < len(spec.tenants) else f"tenant{tid}"
                print(f"{'':9s} [{name:>8s}] offered={tn.offered:4d} "
                      f"attained={tn.attained:4d} "
                      f"TTFT-att={tn.ttft_attainment*100:5.1f}% "
                      f"TPOT-att={tn.tpot_attainment*100:5.1f}% "
                      f"TTFT-p99={tn.ttft_p99:5.2f}s "
                      f"versions={tn.versions_served}")
        print(f"{'':9s} ft_throughput={res.ft_throughput:6.2f} "
              f"(iters/s x batch)  fleet={res.final_fleet} final / "
              f"{res.peak_fleet} peak  scale-actions={len(acts)} "
              f"{[d.action for d in acts]}\n")

    h, s = out["harli"], out["separate"]
    if s.ft_throughput > 0:
        print(f"harli/separate finetune throughput: "
              f"{h.ft_throughput / s.ft_throughput:.2f}x at "
              f"{h.stats.goodput / max(s.stats.goodput, 1e-9):.2f}x goodput")
    return out


if __name__ == "__main__":
    main()
