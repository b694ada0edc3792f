"""CLI entry point of the PyTorch/CUDA port — the port of
``tpu_scheduler/cli.py``: the same parser and flag names, with
``--backend={cuda,cuda-sharded}`` and ``--device={cuda,cpu}``.

The cluster is the in-process fake API server loaded with a synthetic
workload, or a Kubernetes-style API server over HTTP (``--api-server URL``
with ``--api-token``, or ``--kubeconfig [PATH]``).  Run on the card:

    python -m tpu_scheduler_torch.cli --nodes 1000 --pods 10000
    python -m tpu_scheduler_torch.cli --kubeconfig ~/.kube/config --http-port 8080

and on the CPU, through the kernels' plain torch versions, only when asked:

    python -m tpu_scheduler_torch.cli --device cpu --nodes 50 --pods 200

Prints one JSON metrics line per cycle and a final summary line.  Cycles
run through the delta engine unless ``--no-delta``; ``--checkpoint-dir``
restores scheduler-local state at start and saves it at exit.  There is
no fallback: without CUDA, ``--device cuda`` fails with the backend's
``BackendUnavailable`` before any cycle.  Flags whose subsystem waits for
a later item of the port (ROADMAP Queue 1) exit 2 naming the item.

``sim`` runs the simulator (``sim/cli.py``):

    python -m tpu_scheduler_torch.cli sim --scenario sim-smoke --seed 0
    python -m tpu_scheduler_torch.cli sim --device cpu --scenario sim-smoke
"""

from __future__ import annotations

import argparse
import json
import sys

from .errors import BackendUnavailable
from .models.profiles import PROFILES
from .runtime.controller import ATTEMPTS, REQUEUE_SECONDS, Scheduler
from .runtime.fake_api import FakeApiServer
from .testing import synth_cluster
from .utils.tracing import configure_logging

# The CLI's mixed workload: every feature of the scheduler in one cluster.
MIXED_WORKLOAD = dict(
    selector_fraction=0.25,
    anti_affinity_fraction=0.1,
    spread_fraction=0.1,
    tainted_fraction=0.15,
    node_affinity_fraction=0.15,
    soft_taint_fraction=0.15,
    preferred_affinity_fraction=0.15,
    schedule_anyway_fraction=0.1,
    gang_fraction=0.1,
    pod_affinity_fraction=0.1,
    preferred_pod_affinity_fraction=0.15,
    extended_fraction=0.15,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-scheduler-torch", description=__doc__)
    p.add_argument(
        "--backend",
        choices=["cuda", "cuda-sharded"],
        default="cuda",
        help="scheduling backend; cuda-sharded runs the cycle over a dp×tp device mesh",
    )
    p.add_argument("--tp", type=int, default=None, help="cuda-sharded: tensor-parallel (nodes-axis) mesh width; dp gets the rest of the devices")
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the backend runs: the card (default; no fallback) or, when asked, the CPU through the "
        "kernels' plain torch versions",
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process meshes (not ported yet: ROADMAP Queue 1 item 7)",
    )
    p.add_argument("--policy", choices=["batch", "sample"], default="batch", help="batched cycle vs reference-style per-pod random sampling")
    p.add_argument("--profile", choices=sorted(PROFILES), default="default", help="scoring profile")
    p.add_argument(
        "--profile-file",
        default=None,
        metavar="PATH",
        help="load the scoring profile from a tuned-profile JSON artifact (learn/profiles schema; "
        "overrides --profile; --driver/--max-rounds/--pool-key/--preemption still apply on top)",
    )
    p.add_argument(
        "--driver",
        choices=["auto", "monolithic", "epochs"],
        default=None,
        help="auction driver override (profiles.SchedulingProfile.driver); the port runs one eager driver for every value",
    )
    p.add_argument("--max-rounds", type=int, default=None, help="auction round cap override (profiles default: 32)")
    p.add_argument("--leader-elect", action="store_true", help="lease-based leader election: only the lease holder schedules; standbys keep caches warm and take over on leader loss")
    p.add_argument("--lease-name", default="tpu-scheduler", help="leader-election lease name")
    p.add_argument("--lease-duration", type=float, default=15.0, help="lease TTL (seconds) — the leader lease, or each shard lease with --shards")
    p.add_argument("--identity", default=None, help="leader-election holder identity (default: derived from pid)")
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="active-active sharded control plane: partition the pending set into K stable-hash shards, each owned "
        "via its own tpu-scheduler-shard-<i> lease — run several replicas with the same K and they split the shards; "
        "supersedes --leader-elect (runtime/shards.py)",
    )
    p.add_argument(
        "--replica-id",
        default=None,
        help="this replica's identity for shard-lease ownership (default: --identity, then pid-derived)",
    )
    p.add_argument(
        "--preemption",
        action="store_true",
        help="evict strictly-lower-priority pods when a cycle leaves higher-priority pods resource-starved (kube PostFilter)",
    )
    p.add_argument(
        "--pool-key",
        default=None,
        help="node label partitioning the cluster into per-pool scheduling shards (expert-parallel routing; pods pinning the label route to their pool's shard)",
    )
    p.add_argument(
        "--topology-file",
        default=None,
        help="JSON interconnect-topology spec (levels + optional node->domain map, topology/model.py) for "
        "rank-aware gang co-placement; default: auto-detect from the topology.tpu-scheduler/{slice,rack} node labels",
    )
    p.add_argument(
        "--no-topology",
        action="store_true",
        help="disable topology-aware gang scoring even when nodes carry topology labels",
    )
    p.add_argument("--nodes", type=int, default=100, help="synthetic cluster: node count")
    p.add_argument("--pods", type=int, default=1000, help="synthetic cluster: pending pods")
    p.add_argument("--bound-pods", type=int, default=0, help="synthetic cluster: pre-bound pods")
    p.add_argument("--seed", type=int, default=0, help="synthetic cluster seed")
    p.add_argument(
        "--workload",
        default="plain",
        choices=["plain", "mixed"],
        help="synthetic workload shape: 'mixed' exercises the full feature surface "
        "(selectors, taints, node+pod affinity hard+soft, spread, gangs, extended TPU-chip requests)",
    )
    p.add_argument("--cycles", type=int, default=None, help="max scheduling cycles (default: run until settled)")
    p.add_argument("--daemon", action="store_true", help="serve forever: never exit on settle, idle between cycles (reference main.rs:146-149)")
    p.add_argument(
        "--pipeline",
        action="store_true",
        help="overlap binding POSTs with the next cycle's pack+solve via an assumed-bindings cache (host<->device pipelining; plain unconstrained cycles — routed/constrained cycles bind synchronously)",
    )
    p.add_argument("--interval", type=float, default=1.0, help="daemon mode: idle sleep between settled cycles (seconds)")
    p.add_argument("--attempts", type=int, default=ATTEMPTS, help="sample policy: candidates per pod (reference ATTEMPTS)")
    p.add_argument(
        "--requeue-seconds",
        type=float,
        default=REQUEUE_SECONDS,
        help="failed-pod backoff base: per-failure-class exponential delays scale on it (runtime/resilience.py); 0 retries immediately",
    )
    p.add_argument(
        "--breaker-open-seconds",
        type=float,
        default=5.0,
        help="circuit breaker: first open window after tripping (escalates x2 while probes fail, capped at 60s)",
    )
    p.add_argument(
        "--breaker-window",
        type=int,
        default=20,
        help="circuit breaker: rolling bind/watch outcome window the failure ratio trips on",
    )
    p.add_argument(
        "--no-breaker",
        action="store_true",
        help="disable the API circuit breaker (every bind POSTs immediately, brownout or not)",
    )
    p.add_argument(
        "--flush-capacity",
        type=int,
        default=4096,
        help="degraded mode: max binding POSTs deferred while the breaker is open (overflow requeues instead)",
    )
    p.add_argument(
        "--no-delta",
        action="store_true",
        help="disable the incremental delta-scheduling engine: every cycle runs the classic full-wave pack+solve",
    )
    p.add_argument(
        "--rebalance",
        action="store_true",
        help="enable the background rebalancer (rebalance/): a cadence-gated packing solve on a "
        "worker thread proposing bounded defragmentation migration batches (unbind -> cordon -> delta re-place)",
    )
    p.add_argument(
        "--rebalance-every",
        type=int,
        default=8,
        metavar="CYCLES",
        help="rebalancer cadence: cycles between background ticks (with --rebalance)",
    )
    p.add_argument(
        "--rebalance-batch",
        type=int,
        default=8,
        metavar="N",
        help="max migrations issued per rebalancer tick (whole-node drain groups; with --rebalance)",
    )
    p.add_argument(
        "--autoscale",
        action="store_true",
        help="enable the closed-loop autoscaler (autoscale/) against the simulated cloud provider: "
        "cost-aware SKU packing on SLO burn, scale-down through the drain protocol (synthetic cluster only)",
    )
    p.add_argument(
        "--catalog-file",
        default=None,
        metavar="PATH",
        help="JSON SKU catalog for --autoscale (name/cpu/mem_gi/hourly_cost/quota/provision_s/...); default: built-in catalog",
    )
    p.add_argument("--log-level", default="INFO")
    p.add_argument(
        "--log-format",
        choices=["text", "json"],
        default="text",
        help="log line format: 'json' emits one machine-parseable JSON object per line (ts, level, logger, msg, cycle)",
    )
    p.add_argument(
        "--events-buffer",
        type=int,
        default=4096,
        help="flight recorder capacity (max pod timelines retained for the /debug routes); 0 disables recording",
    )
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler Chrome trace of the cycles here")
    p.add_argument("--checkpoint-dir", default=None, help="restore scheduler-local state from / save it to this directory")
    p.add_argument("--http-port", type=int, default=None, help="serve /metrics, /healthz, /debug/* (and, for the in-process cluster, the k8s REST routes) on this port")
    p.add_argument("--api-server", default=None, help="schedule against a remote k8s-style REST endpoint instead of the in-process cluster")
    p.add_argument("--api-token", default=None, help="bearer token for --api-server")
    p.add_argument(
        "--kubeconfig",
        default=None,
        help="schedule against a real cluster: kubeconfig path (bare flag = $KUBECONFIG -> ~/.kube/config -> in-cluster serviceaccount)",
        nargs="?",
        const="",
    )
    p.add_argument("--kube-context", default=None, help="kubeconfig context to use (default: current-context)")
    p.add_argument(
        "--allow-exec-auth",
        action="store_true",
        help="allow kubeconfig exec: credential plugins (spawns the configured helper binary; off by default)",
    )
    return p


def unported_flags(args) -> list[str]:
    """The given flags whose subsystem is not ported yet, each with its
    ROADMAP Queue 1 item."""
    asked = [
        ("--distributed", args.distributed, "7"),
    ]
    return [f"{flag} (ROADMAP Queue 1 item {item})" for flag, on, item in asked if on]


def make_cli_backend(args):
    """The backend the flags ask for, on the card unless ``--device cpu``."""
    import torch

    if args.backend == "cuda-sharded":
        from .parallel.mesh import make_mesh
        from .parallel.sharded import ShardedBackend

        if args.device == "cpu":
            # Eight virtual CPU devices, as the JAX package's test harness.
            return ShardedBackend(mesh=make_mesh([torch.device("cpu")] * 8, tp=args.tp))
        return ShardedBackend(tp=args.tp)
    from .backends.cuda import CudaBackend

    return CudaBackend(device=args.device)


def make_api(args):
    """The cluster the flags name: a kubeconfig's (``Client::try_default()``
    resolution), an ``--api-server`` endpoint, or the synthetic one."""
    if args.kubeconfig is not None:
        from .runtime.http_api import RemoteApiAdapter
        from .runtime.kubeconfig import client_from_kubeconfig

        return RemoteApiAdapter(
            client_from_kubeconfig(args.kubeconfig or None, context=args.kube_context, allow_exec=args.allow_exec_auth)
        )
    if args.api_server:
        from .runtime.http_api import KubeApiClient, RemoteApiAdapter

        return RemoteApiAdapter(KubeApiClient(args.api_server, token=args.api_token))
    return synthetic_api(args)


def synthetic_api(args) -> FakeApiServer:
    """The in-process API server loaded with the synthetic cluster the
    flags describe."""
    api = FakeApiServer()
    snap = synth_cluster(
        n_nodes=args.nodes,
        n_pending=args.pods,
        n_bound=args.bound_pods,
        seed=args.seed,
        **(MIXED_WORKLOAD if args.workload == "mixed" else {}),
    )
    api.load(snap.nodes, snap.pods)
    return api


def make_scheduler(args, api, backend) -> Scheduler:
    """The Scheduler the flags describe, over ``api`` and ``backend``."""
    if args.profile_file:
        from .models.profiles import SchedulingProfile

        profile = SchedulingProfile.from_file(args.profile_file)
    else:
        profile = PROFILES[args.profile]
    if args.driver is not None:
        profile = profile.with_(driver=args.driver)
    if args.max_rounds is not None:
        profile = profile.with_(max_rounds=args.max_rounds)
    if args.pool_key:
        profile = profile.with_(pool_key=args.pool_key)
    if args.preemption:
        profile = profile.with_(preemption=True)
    from .runtime.resilience import BreakerConfig

    breaker_config = BreakerConfig(
        window=args.breaker_window,
        open_seconds=args.breaker_open_seconds,
        # A ratio above 1 can never be reached: --no-breaker keeps the
        # machinery (metrics) but never trips it.
        failure_ratio=2.0 if args.no_breaker else BreakerConfig.failure_ratio,
    )
    if args.no_topology:
        topology = None
    elif args.topology_file:
        from .topology.model import load_topology_file

        topology = load_topology_file(args.topology_file)
    else:
        topology = "auto"
    rebalance_cfg = None
    if args.rebalance:
        from .rebalance import RebalanceConfig

        # Daemon mode runs the packing solve on a worker thread so the
        # background tier stays off the cycle critical path.
        rebalance_cfg = RebalanceConfig(every=args.rebalance_every, batch=args.rebalance_batch, background=True)
    autoscale_cfg = None
    autoscale_provider = None
    if args.autoscale:
        if args.api_server or args.kubeconfig is not None:
            # The simulated provider joins nodes through the in-process
            # apiserver; a remote cluster owns its own node lifecycle.
            print(json.dumps({"autoscale": False, "reason": "remote cluster"}), file=sys.stderr)
        else:
            import random
            import time

            from .autoscale import DEFAULT_CATALOG, AutoscaleConfig, SimCloudProvider, load_catalog

            catalog = load_catalog(args.catalog_file) if args.catalog_file else DEFAULT_CATALOG
            autoscale_provider = SimCloudProvider(
                api, clock=time.monotonic, rng=random.Random(args.seed), catalog=catalog
            )
            # Daemon mode plans the catalog what-if on a worker thread so
            # the elastic tier stays off the cycle critical path.
            autoscale_cfg = AutoscaleConfig(background=True)
    return Scheduler(
        api,
        backend,
        profile=profile,
        policy=args.policy,
        topology=topology,
        attempts=args.attempts,
        requeue_seconds=args.requeue_seconds,
        pipeline=args.pipeline,
        leader_elect=args.leader_elect,
        identity=args.replica_id or args.identity,
        lease_name=args.lease_name,
        lease_duration=args.lease_duration,
        shards=args.shards,
        events_buffer=args.events_buffer,
        breaker_config=breaker_config,
        flush_capacity=args.flush_capacity,
        delta=not args.no_delta,
        rebalance=rebalance_cfg,
        autoscale=autoscale_cfg,
        autoscale_provider=autoscale_provider,
    )


def start_http(args, api, sched):
    """The ``--http-port`` server: metrics, health and the debug routes, and
    the cluster routes when the cluster is the in-process one (a remote API
    server owns its cluster state)."""
    from .runtime.http_api import HttpApiServer
    from .utils.profiler import ReplicaLatencyRegistry, ReplicaProfileRegistry

    local_api = None if (args.api_server or args.kubeconfig is not None) else api
    # /debug/profile and /debug/latency serve through replica registries so
    # multi-replica deployments can aggregate (?replica= selects); a single
    # replica registers just itself.
    profile_registry = ReplicaProfileRegistry()
    profile_registry.register(sched.identity, sched.profile_snapshot)
    latency_registry = ReplicaLatencyRegistry()
    latency_registry.register(sched.identity, sched.latency_snapshot)
    return HttpApiServer(
        local_api,
        metrics=sched.metrics,
        recorder=sched.recorder,
        resilience=sched.resilience_snapshot,
        shards=sched.shards_snapshot,
        profile=profile_registry.snapshot,
        pending_ages=sched.pending_age_debug,
        rebalance=sched.rebalance_snapshot if sched.rebalancer is not None else None,
        autoscale=sched.autoscale_snapshot if sched.autoscaler is not None else None,
        latency=latency_registry.snapshot,
        port=args.http_port,
    ).start()


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "sim":
        # The simulator (sim/): python -m tpu_scheduler_torch.cli sim
        # --scenario NAME --seed N [--device cpu].
        from .sim.cli import main as sim_main

        return sim_main(argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    refused = unported_flags(args)
    if refused:
        parser.error("not ported yet: " + ", ".join(refused))
    configure_logging(args.log_level, args.log_format)

    from .utils.gc_tuning import enable_daemon_gc_tuning

    enable_daemon_gc_tuning()
    try:
        backend = make_cli_backend(args)
    except BackendUnavailable as e:
        print(f"tpu-scheduler-torch: {e}", file=sys.stderr)
        return 1

    api = make_api(args)
    sched = make_scheduler(args, api, backend)
    if args.profile_dir:
        sched.recorder.device_trace_dir = args.profile_dir

    if args.checkpoint_dir:
        from .runtime.checkpoint import restore_scheduler

        restore_scheduler(sched, args.checkpoint_dir)
    # Counters restored from a checkpoint are all-time totals; remember the
    # starting point so the summary line reports *this run's* work.
    counters_at_start = sched.metrics.snapshot()

    http_server = None
    if args.http_port is not None:
        http_server = start_http(args, api, sched)
        print(json.dumps({"http": True, "url": http_server.base_url}), file=sys.stderr)

    from .utils.tracing import device_profile

    try:
        with device_profile(args.profile_dir):
            if args.daemon:
                try:
                    metrics = sched.run(max_cycles=args.cycles, daemon_interval=args.interval)
                except KeyboardInterrupt:
                    metrics = []  # per-cycle history not kept in daemon mode; counters survive below
            else:
                metrics = sched.run(max_cycles=args.cycles, until_settled=args.cycles is None)
    except BackendUnavailable as e:
        print(f"tpu-scheduler-torch: {e}", file=sys.stderr)
        return 1
    finally:
        if args.checkpoint_dir:
            from .runtime.checkpoint import save_scheduler

            save_scheduler(sched, args.checkpoint_dir)
        if http_server is not None:
            http_server.stop()
        sched.close()  # drain in-flight pipelined binds, stop the worker

    for m in metrics:
        print(m.to_json())
    counters = sched.metrics.snapshot()
    # In daemon mode the per-cycle history is truncated (and empty after a
    # Ctrl-C), so this run's totals come from counter deltas vs startup
    # (checkpoint restore pre-loads all-time totals).
    run_total = lambda name: counters.get(name, 0) - counters_at_start.get(name, 0)  # noqa: E731
    summary = {
        "summary": True,
        "backend": args.backend,
        "device": args.device,
        "policy": args.policy,
        "cycles": run_total("scheduler_cycles_total"),
        "bound_total": run_total("scheduler_pods_bound_total"),
        "unschedulable_last": metrics[-1].unschedulable if metrics else 0,
        "counters": counters,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
