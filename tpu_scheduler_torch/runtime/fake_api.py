"""In-memory Kubernetes-style API server.

The reference can only run against a real cluster (``src/main.rs:130``,
``README.md:27-28``) and its API-dependent predicate was therefore untestable
(SURVEY.md §4 — the unused mockall deps).  This fake server delivers what the
reference merely *intended*: full watch/list/bind semantics in-process, so the
whole control loop is exercised by unit tests and synthetic benchmarks.

Capabilities (matching what the reference consumes from kube):
  • typed stores of Nodes and Pods with resourceVersion bookkeeping
  • watch streams with ADDED/MODIFIED/DELETED events and field selectors
    (``status.phase=Pending`` — main.rs:141-142; ``spec.nodeName=X`` —
    predicates.rs:22-26)
  • list with the same field selectors
  • the Binding subresource (main.rs:94-109): sets ``spec.nodeName``, flips
    phase to Running (standing in for the kubelet), 409s on conflicts
  • fault injection for the error paths (CreateBindingFailed → requeue)

Port: a copy of ``tpu_scheduler/runtime/fake_api.py``, unchanged (lease methods included).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Iterable

from ..api.objects import Node, ObjectReference, Pod, is_pod_bound
from ..errors import CreateBindingFailed

__all__ = ["ApiError", "WatchEvent", "Watch", "FakeApiServer"]


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


@dataclass(frozen=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Pod | Node


def _evolve(obj, **changes):
    """``dataclasses.replace`` for the binding hot path: a shallow
    ``__dict__`` copy plus the changed fields — same replace-don't-mutate
    result (a NEW object, the old one untouched) without re-walking every
    field through getattr/__init__.  Safe here because these API objects
    are plain dataclasses with no __post_init__/InitVar logic."""
    new = object.__new__(type(obj))
    new.__dict__.update(obj.__dict__)
    new.__dict__.update(changes)
    return new


def _field_selector_fn(selector: str | None) -> Callable[[Pod | Node], bool]:
    """Supports the two k8s field-selector shapes the reference uses."""
    if not selector:
        return lambda obj: True

    clauses = []
    for part in selector.split(","):
        path, _, want = part.partition("=")
        path = path.strip()
        want = want.strip()
        if path == "status.phase":
            clauses.append(lambda o, w=want: getattr(o.status, "phase", None) == w)
        elif path == "spec.nodeName":
            clauses.append(lambda o, w=want: o.spec is not None and o.spec.node_name == w)
        elif path == "metadata.name":
            clauses.append(lambda o, w=want: o.metadata.name == w)
        else:
            raise ApiError(400, f"unsupported field selector {path!r}")
    return lambda obj: all(c(obj) for c in clauses)


class Watch:
    """A subscription to a kind's event stream (the reflector's feed)."""

    def __init__(self, server: "FakeApiServer", kind: str, selector: str | None):
        self._server = server
        self._kind = kind
        self._match = _field_selector_fn(selector)
        self._queue: deque[WatchEvent] = deque()  # guarded-by: _server._lock

    def _offer(self, event: WatchEvent) -> None:  # holds-lock: _server._lock
        if self._match(event.object):
            self._queue.append(event)

    def poll(self) -> list[WatchEvent]:
        """Drain currently-queued events (non-blocking)."""
        with self._server._lock:
            out = list(self._queue)
            self._queue.clear()
        return out

    def close(self) -> None:
        with self._server._lock:
            self._server._watches[self._kind].discard(self)


class FakeApiServer:
    def __init__(self, watch_history: int = 1 << 18, clock=None):
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}  # guarded-by: _lock
        self._pods: dict[tuple[str, str], Pod] = {}  # guarded-by: _lock — (namespace, name)
        self._pdbs: dict[str, object] = {}  # guarded-by: _lock — "ns/name" -> PodDisruptionBudget
        self._rv = 0  # guarded-by: _lock
        self._watches: dict[str, set[Watch]] = {"Node": set(), "Pod": set()}  # guarded-by: _lock
        # Bounded event history for resourceVersion-based incremental watch
        # (the HTTP boundary's ``?watch=true&resourceVersion=N`` long-poll):
        # (rv, kind, event, prev_object), rv strictly increasing.  A list
        # (not a deque) so watch_since can bisect straight to the suffix
        # after rv — O(log n + delta) per poll, not O(history).  A client
        # whose rv has been evicted gets 410 Gone and relists — the kube
        # watch-cache contract.
        self._events_log: list[tuple[int, str, WatchEvent, Pod | Node | None]] = []  # guarded-by: _lock
        self._watch_history = watch_history
        self._events_cv = threading.Condition(self._lock)
        # Leader-election Leases (coordination.k8s.io/v1): (namespace, name)
        # -> kube-shaped Lease dict.  The server only stores and CASes on
        # metadata.resourceVersion; leadership is decided CLIENT-side from
        # spec.renewTime + leaseDurationSeconds (client-go semantics,
        # runtime/lease.py).
        self._leases: dict[tuple[str, str], dict] = {}  # guarded-by: _lock
        # Every lease WRITE in commit order: (name, holderIdentity-after) —
        # "" marks a release.  The renew-vs-release shutdown race regression
        # test reads this to prove no renewal lands after the release.
        self.lease_history: list[tuple[str, str]] = []  # guarded-by: _lock
        # Fault injection: number of upcoming binding calls to fail with 500.
        self.fail_next_bindings = 0
        self.binding_count = 0

    # -- internals ---------------------------------------------------------

    def _emit(self, kind: str, event: WatchEvent, prev: Pod | Node | None = None, rv: int | None = None) -> None:  # holds-lock: _lock
        if rv is None:
            rv = event.object.metadata.resource_version or self._rv
        self._events_log.append((rv, kind, event, prev))
        if len(self._events_log) >= 2 * self._watch_history:
            # Trim in halves — amortized O(1) per append.
            del self._events_log[: len(self._events_log) - self._watch_history]
        for w in self._watches[kind]:
            w._offer(event)
        self._events_cv.notify_all()

    def _bump(self, obj: Pod | Node) -> None:  # holds-lock: _lock
        self._rv += 1
        obj.metadata.resource_version = self._rv

    @property
    def latest_rv(self) -> int:
        with self._lock:
            return self._rv

    def watch_since(
        self, kind: str, rv: int, field_selector: str | None = None, timeout: float = 0.0
    ) -> tuple[list[WatchEvent], int]:
        """Events of ``kind`` with resourceVersion > ``rv`` (the incremental
        watch the reference's kube watcher provides, ``main.rs:135``).

        Long-polls up to ``timeout`` seconds when nothing is pending.  An
        object whose update leaves the field selector emits DELETED (kube
        semantics).  Raises ``ApiError(410)`` when ``rv`` predates the
        retained history — the client's cue to relist.
        """
        import bisect

        match = _field_selector_fn(field_selector)
        deadline = time.monotonic() + timeout
        with self._events_cv:
            while True:
                oldest = self._events_log[0][0] if self._events_log else self._rv + 1
                if rv < oldest - 1:
                    raise ApiError(410, f"resourceVersion {rv} too old (oldest retained {oldest - 1})")
                start = bisect.bisect_right(self._events_log, rv, key=lambda e: e[0])
                out: list[WatchEvent] = []
                for erv, k, ev, prev in self._events_log[start:]:
                    if k != kind:
                        continue
                    if match(ev.object):
                        out.append(ev)
                    elif prev is not None and match(prev):
                        out.append(WatchEvent("DELETED", ev.object))
                if out or timeout <= 0:
                    return out, self._rv
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], self._rv
                self._events_cv.wait(remaining)

    @staticmethod
    def _pod_key(pod: Pod) -> tuple[str, str]:
        return (pod.metadata.namespace or "default", pod.metadata.name)

    # -- nodes -------------------------------------------------------------

    def create_node(self, node: Node) -> None:
        with self._lock:
            if node.name in self._nodes:
                raise ApiError(409, f"node {node.name} exists")
            self._bump(node)
            self._nodes[node.name] = node
            self._emit("Node", WatchEvent("ADDED", node))

    def update_node(self, node: Node) -> None:
        with self._lock:
            prev = self._nodes.get(node.name)
            if prev is None:
                raise ApiError(404, f"node {node.name} not found")
            self._bump(node)
            self._nodes[node.name] = node
            self._emit("Node", WatchEvent("MODIFIED", node), prev=prev)

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is None:
                raise ApiError(404, f"node {name} not found")
            self._rv += 1  # deletion is an rv-advancing event (kube semantics)
            self._emit("Node", WatchEvent("DELETED", node), rv=self._rv)

    def list_nodes(self) -> list[Node]:
        with self._lock:
            return list(self._nodes.values())

    def list_nodes_with_rv(self) -> tuple[list[Node], int]:
        """(nodes, resourceVersion) taken atomically — the watch-start token
        a lister needs: events after this rv are exactly what the list
        doesn't already reflect."""
        with self._lock:
            return list(self._nodes.values()), self._rv

    def watch_nodes(self, field_selector: str | None = None, send_initial: bool = True) -> Watch:
        with self._lock:
            w = Watch(self, "Node", field_selector)
            self._watches["Node"].add(w)
            if send_initial:
                for node in self._nodes.values():
                    w._offer(WatchEvent("ADDED", node))
            return w

    # -- pods --------------------------------------------------------------

    def create_pod(self, pod: Pod) -> None:
        with self._lock:
            key = self._pod_key(pod)
            if key in self._pods:
                raise ApiError(409, f"pod {key} exists")
            self._bump(pod)
            self._pods[key] = pod
            self._emit("Pod", WatchEvent("ADDED", pod))

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            pod = self._pods.pop((namespace, name), None)
            if pod is None:
                raise ApiError(404, f"pod {namespace}/{name} not found")
            self._rv += 1  # deletion is an rv-advancing event (kube semantics)
            self._emit("Pod", WatchEvent("DELETED", pod), rv=self._rv)

    def list_pods(self, field_selector: str | None = None) -> list[Pod]:
        match = _field_selector_fn(field_selector)
        with self._lock:
            return [p for p in self._pods.values() if match(p)]

    def list_pods_with_rv(self, field_selector: str | None = None) -> tuple[list[Pod], int]:
        """(pods, resourceVersion) taken atomically (see list_nodes_with_rv)."""
        match = _field_selector_fn(field_selector)
        with self._lock:
            return [p for p in self._pods.values() if match(p)], self._rv

    def watch_pods(self, field_selector: str | None = None, send_initial: bool = True) -> Watch:
        with self._lock:
            w = Watch(self, "Pod", field_selector)
            self._watches["Pod"].add(w)
            if send_initial:
                for pod in self._pods.values():
                    w._offer(WatchEvent("ADDED", pod))
            return w

    # -- binding subresource (main.rs:94-109) ------------------------------

    def create_binding(self, namespace: str, pod_name: str, target: ObjectReference) -> None:
        """POST /api/v1/namespaces/{ns}/pods/{name}/binding.

        Hot path of the e2e cycle: a 100k-pod wave issues 100k of these, so
        the object evolution uses ``_evolve`` (a ``__dict__``-copy twin of
        ``dataclasses.replace``, ~10x faster — replace re-walks every field
        via getattr) while keeping the replace-don't-mutate contract the
        identity-keyed pack memos rely on."""
        with self._lock:
            self.binding_count += 1
            if self.fail_next_bindings > 0:
                self.fail_next_bindings -= 1
                raise CreateBindingFailed(f"injected API failure binding {namespace}/{pod_name}")
            pod = self._pods.get((namespace, pod_name))
            if pod is None:
                raise ApiError(404, f"pod {namespace}/{pod_name} not found")
            if is_pod_bound(pod):
                raise ApiError(409, f"pod {namespace}/{pod_name} already bound")
            if target.name not in self._nodes:
                raise ApiError(404, f"node {target.name} not found")
            if pod.spec is not None:
                new_spec = _evolve(pod.spec, node_name=target.name)
            else:
                from ..api.objects import PodSpec

                new_spec = PodSpec(node_name=target.name)
            bound = _evolve(pod, spec=new_spec, status=_evolve(pod.status, phase="Running"))
            self._bump(bound)
            self._pods[(namespace, pod_name)] = bound
            self._emit("Pod", WatchEvent("MODIFIED", bound), prev=pod)

    def unbind_pod(self, namespace: str, pod_name: str, expect_node: str | None = None) -> None:
        """Deschedule: clear ``spec.nodeName`` and return the pod to
        Pending in ONE atomic call (the rebalancer's migration seam — a
        crash leaves the pod either bound or pending, never lost).

        ``expect_node`` is a CAS guard: when given, the pod must currently
        be bound to exactly that node or the call 409s — a stale migration
        plan can never deschedule a pod that already moved."""
        with self._lock:
            pod = self._pods.get((namespace, pod_name))
            if pod is None:
                raise ApiError(404, f"pod {namespace}/{pod_name} not found")
            if not is_pod_bound(pod):
                raise ApiError(409, f"pod {namespace}/{pod_name} is not bound")
            if expect_node is not None and pod.spec.node_name != expect_node:
                raise ApiError(
                    409, f"pod {namespace}/{pod_name} is bound to {pod.spec.node_name}, not {expect_node}"
                )
            unbound = _evolve(pod, spec=_evolve(pod.spec, node_name=None), status=_evolve(pod.status, phase="Pending"))
            self._bump(unbound)
            self._pods[(namespace, pod_name)] = unbound
            self._emit("Pod", WatchEvent("MODIFIED", unbound), prev=pod)

    # -- leader election (coordination.k8s.io/v1 Lease objects) ------------
    #
    # Spec-shaped primitives with resourceVersion compare-and-swap — the
    # contract a real kube-apiserver serves — plus acquire/release helpers
    # running the client-go election algorithm (runtime/lease.py) over them,
    # so the in-process path and the HTTP path execute the same recipe.

    def get_lease_object(self, namespace: str, name: str) -> dict | None:
        with self._lock:
            lease = self._leases.get((namespace, name))
            return json.loads(json.dumps(lease)) if lease is not None else None

    def create_lease_object(self, namespace: str, name: str, lease: dict) -> dict:
        with self._lock:
            if (namespace, name) in self._leases:
                raise ApiError(409, f"lease {namespace}/{name} already exists")
            self._rv += 1
            stored = {**lease, "metadata": {**lease.get("metadata", {}), "name": name, "namespace": namespace, "resourceVersion": str(self._rv)}}
            self._leases[(namespace, name)] = stored
            self.lease_history.append((name, (stored.get("spec") or {}).get("holderIdentity") or ""))
            return json.loads(json.dumps(stored))

    def update_lease_object(self, namespace: str, name: str, lease: dict) -> dict:
        """PUT with optimistic concurrency: the submitted
        metadata.resourceVersion must equal the stored one or 409 — the CAS
        every leader-election race resolves through."""
        with self._lock:
            cur = self._leases.get((namespace, name))
            if cur is None:
                raise ApiError(404, f"lease {namespace}/{name} not found")
            sent_rv = str((lease.get("metadata") or {}).get("resourceVersion") or "")
            if sent_rv != str(cur["metadata"]["resourceVersion"]):
                raise ApiError(409, f"lease {namespace}/{name} conflict: resourceVersion {sent_rv} is stale")
            self._rv += 1
            stored = {**lease, "metadata": {**lease["metadata"], "name": name, "namespace": namespace, "resourceVersion": str(self._rv)}}
            self._leases[(namespace, name)] = stored
            self.lease_history.append((name, (stored.get("spec") or {}).get("holderIdentity") or ""))
            return json.loads(json.dumps(stored))

    def acquire_lease(self, name: str, holder: str, duration_seconds: float) -> bool:
        """One election round per the client-go algorithm: create if absent,
        renew if ours, take over if expired/released; conflicts mean a lost
        race (kube leader-election semantics, server holds no verbs)."""
        from . import lease as lease_mod

        def _create(obj):
            try:
                self.create_lease_object(lease_mod.LEASE_NAMESPACE, name, obj)
                return True
            except ApiError:
                return False

        def _update(obj):
            try:
                self.update_lease_object(lease_mod.LEASE_NAMESPACE, name, obj)
                return True
            except ApiError:
                return False

        # The whole round runs under the store lock (re-entrant), so an
        # in-process renewal thread and main loop for the SAME holder never
        # read each other's CAS as a lost election; cross-process races
        # still resolve through the resourceVersion conflict.
        with self._lock:
            return lease_mod.try_acquire_or_renew(
                lambda: self.get_lease_object(lease_mod.LEASE_NAMESPACE, name),
                _create,
                _update,
                lease_mod.LEASE_NAMESPACE,
                name,
                holder,
                duration_seconds,
                self._clock(),
            )

    def release_lease(self, name: str, holder: str) -> None:
        """Voluntary hand-off (clean shutdown): only the holder may release."""
        from . import lease as lease_mod

        def _update(obj):
            try:
                self.update_lease_object(lease_mod.LEASE_NAMESPACE, name, obj)
                return True
            except ApiError:
                return False

        with self._lock:
            lease_mod.release(
                lambda: self.get_lease_object(lease_mod.LEASE_NAMESPACE, name), _update, holder, self._clock()
            )

    def get_lease(self, name: str) -> dict | None:
        """Back-compat summary view: {'holder', 'expires'} or None."""
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

    def list_lease_summaries(self) -> list[dict]:
        """{'name', 'holder', 'expires'} per Lease in the election namespace,
        name-sorted — the sharded control plane's replica-presence scan
        (runtime/shards.py); '' holder entries (released leases) included so
        callers judge liveness themselves."""
        from . import lease as lease_mod

        with self._lock:
            keys = sorted(k for k in self._leases if k[0] == lease_mod.LEASE_NAMESPACE)
        out = []
        for _ns, name in keys:
            spec = (self.get_lease_object(lease_mod.LEASE_NAMESPACE, name) or {}).get("spec") or {}
            renew = lease_mod.parse_micro_time(spec.get("renewTime")) or 0.0
            out.append(
                {
                    "name": name,
                    "holder": spec.get("holderIdentity") or "",
                    "expires": renew + float(spec.get("leaseDurationSeconds") or 0),
                }
            )
        return out

    # -- PodDisruptionBudgets (policy/v1 subset; consulted by preemption) --

    def create_pdb(self, pdb) -> None:
        with self._lock:
            key = f"{pdb.metadata.namespace or 'default'}/{pdb.metadata.name}"
            self._pdbs[key] = pdb

    def delete_pdb(self, namespace: str, name: str) -> None:
        with self._lock:
            self._pdbs.pop(f"{namespace}/{name}", None)

    def list_pdbs(self) -> list:
        with self._lock:
            return list(self._pdbs.values())

    # -- bulk helpers for synthetic clusters -------------------------------

    def load(self, nodes: Iterable[Node] = (), pods: Iterable[Pod] = (), pdbs: Iterable = ()) -> None:
        for n in nodes:
            self.create_node(n)
        for p in pods:
            self.create_pod(p)
        for b in pdbs:
            self.create_pdb(b)
