"""The HTTP boundary of the port (``tpu_scheduler_torch/runtime/http_api.py``,
``runtime/kubeconfig.py``) against the JAX package's, over real sockets on
127.0.0.1: each client against each server — list, field selectors,
incremental watch and the 410 relist, bind and its 409, the lease CAS — with
equal results, and the two servers answering every route with the same
bytes for the same cluster.  Then the port's Scheduler over
``RemoteApiAdapter`` against the same Scheduler in-process, the port's CLI
with ``--api-server``, ``--kubeconfig``, ``--http-port`` and
``--checkpoint-dir``, and ``load_kubeconfig`` against the JAX loader on the
JAX tests' fixtures, PyYAML or not."""

import base64
import builtins
import functools
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

torch.set_num_threads(1)

import tpu_scheduler.api.objects as jax_objects  # noqa: E402
import tpu_scheduler.runtime.fake_api as jax_fake_api  # noqa: E402
import tpu_scheduler.runtime.http_api as jax_http  # noqa: E402
import tpu_scheduler.runtime.kubeconfig as jax_kc  # noqa: E402
import tpu_scheduler.testing as jt  # noqa: E402
import tpu_scheduler.utils.events as jax_events  # noqa: E402
import tpu_scheduler.utils.metrics as jax_metrics  # noqa: E402
import tpu_scheduler_torch.api.objects as objects  # noqa: E402
import tpu_scheduler_torch.runtime.controller as controller  # noqa: E402
import tpu_scheduler_torch.runtime.fake_api as fake_api  # noqa: E402
import tpu_scheduler_torch.runtime.http_api as http_api  # noqa: E402
import tpu_scheduler_torch.runtime.kubeconfig as kc  # noqa: E402
import tpu_scheduler_torch.utils.events as events_mod  # noqa: E402
import tpu_scheduler_torch.utils.metrics as metrics_mod  # noqa: E402
from tpu_scheduler_torch.backends.cuda import CudaBackend  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(port):
    if port:
        return dict(objects=objects, fake_api=fake_api, http=http_api, events=events_mod, metrics=metrics_mod)
    return dict(objects=jax_objects, fake_api=jax_fake_api, http=jax_http, events=jax_events, metrics=jax_metrics)


@functools.lru_cache(maxsize=None)
def _cluster():
    """Nodes with labels and a taint; pending pods with selectors,
    anti-affinity and spread; bound pods; a gang (built once: the uids
    count up per object made)."""
    nodes = [jt.make_node(f"n{i}", cpu="4", memory="8Gi", labels={"zone": f"z{i % 2}"}) for i in range(3)]
    nodes.append(jt.make_node("tainted", taints=[jax_objects.Taint(key="gpu", value="a", effect="NoSchedule")]))
    pods = [
        jt.make_pod("a", cpu="750m", memory="2Gi", node_selector={"zone": "z1"}, priority=7, labels={"app": "db"},
                    anti_affinity=[jax_objects.PodAntiAffinityTerm(match_labels={"app": "db"}, topology_key="zone")],
                    topology_spread=[jax_objects.TopologySpreadConstraint(topology_key="zone", max_skew=2,
                                                                          match_labels={"app": "db"})]),
        jt.make_pod("b", node_name="n1", phase="Running"),
        jt.make_pod("c", cpu="64", memory="1Gi"),
        jt.make_pod("g-0", gang="g"),
        jt.make_pod("g-1", gang="g", node_name="n0", phase="Running"),
    ]
    late = jt.make_pod("late")
    extra = [jt.make_node(f"extra-{i}") for i in range(8)]
    return nodes, pods, late, extra


def _serve(port, nodes=None, pods=None, **kw):
    p = _pkg(port)
    api = p["fake_api"].FakeApiServer()
    if nodes is not None:
        api.load([p["objects"].Node.from_dict(jax_objects.node_to_dict(n)) for n in nodes],
                 [p["objects"].Pod.from_dict(jax_objects.pod_to_dict(q)) for q in pods])
    server = p["http"].HttpApiServer(api, **kw).start()
    return api, server


def _wire(port, obj):
    p = _pkg(port)["objects"]
    return p.pod_to_dict(obj) if isinstance(obj, p.Pod) else p.node_to_dict(obj)


def _transcript(server_port: bool, client_port: bool) -> list:
    """One fixed script of client calls against one server, recorded as
    JSON-comparable values (objects as their wire dicts)."""
    nodes, pods, late, extra = _cluster()
    api, server = _serve(server_port, nodes, pods)
    c = _pkg(client_port)
    sp = _pkg(server_port)
    out = []
    try:
        client = c["http"].KubeApiClient(server.base_url)
        ns, rv = client.list_nodes(with_rv=True)
        out.append(("nodes", [_wire(client_port, n) for n in ns], rv))
        for sel in (None, "status.phase=Pending", "spec.nodeName=n1"):
            out.append(("pods", sel, [_wire(client_port, q) for q in client.list_pods(field_selector=sel)]))
        _pods, prv = client.list_pods(with_rv=True)
        api.create_pod(sp["objects"].Pod.from_dict(jax_objects.pod_to_dict(late)))
        api.delete_pod("default", "c")
        evs, new_rv = client.watch_pods_since(prv)
        out.append(("watch", [(e.type, _wire(client_port, e.object)) for e in evs], new_rv - prv))
        evs, _ = client.watch_pods_since(prv, field_selector="status.phase=Pending")
        out.append(("watch-pending", [(e.type, e.object.metadata.name) for e in evs]))
        client.create_binding("default", "late", c["objects"].ObjectReference(name="n2"))
        try:
            client.create_binding("default", "late", c["objects"].ObjectReference(name="n0"))
            out.append(("rebind", "accepted"))
        except c["fake_api"].ApiError as e:
            out.append(("rebind", e.code))
        try:
            client.create_binding("default", "nope", c["objects"].ObjectReference(name="n0"))
        except c["fake_api"].ApiError as e:
            out.append(("bind-missing", e.code))
        out.append(("pdbs", client.list_pdbs()))
        out.append(("lease-a", client.acquire_lease("sched", "a", 15.0), client.acquire_lease("sched", "b", 15.0)))
        lease = client.get_lease("sched")
        out.append(("lease", lease["holder"], lease["expires"] > time.time()))
        client.release_lease("sched", "a")
        out.append(("lease-b", client.acquire_lease("sched", "b", 15.0)))
        out.append(("healthz", client.healthz()))
        # HttpWatch: one list, incremental polls, a 410 and one relist.
        adapter = c["http"].RemoteApiAdapter(client)
        watch = adapter.watch_nodes()
        out.append(("first", sorted((e.type, e.object.name) for e in watch.poll())))
        out.append(("steady", watch.poll()))
        for n in extra:
            api.create_node(sp["objects"].Node.from_dict(jax_objects.node_to_dict(n)))
        del api._events_log[:-2]
        out.append(("relist", sorted((e.type, e.object.name) for e in watch.poll())))
        out.append(("after", watch.poll()))
        api.delete_node("extra-0")
        out.append(("delete", [(e.type, e.object.name) for e in watch.poll()]))
        pw = c["http"].PollingWatch(lambda: client.list_nodes(), key_fn=lambda n: n.name)
        out.append(("polling", len(pw.poll()), pw.poll()))
        out.append(("counts", sorted(client.request_counts.items())))
        client.close()
    finally:
        server.stop()
    return out


@pytest.mark.parametrize("server_port,client_port", [(True, False), (False, True)], ids=["port-server", "jax-server"])
def test_clients_and_servers_interoperate(server_port, client_port):
    """Each package's client against the other's server gives what the JAX
    client gives against the JAX server: lists and field selectors, the
    incremental watch, bind and its 409, the lease CAS, the 410 relist."""
    assert _transcript(server_port, client_port) == _transcript(False, False)


ROUTES = ["/healthz", "/readyz", "/api/v1/nodes", "/api/v1/pods", "/api/v1/pods?fieldSelector=status.phase%3DPending",
          "/api/v1/pods?watch=true&resourceVersion=3&allowWatchBookmarks=true",
          "/api/v1/nodes?watch=true&resourceVersion=0", "/apis/policy/v1/poddisruptionbudgets",
          "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/sched",
          "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/none",
          "/debug/pods/default/a", "/debug/pods/default/g-0", "/debug/pods/default/unknown", "/debug/cycles?n=4",
          "/debug/cycles?n=x", "/debug/trace?cycles=2", "/debug/shards", "/debug/rebalance", "/debug/autoscale",
          "/debug/resilience", "/debug/profile", "/debug/latency", "/api/v1/unknown", "/nope"]


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _send(url, method, body: bytes):
    req = urllib.request.Request(url, data=body, method=method, headers={"Content-Type": "application/json"})
    return _get(req)


def _no_wall_stamps(doc):
    """``doc`` less the recorder's wall-clock stamps (``ts``, ``t``)."""
    if isinstance(doc, dict):
        return {k: _no_wall_stamps(v) for k, v in doc.items() if k not in ("ts", "t")}
    if isinstance(doc, list):
        return [_no_wall_stamps(v) for v in doc]
    return doc


def _routes(port: bool) -> list:
    """Every route of a server loaded with :func:`_cluster`, a recorder and
    metrics, as (status, content type, body bytes)."""
    p = _pkg(port)
    nodes, pods, _late, _extra = _cluster()
    recorder = p["events"].FlightRecorder()
    recorder.record("default/a", "unschedulable", 3, reason="TaintNotTolerated")
    recorder.record("default/g-0", "seen", 2)
    metrics = p["metrics"].MetricsRegistry()
    metrics.inc("scheduler_bindings_total", 3)
    api, server = _serve(port, nodes, pods, metrics=metrics, recorder=recorder)
    base = server.base_url
    out = []
    try:
        lease = {"metadata": {"name": "sched"}, "spec": {"holderIdentity": "a", "leaseDurationSeconds": 15,
                                                         "renewTime": "2030-01-01T00:00:00.000000Z"}}
        out.append(_send(base + "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases", "POST",
                         json.dumps(lease).encode()))
        out.append(_send(base + "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases", "POST",
                         json.dumps(lease).encode()))
        stale = dict(lease, metadata={"name": "sched", "resourceVersion": "0"})
        out.append(_send(base + "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/sched", "PUT",
                         json.dumps(stale).encode()))
        for route in ROUTES:
            status, ctype, body = _get(base + route)
            if route == "/metrics":
                continue
            if route.startswith("/debug/") and status == 200:
                body = json.dumps(_no_wall_stamps(json.loads(body))).encode()
            out.append((route, status, ctype, body))
        binding = {"target": {"name": "n2"}}
        out.append(_send(base + "/api/v1/namespaces/default/pods/a/binding", "POST", json.dumps(binding).encode()))
        out.append(_send(base + "/api/v1/namespaces/default/pods/a/binding", "POST", json.dumps(binding).encode()))
        out.append(_send(base + "/api/v1/namespaces/default/pods/a/binding", "POST", b"not-json"))
        out.append(_send(base + "/api/v1/namespaces/default/pods/c", "DELETE", b""))
        out.append(_send(base + "/api/v1/namespaces/default/pods/c", "DELETE", b""))
        out.append(_get(base + "/api/v1/pods"))
        status, ctype, text = _get(base + "/metrics")
        out.append((status, ctype, [ln for ln in text.decode().splitlines() if "uptime" not in ln]))
    finally:
        server.stop()
    return out


def test_servers_answer_every_route_with_the_same_bytes():
    """The wire format is the JAX server's: every route (cluster, lease,
    binding, eviction, watch, debug, metrics less the uptime sample) answers
    with the same status, content type and body."""
    port, jax = _routes(True), _routes(False)
    assert len(port) == len(jax)
    for p_row, j_row in zip(port, jax):
        assert p_row == j_row


def test_metrics_only_server_and_unattached_routes():
    """With ``api=None`` the cluster routes answer 503, the debug routes
    serve the recorder's timelines; unattached subsystems 404 — as the JAX
    server does."""
    rows = []
    for port in (True, False):
        p = _pkg(port)
        recorder = p["events"].FlightRecorder()
        recorder.record("default/p", "unschedulable", 3, reason="TaintNotTolerated")
        server = p["http"].HttpApiServer(None, metrics=p["metrics"].MetricsRegistry(), recorder=recorder).start()
        try:
            rows.append([_get(server.base_url + r)[:2] for r in
                         ("/debug/pods/default/p", "/debug/pods/default/unknown", "/api/v1/pods", "/debug/shards")]
                        + [_send(server.base_url + "/api/v1/namespaces/default/pods/p/binding", "POST", b"{}")[0]])
        finally:
            server.stop()
    assert rows[0] == rows[1]
    assert [r[0] for r in rows[0][:4]] == [200, 404, 503, 404] and rows[0][4] == 503


def test_long_poll_watch_wakes_on_an_event():
    api, server = _serve(True, [jt.make_node("n1")], [])
    try:
        client = http_api.KubeApiClient(server.base_url, timeout=0.5)
        _, rv = client.list_nodes(with_rv=True)
        got = {}

        def poll():
            t0 = time.monotonic()
            got["events"], _ = client.watch_nodes_since(rv, timeout_seconds=5.0)
            got["latency"] = time.monotonic() - t0

        t = threading.Thread(target=poll)
        t.start()
        time.sleep(0.2)
        api.create_node(objects.Node.from_dict(jax_objects.node_to_dict(jt.make_node("n2"))))
        t.join(timeout=5)
        assert [e.object.name for e in got["events"]] == ["n2"] and 0.1 < got["latency"] < 3.0
        # A long poll that outlives the client's socket timeout ends cleanly.
        assert client.watch_nodes_since(rv + 1, timeout_seconds=1.0) == ([], rv + 1)
    finally:
        server.stop()


# --- the Scheduler and the CLI over HTTP -------------------------------------------


def _placement(api):
    return sorted((p.metadata.name, p.spec.node_name) for p in api.list_pods())


@pytest.mark.parametrize("delta", [True, False])
def test_scheduler_over_http_equals_in_process(delta):
    """The port's Scheduler over RemoteApiAdapter → HTTP → FakeApiServer
    binds exactly what it binds in-process, cycle by cycle; the remote
    boundary lists once and then only watches."""
    snap = jt.synth_cluster(n_nodes=12, n_pending=160, n_bound=20, seed=5, selector_fraction=0.2, gang_fraction=0.1,
                            anti_affinity_fraction=0.1)
    results = []
    for remote in (True, False):
        api, server = _serve(True, list(snap.nodes), list(snap.pods))
        try:
            client = http_api.KubeApiClient(server.base_url)
            target = http_api.RemoteApiAdapter(client) if remote else api
            sched = controller.Scheduler(target, CudaBackend(device="cpu"), requeue_seconds=0.0,
                                         rng=random.Random(1), delta=delta)
            rows = [(m.pending, m.bound, m.unschedulable) for m in sched.run(until_settled=True, max_cycles=6)]
            for i in range(4):
                api.create_pod(objects.Pod.from_dict(jax_objects.pod_to_dict(jt.make_pod(f"late-{i}"))))
            rows.append(sched.run_cycle().bound)
            results.append((rows, _placement(api), sched.delta.stats() if delta else None))
            sched.close()
            if remote:
                assert client.request_counts[("GET", "/api/v1/pods")] == 1
                assert client.request_counts[("GET", "/api/v1/nodes")] == 1
        finally:
            server.stop()
    assert results[0] == results[1]
    assert results[0][0][-1] == 4


def _cli(*args, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "tpu_scheduler_torch.cli", "--device", "cpu",
                           "--log-level", "ERROR", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _summary(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _write_kubeconfig(path, server, token=None, extra_user=None, extra_cluster=None, current="ctx", fmt="yaml"):
    user = {"token": token} if token else {}
    user.update(extra_user or {})
    cluster = {"server": server}
    cluster.update(extra_cluster or {})
    cfg = {
        "apiVersion": "v1", "kind": "Config", "current-context": current,
        "contexts": [{"name": "ctx", "context": {"cluster": "c1", "user": "u1"}}],
        "clusters": [{"name": "c1", "cluster": cluster}],
        "users": [{"name": "u1", "user": user}],
    }
    path.write_text(yaml.safe_dump(cfg) if fmt == "yaml" else json.dumps(cfg))
    return path


@pytest.mark.parametrize("how", ["api-server", "kubeconfig"])
def test_cli_over_http_binds_what_the_in_process_scheduler_binds(how, tmp_path):
    """The port's CLI pointed at an HTTP server (``--api-server`` with a
    token, or ``--kubeconfig`` with a bearer token), until settled, with the
    delta engine on: the server ends with the bindings the same Scheduler
    makes in-process."""
    snap = jt.synth_cluster(n_nodes=20, n_pending=300, n_bound=30, seed=0)
    api, server = _serve(True, list(snap.nodes), list(snap.pods))
    try:
        if how == "api-server":
            flags = ["--api-server", server.base_url, "--api-token", "t0k"]
        else:
            flags = ["--kubeconfig", str(_write_kubeconfig(tmp_path / "config", server.base_url, token="t0k",
                                                           fmt="json"))]
        summary = _summary(_cli(*flags, "--requeue-seconds", "0"))
        remote = _placement(api)
    finally:
        server.stop()
    local, _ = _serve(True, list(snap.nodes), list(snap.pods))
    from tpu_scheduler_torch import cli

    args = cli.build_parser().parse_args(["--device", "cpu", "--requeue-seconds", "0"])
    sched = cli.make_scheduler(args, local, CudaBackend(device="cpu"))
    sched.run(until_settled=True)
    sched.close()
    assert remote == _placement(local)
    assert summary["bound_total"] == sum(1 for _n, node in remote if node) - 30
    assert summary["counters"]['scheduler_full_solves_total{reason="cold"}'] == 1


def test_cli_http_port_serves_metrics_and_debug(tmp_path):
    """``--http-port`` serves the in-process cluster's routes and the
    debug surface while the CLI runs; the URL is printed on stderr."""
    proc = subprocess.Popen([sys.executable, "-m", "tpu_scheduler_torch.cli", "--device", "cpu", "--nodes", "4",
                             "--pods", "20", "--http-port", "0", "--daemon", "--interval", "0.05", "--log-level",
                             "ERROR"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        line = ""
        deadline = time.monotonic() + 120
        while '"http"' not in line and time.monotonic() < deadline:
            line = proc.stderr.readline()
        url = json.loads(line)["url"]
        for _ in range(200):
            status, _ctype, body = _get(url + "/api/v1/pods?fieldSelector=status.phase%3DPending")
            if status == 200 and not json.loads(body)["items"]:
                break
            time.sleep(0.05)
        assert _get(url + "/healthz")[0] == 200
        status, _c, text = _get(url + "/metrics")
        assert status == 200 and b"scheduler_pods_bound_total 20" in text
        for route in ("/debug/profile", "/debug/latency", "/debug/resilience", "/debug/shards", "/debug/cycles"):
            assert _get(url + route)[0] == 200, route
        assert _get(url + "/debug/rebalance")[0] == 404
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_checkpoint_restart_resumes(tmp_path):
    """``--checkpoint-dir``: a one-cycle run saves at exit; the restarted
    run restores (its first cycle escalates with "restore") and ends with
    the bindings of an uninterrupted run."""
    # Oversubscribed: the verdicts the first run leaves stand, the restored
    # run re-solves them in its "restore" wave.
    snap = jt.synth_cluster(n_nodes=6, n_pending=200, n_bound=10, seed=3, selector_fraction=0.2)
    placements = []
    for restart in (True, False):
        api, server = _serve(True, list(snap.nodes), list(snap.pods))
        try:
            flags = ["--api-server", server.base_url, "--requeue-seconds", "0"]
            if restart:
                ck = str(tmp_path / "ckpt")
                first = _summary(_cli(*flags, "--checkpoint-dir", ck, "--cycles", "1"))
                assert os.path.exists(os.path.join(ck, "state.json")) and first["cycles"] == 1
                second = _summary(_cli(*flags, "--checkpoint-dir", ck))
                assert second["counters"]['scheduler_full_solves_total{reason="restore"}'] == 1
                assert second["cycles"] >= 1
            else:
                _summary(_cli(*flags))
            placements.append(_placement(api))
        finally:
            server.stop()
    assert placements[0] == placements[1]


# --- kubeconfig ------------------------------------------------------------------


def _both(fn):
    """``fn(module)`` on the port's loader and the JAX one: equal answers,
    or the same exception type and message."""
    outs = []
    for mod in (kc, jax_kc):
        try:
            outs.append(("ok", fn(mod)))
        except Exception as e:  # noqa: BLE001 — compared across the packages
            outs.append(("raise", type(e).__name__, str(e)))
    assert outs[0] == outs[1]
    return outs[0]


def _resolved(mod, path, **kw):
    server, token, ctx, _keep = mod.load_kubeconfig(str(path), **kw)
    return (server, token() if callable(token) else token, callable(token),
            None if ctx is None else (ctx.verify_mode, ctx.check_hostname))


def _plugin(tmp_path, name, body):
    import stat

    p = tmp_path / name
    p.write_text("#!/bin/sh\n" + body)
    p.chmod(p.stat().st_mode | stat.S_IXUSR)
    return str(p)


@pytest.mark.parametrize("case", ["token", "token_file", "tls_skip", "context", "unknown_context", "no_context",
                                  "no_server", "exec_refused", "exec_token", "exec_shadowed", "exec_missing",
                                  "exec_cert", "inline_ca"])
def test_load_kubeconfig_matches_jax(case, tmp_path):
    """The JAX tests' fixtures through both loaders: the same server,
    token (or provider's token), TLS settings and errors."""
    cred = {"kind": "ExecCredential", "status": {"token": "minted", "expirationTimestamp": "2999-01-01T00:00:00Z"}}
    plugin = _plugin(tmp_path, "auth", f"cat <<'EOF'\n{json.dumps(cred)}\nEOF\n")
    tok = tmp_path / "tok"
    tok.write_text("from-file\n")
    kw = {}
    if case == "token":
        cfg = _write_kubeconfig(tmp_path / "c", "http://127.0.0.1:1", token="sekret")
    elif case == "token_file":
        cfg = _write_kubeconfig(tmp_path / "c", "http://127.0.0.1:1", extra_user={"tokenFile": str(tok)})
    elif case == "tls_skip":
        cfg = _write_kubeconfig(tmp_path / "c", "https://10.0.0.1:6443", token="t",
                                extra_cluster={"insecure-skip-tls-verify": True})
    elif case == "context":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", token="t", current="nope")
        kw = {"context": "ctx"}
    elif case == "unknown_context":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", current="nope")
    elif case == "no_context":
        cfg = tmp_path / "c"
        cfg.write_text(yaml.safe_dump({"clusters": []}))
    elif case == "no_server":
        cfg = _write_kubeconfig(tmp_path / "c", "", token="t")
    elif case == "exec_refused":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", extra_user={"exec": {"command": plugin}})
    elif case == "exec_token":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", extra_user={"exec": {"command": plugin}})
        kw = {"allow_exec": True}
    elif case == "exec_shadowed":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", extra_user={
            "tokenFile": str(tok), "exec": {"command": "definitely-not-installed-helper"}})
        kw = {"allow_exec": True}
    elif case == "exec_missing":
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", extra_user={
            "exec": {"command": "helper-not-here", "installHint": "install it"}})
        kw = {"allow_exec": True}
    elif case == "exec_cert":
        bad = _plugin(tmp_path, "certs", 'echo \'{"kind": "ExecCredential", "status": {"clientCertificateData": "P"}}\'\n')
        cfg = _write_kubeconfig(tmp_path / "c", "http://x", extra_user={"exec": {"command": bad}})
        kw = {"allow_exec": True}
    else:
        cfg = _write_kubeconfig(tmp_path / "c", "https://10.0.0.1:6443", token="t",
                                extra_cluster={"certificate-authority-data": base64.b64encode(b"junk").decode()})
    got = _both(lambda mod: _resolved(mod, cfg, **kw))
    expect_ok = case in ("token", "token_file", "tls_skip", "context", "exec_token", "exec_shadowed")
    assert (got[0] == "ok") == expect_ok, got


def test_kubeconfig_token_file_rotates_and_exec_refreshes(tmp_path, monkeypatch):
    """A tokenFile provider re-reads after its refresh window; an expired
    exec credential re-runs the plugin on each use; a failing plugin with a
    last-good token serves it (an OSError otherwise)."""
    tok = tmp_path / "tok"
    tok.write_text("one")
    provider = kc._file_token_provider(str(tok))
    assert provider() == "one"
    tok.write_text("two")
    t_real = time.monotonic
    monkeypatch.setattr(time, "monotonic", lambda: t_real() + 120.0)
    assert provider() == "two"
    monkeypatch.setattr(time, "monotonic", t_real)
    count = tmp_path / "count"
    flag = tmp_path / "fail"
    cred = {"kind": "ExecCredential", "status": {"token": "t1", "expirationTimestamp": "2001-01-01T00:00:00Z"}}
    plugin = _plugin(tmp_path, "p", f"echo x >> {count}\nif [ -e {flag} ]; then exit 3; fi\n"
                                    f"cat <<'EOF'\n{json.dumps(cred)}\nEOF\n")
    p = kc._exec_token_provider({"command": plugin}, str(tmp_path), {})
    assert p() == "t1" and p() == "t1" and count.read_text().count("x") == 2
    flag.write_text("x")
    assert p() == "t1"
    with pytest.raises(kc.ExecCredentialError):
        kc._exec_token_provider({"command": plugin}, str(tmp_path), {})()
    assert issubclass(kc.ExecCredentialError, OSError) and issubclass(kc.ExecCredentialError, kc.KubeconfigError)


def test_kubeconfig_without_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML a JSON kubeconfig (valid YAML) resolves as it does
    with PyYAML, and a YAML-only file raises KubeconfigError naming
    PyYAML."""
    json_cfg = _write_kubeconfig(tmp_path / "j", "http://127.0.0.1:1", token="t", fmt="json")
    yaml_cfg = _write_kubeconfig(tmp_path / "y", "http://127.0.0.1:1", token="t")
    with_yaml = _resolved(kc, json_cfg)
    assert with_yaml == _resolved(jax_kc, json_cfg) == _resolved(kc, yaml_cfg)
    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert _resolved(kc, json_cfg) == with_yaml
    with pytest.raises(kc.KubeconfigError, match="PyYAML"):
        kc.load_kubeconfig(str(yaml_cfg))
    empty = tmp_path / "empty"
    empty.write_text("")
    with pytest.raises(kc.KubeconfigError, match="no current-context"):
        kc.load_kubeconfig(str(empty))


def test_client_from_kubeconfig_resolution(tmp_path, monkeypatch):
    """Explicit path, then the first existing file of $KUBECONFIG's list;
    the bearer token rides every request; a server URL's path prefix is
    kept; nothing found raises."""
    api, server = _serve(True, [jt.make_node("n1")], [])
    try:
        cfg = _write_kubeconfig(tmp_path / "b", server.base_url, token="sekret")
        client = kc.client_from_kubeconfig(str(cfg))
        assert [n.name for n in client.list_nodes()] == ["n1"] and client._token == "sekret"
        monkeypatch.setenv("KUBECONFIG", f"{tmp_path / 'missing'}{os.pathsep}{cfg}")
        assert [n.name for n in kc.client_from_kubeconfig().list_nodes()] == ["n1"]
    finally:
        server.stop()
    assert http_api.KubeApiClient("http://127.0.0.1:1/k8s/clusters/c-abc")._prefix == "/k8s/clusters/c-abc"
    with pytest.raises(kc.KubeconfigError, match="no kubeconfig found"):
        kc.client_from_kubeconfig(str(tmp_path / "missing"))
