"""Kubeconfig / in-cluster discovery — the real-cluster edge of the HTTP
boundary.

The reference gets this for free from ``Client::try_default()``
(``src/main.rs:130``): kubeconfig discovery ($KUBECONFIG → ~/.kube/config),
TLS against the cluster CA, bearer/client-cert auth, and the in-cluster
serviceaccount fallback.  This module reproduces that resolution chain for
:class:`~tpu_scheduler_torch.runtime.http_api.KubeApiClient` using only the
stdlib + PyYAML:

  * ``load_kubeconfig`` — parse a kubeconfig, resolve the chosen (or
    current) context to (server, token, ssl.SSLContext);
  * ``client_from_kubeconfig`` — ``try_default()``: explicit path →
    $KUBECONFIG → ~/.kube/config → in-cluster serviceaccount.

Supported auth: bearer ``token`` / ``tokenFile``, client certificates
(``client-certificate(-data)`` + ``client-key(-data)``), cluster CA
(``certificate-authority(-data)``), ``insecure-skip-tls-verify``, and —
behind an explicit ``allow_exec=True`` opt-in (CLI ``--allow-exec-auth``) —
``exec:`` credential plugins (client.authentication.k8s.io ExecCredential:
the aws/gke/azure token-helper shape).  Exec plugins spawn arbitrary
binaries, which a scheduler sidecar should not do implicitly, so without
the opt-in they raise with a clear message instead.  Token-emitting
plugins are fully supported (incl. expirationTimestamp-driven refresh);
plugins that emit client certificates are rejected — rotating a TLS
context mid-daemon is not supported.

Port: a copy of ``tpu_scheduler/runtime/kubeconfig.py``, with one change:
PyYAML is optional.  Without it a kubeconfig written as JSON (valid YAML,
and read by kubectl) is parsed with ``json``, and any other file raises
:class:`KubeconfigError` naming PyYAML.  A file both loaders can read gives
the same answer.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile

__all__ = ["KubeconfigError", "ExecCredentialError", "load_kubeconfig", "client_from_kubeconfig"]

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeconfigError(Exception):
    """Unusable kubeconfig: missing file, unknown context, bad references."""


class ExecCredentialError(KubeconfigError, OSError):
    """Exec credential-plugin failure AT REQUEST TIME (helper crashed,
    timed out, emitted garbage).  Inherits OSError so the runtime's
    transient-fault handlers (reflector backoff, per-pod bind requeue,
    lease fail-safe — all catch OSError) back off and retry instead of
    treating a helper's network blip as a fatal programming error; a
    tokenFile read failure surfaces as OSError the same way."""


def _named(seq, name: str, what: str) -> dict:
    for item in seq or []:
        if item.get("name") == name:
            return item.get(what) or {}
    raise KubeconfigError(f"kubeconfig references unknown {what} {name!r}")


def _material(entry: dict, key: str, tmpdir: list) -> str | None:
    """Resolve ``{key}`` (a path) or ``{key}-data`` (inline base64) to a
    filesystem path — ssl's loaders want files, so inline data lands in a
    private tempdir that lives as long as the returned client."""
    data = entry.get(f"{key}-data")
    if data:
        if not tmpdir:
            d = tempfile.TemporaryDirectory(prefix="tpu-sched-kubeconfig-")
            tmpdir.append(d)
        path = os.path.join(tmpdir[0].name, key.replace("-", "_"))
        with open(path, "wb") as f:
            f.write(base64.b64decode(data))
        return path
    return entry.get(key)


def load_kubeconfig(path: str, context: str | None = None, allow_exec: bool = False):
    """Parse ``path`` and resolve ``context`` (default: current-context).

    Returns (server_url, token, ssl_context_or_None, keepalive) —
    ``keepalive`` holds the tempdir backing any inline cert material and
    must stay referenced while the connection is in use.  ``allow_exec``
    opts in to running the user's ``exec:`` credential plugin (see module
    docstring)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise KubeconfigError(f"cannot read kubeconfig {path!r}: {e}") from e
    cfg = _parse(text, path)

    ctx_name = context or cfg.get("current-context")
    if not ctx_name:
        raise KubeconfigError(f"kubeconfig {path!r} has no current-context and none was given")
    ctx = _named(cfg.get("contexts"), ctx_name, "context")
    cluster = _named(cfg.get("clusters"), ctx.get("cluster", ""), "cluster")
    user = _named(cfg.get("users"), ctx.get("user", ""), "user")

    server = cluster.get("server")
    if not server:
        raise KubeconfigError(f"cluster {ctx.get('cluster')!r} has no server URL")
    token = user.get("token")
    token_provider = None
    if "exec" in user and not token and not user.get("tokenFile"):
        # A static token OR tokenFile shadows the exec block (client-go
        # precedence: the bearer round-tripper covers both and is applied
        # outermost), so a missing/broken helper binary must not abort a
        # config that would never invoke it.
        if not allow_exec:
            raise KubeconfigError(
                "exec credential plugins are disabled by default (they spawn arbitrary binaries); "
                "pass --allow-exec-auth / allow_exec=True to opt in, or use a token or client certificate"
            )
        token_provider = _exec_token_provider(user["exec"], os.path.dirname(os.path.abspath(path)), cluster)
    if not token and token_provider is None and user.get("tokenFile"):
        # Re-read per use: bound serviceaccount tokens rotate (~1 h); a
        # static copy turns into permanent 401s in a daemon.
        token_provider = _file_token_provider(user["tokenFile"])
        token_provider()  # fail fast on an unreadable file

    keepalive: list = []
    ssl_ctx = None
    if server.startswith("https"):
        ssl_ctx = ssl.create_default_context()
        ca = _material(cluster, "certificate-authority", keepalive)
        if ca:
            ssl_ctx.load_verify_locations(cafile=ca)
        if cluster.get("insecure-skip-tls-verify"):
            ssl_ctx.check_hostname = False
            ssl_ctx.verify_mode = ssl.CERT_NONE
        cert = _material(user, "client-certificate", keepalive)
        key = _material(user, "client-key", keepalive)
        if cert:
            ssl_ctx.load_cert_chain(certfile=cert, keyfile=key)
    return server, token or token_provider, ssl_ctx, keepalive


def _parse(text: str, path: str) -> dict:
    """The kubeconfig document: YAML through PyYAML when it is installed,
    else JSON (a subset of YAML) through ``json``."""
    try:
        import yaml
    except ImportError:
        if not text.strip():
            return {}
        try:
            return json.loads(text) or {}
        except ValueError as e:
            raise KubeconfigError(
                f"kubeconfig {path!r} is not JSON, and PyYAML, which reads YAML kubeconfigs, is not installed: {e}"
            ) from e
    return yaml.safe_load(text) or {}


def _file_token_provider(path: str):
    """() -> token, re-reading ``path`` with a short cache (rotation-safe
    without a stat per request burst)."""
    state = {"t": 0.0, "token": None}

    def provider():
        import time

        now = time.monotonic()
        if state["token"] is None or now - state["t"] > 60.0:
            try:
                with open(path) as f:
                    state["token"] = f.read().strip()
            except OSError as e:
                if state["token"] is None:
                    raise KubeconfigError(f"cannot read token file {path!r}: {e}") from e
                # keep serving the last good token on a transient read error
            state["t"] = now
        return state["token"]

    return provider


def _exec_token_provider(exec_spec: dict, kubeconfig_dir: str, cluster: dict):
    """() -> bearer token via the kubeconfig ``exec:`` credential plugin
    (client.authentication.k8s.io ExecCredential — the mechanism behind
    ``aws eks get-token`` / ``gke-gcloud-auth-plugin``; reference inherits
    it from client-go via ``Client::try_default()``, ``main.rs:130``).

    Spawns the plugin on first use and again once the returned credential's
    ``expirationTimestamp`` passes (no expiry → cached for the process).
    client-go semantics honored: relative ``command`` paths resolve against
    the kubeconfig's directory; ``env`` entries overlay the inherited
    environment; ``provideClusterInfo`` ships the cluster block in
    ``KUBERNETES_EXEC_INFO``; ``interactiveMode: Always`` is refused (a
    scheduler daemon has no TTY).  Certificate-emitting plugins are
    rejected — rotating a TLS context mid-daemon is out of scope."""
    import shutil
    import subprocess

    command = exec_spec.get("command")
    if not command:
        raise KubeconfigError("exec credential plugin has no command")
    if exec_spec.get("interactiveMode") == "Always":
        raise KubeconfigError("exec credential plugin requires a TTY (interactiveMode: Always); a scheduler daemon has none")
    api_version = exec_spec.get("apiVersion") or "client.authentication.k8s.io/v1beta1"

    def _hint() -> str:
        # client-go appends installHint exactly on plugin-not-found errors —
        # it is the one message telling the operator how to fix the setup.
        h = exec_spec.get("installHint")
        return f"; {h}" if h else ""

    # client-go: a command with a path separator resolves relative to the
    # kubeconfig's directory; a bare name resolves via PATH.
    if os.sep in command and not os.path.isabs(command):
        command = os.path.normpath(os.path.join(kubeconfig_dir, command))
    elif os.sep not in command and shutil.which(command) is None:
        raise KubeconfigError(f"exec credential plugin {command!r} not found on PATH{_hint()}")

    env = dict(os.environ)
    for entry in exec_spec.get("env") or []:
        env[entry.get("name", "")] = entry.get("value", "")
    if exec_spec.get("provideClusterInfo"):
        cluster_info = {"server": cluster.get("server")}
        if cluster.get("certificate-authority-data"):
            cluster_info["certificate-authority-data"] = cluster["certificate-authority-data"]
        env["KUBERNETES_EXEC_INFO"] = json.dumps(
            {"apiVersion": api_version, "kind": "ExecCredential", "spec": {"interactive": False, "cluster": cluster_info}}
        )

    state = {"token": None, "expires": None}

    def _expired() -> bool:
        if state["token"] is None:
            return True
        if state["expires"] is None:
            return False
        import datetime

        return datetime.datetime.now(datetime.timezone.utc) >= state["expires"]

    def provider():
        if not _expired():
            return state["token"]
        try:
            return _mint()
        except ExecCredentialError:
            if state["token"] is not None:
                # Serve the last-good (possibly just-expired) token on a
                # transient helper failure — the apiserver 401s if it is
                # truly dead, which the request layer already treats as a
                # retryable ApiError (same grace _file_token_provider gives
                # a transiently-unreadable tokenFile).
                return state["token"]
            raise

    def _mint():
        argv = [command] + list(exec_spec.get("args") or [])
        try:
            out = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise ExecCredentialError(f"exec credential plugin {command!r} failed to run: {e}{_hint()}") from e
        if out.returncode != 0:
            hint = exec_spec.get("installHint") or out.stderr.strip()[:200]
            raise ExecCredentialError(f"exec credential plugin {command!r} exited {out.returncode}: {hint}")
        try:
            cred = json.loads(out.stdout)
        except ValueError as e:
            raise ExecCredentialError(f"exec credential plugin {command!r} emitted invalid JSON: {e}") from e
        if cred.get("kind") != "ExecCredential":
            raise ExecCredentialError(
                f"exec credential plugin {command!r} emitted kind {cred.get('kind')!r}, want ExecCredential"
            )
        status = cred.get("status") or {}
        if status.get("clientCertificateData") or status.get("clientKeyData"):
            raise ExecCredentialError(
                f"exec credential plugin {command!r} emitted client certificates, which are not supported; "
                "use a token-emitting plugin"
            )
        token = status.get("token")
        if not token:
            raise ExecCredentialError(f"exec credential plugin {command!r} emitted no status.token")
        expires = None
        ts = status.get("expirationTimestamp")
        if ts:
            import datetime

            try:
                expires = datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
                if expires.tzinfo is None:
                    expires = expires.replace(tzinfo=datetime.timezone.utc)
            except ValueError:
                expires = None  # unparsable expiry → treat as non-expiring
        state["token"], state["expires"] = token, expires
        return token

    return provider


def _in_cluster():
    """Serviceaccount fallback (the pod-mounted credentials kube injects).
    The token is a rotating projected token — re-read, never cached
    statically."""
    token_path = os.path.join(SERVICEACCOUNT_DIR, "token")
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    if not host or not os.path.exists(token_path):
        return None
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    ssl_ctx = ssl.create_default_context()
    ca_path = os.path.join(SERVICEACCOUNT_DIR, "ca.crt")
    if os.path.exists(ca_path):
        ssl_ctx.load_verify_locations(cafile=ca_path)
    return f"https://{host}:{port}", _file_token_provider(token_path), ssl_ctx, []


def client_from_kubeconfig(
    path: str | None = None, context: str | None = None, timeout: float = 10.0, allow_exec: bool = False
):
    """``Client::try_default()`` (reference ``main.rs:130``): explicit path →
    $KUBECONFIG → ~/.kube/config → in-cluster serviceaccount.  Returns a
    ready :class:`KubeApiClient`.  ``allow_exec`` opts in to ``exec:``
    credential plugins (see :func:`load_kubeconfig`)."""
    import http.client
    from urllib.parse import urlparse

    from .http_api import KubeApiClient

    resolved = None
    if path:
        candidates = [path]
    else:
        # $KUBECONFIG is a colon-separated path LIST (kubectl semantics);
        # client-go merges the files — here the first existing one wins,
        # which covers the dominant single-file case without a merge engine.
        env = os.environ.get("KUBECONFIG") or ""
        candidates = [c for c in env.split(os.pathsep) if c] + [os.path.expanduser("~/.kube/config")]
    for cand in candidates:
        if cand and os.path.exists(cand):
            resolved = load_kubeconfig(cand, context, allow_exec=allow_exec)
            break
    if resolved is None and not path:
        resolved = _in_cluster()
    if resolved is None:
        tried = " -> ".join(str(c) for c in candidates if c) or "<none>"
        raise KubeconfigError(f"no kubeconfig found (tried {tried}) and not running in-cluster")
    server, token, ssl_ctx, keepalive = resolved
    token_provider = token if callable(token) else None
    static_token = None if callable(token) else token

    parsed = urlparse(server)
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    if parsed.scheme == "https":
        factory = lambda: http.client.HTTPSConnection(host, port, timeout=timeout, context=ssl_ctx)  # noqa: E731
    else:
        factory = lambda: http.client.HTTPConnection(host, port, timeout=timeout)  # noqa: E731
    # KubeApiClient keeps the server URL's PATH prefix (proxied apiservers:
    # kubectl proxy, rancher /k8s/clusters/X) and prepends it per request.
    client = KubeApiClient(
        server, token=static_token, timeout=timeout, connection_factory=factory, token_provider=token_provider
    )
    client._kubeconfig_keepalive = keepalive  # pin inline cert tempdir to the client's lifetime
    return client
