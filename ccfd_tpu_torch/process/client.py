"""REST client for a remote process engine: the router's KIE_SERVER_URL hop.

The port's copy of ccfd_tpu/process/client.py: the engine surface the
router calls (``start_process``, ``start_process_batch``, ``signal``) and
the investigator's (``instance``, ``tasks``, ``complete_task``) against a
KIE-shaped engine server (process/server.py, or the reference's). Pooled
connections with bounded retries; a process start is never re-sent once
the request may have reached the engine.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from ccfd_tpu_torch.utils.httpclient import PooledHTTPClient


class EngineRestClient:
    def __init__(self, base_url: str, pool_size: int = 4, timeout_s: float = 5.0,
                 retries: int = 2, breaker=None, tracer=None):
        self._http = PooledHTTPClient(
            base_url, default_port=8090, pool_size=pool_size, timeout_s=timeout_s,
            retries=retries, scheme_error="unsupported scheme in KIE_SERVER_URL",
            breaker=breaker, tracer=tracer, trace_edge="engine")

    def _request(self, method: str, path: str, body: Any = None,
                 idempotent: bool = True) -> tuple[int, Any]:
        return self._http.request(method, path, body, idempotent=idempotent)

    def start_process(self, def_id: str, variables: Mapping[str, Any]) -> int:
        code, body = self._request("POST", f"/rest/processes/{def_id}/instances",
                                   {"variables": dict(variables)}, idempotent=False)
        if code != 201:
            raise RuntimeError(f"start_process {def_id!r} failed: {code} {body}")
        return int(body["process_id"])

    def start_process_batch(self, def_id: str,
                            variables_list: Sequence[Mapping[str, Any]],
                            copy_vars: bool = True) -> list[int | None]:
        """One HTTP round trip for a micro-batch of starts. ``None`` slots are
        instances the engine aborted; a transport failure raises.
        ``copy_vars`` is the in-process engine's option, moot over the wire
        (the variables are serialized either way)."""
        del copy_vars
        code, body = self._request("POST", f"/rest/processes/{def_id}/instances/batch",
                                   {"variables_list": [dict(v) for v in variables_list]},
                                   idempotent=False)
        if code != 201:
            raise RuntimeError(f"start_process_batch {def_id!r} failed: {code} {body}")
        return [None if p is None else int(p) for p in body["process_ids"]]

    def signal(self, pid: int, name: str, payload: Any = None) -> bool:
        code, body = self._request("POST", f"/rest/instances/{pid}/signal/{name}",
                                   {"payload": payload})
        return code == 200 and bool(body.get("consumed"))

    def instance(self, pid: int) -> Mapping[str, Any]:
        code, body = self._request("GET", f"/rest/instances/{pid}")
        if code != 200:
            raise KeyError(pid)
        return body

    def tasks(self, status: str = "open") -> list[Mapping[str, Any]]:
        code, body = self._request("GET", f"/rest/tasks?status={status}")
        if code != 200:
            raise RuntimeError(f"tasks query failed: {code} {body}")
        return body or []

    def complete_task(self, task_id: int, outcome: Any) -> None:
        code, body = self._request("POST", f"/rest/tasks/{task_id}/complete",
                                   {"outcome": outcome})
        if code != 200:
            raise RuntimeError(f"complete_task {task_id} failed: {code} {body}")

    def close(self) -> None:
        self._http.close()
