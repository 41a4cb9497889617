"""The port's supervisor and health probes against the reference's.

``runtime/supervisor.py`` and ``runtime/health.py`` are copies of the
reference's. The same scripted services (crash, clean exit, block until
stopped, an injected failure) run under both supervisors on a patched
clock: each monitor pass advances the clock by the poll interval, so the
backoff schedule is exact. Tolerance: none; the state sequence, restart
counts, last errors and backoff deadlines must be equal pass for pass.
"""

from __future__ import annotations

import json
import threading
import time as real_time
import urllib.request

import pytest

import ccfd_tpu.runtime.health as ref_health
import ccfd_tpu.runtime.supervisor as ref_sup
import ccfd_tpu_torch.runtime.health as port_health
import ccfd_tpu_torch.runtime.supervisor as port_sup

PASSES = 400


class _Script:
    """A service whose n-th run does ``steps[n]``: "crash" raises, "exit"
    returns, "block" runs until stopped (the last step repeats)."""

    def __init__(self, steps: list[str]):
        self.steps = steps
        self.calls = 0
        self.stop_ev = threading.Event()
        self.blocking = threading.Event()

    def run(self) -> None:
        step = self.steps[min(self.calls, len(self.steps) - 1)]
        self.calls += 1
        if step == "crash":
            raise RuntimeError(f"crash {self.calls}")
        if step == "block":
            self.blocking.set()
            self.stop_ev.wait()
            self.blocking.clear()

    def stop(self) -> None:
        self.stop_ev.set()

    def reset(self) -> None:
        self.stop_ev.clear()


class _Clock:
    """The module's ``time``: each ``sleep`` is one monitor pass; it waits
    (in real time) until every spawned service has ended or is blocking,
    advances the clock, records the status and fires the scripted
    injections."""

    def __init__(self, sup, scripts: dict, inject: dict[int, str]):
        self.t = 1000.0
        self.sup = sup
        self.scripts = scripts
        self.inject = inject
        self.passes = 0
        self.trace: list = []

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        for name, svc in list(self.sup._services.items()):
            th = svc._thread
            sc = self.scripts[name]
            # settled: ended, or blocking with no stop pending
            while th is not None and th.is_alive() and not (
                    sc.blocking.is_set() and not sc.stop_ev.is_set()):
                real_time.sleep(0.0002)
            if th is not None and not th.is_alive():
                th.join()
        self.t += s
        self.passes += 1
        status = self.sup.status()
        nexts = {n: round(v._next_start - 1000.0, 9) for n, v in self.sup._services.items()}
        self.trace.append((status, nexts))
        if self.passes in self.inject:
            self.sup.inject_failure(self.inject[self.passes], "scripted")
        if self.passes >= PASSES:
            self.sup._stop.set()


def _drive(mod, policy_of, monkeypatch) -> list:
    scripts = {
        "flappy": _Script(["crash", "crash", "crash", "crash", "block"]),
        "job": _Script(["exit"]),
        "retry": _Script(["crash", "exit"]),
        "steady": _Script(["block"]),
    }
    sup = mod.Supervisor(backoff_initial_s=0.1, backoff_cap_s=0.5, stable_after_s=2.0,
                         poll_interval_s=0.02)
    clock = _Clock(sup, scripts, inject={150: "steady", 300: "flappy"})
    monkeypatch.setattr(mod, "time", clock)
    for name, sc in scripts.items():
        sup.add_thread_service(name, sc.run, sc.stop, policy=policy_of(mod, name),
                               max_restarts=(3 if name == "retry" else None), reset=sc.reset)
    sup.start()
    sup._monitor.join(timeout=60)
    assert not sup._monitor.is_alive()
    final = sup.status()
    sup.stop(timeout_s=5)
    return clock.trace + [final, {n: sc.calls for n, sc in scripts.items()}]


def _policy(mod, name):
    return {"flappy": mod.RestartPolicy.ALWAYS, "job": mod.RestartPolicy.NEVER,
            "retry": mod.RestartPolicy.ON_FAILURE, "steady": mod.RestartPolicy.ALWAYS}[name]


def test_scripted_crashes_give_the_references_state_sequence(monkeypatch):
    ref = _drive(ref_sup, _policy, monkeypatch)
    port = _drive(port_sup, _policy, monkeypatch)
    assert port == ref
    final = port[-2]
    # the schedule did what it says: the flappy service backed off through
    # four crashes and recovered, the job ran once, retry stopped at success
    assert final["flappy"]["restarts"] >= 4 and final["job"]["state"] == "Succeeded"
    assert final["retry"]["state"] == "Succeeded" and final["retry"]["restarts"] == 1
    assert final["steady"]["restarts"] == 1  # the injected failure
    assert "injected: scripted" in {s[0]["steady"]["last_error"] for s in port[:-2]}
    # passes spent in CrashLoopBackOff before each flappy restart: the
    # backoff doubles from 0.1 s and caps at 0.5 s (0.02 s a pass, plus
    # the pass that sees the crash)
    waits, run = [], 0
    for status, _n in port[:-2]:
        if status["flappy"]["state"] == "CrashLoopBackOff":
            run += 1
        elif run:
            waits.append(run)
            run = 0
    assert waits[:4] == [6, 11, 21, 26], waits


def test_health_server_answers_as_the_references():
    def serve(mod_sup, mod_health):
        sup = mod_sup.Supervisor(poll_interval_s=0.01)
        stop = threading.Event()
        sup.add_thread_service("svc", stop.wait, stop.set, reset=stop.clear)
        sup.start()
        assert sup.wait_ready(5.0)
        srv = mod_health.HealthServer(sup).start()
        out = {}
        try:
            for path in ("/healthz", "/readyz", "/status", "/nope"):
                try:
                    with urllib.request.urlopen(srv.endpoint + path, timeout=5) as r:
                        out[path] = (r.status, json.loads(r.read()))
                except urllib.error.HTTPError as e:
                    out[path] = (e.code, json.loads(e.read()))
        finally:
            srv.stop()
            sup.stop()
        return out

    assert serve(port_sup, port_health) == serve(ref_sup, ref_health)


@pytest.mark.parametrize("mod", [port_sup])
def test_wait_ready_and_start_service(mod):
    sup = mod.Supervisor(poll_interval_s=0.01)
    stop = threading.Event()
    sup.add_thread_service("a", stop.wait, stop.set, reset=stop.clear)
    sup.start()
    assert sup.wait_ready(5.0)
    done = threading.Event()
    sup.add_thread_service("job", done.set, policy=mod.RestartPolicy.NEVER)
    assert sup.status()["job"]["state"] == "Pending"
    sup.start_service("job")
    assert done.wait(5.0)
    assert sup.wait_ready(5.0)
    assert not sup.inject_failure("nope")
    sup.stop()
    assert {s["state"] for s in sup.status().values()} == {"Stopped"}
