"""Remote broker client: the Broker/Consumer surface over HTTP.

The port's copy of ccfd_tpu/bus/client.py. A role takes a broker object and
does not care whether it is the in-process ``Broker`` or this client
pointed at a ``BrokerServer`` (``BROKER_URL=http://host:port``). Polls
long-poll on the server.

Delivery across transport failures: ``produce``/``produce_batch`` never
blind-retry after the request may have reached the server (only a refused
connection retries); ``poll`` carries a sequence number, and a retry after
a lost response gets the same batch back (at-least-once).
"""

from __future__ import annotations

from typing import Any, Iterable

from ccfd_tpu_torch.bus.broker import StaleEpochError
from ccfd_tpu_torch.bus.server import decode_value, encode_value
from ccfd_tpu_torch.utils.httpclient import PooledHTTPClient


class RemoteBusError(ConnectionError):
    pass


class RemoteBroker:
    def __init__(self, base_url: str, pool_size: int = 4,
                 timeout_s: float = 40.0,  # > the server's longest long poll (30 s)
                 retries: int = 2, breaker=None, tracer=None):
        # with a tracer every bus RPC is a client span and carries
        # traceparent, so a produced batch's context rides its records
        self._http = PooledHTTPClient(
            base_url, default_port=9092, pool_size=pool_size, timeout_s=timeout_s,
            retries=retries, scheme_error="RemoteBroker needs an http:// URL",
            breaker=breaker, tracer=tracer, trace_edge="bus")

    def _request(self, method: str, path: str, body: Any = None,
                 idempotent: bool = True) -> tuple[int, Any]:
        try:
            return self._http.request(method, path, body, idempotent=idempotent)
        except ConnectionError as e:
            raise RemoteBusError(str(e)) from e

    # -- Broker surface ----------------------------------------------------
    def produce(self, topic: str, value: Any, key: Any = None,
                partition: int | None = None,
                headers: dict | None = None) -> dict[str, Any]:
        """``partition`` overrides key routing; ``headers`` stamps the record
        on the server."""
        rec: dict[str, Any] = {"value": encode_value(value), "key": encode_value(key)}
        if partition is not None:
            rec["partition"] = int(partition)
        body_out: dict[str, Any] = {"records": [rec]}
        if headers:
            body_out["headers"] = dict(headers)
        code, body = self._request("POST", f"/topics/{topic}/produce", body_out,
                                   idempotent=False)
        if code != 200:
            raise RemoteBusError(f"produce to {topic!r} failed: {code} {body}")
        return body["metas"][0]

    def produce_batch(self, topic: str, values: Iterable[Any],
                      keys: Iterable[Any] | None = None,
                      headers: dict | None = None) -> int:
        """Many records in one HTTP round trip (the producer's hot path);
        one ``headers`` mapping stamps the batch."""
        if keys is None:
            records = [{"value": encode_value(v), "key": None} for v in values]
        else:
            records = [{"value": encode_value(v), "key": encode_value(k)}
                       for v, k in zip(values, keys)]
        if not records:
            return 0
        body_out: dict[str, Any] = {"records": records}
        if headers:
            body_out["headers"] = dict(headers)
        code, body = self._request("POST", f"/topics/{topic}/produce", body_out,
                                   idempotent=False)
        if code != 200:
            raise RemoteBusError(f"produce to {topic!r} failed: {code} {body}")
        return len(body["metas"])

    def end_offsets(self, topic: str) -> list[int]:
        code, body = self._request("GET", f"/topics/{topic}/offsets")
        if code != 200:
            raise RemoteBusError(f"offsets for {topic!r} failed: {code}")
        return body

    def beginning_offsets(self, topic: str) -> list[int]:
        code, body = self._request("GET", f"/topics/{topic}/offsets/begin")
        if code != 200:
            raise RemoteBusError(f"begin offsets for {topic!r} failed: {code}")
        return body

    def committed_offsets(self, group_id: str, topic: str) -> list[int]:
        code, body = self._request("GET", f"/groups/{group_id}/topics/{topic}/offsets")
        if code != 200:
            raise RemoteBusError(
                f"committed offsets for {group_id!r}/{topic!r} failed: {code}")
        return body

    def reset_offsets(self, group_id: str, topic: str, offsets: list[int]) -> None:
        """Rewind (or advance) a group's committed offsets; idempotent."""
        code, body = self._request("POST", f"/groups/{group_id}/topics/{topic}/offsets",
                                   {"offsets": [int(o) for o in offsets]})
        if code != 200:
            raise RemoteBusError(
                f"reset offsets for {group_id!r}/{topic!r} failed: {code} {body}")

    def group_epoch(self, group_id: str) -> int:
        code, body = self._request("GET", f"/groups/{group_id}/epoch")
        if code != 200:
            raise RemoteBusError(f"group epoch for {group_id!r} failed: {code}")
        return int(body["epoch"])

    def fence_group(self, group_id: str, idle_s: float = 0.0) -> dict:
        code, body = self._request("POST", f"/groups/{group_id}/fence",
                                   {"idle_s": float(idle_s)})
        if code != 200:
            raise RemoteBusError(f"fence for {group_id!r} failed: {code} {body}")
        return body

    def consumer(self, group_id: str, topics: Iterable[str],
                 auto_commit: bool = True) -> "RemoteConsumer":
        code, body = self._request("POST", "/consumers", {
            "group": group_id, "topics": list(topics), "auto_commit": bool(auto_commit)})
        if code != 201:
            raise RemoteBusError(f"consumer create failed: {code} {body}")
        return RemoteConsumer(self, int(body["consumer_id"]), group_id, tuple(topics),
                              auto_commit=auto_commit, epoch=int(body.get("epoch", 0)))

    def close(self) -> None:
        self._http.close()


class _RemoteRecord:
    """A record over the wire, with bus.broker.Record's attributes."""

    __slots__ = ("topic", "partition", "offset", "key", "value", "timestamp", "headers")

    def __init__(self, d: dict[str, Any]):
        self.topic = d["topic"]
        self.partition = d["partition"]
        self.offset = d["offset"]
        self.key = decode_value(d["key"])
        self.value = decode_value(d["value"])
        self.timestamp = d["timestamp"]
        self.headers = d.get("headers")


class RemoteConsumer:
    def __init__(self, broker: RemoteBroker, cid: int, group_id: str,
                 topics: tuple[str, ...], auto_commit: bool = True, epoch: int = 0):
        self._broker = broker
        self._cid = cid
        self.group_id = group_id
        self.topics = topics
        self._seq = 0
        self._closed = False
        self._auto_commit = auto_commit
        # the group epoch of the last poll: the fence manual commits carry
        self.epoch = epoch
        self.assignment: list[tuple[str, int]] = []

    def _poll_once(self, seq: int, max_records: int, timeout_s: float) -> tuple[int, Any]:
        payload: dict[str, Any] = {"max_records": max_records, "timeout_s": timeout_s,
                                   "seq": seq}
        if not self._auto_commit:
            payload["epoch"] = self.epoch
        return self._broker._request("POST", f"/consumers/{self._cid}/poll", payload)

    def poll(self, max_records: int = 500, timeout_s: float = 0.0) -> list[_RemoteRecord]:
        if self._closed:
            return []
        # the seq advances only after a successful, decoded response: a
        # failed poll re-sends the same seq and hits the server's cache
        seq = self._seq + 1
        code, body = self._poll_once(seq, max_records, timeout_s)
        if code == 404:  # reaped by the session timeout: re-register, retry once
            fresh = self._broker.consumer(self.group_id, self.topics,
                                          auto_commit=self._auto_commit)
            self._cid = fresh._cid
            self.epoch = fresh.epoch
            code, body = self._poll_once(seq, max_records, timeout_s)
        if code == 409:  # the group rebalanced: adopt the new epoch, retry once
            self.epoch = int(body.get("epoch", self.epoch))
            asn = body.get("assignment")
            if asn is not None:
                self.assignment = [tuple(tp) for tp in asn]
            code, body = self._poll_once(seq, max_records, timeout_s)
        if code != 200:
            raise RemoteBusError(f"poll failed: {code} {body}")
        try:
            records = [_RemoteRecord(r) for r in body["records"]]
        except (KeyError, ValueError, TypeError) as e:
            raise RemoteBusError(f"undecodable poll batch: {e}") from e
        self._seq = seq
        self.epoch = int(body.get("epoch", self.epoch))
        asn = body.get("assignment")
        if asn is not None:
            self.assignment = [tuple(tp) for tp in asn]
        return records

    def commit(self, offsets: dict[tuple[str, int], int] | None = None,
               epoch: int | None = None) -> dict[tuple[str, int], int]:
        """Manual commit, fenced by ``epoch`` (default: the last poll's). A
        rebalance since then, or this consumer reaped at the broker, raises
        :class:`StaleEpochError`."""
        body: dict[str, Any] = {"epoch": self.epoch if epoch is None else int(epoch)}
        if offsets is not None:
            wire: dict[str, dict[str, int]] = {}
            for (t, p), off in offsets.items():
                wire.setdefault(t, {})[str(int(p))] = int(off)
            body["offsets"] = wire
        code, resp = self._broker._request("POST", f"/consumers/{self._cid}/commit", body)
        if code == 404:
            raise StaleEpochError(self.group_id, int(body["epoch"]), -1,
                                  "consumer fenced (reaped) at broker")
        if code == 409:
            raise StaleEpochError(
                self.group_id, int(body["epoch"]),
                int(resp.get("epoch", -1)) if isinstance(resp, dict) else -1)
        if code != 200:
            raise RemoteBusError(f"commit failed: {code} {resp}")
        self.epoch = int(resp.get("epoch", self.epoch))
        return {(t, int(p)): int(off) for t, p, off in resp.get("committed", [])}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._broker._request("POST", f"/consumers/{self._cid}/close", {})
            except RemoteBusError:  # pragma: no cover - server already gone
                pass


def broker_from_url(broker_url: str, **kafka_kwargs):
    """The one seam the roles use: ``http://host:port`` -> a
    :class:`RemoteBroker`; ``kafka://bootstrap`` -> a ``KafkaAdapter`` on
    that bootstrap (``kafka_kwargs``, e.g. ``registry=``, go to it; it
    raises without kafka-python); anything else -> None (the caller builds
    the in-process Broker)."""
    if broker_url.startswith("http://"):
        return RemoteBroker(broker_url)
    if broker_url.startswith("kafka://"):
        from ccfd_tpu_torch.bus.kafka_adapter import KafkaAdapter

        return KafkaAdapter(broker_url[len("kafka://"):], **kafka_kwargs)
    return None
