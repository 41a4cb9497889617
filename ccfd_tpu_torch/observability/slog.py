"""Structured trace-correlated JSON logging.

The port's copy of ccfd_tpu/observability/slog.py; its namespace logger is
``ccfd_tpu_torch``.

The reference's services log free text to pod stdout; correlating a log
line with the transaction that caused it means grepping timestamps. This
layer emits one JSON object per line and stamps ``trace_id``/``span_id``
from the active span (observability/trace.py contextvar), so a retained
trace found via the exporter's ``/traces/<id>`` endpoint joins directly
against the log stream — the logging third of the trace↔metric↔log
triangle (exemplars are the metric side).

Usage::

    log = slog.get_logger("router")        # JSON handler, component field
    log.warning("scorer edge degraded", extra={"tier": "host"})

Any ``extra={...}`` keys land as top-level JSON fields (collisions with
the reserved fields are prefixed ``x_``). ``configure()`` is idempotent
per logger and never touches the root logger, so test harnesses and
embedding applications keep their own logging untouched.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, TextIO

from ccfd_tpu_torch.observability.trace import current_context

_RESERVED = frozenset((
    "ts", "level", "component", "logger", "msg", "trace_id", "span_id", "exc",
))
# logging.LogRecord's own attribute names: anything else on the record came
# from extra={...} and belongs in the JSON object
_RECORD_ATTRS = frozenset(vars(
    logging.LogRecord("", 0, "", 0, "", (), None)
)) | {"message", "asctime", "taskName"}


class TraceJSONFormatter(logging.Formatter):
    def __init__(self, component: str = ""):
        super().__init__()
        self.component = component

    def format(self, record: logging.LogRecord) -> str:
        obj: dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "component": self.component or record.name,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ctx = current_context()
        if ctx is not None:
            obj["trace_id"] = ctx.trace_id
            obj["span_id"] = ctx.span_id
        for key, value in record.__dict__.items():
            if key in _RECORD_ATTRS or key.startswith("_"):
                continue
            out_key = f"x_{key}" if key in _RESERVED else key
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            obj[out_key] = value
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, default=repr)


class _StructuredHandler(logging.StreamHandler):
    """Marker subclass so configure() can recognize its own handler."""


def configure(component: str = "", logger: logging.Logger | str | None = None,
              level: int = logging.INFO,
              stream: TextIO | None = None) -> logging.Logger:
    """Attach a JSON handler to ``logger`` (default: the ``ccfd_tpu_torch``
    namespace logger). Idempotent: re-configuring replaces this module's
    own handler instead of stacking duplicates. ``propagate`` is disabled
    so lines don't double-print through the root logger."""
    if logger is None or isinstance(logger, str):
        logger = logging.getLogger(logger or "ccfd_tpu_torch")
    for h in list(logger.handlers):
        if isinstance(h, _StructuredHandler):
            logger.removeHandler(h)
    handler = _StructuredHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(TraceJSONFormatter(component))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def get_logger(component: str, level: int = logging.INFO,
               stream: TextIO | None = None) -> logging.Logger:
    """A ``ccfd_tpu_torch.<component>`` logger emitting trace-correlated JSON."""
    return configure(component, f"ccfd_tpu_torch.{component}", level=level,
                     stream=stream)


def span_fields(msg: str = "", **fields: Any) -> str:
    """Render ad-hoc fields as one JSON log line body (for call sites that
    must stay on a plain logger but want machine-parseable payloads)."""
    obj: dict[str, Any] = {"msg": msg, **fields}
    ctx = current_context()
    if ctx is not None:
        obj["trace_id"] = ctx.trace_id
        obj["span_id"] = ctx.span_id
    obj["ts"] = round(time.time(), 6)
    return json.dumps(obj, default=repr)
