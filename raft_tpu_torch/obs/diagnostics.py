"""Crash flight-recorder bundles: what the engine was doing when it died.

Counterpart of ``raft_tpu.obs.diagnostics``: the same
``raft_tpu.diagnostics/v1`` schema, so one triage tool reads bundles of
both packages.

A *diagnostics bundle* is one JSON document freezing the observable
state of a serving process at a moment of interest — a watchdog-declared
hang, a breaker trip, or an operator asking "what is this thing doing":

- ``spans``: the last-N span records from the engine's
  :class:`~raft_tpu_torch.obs.spans.RingSink` tape (requests, batches,
  rejects — whatever flowed through ``_emit`` recently);
- ``metrics``: a full registry snapshot (same JSON as ``/metrics.json``);
- ``health``: the engine's ``health()`` doc at dump time;
- ``config``: the engine's effective configuration;
- ``reason``/``ts``/``pid``: why and when.

Written atomically (tmp + ``os.replace``) so a bundle on disk is always
parseable — a process that dies mid-dump leaves the tmp file, not a torn
bundle. :func:`load_bundle` validates the schema marker and is what
tests and the runbook's triage step use to read one back.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

__all__ = ["BUNDLE_SCHEMA", "build_bundle", "write_bundle", "load_bundle"]

BUNDLE_SCHEMA = "raft_tpu.diagnostics/v1"


def build_bundle(reason: str,
                 spans: Optional[List[dict]] = None,
                 registry=None,
                 health: Optional[dict] = None,
                 config: Optional[dict] = None,
                 extra: Optional[dict] = None) -> dict:
    """Assemble the bundle document. Every section is best-effort: a
    registry or health callable that raises yields an ``"error"`` entry
    for its section instead of losing the whole bundle — the recorder
    runs at the worst possible moment by design."""
    now = time.time()
    doc: dict = {
        "schema": BUNDLE_SCHEMA,
        "reason": reason,
        "ts_unix": round(now, 3),
        "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "pid": os.getpid(),
    }
    doc["spans"] = list(spans) if spans is not None else []
    if registry is not None:
        try:
            doc["metrics"] = registry.to_json()
        except Exception as e:
            doc["metrics"] = {"error": f"{type(e).__name__}: {e}"}
    else:
        doc["metrics"] = None
    doc["health"] = health
    doc["config"] = config
    if extra:
        doc["extra"] = extra
    return doc


def write_bundle(dir_path: str, doc: dict,
                 prefix: str = "diagnostics") -> str:
    """Write ``doc`` as ``<prefix>_<utc-stamp>_<pid>.json`` under
    ``dir_path`` (created if missing), atomically. Returns the path."""
    os.makedirs(dir_path, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S",
                          time.gmtime(doc.get("ts_unix", time.time())))
    name = f"{prefix}_{stamp}_{doc.get('pid', os.getpid())}.json"
    path = os.path.join(dir_path, name)
    # same stamp twice in one second (breaker flap): suffix a counter
    n = 1
    while os.path.exists(path):
        path = os.path.join(dir_path, f"{name[:-5]}_{n}.json")
        n += 1
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, default=str)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_bundle(path: str) -> dict:
    """Read a bundle back, checking the schema marker."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"{path}: not a diagnostics bundle "
            f"(schema={doc.get('schema')!r}, want {BUNDLE_SCHEMA!r})")
    return doc
