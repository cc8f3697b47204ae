"""Structured scheduler events: the part of the JAX package's
``serving/telemetry.py`` the core tick reads.  ``SchedEvent`` is the
``str`` subclass behind the serve CLI's ``--verbose`` lines.  Tracing,
metrics and the Chrome-trace export are not ported yet (ROADMAP queue 1,
item 5)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional


class SchedEvent(str):
    """One structured scheduler event: ``kind`` (a stable machine tag:
    admit / prefill / preempt / defer / quarantine / degrade / ok /
    timeout / shed / failed) plus ``fields`` (the event's data), rendered
    as the SAME human-readable line ``on_event`` consumers always
    received — the instance IS that string (``str`` subclass), so
    ``startswith``/``==``/printing are unchanged while structured
    consumers read the attributes.  Per-request events carry the id in
    ``fields["request"]``."""

    kind: str
    fields: Dict[str, Any]

    def __new__(cls, kind: str, message: str,
                fields: Optional[Mapping[str, Any]] = None) -> "SchedEvent":
        ev = super().__new__(cls, message)
        ev.kind = kind
        ev.fields = dict(fields) if fields else {}
        return ev

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "message": str(self), **self.fields}
