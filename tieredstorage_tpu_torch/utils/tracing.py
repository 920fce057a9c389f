"""The span/event seam of the fetch tiers, recording nothing.

The JAX package's tracing plane (spans, Chrome-trace export) is not ported.
The fetch tiers keep its call sites against this recorder, so a later port
of the plane only swaps the object in.
"""

from __future__ import annotations

import contextlib


class NoopTracer:
    def span(self, name: str, **attributes):
        """A span context; yields None (no span to annotate)."""
        return contextlib.nullcontext()

    def event(self, name: str, **attributes) -> None:
        pass


NOOP_TRACER = NoopTracer()
