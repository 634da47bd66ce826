"""Mean milliseconds of a ``next()`` on the ring iterator handed to ``fit``
(a span the harness records around each call) over the window."""

from gpubench.readers import span_ms as read  # noqa: F401
