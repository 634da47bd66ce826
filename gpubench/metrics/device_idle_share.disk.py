"""Share of the traced window in which no operation ran on the device
(100 less the union of the device events' intervals over the window)."""

from gpubench.readers import idle_share as read  # noqa: F401
