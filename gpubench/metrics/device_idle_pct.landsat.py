"""The device's idle share of the traced window: 100 (1 - busy / window),
busy being the union of its kernel and copy intervals."""
from gpubench.readers import idle_pct as read  # noqa: F401
