"""Device idle share of a range search over a hash160 list past the
compare path: 1 - the union of the device ops' intervals / the host
wall of the profiled windows."""
from keybench.readers import idle_share as read  # noqa: F401
