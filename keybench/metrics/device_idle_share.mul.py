"""Device idle share of `mul`: 1 - the union of the device ops'
intervals / the host wall of the profiled windows."""
from keybench.readers import idle_share as read  # noqa: F401
