"""Device idle share of a range search (rnd): 1 - the union of the
device ops' intervals / the host wall of the profiled windows."""
from keybench.readers import idle_share as read  # noqa: F401
