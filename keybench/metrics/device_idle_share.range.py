"""Device idle share of a range search (rnd): 1 - the union of the
device ops' intervals / the profiled windows' wall (the interval their
busy time is measured over)."""
from keybench.readers import idle_share as read  # noqa: F401
