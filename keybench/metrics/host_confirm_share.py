"""Share of the window's wall spent re-deriving device candidates on the
host and checking them against the exact filter (search.common.
derive_h160, Filter.confirm)."""
from keybench import readers


def read(rec):
    return readers.span_share(rec, ("derive_h160", "confirm"))
