"""Share of the window's wall spent re-deriving the device's candidates
of a hash160 list on the host and checking them against the sorted list
(search.common.derive_h160, Filter.confirm)."""
from keybench import readers


def read(rec):
    return readers.span_share(rec, ("derive_h160", "confirm"))
