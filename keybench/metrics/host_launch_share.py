"""Share of the window's wall spent enqueuing the add step's calls on
the host: `StepCall.__call__` (each shard's T graph replays and T slot
copies), over all shards."""
from keybench import readers


def read(rec):
    return readers.span_share(rec, ("launch",))
