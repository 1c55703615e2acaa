"""Host enqueues per add step: graph replays, slot copies and mask
fetches (the port's `add.enqueues`) over the steps queued (`add.steps`);
8 replays + 8 copies + 1 fetch per 8-step call read 2.125."""
from keybench import program


def read(rec):
    c = program.counts(rec, "add.enqueues", "add.steps")
    return None if c is None else c[0] / c[1]
