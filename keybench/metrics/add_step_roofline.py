"""Share of all device time in the profiled windows that the whole add
step's work would take at the least (chords, inversion, hash and probe):
it bounds the kernels' shares whichever kernels a program runs."""
from keybench import readers


def read(rec):
    return readers.roofline(rec, None, ("chord_dx", "chord_points",
                                         "inv_batch", "hash_probe"))
