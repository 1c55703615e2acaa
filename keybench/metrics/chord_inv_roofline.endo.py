"""Share of the chord and inversion kernels' device time that the steps'
K4 chords in their -endo form (the beta x, beta^2 x and -y rows written
too) and K2 inversion would take at the least (bytes-bound)."""
from keybench import readers

KERNELS = ("chord_dx", "chord_points", "inv_batch")


def read(rec):
    return readers.roofline(rec, KERNELS, KERNELS)
