"""Share of the hash-and-probe kernels' device time that hashing and
probing every candidate plane of the steps would take at the least
(K1's operations per key and form, the probe's reads of the cell's
filter; operations-bound in both range cells)."""
from keybench import readers

KERNELS = ("hash160_probe",)


def read(rec):
    return readers.roofline(rec, KERNELS, ("hash_probe",))
