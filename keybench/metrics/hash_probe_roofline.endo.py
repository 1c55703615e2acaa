"""Share of the hash-and-probe kernel's device time that hashing and
probing the steps' 12 candidate planes (-endo, addr33 and addr65) would
take at the least: K1's operations per key and form, the probe priced
as a compare over the list's first words (operations-bound)."""
from keybench import readers

KERNELS = ("hash160_probe",)


def read(rec):
    return readers.roofline(rec, KERNELS, ("hash_probe",))
