"""Device prefilter false positives of the add step per 10^9 candidate
lanes: mask bits set (`add.candidates`) less those the host confirmed
(`add.confirmed`), over the lanes hashed (`add.lanes`)."""
from keybench import program


def read(rec):
    return program.fp_per_gkey(rec, "add")
