"""Device prefilter false positives of the mul job per 10^9 candidate
lanes: mask bits set (`mul.candidates`) less those the host confirmed
(`mul.confirmed`), over the lanes hashed (`mul.lanes`, padding
included)."""
from keybench import program


def read(rec):
    return program.fp_per_gkey(rec, "mul")
