"""The benchmark's plain reference: secp256k1, SHA-256, RIPEMD-160 and the
bloom filter's semantics in plain Python, and the judge of a run's
answers.  It imports neither the program nor any accelerator library."""
