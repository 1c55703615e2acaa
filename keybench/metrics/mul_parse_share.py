"""Share of the window's wall spent parsing key lines on the host
(search.mul.parse_keys, keys_to_words, words_mod_n)."""
from keybench import readers


def read(rec):
    return readers.span_share(rec, ("parse_keys", "keys_to_words",
                                    "words_mod_n"))
