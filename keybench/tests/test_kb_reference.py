"""The benchmark's plain reference against outside vectors and hashlib."""

import hashlib
import os

import pytest

from keybench.reference import bloom, hashes, secp

HERE = os.path.dirname(os.path.abspath(__file__))
# the solved Bitcoin puzzles 16-24: the keys of `add -r 8000:ffffff`
PUZZLE_KEYS = (0xC936, 0x1764F, 0x3080D, 0x5749F, 0xD2C55, 0x1BA534,
               0x2DE40F, 0x556E52, 0xDC2A04)


def _puzzle_hashes():
    with open(os.path.join(HERE, "..", "configs", "btc-puzzles-hash")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def test_puzzle_keys_hash_to_the_listed_hash160s():
    listed = _puzzle_hashes()
    got = [secp.pubkey_hash160(k, True).hex() for k in PUZZLE_KEYS]
    assert got == listed[15:24]


def test_puzzle_list_is_the_repository_data_file():
    root = os.path.join(HERE, "..", "..")
    with open(os.path.join(root, "data", "btc-puzzles-hash")) as f:
        assert [ln.strip() for ln in f if ln.strip()] == _puzzle_hashes()


@pytest.mark.parametrize("data", [b"", b"abc", b"a" * 55, b"a" * 56,
                                  b"a" * 64, bytes(range(256)) * 3])
def test_sha256_matches_hashlib(data):
    assert hashes.sha256(data) == hashlib.sha256(data).digest()


@pytest.mark.parametrize("data,digest", [
    (b"", "9c1185a5c5e9fc54612808977ee8f548b2258d31"),
    (b"abc", "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"),
    (b"message digest", "5d0689ef49d2fae572b881b123a85ffa21595f36"),
    (b"1234567890" * 8, "9b752e45573d4b39f4dbd3323cab82bf63326bfb"),
])
def test_ripemd160_vectors(data, digest):
    assert hashes.ripemd160(data).hex() == digest


def test_uncompressed_and_compressed_encodings():
    x, y = secp.point(1)
    assert (x, y) == (secp.GX, secp.GY)
    enc = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    assert secp.pubkey_hash160(1, False) == hashes.hash160(enc)
    assert secp.pubkey_hash160(1, True).hex() == \
        "751e76e8199196d454941c45d1b3a323f1433bd6"


@pytest.mark.parametrize("k", [1, 0xC936, secp.N - 5, 2**200 + 12345])
def test_endomorphism_images(k):
    x, y = secp.point(k)
    images = [(x, y), (x, -y % secp.P), (secp.BETA * x % secp.P, y),
              (secp.BETA * x % secp.P, -y % secp.P),
              (secp.BETA ** 2 * x % secp.P, y),
              (secp.BETA ** 2 * x % secp.P, -y % secp.P)]
    for e, pt in enumerate(images):
        priv = secp.endo_priv(k, e)
        assert secp.point(priv) == pt
        assert secp.endo_base(priv, e) == k % secp.N


def test_bloom_sizing_is_blf_gens():
    # 43.13 bits an entry: 50 M entries, 2^31 bits and a little more
    assert bloom.size_words(50_000_000) * 64 == 2_156_638_144
