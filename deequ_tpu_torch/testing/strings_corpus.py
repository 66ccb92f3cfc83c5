"""Strings that hold K5 (`ops/cuda_kernels.classify_hash_dictionary`) to
the host's `ops/strings.classify` and `hash_strings`: the hard cases of
UTF-8 decoding, of the length buckets and their 128-code-point cap, and of
the type classifier's sign, space, digits, dots and line terminators.

The CPU tests, the card test and `chip_smoke.py` draw from here, so the
kernel and its plain version meet the same corpus."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# signs and spaces around digits and dots
_NUMERIC = [
    "", " ", "  ", ".", "+", "-", "+ ", "- ", "+ 5", "- 5", "+5", "-5", "5", "5.5", ".5",
    "5.", "+.5", "-.", " .", " 5", "  5", "5 ", "++5", "+-5", "5+", "5.5.5", "..", "+ .",
    "- 1.25", "+  5", " +5", "+ 5 ", "1 2", "0", "007", "-0.0", "+ 123.", "- .",
]
# one final Java line terminator is stripped; a second one is not
_TERMINATED = [
    "5\n", "5\r\n", "5\r", "5\x85", "5 ", "5 ", "5\n\n", "5\r\r", "5\n\r",
    "true\n", "true\r\n", "false ", "\n", "\r\n", " ", "+\n", "- \r\n",
    "1.5 ", "5 \n",
]
# NULs inside and at the end: within the cap trailing NULs fall away
_NULS = [
    "\x00", "5\x00", "\x005", "5\x005", "5\n\x00", "a\x00\n", "true\x00", "\x00\x00",
    "1.5\x00\x00\x00", "+\x00", "5\x00\n",
]
# multi-byte UTF-8: 2, 3 and 4 bytes
_MULTIBYTE = [
    "é", "ñ5", "5é", "€", "中文", "𝟓", "😀", "a😀b", "０１２", "١٢٣", "trué", "ｔｒｕｅ",
    "\u0085", "€" * 40, "😀" * 33, "é" * 129, "x" + "😀" * 130,
]
_BOOLEAN = ["true", "false", "True", "FALSE", "truee", "xtrue", " true", "fals", "tru"]


def _long_cases() -> List[str]:
    """Strings of 129-400 code points (over the cap: chunked hashing)
    beside the bucket edges below it."""
    out = []
    for n in (7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128):
        out += ["1" * n, "a" * n]
    for n in (129, 130, 200, 255, 256, 257, 384, 400):
        out += ["1" * n, "a" * n, "1" * (n - 1) + "\n", "1" * (n - 2) + "\r\n",
                "1" * (n - 1) + "\x00", "-" + "1" * (n - 2) + ".", "é" * n]
    return out


EDGE_CASES: List[str] = _NUMERIC + _TERMINATED + _NULS + _MULTIBYTE + _BOOLEAN + _long_cases()


def fuzz(count: int, seed: int) -> List[str]:
    """`count` random strings of 0-20 code points (and a few of 100-300)
    over the classifier's alphabet, terminators, NUL and multi-byte
    letters."""
    rng = np.random.default_rng(seed)
    alphabet = list("0123456789+-. truefalsexyz\n\r\x00") + [
        "\x85", " ", " ", "é", "€", "𝟓", "中",
    ]
    out = []
    for i in range(count):
        size = rng.integers(100, 300) if i % 20 == 0 else rng.integers(0, 21)
        out.append("".join(rng.choice(alphabet, size=size)))
    return out


def utf8_arrays(values: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 offsets, uint8 UTF-8 bytes) of `values`, Arrow's string
    layout: value i is bytes offsets[i]:offsets[i + 1]."""
    encoded = [v.encode("utf-8") for v in values]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    return offsets, np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
