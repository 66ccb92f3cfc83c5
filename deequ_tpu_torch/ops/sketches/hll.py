"""HyperLogLog++ distinct-count sketch: host hashing and estimation.

The host hashes each value once (xxhash64 of 8-byte values in the C
library, ops/native, or numpy with the library off; a vectorized
xxhash-style mix over unique strings, ops/strings.py) and packs
``register idx << 6 | rank`` into one int32 per row; the device folds the
packed codes into 512 registers (`ops/cuda_kernels.hll_register_max`);
merging two sketches is a register-wise max.

Same parameters as deequ: relativeSD=0.05 -> p=9, m=512 registers
(reference: StatefulHyperloglogPlus.scala:154-155). Estimation is the
full HLL++ pipeline — linear counting under the precision threshold,
empirical bias interpolation (K=6 nearest points of the published p=9
tables, hll_bias.py) below 5m, raw estimate above — with the same branch
structure as the reference (StatefulHyperloglogPlus.scala:210-297).
"""

from __future__ import annotations

import numpy as np

P = 9  # precision: derived from RELATIVE_SD = 0.05 like the reference
M = 1 << P  # 512 registers
ALPHA_M2 = (0.7213 / (1.0 + 1.079 / M)) * M * M
SEED = np.uint64(42)

# xxhash64 constants (public algorithm constants, Cyan4973/xxHash)
_PRIME1 = np.uint64(0x9E3779B185EBCA87)
_PRIME2 = np.uint64(0xC2B2AE3D27D4EB4F)
_PRIME3 = np.uint64(0x165667B19E3779F9)
_PRIME4 = np.uint64(0x85EBCA77C2B2AE63)
_PRIME5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _rotl_inplace(x: np.ndarray, r: int, scratch: np.ndarray) -> np.ndarray:
    """x <- rotl(x, r) using a preallocated scratch buffer."""
    np.right_shift(x, np.uint64(64 - r), out=scratch)
    np.left_shift(x, np.uint64(r), out=x)
    np.bitwise_or(x, scratch, out=x)
    return x


def xxhash64_u64(values: np.ndarray, seed: np.uint64 = SEED) -> np.ndarray:
    """Vectorized xxhash64 of 8-byte values, in place over two buffers."""
    with np.errstate(over="ignore"):
        v = values.view(np.uint64) if values.dtype == np.int64 else values.astype(np.uint64)
        acc = v * _PRIME2  # fresh buffer; v itself is never written
        scratch = np.empty_like(acc)
        _rotl_inplace(acc, 31, scratch)
        acc *= _PRIME1
        acc ^= seed + _PRIME5 + np.uint64(8)
        _rotl_inplace(acc, 27, scratch)
        acc *= _PRIME1
        acc += _PRIME4
        np.right_shift(acc, np.uint64(33), out=scratch)
        acc ^= scratch
        acc *= _PRIME2
        np.right_shift(acc, np.uint64(29), out=scratch)
        acc ^= scratch
        acc *= _PRIME3
        np.right_shift(acc, np.uint64(32), out=scratch)
        acc ^= scratch
        return acc


def canonical_int64(values: np.ndarray) -> np.ndarray:
    """Canonical 8-byte form whose xxhash64 defines a value's identity:
    floats by their float64 bit pattern, timestamps as epoch-us, ints and
    bools as int64. Strings have none (they hash through the dictionary
    path in pack_codes)."""
    if values.dtype == object or values.dtype.kind == "U":
        raise TypeError(
            "string values have no canonical int64 form; use the "
            "dictionary hash path"
        )
    if values.dtype == np.bool_:
        return values.astype(np.int64)
    if np.issubdtype(values.dtype, np.floating):
        return values.astype(np.float64).view(np.int64)
    if np.issubdtype(values.dtype, np.datetime64):
        return values.astype("datetime64[us]").astype(np.int64)
    return values.astype(np.int64, copy=False)


def pack_codes(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(register idx << 6 | rank) int32 per row; 0 for invalid rows.

    The C library's one-pass kernel (ops/native `xxhash64_pack`) hashes,
    counts leading zeros and packs at memory speed; with the library off
    the numpy route computes the same codes in about 15 passes. Strings
    hash through their unique values instead."""
    if values.dtype == object or values.dtype.kind == "U":
        from deequ_tpu_torch.ops.strings import hash_strings

        uniques, inv = np.unique(values[valid].astype(str), return_inverse=True)
        idx, rank = registers_from_hashes(hash_strings(uniques))
        packed = np.zeros(len(values), dtype=np.int32)
        packed[valid] = ((idx << 6) | rank)[inv]
        return packed
    from deequ_tpu_torch.ops import native

    canon = canonical_int64(values)
    packed = native.xxhash64_pack(canon, valid)
    if packed is not None:
        return packed
    idx, rank = registers_from_hashes(xxhash64_u64(canon[valid]))
    packed = np.zeros(len(values), dtype=np.int32)
    packed[valid] = (idx << 6) | rank
    return packed


def registers_from_hashes(hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(register index, rank) per hash: idx = top P bits, rank = 1 +
    leading zeros of the remaining bits (capped for the 6-bit register).

    CLZ is vectorized exactly via the f64 exponent of the top 32 bits
    (uint32 -> f64 is lossless, so floor(log2(top)) is the true
    exponent). top==0 (probability 2^-32 per value) takes a scalar loop."""
    idx = (hashes >> np.uint64(64 - P)).astype(np.int32)
    rest = (hashes << np.uint64(P)) | (np.uint64(1) << np.uint64(P - 1))
    top = (rest >> np.uint64(32)).astype(np.uint32)
    f_bits = top.astype(np.float64).view(np.uint64)
    exponent = (f_bits >> np.uint64(52)).astype(np.int32) - 1023
    rank = 32 - exponent
    zero_top = top == 0
    if zero_top.any():
        for i in np.nonzero(zero_top)[0]:
            rank[i] = 65 - int(rest[i]).bit_length()
    np.clip(rank, 1, 64 - P + 1, out=rank)
    return idx, rank


def update_registers(registers: np.ndarray, idx: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Host-side register max-merge; device path uses .at[idx].max."""
    np.maximum.at(registers, idx, rank)
    return registers


def merge_registers(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def estimate_bias(e: float) -> float:
    """Empirical bias for a raw estimate: mean bias of the K=6 nearest
    interpolation points, by squared distance, exactly like the reference
    (reference: StatefulHyperloglogPlus.scala:258-297)."""
    from deequ_tpu_torch.ops.sketches.hll_bias import (
        BIAS_P9,
        K_NEAREST,
        RAW_ESTIMATE_P9,
    )

    estimates = RAW_ESTIMATE_P9
    n = len(estimates)
    nearest = int(np.searchsorted(estimates, e, side="left"))

    low = max(nearest - K_NEAREST + 1, 0)
    high = min(low + K_NEAREST, n)
    while high < n and (e - estimates[high]) ** 2 < (e - estimates[low]) ** 2:
        low += 1
        high += 1
    return float(np.mean(BIAS_P9[low:high]))


def estimate(registers: np.ndarray) -> float:
    """Full HLL++ estimator: raw estimate with empirical bias correction
    below 5m, linear counting below the precision threshold, rounded
    (reference: StatefulHyperloglogPlus.scala:210-256)."""
    from deequ_tpu_torch.ops.sketches.hll_bias import THRESHOLD_P9

    z_inverse = np.sum(np.float64(1.0) / (np.uint64(1) << registers.astype(np.uint64)))
    v = float(np.sum(registers == 0))

    e = ALPHA_M2 / z_inverse
    e_bias_corrected = e - estimate_bias(e) if e < 5.0 * M else e

    if v > 0:
        # linear counting for small cardinalities
        h = M * np.log(M / v)
        if h <= THRESHOLD_P9:
            return float(round(h))
    return float(round(e_bias_corrected))


def pack_words(registers: np.ndarray) -> np.ndarray:
    """512 6-bit registers -> 52 packed int64 words (10 registers/word),
    the reference's persisted layout
    (reference: StatefulHyperloglogPlus.scala:154, HLLConstants)."""
    regs_per_word = 10
    num_words = (M + regs_per_word - 1) // regs_per_word  # 52
    words = np.zeros(num_words, dtype=np.uint64)
    for i in range(M):
        w, slot = divmod(i, regs_per_word)
        words[w] |= np.uint64(int(registers[i]) & 0x3F) << np.uint64(6 * slot)
    return words.view(np.int64)


def unpack_words(words: np.ndarray) -> np.ndarray:
    regs_per_word = 10
    uw = words.view(np.uint64) if words.dtype == np.int64 else words.astype(np.uint64)
    registers = np.zeros(M, dtype=np.int32)
    for i in range(M):
        w, slot = divmod(i, regs_per_word)
        registers[i] = int((uw[w] >> np.uint64(6 * slot)) & np.uint64(0x3F))
    return registers
