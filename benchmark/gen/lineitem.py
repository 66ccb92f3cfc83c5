"""TPC-H lineitem at a configured row count, as one Parquet file.

The columns follow TPC-H v3 Clause 4.2.3, vectorised in numpy from
`numpy.random.default_rng(seed)`:

- orders: `rows / 4` orders (SF x 1,500,000), each of 1-7 lines with
  line numbers 1, 2, ... in sequence; the line counts are drawn, then
  moved by one line in as many orders as it takes to give `rows`
  exactly. O_ORDERKEY is dbgen's sparse key (the first 8 of every 32),
  so (l_orderkey, l_linenumber) is unique.
- O_ORDERDATE uniform over [1992-01-01, 1998-12-31 - 151 days];
  L_SHIPDATE = O_ORDERDATE + [1, 121], L_COMMITDATE = O_ORDERDATE +
  [30, 90], L_RECEIPTDATE = L_SHIPDATE + [1, 30]; L_RETURNFLAG "R" or
  "A" if the receipt is on or before CURRENTDATE (1995-06-17), else "N";
  L_LINESTATUS "O" if shipped after CURRENTDATE, else "F".
- L_PARTKEY uniform over [1, SF x 200,000]; L_SUPPKEY one of the part's
  four suppliers (Clause 4.2.3's formula, S = SF x 10,000);
  L_EXTENDEDPRICE = L_QUANTITY x P_RETAILPRICE of the part, computed in
  cents; L_QUANTITY [1, 50], L_DISCOUNT [0.00, 0.10], L_TAX
  [0.00, 0.08].
- L_COMMENT: a text string of 10-43 characters at a random offset of a
  text pool made by Clause 4.2.2.10's grammar (dbgen draws it so), plain
  strings with millions of distinct values, written without a
  dictionary as parquet-mr writes such a column.

The short string columns (flags, dates, instructions, modes) are kept as
codes into their dictionaries and written by pyarrow as dictionary
arrays, never as Python strings. The file has no Arrow schema in its
footer (`store_schema=False`), as a file written by Spark or parquet-mr
has none.
"""

from __future__ import annotations

import datetime
import functools
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

CODED = ("l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
         "l_shipinstruct", "l_shipmode")
STRINGS = CODED + ("l_comment",)
COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax") + STRINGS

START = datetime.date(1992, 1, 1)
CURRENT_DAY = (datetime.date(1995, 6, 17) - START).days
LAST_ORDER_DAY = (datetime.date(1998, 12, 31) - START).days - 151
ALL_DAYS = np.array([(START + datetime.timedelta(days=d)).isoformat()
                     for d in range((datetime.date(1998, 12, 31) - START).days + 1)], dtype=object)
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
COMMENT_MIN, COMMENT_MAX = 10, 43
POOL_SEED = 19920101  # the pool is fixed, as dbgen's is; the seed draws offsets

# Clause 4.2.2.10's grammar and word lists, with dbgen's weights (dists.dss)
NOUNS = {"packages": 40, "requests": 40, "accounts": 40, "deposits": 40, "foxes": 20,
         "ideas": 20, "theodolites": 20, "pinto beans": 20, "instructions": 20,
         "dependencies": 10, "excuses": 10, "platelets": 10, "asymptotes": 10, "courts": 5,
         "dolphins": 5, "multipliers": 1, "sauternes": 1, "warthogs": 1, "frets": 1,
         "dinos": 1, "attainments": 1, "somas": 1, "Tiresias": 1, "patterns": 1, "forges": 1,
         "braids": 1, "frays": 1, "warhorses": 1, "dugouts": 1, "notornis": 1, "epitaphs": 1,
         "pearls": 1, "tithes": 1, "waters": 1, "orbits": 1, "gifts": 1, "sheaves": 1,
         "depths": 1, "sentiments": 1, "decoys": 1, "realms": 1, "pains": 1, "grouches": 1,
         "escapades": 1, "hockey players": 1}
VERBS = {"sleep": 20, "wake": 20, "are": 20, "cajole": 20, "haggle": 20, "nag": 10, "use": 10,
         "boost": 10, "affix": 5, "detect": 5, "integrate": 5, "maintain": 1, "nod": 1,
         "was": 1, "lose": 1, "sublate": 1, "solve": 1, "thrash": 1, "promise": 1, "engage": 1,
         "hinder": 1, "print": 1, "x-ray": 1, "breach": 1, "eat": 1, "grow": 1, "impress": 1,
         "mold": 1, "poach": 1, "serve": 1, "run": 1, "dazzle": 1, "snooze": 1, "doze": 1,
         "unwind": 1, "kindle": 1, "play": 1, "hang": 1, "believe": 1, "doubt": 1}
ADJECTIVES = {"special": 20, "pending": 20, "unusual": 20, "express": 20, "furious": 1,
              "sly": 1, "careful": 1, "blithe": 1, "quick": 1, "fluffy": 1, "slow": 1,
              "quiet": 1, "ruthless": 1, "thin": 1, "close": 1, "dogged": 1, "daring": 1,
              "brave": 1, "stealthy": 1, "permanent": 1, "enticing": 1, "idle": 1, "busy": 1,
              "regular": 50, "final": 40, "ironic": 40, "even": 30, "bold": 20, "silent": 10}
ADVERBS = {"sometimes": 1, "always": 1, "never": 1, "furiously": 50, "slyly": 50,
           "carefully": 50, "blithely": 40, "quickly": 30, "fluffily": 20, "slowly": 1,
           "quietly": 1, "ruthlessly": 1, "thinly": 1, "closely": 1, "doggedly": 1,
           "daringly": 1, "bravely": 1, "stealthily": 1, "permanently": 1, "enticingly": 1,
           "idly": 1, "busily": 1, "regularly": 1, "finally": 1, "ironically": 1, "evenly": 1,
           "boldly": 1, "silently": 1}
PREPOSITIONS = {"about": 50, "above": 50, "according to": 50, "across": 50, "after": 50,
                "against": 40, "along": 40, "alongside of": 30, "among": 30, "around": 20,
                "at": 10, "atop": 1, "before": 1, "behind": 1, "beneath": 1, "beside": 1,
                "besides": 1, "between": 1, "beyond": 1, "by": 1, "despite": 1, "during": 1,
                "except": 1, "for": 1, "from": 1, "in place of": 1, "inside": 1,
                "instead of": 1, "into": 1, "near": 1, "of": 1, "on": 1, "outside": 1,
                "over": 1, "past": 1, "since": 1, "through": 1, "throughout": 1, "to": 1,
                "toward": 1, "under": 1, "until": 1, "up": 1, "upon": 1, "without": 1,
                "with": 1, "within": 1}
AUXILIARIES = {w: 1 for w in ("do", "may", "might", "shall", "will", "would", "can", "could",
                              "should", "ought to", "must", "will have to", "shall have to",
                              "could have to", "should have to", "must have to", "need to",
                              "try to")}
TERMINATORS = {".": 50, ";": 1, ":": 1, "?": 1, "!": 1, "--": 1}
SENTENCES = {"N V T": 3, "N V P T": 3, "N V N T": 3, "N P V N T": 1, "N P V P T": 1}
NOUN_PHRASES = {"N": 10, "J N": 20, "J, J N": 10, "D J N": 50}
VERB_PHRASES = {"V": 30, "X V": 1, "V D": 40, "X V D": 1}


def _tokens(rng, table: dict, count: int, vocabulary: list, prefix: str = " ") -> np.ndarray:
    """`count` weighted draws from `table`, as ids into `vocabulary`."""
    first = len(vocabulary)
    vocabulary.extend(prefix + word for word in table)
    weights = np.array(list(table.values()), dtype=np.float64)
    return first + rng.choice(len(table), count, p=weights / weights.sum())


def _phrases(rng, table: dict, count: int) -> np.ndarray:
    forms = list(table)
    weights = np.array(list(table.values()), dtype=np.float64)
    return rng.choice(len(forms), count, p=weights / weights.sum())


def _noun_phrases(rng, count: int, vocabulary: list) -> np.ndarray:
    """Four token slots a phrase (-1 is empty): N | J N | J, J N | D J N."""
    form = _phrases(rng, NOUN_PHRASES, count)
    adjective1, adjective2 = (_tokens(rng, ADJECTIVES, count, vocabulary) for _ in range(2))
    adverb = _tokens(rng, ADVERBS, count, vocabulary)
    noun = _tokens(rng, NOUNS, count, vocabulary)
    comma = len(vocabulary)
    vocabulary.append(",")
    out = np.full((count, 4), -1, dtype=np.int64)
    out[:, 3] = noun
    out[:, 2] = np.where(form >= 1, adjective2, -1)
    out[:, 1] = np.where(form == 2, comma, -1)
    out[:, 0] = np.select([form == 2, form == 3], [adjective1, adverb], -1)
    return out


def _verb_phrases(rng, count: int, vocabulary: list) -> np.ndarray:
    """Three token slots a phrase: V | X V | V D | X V D."""
    form = _phrases(rng, VERB_PHRASES, count)
    out = np.full((count, 3), -1, dtype=np.int64)
    out[:, 0] = np.where(np.isin(form, (1, 3)), _tokens(rng, AUXILIARIES, count, vocabulary), -1)
    out[:, 1] = _tokens(rng, VERBS, count, vocabulary)
    out[:, 2] = np.where(np.isin(form, (2, 3)), _tokens(rng, ADVERBS, count, vocabulary), -1)
    return out


def _prepositional_phrases(rng, count: int, vocabulary: list) -> np.ndarray:
    """Six token slots a phrase: P the <noun phrase>."""
    preposition = _tokens(rng, PREPOSITIONS, count, vocabulary)
    the = len(vocabulary)
    vocabulary.append(" the")
    return np.column_stack([preposition, np.full(count, the), _noun_phrases(rng, count,
                                                                            vocabulary)])


@functools.lru_cache(maxsize=1)
def text_pool(size: int, seed: int = POOL_SEED) -> np.ndarray:
    """Sentences of Clause 4.2.2.10's grammar, `size` bytes of them, one
    space between words: N V T | N V P T | N V N T | N P V N T | N P V P T."""
    rng = np.random.default_rng(seed)
    count = size // 40 + 1  # sentences run longer than 40 bytes
    vocabulary: list = []
    form = _phrases(rng, SENTENCES, count)
    first = _noun_phrases(rng, count, vocabulary)
    inner = _prepositional_phrases(rng, count, vocabulary)
    inner[form < 3] = -1
    verb = _verb_phrases(rng, count, vocabulary)
    second = _noun_phrases(rng, count, vocabulary)
    second[(form != 2) & (form != 3)] = -1
    last = _prepositional_phrases(rng, count, vocabulary)
    last[(form != 1) & (form != 4)] = -1
    end = _tokens(rng, TERMINATORS, count, vocabulary, prefix="")
    tokens = np.column_stack([first, inner, verb, second, last, end]).ravel()
    tokens = tokens[tokens >= 0]
    words = [w.encode("ascii") for w in vocabulary]
    lengths = np.array([len(w) for w in words], dtype=np.int64)[tokens]
    flat = np.frombuffer(b"".join(words), dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])])[tokens]
    total = min(int(lengths.sum()), size + COMMENT_MAX)
    ends = np.cumsum(lengths)
    keep = int(np.searchsorted(ends, total)) + 1
    lengths, offsets, ends = lengths[:keep], offsets[:keep], ends[:keep]
    index = np.repeat(offsets - (ends - lengths), lengths) + np.arange(int(ends[-1]))
    pool = flat[index][:size]
    if len(pool) < size:
        raise ValueError(f"text pool of {len(pool)} bytes, wanted {size}")
    return pool


@dataclass
class Comments:
    """L_COMMENT: each row's text is pool[start : start + length]."""

    pool: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray

    def arrow(self, lo: int = 0, hi: int = None):
        """Rows lo .. hi as a pyarrow string array (plain bytes, no Python strings)."""
        import pyarrow as pa

        starts, lengths = self.starts[lo:hi], self.lengths[lo:hi]
        offsets = np.zeros(len(lengths) + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        index = np.repeat(starts - offsets[:-1], lengths) + np.arange(offsets[-1])
        return pa.StringArray.from_buffers(len(lengths), pa.py_buffer(offsets),
                                           pa.py_buffer(self.pool[index]))

    def values(self) -> np.ndarray:
        """The texts as a Python object array; for small tables."""
        raw = self.pool.tobytes()
        pairs = zip(self.starts.tolist(), self.lengths.tolist())
        return np.array([raw[s:s + n].decode("ascii") for s, n in pairs], dtype=object)

    def keys(self) -> np.ndarray:
        """A 64-bit polynomial hash of each text with its length mixed in,
        from prefix sums over the pool (vectorised; 2**64 wraps)."""
        base = np.uint64(1_000_003)
        inverse = np.uint64(pow(1_000_003, -1, 1 << 64))
        size = len(self.pool) + 1
        with np.errstate(over="ignore"):
            powers = np.empty(size, dtype=np.uint64)
            powers[0] = 1
            np.cumprod(np.full(size - 1, base, dtype=np.uint64), out=powers[1:])
            inverse_powers = np.empty(size, dtype=np.uint64)
            inverse_powers[0] = 1
            np.cumprod(np.full(size - 1, inverse, dtype=np.uint64), out=inverse_powers[1:])
            prefix = np.zeros(size, dtype=np.uint64)
            np.cumsum(self.pool.astype(np.uint64) * inverse_powers[:-1], out=prefix[1:])
            ends = self.starts + self.lengths
            hashed = (prefix[ends] - prefix[self.starts]) * powers[self.starts]
            return hashed ^ (self.lengths.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))


@dataclass
class LineitemData:
    """The generated table: numeric columns as arrays, short string
    columns as int32 codes into `dictionaries`, L_COMMENT as offsets into
    its pool, and the Parquet file written."""

    rows: int
    numeric: Dict[str, np.ndarray]
    codes: Dict[str, np.ndarray]
    dictionaries: Dict[str, np.ndarray]
    comments: Comments
    path: str = ""

    def strings(self, column: str) -> np.ndarray:
        """A string column's values (object array); for small tables."""
        if column == "l_comment":
            return self.comments.values()
        return self.dictionaries[column][self.codes[column]]


def _coded(codes: np.ndarray, dictionary) -> tuple:
    """Codes and dictionary cut to the entries in use, in dictionary order."""
    dictionary = np.asarray(dictionary, dtype=object)
    used = np.flatnonzero(np.bincount(codes, minlength=len(dictionary)))
    remap = np.zeros(len(dictionary), dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return remap[codes], dictionary[used]


def _line_counts(rng, orders: int, rows: int) -> np.ndarray:
    """1-7 lines an order, moved by one line in random orders to sum to `rows`."""
    counts = rng.integers(1, 8, orders)
    if not orders <= rows <= 7 * orders:
        raise ValueError(f"{rows} rows do not fit {orders} orders of 1-7 lines")
    gap = rows - int(counts.sum())
    while gap:
        step = 1 if gap > 0 else -1
        movable = np.flatnonzero(counts < 7 if step > 0 else counts > 1)
        picked = rng.choice(movable, min(abs(gap), len(movable)), replace=False)
        counts[picked] += step
        gap -= step * len(picked)
    return counts


def generate(rows: int, seed: int, scale_factor: float = 1.0, pool_bytes: int = 8 << 20
             ) -> LineitemData:
    """Clause 4.2.3's lineitem rows from `seed`."""
    rng = np.random.default_rng(seed)
    orders = max(rows // 4, (rows + 6) // 7)
    parts, suppliers = int(scale_factor * 200_000), int(scale_factor * 10_000)
    counts = _line_counts(rng, orders, rows)
    index = np.arange(1, orders + 1, dtype=np.int64)
    orderkey = ((index >> 3) << 5) | (index & 7)  # dbgen's mk_sparse: 8 keys of every 32
    first = np.repeat(np.cumsum(counts) - counts, counts)
    linenumber = np.arange(rows, dtype=np.int64) - first + 1
    orderdate = np.repeat(rng.integers(0, LAST_ORDER_DAY + 1, orders), counts)
    partkey = rng.integers(1, parts + 1, rows)
    supplier = rng.integers(0, 4, rows)
    suppkey = (partkey + supplier * (suppliers // 4 + (partkey - 1) // suppliers)) % suppliers + 1
    quantity = rng.integers(1, 51, rows)
    retail_cents = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)
    ship = orderdate + rng.integers(1, 122, rows)
    commit = orderdate + rng.integers(30, 91, rows)
    receipt = ship + rng.integers(1, 31, rows)
    returned = rng.integers(0, 2, rows)  # R or A, where the receipt is on or before today
    numeric = {
        "l_orderkey": np.repeat(orderkey, counts),
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": quantity,
        "l_extendedprice": (quantity * retail_cents) / 100.0,
        "l_discount": rng.integers(0, 11, rows) / 100.0,
        "l_tax": rng.integers(0, 9, rows) / 100.0,
    }
    raw = {
        "l_returnflag": (np.where(receipt <= CURRENT_DAY, returned * 2, 1), ("A", "N", "R")),
        "l_linestatus": (np.where(ship > CURRENT_DAY, 0, 1), ("O", "F")),
        "l_shipdate": (ship, ALL_DAYS),
        "l_commitdate": (commit, ALL_DAYS),
        "l_receiptdate": (receipt, ALL_DAYS),
        "l_shipinstruct": (rng.integers(0, 4, rows), INSTRUCTIONS),
        "l_shipmode": (rng.integers(0, 7, rows), MODES),
    }
    codes, dictionaries = {}, {}
    for name, (values, dictionary) in raw.items():
        codes[name], dictionaries[name] = _coded(values.astype(np.int32), dictionary)
    pool = text_pool(pool_bytes)
    lengths = rng.integers(COMMENT_MIN, COMMENT_MAX + 1, rows)
    starts = rng.integers(0, len(pool) - COMMENT_MAX + 1, rows)
    return LineitemData(rows, numeric, codes, dictionaries, Comments(pool, starts, lengths))


def write(data: LineitemData, path: str, row_group_rows: int, compression: str) -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq

    dictionaries = {name: pa.array(list(data.dictionaries[name]), type=pa.string())
                    for name in CODED}
    schema = pa.schema([(name, pa.dictionary(pa.int32(), pa.string()) if name in CODED
                         else pa.string() if name in STRINGS
                         else pa.from_numpy_dtype(data.numeric[name].dtype)) for name in COLUMNS])
    with pq.ParquetWriter(path, schema, compression=compression, store_schema=False,
                          use_dictionary=list(CODED)) as writer:
        for lo in range(0, data.rows, row_group_rows):
            hi = min(lo + row_group_rows, data.rows)
            arrays = []
            for name in COLUMNS:
                if name in data.numeric:
                    arrays.append(pa.array(data.numeric[name][lo:hi]))
                elif name in CODED:
                    arrays.append(pa.DictionaryArray.from_arrays(
                        pa.array(data.codes[name][lo:hi]), dictionaries[name]))
                else:
                    arrays.append(data.comments.arrow(lo, hi))
            writer.write_table(pa.Table.from_arrays(arrays, schema=schema),
                               row_group_size=row_group_rows)
    data.path = path
    return path


def make(config: dict, seed: int, workdir: str, rows: int = None, write_file: bool = True
         ) -> LineitemData:
    """The configuration's table from `seed`, written under `workdir`.
    `rows` overrides the configured count (the CPU tests' tiny tables);
    `write_file=False` makes the same arrays again for a file already
    written there."""
    data = generate(rows or config["rows"], seed, config["scale_factor"],
                    config["text_pool_bytes"])
    path = os.path.join(workdir, "lineitem.parquet")
    if write_file:
        os.makedirs(workdir, exist_ok=True)
        write(data, path, config["row_group_rows"], config["compression"])
    data.path = path
    return data
