"""NEXMark's Bid events for one day, as numpy arrays held in memory.

The rules of the NEXMark event generator (Tucker et al. 2008, as Apache
Beam's `sdks/java/testing/nexmark` and the Flink suite
`github.com/nexmark/nexmark` write it), with its default settings,
vectorised in numpy from the seed:

- Of every 50 events, 1 is a Person, 3 are Auctions and 46 are Bids:
  event i is a bid when `i % 50 >= 4`. Only the bids are made.
- For the bid of event i, `last_person = i // 50` and
  `last_auction = (i // 50) * 3 + 2`, both 0-based: the newest person
  and auction before it (Beam's `lastBase0PersonId` and
  `lastBase0AuctionId`).
- auction: with chance 1/2 (`hotAuctionRatio` 2) the hot auction
  `(last_auction // 100) * 100`, else uniform over
  `[max(last_auction - 100, 0), last_auction + 10]` (100 auctions in
  flight, a lead of 10); plus 1000 (`FIRST_AUCTION_ID`).
- bidder: with chance 3/4 (`hotBiddersRatio` 4) the hot bidder
  `(last_person // 100) * 100 + 1`, else uniform over the last
  `min(last_person + 1, 1000)` people and a lead of 10
  (`numActivePeople` 1000); plus 1000 (`FIRST_PERSON_ID`).
- price, in cents: `round(10 ** (6 u) * 100)`, u uniform in [0, 1)
  (Java's `Math.round`: half up), so each of Query 15's bands (below
  10,000, below 1,000,000, the rest) holds a third of the bids.
- channel and url (the Flink suite's `BidGenerator`): with chance 1/2
  (`HOT_CHANNELS_RATIO` 2) one of the four hot channels, uniform, with
  its fixed url; else `channel-<k>`, k uniform below 10,000
  (`CHANNELS_NUMBER`), whose url is made once per channel: a base url
  `https://www.nexmark.com/<s>/<s>/<s>/item.htm?query=1` (each s 3-4
  characters, a in 13 of them `_`, else a to z), with chance 9/10
  followed by `&channel_id=<abs(Integer.reverse(k))>`.
- date_time, in ms: the suite's base time (2015-07-15 00:00 UTC) plus
  `i / 10,000,000` s (its first event rate, 10,000,000 events/s), so
  100,000,000 events span 10 s of one day.
- extra: padding to the suite's `avgBidByteSize` 100. The four 8-byte
  fields count 32 bytes, so 68 are wanted: `nextExtra` draws a length
  uniform in [68 - 14, 68 + 14) and fills it with letters a to z.

The bid's fields, in the Flink suite's order: auction, bidder, price,
channel, url, date_time, extra. The four numbers are int64 arrays; channel
and url are Arrow string dictionaries over the 10,004 channels, sharing
one int32 code array (a url is its channel's); extra is an Arrow large
string array (about 6.2 GB at 92,000,000 bids).

numpy's generator stands in for Java's `Random`: the same rules, other
draws. The bids are made in blocks of `BLOCK` rows, block b from its own
`default_rng([seed, b])`, the extras' letters in blocks of
`LETTER_BLOCK` bytes from `[seed, c, 1]` and the urls from
`[seed, 0, 2]`, on a few threads at once: the arrays are the same
whatever the thread count.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

COLUMNS = ("auction", "bidder", "price", "channel", "url", "date_time", "extra")
NUMBERS = ("auction", "bidder", "price", "date_time")
EVENTS_PER_CYCLE, BIDS_PER_CYCLE = 50, 46  # person:auction:bid 1:3:46
FIRST_BID_OFFSET = EVENTS_PER_CYCLE - BIDS_PER_CYCLE
AUCTIONS_PER_CYCLE = 3
FIRST_PERSON_ID = FIRST_AUCTION_ID = 1000
HOT_AUCTION_RATIO, HOT_BIDDERS_RATIO = 2, 4
HOT_STRIDE = 100  # hot auctions and bidders are multiples of 100 (bidders plus 1)
IN_FLIGHT_AUCTIONS, AUCTION_LEAD = 100, 10
ACTIVE_PEOPLE, PERSON_LEAD = 1000, 10
BASE_TIME_MS = 1_436_918_400_000  # 2015-07-15T00:00:00Z
EVENTS_PER_MS = 10_000  # 10,000,000 events/s
HOT_CHANNELS = ("Google", "Facebook", "Baidu", "Apple")
HOT_CHANNELS_RATIO, CHANNELS_NUMBER = 2, 10_000
CHANNEL_ID_RATIO = 10  # 9 of 10 channels' urls name the channel's id
AVG_BID_BYTE_SIZE, BID_FIXED_BYTES = 100, 8 + 8 + 8 + 8
EXTRA_BYTES = AVG_BID_BYTE_SIZE - BID_FIXED_BYTES  # 68
EXTRA_DELTA = round(EXTRA_BYTES * 0.2)  # 14: lengths in [54, 82)
BLOCK = 1 << 23
LETTER_BLOCK = 1 << 26


@dataclass
class NexmarkData:
    """The bids, no nulls: the numbers as int64 arrays, the strings as
    Arrow arrays; with `flags`, each bid's hot draws as well (for the
    tests)."""

    rows: int
    events: int
    columns: Dict[str, object]
    hot_auction: Optional[np.ndarray] = None
    hot_bidder: Optional[np.ndarray] = None
    hot_channel: Optional[np.ndarray] = None
    path: Optional[str] = None  # held in memory: no file


def bid_events(first: int, count: int) -> np.ndarray:
    """The event numbers of bids first .. first + count - 1."""
    k = np.arange(first, first + count, dtype=np.int64)
    return (k // BIDS_PER_CYCLE) * EVENTS_PER_CYCLE + FIRST_BID_OFFSET + k % BIDS_PER_CYCLE


def bids_in(events: int) -> int:
    """How many of events 0 .. events - 1 are bids."""
    cycles, rest = divmod(events, EVENTS_PER_CYCLE)
    return cycles * BIDS_PER_CYCLE + max(rest - FIRST_BID_OFFSET, 0)


def events_for(rows: int) -> int:
    """The fewest events that hold `rows` bids."""
    cycles, rest = divmod(rows, BIDS_PER_CYCLE)
    return cycles * EVENTS_PER_CYCLE + (FIRST_BID_OFFSET + rest if rest else 0)


def java_reverse_abs(k: np.ndarray) -> np.ndarray:
    """Java's `Math.abs(Integer.reverse(k))` of non-negative ints (abs of
    Integer.MIN_VALUE stays negative, as in Java)."""
    x = np.asarray(k, dtype=np.uint32)
    r = np.zeros_like(x)
    for bit in range(32):
        r |= ((x >> np.uint32(bit)) & np.uint32(1)) << np.uint32(31 - bit)
    signed = r.view(np.int32).astype(np.int64)
    return np.where(signed == -(2**31), signed, np.abs(signed))


def channels(seed: int):
    """(channel names, their urls): the four hot channels first, then
    `channel-0` .. `channel-9999`, from the seed's own generator. Each
    url's three parts are Beam's `nextString(random, 5, '_')`: 3 or 4
    characters, each `_` with chance 1/13, else a to z."""
    rng = np.random.default_rng([seed, 0, 2])
    k = len(HOT_CHANNELS) + CHANNELS_NUMBER
    lengths = 3 + rng.integers(0, 2, (k, 3))
    letters = np.where(rng.integers(0, 13, (k, 3, 4)) == 0, ord("_"),
                       ord("a") + rng.integers(0, 26, (k, 3, 4))).astype(np.uint8)
    named = rng.integers(0, CHANNEL_ID_RATIO, CHANNELS_NUMBER) > 0
    ids = java_reverse_abs(np.arange(CHANNELS_NUMBER)).tolist()
    urls = []
    for i in range(k):
        parts = "/".join(letters[i, j, :lengths[i, j]].tobytes().decode() for j in range(3))
        url = f"https://www.nexmark.com/{parts}/item.htm?query=1"
        c = i - len(HOT_CHANNELS)
        if c >= 0 and named[c]:
            url += f"&channel_id={ids[c]}"
        urls.append(url)
    names = list(HOT_CHANNELS) + [f"channel-{c}" for c in range(CHANNELS_NUMBER)]
    return names, urls


def _fill(out: Dict[str, np.ndarray], flags, seed: int, lo: int, n: int) -> None:
    """Bids lo .. lo + n - 1 (one block) into `out`, from the block's own
    generator: the numbers, the channel codes and the extras' lengths
    (`out["extra_ends"][lo + 1 .. lo + n]`, summed to offsets later)."""
    hot_a, hot_b, hot_c = flags
    rng = np.random.default_rng([seed, lo // BLOCK])
    i = bid_events(lo, n)
    cycle = i // EVENTS_PER_CYCLE
    last_person = cycle
    last_auction = cycle * AUCTIONS_PER_CYCLE + AUCTIONS_PER_CYCLE - 1

    hot = rng.integers(0, HOT_AUCTION_RATIO, n) > 0
    low = np.maximum(last_auction - IN_FLIGHT_AUCTIONS, 0)
    drawn = low + rng.integers(0, last_auction - low + 1 + AUCTION_LEAD)
    out["auction"][lo:lo + n] = np.where(
        hot, (last_auction // HOT_STRIDE) * HOT_STRIDE, drawn) + FIRST_AUCTION_ID
    if hot_a is not None:
        hot_a[lo:lo + n] = hot

    hot = rng.integers(0, HOT_BIDDERS_RATIO, n) > 0
    people = last_person + 1
    active = np.minimum(people, ACTIVE_PEOPLE)
    drawn = people - active + rng.integers(0, active + PERSON_LEAD)
    out["bidder"][lo:lo + n] = np.where(
        hot, (last_person // HOT_STRIDE) * HOT_STRIDE + 1, drawn) + FIRST_PERSON_ID
    if hot_b is not None:
        hot_b[lo:lo + n] = hot

    out["price"][lo:lo + n] = np.floor(10.0 ** (6.0 * rng.random(n)) * 100.0 + 0.5)

    hot = rng.integers(0, HOT_CHANNELS_RATIO, n) > 0
    out["channel"][lo:lo + n] = np.where(
        hot, rng.integers(0, len(HOT_CHANNELS), n),
        len(HOT_CHANNELS) + rng.integers(0, CHANNELS_NUMBER, n))
    if hot_c is not None:
        hot_c[lo:lo + n] = hot

    out["date_time"][lo:lo + n] = BASE_TIME_MS + i // EVENTS_PER_MS
    out["extra_ends"][lo + 1:lo + n + 1] = EXTRA_BYTES - EXTRA_DELTA + rng.integers(
        0, 2 * EXTRA_DELTA, n)


def _letters(data: np.ndarray, seed: int, lo: int) -> None:
    """The extras' letters lo .. lo + LETTER_BLOCK - 1, from their own
    generator."""
    rng = np.random.default_rng([seed, lo // LETTER_BLOCK, 1])
    n = min(LETTER_BLOCK, len(data) - lo)
    data[lo:lo + n] = rng.integers(ord("a"), ord("z") + 1, n, dtype=np.uint8)


def generate(events: int, seed: int, flags: bool = False, strings: bool = True
             ) -> NexmarkData:
    """The bids of events 0 .. events - 1; without `strings`, the four
    numbers alone (what the reference reads)."""
    import pyarrow as pa

    rows = bids_in(events)
    out = {name: np.empty(rows, dtype=np.int64) for name in NUMBERS}
    out["channel"] = np.empty(rows, dtype=np.int32)
    out["extra_ends"] = ends = np.zeros(rows + 1, dtype=np.int64)
    hot = tuple(np.empty(rows, dtype=bool) if flags else None for _ in range(3))
    blocks = [(lo, min(BLOCK, rows - lo)) for lo in range(0, rows, BLOCK)]
    with ThreadPoolExecutor(max(1, min(32, os.cpu_count() or 1))) as pool:
        for done in [pool.submit(_fill, out, hot, seed, lo, n) for lo, n in blocks]:
            done.result()
        if not strings:
            return NexmarkData(rows, events, {name: out[name] for name in NUMBERS}, *hot)
        np.cumsum(ends, out=ends)
        data = np.empty(int(ends[-1]), dtype=np.uint8)
        for done in [pool.submit(_letters, data, seed, lo)
                     for lo in range(0, len(data), LETTER_BLOCK)]:
            done.result()
    names, urls = channels(seed)
    codes = pa.array(out.pop("channel"))
    columns = {name: out[name] for name in ("auction", "bidder", "price")}
    columns["channel"] = pa.DictionaryArray.from_arrays(codes, pa.array(names))
    columns["url"] = pa.DictionaryArray.from_arrays(codes, pa.array(urls))
    columns["date_time"] = out["date_time"]
    columns["extra"] = pa.LargeStringArray.from_buffers(
        rows, pa.py_buffer(out.pop("extra_ends")), pa.py_buffer(data))
    return NexmarkData(rows, events, columns, *hot)


def make(config: dict, seed: int, workdir: str, rows: int = None, write_file: bool = True
         ) -> NexmarkData:
    """The configuration's bids from `seed`. `rows` overrides the
    configured scale with the fewest events that hold that many bids
    (the CPU tests' tiny tables). Nothing is written: the table is held
    in memory, so `workdir` goes unused; `write_file=False` (the
    harness's copy for the reference, after the window) makes the four
    numbers alone, the only fields the reference reads."""
    return generate(events_for(rows) if rows else config["events"], seed, strings=write_file)
