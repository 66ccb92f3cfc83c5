"""K5 (`cuda_kernels.classify_hash_dictionary`) on the card against its
plain version, bit for bit: the edge corpus of
deequ_tpu_torch/testing/strings_corpus.py and one SF 1 batch of TPC-H
comments from the benchmark's generator (1,048,576 rows, about 910,000
dictionary entries). A CUDA kernel has no CPU mode, so these tests skip
without a card. The directory's conftest imports JAX, which the card's
machine lacks; this file imports none, so it runs there without it:

    python -m pytest --noconftest -m card tests/test_torch_strings_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deequ_tpu_torch.ops import cuda_kernels as ck
from deequ_tpu_torch.testing import strings_corpus

pytestmark = pytest.mark.card

SF1_BATCH = 1 << 20  # the benchmark's row group, one batch of its stream


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _same_on_card(offsets, data, codes, device):
    """The kernel's rows against the plain version's, both on the card."""
    args = [torch.from_numpy(a).to(device) for a in (offsets, data, codes)]
    before = ck.classify_hash_dictionary.launches
    classes, packed = ck.classify_hash_dictionary(*args)
    torch.cuda.synchronize(device)
    assert ck.classify_hash_dictionary.launches == before + 1
    want_classes, want_packed = ck.classify_hash_dictionary_plain(*args)
    assert torch.equal(classes, want_classes)
    assert torch.equal(packed, want_packed)
    return classes, packed


def test_edge_corpus_matches_plain_bit_for_bit(cuda):
    values = strings_corpus.EDGE_CASES + strings_corpus.fuzz(5000, seed=19)
    offsets, data = strings_corpus.utf8_arrays(values)
    n = len(values)
    # every entry once, then nulls, repeats and the last entry
    codes = np.concatenate([np.arange(n), [-1, 0, n - 1, -1, 3]]).astype(np.int32)
    classes, packed = _same_on_card(offsets, data, codes, cuda)
    assert classes[n].item() == 0 and packed[n].item() == 0  # a null row


def test_sf1_batch_of_comments_matches_plain_bit_for_bit(cuda):
    import pyarrow as pa

    from benchmark.gen import lineitem

    comments = lineitem.generate(SF1_BATCH, seed=12345).comments.arrow()
    encoded = comments.dictionary_encode()
    dictionary = encoded.dictionary
    buffers = dictionary.buffers()
    offsets = np.frombuffer(buffers[1], dtype=np.int32)[: len(dictionary) + 1]
    data = np.frombuffer(buffers[2], dtype=np.uint8)[: int(offsets[-1])]
    codes = encoded.indices.to_numpy().astype(np.int32)
    assert len(dictionary) > 1 << 16 and pa.types.is_string(dictionary.type)
    _same_on_card(offsets.astype(np.int64), data.copy(), codes, cuda)
