"""The port's byte BPE (``data/tokenizer.py``, built from
``native/bpe.cpp`` into the port's build directory) against the JAX
package's ``Tokenizer`` on one seeded corpus: the same merges, ids
integer-equal, the same decoded text; ``TokenizedTextDataset`` windows
and ``pack_documents`` rows integer-equal to the JAX ones."""

import numpy as np
import pytest

from pytorch_distributed_tpu.data.packing import (
    pack_documents as jax_pack_documents,
)
from pytorch_distributed_tpu.data.tokenizer import (
    TokenizedTextDataset as JaxTokenizedTextDataset,
    Tokenizer as JaxTokenizer,
)
from pytorch_distributed_tpu_torch.data import (
    TokenizedTextDataset,
    Tokenizer,
    pack_documents,
)
from pytorch_distributed_tpu_torch.utils import native_build
from tests.torch_parity import assert_equal


def _corpus(seed=0, paragraphs=40):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghij klmnopqrstuvwxyz.,"))
    words = ["".join(rng.choice(letters, rng.integers(2, 8)))
             for _ in range(60)] + ["ünïcode", "日本", "naïve"]
    return "\n\n".join(" ".join(rng.choice(words, rng.integers(5, 40)))
                       for _ in range(paragraphs))


@pytest.fixture(scope="module")
def pair():
    corpus = _corpus()
    return corpus, Tokenizer.train(corpus, 400), JaxTokenizer.train(corpus,
                                                                    400)


def test_ids_and_round_trip_equal_the_jax_tokenizer(pair):
    corpus, tok, jtok = pair
    assert tok.vocab_size == jtok.vocab_size
    assert_equal(tok.merges, jtok.merges, "merges")
    ids = tok.encode(corpus)
    assert_equal(ids, jtok.encode(corpus), "ids")
    assert tok.decode(ids) == corpus == jtok.decode(ids)
    assert tok.decode_bytes(tok.encode(b"\xff\x00 bytes")) == \
        b"\xff\x00 bytes"
    with pytest.raises(ValueError):
        tok.decode([tok.vocab_size])


def test_windows_and_packed_rows_equal_jax(pair, tmp_path):
    corpus, tok, jtok = pair
    ds = TokenizedTextDataset(corpus, tok, 32, stride=16, max_windows=20)
    jds = JaxTokenizedTextDataset(corpus, jtok, 32, stride=16,
                                  max_windows=20)
    assert len(ds) == len(jds) and ds.num_tokens == jds.num_tokens
    for i in (0, 7, len(ds) - 1):
        assert_equal(ds[i]["input_ids"], jds[i]["input_ids"], f"window {i}")
    assert_equal(ds[np.arange(5)]["input_ids"],
                 jds[np.arange(5)]["input_ids"], "batch")
    docs = [tok.encode(p) for p in corpus.split("\n\n") if p.strip()]
    jdocs = [jtok.encode(p) for p in corpus.split("\n\n") if p.strip()]
    got, want = pack_documents(docs, 64), jax_pack_documents(jdocs, 64)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_equal(got[k], want[k], k)
    tok.save(str(tmp_path / "tok"))
    assert_equal(Tokenizer.load(str(tmp_path / "tok")).merges, tok.merges,
                 "saved merges")
    with pytest.raises(ValueError, match="too short"):
        TokenizedTextDataset("ab", tok, 32)


def test_the_library_is_built_beside_the_port_not_in_native():
    path = native_build.build_native_library("bpe")
    assert path.startswith(str(native_build.BUILD_DIR))
    assert native_build.build_native_library("bpe") == path
