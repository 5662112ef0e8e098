"""The port's ``Vocabulary`` and ``TokenEmbedding`` against the JAX
package's ``text`` module, on the CPU: the same counters give the same
indices, reserved tokens and lookups; the same embedding files give the
same vectors, the port's table a float32 ``torch.Tensor`` with the JAX
package's values."""

import collections
import contextlib
import warnings

import numpy as np
import pytest
import torch

from dt_tpu import text as jtext
from dt_tpu_torch import text as ttext
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _counter(seed=0, n=400):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(60)]
    return collections.Counter(rng.choice(words, n).tolist())


@pytest.mark.parametrize("kw", [
    {}, {"reserved_tokens": ["<pad>", "<bos>", "<eos>"]},
    {"most_freq_count": 10, "unknown_token": "<oov>"},
    {"min_freq": 7, "reserved_tokens": ["w3"]}])
def test_vocabulary_matches(kw):
    counter = _counter()
    t, j = ttext.Vocabulary(counter, **kw), jtext.Vocabulary(counter, **kw)
    assert t.idx_to_token == j.idx_to_token
    assert t.token_to_idx == j.token_to_idx
    assert len(t) == len(j)
    assert t.reserved_tokens == j.reserved_tokens
    probe = ["w0", "w59", "nope", "<pad>", "w3"]
    assert t.to_indices(probe) == j.to_indices(probe)
    assert t.to_indices("w1") == j.to_indices("w1")
    assert t.to_tokens(list(range(len(t)))) == j.to_tokens(
        list(range(len(j))))
    with pytest.raises(IndexError):
        t.to_tokens(len(t))


def test_vocabulary_refusals_and_counts():
    for kw in ({"min_freq": 0}, {"reserved_tokens": ["<unk>"]},
               {"reserved_tokens": ["x", "x"]}):
        with pytest.raises(ValueError):
            ttext.Vocabulary({"a": 1}, **kw)
    toks = "the cat sat on the mat".split()
    assert ttext.Vocabulary.count_tokens(toks) == \
        jtext.Vocabulary.count_tokens(toks)


@pytest.mark.parametrize("body", [
    "hello 1.0 2.0 3.0\nworld 4.0 5.0 6.0\n",
    "3 2\nfoo 1.0 -1.0\nbar 0.5 0.25\n. . 0.1 0.2\nbaz 7 8\n",
    "a 1.0\nb 2.5\n",
    "x 0.1 0.2\ny 0.3\nz 0.5 0.6\n"])
def test_token_embedding_from_file_matches(tmp_path, body):
    """Plain files, a fastText header, a token with spaces, 1-d vectors and
    a dim-mismatch line (both skip it with a warning)."""
    p = tmp_path / "vecs.txt"
    p.write_text(body)
    vocab_t = ttext.Vocabulary({"foo": 3, "a": 2, "x": 2, "hello": 1,
                                "zzz": 1})
    vocab_j = jtext.Vocabulary({"foo": 3, "a": 2, "x": 2, "hello": 1,
                                "zzz": 1})
    with _quiet():
        t = ttext.TokenEmbedding.from_file(str(p), vocabulary=vocab_t)
        j = jtext.TokenEmbedding.from_file(str(p), vocabulary=vocab_j)
    assert t.dim == j.dim
    toks = ["hello", "world", "foo", "bar", "baz", "a", "b", "x", "y", "z",
            "missing"]
    np.testing.assert_array_equal(t.get_vecs_by_tokens(toks),
                                  j.get_vecs_by_tokens(toks))
    np.testing.assert_array_equal(t.get_vecs_by_tokens("missing"),
                                  j.get_vecs_by_tokens("missing"))
    table = t.idx_to_vec
    assert isinstance(table, torch.Tensor) and table.dtype == torch.float32
    np.testing.assert_array_equal(table.numpy(), np.asarray(j.idx_to_vec))


@contextlib.contextmanager
def _quiet():
    """The loaders warn about the lines they skip; the tests expect it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def test_token_embedding_refusals(tmp_path):
    p = tmp_path / "empty.txt"
    p.write_text("just\n")
    with pytest.raises(ValueError, match="no vectors"):
        ttext.TokenEmbedding.from_file(str(p))
    p.write_text("a 1\nb 1 2\nc 1 2\nd 1 2\n")
    with _quiet(), pytest.raises(ValueError, match="dim-mismatch"):
        ttext.TokenEmbedding.from_file(str(p))
    emb = ttext.TokenEmbedding({"a": np.ones(2, np.float32)}, 2,
                               init_unknown_vec=np.ones)
    np.testing.assert_array_equal(emb.get_vecs_by_tokens("zz"), [1, 1])
    with pytest.raises(ValueError, match="no vocabulary"):
        emb.idx_to_vec
