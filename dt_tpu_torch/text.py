"""Text utilities: vocabulary and pretrained token embeddings (counterpart
of ``dt_tpu/text.py``).

Reference: ``python/mxnet/contrib/text/`` — ``vocab.py:1`` (``Vocabulary``:
frequency-sorted indexing with unknown + reserved tokens), ``embedding.py``
(``CustomEmbedding``/glove-style ``.vec`` file loading,
``get_vecs_by_tokens``, attaching vectors to a vocabulary).

Vectors are numpy float32 as in the JAX package, except the table
:attr:`TokenEmbedding.idx_to_vec`, a float32 ``torch.Tensor`` on the CPU
that drops into an embedding as its initial value (the JAX package's
docstring promises a ``jnp`` array; it gives numpy); its values are the
JAX package's.
"""

from __future__ import annotations

import collections
from typing import Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np
import torch


class Vocabulary:
    """Frequency-ordered token index.

    Index 0 is ``unknown_token``, then ``reserved_tokens``, then counter
    keys sorted by (-frequency, token) — the reference's ordering
    (``vocab.py``).  ``most_freq_count`` / ``min_freq`` restrict which
    counter keys are indexed (neither restricts reserved tokens).
    """

    def __init__(self, counter: Optional[Dict[Hashable, int]] = None,
                 most_freq_count: Optional[int] = None, min_freq: int = 1,
                 unknown_token: Hashable = "<unk>",
                 reserved_tokens: Optional[Sequence[Hashable]] = None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        reserved = list(reserved_tokens or [])
        if unknown_token in reserved or len(set(reserved)) != len(reserved):
            raise ValueError("reserved_tokens must be unique and must not "
                             "contain unknown_token")
        self.unknown_token = unknown_token
        self.reserved_tokens = reserved
        self._idx_to_token: List[Hashable] = [unknown_token] + reserved
        if counter:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1],
                                                            str(kv[0])))
            kept = 0
            for tok, freq in pairs:
                if freq < min_freq:
                    break
                if most_freq_count is not None and kept >= most_freq_count:
                    break
                if tok == unknown_token or tok in set(reserved):
                    continue
                self._idx_to_token.append(tok)
                kept += 1
        self._token_to_idx = {t: i for i, t in
                              enumerate(self._idx_to_token)}

    def __len__(self) -> int:
        return len(self._idx_to_token)

    @property
    def idx_to_token(self) -> List[Hashable]:
        return list(self._idx_to_token)

    @property
    def token_to_idx(self) -> Dict[Hashable, int]:
        return dict(self._token_to_idx)

    def to_indices(self, tokens) -> object:
        """Token (or list of tokens) -> index/indices; unknown -> 0."""
        if isinstance(tokens, (list, tuple)):
            return [self._token_to_idx.get(t, 0) for t in tokens]
        return self._token_to_idx.get(tokens, 0)

    def to_tokens(self, indices) -> object:
        """Index (or list) -> token(s); raises on out-of-range."""
        if isinstance(indices, (list, tuple)):
            return [self._idx_to_token[i] for i in indices]
        return self._idx_to_token[indices]

    @staticmethod
    def count_tokens(source: Iterable[Hashable]) -> collections.Counter:
        """Count tokens from an iterable (``utils.py`` count_tokens_from_str
        analog for pre-tokenized input)."""
        return collections.Counter(source)


class TokenEmbedding:
    """Pretrained token vectors attached to a :class:`Vocabulary`.

    Reference: ``embedding.py`` CustomEmbedding — loads a glove/fastText
    style text file (``token v1 v2 ... vD`` per line), exposes
    ``get_vecs_by_tokens`` and a full ``idx_to_vec`` table for the
    vocabulary, with ``init_unknown_vec`` (default zeros) for missing
    tokens.
    """

    def __init__(self, token_to_vec: Dict[Hashable, np.ndarray], dim: int,
                 vocabulary: Optional[Vocabulary] = None,
                 init_unknown_vec=np.zeros):
        self._map = token_to_vec
        self.dim = dim
        self._unk = np.asarray(init_unknown_vec(dim), np.float32)
        self.vocabulary = vocabulary

    @classmethod
    def from_file(cls, path: str, vocabulary: Optional[Vocabulary] = None,
                  init_unknown_vec=np.zeros, encoding: str = "utf-8"):
        """Parse a ``token v1 ... vD`` text file (glove ``.txt`` /
        fastText ``.vec``; a leading ``count dim`` header line is
        skipped, like the reference's fastText handling)."""
        table: Dict[Hashable, np.ndarray] = {}
        dim = None
        skipped_dim = 0
        with open(path, encoding=encoding) as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip().split(" ")
                if lineno == 0 and len(parts) == 2:
                    try:  # fastText "count dim" header: both fields ints
                        int(parts[0]), int(parts[1])
                        continue
                    except ValueError:
                        pass  # a real (token, 1-d vector) line
                if len(parts) < 2:
                    continue
                try:
                    vec = np.asarray([float(v) for v in parts[1:]],
                                     np.float32)
                except ValueError:
                    # token itself contains spaces (real GloVe files have
                    # lines like ". . . 0.1 ...") — warn and skip, like
                    # the reference loader, instead of aborting the file
                    import warnings
                    warnings.warn(f"{path}:{lineno + 1}: unparsable "
                                  "embedding line skipped")
                    continue
                if dim is None:
                    dim = len(vec)
                elif len(vec) != dim:
                    import warnings
                    warnings.warn(f"{path}:{lineno + 1}: dim {len(vec)} "
                                  f"!= {dim}; line skipped")
                    skipped_dim += 1
                    continue
                table[parts[0]] = vec
        if skipped_dim > len(table):
            # a truncated/garbled FIRST line locks `dim` to the wrong
            # value and sheds every real vector as "dim mismatch"; when
            # those outnumber the keeps the file (not the odd line) is
            # the problem — fail loudly.  Unparsable-token skips (GloVe
            # multi-space tokens) are normal and don't count.
            raise ValueError(
                f"{path}: {skipped_dim} dim-mismatch lines vs "
                f"{len(table)} kept — wrong dim lock or corrupt file?")
        if dim is None:
            raise ValueError(f"{path}: no vectors found")
        return cls(table, dim, vocabulary, init_unknown_vec)

    def get_vecs_by_tokens(self, tokens) -> np.ndarray:
        """Token (or list) -> (D,) or (N, D) float32 vectors; unknown
        tokens get the init_unknown_vec value."""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else list(tokens)
        out = np.stack([self._map.get(t, self._unk) for t in toks])
        return out[0] if single else out

    @property
    def idx_to_vec(self) -> torch.Tensor:
        """(len(vocab), D) float32 table aligned to the attached
        vocabulary — drop-in initializer for an embedding layer."""
        if self.vocabulary is None:
            raise ValueError("no vocabulary attached")
        return torch.from_numpy(
            self.get_vecs_by_tokens(self.vocabulary.idx_to_token))
