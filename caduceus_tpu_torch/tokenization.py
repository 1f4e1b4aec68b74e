"""Character-level DNA tokenizers as pure numpy vocab tables.

An owned copy of `caduceus_tpu/tokenization.py` (same vocabulary ids and
complement map). Capability parity with the reference tokenizers:
- `caduceus/tokenization_caduceus.py:10-135` (CaduceusTokenizer)
- `src/dataloaders/datasets/hg38_char_tokenizer.py` (CharacterTokenizer,
  same vocab layout, used for downstream tasks)

Vocabulary layout (shared by both reference tokenizers):
    [CLS]=0 [SEP]=1 [BOS]=2 [MASK]=3 [PAD]=4 [RESERVED]=5 [UNK]=6
    then one id per character starting at 7 (A=7, C=8, G=9, T=10, N=11).

Design notes (TPU-first): tokenization is a byte-level numpy table lookup
(O(1) per char, vectorized over whole sequences); no Python per-char loops,
no HF dependency. The complement map is exposed both as a dict (for config
plumbing parity) and as an int32 numpy array (for jittable gather).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# Special token ids — fixed layout, `caduceus/tokenization_caduceus.py:49-58`.
CLS_ID = 0
SEP_ID = 1
BOS_ID = 2
MASK_ID = 3
PAD_ID = 4
RESERVED_ID = 5
UNK_ID = 6

_SPECIALS = ("[CLS]", "[SEP]", "[BOS]", "[MASK]", "[PAD]", "[RESERVED]", "[UNK]")

DEFAULT_CHARACTERS = ("A", "C", "G", "T", "N")
# String-level complements, `caduceus/tokenization_caduceus.py:45`.
DEFAULT_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


class CaduceusTokenizer:
    """Vectorized character tokenizer with reverse-complement support."""

    def __init__(
        self,
        model_max_length: int = 2**20,
        characters: Sequence[str] = DEFAULT_CHARACTERS,
        complement_map: Optional[Dict[str, str]] = None,
    ):
        if complement_map is None:
            complement_map = dict(DEFAULT_COMPLEMENT)
        self.model_max_length = model_max_length
        self.characters = tuple(characters)

        self._vocab_str_to_int: Dict[str, int] = {
            s: i for i, s in enumerate(_SPECIALS)
        }
        for i, ch in enumerate(self.characters):
            self._vocab_str_to_int[ch] = i + 7
        self._vocab_int_to_str = {v: k for k, v in self._vocab_str_to_int.items()}

        # id -> complement id; specials map to themselves
        # (`caduceus/tokenization_caduceus.py:63-66`).
        self._complement_map: Dict[int, int] = {}
        for tok, tid in self._vocab_str_to_int.items():
            comp = complement_map.get(tok)
            self._complement_map[tid] = (
                self._vocab_str_to_int[comp] if comp is not None else tid
            )

        # byte -> id lookup table; unknown bytes -> UNK; lowercase folded to
        # uppercase (`caduceus/tokenization_caduceus.py:91`).
        table = np.full(256, UNK_ID, dtype=np.int32)
        for ch, tid in self._vocab_str_to_int.items():
            if len(ch) == 1:
                table[ord(ch)] = tid
                table[ord(ch.lower())] = tid
        self._byte_table = table

    # -- vocab -------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._vocab_str_to_int)

    @property
    def pad_token_id(self) -> int:
        return PAD_ID

    @property
    def mask_token_id(self) -> int:
        return MASK_ID

    @property
    def sep_token_id(self) -> int:
        return SEP_ID

    @property
    def complement_map(self) -> Dict[int, int]:
        """id -> complement id, ordered by id (parity with reference)."""
        return dict(sorted(self._complement_map.items()))

    def complement_array(self, vocab_size: Optional[int] = None) -> np.ndarray:
        """Complement map as an int32 array for jittable gathers.

        `vocab_size` > len(map) extends with identity (vocab padding,
        `caduceus/modeling_caduceus.py:355-357`).
        """
        n = vocab_size or self.vocab_size
        arr = np.arange(n, dtype=np.int32)
        for k, v in self._complement_map.items():
            if k < n:
                arr[k] = v
        return arr

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab_str_to_int)

    # -- encode / decode ---------------------------------------------------
    def encode(self, text: str, add_sep: bool = False) -> np.ndarray:
        """Encode a DNA string to int32 ids (vectorized byte lookup)."""
        ids = self._byte_table[np.frombuffer(text.encode("ascii"), dtype=np.uint8)]
        if add_sep:
            ids = np.concatenate([ids, np.array([SEP_ID], dtype=np.int32)])
        return ids

    def encode_bytes(self, buf: bytes) -> np.ndarray:
        return self._byte_table[np.frombuffer(buf, dtype=np.uint8)].astype(np.int32)

    def decode(self, ids) -> str:
        return "".join(self._vocab_int_to_str.get(int(i), "[UNK]") for i in np.asarray(ids).ravel())

    def __call__(self, text: str, add_special_tokens: bool = False):
        ids = self.encode(text, add_sep=add_special_tokens)
        return {"input_ids": ids}

    def __len__(self) -> int:
        return self.vocab_size

    # -- reverse complement ------------------------------------------------
    def reverse_complement_ids(self, ids: np.ndarray) -> np.ndarray:
        """rc on token ids: flip length then complement each id.

        Matches `RCPSEmbedding.rc` (`caduceus/modeling_rcps.py:46-52`).
        """
        comp = self.complement_array(int(np.max(ids)) + 1 if ids.size else self.vocab_size)
        return comp[np.flip(ids, axis=-1)]


# String-level reverse complement incl. lowercase + N
# (parity with `src/dataloaders/utils/rc.py:7-18`).
_STRING_COMP = {
    "A": "T", "C": "G", "G": "C", "T": "A", "a": "t", "c": "g", "g": "c",
    "t": "a", "N": "N", "n": "n",
}
_RC_BYTE_TABLE = np.arange(256, dtype=np.uint8)
for _k, _v in _STRING_COMP.items():
    _RC_BYTE_TABLE[ord(_k)] = ord(_v)


def string_reverse_complement(seq: str) -> str:
    """Reverse-complement a DNA string (vectorized)."""
    b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _RC_BYTE_TABLE[b[::-1]].tobytes().decode("ascii")


class CharacterTokenizer(CaduceusTokenizer):
    """Downstream-task tokenizer; same vocab layout as CaduceusTokenizer.

    The reference keeps a second, HyenaDNA-era implementation
    (`src/dataloaders/datasets/hg38_char_tokenizer.py`) with an identical
    vocab layout; here it is the same class with padding-side support for
    classification batching.
    """

    def __init__(self, characters: Sequence[str] = DEFAULT_CHARACTERS,
                 model_max_length: int = 2**20, padding_side: str = "left", **kw):
        super().__init__(model_max_length=model_max_length, characters=characters, **kw)
        assert padding_side in ("left", "right")
        self.padding_side = padding_side

    def encode_padded(self, text: str, length: int, add_sep: bool = True) -> np.ndarray:
        """Encode and pad/truncate to `length` on the configured side."""
        ids = self.encode(text, add_sep=add_sep)
        if len(ids) > length:
            return ids[-length:] if self.padding_side == "left" else ids[:length]
        pad = np.full(length - len(ids), PAD_ID, dtype=np.int32)
        if self.padding_side == "left":
            return np.concatenate([pad, ids])
        return np.concatenate([ids, pad])



def make_mlm_eligible_replacements(tokenizer: CaduceusTokenizer) -> np.ndarray:
    """Token ids eligible as random replacements during MLM (ACGT only;
    `caduceus_tpu/tokenization.py:191-194`)."""
    v = tokenizer.get_vocab()
    return np.array([v[c] for c in "ACGT"], dtype=np.int32)
