"""Byte-level BPE tokenizer with no downloads.

The counterpart of ``flashattention_tpu/tokenizer.py``, copied (that
package's ``__init__`` imports JAX):

- ``BPETokenizer.from_files`` loads the GPT-2 ``encoder.json`` +
  ``vocab.bpe`` pair where a local copy exists; ids then match tiktoken's
  ``gpt2`` encoding for text without special tokens (same byte table, merge
  list and split pattern).
- ``BPETokenizer.train`` learns a byte-level BPE from a string.
- ``save`` / ``from_files`` round-trip in the GPT-2 file format.

``encode`` runs the merge loop in the native engine (``csrc/bpe_encoder.cc``
at the repository root, built with g++ into ``_build/libfat_bpe.so`` at first
use by ``_build.build_bpe``); a missing g++ or a failed build raises. The
pure-Python merge loop is the plain version the engine is held against
(``encode_plain``), and the route for a vocab whose ids are not dense
``0..V-1``, which the engine cannot take. Token ids are int64.
"""

from __future__ import annotations

import ctypes
import json
import threading
from collections import Counter
from pathlib import Path

import numpy as np

from flashattention_tpu_torch import _build

try:  # GPT-2's exact split pattern needs unicode classes (\p{L}).
    import regex as _re

    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
    )
except ImportError:  # pragma: no cover - regex is installed with the port
    import re as _re

    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
    )


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table: the 188 printable
    latin-1 bytes map to themselves; the rest shift into U+0100.. so every
    token string is printable."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}
# latin-1 maps bytes 1:1 onto chars; one str.translate applies the table.
_BYTE_TRANS = str.maketrans({chr(b): c for b, c in _BYTE_ENC.items()})

_I32P = ctypes.POINTER(ctypes.c_int32)
_NATIVE_LIB: ctypes.CDLL | None = None
_NATIVE_LOCK = threading.Lock()


def _to_symbols(word: str) -> str:
    return word.encode("utf-8").decode("latin-1").translate(_BYTE_TRANS)


def _load_native_bpe() -> ctypes.CDLL:
    """The native merge engine, built at first use; raises where it cannot
    be built."""
    global _NATIVE_LIB
    with _NATIVE_LOCK:
        if _NATIVE_LIB is None:
            lib = ctypes.CDLL(str(_build.build_bpe()))
            lib.fat_bpe_create.restype = ctypes.c_void_p
            lib.fat_bpe_create.argtypes = [
                ctypes.c_char_p, _I32P, ctypes.c_int32,
                ctypes.c_char_p, _I32P, ctypes.c_int32,
            ]
            lib.fat_bpe_destroy.argtypes = [ctypes.c_void_p]
            lib.fat_bpe_cache_size.restype = ctypes.c_int64
            lib.fat_bpe_cache_size.argtypes = [ctypes.c_void_p]
            lib.fat_bpe_encode.restype = ctypes.c_int64
            lib.fat_bpe_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, _I32P, ctypes.c_int32,
                _I32P, ctypes.c_int64,
            ]
            _NATIVE_LIB = lib
        return _NATIVE_LIB


def _pack_strings(strings):
    """UTF-8 blob + (n+1,) int32 offsets for a list of symbol strings."""
    bs = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(bs) + 1, np.int32)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return b"".join(bs), offs


class BPETokenizer:
    """Byte-level BPE: greedy lowest-rank pair merging per regex-split word.

    The engine's memo cache is guarded by a mutex (ctypes releases the GIL
    during an encode, so threads sharing one tokenizer reach it at once)."""

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache: dict[str, list[str]] = {}
        ids = sorted(self.encoder.values())
        # the engine takes token i as id i: ids must be exactly 0..V-1
        self.dense_ids = ids == list(range(len(ids)))
        self._native = None  # (lib, handle) once created
        self._native_lock = threading.Lock()

    def __del__(self):  # pragma: no cover - interpreter-exit ordering
        try:
            if self._native is not None:
                lib, handle = self._native
                lib.fat_bpe_destroy(handle)
        except Exception:
            pass

    def _native_engine(self):
        """(lib, handle) of this tokenizer's engine, created at first use."""
        with self._native_lock:
            if self._native is None:
                lib = _load_native_bpe()
                by_id = sorted(self.encoder.items(), key=lambda kv: kv[1])
                vb, vo = _pack_strings([k for k, _ in by_id])
                pairs = sorted(self.ranks.items(), key=lambda kv: kv[1])
                mb, mo = _pack_strings([s for (a, b), _ in pairs
                                        for s in (a, b)])
                handle = lib.fat_bpe_create(
                    vb, vo.ctypes.data_as(_I32P), len(by_id),
                    mb, mo.ctypes.data_as(_I32P), len(pairs),
                )
                if not handle:
                    raise RuntimeError("fat_bpe_create failed")
                self._native = (lib, handle)
            return self._native

    # -- construction ------------------------------------------------------

    @classmethod
    def from_files(cls, encoder_json: str | Path, vocab_bpe: str | Path):
        """Load the GPT-2 artifact pair (``encoder.json`` + ``vocab.bpe``)."""
        encoder = json.loads(Path(encoder_json).read_text(encoding="utf-8"))
        lines = Path(vocab_bpe).read_text(encoding="utf-8").splitlines()
        if lines and lines[0].startswith("#"):  # "#version: 0.2" header
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]
        return cls(encoder, merges)

    @classmethod
    def train(cls, text: str, vocab_size: int) -> "BPETokenizer":
        """Learn merges from ``text`` until the vocab reaches ``vocab_size``
        (>= 256; byte tokens are always present)."""
        if vocab_size < 256:
            raise ValueError("vocab_size must be >= 256 (byte base vocab)")
        words = Counter()
        for w in _PAT.findall(text):
            words[tuple(_BYTE_ENC[b] for b in w.encode("utf-8"))] += 1
        encoder = {ch: i for i, ch in enumerate(_BYTE_ENC[b] for b in range(256))}
        merges: list[tuple[str, str]] = []
        while len(encoder) < vocab_size:
            pairs = Counter()
            for word, freq in words.items():
                for a, b in zip(word, word[1:]):
                    pairs[(a, b)] += freq
            if not pairs:
                break
            (a, b), freq = pairs.most_common(1)[0]
            if freq < 2:
                break  # nothing left worth merging
            merges.append((a, b))
            encoder[a + b] = len(encoder)
            merged = {}
            for word, f in words.items():
                out, i = [], 0
                while i < len(word):
                    if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                key = tuple(out)
                merged[key] = merged.get(key, 0) + f
            words = Counter(merged)
        return cls(encoder, merges)

    def save(self, directory: str | Path) -> None:
        """Write the GPT-2 artifact pair so ``from_files`` round-trips."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        (d / "encoder.json").write_text(
            json.dumps(self.encoder, ensure_ascii=False), encoding="utf-8"
        )
        inv = sorted(self.ranks, key=self.ranks.get)
        (d / "vocab.bpe").write_text(
            "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in inv) + "\n",
            encoding="utf-8",
        )

    # -- encode / decode ---------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> list[str]:
        """Merge the byte-unicode symbols of one pre-split word, lowest
        learned rank first (the BPE greedy order)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = set(zip(parts, parts[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            out, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._cache[token] = parts
        return parts

    def encode_plain(self, text: str) -> np.ndarray:
        """``encode`` through the pure-Python merge loop."""
        ids: list[int] = []
        for w in _PAT.findall(text):
            ids.extend(self.encoder[p] for p in self._bpe(_to_symbols(w)))
        return np.asarray(ids, dtype=np.int64)

    def encode(self, text: str) -> np.ndarray:
        """int64 token ids of ``text``: the native engine, or the Python
        loop for a vocab whose ids are not dense."""
        if not self.dense_ids:
            return self.encode_plain(text)
        lib, handle = self._native_engine()
        syms = [_to_symbols(w) for w in _PAT.findall(text)]
        if not syms:
            return np.zeros(0, np.int64)
        blob, offs = _pack_strings(syms)
        cap = max(256, len(blob))  # ids never exceed the symbol count
        out = np.empty(cap, np.int32)
        n = lib.fat_bpe_encode(handle, blob, offs.ctypes.data_as(_I32P),
                               len(syms), out.ctypes.data_as(_I32P), cap)
        if n == -1000000000:
            raise KeyError("symbol missing from vocab (native encode)")
        if n < 0:  # capacity miss (cannot happen with cap >= symbols)
            out = np.empty(-n, np.int32)
            n = lib.fat_bpe_encode(handle, blob, offs.ctypes.data_as(_I32P),
                                   len(syms), out.ctypes.data_as(_I32P), -n)
        return out[:n].astype(np.int64)

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in np.asarray(ids).ravel())
        return bytes(_BYTE_DEC[c] for c in text).decode("utf-8", errors="replace")
