"""Token-stream dataset for LM training.

The counterpart of ``flashattention_tpu/data.py``, copied (that package's
``__init__`` imports JAX): tokenize a text once into a flat stream, slice
``seq_len + 1`` windows, pack variable-length documents into fixed rows with
segment ids, and prefetch batches on a host thread while the card computes.

- ``tokenize_bytes`` (vocab 256) works on any text with no downloads;
  ``tokenizer.BPETokenizer`` gives subword streams
  (``load_token_stream(path, tokenizer=tok.encode)``).
- Streams are int64 numpy arrays; batches are dicts of CPU ``torch``
  tensors (``train`` moves every value to its device): tokens int64, the
  dtype index ops take, and segment ids int32.
- Shuffles draw from ``numpy.random.default_rng(seed)`` as the JAX package
  does, so both packages yield the same rows in the same order.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

VOCAB_BYTES = 256


def tokenize_bytes(text: str | bytes) -> np.ndarray:
    """Byte-level tokenization: every byte is a token id in [0, 256)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, dtype=np.uint8).astype(np.int64)


def load_token_stream(
    path: str | Path,
    tokenizer: Callable[[str], np.ndarray] | None = None,
) -> np.ndarray:
    """Tokenize a text file once into a flat int64 stream."""
    raw = Path(path).read_bytes()
    if tokenizer is None:
        return tokenize_bytes(raw)
    return np.asarray(tokenizer(raw.decode("utf-8")), dtype=np.int64)


class TokenStreamDataset:
    """Slices (seq_len + 1)-token windows out of a flat stream.

    ``stride`` defaults to seq_len (non-overlapping windows); smaller
    strides give overlapping windows."""

    def __init__(self, stream: np.ndarray, seq_len: int, stride: int | None = None):
        stream = np.asarray(stream)
        if stream.ndim != 1:
            raise ValueError(f"stream must be 1-D, got {stream.shape}")
        self.stream = stream.astype(np.int64)
        self.seq_len = seq_len
        self.stride = stride or seq_len
        n = (len(stream) - seq_len - 1) // self.stride + 1
        if n <= 0:
            raise ValueError(
                f"stream of {len(stream)} tokens too short for seq_len {seq_len}"
            )
        self.n_examples = n

    def __len__(self) -> int:
        return self.n_examples

    def __getitem__(self, i: int) -> np.ndarray:
        start = i * self.stride
        return self.stream[start: start + self.seq_len + 1]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: int | None = None,
        drop_last: bool = True,
    ) -> Iterator[dict]:
        """Yields {"tokens": (B, seq_len+1) int64 CPU tensor} batches."""
        rng = np.random.default_rng(seed)
        if drop_last and self.n_examples < batch_size:
            # no batch in any epoch: with epochs=None the loop below would
            # spin forever yielding nothing
            raise ValueError(
                f"n_examples={self.n_examples} < batch_size={batch_size} "
                "with drop_last=True yields no batches ever; shrink the "
                "batch or pass drop_last=False"
            )
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(self.n_examples)
            if shuffle:
                rng.shuffle(order)
            stop = (
                self.n_examples - batch_size + 1 if drop_last
                else self.n_examples
            )
            for i in range(0, max(stop, 0), batch_size):
                idx = order[i: i + batch_size]
                yield {"tokens": torch.from_numpy(
                    np.stack([self[j] for j in idx]))}
            epoch += 1


def pack_documents(
    docs: list[np.ndarray],
    seq_len: int,
    *,
    min_tokens: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy sequence packing: variable-length documents -> fixed
    (rows, seq_len + 1) token rows + matching segment-id rows.

    Each document is one contiguous segment and the flash kernels'
    segment-id compare keeps attention within it. Documents longer than a
    row are split across rows (each chunk its own segment). Row tails too
    short for ``min_tokens`` of a new document are padded with segment id
    -1, whose targets ``loss_fn`` drops.

    Returns (tokens int64, segment_ids int32), both (rows, seq_len + 1)
    CPU tensors. Feed as ``{"tokens": t[i:j], "segment_ids": s[i:j]}``
    batches.
    """
    width = seq_len + 1
    rows_t: list[np.ndarray] = []
    rows_s: list[np.ndarray] = []
    cur_t = np.zeros((width,), np.int64)
    cur_s = np.full((width,), -1, np.int32)
    fill = 0
    next_id = 0

    def flush():
        nonlocal fill, cur_t, cur_s
        if fill > 0:
            rows_t.append(cur_t)
            rows_s.append(cur_s)
            cur_t = np.zeros((width,), np.int64)
            cur_s = np.full((width,), -1, np.int32)
            fill = 0

    for doc in docs:
        doc = np.asarray(doc, np.int64).ravel()
        off = 0
        while off < len(doc):
            if width - fill < min_tokens:
                flush()
            take = min(len(doc) - off, width - fill)
            cur_t[fill: fill + take] = doc[off: off + take]
            cur_s[fill: fill + take] = next_id
            fill += take
            off += take
            next_id += 1  # each chunk is its own segment
            if fill == width:
                flush()
    flush()
    if not rows_t:
        raise ValueError("no documents with tokens to pack")
    return torch.from_numpy(np.stack(rows_t)), torch.from_numpy(np.stack(rows_s))


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Builds the next batches on a host thread while the card computes.
    An exception of the wrapped iterator re-raises in the consumer: a
    failed loader fails the job instead of ending the stream."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    # an identity sentinel: comparing a string with an array item would
    # broadcast to a bool array and make the check below raise
    _ERR = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - forwarded, not swallowed
            q.put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        yield item
