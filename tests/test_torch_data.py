"""The port's data pipeline (``flashattention_tpu_torch/data.py``) against
the JAX package's, on the CPU: the JAX package's six cases, the same
batches and packed rows for the same seed (exactly), and the port's
``train`` on packed rows against the JAX ``train`` on the same batches in
float32 at dropout 0 (1e-4, the JAX ladder).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from flashattention_tpu import data as jdata
from flashattention_tpu.models import train as jtrain
from flashattention_tpu.models.transformer import init_transformer
from flashattention_tpu_torch.data import (
    TokenStreamDataset,
    load_token_stream,
    pack_documents,
    prefetch,
    tokenize_bytes,
)
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    params_from_jax,
)

TOL = 1e-4
DOCS_TEXT = [p.read_text(encoding="utf-8")
             for p in sorted(Path(__file__).resolve().parents[1].glob("*.md"))]


def test_tokenize_bytes_roundtrip():
    t = tokenize_bytes("hello")
    assert t.dtype == np.int64 and t.tolist() == [104, 101, 108, 108, 111]


def test_stream_slicing_and_batches(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("abcdefghij" * 50)  # 500 bytes
    stream = load_token_stream(p)
    ds = TokenStreamDataset(stream, seq_len=16)
    assert len(ds) == (500 - 17) // 16 + 1
    assert ds[0].shape == (17,)
    batches = list(ds.batches(4, epochs=1, seed=1))
    assert all(b["tokens"].shape == (4, 17) for b in batches)
    assert all(b["tokens"].dtype == torch.int64 for b in batches)
    b1 = list(ds.batches(4, epochs=1, seed=1))
    torch.testing.assert_close(batches[0]["tokens"], b1[0]["tokens"])


def test_prefetch_preserves_order():
    items = [{"tokens": torch.full((1, 3), i)} for i in range(10)]
    out = list(prefetch(iter(items), depth=3))
    assert [int(o["tokens"][0, 0]) for o in out] == list(range(10))


def test_train_on_real_stream(tmp_path):
    """File -> stream -> batches -> the port's train reduces the loss."""
    p = tmp_path / "corpus.txt"
    p.write_text("the quick brown fox jumps over the lazy dog. " * 200)
    ds = TokenStreamDataset(load_token_stream(p), seq_len=32)
    cfg = TransformerConfig(
        vocab_size=256, d_model=64, n_layers=1, n_heads=4, d_ff=128,
        max_seq_len=64, block_size=32, dropout_rate=0.0,
        dtype=torch.float32, param_dtype=torch.float32,
    )
    tc = ttrain.TrainConfig(batch_size=4, seq_len=32, total_steps=20,
                            grad_accum=1, warmup_steps=2, log_every=5)
    _, _, losses = ttrain.train(cfg, tc, prefetch(ds.batches(4, seed=0)),
                                device="cpu", verbose=False)
    assert losses[-1] < losses[0]


def test_batches_raises_when_dataset_smaller_than_batch():
    ds = TokenStreamDataset(np.arange(200), seq_len=16)
    with pytest.raises(ValueError, match="drop_last"):
        next(ds.batches(batch_size=10 ** 6))
    assert next(ds.batches(batch_size=4))["tokens"].shape == (4, 17)


def test_prefetch_tuple_batches_and_error_forwarding():
    pairs = [(np.zeros(3), np.ones(3)) for _ in range(4)]
    out = list(prefetch(iter(pairs)))
    assert len(out) == 4 and all(isinstance(t, tuple) for t in out)

    def failing():
        yield (np.zeros(2), np.zeros(2))
        raise RuntimeError("loader died")

    with pytest.raises(RuntimeError, match="loader died"):
        list(prefetch(failing()))


@pytest.mark.parametrize("kw", [dict(), dict(stride=7), dict(shuffle=False),
                                dict(drop_last=False, epochs=2)])
def test_batches_equal_jax(kw):
    """Same stream, same seed: the same rows in the same order."""
    stream = tokenize_bytes("".join(DOCS_TEXT)[:6000])
    stride = kw.pop("stride", None)
    epochs = kw.pop("epochs", 1)
    ours = TokenStreamDataset(stream, 32, stride).batches(
        5, seed=3, epochs=epochs, **kw)
    theirs = jdata.TokenStreamDataset(stream.astype(np.int32), 32,
                                      stride).batches(5, seed=3, epochs=epochs,
                                                      **kw)
    n = 0
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])
        n += 1
    assert n > 1


@pytest.mark.parametrize("seq_len,min_tokens", [(64, 2), (200, 8), (31, 1)])
def test_pack_documents_equal_jax(seq_len, min_tokens):
    docs = [tokenize_bytes(t[:700]) for t in DOCS_TEXT] + [np.zeros(0)]
    t, s = pack_documents(docs, seq_len, min_tokens=min_tokens)
    jt, js = jdata.pack_documents(docs, seq_len, min_tokens=min_tokens)
    assert (t.dtype, s.dtype) == (torch.int64, torch.int32)
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_array_equal(s.numpy(), js)
    with pytest.raises(ValueError, match="no documents"):
        pack_documents([np.zeros(0)], seq_len)


def _packed_batches(b, seq_len, n_batches, int32=False):
    docs = [tokenize_bytes(t[:37 * (i + 1)]) for i, t in enumerate(DOCS_TEXT)]
    t, s = pack_documents(docs, seq_len, min_tokens=16)
    if int32:
        t = t.int()
    return [{"tokens": t[i * b:(i + 1) * b], "segment_ids": s[i * b:(i + 1) * b]}
            for i in range(n_batches)]


def test_int32_packed_rows_through_loss_fn():
    """int32 token rows (the JAX package's dtype) go through the port's
    loss_fn and give the int64 rows' loss."""
    cfg = TransformerConfig(vocab_size=256, d_model=32, n_layers=1, n_heads=4,
                            d_ff=64, max_seq_len=64, dropout_rate=0.0,
                            dtype=torch.float32, param_dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    b64 = _packed_batches(2, 48, 1)[0]
    b32 = _packed_batches(2, 48, 1, int32=True)[0]
    assert b32["tokens"].dtype == torch.int32
    for chunk in (None, 16):
        c = dataclasses.replace(cfg, loss_chunk=chunk)
        l32 = ttrain.loss_fn(params, b32, c, None)
        l64 = ttrain.loss_fn(params, b64, c, None)
        assert torch.isfinite(l32)
        torch.testing.assert_close(l32, l64, rtol=0, atol=0)


def test_train_on_packed_rows_matches_jax():
    """Four updates of the port's train on packed rows (through prefetch)
    against the JAX train on the same rows, same initial parameters."""
    from flashattention_tpu.models.transformer import TransformerConfig as JCfg
    import jax.numpy as jnp

    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq_len=64, block_size=32, dropout_rate=0.0)
    jcfg = JCfg(**base, dtype=jnp.float32)
    pcfg = TransformerConfig(**base, dtype=torch.float32,
                             param_dtype=torch.float32)
    tc = jtrain.TrainConfig(batch_size=2, seq_len=48, total_steps=8,
                            grad_accum=2, warmup_steps=2, log_every=1,
                            learning_rate=1e-3)
    batches = _packed_batches(2, 48, 8)
    assert any((b["segment_ids"] < 0).any() for b in batches)  # padding
    _, _, jlosses = jtrain.train(
        jcfg, tc, [{k: v.numpy().astype(np.int32) for k, v in b.items()}
                   for b in batches], verbose=False)
    pkey, _ = jax.random.split(jax.random.key(tc.seed))
    jp0 = jax.tree.map(np.asarray, init_transformer(pkey, jcfg))
    _, opt, losses = ttrain.train(
        pcfg, ttrain.TrainConfig(**dataclasses.asdict(tc)),
        prefetch(iter(batches)), params=params_from_jax(jp0, pcfg, "cpu"),
        device="cpu", verbose=False)
    assert opt.updates == 4
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
