"""The port's byte-level BPE tokenizer (``flashattention_tpu_torch/
tokenizer.py``) against the JAX package's, on the CPU: the JAX package's
seven cases, the same merges and ids from the same text, the native engine
against the Python merge loop, and a failed build that raises.

Ids are compared exactly.
"""

from pathlib import Path

import numpy as np
import pytest

from flashattention_tpu import tokenizer as jtok
from flashattention_tpu_torch import _build
from flashattention_tpu_torch import tokenizer as ttok
from flashattention_tpu_torch.data import TokenStreamDataset, load_token_stream
from flashattention_tpu_torch.tokenizer import BPETokenizer, bytes_to_unicode

REAL_TEXT = (Path(__file__).resolve().parents[1] / "README.md").read_text(
    encoding="utf-8"
)
ODD_TEXTS = (
    "naïve café — résumé 123!\n\ttabs",
    "",
    "ünïcode ∑∫ emoji 🙂 bytes\x00\x01",
    "a" * 500,  # one long word: deep merge chains
)


@pytest.fixture(scope="module")
def tok400():
    return BPETokenizer.train(REAL_TEXT, vocab_size=400)


def test_byte_table_is_a_bijection():
    table = bytes_to_unicode()
    assert len(table) == 256
    assert len(set(table.values())) == 256
    assert table == jtok.bytes_to_unicode()


def test_train_roundtrip_on_real_text():
    tok = BPETokenizer.train(REAL_TEXT, vocab_size=512)
    assert 256 < tok.vocab_size <= 512
    ids = tok.encode(REAL_TEXT)
    assert ids.dtype == np.int64
    assert tok.decode(ids) == REAL_TEXT
    assert len(ids) < len(REAL_TEXT.encode("utf-8"))


def test_handles_non_ascii_and_empty():
    tok = BPETokenizer.train("héllo wörld — ünïcode! " * 5, vocab_size=300)
    s = "héllo — ünïcode"
    assert tok.decode(tok.encode(s)) == s
    assert tok.encode("").size == 0


def test_save_load_gpt2_format(tmp_path):
    tok = BPETokenizer.train(REAL_TEXT[:4000], vocab_size=320)
    tok.save(tmp_path)
    assert (tmp_path / "encoder.json").exists()
    assert (tmp_path / "vocab.bpe").read_text(encoding="utf-8").startswith(
        "#version"
    )
    tok2 = BPETokenizer.from_files(
        tmp_path / "encoder.json", tmp_path / "vocab.bpe"
    )
    s = REAL_TEXT[:1000]
    np.testing.assert_array_equal(tok.encode(s), tok2.encode(s))
    assert tok2.vocab_size == tok.vocab_size
    # the JAX package reads the same files into the same tokenizer
    jt = jtok.BPETokenizer.from_files(
        tmp_path / "encoder.json", tmp_path / "vocab.bpe")
    np.testing.assert_array_equal(tok2.encode(s), jt.encode(s))


def test_feeds_data_pipeline(tmp_path, tok400):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(REAL_TEXT, encoding="utf-8")
    stream = load_token_stream(corpus, tokenizer=tok400.encode)
    assert stream.dtype == np.int64
    assert stream.max() < tok400.vocab_size
    window = TokenStreamDataset(stream, seq_len=32)[0]
    assert window.shape == (33,)
    assert tok400.decode(window) in REAL_TEXT


def test_native_bpe_engine_parity(tok400):
    """The C++ merge engine gives exactly the Python loop's ids, and fills
    its memo cache."""
    for text in (REAL_TEXT[:3000], *ODD_TEXTS):
        a, b = tok400.encode(text), tok400.encode_plain(text)
        np.testing.assert_array_equal(a, b)
        assert tok400.decode(a) == tok400.decode(b)
    lib, handle = tok400._native_engine()
    assert lib.fat_bpe_cache_size(handle) > 0


def test_native_engine_concurrent_encode(tok400):
    """ctypes releases the GIL during an encode: four threads share one
    engine and its memo cache."""
    import threading

    errs: list = []

    def run(seed):
        try:
            for i in range(30):
                s = REAL_TEXT[i * 37 % 2000: i * 37 % 2000 + 300 + seed]
                assert tok400.decode(tok400.encode(s)) == s
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs


def test_same_merges_and_ids_as_jax(tok400):
    """Trained on the same text, both packages learn the same merges and
    vocab and give the same ids (the port's engine vs the JAX encode)."""
    jt = jtok.BPETokenizer.train(REAL_TEXT, vocab_size=400)
    assert tok400.encoder == jt.encoder
    assert tok400.ranks == jt.ranks
    for text in (REAL_TEXT, *ODD_TEXTS):
        np.testing.assert_array_equal(tok400.encode(text), jt.encode(text))


def test_sparse_ids_take_the_python_loop(tok400):
    """A vocab whose ids are not 0..V-1 runs the Python loop (the engine
    takes token i as id i)."""
    shifted = {k: v + 7 for k, v in tok400.encoder.items()}
    merges = sorted(tok400.ranks, key=tok400.ranks.get)
    tok = BPETokenizer(shifted, merges)
    assert not tok.dense_ids
    s = REAL_TEXT[:2000]
    np.testing.assert_array_equal(tok.encode(s), tok400.encode(s) + 7)
    assert tok._native is None
    assert tok.decode(tok.encode(s)) == s


@pytest.mark.parametrize("compiler", [None, "/bin/false"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """No g++, or a compiler that fails: encode raises, no fall-back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: compiler)
    monkeypatch.setattr(ttok, "_NATIVE_LIB", None)
    tok = BPETokenizer.train("abc abd abe " * 4, vocab_size=260)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found|failed"):
        tok.encode("abc")
    assert not (tmp_path / "libfat_bpe.so").exists()
