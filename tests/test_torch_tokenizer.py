"""The port's byte-level BPE tokenizer (``workloads/tokenizer.py``, a
copy of the JAX package's) against the JAX one, on the CPU: the shard
``build_shard`` and the CLI write from ``data/corpus.txt`` with a copy of
``data/tokenizer.json`` is ``data/corpus.bin`` byte for byte and the
JAX ``build_shard``'s; training gives the same merges; encode and decode
of unseen text, and the tokenizer-reuse rule, are the JAX package's.
Exact equality throughout (integer arithmetic).  Every path written is
temporary: nothing here writes into ``data/``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tpu_autoscaler.workloads import tokenizer as jax_tokenizer
from tpu_autoscaler_torch.workloads import tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
CORPUS = os.path.join(DATA, "corpus.txt")
UNSEEN = ("Unseen text: the autoscaler drained a v5e-64 slice at 03:14, "
          "résumé ✓ — then def f(x): return x ** 2\n\tand \x00\xff bytes.")


def _tokenizer_copy(tmp_path, name="tokenizer.json"):
    path = tmp_path / name
    shutil.copy(os.path.join(DATA, "tokenizer.json"), path)
    return str(path)


def test_cli_rebuilds_corpus_bin_byte_for_byte_as_jax_does(tmp_path):
    """The port's CLI and the JAX ``build_shard``, each with its own copy
    of data/tokenizer.json (reused: its requested vocab is 8192), write
    data/corpus.bin exactly; neither touches the tokenizer copy."""
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    tok = _tokenizer_copy(tmp_path)
    before = open(tok, "rb").read()
    res = subprocess.run(
        [sys.executable, "-m", "tpu_autoscaler_torch.workloads.tokenizer",
         "--corpus", CORPUS, "--vocab", "8192", "--tokenizer-out", tok,
         "--shard-out", str(ours)], capture_output=True, text=True,
        timeout=240, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert "tokenizer: vocab 8192" in res.stdout
    assert "shard: 199762 tokens" in res.stdout
    _, ids = jax_tokenizer.build_shard(
        CORPUS, _tokenizer_copy(tmp_path, "jax.json"), str(theirs), 8192)
    want = open(os.path.join(DATA, "corpus.bin"), "rb").read()
    assert ours.read_bytes() == want
    assert theirs.read_bytes() == want
    assert len(want) == 4 * len(ids) == 4 * 199_762
    assert open(tok, "rb").read() == before


def test_build_shard_returns_the_jax_tokenizer_and_ids(tmp_path):
    bpe, ids = tokenizer.build_shard(CORPUS, _tokenizer_copy(tmp_path),
                                     str(tmp_path / "port.bin"), 8192)
    want = jax_tokenizer.ByteBPE.load(os.path.join(DATA, "tokenizer.json"))
    assert bpe.merges == want.merges and bpe.vocab_size == 8192
    assert bpe.requested_vocab_size == want.requested_vocab_size
    np.testing.assert_array_equal(ids, np.fromfile(
        os.path.join(DATA, "corpus.bin"), dtype="<u4"))


@pytest.mark.parametrize("vocab,min_count", [(512, 2), (300, 2),
                                             (700, 40)],
                         ids=["v512", "v300", "v700-early-stop"])
def test_train_gives_the_jax_merges(vocab, min_count):
    """ByteBPE.train on the corpus's first 64 KB: the same merges list
    (v700 at min_count 40 stops early, short of the vocab asked for)."""
    data = open(CORPUS, "rb").read()[:65536]
    ours = tokenizer.ByteBPE.train(data, vocab, min_count)
    theirs = jax_tokenizer.ByteBPE.train(data, vocab, min_count)
    assert ours.merges == theirs.merges
    assert ours.vocab_size == theirs.vocab_size
    assert ours.requested_vocab_size == theirs.requested_vocab_size == vocab
    if min_count == 40:
        assert ours.vocab_size < vocab


def test_encode_and_decode_of_unseen_text_equal_jax():
    path = os.path.join(DATA, "tokenizer.json")
    ours, theirs = tokenizer.ByteBPE.load(path), \
        jax_tokenizer.ByteBPE.load(path)
    for text in (UNSEEN, UNSEEN.encode("utf-8"), "", "a", "aaaaaaa"):
        got, want = ours.encode(text), theirs.encode(text)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        raw = text.encode("utf-8") if isinstance(text, str) else text
        assert ours.decode(got) == theirs.decode(want) == raw
    ids = ours.encode(UNSEEN)
    assert ours.decode_str(ids) == theirs.decode_str(ids) == UNSEEN
    assert len(ids) < len(UNSEEN.encode("utf-8"))


def test_tokenizer_reuse_rule_matches_jax(tmp_path):
    """build_shard reuses a tokenizer.json whose requested vocab (or, in
    files without that field, actual vocab) matches and retrains one
    that does not, in both packages; the saved files are equal."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(open(CORPUS, "rb").read()[:20000])
    results = {}
    for name, mod in (("port", tokenizer), ("jax", jax_tokenizer)):
        tok = tmp_path / f"{name}.json"
        # An early-stopped tokenizer: requested 5000, far fewer merges.
        early = mod.ByteBPE.train(corpus.read_bytes(), 5000, min_count=50)
        early.save(str(tok))
        reused, _ = mod.build_shard(str(corpus), str(tok),
                                    str(tmp_path / f"{name}.bin"), 5000)
        retrained, ids = mod.build_shard(str(corpus), str(tok),
                                         str(tmp_path / f"{name}2.bin"), 300)
        results[name] = (reused.merges, retrained.merges, tok.read_text(),
                         ids)
    assert results["port"][0] == results["jax"][0]
    assert len(results["port"][0]) < 5000 - 256
    assert results["port"][1] == results["jax"][1]
    assert len(results["port"][1]) == 300 - 256
    assert results["port"][2] == results["jax"][2]
    np.testing.assert_array_equal(results["port"][3], results["jax"][3])


def test_load_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"format": "other", "merges": []}')
    for mod in (tokenizer, jax_tokenizer):
        with pytest.raises(ValueError, match="not a byte-bpe-v1"):
            mod.ByteBPE.load(str(bad))
        with pytest.raises(ValueError, match="vocab_size must be >= 256"):
            mod.ByteBPE.train(b"abc", 255)
