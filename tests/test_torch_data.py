"""The port's copies of the numpy-only data modules against the JAX
package's: the synthetic corpus, its held-out split and per-language eval
sets, the language restriction set, the sharded pipeline's batches (pure
and through the prefetch thread) and the byte tokenizer. Equal bytes, not
tolerances: both run the same numpy code."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro_torch.data import pipeline, synthetic
from repro_torch.data.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_corpus_splits_and_eval_sets_equal_jax(seed):
    got, meta = synthetic.make_corpus(256, 50_000, seed=seed)
    want, jmeta = jsynthetic.make_corpus(256, 50_000, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert meta.lang_ranges == jmeta.lang_ranges
    np.testing.assert_array_equal(meta.mixture, jmeta.mixture)
    for a, b in zip(meta.transitions, jmeta.transitions):
        np.testing.assert_array_equal(a, b)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(meta.top_language_tokens(k),
                                      jmeta.top_language_tokens(k))
    for a, b in zip(synthetic.heldout_split(got),
                    jsynthetic.heldout_split(want)):
        np.testing.assert_array_equal(a, b)
    sets = synthetic.make_eval_sets(meta, n_tokens=3000, seed=seed + 1)
    jsets = jsynthetic.make_eval_sets(jmeta, n_tokens=3000, seed=seed + 1)
    assert sets.keys() == jsets.keys()
    for k in sets:
        np.testing.assert_array_equal(sets[k], jsets[k])


def test_full_corpus_equals_jax():
    """The corpus every quality path trains on: 200,000 tokens at seed 0."""
    got, _ = synthetic.make_corpus(256, 200_000, seed=0)
    want, _ = jsynthetic.make_corpus(256, 200_000, seed=0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pipeline_batches_equal_jax(n_shards):
    toks, _ = synthetic.make_corpus(256, 20_000, seed=0)
    for shard in range(n_shards):
        kw = dict(batch_size=8, seq_len=32, shard_id=shard,
                  n_shards=n_shards, seed=3)
        got = pipeline.DataPipeline(toks, **kw)
        want = jpipeline.DataPipeline(toks, **kw)
        for step in (0, 1, 7, 123):
            a, b = got.batch_at(step), want.batch_at(step)
            assert a.keys() == b.keys() == {"tokens", "labels"}
            for k in a:
                assert a[k].shape == (8 // n_shards, 32)
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_thread_yields_batch_at():
    toks, _ = synthetic.make_corpus(256, 20_000, seed=0)
    pipe = pipeline.DataPipeline(toks, batch_size=4, seq_len=16, seed=1)
    jpipe = jpipeline.DataPipeline(toks, batch_size=4, seq_len=16, seed=1)
    pipe.start(5)
    try:
        for want_step in range(5, 12):
            step, batch = pipe.next()
            assert step == want_step
            for k, v in jpipe.batch_at(step).items():
                np.testing.assert_array_equal(batch[k], v)
    finally:
        pipe.stop()
    assert not pipe._thread.is_alive()


@pytest.mark.parametrize("text,bos,eos", [
    ("hello world", False, False), ("norm tweaking é中", True, True),
    ("", True, False)])
def test_byte_tokenizer_equals_jax(text, bos, eos):
    ids = ByteTokenizer().encode(text, bos=bos, eos=eos)
    want = JaxByteTokenizer().encode(text, bos=bos, eos=eos)
    assert ids.dtype == want.dtype
    np.testing.assert_array_equal(ids, want)
    assert ByteTokenizer().decode(ids) == JaxByteTokenizer().decode(want) \
        == text
    assert ByteTokenizer.vocab_size == JaxByteTokenizer.vocab_size
