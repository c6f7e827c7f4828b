"""repro_torch's bitmap data pipeline vs the reference package.

The same synthetic corpus (NumPy, from a seed) feeds both pipelines.  The
selection is a planned bitmap query and batches are integer token arrays,
so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as r_pipe
from repro_torch.data import pipeline as t_pipe


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return r_pipe.Corpus.synthetic(n_docs=512, doc_len=48, vocab=1000,
                                   seed=3)


def _pair(corpus, **kw):
    t_corpus = t_pipe.Corpus(tokens=corpus.tokens,
                             fact_table=corpus.fact_table, cards=corpus.cards)
    return (r_pipe.BitmapDataPipeline(corpus, **kw),
            t_pipe.BitmapDataPipeline(t_corpus, device="cpu", **kw))


def test_synthetic_corpus_matches_reference():
    r = r_pipe.Corpus.synthetic(n_docs=100, doc_len=16, vocab=77, seed=9)
    t = t_pipe.Corpus.synthetic(n_docs=100, doc_len=16, vocab=77, seed=9)
    np.testing.assert_array_equal(t.tokens, r.tokens)
    np.testing.assert_array_equal(t.fact_table, r.fact_table)
    assert t.cards == r.cards


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("sel", [
    {},
    {"conj": {"lang": 3, "quality": 2}},
    {"disj": {"lang": 1, "source": 4}},
    {"conj": {"quality": 1}, "exclude": {"lang": 2, "source": 0}},
])
def test_selection_composition_and_batches_match_reference(corpus, sort,
                                                           sel):
    r, t = _pair(corpus, sort=sort, seed=5)
    np.testing.assert_array_equal(t.row_perm, r.row_perm)
    np.testing.assert_array_equal(t.table, r.table)
    assert t.select(**sel) == r.select(**sel)
    np.testing.assert_array_equal(t.selected, r.selected)
    assert t.selected_count() == r.selected_count()
    for column in ("lang", "quality", "source"):
        np.testing.assert_array_equal(t.composition(column),
                                      r.composition(column))
    for step in (0, 1, 7, 40):
        np.testing.assert_array_equal(t.batch(step, 4, 32)["tokens"],
                                      r.batch(step, 4, 32)["tokens"])


def test_index_stats_match_reference(corpus):
    r, t = _pair(corpus)
    assert t.index_stats() == r.index_stats()


def test_pipeline_selection_matches_naive():
    corpus = t_pipe.Corpus.synthetic(n_docs=512, doc_len=32)
    pipe = t_pipe.BitmapDataPipeline(corpus, device="cpu")
    n = pipe.select(conj={"lang": 3, "quality": 2})
    want = np.flatnonzero((pipe.table[:, 1] == 3) & (pipe.table[:, 3] == 2))
    assert n == len(want)
    assert np.array_equal(pipe.selected, want)


def test_pipeline_batches_are_seekable():
    corpus = t_pipe.Corpus.synthetic(n_docs=128, doc_len=64)
    pipe = t_pipe.BitmapDataPipeline(corpus, device="cpu")
    pipe.select(conj={"quality": 1})
    b1 = pipe.batch(11, 4, 32)
    b2 = pipe.batch(11, 4, 32)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_empty_selection_raises_on_batch(corpus):
    _, t = _pair(corpus)
    t.selected = np.zeros(0, dtype=np.int64)
    with pytest.raises(ValueError, match="empty selection"):
        t.batch(0, 2, 8)


def test_pipeline_default_device_is_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_pipe.BitmapDataPipeline(corpus)
