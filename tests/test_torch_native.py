"""pipe_tpu_torch's native corpus processor and batch prefetcher
(``data/native.py`` over ``pipe_tpu_torch/csrc/pipetpu_{io,prefetch}.cpp``)
against pipe_tpu's and against ``lm_text``: the same ids and vocabulary, the
same batches as ``get_batch`` and as pipe_tpu's prefetcher, a build under
``build/native/`` (never beside the sources, nor in the root ``csrc/``), the
pure-Python fallback without a toolchain, and a ``Trainer`` with
``prefetch_depth`` whose losses are bitwise those of the inline walk.
"""

import dataclasses
import os

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.data import lm_text as jtext
from pipe_tpu.data import native as jnative
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.data import native
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.train import loop as tloop

SAMPLE = """The quick brown Fox jumps over the lazy dog.
Pack my box with five dozen liquor jugs!
(Hello, world); "quotes" and it's colons: done?

Repeated words repeated WORDS repeated.
"""


def python_reference(text):
    lines = text.splitlines()
    vocab = lm_text.Vocab(map(lm_text.basic_english_tokenize, lines))
    return (lm_text.data_process(lines, vocab),
            [vocab.lookup_token(i) for i in range(len(vocab))])


@pytest.mark.parametrize("which", ["sample", "synthetic", "blank"])
def test_ids_and_vocab_equal_lm_text_and_pipe_tpu(which):
    text = {"sample": SAMPLE,
            "synthetic": "\n".join(lm_text.synthetic_corpus(5_000, 300,
                                                            seed=9)),
            "blank": "\n   \n\t\n"}[which]
    c = native.NativeCorpus.from_text(text)
    j = jnative.NativeCorpus.from_text(text)
    want_ids, want_vocab = python_reference(text)
    np.testing.assert_array_equal(c.ids(), want_ids)
    np.testing.assert_array_equal(c.ids(), j.ids())
    assert c.vocab_list() == want_vocab == j.vocab_list()
    lines = text.splitlines()
    jvocab = jtext.Vocab(map(jtext.basic_english_tokenize, lines))
    np.testing.assert_array_equal(c.ids(), jtext.data_process(lines, jvocab))


def test_file_roundtrip_lookup_and_unk(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text(SAMPLE)
    ids, vocab = native.process_corpus(path=str(p))
    jids, jvocab = jnative.process_corpus(path=str(p))
    np.testing.assert_array_equal(ids, jids)
    assert vocab == jvocab
    c = native.NativeCorpus.from_text("alpha beta gamma alpha")
    assert (c.lookup("alpha"), c.lookup("never-seen")) == (1, 0)
    assert c.token(0) == "<unk>" and c.vocab_size == 4
    with pytest.raises(FileNotFoundError):
        native.NativeCorpus.from_file(str(tmp_path / "none.txt"))
    with pytest.raises(ValueError, match="exactly one"):
        native.process_corpus()


def test_non_ascii_text_takes_the_python_path():
    text = "Café au lait\nnaïve Straße"
    ids, vocab = native.process_corpus(text=text)
    want_ids, want_vocab = python_reference(text)
    np.testing.assert_array_equal(ids, want_ids)
    assert vocab == want_vocab


def test_libraries_build_under_build_native(tmp_path, monkeypatch):
    """The libraries live in build/native/, named by their source; a fresh
    build directory is filled by one g++ run each, and without g++ the
    loaders report no library (the Python fallback) instead of raising."""
    assert native.native_available() and native.prefetch_available()
    for lib in native._libs.values():
        path = lib._name
        assert os.path.dirname(path) == str(native.BUILD_DIR)
        assert os.path.basename(path).startswith("libpipetpu_")
    csrc = native._CSRC
    assert not list(csrc.glob("*.so"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    built = native._build_lib("pipetpu_io.cpp")
    assert built.parent == tmp_path / "b" and built.exists()
    assert native._build_lib("pipetpu_io.cpp") == built     # reused
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "c")
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    assert native._build_lib("pipetpu_prefetch.cpp", "-pthread") is None
    monkeypatch.setattr(native, "_libs", {})
    assert not native.prefetch_available()
    ids, vocab = native.process_corpus(text=SAMPLE)
    np.testing.assert_array_equal(ids, python_reference(SAMPLE)[0])


def _expected(src, bptt):
    out = []
    for b in range(lm_text.num_batches(src, bptt)):
        d, t = lm_text.get_batch(src, b * bptt, bptt)
        if d.shape[1] < bptt:
            break
        out.append((d, t))
    return out


@pytest.mark.parametrize("depth", [1, 2, 8])
@pytest.mark.parametrize("nrows,bsz,bptt", [(41, 4, 5), (33, 8, 4),
                                            (5, 2, 5), (200, 3, 7)])
def test_prefetcher_yields_get_batchs_and_pipe_tpus_batches(depth, nrows,
                                                            bsz, bptt):
    src = np.random.default_rng(nrows + bsz).integers(
        0, 1000, size=(nrows, bsz)).astype(np.int32)
    want = _expected(src, bptt)
    with native.BatchPrefetcher(src, bptt, depth=depth) as pf:
        assert pf.num_batches == len(want)
        got = [(d.copy(), t.copy()) for d, t in pf]
    with jnative.BatchPrefetcher(src, bptt, depth=depth) as jpf:
        jgot = [(d.copy(), t.copy()) for d, t in jpf]
    assert len(got) == len(want) == len(jgot)
    for (d, t), (ed, et), (jd, jt) in zip(got, want, jgot):
        np.testing.assert_array_equal(d, ed)
        np.testing.assert_array_equal(t, et)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(t, jt)


def test_prefetcher_ring_views_close_and_arguments():
    src = np.arange(31 * 4, dtype=np.int32).reshape(31, 4)
    with native.BatchPrefetcher(src, 5, depth=2) as pf:
        addrs = [d.__array_interface__["data"][0] for d, _ in pf]
    assert len(addrs) == 6 and addrs[0] == addrs[2] == addrs[4] \
        and addrs[1] == addrs[3] == addrs[5] and addrs[0] != addrs[1]
    big = np.random.default_rng(0).integers(
        0, 100, size=(10_001, 16)).astype(np.int32)
    pf = native.BatchPrefetcher(big, 10, depth=2)
    it = iter(pf)
    next(it)
    pf.close()          # joins the producer thread without deadlock
    with pytest.raises(StopIteration):
        next(it)
    for bad in ((src[0], 5, 2), (src, 0, 2), (src, 5, 0)):
        with pytest.raises(ValueError):
            native.BatchPrefetcher(*bad)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_trainer_losses_identical_with_prefetch(schedule):
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2)
    cfg = tloop.TrainerConfig(batch_size=8, bptt=model.seq_len, chunks=2,
                              n_stages=2, lr=0.05, schedule=schedule,
                              checkpoint="never")
    ids = np.random.default_rng(9).integers(0, model.vocab, size=2048)
    src = lm_text.batchify(ids, cfg.batch_size)

    def run(c):
        tr = tloop.Trainer(model, c, device="cpu")
        got = []
        step = tr._step
        tr._step = lambda *a: (got.append(step(*a)), got[-1])[1]
        _, info = tr.train_epoch(src, max_steps=4, log_every=0, start_step=1)
        return [float(x) for x in got], info

    opened = native.BatchPrefetcher.opened
    base, info = run(cfg)
    pf, pinfo = run(dataclasses.replace(cfg, prefetch_depth=2))
    assert native.BatchPrefetcher.opened == opened + 1
    assert info["steps"] == pinfo["steps"] == 3
    assert pf == base
