"""psg_tpu_torch's data layer against psg_tpu's on the CPU: the split, the
caption variants, and the training loader's batches, which must be
bit-equal over two epochs with augmentation on (the native engine and the
Python one), caption variants on, and the eval loader's wraparound padding.

Both packages read one sprite corpus made from a seed
(``psg_tpu_torch.data.synthetic``) with the committed vocabulary."""

from pathlib import Path

import numpy as np
import pytest
import torch

import psg_tpu.data.native as jax_native
from psg_tpu.data.caption_augment import caption_variants as jax_caption_variants
from psg_tpu.data.dataset import PokemonDataset as JaxDataset
from psg_tpu.data.dataset import dataset_statistics as jax_dataset_statistics
from psg_tpu.data.dataset import split_indices as jax_split_indices
from psg_tpu.data.loader import Loader as JaxLoader
from psg_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer

import psg_tpu_torch.data.native as native
from psg_tpu_torch.data.caption_augment import caption_variants
from psg_tpu_torch.data.dataset import PokemonDataset, dataset_statistics, split_indices
from psg_tpu_torch.data.loader import Loader
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

VOCAB = Path(__file__).resolve().parent.parent / "experiments/evidence_r5c_vae/vocab.txt"


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    csv, images = write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=30, seed=3,
                                      size=48)
    jds = JaxDataset(csv, images, image_size=48, tokenizer=JaxTokenizer.from_vocab_file(VOCAB),
                     text_len=32)
    pds = PokemonDataset(csv, images, image_size=48,
                         tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB), text_len=32)
    return jds, pds


@pytest.mark.parametrize("n,val,test,seed", [(898, 0.15, 0.05, 42), (30, 0.15, 0.05, 0),
                                             (7, 0.3, 0.0, 5)])
def test_split_indices_equal(n, val, test, seed):
    for got, ref in zip(split_indices(n, val, test, seed), jax_split_indices(n, val, test, seed)):
        np.testing.assert_array_equal(got, ref)


def test_caption_variants_equal():
    texts = ["Pokemon named Bulba. A green seed creature. It has a bulb on its back. "
             "The bulb grows in sunlight. It is calm and loyal.",
             "Pokemon named Mr. A psychic clown. It mimes walls.",
             "A creature with no name. One sentence only.",
             "Pokemon named Zed."]
    for k, seed, p in ((4, 0, 0.5), (6, 7, 0.0), (1, 3, 0.5)):
        assert caption_variants(texts, k, seed, p_name_drop=p) == jax_caption_variants(
            texts, k, seed, p_name_drop=p)


def test_dataset_and_statistics_equal(datasets):
    jds, pds = datasets
    np.testing.assert_array_equal(pds.images, jds.images)
    for name in ("text_ids", "text_mask", "desc_ids", "desc_mask"):
        np.testing.assert_array_equal(getattr(pds, name), getattr(jds, name))
    assert dataset_statistics(pds) == jax_dataset_statistics(jds)
    jds.set_caption_variants(3, 11, p_name_drop=0.5)
    pds.set_caption_variants(3, 11, p_name_drop=0.5)
    np.testing.assert_array_equal(pds.text_ids_aug, jds.text_ids_aug)
    np.testing.assert_array_equal(pds.text_mask_aug, jds.text_mask_aug)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("variants", [False, True])
def test_train_batches_bit_equal(datasets, monkeypatch, engine, workers, variants):
    """Two epochs of shuffled, augmented train batches (drop_last), with and
    without caption variants, on one engine in both packages."""
    jds, pds = datasets
    if engine == "python":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available() and jax_native.available()
    for ds in (jds, pds):
        ds.text_ids_aug = ds.text_mask_aug = None
        if variants:
            ds.set_caption_variants(3, 5)
    idx = split_indices(len(pds), 0.15, 0.05, seed=42)[0]
    kw = dict(train=True, seed=42, augment=True, num_workers=workers)
    jl, pl = JaxLoader(jds, idx, 4, **kw), Loader(pds, idx, 4, **kw)
    assert len(pl) == len(jl) == len(idx) // 4
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        _assert_batches_equal(list(pl), list(jl))


def test_eval_batches_pad_the_tail(datasets):
    jds, pds = datasets
    idx = split_indices(len(pds), 0.15, 0.05, seed=42)[1]       # 4 of 30
    for bs in (3, 4, 8):
        jl = JaxLoader(jds, idx, bs, train=False, num_workers=2)
        pl = Loader(pds, idx, bs, train=False, num_workers=2)
        got = list(pl)
        _assert_batches_equal(got, list(jl))
        assert sum(int(b["valid"]) for b in got) == len(idx)
        assert all(b["image"].shape[0] == bs for b in got)


def test_native_engine_first_use_from_threads(monkeypatch, tmp_path):
    """The loader's threads ask for the engine at once on an unbuilt
    checkout: every one of them gets the native engine, none the Python one
    while another builds it."""
    import shutil
    import sys
    import threading
    import time

    assert native.available()
    built = native.library_path()
    fresh = tmp_path / built.name

    def slow_build(path):
        time.sleep(0.3)
        shutil.copy(built, path)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: fresh)
    monkeypatch.setattr(native, "_build", slow_build)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        seen = []
        threads = [threading.Thread(target=lambda: seen.append(native.available()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 8


def test_native_engine_builds_outside_the_source_tree():
    """The port's library lands in the gitignored build directory, never
    beside native/augment.cc."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "psg_tpu_torch")
