"""psg_tpu_torch's CLIP and CLIP BPE tokenizer against psg_tpu's on the CPU.

The BPE runs on an in-test vocabulary and merges (the case of
tests/test_bpe.py: byte unigrams, their word-final forms and three merges),
under both pre-tokenizer branches (the ``regex`` package's Unicode classes
and the standard library's ``re``).  CLIP runs at ``ClipConfig.tiny_test``
with the JAX package's random parameters carried across by
``models/bridge.py``, fp32 throughout.  Bounds: ids equal; embeddings and
the loss within 1e-5 relative; the loss's gradient with respect to the
images within 1e-4 * max|g| + 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.models import clip as jclip
from psg_tpu.text.bpe import ClipBPETokenizer as JaxBPE
from psg_tpu.text.bpe import bytes_to_unicode as jax_bytes_to_unicode

from psg_tpu_torch.models import bridge
from psg_tpu_torch.models import clip
from psg_tpu_torch.text import bpe

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

CAPTIONS = ["Bulbasaur. A small green creature with a plant bulb on its back.",
            "  a RED fire lizard's   tail burns at 1200 degrees!! ",
            "it's 2 meters tall &amp; weighs 90.5 kg; don't touch (seriously)",
            "hello hi hillo -- lo/lo"]
VOCAB = 64


def _toy_vocab():
    """tests/test_bpe.py's toy vocabulary and merges."""
    byte_chars = list(bpe.bytes_to_unicode().values())
    assert byte_chars == list(jax_bytes_to_unicode().values())
    vocab = {}
    for ch in byte_chars:
        vocab[ch] = len(vocab)
    for ch in byte_chars:
        vocab[ch + "</w>"] = len(vocab)
    merges = [("h", "i</w>"), ("l", "o</w>"), ("l", "lo</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


@pytest.mark.parametrize("branch", ["regex", "re"])
def test_bpe_ids_match_jax(branch, monkeypatch):
    vocab, merges = _toy_vocab()
    ref = JaxBPE(vocab, merges)
    pattern = {"regex": bpe.PAT_REGEX, "re": bpe.PAT_RE}[branch]
    assert pattern is not None
    monkeypatch.setattr(bpe, "_PAT", pattern)
    tok = bpe.ClipBPETokenizer(vocab, merges)
    for text in CAPTIONS:
        assert tok.encode(text) == ref.encode(text), text
    for length in (77, 12):
        ids, mask = tok.encode_batch(CAPTIONS, length)
        rids, rmask = ref.encode_batch(CAPTIONS, length)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(mask, rmask)
    toks = {v: k for k, v in vocab.items()}
    assert [toks[i] for i in tok.encode("hello")] == ["h", "e", "llo</w>"]


def test_bpe_files_and_named_directory(tmp_path, monkeypatch):
    """from_files reads vocab.json and merges.txt (with a #version header)
    as the JAX package does; a directory $PSG_TPU_CLIP_BPE names must hold
    both files, while the default directory without them gives None."""
    import json

    vocab, merges = _toy_vocab()
    (tmp_path / "clip_vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    monkeypatch.setenv("PSG_TPU_CLIP_BPE", str(tmp_path))
    tok, ref = bpe.ClipBPETokenizer.find(), JaxBPE.find()
    assert tok.vocab_size == ref.vocab_size == len(vocab)
    np.testing.assert_array_equal(tok.encode_batch(CAPTIONS)[0], ref.encode_batch(CAPTIONS)[0])
    monkeypatch.setenv("PSG_TPU_CLIP_BPE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="PSG_TPU_CLIP_BPE"):
        bpe.ClipBPETokenizer.find()
    monkeypatch.delenv("PSG_TPU_CLIP_BPE")
    assert bpe.ClipBPETokenizer.find(tmp_path / "empty") is None


@pytest.fixture(scope="module")
def params():
    cfg = jclip.ClipConfig.tiny_test(VOCAB)
    jp = jclip.clip_init(jax.random.PRNGKey(4321), cfg)
    pcfg = clip.ClipConfig.tiny_test(VOCAB)
    assert tuple(pcfg) == tuple(cfg)
    template = clip.clip_init(torch.Generator().manual_seed(4321), pcfg)
    pp = bridge.fit(template, bridge.from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return cfg, jp, pcfg, pp


def _text(seed, b=3, s=32):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, VOCAB, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate((32, 7, 20)[:b]):   # one row past text_len 16
        mask[i, :n] = 1
    return ids * mask, mask


def _images(seed, size=64, b=3):
    return np.random.RandomState(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("size", [64, 48])
def test_clip_encode_image_matches(params, size):
    """At the tower's own 64 px and through the bilinear upsample from 48."""
    cfg, jp, pcfg, pp = params
    x = (_images(size, size) + 1.0) / 2.0
    ref = jclip.clip_encode_image(jp, jnp.asarray(x), cfg)
    got = clip.clip_encode_image(pp, torch.from_numpy(x), pcfg)
    assert got.shape == (3, 32)
    _close(got, ref)


def test_clip_encode_text_matches_with_truncation(params):
    """S 32 against text_len 16: both truncate before building the causal +
    padding bias; the first row pools position 15, the others their last
    valid token."""
    cfg, jp, pcfg, pp = params
    ids, mask = _text(0)
    ref = jclip.clip_encode_text(jp, jnp.asarray(ids), jnp.asarray(mask), cfg)
    got = clip.clip_encode_text(pp, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask).long(), pcfg)
    _close(got, ref)
    # tokens past the 16th change nothing
    ids2 = ids.copy()
    ids2[0, 16:] = 1
    again = clip.clip_encode_text(pp, torch.from_numpy(ids2).long(),
                                  torch.from_numpy(mask).long(), pcfg)
    assert torch.equal(again, got)


@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 1.0)])
def test_clip_alignment_loss_matches(params, weights):
    cfg, jp, pcfg, pp = params
    images, (ids, mask) = _images(1), _text(1)
    w = None if weights is None else np.asarray(weights, np.float32)
    ref = jclip.clip_alignment_loss(jp, jnp.asarray(images), jnp.asarray(ids),
                                    jnp.asarray(mask), cfg,
                                    sample_weights=None if w is None else jnp.asarray(w))
    got = clip.clip_alignment_loss(pp, torch.from_numpy(images), torch.from_numpy(ids).long(),
                                   torch.from_numpy(mask).long(), pcfg,
                                   sample_weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_clip_loss_image_gradient_matches(params):
    """The gradient the stage-3 decoder receives: d loss / d images."""
    cfg, jp, pcfg, pp = params
    images, (ids, mask) = _images(2), _text(2)
    w = np.asarray([1.0, 1.0, 0.0], np.float32)
    ref = jax.grad(lambda im: jclip.clip_alignment_loss(
        jp, im, jnp.asarray(ids), jnp.asarray(mask), cfg,
        sample_weights=jnp.asarray(w)))(jnp.asarray(images))
    x = torch.from_numpy(images).requires_grad_(True)
    clip.clip_alignment_loss(pp, x, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                             pcfg, sample_weights=torch.from_numpy(w)).backward()
    ref = np.asarray(ref)
    err = float(np.abs(x.grad.numpy() - ref).max())
    assert err <= 1e-4 * np.abs(ref).max() + 1e-7, err
    assert float(x.grad[2].abs().max()) == 0.0    # the weight-0 sample
