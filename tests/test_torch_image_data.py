"""Port vs JAX: the colour transforms (data/transforms.py) and the image and
video datasets (data/image.py) on the CPU.

Transforms run on seeded arrays through both packages: the YCbCr pair and
the 4:2:0 average pool within 1e-6 x max|ref| (float32 summation order),
the 4:2:0 -> 4:4:4 upsampling (bilinear and nearest) within the same bound
at every position, the borders included. Datasets read PNGs written with
PIL into a temporary directory (and a memmap and a raw .yuv file written
with numpy): every item equals the JAX package's array bitwise, and
``tools/train.build_data`` on an ``ImageFolder`` config gives the JAX
CLI's batches."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import cra5_tpu.data as jdata
import cra5_tpu.data.image as jimage
from cra5_tpu.tools import train as j_train
from cra5_tpu_torch import data as tdata
from cra5_tpu_torch import registry
from cra5_tpu_torch.data import image as timage
from cra5_tpu_torch.tools import train

RTOL = 1e-6  # x max|ref|


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1.0)


def _arr(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 3, 9, 12)])
def test_ycbcr_pair_matches_jax(shape):
    x = _arr(shape, 0)
    y = tdata.rgb2ycbcr(torch.from_numpy(x))
    _close(y, jdata.rgb2ycbcr(jnp.asarray(x)))
    _close(tdata.ycbcr2rgb(y), jdata.ycbcr2rgb(jnp.asarray(y.numpy())))
    assert torch.allclose(tdata.ycbcr2rgb(y), torch.from_numpy(x), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (3, 9, 13)])
def test_444_to_420_matches_jax(shape):
    x = _arr(shape, 1)
    got = tdata.yuv_444_to_420(torch.from_numpy(x))
    want = jdata.yuv_444_to_420(jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)
    planes = tuple(torch.from_numpy(p) for p in np.split(x, 3, axis=-3))
    for g, w in zip(tdata.yuv_444_to_420(planes), want):
        _close(g, w)
    with pytest.raises(ValueError, match="downsampling"):
        tdata.yuv_444_to_420(torch.from_numpy(x), mode="bicubic")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_420_to_444_matches_jax_at_the_borders(mode, lead):
    y = _arr(lead + (1, 10, 14), 2)
    u, v = _arr(lead + (1, 5, 7), 3), _arr(lead + (1, 5, 7), 4)
    t = tuple(torch.from_numpy(a) for a in (y, u, v))
    j = tuple(jnp.asarray(a) for a in (y, u, v))
    got = tdata.yuv_420_to_444(t, mode=mode)
    want = np.asarray(jdata.yuv_420_to_444(j, mode=mode))
    _close(got, want)
    # the borders alone: first and last rows and columns of the chroma
    for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
        assert np.abs(got.numpy()[sl] - want[sl]).max() <= RTOL
    for g, w in zip(tdata.yuv_420_to_444(t, mode=mode, return_tuple=True),
                    jdata.yuv_420_to_444(j, mode=mode, return_tuple=True)):
        _close(g, w)
    with pytest.raises(ValueError, match="upsampling"):
        tdata.yuv_420_to_444(t, mode="bicubic")


def _png(path, h, w, seed):
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(px).save(path)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """root/{train,valid}/*.png (and a stray .txt), root/videos/train/<clip>/
    frames, a Vimeo-90k tree and its list, a memmap of patches and a raw
    .yuv file."""
    root = tmp_path_factory.mktemp("images")
    for split, n in (("train", 5), ("valid", 2)):
        (root / split).mkdir()
        for i in range(n):
            _png(root / split / f"im{i:02d}.png", 20 + i, 24, seed=10 * i + len(split))
    (root / "train" / "notes.txt").write_text("not an image")
    for c, frames in enumerate((4, 2, 3)):
        d = root / "videos" / "train" / f"clip{c}"
        d.mkdir(parents=True)
        for f in range(frames):
            _png(d / f"f{f}.png", 16, 20, seed=100 + 10 * c + f)
    seqs = ["00001/0001", "00001/0002"]
    for s in seqs:
        d = root / "vimeo" / "sequences" / s
        d.mkdir(parents=True)
        for i in range(1, 4):
            _png(d / f"im{i}.png", 12, 16, seed=200 + i + len(s))
    (root / "vimeo" / "tri_trainlist.txt").write_text("\n".join(seqs) + "\n\n")
    (root / "patches").mkdir()
    rng = np.random.default_rng(7)
    rng.integers(0, 256, (6, 8, 10, 3), dtype=np.uint8).tofile(root / "patches" / "training.npy")
    rng.integers(0, 256, (2, 8, 10, 3), dtype=np.uint8).tofile(root / "patches" / "validation.npy")
    w, h = 8, 6
    frame = w * h + 2 * (w // 2) * (h // 2)
    rng.integers(0, 256, 3 * frame, dtype=np.uint8).tofile(root / f"seq_{w}x{h}_30.yuv")
    rng.integers(0, 1024, 2 * frame, dtype=np.uint16).tofile(root / "ten_bit.yuv")
    return root


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in b)
        else:
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_image_folder_items_equal_jax(folder):
    _same_items(timage.ImageFolder(str(folder)), jimage.ImageFolder(str(folder)))
    _same_items(timage.ImageFolder(str(folder), "valid"),
                jimage.ImageFolder(str(folder), "valid"))
    tc = timage.ImageFolder(str(folder), transform=lambda im: timage.center_crop(im, 16))
    jc = jimage.ImageFolder(str(folder), transform=lambda im: jimage.center_crop(im, 16))
    _same_items(tc, jc)
    assert tc[0].shape == (3, 16, 16) and len(tc) == 5
    with pytest.raises(RuntimeError, match="Invalid directory"):
        timage.ImageFolder(str(folder), "test")


def test_crops_equal_jax():
    img = _arr((3, 20, 24), 5)
    a = timage.random_crop(img, 16, random.Random(3))
    b = jimage.random_crop(img, 16, random.Random(3))
    assert np.array_equal(a, b) and a.shape == (3, 16, 16)
    assert np.array_equal(timage.center_crop(img, 9), jimage.center_crop(img, 9))
    with pytest.raises(ValueError, match="smaller than crop"):
        timage.random_crop(img, 32)


def test_memmap_patches_equal_jax(folder):
    root = str(folder / "patches")
    for split in ("train", "valid"):
        _same_items(timage.PreGeneratedMemmapDataset(root, split, (8, 10)),
                    jimage.PreGeneratedMemmapDataset(root, split, (8, 10)))
    assert timage.PreGeneratedMemmapDataset(root, "train", (8, 10))[0].shape == (3, 8, 10)
    with pytest.raises(ValueError, match="split"):
        timage.PreGeneratedMemmapDataset(root, "test", 8)
    with pytest.raises(RuntimeError, match="Invalid path"):
        timage.PreGeneratedMemmapDataset(str(folder / "nope"))


def test_video_datasets_equal_jax(folder):
    got = timage.VideoFolder(str(folder / "videos"), max_frames=3)
    _same_items(got, jimage.VideoFolder(str(folder / "videos"), max_frames=3))
    assert len(got) == 2 and got[0].shape == (3, 3, 16, 20)  # the 2-frame clip is skipped
    flip = lambda f: f[:, ::-1].copy()  # noqa: E731
    _same_items(timage.VideoFolder(str(folder / "videos"), transform=flip),
                jimage.VideoFolder(str(folder / "videos"), transform=flip))
    _same_items(timage.Vimeo90kDataset(str(folder / "vimeo")),
                jimage.Vimeo90kDataset(str(folder / "vimeo")))
    assert len(timage.Vimeo90kDataset(str(folder / "vimeo"))) == 6
    with pytest.raises(RuntimeError, match="Missing list"):
        timage.Vimeo90kDataset(str(folder / "vimeo"), split="test")


def test_raw_video_frames_equal_jax(folder):
    path = str(folder / "seq_8x6_30.yuv")
    got, want = timage.RawVideoSequence(path), jimage.RawVideoSequence(path)
    assert (got.width, got.height, len(got)) == (8, 6, 3)
    _same_items(got, want)
    assert got[0]["u"].shape == (1, 3, 4)
    ten = str(folder / "ten_bit.yuv")
    _same_items(timage.RawVideoSequence(ten, 8, 6, bitdepth=10),
                jimage.RawVideoSequence(ten, 8, 6, bitdepth=10))
    with pytest.raises(IndexError):
        got[3]
    with pytest.raises(ValueError, match="WxH"):
        timage.RawVideoSequence(ten)


def test_the_datasets_are_registered_and_train_feeds_the_jax_batches(folder):
    assert registry.NOT_PORTED["datasets"] == ()
    for name in ("ImageFolder", "PreGeneratedMemmapDataset", "VideoFolder", "Vimeo90kDataset"):
        assert registry.DATASETS.get(name) is getattr(timage, name)
    dcfg = dict(type="ImageFolder", root=str(folder), split="valid", batch_size=1, epochs=2)
    got = [b.numpy() for b in train.build_data(dict(dcfg), seed=3, device="cpu")]
    want = list(j_train.build_data(dict(dcfg), seed=3))
    assert len(got) == len(want) == 4
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
    assert {b.shape for b in got} == {(1, 3, 20, 24), (1, 3, 21, 24)}
