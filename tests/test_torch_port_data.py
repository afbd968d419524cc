"""The port's training input path against the JAX package's, on the CPU.

Image files are written into ``tmp_path``: by Pillow where it can write the
format, otherwise by a small PNG writer here (every bit depth, Adam7, each
row filter), and Pillow's reading of each file is the reference for
``data/png.py``. The host transforms, the datasets and the loaders are held
to JAX's on the same files and the same ``np.random.Generator`` seeds: equal,
but for the rotation, where cv2's fixed point and the port's double
precision differ by at most 1 in the interior. The device augmentation's
apply steps get JAX's own draws (recomputed from JAX's key splits): crops,
flips and normalisation within 1e-6, rotation within 1e-5 on ≥ 99.9% of
values and 2/127.5 anywhere, the synthetic degradation equal but where the
1/255 floor flips. The native C++ library is held in
``test_torch_port_data_native.py``.
"""

import io
import struct
import subprocess
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cv_diffusion_tpu.data import augment as jaugment
from cv_diffusion_tpu.data import dataset as jdataset
from cv_diffusion_tpu.data import device_augment as jdevice_augment
from cv_diffusion_tpu_torch.config import TrainConfig
from cv_diffusion_tpu_torch.data import augment as taugment
from cv_diffusion_tpu_torch.data import dataset as tdataset
from cv_diffusion_tpu_torch.data import device_augment as tdevice_augment
from cv_diffusion_tpu_torch.data import native as tnative
from cv_diffusion_tpu_torch.data import png
from cv_diffusion_tpu_torch.data.device_cache import DeviceCacheLoader, load_frames
from cv_diffusion_tpu_torch.data.prefetch import PrefetchLoader
from cv_diffusion_tpu_torch.training import checkpoint as tckpt

from test_torch_port_weights import one_torch_thread  # noqa: F401

REPO = __file__.rsplit("/tests/", 1)[0]


# --- a PNG writer for what Pillow cannot write ---------------------------------

def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Filter uint8 rows [h, n] with filter ftypes[y % len] (the spec's
    formulas, written independently of the port's encoder)."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) // 2, paeth]
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    for y in range(rows.shape[0]):
        f = ftypes[y % len(ftypes)]
        out[y, 0] = f
        out[y, 1:] = (x[y] - preds[f][y]) & 255
    return out.tobytes()


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.reshape(h, w * ch).astype(np.uint8)
    bits = (samples.reshape(h, w * ch)[..., None]
            >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def _raw_png(samples, color, depth, interlace=0, ftypes=(0, 1, 2, 3, 4),
             plte=None, trns=None) -> bytes:
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if not interlace:
        body = _filter_rows(_pack(samples, depth), bpp, ftypes)
    else:
        body = b"".join(
            _filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp, ftypes)
            for y0, x0, dy, dx in png._ADAM7
            if samples[y0::dy, x0::dx].size)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    out = png.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")


def _pillow_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im.convert("RGB"))


_PNG_CASES = [(color, depth, interlace, trns)
              for color, depths in sorted(png._DEPTHS.items())
              for depth in depths for interlace in (0, 1)
              for trns in ((False, True) if color == 3 else (False,))]


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("color,depth,interlace,trns", _PNG_CASES,
                         ids=lambda v: str(int(v)))
def test_png_decode_equals_pillow(color, depth, interlace, trns):
    """Every colour type and bit depth, Adam7 or not, palette with and
    without tRNS, rows cycling through the five filters: the decode equals
    ``np.array(Image.open(p).convert("RGB"))`` exactly (16-bit gray clips
    to 255 there, 16-bit colour keeps the high byte)."""
    rng = np.random.default_rng(100 * color + depth + interlace)
    ch = png._CHANNELS[color]
    s = rng.integers(0, 1 << depth, (13, 11, ch))
    if depth == 16:
        s[0, :6, 0] = [0, 200, 255, 256, 4095, 65535]
    plte = None
    if color == 3:
        plte = rng.integers(0, 256, (min(1 << depth, 200), 3))
        s %= len(plte)
    data = _raw_png(s, color, depth, interlace, plte=plte,
                    trns=bytes(range(len(plte) // 2)) if trns else None)
    np.testing.assert_array_equal(png.decode_png(data), _pillow_rgb(data))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PT", "RGB", "RGBA",
                                  "I;16"])
def test_png_files_pillow_writes(tmp_path, mode):
    """Files as Pillow writes them (its own filter choice per row, palette
    transparency): read as Pillow reads them."""
    rng = np.random.default_rng(7)
    rgb = Image.fromarray(rng.integers(0, 256, (21, 17, 3), dtype=np.uint8))
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 700, (21, 17)).astype(np.uint16))
    elif mode in ("P", "PT"):
        im = rgb.quantize(40)
        if mode == "PT":
            im.info["transparency"] = 3
    else:
        im = rgb.convert(mode)
    path = tmp_path / "x.png"
    im.save(path, transparency=im.info.get("transparency"))
    with Image.open(path) as ref:
        want = np.array(ref.convert("RGB"))
    np.testing.assert_array_equal(png.read_image(path), want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_bmp_decode_equals_pillow(tmp_path, mode):
    img = np.random.default_rng(3).integers(0, 256, (9, 7, len(mode)),
                                            dtype=np.uint8)
    Image.fromarray(img, mode).save(tmp_path / "x.bmp")
    with Image.open(tmp_path / "x.bmp") as ref:
        want = np.array(ref.convert("RGB"))
    np.testing.assert_array_equal(png.read_image(tmp_path / "x.bmp"), want)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
def test_png_encoder_read_back_by_pillow(tmp_path, filters):
    img = np.random.default_rng(4).integers(0, 256, (17, 19, 3), dtype=np.uint8)
    png.write_png(tmp_path / "x.png", img, filters)
    with Image.open(tmp_path / "x.png") as got:
        assert got.mode == "RGB"
        np.testing.assert_array_equal(np.array(got), img)
    np.testing.assert_array_equal(png.read_image(tmp_path / "x.png"), img)


def test_jpeg_is_refused_with_the_native_loader_named(tmp_path):
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "x.jpg")
    with pytest.raises(ValueError, match="JPEG.*native loader"):
        png.read_image(tmp_path / "x.jpg")


# --- host transforms, datasets, loaders ----------------------------------------

@pytest.mark.parametrize("angle", [-15.0, -7.3, 0.0, 4.9, 15.0])
def test_rotate_within_one_lsb_of_cv2_in_the_interior(angle):
    img = np.random.default_rng(11).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    diff = np.abs(jaugment.rotate(img, angle).astype(int)
                  - taugment.rotate(img, angle).astype(int))
    assert diff[2:-2, 2:-2].max() <= 1
    assert diff.mean() < 0.5


def _assert_pair_close(got, want, rotated_allowed):
    """Equal, or (where a rotation may have run) within 1 LSB, 2/255 after
    normalisation, in the interior. Returns whether they differ."""
    if np.array_equal(got, want):
        return False
    assert rotated_allowed
    diff = np.abs(got - want)
    assert diff[2:-2, 2:-2].max() <= 2 / 255 + 1e-6
    assert diff.mean() < 1 / 255
    return True


def test_paired_transforms_equal_jax_for_equal_seeds():
    """The same draws from the same generator (the generators stay in step),
    the same crops and flips; rotation within 1 LSB."""
    rng = np.random.default_rng(5)
    differed = 0
    for seed in range(40):
        low = rng.integers(0, 256, (40, 47, 3), dtype=np.uint8)
        high = rng.integers(0, 256, (41, 46, 3), dtype=np.uint8)
        ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jaugment.paired_train_transform(ga, low, high, 32)
        got = taugment.paired_train_transform(gb, low, high, 32)
        assert ga.random() == gb.random()
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (32, 32, 3)
            differed += _assert_pair_close(g, w, True)
    assert 0 < differed < 40        # rotations ran, and most pairs are equal
    for g, w in zip(taugment.paired_eval_transform(low, high, 32),
                    jaugment.paired_eval_transform(low, high, 32)):
        np.testing.assert_array_equal(g, w)
    assert (taugment.center_crop_coords(41, 46, 32)
            == jaugment.center_crop_coords(41, 46, 32))
    with pytest.raises(ValueError, match="smaller than crop"):
        taugment.center_crop_coords(20, 46, 32)


def _lol(root, n=5, shape=(36, 44), low_dir="low", high_dir="high", ext="png"):
    rng = np.random.default_rng(len(str(root)))
    for sub in (low_dir, high_dir):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        high = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        low = (high * rng.uniform(0.1, 0.4)).astype(np.uint8)
        Image.fromarray(low).save(root / low_dir / f"{i:02d}.{ext}")
        Image.fromarray(high).save(root / high_dir / f"{i:02d}.{ext}")
    return root


@pytest.fixture(scope="module")
def lol_dir(tmp_path_factory):
    return _lol(tmp_path_factory.mktemp("lol"))


@pytest.mark.parametrize("augment_data,paired", [(True, True), (False, True),
                                                 (True, False)])
def test_low_light_dataset_equals_jax(lol_dir, augment_data, paired):
    kw = dict(image_size=32, augment_data=augment_data, paired=paired, seed=3)
    ref = jdataset.LowLightDataset(str(lol_dir), **kw)
    got = tdataset.LowLightDataset(str(lol_dir), **kw)
    assert [p.name for p in got.low_images] == [p.name for p in ref.low_images]
    for _ in range(3):
        for i in range(len(ref)):
            r, g = ref[i], got[i]
            assert g["filename"] == r["filename"]
            for key in ("low_light", "normal_light"):
                _assert_pair_close(g[key], r[key], augment_data)
        assert ref._rng.random() == got._rng.random()


def test_dataset_probing_truncation_and_errors(tmp_path, capsys):
    root = _lol(tmp_path / "a", n=3, low_dir="dark", high_dir="normal")
    (root / "normal" / "99.png").write_bytes(png.encode_png(
        np.zeros((36, 44, 3), np.uint8)))
    got = tdataset.LowLightDataset(str(root), image_size=32)
    assert len(got) == 3 and got.high_images[0].parent.name == "normal"
    assert "Image count mismatch" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="not found"):
        tdataset.LowLightDataset(str(tmp_path / "none"))
    (tmp_path / "b" / "low").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="(?s)High-light.*structure"):
        tdataset.LowLightDataset(str(tmp_path / "b"))


def test_synthetic_directory_dataset_and_loader_equal_jax(lol_dir):
    """The directory form of the synthetic dataset, batched with
    filenames: JAX's batches bit for bit over two epochs."""
    ref = jdataset.DataLoader(jdataset.SyntheticLowLightDataset(
        str(lol_dir / "high"), image_size=32, seed=3), 2, shuffle=True,
        drop_last=True, seed=4)
    got = tdataset.DataLoader(tdataset.SyntheticLowLightDataset(
        str(lol_dir / "high"), image_size=32, seed=3), 2, shuffle=True,
        drop_last=True, seed=4)
    assert len(got) == len(ref) == 2
    for _ in range(2):
        for r, g in zip(ref, got):
            assert g["filenames"] == r["filenames"]
            for key in ("low_light", "normal_light"):
                np.testing.assert_array_equal(g[key], r[key])


def test_shard_files_by_process_equals_jax():
    files = list(range(11))
    for n, pid in ((1, 0), (3, 0), (3, 2), (4, 1)):
        assert (tdataset.shard_files_by_process(files, pid, n)
                == jdataset.shard_files_by_process(files, pid, n))
    for args in ((files, 3, 3), (files[:2], 0, 3)):
        with pytest.raises(ValueError):
            tdataset.shard_files_by_process(*args)


def _kinds(loaders):
    def kind(x):
        if x is None:
            return None
        if isinstance(x, PrefetchLoader):
            return "prefetch:" + kind(x.loader)
        return type(x).__name__
    return tuple(kind(x) for x in loaders)


def test_create_dataloaders_routes_as_jax(lol_dir, tmp_path, monkeypatch):
    """The routing of ``create_dataloaders`` (Python / prefetch / device
    cache / synthetic) and its errors, as the JAX tests check it; the
    native library is made unavailable here (its routes are held in
    ``test_torch_port_data_native.py``)."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_REASON", "no libpng headers (test)")
    kw = dict(batch_size=2, image_size=32, device="cpu")
    root = str(lol_dir)
    assert _kinds(tdataset.create_dataloaders(root, root, **kw)) == (
        "prefetch:DataLoader", "prefetch:DataLoader")
    assert _kinds(tdataset.create_dataloaders(root, None, prefetch=0, **kw)) == (
        "DataLoader", None)
    assert _kinds(tdataset.create_dataloaders(root, root, device_cache=True,
                                              **kw)) == (
        "DeviceCacheLoader", "prefetch:DataLoader")
    assert _kinds(tdataset.create_dataloaders(
        str(lol_dir / "high"), None, use_synthetic=True, prefetch=0,
        gamma_range=(2.0, 3.0), **kw)) == ("DataLoader", None)
    with pytest.raises(RuntimeError, match="unavailable: no libpng"):
        tdataset.create_dataloaders(root, None, native=True, **kw)
    with pytest.raises(TypeError, match="unknown dataset kwargs"):
        tdataset.create_dataloaders(root, None, gama_range=(1, 2), **kw)
    with pytest.raises(ValueError, match="paired=True"):
        tdataset.create_dataloaders(root, None, device_cache=True,
                                    paired=False, **kw)
    # one process is all the port trains in
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    with pytest.raises(NotImplementedError, match="item 8"):
        tdataset.create_dataloaders(root, None, **kw)


def test_prefetch_stops_early_and_raises_the_producers_error():
    produced = []

    class Counting:
        def __len__(self):
            return 1000

        def __iter__(self):
            for i in range(1000):
                produced.append(i)
                yield {"low_light": np.full(1, i)}

    first = next(iter(PrefetchLoader(Counting(), prefetch=2)))
    np.testing.assert_array_equal(first["low_light"], np.zeros(1))
    deadline = time.time() + 5.0
    while time.time() < deadline and threading.active_count() > 1 \
            and len(produced) < 6:
        time.sleep(0.01)
    assert len(produced) <= 6, f"producer ran on: {len(produced)} batches"

    class Boom:
        def __len__(self):
            return 1

        def __iter__(self):
            yield {"low_light": np.zeros(1)}
            raise ValueError("decode failed")

    with pytest.raises(ValueError, match="decode failed"):
        list(PrefetchLoader(Boom(), prefetch=2))
    with pytest.raises(ValueError):
        PrefetchLoader(Boom(), prefetch=0)


# --- device augmentation on JAX's draws ---------------------------------------

def _jax_paired_draws(key, b, h, w, size):
    """``device_augment.paired_augment``'s draws, from its own splits."""
    k_top, k_left, k_h, k_v, k_rp, k_ra = jax.random.split(key, 6)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return {
        "tops": t(jax.random.randint(k_top, (b,), 0, h - size + 1)).long(),
        "lefts": t(jax.random.randint(k_left, (b,), 0, w - size + 1)).long(),
        "hflip": t(jax.random.uniform(k_h, (b,)) < 0.5),
        "vflip": t(jax.random.uniform(k_v, (b,)) < 0.3),
        "rotate": t(jax.random.uniform(k_rp, (b,)) < 0.3),
        "angles": t(jax.random.uniform(k_ra, (b,), minval=-15.0, maxval=15.0)),
    }


def test_device_paired_augment_apply_on_jax_draws():
    b, h, w, size = 16, 30, 37, 24
    rng = np.random.default_rng(8)
    low = (rng.integers(0, 256, (b, h, w, 3)) / 127.5 - 1).astype(np.float32)
    high = (rng.integers(0, 256, (b, h, w, 3)) / 127.5 - 1).astype(np.float32)
    key = jax.random.key(21)
    want = jdevice_augment.paired_augment(key, jnp.asarray(low),
                                          jnp.asarray(high), size)
    draws = _jax_paired_draws(key, b, h, w, size)
    assert 0 < int(draws["rotate"].sum()) < b
    got = tdevice_augment.apply_paired(torch.from_numpy(low),
                                       torch.from_numpy(high), draws, size)
    plain = ~draws["rotate"].numpy()
    for g, r in zip(got, want):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g[plain], r[plain], atol=1e-6, rtol=0)
        d = np.abs(g[~plain] - r[~plain])
        assert (d <= 1e-5).mean() >= 0.999 and d.max() <= 2 / 127.5
    for g, r in zip(tdevice_augment.paired_center_crop(
            torch.from_numpy(low), torch.from_numpy(high), size),
            jdevice_augment.paired_center_crop(jnp.asarray(low),
                                               jnp.asarray(high), size)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_device_synthetic_degradation_apply_on_jax_draws():
    b, s = 6, 20
    normal = (np.random.default_rng(9).integers(0, 256, (b, s, s, 3)) / 127.5
              - 1).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jdevice_augment.synthetic_low_light(key, jnp.asarray(normal)))
    k_g, k_nl, k_n, k_cp, k_cs = jax.random.split(key, 5)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    draws = {
        "gamma": t(jax.random.uniform(k_g, (b, 1, 1, 1), minval=2.0, maxval=5.0)),
        "noise_level": t(jax.random.uniform(k_nl, (b, 1, 1, 1), minval=0.01,
                                            maxval=0.05)),
        "noise": t(jax.random.normal(k_n, (b, s, s, 3))),
        "scale": t(jax.random.uniform(k_cs, (b, 1, 1, 3), minval=0.8, maxval=1.0)),
        "color_shift": t(jax.random.uniform(k_cp, (b, 1, 1, 1)) < 0.5),
    }
    got = tdevice_augment.apply_synthetic(torch.from_numpy(normal), draws).numpy()
    grid = np.round((got + 1) * 127.5)
    np.testing.assert_allclose((got + 1) * 127.5, grid, atol=1e-4)
    flips = np.abs(got - want) > 1e-6
    assert flips.mean() < 1e-3
    assert np.abs(got - want).max() <= 2 / 255 + 1e-6


# --- the device cache on the CPU ------------------------------------------------

def test_device_cache_pairs_seeds_windows_and_sizes(lol_dir, tmp_path):
    lows = sorted(str(p) for p in (lol_dir / "low").iterdir())
    highs = sorted(str(p) for p in (lol_dir / "high").iterdir())
    frames = load_frames(lows)
    assert frames.dtype == np.uint8 and frames.shape == (5, 36, 44, 3)
    np.testing.assert_array_equal(frames[0], png.read_image(lows[0]))

    # the centre crop is the host eval transform exactly
    ev = DeviceCacheLoader(lows, highs, 32, 2, augment=False, device="cpu")
    assert ev.nbytes() == 2 * 5 * 36 * 44 * 3
    host = tdataset.LowLightDataset(str(lol_dir), image_size=32, augment_data=False)
    for bi, batch in enumerate(ev):
        for j, name in enumerate(batch["filenames"]):
            item = host[2 * bi + j]
            assert name == item["filename"]
            np.testing.assert_array_equal(batch["low_light"][j].numpy(), item["low_light"])
            np.testing.assert_array_equal(batch["normal_light"][j].numpy(),
                                          item["normal_light"])

    # augmented: pairs share one transform (high = 255 − low keeps its
    # relation), each unrotated crop is a window of its frame, and the seed
    # fixes the batches
    inv = tmp_path / "inv"
    for sub in ("low", "high"):
        (inv / sub).mkdir(parents=True)
    for i, f in enumerate(frames):
        png.write_png(inv / "low" / f"{i}.png", f)
        png.write_png(inv / "high" / f"{i}.png", 255 - f)
    il = sorted(str(p) for p in (inv / "low").iterdir())
    ih = sorted(str(p) for p in (inv / "high").iterdir())
    loaders = [DeviceCacheLoader(il, ih, 24, 2, shuffle=True, drop_last=True,
                                 seed=s, device="cpu") for s in (1, 1, 2)]
    assert len(loaders[0]) == 2
    epochs = [[b for _ in range(4) for b in dl] for dl in loaders]
    for a, b in zip(epochs[0], epochs[1]):
        assert torch.equal(a["low_light"], b["low_light"])
    assert not all(torch.equal(a["low_light"], c["low_light"])
                   for a, c in zip(epochs[0], epochs[2]))
    windows = {f.tobytes() for fr in frames for f in _windows(fr, 24)}
    exact = 0
    for batch in epochs[0]:
        lo, hi = batch["low_light"], batch["normal_light"]
        assert lo.shape == (2, 24, 24, 3) and lo.dtype == torch.float32
        assert float((lo + hi).abs().max()) <= 1e-5
        for crop in lo:
            u8 = np.round((crop.numpy() + 1) * 127.5).astype(np.uint8)
            exact += u8.tobytes() in windows
    assert 8 <= exact < 16       # rotate p=.3: most crops are plain windows

    # synthetic mode: values on the 1/255 grid, normal frames windows
    syn = DeviceCacheLoader(lows, None, 24, 2, device="cpu", seed=3)
    batch = next(iter(syn))
    lo = (batch["low_light"].numpy() + 1) * 127.5
    np.testing.assert_allclose(lo, np.round(lo), atol=1e-3)
    for crop in batch["normal_light"]:
        u8 = np.round((crop.numpy() + 1) * 127.5).astype(np.uint8)
        assert u8.tobytes() in windows

    # sizes: mixed frames, mismatched pairs, crops larger than frames
    bad = tmp_path / "bad"
    png.write_png(bad / "a.png", frames[0])
    png.write_png(bad / "b.png", frames[0][:30])
    with pytest.raises(ValueError, match="uniform frame sizes"):
        load_frames([str(bad / "a.png"), str(bad / "b.png")])
    with pytest.raises(ValueError, match="matching low/high"):
        DeviceCacheLoader([str(bad / "a.png")], [str(bad / "b.png")], 24, 1,
                          device="cpu")
    with pytest.raises(ValueError, match="smaller than crop"):
        DeviceCacheLoader([str(bad / "a.png")], None, 40, 1, device="cpu")


def _windows(frame, size):
    """Every size × size window of ``frame``, each with its flips."""
    h, w, _ = frame.shape
    for t in range(h - size + 1):
        for left in range(w - size + 1):
            win = frame[t:t + size, left:left + size]
            for v in (win, win[:, ::-1], win[::-1], win[::-1, ::-1]):
                yield np.ascontiguousarray(v)


# --- checkpoints, grids, train_model, the CLI -----------------------------------

def _tiny_state():
    from cv_diffusion_tpu_torch.config import diffusion_config
    from cv_diffusion_tpu_torch.models.diffusion import create_model
    from cv_diffusion_tpu_torch.training.train_state import create_train_state
    from cv_diffusion_tpu_torch.weights import init_weights

    cfg = diffusion_config("tiny", 32)
    model, schedule = create_model(cfg, device="cpu")
    model.load_state_dict(init_weights(cfg, seed=0, device="cpu"), strict=True)
    tc = TrainConfig(unet_variant="tiny", image_size=32, use_amp=False)
    return model, schedule, create_train_state(model, tc), tc


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema_params.items()})


def test_async_checkpoint_is_the_state_at_save_time(tmp_path):
    """An async save restores what a sync save of the same moment restores,
    though a step runs in place right after :meth:`save`; saves land in
    order, and a failed write raises from the next call."""
    from cv_diffusion_tpu_torch.training.train_state import make_train_step

    model, schedule, state, tc = _tiny_state()
    step = make_train_step(model, schedule, tc)
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
             for k in ("low_light", "normal_light")}
    state, _ = step(state, batch)
    saver = tckpt.AsyncCheckpointSaver(max_pending=1)
    tckpt.save_checkpoint(str(tmp_path / "sync.pt"), state, epoch=3,
                          best_val_loss=0.5, config_json="{}")
    params, ema = _snapshot(state)
    saver.save(str(tmp_path / "async.pt"), state, epoch=3, best_val_loss=0.5,
               config_json="{}")
    state, _ = step(state, batch)             # in place, after the save
    saver.save(str(tmp_path / "later.pt"), state, epoch=4, best_val_loss=0.4,
               config_json="{}")
    saver.wait()
    sync, got = tckpt.load_raw(str(tmp_path / "sync.pt")), tckpt.load_raw(
        str(tmp_path / "async.pt"))
    assert got["step"] == sync["step"] == 1 and got["epoch"] == 3
    for k in params:
        assert torch.equal(got["params"][k], params[k])
        assert torch.equal(got["params"][k], sync["params"][k])
    for k in ema:
        assert torch.equal(got["ema_params"][k], ema[k])
    for i, s in sync["opt_state"]["state"].items():
        for name, t in s.items():
            assert torch.equal(got["opt_state"]["state"][i][name], t)
    assert torch.equal(got["generator"], sync["generator"])
    assert tckpt.load_raw(str(tmp_path / "later.pt"))["step"] == 2

    (tmp_path / "file").write_text("")
    saver.save(str(tmp_path / "file" / "x.pt"), state, epoch=0,
               best_val_loss=0.0, config_json="{}")
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                               # the failed job is gone
    saver.save_params(str(tmp_path / "params"), dict(model.named_parameters()),
                      '{"a": 1}', sidecar={"student_timesteps.json": "[739]"})
    saver.wait()
    weights = tckpt.load_inference_params(str(tmp_path / "params"))
    assert all(torch.equal(weights[k], p) for k, p in model.named_parameters())
    assert (tmp_path / "params" / "student_timesteps.json").read_text() == "[739]"


def test_comparison_grid_pixels_equal_jax(tmp_path):
    from cv_diffusion_tpu.training.trainer import (
        save_comparison_grid as jax_grid)
    from cv_diffusion_tpu_torch.training.trainer import save_comparison_grid

    rng = np.random.default_rng(2)
    blocks = [rng.uniform(-1.1, 1.1, (3, 8, 10, 3)).astype(np.float32)
              for _ in range(3)]
    jax_grid(*blocks, str(tmp_path / "jax.png"))
    save_comparison_grid(*[torch.from_numpy(b) for b in blocks],
                         str(tmp_path / "port.png"))
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        assert b.size == (30, 24)
        np.testing.assert_array_equal(np.array(a), np.array(b))


def test_train_model_from_directories_on_the_cpu(lol_dir, tmp_path):
    """Two steps of tiny@32 from a PNG directory: a checkpoint, a sample
    grid decoded back to the arrays it was made from, asynchronous saves
    drained."""
    from cv_diffusion_tpu_torch.training.trainer import train_model

    tc = TrainConfig(unet_variant="tiny", image_size=32, batch_size=2,
                     epochs=1, use_amp=False, warmup_epochs=0, native_loader=False,
                     num_inference_steps=1, checkpoint_dir=str(tmp_path / "ck"),
                     output_dir=str(tmp_path / "out"), log_interval=1)
    trainer = train_model(str(lol_dir), str(lol_dir), tc, device="cpu")
    assert trainer.state.step == 2 and trainer.epoch_stats["steps"] == 2
    assert trainer.epoch_stats["loader_wait_s"] >= 0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "best_model.pt", "final_model.pt"]
    grid = png.read_image(tmp_path / "out" / "samples_epoch_0.png")
    assert grid.shape == (3 * 32, 2 * 32, 3)
    first = next(iter(trainer.val_loader))
    want = np.clip((first["normal_light"][0] + 1) / 2 * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[64:, :32], want)


def test_train_cli_help_and_refused_flags(tmp_path):
    from cv_diffusion_tpu_torch import train as tcli

    proc = subprocess.run([sys.executable, "-m", "cv_diffusion_tpu_torch.train",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--data_on_device" in proc.stdout
    for flags, item in ((["--distributed"], "item 8"),
                        (["--config", "x.yaml"], "item 9"), (["--wandb"], "W&B")):
        with pytest.raises(NotImplementedError, match=item):
            tcli.main(flags)
    args = tcli.build_parser().parse_args(["--no_amp", "--sync_checkpoints",
                                           "--val_dir", "none"])
    config, data_dir, val_dir, synth = tcli.resolve_config(args)
    assert not config.use_amp and not config.async_checkpoints and config.use_ema
    assert (data_dir, val_dir, synth) == ("data/our485", None, False)
    assert config.epochs == 100 and config.batch_size == 8
    # --qat and --qat_act, refused before QAT was ported, set their fields
    config = tcli.resolve_config(tcli.build_parser().parse_args(["--qat_act"]))[0]
    assert config.qat_act and not config.qat
