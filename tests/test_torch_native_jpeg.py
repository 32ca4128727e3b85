"""The port's native JPEG decoder (tdeed_tpu_torch/native/jpeg.py) against
the JAX package's (tdeed_tpu/native/jpeg.py): the same C++ source and
flags, so every decode is held bit for bit (tolerance 0) on JPEGs PIL
writes at quality 95, including an odd width and a grayscale file; the
zero-fill contract of decode_batch; the committed fixtures against their
manifest; and a failed build, which ``get_decoder('native')`` reports
with the compiler's message while 'auto' goes on to the next decoder.

``write_fixtures`` wrote tdeed_tpu_torch/native/fixtures/ (run this file
as a script with the directory as its argument to write them again).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from tdeed_tpu.native import jpeg as jjpeg
from tdeed_tpu_torch.data import frames as pframes
from tdeed_tpu_torch.native import jpeg as pjpeg

FIXTURES = os.path.join(os.path.dirname(pjpeg.__file__), "fixtures")
# (file, height, width, PIL mode): the 256^2 frames feed chip_smoke.py's
# phase-11 FineDiving videos, the 448x796 ones are SoccerNet Ball's full
# frames, the small ones are the tools' fixture sizes (24^2, 24x32, 32^2),
# and one has an odd width and height
FIXTURE_FRAMES = (
    ("rgb_256x256_0.jpg", 256, 256, "RGB"),
    ("rgb_256x256_1.jpg", 256, 256, "RGB"),
    ("rgb_256x256_2.jpg", 256, 256, "RGB"),
    ("rgb_448x796_0.jpg", 448, 796, "RGB"),
    ("rgb_448x796_1.jpg", 448, 796, "RGB"),
    ("gray_24x24.jpg", 24, 24, "L"),
    ("rgb_24x32.jpg", 24, 32, "RGB"),
    ("rgb_32x32.jpg", 32, 32, "RGB"),
    ("rgb_45x61.jpg", 45, 61, "RGB"),
)


def fixture_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth colour gradient (its direction and phase from the seed)
    plus uniform noise of +-20: the content of a video frame, which a JPEG
    compresses like one, not like pure noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack([
        127.5 + 100 * np.sin(2 * np.pi * x / w + phase[0]),
        127.5 + 100 * np.sin(2 * np.pi * y / h + phase[1]),
        127.5 + 100 * np.sin(2 * np.pi * (x / w + y / h) + phase[2]),
    ], axis=-1)
    noise = rng.integers(-20, 21, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def write_jpeg(path: str, frame: np.ndarray, mode: str = "RGB") -> None:
    img = Image.fromarray(frame)
    if mode == "L":
        img = img.convert("L")
    img.save(path, quality=95)


def write_fixtures(out_dir: str) -> dict:
    """Write the fixture JPEGs, their manifest (each frame's shape, its
    decode's sha256 and the libjpeg it was decoded with) and the smallest
    frame's decode as .npy."""
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    soname = pjpeg.libjpeg_soname()
    frames = []
    for seed, (name, h, w, mode) in enumerate(FIXTURE_FRAMES):
        path = os.path.join(out_dir, name)
        write_jpeg(path, fixture_frame(h, w, seed), mode)
        decoded = pjpeg.decode(path)
        frames.append({"file": name, "height": h, "width": w, "mode": mode,
                       "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest(),
                       "libjpeg": soname})
    smallest = min(FIXTURE_FRAMES, key=lambda f: f[1] * f[2])[0]
    npy = smallest.replace(".jpg", ".npy")
    np.save(os.path.join(out_dir, npy), pjpeg.decode(os.path.join(out_dir, smallest)))
    manifest = {"encoder": f"PIL {PIL.__version__}, quality 95", "frames": frames,
                "smallest": {"file": smallest, "decoded": npy}}
    with open(os.path.join(out_dir, "manifest.json"), "w") as fp:
        json.dump(manifest, fp, indent=1)
    return manifest


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """PIL-written JPEGs of the fixture shapes under a temporary directory,
    plus a truncated copy of one (a corrupt stream)."""
    root = tmp_path_factory.mktemp("jpegs")
    paths = {}
    for seed, (name, h, w, mode) in enumerate(FIXTURE_FRAMES):
        paths[name] = str(root / name)
        write_jpeg(paths[name], fixture_frame(h, w, 100 + seed), mode)
    with open(paths["rgb_24x32.jpg"], "rb") as fp:
        data = fp.read()
    paths["corrupt"] = str(root / "corrupt.jpg")
    with open(paths["corrupt"], "wb") as fp:
        fp.write(data[: len(data) // 2])
    return paths


@pytest.mark.parametrize("name", [f[0] for f in FIXTURE_FRAMES])
def test_decode_and_probe_equal_jax_bit_for_bit(jpegs, name):
    path = jpegs[name]
    assert pjpeg.probe(path) == jjpeg.probe(path)
    got = pjpeg.decode(path)
    assert got.dtype == np.uint8 and got.shape == jjpeg.decode(path).shape
    np.testing.assert_array_equal(got, jjpeg.decode(path))
    # the JAX package's fixtures are PIL-decoded: libjpeg here gives PIL's bits
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_decode_batch_zero_fills_like_jax(jpegs, tmp_path, n_threads):
    """None, a missing file, a corrupt stream and a frame of another size
    come back as zero frames, and n_decoded counts the rest, as JAX's."""
    paths = [jpegs["rgb_24x32.jpg"], None, str(tmp_path / "missing.jpg"), jpegs["corrupt"],
             jpegs["rgb_32x32.jpg"], jpegs["rgb_24x32.jpg"]]
    got, n_got = pjpeg.decode_batch(paths, 24, 32, n_threads=n_threads)
    want, n_want = jjpeg.decode_batch(paths, 24, 32, n_threads=n_threads)
    assert n_got == n_want == 2
    np.testing.assert_array_equal(got, want)
    assert not got[1:5].any()
    out = np.full((6, 24, 32, 3), 7, np.uint8)
    same, n_out = pjpeg.decode_batch(paths, 24, 32, out=out, n_threads=n_threads)
    assert same is out and n_out == 2
    np.testing.assert_array_equal(out, want)


def test_decode_batch_refuses_a_strided_out(jpegs):
    paths = [jpegs["rgb_24x32.jpg"]] * 2
    strided = np.zeros((4, 24, 32, 3), np.uint8)[::2]
    with pytest.raises(ValueError, match="C-contiguous"):
        pjpeg.decode_batch(paths, 24, 32, out=strided)
    with pytest.raises(AssertionError, match="C-contiguous"):
        jjpeg.decode_batch(paths, 24, 32, out=strided)
    with pytest.raises(ValueError, match="not uint8"):
        pjpeg.decode_batch(paths, 24, 32, out=np.zeros((2, 24, 31, 3), np.uint8))


def test_corrupt_and_missing_files_raise_like_jax(jpegs, tmp_path):
    for path in (jpegs["corrupt"], str(tmp_path / "missing.jpg")):
        for mod in (pjpeg, jjpeg):
            with pytest.raises(OSError):
                mod.decode(path)


def test_committed_fixtures_decode_to_their_manifest():
    """Every committed fixture decodes to the sha256 its manifest holds, with
    the libjpeg named there, and the smallest to its committed .npy; the
    directory stays under 1.5 MB."""
    with open(os.path.join(FIXTURES, "manifest.json")) as fp:
        manifest = json.load(fp)
    assert [f["file"] for f in manifest["frames"]] == [f[0] for f in FIXTURE_FRAMES]
    for f in manifest["frames"]:
        path = os.path.join(FIXTURES, f["file"])
        assert f["libjpeg"] == pjpeg.libjpeg_soname() == "libjpeg.so.62"
        decoded = pjpeg.decode(path)
        assert decoded.shape == (f["height"], f["width"], 3)
        assert hashlib.sha256(decoded.tobytes()).hexdigest() == f["decoded_sha256"], f["file"]
        np.testing.assert_array_equal(decoded, jjpeg.decode(path))
    small = manifest["smallest"]
    np.testing.assert_array_equal(
        pjpeg.decode(os.path.join(FIXTURES, small["file"])),
        np.load(os.path.join(FIXTURES, small["decoded"])))
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 1.5e6


def _fresh_build(monkeypatch, tmp_path, **settings):
    """Forget the built library; build into tmp_path with ``settings``."""
    for name, value in dict(_lib=None, _error=None, _route=None,
                            BUILD_DIR=tmp_path / "native", **settings).items():
        monkeypatch.setattr(pjpeg, name, value)


def test_without_the_system_libjpeg_the_bundled_one_builds(monkeypatch, tmp_path):
    """The system route fails to link; the decoder builds against the
    libjpeg Pillow bundles, with the committed 6.2 headers, and decodes the
    committed fixtures to their manifest's bits."""
    if pjpeg.bundled_libjpeg() is None:
        pytest.skip("this Pillow bundles no libjpeg")
    _fresh_build(monkeypatch, tmp_path, LDFLAGS=("-shared", "-lno_such_jpeg", "-lpthread"))
    assert pjpeg.available() and pjpeg.route().startswith("Pillow's")
    assert pjpeg.libjpeg_path() == str(pjpeg.bundled_libjpeg())
    assert pjpeg.libjpeg_soname() == "libjpeg.so.62"
    with open(os.path.join(FIXTURES, "manifest.json")) as fp:
        for f in json.load(fp)["frames"]:
            decoded = pjpeg.decode(os.path.join(FIXTURES, f["file"]))
            assert hashlib.sha256(decoded.tobytes()).hexdigest() == f["decoded_sha256"]


def test_a_failed_build_raises_for_native_and_auto_moves_on(monkeypatch, jpegs, tmp_path):
    """A compiler that cannot run: available() is False, get_decoder('native')
    and the predictor's lookup raise with every route's message, decode
    raises it too, and 'auto' takes the next decoder (cv2 here, else PIL),
    whose frames load_clip then decodes one by one."""
    _fresh_build(monkeypatch, tmp_path, CXX=str(tmp_path / "no-such-g++"))
    assert not pjpeg.available() and pjpeg.route() is None
    message = pjpeg.error()
    assert "did not build" in message and "no-such-g++" in message
    assert "against the system libjpeg" in message
    if pjpeg.bundled_libjpeg() is not None:
        assert "against Pillow's" in message
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        pframes.get_decoder("native")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        pjpeg.decode(jpegs["rgb_24x32.jpg"])
    auto = pframes.get_decoder("auto")
    try:
        import cv2  # noqa: F401
        assert auto is pframes._decode_cv2
    except ImportError:
        assert auto is pframes._decode_pil
    np.testing.assert_array_equal(auto(jpegs["rgb_24x32.jpg"]),
                                  jjpeg.decode(jpegs["rgb_24x32.jpg"]))


def test_a_failed_compile_keeps_the_compilers_output(monkeypatch, tmp_path):
    """A compiler that runs and fails: its own output is the message."""
    broken = tmp_path / "jpeg_decode.cpp"
    broken.write_text("#include <no_such_header.h>\n")
    _fresh_build(monkeypatch, tmp_path, SOURCE=broken)
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        pframes.get_decoder("native")
    assert not list((tmp_path / "native").glob("*"))  # no half-written library


if __name__ == "__main__":
    print(json.dumps(write_fixtures(sys.argv[1]), indent=1))
