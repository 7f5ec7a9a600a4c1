"""The port's native FFmpeg decoder (data/native_video.py over its own
csrc/videodecode.cpp and videoencode.cpp) against the JAX package's: JAX's
library is built from the repository's csrc/ sources with csrc/build.py's
command into the test's own directory and loaded through JAX's own
``NativeVideoLib(lib_path)``; nothing is built into csrc/.

Held bit for bit: probe, read_frames and read_frames_yuv (planes and
full_range) at JAX's seek times, read_frames_yuv_into, an encode_video
round trip, and the corrupt inputs of JAX's tests/test_data.py (both raise
OSError, or both decode a truncation's prefix alike). Also: "auto" takes
the native decoder here; a build whose compiler finds no FFmpeg headers
raises the one named error (NativeToolchainMissing), on
which "auto" takes opencv and "native" raises, while a compile error
raises RuntimeError through "auto" too; and the YUV route into the
tiny Detector (yuv420_to_rgb, then predict, f32 on the CPU) against JAX's
at atol = rtol = 1e-4.

The tests skip, with the reason, only where g++ or FFmpeg's headers or
libraries are missing.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu_torch.data import native_video as tnative
from dfd_clip_tpu_torch.data import video as tvideo

ROOT = Path(__file__).resolve().parent.parent
TIMES = [0.0, 0.04, 0.5, 1.02, 3.9]    # JAX's tests/test_data.py seek times
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the port's NativeVideoLib, JAX's NativeVideoLib on its own build)."""
    from dfd_clip_tpu.data.native_video import NativeVideoLib as JLib

    try:
        port = tnative.NativeVideoLib(str(tnative.build()))
    except tnative.NativeToolchainMissing as e:
        pytest.skip(f"the native decoder cannot be built here: {e}")
    out = tmp_path_factory.mktemp("jaxlib") / "libdfdvideo.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                    str(ROOT / "csrc" / "videodecode.cpp"), str(ROOT / "csrc" / "videoencode.cpp"),
                    "-o", str(out), "-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
                   check=True, capture_output=True)
    return port, JLib(str(out))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """JAX's fixture video: cv2-written MJPG, 100 frames at 25 fps, 48 px."""
    pytest.importorskip("cv2")
    from fixtures import write_video

    p = str(tmp_path_factory.mktemp("vid") / "v.avi")
    write_video(p, 100, fps=25.0, size=48, seed=3)
    return p


def test_probe_and_frames_bit_equal(libs, video):
    port, jaxlib = libs
    assert port.probe(video) == jaxlib.probe(video)
    fps, frames, _ = port.probe(video)
    meta = tvideo.OpenCVBackend().probe(video)
    assert fps == meta.fps and frames == meta.frames == 100
    got = port.read_frames(video, TIMES)
    assert got.shape == (len(TIMES), 48, 48, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jaxlib.read_frames(video, TIMES))
    np.testing.assert_array_equal(got, tvideo.OpenCVBackend().read_frames(video, TIMES))


def test_yuv_planes_bit_equal(libs, video):
    port, jaxlib = libs
    got, want = port.read_frames_yuv(video, TIMES), jaxlib.read_frames_yuv(video, TIMES)
    assert got[0].shape == (5, 48, 48) and got[1].shape == got[2].shape == (5, 24, 24)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_yuv_into_caller_buffers(libs, video):
    """Into contiguous buffers (here the .numpy() views of host tensors, as
    a card run passes pinned ones): the same planes; a buffer of another
    shape is refused before any decode."""
    port, _ = libs
    y, u, v, full = port.read_frames_yuv(video, TIMES)
    bufs = [torch.empty(a.shape, dtype=torch.uint8) for a in (y, u, v)]
    assert port.read_frames_yuv_into(video, TIMES, *(b.numpy() for b in bufs)) == full
    for b, a in zip(bufs, (y, u, v)):
        np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(ValueError, match="must be contiguous uint8"):
        port.read_frames_yuv_into(video, TIMES[:2], y, u, v)


def test_encode_round_trip(libs, tmp_path):
    """x264 at CRF 18 through the port's encoder: both decoders read the
    file alike, 50 frames at 25 fps, close to the source (JAX's round
    trip); the YUV planes of x264's output are limited range."""
    port, jaxlib = libs
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    frames = np.stack([
        np.clip(np.stack([150 + 50 * np.sin(6 * xx + f / 5), yy * 200,
                          np.full_like(yy, 80.0)], -1), 0, 255).astype(np.uint8)
        for f in range(50)])
    p = str(tmp_path / "x264.mp4")
    port.encode_video(p, frames, fps=25.0, crf=18, codec="libx264")
    assert port.probe(p) == jaxlib.probe(p)
    fps, n, _ = port.probe(p)
    assert n == 50 and abs(fps - 25.0) < 1.0
    dec = port.read_frames(p, [0.0, 1.0, 1.96])
    np.testing.assert_array_equal(dec, jaxlib.read_frames(p, [0.0, 1.0, 1.96]))
    assert np.abs(dec[0].astype(int) - frames[0].astype(int)).mean() < 6.0
    assert not port.read_frames_yuv(p, [0.0])[3]
    q = str(tmp_path / "jax.mp4")
    jaxlib.encode_video(q, frames, fps=25.0, crf=18, codec="libx264")
    np.testing.assert_array_equal(jaxlib.read_frames(q, [0.0, 1.96]),
                                  port.read_frames(q, [0.0, 1.96]))


def test_corrupt_inputs_raise_alike(libs, tmp_path):
    """JAX's corrupt inputs: a missing path, an empty file and random bytes
    raise OSError in both; a mid-file truncation either raises in both or
    decodes the same well-formed frames; seeks past either end raise; an
    empty request is well-defined."""
    pytest.importorskip("cv2")
    from fixtures import write_video

    port, jaxlib = libs
    ok = str(tmp_path / "ok.avi")
    write_video(ok, 20, fps=10.0, size=32, seed=0)
    bad = [str(tmp_path / "nope.avi"), str(tmp_path / "empty.avi"), str(tmp_path / "garbage.avi")]
    open(bad[1], "wb").close()
    Path(bad[2]).write_bytes(bytes(range(256)) * 16)
    for lib in (port, jaxlib):
        for path in bad:
            with pytest.raises(OSError):
                lib.probe(path)
            with pytest.raises(OSError):
                lib.read_frames(path, [0.0, 0.5])
        for times in ([-1.0], [100.0]):
            with pytest.raises(OSError):
                lib.read_frames(ok, times)
        assert lib.read_frames(ok, []).shape[0] == 0
    trunc = str(tmp_path / "trunc.avi")
    data = Path(ok).read_bytes()
    Path(trunc).write_bytes(data[: len(data) // 3])
    for times in ([0.0, 0.5], [1.9], [0.0, 0.5, 1.0, 1.5, 1.9]):
        outcome = []
        for lib in (port, jaxlib):
            try:
                outcome.append(lib.read_frames(trunc, times))
            except OSError:
                outcome.append(None)
        if outcome[0] is None or outcome[1] is None:
            assert outcome[0] is None and outcome[1] is None, times
        else:
            assert outcome[0].shape == (len(times), 32, 32, 3)
            np.testing.assert_array_equal(outcome[0], outcome[1])


def test_auto_takes_native(libs, monkeypatch):
    monkeypatch.setattr(tvideo, "_BACKENDS", {})
    assert isinstance(tvideo.get_backend("auto"), tvideo.NativeBackend)
    assert tvideo.backend_name("auto") == "NativeBackend"


def test_missing_headers_named_error(libs, tmp_path, monkeypatch):
    """A compiler whose include directories hold no FFmpeg headers: build
    raises NativeToolchainMissing, "native" raises it, "auto" takes
    opencv."""
    monkeypatch.setattr(tnative, "include_dirs", lambda cxx: [tmp_path / "no_headers"])
    with pytest.raises(tnative.NativeToolchainMissing, match="headers"):
        tnative.build()
    monkeypatch.setattr(tnative.NativeVideoLib, "_instance", None)
    monkeypatch.setattr(tvideo, "_BACKENDS", {})
    with pytest.raises(tnative.NativeToolchainMissing):
        tvideo.get_backend("native")
    assert isinstance(tvideo.get_backend("auto"), tvideo.OpenCVBackend)
    assert tvideo.backend_name("auto") == "OpenCVBackend"


def test_compile_error_is_not_a_missing_toolchain(libs, tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError with g++'s
    message, through "auto" as well: only a missing toolchain falls back."""
    broken = tmp_path / "csrc"
    broken.mkdir()
    for s in tnative.SOURCES:
        shutil.copy(tnative.CSRC / s, broken / s)
    with open(broken / "videodecode.cpp", "a") as f:
        f.write("\nint dfd_broken( {\n")
    monkeypatch.setattr(tnative, "CSRC", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.NativeVideoLib, "_instance", None)
    monkeypatch.setattr(tvideo, "_BACKENDS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tvideo.get_backend("auto")
    assert "dfd_broken" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_yuv_route_into_predict_matches_jax(libs, video):
    """Eight frames' YUV planes from the port's decoder through the port's
    yuv420_to_rgb and the tiny Detector's predict (f32, CPU) against JAX's
    yuv420_to_rgb and predict on the same planes and weights."""
    from dfd_clip_tpu.ops.image_ops import yuv420_to_rgb as jyuv
    from dfd_clip_tpu_torch.models import weights as tweights
    from dfd_clip_tpu_torch.ops.image_ops import yuv420_to_rgb as tyuv
    from test_torch_port_model import tiny_port_detector

    from fixtures import tiny_detector

    port, _ = libs
    y, u, v, full = port.read_frames_yuv(video, [0.0, 0.04, 0.5, 1.02, 1.5, 2.0, 3.0, 3.9])
    jrgb = np.asarray(jyuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), full))
    trgb = tyuv(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v), full)
    jdet, tdet = tiny_detector(num_frames=4), tiny_port_detector(num_frames=4)
    jparams = jdet.init_params(jax.random.key(2))
    tparams = tdet.prepare_params(tweights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    m = np.ones((2, 4), bool)
    want = np.asarray(jdet.predict(jparams, jnp.asarray(jrgb.reshape(2, 4, 3, 48, 48)),
                                   jnp.asarray(m))[0][0])
    got = tdet.predict(tparams, trgb.reshape(2, 4, 3, 48, 48), torch.from_numpy(m))[0][0]
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
