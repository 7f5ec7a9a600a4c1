"""The port's augmentation engine (dfd_clip_tpu_torch/data/augment.py) and
FFPP's training items against the JAX package, on the CPU: each
ClipAugmenter spec and the ssl_fake forgery from the same
np.random.Generator on the same uint8 frames, the replay reused for a
raw/c23 pair, and FFPP training datasets with ``normal+frame`` (and with
``ssl_fake``) on a cv2-written fixture tree, item by item and collated.

Tolerance: byte-equal (the same numpy and cv2 operations in the same order
on the same draws). Each dataset test chdirs into its tmp_path: the
video-table cache is CWD-relative.
"""

import numpy as np
import pytest

from dfd_clip_tpu.data import augment as jaug
from dfd_clip_tpu.data import datasets as jds
from dfd_clip_tpu_torch.data import augment as taug
from dfd_clip_tpu_torch.data import datasets as tds

from fixtures import make_ffpp_tree

SPECS = ["normal", "frame", "normal+frame", "dev-mode+force-rgb", "dev-mode+force-hue",
         "dev-mode+force-bright", "none"]


def frames(rng, t=6, size=48):
    return rng.integers(0, 256, (t, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("spec", SPECS)
def test_clip_augmenter_byte_equal(spec):
    """Five draws of each spec on fresh frames: the same bytes and the same
    replay record; a second clip through the first clip's replay (the raw /
    c23 pair) too, with no further draws."""
    src = np.random.default_rng(0)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jaugm, taugm = jaug.ClipAugmenter(spec), taug.ClipAugmenter(spec)
    for _ in range(5):
        x, pair = frames(src), frames(src)
        want, jreplay = jaugm(x, {}, jr)
        got, treplay = taugm(x, {}, tr)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert repr(treplay) == repr(jreplay)
        state = tr.bit_generator.state
        got2, _ = taugm(pair, treplay, tr)
        want2, _ = jaugm(pair, jreplay, jr)
        assert np.array_equal(got2, want2)
        assert tr.bit_generator.state == state      # the replay draws nothing
    assert jr.bit_generator.state == tr.bit_generator.state


def test_ssl_fake_and_unknown_specs():
    """The ssl_fake elastic forgery byte-equal from the same draw; specs
    the engine does not know raise in both packages."""
    src, jr, tr = (np.random.default_rng(s) for s in (1, 6, 6))
    x = frames(src, t=3)
    jp, tp = jaug.ssl_fake_pipeline(), taug.ssl_fake_pipeline()
    jrep, trep = jp.sample(jr), tp.sample(tr)
    assert jrep == trep
    for f in x:
        assert np.array_equal(tp.apply(f, trep), jp.apply(f, jrep))
    for spec in ("dev-mode", "bogus"):
        for mod in (jaug, taug):
            with pytest.raises(NotImplementedError):
                mod.ClipAugmenter(spec)


@pytest.fixture(scope="module")
def ffpp_tree(tmp_path_factory):
    return make_ffpp_tree(str(tmp_path_factory.mktemp("trees") / "ffpp"),
                          types=("REAL", "DF"), compressions=("raw", "c23"))


def dataset_cfg(cls, root, **over):
    cfg = cls.get_default_config()
    cfg.root_dir = root
    cfg.types = ["REAL", "DF"]
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


CASES = {
    # the flagship recipe's training set: contrast pairs through normal+frame
    "normal+frame_contrast": dict(augmentation="normal+frame", contrast=1),
    # both compressions of a clip through one replay
    "normal+frame_pair": dict(augmentation="normal+frame", compressions=["raw", "c23"], pair=1),
    "ssl_fake": dict(augmentation="normal", contrast=1, ssl_fake=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ffpp_training_items_equal_jax(tmp_path, monkeypatch, ffpp_tree, case):
    """Every item of an FFPP training set (and a collated batch of three)
    equals JAX's, augmentation included."""
    monkeypatch.setenv("DFD_VIDEO_BACKEND", "opencv")
    made = {}
    for pkg, mod, extra in (("jax", jds, {}), ("port", tds, {"video_backend": "opencv"})):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        made[pkg] = mod.FFPP(dataset_cfg(mod.FFPP, ffpp_tree, **CASES[case]), 4, 1.0,
                             split="train", index=0, seed=2, **extra)
    got, want = made["port"], made["jax"]
    assert len(got) == len(want) > 0
    items = []
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, list) and b and isinstance(b[0], dict):    # contrast clips
                for ga, wb in zip(a, b):
                    assert sorted(ga) == sorted(wb)
                    for comp in wb:
                        assert np.array_equal(ga[comp], wb[comp])
            elif isinstance(b, dict):
                for comp in b:
                    assert np.array_equal(a[comp], b[comp])
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b))
        items.append(g)
    batch_g, batch_w = got.collate_fn(items[:3]), want.collate_fn(items[:3])
    for a, b in zip(batch_g, batch_w):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the augmentation did change the frames (against the same clip unaugmented)
    plain = tds.FFPP(dataset_cfg(tds.FFPP, ffpp_tree, **{**CASES[case], "augmentation": "none",
                                                          "ssl_fake": 0}),
                     4, 1.0, split="train", index=0, seed=2, video_backend="opencv")
    assert not all(np.array_equal(a, b) for a, b in
                   zip(got.collate_fn(items[:3])[0], plain.collate_fn(
                       [plain[i] for i in range(3)])[0]))
