"""CLIP's zero-shot surface in the port against the JAX package, on the
CPU: the tokenizer (ids equal, with ``regex`` and with the stdlib
fallback forced on both sides), the text tower (Text-Test), the pooled
image features (a converter-loaded ViT-Test tree with ln_post / proj),
zero_shot_logits, the ResNet tower (RN-Test, f32 and bf16), the four
converters and the carry-across (leaf for leaf equal) on synthetic
torch-format state dicts, and a reference-decoder checkpoint converted by
both packages and run through both decoders. Inputs come from numpy seeds;
f32 at atol = rtol = 1e-4 unless a test says otherwise.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.data import tokenizer as jtok
from dfd_clip_tpu.models import clip_resnet as jrn
from dfd_clip_tpu.models import clip_text as jtext
from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.models import decoder as jdec
from dfd_clip_tpu.models import weights as jweights
from dfd_clip_tpu_torch.data import tokenizer as ttok
from dfd_clip_tpu_torch.models import clip_resnet as trn
from dfd_clip_tpu_torch.models import clip_text as ttext
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models import decoder as tdec
from dfd_clip_tpu_torch.models import weights as tweights

TOL = dict(rtol=1e-4, atol=1e-4)

PROMPTS = [
    "a photo of a real face.",
    "A DEEPFAKE video, generated by FaceSwap!!!",
    "it's a café in Zürich — naïve façade 🙂",
    "don't   we'll they've I'm  you'd; 3.14159 x 42 = ?",
    "&amp;lt;html&amp;gt; tags &quot;quoted&quot;",
    "日本語のテキスト and ελληνικά",
]
SYNTHETIC_MERGES = [("a", "b"), ("ab", "c</w>"), ("h", "e"), ("l", "l"), ("he", "ll"),
                    ("hell", "o</w>"), ("t", "h"), ("th", "e</w>")]


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, want):
    """Same paths, same shapes and dtypes' values, leaf for leaf exactly."""
    g, gdef = jax.tree_util.tree_flatten_with_path(numpy_tree(got))
    w, wdef = jax.tree_util.tree_flatten_with_path(numpy_tree(want))
    assert gdef == wdef
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# -- the tokenizer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped():
    return jtok.ClipTokenizer(), ttok.ClipTokenizer()


@pytest.fixture(params=["regex", "re"])
def splitter(request, monkeypatch):
    """The word splitter on both sides: ``regex``, or the stdlib fallback
    (``regex`` made unimportable and both pattern caches cleared)."""
    if request.param == "re":
        monkeypatch.setitem(sys.modules, "regex", None)
    jtok._word_pattern.cache_clear()
    ttok._word_pattern.cache_clear()
    yield request.param
    jtok._word_pattern.cache_clear()
    ttok._word_pattern.cache_clear()


def test_tokenize_shipped_table_matches_jax(shipped, splitter):
    jt, tt = shipped
    assert tt.vocab_size == jt.vocab_size == 49408 and tt.eot == jt.eot
    want = jtok.tokenize(PROMPTS, jt)
    got = ttok.tokenize(PROMPTS, tt)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert (got.argmax(-1) == (got == tt.eot).argmax(-1)).all()   # EOT at each row's argmax
    assert (got[:, 0] == tt.sot).all()
    for p in PROMPTS[:2]:
        assert tt.decode(tt.encode(p)) == jt.decode(jt.encode(p))


def test_tokenize_synthetic_merges_match_jax(splitter):
    jt = jtok.ClipTokenizer(merges=SYNTHETIC_MERGES)
    tt = ttok.ClipTokenizer(merges=SYNTHETIC_MERGES)
    assert tt.vocab_size == jt.vocab_size == 512 + len(SYNTHETIC_MERGES) + 2
    texts = ["abc hello the", "hello, hello!! abcabc", "the thé ab"]
    np.testing.assert_array_equal(ttok.tokenize(texts, tt, context_length=16),
                                  jtok.tokenize(texts, jt, context_length=16))


def test_tokenize_truncation_matches_jax(shipped, splitter):
    jt, tt = shipped
    long = " ".join(PROMPTS)
    got = ttok.tokenize(long, tt, context_length=12, truncate=True)
    np.testing.assert_array_equal(got, jtok.tokenize(long, jt, context_length=12,
                                                     truncate=True))
    assert got[0, -1] == tt.eot
    for tokenize, tok in ((ttok.tokenize, tt), (jtok.tokenize, jt)):
        with pytest.raises(ValueError, match="truncate=True"):
            tokenize(long, tok, context_length=12)


def test_default_table_is_beside_the_package():
    assert ttok.DEFAULT_BPE_PATH.is_file()
    assert ttok.load_merges() == jtok.load_merges(jtok.DEFAULT_BPE_PATH)


# -- the text tower -------------------------------------------------------------------

def random_tokens(rng, cfg, n=3):
    """Prompts of varied length: ids below EOT, EOT (the largest id), zeros."""
    toks = np.zeros((n, cfg.context_length), np.int32)
    for r, length in enumerate(rng.integers(2, cfg.context_length, n)):
        toks[r, :length - 1] = rng.integers(1, cfg.vocab_size - 1, length - 1)
        toks[r, length - 1] = cfg.vocab_size - 1
    return toks


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_clip_text_encode_matches_jax(rng, causal, normalize):
    cfg = jtext.ARCHITECTURES["Text-Test"]
    params = jtext.init_clip_text(jax.random.key(1), cfg)
    toks = random_tokens(rng, cfg)
    want = jtext.clip_text_encode(params, jnp.asarray(toks), cfg, normalize=normalize,
                                  causal=causal)
    tparams = tweights.params_from_jax(numpy_tree(params))
    assert isinstance(tparams["blocks"], list) and len(tparams["blocks"]) == cfg.layers
    got = ttext.clip_text_encode(tparams, torch.from_numpy(toks),
                                 ttext.ARCHITECTURES["Text-Test"], normalize=normalize,
                                 causal=causal)
    assert got.shape == (3, cfg.embed_dim)
    close(got, want)


def test_text_architectures_match_jax():
    """The configs equal JAX's; the port's init has the carried-across JAX
    init's leaves and shapes."""
    assert {k: dataclasses.asdict(v) for k, v in ttext.ARCHITECTURES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jtext.ARCHITECTURES.items()}
    cfg = ttext.ARCHITECTURES["Text-Test"]
    params = ttext.init_clip_text(torch.Generator().manual_seed(0), cfg)
    jparams = tweights.clip_text_from_jax(numpy_tree(
        jtext.init_clip_text(jax.random.key(0), jtext.ARCHITECTURES["Text-Test"])))
    assert len(params["blocks"]) == cfg.layers
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), jparams)


# -- synthetic torch-format state dicts -------------------------------------------------

def block_sd(rng, prefix, width):
    return {
        f"{prefix}.attn.in_proj_weight": rng.standard_normal((3 * width, width)),
        f"{prefix}.attn.in_proj_bias": rng.standard_normal(3 * width),
        f"{prefix}.attn.out_proj.weight": rng.standard_normal((width, width)),
        f"{prefix}.attn.out_proj.bias": rng.standard_normal(width),
        f"{prefix}.ln_1.weight": 1 + 0.1 * rng.standard_normal(width),
        f"{prefix}.ln_1.bias": rng.standard_normal(width),
        f"{prefix}.mlp.c_fc.weight": rng.standard_normal((4 * width, width)),
        f"{prefix}.mlp.c_fc.bias": rng.standard_normal(4 * width),
        f"{prefix}.mlp.c_proj.weight": rng.standard_normal((width, 4 * width)),
        f"{prefix}.mlp.c_proj.bias": rng.standard_normal(width),
        f"{prefix}.ln_2.weight": 1 + 0.1 * rng.standard_normal(width),
        f"{prefix}.ln_2.bias": rng.standard_normal(width),
    }


def f32(sd):
    return {k: (0.1 * np.asarray(v)).astype(np.float32) if "ln_" not in k or "bias" in k
            else np.asarray(v, np.float32) for k, v in sd.items()}


def vit_sd(rng, cfg, prefix="visual."):
    w, p = cfg.width, cfg.patch_size
    sd = {f"{prefix}conv1.weight": rng.standard_normal((w, 3, p, p)),
          f"{prefix}class_embedding": rng.standard_normal(w),
          f"{prefix}positional_embedding": rng.standard_normal((cfg.num_tokens, w)),
          f"{prefix}ln_pre.weight": 1 + 0.1 * rng.standard_normal(w),
          f"{prefix}ln_pre.bias": rng.standard_normal(w),
          f"{prefix}ln_post.weight": 1 + 0.1 * rng.standard_normal(w),
          f"{prefix}ln_post.bias": rng.standard_normal(w),
          f"{prefix}proj": rng.standard_normal((w, cfg.output_dim))}
    for i in range(cfg.layers):
        sd.update(block_sd(rng, f"{prefix}transformer.resblocks.{i}", w))
    return f32(sd)


def text_sd(rng, cfg, with_scale=True):
    w = cfg.width
    sd = {"token_embedding.weight": rng.standard_normal((cfg.vocab_size, w)),
          "positional_embedding": rng.standard_normal((cfg.context_length, w)),
          "ln_final.weight": 1 + 0.1 * rng.standard_normal(w),
          "ln_final.bias": rng.standard_normal(w),
          "text_projection": rng.standard_normal((w, cfg.embed_dim))}
    for i in range(cfg.layers):
        sd.update(block_sd(rng, f"transformer.resblocks.{i}", w))
    sd = f32(sd)
    if with_scale:
        sd["logit_scale"] = np.asarray(4.0, np.float32)
    return sd


def resnet_sd(rng, cfg, prefix="visual."):
    """ModifiedResNet's state dict names and OIHW / (out, in) layouts, with
    BN running statistics away from (0, 1)."""
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = rng.standard_normal((cout, cin, k, k)) * (cin * k * k) ** -0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * rng.standard_normal(c)
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.running_mean"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7.0)

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv(f"{prefix}conv{i}", cin, cout, 3)
        bn(f"{prefix}bn{i}", cout)
    cin = w
    for s, blocks in enumerate(cfg.layers, 1):
        planes = w * 2 ** (s - 1)
        for b in range(blocks):
            base = f"{prefix}layer{s}.{b}"
            conv(f"{base}.conv1", cin, planes, 1)
            bn(f"{base}.bn1", planes)
            conv(f"{base}.conv2", planes, planes, 3)
            bn(f"{base}.bn2", planes)
            conv(f"{base}.conv3", planes, planes * 4, 1)
            bn(f"{base}.bn3", planes * 4)
            if b == 0:
                conv(f"{base}.downsample.0", cin, planes * 4, 1)
                bn(f"{base}.downsample.1", planes * 4)
            cin = planes * 4
    c = cfg.embed_dim
    ap = f"{prefix}attnpool"
    sd[f"{ap}.positional_embedding"] = rng.standard_normal((cfg.spacial_dim ** 2 + 1, c)) \
        * c ** -0.5
    for name, out in (("q_proj", c), ("k_proj", c), ("v_proj", c), ("c_proj", cfg.output_dim)):
        sd[f"{ap}.{name}.weight"] = rng.standard_normal((out, c)) * c ** -0.5
        sd[f"{ap}.{name}.bias"] = 0.1 * rng.standard_normal(out)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def decoder_sd(rng, cfg):
    """The reference Decoder's state dict: dual in_proj (2W, W), per-block
    augment_query, task projections proj{t}x{dim}[_L{layer}]."""
    w = cfg.width
    sd = {"class_embedding": rng.standard_normal(w),
          "ln_pre.weight": 1 + 0.1 * rng.standard_normal(w), "ln_pre.bias": rng.standard_normal(w),
          "ln_post.weight": 1 + 0.1 * rng.standard_normal(w),
          "ln_post.bias": rng.standard_normal(w),
          "positional_embedding": rng.standard_normal((cfg.num_frames, 1, cfg.heads,
                                                       cfg.head_dim))}
    for i in range(cfg.num_blocks):
        b = f"transformer.resblocks.{i}"
        sd.update(block_sd(rng, b, w))
        del sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"]
        sd[f"{b}.attn.in_proj.weight"] = rng.standard_normal((2 * w, w))
        sd[f"{b}.attn.in_proj.bias"] = rng.standard_normal(2 * w)
    for i in range(cfg.num_blocks - 1):
        sd[f"transformer.augment_query_{i}"] = rng.standard_normal(w)
    for t, dim in enumerate(cfg.out_dims):
        for layer in cfg.layer_indices:
            sd[f"proj{t}x{dim}_L{layer}"] = rng.standard_normal((w, dim))
        sd[f"proj{t}x{dim}"] = rng.standard_normal((w, dim))
    return f32(sd)


# -- the converters and the carry-across ------------------------------------------------

@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_resnet_converter_matches_jax(rng, prefix):
    cfg = jrn.ARCHITECTURES["RN-Test"]
    sd = resnet_sd(rng, cfg, prefix)
    assert_trees_equal(tweights.convert_clip_resnet(sd), jweights.convert_clip_resnet(sd))
    got, want = tweights.infer_clip_resnet_config(sd), jweights.infer_clip_resnet_config(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) == \
        dataclasses.asdict(trn.ARCHITECTURES["RN-Test"])


@pytest.mark.parametrize("with_scale", [True, False])
def test_text_converter_matches_jax(rng, with_scale):
    cfg = jtext.ARCHITECTURES["Text-Test"]
    sd = text_sd(rng, cfg, with_scale)
    assert_trees_equal(tweights.convert_clip_text(sd), jweights.convert_clip_text(sd))


@pytest.mark.parametrize("global_prediction", [False, True])
@pytest.mark.parametrize("aug_query", [False, True])
def test_reference_decoder_converter_matches_jax(rng, global_prediction, aug_query):
    cfg = jdec.DecoderConfig(width=128, heads=2, num_frames=3, layer_indices=(0, 2),
                             out_dims=(2, 3), global_prediction=global_prediction,
                             aug_query=aug_query)
    sd = decoder_sd(rng, cfg)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    assert_trees_equal(tweights.convert_reference_decoder(sd, tcfg),
                       jweights.convert_reference_decoder(sd, cfg))


def test_carry_across_text_and_resnet_trees():
    """params_from_jax on JAX's clip_text tree (stacked blocks -> a list) and
    clip_resnet tree (HWIO -> OIHW), leaf for leaf."""
    jt = numpy_tree(jtext.init_clip_text(jax.random.key(2), jtext.ARCHITECTURES["Text-Test"]))
    tt = tweights.params_from_jax(jt)
    for i, blk in enumerate(tt["blocks"]):
        assert_trees_equal(jax.tree_util.tree_map(lambda t: t.numpy(), blk),
                           jax.tree_util.tree_map(lambda a: a[i], jt["blocks"]))
    assert_trees_equal({k: v.numpy() for k, v in tt.items() if torch.is_tensor(v)},
                       {k: v for k, v in jt.items() if not isinstance(v, dict)})
    jr = numpy_tree(jrn.init_clip_resnet(jax.random.key(3), jrn.ARCHITECTURES["RN-Test"]))
    tr = tweights.params_from_jax(jr)
    np.testing.assert_array_equal(tr["stem"]["conv1"]["w"].numpy(),
                                  jr["stem"]["conv1"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tr["layer2"][0]["downsample"]["conv"]["w"].numpy(),
                                  jr["layer2"][0]["downsample"]["conv"]["w"].transpose(3, 2, 0, 1))
    assert_trees_equal(jax.tree_util.tree_map(lambda t: t.numpy(), tr["attnpool"]),
                       jr["attnpool"])
    assert_trees_equal(jax.tree_util.tree_map(lambda t: t.numpy(), tr["layer1"][0]["bn1"]),
                       jr["layer1"][0]["bn1"])


# -- the image towers and the zero-shot logits ------------------------------------------

def test_clip_vision_features_matches_jax(rng):
    cfg = jvit.ARCHITECTURES["ViT-Test"]
    sd = vit_sd(rng, cfg)
    jparams = jweights.convert_clip_visual(sd, jweights.infer_clip_vit_config(sd))
    tparams = tweights.params_from_jax(tweights.convert_clip_visual(
        sd, tweights.infer_clip_vit_config(sd)))
    assert "ln_post" in tparams and "proj" in tparams
    x = rng.standard_normal((3, 3, cfg.input_resolution, cfg.input_resolution)
                            ).astype(np.float32)
    for normalize in (False, True):
        want = jtext.clip_vision_features(jparams, jnp.asarray(x), cfg, normalize=normalize)
        got = ttext.clip_vision_features(tparams, torch.from_numpy(x),
                                         tvit.ARCHITECTURES["ViT-Test"], normalize=normalize)
        assert got.shape == (3, cfg.output_dim)
        close(got, want)


def test_zero_shot_logits_match_jax(rng):
    img = rng.standard_normal((4, 16)).astype(np.float32)
    txt = rng.standard_normal((5, 16)).astype(np.float32)
    want = jtext.zero_shot_logits(jnp.asarray(img), jnp.asarray(txt), jnp.float32(2.6592))
    got = ttext.zero_shot_logits(torch.from_numpy(img), torch.from_numpy(txt),
                                 torch.tensor(2.6592))
    assert got.shape == (4, 5)
    close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_resnet_features_match_jax(rng, dtype):
    """A converted RN-Test checkpoint (BN running statistics away from 0 and
    1) through both towers: f32 at 1e-4, bf16 at 1e-2 of the max."""
    cfg = jrn.ARCHITECTURES["RN-Test"]
    sd = resnet_sd(rng, cfg)
    jparams = jweights.convert_clip_resnet(sd)
    tparams = tweights.params_from_jax(tweights.convert_clip_resnet(sd))
    x = rng.standard_normal((2, 3, cfg.input_resolution, cfg.input_resolution)
                            ).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jrn.clip_resnet_features(jparams, jnp.asarray(x), cfg, jdt), np.float32)
    got = trn.clip_resnet_features(tparams, torch.from_numpy(x), trn.ARCHITECTURES["RN-Test"],
                                   tdt)
    assert got.shape == (2, cfg.output_dim) and got.dtype == tdt
    if dtype == "f32":
        close(got, want)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err


def test_init_clip_resnet_shapes_match_jax():
    cfg = trn.ARCHITECTURES["RN-Test"]
    got = trn.init_clip_resnet(torch.Generator().manual_seed(0), cfg)
    want = tweights.params_from_jax(numpy_tree(jrn.init_clip_resnet(jax.random.key(0), cfg)))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), want)
    out = trn.clip_resnet_features(got, torch.zeros(2, 3, 32, 32), cfg, torch.float32)
    assert out.shape == (2, cfg.output_dim) and torch.isfinite(out).all()


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_reference_decoder_checkpoint_runs_like_jax(rng, monkeypatch, reference):
    """A reference-decoder checkpoint, converted by each package, through
    each package's decoder on the same K/V (one sample with a masked frame)."""
    monkeypatch.setenv("DFD_ATTENTION_BACKEND", reference)
    monkeypatch.setenv("DFD_DEC_STACK", "force" if reference == "pallas" else "0")
    cfg = jdec.DecoderConfig(width=128, heads=2, num_frames=3, layer_indices=(0, 2),
                             out_dims=(2, 3), aug_query=True)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    sd = decoder_sd(rng, cfg)
    kvs = {s: rng.standard_normal((2, 2, 3, 4, 2, 64)).astype(np.float32) for s in ("k", "v")}
    m = np.array([[True, True, True], [True, True, False]])
    want_logits, want_feat = jdec.apply_decoder(
        jax.tree_util.tree_map(jnp.asarray, jweights.convert_reference_decoder(sd, cfg)),
        {s: jnp.asarray(a) for s, a in kvs.items()}, jnp.asarray(m), cfg)
    got_logits, got_feat = tdec.apply_decoder(
        tweights.params_from_jax(tweights.convert_reference_decoder(sd, tcfg)),
        {s: torch.from_numpy(a) for s, a in kvs.items()}, torch.from_numpy(m), tcfg)
    close(got_feat, want_feat)
    assert len(got_logits) == 2
    for g, w in zip(got_logits, want_logits):
        close(g, w)
