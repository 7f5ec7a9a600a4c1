"""The PyTorch port's operators (dfd_clip_tpu_torch, plain versions on the
CPU) against the JAX package: its XLA composition and its Pallas kernels in
interpret mode.

Tolerance: atol = rtol = 1e-4 in float32. Both sides compute in f32 (the
JAX matmul precision is "highest" in conftest), so what remains is summation
order; nothing here is a bf16 comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import layers as jlayers
from dfd_clip_tpu.ops import image_ops as jimage
from dfd_clip_tpu.ops.attention import encoder_self_attention_qkv
from dfd_clip_tpu.ops.decoder_attention import dual_activation_attention as jdual
from dfd_clip_tpu.ops.pallas_attention import (
    fused_encoder_attn_block as j_attn_block,
    fused_encoder_mlp_block as j_mlp_block,
)
from dfd_clip_tpu.ops.pallas_decoder_attention import fused_decoder_attention as j_fused_dec
from dfd_clip_tpu.ops.pallas_decoder_stack import decoder_boundary as j_boundary
from dfd_clip_tpu_torch.models import layers as tlayers
from dfd_clip_tpu_torch.models.decoder import token_mask
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import image_ops as timage
from dfd_clip_tpu_torch.ops.decoder_stack import decoder_boundary
from dfd_clip_tpu_torch.ops.encoder_block import (
    fused_encoder_attn_block,
    fused_encoder_mlp_block,
)
from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention

TOL = dict(rtol=1e-4, atol=1e-4)
# (width, heads): ViT-Test (head_dim 16) and ViT-Test-Wide (head_dim 64)
GEOMETRIES = [(64, 4), (256, 4)]


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


def ln_params(rng, w):
    return {"scale": (1 + 0.3 * rng.standard_normal(w)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(w)).astype(np.float32)}


def lin_params(rng, i, o):
    return {"w": (i ** -0.5 * rng.standard_normal((i, o))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    return params_from_jax(tree)


# -- weights ----------------------------------------------------------------------

def test_params_from_jax_round_trips_every_leaf():
    """Every leaf of the JAX tiny_detector params reaches the port unchanged,
    up to the documented layout moves (conv1 HWIO -> OIHW, stacked encoder
    blocks -> a per-layer list)."""
    from fixtures import tiny_detector

    det = tiny_detector()
    ref = jax.tree_util.tree_map(np.asarray, det.init_params(jax.random.key(0)))
    port = params_from_jax(ref)
    enc, penc = ref["encoder"], port["encoder"]
    np.testing.assert_array_equal(penc["conv1"]["w"].permute(2, 3, 1, 0).numpy(),
                                  enc["conv1"]["w"])
    n_layers = enc["blocks"]["ln_1"]["scale"].shape[0]
    assert len(penc["blocks"]) == n_layers
    restacked = jax.tree_util.tree_map(lambda *xs: np.stack([x.numpy() for x in xs]),
                                       *penc["blocks"])
    checked = 0
    for a, b in zip(jax.tree_util.tree_leaves(restacked),
                    jax.tree_util.tree_leaves(enc["blocks"])):
        np.testing.assert_array_equal(a, b)
        checked += 1
    for key in ("class_embedding", "positional_embedding"):
        np.testing.assert_array_equal(penc[key].numpy(), enc[key])
    rest = {k: v for k, v in ref.items() if k != "encoder"}
    prest = {k: v for k, v in port.items() if k != "encoder"}
    ref_leaves = jax.tree_util.tree_leaves(rest)
    port_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), prest))
    assert len(ref_leaves) == len(port_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    assert checked == len(jax.tree_util.tree_leaves(enc["blocks"]))


# -- layers -----------------------------------------------------------------------

def test_layers_match_jax(rng):
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    ln = ln_params(rng, 64)
    lin = lin_params(rng, 64, 48)
    close(tlayers.layer_norm(th(ln), torch.from_numpy(x)), jlayers.layer_norm(jx(ln), x))
    close(tlayers.quick_gelu(torch.from_numpy(x)), jlayers.quick_gelu(jnp.asarray(x)))
    close(tlayers.linear(th(lin), torch.from_numpy(x)), jlayers.linear(jx(lin), jnp.asarray(x)))


# -- image ops --------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 80), (24, 20), (32, 32)],
                         ids=["downscale", "upscale", "identity"])
def test_resize_crop_normalize_matches_jax(rng, hw):
    x = rng.integers(0, 256, (2, 3) + hw, dtype=np.uint8)
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    got = timage.resize_crop_normalize(torch.from_numpy(x), 32, mean, std)
    want = jimage.resize_crop_normalize(jnp.asarray(x), 32, mean, std)
    assert tuple(got.shape) == want.shape == (2, 3, 32, 32)
    close(got, want)


@pytest.mark.parametrize("sizes", [(80, 32), (20, 32), (224, 224)])
def test_bicubic_matrix_equals_jax(sizes):
    np.testing.assert_array_equal(timage._bicubic_matrix(*sizes), jimage._bicubic_matrix(*sizes))


# -- encoder blocks ---------------------------------------------------------------

def attn_inputs(rng, w, n=4, t=14):
    h = rng.standard_normal((n, t, w)).astype(np.float32)
    return h, ln_params(rng, w), {"in_proj": lin_params(rng, w, 3 * w),
                                  "out_proj": lin_params(rng, w, w)}


def xla_attn_block(h, ln, attn, heads, hd, lo, pad):
    """The JAX package's XLA composition of the attention half."""
    w = h.shape[-1]
    y = jlayers.layer_norm(ln, h)
    qkv = jlayers.linear(attn["in_proj"], y)
    ho = h + jlayers.linear(attn["out_proj"], encoder_self_attention_qkv(qkv, heads, hd))
    padw = ((0, 0), (0, pad), (0, 0))
    return ho, jnp.pad(qkv[:, lo:, w: 2 * w], padw), jnp.pad(qkv[:, lo:, 2 * w:], padw)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["plain", "export", "stacked", "last_only"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["d16", "d64"])
def test_fused_encoder_attn_block_matches_jax(rng, reference, mode, geometry):
    """Four modes: plain; export (CLS kept, unpadded); stacked export_into a
    (3, N, T', W) buffer at slot 1 with kv_pad, whose pad rows must be exactly
    0; last_only (LN1 + K/V only) into the stacked buffer."""
    w, heads = geometry
    hd = w // heads
    h, ln, attn = attn_inputs(rng, w)
    n, t, _ = h.shape
    drop_cls = mode in ("stacked", "last_only")
    lo = 1 if drop_cls else 0
    pad = (-(t - lo)) % 8 if drop_cls else 0          # 13 -> 16 rows
    t_out, nsel, slot = t - lo + pad, 3, 1
    kw = dict(export=mode in ("export", "stacked"), drop_cls=drop_cls,
              last_only=mode == "last_only", kv_pad=pad)

    if reference == "xla":
        ho_w, k_w, v_w = xla_attn_block(jnp.asarray(h), jx(ln), jx(attn), heads, hd, lo, pad)
    else:
        into = None
        if drop_cls:
            z = jnp.zeros((nsel, n, t_out, w), jnp.float32)
            into = (z, z, slot, nsel)
        out = j_attn_block(jnp.asarray(h), jx(ln), jx(attn), heads, hd,
                           export_into=into, **kw)
        ho_w = out if mode == "plain" else (None if mode == "last_only" else out[0])
        if mode != "plain":
            k_w, v_w = out[-2:]
            if drop_cls:
                k_w, v_w = k_w[slot], v_w[slot]
            k_w, v_w = (np.asarray(a).reshape(n, t_out, w) for a in (k_w, v_w))

    into = None
    if drop_cls:
        into = (torch.full((nsel, n, t_out, w), float("nan")),
                torch.full((nsel, n, t_out, w), float("nan")), slot, nsel)
    out = fused_encoder_attn_block(torch.from_numpy(h), th(ln), th(attn), heads, hd,
                                   export_into=into, **kw)
    if mode == "plain":
        close(out, ho_w)
        return
    if mode != "last_only":
        close(out[0], ho_w)
    k, v = out[-2:]
    if drop_cls:
        assert k is into[0] and v is into[1]
        k, v = k[slot], v[slot]
        assert torch.equal(k[:, t - lo:], torch.zeros_like(k[:, t - lo:]))
        assert torch.equal(v[:, t - lo:], torch.zeros_like(v[:, t - lo:]))
    close(k.reshape(n, t_out, w), k_w)
    close(v.reshape(n, t_out, w), v_w)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["d16", "d64"])
def test_fused_encoder_mlp_block_matches_jax(rng, reference, geometry):
    w, _ = geometry
    h = rng.standard_normal((4, 14, w)).astype(np.float32)
    ln = ln_params(rng, w)
    mlp = {"c_fc": lin_params(rng, w, 4 * w), "c_proj": lin_params(rng, 4 * w, w)}
    if reference == "xla":
        hj, lnj, mj = jnp.asarray(h), jx(ln), jx(mlp)
        want = hj + jlayers.linear(mj["c_proj"], jlayers.quick_gelu(
            jlayers.linear(mj["c_fc"], jlayers.layer_norm(lnj, hj))))
    else:
        want = j_mlp_block(jnp.asarray(h), jx(ln), jx(mlp))
    close(fused_encoder_mlp_block(torch.from_numpy(h), th(ln), th(mlp)), want)


# -- decoder attention ------------------------------------------------------------

DEC_CASES = {
    # frames x patches with patch_valid < patches: the 8-aligned export pad
    "pad_rows_d64": dict(heads=2, d=64, t=3, p=24, patch_valid=21),
    # L = 5 x 13 = 65 tokens: not a multiple of any tile
    "ragged_d16": dict(heads=4, d=16, t=5, p=13, patch_valid=None),
}


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(DEC_CASES))
def test_fused_decoder_attention_matches_jax(rng, reference, case):
    """Stacked K/V read at slot 1, temporal_pos on K and V, sample 1 with its
    last frames masked and sample 2 fully masked (its output must be 0)."""
    c = DEC_CASES[case]
    b, nsel, h, d, t, p = 3, 3, c["heads"], c["d"], c["t"], c["p"]
    l = t * p
    qs = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    qc = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((nsel, b, l, h, d)).astype(np.float32)
    v = rng.standard_normal((nsel, b, l, h, d)).astype(np.float32)
    pos = (0.1 * rng.standard_normal((l, h, d))).astype(np.float32)
    frames = np.ones((b, t), bool)
    frames[1, t // 2 + 1:] = False
    frames[2] = False
    mask = token_mask(torch.from_numpy(frames), p, c["patch_valid"])
    mj = jnp.asarray(mask.numpy())
    args = [jnp.asarray(a) for a in (qs, qc, k, v)]
    if reference == "xla":
        want = jdual(*args, mj, num_frames=t, temporal_pos=jnp.asarray(pos), layer=1)
    else:
        want = j_fused_dec(*args, mj, temporal_pos=jnp.asarray(pos), layer=1)
    got = fused_decoder_attention(*(torch.from_numpy(a) for a in (qs, qc, k, v)), mask,
                                  torch.from_numpy(pos), layer=1)
    close(got, want)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


# -- decoder boundary -------------------------------------------------------------

# the row counts the card's kernel tiles (16-row tiles: one row, a partial
# tile, the serve batch's whole tile, one past it) at a narrow and a wider
# width; (3, 64) is the case held before the kernel took the boundary
@pytest.mark.parametrize("w", [64, 256])
@pytest.mark.parametrize("b", [1, 3, 16, 17])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("form", ["first", "middle", "last"])
def test_decoder_boundary_matches_jax(rng, reference, form, b, w):
    x = rng.standard_normal((b, w)).astype(np.float32)
    o = rng.standard_normal((b, w)).astype(np.float32)
    tail = {"attn_out_proj": lin_params(rng, w, w), "ln_2": ln_params(rng, w),
            "mlp": {"c_fc": lin_params(rng, w, 4 * w), "c_proj": lin_params(rng, 4 * w, w)}}
    query = {"ln_1": ln_params(rng, w), "in_proj": lin_params(rng, w, 2 * w)}
    tail_p = None if form == "first" else tail
    query_p = None if form == "last" else query
    attn = None if form == "first" else o
    if reference == "pallas":
        want = j_boundary(jnp.asarray(x), None if attn is None else jnp.asarray(attn),
                          None if tail_p is None else jx(tail_p),
                          None if query_p is None else jx(query_p))
    else:  # models/decoder.py's XLA composition of the same boundary
        xj, want_x, want_q = jnp.asarray(x), None, None
        if tail_p is not None:
            tj = jx(tail_p)
            xj = xj + jlayers.linear(tj["attn_out_proj"], jnp.asarray(attn))
            y = jlayers.quick_gelu(jlayers.linear(tj["mlp"]["c_fc"],
                                                  jlayers.layer_norm(tj["ln_2"], xj)))
            xj = want_x = xj + jlayers.linear(tj["mlp"]["c_proj"], y)
        if query_p is not None:
            qj = jx(query_p)
            want_q = jlayers.linear(qj["in_proj"], jlayers.layer_norm(qj["ln_1"], xj))
        want = (want_x, want_q)
    got = decoder_boundary(torch.from_numpy(x), None if attn is None else torch.from_numpy(attn),
                           None if tail_p is None else th(tail_p),
                           None if query_p is None else th(query_p))
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if g is not None:
            close(g, wv)


# -- kernels take only the card ---------------------------------------------------

def test_kernel_wrappers_refuse_other_devices():
    """On a CPU tensor a wrapper takes its plain version only because the
    tensor lies on the CPU; the CUDA-only launchers and any other device
    raise instead of falling back."""
    meta = torch.empty((2, 5, 64), device="meta")
    ln = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    with pytest.raises(ValueError):
        fused_encoder_mlp_block(meta, ln, {})
    with pytest.raises(ValueError):
        _cuda.gemm(torch.zeros(4, 32, dtype=torch.bfloat16),
                   torch.zeros(32, 8, dtype=torch.bfloat16), torch.zeros(8))
    with pytest.raises(ValueError):
        _cuda.layer_norm_rows(torch.zeros(4, 64, dtype=torch.bfloat16), ln["scale"], ln["bias"])


@pytest.mark.parametrize("forms", [("gelu", "residual"), ("gelu", "export"),
                                   ("residual", "export")], ids="+".join)
@pytest.mark.parametrize("wrapper", ["gemm", "gemm_s8"])
def test_gemm_wrappers_take_one_epilogue_form(wrapper, forms):
    """The GEMMs' kernels exist for QuickGELU, a residual or the K/V export
    one at a time (csrc/gemm_hopper.cuh, kForms): a pair is refused by its
    arguments, before any tensor is looked at."""
    m, k, n = 4, 64, 24
    kw = {"gelu": True, "residual": torch.zeros(m, n, dtype=torch.bfloat16),
          "export": (torch.zeros(1, 8, 8, dtype=torch.bfloat16),
                     torch.zeros(1, 8, 8, dtype=torch.bfloat16), 4, 8, 1, 8)}
    kw = {f: kw[f] for f in forms}
    bias = torch.zeros(n)
    with pytest.raises(ValueError, match="one at a time"):
        if wrapper == "gemm":
            _cuda.gemm(torch.zeros(m, k, dtype=torch.bfloat16),
                       torch.zeros(k, n, dtype=torch.bfloat16), bias, **kw)
        else:
            _cuda.gemm_s8(torch.zeros(m, k, dtype=torch.int8), torch.ones(m),
                          torch.zeros(n, k, dtype=torch.int8), torch.ones(n), bias, **kw)
