"""The port's plain versions against the JAX package in bf16, the dtype the
card runs, where the two packages round at different points:

* the encoder kernels add biases in f32 before the bf16 cast, the JAX XLA
  composition (layers.linear) after it;
* the encoder softmax subtracts the row maximum, the TPU kernel clamps
  logits at 60 instead;
* the decoder's XLA composition rounds the attention weights to bf16 before
  PV and the TPU kernel rounds k + pos to bf16; the port keeps both in f32.

Tolerance: max|port - jax| <= 1e-2 x max|jax|, about two bf16 ulps (2^-8
each) at the top of the output's range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import layers as jl
from dfd_clip_tpu.ops.attention import encoder_self_attention_qkv
from dfd_clip_tpu.ops.decoder_attention import dual_activation_attention
from dfd_clip_tpu.ops.pallas_attention import fused_encoder_attn_block, fused_encoder_mlp_block
from dfd_clip_tpu.ops.pallas_decoder_attention import fused_decoder_attention
from dfd_clip_tpu_torch.ops import encoder_block as eb
from dfd_clip_tpu_torch.ops.fused_decoder_attention import fused_decoder_attention_plain

REL = 1e-2
W, HEADS, D = 256, 4, 64


def rel_err(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(7)

    def lin(i, o):
        return {"w": (i ** -0.5 * rng.standard_normal((i, o))).astype(np.float32),
                "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    return {
        "h": rng.standard_normal((2, 197, W)).astype(np.float32),
        "ln": {"scale": (1 + 0.3 * rng.standard_normal(W)).astype(np.float32),
               "bias": (0.1 * rng.standard_normal(W)).astype(np.float32)},
        "attn": {"in_proj": lin(W, 3 * W), "out_proj": lin(W, W)},
        "mlp": {"c_fc": lin(W, 4 * W), "c_proj": lin(4 * W, W)},
    }


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_attn_block_bf16_close_to_jax(block, reference):
    hj = jnp.asarray(block["h"], jnp.bfloat16)
    ln, attn = jx(block["ln"]), jx(block["attn"])
    if reference == "pallas":
        want = fused_encoder_attn_block(hj, ln, attn, HEADS, D)
    else:
        qkv = jl.linear(attn["in_proj"], jl.layer_norm(ln, hj))
        want = hj + jl.linear(attn["out_proj"], encoder_self_attention_qkv(qkv, HEADS, D))
    got = eb.fused_encoder_attn_block(torch.from_numpy(block["h"]).bfloat16(),
                                      th(block["ln"]), th(block["attn"]), HEADS, D)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_mlp_block_bf16_close_to_jax(block, reference):
    hj = jnp.asarray(block["h"], jnp.bfloat16)
    ln, mlp = jx(block["ln"]), jx(block["mlp"])
    if reference == "pallas":
        want = fused_encoder_mlp_block(hj, ln, mlp)
    else:
        want = hj + jl.linear(mlp["c_proj"], jl.quick_gelu(
            jl.linear(mlp["c_fc"], jl.layer_norm(ln, hj))))
    got = eb.fused_encoder_mlp_block(torch.from_numpy(block["h"]).bfloat16(),
                                     th(block["ln"]), th(block["mlp"]))
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_decoder_attention_bf16_close_to_jax(reference):
    rng = np.random.default_rng(8)
    b, l = 3, 3 * 200
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, 1, HEADS, D), (b, 1, HEADS, D),
                        (2, b, l, HEADS, D), (2, b, l, HEADS, D))]
    pos = (0.1 * rng.standard_normal((l, HEADS, D))).astype(np.float32)
    mask = np.ones((b, l), bool)
    mask[1, 400:] = False
    args = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    pj = jnp.asarray(pos, jnp.bfloat16)
    if reference == "pallas":
        want = fused_decoder_attention(*args, jnp.asarray(mask), temporal_pos=pj, layer=1)
    else:
        want = dual_activation_attention(*args, jnp.asarray(mask), num_frames=3,
                                         temporal_pos=pj, layer=1)
    got = fused_decoder_attention_plain(*(torch.from_numpy(a).bfloat16() for a in arrays),
                                        torch.from_numpy(mask),
                                        torch.from_numpy(pos).bfloat16(), layer=1)
    assert rel_err(got, want) <= REL
