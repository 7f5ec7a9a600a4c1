"""The SSL tower in the port (dfd_clip_tpu_torch on the CPU, plain versions)
against the JAX package on the same numpy inputs, with the weights carried
across: ``_pos_embed_for``, ``dinov2_forward`` with iBOT masks on global and
local crops, ``_block`` with given stochastic-depth masks, ``remat``
against no remat, the trainable encoder attention's gradients against
``jax.grad`` of ``_xla_attention``, and the SSL trees through
``params_from_jax`` / ``params_to_jax``.

Tolerances, with their reasons:
* ``_pos_embed_for`` (16 x 16 -> 7 x 7, width 8, and 4 x 4 -> 2 x 2):
  within 1e-6 of the largest value. The weights are equal (the same f32
  arithmetic); the two products sum in another order than XLA's einsum,
  whose own error against a float64 resize is about 3e-7 of the largest
  value at unit scale;
* the f32 tower and block: 1e-5 (LayerNorm, GELU and softmax sums in other
  orders over 2 layers);
* the attention's gradients: f32 within 1e-5 of each gradient's largest
  value; bf16 within 2 ulps of bf16 (2 x 2^-8) of it: both sides round P
  and dP to bf16 where _xla_attention's VJP does, and the f32 products
  before the last rounding run in other orders;
* remat against no remat: bit-equal (the same operations, the same masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import dinov2_vit as jdino
from dfd_clip_tpu.models.clip_vit import ViTConfig as JViTConfig
from dfd_clip_tpu.ops.attention import _xla_attention
from dfd_clip_tpu.ssl.meta_arch import SSLConfig as JSSLConfig
from dfd_clip_tpu.ssl.meta_arch import SSLMetaArch as JSSLMetaArch
from dfd_clip_tpu_torch.engine.optim import named_leaves
from dfd_clip_tpu_torch.models import dinov2_vit as tdino
from dfd_clip_tpu_torch.models.weights import params_from_jax, params_to_jax
from dfd_clip_tpu_torch.ops.attention import plain_attention, trainable_encoder_attention

ARCH = jdino.ARCHITECTURES["ViT-Test"]
TDTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
JDTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def jax_backbone(seed: int = 0):
    """JAX's init as numpy, with a non-zero mask token (the init's is 0,
    which would hide a wrong substitution)."""
    p = jax.tree_util.tree_map(np.asarray, jdino.init_dinov2(jax.random.key(seed), ARCH))
    p["mask_token"] = np.random.default_rng(seed).standard_normal(ARCH.width).astype(np.float32)
    return p


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("src,dst,scale", [(16, 7, 0.02), (16, 7, 1.0), (4, 2, 1.0), (4, 4, 1.0)],
                         ids=["16_to_7_init_scale", "16_to_7_unit", "4_to_2", "same_grid"])
def test_pos_embed_for_matches_jax(src, dst, scale):
    pos = (scale * np.random.default_rng(src + dst).standard_normal((src * src + 1, 8))
           ).astype(np.float32)
    want = np.asarray(jdino._pos_embed_for(jnp.asarray(pos), dst * dst + 1, ARCH))
    got = tdino._pos_embed_for(torch.from_numpy(pos), dst * dst + 1).numpy()
    assert got.shape == want.shape == (dst * dst + 1, 8)
    assert rel_max(got, want) <= (0.0 if src == dst else 1e-6)
    np.testing.assert_array_equal(got[0], pos[0])


def test_pos_embed_for_keeps_the_gradient():
    pos = torch.randn(17, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)
    tdino._pos_embed_for(pos, 5).sum().backward()
    assert pos.grad is not None and torch.count_nonzero(pos.grad[1:]) > 0


@pytest.mark.parametrize("size,masked", [(28, True), (14, False)], ids=["global_masked", "local"])
def test_dinov2_forward_matches_jax(size, masked):
    jp = jax_backbone()
    rng = np.random.default_rng(size)
    x = rng.standard_normal((4, 3, size, size)).astype(np.float32)
    p = (size // 14) ** 2
    masks = (rng.random((4, p)) < 0.5) if masked else None
    want = jdino.dinov2_forward(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), ARCH,
                                jnp.float32, masks=None if masks is None else jnp.asarray(masks))
    got = tdino.dinov2_forward(params_from_jax(jp), torch.from_numpy(x), ARCH, torch.float32,
                               masks=None if masks is None else torch.from_numpy(masks))
    for k in ("cls", "patch"):
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def test_block_with_drop_path_masks_matches_jax():
    jp = jax_backbone(1)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 5, ARCH.width)).astype(np.float32)
    keep = 0.7
    dp1 = ((rng.random((3, 1, 1)) < keep) / keep).astype(np.float32)
    dp2 = ((rng.random((3, 1, 1)) < keep) / keep).astype(np.float32)
    bp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jp["blocks"])
    want = jdino._block(bp, jnp.asarray(h), ARCH, jnp.asarray(dp1), jnp.asarray(dp2))
    got = tdino._block(params_from_jax(jp)["blocks"][0], torch.from_numpy(h), ARCH,
                       torch.from_numpy(dp1), torch.from_numpy(dp2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a dropped sample keeps its input on the dropped branch
    both = tdino._block(params_from_jax(jp)["blocks"][0], torch.from_numpy(h), ARCH,
                        torch.zeros(3, 1, 1), torch.zeros(3, 1, 1))
    np.testing.assert_array_equal(both.numpy(), h)


def _grads(params, x, masks, remat, rate, seed):
    leaves = [t.requires_grad_() for _, t in named_leaves(params)]
    out = tdino.dinov2_forward(params, x, ARCH, torch.float32, masks=masks, drop_path_rate=rate,
                               gen=torch.Generator().manual_seed(seed), remat=remat)
    loss = out["cls"].square().sum() + (out["patch"] * torch.linspace(-1, 1, ARCH.width)).sum()
    return loss, torch.autograd.grad(loss, leaves)


def test_remat_matches_no_remat_and_drop_path_draws():
    """remat checkpoints each block with its masks drawn before the call:
    loss and every gradient bit-equal to the plain forward (as
    tests/test_ssl.py:396 holds JAX's). Different generator seeds draw
    different masks; rate 0 is the deterministic forward."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 3, 28, 28)).astype(np.float32))
    masks = torch.from_numpy(rng.random((6, 4)) < 0.5)
    base = params_from_jax(jax_backbone(2))
    l0, g0 = _grads(params_from_jax(jax_backbone(2)), x, masks, False, 0.3, 5)
    l1, g1 = _grads(params_from_jax(jax_backbone(2)), x, masks, True, 0.3, 5)
    assert l0.item() == l1.item()
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    l2, _ = _grads(params_from_jax(jax_backbone(2)), x, masks, False, 0.3, 6)
    assert l2.item() != l0.item()
    plain = tdino.dinov2_forward(base, x, ARCH, torch.float32, masks=masks)
    zero = tdino.dinov2_forward(base, x, ARCH, torch.float32, masks=masks, drop_path_rate=0.0,
                                gen=torch.Generator().manual_seed(5))
    torch.testing.assert_close(plain["cls"], zero["cls"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,t,h,d", [(3, 50, 2, 64), (2, 5, 2, 16)], ids=["50_tokens", "5_tokens"])
def test_trainable_attention_grads_match_jax(dtype, n, t, h, d):
    """q, k, v as the column blocks of one packed buffer (as the tower reads
    them); forward against plain_attention, dq / dk / dv against jax.grad of
    _xla_attention on the same cotangent."""
    rng = np.random.default_rng(t)
    qkv = rng.standard_normal((n, t, 3 * h * d)).astype(np.float32)
    ct = rng.standard_normal((n, t, h, d)).astype(np.float32)
    tq = torch.from_numpy(qkv).to(TDTYPE[dtype]).requires_grad_()
    q, k, v = (s.reshape(n, t, h, d) for s in tq.split(h * d, dim=-1))
    out = trainable_encoder_attention(q, k, v)
    torch.testing.assert_close(out, plain_attention(q, k, v), rtol=0, atol=0)
    out.backward(torch.from_numpy(ct).to(TDTYPE[dtype]))
    got = tq.grad.float().reshape(n, t, 3, h, d)

    jqkv = jnp.asarray(qkv).astype(JDTYPE[dtype]).reshape(n, t, 3, h, d)

    def f(q, k, v):
        return jnp.sum(_xla_attention(q, k, v).astype(jnp.float32) * jnp.asarray(ct))

    want = jax.grad(f, argnums=(0, 1, 2))(jqkv[:, :, 0], jqkv[:, :, 1], jqkv[:, :, 2])
    tol = 1e-5 if dtype == "f32" else 2 * 2.0 ** -8
    for i, name in enumerate("qkv"):
        err = rel_max(got[:, :, i].numpy(), np.asarray(want[i].astype(jnp.float32)))
        assert err <= tol, f"d{name}: {err:.3e} > {tol:g}"


def test_ssl_trees_convert_both_ways():
    """A JAX SSLMetaArch's student (backbone and both heads), teacher and
    centers through params_from_jax: the backbone in the port's layout
    (OIHW conv1, a per-layer block list), the heads as they are; back
    through params_to_jax bit-equal."""
    cfg = JSSLConfig(arch=JViTConfig(**{**ARCH.__dict__}), out_dim=16, ibot_out_dim=16,
                     head_hidden_dim=32, head_bottleneck_dim=8)
    student, teacher, centers = JSSLMetaArch(cfg).init_params(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, {"student": student, "teacher": teacher,
                                               "centers": centers})
    port = params_from_jax(tree)
    bb = port["student"]["backbone"]
    assert bb["conv1"]["w"].shape == (ARCH.width, 3, 14, 14)
    assert isinstance(bb["blocks"], list) and len(bb["blocks"]) == ARCH.layers
    assert port["student"]["dino_head"]["last_v"].shape == (8, 16)
    assert len(port["teacher"]["ibot_head"]["mlp"]) == 3
    back = params_to_jax(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("remat", [True, False])
def test_attention_calls_a_train_step(monkeypatch, remat):
    """The structure the card holds as launches (chip_smoke.py: 60 a ViT-B/14
    step with remat, 36 without, 12 a feature batch), counted here as calls
    of fused_encoder_attention at ViT-Test's 2 layers: the teacher's
    globals, the student's globals and locals, and with remat each
    student block again in the backward; by token count (5 at 28 pixels, 2
    at 14)."""
    import collections

    from dfd_clip_tpu_torch.ops import attention as att
    from dfd_clip_tpu_torch.ssl import evals
    from dfd_clip_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch

    calls = collections.Counter()
    kernel = att.fused_encoder_attention

    def counted(q, k, v):
        calls[q.shape[1]] += 1
        return kernel(q, k, v)

    monkeypatch.setattr(att, "fused_encoder_attention", counted)
    meta = SSLMetaArch(SSLConfig(arch=ARCH, out_dim=16, ibot_out_dim=16, local_size=14,
                                 n_local_crops=2, head_hidden_dim=32, head_bottleneck_dim=16,
                                 remat=remat), torch.float32)
    student, teacher, centers = meta.init_params(torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_() for _, t in named_leaves(student)]
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.standard_normal((2, 2, 3, 28, 28)).astype(np.float32))
    loc = torch.from_numpy(rng.standard_normal((2, 2, 3, 14, 14)).astype(np.float32))
    masks = torch.from_numpy(rng.random((2, 2, 4)) < 0.5)
    total, _ = meta.forward_loss(student, teacher, centers, g, loc, masks, 0.04)
    torch.autograd.grad(total, leaves)
    layers = ARCH.layers
    assert calls == {5: (3 if remat else 2) * layers, 2: (2 if remat else 1) * layers}
    calls.clear()
    evals.extract_features(teacher["backbone"], ARCH, np.zeros((3, 3, 28, 28), np.float32),
                           batch_size=2, compute_dtype=torch.float32)
    assert calls == {5: 2 * layers}
