"""The W8A8 tower wider than 1024 (JAX's XLA composition with
``layers.linear_w8a8``, dfd_clip_tpu/models/clip_vit.py:438-497) against the
JAX package on the CPU, in f32: width 1152 (18 heads of 64), 2 layers, a
32-pixel input at patch 16 (5 tokens, 4 after drop_cls, padded to 8).

Tolerances:

* the plain export and every f32 scale: atol = rtol = 1e-4, the int8 tower
  tests' f32 tolerance (the product sums run in another order);
* the int8 K/V values (``kv_int8``, ``kv_int8_rows``): equal, except where
  the JAX value before its rounding lies within that 1e-4 of a rounding
  tie. Each such flip is one quantum, counted and reported (the test's
  ``int8_flips`` property), never passed by a looser bound: seed 4 gives
  one flip in 36,864 values of ``kv_int8``'s V and none elsewhere.

Also the quantiser's form (quant_linear_plain) against JAX's activation
quantiser, and the refusals at this width: the whole-encoder tower and the
whole int8 block budget for width <= 1024 and raise, as JAX's fused kernels
do not run there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu_torch.models import clip_vit as tvit
from dfd_clip_tpu_torch.models.weights import params_from_jax
from dfd_clip_tpu_torch.ops import int8 as ti

TOL = dict(rtol=1e-4, atol=1e-4)
GEOMETRY = dict(input_resolution=32, patch_size=16, width=1152, layers=2, heads=18,
                output_dim=32)
KW = dict(keep_layers=(0, 1), drop_cls=True, pad_tokens=True, compute_int8=True)
FORMS = {"plain": {}, "kv_int8": {"kv_int8": True}, "kv_int8_rows": {"kv_int8_rows": True}}


@pytest.fixture(scope="module")
def wide():
    """JAX's and the port's outputs in each export form on the same
    parameters and frames."""
    jcfg, tcfg = jvit.ViTConfig(**GEOMETRY), tvit.ViTConfig(**GEOMETRY)
    params = jax.tree_util.tree_map(np.asarray, jvit.init_clip_vision(jax.random.key(4), jcfg))
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    jparams = jvit.prepare_int8_params(jax.tree_util.tree_map(jnp.asarray, params))
    tparams = tvit.prepare_int8_params(params_from_jax(params))
    out = {}
    for form, extra in FORMS.items():
        want = jvit.clip_vision_kv(jparams, jnp.asarray(x), jcfg, compute_dtype=jnp.float32,
                                   **KW, **extra)
        got = tvit.clip_vision_kv(tparams, torch.from_numpy(x), tcfg,
                                  compute_dtype=torch.float32, **KW, **extra)
        out[form] = ({s: v.numpy() for s, v in got.items()},
                     {s: np.asarray(v) for s, v in want.items()})
    return out, tparams, tcfg, x


def flips_at_ties(got: np.ndarray, want: np.ndarray, pre: np.ndarray, slack: np.ndarray) -> int:
    """The int8 values that differ: each by one quantum, and each where
    ``pre`` (JAX's value before the rounding) is within ``slack`` of a
    rounding tie. Returns their count."""
    d = got.astype(np.int32) - want.astype(np.int32)
    flips = d != 0
    assert np.abs(d).max(initial=0) <= 1
    to_tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5)
    assert (to_tie[flips] <= slack[flips]).all(), (to_tie[flips], slack[flips])
    return int(flips.sum())


def test_plain_export_matches_jax(wide):
    got, want = wide[0]["plain"]
    assert sorted(got) == sorted(want) == ["k", "v"]
    for s in got:
        assert got[s].shape == want[s].shape == (2, 2, 8, 18, 64), s
        np.testing.assert_allclose(got[s], want[s], **TOL, err_msg=s)
        assert (got[s][:, :, 4:] == 0).all()   # the 8-row pad


@pytest.mark.parametrize("form", ["kv_int8", "kv_int8_rows"])
def test_int8_exports_match_jax(wide, form, record_property):
    """The int8 values and their scales; each flip sits at a tie of JAX's
    unrounded value (from the plain export, itself within 1e-4)."""
    out = wide[0]
    got, want = out[form]
    plain = out["plain"][1]
    assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
    count = 0
    for s in ("k", "v"):
        assert got[s].dtype == want[s].dtype == np.int8 and got[s].shape == want[s].shape
        np.testing.assert_allclose(got[f"{s}_scale"], want[f"{s}_scale"], **TOL, err_msg=s)
        f = plain[s].astype(np.float64)
        if form == "kv_int8":   # one scale a (layer, head): q = round(f / s * 127)
            scale = want[f"{s}_scale"][:, None, None, :, None].astype(np.float64)
            pre, unit = f / scale * 127.0, 127.0 / scale
        else:                   # one scale a row: q = round(r / s), s = max|r| / 127
            lsel, n, t = f.shape[:3]
            scale = want[f"{s}_scale"].reshape(lsel, n, t, 1, 1).astype(np.float64)
            pre, unit = f / scale, 1.0 / scale
        count += flips_at_ties(got[s], want[s], pre, (1e-4 + 1e-4 * np.abs(f)) * unit)
    record_property("int8_flips", count)
    print(f"{form}: {count} int8 flips at rounding ties of {2 * got['k'].size} values")


def test_quant_linear_plain_matches_jax():
    """The activation quantiser of linear_w8a8 (x / s * 127, not the
    kernels' x * (127 / s)) bit for bit against JAX's own arithmetic, at
    the wide tower's c_fc input width; the kernels' form differs on these
    rows (1 value in 1.3 M), which is why the form is its own."""
    x = np.random.default_rng(7).standard_normal((1024, 1280)).astype(np.float32) * 3.0
    x32 = jnp.asarray(x)
    js = jnp.max(jnp.abs(x32), axis=-1, keepdims=True) + 1e-8
    jq = jnp.clip(jnp.round(x32 / js * 127.0), -127, 127).astype(jnp.int8)
    q, s = ti.quant_linear_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    q_rows, _ = ti.quant_rows_plain(torch.from_numpy(x))
    assert (q_rows != q).any()


@pytest.mark.parametrize("refused", [{"tower": True}, {"block": "full"}])
def test_fused_forms_raise_above_1024(wide, refused):
    """tower=True and block="full" raise at width 1152 with compute_int8,
    naming the reason, and run nothing else in their place."""
    _, tparams, tcfg, x = wide
    with pytest.raises(ValueError, match="budget for width <= 1024"):
        tvit.clip_vision_kv(tparams, torch.from_numpy(x), tcfg, compute_dtype=torch.float32,
                            **KW, **refused)


def test_quant_rows_forms_refused():
    """quant_rows names its forms and refuses another before it touches a
    device."""
    from dfd_clip_tpu_torch.ops import _cuda

    assert _cuda.QUANT_FORMS == {"rows": 0, "kv": 1, "linear": 2}
    with pytest.raises(ValueError, match="form must be one of"):
        _cuda.quant_rows(torch.zeros(2, 8), form="linear8")
